"""Every file the benchmark finds by name loads and resolves, BENCHMARK.json
and the cell files agree, and a new cell is picked up without an edit."""
import json
import shutil

import pytest

from portbench import harness

BENCHMARK = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_benchmark_json_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["portbench"]
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert any(m["name"] == "setup_s" for m in BENCHMARK["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == name)
    cell = harness.resolve(name)
    assert cell.cell["config"] == entry["config"] and cell.cell["traffic"] == entry["traffic"]
    assert cell.chips == entry["chips"] and cell.cell["why"] == entry["why"]
    harness.traffic_kind(cell.traffic["kind"])
    conf = next(c for c in BENCHMARK["configs"] if c["name"] == entry["config"])
    assert conf["file"] == f"portbench/configs/{entry['config']}.json"
    assert conf["source"] == cell.config["source"] and conf["reduced"] == cell.config["reduced"]
    e2e = [m["name"] for m in BENCHMARK["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    assert sorted(cell.metrics(False)) == sorted(e2e)
    per = [m["name"] for m in BENCHMARK["per_layer"]
           if "workloads" not in m or name in m["workloads"]]
    assert sorted(cell.metrics(True)) == sorted(per)


@pytest.mark.parametrize("entry", BENCHMARK["end_to_end"] + BENCHMARK["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_file(entry):
    m = harness.metric(entry["name"])
    assert m.UNIT == entry["unit"] and m.SOURCE == entry["source"]
    assert m.read({}) is None


@pytest.mark.parametrize("op", ["self_attention", "conv3x3", "model_step"])
def test_operation_files(op):
    harness.operation(op)
    if op != "model_step":
        assert harness.kernel_patterns(op)


def test_new_cell_needs_no_edit(tmp_path):
    """A cell added as files alone (a workload naming an existing config and
    traffic, or new ones) resolves and runs through the same code."""
    for kind in ("configs", "traffic", "workloads"):
        shutil.copytree(harness.BENCH / kind, tmp_path / kind)
    cell = json.loads((harness.BENCH / "workloads" / f"{CELLS[0]}.json").read_text())
    traffic = json.loads((harness.BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps(dict(traffic, batch=4)))
    (tmp_path / "workloads" / "new-cell.json").write_text(
        json.dumps(dict(cell, traffic="new-mix")))
    got = harness.resolve("new-cell", tmp_path)
    assert got.traffic["batch"] == 4 and got.config["name"] == cell["config"]
    with pytest.raises(FileNotFoundError):
        harness.resolve("no-such-cell", tmp_path)


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no result."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    """A short run of each cell on the card is correct."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                          "--seed", str(2**31 + 3), "--seconds", "5"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


def test_benchmark_json_contract():
    """Names, units, lengths and keys as the benchmark's contract has them."""
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s  # noqa: E731
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert 2 + 14 * 24 * (BENCHMARK["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(name.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    pairs = set()
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    for m in BENCHMARK["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        has = lambda ms: [m for m in ms if cell in m.get("workloads", cells)]  # noqa: E731
        assert any(m["name"] == "setup_s" for m in has(BENCHMARK["end_to_end"]))
        assert len(has(BENCHMARK["end_to_end"])) >= 2 and has(BENCHMARK["per_layer"])
