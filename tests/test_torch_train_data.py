"""The port's training data, logger, config overlay, checkpoints and train
CLI (`data/`, `utils/logger.py`, `utils/config.py`, `io/checkpoints.py`,
`cli/train.py`) against the JAX package's where it has a counterpart.

Data batches must be bytewise equal to the JAX package's on the same files
and seed: the port reads the CSV manifests without pandas and reproduces
pandas' "nan" caption for an empty field. The CLI runs each train mode on
the CPU at the --debug_tiny size for 2 steps.
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from minddiffusion_tpu.data import dataset as jax_dataset
from minddiffusion_tpu.data import dataset_db as jax_db
from minddiffusion_tpu.utils import logger as jax_logger
from minddiffusion_tpu_torch.cli import train as train_cli
from minddiffusion_tpu_torch.data import DreamBoothDataset, dataset, load_data
from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager, load_checkpoint
from minddiffusion_tpu_torch.models.lora import is_lora_name
from minddiffusion_tpu_torch.utils import config, logger


def byte_tokenize(texts):
    """Token ids that carry each caption's bytes, so any caption difference
    shows in the batch."""
    return np.stack([np.frombuffer(t.encode("utf-8").ljust(77, b"\0")[:77], np.uint8)
                     for t in texts]).astype(np.int32)


def write_images(d, n: int, seed: int, size=(90, 70)):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    names = []
    for i in range(n):
        name = f"im_{i}.png"
        Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)).save(
            os.path.join(d, name))
        names.append(name)
    return names


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("manifest"))
    names = write_images(d, 7, 0)
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(os.path.join(d, "small.png"))
    caps = ["a cat", "", "来自太空的长城照片", "None", "two, words", "x", "NA"]
    rows = [f'{n},"{c}"' for n, c in zip(names, caps)] + ["small.png,too small"]
    with open(os.path.join(d, "b.csv"), "w", encoding="utf-8") as f:
        f.write("dir,text\n" + "\n".join(rows[4:]) + "\n")
    with open(os.path.join(d, "a.csv"), "w", encoding="utf-8") as f:
        f.write("dir,text\n" + "\n".join(rows[:4]) + "\n")
    return d


def test_manifest_reads_like_pandas(data_dir):
    ours = dataset.list_image_files_captions(data_dir)
    ref = jax_dataset.list_image_files_captions(data_dir)
    assert ours == ref
    assert ours[1][1] == "nan" and ours[1][3] == "nan" and ours[1][6] == "nan"


@pytest.mark.parametrize("random_crop", [False, True])
def test_dataset_batches_equal_jax(data_dir, random_crop):
    kw = dict(image_size=48, image_filter_size=40, random_crop=random_crop, seed=3)
    ours = load_data(data_dir, 2, byte_tokenize, **kw)
    ref = jax_dataset.load_data(data_dir, 2, byte_tokenize, shard_index=0, shard_count=1, **kw)
    assert ours.images == ref.images and len(ours.images) == 7       # small.png dropped
    assert os.path.exists(os.path.join(data_dir, ".filter_cache_40_8.npy"))
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_dreambooth_batches_equal_jax(tmp_path):
    inst, cls = str(tmp_path / "inst"), str(tmp_path / "cls")
    write_images(inst, 2, 1)
    write_images(cls, 3, 2, size=(60, 80))
    args = (inst, cls, "sks", "dog", byte_tokenize, 2, 32, 3, 5)
    got, want = list(DreamBoothDataset(*args).epoch(1)), list(jax_db.DreamBoothDataset(*args).epoch(1))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys() == {"image", "tokens", "reg_image", "reg_tokens"}
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_logger_matches_jax_and_f3(tmp_path, capsys):
    for n in (0, 1, 127, 128, 300, 2 ** 40):
        assert logger._varint(n) == jax_logger._varint(n)
    assert logger._varint(-1) == b"\xff" * 9 + b"\x01"      # protobuf's int64 -1
    assert logger._tb_event(1.0, -2, {"a": 1.0}) is not None
    a = logger.TensorBoardWriter(str(tmp_path / "tb"))
    b = logger.TensorBoardWriter(str(tmp_path / "tb"))
    assert str(os.getpid()) in os.path.basename(a.path)
    a.write({"step": 1, "loss": 0.5, "name": "x"})
    assert a.path == b.path or os.path.exists(a.path)
    with open(a.path, "rb") as f:
        head = f.read(12)
    (length,) = struct.unpack("<Q", head[:8])
    assert struct.unpack("<I", head[8:])[0] == logger._masked_crc(head[:8]) and length > 0
    log = logger.KVLogger(str(tmp_path / "log"), formats=("human", "json", "csv"))
    ref = jax_logger.KVLogger(str(tmp_path / "ref"), formats=("json",))
    for lg in (log, ref):
        lg.logkv_mean("loss", 1.0)
        lg.logkv_mean("loss", 2.0)
        lg.logkv("step", 2)
    assert log.dumpkvs() == ref.dumpkvs() == {"loss": 1.5, "step": 2}
    with open(tmp_path / "log" / "log.jsonl") as f:
        assert json.loads(f.readline()) == {"loss": 1.5, "step": 2}
    assert "loss" in capsys.readouterr().out


def test_config_overlay(tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"max_steps": 7, "seed": 11, "unknown": 1}))
    args = config.parse_with_config(train_cli.build_parser(),
                                    ["--config", str(cfg), "--seed", "5"])
    assert args.max_steps == 7 and args.seed == 5 and not hasattr(args, "unknown")


def test_checkpoint_manager_keeps_orbax_decisions(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), save_every_steps=3, keep_max=2)
    saved = []
    for step in range(1, 11):
        if mgr.should_save(step):
            mgr.save(step, {"w": torch.full((2,), float(step))})
            saved.append(step)
    assert saved == [1, 3, 6, 9]             # the initial save, then every 3
    assert mgr.steps() == [6, 9] and mgr.latest_step() == 9
    assert torch.equal(mgr.restore_latest()["w"], torch.full((2,), 9.0))
    assert not mgr.should_save(9)


@pytest.fixture
def vocab(tmp_path, monkeypatch):
    d = tmp_path / "assets"
    d.mkdir()
    (d / "vocab_zh.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a",
                                               "cat", "dog", "sks"]) + "\n")
    monkeypatch.setenv("MINDDIFFUSION_TPU_ASSETS", str(d))


@pytest.mark.parametrize("mode", ["finetune", "lora", "dreambooth"])
def test_train_cli_tiny(tmp_path, vocab, mode, capsys):
    data = str(tmp_path / "data")
    write_images(data, 4, 5)
    with open(os.path.join(data, "m.csv"), "w") as f:
        f.write("dir,text\n" + "".join(f"im_{i}.png,a cat\n" for i in range(4)))
    out = str(tmp_path / "out")
    argv = ["--debug_tiny", "--device", "cpu", "--dtype", "fp32", "--image_size", "64",
            "--image_filter_size", "32", "--train_batch_size", "2", "--max_steps", "2",
            "--warmup_steps", "0", "--start_learning_rate", "1e-3",
            "--output_path", out, "--train_mode", mode]
    if mode == "dreambooth":
        write_images(str(tmp_path / "cls"), 2, 6)
        argv += ["--instance_data_dir", data, "--class_data_dir", str(tmp_path / "cls"),
                 "--train_data_repeats", "2"]
    else:
        argv += ["--data_path", data]
    state = train_cli.main(argv)
    assert state.step == 2
    lines = [json.loads(line) for line in open(os.path.join(out, "log.jsonl"))]
    assert len(lines) == 1 and lines[0]["final_step"] == 2     # logs every 10 steps
    assert np.isfinite(lines[0]["loss"])
    ckpt = load_checkpoint(os.path.join(out, "ckpt", "ckpt_00000001.pt"))
    if mode == "lora":
        assert ckpt and all(is_lora_name(k) for k in ckpt)
        assert any(not torch.equal(v, state.models.state_dict()[k]) for k, v in ckpt.items())
    else:
        assert ckpt.keys() == state.models.state_dict().keys()


def test_loop_logs_the_jax_loops_means(tmp_path):
    """The metrics stay on the device between fetches (every `fetch_every`
    steps and at an epoch's end); LossMonitor still logs the mean loss of
    each `log_every` window at the JAX loop's steps."""
    from minddiffusion_tpu_torch.train.loop import LossMonitor, Trainer

    class Data:
        def epoch(self, i):
            return iter([{"x": np.zeros(1, np.float32)}] * 5)

    class State:
        step = 0

    fetched = []

    def step_fn(state, batch, seed):
        state.step += 1
        return {"loss": torch.tensor(float(state.step)), "grads_finite": torch.tensor(1.0)}

    class Spy(LossMonitor):
        def on_step_end(self, step, metrics):
            fetched.append((step, metrics["loss"]))
            super().on_step_end(step, metrics)

    log = logger.configure(str(tmp_path), formats=("json",))
    Trainer(step_fn, Data(), seed=0, device=torch.device("cpu"),
            callbacks=[Spy(log, log_every=2)], fetch_every=4).fit(State(), epochs=1)
    assert fetched == [(i, float(i)) for i in range(1, 6)]
    lines = [json.loads(line) for line in open(tmp_path / "log.jsonl")]
    assert [(r["step"], r["loss"]) for r in lines] == [(2, 1.5), (4, 3.5)]


def test_train_cli_refusals(tmp_path):
    # a grid that does not multiply out to the world size (1 without torchrun)
    with pytest.raises(SystemExit, match="mesh 2x1x1 != 1 devices"):
        train_cli.main(["--data_path", str(tmp_path), "--dp", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="mesh 0x2x1 != 1 devices"):
        train_cli.main(["--data_path", str(tmp_path), "--fsdp", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="class_data_dir"):
        train_cli.main(["--train_mode", "dreambooth", "--instance_data_dir", str(tmp_path),
                        "--device", "cpu"])
    with pytest.raises(SystemExit, match="data_path"):
        train_cli.main(["--device", "cpu"])


def test_lora_over_a_checkpoint_without_adapters(tmp_path):
    """--pretrained_ckpt of a model without LoRA: the base loads strictly,
    the adapters start as the JAX init does (A ~ N(0, 0.02^2), B = 0)."""
    from minddiffusion_tpu_torch.cli import common

    cpu = torch.device("cpu")
    plain = common.build_sd("wukong", "fp32", cpu, tiny=True, seed=1)
    path = str(tmp_path / "base.pt")
    torch.save({"state_dict": plain.state_dict()}, path)
    lora = common.build_sd("wukong", "fp32", cpu, tiny=True, ckpt_path=path,
                           param_dtype=torch.float32, enable_lora=True)
    sd, base = lora.state_dict(), plain.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in base.items())
    a = [v for k, v in sd.items() if k.endswith(".lora_a")]
    b = [v for k, v in sd.items() if k.endswith(".lora_b")]
    assert a and len(a) == len(b) == len(set(sd) - set(base)) // 2
    assert all(not v.any() for v in b) and 0.01 < torch.cat([v.flatten() for v in a]).std() < 0.03
