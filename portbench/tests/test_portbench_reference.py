"""The plain reference against the port's plain path at a tiny width on
the CPU (fp32, TF32 irrelevant here), and whole tiny runs of each kind."""
import time

import pytest
import torch

from portbench import harness, sd, weights
from portbench.reference import models as ref
from portbench.run import Context

DATA = harness.BENCH / "tests" / "data"
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["tiny-sd2", "tiny-wukong"])
def pair(request):
    torch.manual_seed(0)
    config = harness.load_json("configs", request.param, DATA)
    state, _ = weights.make(config, 1234, CPU, torch.float32)
    return config, state, sd.port_models(config, state, CPU)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@torch.no_grad()
def test_text_encoder(pair):
    config, state, models = pair
    tok, _ = sd.prompt_tokens(config, {"prompt_tokens": [3, 20]}, 5, 0, 3, CPU)
    assert _rel(ref.text_encoder(state, config["text"], tok), models.text_encoder(tok)) < 1e-5


@torch.no_grad()
@pytest.mark.parametrize("fold", [False, True])
def test_unet(pair, fold):
    config, state, models = pair
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 16, 4, generator=g)
    ctx = torch.randn(4, 77, config["unet"]["context_dim"], generator=g)
    t = torch.tensor([500])
    got = models.unet(x, t, ctx, cfg_fold=True) if fold else models.unet(torch.cat([x, x]), t, ctx)
    want = ref.unet(state, config["unet"], torch.cat([x, x]), t.expand(4), ctx)
    assert _rel(got, want) < 1e-5


@torch.no_grad()
def test_vae(pair):
    config, state, models = pair
    g = torch.Generator().manual_seed(4)
    z = torch.randn(2, 8, 8, 4, generator=g)
    assert _rel(models.vae.decode(z), ref.vae_decode(state, config["vae"], z)) < 1e-5
    img = torch.rand(2, 64, 64, 3, generator=g) * 2 - 1
    assert _rel(models.vae.encode(img), ref.vae_encode(state, config["vae"], img)) < 1e-5


@pytest.mark.parametrize("cell", ["tiny-sd2-ddim", "tiny-wukong-dpm", "tiny-wukong-ft",
                                  "tiny-sd2-serve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run(cell, trace):
    """A whole run at a CPU size: the timed path, the window, the records and
    the comparison, which passes limits set for fp32 against fp32."""
    c = harness.resolve(cell, DATA)
    out = harness.traffic_kind(c.traffic["kind"]).run(
        Context(c, 2**31 + 99, 0.5, bool(trace), CPU, time.monotonic()))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    names = {n for n, _, _ in out.checks}
    assert names == set(c.cell["limits"])
    if trace:
        assert out.records["segment"] and out.trace is not None
    else:
        assert out.records["setup_s"] > 0 and out.records["window_s"] >= 0.5
    for name in c.metrics(bool(trace)):
        if harness.metric(name).SOURCE == "device_trace" or name == "unet_ms_per_eval.t2i":
            continue      # no device here: readers of the trace and CUDA events stay silent
        assert harness.metric(name).read(dict(out.records, trace=out.trace)) is not None, name
