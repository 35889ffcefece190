"""The counted work against hand counts."""
import pytest

from portbench import harness, roofline, work


def _cell(name):
    return harness.resolve(name)


def test_k1_ds1_bound():
    """K1 at (16, 4096, 5 x 64): 0.3474 ms, bound by the tensor cores (PERF.md)."""
    b, h, n, d = 16, 5, 4096, 64
    ms = 1e3 * roofline.least_seconds(flops=4.0 * b * h * n * n * d, exps=b * h * n * n,
                                      nbytes=2.0 * b * h * d * 4 * n)
    assert ms == pytest.approx(0.3474, abs=5e-5)


def test_sd2_attention_sites():
    """10 K1 sites an SD2 512^2 eval (5 at 64^2, 5 at 32^2) and the VAE mid:
    501 a DDIM-50 batch, the first site of an eval at B (CFG-prefix saving)."""
    cell = _cell("sd2-t2i-ddim50-b8")
    sites = harness.operation("self_attention").sites(cell.config, cell.traffic)
    assert len(sites) == 501
    assert sum(1 for s in sites if s[1] == 8 and s[7] == "unet") == 50
    assert sum(1 for s in sites if s[7] == "vae_decode") == 1


def test_sd2_conv_sites():
    """Stride-1 3x3 convs at 16^2 and up: 13 at 64^2, 11 at 32^2, 11 at 16^2
    an eval; the VAE decoder's 33."""
    cell = _cell("sd2-t2i-ddim50-b8")
    sites = harness.operation("conv3x3").sites(cell.config, cell.traffic)
    per_side = {}
    for s in sites:
        if s[7] == "unet":
            per_side[s[2]] = per_side.get(s[2], 0) + 1
    assert per_side == {64: 13 * 50, 32: 11 * 50, 16: 11 * 50}
    assert sum(1 for s in sites if s[7] == "vae_decode") == 33


def test_unet_flops_sd2():
    """An SD2 UNet eval at 64^2 for one row is about 0.68 TFLOP (PERF.md's
    reckoning), with cross K/V."""
    cfg = _cell("sd2-t2i-ddim50-b8").config
    f = sum(work.flops(r) for r in work.unet(cfg["unet"], 1, 64, 64, 77))
    assert 0.6e12 < f < 0.9e12


@pytest.mark.parametrize("name", ["tiny-sd2", "tiny-wukong"])
def test_unet_flops_match_the_reference(name):
    """work.unet counts what torch's flop counter reads in the reference UNet
    (the time embedding's rows aside: within 1%)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench import weights
    from portbench.reference import models as ref

    config = harness.load_json("configs", name, harness.BENCH / "tests" / "data")
    state, _ = weights.make(config, 1, torch.device("cpu"), torch.float32)
    x = torch.randn(2, 16, 16, 4)
    ctx = torch.randn(2, 77, config["unet"]["context_dim"])
    with FlopCounterMode(display=False) as fc:
        ref.unet(state, config["unet"], x, torch.tensor([10, 10]), ctx)
    counted = sum(work.flops(r) for r in work.unet(config["unet"], 2, 16, 16, 77))
    assert counted == pytest.approx(fc.get_total_flops(), rel=1e-2)


def test_counts_do_not_depend_on_the_route():
    """The operations read the same work from the configuration alone."""
    cell = _cell("wukong-t2i-dpm15-b8")
    a = harness.operation("self_attention").work_of(cell.config, cell.traffic)
    b = harness.operation("self_attention").work_of(dict(cell.config, attn_impl="fast"),
                                                     cell.traffic)
    assert a == b and a["flops"] > 0
