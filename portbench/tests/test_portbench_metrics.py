"""Each metric reader on synthetic records."""
import pytest

from portbench import harness, roofline, trace

SD2 = harness.resolve("sd2-t2i-ddim50-b8")


def _trace(device, window=(0, 10**9)):
    return trace.reduce_events(device, [("aten::mm", 0, 2 * 10**8)], window)


def test_reduce_events():
    tr = _trace([("k1", 0, 10**8), ("k2", 5 * 10**7, 2 * 10**8), ("k3", 5 * 10**8, 6 * 10**8)])
    assert tr["busy_s"] == pytest.approx(0.3) and tr["window_s"] == pytest.approx(1.0)
    gaps = tr["breakdown"]["idle_gaps"]
    assert gaps[0][1] == pytest.approx(0.4) and gaps[1][1] == pytest.approx(0.3)
    assert tr["breakdown"]["device_ops"][0] == ["k2", pytest.approx(0.15)]


def test_end_to_end():
    rec = {"batch": 8, "completions": [1.0, 2.0, 3.0], "window_s": 3.0, "setup_s": 12.5}
    assert harness.metric("img_per_s").read(rec) == pytest.approx(8.0)
    assert harness.metric("setup_s").read(rec) == 12.5
    assert harness.metric("train_img_per_s").read({"batch": 8, "steps": 20,
                                                   "window_s": 10.0}) == pytest.approx(16.0)


def test_device_metrics():
    tr = _trace([("void packed_attn_kernel<64>", 0, 10**8),
                 ("void wino_fused_kernel<1>", 10**8, 3 * 10**8)])
    rec = {"config": SD2.config, "traffic": SD2.traffic, "trace": tr,
           "segment": {"batches": 1, "unet_evals": [(2.0, 50.0), (4.0, 70.0)]}}
    assert harness.metric("device_idle_share.t2i").read(rec) == pytest.approx(70.0)
    assert harness.metric("unet_ms_per_eval.t2i").read(rec) == pytest.approx(60.0)
    assert harness.metric("unet_host_ms_per_eval.t2i").read(rec) == pytest.approx(3.0)
    w = harness.operation("self_attention").work_of(SD2.config, SD2.traffic)
    least = roofline.least_seconds(w["flops"], w["exps"], w["bytes"])
    assert harness.metric("attn_roofline.t2i").read(rec) == pytest.approx(100 * least / 0.1)
    w = harness.operation("conv3x3").work_of(SD2.config, SD2.traffic)
    least = roofline.least_seconds(w["flops"], w["exps"], w["bytes"])
    assert harness.metric("conv_roofline.t2i").read(rec) == pytest.approx(100 * least / 0.2)
    flops = harness.operation("model_step").txt2img(SD2.config, SD2.traffic)
    assert harness.metric("mfu.t2i").read(rec) == pytest.approx(100 * flops / 989e12)


def test_silent_without_a_trace():
    """A reader with nothing to read returns None, never 0."""
    rec = {"config": SD2.config, "traffic": SD2.traffic, "segment": {"batches": 1},
           "trace": _trace([])}
    for name in ("attn_roofline.t2i", "conv_roofline.t2i", "mfu.t2i",
                 "device_idle_share.t2i", "unet_ms_per_eval.t2i"):
        assert harness.metric(name).read(rec) is None


def test_train_metrics():
    ft = harness.resolve("wukong-ft-512-b8")
    tr = _trace([("k", 0, 5 * 10**8)])
    rec = {"config": ft.config, "traffic": ft.traffic, "trace": tr,
           "segment": {"steps": 2, "step_host_ms": [300.0, 100.0]}}
    assert harness.metric("step_host_ms.train").read(rec) == pytest.approx(200.0)
    assert harness.metric("device_idle_share.train").read(rec) == pytest.approx(50.0)
    flops = harness.operation("model_step").train(ft.config, ft.traffic)
    assert harness.metric("mfu.train").read(rec) == pytest.approx(100 * 2 * flops / 989e12)
