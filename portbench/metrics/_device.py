"""Readers shared by the per-layer metrics of the traced segment."""
from portbench import roofline
from portbench.harness import kernel_patterns, operation


def idle_share(records: dict):
    """100 x (1 - the union of device intervals / the segment), in %."""
    tr = records.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def op_roofline(records: dict, op: str):
    """The least time of `op`'s work over the segment's batches / the device
    time of its kernels, in %."""
    seg = records.get("segment")
    if not seg or not records.get("trace"):
        return None
    w = operation(op).work_of(records["config"], records["traffic"])
    least = seg["batches"] * roofline.least_seconds(w["flops"], w["exps"], w["bytes"])
    return roofline.share(least, roofline.kernel_seconds(records["trace"], kernel_patterns(op)))


def mfu(records: dict, flops: float):
    """100 x flops / (the segment x the bf16 peak), in %."""
    tr = records.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * flops / (tr["window_s"] * roofline.PEAKS["bf16_flops_per_s"])
