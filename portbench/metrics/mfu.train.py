"""Model FLOPs of the traced train steps (ops/model_step.py: VAE encode,
text forward, UNet forward and backward, a sample) / (the segment x the
bf16 peak), in % (device_trace)."""
from portbench.harness import operation
from portbench.metrics._device import mfu

UNIT = "%"
SOURCE = "device_trace"


def read(records: dict):
    seg = records.get("segment")
    if not seg:
        return None
    per = operation("model_step").train(records["config"], records["traffic"])
    return mfu(records, seg["steps"] * per)
