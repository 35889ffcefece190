"""Model FLOPs of the traced txt2img batches (ops/model_step.py) / (the
segment x the bf16 peak), in % (device_trace)."""
from portbench.harness import operation
from portbench.metrics._device import mfu

UNIT = "%"
SOURCE = "device_trace"


def read(records: dict):
    seg = records.get("segment")
    if not seg:
        return None
    per = operation("model_step").txt2img(records["config"], records["traffic"])
    return mfu(records, seg["batches"] * per)
