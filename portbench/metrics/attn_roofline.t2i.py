"""Self-attention's share of its roofline over the traced txt2img batches:
the least time of ops/self_attention.py's work / the device time of the
kernels its patterns name, in % (device_trace)."""
from portbench.metrics._device import op_roofline

UNIT = "%"
SOURCE = "device_trace"


def read(records: dict):
    return op_roofline(records, "self_attention")
