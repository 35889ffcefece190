"""The 3x3 convolutions' share of their roofline over the traced txt2img
batches: the least time of ops/conv3x3.py's work / the device time of the
kernels its patterns name, in % (device_trace)."""
from portbench.metrics._device import op_roofline

UNIT = "%"
SOURCE = "device_trace"


def read(records: dict):
    return op_roofline(records, "conv3x3")
