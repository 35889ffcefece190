"""Share of the traced segment (a stretch of the open-loop window) in
which no operation ran on the device (device_trace)."""
from portbench.metrics._device import idle_share

UNIT = "%"
SOURCE = "device_trace"
read = idle_share
