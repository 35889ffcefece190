"""Share of the traced segment (whole train steps) in
which no operation ran on the device (device_trace)."""
from portbench.metrics._device import idle_share

UNIT = "%"
SOURCE = "device_trace"
read = idle_share
