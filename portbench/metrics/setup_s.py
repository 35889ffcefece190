"""Seconds from process start to the start of the window: imports, loading
or building the kernels, weights from the seed, warm-up (host clock)."""
UNIT = "s"
SOURCE = "host_clock"


def read(records: dict):
    return records.get("setup_s")
