"""Samples of all train steps in the window / the window, which ends at a
synchronise after the last step (host clock)."""
UNIT = "img/s"
SOURCE = "host_clock"


def read(records: dict):
    if not records.get("steps") or "batch" not in records:
        return None
    return records["batch"] * records["steps"] / records["window_s"]
