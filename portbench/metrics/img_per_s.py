"""Images of all batches completed in the window / the window, which closes
at the first batch completion after --seconds (host clock)."""
UNIT = "img/s"
SOURCE = "host_clock"


def read(records: dict):
    if not records.get("completions") or "batch" not in records:
        return None
    return records["batch"] * len(records["completions"]) / records["window_s"]
