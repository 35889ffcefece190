"""Rows of the engine's batches that carried a request: requests_served /
(batches_run x batch) over the open loop (the window and, in a traced run,
the stretch after it at the same load), from the engine's own counters,
in % (program_counter)."""
UNIT = "%"
SOURCE = "program_counter"


def read(records: dict):
    if not records.get("batches_run"):
        return None
    return 100.0 * records["requests_served"] / (records["batches_run"] * records["batch"])
