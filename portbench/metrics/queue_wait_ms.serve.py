"""Median milliseconds from a request's submit to the adapter dispatch that
carries it (the harness's wrapper around the engine's adapter) over the
window (program_span)."""
import statistics

UNIT = "ms"
SOURCE = "program_span"


def read(records: dict):
    waits = records.get("queue_waits")
    return 1e3 * statistics.median(waits) if waits else None
