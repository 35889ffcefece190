"""Host milliseconds from the call of the program's train step to its
return, the mean over the traced steps: the step's enqueue cost, and any
wait inside it (program_span)."""
UNIT = "ms"
SOURCE = "program_span"


def read(records: dict):
    host = (records.get("segment") or {}).get("step_host_ms")
    return sum(host) / len(host) if host else None
