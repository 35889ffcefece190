"""Host milliseconds per UNet evaluation over the traced batches: the host
clock between the forward pre and post hooks on the program's UNet, the
launch cost of an evaluation (program_span)."""
UNIT = "ms"
SOURCE = "program_span"


def read(records: dict):
    evals = [host for host, _ in (records.get("segment") or {}).get("unet_evals", [])]
    return sum(evals) / len(evals) if evals else None
