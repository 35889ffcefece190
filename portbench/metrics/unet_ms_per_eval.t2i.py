"""Device milliseconds per UNet evaluation over the traced batches: CUDA
events recorded by forward pre / post hooks on the program's UNet, the
mean over its evaluations (program_span)."""
UNIT = "ms"
SOURCE = "program_span"


def read(records: dict):
    evals = [dev for _, dev in (records.get("segment") or {}).get("unet_evals", [])
             if dev is not None]
    return sum(evals) / len(evals) if evals else None
