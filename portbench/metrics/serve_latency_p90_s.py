"""The 90th percentile (nearest rank) of the latency of every request due
in the window, each from when it was due to its image in the client's
hand; a failed or missing request counts as infinitely late (host_clock).
None where more than a tenth of the requests are missing."""
import math

UNIT = "s"
SOURCE = "host_clock"


def read(records: dict):
    lat = sorted(records.get("latencies") or [])
    if not lat:
        return None
    value = lat[math.ceil(0.9 * len(lat)) - 1]
    return value if math.isfinite(value) else None
