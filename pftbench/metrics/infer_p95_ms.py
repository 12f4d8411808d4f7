"""The 95th percentile of the latency of every inference request due in the
window, from its due time to its result (host clock); a request that was
refused or never served counts as missing (infinite)."""
import numpy as np


def read(rec):
    lat = rec.get("infer_latency_s") if rec.get("kind") == "service" else None
    if lat is None or len(lat) == 0:
        return None
    return 1e3 * float(np.percentile(lat, 95))
