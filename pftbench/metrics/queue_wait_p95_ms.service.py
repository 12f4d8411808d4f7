"""The 95th percentile of the time a request waits in the service's queue,
from its submission to the step that admits it: the window's
``serve.queued`` intervals, from the program's own spans
(``repro_torch.obs``, host clock)."""
import numpy as np


def read(rec):
    if rec.get("kind") != "service" or not rec.get("trace"):
        return None
    try:
        from repro_torch import obs
    except ImportError:             # a program without spans
        return None
    wait = [(s["t1_ns"] - s["t0_ns"]) * 1e-6 for s in obs.snapshot()["spans"]
            if s["name"] == "serve.queued"]
    return float(np.percentile(wait, 95)) if wait else None
