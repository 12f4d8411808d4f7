"""Milliseconds of device time a client EM iteration takes: the device time
of the window's ``fl.client.em`` spans (each a batched EM, its iterations
and its last E-step) over the iterations they ran (counter
``fl.client.em_iters``), from the program's own spans (``repro_torch.obs``)."""


def read(rec):
    if rec.get("kind") != "round" or not rec.get("trace"):
        return None
    try:
        from repro_torch import obs
    except ImportError:             # a program without spans
        return None
    snap = obs.snapshot()
    ms = [s["device_ms"] for s in snap["spans"]
          if s["name"] == "fl.client.em" and s["device_ms"] is not None]
    n = snap["counters"].get("fl.client.em_iters", 0)
    return sum(ms) / n if ms and n else None
