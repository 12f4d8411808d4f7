"""Milliseconds of device time a server head step takes: the device time of
the window's ``fl.server.head`` spans over the head steps they ran (counter
``fl.server.head_steps``), from the program's own spans
(``repro_torch.obs``, recorded while the traced window's profiler runs)."""


def read(rec):
    if rec.get("kind") != "round" or not rec.get("trace"):
        return None
    try:
        from repro_torch import obs
    except ImportError:             # a program without spans
        return None
    snap = obs.snapshot()
    ms = [s["device_ms"] for s in snap["spans"]
          if s["name"] == "fl.server.head" and s["device_ms"] is not None]
    n = snap["counters"].get("fl.server.head_steps", 0)
    return sum(ms) / n if ms and n else None
