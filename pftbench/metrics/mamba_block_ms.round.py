"""Milliseconds of device time one Mamba2 layer takes on one features batch:
the mean over the window's ``model.mamba_block`` spans, from the program's
own spans (``repro_torch.obs``)."""


def read(rec):
    if rec.get("kind") != "round" or not rec.get("trace"):
        return None
    try:
        from repro_torch import obs
    except ImportError:             # a program without spans
        return None
    ms = [s["device_ms"] for s in obs.snapshot()["spans"]
          if s["name"] == "model.mamba_block" and s["device_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
