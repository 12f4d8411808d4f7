"""Share of the service steps' slot positions (slots x prompt bucket) that
hold a real prompt token, not padding or an unused slot: counters
``serve.real_tokens`` over ``serve.slot_positions``, from the program's own
counters (``repro_torch.obs``)."""


def read(rec):
    if rec.get("kind") != "service" or not rec.get("trace"):
        return None
    try:
        from repro_torch import obs
    except ImportError:             # a program without counters
        return None
    c = obs.snapshot()["counters"]
    n = c.get("serve.slot_positions", 0)
    return 100.0 * c.get("serve.real_tokens", 0) / n if n else None
