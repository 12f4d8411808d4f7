"""Share of the rows the features normalised on the card that went through
the one-pass RMS norm kernel: counter ``kernels.rms_norm.rows`` over it and
``model.rms_norm.plain_rows`` (the plain expression on a CUDA tensor), from
the program's own counters (``repro_torch.obs``).  None where the program
counts neither."""


def read(rec):
    if rec.get("kind") != "round" or not rec.get("trace"):
        return None
    try:
        from repro_torch import obs
    except ImportError:             # a program without counters
        return None
    c = obs.snapshot()["counters"]
    kernel = c.get("kernels.rms_norm.rows", 0)
    n = kernel + c.get("model.rms_norm.plain_rows", 0)
    return 100.0 * kernel / n if n else None
