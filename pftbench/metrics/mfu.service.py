"""The model FLOPs of the window's requests over their real prompt tokens
only (padding is waste) over the window's time, as a share of the bf16
peak."""
from pftbench import workcount


def read(rec):
    if rec.get("kind") != "service" or not rec.get("window_s"):
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / workcount.BF16_FLOPS
