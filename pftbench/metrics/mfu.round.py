"""The model FLOPs of the window's features (every layer and every use of a
shared block, real positions only, no embedding lookup) over the window's
time, as a share of the bf16 peak."""
from pftbench import workcount


def read(rec):
    if rec.get("kind") != "round" or not rec.get("window_s"):
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / workcount.BF16_FLOPS
