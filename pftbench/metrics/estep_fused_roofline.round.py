"""estep_fused's share of its roofline over the traced window: the least time of
the EM's E-steps (operations over the peak of their type or bytes over the
memory bandwidth, from each client's fits and rows, however they are
launched) over the device time of its kernels."""
from pftbench import trace


def read(rec):
    tr, bound = rec.get("trace"), rec.get("bound_s", {}).get("estep_fused")
    if rec.get("kind") != "round" or not tr or not bound:
        return None
    spent = trace.kernel_seconds(tr["kernel_s"], "estep_fused")
    return 100.0 * bound / spent if spent > 0 else None
