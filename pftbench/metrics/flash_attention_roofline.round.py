"""flash_attention's share of its roofline over the traced window: the least time of
its calls (operations over the peak of their type or bytes over the memory
bandwidth, from their shapes) over the device time of its kernels."""
from pftbench import trace


def read(rec):
    tr, bound = rec.get("trace"), rec.get("bound_s", {}).get("flash_attention")
    if rec.get("kind") != "round" or not tr or not bound:
        return None
    spent = trace.kernel_seconds(tr["kernel_s"], "flash_attention")
    return 100.0 * bound / spent if spent > 0 else None
