"""Share of the traced window in which no operation ran on the device."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "round" or not tr or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / rec["window_s"])
