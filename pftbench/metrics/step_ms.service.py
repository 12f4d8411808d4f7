"""Milliseconds a ``FedPFTService.step`` takes, the mean over the window's
steps (host clock around each step, which ends with its results on the
host)."""


def read(rec):
    if rec.get("kind") != "service" or not rec.get("steps"):
        return None
    return 1e3 * rec["step_s"] / rec["steps"]
