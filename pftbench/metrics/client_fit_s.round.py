"""Seconds a round spends in its client_fit phase, the mean over the window's
rounds: client_fit_s of each round's phase record."""


def read(rec):
    phases = rec.get("phases") if rec.get("kind") == "round" else None
    if not phases:
        return None
    return sum(p["client_fit_s"] for p in phases) / len(phases)
