"""Requests a service step admits, the mean over the window's steps (of the
pool's slots)."""


def read(rec):
    if rec.get("kind") != "service" or not rec.get("steps"):
        return None
    return rec["rows"] / rec["steps"]
