"""Samples of all the window's rounds over all its time, features, clients,
wire and server included (host clock; each round ends in a synchronize)."""


def read(rec):
    if rec.get("kind") != "round" or not rec.get("window_s"):
        return None
    return rec["samples"] / rec["window_s"]
