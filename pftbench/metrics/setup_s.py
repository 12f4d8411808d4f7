"""Seconds from the process's start to the window's: imports, kernels loaded
(or built, in a checkout's first run), weights and data made, shapes warmed."""


def read(rec):
    return rec.get("setup_s")
