"""Queries answered, answers on the host, over the whole window (host clock)."""


def read(r):
    return r.queries / r.window_s if r.window_s > 0 else None
