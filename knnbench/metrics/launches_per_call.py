"""Kernel launches in the traced window over its calls."""


def read(r):
    t = r.trace
    if t is None or t.kernels == 0 or t.calls == 0:
        return None
    return t.kernels / t.calls
