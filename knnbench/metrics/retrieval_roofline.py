"""The least time of the traced window's retrievals, by the problem's shapes
(``bounds.py``), over the device time of every kernel the window launched,
in %. It counts the same work whatever kernels do it."""


def read(r):
    t = r.trace
    if t is None or t.kernel_s <= 0 or t.calls == 0:
        return None
    return 100.0 * t.calls * r.bound_s / t.kernel_s
