"""For each call of the traced window, its wall minus the time in which the
card worked for it (kernels, copies, fills), averaged over the calls, in ms:
the host's own share of a call."""


def read(r):
    t = r.trace
    if t is None or t.calls == 0 or t.busy_s <= 0:
        return None
    return (t.call_wall_s - t.call_device_s) / t.calls * 1e3
