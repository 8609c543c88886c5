"""The device's idle share of the traced batches of the DINOv3 960px
stream, in %: the part of the profiled span that no kernel, copy or memset
covers (the union of their intervals)."""


def read(r):
    t = r.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
