"""The device's idle share of the traced steps over the cards, in %: the
part of the profiled span that no kernel, copy or memset covers (the
union of their intervals), each card's busy and span averaged over the
cards.  An NCCL kernel counts as busy while it waits for its peers."""


def read(r):
    t = r.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
