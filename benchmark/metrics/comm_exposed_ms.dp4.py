"""Exposed DP exchange, in ms a step: the device time in which a
collective (an ``nccl`` kernel) runs and no other kernel, copy or memset
does, a card's mean over the traced steps.  An exchange fully hidden
behind the backward reads 0; None where the trace holds no collective."""


def read(r):
    t = r.trace
    steps = r.traced.get("iterations")
    if t is None or not steps or t.comm_s <= 0:
        return None
    return 1e3 * t.comm_exposed_s / steps
