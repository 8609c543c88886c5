"""Device time of the DP exchange, in ms a step: the kernels whose name
holds ``nccl`` (the gradients', loss's and teacher mean's all-reduce,
and the waiting for the slowest card inside it), a card's mean over the
traced steps.  None where the trace holds no such kernel (gloo runs its
collectives on the host)."""


def read(r):
    t = r.trace
    steps = r.traced.get("iterations")
    if t is None or not steps:
        return None
    seconds, launches = t.kernels_like("nccl")
    if not launches:
        return None
    return 1e3 * seconds / steps
