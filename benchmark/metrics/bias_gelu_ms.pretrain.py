"""Device time of fc1's bias-GELU pass in the pretrain step, in ms a step:
the kernels whose name holds ``bias_gelu`` (the forward, the backward and
its partial sums' reduction; the student's 12 blocks over both crop
groups), over the traced steps.  None where the trace holds no such
kernel, as in a port without the pass."""


def read(r):
    t = r.trace
    steps = r.traced.get("iterations")
    if t is None or not steps:
        return None
    seconds, launches = t.kernels_like("bias_gelu")
    if not launches:
        return None
    return 1e3 * seconds / steps
