"""Host time of the pretrain step, in ms: the port's ``pretrain.step`` span
(host seconds) over the steps it saw.  The host enqueues the step's work
without waiting for the card, so this is its headroom under the device's
step.  None where the port has no spans."""


def read(r):
    try:
        from dino_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    step = span_totals().get("pretrain.step")
    if not step or not step["count"]:
        return None
    return 1e3 * step["host_s"] / step["count"]
