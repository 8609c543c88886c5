"""Device time of the pretrain step's tail, in ms a step: the port's
``pretrain.update`` span (clip, the last layer's freeze, AdamW, the
teacher's EMA and the centre), timed by CUDA events on the card, over the
steps ``pretrain.step`` saw.  None where the port has no spans or did not
time them on the card."""


def read(r):
    try:
        from dino_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    step, update = t.get("pretrain.step"), t.get("pretrain.update")
    if (not step or not step["count"] or not update
            or update["device_s"] is None):
        return None
    return 1e3 * update["device_s"] / step["count"]
