"""Host time of ``predict_stream`` staging a frame, in ms: the port's
``stream.stage`` span (the frame as uint8, copied into the pinned batch)
over the frames it saw.  None where the port has no spans."""


def read(r):
    try:
        from dino_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    stage = span_totals().get("stream.stage")
    if not stage or not stage["count"]:
        return None
    return 1e3 * stage["host_s"] / stage["count"]
