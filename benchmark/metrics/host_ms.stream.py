"""Host time of ``predict_stream`` a frame, in ms, less its waits for the
card: the port's ``stream.stage``, ``stream.submit`` and ``stream.labels``
spans (host seconds) over the frames ``stream.stage`` saw.  The batches
straddle the traced region's edges, so the three need not count the same
frames.  None where the port has no spans."""
PARTS = ("stream.stage", "stream.submit", "stream.labels")


def read(r):
    try:
        from dino_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    if not all(t.get(name, {"count": 0})["count"] for name in PARTS):
        return None
    return (1e3 * sum(t[name]["host_s"] for name in PARTS)
            / t["stream.stage"]["count"])
