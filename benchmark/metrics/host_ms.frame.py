"""Host time of the serving program a frame, in ms, less its wait for the
card: the port's ``serve.call`` span less its ``serve.wait`` spans (host
seconds) over the calls the spans saw (``serve.call``'s count).  None where
the port has no spans."""


def read(r):
    try:
        from dino_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    call = t.get("serve.call")
    if not call or not call["count"]:
        return None
    wait = t.get("serve.wait", {"host_s": 0.0})["host_s"]
    return 1e3 * (call["host_s"] - wait) / call["count"]
