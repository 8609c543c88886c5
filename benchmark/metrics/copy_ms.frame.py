"""Device time of the host-to-device and device-to-host copies a frame,
in ms: the profiler's copy events over the traced calls / frames."""


def read(r):
    t = r.trace
    frames = r.traced.get("frames")
    if t is None or not frames:
        return None
    copies = sum(s for name, s in t.copy_s.items()
                 if "HtoD" in name or "DtoH" in name)
    if copies <= 0:
        return None
    return 1e3 * copies / frames
