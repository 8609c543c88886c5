"""Device ms a frame of the DINOv3 blocks' MLPs (the port's ``vit.mlp``
spans: LN2, the w1 and w2 product, SwiGLU's epilogue, w3, LayerScale and
the residual add), over the traced frames.  None where the port has no
such span."""


def read(r):
    try:
        from dino_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    mlp = span_totals().get("vit.mlp")
    frames = r.traced.get("frames")
    if not mlp or not mlp["count"] or mlp["device_s"] is None or not frames:
        return None
    return 1e3 * mlp["device_s"] / frames
