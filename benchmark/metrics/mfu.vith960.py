"""The DINOv3 segmentation model's share of the card's bf16 peak over the
measured window, in %: its forward's matmul FLOPs a frame at the cell's
resolution (``costs/dinov3_forward.py``) x frames of the window / the
window's seconds / the peak."""
from benchmark.harness.peaks import peak


def read(r):
    fl = peak(r.device_kind, "bf16_flops")
    frames = r.window.work.get("frames")
    if not fl or not frames:
        return None
    per_frame = r.bench.costs("dinov3_forward").seg_frame_flops(
        r.cell.config, r.cell.traffic["resolution"])
    return 100.0 * per_frame * frames / r.window.seconds / fl
