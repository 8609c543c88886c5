"""The pretrain step's share of the card's bf16 peak over the measured
window, in %: the matmul FLOPs of an image (``costs/dino_pretrain.py``:
three times the student's forward over every crop, the teacher's over the
globals, heads included) x images of the window / its seconds / the
peak."""
from benchmark.harness.peaks import peak


def read(r):
    fl = peak(r.device_kind, "bf16_flops")
    images = r.window.work.get("images")
    if not fl or not images:
        return None
    per_image = r.bench.costs("dino_pretrain").image_flops(r.cell.config)
    return 100.0 * per_image * images / r.window.seconds / fl
