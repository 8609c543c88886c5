"""The DP pretrain step's share of the cards' bf16 peak over the measured
window, in %: the matmul FLOPs of an image (``costs/dino_pretrain.py``)
x the global batch's images of the window / its seconds / (the cards x
one card's peak)."""
from benchmark.harness.peaks import peak


def read(r):
    fl = peak(r.device_kind, "bf16_flops")
    images = r.window.work.get("images")
    if not fl or not images:
        return None
    per_image = r.bench.costs("dino_pretrain").image_flops(r.cell.config)
    return 100.0 * per_image * images / r.window.seconds / (r.cell.chips * fl)
