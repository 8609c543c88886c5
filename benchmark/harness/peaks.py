"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity), by ``torch.cuda.get_device_name()``.

NVIDIA H100 SXM data sheet: 989 TFLOP/s in bf16 and fp16 on the tensor
cores, 80 GB of HBM3 at 3.35 TB/s, at the full 700 W power limit.  A
card not listed has no peak, and its roofline and mfu metrics are left
out.
"""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak(kind: Optional[str], what: str) -> Optional[float]:
    return PEAKS.get(kind or "", {}).get(what)
