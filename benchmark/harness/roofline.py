"""A kernel's share of its roofline over the traced iterations.

The bound of a launch is the larger of its operations over the card's
bf16 peak and its bytes over the card's memory bandwidth
(``costs/<kernel>.py``; each input byte read once, each output byte
written once).  The driver gives each traced iteration's launches of the
kernel by shape; the trace gives the launches seen and their device
time.  share = (launches seen x the mean bound of an iteration's
launches) / their device time, in %.  No launch in the trace, or a card
without a listed peak: no reading.
"""
from __future__ import annotations

from typing import Optional

from benchmark.harness.peaks import peak


def roofline_share(r, kernel: str, match: Optional[str] = None
                   ) -> Optional[float]:
    if r.trace is None:
        return None
    seconds, n = r.trace.kernels_like(match or kernel)
    mix = r.launches.get(kernel)
    flops_peak = peak(r.device_kind, "bf16_flops")
    bytes_peak = peak(r.device_kind, "hbm_bytes")
    if not n or seconds <= 0 or not mix or not flops_peak or not bytes_peak:
        return None
    costs = r.bench.costs(kernel)
    per_iter = sum(count for count, _ in mix)
    bound = sum(count * max(costs.flops(**a) / flops_peak,
                            costs.bytes_moved(**a) / bytes_peak)
                for count, a in mix)
    return 100.0 * (n * bound / per_iter) / seconds
