"""Share of the pretrain step's device busy time, in %, spent in kernels
that are neither matrix products (cuBLAS and CUTLASS GEMMs, by kernel
name) nor the port's flash kernels: the eager elementwise, reduction,
normalization and optimizer passes."""
import re

PRODUCTS = re.compile(r"gemm|nvjet|xmma|splitKreduce|cublas|flash_",
                      re.IGNORECASE)


def read(r):
    t = r.trace
    if t is None or t.busy_s <= 0:
        return None
    other = sum(s for name, s in t.kernel_s.items()
                if not PRODUCTS.search(name))
    return 100.0 * other / t.busy_s
