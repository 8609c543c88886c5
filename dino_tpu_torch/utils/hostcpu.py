"""Host-CPU capability tag for machine-specific on-disk caches.

The native loader (``data/native_loader.py``) is built with
``-march=native``, so the library is valid only on the CPU that built it.
Its file name carries this tag, so a checkout shared between hosts of
different CPU generations never loads a library built for another CPU.
The port's own copy of ``dino_tpu/utils/hostcpu.py:cpu_tag``.
"""
from __future__ import annotations

import hashlib
import platform


def cpu_tag() -> str:
    """Hash of the host CPU's ISA flags (not the hostname: containers often
    share hostname and machine type across CPU generations)."""
    sig = platform.machine()
    got_flags = False
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    sig += " ".join(sorted(line.split(":", 1)[1].split()))
                    got_flags = True
                    break
    except OSError:
        pass
    if not got_flags:
        # no flags line (non-Linux, or another cpuinfo format): key per host
        # rather than let CPU generations collide on one machine() slot
        sig += platform.node()
    return hashlib.md5(sig.encode()).hexdigest()[:8]
