"""Hand-written CUDA kernels of the port (csrc/), their builder
(build.py) and their host-side wrappers.  Each wrapper launches its
kernel for CUDA tensors and runs its plain torch version for CPU
tensors; nothing is built or imported from CUDA at import time.  The
scan kernels (scan_kernel.py, grouped.py, with the join probe of
join.py inside them) and the window kernel (window.py)."""
from .grouped import (scan_hash, scan_hash_plain, scan_span,
                      scan_span_plain, try_grouped_scan_kernel)
from .scan_kernel import (KERNEL_DECLINE_REASONS, KERNEL_HASH_MAX_SLOTS,
                          KERNEL_METRICS, KERNEL_SPAN_MAX_GROUPS, LAUNCHES,
                          build_scan_plan, scan_direct, scan_direct_plain,
                          try_direct_scan_kernel)
from .window import (try_window_kernel, window_scan, window_scan_plain)

__all__ = ["KERNEL_DECLINE_REASONS", "KERNEL_HASH_MAX_SLOTS",
           "KERNEL_METRICS", "KERNEL_SPAN_MAX_GROUPS", "LAUNCHES",
           "build_scan_plan", "scan_direct",
           "scan_direct_plain", "scan_hash", "scan_hash_plain", "scan_span",
           "scan_span_plain", "try_direct_scan_kernel",
           "try_grouped_scan_kernel", "try_window_kernel", "window_scan",
           "window_scan_plain"]
