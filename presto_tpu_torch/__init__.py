"""presto_tpu_torch: the PyTorch/CUDA port of the presto_tpu worker engine.

The package mirrors presto_tpu's layout (common/, spi/, sql/, connectors/,
storage/, exec/, exec/kernels/).  Host-only modules (parser, planner,
optimizer, pages, serde, catalog) are the port's own copies; the modules
that touch a device are rewritten over torch tensors, and the hot path's
fused scan kernel is CUDA C++ for Hopper, generated per chain shape
(exec/kernels/codegen.py over exec/kernels/csrc/scan_common.cuh).

Entry points run on the card (device="cuda") unless the caller asks for
the CPU, where every kernel wrapper runs its plain torch version.
"""

__version__ = "0.1.0"
