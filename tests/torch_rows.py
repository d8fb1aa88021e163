"""The parity tests' row comparison: presto_tpu_torch/benchmarks/rows.py
(the chip script's torch-chain phase uses the same)."""
from presto_tpu_torch.benchmarks.rows import (  # noqa: F401
    assert_rows_close, values_close)
