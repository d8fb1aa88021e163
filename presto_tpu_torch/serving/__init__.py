"""Serving tier of the port (presto_tpu/serving/): prepared statements,
the canonical plan/executable cache, micro-batching, fragment sharing and
warm restarts.

The pieces:
  sql/canonical.py   plan parameterization + cache keys
  serving/cache.py   LRU of (optimized template, PlanCompiler) entries
  serving/prepared.py  PREPARE/EXECUTE registry + the skip-parse-and-plan
                     fast path
  serving/metrics.py process-wide counters for /v1/metrics and /v1/status
  serving/batching.py  micro-batcher: concurrent same-template EXECUTEs
                     collapse into one batched drain
  serving/batched.py the per-template batched executor behind the batcher
  serving/persist.py durable sidecar + the generated kernels' cubin
                     cache: a restart warm-starts without recompiling
  serving/fragments.py  structural-key step sharing across plans
  worker/statement.py  weighted fair-share + memory-headroom admission

serving/batched.py imports exec.pipeline, so it is NOT imported here --
exec.pipeline lazily imports serving.fragments, and an eager import
would make that a cycle.  Import it as `presto_tpu_torch.serving.batched`.
"""
from .batching import MicroBatcher
from .cache import GLOBAL_PLAN_CACHE, PlanCache
from .fragments import FRAGMENT_JIT_CACHE, FragmentJitCache
from .metrics import SERVING_METRICS
from .persist import PlanCacheSidecar, enable_compilation_cache
from .prepared import PREPARED_REGISTRY, PreparedRegistry

__all__ = ["GLOBAL_PLAN_CACHE", "PlanCache", "SERVING_METRICS",
           "PREPARED_REGISTRY", "PreparedRegistry", "MicroBatcher",
           "FRAGMENT_JIT_CACHE", "FragmentJitCache", "PlanCacheSidecar",
           "enable_compilation_cache"]
