"""The window slice end to end on the CPU: W1-W3, the reference's
window-kernel shapes and its fuzz seeds 31-35 through the port's
LocalQueryRunner(device="cpu") -- the window kernel's plain version --
return exactly the reference package's rows.  W1-W3 and the kernel's
edge shapes run against the reference's Pallas window kernel (interpret
mode), the other shapes and the fuzz seeds against its XLA scans, which
the reference's parity contract makes bit-identical
(presto_tpu/exec/kernels/window.py:25-34).  The port runs exactly one
window program and declines nothing; a decline for any reason but the
function shape raises."""
import pytest

from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.exec.runner import _assert_rows_equal
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks import window_queries as WQ
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.pipeline import tuned_config
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_threads import one_torch_thread  # noqa: F401


def _window_programs(res) -> int:
    return int((res.runtime_stats or {}).get(
        "kernelWindowPrograms", {}).get("sum", 0))


def _declined(res) -> dict:
    return {k[len("kernelDeclined"):]: int(v["sum"])
            for k, v in (res.runtime_stats or {}).items()
            if k.startswith("kernelDeclined")}


@pytest.fixture(scope="module")
def pallas():
    return JRunner("sf0.01", config=jtuned(scan_kernel="pallas"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def xla():
    return JRunner("sf0.01", config=jtuned(scan_kernel="xla"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", device="cpu")


def _check(port, ref, sql, ordered):
    before = dict(sk.LAUNCHES)
    got = port.execute(sql)
    exp = ref.execute(sql)
    _assert_rows_equal(got, exp, ordered=ordered)
    assert got.column_names == exp.column_names
    assert _window_programs(got) == 1, _declined(got)
    assert not _declined(got)
    # the plain version runs on the CPU: no launch is counted
    assert sk.LAUNCHES == before
    return got, exp


@pytest.mark.parametrize("name", ["W1", "W2", "W3"])
def test_window_queries_equal_reference_kernel(port, pallas, name):
    got, exp = _check(port, pallas, getattr(WQ, name), ordered=True)
    assert len(got.rows) == 100
    assert _window_programs(exp) == 1


# the kernel's edges against the reference's Pallas kernel, the other
# shapes against its XLA scans (each Pallas shape is a compile of its own)
_PALLAS_SHAPES = ("global_partition", "single_row_partitions")


@pytest.mark.parametrize("name", sorted(WQ.KERNEL_SHAPES))
def test_reference_kernel_shapes(port, pallas, xla, name):
    ref = pallas if name in _PALLAS_SHAPES else xla
    _check(port, ref, WQ.KERNEL_SHAPES[name], ordered=False)


@pytest.mark.parametrize("seed", [31, 32, 33, 34, 35])
def test_reference_fuzz_seeds(port, xla, seed):
    _check(port, xla, WQ.window_fuzz_sql(seed), ordered=False)


def test_declined_function_runs_window_batch(port, xla):
    """lag is outside the kernel's functions: one metered
    WindowFunctionShape decline, then operators.window_batch."""
    got = port.execute(WQ.W1_LAG)
    _assert_rows_equal(got, xla.execute(WQ.W1_LAG), ordered=True)
    assert _window_programs(got) == 0
    assert _declined(got) == {"WindowFunctionShape": 1}


def test_xla_mode_declines_disabled_and_raises(xla):
    """scan_kernel=xla is metered (Disabled) and runs operators.window_batch,
    as the reference does; its rows equal the reference's (a pool too
    small for the launch still raises, tests/test_torch_window_kernel.py)."""
    r = LocalQueryRunner("sf0.01", config=tuned_config(scan_kernel="xla"),
                         device="cpu")
    before = sk.KERNEL_METRICS.snapshot()["declined"].get("Disabled", 0)
    got = r.execute(WQ.W2)
    assert sk.KERNEL_METRICS.snapshot()["declined"]["Disabled"] == before + 1
    assert _window_programs(got) == 0
    _assert_rows_equal(got, xla.execute(WQ.W2), ordered=True)
