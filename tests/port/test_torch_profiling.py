"""``icp_tpu_torch.utils.profiling`` against ``icp_tpu.utils.profiling``:
``nn_roofline`` equal on a grid of shapes; ``time_fn`` counts its runs and
waits for the work; a CPU ``trace`` writes a Chrome trace that reads back
with the traced ops; ``nvtx_range`` does nothing off the card."""

import json
import time

import pytest
import torch

from icp_tpu.utils import profiling as jax_profiling
from icp_tpu_torch.utils import profiling


@pytest.mark.parametrize("batch", [1, 256, 1024])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n,m", [(1024, 1024), (10720, 10720), (512, 40000), (1, 7)])
def test_nn_roofline_equals_jax(n, m, dim, batch):
    for dtype_bytes in (4, 8):
        assert profiling.nn_roofline(n, m, dim, batch, dtype_bytes) == jax_profiling.nn_roofline(
            n, m, dim, batch, dtype_bytes)


def test_time_fn_counts_runs_and_waits():
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.01)
        return x

    timing = profiling.time_fn(fn, 3, runs=4, warmup=2)
    assert calls == [3] * 6 and timing.runs == 4
    assert 0.04 <= timing.seconds < 5.0 and timing.per_run == pytest.approx(timing.seconds / 4)
    assert profiling.Timing(1.0, 0).per_run == 1.0


def test_cpu_trace_writes_chrome_trace(tmp_path):
    a = torch.randn(64, 64, dtype=torch.float64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.nvtx_range("matmul", a.device):
            torch.matmul(a, a)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_nvtx_range_is_inert_off_the_card():
    with profiling.nvtx_range("nothing", "cpu"):
        pass
    with profiling.nvtx_range("nothing", torch.device("cpu")):
        pass


@pytest.mark.cuda
def test_cuda_trace_sees_kernels(cuda_device, tmp_path):
    a = torch.randn(256, 256, device=cuda_device)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.nvtx_range("matmul", cuda_device):
            torch.matmul(a, a)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels and (tmp_path / "trace.json").stat().st_size > 0
