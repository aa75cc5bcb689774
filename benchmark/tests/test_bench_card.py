"""The cells on the card at a small size: a run is correct, reports its
metrics from the device, and the TF32 controls are not correct: the
reference computed in TF32 in the program's place (the control of
``trimmed2d``), and in 3D the program with its own TF32 path switched on
(the control of ``trimmed3d``)."""

import io
import json
import time

import pytest

from harness import cell, controls

SMALL = {"trimmed2d-fleet8192": dict(lanes=512, distinct_batches=2, sample=128, trace_calls=2),
         "trimmed3d-multistart512": dict(lanes=16, distinct_batches=2, sample=8, trace_calls=1)}


def _run(root, workload, trace, patch=None):
    out, err, extras = io.StringIO(), io.StringIO(), {}
    rc = cell.run(workload, 2**31 + 99, 1.0, trace, t_start=time.perf_counter(), root=root,
                  overrides=SMALL[workload], patch=patch, out=out, err=err, extras=extras)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_on_the_card(cuda_device, root, workload, trace):
    result, err = _run(root, workload, trace)
    assert result["correct"] is True, err
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert set(result["metrics"]) == {"loop_iterations", "active_lane_pct",
                                          "launches_per_call", "nn_roofline_pct",
                                          "device_idle_pct"}
        assert 0 < result["metrics"]["nn_roofline_pct"]["value"] <= 100
        assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_tf32_reference_is_not_correct_on_the_card(cuda_device, root, workload):
    result, _ = _run(root, workload, False, controls.tf32_reference)
    assert result["correct"] is False


@pytest.mark.cuda
def test_the_programs_tf32_path_is_not_correct_in_3d(cuda_device, root):
    import torch

    try:
        result, _ = _run(root, "trimmed3d-multistart512", False, controls.tf32_program)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert result["correct"] is False
