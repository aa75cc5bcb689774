"""The plain reference agrees with the port on small seeded inputs (both in
float64 on the CPU), and a run in a lower precision fails the comparison."""

import io
import math
import time

import pytest
import torch

from harness import cell, compare, controls, data, reference, spec
from harness.system import System


def _batch(root, workload, lanes, stride, seed):
    c = spec.load_cell(workload, root)
    pairs = data.load_pairs(root, c.config["data"]["pairs"])
    pairs = [dict(p, source=p["source"][::stride], target=p["target"][::stride]) for p in pairs]
    cap = -(-c.config["system"]["capacity"] // stride)
    mix = dict(c.traffic, lanes=lanes, distinct_batches=1)
    make = spec.module("generators", c.traffic["kind"], root).make
    return c.config["system"], make(pairs, cap, mix, seed, torch.float64, "cpu")[0]


@pytest.mark.parametrize("workload,lanes,stride", [("trimmed2d-fleet8192", 12, 1),
                                                   ("trimmed3d-multistart512", 3, 16)])
def test_reference_agrees_with_the_port_in_float64(root, workload, lanes, stride):
    settings, b = _batch(root, workload, lanes, stride, 2**31 + 11)
    system = System(settings)
    rot, trans, it = system.call(system.inputs(b))
    ref = reference.register("float64", settings, b.source, b.source_count, b.target,
                             b.target_count, b.rotation, b.translation)
    gaps = compare.gaps(rot, trans, it, ref)
    assert float(gaps["translation_gap_m"].max()) < 1e-9
    assert float(gaps["rotation_gap_rad"].max()) < 1e-9
    assert torch.equal(it.long(), ref["iterations"])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, math.inf])
    assert reference.tf32_round(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, math.inf]


def _run(root, workload, patch, overrides):
    extras = {}
    rc = cell.run(workload, 2**31 + 3, 0.1, False, t_start=time.perf_counter(), root=root,
                  device="cpu", check_chip=False, overrides=overrides, patch=patch,
                  out=io.StringIO(), err=io.StringIO(), extras=extras)
    assert rc == 0
    return extras["result"]


SMALL = {"trimmed2d-fleet8192": dict(lanes=6, distinct_batches=1, sample=6),
         "trimmed3d-multistart512": dict(lanes=2, distinct_batches=1, sample=2,
                                         point_stride=16)}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_reference_in_tf32_in_the_programs_place_is_not_correct(root, workload):
    result = _run(root, workload, controls.tf32_reference, SMALL[workload])
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch", "altered_answer"])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(root, workload, fault):
    result = _run(root, workload, getattr(controls, fault), SMALL[workload])
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_sound_program_is_correct(root, workload):
    assert _run(root, workload, None, SMALL[workload])["correct"] is True
