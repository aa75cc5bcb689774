"""Each cell end to end at a tiny size on the CPU, the run's guards, and the
metric readers on a record made by hand."""

import io
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from harness import cell, record, roofline, spec

TINY = {
    "trimmed2d-fleet8192": dict(lanes=4, distinct_batches=2, sample=8, trace_calls=2),
    "trimmed3d-multistart512": dict(lanes=2, distinct_batches=2, sample=4, trace_calls=1,
                                    point_stride=24),
}


def tiny_run(root, workload, trace, **kw):
    out, err, extras = io.StringIO(), io.StringIO(), {}
    rc = cell.run(workload, 2**31 + 7, 0.2, trace, t_start=time.perf_counter(), root=root,
                  device="cpu", check_chip=False, overrides=TINY[workload], out=out, err=err,
                  extras=extras, **kw)
    return rc, out.getvalue(), err.getvalue(), extras


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_runs_end_to_end_on_cpu(root, workload, trace):
    rc, out, err, _ = tiny_run(root, workload, trace)
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True and result["failed"] == 0, err
    assert result["attempted"] % (2 * TINY[workload]["lanes"]) == 0
    names = set(result["metrics"])
    if trace:
        assert {"loop_iterations", "active_lane_pct"} <= names  # no device trace on the CPU
        assert "breakdown" in result and result["device"]["window_s"] > 0
    else:
        assert {"setup_s", "pairs_per_s"} <= names
        assert ("call_p95_ms" in names) == workload.startswith("trimmed2d")
    for name in result["checks"]:
        assert f"check {name} " in err.strip().splitlines()[-len(result["checks"]):][
            list(result["checks"]).index(name)]


def test_run_without_a_card_prints_no_result(root):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "trimmed2d-fleet8192", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_checkout_of_the_benchmark_alone_fails(root, tmp_path):
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with pytest.raises(FileNotFoundError):
        cell.run("trimmed2d-fleet8192", 1, 0.1, False, t_start=time.perf_counter(),
                 root=str(tmp_path), device="cpu", check_chip=False, out=io.StringIO(),
                 err=io.StringIO())


def test_same_seed_same_inputs_other_seed_same_work(root):
    import torch

    from harness import data

    c = spec.load_cell("trimmed2d-fleet8192", root)
    make = spec.module("generators", c.traffic["kind"], root).make
    pairs = data.load_pairs(root, c.config["data"]["pairs"])
    mix = dict(c.traffic, lanes=64, distinct_batches=3)
    a, b, other = (make(pairs, 1024, mix, s, torch.float32, "cpu")
                   for s in (2**31 + 5, 2**31 + 5, 3))
    for x, y in zip(a, b):
        assert torch.equal(x.translation, y.translation) and torch.equal(x.pair, y.pair)
    assert not torch.equal(a[0].translation, other[0].translation)

    def work(batches):  # each batch's lanes, whatever their order
        return sorted(tuple(sorted(zip(x.pair.tolist(), x.translation.sum(-1).tolist())))
                      for x in batches)

    assert work(a) == work(other)


def test_a_metric_that_reads_nothing_ends_the_run_with_no_result(root):
    import contextlib

    def record_nothing(system):
        system.recording_levels = lambda sink: contextlib.nullcontext()

    rc, out, err, _ = tiny_run(root, "trimmed2d-fleet8192", True, patch=record_nothing)
    assert rc == 5 and out == ""
    assert "loop_iterations" in err and "active_lane_pct" in err


def test_a_cell_added_by_files_alone_runs(root, tmp_path):
    """A new cell, with a kind of traffic, an entry, a reference schedule and a
    metric of its own, is new files and a new entry in ``BENCHMARK.json``."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(os.path.join(root, "benchmark"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(root, "ex_data"), tmp_path / "ex_data")
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    for folder, old, new in (("generators", "closed_loop", "closed_loop_copy"),
                             ("entries", "converge", "converge_copy"),
                             ("references/entries", "converge", "converge_copy"),
                             ("metrics", "pairs_per_s", "lanes_per_s")):
        shutil.copy(bench_dir / folder / f"{old}.py", bench_dir / folder / f"{new}.py")
    traffic = spec.load_json(os.path.join(root, "benchmark", "traffic", "multistart512.json"))
    with open(bench_dir / "traffic" / "other.json", "w") as f:
        json.dump(dict(traffic, kind="closed_loop_copy"), f)
    config = spec.load_json(os.path.join(root, "benchmark", "configs", "trimmed3d.json"))
    config["system"]["entry"] = "converge_copy"
    with open(bench_dir / "configs" / "other3d.json", "w") as f:
        json.dump(config, f)
    bench["configs"].append(dict(bench["configs"][1], name="other3d",
                                 file="benchmark/configs/other3d.json"))
    bench["workloads"].append(dict(bench["workloads"][1], name="other3d-cell",
                                   config="other3d", traffic="other"))
    bench["end_to_end"].append({"name": "lanes_per_s", "unit": "pairs/s", "better": "higher",
                                "bound": 0.2, "source": "host_clock",
                                "workloads": ["other3d-cell"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run("other3d-cell", 5, 0.1, False, t_start=time.perf_counter(),
                  root=str(tmp_path), device="cpu", check_chip=False,
                  overrides=TINY["trimmed3d-multistart512"], out=out, err=err)
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True and "lanes_per_s" in result["metrics"]


def _trace(device, levels, wall_s=1.0):
    return record.TraceSlice(calls=1, wall_s=wall_s, device=device, host=[],
                             levels=[levels], nn_per_lane={"init": 1, "iteration": 1})


def test_readers_on_a_record_made_by_hand(root):
    lv = record.Level(source_count=[100, 50], target_count=[200, 200], iterations=[3, 1],
                      dim=2, dtype_bytes=4)
    kernels = [("void nn_kernel<float, 2, true>", 0, 400_000_000),
               ("elementwise", 300_000_000, 500_000_000)]
    run = record.RunRecord(setup_s=4.0, lanes=2, call_starts=[0.0, 1.0], call_ends=[1.0, 3.0],
                           trace=_trace(kernels, [lv], wall_s=1.0))
    read = {m: spec.reader(m, root)(run) for m in (
        "setup_s", "pairs_per_s", "call_p95_ms", "loop_iterations", "active_lane_pct",
        "launches_per_call", "device_idle_pct", "nn_roofline_pct")}
    assert read["setup_s"] == 4.0 and read["pairs_per_s"] == pytest.approx(4 / 3)
    assert read["call_p95_ms"] == pytest.approx(1950.0)
    assert read["loop_iterations"] == 3 and read["active_lane_pct"] == pytest.approx(400 / 6)
    assert read["launches_per_call"] == 2 and read["device_idle_pct"] == pytest.approx(50.0)
    # the start and iteration 1 serve both lanes, iterations 2 and 3 the first
    pairs = 2 * (100 * 200 + 50 * 200) + 2 * (100 * 200)
    assert roofline.nn_bound_s([lv], {"init": 1, "iteration": 1}) == pytest.approx(
        pairs * 5 / roofline.PEAK_F32_FLOPS)
    assert read["nn_roofline_pct"] == pytest.approx(100 * pairs * 5 / 67e12 / 0.4)


def test_readers_return_nothing_without_a_trace(root):
    run = record.RunRecord(setup_s=1.0, lanes=1, call_starts=[0.0], call_ends=[1.0])
    for m in ("loop_iterations", "active_lane_pct", "launches_per_call", "device_idle_pct",
              "nn_roofline_pct"):
        assert spec.reader(m, root)(run) is None
