"""``python -m icp_tpu_torch.cli``: ``register``, ``odometry``, ``graph`` and
``methods`` against the JAX CLI, both on the CPU.  Both load scans in
float32, so poses agree at float32 tolerance (atol 1e-5; 1e-4 through the
float32 pose-graph solves of ``odometry --optimize`` and ``--online``);
iteration counts, keyframe / refined / closure fields and the ``--save``
file's layout are equal, and so are the ``--eval`` records (rtol 1e-4).
``graph`` reads g2o files in float64 on the CPU on both sides, so its JSON
record agrees to 1e-8 relative."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

import icp_tpu_torch as T
from icp_tpu import cli as jax_cli
from icp_tpu_torch import cli, convert
from icp_tpu_torch.io import read_ply, write_tum

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(REPO, "ex_data")
CASES = {
    "scan1 trimmed": ["-S", f"{DATA}/scan1/first.csv", "-D", f"{DATA}/scan1/second.csv",
                      "-m", "trimmed"],
    "torus trimmed 3D": ["--ply", "-S", f"{DATA}/ply/torus_transformed.ply",
                         "-D", f"{DATA}/ply/torus.ply", "-m", "trimmed"],
}
# The -c keys of the net-new families, and the typed Config they must parse to.
FAMILY_KEYS = {
    "ndt": (["cell_size=0.5", "cells=1024", "variant=d2d", "lookup=sorted"],
            dict(cell_size=0.5, cells=1024, variant="d2d", lookup="sorted")),
    "gicp": (["neighbors=10", "line_search=0"], dict(neighbors=10, line_search=0)),
}


def _run(main, capsys, args, platform="cpu"):
    main(["--platform", platform, "register", *args, "--json"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_register_matches_jax_cli(capsys, case):
    got = _run(cli.main, capsys, CASES[case])
    want = _run(jax_cli.main, capsys, CASES[case])
    assert got["method"] == want["method"] and got["iterations"] == want["iterations"]
    np.testing.assert_allclose(got["rotation"], want["rotation"], atol=1e-5)
    np.testing.assert_allclose(got["translation"], want["translation"], atol=1e-5)
    np.testing.assert_allclose(got["cost"], want["cost"], atol=1e-5)


@pytest.mark.parametrize("name", sorted(FAMILY_KEYS))
def test_register_new_family_keys(capsys, name):
    """``-c`` parses gicp's and NDT's keys to their types: the CLI's pose is
    the library's under the typed Config (float32 on the CPU, as the CLI
    loads)."""
    import torch

    import icp_tpu_torch as T

    keys, typed = FAMILY_KEYS[name]
    got = _run(cli.main, capsys, [*CASES["scan1 trimmed"][:4], "-m", name, "-c", *keys,
                                  "--exact-capacity", "--max-iterations", "50",
                                  "--translation-tolerance", "0.01"])
    assert got["method"] == name
    a, b = (T.io.parse_lidar_scan_array(CASES["scan1 trimmed"][i]) for i in (1, 3))
    want, _ = T.converge(
        T.from_method(name, 2, T.Config(**typed)),
        *(T.from_points(p, dtype=torch.float32, device="cpu") for p in (a, b)),
        T.identity(2, dtype=torch.float32, device="cpu"),
        T.DriverConfig(max_iterations=50, angle_tolerance=float(np.deg2rad(0.1)),
                       translation_tolerance=0.01))
    assert got["iterations"] == int(want.iteration_count)
    np.testing.assert_allclose(got["translation"], want.transform.translation.numpy(), atol=1e-6)


def test_register_out_ply_and_text(capsys, tmp_path):
    out = str(tmp_path / "moved.ply")
    cli.main(["--platform", "cpu", "register", *CASES["scan1 trimmed"], "--multiscale",
              "--exact-capacity", "--out-ply", out])
    text = capsys.readouterr().out
    assert "converged in" in text and f"wrote {out}" in text
    moved = read_ply(out)
    assert moved.shape[1] == 3 and not moved[:, 2].any()


def test_register_unknown_method_lists_registry(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--platform", "cpu", "register", *CASES["scan1 trimmed"][:4], "-m", "nope"])
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert "unknown ICP method 'nope'" in err
    for name in ("vanilla", "trimmed", "feature_aware"):
        assert f"* {name}" in err


def test_methods_lists_both_dims(capsys):
    cli.main(["methods"])
    assert capsys.readouterr().out.splitlines() == [
        "2D: feature_aware, gicp, ndt, point_to_plane, robust, symmetric, trimmed, vanilla",
        "3D: gicp, ndt, point_to_plane, robust, symmetric, trimmed, vanilla"]


def test_gpu_platform_needs_a_card(capsys, monkeypatch):
    """The default platform is the card; without one it exits, never falling
    back to the CPU."""
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        cli.main(["register", *CASES["scan1 trimmed"]])


def test_register_sor_and_coarse_match_jax_cli(capsys):
    args = [*CASES["scan1 trimmed"], "--sor", "--coarse"]
    got = _run(cli.main, capsys, args)
    want = _run(jax_cli.main, capsys, args)
    assert got["iterations"] == want["iterations"]
    np.testing.assert_allclose(got["rotation"], want["rotation"], atol=1e-5)
    np.testing.assert_allclose(got["translation"], want["translation"], atol=1e-5)


SWEEPS = sorted(glob.glob(f"{DATA}/seq1/sweep_*.conf"))[:6]


@pytest.fixture(scope="module")
def gt_tum(tmp_path_factory):
    """seq1's ground truth of the first 6 sweeps as a 2D TUM file."""
    with open(f"{DATA}/seq1/groundtruth.json") as f:
        gt = np.asarray(json.load(f)["poses"])[: len(SWEEPS)]
    c, s = np.cos(gt[:, 2]), np.sin(gt[:, 2])
    path = str(tmp_path_factory.mktemp("gt") / "seq1.tum")
    write_tum(path, convert.transform_from_numpy(
        np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2), gt[:, :2], device="cpu"))
    return path


def _odometry(main, capsys, args):
    main(["--platform", "cpu", "odometry", *args])
    captured = capsys.readouterr()
    return [json.loads(line) for line in captured.out.strip().splitlines()], captured.err


ODOMETRY = {
    "batch": ["--scans", *SWEEPS],
    "batch csv": ["--scans", f"{DATA}/scan1/first.csv", f"{DATA}/scan1/second.csv",
                  f"{DATA}/scan1/first.csv", "--exact-capacity"],
    "scan-to-map": ["--scans", *SWEEPS, "--scan-to-map", "-m", "robust",
                    "--voxel-size", "0.1", "--map-capacity", "2048"],
    "scan-to-map device map": ["--scans", *SWEEPS, "--scan-to-map", "-m", "robust",
                               "--map-capacity", "2048", "--device-map"],
}


@pytest.mark.parametrize("case", sorted(ODOMETRY))
def test_odometry_matches_jax_cli(capsys, gt_tum, case):
    args = ODOMETRY[case] + (["--eval", gt_tum] if "csv" not in case else [])
    got, _ = _odometry(cli.main, capsys, args)
    want, _ = _odometry(jax_cli.main, capsys, args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        if "eval_against" in w:
            for key in w:
                if key != "eval_against":
                    np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-7)
            continue
        assert g["scan"] == w["scan"] and g.get("keyframe") == w.get("keyframe")
        assert g.get("iterations") == w.get("iterations")
        np.testing.assert_allclose(g["rotation"], w["rotation"], atol=1e-5)
        np.testing.assert_allclose(g["translation"], w["translation"], atol=1e-5)
    assert ("eval_against" in got[-1]) == ("csv" not in case)


@pytest.mark.parametrize("flag", ["--coarse", "--multiscale"])
def test_odometry_flags_run_the_library_chain(capsys, flag):
    """``--coarse`` / ``--multiscale`` print the library's float32 chain
    exactly.  (Against the JAX CLI they agree only to float32's reach: the
    coarse guess's sub-bin parabola cancels, c0 - 2 c1 + c2, so the two
    frameworks' float32 guesses differ by ~1e-5 rad; the chains are held
    against JAX in float64 in test_torch_odometry.py.)"""
    import torch

    import icp_tpu_torch as T
    from icp_tpu_torch import odometry

    got, _ = _odometry(cli.main, capsys, ["--scans", *SWEEPS, flag])
    clouds = [T.io.parse_sweep(p, dtype=torch.float32, device="cpu") for p in SWEEPS]
    cap = T.bucket_capacity(max(c.capacity for c in clouds))
    traj = odometry.chain_scans(
        T.stack([T.pad_to(c, cap) for c in clouds]), T.from_method("trimmed", 2),
        T.DriverConfig(max_iterations=100, angle_tolerance=float(np.deg2rad(0.1)),
                       translation_tolerance=0.1), **{flag[2:]: True})
    for t, rec in enumerate(got):
        assert rec["translation"] == traj.poses.translation[t].tolist()
        assert rec["rotation"] == traj.poses.rotation[t].tolist()
        if t:
            assert rec["iterations"] == int(traj.registration.iteration_count[t - 1])


def test_odometry_scan_to_map_hint_and_ignored_flags(capsys):
    got, err = _odometry(cli.main, capsys, ["--scans", *SWEEPS[:3], "--scan-to-map",
                                            "--coarse", "--multiscale", "--max-iterations", "5"])
    assert len(got) == 3 and got[0]["keyframe"] is True
    assert "hint: method 'trimmed' is a hard-overlap method" in err
    assert "--coarse is not supported with --scan-to-map" in err
    assert "--multiscale is not supported with --scan-to-map" in err


@pytest.mark.parametrize("flag", ["--optimize", "--online", "--loop-radius=2.0",
                                  "--loop-descriptor=30", "--pipelined", "--async-refine",
                                  "--odometry-weight=100", "--save=out.npz"])
def test_odometry_refuses_slam_flags(capsys, tmp_path, monkeypatch, flag):
    """The SLAM flags run: the offline back end (``--optimize``,
    ``--loop-radius``, ``--loop-descriptor``), online SLAM (``--online``,
    with ``--pipelined``, ``--async-refine`` and ``--odometry-weight``
    taking effect under it) and ``--save``.  Only ``--aot-cache`` is still
    refused by argparse (with ``--async-refine``'s case)."""
    monkeypatch.chdir(tmp_path)
    args = ["--platform", "cpu", "odometry", "--scans", *SWEEPS[:2], flag]
    if flag == "--async-refine":
        cli.main([*args, "--online"])
        captured = capsys.readouterr()
        assert len(captured.out.strip().splitlines()) == 2
        assert "online slam: " in captured.err
        with pytest.raises(SystemExit) as exc:
            cli.main([*args[:-1], "--aot-cache=cache"])
        assert exc.value.code == 2
        assert "unrecognized arguments" in capsys.readouterr().err
        return
    cli.main(args)
    captured = capsys.readouterr()
    assert len(captured.out.strip().splitlines()) == 2
    if flag in ("--optimize", "--loop-radius=2.0", "--loop-descriptor=30"):
        assert "pose-graph cost:" in captured.err
    elif flag == "--online":
        assert "online slam: " in captured.err
    elif flag == "--save=out.npz":
        assert "saved trajectory to out.npz" in captured.err
        assert np.load("out.npz")["leaf_1"].shape == (2, 2)


SEQ2 = sorted(glob.glob(f"{DATA}/seq2loop/sweep_*.conf"))[:10]
ONLINE_ARGS = ["--scans", *SEQ2, "--loop-every", "2", "--loop-min-separation", "3",
               "--odometry-weight", "100", "--loop-weight", "100", "--keyframe-translation",
               "0.25", "--max-iterations", "50", "--translation-tolerance", "1e-4",
               "--angle-tolerance-deg", "1e-3"]
ONLINE = {
    "online": ["--online", "--loop-radius", "2.0", "--robust-kernel", "gnc_gm"],
    "online pipelined descriptor": ["--online", "--pipelined", "--loop-descriptor", "30",
                                    "--descriptor-max-distance", "0.5"],
    "offline descriptor": ["--loop-descriptor", "30", "--descriptor-max-distance", "0.5"],
}


@pytest.mark.parametrize("case", sorted(ONLINE))
def test_odometry_slam_matches_jax_cli(capsys, tmp_path, case):
    """``odometry --online`` (serial under gnc_gm; pipelined with the
    descriptor detector and no kernel) and the offline ``--loop-descriptor``
    on 10 seq2loop sweeps against the JAX CLI, both in float32: the JSON
    records (poses at 1e-4, keyframe / refined / closures exact), the stderr
    lines, and the ``--save`` file's leaves at 1e-4."""
    saved = {}
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        saved[name] = str(tmp_path / f"{name}.npz")
        records, err = _odometry(main, capsys, [*ONLINE_ARGS, *ONLINE[case], "--save",
                                                saved[name]])
        outs[name] = records, err.replace(saved[name], "OUT")
    (got, err), (want, jerr) = outs["port"], outs["jax"]
    assert len(got) == len(want) == len(SEQ2)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("scan", "keyframe", "refined", "closures", "iterations"):
            assert g.get(key) == w.get(key), key
        np.testing.assert_allclose(g["rotation"], w["rotation"], atol=1e-4)
        np.testing.assert_allclose(g["translation"], w["translation"], atol=1e-4)
    lines = [line.split(":")[0] for line in err.splitlines()]
    assert lines == [line.split(":")[0] for line in jerr.splitlines()]
    assert err.splitlines()[0].split(" (")[0] == jerr.splitlines()[0].split(" (")[0]
    if case.startswith("online"):
        assert any(r["closures"] for r in got) or "closures" in err
    assert "trajectory to OUT" in err
    port_leaves = T.checkpoint.load_leaves(saved["port"])
    jax_leaves = T.checkpoint.load_leaves(saved["jax"])
    assert [a.shape for a in port_leaves] == [a.shape for a in jax_leaves]
    for a, b in zip(port_leaves, jax_leaves):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_odometry_online_async_refine_quality(capsys, tmp_path):
    """``--online --async-refine`` on the 10 seq2loop sweeps: every record
    streams, refinements land, and the finalized keyframe trajectory is
    within 5 cm of the synchronous run's (``tests/test_online_slam.py``'s
    limit for the library; the apply timing is not pinned here)."""
    runs = {}
    for name, extra in (("sync", []), ("async", ["--async-refine"])):
        path = str(tmp_path / f"{name}.npz")
        records, err = _odometry(cli.main, capsys, [*ONLINE_ARGS, *ONLINE["online"], *extra,
                                                    "--save", path])
        runs[name] = records, err, T.checkpoint.load_leaves(path)
    (records, err, (_, kf_async)), (sync_records, _, (_, kf_sync)) = runs["async"], runs["sync"]
    assert len(records) == len(SEQ2) and "online slam: " in err
    assert [r["keyframe"] for r in records] == [r["keyframe"] for r in sync_records]
    assert any(r["refined"] for r in records) or "finalize ran a refinement" in err
    assert kf_async.shape == kf_sync.shape
    assert float(np.linalg.norm(kf_async - kf_sync, axis=-1).max()) < 0.05


@pytest.mark.parametrize("case", ["batch", "scan-to-map"])
def test_odometry_render_writes_png(capsys, tmp_path, case):
    out = str(tmp_path / "traj.png")
    extra = ["--scan-to-map", "--max-iterations", "5"] if case == "scan-to-map" else []
    records, err = _odometry(cli.main, capsys, ["--scans", *SWEEPS[:3], *extra, "--render", out])
    assert len(records) == 3 and f"wrote {out}" in err
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _view_lines(main, capsys, out_dir, extra=()):
    main(["--platform", "cpu", "view", *CASES["scan1 trimmed"], "-l", "--iterations", "4",
          "--every", "2", "--out", str(out_dir), *extra])
    return capsys.readouterr().out.strip().splitlines()


def test_view_log_matches_jax_cli(capsys, tmp_path):
    """``view -l``: one dump line per iteration (iteration exact, cost and
    translation at float32 tolerance) and the same frames as the JAX CLI;
    ``--view-conf`` and ``--animate`` run."""
    conf = tmp_path / "view.conf"
    conf.write_text("window_width = 400\nwindow_height = 300\nview_scale = 25\n# note\n")
    got = _view_lines(cli.main, capsys, tmp_path / "port",
                      ["--view-conf", str(conf), "--animate", str(tmp_path / "a.html")])
    want = _view_lines(jax_cli.main, capsys, tmp_path / "jax")
    assert got[-1] == f"wrote animation {tmp_path / 'a.html'}"
    got = got[:-1]
    assert len(got) == len(want) == 7
    for g, w in zip(got[:5], want[:5]):
        gi, gc, gt = (part.split("=", 1)[1] for part in g.split(" ", 2))
        wi, wc, wt = (part.split("=", 1)[1] for part in w.split(" ", 2))
        assert gi == wi
        assert float(gc) == pytest.approx(float(wc), abs=2e-6)
        np.testing.assert_allclose(json.loads(gt), json.loads(wt), atol=1e-5)
    assert (got[5], want[5]) == (f"wrote 3 frames to {tmp_path / 'port'}",
                                 f"wrote 3 frames to {tmp_path / 'jax'}")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert cli._parse_view_conf(str(conf)) == {"window_width": 400.0, "window_height": 300.0,
                                               "view_scale": 25.0}


def _bench_report(main, capsys, args):
    main(["--platform", "cpu", "bench", "--data-dir", DATA, *args])
    return [line for line in capsys.readouterr().out.splitlines()
            if "time per" not in line and "Batched" not in line]


def test_bench_matches_jax_cli(capsys):
    """``bench``'s report against the JAX CLI's on scans 1 and 2 (two of the
    eight 2D methods, for the test's time), the timing lines aside: the
    same lines, iteration statistics equal, costs at float32 tolerance;
    ``--batch`` adds the throughput line."""
    args = ["--invocations", "2", "--methods", "vanilla", "trimmed", "--scans", "1", "2"]
    got = _bench_report(cli.main, capsys, args)
    want = _bench_report(jax_cli.main, capsys, args)
    assert len(got) == len(want) == 4 * 10
    for g, w in zip(got, want):
        key, _, value = g.partition(": ")
        assert key == w.partition(": ")[0]
        if "cost" in key:
            assert float(value) == pytest.approx(float(w.partition(": ")[2]), rel=1e-4)
        else:
            assert g == w
    cli.main(["--platform", "cpu", "bench", "--data-dir", DATA, "--invocations", "1",
              "--methods", "vanilla", "--scans", "1", "--batch", "4"])
    assert "* Batched throughput (4 pairs/invocation):" in capsys.readouterr().out


def test_odometry_eval_pose_count_mismatch(capsys, gt_tum):
    with pytest.raises(SystemExit, match="ground truth has 6 poses"):
        cli.main(["--platform", "cpu", "odometry", "--scans", *SWEEPS[:3], "--eval", gt_tum])


M600 = f"{DATA}/manhattan/m600.g2o"
GRAPH = {
    "gnc_gm pcg": ["--robust-kernel", "gnc_gm", "--solver", "pcg"],
    "welsch two-pass": ["--robust-kernel", "welsch", "--scale-passes", "2", "--solver", "pcg",
                        "--iterations", "15"],
}


def _graph(main, capsys, args):
    main(["--platform", "cpu", "graph", *args])
    captured = capsys.readouterr()
    return json.loads(captured.out.strip().splitlines()[-1]), captured.err


@pytest.mark.parametrize("case", sorted(GRAPH))
def test_graph_matches_jax_cli(capsys, tmp_path, case):
    out = str(tmp_path / "opt.g2o")
    got, err = _graph(cli.main, capsys, [M600, *GRAPH[case], "-o", out])
    want, jerr = _graph(jax_cli.main, capsys, [M600, *GRAPH[case]])
    assert sorted(got) == sorted(want)
    assert (got["vertices"], got["edges"]) == (want["vertices"], want["edges"]) == (600, 1210)
    np.testing.assert_allclose(got["chi2_initial"], want["chi2_initial"], rtol=1e-10)
    np.testing.assert_allclose(got["chi2_final"], want["chi2_final"], rtol=1e-8)
    # The same stderr lines, numbers aside.
    assert [line.split(":")[0] for line in err.splitlines() if "wrote" not in line] == [
        line.split(":")[0] for line in jerr.splitlines()]
    assert f"wrote {out}" in err and os.path.getsize(out) > 0
    if case.startswith("gnc_gm"):
        assert "robust scale (auto): 1.786" in err  # the verify recipe's ~1.79
        assert got["chi2_final"] < 1.3e3


def test_graph_outlier_protocol_and_tum(capsys, tmp_path):
    """``--outlier-protocol`` prints one JSON record per (mode, rate, kernel),
    the records of ``robustness.run_protocol``; ``--tum`` writes the
    trajectory."""
    from icp_tpu_torch import robustness
    from icp_tpu_torch.io import read_g2o, write_g2o

    small = str(tmp_path / "small.g2o")
    graph = read_g2o(M600, device="cpu")
    keep = (graph.edges_ij < 120).all(-1)
    write_g2o(small, dataclasses.replace(
        graph, poses=T.geometry.RigidTransform(graph.poses.rotation[:120],
                                               graph.poses.translation[:120]),
        edges_ij=graph.edges_ij[keep],
        measurements=T.geometry.RigidTransform(graph.measurements.rotation[keep],
                                               graph.measurements.translation[keep]),
        weights=graph.weights[keep], sqrt_information=graph.sqrt_information[keep]))
    cli.main(["--platform", "cpu", "graph", small, "--outlier-protocol", "--outlier-rates",
              "0.2", "--outlier-modes", "random", "--protocol-kernels", "none,welsch",
              "--iterations", "10", "--solver", "dense", "--scale-passes", "2",
              "--protocol-seed", "3"])
    captured = capsys.readouterr()
    recs = [json.loads(line) for line in captured.out.strip().splitlines()]
    want = robustness.run_protocol(read_g2o(small, device="cpu"), rates=(0.2,),
                                   modes=("random",), kernels=("none", "welsch"),
                                   iterations=10, solver="dense", seed=3, scale_passes=2)
    assert recs == json.loads(json.dumps(want))
    tum = str(tmp_path / "traj.tum")
    got, err = _graph(cli.main, capsys, [small, "--iterations", "3", "--tum", tum])
    assert f"wrote {tum}" in err and len(open(tum).read().splitlines()) == 120


BACK_END = {
    "loops gnc_gm closure-information": [
        "--loop-radius", "2.0", "--loop-min-separation", "4", "--robust-kernel", "gnc_gm",
        "--closure-information", "--loop-weight", "100"],
    "loops welsch two-pass": [
        "--loop-radius", "2.0", "--loop-min-separation", "4", "--robust-kernel", "welsch",
        "--mapping-threshold", "2", "--loop-max-cost", "1.0", "--gn-iterations", "12"],
}


@pytest.mark.parametrize("case", sorted(BACK_END))
def test_odometry_back_end_matches_jax_cli(capsys, case):
    """``odometry --optimize --loop-radius`` on the first 8 seq1 sweeps: the
    closures found, registered and accepted, the stderr report and the
    optimized poses, against the JAX CLI (both float32)."""
    args = ["--scans", *sorted(glob.glob(f"{DATA}/seq1/sweep_*.conf"))[:8], *BACK_END[case]]
    got, err = _odometry(cli.main, capsys, args)
    want, jerr = _odometry(jax_cli.main, capsys, args)
    lines = [line.split(":")[0] for line in err.splitlines()]
    assert lines == [line.split(":")[0] for line in jerr.splitlines()]
    assert lines[0] == "loop closures" and err.splitlines()[0].split(" (")[0] == \
        jerr.splitlines()[0].split(" (")[0]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["scan"] == w["scan"] and g.get("iterations") == w.get("iterations")
        np.testing.assert_allclose(g["rotation"], w["rotation"], atol=1e-4)
        np.testing.assert_allclose(g["translation"], w["translation"], atol=1e-4)


@pytest.mark.cuda
def test_graph_on_card_agrees_with_cpu(capsys, cuda_device):
    """``graph`` on the card (the default platform, float32) against the CPU
    (float64): chi² to 1e-3 relative, the same scale line."""
    args = [M600, "--robust-kernel", "gnc_gm", "--solver", "pcg"]
    cli.main(["graph", *args])
    card = capsys.readouterr()
    got = json.loads(card.out.strip().splitlines()[-1])
    want, err = _graph(cli.main, capsys, args)
    np.testing.assert_allclose(got["chi2_final"], want["chi2_final"], rtol=1e-3)
    assert "robust scale (auto): 1.78" in card.err and "robust scale (auto): 1.78" in err
