"""``python -m icp_tpu_torch.cli``: ``register`` and ``methods`` against the
JAX CLI, both on the CPU.  Both load their inputs in float32, so poses agree
at float32 tolerance (atol 1e-5); iteration counts are equal."""

import json
import os

import numpy as np
import pytest

from icp_tpu import cli as jax_cli
from icp_tpu_torch import cli
from icp_tpu_torch.io import read_ply

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
