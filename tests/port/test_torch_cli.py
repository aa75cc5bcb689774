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
        "2D: feature_aware, trimmed, vanilla", "3D: trimmed, vanilla"]


def test_gpu_platform_needs_a_card(capsys, monkeypatch):
    """The default platform is the card; without one it exits, never falling
    back to the CPU."""
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        cli.main(["register", *CASES["scan1 trimmed"]])
