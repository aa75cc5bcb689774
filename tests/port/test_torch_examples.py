"""The port's examples (``icp_tpu_torch/examples``) at the JAX examples'
smoke-test sizes on the CPU (``ICP_EXAMPLES_QUICK=1``, ``ICP_EXAMPLES_CPU=1``),
images into temporary directories (``ICP_EXAMPLES_OUT``).

Each port example must print its JAX original's key line (``CASES`` of
``tests/test_examples.py``).  Those that carry logic of their own
(``JAX_COMPARED``: the registration, place recognition, the seq1 odometry
and loop closure, online SLAM, the session merge and the fleet over the
device mesh) must also print the JAX example's numbers (``examples/*.py``,
run in this process after the port's): the output lines are paired in
order, every integer of a line (a count or an index) must equal the JAX
example's, and every other number must equal it within one unit of its
last printed digit (values under 1e-12, a zero residual's round-off, count
as zero).  Both sides run in float64 (the tests run JAX with x64) except
where the JAX example computes in float32 (``register_pair``'s parsed scans
and ``place_recognition``'s clouds, where the port's CPU runs are float64;
``fleet_registration``, float32 in both): those numbers may also differ by
FLOAT32_ATOL.  Lines that report a wall time or a written file are left
out.  ``serving_demo`` must print a zero pose error across its
clients.  ``slam_pipeline`` and ``odometry_sequence_3d`` are held to their
key lines only (their JAX runs would add ~50 s): the pieces they chain are
held against the JAX package in ``test_torch_slam.py`` (``run_slam``) and
``test_torch_odometry.py`` / ``test_torch_methods_extended.py`` (the 3D
chain, GICP).

``register_pair`` runs as the command a user types (``python -m
icp_tpu_torch.examples.register_pair``); the other eight run in this process
through ``runpy.run_path``, so that torch is imported once, and so do the
JAX examples, one after the other (run beside the port's, both slow down
several times over on a shared CPU).
"""

import contextlib
import io
import os
import re
import runpy
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXAMPLES = os.path.join(REPO, "icp_tpu_torch", "examples")
KEY_LINES = {
    "register_pair": "translation:",
    "serving_demo": "max pose error",
    "slam_pipeline": "optimized end-pose drift",
    "place_recognition": "descriptor search",
    "odometry_sequence": "optimized ATE",
    "odometry_sequence_3d": "after closure",
    "online_slam": "stream done",
    "multi_session_merge": "merged sessions:",
    "fleet_registration": "pairs on",
}
SKIPPED_LINES = ("wrote ", "render skipped", "concurrent clients served in")
# online_slam's last "final live error": the JAX example measures it against
# the sequence's last ground-truth pose, not the last streamed sweep's (the
# port's departure, see icp_tpu_torch/examples/online_slam.py).
# fleet_registration's device count is the port's world size (one process
# here), JAX's the 8 virtual CPU devices; the batch is 64 either way.
DEPARTURES = {("online_slam", "stream done"): "final live error",
              ("fleet_registration", "pairs on"): " on "}
# fleet_registration's converged costs are float32 round-off of 30 m
# coordinates (one float32 ulp at 30 m is 1.9e-6) in both packages.
FLOAT32_ATOL = {"register_pair": 1e-6, "place_recognition": 1e-6, "fleet_registration": 1e-5}
JAX_COMPARED = ("register_pair", "place_recognition", "odometry_sequence", "online_slam",
                "multi_session_merge", "fleet_registration")
_NUMBER = re.compile(r"[-+]?\d+(?:\.(\d+))?(?:e([-+]?\d+))?")


def _numbers(line: str) -> list[tuple[float, float]]:
    """Each number of ``line`` with one unit of its last printed digit (0 for
    an integer: it must be equal)."""
    found = []
    for m in _NUMBER.finditer(line):
        if m.group(1) is None and m.group(2) is None:
            found.append((float(m.group(0)), 0.0))
            continue
        decimals = len(m.group(1) or "")
        exponent = int(m.group(2) or 0)
        found.append((float(m.group(0)), 10.0 ** (exponent - decimals)))
    return found


def _compare(name: str, got: str, want: str) -> None:
    """The port example's output ``got`` against the JAX example's ``want``
    (the module docstring's rule)."""

    def lines(text):
        return [ln for ln in text.splitlines()
                if ln.strip() and not any(s in ln for s in SKIPPED_LINES)]

    got_lines, want_lines = lines(got), lines(want)
    assert len(got_lines) == len(want_lines), (name, got_lines, want_lines)
    for g, w in zip(got_lines, want_lines):
        departure = next((cut for (ex, key), cut in DEPARTURES.items()
                          if ex == name and key in g), None)
        if departure is not None:
            g, w = g.split(departure)[0], w.split(departure)[0]
        gn, wn = _numbers(g), _numbers(w)
        assert len(gn) == len(wn), (name, g, w)
        for (a, unit_a), (b, unit_b) in zip(gn, wn):
            if unit_a == unit_b == 0.0:
                assert a == b, (name, g, w)
                continue
            tol = max(unit_a, unit_b, 1e-12, FLOAT32_ATOL.get(name, 0.0))
            assert abs(a - b) <= tol * (1 + 1e-9), (name, g, w)


def _env(tmp_path):
    return {"ICP_EXAMPLES_CPU": "1", "ICP_EXAMPLES_QUICK": "1",
            "ICP_EXAMPLES_OUT": str(tmp_path)}


def _jax_output(name, tmp_path, monkeypatch) -> str:
    """The JAX example's stdout (float64: the tests run JAX with x64)."""
    out_dir = tmp_path / "jax"
    out_dir.mkdir()
    for key, value in _env(out_dir).items():
        monkeypatch.setenv(key, value)
    monkeypatch.chdir(out_dir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"), run_name="__main__")
    return buf.getvalue()


def test_register_pair_runs_as_a_module(tmp_path, monkeypatch):
    env = dict(os.environ, PYTHONPATH=REPO, **_env(tmp_path))
    out = subprocess.run([sys.executable, "-m", "icp_tpu_torch.examples.register_pair"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert KEY_LINES["register_pair"] in out.stdout
    _compare("register_pair", out.stdout, _jax_output("register_pair", tmp_path, monkeypatch))


@pytest.mark.parametrize("name", sorted(set(KEY_LINES) - {"register_pair"}))
def test_example_runs(name, tmp_path, monkeypatch, capsys):
    for key, value in _env(tmp_path).items():
        monkeypatch.setenv(key, value)
    monkeypatch.chdir(tmp_path)
    runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert KEY_LINES[name] in out
    for tree in (REPO, EXAMPLES):  # images land in ICP_EXAMPLES_OUT only
        assert not [f for f in os.listdir(tree) if f.endswith(".png")]
    if name in JAX_COMPARED:
        _compare(name, out, _jax_output(name, tmp_path, monkeypatch))
    elif name == "serving_demo":
        line = next(ln for ln in out.splitlines() if KEY_LINES[name] in ln)
        assert [v for v, _ in _numbers(line)] == [0.0], line


def test_numbers_compare_to_the_last_printed_digit():
    """The rule itself: one unit of the last printed digit passes, two fail,
    integers must be equal; a departure's tail is left out."""
    _compare("x", "a 0.051 m, 19 kf, 1.0e-29", "a 0.052 m, 19 kf, 3.0e-28")
    with pytest.raises(AssertionError):
        _compare("x", "a 0.050 m", "a 0.052 m")
    with pytest.raises(AssertionError):
        _compare("x", "19 keyframes", "20 keyframes")
    with pytest.raises(AssertionError):
        _compare("x", "one line", "one line\nanother line")
    _compare("online_slam", "stream done: 19 kf, final live error 0.044 m",
             "stream done: 19 kf, final live error 9.848 m")


def test_examples_need_a_card_by_default(monkeypatch):
    """Without ``ICP_EXAMPLES_CPU`` the examples run on the card, and raise
    where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    monkeypatch.delenv("ICP_EXAMPLES_CPU", raising=False)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        runpy.run_path(os.path.join(EXAMPLES, "register_pair.py"), run_name="__main__")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["register_pair", "online_slam"])
def test_example_on_card(cuda_device, name, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, ICP_EXAMPLES_QUICK="1",
               ICP_EXAMPLES_OUT=str(tmp_path))
    env.pop("ICP_EXAMPLES_CPU", None)
    out = subprocess.run([sys.executable, "-m", f"icp_tpu_torch.examples.{name}"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert KEY_LINES[name] in out.stdout
