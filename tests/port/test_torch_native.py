"""The native CSV loader of the port (``icp_tpu_torch.utils.native``, the
same ``native/libicptpu.so`` as the JAX package's) bound through
``icp_tpu_torch.io.scan_csv``, against the JAX package's loader and the
port's own Python path: the ``ex_data/seq1`` sweeps written as CSV scans
(with rows the parser drops), float64 on the CPU, arrays and counts exact;
with the library built, and forced absent (``ICP_TPU_NO_NATIVE_BUILD`` and
a library path with nothing there)."""

import glob
import os

import numpy as np
import pytest
import torch

from icp_tpu.io import parse_lidar_scan_batch as jax_batch
from icp_tpu.io.scan_conf import parse_sweep_conf, sweep_to_points
from icp_tpu_torch.io import scan_csv
from icp_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def seq1_csvs(tmp_path_factory):
    """seq1's 120 sweeps as ``x,y`` CSV files; every 10th also carries a
    no-return row, a NaN row and an unparsable row, which are dropped."""
    out = tmp_path_factory.mktemp("seq1csv")
    paths = []
    for i, conf in enumerate(sorted(glob.glob(f"{REPO}/ex_data/seq1/sweep_*.conf"))):
        pts = sweep_to_points(parse_sweep_conf(conf))
        lines = [f"{float(x)!r},{float(y)!r}" for x, y in pts]
        if i % 10 == 0:
            lines[5:5] = ["inf,1.0", "nan,2.0", "x,y"]
        path = out / f"scan_{i:03d}.csv"
        path.write_text("\n".join(lines) + "\n")
        paths.append(str(path))
    return paths


@pytest.fixture
def no_library(tmp_path, monkeypatch):
    """The loader as where the library is absent and may not be built."""
    monkeypatch.setenv("ICP_TPU_NO_NATIVE_BUILD", "1")
    monkeypatch.setattr(native, "_lib_path", lambda: str(tmp_path / "native" / "libicptpu.so"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.native_lib() is None


def _port(paths, capacity):
    return scan_csv.parse_lidar_scan_batch(paths, capacity=capacity, dtype=torch.float64,
                                           device="cpu")


def _assert_equal(got, want):
    assert int(got.count.min()) > 500  # seq1's sweeps carry 500-540 returns
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert got.count.dtype == torch.int32


def test_library_loads():
    assert native.native_lib() is not None, "native/libicptpu.so did not build or load"


@pytest.mark.parametrize("capacity", [1024, None, "bucket"])
def test_batch_matches_jax(seq1_csvs, capacity):
    _assert_equal(_port(seq1_csvs, capacity), jax_batch(seq1_csvs, capacity=capacity,
                                                         dtype=np.float64))


def test_batch_takes_the_native_path(seq1_csvs, monkeypatch):
    """With an int capacity the threaded loader parses every file (the
    Python parser is never called)."""
    want = _port(seq1_csvs[:7], 1024)

    def refuse(path):
        raise AssertionError(f"the Python parser ran on {path}")

    monkeypatch.setattr(scan_csv, "parse_lidar_scan_array", refuse)
    _assert_equal(_port(seq1_csvs[:7], 1024), want)


def test_native_equals_python_path(seq1_csvs, tmp_path):
    """``tests/test_io_tools.py:90``'s mixed rows, and the seq1 scans."""
    mixed = tmp_path / "mixed.csv"
    mixed.write_text("1.0 2.0\n3.0,4.0,9.9\nnan,1.0\ninf,2.0\n5,6\n 7.5 , 8.5 \n")
    lib = native.native_lib()
    for path in [str(mixed), *seq1_csvs[::20]]:
        got = lib.parse_scan_csv(path)
        np.testing.assert_array_equal(got, scan_csv.parse_lidar_scan_array(path))
    np.testing.assert_array_equal(scan_csv.parse_lidar_scan_array(str(mixed)),
                                  [[5.0, 6.0], [7.5, 8.5]])


def test_batch_without_library_matches_jax(seq1_csvs, no_library):
    _assert_equal(_port(seq1_csvs, 1024), jax_batch(seq1_csvs, capacity=1024,
                                                    dtype=np.float64))


@pytest.mark.parametrize("library", [True, False])
def test_overflow_raises(seq1_csvs, request, library):
    """A scan over the capacity: the library reports it, and the Python path
    raises with the file's name (both ways)."""
    if not library:
        request.getfixturevalue("no_library")
    with pytest.raises(ValueError, match="exceed capacity 64"):
        _port(seq1_csvs[:3], 64)


@pytest.mark.cuda
def test_batch_lands_on_the_card(cuda_device, seq1_csvs):
    got = scan_csv.parse_lidar_scan_batch(seq1_csvs[:4], capacity=1024, device=cuda_device)
    assert got.points.device.type == "cuda" and got.points.dtype == torch.float32
    want = jax_batch(seq1_csvs[:4], capacity=1024)
    np.testing.assert_array_equal(got.points.cpu().numpy(), np.asarray(want.points))
