"""The benchmark's own readers of the example data, independent of the program.

Both sides of a run (the program and the plain reference) take their points
from these readers, so neither reads what the other derived.  Every file a
configuration names is pinned by its SHA-256 in the configuration: a changed
file stops the run before anything is measured.

Formats (as the repository's ``ex_data/README.md`` describes them):

* scan CSV: ``x,y`` rows, unparsable or non-finite rows dropped;
* sweep ``.conf``: ``key = value`` header lines (``angle_min``,
  ``angle_increment``, ``length``, ``range_min``, ``range_max``) and
  ``i = range_i`` lines; the points are the finite in-range returns in
  angular order;
* PLY: binary little-endian or ASCII ``vertex`` elements with ``x, y, z``;
* ``groundtruth.json``: ``{"poses": [[x, y, theta], ...]}``, world poses.
"""

from __future__ import annotations

import glob
import hashlib
import json
import math
import os

import numpy as np


def sha256(root: str, pattern: str) -> str:
    """SHA-256 of the files matching ``pattern`` (a path or a glob, relative
    to ``root``), taken over each file's relative path and bytes in sorted
    order."""
    digest = hashlib.sha256()
    paths = sorted(glob.glob(os.path.join(root, pattern)))
    if not paths:
        raise FileNotFoundError(f"no file matches {pattern}")
    for path in paths:
        digest.update(os.path.relpath(path, root).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()


def check_pinned(root: str, pinned: dict) -> None:
    """Raise unless every ``{pattern: sha256}`` matches its files."""
    for pattern, want in pinned.items():
        got = sha256(root, pattern)
        if got != want:
            raise RuntimeError(f"{pattern}: sha256 {got} differs from the configuration's {want}")


def read_scan_csv(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            x_str, _, y_str = line.strip().partition(",")
            try:
                x, y = float(x_str), float(y_str)
            except ValueError:
                continue
            if math.isfinite(x) and math.isfinite(y):
                rows.append((x, y))
    return np.asarray(rows, dtype=np.float64).reshape(-1, 2)


def read_sweep_conf(path: str) -> np.ndarray:
    header, ranges = {}, {}
    with open(path) as f:
        for line in f:
            key, eq, value = line.partition("=")
            if not eq:
                continue
            key = key.strip()
            if key.isdigit():
                ranges[int(key)] = float(value)
            else:
                header[key] = float(value)
    n = int(header.get("length", len(ranges)))
    r = np.full(n, np.inf)
    for i, v in ranges.items():
        if 0 <= i < n:
            r[i] = v
    angles = header["angle_min"] + header["angle_increment"] * np.arange(n)
    ok = np.isfinite(r) & (r >= header.get("range_min", -np.inf)) & (
        r <= header.get("range_max", np.inf))
    return np.stack([r[ok] * np.cos(angles[ok]), r[ok] * np.sin(angles[ok])], axis=-1)


_PLY_TYPES = {"float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
              "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
              "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
              "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4"}


def read_ply(path: str) -> np.ndarray:
    """The vertices' ``x, y, z`` of a PLY whose first element is ``vertex``."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt, elements = None, []
        while True:
            tokens = f.readline().decode("ascii").split()
            if not tokens:
                continue
            if tokens[0] == "end_header":
                break
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                elements[-1][2].append((tokens[-1], tokens[1]))
        if not elements or elements[0][0] != "vertex":
            raise ValueError(f"{path}: the first element is not vertex")
        _, count, props = elements[0]
        if fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + _PLY_TYPES[t]) for name, t in props])
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
            cols = [data[c].astype(np.float64) for c in "xyz"]
        elif fmt == "ascii":
            names = [name for name, _ in props]
            rows = [f.readline().split() for _ in range(count)]
            cols = [np.array([float(r[names.index(c)]) for r in rows]) for c in "xyz"]
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return np.stack(cols, axis=-1)


def read_cloud(path: str) -> np.ndarray:
    if path.endswith(".csv"):
        return read_scan_csv(path)
    if path.endswith(".conf"):
        return read_sweep_conf(path)
    if path.endswith(".ply"):
        return read_ply(path)
    raise ValueError(f"unknown cloud format: {path}")


def se2(x: float, y: float, theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s, x], [s, c, y], [0.0, 0.0, 1.0]])


def load_pairs(root: str, pairs: list) -> list[dict]:
    """The configuration's registration pairs.

    Each entry of ``pairs`` is either ``{"source": path, "target": path}``
    (the base pose is the identity) or ``{"sequence": dir, "groundtruth":
    path}``: every consecutive pair of ``dir/sweep_*.conf``, sweep i onto
    sweep i + 1, whose base pose is the ground-truth relative pose
    ``P_{i+1}^-1 P_i`` (sweep i's points in sweep i + 1's frame).  Returns
    dicts with ``source``, ``target`` (float64 ``(n, D)``), ``base``
    (``(D + 1, D + 1)`` homogeneous) and ``name``.
    """
    out = []
    for entry in pairs:
        if "sequence" in entry:
            paths = sorted(glob.glob(os.path.join(root, entry["sequence"], "sweep_*.conf")))
            with open(os.path.join(root, entry["groundtruth"])) as f:
                poses = [se2(*p) for p in json.load(f)["poses"]]
            if len(poses) != len(paths):
                raise ValueError(f"{entry['sequence']}: {len(paths)} sweeps, "
                                 f"{len(poses)} ground-truth poses")
            clouds = [read_sweep_conf(p) for p in paths]
            for i in range(len(paths) - 1):
                out.append({"source": clouds[i], "target": clouds[i + 1],
                            "base": np.linalg.solve(poses[i + 1], poses[i]),
                            "name": f"{entry['sequence']}[{i}->{i + 1}]"})
        else:
            src = read_cloud(os.path.join(root, entry["source"]))
            dst = read_cloud(os.path.join(root, entry["target"]))
            out.append({"source": src, "target": dst, "base": np.eye(src.shape[1] + 1),
                        "name": f"{entry['source']}->{entry['target']}"})
    return out
