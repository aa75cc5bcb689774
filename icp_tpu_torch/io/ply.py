"""Minimal PLY reader/writer (ASCII and binary_little_endian).

The port's own copy of :mod:`icp_tpu.io.ply` (numpy only), which replaces
the reference's PCL dependency for PLY vertex IO (``tests/test_ply.cpp:32-78``).
Reads ``vertex`` elements with float/double x/y/z properties, skipping any
other scalar vertex properties, in ASCII and binary little-endian.
"""

from __future__ import annotations

import numpy as np

_TYPE_MAP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> np.ndarray:
    """Read vertex x/y/z from a PLY file -> ``(n, 3)`` float64 array."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements: list[tuple[str, int, list[tuple[str, str]]]] = []
        cur_props: list[tuple[str, str]] | None = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur_props = []
                elements.append((tokens[1], int(tokens[2]), cur_props))
            elif tokens[0] == "property":
                if cur_props is None:
                    raise ValueError("property before element in PLY header")
                if tokens[1] == "list":
                    cur_props.append(("__list__", " ".join(tokens[2:])))
                else:
                    cur_props.append((tokens[-1], tokens[1]))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format: {fmt}")

        out = None
        for name, count, props in elements:
            if any(p[0] == "__list__" for p in props):
                if name == "vertex":
                    raise ValueError("list properties on vertex element unsupported")
                if out is None:
                    raise ValueError(
                        f"element '{name}' with list properties precedes the "
                        "vertex element; variable-size rows cannot be skipped"
                    )
                break  # variable-size rows; stop after vertices were read
            dtype = np.dtype(
                [(p, ("<" if fmt != "ascii" else "") + _TYPE_MAP[t]) for p, t in props]
            )
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(tuple(f.readline().split()[: len(props)]))
                data = np.array(
                    [tuple(float(v) for v in r) for r in rows],
                    dtype=[(p, "f8") for p, _ in props],
                )
            else:
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
            if name == "vertex":
                out = np.stack(
                    [data["x"].astype(np.float64), data["y"].astype(np.float64),
                     data["z"].astype(np.float64)],
                    axis=-1,
                )
                break
        if out is None:
            raise ValueError(f"no vertex element in {path}")
        return out


def write_ply(path: str, points: np.ndarray, binary: bool = False) -> None:
    """Write an ``(n, 3)`` array as a PLY vertex cloud.

    ASCII float output mirrors the reference test's
    ``savePLYFileASCII`` of float32 coordinates (``test_ply.cpp:56-78``).
    """
    pts = np.asarray(points, dtype=np.float32)
    n = pts.shape[0]
    fmt = "binary_little_endian 1.0" if binary else "ascii 1.0"
    header = (
        f"ply\nformat {fmt}\ncomment generated by icp_tpu_torch\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            lines = "\n".join(f"{p[0]:g} {p[1]:g} {p[2]:g}" for p in pts)
            f.write((lines + "\n").encode("ascii"))
