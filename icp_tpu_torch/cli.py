"""Command-line interface: ``python -m icp_tpu_torch.cli``.

Port of the ``register`` and ``methods`` subcommands of :mod:`icp_tpu.cli`:

* ``register`` — one-shot registration of a 2D scan pair (CSV, or a ``.conf``
  polar sweep) or, with ``--ply``, a 3D PLY pair, under the driver flags;
  prints the pose (``--json``: one JSON object) and can write the moved
  source (``--out-ply``).  Inputs load in float32 with power-of-two bucket
  capacity (``--exact-capacity``: a multiple of 8), as in the JAX CLI.
* ``methods`` — list the registry (the reference prints it on an unknown
  method, ``vis/main.cpp:133-139``).

``--platform gpu`` (the default) runs on the CUDA card and fails without
one; ``--platform cpu`` runs on the CPU.  The JAX CLI's ``--sor``,
``--coarse`` and ``--aot-cache`` are not ported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _parse_config(pairs):
    from .config import Config

    params = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"error: config entry {pair!r} is not key=value")
        key, value = pair.split("=", 1)
        try:
            params[key] = int(value)
        except ValueError:
            try:
                params[key] = float(value)
            except ValueError:
                params[key] = value  # string parameters, e.g. solver=quat
    return Config(params)


def _make_method(name: str, dim: int, config):
    from .methods import from_method, registered_methods

    try:
        return from_method(name, dim, config)
    except KeyError:
        print(f"error: unknown ICP method '{name}'. expected one of:", file=sys.stderr)
        for m in registered_methods(dim):
            print(f"* {m}", file=sys.stderr)
        raise SystemExit(1)


def _driver_config(args):
    from .driver import DriverConfig

    return DriverConfig(
        max_iterations=args.max_iterations,
        angle_tolerance=float(np.deg2rad(args.angle_tolerance_deg))
        if args.angle_tolerance_deg is not None
        else None,
        translation_tolerance=args.translation_tolerance,
        stop_cost=args.stop_cost,
        absolute_cost_tolerance=args.absolute_cost_tolerance,
        relative_cost_tolerance=args.relative_cost_tolerance,
    )


def _add_driver_flags(p):
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument(
        "--angle-tolerance-deg", type=float, default=0.1,
        help="angle tolerance in degrees (with --translation-tolerance)",
    )
    p.add_argument("--translation-tolerance", type=float, default=0.1)
    p.add_argument("--stop-cost", type=float, default=None)
    p.add_argument("--absolute-cost-tolerance", type=float, default=None)
    p.add_argument("--relative-cost-tolerance", type=float, default=None)


def _device(platform: str) -> torch.device:
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("error: --platform gpu needs a CUDA card (use --platform cpu)")
    return torch.device("cuda", 0)


def _load_scan(path: str, capacity, device):
    """A 2D scan by extension: ``.conf`` polar sweep, else CSV."""
    from .io import parse_lidar_scan, parse_sweep

    load = parse_sweep if path.endswith(".conf") else parse_lidar_scan
    return load(path, capacity=capacity, dtype=torch.float32, device=device)


def cmd_register(args):
    from . import geometry
    from .cloud import from_points
    from .driver import converge
    from .io import read_ply, write_ply
    from .multiscale import converge_multiscale

    device = _device(args.platform)
    config = _parse_config(args.config)
    cap = None if args.exact_capacity else "bucket"
    if args.ply:
        source, target = (
            from_points(read_ply(p), capacity=cap, dtype=torch.float32, device=device)
            for p in (args.src, args.dst)
        )
        dim = 3
    else:
        source = _load_scan(args.src, cap, device)
        target = _load_scan(args.dst, cap, device)
        dim = 2
    method = _make_method(args.method, dim, config)
    cfg = _driver_config(args)
    guess = geometry.identity(dim, dtype=torch.float32, device=device)

    t0 = time.perf_counter()
    if args.multiscale:
        result, _ = converge_multiscale(
            method, source, target, guess, cfg, factors=(4,), coarse_max_iterations=30
        )
    else:
        result, _ = converge(method, source, target, guess, cfg)
    rotation = result.transform.rotation.cpu().numpy()
    dt = time.perf_counter() - t0

    out = {
        "method": args.method,
        "iterations": int(result.iteration_count),
        "cost": float(result.cost),
        "rotation": rotation.tolist(),
        "translation": result.transform.translation.cpu().numpy().tolist(),
        "seconds": round(dt, 4),
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(f"converged in {out['iterations']} iterations, cost {out['cost']:.6f}")
        print("rotation:")
        for row in out["rotation"]:
            print("  " + "  ".join(f"{v: .8f}" for v in row))
        print("translation: " + "  ".join(f"{v: .8f}" for v in out["translation"]))
    if args.out_ply:
        moved = geometry.apply(result.transform, source.points)[: int(source.count)]
        moved = moved.cpu().numpy()
        if moved.shape[1] == 2:  # PLY vertices are xyz; z = 0 for 2D scans
            moved = np.column_stack([moved, np.zeros(len(moved), dtype=moved.dtype)])
        write_ply(args.out_ply, moved)
        print(f"wrote {args.out_ply}")


def cmd_methods(args):
    from .methods import registered_methods

    del args
    for dim in (2, 3):
        print(f"{dim}D: " + ", ".join(registered_methods(dim)))


def main(argv=None):
    from . import __version__

    parser = argparse.ArgumentParser(
        prog="icp-tpu-torch", description="scan matching on a CUDA card (PyTorch)"
    )
    parser.add_argument("--version", action="version", version=f"icp-tpu-torch {__version__}")
    parser.add_argument(
        "--platform", choices=["cpu", "gpu"], default="gpu",
        help="gpu (default) runs on the CUDA card and fails without one; cpu runs on the host",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_reg = sub.add_parser("register", help="register one scan/cloud pair")
    p_reg.add_argument("-S", "--src", required=True,
                       help="source scan CSV/.conf (or PLY with --ply)")
    p_reg.add_argument("-D", "--dst", required=True, help="destination scan CSV/.conf (or PLY)")
    p_reg.add_argument("-m", "--method", default="vanilla")
    p_reg.add_argument("-c", "--config", nargs="*", help="method config key=value")
    p_reg.add_argument("--ply", action="store_true", help="inputs are 3D PLY clouds")
    p_reg.add_argument(
        "--multiscale", action="store_true",
        help="coarse-to-fine pyramid (decimate 4x, then full resolution)",
    )
    p_reg.add_argument(
        "--exact-capacity", action="store_true",
        help="pad clouds to a multiple of 8 instead of power-of-two buckets",
    )
    p_reg.add_argument("--json", action="store_true")
    p_reg.add_argument("--out-ply", help="write transformed source cloud")
    _add_driver_flags(p_reg)
    p_reg.set_defaults(fn=cmd_register)

    p_m = sub.add_parser("methods", help="list registered methods")
    p_m.set_defaults(fn=cmd_methods)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
