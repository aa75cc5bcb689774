"""Readings for the limits of ``correct``: sound runs and the controls.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 2] [--out readings.jsonl]
        [--controls tf32_program,tf32_reference] [--cpu '{"lanes": 4, ...}']

In one process (so the program's set-up is paid once): each seed of
``--seeds`` is a run of the cell as ``run.py`` makes it, with a window of
``--seconds``; each seed of ``--control-seeds`` is a run with the program's
TF32 path switched on, and one with the reference computed in TF32 put in
the program's place (one distinct batch, so one call a window).  Each run
writes one JSON line: every number the comparison can compare, the
quantiles of the gaps over the compared answers, the share of answers
above each of a list of distances, and the run's end-to-end metrics.  For
the sound runs it also gives the widest answers a second witness: the
reference computed in float32 on the same inputs, and its gap from the
float64 reference and from the program.  The benchmark's own runs
never run this.
"""

import argparse
import io
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


THRESHOLDS_M = (1e-6, 2e-6, 3e-6, 5e-6, 8e-6, 1e-5, 2e-5, 5e-5, 1e-4, 1e-3)


def witness(reference, compare, extras, torch, device, count: int = 4) -> list:
    """The ``count`` widest answers against the reference computed in float32."""
    t_gap = extras["gaps"]["translation_gap_m"]
    top = torch.argsort(torch.nan_to_num(t_gap, posinf=1e9), descending=True)[:count]
    rows = extras["at"][top]
    f32 = reference.register_blocks(extras["settings"], "float32",
                                    [x[rows.to(x.device)] for x in extras["inputs"]], device)
    ref = {k: (tuple(x[top] for x in v) if isinstance(v, tuple) else v[top])
           for k, v in extras["reference"].items()}
    prog = [x[top] for x in extras["program"]]
    vs_ref = compare.gaps(f32["rotation"], f32["translation"], f32["iterations"], ref)
    vs_f32 = compare.gaps(*prog, f32)
    return [{"program_vs_f64_m": float(t_gap[i]),
             "f32_reference_vs_f64_m": float(vs_ref["translation_gap_m"][j]),
             "program_vs_f32_reference_m": float(vs_f32["translation_gap_m"][j]),
             "iterations_program_f64_f32": [int(prog[2][j]), int(ref["iterations"][j]),
                                            int(f32["iterations"][j])]}
            for j, i in enumerate(top.tolist())]


def far_shares(t_gap) -> dict:
    """The share of answers above each of ``THRESHOLDS_M``, percent."""
    return {f"{m:g}": 100.0 * float((t_gap > m).double().mean()) for m in THRESHOLDS_M}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--controls", default="tf32_program,tf32_reference")
    parser.add_argument("--cpu", default=None)
    args = parser.parse_args()
    sys.path.insert(0, BENCH)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from harness import cell, compare, controls, reference

    device = "cpu" if args.cpu else "cuda"
    base = json.loads(args.cpu) if args.cpu else {}
    runs = [(int(s), "program", None, {}) for s in args.seeds.split(",") if s]
    once = {"tf32_program": {}, "tf32_reference": {"distinct_batches": 1}}
    for s in (int(s) for s in args.control_seeds.split(",") if s):
        for kind in args.controls.split(","):
            runs.append((s, kind, getattr(controls, kind), once[kind]))
    sink = open(args.out, "a") if args.out else sys.stdout
    try:
        for seed, kind, patch, overrides in runs:
            extras, log = {}, io.StringIO()
            t0 = time.perf_counter()
            rc = cell.run(args.workload, seed, args.seconds, False, t_start=t0, root=ROOT,
                          device=device, check_chip=not args.cpu, patch=patch,
                          overrides=dict(base, **overrides), out=log, err=log, extras=extras)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            line = {"workload": args.workload, "seed": seed, "kind": kind, "rc": rc,
                    "seconds": time.perf_counter() - t0}
            if rc == 0:
                line["checks"] = extras["result"]["checks"]
                line["correct"] = extras["result"]["correct"]
                line["numbers"] = extras["numbers"]
                if kind == "program":
                    line["widest"] = witness(reference, compare, extras, torch, device)
                line["far_share_pct_above_m"] = far_shares(extras["gaps"]["translation_gap_m"])
                line["answers"] = len(extras["gaps"]["translation_gap_m"])
                line["quantiles_50_90_99_100"] = {
                    k: np.quantile(v.numpy(), [0.5, 0.9, 0.99, 1.0]).tolist()
                    for k, v in extras["gaps"].items()
                    if v.is_floating_point()}
                line["metrics"] = extras["result"]["metrics"]
                line["reference_s"] = extras["reference_s"]
            else:
                line["log"] = log.getvalue()[-2000:]
            print(json.dumps(line), file=sink, flush=True)
            print(json.dumps({k: line.get(k) for k in ("seed", "kind", "rc", "correct",
                                                       "checks", "seconds")}), flush=True)
    finally:
        if sink is not sys.stdout:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
