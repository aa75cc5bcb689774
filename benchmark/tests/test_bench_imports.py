"""Nothing the benchmark runs imports JAX or the JAX package; the reference
imports nothing of the program.  Module names are compared by their whole
top-level name, since the port's name ``icp_tpu_torch`` begins with the JAX
package's ``icp_tpu``."""

import ast
import os
import subprocess
import sys

from harness import cell

HARNESS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "harness")


def test_top_level_names_are_compared_whole(monkeypatch):
    before = cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "icp_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.probe", sys)
    assert cell.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "icp_tpu.probe", sys)
    assert "icp_tpu" in cell.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_only_system_imports_the_program(root):
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(base, name)
            names = set(_imports(path))
            assert not names & {"jax", "jaxlib", "flax", "icp_tpu"}, path
            if "icp_tpu_torch" in names:
                assert path == os.path.join(HARNESS, "system.py"), path


def test_a_run_loads_no_jax_module(root):
    code = (
        "import sys, time, io; sys.path[:0] = ['benchmark', '.']\n"
        "from harness import cell\n"
        "rc = cell.run('trimmed2d-fleet8192', 3, 0.1, False, t_start=time.perf_counter(),"
        " device='cpu', check_chip=False, overrides=dict(lanes=2, distinct_batches=1,"
        " sample=2), out=io.StringIO(), err=io.StringIO())\n"
        "assert rc == 0, rc\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'icp_tpu'}), 'icp_tpu_torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[] True"


def test_the_reference_loads_nothing_of_the_program(root):
    code = ("import sys, torch; sys.path[:0] = ['benchmark', '.']\n"
            "from harness import reference, compare, traffic, data, spec\n"
            "for name in ('trimmed2d', 'trimmed3d'):\n"
            "    s = spec.load_json(f'benchmark/configs/{name}.json')['system']\n"
            "    d, n = s['dim'], 12\n"
            "    pts = torch.rand(2, n, d, dtype=torch.float64)\n"
            "    cnt = torch.full((2,), n)\n"
            "    eye = torch.eye(d, dtype=torch.float64).expand(2, d, d)\n"
            "    reference.register('float64', s, pts, cnt, pts + 0.01, cnt, eye,"
            " torch.zeros(2, d, dtype=torch.float64))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'icp_tpu', 'icp_tpu_torch'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
