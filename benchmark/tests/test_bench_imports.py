"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference nothing of the port either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "sparc_ldpc_tpu"}


def loaded_after(code: str) -> set:
    """Top-level module names in a fresh interpreter after `code`."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    names = loaded_after(
        "import benchmark.reference.codes as c, benchmark.reference.compare\n"
        "import benchmark.reference.seeds, benchmark.reference.noise\n"
        "cfg = dict(L=32, M=32, R=1.0, P=1.0, power_alloc='flat', "
        "op_seed=0, amp_iters=4, amp_tol=0.0, op_kind='hadamard')\n"
        "c.Sparc(cfg, 3.0, 'cpu').frames(1, 0, 0, 4, 'cpu')")
    assert not names & (JAX_SIDE | {"sparc_ldpc_tpu_torch"})


def test_reference_sources_import_only_torch_numpy_and_themselves():
    allowed = {"torch", "numpy", "math", "copy", "typing", "__future__"}
    for path in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in allowed, (path.name, m)


def test_a_run_loads_no_jax(tmp_path):
    """A whole run on the CPU, window, trace and check, through the port:
    nothing of JAX or the JAX package is loaded."""
    from benchmark.tests.tiny import write_tiny

    d = write_tiny(tmp_path)
    names = loaded_after(
        "from benchmark.harness import spec\nimport benchmark.run as r\n"
        "from pathlib import Path\n"
        f"spec.ROOT = spec.BENCH_DIR = Path({str(d)!r})\n"
        "assert r.main(['--workload', 'tiny_concat.t16', '--seed', '5', "
        "'--seconds', '0.5', '--trace', '1'], devices=['cpu']) == 0")
    assert "sparc_ldpc_tpu_torch" in names
    assert not names & JAX_SIDE


def test_run_refuses_when_jax_was_loaded(monkeypatch):
    import benchmark.run as r

    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    assert r.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "sparc_ldpc_tpu.config",
                        sys.modules["json"])
    assert r.forbidden_modules() == ["sparc_ldpc_tpu"]


@pytest.mark.parametrize("name,bad", [("sparc_ldpc_tpu_torch.ops", False),
                                      ("sparc_ldpc_tpu", True),
                                      ("jaxlib.xla", True),
                                      ("jax_like", False)])
def test_names_are_compared_whole(monkeypatch, name, bad):
    import benchmark.run as r

    for k in list(sys.modules):
        if k.split(".")[0] in JAX_SIDE:
            monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, name, sys.modules["json"])
    assert bool(r.forbidden_modules()) == bad
