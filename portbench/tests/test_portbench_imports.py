"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's), and
the reference and the yardstick import nothing of the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench import harness
from portbench.tests import tiny

PB = tiny.ROOT / "portbench"
# the yardstick: the reference, the check, the traffic and the arithmetic
YARDSTICK = ("reference.py", "check.py", "prompts.py", "tokenizer.py", "questions.py",
             "traffic.py", "weights.py", "yardstick.py", "readers.py", "trace.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_harness_imports_jax_or_the_jax_package():
    files = [p for p in PB.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        for mod in _imports(p):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (p, mod)


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    for name in YARDSTICK:
        for mod in _imports(PB / name):
            assert mod.split(".")[0] != "repro_torch", (name, mod)


def test_a_whole_run_loads_no_jax_module(tmp_path):
    root = tiny.make_root(tmp_path)
    code = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(tiny.ROOT / 'src')!r}, {str(tiny.ROOT)!r}]\n"
        "torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        f"res, err, mods = harness.run(Path({str(root)!r}), 'tiny.tiny-closed', 7, 1.0, False,"
        " device='cpu')\n"
        "print(json.dumps({'correct': res['correct'], 'mods': mods,"
        " 'top': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["mods"] == []
    assert not set(got["top"]) & set(harness.FORBIDDEN)
    assert "repro_torch" in got["top"] and "portbench" in got["top"]
