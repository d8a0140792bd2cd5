"""AST lint over ``src/repro_torch`` (counterpart of
``src/repro/analysis/lint.py``, DESIGN.md §10, Layer 1).

Run as ``python -m repro_torch.analysis.lint``; ``tests/test_torch_analysis.py``
runs the same checks, so a dirty tree fails the tests.

Rules
-----
Host-sync rules, only inside the hot modules (``registry.HOT_MODULES``);
each flagged call may be a per-request device->host round trip on the
serve path (DESIGN.md §5):

* **HS101** ``.item()``.
* **HS102** ``int(x)`` / ``float(x)`` where ``x`` may be a tensor.  The
  reference's exemptions hold (literals, ``len()``, ``.shape`` / ``.ndim`` /
  ``.size`` / ``.dtype`` reads and subscripts of them, comparisons), plus
  the calls that return Python ints in torch (``.numel()``, ``.dim()``,
  ``.size(...)``, ``.element_size()``, ``.data_ptr()``).
* **HS103** an explicit copy to the host or a wait: ``.cpu()``,
  ``.numpy()``, ``.tolist()``, ``.to("cpu")`` / ``.to(torch.device("cpu"))``
  / ``.to(device="cpu")``, ``torch.cuda.synchronize()`` and any
  ``.synchronize()`` (streams, events).  One flag per chain: ``.numpy()``
  or ``.tolist()`` on a receiver that ends in ``.cpu()`` / ``.numpy()`` is
  the copy already flagged there.  ``.tolist()`` / ``.numpy()`` on an
  evident numpy value (a ``np.``/``numpy.`` call, or a chain through
  ``.astype(...)``, which tensors lack) is exempt.  The AST cannot tell
  other host arrays (an engine's numpy routes) from tensors: those sites
  carry a waiver saying they read a host array.
* **HS104** ``bool(x)`` on a possible tensor.

Seed hygiene, everywhere in ``src/repro_torch``:

* **SD201** a literal seed: ``torch.manual_seed(<literal>)``,
  ``torch.cuda.manual_seed[_all](<literal>)`` and
  ``<generator>.manual_seed(<literal>)`` (``torch.Generator(...)`` too).
* **SD202** a literal ``seed=0`` keyword at a call site (API defaults
  ``seed: int = 0`` are caller-overridable and stay legal).

Import hygiene:

* **IS301** process state mutated at module scope: ``os.environ``,
  ``warnings.filterwarnings``, ``sys.path``, ... as in the reference, and
  torch's: assignment to ``torch.backends.*``, ``torch.set_default_dtype``,
  ``torch.set_num_threads``, ``torch.set_float32_matmul_precision`` and
  the like.  Importing a module for its helpers must not rewrite process
  state.

Hot-path registry (``registry.HOT_PATHS``):

* **JR403** a stale entry: the file was not scanned, or defines no
  function of that qualname.  The reference's JR401/JR402 (an unregistered
  ``jax.jit`` site, a drifted donation policy) have no eager counterpart:
  the contracts check each entry's syncs and in-place writes by running it.

Waivers
-------
``# hostsync: ok <reason>``, ``# seed: ok <reason>``,
``# import-side-effect: ok <reason>`` on the offending line or on the line
above suppress the matching rule family.  A ``# hostsync: ok`` on a
``def`` line waives the whole function (host-side maintenance paths: the
k-means rebuild, the host-loop decode oracle).  The reason names the sync.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Set, Tuple

from . import registry

WAIVER_TOKENS = {
    "HS": "hostsync: ok",
    "SD": "seed: ok",
    "IS": "import-side-effect: ok",
}

_SIDE_EFFECT_CALLS = {
    "os.environ.update", "os.environ.setdefault", "os.environ.pop",
    "os.putenv", "os.unsetenv",
    "warnings.filterwarnings", "warnings.simplefilter",
    "logging.basicConfig",
    "np.random.seed", "numpy.random.seed", "random.seed",
    "sys.path.insert", "sys.path.append", "sys.path.extend",
    "matplotlib.use", "multiprocessing.set_start_method",
    "torch.manual_seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.set_default_dtype", "torch.set_default_device", "torch.set_default_tensor_type",
    "torch.set_num_threads", "torch.set_num_interop_threads",
    "torch.set_float32_matmul_precision", "torch.set_grad_enabled",
    "torch.use_deterministic_algorithms", "torch.cuda.set_sync_debug_mode",
    "torch.set_printoptions",
}
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype"}
# tensor methods that return Python ints (torch only; the reference flags them)
_INT_METHODS = {"numel", "dim", "size", "element_size", "data_ptr", "nelement"}
_SEED_CALLS = {"torch.manual_seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}


@dataclasses.dataclass(frozen=True)
class Violation:
    rel: str
    line: int
    rule: str
    msg: str

    def __str__(self) -> str:
        return f"{self.rel}:{self.line}: {self.rule} {self.msg}"


def _dotted(node: ast.expr) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _maybe_tensor(node: ast.expr) -> bool:
    """Could this expression hold a tensor?  Conservative: literals,
    ``len()``, ``.shape``-style reads, comparisons and the int-returning
    tensor methods are exempt; everything else is assumed a tensor."""
    if isinstance(node, ast.Constant):
        return False
    if isinstance(node, (ast.Compare, ast.BoolOp)):
        return False
    if isinstance(node, ast.UnaryOp):
        return _maybe_tensor(node.operand)
    if isinstance(node, ast.BinOp):
        return _maybe_tensor(node.left) or _maybe_tensor(node.right)
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name == "len":
            return False
        if name in ("min", "max", "round", "abs") and node.args:
            return any(_maybe_tensor(a) for a in node.args)
        if isinstance(node.func, ast.Attribute) and node.func.attr in _INT_METHODS:
            return False
        return True
    if isinstance(node, ast.Attribute):
        return node.attr not in _STATIC_ATTRS
    if isinstance(node, ast.Subscript):
        if isinstance(node.value, ast.Attribute) and node.value.attr in _STATIC_ATTRS:
            return False
        if isinstance(node.value, ast.Call) and isinstance(node.value.func, ast.Attribute) \
                and node.value.func.attr == "size":
            return False
        return True
    return True


def _is_cpu_device(node: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and _dotted(node.func) in ("torch.device", "device")
            and bool(node.args) and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


def _host_receiver(node: ast.expr) -> bool:
    """Is ``node`` evidently host data, or the end of a chain whose copy is
    flagged already?  A ``np.``/``numpy.`` call, a chain through
    ``.astype(...)`` (numpy only), or one ending in ``.cpu()`` /
    ``.numpy()`` / ``.tolist()``."""
    if isinstance(node, ast.Call):
        name = _dotted(node.func) or ""
        if name.startswith(("np.", "numpy.")):
            return True
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in ("cpu", "numpy", "tolist", "astype"):
                return True
            return _host_receiver(node.func.value)
    if isinstance(node, ast.Subscript):
        return _host_receiver(node.value)
    if isinstance(node, ast.Attribute):
        return _host_receiver(node.value)
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, hot: bool):
        self.rel = rel
        self.hot = hot
        self.violations: List[Violation] = []
        self.scope: List[str] = []
        self.defined: Set[str] = set()
        self.hs_waived = 0          # nested hostsync-waived functions
        self._lines: List[str] = []

    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        if rule.startswith("HS") and self.hs_waived:
            return
        self.violations.append(Violation(self.rel, getattr(node, "lineno", 0), rule, msg))

    # ------------------------------------------------------------ scopes
    def _visit_function(self, node) -> None:
        for dec in node.decorator_list:
            self.visit(dec)
        for default in list(node.args.defaults) + \
                [d for d in node.args.kw_defaults if d is not None]:
            self.visit(default)
        waived = _line_has_waiver_text(self._lines, node.lineno, "HS")
        self.scope.append(node.name)
        self.defined.add(".".join(self.scope))
        self.hs_waived += int(waived)
        for stmt in node.body:
            self.visit(stmt)
        self.hs_waived -= int(waived)
        self.scope.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_function(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_function(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        for dec in node.decorator_list:
            self.visit(dec)
        self.scope.append(node.name)
        for stmt in node.body:
            self.visit(stmt)
        self.scope.pop()

    # ------------------------------------------------------------- calls
    def _host_sync(self, node: ast.Call, name: Optional[str]) -> None:
        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else None
        if attr == "item" and not node.args:
            self._flag(node, "HS101", ".item() is a device->host sync on the hot path")
        elif attr == "cpu" and not node.args:
            self._flag(node, "HS103", ".cpu() copies device data to the host — batch it "
                                      "into the per-batch copy or waive it")
        elif attr in ("numpy", "tolist") and not node.args:
            if not _host_receiver(func.value):
                self._flag(node, "HS103", f".{attr}() reads a tensor on the host — batch it "
                                          "into the per-batch copy or waive it")
        elif attr == "to" and (any(_is_cpu_device(a) for a in node.args[:1])
                               or any(k.arg == "device" and _is_cpu_device(k.value)
                                      for k in node.keywords)):
            self._flag(node, "HS103", ".to('cpu') copies device data to the host")
        elif name == "torch.cuda.synchronize" or (attr == "synchronize" and not node.args):
            self._flag(node, "HS103", "a synchronize() stalls the host on the device")
        elif name in ("int", "float") and len(node.args) == 1 and not node.keywords \
                and _maybe_tensor(node.args[0]):
            self._flag(node, "HS102", f"{name}() on a possible tensor forces a host sync — "
                                      "batch the reads into one copy")
        elif name == "bool" and len(node.args) == 1 and _maybe_tensor(node.args[0]):
            self._flag(node, "HS104", "bool() on a possible tensor forces a host sync")

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if self.hot:
            self._host_sync(node, name)
        is_seed = name in _SEED_CALLS or (isinstance(node.func, ast.Attribute)
                                          and node.func.attr == "manual_seed")
        if is_seed and node.args and isinstance(node.args[0], ast.Constant):
            self._flag(node, "SD201",
                       f"hard-coded seed manual_seed({node.args[0].value!r}) — thread a "
                       "per-call seed instead (a replayed stream samples every batch alike)")
        for kw in node.keywords:
            if kw.arg == "seed" and isinstance(kw.value, ast.Constant) and \
                    kw.value.value == 0:
                # anchored at the keyword's own line so that a waiver can sit
                # beside `seed=0` in a multi-line call
                self._flag(kw.value, "SD202",
                           "literal seed=0 at a call site replays one stream — thread a "
                           "counter or config seed")
        self.generic_visit(node)

    # ----------------------------------------------- module-level effects
    def _check_module_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and \
                        _dotted(t.value) in ("os.environ", "environ"):
                    self._flag(stmt, "IS301",
                               "os.environ mutated at import time — move it behind "
                               "main()/a function (importing a module for helpers must "
                               "not rewrite process state)")
                dotted = _dotted(t) if isinstance(t, ast.Attribute) else None
                if dotted and dotted.startswith("torch."):
                    self._flag(stmt, "IS301",
                               f"{dotted} set at import time — move it behind a function")
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            name = _dotted(stmt.value.func)
            if name in _SIDE_EFFECT_CALLS:
                self._flag(stmt, "IS301",
                           f"import-time call to {name}() — move it behind main()/a "
                           "function")
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._check_module_stmt(child)

    def run(self, tree: ast.Module, lines: List[str]) -> None:
        self._lines = lines
        for stmt in tree.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self._check_module_stmt(stmt)
        self.visit(tree)


def _line_has_waiver_text(lines: List[str], lineno: int, family: str) -> bool:
    token = WAIVER_TOKENS.get(family)
    if token is None or not lines:
        return False
    idx = lineno - 1
    if 0 <= idx < len(lines) and token in lines[idx]:
        return True
    prev = idx - 1
    if 0 <= prev < len(lines):
        stripped = lines[prev].strip()
        if stripped.startswith("#") and token in stripped:
            return True
    return False


def _apply_waivers(violations: List[Violation], lines: List[str]) -> List[Violation]:
    return [v for v in violations if not _line_has_waiver_text(lines, v.line, v.rule[:2])]


# ---------------------------------------------------------------- the tree

def _lint(source: str, rel: str) -> Tuple[List[Violation], Set[str]]:
    tree = ast.parse(source, filename=rel)
    lines = source.splitlines()
    linter = _Linter(rel, hot=registry.is_hot(rel))
    linter.run(tree, lines)
    return _apply_waivers(linter.violations, lines), linter.defined


def lint_source(source: str, rel: str) -> List[Violation]:
    """Lint one module's source; ``rel`` is its path relative to
    src/repro_torch.  The registry check is a whole-tree property
    (:func:`check_registry`, :func:`lint_tree`)."""
    return _lint(source, rel)[0]


def check_registry(defined: Dict[str, Set[str]],
                   table: Tuple[registry.HotPath, ...] = registry.HOT_PATHS
                   ) -> List[Violation]:
    """JR403: every hot-path entry names a function of a scanned file;
    ``defined`` maps each scanned file to its function qualnames."""
    out = []
    for p in table:
        if p.file not in defined:
            out.append(Violation(p.file, 0, "JR403",
                                 f"registry names `{p.qualname}` in a file the lint never "
                                 "scanned — moved or deleted?"))
        elif p.qualname not in defined[p.file]:
            out.append(Violation(p.file, 0, "JR403",
                                 f"stale hot-path entry: no function `{p.qualname}`"))
    return out


def find_root() -> str:
    """The src/repro_torch package directory this module lives in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_tree(root: Optional[str] = None) -> List[Violation]:
    """Lint every module under ``root`` (default: this src/repro_torch tree)."""
    root = root or find_root()
    violations: List[Violation] = []
    defined: Dict[str, Set[str]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                found, defined[rel] = _lint(f.read(), rel)
            violations.extend(found)
    violations.extend(check_registry(defined))
    return violations


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="the port's hot-path lint (DESIGN.md §10)")
    ap.add_argument("--root", default=None,
                    help="package root to lint (default: the src/repro_torch tree this "
                         "module lives in)")
    args = ap.parse_args(argv)
    violations = lint_tree(args.root)
    for v in violations:
        print(v)
    if violations:
        print(f"FAIL: {len(violations)} lint violation(s)")
        return 1
    print("analysis lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
