"""The import rule: nothing the benchmark runs loads JAX or the JAX
package, and the plain reference loads nothing of the port.

Names are compared by their top-level part, the part before the first
dot, whole: the port's name begins with the JAX package's.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List, Tuple

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vhr_tpu"})
PORT = "vhr_tpu_torch"


def top_names(tree: ast.AST) -> Iterable[Tuple[int, str]]:
    """(line, top-level module name) of every absolute import in ``tree``,
    ``importlib.import_module("...")`` and ``__import__("...")`` with a
    literal name included."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else None
            if fname in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value.split(".")[0]


def static_violations(bench_dir: str) -> List[str]:
    """Every import under ``bench_dir`` that breaks the rule, as
    ``path:line name``."""
    bad = []
    for dirpath, _, files in os.walk(bench_dir):
        in_ref = os.sep + "reference" in dirpath[len(bench_dir):]
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for line, name in top_names(tree):
                if name in FORBIDDEN or (in_ref and name == PORT):
                    bad.append(f"{os.path.relpath(path, bench_dir)}:{line} "
                               f"{name}")
    return bad


def loaded_forbidden(modules=None) -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)
