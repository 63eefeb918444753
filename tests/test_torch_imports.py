"""The port stands alone: no module of ``src/repro_torch`` and no line of
``chip_smoke.py`` imports JAX or the JAX package.

Every file is parsed with ``ast`` and every node is walked, so an import
inside a function, a ``try`` or a class body counts as much as one at the
top. ``importlib.import_module("...")`` and ``__import__("...")`` with a
literal name count too.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def imported_names(tree: ast.AST):
    """(line, module) of every absolute import in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            called = (fn.attr if isinstance(fn, ast.Attribute)
                      else fn.id if isinstance(fn, ast.Name) else "")
            arg = node.args[0]
            if (called in ("import_module", "__import__")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                yield node.lineno, arg.value


def test_the_walk_sees_every_kind_of_import():
    src = ("import os\n"
           "def f():\n"
           "    if True:\n"
           "        import jax.numpy as jnp\n"
           "try:\n"
           "    from repro.core import solve\n"
           "except ImportError:\n"
           "    pass\n"
           "class C:\n"
           "    import jaxlib\n"
           "from . import sibling\n"
           "from repro_torch.core import solve\n"
           "importlib.import_module('repro.serve')\n")
    bad = sorted((line, name) for line, name in imported_names(ast.parse(src))
                 if _forbidden(name))
    assert bad == [(4, "jax.numpy"), (6, "repro.core"), (10, "jaxlib"),
                   (13, "repro.serve")]


def test_the_port_has_files_to_check():
    rel = {str(p.relative_to(ROOT)) for p in FILES}
    assert "src/repro_torch/serve/eigen_engine.py" in rel
    assert "src/repro_torch/launch/eigenserve.py" in rel
    for name in ("models/model.py", "serve/engine.py", "launch/serve.py",
                 "configs/__init__.py"):
        assert f"src/repro_torch/{name}" in rel
    assert "chip_smoke.py" in rel
    assert len(FILES) > 40


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.relative_to(ROOT)}:{line}: {name}"
           for line, name in imported_names(tree) if _forbidden(name)]
    assert not bad, "imports of JAX or the JAX package:\n" + "\n".join(bad)
