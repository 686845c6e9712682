# -*- coding: utf-8 -*-
"""The port stands alone: no module of ``smsut_tpu_torch`` (nor
``chip_smoke.py``, which drives it on the card) imports JAX, flax, optax,
orbax, anything of the JAX package ``smsut_tpu`` or of the JAX tools in
``tools/`` -- checked in the source, and in a fresh interpreter that
imports every module.  And each imports only what the card's machine has:
the standard library, numpy, scipy, torch, triton (inside a function) and
the port itself -- no cv2, yaml, PIL or tensorboardX."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "smsut_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "smsut_tpu",
             "tools")


def _forbidden(name: str) -> bool:
    # exact names and dotted prefixes: smsut_tpu_torch is not smsut_tpu
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


ALLOWED = ("numpy", "scipy", "torch", "smsut_tpu_torch")
LAZY_ONLY = ("triton",)


def _strays(tree: ast.AST):
    """Imported names outside the allow-list; triton only inside a
    function."""
    bad = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            inner = in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module]
            for name in names:
                root = name.split(".")[0]
                if not (root in sys.stdlib_module_names or root in ALLOWED
                        or root in LAZY_ONLY and inner):
                    bad.append(name)
            visit(child, inner)

    visit(tree, False)
    return bad


def test_allow_list_flags_strays():
    src = ("import cv2\nimport yaml\nfrom PIL import Image\n"
           "import tensorboardX\nimport triton\nimport os, numpy\n"
           "from scipy import ndimage\nfrom . import x\n"
           "def f():\n    import triton.language as tl\n    import orbax\n")
    assert _strays(ast.parse(src)) == ["cv2", "yaml", "PIL", "tensorboardX",
                                       "triton", "orbax"]


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_only_the_cards_packages(path):
    bad = _strays(ast.parse(path.read_text()))
    assert not bad, bad


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_matches_exact_names_and_prefixes():
    assert _forbidden("smsut_tpu") and _forbidden("smsut_tpu.config")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("smsut_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")
    assert _forbidden("tools.microbench_pallas_conv")
    assert not _forbidden("smsut_tpu_torch.tools.microbench_conv")


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    mods = _modules() + ["chip_smoke"]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad
