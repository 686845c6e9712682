# -*- coding: utf-8 -*-
"""The port stands alone: no module of ``smsut_tpu_torch`` (nor
``chip_smoke.py``, which drives it on the card) imports JAX, flax, optax,
orbax, anything of the JAX package ``smsut_tpu`` or of the JAX tools in
``tools/`` -- checked in the source, and in a fresh interpreter that
imports every module."""
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
