# -*- coding: utf-8 -*-
"""The tensor-core conv candidates (smsut_tpu_torch/ops/conv_mma.py) and the
ported conv microbench (smsut_tpu_torch/tools/microbench_conv.py) against
the Pallas candidates of tools/microbench_pallas_conv.py, which run in
interpret mode on the CPU.  The same numpy-seeded inputs, rounded to the
working dtype, go through both.  The CUDA kernels are held against their
plain version on the card in tests/test_torch_cuda.py.

Tolerances, max |port - pallas| / max |pallas|: float32 1e-5 (summation
order only); bfloat16 8e-3, one bf16 rounding of the largest output (2^-8
of it) with room for a flip in either direction."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smsut_tpu_torch.ops import conv_mma
from smsut_tpu_torch.tools import microbench_conv

ROOT = Path(__file__).resolve().parents[1]
PORT = {"dots": conv_mma.conv3x3_dots, "im2col": conv_mma.conv3x3_im2col,
        "im2col2": conv_mma.conv3x3_im2col2}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 8e-3)}


@pytest.fixture(scope="module")
def pallas_tool():
    """tools/microbench_pallas_conv.py, loaded by path (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "microbench_pallas_conv", ROOT / "tools" / "microbench_pallas_conv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("strip", [8, 16])
@pytest.mark.parametrize("name", list(PORT))
def test_port_matches_pallas_candidate(pallas_tool, name, strip, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    xj = jnp.asarray(rng.normal(size=(2, 16, 16, 16)).astype(np.float32),
                     jdt)
    wj = jnp.asarray((0.1 * rng.normal(size=(3, 3, 16, 16))).astype(
        np.float32), jdt)
    want = np.asarray(getattr(pallas_tool, f"pallas_conv_{name}")(
        xj, wj, strip).astype(jnp.float32))
    as_torch = lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(tdt)
    got = PORT[name](as_torch(xj), as_torch(wj), strip)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_plain_matches_the_tools_library_conv(pallas_tool):
    """The plain version against the JAX tool's yardstick, XLA's conv, in
    float32 at the tool's channel count."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 8, 12, 64)).astype(np.float32)
    w = (0.05 * rng.normal(size=(3, 3, 64, 64))).astype(np.float32)
    want = np.asarray(pallas_tool.xla_conv(jnp.asarray(x), jnp.asarray(w)))
    got = conv_mma.conv3x3_mma_plain(torch.from_numpy(x),
                                     torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cpu_path_counts_no_launch_and_checks_strip():
    x = torch.zeros((1, 12, 8, 16), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 16, 16), dtype=torch.bfloat16)
    before = [f.launches for f in PORT.values()]
    for f in PORT.values():
        assert tuple(f(x, w, strip=4).shape) == (1, 12, 8, 16)
        with pytest.raises(ValueError):      # H % strip != 0
            f(x, w, strip=8)
    assert [f.launches for f in PORT.values()] == before


def test_microbench_main_on_cpu(capsys):
    """The ported tool end to end on the CPU at batch 1: one line per
    candidate, in the JAX tool's order plus k2, each under the bound."""
    rows = microbench_conv.main(["1", "2"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    names = ["library", "k2", "dots", "im2col", "im2col2", "im2col2_32",
             "im2col_32"]
    assert [r["name"] for r in rows] == names
    assert "cpu" in out[0]
    for r, line in zip(rows, out[1:]):
        assert line.split()[0] == r["name"]
        assert " us " in line and "TF/s" in line and "rel_err=" in line
        assert r["us"] > 0 and r["rel_err"] <= microbench_conv.REL_TOL


def test_microbench_main_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        microbench_conv.main(["1", "1"])
