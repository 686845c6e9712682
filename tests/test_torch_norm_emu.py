# -*- coding: utf-8 -*-
"""K1's and K4's kernels on the CPU, under the emulation of
tests/test_torch_cuda_emu.py (``SOURCES["instnorm"]``,
``SOURCES["instnorm_bwd"]``), which runs the blocks of a thread-block
cluster at once, with cluster.sync() and each other's shared memory:

- ``csrc/instnorm.cuh``, K1's resident plan (a cluster per sample and
  channel group, the partials exchanged over distributed shared memory) and
  its two-pass plan (a sums pass whose last blocks add the splits, then the
  apply pass), against float64 (tests/cuda_emu/instnorm_check.cpp);
- ``csrc/instnorm_bwd.cuh``, K4's two passes (the plan each shape gets,
  one split, five), dx, dscale and dbias against float64, the batch sums by
  the block that arrives last at an integer ticket
  (tests/cuda_emu/instnorm_bwd_check.cpp);

each at C 3, 8, 16, 32 (and 12, 24, 256), K1 with clusters of 4 and 16
blocks and cp.async landing at its wait, two runs bit for bit, every
ticket left zero.  That the plans of K1, K4 and K6's sums passes cover
every pixel and channel of a map once (``EMU_PLAN``) is
tests/test_torch_instnorm.py's.  The check programs build
here, so this module runs on its own worker beside
tests/test_torch_cuda_emu.py.
"""
import pytest

from test_torch_cuda_emu import ENVS, _build, _run


@pytest.fixture(scope="module")
def norm_binary(tmp_path_factory):
    return _build(tmp_path_factory, "instnorm")


@pytest.fixture(scope="module")
def norm_bwd_binary(tmp_path_factory):
    return _build(tmp_path_factory, "instnorm_bwd")


def _plans_seen(lines):
    return {l.split(":")[1].split(",")[0].strip() for l in lines if ": " in l
            and " err " in l}


# cp.async landing at once or at its wait; and no cluster of more than one
# block fitting the card, so that the plans each shape gets fall back to two
# passes (a cluster of one block still fits)
NORM_ENVS = {**ENVS, "no_clusters": {"EMU_CLUSTERS": "0", "EMU_DEFER": "1"}}


def _auto_lines(lines):
    auto = [l for l in lines if l.startswith("auto ")]
    assert auto and all("tickets clear 1" in l for l in lines if " err " in l)
    return auto


def _auto_plans_fit(lines, env):
    auto = _auto_lines(lines)
    if "EMU_CLUSTERS" in env:
        assert all("two-pass" in l or " 1 blocks of " in l for l in auto)
        assert any("two-pass" in l for l in auto)
    else:
        assert any("resident" in l for l in auto)


@pytest.mark.parametrize("env", list(NORM_ENVS.values()), ids=list(NORM_ENVS))
def test_instnorm_kernels_in_emulation(norm_binary, env):
    lines = _run(norm_binary, env)
    plans = _plans_seen(lines)
    assert any(p.startswith("resident vec") for p in plans), plans
    assert any(p.startswith("resident scalar") for p in plans), plans
    assert any(p.startswith("two-pass") for p in plans), plans
    assert any(" 16 blocks of " in l and l.startswith("resident K16 ")
               for l in lines)
    _auto_plans_fit(lines, env)


@pytest.mark.parametrize("env", list(NORM_ENVS.values()), ids=list(NORM_ENVS))
def test_instnorm_bwd_kernels_in_emulation(norm_bwd_binary, env):
    lines = _run(norm_bwd_binary, env)
    assert any(l.startswith("two-pass 1 split ") for l in lines)
    assert any(l.startswith("two-pass 5 splits ") for l in lines)
    assert all(": two-pass " in l for l in _auto_lines(lines))
