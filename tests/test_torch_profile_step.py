# -*- coding: utf-8 -*-
"""The step profiler's grouping of kernels into families
(``smsut_tpu_torch/tools/profile_step.py``): function names from profiler
keys, the STATS split of the conv kernels, and the K3 / K6 sums of a
``block_pallas`` step for the tensor-core and the CUDA-core convs alike."""
import pytest
import torch

from smsut_tpu_torch.tools import profile_step as ps

TC = "void smsut::conv3x3_tc_kernel<64, 2, 4, 3, __nv_bfloat16, {}, false, 0>(x)"
TILE = "void smsut::conv_tile_kernel<__nv_bfloat16, float, 1, 16, {}, false, 0>(x)"


@pytest.mark.parametrize("key,name", [
    (TC.format("true"), "conv3x3_tc_kernel+stats"),
    (TC.format("false"), "conv3x3_tc_kernel-stats"),
    ("void smsut::conv3x3_tc_kernel<8, 1, 4>(x)", "conv3x3_tc_kernel-stats"),
    (TILE.format("true"), "conv_tile_kernel+stats"),
    (TILE.format("false"), "conv_tile_kernel-stats"),
    ("void smsut::dw_partial_kernel<float, 3, 32, true>(x)",
     "dw_partial_kernel"),
    ("smsut::finalize_kernel(float const*, int)", "finalize_kernel"),
    ("void block_out_kernel<__nv_bfloat16, true>(int)", "block_out_kernel"),
    ("void at::native::(anonymous namespace)::fill<float>(float*)", "fill"),
    ("ampere_sgemm_128x64_nn", "ampere_sgemm_128x64_nn"),
    ("void smsut::norm_sums_kernel<smsut::XSrc<__nv_bfloat16>, true>(x)",
     "norm_sums_kernel<XSrc>"),
    ("void smsut::norm_sums_kernel<smsut::NormBwdSrc<float>, false>(x)",
     "norm_sums_kernel<NormBwdSrc>"),
    ("void norm_sums_kernel<BlockOutSrc<__nv_bfloat16, true>, true>(x)",
     "norm_sums_kernel<BlockOutSrc>"),
    ("void smsut::in_resident_kernel<float, true>(x)", "in_resident_kernel"),
])
def test_kernel_function(key, name):
    assert ps.kernel_function(key) == name


@pytest.mark.parametrize("conv,dw", [(TC, "conv3x3_dw_tc_kernel<32, 64, 3, true>"),
                                     (TILE, "dw_partial_kernel<float, 3, 32, true>")])
def test_block_families(conv, dw):
    """K3: the convs that take statistics, finalize and the out pass; K6:
    the others, the weight gradients and the norm backward; the rest stays
    out of both."""
    rows = [(conv.format("true"), 1.0, 27), (conv.format("false"), 2.0, 27),
            (f"void smsut::{dw}(x)", 4.0, 27),
            ("smsut::finalize_kernel(float const*)", 0.25, 28),
            ("void block_out_kernel<float>(x)", 0.5, 9),
            ("void smsut::bwd_sums_kernel<smsut::NormBwdSrc<float> >(x)",
             8.0, 19),
            ("void in_stats_kernel<__nv_bfloat16>(x)", 16.0, 1),
            ("sm80_xmma_wgrad_implicit_gemm", 32.0, 1)]
    fam = ps.families(rows, fused=True)
    assert fam == {"K1": 16.0, "K3": 1.75, "K6": 14.0}
    fn = ps.by_function(rows, ["block_out_kernel", "dw_reduce_kernel"])
    assert fn == {"block_out_kernel": [0.5, 9], "dw_reduce_kernel": [0.0, 0]}


def test_norm_families_by_source():
    """The sums pass is K1's, K4's or K6's by its source of summands; the
    parent's stats, finalize and batch-sum kernels keep their families."""
    sums = "void smsut::norm_sums_kernel<smsut::{}<float>, true>(x)"
    rows = [(sums.format("XSrc"), 1.0, 28), (sums.format("NormBwdSrc"), 2.0, 28),
            ("void smsut::in_resident_kernel<float, true>(x)", 4.0, 28),
            ("void smsut::norm_bwd_apply_kernel<float, true>(x)", 8.0, 28),
            ("smsut::finalize_kernel(float const*)", 16.0, 28),
            ("void smsut::bwd_finalize_kernel(x)", 32.0, 28)]
    fam = ps.families(rows, fused=False)
    assert fam["K1"] == 21.0 and fam["K4"] == 42.0
    rows.append(("void norm_sums_kernel<BlockOutSrc<float, true>, true>(x)",
                 64.0, 9))
    fam = ps.families(rows, fused=True)
    assert fam["K1"] == 5.0 and fam["K6"] == 106.0 and fam["K3"] == 16.0


def test_unfused_families_take_every_conv_as_k2():
    rows = [(TC.format("false"), 1.0, 36), (TC.format("true"), 2.0, 1)]
    assert ps.families(rows, fused=False)["K2"] == 3.0


def test_step_profile_reads_one_profile(monkeypatch):
    """The median leaves out the first step; the families, the rest and the
    idle share all come from the same profiler rows."""
    rows = [(TC.format("true"), 1.0, 27), (TC.format("false"), 2.0, 27),
            ("smsut::finalize_kernel(float const*)", 0.25, 28),
            ("void in_stats_kernel<__nv_bfloat16>(x)", 0.5, 1),
            ("sm80_xmma_wgrad_implicit_gemm", 0.25, 1)]
    calls = []

    def fake_rows(torch_, fn, n):
        calls.append(n)
        return rows, 99.0
    monkeypatch.setattr(ps, "device_rows", fake_rows)
    p = ps.step_profile(torch, lambda: None, True, [100.0, 8.0, 4.0, 6.0])
    assert calls == [3]
    assert p["median_step_ms"] == 6.0 and p["device_ms"] == 4.0
    assert p["idle_share"] == pytest.approx(1 / 3)
    assert p["kernels_per_step"] == 84
    assert p["families_ms"] == {"K1": 0.5, "K3": 1.25, "K6": 2.0}
    assert p["other_ms"] == 0.25
    assert p["functions"]["finalize_kernel"] == [0.25, 28]
    assert p["top"] == rows


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU host")
def test_main_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.main()
