# -*- coding: utf-8 -*-
"""Shared pieces of the tests of the PyTorch/CUDA port (tests/test_torch_*).

Inputs are made with numpy from a seed and handed to both the JAX
reference and the port.  Tests of a CUDA kernel itself carry the ``cuda``
marker and take the :func:`cuda_device` fixture, which skips when the host
has no card; the decision is made when the test runs, never at import.
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode); "
                    "run on the card: python -m pytest tests/test_torch_*.py -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def t(a: np.ndarray, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                       dtype=dtype)


def norm_params(rng, c):
    return ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def conv_w(rng, k, ci, co, std=0.1):
    return (std * rng.standard_normal((k, k, ci, co))).astype(np.float32)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(1, max |want|)."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))
