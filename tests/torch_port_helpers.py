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


# the JAX package's strict-parity mode of the semi-supervised steps: float32
# end to end, unpacked, reduced statistics, host augmentation, one step a
# dispatch, no tower pairing
STRICT = dict(compute_dtype="float32", pack_levels=0, norm_stats="reduce",
              device_augment=False, steps_per_dispatch=1, pair_towers=False,
              packed_loss_tails=False)


def flat(tree, prefix=()):
    """A nested mapping's leaves as numpy arrays by '/'-joined path."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def assert_trees_close(got, want, what: str, rtol=5e-3, atol=5e-4) -> None:
    """Two flax-layout trees leaf by leaf (tests/test_torch_train.py's
    bounds by default)."""
    got, want = dict(flat(got)), dict(flat(want))
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=f"{what}/{k}")


@pytest.fixture(scope="module")
def few_torch_threads():
    """The port's CPU steps share the process with XLA's thread pool; with
    torch's default of one thread per core the two oversubscribe the host
    (tests/test_torch_train.py).  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def at_count(jstate, count: int):
    """A JAX TrainState moved to step ``count``, its optimizers' counts
    too (optax's schedules read their own count, which the JAX steps keep
    equal to the step)."""
    import jax
    import jax.numpy as jnp

    to = lambda leaf: (jnp.asarray(count, leaf.dtype)
                       if jnp.issubdtype(leaf.dtype, jnp.integer)
                       and leaf.ndim == 0 else leaf)
    kw = {"opt_state": jax.tree_util.tree_map(to, jstate.opt_state)}
    if jstate.opt_state2 is not None:
        kw["opt_state2"] = jax.tree_util.tree_map(to, jstate.opt_state2)
    return jstate.replace(step=jnp.asarray(count, jnp.int32), **kw)
