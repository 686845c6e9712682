# -*- coding: utf-8 -*-
import torch

from smsut_tpu_torch.config import Config

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def setup_compute(cfg: Config) -> torch.dtype:
    """Shared algorithm setup: resolve the activation dtype and pin the
    float32 precision.

    TF32 is off for both matmuls and cuDNN convolutions (cuDNN would run
    float32 convs in TF32 by default), so the strict-parity mode
    ``compute_dtype="float32"`` is float32 end to end, as in the JAX
    reference.  The kernel knobs need no arming here: ``block_pallas`` is
    handed to the model, ``use_pallas``/``conv_pallas`` are no-ops
    (config.py).  The packing's form is checked (:func:`pack_levels`)."""
    pack_levels(cfg)
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not one of "
                         f"{sorted(_DTYPES)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _DTYPES[cfg.compute_dtype]


def pack_levels(cfg: Config, discriminator: bool = False) -> int:
    """``cfg.pack_levels`` after checking the packing's form: the port runs
    the JAX package's space-to-depth ("hw") packing; with ``pack_levels >
    0`` a ``pack_mode`` (and for a model with a ``discriminator`` a
    ``d_pack_mode``, "" inheriting ``pack_mode``) of "w" raises, never
    running another layout in silence."""
    p = cfg.pack_levels
    if p not in (0, 1, 2):
        raise ValueError(f"pack_levels {p} is not 0, 1 or 2")
    if p == 0:
        return 0
    modes = [("pack_mode", cfg.pack_mode)]
    if discriminator:
        modes.append(("d_pack_mode", cfg.d_pack_mode or cfg.pack_mode))
    for name, mode in modes:
        if mode == "w":
            raise ValueError(
                f"{name}='w' with pack_levels={p}: the W packing is ROADMAP "
                f"A13b, not ported; run --set d_pack_mode=hw (and "
                f"pack_mode=hw), or pack_levels=0")
        if mode != "hw":
            raise ValueError(f"{name}={mode!r} is not 'hw' or 'w'")
    return p


def pool_fused(cfg: Config) -> bool:
    """``Config.pool_pack_fused``, None meaning the JAX package's auto rule:
    on from a batch of 32."""
    ppf = cfg.pool_pack_fused
    return cfg.batch_size >= 32 if ppf is None else bool(ppf)


def loss_weight(w):
    """A loss weight of a step: a 0-d device tensor as it is (set per epoch,
    read by a replayed graph), a number as a float."""
    return w if isinstance(w, torch.Tensor) else float(w)
