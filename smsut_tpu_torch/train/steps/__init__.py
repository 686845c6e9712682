# -*- coding: utf-8 -*-
from typing import NamedTuple

import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.packed_w import w_pack_schedule

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def setup_compute(cfg: Config) -> torch.dtype:
    """Shared algorithm setup: resolve the activation dtype and pin the
    float32 precision.

    TF32 is off for both matmuls and cuDNN convolutions (cuDNN would run
    float32 convs in TF32 by default), so the strict-parity mode
    ``compute_dtype="float32"`` is float32 end to end, as in the JAX
    reference.  The kernel knobs need no arming here: ``block_pallas`` is
    handed to the model, ``use_pallas``/``conv_pallas`` are no-ops
    (config.py).  The packed layout is checked (:func:`pack_levels`)."""
    pack_levels(cfg)
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not one of "
                         f"{sorted(_DTYPES)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _DTYPES[cfg.compute_dtype]


class Packing(NamedTuple):
    """The packed layout a step builds its models in: ``levels`` (the
    towers' packed levels, 0, 1 or 2), the generator's ``mode`` and the
    discriminator's ``d_mode`` ("hw" or "w"), ``w0`` (the W packing's
    level-0 pack) and ``d_deep`` (the W discriminator's packed pyramid)."""

    levels: int
    mode: str
    d_mode: str
    w0: int
    d_deep: bool

    def model_kw(self) -> dict:
        """The U-Net's and the UGAN towers' packing arguments."""
        return dict(pack_levels=self.levels, pack_mode=self.mode,
                    pack_w0=self.w0)

    def d_kw(self) -> dict:
        """The discriminator's."""
        return dict(pack_levels=self.levels, pack_mode=self.d_mode,
                    pack_w0=self.w0, pack_deep=self.d_deep)


def pack_levels(cfg: Config, discriminator: bool = False) -> Packing:
    """The packed layout of ``cfg``, checked as the JAX package checks it:
    ``pack_levels`` 0, 1 or 2; ``pack_mode`` "hw" or "w", ``d_pack_mode``
    "", "hw" or "w" ("" inheriting ``pack_mode``); ``layout_pin`` other
    than "off" with a W discriminator refused with the JAX message, at any
    ``pack_levels``; with ``pack_levels > 0`` a W layout whose packs do not
    divide the maps (where the JAX package's shapes would not hold) refused
    naming ``pack_w0``, the discriminator's only for a model with a
    ``discriminator``."""
    p = cfg.pack_levels
    if p not in (0, 1, 2):
        raise ValueError(f"pack_levels {p} is not 0, 1 or 2")
    if cfg.pack_mode not in ("hw", "w"):
        raise ValueError(f"pack_mode={cfg.pack_mode!r} is not 'hw' or 'w'")
    if cfg.d_pack_mode not in ("", "hw", "w"):
        raise ValueError(f"d_pack_mode={cfg.d_pack_mode!r} is not '', 'hw' "
                         f"or 'w'")
    d_mode = cfg.d_pack_mode or cfg.pack_mode
    if cfg.layout_pin != "off" and d_mode == "w":
        raise ValueError(
            f"layout_pin={cfg.layout_pin!r} cannot be combined with the "
            f"W-packed discriminator (d_pack_mode='w', the default) — it "
            f"crashes the TPU backend.  Use --set d_pack_mode=hw (or "
            f"pack_mode=hw with d_pack_mode='') to experiment with layout "
            f"pinning.")
    out = Packing(p, cfg.pack_mode, d_mode, cfg.pack_w0, cfg.d_pack_deep)
    if p and cfg.pack_mode == "w":
        _check_w_generator(cfg.input_size, cfg.pack_w0,
                           w_pack_schedule(cfg.pack_w0, cfg.base_width, p))
    if p and discriminator and d_mode == "w":
        _check_w_discriminator(cfg.input_size, cfg.pack_w0, cfg.d_pack_deep)
    return out


def _refuse_w0(size: int, w0: int, why: str) -> None:
    raise ValueError(f"pack_w0={w0} at input_size {size}: {why}; choose a "
                     f"pack_w0 that divides the maps, or pack_mode/"
                     f"d_pack_mode hw")


def _check_w_generator(size: int, w0: int, ps) -> None:
    """The W towers' maps: level i's width (size / 2^i) a multiple of its
    pack, each pack even (its pool halves the subpixel pairs)."""
    if w0 < 2 or size % w0:
        _refuse_w0(size, w0, "the stem's width is not a multiple of it")
    for i, pi in enumerate(ps):
        if pi % 2 or (size >> i) % pi:
            _refuse_w0(size, w0, f"level {i}'s pack {pi} does not divide "
                       f"its width {size >> i} in subpixel pairs")


def _check_w_discriminator(size: int, w0: int, deep: bool) -> None:
    """The W discriminator: the stem's stride 2 needs an even ``pack_w0``
    dividing the width; each packed block after it an even pack."""
    if w0 < 2 or w0 % 2 or size % w0:
        _refuse_w0(size, w0, "the stride-2 stem needs an even pack that "
                   "divides the width")
    p = w0 // 2
    while deep and p >= 2:
        if p % 2:
            _refuse_w0(size, w0, f"a stride-2 block at pack {p} splits no "
                       f"subpixel pairs")
        p //= 2


def pool_fused(cfg: Config) -> bool:
    """``Config.pool_pack_fused``, None meaning the JAX package's auto rule:
    on from a batch of 32."""
    ppf = cfg.pool_pack_fused
    return cfg.batch_size >= 32 if ppf is None else bool(ppf)


def loss_weight(w):
    """A loss weight of a step: a 0-d device tensor as it is (set per epoch,
    read by a replayed graph), a number as a float."""
    return w if isinstance(w, torch.Tensor) else float(w)
