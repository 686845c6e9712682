# -*- coding: utf-8 -*-
"""Typed configuration for the PyTorch/CUDA port.

An own copy of the JAX package's ``Config``/``Modality`` with the same knob
names and defaults, so ``--set k=v`` lines carry over between the two
packages.  The port imports nothing of the JAX package, not even its
jax-free modules.

Knobs that shape the TPU lowering only are accepted and are no-ops in the
port for now: ``pack_levels``, ``pack_mode``, ``pack_w0``, ``d_pack_deep``,
``d_pack_mode``, ``pair_towers``, ``layout_pin``, ``pool_pack_fused``,
``norm_stats`` (the port always takes f32 ``reduce`` statistics), and
the GAN step's ``d_concat_hat``, ``packed_loss_tails`` and ``remat``.  The
port runs the unpacked NHWC graph, with real and fake through one D apply
and x_hat through another.

``steps_per_dispatch`` and ``eval_scan`` govern the fit loop's dispatch as
in the JAX package: T iterations staged per dispatch, and the eval sweep
from a test set kept on the card; on the card each iteration and each
eval batch is a CUDA graph replay (train/loop.py).

The kernel knobs keep their names: ``block_pallas`` selects, on a CUDA
device, the fused residual-block kernel (K3) instead of the conv (K2) +
instance-norm (K1) chain.  ``use_pallas`` and ``conv_pallas`` are no-ops:
on CUDA every 3x3 conv and every instance norm of the path already runs a
hand-written kernel.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Dict, Optional, Sequence, Tuple


class Modality(enum.IntEnum):
    """Imaging modalities."""

    ct = 0
    t1in = 1
    t1out = 2
    t2 = 3


MODALITIES: Tuple[str, ...] = tuple(Modality.__members__)


def default_data_aug() -> Dict[str, object]:
    return dict(
        rotate=True,
        rotate_degrees=15,
        resizeCrop=True,
        resizeCrop_size=256,
        elasticDeform=True,
        elasticDeform_sigmas=(9.0, 13.0),
        elasticDeform_points=3,
        colorJitter=False,
        gammaCorrect=False,
        gammaCorrect_gammas=(0.7, 1.5),
    )


@dataclasses.dataclass
class Config:
    # ----- misc -----
    seed: int = 2020
    n_modal: int = len(Modality.__members__)
    n_label: int = 4  # 4 abdominal organs: liver, r-kidney, l-kidney, spleen

    # ----- training loop -----
    num_iter_per_epoch: int = 150
    max_epoch: int = 200
    exp_alpha: float = 1.0
    weight_dc: float = 0.5
    weight_ce: float = 0.5

    # ----- network -----
    img_channels: int = 1
    base_width: int = 16

    # ----- data roots; overridable via env -----
    atlas_root: str = ""
    chaos_root: str = ""
    base_root: str = ""
    expr_root: str = ""

    # ----- preprocessing -----
    new_spacing: Tuple[float, float, float] = (1.5, 1.5, 5.0)
    input_size: int = 256
    mod_type: Tuple[str, ...] = MODALITIES

    # ----- data loading -----
    split_yaml: str = "semi-1910.yaml"
    batch_size: int = 8
    num_workers: int = 6
    data_aug: Dict[str, object] = dataclasses.field(default_factory=default_data_aug)

    # ----- optimization -----
    lr: float = 1e-2
    weight_decay: float = 1e-3

    # ----- PatchNCE -----
    nce_layers: Sequence[int] = (5,)
    nce_patches: int = 64
    nce_temperature: float = 0.07
    netF_nc: int = 256

    # ----- CoraNet -----
    thres: float = 0.5
    default_w: Tuple[float, ...] = (1.0, 1.0)
    w_con: Tuple[float, ...] = (1.0, 5.0)
    w_rad: Tuple[float, ...] = (5.0, 1.0)
    pre_epoch: int = 100
    cora_epoch: int = 200
    pred_step: int = 10

    # ----- compute -----
    # activation dtype ("bfloat16" or "float32"); parameters, norm
    # statistics and logits are always float32.
    compute_dtype: str = "bfloat16"
    data_parallel: int = 0
    spatial_parallel: int = 1
    prefetch_depth: int = 2
    # no-op in the port (every CUDA instance norm runs kernel K1)
    use_pallas: bool = False
    # TPU layout knobs: accepted, no-ops in the port (module docstring)
    pack_levels: int = 2
    pack_mode: str = "hw"
    pack_w0: int = 8
    d_pack_deep: bool = True
    d_pack_mode: str = "w"
    pair_towers: Optional[bool] = None
    layout_pin: str = "off"
    # no-op in the port (every CUDA 3x3 conv runs kernel K2)
    conv_pallas: str = "off"
    # on CUDA: each BasicBlock as one fused-block call (K3) instead of K2+K1
    block_pallas: bool = False
    norm_stats: str = "auto"
    pool_pack_fused: Optional[bool] = None
    device_augment: bool = True
    profile_dir: str = ""
    steps_per_dispatch: int = 8
    prefetch_device: bool = True
    remat: bool = False
    remat_unet: bool = False
    pseudo_volumes: Tuple[str, ...] = ("ct_028", "t1in_037", "t1out_015",
                                       "t2_032")
    eval_every: int = 1
    eval_scan: bool = True
    packed_loss_tails: Optional[bool] = None
    d_concat_hat: bool = False
    consis_gate_step: int = 1000
    real_hd: bool = False

    def __post_init__(self):
        env_base = os.environ.get("SMSUT_DATA_ROOT")
        if env_base and not self.base_root:
            self.base_root = env_base
        env_expr = os.environ.get("SMSUT_EXPR_ROOT")
        if env_expr and not self.expr_root:
            self.expr_root = env_expr
        if not self.expr_root:
            self.expr_root = os.path.join(os.path.expanduser("~"), "smsut-out")

    @property
    def n_class(self) -> int:
        """Segmentation channels: background + n_label."""
        return self.n_label + 1

    @property
    def total_iters(self) -> int:
        return self.max_epoch * self.num_iter_per_epoch

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def get_config() -> Config:
    """The default configuration, on which ``--set`` overrides apply."""
    return Config()
