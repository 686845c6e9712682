# -*- coding: utf-8 -*-
"""Typed configuration for the PyTorch/CUDA port.

An own copy of the JAX package's ``Config``/``Modality`` with the same knob
names and defaults, so ``--set k=v`` lines carry over between the two
packages.  The port imports nothing of the JAX package, not even its
jax-free modules.

The packing knobs are live, as in the JAX package: ``pack_levels`` N runs
the first N levels of the U-Net and the UGAN towers and the last N of
their decoders packed, and the discriminator's stem, in ``pack_mode``
(the towers) and ``d_pack_mode`` (the discriminator; "" inherits
``pack_mode``): "hw" on the 2x2 space-to-depth grid
(``models/packed.py``), "w" W-only (``models/packed_w.py``) from
``pack_w0`` subpixels at level 0, the W discriminator's stride-2 blocks
packed too while ``d_pack_deep``; no packing under batch norm (DTC).  So
``--set pack_levels=2`` runs the JAX ``Config()``'s layout: hw towers,
paired, with a deep W discriminator.  ``pair_towers`` (None: on where
the JAX package's rule turns it on) runs two hw towers' level 0 as one
program (``models/paired.py``: the UGAN family but ``uganShp0``, CPS's
two nets; W towers are never paired); ``packed_loss_tails`` (None: each
step's JAX rule) feeds the hw-packed logits to the packed losses;
``pool_pack_fused`` (None: on from batch 32) pools and repacks in one;
the GAN step's ``d_concat_hat`` runs real, fake and x_hat through one D
apply.  Packing on the space or model axis raises (ROADMAP A13c).  The
hw conv's lowering and the paired conv's weight gradient are chosen by
the environment, as in the JAX package: ``SMSUT_PACKED_IMPL`` (v1, the
default, v2 or v2k3) and ``SMSUT_PAIRED_DW`` (dense, the default, or
block).  The port's default ``pack_levels`` is 0, not the JAX package's
2: no H100 measurement has chosen a packed layout yet (ROADMAP C).

Knobs that shape the TPU lowering only are accepted and do nothing in the
port: ``layout_pin`` (ROADMAP A13b; refused, as in the JAX package, with
a W discriminator, its default), and ``norm_stats`` (the port always
takes f32 ``reduce`` statistics, where the JAX package's "auto" sums in
bf16 under bf16 compute; its other modes are ROADMAP A13b).

``remat`` and ``remat_unet`` rematerialise in the backward, as in the JAX
package: ``remat`` the UGAN family's generator forward
(``train/steps/gan.py``), ``remat_unet`` the supervised U-Net's encoder
and decoder, each on its own (``models/unet.py``; the zoo's U-Nets are
built without it, as there).  Only under grad: the same function for one
more forward of what is wrapped, and less activation memory.

``steps_per_dispatch`` and ``eval_scan`` govern the fit loop's dispatch as
in the JAX package: T iterations staged per dispatch, and the eval sweep
from a test set kept on the card; on the card each iteration and each
eval batch is a CUDA graph replay (train/loop.py).

``data_parallel`` and ``spatial_parallel`` are checked against the
process group (``parallel/mesh.py`` ``check_config``, called by the fit
loop): the group of ``dp x sp`` ranks is laid out as the JAX package's
``('data', 'space')`` mesh; ``spatial_parallel`` ``sp`` must divide the
group's size, and each rank then holds ``1/sp`` of the rows of every map
of its data coordinate's images; ``data_parallel`` 0 takes the group's
size over ``sp``, and any other value must equal it (a value above 1 in a
single process raises: launch that many processes with
``torch.distributed.run``).  Under ``sp > 1`` the JAX Trainer's guard
(``input_size // 16 >= max(4, sp)``) holds, every map must split into
whole rows of at least its halo (M3L's SegFormer: each stage's rows a
multiple of its attention's reduction ratio); ``block_pallas`` runs K3
and K6 split at their statistics (``ops/block.py``).  Every algorithm takes the space axis: the U-Net, the UGAN
family, Mean Teacher, CPS, CoraNet's two stages and M3L (and DTC's
model).

Channel-wise tensor parallelism has no knob, as in the JAX package, whose
Trainer does not reach it either: a program lays the group out with
``parallel/mesh.py`` ``make_mesh_2d(dp, tp)`` and shards a train state
with ``shard_params_channelwise(mesh, state)``, then calls the
algorithm's ``train_step`` and ``eval_fn`` (every algorithm: the U-Net,
the UGAN family, Mean Teacher, CPS, CoraNet's two stages and its pseudo
sweep, M3L, and DTC's model), as ``parallel/dryrun.py``
``dryrun_multichip`` does.  It does not combine with ``spatial_parallel >
1`` (the JAX package's guard).

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
    # ranks of the process group: 0 = all of them, else the group's size
    data_parallel: int = 0
    # H-sharding across ranks: each rank 1/spatial_parallel of every map's
    # rows (parallel/mesh.py check_config)
    spatial_parallel: int = 1
    prefetch_depth: int = 2
    # no-op in the port (every CUDA instance norm runs kernel K1)
    use_pallas: bool = False
    # the packed levels (module docstring); 0 in the port
    pack_levels: int = 0
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
