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
    (config.py)."""
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} is not one of "
                         f"{sorted(_DTYPES)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _DTYPES[cfg.compute_dtype]
