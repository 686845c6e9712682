# -*- coding: utf-8 -*-
"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The card unless the caller names a device.  With no device given and
    no CUDA, raise: an entry point never runs on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain PyTorch path on the CPU")
    return torch.device("cuda")
