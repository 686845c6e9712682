# -*- coding: utf-8 -*-
from smsut_tpu_torch.models.unet import UNet

__all__ = ["UNet"]
