# -*- coding: utf-8 -*-
"""PyTorch/CUDA port of SMSUT-TPU for NVIDIA Hopper (H100).

The JAX package ``smsut_tpu`` is the reference this package is held
against; nothing here imports it or JAX.  Public functions take and return
NHWC tensors, as the JAX package does.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
