# -*- coding: utf-8 -*-
"""Command-line tools of the port, run as ``python -m
smsut_tpu_torch.tools.<name>``."""
