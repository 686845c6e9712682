# -*- coding: utf-8 -*-
"""UGANnce + PatchNCE trainer CLI (``trainer/uganShp0Trainer.py``); flags
as ``uganConsisTrainer``."""
from smsut_tpu_torch.train.cli import run_main
from smsut_tpu_torch.train.steps.gan import UGANShp0Algo

if __name__ == "__main__":
    run_main(UGANShp0Algo)
