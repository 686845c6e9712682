# -*- coding: utf-8 -*-
"""UGAN translation-GAN trainer CLI (``trainer/uganTrainer.py``); flags as
``uganConsisTrainer``."""
from smsut_tpu_torch.train.cli import run_main
from smsut_tpu_torch.train.steps.gan import UGANTrainerAlgo

if __name__ == "__main__":
    run_main(UGANTrainerAlgo)
