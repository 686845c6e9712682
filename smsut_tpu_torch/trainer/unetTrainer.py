# -*- coding: utf-8 -*-
"""Supervised U-Net trainer CLI, the port's counterpart of
``trainer/unetTrainer.py``:

    python -m smsut_tpu_torch.trainer.unetTrainer -p train --data_root D \
        --expr_root E [--set KEY=VALUE ...]
    python -m smsut_tpu_torch.trainer.unetTrainer -p test -i 000 -wh best \
        --data_root D --expr_root E [--set KEY=VALUE ...]

On the CUDA card unless ``--device cpu``.
"""
from smsut_tpu_torch.train.cli import run_main
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

if __name__ == "__main__":
    run_main(SupervisedUNet)
