# -*- coding: utf-8 -*-
"""The paper's method (SMSUT) trainer CLI, the port's counterpart of
``trainer/uganConsisTrainer.py``:

    python -m smsut_tpu_torch.trainer.uganConsisTrainer -p train \
        --data_root D --expr_root E [--set KEY=VALUE ...]
    python -m smsut_tpu_torch.trainer.uganConsisTrainer -p test -i 000 \
        -wh best --data_root D --expr_root E [--set KEY=VALUE ...]

On the CUDA card unless ``--device cpu``.
"""
from smsut_tpu_torch.train.cli import run_main
from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

if __name__ == "__main__":
    run_main(UGANConsisAlgo)
