# -*- coding: utf-8 -*-
"""M3L masked-consistency SegFormer trainer CLI, the port's counterpart of
``trainer/M3LTrainer.py``:

    python -m smsut_tpu_torch.trainer.M3LTrainer -p train \
        --data_root D --expr_root E [--set KEY=VALUE ...]
    python -m smsut_tpu_torch.trainer.M3LTrainer -p test -i 000 \
        -wh best --data_root D --expr_root E [--set KEY=VALUE ...]

``-p pseudo -i 000`` writes the colour dumps; ``--resume 000:last`` goes on
with a run.  On the CUDA card unless ``--device cpu``.
"""
from smsut_tpu_torch.train.cli import run_main
from smsut_tpu_torch.train.steps.m3l import M3L

if __name__ == "__main__":
    run_main(M3L)
