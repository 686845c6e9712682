# -*- coding: utf-8 -*-
"""Cross-pseudo supervision trainer CLI, the port's counterpart of
``trainer/crossPseTrainer.py``:

    python -m smsut_tpu_torch.trainer.crossPseTrainer -p train \
        --data_root D --expr_root E [--set KEY=VALUE ...]
    python -m smsut_tpu_torch.trainer.crossPseTrainer -p test -i 000 \
        -wh best --data_root D --expr_root E [--set KEY=VALUE ...]

``-p pseudo -i 000`` writes the colour dumps (net 1); ``--resume 000:last``
goes on with a run.  On the CUDA card unless ``--device cpu``.
"""
from smsut_tpu_torch.train.cli import run_main
from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo

if __name__ == "__main__":
    run_main(CrossPseudo)
