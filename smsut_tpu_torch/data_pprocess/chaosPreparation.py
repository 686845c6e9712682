# -*- coding: utf-8 -*-
"""CHAOS preparation CLI, the port's counterpart of
``data_pprocess/chaosPreparation.py``:

    python -m smsut_tpu_torch.data_pprocess.chaosPreparation \
        --chaos_root <CHAOS Train_Sets> --out <nii.gz tree> \
        [--spacing 1.5 1.5 5] [--size 256]

Writes ``{t1in,t1out,t2}/{images,labels}/{modality}_{pid}.nii.gz``
(``preprocess/chaos.py``).
"""
import argparse
import sys

from smsut_tpu_torch.config import get_config
from smsut_tpu_torch.preprocess.chaos import ChaosPreparation
from smsut_tpu_torch.utils.io import maybe_mkdir


def main(argv=None) -> int:
    cfg = get_config()
    ap = argparse.ArgumentParser()
    ap.add_argument("--chaos_root", default=cfg.chaos_root)
    ap.add_argument("--out", default=cfg.base_root)
    ap.add_argument("--spacing", type=float, nargs=3,
                    default=list(cfg.new_spacing))
    ap.add_argument("--size", type=int, default=cfg.input_size)
    args = ap.parse_args(argv)
    maybe_mkdir(args.out)
    for modality in ("t1in", "t1out", "t2"):
        ChaosPreparation(args.chaos_root, modality).run(
            args.out, tuple(args.spacing), args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
