# -*- coding: utf-8 -*-
"""nii.gz -> PNG slice tree and split YAML CLI, the port's counterpart of
``data_pprocess/toPngAndSplit.py``:

    python -m smsut_tpu_torch.data_pprocess.toPngAndSplit \
        --src <nii.gz tree> --dst <PNG tree> [--skip-png] [--skip-split]

Writes ``{modality}/{pid}/{images,labels}/*.png``, each volume's label
``.npy`` and the split YAML (``Config.split_yaml``) that the trainers read
(``preprocess/to_png_and_split.py``).
"""
import argparse
import random
import sys

import numpy as np

from smsut_tpu_torch.config import get_config
from smsut_tpu_torch.preprocess.to_png_and_split import (
    split_train_val_test, to_png)


def main(argv=None) -> int:
    cfg = get_config()
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=cfg.base_root,
                    help="nii.gz tree (bimod_root)")
    ap.add_argument("--dst", default=cfg.base_root,
                    help="png tree (png_root)")
    ap.add_argument("--skip-png", action="store_true")
    ap.add_argument("--skip-split", action="store_true")
    args = ap.parse_args(argv)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    if not args.skip_png:
        to_png(args.src, args.dst)
    if not args.skip_split:
        split_train_val_test(args.dst, args.dst, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
