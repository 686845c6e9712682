# -*- coding: utf-8 -*-
"""Multi-Atlas (BTCV) preparation CLI, the port's counterpart of
``data_pprocess/atlasPreparation.py``:

    python -m smsut_tpu_torch.data_pprocess.atlasPreparation \
        --atlas_root <BTCV RawData> --out <nii.gz tree> \
        [--spacing 1.5 1.5 5] [--size 256]

Writes ``ct/{images,labels}/ct_{pid}.nii.gz`` (``preprocess/atlas.py``).
"""
import argparse
import sys

from smsut_tpu_torch.config import get_config
from smsut_tpu_torch.preprocess.atlas import AtlasPreparation
from smsut_tpu_torch.utils.io import maybe_mkdir


def main(argv=None) -> int:
    cfg = get_config()
    ap = argparse.ArgumentParser()
    ap.add_argument("--atlas_root", default=cfg.atlas_root)
    ap.add_argument("--out", default=cfg.base_root)
    ap.add_argument("--spacing", type=float, nargs=3,
                    default=list(cfg.new_spacing))
    ap.add_argument("--size", type=int, default=cfg.input_size)
    args = ap.parse_args(argv)
    maybe_mkdir(args.out)
    AtlasPreparation(args.atlas_root).run(args.out, tuple(args.spacing),
                                          args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
