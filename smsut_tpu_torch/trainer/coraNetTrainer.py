# -*- coding: utf-8 -*-
"""CoraNet's two-stage trainer CLI, the port's counterpart of
``trainer/coraNetTrainer.py``:

    # stage A (pre_epoch epochs): saves pre_best / pre_last
    python -m smsut_tpu_torch.trainer.coraNetTrainer -p train \
        --data_root D --expr_root E [--set KEY=VALUE ...]
    # stage B (cora_epoch epochs) from run 000's pre_best: best / last
    python -m smsut_tpu_torch.trainer.coraNetTrainer -p train -i 000 ...
    # head 0 of a checkpoint: the trois CSV, or the colour dumps
    python -m smsut_tpu_torch.trainer.coraNetTrainer -p test -i 001 -wh best
    python -m smsut_tpu_torch.trainer.coraNetTrainer -p pseudo -i 001 -wh best

``--resume IDX[:TAG]`` goes on with a run of the stage the flags name
(stage A's ``pre_last``, stage B's ``last`` by default).  On the CUDA card
unless ``--device cpu``.
"""
from smsut_tpu_torch.train.cli import (config_of, drive, make_parser,
                                       process_group, seed_host)


def main(args=None, capture: bool = True) -> None:
    """Build the stage ``args`` name and drive it; ``capture=False`` runs
    the iterations, the eval sweep and the pseudo-label sweep eagerly."""
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.coranet import CoraNet

    if args is None:
        args = make_parser().parse_args()
    cfg = config_of(args)
    if args.phase in ("test", "pseudo") and not args.model_id:
        raise SystemExit(f"error: -p {args.phase} requires -i/--model_id")
    seed_host(cfg)
    # stage B trains from -i's pre_best; test and pseudo read head 0
    stage = "pre" if args.phase == "train" and not args.model_id else "cora"
    with process_group(args):
        algo = CoraNet(cfg, getattr(args, "device", None), stage=stage)
        trainer = Trainer(algo, cfg, args.phase, args, capture=capture)
        start = None
        if stage == "cora" and args.phase == "train":
            start = lambda: algo.load_pretrained(trainer, args.model_id)
        drive(trainer, args, start)


if __name__ == "__main__":
    main()
