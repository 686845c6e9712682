# -*- coding: utf-8 -*-
"""The trainers' command line: port of ``smsut_tpu/train/cli.py``.

The reference's flags verbatim -- ``-p/--phase {train,test,pseudo}
-f/--fold -nm/--expr_name -i/--model_id -wh/--which_ckpt`` -- with
``--data_root``, ``--expr_root``, ``--set KEY=VALUE`` and ``--resume
IDX[:TAG]``.  One flag of the port's own, ``--device``, names the device;
the card is the default, and ``--device cpu`` runs the plain PyTorch path
on the CPU (as the JAX package's tests ask for its CPU platform).
"""
from __future__ import annotations

import argparse
import ast
import random
from os.path import join as pjoin

import numpy as np

from smsut_tpu_torch.config import Config, get_config


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--phase", type=str,
                        choices=("train", "test", "pseudo"))
    parser.add_argument("-f", "--fold", type=int, default=0)
    parser.add_argument("-nm", "--expr_name", type=str)
    parser.add_argument("-i", "--model_id", type=str, help="only for test")
    parser.add_argument("-wh", "--which_ckpt", type=str, default="last")
    parser.add_argument("--data_root", type=str, default=None,
                        help="override SMSUT_DATA_ROOT")
    parser.add_argument("--expr_root", type=str, default=None)
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="override any Config field, e.g. --set max_epoch=2")
    parser.add_argument("--resume", type=str, default=None, metavar="IDX[:TAG]",
                        help="resume training from a saved full state, e.g. "
                             "--resume 000 or --resume 000:last (checkpoints "
                             "carry the optimizer state and the step)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: the CUDA "
                             "card; 'cpu' for the plain PyTorch path)")
    return parser


def apply_overrides(cfg: Config, overrides) -> Config:
    for item in overrides or []:
        key, _, raw = item.partition("=")
        if not hasattr(cfg, key):
            raise SystemExit(f"error: unknown config field '{key}' in --set {item}")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw  # bare strings
        cfg = cfg.replace(**{key: value})
    return cfg


def run_main(algo_factory, args=None, capture: bool = True) -> None:
    """Seed the host RNGs and drive the train or test phase, as each
    reference trainer's ``__main__`` block does.  ``algo_factory(cfg,
    device)`` builds the algorithm; ``capture=False`` runs the Trainer's
    iterations and eval sweep eagerly instead of as CUDA graphs."""
    if args is None:
        args = make_parser().parse_args()
    cfg = get_config()
    if args.data_root:
        cfg = cfg.replace(base_root=args.data_root)
    if args.expr_root:
        cfg = cfg.replace(expr_root=args.expr_root)
    cfg = apply_overrides(cfg, getattr(args, "overrides", []))

    if args.phase in ("test", "pseudo") and not args.model_id:
        raise SystemExit(f"error: -p {args.phase} requires -i/--model_id "
                         "(the numbered experiment dir to load)")
    if args.phase == "pseudo":
        raise NotImplementedError(
            "-p pseudo is not ported yet: it writes JPEGs through PIL and "
            "comes with the GAN's pseudo phase (ROADMAP A7)")

    random.seed(cfg.seed)
    np.random.seed(cfg.seed)

    from smsut_tpu_torch.train.loop import Trainer

    algo = algo_factory(cfg, getattr(args, "device", None))
    trainer = Trainer(algo, cfg, args.phase, args, capture=capture)
    try:
        if args.phase == "train":
            trainer.exp.register_experiment_args(args)  # expriments.log
            if getattr(args, "resume", None):
                idx, _, tag = args.resume.partition(":")
                trainer.load_model(idx, tag or "last")
                trainer.epoch = int(trainer.state.step) // cfg.num_iter_per_epoch
            trainer.fit("inTurn")
        elif args.phase == "test":
            trainer.load_model(args.model_id, args.which_ckpt)
            expr_root = pjoin(trainer.exp.expr_root, args.model_id)
            trainer.test("inTurn", expr_root)
        else:
            raise NotImplementedError(args.phase)
    finally:
        trainer.exp.close()
