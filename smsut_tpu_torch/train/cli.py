# -*- coding: utf-8 -*-
"""The trainers' command line: port of ``smsut_tpu/train/cli.py``.

The reference's flags verbatim -- ``-p/--phase {train,test,pseudo}
-f/--fold -nm/--expr_name -i/--model_id -wh/--which_ckpt`` -- with
``--data_root``, ``--expr_root``, ``--set KEY=VALUE`` and ``--resume
IDX[:TAG]``.  One flag of the port's own, ``--device``, names the device;
the card is the default, and ``--device cpu`` runs the plain PyTorch path
on the CPU (as the JAX package's tests ask for its CPU platform).

``-p pseudo`` (:func:`saving_pseudo`) writes per test slice the colourised
prediction, ground truth and image, and for the GAN algorithms the
translation strip and the hand-picked volumes' grids, as PNG through the
port's own codec (utils/io.py), where the JAX package writes JPEG through
PIL.

Data parallel on N cards: ``python -m torch.distributed.run
--nproc_per_node N -m smsut_tpu_torch.trainer.unetTrainer -p train ...``
(any trainer module of ``smsut_tpu_torch/trainer/``).  :func:`run_main`
joins the process group first (``parallel/distributed.py``: NCCL with a
card per rank, gloo otherwise) and each rank takes its own card;
``batch_size`` stays the global batch.  ``-p test`` runs the sharded eval
sweep on every rank and rank 0 writes the CSV; ``-p pseudo`` runs on rank
0 alone.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import random
from os.path import join as pjoin

import numpy as np
import torch.distributed

from smsut_tpu_torch.config import Config, get_config
from smsut_tpu_torch.parallel import distributed


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


def config_of(args) -> Config:
    """The run's Config: the defaults, the roots and the ``--set``
    overrides of ``args``."""
    cfg = get_config()
    if args.data_root:
        cfg = cfg.replace(base_root=args.data_root)
    if args.expr_root:
        cfg = cfg.replace(expr_root=args.expr_root)
    return apply_overrides(cfg, getattr(args, "overrides", []))


def seed_host(cfg: Config) -> None:
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)


def run_main(algo_factory, args=None, capture: bool = True) -> None:
    """Seed the host RNGs and drive the train, test or pseudo phase, as
    each reference trainer's ``__main__`` block does.  ``algo_factory(cfg,
    device)`` builds the algorithm; ``capture=False`` runs the Trainer's
    iterations and eval sweep eagerly instead of as CUDA graphs."""
    if args is None:
        args = make_parser().parse_args()
    cfg = config_of(args)
    if args.phase in ("test", "pseudo") and not args.model_id:
        raise SystemExit(f"error: -p {args.phase} requires -i/--model_id "
                         "(the numbered experiment dir to load)")
    seed_host(cfg)

    from smsut_tpu_torch.train.loop import Trainer

    with process_group(args):
        algo = algo_factory(cfg, getattr(args, "device", None))
        drive(Trainer(algo, cfg, args.phase, args, capture=capture), args)


@contextlib.contextmanager
def process_group(args):
    """The process group of a launch of N processes joined for the
    block, before anything touches the card (each rank then takes its own
    card), and left after it; nothing in a single process."""
    joined = (not torch.distributed.is_initialized()
              and distributed.initialize(device=getattr(args, "device",
                                                        None)))
    if joined:
        print(f"[distributed] process {distributed.process_index()}/"
              f"{distributed.process_count()}, backend "
              f"{distributed.backend()}", flush=True)
    try:
        yield
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def drive(trainer, args, start=None) -> None:
    """Run ``args.phase`` on ``trainer``: train (resumed from
    ``--resume IDX[:TAG]``, the algorithm's last checkpoint by default;
    else after ``start()`` where given), test or pseudo; the experiment
    closed at the end."""
    try:
        if args.phase == "train":
            trainer.exp.register_experiment_args(args)  # expriments.log
            if getattr(args, "resume", None):
                idx, _, tag = args.resume.partition(":")
                trainer.load_model(idx, tag or getattr(
                    trainer.algo, "last_prefix", "last"))
                trainer.epoch = (int(trainer.state.step)
                                 // trainer.cfg.num_iter_per_epoch)
            elif start is not None:
                start()
            trainer.fit("inTurn")
        else:
            evaluate(trainer, args)
    finally:
        trainer.exp.close()


def evaluate(trainer, args) -> None:
    """``-p test`` (the trois CSV) or ``-p pseudo`` (:func:`saving_pseudo`)
    of the checkpoint ``-i``/``-wh``."""
    if args.phase == "pseudo" and not trainer._primary:
        return   # rank 0 writes the PNGs, once
    trainer.load_model(args.model_id, args.which_ckpt)
    expr_root = pjoin(trainer.exp.expr_root, args.model_id)
    if args.phase == "test":
        trainer.test("inTurn", expr_root)
    elif args.phase == "pseudo":
        saving_pseudo(trainer, expr_root)
    else:
        raise NotImplementedError(args.phase)


def saving_pseudo(trainer, expr_root: str) -> int:
    """Per test slice ``{name}pse.png`` (the colourised prediction),
    ``{name}gt.png`` (the colourised ground truth) and ``{name}ori.png``
    (the image, ``(x + 1) * 255`` as uint8, grey in RGB, as the reference
    writes it); for an algorithm with a translation (the GAN family)
    ``{name}fk.png``, the slice and its translation to every modality side
    by side, and ``{key}_grid.png`` for each of ``cfg.pseudo_volumes``,
    the volume's strips stacked by slice.  Under ``{expr_root}/pseudo``;
    returns the slices written."""
    from smsut_tpu_torch.data.dataset import get_loader
    from smsut_tpu_torch.utils.io import (colorize, imwrite_gray,
                                          imwrite_rgb, maybe_mkdir)

    cfg = trainer.cfg
    pred_root = pjoin(expr_root, "pseudo")
    maybe_mkdir(pred_root)
    loader = get_loader(cfg.base_root, "test", 0, cfg.batch_size, cfg=cfg)
    trainer.info(f"Predict and save in {pred_root}.")
    params = trainer.algo.eval_params(trainer.state)
    translate = getattr(trainer.algo, "_translate", None)
    eye = np.eye(cfg.n_modal, dtype=np.float32)
    vol_strips = {k: [] for k in (cfg.pseudo_volumes or ())}
    count = 0
    for batch in loader:
        b = batch.batch_size
        img, msk = batch.img, batch.msk
        if b != cfg.batch_size:
            pad = ((0, cfg.batch_size - b),) + ((0, 0),) * (img.ndim - 1)
            img, msk = np.pad(img, pad), np.pad(msk, pad[:msk.ndim])
        _, pred = trainer._eval_step(params, trainer._to_device(img),
                                     trainer._to_device(msk))
        pred = pred[:b].cpu().numpy()
        strips = None
        if translate is not None:
            vec_org = eye[np.full(img.shape[0], int(batch.mdl[0]))]
            cols = [img]
            for target in range(cfg.n_modal):
                _, tsl = translate(params, img, eye[target] - vec_org)
                cols.append(tsl.cpu().numpy())
            strips = np.clip((np.concatenate(cols, axis=2) + 1) / 2, 0, 1)
        count += b
        for i in range(b):
            name = pjoin(pred_root, batch.names[i])
            imwrite_rgb(name + "pse.png", colorize(pred[i]).astype(np.uint8))
            imwrite_rgb(name + "gt.png",
                        colorize(batch.msk[i]).astype(np.uint8))
            ori = ((batch.img[i, ..., 0] + 1) * 255).astype(np.uint8)
            imwrite_rgb(name + "ori.png", np.repeat(ori[..., None], 3, -1))
            if strips is None:
                continue
            imwrite_gray(name + "fk.png",
                         (strips[i, ..., 0] * 255).astype(np.uint8))
            mod, pid, z = batch.names[i].split("_")
            if f"{mod}_{pid}" in vol_strips:
                vol_strips[f"{mod}_{pid}"].append((int(z), strips[i, ..., 0]))
    for key, rows in vol_strips.items():
        if not rows:
            continue
        rows.sort(key=lambda t: t[0])
        grid = np.concatenate([r for _, r in rows], axis=0)
        imwrite_gray(pjoin(pred_root, key + "_grid.png"),
                     (grid * 255).astype(np.uint8))
        trainer.info(f"Saved translation grid {key}_grid.png "
                     f"({len(rows)} slices).")
    print(count)
    return count
