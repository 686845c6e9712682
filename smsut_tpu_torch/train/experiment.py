# -*- coding: utf-8 -*-
"""Experiment directory manager, logging, TensorBoard, code snapshot.

Port of ``smsut_tpu/train/experiment.py``: numbered experiment dirs (000,
001, ...) with ckpt/tb/result/sample subdirs, a snapshot of the source, a
file+console logger writing ``train.log``, and the ``expriments.log``
registry appender.  Scalars go to TensorBoard when
``torch.utils.tensorboard`` can be imported, and nowhere otherwise.

Under a process group the ranks other than 0 are spectators
(``spectator=True``): they make no directory, write no log, no registry
line and no TensorBoard events, and ``info`` prints."""
from __future__ import annotations

import logging
import os
import shutil
from os.path import join as pjoin
from typing import Optional

from smsut_tpu_torch.utils.io import maybe_mkdir


def _summary_writer(log_dir: str):
    """A TensorBoard writer, or None where the tensorboard package that
    ``torch.utils.tensorboard`` needs is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class Experiment:
    def __init__(self, expr_root: str, expr_name: str, phase: str = "train",
                 snapshot_src: Optional[str] = None, spectator: bool = False):
        """Outside the train phase, and for a spectator, there is no model
        dir and no logger, and info() prints."""
        self.spectator = spectator
        if not spectator:
            maybe_mkdir(expr_root)
        self.expr_root = pjoin(expr_root, expr_name)
        self.phase = phase
        self.model_idx: Optional[str] = None
        self.writer = None
        self.logger: Optional[logging.Logger] = None
        self.model_root = None
        self.ckpt_root = self.result_root = self.sample_root = None
        if phase == "train" and not spectator:
            self._init_train_env(snapshot_src)

    def _init_train_env(self, snapshot_src: Optional[str]) -> None:
        if snapshot_src is None:
            # default: snapshot the framework source (the repository)
            snapshot_src = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        maybe_mkdir(self.expr_root)
        self.model_idx = str(len(os.listdir(self.expr_root))).rjust(3, "0")
        self.model_root = pjoin(self.expr_root, self.model_idx)
        self.ckpt_root = pjoin(self.model_root, "ckpt")
        tb_root = pjoin(self.model_root, "tb")
        self.result_root = pjoin(self.model_root, "result")
        self.sample_root = pjoin(self.model_root, "sample")
        maybe_mkdir(self.model_root, self.ckpt_root, tb_root, self.result_root,
                    self.sample_root)
        inside = os.path.abspath(self.model_root).startswith(
            os.path.abspath(snapshot_src) + os.sep) if snapshot_src else False
        if snapshot_src and os.path.isdir(snapshot_src) and not inside:
            shutil.copytree(snapshot_src, pjoin(self.model_root, "code"),
                            ignore=shutil.ignore_patterns(
                                ".git", "__pycache__", "*.ckpt", "*.so",
                                ".pytest_cache", "build", "chiprun_out"),
                            dirs_exist_ok=True)
        if os.environ.get("SMSUT_NO_TB") != "1":
            self.writer = _summary_writer(tb_root)

        # a logger of this experiment's own, outside logging's registry:
        # another experiment in the process (or the JAX package's, in the
        # tests) must not add its handlers to it
        self.logger = logging.Logger(f"smsut_tpu_torch.{self.model_idx}")
        self.logger.setLevel(logging.INFO)
        fmt = logging.Formatter("%(asctime)s - %(levelname)s: %(message)s")
        for handler in (logging.StreamHandler(),
                        logging.FileHandler(pjoin(self.model_root, "train.log"),
                                            mode="a", encoding="utf-8")):
            handler.setFormatter(fmt)
            self.logger.addHandler(handler)
        self.info(f"Create train environment in {self.model_root}.")

    def register_experiment_args(self, args, filename: str = "expriments.log") -> None:
        # (sic) the reference's filename
        if self.spectator:
            return
        with open(pjoin(os.path.dirname(self.expr_root), filename), "a") as f:
            f.write(f"{os.path.basename(self.expr_root)}, {self.model_root}\n")
            f.write(str(args) + "\n\n")

    def close(self) -> None:
        """Close the log file and the TensorBoard writer."""
        if self.logger is not None:
            for handler in list(self.logger.handlers):
                self.logger.removeHandler(handler)
                handler.close()
            self.logger = None
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    def info(self, s) -> None:
        if self.logger is not None:
            self.logger.info(s)
        else:
            print(s)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
