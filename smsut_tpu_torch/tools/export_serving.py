# -*- coding: utf-8 -*-
"""Export a trained checkpoint for serving, the port's counterpart of the
JAX package's ``tools/export_serving.py``:

    python -m smsut_tpu_torch.tools.export_serving MODEL EXPR_DIR[:TAG] \
        OUT_DIR [--set K=V ...] [--device cpu]

MODEL is a zoo name (serve.py ``factories``: unet, meanTeacher, M3L,
crossPse, coraNet, ugan, uganShp0, uganConsis), EXPR_DIR a numbered
experiment directory holding ``ckpt/`` (TAG: ``best`` by default;
CoraNet's stage A saves ``pre_best``), OUT_DIR the directory for the
parameter file and ``manifest.json`` (smsut_tpu_torch/serve.py).  The
``--set`` overrides are the training run's (the widths, ``block_pallas``,
``compute_dtype``).  The checkpoint loads on the card unless ``--device``
names another.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    from smsut_tpu_torch.config import get_config
    from smsut_tpu_torch.serve import export_eval, factories
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.cli import apply_overrides

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", choices=list(factories()))
    p.add_argument("expr", metavar="EXPR_DIR[:TAG]")
    p.add_argument("out_dir")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    expr_dir, _, tag = args.expr.partition(":")
    cfg = apply_overrides(get_config(), args.overrides)
    algo = factories()[args.model][1](cfg, args.device)
    state = checkpoints.load_state(algo.init_state(cfg.seed),
                                   os.path.join(expr_dir, "ckpt"),
                                   tag or "best")
    path = export_eval(algo, algo.eval_params(state), cfg, args.out_dir)
    print(f"exported {args.model} [{tag or 'best'}] -> {path}")
    return path


if __name__ == "__main__":
    main()
