# -*- coding: utf-8 -*-
"""Metric accumulator with best-value tracking: a copy of
``smsut_tpu/utils/meter.py`` ``Meter`` (EMA ``alpha``, best values,
``collect_loss_by``, ``collect_dice_by``)."""
from __future__ import annotations

from collections import OrderedDict
from copy import deepcopy
from typing import Dict, List, Sequence, Tuple

from smsut_tpu_torch.config import Modality


class Meter:
    def __init__(self, min_better_keys: List[str], max_better_keys: List[str],
                 alpha: float = 1.0):
        self.configs: "OrderedDict[str, str]" = OrderedDict()
        self.alpha = alpha
        for k in min_better_keys:
            self.configs[k] = "min"
        for k in max_better_keys:
            self.configs[k] = "max"
        self.best_values = self.get_empty_dict()
        self.pre_values = None
        self.cur_values = self.get_empty_dict()
        self.n = self.get_empty_dict()

    def get_empty_dict(self) -> Dict[str, float]:
        return {k: 0 for k in self.configs.keys()}

    def accumulate(self, values: Dict[str, float], n: Dict[str, float]) -> None:
        for k, v in values.items():
            self.cur_values[k] += v
            self.n[k] += n[k]

    def update_cur(self, reset_best: bool = False) -> None:
        for k in self.configs.keys():
            if self.n[k] != 0:
                self.cur_values[k] /= self.n[k]
            if self.pre_values is not None:
                self.cur_values[k] = ((1.0 - self.alpha) * self.pre_values[k]
                                      + self.alpha * self.cur_values[k])
        if self.pre_values is None or reset_best:
            self.best_values = deepcopy(self.cur_values)
            self.pre_values = deepcopy(self.cur_values)
        else:
            for k, f in self.configs.items():
                if f == "min" and self.cur_values[k] < self.best_values[k]:
                    self.best_values[k] = self.cur_values[k]
                elif f == "max" and self.cur_values[k] > self.best_values[k]:
                    self.best_values[k] = self.cur_values[k]
                self.pre_values[k] = self.cur_values[k]

    def reset_cur(self) -> None:
        self.cur_values = self.get_empty_dict()
        self.n = self.get_empty_dict()

    @staticmethod
    def collect_loss_by(sample_loss: float, modal_id: int,
                        n: int) -> Tuple[Dict[str, float], Dict[str, float]]:
        k = f"loss_{modal_id}"
        return ({"loss": sample_loss * n, k: sample_loss * n},
                {"loss": n, k: n})

    @staticmethod
    def collect_dice_by(sample_dices: Sequence[float], modal_idxs: Sequence[int],
                        n_modal: int) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Aggregate per-sample dice by modality."""
        dice = [0.0 for _ in range(n_modal)]
        n = [0 for _ in range(n_modal)]
        for sd, mi in zip(sample_dices, modal_idxs):
            i = int(mi)
            dice[i] += float(sd)
            n[i] += 1
        a = {f"dice_{i}": dice[i] for i in range(n_modal)}
        a["dice"] = sum(dice)
        b = {f"dice_{i}": n[i] for i in range(n_modal)}
        b["dice"] = sum(n)
        return a, b

    def __repr__(self) -> str:
        s = ""
        for k in self.configs.keys():
            if "_" in k:
                typ, m = k.split("_")
                new_k = f"{typ}_{Modality(int(m)).name}"
            else:
                new_k = k
            s += " %s: %.4f/%.4f," % (new_k, self.cur_values[k], self.best_values[k])
        return s
