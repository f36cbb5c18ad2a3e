"""Train/eval split strategies (a copy of ``gstk_tpu/data/splits.py``).

Same four modes as the reference (``gs_toolkit/data/utils/dataparsers_utils.py``):
fraction (evenly-spaced train images), filename ("train"/"eval" in basename),
interval (every k-th is eval), all (both splits share all images).
"""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import numpy as np


def split_fraction(filenames: List, fraction: float) -> Tuple[np.ndarray, np.ndarray]:
    n = len(filenames)
    n_train = math.ceil(n * fraction)
    i_all = np.arange(n)
    i_train = np.linspace(0, n - 1, n_train, dtype=int)
    i_eval = np.setdiff1d(i_all, i_train)
    return i_train, i_eval


def split_filename(filenames: List) -> Tuple[np.ndarray, np.ndarray]:
    i_train, i_eval = [], []
    for idx, f in enumerate(filenames):
        base = os.path.basename(str(f))
        if "train" in base:
            i_train.append(idx)
        elif "eval" in base:
            i_eval.append(idx)
        else:
            raise ValueError(
                f"{base}: filename must contain 'train' or 'eval' for this mode"
            )
    return np.asarray(i_train), np.asarray(i_eval)


def split_interval(filenames: List, interval: int) -> Tuple[np.ndarray, np.ndarray]:
    i_all = np.arange(len(filenames))
    return i_all[i_all % interval != 0], i_all[i_all % interval == 0]


def split_all(filenames: List) -> Tuple[np.ndarray, np.ndarray]:
    i_all = np.arange(len(filenames))
    return i_all, i_all


def get_split(filenames, mode: str, fraction: float = 0.9, interval: int = 8):
    if mode == "fraction":
        return split_fraction(filenames, fraction)
    if mode == "filename":
        return split_filename(filenames)
    if mode == "interval":
        return split_interval(filenames, interval)
    if mode == "all":
        return split_all(filenames)
    raise ValueError(f"Unknown eval mode {mode}")
