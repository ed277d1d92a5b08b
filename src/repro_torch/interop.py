"""Carry the reference package's trees into the port.

``from_reference`` takes a tree of nested dicts and lists of numpy
arrays in the reference layout (``repro``'s parameter, code and adapter
trees after ``np.asarray`` on each leaf) and returns the port's tree on
``device``. A ``CrossbarWeight`` arrives as the dict ``{"g_pos",
"g_neg", "scale"}``. bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16)
keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rram import CrossbarWeight

_CROSSBAR_KEYS = {"g_pos", "g_neg", "scale"}


def to_tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_reference(tree, device):
    """Numpy reference tree -> port tree on ``device``."""
    if isinstance(tree, dict):
        if set(tree) == _CROSSBAR_KEYS:
            return CrossbarWeight(**{k: to_tensor(tree[k], device) for k in _CROSSBAR_KEYS})
        return {k: from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_reference(v, device) for v in tree]
    return to_tensor(tree, device)
