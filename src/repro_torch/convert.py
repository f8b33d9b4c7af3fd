"""Carry weights and data between the JAX package's layout and the port's.

The JAX package keeps parameters as dicts of arrays with conv kernels in
HWIO; the port keeps conv kernels in PyTorch's OIHW.  Node-stacked trees
carry the node axis first in both.  Everything else (Stiefel leaves, y,
batches) has the same layout in both packages.  Inputs are NumPy arrays
(or anything ``numpy.asarray`` takes); this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

# HWIO -> OIHW for one kernel, and with a leading node axis
_TO_OIHW = {4: (3, 2, 0, 1), 5: (0, 4, 3, 1, 2)}
_TO_HWIO = {4: (2, 3, 1, 0), 5: (0, 3, 4, 2, 1)}


def _is_conv(name: str) -> bool:
    return name.startswith("conv")


def params_from_reference(params: dict, device) -> dict:
    """The JAX package's parameter dict (single-node or node-stacked) as
    the port's tensors: conv kernels HWIO -> OIHW, fp32."""
    out = {}
    for name, value in params.items():
        a = np.array(value, dtype=np.float32)
        if _is_conv(name):
            a = np.transpose(a, _TO_OIHW[a.ndim])
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def params_to_reference(params: dict) -> dict:
    """The inverse of :func:`params_from_reference`, as NumPy arrays."""
    out = {}
    for name, value in params.items():
        a = value.detach().cpu().numpy()
        if _is_conv(name):
            a = np.transpose(a, _TO_HWIO[a.ndim])
        out[name] = np.ascontiguousarray(a)
    return out


def batch_to_torch(batch: dict, device) -> dict:
    """A synthetic-stream batch (images fp32, labels int) as tensors; labels
    become int64, the index type of PyTorch's gather."""
    return {
        "images": torch.as_tensor(np.asarray(batch["images"], np.float32),
                                  device=device),
        "labels": torch.as_tensor(np.asarray(batch["labels"], np.int64),
                                  device=device),
    }
