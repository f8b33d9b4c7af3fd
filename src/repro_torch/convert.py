"""Carry weights and data between the JAX package's layout and the port's.

The JAX package keeps parameters as dicts of arrays with conv kernels in
HWIO; the port keeps conv kernels in PyTorch's OIHW.  Node-stacked trees
carry the node axis first in both.  Everything else (Stiefel leaves, y,
batches) has the same layout in both packages.  The transformer's nested
parameter dicts, its KV caches and the serving path's page pools copy leaf
for leaf (weights ``x @ W`` as (d_in, d_out), stacked repeats on a leading
axis, in both).  The comms engine's memory
(``CommState`` hats, one tree per slot) converts the same way.  Inputs are
NumPy arrays (or anything ``numpy.asarray`` takes); this module imports no
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comms.layer import CommState

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


def _slot_from_reference(tree, device):
    if isinstance(tree, dict):
        return params_from_reference(tree, device)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _slot_to_reference(tree):
    if isinstance(tree, dict):
        return params_to_reference(tree)
    return tree.detach().cpu().numpy()


def comm_state_from_reference(hats: dict, deltas: dict | None, device):
    """The JAX package's ``CommState`` memory (its ``hats`` and ``deltas``,
    as NumPy) as the port's ``CommState``: per slot (x, y, u, v) a parameter
    dict, conv kernels HWIO -> OIHW, or a plain array."""
    return CommState(
        hats={slot: _slot_from_reference(tree, device)
              for slot, tree in hats.items()},
        deltas=None if deltas is None else {
            slot: torch.tensor(float(np.asarray(d)), dtype=torch.float32,
                               device=device)
            for slot, d in deltas.items()})


def comm_state_to_reference(state) -> tuple[dict, dict | None]:
    """The inverse of :func:`comm_state_from_reference`: (hats, deltas) as
    NumPy arrays in the JAX package's layout."""
    hats = {slot: _slot_to_reference(tree) for slot, tree in state.hats.items()}
    deltas = None if state.deltas is None else {
        slot: np.float32(d.item()) for slot, d in state.deltas.items()}
    return hats, deltas


def tree_from_reference(tree, device, dtype=None):
    """A nested dict of the JAX package's arrays (parameters, caches,
    pools) as tensors on ``device``, copied leaf for leaf, in ``dtype``
    (a NumPy dtype; default: each leaf's own)."""
    if isinstance(tree, dict):
        return {k: tree_from_reference(v, device, dtype)
                for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=dtype)).to(device)


def tree_to_reference(tree):
    """The inverse of :func:`tree_from_reference`, as NumPy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_reference(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def transformer_params_from_reference(params: dict, device) -> dict:
    """The JAX transformer's parameters (``models.transformer.init_params``,
    stacked repeats included) as the port's fp32 tensors, no transpose."""
    return tree_from_reference(params, device, np.float32)


def transformer_params_to_reference(params: dict) -> dict:
    """The inverse of :func:`transformer_params_from_reference`."""
    return tree_to_reference(params)


def batch_to_torch(batch: dict, device) -> dict:
    """A synthetic-stream batch (images fp32, labels int) as tensors; labels
    become int64, the index type of PyTorch's gather."""
    return {
        "images": torch.as_tensor(np.asarray(batch["images"], np.float32),
                                  device=device),
        "labels": torch.as_tensor(np.asarray(batch["labels"], np.int64),
                                  device=device),
    }
