"""Dependency-free tree checkpointing (npz + path manifest).

Mirrors ``src/repro/checkpoint.py``, file for file:
``<dir>/step_<n>.npz`` with keys ``p<i>`` in the JAX package's flatten
order (dict keys sorted; ``tree.tree_flatten_with_path``), a
``__paths__`` manifest checked on restore and a ``__dtypes__`` manifest
(bfloat16 leaves are stored as their raw 16 bits).  So a parameter tree
written by either package restores in the other, and so does an optimizer
state, with telemetry too: the port's wire counters (``obs/wire.py``
``Counters``, a host half and a device half) are saved as the JAX
package's one packed ``f32[6]`` leaf and split again on restore
(``obs.wire.from_packed``).  Leaves are stored as they are: the
port's conv kernels in OIHW, the JAX package's in HWIO
(``repro_torch.convert`` carries a fair parameter tree between the two).

Tensors are saved from any device and restored to the device the caller
names (``cuda`` by default).  A leaf of ``like`` that is a Python number
(the port's ``step``) restores as a Python number, a NumPy array as a
NumPy array.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.obs.wire import Counters, from_packed, pack
from repro_torch.tree import tree_flatten_with_path

Tree = Any


def _is_counters(node) -> bool:
    return isinstance(node, Counters)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, Counters):
        return pack(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, a: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(a.dtype)


def save(directory: str, step: int, tree: Tree) -> str:
    os.makedirs(directory, exist_ok=True)
    paths, leaves, _ = tree_flatten_with_path(tree, _is_counters)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        a = _to_numpy(leaf)
        dtypes.append(_dtype_name(leaf, a))
        arrays[f"p{i}"] = a
    arrays["__paths__"] = np.array(json.dumps(paths))
    arrays["__dtypes__"] = np.array(json.dumps(dtypes))
    path = os.path.join(directory, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def _restore_leaf(a: np.ndarray, dtype: str | None, like, device):
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return t.to(device)
    if dtype is not None and str(a.dtype) != dtype:
        a = a.view(np.dtype(dtype))
    if isinstance(like, Counters):
        return from_packed(a, device)
    if isinstance(like, (np.ndarray, np.generic)):
        return a
    if isinstance(like, (bool, int, float)):
        return type(like)(a.item())
    return torch.from_numpy(np.array(a)).to(device)


def restore(directory: str, step: int, like: Tree, device="cuda") -> Tree:
    """Restore into the structure of ``like`` (validates the path
    manifest), tensors on ``device``."""
    path = os.path.join(directory, f"step_{step:08d}.npz")
    with np.load(path, allow_pickle=False) as data:
        want, like_leaves, unflatten = tree_flatten_with_path(like,
                                                              _is_counters)
        have = json.loads(str(data["__paths__"]))
        if want != have:
            raise ValueError(
                f"checkpoint structure mismatch: {len(have)} leaves saved vs "
                f"{len(want)} expected; first diff: "
                f"{next((a, b) for a, b in zip(have + [''], want + ['']) if a != b)}")
        dtypes = json.loads(str(data["__dtypes__"])) \
            if "__dtypes__" in data else [None] * len(want)
        leaves = [_restore_leaf(data[f"p{i}"], dtypes[i], like_leaves[i],
                                device) for i in range(len(want))]
    return unflatten(leaves)
