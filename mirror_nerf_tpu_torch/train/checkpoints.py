"""The weights bridge: named-leaf npz snapshots of parameter trees (torch
counterpart of `save_pytree` / `load_pytree` in
`mirror_nerf_tpu/train/checkpoints.py`).

A parameter tree is nested dicts/lists of tensors. Each leaf is stored under
its path — dict keys and list indices joined by "/" (`coarse/grid/axes/0/1`,
`fine/sigma_net/0/w`, ...) — the names the JAX package writes, with matrices
kept in its (in, out) layout. So an npz written by either package loads in
the other, bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map(tree, fn, prefix=""):
    """Same structure as `tree`, each leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def params_from_numpy(tree, device="cpu"):
    """A tree of numpy arrays (e.g. JAX parameters through `np.asarray`) ->
    the same tree of tensors on `device`."""
    return _map(tree, lambda _, v: torch.from_numpy(
        np.array(v, copy=True)).to(device))


def params_to_numpy(tree):
    return _map(tree, lambda _, v: _to_numpy(v))


def save_pytree(path: str, tree) -> None:
    arrays = {p: _to_numpy(v) for p, v in _leaves(tree)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_pytree(path: str, like):
    """Load leaves saved by either package's save_pytree into the structure
    of `like` (dtype and device of each `like` leaf)."""
    data = np.load(path, allow_pickle=False)

    def take(key, v):
        if key not in data:
            raise KeyError(f"checkpoint {path} missing leaf {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs model {tuple(v.shape)}")
        return torch.from_numpy(np.array(arr, copy=True)).to(
            dtype=v.dtype, device=v.device)

    return _map(like, take)


def load_params_any(path: str, params_like: dict) -> dict:
    """Load params from an npz checkpoint: a raw parameter tree, or a full
    train checkpoint whose parameter leaves live under "params/"."""
    if not path.endswith(".npz"):
        raise NotImplementedError(
            "reference torch Lightning checkpoints are not bridged yet "
            "(ROADMAP.md queue 1, item 2); convert to npz with the JAX "
            "package's load_params_any + save_pytree")
    with np.load(path) as data:
        is_train = any(k.startswith("params/") for k in data.files)
    if is_train:
        return load_pytree(path, {"params": params_like})["params"]
    return load_pytree(path, params_like)
