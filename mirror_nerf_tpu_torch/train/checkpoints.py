"""The weights bridge: named-leaf npz snapshots of parameter trees (torch
counterpart of `save_pytree` / `load_pytree` in
`mirror_nerf_tpu/train/checkpoints.py`).

Train checkpoints add the global step, the epoch and the optimizer state,
again under the JAX package's names (`Optimizer.state_arrays`), so a run
resumes in either package.

A parameter tree is nested dicts/lists of tensors. Each leaf is stored under
its path — dict keys and list indices joined by "/" (`coarse/grid/axes/0/1`,
`fine/sigma_net/0/w`, ...) — the names the JAX package writes, with matrices
kept in its (in, out) layout. So an npz written by either package loads in
the other, bit for bit. The reference's torch Lightning checkpoints of the
PE-MLP layout load too (`load_torch_ckpt`; `save_torch_ckpt` writes
one).
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


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree in path order (dict keys
    sorted): the order of the npz leaf names."""
    return [leaf for _, leaf in _leaves(tree)]


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


def _load_leaves(data, path: str, like):
    """`like`'s structure with each leaf taken from `data` (leaf path ->
    array), in the dtype and on the device of the `like` leaf."""
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


def load_pytree(path: str, like):
    """Load leaves saved by either package's save_pytree into the structure
    of `like` (dtype and device of each `like` leaf)."""
    return _load_leaves(np.load(path, allow_pickle=False), path, like)


def load_pytree_nonstrict(path: str, like, prefixes_to_ignore=()):
    """Non-strict load (reference utils/__init__.py:109-136): leaves the
    checkpoint names with the right shape, outside the ignored prefixes,
    come from it; every other leaf keeps its value from `like`. A train
    checkpoint's "params/" leaves count as parameters."""
    with np.load(path, allow_pickle=False) as raw:
        if any(k.startswith("params/") for k in raw.files):
            data = {k[len("params/"):]: raw[k] for k in raw.files
                    if k.startswith("params/")}
        else:
            data = {k: raw[k] for k in raw.files}
    if not any(p in data for p, _ in _leaves(like)):
        raise KeyError(f"checkpoint {path} shares no leaves with the model")

    def take(key, v):
        arr = data.get(key)
        if (arr is None or tuple(arr.shape) != tuple(v.shape)
                or any(key.startswith(pre) or f"/{pre}" in f"/{key}"
                       for pre in prefixes_to_ignore)):
            return v
        return torch.from_numpy(np.array(arr, copy=True)).to(
            dtype=v.dtype, device=v.device)

    return _map(like, take)


# ---- the reference's torch Lightning checkpoints ----


def _torch_linear(sd: dict, prefix: str) -> dict:
    """One torch nn.Linear -> {"w": (in, out), "b": (out,)} (torch keeps
    the weight as (out, in))."""
    out = {"w": np.asarray(sd[f"{prefix}.weight"], np.float32).T}
    if f"{prefix}.bias" in sd:
        out["b"] = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return out


def torch_mirror_nerf_to_params(sd: dict, model_prefix: str,
                                depth: int = 8) -> dict:
    """One reference MirrorNeRF module's state dict (keys like
    `nerf_fine.xyz_encoding_1.0.weight`) -> the MirrorNeRFField parameter
    tree, as numpy arrays. The mirror head's second linear is
    `is_mirror_net.2` (index 1 is its LeakyReLU)."""
    sub = {k[len(model_prefix) + 1:]: v for k, v in sd.items()
           if k.startswith(model_prefix + ".")}
    params = {
        "trunk": [_torch_linear(sub, f"xyz_encoding_{i + 1}.0")
                  for i in range(depth)],
        "sigma": _torch_linear(sub, "sigma"),
        "xyz_final": _torch_linear(sub, "xyz_encoding_final"),
        "dir_enc": _torch_linear(sub, "dir_encoding.0"),
        "rgb": _torch_linear(sub, "rgb.0"),
    }
    if any(k.startswith("normal_net") for k in sub):
        params["normal"] = [_torch_linear(sub, "normal_net.0"),
                            _torch_linear(sub, "normal_net.1")]
    if any(k.startswith("is_mirror_net") for k in sub):
        params["is_mirror"] = [_torch_linear(sub, "is_mirror_net.0"),
                               _torch_linear(sub, "is_mirror_net.2")]
    return params


def save_torch_ckpt(path: str, params: dict) -> None:
    """Write PE-MLP parameters ({"coarse": ..., "fine": ...}, tensors or
    arrays) as the reference's Lightning checkpoint (`nerf_<side>.` +
    `xyz_encoding_<i+1>.0`, `sigma`, `xyz_encoding_final`, `dir_encoding.0`,
    `rgb.0`, `normal_net.{0,1}`, `is_mirror_net.{0,2}`; torch's (out, in)
    weights) — the inverse of `load_torch_ckpt`."""
    sd = {}

    def lin(prefix, p):
        for key, name in (("w", "weight"), ("b", "bias")):
            a = np.asarray(torch.as_tensor(p[key]).detach().cpu(), np.float32)
            sd[f"{prefix}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(a.T if key == "w" else a))

    for side, p in params.items():
        m = f"nerf_{side}"
        for i, layer in enumerate(p["trunk"]):
            lin(f"{m}.xyz_encoding_{i + 1}.0", layer)
        for name, key in (("sigma", "sigma"),
                          ("xyz_encoding_final", "xyz_final"),
                          ("dir_encoding.0", "dir_enc"), ("rgb.0", "rgb")):
            lin(f"{m}.{name}", p[key])
        for name, key, idx in (("normal_net", "normal", (0, 1)),
                               ("is_mirror_net", "is_mirror", (0, 2))):
            for j, lp in zip(idx, p.get(key, ())):
                lin(f"{m}.{name}.{j}", lp)
    torch.save({"epoch": 0, "state_dict": sd}, path)


def load_torch_ckpt(path: str, params_like: dict) -> dict:
    """A reference Lightning .ckpt of the MirrorNeRF MLP layout
    (`nerf_coarse.*` / `nerf_fine.*`) -> the parameters, in the structure,
    dtype and device of `params_like` ({"coarse": ..., "fine": ...})."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}
    if any(k.endswith("encoder.params") for k in sd):
        raise NotImplementedError(
            f"{path} is a hash-grid (MirrorNeRFTcnn) checkpoint; the "
            "hash-grid model is not ported yet: ROADMAP.md queue 1, item 4")
    data = {}
    for side, like in params_like.items():
        if "trunk" not in like:
            raise ValueError(f"{path} holds the reference's PE-MLP layout, "
                             "which loads into --model_type nerf only")
        if not any(k.startswith(f"nerf_{side}.") for k in sd):
            raise KeyError(f"checkpoint {path} has no nerf_{side} module")
        tree = torch_mirror_nerf_to_params(sd, f"nerf_{side}",
                                           depth=len(like["trunk"]))
        data.update({f"{side}/{p}": v for p, v in _leaves(tree)})
    return _load_leaves(data, path, params_like)


def load_params_any(path: str, params_like: dict) -> dict:
    """Load params from an npz checkpoint (a raw parameter tree, or a full
    train checkpoint whose parameter leaves live under "params/") or, for
    any other path, from a reference torch Lightning .ckpt."""
    if not path.endswith(".npz"):
        return load_torch_ckpt(path, params_like)
    with np.load(path) as data:
        is_train = any(k.startswith("params/") for k in data.files)
    if is_train:
        return load_pytree(path, {"params": params_like})["params"]
    return load_pytree(path, params_like)


def save_train_ckpt(path: str, params, optimizer, step: int,
                    epoch: int) -> None:
    """Parameters under "params/", the step, the epoch and the optimizer
    state, as the JAX package's `save_train_ckpt` writes them."""
    arrays = {f"params/{p}": _to_numpy(v) for p, v in _leaves(params)}
    arrays["step"] = np.asarray(step, np.int64)
    arrays["epoch"] = np.asarray(epoch, np.int64)
    arrays.update(optimizer.state_arrays(step))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_train_ckpt(path: str, params_like):
    """Load a train checkpoint of either package: (the parameters in the
    structure, dtype and device of `params_like`, the step, the epoch).
    `load_optimizer_state` restores the optimizer state."""
    params = load_pytree(path, {"params": params_like})["params"]
    with np.load(path, allow_pickle=False) as data:
        return params, int(data["step"]), int(data["epoch"])


def load_optimizer_state(path: str, optimizer) -> None:
    """Restore a train checkpoint's optimizer state into `optimizer`
    (train/optim.Optimizer over the parameters it will update)."""
    with np.load(path, allow_pickle=False) as data:
        optimizer.load_state_arrays(data)
