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
the other, bit for bit. The reference's torch Lightning checkpoints load
too (`load_torch_ckpt`), of the PE-MLP layout (MirrorNeRF) and of the
hash-grid layout (MirrorNeRFTcnn: tcnn's flat grid blob and the bias-free
nets); `save_torch_ckpt` writes either.
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


def _tcnn_level_sizes(spec) -> list:
    """tiny-cuda-nn's per-level entry counts for a HashGrid encoding.

    tcnn (GridEncoding, grid.h): scale_l = 2^(l*S)*base - 1,
    resolution_l = ceil(scale_l) + 1, entries = min(2^log2_hashmap,
    resolution^D) rounded UP to a multiple of 8. This differs from the
    vendored gridencoder (`HashGridSpec.levels`, which pads the dense side
    by one like grid.py:117-124), so a published tcnn blob's levels are
    copied one by one rather than reshaped wholesale.
    """
    sizes = []
    max_params = 2 ** spec.log2_hashmap_size
    for lvl in range(spec.num_levels):
        scale = float(np.exp2(lvl * spec.scale_log2) * spec.base_resolution
                      - 1.0)
        resolution = int(np.ceil(scale)) + 1
        n = min(max_params, resolution ** spec.input_dim)
        sizes.append(int(np.ceil(n / 8) * 8))
    return sizes


def _nobias_stack(sub: dict, name: str, count: int) -> list:
    return [{"w": np.asarray(sub[f"{name}.{i}.weight"], np.float32).T}
            for i in range(count)]


def torch_ngp_to_params(sd: dict, model_prefix: str, field,
                        table_like) -> dict:
    """One reference MirrorNeRFTcnn module's state dict -> the NGPField
    parameter tree, as numpy arrays.

    Reference layout (models/mirror_nerf_tcnn.py:36-149):
      * `encoder.params`: tcnn's flat (possibly fp16) grid blob, level-major,
        entry-major, the 2 features of an entry contiguous;
      * `sigma_net.{i}.weight`, `color_net.{i}.weight`,
        `normal_net.{i}.weight`: bias-free nn.Linear (out, in), transposed;
      * `is_mirror_net.{0,2}.weight/.bias`: the biased mirror head.

    When the blob's rows equal the table's (this package's layout) it is
    taken wholesale; otherwise (tcnn's layout) each level's leading
    min(rows) entries are copied and the rest keep `table_like`'s values.
    """
    sub = {k[len(model_prefix) + 1:]: v for k, v in sd.items()
           if k.startswith(model_prefix + ".")}
    spec = field.grid_spec
    blob = np.asarray(sub["encoder.params"], np.float32).reshape(
        -1, spec.level_dim)
    table = np.array(_to_numpy(table_like), np.float32, copy=True)
    if blob.shape[0] == table.shape[0]:
        table = blob
    else:
        theirs = _tcnn_level_sizes(spec)
        if sum(theirs) != blob.shape[0]:
            raise ValueError(
                f"{model_prefix}.encoder.params has {blob.shape[0]} rows; "
                f"neither this package's layout ({table.shape[0]}) nor "
                f"tcnn's ({sum(theirs)}) for {spec}")
        src_off = 0
        for lv, src_size in zip(spec.levels(), theirs):
            n = min(lv.size, src_size)
            table[lv.offset:lv.offset + n] = blob[src_off:src_off + n]
            src_off += src_size
    params = {"grid": table,
              "sigma_net": _nobias_stack(sub, "sigma_net", field.num_layers),
              "color_net": _nobias_stack(sub, "color_net",
                                         field.num_layers_color)}
    if any(k.startswith("normal_net") for k in sub):
        params["normal"] = _nobias_stack(sub, "normal_net", field.num_layers)
    if any(k.startswith("is_mirror_net") for k in sub):
        params["is_mirror"] = [_torch_linear(sub, "is_mirror_net.0"),
                               _torch_linear(sub, "is_mirror_net.2")]
    return params


def _bound_from_rows(rows: int) -> float:
    """Invert NGPField.grid_spec's table_rows -> bound (small int search)."""
    from ..models.ngp import NGPField

    for bound in (1, 2, 3, 4, 6, 8, 12, 16, 32):
        if NGPField(bound=float(bound)).grid_spec.table_rows == rows:
            return float(bound)
    raise ValueError(f"no standard bound yields a {rows}-row hash table")


def _ngp_field_like(like: dict):
    """The NGPField statics from a parameter tree's shapes (the published
    default architecture), for a checkpoint loaded without its field."""
    from ..models.ngp import NGPField

    return NGPField(
        num_layers=len(like["sigma_net"]),
        hidden_dim=(like["sigma_net"][0]["w"].shape[1]
                    if len(like["sigma_net"]) > 1 else 64),
        geo_feat_dim=like["sigma_net"][-1]["w"].shape[1] - 1,
        num_layers_color=len(like["color_net"]),
        bound=_bound_from_rows(like["grid"].shape[0]),
        predict_normal="normal" in like,
        predict_mirror_mask="is_mirror" in like)


def save_torch_ckpt(path: str, params: dict) -> None:
    """Write parameters ({"coarse": ..., "fine": ...}, tensors or arrays) as
    the reference's Lightning checkpoint, the inverse of `load_torch_ckpt`
    (torch's (out, in) weights). PE-MLP parameters take the MirrorNeRF
    layout (`nerf_<side>.` + `xyz_encoding_<i+1>.0`, `sigma`,
    `xyz_encoding_final`, `dir_encoding.0`, `rgb.0`, `normal_net.{0,1}`,
    `is_mirror_net.{0,2}`); hash-grid parameters the MirrorNeRFTcnn layout
    (`encoder.params` — the table flat, fp32, in this package's row layout,
    which the loader takes wholesale — `sigma_net.{i}`, `color_net.{i}`,
    `normal_net.{i}`, `is_mirror_net.{0,2}`)."""
    sd = {}

    def arr(v):
        return np.asarray(torch.as_tensor(v).detach().cpu(), np.float32)

    def lin(prefix, p):
        for key, name in (("w", "weight"), ("b", "bias")):
            if key in p:
                a = arr(p[key])
                sd[f"{prefix}.{name}"] = torch.from_numpy(
                    np.ascontiguousarray(a.T if key == "w" else a))

    for side, p in params.items():
        m = f"nerf_{side}"
        if "grid" in p:
            sd[f"{m}.encoder.params"] = torch.from_numpy(
                arr(p["grid"]).reshape(-1))
            for name, key in (("sigma_net", "sigma_net"),
                              ("color_net", "color_net"),
                              ("normal_net", "normal")):
                for j, lp in enumerate(p.get(key, ())):
                    lin(f"{m}.{name}.{j}", lp)
            for j, lp in zip((0, 2), p.get("is_mirror", ())):
                lin(f"{m}.is_mirror_net.{j}", lp)
            continue
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


def load_torch_ckpt(path: str, params_like: dict, field=None) -> dict:
    """A reference Lightning .ckpt (`nerf_coarse.*` / `nerf_fine.*`) -> the
    parameters, in the structure, dtype and device of `params_like`
    ({"coarse": ..., "fine": ...}). The checkpoint's own keys pick the
    layout: `encoder.params` is the hash-grid (MirrorNeRFTcnn) one, whose
    grid spec comes from `field` (an NGPField) or, without it, from the
    table's row count (the published default architecture only)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}
    is_ngp = any(k.endswith("encoder.params") for k in sd)
    data = {}
    for side, like in params_like.items():
        if not any(k.startswith(f"nerf_{side}.") for k in sd):
            raise KeyError(f"checkpoint {path} has no nerf_{side} module")
        if is_ngp:
            if not torch.is_tensor(like.get("grid")):
                raise ValueError(f"{path} holds the reference's hash-grid "
                                 "layout, which loads into --model_type "
                                 "nerf_tcnn only")
            f = field if hasattr(field, "grid_spec") else _ngp_field_like(
                like)
            tree = torch_ngp_to_params(sd, f"nerf_{side}", f, like["grid"])
        else:
            if "trunk" not in like:
                raise ValueError(f"{path} holds the reference's PE-MLP "
                                 "layout, which loads into --model_type "
                                 "nerf only")
            tree = torch_mirror_nerf_to_params(sd, f"nerf_{side}",
                                               depth=len(like["trunk"]))
        data.update({f"{side}/{p}": v for p, v in _leaves(tree)})
    return _load_leaves(data, path, params_like)


def load_params_any(path: str, params_like: dict, field=None) -> dict:
    """Load params from an npz checkpoint (a raw parameter tree, or a full
    train checkpoint whose parameter leaves live under "params/") or, for
    any other path, from a reference torch Lightning .ckpt (`field`, the
    model, gives a hash-grid checkpoint its grid spec)."""
    if not path.endswith(".npz"):
        return load_torch_ckpt(path, params_like, field)
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
