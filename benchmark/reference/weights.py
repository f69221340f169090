"""Seeded weights, drawn on the device in one call a tree.

A tree's leaves are linear layers given as (in, out): each becomes
{"w": (in, out)} (and "b": (out,) with `bias`), U(±1/√in) as torch's
`nn.Linear` draws them. All leaves come from one `torch.rand` of their
total size, cut in the tree's order (dict keys sorted, lists in order).
"""

from __future__ import annotations

import torch


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict / list tree, dict keys sorted;
    a path is the tuple of keys and indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def linear_tree(shapes, generator: torch.Generator, device,
                bias: bool) -> dict:
    shape_leaves = list(leaves(shapes))
    sizes = [i * o + (o if bias else 0) for _, (i, o) in shape_leaves]
    u = torch.rand(sum(sizes), generator=generator, device=device,
                   dtype=torch.float32)
    out = _skeleton(shapes)
    start = 0
    for (path, (i, o)), size in zip(shape_leaves, sizes):
        chunk = (u[start:start + size] * 2.0 - 1.0) * (1.0 / i ** 0.5)
        start += size
        layer = {"w": chunk[:i * o].reshape(i, o).clone()}
        if bias:
            layer["b"] = chunk[i * o:].clone()
        _set(out, path, layer)
    return out


def uniform(shape, bound: float, generator: torch.Generator,
            device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (2.0 * bound) - bound
