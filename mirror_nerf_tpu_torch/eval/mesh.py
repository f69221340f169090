"""Mesh extraction: iso-surface + denoise + vertex coloring + PLY.

Capability parity with reference `extract_color_mesh.py`: dense N³ σ-query of
the fine field over a user box, iso-surface extraction at `sigma_threshold`,
largest-connected-cluster denoising (reference uses open3d,
extract_color_mesh.py:218-228), and two vertex-coloring modes — rays along
vertex normals through the renderer, or multi-view reprojection with
NeRF-opacity occlusion weighting — written to PLY.

The iso-surface, the denoising, the normals and the PLY I/O stay numpy and
scipy on the host, copies of the JAX package's `eval/mesh.py`: vectorized
**marching tetrahedra** (6-tet cube split, edge-welded vertices,
inside→outside orientation), connected components by
scipy.sparse.csgraph. They give the same triangles from the same σ grid.

The σ grid query (`query_sigma_grid`) runs on the field's density route:
on a CUDA device the CP grid's train forward without tangents
(ops/fused_cp_train.py `density_fused`), the hash grid's ENCODE
(`hashgrid_encode`, inside `NGPField.density`) and the flagship's points
mode (ops/fused_mlp.py `fused_packed_eval`, σ-only); a trunk no kernel
takes runs the plain modules, as its training does. On the CPU every route
is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

# the classic 6-tetrahedra decomposition of a cube around diagonal 0-6;
# cube corners numbered by binary (x, y, z) offsets: 0=(0,0,0) .. 7=(0,1,1)
_CUBE_OFFSETS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64)
_TETS = [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
         (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)]


def _tet_case_table():
    """case id (4-bit inside mask) -> list of triangles, each a triple of
    tet-local edges (a, b) crossing the surface."""
    table = {}
    for case in range(16):
        ins = [i for i in range(4) if case >> i & 1]
        outs = [i for i in range(4) if not case >> i & 1]
        tris = []
        if len(ins) == 1:
            a = ins[0]
            e = [(a, o) for o in outs]
            tris = [(e[0], e[1], e[2])]
        elif len(ins) == 3:
            a = outs[0]
            e = [(a, i) for i in ins]
            tris = [(e[0], e[2], e[1])]
        elif len(ins) == 2:
            a, b = ins
            c, d = outs
            e = [(a, c), (a, d), (b, d), (b, c)]
            tris = [(e[0], e[1], e[2]), (e[0], e[2], e[3])]
        table[case] = tris
    return table


_CASES = _tet_case_table()


def marching_tetrahedra(values: np.ndarray, threshold: float):
    """Extract the iso-surface of a (Nx, Ny, Nz) scalar grid.

    Returns (vertices (V, 3) in grid-index units, triangles (T, 3) int).
    """
    nx, ny, nz = values.shape
    vals = values.reshape(-1)
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    corner_ids = np.stack(
        [idx[o[0]:nx - 1 + o[0], o[1]:ny - 1 + o[1], o[2]:nz - 1 + o[2]]
         .reshape(-1) for o in _CUBE_OFFSETS], axis=1)  # (M, 8)

    edge_keys = []
    for tet in _TETS:
        ids = corner_ids[:, tet]  # (M, 4) global corner ids
        v = vals[ids]  # (M, 4)
        inside = v > threshold
        case = (inside * np.array([1, 2, 4, 8])).sum(-1)  # (M,)
        for c in range(1, 15):
            sel = np.nonzero(case == c)[0]
            if len(sel) == 0:
                continue
            for tri in _CASES[c]:
                tri_edges = np.stack(
                    [np.stack([ids[sel, a], ids[sel, b]], axis=1)
                     for (a, b) in tri], axis=1)  # (S, 3, 2)
                edge_keys.append(tri_edges)
    if not edge_keys:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tri_edges = np.concatenate(edge_keys, axis=0)  # (T, 3, 2)
    lo = np.minimum(tri_edges[..., 0], tri_edges[..., 1])
    hi = np.maximum(tri_edges[..., 0], tri_edges[..., 1])
    keys = lo.astype(np.int64) * (nx * ny * nz) + hi  # (T, 3)
    uniq, inverse = np.unique(keys.reshape(-1), return_inverse=True)
    triangles = inverse.reshape(-1, 3)

    a = (uniq // (nx * ny * nz)).astype(np.int64)
    b = (uniq % (nx * ny * nz)).astype(np.int64)
    va, vb = vals[a], vals[b]
    t = np.clip((threshold - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12,
                                            vb - va), 0.0, 1.0)

    def coords(ids):
        return np.stack([ids // (ny * nz), (ids // nz) % ny, ids % nz],
                        axis=1).astype(np.float64)

    verts = coords(a) + t[:, None] * (coords(b) - coords(a))

    # orient triangles so normals point from inside (v > thr) outward
    p0, p1, p2 = (verts[triangles[:, i]] for i in range(3))
    n = np.cross(p1 - p0, p2 - p0)
    # "outward" reference: gradient of the field at the triangle centroid is
    # approximated by the inside corner direction — use the edge endpoint
    # with the larger value as the inside side
    inside_pt = np.where((va > vb)[:, None], coords(a), coords(b))
    centroid = (p0 + p1 + p2) / 3.0
    inside_dir = centroid - inside_pt[triangles[:, 0]]
    flip = (n * inside_dir).sum(-1) < 0
    tr = triangles.copy()
    tr[flip] = tr[flip][:, ::-1]
    return verts.astype(np.float32), tr


def largest_cluster(vertices: np.ndarray, triangles: np.ndarray):
    """Keep only the triangles of the largest vertex-connected component
    (reference uses open3d cluster_connected_triangles)."""
    if len(triangles) == 0:
        return vertices, triangles
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = len(vertices)
    rows = np.concatenate([triangles[:, 0], triangles[:, 1], triangles[:, 2]])
    cols = np.concatenate([triangles[:, 1], triangles[:, 2], triangles[:, 0]])
    g = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, labels = connected_components(g, directed=False)
    counts = np.bincount(labels)
    keep_label = np.argmax(counts)
    keep_tri = labels[triangles[:, 0]] == keep_label
    triangles = triangles[keep_tri]
    used = np.unique(triangles)
    remap = -np.ones(n, np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[triangles]


def vertex_normals(vertices: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    vn = np.zeros_like(vertices, np.float64)
    p0, p1, p2 = (vertices[triangles[:, i]] for i in range(3))
    fn = np.cross(p1 - p0, p2 - p0)
    for i in range(3):
        np.add.at(vn, triangles[:, i], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


def write_ply(path: str, vertices: np.ndarray, triangles: np.ndarray,
              colors: np.ndarray = None) -> None:
    """Binary little-endian PLY with optional uchar vertex colors."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.int32)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {len(v)}",
                  "property float x", "property float y", "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [f"element face {len(t)}",
                   "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            dt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec = np.empty(len(v), dt)
            rec["xyz"] = v
            rec["rgb"] = np.asarray(colors, np.uint8)
            rec.tofile(f)
        else:
            v.tofile(f)
        dt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
        rec = np.empty(len(t), dt)
        rec["n"] = 3
        rec["idx"] = t
        rec.tofile(f)


def read_ply(path: str):
    """Minimal reader for files written by write_ply (tests)."""
    with open(path, "rb") as f:
        n_v = n_f = 0
        has_color = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif "red" in line:
                has_color = True
            elif line == "end_header":
                break
        if has_color:
            dt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec = np.fromfile(f, dt, n_v)
            verts, colors = rec["xyz"], rec["rgb"]
        else:
            verts = np.fromfile(f, np.float32, n_v * 3).reshape(-1, 3)
            colors = None
        dt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
        tris = np.fromfile(f, dt, n_f)["idx"]
    return verts, tris, colors


def sigma_route(field, params: dict, device) -> tuple:
    """(name, fn): the σ query's route for `field` on `device`, fn mapping
    (B, 3) raw world points to (B,) raw σ. The route follows the device
    and the field's `supports_*` properties, as the renderer's does."""
    cuda = torch.device(device).type == "cuda"
    if getattr(field, "supports_fused_train", False):
        from ..ops.fused_cp_train import density_fused

        return ("CP train forward, density only" if cuda else
                "plain CP grid"), (
            lambda pts: density_fused(field, params, pts, need_dx=False)[0])
    if getattr(field, "supports_fused", False):
        from ..ops.fused_mlp import fused_packed_eval

        return ("PE-MLP points mode, σ-only" if cuda else "plain PE-MLP"), (
            lambda pts: fused_packed_eval(field, params, pts,
                                          sigma_only=True)[:, 0])
    name = "plain field modules"
    if cuda and hasattr(field, "grid_spec") and not hasattr(field, "cp_spec"):
        name = "ENCODE and the plain σ-net"
    return name, lambda pts: field.density(params, pts)[0]


@torch.no_grad()
def query_sigma_grid(field, params: dict, n_grid: int, x_range, y_range,
                     z_range, chunk: int = 64 * 1024,
                     device="cpu") -> np.ndarray:
    """Dense σ query over the box, (N, N, N), ReLU-clamped like the reference
    (extract_color_mesh.py:184-185). Grid layout matches the reference's
    meshgrid(x, y, z) (y-major first axis). The points go to `device` once;
    chunks of `chunk` points (the last padded with its last point, as in
    the JAX package) take `sigma_route`, their σ stay there until one copy
    back."""
    x = np.linspace(*x_range, n_grid)
    y = np.linspace(*y_range, n_grid)
    z = np.linspace(*z_range, n_grid)
    xyz = np.stack(np.meshgrid(x, y, z), -1).reshape(-1, 3).astype(np.float32)
    _, fn = sigma_route(field, params, device)
    pts_all = torch.from_numpy(xyz).to(device)
    n = len(xyz)
    out = torch.empty(n, dtype=torch.float32, device=pts_all.device)
    for i in range(0, n, chunk):
        pts = pts_all[i:i + chunk]
        pad = chunk - len(pts)
        if pad:
            pts = torch.cat([pts, pts[-1:].expand(pad, 3)])
        out[i:i + chunk - pad] = fn(pts)[:chunk - pad]
    sigma = out.cpu().numpy()
    return np.maximum(sigma, 0).reshape(n_grid, n_grid, n_grid)


def grid_to_world(vertices: np.ndarray, n_grid: int, x_range, y_range,
                  z_range) -> np.ndarray:
    """Map grid-index vertices to world coords with the reference's axis swap
    (extract_color_mesh.py:193-199: meshgrid makes axis0=y, axis1=x)."""
    v = vertices / n_grid
    out = np.empty_like(v)
    out[:, 0] = (x_range[1] - x_range[0]) * v[:, 1] + x_range[0]
    out[:, 1] = (y_range[1] - y_range[0]) * v[:, 0] + y_range[0]
    out[:, 2] = (z_range[1] - z_range[0]) * v[:, 2] + z_range[0]
    return out
