"""Port parity, mesh extraction (run.sh mode 2): the port's `eval/mesh.py`
and `python -m mirror_nerf_tpu_torch.mesh` against the JAX package's
`eval/mesh.py` and `extract_color_mesh.py`, on the same inputs and on
weights carried across through the npz layout.

The fields run at bound 2: x01 = (x + 2)·(1/4) is exact, so the port's
fp32-reciprocal x01 and JAX's division (or XLA's folded scale) agree bit
for bit, and the σ grids differ by the order of fp32 operations only
(ROADMAP.md §3 lists the x01 rounding as a known difference). Before the
CLIs' faces are held equal, the test checks that no σ of JAX's grid lies
within the σ tolerance of the threshold, where one corner's case could
move."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.eval import mesh as jmesh
from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxMLP
from mirror_nerf_tpu.models.ngp import NGPField as JaxNGP
from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxCP
from mirror_nerf_tpu_torch.eval import mesh
from mirror_nerf_tpu_torch.mesh import cli
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField
from mirror_nerf_tpu_torch.models.ngp import NGPField
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField
from mirror_nerf_tpu_torch.train.checkpoints import (params_from_numpy,
                                                     save_pytree)
from test_torch_port_apps import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# σ grids, fp32 against fp32: max|a − b| / max(1, max|a|)
SIGMA_TOL = 1e-5
BOX = ((-0.8, 0.6), (-0.7, 0.7), (-0.5, 0.9))
FIELDS = {
    "cp": (dict(bound=2.0, grid_levels=((16, 8), (32, 8))), JaxCP,
           TPUGridField),
    "hash": (dict(bound=2.0, n_levels=4, log2_hashmap_size=12), JaxNGP,
             NGPField),
    "flagship": (dict(N_emb_xyz=4, N_emb_dir=2, depth=3, width=32,
                      skips=(1,)), JaxMLP, MirrorNeRFField),
}


def _field_params(kind: str, seed: int = 0, scale_hashed: bool = True,
                  **kw):
    """JAX-initialized weights (numpy): the σ column ×40 with alternate
    units' signs flipped and shrunk to 0.9, so σ changes sign inside the
    box (a surface between empty and filled space, not a fog above the
    threshold everywhere); the hash table ×1e4, or its dense levels only
    for renders (`scale_hashed` False: a sample's position rounds
    differently in XLA's fused o + d·z, and at ×1e4 a hashed level's cell
    faces turn that into O(1) colour jumps; see
    tests/test_torch_port_ngp_slice.py)."""
    kw = dict(FIELDS[kind][0], **kw)
    jf = FIELDS[kind][1](**kw)
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(seed)))
    col = p["sigma"]["w"] if kind == "flagship" else p["sigma_net"][1]["w"]
    col[:, 0] = np.abs(col[:, 0]) * 40 * np.where(
        np.arange(len(col)) % 2, 1.0, -0.9)
    if kind == "hash":
        for lv in jf.grid_spec.levels():
            if scale_hashed or not lv.use_hash:
                p["grid"][lv.offset:lv.offset + lv.size] *= np.float32(1e4)
    return jf, FIELDS[kind][2](**kw), p


def _scaled_err(a, b) -> float:
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))


# ---- the host side on analytic grids ----


def _analytic(kind: str) -> np.ndarray:
    """A sphere, two spheres with specks of noise (largest_cluster's
    case), or an empty grid; (N, N, N) float values around 0."""
    n = 20
    lin = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    if kind == "empty":
        return np.zeros((n, n, n))
    vals = 0.55 - np.sqrt(x ** 2 + y ** 2 + z ** 2)
    if kind == "blobs":
        vals = np.maximum(vals, 0.25 - np.sqrt((x - 0.7) ** 2 + (y + 0.7) ** 2
                                               + z ** 2))
        vals[2, 17, 3] = vals[15, 2, 16] = 1.0
    return vals


@pytest.mark.parametrize("kind", ["sphere", "blobs", "empty"])
def test_host_mesh_steps_match_jax(kind):
    """marching_tetrahedra, largest_cluster, vertex_normals and
    grid_to_world: the same arrays, bit for bit."""
    vals = _analytic(kind)
    got, want = mesh.marching_tetrahedra(vals, 0.0), \
        jmesh.marching_tetrahedra(vals, 0.0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if kind == "empty":
        assert len(got[0]) == 0
        return
    world = mesh.grid_to_world(got[0], 20, *BOX)
    assert np.array_equal(world, jmesh.grid_to_world(want[0], 20, *BOX))
    cl, jcl = mesh.largest_cluster(world, got[1]), \
        jmesh.largest_cluster(world, want[1])
    for a, b in zip(cl, jcl):
        assert np.array_equal(a, b)
    if kind == "blobs":
        assert len(cl[1]) < len(got[1])  # the small sphere and specks go
    assert np.array_equal(mesh.vertex_normals(*cl),
                          jmesh.vertex_normals(*jcl))


@pytest.mark.parametrize("colors", [False, True])
def test_ply_files_match_jax_byte_for_byte(tmp_path, colors):
    verts, tris = mesh.marching_tetrahedra(_analytic("sphere"), 0.0)
    c = (np.arange(len(verts) * 3) % 256).astype(np.uint8).reshape(-1, 3) \
        if colors else None
    mesh.write_ply(str(tmp_path / "a.ply"), verts, tris, c)
    jmesh.write_ply(str(tmp_path / "b.ply"), verts, tris, c)
    raw = (tmp_path / "a.ply").read_bytes()
    assert raw == (tmp_path / "b.ply").read_bytes()
    for a, b in zip(mesh.read_ply(str(tmp_path / "a.ply")),
                    jmesh.read_ply(str(tmp_path / "a.ply"))):
        assert (a is None and b is None) or np.array_equal(a, b)


# ---- the σ query ----


@pytest.mark.parametrize("kind", list(FIELDS))
def test_query_sigma_grid_matches_jax(kind):
    """`query_sigma_grid` on the CPU (the plain version of each route)
    against the JAX package's jitted `field.density`, a 20³ box in 7
    chunks (the last padded)."""
    jf, tf, p = _field_params(kind)
    want = jmesh.query_sigma_grid(jf, p, 20, *BOX, chunk=1200)
    got = mesh.query_sigma_grid(tf, params_from_numpy(p), 20, *BOX,
                                chunk=1200)
    assert got.shape == (20, 20, 20) and got.dtype == np.float32
    assert 0.1 < (want > 0).mean() < 0.99 and want.max() > 1
    assert _scaled_err(want, got) <= SIGMA_TOL, kind


def test_routes_follow_device_and_field():
    """The σ route and the color passes' fusion come from the device and
    the field's `supports_*`: the kernels on CUDA, plain on the CPU."""
    cases = {
        "cp": (TPUGridField(), "CP train forward, density only", True),
        "hash": (NGPField(), "ENCODE and the plain σ-net", True),
        "hash_other_nets": (NGPField(hidden_dim=32),
                            "ENCODE and the plain σ-net", False),
        "flagship": (MirrorNeRFField(), "PE-MLP points mode, σ-only", True),
        "flagship_narrow": (FIELDS["flagship"][2](**FIELDS["flagship"][0]),
                            "plain field modules", False),
        "cp_other_nets": (TPUGridField(hidden_dim=32), "plain field modules",
                          False),
    }
    for name, (field, route, fused) in cases.items():
        assert mesh.sigma_route(field, {}, "cuda")[0] == route, name
        assert cli.fused_colors(field, "cuda") is fused, name
        assert not cli.fused_colors(field, "cpu"), name
        assert mesh.sigma_route(field, {}, "cpu")[0].startswith("plain"), \
            name


def test_fused_color_pass_differs_by_fp32_order_only():
    """On the card the color passes take the fused composite, where the
    JAX package renders unfused. On the CPU the fused route's plain
    version against the plain renderer: the vertex-normal pass's colors
    and the multi-view pass's opacity (ROADMAP.md §3 records this)."""
    from dataclasses import replace

    from mirror_nerf_tpu_torch.config import Config
    from mirror_nerf_tpu_torch.train.loop import render_image_chunked

    _, tf, p = _field_params("cp")
    pt = params_from_numpy({"coarse": p, "fine": p})
    rng = np.random.default_rng(4)
    d = rng.normal(size=(300, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = cli.vertex_normal_rays(
        rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32),
        d.astype(np.float32), 0.05, 2.0, 1.0)
    cfg = Config(N_samples=8, N_importance=8, chunk=128)
    errs = {}
    for n_imp, key in ((8, "rgb_fine"), (0, "opacity_coarse")):
        ts = cli.color_settings(cfg, tf, "cpu", n_imp, n_imp > 0,
                                "fine" if n_imp else "none")
        assert not ts.render.fused_field
        fused = replace(ts, render=replace(ts.render, fused_field=True))
        a, b = (render_image_chunked(tf, pt, rays, None, t, 128, "cpu",
                                     keys=(key,))[key] for t in (ts, fused))
        errs[key] = float(np.abs(a - b).max())
    print(f"fused against plain color passes on the CPU: {errs}")
    assert max(errs.values()) <= 1e-5, errs


# ---- the CLIs end to end ----


# run.sh mode 2's model and data flags per model type, at a tiny size
MODELS = {
    "nerf_tcnn": ("hash", dict(log2_hashmap_size=15, n_levels=16,
                               scale_hashed=False),
                  ["--log2_hashmap_size", "15"]),
    "nerf_tpu": ("cp", {}, ["--grid_levels", "16:8,32:8"]),
}


# the mesh boxes in front of every train camera of the generated scene in
# each layout: the multi-view colors weigh a view by 0.1 / depth (the
# reference's rule), negative behind a camera, where the weights can sum to
# ~0 and a 1-ulp vertex difference moves a color by several levels. The
# ARKit loader centres the poses on their average, so its cameras sit
# around the origin looking down -z.
BOXES = {"blender": BOX,
         "real_arkit": (BOX[0], BOX[1], (BOX[2][0] - 2.0, BOX[2][1] - 2.0))}


def _threshold(sig: np.ndarray) -> tuple:
    """The middle of the widest gap between neighbouring positive σ values
    among their middle three fifths, its distance to the nearest σ, and
    the σ tolerance in σ units (as _scaled_err applies it)."""
    pos = np.sort(sig[sig > 0])
    mid = pos[int(0.2 * len(pos)):int(0.8 * len(pos))]
    k = int(np.argmax(np.diff(mid)))
    thr = float(0.5 * (mid[k] + mid[k + 1]))
    return (thr, float(np.abs(sig - thr).min()),
            SIGMA_TOL * max(1.0, float(pos[-1])))


@pytest.fixture(scope="module", params=list(MODELS))
def mesh_scene(request, tmp_path_factory):
    """A generated 16×12 scene (2 train views) in the blender and the ARKit
    layout, the model's weights in an npz, and per layout a threshold from
    JAX's σ grid over its box (`_threshold`)."""
    from mirror_nerf_tpu_torch.data.synthetic import (generate_scene,
                                                      generate_scene_arkit)

    model = request.param
    kind, kw, _ = MODELS[model]
    root = tmp_path_factory.mktemp(f"mesh_cli_{model}")
    generate_scene(str(root / "blender"), n_train=2, n_val=1, n_test=1,
                   img_wh=(16, 12))
    generate_scene_arkit(str(root / "real_arkit"), n_train=2, n_val=1,
                         n_test=1, img_wh=(16, 12))
    jf, tf, p = _field_params(kind, **kw)
    save_pytree(str(root / "w.npz"), {"coarse": p, "fine": p})
    thresholds = {d: _threshold(jmesh.query_sigma_grid(jf, p, 24, *box))
                  for d, box in BOXES.items()}
    return model, root, thresholds, tf, p


@pytest.mark.parametrize("dataset", list(BOXES))
@pytest.mark.parametrize("mode", ["vertex_normal", "multi_view"])
def test_mesh_cli_matches_extract_color_mesh(mesh_scene, mode, dataset,
                                             monkeypatch):
    """Both CLIs with run.sh mode 2's flags and --color_mesh on the same
    checkpoint: all three PLYs with the same vertex and face counts and
    faces, colors within 1 of 255. The σ grids agree to ~1e-6 of their
    scale (test_query_sigma_grid_matches_jax); a vertex on an edge whose σ
    step is small moves by that over the step, up to 2–3e-4 grid units on
    these seeded fields (ROADMAP.md §3), so the vertices are held to JAX's
    host steps on the port's own σ grid, bit for bit, and their distance
    to JAX's vertices is printed."""
    model, root, thresholds, tf, p = mesh_scene
    thr, margin, tol = thresholds[dataset]
    bx = BOXES[dataset]
    sys.path.insert(0, REPO)
    import extract_color_mesh as jcli

    box = ["--x_range", *map(str, bx[0]), "--y_range", *map(str, bx[1]),
           "--z_range", *map(str, bx[2])]
    flags = ["--dataset_name", dataset, "--root_dir", str(root / dataset),
             "--img_wh", "16", "12", "--near", "0.05", "--far", "8",
             "--model_type", model, "--predict_normal",
             "--predict_mirror_mask", "--trace_secondary_rays", "--bound",
             "2", "--N_samples", "8", "--N_importance", "8", "--chunk",
             "4096", "--ckpt_path", str(root / "w.npz"), "--exp_name", "m",
             "--N_grid", "24", *box, "--sigma_threshold", str(thr),
             "--color_mesh", *MODELS[model][2]] + (
                 ["--use_vertex_normal"] if mode == "vertex_normal" else [])
    # no σ within the σ tolerance of the threshold: the cases are the same
    assert margin > tol, (margin, tol)
    out, run = {}, None
    for who in ("jax", "port"):
        monkeypatch.chdir(root)
        os.makedirs(f"{who}_{dataset}", exist_ok=True)
        monkeypatch.chdir(root / f"{who}_{dataset}")
        if who == "jax":
            d = jcli.main(flags)
        else:
            with one_thread():
                run = cli.extract(*cli.get_opt(flags + ["--device", "cpu"]))
            d = run["dir"]
        out[who] = {f: mesh.read_ply(os.path.join(d, f))
                    for f in ("m.ply", "noise_free.ply", "m_colored.ply")}
    assert run["routes"]["colors_fused"] is False
    assert run["routes"]["sigma"].startswith("plain")
    assert run["faces"] == len(out["port"]["noise_free.ply"][1])
    if mode == "multi_view":
        # every vertex in front of every train camera: positive weights
        from mirror_nerf_tpu_torch.config import Config
        from mirror_nerf_tpu_torch.data import get_dataset

        ds = get_dataset(dataset)(str(root / dataset), "train", (16, 12),
                                  Config(img_wh=(16, 12), near=0.05, far=8.0))
        v = out["jax"]["m_colored.ply"][0]
        for pose in ds.poses:
            w2c = np.linalg.inv(np.concatenate(
                [np.asarray(pose)[:3, :4], [[0, 0, 0, 1]]], 0))
            assert ((w2c[2, :3] @ v.T + w2c[2, 3]) < 0).all()
    # world units to grid units, per world axis
    scale = 24 / np.array([hi - lo for lo, hi in bx])
    sig = mesh.query_sigma_grid(tf, params_from_numpy(p), 24, *bx)
    v, t = jmesh.marching_tetrahedra(sig, thr)
    v = jmesh.grid_to_world(v, 24, *bx)
    want = {"m.ply": (v, t)}
    want["noise_free.ply"] = want["m_colored.ply"] = \
        jmesh.largest_cluster(v, t)
    errs = {}
    for f, (jv, jt, jc) in out["jax"].items():
        v, t, c = out["port"][f]
        assert len(v) > 100 and v.shape == jv.shape, f
        assert np.array_equal(t, jt), f
        errs[f] = float((np.abs(v - jv) * scale).max())
        assert np.array_equal(v, want[f][0]), f
        assert (c is None) == (jc is None), f
        if c is not None:
            diff = np.abs(c.astype(int) - jc.astype(int))
            assert diff.max() <= 1, (f, diff.max())
            assert c.std() > 0, f
    print(f"{model} {mode} {dataset}: vertices against JAX's, grid units: "
          f"{errs}")
