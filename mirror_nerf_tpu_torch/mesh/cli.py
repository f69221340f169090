"""The port's colored mesh extraction: `python -m mirror_nerf_tpu_torch.mesh`.

The same flags, defaults and outputs as the JAX package's
`extract_color_mesh.py` (run.sh mode 2), plus `--device cuda|cpu` (default
`cuda`): a dense `--N_grid`³ σ grid of the fine field over the box
(eval/mesh.py `query_sigma_grid`), the iso-surface at `--sigma_threshold`
by marching tetrahedra, the largest connected cluster, and with
`--color_mesh` vertex colors, by rays along the vertex normals
(`--use_vertex_normal`) or by reprojecting every train image with the
coarse pass's opacity as the occlusion vote. It writes `{exp_name}.ply`,
`noise_free.ply` and `{exp_name}_colored.ply` under
`results/{dataset}/{exp_name}/mesh/`.

Routes: the σ query takes the field's density kernel on the card
(`eval.mesh.sigma_route`); both color passes take the field's fused
composite where it has one (the CP grid, the flagship, a hash spec the fused
NGP composite takes), the plain renderer otherwise and on the CPU. The
device and the field's `supports_*` properties choose; no flag does. The
JAX package renders the color passes unfused: the fused composites differ
from it by the order of fp32 operations only. The run logs its routes and,
per step, its wall time; `extract` returns them.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def get_opt(argv=None):
    from ..config import add_common_args, config_from_namespace

    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--N_grid", type=int, default=256)
    parser.add_argument("--x_range", nargs="+", type=float, default=[-1.0, 1.0])
    parser.add_argument("--y_range", nargs="+", type=float, default=[-1.0, 1.0])
    parser.add_argument("--z_range", nargs="+", type=float, default=[-1.0, 1.0])
    parser.add_argument("--sigma_threshold", type=float, default=20.0)
    parser.add_argument("--occ_threshold", type=float, default=0.2)
    parser.add_argument("--use_vertex_normal", action="store_true",
                        default=False)
    parser.add_argument("--near_t", type=float, default=1.0)
    parser.add_argument("--color_mesh", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda")
    ns = parser.parse_args(argv)
    return config_from_namespace(ns), ns


def fused_colors(field, device) -> bool:
    """Whether the color passes take the field's fused composite: on a CUDA
    device, for a field that has one."""
    import torch

    return torch.device(device).type == "cuda" and any(
        getattr(field, p, False) for p in ("supports_fused_cp",
                                           "supports_fused",
                                           "supports_fused_hash"))


def color_settings(cfg, field, device, n_importance: int, test_time: bool,
                   fine_pass: str):
    """The color passes' trace: one noise-free level, no secondary rays."""
    from ..render.renderer import RenderSettings
    from ..render.tracer import TraceSettings

    rs = RenderSettings(sigma_activation=cfg.sigma_activation,
                        N_samples=cfg.N_samples, N_importance=n_importance,
                        perturb=0.0, noise_std=0.0, test_time=test_time,
                        compute_normal=False, fine_pass=fine_pass,
                        fused_field=fused_colors(field, device))
    return TraceSettings(render=rs, trace_secondary_rays=False,
                         max_recursive_level=0, is_eval=False)


def vertex_normal_rays(verts, normals, near: float, far: float,
                       near_t: float) -> np.ndarray:
    """Rays along the vertex normals, from near·near_t behind each vertex
    (reference :247-267)."""
    from ..core.rays import make_ray_buffer

    rays_o = verts - normals * near * near_t
    return make_ray_buffer(rays_o.astype(np.float32),
                           normals.astype(np.float32), near, far)


def vertex_normal_rgb(cfg, field, params: dict, rays: np.ndarray,
                      device) -> np.ndarray:
    """The vertex-normal pass's colors in [0, 1] (fine if rendered)."""
    from ..train.loop import render_image_chunked

    ts = color_settings(cfg, field, device, cfg.N_importance, True,
                        "fine" if "fine" in params else "none")
    res = render_image_chunked(field, params, rays, None, ts, cfg.chunk,
                               device, None, keys=("rgb_fine", "rgb_coarse"))
    typ = "fine" if "rgb_fine" in res else "coarse"
    return np.clip(res[f"rgb_{typ}"], 0, 1)


def multiview_colors(cfg, args, field, fine_params: dict, dataset, verts,
                     device) -> np.ndarray:
    """Every train image reprojected onto the vertices (cv2.remap), weighted
    by 0.1 / depth plus a vote where the coarse pass of the fine field from
    that camera to the vertex stays below `--occ_threshold` opacity (NaN
    taken as 1) (reference :269-355)."""
    import cv2
    from PIL import Image

    from ..train.loop import render_image_chunked

    W, H = cfg.img_wh
    n_v = len(verts)
    K = np.array([[dataset.focal, 0, W / 2], [0, dataset.focal, H / 2],
                  [0, 0, 1]], np.float32)
    verts_homo = np.concatenate([verts, np.ones((n_v, 1))], 1)
    non_occluded_sum = np.zeros((n_v, 1))
    v_color_sum = np.zeros((n_v, 3))
    ts = color_settings(cfg, field, device, 0, False, "none")
    fine_only = {"coarse": fine_params}

    poses = dataset.poses
    image_paths = getattr(dataset, "image_paths", None)
    n_views = len(poses)
    for idx in range(n_views):
        if image_paths is not None:
            image = Image.open(image_paths[idx]).convert("RGB")
            image = np.array(image.resize((W, H), Image.LANCZOS))
        else:
            image = (dataset.get_image(idx)["rgbs"].reshape(H, W, 3)
                     * 255).astype(np.uint8)
        pose = np.asarray(poses[idx])[:3, :4] if poses[idx].shape[0] > 3 \
            else np.asarray(poses[idx])
        P_c2w = np.concatenate([pose, [[0, 0, 0, 1]]], 0)
        P_w2c = np.linalg.inv(P_c2w)[:3]
        vc = P_w2c @ verts_homo.T
        vc[1:] *= -1  # "right up back" -> "right down forward"
        vi = (K @ vc).T
        depth = vi[:, -1:] + 1e-5
        vi = (vi[:, :2] / depth).astype(np.float32)
        vi[:, 0] = np.clip(vi[:, 0], 0, W - 1)
        vi[:, 1] = np.clip(vi[:, 1], 0, H - 1)
        colors = []
        for i in range(0, n_v, 30000):
            colors.append(cv2.remap(image, vi[i:i + 30000, 0],
                                    vi[i:i + 30000, 1],
                                    interpolation=cv2.INTER_LINEAR)[:, 0])
        colors = np.vstack(colors)

        rays_o = np.broadcast_to(pose[:, 3], (n_v, 3)).astype(np.float32)
        rays_d = verts - rays_o
        rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays = np.concatenate(
            [rays_o, rays_d.astype(np.float32),
             np.full((n_v, 1), cfg.near, np.float32),
             depth.astype(np.float32)], 1)
        res = render_image_chunked(field, fine_only, rays, None, ts,
                                   cfg.chunk, device, None,
                                   keys=("opacity_coarse",))
        opacity = np.nan_to_num(res["opacity_coarse"], nan=1.0)[:, None]
        non_occluded = np.ones_like(non_occluded_sum) * 0.1 / depth
        non_occluded += opacity < args.occ_threshold
        v_color_sum += colors * non_occluded
        non_occluded_sum += non_occluded
        print(f"fused view {idx + 1}/{n_views}")
    return (v_color_sum / non_occluded_sum).astype(np.uint8)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> str:
    """Run with `argv`; returns the mesh directory."""
    return extract(*get_opt(argv))["dir"]


def extract(cfg, args) -> dict:
    """The mesh run for parsed flags. Returns the mesh directory (`dir`),
    the routes, the steps' seconds, the σ query's points/s, the color
    passes' rays/s and the vertex and face counts."""
    import torch

    from ..data import get_dataset
    from ..eval.cli import init_params
    from ..eval.mesh import (grid_to_world, largest_cluster,
                             marching_tetrahedra, query_sigma_grid,
                             sigma_route, vertex_normals, write_ply)
    from ..models.fields import make_field

    device = torch.device(args.device)
    split = "test" if cfg.dataset_name == "llff" else "train"
    dataset = get_dataset(cfg.dataset_name)(cfg.root_dir, split, cfg.img_wh,
                                            cfg)
    field = make_field(cfg)
    params = init_params(field, cfg, device)
    fine_params = params.get("fine", params["coarse"])

    dir_name = f"results/{cfg.dataset_name}/{cfg.exp_name}/mesh"
    os.makedirs(dir_name, exist_ok=True)
    print(f"[info] Results saved to dir {dir_name}.")
    route = sigma_route(field, fine_params, device)[0]
    fused = fused_colors(field, device)
    run = {"dir": dir_name, "routes": {"sigma": route,
                                       "colors_fused": fused}}
    print(f"[route] σ grid: {route}; color passes: "
          + ("the field's fused composite" if fused else "the plain renderer")
          + f" ({device})")

    print("Predicting occupancy ...")
    _sync(device)
    t0 = time.perf_counter()
    sigma = query_sigma_grid(field, fine_params, args.N_grid,
                             tuple(args.x_range), tuple(args.y_range),
                             tuple(args.z_range), chunk=cfg.chunk,
                             device=device)
    t_sigma = time.perf_counter() - t0
    run.update(sigma_s=t_sigma, points_per_s=sigma.size / t_sigma,
                    sigma_max=float(sigma.max()))
    print(f"[time] σ query: {t_sigma:.3f} s, {sigma.size} points, "
          f"{sigma.size / t_sigma:.4g} points/s")

    print("Extracting mesh ...")
    t0 = time.perf_counter()
    verts_grid, tris = marching_tetrahedra(sigma, args.sigma_threshold)
    run["marching_s"] = time.perf_counter() - t0
    if len(verts_grid) == 0:
        print(f"[warning] no iso-surface at sigma_threshold="
              f"{args.sigma_threshold} (sigma range "
              f"[{sigma.min():.2f}, {sigma.max():.2f}]); nothing to write.")
        return run
    verts = grid_to_world(verts_grid, args.N_grid, tuple(args.x_range),
                          tuple(args.y_range), tuple(args.z_range))
    t0 = time.perf_counter()
    write_ply(os.path.join(dir_name, f"{cfg.exp_name}.ply"), verts, tris)
    t_ply = time.perf_counter() - t0

    print("Removing noise ...")
    t0 = time.perf_counter()
    verts, tris = largest_cluster(verts, tris)
    run["cluster_s"] = time.perf_counter() - t0
    print(f"Mesh has {len(verts) / 1e6:.2f} M vertices and "
          f"{len(tris) / 1e6:.2f} M faces.")
    t0 = time.perf_counter()
    write_ply(os.path.join(dir_name, "noise_free.ply"), verts, tris)
    run.update(ply_s=t_ply + time.perf_counter() - t0,
                    vertices=len(verts), faces=len(tris))
    print(f"[time] marching tetrahedra {run['marching_s']:.3f} s, "
          f"largest cluster {run['cluster_s']:.3f} s, PLY "
          f"{run['ply_s']:.3f} s")

    if not args.color_mesh:
        return run

    _sync(device)
    t0 = time.perf_counter()
    if args.use_vertex_normal:
        normals = vertex_normals(verts, tris)
        rays = vertex_normal_rays(verts, normals,
                                  getattr(dataset, "near", cfg.near),
                                  getattr(dataset, "far", cfg.far),
                                  args.near_t)
        v_colors = (vertex_normal_rgb(cfg, field, params, rays, device)
                    * 255).astype(np.uint8)
        n_rays = len(rays)
    else:
        v_colors = multiview_colors(cfg, args, field, fine_params, dataset,
                                    verts, device)
        n_rays = len(verts) * len(dataset.poses)
    t_color = time.perf_counter() - t0
    run.update(color_s=t_color, color_rays=n_rays,
                    color_rays_per_s=n_rays / t_color)
    mode = "vertex normals" if args.use_vertex_normal else "multi-view"
    print(f"[time] colors ({mode}): {t_color:.3f} s, {n_rays} rays, "
          f"{n_rays / t_color:.4g} rays/s")

    write_ply(os.path.join(dir_name, f"{cfg.exp_name}_colored.ply"), verts,
              tris, v_colors)
    print("Done!")
    return run
