"""What bounds the CP-grid train kernels: copies of `csrc/fused_cp_train.cu`
with one piece changed, built beside the real one and timed in turns on the
same inputs, in one process on the card.

    python -m mirror_nerf_tpu_torch.tools.exp_train_diag [--tree DIR]
        [--variants ...] [--rounds 3]

`--tree` names another checkout of the repository (`git archive <commit> |
tar -x -C build/other`): its port is imported under another name (as
`tools/exp_launch_ab.py` does) and its kernel source patched and timed
through its own wrapper. The variants are those of the tree's design, told
apart by the source (`DESIGNS`):

  the first design (one thread a sample, fp32 CUDA cores, atomics):
    no_table_atomics  the table grads' scalar atomicAdds (six a rank a
                      sample) replaced by a store that never runs;
    no_dense_atomics  the dense weight grads' warp transpose-sums and their
                      atomicAdds replaced by a plain sum of the 32 entries
                      and a store that never runs;
    vec_loads         the table rows read four ranks at a time by 16-B
                      loads in place of one scalar load a rank (the values
                      are the real kernel's).
  the tensor-core design (3×TF32 mma.sync, per-block sums):
    one_tf32          one TF32 product (a_hi·b_hi) in place of three;
    no_table_red      the table grads' vector reductions replaced by a
                      store that never runs;
    no_dense_sums     a tile's dense-grad partial products not added into
                      the warp's running sums (neither loaded nor stored;
                      the block's final sum and atomics stay);
    no_table_loads    the table rows replaced by constants (timed only);
    run_sums          the tile's table-grad rows summed along the runs of
                      its samples by 12 lanes in turn (a table and 4-rank
                      quad each, a two-row window in registers), in place
                      of a lane summing only its own two samples.

The variants that change what the kernel computes are timed only; the
others are held to the plain version (forward ≤ 1e-4 scaled above 1, every
gradient leaf ≤ 1e-3 relative).

Inputs (`cases`, which chip_smoke.py phase 4 uses too), the default CP
field (levels 64:64, 256:64, 512:64, bound 6, seeded weights with the σ
column |w|·5), cotangents on σ, geo and ∇σ:
  uniform  T = 131072 points, each axis uniform over ±1.0068·bound;
  rays128  1024 rays of the train camera (64×64, six poses of the
           procedural ring, a seeded batch) × 128 fine samples, a ray's
           samples consecutive, as the renderer hands them to the kernels
           (coarse 64 stratified and jittered, 64 more from their weights);
  rays64   the same rays' 64 coarse samples.
Times: the tangent forward and the tangent backward with d_x, each its own
launch through the tree's wrapper (`_forward`, `_backward`, the zeroed
grads of the backward included), 10 calls a round, best of `--rounds` in
turns. Prints ms per call, ptxas' registers and spills and each build's
difference from the plain version. The builds go to `build/kernels/
diag_train/` (git-ignored). A patch that does not match the source exactly
as often as it says stops the tool with an error naming it.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import fused_cp_train as fct
from .exp_cp_diag import _ms

FWD, BWD = "mnerf_cp_train_fwd", "mnerf_cp_train_bwd"
FWD_ATOL, GRAD_RTOL = 1e-4, 1e-3  # chip_smoke.py's bars

# ---- the first design (one thread a sample, fp32 CUDA cores, atomics) ----
_SINK = ("template <bool TANGENTS, bool NEED_DX>\n"
         "__global__ void __launch_bounds__(BLOCK) bwd_kernel(",
         "__device__ __forceinline__ void sink(const float (&v)[32], "
         "float* p) {\n  float s = 0.f;\n#pragma unroll\n"
         "  for (int k = 0; k < 32; ++k) s += v[k];\n"
         "  if (s == 1234.5f) *p = s;\n}\n\n"
         "template <bool TANGENTS, bool NEED_DX>\n"
         "__global__ void __launch_bounds__(BLOCK) bwd_kernel(", 1)
_LANE4 = ("template <bool TANGENTS>\n__global__",
          "__device__ __forceinline__ float lane4(float4 q, int j) {\n"
          "  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;\n}\n\n"
          "template <bool TANGENTS>\n__global__", 1)
_CHUNK = ("#pragma unroll 1\n    for (int r4 = 0; r4 < R; r4 += 4) {\n"
          "      float4 q0[3], q1[3];\n#pragma unroll\n"
          "      for (int a = 0; a < 3; ++a) {\n"
          "        q0[a] = __ldg(reinterpret_cast<const float4*>"
          "(ax[a].lo + r4));\n"
          "        q1[a] = __ldg(reinterpret_cast<const float4*>"
          "(ax[a].lo + R + r4));\n      }\n")
_LOADS = ("        const float t0 = lane4(q0[a], r - r4);\n"
          "        const float t1 = lane4(q1[a], r - r4);\n")
FIRST_DESIGN = {
    "no_table_atomics": [
        ("          atomicAdd(row, c0);\n          atomicAdd(row + R, c1);",
         "          if (c0 == 1234.5f) row[0] = c1;", 1)],
    "no_dense_atomics": [
        _SINK,
        ("      atomicAdd(d_s1 + lane * H + oo, warp_transpose_sum(vals, "
         "lane));", "      sink(vals, d_s1 + lane);", 1),
        ("    atomicAdd(d_s2 + o * NSG + lane, warp_transpose_sum(vals, "
         "lane));", "    sink(vals, d_s2 + lane);", 1),
        ("      atomicAdd(d_fold + (roff + r) * F + lane,\n"
         "                warp_transpose_sum(vals, lane));",
         "      sink(vals, d_fold + lane);", 1)],
    "vec_loads": [
        _LANE4,
        ("    for (int r = 0; r < R; ++r) {\n      float f[3], g[3];\n"
         "#pragma unroll\n      for (int a = 0; a < 3; ++a) {\n"
         "        const float t0 = __ldg(ax[a].lo + r);\n"
         "        const float t1 = __ldg(ax[a].lo + R + r);\n",
         _CHUNK + "#pragma unroll\n    for (int r = r4; r < r4 + 4; ++r) {\n"
         "      float f[3], g[3];\n#pragma unroll\n"
         "      for (int a = 0; a < 3; ++a) {\n" + _LOADS, 2),
        ("#pragma unroll 1\n    for (int r = 0; r < R; ++r) {\n"
         "      float f[3], g[3] = {0.f, 0.f, 0.f};\n#pragma unroll\n"
         "      for (int a = 0; a < 3; ++a) {\n"
         "        const float t0 = __ldg(ax[a].lo + r);\n"
         "        const float t1 = __ldg(ax[a].lo + R + r);\n",
         _CHUNK + "#pragma unroll 1\n    for (int r = r4; r < r4 + 4; ++r) {"
         "\n      float f[3], g[3] = {0.f, 0.f, 0.f};\n#pragma unroll\n"
         "      for (int a = 0; a < 3; ++a) {\n" + _LOADS, 1),
        ("    roff += R;", "    }\n    roff += R;", 3)],
}
# ---- the tensor-core design (3×TF32 mma.sync, per-warp dense sums) ------
TC_DESIGN = {
    "one_tf32": [("  mma_tf32(c, a.lo, b.hi);\n  mma_tf32(c, a.hi, b.lo);\n"
                  "  mma_tf32(c, a.hi, b.hi);", "  mma_tf32(c, a.hi, b.hi);",
                  1)],
    "no_table_red": [("  atomicAdd(reinterpret_cast<float4*>(p), v);",
                      "  if (v.x == 1234.5f) *p = v.y + v.z + v.w;", 1)],
    "no_dense_sums": [
        ("  *part_at(buf, frag, lane) =\n      make_float4(c[0] + old.x, "
         "c[1] + old.y, c[2] + old.z, c[3] + old.w);",
         "  if (c[0] == 1234.5f) buf[lane] = c[1] + c[2] + c[3] + old.x;", 1),
        ("  return first ? make_float4(0.f, 0.f, 0.f, 0.f) : "
         "*part_at(buf, frag, lane);",
         "  return make_float4(0.f, 0.f, 0.f, (float)(first + frag));", 1)],
    "no_table_loads": [
        ("    const float4 a0 = __ldg(reinterpret_cast<const float4*>(lo));",
         "    const float4 a0 = make_float4(1.f, 1.f, 0.5f, "
         "__int_as_float(off));", 1),
        ("    const float4 a1 = __ldg(reinterpret_cast<const float4*>"
         "(lo + R));",
         "    const float4 a1 = make_float4(1.f, 0.5f, 1.f, "
         "__int_as_float(ax[k].xi));", 1)],
}
# run_sums: the tile's table-grad rows summed along the runs of its
# samples by 12 lanes in turn (a table and 4-rank quad each, a two-row
# window in registers), in place of a lane summing its own two samples
_RUN_WALK = """__device__ __forceinline__ void scatter_run(float* tab, int R,
    const int* xi, const float* c0, const float* c1, int ns) {
  int row = xi[0];
  float4 acc0 = *reinterpret_cast<const float4*>(c0);
  float4 acc1 = *reinterpret_cast<const float4*>(c1);
  for (int s = 1; s < ns; ++s) {
    const int x = xi[3 * s];
    const float4 v0 = *reinterpret_cast<const float4*>(c0 + 16 * s);
    const float4 v1 = *reinterpret_cast<const float4*>(c1 + 16 * s);
    if (x == row) {
      acc0 = f4add(acc0, v0);
      acc1 = f4add(acc1, v1);
    } else if (x == row + 1) {
      red4(tab + (long long)row * R, acc0);
      acc0 = f4add(acc1, v0);
      acc1 = v1;
    } else if (x == row - 1) {
      red4(tab + (long long)(row + 1) * R, acc1);
      acc1 = f4add(acc0, v1);
      acc0 = v0;
    } else {
      red4(tab + (long long)row * R, acc0);
      red4(tab + (long long)(row + 1) * R, acc1);
      acc0 = v0;
      acc1 = v1;
    }
    row = x;
  }
  red4(tab + (long long)row * R, acc0);
  red4(tab + (long long)(row + 1) * R, acc1);
}

"""
_BWD_HEAD = ("template <bool TANGENTS, bool NEED_DX>\n"
             "__global__ void __launch_bounds__(BLOCK, 1) bwd_kernel(")
TC_DESIGN["run_sums"] = [
    (_BWD_HEAD, _RUN_WALK + _BWD_HEAD, 1),
    ("""        if (act[0]) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            scatter_pair(a.gt.tab[l][k], R, 16 * pl + 4 * t, ax[0][k].xi,
                         ax[1][k].xi, act[1], quad4(c0v[0][k]),
                         quad4(c1v[0][k]), quad4(c0v[1][k]),
                         quad4(c1v[1][k]));
        }
        // d_fold rows 16p … 16p + 15: the group's p (and tpn) as Aᵀ with
        // the samples as K, ē (and v) as B
        __syncwarp();  // the previous group's reads are done
""", """        __syncwarp();
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int at = 320 + (2 * g + q) * 16 + 4 * t + 256 * k;
            *reinterpret_cast<float4*>(scr + SZ + at) = quad4(c0v[q][k]);
            *reinterpret_cast<float4*>(scr + SM + at) = quad4(c1v[q][k]);
            if (t == 0)
              reinterpret_cast<int*>(scr + SG)[(2 * g + q) * 3 + k] =
                  ax[q][k].xi;
          }
        __syncwarp();
        if (lane < 12) {
          const int k = lane >> 2, quad = 4 * (lane & 3);
          const long long left = a.n - t0;
          scatter_run(a.gt.tab[l][k] + 16 * pl + quad, R,
                      reinterpret_cast<const int*>(scr + SG) + k,
                      scr + SZ + 320 + 256 * k + quad,
                      scr + SM + 320 + 256 * k + quad,
                      left < TILE ? (int)left : TILE);
        }
""", 1)]
PATCHES = {**FIRST_DESIGN, **TC_DESIGN}
# design -> (a text only its source holds, its variants)
DESIGNS = {"first": ("warp_transpose_sum(", tuple(FIRST_DESIGN)),
           "tc": ("scatter_pair(", tuple(TC_DESIGN))}
WRONG = ("no_table_atomics", "no_dense_atomics", "one_tf32", "no_table_red",
         "no_dense_sums", "no_table_loads")  # timed only


def kernel_source(csrc) -> str:
    """The train kernel's source in `csrc` with `tf32.cuh` written in place
    of its include, so that a patch can change the 3×TF32 products too."""
    src = (Path(csrc) / "fused_cp_train.cu").read_text()
    header = Path(csrc) / "tf32.cuh"
    if header.exists():
        src = src.replace('#include "tf32.cuh"\n',
                          header.read_text().replace("#pragma once\n", ""))
    return src


def design_of(src: str) -> str:
    """The design a kernel source is of (`DESIGNS`)."""
    for name, (mark, _) in DESIGNS.items():
        if mark in src:
            return name
    raise ValueError("the train kernel's source is of no known design")


def patched_source(name: str, src: str) -> str:
    """`src` with variant `name`'s patches applied; raises ValueError unless
    each matches as often as it says."""
    for old, new, count in PATCHES[name]:
        if src.count(old) != count:
            raise ValueError(f"{name}: the patch matches the source "
                             f"{src.count(old)} times, not {count}: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def load_tree(root=None):
    """(the tree's fused_cp_train module, its _build module): this
    checkout's, or another's imported as exp_launch_ab does."""
    if root is None:
        return fct, _build
    from .exp_launch_ab import load_other

    mods = load_other(root)
    return mods["fused_cp_train"], mods["_build"]


def build(name: str, mod, bld):
    """nvcc a variant of the tree's kernel into build/kernels/diag_train/:
    ({entry: ctypes function}, ptxas lines)."""
    out = _build.BUILD_DIR / "diag_train" / (
        "this" if bld is _build else "other")
    out.mkdir(parents=True, exist_ok=True)
    for header in bld.CSRC.glob("*.cuh"):
        tmp = out / f"{header.name}.{threading.get_ident()}.tmp"
        tmp.write_text(header.read_text())
        os.replace(tmp, out / header.name)
    cu = out / f"{name}.cu"
    cu.write_text(patched_source(name, kernel_source(bld.CSRC)))
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fns = {}
    for entry in (FWD, BWD):
        fn = getattr(lib, entry)
        fn.argtypes = mod._library.entries[entry]
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return fns, ptxas_lines(proc.stdout + proc.stderr)


def ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def builds(names, mod, bld):
    """The real entries and each variant in `names`, built in parallel:
    name -> ({entry: fn}, ptxas lines)."""
    mod._library()
    out = {"real": ({e: mod._library._fns[e] for e in (FWD, BWD)},
                    ptxas_lines(bld.build_log.get(mod._LIB, "")))}
    names = [n for n in names if n != "real"]
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        out.update(zip(names, pool.map(lambda n: build(n, mod, bld), names)))
    return out


def _swapped(mod, fns: dict, call):
    """`call()` with the wrapper's entries swapped for `fns`."""
    real = dict(mod._library._fns)
    mod._library._fns.update(fns)
    try:
        return call()
    finally:
        mod._library._fns.update(real)


def field_and_params(device: str = "cuda", sigma_scale: float = 5.0):
    """The default CP field (both heads) and its seeded weights with the σ
    column |w|·sigma_scale."""
    from ..models.tpugrid import TPUGridField

    field = TPUGridField(bound=6.0, predict_normal=True,
                         predict_mirror_mask=True)
    p = field.init(torch.Generator().manual_seed(0), device)
    s2 = p["sigma_net"][1]["w"].clone()
    s2[:, 0] = s2[:, 0].abs() * sigma_scale
    p["sigma_net"] = [p["sigma_net"][0], {"w": s2}]
    return field, p


def uniform_points(t: int, seed: int, device: str = "cuda"):
    """T points, ~2 % of them outside the bound 6 (each axis uniform over
    ±1.0068·bound), and cotangents on σ, geo and ∇σ."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.rand((t, 3), generator=g, device=device) * 2 - 1) * 6.0408
    cots = [torch.randn(s, generator=g, device=device)
            for s in ((t,), (t, 15), (t, 3))]
    return x.contiguous(), cots


def train_rays(n_rays: int = 1024, seed: int = 0, size: int = 64,
               n_views: int = 6) -> np.ndarray:
    """A seeded batch of n_rays rays of the train camera (size×size, 0.9 rad
    across, the first n_views poses of the procedural ring, near 0.05, far
    8), (n_rays, 8)."""
    from ..core.rays import get_ray_directions, get_rays, make_ray_buffer
    from ..data.synthetic import camera_ring

    focal = 0.5 * size / np.tan(0.45)
    dirs = get_ray_directions(size, size, focal)
    rays = np.concatenate([make_ray_buffer(*get_rays(dirs, c2w), 0.05, 8.0)
                           for c2w in camera_ring(n_views)])
    sel = np.random.default_rng(seed).permutation(len(rays))[:n_rays]
    return np.ascontiguousarray(rays[sel])


def ray_samples(field, params, n_rays: int = 1024, seed: int = 0,
                device: str = "cuda"):
    """The renderer's sample positions for a train batch: (coarse (n·64, 3),
    fine (n·128, 3)), a ray's samples consecutive (coarse stratified and
    jittered; fine = the coarse ones and 64 from their weights, sorted)."""
    from ..core.sampling import merge_fine_z_vals, stratified_z_vals
    from ..ops import fused_cp

    r = torch.from_numpy(train_rays(n_rays, seed)).to(device)
    o, d = r[:, 0:3].contiguous(), r[:, 3:6].contiguous()
    g = torch.Generator(device=device).manual_seed(seed)
    z64 = stratified_z_vals(r[:, 6:7], r[:, 7:8], 64, perturb=1.0,
                            generator=g).contiguous()
    with torch.no_grad():
        w = fused_cp.cp_rays_composite_reference(field, params, o, d, d, z64,
                                                 sigma_only=True)["weights"]
        z128 = merge_fine_z_vals(z64, w, 64, 1.0, generator=g)
    return tuple((o[:, None, :] + d[:, None, :] * z[..., None])
                 .reshape(-1, 3).contiguous() for z in (z64, z128))


def cases(field, params, device: str = "cuda") -> dict:
    """name -> (x (T, 3), [σ̄ (T,), ḡeo (T, 15), n̄ (T, 3)]): uniform
    T = 131072, and the ray-ordered fine (1024 × 128) and coarse (1024 × 64)
    samples of a train batch."""
    out = {"uniform": uniform_points(131072, 1, device)}
    coarse, fine = ray_samples(field, params, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    for name, x in (("rays128", fine), ("rays64", coarse)):
        t = x.shape[0]
        out[name] = (x, [torch.randn(s, generator=g, device=device)
                         for s in ((t,), (t, 15), (t, 3))])
    return out


def density_with_grad_f64(field, params, x, margin: bool = False):
    """σ, geo and ∇σ of the CP field in float64 from fp32 positions: x01,
    the cell, the lerp weight and the slope scale are the kernel's fp32
    values (a sample near a node stays in its cell), every product and sum
    after them float64; ∇σ_a = Σ_o s2[o, 0] [z1_o > 0] (s1ᵀ fold ⊕ tp_a)_o.
    The yardstick of the kernels' signed mean error (truncating tensor-core
    sums bias it where the plain fp32 version does not). With `margin`,
    also each sample's smallest |z1_o|: ∇σ jumps where a hidden unit
    changes sign, so two fp32 versions may differ by O(1) there."""
    inv2b = torch.tensor(1.0 / (2.0 * field.bound), dtype=torch.float32)
    x01 = (x + field.bound) * inv2b.to(x.device)
    inb = ((x01 >= 0) & (x01 <= 1)).double() * float(inv2b)
    axes = params["grid"]["axes"]
    p_all, tp_all = [], [[], [], []]
    for li, (g, _) in enumerate(field.grid_levels):
        f, sl = [], []
        for a in range(3):
            xf = torch.clamp(x01[:, a], 0.0, 1.0) * (g - 1)
            xi = torch.clamp_max(torch.floor(xf).long(), g - 2)
            w = (xf - xi.float()).double()[:, None]
            tab = axes[a][li].double()
            t0, t1 = tab[xi], tab[xi + 1]
            f.append(t0 * (1.0 - w) + t1 * w)
            sl.append((g - 1) * inb[:, a:a + 1] * (t1 - t0))
        p_all.append(f[0] * f[1] * f[2])
        tp_all[0].append(sl[0] * f[1] * f[2])
        tp_all[1].append(f[0] * sl[1] * f[2])
        tp_all[2].append(f[0] * f[1] * sl[2])
    fold = params["grid"]["fold"].double()
    s1 = params["sigma_net"][0]["w"].double()
    s2 = params["sigma_net"][1]["w"].double()
    z1 = (torch.cat(p_all, -1) @ fold) @ s1
    sg = torch.relu(z1) @ s2
    m = (z1 > 0).double() * s2[:, 0]
    grad = torch.stack([((torch.cat(tp, -1) @ fold) @ s1 * m).sum(-1)
                        for tp in tp_all], -1)
    if margin:
        return sg[:, 0], sg[:, 1:], grad, z1.abs().min(-1).values
    return sg[:, 0], sg[:, 1:], grad


def stable_samples(field, params, x, rel: float = 1e-6):
    """Bool (T,): the samples whose float64 hidden units all clear their
    sign change by `rel` of the largest such margin (at least 1). ∇σ jumps
    where a unit's z1 changes sign, so two fp32 versions that sum in other
    orders may differ by O(1) at the others."""
    *_, margin = density_with_grad_f64(field, params, x, True)
    return margin > rel * float(margin.max().clamp(min=1.0))


def signed_mean_errors(field, params, x, got) -> dict:
    """The kernel's (σ, geo, ∇σ) `got` against the float64 version: the
    signed mean error of σ and of each ∇σ component, each over
    max(1, the largest magnitude of its float64 values), as chip_smoke.py
    phase 11 scales the flagship's."""
    want = density_with_grad_f64(field, params, x)
    pairs = {"sigma": (got[0], want[0])}
    pairs.update((f"grad{k}", (got[2][:, k], want[2][:, k]))
                 for k in range(3))
    return {k: float((a.double() - b).mean()) / max(1.0, float(b.abs().max()))
            for k, (a, b) in pairs.items()}


def _calls(mod, field, params, x, cots):
    """(the tangent forward, the tangent backward with d_x) through the
    tree's wrapper."""
    args = mod._param_args(params)
    fold, s1, s2, *tables = args

    def fwd():
        return mod._forward(field, True, x, fold, s1, s2, tables)

    def bwd():
        return mod._backward(field, True, True, x, fold, s1, s2, tables,
                             *cots)
    return fwd, bwd


def plain_differences(mod, fns: dict, field, params, x, cots) -> dict:
    """name -> {forward (scaled above 1), worst gradient leaf and d_x
    (relative)} against the plain version on (x, cots)."""
    from ..ops.fused_cp_train import density_with_grad_reference

    leaves = [p.detach().requires_grad_(True)
              for p in fct._param_args(params)]
    p = {"grid": {"fold": leaves[0],
                  "axes": [[leaves[3 + li * 3 + a]
                            for li in range(len(field.grid_levels))]
                           for a in range(3)]},
         "sigma_net": [{"w": leaves[1]}, {"w": leaves[2]}]}
    xr = x.detach().requires_grad_(True)
    ref = density_with_grad_reference(field, p, xr)
    want = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(ref, cots)), leaves + [xr])
    ref = [o.detach() for o in ref]
    fwd, bwd = _calls(mod, field, params, x, cots)
    out = {}
    for name, f in fns.items():
        got = _swapped(mod, f, fwd)
        dx, d_fold, d_s1, d_s2, d_tables = _swapped(mod, f, bwd)
        grads = [d_fold, d_s1, d_s2, *d_tables, dx]
        out[name] = {
            "forward": max(float((a - b).abs().max())
                           / max(1.0, float(b.abs().max()))
                           for a, b in zip(got, ref)),
            "grads": max(float((a - b).abs().max())
                         / (float(b.abs().max()) + 1e-30)
                         for a, b in zip(grads, want))}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="another checkout to diagnose")
    ap.add_argument("--variants", nargs="+", choices=list(PATCHES))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants are timed on a card")
    mod, bld = load_tree(args.tree)
    design = design_of(kernel_source(bld.CSRC))
    names = args.variants or list(DESIGNS[design][1])
    built = builds(names, mod, bld)
    fns = {k: v[0] for k, v in built.items()}
    field, params = field_and_params()
    todo = cases(field, params)
    diff = plain_differences(mod, fns, field, params,
                             *uniform_points(65536 + 37, 3))
    res = {name: {} for name in fns}
    with torch.no_grad():
        for rnd in range(args.rounds):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                for case, (x, cots) in todo.items():
                    fwd, bwd = _calls(mod, field, params, x, cots)
                    for what, fn in (("fwd", fwd), ("bwd", bwd)):
                        ms = _swapped(mod, fns[name], lambda fn=fn: _ms(fn))
                        key = f"{case} {what}"
                        res[name][key] = min(res[name].get(key, 1e9), ms)
    card = torch.cuda.get_device_name(0)
    print(f"device: {card}; tree {Path(args.tree or '.').resolve()} "
          f"({design} design); ms per call, best of {args.rounds} rounds in "
          "turns; |build - plain| at T = 65573 uniform (bars: forward "
          f"{FWD_ATOL:.0e} scaled, grads {GRAD_RTOL:.0e} relative)")
    for name in fns:
        note = (("wrong values, timed only; " if name in WRONG else "")
                + f"forward {diff[name]['forward']:.2e}, grads "
                f"{diff[name]['grads']:.2e}")
        print(f"{name:17s} " + ", ".join(
            f"{k} {ms:.4f}" for k, ms in res[name].items()) + f" ({note})")
        for line in built[name][1]:
            print(f"{'':17s} ptxas: {line}")
    for name, d in diff.items():
        if name not in WRONG:
            assert d["forward"] <= FWD_ATOL and d["grads"] <= GRAD_RTOL, (
                name, d)
    return {"device": card, "design": design, "ms": res, "diff": diff}


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
