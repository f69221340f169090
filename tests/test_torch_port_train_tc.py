"""Port parity, the CP train kernels' tensor-core design
(`csrc/fused_cp_train.cu`), emulated on the CPU.

The kernels cannot run here, so this file runs their arithmetic in the
kernels' own layout: a warp's 16-sample tile (row g sample 2g, row g + 8
sample 2g + 1), the `mma.sync.m16n8k8` fragments each lane holds, the
3×TF32 hi/lo split (`fused_cp.mma3_reference`: each fragment product exact,
summed in float64, a chunk's sum rounded to fp32 and added in fp32), the
weights staged in fragment order through the index maps of the wrapper
(`fused_cp_train.rho`, `sigma_order`, `c_order`), the backward's scratch
rows read back as transposed operands (p with the samples as K), each
warp's running dense-grad sums in fragment order added in warp order at a
block's end, and the table grads' 16-B reductions of a lane's two samples
summed where their rows meet. Each emulation is held to the plain version
(`density_with_grad_reference`, `density_reference`) and, through the same
inputs, to the JAX package's Pallas kernels in interpret mode, at 2e-5
relative: both tangents, grad-of-grad through tanh(∇σ), and need_dx false.
On a machine with a card, the kernels themselves against the plain
versions (gpu-marked; they skip here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.tpugrid import TPUGridField as JaxField
from mirror_nerf_tpu.ops.pallas.fused_cp_train import \
    density_fused as jax_density_fused
from mirror_nerf_tpu.ops.pallas.fused_cp_train import \
    density_with_grad_fused as jax_dwg_fused
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchField
from mirror_nerf_tpu_torch.ops import fused_cp_train as fct
from mirror_nerf_tpu_torch.ops.fused_cp import mma3_reference, tf32_round
from mirror_nerf_tpu_torch.tools import exp_train_diag
from mirror_nerf_tpu_torch.train.checkpoints import (_leaves, _map,
                                                     params_from_numpy,
                                                     tree_leaves)

# ranks a multiple of 16 (the kernels' own layout; other ranks are padded
# by the wrapper); T: four full tiles and a partly filled fifth with an odd
# last sample
LEVELS = ((16, 16), (33, 16))
T = 75
TILE = 16
RTOL = 2e-5  # the 3×TF32 emulation against fp32 / JAX: other sum orders
G = torch.arange(32) // 4  # a lane's g and t
TL = torch.arange(32) % 4

# ---------------------------------------------------------------- fragments


def a_dense(r):
    """A lane-register A fragment (32, 4) → its 16 × 8 tile."""
    a = torch.zeros((16, 8), dtype=r.dtype)
    a[G, TL], a[G + 8, TL] = r[:, 0], r[:, 1]
    a[G, TL + 4], a[G + 8, TL + 4] = r[:, 2], r[:, 3]
    return a


def b_dense(r):
    """A B fragment (32, 2) → its 8 × 8 tile: rows t, t + 4 of column g."""
    b = torch.zeros((8, 8), dtype=r.dtype)
    b[TL, G], b[TL + 4, G] = r[:, 0], r[:, 1]
    return b


def c_regs(c):
    """A 16 × 8 C tile → the lanes' registers (32, 4)."""
    return torch.stack([c[G, 2 * TL], c[G, 2 * TL + 1], c[G + 8, 2 * TL],
                        c[G + 8, 2 * TL + 1]], -1)


def mma3(a, b):
    """A fresh chunk: the 3×TF32 product of one A and one B fragment, as
    fp32 C registers."""
    return c_regs(mma3_reference(a_dense(a), b_dense(b)).float())


def chunked(pairs, size: int):
    """Σ of fragment products, `size` k-tiles a chunk, each chunk's sum
    rounded to fp32 and the chunks added in fp32 (as the kernels add them)."""
    out = torch.zeros((32, 4))
    for i in range(0, len(pairs), size):
        part = sum(mma3_reference(a_dense(a), b_dense(b))
                   for a, b in pairs[i:i + size])
        out = out + c_regs(part.float())
    return out


def a_from_c(c):
    """The next layer's A fragment from a C fragment (csrc/tf32.cuh)."""
    return torch.stack([c[:, 0], c[:, 2], c[:, 1], c[:, 3]], -1)


def remap(mode: str, i: int) -> int:
    return {"ident": i, "rho": fct.rho(i), "sigma": fct.sigma_order(i),
            "cord": fct.c_order(i)}[mode]


def stage(w, trans: bool, km: str, nm: str, k: int, n: int):
    """The kernels' `stage`: B(i, j) = w[km(i)][nm(j)] (or transposed) in
    fragment order, (k/8, n/8, 32 lanes, 2)."""
    out = torch.zeros((k // 8, n // 8, 32, 2))
    for kt in range(k // 8):
        for nt in range(n // 8):
            for lane in range(32):
                nn = remap(nm, 8 * nt + lane // 4)
                for h in range(2):
                    kk = remap(km, 8 * kt + lane % 4 + 4 * h)
                    out[kt, nt, lane, h] = w[nn, kk] if trans else w[kk, nn]
    return out


# scratch rows of a tile: row s is sample s
def put_c(s, col, c):
    s[2 * G, col + 2 * TL], s[2 * G, col + 2 * TL + 1] = c[:, 0], c[:, 1]
    s[2 * G + 1, col + 2 * TL] = c[:, 2]
    s[2 * G + 1, col + 2 * TL + 1] = c[:, 3]


def get_a(s, kt):
    k = 8 * kt + TL
    return torch.stack([s[2 * G, k], s[2 * G + 1, k], s[2 * G, k + 4],
                        s[2 * G + 1, k + 4]], -1)


def get_at(s, m0, kt):
    k = 8 * kt + TL
    return torch.stack([s[k, m0 + G], s[k, m0 + G + 8], s[k + 4, m0 + G],
                        s[k + 4, m0 + G + 8]], -1)


def get_b(s, kt, n0):
    k = 8 * kt + TL
    return torch.stack([s[k, n0 + G], s[k + 4, n0 + G]], -1)


# ------------------------------------------------------------ per sample


def rows_of(field, params, x):
    """The kernels' fp32 position arithmetic and table rows: per level and
    axis the cell xi, lerp weight w, slope scale sl, and f, g over the
    ranks (T, R); P and the tangent streams over ΣR."""
    inv2b = torch.tensor(1.0 / (2.0 * field.bound), dtype=torch.float32)
    x01 = (x + field.bound) * inv2b
    inb = torch.where((x01 >= 0) & (x01 <= 1), inv2b, torch.zeros(()))
    lv = []
    for li, (g, _) in enumerate(field.grid_levels):
        axes = []
        for a in range(3):
            xf = torch.clamp(x01[:, a], 0.0, 1.0) * (g - 1)
            xi = torch.clamp_max(torch.floor(xf).long(), g - 2)
            w = (xf - xi.float())[:, None]
            tab = params["grid"]["axes"][a][li]
            t0, t1 = tab[xi], tab[xi + 1]
            sl = (g - 1) * inb[:, a:a + 1]
            axes.append({"xi": xi, "w": w, "sl": sl,
                         "f": t0 * (1.0 - w) + t1 * w, "g": sl * (t1 - t0)})
        lv.append(axes)
    f = [torch.cat([lvl[a]["f"] for lvl in lv], -1) for a in range(3)]
    g = [torch.cat([lvl[a]["g"] for lvl in lv], -1) for a in range(3)]
    streams = [f[0] * f[1] * f[2], g[0] * f[1] * f[2], f[0] * g[1] * f[2],
               f[0] * f[1] * g[2]]
    return lv, f, g, streams


def fold_frags(stream, i0, i1, kt):
    """A fragment of k-tile kt of a rank stream for the lanes' samples
    i0 (row g) and i1 (row g + 8): columns t, t + 4 are the ranks of one
    16-B load, rank 16p + 4t + 2h (+ 1) for kt = 2p + h."""
    p, h = divmod(kt, 2)
    r = 16 * p + 4 * TL + 2 * h
    return torch.stack([stream[i0, r], stream[i1, r], stream[i0, r + 1],
                        stream[i1, r + 1]], -1)


def tile_samples(t0: int, n: int):
    s0 = t0 + 2 * G
    act0, act1 = s0 < n, s0 + 1 < n
    i0 = torch.where(act0, s0, n - 1)
    i1 = torch.where(act1, s0 + 1, n - 1)
    return i0, i1, act0, act1


def nets(params):
    return (params["grid"]["fold"].float(), params["sigma_net"][0]["w"],
            params["sigma_net"][1]["w"])


# --------------------------------------------------------------- forward


def emulate_forward(field, params, x, tangents: bool):
    """The forward kernel tile by tile: σ, geo (and ∇σ)."""
    n, sum_r = x.shape[0], sum(r for _, r in field.grid_levels)
    fold, s1, s2 = nets(params)
    b_fold = stage(fold, False, "rho", "ident", sum_r, 32)
    b_s1 = stage(s1, False, "cord", "ident", 32, 64)
    b_s2 = stage(s2, False, "cord", "ident", 64, 16)
    s2c = s2[:, 0]
    _, _, _, streams = rows_of(field, params, x)
    streams = streams if tangents else streams[:1]
    sigma, geo, grad = (torch.zeros(n), torch.zeros((n, 15)),
                        torch.zeros((n, 3)))
    for t0 in range(0, n, TILE):
        i0, i1, act0, act1 = tile_samples(t0, n)
        acc = [[torch.zeros((32, 4)) for _ in range(4)] for _ in streams]
        for kt in range(sum_r // 8):
            for s, v in enumerate(streams):
                a = fold_frags(v, i0, i1, kt)
                for nt in range(4):
                    acc[s][nt] = acc[s][nt] + mma3(a, b_fold[kt, nt])
        fe = [a_from_c(acc[0][kt]) for kt in range(4)]
        z1 = [chunked([(fe[kt], b_s1[kt, nt]) for kt in range(4)], 1)
              for nt in range(8)]
        sg = [chunked([(a_from_c(torch.relu(z1[kt])), b_s2[kt, nt])
                       for kt in range(8)], 2) for nt in range(2)]
        # raw σ on the CUDA cores: lane t's columns, then the quad's sum
        sig = torch.zeros((32, 2))
        for kt in range(8):
            h = torch.relu(z1[kt])
            m0, m1 = s2c[8 * kt + 2 * TL], s2c[8 * kt + 2 * TL + 1]
            sig[:, 0] += m0 * h[:, 0] + m1 * h[:, 1]
            sig[:, 1] += m0 * h[:, 2] + m1 * h[:, 3]
        sig = sig.view(8, 4, 2).sum(1)  # quad sums, one per g
        gr = torch.zeros((8, 2, 3))
        for s in range(1, len(streams)):
            ft = [a_from_c(acc[s][kt]) for kt in range(4)]
            r = torch.zeros((32, 2))
            for nt in range(8):
                zt = chunked([(ft[kt], b_s1[kt, nt]) for kt in range(4)], 1)
                m0, m1 = s2c[8 * nt + 2 * TL], s2c[8 * nt + 2 * TL + 1]
                r[:, 0] += torch.where(z1[nt][:, 0] > 0, m0 * zt[:, 0], 0)
                r[:, 0] += torch.where(z1[nt][:, 1] > 0, m1 * zt[:, 1], 0)
                r[:, 1] += torch.where(z1[nt][:, 2] > 0, m0 * zt[:, 2], 0)
                r[:, 1] += torch.where(z1[nt][:, 3] > 0, m1 * zt[:, 3], 0)
            gr[:, :, s - 1] = r.view(8, 4, 2).sum(1)
        for q, (idx, act) in enumerate(((i0, act0), (i1, act1))):
            for nt in range(2):
                for e in range(2):
                    col = 8 * nt + 2 * TL + e
                    val = sg[nt][:, 2 * q + e]
                    keep = act & (col > 0)
                    geo[idx[keep], col[keep] - 1] = val[keep]
            lead = act & (TL == 0)
            sigma[idx[lead]] = sig[G[lead], q]
            grad[idx[lead]] = gr[G[lead], q]
    return (sigma, geo, grad) if tangents else (sigma, geo)


# -------------------------------------------------------------- backward


def scatter_pair(tab, off, xi0, xi1, act1, c00, c01, c10, c11, counts):
    """The kernel's `scatter_pair` for one lane: rows of a table (G, R) get
    4 ranks each, the two samples' rows summed where they meet; counts the
    16-B reductions by how many the pair took."""
    if not act1:
        tab[xi0, off:off + 4] += c00
        tab[xi0 + 1, off:off + 4] += c01
        counts[2] += 1
        return
    d = xi1 - xi0
    if d == 0:
        tab[xi0, off:off + 4] += c00 + c10
        tab[xi0 + 1, off:off + 4] += c01 + c11
        counts[2] += 1
    elif d == 1:
        tab[xi0, off:off + 4] += c00
        tab[xi0 + 1, off:off + 4] += c01 + c10
        tab[xi0 + 2, off:off + 4] += c11
        counts[3] += 1
    elif d == -1:
        tab[xi0 - 1, off:off + 4] += c10
        tab[xi0, off:off + 4] += c11 + c00
        tab[xi0 + 1, off:off + 4] += c01
        counts[3] += 1
    else:
        tab[xi0, off:off + 4] += c00
        tab[xi0 + 1, off:off + 4] += c01
        tab[xi1, off:off + 4] += c10
        tab[xi1 + 1, off:off + 4] += c11
        counts[4] += 1


def frag_to_entry(k: int, r32: int):
    """A running-sum float's place (fragment order) → (grad, row, column),
    as the block's final sum maps it."""
    f, ln, e = k >> 7, (k >> 2) & 31, k & 3
    row, col = (ln >> 2) + 8 * (e >> 1), 2 * (ln & 3) + (e & 1)
    if k < r32:
        return "fold", 16 * (f >> 2) + row, 8 * (f & 3) + col
    if k < r32 + 2048:
        f1 = f - r32 // 128
        return "s1", 16 * (f1 >> 3) + row, 8 * (f1 & 7) + col
    f2 = f - (r32 + 2048) // 128
    return "s2", 16 * (f2 >> 1) + row, 8 * (f2 & 1) + col


def emulate_backward(field, params, x, cots, tangents: bool, need_dx: bool,
                     blocks: int = 2, warps: int = 2):
    """The backward kernel on a grid of `blocks` × `warps` warps walking the
    tiles by a stride: (dx, d_fold, d_s1, d_s2, d_tables, reduction
    counts)."""
    n, sum_r = x.shape[0], sum(r for _, r in field.grid_levels)
    r32 = sum_r * 32
    fold, s1, s2 = nets(params)
    b_fold = stage(fold, False, "rho", "ident", sum_r, 32)
    b_foldt = stage(fold, True, "ident", "sigma", 32, sum_r)
    b_s1 = stage(s1, False, "ident", "ident", 32, 64)
    b_s1t = stage(s1, True, "ident", "ident", 64, 32)
    b_s2t = stage(s2, True, "ident", "ident", 16, 64)
    s2c = s2[:, 0]
    lv, f, g, streams = rows_of(field, params, x)
    dsig, dgeo, dgrad = cots
    nb = dgrad if tangents else torch.zeros_like(dgrad)
    tpn = nb[:, :1] * streams[1] + nb[:, 1:2] * streams[2] \
        + nb[:, 2:3] * streams[3]
    rank_streams = [streams[0], tpn] if tangents else [streams[0]]
    d_tables = [torch.zeros_like(params["grid"]["axes"][a][li])
                for li in range(len(lv)) for a in range(3)]
    dx = torch.zeros((n, 3))
    part = torch.zeros((blocks * warps, r32 + 3072))
    touched = torch.zeros(blocks * warps, dtype=torch.bool)
    counts = {2: 0, 3: 0, 4: 0}
    for w in range(blocks * warps):
        for t0 in range(w * TILE, n, blocks * warps * TILE):
            touched[w] = True
            i0, i1, act0, act1 = tile_samples(t0, n)
            sgr = torch.zeros((16, 16))  # (σ̄, ḡeo) rows, 0 past the end
            rows = torch.arange(t0, t0 + 16)
            live = rows < n
            sgr[live, 0] = dsig[rows[live]]
            sgr[live, 1:] = dgeo[rows[live]]
            nbr = torch.zeros((16, 3))
            nbr[live] = nb[rows[live]]
            # recompute e (and u)
            acc = [[torch.zeros((32, 4)) for _ in range(4)]
                   for _ in rank_streams]
            for kt in range(sum_r // 8):
                for s, v in enumerate(rank_streams):
                    a = fold_frags(v, i0, i1, kt)
                    for nt in range(4):
                        acc[s][nt] = acc[s][nt] + mma3(a, b_fold[kt, nt])
            se, su = torch.zeros((16, 32)), torch.zeros((16, 32))
            # a sample past the end carries no cotangent: its u row is 0
            for nt in range(4):
                put_c(se, 8 * nt, acc[0][nt])
                if tangents:
                    put_c(su, 8 * nt, acc[1][nt])
            su[~live] = 0.0
            # z1, zu → h, tn and the sign mask
            sz, sm = torch.zeros((16, 64)), torch.zeros((16, 64))
            mask = torch.zeros((16, 64), dtype=torch.bool)
            for nt in range(8):
                z = chunked([(get_a(se, kt), b_s1[kt, nt])
                             for kt in range(4)], 1)
                put_c(sz, 8 * nt, torch.relu(z))
                zs = torch.zeros((16, 64))
                put_c(zs, 8 * nt, z)
                mask[:, 8 * nt:8 * nt + 8] = zs[:, 8 * nt:8 * nt + 8] > 0
                if tangents:
                    zu = chunked([(get_a(su, kt), b_s1[kt, nt])
                                  for kt in range(4)], 1)
                    put_c(sm, 8 * nt, zu)
            sm = torch.where(mask, sm, torch.zeros(()))
            # d_s2 += hᵀ sḡ (+ Σ tn into column 0)
            e0 = torch.stack([(G == 0).float()] * 2, -1)
            for mt in range(4):
                for nt in range(2):
                    c = sum(mma3_reference(a_dense(get_at(sz, 16 * mt, kt)),
                                           b_dense(get_b(sgr, kt, 8 * nt)))
                            for kt in range(2))
                    if tangents and nt == 0:
                        c = c + sum(mma3_reference(
                            a_dense(get_at(sm, 16 * mt, kt)), b_dense(e0))
                            for kt in range(2))
                    frag = r32 // 128 + 16 + 2 * mt + nt
                    part[w].view(-1, 32, 4)[frag] += c_regs(c.float())
            # z̄1, m
            hb = torch.zeros((16, 64))
            for nt in range(8):
                put_c(hb, 8 * nt, chunked([(get_a(sgr, kt), b_s2t[kt, nt])
                                           for kt in range(2)], 2))
            sz = torch.where(mask, hb, torch.zeros(()))
            sm = torch.where(mask, s2c.expand(16, 64), torch.zeros(())) \
                if tangents else torch.zeros((16, 64))
            # d_s1 += eᵀ z̄1 + uᵀ m
            for nt in range(8):
                for mt in range(2):
                    c = sum(mma3_reference(a_dense(get_at(se, 16 * mt, kt)),
                                           b_dense(get_b(sz, kt, 8 * nt)))
                            for kt in range(2))
                    if tangents:
                        c = c + sum(mma3_reference(
                            a_dense(get_at(su, 16 * mt, kt)),
                            b_dense(get_b(sm, kt, 8 * nt))) for kt in range(2))
                    frag = r32 // 128 + 8 * mt + nt
                    part[w].view(-1, 32, 4)[frag] += c_regs(c.float())
            # ē, v
            eb, vv = torch.zeros((16, 32)), torch.zeros((16, 32))
            for nt in range(4):
                put_c(eb, 8 * nt, chunked([(get_a(sz, kt), b_s1t[kt, nt])
                                           for kt in range(8)], 2))
                if tangents:
                    put_c(vv, 8 * nt, chunked([(get_a(sm, kt),
                                                b_s1t[kt, nt])
                                               for kt in range(8)], 2))
            # per 16-rank group
            for li, (_, R) in enumerate(field.grid_levels):
                p0 = sum(r for _, r in field.grid_levels[:li]) // 16
                for pl in range(R // 16):
                    p = p0 + pl
                    pb, qv = [], []
                    for h in range(2):
                        pb.append(chunked([(get_a(eb, kt),
                                            b_foldt[kt, 2 * p + h])
                                           for kt in range(4)], 2))
                        qv.append(chunked([(get_a(vv, kt),
                                            b_foldt[kt, 2 * p + h])
                                           for kt in range(4)], 2))
                    sp, stp = torch.zeros((16, 16)), torch.zeros((16, 16))
                    for lane in range(32):
                        gg, tt = lane // 4, lane % 4
                        c0v = np.zeros((2, 3, 4), np.float32)
                        c1v = np.zeros((2, 3, 4), np.float32)
                        for q in range(2):
                            idx = int((i0, i1)[q][lane])
                            for j in range(4):
                                rk = 16 * p + 4 * tt + j
                                fq = [float(f[a][idx, rk]) for a in range(3)]
                                gq = [float(g[a][idx, rk]) for a in range(3)]
                                pbv = float(pb[j >> 1][lane, 2 * q + (j & 1)])
                                qvv = float(qv[j >> 1][lane, 2 * q + (j & 1)])
                                nq = [float(v) for v in nbr[2 * gg + q]]
                                fb = [pbv * fq[1] * fq[2], pbv * fq[0] * fq[2],
                                      pbv * fq[0] * fq[1]]
                                gb = [0.0, 0.0, 0.0]
                                if tangents:
                                    qb = [qvv * v for v in nq]
                                    fb[0] += qb[1] * gq[1] * fq[2] \
                                        + qb[2] * fq[1] * gq[2]
                                    fb[1] += qb[0] * gq[0] * fq[2] \
                                        + qb[2] * fq[0] * gq[2]
                                    fb[2] += qb[0] * gq[0] * fq[1] \
                                        + qb[1] * fq[0] * gq[1]
                                    gb = [qb[0] * fq[1] * fq[2],
                                          qb[1] * fq[0] * fq[2],
                                          qb[2] * fq[0] * fq[1]]
                                    stp[2 * gg + q, 4 * tt + j] = float(
                                        rank_streams[1][idx, rk])
                                sp[2 * gg + q, 4 * tt + j] = float(
                                    streams[0][idx, rk])
                                for a in range(3):
                                    ax = lv[li][a]
                                    w_ = float(ax["w"][idx])
                                    sl = float(ax["sl"][idx])
                                    c0v[q, a, j] = fb[a] * (1 - w_) - gb[a] * sl
                                    c1v[q, a, j] = fb[a] * w_ + gb[a] * sl
                                    if need_dx and bool((act0, act1)[q][lane]):
                                        dx[idx, a] += fb[a] * gq[a]
                        if not bool(act0[lane]):
                            continue
                        for a in range(3):
                            xi = [int(lv[li][a]["xi"][int(i)])
                                  for i in (i0[lane], i1[lane])]
                            scatter_pair(d_tables[li * 3 + a], 16 * pl + 4 * tt,
                                         xi[0], xi[1], bool(act1[lane]),
                                         *(torch.from_numpy(v.copy()) for v in
                                           (c0v[0, a], c1v[0, a], c0v[1, a],
                                            c1v[1, a])), counts)
                    # a sample past the end carries no n̄: its tpn row is 0
                    stp[~live] = 0.0
                    # d_fold rows of group p: pᵀ ē + tpnᵀ v, samples as K
                    for nt in range(4):
                        c = sum(mma3_reference(a_dense(get_at(sp, 0, kt)),
                                               b_dense(get_b(eb, kt, 8 * nt)))
                                for kt in range(2))
                        if tangents:
                            c = c + sum(mma3_reference(
                                a_dense(get_at(stp, 0, kt)),
                                b_dense(get_b(vv, kt, 8 * nt)))
                                for kt in range(2))
                        part[w].view(-1, 32, 4)[4 * p + nt] += c_regs(c.float())
    # each block: its warps' sums in warp order, then one add an entry
    grads = {"fold": torch.zeros((sum_r, 32)), "s1": torch.zeros((32, 64)),
             "s2": torch.zeros((64, 16))}
    for b in range(blocks):
        total = torch.zeros(r32 + 3072)
        for w in range(b * warps, (b + 1) * warps):
            if touched[w]:
                total = total + part[w]
        for k in range(r32 + 3072):
            name, row, col = frag_to_entry(k, r32)
            grads[name][row, col] += total[k]
    return (dx, grads["fold"], grads["s1"], grads["s2"], d_tables, counts)


# ------------------------------------------------------------------- data


@pytest.fixture(scope="module")
def setup():
    kw = dict(predict_normal=True, predict_mirror_mask=True, bound=6.0,
              grid_levels=LEVELS)
    jf, tf = JaxField(**kw), TorchField(**kw)
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(0)))
    # σ column |w|·5: σ > 0 on most samples (gradients through z̄1 live)
    p["sigma_net"][1]["w"][:, 0] = np.abs(p["sigma_net"][1]["w"][:, 0]) * 5
    rng = np.random.default_rng(3)
    # ray-ordered samples: 5 rays × 15 samples, consecutive along each,
    # spaced so that neighbours share a cell, touch or skip one at the
    # three levels' widths; tiles of 16 cut across rays and runs; one ray
    # runs out of the bound
    o = rng.uniform(-4, 4, (5, 3))
    d = rng.normal(size=(5, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 1.2, (5, 15)), -1) \
        + np.linspace(0, 6.0, 15)[None] * np.array([[0.05], [0.2], [0.6],
                                                    [1.0], [1.3]])
    x = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    x[-3:] = [[6.3, 0.1, -2.0], [0.5, -6.2, 1.0], [1.0, 2.0, 6.01]]
    x = x.astype(np.float32)
    assert x.shape[0] == T
    cots = (rng.normal(size=(T,)).astype(np.float32),
            rng.normal(size=(T, 15)).astype(np.float32),
            rng.normal(size=(T, 3)).astype(np.float32))
    return jf, tf, p, x, cots


def _plain_grads(tf, pt, x, cots, tangents, need_dx=True):
    leaves = tree_leaves(pt)
    leaves = [v.detach().requires_grad_(True) for v in leaves]
    p = _tree_like(pt, leaves)
    xt = torch.from_numpy(x).requires_grad_(need_dx)
    if tangents:
        out = fct.density_with_grad_reference(tf, p, xt)
    else:
        out = fct.density_reference(tf, p, xt if need_dx else xt.detach())
    ca, cb, cc = (torch.from_numpy(c) for c in cots)
    loss = (out[0] * ca).sum() + (out[1] * cb).sum()
    if tangents:
        loss = loss + (out[2] * cc).sum()
    gr = torch.autograd.grad(loss, leaves + ([xt] if need_dx else []),
                             allow_unused=True)
    gr = [torch.zeros_like(v) if a is None else a
          for v, a in zip(leaves + [xt], gr)]
    return [o.detach() for o in out], gr, p


def _tree_like(pt, leaves):
    """`pt`'s tree with its leaves (in `tree_leaves` order) replaced."""
    by_path = dict(zip((path for path, _ in _named(pt)), leaves))
    return _map(pt, lambda path, _: by_path[path])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(a).max()) + 1e-12)


# ---------------------------------------------------------------- tests


def test_index_maps_are_permutations():
    """ρ, σ and the C order permute each 16-rank group (8-column tile) onto
    itself; ρ's k-tiles 2p, 2p + 1 give lane t the four adjacent ranks
    16p + 4t … 16p + 4t + 3, and σ puts pb's C columns 2t, 2t + 1 on the
    ranks the same lane's A columns t, t + 4 hold."""
    for fn, block in ((fct.rho, 16), (fct.sigma_order, 16),
                      (fct.c_order, 8)):
        for base in (0, block, 5 * block):
            got = sorted(fn(base + i) for i in range(block))
            assert got == list(range(base, base + block))
    for p in range(3):
        for t in range(4):
            lane = sorted(fct.rho(8 * (2 * p + h) + t + 4 * e)
                          for h in range(2) for e in range(2))
            assert lane == [16 * p + 4 * t + j for j in range(4)]
            for h in range(2):
                for e in range(2):
                    assert fct.sigma_order(8 * (2 * p + h) + 2 * t + e) \
                        == fct.rho(8 * (2 * p + h) + t + 4 * e)
    assert [fct.c_order(k) for k in range(8)] == [0, 2, 4, 6, 1, 3, 5, 7]


def test_fragment_round_trip():
    """a_dense / b_dense / c_regs invert the PTX layouts: an A fragment
    built from a tile's C fragment (a_from_c) is that tile with its columns
    in the C order."""
    c = torch.arange(128, dtype=torch.float32).view(16, 8)
    regs = c_regs(c)
    a = a_dense(a_from_c(regs))
    order = [fct.c_order(k) for k in range(8)]
    assert torch.equal(a, c[:, order])
    b = torch.arange(64, dtype=torch.float32).view(8, 8)
    back = torch.stack([b[TL, G], b[TL + 4, G]], -1)
    assert torch.equal(b_dense(back), b)


def test_tf32_split_in_the_emulated_products():
    """The 3×TF32 fragment product is fp32-accurate where one TF32 product
    is not: the split keeps 2⁻²² of the operands, TF32 alone 2⁻¹¹."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn((32, 4), generator=g) * 3
    b = torch.randn((32, 2), generator=g)
    exact = a_dense(a).double() @ b_dense(b).double()
    three = mma3_reference(a_dense(a), b_dense(b))
    single = tf32_round(a_dense(a)).double() @ tf32_round(b_dense(b)).double()
    scale = float(exact.abs().max())
    assert float((three - exact).abs().max()) <= 1e-6 * scale
    assert float((single - exact).abs().max()) > 1e-5 * scale


@pytest.mark.parametrize("tangents", [True, False],
                         ids=["tangents", "density"])
def test_forward_emulation_matches_plain_and_jax(setup, tangents):
    """The forward kernel's tiles, fragments, staging and chunked 3×TF32
    sums reproduce the plain version (σ, geo, ∇σ), and through the same
    inputs the JAX package's Pallas kernel in interpret mode."""
    jf, tf, p, x, _ = setup
    pt = params_from_numpy(p)
    xt = torch.from_numpy(x)
    got = emulate_forward(tf, pt, xt, tangents)
    if tangents:
        want = fct.density_with_grad_reference(tf, pt, xt)
        jx = jax_dwg_fused(jf, p, x, interpret=True)
    else:
        want = fct.density_reference(tf, pt, xt)
        jx = jax_density_fused(jf, p, x, interpret=True)
    for name, a, b, c in zip(("sigma", "geo", "grad"), got, want, jx):
        assert _rel(b.detach(), a) < RTOL, name
        assert _rel(np.asarray(c), a) < RTOL, name
    if tangents:  # no slope along an axis outside the bound
        assert (got[2][torch.from_numpy(np.abs(x) > 6.0)] == 0).all()


@pytest.mark.parametrize("variant", ["tangents", "tangents_no_dx", "density",
                                     "density_no_dx"])
def test_backward_emulation_matches_plain_and_jax(setup, variant):
    """The backward kernel's recompute, scratch rows, transposed operands
    (p with the samples as K), per-warp running sums added in warp order a
    block, and the pair-summed table scatter give the plain version's
    gradients — grad-of-grad through the ∇σ cotangent included — and the
    JAX kernels' (interpret mode) on the same cotangents; d_x is 0 without
    need_dx and outside the bound."""
    jf, tf, p, x, cots = setup
    tangents, need_dx = variant.startswith("tangents"), "no_dx" not in variant
    pt = params_from_numpy(p)
    ct = [torch.from_numpy(c) for c in cots]
    dx, d_fold, d_s1, d_s2, d_tab, counts = emulate_backward(
        tf, pt, torch.from_numpy(x), ct, tangents, need_dx)
    _, want, _ = _plain_grads(tf, pt, x, cots, tangents, need_dx)
    got = {"fold": d_fold, "s1": d_s1, "s2": d_s2}
    names = [n for n, _ in _named(pt)]
    for name, w in zip(names, want):
        if name == "grid/fold":
            g = got["fold"]
        elif name == "sigma_net/0/w":
            g = got["s1"]
        elif name == "sigma_net/1/w":
            g = got["s2"]
        elif name.startswith("grid/axes/"):
            a, li = (int(v) for v in name.split("/")[2:4])
            g = d_tab[li * 3 + a]
        else:
            assert float(w.abs().max()) == 0.0, name  # the heads
            continue
        assert _rel(w, g) < RTOL, name
    if need_dx:
        assert _rel(want[-1], dx) < RTOL
        assert (dx[torch.from_numpy(np.abs(x) > 6.0)] == 0).all()
    else:
        assert float(dx.abs().max()) == 0.0
    # the ray-ordered samples exercise every way a pair's rows meet
    assert min(counts.values()) > 0, counts
    # JAX, interpret mode: the same loss as its value_and_grad
    if tangents:
        def fn(pp, xx):
            return jax_dwg_fused(jf, pp, xx, interpret=True)
    else:
        def fn(pp, xx):
            return jax_density_fused(jf, pp, xx, interpret=True)

    def loss(pp, xx):
        out = fn(pp, xx if need_dx else jax.lax.stop_gradient(xx))
        v = jnp.sum(out[0] * cots[0]) + jnp.sum(out[1] * cots[1])
        return v + (jnp.sum(out[2] * cots[2]) if tangents else 0.0)

    gp, gx = jax.grad(loss, argnums=(0, 1))(p, x)
    jg = gp["grid"]
    assert _rel(np.asarray(jg["fold"]), d_fold) < RTOL
    assert _rel(np.asarray(gp["sigma_net"][0]["w"]), d_s1) < RTOL
    assert _rel(np.asarray(gp["sigma_net"][1]["w"]), d_s2) < RTOL
    for li in range(len(LEVELS)):
        for a in range(3):
            assert _rel(np.asarray(jg["axes"][a][li]), d_tab[li * 3 + a]) \
                < RTOL
    if need_dx:
        assert _rel(np.asarray(gx), dx) < RTOL


def _named(pt):
    return list(_leaves(pt))


def test_block_sums_cover_every_dense_grad_entry_once():
    """The block's final sum maps the warps' running sums (fragment order)
    onto d_fold, d_s1 and d_s2: every entry once."""
    r32 = 64 * 32
    seen = {"fold": set(), "s1": set(), "s2": set()}
    for k in range(r32 + 3072):
        name, row, col = frag_to_entry(k, r32)
        assert (row, col) not in seen[name]
        seen[name].add((row, col))
    assert len(seen["fold"]) == r32 and len(seen["s1"]) == 2048 \
        and len(seen["s2"]) == 1024


def test_padded_levels_keep_the_grads_shapes():
    """Levels whose rank is not a multiple of 16 run on zero-padded copies
    (`_kernel_operands`): the real ranks' rows and columns, in order."""
    levels = ((16, 8), (33, 16), (9, 5))
    g = torch.Generator().manual_seed(1)
    fold = torch.randn((29, 32), generator=g)
    tables = [torch.randn((gg, r), generator=g) for gg, r in levels
              for _ in range(3)]
    lv, fold_p, tab_p, spans = fct._kernel_operands(levels, fold, tables)
    assert lv == ((16, 16), (33, 16), (9, 16))
    assert spans == [(0, 8), (16, 16), (32, 5)]
    assert fold_p.shape == (48, 32)
    assert torch.equal(fct._unpad_fold(fold_p, spans), fold)
    assert float(fold_p.abs().sum()) == float(fold.abs().sum())
    for t, tp in zip(tables, tab_p):
        assert tp.shape[1] % 16 == 0 and torch.equal(tp[:, :t.shape[1]], t)
        assert float(tp[:, t.shape[1]:].abs().sum()) == 0.0
    same = fct._kernel_operands(((16, 16),), fold[:16],
                                [torch.zeros((16, 16)) for _ in range(3)])
    assert same[3] is None and same[1] is not None


@pytest.mark.parametrize("variant", list(exp_train_diag.PATCHES))
def test_diagnosis_patches_match_their_design(variant):
    """Each variant of tools/exp_train_diag.py belongs to one design and
    matches that design's source as often as it says; the tensor-core
    design's match this checkout's kernel."""
    from mirror_nerf_tpu_torch.ops import _build

    src = exp_train_diag.kernel_source(_build.CSRC)
    assert exp_train_diag.design_of(src) == "tc"
    designs = [d for d, (_, names) in exp_train_diag.DESIGNS.items()
               if variant in names]
    assert len(designs) == 1
    if designs[0] == "tc":
        got = exp_train_diag.patched_source(variant, src)
        assert got != src
    else:
        with pytest.raises(ValueError, match=variant):
            exp_train_diag.patched_source(variant, src)


def test_float64_reference_matches_the_plain_version(setup):
    """The yardstick of the signed-mean check: float64 after the kernels'
    fp32 cells agrees with the fp32 plain version to fp32 rounding."""
    _, tf, p, x, _ = setup
    pt = params_from_numpy(p)
    xt = torch.from_numpy(x)
    want = fct.density_with_grad_reference(tf, pt, xt)
    got = exp_train_diag.density_with_grad_f64(tf, pt, xt)
    for a, b in zip(want, got):
        assert _rel(b, a.detach()) < 1e-5


# ------------------------------------------------------ on a card only


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["tangents", "tangents_no_dx", "density",
                                     "density_no_dx"])
def test_cuda_kernels_match_plain_on_ray_ordered_samples(setup, variant):
    """The kernels against the plain versions on the ray-ordered samples
    (every pair-sum case of the table scatter, tiles across rays)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tf, p, x, cots = setup
    tangents, need_dx = variant.startswith("tangents"), "no_dx" not in variant
    pt = params_from_numpy(p, device="cuda")
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(pt)]
    pk = _tree_like(pt, leaves)
    xt = torch.from_numpy(x).cuda().requires_grad_(need_dx)
    if tangents:
        out = fct.density_with_grad_fused(tf, pk, xt)
    else:
        out = fct.density_fused(tf, pk, xt, need_dx=need_dx)
    ca, cb, cc = (torch.from_numpy(c).cuda() for c in cots)
    loss = (out[0] * ca).sum() + (out[1] * cb).sum()
    if tangents:
        loss = loss + (out[2] * cc).sum()
    got = torch.autograd.grad(loss, leaves + ([xt] if need_dx else []),
                              allow_unused=True)
    ref_out, want, _ = _plain_grads(tf, params_from_numpy(p), x, cots,
                                    tangents, need_dx)
    for a, b in zip(out, ref_out):
        scale = max(1.0, float(b.abs().max()))
        assert float((a.detach().cpu() - b).abs().max()) <= 1e-4 * scale
    for g, w in zip(got[:len(leaves)], want):
        g = torch.zeros_like(w) if g is None else g.cpu()
        if float(w.abs().max()) > 0:
            assert _rel(w, g) < 1e-3
    if need_dx:
        assert _rel(want[-1], got[-1].cpu()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("extra, fwd_fits, bwd_fits",
                         [(0, True, True), (16, True, False),
                          (48, False, False)])
def test_cuda_kernels_at_their_shared_memory_limit(extra, fwd_fits,
                                                   bwd_fits):
    """The fold is staged twice, so the levels' ranks may sum to 800 in the
    forward and 768 in the backward (one warp a block there). At 768 both
    kernels match the plain version; at 784 the backward refuses, at 816
    the forward too, each with the -5 message naming the limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    levels = ((16, 256),) * 3 + (((16, extra),) if extra else ())
    tf = TorchField(predict_normal=True, predict_mirror_mask=True, bound=6.0,
                    grid_levels=levels)
    pt = tf.init(torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.rand((4096, 3), generator=g, device="cuda") * 2 - 1) * 6.0
    cots = [torch.randn(s, generator=g, device="cuda")
            for s in ((4096,), (4096, 15), (4096, 3))]
    refusal = "768 in the backward"

    def run(fn):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(pt)]
        xr = x.clone().requires_grad_(True)
        out = fn(tf, _tree_like(pt, leaves), xr)
        loss = sum((o * c).sum() for o, c in zip(out, cots))
        grads = torch.autograd.grad(loss, leaves + [xr], allow_unused=True)
        return out, [torch.zeros_like(v) if gr is None else gr
                     for v, gr in zip(leaves + [xr], grads)]

    if not fwd_fits:
        with pytest.raises(ValueError, match=refusal):
            fct.density_with_grad_fused(tf, pt, x)
        return
    if not bwd_fits:
        with pytest.raises(ValueError, match=refusal):
            run(fct.density_with_grad_fused)
        return
    out, got = run(fct.density_with_grad_fused)
    ref, want = run(fct.density_with_grad_reference)
    for a, b in zip(out, ref):
        a, b = a.detach(), b.detach()
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 1e-4 * scale
    for g_, w in zip(got, want):
        if float(w.abs().max()) > 0:
            assert _rel(w.cpu(), g_.cpu()) < 1e-3


@pytest.mark.gpu
def test_cuda_sass_runs_on_the_tensor_cores():
    """All six instances hold HMMA; none spills more than the forward
    tangent instance's few hundred bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and the toolkit's cuobjdump")
    from mirror_nerf_tpu_torch.ops import _build

    fct._library()
    sass = _build.sass_counts(_build.library_path(fct._LIB), "_kernel")
    assert len(sass) == 6
    assert min(c["HMMA"] for c in sass.values()) > 0
