"""The in-kernel hash-grid probe on the GPU (torch counterpart of
`tools/exp_hash_inkernel.py`).

    python -m mirror_nerf_tpu_torch.tools.exp_hash_inkernel         # the card
    python -m mirror_nerf_tpu_torch.tools.exp_hash_inkernel --cpu   # no card

The JAX probe asked whether a TPU kernel can gather hash-table rows fast
enough to fuse the hash-grid encoder (it cannot: Mosaic has no scalar
gather). Here the same question is asked of the three modes of
`csrc/hashgrid.cu` (ops/hashgrid.py):

Parity, against the plain PyTorch versions on the same inputs:
  B. GATHER (`gather_rows`) equals `table[idx]` bit for bit, fp32 and bf16;
  C. DENSE (`dense_level_lookup`) on level 3 of the bound-6 spec (side 62)
     matches its plain version and `hashgrid_encode`'s level-3 slice;
  D. ENCODE (`hashgrid_encode`) at the full bound-6 spec (16 levels × 2,
     6,616,280 rows, the table ×1e4) matches its plain version, on points
     ~2 % of which lie outside [0, 1]³.
On the CPU the wrappers are the plain versions, so only B's and C's
identities (the JAX probe's own checks) say anything there.

Timing (the card only; CUDA events over back-to-back calls after a warm
one, and each kernel's device time from a torch.profiler trace — at a few
µs a kernel the first measures the host's launch rate), at the JAX probe's
shapes — a 2¹⁹ × 2 table, fp32 and bf16, idx
(64, 4096); 262,144 samples at scale 59.43 on a side-62 level — and at the
render path's: 16384 rays × 128 samples = 2,097,152 points:
  A. torch indexing `table[idx]`, the library call GATHER is held against;
  B. GATHER, its plain version, and GATHER through bare ctypes (the C entry
     with the wrapper's pointers, card and stream, no checks,
     no allocation, counted in `launches_gather` like the wrapper's: the
     wrapper's cost above it is the launch path's); A and B are timed in
     turns, best of 5 rounds (`timing.per_call_ms`);
  C. DENSE and the library call `grid_sample` (trilinear), in turns the
     same way, and DENSE's plain version;  D. ENCODE and its plain version.
Rates in M rows/s (A, B) or M samples/s (C, D).

It imports only torch and the port, and builds the kernels at first use.
`main` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.ngp import NGPField
from ..ops import hashgrid as hg
from .timing import device_ms, per_call_ms, time_ms

TABLE_ROWS = 2 ** 19
IDX_SHAPE = (64, 4096)
DENSE_SAMPLES = 262_144
DENSE_SCALE = 59.43
DENSE_SIDE = 62
PATH_POINTS = 16384 * 128


def encode_case(n: int, seed: int, device, oob_share: float = 0.02):
    """The full bound-6 spec, a ×1e4 table (O(1) values: the ±1e-4 init
    would hide errors) and n points uniform over [−s, 1 + s]³, s chosen so
    that ~`oob_share` of them fall outside [0, 1]³."""
    spec = NGPField(bound=6.0).grid_spec
    g = torch.Generator().manual_seed(seed)
    table = hg.init_hashgrid(g, spec) * 1e4
    s = ((1.0 - oob_share) ** (-1.0 / 3.0) - 1.0) / 2.0
    x = torch.rand((n, 3), generator=g) * (1.0 + 2.0 * s) - s
    return spec, table.to(device), x.to(device)


def _scaled_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| / max(1, max |ref|)."""
    return float((got.float() - ref.float()).abs().max()) / max(
        1.0, float(ref.float().abs().max()))


def parity(device, n_encode: int = PATH_POINTS, seed: int = 0) -> dict:
    """Each mode against its plain version (and the JAX probe's identities)
    on `device`; returns the errors and asserts them."""
    rng = np.random.default_rng(seed)
    out = {}
    with torch.no_grad():
        # B: GATHER == table[idx], exactly
        t32 = torch.from_numpy(
            rng.standard_normal((TABLE_ROWS, 2)).astype(np.float32)).to(device)
        idx = torch.from_numpy(rng.integers(
            0, TABLE_ROWS, IDX_SHAPE, dtype=np.int32)).to(device)
        for name, t in (("gather_fp32", t32),
                        ("gather_bf16", t32.to(torch.bfloat16))):
            got, ref = hg.gather_rows(t, idx), hg.gather_rows_reference(t, idx)
            assert got.dtype == t.dtype and got.shape == (*IDX_SHAPE, 2)
            out[name] = float((got.float() - ref.float()).abs().max())
            assert torch.equal(got, ref), name

        # C: DENSE on level 3 of the bound-6 spec; equal to its plain version
        # bit for bit (the kernel's arithmetic) and to hashgrid_encode's
        # level-3 slice within 1e-5
        spec, table, _ = encode_case(8, seed, device)
        lv = spec.levels()[3]
        side = lv.resolution + 1
        assert not lv.use_hash and side == DENSE_SIDE, (lv, side)
        rows = table[lv.offset:lv.offset + lv.size].contiguous()
        x = torch.from_numpy(rng.random((DENSE_SAMPLES, 3),
                                        dtype=np.float32)).to(device)
        got = hg.dense_level_lookup(rows, x, lv.scale, side)
        out["dense"] = _scaled_err(
            got, hg.dense_level_lookup_reference(rows, x, lv.scale, side))
        out["dense_vs_encode_level3"] = _scaled_err(
            got, hg.hashgrid_encode_reference(table, x, spec)[:, 6:8])
        assert out["dense"] == 0.0 and out["dense_vs_encode_level3"] <= 1e-5

        # D: ENCODE at the full spec, ~2 % of the points out of bound
        spec, table, x = encode_case(n_encode, seed + 1, device)
        got = hg.hashgrid_encode(table, x, spec)
        ref = hg.hashgrid_encode_reference(table, x, spec)
        oob = ((x < 0) | (x > 1)).any(-1)
        out["encode"] = _scaled_err(got, ref)
        out["encode_oob_share"] = float(oob.float().mean())
        assert float(got[oob].abs().max()) == 0.0
        assert out["encode"] <= 1e-5, out
    return out


def _grid_sample_args(rows: torch.Tensor, x: torch.Tensor, scale: float,
                      side: int):
    """DENSE as one PyTorch call: trilinear `grid_sample` on the level's
    (side³, C) rows as a (1, C, z, y, x) volume, the node coordinate
    x·scale + 0.5 mapped to [−1, 1] (align_corners). The library yardstick
    only; it rounds the coordinates its own way."""
    c = rows.shape[1]
    vol = rows[:side ** 3].reshape(side, side, side, c).permute(
        3, 0, 1, 2)[None].contiguous()
    grid = ((x * scale + 0.5) * (2.0 / (side - 1)) - 1.0).reshape(
        1, 1, 1, -1, 3)
    return vol, grid


def bench(seed: int = 1) -> dict:
    """A–D on the card. Each entry: ms (CUDA events over back-to-back
    calls), the rate from it, and for the kernels device_ms (kernel time
    per call from a profiler trace)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    dev = "cuda"
    res = {}

    def run(tag, fn, n, unit, reps=20, device=False):
        ms = time_ms(fn, reps)
        res[tag] = {"ms": ms, unit: n / ms / 1e3}
        if device:
            res[tag]["device_ms"] = device_ms(fn)

    with torch.no_grad():
        t16 = torch.from_numpy(rng.standard_normal(
            (TABLE_ROWS, 2)).astype(np.float32)).to(dev).to(torch.bfloat16)
        idx = torch.from_numpy(rng.integers(
            0, TABLE_ROWS - 1, IDX_SHAPE, dtype=np.int32)).to(dev)
        gather = hg._library.entry("mnerf_hash_gather")
        stream = torch.cuda.current_stream().cuda_stream
        rcs = []
        for dtype, t in (("fp32", t16.float()), ("bf16", t16)):
            out = torch.empty((*idx.shape, 2), dtype=t.dtype, device=dev)
            bare = (t.data_ptr(), t.shape[0], 2, t.element_size(),
                    idx.data_ptr(), idx.numel(), out.data_ptr(),
                    t.get_device(), stream)
            fns = {f"A_torch_index_{dtype}": lambda: t[idx],
                   f"B_gather_{dtype}": lambda: hg.gather_rows(t, idx),
                   f"B_gather_bare_{dtype}":
                       lambda: rcs.append(gather(*bare)),
                   f"B_gather_plain_{dtype}":
                       lambda: hg.gather_rows_reference(t, idx)}
            per = per_call_ms(fns)
            for tag, fn in fns.items():
                res[tag] = {"ms": per[tag],
                            "M_rows_per_s": idx.numel() / per[tag] / 1e3}
                if tag[0] == "A" or tag == f"B_gather_{dtype}":
                    res[tag]["device_ms"] = device_ms(fn)
        assert not any(rcs), f"bare GATHER returned {set(rcs)}"
        hg.launches_gather += len(rcs)  # launched past the wrapper
        rows = torch.from_numpy(rng.standard_normal(
            (DENSE_SIDE ** 3, 2)).astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.random((DENSE_SAMPLES, 3),
                                        dtype=np.float32)).to(dev)
        vol, grid = _grid_sample_args(rows, x, DENSE_SCALE, DENSE_SIDE)

        def library():
            return F.grid_sample(vol, grid, mode="bilinear",
                                 align_corners=True)

        fns = {"C_dense": lambda: hg.dense_level_lookup(
                   rows, x, DENSE_SCALE, DENSE_SIDE),
               "C_dense_grid_sample": library}
        per = per_call_ms(fns)
        for tag, fn in fns.items():
            res[tag] = {"ms": per[tag],
                        "M_samples_per_s": DENSE_SAMPLES / per[tag] / 1e3,
                        "device_ms": device_ms(fn)}
        run("C_dense_plain", lambda: hg.dense_level_lookup_reference(
            rows, x, DENSE_SCALE, DENSE_SIDE), DENSE_SAMPLES,
            "M_samples_per_s", reps=3)
        res["C_dense_grid_sample"]["max_abs_diff"] = float(
            (library().reshape(2, -1).t() - hg.dense_level_lookup(
                rows, x, DENSE_SCALE, DENSE_SIDE)).abs().max())
        spec, table, x = encode_case(PATH_POINTS, seed, dev, oob_share=0.0)
        run("D_encode", lambda: hg.hashgrid_encode(table, x, spec),
            PATH_POINTS, "M_samples_per_s", device=True)
        run("D_encode_plain", lambda: hg.hashgrid_encode_reference(
            table, x, spec), PATH_POINTS, "M_samples_per_s", reps=3)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the parity part on the CPU (plain versions)")
    ap.add_argument("--skip_parity", action="store_true")
    ap.add_argument("--skip_bench", action="store_true")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --cpu for the parity "
                         "part on the CPU")
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"device: {name}")
    result = {"device": device}
    if not args.skip_parity:
        # the path's point count on the card; on the CPU the plain versions
        # take ~40 µs a point, so a few thousand points
        n = PATH_POINTS if device == "cuda" else 4096
        result["parity"] = parity(device, n)
        print("parity (max abs error, scaled above 1): " + ", ".join(
            f"{k} {v:.3e}" for k, v in result["parity"].items()))
    if not args.skip_bench:
        if device == "cpu":
            print("timing: not measured (no card)")
        else:
            result["bench"] = bench()
            for k, v in result["bench"].items():
                dev = (f" (device {v['device_ms']:.4f} ms)"
                       if "device_ms" in v else "")
                rate = ", ".join(f"{u} {x:.3g}" for u, x in v.items()
                                 if "ms" not in u)
                print(f"{k:22s}: {v['ms']:.4f} ms{dev}, {rate}")
    return result


if __name__ == "__main__":
    main()
