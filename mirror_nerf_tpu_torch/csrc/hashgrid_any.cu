// The hash-grid encoder for every `HashGridSpec` (sm_90a): ENCODE, BWD and
// BWD2 for any input_dim D in 1..7, any level_dim C, align_corners, linear
// or smoothstep interpolation, any number of levels, hashed or tiled.
//
// A GPU addition, as csrc/hashgrid.cu's ENCODE, BWD and BWD2 are: it
// replaces XLA's gathers and autodiff (scatter-adds, grad-of-grad) of
// mirror_nerf_tpu/ops/hashgrid.py:137 `hashgrid_encode`, over the range of
// specs that function takes (`HashGridSpec`, :51-62; D ≤ 7, the length of
// `_PRIMES`, :37). The tuned kernels of csrc/hashgrid.cu stay the route for
// the hash-grid model's spec (3-d, C = 2, linear, align_corners off, ≤ 32
// levels; ops/hashgrid.py routes it there); every other spec runs here.
//
// Per level of a point x ∈ [0, 1]^D (a point outside gets zero features,
// adds nothing and gets zero gradients), with the fp32 scale s:
//   pos_d = x_d·s + (align_corners ? 0 : 0.5), one FMA, as XLA contracts it
//   g_d = floor(pos_d), t_d = pos_d − g_d, S_d = t_d, or with smoothstep
//     (t·t)·(3 − 2t), S' = 6t·(1 − t), S'' = 6 − 12t
//   corner c (bit d: +1 along axis d): f_d = S_d or 1 − S_d, w_c = Π_d f_d
//     (in axis order); its row: the uint32 xor of (g_d + bit)·prime_d for
//     a hashed level, else Σ (g_d + bit)·stride_d, modulo the level size
//   ENCODE  y[k] = Σ_c w_c T[row_c][k]
//   BWD     d_table[row_c] += w_c·dy_l; dx_d = Σ_l s Σ_c ∂w_c/∂t_d ⟨T_c, dy_l⟩,
//           ∂w_c/∂t_d = ±S'_d Π_{e≠d} f_e
//   BWD2    (the cotangent g of dx) u_c = s Σ_d g_d ∂w_c/∂t_d;
//           d_dy_l = Σ_c u_c T_c; d_table[row_c] += u_c·dy_l;
//           d_x_d = Σ_l s² Σ_c ⟨T_c, dy_l⟩ (Σ_{e≠d} g_e ∂²w_c/∂t_d∂t_e
//             + g_d ±S''_d Π_{e≠d} f_e): smoothstep's diagonal term, which
//           the linear weights lack
//
// What bounds them on the H100: the gathers, 2^D row loads of C·4 bytes a
// (point, level), and for BWD and BWD2 as many reductions into L2; at 7-d,
// where the table fits in L2, the work of the corners. ENCODE, BWD and
// BWD2:
//   * corners by trees over the axes (`Walk`): per (point, level) and axis
//     the two factors 1 − S_d, S_d and the two row terms (g_d + b)·prime_d
//     (hashed) or (g_d + b)·stride_d (dense), once; the 2^D weights by
//     doubling, w·f_d in axis order (the plain version's product order, so
//     the weights are the same bits), the rows the same way by xor or add
//     (ENCODE has an instance for each, BWD and BWD2 choose at run time:
//     `Rows`).
//     The walk is depth first and two trees at once, the two halves of
//     axis 0, so that a leaf holds corners c and c + 1, an x-pair, and the
//     registers hold D levels of the walk, not 2^D corners; its last
//     WALK_AXES axes are unrolled and the ones above them a run-time loop
//     (`walk_fwd`, `walk_bwd`), so the code holds at most 8 leaves for any
//     D (the whole walk unrolled took minutes of nvcc);
//   * a row's index reduced by a per-level rule the wrapper packs
//     (`index_of`, ops/hashgrid.py `index_rule`): a mask where the size is a
//     power of two (every hashed level), min(i, i − size) where the index
//     stays below twice the size (a dense level with align_corners reaches
//     its size at x = 1), a true modulo only where neither holds;
//   * a corner's row as one 4-, 8- or 16-B load (C 1, 2, 4; above, 16-B
//     chunks of one walk for up to 8 features); where C ≤ 2 and both rows
//     of the x-pair lie in one 16-B block of the table, one 16-B load for
//     both. A table not aligned for them takes narrower loads in the same
//     kernel;
//   * ENCODE: level-major. The grid is level groups outer, point tiles
//     inner, so the blocks in flight gather from one group's rows; a group
//     is G levels with G·C·4 ≤ 32 bytes (at most 2¹⁹·32 B = 16 MB), a warp
//     32 consecutive points of one level, and a block's features are staged
//     in shared memory and stored as whole 32-B sectors of the (N, L·C)
//     output;
//   * BWD: a block of BWD_TILE consecutive points, a thread a point that
//     walks the levels in order, so that a warp holds 32 consecutive points
//     of one level at each step, dx is summed in registers in level order
//     (no atomics, no scratch: the entry keeps its arguments), and the
//     blocks, resident together at the sizes BWD takes, send their
//     reductions into one level's rows at a time. A run of lanes in one cell
//     sums its corners by segmented shuffles and its first lane sends one
//     no-return vector reduction a corner (8 B at C 2, 16 B at C 4), or one
//     of 16 B for the x-pair where both rows lie in one 16-B block; a level
//     whose grads fit SHARED_FLOATS and whose rows are fewer than a block's
//     corners (a coarse dense level) is summed in shared memory and flushed
//     once a block (ops/hashgrid.py `any_reduction_plan` is the plan);
//   * BWD2: BWD's block, lanes, runs and reductions, its table grads u_c·dy_l
//     sent as BWD sends w_c·dy_l. The trees' nodes also carry the tangent
//     v = Σ_d g_d ∂w/∂t_d (u_c = s·v_c; `Walk2`: v' = v·f + w·τ, τ = ±g_d
//     S'_d), and for d_x the reverse of both trees sums per axis the
//     adjoints of the factors and of the tangent terms (forward mode over
//     reverse mode: the mixed second derivatives and smoothstep's diagonal
//     one, with no per-corner products over the axes); an instance without
//     d_x walks forward only. A corner's row is loaded once for d_dy and
//     the dot; d_dy_l is summed in registers and written once a (point,
//     level), through shared memory where a block's rows fit, so that the
//     block's contiguous run of d_dy leaves in whole sectors.
// D is a template parameter, C too for 1 and 2 (and 4 in BWD and BWD2; any
// other C runs in chunks of four features); align_corners and smoothstep
// are run-time.
// Times on an NVIDIA H100 (chip_smoke.py phase 23, PERF.md §6 rows 9g–9i).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "launch.cuh"

namespace {

constexpr int MAX_D = 7;
constexpr unsigned FULL = 0xffffffffu;
// ENCODE's block: 8 warps, G levels × 256/G points
constexpr int ENC_THREADS = 256;
constexpr int ENC_WARPS = ENC_THREADS / 32;
// BWD's block: BWD_TILE consecutive points, a thread a point
constexpr int BWD_TILE = 128;
// BWD's shared-memory levels hold at most this many floats of grads
constexpr int SHARED_FLOATS = 2048;
// BWD2 stages a block's d_dy rows where they fit this many floats (with
// the static SHARED_FLOATS, 48 KB a block)
constexpr int STAGE_FLOATS = 10240;
// LevelAny.flags
constexpr unsigned FLAG_MODULO = 1u;  // the index needs a true modulo
constexpr unsigned FLAG_SHARED = 2u;  // BWD sums the level in shared memory
// the kernels' alignment flags (bits of `vec`)
constexpr int TABLE_8 = 1, TABLE_16 = 2, DY_8 = 4, DY_16 = 8, GRADS_16 = 16;

// the reference's spatial-hash primes (gridencoder.cu:55-56)
__constant__ unsigned PRIMES[MAX_D] = {1u,          2654435761u, 805459861u,
                                       3674653429u, 2097192037u, 1434869437u,
                                       2165219737u};

// One level as ops/hashgrid.py `_level_table_any` packs it: 16 int32 words.
struct LevelAny {
  unsigned offset;         // first row of the level in the table
  unsigned size;           // rows of the level
  float scale;             // fp32 2^(l·S)·H − 1
  int use_hash;
  unsigned stride[MAX_D];  // dense strides (0 past the level size)
  unsigned msk, sub;       // the index rule: min(i & msk, (i & msk) − sub)
  unsigned flags;          // FLAG_MODULO, FLAG_SHARED
  unsigned mod_lo, mod_hi; // FLAG_MODULO: ⌈2⁶⁴ / size⌉
};
static_assert(sizeof(LevelAny) == 64, "LevelAny is 16 words");

__device__ __forceinline__ LevelAny load_level_any(
    const LevelAny* __restrict__ levels, int l) {
  const uint4* w = reinterpret_cast<const uint4*>(levels + l);
  uint4 q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __ldg(w + i);
  LevelAny L;
  memcpy(&L, q, sizeof(L));
  return L;
}

__device__ __forceinline__ bool in_unit_box(const float* x, int d) {
  for (int i = 0; i < d; ++i)
    if (x[i] < 0.f || x[i] > 1.f) return false;
  return true;
}

// ---- ENCODE's and BWD's device functions ----

// One level of one point, per axis: the factors f[b][d] (1 − S_d for b = 0,
// S_d for b = 1), the row terms t[b][d] = (g_d + b)·m_d in uint32 (m_d the
// prime or the dense stride), the cell g_d and S'_d.
template <int D>
struct Axes {
  float f[2][D];
  unsigned t[2][D];
  unsigned g[D];
  float s1[D];
  bool hash;  // the level is hashed (the rows combine by xor)
};

// How a kernel instance combines the row terms: every level dense, every
// level hashed (ENCODE takes one of the two a level), or either, chosen at
// run time by the level (BWD: half the code, the same times).
enum Rows { DENSE, HASHED, EITHER };

template <int D, int ROWS>
__device__ __forceinline__ void axes_of(const LevelAny& L, const float* x,
                                        float off, bool smooth, Axes<D>& a) {
  a.hash = L.use_hash;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float p = __fmaf_rn(x[d], L.scale, off);
    const float fl = floorf(p);
    const float t = __fsub_rn(p, fl);
    const unsigned g = (unsigned)(int)fl;
    float s = t, s1 = 1.f;
    if (smooth) {
      s = __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.f, __fmul_rn(2.f, t)));
      s1 = __fmul_rn(__fmul_rn(6.f, t), __fsub_rn(1.f, t));
    }
    a.f[0][d] = __fsub_rn(1.f, s);
    a.f[1][d] = s;
    a.s1[d] = s1;
    a.g[d] = g;
    const unsigned m =
        (ROWS == EITHER ? a.hash : ROWS == HASHED) ? PRIMES[d] : L.stride[d];
    a.t[0][d] = g * m;
    a.t[1][d] = (g + 1u) * m;
  }
}

template <int ROWS>
__device__ __forceinline__ unsigned combine(unsigned r, unsigned t,
                                            bool hash) {
  return (ROWS == EITHER ? hash : ROWS == HASHED) ? (r ^ t) : (r + t);
}

// A corner's uint32 index → its row in the level (ops/hashgrid.py
// `index_rule`): a mask (msk = size − 1, sub = 0), min(i, i − size) in
// uint32 (sub = size: i < 2·size), nothing (msk = ~0, sub = 0), or a
// modulo, i − ⌊i·M / 2⁶⁴⌋·size with M = ⌈2⁶⁴ / size⌉ (exact for 32-bit i:
// no division in the kernel).
__device__ __forceinline__ unsigned index_of(const LevelAny& L, unsigned r) {
  unsigned i = r & L.msk;
  i = min(i, i - L.sub);
  if (L.flags & FLAG_MODULO) {
    const unsigned long long m =
        ((unsigned long long)L.mod_hi << 32) | L.mod_lo;
    i -= (unsigned)__umul64hi(i, m) * L.size;
  }
  return i;
}

// The corners of one (point, level) by two trees over the axes at once: the
// walk below axis 0 carries the prefix weights (wa, wb) and rows (ra, rb) of
// the two halves (bit 0 clear, bit 0 set), one axis a depth, both children
// in order; at depth D `leaf(wa, wb, ra, rb)` takes corners c and c + 1.
// `bwd` also runs the tree's reverse: a leaf returns (dot_a, dot_b), a node
// returns Σ_leaves Π_{e ≥ d} f_e · dot for each half, and gf[b][d] sums
// Π_{e ≠ d} f_e · dot over the corners with bit d = b (∂/∂f_d(b) of
// Σ_c w_c dot_c).
template <int D, int d, int ROWS>
struct Walk {
  template <class Leaf>
  static __device__ __forceinline__ void fwd(const Axes<D>& a, float wa,
                                             float wb, unsigned ra,
                                             unsigned rb, Leaf& leaf) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
      Walk<D, d + 1, ROWS>::fwd(a, __fmul_rn(wa, a.f[b][d]),
                                __fmul_rn(wb, a.f[b][d]),
                                combine<ROWS>(ra, a.t[b][d], a.hash),
                                combine<ROWS>(rb, a.t[b][d], a.hash), leaf);
  }
  template <class Leaf>
  static __device__ __forceinline__ float2 bwd(const Axes<D>& a, float wa,
                                               float wb, unsigned ra,
                                               unsigned rb,
                                               float (&gf)[2][D],
                                               Leaf& leaf) {
    float2 adj[2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
      adj[b] = Walk<D, d + 1, ROWS>::bwd(a, __fmul_rn(wa, a.f[b][d]),
                                         __fmul_rn(wb, a.f[b][d]),
                                         combine<ROWS>(ra, a.t[b][d], a.hash),
                                         combine<ROWS>(rb, a.t[b][d], a.hash), gf,
                                         leaf);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      gf[b][d] = fmaf(wa, adj[b].x, fmaf(wb, adj[b].y, gf[b][d]));
    return make_float2(fmaf(a.f[0][d], adj[0].x, a.f[1][d] * adj[1].x),
                       fmaf(a.f[0][d], adj[0].y, a.f[1][d] * adj[1].y));
  }
};

template <int D, int ROWS>
struct Walk<D, D, ROWS> {
  template <class Leaf>
  static __device__ __forceinline__ void fwd(const Axes<D>&, float wa,
                                             float wb, unsigned ra,
                                             unsigned rb, Leaf& leaf) {
    leaf(wa, wb, ra, rb);
  }
  template <class Leaf>
  static __device__ __forceinline__ float2 bwd(const Axes<D>&, float wa,
                                               float wb, unsigned ra,
                                               unsigned rb, float (&)[2][D],
                                               Leaf& leaf) {
    return leaf(wa, wb, ra, rb);
  }
};

// The loop over the top axes: a (point, level) walks axes 1 … T_D by a
// run-time loop over their 2^T_D paths, each recomputing its prefix (the
// same products in axis order) and walking the last WALK_AXES axes
// unrolled, so a kernel holds 2^WALK_AXES leaves of code whatever D.
constexpr int WALK_AXES = 3;
template <int D>
__host__ __device__ constexpr int top_axes() {
  return D - 1 > WALK_AXES ? D - 1 - WALK_AXES : 0;
}

template <int D, int ROWS, class Leaf>
__device__ __forceinline__ void walk_fwd(const Axes<D>& a, Leaf& leaf) {
  constexpr int T = top_axes<D>();
#pragma unroll 1
  for (unsigned j = 0; j < (1u << T); ++j) {
    float wa = a.f[0][0], wb = a.f[1][0];
    unsigned ra = a.t[0][0], rb = a.t[1][0];
#pragma unroll
    for (int d = 1; d <= T; ++d) {
      const bool b = (j >> (d - 1)) & 1u;
      const float f = b ? a.f[1][d] : a.f[0][d];
      const unsigned t = b ? a.t[1][d] : a.t[0][d];
      wa = __fmul_rn(wa, f);
      wb = __fmul_rn(wb, f);
      ra = combine<ROWS>(ra, t, a.hash);
      rb = combine<ROWS>(rb, t, a.hash);
    }
    Walk<D, T + 1, ROWS>::fwd(a, wa, wb, ra, rb, leaf);
  }
}

// The same walk with the reverse: gf[b][d] += ∂/∂f_d(b) of Σ_c w_c dot_c.
// A top axis d of a path takes Π_{e ≠ d} of the path's top factors times
// f_0(0)·adj_a + f_0(1)·adj_b (the adjoints of the path's two subtrees);
// axis 0 takes Π of the top factors times adj_a or adj_b.
template <int D, int ROWS, class Leaf>
__device__ __forceinline__ void walk_bwd(const Axes<D>& a,
                                         float (&gf)[2][D], Leaf& leaf) {
  constexpr int T = top_axes<D>();
#pragma unroll 1
  for (unsigned j = 0; j < (1u << T); ++j) {
    float ft[T + 2];
    float wa = a.f[0][0], wb = a.f[1][0];
    unsigned ra = a.t[0][0], rb = a.t[1][0];
#pragma unroll
    for (int d = 1; d <= T; ++d) {
      const bool b = (j >> (d - 1)) & 1u;
      ft[d] = b ? a.f[1][d] : a.f[0][d];
      const unsigned t = b ? a.t[1][d] : a.t[0][d];
      wa = __fmul_rn(wa, ft[d]);
      wb = __fmul_rn(wb, ft[d]);
      ra = combine<ROWS>(ra, t, a.hash);
      rb = combine<ROWS>(rb, t, a.hash);
    }
    const float2 adj = Walk<D, T + 1, ROWS>::bwd(a, wa, wb, ra, rb, gf, leaf);
    float suf[T + 2];  // suf[d] = Π_{e ≥ d} of the path's top factors
    suf[T + 1] = 1.f;
#pragma unroll
    for (int d = T; d >= 1; --d) suf[d] = ft[d] * suf[d + 1];
    const float both = fmaf(a.f[0][0], adj.x, a.f[1][0] * adj.y);
    float pre = 1.f;
#pragma unroll
    for (int d = 1; d <= T; ++d) {
      const float v = pre * suf[d + 1] * both;
      if ((j >> (d - 1)) & 1u)
        gf[1][d] += v;
      else
        gf[0][d] += v;
      pre *= ft[d];
    }
    gf[0][0] = fmaf(suf[1], adj.x, gf[0][0]);
    gf[1][0] = fmaf(suf[1], adj.y, gf[1][0]);
  }
}

// v's float number i mod 4
__device__ __forceinline__ float lane_of(const float4& v, unsigned i) {
  return (i & 2u) ? ((i & 1u) ? v.w : v.z) : ((i & 1u) ? v.y : v.x);
}

// Rows a and b (level-relative) of an x-pair from the level's first row
// `base` (C = CV floats a row): one 16-B load where both lie in one block
// of 16 B ({2k, 2k + 1} at C 2; 1 ≤ a ^ b ≤ 3 at C 1, as for 3 of 4 cells
// of a hashed level, whose axis-0 prime is 1) and the table allows it, else
// one load a row (4 or 8 B; a float each where the table is not 16-B
// aligned at C 2).
template <int CV>
__device__ __forceinline__ void load_pair(const float* __restrict__ base,
                                          unsigned a, unsigned b, int vec,
                                          float (&va)[CV], float (&vb)[CV]) {
  static_assert(CV == 1 || CV == 2, "rows of 1 or 2 floats");
  const bool pair = (a ^ b) == 1u;
  const bool hi = a & 1u;
  if constexpr (CV == 1) {
    if ((a ^ b) - 1u < 3u && (vec & TABLE_16)) {
      // both rows in one aligned block of four
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(base + (a & ~3u)));
      va[0] = lane_of(v, a);
      vb[0] = lane_of(v, b);
    } else if (pair && (vec & TABLE_8)) {
      const float2 v =
          __ldg(reinterpret_cast<const float2*>(base + (a & ~1u)));
      va[0] = hi ? v.y : v.x;
      vb[0] = hi ? v.x : v.y;
    } else {
      va[0] = __ldg(base + a);
      vb[0] = __ldg(base + b);
    }
  } else if (vec & TABLE_16) {
    if (pair) {
      const float4 v = __ldg(
          reinterpret_cast<const float4*>(base + 2 * (size_t)(a & ~1u)));
      va[0] = hi ? v.z : v.x;
      va[1] = hi ? v.w : v.y;
      vb[0] = hi ? v.x : v.z;
      vb[1] = hi ? v.y : v.w;
    } else {
      const float2 u = __ldg(reinterpret_cast<const float2*>(base) + a);
      const float2 v = __ldg(reinterpret_cast<const float2*>(base) + b);
      va[0] = u.x, va[1] = u.y;
      vb[0] = v.x, vb[1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      va[k] = __ldg(base + 2 * (size_t)a + k);
      vb[k] = __ldg(base + 2 * (size_t)b + k);
    }
  }
}

// Features k0 … k0 + 3 (those below C) of the row at `row`: one 16-B load
// where C is a multiple of 4 and the table 16-B aligned, else a float each.
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ row,
                                             int k0, int C, bool vec4) {
  if (vec4) return __ldg(reinterpret_cast<const float4*>(row + k0));
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k0 + k < C ? __ldg(row + k0 + k) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// ENCODE of one (point, level): acc[k] = y[kb + k] for the features of a
// block (CV of them, or for CV = 0 up to 8 from kb, in chunks of four).
template <int D, int CV, int ROWS>
__device__ __forceinline__ void encode_level(
    const LevelAny& L, const float* __restrict__ table, const float* xp,
    float off, bool smooth, int vec, int C, int kb,
    float (&acc)[CV ? CV : 8]) {
  Axes<D> a;
  axes_of<D, ROWS>(L, xp, off, smooth, a);
  const float* base = table + (size_t)L.offset * C;
#pragma unroll
  for (int k = 0; k < (CV ? CV : 8); ++k) acc[k] = 0.f;
  if constexpr (CV > 0) {
    auto leaf = [&](float wa, float wb, unsigned ra, unsigned rb) {
      float va[CV], vb[CV];
      load_pair<CV>(base, index_of(L, ra), index_of(L, rb), vec, va, vb);
#pragma unroll
      for (int k = 0; k < CV; ++k)
        acc[k] = fmaf(wb, vb[k], fmaf(wa, va[k], acc[k]));
    };
    walk_fwd<D, ROWS>(a, leaf);
  } else {
    const bool vec4 = (C & 3) == 0 && (vec & TABLE_16);
    auto leaf = [&](float wa, float wb, unsigned ra, unsigned rb) {
      const float* rowa = base + (size_t)index_of(L, ra) * C + kb;
      const float* rowb = base + (size_t)index_of(L, rb) * C + kb;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (kb + 4 * ch >= C) break;
        const float4 u = load_chunk(rowa, 4 * ch, C - kb, vec4);
        const float4 v = load_chunk(rowb, 4 * ch, C - kb, vec4);
        float* s = acc + 4 * ch;
        s[0] = fmaf(wb, v.x, fmaf(wa, u.x, s[0]));
        s[1] = fmaf(wb, v.y, fmaf(wa, u.y, s[1]));
        s[2] = fmaf(wb, v.z, fmaf(wa, u.z, s[2]));
        s[3] = fmaf(wb, v.w, fmaf(wa, u.w, s[3]));
      }
    };
    walk_fwd<D, ROWS>(a, leaf);
  }
}

// ENCODE, level-major: block b takes level group b / tiles (G levels) and
// point tile b % tiles (256/G points); warp w level w / (8/G) of the group,
// 32 consecutive points. With G > 1 (C ≤ 4) the block's features go
// through shared memory and leave as the tile's whole (point, group) runs
// of G·C floats; out (N, L·C).
template <int D, int CV>
__global__ void __launch_bounds__(ENC_THREADS)
    encode_any_kernel(const float* __restrict__ x,
                      const float* __restrict__ table,
                      const LevelAny* __restrict__ levels, int n_levels,
                      int C, long long n, float off, int smooth, int vec,
                      int G, unsigned tiles, float* __restrict__ out) {
  __shared__ float stage[ENC_THREADS * 4];
  constexpr int KA = CV ? CV : 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned group = blockIdx.x / tiles;
  const long long tile = blockIdx.x - group * tiles;
  const int wpl = ENC_WARPS / G;  // warps a level
  const int P = 32 * wpl;         // points a block
  const int l0 = (int)group * G;
  const int ge = min(G, n_levels - l0);  // levels in this group
  const int gi = warp / wpl;
  const int q = (warp - gi * wpl) * 32 + lane;
  const long long p = tile * P + q;
  const long long lc = (long long)n_levels * C;
  if (gi < ge && p < n) {
    float xp[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xp[d] = __ldg(x + D * p + d);
    const bool live = in_unit_box(xp, D);
    const LevelAny L = load_level_any(levels, l0 + gi);
    for (int kb = 0; kb < C; kb += KA) {
      float acc[KA];
      if (!live) {
#pragma unroll
        for (int k = 0; k < KA; ++k) acc[k] = 0.f;
      } else if (L.use_hash) {
        encode_level<D, CV, HASHED>(L, table, xp, off, smooth, vec, C, kb,
                                  acc);
      } else {
        encode_level<D, CV, DENSE>(L, table, xp, off, smooth, vec, C, kb,
                                   acc);
      }
      const int nk = min(KA, C - kb);
      if (G > 1) {
        float* s = stage + (q * ge + gi) * C + kb;
#pragma unroll
        for (int k = 0; k < KA; ++k)
          if (k < nk) s[k] = acc[k];
      } else {
        float* y = out + p * lc + (long long)l0 * C + kb;
#pragma unroll
        for (int k = 0; k < KA; ++k)
          if (k < nk) y[k] = acc[k];
      }
    }
  }
  if (G > 1) {
    __syncthreads();
    const int seg = ge * C;
    for (int i = threadIdx.x; i < P * seg; i += ENC_THREADS) {
      const int qq = i / seg;
      const long long pp = tile * P + qq;
      if (pp < n) out[pp * lc + (long long)l0 * C + (i - qq * seg)] = stage[i];
    }
  }
}

// One BWD table-grad reduction of an x-pair's values va, vb (CV floats) at
// level-relative rows a, b of `grads` (the level's first row of d_table):
// one 16-B reduction where both lie in one block of 16 B ({2k, 2k + 1} at
// C 2; 1 ≤ a ^ b ≤ 3 at C 1, the other two floats zero), else one a row
// (4 or 8 B), scalar where d_table is not 16-B aligned.
template <int CV>
__device__ __forceinline__ void red_pair(float* __restrict__ grads,
                                         unsigned a, unsigned b, int vec,
                                         const float (&va)[CV],
                                         const float (&vb)[CV]) {
  static_assert(CV == 1 || CV == 2, "rows of 1 or 2 floats");
  const bool wide = vec & GRADS_16;
  if constexpr (CV == 1) {
    if (wide && (a ^ b) - 1u < 3u) {
      // one 16-B reduction of the aligned block of four holding both
      float v[4];
#pragma unroll
      for (unsigned k = 0; k < 4; ++k)
        v[k] = (a & 3u) == k ? va[0] : ((b & 3u) == k ? vb[0] : 0.f);
      atomicAdd(reinterpret_cast<float4*>(grads + (a & ~3u)),
                make_float4(v[0], v[1], v[2], v[3]));
    } else {
      atomicAdd(grads + a, va[0]);
      atomicAdd(grads + b, vb[0]);
    }
  } else {
    if (wide && (a ^ b) == 1u) {
      atomicAdd(reinterpret_cast<float4*>(grads + 2 * (size_t)(a & ~1u)),
                (a & 1u) ? make_float4(vb[0], vb[1], va[0], va[1])
                         : make_float4(va[0], va[1], vb[0], vb[1]));
    } else if (wide) {
      atomicAdd(reinterpret_cast<float2*>(grads) + a,
                make_float2(va[0], va[1]));
      atomicAdd(reinterpret_cast<float2*>(grads) + b,
                make_float2(vb[0], vb[1]));
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        atomicAdd(grads + 2 * (size_t)a + k, va[k]);
        atomicAdd(grads + 2 * (size_t)b + k, vb[k]);
      }
    }
  }
}

// What one BWD or BWD2 level step needs besides the point.
struct BwdLevel {
  const float* base;  // the level's first table row
  float* grads;       // its first d_table row (null: no table grads)
  float* shared;      // the block's shared-memory grads (shared level)
  int vec, C;
  bool load_rows;     // the corners' table rows are read (BWD: dx; BWD2:
                      // d_dy or d_x)
};

// A warp's runs at one level: a lane and the following lanes of its warp
// that are live and in the same cell share all 2^D rows. `head`: the run's
// first lane (a lane that is not live is a run of its own), which sends its
// sums; `end`: one past the run's last lane; `longest`: the warp's longest
// run. Every lane of the warp calls it.
struct Runs {
  bool head;
  int end;
  unsigned longest;
};

template <int D>
__device__ __forceinline__ Runs runs_of(const Axes<D>& a, bool live) {
  const int lane = threadIdx.x & 31;
  const int qlive = __shfl_up_sync(FULL, (int)live, 1);
  bool head = lane == 0 || !live || !qlive;
#pragma unroll
  for (int d = 0; d < D; ++d)
    head = (__shfl_up_sync(FULL, a.g[d], 1) != a.g[d]) || head;
  const unsigned later = __ballot_sync(FULL, head) & (0xFFFFFFFEu << lane);
  const int end = later ? __ffs(later) - 1 : 32;
  return {head, end, __reduce_max_sync(FULL, (unsigned)(end - lane))};
}

// dy's features k0 … k0 + K − 1 of one (point, level), zero past C and for
// a lane that is not live: one 8- or 16-B load where dy allows it.
template <int CV, int K>
__device__ __forceinline__ void load_dy(const float* __restrict__ dyl, int k0,
                                        int C, int vec, bool live,
                                        float (&g)[K]) {
  if constexpr (CV == 2) {
    float2 u = make_float2(0.f, 0.f);
    if (live)
      u = (vec & DY_8) ? __ldg(reinterpret_cast<const float2*>(dyl))
                       : make_float2(__ldg(dyl), __ldg(dyl + 1));
    g[0] = u.x;
    g[1] = u.y;
  } else if constexpr (CV == 0 || CV == 4) {
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) u = load_chunk(dyl, k0, C, (C & 3) == 0 && (vec & DY_16));
    g[0] = u.x, g[1] = u.y, g[2] = u.z, g[3] = u.w;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      g[k] = live && k0 + k < C ? __ldg(dyl + k0 + k) : 0.f;
  }
}

// An x-pair's table rows at level-relative rows ia, ib, features k0 … k0 +
// K − 1: `load_pair` for C 1, 2; else 16-B chunks or a float each.
template <int CV, int K>
__device__ __forceinline__ void load_rows(const float* __restrict__ base,
                                          unsigned ia, unsigned ib, int k0,
                                          int C, int vec, float (&ta)[K],
                                          float (&tb)[K]) {
  if constexpr (CV == 1 || CV == 2) {
    load_pair<CV>(base, ia, ib, vec, ta, tb);
  } else {
    const bool t4 = (C & 3) == 0 && (vec & TABLE_16);
    const float4 u = load_chunk(base + (size_t)ia * C, k0, C, t4);
    const float4 v = load_chunk(base + (size_t)ib * C, k0, C, t4);
    ta[0] = u.x, ta[1] = u.y, ta[2] = u.z, ta[3] = u.w;
    tb[0] = v.x, tb[1] = v.y, tb[2] = v.z, tb[3] = v.w;
  }
}

// An x-pair's table grads va, vb (features k0 … k0 + K − 1) at
// level-relative rows ia, ib: shared-memory atomics on a shared level, else
// summed over the lane's run by segmented shuffles and sent by its first
// lane (`red_pair` for C 1, 2; a 16-B reduction a row where C is a multiple
// of 4 and d_table 16-B aligned; else a float each). Every lane of the warp
// calls it; a lane that is not live sends nothing.
template <int CV, int K>
__device__ __forceinline__ void send_grads(const BwdLevel& B, const Runs& R,
                                           bool live, unsigned ia,
                                           unsigned ib, int k0, int C,
                                           float (&va)[K], float (&vb)[K]) {
  if (B.shared) {
    if (live) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k0 + k >= C) break;
        atomicAdd(B.shared + (size_t)ia * C + k0 + k, va[k]);
        atomicAdd(B.shared + (size_t)ib * C + k0 + k, vb[k]);
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (unsigned o = 1; o < R.longest; o <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float sa = __shfl_down_sync(FULL, va[k], o);
      const float sb = __shfl_down_sync(FULL, vb[k], o);
      if (lane + (int)o < R.end) {
        va[k] += sa;
        vb[k] += sb;
      }
    }
  }
  if (!(R.head && live)) return;
  if constexpr (CV == 1 || CV == 2) {
    red_pair<CV>(B.grads, ia, ib, B.vec, va, vb);
  } else {
    float* pa = B.grads + (size_t)ia * C + k0;
    float* pb = B.grads + (size_t)ib * C + k0;
    if ((C & 3) == 0 && (B.vec & GRADS_16)) {
      atomicAdd(reinterpret_cast<float4*>(pa),
                make_float4(va[0], va[1], va[2], va[3]));
      atomicAdd(reinterpret_cast<float4*>(pb),
                make_float4(vb[0], vb[1], vb[2], vb[3]));
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k0 + k >= C) break;
        atomicAdd(pa + k, va[k]);
        atomicAdd(pb + k, vb[k]);
      }
    }
  }
}

// One BWD level of one point: the table grads of its corners
// (`send_grads`) and gl[d] = S'_d (gf[1][d] − gf[0][d]), the level's
// ∂/∂t_d of Σ_c w_c ⟨T_c, dy⟩. Every lane of the warp runs it (the
// shuffles); a lane that is not live sends and loads nothing. K = CV
// features of dy at a time (CV = 0: chunks of four from k0).
template <int D, int CV, int ROWS>
__device__ __forceinline__ void bwd_level(const LevelAny& L,
                                          const BwdLevel& B, const float* xp,
                                          float off, bool smooth, bool live,
                                          const float* __restrict__ dyl,
                                          float (&gl)[D]) {
  constexpr int K = CV ? CV : 4;
  const int lane = threadIdx.x & 31;
  Axes<D> a;
  axes_of<D, ROWS>(L, xp, off, smooth, a);
  Runs R{true, lane + 1, 1u};
  if (B.grads && !B.shared) R = runs_of<D>(a, live);
  float gf[2][D];
#pragma unroll
  for (int d = 0; d < D; ++d) gf[0][d] = gf[1][d] = 0.f;
  const int C = CV ? CV : B.C;
  for (int k0 = 0; k0 < C; k0 += K) {
    float g[K];
    load_dy<CV, K>(dyl, k0, C, B.vec, live, g);
    auto leaf = [&](float wa, float wb, unsigned ra, unsigned rb) {
      const unsigned ia = index_of(L, ra), ib = index_of(L, rb);
      if (B.grads) {
        float va[K], vb[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          va[k] = wa * g[k];
          vb[k] = wb * g[k];
        }
        send_grads<CV, K>(B, R, live, ia, ib, k0, C, va, vb);
      }
      float2 dot = make_float2(0.f, 0.f);
      if (B.load_rows && live) {
        float ta[K], tb[K];
        load_rows<CV, K>(B.base, ia, ib, k0, C, B.vec, ta, tb);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dot.x = fmaf(ta[k], g[k], dot.x);
          dot.y = fmaf(tb[k], g[k], dot.y);
        }
      }
      return dot;
    };
    walk_bwd<D, ROWS>(a, gf, leaf);
  }
#pragma unroll
  for (int d = 0; d < D; ++d)
    gl[d] = live ? a.s1[d] * (gf[1][d] - gf[0][d]) : 0.f;
}

// BWD: a block of BWD_TILE consecutive points, a thread a point, its levels
// in order (the warps hold 32 consecutive points of one level at each
// step); dx summed in registers in level order.
template <int D, int CV>
__global__ void __launch_bounds__(BWD_TILE)
    bwd_any_kernel(const float* __restrict__ x,
                   const float* __restrict__ table,
                   const LevelAny* __restrict__ levels, int n_levels, int C,
                   long long n, float off, int smooth, int vec,
                   const float* __restrict__ dy, float* __restrict__ d_table,
                   float* __restrict__ dx) {
  __shared__ float shared[SHARED_FLOATS];
  const long long p = (long long)blockIdx.x * BWD_TILE + threadIdx.x;
  const bool inb = p < n;
  float xp[D], gx[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xp[d] = inb ? __ldg(x + D * p + d) : 0.f;
    gx[d] = 0.f;
  }
  const bool live = inb && in_unit_box(xp, D);
  const long long lc = (long long)n_levels * C;
  for (int l = 0; l < n_levels; ++l) {
    const LevelAny L = load_level_any(levels, l);
    const bool sh = d_table && (L.flags & FLAG_SHARED);
    const int cells = (int)L.size * C;
    if (sh) {
      for (int i = threadIdx.x; i < cells; i += BWD_TILE) shared[i] = 0.f;
      __syncthreads();
    }
    const BwdLevel B{table + (size_t)L.offset * C,
                     d_table ? d_table + (size_t)L.offset * C : nullptr,
                     sh ? shared : nullptr, vec, C, dx != nullptr};
    const float* dyl = dy + (inb ? p : 0) * lc + (long long)l * C;
    float gl[D];
    bwd_level<D, CV, EITHER>(L, B, xp, off, smooth, live, dyl, gl);
    if (sh) {
      __syncthreads();
      for (int i = threadIdx.x; i < cells; i += BWD_TILE) {
        const float v = shared[i];
        if (v != 0.f) atomicAdd(B.grads + i, v);
      }
      __syncthreads();
    }
#pragma unroll
    for (int d = 0; d < D; ++d) gx[d] += gl[d] * L.scale;
  }
  if (dx && inb) {
#pragma unroll
    for (int d = 0; d < D; ++d) dx[D * p + d] = gx[d];
  }
}

// BWD2's walk: the same two trees over the axes, each node also carrying
// its tangent v = Σ_d g_d ∂w/∂t_d. Along axis d with branch b a child takes
// w·f_b(d) and v·f_b(d) + w·τ_b(d), with τ_1(d) = g_d·S'_d and τ_0(d) =
// −τ_1(d) (`tau`: τ_1); the weights are ENCODE's products, in axis order.
// A leaf takes (v_a, v_b, r_a, r_b) of corners c and c + 1 (u_c = s·v_c).
// `bwd` also runs the reverse of both trees for Σ_c v_c·dot_c: a leaf
// returns the adjoints of its two v, the dots ⟨T_c, dy⟩ (a v's adjoint at a
// leaf; a w's is 0 there); a node returns the adjoints of its own (w, v),
// both halves, and adds to gf[d] and ga[d] the sums over its two children
// of ∂/∂f_b(d) and ∂/∂τ_b(d), branch 1 less branch 0: per child w·adj_w' +
// v·adj_v' and w·adj_v'.
struct Adj2 {
  float wa, wb, va, vb;
};

template <int D, int d, int ROWS>
struct Walk2 {
  template <class Leaf>
  static __device__ __forceinline__ void fwd(const Axes<D>& a,
                                             const float (&tau)[D], float wa,
                                             float wb, float va, float vb,
                                             unsigned ra, unsigned rb,
                                             Leaf& leaf) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float f = a.f[b][d], t = b ? tau[d] : -tau[d];
      Walk2<D, d + 1, ROWS>::fwd(
          a, tau, __fmul_rn(wa, f), __fmul_rn(wb, f), fmaf(wa, t, va * f),
          fmaf(wb, t, vb * f), combine<ROWS>(ra, a.t[b][d], a.hash),
          combine<ROWS>(rb, a.t[b][d], a.hash), leaf);
    }
  }
  template <class Leaf>
  static __device__ __forceinline__ Adj2 bwd(const Axes<D>& a,
                                             const float (&tau)[D], float wa,
                                             float wb, float va, float vb,
                                             unsigned ra, unsigned rb,
                                             float (&gf)[D], float (&ga)[D],
                                             Leaf& leaf) {
    Adj2 c[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float f = a.f[b][d], t = b ? tau[d] : -tau[d];
      c[b] = Walk2<D, d + 1, ROWS>::bwd(
          a, tau, __fmul_rn(wa, f), __fmul_rn(wb, f), fmaf(wa, t, va * f),
          fmaf(wb, t, vb * f), combine<ROWS>(ra, a.t[b][d], a.hash),
          combine<ROWS>(rb, a.t[b][d], a.hash), gf, ga, leaf);
    }
    const float f0 = a.f[0][d], f1 = a.f[1][d];
    const float dva = c[1].va - c[0].va, dvb = c[1].vb - c[0].vb;
    ga[d] = fmaf(wa, dva, fmaf(wb, dvb, ga[d]));
    Adj2 r;
    r.va = fmaf(f0, c[0].va, f1 * c[1].va);
    r.vb = fmaf(f0, c[0].vb, f1 * c[1].vb);
    if constexpr (d + 1 == D) {  // the children are leaves: adj_w' = 0
      gf[d] = fmaf(va, dva, fmaf(vb, dvb, gf[d]));
      r.wa = tau[d] * dva;
      r.wb = tau[d] * dvb;
    } else {
      const float dwa = c[1].wa - c[0].wa, dwb = c[1].wb - c[0].wb;
      gf[d] = fmaf(wa, dwa, fmaf(va, dva, fmaf(wb, dwb, fmaf(vb, dvb,
                                                              gf[d]))));
      r.wa = fmaf(tau[d], dva, fmaf(f0, c[0].wa, f1 * c[1].wa));
      r.wb = fmaf(tau[d], dvb, fmaf(f0, c[0].wb, f1 * c[1].wb));
    }
    return r;
  }
};

template <int D, int ROWS>
struct Walk2<D, D, ROWS> {
  template <class Leaf>
  static __device__ __forceinline__ void fwd(const Axes<D>&,
                                             const float (&)[D], float, float,
                                             float va, float vb, unsigned ra,
                                             unsigned rb, Leaf& leaf) {
    leaf(va, vb, ra, rb);
  }
  template <class Leaf>
  static __device__ __forceinline__ Adj2 bwd(const Axes<D>&,
                                             const float (&)[D], float, float,
                                             float va, float vb, unsigned ra,
                                             unsigned rb, float (&)[D],
                                             float (&)[D], Leaf& leaf) {
    const float2 dot = leaf(va, vb, ra, rb);
    return {0.f, 0.f, dot.x, dot.y};
  }
};

// BWD2's loop over the top axes, as `walk_fwd`: a path's prefix (w, v of
// both halves after each top axis) recomputed in axis order, the last
// WALK_AXES axes unrolled below it. With DX the path's chain is reversed
// too: at top axis d the adjoints (of w, v) below it add w·adj_w + v·adj_v
// to gf[d] and w·adj_v to ga[d] (signed by the path's branch), then pass up
// as adj_w·f + adj_v·τ and adj_v·f; at axis 0 the root's (w, v) = (1, 0).

template <int D, int ROWS, bool DX, class Leaf>
__device__ __forceinline__ void walk2(const Axes<D>& a, const float (&tau)[D],
                                      float (&gf)[D], float (&ga)[D],
                                      Leaf& leaf) {
  constexpr int T = top_axes<D>();
#pragma unroll 1
  for (unsigned j = 0; j < (1u << T); ++j) {
    float wa[T + 1], wb[T + 1], va[T + 1], vb[T + 1], ft[T + 1], tt[T + 1];
    wa[0] = a.f[0][0];
    wb[0] = a.f[1][0];
    va[0] = -tau[0];
    vb[0] = tau[0];
    unsigned ra = a.t[0][0], rb = a.t[1][0];
#pragma unroll
    for (int d = 1; d <= T; ++d) {
      const bool b = (j >> (d - 1)) & 1u;
      ft[d] = b ? a.f[1][d] : a.f[0][d];
      tt[d] = b ? tau[d] : -tau[d];
      wa[d] = __fmul_rn(wa[d - 1], ft[d]);
      wb[d] = __fmul_rn(wb[d - 1], ft[d]);
      va[d] = fmaf(wa[d - 1], tt[d], va[d - 1] * ft[d]);
      vb[d] = fmaf(wb[d - 1], tt[d], vb[d - 1] * ft[d]);
      const unsigned t = b ? a.t[1][d] : a.t[0][d];
      ra = combine<ROWS>(ra, t, a.hash);
      rb = combine<ROWS>(rb, t, a.hash);
    }
    if constexpr (!DX) {
      Walk2<D, T + 1, ROWS>::fwd(a, tau, wa[T], wb[T], va[T], vb[T], ra, rb,
                                 leaf);
    } else {
      Adj2 A = Walk2<D, T + 1, ROWS>::bwd(a, tau, wa[T], wb[T], va[T],
                                          vb[T], ra, rb, gf, ga, leaf);
#pragma unroll
      for (int d = T; d >= 1; --d) {
        const bool b = (j >> (d - 1)) & 1u;
        const float vf = fmaf(A.wa, wa[d - 1], fmaf(A.va, va[d - 1],
                              fmaf(A.wb, wb[d - 1], A.vb * vb[d - 1])));
        const float vt = fmaf(A.va, wa[d - 1], A.vb * wb[d - 1]);
        gf[d] += b ? vf : -vf;
        ga[d] += b ? vt : -vt;
        A.wa = fmaf(A.va, tt[d], A.wa * ft[d]);
        A.wb = fmaf(A.vb, tt[d], A.wb * ft[d]);
        A.va *= ft[d];
        A.vb *= ft[d];
      }
      gf[0] += A.wb - A.wa;
      ga[0] += A.vb - A.va;
    }
  }
}

// A BWD2 leaf (a functor, so that it is inlined like the walk): corners
// c and c + 1 with tangents va, vb at rows ra, rb. It sends their table
// grads v·s·dy (`send_grads`), adds v·T_c to acc (d_dy / s) and returns
// the dots ⟨T_c, dy⟩ (with DX).
template <int CV, bool DX>
struct Bwd2Leaf {
  static constexpr int K = CV ? CV : 4;
  const LevelAny& L;
  const BwdLevel& B;
  const Runs& R;
  bool live;
  int k0, C;
  const float (&g)[K];   // dy's features k0 …
  const float (&sg)[K];  // s·dy
  float (&acc)[K];
  __device__ __forceinline__ float2 operator()(float va, float vb,
                                               unsigned ra,
                                               unsigned rb) const {
    const unsigned ia = index_of(L, ra), ib = index_of(L, rb);
    if (B.grads) {
      float ua[K], ub[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ua[k] = va * sg[k];
        ub[k] = vb * sg[k];
      }
      send_grads<CV, K>(B, R, live, ia, ib, k0, C, ua, ub);
    }
    float2 dot = make_float2(0.f, 0.f);
    if (B.load_rows && live) {
      float ta[K], tb[K];
      load_rows<CV, K>(B.base, ia, ib, k0, C, B.vec, ta, tb);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k] = fmaf(vb, tb[k], fmaf(va, ta[k], acc[k]));
        if (DX) {
          dot.x = fmaf(ta[k], g[k], dot.x);
          dot.y = fmaf(tb[k], g[k], dot.y);
        }
      }
    }
    return dot;
  }
};

// One BWD2 level of one point, u_c = s·v_c: the table grads u_c·dy_l of
// its corners (`send_grads`, BWD's runs and reductions), d_dy_l = Σ_c u_c
// T_c summed in registers and written once to `ddy` (shared memory or
// d_dy; null: not asked for), and with DX el[d] = S'_d·gf[d] + g_d·S''_d·
// ga[d], the level's ∂/∂t_d of Σ_c v_c ⟨T_c, dy⟩ (d_x_d takes s² of it).
// Every lane of the warp runs it; a lane that is not live sends and loads
// nothing and writes zeros.
template <int D, int CV, bool DX, int ROWS>
__device__ __forceinline__ void bwd2_level(
    const LevelAny& L, const BwdLevel& B, const float* xp, const float* gp,
    float off, bool smooth, bool live, const float* __restrict__ dyl,
    float* ddy, float (&el)[D]) {
  constexpr int K = CV ? CV : 4;
  const int lane = threadIdx.x & 31;
  Axes<D> a;
  axes_of<D, ROWS>(L, xp, off, smooth, a);
  float tau[D], gf[D], ga[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    tau[d] = gp[d] * a.s1[d];
    gf[d] = ga[d] = 0.f;
  }
  Runs R{true, lane + 1, 1u};
  if (B.grads && !B.shared) R = runs_of<D>(a, live);
  const float s = L.scale;
  const int C = CV ? CV : B.C;
  for (int k0 = 0; k0 < C; k0 += K) {
    float g[K], sg[K], acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    load_dy<CV, K>(dyl, k0, C, B.vec, live, g);
#pragma unroll
    for (int k = 0; k < K; ++k) sg[k] = s * g[k];
    Bwd2Leaf<CV, DX> leaf{L, B, R, live, k0, C, g, sg, acc};
    walk2<D, ROWS, DX>(a, tau, gf, ga, leaf);
    if (ddy) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k0 + k < C) ddy[k0 + k] = acc[k] * s;
    }
  }
  if constexpr (DX) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      // S''_d = 6 − 12 t_d for smoothstep, 0 for linear weights
      float h = a.s1[d] * gf[d];
      if (smooth) {
        const float p = __fmaf_rn(xp[d], L.scale, off);
        const float t = __fsub_rn(p, floorf(p));
        h = fmaf(gp[d] * __fsub_rn(6.f, __fmul_rn(12.f, t)), ga[d], h);
      }
      el[d] = live ? h : 0.f;
    }
  }
}

// BWD2: BWD's block and lanes (BWD_TILE consecutive points, a thread a
// point walking the levels in order), d_x summed in registers in level
// order. d_dy: where `stride` > 0, each point's L·C floats are staged in
// shared memory (`stride` = L·C + 1 floats a point: the lanes' rows on
// distinct banks) and the block's rows, one contiguous run of d_dy, are
// stored whole at the end; else each (point, level) is stored directly.
// Every element of d_dy is written, zeros included. The launch bounds name
// one block an SM, so that ptxas takes the registers it needs: left to its
// own occupancy target it spilled a few words in four instances (D 5, 6).
template <int D, int CV, bool DX>
__global__ void __launch_bounds__(BWD_TILE, 1)
    bwd2_any_kernel(const float* __restrict__ x,
                    const float* __restrict__ table,
                    const LevelAny* __restrict__ levels, int n_levels, int C,
                    long long n, float off, int smooth, int vec, int stride,
                    const float* __restrict__ dy,
                    const float* __restrict__ g, float* __restrict__ d_dy,
                    float* __restrict__ d_table, float* __restrict__ d_x) {
  __shared__ float shared[SHARED_FLOATS];
  extern __shared__ float stage[];
  const long long p0 = (long long)blockIdx.x * BWD_TILE;
  const long long p = p0 + threadIdx.x;
  const bool inb = p < n;
  float xp[D], gp[D], ex[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xp[d] = inb ? __ldg(x + D * p + d) : 0.f;
    gp[d] = inb ? __ldg(g + D * p + d) : 0.f;
    ex[d] = 0.f;
  }
  const bool live = inb && in_unit_box(xp, D);
  const long long lc = (long long)n_levels * C;
  for (int l = 0; l < n_levels; ++l) {
    const LevelAny L = load_level_any(levels, l);
    const bool sh = d_table && (L.flags & FLAG_SHARED);
    const int cells = (int)L.size * C;
    if (sh) {
      for (int i = threadIdx.x; i < cells; i += BWD_TILE) shared[i] = 0.f;
      __syncthreads();
    }
    const BwdLevel B{table + (size_t)L.offset * C,
                     d_table ? d_table + (size_t)L.offset * C : nullptr,
                     sh ? shared : nullptr, vec, C, d_dy || DX};
    const float* dyl = dy + (inb ? p : 0) * lc + (long long)l * C;
    float* ddy = !d_dy ? nullptr
                 : stride ? stage + threadIdx.x * stride + l * C
                 : inb    ? d_dy + p * lc + (long long)l * C
                          : nullptr;
    float el[D];
    bwd2_level<D, CV, DX, EITHER>(L, B, xp, gp, off, smooth, live, dyl, ddy,
                                  el);
    if (sh) {
      __syncthreads();
      for (int i = threadIdx.x; i < cells; i += BWD_TILE) {
        const float v = shared[i];
        if (v != 0.f) atomicAdd(B.grads + i, v);
      }
      __syncthreads();
    }
    if constexpr (DX) {
#pragma unroll
      for (int d = 0; d < D; ++d) ex[d] += (el[d] * L.scale) * L.scale;
    }
  }
  if (DX && inb) {
#pragma unroll
    for (int d = 0; d < D; ++d) d_x[D * p + d] = ex[d];
  }
  if (d_dy && stride) {
    // the block's rows: a warp a point, its lanes on consecutive floats
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int pts = (int)min((long long)BWD_TILE, n - p0);
    for (int q = warp; q < pts; q += BWD_TILE / 32) {
      float* out = d_dy + (p0 + q) * lc;
      const float* row = stage + q * stride;
      for (int i = lane; i < (int)lc; i += 32) out[i] = row[i];
    }
  }
}

struct Args {
  const float* x;
  const float* table;
  const LevelAny* levels;
  int n_levels, C;
  long long n;
  float off;
  int smooth;
};

// the alignment flags of the table (and dy, d_table) the kernels read
int vec_flags(const void* table, const void* dy, const void* d_table) {
  auto at = [](const void* p, unsigned a) {
    return p && (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
  };
  return (at(table, 8) ? TABLE_8 : 0) | (at(table, 16) ? TABLE_16 : 0) |
         (at(dy, 8) ? DY_8 : 0) | (at(dy, 16) ? DY_16 : 0) |
         (at(d_table, 16) ? GRADS_16 : 0);
}

template <int D, int CV>
int encode_cv(const Args& a, float* out, cudaStream_t s) {
  // G levels a block: the most (1, 2, 4 or 8, at most the level count)
  // with G·C·4 ≤ 32 bytes
  const int gmax = a.C == 1 ? 8 : a.C == 2 ? 4 : a.C <= 4 ? 2 : 1;
  int G = 1;
  while (2 * G <= gmax && 2 * G <= a.n_levels) G *= 2;
  const long long P = 32LL * (ENC_WARPS / G);
  const long long tiles = (a.n + P - 1) / P;
  const long long grid = (a.n_levels + G - 1) / G * tiles;
  if (grid > 0x7fffffffLL) return -6;
  encode_any_kernel<D, CV><<<(unsigned)grid, ENC_THREADS, 0, s>>>(
      a.x, a.table, a.levels, a.n_levels, a.C, a.n, a.off, a.smooth,
      vec_flags(a.table, nullptr, nullptr), G, (unsigned)tiles, out);
  return (int)cudaGetLastError();
}

template <int D>
int encode(const Args& a, float* out, cudaStream_t s) {
  switch (a.C) {
    case 1: return encode_cv<D, 1>(a, out, s);
    case 2: return encode_cv<D, 2>(a, out, s);
    default: return encode_cv<D, 0>(a, out, s);
  }
}

template <int D, int CV>
int bwd_cv(const Args& a, const float* dy, float* d_table, float* dx,
           cudaStream_t s) {
  const long long grid = (a.n + BWD_TILE - 1) / BWD_TILE;
  if (grid > 0x7fffffffLL) return -6;
  bwd_any_kernel<D, CV><<<(unsigned)grid, BWD_TILE, 0, s>>>(
      a.x, a.table, a.levels, a.n_levels, a.C, a.n, a.off, a.smooth,
      vec_flags(a.table, dy, d_table), dy, d_table, dx);
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const Args& a, const float* dy, float* d_table, float* dx,
        cudaStream_t s) {
  switch (a.C) {
    case 1: return bwd_cv<D, 1>(a, dy, d_table, dx, s);
    case 2: return bwd_cv<D, 2>(a, dy, d_table, dx, s);
    case 4: return bwd_cv<D, 4>(a, dy, d_table, dx, s);
    default: return bwd_cv<D, 0>(a, dy, d_table, dx, s);
  }
}

template <int D, int CV, bool DX>
int bwd2_cv(const Args& a, const float* dy, const float* g, float* d_dy,
            float* d_table, float* d_x, cudaStream_t s) {
  const long long grid = (a.n + BWD_TILE - 1) / BWD_TILE;
  if (grid > 0x7fffffffLL) return -6;
  // d_dy staged where a block's rows fit STAGE_FLOATS
  const long long lc = (long long)a.n_levels * a.C;
  const int stride =
      d_dy && BWD_TILE * (lc + 1) <= STAGE_FLOATS ? (int)lc + 1 : 0;
  bwd2_any_kernel<D, CV, DX>
      <<<(unsigned)grid, BWD_TILE, stride * BWD_TILE * sizeof(float), s>>>(
          a.x, a.table, a.levels, a.n_levels, a.C, a.n, a.off, a.smooth,
          vec_flags(a.table, dy, d_table), stride, dy, g, d_dy, d_table, d_x);
  return (int)cudaGetLastError();
}

template <int D, int CV>
int bwd2_cv(const Args& a, const float* dy, const float* g, float* d_dy,
            float* d_table, float* d_x, cudaStream_t s) {
  return d_x ? bwd2_cv<D, CV, true>(a, dy, g, d_dy, d_table, d_x, s)
             : bwd2_cv<D, CV, false>(a, dy, g, d_dy, d_table, d_x, s);
}

template <int D>
int bwd2(const Args& a, const float* dy, const float* g, float* d_dy,
         float* d_table, float* d_x, cudaStream_t s) {
  switch (a.C) {
    case 1: return bwd2_cv<D, 1>(a, dy, g, d_dy, d_table, d_x, s);
    case 2: return bwd2_cv<D, 2>(a, dy, g, d_dy, d_table, d_x, s);
    case 4: return bwd2_cv<D, 4>(a, dy, g, d_dy, d_table, d_x, s);
    default: return bwd2_cv<D, 0>(a, dy, g, d_dy, d_table, d_x, s);
  }
}

// the instance for D (1..MAX_D), checked by the entries
#define MNERF_BY_D(D_, CALL)                \
  switch (D_) {                             \
    case 1: return CALL(1);                 \
    case 2: return CALL(2);                 \
    case 3: return CALL(3);                 \
    case 4: return CALL(4);                 \
    case 5: return CALL(5);                 \
    case 6: return CALL(6);                 \
    default: return CALL(7);                \
  }

int check(int d, int n_levels, int c) {
  if (d < 1 || d > MAX_D) return -1;
  if (n_levels < 1) return -2;
  if (c < 1) return -3;
  return 0;
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Each entry returns 0, a cudaError_t (> 0) from the launch, or a negative
// code for arguments the kernels do not take (ops/hashgrid.py maps each to
// a message):
//   -1 input_dim outside [1, 7] (the hash's primes)   -2 no levels
//   -3 level_dim < 1                                   -5 no output asked for
//   -6 more blocks than a launch takes
// x is (n, d), table (rows, c), `levels` n_levels × 16 int32 words;
// align_corners puts pos at x·scale (else x·scale + 0.5), smooth selects
// smoothstep interpolation. Each entry takes the card's index (int) and a
// stream of that card last (csrc/launch.cuh).
int mnerf_hash_any_encode(const float* x, const float* table,
                          const int* levels, int d, int n_levels, int c,
                          long long n, int align_corners, int smooth,
                          float* out, int device, void* stream) {
  if (int e = check(d, n_levels, c)) return e;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Args a{x, table, reinterpret_cast<const LevelAny*>(levels),
               n_levels, c, n, align_corners ? 0.f : 0.5f, smooth};
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_CALL(D) encode<D>(a, out, s)
  MNERF_BY_D(d, MNERF_CALL)
#undef MNERF_CALL
}

// BWD: d_table (rows × c, zeroed by the caller) and dx (n × d) may each be
// null (not computed), not both; `table` is read only for dx.
int mnerf_hash_any_bwd(const float* x, const float* table, const int* levels,
                       int d, int n_levels, int c, long long n,
                       int align_corners, int smooth, const float* dy,
                       float* d_table, float* dx, int device, void* stream) {
  if (int e = check(d, n_levels, c)) return e;
  if (!d_table && !dx) return -5;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Args a{x, table, reinterpret_cast<const LevelAny*>(levels),
               n_levels, c, n, align_corners ? 0.f : 0.5f, smooth};
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_CALL(D) bwd<D>(a, dy, d_table, dx, s)
  MNERF_BY_D(d, MNERF_CALL)
#undef MNERF_CALL
}

// BWD2: d_dy (n × L·c), d_table (rows × c, zeroed by the caller) and d_x
// (n × d) may each be null (not computed), not all three.
int mnerf_hash_any_bwd2(const float* x, const float* table,
                        const int* levels, int d, int n_levels, int c,
                        long long n, int align_corners, int smooth,
                        const float* dy, const float* g, float* d_dy,
                        float* d_table, float* d_x, int device,
                        void* stream) {
  if (int e = check(d, n_levels, c)) return e;
  if (!d_dy && !d_table && !d_x) return -5;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Args a{x, table, reinterpret_cast<const LevelAny*>(levels),
               n_levels, c, n, align_corners ? 0.f : 0.5f, smooth};
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_CALL(D) bwd2<D>(a, dy, g, d_dy, d_table, d_x, s)
  MNERF_BY_D(d, MNERF_CALL)
#undef MNERF_CALL
}

#undef MNERF_BY_D

}  // extern "C"
