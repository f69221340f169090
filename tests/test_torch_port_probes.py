"""Port parity, the last three TPU probes: the port's plain versions (what CPU
tensors run) against the probes' Pallas kernels in interpret mode, with the
probes' own BlockSpecs —

  * the launch floor (`tools/exp_invoke_floor.py` `kern`:43 run as `small`,
    `kern_g`:55 as `grid`) against `ops/invoke_floor.py`, bit for bit (XLA
    contracts the body into one FMA in interpret mode too, and the plain
    version rounds once);
  * the segmented exclusive prefix (`tools/exp_reshape_probe.py`
    `kernel_reshape`:35 with `_tri_excl`) against
    `ops/segment_scan.py segment_prefix` and TRI's arithmetic
    (`segment_prefix_split_reference`: three bf16 pieces, fp32 sums) at
    every S, uniform and δ_inf sentinel input; TRI's split (`split3`)
    rebuilding x bit for bit, its first two pieces the JAX package's
    `_mm_hilo_lhs` split; and `_prefix_weights` (`mirror_nerf_tpu/ops/
    pallas/fused_mlp_t.py:108`, the test kernel of
    tests/test_fused_cp.py:204) against `prefix_weights`;
  * the table products (`tools/exp_int8_probe.py` `kernel`:49) against
    `ops/table_mma.py`, int8 bit for bit and bf16 to 1e-5;

the CPU/CUDA dispatch contract and the three entry points with `--cpu` —
and, on a machine with a card only, each kernel against its plain version
and TRI's machine code on the tensor cores (HMMA).

`kern`, `kern_g` and the int8 probe's `kernel` are closures inside the
probes' `main()`: their bodies are copied here verbatim, with the line they
come from."""

import importlib.util
import os
import re
import subprocess
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mirror_nerf_tpu.ops.pallas.fused_mlp_t import _prefix_weights
from mirror_nerf_tpu_torch.ops import _build
from mirror_nerf_tpu_torch.ops import invoke_floor as fl
from mirror_nerf_tpu_torch.ops import segment_scan as ss
from mirror_nerf_tpu_torch.ops import table_mma as tm
from mirror_nerf_tpu_torch.tools import (exp_int8_probe, exp_invoke_floor,
                                         exp_reshape_probe)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX_BAR = 2e-6  # max |a − b| / max(1, max |b|)
SEGMENTS = [1, 2, 4, 8, 16, 32, 64, 128]
BF16_BAR = 1e-5  # the same scaling: fp32 sums in another order


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


@pytest.fixture(scope="module")
def reshape_probe():
    """tools/exp_reshape_probe.py, loaded from its file (tools/ is not a
    package)."""
    path = os.path.join(REPO, "tools", "exp_reshape_probe.py")
    spec = importlib.util.spec_from_file_location("jax_exp_reshape_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------- 10c: the launch floor


def kern(x_ref, o_ref):  # tools/exp_invoke_floor.py:43-44, verbatim
    o_ref[...] = x_ref[...] * 1.000001 + 1e-6


def kern_g(x_ref, o_ref):  # tools/exp_invoke_floor.py:55-56, verbatim
    o_ref[...] = x_ref[...] * 1.000001 + 1e-6


def _jax_floor(name: str, x: np.ndarray) -> np.ndarray:
    """`small` (:46-53) or `grid` (:58-67), in interpret mode."""
    if name == "small":
        call = pl.pallas_call(
            kern,
            in_specs=[pl.BlockSpec((8, 128), lambda: (0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((8, 128), lambda: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True)
    else:
        call = pl.pallas_call(
            kern_g, grid=(128,),
            in_specs=[pl.BlockSpec((1, 1, 4096), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((1, 1, 4096), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((128, 1, 4096), jnp.float32),
            compiler_params=pltpu.CompilerParams(
                dimension_semantics=("parallel",)),
            interpret=True)
    return np.asarray(call(jnp.asarray(x)))


def _floor_input(shape, seed):
    """Normal values, with tiny and large ones where one rounding and two
    differ most often."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32).reshape(-1)
    n = x.size // 4
    x[:n] = (10.0 ** rng.uniform(-12, 30, n)
             * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[:6] = [0.0, -0.0, 1e-9, -3e-8, 1e3, -1e5]
    return x.reshape(shape)


@pytest.mark.parametrize("name,shape", [("small", fl.SMALL_SHAPE),
                                        ("grid", fl.GRID_SHAPE)])
def test_floor_matches_probe_kernel(name, shape):
    """Bit for bit: interpret mode contracts the body into one FMA, as XLA
    does, and the plain version rounds once."""
    x = _floor_input(shape, seed=len(shape))
    want = _jax_floor(name, x)
    got = fl.axpb(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # two roundings differ from it on a good share of these inputs
    two = (x * np.float32(1.000001) + np.float32(1e-6)).astype(np.float32)
    assert (two != want).mean() > 0.05


def _round32(exact: Fraction) -> np.float32:
    """The float32 nearest `exact`, ties to even."""
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.float32(c).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """`fma32` is one rounding where the float64 sum alone would round twice:
    (1 + 2⁻¹²)² + 2⁻⁶⁰ lies just above a float32 midpoint that float64
    cannot hold; then random operands against exact rational rounding."""
    a = np.float32(1 + 2.0 ** -12)
    for shift, want in ((2.0 ** -60, 1 + 2.0 ** -11 + 2.0 ** -23),
                        (-2.0 ** -60, 1 + 2.0 ** -11)):
        got = fl.fma32(torch.tensor([a]), a, np.float32(shift))
        assert float(got) == want
    naive = np.float32(np.float64(a) * np.float64(a) + 2.0 ** -60)
    assert naive == np.float32(1 + 2.0 ** -11)  # the double rounding
    rng = np.random.default_rng(0)
    x = _floor_input((512,), 1)
    scale = np.float32(rng.uniform(0.5, 2.0))
    shift = np.float32(rng.uniform(-1e-3, 1e-3))
    got = fl.fma32(torch.from_numpy(x), scale, shift).numpy()
    want = [_round32(Fraction(float(v)) * Fraction(float(scale))
                     + Fraction(float(shift))) for v in x]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


# --------------------------------------- 10a: the segmented exclusive prefix


def _jax_prefix(probe, x: np.ndarray, s: int) -> np.ndarray:
    """`kernel_reshape` through the probe's own pallas_call (:48-58) with
    `_tri_excl(s)`, in interpret mode."""
    fn = pl.pallas_call(
        probe.kernel_reshape,
        grid=(8,),
        in_specs=[pl.BlockSpec((1, 1, probe.L), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((probe.S, probe.S), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, probe.L), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 1, probe.L), jnp.float32),
        interpret=True)
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(probe._tri_excl(s))))


def _prefix_input(probe, s: int, kind: str) -> np.ndarray:
    """The probe's own input (RandomState(0), :45), with 1e10 on each
    segment's last value for the sentinel kind."""
    x = np.random.RandomState(0).rand(8, 1, probe.L).astype(np.float32)
    if kind == "sentinel":
        x.reshape(-1, s)[:, -1] = 1e10
    return x


def _exclusive64(x: np.ndarray, s: int) -> np.ndarray:
    xs = x.astype(np.float64).reshape(-1, s)
    return np.concatenate([np.zeros_like(xs[:, :1]),
                           np.cumsum(xs[:, :-1], -1)], -1)


@pytest.mark.parametrize("kind", ["uniform", "sentinel"])
@pytest.mark.parametrize("s", [128, 16, 1, 2, 4, 8, 32, 64])
def test_segment_prefix_matches_probe_kernel(reshape_probe, s, kind):
    """The plain version and TRI's arithmetic in plain PyTorch (the three
    bf16 pieces times TRI, fp32 sums) against `kernel_reshape` and float64,
    at every segment length."""
    x = _prefix_input(reshape_probe, s, kind)
    want = _jax_prefix(reshape_probe, x, s)
    ref = _exclusive64(x, s)
    # each segment's last value is the sum of its segment's others
    others = x.astype(np.float64).reshape(-1, s)[:, :-1].sum(-1)
    for fn in (ss.segment_prefix, ss.segment_prefix_split_reference):
        got = fn(torch.from_numpy(x), s).numpy()
        assert got.shape == x.shape
        assert _scaled(got, want) <= PREFIX_BAR
        assert _scaled(got.reshape(-1, s), ref) <= PREFIX_BAR
        assert _scaled(got.reshape(-1, s)[:, -1], others) <= PREFIX_BAR
        if s == 1:
            assert not got.any()


def test_inclusive_minus_self_is_the_trap(reshape_probe):
    """The JAX probe's own oracle (cumsum − x, :72) cancels the prefix
    against a δ_inf sentinel; the port's plain version does not."""
    s = reshape_probe.S
    x = _prefix_input(reshape_probe, s, "sentinel")
    xs = x.reshape(8, -1, s)
    trap = (np.cumsum(xs, axis=-1) - xs).reshape(-1, s)
    ref = _exclusive64(x, s)
    assert np.abs(trap[:, -1] - ref[:, -1]).max() > 10.0
    got = ss.segment_prefix(torch.from_numpy(x), s).numpy().reshape(-1, s)
    assert _scaled(got, ref) <= PREFIX_BAR


# TRI's three-piece bf16 split (`split3`) and its arithmetic


def _split_input(n: int = 8192, seed: int = 0) -> np.ndarray:
    """fp32 values of both signs spread over 1e-30 … 1e30, with zeros and
    the δ_inf sentinel."""
    rng = np.random.default_rng(seed)
    x = (10.0 ** rng.uniform(-30.0, 30.0, n)
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[:8] = [0.0, -0.0, 1e10, -1e10, 1e-30, -1e30, 1.0, 3.0e-7]
    return x


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_split3_rebuilds_x_bit_for_bit():
    x = _split_input()
    hi, mid, lo = ss.split3(torch.from_numpy(x))
    assert {p.dtype for p in (hi, mid, lo)} == {torch.bfloat16}
    back = ((hi.float() + mid.float()) + lo.float()).numpy()
    nz = x != 0
    np.testing.assert_array_equal(back[nz].view(np.uint32),
                                  x[nz].view(np.uint32))
    assert (back[~nz] == 0).all()
    exact = (hi.double() + mid.double() + lo.double()).numpy()
    np.testing.assert_array_equal(exact, x.astype(np.float64))
    # the pieces fall by at least 2⁸ each: mid is the rounding error of hi
    big = np.abs(x) > 1e-20
    h, m = hi.double().abs().numpy(), mid.double().abs().numpy()
    assert (m[big] <= h[big] * 2.0 ** -8).all()


def test_split3_matches_jax_hilo():
    """hi and mid are `x.astype(bf16)` and `(x − hi).astype(bf16)`, as
    `_mm_hilo_lhs` writes them, bit for bit on the same numpy input."""
    x = _split_input(seed=1)
    hi, mid, _ = ss.split3(torch.from_numpy(x))
    jx = jnp.asarray(x)
    jhi = jx.astype(jnp.bfloat16)
    jlo = (jx - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(hi), np.asarray(jhi).view(np.uint16))
    np.testing.assert_array_equal(_bits(mid),
                                  np.asarray(jlo).view(np.uint16))


def test_two_pieces_miss_the_bar():
    """Why three pieces: hi + mid alone (the JAX package's split, ~16 bits)
    misses the probe's 2e-6 bar on wide-range values at S = 16 even with
    exact sums; the three pieces' sums in fp32 meet it."""
    x = exp_reshape_probe.wide_input("cpu", seed=0)
    hi, mid, _ = ss.split3(x)
    ref = exp_reshape_probe.exclusive64(x, 16)
    two = exp_reshape_probe.exclusive64(hi.float() + mid.float(), 16)
    assert _scaled(two, ref) > PREFIX_BAR
    err, last = exp_reshape_probe.prefix_errors(
        ss.segment_prefix_split_reference(x, 16), x, 16)
    assert err <= PREFIX_BAR / 10 and last <= PREFIX_BAR / 10


@pytest.mark.parametrize("kind", ["uniform", "wide"])
@pytest.mark.parametrize("s", [16, 64, 128])
def test_split_reference_wide_range(s, kind):
    """Log-uniform values over 1e-6 … 1e10 (and uniform ones) on 64 rows:
    TRI's split and fp32 sums stay within the bar of float64."""
    x = exp_reshape_probe.kind_input(
        exp_reshape_probe.path_input("cpu")[:64], s, kind)
    got = ss.segment_prefix_split_reference(x, s)
    err, last = exp_reshape_probe.prefix_errors(got, x, s)
    assert err <= PREFIX_BAR and last <= PREFIX_BAR


@pytest.mark.parametrize("s,lanes", [(16, 128), (128, 512)])
def test_prefix_weights_matches_jax_kernel(s, lanes):
    """WEIGHTS' plain version against `_prefix_weights` in a pallas_call
    (interpret), on the sentinel input of tests/test_fused_cp.py:194-199."""
    rng = np.random.default_rng(0)
    sd = rng.uniform(0.0, 1.5, (1, lanes)).astype(np.float32)
    sd[0, s - 1::s] = 1e10

    def k(x_ref, o_ref):  # tests/test_fused_cp.py:201-202
        o_ref[...] = _prefix_weights(x_ref[...], s)

    want = np.asarray(pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((1, lanes), jnp.float32),
        interpret=True)(jnp.asarray(sd)))
    got = ss.prefix_weights(torch.from_numpy(sd), s).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got.reshape(-1, s).sum(-1) <= 1.0 + 1e-5).all()


# ------------------------------------------ 10b: the table-product probe


def _int8_probe_call(g, r, lanes, nb, nt, name):
    """`make_timed`'s kernel (tools/exp_int8_probe.py:49-67, verbatim) and
    its pallas_call (:73-85), in interpret mode."""

    def kernel(x_ref, t_ref, o_ref):
        x = x_ref[0]  # (1, L) fp32
        iot = lax.broadcasted_iota(jnp.int32, (g, lanes), 0)
        acc = jnp.zeros((r, lanes), jnp.float32)
        for j in range(nt):
            basis_f = iot.astype(jnp.float32) * 1e-3 + x + jnp.float32(j)
            if name == "int8":
                basis = jnp.clip(basis_f, -127, 127).astype(jnp.int8)
                o = lax.dot_general(
                    t_ref[j], basis, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32)
                acc = acc + o.astype(jnp.float32)
            else:
                basis = basis_f.astype(jnp.bfloat16)
                o = lax.dot_general(
                    t_ref[j], basis, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
                acc = acc + o
        o_ref[0] = acc

    return pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=[
            pl.BlockSpec((1, 1, lanes), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((nt, r, g), lambda i: (0, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, r, lanes), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nb, r, lanes), jnp.float32),
        interpret=True)


@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_table_mma_matches_probe_kernel(name):
    """At g 64, r 16, lanes 128, 2 blocks, 3 tables: int8 bit for bit (every
    partial sum is an integer below 2²⁴), bf16 to 1e-5 scaled."""
    size = exp_int8_probe.CPU_SIZE
    x, tabs = exp_int8_probe.inputs(**size, seed=3, device="cpu")
    t = tabs[name]
    tj = jnp.asarray(t.float().numpy()).astype(
        jnp.int8 if name == "int8" else jnp.bfloat16)
    want = np.asarray(_int8_probe_call(
        size["g"], size["r"], size["lanes"], size["blocks"], size["tables"],
        name)(jnp.asarray(x.numpy()), tj))
    got = tm.table_mma(x, t).numpy()
    assert got.shape == want.shape == (2, 16, 128)
    if name == "int8":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, exp_int8_probe.numpy_int8(x.numpy(), t.numpy()))
    else:
        assert _scaled(got, want) <= BF16_BAR


def test_table_mma_basis_rounding():
    """The basis is three fp32 roundings, fl(fl(fl(i·1e-3) + x) + j), not the
    FMA-contracted i·1e-3 + x: against numpy's separate roundings, and the
    two forms differ on some of these values."""
    rng = np.random.default_rng(5)
    x = rng.random((1, 1, 1024), dtype=np.float32)
    got = tm.basis_reference(torch.from_numpy(x), 512, 3,
                             torch.float32).numpy()[0]
    iot = np.arange(512, dtype=np.float32)[:, None]
    want = (iot * np.float32(1e-3) + x[0]) + np.float32(3)
    np.testing.assert_array_equal(got, want)
    fma = ((iot.astype(np.float64) * np.float64(np.float32(1e-3))
            + x[0]).astype(np.float32)) + np.float32(3)
    assert (fma != want).any()


# ------------------------------------------------------------- dispatch


def test_dispatch_contract():
    """CPU tensors take the plain versions (no launch counted); the shapes
    and types the kernels refuse raise on the CPU too."""
    before = (fl.launches_small, fl.launches_grid, ss.launches_scan,
              ss.launches_tri, ss.launches_weights, tm.launches_int8,
              tm.launches_bf16)
    fl.axpb(torch.ones(fl.SMALL_SHAPE))
    ss.segment_prefix(torch.ones(256), 64, "tri")
    ss.prefix_weights(torch.ones(256), 64)
    x, tabs = exp_int8_probe.inputs(**exp_int8_probe.CPU_SIZE, seed=0,
                                    device="cpu")
    tm.table_mma(x, tabs["bf16"])
    assert (fl.launches_small, fl.launches_grid, ss.launches_scan,
            ss.launches_tri, ss.launches_weights, tm.launches_int8,
            tm.launches_bf16) == before
    with pytest.raises(ValueError, match="floor kernel takes"):
        fl.axpb(torch.ones(4, 4))
    with pytest.raises(ValueError, match="does not divide"):
        ss.segment_prefix(torch.ones(256), 3)
    with pytest.raises(ValueError, match="multiple of 128"):
        ss.segment_prefix(torch.ones(100), 4)
    with pytest.raises(ValueError, match="'scan' or 'tri'"):
        ss.segment_prefix(torch.ones(128), 4, "weights")
    with pytest.raises(ValueError, match="int8 or bf16"):
        tm.table_mma(x, tabs["bf16"].float())
    with pytest.raises(ValueError, match="several devices"):
        tm.table_mma(x, tabs["int8"].to("meta"))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: on CPU tensors they raise before
    any build."""
    x = torch.ones(fl.SMALL_SHAPE)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fl.axpb_cuda(x)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fl.chain_cuda(x, torch.empty_like(x), 3)
    for mode in ("scan", "tri"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ss.segment_prefix_cuda(torch.ones(256), 64, mode)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ss.prefix_weights_cuda(torch.ones(256), 64)
    xt, tabs = exp_int8_probe.inputs(**exp_int8_probe.CPU_SIZE, seed=0,
                                     device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tm.table_mma_cuda(xt, tabs["int8"])


@pytest.mark.parametrize("probe", [exp_invoke_floor, exp_reshape_probe,
                                   exp_int8_probe])
def test_entry_point_runs_on_cpu(probe):
    """Each entry point's parity part with --cpu (the plain versions), its
    timing part refusing to measure without a card."""
    res = probe.main(["--cpu"])
    assert res["device"] == "cpu" and res["parity"] and "bench" not in res


def test_device_ms_refuses_a_partial_trace(monkeypatch):
    """`timing.device_ms` counts the kernels a call launched in the
    warm-up trace (or the timed one, whichever holds more) and takes
    another pair of traces while the timed one holds fewer than reps ×
    that (a trace that lost kernels reads low), and also when the warm-up
    trace held no kernel; it raises when none of its tries is whole. A
    whole trace gives its kernels' summed time a call."""
    from mirror_nerf_tpu_torch.tools import timing

    def kernels(n, ts, name="k"):
        return [{"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                 "dur": 3.0} for _ in range(n)]

    def trace(*pairs):
        it = iter(pairs)
        monkeypatch.setattr(timing, "_traced_kernels",
                            lambda fn, reps: next(it))

    # two kernels a call; every timed trace kept 37 of its 40
    trace(*[(kernels(40, 0), kernels(37, 1))] * 3)
    with pytest.raises(RuntimeError, match="lost kernels"):
        timing.device_ms(lambda: None, 20)
    # the warm-up trace itself lost three: still two a call
    trace(*[(kernels(37, 0), kernels(39, 1))] * 3)
    with pytest.raises(RuntimeError, match="lost kernels"):
        timing.device_ms(lambda: None, 20)
    # the warm-up trace lost one of each call's two, the timed one kept
    # 25 of 40: the timed trace's own count (two a call) refuses it
    trace(*[(kernels(20, 0), kernels(25, 1))] * 3)
    with pytest.raises(RuntimeError, match="lost kernels"):
        timing.device_ms(lambda: None, 20)
    trace(*[([], kernels(20, 1))] * 3)
    with pytest.raises(RuntimeError, match="held no kernel"):
        timing.device_ms(lambda: None, 20)
    # a first trace that lost every kernel, then a whole pair
    trace(([], []), (kernels(20, 0), kernels(20, 1)))
    assert timing.device_ms(lambda: None, 20) == pytest.approx(0.003)
    trace((kernels(37, 0), kernels(40, 1)))
    assert timing.device_ms(lambda: None, 20) == pytest.approx(0.006)
    # a partial trace, then a whole one: the whole one's time
    trace((kernels(20, 0), kernels(7, 1)), (kernels(20, 0),
                                            kernels(20, 1, "k2")))
    assert timing.device_ms(lambda: None, 20) == pytest.approx(0.003)
    # with a flush kernel left out: the one kernel's mean
    trace((kernels(20, 0, "FillFunctor") + kernels(20, 0),
           kernels(20, 1, "FillFunctor") + kernels(20, 1)))
    assert timing.device_ms(lambda: None, 20,
                            exclude="FillFunctor") == pytest.approx(0.003)
    trace(*[(kernels(20, 0, "FillFunctor") + kernels(20, 0),
             kernels(20, 1, "FillFunctor") + kernels(17, 1))] * 3)
    with pytest.raises(RuntimeError, match="lost kernels"):
        timing.device_ms(lambda: None, 20, exclude="FillFunctor")


# --------------------------------------------------- on a card only


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [fl.SMALL_SHAPE, fl.GRID_SHAPE,
                                   (3, 1, 260)])
def test_cuda_floor_exact(shape):
    _needs_card()
    x = torch.from_numpy(_floor_input(shape, 7)).cuda()
    small = tuple(shape) == fl.SMALL_SHAPE
    before = fl.launches_small if small else fl.launches_grid
    got = fl.axpb(x)
    torch.cuda.synchronize()
    assert (fl.launches_small if small else fl.launches_grid) == before + 1
    assert torch.equal(got.view(torch.int32),
                       fl.axpb_reference(x).view(torch.int32))
    want = x
    for _ in range(5):
        want = fl.axpb_reference(want)
    chained = fl.chain_cuda(x.clone(), torch.empty_like(x), 5)
    assert torch.equal(chained, want)


@pytest.mark.gpu
def test_cuda_floor_graph_capture():
    """The wrapper takes the capture stream and does not synchronise: a
    captured chain replays to the plain chain's result; the counter moves at
    capture and not on replay."""
    _needs_card()
    a = torch.from_numpy(_floor_input(fl.SMALL_SHAPE, 8)).cuda()
    b = torch.empty_like(a)
    start = a.clone()
    fl.axpb(a, b)  # warm: the library is loaded before capture
    torch.cuda.synchronize()
    a.copy_(start)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fl.axpb(a, b)
        fl.axpb(b, a)
    counted = fl.launches_small
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert fl.launches_small == counted
    want = start
    for _ in range(4):
        want = fl.axpb_reference(want)
    assert torch.equal(a, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["scan", "tri"])
@pytest.mark.parametrize("s", SEGMENTS)
def test_cuda_segment_prefix(mode, s):
    """1001 rows (a ragged TRI tile), uniform, sentinel and wide-range
    (1e-6 … 1e10) input, against float64 at 2e-6 scaled; the sentinels' own
    values too."""
    _needs_card()
    g = torch.Generator().manual_seed(s)
    x = torch.rand((1001, 128), generator=g).cuda()
    for kind in exp_reshape_probe.KINDS:
        xi = exp_reshape_probe.kind_input(x, s, kind)
        before = ss.launches_scan + ss.launches_tri
        got = ss.segment_prefix(xi, s, mode)
        torch.cuda.synchronize()
        assert ss.launches_scan + ss.launches_tri == before + 1
        err, last = exp_reshape_probe.prefix_errors(got, xi, s)
        assert err <= PREFIX_BAR and last <= PREFIX_BAR


@pytest.mark.gpu
@pytest.mark.parametrize("s", [16, 64, 128])
def test_cuda_prefix_weights(s):
    _needs_card()
    g = torch.Generator().manual_seed(s)
    sd = exp_reshape_probe.with_sentinel(
        torch.rand((4099, 128), generator=g) * 1.5, s).cuda()
    before = ss.launches_weights
    got = ss.prefix_weights(sd, s)
    torch.cuda.synchronize()
    assert ss.launches_weights == before + 1
    torch.testing.assert_close(got, ss.prefix_weights_reference(sd, s),
                               atol=1e-5, rtol=0)
    assert float(got.reshape(-1, s).sum(-1).max()) <= 1.0 + 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("size", [
    dict(g=512, r=64, lanes=1024, blocks=64, tables=9),
    dict(g=64, r=16, lanes=128, blocks=2, tables=3),
    dict(g=128, r=80, lanes=256, blocks=3, tables=2)])
def test_cuda_table_mma(size):
    """The probe's defaults, the CPU tests' size, and r = 80 (a ragged
    second row tile): int8 bit for bit, bf16 to 1e-5 scaled."""
    _needs_card()
    x, tabs = exp_int8_probe.inputs(**size, seed=9, device="cuda")
    for name, t in tabs.items():
        before = tm.launches_int8 + tm.launches_bf16
        got = tm.table_mma(x, t)
        torch.cuda.synchronize()
        assert tm.launches_int8 + tm.launches_bf16 == before + 1
        ref = tm.table_mma_reference(x, t)
        if name == "int8":
            assert torch.equal(got, ref)
        else:
            assert _scaled(got.cpu(), ref.cpu()) <= BF16_BAR


@pytest.mark.gpu
def test_cuda_tri_runs_on_the_tensor_cores():
    """Every instance of TRI's kernel holds HMMA instructions in its SASS
    (cuobjdump of the library the wrapper loaded)."""
    _needs_card()
    ss._library()
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path(ss._LIB))], capture_output=True, text=True,
        check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    tri = [f for f in funcs if "tri_kernel" in f.splitlines()[0]]
    assert len(tri) == len(SEGMENTS), [f.splitlines()[0] for f in funcs]
    for f in tri:
        assert "HMMA" in f, f.splitlines()[0]
