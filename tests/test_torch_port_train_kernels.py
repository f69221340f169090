"""Port parity, the fused training kernels' plain versions: the port's
`density_with_grad_reference` / `density_reference` (what CPU tensors run)
against the JAX package's `_density_with_grad` and its Pallas kernels
`density_with_grad_fused` / `density_fused` in interpret mode — values,
gradients and grad-of-grad under cotangents on σ, geo and tanh(∇σ) — plus
the CPU/CUDA dispatch contract and, on a machine with a card only, the CUDA
kernels against the plain versions and the composite kernel's gradient
guard.

Inputs are uniform floats: no sample lies exactly on a grid node, where the
JAX hat basis gives slope 0 and a lerp does not (a measure-zero set).
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
from mirror_nerf_tpu.render.renderer import _density_with_grad
from mirror_nerf_tpu_torch.models.tpugrid import TPUGridField as TorchField
from mirror_nerf_tpu_torch.ops import fused_cp_train as fct
from mirror_nerf_tpu_torch.train.checkpoints import (params_from_numpy,
                                                     tree_leaves)

LEVELS = ((16, 8), (33, 16))
T = 1500  # not a multiple of the kernels' 128-thread block
VALUE_RTOL = 1e-5
GRAD_RTOL = 5e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(a).max()) + 1e-8)


@pytest.fixture(scope="module")
def setup():
    kw = dict(predict_normal=True, predict_mirror_mask=True, bound=6.0,
              grid_levels=LEVELS)
    jf, tf = JaxField(**kw), TorchField(**kw)
    p = jax.tree_util.tree_map(np.array, jf.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    # ±6.2 around a bound of 6: ~3 % of the coordinates lie outside it
    x = rng.uniform(-6.2, 6.2, (T, 3)).astype(np.float32)
    cots = (rng.normal(size=(T,)).astype(np.float32),
            rng.normal(size=(T, 15)).astype(np.float32),
            rng.normal(size=(T, 3)).astype(np.float32))
    return jf, tf, p, x, cots


def _torch_grads(fn, tf, p, x, cots, tangents=True):
    """Value and grads (params tree as numpy leaves, d_x) of the cotangent
    loss through a port function on the CPU."""
    pt = params_from_numpy(p)
    for leaf in tree_leaves(pt):
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    ca, cb, cc = (torch.from_numpy(c) for c in cots)
    out = fn(tf, pt, xt)
    loss = (out[0] * ca).sum() + (out[1] * cb).sum()
    if tangents:
        loss = loss + (torch.tanh(out[2]) * cc).sum()
    loss.backward()
    return (float(loss.detach()), [_grad(leaf) for leaf in tree_leaves(pt)],
            xt.grad.numpy(), [o.detach().numpy() for o in out])


def _grad(leaf: torch.Tensor) -> np.ndarray:
    """A leaf's gradient; zeros for leaves the density never reads (the
    heads), which JAX reports as zeros."""
    if leaf.grad is None:
        return np.zeros(tuple(leaf.shape), np.float32)
    return leaf.grad.cpu().numpy()


def _jax_grads(fn, p, x, cots, tangents=True):
    ca, cb, cc = cots

    def loss(pp, xx):
        out = fn(pp, xx)
        v = jnp.sum(out[0] * ca) + jnp.sum(out[1] * cb)
        if tangents:
            v = v + jnp.sum(jnp.tanh(out[2]) * cc)
        return v

    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(p, x)
    leaves = [np.asarray(v) for v in tree_leaves(
        jax.tree_util.tree_map(np.asarray, gp))]
    return float(val), leaves, np.asarray(gx)


@pytest.mark.parametrize("jax_path", ["unfused", "pallas_interpret"])
def test_density_with_grad_matches_jax(setup, jax_path):
    """Values, param grads and d_x (with every second-order term, through
    the tanh(∇σ) cotangent) of the plain version against JAX."""
    jf, tf, p, x, cots = setup
    if jax_path == "unfused":
        def fn(pp, xx):
            return _density_with_grad(jf, pp, xx)
    else:
        def fn(pp, xx):
            return jax_dwg_fused(jf, pp, xx, interpret=True)
    want = [np.asarray(v) for v in fn(p, x)]
    l1, g1, dx1, got = _torch_grads(fct.density_with_grad_fused, tf, p, x,
                                    cots)
    for name, a, b in zip(("sigma", "geo", "grad"), want, got):
        assert _rel(a, b) < VALUE_RTOL, name
    l0, g0, dx0 = _jax_grads(fn, p, x, cots)
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    assert len(g0) == len(g1)
    assert max(_rel(a, b) for a, b in zip(g0, g1)) < GRAD_RTOL
    assert _rel(dx0, dx1) < GRAD_RTOL
    # out-of-bound coordinates get exactly no ∇σ and no d_x
    out = (np.abs(x) > 6.0)
    assert out.any() and (got[2][out] == 0).all() and (dx1[out] == 0).all()


def test_density_only_matches_jax(setup):
    jf, tf, p, x, cots = setup

    def fn(pp, xx):
        return jax_density_fused(jf, pp, xx, interpret=True)

    want = [np.asarray(v) for v in fn(p, x)]
    l1, g1, dx1, got = _torch_grads(fct.density_fused, tf, p, x, cots,
                                    tangents=False)
    for name, a, b in zip(("sigma", "geo"), want, got):
        assert _rel(a, b) < VALUE_RTOL, name
    l0, g0, dx0 = _jax_grads(fn, p, x, cots, tangents=False)
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    assert max(_rel(a, b) for a, b in zip(g0, g1)) < GRAD_RTOL
    assert _rel(dx0, dx1) < GRAD_RTOL


def test_need_dx_false_gives_zero_dx(setup):
    _, tf, p, x, _ = setup
    pt = params_from_numpy(p)
    for leaf in tree_leaves(pt):
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    sigma, geo = fct.density_fused(tf, pt, xt, need_dx=False)
    (sigma.sum() + geo.sum()).backward()
    assert pt["grid"]["fold"].grad is not None
    assert xt.grad is None


def test_cpu_tensors_take_the_plain_version(setup):
    _, tf, p, x, _ = setup
    pt = params_from_numpy(p)
    xt = torch.from_numpy(x)
    before = (fct.launches_fwd, fct.launches_bwd)
    got = fct.density_with_grad_fused(tf, pt, xt)
    ref = fct.density_with_grad_reference(tf, pt, xt)
    assert (fct.launches_fwd, fct.launches_bwd) == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_kernel_path_refuses_cpu_tensors(setup):
    """No quiet fallback: the autograd Functions raise off the card."""
    _, tf, p, x, _ = setup
    args = fct._param_args(params_from_numpy(p))
    with pytest.raises(ValueError, match="CUDA"):
        fct.DensityWithGradFn.apply(tf, torch.from_numpy(x), *args)
    with pytest.raises(ValueError, match="CUDA"):
        fct.DensityFn.apply(tf, True, torch.from_numpy(x), *args)


def test_no_grad_plain_version_still_gives_the_normal(setup):
    """The validation render runs the σ-gradient under no_grad."""
    _, tf, p, x, _ = setup
    pt = params_from_numpy(p)
    with torch.no_grad():
        s, g, n = fct.density_with_grad_fused(tf, pt, torch.from_numpy(x))
    ref = fct.density_with_grad_reference(tf, pt, torch.from_numpy(x))
    assert not n.requires_grad and torch.equal(n, ref[2].detach())


# ---- on a machine with a card only ----


def _cuda_case(p, saturating: bool, seed: int, t: int):
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.array, p)
    if saturating:
        p["sigma_net"][1]["w"][:, 0] = np.abs(p["sigma_net"][1]["w"][:, 0]) \
            * 2000.0
    x = rng.uniform(-6.1, 6.1, (t, 3)).astype(np.float32)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((t,), (t, 15), (t, 3))]
    return p, x, cots


def _grads_on(fn, tf, p, x, cots, device, tangents, need_dx=True):
    pt = params_from_numpy(p, device=device)
    leaves = tree_leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).to(device).requires_grad_(True)
    ca, cb, cc = (torch.from_numpy(c).to(device) for c in cots)
    out = fn(tf, pt, xt) if tangents else fn(tf, pt, xt, need_dx=need_dx)
    loss = (out[0] * ca).sum() + (out[1] * cb).sum()
    if tangents:
        loss = loss + (torch.tanh(out[2]) * cc).sum()
    loss.backward()
    dx = xt.grad if xt.grad is not None else torch.zeros_like(xt)
    return ([o.detach().cpu().numpy() for o in out],
            [_grad(leaf) for leaf in leaves], dx.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("saturating", [False, True],
                         ids=["seeded", "saturating"])
@pytest.mark.parametrize("variant", ["tangents", "density", "density_no_dx"])
def test_cuda_kernels_match_plain(setup, variant, saturating):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    jf, tf, p0, _, _ = setup
    p, x, cots = _cuda_case(p0, saturating, 2, 1000 + 37)
    tangents = variant == "tangents"
    need_dx = variant != "density_no_dx"
    if tangents:
        fused, plain = (fct.density_with_grad_fused,
                        fct.density_with_grad_reference)
    else:
        fused = fct.density_fused

        def plain(f, pp, xx, need_dx=True):
            return fct.density_reference(f, pp, xx if need_dx
                                         else xx.detach())
    before = (fct.launches_fwd, fct.launches_bwd)
    got = _grads_on(fused, tf, p, x, cots, "cuda", tangents, need_dx)
    torch.cuda.synchronize()
    assert (fct.launches_fwd, fct.launches_bwd) == (before[0] + 1,
                                                    before[1] + 1)
    ref = _grads_on(plain, tf, p, x, cots, "cuda", tangents, need_dx)
    for a, b in zip(got[0], ref[0]):
        # 1e-4 abs, relative to the magnitude on the saturating field
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=1e-4 * scale, rtol=0)
    assert max(_rel(b, a) for a, b in zip(got[1], ref[1])) < 1e-3
    if need_dx:
        assert _rel(ref[2], got[2]) < 1e-3
    else:
        assert float(np.abs(got[2]).max()) == 0.0


@pytest.mark.gpu
def test_composite_kernel_refuses_params_that_require_grad(setup):
    """The eval kernel is forward-only: under grad mode it raises when a
    parameter leaf requires grad, instead of returning outputs without a
    graph (silent zero gradients)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from mirror_nerf_tpu_torch.ops import fused_cp

    kw = dict(bound=2.0, grid_levels=((16, 8), (32, 8)))
    jf, tf = JaxField(**kw), TorchField(**kw)
    pt = params_from_numpy(jax.tree_util.tree_map(
        np.array, jf.init(jax.random.PRNGKey(0))), device="cuda")
    pt["sigma_net"][0]["w"].requires_grad_(True)
    n, s = 8, 16
    o = torch.zeros((n, 3), device="cuda")
    d = torch.nn.functional.normalize(torch.ones((n, 3), device="cuda"),
                                      dim=-1)
    z = torch.linspace(0.1, 1.0, s, device="cuda").expand(n, s).contiguous()
    with pytest.raises(ValueError, match="fused_cp_train"):
        fused_cp.fused_cp_rays_composite(tf, pt, o, d, d, z)
    with torch.no_grad():
        fused_cp.fused_cp_rays_composite(tf, pt, o, d, d, z)
