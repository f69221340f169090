"""Port parity, training the hash-grid model (`--model_type nerf_tcnn`): the
encoder's backward (BWD) and the backward of that backward (BWD2), whose
plain versions CPU tensors run, against the JAX package's autodiff of
`mirror_nerf_tpu.ops.hashgrid.hashgrid_encode` (its vjp and its
grad-of-grad); the `HashEncode` Function graph (what the card runs too)
against JAX; `tv_loss`; the table-grad skip of the σ-gradient normal's
backward; the grid-lr groups on the hash table against optax; a
fixed-seed Trainer trajectory against the JAX Trainer. On a machine with a
card, BWD and BWD2 against their plain versions at the model's full width.

Tables are O(1) (the ±1e-4 init ×1e4), or errors would hide. The bars are
relative to the largest entry of the reference: fp32 against fp32, only
the order of the sums differs (index_add_ against XLA's scatter-add, the
corners and levels against autodiff's order), ~1e-7 of scale measured."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.config import Config as JaxConfig
from mirror_nerf_tpu.ops import hashgrid as jhg
from mirror_nerf_tpu.train.optim import make_optimizer as jax_optimizer
from mirror_nerf_tpu_torch.config import Config
from mirror_nerf_tpu_torch.models.ngp import NGPField
from mirror_nerf_tpu_torch.ops import hashgrid as thg
from mirror_nerf_tpu_torch.train.checkpoints import (_leaves,
                                                     params_from_numpy,
                                                     tree_leaves)
from mirror_nerf_tpu_torch.train.optim import Optimizer

# 4 levels, 2^10 rows a level at most: levels 0, 1 dense (sides 5, 9),
# 2, 3 hashed (sides 17, 33)
SPEC = dict(num_levels=4, level_dim=2, base_resolution=4,
            log2_hashmap_size=10, per_level_scale=2.0)
# fp32 against fp32 in another order: max|a − b| / max(1, max|ref|)
REL = 1e-6


def _specs():
    return jhg.HashGridSpec(**SPEC), thg.HashGridSpec(**SPEC)


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(
        1.0, float(np.abs(want).max()))


def _case(n=384, seed=0):
    """A ×1e4 table, n points (~4 % outside [0, 1]³, the corners 0 and 1,
    points on faces and at grid nodes of each level), dy (N, 8), g (N, 3)
    and a table cotangent G, all seeded numpy."""
    _, ts = _specs()
    rng = np.random.default_rng(seed)
    table = (rng.uniform(-1.0, 1.0, (ts.table_rows, 2))).astype(np.float32)
    x = rng.uniform(-0.01, 1.01, (n, 3)).astype(np.float32)
    x[0], x[1], x[2], x[3] = 0.0, 1.0, [0.0, 1.0, 0.5], [1.0, 0.0, 0.25]
    x[4] = [1.5, 0.5, 0.5]  # outside
    for i, lv in enumerate(ts.levels() * 3):
        node = rng.integers(1, lv.resolution, 3)
        x[5 + i] = ((node - 0.5) / np.float32(lv.scale)).astype(np.float32)
    dy = rng.standard_normal((n, ts.output_dim)).astype(np.float32)
    g = rng.standard_normal((n, 3)).astype(np.float32)
    big_g = rng.standard_normal((ts.table_rows, 2)).astype(np.float32)
    oob = ((x < 0) | (x > 1)).any(-1)
    assert 0.01 < oob.mean() < 0.1
    return table, x, dy, g, big_g


def _jax_dx(js):
    def dx(t, x, dy):
        _, vjp = jax.vjp(lambda tt, xx: jhg.hashgrid_encode(tt, xx, js), t, x)
        return vjp(dy)
    return dx


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------- BWD


@pytest.mark.parametrize("need", [(True, True), (True, False),
                                  (False, True)],
                         ids=["both", "table", "dx"])
def test_bwd_plain_matches_jax_vjp(need):
    js, ts = _specs()
    table, x, dy, _, _ = _case()
    want_t, want_x = _jax_dx(js)(jnp.asarray(table), jnp.asarray(x),
                                 jnp.asarray(dy))
    got_t, got_x = thg.encode_backward_reference(*_t(table, x, dy), ts,
                                                 *need)
    assert (got_t is None) != need[0] and (got_x is None) != need[1]
    if need[0]:
        assert _rel(got_t, want_t) <= REL
    if need[1]:
        oob = ((x < 0) | (x > 1)).any(-1)
        assert np.all(got_x.numpy()[oob] == 0)
        assert _rel(got_x, want_x) <= REL


# ------------------------------------------------------------- BWD2


@pytest.mark.parametrize("need", [(True, True, True), (True, False, False),
                                  (False, True, False), (False, False, True)],
                         ids=["all", "table", "dy", "dx"])
def test_bwd2_plain_matches_jax_grad_of_grad(need):
    """BWD2 against JAX's vjp of the encoder's x-vjp (its grad-of-grad)
    under the cotangent g of dx01."""
    js, ts = _specs()
    table, x, dy, g, _ = _case(seed=1)

    def dx_of(t, xx, d):
        return _jax_dx(js)(t, xx, d)[1]

    _, vjp = jax.vjp(dx_of, jnp.asarray(table), jnp.asarray(x),
                     jnp.asarray(dy))
    want_t, want_x, want_dy = vjp(jnp.asarray(g))
    got_t, got_dy, got_x = thg.encode_backward2_reference(
        *_t(table, x, dy, g), ts, *need)
    for got, want, on in ((got_t, want_t, need[0]), (got_dy, want_dy,
                                                      need[1]),
                          (got_x, want_x, need[2])):
        assert (got is None) != on
        if on:
            assert float(np.abs(np.asarray(want)).max()) > 1.0
            assert _rel(got, want) <= REL


# ------------------------------------------------- the Function graph


@pytest.mark.parametrize("table_cot", [False, True],
                         ids=["dx", "dx_and_table"])
def test_hash_encode_graph_matches_jax(table_cot):
    """`torch.autograd.grad(create_graph=True)` through `hashgrid_encode`
    (HashEncode → HashEncodeBackward, BWD), then a second backward (BWD2
    and, with a cotangent G on the table grads, ENCODE and BWD with G as
    the table) against JAX's grad-of-grad, every input's gradient."""
    js, ts = _specs()
    table, x, dy, g, big_g = _case(seed=2)

    def jloss(t, xx, d):
        dt, dx = _jax_dx(js)(t, xx, d)
        out = jnp.sum(dx * g)
        return out + jnp.sum(dt * big_g) if table_cot else out

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(table), jnp.asarray(x), jnp.asarray(dy))
    tt, xt, dyt = (a.requires_grad_(True) for a in _t(table, x, dy))
    y = thg.hashgrid_encode(tt, xt, ts)
    assert y.grad_fn is not None and "HashEncode" in type(y.grad_fn).__name__
    if table_cot:
        dt, dx = torch.autograd.grad(y, (tt, xt), dyt, create_graph=True)
        loss = (dx * torch.from_numpy(g)).sum() + (
            dt * torch.from_numpy(big_g)).sum()
    else:
        (dx,) = torch.autograd.grad(y, xt, dyt, create_graph=True)
        loss = (dx * torch.from_numpy(g)).sum()
    loss.backward()
    for got, w in zip((tt.grad, xt.grad, dyt.grad), want):
        assert got is not None
        assert _rel(got, w) <= REL


def test_normal_pass_skips_the_table_scatter(monkeypatch):
    """The σ-gradient normal differentiates σ for x alone: its BWD computes
    dx01 only; the loss's backward then runs BWD2 (table, dy and, for the
    parameters only, no x) and BWD for the table (no dx01)."""
    from mirror_nerf_tpu_torch.ops.fused_cp_train import (
        density_with_grad_reference)

    calls = []
    real1, real2 = thg.encode_backward, thg.encode_backward2

    def bwd(*a):
        calls.append(("BWD", a[4:]))
        return real1(*a)

    def bwd2(*a):
        calls.append(("BWD2", a[5:]))
        return real2(*a)

    monkeypatch.setattr(thg, "encode_backward", bwd)
    monkeypatch.setattr(thg, "encode_backward2", bwd2)
    field = NGPField(bound=1.0, log2_hashmap_size=10)
    params = params_from_numpy({"f": field.init(
        torch.Generator().manual_seed(0))})["f"]
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    xyz = torch.rand((64, 3), generator=torch.Generator().manual_seed(1))
    sigma, _, grad = density_with_grad_reference(field, params, xyz * 1.6
                                                 - 0.8)
    assert calls == [("BWD", (False, True))]
    ((grad ** 2).sum() + sigma.sum()).backward(inputs=leaves)
    assert sorted(calls[1:]) == [("BWD", (True, False)),
                                 ("BWD2", (True, True, False))]
    assert float(params["grid"].grad.abs().max()) > 0


@pytest.mark.parametrize("wrt", ["table", "x"])
def test_grad_of_a_captured_leaf_is_wanted(monkeypatch, wrt):
    """`torch.autograd.grad` for a leaf input: the engine's query raises its
    leaf-capture error for that leaf, and its gradient is computed."""
    _, ts = _specs()
    table, x, dy, _ = _t(*_case(n=32, seed=7)[:4])
    tt, xt = (a.requires_grad_(True) for a in (table, x))
    calls = []
    real = thg.encode_backward

    def bwd(*a):
        calls.append(a[4:])
        return real(*a)

    monkeypatch.setattr(thg, "encode_backward", bwd)
    want = tt if wrt == "table" else xt
    (got,) = torch.autograd.grad(thg.hashgrid_encode(tt, xt, ts), want, dy)
    assert calls == [(wrt == "table", wrt == "x")]
    assert float(got.abs().max()) > 0


def test_engine_query_errors_propagate(monkeypatch):
    """Only the leaf-capture error means "wanted": any other error of the
    engine's query reaches the caller."""
    _, ts = _specs()
    table, x, dy, _ = _t(*_case(n=32, seed=7)[:4])
    tt, xt = (a.requires_grad_(True) for a in (table, x))
    y = thg.hashgrid_encode(tt * 1.0, xt * 1.0, ts)

    def broken(node):
        raise RuntimeError("engine state lost")

    monkeypatch.setattr(torch._C, "_will_engine_execute_node", broken)
    with pytest.raises(RuntimeError, match="engine state lost"):
        torch.autograd.grad(y, [tt, xt], dy)


def test_third_derivative_raises():
    _, ts = _specs()
    table, x, dy, g, _ = _case(n=32, seed=3)
    tt, xt = (a.requires_grad_(True) for a in _t(table, x))
    (dx,) = torch.autograd.grad(thg.hashgrid_encode(tt, xt, ts), xt,
                                torch.from_numpy(dy), create_graph=True)
    with pytest.raises(NotImplementedError, match="third derivative"):
        torch.autograd.grad((dx ** 2).sum(), tt, create_graph=True)


def test_cuda_wrappers_refuse_cpu_tensors():
    _, ts = _specs()
    table, x, dy, g = _t(*_case(n=64, seed=4)[:4])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        thg.encode_backward_cuda(table, x, dy, ts)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        thg.encode_backward2_cuda(table, x, dy, g, ts)


# ------------------------------------------------------------- tv_loss


def test_tv_loss_matches_jax():
    js, ts = _specs()
    table, x, _, _, _ = _case(seed=5)
    x = np.clip(x, 0.0, 1.0)
    want, want_g = jax.value_and_grad(
        lambda t: jhg.tv_loss(t, jnp.asarray(x), js, weight=1e-3))(
        jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    got = thg.tv_loss(tt, torch.from_numpy(x), ts, weight=1e-3)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert _rel(tt.grad, want_g) <= REL


# ------------------------------------------------- the grid-lr groups


def test_grid_lr_mult_reaches_the_hash_table():
    """The hash table is the field's "grid" leaf: `--grid_lr_mult` and
    `--coarse_grid_lr_mult` scale its steps as optax's scale_grid_updates
    does, the nets' not (three Adam steps)."""
    kw = dict(lr=1e-2, optimizer="adam", grid_lr_mult=20.0,
              coarse_grid_lr_mult=3.0, adam_eps=1e-15)
    field = NGPField(bound=1.0, log2_hashmap_size=10)
    g0 = torch.Generator().manual_seed(0)
    p = {"coarse": field.init(g0), "fine": field.init(g0)}
    pn = jax.tree_util.tree_map(lambda a: a.numpy(), p)
    tx = jax_optimizer(JaxConfig(**kw), 4)
    state = tx.init(pn)
    pt = params_from_numpy(pn)
    for leaf in tree_leaves(pt):
        leaf.requires_grad_(True)
    port = Optimizer(Config(**kw), pt, 4)
    assert sorted(gr["mult"] for gr in port.opt.param_groups) == [1.0, 3.0,
                                                                   20.0]
    rng = np.random.default_rng(0)
    pj = pn
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), pn)
        upd, state = tx.update(grads, state, pj)
        pj = jax.tree_util.tree_map(lambda a, u: a + u, pj, upd)
        for leaf, gl in zip(tree_leaves(pt), tree_leaves(
                params_from_numpy(grads))):
            leaf.grad = gl
        port.step(step)
    for a, b in zip(tree_leaves(params_from_numpy(
            jax.tree_util.tree_map(np.asarray, pj))), tree_leaves(pt)):
        np.testing.assert_allclose(b.detach().numpy(), a.numpy(),
                                   atol=1e-6, rtol=1e-5)


# ------------------------------------------------- Trainer trajectory


TRAJ = dict(img_wh=(16, 16), near=0.05, far=8.0, bound=1.0,
            model_type="nerf_tcnn", log2_hashmap_size=13, N_samples=4,
            N_importance=4, batch_size=64, num_epochs=2,
            predict_normal=True, predict_mirror_mask=True,
            trace_secondary_rays=True, only_trace_rays_in_mirrors=True,
            smooth_mirror_start_epoch=0, train_mirror_mask_start_epoch=0,
            train_normal_start_epoch=0, chunk=256, perturb=0.0,
            noise_std=0.0, fused_train="off", train_geometry_stage=True,
            train_geometry_stage_end_epoch=1, grid_lr_mult=3.0,
            adam_eps=1e-5)


def trajectory_matches_jax(tmp_path, traj: dict, edit=None):
    """Three reflection-stage steps, then one geometry-stage step, on the
    same batches of mirror pixels from the same initial parameters (the
    npz bridge; `edit(params, field)` changes the JAX Trainer's initial
    numpy params in place, so that σ and every leaf live); the loss of
    every step and every leaf at the end
    (the bars of tests/test_torch_port_train.py); returns the Trainer and
    the names of the leaves that moved. Shared with
    tests/test_torch_port_mlp_train.py."""
    from mirror_nerf_tpu.data.blender import BlenderDataset as JaxDS
    from mirror_nerf_tpu.parallel.mesh import get_mesh
    from mirror_nerf_tpu.train.loop import EpochStatics as JaxStatics
    from mirror_nerf_tpu.train.loop import Trainer as JaxTrainer
    from mirror_nerf_tpu_torch.data.blender import BlenderDataset
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.train.loop import EpochStatics, Trainer

    root = str(tmp_path / "scene")
    generate_scene(root, n_train=2, n_val=1, n_test=1, img_wh=traj["img_wh"])
    jcfg = JaxConfig(root_dir=root, **traj)
    cfg = Config(root_dir=root, **traj)
    jds = JaxDS(root, "train", jcfg.img_wh, jcfg)
    jt = JaxTrainer(jcfg, jds, str(tmp_path / "jax"), mesh=get_mesh())
    p0 = jax.tree_util.tree_map(np.array, jt.params)
    if edit is not None:
        edit(p0, jt.field)
    # on the trainer's shardings, or the second step compiles again
    params = jax.tree_util.tree_map(lambda a, ref: jax.device_put(
        a, ref.sharding), p0, jt.params)
    ds = BlenderDataset(root, "train", cfg.img_wh, cfg)
    pt = Trainer(cfg, ds, str(tmp_path / "port"), device="cpu", params=p0)
    ds.train_geometry_stage = jds.train_geometry_stage = False
    rays, rgbs, masks = ds.train_buffers()
    # batches that hold mirror pixels and others: the rays in an order
    # that interleaves the two
    order = np.argsort(np.arange(len(rays)) % 7, kind="stable")
    rays, rgbs, masks = rays[order], rgbs[order], masks[order]

    plan = [(JaxStatics.of(jcfg, 1, False), EpochStatics.of(cfg, 1, False))
            ] * 3 + [(JaxStatics.of(jcfg, 0, True),
                      EpochStatics.of(cfg, 0, True))]
    opt = jt.opt_state
    for i, (js, ps) in enumerate(plan):
        sl = slice(i * cfg.batch_size, (i + 1) * cfg.batch_size)
        assert float(masks[sl].max()) > 0.5  # batches with mirror pixels
        step = jt.get_step_fn(js)
        params, opt, aux = step(params, opt, {
            "rays": jnp.asarray(rays[sl]), "rgbs": jnp.asarray(rgbs[sl]),
            "mirror_mask": jnp.asarray(masks[sl])}, jax.random.PRNGKey(i))
        got = pt.train_step(ps, {"rays": torch.from_numpy(rays[sl]),
                                 "rgbs": torch.from_numpy(rgbs[sl]),
                                 "mirror_mask": torch.from_numpy(masks[sl])})
        np.testing.assert_allclose(float(got["loss"]), float(aux["loss"]),
                                   rtol=2e-4, err_msg=f"step {i}")
    moved = []
    for a, (name, b), a0 in zip(
            tree_leaves(jax.tree_util.tree_map(np.array, params)),
            _leaves(pt.params), tree_leaves(p0)):
        np.testing.assert_allclose(b.detach().numpy(), a, atol=5e-5,
                                   rtol=5e-4, err_msg=name)
        if not np.array_equal(a, a0):
            moved.append(name)
    return pt, moved


def test_trainer_trajectory_matches_jax(tmp_path):
    """The hash grid's trajectory: its tables (×1e4 so that σ and the
    normal losses live) learn through BWD and BWD2's plain versions, and
    every leaf moves."""
    def scale_dense_level(p0, field):
        # the ±1e-4 init leaves σ at ~0
        dense = sum(lv.size for lv in field.grid_spec.levels()
                    if not lv.use_hash)
        for side in p0.values():
            side["grid"][:dense] *= 1e4

    pt, moved = trajectory_matches_jax(tmp_path, TRAJ, scale_dense_level)
    assert len(moved) == len(tree_leaves(pt.params))


# ---------------------------------------------------- on a card only


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _full_case(n, seed):
    """The model's bound-6 spec, a ×1e4 table, n points (~4 % outside),
    dy, g and G on the card."""
    ts = NGPField(bound=6.0).grid_spec
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (ts.table_rows, 2)).astype(np.float32)
    x = rng.uniform(-0.02, 1.02, (n, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1.5, 0.5, 0.5]]
    dy = rng.standard_normal((n, ts.output_dim)).astype(np.float32)
    g = rng.standard_normal((n, 3)).astype(np.float32)
    return ts, [torch.from_numpy(a).cuda() for a in (table, x, dy, g)]


@pytest.mark.gpu
@pytest.mark.parametrize("need", [(True, True), (True, False),
                                  (False, True)],
                         ids=["both", "table", "dx"])
def test_cuda_bwd_matches_plain(need):
    """BWD's table grads within 1e-5 of scale (fp32 atomics in a
    run-to-run order), dx01 within 1e-5 of scale, 0 outside the cube."""
    _needs_card()
    ts, (table, x, dy, _) = _full_case(65_537, seed=7)
    got = thg.encode_backward(table, x, dy, ts, *need)
    want = thg.encode_backward_reference(table, x, dy, ts, *need)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a.cpu(), b.cpu()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("need", [(True, True, True), (True, False, False),
                                  (False, True, False), (False, False, True),
                                  (False, True, True)],
                         ids=["all", "table", "dy", "dx", "dy_dx"])
def test_cuda_bwd2_matches_plain(need):
    _needs_card()
    ts, (table, x, dy, g) = _full_case(65_537, seed=8)
    got = thg.encode_backward2(table, x, dy, g, ts, *need)
    want = thg.encode_backward2_reference(table, x, dy, g, ts, *need)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a.cpu(), b.cpu()) <= 1e-5


@pytest.mark.gpu
def test_cuda_graph_of_hash_encode():
    """The Function graph on the card (ENCODE, BWD, BWD2) against the same
    graph on the CPU (plain versions), with the launches counted."""
    _needs_card()
    ts, (table, x, dy, g) = _full_case(4099, seed=9)
    grads = {}
    for dev in ("cuda", "cpu"):
        tt, xt = (a.to(dev).clone().requires_grad_(True) for a in (table, x))
        n0 = (thg.launches_encode, thg.launches_bwd, thg.launches_bwd2)
        y = thg.hashgrid_encode(tt, xt, ts)
        (dx,) = torch.autograd.grad(y, xt, dy.to(dev), create_graph=True)
        ((dx * g.to(dev)).sum() + (y * dy.to(dev)).sum()).backward()
        grads[dev] = (dx.detach().cpu(), tt.grad.cpu(), xt.grad.cpu())
        n1 = (thg.launches_encode, thg.launches_bwd, thg.launches_bwd2)
        assert (np.subtract(n1, n0) > 0).all() == (dev == "cuda"), (n0, n1)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _rel(a, b) <= 1e-5


# ------------------------------- the eval tracer about ∇σ (item [10])


@pytest.mark.parametrize("model", ["nerf_tpu", "nerf_tcnn", "nerf"])
def test_eval_normal_route_follows_the_device(model):
    """Without `--predict_normal` the eval's σ-gradient normal takes the
    kernel route on the card and the plain version on the CPU, whatever the
    training flag `--fused_train` says; the renderer picks the CP grid's
    train kernel by the field (`supports_fused_train`)."""
    from mirror_nerf_tpu_torch.eval.apps import AppContext
    from mirror_nerf_tpu_torch.eval.cli import get_opt
    from mirror_nerf_tpu_torch.models.fields import make_field

    for flag in ("auto", "off", "on"):
        cfg, args = get_opt(["--model_type", model, "--fused_train", flag,
                             "--trace_secondary_rays"])
        field = make_field(cfg)
        for device, want in (("cpu", False), ("cuda", True)):
            ctx = AppContext.build(cfg, args, field, {}, device)
            assert ctx.rs.compute_normal
            assert ctx.rs.fused_density is want, (flag, device)
    assert getattr(field, "supports_fused_train", False) is (
        model == "nerf_tpu")


def test_eval_trace_without_predict_normal_matches_jax():
    """Without `--predict_normal` the eval tracer reflects about the
    σ-gradient normal (`surface_normal_grad_*`, ∇σ through HashEncode's
    backward under no_grad): level 2 against JAX's eval_trace on the
    half-space scene of tests/test_torch_port_ngp_slice.py."""
    from mirror_nerf_tpu.eval.apps import EvalAppFlags as JaxApp
    from mirror_nerf_tpu.eval.apps import eval_trace as jax_eval_trace
    from mirror_nerf_tpu.models.ngp import NGPField as JaxNGP
    from mirror_nerf_tpu.render.renderer import RenderSettings as JaxRS
    from mirror_nerf_tpu_torch.eval.apps import EvalAppFlags, eval_trace
    from mirror_nerf_tpu_torch.render.renderer import RenderSettings
    from test_torch_port_ngp_slice import RS, TRACE_ATOL, _half_space_params

    jf = JaxNGP(bound=6.0, predict_normal=False)
    tf = NGPField(bound=6.0, predict_normal=False)
    p = {"coarse": _half_space_params(jf, 0),
         "fine": _half_space_params(jf, 1)}
    rng = np.random.default_rng(0)
    n = 64
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    o[:, 1:] = rng.normal(size=(n, 2)) * 0.2
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] *= 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.1, np.float32),
                           np.full((n, 1), 1.5, np.float32)], axis=1)
    rs = dict(RS, compute_normal=True)
    want = jax_eval_trace(jf, p, jnp.asarray(rays), jax.random.PRNGKey(0),
                          JaxRS(**rs), JaxApp(), 2, True)
    with torch.no_grad():
        got = eval_trace(tf, params_from_numpy(p), torch.from_numpy(rays),
                         RenderSettings(**rs), EvalAppFlags(), 2, True)
    assert "surface_normal_fine" not in got
    assert 0.25 <= float(got["mirror_mask_resolved"].mean()) <= 0.75
    for k in ("rgb_fine", "depth_fine", "mirror_mask_resolved",
              "surface_normal_grad_fine", "reflect_direction",
              "rgb_fine_reflect", "depth_fine_reflect", "rgb_fine_direct"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TRACE_ATOL, rtol=0, err_msg=k)
