"""Port parity, training the flagship PE-MLP (`--model_type nerf`, 8×256,
posenc 10/4, both heads): σ, the trunk features and ∇σ of
`density_with_grad_reference` and the grad-of-grad of a loss on ∇σ into
every parameter, against the JAX package's `_density_with_grad` under
`jax.grad`; a fixed-seed Trainer trajectory against the JAX Trainer. The
flagship needs no kernel to train (the JAX package trains it on XLA):
on the card its products are cuBLAS in full fp32 (`allow_tf32` off)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mirror_nerf_tpu.models.fields import MirrorNeRFField as JaxField
from mirror_nerf_tpu.render.renderer import _density_with_grad
from mirror_nerf_tpu_torch.models.fields import MirrorNeRFField
from mirror_nerf_tpu_torch.ops.fused_cp_train import (
    density_with_grad_reference)
from mirror_nerf_tpu_torch.train.checkpoints import (_leaves,
                                                     params_from_numpy,
                                                     tree_leaves)
from test_torch_port_hash_train import TRAJ as HASH_TRAJ
from test_torch_port_hash_train import trajectory_matches_jax


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(
        1.0, float(np.abs(want).max()))


def test_density_grad_of_grad_matches_jax():
    """A loss on σ and ∇σ (the normal losses' shape): its value and its
    gradient in every leaf, through autograd's double backward of the
    posenc, the trunk (skip at 4) and the σ head. fp32 products in another
    order: 2e-5 of each leaf's scale."""
    jf = JaxField()
    p = jax.tree_util.tree_map(np.asarray, jf.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    g = rng.standard_normal((64, 3)).astype(np.float32)
    c = rng.standard_normal((64,)).astype(np.float32)

    def jloss(params):
        sigma, geo, grad = _density_with_grad(jf, params, jnp.asarray(xyz))
        return jnp.sum(grad * g) + jnp.sum(sigma * c) + 1e-3 * jnp.sum(geo)

    want, want_g = jax.value_and_grad(jloss)(p)
    tf = MirrorNeRFField()
    pt = params_from_numpy(p)
    for leaf in tree_leaves(pt):
        leaf.requires_grad_(True)
    sigma, geo, grad = density_with_grad_reference(tf, pt,
                                                   torch.from_numpy(xyz))
    assert grad.requires_grad  # differentiable: the graph is kept
    loss = ((grad * torch.from_numpy(g)).sum() + (sigma * torch.from_numpy(
        c)).sum() + 1e-3 * geo.sum())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=2e-5)
    for a, b in zip(tree_leaves(jax.tree_util.tree_map(np.asarray, want_g)),
                    tree_leaves(pt)):
        got = np.zeros_like(a) if b.grad is None else b.grad.numpy()
        assert _rel(got, a) <= 2e-5
    live = [b for b in tree_leaves(pt) if b.grad is not None]
    assert len(live) == 2 * len(pt["trunk"]) + 2  # the trunk and σ head


# 6 position frequencies: at 10 the reflection stage's color gradient at
# the seeded init is ill-conditioned in fp32 (it flows through the traced
# ray's origin into posenc's 2⁹ band: the port's fp32 gradient of the σ
# head is 1.5 % off its float64 one, JAX's 13 %); at 6 both are within
# 2e-3 of float64 and agree to 5e-5. Adam's eps 1e-4: with the coarse σ
# lifted, the first step's gradients of port and JAX agree within 8e-5 of
# each leaf's largest entry and lie as far from float64 (≤ 1e-3 of it);
# at eps 1e-5 Adam's division by √v + eps turned that rounding into
# 6.7e-5 after four steps in 4 of the 65,536 entries of a coarse trunk
# weight
TRAJ = dict(HASH_TRAJ, model_type="nerf", N_emb_xyz=6, adam_eps=1e-4)


def test_trainer_trajectory_matches_jax(tmp_path):
    """Three reflection-stage steps, then one geometry-stage step, from the
    JAX Trainer's initial parameters (8×256, both heads): the loss of
    every step and every leaf (tests/test_torch_port_train.py's bars)."""
    def lift_coarse_sigma(p0, field):
        # the coarse field's σ is ≤ 0 at this init (no weight, no gradient,
        # in JAX too): its bias lifted, every leaf of both fields learns
        p0["coarse"]["sigma"]["b"] += 1.0

    pt, moved = trajectory_matches_jax(tmp_path, TRAJ, lift_coarse_sigma)
    assert moved == [n for n, _ in _leaves(pt.params)]


def test_plain_exponentials_immune_to_the_exp_fault(monkeypatch):
    """F5 in the renderer's and the CP composite's plain exponentials: with
    torch.exp faulted as MKL's first fp32 call can be (one thread's share
    of 32768 values off by 1.5e-4, tests/test_torch_port_probes.py),
    `_composite_weights` (relu and softplus) and `fused_cp.prefix_weights`
    return the same values as without the fault, where the former
    torch.exp versions miss 1e-5."""
    from mirror_nerf_tpu_torch.ops.fused_cp import prefix_weights
    from mirror_nerf_tpu_torch.render.renderer import _composite_weights
    from test_torch_port_probes import _faulty_exp

    rng = np.random.default_rng(0)
    sigmas = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    z = torch.from_numpy(np.sort(rng.uniform(0.1, 4.0, (256, 128)), -1)
                         .astype(np.float32))
    noise = torch.zeros_like(sigmas)
    sd = torch.from_numpy(rng.uniform(0.0, 0.05, (256, 128)).astype(
        np.float32))
    clean = [_composite_weights(sigmas, z, noise, act)
             for act in ("relu", "softplus")] + [prefix_weights(sd)]
    _faulty_exp(monkeypatch)
    faulted = [_composite_weights(sigmas, z, noise, act)
               for act in ("relu", "softplus")] + [prefix_weights(sd)]
    for a, b in zip(clean, faulted):
        assert torch.equal(a, b)
    excl = torch.cat([torch.zeros_like(sd[:, :1]),
                      torch.cumsum(sd[:, :-1], dim=-1)], dim=-1)
    old = torch.exp(-excl) * (1.0 - torch.exp(-sd))
    assert float((old - clean[2]).abs().max()) > 1e-5
