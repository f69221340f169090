"""Port parity, the encoders: `sh_encode` at degrees 1–8 (values and the
gradient) and every `get_encoder` name against the JAX package's
`models/encoding.py`, with its output dims; the grid encoders on specs the
hash-grid kernel takes (through `hashgrid_encode`, its plain versions on the
CPU) and on specs it does not (2-d inputs, align_corners, 4 features a
level: the plain encoder by autograd on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_nerf_tpu.models.encoding import get_encoder as jax_get_encoder
from mirror_nerf_tpu.ops.sh import sh_encode as jax_sh
from mirror_nerf_tpu_torch.models.encoding import get_encoder, kernel_takes
from mirror_nerf_tpu_torch.ops.sh import sh_encode

# the recurrence's fp32 rounding: XLA contracts some of its products into
# FMAs; the port's distance from float64 is within 1.3e-6 at degree 8
SH_ATOL = 4e-6
# the grid encoders at identical positions: fp32 summation order (tables
# ×1e4, O(1) features)
GRID_ATOL = 1e-5


def _dirs(n=2000, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode_matches_jax(degree):
    d = _dirs()
    want = np.asarray(jax.jit(lambda x: jax_sh(x, degree))(d))
    x = torch.from_numpy(d).requires_grad_(True)
    got = sh_encode(x, degree)
    assert got.shape == want.shape == (len(d), degree * degree)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=SH_ATOL,
                               rtol=0)
    if degree == 1:  # a constant
        return
    # backward: autograd against jax.grad of the same weighted sum
    w = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    gj = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jax_sh(x, degree) * w)))(d))
    (gt,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), x)
    scale = float(np.abs(gj).max())
    np.testing.assert_allclose(gt.numpy(), gj, atol=SH_ATOL * scale, rtol=0)


def test_sh_encode_degree_range():
    for bad in (0, 9):
        with pytest.raises(ValueError, match="degree"):
            sh_encode(torch.zeros(1, 3), bad)


def _points(n, dim, seed=2):
    """Dyadic points in (−1, 1): x + 1 and its half are exact in fp32, so
    both packages put every point at the same x01."""
    k = np.random.default_rng(seed).integers(1, 2 ** 12, size=(n, dim))
    return (k / 2.0 ** 11 - 1.0).astype(np.float32)


@pytest.mark.parametrize("name,kw", [
    ("None", {}),
    ("frequency", dict(multires=6)),
    ("frequency", dict(multires=10)),
    ("sphere_harmonics", dict(degree=4)),
    ("sphere_harmonics", dict(degree=7)),
], ids=["none", "freq6", "freq10", "sh4", "sh7"])
def test_plain_encoders_match_jax(name, kw):
    x = _dirs(500)
    jenc, jdim = jax_get_encoder(name, **kw)
    enc, dim = get_encoder(name, **kw)
    want = np.asarray(jenc(jnp.asarray(x)))
    got = enc(torch.from_numpy(x)).numpy()
    assert dim == jdim == want.shape[-1] == got.shape[-1]
    np.testing.assert_allclose(got, want, atol=SH_ATOL, rtol=0)


GRIDS = {
    # specs the kernel takes (hashgrid_encode; its plain version here)
    "hashgrid": ("hashgrid", dict(num_levels=6, log2_hashmap_size=12,
                                  desired_resolution=256)),
    "tiledgrid": ("tiledgrid", dict(num_levels=6, log2_hashmap_size=12,
                                    desired_resolution=256)),
    # specs it does not: the plain encoder (item 15 on the card)
    "hash_2d": ("hashgrid", dict(input_dim=2, num_levels=4,
                                 log2_hashmap_size=10,
                                 desired_resolution=128)),
    "hash_align": ("hashgrid", dict(num_levels=4, log2_hashmap_size=10,
                                    desired_resolution=128,
                                    align_corners=True)),
    "tiled_4feat": ("tiledgrid", dict(num_levels=3, level_dim=4,
                                      log2_hashmap_size=10,
                                      desired_resolution=64)),
}


@pytest.mark.parametrize("case", list(GRIDS))
def test_grid_encoders_match_jax(case):
    """The table JAX's encoder initializes (×1e4), at identical positions:
    values, output dims, and the table and position gradients of a
    weighted sum."""
    name, kw = GRIDS[case]
    jenc, jdim = jax_get_encoder(name, **kw)
    enc, dim = get_encoder(name, **kw)
    assert dim == jdim == enc.spec.output_dim
    assert enc.spec.table_rows == jenc.spec.table_rows
    assert kernel_takes(enc.spec) == (case in ("hashgrid", "tiledgrid"))
    table = np.asarray(jenc.init(jax.random.PRNGKey(3))) * np.float32(1e4)
    x = _points(700, enc.spec.input_dim)
    w = np.random.default_rng(4).normal(size=(700, dim)).astype(np.float32)

    def jax_loss(t, p):
        return jnp.sum(jenc(t, p, bound=1.0) * w)

    want = np.asarray(jax.jit(lambda t, p: jenc(t, p, bound=1.0))(table, x))
    gt_j, gx_j = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(table, x)
    t = torch.from_numpy(table).requires_grad_(True)
    p = torch.from_numpy(x).requires_grad_(True)
    got = enc(t, p, bound=1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=GRID_ATOL,
                               rtol=0)
    g_t, g_x = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (t, p))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(gt_j), atol=1e-4,
                               rtol=1e-5)
    scale = float(np.abs(np.asarray(gx_j)).max())
    np.testing.assert_allclose(g_x.numpy(), np.asarray(gx_j),
                               atol=1e-4 * scale, rtol=0)


def test_grid_encoder_init_shapes():
    enc, dim = get_encoder("hashgrid", num_levels=4, log2_hashmap_size=10)
    table = enc.init(torch.Generator().manual_seed(0))
    assert table.shape == (enc.spec.table_rows, 2) and dim == 8
    assert float(table.abs().max()) <= 1e-4


def test_unknown_encoding_raises():
    with pytest.raises(NotImplementedError, match="Unknown encoding"):
        get_encoder("fourier")
