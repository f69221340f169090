"""Port parity, `mirror_nerf_tpu_torch/native.py`: the port's build of
`native/src/raygen.cpp` (its own build directory) against the JAX
package's `native` bindings and the numpy versions, bit for bit where the
C++ computes the same thing (the same source and flags), and each binding's
numpy fallback when the library cannot be built."""

import ctypes

import numpy as np
import pytest

from mirror_nerf_tpu import native as jax_native
from mirror_nerf_tpu_torch import native
from mirror_nerf_tpu_torch.core.rays import (get_ray_directions, get_rays,
                                             make_ray_buffer)


@pytest.fixture(scope="module")
def libs():
    lib, jlib = native.get_lib(), jax_native.get_lib()
    if lib is None or jlib is None:
        pytest.skip("native library unavailable (no compiler)")
    return lib, jlib


def _c2w(seed=0):
    rng = np.random.default_rng(seed)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    c2w[:, 3] = [0.3, -0.2, 1.1]
    return c2w


def test_library_built_in_the_port_build_dir(libs):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert "native/build" not in str(path)


def test_generate_rays_matches_jax_native_and_numpy(libs):
    c2w = _c2w()
    H, W, focal = 37, 53, 41.5
    got = native.generate_rays(c2w, H, W, focal, 0.05, 8.0)
    np.testing.assert_array_equal(
        got, jax_native.generate_rays(c2w, H, W, focal, 0.05, 8.0))
    o, d = get_rays(get_ray_directions(H, W, focal), c2w)
    np.testing.assert_allclose(got, make_ray_buffer(o, d, 0.05, 8.0),
                               rtol=1e-5, atol=1e-6)


def test_gather_batch_matches_jax_native_and_numpy(libs):
    rng = np.random.default_rng(1)
    n, k = 10000, 512
    rays = rng.normal(size=(n, 8)).astype(np.float32)
    rgbs = rng.normal(size=(n, 3)).astype(np.float32)
    masks = rng.normal(size=(n,)).astype(np.float32)
    idx = rng.integers(0, n, k)
    got = native.gather_batch(rays, rgbs, masks, idx)
    for a, b, c in zip(got, jax_native.gather_batch(rays, rgbs, masks, idx),
                       (rays[idx], rgbs[idx], masks[idx])):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_blend_rgba_matches_jax_native_and_numpy(libs):
    img = np.random.default_rng(2).integers(0, 256, (5000, 4)).astype(
        np.uint8)
    rgb, valid = native.blend_rgba(img)
    jrgb, jvalid = jax_native.blend_rgba(img)
    np.testing.assert_array_equal(rgb, jrgb)
    np.testing.assert_array_equal(valid, jvalid)
    f = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(rgb, f[:, :3] * f[:, 3:4] + (1.0 - f[:, 3:4]),
                               atol=1e-6)
    np.testing.assert_array_equal(valid, img[:, 3] > 0)


def test_shuffle_is_the_same_permutation(libs):
    lib, jlib = libs
    out = []
    for lb in (lib, jlib):
        idx = np.arange(1000, dtype=np.int64)
        lb.mn_shuffle_indices(
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx), 42)
        out.append(idx)
    np.testing.assert_array_equal(out[0], out[1])
    assert sorted(out[0]) == list(range(1000))


def test_numpy_fallback_without_a_library(monkeypatch):
    """Where no library can be built, each binding returns the numpy
    version's values (the JAX package's fallbacks)."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert native.get_lib() is None
    c2w = _c2w(3)
    o, d = get_rays(get_ray_directions(9, 7, 6.0), c2w)
    np.testing.assert_array_equal(native.generate_rays(c2w, 9, 7, 6.0, 0.1,
                                                       4.0),
                                  make_ray_buffer(o, d, 0.1, 4.0))
    rng = np.random.default_rng(4)
    rays, rgbs = rng.normal(size=(50, 8)), rng.normal(size=(50, 3))
    masks, idx = rng.normal(size=50), rng.integers(0, 50, 9)
    for a, b in zip(native.gather_batch(rays, rgbs, masks, idx),
                    (rays[idx], rgbs[idx], masks[idx])):
        np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 256, (20, 4)).astype(np.uint8)
    rgb, valid = native.blend_rgba(img)
    np.testing.assert_array_equal(valid, img[:, 3] > 0)


def test_failed_build_falls_back(monkeypatch, tmp_path):
    """A compiler that fails leaves no library behind and no temp file."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    out = tmp_path / "lib.so"
    assert not native._build(out)
    assert list(tmp_path.iterdir()) == []
