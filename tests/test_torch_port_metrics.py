"""Port parity, LPIPS: `eval/lpips.py` against the JAX package's
`eval/lpips_jax.lpips_forward` on seeded random AlexNet and lin weights in
both of its layouts (npz, and a torch state dict with torchvision and lpips
keys); NaN without a weight file and on an unusable one; the card by
default, a call with no device raising where there is none; and the eval
CLI's
`mean_lpips` / `lpips` in psnr.json, written exactly when JAX's eval.py
writes them, each score equal to JAX's forward on the same images.

The pretrained weights are not in the repository; random weights (He
scale) give O(0.1–1) distances, enough to hold the forward to 1e-5."""

import json
import os

import numpy as np
import pytest
import torch

from mirror_nerf_tpu.eval.lpips_jax import _load_weights as jax_load
from mirror_nerf_tpu.eval.lpips_jax import lpips_forward as jax_lpips
from mirror_nerf_tpu_torch.eval import lpips as tl
from mirror_nerf_tpu_torch.eval.metrics import lpips

ATOL = 1e-5
_ALEX = ((3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
         (256, 256, 3))


def _weights(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    w = {}
    for i, (cin, cout, k) in enumerate(_ALEX):
        w[f"conv{i}/w"] = (rng.normal(size=(cout, cin, k, k))
                           * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)
        w[f"conv{i}/b"] = (rng.normal(size=cout) * 0.05).astype(np.float32)
        w[f"lin{i}/w"] = rng.uniform(0, 0.5, size=cout).astype(np.float32)
    return w


def _write(path, w, layout):
    if layout == "npz":
        np.savez(path, **w)
        return
    sd = {}
    for i, fi in enumerate((0, 3, 6, 8, 10)):
        sd[f"net.features.{fi}.weight"] = torch.from_numpy(w[f"conv{i}/w"])
        sd[f"net.features.{fi}.bias"] = torch.from_numpy(w[f"conv{i}/b"])
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(
            w[f"lin{i}/w"].reshape(1, -1, 1, 1))
    torch.save({"state_dict": sd}, path)


def _images(h, w, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("layout,name", [("npz", "w.npz"),
                                         ("torch", "alex.pth")])
def test_lpips_matches_jax_in_both_layouts(layout, name, tmp_path):
    path = str(tmp_path / name)
    _write(path, _weights(), layout)
    jw = jax_load(path)
    tw = tl.load_weights(path)
    assert sorted(jw) == sorted(tw)
    for k in jw:
        np.testing.assert_array_equal(tw[k], jw[k])
    for h, w in ((64, 64), (96, 80)):
        a, b = _images(h, w)
        want = jax_lpips(jw, a, b)
        got = lpips(a, b, path, device="cpu")
        assert np.isfinite(got) and got > 0.01
        assert abs(got - want) <= ATOL, (h, w, got, want)
    assert lpips(a, a, path, device="cpu") == pytest.approx(0.0, abs=1e-6)


def test_lpips_nan_without_or_with_a_bad_file(tmp_path, monkeypatch):
    a, b = _images(64, 64)
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    assert np.isnan(lpips(a, b))
    assert np.isnan(lpips(a, b, str(tmp_path / "absent.npz")))
    bad = tmp_path / "bad.pth"
    bad.write_bytes(b"not a torch file")
    with pytest.warns(UserWarning, match="LPIPS weights unusable"):
        assert np.isnan(lpips(a, b, str(bad), device="cpu"))
    partial = str(tmp_path / "partial.pth")
    torch.save({"features.0.weight": torch.zeros(1)}, partial)
    with pytest.warns(UserWarning, match="missing AlexNet"):
        assert np.isnan(lpips(a, b, partial, device="cpu"))
    # a pickled object that is not a state dict is refused, not run
    pickled = str(tmp_path / "pickled.pth")
    torch.save({"features.0.weight": _Pickled()}, pickled)
    with pytest.warns(UserWarning, match="LPIPS weights unusable"):
        assert np.isnan(lpips(a, b, pickled, device="cpu"))


class _Pickled:
    """An arbitrary class: `torch.load(weights_only=True)` refuses it."""


def test_lpips_runs_on_the_card_by_default(tmp_path):
    """With no device argument the score is the card's: on a machine
    without one, both entry points raise (no silent scoring on the host);
    with a card, the weights land on CUDA."""
    path = str(tmp_path / "w.npz")
    _write(path, _weights(4), "npz")
    a, b = _images(64, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            lpips(a, b, path)
        with pytest.raises((RuntimeError, AssertionError)):
            tl.lpips_from_file(a, b, path)
        return
    got = lpips(a, b, path)
    assert tl._CACHE[(os.path.abspath(path), "cuda")]["conv0/w"].is_cuda
    assert abs(got - lpips(a, b, path, device="cpu")) <= ATOL


def test_lpips_weights_cached_per_device(tmp_path, monkeypatch):
    path = str(tmp_path / "w.npz")
    _write(path, _weights(2), "npz")
    monkeypatch.setenv("LPIPS_WEIGHTS", path)
    a, b = _images(64, 64)
    first = lpips(a, b, device="cpu")
    key = (os.path.abspath(path), "cpu")
    assert key in tl._CACHE
    assert tl._CACHE[key]["conv0/w"].device.type == "cpu"
    assert lpips(a, b, device="cpu") == first


@pytest.mark.parametrize("weights", [True, False], ids=["weights", "none"])
def test_eval_cli_writes_mean_lpips(weights, tmp_path, monkeypatch):
    """Two 40×40 views of a generated scene through the eval CLI on the
    CPU: with $LPIPS_WEIGHTS, psnr.json holds `lpips` (one score a view,
    each JAX's forward on the CLI's own images) and `mean_lpips`; without,
    neither key."""
    from mirror_nerf_tpu_torch.data.synthetic import generate_scene
    from mirror_nerf_tpu_torch.eval import cli, metrics

    generate_scene(str(tmp_path / "scene"), n_train=1, n_val=1, n_test=2,
                   img_wh=(40, 40))
    path = str(tmp_path / "w.npz")
    _write(path, _weights(3), "npz")
    if weights:
        monkeypatch.setenv("LPIPS_WEIGHTS", path)
    else:
        monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    seen = []
    real = metrics.lpips

    def spy(pred, gt, weights_path=None, device="cuda"):
        seen.append((np.array(pred), np.array(gt)))
        return real(pred, gt, weights_path, device)

    monkeypatch.setattr(metrics, "lpips", spy)
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops under pytest -n 6
    try:
        out = cli.main([
            "--dataset_name", "blender", "--root_dir", "scene",
            "--img_wh", "40", "40", "--model_type", "nerf_tpu",
            "--grid_levels", "16:8,32:8", "--bound", "6", "--near", "0.05",
            "--far", "8", "--N_samples", "8", "--N_importance", "8",
            "--predict_normal", "--predict_mirror_mask", "--split", "test",
            "--exp_name", "lp", "--device", "cpu", "--not_save_depth"])
    finally:
        torch.set_num_threads(n)
    table = json.load(open(os.path.join(out, "psnr.json")))
    assert len(seen) == 2 and len(table["psnrs"]) == 2
    if not weights:
        assert "mean_lpips" not in table and "lpips" not in table
        return
    jw = jax_load(path)
    want = [jax_lpips(jw, pred, gt) for pred, gt in seen]
    assert len(table["lpips"]) == 2
    np.testing.assert_allclose(table["lpips"], want, atol=ATOL, rtol=0)
    assert table["mean_lpips"] == pytest.approx(np.mean(table["lpips"]))
