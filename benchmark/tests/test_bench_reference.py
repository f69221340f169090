"""The benchmark's plain reference against the port at a tiny size on the
CPU (the port's kernels run their plain versions there): one view of each
configuration traced to level 2, and one flagship train step's loss and
gradients."""

import tempfile

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import train as train_drv
from benchmark.drivers import views as views_drv
from benchmark.reference import common
from benchmark.reference import train as ref_train
from benchmark.reference.weights import leaves

CPU = torch.device("cpu")


def _view_setup(name: str, seed: int):
    cell = harness.any_cell(name, overrides={"view_wh": [16, 12]})
    s = views_drv.Setup(cell, harness.reference(cell), seed, CPU)
    params, _ = s.weights()
    return cell, s, params


@pytest.mark.parametrize("name", ["flagship.view.mirror",
                                  "hashgrid.view.mirror"])
def test_parameter_trees_match_the_port(name):
    from mirror_nerf_tpu_torch.eval.cli import get_opt
    from mirror_nerf_tpu_torch.models.fields import make_field

    cell, s, params = _view_setup(name, 5)
    cfg, _ = get_opt(list(cell.config["eval_flags"]))
    port = make_field(cfg).init(torch.Generator().manual_seed(0), CPU)
    ours = dict(leaves(params["fine"]))
    theirs = dict(leaves(port))
    assert {p: tuple(v.shape) for p, v in ours.items()} == {
        p: tuple(v.shape) for p, v in theirs.items()}


@pytest.mark.parametrize("name", ["flagship.view.mirror",
                                  "hashgrid.view.mirror"])
def test_view_to_level_two_matches_the_port(name):
    from mirror_nerf_tpu_torch.eval.apps import AppContext, run_view
    from mirror_nerf_tpu_torch.eval.cli import get_opt
    from mirror_nerf_tpu_torch.models.fields import make_field

    cell, s, params = _view_setup(name, 21)
    cfg, args = get_opt(s.flags + ["--img_wh", "16", "12", "--device",
                                   "cpu"])
    ctx = AppContext.build(cfg, args, make_field(cfg), params, CPU)
    res = run_view(ctx, {"rays": s.rays[2]})
    ref = common.trace_eval(s.field, params, torch.from_numpy(s.rays[2]),
                            2, s.n_samples, s.n_importance, "fp32")
    # rays off the mask's threshold, and not dropped by the port's level-2
    # capacity (its prepass pads a view this small with its last ray)
    ok = np.abs(ref["mask_value"][0].numpy() - 0.5) > 1e-3
    ok &= res.get("compact_dropped", np.zeros(len(ok))) == 0
    m0 = ref["mask"].numpy() > 0.5
    assert m0.any() and ok.mean() > 0.5
    np.testing.assert_allclose(res["rgb_fine"][ok], ref["rgb"].numpy()[ok],
                               atol=1e-5)
    np.testing.assert_allclose(res["depth_fine"], ref["depth"].numpy(),
                               atol=1e-4)
    # the mirror logits carry the calibration's gain (~1e4): 1e-4 of mask
    np.testing.assert_allclose(res["mirror_mask_fine"],
                               ref["mask_value"][0].numpy(), atol=1e-4)
    np.testing.assert_array_equal(res["mirror_mask_resolved"][ok], m0[ok])
    np.testing.assert_allclose(res["depth_fine_reflect"][ok & m0],
                               ref["depth_reflect"].numpy()[ok & m0],
                               atol=1e-4)


def _train_cell():
    cell = harness.find_cell("flagship.train.reflect")
    flags = list(cell.config["train_flags"])
    for k, v in (("--batch_size", "64"), ("--N_importance", "8"),
                 ("--novel_ray_batch", "32")):
        flags[flags.index(k) + 1] = v
    cell.overrides.update({"train_flags": flags + ["--N_samples", "8"],
                           "view_wh": [8, 8], "trace_schedule": [1, 1, 2]})
    return cell


def test_train_step_matches_the_port():
    from mirror_nerf_tpu_torch.train.loop import EpochStatics, Trainer

    cell = _train_cell()
    data, field, p0, cfg, warm = train_drv.setup(
        cell, harness.reference(cell), 77, CPU)
    trainer = Trainer(cfg, data, tempfile.mkdtemp(), device=CPU, params=p0)
    idx = warm[:cfg.batch_size]
    batch = {"rays": torch.from_numpy(data.all_rays[idx]),
             "rgbs": torch.from_numpy(data.all_rgbs[idx]),
             "mirror_mask": torch.from_numpy(data.all_masks[idx])}
    assert 0 < float(batch["mirror_mask"].mean()) < 1
    statics = EpochStatics.of(trainer.cfg, cell.get("epoch"), False)
    assert statics.enable_plane_loss and statics.enable_novel_reg
    loss, _ = trainer.loss_and_aux(statics, batch)
    grads = torch.autograd.grad(loss, [x for _, x in leaves(trainer.params)],
                                allow_unused=True)

    g = torch.Generator().manual_seed(cfg.seed)
    mine = {p: x.detach().clone().requires_grad_(True)
            for p, x in leaves(p0)}
    ref_loss, _ = ref_train.step_loss(field, train_drv._rebuild(p0, mine),
                                      batch, g, train_drv.settings(cfg),
                                      "fp32")
    ref_grads = torch.autograd.grad(ref_loss, list(mine.values()),
                                    allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-6)
    norms = [0.0 if r is None else float(r.norm()) for r in ref_grads]
    med = float(np.median(norms))
    for ours, ref, n in zip(grads, ref_grads, norms):
        ours = 0.0 if ours is None else float(ours.norm())
        assert abs(ours - n) <= 1e-3 * max(n, med)


def test_adam_matches_torch():
    torch.manual_seed(0)
    x = torch.randn(64, 8)
    mine, theirs = x.clone(), x.clone().requires_grad_(True)
    opt = torch.optim.Adam([theirs], lr=5e-4, eps=1e-15)
    adam = ref_train.Adam([mine], lr=5e-4, eps=1e-15)
    for _ in range(3):
        g = torch.randn(64, 8)
        theirs.grad = g.clone()
        opt.step()
        adam.step([mine], [g])
    np.testing.assert_allclose(mine.numpy(), theirs.detach().numpy(),
                               atol=1e-9)
