"""Field factory (torch counterpart of `mirror_nerf_tpu/models/fields.py`).

Only the CP-grid model (`--model_type nerf_tpu`) is ported; the PE-MLP
flagship (`nerf`) and the hash-grid model (`nerf_tcnn`) raise until their
slices land (ROADMAP.md queue 1, items 2 and 4).
"""

from __future__ import annotations

from .tpugrid import TPUGridField


def parse_grid_levels(spec: str):
    """"res:rank,res:rank,..." -> ((res, rank), ...)."""
    return tuple((int(g), int(r))
                 for g, r in (lv.split(":") for lv in spec.split(",") if lv))


def make_field(cfg) -> TPUGridField:
    """Build the field described by a Config (model_type dispatch)."""
    if cfg.model_type != "nerf_tpu":
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not ported yet (ROADMAP.md "
            "queue 1: 'nerf' is item 2, 'nerf_tcnn' item 4); only "
            "'nerf_tpu' is")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "the port computes in float32 only; bf16 comes with the faster "
            "kernels of ROADMAP.md queue 2")
    return TPUGridField(
        bound=cfg.bound,
        predict_normal=cfg.predict_normal,
        predict_mirror_mask=cfg.predict_mirror_mask,
        compute_dtype=cfg.compute_dtype,
        grid_levels=parse_grid_levels(cfg.grid_levels),
    )
