"""Whitted tracer constants (torch counterpart of
`mirror_nerf_tpu/render/tracer.py`). The training tracer `trace_rays` comes
with the training slice (ROADMAP.md queue 1, item 1)."""

# offset pushing secondary-ray origins off the mirror surface
# (reference train.py:232: ray_forward_offset = 0.1)
RAY_FORWARD_OFFSET = 0.1
