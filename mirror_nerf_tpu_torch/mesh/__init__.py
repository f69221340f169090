"""Colored mesh extraction, run.sh mode 2
(`python -m mirror_nerf_tpu_torch.mesh`, see `cli.py`)."""

from .cli import get_opt, main  # noqa: F401
