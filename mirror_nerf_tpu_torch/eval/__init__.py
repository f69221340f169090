"""Evaluation: the Whitted eval tracer (`apps.py`), metrics and the CLI
(`python -m mirror_nerf_tpu_torch.eval`, see `cli.py`)."""

from .cli import get_opt, main  # noqa: F401
