"""Measurement tools of the port, run as `python -m
mirror_nerf_tpu_torch.tools.<name>`."""
