"""Training: losses, optimizer, the npz checkpoints, the staged loop and
the CLI (`python -m mirror_nerf_tpu_torch.train`, see `cli.py`)."""
