"""Multi-device data parallelism over torch.distributed (parallel/mesh.py)."""
