"""mirror_nerf_tpu_torch — the PyTorch + CUDA port of mirror_nerf_tpu.

It mirrors the JAX package's layout and names module by module, and is held
against it by the `tests/test_torch_port_*.py` parity tests. It imports
neither jax nor `mirror_nerf_tpu`.

Parameters are nested dicts/lists of tensors with the JAX package's leaf
names and (in, out) matrix layout, so one npz checkpoint loads in both
packages (`train/checkpoints.py`). Every Pallas kernel on a ported path has a
hand-written CUDA kernel under `csrc/` beside a plain PyTorch version of the
same function; a wrapper takes the plain version for CPU tensors only and
launches the kernel (or raises) for CUDA tensors.
"""

__version__ = "0.1.0"
