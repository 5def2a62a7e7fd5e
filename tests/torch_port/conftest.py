"""Tests of the PyTorch port (kmerax_torch) against the JAX package.

The JAX side runs on the CPU backend that tests/conftest.py forces; data
crosses between the packages as numpy arrays. Each xdist worker keeps torch
to one thread so `-n 6` does not oversubscribe the host.

These tests run on the CPU only: tests/conftest.py imports jax, which the
GPU machine lacks. The kernels are held against their plain versions on
the card by chip_smoke.py.
"""

import torch

torch.set_num_threads(1)
