"""grappa_tpu_torch: the PyTorch / CUDA port of grappa_tpu for NVIDIA Hopper.

The JAX package `grappa_tpu` stays the reference; this package imports
nothing of it (nor JAX). Its entry points run on a CUDA device unless the
caller passes device='cpu'.
"""
from grappa_tpu_torch.api import Grappa
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.parameters import Parameters

__all__ = ['Grappa', 'Molecule', 'Parameters']
