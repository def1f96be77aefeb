"""grappa_tpu_torch: the PyTorch / CUDA port of grappa_tpu for NVIDIA Hopper.

The JAX package `grappa_tpu` stays the reference; this package imports
nothing of it (nor JAX). Its entry points run on a CUDA device unless the
caller passes device='cpu'.
"""
from grappa_tpu_torch.api import Grappa
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.parameters import Parameters

# lazy top-level names (PEP 562), as grappa_tpu exports them: the wrappers'
# optional engines (openmm, ...) are imported only when a name is touched
_LAZY = {
    'OpenmmGrappa': ('grappa_tpu_torch.wrappers.openmm_wrapper',
                     'OpenmmGrappa'),
    'GromacsGrappa': ('grappa_tpu_torch.wrappers.gromacs_wrapper',
                      'GromacsGrappa'),
    'MolData': ('grappa_tpu_torch.data.moldata', 'MolData'),
    'Dataset': ('grappa_tpu_torch.data.dataset', 'Dataset'),
}

__all__ = ['Grappa', 'Molecule', 'Parameters', *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'grappa_tpu_torch' has no attribute {name!r}")
