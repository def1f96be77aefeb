from grappa_tpu_torch.data.graph_batch import (
    GraphBatch, MolGraph, PadSpec, TermBatch, collate)
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.parameters import Parameters

__all__ = ['GraphBatch', 'MolGraph', 'Molecule', 'PadSpec', 'Parameters',
           'TermBatch', 'collate']
