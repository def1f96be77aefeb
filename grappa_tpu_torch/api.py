"""Top-level inference API: Molecule in, Parameters out.

Counterpart of `grappa_tpu.api.Grappa`. `predict_many` collates up to
`batch_size` molecules into one padded batch (bucketed pad sizes, as the
JAX package), runs one forward on the model's device and slices the
per-molecule parameters back out. PyTorch runs eagerly, so there is no
compiled program to cache.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from grappa_tpu_torch import topology
from grappa_tpu_torch.data.graph_batch import MolGraph, collate
from grappa_tpu_torch.data.loader import bucketed_pad_spec
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.parameters import Parameters
from grappa_tpu_torch.models.grappa_model import GrappaModel, field_of_view
from grappa_tpu_torch.train.export import load_model_dict, model_from_dict
from grappa_tpu_torch.utils import resolve_device
from grappa_tpu_torch.zoo import model_path_from_tag


class Grappa:
    """Machine-learned MM force field: predicts bonded parameters.

    Runs on `device`: CUDA unless the caller asks for another (the model is
    moved there)."""

    def __init__(self, model: GrappaModel, config: Optional[Dict] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.config = config or {}

    @classmethod
    def from_tag(cls, tag: str = 'latest', device=None) -> 'Grappa':
        """Load a published model by tag (e.g. 'grappa-1.2') or file path
        (`.pth` / `.npz`) from the cache (`zoo.model_path_from_tag`)."""
        return cls.from_model_dict(load_model_dict(model_path_from_tag(tag)),
                                   device)

    @classmethod
    def from_model_dict(cls, model_dict: Dict, device=None) -> 'Grappa':
        """From a `{state_dict, config, ...}` model dict, ours or the
        reference's, through `export.model_from_dict` (the audited import;
        a file without scaler buffers takes the config's statistics)."""
        model, config = model_from_dict(model_dict)
        return cls(model, config, device)

    @property
    def field_of_view(self) -> int:
        """Graph distance influencing a predicted parameter."""
        return field_of_view(self.config.get('model_config', self.config))

    def predict(self, molecule: Molecule,
                check_eq_values: bool = True) -> Parameters:
        return self.predict_many([molecule],
                                 check_eq_values=check_eq_values)[0]

    @torch.inference_mode()
    def predict_many(self, molecules, check_eq_values: bool = True,
                     batch_size: int = 32) -> list:
        """Parametrize a collection of molecules in batched forwards; returns
        a list of `Parameters` aligned with the input order."""
        molecules = list(molecules)
        results = []
        for start in range(0, len(molecules), batch_size):
            chunk = molecules[start:start + batch_size]
            graphs = []
            for mol in chunk:
                if not topology.check_connected(mol.bonds_by_index(),
                                                len(mol.atoms)):
                    raise ValueError(
                        f"molecule #{start + len(graphs)}: the graph is "
                        "disconnected; split it into connected components "
                        "(water/ions are not parametrized by grappa)")
                graphs.append(MolGraph.from_molecule(mol))
            pad = bucketed_pad_spec(graphs, n_confs=1)
            batch = collate(graphs, pad=pad, n_confs=1, device=self.device)
            pred = {k: v.cpu().numpy() for k, v in self.model(batch).items()}
            # tuples are laid out contiguously per molecule (collate fills
            # in input order, padding at the tail): slice by running offsets
            offsets = {'n2': 0, 'n3': 0, 'n4': 0, 'n4_improper': 0}
            for mol in chunk:
                counts = {'n2': len(mol.bonds), 'n3': len(mol.angles),
                          'n4': len(mol.propers),
                          'n4_improper': len(mol.impropers)}
                sliced = {}
                for key, v in pred.items():
                    t = ('n4_improper' if key.startswith('n4_improper')
                         else key.rsplit('_', 1)[0])
                    sliced[key] = v[offsets[t]:offsets[t] + counts[t]]
                for t in offsets:
                    offsets[t] += counts[t]
                results.append(Parameters.from_prediction(
                    mol, sliced, check_eq_values=check_eq_values))
        return results

