"""Model packaging: the model_dict reproducibility contract.

Counterpart of `grappa_tpu.train.export` (reference: src/grappa/training/
export_model.py:48-123 and utils/loading_utils.py:7-86). A model file holds
{state_dict, config, split_names[, results, ds_size]}. The port's module
tree carries the reference's names and scaler buffers, so its
`state_dict()` is the file's state_dict as it stands, and a `.npz` or
`.pth` written by either package loads in the other; a reference-format
file loads through `torch_compat.import_state_dict`'s audit.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from grappa_tpu_torch.models.grappa_model import GrappaModel, make_model
from grappa_tpu_torch.train.torch_compat import import_state_dict


def build_model_dict(model: GrappaModel, config: Dict,
                     split_names: Optional[Dict] = None,
                     results: Optional[Dict] = None,
                     ds_size: Optional[Dict] = None) -> Dict:
    """The model's weights and scaler buffers as host numpy arrays, with
    the run's config and split."""
    state_dict = {k: v.detach().cpu().numpy()
                  for k, v in model.state_dict().items()}
    d = {'state_dict': state_dict, 'config': config,
         'split_names': split_names or {}}
    if results is not None:
        d['results'] = results
    if ds_size is not None:
        d['ds_size'] = ds_size
    return d


def save_model_dict(model_dict: Dict, path: Union[str, Path]):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == '.pth':
        torch.save({**model_dict, 'state_dict': {
            k: torch.as_tensor(np.asarray(v))
            for k, v in model_dict['state_dict'].items()}}, path)
    elif path.suffix == '.npz':
        arrays = {f'state_dict/{k}': np.asarray(v)
                  for k, v in model_dict['state_dict'].items()}
        meta = {k: v for k, v in model_dict.items() if k != 'state_dict'}
        np.savez(path, __meta__=np.array(json.dumps(meta)), **arrays)
    else:
        raise ValueError(f"unknown model file suffix: {path.suffix}")


def load_model_dict(path: Union[str, Path]) -> Dict:
    path = Path(path)
    if path.suffix == '.pth':
        return torch.load(path, map_location='cpu', weights_only=False)
    if path.suffix == '.npz':
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data['__meta__']))
            prefix = 'state_dict/'
            state_dict = {k[len(prefix):]: data[k] for k in data.files
                          if k.startswith(prefix)}
        return {'state_dict': state_dict, **meta}
    raise ValueError(f"unknown model file suffix: {path.suffix}")


def model_from_dict(model_dict: Dict):
    """model_dict -> (model on the CPU, config). The file goes through
    `import_state_dict`'s audit; the scalers come from its buffers where it
    stores them, else from the config's default statistics (a buffer-less
    file), and the strict load sets every weight from the file."""
    config = model_dict['config']
    model_config = config.get('model_config', config)
    state_dict, stats = import_state_dict(model_dict['state_dict'],
                                          model_config, require_buffers=False)
    model = (make_model(model_config, stats, eps_applied=True)
             if stats is not None else make_model(model_config))
    load_imported(model, state_dict)
    return model, config


def load_imported(model: GrappaModel, state_dict: Dict):
    """Strict load of an `import_state_dict` result: every weight from the
    file, and the buffers the file does not store the model's own."""
    own = {k: v for k, v in model.named_buffers() if k not in state_dict}
    model.load_state_dict({**own, **state_dict}, strict=True)
