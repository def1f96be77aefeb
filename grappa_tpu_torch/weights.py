"""Weights carried across from the JAX package: flax params -> the port's
state_dict.

The port's module tree uses the reference's torch naming, so this is the
same mapping as `grappa_tpu.train.torch_compat.export_state_dict` (the
port's own copy; it imports nothing of the JAX package). Conventions: torch
Linear weight (out, in) == flax kernel (in, out).T; LayerNorm weight/bias ==
flax scale/bias; the packed in_proj rows are [q; k; v] == the flax in_proj
kernel's columns. Buffers: the `gnn.blocks.{i}` aliases, the positional
encodings, the Symmetriser permutation sets and the scaler statistics.
`parameters_from_flax` maps any parameter-shaped tree (the weights, or
Adam's mu / nu from optax's state) onto the names of
`model.named_parameters()`, without buffers.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from grappa_tpu_torch.models.grappa_model import get_default_model_config

_WRITERS = (('bond', 'n2', 'bond_model'), ('angle', 'n3', 'angle_model'),
            ('proper', 'n4', 'torsion_model'),
            ('improper', 'n4_improper', 'torsion_model'))


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def _writer_permutations(writer: str, cfg: Dict):
    perms = {
        'bond': [[0, 1], [1, 0]],
        'angle': [[0, 1, 2], [2, 1, 0]],
        'proper': [[0, 1, 2, 3], [3, 2, 1, 0]],
        'improper': [[0, 1, 2, 3], [3, 1, 2, 0]],
    }[writer]
    if writer == 'improper' and cfg.get('wrong_symmetry'):
        perms = [[0, 1, 2, 3], [3, 1, 2, 0], [1, 3, 2, 0],
                 [0, 3, 2, 1], [3, 0, 2, 1], [1, 0, 2, 3]]
    return perms


def _positional_encoding(writer: str, cfg: Dict):
    """The constant encoding the reference stores for arity >= 3
    (perm_equiv_transformer.py:188)."""
    if writer == 'improper' and cfg.get('wrong_symmetry'):
        return [[0.0], [0.0], [1.0], [0.0]]
    if writer == 'angle':
        return [[0.0], [1.0], [0.0]]
    return [[0.0], [1.0], [1.0], [0.0]]


def parameters_from_flax(tree: Dict, model_config: Dict
                         ) -> Dict[str, torch.Tensor]:
    """A flax-parameter-shaped tree (the weights, or optax's Adam mu / nu)
    -> {name: tensor} under the names of the port's
    `model.named_parameters()` (no buffers, no `gnn.blocks` aliases)."""
    return state_dict_from_flax(tree, model_config, None, buffers=False)


def state_dict_from_flax(params: Dict, model_config: Dict,
                         stats: Optional[Dict], buffers: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """flax params (nested dict of numpy arrays, with or without the top
    'params' level) + epsilon-applied stats ({'mean', 'std'} of numpy
    arrays) -> the port's state_dict, for GrappaModel.load_state_dict
    (strict=True). buffers=False leaves out every buffer and alias (stats
    are then not read)."""
    cfg = dict(get_default_model_config())
    cfg.update(model_config or {})
    p = params['params'] if 'params' in params else params
    sd: Dict[str, torch.Tensor] = {}

    def linear(name, kernel, bias=None):
        sd[f'{name}.weight'] = _t(np.asarray(kernel).T)
        if bias is not None:
            sd[f'{name}.bias'] = _t(bias)

    def norm(name, leaf):
        sd[f'{name}.weight'] = _t(leaf['scale'])
        sd[f'{name}.bias'] = _t(leaf['bias'])

    gnn = p['gnn']
    linear('gnn.pre_dense.0', gnn['pre_dense']['kernel'],
           gnn['pre_dense']['bias'])
    for i in range(cfg['gnn_convolutions']):
        blk = gnn[f'conv_block_{i}']
        base = f'gnn.conv_blocks.{i}'
        norm(f'{base}.layer_norm', blk['norm'])
        linear(f'{base}.graph_module.fc_self',
               blk['conv']['fc_self']['kernel'])
        linear(f'{base}.graph_module.fc_neigh',
               blk['conv']['fc_neigh']['kernel'],
               blk['conv']['fc_neigh']['bias'])
        norm(f'{base}.interaction_norm', blk['interaction_norm'])
        linear(f'{base}.self_interaction.0', blk['si_dense']['kernel'],
               blk['si_dense']['bias'])
    for i in range(cfg['gnn_attentional_layers']):
        blk = gnn[f'att_block_{i}']
        base = f'gnn.att_blocks.{i}'
        norm(f'{base}.layer_norm', blk['norm'])
        linear(f'{base}.graph_module.fc', blk['attention']['fc']['kernel'])
        linear(f'{base}.head_reducer', blk['head_reducer']['kernel'],
               blk['head_reducer']['bias'])
        norm(f'{base}.interaction_norm', blk['interaction_norm'])
        linear(f'{base}.self_interaction.0', blk['si_dense1']['kernel'],
               blk['si_dense1']['bias'])
        linear(f'{base}.self_interaction.2', blk['si_dense2']['kernel'],
               blk['si_dense2']['bias'])
    linear('gnn.post_dense.0', gnn['post_dense']['kernel'],
           gnn['post_dense']['bias'])

    # `gnn.blocks = conv_blocks + att_blocks` registers every block a second
    # time under gnn.blocks.{i} (reference graph_attention.py:131)
    n_conv = cfg['gnn_convolutions']
    alias = {}
    for key, val in sd.items():
        for prefix, offset in (('gnn.conv_blocks.', 0),
                               ('gnn.att_blocks.', n_conv)):
            if key.startswith(prefix):
                i, tail = key[len(prefix):].split('.', 1)
                alias[f'gnn.blocks.{offset + int(i)}.{tail}'] = val
    if buffers:
        sd.update(alias)

    for writer, term, model_name in _WRITERS:
        wp = p[f'{writer}_writer']['head']
        base = f'parameter_writer.{writer}_writer'
        linear(f'{base}.rep_projector.mlp.0', wp['rep_projector']['kernel'],
               wp['rep_projector']['bias'])
        for i in range(cfg[f'{writer}_transformer_depth']):
            blk = wp[f'transformer_{i}']
            tbase = f'{base}.{model_name}.grappa_transformer.transformer.{i}'
            norm(f'{tbase}.norm1', blk['norm1'])
            sd[f'{tbase}.attn.in_proj_weight'] = _t(
                np.asarray(blk['attn']['in_proj']['kernel']).T)
            sd[f'{tbase}.attn.in_proj_bias'] = _t(
                blk['attn']['in_proj']['bias'])
            linear(f'{tbase}.attn.out_proj', blk['attn']['out_proj']['kernel'],
                   blk['attn']['out_proj']['bias'])
            norm(f'{tbase}.ff.norm1', blk['ff']['norm'])
            linear(f'{tbase}.ff.linear1', blk['ff']['linear1']['kernel'],
                   blk['ff']['linear1']['bias'])
            linear(f'{tbase}.ff.linear2', blk['ff']['linear2']['kernel'],
                   blk['ff']['linear2']['bias'])
        if buffers and cfg['positional_encoding'] and writer != 'bond':
            sd[f'{base}.{model_name}.grappa_transformer.positional_encoding'] \
                = _t(np.asarray(_positional_encoding(writer, cfg),
                                np.float32))
        for i in range(cfg[f'{writer}_symmetriser_depth']):
            blk = wp['symmetriser'][f'mlp_{i}']
            sbase = f'{base}.{model_name}.symmetriser.mlp.{i}'
            norm(f'{sbase}.norm1', blk['norm'])
            linear(f'{sbase}.linear1', blk['linear1']['kernel'],
                   blk['linear1']['bias'])
            linear(f'{sbase}.linear2', blk['linear2']['kernel'],
                   blk['linear2']['bias'])
        if not buffers:
            continue
        perms = _writer_permutations(writer, cfg)
        sd[f'{base}.{model_name}.symmetriser.permutations'] = _t(
            np.asarray(perms, np.int32))
        sd[f'{base}.{model_name}.symmetriser.permutation_prefactors'] = _t(
            np.ones(len(perms), np.float32))

        if writer in ('bond', 'angle'):
            k_mean = float(np.asarray(stats['mean'][f'{term}_k'])[0])
            k_std = float(np.asarray(stats['std'][f'{term}_k'])[0])
            sd[f'{base}.to_k.mean_over_std'] = _t(k_mean / k_std)
            sd[f'{base}.to_k.std'] = _t(k_std)
            sd[f'{base}.to_k.min_'] = _t(0.0)
            eq_std = float(np.asarray(stats['std'][f'{term}_eq'])[0])
            if writer == 'bond':
                eq_mean = float(np.asarray(stats['mean'][f'{term}_eq'])[0])
                sd[f'{base}.to_eq.mean_over_std'] = _t(eq_mean / eq_std)
                sd[f'{base}.to_eq.std'] = _t(eq_std)
                sd[f'{base}.to_eq.min_'] = _t(0.0)
            else:
                sd[f'{base}.to_eq.std_over_max'] = _t(eq_std / np.pi)
                sd[f'{base}.to_eq.max'] = _t(float(np.pi))
        else:
            n_per = cfg[f'n_periodicity_{writer}']
            k_mean = np.asarray(stats['mean'][f'{term}_k'],
                                np.float32).reshape(-1)
            k_std = np.asarray(stats['std'][f'{term}_k'],
                               np.float32).reshape(-1)
            k_mean = np.pad(k_mean, (0, max(0, n_per - len(k_mean))),
                            constant_values=0.0)[:n_per]
            k_std = np.pad(k_std, (0, max(0, n_per - len(k_std))),
                           constant_values=1.0)[:n_per]
            sd[f'{base}.k_mean'] = _t(k_mean[None])
            sd[f'{base}.k_std'] = _t(k_std[None])
            sd[f'{base}.n_periodicity'] = _t(np.int64(n_per))
    return sd
