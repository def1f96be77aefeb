"""Import of reference-format checkpoints: the key-for-key audit.

Counterpart of `grappa_tpu.train.torch_compat`'s `expected_reference_keys`,
`stats_from_model` and `import_state_dict` (reference module tree:
src/grappa/models/grappa.py:51-109, graph_attention.py:48-139,
interaction_parameters.py:38-123, perm_equiv_transformer.py:40-237,
final_layer.py:11-97). The port's module tree already carries the
reference's names (`weights.state_dict_from_flax` writes them), so an
import is an audit and a renaming, not a transposition: every weight
stays the file's own tensor. The audit, as the JAX package's:

  * every missing key is collected and raised in one KeyError;
  * DGL's bipartite name `graph_module.fc_src` is taken for `fc`;
  * the `gnn.blocks.{i}` registration aliases are checked against their
    source where present and filled from it where absent;
  * the stored Symmetriser permutation sets, positional encodings and
    `n_periodicity` must be the config's; `min_ != 0` is refused;
  * keys that were not used are warned about, once, in one list;
  * with require_buffers=False a file without scaler buffers returns
    stats None: the caller builds the scalers from the config.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from grappa_tpu_torch.models.grappa_model import get_default_model_config
from grappa_tpu_torch.weights import (_WRITERS, _positional_encoding,
                                      _writer_permutations)


def _config(model_config: Optional[Dict]) -> Dict:
    cfg = get_default_model_config()
    cfg.update(model_config or {})
    return cfg


def _block_keys(cfg: Dict):
    """(source prefix, alias prefix, kind) of every GNN block."""
    n_conv = cfg['gnn_convolutions']
    for i in range(n_conv):
        yield f'gnn.conv_blocks.{i}', f'gnn.blocks.{i}', 'conv'
    for i in range(cfg['gnn_attentional_layers']):
        yield f'gnn.att_blocks.{i}', f'gnn.blocks.{n_conv + i}', 'att'


def _scaler_keys(writer: str, base: str):
    if writer == 'bond':
        return [f'{base}.to_k.mean_over_std', f'{base}.to_k.std',
                f'{base}.to_eq.mean_over_std', f'{base}.to_eq.std']
    if writer == 'angle':
        return [f'{base}.to_k.mean_over_std', f'{base}.to_k.std',
                f'{base}.to_eq.std_over_max', f'{base}.to_eq.max']
    return [f'{base}.k_mean', f'{base}.k_std']


def expected_reference_keys(model_config: Optional[Dict] = None) -> set:
    """Every state_dict key a published grappa `.pth` holds for this model
    config (the JAX package's `expected_reference_keys`): the GNN's
    pre / post dense layers and blocks, each block also under its
    `gnn.blocks.{i}` alias; each writer's projector, transformer blocks
    (packed qkv), positional encoding (arity >= 3), Symmetriser MLP with
    its permutations / prefactors buffers and scaler buffers (to_k / to_eq
    with min_, or k_mean / k_std / n_periodicity for torsions)."""
    cfg = _config(model_config)
    keys = set()

    def linear(name):
        keys.update((f'{name}.weight', f'{name}.bias'))

    linear('gnn.pre_dense.0')
    for base, alias, kind in _block_keys(cfg):
        for b in (base, alias):
            linear(f'{b}.layer_norm')
            linear(f'{b}.interaction_norm')
            linear(f'{b}.self_interaction.0')
            if kind == 'att':
                keys.add(f'{b}.graph_module.fc.weight')
                linear(f'{b}.head_reducer')
                linear(f'{b}.self_interaction.2')
            else:
                # DGL SAGEConv (mean aggregator): fc_self without bias
                keys.add(f'{b}.graph_module.fc_self.weight')
                linear(f'{b}.graph_module.fc_neigh')
    linear('gnn.post_dense.0')

    for writer, _, model_name in _WRITERS:
        base = f'parameter_writer.{writer}_writer'
        linear(f'{base}.rep_projector.mlp.0')
        for i in range(cfg[f'{writer}_transformer_depth']):
            t = f'{base}.{model_name}.grappa_transformer.transformer.{i}'
            keys.update((f'{t}.attn.in_proj_weight', f'{t}.attn.in_proj_bias'))
            for name in ('norm1', 'attn.out_proj', 'ff.norm1', 'ff.linear1',
                         'ff.linear2'):
                linear(f'{t}.{name}')
        if cfg['positional_encoding'] and writer != 'bond':
            keys.add(f'{base}.{model_name}.grappa_transformer'
                     f'.positional_encoding')
        for i in range(cfg[f'{writer}_symmetriser_depth']):
            s = f'{base}.{model_name}.symmetriser.mlp.{i}'
            for name in ('norm1', 'linear1', 'linear2'):
                linear(f'{s}.{name}')
        keys.add(f'{base}.{model_name}.symmetriser.permutations')
        keys.add(f'{base}.{model_name}.symmetriser.permutation_prefactors')
        keys.update(_scaler_keys(writer, base))
        if writer in ('bond', 'angle'):
            keys.add(f'{base}.to_k.min_')
        if writer == 'bond':
            keys.add(f'{base}.to_eq.min_')
        if writer in ('proper', 'improper'):
            keys.add(f'{base}.n_periodicity')
    return keys


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _stats_from_buffers(get) -> Dict:
    """{'mean', 'std'} (epsilon applied, as the buffers hold them) from the
    scaler buffers, `get(key) -> float32 array`. The angle's equilibrium
    scaler stores no mean; it reads as pi / 2, as in the JAX package."""
    stats = {'mean': {}, 'std': {}}
    for writer, term, _ in _WRITERS:
        base = f'parameter_writer.{writer}_writer'
        if writer in ('bond', 'angle'):
            k_std = get(f'{base}.to_k.std')
            stats['mean'][f'{term}_k'] = get(f'{base}.to_k.mean_over_std') \
                * k_std
            stats['std'][f'{term}_k'] = k_std
            if writer == 'bond':
                eq_std = get(f'{base}.to_eq.std')
                stats['mean'][f'{term}_eq'] = \
                    get(f'{base}.to_eq.mean_over_std') * eq_std
                stats['std'][f'{term}_eq'] = eq_std
            else:
                stats['mean'][f'{term}_eq'] = np.array([np.pi / 2],
                                                       np.float32)
                stats['std'][f'{term}_eq'] = \
                    get(f'{base}.to_eq.std_over_max') \
                    * get(f'{base}.to_eq.max')
        else:
            stats['mean'][f'{term}_k'] = get(f'{base}.k_mean')
            stats['std'][f'{term}_k'] = get(f'{base}.k_std')
    return stats


def stats_from_model(model) -> Dict:
    """The model's baked (epsilon-applied) statistics, read from its scaler
    buffers."""
    sd = model.state_dict()
    return _stats_from_buffers(
        lambda k: _np(sd[k]).astype(np.float32).reshape(-1))


def import_state_dict(state_dict: Dict, model_config: Optional[Dict],
                      verbose: bool = True, require_buffers: bool = True
                      ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict]]:
    """Reference-named state_dict (tensors or numpy arrays) -> (the port's
    state_dict, stats or None).

    The returned state_dict holds every weight of the file under the
    port's names, every `gnn.blocks.{i}` alias and the buffers the file
    stores. It lacks a buffer only where the file does: load it into a
    model built by `make_model(config, stats, eps_applied=True)` (or
    `make_model(config)` when stats is None) completed by that model's
    own buffers. Raises KeyError (all missing keys at once) and
    ValueError (a convention the config does not share)."""
    cfg = _config(model_config)
    consumed: set = set()
    missing: list = []
    out: Dict[str, torch.Tensor] = {}

    def take(key, name=None):
        """Consume `name` (default `key`) from the file as port key `key`."""
        name = name or key
        if name not in state_dict:
            missing.append(name)
            return
        consumed.add(name)
        v = state_dict[name]
        out[key] = (v.detach() if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v)))

    def stored(key):
        """An optional buffer: consumed and returned as numpy, or None."""
        if key not in state_dict:
            return None
        take(key)
        return _np(state_dict[key])

    scalers = set()
    for writer, _, _ in _WRITERS:
        scalers.update(_scaler_keys(writer,
                                    f'parameter_writer.{writer}_writer'))
    buffers_absent = not require_buffers and any(
        k not in state_dict for k in scalers)

    optional = set()
    for writer, _, model_name in _WRITERS:
        base = f'parameter_writer.{writer}_writer'
        optional.update((
            f'{base}.{model_name}.grappa_transformer.positional_encoding',
            f'{base}.{model_name}.symmetriser.permutations',
            f'{base}.{model_name}.symmetriser.permutation_prefactors',
            f'{base}.to_k.min_', f'{base}.to_eq.min_',
            f'{base}.n_periodicity'))
    expected = expected_reference_keys(cfg)
    for key in sorted(expected):
        if key.startswith('gnn.blocks.') or key in optional:
            continue
        if key in scalers and key not in state_dict and not require_buffers:
            continue
        if key.endswith('graph_module.fc.weight') and key not in state_dict:
            take(key, key.replace('graph_module.fc.', 'graph_module.fc_src.'))
        else:
            take(key)
    if missing:
        raise KeyError(
            f'{len(missing)} expected keys are missing from the state_dict '
            f'(reference contract: expected_reference_keys()): {missing}')

    for writer, _, model_name in _WRITERS:
        base = f'parameter_writer.{writer}_writer'
        for name in ('to_k.min_', 'to_eq.min_'):
            v = stored(f'{base}.{name}')
            if v is not None and float(v):
                raise ValueError(f'{base}.{name} != 0 is unsupported')
        n_per = stored(f'{base}.n_periodicity')
        if n_per is not None:
            want = cfg[f'n_periodicity_{writer}']
            if int(n_per) != want:
                raise ValueError(
                    f'{base}.n_periodicity in the checkpoint is '
                    f'{int(n_per)} but the config says {want}')
        ekey = f'{base}.{model_name}.grappa_transformer.positional_encoding'
        enc = stored(ekey)
        if enc is not None:
            want = _positional_encoding(writer, cfg)
            if np.asarray(enc, np.float32).tolist() != want:
                raise ValueError(
                    f'{ekey}: stored positional encoding '
                    f'{np.asarray(enc).tolist()} does not match the '
                    f'expected {want}')
        pkey = f'{base}.{model_name}.symmetriser.permutations'
        perms = stored(pkey)
        if perms is not None:
            stored(f'{base}.{model_name}.symmetriser.permutation_prefactors')
            want = _writer_permutations(writer, cfg)
            if sorted(perms.tolist()) != sorted(want):
                raise ValueError(
                    f'{pkey}: stored permutation set {perms.tolist()} does '
                    f'not match the expected {want} — symmetry conventions '
                    f'differ, a silent load would produce wrong parameters')

    # `gnn.blocks.{i}` alias `conv_blocks` / `att_blocks` (reference
    # graph_attention.py:131): checked where the file has them, and filled
    # from their source for the port's module tree, which registers them
    n_conv = cfg['gnn_convolutions']
    for key in list(state_dict):
        if not key.startswith('gnn.blocks.'):
            continue
        i, tail = key[len('gnn.blocks.'):].split('.', 1)
        i = int(i)
        src = (f'gnn.conv_blocks.{i}.{tail}' if i < n_conv
               else f'gnn.att_blocks.{i - n_conv}.{tail}')
        if src in state_dict:
            if not np.array_equal(_np(state_dict[key]),
                                  _np(state_dict[src])):
                raise ValueError(
                    f'alias {key} differs from {src} — corrupt checkpoint?')
            consumed.add(key)
    for base, alias, _ in _block_keys(cfg):
        for key in [k for k in out if k.startswith(base + '.')]:
            out[alias + key[len(base):]] = out[key]

    unused = sorted(set(state_dict) - consumed)
    if unused and verbose:
        warnings.warn(
            f'import_state_dict: {len(unused)} keys in the checkpoint were '
            f'not consumed (ignored): {unused[:40]}'
            + (' ...' if len(unused) > 40 else ''))
    # a stored buffer the config's model does not have (a positional
    # encoding with positional_encoding off) was checked and is dropped
    out = {k: v for k, v in out.items() if k in expected}
    if buffers_absent:
        for key in scalers:
            out.pop(key, None)
        return out, None
    return out, _stats_from_buffers(
        lambda k: _np(out[k]).astype(np.float32).reshape(-1))
