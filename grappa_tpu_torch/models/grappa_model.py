"""The full parameter-prediction model: GNN embedder + four symmetric heads.

Counterpart of `grappa_tpu.models.grappa_model`. Configuration keys and
defaults are the JAX package's (and so the reference's deployed config), so
yaml configs interchange. The model maps a GraphBatch to

  {n2_k (B,), n2_eq (B,), n3_k (A,), n3_eq (A,),
   n4_k (P, n_periodicity_proper), n4_improper_k (I, n_periodicity_improper)}

Torsion ks are signed (phase folded into sign). The module tree and buffer
names are the reference's (`gnn.*`, `parameter_writer.*_writer.*`), so the
state_dict of `weights.state_dict_from_flax` loads with strict=True.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from grappa_tpu_torch.data.graph_batch import GraphBatch
from grappa_tpu_torch.models.gnn import GrappaGNN
from grappa_tpu_torch.models.heads import (HarmonicParameterHead,
                                           TorsionParameterHead)
from grappa_tpu_torch.models.layers import init_parameters
from grappa_tpu_torch.statistics import (get_default_statistics,
                                         sanitize_statistics)

_EPS_STD_HARMONIC = 1e-6
_STAT_KEYS = ('n2_k', 'n2_eq', 'n3_k', 'n3_eq', 'n4_k', 'n4_improper_k')


def get_default_model_config() -> Dict:
    """Canonical hyperparameters of the deployed model family (the keys and
    values of grappa_tpu.models.grappa_model.get_default_model_config)."""
    return {
        "graph_node_features": 256,
        "in_feat_name": ["atomic_number", "partial_charge", "ring_encoding",
                         "degree", "charge_model"],
        "gnn_width": 512,
        "gnn_attentional_layers": 7,
        "gnn_convolutions": 0,
        "gnn_attention_heads": 16,
        "gnn_dropout_attention": 0.3,
        "gnn_dropout_initial": 0.0,
        "gnn_dropout_conv": 0.1,
        "gnn_dropout_final": 0.1,
        "parameter_dropout": 0.5,
        "bond_transformer_depth": 3,
        "bond_n_heads": 8,
        "bond_transformer_width": 512,
        "bond_symmetriser_depth": 3,
        "bond_symmetriser_width": 256,
        "angle_transformer_depth": 3,
        "angle_n_heads": 8,
        "angle_transformer_width": 512,
        "angle_symmetriser_depth": 3,
        "angle_symmetriser_width": 256,
        "proper_transformer_depth": 3,
        "proper_n_heads": 8,
        "proper_transformer_width": 512,
        "proper_symmetriser_depth": 3,
        "proper_symmetriser_width": 256,
        "improper_transformer_depth": 3,
        "improper_n_heads": 8,
        "improper_transformer_width": 512,
        "improper_symmetriser_depth": 3,
        "improper_symmetriser_width": 256,
        "n_periodicity_proper": 6,
        "n_periodicity_improper": 3,
        "gated_torsion": True,
        "wrong_symmetry": False,
        "positional_encoding": True,
        "layer_norm": True,
        "self_interaction": True,
        "learnable_statistics": False,
        "torsion_cutoff": 1e-4,
        "harmonic_gate": False,
        # matmul compute dtype ('float32' | 'bfloat16'); the port runs
        # float32 only so far (ROADMAP.md: bf16 kernels)
        "compute_dtype": "float32",
        "gnn_compute_dtype": None,
        "heads_compute_dtype": None,
        # hand-written CUDA kernels for the head blocks / GNN blocks:
        # 'auto' = on whenever the model's tensors lie on a CUDA device,
        # False = the eager modules, True = the fused ops on any device
        # (their plain PyTorch versions on the CPU)
        "fused_heads": "auto",
        "fused_gnn": "auto",
        # layer-wise rematerialization in the JAX package's training; has
        # no effect on the port's forward
        "remat": False,
    }


def get_small_model_config() -> Dict:
    """A small config for tests and fast smoke runs."""
    cfg = get_default_model_config()
    cfg.update({
        "graph_node_features": 64, "gnn_width": 64,
        "gnn_attentional_layers": 2, "gnn_attention_heads": 4,
        "gnn_dropout_attention": 0.0, "gnn_dropout_final": 0.0,
        "parameter_dropout": 0.0,
    })
    for term in ("bond", "angle", "proper", "improper"):
        cfg[f"{term}_transformer_depth"] = 1
        cfg[f"{term}_n_heads"] = 4
        cfg[f"{term}_transformer_width"] = 64
        cfg[f"{term}_symmetriser_depth"] = 2
        cfg[f"{term}_symmetriser_width"] = 64
    return cfg


def _check_dtype(cfg: Dict) -> None:
    for key in ('compute_dtype', 'gnn_compute_dtype', 'heads_compute_dtype'):
        if cfg.get(key) not in (None, 'float32'):
            raise NotImplementedError(
                f"{key}={cfg[key]!r}: the port runs float32 only; bfloat16 "
                f"kernels are queued in ROADMAP.md (bf16 kernels)")


class GrappaModel(nn.Module):
    """GNN + parameter writers. Build with `make_model(config, statistics)`.

    `stats` are the epsilon-applied statistics ({'mean', 'std'} of numpy
    arrays). Parameters are created on the CPU from `generator`; move the
    model with `.to(device)`. With fused_gnn / fused_heads 'auto' the fused
    kernels run whenever the inputs lie on a CUDA device."""

    def __init__(self, config: Dict, stats: Dict,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = dict(config)
        _check_dtype(cfg)
        fused_gnn = cfg.get('fused_gnn', 'auto')
        fused_heads = cfg.get('fused_heads', 'auto')
        ln = cfg['layer_norm']
        rep = cfg['graph_node_features']
        mean, std = stats['mean'], stats['std']

        self.gnn = GrappaGNN(
            out_feats=rep, node_feats=cfg['gnn_width'],
            n_conv=cfg['gnn_convolutions'],
            n_att=cfg['gnn_attentional_layers'],
            n_heads=cfg['gnn_attention_heads'],
            in_feat_names=cfg['in_feat_name'],
            conv_dropout=cfg['gnn_dropout_conv'],
            attention_dropout=cfg['gnn_dropout_attention'],
            initial_dropout=cfg['gnn_dropout_initial'],
            final_dropout=cfg['gnn_dropout_final'],
            layer_norm=ln, self_interaction=cfg['self_interaction'],
            fused=fused_gnn)

        def width(name):
            return dict(
                transformer_width=cfg[f'{name}_transformer_width'],
                transformer_depth=cfg[f'{name}_transformer_depth'],
                n_heads=cfg[f'{name}_n_heads'],
                symmetriser_depth=cfg[f'{name}_symmetriser_depth'],
                symmetriser_width=cfg[f'{name}_symmetriser_width'],
                dropout=cfg['parameter_dropout'], layer_norm=ln,
                fused=fused_heads)

        def torsion_stats(key, n_per):
            # pad with neutral statistics if the model asks for more terms
            m = list(np.asarray(mean[key], np.float32))
            s = list(np.asarray(std[key], np.float32))
            m += [0.0] * (n_per - len(m))
            s += [1.0] * (n_per - len(s))
            return m[:n_per], s[:n_per]

        writer = nn.Module()
        writer.bond_writer = HarmonicParameterHead(
            'n2', rep, k_mean=float(mean['n2_k'][0]),
            k_std=float(std['n2_k'][0]), eq_mean=float(mean['n2_eq'][0]),
            eq_std=float(std['n2_eq'][0]), positional_encoding=False,
            gate=cfg['harmonic_gate'], **width('bond'))
        writer.angle_writer = HarmonicParameterHead(
            'n3', rep, k_mean=float(mean['n3_k'][0]),
            k_std=float(std['n3_k'][0]), eq_mean=0.0,
            eq_std=float(std['n3_eq'][0]),
            positional_encoding=cfg['positional_encoding'],
            gate=cfg['harmonic_gate'], **width('angle'))
        for name, term in (('proper', 'n4'), ('improper', 'n4_improper')):
            n_per = cfg[f'n_periodicity_{name}']
            k_mean, k_std = torsion_stats(f'{term}_k', n_per)
            setattr(writer, f'{name}_writer', TorsionParameterHead(
                term, rep, n_per, k_mean=k_mean, k_std=k_std,
                gated=cfg['gated_torsion'],
                positional_encoding=cfg['positional_encoding'],
                wrong_symmetry=cfg['wrong_symmetry'],
                cutoff=cfg['torsion_cutoff'], **width(name)))
        self.parameter_writer = writer
        init_parameters(self, generator)

    def forward(self, batch: GraphBatch,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """In training mode the dropouts draw their seeds from `generator`
        (a CPU generator: drawing never waits for the card); in eval mode
        it is not needed."""
        h = self.gnn(batch.feats, batch.neighbors, batch.neighbor_mask,
                     generator)
        w = self.parameter_writer
        n2_k, n2_eq = w.bond_writer(h, batch.terms['n2'].idxs, generator)
        n3_k, n3_eq = w.angle_writer(h, batch.terms['n3'].idxs, generator)
        return {
            'n2_k': n2_k, 'n2_eq': n2_eq, 'n3_k': n3_k, 'n3_eq': n3_eq,
            'n4_k': w.proper_writer(h, batch.terms['n4'].idxs, generator),
            'n4_improper_k': w.improper_writer(
                h, batch.terms['n4_improper'].idxs, generator),
        }


def make_model(model_config: Optional[Dict] = None,
               param_statistics: Optional[Dict] = None,
               eps_applied: bool = False,
               generator: Optional[torch.Generator] = None) -> GrappaModel:
    """Factory: config dict (reference-compatible keys) + statistics -> model
    with flax-style initial weights drawn from `generator`.

    eps_applied: set True when the statistics already include the reference's
    EPSILON_STD (e.g. taken from checkpoint scaler buffers); by default a
    small epsilon is added to every std so scalers never divide by zero
    (1e-6 harmonic; 0.1 gated / 0.01 ungated torsion).
    """
    cfg = get_default_model_config()
    if model_config:
        unknown = set(model_config) - set(cfg) - {'in_feats', 'in_feat_dims'}
        if unknown:
            raise KeyError(f"unknown model config keys: {sorted(unknown)}")
        cfg.update({k: v for k, v in model_config.items() if k in cfg})
    stats = sanitize_statistics(param_statistics or get_default_statistics())
    if not eps_applied:
        eps_torsion = 1e-1 if cfg['gated_torsion'] else 1e-2
        for key in ('n2_k', 'n2_eq', 'n3_k', 'n3_eq'):
            stats['std'][key] = stats['std'][key] + _EPS_STD_HARMONIC
        for key in ('n4_k', 'n4_improper_k'):
            stats['std'][key] = stats['std'][key] + eps_torsion
    stats = {m: {k: np.asarray(stats[m][k], np.float32) for k in _STAT_KEYS}
             for m in ('mean', 'std')}
    return GrappaModel(cfg, stats, generator=generator)


def field_of_view(model_config: Dict) -> int:
    """Graph distance the model can see: attention + conv layers + 3
    (tuples and ring features)."""
    return (model_config.get('gnn_attentional_layers', 7)
            + model_config.get('gnn_convolutions', 0) + 3)
