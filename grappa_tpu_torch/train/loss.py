"""Molecule-wise training loss, vectorised over the batch.

Counterpart of `grappa_tpu.train.loss` (reference: src/grappa/training/
loss.py:11-167): per-molecule MSEs of centred energies, of gradients and of
the NaN-masked classical parameters with per-type weights, plus an L2
regularisation of torsion amplitudes, averaged over molecules so every
molecule weighs the same. Segment sums are `index_add` into num_mols + 1
segments (the last collects the padding). Semantics kept from the JAX
package: entries with a NaN reference still count in the parameter-loss
denominator; reference torsion ks are zero-padded or truncated to the
model's periodicity; improper ks stay out of the parameter loss; the mean
over molecules comes last.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from grappa_tpu_torch.data.graph_batch import GraphBatch
from grappa_tpu_torch.models import mm_energy
from grappa_tpu_torch.models.mm_energy import segment_sum

# relative weights of parameter types inside the parameter loss
DEFAULT_PARAM_TYPE_WEIGHTS = {'n2_k': 1e-3, 'n3_k': 1e-2, 'n4_k': 1e-4}


class LossWeights(NamedTuple):
    """Weights of the loss's parts: floats or tensors; `param` may be a
    per-molecule (M,) tensor (per-dataset parameter-loss weights)."""
    energy: torch.Tensor
    gradient: torch.Tensor
    param: torch.Tensor
    proper_reg: torch.Tensor
    improper_reg: torch.Tensor


def _segment_mean(values, seg, counts, num_mols):
    return segment_sum(values, seg, num_mols) / counts.clamp_min(1.0)


def molwise_loss(batch: GraphBatch, pred: Dict[str, torch.Tensor],
                 weights: LossWeights,
                 param_type_weights: Optional[Dict[str, float]] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar loss and per-molecule diagnostics (energy_mse, gradient_mse,
    param_mse). `pred` is the model's output dict (n2_k .. n4_improper_k)."""
    if param_type_weights is None:
        param_type_weights = DEFAULT_PARAM_TYPE_WEIGHTS
    m = batch.num_mols
    aux: Dict[str, torch.Tensor] = {}

    energy, gradient = mm_energy.energy_and_gradient(batch, pred)

    # energy: per-molecule MSE of centred energies over valid conformers
    e_pred = mm_energy.centered(energy, batch.conf_mask)
    e_ref = mm_energy.centered(batch.energy_ref, batch.conf_mask)
    conf_counts = batch.conf_mask.sum(dim=1).to(torch.float32)
    e_mse = torch.square(e_pred - e_ref).sum(dim=1) / conf_counts.clamp_min(
        1.0)
    aux['energy_mse'] = e_mse

    # gradient: per-molecule MSE over (atoms x confs x 3) of that molecule
    node_mol = batch.node_mol.long()
    conf_mask_per_node = (batch.conf_mask[node_mol.clamp_max(m - 1)]
                          * batch.node_mask[:, None]).to(torch.float32)
    g_diff = (torch.square(gradient - batch.gradient_ref)
              * conf_mask_per_node[..., None])
    g_counts = batch.atoms_per_mol() * conf_counts * 3.0
    g_mse = _segment_mean(g_diff.sum(dim=(1, 2)), node_mol, g_counts, m)
    aux['gradient_mse'] = g_mse

    # parameters: NaN-masked squared error with per-type weights, one mean
    # over all parameter entries of the molecule (impropers left out, as
    # the reference's loss.py:91-92)
    se_per_mol = energy.new_zeros(m)
    count_per_mol = energy.new_zeros(m)
    for key in ('n2_k', 'n2_eq', 'n3_k', 'n3_eq', 'n4_k'):
        term = key[:2] if key.startswith(('n2', 'n3')) else 'n4'
        tb = batch.terms[term]
        ref = tb.k_ref if key.endswith('_k') else tb.eq_ref
        p = pred[key]
        if p.dim() == 1:
            p, ref = p[:, None], ref[:, None]
        if key == 'n4_k' and ref.shape[1] != p.shape[1]:
            # zero-pad or truncate the reference ks to the model's
            # periodicity (the reference's correct_torsion_shape)
            if ref.shape[1] < p.shape[1]:
                ref = torch.cat([ref, ref.new_zeros(
                    (ref.shape[0], p.shape[1] - ref.shape[1]))], dim=1)
            else:
                ref = ref[:, :p.shape[1]]
        fac = param_type_weights.get(key, 1.0)
        valid = ~torch.isnan(ref) & tb.mask[:, None]
        diff = torch.where(valid, (p - torch.nan_to_num(ref)) * fac,
                           torch.zeros_like(p))
        # NaN-reference entries count toward the denominator (zeroed but
        # included in the mean), as the reference does
        cnt = tb.mask.to(torch.float32) * ref.shape[1]
        se_per_mol = se_per_mol + segment_sum(
            torch.square(diff).sum(dim=1), tb.mol, m)
        count_per_mol = count_per_mol + segment_sum(cnt, tb.mol, m)
    param_mse = se_per_mol / count_per_mol.clamp_min(1.0)
    aux['param_mse'] = param_mse

    # torsion L2 regularisation (per-molecule mean of squared amplitudes)
    regs = energy.new_zeros(m)
    for term, w in (('n4', weights.proper_reg),
                    ('n4_improper', weights.improper_reg)):
        tb = batch.terms[term]
        k = pred[f'{term}_k']
        se = torch.square(torch.where(tb.mask[:, None], k,
                                      torch.zeros_like(k))).sum(dim=1)
        cnt = tb.mask.to(torch.float32) * k.shape[1]
        regs = regs + w * (segment_sum(se, tb.mol, m)
                           / segment_sum(cnt, tb.mol, m).clamp_min(1.0))

    per_mol = (weights.energy * e_mse + weights.gradient * g_mse
               + weights.param * param_mse + regs)
    return per_mol.mean(), aux
