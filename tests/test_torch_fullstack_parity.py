"""Full-stack checkpoint-import parity oracle.

An independent torch implementation of the reference architecture
(tests/torch_ref_model.py, re-derived from reference: src/grappa/models/*)
is loaded from `export_state_dict(...)` output with strict=True and must
reproduce the flax model's parameter predictions on a dozen molecules.

This validates, end to end and numerically:
  * the state_dict naming contract (strict load: no missing/unexpected keys,
    incl. the reference's `gnn.blocks.*` aliases and pos-enc buffers),
  * DotGatConv semantics of our NeighborAttention (reference
    graph_attention.py:226-310), SAGEConv, the charge encoding,
  * the writer stack incl. scalers and the gated torsion head (reference
    interaction_parameters.py:538-553),
so a published grappa `.pth` loaded via import_state_dict produces the
reference's predictions (the strongest available oracle without egress).
"""
import numpy as np
import torch

import jax

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu.data import MolGraph, collate
from grappa_tpu.data.graph_batch import TERMS
from grappa_tpu.data.synthetic import make_moldata
from grappa_tpu.models.grappa_model import (
    get_default_model_config, get_small_model_config, make_model)
from grappa_tpu.train.torch_compat import (
    export_state_dict, import_state_dict, stats_from_model)

from torch_ref_model import TorchReferenceModel


def _batch_inputs(batch, cfg):
    """Unpadded numpy inputs for the torch oracle from a 1-molecule batch."""
    n_real = int(np.asarray(batch.node_mask).sum())
    feats = {k: np.asarray(v) for k, v in batch.feats.items()}
    cols = []
    for name in cfg['in_feat_name']:
        col = feats[name][:n_real]
        cols.append(col if col.ndim >= 2 else col[:, None])
    in_feature = np.concatenate(cols, axis=-1).astype(np.float32)

    neighbors = np.asarray(batch.neighbors)[:n_real]
    nbr_mask = np.asarray(batch.neighbor_mask)[:n_real]
    dst, slot = np.nonzero(nbr_mask)
    edges = np.stack([neighbors[dst, slot], dst]).astype(np.int64)

    term_idxs, term_counts = {}, {}
    for t in TERMS:
        n_t = int(np.asarray(batch.terms[t].mask).sum())
        term_idxs[t] = np.asarray(batch.terms[t].idxs)[:n_t].astype(np.int64)
        term_counts[t] = n_t
    charges = feats['partial_charge'][:n_real].astype(np.float32)
    return in_feature, charges, edges, term_idxs, term_counts


def _run_parity(cfg, seeds, rtol, atol):
    model = make_model(cfg)
    graphs = [MolGraph.from_moldata(make_moldata(seed=s, n_confs=2))
              for s in seeds]
    batch0 = collate([graphs[0]])
    params = model.init(jax.random.key(0), batch0)

    sd = export_state_dict(params, cfg, stats=stats_from_model(model))
    in_feature, charges, _, _, _ = _batch_inputs(batch0, cfg)
    oracle = TorchReferenceModel(cfg, stats_from_model(model),
                                 in_feats=in_feature.shape[1])
    oracle.load_state_dict(sd, strict=True)   # naming-contract check
    oracle.eval()

    seen = {t: 0 for t in TERMS}
    for g in graphs:
        batch = collate([g])
        flax_out = model.apply(params, batch)
        in_feature, charges, edges, term_idxs, counts = _batch_inputs(
            batch, cfg)
        for t in TERMS:
            seen[t] += counts[t]
        with torch.no_grad():
            torch_out = oracle(
                torch.tensor(in_feature), torch.tensor(charges),
                torch.tensor(edges),
                {t: torch.tensor(v) for t, v in term_idxs.items()})
        for term in TERMS:
            n_t = counts[term]
            keys = [f'{term}_k'] + ([f'{term}_eq']
                                    if term in ('n2', 'n3') else [])
            for key in keys:
                np.testing.assert_allclose(
                    np.asarray(flax_out[key])[:n_t],
                    torch_out[key].numpy()[:n_t],
                    rtol=rtol, atol=atol, err_msg=key)
    assert min(seen.values()) > 0, f'term never exercised: {seen}'
    return model, params, sd


def test_fullstack_parity_small_config():
    """12 molecules through a small config incl. a SAGE conv block."""
    cfg = get_small_model_config()
    cfg['gnn_convolutions'] = 1
    _run_parity(cfg, seeds=range(12), rtol=1e-4, atol=1e-5)


def test_fullstack_roundtrip_import():
    """export -> import_state_dict -> flax predictions identical."""
    cfg = get_small_model_config()
    model, params, sd = _run_parity(cfg, seeds=[3], rtol=1e-4, atol=1e-5)
    params2, stats2 = import_state_dict(sd, cfg)
    model2 = make_model(cfg, stats2, eps_applied=True)
    batch = collate([MolGraph.from_moldata(make_moldata(seed=7, n_confs=2))])
    out1 = model.apply(params, batch)
    out2 = model2.apply(params2, batch)
    for key, v in out1.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(out2[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)


def test_fullstack_parity_default_config():
    """The deployed (grappa-1.2-sized) config: 7x512 GNN, depth-3 heads."""
    _run_parity(get_default_model_config(), seeds=[0, 1], rtol=3e-4,
                atol=3e-5)
