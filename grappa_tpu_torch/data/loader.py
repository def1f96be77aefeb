"""Bucketed padding: padded sizes are rounded up a geometric ladder, so the
set of padded shapes stays small while padding waste stays bounded (~25%).
The loader itself (weighted sampling, conformer strategies) is queued for a
later slice of the port."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from grappa_tpu_torch.data.graph_batch import MolGraph, PadSpec, TERMS


def bucket_size(x: int, base: int, ratio: float = 1.25) -> int:
    """Smallest ladder value >= x; ladder = base, then *ratio rounded to 8.
    Always advances by at least 8 per rung so ratio <= 1.0 cannot hang."""
    s = base
    while s < x:
        s = max(int(np.ceil(s * ratio / 8) * 8), s + 8)
    return s


def bucketed_pad_spec(graphs: Sequence[MolGraph], n_confs: int,
                      node_base: int = 64, tuple_base: int = 64,
                      ratio: float = 1.25) -> PadSpec:
    n_nodes = bucket_size(sum(g.n_atoms for g in graphs), node_base, ratio)
    n_tuples = {
        t: bucket_size(max(1, sum(len(g.tuple_idxs[t]) for g in graphs)),
                       tuple_base, ratio)
        for t in TERMS
    }
    return PadSpec(n_nodes=n_nodes, n_tuples=n_tuples, n_confs=n_confs)
