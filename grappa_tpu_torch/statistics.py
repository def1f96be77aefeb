"""Classical-parameter statistics used to initialize the output scalers.

Mirrors the reference's statistics pipeline (reference: src/grappa/utils/
graph_utils.py:201-242): mean/std of the `_ref` classical parameters over the
training set, NaN-aware, with a hardcoded fallback. The scalers depend on
these, so convergence behavior tracks the reference when statistics match.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

STAT_KEYS = ('n2_k', 'n2_eq', 'n3_k', 'n3_eq', 'n4_k', 'n4_improper_k')


def get_default_statistics() -> Dict[str, Dict[str, np.ndarray]]:
    """Fallback statistics (from a peptide dataset; same values as the
    reference default, graph_utils.py:233-242)."""
    return {
        'mean': {
            'n2_k': np.array([763.2819], np.float32),
            'n2_eq': np.array([1.2353], np.float32),
            'n3_k': np.array([105.6576], np.float32),
            'n3_eq': np.array([1.9750], np.float32),
            'n4_k': np.array([1.5617e-01, -5.8312e-01, 7.0820e-02,
                              -6.3840e-04, 4.7139e-04, -4.1655e-04], np.float32),
            'n4_improper_k': np.array([0.0, -2.3933, 0.0], np.float32),
        },
        'std': {
            'n2_k': np.array([161.2278], np.float32),
            'n2_eq': np.array([0.1953], np.float32),
            'n3_k': np.array([26.5965], np.float32),
            'n3_eq': np.array([0.0917], np.float32),
            'n4_k': np.array([0.4977, 1.2465, 0.1466, 0.0192, 0.0075, 0.0066],
                             np.float32),
            'n4_improper_k': np.array([0.0, 4.0571, 0.0], np.float32),
        },
    }


def sanitize_statistics(stats: Dict) -> Dict[str, Dict[str, np.ndarray]]:
    """Replace NaN entries with defaults; coerce to float32 arrays."""
    defaults = get_default_statistics()
    out = {'mean': {}, 'std': {}}
    for m in ('mean', 'std'):
        for k in STAT_KEYS:
            v = np.asarray(stats.get(m, {}).get(k, defaults[m][k]),
                           np.float32).reshape(-1)
            if np.isnan(v).any():
                v = np.asarray(defaults[m][k], np.float32).reshape(-1)
            out[m][k] = v
    return out
