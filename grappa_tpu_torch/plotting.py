"""Plotting utilities: parameter distributions and cross-model comparison.

Counterpart of `grappa_tpu.plotting` (the port's own copy; matplotlib is
imported inside each function, so the module imports without it).

Counterpart of the reference's Parameters plotting (reference:
src/grappa/data/Parameters.py:646-923 violin/scatter comparisons) used for
visual inspection of predicted force-field parameters (e.g. the -p flag of
grappa_gmx). matplotlib only; no seaborn dependency.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from grappa_tpu_torch.data.parameters import Parameters

_PARAM_PANELS = [
    ('bond_eq', 'bond eq [A]'),
    ('bond_k', 'bond k [kcal/mol/A^2]'),
    ('angle_eq', 'angle eq [rad]'),
    ('angle_k', 'angle k [kcal/mol/rad^2]'),
    ('proper_ks', 'proper k_n [kcal/mol]'),
    ('improper_ks', 'improper k_n [kcal/mol]'),
]


def _values(params: Parameters, key: str) -> np.ndarray:
    v = getattr(params, key)
    if v is None:
        return np.zeros(0)
    return np.asarray(v, dtype=np.float64).reshape(-1)


def plot_parameters(parameters: Union[Parameters, Sequence[Parameters]],
                    filename: Optional[str] = None,
                    title: Optional[str] = None):
    """Violin plots of each parameter type's distribution."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    if isinstance(parameters, Parameters):
        parameters = [parameters]
    fig, axes = plt.subplots(2, 3, figsize=(14, 8))
    for ax, (key, label) in zip(axes.flat, _PARAM_PANELS):
        vals = np.concatenate([_values(p, key) for p in parameters])
        vals = vals[np.isfinite(vals)]
        if len(vals):
            ax.violinplot(vals, showmedians=True)
        ax.set_title(label)
        ax.set_xticks([])
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=120)
        plt.close(fig)
        return None
    return fig, axes


def _detailed_panels(parameters: Sequence[Parameters],
                     n_periodicity: int = 3,
                     exclude_idxs: Optional[Sequence[np.ndarray]] = None):
    """The reference's 6-panel decomposition (Parameters.py:646-830): bond
    eq [A], angle eq [deg], SIGNED torsion k_1, bond k, angle k
    [kcal/mol/deg^2], signed torsion k_2..k_n. exclude_idxs: per-Parameters
    atom-id arrays; bonds/angles touching those atoms are dropped (the
    reference uses this to ignore e.g. radical sites)."""
    deg = np.pi / 180.0
    panels = {k: [] for k in ('bond_eq', 'angle_eq', 'torsion_k1',
                              'bond_k', 'angle_k', 'torsion_kn')}
    for i, p in enumerate(parameters):
        bond_mask = np.ones(len(p.bond_eq), bool)
        angle_mask = np.ones(len(p.angle_eq), bool)
        if exclude_idxs is not None and len(exclude_idxs[i]):
            bond_mask = ~np.isin(np.asarray(p.bonds), exclude_idxs[i]
                                 ).any(axis=1)
            angle_mask = ~np.isin(np.asarray(p.angles), exclude_idxs[i]
                                  ).any(axis=1)
        signed = Parameters.to_signed_k(np.nan_to_num(p.proper_ks),
                                        np.nan_to_num(p.proper_phases))
        signed = np.atleast_2d(signed)
        if signed.shape[1] < n_periodicity:  # classical FFs may carry fewer
            signed = np.pad(signed,
                            ((0, 0), (0, n_periodicity - signed.shape[1])))
        panels['bond_eq'].append(np.asarray(p.bond_eq)[bond_mask])
        panels['bond_k'].append(np.asarray(p.bond_k)[bond_mask])
        panels['angle_eq'].append(np.asarray(p.angle_eq)[angle_mask] / deg)
        panels['angle_k'].append(np.asarray(p.angle_k)[angle_mask] * deg ** 2)
        panels['torsion_k1'].append(signed[:, 0].reshape(-1))
        panels['torsion_kn'].append(signed[:, 1:n_periodicity].reshape(-1))
    return {k: np.concatenate(v) if v else np.zeros(0)
            for k, v in panels.items()}


_DETAILED_TITLES = [
    ('bond_eq', 'Bond eq. [$\\AA$]'),
    ('angle_eq', 'Angle eq. [deg]'),
    ('torsion_k1', 'Torsion k_1 [kcal/mol]'),
    ('bond_k', 'Bond k [kcal/mol/$\\AA^2$]'),
    ('angle_k', 'Angle k [kcal/mol/deg$^2$]'),
    ('torsion_kn', 'Torsion k_2-n [kcal/mol]'),
]


def compare_parameters_detailed(
        params_x: Union[Parameters, Sequence[Parameters]],
        params_y: Union[Parameters, Sequence[Parameters]],
        filename: Optional[str] = None,
        xlabel: str = 'reference', ylabel: str = 'predicted',
        title: Optional[str] = None, n_periodicity: int = 3,
        exclude_idxs: Optional[Sequence[np.ndarray]] = None,
        density: bool = False):
    """Reference-layout calibration figure (Parameters.py:646-830): signed
    torsion ks split per periodicity (k_1 vs k_2..k_n), angles in degrees,
    square axes with the identity line. density=True adds a log-scaled
    hexbin under the scatter (matplotlib stand-in for the reference's
    seaborn kdeplot — seaborn is not a dependency here)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    if isinstance(params_x, Parameters):
        params_x = [params_x]
    if isinstance(params_y, Parameters):
        params_y = [params_y]
    if len(params_x) != len(params_y):
        raise ValueError('params_x and params_y must align')
    px = _detailed_panels(params_x, n_periodicity, exclude_idxs)
    py = _detailed_panels(params_y, n_periodicity, exclude_idxs)

    fig, axes = plt.subplots(2, 3, figsize=(15, 10))
    for ax, (key, label) in zip(axes.flat, _DETAILED_TITLES):
        x, y = px[key], py[key]
        if x.shape != y.shape:
            # same rationale as compare_parameters: mismatched tuple sets
            # would scatter wrongly paired values — annotate, don't abort
            # the whole evaluation plot stage
            ax.text(0.5, 0.5, f'tuple sets differ\n({x.shape} vs {y.shape})',
                    ha='center', va='center', transform=ax.transAxes,
                    fontsize=9, color='0.4')
            ax.set_title(label)
            continue
        good = np.isfinite(x) & np.isfinite(y)
        x, y = x[good], y[good]
        if len(x):
            if density:
                from matplotlib.colors import LogNorm
                ax.hexbin(x, y, gridsize=50, cmap='Blues', norm=LogNorm(),
                          mincnt=1)
            ax.scatter(x, y, s=4, alpha=0.5, color='tab:blue')
            lo = min(ax.get_xlim()[0], ax.get_ylim()[0])
            hi = max(ax.get_xlim()[1], ax.get_ylim()[1])
            ax.plot([lo, hi], [lo, hi], 'k--', lw=1)
            ax.set_xlim(lo, hi)
            ax.set_ylim(lo, hi)
        ax.set_title(label)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=120)
        plt.close(fig)
        return None
    return fig, axes


def plot_parameters_detailed(
        parameters: Union[Parameters, Sequence[Parameters]],
        compare: Optional[Union[Parameters, Sequence[Parameters]]] = None,
        filename: Optional[str] = None, name: str = 'Grappa',
        compare_name: str = 'Reference', title: Optional[str] = None,
        n_periodicity: int = 3):
    """Reference-layout distribution figure (Parameters.py:827-923):
    side-by-side violins of each panel, optionally against a second
    parameter collection (e.g. the classical force field)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    if isinstance(parameters, Parameters):
        parameters = [parameters]
    if isinstance(compare, Parameters):
        compare = [compare]
    panels = _detailed_panels(parameters, n_periodicity)
    cpanels = _detailed_panels(compare, n_periodicity) if compare else None

    fig, axes = plt.subplots(2, 3, figsize=(15, 10))
    for ax, (key, label) in zip(axes.flat, _DETAILED_TITLES):
        sets = [panels[key][np.isfinite(panels[key])]]
        ticks = [name]
        if cpanels is not None:
            sets.append(cpanels[key][np.isfinite(cpanels[key])])
            ticks.append(compare_name)
        sets = [s for s in sets if len(s)]
        if sets:
            ax.violinplot(sets, showmedians=True)
            ax.set_xticks(range(1, len(sets) + 1))
            ax.set_xticklabels(ticks[:len(sets)])
        ax.set_title(label)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=120)
        plt.close(fig)
        return None
    return fig, axes


def compare_parameters(params_x: Union[Parameters, Sequence[Parameters]],
                       params_y: Union[Parameters, Sequence[Parameters]],
                       filename: Optional[str] = None,
                       xlabel: str = 'reference',
                       ylabel: str = 'predicted',
                       title: Optional[str] = None):
    """Scatter of y vs x per parameter type (tuples must align) — the
    reference's per-parameter calibration plot (Parameters.py:646-923,
    evaluation.py:389-408). Accepts single Parameters or aligned lists."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    if isinstance(params_x, Parameters):
        params_x = [params_x]
    if isinstance(params_y, Parameters):
        params_y = [params_y]

    fig, axes = plt.subplots(2, 3, figsize=(14, 8))
    for ax, (key, label) in zip(axes.flat, _PARAM_PANELS):
        x = np.concatenate([_values(p, key) for p in params_x])
        y = np.concatenate([_values(p, key) for p in params_y])
        if len(x) != len(y):
            # different tuple/periodicity enumerations (e.g. classical
            # impropers store only assigned versions while predictions
            # cover all 3 cyclic versions): truncating would scatter
            # wrongly paired values, so annotate the panel instead
            ax.text(0.5, 0.5, f'tuple sets differ\n({len(x)} vs {len(y)})',
                    ha='center', va='center', transform=ax.transAxes,
                    fontsize=9, color='0.4')
            ax.set_title(label)
            continue
        good = np.isfinite(x) & np.isfinite(y)
        x, y = x[good], y[good]
        if len(x):
            ax.scatter(x, y, s=4, alpha=0.5)
            lo, hi = min(x.min(), y.min()), max(x.max(), y.max())
            ax.plot([lo, hi], [lo, hi], 'k--', lw=0.8)
        ax.set_title(label)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=120)
        plt.close(fig)
        return None
    return fig, axes
