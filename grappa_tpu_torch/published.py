"""Published grappa-1.2 benchmark numbers for release-ingest comparison.

The port's copy of `grappa_tpu.published`.

Test-split RMSEs from the reference's espaloma benchmark table
(reference: experiments/evaluation/espaloma_benchmark/table.tex:28-57,
report_summary.csv; transcribed in BASELINE.md). Energy RMSE in kcal/mol,
force component-RMSE in kcal/mol/A. Keys are this repo's dataset-zoo tags
(grappa_tpu_torch.zoo.DATASET_TAGS); the table's display names differ
(e.g. 'gen2' is published as 'Gen2-Opt', 'pepconf-dlc' as 'Pepconf-Opt').
"""

GRAPPA_12_TEST_RMSE = {
    'spice-pubchem':      {'rmse_energies': 2.3, 'crmse_gradients': 6.1},
    'spice-des-monomers': {'rmse_energies': 1.3, 'crmse_gradients': 5.2},
    'spice-dipeptide':    {'rmse_energies': 2.3, 'crmse_gradients': 5.4},
    'rna-diverse':        {'rmse_energies': 3.3, 'crmse_gradients': 3.7},
    'rna-trinucleotide':  {'rmse_energies': 3.5, 'crmse_gradients': 3.6},
    'gen2-torsion':       {'rmse_energies': 1.7, 'crmse_gradients': 4.0},
    'protein-torsion':    {'rmse_energies': 2.2, 'crmse_gradients': 3.8},
    'gen2':               {'rmse_energies': 1.8, 'crmse_gradients': 3.8},
    'pepconf-dlc':        {'rmse_energies': 3.2, 'crmse_gradients': 3.6},
}

# published-parity criterion used by `cli.py ingest-release`: an imported
# checkpoint reproduces the published table if every metric lands within
# this relative tolerance (bootstrap CI half-widths in report_summary.csv
# are ~2-6% of the value; 10% leaves room for conformer subsampling).
PARITY_RTOL = 0.10


def parity_verdict(ours: dict, rtol: float = PARITY_RTOL) -> dict:
    """Compare evaluated per-dataset metrics against the published table.

    `ours`: {dataset_tag: {metric: value, ...}, ...} as produced by
    eval_model. Returns {'pass': bool, 'per_dataset': {...}} where each
    dataset maps metric -> {'ours', 'published', 'ratio', 'pass'}.
    Datasets without published numbers are reported but don't gate.
    """
    per_ds = {}
    overall = True
    gated = 0
    for ds, metrics in ours.items():
        if ds == 'avg':
            continue
        pub = GRAPPA_12_TEST_RMSE.get(ds)
        entry = {}
        for key in ('rmse_energies', 'crmse_gradients'):
            v = metrics.get(key)
            p = (pub or {}).get(key)
            ok = (v is not None and p is not None
                  and float(v) <= p * (1.0 + rtol))
            entry[key] = {'ours': None if v is None else float(v),
                          'published': p,
                          'ratio': (float(v) / p if v is not None and p
                                    else None),
                          'pass': ok if p is not None else None}
            if p is not None:
                gated += 1
                if not ok:
                    overall = False
        per_ds[ds] = entry
    # gated == 0 means no evaluated dataset had published numbers — that is
    # a mismatch (wrong tags?), never vacuous parity
    return {'pass': overall and gated > 0, 'rtol': rtol,
            'metrics_gated': gated, 'per_dataset': per_ds}
