"""The espaloma-proxy offline accuracy benchmark on the port.

Counterpart of the JAX package's experiments/espaloma_proxy/run.py (and
of its analyze.py: `analyze` below). 2,000 molecules in four chemistries
that mirror the published espaloma collection's axes, every target from
one shared environment force field (data.synthetic.make_moldata with
learnable=True), a fixed 80/10/10 espaloma-style split committed as
experiments/espaloma_proxy/espaloma_split.json, and training through the
production path (the benchmark recipe's yaml, tag resolution through
GRAPPA_TPU_CACHE, the weighted multi-dataset loader, bootstrap test
metrics):

    proxy-spice-monomers  500 mols  10-20 atoms  HCNO        am1BCC  8 confs
    proxy-spice-pubchem   700 mols  18-40 atoms  HCNOS+F/Cl  am1BCC  6 confs
    proxy-peptide         500 mols  30-60 atoms  HCNO-chain  amber99 6 confs
    proxy-rna-like        300 mols  20-36 atoms  HCNOP       am1BCC  8 confs

Stages, each writing under --out (default runs/torch_experiments/proxy):

    python -m grappa_tpu_torch.experiments.espaloma_proxy generate
    python -m grappa_tpu_torch.experiments.espaloma_proxy train \
        [--epochs 150] [--time_limit HOURS] [--device cpu]
    python -m grappa_tpu_torch.experiments.espaloma_proxy table
    python -m grappa_tpu_torch.experiments.espaloma_proxy analyze
    python -m grappa_tpu_torch.experiments.espaloma_proxy all ...

<out>/cache/datasets/<tag> holds the generated datasets, <out>/runs/
espaloma-proxy the training run, and <out> its proxy_results.json,
table.md / .tex, gate.json and analysis.json. --time_limit bounds one
session (hours): the run checkpoints, evaluates and exports at the bound,
and `train` again resumes it from last.ckpt.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from multiprocessing import get_context
from pathlib import Path
from typing import Dict, List, Optional

from grappa_tpu_torch.espaloma_split import build_espaloma_split
from grappa_tpu_torch.train.config import read_yaml, write_yaml
from grappa_tpu_torch.train.export import load_model_dict
from grappa_tpu_torch.train.run import do_trainrun, resume_trainrun

EXPERIMENTS = Path(__file__).resolve().parents[2] / 'experiments'
BENCHMARK_YAML = EXPERIMENTS / 'benchmark' / 'grappa_config.yaml'
SPLIT_JSON = EXPERIMENTS / 'espaloma_proxy' / 'espaloma_split.json'
OUT = Path('runs') / 'torch_experiments' / 'proxy'
RUN_NAME = 'espaloma-proxy'

# (n_mols, n_confs, seed, elements, atom_range, charge_model); element
# repeats raise the draw probability. Molecule i of a chemistry is
# make_moldata(seed=seed * 1000 + i), with the id '<tag>-<seed * 1000 + i>'
SPECS = {
    'proxy-spice-monomers': (500, 8, 31, [1, 1, 6, 6, 7, 8], (10, 21),
                             'am1BCC'),
    'proxy-spice-pubchem': (700, 6, 32, [1, 1, 6, 6, 6, 7, 8, 16, 9, 17],
                            (18, 41), 'am1BCC'),
    'proxy-peptide': (500, 6, 33, [1, 1, 1, 6, 6, 6, 7, 8], (30, 61),
                      'amber99'),
    'proxy-rna-like': (300, 8, 34, [1, 6, 6, 7, 7, 8, 8, 15], (20, 37),
                       'am1BCC'),
}

# The two-tier gate on the held-out test split: TARGET, the 1.0 / 1.5
# limits, and RATCHET, per-dataset ceilings at <= 10% above the JAX
# package's 2400-epoch record, capped at the target
GATE_TARGET = {'rmse_energies': 1.0, 'crmse_gradients': 1.5}
GATE_RATCHET = {
    'proxy-spice-monomers': {'rmse_energies': 0.42, 'crmse_gradients': 0.86},
    'proxy-spice-pubchem': {'rmse_energies': 0.90, 'crmse_gradients': 1.50},
    'proxy-peptide': {'rmse_energies': 0.62, 'crmse_gradients': 0.74},
    'proxy-rna-like': {'rmse_energies': 0.67, 'crmse_gradients': 1.00},
}
# the four datasets in the order the ablation, learning-curve and sweep
# drivers list them
PROXY_DATASETS = ['proxy-spice-monomers', 'proxy-spice-pubchem',
                  'proxy-peptide', 'proxy-rna-like']


@dataclass(frozen=True)
class Study:
    """One proxy benchmark: its chemistries (in SPECS' format), the
    committed split of their ids, its gate's per-dataset ratchet (the
    target for a dataset not in it) and its default output directory."""
    specs: Dict
    split_json: Path
    ratchet: Dict
    out: Path


PROXY = Study(SPECS, SPLIT_JSON, GATE_RATCHET, OUT)


@contextlib.contextmanager
def dataset_cache(path):
    """GRAPPA_TPU_CACHE pointed at `path` for the block, then restored."""
    saved = os.environ.get('GRAPPA_TPU_CACHE')
    os.environ['GRAPPA_TPU_CACHE'] = str(path)
    try:
        yield Path(path)
    finally:
        if saved is None:
            os.environ.pop('GRAPPA_TPU_CACHE', None)
        else:
            os.environ['GRAPPA_TPU_CACHE'] = saved


def default_cache(cache_dir=None) -> Path:
    """The proxy datasets' cache: `cache_dir`, else GRAPPA_TPU_CACHE,
    else <OUT>/cache (what the studies on the proxy data read)."""
    return Path(cache_dir or os.environ.get('GRAPPA_TPU_CACHE')
                or OUT / 'cache')


def tasks(specs: Optional[Dict] = None) -> Dict[str, List[tuple]]:
    """make_moldata's arguments of every molecule, by chemistry."""
    specs = SPECS if specs is None else specs
    return {tag: [(tag, seed * 1000 + i, n_confs, elements, atom_range, cm)
                  for i in range(n_mols)]
            for tag, (n_mols, n_confs, seed, elements, atom_range, cm)
            in specs.items()}


def build_split(mol_ids) -> Dict[str, List[str]]:
    """The fixed espaloma-style split: the ids sorted, every 10th is test,
    the one after it validation (80 / 10 / 10)."""
    ids = sorted(mol_ids)
    return build_espaloma_split(ids, te_smiles=ids[::10],
                                vl_smiles=ids[1::10])


def _init_worker():
    import torch
    torch.set_num_threads(1)


def _one_moldata(task):
    from grappa_tpu_torch.data.synthetic import make_moldata
    tag, seed, n_confs, elements, atom_range, charge_model = task
    return make_moldata(seed=seed, n_confs=n_confs, ds_name=tag,
                        learnable=True, conf_noise=0.08,
                        charge_model=charge_model, elements=elements,
                        atom_range=atom_range)


def generate(workers: int = 8, cache_dir=None,
             study: Study = PROXY) -> Dict[str, List[str]]:
    """Generate (or load from the cache) every chemistry of the study
    into <cache_dir>/datasets/<tag> and return the split of their ids,
    which must equal the study's committed split json.

    The molecules are made on the host in `workers` spawned processes of
    one thread each, which never touch CUDA."""
    from grappa_tpu_torch.data.dataset import Dataset
    split_json = Path(study.split_json)
    if not split_json.exists():
        raise FileNotFoundError(f'no committed split at {split_json}')
    cache = Path(cache_dir) if cache_dir else study.out / 'cache'
    all_ids = []
    todo = {tag: ts for tag, ts in tasks(study.specs).items()
            if not (cache / 'datasets' / tag).exists()}
    if todo:
        # one pool for every chemistry: the workers start once
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=get_context('spawn'),
                                 initializer=_init_worker) as ex:
            made = iter(ex.map(_one_moldata,
                               [t for ts in todo.values() for t in ts],
                               chunksize=8))
            mds = {tag: [next(made) for _ in ts] for tag, ts in todo.items()}
    for tag in study.specs:
        out = cache / 'datasets' / tag
        if tag in todo:
            ds = Dataset.from_moldata(mds[tag], tag)
            ds.save(out)
            print(f'{tag}: generated {len(ds)} mols')
        else:
            ds = Dataset.load(out)
            print(f'{tag}: cached ({len(ds)} mols)')
        all_ids += ds.mol_ids

    split = build_split(all_ids)
    if json.loads(split_json.read_text()) != split:
        raise RuntimeError(
            f'regenerated split differs from {split_json}: generation is '
            f'no longer deterministic')
    print(f'split matches {split_json}')
    return split


def proxy_config(base_config: Optional[Dict] = None,
                 epochs: Optional[int] = None,
                 time_limit: Optional[float] = None,
                 datasets: Optional[List[str]] = None,
                 split_json=None) -> Dict:
    """The benchmark recipe (or `base_config`) on `datasets` (default the
    proxy's, sorted) and split_json (None: the config's own splitpath),
    with one loop an epoch over the batch cache and checkpoints written
    on a background thread; `epochs` (when given) epochs, `time_limit`
    (when given) this session's bound in hours."""
    config = (copy.deepcopy(base_config) if base_config is not None
              else read_yaml(BENCHMARK_YAML))
    datasets = list(sorted(SPECS) if datasets is None else datasets)
    config['data_config'].update({
        'datasets': datasets,
        'pure_train_datasets': [], 'pure_val_datasets': [],
        # the published weighting: the scarce RNA-like set up, the big
        # pubchem-like set down (by suffix, so renamed specs inherit it)
        'weights': {**{n: 3.0 for n in datasets if n.endswith('rna-like')},
                    **{n: 0.8 for n in datasets
                       if n.endswith('spice-pubchem')}},
        'conf_strategy': 8, 'val_conf_strategy': 8,
    })
    if split_json is not None:
        config['data_config']['splitpath'] = str(split_json)
    tc = config['trainer_config']
    tc.update({'scan_epochs': True, 'async_checkpoints': True})
    if epochs is not None:
        tc['max_epochs'] = epochs
    if time_limit is not None:
        # the bound of this session; time_limit is cumulative over resumes
        # and would end a resumed run at once
        config['lit_model_config']['session_time_limit'] = float(time_limit)
    return config


def _reconcile(run_dir: Path, epochs: int, time_limit: Optional[float]):
    """Bring the stored config of an interrupted run to this call's epoch
    target, execution mode and session bound (cleared when no bound is
    given, so a stale one never carries over)."""
    stored = read_yaml(run_dir / 'grappa_config.yaml')
    tc = stored['trainer_config']
    wanted = {'max_epochs': epochs, 'scan_epochs': True,
              'async_checkpoints': True}
    changed = {k: v for k, v in wanted.items() if tc.get(k) != v}
    tc.update(changed)
    lc = stored['lit_model_config']
    session = float(time_limit) if time_limit is not None else None
    if lc.get('session_time_limit') != session:
        lc['session_time_limit'] = session
        changed['session_time_limit'] = session
    if changed:
        write_yaml(stored, run_dir / 'grappa_config.yaml')
        print(f'updated stored config: {changed}')


def train_or_resume(config: Dict, run_dir, cache_dir=None, device=None):
    """Train `config` into run_dir (named after it) through the production
    path on the batch cache, or resume it from run_dir/last.ckpt when it
    is there, with the datasets read from cache_dir (default_cache's).
    Returns the run's output and the exported model's bootstrap test
    metrics."""
    run_dir = Path(run_dir)
    with dataset_cache(default_cache(cache_dir)):
        if (run_dir / 'last.ckpt').exists():
            print(f'resuming interrupted run from {run_dir}/last.ckpt')
            out = resume_trainrun(str(run_dir), cache_batches=True,
                                  device=device)
        else:
            out = do_trainrun(config, project_dir=str(run_dir.parent),
                              run_name=run_dir.name, cache_batches=True,
                              device=device)
    md = load_model_dict(out['model_dict_path'])
    return out, (md.get('results') or {}).get('test')


def summarize(out: Dict, test: Optional[Dict]) -> Dict:
    """The run's summary: epochs, best early-stopping loss and the
    exported model's bootstrap test metrics (`test`)."""
    results = out['results']
    history = results.get('history', [])
    return {
        'epoch': results.get('epochs'),      # absolute epoch reached
        'epochs_run': len(history),          # this session's
        'best_es_loss': min(
            (h['early_stopping_loss'] for h in history
             if h.get('early_stopping_loss') is not None), default=None),
        'test': test,
    }


def train(epochs: int = 150, out_dir=None, base_config: Optional[Dict] = None,
          time_limit: Optional[float] = None, cache_dir=None,
          device=None, study: Study = PROXY) -> Dict:
    """Train on the study's datasets and split through the production path
    into <out_dir>/runs/espaloma-proxy (resuming it from last.ckpt when it
    is there), write <out_dir>/proxy_results.json and the table.
    base_config: another config than the benchmark yaml (a small one for
    a rehearsal). time_limit: this session's bound in hours."""
    out_dir = Path(out_dir) if out_dir else study.out
    run_dir = out_dir / 'runs' / RUN_NAME
    if (run_dir / 'last.ckpt').exists():
        _reconcile(run_dir, epochs, time_limit)
    config = proxy_config(base_config, epochs, time_limit,
                          sorted(study.specs), study.split_json)
    config['trainer_config']['name'] = RUN_NAME
    out, test = train_or_resume(config, run_dir,
                                cache_dir or out_dir / 'cache', device)
    summary = summarize(out, test)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / 'proxy_results.json').write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1))
    try:
        table(out_dir, study)
    except Exception as exc:   # the results are on disk already
        print(f'table generation failed (rerun the table stage): {exc}')
    return summary


def table(out_dir=None, study: Study = PROXY) -> Dict:
    """Render <out_dir>/proxy_results.json into table.md / .tex (with the
    bootstrap CIs) and write the gate's verdict (the study's ratchet and
    the target) to gate.json."""
    from grappa_tpu_torch.train.report import write_report
    out_dir = Path(out_dir) if out_dir else study.out
    summary = json.loads((out_dir / 'proxy_results.json').read_text())
    test = summary.get('test') or {}
    if not test:
        raise RuntimeError('proxy_results.json has no test metrics yet')
    write_report({'grappa_tpu': test}, str(out_dir / 'table'), with_ci=True)

    def check(m, limits):
        return {k: (m.get(k) is not None and float(m[k]) <= lim)
                for k, lim in limits.items()}

    per_ds = {ds: m for ds, m in test.items() if ds != 'avg'}
    ratchet = {ds: check(m, study.ratchet.get(ds, GATE_TARGET))
               for ds, m in per_ds.items()}
    target = {ds: check(m, GATE_TARGET) for ds, m in per_ds.items()}
    ok = bool(ratchet) and all(all(v.values()) for v in ratchet.values())
    target_ok = bool(target) and all(all(v.values())
                                     for v in target.values())
    verdict = {'pass': ok, 'target_pass': target_ok,
               'limits': GATE_TARGET, 'ratchet_limits': study.ratchet,
               'per_dataset': ratchet, 'per_dataset_target': target}
    (out_dir / 'gate.json').write_text(json.dumps(verdict, indent=1))
    print(f'wrote {out_dir}/table.md .tex; regression gate: '
          f'{"PASS" if ok else "FAIL"}; aspirational target: '
          f'{"PASS" if target_ok else "not reached"}')
    return verdict


# --- convergence analysis (experiments/espaloma_proxy/analyze.py) ---

def load_series(run_dir) -> List[Dict]:
    """metrics.jsonl -> one dict an epoch (train and validation rows
    merged)."""
    rows: Dict[int, Dict] = {}
    with open(Path(run_dir) / 'metrics.jsonl') as f:
        for line in f:
            r = json.loads(line)
            rows.setdefault(r['epoch'], {}).update(r)
    return [rows[e] for e in sorted(rows)]


def tail_slope(epochs, values, frac=0.2, min_points=10):
    """Least-squares slope of log10(value) per 100 epochs over the last
    `frac` of the run (None below `min_points` usable points)."""
    pts = [(e, v) for e, v in zip(epochs, values)
           if v is not None and v > 0 and math.isfinite(v)]
    if len(pts) < min_points:
        return None
    tail = pts[-max(min_points, int(len(pts) * frac)):]
    xs = [e for e, _ in tail]
    ys = [math.log10(v) for _, v in tail]
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    den = sum((x - mx) ** 2 for x in xs)
    if den == 0:
        return None
    return 100.0 * sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den


def analyze(run_dir) -> Dict:
    """Is the run still descending, at a generalization floor (validation
    flat while training falls) or at an optimization plateau?"""
    series = load_series(run_dir)
    epochs = [r['epoch'] for r in series]
    es = [r.get('early_stopping_loss') for r in series]
    lr = [r.get('lr') for r in series]
    train_loss = [r.get('train_loss') for r in series]
    val_e = [r.get('val_metrics/avg/rmse_energies') for r in series]
    val_f = [r.get('val_metrics/avg/rmse_gradients') for r in series]

    lr_events = [{'epoch': epochs[i], 'from': lr[i - 1], 'to': lr[i]}
                 for i in range(1, len(lr))
                 if lr[i] is not None and lr[i - 1] is not None
                 and lr[i] != lr[i - 1]]
    valid_es = [(e, v) for e, v in zip(epochs, es) if v is not None]
    best_es = min(valid_es, key=lambda t: t[1]) if valid_es else None
    slopes = {'es_loss_tail_slope': tail_slope(epochs, es),
              'train_loss_tail_slope': tail_slope(epochs, train_loss),
              'val_e_rmse_tail_slope': tail_slope(epochs, val_e),
              'val_f_rmse_tail_slope': tail_slope(epochs, val_f)}

    s_val = slopes['es_loss_tail_slope']
    s_train = slopes['train_loss_tail_slope']
    if s_val is None:
        verdict = 'insufficient data'
    elif s_val < -0.02:
        verdict = ('still descending: val es_loss falls '
                   f'{-s_val:.3f} decades/100ep in the tail — train longer')
    elif s_train is not None and s_train < -0.02:
        verdict = ('generalization floor: train still falls '
                   f'({s_train:.3f} dec/100ep) while val is flat '
                   f'({s_val:.3f}) — data- or capacity-limited, more '
                   'epochs will not close the gate gap')
    else:
        verdict = ('optimization plateau: train and val both flat (train '
                   f'{s_train if s_train is not None else float("nan"):.3f}'
                   f', val {s_val:.3f} dec/100ep) — schedule/LR bound')
    last = lambda xs: next((v for v in reversed(xs) if v is not None), None)
    return {
        'epochs_seen': len(epochs),
        'last_epoch': epochs[-1] if epochs else None,
        'best_es_loss': ({'epoch': best_es[0], 'value': best_es[1]}
                         if best_es else None),
        'final_lr': last(lr),
        'lr_decay_events': lr_events,
        'tail_slopes_log10_per_100ep': slopes,
        'final_val': {'avg_rmse_energies': last(val_e),
                      'avg_rmse_gradients': last(val_f)},
        'verdict': verdict,
    }


def plot(run_dir, out_png):
    """The validation loss, energy RMSE and learning rate by epoch (needs
    matplotlib, imported here)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    series = load_series(run_dir)
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    for ax, key, label in (
            (axes[0], 'early_stopping_loss', 'val early-stopping loss'),
            (axes[1], 'val_metrics/avg/rmse_energies',
             'val avg energy RMSE [kcal/mol]'),
            (axes[2], 'lr', 'learning rate')):
        pts = [(r['epoch'], r[key]) for r in series
               if r.get(key) is not None]
        ax.plot([p[0] for p in pts], [p[1] for p in pts], lw=1.2)
        ax.set_yscale('log')
        ax.set_xlabel('epoch')
        ax.set_title(label, fontsize=10)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def write_analysis(out_dir=None, run_dir=None) -> Dict:
    """analyze() of the run into <out_dir>/analysis.json, and the curves
    into learning_curves.png where matplotlib is installed."""
    out_dir = Path(out_dir) if out_dir else OUT
    run_dir = Path(run_dir) if run_dir else out_dir / 'runs' / RUN_NAME
    out = analyze(run_dir)
    (out_dir / 'analysis.json').write_text(json.dumps(out, indent=1))
    try:
        plot(run_dir, out_dir / 'learning_curves.png')
    except ImportError as exc:
        print(f'no plot: {exc}')
    print(json.dumps(out, indent=1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.experiments.espaloma_proxy')
    ap.add_argument('stage',
                    choices=['generate', 'train', 'table', 'analyze', 'all'])
    ap.add_argument('--epochs', type=int, default=150)
    ap.add_argument('--workers', type=int, default=8)
    ap.add_argument('--out', default=str(OUT))
    ap.add_argument('--time_limit', type=float, default=None,
                    help='bound of this session in hours; the run '
                         'finalizes at it and resumes later')
    ap.add_argument('--device', default=None,
                    help='torch device (default: CUDA)')
    args = ap.parse_args(argv)
    out = Path(args.out)
    if args.stage in ('generate', 'all'):
        generate(workers=args.workers, cache_dir=out / 'cache')
    if args.stage in ('train', 'all'):
        train(epochs=args.epochs, out_dir=out, time_limit=args.time_limit,
              device=args.device)
    if args.stage == 'table':
        table(out)
    if args.stage in ('analyze', 'all'):
        write_analysis(out)


if __name__ == '__main__':
    main()
