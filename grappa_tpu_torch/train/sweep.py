"""Local hyperparameter sweeps (random search + Bayesian optimization).

Counterpart of `grappa_tpu.train.sweep`: the sampling, the spec encoder,
the GP surrogate and the acquisition are the same numpy arithmetic, so the
same seed gives the same draws and suggestions; each trial is the port's
`do_trainrun` on `device` (CUDA unless the caller asks for another). The
reference runs wandb Bayes sweeps over lr/batch/width/layers (reference:
experiments/hyperparameter_optimization/sweep_config.yaml + hpo_run.py via
the config_from_sweep hook, trainrun.py:30-41). This is an offline-first
equivalent: a sweep spec maps dotted config paths to value distributions;
each trial runs do_trainrun with a short budget and the results stream into
<sweep_dir>/trials.jsonl. The `finish_criterion` mechanism of the trainer
kills unpromising trials early, like the reference's sweep runs.

`method='bayes'` matches the reference sweep's `method: bayes`: a
first-party Gaussian-process surrogate (RBF kernel on the unit-cube
encoding of the spec, numpy-only — wandb's service is unavailable offline)
with expected-improvement acquisition over random candidates; the first
`n_init` trials are random.

Spec example:
    spec = {
        'lit_model_config.lr': ('log_uniform', 1e-5, 1e-3),
        'model_config.gnn_width': ('choice', [256, 512]),
        'data_config.train_batch_size': ('choice', [16, 32, 64]),
    }
"""
from __future__ import annotations

import copy
import json
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


def sample_value(rng: np.random.Generator, dist: Tuple):
    kind = dist[0]
    if kind == 'choice':
        values = dist[1]
        return values[int(rng.integers(len(values)))]
    if kind == 'uniform':
        return float(rng.uniform(dist[1], dist[2]))
    if kind == 'log_uniform':
        return float(np.exp(rng.uniform(np.log(dist[1]), np.log(dist[2]))))
    if kind == 'int_uniform':
        return int(rng.integers(dist[1], dist[2] + 1))
    raise ValueError(f"unknown distribution {kind!r}")


class SpecEncoder:
    """Maps spec samples <-> points on the unit cube for the GP surrogate.

    Continuous dims normalize linearly (log-space for log_uniform);
    `choice` dims are one-hot encoded so the kernel sees no fake ordering.
    """

    def __init__(self, spec: Dict[str, Tuple]):
        self.spec = spec
        self.paths = sorted(spec)
        self.dim = sum(len(spec[p][1]) if spec[p][0] == 'choice' else 1
                       for p in self.paths)

    def encode(self, sampled: Dict[str, object]) -> np.ndarray:
        x: List[float] = []
        for p in self.paths:
            dist = self.spec[p]
            kind = dist[0]
            v = sampled[p]
            if kind == 'choice':
                onehot = [0.0] * len(dist[1])
                onehot[dist[1].index(v)] = 1.0
                x += onehot
            elif kind == 'uniform':
                x.append((float(v) - dist[1]) / (dist[2] - dist[1]))
            elif kind == 'log_uniform':
                x.append((np.log(float(v)) - np.log(dist[1]))
                         / (np.log(dist[2]) - np.log(dist[1])))
            elif kind == 'int_uniform':
                x.append((float(v) - dist[1]) / max(dist[2] - dist[1], 1))
            else:
                raise ValueError(f"unknown distribution {kind!r}")
        return np.asarray(x, np.float64)


def _gp_posterior(X: np.ndarray, y: np.ndarray, Xq: np.ndarray,
                  length_scale: float = 0.35, noise: float = 1e-4):
    """GP regression posterior mean/std at Xq (RBF kernel, zero prior mean
    on standardized y)."""
    def rbf(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / length_scale ** 2)

    K = rbf(X, X) + noise * np.eye(len(X))
    Ks = rbf(Xq, X)
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
    mean = Ks @ alpha
    v = np.linalg.solve(L, Ks.T)
    var = np.clip(1.0 + noise - (v ** 2).sum(0), 1e-12, None)
    return mean, np.sqrt(var)


def _expected_improvement(mean, std, best_y):
    """EI for MINIMIZATION on standardized y."""
    from math import erf, exp, pi, sqrt
    z = (best_y - mean) / std
    cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
    pdf = np.exp(-0.5 * z ** 2) / sqrt(2.0 * pi)
    return (best_y - mean) * cdf + std * pdf


def suggest_bayes(spec: Dict[str, Tuple], history: List[Dict],
                  rng: np.random.Generator,
                  n_candidates: int = 512) -> Dict[str, object]:
    """One GP-EI suggestion given trial history entries
    {'params': {...}, 'early_stopping_loss': float}."""
    enc = SpecEncoder(spec)
    done = [h for h in history
            if np.isfinite(h.get('early_stopping_loss', np.inf))]
    if len(done) < 2:
        return {p: sample_value(rng, d) for p, d in spec.items()}
    X = np.stack([enc.encode(h['params']) for h in done])
    y = np.log(np.maximum([h['early_stopping_loss'] for h in done], 1e-12))
    y_std = y.std() or 1.0
    y_norm = (y - y.mean()) / y_std
    cands = [{p: sample_value(rng, d) for p, d in spec.items()}
             for _ in range(n_candidates)]
    Xq = np.stack([enc.encode(c) for c in cands])
    mean, std = _gp_posterior(X, y_norm, Xq)
    ei = _expected_improvement(mean, std, y_norm.min())
    return cands[int(np.argmax(ei))]


def set_dotted(config: Dict, path: str, value):
    keys = path.split('.')
    node = config
    for k in keys[:-1]:
        node = node[k]
    if keys[-1] not in node:
        raise KeyError(f"config has no key {path!r}")
    node[keys[-1]] = value


def run_sweep(base_config: Dict, spec: Dict[str, Tuple], n_trials: int,
              sweep_dir: str = 'sweeps/sweep', seed: int = 0,
              dataset_override=None,
              max_epochs: Optional[int] = None,
              method: str = 'random', n_init: int = 5,
              cache_batches: bool = False, device=None) -> Dict:
    """Sweep with `method` in {'random', 'bayes'}; returns the best trial
    summary. 'bayes' = GP-EI after `n_init` random warmup trials (reference
    sweep_config.yaml method: bayes).

    Resumable: completed trials recorded in <sweep_dir>/trials.jsonl are
    skipped on re-invocation (their records seed the GP history), so an
    interrupted sweep continues where it stopped instead of retraining
    from trial 0, as an unattended run needs. A recorded best trial keeps
    its run directory in best.json (the JAX package's resumed best.json
    drops it), so resuming a finished sweep leaves best.json as it was.
    Each trial trains on `device` (CUDA unless the caller asks for
    another)."""
    from grappa_tpu_torch.train.run import do_trainrun
    from grappa_tpu_torch.utils import resolve_device

    if method not in ('random', 'bayes'):
        raise ValueError(f"method must be 'random' or 'bayes', got {method!r}")
    # a missing card raises here, not as an error record of every trial
    device = resolve_device(device)
    sweep_dir = Path(sweep_dir)
    sweep_dir.mkdir(parents=True, exist_ok=True)
    log_path = sweep_dir / 'trials.jsonl'
    rng = np.random.default_rng(seed)

    done: Dict[int, Dict] = ({int(rec['trial']): rec
                              for rec in read_trials(log_path)}
                             if log_path.exists() else {})

    history: List[Dict] = []
    best = {'trial': None, 'early_stopping_loss': float('inf')}
    with open(log_path, 'a') as log:
        for trial in range(n_trials):
            if trial in done:
                rec = done[trial]
                if 'early_stopping_loss' in rec:
                    history.append(rec)
                    if rec['early_stopping_loss'] < \
                            best['early_stopping_loss']:
                        # the run directory do_trainrun gave the trial, so
                        # that a resumed sweep writes the same best.json
                        best = {'trial': trial, 'params': rec['params'],
                                'early_stopping_loss':
                                    rec['early_stopping_loss'],
                                'run_dir': str(sweep_dir
                                               / f'trial_{trial:03d}')}
                continue
            config = copy.deepcopy(base_config)
            if method == 'bayes' and trial >= n_init:
                sampled = suggest_bayes(spec, history, rng)
            else:
                sampled = {path: sample_value(rng, dist)
                           for path, dist in spec.items()}
            for path, value in sampled.items():
                set_dotted(config, path, value)
            if max_epochs is not None:
                config['trainer_config']['max_epochs'] = max_epochs
            config['trainer_config']['name'] = f'trial_{trial:03d}'

            record = {'trial': trial, 'params': sampled}
            try:
                out = do_trainrun(config, project_dir=str(sweep_dir),
                                  run_name=f'trial_{trial:03d}',
                                  dataset_override=dataset_override,
                                  cache_batches=cache_batches,
                                  device=device)
                loss = out['results'].get('best_early_stopping_loss',
                                          float('inf'))
                record['early_stopping_loss'] = loss
                record['epochs'] = out['results'].get('epochs')
                history.append(record)
                if loss < best['early_stopping_loss']:
                    best = {'trial': trial, 'params': sampled,
                            'early_stopping_loss': loss,
                            'run_dir': out['run_dir']}
            except Exception as exc:
                record['error'] = f'{type(exc).__name__}: {exc}'
                traceback.print_exc()
            log.write(json.dumps(_json_safe(record)) + '\n')
            log.flush()
    (sweep_dir / 'best.json').write_text(
        json.dumps(_json_safe(best), indent=1))
    return best


def read_trials(path) -> List[Dict]:
    """The records of a sweep's trials.jsonl. A non-finite early-stopping
    loss (a trial that ended before its first QM epoch), which _json_safe
    wrote as null, reads back as infinity."""
    trials = [json.loads(line) for line in Path(path).read_text()
              .splitlines()]
    for rec in trials:
        if rec.get('early_stopping_loss', 0.0) is None:
            rec['early_stopping_loss'] = float('inf')
    return trials


def _json_safe(obj):
    """Replace inf/nan floats with None: json.dumps would emit the non-RFC
    'Infinity'/'NaN' tokens, which strict parsers (jq, pandas) reject."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj
