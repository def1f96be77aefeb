"""Metric logging: JSONL file logger + optional wandb passthrough.

Counterpart of `grappa_tpu.train.logging`, with the same flattened keys.
The reference logs everything to wandb (reference: src/grappa/training/
lightning_trainer.py:22-40). Offline-first here: metrics stream into
`<run_dir>/metrics.jsonl` (one JSON object per event, with wall-clock time),
and a wandb run is attached transparently when the package is importable and
GRAPPA_TPU_WANDB=1.
"""
from __future__ import annotations

import importlib
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, run_dir: Optional[str] = None, use_wandb: bool = None,
                 project: str = 'grappa_tpu', name: Optional[str] = None):
        self.run_dir = Path(run_dir) if run_dir else None
        self._file = None
        if self.run_dir:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self._file = open(self.run_dir / 'metrics.jsonl', 'a')
        if use_wandb is None:
            use_wandb = os.environ.get('GRAPPA_TPU_WANDB') == '1'
        self._wandb = None
        if use_wandb and importlib.util.find_spec('wandb') is not None:
            import wandb
            self._wandb = wandb.init(project=project, name=name,
                                     dir=str(self.run_dir or '.'))

    def log(self, metrics: Dict):
        record = {'time': time.time(), **_flatten(metrics)}
        if self._file:
            self._file.write(json.dumps(record) + '\n')
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != 'time'})

    def finish(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    def __call__(self, metrics: Dict):
        self.log(metrics)


def _flatten(d: Dict, prefix: str = '') -> Dict:
    out = {}
    for k, v in d.items():
        key = f'{prefix}{k}'
        if isinstance(v, dict):
            out.update(_flatten(v, f'{key}/'))
        else:
            try:
                json.dumps(v)
                out[key] = v
            except TypeError:
                out[key] = str(v)
    return out
