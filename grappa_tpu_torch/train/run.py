"""Training-run entry point: config -> dataloaders -> statistics -> model ->
Trainer -> fitted checkpoint + exported model_dict.

Counterpart of `grappa_tpu.train.run` (reference: src/grappa/training/
trainrun.py:24-191 `do_trainrun`/`safe_trainrun` and get_dataloaders.py:
9-189): dataset tag/path resolution, feature pruning, split load-or-compute
(+ json persistence), pure train/val/test datasets that bypass the mol-id
split, subsampling, per-subdataset sampling weights, a one-batch non-NaN
smoke test (`test_model`), and one automatic restart from last.ckpt on
failure. Every entry point runs on a CUDA device unless the caller passes
`device='cpu'`; the smoke test runs on the run's device, kernels included.

With `mesh` (`parallel.dp.make_mesh`) every rank of the job makes the same
call (under torchrun or torch.multiprocessing) and the Trainer trains
data-parallel on the mesh's device. The split, the statistics and the
initial model are deterministic (the config's seed), so every rank makes
the same ones; the Trainer broadcasts rank 0's weights all the same. Rank
0 alone writes the run directory's files (config, split, statistics,
logs, checkpoints, model.npz), and every rank returns after they are
written. There is no command-line flag for it, as in the JAX package.
"""
from __future__ import annotations

import copy
import json
import pickle
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from grappa_tpu_torch.data.dataset import (
    Dataset, calc_split_ids, load_split, save_split)
from grappa_tpu_torch.data.loader import GraphLoader
from grappa_tpu_torch.models.grappa_model import make_model
from grappa_tpu_torch.statistics import param_statistics_from_graphs
from grappa_tpu_torch.train.config import read_yaml, validate_config, write_yaml
from grappa_tpu_torch.train.eval_model import BootstrapEvaluator
from grappa_tpu_torch.train.export import (
    build_model_dict, load_imported, load_model_dict, save_model_dict)
from grappa_tpu_torch.train.logging import MetricLogger
from grappa_tpu_torch.train.torch_compat import import_state_dict
from grappa_tpu_torch.train.trainer import (
    Trainer, _verify_checkpoint, make_eval_step)
from grappa_tpu_torch.utils import resolve_device
from grappa_tpu_torch.zoo import dataset_path_from_tag


def load_datasets(tags: List[str]) -> Dataset:
    """Resolve tags/paths to dataset directories and concatenate."""
    parts = []
    for tag in tags:
        path = dataset_path_from_tag(tag)
        ds = Dataset.load(path)
        # tag becomes the subdataset name unless the manifest already set one
        if len(set(ds.ds_names)) == 1 and ds.ds_names and (
                ds.ds_names[0] in ('dataset', '')):
            ds.ds_names = [Path(str(tag)).name] * len(ds)
        parts.append(ds)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def resolve_splitpath(splitpath) -> Path:
    """A splitpath may be a json file or a dataset tag whose directory
    holds a split json (reference get_dataloaders.py:91-99). Candidate
    jsons must hold a train/val/test partition, so an unrelated json in
    the tag directory (a dataset manifest) is never taken for a split."""
    def _is_split(path: Path) -> bool:
        try:
            d = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return False
        return isinstance(d, dict) and any(
            k in d for k in ('train', 'val', 'test'))

    path = Path(splitpath)
    if path.exists():
        return path
    tag_path = Path(dataset_path_from_tag(str(splitpath)))
    candidates = [tag_path / 'split.json', tag_path / 'espaloma_split.json']
    candidates += sorted(tag_path.glob('*.json'))
    for cand in candidates:
        if cand.exists() and _is_split(cand):
            return cand
    raise FileNotFoundError(
        f"splitpath {splitpath!r} is neither a file nor a tag directory "
        f"containing a split json with train/val/test keys ({tag_path})")


def _train_val_loaders(tr: Dataset, vl: Dataset, cfg: Dict, device
                       ) -> Tuple[GraphLoader, Optional[GraphLoader]]:
    train_loader = GraphLoader(
        tr, batch_size=cfg.get('train_batch_size', 32),
        conf_strategy=cfg.get('conf_strategy', 32), shuffle=True,
        weights=cfg.get('weights', {}),
        balance_factor=cfg.get('balance_factor', 0.0),
        seed=cfg.get('seed', 0), drop_last=True, device=device)
    val_loader = GraphLoader(
        vl, batch_size=cfg.get('val_batch_size', 32),
        conf_strategy=cfg.get('val_conf_strategy', 500), shuffle=False,
        device=device) if len(vl) else None
    return train_loader, val_loader


def get_dataloaders(data_config: Dict, run_dir: Optional[Path] = None,
                    device=None
                    ) -> Tuple[GraphLoader, GraphLoader, GraphLoader, Dict]:
    """Build train/val/test loaders according to the data config."""
    cfg = data_config
    ds = load_datasets(cfg['datasets']) if cfg['datasets'] else Dataset([], [])
    if len(ds):
        ds.remove_uncommon_features()

    # split by molecule ids
    ids_by_ds = {}
    for e, name in zip(ds.entries, ds.ds_names):
        ids_by_ds.setdefault(name, []).append(e.mol_id)
    existing = None
    if cfg.get('splitpath'):
        # a stored split assigns its ids; molecules it does not cover are
        # split by the usual per-dataset partition (reference
        # get_dataloaders.py:100-103)
        existing = load_split(resolve_splitpath(cfg['splitpath']))
    split = calc_split_ids(ids_by_ds, tuple(cfg.get('partition',
                                                    (0.8, 0.1, 0.1))),
                           seed=cfg.get('seed', 0),
                           existing_split=existing)
    if run_dir is not None:
        save_split(split, Path(run_dir) / 'split.json')

    tr, vl, te = ds.split(split['train'], split['val'], split['test'])

    # pure datasets bypass the mol-id split entirely
    for key, target in (('pure_train_datasets', 'tr'),
                        ('pure_val_datasets', 'vl'),
                        ('pure_test_datasets', 'te')):
        for tag in cfg.get(key, []) or []:
            try:
                extra = load_datasets([tag])
            except (FileNotFoundError, RuntimeError, KeyError) as exc:
                # pure datasets are auxiliary; missing ones are skipped
                # LOUDLY
                print(f"skipping pure dataset {tag!r}: {exc}")
                continue
            extra.remove_uncommon_features()
            if target == 'tr':
                tr = tr + extra
            elif target == 'vl':
                vl = vl + extra
            else:
                te = te + extra

    if cfg.get('tr_subsampling_factor') is not None:
        tr = tr.subsampled(cfg['tr_subsampling_factor'],
                           seed=cfg.get('seed', 0))

    train_loader, val_loader = _train_val_loaders(tr, vl, cfg, device)
    # fixed_pad: one padded shape for the whole test pass (padding is
    # metric-neutral: masked reductions)
    test_loader = GraphLoader(
        te, batch_size=cfg.get('test_batch_size', 1),
        conf_strategy='max', shuffle=False,
        fixed_pad=True, device=device) if len(te) else None
    return train_loader, val_loader, test_loader, split


def _phase(msg: str) -> None:
    """Timestamped startup-phase print, so a slow start can be located."""
    import datetime
    print(f"[{datetime.datetime.now(datetime.timezone.utc):%H:%M:%S}] {msg}",
          flush=True)


def do_trainrun(config: Dict, project_dir: str = 'runs',
                run_name: Optional[str] = None,
                dataset_override: Optional[Dataset] = None,
                cache_batches: bool = False,
                pretrain_path: Optional[str] = None,
                device=None, mesh=None) -> Dict:
    """Train a model as `config` says, into <project_dir>/<run_name>.

    pretrain_path: model file (.npz/.pth model_dict) whose weights AND
    scaler-statistic buffers initialize the model; start_qm_epochs is forced
    to 0 (reference trainrun.py:118-136).

    device: where the model, the batches and the kernels run (CUDA unless
    the caller asks for another). mesh: data-parallel training over the
    mesh's ranks on its device (module doc)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    validate_config(config)
    run_name = run_name or config['trainer_config'].get('name') or 'run'
    run_dir = Path(project_dir) / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    if writer:
        write_yaml(config, run_dir / 'grappa_config.yaml')
    dcfg = config['data_config']

    if dataset_override is not None:
        ds = dataset_override
        ids_by_ds = {}
        for e, name in zip(ds.entries, ds.ds_names):
            ids_by_ds.setdefault(name, []).append(e.mol_id)
        split = calc_split_ids(
            ids_by_ds, tuple(dcfg.get('partition', (0.8, 0.1, 0.1))),
            seed=dcfg.get('seed', 0))
        if writer:
            save_split(split, run_dir / 'split.json')
        tr, vl, _ = ds.split(split['train'], split['val'], split['test'])
        train_loader, val_loader = _train_val_loaders(tr, vl, dcfg, device)
        test_loader = None
    else:
        _phase(f"{run_name}: loading datasets")
        train_loader, val_loader, test_loader, split = get_dataloaders(
            dcfg, run_dir if writer else None, device)

    # scaler statistics from the train set (full pass, like the reference)
    _phase(f"{run_name}: computing parameter statistics")
    stats = param_statistics_from_graphs(train_loader.dataset.graphs())
    if writer:
        (run_dir / 'param_statistics.json').write_text(json.dumps(
            {m: {k: np.asarray(v).tolist() for k, v in stats[m].items()}
             for m in ('mean', 'std')}))
    seed = dcfg.get('seed', 0)
    model = make_model(config['model_config'], stats,
                       generator=torch.Generator().manual_seed(seed))

    if pretrain_path is not None:
        d = load_model_dict(pretrain_path)
        # weights AND the scaler buffers come from the file, through the
        # import's audit (buffers required, as in the JAX package)
        sd, _ = import_state_dict(d['state_dict'] if 'state_dict' in d
                                  else d, config['model_config'])
        own = model.state_dict()
        for k, v in sd.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"pretrain shape mismatch for {k}: "
                                 f"{tuple(v.shape)} vs "
                                 f"{tuple(own[k].shape)}")
        load_imported(model, sd)
        config['lit_model_config']['start_qm_epochs'] = 0
    model = model.to(device)

    # one batch, drawn as the JAX package draws its init batch (the same
    # loader RNG stream), for the smoke test
    batch, _ = next(iter(train_loader))
    if config.get('test_model'):
        energy, gradient = make_eval_step(model)(batch)
        if not bool(torch.isfinite(energy).all()):
            raise RuntimeError("model smoke test: non-finite energies")
        if not bool(torch.isfinite(gradient).all()):
            raise RuntimeError("model smoke test: non-finite gradients")
    del batch

    logger = MetricLogger(run_dir, name=run_name) if writer else None
    trainer = Trainer(model, train_loader, val_loader,
                      config['lit_model_config'], config['trainer_config'],
                      out_dir=str(run_dir), full_config=config,
                      log_fn=logger.log if logger else None, seed=seed,
                      cache_batches=cache_batches, mesh=mesh)
    try:
        _phase(f"{run_name}: entering fit")
        results = trainer.fit()
    finally:
        if logger:
            logger.finish()

    return _finalize_run(trainer, config, split, test_loader, run_dir,
                         results)


def _finalize_run(trainer: Trainer, config, split, test_loader, run_dir,
                  results) -> Dict:
    """Post-fit tail shared by do_trainrun and resume_trainrun: bootstrap
    test evaluation (if a test loader exists) + model_dict export.

    Evaluates/exports the BEST checkpoint (lowest early-stopping loss), like
    the reference, which exports best-model.ckpt (reference
    export_model.py:30); a copy of the model holds it, and the trainer's
    model keeps the last weights. An unusable best.ckpt falls back to the
    last weights."""
    run_dir = Path(run_dir)
    eval_model = trainer.model
    best = run_dir / 'best.ckpt'
    if best.exists():
        try:
            _verify_checkpoint(best)
            state = torch.load(best / 'params.pt', map_location=trainer.device,
                               weights_only=True)
            eval_model = copy.deepcopy(trainer.model)
            eval_model.load_state_dict(state)
            _phase(f"{run_dir.name}: evaluating best.ckpt params")
        except (OSError, RuntimeError, pickle.UnpicklingError) as exc:
            print(f"best.ckpt unusable ({exc}); evaluating last params")
            eval_model = trainer.model
    final_metrics = (results.get('history', [])[-1]['metrics']
                     if results.get('history') else {})
    test_eval_s = None
    if test_loader is not None:
        _phase(f"{run_dir.name}: bootstrap test evaluation")
        t0 = time.perf_counter()
        evaluator = BootstrapEvaluator()
        eval_step = make_eval_step(eval_model)
        for batch, names in test_loader:
            energy, gradient = eval_step(batch)
            evaluator.step(batch, energy, gradient, names)
        final_metrics = {'val': final_metrics,
                         'test': evaluator.pool(n_bootstrap=200)}
        test_eval_s = time.perf_counter() - t0
        _phase(f"{run_dir.name}: test evaluation done")

    model_dict = build_model_dict(eval_model, config, split_names=split,
                                  results=final_metrics)
    export_path = run_dir / 'model.npz'
    if trainer.mesh is None or trainer.mesh.rank == 0:
        save_model_dict(model_dict, export_path)
    if trainer.mesh is not None:
        trainer.mesh.barrier()
    return {'model_dict_path': str(export_path), 'results': results,
            'run_dir': str(run_dir), 'trainer': trainer,
            'test_eval_s': test_eval_s}


def resume_trainrun(run_dir: str, extra_epochs: Optional[int] = None,
                    cache_batches: bool = False, device=None,
                    mesh=None) -> Dict:
    """Continue a run from <run_dir>/last.ckpt with the stored config.

    Like do_trainrun, finishes with the bootstrap test evaluation and
    model.npz export, so a run that completes via resume produces the same
    artifacts as an uninterrupted one. mesh: data-parallel, as
    do_trainrun's (every rank loads the checkpoint)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    run_dir = Path(run_dir)
    config = read_yaml(run_dir / 'grappa_config.yaml')
    if not config['data_config'].get('datasets'):
        raise ValueError(
            f"the stored config of {run_dir} lists no datasets — the run was "
            f"trained with a dataset_override, which is not persisted; "
            f"resume such runs by calling Trainer.load_checkpoint directly "
            f"with the original dataset")

    # pin the resume to the split the original run actually used: the run
    # dir's split.json is the fully-resolved assignment; molecules it does
    # not cover (newly added data) still get extended deterministically
    if (run_dir / 'split.json').exists():
        config['data_config']['splitpath'] = str(run_dir / 'split.json')
    _phase(f"resume {run_dir.name}: loading datasets")
    if mesh is not None and not writer:
        mesh.barrier()     # rank 0 rewrites split.json first
    train_loader, val_loader, test_loader, split = get_dataloaders(
        config['data_config'], run_dir if writer else None, device)
    if mesh is not None and writer:
        mesh.barrier()
    stats = param_statistics_from_graphs(train_loader.dataset.graphs())
    # weights and buffers are overwritten by the checkpoint
    model = make_model(config['model_config'], stats).to(device)
    next(iter(train_loader))   # the JAX package's init batch draw

    logger = MetricLogger(run_dir) if writer else None
    trainer = Trainer(model, train_loader, val_loader,
                      config['lit_model_config'], config['trainer_config'],
                      out_dir=str(run_dir), full_config=config,
                      log_fn=logger.log if logger else None,
                      cache_batches=cache_batches, mesh=mesh)
    trainer.load_checkpoint(run_dir / 'last.ckpt')
    max_epochs = (trainer.epoch + extra_epochs if extra_epochs is not None
                  else config['trainer_config'].get('max_epochs'))
    try:
        _phase(f"resume {run_dir.name}: entering fit at epoch "
               f"{trainer.epoch}")
        results = trainer.fit(max_epochs=max_epochs)
    finally:
        if logger:
            logger.finish()
    return _finalize_run(trainer, config, split, test_loader, run_dir,
                         results)


def safe_trainrun(config: Dict, project_dir: str = 'runs',
                  run_name: Optional[str] = None, **kwargs) -> Dict:
    """do_trainrun with one automatic resume-from-last-checkpoint retry.

    The retry keeps the run's execution mode (cache_batches, device,
    mesh), and runs started with a dataset_override cannot be resumed (the
    datasets are not persisted), so the original error is re-raised
    instead."""
    try:
        return do_trainrun(config, project_dir, run_name, **kwargs)
    except Exception:
        traceback.print_exc()
        if kwargs.get('dataset_override') is not None:
            raise
        run_name = run_name or config['trainer_config'].get('name') or 'run'
        run_dir = Path(project_dir) / run_name
        if (run_dir / 'last.ckpt').exists():
            print(f"training failed; retrying once from {run_dir}/last.ckpt")
            return resume_trainrun(
                str(run_dir),
                cache_batches=kwargs.get('cache_batches', False),
                device=kwargs.get('device'), mesh=kwargs.get('mesh'))
        raise
