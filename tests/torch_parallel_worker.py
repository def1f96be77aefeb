"""The ranks of tests/test_torch_port_parallel.py: every case of the port's
parallel layer (grappa_tpu_torch.parallel, Trainer(mesh=...), atom-sharded
MD) run by W gloo ranks on the CPU, rank 0 writing the results to an npz
file that the test compares with the JAX package's.

Imports nothing of JAX or grappa_tpu: the ranks are spawned processes,
and the JAX references are computed in the test's own process. The inputs
(the small model's weights, made by JAX's init and carried over by
state_dict_from_flax; the conformer-sharded case's predicted parameters;
the MD case's velocities) come from `inputs.pt` in the work directory. The
molecules are the port's make_moldata / make_dataset of the test's seeds
(equal to the JAX package's bit for bit).
"""
from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch

# the cases' sizes and seeds, shared with the test
DATA_SEED, DATA_MOLS, DATA_CONFS, BATCH = 9, 10, 4, 2
TRAIN_LIT = {'lr': 3e-4, 'start_qm_epochs': 0, 'warmup_steps': 2,
             'patience': 0}
SP_SEED, SP_ATOMS, SP_CONFS = 5, 600, 4
MD_SEED, MD_ATOMS, MD_CONFS, MD_STEPS, MD_DT = 6, 400, 2, 10, 0.5
CONF_SEED, CONF_CONFS = 77, 8
LR = 1e-3
DROPOUT = {'gnn_dropout_attention': 0.3, 'gnn_dropout_final': 0.1,
           'parameter_dropout': 0.5}
REF_FIELDS = (('n2_k', 'n2', 'k_ref'), ('n2_eq', 'n2', 'eq_ref'),
              ('n3_k', 'n3', 'k_ref'), ('n3_eq', 'n3', 'eq_ref'),
              ('n4_k', 'n4', 'k_ref'),
              ('n4_improper_k', 'n4_improper', 'k_ref'))


def qm_weights(m: int):
    """test_parallel.py's loss weights, as the port's LossWeights."""
    from grappa_tpu_torch.train.loss import LossWeights
    return LossWeights(1.0, 0.8, torch.full((m,), 1e-3), 1e-3, 1e-3)


def train_loader(fixed_pad: bool = True):
    """DATA_MOLS molecules in batches of BATCH (5 batches), the order the
    JAX package's loader of the same seed draws."""
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.loader import GraphLoader
    from grappa_tpu_torch.data.synthetic import make_dataset
    ds = Dataset.from_moldata(make_dataset(n_mols=DATA_MOLS,
                                           n_confs=DATA_CONFS,
                                           seed=DATA_SEED), 'syn')
    return GraphLoader(ds, batch_size=BATCH, conf_strategy=DATA_CONFS,
                       shuffle=True, drop_last=True, seed=0,
                       fixed_pad=fixed_pad, device='cpu')


class _Capture:
    """AdamClip that keeps the gradients (the ranks' mean) of its step."""

    def __init__(self, opt):
        self.opt, self.seen = opt, None

    def step(self, params, grads, lr):
        self.seen = [g.clone() for g in grads]
        self.opt.step(params, grads, lr)

    def __getattr__(self, name):
        return getattr(self.opt, name)


def _model(inputs, cfg=None):
    from grappa_tpu_torch.models.grappa_model import make_model
    model = make_model(cfg or inputs['cfg'])
    model.load_state_dict(inputs['state_dict'], strict=True)
    return model


def _dp_cases(inputs, mesh, out):
    from grappa_tpu_torch.parallel import dp
    from grappa_tpu_torch.train.trainer import (Trainer, make_optimizer,
                                                make_train_step)
    w = mesh.size
    batches = [b for b, _ in train_loader()]

    # the DP step: rank r trains on batch r; the ranks' mean gradients
    model = _model(inputs)
    opt = _Capture(make_optimizer())
    step = dp.make_dp_train_step(model, opt, mesh)
    loss, aux = step(batches[mesh.rank], qm_weights(batches[0].num_mols),
                     LR, torch.Generator().manual_seed(0))
    out['dp/loss'] = float(loss)
    for k, v in aux.items():
        out[f'dp/aux/{k}'] = v.numpy()
    names = [n for n, _ in model.named_parameters()]
    for n, g in zip(names, opt.seen):
        out[f'dp/grad/{n}'] = g.numpy()
    for n, p in model.named_parameters():
        out[f'dp/new/{n}'] = p.detach().numpy().copy()

    # remainder padding: [batch 0 x W scale, zero-weight replicas] against
    # one process's step on batch 0
    model = _model(inputs)
    step = dp.make_dp_train_step(model, make_optimizer(), mesh)
    wts = qm_weights(batches[0].num_mols)
    scale = float(np.float32(w)) if mesh.rank == 0 else 0.0
    wts = type(wts)(*(torch.as_tensor(x, dtype=torch.float32) * scale
                      for x in wts))
    loss, _ = step(batches[0], wts, LR, torch.Generator().manual_seed(0))
    single = _model(inputs)
    ref_loss, _ = make_train_step(single, make_optimizer())(
        batches[0], qm_weights(batches[0].num_mols), LR,
        torch.Generator().manual_seed(0))
    out['pad/loss'], out['pad/ref_loss'] = float(loss), float(ref_loss)
    out['pad/max_dev'] = max(
        float((a.detach() - b.detach()).abs().max())
        for a, b in zip(model.parameters(), single.parameters()))

    # the Trainer's DP epoch (5 batches: a trailing group); the rank
    # collates only the batches it trains on
    model = _model(inputs)
    loader = train_loader()
    collated = []
    make_batch = loader._make_batch
    loader._make_batch = lambda idxs: (collated.append(1),
                                       make_batch(idxs))[1]
    trainer = Trainer(model, loader, None, dict(TRAIN_LIT),
                      {'max_epochs': 1}, out_dir=None, mesh=mesh)
    out['trainer/mean_loss'] = trainer.train_epoch()
    out['trainer/losses'] = np.asarray(trainer.train_losses[0])
    out['trainer/global_step'] = trainer.global_step
    out['trainer/collated'] = mesh.all_gather(
        torch.tensor([len(collated)])).numpy()

    # the cached DP epoch against looped DP steps, identity permutation:
    # each rank stacks the slots it trains on, one a group
    n_real = len(batches)
    n_groups = -(-n_real // w)
    lrs = [1e-3, 5e-4, 2e-4][:n_groups] + [2e-4] * max(0, n_groups - 3)
    base = [qm_weights(b.num_mols) for b in batches]
    looped = _model(inputs)
    lstep = dp.make_dp_train_step(looped, make_optimizer(), mesh)
    gen = torch.Generator().manual_seed(1)
    losses_ref, mine_all, scale = [], [], np.ones(n_groups, np.float32)
    for g in range(n_groups):
        grp = list(range(g * w, min((g + 1) * w, n_real)))
        kk = len(grp)
        mine = grp[mesh.rank] if mesh.rank < kk else grp[(mesh.rank - kk)
                                                         % kk]
        scale[g] = (1.0 if kk == w else w / kk if mesh.rank < kk else 0.0)
        wts = type(base[0])(*(torch.as_tensor(x, dtype=torch.float32)
                              * float(scale[g]) for x in base[mine]))
        loss, _ = lstep(batches[mine], wts, lrs[g], gen)
        losses_ref.append(float(loss))
        mine_all.append(mine)
    scanned = _model(inputs)
    epoch = dp.make_dp_scan_epoch_step(scanned, make_optimizer(), mesh)
    losses = epoch(dp.shard_batches([batches[i] for i in mine_all]),
                   dp.stack_loss_weights([base[i] for i in mine_all]),
                   torch.from_numpy(scale), np.arange(n_groups), lrs,
                   torch.Generator().manual_seed(1))
    out['scan/losses'], out['scan/losses_ref'] = (losses.numpy(),
                                                  np.asarray(losses_ref))
    out['scan/max_dev'] = max(
        float((a.detach() - b.detach()).abs().max())
        for a, b in zip(scanned.parameters(), looped.parameters()))

    # the cached Trainer epoch restacks the curriculum's weights each epoch
    model = _model(inputs)
    trainer = Trainer(model, train_loader(), None,
                      {'lr': 3e-4, 'start_qm_epochs': 1, 'warmup_steps': 1,
                       'energy_weight': 1.0}, {'max_epochs': 2},
                      out_dir=None, mesh=mesh, cache_batches=True,
                      scan_epochs=True)
    seen = []
    orig = trainer.dp_scan_step

    def spy(b, wts, scale, perm, lrs, gen):
        seen.append(wts.energy.numpy().copy())
        return orig(b, wts, scale, perm, lrs, gen)

    trainer.dp_scan_step = spy
    trainer.fit()
    out['curriculum/energy'] = np.stack(seen)
    ragged = Trainer(_model(inputs), train_loader(fixed_pad=False), None,
                     {'lr': 3e-4, 'start_qm_epochs': 0, 'warmup_steps': 1},
                     {'max_epochs': 1}, out_dir=None, mesh=mesh,
                     cache_batches=True, scan_epochs=True)
    try:
        ragged.train_epoch()
        out['curriculum/ragged'] = 'no error'
    except ValueError as exc:
        out['curriculum/ragged'] = str(exc)

    # the cached Trainer: looped and scanned epochs over the rank's own
    # cached slots, the same shuffles, for 2 epochs
    cached = {}
    for scan in (False, True):
        model = _model(inputs)
        trainer = Trainer(model, train_loader(), None,
                          {'lr': 3e-4, 'start_qm_epochs': 0,
                           'warmup_steps': 1}, {'max_epochs': 2},
                          out_dir=None, mesh=mesh, cache_batches=True,
                          scan_epochs=scan)
        trainer.fit()
        cached[scan] = model
        out[f'cached/losses_{int(scan)}'] = np.asarray(trainer.train_losses)
    out['cached/max_dev'] = max(
        float((a.detach() - b.detach()).abs().max())
        for a, b in zip(cached[False].parameters(),
                        cached[True].parameters()))

    # DP eval: each rank's batch, all-gathered
    energy, gradient = dp.make_dp_eval_step(_model(inputs), mesh)(
        batches[mesh.rank])
    out['eval/energy'], out['eval/gradient'] = (energy.numpy(),
                                                gradient.numpy())

    # the conformer-sharded energy of JAX's predicted parameters
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.synthetic import make_moldata
    graph = MolGraph.from_moldata(make_moldata(seed=CONF_SEED,
                                               n_confs=CONF_CONFS))
    pred = {k: torch.from_numpy(v) for k, v in inputs['conf_pred'].items()}
    fn = dp.make_conf_sharded_energy_fn(mesh)
    energy, gradient = fn(collate([graph], n_confs=CONF_CONFS,
                                  device='cpu'), pred)
    out['conf/energy'], out['conf/gradient'] = (energy.numpy(),
                                                gradient.numpy())
    try:
        fn(collate([graph], n_confs=w + 1, device='cpu'), pred)
        out['conf/odd'] = 'no error'
    except ValueError as exc:
        out['conf/odd'] = str(exc)

    try:
        dp.make_mesh(w + 1, device='cpu')
        out['mesh/too_few'] = 'no error'
    except ValueError as exc:
        out['mesh/too_few'] = str(exc)


def _sp_cases(inputs, mesh, out):
    from grappa_tpu_torch import md
    from grappa_tpu_torch.data.graph_batch import (MolGraph, PadSpec,
                                                   collate)
    from grappa_tpu_torch.data.synthetic import make_moldata
    from grappa_tpu_torch.parallel import sp
    from grappa_tpu_torch.train.trainer import make_optimizer

    g = MolGraph.from_moldata(make_moldata(seed=SP_SEED, n_confs=SP_CONFS,
                                           n_atoms=SP_ATOMS))
    pad = sp.atom_sharded_pad_spec([g], SP_CONFS, mesh)
    batch = collate([g], pad=pad, device='cpu')
    sharded = sp.shard_batch_by_atoms(batch, mesh)
    energy, gradient = sp.make_atom_sharded_forward(_model(inputs), mesh)(
        sharded)
    out['sp/energy'] = energy.numpy()
    out['sp/gradient'] = mesh.all_gather(gradient).numpy()
    odd = PadSpec(n_nodes=pad.n_nodes + 1, n_tuples=pad.n_tuples,
                  n_confs=SP_CONFS)
    try:
        sp.shard_batch_by_atoms(collate([g], pad=odd, device='cpu'), mesh)
        out['sp/odd'] = 'no error'
    except ValueError as exc:
        out['sp/odd'] = str(exc)

    # the train step on the sharded batch against JAX's on the whole one:
    # the all-reduced gradients AdamClip is given, and the update
    model = _model(inputs)
    opt = _Capture(make_optimizer())
    step = sp.make_atom_sharded_train_step(model, opt, mesh)
    loss, aux = step(sharded, qm_weights(1), LR,
                     torch.Generator().manual_seed(0))
    out['sp_step/loss'] = float(loss)
    out['sp_step/gradient_mse'] = aux['gradient_mse'].numpy()
    for (n, p), g in zip(model.named_parameters(), opt.seen):
        out[f'sp_step/grad/{n}'] = g.numpy()
        out[f'sp_step/new/{n}'] = p.detach().numpy().copy()

    # dropout on: the sharded training-mode forward equals the unsharded
    # one with the same generator (its masks are the unsharded masks'
    # slices), eager and fused (the fused ops' plain versions)
    for fused in (False, True):
        cfg = dict(inputs['cfg'], fused_gnn=fused, fused_heads=fused,
                   **DROPOUT)
        model = _model(inputs, cfg).train()
        with torch.no_grad():
            want = model(batch, torch.Generator().manual_seed(3))
            got = model(sharded, torch.Generator().manual_seed(3))
        tag = 'fused' if fused else 'eager'
        for k, v in got.items():
            full = mesh.all_gather(v)
            out[f'sp_dropout/{tag}/{k}'] = float(
                (full - want[k]).abs().max() / want[k].abs().max()
                .clamp_min(1e-30))

    # atom-sharded NVE with the reference parameters
    mdata = make_moldata(seed=MD_SEED, n_confs=MD_CONFS, n_atoms=MD_ATOMS,
                         learnable=True, conf_noise=0.05)
    gm = MolGraph.from_moldata(mdata)
    mbatch = collate([gm], pad=sp.atom_sharded_pad_spec([gm], MD_CONFS,
                                                        mesh), device='cpu')
    msharded = sp.shard_batch_by_atoms(mbatch, mesh)
    params = {key: torch.nan_to_num(getattr(msharded.terms[t], f))
              for key, t, f in REF_FIELDS}
    masses = md.masses_from_molecules([mdata.molecule],
                                      mbatch.xyz.shape[0], device='cpu')
    res = md.simulate(msharded, params, masses, dt_fs=MD_DT,
                      n_steps=MD_STEPS, v0=torch.from_numpy(inputs['md_v0']))
    out['md/potential'] = res['potential'].numpy()
    out['md/xyz'] = mesh.all_gather(res['xyz']).numpy()
    # BAOAB: the whole noise array drawn, the rank's rows kept, so the
    # sharded run is the unsharded one
    params_full = {key: torch.nan_to_num(getattr(mbatch.terms[t], f))
                   for key, t, f in REF_FIELDS}
    lang = md.simulate(msharded, params, masses, dt_fs=MD_DT, n_steps=5,
                       temperature=300.0, seed=4)
    lang_ref = md.simulate(mbatch, params_full, masses, dt_fs=MD_DT,
                           n_steps=5, temperature=300.0, seed=4)
    out['md/langevin_dev'] = float(
        (mesh.all_gather(lang['xyz']) - lang_ref['xyz']).abs().max())
    out['md/langevin_kinetic_dev'] = float(
        ((lang['kinetic'] - lang_ref['kinetic']).abs()
         / lang_ref['kinetic'].abs()).max())


def _run_cases(inputs, mesh, out, workdir):
    """do_trainrun(mesh=...) and resume_trainrun(mesh=...) on a dataset
    directory rank 0 writes: rank 0 alone writes the run's files, every
    rank ends with the same parameters."""
    import json
    from pathlib import Path

    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.synthetic import make_dataset
    from grappa_tpu_torch.train import config as tconfig
    from grappa_tpu_torch.train.run import do_trainrun, resume_trainrun
    ds_dir = Path(workdir) / f'ds_w{mesh.size}'
    if mesh.rank == 0:
        Dataset.from_moldata(make_dataset(n_mols=12, n_confs=4, seed=3),
                             'syn').save(ds_dir)
    mesh.barrier()
    config = tconfig.default_config()
    tconfig.overwrite_config({
        'model_config': inputs['cfg'],
        'data_config': {
            'datasets': [str(ds_dir)], 'conf_strategy': 4,
            'val_conf_strategy': 4, 'train_batch_size': 2,
            'val_batch_size': 4, 'partition': [0.6, 0.2, 0.2],
            'pure_train_datasets': [], 'pure_val_datasets': [],
            'weights': {}, 'seed': 3},
        'lit_model_config': {'lr': 2e-4, 'start_qm_epochs': 1,
                             'warmup_steps': 2},
        'trainer_config': {'max_epochs': 2, 'checkpoint_every': 1,
                           'name': 'run'},
        'test_model': True}, config)
    project = Path(workdir) / f'runs_w{mesh.size}'
    res = do_trainrun(config, project_dir=str(project), mesh=mesh)
    first = res['trainer']
    res2 = resume_trainrun(res['run_dir'], extra_epochs=1, mesh=mesh)
    trainer = res2['trainer']
    sums = torch.stack([p.detach().double().sum()
                        for p in trainer.model.parameters()])
    every = mesh.all_gather(sums[None])
    out['run/epochs'] = np.asarray([first.epoch, trainer.epoch])
    out['run/steps'] = np.asarray([first.global_step, trainer.global_step])
    out['run/ranks_equal'] = bool((every == every[0]).all())
    out['run/writer_dirs'] = np.asarray(
        mesh.all_gather(torch.tensor([[int(trainer.out_dir is not None)]]))
        .reshape(-1).numpy())
    run_dir = Path(res2['run_dir'])
    out['run/files'] = np.asarray(sorted(p.name for p in run_dir.iterdir()))
    lines = (run_dir / 'metrics.jsonl').read_text().splitlines()
    out['run/train_entries'] = np.asarray(
        [json.loads(x)['epoch'] for x in lines
         if 'train_loss' in json.loads(x)])


def main(rank: int, world: int, workdir: str, cases: str) -> None:
    torch.set_num_threads(1)
    from grappa_tpu_torch.parallel import dp
    mesh = dp.make_mesh(world, device='cpu',
                        init_method=f'file://{workdir}/store_{world}',
                        rank=rank, world_size=world, timeout_s=90)
    inputs = torch.load(os.path.join(workdir, 'inputs.pt'),
                        weights_only=False)
    out = {}
    try:
        if 'dp' in cases:
            _dp_cases(inputs, mesh, out)
        if 'sp' in cases:
            _sp_cases(inputs, mesh, out)
        if 'run' in cases:
            _run_cases(inputs, mesh, out, workdir)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    if rank == 0:
        np.savez(os.path.join(workdir, f'out_w{world}.npz'),
                 **{k: np.asarray(v) for k, v in out.items()})
    import torch.distributed as dist
    dist.destroy_process_group()
