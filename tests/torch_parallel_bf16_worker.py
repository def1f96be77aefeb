"""The ranks of tests/test_torch_port_parallel_bf16.py: the port's
multi-device layer with a bfloat16 model (the small config with
compute_dtype='bfloat16'), run by W gloo ranks on the CPU, rank 0 writing
the results to an npz file that the test compares with the JAX package's
and with the port's own one-process bf16 path.

Every case runs the eager modules ('auto' on the CPU, as JAX's make_model
picks them there) and, where a case says so, the fused ops' plain versions
(the card's path: K1 / K1b, K2 / K2b, K3 / K3b and K5 / K5b in their plain
PyTorch form). Rank 0 also computes the one-process references: the same
model and batches without a mesh, in bf16 and in float32 (the float32
results give the bf16 effect the test's rule measures against).

Imports nothing of JAX or grappa_tpu. The inputs (the small model's
weights from JAX's init with seeded noise, carried over by
state_dict_from_flax) come from `inputs.pt` in the work directory; the
molecules are the port's make_moldata / make_dataset of the seeds below.
"""
from __future__ import annotations

import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

import torch_parallel_worker as wk

BF16_CFG = {'compute_dtype': 'bfloat16'}
SP_SEED, SP_ATOMS, SP_CONFS = 5, 320, 4
TORSION_SEED, TORSION_ATOMS, TORSION_CONFS = 6, 400, 2


def _model(inputs, fused=False, dtype='bfloat16', **extra):
    from grappa_tpu_torch.models.grappa_model import make_model
    cfg = dict(inputs['cfg'], compute_dtype=dtype, fused_gnn=fused,
               fused_heads=fused, **extra)
    model = make_model(cfg)
    model.load_state_dict(inputs['state_dict'], strict=True)
    return model


def _dtypes(out, key):
    """The (collective, dtype) pairs this rank ran since the last call, as
    'collective:dtype' strings under key."""
    from grappa_tpu_torch.parallel import dp
    out[f'{key}/collectives'] = np.asarray(sorted(
        f'{op}:{dt}' for op, dt in dp.COLLECTIVE_DTYPES))
    dp.COLLECTIVE_DTYPES.clear()


def _grads(out, key, names, grads):
    for n, g in zip(names, grads):
        out[f'{key}/{n}'] = g.detach().numpy().copy()


def _dp_cases(inputs, mesh, out):
    """The bf16 DP step (eager and fused) on batch `rank`; rank 0: the
    one-process bf16 mean of the two batches' gradients, and the float32
    one."""
    from grappa_tpu_torch.parallel import dp
    from grappa_tpu_torch.train.trainer import loss_gradients, make_optimizer
    batches = [b for b, _ in wk.train_loader()]
    wts = wk.qm_weights(batches[0].num_mols)
    dp.COLLECTIVE_DTYPES.clear()
    for fused in (False, True):
        tag = 'fused' if fused else 'eager'
        model = _model(inputs, fused)
        names = [n for n, _ in model.named_parameters()]
        opt = wk._Capture(make_optimizer())
        step = dp.make_dp_train_step(model, opt, mesh)
        loss, aux = step(batches[mesh.rank], wts, wk.LR,
                         torch.Generator().manual_seed(0))
        _dtypes(out, f'dp/{tag}')
        out[f'dp/{tag}/loss'] = float(loss)
        for k, v in aux.items():
            out[f'dp/{tag}/aux/{k}'] = v.numpy()
        _grads(out, f'dp/{tag}/grad', names, opt.seen)
        if mesh.rank != 0:
            continue
        # float32: the bf16 effect of the JAX comparison (fused only)
        for dtype in ('bfloat16', 'float32') if fused else ('bfloat16',):
            losses, mean = [], None
            for b in batches[:mesh.size]:
                loss, _, g = loss_gradients(_model(inputs, fused, dtype), b,
                                            wts)
                losses.append(float(loss))
                g = list(g.values())
                mean = g if mean is None else [x + y for x, y in zip(mean, g)]
            out[f'dp/{tag}/one/{dtype}/loss'] = float(np.mean(losses))
            _grads(out, f'dp/{tag}/one/{dtype}/grad', names,
                   [g / mesh.size for g in mean])


def _trainer_cases(inputs, mesh, out):
    """A bf16 Trainer(mesh=...) epoch of 5 batches (a trailing group);
    rank 0: the same groups in one process (each rank's batch, the
    trailing group's weights scaled by W / k and its padding's by 0, the
    mean gradient, AdamClip at the warmup's learning rates)."""
    from grappa_tpu_torch.train.loss import LossWeights
    from grappa_tpu_torch.train.trainer import (Trainer, loss_gradients,
                                                make_optimizer)
    model = _model(inputs)
    loader = wk.train_loader()
    collated = []
    make_batch = loader._make_batch
    loader._make_batch = lambda idxs: (collated.append(1),
                                       make_batch(idxs))[1]
    trainer = Trainer(model, loader, None, dict(wk.TRAIN_LIT),
                      {'max_epochs': 1}, out_dir=None, mesh=mesh)
    out['trainer/mean_loss'] = trainer.train_epoch()
    out['trainer/losses'] = np.asarray(trainer.train_losses[0])
    out['trainer/global_step'] = trainer.global_step
    out['trainer/collated'] = mesh.all_gather(
        torch.tensor([len(collated)])).numpy()
    sums = torch.stack([p.detach().double().sum()
                        for p in model.parameters()])
    every = mesh.all_gather(sums[None])
    out['trainer/ranks_equal'] = bool((every == every[0]).all())
    if mesh.rank != 0:
        return
    w = mesh.size
    batches = [b for b, _ in wk.train_loader()]
    ref = _model(inputs)
    params = dict(ref.named_parameters())
    opt, losses = make_optimizer(), []
    for g, first in enumerate(range(0, len(batches), w)):
        grp = list(range(first, min(first + w, len(batches))))
        k = len(grp)
        vals, mean = [], None
        for r in range(w):
            b = batches[grp[r] if r < k else grp[(r - k) % k]]
            scale = 1.0 if k == w else (w / k if r < k else 0.0)
            wts = LossWeights(
                *(torch.as_tensor(x, dtype=torch.float32) * scale
                  for x in (1.0, 0.8, torch.full((b.num_mols,), 1e-3),
                            0.0, 0.0)))
            loss, _, gr = loss_gradients(ref, b, wts)
            vals.append(float(loss))
            gr = list(gr.values())
            mean = gr if mean is None else [x + y for x, y in zip(mean, gr)]
        lr = min(g / wk.TRAIN_LIT['warmup_steps'], 1.0) * wk.TRAIN_LIT['lr']
        opt.step(params, [x / w for x in mean], lr)
        losses.append(float(np.mean(vals)))
    out['trainer/one_losses'] = np.asarray(losses)


def _run_cases(inputs, mesh, out, workdir):
    """do_trainrun(mesh=...) with a bf16 config for 2 epochs, then
    resume_trainrun(mesh=...) by one: the stored config keeps the compute
    dtype, rank 0 alone writes, model.npz holds float32 parameters."""
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.synthetic import make_dataset
    from grappa_tpu_torch.train import config as tconfig
    from grappa_tpu_torch.train.run import do_trainrun, resume_trainrun
    ds_dir = Path(workdir) / 'ds_bf16'
    if mesh.rank == 0:
        Dataset.from_moldata(make_dataset(n_mols=12, n_confs=4, seed=3),
                             'syn').save(ds_dir)
    mesh.barrier()
    config = tconfig.default_config()
    tconfig.overwrite_config({
        'model_config': dict(inputs['cfg'], **BF16_CFG),
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
    res = do_trainrun(config, project_dir=str(Path(workdir) / 'runs_bf16'),
                      mesh=mesh)
    first = res['trainer']
    res2 = resume_trainrun(res['run_dir'], extra_epochs=1, mesh=mesh)
    trainer = res2['trainer']
    sums = torch.stack([p.detach().double().sum()
                        for p in trainer.model.parameters()])
    every = mesh.all_gather(sums[None])
    out['run/epochs'] = np.asarray([first.epoch, trainer.epoch])
    out['run/ranks_equal'] = bool((every == every[0]).all())
    out['run/writer_dirs'] = np.asarray(
        mesh.all_gather(torch.tensor([[int(trainer.out_dir is not None)]]))
        .reshape(-1).numpy())
    out['run/model_dtype'] = str(trainer.model.gnn.att_blocks[0].dtype)
    mesh.barrier()
    if mesh.rank == 0:
        run_dir = Path(res2['run_dir'])
        stored = tconfig.read_yaml(run_dir / 'grappa_config.yaml')
        out['run/stored_dtype'] = str(stored['model_config']['compute_dtype'])
        with np.load(run_dir / 'model.npz') as f:
            out['run/npz_dtypes'] = np.asarray(sorted(
                {str(f[k].dtype) for k in f.files
                 if np.issubdtype(f[k].dtype, np.floating)}))
        out['run/files'] = np.asarray(sorted(p.name
                                             for p in run_dir.iterdir()))
        lines = (run_dir / 'metrics.jsonl').read_text().splitlines()
        out['run/train_losses'] = np.asarray(
            [json.loads(x)['train_loss'] for x in lines
             if 'train_loss' in json.loads(x)])


def _sp_batches(mesh, kind='big'):
    """(the whole batch, the rank's shard) of the atom-sharded cases:
    'big', one SP_ATOMS-atom molecule; 'mols', the DP step's batch 0 (two
    molecules, whose bf16 gradients the test holds to JAX's)."""
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.synthetic import make_moldata
    from grappa_tpu_torch.parallel import sp
    if kind == 'big':
        g = MolGraph.from_moldata(make_moldata(
            seed=SP_SEED, n_confs=SP_CONFS, n_atoms=SP_ATOMS))
        batch = collate([g], pad=sp.atom_sharded_pad_spec([g], SP_CONFS,
                                                          mesh),
                        device='cpu')
    else:
        batch = next(iter(wk.train_loader()))[0]
    return batch, sp.shard_batch_by_atoms(batch, mesh)


def _sp_cases(inputs, mesh, out):
    """The atom-sharded bf16 forward and train step: on 'big' eager and
    fused, the step with the dropout rates on (wk.DROPOUT), rank 0 also
    the unsharded bf16 forward and step; on 'mols' (the JAX comparison's
    batch) fused, without dropout, rank 0 also the unsharded bf16 and
    float32 ones."""
    from grappa_tpu_torch.parallel import dp, sp
    from grappa_tpu_torch.train.trainer import (make_eval_step,
                                                make_optimizer,
                                                make_train_step)
    for kind, paths, refs in (('mols', (True,), ('bfloat16', 'float32')),
                              ('big', (False, True), ('bfloat16',))):
        batch, sharded = _sp_batches(mesh, kind)
        wts = wk.qm_weights(batch.num_mols)
        drop = wk.DROPOUT if kind == 'big' else {}
        dp.COLLECTIVE_DTYPES.clear()
        for fused in paths:
            tag = f'sp/{kind}/' + ('fused' if fused else 'eager')
            energy, gradient = sp.make_atom_sharded_forward(
                _model(inputs, fused), mesh)(sharded)
            _dtypes(out, f'{tag}/forward')
            out[f'{tag}/energy'] = energy.numpy()
            out[f'{tag}/gradient'] = mesh.all_gather(gradient).numpy()
            model = _model(inputs, fused, **drop)
            names = [n for n, _ in model.named_parameters()]
            opt = wk._Capture(make_optimizer())
            loss, aux = sp.make_atom_sharded_train_step(model, opt, mesh)(
                sharded, wts, wk.LR, torch.Generator().manual_seed(0))
            _dtypes(out, f'{tag}/step')
            out[f'{tag}/loss'] = float(loss)
            _grads(out, f'{tag}/grad', names, opt.seen)
            _grads(out, f'{tag}/new', names, list(model.parameters()))
            if mesh.rank != 0:
                continue
            for dtype in refs:
                one = f'{tag}/one/{dtype}'
                e, g = make_eval_step(_model(inputs, fused, dtype))(batch)
                out[f'{one}/energy'] = e.numpy()
                out[f'{one}/gradient'] = g.numpy()
                ref = _model(inputs, fused, dtype, **drop)
                ropt = wk._Capture(make_optimizer())
                loss, _ = make_train_step(ref, ropt)(
                    batch, wts, wk.LR, torch.Generator().manual_seed(0))
                out[f'{one}/loss'] = float(loss)
                _grads(out, f'{one}/grad', names, ropt.seen)
                _grads(out, f'{one}/new', names, list(ref.parameters()))


def _dropout_cases(inputs, mesh, out):
    """Training-mode bf16 forwards with the dropout rates on, sharded and
    unsharded with the same generator, eager and fused: every mask a rank
    draws against the unsharded mask's rows, bit for bit, and the sharded
    prediction against the unsharded one."""
    from grappa_tpu_torch.ops import philox
    batch, sharded = _sp_batches(mesh)
    plain = philox.dropout_mask
    for fused in (False, True):
        tag = 'fused' if fused else 'eager'
        drawn = {}

        def spy(seed, stream, shape, rate, device=None, rows=None):
            mask = plain(seed, stream, shape, rate, device, rows)
            drawn[key].append((rows, mask))
            return mask

        model = _model(inputs, fused, **wk.DROPOUT).train()
        philox.dropout_mask = spy
        try:
            with torch.no_grad():
                key = 'full'
                drawn[key] = []
                want = model(batch, torch.Generator().manual_seed(3))
                key = 'part'
                drawn[key] = []
                got = model(sharded, torch.Generator().manual_seed(3))
        finally:
            philox.dropout_mask = plain
        same = len(drawn['full']) == len(drawn['part']) > 0
        for (_, full), (rows, part) in zip(drawn['full'], drawn['part']):
            first = 0 if rows is None else rows[0]
            n = part.shape[-2]
            same &= torch.equal(part, full[..., first:first + n, :])
        out[f'dropout/{tag}/masks'] = len(drawn['part'])
        out[f'dropout/{tag}/masks_equal'] = bool(same)
        for k, v in got.items():
            full = mesh.all_gather(v)
            out[f'dropout/{tag}/{k}'] = float(
                (full - want[k]).abs().max()
                / want[k].abs().max().clamp_min(1e-30))


def _torsion_cases(inputs, mesh, out):
    """The atom-sharded MM energy with use_fused_torsion=True (K5 / K5b's
    plain versions on the CPU) and without, on the reference parameters;
    rank 0: the unsharded fused energy."""
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.synthetic import make_moldata
    from grappa_tpu_torch.models import mm_energy
    from grappa_tpu_torch.ops import torsion_kernel
    from grappa_tpu_torch.parallel import sp
    g = MolGraph.from_moldata(make_moldata(
        seed=TORSION_SEED, n_confs=TORSION_CONFS, n_atoms=TORSION_ATOMS,
        learnable=True, conf_noise=0.05))
    batch = collate([g], pad=sp.atom_sharded_pad_spec([g], TORSION_CONFS,
                                                      mesh), device='cpu')
    sharded = sp.shard_batch_by_atoms(batch, mesh)
    ref = lambda b: {key: torch.nan_to_num(getattr(b.terms[t], f))
                     for key, t, f in wk.REF_FIELDS}
    calls = []
    plain = torsion_kernel.reference_torsion_energy
    torsion_kernel.reference_torsion_energy = lambda *a: (
        calls.append(a[0].shape[0]), plain(*a))[1]
    try:
        for fused in (True, False):
            tag = 'fused' if fused else 'plain'
            e, gr = mm_energy.energy_and_gradient(
                sharded, ref(sharded), use_fused_torsion=fused)
            out[f'torsion/{tag}/energy'] = e.numpy()
            out[f'torsion/{tag}/gradient'] = mesh.all_gather(gr).numpy()
            out[f'torsion/{tag}/k5_calls'] = len(calls)
            calls.clear()
        if mesh.rank == 0:
            e, gr = mm_energy.energy_and_gradient(batch, ref(batch),
                                                  use_fused_torsion=True)
            out['torsion/one/energy'] = e.numpy()
            out['torsion/one/gradient'] = gr.numpy()
    finally:
        torsion_kernel.reference_torsion_energy = plain


def _dense_cases(inputs, mesh, out):
    """A bf16 Dense on the rank's rows: the weight and bias gradients the
    step hands AdamClip (the ranks' mean of theirs, each rank's output
    gradient carrying the world size's factor of the replicated loss)
    through `layers.shard_dense`, and through autograd's own bf16 product
    (each rank's part rounded to bf16 before the sum); rank 0: the
    unsharded bf16 Dense's. Then a writer's projection of the gathered
    rows (`AtomShard.whole_grad`), each rank using its half of the rows'
    output gradient, against the unsharded."""
    from types import SimpleNamespace

    from grappa_tpu_torch.models.layers import dense, shard_dense
    from grappa_tpu_torch.parallel import dp
    bf16, w = torch.bfloat16, mesh.size
    gen = torch.Generator().manual_seed(11)
    n, f_in, f_out = 384 * w, 64, 48
    x = torch.randn(n, f_in, generator=gen)
    weight = torch.randn(f_out, f_in, generator=gen) / 8
    bias = torch.randn(f_out, generator=gen) / 8
    dy = torch.randn(n, f_out, generator=gen)
    part = slice(mesh.rank * (n // w), (mesh.rank + 1) * (n // w))
    shard = SimpleNamespace(mesh=mesh)

    def grads(fn, rows, g):
        leaves = (weight.clone().requires_grad_(True),
                  bias.clone().requires_grad_(True))
        return torch.autograd.grad(fn(x[rows], *leaves), leaves,
                                   g.to(bf16))

    got = dp.mean_over_ranks(grads(
        lambda a, q, c: shard_dense(a, q, c, bf16, shard), part,
        dy[part] * w), mesh)
    plain = dp.mean_over_ranks(grads(
        lambda a, q, c: dense(a, q, c, bf16), part, dy[part] * w), mesh)
    # the projection of all rows on every rank, half the uses a rank
    sh = SimpleNamespace(whole_grad=lambda t: dp.whole_grad(t, mesh))
    proj = lambda a, q, c, s: (s.whole_grad(dense(a, q, c, bf16).float())
                               if s else dense(a, q, c, bf16).float())
    mine = torch.zeros_like(dy)
    mine[part] = dy[part] * w
    whole = dp.mean_over_ranks(grads(lambda a, q, c: proj(a, q, c, sh),
                                     slice(None), mine), mesh)
    unfixed = dp.mean_over_ranks(grads(lambda a, q, c: proj(a, q, c, None),
                                       slice(None), mine), mesh)
    if mesh.rank == 0:
        want = grads(lambda a, q, c: dense(a, q, c, bf16), slice(None), dy)
        for key, g in (('shard_dense', got), ('autograd', plain),
                       ('whole_grad', whole), ('whole_autograd', unfixed)):
            for name, a, b in zip(('weight', 'bias'), g, want):
                out[f'dense/{key}/{name}'] = float(
                    (a.double() - b.double()).norm() / b.double().norm())


CASES = {'dense': _dense_cases, 'dp': _dp_cases, 'trainer': _trainer_cases,
         'sp': _sp_cases, 'dropout': _dropout_cases,
         'torsion': _torsion_cases}


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
        for name in cases.split(','):
            if name == 'run':
                _run_cases(inputs, mesh, out, workdir)
            else:
                CASES[name](inputs, mesh, out)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    if rank == 0:
        np.savez(os.path.join(workdir, f'out_w{world}.npz'),
                 **{k: np.asarray(v) for k, v in out.items()})
    import torch.distributed as dist
    dist.destroy_process_group()
