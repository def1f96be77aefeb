#!/usr/bin/env python3
"""Smoke run of grappa_tpu_torch (the PyTorch / CUDA port) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit, the torch / CUDA versions;
     builds the hand-written kernels from grappa_tpu_torch/csrc and times it.
  2. kernels: each CUDA kernel against its plain PyTorch version on the same
     seeded inputs at the shapes the serving path gives it in both
     workloads of phase 3, with the error, the kernel / plain times and the
     card's bound.
  3. predict_many at the default model's full width (7 x 512 GNN, depth-3 x
     512 heads) on seeded non-zero weights, on two paths: 32 small
     molecules, then a 1224-atom protein-like molecule. Checks that every
     output is finite, that each path's forward launched the kernels
     7 / 12 / 4 times (the counts are zeroed just before each path and read
     just after it), and that the outputs match the same model run on the
     CPU (the eager modules).

The last three lines are a JSON object describing the kernels, the card's
name and power limit, and {"ok": true, "device": {...}}. In the kernels'
line, `launches` sums the two paths (`launches_per_path` gives each), and
`ms`, `plain_ms` and `bound_ms` sum one call at each shape of each path.
Any failure exits non-zero before those lines. Needs one CUDA device;
imports nothing of JAX or of grappa_tpu.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (H100 SXM): fp32 outside the tensor cores and
# HBM bandwidth; a card set below 700 W runs below them
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel vs plain version on the card, both float32 (TF32 off): elementwise
# |kernel - plain| <= ATOL + RTOL * |plain|; the two sum their products in
# different orders, which at K <= 2048 costs a few float32 ulps
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# predict_many on the card (kernels) vs on the CPU (eager modules): the
# tolerance the repo's default-config parity test uses
MODEL_RTOL, MODEL_ATOL = 3e-4, 3e-5
TORSION_CUTOFF = 1e-4

FAILURES = []


def phase(name):
    print(f'== {name}', flush=True)


def check(ok, what):
    print(('PASS ' if ok else 'FAIL ') + what, flush=True)
    if not ok:
        FAILURES.append(what)


def protein_like_molecule(Molecule, n_atoms=1231, seed=0):
    """Chain-of-residues graph approximating a small protein's topology
    (the JAX package's benchmarks/inference_bench.py molecule)."""
    rng = np.random.default_rng(seed)
    bonds = []
    atoms_per_res = 8
    n_res = n_atoms // atoms_per_res
    idx = 0
    prev_backbone = None
    for _ in range(n_res):
        base = idx
        # backbone N-CA-C(=O)
        bonds += [(base, base + 1), (base + 1, base + 2), (base + 2, base + 3)]
        if prev_backbone is not None:
            bonds.append((prev_backbone, base))
        # side chain
        bonds += [(base + 1, base + 4), (base + 4, base + 5),
                  (base + 4, base + 6), (base + 5, base + 7)]
        prev_backbone = base + 2
        idx += atoms_per_res
    n = idx
    zs = rng.choice([1, 6, 6, 7, 8], size=n)
    charges = rng.normal(0, 0.2, size=n).astype(np.float32)
    charges -= charges.mean()
    impropers = []
    # sp2 carbonyl impropers
    for r in range(n_res - 1):
        c = r * atoms_per_res + 2
        impropers.append((c - 1, c + 1, c, (r + 1) * atoms_per_res))
    return Molecule(atoms=np.arange(n), bonds=bonds, impropers=impropers,
                    atomic_numbers=zs, partial_charges=charges,
                    improper_in_correct_format=False)


def small_molecules(random_molecule, n=32):
    return [random_molecule(seed=s, n_atoms=int(
        np.random.default_rng(s).integers(10, 40))) for s in range(n)]


def timed(torch, fn, iters=20, warmup=2):
    """Mean device ms of fn() over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, reps=5):
    """Median and all host-clock ms of fn() over `reps` warm runs, each
    ending in a synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (float(np.median(times)),
            ', '.join(f'{t:.2f}' for t in times))


def bound(flops, nbytes):
    t_ops, t_mem = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ('operations' if t_ops >= t_mem
                                     else 'bytes')


def rand_params(torch, gen, shapes):
    """Seeded non-zero parameters: weights ~ N(0, 1/fan_in), vectors are
    LayerNorm scales around 1 or biases around 0 (every entry non-zero,
    so no zero-initialised branch can hide a wrong kernel)."""
    out = []
    for shape, kind in shapes:
        if kind == 'w':
            t = torch.randn(shape, generator=gen) / np.sqrt(shape[1])
        elif kind == 'g':
            t = 1.0 + 0.1 * torch.randn(shape, generator=gen)
        else:
            t = 0.1 * torch.randn(shape, generator=gen)
        out.append(t.cuda())
    return tuple(out)


def kernel_phase(torch, workloads):
    """Phase 2: every kernel against its plain version at the shapes each
    workload's forward gives it (its padded N, neighbour list and tuple
    counts). Returns the per-kernel JSON entries (launch counts filled in
    by phase 3)."""
    from grappa_tpu_torch.data.graph_batch import TERM_ARITY, TERMS
    from grappa_tpu_torch.ops import fused_block as fb
    from grappa_tpu_torch.ops import fused_gnn as fg
    from grappa_tpu_torch.ops import fused_symmetriser as fs
    from grappa_tpu_torch.models.heads import (PERMUTATIONS,
                                               WRONG_SYMMETRY_IMPROPER)
    gen = torch.Generator().manual_seed(1234)
    entries = {}

    def compare(name, label, kernel, plain, flops, nbytes, on_path=True):
        y_k, y_p = kernel(), plain()
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(y_k).all())
        err = (y_k - y_p).abs()
        max_abs = float(err.max())
        ok = finite and bool(
            (err <= KERNEL_ATOL + KERNEL_RTOL * y_p.abs()).all())
        rel = max_abs / max(float(y_p.abs().max()), 1e-30)
        ms, plain_ms = timed(torch, kernel), timed(torch, plain)
        b_ms, b_by = bound(flops, nbytes)
        check(ok, f'{name} {label}: max_abs_err {max_abs:.3e} rel '
                  f'{rel:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}|y|) '
                  f'kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound '
                  f'{b_ms:.4f} ms ({b_by}, {flops / 1e9:.2f} GFLOP, '
                  f'{nbytes / 1e6:.1f} MB)')
        if not on_path:
            return
        # the JSON line sums one call at each shape of each workload
        e = entries.setdefault(name, dict(max_abs_err=0.0, ms=0.0,
                                          plain_ms=0.0, flops=0.0,
                                          nbytes=0.0))
        e['max_abs_err'] = max(e['max_abs_err'], max_abs)
        e['ms'] += ms
        e['plain_ms'] += plain_ms
        e['flops'] += flops
        e['nbytes'] += nbytes

    f, heads, hid, hid2, width = 512, 16, 2048, 512, 256
    sym_out = {'n2': 2, 'n3': 2, 'n4': 12, 'n4_improper': 6}

    def sym_case(perms, t, out, label, on_path=True):
        s = len(perms[0])
        x = torch.randn((s, t, f), generator=gen).cuda()
        dims = [(s * f, width, width), (width, width, width),
                (width, width, out)]
        layers = [rand_params(torch, gen, [
            ((i,), 'g'), ((i,), 'b'), ((h, i), 'w'), ((h,), 'b'),
            ((o, h), 'w'), ((o,), 'b')]) for i, h, o in dims]
        macs = sum(i * h + h * o for i, h, o in dims)
        compare('fused_symmetriser', f'{label} S={s} T={t} '
                f'perms={len(perms)} out={out}',
                lambda: fs.fused_symmetriser(x, layers, perms),
                lambda: fs.reference_symmetriser(x, layers, perms),
                flops=2 * len(perms) * t * macs,
                nbytes=4 * (s * t * f + sum(p.numel() for layer in layers
                                            for p in layer) + t * out),
                on_path=on_path)

    for label, batch in workloads.items():
        # K1 at the workload's padded node count, with its neighbour list:
        # the padding rows have every slot masked
        nb = batch.neighbors
        n, d = nb.shape
        feat = torch.randn((n, f), generator=gen).cuda()
        hn = torch.randn((n, f), generator=gen).cuda()
        nbr = feat[nb.t()].contiguous()
        mask = batch.neighbor_mask.t().float().contiguous()
        p1 = rand_params(torch, gen, [
            ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
            ((hid, f), 'w'), ((hid,), 'b'), ((f, hid), 'w'), ((f,), 'b')])
        real_slots = float(mask.sum())
        compare('fused_gnn_block', f'{label} N={n} F={f} H={heads} D={d}',
                lambda: fg.fused_gnn_block(feat, nbr, hn, mask, p1, heads),
                lambda: fg.reference_gnn_block(feat, nbr, hn, mask, p1,
                                               heads),
                flops=2 * n * (f * f + 2 * f * hid) + 4 * real_slots * f,
                nbytes=4 * ((2 + d) * n * f + d * n
                            + sum(p.numel() for p in p1) + n * f))

        # K2 and K3 at the four heads' (S, T)
        for term in TERMS:
            s, t = TERM_ARITY[term], batch.terms[term].idxs.shape[0]
            x = torch.randn((s, t, f), generator=gen).cuda()
            p2 = rand_params(torch, gen, [
                ((f,), 'g'), ((f,), 'b'), ((3 * f, f), 'w'),
                ((3 * f,), 'b'), ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'),
                ((f,), 'b'), ((hid2, f), 'w'), ((hid2,), 'b'),
                ((f, hid2), 'w'), ((f,), 'b')])
            r = s * t
            compare('fused_transformer_block', f'{label} S={s} T={t} F={f} '
                    f'H=8',
                    lambda: fb.fused_transformer_block(x, p2, 8),
                    lambda: fb.reference_block(x, p2, 8),
                    flops=(2 * r * (4 * f * f + 2 * f * hid2)
                           + 4 * t * s * s * f),
                    nbytes=4 * (2 * r * f + sum(p.numel() for p in p2)))
            sym_case(PERMUTATIONS[term], t, sym_out[term], label)

    # the 6-permutation improper case (wrong_symmetry), off the default path
    sym_case(WRONG_SYMMETRY_IMPROPER, 552, 6, 'wrong_symmetry',
             on_path=False)
    return entries


def compare_outputs(label, got, want):
    """The six outputs of the card's run against the CPU's. Torsion ks that
    the hard cutoff (|k| > 1e-4) sends to 0 on one side only are legitimate
    disagreements near the cutoff; they are counted and left out."""
    for key in got:
        a, b = got[key], want[key]
        ok = a.shape == b.shape and bool(np.isfinite(a).all())
        keep = np.ones(a.shape, bool)
        if key.endswith('_ks'):
            flip = (np.abs(a) > TORSION_CUTOFF) != (np.abs(b) > TORSION_CUTOFF)
            keep &= ~flip
            ok &= flip.mean() < 1e-3 if flip.size else True
        err = np.abs(a - b)[keep]
        ok &= bool(np.all(err <= MODEL_ATOL + MODEL_RTOL
                          * np.abs(b)[keep]))
        check(ok, f'{label} {key} {a.shape}: max_abs_err '
                  f'{float(err.max()) if err.size else 0.0:.3e} (tol '
                  f'{MODEL_ATOL} + {MODEL_RTOL}|y|)'
                  + (f', {int((~keep).sum())} cutoff flips left out'
                     if key.endswith('_ks') else ''))


def stack(params_list):
    fields = ('bond_k', 'bond_eq', 'angle_k', 'angle_eq', 'proper_ks',
              'improper_ks')
    col = lambda a: a[:, None] if a.ndim == 1 else a
    return {k: np.concatenate([col(np.asarray(getattr(p, k)))
                               for p in params_list]) for k in fields}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, 'grappa_tpu_torch')):
        print('chip_smoke.py: run it from a checkout of the repository '
              '(grappa_tpu_torch/ not found)', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke.py: no CUDA device', file=sys.stderr)
        return 1

    phase('1. device')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f'card: {smi}')
    print(f'python {sys.version.split()[0]} torch {torch.__version__} '
          f'cuda {torch.version.cuda} device '
          f'{torch.cuda.get_device_name(0)} count '
          f'{torch.cuda.device_count()}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn {torch.backends.cudnn.allow_tf32}')
    from grappa_tpu_torch.ops import _cuda
    t0 = time.time()
    so = _cuda.build(verbose=True)
    _cuda.lib()
    print(f'kernels built in {time.time() - t0:.1f} s: '
          f'{os.path.relpath(so, ROOT)}', flush=True)

    from grappa_tpu_torch import Grappa
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.data.molecule import Molecule
    from grappa_tpu_torch.data.synthetic import random_molecule
    from grappa_tpu_torch.models.grappa_model import (
        get_default_model_config, make_model)
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser

    protein = protein_like_molecule(Molecule)
    smalls = small_molecules(random_molecule)
    paths = {'small': smalls, 'protein': [protein]}
    workloads = {}
    for label, mols in paths.items():
        graphs = [MolGraph.from_molecule(m) for m in mols]
        workloads[label] = collate(graphs, bucketed_pad_spec(graphs, 1), 1,
                                   device='cuda')

    phase('2. kernels against their plain versions (both workloads\' '
          'shapes)')
    entries = kernel_phase(torch, workloads)

    phase('3. predict_many, default config, seeded non-zero weights')
    cfg = get_default_model_config()
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            # zero-initialised branches (head_reducer, out_proj, ...) and
            # biases become non-zero too
            scale = 0.02 if p.dim() >= 2 else 0.05
            p.add_(scale * torch.randn(p.shape, generator=gen))
    cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
    ff = Grappa(model, {'model_config': cfg})          # CUDA by default
    print(f'{len(smalls)} small molecules ({sum(len(m.atoms) for m in smalls)}'
          f' atoms), protein-like molecule ({len(protein.atoms)} atoms); '
          f'random weights, so check_eq_values=False')
    ff.predict_many(smalls, check_eq_values=False)       # warm-up
    ff.predict(protein, check_eq_values=False)
    torch.cuda.synchronize()

    # each path is read on its own: the counts are set to 0 just before its
    # predict and read just after
    counters = (fused_gnn_block, fused_transformer_block, fused_symmetriser)
    launches = {c.__name__: {} for c in counters}
    outputs = {}
    for label, mols in paths.items():
        for c in counters:
            c.launches = 0
        outputs[label] = ff.predict_many(mols, check_eq_values=False)
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in counters}
        for name, n in got.items():
            launches[name][label] = n
        check(got == {'fused_gnn_block': 7, 'fused_transformer_block': 12,
                      'fused_symmetriser': 4},
              f'{label}: launch counts of one forward {got} (7 / 12 / 4)')
    out_small, out_prot = outputs['small'], outputs['protein'][0]

    card_small, card_prot = stack(out_small), stack([out_prot])
    for label, out in (('small', card_small), ('protein', card_prot)):
        check(all(np.isfinite(v).all() for v in out.values()),
              f'{label}: all outputs finite')
    check(card_prot['bond_k'].shape == (len(protein.bonds), 1)
          and card_prot['proper_ks'].shape == (len(protein.propers), 6)
          and card_prot['improper_ks'].shape == (len(protein.impropers), 3),
          'protein: output shapes match its tuple counts')

    eager = make_model(dict(cfg, fused_gnn=False, fused_heads=False))
    eager.load_state_dict(cpu_state)
    ff_eager = Grappa(eager, {'model_config': cfg})
    ff_eager.predict(protein, check_eq_values=False)     # warm-up
    for name, mols in (('small x32', smalls), ('protein 1224 atoms',
                                                [protein])):
        # where the time goes: host featurize + collate, then the forward,
        # timed on the card (CUDA events), for the kernels and the eager
        # modules (cuBLAS) on the same batch
        graphs = [MolGraph.from_molecule(m) for m in mols]
        batch = collate(graphs, bucketed_pad_spec(graphs, 1), 1)
        for label, f in (('kernels', ff), ('eager modules', ff_eager)):
            med, runs = host_ms(torch, lambda: f.predict_many(
                mols, check_eq_values=False), reps=7)
            with torch.inference_mode():
                fwd = timed(torch, lambda: f.model(batch), iters=10)
            print(f'warm predict {name}, {label}: median {med:.2f} ms '
                  f'(runs {runs}); forward {fwd:.2f} ms on the card '
                  f'(CUDA events, mean of 10)', flush=True)
        prep, runs = host_ms(torch, lambda: collate(
            [MolGraph.from_molecule(m) for m in mols],
            bucketed_pad_spec(graphs, 1), 1), reps=7)
        print(f'  host featurize + collate {name}: median {prep:.2f} ms '
              f'(runs {runs})', flush=True)

    cpu_model = make_model(cfg)
    cpu_model.load_state_dict(cpu_state)
    ff_cpu = Grappa(cpu_model, {'model_config': cfg}, device='cpu')
    compare_outputs('small', card_small, stack(ff_cpu.predict_many(
        smalls, check_eq_values=False)))
    compare_outputs('protein', card_prot, stack([ff_cpu.predict(
        protein, check_eq_values=False)]))

    if FAILURES:
        print(f'chip_smoke.py: {len(FAILURES)} check(s) failed',
              file=sys.stderr)
        return 1

    sources = {'fused_gnn_block': ('grappa_tpu_torch/csrc/fused_gnn.cu',
                                   'grappa_tpu/ops/fused_gnn.py:271'),
               'fused_transformer_block': (
                   'grappa_tpu_torch/csrc/fused_block.cu',
                   'grappa_tpu/ops/fused_block.py:379'),
               'fused_symmetriser': (
                   'grappa_tpu_torch/csrc/fused_symmetriser.cu',
                   'grappa_tpu/ops/fused_symmetriser.py:174')}
    kernels = []
    for name, (source, replaces) in sources.items():
        e = entries[name]
        b_ms, b_by = bound(e['flops'], e['nbytes'])
        kernels.append(dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=sum(launches[name].values()),
            launches_per_path=launches[name], max_abs_err=e['max_abs_err'],
            ms=e['ms'], plain_ms=e['plain_ms'], bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
