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
  4. training kernels at the training batch's shapes (the JAX package's
     128-molecule x 32-conformer bench batch, rebuilt by the port's
     make_moldata): K1 / K2 forward with dropout at the default rates and
     K3 forward, K1b / K2b / K3b against autograd through the plain
     versions (same dropout seeds), the K1m / K2m mask dumps bit-equal to
     the plain Philox, with times and bounds.
  5. training at the default config: (a) one step on the card against the
     same step on the CPU (plain path), dropout off, 8 molecules x 4
     conformers; (b) ten steps with the config's dropout on the 128 x 32
     batch (QM-phase loss weights, lr 1.5e-5): finite losses, 7 / 12 / 4
     forward and 7 / 12 / 4 backward launches per step (counts zeroed
     before each step), the step's time split and peak memory; (c) twenty
     steps without dropout at lr 1e-4 on the 8-molecule batch must lower
     the loss.

The last three lines are a JSON object describing the kernels, the card's
name and power limit, and {"ok": true, "device": {...}}. In the kernels'
line, `launches` sums the main paths (the two predict paths and the ten
training steps; `launches_per_path` gives each), and `ms`, `plain_ms` and
`bound_ms` sum one call at each shape of each path. Any failure exits
non-zero before those lines. Needs one CUDA device; imports nothing of JAX
or of grappa_tpu.
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
# backward kernel vs autograd through the plain version: per gradient
# tensor, max |kernel - plain| <= GRAD_RTOL * max |plain| (weight gradients
# sum thousands of rows in another order)
GRAD_RTOL = 1e-4
# one training step on the card vs on the CPU: loss rtol, and per-gradient
# relative L2 (float32 sums in another order through a double backward)
STEP_LOSS_RTOL, STEP_GRAD_RL2 = 1e-4, 1e-3
# the JAX package's training bench batch (bench.py) and QM-phase weights
# (grappa_tpu/train/config.py lit_model_config)
TRAIN_MOLS, TRAIN_CONFS, TRAIN_SEED = 128, 32, 123
QM_WEIGHTS = dict(energy=1.0, gradient=0.8, param=1e-3, proper_reg=1e-3,
                  improper_reg=1e-3)
TRAIN_LR, OVERFIT_LR = 1.5e-5, 1e-4

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


def accumulate(entries, name, max_abs, ms, plain_ms, flops, nbytes):
    """The JSON line sums one call at each shape of each path."""
    e = entries.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                      flops=0.0, nbytes=0.0))
    e['max_abs_err'] = max(e['max_abs_err'], max_abs)
    e['ms'] += ms
    e['plain_ms'] += plain_ms
    e['flops'] += flops
    e['nbytes'] += nbytes


def compare_out(torch, entries, name, label, kernel, plain, flops, nbytes,
                on_path=True):
    """A forward kernel against its plain version on the same inputs;
    adds its error, times and bound to `entries[name]` when on_path."""
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
    if on_path:
        accumulate(entries, name, max_abs, ms, plain_ms, flops, nbytes)


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

    compare = lambda *a, **k: compare_out(torch, entries, *a, **k)

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


def training_batches(torch):
    """The JAX package's training bench batch (bench.py: 128 molecules,
    n_atoms = rng.integers(8, 44) with rng = default_rng(123), seed 123 + i,
    32 conformers, bucketed padding), as MolGraphs."""
    from grappa_tpu_torch.data.graph_batch import MolGraph
    from grappa_tpu_torch.data.synthetic import make_moldata
    rng = np.random.default_rng(TRAIN_SEED)
    t0 = time.time()
    graphs = [MolGraph.from_moldata(make_moldata(
        seed=TRAIN_SEED + i, n_confs=TRAIN_CONFS,
        n_atoms=int(rng.integers(8, 44)))) for i in range(TRAIN_MOLS)]
    print(f'built {TRAIN_MOLS} molecules x {TRAIN_CONFS} conformers '
          f'({sum(g.n_atoms for g in graphs)} atoms) on the host in '
          f'{time.time() - t0:.1f} s', flush=True)
    return graphs


def compare_grad(torch, entries, name, label, kernel, plain, inputs, dy,
                 flops, nbytes):
    """A backward kernel against autograd through the plain version on the
    same inputs (and dropout masks); times the backward alone (the forward
    graph is kept and its backward run again)."""
    lk = [t.detach().clone().requires_grad_(True) for t in inputs]
    lp = [t.detach().clone().requires_grad_(True) for t in inputs]
    y_k, y_p = kernel(*lk), plain(*lp)
    bwd_k = lambda: torch.autograd.grad(y_k, lk, dy, retain_graph=True)
    bwd_p = lambda: torch.autograd.grad(y_p, lp, dy, retain_graph=True)
    g_k, g_p = bwd_k(), bwd_p()
    torch.cuda.synchronize()
    worst, max_abs, ok = 0.0, 0.0, True
    for a, b in zip(g_k, g_p):
        err = float((a - b).abs().max())
        rel = err / max(float(b.abs().max()), 1e-30)
        ok &= bool(torch.isfinite(a).all()) and rel <= GRAD_RTOL
        worst, max_abs = max(worst, rel), max(max_abs, err)
    ms, plain_ms = timed(torch, bwd_k, iters=5), timed(torch, bwd_p, iters=5)
    b_ms, b_by = bound(flops, nbytes)
    check(ok, f'{name} {label}: {len(g_k)} gradients, max_abs_err '
              f'{max_abs:.3e}, worst max|err|/max|plain| {worst:.3e} (tol '
              f'{GRAD_RTOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms '
              f'bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.2f} GFLOP, '
              f'{nbytes / 1e6:.1f} MB)')
    accumulate(entries, name, max_abs, ms, plain_ms, flops, nbytes)


def training_kernel_phase(torch, batch, entries):
    """Phase 4: the kernels at the shapes one training step gives them on
    the 128 x 32 batch, dropout on at the default rates."""
    from grappa_tpu_torch.data.graph_batch import TERM_ARITY, TERMS
    from grappa_tpu_torch.models.heads import PERMUTATIONS
    from grappa_tpu_torch.ops import fused_block as fb
    from grappa_tpu_torch.ops import fused_gnn as fg
    from grappa_tpu_torch.ops import fused_symmetriser as fs
    from grappa_tpu_torch.ops import philox
    gen = torch.Generator().manual_seed(4321)
    f, heads, hid, hid2, width = 512, 16, 2048, 512, 256
    sym_out = {'n2': 2, 'n3': 2, 'n4': 12, 'n4_improper': 6}
    compare = lambda *a, **k: compare_out(torch, entries, *a, **k)

    def mask_check(op, name, shape, rate, seed):
        m1, m2 = op.dropout_masks(seed, shape, rate, device='cuda')
        want = [philox.dropout_mask(seed, s, shape, rate, device='cuda')
                for s in (0, 1)]
        torch.cuda.synchronize()
        same = torch.equal(m1, want[0]) and torch.equal(m2, want[1])
        keep = float((m1 > 0).float().mean())
        n = m1.numel()
        sigma = np.sqrt(rate * (1 - rate) / n)
        ms = timed(torch, lambda: op.dropout_masks(seed, shape, rate,
                                                   device='cuda'))
        plain_ms = timed(torch, lambda: [
            philox.dropout_mask(seed, s, shape, rate, device='cuda')
            for s in (0, 1)])
        nbytes = 2 * 4 * n
        b_ms, b_by = bound(0, nbytes)
        check(same and abs(keep - (1 - rate)) <= 4 * sigma,
              f'{name} {tuple(shape)} rate {rate}: bit-equal to the plain '
              f'Philox {same}, keep fraction {keep:.6f} (1 - rate = '
              f'{1 - rate}, 4 sigma = {4 * sigma:.2e}) kernel {ms:.4f} ms '
              f'plain {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})')
        accumulate(entries, name, 0.0, ms, plain_ms, 0, nbytes)

    # K1 / K1b / K1m at the batch's padded nodes and neighbour list
    nb = batch.neighbors
    n, d = nb.shape
    feat = torch.randn((n, f), generator=gen).cuda()
    hn = torch.randn((n, f), generator=gen).cuda()
    nbr = feat[nb.t()].contiguous()
    mask = batch.neighbor_mask.t().float().contiguous()
    p1 = rand_params(torch, gen, [
        ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
        ((hid, f), 'w'), ((hid,), 'b'), ((f, hid), 'w'), ((f,), 'b')])
    rate1, seed1 = 0.3, 17
    masks1 = [philox.dropout_mask(seed1, j, (n, f), rate1, device='cuda')
              for j in (0, 1)]
    fwd1 = 2 * n * (f * f + 2 * f * hid) + 4 * float(mask.sum()) * f
    in1 = (2 + d) * n * f + d * n + sum(q.numel() for q in p1)
    compare('fused_gnn_block', f'train N={n} D={d} dropout {rate1}',
            lambda: fg.fused_gnn_block(feat, nbr, hn, mask, p1, heads, rate1,
                                       True, seed1),
            lambda: fg.reference_gnn_block(feat, nbr, hn, mask, p1, heads,
                                           masks1),
            flops=fwd1, nbytes=4 * (in1 + n * f))
    dy1 = torch.randn((n, f), generator=gen).cuda()
    compare_grad(torch, entries, 'fused_gnn_block.backward',
                 f'train N={n} D={d} dropout {rate1}',
                 lambda a, b, c, *q: fg.fused_gnn_block(
                     a, b, c, mask, q, heads, rate1, True, seed1),
                 lambda a, b, c, *q: fg.reference_gnn_block(
                     a, b, c, mask, q, heads, masks1),
                 [feat, nbr, hn, *p1], dy1, flops=2 * fwd1,
                 nbytes=4 * (2 * in1 - d * n + n * f))
    mask_check(fg, 'fused_gnn.dropout_masks', (n, f), rate1, seed1)

    # K2 / K2b / K2m and K3 / K3b at the four heads' (S, T)
    rate2 = 0.5
    for i, term in enumerate(TERMS):
        s, t = TERM_ARITY[term], batch.terms[term].idxs.shape[0]
        r = s * t
        x = torch.randn((s, t, f), generator=gen).cuda()
        p2 = rand_params(torch, gen, [
            ((f,), 'g'), ((f,), 'b'), ((3 * f, f), 'w'), ((3 * f,), 'b'),
            ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
            ((hid2, f), 'w'), ((hid2,), 'b'), ((f, hid2), 'w'), ((f,), 'b')])
        seed2 = 100 + i
        masks2 = [philox.dropout_mask(seed2, j, (s, t, f), rate2,
                                      device='cuda') for j in (0, 1)]
        fwd2 = 2 * r * (4 * f * f + 2 * f * hid2) + 4 * t * s * s * f
        in2 = r * f + sum(q.numel() for q in p2)
        compare('fused_transformer_block', f'train S={s} T={t} dropout '
                f'{rate2}',
                lambda: fb.fused_transformer_block(x, p2, 8, rate2, True,
                                                   seed2),
                lambda: fb.reference_block(x, p2, 8, masks2),
                flops=fwd2, nbytes=4 * (in2 + r * f))
        compare_grad(torch, entries, 'fused_transformer_block.backward',
                     f'train S={s} T={t} dropout {rate2}',
                     lambda a, *q: fb.fused_transformer_block(
                         a, q, 8, rate2, True, seed2),
                     lambda a, *q: fb.reference_block(a, q, 8, masks2),
                     [x, *p2], torch.randn_like(x), flops=2 * fwd2,
                     nbytes=4 * (2 * in2 + r * f))
        if term == 'n4':
            mask_check(fb, 'fused_block.dropout_masks', (s, t, f), rate2,
                       seed2)

        perms, out = PERMUTATIONS[term], sym_out[term]
        dims = [(s * f, width, width), (width, width, width),
                (width, width, out)]
        layers = [rand_params(torch, gen, [
            ((a,), 'g'), ((a,), 'b'), ((h, a), 'w'), ((h,), 'b'),
            ((o, h), 'w'), ((o,), 'b')]) for a, h, o in dims]
        flat = [q for layer in layers for q in layer]
        fwd3 = 2 * len(perms) * t * sum(a * h + h * o for a, h, o in dims)
        in3 = r * f + sum(q.numel() for q in flat)
        split = lambda q: [q[6 * j:6 * j + 6] for j in range(3)]
        compare('fused_symmetriser', f'train S={s} T={t} perms={len(perms)}',
                lambda: fs.fused_symmetriser(x, layers, perms),
                lambda: fs.reference_symmetriser(x, layers, perms),
                flops=fwd3, nbytes=4 * (in3 + t * out))
        compare_grad(torch, entries, 'fused_symmetriser.backward',
                     f'train S={s} T={t} perms={len(perms)}',
                     lambda a, *q: fs.fused_symmetriser(a, split(q), perms),
                     lambda a, *q: fs.reference_symmetriser(a, split(q),
                                                            perms),
                     [x, *flat], torch.randn((t, out), device='cuda'),
                     flops=2 * fwd3, nbytes=4 * (2 * in3 + t * out))


def perturbed_model(torch, make_model, cfg, seed=0):
    """The default model with seeded non-zero weights (zero-initialised
    branches and biases perturbed too), on the CPU."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for q in model.parameters():
            q.add_((0.02 if q.dim() >= 2 else 0.05)
                   * torch.randn(q.shape, generator=gen))
    return model


def training_phase(torch, graphs, batch, cfg):
    """Phase 5: (a) card vs CPU step, (b) ten steps with dropout on the
    128 x 32 batch, (c) overfitting. Returns the launches of (b)."""
    from grappa_tpu_torch.data.graph_batch import collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    from grappa_tpu_torch.train.loss import LossWeights, molwise_loss
    from grappa_tpu_torch.train.trainer import (loss_gradients,
                                                make_optimizer,
                                                make_train_step)

    def weights(m, device):
        w = dict(QM_WEIGHTS, param=torch.full((m,), QM_WEIGHTS['param'],
                                              device=device))
        return LossWeights(**w)

    no_drop = dict(cfg, gnn_dropout_attention=0.0, parameter_dropout=0.0,
                   gnn_dropout_final=0.0, gnn_dropout_initial=0.0)
    few = graphs[:8]
    pad8 = bucketed_pad_spec(few, 4)
    b_cpu = collate(few, pad8, 4, device='cpu')
    b_gpu = collate(few, pad8, 4, device='cuda')

    # (a) the same step on the card (kernels) and on the CPU (plain path)
    cpu_model = perturbed_model(torch, make_model, no_drop)
    gpu_model = make_model(no_drop).cuda()
    gpu_model.load_state_dict(cpu_model.state_dict())
    t0 = time.time()
    l_cpu, _, g_cpu = loss_gradients(cpu_model, b_cpu,
                                     weights(b_cpu.num_mols, 'cpu'))
    cpu_s = time.time() - t0
    l_gpu, _, g_gpu = loss_gradients(gpu_model, b_gpu,
                                     weights(b_gpu.num_mols, 'cuda'))
    l_cpu, l_gpu = float(l_cpu), float(l_gpu)
    worst = max((float((g_gpu[k].cpu() - g).norm()
                       / max(float(g.norm()), 1e-30)), k)
                for k, g in g_cpu.items())
    check(abs(l_gpu - l_cpu) <= STEP_LOSS_RTOL * abs(l_cpu)
          and worst[0] <= STEP_GRAD_RL2,
          f'(a) step on the card vs the CPU ({len(few)} molecules x 4 '
          f'conformers, N={b_gpu.xyz.shape[0]}, dropout off): loss '
          f'{l_gpu:.6e} vs {l_cpu:.6e} (rtol {STEP_LOSS_RTOL}); worst '
          f'gradient relative L2 {worst[0]:.3e} ({worst[1]}; tol '
          f'{STEP_GRAD_RL2}) over {len(g_cpu)} tensors; CPU step '
          f'{cpu_s:.1f} s')

    # (b) ten steps at the default config with its dropout
    w = weights(batch.num_mols, 'cuda')
    model = perturbed_model(torch, make_model, cfg).cuda()
    opt = make_optimizer()
    step = make_train_step(model, opt)
    gen = torch.Generator().manual_seed(7)
    step(batch, w, TRAIN_LR, gen)                      # warm-up
    torch.cuda.synchronize()
    counters = (fused_gnn_block, fused_transformer_block, fused_symmetriser)
    want = {'fused_gnn_block': (7, 7), 'fused_transformer_block': (12, 12),
            'fused_symmetriser': (4, 4)}
    launches = {c.__name__: [0, 0] for c in counters}
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(10):
        for c in counters:
            c.launches = c.bwd_launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, _ = step(batch, w, TRAIN_LR, gen)
        end.record()
        torch.cuda.synchronize()
        got = {c.__name__: (c.launches, c.bwd_launches) for c in counters}
        for name, (nf, nb) in got.items():
            launches[name][0] += nf
            launches[name][1] += nb
        losses.append(float(loss))
        step_ms.append(start.elapsed_time(end))
        check(got == want and np.isfinite(losses[-1]),
              f'(b) step {i}: loss {losses[-1]:.6e}, forward / backward '
              f'launches {got} (7/7, 12/12, 4/4), {step_ms[-1]:.2f} ms')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'(b) 10 steps, {batch.num_mols} molecules x {TRAIN_CONFS} '
          f'conformers: step median {np.median(step_ms):.2f} ms (CUDA '
          f'events; all: {", ".join(f"{t:.2f}" for t in step_ms)}); peak '
          f'memory {peak:.2f} GiB (max_memory_allocated)', flush=True)

    # where a step's time goes: the same calls as make_train_step, with an
    # event between forward, MM energy + dE/dx + loss, backward, optimizer
    params = dict(model.named_parameters())
    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        model.train()
        pred = model(batch, generator=gen)
        ev[1].record()
        loss, _ = molwise_loss(batch, pred, w)
        ev[2].record()
        grads = torch.autograd.grad(loss, list(params.values()))
        ev[3].record()
        opt.step(params, list(grads), TRAIN_LR)
        ev[4].record()
        torch.cuda.synchronize()
        splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    med = np.median(np.asarray(splits), axis=0)
    print(f'(b) step split, median of 3 (CUDA events): forward '
          f'{med[0]:.2f} ms, MM energy + dE/dx + loss {med[1]:.2f} ms, '
          f'backward {med[2]:.2f} ms, optimizer {med[3]:.2f} ms', flush=True)

    # (c) twenty steps without dropout on the 8-molecule batch
    small = perturbed_model(torch, make_model, no_drop).cuda()
    step_c = make_train_step(small, make_optimizer())
    w8 = weights(b_gpu.num_mols, 'cuda')
    first = last = None
    for i in range(20):
        loss, _ = step_c(b_gpu, w8, OVERFIT_LR, gen)
        last = float(loss)
        first = last if first is None else first
    check(np.isfinite(last) and last < first,
          f'(c) 20 steps at lr {OVERFIT_LR}, dropout off, 8 molecules: '
          f'loss {first:.6e} -> {last:.6e}')
    return launches




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

    phase('4. training kernels against their plain versions (the 128 x 32 '
          'training batch\'s shapes)')
    graphs = training_batches(torch)
    train_batch = collate(graphs, bucketed_pad_spec(graphs, TRAIN_CONFS),
                          TRAIN_CONFS, device='cuda')
    print('training batch, padded: N=%d, conformers %d, T bonds / angles / '
          'propers / impropers = %s' % (
              train_batch.xyz.shape[0], train_batch.xyz.shape[1],
              ' / '.join(str(train_batch.terms[t].idxs.shape[0])
                         for t in ('n2', 'n3', 'n4', 'n4_improper'))),
          flush=True)
    training_kernel_phase(torch, train_batch, entries)

    phase('5. training steps, default config')
    train_launches = training_phase(torch, graphs, train_batch, cfg)
    for name, (nf, nb) in train_launches.items():
        launches[name]['train'] = nf
        launches[f'{name}.backward'] = {'train': nb}

    if FAILURES:
        print(f'chip_smoke.py: {len(FAILURES)} check(s) failed',
              file=sys.stderr)
        return 1

    csrc, tpu = 'grappa_tpu_torch/csrc/', 'grappa_tpu/ops/'
    sources = {
        'fused_gnn_block': ('fused_gnn.cu', 'fused_gnn.py:271'),
        'fused_gnn_block.backward': ('fused_gnn.cu', 'fused_gnn.py:323'),
        'fused_gnn.dropout_masks': ('dropout.cu', 'fused_gnn.py:369'),
        'fused_transformer_block': ('fused_block.cu', 'fused_block.py:379'),
        'fused_transformer_block.backward': ('fused_block.cu',
                                             'fused_block.py:421'),
        'fused_block.dropout_masks': ('dropout.cu', 'fused_block.py:465'),
        'fused_symmetriser': ('fused_symmetriser.cu',
                              'fused_symmetriser.py:174'),
        'fused_symmetriser.backward': ('fused_symmetriser.cu',
                                       'fused_symmetriser.py:199')}
    kernels = []
    for name, (source, replaces) in sources.items():
        e = entries[name]
        b_ms, b_by = bound(e['flops'], e['nbytes'])
        per_path = launches.get(name, {})
        kernels.append(dict(
            name=name, route='cuda', source=csrc + source,
            replaces=tpu + replaces, status='ported',
            launches=sum(per_path.values()), launches_per_path=per_path,
            max_abs_err=e['max_abs_err'], ms=e['ms'],
            plain_ms=e['plain_ms'], bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
