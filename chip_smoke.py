#!/usr/bin/env python3
"""Smoke run of grappa_tpu_torch (the PyTorch / CUDA port) on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1, 2 and 4 alone
    python3 chip_smoke.py --torsion        # phase 1 and the K5 path's times
    python3 chip_smoke.py --trainrun       # phases 1 and 8 alone
    python3 chip_smoke.py --train-step     # phases 1 and 5 alone

Phases, each printing its own lines:
  1. device: the card's name and power limit, the torch / CUDA versions;
     builds the hand-written kernels from grappa_tpu_torch/csrc and times it.
  2. kernels: each CUDA kernel against its plain PyTorch version on the same
     seeded inputs at the shapes the serving path gives it in both
     workloads of phase 3 and at the shapes of phase 8's train, validation
     and test batches (one of each from the loaders do_trainrun builds from
     phase 8's dataset, made here), with the error, the kernel / plain
     times and the card's bound.
  3. predict_many at the default model's full width (7 x 512 GNN, depth-3 x
     512 heads) on seeded non-zero weights, on two paths: 32 small
     molecules, then a 1224-atom protein-like molecule. Checks that every
     output is finite, that each path's forward launched the kernels
     7 / 12 / 4 times (the counts are zeroed just before each path and read
     just after it), and that the outputs match the same model run on the
     CPU (the eager modules).
  4. training kernels at the training batch's shapes (the JAX package's
     128-molecule x 32-conformer bench batch, rebuilt by the port's
     make_moldata) and at phase 8's train batch's: K1 / K2 forward with
     dropout at the default rates and K3 forward, K1b / K2b / K3b against
     autograd through the plain versions (same dropout seeds), the K1m /
     K2m mask dumps (bench batch alone) bit-equal to the plain Philox,
     with times, device times and bounds. Then the
     `block_profile` line: K2 / K2b at the n4 training shape (S=4,
     T=8256, F=hid=512, dropout 0.5), K1 / K1b at the training batch's
     nodes (N=3376, dropout 0.3) and K3 / K3b at the n4 training shape
     under torch.profiler, each launch of one call with its device ms and
     share (printed above the line) and the device ms by kernel name,
     beside one torch.matmul
     (fp32, TF32 off) of K2's largest product, 33024 x 1536 x 512, a
     yardstick the port never calls.
  5. training at the default config: (a) one step on the card against the
     same step on the CPU (plain path), dropout off, 8 molecules x 4
     conformers; (b) ten steps with the config's dropout on the 128 x 32
     batch (QM-phase loss weights, lr 1.5e-5): finite losses, 7 / 12 / 4
     forward and 7 / 12 / 4 backward launches per step (counts zeroed
     before each step), the step's time split, peak memory and the
     device's idle share in a step (torch.profiler); (c) twenty
     steps without dropout at lr 1e-4 on the 8-molecule batch must lower
     the loss.
  6. the torsion kernel K5, its backward K5b and the paths that use
     energies and forces: (a) K5 and K5b against their plain versions at
     the training batch's propers / impropers (C=32), a 12,000- and a
     40,000-atom molecule's (C=4) and benchmarks/kernel_bench.py's (4096,
     32) and (16384, 128), with degenerate tuples and zeroed k rows: K5's
     energies, K5b's dpos and dk against the plain vjp
     (`reference_torsion_energy_grad`), autograd through both against
     autograd through the plain version, the device time of each
     (torch.profiler); (b) benchmarks/
     fusion_decision.py's measurement at 12,000 and 40,000 atoms x 4
     conformers with the default model's predicted parameters:
     energy_and_gradient with use_fused_torsion=True against the plain
     path on the card (2 K5 and 2 K5b launches per fused call, 0 / 0
     plain), the proper / improper energies per tuple and pooled (K5's
     output itself: the total is mostly bond energy), and the stage
     times, the CUDA kernels one call of each path launches and K5's host
     time a call on the path's propers, printed as `fusion_decision {...}`
     lines; (c) the fused energy, dE/dx and torsion energies at 12,000
     atoms with the batch's reference parameters, card vs CPU; (d)
     StreamingEvaluator on the training batch, card (K5 / K5b) vs CPU.
  7. MD with the batches' reference parameters: (a) 50 NVE steps, card vs
     CPU; (b) at 12,000 atoms x 4 replicas: minimize lowers the energy,
     then from the minimum NVE at 0.2 fs conserves the total energy and
     BAOAB at 300 K reaches (3N/2) kT within 10%; ms a step, peak memory.
  8. the training run at the default width: (a) do_trainrun from a dataset
     directory the port's Dataset.save wrote (make_dataset: 80 molecules x
     32 conformers, 8-43 atoms; partition 0.8 / 0.1 / 0.1, batches 32 /
     32 / 1, lr 1.5e-5, start_qm_epochs 1, warmup 3 steps, 3 epochs, a
     checkpoint every epoch, written asynchronously, test_model on):
     finite losses; the K1-K3 / K1b-K3b launches its 6 steps, 3 validation
     passes of 1 batch, 8 test molecules and the smoke test imply (18
     forwards, 6 backwards); best.ckpt and last.ckpt pass
     _verify_checkpoint; model.npz reloaded through Grappa.from_model_dict
     predicts what the Trainer's best weights predict;
     resume_trainrun(extra_epochs=1) ends at epoch 4; then writer-free
     epochs of the resumed Trainer: their steady train steps/s and its
     spread, each epoch's loader wait, host ms of the steps and loss fetch,
     beside the same with a wait for the card before each step and over
     the batch cache (`steady_epochs`), the device idle share of two
     epochs under torch.profiler, and Trainer.validate (a fetch a batch)
     against one fetch for the pass over the 8 test batches (metrics at
     VAL_RTOL); the `trainrun`
     line (the run's epoch wall times and steps/s on the host clock,
     those steady numbers, the time the Trainer waited on the loader,
     validation, test-evaluation and checkpoint-write ms, peak memory,
     and whether the native pre-processing ran).
     (b) the same run without dropout on 8 molecules x 4 conformers (train
     batches of 3), 2 epochs, on the card and on the CPU: the first step's
     loss at rtol 1e-4, the later losses and the validation metrics at
     TRAINRUN_RTOL.

The `trainrun {...}` line comes before the last three lines, which are a
JSON object describing the kernels, the card's name and power limit, and
{"ok": true, "device": {...}}. In the kernels'
line, `launches` sums the main paths (the two predict paths and the ten
training steps and phase 8's training run for K1-K3; phase 6's four
paths for K5 and K5b;
`launches_per_path` gives each), and `ms`, `plain_ms`, `bound_ms`,
`gflop` and `mbytes` sum one call at each shape of each path; K1-K3 and
K1b-K3b also give `bound_tc_ms` (3 x their FLOPs at the 495 TFLOP/s TF32
peak: the bound of 3xTF32 products, as every product of theirs runs);
K5, K5b and the mask dumps `device_ms` (torch.profiler). The mask dumps'
bound counts their Philox work from the kernel's SASS (cuobjdump): the
SM clocks its instructions take an element on the busiest of the FMA
pipe (integer multiply-adds, 64 a clock), the ALU pipe (the other
integer instructions, 64 a clock) and issue (every instruction, 128 a
clock), over the card's SM clocks (`g_sm_clocks`), against their
stores. Any failure exits non-zero before those lines. `--kernels-only` stops after phase 4 and prints the kernels' sums as a
`kernel_times` line instead; `--trainrun` runs phase 8 alone and
`--train-step` phase 5 alone (with names a parent checkout shares, so that
one copy of this script times the step of both); `--torsion` prints only
K5's host time by
part at the propers' shapes (`k5_host` lines) and the energy + dE/dx
path's times and kernels (`torsion_path_phase`), with names a parent
checkout shares, so that one copy of this script times both. Needs one CUDA device; imports nothing of JAX or
of grappa_tpu.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (H100 SXM): fp32 outside the tensor cores,
# dense TF32 on the tensor cores, HBM bandwidth; a card set below 700 W runs
# below them
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# the issue rates of an SM of compute capability 9.0 (132 of them, at the
# card's maximum SM clock as nvidia-smi reads it, `clocks.max.sm`), in
# thread instructions a clock: 32-bit integer multiply-adds run on the FMA
# pipe at 64, the other integer instructions (add, logic, compare, select,
# shift) on the ALU pipe at 64, beside each other; the four schedulers
# issue 128 instructions of any kind (the CUDA programming guide's
# throughput table)
INT_OPS_PER_CLOCK_SM, ISSUE_PER_CLOCK_SM, SMS = 64, 128, 132
INT_FMA_OPCODES = ('IMAD', 'IMUL')
INT_ALU_OPCODES = ('IADD3', 'IADD', 'LOP3', 'LOP', 'ISETP', 'SHF', 'SHL',
                   'SHR', 'LEA', 'SEL', 'IABS', 'IMNMX', 'VIADD', 'VIMNMX',
                   'PRMT', 'FLO', 'POPC', 'BMSK', 'BREV')
# kernels made of float32 products: their line also gives the bound of 3
# TF32 products per float32 product on the tensor cores, as every product
# of theirs runs (tc_gemm.cuh)
TENSOR_CORE_KERNELS = ('fused_transformer_block',
                       'fused_transformer_block.backward',
                       'fused_gnn_block.backward',
                       'fused_symmetriser.backward',
                       'fused_gnn_block', 'fused_symmetriser')

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
# dE/dx through K5 vs the plain path (or the card vs the CPU): max |err| <=
# FORCE_RTOL x max |dE/dx| (float32 sums of bond terms in another order)
FORCE_RTOL = 1e-4
# benchmarks/fusion_decision.py's protein scales: make_moldata(seed=0,
# n_confs=4, n_atoms=...), one molecule
FUSION_ATOMS, FUSION_CONFS = (12000, 40000), 4
# K5 at the JAX package's benchmarks/kernel_bench.py shapes (T, C), P = 6
KERNEL_BENCH_TC = ((4096, 32), (16384, 128))
# the propers' (T, C) on phase 6's paths (padded T of the training batch
# and of the 12,000- and 40,000-atom molecules): `--torsion`'s shapes
K5_HOST_SHAPES = (('train propers', 8256, 32),
                  ('12000-atom propers', 20096, 4),
                  ('40000-atom propers', 66304, 4))
# phase 8: the training run's dataset (the port's make_dataset) and the
# card-vs-CPU run's later losses and validation metrics. A step's gradients
# on the card and on the CPU agree to STEP_GRAD_RL2, but Adam normalises
# every entry, so an entry whose gradient is near 0 moves by about +-lr in
# the direction the rounding on each device picks; after 4 steps at lr
# 1.5e-5 the losses and metrics may part by more than one step's 1e-4
TRAINRUN_MOLS, TRAINRUN_CONFS, TRAINRUN_ATOMS = 80, 32, (8, 44)
TRAINRUN_RTOL = 2e-3
# two validation passes of the same weights on the card: dE/dx's scatter
# sums run in another order each time, a few float32 ulps of each metric
VAL_RTOL = 1e-5
REF_FIELDS = {'n2_k': ('n2', 'k_ref'), 'n2_eq': ('n2', 'eq_ref'),
              'n3_k': ('n3', 'k_ref'), 'n3_eq': ('n3', 'eq_ref'),
              'n4_k': ('n4', 'k_ref'),
              'n4_improper_k': ('n4_improper', 'k_ref')}

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


def profiled_ms(torch, fn, kernel, iters=20, tries=3):
    """Mean device ms a call of the CUDA kernels whose name holds
    `kernel`, from a torch.profiler trace of `iters` calls; a trace that
    holds none of them is taken again, up to `tries` traces, and a line
    says so. None when the profiler cannot trace the card or no trace
    shows device time for them."""
    for n in range(1, tries + 1):
        ms = sum(m for name, m in device_events(torch, fn, iters) or ()
                 if kernel in name) / iters
        if ms or n == tries:
            break
    if n > 1:
        print(f'  torch.profiler: {n} traces of {kernel} taken, ' + (
            f'the first {n - 1} without its events' if ms
            else 'none with its events'), flush=True)
    return ms or None


def short_kernel_name(name):
    """A kernel's name without `void`, namespaces and its argument list
    (its template arguments stay: they tell the GEMM's products apart)."""
    name = name.replace('(anonymous namespace)::', '').replace('void ', '', 1)
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == '<') - (ch == '>')
        if ch == '(' and depth == 0:
            return name[:i]
    return name


def device_events(torch, fn, iters):
    """Every CUDA kernel of `iters` calls of fn(), in launch order, as (name,
    device ms) from a torch.profiler trace; None when the profiler cannot
    trace the card."""
    from torch.profiler import ProfilerActivity, profile, supported_activities
    if ProfilerActivity.CUDA not in supported_activities():
        return None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if str(getattr(e, 'device_type', '')).endswith('CUDA')),
                    key=lambda e: e.time_range.start)
    return [(short_kernel_name(e.name), e.time_range.elapsed_us() / 1e3)
            for e in events]


def idle_share(torch, fn, reps=3):
    """Each of `reps` calls of fn() under torch.profiler, after one that is
    not kept: its wall ms (host clock from the call to the end of a
    synchronize), the union of its kernels' device intervals (overlaps
    counted once) in ms, the idle share 1 - busy / wall and the number of
    kernels; None when the profiler cannot trace the card."""
    from torch.profiler import ProfilerActivity, profile, supported_activities
    if ProfilerActivity.CUDA not in supported_activities():
        return None
    runs = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        spans = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if str(getattr(e, 'device_type', '')).endswith('CUDA')
            and not e.name.startswith(('Memcpy', 'Memset')))
        busy, end = 0.0, float('-inf')
        for a, b in spans:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        runs.append((wall, busy / 1e3, 1 - busy / 1e3 / wall, len(spans)))
    return runs[1:]


def block_profile(torch, batch, iters=3):
    """The kernels' launches under torch.profiler, each launch of one call
    with its device ms and the device ms by kernel name: K2 and K2b at the
    n4 training shape (S=4, T=8256, F=hid=512, 8 heads, dropout 0.5), K1
    and K1b at the training batch's nodes and neighbour list (F=512, 16
    heads, dropout 0.3), K3 and K3b at the n4 training shape (2
    permutations, 3 x 256, out 12). Beside them one torch.matmul (float32,
    TF32 off) of K2's largest product, 33024 x 1536 x 512, as a yardstick
    the port never calls."""
    from grappa_tpu_torch.models.heads import PERMUTATIONS
    from grappa_tpu_torch.ops import fused_block as fb
    from grappa_tpu_torch.ops import fused_gnn as fg
    from grappa_tpu_torch.ops import fused_symmetriser as fs
    gen = torch.Generator().manual_seed(2468)

    def backward_of(fn, inputs, dy):
        leaves = [q.detach().clone().requires_grad_(True) for q in inputs]
        y = fn(*leaves)
        return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)

    s, t, f, hid, rate, seed = 4, 8256, 512, 512, 0.5, 7
    x = torch.randn((s, t, f), generator=gen).cuda()
    p2 = rand_params(torch, gen, [
        ((f,), 'g'), ((f,), 'b'), ((3 * f, f), 'w'), ((3 * f,), 'b'),
        ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
        ((hid, f), 'w'), ((hid,), 'b'), ((f, hid), 'w'), ((f,), 'b')])
    k2 = lambda a, *q: fb.fused_transformer_block(a, q, 8, rate, True, seed)

    nb = batch.neighbors
    n, d = nb.shape
    feat = torch.randn((n, f), generator=gen).cuda()
    hn = torch.randn((n, f), generator=gen).cuda()
    nbr = feat[nb.t()].contiguous()
    mask = batch.neighbor_mask.t().float().contiguous()
    p1 = rand_params(torch, gen, [
        ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
        ((4 * f, f), 'w'), ((4 * f,), 'b'), ((f, 4 * f), 'w'), ((f,), 'b')])
    k1 = lambda a, b, c, *q: fg.fused_gnn_block(a, b, c, mask, q, 16, 0.3,
                                                True, 17)

    perms, width, out = PERMUTATIONS['n4'], 256, 12
    layers = [rand_params(torch, gen, [
        ((a,), 'g'), ((a,), 'b'), ((h, a), 'w'), ((h,), 'b'),
        ((o, h), 'w'), ((o,), 'b')]) for a, h, o in (
            (s * f, width, width), (width, width, width), (width, width, out))]
    flat = [q for layer in layers for q in layer]
    k3 = lambda a, *q: fs.fused_symmetriser(
        a, [q[6 * j:6 * j + 6] for j in range(3)], perms)

    calls = {'K2': lambda: k2(x, *p2),
             'K2b': backward_of(k2, [x, *p2], torch.randn_like(x)),
             'K1': lambda: k1(feat, nbr, hn, *p1),
             'K1b': backward_of(k1, [feat, nbr, hn, *p1],
                                torch.randn_like(feat)),
             'K3': lambda: k3(x, *flat),
             'K3b': backward_of(k3, [x, *flat],
                                torch.randn((t, out), device='cuda'))}
    out_line = {'n4': [s, t, f, hid], 'n4_dropout': rate, 'gnn_nodes': n,
                'gnn_slots': d, 'gnn_dropout': 0.3,
                'symmetriser': [len(perms), width, out]}
    for label, fn in calls.items():
        events = device_events(torch, fn, iters)
        if not events or len(events) % iters:
            out_line[label] = 'not measured (no device time in a '\
                              'torch.profiler trace)'
            continue
        n_launch = len(events) // iters      # the launches of one call
        kernels = [(events[i][0],
                    sum(events[i + j * n_launch][1]
                        for j in range(iters)) / iters)
                   for i in range(n_launch)]
        total = sum(ms for _, ms in kernels)
        by_name = {}
        for name, ms in kernels:
            key = name.split('<')[0]
            by_name[key] = by_name.get(key, 0.0) + ms
        out_line[label] = {'device_ms': total, 'launches': len(kernels),
                           'by_kernel': {k: [v, v / total] for k, v in sorted(
                               by_name.items(), key=lambda kv: -kv[1])}}
        for i, (name, ms) in enumerate(kernels):
            print(f'  {label} #{i:02d} {ms:8.4f} ms {100 * ms / total:5.1f}%'
                  f'  {name[:150]}')
    a = torch.randn((s * t, f), generator=gen).cuda()
    b = torch.randn((f, 3 * f), generator=gen).cuda()
    mm_ms = timed(torch, lambda: torch.matmul(a, b), iters=20)
    out_line['matmul_33024x1536x512'] = {
        'ms': mm_ms, 'tflops': 2 * s * t * 3 * f * f / mm_ms / 1e9,
        'allow_tf32': torch.backends.cuda.matmul.allow_tf32}
    print('block_profile ' + json.dumps(out_line), flush=True)


def enqueue_ms(torch, fn, calls=200):
    """Host ms a call of fn() when the host never waits (the launch rate
    the host can sustain)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
    t_ops, t_mem = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ('operations' if t_ops >= t_mem
                                     else 'bytes')


def sm_clock_rate():
    """SM clocks a second over the card: its SMs times its maximum SM
    clock."""
    mhz = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        timeout=60).stdout.split()[0]
    return SMS * float(mhz) * 1e6


def issue_clocks(opcodes):
    """The least SM clocks one thread's instructions take on an SM: the
    busiest of its FMA pipe (integer multiply-adds), its ALU pipe (the
    other integer instructions) and its schedulers (every instruction);
    with the instructions counted for each."""
    base = [op.split('.')[0] for op in opcodes]
    n = dict(fma=sum(op in INT_FMA_OPCODES for op in base),
             alu=sum(op in INT_ALU_OPCODES for op in base), all=len(base))
    return max(n['fma'] / INT_OPS_PER_CLOCK_SM,
               n['alu'] / INT_OPS_PER_CLOCK_SM,
               n['all'] / ISSUE_PER_CLOCK_SM), n


def sass_opcodes(so, kernel):
    """The opcodes of `kernel`'s SASS in the built library (cuobjdump
    -sass), padding NOPs and the branch to itself after the last EXIT
    (never issued) left out; None when its output lacks the kernel."""
    from grappa_tpu_torch.ops import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', str(so)], capture_output=True,
                          text=True, timeout=300).stdout
    m = re.search(r'Function : (\S*' + kernel + r'\S*)\n(.*?)'
                  r'(?=\n\s*Function :|\Z)', sass, re.S)
    if not m:
        return None
    ops = re.findall(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?'
                     r'([A-Z][A-Z0-9_.]*)', m.group(2))
    ops = [op for op in ops if op != 'NOP']
    return ops[:len(ops) - ops[::-1].index('EXIT')] if 'EXIT' in ops else ops


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


def accumulate(entries, name, max_abs, ms, plain_ms, flops, nbytes,
               peak=PEAK_FP32_FLOPS, device_ms=False):
    """The JSON line sums one call at each shape of each path; `flops` are
    operations at `peak` a second (SM clocks of issue for the mask
    dump); `device_ms` is torch.profiler's (None: not measured; False:
    not asked for)."""
    e = entries.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                      flops=0.0, nbytes=0.0, peak=peak))
    e['max_abs_err'] = max(e['max_abs_err'], max_abs)
    e['ms'] += ms
    e['plain_ms'] += plain_ms
    e['flops'] += flops
    e['nbytes'] += nbytes
    if device_ms is not False:
        prev = e.get('device_ms', 0.0)
        e['device_ms'] = (None if prev is None or device_ms is None
                          else prev + device_ms)


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
                 flops, nbytes, record=True):
    """A backward kernel against autograd through the plain version on the
    same inputs (and dropout masks); times the backward alone (the forward
    graph is kept and its backward run again). record=False checks a
    backward that is no kernel of its own and keeps it out of `entries`."""
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
    if record:
        accumulate(entries, name, max_abs, ms, plain_ms, flops, nbytes)


def training_kernel_phase(torch, batches, entries):
    """Phase 4: the kernels at the shapes one training step gives them on
    each of `batches` (label -> batch), dropout on at the default rates;
    the mask dumps, off every main path, at the 'train' batch alone."""
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

    # the mask dump's integer work: each thread draws one element's two
    # masks in straight-line code, so every instruction of its SASS runs
    # once an element (a wide multiply counted once)
    from collections import Counter
    from grappa_tpu_torch.ops import _cuda
    opcodes = sass_opcodes(_cuda.build(), 'dropout_masks_kernel') or []
    clk, counts = issue_clocks(opcodes)
    check(counts['fma'] + counts['alu'] > 0,
          f'dropout_masks_kernel SASS: {counts["all"]} instructions an '
          f'element, {counts["fma"]} integer on the FMA pipe and '
          f'{counts["alu"]} on the ALU pipe: at least {clk:.4f} SM clocks '
          f'an element; ' + json.dumps(dict(Counter(opcodes).most_common())))
    clock_rate = sm_clock_rate()

    def mask_check(op, name, shape, rate, seed):
        call = lambda: op.dropout_masks(seed, shape, rate, device='cuda')
        m1, m2 = call()
        want = [philox.dropout_mask(seed, s, shape, rate, device='cuda')
                for s in (0, 1)]
        torch.cuda.synchronize()
        same = torch.equal(m1, want[0]) and torch.equal(m2, want[1])
        keep = float((m1 > 0).float().mean())
        n = m1.numel()
        sigma = np.sqrt(rate * (1 - rate) / n)
        ms = timed(torch, call)
        plain_ms = timed(torch, lambda: [
            philox.dropout_mask(seed, s, shape, rate, device='cuda')
            for s in (0, 1)])
        dev_ms = profiled_ms(torch, call, 'dropout_masks_kernel')
        nbytes = 2 * 4 * n
        b_ms, b_by = bound(n * clk, nbytes, clock_rate)
        share = ('not measured' if dev_ms is None
                 else f'{b_ms / dev_ms:.3f} of it')
        check(same and abs(keep - (1 - rate)) <= 4 * sigma,
              f'{name} {tuple(shape)} rate {rate}: bit-equal to the plain '
              f'Philox {same}, keep fraction {keep:.6f} (1 - rate = '
              f'{1 - rate}, 4 sigma = {4 * sigma:.2e}) kernel {ms:.4f} ms '
              f'plain {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: '
              f'{clk:.4f} SM clocks an element at '
              f'{clock_rate / 1e12:.4f} T SM clocks/s; stores alone '
              f'{nbytes / PEAK_BYTES * 1e3:.4f} ms)')
        print(f'  mask dump {tuple(shape)}: device '
              f'{"not measured" if dev_ms is None else f"{dev_ms:.4f} ms"}'
              f' a call (torch.profiler), restated bound {b_ms:.4f} ms '
              f'({b_by}), the bound {share}', flush=True)
        accumulate(entries, name, 0.0, ms, plain_ms, n * clk, nbytes,
                   peak=clock_rate, device_ms=dev_ms)

    for label, batch in batches.items():
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
        compare('fused_gnn_block', f'{label} N={n} D={d} dropout {rate1}',
                lambda: fg.fused_gnn_block(feat, nbr, hn, mask, p1, heads, rate1,
                                           True, seed1),
                lambda: fg.reference_gnn_block(feat, nbr, hn, mask, p1, heads,
                                               masks1),
                flops=fwd1, nbytes=4 * (in1 + n * f))
        dy1 = torch.randn((n, f), generator=gen).cuda()
        compare_grad(torch, entries, 'fused_gnn_block.backward',
                     f'{label} N={n} D={d} dropout {rate1}',
                     lambda a, b, c, *q: fg.fused_gnn_block(
                         a, b, c, mask, q, heads, rate1, True, seed1),
                     lambda a, b, c, *q: fg.reference_gnn_block(
                         a, b, c, mask, q, heads, masks1),
                     [feat, nbr, hn, *p1], dy1, flops=2 * fwd1,
                     nbytes=4 * (2 * in1 - d * n + n * f))
        if label == 'train':
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
            compare('fused_transformer_block', f'{label} S={s} T={t} dropout '
                    f'{rate2}',
                    lambda: fb.fused_transformer_block(x, p2, 8, rate2, True,
                                                       seed2),
                    lambda: fb.reference_block(x, p2, 8, masks2),
                    flops=fwd2, nbytes=4 * (in2 + r * f))
            compare_grad(torch, entries, 'fused_transformer_block.backward',
                         f'{label} S={s} T={t} dropout {rate2}',
                         lambda a, *q: fb.fused_transformer_block(
                             a, q, 8, rate2, True, seed2),
                         lambda a, *q: fb.reference_block(a, q, 8, masks2),
                         [x, *p2], torch.randn_like(x), flops=2 * fwd2,
                         nbytes=4 * (2 * in2 + r * f))
            if term == 'n4' and label == 'train':
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
            compare('fused_symmetriser', f'{label} S={s} T={t} perms={len(perms)}',
                    lambda: fs.fused_symmetriser(x, layers, perms),
                    lambda: fs.reference_symmetriser(x, layers, perms),
                    flops=fwd3, nbytes=4 * (in3 + t * out))
            compare_grad(torch, entries, 'fused_symmetriser.backward',
                         f'{label} S={s} T={t} perms={len(perms)}',
                         lambda a, *q: fs.fused_symmetriser(a, split(q), perms),
                         lambda a, *q: fs.reference_symmetriser(a, split(q),
                                                                perms),
                         [x, *flat], torch.randn((t, out), device='cuda'),
                         flops=2 * fwd3, nbytes=4 * (2 * in3 + t * out))


def loss_weights(torch, m, device):
    """The QM-phase loss weights, the parameter weight per molecule."""
    from grappa_tpu_torch.train.loss import LossWeights
    return LossWeights(**dict(QM_WEIGHTS, param=torch.full(
        (m,), QM_WEIGHTS['param'], device=device)))


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
    from grappa_tpu_torch.train.loss import molwise_loss
    from grappa_tpu_torch.train.trainer import (loss_gradients,
                                                make_optimizer,
                                                make_train_step)

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
    l_cpu, _, g_cpu = loss_gradients(
        cpu_model, b_cpu, loss_weights(torch, b_cpu.num_mols, 'cpu'))
    cpu_s = time.time() - t0
    l_gpu, _, g_gpu = loss_gradients(
        gpu_model, b_gpu, loss_weights(torch, b_gpu.num_mols, 'cuda'))
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
    w = loss_weights(torch, batch.num_mols, 'cuda')
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
    # how much of a step the card spends idle, waiting on the host
    runs = idle_share(torch, lambda: step(batch, w, TRAIN_LR, gen))
    print('(b) step device idle share (torch.profiler, 3 steps): ' + (
        'not measured (no device time in a torch.profiler trace)'
        if runs is None else f'median {np.median([r[2] for r in runs]):.4f}; '
        + '; '.join(
            f'wall {wall:.2f} ms, kernels busy {busy:.2f} ms (union of '
            f'{n} kernels\' device intervals), idle share {idle:.4f}'
            for wall, busy, idle, n in runs)), flush=True)

    # (c) twenty steps without dropout on the 8-molecule batch
    small = perturbed_model(torch, make_model, no_drop).cuda()
    step_c = make_train_step(small, make_optimizer())
    w8 = loss_weights(torch, b_gpu.num_mols, 'cuda')
    first = last = None
    for i in range(20):
        loss, _ = step_c(b_gpu, w8, OVERFIT_LR, gen)
        last = float(loss)
        first = last if first is None else first
    check(np.isfinite(last) and last < first,
          f'(c) 20 steps at lr {OVERFIT_LR}, dropout off, 8 molecules: '
          f'loss {first:.6e} -> {last:.6e}')
    return launches


def ref_params(torch, batch):
    """The batch's reference parameters, NaNs (padding) zeroed."""
    return {key: torch.nan_to_num(getattr(batch.terms[t], field))
            for key, (t, field) in REF_FIELDS.items()}


def distinct_quads(torch, gen, n_atoms, t):
    """(T, 4) indices of four distinct atoms each (two equal atoms would
    make a near-degenerate tuple whose phi is rounding noise)."""
    step = max(1, n_atoms // 4)
    i0 = torch.randint(0, n_atoms, (t, 1), generator=gen)
    gaps = torch.randint(1, step, (t, 3), generator=gen)
    offs = torch.cat([torch.zeros((t, 1), dtype=gaps.dtype),
                      gaps.cumsum(1)], 1)
    return (i0 + offs) % n_atoms


def k5_host_us(torch, tk, pos, k, calls=2000):
    """Where K5's wrapper spends its host time: us a call (host clock over
    `calls` calls, no synchronize) of the whole wrapper without and with a
    graph to build, and of its parts (the shape checks, `on_cuda`, the
    autograd Function, the launch and, within it, the output's allocation,
    the stream handle and the ctypes call). Reads the module's internals
    under the names both this tree and its parent give them."""
    from grappa_tpu_torch.ops import _cuda
    t, _, _, c = pos.shape
    pos_g = pos.detach().requires_grad_(True)
    lib, stream = _cuda.lib(), _cuda.stream_of(pos)
    out = tk.torsion_energy_fused(pos, k)
    check_args = (pos, k, 'x')[:tk._check.__code__.co_argcount]
    parts = {
        'wrapper': lambda: tk.torsion_energy_fused(pos, k),
        'wrapper_graph': lambda: tk.torsion_energy_fused(pos_g, k),
        'check': lambda: tk._check(*check_args),
        'on_cuda': lambda: _cuda.on_cuda((pos, k), 'x'),
        'function_apply': lambda: tk.TorsionEnergy.apply(pos_g, k),
        'launch': lambda: tk._launch(pos, k),
        'torch_empty': lambda: torch.empty((t, c), dtype=torch.float32,
                                           device=pos.device),
        'stream_of': lambda: _cuda.stream_of(pos),
        'ctypes_call': lambda: lib.grappa_torsion_energy(
            pos.data_ptr(), k.data_ptr(), out.data_ptr(), t, c,
            k.shape[1], stream)}
    before = tk.torsion_energy_fused.launches
    res = {name: enqueue_ms(torch, fn, calls) * 1e3
           for name, fn in parts.items()}
    tk.torsion_energy_fused.launches = before
    return res


def torsion_path_phase(torch):
    """`--torsion`: K5's wrapper host time by part at the propers' shapes
    of phase 6 (the training batch's, the 12,000- and 40,000-atom
    molecules'), on seeded positions; then energy + dE/dx at 12,000 and
    40,000 atoms x 4 conformers with the reference parameters, with and
    without use_fused_torsion: ms a call (CUDA events over 10 calls) and
    the CUDA kernels of one call (`torsion_path` lines). Drives only names
    that this tree and its parent share, so a copy of this script times
    the parent."""
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.synthetic import make_moldata
    from grappa_tpu_torch.models import mm_energy
    from grappa_tpu_torch.ops import torsion_kernel as tk
    gen = torch.Generator().manual_seed(556)
    for label, t, c in K5_HOST_SHAPES:
        xyz = 2.0 * torch.randn((t // 2, c, 3), generator=gen)
        idxs = distinct_quads(torch, gen, t // 2, t)
        pos = tk.gather_torsion_positions(xyz.cuda(), idxs.cuda())
        k = (0.5 * torch.randn((t, 6), generator=gen)).cuda()
        print(f'  k5_host {label}: ' + json.dumps(
            k5_host_us(torch, tk, pos, k)), flush=True)
    for n_atoms in FUSION_ATOMS:
        batch = collate([MolGraph.from_moldata(make_moldata(
            seed=0, n_confs=FUSION_CONFS, n_atoms=n_atoms))])
        params = ref_params(torch, batch)
        res = {'n_atoms': n_atoms, **energy_path_times(
            torch, lambda: mm_energy.energy_and_gradient(batch, params),
            lambda: mm_energy.energy_and_gradient(
                batch, params, use_fused_torsion=True))}
        print('torsion_path ' + json.dumps(res), flush=True)


def torsion_kernel_phase(torch, entries, shapes):
    """Phase 6(a): K5 and K5b against their plain versions at each (T, C,
    P), with degenerate tuples (four equal atoms) and zeroed k rows: K5's
    energies, K5b's dpos and dk (each within GRAD_RTOL x max |plain|),
    and autograd through K5 / K5b against autograd through the plain
    version; both kernels' device time (torch.profiler)."""
    from grappa_tpu_torch.ops import torsion_kernel as tk
    gen = torch.Generator().manual_seed(555)
    for label, t, c, p, on_path in shapes:
        n_atoms = max(16, t // 2)
        xyz = 2.0 * torch.randn((n_atoms, c, 3), generator=gen)
        idxs = distinct_quads(torch, gen, n_atoms, t)
        idxs[::7] = idxs[::7, :1]                 # degenerate tuples
        k = 0.5 * torch.randn((t, p), generator=gen)
        k[::5] = 0.0                              # masked / padded rows
        g = torch.randn((t, c), generator=gen).cuda()
        pos = tk.gather_torsion_positions(xyz.cuda(), idxs.cuda())
        k = k.cuda()
        shape = f'{label} T={t} C={c} P={p}'
        call = lambda: tk.torsion_energy_fused(pos, k)
        compare_out(torch, entries, 'torsion_energy_fused', shape, call,
                    lambda: tk.reference_torsion_energy(pos, k),
                    flops=t * c * (60 + 5 * p),
                    nbytes=4 * (12 * t * c + t * p + t * c),
                    on_path=on_path)
        # the events above time back-to-back calls, which the host's
        # wrapper paces at small shapes: split the device's share out
        dev_ms = profiled_ms(torch, call, 'torsion_energy_kernel')
        print(f'  K5 {label}: device ' + (
            'not measured (no device time in a torch.profiler trace)'
            if dev_ms is None else f'{dev_ms * 1e3:.2f} us a launch '
            f'(torch.profiler)'), flush=True)
        if on_path:
            accumulate(entries, 'torsion_energy_fused', 0.0, 0.0, 0.0, 0, 0,
                       device_ms=dev_ms)

        # K5b: dpos and dk against the plain vjp; the main paths ask for
        # dpos alone (their parameters are detached)
        kernel = lambda need_k: tk.torsion_energy_grad(pos, k, g, need_k)
        plain = lambda need_k: tk.reference_torsion_energy_grad(pos, k, g,
                                                                need_k)
        got, want = kernel(True), plain(True)
        torch.cuda.synchronize()
        ok, errs = True, []
        for a, b in zip(got, want):
            err = float((a - b).abs().max())
            rel = err / max(float(b.abs().max()), 1e-30)
            ok &= bool(torch.isfinite(a).all()) and rel <= GRAD_RTOL
            errs.append((err, rel))
        zero = bool((got[0][::7] == 0).all())
        ms = timed(torch, lambda: kernel(False))
        ms_k = timed(torch, lambda: kernel(True))
        plain_ms = timed(torch, lambda: plain(False))
        dev_b = profiled_ms(torch, lambda: kernel(False),
                            'torsion_grad_kernel')
        flops, nbytes = t * c * (180 + 6 * p), 4 * (25 * t * c + t * p)
        b_ms, b_by = bound(flops, nbytes)
        device = ('not measured (no device time in a torch.profiler trace)'
                  if dev_b is None else f'{dev_b:.4f} ms')
        check(ok and zero,
              f'torsion_energy_grad {shape}: dpos max_abs_err '
              f'{errs[0][0]:.3e} (max|err|/max|plain| {errs[0][1]:.3e}), '
              f'dk {errs[1][0]:.3e} ({errs[1][1]:.3e}) (tol {GRAD_RTOL} x '
              f'max|plain|); degenerate tuples\' dpos 0: {zero}; kernel '
              f'{ms:.4f} ms ({ms_k:.4f} with dk), device {device}, plain '
              f'{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, '
              f'{nbytes / 1e6:.1f} MB)')
        if on_path:
            accumulate(entries, 'torsion_energy_grad', errs[0][0], ms,
                       plain_ms, flops, nbytes, device_ms=dev_b)
            compare_grad(torch, entries, 'torsion_energy_fused gradients',
                         f'{shape} (K5 and K5b through autograd)',
                         tk.torsion_energy_fused, tk.reference_torsion_energy,
                         [pos, k], g, flops=2 * t * c * (60 + 5 * p),
                         nbytes=4 * (2 * (12 * t * c + t * p) + t * c),
                         record=False)


def close_energy_gradient(torch, label, e, g, e_want, g_want):
    """Energies elementwise within MODEL_ATOL + MODEL_RTOL |E|, dE/dx
    within FORCE_RTOL x max |dE/dx|, all finite."""
    e, g, e_want, g_want = [x.detach().double().cpu()
                            for x in (e, g, e_want, g_want)]
    e_err = (e - e_want).abs()
    g_err = float((g - g_want).abs().max())
    g_max = float(g_want.abs().max())
    ok = (bool(torch.isfinite(e).all() and torch.isfinite(g).all())
          and bool((e_err <= MODEL_ATOL + MODEL_RTOL * e_want.abs()).all())
          and g_err <= FORCE_RTOL * g_max)
    check(ok, f'{label}: energies {tuple(e.shape)} max_abs_err '
              f'{float(e_err.max()):.3e} at |E| up to '
              f'{float(e_want.abs().max()):.4e} (tol {MODEL_ATOL} + '
              f'{MODEL_RTOL}|E|); dE/dx max_abs_err {g_err:.3e}, max|dE/dx| '
              f'{g_max:.4e} (tol {FORCE_RTOL} x max)')


def torsion_terms(torch, batch, params, fused):
    """The proper / improper energies a path computes from `params` at the
    batch's geometry: per tuple (T, C), pooled (M, C), and each molecule's
    sum of |tuple energy| (the pooled term's own scale), float64 on the
    host."""
    from grappa_tpu_torch.models import mm_energy
    with torch.no_grad():
        tup = mm_energy.tuple_energies(batch, params, batch.xyz,
                                       use_fused_torsion=fused)
        pooled = mm_energy.pooled_energy(batch, params, batch.xyz,
                                         use_fused_torsion=fused)
    return {t: [x.double().cpu() for x in (
        tup[t], pooled[f'energy_{t}'], mm_energy.segment_sum(
            tup[t].abs(), batch.terms[t].mol, batch.num_mols))]
            for t in mm_energy.TORSIONS}


def close_torsion_terms(torch, label, got, want):
    """K5's output on a path's own inputs: per tuple within KERNEL_ATOL +
    KERNEL_RTOL |e|, pooled within MODEL_ATOL + MODEL_RTOL x the sum of
    |e| over the molecule's tuples (the term's own scale: the total energy
    is dominated by the bond terms)."""
    for t in got:
        (e, pooled, _), (e_want, p_want, scale) = got[t], want[t]
        e_err, p_err = (e - e_want).abs(), (pooled - p_want).abs()
        ok = (bool(torch.isfinite(e).all() and torch.isfinite(pooled).all())
              and bool((e_err <= KERNEL_ATOL
                        + KERNEL_RTOL * e_want.abs()).all())
              and bool((p_err <= MODEL_ATOL + MODEL_RTOL * scale).all()))
        check(ok, f'{label}, {t}: per tuple {tuple(e.shape)} max_abs_err '
                  f'{float(e_err.max()):.3e} (tol {KERNEL_ATOL} + '
                  f'{KERNEL_RTOL}|e|); pooled {tuple(pooled.shape)} '
                  f'max_abs_err {float(p_err.max()):.3e} at |E_{t}| up to '
                  f'{float(p_want.abs().max()):.4e}, sum |e| up to '
                  f'{float(scale.max()):.4e} (tol {MODEL_ATOL} + '
                  f'{MODEL_RTOL} sum |e|)')


def k5_launches(torch, fn):
    """fn()'s result and the K5 and K5b launches it made (the counts are
    set to 0 just before and read just after)."""
    from grappa_tpu_torch.ops import torsion_kernel as tk
    tk.torsion_energy_fused.launches = tk.torsion_energy_grad.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, (tk.torsion_energy_fused.launches,
                 tk.torsion_energy_grad.launches)


def record_launches(launches, path, counts):
    """Adds a path's K5 / K5b launch counts to the kernels line's."""
    for name, n in zip(('torsion_energy_fused', 'torsion_energy_grad'),
                       counts):
        launches.setdefault(name, {})[path] = n


def cuda_kernels(torch, fn):
    """The CUDA kernels one call of fn() launches (torch.profiler, copies
    and fills left out); None when the profiler cannot trace the card."""
    events = device_events(torch, fn, 1)
    if events is None:
        return None
    return sum(not name.startswith(('Memcpy', 'Memset'))
               for name, _ in events)


def energy_path_times(torch, plain, fused):
    """energy_and_gradient's two paths: ms a call (CUDA events over 10
    calls) and the CUDA kernels one call launches."""
    return {'energy_forces_plain_ms': timed(torch, plain, iters=10),
            'energy_forces_fused_ms': timed(torch, fused, iters=10),
            'cuda_kernels_plain': cuda_kernels(torch, plain),
            'cuda_kernels_fused': cuda_kernels(torch, fused)}


def fusion_phase(torch, cfg, batches, launches):
    """Phase 6(b): benchmarks/fusion_decision.py's measurement at protein
    scale with the default model's predicted parameters: energy and dE/dx
    through K5 / K5b against the plain path on the card, the stage times,
    the CUDA kernels one call of each path launches and the host time of
    a K5 call on the path's own inputs."""
    from grappa_tpu_torch.models import mm_energy
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.ops import torsion_kernel as tk
    from grappa_tpu_torch.train.trainer import make_optimizer, make_train_step
    model = perturbed_model(torch, make_model, cfg).cuda()
    for n_atoms, batch in batches.items():
        model.eval()
        with torch.no_grad():
            pred = model(batch)
            fwd_ms = timed(torch, lambda: model(batch), iters=3, warmup=1)
        pred = {key: v.detach() for key, v in pred.items()}
        fused = lambda: mm_energy.energy_and_gradient(
            batch, pred, use_fused_torsion=True)
        plain = lambda: mm_energy.energy_and_gradient(batch, pred)
        (e_f, g_f), n_fused = k5_launches(torch, fused)
        (e_p, g_p), n_plain = k5_launches(torch, plain)
        record_launches(launches, f'fusion {n_atoms} atoms', n_fused)
        check(n_fused == (2, 2) and n_plain == (0, 0),
              f'{n_atoms} atoms: K5 / K5b launches per energy_and_gradient '
              f'call: fused {n_fused} (2, 2), plain {n_plain} (0, 0)')
        close_energy_gradient(torch, f'{n_atoms} atoms, predicted '
                              f'parameters, fused vs plain on the card',
                              e_f, g_f, e_p, g_p)
        close_torsion_terms(torch, f'{n_atoms} atoms, fused vs plain',
                            torsion_terms(torch, batch, pred, True),
                            torsion_terms(torch, batch, pred, False))
        res = {'n_atoms': n_atoms, 'n_confs': batch.xyz.shape[1],
               'n_padded': batch.xyz.shape[0],
               'n_propers': int(batch.terms['n4'].mask.sum()),
               'forward_ms': fwd_ms,
               **energy_path_times(torch, plain, fused)}
        # K5 as the fused path calls it: the propers, a graph to build
        tb = batch.terms['n4']
        xyz = batch.xyz.detach().requires_grad_(True)
        pos = tk.gather_torsion_positions(xyz, tb.idxs)
        k = torch.where(tb.mask[:, None], pred['n4_k'], 0.0)
        before = tk.torsion_energy_fused.launches
        res['k5_host_us'] = enqueue_ms(
            torch, lambda: tk.torsion_energy_fused(pos, k)) * 1e3
        tk.torsion_energy_fused.launches = before
        if n_atoms == min(batches):
            step = make_train_step(model, make_optimizer())
            w = loss_weights(torch, batch.num_mols, 'cuda')
            gen = torch.Generator().manual_seed(11)
            step(batch, w, TRAIN_LR, gen)                    # warm-up
            res['full_step_ms'] = timed(
                torch, lambda: step(batch, w, TRAIN_LR, gen), iters=3,
                warmup=0)
        print('fusion_decision ' + json.dumps(res), flush=True)


def evaluation_phase(torch, cfg, graphs, batch, big, launches):
    """Phase 6(c) and (d): the fused energy and dE/dx at protein scale with
    the batch's reference parameters, card vs CPU; StreamingEvaluator on
    the training batch with the default model's predictions, card (K5) vs
    CPU (plain path)."""
    from grappa_tpu_torch.data.graph_batch import collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.models import mm_energy
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.train.evaluator import (StreamingEvaluator,
                                                  early_stopping_loss)
    big_graphs, big_card = big
    big_cpu = collate(big_graphs, device='cpu')
    (e, g), n = k5_launches(torch, lambda: mm_energy.energy_and_gradient(
        big_card, ref_params(torch, big_card), use_fused_torsion=True))
    n_atoms = sum(gr.n_atoms for gr in big_graphs)
    record_launches(launches, f'reference {n_atoms} atoms', n)
    e_c, g_c = mm_energy.energy_and_gradient(
        big_cpu, ref_params(torch, big_cpu), use_fused_torsion=True)
    check(n == (2, 2), f'(c) K5 / K5b launches: {n} (2, 2)')
    close_energy_gradient(torch, f'(c) {n_atoms} atoms, reference '
                          f'parameters, fused, card vs CPU', e, g, e_c, g_c)
    close_torsion_terms(
        torch, f'(c) {n_atoms} atoms, fused, card vs CPU',
        torsion_terms(torch, big_card, ref_params(torch, big_card), True),
        torsion_terms(torch, big_cpu, ref_params(torch, big_cpu), True))

    model = perturbed_model(torch, make_model, cfg).cuda()
    model.eval()
    with torch.no_grad():
        pred = {key: v.detach() for key, v in model(batch).items()}
    names = [('spice', 'pepconf', 'rna')[i % 3] for i in range(len(graphs))]
    cpu_batch = collate(graphs, bucketed_pad_spec(graphs, TRAIN_CONFS),
                        TRAIN_CONFS, device='cpu')
    ev_card, ev_cpu = StreamingEvaluator(), StreamingEvaluator()

    def card_step():
        e, g = mm_energy.energy_and_gradient(batch, pred,
                                             use_fused_torsion=True)
        ev_card.step(batch, e, g, names)

    _, n = k5_launches(torch, card_step)
    record_launches(launches, 'evaluate', n)
    e, g = mm_energy.energy_and_gradient(
        cpu_batch, {key: v.cpu() for key, v in pred.items()})
    ev_cpu.step(cpu_batch, e, g, names)
    got, want = ev_card.pool(), ev_cpu.pool()
    worst = max(abs(got[d][key] - v) / max(abs(v), 1e-30)
                for d in want for key, v in want[d].items())
    finite = all(np.isfinite(v) for d in got.values() for v in d.values())
    check(n == (2, 2) and finite and got.keys() == want.keys()
          and worst <= 1e-4,
          f'(d) StreamingEvaluator, {batch.num_mols} molecules x '
          f'{TRAIN_CONFS} conformers, card (K5 / K5b, {n} launches) vs CPU '
          f'(plain path): worst relative difference {worst:.3e} (tol 1e-4); avg '
          f'{got["avg"]}; early_stopping_loss '
          f'{early_stopping_loss(got):.6e} vs {early_stopping_loss(want):.6e}')


def md_phase(torch, big):
    """Phase 7: MD on the card with the batches' reference parameters."""
    from grappa_tpu_torch import md
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.synthetic import make_moldata

    # (a) 50 NVE steps, card vs CPU, the same numpy-made velocities
    mdata = make_moldata(seed=3, n_confs=4, learnable=True, conf_noise=0.05)
    graphs = [MolGraph.from_moldata(mdata)]
    runs = {}
    for device in ('cuda', 'cpu'):
        b = collate(graphs, n_confs=4, device=device)
        masses = md.masses_from_molecules([mdata.molecule], b.xyz.shape[0],
                                          device=device)
        rng = np.random.default_rng(0)
        sigma = np.sqrt(md.KB * 300.0 / masses.cpu().numpy())[:, None, None]
        v0 = (sigma * rng.normal(size=tuple(b.xyz.shape))
              * b.node_mask.cpu().numpy()[:, None, None]).astype(np.float32)
        runs[device] = md.simulate(b, ref_params(torch, b), masses,
                                   dt_fs=0.5, n_steps=50,
                                   v0=torch.tensor(v0, device=device))
    pot, pot_cpu = runs['cuda']['potential'].cpu(), runs['cpu']['potential']
    err = (pot - pot_cpu).abs()
    check(bool(torch.isfinite(pot).all())
          and bool((err <= 1e-4 + 1e-4 * pot_cpu.abs()).all()),
          f'(a) NVE 50 steps at 0.5 fs, {len(mdata.molecule.atoms)} atoms x 4 '
          f'replicas, card vs CPU: potential max_abs_err '
          f'{float(err.max()):.3e} (tol 1e-4 + 1e-4|E|)')

    # (b) the 12,000-atom protein-scale molecule, 4 replicas
    (mdata, big_batch) = big
    n_atoms = len(mdata.molecule.atoms)
    masses = md.masses_from_molecules([mdata.molecule],
                                      big_batch.xyz.shape[0],
                                      device=big_batch.xyz.device)
    params = ref_params(torch, big_batch)
    force = md.make_force_fn(big_batch, params)
    torch.cuda.reset_peak_memory_stats()
    x_min = md.minimize(big_batch, params, n_steps=500, lr=5e-4)
    e0, e1 = force(big_batch.xyz)[1][0], force(x_min)[1][0]
    check(bool((e1 < e0).all()),
          f'(b) minimize, 500 steps at lr 5e-4: potential per replica '
          f'{[round(float(v), 1) for v in e0]} -> '
          f'{[round(float(v), 1) for v in e1]} kcal/mol')
    target = 1.5 * n_atoms * md.KB * 300.0
    v0 = md.maxwell_boltzmann_velocities(
        big_batch, masses, 300.0,
        torch.Generator(device='cuda').manual_seed(0))
    step_ms = {}
    for label, kwargs in (
            ('NVE', dict(dt_fs=0.2, n_steps=500, v0=v0)),
            ('BAOAB', dict(dt_fs=0.5, n_steps=1000, temperature=300.0,
                           friction_per_ps=20.0, seed=7))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = md.simulate(big_batch, params, masses, xyz0=x_min, **kwargs)
        end.record()
        torch.cuda.synchronize()
        step_ms[label] = start.elapsed_time(end) / kwargs['n_steps']
        ke = out['kinetic'][:, 0].double().cpu()            # (steps, C)
        if label == 'NVE':
            total = out['potential'][:, 0].double().cpu() + ke
            ratio = ((total - total[0]).abs().max(0).values
                     / ke.mean(0)).max()
            check(bool(torch.isfinite(total).all()) and float(ratio) < 0.05,
                  f'(b) NVE 500 steps at 0.2 fs from the minimum, 300 K '
                  f'velocities: max |E_tot drift| / mean KE over the 4 '
                  f'replicas {float(ratio):.3e} (< 0.05)')
        else:
            mean_ke = float(ke[300:].mean())
            check(bool(torch.isfinite(ke).all())
                  and abs(mean_ke / target - 1) < 0.1,
                  f'(b) BAOAB 1000 steps at 0.5 fs, 300 K, 20 / ps from the '
                  f'minimum: mean KE after step 300 {mean_ke:.1f} vs '
                  f'(3N/2) kT {target:.1f} kcal/mol (ratio '
                  f'{mean_ke / target:.4f}, within 10%)')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'(b) MD at {n_atoms} atoms x 4 replicas (N padded '
          f'{big_batch.xyz.shape[0]}): {step_ms["NVE"]:.3f} ms a step NVE, '
          f'{step_ms["BAOAB"]:.3f} ms a step BAOAB (CUDA events over the '
          f'run); peak memory {peak:.3f} GiB (max_memory_allocated)',
          flush=True)


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


def predict_phase(torch, cfg, smalls, protein, paths):
    """Phase 3: predict_many on both paths with the launch counts of each
    forward, its times, and the outputs against the same model on the CPU.
    Returns the launches per path."""
    from grappa_tpu_torch import Grappa
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    phase('3. predict_many, default config, seeded non-zero weights')
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
    return launches


def trainrun_config(default_config, data_dir):
    """default_config() at the default width, trained from `data_dir` with
    phase 8's settings."""
    cfg = default_config()
    cfg['data_config'].update(
        datasets=[data_dir], pure_train_datasets=[], pure_val_datasets=[],
        pure_test_datasets=[], weights={}, partition=[0.8, 0.1, 0.1],
        train_batch_size=32, val_batch_size=32, test_batch_size=1,
        conf_strategy=32)
    cfg['lit_model_config'].update(lr=TRAIN_LR, start_qm_epochs=1,
                                   warmup_steps=3)
    cfg['trainer_config'].update(max_epochs=3, checkpoint_every=1,
                                 async_checkpoints=True)
    cfg['test_model'] = True
    return cfg


def trainrun_data(torch, work):
    """Phase 8's dataset, saved under `work` (a directory .gitignore lists,
    deleted at exit), and the loaders do_trainrun builds from it: their
    first train batch, validation batch and test batches, on the card. The
    train batches are fixed-padded to the worst case of 32 molecules and
    the test batches to the worst single molecule, so these batches give
    the kernels every shape of the run."""
    import atexit
    import copy
    import shutil
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.synthetic import make_dataset
    from grappa_tpu_torch.train.config import default_config
    from grappa_tpu_torch.train.run import get_dataloaders
    shutil.rmtree(work, ignore_errors=True)
    atexit.register(shutil.rmtree, work, True)
    t0 = time.time()
    data_dir = os.path.join(work, 'data', 'synthetic')
    Dataset.from_moldata(make_dataset(
        n_mols=TRAINRUN_MOLS, n_confs=TRAINRUN_CONFS, seed=0,
        atom_range=TRAINRUN_ATOMS)).save(data_dir)
    made = time.time() - t0
    config = trainrun_config(default_config, data_dir)
    train, val, test, _ = get_dataloaders(
        copy.deepcopy(config['data_config']), device='cuda')
    batches = list(test)
    firsts = {'train': next(iter(train))[0], 'val': next(iter(val))[0],
              'test': batches[0][0]}
    for label, b in firsts.items():
        print(f'training run\'s {label} batch, padded: N=%d, molecules %d, '
              f'conformers %d, T bonds / angles / propers / impropers = %s'
              % (b.xyz.shape[0], b.num_mols, b.xyz.shape[1], ' / '.join(
                  str(b.terms[t].idxs.shape[0])
                  for t in ('n2', 'n3', 'n4', 'n4_improper'))), flush=True)
    check(len({b.shapes() for b, _ in batches}) == 1,
          f'training run: its {len(batches)} test batches share one '
          f'padded shape')
    return data_dir, made, firsts, batches


def steady_epochs(torch, trainer, epochs=3, rounds=2):
    """Writer-free epochs of a fitted Trainer: train_epoch alone, host
    clock to the end of its loss fetch, after one warm epoch. Variants,
    interleaved: 'loader' is the Trainer as it is; 'wait' the same with a
    wait for the card before each step (what the per-step copy of the loss
    weights from pageable memory, which the Trainer had before, cost);
    'cached' runs over its batch cache, without the loader's producer
    thread. Returns {variant: [(epoch ms, steps/s, loader wait ms, host ms
    of the steps, loss fetch ms), ...]}."""
    t = trainer.timings
    keep = trainer._loss_weights

    def waited(*args):
        weights = keep(*args)
        torch.cuda.synchronize()
        return weights

    def run(variant):
        trainer._loss_weights = waited if variant == 'wait' else keep
        marks = {k: len(t[k]) for k in ('loader_wait_s', 'step_s', 'fetch_s')}
        steps = trainer.global_step
        t0 = time.perf_counter()
        trainer.train_epoch()
        wall = time.perf_counter() - t0
        part = {k: round(sum(t[k][n:]) * 1e3, 3) for k, n in marks.items()}
        return (round(wall * 1e3, 3), (trainer.global_step - steps) / wall,
                part['loader_wait_s'], part['step_s'], part['fetch_s'])

    out = {'loader': [], 'wait': []}
    run('loader')
    for _ in range(rounds):
        for variant in ('loader', 'wait'):
            out[variant] += [run(variant) for _ in range(epochs)]
    trainer.cache_batches = True
    run('cached')
    out['cached'] = [run('cached') for _ in range(epochs * rounds)]
    trainer.cache_batches, trainer._batch_cache = False, None
    del trainer._loss_weights
    return out


def validation_fetches(torch, trainer, batches, reps=8):
    """A validation pass over `batches` (collated, on the card): the
    Trainer's validate, one fetch from the card a batch, against the same
    pass with one fetch for the whole pass; `reps` runs of each,
    interleaved, host clock, each run ending in a synchronize. Returns the
    two lists of ms and the worst relative difference of their metrics
    (dE/dx's scatter sums in another order from run to run)."""
    from grappa_tpu_torch.train.evaluator import (StreamingEvaluator,
                                                  _per_mol_sqerr)
    evaluator = StreamingEvaluator()

    def one_fetch():
        stats, names = [], []
        for batch, ds_names in batches:
            energy, gradient = trainer.eval_step(batch)
            stats.append(torch.stack(_per_mol_sqerr(batch, energy,
                                                    gradient)))
            names.append(ds_names)
        host = torch.cat(stats, dim=1).cpu().numpy()
        at = np.cumsum([0] + [x.shape[1] for x in stats])
        for j, ds_names in enumerate(names):
            evaluator.accumulate(*host[:, at[j]:at[j + 1]], ds_names)
        return evaluator.pool()

    saved, trainer.val_loader = trainer.val_loader, batches
    try:
        each, one = trainer.validate(), one_fetch()
        worst = max(abs(one[ds][k] - each[ds][k]) / max(abs(each[ds][k]),
                                                       1e-30)
                    for ds in each for k in each[ds])
        if one.keys() != each.keys():
            worst = float('inf')
        times = {'one': [], 'per_batch': []}
        for _ in range(reps):
            for key, fn in (('one', one_fetch),
                            ('per_batch', trainer.validate)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[key].append((time.perf_counter() - t0) * 1e3)
    finally:
        trainer.val_loader = saved
    return times, worst


def trainrun_phase(torch, work, data_dir, made, test_batches):
    """Phase 8. Returns the training run's launches and the `trainrun`
    line's fields."""
    import copy
    from pathlib import Path
    from grappa_tpu_torch import Grappa, native
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.synthetic import make_dataset, random_molecule
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    from grappa_tpu_torch.train.config import default_config
    from grappa_tpu_torch.train.export import load_model_dict
    from grappa_tpu_torch.train.run import do_trainrun, resume_trainrun
    from grappa_tpu_torch.train.trainer import _verify_checkpoint

    phase('8. the training run (do_trainrun / resume_trainrun), default '
          'config')
    print(f'(a) dataset of {TRAINRUN_MOLS} molecules x {TRAINRUN_CONFS} '
          f'conformers made and saved in {made:.1f} s; native '
          f'graph pre-processing: '
          f'{"ran" if native.available() else "absent (Python paths)"}',
          flush=True)
    config = trainrun_config(default_config, data_dir)
    counters = (fused_gnn_block, fused_transformer_block, fused_symmetriser)
    for c in counters:
        c.launches = c.bwd_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = do_trainrun(copy.deepcopy(config), project_dir=work,
                      run_name='trainrun')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {c.__name__: (c.launches, c.bwd_launches) for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer, run_dir = out['trainer'], out['run_dir']

    # forwards: each train step, each epoch's validation batches, each
    # test molecule (batch 1) and test_model's smoke test
    split = json.loads((Path(run_dir) / 'split.json').read_text())
    steps = trainer.global_step
    n_val = len(trainer.val_loader)
    forwards = steps + trainer.epoch * n_val + len(split['test']) + 1
    want = {'fused_gnn_block': (7 * forwards, 7 * steps),
            'fused_transformer_block': (12 * forwards, 12 * steps),
            'fused_symmetriser': (4 * forwards, 4 * steps)}
    check(got == want and (steps, forwards) == (6, 18),
          f'(a) launches (forward, backward) {got}: {steps} train steps, '
          f'{trainer.epoch} validations of {n_val} batch(es), '
          f'{len(split["test"])} test molecules, 1 smoke test = {forwards} '
          f'forwards (want 6 steps, 18 forwards: 126 / 216 / 72 and 42 / '
          f'72 / 24)')
    losses = sum(trainer.train_losses, [])
    es = [h['early_stopping_loss'] for h in trainer.history]
    check(len(losses) == steps and bool(np.isfinite(losses).all())
          and bool(np.isfinite(es).all()),
          f'(a) finite losses: train {", ".join(f"{l:.6e}" for l in losses)}'
          f'; early-stopping loss by epoch '
          f'{", ".join(f"{l:.6e}" for l in es)}')
    for name in ('best.ckpt', 'last.ckpt'):
        path = Path(run_dir) / name
        try:
            _verify_checkpoint(path)
            verified = 'passes _verify_checkpoint'
        except RuntimeError as exc:
            verified = f'fails _verify_checkpoint: {exc}'
        has_opt = (path / 'opt_state.pt').exists()
        check(verified.startswith('passes')
              and has_opt == (name == 'last.ckpt'),
              f'(a) {name} {verified}; optimizer state '
              f'{"present" if has_opt else "absent"}')

    # model.npz against the Trainer's best weights, both on the card
    mols = [random_molecule(seed=s) for s in range(16)]
    exported = Grappa.from_model_dict(load_model_dict(out['model_dict_path']))
    best_model = make_model(config['model_config'])
    best_model.load_state_dict(trainer._best_snapshot[0])
    best = Grappa(best_model, config)
    compare_outputs(f'(a) model.npz (best epoch {trainer._best_snapshot[1]})'
                    f' vs the Trainer\'s best weights, 16 molecules,',
                    stack(exported.predict_many(mols, check_eq_values=False)),
                    stack(best.predict_many(mols, check_eq_values=False)))
    del exported, best, best_model

    t0 = time.perf_counter()
    resumed = resume_trainrun(run_dir, extra_epochs=1)
    resume_s = time.perf_counter() - t0
    rt = resumed['trainer']
    check(rt.epoch == 4 and bool(np.isfinite(rt.train_losses[-1]).all()),
          f'(a) resume_trainrun(extra_epochs=1) ends at epoch {rt.epoch} '
          f'(want 4) in {resume_s:.1f} s; its losses '
          f'{", ".join(f"{l:.6e}" for l in rt.train_losses[-1])}')
    # writer-free epochs: the steady rate and where an epoch's time goes
    runs = idle_share(torch, rt.train_epoch, reps=2)
    steady = steady_epochs(torch, rt)
    rate = {k: [r[1] for r in v] for k, v in steady.items()}
    for variant, rows in steady.items():
        print(f'(a) {variant} epochs (ms, steps/s, loader wait ms, host ms of '
              f'the steps, loss fetch ms): ' + '; '.join(
                  f'{r[0]:.1f}, {r[1]:.3f}, {r[2]:.1f}, {r[3]:.1f}, '
                  f'{r[4]:.1f}' for r in rows), flush=True)
    if runs is not None:
        print('(a) writer-free train epochs under torch.profiler (wall ms, '
              'device busy ms, idle share, kernels): ' + '; '.join(
                  f'{w:.1f}, {b:.1f}, {i:.3f}, {n}' for w, b, i, n in runs),
              flush=True)
    val_times, worst = validation_fetches(torch, rt, test_batches)
    fmt = lambda xs: ', '.join(f'{x:.2f}' for x in xs)
    check(worst <= VAL_RTOL,
          f'(a) validation over the {len(test_batches)} test batches: '
          f'Trainer.validate (a fetch a batch) median '
          f'{np.median(val_times["per_batch"]):.2f} ms '
          f'({fmt(val_times["per_batch"])}), one fetch for the pass median '
          f'{np.median(val_times["one"]):.2f} ms '
          f'({fmt(val_times["one"])}); metrics worst rel '
          f'{worst:.2e} (tol {VAL_RTOL})')
    ms = lambda xs: [round(x * 1e3, 3) for x in xs]
    t = trainer.timings
    line = {
        'molecules': TRAINRUN_MOLS, 'conformers': TRAINRUN_CONFS,
        'epochs': trainer.epoch, 'train_steps': steps,
        'run_wall_s': round(wall, 3), 'epoch_ms': ms(t['epoch_s']),
        'train_ms': ms(t['train_s']),
        'run_train_steps_per_s': steps / sum(t['train_s']),
        'steady_train_steps_per_s': float(np.median(rate['loader'])),
        'steady_steps_per_s_min_max': [min(rate['loader']),
                                       max(rate['loader'])],
        'steady_epochs': len(rate['loader']),
        'wait_train_steps_per_s': float(np.median(rate['wait'])),
        'cached_train_steps_per_s': float(np.median(rate['cached'])),
        'steady_epoch_ms': float(np.median(
            [r[0] for r in steady['loader']])),
        'steady_step_host_ms': float(np.median(
            [r[3] for r in steady['loader']])) / len(rt.train_loader),
        'steady_loader_wait_ms': float(np.median(
            [r[2] for r in steady['loader']])),
        'steady_fetch_ms': float(np.median([r[4] for r in steady['loader']])),
        'loader_wait_ms': round(sum(t['loader_wait_s']) * 1e3, 3),
        'val_ms': ms(t['val_s']),
        'val_one_fetch_ms': float(np.median(val_times['one'])),
        'val_per_batch_fetch_ms': float(np.median(val_times['per_batch'])),
        'test_eval_ms': round(out['test_eval_s'] * 1e3, 3),
        'ckpt_blocking_ms': ms(t['ckpt_blocking_s']),
        'ckpt_async_ms': ms(t['ckpt_async_s']),
        'peak_gib': round(peak, 3),
        'epoch_idle_share': (None if runs is None
                             else [round(r[2], 4) for r in runs]),
        'epoch_profiled_ms': (None if runs is None
                              else [round(r[0], 3) for r in runs]),
        'epoch_busy_ms': (None if runs is None
                          else [round(r[1], 3) for r in runs]),
        'native_preprocessing': native.available(),
        'launches': got}

    # (b) card vs CPU without dropout
    small_dir = os.path.join(work, 'data', 'small')
    Dataset.from_moldata(make_dataset(n_mols=8, n_confs=4, seed=0,
                                      atom_range=TRAINRUN_ATOMS)
                         ).save(small_dir)
    cfg = trainrun_config(default_config, small_dir)
    cfg['model_config'].update(gnn_dropout_attention=0.0,
                               parameter_dropout=0.0, gnn_dropout_final=0.0,
                               gnn_dropout_initial=0.0)
    cfg['data_config']['train_batch_size'] = 3
    cfg['trainer_config']['max_epochs'] = 2
    res = {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        r = do_trainrun(copy.deepcopy(cfg), project_dir=work,
                        run_name=f'vs_{dev}', device=dev)
        res[dev] = (sum(r['trainer'].train_losses, []),
                    [h['metrics'] for h in r['trainer'].history],
                    time.perf_counter() - t0)
    (lg, mg, sg), (lc, mc, sc) = res['cuda'], res['cpu']
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    first = rel(lg[0], lc[0]) if lg and lc else float('inf')
    later = max((rel(a, b) for a, b in zip(lg[1:], lc[1:])), default=0.0)
    metric = max((rel(x[ds][k], y[ds][k]) for x, y in zip(mg, mc)
                  for ds in y for k in y[ds]), default=float('inf'))
    check(len(lg) == len(lc) == 4 and first <= STEP_LOSS_RTOL
          and later <= TRAINRUN_RTOL and metric <= TRAINRUN_RTOL
          and all(x.keys() == y.keys() for x, y in zip(mg, mc)),
          f'(b) card vs CPU, 8 molecules x 4 conformers, dropout off, '
          f'{len(lg)} steps: first loss {lg[0]:.6e} vs {lc[0]:.6e} (rel '
          f'{first:.2e}, tol {STEP_LOSS_RTOL}); later losses worst rel '
          f'{later:.2e}, validation metrics worst rel {metric:.2e} (tol '
          f'{TRAINRUN_RTOL}); card {sg:.1f} s, CPU {sc:.1f} s')
    return {name: n for name, n in got.items()}, line


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, 'grappa_tpu_torch')):
        print('chip_smoke.py: run it from a checkout of the repository '
              '(grappa_tpu_torch/ not found)', file=sys.stderr)
        return 2
    kernels_only = sys.argv[1:] == ['--kernels-only']
    torsion_only = sys.argv[1:] == ['--torsion']
    trainrun_only = sys.argv[1:] == ['--trainrun']
    train_step_only = sys.argv[1:] == ['--train-step']
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
    if torsion_only:
        torsion_path_phase(torch)
        return 1 if FAILURES else 0
    work = os.path.join(ROOT, 'runs', 'chip_smoke')
    if trainrun_only:
        data_dir, made, _, test_batches = trainrun_data(torch, work)
        _, line = trainrun_phase(torch, work, data_dir, made, test_batches)
        print('trainrun ' + json.dumps(line), flush=True)
        return 1 if FAILURES else 0

    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.data.molecule import Molecule
    from grappa_tpu_torch.data.synthetic import random_molecule
    from grappa_tpu_torch.models.grappa_model import get_default_model_config

    cfg = get_default_model_config()
    if train_step_only:
        graphs = training_batches(torch)
        phase('5. training steps, default config')
        training_phase(torch, graphs, collate(
            graphs, bucketed_pad_spec(graphs, TRAIN_CONFS), TRAIN_CONFS,
            device='cuda'), cfg)
        return 1 if FAILURES else 0

    protein = protein_like_molecule(Molecule)
    smalls = small_molecules(random_molecule)
    paths = {'small': smalls, 'protein': [protein]}
    workloads = {}
    for label, mols in paths.items():
        graphs = [MolGraph.from_molecule(m) for m in mols]
        workloads[label] = collate(graphs, bucketed_pad_spec(graphs, 1), 1,
                                   device='cuda')
    # the training run's (phase 8) train, validation and test batches
    data_dir, made, run_batches, test_batches = trainrun_data(torch, work)
    workloads.update({f'trainrun {k}': v for k, v in run_batches.items()})

    phase('2. kernels against their plain versions (the serving '
          'workloads\' and the training run\'s shapes)')
    entries = kernel_phase(torch, workloads)

    if not kernels_only:
        launches = predict_phase(torch, cfg, smalls, protein, paths)

    phase('4. training kernels against their plain versions (the 128 x 32 '
          'training batch\'s and the training run\'s train batch\'s '
          'shapes)')
    graphs = training_batches(torch)
    train_batch = collate(graphs, bucketed_pad_spec(graphs, TRAIN_CONFS),
                          TRAIN_CONFS, device='cuda')
    print('training batch, padded: N=%d, conformers %d, T bonds / angles / '
          'propers / impropers = %s' % (
              train_batch.xyz.shape[0], train_batch.xyz.shape[1],
              ' / '.join(str(train_batch.terms[t].idxs.shape[0])
                         for t in ('n2', 'n3', 'n4', 'n4_improper'))),
          flush=True)
    training_kernel_phase(torch, {'train': train_batch,
                                  'trainrun train': run_batches['train']},
                          entries)
    block_profile(torch, train_batch)
    if kernels_only:
        print('kernel_times ' + json.dumps(entries), flush=True)
        return 1 if FAILURES else 0

    phase('5. training steps, default config')
    train_launches = training_phase(torch, graphs, train_batch, cfg)
    for name, (nf, nb) in train_launches.items():
        launches[name]['train'] = nf
        launches[f'{name}.backward'] = {'train': nb}

    phase('6. the torsion kernel K5; energy, dE/dx and evaluation through '
          'it')
    from grappa_tpu_torch.data.synthetic import make_moldata
    fusion = {}
    for n_atoms in FUSION_ATOMS:
        t0 = time.time()
        mdata = make_moldata(seed=0, n_confs=FUSION_CONFS, n_atoms=n_atoms)
        mol_graphs = [MolGraph.from_moldata(mdata)]
        fusion[n_atoms] = (mdata, mol_graphs, collate(mol_graphs))
        b = fusion[n_atoms][2]
        print(f'{n_atoms} atoms x {FUSION_CONFS} conformers built on the host '
              f'in {time.time() - t0:.1f} s, padded: N={b.xyz.shape[0]}, T '
              f'bonds / angles / propers / impropers = ' + ' / '.join(
                  str(b.terms[t].idxs.shape[0])
                  for t in ('n2', 'n3', 'n4', 'n4_improper')), flush=True)
    big_n = min(FUSION_ATOMS)
    big = fusion[big_n][2]
    shapes = [('train propers', train_batch.terms['n4'].idxs.shape[0],
               TRAIN_CONFS, 6, True),
              ('train impropers',
               train_batch.terms['n4_improper'].idxs.shape[0], TRAIN_CONFS,
               3, True)]
    for n_atoms, (_, _, b) in fusion.items():
        shapes += [(f'{n_atoms}-atom propers', b.terms['n4'].idxs.shape[0],
                    FUSION_CONFS, 6, True),
                   (f'{n_atoms}-atom impropers',
                    b.terms['n4_improper'].idxs.shape[0], FUSION_CONFS, 3,
                    True)]
    shapes += [('kernel_bench', t, c, 6, False) for t, c in KERNEL_BENCH_TC]
    torsion_kernel_phase(torch, entries, shapes)
    fusion_phase(torch, cfg, {n: v[2] for n, v in fusion.items()}, launches)
    evaluation_phase(torch, cfg, graphs, train_batch,
                     (fusion[big_n][1], big), launches)

    phase('7. molecular dynamics on the card (reference parameters)')
    md_phase(torch, (fusion[big_n][0], big))
    del fusion, big

    run_launches, trainrun_line = trainrun_phase(torch, work, data_dir,
                                                 made, test_batches)
    for name, (nf, nb) in run_launches.items():
        launches[name]['trainrun'] = nf
        launches[f'{name}.backward']['trainrun'] = nb

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
                                       'fused_symmetriser.py:199'),
        'torsion_energy_fused': ('torsion.cu', 'torsion_kernel.py:109'),
        # K5's backward: in the JAX package the vjp of _energy_jnp run as
        # one XLA program (_bwd), not a Pallas kernel
        'torsion_energy_grad': ('torsion.cu', 'torsion_kernel.py:156')}
    kernels = []
    for name, (source, replaces) in sources.items():
        e = entries[name]
        b_ms, b_by = bound(e['flops'], e['nbytes'], e['peak'])
        per_path = launches.get(name, {})
        kernels.append(dict(
            name=name, route='cuda', source=csrc + source,
            replaces=tpu + replaces, status='ported',
            launches=sum(per_path.values()), launches_per_path=per_path,
            max_abs_err=e['max_abs_err'], ms=e['ms'],
            plain_ms=e['plain_ms'], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, mbytes=e['nbytes'] / 1e6))
        if e['peak'] == PEAK_FP32_FLOPS:
            kernels[-1]['gflop'] = e['flops'] / 1e9
        else:
            kernels[-1]['g_sm_clocks'] = e['flops'] / 1e9
        if 'device_ms' in e:
            kernels[-1]['device_ms'] = e['device_ms']
        if name in TENSOR_CORE_KERNELS:
            kernels[-1]['bound_tc_ms'] = bound(3 * e['flops'], e['nbytes'],
                                               PEAK_TF32_FLOPS)[0]
    print('trainrun ' + json.dumps(trainrun_line))
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
