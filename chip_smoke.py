#!/usr/bin/env python3
"""Smoke run of grappa_tpu_torch (the PyTorch / CUDA port) on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1, 2 and 4 alone
    python3 chip_smoke.py --torsion        # phase 1 and the K5 path's times
    python3 chip_smoke.py --trainrun       # phases 1 and 8 alone
    python3 chip_smoke.py --train-step     # phases 1, 5 and 10(c)(c)
    python3 chip_smoke.py --eval           # phases 1 and 9 alone
    python3 chip_smoke.py --bf16           # phases 1 and 10 alone
    python3 chip_smoke.py --gmx            # phases 1 and 11 alone
    python3 chip_smoke.py --data           # phases 1 and 12 alone
    python3 chip_smoke.py --gnn-calls      # K1 / K1b bf16 a call, profile
    python3 chip_smoke.py --parallel       # phases 1 and 13 alone
    python3 chip_smoke.py --parallel-bf16  # phases 1, 13(e) and 13(f)
    python3 chip_smoke.py --parallel-bf16 --spread  # and 13(e)'s one-ulp
                                                    # spread reading
    python3 chip_smoke.py --recipes        # phases 1 and 14 alone

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
     `block_profile` line: K2 / K2b (float32 and bf16) at the n4
     training shape (S=4, T=8256, F=hid=512, dropout 0.5), K1 / K1b
     (float32 and bf16) at the training batch's nodes (N=3376, dropout
     0.3) and K3 / K3b (float32 and bf16) at the n4 training shape under
     torch.profiler, each launch of one call with its device ms and share
     (printed above the line) and the device ms by kernel name, beside one
     torch.matmul (fp32, TF32 off) of K2's largest product, 33024 x 1536 x
     512, a yardstick the port never calls.
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
  9. evaluation, checkpoint import and the command line at the default
     width, in a temporary GRAPPA_TPU_CACHE: (a) a release's layout: the
     default model with seeded non-zero weights as models/grappa-1.2.pth
     (the reference's format, every alias and buffer), three datasets
     under published tags (EVAL_TAGS, 128 make_dataset molecules x 32
     conformers each, 8-43 atoms, a stand-in classical force field in the
     entries; the last one zipped with a nested top directory) and an
     espaloma_split directory (0.8 / 0.1 / 0.1); (b) `cli eval --set all
     --classical`, twice (the second warm): K1 / K2 / K3 launched batches x
     7 / 12 / 4 times in each call, finite results written back into the
     model file, the first tag's metrics and CIs against eval_model on the
     CPU at EVAL_RTOL; the `eval` line (eval_model's wall, loader, step
     and bootstrap ms, molecules/s and conformers/s, the batch count and
     adaptive batch size, the command's wall, peak memory, the card's name
     and power limit); (c) `cli ingest-release`: rc 1 on the FAIL verdict
     these weights must get, the .json / .md / .tex report, an audit with
     0 missing and 0 unexpected keys; the `ingest` line; (d) a buffer-less
     .npz and a state dict with `fc_src` and without the gnn.blocks aliases
     through Grappa.from_model_dict on the card, predicting what they
     predict on the CPU (MODEL_RTOL / MODEL_ATOL), and `cli export` of
     phase 8's best.ckpt (with --eval, of a 2-epoch run made here) equal
     to its model.npz bit for bit.
 10. the bf16 mode (compute_dtype='bfloat16'; the kernels' mm_dtype): (a)
     K1-K3 in bf16 mode against their plain bf16 versions at phase 2's
     shapes (the serving workloads, phase 8's and phase 9's batches): mean
     |kernel - plain bf16| <= BF16_RULE x mean |plain bf16 - plain f32|
     (the bf16 effect), max <= BF16_MAX x its max; the bf16 kernel's, the
     plain version's and the float32 kernel's ms at each shape, and the
     bf16 bound (FLOP at 989 TFLOP/s or bytes at 3.35 TB/s); (b)
     predict_many at the default width in bf16 on phase 3's two paths and
     weights: bf16 launches 7 / 12 / 4 a forward and no float32 launch
     (counts zeroed before each path), finite outputs, each output against
     the same model on the CPU (fused: the plain bf16 versions) within
     1.25 x the card's own spread under a one-ulp change of the weights
     (bf16 roundings cascade over the full width: compare_bf16_outputs),
     every stage alone (each GNN block, each writer's RepProjector,
     transformer blocks and Symmetriser) card vs CPU on the CPU's input
     at BF16_RULE, the warm latency beside the float32 model's; (c)
     training in bf16: (a) K1b-K3b in bf16 mode against autograd through
     their plain bf16 versions at phase 4's shapes, dropout on: mean
     |kernel - plain bf16| <= max(BF16_RULE x the bf16 effect,
     BF16_ORDER x the plain bf16 version's own distance on the CPU), max
     <= BF16_MAX x the effect's max, per gradient; the bf16 kernel's, the
     plain version's and the float32 kernel's backward ms and the bf16
     bound; then readings (no checks) of K1b bf16 at 40 rows (F 512, D
     8), head width 128 and 256, on tests/test_torch_port_kernels.py's
     inputs for seeds 0-5 against the same rule, with the attention
     pass's bf16 flips (gnn_gap_readings); (c) make_train_step with
     compute_dtype='bfloat16' and the
     config's dropout on the 128 x 32 batch and bench.py's 512 x 32 peak
     config (build_big_batch's molecules), in turns with the float32 step
     on the same weights: 7 / 12 / 4 bf16 forward and backward launches a
     step and no float32 one, finite losses, step ms (median of 10),
     peak memory and idle share; gnn_compute_dtype / heads_compute_dtype
     alone launch only their own stage in bf16; (d) dropout-free bf16
     steps, card vs CPU (8 x 4) in BF16_STEP_DRAWS draws of weights,
     molecules and one-ulp weight change, in units of each draw's bf16
     effect: the median loss distance within max(BF16_RULE, 1.25 x the
     median of the card's own spread under the one-ulp change); for the
     gradients and the update the median of the draws' medians over
     tensors within max(BF16_RULE, 1.25 x the same of the spread) and the
     median of their largest within 1.25 x the median of the widest
     spread; beside them a witness, the card with K1 / K1b on their plain
     version; (e) do_trainrun in bf16 on phase
     8's dataset, 2 epochs, then resume_trainrun by one: bf16 launches
     only, finite losses, compute_dtype kept in the stored config and the
     resumed model, model.npz's float32 parameters loaded into a bf16
     model on the card give the run's test metrics (EVAL_RTOL), writer-
     free steps/s beside phase 8's float32 (`trainrun_bf16` line); (d)
     the built library's SASS: every wg_gemm_kernel (K1 / K1b's, K2 /
     K2b's and K3 / K3b's bf16 products, each file's MN-major and split-K
     ones among them) has a bf16 HGMMA and no HMMA; every tc_gemm_kernel
     (the float32 products) the TF32 HMMA and no bf16 one; no function a
     bf16 mma.sync (HMMA.16816.F32.BF16) and no name a TcBf16
     instantiation.
 11. the GROMACS path at the default width (GromacsGrappa.parametrize and
     `cli gmx`, grappa_tpu_torch.wrappers): (a) a .top with the
     protein-like chain (phase 3's molecule, masses of each element,
     charges summing to an integer), a 30-atom ligand, SOL x 2000 and NA /
     CL x 10, the default model with seeded non-zero weights as
     models/grappa-1.2.pth in a temporary GRAPPA_TPU_CACHE; phase 2 holds
     K1-K3 at the shapes of its forwards; (b) `cli gmx -t grappa-1.2`
     returns 0, the written file parses, the protein and the ligand carry
     a predicted row for every bond, angle, proper (6 periodicities) and
     improper (3), SOL, the ions and every line outside the moleculetypes
     are unchanged byte for byte; (c) `cli gmx --focus` on two protein
     atoms more than GMX_FOCUS_APART x the field of view bonds apart: two
     components in one predict_many, every row outside the apply set (and
     the ligand, water, ions) unchanged byte for byte; (d) K1 / K2 / K3
     launch 7 / 12 / 4 times a forward (2 forwards for (b), 1 for (c),
     counts zeroed before each command), the kernels line's `gmx` path;
     (e) GromacsGrappa on the card and on the CPU parametrize the file,
     whole and with the focus: last_predictions at MODEL_RTOL /
     MODEL_ATOL (the torsion cutoff rule of compare_outputs), the written
     files line for line (each parameter at that tolerance x its unit
     factor + half a printed unit), the CLI's file against the in-process
     one, and every row formatted from last_predictions in the file; (f)
     the warm parametrize of the whole file (median of GMX_REPS, host
     clock) split into parse, featurise + collate, the forward (CUDA
     events, its host time beside), row formatting + write and the rest;
     the `gmx` line (with the card's name and power limit and the atoms
     parametrized a second).
 12. the data tools, the sweep, the plots and the minimiser: (a) a
     folder/<mol>/moldata.npz tree of DATA_MOLS make_dataset molecules
     (phase 8's conformers and atoms) through `python -m
     grappa_tpu_torch.cli dataset from-moldata-dirs` and
     `add-charge-model`, build_espaloma_split and `split-export`, and
     convert_espaloma_dir / assemble_dataset_dir on archive records of
     DATA_RECORDS' SMILES written with the port's parser: counts by
     partition, every id in one partition, the am1BCC one-hot, a second
     run (in process) byte for byte equal, each step's wall ms (the
     `dataset_tools` line); (b) run_sweep(method='bayes', n_init=2, 4
     trials, max_epochs=2) over SWEEP_SPEC at the default width on (a)'s
     dataset and split: per trial the params, early-stopping loss,
     epochs, steps, wall ms, steps/s and its split (loader wait, steps,
     validation, checkpoint writes, test evaluation, the rest); K1-K3 /
     K1b-K3b launched 7 / 12 / 4 times the trials' forwards and steps,
     peak memory; the same call again skips every trial, launches
     nothing and leaves best.json and trials.jsonl as they were (the
     `sweep` line); (c) a random sweep over SWEEP_PARITY_SPEC (2 trials,
     2 epochs, 8 molecules x 4 conformers, dropout off, default width)
     on the card and on the CPU: the same params, each trial's loss at
     TRAINRUN_RTOL (`sweep_parity`); (d) eval_model.plot_arrays (one
     forward a molecule) on phase 9's first tag's 128 molecules, card vs
     CPU: parameters at MODEL_RTOL / MODEL_ATOL, centred energies within
     MODEL_ATOL + MODEL_RTOL x the molecule's max |E|, dE/dx within
     FORCE_RTOL x its max, 7 / 12 / 4 launches a molecule, molecules/s
     (`eval_plots`); (e) minimize_geometry(method='bucketed') on the
     card against 'torch' on the CPU on MIN_MOLS molecules of
     tests/test_energy.py:138-171's kind: the energy at each minimum
     within max(0.02 |E|, 0.5), ms a molecule, make_dataset(learnable)
     with each (`minimizer`). Every line carries the card's name and
     power limit.
 13. the multi-device layer (grappa_tpu_torch.parallel) on the one card:
     (a) a mesh of one rank on NCCL: PAR_DP_STEPS data-parallel steps at
     the 128 x 32 batch with the config's dropout equal make_train_step's
     parameters bit for bit (deterministic algorithms on: index_add's
     atomics would part them), 7 / 12 / 4 launches a step each way; (b)
     PAR_RANKS gloo ranks, processes sharing the card: the DP step on PAR_RANKS
     shares of that batch (64 x 32 each) against one process's mean of
     the shares' gradients with the same dropout seeds (loss rtol
     STEP_LOSS_RTOL, each gradient's relative L2 STEP_GRAD_RL2), every rank
     holding the same mean, launches counted per rank; (c) a
     Trainer(mesh=...) epoch of 5 batches (a trailing group of 1): 3
     steps, finite losses, the same parameters on every rank; the
     conformer-sharded energy of 8 x 32 against the unsharded one; (d) at
     SP_ATOMS atoms x 4 conformers the atom-sharded forward, one train
     step with dropout and SP_MD_STEPS NVE steps with the reference
     parameters against the unsharded path (rank 0 runs it on the same
     card) at the CPU tests' tolerances: the step's loss against the
     float64 loss of the same prediction (rtol SP_LOSS_RTOL); with that
     loss in float64, each all-reduced gradient of the sharded forward
     and backward against one process's on the whole batch (relative L2
     STEP_GRAD_RL2; at this size float32 resolves the loss only to ~1e-3
     and a float32 step's gradients carry it, PERF.md §6); the updated
     parameters against the unsharded step's; (e) K1m / K2m with a shard's rows
     against the unsharded dump's rows bit for bit, K1 / K1b and K2 / K2b
     with the row offset against their plain versions on those rows. The
     `parallel` line: step ms, all-reduce ms (and MB) and peak memory for
     the one-rank mesh and for each gloo rank, the atom-sharded forward,
     step and MD ms, with the card's name and power limit; two ranks on
     one card show the arithmetic and the collectives' placement, not a
     multi-card speed.
     13(e) the same paths with the default model in bf16
     (compute_dtype='bfloat16'), deterministic algorithms on: a mesh of
     one NCCL rank, 3 bf16 DP steps bit for bit with bf16 make_train_step
     (else where they part); two gloo ranks: the bf16 DP step on the
     shares against one process's mean of the shares' bf16 gradients
     (13(b)'s tolerances), a bf16 Trainer(mesh=...) epoch, the
     atom-sharded bf16 forward and step at 12,000 atoms against the
     unsharded bf16 ones on the card (13(d)'s tolerances, the step's
     loss gated in float64: the sharded prediction's float64 loss
     against the unsharded prediction's, the float32 losses readings;
     with --spread the unsharded step's own one-ulp spread as a
     reading), the collectives' operand
     dtypes, the bf16 launches (7 / 12 / 4 a forward and a step a rank,
     no float32 launch; the sharded step's 7 / 12 through K1's / K2's
     `_rows` builds), and K1 / K1b, K2 / K2b in bf16 through `_rows` at
     every shape the sharded step gives them (K1 at a rank's nodes, K2 at
     each writer's S and T) on every rank's rows against their plain
     bf16 versions (10(a) / 10(c)(a)'s rule), at rank 1's nodes and n4
     tuples beside the unsharded bf16 kernel's time at those rows. 13(f)
     the atom-sharded MM energy with K5 / K5b (2 / 2 launches a call a
     rank) against the sharded plain path (6(b)'s tolerances) and the
     unsharded K5 path (13(d)'s). The `parallel_bf16` line: step,
     forward, all-reduce and energy ms and peak memory a rank, with the
     card's name and power limit.
 14. the published training recipes through grappa_tpu_torch.production
     at the published width, on stand-ins under the recipes' own tags in a
     temporary GRAPPA_TPU_CACHE (make_dataset, RECIPE_MOLS x RECIPE_CONFS
     a tag, phase 8's atoms, random classical parameters with 6-wide
     proper ks; an espaloma_split tag over the first RECIPE_SPLIT_TAGS
     tags, so that the split's extension runs; downloads raise), cut to
     RECIPE_EPOCHS epochs, param_loss_epochs 100 -> 3 and
     val_conf_strategy 500 -> 16 (run_production's overrides): (a)
     grappa-1.2.1 (7 x 512 GNN, periodicity 3, torsion cutoff): finite
     losses; each epoch's LossWeights (param-only epochs 0-1, QM epoch 2,
     the parameter weight off at epoch 3) and the restarts; 7 / 12 / 4
     launches each forward (steps, validation and test batches) and each
     step's backward; split.json assigns every molecule of the 13 training
     tags and keeps the stored split's assignments, rna-nucleoside trains
     only, the two pure test tags are only in the test metrics; model.npz
     predicts proper ks of width 3; K1-K3 at the run's train and test
     batches' shapes and K1b-K3b at its train batch's against their plain
     versions (phases 2 and 4's rules, K3 with 6 proper outputs);
     resume_trainrun by one epoch; (b) grappa-1.0 (2 convolution blocks +
     5 attention blocks, periodicity 6), RECIPE_V10_EPOCHS epochs: 5 / 12
     / 4 launches each forward and step, non-zero gradients on both
     convolution blocks, a 32-molecule forward card vs the CPU's eager
     modules (MODEL_RTOL / MODEL_ATOL), a dropout-free step card vs CPU
     (phase 5(a)'s rule); (c) one epoch with -p 0.001 --shrink_train 0.5
     --n_periodicity 4 --no_torsion_cutoff and one with --pretrain_path
     (a)'s model.npz: the JAX driver's run names and config edits, the
     pretrained run's first weights equal to the file's, QM weights with
     the parameter weight 0 from epoch 0; then grappa-1.2.1 on
     RECIPE_CPU_MOLS x RECIPE_CPU_CONFS a tag, dropout off, card vs CPU
     (phase 8(b)'s rules). A `recipe` line a version: epochs, writer-free
     steps/s, epoch, validation and test-evaluation ms, peak memory, the
     device idle share of an epoch, launches, the cuts, the card's name
     and power limit.

The `trainrun {...}`, `trainrun_bf16 {...}`, `eval {...}`, `ingest
{...}`, `gmx {...}`, phase 12's five lines, `parallel {...}`,
`parallel_bf16 {...}` and the two `recipe {...}` lines come before
the last three lines, which are a
JSON object describing the kernels, the card's name and power limit, and
{"ok": true, "device": {...}}. In the kernels'
line, `launches` sums the main paths (the two predict paths and the ten
training steps, phase 8's training run and phase 9's eval and ingest
paths, phase 11's gmx path, phase 12's sweep and plots, phase 13's
steps and atom-sharded paths (`parallel`, the ranks' summed) and phase
14's four recipe runs (`recipe_1.2.1`, `recipe_1.0`, `recipe_flags`,
`recipe_pretrain`) for K1-K3 and the sweep, phase 13 and phase 14 for
K1b-K3b; phase 6's four paths and 13(f)'s
sharded energy (`parallel_sharded_energy`) for K5 and K5b; 13(e)'s bf16
steps and atom-sharded paths (`parallel_bf16`) for the bf16 entries;
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
stores. The bf16 entries (`<kernel>.bf16`) sum phase 10(a)'s shapes,
the bf16 backward entries (`<kernel>.bf16_bwd`) phase 10(c)(a)'s, with
`f32_ms` (the float32 kernel at the same shapes) and a bf16 bound;
their launches are phase 10(b)'s and 10(c)'s (the steps and the bf16
training run). Any failure exits non-zero before those lines.
`--kernels-only` stops after phase 4 and 10(a) / (c)(a) / (d) and prints
the kernels' sums as a `kernel_times` line instead; `--bf16` runs phase
10 alone (building phase 2's workloads; `trainrun_bf16` and
`bf16_kernel_times` lines); `--trainrun` runs phase 8 alone and
`--eval` phase 9 alone, `--gmx` phase 11 alone (after phase 2 at its
shapes; a `kernel_times` line and the `gmx` line) and
`--recipes` phase 14 alone (a `kernel_times` line and the `recipe`
lines), `--train-step` phase 5 and 10(c)(c) alone (the float32 and the bf16
steps, with names a parent checkout shares, so that one copy of this
script times the steps of both); `--gnn-calls` prints only the
`gnn_call` lines, K1 / K1b in bf16 mode one call at a time at N 64, 224,
1096, 1376, 3376 and 12904 (gnn_calls: back-to-back ms, device ms,
launches, the host us of a call split into the C entry and the Python
around it, the C entry's CUDA runtime calls), and `block_profile`, with
names a parent checkout shares;
`--torsion` prints only K5's host time by part at the propers' shapes (`k5_host` lines) and the energy + dE/dx
path's times and kernels (`torsion_path_phase`), with names a parent
checkout shares, so that one copy of this script times both. Needs one CUDA device; imports nothing of JAX or
of grappa_tpu.
"""
from __future__ import annotations

import contextlib
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
PEAK_BF16_FLOPS = 989e12
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
# phase 9: three datasets under published tags (the last one zipped) of
# make_dataset molecules at phase 8's conformers and atoms; evaluation on
# the card vs the CPU, every metric and CI (phase 6(d)'s tolerance: the
# per-molecule sums run in another order, the bootstrap draws are equal)
EVAL_TAGS = ('spice-dipeptide', 'gen2', 'rna-diverse')
EVAL_MOLS = 128
EVAL_RTOL = 1e-4
# phase 10: the bf16 mode against the plain bf16 versions (kernels) and
# the CPU's plain bf16 path (predict_many): mean |bf16 - its reference| <=
# BF16_RULE x mean |reference - the same in float32| (the bf16 effect),
# the rule tests/test_torch_port_bf16.py holds the port to against the JAX
# package. The two sides round the same operands to bf16 and differ only
# where a float32 value summed in another order lands on the other side of
# a bf16 rounding; a flip moves its row's LayerNorm and the next roundings
# in that row, so one element's error can approach the effect's own size.
# Kernels also max <= BF16_MAX x the effect's max: a wrong tile or
# fragment errs by the output's own size.
BF16_RULE, BF16_MAX = 0.1, 2.0
# phase 10(c)(a): a backward chains three or four roundings of operands
# that depend on float32 sums, so at full width the plain bf16 version on
# the CPU (the same arithmetic in another float32 order) sits 0.03-0.16 of
# the bf16 effect from the same on the card; a backward kernel's mean
# error may reach BF16_ORDER x that distance where it exceeds BF16_RULE
BF16_ORDER = 1.5
# phase 10(c)(d): a bf16 step is a chaotic cascade of roundings, so one
# card-vs-CPU distance and one one-ulp spread are each one draw of it. The
# check draws both BF16_STEP_DRAWS times, draw k with the weights of
# perturbed_model seed 2k, molecules 8k..8k+7 and the one-ulp change
# seeded 5 + k (draw 0 is the single draw the check held alone before),
# and holds the medians over the draws
BF16_STEP_DRAWS = 9
# the SASS: tc_gemm.cuh's float32 products run the TF32 mma.sync; the bf16
# mma.sync (the engine K1 / K1b's bf16 mode ran on before wg_gemm.cuh) is
# in no function of the library
BF16_HMMA, TF32_HMMA = 'HMMA.16816.F32.BF16', 'HMMA.1688.F32.TF32'
# phase 11: the GROMACS path on a topology of the protein-like chain,
# a GMX_LIGAND_ATOMS-atom ligand (random_molecule, GMX_LIGAND_SEED),
# GMX_WATERS waters and GMX_IONS Na+ and Cl- each (skipped, as
# gromacs_topology.SKIP_MOLECULES says); `--focus` on two protein atoms
# more than GMX_FOCUS_APART x the field of view bonds apart; the warm
# parametrize timed GMX_REPS times
GMX_LIGAND_ATOMS, GMX_LIGAND_SEED, GMX_WATERS, GMX_IONS = 30, 0, 2000, 10
GMX_FOCUS_APART, GMX_REPS = 4, 5
# phase 10(c)(a)'s readings of K1b at 40 rows (gnn_gap_readings)
GAP_N, GAP_SEEDS = 40, 6
# gnn_calls: bench.py's 512-molecule x 32-conformer batch's padded nodes
# (the bf16 step of phase 10(c)(c))
GNN_BIG_N = 12904
# phase 12: the data tools on a moldata tree of DATA_MOLS make_dataset
# molecules at phase 8's conformers and atoms, under a name add-charge-model
# infers am1BCC from; the espaloma split takes the last DATA_TEST ids as
# test and the DATA_TEST before them as validation; the pipeline converts
# archive records of these mapped SMILES (and a merged duplicate)
DATA_TAG, DATA_MOLS, DATA_TEST = 'spice-sweep', 48, 5
DATA_RECORDS = {
    'ds_a': ['[C:1](=[O:2])([N:3]([H:5])[H:6])[H:4]',
             '[c:1]1([H:7])[c:2]([H:8])[c:3]([H:9])[c:4]([H:10])'
             '[c:5]([H:11])[c:6]1[H:12]'],
    'ds_b': ['[C:1]([H:4])([H:5])([H:6])[C:2]([H:7])([H:8])[O:3][H:9]']}
# the sweep at the default width, and its card-vs-CPU check at phase 8(b)'s
# setting (a learning rate near its 1.5e-5, batches of a few molecules)
SWEEP_SPEC = {'lit_model_config.lr': ('log_uniform', 1e-5, 1e-3),
              'data_config.train_batch_size': ('choice', [16, 32])}
SWEEP_PARITY_SPEC = {'lit_model_config.lr': ('log_uniform', 1e-5, 2e-5),
                     'data_config.train_batch_size': ('choice', [2, 3])}
# the minimiser: make_dataset(learnable=True, seed=MIN_SEED) of MIN_MOLS
# molecules of tests/test_energy.py:138-171's elements and sizes
MIN_MOLS, MIN_SEED = 16, 977
# phase 13: the multi-device layer on the one card. (a) a mesh of one rank
# (NCCL), PAR_DP_STEPS DP steps against make_train_step; (b)-(d) PAR_RANKS
# gloo ranks sharing the card: the DP step on PAR_RANKS shares of the 128 x
# 32 batch, a Trainer(mesh=...) epoch over PAR_TRAINER_MOLS molecules in
# batches of 2 (5 batches: a trailing group), the atom-sharded forward,
# step and SP_MD_STEPS NVE steps at SP_ATOMS atoms, at the CPU tests'
# tolerances (tests/test_torch_port_parallel.py); a collective that waits
# PAR_TIMEOUT_S fails its rank, and the ranks are killed after PAR_JOIN_S
PAR_RANKS, PAR_DP_STEPS, PAR_SEED = 2, 3, 21
PAR_TRAINER_MOLS, PAR_TRAINER_CONFS = 10, 4
PAR_TIMEOUT_S, PAR_JOIN_S = 300, 600
SP_ATOMS, SP_MD_STEPS, SP_MD_DT = 12000, 10, 0.2
SP_E_TOL, SP_G_TOL, SP_LOSS_RTOL, SP_PARAM_TOL, SP_MD_TOL = (
    2e-4, 2e-3, 1e-3, 5e-3, 2e-4)
REF_FIELDS = {'n2_k': ('n2', 'k_ref'), 'n2_eq': ('n2', 'eq_ref'),
              'n3_k': ('n3', 'k_ref'), 'n3_eq': ('n3', 'eq_ref'),
              'n4_k': ('n4', 'k_ref'),
              'n4_improper_k': ('n4_improper', 'k_ref')}
# phase 13(e): the bf16 mesh (the default config with PAR_BF16), held
# against the port's unsharded bf16 path on the card at 13(a)-(d)'s
# tolerances, the ranks and the references with deterministic algorithms
# on: the same kernels on the same rows then keep the two within float32
# order. A bf16 step's gradients at 12,000 atoms move by ~5% under a
# one-ulp weight change (the bf16 roundings cascade; `--spread` prints
# it): a rule scaled by it would pass a step whose masks are wrong.
# 13(f): K5 / K5b on SP_ATOMS atoms over the ranks, phase 6(b)'s
# tolerances against the sharded plain path, (d)'s against the unsharded
PAR_BF16 = {'compute_dtype': 'bfloat16'}
# phase 14: the published recipes through grappa_tpu_torch.production at
# the published width, on stand-ins under the recipes' own tags
# (RECIPE_MOLS x RECIPE_CONFS a tag, phase 8's atoms; the espaloma_split
# tag covers the first RECIPE_SPLIT_TAGS tags), cut to RECIPE_EPOCHS
# epochs (grappa-1.0: RECIPE_V10_EPOCHS), param_loss_epochs 100 ->
# RECIPE_PARAM_LOSS_EPOCHS and val_conf_strategy 500 -> RECIPE_VAL_CONFS;
# card vs CPU on RECIPE_CPU_MOLS x RECIPE_CPU_CONFS a tag, dropout off
RECIPE_DIRS = {'grappa-1.2.1': 'experiments/train-grappa-1.2.1',
               'grappa-1.0': 'experiments/train-grappa-1.0'}
RECIPE_MOLS, RECIPE_CONFS, RECIPE_SPLIT_TAGS = 16, 8, 3
RECIPE_EPOCHS, RECIPE_V10_EPOCHS = 4, 3
RECIPE_PARAM_LOSS_EPOCHS, RECIPE_VAL_CONFS = 3, 16
RECIPE_CPU_MOLS, RECIPE_CPU_CONFS, RECIPE_CPU_EPOCHS = 8, 4, 2

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
    permutations, 3 x 256, out 12); K2 / K2b, K1 / K1b and K3 / K3b also
    in bf16 mode at their shapes (K2.bf16, K2b.bf16, K1.bf16, K1b.bf16,
    K3.bf16, K3b.bf16: the split between wg_gemm.cuh's products and the
    LayerNorm, attention, permuted-row, cast and column-sum passes).
    Beside them one
    torch.matmul (float32, TF32 off) of K2's largest product, 33024 x 1536
    x 512, as a yardstick the port never calls."""
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
    k2h = lambda a, *q: fb.fused_transformer_block(
        a, q, 8, rate, True, seed, mm_dtype=torch.bfloat16)

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
    k1h = lambda a, b, c, *q: fg.fused_gnn_block(
        a, b, c, mask, q, 16, 0.3, True, 17, mm_dtype=torch.bfloat16)

    perms, width, out = PERMUTATIONS['n4'], 256, 12
    layers = [rand_params(torch, gen, [
        ((a,), 'g'), ((a,), 'b'), ((h, a), 'w'), ((h,), 'b'),
        ((o, h), 'w'), ((o,), 'b')]) for a, h, o in (
            (s * f, width, width), (width, width, width), (width, width, out))]
    flat = [q for layer in layers for q in layer]
    k3 = lambda a, *q: fs.fused_symmetriser(
        a, [q[6 * j:6 * j + 6] for j in range(3)], perms)
    k3h = lambda a, *q: fs.fused_symmetriser(
        a, [q[6 * j:6 * j + 6] for j in range(3)], perms,
        mm_dtype=torch.bfloat16)

    dy2 = torch.randn_like(x)
    dy3 = torch.randn((t, out), device='cuda')
    dy1 = torch.randn_like(feat)
    calls = {'K2': lambda: k2(x, *p2),
             'K2b': backward_of(k2, [x, *p2], dy2),
             'K2.bf16': lambda: k2h(x, *p2),
             'K2b.bf16': backward_of(k2h, [x, *p2], dy2),
             'K1': lambda: k1(feat, nbr, hn, *p1),
             'K1b': backward_of(k1, [feat, nbr, hn, *p1], dy1),
             'K1.bf16': lambda: k1h(feat, nbr, hn, *p1),
             'K1b.bf16': backward_of(k1h, [feat, nbr, hn, *p1], dy1),
             'K3': lambda: k3(x, *flat),
             'K3b': backward_of(k3, [x, *flat], dy3),
             'K3.bf16': lambda: k3h(x, *flat),
             'K3b.bf16': backward_of(k3h, [x, *flat], dy3)}
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


def tiled_neighbors(torch, batch, n):
    """The batch's neighbour list (N, D) and mask repeated, each copy's
    indices offset by the batch's N, and cut to n rows; slots that point
    past row n are masked."""
    nb, mk = batch.neighbors, batch.neighbor_mask
    rows = nb.shape[0]
    reps = -(-n // rows)
    nbs = torch.cat([nb + i * rows for i in range(reps)])[:n].clone()
    mks = torch.cat([mk] * reps)[:n].clone()
    past = nbs >= n
    nbs[past] = 0
    mks[past] = False
    return nbs, mks


def call_us(torch, fn, reps=30):
    """Median host us of one call of fn(), each started on an idle card
    (a synchronize before it, outside the clock), so no launch waits for
    room in the queue."""
    times = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times[2:])) * 1e6


def gnn_call_nodes(torch, workloads, train_batch):
    """gnn_calls' node counts: the training run's test, validation and
    train batches (N 64, 224, 1376), the small serving batch (1096), the
    128 x 32 training batch (3376) and bench.py's 512 x 32 batch's N
    (12904) as the 128-molecule batch's neighbour list repeated."""
    src = {f'N={b.neighbors.shape[0]} {label}': b for label, b in (
        ('trainrun test', workloads['trainrun test']),
        ('trainrun val', workloads['trainrun val']),
        ('small', workloads['small']),
        ('trainrun train', workloads['trainrun train']),
        ('train', train_batch))}
    nodes = {k: (b.neighbors, b.neighbor_mask) for k, b in src.items()}
    nodes[f'N={GNN_BIG_N} 512 x 32 (tiled)'] = tiled_neighbors(
        torch, train_batch, GNN_BIG_N)
    return nodes


def gnn_c_entries(torch, lib, ins, n, d, dims, drop, stream, scale):
    """K1 / K1b's C entries of kernel library `lib` in bf16 mode on the
    tensors `ins` (feat, nbr, hn, mask, the 8 parameters, dy), as the
    wrapper calls them, with scratch of their own: (forward, backward), each
    a function of no argument returning the entry's code."""
    f, heads, hid = dims
    # run from a parent checkout, whose scratch entries take no mm_bf16
    mode = (1,) if len(lib.grappa_fused_gnn_scratch.argtypes) == 4 else ()
    feat, nbr, hn, mask, *p1, dy = ins
    fwd_scratch = torch.empty(lib.grappa_fused_gnn_scratch(
        n, f, hid, *mode), dtype=torch.float32, device='cuda')
    y = torch.empty((n, f), device='cuda')
    fwd_args = ([t.data_ptr() for t in (feat, nbr, hn, mask, *p1)]
                + [*drop, fwd_scratch.data_ptr(), y.data_ptr(), n, f, hid, d,
                   heads, scale, 1, stream])
    bwd_scratch = torch.empty(lib.grappa_fused_gnn_bwd_scratch(
        n, f, hid, *mode), dtype=torch.float32, device='cuda')
    grads = [torch.empty_like(t) for t in (feat, nbr, feat, *p1)]
    wr, _, g2, _, w1, _, w2, _ = p1
    bwd_args = ([t.data_ptr() for t in (feat, nbr, mask, wr, g2, w1, w2, dy)]
                + [*drop, fwd_scratch.data_ptr(), bwd_scratch.data_ptr()]
                + [g.data_ptr() for g in grads]
                + [n, f, hid, d, heads, scale, 1, stream])
    keep = (fwd_scratch, y, bwd_scratch, grads)
    return (lambda: (keep, lib.grappa_fused_gnn_fwd(*fwd_args))[1],
            lambda: (keep, lib.grappa_fused_gnn_bwd(*bwd_args))[1])


def runtime_api_us(torch, fn, iters=20):
    """Host us a call of fn() spends in each CUDA runtime call it makes
    (torch.profiler's CUDA runtime events, summed by name); None when the
    profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            torch.cuda.synchronize()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if (e.name.startswith('cuda') and 'Synchronize' not in e.name
                and not str(getattr(e, 'device_type', '')).endswith('CUDA')):
            out[e.name] = out.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / iters
    return out or None


def gnn_calls(torch, nodes, reps=60):
    """K1 and K1b in bf16 mode one call at a time at each node count of
    `nodes` (label -> (neighbour list (N, D), its mask)), default width
    (F = 512, 16 heads, hid 2048, dropout 0.3): `ms` (CUDA events over 20
    calls back to back: the device's or the host's pace, whichever is
    slower), `device_ms` (torch.profiler: the call's kernels) and its
    `launches`, `host_us` (call_us of the op: fused_gnn_block, or
    torch.autograd.grad through it) split into `c_us` (the C entry called
    directly through ctypes, its argument marshalling included) and
    `python_us` (the rest: checks, torch.empty, data_ptr, autograd), and
    `runtime_us`: the C entry's host us in each CUDA runtime call
    (runtime_api_us); for the backward `autograd_us`, call_us of
    torch.autograd.grad through a Function that launches nothing in its
    backward on the same leaves (autograd's own share of python_us: the
    hand-over to the card's autograd thread and back). Prints one
    `gnn_call` line a shape; returns {label: {'fwd': ..., 'bwd': ...}}."""
    from grappa_tpu_torch.ops import _cuda, philox
    from grappa_tpu_torch.ops import fused_gnn as fg

    class PassThrough(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *xs):
            ctx.n = len(xs)
            return xs[0] * 1.0

        @staticmethod
        def backward(ctx, dy):
            return (dy,) + (None,) * (ctx.n - 1)

    gen = torch.Generator().manual_seed(97531)
    f, heads, hid, rate, seed = 512, 16, 2048, 0.3, 17
    lib, bf16 = _cuda.lib(), torch.bfloat16
    out = {}
    for label, (nb, nmask) in nodes.items():
        n, d = nb.shape
        feat = torch.randn((n, f), generator=gen).cuda()
        hn = torch.randn((n, f), generator=gen).cuda()
        nbr = feat[nb.t()].contiguous()
        mask = nmask.t().float().contiguous()
        p1 = rand_params(torch, gen, [
            ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
            ((hid, f), 'w'), ((hid,), 'b'), ((f, hid), 'w'), ((f,), 'b')])
        leaves = [q.detach().clone().requires_grad_(True)
                  for q in (feat, nbr, hn, *p1)]
        fwd = lambda: fg.fused_gnn_block(feat, nbr, hn, mask, p1, heads,
                                         rate, True, seed, mm_dtype=bf16)
        y = fg.fused_gnn_block(leaves[0], leaves[1], leaves[2], mask,
                               leaves[3:], heads, rate, True, seed,
                               mm_dtype=bf16)
        dy = torch.randn((n, f), generator=gen).cuda()
        bwd = lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)
        y0 = PassThrough.apply(*leaves)
        engine = lambda: torch.autograd.grad(y0, leaves, dy,
                                             retain_graph=True,
                                             allow_unused=True)
        # the C entries alone, on the same tensors, as the wrapper calls them
        c_args = ([feat, nbr, hn, mask, *p1, dy], n, d, (f, heads, hid),
                  philox.kernel_args(seed, rate), _cuda.stream_of(feat),
                  _cuda.head_scale(f // heads))
        c_fwd, c_bwd = gnn_c_entries(torch, lib, *c_args)
        for fn, name in ((c_fwd, 'fwd'), (c_bwd, 'bwd')):
            _cuda.check(fn(), f'grappa_fused_gnn_{name}')
        torch.cuda.synchronize()
        line = {'n': n, 'slots': d, 'real_slots': int(nmask.sum())}
        for part, op, c_entry in (('fwd', fwd, c_fwd), ('bwd', bwd, c_bwd)):
            events = device_events(torch, op, 3) or []
            host, c_us = call_us(torch, op, reps), call_us(torch, c_entry,
                                                           reps)
            line[part] = {
                'ms': timed(torch, op, iters=50), 'device_ms': (
                    sum(ms for _, ms in events) / 3 if events else None),
                'launches': len(events) // 3 if events else None,
                'host_us': host, 'c_us': c_us, 'python_us': host - c_us,
                'runtime_us': runtime_api_us(torch, c_entry)}
        line['bwd']['autograd_us'] = call_us(torch, engine, reps)
        print(f'gnn_call {label} ' + json.dumps(line), flush=True)
        out[label] = line
    return out


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


def sass_functions(so):
    """{mangled name: opcodes} of every function's SASS in the built
    library (cuobjdump -sass), padding NOPs and the branch to itself after
    the last EXIT (never issued) left out."""
    from grappa_tpu_torch.ops import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', str(so)], capture_output=True,
                          text=True, timeout=300).stdout
    out = {}
    for m in re.finditer(r'Function : (\S+)\n(.*?)(?=\n\s*Function :|\Z)',
                         sass, re.S):
        ops = re.findall(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?'
                         r'([A-Z][A-Za-z0-9_.]*)', m.group(2))
        ops = [op for op in ops if op != 'NOP']
        out[m.group(1)] = (ops[:len(ops) - ops[::-1].index('EXIT')]
                           if 'EXIT' in ops else ops)
    return out


def sass_opcodes(so, kernel):
    """The opcodes of the first function whose name holds `kernel`
    (sass_functions); None when the library lacks it."""
    return next((ops for name, ops in sass_functions(so).items()
                 if kernel in name), None)


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


def kernel_cases(torch, workloads, n4_out=12):
    """Every forward kernel's case at the shapes each workload's forward
    gives it (its padded N, neighbour list and tuple counts), on seeded
    inputs: (name, label, kernel(mm_dtype), plain(mm_dtype), flops,
    nbytes, on_path), made one at a time (the same inputs on every call).
    n4_out: the proper writer's symmetriser outputs (2 x the gated
    periodicity: 12 at the default 6, 6 at the 1.1+ recipes' 3)."""
    from grappa_tpu_torch.data.graph_batch import TERM_ARITY, TERMS
    from grappa_tpu_torch.ops import fused_block as fb
    from grappa_tpu_torch.ops import fused_gnn as fg
    from grappa_tpu_torch.ops import fused_symmetriser as fs
    from grappa_tpu_torch.models.heads import (PERMUTATIONS,
                                               WRONG_SYMMETRY_IMPROPER)
    gen = torch.Generator().manual_seed(1234)
    f, heads, hid, hid2, width = 512, 16, 2048, 512, 256
    sym_out = {'n2': 2, 'n3': 2, 'n4': n4_out, 'n4_improper': 6}

    def sym_case(perms, t, out, label, on_path=True):
        s = len(perms[0])
        x = torch.randn((s, t, f), generator=gen).cuda()
        dims = [(s * f, width, width), (width, width, width),
                (width, width, out)]
        layers = [rand_params(torch, gen, [
            ((i,), 'g'), ((i,), 'b'), ((h, i), 'w'), ((h,), 'b'),
            ((o, h), 'w'), ((o,), 'b')]) for i, h, o in dims]
        macs = sum(i * h + h * o for i, h, o in dims)
        return ('fused_symmetriser', f'{label} S={s} T={t} '
                f'perms={len(perms)} out={out}',
                lambda dt: fs.fused_symmetriser(x, layers, perms, dt),
                lambda dt: fs.reference_symmetriser(x, layers, perms, dt),
                2 * len(perms) * t * macs,
                4 * (s * t * f + sum(p.numel() for layer in layers
                                     for p in layer) + t * out), on_path)

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
        yield ('fused_gnn_block', f'{label} N={n} F={f} H={heads} D={d}',
               lambda dt: fg.fused_gnn_block(feat, nbr, hn, mask, p1, heads,
                                             mm_dtype=dt),
               lambda dt: fg.reference_gnn_block(feat, nbr, hn, mask, p1,
                                                 heads, mm_dtype=dt),
               2 * n * (f * f + 2 * f * hid) + 4 * real_slots * f,
               4 * ((2 + d) * n * f + d * n + sum(p.numel() for p in p1)
                    + n * f), True)

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
            yield ('fused_transformer_block', f'{label} S={s} T={t} F={f} '
                   f'H=8',
                   lambda dt, x=x, p2=p2: fb.fused_transformer_block(
                       x, p2, 8, mm_dtype=dt),
                   lambda dt, x=x, p2=p2: fb.reference_block(
                       x, p2, 8, mm_dtype=dt),
                   2 * r * (4 * f * f + 2 * f * hid2) + 4 * t * s * s * f,
                   4 * (2 * r * f + sum(p.numel() for p in p2)), True)
            yield sym_case(PERMUTATIONS[term], t, sym_out[term], label)

    # the 6-permutation improper case (wrong_symmetry), off the default path
    yield sym_case(WRONG_SYMMETRY_IMPROPER, 552, 6, 'wrong_symmetry',
                   on_path=False)


def kernel_phase(torch, workloads):
    """Phase 2: every kernel against its plain version at the shapes each
    workload's forward gives it. Returns the per-kernel JSON entries
    (launch counts filled in by phase 3)."""
    entries = {}
    for name, label, kernel, plain, flops, nbytes, on_path in kernel_cases(
            torch, workloads):
        compare_out(torch, entries, name, label, lambda: kernel(None),
                    lambda: plain(None), flops=flops, nbytes=nbytes,
                    on_path=on_path)
    return entries


def training_batches(torch, start=0, stop=TRAIN_MOLS):
    """Molecules start..stop-1 of the JAX package's training bench batches
    (bench.py: n_atoms = rng.integers(8, 44) drawn one a molecule with rng
    = default_rng(123), seed 123 + i, 32 conformers; the first 128 are the
    headline batch, the first 512 build_big_batch's), as MolGraphs."""
    from grappa_tpu_torch.data.graph_batch import MolGraph
    from grappa_tpu_torch.data.synthetic import make_moldata
    rng = np.random.default_rng(TRAIN_SEED)
    sizes = [int(rng.integers(8, 44)) for _ in range(stop)]
    t0 = time.time()
    graphs = [MolGraph.from_moldata(make_moldata(
        seed=TRAIN_SEED + i, n_confs=TRAIN_CONFS, n_atoms=sizes[i]))
        for i in range(start, stop)]
    print(f'built molecules {start}-{stop - 1} x {TRAIN_CONFS} conformers '
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


def training_cases(torch, batches, n4_out=12):
    """K1b-K3b's cases at the shapes one training step gives them on each
    of `batches` (label -> batch), dropout on at the default rates (K1
    0.3, K2 0.5; K3 has none), on seeded inputs: dicts with the op's name,
    a label, the inputs, dy, kernel(mm_dtype) and plain(mm_dtype) (each a
    function of the inputs; plain runs on the inputs' device), the
    forward's and the backward's FLOPs and bytes, and what the mask dumps
    need (`masks`: (op module, shape, rate, seed) on the 'train' batch).
    n4_out: as kernel_cases'."""
    from grappa_tpu_torch.data.graph_batch import TERM_ARITY, TERMS
    from grappa_tpu_torch.models.heads import PERMUTATIONS
    from grappa_tpu_torch.ops import fused_block as fb
    from grappa_tpu_torch.ops import fused_gnn as fg
    from grappa_tpu_torch.ops import fused_symmetriser as fs
    from grappa_tpu_torch.ops import philox
    gen = torch.Generator().manual_seed(4321)
    # K2b's and K3b's dy, drawn on the card from a generator of their own
    # so that every other input stays what `gen` gives it
    dy_gen = torch.Generator(device='cuda').manual_seed(4321)
    f, heads, hid, hid2, width = 512, 16, 2048, 512, 256
    sym_out = {'n2': 2, 'n3': 2, 'n4': n4_out, 'n4_improper': 6}
    on = lambda ts, a: tuple(t.to(a.device) for t in ts)

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
        yield dict(
            name='fused_gnn_block', label=f'{label} N={n} D={d} dropout '
            f'{rate1}', inputs=[feat, nbr, hn, *p1],
            dy=torch.randn((n, f), generator=gen).cuda(),
            kernel=lambda dt: lambda a, b, c, *q: fg.fused_gnn_block(
                a, b, c, mask, q, heads, rate1, True, seed1, mm_dtype=dt),
            plain=lambda dt: lambda a, b, c, *q: fg.reference_gnn_block(
                a, b, c, mask.to(a.device), q, heads, on(masks1, a), dt),
            fwd=(fwd1, 4 * (in1 + n * f)),
            bwd=(2 * fwd1, 4 * (2 * in1 - d * n + n * f)),
            masks=(fg, (n, f), rate1, seed1) if label == 'train' else None)

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
            yield dict(
                name='fused_transformer_block', label=f'{label} S={s} T={t} '
                f'dropout {rate2}', inputs=[x, *p2],
                dy=torch.randn(x.shape, generator=dy_gen, device='cuda'),
                kernel=lambda dt, seed2=seed2: lambda a, *q: (
                    fb.fused_transformer_block(a, q, 8, rate2, True, seed2,
                                               mm_dtype=dt)),
                plain=lambda dt, masks2=masks2: lambda a, *q: (
                    fb.reference_block(a, q, 8, on(masks2, a), dt)),
                fwd=(fwd2, 4 * (in2 + r * f)),
                bwd=(2 * fwd2, 4 * (2 * in2 + r * f)),
                masks=((fb, (s, t, f), rate2, seed2)
                       if term == 'n4' and label == 'train' else None))

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
            yield dict(
                name='fused_symmetriser', label=f'{label} S={s} T={t} '
                f'perms={len(perms)}', inputs=[x, *flat],
                dy=torch.randn((t, out), generator=dy_gen, device='cuda'),
                kernel=lambda dt, perms=perms: lambda a, *q: (
                    fs.fused_symmetriser(a, split(q), perms, dt)),
                plain=lambda dt, perms=perms: lambda a, *q: (
                    fs.reference_symmetriser(a, split(q), perms, dt)),
                fwd=(fwd3, 4 * (in3 + t * out)),
                bwd=(2 * fwd3, 4 * (2 * in3 + t * out)), masks=None)


def training_kernel_phase(torch, batches, entries):
    """Phase 4: the kernels at the shapes one training step gives them on
    each of `batches` (training_cases), dropout on at the default rates;
    the mask dumps, off every main path, at the 'train' batch alone."""
    from grappa_tpu_torch.ops import philox
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

    for c in training_cases(torch, batches):
        x = c['inputs']
        compare(c['name'], c['label'], lambda: c['kernel'](None)(*x),
                lambda: c['plain'](None)(*x), flops=c['fwd'][0],
                nbytes=c['fwd'][1])
        compare_grad(torch, entries, c['name'] + '.backward', c['label'],
                     c['kernel'](None), c['plain'](None), x, c['dy'],
                     flops=c['bwd'][0], nbytes=c['bwd'][1])
        if c['masks'] is not None:
            op, shape, rate, seed = c['masks']
            mask_check(op, op.__name__.rsplit('.', 1)[1] + '.dropout_masks',
                       shape, rate, seed)


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


def no_dropout(cfg):
    """The model config `cfg` with every dropout rate 0."""
    return dict(cfg, gnn_dropout_attention=0.0, parameter_dropout=0.0,
                gnn_dropout_final=0.0, gnn_dropout_initial=0.0,
                gnn_dropout_conv=0.0)


def step_card_vs_cpu(torch, label, cfg, graphs, confs=4):
    """The loss and gradients of one training-mode forward of the model
    `cfg` (dropout off; perturbed_model's weights) on `graphs` x `confs`
    conformers with the QM-phase weights, on the card (kernels) and on the
    CPU (plain path): the loss at STEP_LOSS_RTOL, every gradient's
    relative L2 at STEP_GRAD_RL2. Returns the batch on the card."""
    from grappa_tpu_torch.data.graph_batch import collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.train.trainer import loss_gradients
    pad = bucketed_pad_spec(graphs, confs)
    b_cpu = collate(graphs, pad, confs, device='cpu')
    b_gpu = collate(graphs, pad, confs, device='cuda')
    cpu_model = perturbed_model(torch, make_model, cfg)
    gpu_model = make_model(cfg).cuda()
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
          f'{label} step on the card vs the CPU ({len(graphs)} molecules x '
          f'{confs} conformers, N={b_gpu.xyz.shape[0]}, dropout off): loss '
          f'{l_gpu:.6e} vs {l_cpu:.6e} (rtol {STEP_LOSS_RTOL}); worst '
          f'gradient relative L2 {worst[0]:.3e} ({worst[1]}; tol '
          f'{STEP_GRAD_RL2}) over {len(g_cpu)} tensors; CPU step '
          f'{cpu_s:.1f} s')
    return b_gpu


def training_phase(torch, graphs, batch, cfg):
    """Phase 5: (a) card vs CPU step, (b) ten steps with dropout on the
    128 x 32 batch, (c) overfitting. Returns the launches of (b)."""
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    from grappa_tpu_torch.train.loss import molwise_loss
    from grappa_tpu_torch.train.trainer import make_optimizer, make_train_step

    no_drop = no_dropout(cfg)
    few = graphs[:8]
    # (a) the same step on the card (kernels) and on the CPU (plain path)
    b_gpu = step_card_vs_cpu(torch, '(a)', no_drop, few)

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


def serving_state(torch, make_model, cfg):
    """The serving phases' weights: the model's seeded init, every
    parameter moved by seeded noise (the zero-initialised branches --
    head_reducer, out_proj, ... -- and the biases become non-zero too), as
    a CPU state_dict."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            scale = 0.02 if p.dim() >= 2 else 0.05
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return {k: v.clone() for k, v in model.state_dict().items()}


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
    cpu_state = serving_state(torch, make_model, cfg)
    model = make_model(cfg)
    model.load_state_dict(cpu_state)
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


def compare_bf16(torch, entries, name, label, kernel, plain, flops, nbytes,
                 on_path=True):
    """Phase 10(a): a forward kernel in bf16 mode against its plain version
    in bf16 mode on the same inputs, the error measured against the bf16
    effect (plain bf16 against plain float32); adds its error, times (the
    bf16 kernel, its plain version, the float32 kernel at the same shape)
    and bf16 bound to `entries[name + '.bf16']` when on_path."""
    bf16 = torch.bfloat16
    y16, p16, p32 = kernel(bf16), plain(bf16), plain(None)
    torch.cuda.synchronize()
    err, eff = (y16 - p16).abs(), (p16 - p32).abs()
    mean_ratio = float(err.mean()) / max(float(eff.mean()), 1e-30)
    max_ratio = float(err.max()) / max(float(eff.max()), 1e-30)
    ok = (bool(torch.isfinite(y16).all()) and mean_ratio <= BF16_RULE
          and max_ratio <= BF16_MAX)
    ms = timed(torch, lambda: kernel(bf16))
    plain_ms = timed(torch, lambda: plain(bf16))
    f32_ms = timed(torch, lambda: kernel(None))
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    check(ok, f'{name} bf16 {label}: mean err / bf16 effect {mean_ratio:.3e}'
              f' (tol {BF16_RULE}), max {max_ratio:.3e} (tol {BF16_MAX}), '
              f'max_abs_err {float(err.max()):.3e}; kernel {ms:.4f} ms, '
              f'plain {plain_ms:.4f} ms, float32 kernel {f32_ms:.4f} ms, '
              f'bf16 bound {b_ms:.4f} ms ({b_by})')
    if on_path:
        accumulate(entries, name + '.bf16', float(err.max()), ms, plain_ms,
                   flops, nbytes, PEAK_BF16_FLOPS)
        e = entries[name + '.bf16']
        e['f32_ms'] = e.get('f32_ms', 0.0) + f32_ms


def bf16_sass(torch):
    """Phase 10(d): every tensor-core GEMM kernel of the built library runs
    its engine's instruction. Every instantiation of wg_gemm.cuh's kernel
    (the bf16 products of K1 / K1b, K2 / K2b and K3 / K3b; each file's
    MN-major and split-K ones among them) has a bf16 warpgroup mma (HGMMA
    ... BF16) and no mma.sync (HMMA); every tc_gemm_kernel (the float32
    products) TF32_HMMA and no bf16 mma; no function of the library holds
    a bf16 mma.sync (BF16_HMMA) and no name a TcBf16 instantiation: the
    mma.sync bf16 engine is gone."""
    from grappa_tpu_torch.ops import _cuda
    tc, wg, bf16_mma = [], [], []
    for name, ops in sass_functions(_cuda.build()).items():
        if 'tc_gemm_kernel' in name:
            tc.append((name, sorted(
                {op for op in ops if op.startswith('HMMA')})))
        if 'wg_gemm_kernel' in name:
            wg.append((name, sorted(
                {op for op in ops if op.startswith(('HGMMA', 'HMMA'))})))
        if 'TcBf16' in name or BF16_HMMA in ops:
            bf16_mma.append(name)
    # an anonymous namespace's mangled name carries its file's name; the
    # layouts are the kernel's bool template arguments (mangled Lb0E: an
    # MN-major operand); the split-K partial store is the Partial epilogue
    per_file = {src: [(name, h) for name, h in wg if f'{src}_cu' in name]
                for src in ('fused_gnn', 'fused_block', 'fused_symmetriser')}
    counts = {src: (len(found), sum('Lb0E' in name for name, _ in found),
                    sum('Partial' in name for name, _ in found))
              for src, found in per_file.items()}
    check(bool(wg) and all(n > 0 and mn > 0 and split > 0
                           for n, mn, split in counts.values()) and all(
        any(op.startswith('HGMMA') and 'BF16' in op for op in h)
        and not any(op.startswith('HMMA') for op in h) for _, h in wg),
          f'SASS: {len(wg)} wg_gemm_kernel instantiations (by file: '
          f'instantiations, with an MN-major operand, split-K: {counts}), '
          f'each with a bf16 HGMMA and no HMMA (their opcodes: '
          f'{sorted({op for _, h in wg for op in h})})')
    check(not bf16_mma, f'SASS: no TcBf16 instantiation and no '
                        f'{BF16_HMMA} in any function ({len(bf16_mma)} '
                        f'found: {bf16_mma[:3]})')
    mn = sum('Lb0E' in name for name, _ in tc)
    split = sum('Partial' in name for name, _ in tc)
    check(bool(tc) and mn > 0 and split > 0
          and all(TF32_HMMA in h and BF16_HMMA not in h for _, h in tc),
          f'SASS: {len(tc)} tc_gemm_kernel instantiations (float32: {mn} '
          f'with an MN-major operand, {split} split-K), each with '
          f'{TF32_HMMA} and without {BF16_HMMA} (their HMMA opcodes: '
          f'{sorted({op for _, h in tc for op in h})})')


def bf16_kernel_phase(torch, workloads, entries):
    """Phase 10(a) and (d): K1-K3 in bf16 mode against their plain bf16
    versions at every workload's shapes (compare_bf16), and the library's
    SASS (bf16_sass)."""
    phase('10(a). K1-K3 in bf16 mode (compute_dtype=\'bfloat16\') against '
          'their plain bf16 versions')
    for name, label, kernel, plain, flops, nbytes, on_path in kernel_cases(
            torch, workloads):
        compare_bf16(torch, entries, name, label, kernel, plain, flops,
                     nbytes, on_path)
    phase('10(d). the bf16 mode\'s SASS')
    bf16_sass(torch)


def bf16_predict_phase(torch, cfg, smalls, protein, paths):
    """Phase 10(b): predict_many at the default width with
    compute_dtype='bfloat16' on both serving paths: the bf16 launches 7 /
    12 / 4 a forward (no float32 launch), finite outputs against the same
    model on the CPU (fused, the plain bf16 versions), warm latency beside
    the float32 model's on the same weights. Returns the bf16 launches per
    path."""
    from grappa_tpu_torch import Grappa
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    phase('10(b). predict_many in bf16, default config, seeded non-zero '
          'weights')
    print(f'cuBLAS bf16 reduced-precision reductions (the bf16 Dense '
          f'products outside the kernels: fc, rep_projector): '
          f'{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}'
          , flush=True)
    cfg16 = dict(cfg, compute_dtype='bfloat16')
    fused = dict(fused_gnn=True, fused_heads=True)
    state = serving_state(torch, make_model, cfg)
    # the same weights, each moved by one float32 ulp (a seeded direction)
    gen = torch.Generator().manual_seed(2)
    ulp_state = {k: torch.nextafter(v, torch.where(
        torch.rand(v.shape, generator=gen) < 0.5, -np.inf, np.inf))
        if v.is_floating_point() else v for k, v in state.items()}
    models = {}
    for label, c, device, sd in (
            ('bf16', cfg16, 'cuda', state), ('f32', cfg, 'cuda', state),
            ('bf16 ulp', cfg16, 'cuda', ulp_state),
            ('cpu bf16', dict(cfg16, **fused), 'cpu', state),
            ('cpu f32', dict(cfg, **fused), 'cpu', state)):
        m = make_model(c)
        m.load_state_dict(sd, strict=True)
        models[label] = Grappa(m, {'model_config': c}, device=device)
    ff16, ff32 = models['bf16'], models['f32']
    for ff in (ff16, ff32):
        ff.predict_many(smalls, check_eq_values=False)     # warm-up
        ff.predict(protein, check_eq_values=False)
    torch.cuda.synchronize()

    # each path is read on its own: the counts are set to 0 just before its
    # predict and read just after
    counters = (fused_gnn_block, fused_transformer_block, fused_symmetriser)
    launches = {f'{c.__name__}.bf16': {} for c in counters}
    for label, mols in paths.items():
        for c in counters:
            c.launches = c.bf16_launches = 0
        card = stack(ff16.predict_many(mols, check_eq_values=False))
        torch.cuda.synchronize()
        got = {c.__name__: c.bf16_launches for c in counters}
        f32 = {c.__name__: c.launches for c in counters}
        for name, n in got.items():
            launches[f'{name}.bf16'][label] = n
        check(got == {'fused_gnn_block': 7, 'fused_transformer_block': 12,
                      'fused_symmetriser': 4} and not any(f32.values()),
              f'{label} bf16: bf16 launch counts of one forward {got} '
              f'(7 / 12 / 4), float32 launches {f32} (none)')
        check(all(np.isfinite(v).all() for v in card.values()),
              f'{label} bf16: all outputs finite')
        compare_bf16_outputs(label, card, *(stack(models[k].predict_many(
            mols, check_eq_values=False)) for k in (
                'f32', 'bf16 ulp', 'cpu bf16', 'cpu f32')))
    graphs = [MolGraph.from_molecule(m) for m in smalls]
    bf16_stages(torch, ff16.model, models['cpu bf16'].model,
                models['cpu f32'].model,
                collate(graphs, bucketed_pad_spec(graphs, 1), 1,
                        device='cpu'))
    for name, mols in (('small x32', smalls), ('protein 1224 atoms',
                                                [protein])):
        graphs = [MolGraph.from_molecule(m) for m in mols]
        b = collate(graphs, bucketed_pad_spec(graphs, 1), 1)
        for label, ff in (('bf16', ff16), ('float32', ff32)):
            med, runs = host_ms(torch, lambda: ff.predict_many(
                mols, check_eq_values=False), reps=7)
            with torch.inference_mode():
                fwd = timed(torch, lambda: ff.model(b), iters=10)
            print(f'warm predict {name}, {label} kernels: median {med:.2f} '
                  f'ms (runs {runs}); forward {fwd:.2f} ms on the card '
                  f'(CUDA events, mean of 10)', flush=True)

    return launches


def stage_ratio(card, cpu16, cpu32):
    """(mean |card - cpu16| / mean |cpu16 - cpu32|, the same of the
    maxima), the card's output brought to the host."""
    card = card.detach().float().cpu()
    err, eff = (card - cpu16).abs(), (cpu16 - cpu32).abs()
    return (float(err.mean()) / max(float(eff.mean()), 1e-30),
            float(err.max()) / max(float(eff.max()), 1e-30))


def bf16_stages(torch, card, cpu16, cpu32, batch):
    """Phase 10(b): every bf16 stage of the model on the card against the
    CPU (fused, the plain bf16 versions) on the same input, the CPU's own
    input to that stage: each GNN attention block (the LayerNorm, fc in
    bf16 through cuBLAS, K1), each writer's RepProjector (a bf16 Dense and
    elu), its transformer blocks (K2) and its Symmetriser (K3). Mean error
    <= BF16_RULE x the stage's bf16 effect (the CPU's float32 model on
    the same input)."""
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    seen = {}

    def keep(name):
        def hook(mod, args, out):
            seen[name] = (args, out)
        return hook

    gnn16, gnn32 = cpu16.gnn, cpu32.gnn
    hooks = [m.register_forward_hook(keep(f'gnn block {i}'))
             for i, m in enumerate(gnn16.att_blocks)]
    w16, w32, wc = (m.parameter_writer for m in (cpu16, cpu32, card))
    writers = ('bond_writer', 'angle_writer', 'proper_writer',
               'improper_writer')
    for name in writers:
        head = getattr(w16, name)
        hooks += [head.rep_projector.register_forward_hook(
                      keep(f'{name} rep_projector')),
                  head_model(head).grappa_transformer.register_forward_hook(
                      keep(f'{name} transformer')),
                  head_model(head).symmetriser.register_forward_hook(
                      keep(f'{name} symmetriser'))]
    with torch.inference_mode():
        cpu16(batch)
    for h in hooks:
        h.remove()
    ratios = {}
    to_card = lambda args: [a.cuda() if torch.is_tensor(a) else a
                            for a in args]
    with torch.inference_mode():
        for i, (blk16, blk32, blkc) in enumerate(zip(
                gnn16.att_blocks, gnn32.att_blocks, card.gnn.att_blocks)):
            args, out = seen[f'gnn block {i}']
            ratios[f'gnn block {i}'] = stage_ratio(blkc(*to_card(args)), out,
                                                   blk32(*args))
        for name in writers:
            h16, h32, hc = (getattr(w, name) for w in (w16, w32, wc))
            args, out = seen[f'{name} rep_projector']
            ratios[f'{name} rep_projector'] = stage_ratio(
                hc.rep_projector(*to_card(args)), out,
                h32.rep_projector(*args))
            # the transformer blocks one by one, each on the CPU's input
            t16, t32, tc = (head_model(h).grappa_transformer
                            for h in (h16, h32, hc))
            x = seen[f'{name} transformer'][0][0]
            if t16.positional_encoding is not None:
                pos = t16.positional_encoding[:, None, :].expand(
                    -1, x.shape[1], -1)
                x = torch.cat([x, pos], dim=-1)
            for j, (b16, b32, bc) in enumerate(zip(
                    t16.transformer, t32.transformer, tc.transformer)):
                y16 = fused_transformer_block(x, b16.fused_params(),
                                              b16.num_heads,
                                              mm_dtype=torch.bfloat16)
                ratios[f'{name} transformer block {j}'] = stage_ratio(
                    fused_transformer_block(x.cuda(), bc.fused_params(),
                                            bc.num_heads,
                                            mm_dtype=torch.bfloat16),
                    y16, fused_transformer_block(x, b32.fused_params(),
                                                 b32.num_heads))
                x = y16
            args, out = seen[f'{name} symmetriser']
            ratios[f'{name} symmetriser'] = stage_ratio(
                head_model(hc).symmetriser(*to_card(args)), out,
                head_model(h32).symmetriser(*args))
    for name, (mean_ratio, max_ratio) in ratios.items():
        check(mean_ratio <= BF16_RULE,
              f'bf16 stage {name}, card vs CPU on the CPU\'s input: mean '
              f'err / bf16 effect {mean_ratio:.3e} (tol {BF16_RULE}), max '
              f'{max_ratio:.3e}')


def head_model(head):
    """A writer's TupleHead (the reference's bond_model / angle_model /
    torsion_model)."""
    return getattr(head, getattr(head, 'model_name', 'torsion_model'))


def compare_bf16_outputs(label, card16, card32, card_ulp, cpu16, cpu32):
    """The card's bf16 predict_many against the CPU's (fused, the plain bf16
    versions), per output over the whole model. bf16 cascades: a float32
    sum in another order flips a bf16 rounding now and then, the flipped
    operand moves its product by a whole bf16 ulp, and the next roundings
    spread it; over 7 GNN blocks and a writer's 3 + 3 layers two
    evaluations that differ only in float32 order part by a good share of
    the bf16 effect. The floor is measured: the card's own bf16 model with
    every weight moved by one float32 ulp. Checked: mean |card - CPU| <=
    max(BF16_RULE, 1.25 x that floor) x the CPU's bf16 effect (the card
    is no further from the CPU than from itself), and the card's bf16
    effect (card bf16 - card float32) within 0.8-1.25 of the CPU's (the
    same roundings in the same places). bf16_stages holds each stage to
    BF16_RULE. Torsion ks that the hard cutoff sends to 0 on one side only
    are left out."""
    for key in card16:
        outs = (card16[key], card32[key], card_ulp[key], cpu16[key],
                cpu32[key])
        a = outs[0]
        ok = all(o.shape == a.shape for o in outs) and bool(
            np.isfinite(a).all())
        keep = np.ones(a.shape, bool)
        if key.endswith('_ks'):
            for o in outs[1:]:
                keep &= (np.abs(o) > TORSION_CUTOFF) == (
                    np.abs(a) > TORSION_CUTOFF)
            ok &= keep.mean() > 0.95 if keep.size else True
        c16, c32, cu, p16, p32 = (o[keep] for o in outs)
        eff = max(float(np.abs(p16 - p32).mean()), 1e-30)
        ratio = float(np.abs(c16 - p16).mean()) / eff
        floor = float(np.abs(cu - c16).mean()) / eff
        effect = float(np.abs(c16 - c32).mean()) / eff
        tol = max(BF16_RULE, 1.25 * floor)
        ok &= ratio <= tol and 0.8 <= effect <= 1.25
        check(ok, f'{label} bf16 {key} {a.shape}: card vs CPU mean err / '
                  f'bf16 effect {ratio:.3e} (tol {tol:.3e}: 1.25 x the card '
                  f'against itself with weights 1 float32 ulp apart, '
                  f'{floor:.3e}), card bf16 effect / CPU bf16 effect '
                  f'{effect:.3f} (tol 0.8-1.25), CPU bf16 effect mean '
                  f'{eff:.3e}'
                  + (f', {int((~keep).sum())} cutoff flips left out'
                     if key.endswith('_ks') else ''))


BF16_COUNTS = ('launches', 'bf16_launches', 'bwd_launches',
               'bf16_bwd_launches')


def bf16_counters():
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    return (fused_gnn_block, fused_transformer_block, fused_symmetriser)


def zero_counts(counters):
    for c in counters:
        for k in BF16_COUNTS:
            setattr(c, k, 0)


def read_counts(counters):
    """{op: (float32 forward, bf16 forward, float32 backward, bf16
    backward) launches}."""
    return {c.__name__: tuple(getattr(c, k) for k in BF16_COUNTS)
            for c in counters}


def want_counts(gnn16, heads16, forwards=1, backwards=1):
    """The launches a run of `forwards` forwards and `backwards` backwards
    of the default model gives, each stage in bf16 mode or float32."""
    def of(n, bf16):
        f, b = n * forwards, n * backwards
        return (0, f, 0, b) if bf16 else (f, 0, b, 0)
    return {'fused_gnn_block': of(7, gnn16),
            'fused_transformer_block': of(12, heads16),
            'fused_symmetriser': of(4, heads16)}


def compare_grad_bf16(torch, entries, case):
    """Phase 10(c)(a): a backward kernel in bf16 mode against autograd
    through its plain bf16 version on the same inputs and dropout masks.
    Per gradient tensor: mean |kernel - plain| <= max(BF16_RULE x the bf16
    effect (plain bf16 - plain float32), BF16_ORDER x the plain bf16
    version's own distance on the CPU, the same arithmetic in another
    float32 order; computed only where the first is exceeded), max <=
    BF16_MAX x the effect's max; a gradient bf16 leaves as it is at
    GRAD_RTOL. Times the backward alone (the bf16 kernel, its plain
    version, the float32 kernel) into entries[name + '.bf16_bwd'], with
    the bf16 bound."""
    bf16, x, dy = torch.bfloat16, case['inputs'], case['dy']

    def graph(fn, dt, device='cuda'):
        leaves = [t.detach().to(device).clone().requires_grad_(True)
                  for t in x]
        return fn(dt)(*leaves), leaves

    runs = {k: graph(case[fn], dt) for k, fn, dt in (
        ('k16', 'kernel', bf16), ('p16', 'plain', bf16),
        ('p32', 'plain', None), ('k32', 'kernel', None))}
    bwd = {k: (lambda y=y, l=l: torch.autograd.grad(y, l, dy,
                                                   retain_graph=True))
           for k, (y, l) in runs.items()}
    gk, gp, g32 = bwd['k16'](), bwd['p16'](), bwd['p32']()
    torch.cuda.synchronize()
    ok, max_abs, ratios = True, 0.0, {}
    for i, (a, b, c) in enumerate(zip(gk, gp, g32)):
        err, eff = (a - b).abs(), (b - c).abs()
        scale = max(float(c.abs().max()), 1e-30)
        ok &= bool(torch.isfinite(a).all())
        max_abs = max(max_abs, float(err.max()))
        if float(eff.max()) <= 1e-6 * scale:
            ok &= float(err.max()) <= GRAD_RTOL * scale
            continue
        ratios[i] = [float(err.mean() / eff.mean()),
                     float(err.max() / eff.max()), 0.0]
    if any(r[0] > BF16_RULE for r in ratios.values()):
        y, leaves = graph(case['plain'], bf16, 'cpu')
        gc = torch.autograd.grad(y, leaves, dy.cpu())
        for i, r in ratios.items():
            r[2] = float((gc[i].to(gp[i].device) - gp[i]).abs().mean()
                         / (gp[i] - g32[i]).abs().mean())
    for mean_r, max_r, order in ratios.values():
        ok &= mean_r <= max(BF16_RULE, BF16_ORDER * order)
        ok &= max_r <= BF16_MAX
    worst = max(ratios.values(), key=lambda r: r[0] / max(
        BF16_RULE, BF16_ORDER * r[2]))
    ms = timed(torch, bwd['k16'], iters=5)
    plain_ms = timed(torch, bwd['p16'], iters=5)
    f32_ms = timed(torch, bwd['k32'], iters=5)
    flops, nbytes = case['bwd']
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    name = case['name'] + '.bf16_bwd'
    check(ok, f'{name} {case["label"]}: {len(gk)} gradients, {len(ratios)} '
              f'moved by bf16; worst mean err / bf16 effect {worst[0]:.3e} '
              f'(tol max({BF16_RULE}, {BF16_ORDER} x the CPU\'s plain bf16 '
              f'{worst[2]:.3e})), max over gradients of max err / effect '
              f'max {max(r[1] for r in ratios.values()):.3e} (tol '
              f'{BF16_MAX}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
              f'float32 kernel {f32_ms:.4f} ms, bf16 bound {b_ms:.4f} ms '
              f'({b_by}, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)')
    accumulate(entries, name, max_abs, ms, plain_ms, flops, nbytes,
               PEAK_BF16_FLOPS)
    entries[name]['f32_ms'] = entries[name].get('f32_ms', 0.0) + f32_ms


def gnn_gap_readings(torch):
    """K1b bf16 at GAP_N = 40 rows (F 512, D 8) with head width 128 (4
    heads) and 256 (2 heads, whose attention passes take the float32
    kernels' rows, as bf16 mode does above dh 128), dropout off, on
    tests/test_torch_port_kernels.py's `_gnn_case` inputs for seeds 0 to
    GAP_SEEDS - 1 (seed 0 is that file's; dy from seed 7): each gradient's
    mean error against the card's plain bf16 version in units of the bf16
    effect, beside the CPU's plain bf16 distance, under 10(c)(a)'s rule
    max(BF16_RULE, BF16_ORDER x that distance). Readings, not checks: at
    40 rows one bf16 rounding that a float32 sum in another order flips
    moves a row's LayerNorm, 1/37 of every mean, and the CPU's distance
    is one draw of such flips (ROADMAP §3). Beside each, the attention
    pass alone (identity head_reducer, no FF): how many elements of
    bf16(attn0) the kernel and the CPU's plain version round otherwise
    than the card's plain version. Prints a line a case and the count
    outside the rule by head width."""
    from grappa_tpu_torch.ops import fused_gnn as fg
    n, f, d = GAP_N, 512, 8
    outside = {128: 0, 256: 0}
    for seed in range(GAP_SEEDS):
        gen = torch.Generator().manual_seed(seed)
        feat = torch.randn((n, f), generator=gen)
        neighbors = torch.randint(0, n, (n, d), generator=gen)
        neighbors[0, 0] = 0
        mask = (torch.rand((d, n), generator=gen) > 0.3).float()
        mask[0, 0] = 0.0
        mask[:, -3:] = 0.0
        nbr = feat[neighbors.t()].contiguous()
        hn = torch.randn((n, f), generator=gen)
        p = [q.cpu() for q in rand_params(torch, gen, [
            ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
            ((4 * f, f), 'w'), ((4 * f,), 'b'), ((f, 4 * f), 'w'),
            ((f,), 'b')])]
        dy = torch.randn((n, f), generator=torch.Generator().manual_seed(7))
        inputs = [feat, nbr, hn, *p]
        for heads in (4, 2):
            def grads(kernel, dt, device):
                leaves = [t.to(device).requires_grad_(True) for t in inputs]
                m = mask.to(device)
                y = (fg.fused_gnn_block(*leaves[:3], m, leaves[3:], heads,
                                        mm_dtype=dt) if kernel else
                     fg.reference_gnn_block(*leaves[:3], m, leaves[3:],
                                            heads, None, dt))
                return [g.double().cpu() for g in torch.autograd.grad(
                    y, leaves, dy.to(device))]
            k16 = grads(True, torch.bfloat16, 'cuda')
            p16 = grads(False, torch.bfloat16, 'cuda')
            p32 = grads(False, None, 'cuda')
            c16 = grads(False, torch.bfloat16, 'cpu')
            rows = []
            for i, (a, b, c, e) in enumerate(zip(k16, p16, p32, c16)):
                eff = float((b - c).abs().mean())
                rows.append((float((a - b).abs().mean()) / eff,
                             float((e - b).abs().mean()) / eff, i))
            over = [r for r in rows if r[0] > max(BF16_RULE,
                                                  BF16_ORDER * r[1])]
            worst = max(rows, key=lambda r: r[0] / max(BF16_RULE,
                                                       BF16_ORDER * r[1]))
            outside[f // heads] += bool(over)
            # the attention pass alone: with wr = I, br = 0 and the FF
            # zeroed, y = LN(bf16(attn0)); elements past 1e-4 from the
            # card's plain version are attn0's bf16 flips
            probe = [torch.eye(f), torch.zeros(f), torch.ones(f),
                     torch.zeros(f), torch.zeros(4 * f, f),
                     torch.zeros(4 * f), torch.zeros(f, 4 * f),
                     torch.zeros(f)]
            with torch.no_grad():
                ys = [fn(feat.to(dv), nbr.to(dv), torch.zeros_like(hn).to(
                    dv), mask.to(dv), [q.to(dv) for q in probe], heads,
                    **kw).cpu() for fn, dv, kw in (
                        (fg.fused_gnn_block, 'cuda',
                         {'mm_dtype': torch.bfloat16}),
                        (fg.reference_gnn_block, 'cuda',
                         {'mm_dtype': torch.bfloat16}),
                        (fg.reference_gnn_block, 'cpu',
                         {'mm_dtype': torch.bfloat16}))]
            flips = [int(((y - ys[1]).abs() > 1e-4).sum())
                     for y in (ys[0], ys[2])]
            print(f'gap K1b bf16 N={n} seed {seed} heads {heads} (dh '
                  f'{f // heads}): worst gradient {worst[2]} mean err / '
                  f'effect {worst[0]:.4f}, the CPU\'s plain bf16 '
                  f'{worst[1]:.4f}; {len(over)} of {len(rows)} gradients '
                  f'outside max({BF16_RULE}, {BF16_ORDER} x the CPU\'s) '
                  f'(a reading, not a check); attn0 bf16 flips against '
                  f'the card\'s plain version: kernel {flips[0]}, CPU '
                  f'plain {flips[1]} of {n * f}', flush=True)
    print(f'gap K1b bf16 N={n}: cases with a gradient outside 10(c)(a)\'s '
          f'rule, of {GAP_SEEDS} seeds: dh 128 {outside[128]}, dh 256 '
          f'{outside[256]}', flush=True)


def bf16_training_kernel_phase(torch, batches, entries):
    """Phase 10(c)(a): K1b-K3b in bf16 mode at phase 4's shapes, then the
    readings of K1b at 40 rows (`gnn_gap_readings`)."""
    phase('10(c)(a). K1b-K3b in bf16 mode against autograd through their '
          'plain bf16 versions (phase 4\'s shapes)')
    for case in training_cases(torch, batches):
        compare_grad_bf16(torch, entries, case)
    gnn_gap_readings(torch)


def step_runs(torch, step, batch, w, gen, n):
    """n steps of `step` (after one warm-up): their ms (CUDA events),
    losses and launches (read_counts, zeroed before each step), and the
    peak memory in GiB."""
    counters = bf16_counters()
    step(batch, w, TRAIN_LR, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, counts = [], [], []
    for _ in range(n):
        zero_counts(counters)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, _ = step(batch, w, TRAIN_LR, gen)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        counts.append(read_counts(counters))
    return ms, losses, counts, torch.cuda.max_memory_allocated() / 2 ** 30


def bf16_step_phase(torch, cfg, graphs, batch):
    """Phase 10(c)(c): make_train_step in bf16 with the config's dropout
    at full width on the 128 x 32 batch and bench.py's 512 x 32 peak
    config, beside the float32 step on the same batch and weights (turns:
    float32, bf16, float32): 7 / 12 / 4 bf16 forward and backward
    launches a step and no float32 one, finite losses, step ms (median of
    10), peak memory and idle share; then gnn_compute_dtype and
    heads_compute_dtype alone. Returns the bf16 launches by path."""
    from grappa_tpu_torch.data.graph_batch import collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.train.trainer import make_optimizer, make_train_step
    phase('10(c)(c). make_train_step in bf16, default config with its '
          'dropout, 128 x 32 and 512 x 32')
    rest = training_batches(torch, TRAIN_MOLS, 4 * TRAIN_MOLS)
    big_graphs = graphs + rest
    big = collate(big_graphs, bucketed_pad_spec(big_graphs, TRAIN_CONFS),
                  TRAIN_CONFS, device='cuda')
    del rest
    print('512 x 32 batch, padded: N=%d, T bonds / angles / propers / '
          'impropers = %s' % (big.xyz.shape[0], ' / '.join(
              str(big.terms[t].idxs.shape[0])
              for t in ('n2', 'n3', 'n4', 'n4_improper'))), flush=True)
    state = perturbed_model(torch, make_model, cfg).state_dict()
    gen = torch.Generator().manual_seed(11)

    def make_step(**over):
        model = make_model(dict(cfg, **over))
        model.load_state_dict(state)
        return make_train_step(model.cuda(), make_optimizer())

    launches = {'fwd': {}, 'bwd': {}}
    for label, b in (('train bf16', batch), ('train bf16 512', big)):
        w = loss_weights(torch, b.num_mols, 'cuda')
        steps = {'bf16': make_step(compute_dtype='bfloat16'),
                 'float32': make_step()}
        res = {}
        for dtype, n in (('float32', 5), ('bf16', 10), ('float32', 5)):
            ms, losses, counts, peak = step_runs(torch, steps[dtype], b, w,
                                                 gen, n)
            prev = res.get(dtype, ([], [], [], 0.0))
            res[dtype] = (prev[0] + ms, prev[1] + losses, prev[2] + counts,
                          max(prev[3], peak))
        for dtype, (ms, losses, counts, peak) in res.items():
            want = want_counts(dtype == 'bf16', dtype == 'bf16')
            check(all(c == want for c in counts)
                  and bool(np.isfinite(losses).all()),
                  f'(c) {label} {dtype}: {len(ms)} steps, each launched '
                  f'{want} (float32 fwd, bf16 fwd, float32 bwd, bf16 bwd): '
                  f'{all(c == want for c in counts)}; losses '
                  f'{", ".join(f"{l:.6e}" for l in losses)}')
            runs = idle_share(torch, lambda: steps[dtype](b, w, TRAIN_LR,
                                                          gen))
            print(f'(c) {label}, {b.num_mols} molecules x {TRAIN_CONFS} '
                  f'conformers, {dtype} step: median {np.median(ms):.2f} ms '
                  f'(CUDA events; all: {", ".join(f"{t:.2f}" for t in ms)})'
                  f'; peak memory {peak:.2f} GiB (max_memory_allocated); '
                  f'device idle share ' + (
                      'not measured' if runs is None else
                      f'{np.median([r[2] for r in runs]):.4f} (torch.'
                      f'profiler, 3 steps; busy ms '
                      f'{", ".join(f"{r[1]:.2f}" for r in runs)})'),
                  flush=True)
        n = len(res['bf16'][0])
        for key, col in (('fwd', 1), ('bwd', 3)):
            for c in ('fused_gnn_block', 'fused_transformer_block',
                      'fused_symmetriser'):
                launches[key].setdefault(c, {})[label] = sum(
                    counts[c][col] for counts in res['bf16'][2])
        del steps
        torch.cuda.empty_cache()
        print(f'(c) {label}: bf16 / float32 step median '
              f'{np.median(res["bf16"][0]):.2f} / '
              f'{np.median(res["float32"][0]):.2f} ms over {n} steps each',
              flush=True)
    del big
    torch.cuda.empty_cache()
    w = loss_weights(torch, batch.num_mols, 'cuda')
    for key, gnn16, heads16 in (('gnn_compute_dtype', True, False),
                                ('heads_compute_dtype', False, True)):
        step = make_step(**{key: 'bfloat16'})
        _, losses, counts, _ = step_runs(torch, step, batch, w, gen, 1)
        want = want_counts(gnn16, heads16)
        check(counts[0] == want and bool(np.isfinite(losses).all()),
              f'(c) {key}=\'bfloat16\' alone, a step on the 128 x 32 batch: '
              f'launches {counts[0]} (want {want}), loss {losses[0]:.6e}')
    return launches


def effect_distance(a, b, cpu16, cpu32):
    """mean |a - b| / mean |cpu16 - cpu32| (the bf16 effect), None where
    bf16 leaves the value as it is."""
    eff = float((cpu16 - cpu32).abs().mean())
    scale = float(cpu32.abs().mean())
    if eff <= 1e-7 * max(scale, 1e-30):
        return None
    return float((a - b).abs().mean()) / eff


@contextlib.contextmanager
def plain_gnn_blocks():
    """The model's GNN blocks through K1's plain version on their own
    device (dropout off), so K1 / K1b launch nothing on the card."""
    from grappa_tpu_torch.models import gnn
    from grappa_tpu_torch.ops.fused_gnn import reference_gnn_block
    fused = gnn.fused_gnn_block

    def plain(feat, nbr, hn, mask, params, n_heads, rate, training, seed,
              mm_dtype, rows=None):
        assert rate == 0.0 or not training
        return reference_gnn_block(feat, nbr, hn, mask, params, n_heads,
                                   None, mm_dtype)
    gnn.fused_gnn_block = plain
    try:
        yield
    finally:
        gnn.fused_gnn_block = fused


def bf16_card_cpu_phase(torch, cfg, graphs):
    """Phase 10(c)(d): dropout-free bf16 steps at full width on the card
    and on the CPU (fused: the plain bf16 versions), 8 molecules x 4
    conformers, in BF16_STEP_DRAWS draws (module note), measured in units
    of each draw's bf16 effect (the CPU's bf16 against its float32) beside
    the card's own spread under a one-ulp weight change: over the draws,
    the median loss distance within max(BF16_RULE, 1.25 x the spread's
    median); for the gradients and Adam's update, the median of the draws'
    medians over tensors within max(BF16_RULE, 1.25 x the same of the
    spread) and the median of the draws' largest tensor distance within
    1.25 x the median of their widest spread. The witness (printed, not
    held): the card with K1 / K1b on their plain version
    (plain_gnn_blocks) against the CPU in the same units."""
    from grappa_tpu_torch.data.graph_batch import collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.train.trainer import loss_gradients, make_optimizer
    phase('10(c)(d). a bf16 step on the card against the CPU, default '
          'config, dropout off')
    no_drop = no_dropout(cfg)
    fused = dict(fused_gnn=True, fused_heads=True)
    bf16 = dict(compute_dtype='bfloat16')

    def run(over, sd, batches, device):
        model = make_model(dict(no_drop, **over))
        model.load_state_dict(sd)
        model.to(device)
        b = batches[device]
        t0 = time.time()
        loss, _, grads = loss_gradients(
            model, b, loss_weights(torch, b.num_mols, device))
        params = dict(model.named_parameters())
        before = {k: v.detach().clone() for k, v in params.items()}
        make_optimizer().step(params, list(grads.values()), TRAIN_LR)
        return (float(loss), {k: g.cpu() for k, g in grads.items()},
                {k: (params[k].detach() - before[k]).cpu()
                 for k in params}, time.time() - t0)

    # per draw: loss (card, spread, witness); per tensor kind: (median
    # and max over tensors of card vs CPU, the same of the spread, of the
    # witness), and whether the card's values are finite
    loss, kinds = [], {'gradient': [], 'Adam update': []}
    for k in range(BF16_STEP_DRAWS):
        few = graphs[8 * k:8 * k + 8]
        pad = bucketed_pad_spec(few, 4)
        batches = {d: collate(few, pad, 4, device=d) for d in ('cpu', 'cuda')}
        state = perturbed_model(torch, make_model, no_drop,
                                seed=2 * k).state_dict()
        gen = torch.Generator().manual_seed(5 + k)
        ulp_state = {n: torch.nextafter(v, torch.where(
            torch.rand(v.shape, generator=gen) < 0.5, -np.inf, np.inf))
            if v.is_floating_point() else v for n, v in state.items()}
        card = run(bf16, state, batches, 'cuda')
        ulp = run(bf16, ulp_state, batches, 'cuda')
        with plain_gnn_blocks():
            wit = run(bf16, state, batches, 'cuda')
        cpu16 = run(dict(bf16, **fused), state, batches, 'cpu')
        cpu32 = run(fused, state, batches, 'cpu')
        eff = abs(cpu16[0] - cpu32[0])
        loss.append((abs(card[0] - cpu16[0]) / eff,
                     abs(ulp[0] - card[0]) / eff,
                     abs(wit[0] - cpu16[0]) / eff))
        for what, idx in (('gradient', 1), ('Adam update', 2)):
            r, f, w = (np.array([x for x in (
                effect_distance(a[idx][n], b[idx][n], cpu16[idx][n],
                                cpu32[idx][n]) for n in card[idx])
                if x is not None])
                for a, b in ((card, cpu16), (ulp, card), (wit, cpu16)))
            kinds[what].append((
                np.median(r), r.max(), np.median(f), f.max(), np.median(w),
                w.max(), all(bool(torch.isfinite(v).all())
                             for v in card[idx].values())))
        print(f'(d) draw {k} (weights seed {2 * k}, molecules {8 * k}-'
              f'{8 * k + 7}, one-ulp seed {5 + k}): loss card '
              f'{card[0]:.6e}, CPU {cpu16[0]:.6e} (float32 {cpu32[0]:.6e}), '
              f'K1 plain on the card {wit[0]:.6e}; card vs CPU / bf16 effect '
              f'{loss[-1][0]:.3e}, spread {loss[-1][1]:.3e}, witness '
              f'{loss[-1][2]:.3e}; gradients median / max over tensors: '
              f'card {kinds["gradient"][-1][0]:.3e} / '
              f'{kinds["gradient"][-1][1]:.3e}, spread '
              f'{kinds["gradient"][-1][2]:.3e} / '
              f'{kinds["gradient"][-1][3]:.3e}, witness '
              f'{kinds["gradient"][-1][4]:.3e} / '
              f'{kinds["gradient"][-1][5]:.3e}; CPU bf16 step '
              f'{cpu16[3]:.1f} s', flush=True)
    d, s, w = (np.median([x[i] for x in loss]) for i in range(3))
    check(d <= max(BF16_RULE, 1.25 * s),
          f'(d) loss over {BF16_STEP_DRAWS} draws: card vs CPU / bf16 '
          f'effect median {d:.3e} (tol max({BF16_RULE}, 1.25 x the card\'s '
          f'own spread\'s median {s:.3e})); witness (K1 / K1b plain on the '
          f'card) median {w:.3e}; draw 0 (the single draw held alone '
          f'before) {loss[0][0]:.3e} against 1.25 x its spread '
          f'{loss[0][1]:.3e}')
    for what, rows in kinds.items():
        med = [np.median([x[i] for x in rows]) for i in range(6)]
        tol = max(BF16_RULE, 1.25 * med[2])
        check(med[0] <= tol and med[1] <= 1.25 * med[3]
              and all(x[6] for x in rows),
              f'(d) every {what} over {BF16_STEP_DRAWS} draws: card vs CPU '
              f'/ bf16 effect, median over draws of the median over tensors '
              f'{med[0]:.3e} (tol {tol:.3e}: max({BF16_RULE}, 1.25 x the '
              f'spread\'s {med[2]:.3e})), of the max over tensors '
              f'{med[1]:.3e} (tol {1.25 * med[3]:.3e}: 1.25 x the widest '
              f'spread\'s {med[3]:.3e}); witness {med[4]:.3e} / '
              f'{med[5]:.3e}; draw 0: {rows[0][0]:.3e} / {rows[0][1]:.3e} '
              f'against 1.25 x its spread {1.25 * rows[0][2]:.3e} / '
              f'{1.25 * rows[0][3]:.3e}')


def bf16_trainrun_phase(torch, work, data_dir, test_batches, f32_steady):
    """Phase 10(c)(e): do_trainrun with compute_dtype='bfloat16' on phase
    8's dataset for 2 epochs, then resume_trainrun by one: bf16 launches
    only, finite losses, the dtype kept through the stored config and the
    resume; model.npz holds float32 parameters that, loaded into a bf16
    model on the card, give the run's own test metrics; the resumed
    Trainer's writer-free steps/s beside phase 8's float32 (`f32_steady`,
    None when phase 8 did not run). Returns the bf16 launches and the
    `trainrun_bf16` line."""
    import copy
    from pathlib import Path
    from grappa_tpu_torch import Grappa
    from grappa_tpu_torch.train.config import default_config, read_yaml
    from grappa_tpu_torch.train.eval_model import BootstrapEvaluator
    from grappa_tpu_torch.train.export import load_model_dict
    from grappa_tpu_torch.train.run import do_trainrun, resume_trainrun
    from grappa_tpu_torch.train.trainer import make_eval_step
    phase('10(c)(e). the training run in bf16 (do_trainrun / '
          'resume_trainrun), default config')
    config = trainrun_config(default_config, data_dir)
    config['model_config']['compute_dtype'] = 'bfloat16'
    config['trainer_config']['max_epochs'] = 2
    counters = bf16_counters()
    zero_counts(counters)
    t0 = time.perf_counter()
    out = do_trainrun(copy.deepcopy(config), project_dir=work,
                      run_name='trainrun_bf16')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = ran = read_counts(counters)
    trainer, run_dir = out['trainer'], Path(out['run_dir'])
    split = json.loads((run_dir / 'split.json').read_text())
    steps = trainer.global_step
    forwards = (steps + trainer.epoch * len(trainer.val_loader)
                + len(split['test']) + 1)
    want = want_counts(True, True, forwards, steps)
    losses = sum(trainer.train_losses, [])
    check(got == want and bool(np.isfinite(losses).all()),
          f'(e) do_trainrun in bf16, {trainer.epoch} epochs, {steps} steps, '
          f'{forwards} forwards in {wall:.1f} s: launches {got} (want '
          f'{want}); train losses {", ".join(f"{l:.6e}" for l in losses)}')
    stored = read_yaml(run_dir / 'grappa_config.yaml')['model_config']
    dtypes = {m.dtype for m in trainer.model.modules()
              if hasattr(m, 'dtype')}
    check(stored['compute_dtype'] == 'bfloat16'
          and dtypes == {torch.bfloat16},
          f'(e) the run\'s stored compute_dtype {stored["compute_dtype"]!r},'
          f' its modules\' dtypes {sorted(map(str, dtypes))}')

    # model.npz: float32 arrays; loaded into a bf16 model on the card they
    # give the run's own test metrics (best.ckpt's weights)
    d = load_model_dict(out['model_dict_path'])
    kinds = {str(np.asarray(v).dtype) for v in d['state_dict'].values()
             if np.asarray(v).dtype.kind == 'f'}
    ff = Grappa.from_model_dict(d)
    loaded = {m.dtype for m in ff.model.modules() if hasattr(m, 'dtype')}
    evaluator = BootstrapEvaluator()
    eval_step = make_eval_step(ff.model)
    for batch, names in test_batches:
        energy, gradient = eval_step(batch)
        evaluator.step(batch, energy, gradient, names)
    again = evaluator.pool(n_bootstrap=200)
    want_m = d['results']['test']
    worst = max(abs(again[ds][k] - v) / max(abs(v), 1e-30)
                for ds, m in want_m.items() for k, v in m.items()
                if isinstance(v, float))
    check(kinds == {'float32'} and loaded == {torch.bfloat16}
          and again.keys() == want_m.keys() and worst <= EVAL_RTOL,
          f'(e) model.npz floating arrays {sorted(kinds)}, loaded as a '
          f'bf16 model '
          f'({sorted(map(str, loaded))}) on the card: its test metrics '
          f'against the run\'s own, worst rel {worst:.2e} (tol {EVAL_RTOL})')
    del ff

    zero_counts(counters)
    t0 = time.perf_counter()
    resumed = resume_trainrun(str(run_dir), extra_epochs=1)
    resume_s = time.perf_counter() - t0
    rt = resumed['trainer']
    got = read_counts(counters)
    dtypes = {m.dtype for m in rt.model.modules() if hasattr(m, 'dtype')}
    check(rt.epoch == 3 and bool(np.isfinite(rt.train_losses[-1]).all())
          and got['fused_gnn_block'][3] > 0
          and not any(c[0] or c[2] for c in got.values())
          and dtypes == {torch.bfloat16},
          f'(e) resume_trainrun(extra_epochs=1) ends at epoch {rt.epoch} '
          f'(want 3) in {resume_s:.1f} s, launches {got}, dtypes '
          f'{sorted(map(str, dtypes))}; losses '
          f'{", ".join(f"{l:.6e}" for l in rt.train_losses[-1])}')
    steady = steady_epochs(torch, rt, epochs=3, rounds=1)
    rate = [r[1] for r in steady['loader']]
    print(f'(e) bf16 writer-free epochs (ms, steps/s): ' + '; '.join(
        f'{r[0]:.1f}, {r[1]:.3f}' for r in steady['loader'])
        + f'; median {np.median(rate):.3f} steps/s against phase 8\'s '
        f'float32 ' + ('(not run)' if f32_steady is None
                       else f'{f32_steady:.3f}'), flush=True)
    line = {'epochs': rt.epoch, 'train_steps': rt.global_step,
            'run_wall_s': round(wall, 3), 'resume_s': round(resume_s, 3),
            'steady_train_steps_per_s': float(np.median(rate)),
            'steady_steps_per_s_min_max': [min(rate), max(rate)],
            'f32_steady_train_steps_per_s': f32_steady,
            'test_metrics_worst_rel': worst}
    return {'run': ran, 'resumed': got}, line


def bf16_training_phase(torch, cfg, graphs, train_batch, run_batches, work,
                        data_dir, test_batches, entries, f32_steady=None):
    """Phase 10(c): training in bf16 on the card, (a) the kernels, (c) the
    step, (d) card vs CPU, (e) the training run; the SASS, (b), is
    phase 10(d) (bf16_sass). Returns the bf16 launches by kernel and
    path, and the `trainrun_bf16` line."""
    bf16_training_kernel_phase(
        torch, {'train': train_batch, 'trainrun train': run_batches['train']},
        entries)
    steps = bf16_step_phase(torch, cfg, graphs, train_batch)
    bf16_card_cpu_phase(torch, cfg, graphs)
    run, line = bf16_trainrun_phase(torch, work, data_dir, test_batches,
                                    f32_steady)
    launches = {}
    for c in ('fused_gnn_block', 'fused_transformer_block',
              'fused_symmetriser'):
        fwd = dict(steps['fwd'][c])
        bwd = dict(steps['bwd'][c])
        fwd['trainrun bf16'] = run['run'][c][1] + run['resumed'][c][1]
        bwd['trainrun bf16'] = run['run'][c][3] + run['resumed'][c][3]
        launches[f'{c}.bf16'] = fwd
        launches[f'{c}.bf16_bwd'] = bwd
    return launches, line


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


def eval_tag_dataset(i):
    """Phase 9's dataset under EVAL_TAGS[i]: EVAL_MOLS make_dataset
    molecules at phase 8's conformers and atoms, with a stand-in classical
    force field that misses the reference by seeded noise."""
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.synthetic import make_dataset
    tag = EVAL_TAGS[i]
    mds = make_dataset(n_mols=EVAL_MOLS, n_confs=TRAINRUN_CONFS, seed=10 + i,
                       ds_name=tag, atom_range=TRAINRUN_ATOMS)
    rng = np.random.default_rng(i)
    for m in mds:
        m.ff_energy['reference_ff'] = (m.energy_ref + rng.normal(
            0, 2.0, m.energy_ref.shape)).astype(np.float32)
        m.ff_gradient['reference_ff'] = (m.gradient_ref + rng.normal(
            0, 3.0, m.gradient_ref.shape)).astype(np.float32)
    return Dataset.from_moldata(mds, tag)


def eval_fixture(torch, cache, cfg):
    """Phase 9(a): a release's layout under `cache`: the default model with
    seeded non-zero weights as models/grappa-1.2.pth (the reference's
    format, every alias and buffer), three datasets under published tags
    (EVAL_TAGS; the last one zipped with a nested top directory, as the
    release ships it) with a stand-in classical force field in the
    entries, and the espaloma_split directory. Returns the model file,
    the CPU model and {tag: mol_ids}."""
    import shutil
    import zipfile
    from pathlib import Path
    from grappa_tpu_torch.data.dataset import calc_split_ids, save_split
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.train.export import build_model_dict, save_model_dict
    cache = Path(cache)
    model = perturbed_model(torch, make_model, cfg, seed=9)
    model_path = cache / 'models' / 'grappa-1.2.pth'
    save_model_dict(build_model_dict(model, {'model_config': cfg}),
                    model_path)
    ids = {}
    for i, tag in enumerate(EVAL_TAGS):
        ds = eval_tag_dataset(i)
        ids[tag] = ds.mol_ids
        if i < len(EVAL_TAGS) - 1:
            ds.save(cache / 'datasets' / tag)
            continue
        staging = cache / 'staging' / tag
        ds.save(staging)
        with zipfile.ZipFile(cache / 'datasets' / f'{tag}.zip', 'w') as zf:
            for f in staging.rglob('*'):
                zf.write(f, f'{tag}/{f.relative_to(staging)}')
        shutil.rmtree(cache / 'staging')
    split_dir = cache / 'datasets' / 'espaloma_split'
    split_dir.mkdir(parents=True)
    save_split(calc_split_ids(ids, (0.8, 0.1, 0.1), seed=0),
               split_dir / 'espaloma_split.json')
    return model_path, model, ids


def eval_data(torch, work, cfg):
    """Phase 9's fixture under <work>/cache (GRAPPA_TPU_CACHE set there),
    made before phase 2 in a whole run. Returns the model file, the CPU
    model and {tag: mol_ids}."""
    import shutil
    from pathlib import Path
    cache = Path(work) / 'cache'
    shutil.rmtree(cache, ignore_errors=True)
    os.environ['GRAPPA_TPU_CACHE'] = str(cache)
    t0 = time.time()
    fixture = eval_fixture(torch, cache, cfg)
    model_path, _, ids = fixture
    from grappa_tpu_torch.train.export import load_model_dict
    print(f'phase 9\'s fixture made in {time.time() - t0:.1f} s: '
          f'{model_path.name} '
          f'({len(load_model_dict(model_path)["state_dict"])} keys), '
          f'{" / ".join(f"{t}: {len(v)}" for t, v in ids.items())} '
          f'molecules x {TRAINRUN_CONFS} conformers ({EVAL_TAGS[-1]} '
          f'zipped), espaloma_split 0.8 / 0.1 / 0.1', flush=True)
    return fixture


def eval_batches(torch):
    """The batches phase 9's paths give the kernels: the eval loader's over
    the three tags and the ingest's test split's, built as eval_model
    builds them (adaptive batch size, conformers 'max', in order), on the
    card. The tags resolve through the zoo (the zip is extracted here)."""
    from grappa_tpu_torch.data.dataset import load_split
    from grappa_tpu_torch.data.loader import GraphLoader
    from grappa_tpu_torch.train.eval_model import adaptive_batch_size
    from grappa_tpu_torch.train.run import load_datasets, resolve_splitpath
    ds = load_datasets(list(EVAL_TAGS))
    ds.remove_uncommon_features()
    split = load_split(resolve_splitpath('espaloma_split'))
    test = ds.split(split['train'], split['val'], split['test'])[2]
    batches = {}
    for label, part in (('eval', ds), ('ingest', test)):
        loader = GraphLoader(part, batch_size=adaptive_batch_size(part),
                             conf_strategy='max', shuffle=False,
                             device='cuda')
        for i, (b, _) in enumerate(loader):
            batches[f'{label} batch {i}'] = b
            print(f'{label} batch {i}, padded: N=%d, molecules %d, '
                  f'conformers %d, T bonds / angles / propers / impropers = '
                  f'%s' % (b.xyz.shape[0], b.num_mols, b.xyz.shape[1],
                           ' / '.join(str(b.terms[t].idxs.shape[0])
                                      for t in ('n2', 'n3', 'n4',
                                                'n4_improper'))),
                  flush=True)
    return batches


def eval_phase(torch, work, cfg, smi, fixture, run_dir=None):
    """Phase 9 on the fixture of `eval_data`. Returns the eval path's K1-K3
    launches and the `eval` and `ingest` lines' fields."""
    import copy
    import io
    from pathlib import Path
    from grappa_tpu_torch import Grappa, cli
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.synthetic import make_dataset, random_molecule
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    from grappa_tpu_torch.train import eval_model as eval_mod
    from grappa_tpu_torch.train.config import default_config
    from grappa_tpu_torch.train.export import (build_model_dict,
                                               load_model_dict,
                                               model_from_dict,
                                               save_model_dict)
    from grappa_tpu_torch.train.run import do_trainrun
    from grappa_tpu_torch.train.torch_compat import expected_reference_keys

    phase('9. evaluation, checkpoint import and the command line, default '
          'config')
    model_path, model, ids = fixture
    cache = model_path.parent.parent
    n_mols = sum(len(v) for v in ids.values())

    # (b) cli eval, twice; eval_model's own split of the time is read
    # through its `timings`
    counters = (fused_gnn_block, fused_transformer_block, fused_symmetriser)
    calls, real_eval = [], eval_mod.eval_model

    def timed_eval(*args, **kwargs):
        t = {}
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real_eval(*args, timings=t, **kwargs)
        t['wall_s'] = time.perf_counter() - start
        calls.append(t)
        return out

    out_json = Path(work) / 'eval.json'
    argv = ['eval', '-t', 'grappa-1.2', '-d', *EVAL_TAGS, '--set', 'all',
            '--classical', '-o', str(out_json)]
    eval_mod.eval_model = timed_eval
    runs = []
    try:
        for _ in range(2):
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            runs.append((rc, time.perf_counter() - start,
                         {c.__name__: c.launches for c in counters},
                         torch.cuda.max_memory_allocated() / 2 ** 30))
    finally:
        eval_mod.eval_model = real_eval
    results = json.loads(out_json.read_text())
    (rc, _, got_eval, peak), t = runs[1], calls[1]
    batches = t['batches']
    want = {'fused_gnn_block': 7 * batches,
            'fused_transformer_block': 12 * batches,
            'fused_symmetriser': 4 * batches}
    check(rc == 0 and all(r[2] == want for r in runs)
          and calls[0]['batches'] == batches,
          f'(b) cli eval --set all --classical: rc {rc}; launches per call '
          f'{[r[2] for r in runs]} (want {batches} batches x 7 / 12 / 4)')
    finite = all(np.isfinite(v).all() for m in results.values()
                 for d in m.values() for v in d.values())
    check(set(results) == {'grappa_tpu', 'reference_ff'} and finite
          and all(set(results[m]) == set(EVAL_TAGS) for m in results)
          and all(results['grappa_tpu'][tag]['n_mols'] == EVAL_MOLS
                  for tag in EVAL_TAGS),
          f'(b) results: finite metrics and CIs for {sorted(results)} on '
          f'{len(EVAL_TAGS)} datasets of {EVAL_MOLS} molecules')
    stored = load_model_dict(model_path).get('results', {}).get('all')
    check(stored == results,
          '(b) the results were written back into the model file')

    # card vs CPU on the first tag's molecules: the bootstrap draws of the
    # first dataset are the same numpy stream in both
    first = EVAL_TAGS[0]
    ds = Dataset.load(cache / 'datasets' / first)
    cpu_model, _ = model_from_dict(load_model_dict(model_path))
    t0 = time.perf_counter()
    cpu = real_eval(cpu_model, ds, classical=True, device='cpu')
    cpu_s = time.perf_counter() - t0
    pairs = [(results[m][first][k], cpu[m][first][k])
             for m in cpu for k in cpu[m][first]]
    worst = max(float(np.max(np.abs(np.subtract(a, b))
                             / np.maximum(np.abs(b), 1e-30)))
                for a, b in pairs)
    check(worst <= EVAL_RTOL and set(cpu) == set(results),
          f'(b) {first}: card vs CPU eval_model ({EVAL_MOLS} molecules, CPU '
          f'{cpu_s:.1f} s), every metric and CI: worst relative difference '
          f'{worst:.2e} (tol {EVAL_RTOL})')
    eval_line = {
        'datasets': list(EVAL_TAGS), 'molecules': n_mols,
        'conformers': n_mols * TRAINRUN_CONFS, 'batches': batches,
        'batch_size': t['batch_size'],
        'cli_wall_ms': [round(r[1] * 1e3, 3) for r in runs],
        'eval_model_ms': [round(c['wall_s'] * 1e3, 3) for c in calls],
        'molecules_per_s': n_mols / t['wall_s'],
        'conformers_per_s': n_mols * TRAINRUN_CONFS / t['wall_s'],
        'loader_ms': round(t['loader_s'] * 1e3, 3),
        'step_ms': round(t['step_s'] * 1e3, 3),
        'pool_ms': round(t['pool_s'] * 1e3, 3),
        'launches': got_eval, 'peak_gib': round(peak, 3),
        'written_back': stored == results, 'card_vs_cpu_worst_rel': worst,
        'card': smi}

    # (c) ingest-release: the audit, the test split's evaluation and the
    # parity verdict (these seeded weights must fail it)
    out = Path(work) / 'ingest' / 'report'
    out.parent.mkdir(parents=True, exist_ok=True)
    for c in counters:
        c.launches = 0
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(['ingest-release', '-d', *EVAL_TAGS, '-o', str(out)])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - start
    ingest_launches = {c.__name__: c.launches for c in counters}
    report = json.loads(out.with_suffix('.json').read_text())
    audit, verdict = report['checkpoint_audit'], report['parity']
    n_test = sum(d['n_mols'] for d in report['results'].values())
    check(rc == 1 and verdict['pass'] is False
          and all(out.with_suffix(s).exists() for s in ('.md', '.tex'))
          and not audit['missing_vs_expected']
          and not audit['unexpected_in_file']
          and not audit['import_warnings']
          and audit['keys_in_file'] == audit['keys_expected']
          and ingest_launches['fused_gnn_block'] % 7 == 0
          and ingest_launches['fused_gnn_block'] > 0,
          f'(c) cli ingest-release: rc {rc} on a FAIL verdict (seeded '
          f'weights, {verdict["metrics_gated"]} metrics gated); '
          f'{n_test} test molecules; report .json / .md / .tex written; '
          f'audit {audit["keys_in_file"]} keys, '
          f'{len(audit["missing_vs_expected"])} missing, '
          f'{len(audit["unexpected_in_file"])} unexpected, '
          f'{len(audit["import_warnings"])} warnings; launches '
          f'{ingest_launches}')
    ingest_line = {'test_molecules': n_test, 'rc': rc,
                   'parity_pass': verdict['pass'],
                   'wall_ms': round(ingest_s * 1e3, 3),
                   'keys': audit['keys_in_file'],
                   'launches': ingest_launches, 'card': smi}

    # (d) the tolerant import on the card: a buffer-less .npz, and a state
    # dict with DGL's fc_src name and without the gnn.blocks aliases, each
    # on the card and on the CPU
    full = build_model_dict(model, {'model_config': cfg})
    scalers = ('.to_k.', '.to_eq.', '.k_mean', '.k_std', '.n_periodicity')
    bufferless = dict(full, state_dict={
        k: v for k, v in full['state_dict'].items()
        if not any(s in k for s in scalers)})
    npz = Path(work) / 'bufferless.npz'
    save_model_dict(bufferless, npz)
    renamed = dict(full, state_dict={
        k.replace('graph_module.fc.', 'graph_module.fc_src.'): v
        for k, v in full['state_dict'].items()
        if not k.startswith('gnn.blocks.')})
    mols = [random_molecule(seed=s) for s in range(16)]
    for label, md in (('buffer-less .npz', load_model_dict(npz)),
                      ('fc_src, no gnn.blocks aliases', renamed)):
        card = Grappa.from_model_dict(md)
        host = Grappa.from_model_dict(md, device='cpu')
        check(card.device.type == 'cuda', f'(d) {label}: loads on the card')
        compare_outputs(f'(d) {label}, 16 molecules, card vs CPU,',
                        stack(card.predict_many(mols, check_eq_values=False)),
                        stack(host.predict_many(mols, check_eq_values=False)))
    check(set(full['state_dict']) == expected_reference_keys(cfg),
          '(d) the exported state dict holds every reference key')

    # cli export of a run's best.ckpt equals its model.npz, bit for bit
    if run_dir is None:
        data_dir = os.path.join(work, 'data', 'export')
        Dataset.from_moldata(make_dataset(n_mols=8, n_confs=4, seed=1,
                                          atom_range=TRAINRUN_ATOMS)
                             ).save(data_dir)
        config = trainrun_config(default_config, data_dir)
        config['data_config']['train_batch_size'] = 3
        # best.ckpt is kept from the first QM epoch on (start_qm_epochs 1)
        config['trainer_config']['max_epochs'] = 2
        with contextlib.redirect_stdout(io.StringIO()):
            run_dir = do_trainrun(copy.deepcopy(config), project_dir=work,
                                  run_name='export')['run_dir']
    exported = Path(work) / 'exported.npz'
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(['export', str(run_dir), '-o', str(exported)])
    got = load_model_dict(exported)
    want = load_model_dict(Path(run_dir) / 'model.npz')
    same = (rc == 0 and got['state_dict'].keys() == want['state_dict'].keys()
            and all(a.dtype == want['state_dict'][k].dtype
                    and a.tobytes() == want['state_dict'][k].tobytes()
                    for k, a in got['state_dict'].items())
            and got['split_names'] == want['split_names'])
    check(same, f'(d) cli export of {Path(run_dir).name}/best.ckpt equals '
                f'its model.npz bit for bit ({len(got["state_dict"])} arrays)')
    return {'eval': got_eval, 'ingest': ingest_launches}, eval_line, \
        ingest_line


GMX_SYMBOLS = {1: 'H', 6: 'C', 7: 'N', 8: 'O', 9: 'F', 15: 'P', 16: 'S',
               17: 'Cl', 35: 'Br', 53: 'I'}
GMX_SOLVENT = [
    '[ moleculetype ]', '; name nrexcl', 'SOL 2', '', '[ atoms ]',
    '1 OW 1 SOL OW 1 -0.834 15.999', '2 HW 1 SOL HW1 1 0.417 1.008',
    '3 HW 1 SOL HW2 1 0.417 1.008', '', '[ settles ]',
    '1 1 0.09572 0.15139', '', '[ exclusions ]', '1 2 3', '2 1 3',
    '3 1 2', '', '[ moleculetype ]', 'NA 1', '', '[ atoms ]',
    '1 NA 1 NA NA 1 1.0000 22.990', '', '[ moleculetype ]', 'CL 1', '',
    '[ atoms ]', '1 CL 1 CL CL 1 -1.0000 35.453', '']


def gmx_moleculetype(name, mol):
    """A [moleculetype] block of `mol` (ids become nrs 1..n): masses of
    each element, charges at 4 decimals summing to the nearest integer,
    placeholder bonded parameters (the ones a parametrization replaces),
    the propers and one improper row an improper atom set in two
    [ dihedrals ] sections. Rows are single-space separated, as
    `_merge_partial` writes the rows it keeps, with no blank row between
    sections (`Section.replace_data` keeps only a section's leading
    comment rows), so a partial rewrite leaves every other row as it
    was."""
    from grappa_tpu_torch.constants import ATOMIC_MASSES
    q = np.round(np.asarray(mol.partial_charges, np.float64) * 1e4)
    q = q.astype(np.int64)
    q[-1] += int(round(q.sum() / 1e4)) * 10000 - q.sum()
    nr = {int(a): i + 1 for i, a in enumerate(mol.atoms)}
    lines = ['[ moleculetype ]', '; name nrexcl', f'{name} 3',
             '[ atoms ]', '; nr type resnr residue atom cgnr charge mass']
    for i, (a, z) in enumerate(zip(mol.atoms, mol.atomic_numbers)):
        sym = GMX_SYMBOLS.get(int(z), f'X{int(z)}')
        lines.append(f'{nr[int(a)]} {sym} {i // 8 + 1} {name} {sym}{i + 1} '
                     f'{i + 1} {q[i] / 1e4:.4f} '
                     f'{ATOMIC_MASSES[int(z)]:.3f}')
    lines += ['[ bonds ]']
    lines += [f'{nr[int(a)]} {nr[int(b)]} 1 0.1500 250000.0'
              for a, b in mol.bonds]
    lines += ['[ angles ]']
    lines += [f'{nr[int(a)]} {nr[int(b)]} {nr[int(c)]} 1 109.500 400.000'
              for a, b, c in mol.angles]
    lines += ['[ dihedrals ]']
    lines += [' '.join(str(nr[int(x)]) for x in t) + ' 9 0.0 0.6508 3'
              for t in mol.propers]
    lines += ['[ dihedrals ]']
    seen = set()
    for t in mol.impropers:
        key = frozenset(int(x) for x in t)
        if key not in seen:
            seen.add(key)
            lines.append(' '.join(str(nr[int(x)]) for x in t)
                         + ' 4 180.0 4.6024 2')
    return lines


def gmx_topology(work):
    """Phase 11(a)'s topology under <work>/gmx: the protein-like chain
    (phase 3's molecule), a 30-atom ligand, GMX_WATERS waters and
    GMX_IONS Na+ and Cl- each. Returns the .top's path and {moleculetype:
    the Molecule it was written from}."""
    from pathlib import Path
    from grappa_tpu_torch.data.molecule import Molecule
    from grappa_tpu_torch.data.synthetic import random_molecule
    root = Path(work) / 'gmx'
    root.mkdir(parents=True, exist_ok=True)
    mols = {'PROT': protein_like_molecule(Molecule),
            'LIG': random_molecule(seed=GMX_LIGAND_SEED,
                                   n_atoms=GMX_LIGAND_ATOMS,
                                   charge_model='amber99')}
    lines = ['; a protein-like chain and a ligand in water with ions',
             '#include "amber99sb-ildn.ff/forcefield.itp"', '']
    for name, mol in mols.items():
        lines += gmx_moleculetype(name, mol)
    lines += GMX_SOLVENT + [
        '[ system ]', 'protein-like chain and ligand in water', '',
        '[ molecules ]', 'PROT 1', 'LIG 1', f'SOL {GMX_WATERS}',
        f'NA {GMX_IONS}', f'CL {GMX_IONS}']
    path = root / 'system.top'
    path.write_text('\n'.join(lines) + '\n')
    return path, mols


def gmx_focus(bonds, fov, n_ligand):
    """Two protein atom nrs more than GMX_FOCUS_APART x the field of view
    bonds apart (both above the ligand's nrs): the first backbone atom of
    the sixth residue and the first atom at 4 fov + 8 bonds from it."""
    from grappa_tpu_torch import topology
    nbrs = topology.neighbor_map(bonds)
    a = 5 * 8 + 1
    if a <= n_ligand:
        raise ValueError(f'focus nr {a} is also a ligand atom')
    dist, frontier = {a: 0}, [a]
    while frontier:
        nxt = []
        for x in frontier:
            for y in nbrs.get(x, ()):
                if y not in dist:
                    dist[y] = dist[x] + 1
                    nxt.append(y)
        frontier = nxt
    b = min(x for x, d in dist.items()
            if d == GMX_FOCUS_APART * fov + 8)
    return [a, b], dist[b]


def gmx_molecules(top_path, fov, focus=None):
    """The molecules each parametrize forward of phase 11 gets, built as
    GromacsGrappa._parametrize_moleculetype builds them: {moleculetype:
    [Molecule, ...]} (one a component under `focus`)."""
    from grappa_tpu_torch.wrappers import gromacs_wrapper as gw
    from grappa_tpu_torch.wrappers.gromacs_topology import (SKIP_MOLECULES,
                                                            GromacsTopology)
    top = GromacsTopology.parse(top_path)
    info = top.atomtype_info()
    out = {}
    for mt in top.molecule_types():
        bonds = mt.bonds()
        if mt.name.upper() in SKIP_MOLECULES or not bonds:
            continue
        comps = [None]
        if focus:
            apply = gw.fov_neighborhood(bonds, set(focus), fov)
            comps = gw._connected_components(
                bonds, gw.fov_neighborhood(bonds, apply, fov))
        if comps:
            out[mt.name] = [gw.molecule_from_moleculetype(
                mt, atom_filter=c, type_info=info) for c in comps]
    return out


def gmx_data(torch, work, cfg):
    """Phase 11's topology and focus atoms, made before phase 2 in a whole
    run, and the batches its forwards give the kernels (on the card)."""
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    from grappa_tpu_torch.models.grappa_model import field_of_view
    top_path, mols = gmx_topology(work)
    fov = field_of_view(cfg)
    bonds = [(int(a) + 1, int(b) + 1) for a, b in mols['PROT'].bonds]
    focus, apart = gmx_focus(bonds, fov, len(mols['LIG'].atoms))
    batches = {}
    for label, f in (('gmx', None), ('gmx focus', focus)):
        for name, ms in gmx_molecules(top_path, fov, f).items():
            graphs = [MolGraph.from_molecule(m) for m in ms]
            b = collate(graphs, bucketed_pad_spec(graphs, 1), 1,
                        device='cuda')
            key = f'{label} {name}'
            batches[key] = b
            print(f'{key}: {len(ms)} molecule(s), '
                  f'{sum(len(m.atoms) for m in ms)} atoms; padded N=%d, T '
                  f'bonds / angles / propers / impropers = %s' % (
                      b.xyz.shape[0], ' / '.join(
                          str(b.terms[t].idxs.shape[0])
                          for t in ('n2', 'n3', 'n4', 'n4_improper'))),
                  flush=True)
    print(f'phase 11\'s topology: {top_path.name}, focus nrs {focus} '
          f'({apart} bonds apart; field of view {fov})', flush=True)
    return top_path, mols, focus, batches


def gmx_blocks(text):
    """{moleculetype name: its lines} and the lines outside them."""
    from grappa_tpu_torch.wrappers.gromacs_topology import (GromacsTopology,
                                                            Section)
    top = GromacsTopology.parse(text)
    blocks = {m.name: [line for s in m.sections
                       for line in [s.header_line, *s.rows]]
              for m in top.molecule_types()}
    inside = {id(s) for m in top.molecule_types() for s in m.sections}
    blocks[''] = [line for el in top.elements
                  for line in ((el.header_line, *el.rows)
                               if isinstance(el, Section) else (el,))
                  if not isinstance(el, Section) or id(el) not in inside]
    return top, blocks


def gmx_rows(mt):
    """{section kind: [data row as written]} of a moleculetype; the
    dihedral rows split by funct."""
    out = {'bonds': [], 'angles': [], 'propers': [], 'impropers': []}
    for kind in ('bonds', 'angles'):
        sec = mt.section(kind)
        out[kind] = [' '.join(r) for r in (sec.data_rows() if sec else [])]
    for _, r in mt.dihedral_rows():
        out['propers' if r[4] in ('9', '1') else 'impropers'].append(
            ' '.join(r))
    return out


def gmx_lines_agree(label, got, want):
    """Two written topologies line for line, as
    tests/test_torch_port_gromacs.py compares them: every line equal, or a
    bonded row with equal ids, functs and periodicity whose parameters
    agree at MODEL_ATOL x the unit factor + MODEL_RTOL |value| + half a
    printed unit; torsion rows that the k cutoff zeroes on one side only
    are counted and left out."""
    from grappa_tpu_torch.wrappers import gromacs_wrapper as gw
    cols = {'bonds': {3: (gw.BOND_EQ_FACTOR, 6), 4: (gw.BOND_K_FACTOR, 4)},
            'angles': {4: (gw.ANGLE_EQ_FACTOR, 4),
                       5: (gw.ANGLE_K_FACTOR, 4)},
            'dihedrals': {5: (gw.TORSION_PHASE_FACTOR, 4),
                          6: (gw.TORSION_K_FACTOR, 6)}}
    got, want = got.splitlines(), want.splitlines()
    ok, section, differ, flips, worst = len(got) == len(want), None, 0, 0, 0.0
    for g, w in zip(got, want):
        m = re.match(r'^\s*\[\s*(\S+)\s*\]', w)
        if m:
            section = m.group(1).lower()
        if g == w:
            continue
        differ += 1
        gt, wt, c = g.split(), w.split(), cols.get(section)
        if not c or len(gt) != len(wt):
            ok = False
            continue
        if section == 'dihedrals' and (
                abs(float(gt[6])) / gw.TORSION_K_FACTOR > TORSION_CUTOFF) != (
                abs(float(wt[6])) / gw.TORSION_K_FACTOR > TORSION_CUTOFF):
            flips += 1
            ok &= gt[:5] + gt[7:] == wt[:5] + wt[7:]
            continue
        for i, (a, b) in enumerate(zip(gt, wt)):
            if i not in c:
                ok &= a == b
                continue
            factor, decimals = c[i]
            tol = (MODEL_ATOL * factor + MODEL_RTOL * abs(float(b))
                   + 0.5 * 10 ** -decimals)
            worst = max(worst, abs(float(a) - float(b)) / tol)
    ok &= worst <= 1.0 and flips <= 1e-3 * len(want)
    check(ok, f'{label}: {len(got)} lines against {len(want)}, {differ} '
              f'differ, worst parameter at {worst:.3f} of its tolerance '
              f'(MODEL_ATOL {MODEL_ATOL} x unit + MODEL_RTOL {MODEL_RTOL} '
              f'|y| + half a printed unit), {flips} torsion rows at the k '
              f'cutoff left out')


class StageClock:
    """Host seconds by stage of a parametrize call, through wrapped
    functions (`wrap`), and the model forward's device ms (CUDA events
    around each forward: `hook`)."""

    def __init__(self, torch):
        self.torch, self.host, self.events = torch, {}, []

    def wrap(self, stage, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.host[stage] = (self.host.get(stage, 0.0)
                                    + time.perf_counter() - t0)
        return timed

    def hook(self, model):
        torch = self.torch

        def pre(module, args):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events.append([start, None, time.perf_counter()])

        def post(module, args, out):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events[-1][1] = end
            self.host['forward'] = (self.host.get('forward', 0.0)
                                    + time.perf_counter()
                                    - self.events[-1][2])
        return (model.register_forward_pre_hook(pre),
                model.register_forward_hook(post))

    def device_ms(self):
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e, _ in self.events)


def gmx_times(torch, ff, top_path, out_path, reps=GMX_REPS):
    """Phase 11(f): warm parametrize of the whole topology, host clock
    (median of `reps`), split into the topology parse, featurise (the
    moleculetypes' Molecules, MolGraph, pad spec) + collate, the forward
    (CUDA events; its host time beside), row formatting + the write, and
    the rest (the copy back, slicing, Parameters)."""
    from grappa_tpu_torch import api
    from grappa_tpu_torch.wrappers import gromacs_wrapper as gw
    runs = []
    for _ in range(reps):
        clock = StageClock(torch)
        saved = {(gw, 'GromacsTopology'): gw.GromacsTopology,
                 (gw, 'molecule_from_moleculetype'):
                     gw.molecule_from_moleculetype,
                 (gw, 'gromacs_parameter_rows'): gw.gromacs_parameter_rows,
                 (api, 'MolGraph'): api.MolGraph,
                 (api, 'bucketed_pad_spec'): api.bucketed_pad_spec,
                 (api, 'collate'): api.collate}
        base = gw.GromacsTopology

        class Timed(base):
            @classmethod
            def parse(cls, *args, **kwargs):
                return clock.wrap('parse', base.parse.__func__)(
                    cls, *args, **kwargs)

            def save(self, path):
                return clock.wrap('rows_write', base.save)(self, path)

        class Graphs:
            from_molecule = staticmethod(clock.wrap(
                'featurise_collate', api.MolGraph.from_molecule))

        gw.GromacsTopology = Timed
        gw.molecule_from_moleculetype = clock.wrap(
            'featurise_collate', gw.molecule_from_moleculetype)
        gw.gromacs_parameter_rows = clock.wrap('rows_write',
                                               gw.gromacs_parameter_rows)
        api.MolGraph = Graphs
        api.bucketed_pad_spec = clock.wrap('featurise_collate',
                                           api.bucketed_pad_spec)
        api.collate = clock.wrap('featurise_collate', api.collate)
        hooks = clock.hook(ff.model)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ff.parametrize(top_path, out_path, check_eq_values=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
            for h in hooks:
                h.remove()
        split = {k: v * 1e3 for k, v in clock.host.items()}
        split['forward_device'] = clock.device_ms()
        split['other'] = wall * 1e3 - sum(
            v for k, v in split.items() if k != 'forward_device')
        runs.append((wall * 1e3, split))
    order = sorted(range(reps), key=lambda i: runs[i][0])
    median = runs[order[reps // 2]]
    return median, [round(r[0], 3) for r in runs]


def gmx_phase(torch, cfg, work, smi, data):
    """Phase 11 on `gmx_data`'s topology. Returns the K1-K3 launches of
    the path and the `gmx` line's fields."""
    import io
    from grappa_tpu_torch import cli
    from grappa_tpu_torch.models.grappa_model import field_of_view, make_model
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    from grappa_tpu_torch.train.export import build_model_dict, save_model_dict
    from grappa_tpu_torch.wrappers import gromacs_wrapper as gw
    from grappa_tpu_torch.wrappers.gromacs_topology import SKIP_MOLECULES

    phase('11. GROMACS: cli gmx and GromacsGrappa.parametrize, default '
          'config')
    top_path, mols, focus, _ = data
    root = top_path.parent
    fov = field_of_view(cfg)
    text = top_path.read_text()
    _, in_blocks = gmx_blocks(text)

    # (a) the model file in a temporary GRAPPA_TPU_CACHE under the tag
    cache = root / 'cache'
    os.environ['GRAPPA_TPU_CACHE'] = str(cache)
    save_model_dict(build_model_dict(perturbed_model(torch, make_model, cfg,
                                                     seed=11),
                                     {'model_config': cfg}),
                    cache / 'models' / 'grappa-1.2.pth')
    n_mol = {name: (len(m.atoms), len(m.bonds), len(m.angles),
                    len(m.propers), len(m.impropers))
             for name, m in mols.items()}
    print('(a) ' + ', '.join(
        f'{name}: {a} atoms, {b} bonds, {an} angles, {p} propers, {i} '
        f'impropers' for name, (a, b, an, p, i) in n_mol.items())
        + f'; SOL x {GMX_WATERS}, NA x {GMX_IONS}, CL x {GMX_IONS} '
        f'(skipped: {sorted(SKIP_MOLECULES & {"SOL", "NA", "CL"})})',
        flush=True)

    counters = (fused_gnn_block, fused_transformer_block, fused_symmetriser)

    def run_cli(out, *flags):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = cli.main(['gmx', '-f', str(top_path), '-o', str(out), '-t',
                           'grappa-1.2', *flags])
        torch.cuda.synchronize()
        return (rc, time.perf_counter() - t0, buf.getvalue(),
                {c.__name__: c.launches for c in counters})

    def forwards(counts, n):
        return counts == {'fused_gnn_block': 7 * n,
                          'fused_transformer_block': 12 * n,
                          'fused_symmetriser': 4 * n}

    # (b) cli gmx over the whole topology: one forward a moleculetype
    out_cli = root / 'cli.top'
    rc, cli_s, stdout, got = run_cli(out_cli)
    launches = {name: {'gmx': n} for name, n in got.items()}
    out_text = out_cli.read_text()
    out_top, out_blocks = gmx_blocks(out_text)
    check(rc == 0 and json.loads(stdout) == {'written': str(out_cli)}
          and forwards(got, 2),
          f'(b) cli gmx: rc {rc} in {cli_s:.2f} s, {stdout.strip()}; '
          f'launches {got} (2 forwards x 7 / 12 / 4: PROT, LIG)')
    n_imp = cfg.get('n_periodicity_improper', 3)
    n_prop = cfg.get('n_periodicity_proper', 6)
    for name, mol in mols.items():
        rows = gmx_rows(next(m for m in out_top.molecule_types()
                             if m.name == name))
        tuples = {k: {tuple(r.split()[:n]) for r in rows[k]}
                  for k, n in (('bonds', 2), ('angles', 3), ('propers', 4),
                               ('impropers', 4))}
        want = {k: {tuple(str(int(x) + 1) for x in t)
                    for t in getattr(mol, k)}
                for k in ('bonds', 'angles', 'propers', 'impropers')}
        check(len(rows['bonds']) == len(mol.bonds)
              and len(rows['angles']) == len(mol.angles)
              and len(rows['propers']) == n_prop * len(mol.propers)
              and len(rows['impropers']) == n_imp * len(mol.impropers)
              and tuples == want
              and not any(r.endswith(('250000.0', '400.000', '0.6508 3',
                                      '4.6024 2'))
                          for v in rows.values() for r in v),
              f'(b) {name}: predicted rows for every bond '
              f'({len(rows["bonds"])}), angle ({len(rows["angles"])}), '
              f'proper x {n_prop} ({len(rows["propers"])}) and improper x '
              f'{n_imp} ({len(rows["impropers"])}); no placeholder left')
    same = [n for n in ('SOL', 'NA', 'CL', '')
            if out_blocks[n] == in_blocks[n]]
    check(len(same) == 4,
          f'(b) SOL, NA, CL and the lines outside the moleculetypes '
          f'unchanged byte for byte ({", ".join(n or "rest" for n in same)})')

    # (c) --focus on two distant protein atoms: one forward, two components
    out_focus = root / 'focus.top'
    rc, focus_s, stdout, got = run_cli(
        out_focus, '--focus', *[str(x) for x in focus])
    for name, n in got.items():
        launches[name]['gmx'] += n
    focus_text = out_focus.read_text()
    focus_top, focus_blocks = gmx_blocks(focus_text)
    prot_bonds = [(int(a) + 1, int(b) + 1) for a, b in mols['PROT'].bonds]
    apply = gw.fov_neighborhood(prot_bonds, set(focus), fov)
    comps = gmx_molecules(top_path, fov, focus)

    def inside(row, arity):
        return all(int(x) in apply for x in row.split()[:arity])
    in_top, _ = gmx_blocks(text)
    prot_in = gmx_rows(in_top.molecule_types()[0])
    prot_out = gmx_rows(focus_top.molecule_types()[0])
    arity = {'bonds': 2, 'angles': 3, 'propers': 4, 'impropers': 4}
    kept = all([r for r in prot_out[k] if not inside(r, n)]
               == [r for r in prot_in[k] if not inside(r, n)]
               for k, n in arity.items())
    rewritten = {k: sum(inside(r, n) for r in prot_out[k])
                 for k, n in arity.items()}
    check(rc == 0 and forwards(got, 1) and list(comps) == ['PROT']
          and len(comps['PROT']) == 2 and kept
          and all(focus_blocks[n] == in_blocks[n]
                  for n in ('LIG', 'SOL', 'NA', 'CL', ''))
          and rewritten['bonds'] > 0,
          f'(c) cli gmx --focus {" ".join(map(str, focus))}: rc {rc} in '
          f'{focus_s:.2f} s; launches {got} (one forward); '
          f'{len(comps.get("PROT", []))} components of '
          f'{[len(m.atoms) for m in comps.get("PROT", [])]} atoms; '
          f'{len(apply)} atoms in the apply set, rows inside it rewritten '
          f'{rewritten}; every row outside it, LIG, SOL, NA, CL and the '
          f'rest unchanged byte for byte')

    # (e) the same GromacsGrappa on the card and on the CPU
    ff = gw.GromacsGrappa.from_tag('grappa-1.2')
    ff_cpu = gw.GromacsGrappa.from_tag('grappa-1.2', device='cpu')
    check(ff.device.type == 'cuda' and ff.field_of_view == fov,
          f'(e) GromacsGrappa.from_tag on {ff.device}, field of view '
          f'{ff.field_of_view}')
    for label, flags in (('whole topology', None), ('--focus', focus)):
        written = {}
        for dev, f in (('card', ff), ('cpu', ff_cpu)):
            t0 = time.perf_counter()
            f.parametrize(top_path, root / f'{dev}.top',
                          focus_nrs=set(flags) if flags else None)
            written[dev] = ((root / f'{dev}.top').read_text(),
                            f.last_predictions, time.perf_counter() - t0)
        card, cpu = written['card'], written['cpu']
        check(card[1].keys() == cpu[1].keys()
              and all(len(card[1][k]) == len(cpu[1][k])
                      and all(a[1] == b[1] for a, b in zip(card[1][k],
                                                           cpu[1][k]))
                      for k in card[1]),
              f'(e) {label}: the same moleculetypes, components and apply '
              f'sets on the card ({card[2]:.2f} s) and on the CPU '
              f'({cpu[2]:.2f} s)')
        for name in card[1]:
            compare_outputs(f'(e) {label} {name}, card vs CPU,',
                            stack([p for p, _ in card[1][name]]),
                            stack([p for p, _ in cpu[1][name]]))
        gmx_lines_agree(f'(e) {label}: the card\'s written .top against '
                        f'the CPU\'s', card[0], cpu[0])
        gmx_lines_agree(f'(e) {label}: cli gmx\'s written .top against '
                        f'GromacsGrappa.parametrize\'s on the card',
                        (out_cli if flags is None else out_focus)
                        .read_text(), card[0])
        rows = {}
        for name, preds in card[1].items():
            for params, app in preds:
                for k, v in gw.gromacs_parameter_rows(params, app).items():
                    rows.setdefault((name, k), []).extend(v)
        card_top, _ = gmx_blocks(card[0])
        written_rows = {(m.name, k): v for m in card_top.molecule_types()
                        for k, v in gmx_rows(m).items()}
        check(all(set(' '.join(r.split()) for r in v)
                  <= set(written_rows[key]) for key, v in rows.items()),
              f'(e) {label}: every row formatted from last_predictions is '
              f'in the written file')

    # (f) warm parametrize on the card, by stage
    gmx_times(torch, ff, top_path, root / 'warm.top', reps=1)
    (wall, split), runs = gmx_times(torch, ff, top_path, root / 'warm.top')
    n_atoms = sum(len(m.atoms) for m in mols.values())
    line = {
        'atoms': n_atoms,
        'moleculetypes': {n: dict(zip(('atoms', 'bonds', 'angles', 'propers',
                                        'impropers'), v))
                          for n, v in n_mol.items()},
        'parametrize_ms': round(wall, 3), 'runs_ms': runs,
        'split_ms': {k: round(v, 3) for k, v in split.items()},
        'atoms_per_s': n_atoms / (wall / 1e3),
        'cli_wall_ms': round(cli_s * 1e3, 3),
        'cli_focus_wall_ms': round(focus_s * 1e3, 3),
        'focus': focus, 'focus_components': [
            len(m.atoms) for m in comps['PROT']],
        'launches': {k: v['gmx'] for k, v in launches.items()},
        'card': smi}
    print(f'(f) warm parametrize of {n_atoms} atoms: median {wall:.2f} ms '
          f'(runs {runs}); split of the median run (ms) '
          f'{json.dumps(line["split_ms"])}; {line["atoms_per_s"]:.1f} '
          f'atoms/s', flush=True)
    return launches, line


def sweep_base_config(default_config, data_dir, splitpath):
    """Phase 12(b)'s base config: default_config() at the default width
    (its dropout) trained from `data_dir` with phase 8's settings (test
    molecules one at a time, a checkpoint every epoch) on the split in
    `splitpath`."""
    cfg = trainrun_config(default_config, data_dir)
    cfg['data_config']['splitpath'] = splitpath
    return cfg


def espaloma_records(work):
    """A few archive records (tests/test_espaloma_pipeline.py's layout)
    written with the port's own SMILES parser under <work>/raw/<ds>/, and
    one espaloma-merged duplicate under <work>/dup/0/<ds>/."""
    from pathlib import Path
    from grappa_tpu_torch.data.smiles import parse_mapped_smiles
    root = Path(work)
    for ds, smiles in DATA_RECORDS.items():
        (root / 'raw' / ds).mkdir(parents=True, exist_ok=True)
        for i, smi in enumerate(smiles):
            z, _, _ = parse_mapped_smiles(smi)
            rng = np.random.default_rng(100 + i)
            n, c = len(z), 4
            f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
            np.savez(root / 'raw' / ds / f'mol{i}.npz', mapped_smiles=np.array(
                [smi]), smiles=np.array([smi.replace(':', 'x')]),
                atomic_numbers=z, am1bcc_elf_charges=0.3 * f32(n),
                xyz=f32(c, n, 3), energy_qm=f32(c),
                gradient_qm=f32(c, n, 3), energy_ref=f32(c),
                gradient_ref=f32(c, n, 3), **{
                    'energy_gaff-2.11': f32(c),
                    'gradient_gaff-2.11': f32(c, n, 3)})
    dup = root / 'dup' / '0' / 'ds_a'
    dup.mkdir(parents=True, exist_ok=True)
    first = sorted((root / 'raw' / 'ds_b').iterdir())[0]
    (dup / 'mol_dup.npz').write_bytes(first.read_bytes())


def data_tools_run(tree, out, subprocess_first):
    """Phase 12(a)'s tools once, from the moldata tree `tree` into `out`:
    `dataset from-moldata-dirs` (through `python -m grappa_tpu_torch.cli`
    when `subprocess_first`), `add-charge-model`, the espaloma split and
    `split-export` (in process: cli.main), then the espaloma pipeline on
    the records `espaloma_records` writes. Returns ({step: wall ms}, the
    split, the commands' outputs)."""
    import io
    from pathlib import Path
    from grappa_tpu_torch import cli
    from grappa_tpu_torch.data import espaloma_pipeline as ep
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.espaloma_split import (build_espaloma_split,
                                                 save_espaloma_split)
    out = Path(out)
    ms, answers = {}, {}

    def run(step, argv):
        t0 = time.perf_counter()
        if subprocess_first and not answers:
            proc = subprocess.run(
                [sys.executable, '-m', 'grappa_tpu_torch.cli'] + argv,
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0,
                  f'(a) {step}: `python -m grappa_tpu_torch.cli '
                  f'{" ".join(argv[:2])}` returns {proc.returncode} '
                  f'{proc.stderr[-300:]}')
            text = proc.stdout
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            text = buf.getvalue()
        ms[step] = (time.perf_counter() - t0) * 1e3
        answers[step] = json.loads(text.strip().splitlines()[-1])

    data = out / DATA_TAG
    run('from-moldata-dirs', ['dataset', 'from-moldata-dirs', '-s',
                              str(tree), '-t', str(data), '-c', 'amber99'])
    run('add-charge-model', ['dataset', 'add-charge-model', '-d', str(data)])
    t0 = time.perf_counter()
    ids = Dataset.load(data).mol_ids
    split = build_espaloma_split(ids, ids[-DATA_TEST:],
                                 ids[-2 * DATA_TEST:-DATA_TEST])
    save_espaloma_split(split, out / 'espaloma_split.json')
    ms['espaloma_split'] = (time.perf_counter() - t0) * 1e3
    run('split-export', ['dataset', 'split-export', '-d', str(data),
                         '--split', str(out / 'espaloma_split.json'), '-t',
                         str(out / 'published')])
    t0 = time.perf_counter()
    espaloma_records(out)
    answers['unmerge'] = ep.unmerge_duplicates(out / 'dup', out / 'raw')
    for ds in DATA_RECORDS:
        answers[f'to-moldata {ds}'] = ep.convert_espaloma_dir(
            out / 'raw' / ds, out / 'moldata' / ds)
        ep.assemble_dataset_dir(out / 'moldata' / ds, out / 'ds' / ds,
                                ds_name=ds)
    ms['espaloma_pipeline'] = (time.perf_counter() - t0) * 1e3
    return ms, split, answers


def data_tools_phase(work, smi):
    """Phase 12(a). Returns the dataset directory, its split file and the
    `dataset_tools` line's fields."""
    from pathlib import Path
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.dataset_creation import charge_model_one_hot
    from grappa_tpu_torch.data.moldata import MolData
    from grappa_tpu_torch.data.synthetic import make_dataset
    phase('12(a). the data tools: cli dataset, the espaloma split and '
          'pipeline')
    root = Path(work) / 'data_tools'
    t0 = time.perf_counter()
    tree = root / 'tree'
    for md in make_dataset(n_mols=DATA_MOLS, n_confs=TRAINRUN_CONFS,
                           seed=7, ds_name=DATA_TAG,
                           atom_range=TRAINRUN_ATOMS):
        (tree / md.mol_id).mkdir(parents=True)
        md.save(tree / md.mol_id / 'moldata.npz')
    made_ms = (time.perf_counter() - t0) * 1e3
    runs = [data_tools_run(tree, root / f'run{k}', k == 0) for k in range(2)]
    (ms, split, answers), (ms2, split2, answers2) = runs
    data = root / 'run0' / DATA_TAG
    ds = Dataset.load(data)
    cm = [np.array_equal(
        md.molecule.additional_features.get('charge_model'),
        charge_model_one_hot('am1BCC', len(md.molecule.atoms)))
        for md in ds.entries]
    written = answers['from-moldata-dirs']['written']
    updated = answers['add-charge-model']['updated']
    check(len(ds) == written == updated == DATA_MOLS and all(cm),
          f'(a) from-moldata-dirs wrote {written} of {DATA_MOLS} molecules '
          f'x {TRAINRUN_CONFS} conformers; add-charge-model (am1BCC, '
          f'inferred from {DATA_TAG!r}) updated {updated}, {sum(cm)} carry '
          f'its one-hot')
    where = {}
    for f in sorted((root / 'run0' / 'published').glob('*/*/*.npz')):
        where.setdefault(MolData.load(f).mol_id, []).append(f.parts[-3])
    counts = {k: answers['split-export'][k] for k in ('train', 'val', 'test')}
    want = {k: len(v) for k, v in split.items()}
    check(counts == want and sorted(where) == sorted(ds.mol_ids)
          and all(len(v) == 1 and v[0] in split and k in split[v[0]]
                  for k, v in where.items()),
          f'(a) espaloma split {want} and split-export {counts}: every id '
          f'in exactly one partition, the one the split names')
    conv = [answers[f'to-moldata {d}'] for d in DATA_RECORDS]
    n_rec = sum(len(v) for v in DATA_RECORDS.values()) + 1
    pipe = (Dataset.load(root / 'run0' / 'ds' / 'ds_a')
            + Dataset.load(root / 'run0' / 'ds' / 'ds_b'))
    check(answers['unmerge'] == {'copied': 1, 'already_there': 0}
          and sum(c['success'] for c in conv) == n_rec
          and sum(c['errors'] for c in conv) == 0 and len(pipe) == n_rec,
          f'(a) espaloma pipeline: unmerge {answers["unmerge"]}, to-moldata '
          f'{conv}, {len(pipe)} molecules in the assembled datasets')
    files = sorted(p.relative_to(root / 'run0')
                   for p in (root / 'run0').rglob('*') if p.is_file())
    same = files == sorted(p.relative_to(root / 'run1')
                           for p in (root / 'run1').rglob('*')
                           if p.is_file())
    differ = [str(f) for f in files if (root / 'run0' / f).read_bytes()
              != (root / 'run1' / f).read_bytes()]
    check(same and not differ and split == split2,
          f'(a) a second run (in process) writes the same {len(files)} '
          f'files byte for byte: {"yes" if same and not differ else differ}')
    line = {'card': smi, 'molecules': DATA_MOLS,
            'conformers': TRAINRUN_CONFS, 'tree_made_ms': made_ms,
            'step_ms': ms, 'step_ms_in_process': ms2, 'split': want,
            'files': len(files)}
    print(f'(a) wall ms: tree {made_ms:.1f}; first run (from-moldata-dirs '
          f'through python -m) ' + ', '.join(f'{k} {v:.1f}'
                                             for k, v in ms.items())
          + '; second run, in process ' + ', '.join(
              f'{k} {v:.1f}' for k, v in ms2.items()), flush=True)
    return data, root / 'run0' / 'espaloma_split.json', line


def sweep_counts(counters):
    return {c.__name__: (c.launches, c.bwd_launches) for c in counters}


def sweep_phase(torch, work, smi, data_dir, splitpath):
    """Phase 12(b): run_sweep at the default width on (a)'s dataset, then
    the same call again (every trial skipped). Returns the sweep's
    launches and the `sweep` line's fields."""
    import copy
    from pathlib import Path
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    from grappa_tpu_torch.train import run as run_mod
    from grappa_tpu_torch.train.config import default_config
    from grappa_tpu_torch.train.sweep import run_sweep
    phase('12(b). run_sweep at the default width (bayes, 4 trials x 2 '
          'epochs)')
    config = sweep_base_config(default_config, str(data_dir), str(splitpath))
    sweep_dir = Path(work) / 'sweep'
    trials = []
    do_trainrun = run_mod.do_trainrun

    def recorded(*args, **kwargs):
        t0 = time.perf_counter()
        out = do_trainrun(*args, **kwargs)
        torch.cuda.synchronize()
        trials.append((out, time.perf_counter() - t0))
        return out

    counters = (fused_gnn_block, fused_transformer_block, fused_symmetriser)
    kw = dict(sweep_dir=str(sweep_dir), seed=0, max_epochs=2,
              method='bayes', n_init=2)
    run_mod.do_trainrun = recorded
    try:
        for c in counters:
            c.launches = c.bwd_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        best = run_sweep(copy.deepcopy(config), SWEEP_SPEC, 4, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = sweep_counts(counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        best_json = (sweep_dir / 'best.json').read_bytes()
        log = (sweep_dir / 'trials.jsonl').read_bytes()
        for c in counters:
            c.launches = c.bwd_launches = 0
        t1 = time.perf_counter()
        again = run_sweep(copy.deepcopy(config), SWEEP_SPEC, 4, **kw)
        resume_ms = (time.perf_counter() - t1) * 1e3
        resumed = sweep_counts(counters)
    finally:
        run_mod.do_trainrun = do_trainrun
    records = [json.loads(x) for x in log.decode().splitlines()]
    rows, forwards, steps = [], 0, 0
    for rec, (out, secs) in zip(records, trials):
        tr = out['trainer']
        split = json.loads((Path(out['run_dir']) / 'split.json').read_text())
        n_steps = tr.global_step
        n_fwd = (n_steps + tr.epoch * len(tr.val_loader)
                 + len(split['test']) + 1)
        forwards, steps = forwards + n_fwd, steps + n_steps
        t = tr.timings
        parts = {'loader_wait': sum(t['loader_wait_s']),
                 'steps': sum(t['step_s']) + sum(t['fetch_s']),
                 'train': sum(t['train_s']), 'validation': sum(t['val_s']),
                 'ckpt_blocking': sum(t['ckpt_blocking_s']),
                 'ckpt_async': sum(t['ckpt_async_s']),
                 'test_eval': out['test_eval_s'] or 0.0}
        parts['rest'] = secs - (parts['train'] + parts['validation']
                                + parts['ckpt_blocking'] + parts['test_eval'])
        rows.append({'trial': rec['trial'], 'params': rec['params'],
                     'early_stopping_loss': rec.get('early_stopping_loss'),
                     'epochs': rec.get('epochs'), 'steps': n_steps,
                     'forwards': n_fwd, 'wall_ms': secs * 1e3,
                     'steps_per_s': n_steps / max(parts['train'], 1e-9),
                     'split_ms': {k: v * 1e3 for k, v in parts.items()}})
        print(f'(b) trial {rec["trial"]}: params {rec["params"]}, '
              f'early_stopping_loss {rec.get("early_stopping_loss")}, '
              f'{rec.get("epochs")} epochs, {n_steps} steps, {n_fwd} '
              f'forwards, wall {secs * 1e3:.1f} ms, '
              f'{rows[-1]["steps_per_s"]:.3f} steps/s; ms: ' + ', '.join(
                  f'{k} {v * 1e3:.1f}' for k, v in parts.items()),
              flush=True)
    want = {'fused_gnn_block': (7 * forwards, 7 * steps),
            'fused_transformer_block': (12 * forwards, 12 * steps),
            'fused_symmetriser': (4 * forwards, 4 * steps)}
    finite = all(r.get('early_stopping_loss') is not None
                 and np.isfinite(r['early_stopping_loss']) for r in records)
    check(len(records) == len(trials) == 4 and finite and got == want
          and steps > 0,
          f'(b) 4 trials recorded with finite losses; launches (forward, '
          f'backward) {got} for {forwards} forwards and {steps} steps (want '
          f'{want}); peak {peak:.3f} GiB; best {best}')
    check(resumed == {c.__name__: (0, 0) for c in counters}
          and (sweep_dir / 'best.json').read_bytes() == best_json
          and (sweep_dir / 'trials.jsonl').read_bytes() == log
          and len(trials) == 4,
          f'(b) the same call again skips every trial in {resume_ms:.1f} ms:'
          f' launches {resumed}, best.json and trials.jsonl unchanged, '
          f'best {again}')
    line = {'card': smi, 'trials': rows, 'wall_ms': wall * 1e3,
            'resume_ms': resume_ms, 'peak_gib': peak, 'launches': got,
            'best': best}
    return got, line


def sweep_parity_phase(torch, work, smi):
    """Phase 12(c): the same random sweep on the card and on the CPU."""
    import copy
    from pathlib import Path
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.synthetic import make_dataset
    from grappa_tpu_torch.train.config import default_config
    from grappa_tpu_torch.train.sweep import run_sweep
    phase('12(c). run_sweep card vs CPU (random, 2 trials, dropout off)')
    small = Path(work) / 'data' / 'sweep_small'
    Dataset.from_moldata(make_dataset(n_mols=8, n_confs=4, seed=0,
                                      atom_range=TRAINRUN_ATOMS)).save(small)
    cfg = trainrun_config(default_config, str(small))
    cfg['model_config'].update(gnn_dropout_attention=0.0,
                               parameter_dropout=0.0, gnn_dropout_final=0.0,
                               gnn_dropout_initial=0.0)
    res = {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        run_sweep(copy.deepcopy(cfg), SWEEP_PARITY_SPEC, 2,
                  sweep_dir=str(Path(work) / f'sweep_{dev}'), seed=1,
                  max_epochs=2, method='random', device=dev)
        res[dev] = ([json.loads(x) for x in (Path(work) / f'sweep_{dev}' /
                     'trials.jsonl').read_text().splitlines()],
                    time.perf_counter() - t0)
    (card, card_s), (cpu, cpu_s) = res['cuda'], res['cpu']
    rel = [abs(a['early_stopping_loss'] - b['early_stopping_loss'])
           / abs(b['early_stopping_loss']) for a, b in zip(card, cpu)
           if a.get('early_stopping_loss') and b.get('early_stopping_loss')]
    check(len(card) == len(cpu) == 2 == len(rel)
          and [a['params'] for a in card] == [b['params'] for b in cpu]
          and max(rel) <= TRAINRUN_RTOL,
          f'(c) params {[a["params"] for a in card]} on both; '
          f'early_stopping_loss card '
          f'{[a.get("early_stopping_loss") for a in card]} vs CPU '
          f'{[b.get("early_stopping_loss") for b in cpu]} (worst rel '
          f'{max(rel, default=float("inf")):.2e}, tol {TRAINRUN_RTOL}); '
          f'card {card_s:.1f} s, CPU {cpu_s:.1f} s')
    return {'card': smi, 'params': [a['params'] for a in card],
            'card_losses': [a.get('early_stopping_loss') for a in card],
            'cpu_losses': [b.get('early_stopping_loss') for b in cpu],
            'worst_rel': max(rel, default=None), 'card_s': card_s,
            'cpu_s': cpu_s}


def eval_plots_phase(torch, cfg, smi, ds, model):
    """Phase 12(d): the plots' device part (eval_model.plot_arrays) on the
    card and on the CPU. Returns its launches and the `eval_plots` line's
    fields."""
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    from grappa_tpu_torch.train.eval_model import plot_arrays
    phase(f'12(d). the scatter plots\' device part, {len(ds)} molecules')
    counters = (fused_gnn_block, fused_transformer_block, fused_symmetriser)
    plot_arrays(model, type(ds)(ds.entries[:1], ds.ds_names[:1]), 'cuda')
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = plot_arrays(model, ds, 'cuda')
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    got = {c.__name__: c.launches for c in counters}
    t0 = time.perf_counter()
    cpu = plot_arrays(model, ds, 'cpu')
    cpu_s = time.perf_counter() - t0
    n = len(ds)
    want = {'fused_gnn_block': 7 * n, 'fused_transformer_block': 12 * n,
            'fused_symmetriser': 4 * n}
    check(got == want, f'(d) launches {got} for {n} molecules (want {want})')
    (name, a), = card.items()
    b = cpu[name]
    compare_outputs(f'(d) {n} molecules\' predicted parameters, card vs CPU,',
                    stack(a['pred']), stack(b['pred']))
    e_err = g_err = 0.0
    ok = True
    for ea, eb, ga, gb in zip(a['e_pred'], b['e_pred'], a['g_pred'],
                              b['g_pred']):
        ea, eb, ga, gb = (np.asarray(x, np.float64) for x in (ea, eb, ga, gb))
        e_tol = MODEL_ATOL + MODEL_RTOL * float(np.abs(eb).max())
        g_tol = FORCE_RTOL * float(np.abs(gb).max())
        ok &= bool(np.isfinite(ea).all() and np.isfinite(ga).all())
        ok &= float(np.abs(ea - eb).max()) <= e_tol
        ok &= float(np.abs(ga - gb).max()) <= g_tol
        e_err = max(e_err, float(np.abs(ea - eb).max()) / e_tol)
        g_err = max(g_err, float(np.abs(ga - gb).max()) / g_tol)
    check(ok and len(a['e_pred']) == n,
          f'(d) centred energies and dE/dx, card vs CPU: worst error / '
          f'tolerance {e_err:.3f} (energies: {MODEL_ATOL} + {MODEL_RTOL} x '
          f'the molecule\'s max |E|) and {g_err:.3f} (dE/dx: {FORCE_RTOL} x '
          f'its max |dE/dx|); card {n / card_s:.2f} molecules/s, CPU '
          f'{n / cpu_s:.2f} molecules/s')
    line = {'card': smi, 'molecules': n, 'card_s': card_s, 'cpu_s': cpu_s,
            'card_molecules_per_s': n / card_s,
            'cpu_molecules_per_s': n / cpu_s, 'launches': got,
            'energy_err_over_tol': e_err, 'gradient_err_over_tol': g_err}
    return got, line


def minimizer_phase(torch, smi):
    """Phase 12(e): make_dataset(learnable=True) of MIN_MOLS molecules of
    tests/test_energy.py:138-171's elements and sizes, its minimisations
    through the bucketed path on the card and then through the 'torch'
    path on the CPU (GRAPPA_TPU_MINIMIZER), each minimisation recorded:
    the bonded energy at each bucketed minimum within max(0.02 |E|, 0.5)
    of the 'torch' one, ms a molecule, make_dataset's wall with each."""
    from grappa_tpu_torch.data import synthetic as syn
    phase(f'12(e). minimize_geometry: \'bucketed\' on the card vs \'torch\' '
          f'on the CPU, make_dataset of {MIN_MOLS} molecules with each')
    minimize = syn.minimize_geometry
    runs = {}

    def recorded(mol, params, xyz0, *args, **kwargs):
        t0 = time.perf_counter()
        x = minimize(mol, params, xyz0, *args, **kwargs)
        runs[method].append((mol, params, x, time.perf_counter() - t0))
        return x

    kw = dict(n_mols=MIN_MOLS, n_confs=8, seed=MIN_SEED, learnable=True,
              elements=[1, 1, 6, 6, 7, 8], atom_range=(12, 20))
    syn.minimize_geometry = recorded
    made = {}
    try:
        for method in ('bucketed', 'torch'):
            os.environ['GRAPPA_TPU_MINIMIZER'] = method
            runs[method] = []
            if method == 'bucketed':      # warm: the card's first graph
                syn.make_dataset(**dict(kw, n_mols=1, seed=MIN_SEED + 1))
                runs[method] = []
            t0 = time.perf_counter()
            syn.make_dataset(**kw)
            made[method] = (time.perf_counter() - t0) * 1e3
    finally:
        syn.minimize_geometry = minimize
        os.environ.pop('GRAPPA_TPU_MINIMIZER', None)
    worst, ok = 0.0, len(runs['bucketed']) == len(runs['torch']) == MIN_MOLS
    for (mol, params, xb, _), (_, _, xt, _) in zip(runs['bucketed'],
                                                   runs['torch']):
        eb = float(syn.torch_bonded_energy(mol, params, xb[None])[0][0])
        et = float(syn.torch_bonded_energy(mol, params, xt[None])[0][0])
        tol = max(0.02 * abs(et), 0.5)
        ok &= bool(np.isfinite(xb).all()) and abs(eb - et) < tol
        worst = max(worst, abs(eb - et) / tol)
    ms = {k: float(np.median([r[3] for r in v])) * 1e3
          for k, v in runs.items()}
    atoms = [len(r[0].atoms) for r in runs['torch']]
    check(ok, f'(e) {MIN_MOLS} molecules ({min(atoms)}-{max(atoms)} atoms): '
              f'bonded energy at the bucketed float32 minimum (card) within '
              f'max(0.02 |E|, 0.5) of the torch float64 one (CPU), worst '
              f'|dE| / tol {worst:.3f}; median ms a molecule: bucketed '
              f'{ms["bucketed"]:.1f}, torch {ms["torch"]:.1f}; '
              f'make_dataset ms: bucketed {made["bucketed"]:.1f}, torch '
              f'{made["torch"]:.1f}')
    return {'card': smi, 'molecules': MIN_MOLS, 'ms_per_molecule': ms,
            'ms_all': {k: [r[3] * 1e3 for r in v] for k, v in runs.items()},
            'worst_energy_over_tol': worst, 'make_dataset_ms': made}


def data_phase(torch, cfg, work, smi, eval_ds=None, eval_model=None):
    """Phase 12. `eval_ds` / `eval_model`: phase 9's first tag's dataset
    and model (made here when not given). Returns {kernel: {path:
    launches}} and the five lines' fields."""
    from grappa_tpu_torch.models.grappa_model import make_model
    t0 = time.perf_counter()
    data_dir, splitpath, tools = data_tools_phase(work, smi)
    t1 = time.perf_counter()
    sweep_got, sweep = sweep_phase(torch, work, smi, data_dir, splitpath)
    t2 = time.perf_counter()
    parity = sweep_parity_phase(torch, work, smi)
    t3 = time.perf_counter()
    if eval_ds is None:
        eval_ds = eval_tag_dataset(0)
        eval_model = perturbed_model(torch, make_model, cfg, seed=9)
    t4 = time.perf_counter()
    plots_got, plots = eval_plots_phase(torch, cfg, smi, eval_ds, eval_model)
    t5 = time.perf_counter()
    minimizer = minimizer_phase(torch, smi)
    t6 = time.perf_counter()
    for line, a, b in ((tools, t0, t1), (sweep, t1, t2), (parity, t2, t3),
                       (plots, t4, t5), (minimizer, t5, t6)):
        line['phase_s'] = b - a
    launches = {}
    for name, (nf, nb) in sweep_got.items():
        launches.setdefault(name, {})['sweep'] = nf
        launches.setdefault(f'{name}.backward', {})['sweep'] = nb
        launches[name]['eval_plots'] = plots_got[name]
    lines = {'dataset_tools': tools, 'sweep': sweep, 'sweep_parity': parity,
             'eval_plots': plots, 'minimizer': minimizer}
    return launches, lines


# ---------------------------------------------------------------- phase 13
def parallel_model(torch, cfg, device='cuda'):
    """phase 13's weights: perturbed_model's seed 0, on `device`."""
    from grappa_tpu_torch.models.grappa_model import make_model
    return perturbed_model(torch, make_model, cfg).to(device)


class CaptureAdam:
    """AdamClip that keeps a copy of the gradients its step is given (the
    ranks' mean, in a data-parallel step)."""

    def __init__(self, opt):
        self.opt, self.seen = opt, None

    def step(self, params, grads, lr):
        if self.seen is None:
            self.seen = [g.detach().clone() for g in grads]
        self.opt.step(params, grads, lr)


def cuda_ms(torch, fn):
    """(fn()'s result, its ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def counted(torch, fn):
    """(fn()'s result, {op: (float32 fwd, bf16 fwd, float32 bwd, bf16
    bwd) launches}) with the counts zeroed just before fn and read just
    after it."""
    counters = bf16_counters()
    zero_counts(counters)
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(counters)


def max_rel(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def params_close(model, want, rtol, atol):
    """Whether every parameter of `model` lies within atol + rtol |want|
    of the same-named one of `want`; the worst max |diff|."""
    worst, ok = 0.0, True
    for (name, p), q in zip(model.named_parameters(), want.parameters()):
        err = (p.detach() - q.detach()).abs()
        ok &= bool((err <= atol + rtol * q.detach().abs()).all())
        worst = max(worst, float(err.max()))
    return ok, worst


def dp_sub_batches(torch, graphs, world, rank):
    """Rank `rank`'s share of the 128 x 32 training batch: molecules
    rank * 128 / W .. (rank + 1) * 128 / W - 1, bucketed padding."""
    from grappa_tpu_torch.data.graph_batch import collate
    from grappa_tpu_torch.data.loader import bucketed_pad_spec
    per = len(graphs) // world
    mine = graphs[rank * per:(rank + 1) * per]
    return collate(mine, bucketed_pad_spec(mine, TRAIN_CONFS), TRAIN_CONFS,
                   device='cuda')


def parallel_rank(rank, world, work):
    """One of phase 13's gloo ranks, all on the one card: (b) the DP step
    on its share of the 128 x 32 batch, (c) a Trainer(mesh=...) epoch
    with a trailing group and the conformer-sharded energy, (d) the
    atom-sharded forward, train step and NVE at 12,000 atoms; rank 0
    also runs (d)'s unsharded references. Writes its numbers and checks
    to rank<r>.json (rank 0 the DP step's mean gradients to dp.pt)."""
    sys.path.insert(0, ROOT)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from grappa_tpu_torch import md
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.loader import GraphLoader
    from grappa_tpu_torch.data.synthetic import make_dataset, make_moldata
    from grappa_tpu_torch.models.grappa_model import get_default_model_config
    from grappa_tpu_torch.parallel import dp, sp
    from grappa_tpu_torch.train.trainer import (Trainer, make_eval_step,
                                                make_optimizer,
                                                make_train_step)
    cfg = get_default_model_config()
    mesh = dp.make_mesh(world, device='cuda:0',
                        init_method=f'file://{work}/store', rank=rank,
                        world_size=world, timeout_s=PAR_TIMEOUT_S)
    res = {'rank': rank, 'backend': mesh.backend, 'launches': {}}
    gib = lambda: torch.cuda.max_memory_allocated() / 2 ** 30

    def tally(counts):
        for name, c in counts.items():
            res['launches'][name] = res['launches'].get(name, 0) + c[0]
            res['launches'][f'{name}.backward'] = res['launches'].get(
                f'{name}.backward', 0) + c[2]

    # (b) the DP step on rank's 64 of the 128 molecules x 32 conformers
    graphs = training_batches(torch)
    batch = dp_sub_batches(torch, graphs, world, rank)
    model = parallel_model(torch, cfg)
    opt = CaptureAdam(make_optimizer())
    step = dp.make_dp_train_step(model, opt, mesh)
    w = loss_weights(torch, batch.num_mols, 'cuda')
    gen = torch.Generator().manual_seed(PAR_SEED)
    torch.cuda.reset_peak_memory_stats()
    ((loss, aux), ms), counts = counted(torch, lambda: cuda_ms(
        torch, lambda: step(batch, w, TRAIN_LR, gen)))
    tally(counts)
    res['dp_first_step_ms'] = ms
    res['dp_counts'] = counts
    times = [cuda_ms(torch, lambda: step(batch, w, TRAIN_LR, gen))[1]
             for _ in range(PAR_DP_STEPS)]
    res['dp_step_ms'] = float(np.median(times))
    res['dp_step_ms_all'] = times
    ar = [cuda_ms(torch, lambda: dp.mean_over_ranks(opt.seen, mesh))[1]
          for _ in range(3)]
    res['all_reduce_ms'] = float(np.median(ar))
    res['all_reduce_mb'] = 4 * sum(g.numel() for g in opt.seen) / 1e6
    res['dp_peak_gib'] = gib()
    res['dp_loss'] = float(loss)
    # every rank holds the same mean gradients and parameters
    norms = torch.stack([g.double().norm() for g in opt.seen]
                        + [p.detach().double().norm()
                           for p in model.parameters()]).float()
    allnorms = mesh.all_gather(norms[None])
    res['dp_ranks_equal'] = bool((allnorms == allnorms[0]).all())
    if rank == 0:
        torch.save({'loss': float(loss),
                    'aux': {k: v.cpu() for k, v in aux.items()},
                    'grads': [g.cpu() for g in opt.seen]},
                   os.path.join(work, 'dp.pt'))
    del model, opt, step, batch

    # (c) a Trainer(mesh=...) epoch: 5 batches of 2 over 2 ranks, the
    # last group a trailing one; the conformer-sharded energy
    ds = Dataset.from_moldata(make_dataset(n_mols=PAR_TRAINER_MOLS,
                                           n_confs=PAR_TRAINER_CONFS,
                                           seed=PAR_SEED), 'syn')
    loader = GraphLoader(ds, batch_size=2, conf_strategy=PAR_TRAINER_CONFS,
                         shuffle=True, drop_last=True, seed=0,
                         device='cuda')
    model = parallel_model(torch, cfg)
    trainer = Trainer(model, loader, None,
                      {'lr': TRAIN_LR, 'start_qm_epochs': 0,
                       'warmup_steps': 2, 'patience': 0},
                      {'max_epochs': 1}, out_dir=None, mesh=mesh)
    (mean_loss, ms), counts = counted(torch, lambda: cuda_ms(
        torch, trainer.train_epoch))
    tally(counts)
    res['trainer'] = dict(losses=trainer.train_losses[0],
                          steps=trainer.global_step, epoch_ms=ms,
                          counts=counts)
    sums = torch.stack([p.detach().double().sum()
                        for p in model.parameters()]).float()
    allsums = mesh.all_gather(sums[None])
    res['trainer']['ranks_equal'] = bool((allsums == allsums[0]).all())
    conf_batch = collate(graphs[:8], n_confs=TRAIN_CONFS, device='cuda')
    model.eval()
    with torch.no_grad():
        pred = model(conf_batch)
    e, g = dp.make_conf_sharded_energy_fn(mesh)(conf_batch, pred)
    from grappa_tpu_torch.models import mm_energy
    e_ref, g_ref = mm_energy.energy_and_gradient(conf_batch, pred)
    res['conf'] = dict(
        energy_ok=bool(((e - e_ref).abs() <= MODEL_ATOL
                        + MODEL_RTOL * e_ref.abs()).all()),
        energy_err=float((e - e_ref).abs().max()),
        grad_rel=max_rel(g, g_ref))
    del model, trainer, loader, conf_batch
    torch.cuda.empty_cache()

    # (d) atom-sharded: 12,000 atoms x 4 conformers
    mdata = make_moldata(seed=0, n_confs=FUSION_CONFS, n_atoms=SP_ATOMS)
    graph = MolGraph.from_moldata(mdata)
    whole = collate([graph], pad=sp.atom_sharded_pad_spec(
        [graph], FUSION_CONFS, mesh), device='cuda')
    sharded = sp.shard_batch_by_atoms(whole, mesh)
    model = parallel_model(torch, cfg)
    fwd = sp.make_atom_sharded_forward(model, mesh)
    torch.cuda.reset_peak_memory_stats()
    ((energy, grad), ms), counts = counted(torch, lambda: cuda_ms(
        torch, lambda: fwd(sharded)))
    tally(counts)
    res['sp_forward'] = dict(ms=ms, counts=counts, warm_ms=cuda_ms(
        torch, lambda: fwd(sharded))[1])
    grad_all = mesh.all_gather(grad)
    sp_model = parallel_model(torch, cfg)
    sp_opt = CaptureAdam(make_optimizer())
    sp_step = sp.make_atom_sharded_train_step(sp_model, sp_opt, mesh)
    wts = loss_weights(torch, 1, 'cuda')
    ((sp_loss, sp_aux), ms), counts = counted(torch, lambda: cuda_ms(
        torch, lambda: sp_step(sharded, wts, TRAIN_LR,
                               torch.Generator().manual_seed(PAR_SEED))))
    tally(counts)
    res['sp_step'] = dict(ms=ms, counts=counts, loss=float(sp_loss),
                          peak_gib=gib())
    params = ref_params(torch, sharded)
    masses = md.masses_from_molecules([mdata.molecule],
                                      whole.xyz.shape[0], device='cuda')
    traj, ms = cuda_ms(torch, lambda: md.simulate(
        sharded, params, masses, dt_fs=SP_MD_DT, n_steps=SP_MD_STEPS))
    res['sp_md'] = dict(ms_a_step=ms / SP_MD_STEPS)
    xyz_all = mesh.all_gather(traj['xyz'])
    # the sharded gradients of the first step's loss in float64 (every
    # rank: the forward's and backward's collectives), the ranks' mean
    loss64_sh, grads64_sh = float64_loss_gradients(torch, cfg, sharded, wts)
    grads64_sh = dp.mean_over_ranks(grads64_sh, mesh)
    if rank == 0:
        # the unsharded path on the same card, the others waiting
        e_ref, g_ref = make_eval_step(model)(whole)
        ref_model = parallel_model(torch, cfg)
        ref_opt = CaptureAdam(make_optimizer())
        ref_loss, _ = make_train_step(ref_model, ref_opt)(
            whole, wts, TRAIN_LR, torch.Generator().manual_seed(PAR_SEED))
        md_ref = md.simulate(whole, ref_params(torch, whole), masses,
                             dt_fs=SP_MD_DT, n_steps=SP_MD_STEPS)
        loss64, grads64 = float64_loss_gradients(torch, cfg, whole, wts)
        names = [n for n, _ in sp_model.named_parameters()]
        rl2 = lambda a, b: float((a.double() - b.double()).norm()) / max(
            float(b.double().norm()), 1e-30)
        sharded_rl2 = [rl2(a, b) for a, b in zip(grads64_sh, grads64)]
        step_rl2 = [rl2(a, b) for a, b in zip(sp_opt.seen, grads64)]
        ref_rl2 = [rl2(a, b) for a, b in zip(ref_opt.seen, grads64)]
        worst = int(np.argmax(sharded_rl2))
        flat = lambda gs: torch.cat([g.reshape(-1).double() for g in gs])
        p_ok, p_err = params_close(sp_model, ref_model, SP_PARAM_TOL,
                                   SP_PARAM_TOL)
        res['sp_ref'] = dict(
            energy_ok=bool(((energy - e_ref).abs() <= SP_E_TOL
                            + SP_E_TOL * e_ref.abs()).all()),
            energy_err=float((energy - e_ref).abs().max()),
            grad_ok=bool(((grad_all - g_ref).abs() <= SP_G_TOL
                          + SP_G_TOL * g_ref.abs()).all()),
            grad_err=float((grad_all - g_ref).abs().max()),
            loss=float(ref_loss), loss64=loss64, loss64_sh=loss64_sh,
            grad_rl2=sharded_rl2[worst], grad_worst=names[worst],
            grad_n=len(names),
            grad_rl2_all=rl2(flat(grads64_sh), flat(grads64)),
            step_grad_rl2=max(step_rl2),
            step_grad_rl2_all=rl2(flat(sp_opt.seen), flat(grads64)),
            step_grad_over=int(sum(x > STEP_GRAD_RL2 for x in step_rl2)),
            ref_grad_rl2=max(ref_rl2),
            ref_grad_rl2_all=rl2(flat(ref_opt.seen), flat(grads64)),
            ref_grad_over=int(sum(x > STEP_GRAD_RL2 for x in ref_rl2)),
            loss_rel=abs(float(sp_loss) - float(ref_loss))
            / abs(float(ref_loss)),
            gradient_mse=float(sp_aux['gradient_mse'][0]),
            params_ok=p_ok, params_err=p_err,
            md_ok=bool(((traj['potential'] - md_ref['potential']).abs()
                        <= SP_MD_TOL + SP_MD_TOL
                        * md_ref['potential'].abs()).all()
                       and ((xyz_all - md_ref['xyz']).abs() <= SP_MD_TOL
                            + SP_MD_TOL * md_ref['xyz'].abs()).all()),
            md_potential_err=float((traj['potential']
                                    - md_ref['potential']).abs().max()),
            md_xyz_err=float((xyz_all - md_ref['xyz']).abs().max()))
    mesh.barrier()
    res['peak_gib'] = gib()
    with open(os.path.join(work, f'rank{rank}.json'), 'w') as f:
        json.dump(res, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def float64_loss_gradients(torch, cfg, batch, weights, ulp=False):
    """The loss of the first step's prediction (phase 13's weights, the
    training-mode forward with PAR_SEED's dropout seeds) in float64 from
    the float32 parameters on, and its gradients (float32, the model's
    backward as in a step): a step's gradients with the loss resolved
    past float32 (the centred energies of a molecule whose total is ~1e7
    carry a few units of rounding). On a rank's shard every rank calls it
    and the gradients are the rank's part. ulp: every weight one float32
    ulp away first (`ulp_model`)."""
    from grappa_tpu_torch.train.loss import LossWeights, molwise_loss
    model = parallel_model(torch, cfg).train()
    if ulp:
        ulp_model(torch, model)
    pred = model(batch, torch.Generator().manual_seed(PAR_SEED))
    up = lambda t: t.double() if t.is_floating_point() else t
    loss, _ = molwise_loss(batch._map(up), {k: v.double()
                                            for k, v in pred.items()},
                           LossWeights(*(up(torch.as_tensor(x, device='cuda'))
                                         for x in weights)))
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return float(loss), [torch.zeros_like(p) if g is None else g.float()
                         for p, g in zip(params, grads)]


def ulp_model(torch, model, seed=5):
    """Every parameter of `model` moved by one float32 ulp in a seeded
    random direction (10(c)(d)'s one-ulp change)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for q in model.parameters():
            up = torch.rand(q.shape, generator=gen) < 0.5
            way = torch.where(up, torch.tensor(float('inf')),
                              torch.tensor(float('-inf'))).to(q.device)
            q.copy_(torch.nextafter(q, way))
    return model


def rows_counts():
    """{op: (`_rows` forward, `_rows` backward) launches} of K1 and K2."""
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    return {c.__name__: (c.rows_launches, c.rows_bwd_launches)
            for c in (fused_gnn_block, fused_transformer_block)}


def counted_rows(torch, fn):
    """(fn()'s result, bf16_counters' counts, rows_counts) with every count
    zeroed just before fn and read just after it."""
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    for c in (fused_gnn_block, fused_transformer_block):
        c.rows_launches = c.rows_bwd_launches = 0
    out, counts = counted(torch, fn)
    return out, counts, rows_counts()


def offset_kernel_checks(torch):
    """13(e): K1m / K2m with a shard's rows against the unsharded dump's
    rows, bit for bit, and K1 / K1b, K2 / K2b with the row offset against
    their plain versions on the unsharded masks' rows, at the halves of
    the 128 x 32 batch's nodes (N 3376) and n4 tuples (S 4, T 8256)."""
    from grappa_tpu_torch.ops import fused_block as fb
    from grappa_tpu_torch.ops import fused_gnn as fg
    from grappa_tpu_torch.ops import philox
    gen = torch.Generator().manual_seed(77)
    f, heads, hid, d = 512, 16, 2048, 8
    for op, full_shape, rate, seed in ((fg, (3376, f), 0.3, 17),
                                       (fb, (4, 8256, f), 0.5, 101)):
        total = full_shape[-2]
        first, n = total // 2, total // 2
        shape = (*full_shape[:-2], n, f)
        want = op.dropout_masks(seed, full_shape, rate, device='cuda')
        got = op.dropout_masks(seed, shape, rate, device='cuda',
                               rows=(first, total))
        same = all(torch.equal(a, b[..., first:first + n, :])
                   for a, b in zip(got, want))
        check(same, f'(e) {op.__name__.split(".")[-1]}.dropout_masks rows '
                    f'{first}..{total - 1} of {total}, shape {shape}: '
                    f'bit-equal to the unsharded dump\'s rows')
        masks = [m[..., first:first + n, :] for m in want]
        if op is fg:
            mask = (torch.rand((d, n), generator=gen) < 0.8).float()
            mask[0] = 1.0
            mask = mask.cuda()
            p1 = rand_params(torch, gen, [
                ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
                ((hid, f), 'w'), ((hid,), 'b'), ((f, hid), 'w'),
                ((f,), 'b')])
            inputs = [torch.randn((n, f), generator=gen).cuda(),
                      torch.randn((d, n, f), generator=gen).cuda(),
                      torch.randn((n, f), generator=gen).cuda(), *p1]
            kernel = lambda a, b, c, *q: fg.fused_gnn_block(
                a, b, c, mask, q, heads, rate, True, seed,
                rows=(first, total))
            plain = lambda a, b, c, *q: fg.reference_gnn_block(
                a, b, c, mask, q, heads, masks)
            name, dy = 'fused_gnn_block', torch.randn(
                (n, f), generator=gen).cuda()
        else:
            p2 = rand_params(torch, gen, [
                ((f,), 'g'), ((f,), 'b'), ((3 * f, f), 'w'),
                ((3 * f,), 'b'), ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'),
                ((f,), 'b'), ((f, f), 'w'), ((f,), 'b'), ((f, f), 'w'),
                ((f,), 'b')])
            inputs = [torch.randn(shape, generator=gen).cuda(), *p2]
            kernel = lambda a, *q: fb.fused_transformer_block(
                a, q, 8, rate, True, seed, rows=(first, total))
            plain = lambda a, *q: fb.reference_block(a, q, 8, masks)
            name, dy = 'fused_transformer_block', torch.randn(
                shape, generator=gen).cuda()
        label = f'rows {first}..{total - 1} of {total}, dropout {rate}'
        compare_out(torch, {}, name, label, lambda: kernel(*inputs),
                    lambda: plain(*inputs), 0.0, 0.0, on_path=False)
        compare_grad(torch, {}, f'{name}.backward', label, kernel, plain,
                     inputs, dy, 0.0, 0.0, record=False)


def parallel_phase(torch, smi):
    """Phase 13 (module doc). Returns ({kernel name: launches on phase
    13's paths}, the `parallel` line)."""
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from grappa_tpu_torch.models.grappa_model import get_default_model_config
    from grappa_tpu_torch.ops import philox
    from grappa_tpu_torch.parallel import dp
    from grappa_tpu_torch.train.trainer import (loss_gradients,
                                                make_optimizer,
                                                make_train_step)
    phase('13. the multi-device layer on the one card')
    torch.cuda.empty_cache()     # the ranks share the card with this process
    cfg = get_default_model_config()
    line = {'card': smi}
    launches = {}

    # (a) a mesh of one rank on NCCL: 3 DP steps = make_train_step's
    graphs = training_batches(torch)
    batch = dp_sub_batches(torch, graphs, 1, 0)
    w = loss_weights(torch, batch.num_mols, 'cuda')
    mesh = dp.make_mesh(1)
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        a, b = parallel_model(torch, cfg), parallel_model(torch, cfg)
        sa = make_train_step(a, make_optimizer())
        sb = dp.make_dp_train_step(b, make_optimizer(), mesh)
        ga = torch.Generator().manual_seed(PAR_SEED)
        gb = torch.Generator().manual_seed(PAR_SEED)
        ms_a, ms_b, same_loss = [], [], True
        for _ in range(PAR_DP_STEPS):
            (la, _), t = cuda_ms(torch, lambda: sa(batch, w, TRAIN_LR, ga))
            ms_a.append(t)
            ((lb, _), t), counts = counted(torch, lambda: cuda_ms(
                torch, lambda: sb(batch, w, TRAIN_LR, gb)))
            ms_b.append(t)
            same_loss &= torch.equal(la, lb)
            for name, c in counts.items():
                launches[name] = launches.get(name, 0) + c[0]
                launches[f'{name}.backward'] = launches.get(
                    f'{name}.backward', 0) + c[2]
        same = all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                      b.parameters()))
        worst = max(float((p - q).detach().abs().max())
                    for p, q in zip(a.parameters(), b.parameters()))
        flat = torch.cat([p.detach().reshape(-1) for p in b.parameters()])
        ar = [cuda_ms(torch, lambda: mesh.all_reduce_(flat))[1]
              for _ in range(3)]
        check(mesh.backend == 'nccl' and same and same_loss,
              f'(a) world size 1 on {mesh.backend}: {PAR_DP_STEPS} DP steps '
              f'at 128 x 32 with dropout equal make_train_step\'s, losses '
              f'{same_loss}, parameters bit for bit {same} (max |diff| '
              f'{worst:.3e}; deterministic algorithms on)')
        want = want_counts(False, False, PAR_DP_STEPS, PAR_DP_STEPS)
        check(all(launches[n] == want[n][0]
                  and launches[f'{n}.backward'] == want[n][2]
                  for n in want),
              f'(a) launches of the {PAR_DP_STEPS} DP steps {launches}')
        line['nccl_world_1'] = dict(
            step_ms=float(np.median(ms_b)), make_train_step_ms=float(
                np.median(ms_a)), all_reduce_ms=float(np.median(ar)),
            all_reduce_mb=flat.numel() * 4 / 1e6,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del a, b, sa, sb, flat
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b)-(d): two gloo ranks sharing the card
    os.makedirs(os.path.join(ROOT, 'runs'), exist_ok=True)
    work = tempfile.mkdtemp(prefix='parallel_', dir=os.path.join(
        ROOT, 'runs'))
    t0 = time.time()
    try:
        ctx = mp.start_processes(parallel_rank, args=(PAR_RANKS, work),
                                 nprocs=PAR_RANKS, join=False,
                                 start_method='spawn')
        deadline = time.time() + PAR_JOIN_S
        try:
            while not ctx.join(timeout=2):
                if time.time() > deadline:
                    raise TimeoutError(f'the ranks ran past {PAR_JOIN_S} s')
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = []
        for r in range(PAR_RANKS):
            with open(os.path.join(work, f'rank{r}.json')) as f:
                ranks.append(json.load(f))
        dp_out = torch.load(os.path.join(work, 'dp.pt'), weights_only=False)
    except Exception as exc:
        check(False, f'(b)-(d) the gloo ranks: {type(exc).__name__}: {exc}')
        shutil.rmtree(work, ignore_errors=True)
        return launches, line
    shutil.rmtree(work, ignore_errors=True)
    wall = time.time() - t0

    # (b) against one process's mean of the sub-batches' gradients
    losses, grads = [], None
    for r in range(PAR_RANKS):
        model = parallel_model(torch, cfg)
        sub = dp_sub_batches(torch, graphs, PAR_RANKS, r)
        loss, _, g = loss_gradients(
            model, sub, loss_weights(torch, sub.num_mols, 'cuda'),
            philox.RankSeeds(torch.Generator().manual_seed(PAR_SEED), r,
                             PAR_RANKS))
        losses.append(float(loss))
        g = [t.float() for t in g.values()]
        grads = g if grads is None else [x + y for x, y in zip(grads, g)]
        del model, sub
    want_loss = float(np.mean(losses))
    rel = [float((a.cuda() - b / PAR_RANKS).norm()
                 / max(float((b / PAR_RANKS).norm()), 1e-30))
           for a, b in zip(dp_out['grads'], grads)]
    loss_rel = abs(dp_out['loss'] - want_loss) / abs(want_loss)
    check(loss_rel <= STEP_LOSS_RTOL and max(rel) <= STEP_GRAD_RL2
          and all(r['dp_ranks_equal'] for r in ranks),
          f'(b) {PAR_RANKS} gloo ranks on one card ({ranks[0]["backend"]}): '
          f'the DP step on {PAR_RANKS} x {TRAIN_MOLS // PAR_RANKS} x '
          f'{TRAIN_CONFS} against one process\'s mean of the sub-batches\' '
          f'gradients (same dropout seeds): loss rel {loss_rel:.3e} (tol '
          f'{STEP_LOSS_RTOL}), worst gradient relative L2 {max(rel):.3e} '
          f'(tol {STEP_GRAD_RL2}); every rank the same mean and parameters '
          f'{all(r["dp_ranks_equal"] for r in ranks)}')
    want1 = want_counts(False, False, 1, 1)
    for r in ranks:
        check(all(tuple(r['dp_counts'][n]) == want1[n] for n in want1),
              f'(b) rank {r["rank"]}: launches of its DP step '
              f'{r["dp_counts"]}')
        t = r['trainer']
        check(t['steps'] == 3 and all(np.isfinite(t['losses']))
              and t['ranks_equal'],
              f'(c) rank {r["rank"]}: Trainer(mesh=...) epoch of 5 batches: '
              f'{t["steps"]} steps (the last a trailing group of 1), losses '
              f'{t["losses"]}, parameters equal on every rank '
              f'{t["ranks_equal"]}')
        c = r['conf']
        check(c['energy_ok'] and c['grad_rel'] <= FORCE_RTOL,
              f'(c) rank {r["rank"]}: conformer-sharded energy (8 x 32, '
              f'16 conformers a rank) against the unsharded: energy max '
              f'err {c["energy_err"]:.3e} (tol {MODEL_ATOL} + '
              f'{MODEL_RTOL}|E|), dE/dx max|err|/max {c["grad_rel"]:.3e} '
              f'(tol {FORCE_RTOL})')
        for key, nf, nb in (('sp_forward', 1, 0), ('sp_step', 1, 1)):
            want = want_counts(False, False, nf, nb)
            check(all(tuple(r[key]['counts'][n]) == want[n] for n in want),
                  f'(d) rank {r["rank"]}: launches of the {key} '
                  f'{r[key]["counts"]}')
        for name, n in r['launches'].items():
            launches[name] = launches.get(name, 0) + n
    s = ranks[0]['sp_ref']
    check(s['energy_ok'] and s['grad_ok'],
          f'(d) atom-sharded forward, {SP_ATOMS} atoms x {FUSION_CONFS} '
          f'conformers over {PAR_RANKS} ranks, against the unsharded: '
          f'energy max err {s["energy_err"]:.3e} (tol {SP_E_TOL} + '
          f'{SP_E_TOL}|E|), dE/dx max err {s["grad_err"]:.3e} (tol '
          f'{SP_G_TOL} + {SP_G_TOL}|g|)')
    # the loss against its float64 value, and the all-reduced gradients
    # with the loss in float64 against one process's on the whole batch:
    # float32 resolves this loss only to ~1e-3, and a step's gradients
    # carry that rounding (the float32 steps' gradients are readings)
    sp_loss, l64 = ranks[0]['sp_step']['loss'], s['loss64']
    off_sp, off_ref = abs(sp_loss - l64), abs(s['loss'] - l64)
    check(off_sp <= SP_LOSS_RTOL * abs(l64)
          and s['grad_rl2'] <= STEP_GRAD_RL2 and s['params_ok'],
          f'(d) atom-sharded train step with dropout: loss {sp_loss:.6e} vs '
          f'the float64 loss of the same prediction {l64:.6e}, rel '
          f'{off_sp / abs(l64):.3e} (tol {SP_LOSS_RTOL}; the unsharded '
          f'float32 loss {s["loss"]:.6e}, rel {off_ref / abs(l64):.3e}); '
          f'with the loss in float64, the worst of the {s["grad_n"]} '
          f'all-reduced gradients against the unsharded, relative L2 '
          f'{s["grad_rl2"]:.3e} ({s["grad_worst"]}; tol {STEP_GRAD_RL2}; '
          f'all together {s["grad_rl2_all"]:.3e}); the float32 steps\' '
          f'gradients against those float64-loss ones: sharded worst '
          f'{s["step_grad_rl2"]:.3e}, all {s["step_grad_rl2_all"]:.3e}, '
          f'{s["step_grad_over"]} over {STEP_GRAD_RL2}; unsharded worst '
          f'{s["ref_grad_rl2"]:.3e}, all {s["ref_grad_rl2_all"]:.3e}, '
          f'{s["ref_grad_over"]} over; parameters max |diff| '
          f'{s["params_err"]:.3e} (tol {SP_PARAM_TOL} + {SP_PARAM_TOL}|p|)')
    check(s['md_ok'],
          f'(d) atom-sharded NVE, {SP_MD_STEPS} steps at {SP_MD_DT} fs with '
          f'the reference parameters: potential max err '
          f'{s["md_potential_err"]:.3e}, xyz {s["md_xyz_err"]:.3e} (tol '
          f'{SP_MD_TOL} + {SP_MD_TOL}|x|)')

    # (e) the row offsets of K1 / K1b / K1m, K2 / K2b / K2m
    offset_kernel_checks(torch)

    line['gloo_two_ranks_one_card'] = dict(
        note=f'{PAR_RANKS} processes sharing one card over gloo: the '
             f'collectives go through host memory; no multi-card speed',
        wall_s=wall, dp_loss_rel=loss_rel, dp_grad_rel_l2=max(rel),
        sp=dict(atoms=SP_ATOMS, energy_err=s['energy_err'],
                grad_err=s['grad_err'], loss_rel=s['loss_rel'],
                loss_off64_sharded=off_sp / abs(l64),
                loss_off64_unsharded=off_ref / abs(l64),
                loss64_sharded_rel=abs(s['loss64_sh'] - l64) / abs(l64),
                grad64_rel_l2_worst=s['grad_rl2'],
                grad64_rel_l2_all=s['grad_rl2_all'],
                step_grad_rel_l2_worst=s['step_grad_rl2'],
                step_grad_rel_l2_all=s['step_grad_rl2_all'],
                step_grad_over=s['step_grad_over'],
                unsharded_step_grad_rel_l2_worst=s['ref_grad_rl2'],
                unsharded_step_grad_rel_l2_all=s['ref_grad_rl2_all'],
                unsharded_step_grad_over=s['ref_grad_over'],
                params_err=s['params_err'],
                md_potential_err=s['md_potential_err'],
                md_xyz_err=s['md_xyz_err']),
        ranks=[dict(
            rank=r['rank'], dp_step_ms=r['dp_step_ms'],
            dp_step_ms_all=r['dp_step_ms_all'],
            dp_first_step_ms=r['dp_first_step_ms'],
            all_reduce_ms=r['all_reduce_ms'],
            all_reduce_mb=r['all_reduce_mb'],
            dp_peak_gib=r['dp_peak_gib'],
            trainer_epoch_ms=r['trainer']['epoch_ms'],
            sp_forward_ms=r['sp_forward']['ms'],
            sp_forward_warm_ms=r['sp_forward']['warm_ms'],
            sp_step_ms=r['sp_step']['ms'],
            sp_step_peak_gib=r['sp_step']['peak_gib'],
            sp_md_ms_a_step=r['sp_md']['ms_a_step'],
            peak_gib=r['peak_gib']) for r in ranks])
    return launches, line


def parallel_bf16_rank(rank, world, work, spread):
    """One of phase 13(e)'s gloo ranks on the one card, the default model
    in bf16 (PAR_BF16), deterministic algorithms on: the DP step on its
    share of the 128 x 32 batch, a Trainer(mesh=...) epoch with a trailing
    group, the atom-sharded forward and train step at SP_ATOMS atoms
    (rank 0 also the unsharded references), and 13(f): the atom-sharded
    MM energy with and without K5 / K5b on the reference parameters (rank
    0 also the unsharded fused energy). spread: rank 0 also reads the
    unsharded step's one-ulp spread. Writes its numbers to
    bf16_rank<r>.json (rank 0 the DP step's mean gradients to dp16.pt)."""
    sys.path.insert(0, ROOT)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.graph_batch import MolGraph, collate
    from grappa_tpu_torch.data.loader import GraphLoader
    from grappa_tpu_torch.data.synthetic import make_dataset, make_moldata
    from grappa_tpu_torch.models import mm_energy
    from grappa_tpu_torch.models.grappa_model import get_default_model_config
    from grappa_tpu_torch.parallel import dp, sp
    from grappa_tpu_torch.train.trainer import (Trainer, make_eval_step,
                                                make_optimizer,
                                                make_train_step)
    cfg = dict(get_default_model_config(), **PAR_BF16)
    mesh = dp.make_mesh(world, device='cuda:0',
                        init_method=f'file://{work}/store', rank=rank,
                        world_size=world, timeout_s=PAR_TIMEOUT_S)
    res = {'rank': rank, 'backend': mesh.backend, 'launches': {}}
    gib = lambda: torch.cuda.max_memory_allocated() / 2 ** 30

    def tally(counts):
        for name, c in counts.items():
            for key, n in zip((name, f'{name}.bf16', f'{name}.backward',
                               f'{name}.bf16_bwd'), c):
                if n:
                    res['launches'][key] = res['launches'].get(key, 0) + n

    def collectives():
        seen = sorted(f'{op}:{dt}' for op, dt in dp.COLLECTIVE_DTYPES)
        dp.COLLECTIVE_DTYPES.clear()
        return seen

    # the DP step on rank's 64 of the 128 molecules x 32 conformers
    graphs = training_batches(torch)
    batch = dp_sub_batches(torch, graphs, world, rank)
    model = parallel_model(torch, cfg)
    opt = CaptureAdam(make_optimizer())
    step = dp.make_dp_train_step(model, opt, mesh)
    w = loss_weights(torch, batch.num_mols, 'cuda')
    gen = torch.Generator().manual_seed(PAR_SEED)
    torch.cuda.reset_peak_memory_stats()
    dp.COLLECTIVE_DTYPES.clear()
    ((loss, _), ms), counts, rows = counted_rows(torch, lambda: cuda_ms(
        torch, lambda: step(batch, w, TRAIN_LR, gen)))
    tally(counts)
    res['dp'] = dict(first_ms=ms, counts=counts, rows=rows, loss=float(loss),
                     collectives=collectives())
    times = [cuda_ms(torch, lambda: step(batch, w, TRAIN_LR, gen))[1]
             for _ in range(PAR_DP_STEPS)]
    ar = [cuda_ms(torch, lambda: dp.mean_over_ranks(opt.seen, mesh))[1]
          for _ in range(3)]
    norms = torch.stack([g.double().norm() for g in opt.seen]
                        + [p.detach().double().norm()
                           for p in model.parameters()]).float()
    allnorms = mesh.all_gather(norms[None])
    res['dp'].update(
        step_ms=float(np.median(times)), step_ms_all=times,
        all_reduce_ms=float(np.median(ar)),
        all_reduce_mb=4 * sum(g.numel() for g in opt.seen) / 1e6,
        peak_gib=gib(), ranks_equal=bool((allnorms == allnorms[0]).all()))
    if rank == 0:
        torch.save({'loss': float(loss),
                    'grads': [g.cpu() for g in opt.seen]},
                   os.path.join(work, 'dp16.pt'))
    del model, opt, step, batch
    torch.cuda.empty_cache()

    # a bf16 Trainer(mesh=...) epoch: 5 batches of 2 over 2 ranks, the last
    # group a trailing one
    ds = Dataset.from_moldata(make_dataset(n_mols=PAR_TRAINER_MOLS,
                                           n_confs=PAR_TRAINER_CONFS,
                                           seed=PAR_SEED), 'syn')
    loader = GraphLoader(ds, batch_size=2, conf_strategy=PAR_TRAINER_CONFS,
                         shuffle=True, drop_last=True, seed=0,
                         device='cuda')
    model = parallel_model(torch, cfg)
    trainer = Trainer(model, loader, None,
                      {'lr': TRAIN_LR, 'start_qm_epochs': 0,
                       'warmup_steps': 2, 'patience': 0},
                      {'max_epochs': 1}, out_dir=None, mesh=mesh)
    (_, ms), counts = counted(torch, lambda: cuda_ms(torch,
                                                     trainer.train_epoch))
    tally(counts)
    sums = torch.stack([p.detach().double().sum()
                        for p in model.parameters()]).float()
    allsums = mesh.all_gather(sums[None])
    res['trainer'] = dict(losses=trainer.train_losses[0],
                          steps=trainer.global_step, epoch_ms=ms,
                          counts=counts,
                          ranks_equal=bool((allsums == allsums[0]).all()))
    del model, trainer, loader
    torch.cuda.empty_cache()

    # the atom-sharded forward and train step: 12,000 atoms x 4 conformers
    mdata = make_moldata(seed=0, n_confs=FUSION_CONFS, n_atoms=SP_ATOMS)
    graph = MolGraph.from_moldata(mdata)
    whole = collate([graph], pad=sp.atom_sharded_pad_spec(
        [graph], FUSION_CONFS, mesh), device='cuda')
    sharded = sp.shard_batch_by_atoms(whole, mesh)
    # the rank's rows K1 and each writer's K2 (S, T) take
    res['shapes'] = dict(nodes=int(sharded.node_mask.shape[0]), tuples={
        t: tuple(int(x) for x in sharded.terms[t].idxs.shape[::-1])
        for t in ('n2', 'n3', 'n4', 'n4_improper')})
    model = parallel_model(torch, cfg)
    fwd = sp.make_atom_sharded_forward(model, mesh)
    torch.cuda.reset_peak_memory_stats()
    dp.COLLECTIVE_DTYPES.clear()
    ((energy, grad), ms), counts, rows = counted_rows(torch, lambda: cuda_ms(
        torch, lambda: fwd(sharded)))
    tally(counts)
    res['sp_forward'] = dict(ms=ms, counts=counts, rows=rows,
                             collectives=collectives(),
                             warm_ms=cuda_ms(torch, lambda: fwd(sharded))[1])
    grad_all = mesh.all_gather(grad)
    sp_model = parallel_model(torch, cfg)
    sp_opt = CaptureAdam(make_optimizer())
    sp_step = sp.make_atom_sharded_train_step(sp_model, sp_opt, mesh)
    wts = loss_weights(torch, 1, 'cuda')
    ((sp_loss, _), ms), counts, rows = counted_rows(torch, lambda: cuda_ms(
        torch, lambda: sp_step(sharded, wts, TRAIN_LR,
                               torch.Generator().manual_seed(PAR_SEED))))
    tally(counts)
    res['sp_step'] = dict(ms=ms, counts=counts, rows=rows,
                          loss=float(sp_loss), peak_gib=gib(),
                          collectives=collectives())
    # the sharded gradients of the first step's loss in float64, the
    # ranks' mean
    loss64_sh, grads64_sh = float64_loss_gradients(torch, cfg, sharded, wts)
    grads64_sh = dp.mean_over_ranks(grads64_sh, mesh)
    if rank == 0:
        # the unsharded path on the same card, the other rank waiting
        e_ref, g_ref = make_eval_step(model)(whole)
        ref_model = parallel_model(torch, cfg)
        ref_loss, _ = make_train_step(ref_model, make_optimizer())(
            whole, wts, TRAIN_LR, torch.Generator().manual_seed(PAR_SEED))
        loss64, grads64 = float64_loss_gradients(torch, cfg, whole, wts)
        names = [n for n, _ in sp_model.named_parameters()]
        rl2 = lambda a, b: float((a.double() - b.double()).norm()) / max(
            float(b.double().norm()), 1e-30)
        rel = [rl2(a, b) for a, b in zip(grads64_sh, grads64)]
        worst = int(np.argmax(rel))
        if spread:
            _, grads_ulp = float64_loss_gradients(torch, cfg, whole, wts,
                                                  ulp=True)
            spread_rel = [rl2(a, b) for a, b in zip(grads_ulp, grads64)]
            res['spread'] = dict(rl2_median=float(np.median(spread_rel)),
                                 rl2_min=min(spread_rel))
        p_ok, p_err = params_close(sp_model, ref_model, SP_PARAM_TOL,
                                   SP_PARAM_TOL)
        res['sp_ref'] = dict(
            energy_ok=bool(((energy - e_ref).abs() <= SP_E_TOL
                            + SP_E_TOL * e_ref.abs()).all()),
            energy_err=float((energy - e_ref).abs().max()),
            grad_ok=bool(((grad_all - g_ref).abs() <= SP_G_TOL
                          + SP_G_TOL * g_ref.abs()).all()),
            grad_err=float((grad_all - g_ref).abs().max()),
            loss=float(ref_loss), loss64=loss64, loss64_sh=loss64_sh,
            grad_n=len(names),
            grad_over=sum(r > STEP_GRAD_RL2 for r in rel),
            grad_rl2_max=max(rel), grad_rl2_median=float(np.median(rel)),
            worst=names[worst],
            params_ok=p_ok, params_err=p_err)
        del ref_model
    mesh.barrier()
    del model, sp_model, sp_opt, sp_step
    torch.cuda.empty_cache()

    # 13(f): the atom-sharded MM energy through K5 / K5b and without
    params = ref_params(torch, sharded)
    call = lambda fused: mm_energy.energy_and_gradient(
        sharded, params, use_fused_torsion=fused)
    (fused, ms_f), k5 = k5_launches(torch, lambda: cuda_ms(
        torch, lambda: call(True)))
    (plain, ms_p), k5_plain = k5_launches(torch, lambda: cuda_ms(
        torch, lambda: call(False)))
    for name, n in zip(('torsion_energy_fused', 'torsion_energy_grad'), k5):
        res['launches'][name] = res['launches'].get(name, 0) + n
    g_f, g_p = mesh.all_gather(fused[1]), mesh.all_gather(plain[1])
    e_f, e_p = fused[0], plain[0]
    res['k5'] = dict(
        launches=k5, plain_launches=k5_plain, first_ms=ms_f,
        first_plain_ms=ms_p,
        fused_ms=timed(torch, lambda: call(True), iters=10),
        plain_ms=timed(torch, lambda: call(False), iters=10),
        energy_ok=bool(torch.isfinite(e_f).all() and (
            (e_f - e_p).abs() <= MODEL_ATOL + MODEL_RTOL * e_p.abs()).all()),
        energy_err=float((e_f - e_p).abs().max()),
        grad_rel=max_rel(g_f, g_p), grad_finite=bool(
            torch.isfinite(g_f).all()))
    if rank == 0:
        e_u, g_u = mm_energy.energy_and_gradient(
            whole, ref_params(torch, whole), use_fused_torsion=True)
        res['k5'].update(
            unsharded_energy_ok=bool(((e_f - e_u).abs() <= SP_E_TOL
                                      + SP_E_TOL * e_u.abs()).all()),
            unsharded_energy_err=float((e_f - e_u).abs().max()),
            unsharded_grad_ok=bool(((g_f - g_u).abs() <= SP_G_TOL
                                    + SP_G_TOL * g_u.abs()).all()),
            unsharded_grad_err=float((g_f - g_u).abs().max()))
    mesh.barrier()
    res['peak_gib'] = gib()
    with open(os.path.join(work, f'bf16_rank{rank}.json'), 'w') as f:
        json.dump(res, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def offset_kernel_checks_bf16(torch, shapes):
    """13(e): K1 / K1b and K2 / K2b in bf16 mode through their `_rows`
    builds at every shape the sharded step gives them, on every rank's
    rows: K1 at a rank's nodes (shapes['nodes'], N of PAR_RANKS x N), K2
    at each writer's tuples (shapes['tuples'][term] = (S, T), T of
    PAR_RANKS x T), dropout on, against their plain bf16 versions on the
    unsharded masks' rows, under phase 10(a) / 10(c)(a)'s rule. At rank
    1's nodes and n4 tuples the unsharded bf16 kernel's time at the same
    rows stands beside each. Returns {name: (rows ms, unsharded ms)}."""
    from grappa_tpu_torch.ops import fused_block as fb
    from grappa_tpu_torch.ops import fused_gnn as fg
    bf16, world = torch.bfloat16, PAR_RANKS
    gen = torch.Generator().manual_seed(78)
    dy_gen = torch.Generator(device='cuda').manual_seed(78)
    f, heads, hid, hid2, d = 512, 16, 2048, 512, 8
    on = lambda ts, a: tuple(x.to(a.device) for x in ts)
    cases = [(fg, 'nodes', (shapes['nodes'], f), 0.3, 17)] + [
        (fb, term, (s, t, f), 0.5, 101)
        for term, (s, t) in shapes['tuples'].items()]
    times = {}
    for op, term, shape, rate, seed in cases:
        n = shape[-2]
        full = op.dropout_masks(seed, (*shape[:-2], world * n, f), rate,
                                device='cuda')
        if op is fg:
            mask = (torch.rand((d, n), generator=gen) < 0.8).float()
            mask[0] = 1.0
            mask = mask.cuda()
            p = rand_params(torch, gen, [
                ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
                ((hid, f), 'w'), ((hid,), 'b'), ((f, hid), 'w'),
                ((f,), 'b')])
            inputs = [torch.randn((n, f), generator=gen).cuda(),
                      torch.randn((d, n, f), generator=gen).cuda(),
                      torch.randn((n, f), generator=gen).cuda(), *p]
            kernel = lambda dt, r: lambda a, b, c, *q: (
                fg.fused_gnn_block(a, b, c, mask, q, heads, rate, True,
                                   seed, mm_dtype=dt, rows=r))
            plain = lambda dt, ms: lambda a, b, c, *q: (
                fg.reference_gnn_block(a, b, c, mask.to(a.device), q, heads,
                                       on(ms, a), dt))
            name = 'fused_gnn_block'
            fwd = 2 * n * (f * f + 2 * f * hid) + 4 * float(mask.sum()) * f
            inb = (2 + d) * n * f + d * n + sum(q.numel() for q in p)
            io = (fwd, 4 * (inb + n * f)), (2 * fwd, 4 * (2 * inb - d * n
                                                           + n * f))
        else:
            p = rand_params(torch, gen, [
                ((f,), 'g'), ((f,), 'b'), ((3 * f, f), 'w'), ((3 * f,), 'b'),
                ((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
                ((hid2, f), 'w'), ((hid2,), 'b'), ((f, hid2), 'w'),
                ((f,), 'b')])
            inputs = [torch.randn(shape, generator=gen).cuda(), *p]
            kernel = lambda dt, r: lambda a, *q: (
                fb.fused_transformer_block(a, q, 8, rate, True, seed,
                                           mm_dtype=dt, rows=r))
            plain = lambda dt, ms: lambda a, *q: fb.reference_block(
                a, q, 8, on(ms, a), dt)
            name = 'fused_transformer_block'
            rs = shape[0] * n
            fwd = 2 * rs * (4 * f * f + 2 * f * hid2) + 4 * n * 16 * f
            inb = rs * f + sum(q.numel() for q in p)
            io = (fwd, 4 * (inb + rs * f)), (2 * fwd, 4 * (2 * inb + rs * f))
        dy = torch.randn(inputs[0].shape, generator=dy_gen, device='cuda')
        for rank in range(world):
            first = rank * n
            rows = (first, world * n)
            masks = tuple(m[..., first:first + n, :].contiguous()
                          for m in full)
            label = (f'{term}, rank {rank}: rows {first}..{first + n - 1} '
                     f'of {world * n}{"" if op is fg else f", S {shape[0]}"}'
                     f', dropout {rate}, the `_rows` build')
            compare_bf16(torch, {}, name, label,
                         lambda dt: kernel(dt, rows)(*inputs),
                         lambda dt: plain(dt, masks)(*inputs), *io[0],
                         on_path=False)
            compare_grad_bf16(torch, {}, dict(
                name=name, label=label, inputs=inputs, dy=dy,
                kernel=lambda dt, r=rows: kernel(dt, r),
                plain=lambda dt, ms=masks: plain(dt, ms), bwd=io[1]))
            if rank != 1 or term not in ('nodes', 'n4'):
                continue

            def bwd_ms(r):
                leaves = [x.detach().clone().requires_grad_(True)
                          for x in inputs]
                y = kernel(bf16, r)(*leaves)
                return timed(torch, lambda: torch.autograd.grad(
                    y, leaves, dy, retain_graph=True), iters=5)
            times[f'{name}.bf16'] = (
                timed(torch, lambda: kernel(bf16, rows)(*inputs)),
                timed(torch, lambda: kernel(bf16, None)(*inputs)))
            times[f'{name}.bf16_bwd'] = (bwd_ms(rows), bwd_ms(None))
            (fr, fu), (br, bu) = (times[f'{name}.bf16'],
                                  times[f'{name}.bf16_bwd'])
            print(f'(e) {name} bf16 at {label}: forward {fr:.4f} ms '
                  f'through `_rows`, {fu:.4f} ms unsharded; backward '
                  f'{br:.4f} / {bu:.4f} ms', flush=True)
        del full
    return times


def parallel_bf16_phase(torch, smi, spread=False):
    """Phases 13(e) and 13(f) (PAR_BF16's comment); spread: with the
    unsharded bf16 step's one-ulp spread as a reading. Returns ({kernel
    name: launches on 13(e)'s paths}, {K5 / K5b: launches on 13(f)'s},
    the `parallel_bf16` line)."""
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from grappa_tpu_torch.models.grappa_model import get_default_model_config
    from grappa_tpu_torch.ops import philox
    from grappa_tpu_torch.parallel import dp
    from grappa_tpu_torch.train.trainer import (loss_gradients,
                                                make_optimizer,
                                                make_train_step)
    phase('13(e), (f). bf16 on the mesh; K5 on the atom-sharded energy')
    torch.cuda.empty_cache()
    cfg = dict(get_default_model_config(), **PAR_BF16)
    line = {'card': smi, 'compute_dtype': PAR_BF16['compute_dtype']}
    launches, k5_launches_all = {}, {}

    def tally(counts):
        for name, c in counts.items():
            for key, n in zip((name, f'{name}.bf16', f'{name}.backward',
                               f'{name}.bf16_bwd'), c):
                if n:
                    launches[key] = launches.get(key, 0) + n

    # (e) a mesh of one rank on NCCL: 3 bf16 DP steps = bf16
    # make_train_step's, bit for bit
    graphs = training_batches(torch)
    batch = dp_sub_batches(torch, graphs, 1, 0)
    w = loss_weights(torch, batch.num_mols, 'cuda')
    mesh = dp.make_mesh(1)
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        a, b = parallel_model(torch, cfg), parallel_model(torch, cfg)
        names = [n for n, _ in a.named_parameters()]
        sa = make_train_step(a, make_optimizer())
        sb = dp.make_dp_train_step(b, make_optimizer(), mesh)
        ga = torch.Generator().manual_seed(PAR_SEED)
        gb = torch.Generator().manual_seed(PAR_SEED)
        ms_a, ms_b, parted, total = [], [], None, {}
        for i in range(PAR_DP_STEPS):
            (la, _), t = cuda_ms(torch, lambda: sa(batch, w, TRAIN_LR, ga))
            ms_a.append(t)
            ((lb, _), t), counts = counted(torch, lambda: cuda_ms(
                torch, lambda: sb(batch, w, TRAIN_LR, gb)))
            ms_b.append(t)
            tally(counts)
            for k, c in counts.items():
                total[k] = tuple(x + y for x, y in zip(total.get(
                    k, (0, 0, 0, 0)), c))
            if parted is None:
                diff = [j for j, (p, q) in enumerate(zip(a.parameters(),
                                                         b.parameters()))
                        if not torch.equal(p, q)]
                if diff or not torch.equal(la, lb):
                    j = diff[0] if diff else 0
                    pa, pb = list(a.parameters())[j], list(b.parameters())[j]
                    parted = dict(step=i + 1, loss_equal=bool(
                        torch.equal(la, lb)), loss_diff=float(la - lb),
                        tensors=len(diff), first=names[j] if diff else None,
                        max_abs=float((pa - pb).abs().max()))
        flat = torch.cat([p.detach().reshape(-1) for p in b.parameters()])
        ar = [cuda_ms(torch, lambda: mesh.all_reduce_(flat))[1]
              for _ in range(3)]
        check(mesh.backend == 'nccl' and parted is None,
              f'(e) bf16, world size 1 on {mesh.backend}: {PAR_DP_STEPS} DP '
              f'steps at 128 x 32 with dropout equal bf16 make_train_step\'s '
              f'bit for bit (deterministic algorithms on); where they part: '
              f'{parted}')
        want = want_counts(True, True, PAR_DP_STEPS, PAR_DP_STEPS)
        check(total == want, f'(e) bf16 launches of the {PAR_DP_STEPS} DP '
                             f'steps {total} (want {want}: no float32 '
                             f'launch)')
        line['nccl_world_1'] = dict(
            step_ms=float(np.median(ms_b)),
            make_train_step_ms=float(np.median(ms_a)),
            all_reduce_ms=float(np.median(ar)),
            all_reduce_mb=flat.numel() * 4 / 1e6, parted=parted,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del a, b, sa, sb, flat
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # two gloo ranks sharing the card
    os.makedirs(os.path.join(ROOT, 'runs'), exist_ok=True)
    work = tempfile.mkdtemp(prefix='parallel_bf16_', dir=os.path.join(
        ROOT, 'runs'))
    t0 = time.time()
    try:
        ctx = mp.start_processes(parallel_bf16_rank,
                                 args=(PAR_RANKS, work, spread),
                                 nprocs=PAR_RANKS, join=False,
                                 start_method='spawn')
        deadline = time.time() + PAR_JOIN_S
        try:
            while not ctx.join(timeout=2):
                if time.time() > deadline:
                    raise TimeoutError(f'the ranks ran past {PAR_JOIN_S} s')
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = []
        for r in range(PAR_RANKS):
            with open(os.path.join(work, f'bf16_rank{r}.json')) as f:
                ranks.append(json.load(f))
        dp_out = torch.load(os.path.join(work, 'dp16.pt'),
                            weights_only=False)
    except Exception as exc:
        check(False, f'(e)-(f) the gloo ranks: {type(exc).__name__}: {exc}')
        shutil.rmtree(work, ignore_errors=True)
        return launches, k5_launches_all, line
    shutil.rmtree(work, ignore_errors=True)
    wall = time.time() - t0

    # (e) the DP step against one process's mean of the shares' bf16
    # gradients (the same dropout seeds, deterministic algorithms on)
    losses, grads = [], None
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for r in range(PAR_RANKS):
            model = parallel_model(torch, cfg)
            sub = dp_sub_batches(torch, graphs, PAR_RANKS, r)
            loss, _, g = loss_gradients(
                model, sub, loss_weights(torch, sub.num_mols, 'cuda'),
                philox.RankSeeds(torch.Generator().manual_seed(PAR_SEED), r,
                                 PAR_RANKS))
            losses.append(float(loss))
            g = [x.float() for x in g.values()]
            grads = g if grads is None else [x + y for x, y in zip(grads, g)]
            del model, sub
    finally:
        torch.use_deterministic_algorithms(False)
    want_loss = float(np.mean(losses))
    rel = [float((x.cuda() - y / PAR_RANKS).norm()
                 / max(float((y / PAR_RANKS).norm()), 1e-30))
           for x, y in zip(dp_out['grads'], grads)]
    loss_rel = abs(dp_out['loss'] - want_loss) / abs(want_loss)
    check(loss_rel <= STEP_LOSS_RTOL and max(rel) <= STEP_GRAD_RL2
          and all(r['dp']['ranks_equal'] for r in ranks),
          f'(e) bf16, {PAR_RANKS} gloo ranks on one card '
          f'({ranks[0]["backend"]}): the DP step on {PAR_RANKS} x '
          f'{TRAIN_MOLS // PAR_RANKS} x {TRAIN_CONFS} against one process\'s '
          f'mean of the shares\' bf16 gradients (same dropout seeds): loss '
          f'rel {loss_rel:.3e} (tol {STEP_LOSS_RTOL}), worst gradient '
          f'relative L2 {max(rel):.3e} (tol {STEP_GRAD_RL2}); every rank '
          f'the same mean and parameters '
          f'{all(r["dp"]["ranks_equal"] for r in ranks)}')
    rows0 = {'fused_gnn_block': [0, 0], 'fused_transformer_block': [0, 0]}
    for r in ranks:
        print(f'(e) rank {r["rank"]}: collectives by operand dtype: DP step '
              f'{r["dp"]["collectives"]}, sharded forward '
              f'{r["sp_forward"]["collectives"]}, sharded step '
              f'{r["sp_step"]["collectives"]}', flush=True)
        for key, nf, nb, rows_want in (
                ('dp', 1, 1, rows0), ('sp_forward', 1, 0, rows0),
                ('sp_step', 1, 1, {'fused_gnn_block': [7, 7],
                                   'fused_transformer_block': [12, 12]})):
            want = want_counts(True, True, nf, nb)
            got = {k: tuple(v) for k, v in r[key]['counts'].items()}
            check(got == want and r[key]['rows'] == rows_want,
                  f'(e) rank {r["rank"]}: launches of the bf16 {key} {got} '
                  f'(want {want}: no float32 launch), of the `_rows` builds '
                  f'(forward, backward) {r[key]["rows"]} (want {rows_want})')
        t = r['trainer']
        check(t['steps'] == 3 and all(np.isfinite(t['losses']))
              and t['ranks_equal']
              and {k: tuple(v) for k, v in t['counts'].items()}
              == want_counts(True, True, 3, 3),
              f'(e) rank {r["rank"]}: bf16 Trainer(mesh=...) epoch of 5 '
              f'batches: {t["steps"]} steps (the last a trailing group of '
              f'1), losses {t["losses"]}, parameters equal on every rank '
              f'{t["ranks_equal"]}, launches {t["counts"]}')
        for name, n in r['launches'].items():
            target = (k5_launches_all if name.startswith('torsion')
                      else launches)
            target[name] = target.get(name, 0) + n
    s = ranks[0]['sp_ref']
    check(s['energy_ok'] and s['grad_ok'],
          f'(e) bf16 atom-sharded forward, {SP_ATOMS} atoms x '
          f'{FUSION_CONFS} conformers over {PAR_RANKS} ranks, against the '
          f'unsharded bf16 forward: energy max err {s["energy_err"]:.3e} '
          f'(tol {SP_E_TOL} + {SP_E_TOL}|E|), dE/dx max err '
          f'{s["grad_err"]:.3e} (tol {SP_G_TOL} + {SP_G_TOL}|g|)')
    # the gate: the float64 loss of the sharded prediction (a float32
    # loss of a ~1e7 total resolves only ~1e-3 of it; the step's float32
    # losses are readings)
    sp_loss, l64, l64_sh = (ranks[0]['sp_step']['loss'], s['loss64'],
                            s['loss64_sh'])
    off_sp, off_ref = abs(sp_loss - l64), abs(s['loss'] - l64)
    off64 = abs(l64_sh - l64) / abs(l64)
    spread_note = ('' if 'spread' not in ranks[0] else
                   f'; reading: the unsharded step\'s own one-ulp spread, '
                   f'median relative L2 '
                   f'{ranks[0]["spread"]["rl2_median"]:.3e}')
    check(off64 <= SP_LOSS_RTOL and np.isfinite(sp_loss)
          and s['grad_over'] == 0 and s['params_ok'],
          f'(e) bf16 atom-sharded train step with dropout: the float64 loss '
          f'of the sharded prediction {l64_sh:.9e} against the unsharded '
          f'prediction\'s {l64:.9e}, rel {off64:.3e} (tol {SP_LOSS_RTOL}); '
          f'readings: the step\'s float32 loss {sp_loss:.6e}, rel '
          f'{off_sp / abs(l64):.3e} from the float64 loss, the unsharded '
          f'step\'s {s["loss"]:.6e}, rel {off_ref / abs(l64):.3e}; with the '
          f'loss in float64 on both sides, {s["grad_over"]} of the '
          f'{s["grad_n"]} all-reduced gradients past relative L2 '
          f'{STEP_GRAD_RL2} against the unsharded (tol 0; max '
          f'{s["grad_rl2_max"]:.3e} at {s["worst"]}, median '
          f'{s["grad_rl2_median"]:.3e}{spread_note}); parameters max |diff| '
          f'{s["params_err"]:.3e} (tol {SP_PARAM_TOL} + {SP_PARAM_TOL}|p|)')
    kernel_times = offset_kernel_checks_bf16(torch, ranks[0]['shapes'])

    # (f) K5 / K5b on the atom-sharded energy
    for r in ranks:
        k = r['k5']
        check(k['energy_ok'] and k['grad_finite']
              and k['grad_rel'] <= FORCE_RTOL and tuple(k['launches'])
              == (2, 2) and tuple(k['plain_launches']) == (0, 0),
              f'(f) rank {r["rank"]}: sharded energy + dE/dx, {SP_ATOMS} '
              f'atoms over {PAR_RANKS} ranks, reference parameters, with K5 '
              f'against without: energy max err {k["energy_err"]:.3e} (tol '
              f'{MODEL_ATOL} + {MODEL_RTOL}|E|), dE/dx max|err|/max '
              f'{k["grad_rel"]:.3e} (tol {FORCE_RTOL}); K5 / K5b launches '
              f'{k["launches"]} (want 2 / 2), without {k["plain_launches"]}')
    k = ranks[0]['k5']
    check(k['unsharded_energy_ok'] and k['unsharded_grad_ok'],
          f'(f) sharded energy with K5 against the unsharded with K5: '
          f'energy max err {k["unsharded_energy_err"]:.3e} (tol {SP_E_TOL} + '
          f'{SP_E_TOL}|E|), dE/dx max err {k["unsharded_grad_err"]:.3e} '
          f'(tol {SP_G_TOL} + {SP_G_TOL}|g|)')

    line['gloo_two_ranks_one_card'] = dict(
        note=f'{PAR_RANKS} processes sharing one card over gloo: the '
             f'collectives go through host memory; no multi-card speed',
        wall_s=wall, dp_loss_rel=loss_rel, dp_grad_rel_l2=max(rel),
        sp=dict(atoms=SP_ATOMS, energy_err=s['energy_err'],
                grad_err=s['grad_err'],
                loss64_sharded_rel=off64,
                loss_off64_sharded=off_sp / abs(l64),
                loss_off64_unsharded=off_ref / abs(l64),
                grad64_rel_l2_max=s['grad_rl2_max'],
                grad64_rel_l2_median=s['grad_rl2_median'],
                grad64_over=s['grad_over'],
                spread=ranks[0].get('spread'),
                params_err=s['params_err']),
        rows_kernels_ms=kernel_times,
        ranks=[dict(
            rank=r['rank'], dp_step_ms=r['dp']['step_ms'],
            dp_step_ms_all=r['dp']['step_ms_all'],
            dp_first_step_ms=r['dp']['first_ms'],
            all_reduce_ms=r['dp']['all_reduce_ms'],
            all_reduce_mb=r['dp']['all_reduce_mb'],
            dp_peak_gib=r['dp']['peak_gib'],
            trainer_epoch_ms=r['trainer']['epoch_ms'],
            sp_forward_ms=r['sp_forward']['ms'],
            sp_forward_warm_ms=r['sp_forward']['warm_ms'],
            sp_step_ms=r['sp_step']['ms'],
            sp_step_peak_gib=r['sp_step']['peak_gib'],
            k5_sharded_ms=r['k5']['fused_ms'],
            plain_sharded_ms=r['k5']['plain_ms'],
            peak_gib=r['peak_gib']) for r in ranks])
    return launches, k5_launches_all, line


def recipe_tags():
    """Every dataset tag the grappa-1.2.1 and grappa-1.0 recipes name, in
    the order of their yamls, with each recipe's config (dry run)."""
    from grappa_tpu_torch.production import run_production
    configs = {v: run_production(os.path.join(ROOT, d), v, argv=[],
                                 v1_0=v == 'grappa-1.0', dry_run=True)
               for v, d in RECIPE_DIRS.items()}
    tags = []
    for config in configs.values():
        dcfg = config['data_config']
        for tag in (dcfg['datasets'] + dcfg['pure_train_datasets']
                    + dcfg['pure_test_datasets']):
            if tag not in tags:
                tags.append(tag)
    return tags, configs


def recipe_data(cache, tags, n_mols, n_confs):
    """Stand-ins under every tag in `cache`/datasets (make_dataset, random
    classical parameters: 6-wide proper ks, as the published datasets'),
    and an espaloma_split tag over the first RECIPE_SPLIT_TAGS tags'
    molecules only (0.8 / 0.1 / 0.1), so that the split's extension runs.
    Returns {tag: mol ids} and the stored split."""
    from grappa_tpu_torch.data.dataset import Dataset
    from grappa_tpu_torch.data.synthetic import make_dataset
    ids = {}
    for i, tag in enumerate(tags):
        ds = Dataset.from_moldata(make_dataset(
            n_mols=n_mols, n_confs=n_confs, seed=500 + i,
            atom_range=TRAINRUN_ATOMS), tag)
        ds.save(os.path.join(cache, 'datasets', tag))
        ids[tag] = ds.mol_ids
    covered = [i for tag in tags[:RECIPE_SPLIT_TAGS] for i in ids[tag]]
    n_tr, n_vl = int(0.8 * len(covered)), int(0.1 * len(covered))
    stored = {'train': covered[:n_tr], 'val': covered[n_tr:n_tr + n_vl],
              'test': covered[n_tr + n_vl:]}
    split_dir = os.path.join(cache, 'datasets', 'espaloma_split')
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, 'split.json'), 'w') as f:
        json.dump(stored, f)
    return ids, stored


def recipe_cuts(epochs, cut_param_loss=True, dropout=True):
    """The phase's cuts of a published recipe, as run_production's
    overrides."""
    cuts = {'data_config': {'val_conf_strategy': RECIPE_VAL_CONFS},
            'trainer_config': {'max_epochs': epochs}}
    if cut_param_loss:
        cuts['lit_model_config'] = {
            'param_loss_epochs': RECIPE_PARAM_LOSS_EPOCHS}
    if not dropout:
        cuts['model_config'] = no_dropout({})
    return cuts


@contextlib.contextmanager
def recipe_env(cache):
    """GRAPPA_TPU_CACHE pointed at the stand-ins, and the zoo's download
    raising (every tag is in the cache; nothing may reach the network)."""
    from grappa_tpu_torch import zoo
    saved = os.environ.get('GRAPPA_TPU_CACHE'), zoo._download

    def no_download(url, target):
        raise RuntimeError(f'phase 14 downloads nothing: {url}')

    os.environ['GRAPPA_TPU_CACHE'] = cache
    zoo._download = no_download
    try:
        yield
    finally:
        if saved[0] is None:
            os.environ.pop('GRAPPA_TPU_CACHE', None)
        else:
            os.environ['GRAPPA_TPU_CACHE'] = saved[0]
        zoo._download = saved[1]


def recipe_counters():
    from grappa_tpu_torch.ops.fused_block import fused_transformer_block
    from grappa_tpu_torch.ops.fused_gnn import fused_gnn_block
    from grappa_tpu_torch.ops.fused_symmetriser import fused_symmetriser
    return fused_gnn_block, fused_transformer_block, fused_symmetriser


def recipe_run(torch, version, argv, overrides, device=None, record=None):
    """run_production of `version` with `argv` and `overrides`, the
    kernels' counts zeroed just before and read just after. record: a
    list that gets (epoch, energy, gradient, sorted parameter weights) of
    every _loss_weights call, and the weights when fit starts. Returns
    (do_trainrun's output, {kernel: (forward, backward)}, wall s, peak
    GiB)."""
    from grappa_tpu_torch.production import run_production
    from grappa_tpu_torch.train.trainer import Trainer
    counters = recipe_counters()
    keep_w, keep_fit = Trainer._loss_weights, Trainer.fit
    if record is not None:
        def loss_weights_(self, ds_names, num_mols):
            w = keep_w(self, ds_names, num_mols)
            record.append((self.epoch, w.energy, w.gradient,
                           tuple(sorted(set(w.param.cpu().tolist())))))
            return w

        def fit_(self, *args, **kwargs):
            record.append(('fit', {k: v.detach().cpu().clone() for k, v in
                                   self.model.state_dict().items()}))
            return keep_fit(self, *args, **kwargs)
        Trainer._loss_weights, Trainer.fit = loss_weights_, fit_
    on_card = device != 'cpu'
    for c in counters:
        c.launches = c.bwd_launches = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = run_production(os.path.join(ROOT, RECIPE_DIRS[version]),
                             version, argv=argv, v1_0=version == 'grappa-1.0',
                             device=device, overrides=overrides)
    finally:
        Trainer._loss_weights, Trainer.fit = keep_w, keep_fit
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {c.__name__: (c.launches, c.bwd_launches) for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    return out, got, wall, peak


def recipe_launch_check(label, out, got, gnn_blocks, n_pure_test):
    """K1-K3 / K1b-K3b launched gnn_blocks / 12 / 4 times each forward
    (every train step, each epoch's validation batches, each test batch:
    split.json's test molecules and the n_pure_test of the pure test
    sets, one a batch) and each step's backward. Returns the test
    molecules."""
    from pathlib import Path
    trainer = out['trainer']
    n_test = n_pure_test + len(json.loads(
        (Path(out['run_dir']) / 'split.json').read_text())['test'])
    steps, n_val = trainer.global_step, len(trainer.val_loader or [])
    forwards = steps + trainer.epoch * n_val + n_test
    want = {'fused_gnn_block': (gnn_blocks * forwards, gnn_blocks * steps),
            'fused_transformer_block': (12 * forwards, 12 * steps),
            'fused_symmetriser': (4 * forwards, 4 * steps)}
    check(got == want and steps > 0,
          f'{label} launches (forward, backward) {got}: {steps} train steps'
          f' + {trainer.epoch} validations of {n_val} batch(es) + {n_test}'
          f' test batches = {forwards} forwards, {steps} backwards (want '
          f'{gnn_blocks} / 12 / 4 each)')
    losses = sum(trainer.train_losses, [])
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          f'{label} finite losses by epoch: ' + '; '.join(
              ', '.join(f'{x:.6e}' for x in e) for e in trainer.train_losses))
    return n_test


def recipe_reduced(epochs):
    """The `recipe` line's cuts of a published recipe."""
    return [
        f'stand-in data for the published tags: make_dataset, '
        f'{RECIPE_MOLS} molecules x {RECIPE_CONFS} conformers a tag, '
        f'{TRAINRUN_ATOMS[0]}-{TRAINRUN_ATOMS[1] - 1} atoms, random '
        f'classical parameters (6-wide proper ks); espaloma_split over the '
        f'first {RECIPE_SPLIT_TAGS} tags',
        f'{epochs} epochs, not max_epochs 10000',
        f'param_loss_epochs 100 -> {RECIPE_PARAM_LOSS_EPOCHS}',
        f'val_conf_strategy 500 -> {RECIPE_VAL_CONFS}']


def recipe_writer_free(torch, trainer, epochs=3):
    """Writer-free epochs of a fitted Trainer (train_epoch alone, host
    clock to the end of its loss fetch) after a warm one, then the device
    idle share of two epochs under torch.profiler. Returns (steps/s of
    each epoch, idle shares or None)."""
    trainer.train_epoch()
    rates = []
    for _ in range(epochs):
        steps, t0 = trainer.global_step, time.perf_counter()
        trainer.train_epoch()
        rates.append((trainer.global_step - steps)
                     / (time.perf_counter() - t0))
    runs = idle_share(torch, trainer.train_epoch, reps=2)
    return rates, None if runs is None else [round(r[2], 4) for r in runs]


def recipe_line(torch, version, out, got, peak, smi, reduced):
    """The `recipe` line's fields for a run, writer-free epochs included."""
    trainer = out['trainer']
    t = trainer.timings
    ms = lambda xs: [round(x * 1e3, 3) for x in xs]
    rates, idle = recipe_writer_free(torch, trainer)
    return {'version': version, 'card': smi, 'epochs': trainer.epoch,
            'train_steps': trainer.global_step,
            'train_molecules': len(trainer.train_loader.dataset),
            'writer_free_steps_per_s': float(np.median(rates)),
            'writer_free_steps_per_s_all': rates,
            'epoch_ms': ms(t['epoch_s']), 'val_ms': ms(t['val_s']),
            'test_eval_ms': round(out['test_eval_s'] * 1e3, 3),
            'peak_gib': round(peak, 3), 'epoch_idle_share': idle,
            'launches': got, 'reduced': reduced}


def recipe_split_check(label, out, configs, ids, stored):
    """split.json against the recipe's routing: every molecule of the
    training tags assigned, the stored split's assignments kept; the pure
    train tag's molecules in training alone, the pure test tags' in the
    test metrics alone."""
    from grappa_tpu_torch.train.export import load_model_dict
    from pathlib import Path
    dcfg = configs['data_config']
    trainer = out['trainer']
    split = json.loads((Path(out['run_dir']) / 'split.json').read_text())
    parts = {k: set(v) for k, v in split.items()}
    in_tags = {i for tag in dcfg['datasets'] for i in ids[tag]}
    kept = all(set(stored[k]) <= parts[k] for k in stored)
    train = set(trainer.train_loader.dataset.mol_ids)
    val = set(trainer.val_loader.dataset.mol_ids)
    pure_train = {i for tag in dcfg['pure_train_datasets'] for i in ids[tag]}
    pure_test = {i for tag in dcfg['pure_test_datasets'] for i in ids[tag]}
    tested = set(load_model_dict(out['model_dict_path'])['results']['test'])
    check(in_tags == parts['train'] | parts['val'] | parts['test'] and kept
          and pure_train <= train and not pure_train & (val | parts['test'])
          and not pure_test & (train | val | set().union(*parts.values()))
          and set(dcfg['pure_test_datasets']) <= tested
          and not set(dcfg['pure_train_datasets']) & tested,
          f'{label} split.json: {len(in_tags)} molecules of '
          f'{len(dcfg["datasets"])} training tags, assigned '
          f'{len(parts["train"])} / {len(parts["val"])} / '
          f'{len(parts["test"])} (every one: '
          f'{in_tags == parts["train"] | parts["val"] | parts["test"]}), '
          f'the stored split\'s {sum(map(len, stored.values()))} kept: '
          f'{kept}; pure train {dcfg["pure_train_datasets"]} in training '
          f'only: {pure_train <= train and not pure_train & (val | parts["test"])}'
          f'; test metrics by tag {sorted(tested)}')


def recipe_phase(torch, work, smi, entries):
    """Phase 14. Returns the launches by path and the `recipe` lines."""
    import copy
    from pathlib import Path
    from grappa_tpu_torch import Grappa
    from grappa_tpu_torch.data.synthetic import random_molecule
    from grappa_tpu_torch.models.grappa_model import make_model
    from grappa_tpu_torch.train.config import read_yaml
    from grappa_tpu_torch.train.export import load_model_dict, model_from_dict
    from grappa_tpu_torch.train.loss import LossWeights
    from grappa_tpu_torch.train.run import get_dataloaders, resume_trainrun
    from grappa_tpu_torch.train.trainer import loss_gradients

    phase('14. the published recipes (grappa_tpu_torch.production) at the '
          'published width, stand-in data under the recipes\' tags')
    t0 = time.time()
    tags, configs = recipe_tags()
    root = os.path.join(work, 'recipes')
    cache = os.path.join(root, 'cache')
    ids, stored = recipe_data(cache, tags, RECIPE_MOLS, RECIPE_CONFS)
    cpu_cache = os.path.join(root, 'cpu_cache')
    recipe_data(cpu_cache, tags, RECIPE_CPU_MOLS, RECIPE_CPU_CONFS)
    print(f'stand-ins under {len(tags)} tags made and saved in '
          f'{time.time() - t0:.1f} s; cuts: '
          + '; '.join(recipe_reduced(RECIPE_EPOCHS))
          + f' (grappa-1.0: {RECIPE_V10_EPOCHS} epochs)', flush=True)
    n_pure_test = {v: sum(len(ids[t]) for t in
                          c['data_config']['pure_test_datasets'])
                   for v, c in configs.items()}
    launches, lines = {}, {}

    def note(path, got):
        for name, (nf, nb) in got.items():
            launches.setdefault(name, {})[path] = nf
            launches.setdefault(f'{name}.backward', {})[path] = nb

    v121, v10 = 'grappa-1.2.1', 'grappa-1.0'
    # the loss weights as LossWeights holds them (float32 values)
    f32 = lambda x: float(np.float32(x))
    qm = (1.0, f32(0.8))
    with recipe_env(cache):
        # (a) grappa-1.2.1: param-only epochs 0-1, QM epoch 2, epoch 3 with
        # the parameter weight off
        cfg121 = configs[v121]
        record = []
        out, got, wall, peak = recipe_run(
            torch, v121, ['--project', os.path.join(root, 'a')],
            recipe_cuts(RECIPE_EPOCHS), record=record)
        trainer, run_dir = out['trainer'], Path(out['run_dir'])
        note('recipe_1.2.1', got)
        print(f'(a) {v121}: {wall:.1f} s, {trainer.global_step} steps, '
              f'{len(trainer.train_loader.dataset)} train / '
              f'{len(trainer.val_loader.dataset)} validation molecules',
              flush=True)
        n_test = recipe_launch_check(f'(a) {v121}', out, got, 7,
                                     n_pure_test[v121])
        print(f'(a) {n_test} test molecules', flush=True)
        lit = cfg121['lit_model_config']
        want = {e: (0.0, 0.0, (f32(1e-3),)) if e < lit['start_qm_epochs']
                else qm + (((f32(lit['param_weight']),)
                            if e < RECIPE_PARAM_LOSS_EPOCHS else (0.0,)),)
                for e in range(RECIPE_EPOCHS)}
        seen = {}
        for epoch, energy, gradient, params in record[1:]:
            seen.setdefault(epoch, set()).add((energy, gradient, params))
        check(trainer.restarts == [lit['start_qm_epochs'],
                                   RECIPE_PARAM_LOSS_EPOCHS]
              and all(seen.get(e) == {w} for e, w in want.items())
              and set(seen) == set(want),
              f'(a) loss weights by epoch (energy, gradient, parameter): '
              f'{ {e: sorted(v) for e, v in seen.items()} } (want {want}); '
              f'restarts {trainer.restarts}')
        recipe_split_check('(a)', out, cfg121, ids, stored)
        md = load_model_dict(out['model_dict_path'])
        ff = Grappa.from_model_dict(md)
        mols = [random_molecule(seed=s) for s in range(4)]
        pred = stack(ff.predict_many(mols, check_eq_values=False))
        check(pred['proper_ks'].shape[1] == 3
              and all(np.isfinite(v).all() for v in pred.values()),
              f'(a) model.npz loads; its proper ks {pred["proper_ks"].shape}'
              f' (width 3), finite')
        del ff
        # the kernels at the run's train and test batches' shapes
        train_l, _, test_l, _ = get_dataloaders(
            copy.deepcopy(cfg121['data_config']), device='cuda')
        shapes = {'recipe train': next(iter(train_l))[0],
                  'recipe test': next(iter(test_l))[0]}
        for label, b in shapes.items():
            print(f'{label} batch, padded: N=%d, molecules %d, conformers %d'
                  % (b.xyz.shape[0], b.num_mols, b.xyz.shape[1]), flush=True)
        for name, label, kernel, plain, flops, nbytes, on_path in \
                kernel_cases(torch, shapes, n4_out=6):
            if on_path:
                compare_out(torch, entries, name, label, lambda: kernel(None),
                            lambda: plain(None), flops=flops, nbytes=nbytes)
        for c in training_cases(torch, {'recipe train':
                                        shapes['recipe train']}, n4_out=6):
            compare_grad(torch, entries, c['name'] + '.backward', c['label'],
                         c['kernel'](None), c['plain'](None), c['inputs'],
                         c['dy'], flops=c['bwd'][0], nbytes=c['bwd'][1])
        del train_l, test_l, shapes
        lines[v121] = recipe_line(torch, v121, out, got, peak, smi,
                                  recipe_reduced(RECIPE_EPOCHS))
        t1 = time.perf_counter()
        resumed = resume_trainrun(str(run_dir), extra_epochs=1)
        rt = resumed['trainer']
        check(rt.epoch == RECIPE_EPOCHS + 1
              and bool(np.isfinite(rt.train_losses[-1]).all()),
              f'(a) resume_trainrun(extra_epochs=1) ends at epoch {rt.epoch}'
              f' (want {RECIPE_EPOCHS + 1}) in {time.perf_counter() - t1:.1f}'
              f' s; its losses '
              f'{", ".join(f"{x:.6e}" for x in rt.train_losses[-1])}')
        del out, trainer, resumed, rt

        # (b) grappa-1.0: 2 convolution blocks + 5 attention blocks
        cfg10 = configs[v10]
        out, got, wall, peak = recipe_run(
            torch, v10, ['--project', os.path.join(root, 'b')],
            recipe_cuts(RECIPE_V10_EPOCHS))
        note('recipe_1.0', got)
        print(f'(b) {v10}: {wall:.1f} s, {out["trainer"].global_step} '
              f'steps', flush=True)
        recipe_launch_check(f'(b) {v10}', out, got, 5, n_pure_test[v10])
        mc10 = cfg10['model_config']
        model = out['trainer'].model
        batch = next(iter(out['trainer'].train_loader))[0]
        w = LossWeights(**dict(QM_WEIGHTS, param=torch.full(
            (batch.num_mols,), QM_WEIGHTS['param'], device='cuda')))
        _, _, grads = loss_gradients(model, batch, w,
                                     torch.Generator().manual_seed(3))
        conv = {k: float(g.abs().max()) for k, g in grads.items()
                if k.startswith('gnn.conv_blocks.')}
        check(len({k.split('.')[2] for k in conv}) == 2
              and all(v > 0 for v in conv.values()),
              f'(b) the 2 convolution blocks\' {len(conv)} tensors get '
              f'non-zero gradients (max |g| each: min '
              f'{min(conv.values()):.3e})')
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        card_model = make_model(mc10).cuda()
        card_model.load_state_dict(state)
        cpu_model = make_model(dict(mc10, fused_gnn=False,
                                    fused_heads=False))
        cpu_model.load_state_dict(state)
        mols = [random_molecule(seed=s) for s in range(32)]
        for c in recipe_counters():
            c.launches = 0
        card = stack(Grappa(card_model, {'model_config': mc10})
                     .predict_many(mols, check_eq_values=False))
        fwd = {c.__name__: c.launches for c in recipe_counters()}
        check(fwd == {'fused_gnn_block': 5, 'fused_transformer_block': 12,
                      'fused_symmetriser': 4}
              and card['proper_ks'].shape[1] == 6,
              f'(b) 32-molecule forward: launches {fwd} (5 / 12 / 4), '
              f'proper ks {card["proper_ks"].shape}')
        compare_outputs('(b) 32 molecules, card vs the CPU\'s eager modules,',
                        card, stack(Grappa(cpu_model, {'model_config': mc10},
                                           device='cpu').predict_many(
                            mols, check_eq_values=False)))
        step_card_vs_cpu(torch, '(b)', no_dropout(mc10),
                         training_batches(torch, 0, 8))
        lines[v10] = recipe_line(torch, v10, out, got, peak, smi,
                                 recipe_reduced(RECIPE_V10_EPOCHS))
        del out, model, card_model, cpu_model, grads

        # (c) the recipe flags, then a run from (a)'s model.npz
        flags = ['-p', '0.001', '--shrink_train', '0.5', '--n_periodicity',
                 '4', '--no_torsion_cutoff']
        out, got, _, _ = recipe_run(
            torch, v121, ['--project', os.path.join(root, 'c')] + flags,
            recipe_cuts(1))
        note('recipe_flags', got)
        stored_cfg = read_yaml(Path(out['run_dir']) / 'grappa_config.yaml')
        name = Path(out['run_dir']).name
        pw = stored_cfg['lit_model_config']['param_weights_by_dataset']
        amber = [t for t in cfg121['data_config']['datasets']
                 if 'amber99sbildn' in t]
        check(name == 'grappa-1.2.1_p-3_shrink50_n_p4_no_cutoff'
              and pw == {t: 0.001 for t in amber}
              and stored_cfg['model_config']['n_periodicity_proper'] == 4
              and stored_cfg['model_config']['torsion_cutoff'] == 0.0
              and stored_cfg['data_config']['tr_subsampling_factor'] == 0.5,
              f'(c) {" ".join(flags)}: run {name}, parameter weights '
              f'{pw}, periodicity '
              f'{stored_cfg["model_config"]["n_periodicity_proper"]}, cutoff'
              f' {stored_cfg["model_config"]["torsion_cutoff"]}')
        recipe_launch_check('(c) flags', out, got, 7, n_pure_test[v121])
        del out
        npz = os.path.join(root, 'a', v121, 'model.npz')
        record = []
        out, got, _, _ = recipe_run(
            torch, v121, ['--project', os.path.join(root, 'c'),
                          '--pretrain_path', npz],
            recipe_cuts(1, cut_param_loss=False), record=record)
        note('recipe_pretrain', got)
        first = record[0][1]
        want_sd = model_from_dict(load_model_dict(npz))[0].state_dict()
        same = [torch.equal(first[k], want_sd[k]) for k in want_sd]
        name = Path(out['run_dir']).name
        check(name == 'grappa-1.2.1_pretrain' and all(same)
              and set(first) == set(want_sd)
              and {r[1:] for r in record[1:]} == {qm + ((0.0,),)},
              f'(c) --pretrain_path: run {name}, first weights equal the '
              f'file\'s in {sum(same)} of {len(want_sd)} tensors; loss '
              f'weights {sorted({r[1:] for r in record[1:]})} (QM from '
              f'epoch 0, parameter weight 0)')
        recipe_launch_check('(c) pretrain', out, got, 7, n_pure_test[v121])
        del out

    # card against CPU: the 1.2.1 recipe on the small stand-ins, dropout off
    with recipe_env(cpu_cache):
        res = {}
        for dev in ('cuda', 'cpu'):
            out, _, wall, _ = recipe_run(
                torch, v121, ['--project', os.path.join(root, f'vs_{dev}')],
                recipe_cuts(RECIPE_CPU_EPOCHS, dropout=False), device=dev)
            tr = out['trainer']
            res[dev] = (sum(tr.train_losses, []),
                        [h['metrics'] for h in tr.history], wall)
            del out, tr
    (lg, mg, sg), (lc, mc, sc) = res['cuda'], res['cpu']
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    first = rel(lg[0], lc[0]) if lg and lc else float('inf')
    later = max((rel(a, b) for a, b in zip(lg[1:], lc[1:])), default=0.0)
    metric = max((rel(x[ds][k], y[ds][k]) for x, y in zip(mg, mc)
                  for ds in y for k in y[ds]), default=float('inf'))
    check(len(lg) == len(lc) > 1 and first <= STEP_LOSS_RTOL
          and later <= TRAINRUN_RTOL and metric <= TRAINRUN_RTOL
          and all(x.keys() == y.keys() for x, y in zip(mg, mc)),
          f'card vs CPU, {v121} on {RECIPE_CPU_MOLS} molecules x '
          f'{RECIPE_CPU_CONFS} conformers a tag, dropout off, '
          f'{RECIPE_CPU_EPOCHS} epochs, {len(lg)} steps: first loss '
          f'{lg[0]:.6e} vs {lc[0]:.6e} (rel {first:.2e}, tol '
          f'{STEP_LOSS_RTOL}); later losses worst rel {later:.2e}, '
          f'validation metrics worst rel {metric:.2e} (tol '
          f'{TRAINRUN_RTOL}); card {sg:.1f} s, CPU {sc:.1f} s')
    return launches, lines


def report_failures() -> int:
    """1 after naming each failed check on standard error (the tail a
    caller that keeps only the end of the output sees), else 0."""
    for what in FAILURES:
        print(f'FAIL {what[:400]}', file=sys.stderr)
    if FAILURES:
        print(f'chip_smoke.py: {len(FAILURES)} check(s) failed',
              file=sys.stderr)
    return 1 if FAILURES else 0


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, 'grappa_tpu_torch')):
        print('chip_smoke.py: run it from a checkout of the repository '
              '(grappa_tpu_torch/ not found)', file=sys.stderr)
        return 2
    kernels_only = sys.argv[1:] == ['--kernels-only']
    torsion_only = sys.argv[1:] == ['--torsion']
    trainrun_only = sys.argv[1:] == ['--trainrun']
    train_step_only = sys.argv[1:] == ['--train-step']
    eval_only = sys.argv[1:] == ['--eval']
    bf16_only = sys.argv[1:] == ['--bf16']
    gnn_calls_only = sys.argv[1:] == ['--gnn-calls']
    gmx_only = sys.argv[1:] == ['--gmx']
    data_only = sys.argv[1:] == ['--data']
    parallel_only = sys.argv[1:] == ['--parallel']
    parallel_bf16_only = sys.argv[1:] == ['--parallel-bf16']
    spread = sys.argv[1:] == ['--parallel-bf16', '--spread']
    parallel_bf16_only |= spread
    recipes_only = sys.argv[1:] == ['--recipes']
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
    # the bf16 model's Dense products outside the kernels sum in float32,
    # as on the CPU
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    if eval_only:
        import atexit
        import shutil
        from grappa_tpu_torch.models.grappa_model import (
            get_default_model_config)
        shutil.rmtree(work, ignore_errors=True)
        atexit.register(shutil.rmtree, work, True)
        cfg = get_default_model_config()
        _, eval_line, ingest_line = eval_phase(
            torch, work, cfg, smi, eval_data(torch, work, cfg))
        print('eval ' + json.dumps(eval_line), flush=True)
        print('ingest ' + json.dumps(ingest_line), flush=True)
        return 1 if FAILURES else 0
    if gmx_only:
        import atexit
        import shutil
        from grappa_tpu_torch.models.grappa_model import (
            get_default_model_config)
        shutil.rmtree(work, ignore_errors=True)
        atexit.register(shutil.rmtree, work, True)
        cfg = get_default_model_config()
        gmx_fix = gmx_data(torch, work, cfg)
        phase('2. kernels against their plain versions (phase 11\'s '
              'shapes)')
        entries = kernel_phase(torch, gmx_fix[3])
        _, gmx_line = gmx_phase(torch, cfg, work, smi, gmx_fix)
        print('kernel_times ' + json.dumps(entries), flush=True)
        print('gmx ' + json.dumps(gmx_line), flush=True)
        return 1 if FAILURES else 0
    if data_only:
        import atexit
        import shutil
        from grappa_tpu_torch.models.grappa_model import (
            get_default_model_config)
        shutil.rmtree(work, ignore_errors=True)
        atexit.register(shutil.rmtree, work, True)
        _, lines = data_phase(torch, get_default_model_config(), work, smi)
        for name, line in lines.items():
            print(f'{name} ' + json.dumps(line), flush=True)
        return report_failures()
    if parallel_only or parallel_bf16_only:
        if parallel_only:
            _, line = parallel_phase(torch, smi)
            print('parallel ' + json.dumps(line), flush=True)
        _, _, line = parallel_bf16_phase(torch, smi, spread)
        print('parallel_bf16 ' + json.dumps(line), flush=True)
        return report_failures()
    if recipes_only:
        import atexit
        import shutil
        shutil.rmtree(work, ignore_errors=True)
        atexit.register(shutil.rmtree, work, True)
        entries = {}
        _, lines = recipe_phase(torch, work, smi, entries)
        print('kernel_times ' + json.dumps(entries), flush=True)
        for line in lines.values():
            print('recipe ' + json.dumps(line), flush=True)
        return report_failures()
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
        batch = collate(graphs, bucketed_pad_spec(graphs, TRAIN_CONFS),
                        TRAIN_CONFS, device='cuda')
        phase('5. training steps, default config')
        training_phase(torch, graphs, batch, cfg)
        bf16_step_phase(torch, cfg, graphs, batch)
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
    if gnn_calls_only:
        graphs = training_batches(torch)
        train_batch = collate(graphs, bucketed_pad_spec(graphs, TRAIN_CONFS),
                              TRAIN_CONFS, device='cuda')
        gnn_calls(torch, gnn_call_nodes(torch, workloads, train_batch))
        block_profile(torch, train_batch)
        return 1 if FAILURES else 0
    # phase 9's eval and ingest batches
    eval_fix = eval_data(torch, work, cfg)
    workloads.update(eval_batches(torch))
    # phase 11's forwards (the GROMACS path)
    gmx_fix = gmx_data(torch, work, cfg)
    workloads.update(gmx_fix[3])
    if bf16_only:
        entries = {}
        bf16_kernel_phase(torch, workloads, entries)
        bf16_predict_phase(torch, cfg, smalls, protein, paths)
        graphs = training_batches(torch)
        _, line = bf16_training_phase(
            torch, cfg, graphs, collate(graphs, bucketed_pad_spec(
                graphs, TRAIN_CONFS), TRAIN_CONFS, device='cuda'),
            run_batches, work, data_dir, test_batches, entries)
        print('trainrun_bf16 ' + json.dumps(line), flush=True)
        print('bf16_kernel_times ' + json.dumps(entries), flush=True)
        return 1 if FAILURES else 0

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
        bf16_kernel_phase(torch, workloads, entries)
        bf16_training_kernel_phase(
            torch, {'train': train_batch,
                    'trainrun train': run_batches['train']}, entries)
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
    eval_launches, eval_line, ingest_line = eval_phase(
        torch, work, cfg, smi, eval_fix,
        run_dir=os.path.join(work, 'trainrun'))
    for path, counts in eval_launches.items():
        for name, n in counts.items():
            launches[name][path] = n
    bf16_kernel_phase(torch, workloads, entries)
    launches.update(bf16_predict_phase(torch, cfg, smalls, protein, paths))
    bf16_train, trainrun_bf16_line = bf16_training_phase(
        torch, cfg, graphs, train_batch, run_batches, work, data_dir,
        test_batches, entries, trainrun_line['steady_train_steps_per_s'])
    for name, per_path in bf16_train.items():
        launches.setdefault(name, {}).update(per_path)
    gmx_launches, gmx_line = gmx_phase(torch, cfg, work, smi, gmx_fix)
    for name, per_path in gmx_launches.items():
        launches[name].update(per_path)
    from grappa_tpu_torch.data.dataset import Dataset
    data_launches, data_lines = data_phase(
        torch, cfg, work, smi, Dataset.load(
            os.path.join(work, 'cache', 'datasets', EVAL_TAGS[0])),
        eval_fix[1])
    for name, per_path in data_launches.items():
        launches.setdefault(name, {}).update(per_path)
    par_launches, parallel_line = parallel_phase(torch, smi)
    for name, n in par_launches.items():
        launches.setdefault(name, {})['parallel'] = n
    bf16_par, k5_par, parallel_bf16_line = parallel_bf16_phase(torch, smi)
    for path, counts in (('parallel_bf16', bf16_par),
                         ('parallel_sharded_energy', k5_par)):
        for name, n in counts.items():
            launches.setdefault(name, {})[path] = n
    recipe_launches, recipe_lines = recipe_phase(torch, work, smi, entries)
    for name, per_path in recipe_launches.items():
        launches.setdefault(name, {}).update(per_path)

    if FAILURES:
        return report_failures()

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
        'torsion_energy_grad': ('torsion.cu', 'torsion_kernel.py:156'),
        # the bf16 mode of K1-K3 (mm_dtype=jnp.bfloat16: the same Pallas
        # call sites compiled for bf16 products)
        'fused_gnn_block.bf16': ('fused_gnn.cu', 'fused_gnn.py:271'),
        'fused_transformer_block.bf16': ('fused_block.cu',
                                         'fused_block.py:379'),
        'fused_symmetriser.bf16': ('fused_symmetriser.cu',
                                   'fused_symmetriser.py:174'),
        # the bf16 mode of K1b-K3b
        'fused_gnn_block.bf16_bwd': ('fused_gnn.cu', 'fused_gnn.py:323'),
        'fused_transformer_block.bf16_bwd': ('fused_block.cu',
                                             'fused_block.py:421'),
        'fused_symmetriser.bf16_bwd': ('fused_symmetriser.cu',
                                       'fused_symmetriser.py:199')}
    kernels = []
    for name, (source, replaces) in sources.items():
        e = entries[name]
        b_ms, b_by = bound(e['flops'], e['nbytes'], e['peak'])
        per_path = launches.get(name, {})
        kernels.append(dict(
            name=name, route='cuda', source=csrc + source,
            replaces=tpu + replaces,
            status=('bf16 mode on wgmma (wg_gemm.cuh)'
                    if name.endswith(('.bf16', '.bf16_bwd')) else 'ported'),
            launches=sum(per_path.values()), launches_per_path=per_path,
            max_abs_err=e['max_abs_err'], ms=e['ms'],
            plain_ms=e['plain_ms'], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, mbytes=e['nbytes'] / 1e6))
        if e['peak'] in (PEAK_FP32_FLOPS, PEAK_BF16_FLOPS):
            kernels[-1]['gflop'] = e['flops'] / 1e9
        else:
            kernels[-1]['g_sm_clocks'] = e['flops'] / 1e9
        for key in ('device_ms', 'f32_ms'):
            if key in e:
                kernels[-1][key] = e[key]
        if name in TENSOR_CORE_KERNELS:
            kernels[-1]['bound_tc_ms'] = bound(3 * e['flops'], e['nbytes'],
                                               PEAK_TF32_FLOPS)[0]
    print('trainrun ' + json.dumps(trainrun_line))
    print('trainrun_bf16 ' + json.dumps(trainrun_bf16_line))
    print('eval ' + json.dumps(eval_line))
    print('ingest ' + json.dumps(ingest_line))
    print('gmx ' + json.dumps(gmx_line))
    for name, line in data_lines.items():
        print(f'{name} ' + json.dumps(line))
    print('parallel ' + json.dumps(parallel_line))
    print('parallel_bf16 ' + json.dumps(parallel_bf16_line))
    for line in recipe_lines.values():
        print('recipe ' + json.dumps(line))
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
