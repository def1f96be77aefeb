"""Training: the optimizer, the train and eval steps, and the Trainer
(curriculum, LR schedule, evaluation, checkpoints).

Counterpart of `grappa_tpu.train.trainer` (reference: src/grappa/training/
lightning_model.py:13-314 and trainrun.py:24-175):
  * curriculum: epochs < start_qm_epochs train on classical parameters only
    (energy/gradient weights zero), then QM energy+force training
  * optimizer restarts at given epochs with linear LR warmup
  * plateau decay: `patience` epochs without improvement of
    early_stopping_loss (3*E_rmse_avg + F_rmse_avg by default) -> lr *= decay
  * optional param_loss_epochs switch-off, per-dataset parameter-loss weights
  * wall-clock time limit, finish criterion for unpromising runs
  * checkpoints: best (by early_stopping_loss) + last, with full config

The optimizer is the port's own copy of the JAX package's optax chain
    clip_by_global_norm(grad_clip) -> scale_by_adam() ->
    [add_decayed_weights(weight_decay)] -> scale(-1)
with the learning rate applied outside the chain, so a schedule changes
nothing in the optimizer. Two places where torch's stock pieces differ from
optax and are not used: `clip_grad_norm_` divides by norm + 1e-6 and scales
always, optax scales by max_norm / norm only when the norm exceeds
max_norm; and the Adam state here is optax's (count, mu, nu), with optax's
order of operations. It runs as multi-tensor `torch._foreach_*` ops over
all parameters. The step updates the model's parameters in place and keeps
the optimizer state in the optimizer (PyTorch runs eagerly; there is no
compiled step to donate buffers to), so every snapshot a checkpoint takes
is a device-side clone.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import zlib
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grappa_tpu_torch.data.graph_batch import GraphBatch
from grappa_tpu_torch.models import mm_energy
from grappa_tpu_torch.train.evaluator import (
    StreamingEvaluator, early_stopping_loss)
from grappa_tpu_torch.train.loss import LossWeights, molwise_loss


class AdamClip:
    """clip_by_global_norm -> scale_by_adam -> [add_decayed_weights] ->
    scale(-1), then x lr: the chain of the JAX package's make_optimizer.
    State: `count` and per-parameter `mu` / `nu`, keyed by parameter name
    (optax's ScaleByAdamState). b1, b2 and eps are optax's defaults, which
    the JAX package uses. Every update is a multi-tensor op over all
    parameters, and nothing in a step waits for the device."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, grad_clip: float = 10.0, weight_decay: float = 0.0):
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.reset()

    def reset(self) -> None:
        """optax's init: count 0, zero moments (made at the next step)."""
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: (g / |g|) * max_norm only where the
        global norm |g| reaches max_norm (no epsilon). The divisor and the
        factor are device-side (1 and 1 below max_norm, where g / 1 * 1 is
        g exactly), so the choice needs no sync."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.grad_clip
        one = torch.ones_like(norm)
        out = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(out, torch.where(keep, one,
                                             one * self.grad_clip))
        return out

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: List[torch.Tensor], lr) -> None:
        """Update `params` (name -> tensor) in place with their `grads`."""
        grads = self.clip(grads)
        if not self.mu:
            self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
            self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count += 1
        b1, b2 = self.b1, self.b2
        # 1 - decay**count in float32, as optax's bias correction
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** self.count)
        bc2 = float(one - np.float32(b2) ** self.count)
        # moments paired with the parameters by name, whatever the order of
        # a loaded state
        p = list(params.values())
        mu, nu = [self.mu[k] for k in params], [self.nu[k] for k in params]
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ weight_decay * p]
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(p, u)

    def state_dict(self) -> Dict:
        return {'count': self.count, 'mu': dict(self.mu),
                'nu': dict(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state['count'])
        self.mu, self.nu = dict(state['mu']), dict(state['nu'])


def make_optimizer(grad_clip: float = 10.0,
                   weight_decay: float = 0.0) -> AdamClip:
    """Adam with global-norm clipping; the step applies the learning rate."""
    return AdamClip(grad_clip, weight_decay)


def make_train_step(model: torch.nn.Module, optimizer: AdamClip
                    ) -> Callable:
    """Returns step(batch, weights, lr, generator) -> (loss, aux): one
    training step of `model` on `batch` in training mode, its dropout
    seeded from `generator` (a CPU torch.Generator, one seed per fused
    block), updating the model's parameters and the optimizer's state in
    place. loss and aux are detached tensors on the batch's device.
    A model with a bfloat16 compute dtype trains in bf16 (the fused ops'
    bf16 mode forward and backward, flax's bf16 Dense in the eager
    modules); its parameters, gradients and Adam state stay float32, and
    no loss scaling is applied (bf16 has float32's exponent range), as in
    the JAX package."""
    params = dict(model.named_parameters())

    def step(batch: GraphBatch, weights: LossWeights, lr,
             generator: torch.Generator
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss, aux, grads = loss_gradients(model, batch, weights, generator)
        optimizer.step(params, list(grads.values()), lr)
        return loss, aux

    return step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """Returns step(batch) -> (energy (M, C), gradient (N, C, 3)) of the
    model's predicted parameters in eval mode."""

    def step(batch: GraphBatch):
        model.eval()
        with torch.no_grad():
            pred = model(batch)
        return mm_energy.energy_and_gradient(batch, pred)

    return step


def loss_gradients(model: torch.nn.Module, batch: GraphBatch,
                   weights: LossWeights,
                   generator: Optional[torch.Generator] = None):
    """(loss, aux, {name: gradient}) of one training-mode forward, without
    an update: the gradient half of a train step (a parameter the loss does
    not reach gets zeros, as jax.grad gives). loss and aux are detached."""
    model.train()
    pred = model(batch, generator=generator)
    loss, aux = molwise_loss(batch, pred, weights)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            {n: (torch.zeros_like(p) if g is None else g)
             for n, p, g in zip(names, params, grads)})


def _map_tensors(tree, fn, memo: Optional[Dict] = None):
    """fn over every tensor of a nest of dicts (other leaves kept). Views
    of the same memory (the state_dict's reference-name aliases) map to one
    result, so a copy keeps the sharing and torch.save writes it once."""
    if memo is None:
        memo = {}
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn, memo) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    key = (tree.data_ptr(), tree.dtype, tuple(tree.shape), tree.stride())
    if key not in memo:
        memo[key] = fn(tree)
    return memo[key]


def _to_host(tree, ready: Optional['torch.cuda.Event'] = None):
    """Host copies of a nest of tensors. With `ready` (an event recorded
    after the device-side snapshot was taken) the copies run on a side
    stream that waits for it, so they never read a buffer before the
    snapshot's clone has written it and do not queue behind later steps."""
    if ready is None:
        return _map_tensors(tree, lambda t: t.detach().cpu())
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        out = _map_tensors(tree, lambda t: torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True))
    stream.synchronize()
    return out


class Trainer:
    """Fits `model` (its parameters on the device the loaders' batches go
    to) with the curriculum, restarts, plateau decay, time limits and
    checkpoints of the JAX package's Trainer.

    The Trainer's RNG is a CPU `torch.Generator` seeded from `seed`: it
    seeds the dropout of every step and the epoch permutations of the batch
    cache. The JAX package draws both from its jax.random key, which cannot
    be reproduced here, so with dropout or `cache_batches` the two packages
    see other masks and other batch orders by design; without them the
    batch order is the loaders' numpy draw, the same in both.

    scan_epochs: the JAX package's one-dispatch epoch over its batch cache.
    PyTorch runs every step eagerly, so here it is the cached loop with the
    scan's rules: it requires cache_batches and uniform batch shapes
    (fixed_pad), and validation runs on a fixed-pad copy of the val loader.
    None reads trainer_config['scan_epochs'] (default off).

    mesh: a `parallel.dp.Mesh` trains data-parallel, every rank running
    the same Trainer on its own device (the model's) with a GraphLoader of
    the same seed. Each optimizer step takes W loader batches: rank r
    takes batch i where i % W == r and the ranks' gradients are averaged
    (`parallel.dp.make_dp_train_step`). A trailing group of k < W batches
    is padded by cycling its batches (rank r >= k takes its batch
    (r - k) % k), the k real batches' loss weights scaled by W / k and
    the padding's zeroed, so the mean is the real batches' (the JAX
    package's rule). A rank collates only its own batches: the loader
    skips the others (`GraphLoader.select`), drawing its RNG as if it
    collated them, so every rank sees the order the JAX package's loader
    draws. With cache_batches a rank caches its own slots (one a group,
    its padding last), and each epoch shuffles its real slots with a seed
    drawn on every rank alike and the rank's index, so the groups change
    from epoch to epoch while the trailing group's scale stays by
    position; scan_epochs runs that cache as one
    `make_dp_scan_epoch_step`. Rank 0's parameters and Adam
    state are broadcast at the start. Rank 0 alone logs and writes
    checkpoints, and every host decision (plateau decay, early stop, the
    time limits) is rank 0's, broadcast; every rank validates, rank 0's
    metrics count."""

    def __init__(self, model: torch.nn.Module, train_loader, val_loader,
                 lit_config: Dict, trainer_config: Dict,
                 out_dir: Optional[str] = None,
                 full_config: Optional[Dict] = None,
                 log_fn: Optional[Callable[[Dict], None]] = None,
                 seed: int = 0,
                 cache_batches: bool = False,
                 scan_epochs: Optional[bool] = None,
                 mesh=None):
        self.model = model
        self.device = next(model.parameters()).device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.cfg = lit_config
        self.trainer_cfg = trainer_config
        self.mesh = mesh
        # only rank 0 of a mesh writes checkpoints and logs
        writer = mesh is None or mesh.rank == 0
        self.out_dir = Path(out_dir) if out_dir and writer else None
        self.full_config = full_config or {}
        self.log_fn = (log_fn if writer else None) or (lambda d: None)

        self.optimizer = make_optimizer(
            grad_clip=trainer_config.get('gradient_clip_val', 10.0),
            weight_decay=lit_config.get('weight_decay', 0.0))
        self.train_step = make_train_step(model, self.optimizer)
        self.eval_step = make_eval_step(model)
        if mesh is not None:
            from grappa_tpu_torch.parallel.dp import (
                make_dp_train_step, replicate)
            replicate(model, mesh, self.optimizer)
            self.dp_train_step = make_dp_train_step(model, self.optimizer,
                                                    mesh)

        self.lr = float(lit_config['lr'])
        self.start_qm_epochs = int(lit_config.get('start_qm_epochs', 1))
        self.restarts = sorted(set(
            [self.start_qm_epochs] + list(lit_config.get('add_restarts', []))))
        if lit_config.get('param_loss_epochs') is not None:
            self.restarts = sorted(set(
                self.restarts + [int(lit_config['param_loss_epochs'])]))
        self.warmup_steps = int(lit_config.get('warmup_steps', 200))
        self._warmup_step: Optional[int] = None

        # device-resident batch cache: one epoch of batches collated once,
        # reshuffled per epoch; conformer subsampling is frozen to the
        # cached draw. Only for datasets whose batches fit on the card.
        self.cache_batches = cache_batches
        self._batch_cache = None
        self._val_cache = None
        if scan_epochs is None:
            scan_epochs = bool(trainer_config.get('scan_epochs', False))
        if scan_epochs and not cache_batches:
            raise ValueError("scan_epochs requires cache_batches=True "
                             "(the scan consumes device-resident batches)")
        self.scan_epochs = scan_epochs
        self._dp_scan_cache = None
        if scan_epochs and mesh is not None:
            from grappa_tpu_torch.parallel.dp import make_dp_scan_epoch_step
            self.dp_scan_step = make_dp_scan_epoch_step(model, self.optimizer,
                                                        mesh)
        if scan_epochs and val_loader is not None and not val_loader.fixed_pad:
            # as the JAX package: the scanned validation pass runs on a
            # trainer-local shallow copy flipped to the fixed worst-case
            # PadSpec (conf masks make padding metric-neutral); the
            # caller's loader keeps its bucketed shapes
            import copy as _copy
            self.val_loader = val_loader = _copy.copy(val_loader)
            val_loader.fixed_pad = True

        # async checkpointing: snapshot on the device (a clone: the step
        # updates the parameters in place), then the device->host copy and
        # the file write run on a background thread; a save asked for while
        # the writer is busy is skipped. Default off.
        self.async_checkpoints = bool(
            trainer_config.get('async_checkpoints', False))
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None

        self.epoch = 0
        self.global_step = 0
        self.best_loss = float('inf')
        # device-side clone of the best state_dict, refreshed at every
        # improvement, so fit() can flush the true best at exit even when
        # the improvement's async save was skipped
        self._best_snapshot = None   # (device state_dict, epoch)
        # plateau-decay baseline, separate from best_loss: best_loss stays a
        # monotone global best (it gates best.ckpt), while this baseline is
        # reset after an LR decay so patience counts from the decay
        self.plateau_baseline = float('inf')
        self.epochs_without_improvement = 0
        self.elapsed_time = 0.0       # wall time from previous runs (s)
        self._fit_start: Optional[float] = None
        self._gen = torch.Generator().manual_seed(seed)
        self.evaluator = StreamingEvaluator()
        self.history: list = []
        self.train_losses: List[List[float]] = []   # per epoch, per step
        # host-clock seconds by part (lists: one entry per event)
        self.timings: Dict[str, list] = defaultdict(list)

    # ------------------------------------------------------------------
    def _loss_weights(self, ds_names: Sequence[str],
                      num_mols: int) -> LossWeights:
        cfg = self.cfg
        qm = self.epoch >= self.start_qm_epochs
        param_w = float(cfg.get('param_weight', 1e-3)) if qm else 1e-3
        if (cfg.get('param_loss_epochs') is not None
                and self.epoch >= cfg['param_loss_epochs']):
            param_w = 0.0
        overrides = cfg.get('param_weights_by_dataset', {})
        pw = np.full(num_mols, param_w, np.float32)
        for i, n in enumerate(ds_names):
            if n in overrides:
                pw[i] = overrides[n]
        return LossWeights(
            energy=float(np.float32(cfg.get('energy_weight', 1.0)
                                    if qm else 0.0)),
            gradient=float(np.float32(cfg.get('gradient_weight', 0.8)
                                      if qm else 0.0)),
            # from pinned memory without a wait: a pageable copy would
            # make the host wait for the previous step to finish
            param=(torch.from_numpy(pw).pin_memory().to(self.device,
                                                          non_blocking=True)
                   if self.device.type == 'cuda' else torch.from_numpy(pw)),
            proper_reg=float(np.float32(cfg.get('proper_regularisation',
                                                0.0))),
            improper_reg=float(np.float32(cfg.get('improper_regularisation',
                                                  0.0))),
        )

    def _step_lr(self) -> float:
        if self._warmup_step is not None:
            if self._warmup_step >= self.warmup_steps:
                self._warmup_step = None
                return self.lr
            lr = self._warmup_step / self.warmup_steps * self.lr
            self._warmup_step += 1
            return lr
        return self.lr

    # ------------------------------------------------------------------
    def profile_steps(self, n_steps: int = 5,
                      trace_dir: Optional[str] = None) -> Path:
        """A torch.profiler trace of n_steps training steps, written as a
        Chrome trace to `trace_dir` (default <out_dir>/profile)."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        batches = (iter(self.train_loader) if self.mesh is None
                   else self.train_loader.select(self._dp_plan()[0]))
        step = self.train_step if self.mesh is None else self.dp_train_step
        try:
            with profile(activities=activities) as prof:
                for batch, ds_names in itertools.islice(batches, n_steps):
                    step(
                        batch, self._loss_weights(ds_names, batch.num_mols),
                        self.lr, self._gen)
                if self.device.type == 'cuda':
                    torch.cuda.synchronize(self.device)
        finally:
            batches.close()
        trace_dir = Path(trace_dir or (self.out_dir or Path('.')) / 'profile')
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / 'trace.json'))
        return trace_dir

    def train_epoch(self) -> float:
        if self.epoch in self.restarts:
            self.optimizer.reset()
            self._warmup_step = 0

        if self.mesh is not None:
            return self._finish_epoch(self._train_epoch_dp_scan()
                                      if self.scan_epochs
                                      else self._train_epoch_dp())
        losses = []
        batches = self._train_batches()
        while True:
            t0 = time.perf_counter()
            item = next(batches, None)
            t1 = time.perf_counter()
            self.timings['loader_wait_s'].append(t1 - t0)
            if item is None:
                break
            batch, ds_names = item
            weights = self._loss_weights(ds_names, batch.num_mols)
            loss, _ = self.train_step(batch, weights, self._step_lr(),
                                      self._gen)
            # host time of the step: its launches, unless something waits
            self.timings['step_s'].append(time.perf_counter() - t1)
            losses.append(loss)
            self.global_step += 1
        return self._finish_epoch(losses)

    def _finish_epoch(self, losses) -> float:
        """One host fetch of the epoch's losses; the epoch's mean."""
        t0 = time.perf_counter()
        values = (torch.stack(list(losses)).cpu().tolist() if len(losses)
                  else [])
        self.timings['fetch_s'].append(time.perf_counter() - t0)
        self.train_losses.append(values)
        mean_loss = float(np.mean(values)) if values else 0.0
        self.log_fn({'epoch': self.epoch, 'train_loss': mean_loss,
                     'lr': self.lr})
        return mean_loss

    def _dp_plan(self):
        """This rank's share of an epoch (class doc): (keep, scale,
        n_real). keep(i) says whether the rank takes loader batch i: one a
        group, in group order. scale (n_groups,) float32: each group's
        weight scale, 1 but for a trailing group of k < W, where it is
        W / k on ranks r < k and 0 on the others, which take a padding
        replica. n_real: the rank's real batches (its padding is last)."""
        w, r = self.mesh.size, self.mesh.rank
        n = len(self.train_loader)
        n_groups = -(-n // w)
        k = n - (n_groups - 1) * w
        scale = np.ones(n_groups, np.float32)
        pad = -1
        if 0 < k < w:
            scale[-1] = w / k if r < k else 0.0
            if r >= k:
                pad = (n_groups - 1) * w + (r - k) % k
        n_real = n_groups - int(pad >= 0)
        return (lambda i: i % w == r or i == pad), scale, n_real

    def _dp_order(self, n_real: int, n_groups: int) -> np.ndarray:
        """The epoch's order of this rank's cached slots: its real slots
        shuffled, its padding last. The seed is drawn from the Trainer's
        generator on every rank alike (the generators stay in step), and
        the rank's index makes its shuffle its own."""
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self._gen))
        rng = np.random.default_rng((seed, self.mesh.rank))
        return np.concatenate([rng.permutation(n_real),
                               np.arange(n_real, n_groups)])

    def _dp_cache(self):
        """This rank's slots of the epoch, collated once: ([(batch,
        names)], scale, n_real) of _dp_plan."""
        if self._batch_cache is None:
            keep, scale, n_real = self._dp_plan()
            slots = list(self.train_loader.select(keep))
            if self.scan_epochs:
                # every rank raises, or none: a lone raise would hang the
                # others in their next collective
                ragged = torch.tensor(
                    [float(len({b.shapes() for b, _ in slots}) > 1)],
                    device=self.mesh.device)
                if float(self.mesh.all_reduce_(ragged)) > 0:
                    raise ValueError(
                        "scan_epochs needs uniform batch shapes — use a "
                        "loader with fixed_pad=True (the training default)")
            self._batch_cache = (slots, scale, n_real)
        return self._batch_cache

    def _train_epoch_dp(self) -> List[torch.Tensor]:
        """One epoch of data-parallel steps, a group of W loader batches a
        step (class doc): the rank's batch of each group, its weights
        times the group's scale."""
        if self.cache_batches:
            slots, scale, n_real = self._dp_cache()
            items = [slots[i] for i in self._dp_order(n_real, len(scale))]
        else:
            keep, scale, _ = self._dp_plan()
            items = self.train_loader.select(keep)
        losses: List[torch.Tensor] = []
        for g, (batch, names) in enumerate(items):
            weights = self._loss_weights(names, batch.num_mols)
            if scale[g] != 1.0:
                # float32 products, as the JAX package's x * float32(scale)
                weights = LossWeights(*(
                    torch.as_tensor(x, dtype=torch.float32,
                                    device=self.device) * float(scale[g])
                    for x in weights))
            t0 = time.perf_counter()
            loss, _ = self.dp_train_step(batch, weights, self._step_lr(),
                                         self._gen)
            self.timings['step_s'].append(time.perf_counter() - t0)
            losses.append(loss)
            self.global_step += 1
        return losses

    def _train_epoch_dp_scan(self) -> torch.Tensor:
        """The cached data-parallel epoch (`make_dp_scan_epoch_step`) over
        this rank's slots, stacked once: the real slots first and the
        padding last; the trailing group's weight scale is positional, so
        the epoch's shuffle of the real slots keeps the loop's group
        rule."""
        from grappa_tpu_torch.data.graph_batch import stack_batches
        from grappa_tpu_torch.parallel.dp import stack_loss_weights
        if self._dp_scan_cache is None:
            slots, scale, n_real = self._dp_cache()
            self._dp_scan_cache = (
                stack_batches([b for b, _ in slots]),
                torch.from_numpy(scale),
                [(n, b.num_mols) for b, n in slots], n_real)
            self._batch_cache = None     # the stack holds the batches
        flat_b, scale, names_mols, n_real = self._dp_scan_cache
        # the curriculum's weights are restacked every epoch
        flat_w = stack_loss_weights([self._loss_weights(n, m)
                                     for n, m in names_mols])
        perm = self._dp_order(n_real, len(names_mols))
        lrs = [self._step_lr() for _ in names_mols]
        losses = self.dp_scan_step(flat_b, flat_w, scale, perm, lrs,
                                   self._gen)
        self.global_step += len(names_mols)
        return losses

    def _train_batches(self):
        if not self.cache_batches:
            return iter(self.train_loader)
        if self._batch_cache is None:
            self._batch_cache = list(self.train_loader)
            if (self.scan_epochs and
                    len({b.shapes() for b, _ in self._batch_cache}) > 1):
                self._batch_cache = None
                raise ValueError(
                    "scan_epochs needs uniform batch shapes — use a "
                    "loader with fixed_pad=True (the training default)")
        order = torch.randperm(len(self._batch_cache),
                               generator=self._gen).tolist()
        return iter([self._batch_cache[i] for i in order])

    def validate(self) -> Dict[str, Dict[str, float]]:
        if self.val_loader is None:
            return {}
        if self.cache_batches:
            if self._val_cache is None:
                self._val_cache = list(self.val_loader)
            batches = self._val_cache
        else:
            batches = self.val_loader
        for batch, ds_names in batches:
            energy, gradient = self.eval_step(batch)
            self.evaluator.step(batch, energy, gradient, ds_names)
        return self.evaluator.pool()

    # ------------------------------------------------------------------
    def fit(self, max_epochs: Optional[int] = None) -> Dict:
        """Train until `self.epoch` reaches max_epochs (ABSOLUTE, like the
        reference's Lightning max_epochs: a resumed run continues to the
        same target instead of running max_epochs more)."""
        if max_epochs is None:  # explicit 0 means "train nothing"
            max_epochs = int(self.trainer_cfg.get('max_epochs', 100))
        time_limit_h = self.cfg.get('time_limit')
        # per-session bound: measured from THIS fit() call only (no
        # elapsed_time), so a resume gets a fresh budget
        session_limit_h = self.cfg.get('session_time_limit')
        finish_criterion = {
            float(k): float(v)
            for k, v in (self.cfg.get('finish_criterion') or {}).items()}
        es_energy_w = float(self.cfg.get('early_stopping_energy_weight', 3.0))
        ckpt_every = int(self.trainer_cfg.get('checkpoint_every', 5))
        self._last_best_save = -ckpt_every
        start_time = time.time()
        # checkpoints written during fit include the in-flight session time,
        # so a resumed run's time_limit / finish_criterion is cumulative
        self._fit_start = start_time

        try:
            self._fit_loop(max_epochs, finish_criterion, time_limit_h,
                           session_limit_h, es_energy_w, ckpt_every,
                           start_time)
        except BaseException:
            # join the in-flight async writer before unwinding: an orphaned
            # writer could finish its (stale) last.ckpt AFTER safe_trainrun's
            # retry resumed from that file. The original exception is what
            # matters; a writer error is dropped here.
            if self._ckpt_thread is not None:
                try:
                    self._join_ckpt_thread()
                except RuntimeError:
                    pass
            raise

        if self.out_dir:
            # if the latest improvement's best-save was skipped (writer busy
            # / throttle window), flush the device-held best snapshot now
            if (self._best_snapshot is not None
                    and self._best_snapshot[1] > self._last_best_save):
                best_params, best_epoch = self._best_snapshot
                self._join_ckpt_thread()
                t0 = time.perf_counter()
                _write_checkpoint(self.out_dir / 'best.ckpt',
                                  _to_host(best_params), None,
                                  self._ckpt_meta(epoch=best_epoch))
                self.timings['ckpt_blocking_s'].append(
                    time.perf_counter() - t0)
                self._last_best_save = best_epoch
            # the fit-exit resume point must be on disk before returning
            self.save_checkpoint(self.out_dir / 'last.ckpt', blocking=True)
        else:
            self._join_ckpt_thread()
        # fold this session's wall time into the stored total so a later
        # fit() (or a save outside fit) doesn't double-count it
        self.elapsed_time += time.time() - start_time
        self._fit_start = None
        if self.mesh is not None:
            # rank 0's checkpoints are on disk before any rank reads them
            self.mesh.barrier()
        return {'best_early_stopping_loss': self.best_loss,
                'epochs': self.epoch, 'history': self.history}

    def _fit_loop(self, max_epochs, finish_criterion, time_limit_h,
                  session_limit_h, es_energy_w, ckpt_every, start_time):
        while self.epoch < max_epochs:
            t_ep = time.time()
            self.train_epoch()
            t_train = time.time() - t_ep
            t_val0 = time.time()
            metrics = self.validate()
            if self.mesh is not None:
                # every decision below reads rank 0's metrics
                metrics = self.mesh.broadcast_object(metrics)
            t_val = time.time() - t_val0
            self.timings['train_s'].append(t_train)
            self.timings['val_s'].append(t_val)
            es_loss = early_stopping_loss(metrics, es_energy_w)
            self.history.append({'epoch': self.epoch, 'metrics': metrics,
                                 'early_stopping_loss': es_loss})
            self.log_fn({'epoch': self.epoch, 'val_metrics': metrics,
                         'early_stopping_loss': es_loss,
                         't_train': round(t_train, 3),
                         't_val': round(t_val, 3)})

            if self.epoch >= self.start_qm_epochs and np.isfinite(es_loss):
                if es_loss < self.best_loss:
                    # monotone global best: gates best.ckpt only
                    self.best_loss = es_loss
                    # keep the best weights on the device whether or not the
                    # save below happens: the fit-exit flush writes them
                    self._best_snapshot = (self._snapshot(), self.epoch)
                    # best checkpoints: params only, throttled; an async
                    # save skipped because the writer is busy does NOT
                    # advance the throttle clock, so the next improvement
                    # retries
                    if self.out_dir and (
                            self.epoch - self._last_best_save >= ckpt_every):
                        if self.save_checkpoint(self.out_dir / 'best.ckpt',
                                                include_opt_state=False):
                            self._last_best_save = self.epoch
                if es_loss < self.plateau_baseline:
                    self.plateau_baseline = es_loss
                    self.epochs_without_improvement = 0
                else:
                    self.epochs_without_improvement += 1
                    patience = int(self.cfg.get('patience', 50))
                    if patience > 0 and self.epochs_without_improvement > patience:
                        self.lr *= float(self.cfg.get('lr_decay', 0.8))
                        self.epochs_without_improvement = 0
                        self.plateau_baseline = es_loss

            # the epoch is COMPLETE here: count it before any early exit, so
            # the final checkpoint records it and a resume does not retrain it
            self.epoch += 1
            self.timings['epoch_s'].append(time.time() - t_ep)

            elapsed_h = (time.time() - start_time + self.elapsed_time) / 3600.0
            relevant = [v for k, v in finish_criterion.items() if k < elapsed_h]
            stop = bool(
                (relevant and es_loss > min(relevant))
                or (time_limit_h is not None and elapsed_h > time_limit_h)
                or (session_limit_h is not None and (
                    (time.time() - start_time) / 3600.0 > session_limit_h)))
            if self.mesh is not None:
                stop = self.mesh.broadcast_object(stop)   # rank 0's clock
            if stop:
                break

            if self.out_dir and self.epoch % ckpt_every == 0:
                self.save_checkpoint(self.out_dir / 'last.ckpt')

    # ------------------------------------------------------------------
    # checkpointing: torch.save payloads + json sidecar + crc32 manifest
    def _snapshot(self) -> Dict[str, torch.Tensor]:
        """Device-side clones of the model's state_dict (weights and
        buffers), taken now: later steps update the live tensors."""
        return _map_tensors(self.model.state_dict(),
                            lambda t: t.detach().clone())

    def _join_ckpt_thread(self):
        """Wait for an in-flight async checkpoint write and surface its
        error (if any) to the caller."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        if self._ckpt_error is not None:
            err, self._ckpt_error = self._ckpt_error, None
            raise RuntimeError('async checkpoint write failed') from err

    def _ckpt_meta(self, epoch: Optional[int] = None) -> Dict:
        elapsed = self.elapsed_time + (
            time.time() - self._fit_start if self._fit_start else 0.0)
        return {
            'epoch': self.epoch if epoch is None else int(epoch),
            'global_step': self.global_step,
            'lr': self.lr, 'best_loss': self.best_loss,
            'plateau_baseline': self.plateau_baseline,
            'elapsed_time': elapsed,
            'config': _jsonable(self.full_config),
        }

    def save_checkpoint(self, path, include_opt_state: bool = True,
                        blocking: Optional[bool] = None) -> bool:
        """Write the state_dict (+ optimizer state) and a json sidecar to
        `path`.

        blocking=None resolves to `not self.async_checkpoints`. A
        non-blocking save clones the state on the device and returns at
        once while a background thread copies it to the host and writes
        it; if a previous async write is still in flight it is SKIPPED
        (returns False), so checkpoints never stall training."""
        path = Path(path)
        if blocking is None:
            blocking = not self.async_checkpoints
        meta = self._ckpt_meta()
        if blocking:
            # serialize with any in-flight async write to the same tree
            self._join_ckpt_thread()
            t0 = time.perf_counter()
            _write_checkpoint(
                path, _to_host(self.model.state_dict()),
                _to_host(self.optimizer.state_dict())
                if include_opt_state else None, meta)
            self.timings['ckpt_blocking_s'].append(time.perf_counter() - t0)
            return True
        if self._ckpt_thread is not None and self._ckpt_thread.is_alive():
            return False
        self._join_ckpt_thread()   # reap the finished thread + its errors
        params = self._snapshot()
        opt = (_map_tensors(self.optimizer.state_dict(),
                            lambda t: t.detach().clone())
               if include_opt_state else None)
        ready = None
        if self.device.type == 'cuda':
            ready = torch.cuda.Event()
            ready.record()

        def work():
            t0 = time.perf_counter()
            try:
                _write_checkpoint(path, _to_host(params, ready),
                                  _to_host(opt, ready), meta)
            except BaseException as exc:   # surfaced on next join
                self._ckpt_error = exc
            self.timings['ckpt_async_s'].append(time.perf_counter() - t0)

        self._ckpt_thread = threading.Thread(
            target=work, name='grappa-ckpt-writer', daemon=True)
        self._ckpt_thread.start()
        return True

    def load_checkpoint(self, path):
        path = Path(path)
        _verify_checkpoint(path)
        self.model.load_state_dict(torch.load(
            path / 'params.pt', map_location=self.device, weights_only=True))
        if (path / 'opt_state.pt').exists():
            self.optimizer.load_state_dict(torch.load(
                path / 'opt_state.pt', map_location=self.device,
                weights_only=True))
        meta = json.loads((path / 'meta.json').read_text())
        self.epoch = meta['epoch']
        self.global_step = meta['global_step']
        self.lr = meta['lr']
        self.best_loss = meta['best_loss']
        self.plateau_baseline = meta.get('plateau_baseline', meta['best_loss'])
        self.elapsed_time = meta.get('elapsed_time', 0.0)


def _write_checkpoint(path: Path, params: Dict, opt_state: Optional[Dict],
                      meta: Dict):
    """Serialize a checkpoint with per-file atomic replaces (tmp +
    os.replace), params -> opt_state -> meta -> manifest. A crash mid-write
    can never truncate an existing checkpoint file (the old resume point
    survives). Per-file replaces alone could still leave a MIXED checkpoint
    (params one save newer than the Adam state/meta), so a manifest with a
    crc32 per payload is written LAST: `_verify_checkpoint` detects any
    torn combination instead of silently resuming from mismatched state.
    `params` and `opt_state` are host tensors."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    crcs = {}

    def atomic_write(name: str, write: Callable[[Path], None]):
        tmp = path / (name + '.tmp')
        write(tmp)
        crcs[name] = _crc32(tmp)
        os.replace(tmp, path / name)

    # torch.save streams into the file: no in-memory copy of the payload
    atomic_write('params.pt', lambda f: torch.save(params, f))
    if opt_state is not None:
        atomic_write('opt_state.pt', lambda f: torch.save(opt_state, f))
    else:
        # a params-only save (best.ckpt) must invalidate any stale opt
        # state left from an older save of the same directory
        (path / 'opt_state.pt').unlink(missing_ok=True)
    atomic_write('meta.json',
                 lambda f: f.write_text(json.dumps(meta, indent=1)))
    manifest = json.dumps(crcs)
    atomic_write('manifest.json', lambda f: f.write_text(manifest))


def _crc32(path: Path, chunk: int = 1 << 24) -> int:
    """crc32 of a file, read in 16 MiB chunks."""
    crc = 0
    with open(path, 'rb') as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _verify_checkpoint(path: Path):
    """Raise if the checkpoint directory is a torn mix of two saves (crash
    between the per-file atomic replaces). Checkpoints without a manifest
    verify trivially."""
    manifest = path / 'manifest.json'
    if not manifest.exists():
        return
    crcs = json.loads(manifest.read_text())
    for name, crc in crcs.items():
        if name == 'manifest.json':
            continue
        f = path / name
        if not f.exists() or _crc32(f) != crc:
            raise RuntimeError(
                f'checkpoint {path} is torn: {name} does not match its '
                f'manifest (crash between per-file writes?). Resume from '
                f'a different checkpoint (best.ckpt / an older copy) or '
                f'delete the directory to restart.')


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
