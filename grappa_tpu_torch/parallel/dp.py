"""Data parallelism on torch.distributed: one process a rank.

Counterpart of `grappa_tpu.parallel.dp`. Where the JAX package runs one
shard_map program over a mesh of devices, here every rank is a process
(started by `torchrun` or `torch.multiprocessing`) that runs the same
calls on its own device, and the collectives are placed by hand:

  * Data parallelism: each rank computes the loss and gradients of its own
    batch; one all-reduce of a single flat buffer holding every gradient,
    the loss and the diagnostics, divided by the world size, gives every
    rank the mean (the JAX package's pmean); AdamClip then updates the
    replicated parameters on every rank alike, its clip seeing the mean.
    DistributedDataParallel is not used: its reducer hooks fire on
    `.backward()`, and the step takes `torch.autograd.grad` through a
    `create_graph` dE/dx.
  * Conformer-axis parallelism: each rank takes C / W conformers of a
    batch, and the energies and dE/dx are all-gathered along C.

`Mesh` carries the process group, the rank, the world size and the rank's
device. The backend is NCCL when every rank has a card of its own (each
host has as many cards as it runs ranks), and gloo when ranks share a card
or run on the CPU; with gloo every collective of a CUDA tensor goes through
a host copy. Only all_reduce, all_gather and
broadcast are used, so NCCL, gloo on the CPU and gloo on a shared card run
the same code. The differentiable collectives (`all_gather_rows`,
`all_reduce_sum`) are the port's own autograd Functions, each backward the
other's forward, so a second backward (the force loss's) works too:
torch.distributed.nn's all_gather differentiates through all_to_all,
which gloo lacks.
"""
from __future__ import annotations

import collections
import datetime
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from grappa_tpu_torch.data.graph_batch import GraphBatch, stack_batches
from grappa_tpu_torch.models import mm_energy
from grappa_tpu_torch.ops import philox
from grappa_tpu_torch.train.loss import LossWeights

# a rank that waits longer than this on a collective fails instead of
# hanging its job
TIMEOUT_S = 120

# {(collective, operand dtype): calls} of this process's Mesh collectives
# (objects and barriers aside); a caller clears it to see one path's
COLLECTIVE_DTYPES = collections.Counter()


class Mesh(NamedTuple):
    """A 1-D mesh of ranks: the process group, this process's rank, the
    world size, the axis name, this rank's device and the backend. Built
    by `make_mesh`."""
    group: object
    rank: int
    size: int
    axis: str
    device: torch.device
    backend: str

    def _host(self, t: torch.Tensor) -> bool:
        """Whether a collective of t goes through a host copy (gloo)."""
        return self.backend == 'gloo' and t.is_cuda

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks of a contiguous tensor."""
        COLLECTIVE_DTYPES['all_reduce', str(t.dtype)] += 1
        if self._host(t):
            h = t.cpu()
            dist.all_reduce(h, group=self.group)
            return t.copy_(h)
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place: every rank's t becomes rank `src`'s."""
        COLLECTIVE_DTYPES['broadcast', str(t.dtype)] += 1
        if self.size == 1:
            return t
        if self._host(t) or not t.is_contiguous():
            h = t.detach().cpu().contiguous() if self._host(t) \
                else t.detach().contiguous()
            dist.broadcast(h, src, group=self.group)
            return t.copy_(h)
        dist.broadcast(t, src, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' t (same shape on every rank) concatenated along axis
        0, in rank order."""
        COLLECTIVE_DTYPES['all_gather', str(t.dtype)] += 1
        if self.size == 1:
            return t.clone()
        src = t.detach().contiguous()
        host = self._host(src)
        if host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        return out.to(t.device) if host else out

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s picklable object, on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src, group=self.group,
            device=self.device if self.backend == 'nccl' else None)
        return box[0]

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None, axis: str = 'dp',
              device=None, init_method: Optional[str] = None,
              rank: Optional[int] = None,
              world_size: Optional[int] = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """The mesh of this process's job. Joins the process group when one is
    initialised; else starts it: from `init_method` (a `file://` store or
    `tcp://host:port`) with `rank` / `world_size`, or from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT); a lone
    process without either is a world of 1. The backend is NCCL when each
    rank has a card of its own, else gloo (`_choose_backend`). device: the
    rank's device,
    `cuda:LOCAL_RANK % device_count` unless the caller passes another
    ('cpu' for the plain path). n_devices: the world size the caller
    needs; fewer ranks raise, as the JAX package's make_mesh does with
    fewer devices (a mesh is the whole world)."""
    if not dist.is_initialized():
        env = os.environ
        if rank is None:
            rank = int(env.get('RANK', 0))
        if world_size is None:
            world_size = int(env.get('WORLD_SIZE', 1))
    else:
        rank, world_size = dist.get_rank(), dist.get_world_size()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass device='cpu' to run the "
                "plain PyTorch path")
        local = int(os.environ.get('LOCAL_RANK', rank))
        device = torch.device('cuda', local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    if not dist.is_initialized():
        backend = _choose_backend(device, world_size)
        if backend == 'nccl':
            torch.cuda.set_device(device)
        timeout = datetime.timedelta(seconds=timeout_s)
        if init_method is not None:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=world_size,
                                    timeout=timeout)
        elif 'MASTER_ADDR' in os.environ:
            dist.init_process_group(backend, rank=rank,
                                    world_size=world_size, timeout=timeout)
        elif world_size == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=timeout)
        else:
            raise RuntimeError(
                f"make_mesh: {world_size} ranks but no rendezvous: run under "
                f"torchrun or pass init_method")
    size = dist.get_world_size()
    if n_devices is not None and size < n_devices:
        raise ValueError(f"need {n_devices} devices, have {size}")
    if n_devices is not None and size != n_devices:
        raise ValueError(f"a mesh spans the whole world of {size} ranks; "
                         f"start {n_devices} ranks for a mesh of "
                         f"{n_devices}")
    return Mesh(dist.group.WORLD, dist.get_rank(), size, axis, device,
                dist.get_backend())


def _choose_backend(device: torch.device, world_size: int) -> str:
    """NCCL when the rank's device is a card and this host has a card for
    each of its ranks, else gloo (ranks sharing a card, or on the CPU).
    The host's ranks are LOCAL_WORLD_SIZE, which torchrun sets; without it
    every rank is taken to run on this host."""
    local = int(os.environ.get('LOCAL_WORLD_SIZE', world_size))
    return ('nccl' if device.type == 'cuda'
            and torch.cuda.device_count() >= local else 'gloo')


# ---------------------------------------------------------------- autograd
class _AllReduceSum(torch.autograd.Function):
    """y = the sum over ranks of x. With every rank's objective the sum of
    its local parts, dx on a rank is the sum of the ranks' dy: the
    backward is this op again."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.detach().contiguous().clone())

    @staticmethod
    def backward(ctx, dy):
        return _AllReduceSum.apply(dy, ctx.mesh), None


class _AllGatherRows(torch.autograd.Function):
    """y = the ranks' x concatenated along axis 0. dx on a rank is its
    rows of the sum of the ranks' dy: an all-reduce, then the rank's
    slice (an all-reduce where NCCL would reduce-scatter: gloo has no
    reduce_scatter)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return mesh.all_gather(x)

    @staticmethod
    def backward(ctx, dy):
        first = ctx.mesh.rank * ctx.rows
        full = _AllReduceSum.apply(dy.contiguous(), ctx.mesh)
        return full[first:first + ctx.rows], None


class _WholeGrad(torch.autograd.Function):
    """y = x, for a tensor every rank computes whole from replicated inputs
    while each rank uses its own part of it: dx is the ranks' mean of dy,
    summed in float32. Each rank's dy carries the world size's factor of
    the replicated loss, so the mean is the whole tensor's gradient, and
    the ops before it see that gradient as an unsharded backward does
    (a bf16 cast's backward would otherwise round each rank's part)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        full = ctx.mesh.all_reduce_(dy.float().contiguous().clone())
        return full.div_(float(ctx.mesh.size)).to(dy.dtype), None


def whole_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x, whose gradient is the ranks' mean of theirs (`_WholeGrad`)."""
    return _WholeGrad.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum over the ranks (every rank gets it)."""
    return _AllReduceSum.apply(x, mesh)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable concatenation of the ranks' x along axis 0."""
    return _AllGatherRows.apply(x, mesh)


def _gather_axis(x: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """Differentiable concatenation of the ranks' x along `axis`."""
    return all_gather_rows(x.movedim(axis, 0).contiguous(),
                           mesh).movedim(0, axis)


# ---------------------------------------------------------------- batches
def shard_batches(batches: Sequence[GraphBatch]) -> GraphBatch:
    """Stack same-shape per-rank batches along a leading slot axis."""
    return stack_batches(batches)


def _slot(stacked: GraphBatch, i: int) -> GraphBatch:
    """Slot i of a stacked batch (views)."""
    return stacked._map(lambda t: t[i])


def stack_loss_weights(weights: Sequence[LossWeights]) -> LossWeights:
    """LossWeights with every field stacked along a leading slot axis, as
    float32 tensors on the device of the first `param` tensor."""
    device = next((w.param.device for w in weights
                   if isinstance(w.param, torch.Tensor)), None)
    return LossWeights(*(
        torch.stack([torch.as_tensor(getattr(w, f), dtype=torch.float32,
                                     device=device) for w in weights])
        for f in LossWeights._fields))


def _slot_weights(stacked: LossWeights, i: int, scale) -> LossWeights:
    """Slot i of stacked loss weights, every field times `scale` (a
    float32 0-d tensor)."""
    return LossWeights(*(x[i] * scale for x in stacked))


def replicate(model: torch.nn.Module, mesh: Mesh, optimizer=None
              ) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers (and the optimizer's
    count and Adam moments) so every rank starts equal."""
    with torch.no_grad():
        seen = set()
        for t in model.state_dict().values():
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                mesh.broadcast_(t)
    if optimizer is not None:
        count, names = mesh.broadcast_object(
            (optimizer.count, list(optimizer.mu)))
        params = dict(model.named_parameters())
        optimizer.count = count
        if names and not optimizer.mu:
            optimizer.mu = {k: torch.zeros_like(params[k]) for k in names}
            optimizer.nu = {k: torch.zeros_like(params[k]) for k in names}
        for k in names:
            mesh.broadcast_(optimizer.mu[k])
            mesh.broadcast_(optimizer.nu[k])
    return model


def mean_over_ranks(tensors: Sequence[torch.Tensor], mesh: Mesh
                    ) -> List[torch.Tensor]:
    """The ranks' mean of each tensor: ONE all-reduce of a flat buffer
    holding them all, then a division by the world size."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    mesh.all_reduce_(flat)
    flat.div_(float(mesh.size))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


# ---------------------------------------------------------------- steps
def make_dp_train_step(model: torch.nn.Module, optimizer, mesh: Mesh
                       ) -> Callable:
    """One data-parallel training step: step(batch, weights, lr,
    generator) -> (loss, aux), the loss and aux the ranks' mean.

    Each rank passes its own batch and weights. The rank's loss and
    gradients (`trainer.loss_gradients`) are averaged over the
    ranks by one all-reduce, and AdamClip updates the parameters with the
    mean. Dropout: every seed the forward draws is the rank-th of W drawn
    from `generator` (`philox.RankSeeds`; the generator must be in the
    same state on every rank); with one rank the step is make_train_step's
    own, bit for bit."""
    from grappa_tpu_torch.train.trainer import loss_gradients
    params = dict(model.named_parameters())

    def step(batch: GraphBatch, weights: LossWeights, lr,
             generator: torch.Generator):
        seeds = (generator if mesh.size == 1
                 else philox.RankSeeds(generator, mesh.rank, mesh.size))
        loss, aux, grads = loss_gradients(model, batch, weights, seeds)
        keys = list(aux)
        mean = mean_over_ranks(
            [loss, *(aux[k] for k in keys), *grads.values()], mesh)
        loss, aux = mean[0], dict(zip(keys, mean[1:1 + len(keys)]))
        optimizer.step(params, mean[1 + len(keys):], lr)
        return loss, aux

    return step


def make_dp_scan_epoch_step(model: torch.nn.Module, optimizer, mesh: Mesh
                            ) -> Callable:
    """One data-parallel epoch over a cached slot axis (the JAX package's
    one-dispatch scan, here the port's cached loop):

      epoch(batches, weights, slot_scale, perm, lrs, generator)
          -> losses (n_groups,)

    Each rank passes its own slots, one a group: batches / weights
    stacked (stack_batches / stack_loss_weights) with a leading axis of
    n_groups, the rank's real batches first and its padding replica last
    (a rank r >= k of a trailing group of k < W real batches has one);
    slot_scale (n_groups,): 1 for full groups, W / k at the trailing
    group's position on ranks r < k and 0 at the padding's, applied by
    position after the permutation; perm (n_groups,) shuffles the rank's
    real slots only; lrs (n_groups,). Step g takes slot perm[g]. The JAX
    package stacks all n_groups * W slots on every device; here a rank
    holds only the slots it trains on. Every rank passes the same lrs and
    generator state (`Trainer` draws the ranks' perms from one seed)."""
    step = make_dp_train_step(model, optimizer, mesh)

    def epoch(batches: GraphBatch, weights: LossWeights,
              slot_scale: torch.Tensor, perm, lrs, generator) -> torch.Tensor:
        scale = torch.as_tensor(slot_scale, dtype=torch.float32,
                                device=weights.energy.device)
        losses = []
        for g, s in enumerate(int(i) for i in perm):
            loss, _ = step(_slot(batches, s),
                           _slot_weights(weights, s, scale[g]),
                           float(lrs[g]), generator)
            losses.append(loss)
        return torch.stack(losses)

    return epoch


def make_dp_eval_step(model: torch.nn.Module, mesh: Mesh) -> Callable:
    """Data-parallel inference: eval(batch) -> (energy (W, M, C),
    gradient (W, N, C, 3)), each rank's result of its own batch (all the
    same shapes) all-gathered along a leading rank axis."""
    from grappa_tpu_torch.train.trainer import make_eval_step
    local = make_eval_step(model)

    def run(batch: GraphBatch):
        energy, gradient = local(batch)
        return (mesh.all_gather(energy[None]),
                mesh.all_gather(gradient[None]))

    return run


def make_conf_sharded_energy_fn(mesh: Mesh) -> Callable:
    """Energy and dE/dx with the conformer axis split over the ranks:
    run(batch, params) -> (energy (M, C), gradient (N, C, 3)). Each rank
    computes its C / W conformers (the energy of a conformer needs no other
    conformer) and the results are all-gathered along C. `params` (the
    predicted parameters) must be the same on every rank."""

    def run(batch: GraphBatch, params: Dict[str, torch.Tensor]):
        w = mesh.size
        c = batch.xyz.shape[1]
        if c % w != 0:
            raise ValueError(
                f"conformer axis ({c}) must be divisible by the mesh size "
                f"({w}); pad n_confs to a multiple (the loader's conf "
                f"buckets can be set accordingly)")
        first, n = mesh.rank * (c // w), c // w
        part = batch._map(lambda t: t)
        part.xyz = batch.xyz[:, first:first + n]
        part.conf_mask = batch.conf_mask[:, first:first + n]
        part.energy_ref = batch.energy_ref[:, first:first + n]
        part.gradient_ref = batch.gradient_ref[:, first:first + n]
        energy, gradient = mm_energy.energy_and_gradient(part, params)
        return _gather_axis(energy, mesh, 1), _gather_axis(gradient, mesh, 1)

    return run
