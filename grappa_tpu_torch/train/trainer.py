"""One training step: the model forward with dropout, the MM energy and its
gradient dE/dx, `molwise_loss`, the backward through dE/dx into the model,
clip-by-global-norm and Adam.

Counterpart of `grappa_tpu.train.trainer.make_optimizer`,
`make_train_step` and `make_eval_step`. The optimizer is the port's own
copy of the JAX package's optax chain
    clip_by_global_norm(grad_clip) -> scale_by_adam() ->
    [add_decayed_weights(weight_decay)] -> scale(-1)
with the learning rate applied outside the chain, so a schedule changes
nothing in the optimizer. Two places where torch's stock pieces differ from
optax and are not used: `clip_grad_norm_` divides by norm + 1e-6 and scales
always, optax scales by max_norm / norm only when the norm exceeds
max_norm; and the Adam state here is optax's (count, mu, nu), with optax's
order of operations. The step updates the model's parameters in place and
keeps the optimizer state in the optimizer (PyTorch runs eagerly; there is
no compiled step to donate buffers to). `Trainer`, the scanned epochs,
checkpoints and the curriculum are queued (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from grappa_tpu_torch.data.graph_batch import GraphBatch
from grappa_tpu_torch.models import mm_energy
from grappa_tpu_torch.train.loss import LossWeights, molwise_loss


class AdamClip:
    """clip_by_global_norm -> scale_by_adam -> [add_decayed_weights] ->
    scale(-1), then x lr: the chain of the JAX package's make_optimizer.
    State: `count` and per-parameter `mu` / `nu`, keyed by parameter name
    (optax's ScaleByAdamState). b1, b2 and eps are optax's defaults, which
    the JAX package uses."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, grad_clip: float = 10.0, weight_decay: float = 0.0):
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: g * max_norm / |g| only where the
        global norm |g| reaches max_norm (no epsilon)."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.grad_clip
        return [torch.where(keep, g, g / norm * self.grad_clip)
                for g in grads]

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
        for (name, p), g in zip(params.items(), grads):
            mu = (1.0 - b1) * g + b1 * self.mu[name]
            nu = (1.0 - b2) * (g * g) + b2 * self.nu[name]
            self.mu[name], self.nu[name] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(-u * lr)


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
    place. loss and aux are detached tensors on the batch's device."""
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
