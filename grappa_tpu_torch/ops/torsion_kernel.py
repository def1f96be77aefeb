"""K5: fused dihedral + periodic-torsion energy, pos (T, 4, 3, C) and signed
k (T, P) -> energy (T, C); K5b: its backward, (pos, k, g) -> dpos and dk.

Counterpart of `grappa_tpu/ops/torsion_kernel.py::torsion_energy_fused`:
the dihedral of the four gathered positions, then sum_n k_n cos(n*phi)
with n = column index + 1. Masked or padded tuples must carry zeroed k
rows. `reference_torsion_energy` is the plain version (the JAX package's
`_energy_jnp`), `reference_torsion_energy_grad` its vector-Jacobian
product (what the JAX package's backward computes).

On CUDA tensors `torsion_energy_fused` launches the hand-written kernel K5
and its backward the hand-written K5b, both in `csrc/torsion.cu`
(trig-free: cos(phi), and the Chebyshev recurrences of the first and
second kind, in registers; the source notes give the card's bounds and the
design). On CPU tensors both run their plain versions.
`torsion_energy_fused.launches` and `torsion_energy_grad.launches` count
kernel launches.

K5b is itself differentiable, so the training loss's double backward
through dE/dx reaches k: its own backward is the vector-Jacobian product of
the plain first-order version at the saved (pos, k, g), as the JAX
package's backward is the plain vjp. Only that second order is plain, and
only a double backward reaches it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from grappa_tpu_torch.models import geometry
from grappa_tpu_torch.ops import _cuda

Grads = Tuple[torch.Tensor, Optional[torch.Tensor]]


def reference_torsion_energy(pos: torch.Tensor, k: torch.Tensor
                             ) -> torch.Tensor:
    """Plain PyTorch version: pos (T, 4, 3, C), k (T, P) -> (T, C)."""
    phi = geometry.dihedral_angle(*[pos[:, a].movedim(1, -1)
                                    for a in range(4)])
    ns = torch.arange(1, k.shape[1] + 1, dtype=phi.dtype, device=phi.device)
    return (k[:, :, None] * torch.cos(ns[None, :, None] * phi[:, None, :])
            ).sum(dim=1)


def reference_torsion_energy_grad(pos: torch.Tensor, k: torch.Tensor,
                                  g: torch.Tensor, need_k: bool = True
                                  ) -> Grads:
    """Plain version of K5b: the vector-Jacobian product of
    `reference_torsion_energy` at (pos, k) with cotangent g (T, C) ->
    (dpos, dk), dk None unless need_k. Under grad mode the result stays a
    function of whichever inputs require grad."""
    create = torch.is_grad_enabled() and (
        pos.requires_grad or k.requires_grad or g.requires_grad)
    with torch.enable_grad():
        p = pos if create and pos.requires_grad else \
            pos.detach().requires_grad_(True)
        kk = k if create and k.requires_grad else \
            k.detach().requires_grad_(need_k)
        energy = reference_torsion_energy(p, kk)
        grads = torch.autograd.grad(energy, [p, kk] if need_k else [p], g,
                                    create_graph=create)
    return grads[0], (grads[1] if need_k else None)


def _launch(pos: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    t, _, _, c = pos.shape
    out = pos.new_empty((t, c))
    _cuda.check(_cuda.lib().grappa_torsion_energy(
        pos.data_ptr(), k.data_ptr(), out.data_ptr(), t, c, k.shape[1],
        _cuda.stream_of(pos)), 'grappa_torsion_energy')
    torsion_energy_fused.launches += 1
    return out


def _launch_grad(pos: torch.Tensor, k: torch.Tensor, g: torch.Tensor,
                 need_k: bool) -> Grads:
    t, _, _, c = pos.shape
    dpos = torch.empty_like(pos)
    dk = torch.empty_like(k) if need_k else None
    _cuda.check(_cuda.lib().grappa_torsion_grad(
        pos.data_ptr(), k.data_ptr(), g.data_ptr(), dpos.data_ptr(),
        None if dk is None else dk.data_ptr(), t, c, k.shape[1],
        _cuda.stream_of(pos)), 'grappa_torsion_grad')
    torsion_energy_grad.launches += 1
    return dpos, dk


class TorsionEnergy(torch.autograd.Function):
    """K5's forward (the plain version on CPU tensors); backward K5b."""

    @staticmethod
    def forward(ctx, pos, k):
        ctx.save_for_backward(pos, k)
        if pos.is_cuda:
            return _launch(pos, k)
        return reference_torsion_energy(pos, k)

    @staticmethod
    def backward(ctx, g):
        need_pos, need_k = ctx.needs_input_grad
        if not (need_pos or need_k):
            return None, None
        pos, k = ctx.saved_tensors
        if pos.is_cuda:
            g = _cuda.grad_output(g, pos, 'torsion_energy_fused')
        dpos, dk = torsion_energy_grad(pos, k, g, need_k)
        return (dpos if need_pos else None), dk


class TorsionEnergyGrad(torch.autograd.Function):
    """K5b (the plain version on CPU tensors), with the plain first-order
    version's vector-Jacobian product as its backward."""

    @staticmethod
    def forward(ctx, pos, k, g, need_k):
        ctx.save_for_backward(pos, k, g)
        ctx.need_k = need_k
        if pos.is_cuda:
            return _launch_grad(pos, k, g, need_k)
        return reference_torsion_energy_grad(pos, k, g, need_k)

    @staticmethod
    def backward(ctx, d_dpos, d_dk):
        # as TorsionEnergy's old backward: grad mode is on here only under
        # create_graph=True, and then the saved inputs stay in the graph
        needs = ctx.needs_input_grad[:3]
        if not any(needs):
            return None, None, None, None
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            ins = [t if create and t.requires_grad
                   else t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            dpos, dk = reference_torsion_energy_grad(*ins, ctx.need_k)
            outs, cots = [dpos], [d_dpos]
            if dk is not None and d_dk is not None:
                outs.append(dk)
                cots.append(d_dk)
            wrt = [t for t, n in zip(ins, needs) if n]
            grads = torch.autograd.grad(outs, wrt, cots, create_graph=create,
                                        allow_unused=True)
        # an input that no output reaches (all tuples degenerate) gets 0
        grads = iter([torch.zeros_like(t) if d is None else d
                      for t, d in zip(wrt, grads)])
        return (*[next(grads) if n else None for n in needs], None)


def _check(pos: torch.Tensor, k: torch.Tensor, name: str) -> None:
    ps, ks = pos.shape, k.shape
    if len(ps) != 4 or ps[1] != 4 or ps[2] != 3:
        raise ValueError(f"{name} takes pos (T, 4, 3, C), got shape "
                         f"{tuple(ps)}")
    if len(ks) != 2 or ks[0] != ps[0] or ks[1] < 1:
        raise ValueError(f"{name} takes k (T, P) with T = {ps[0]} and "
                         f"P >= 1, got shape {tuple(ks)}")


def _needs_graph(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def torsion_energy_fused(pos: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Fused torsion energy: pos (T, 4, 3, C), signed k (T, P) -> (T, C).

    Equivalent to geometry.dihedral_angle + mm_energy.torsion_term_energy
    (offset=False)."""
    _check(pos, k, 'torsion_energy_fused')
    if not _cuda.on_cuda((pos, k), 'torsion_energy_fused'):
        return reference_torsion_energy(pos, k)
    if _needs_graph(pos, k):
        return TorsionEnergy.apply(pos, k)
    return _launch(pos, k)


def torsion_energy_grad(pos: torch.Tensor, k: torch.Tensor, g: torch.Tensor,
                        need_k: bool = True) -> Grads:
    """K5b: the gradient of sum(g * torsion_energy_fused(pos, k)) ->
    (dpos (T, 4, 3, C), dk (T, P) or None unless need_k); differentiable
    in (pos, k, g) under grad mode."""
    _check(pos, k, 'torsion_energy_grad')
    if g.shape != (pos.shape[0], pos.shape[3]):
        raise ValueError(f"torsion_energy_grad takes g (T, C) = "
                         f"{(pos.shape[0], pos.shape[3])}, got shape "
                         f"{tuple(g.shape)}")
    on_card = _cuda.on_cuda((pos, k, g), 'torsion_energy_grad')
    if _needs_graph(pos, k, g):
        return TorsionEnergyGrad.apply(pos, k, g, need_k)
    if on_card:
        return _launch_grad(pos, k, g, need_k)
    return reference_torsion_energy_grad(pos, k, g, need_k)


torsion_energy_fused.launches = 0
torsion_energy_grad.launches = 0


def gather_torsion_positions(xyz: torch.Tensor, idxs: torch.Tensor
                             ) -> torch.Tensor:
    """xyz (N, C, 3), idxs (T, 4) -> pos (T, 4, 3, C), contiguous (the
    kernel's layout)."""
    return xyz.transpose(1, 2).contiguous()[idxs]
