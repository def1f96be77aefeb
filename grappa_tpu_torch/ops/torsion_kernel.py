"""K5: fused dihedral + periodic-torsion energy, pos (T, 4, 3, C) and signed
k (T, P) -> energy (T, C).

Counterpart of `grappa_tpu/ops/torsion_kernel.py::torsion_energy_fused`:
the dihedral of the four gathered positions, then sum_n k_n cos(n*phi)
with n = column index + 1. Masked or padded tuples must carry zeroed k
rows. `reference_torsion_energy` is the plain version (the JAX package's
`_energy_jnp`).

On CUDA tensors `torsion_energy_fused` launches the hand-written kernel in
`csrc/torsion.cu` (trig-free: cos(phi) and the Chebyshev recurrence, in
registers; the source notes give the card's bound and the design). On CPU
tensors it runs `reference_torsion_energy`, and autograd differentiates it.
`torsion_energy_fused.launches` counts kernel launches.

The backward is not a kernel, as in the JAX package: the vector-Jacobian
product of the plain version at the saved (pos, k). It is itself
differentiable, so the training loss's double backward through dE/dx
reaches k.
"""
from __future__ import annotations

import torch

from grappa_tpu_torch.models import geometry
from grappa_tpu_torch.ops import _cuda


def reference_torsion_energy(pos: torch.Tensor, k: torch.Tensor
                             ) -> torch.Tensor:
    """Plain PyTorch version: pos (T, 4, 3, C), k (T, P) -> (T, C)."""
    phi = geometry.dihedral_angle(*[pos[:, a].movedim(1, -1)
                                    for a in range(4)])
    ns = torch.arange(1, k.shape[1] + 1, dtype=phi.dtype, device=phi.device)
    return (k[:, :, None] * torch.cos(ns[None, :, None] * phi[:, None, :])
            ).sum(dim=1)


def _launch(pos: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    t, _, _, c = pos.shape
    out = torch.empty((t, c), dtype=torch.float32, device=pos.device)
    rc = _cuda.lib().grappa_torsion_energy(
        pos.data_ptr(), k.data_ptr(), out.data_ptr(), t, c, k.shape[1],
        _cuda.stream_of(pos))
    _cuda.check(rc, 'grappa_torsion_energy')
    torsion_energy_fused.launches += 1
    return out


class TorsionEnergy(torch.autograd.Function):
    """The kernel's forward (the plain version on CPU tensors) with the
    plain version's vector-Jacobian product as the backward."""

    @staticmethod
    def forward(ctx, pos, k):
        ctx.save_for_backward(pos, k)
        if pos.is_cuda:
            return _launch(pos, k)
        return reference_torsion_energy(pos, k)

    @staticmethod
    def backward(ctx, g):
        # autograd runs this with grad mode on only under create_graph=True:
        # then the saved inputs stay in the graph, so the gradient is a
        # function of (pos, k) that a second backward differentiates
        create = torch.is_grad_enabled()
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t if create and t.requires_grad
                   else t.detach().requires_grad_(n)
                   for t, n in zip(saved, needs)]
            wrt = [t for t, n in zip(ins, needs) if n]
            if not wrt:
                return None, None
            energy = reference_torsion_energy(*ins)
            grads = iter(torch.autograd.grad(energy, wrt, g,
                                             create_graph=create))
        return tuple(next(grads) if n else None for n in needs)


def _check(pos: torch.Tensor, k: torch.Tensor) -> None:
    if pos.dim() != 4 or pos.shape[1:3] != (4, 3):
        raise ValueError(f"torsion_energy_fused takes pos (T, 4, 3, C), got "
                         f"shape {tuple(pos.shape)}")
    if k.dim() != 2 or k.shape[0] != pos.shape[0] or k.shape[1] < 1:
        raise ValueError(f"torsion_energy_fused takes k (T, P) with T = "
                         f"{pos.shape[0]} and P >= 1, got shape "
                         f"{tuple(k.shape)}")


def torsion_energy_fused(pos: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Fused torsion energy: pos (T, 4, 3, C), signed k (T, P) -> (T, C).

    Equivalent to geometry.dihedral_angle + mm_energy.torsion_term_energy
    (offset=False)."""
    _check(pos, k)
    if not _cuda.on_cuda((pos, k), 'torsion_energy_fused'):
        return reference_torsion_energy(pos, k)
    return TorsionEnergy.apply(pos, k)


torsion_energy_fused.launches = 0


def gather_torsion_positions(xyz: torch.Tensor, idxs: torch.Tensor
                             ) -> torch.Tensor:
    """xyz (N, C, 3), idxs (T, 4) -> pos (T, 4, 3, C), contiguous (the
    kernel's layout)."""
    return xyz.transpose(1, 2).contiguous()[idxs]
