"""Internal-coordinate geometry: bond lengths, bond angles, dihedrals.

Counterpart of `grappa_tpu.models.geometry`: distances as L2 norms, angles
as atan2(|r0 x r1|, r0.r1), dihedrals in the atan2 form with the central
bond normalised. Degenerate inputs are made safe deterministically, with no
random jitter: the norm carries an epsilon, and atan2 of a vanishing pair
gives 0 with zero gradient. The guard selects on atan2's *inputs* (as the
JAX package does), so the double backward the training loss takes through
dE/dx stays finite.

All functions take stacked coordinates (..., 3) and batch over the leading
dimensions (tuples x conformers).
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a finite gradient at zero.

    The square root is taken in float64 and rounded back, which is the
    correctly rounded float32 one on every device (on the CPU torch takes
    float32 sqrt from MKL's vector math, which on some hosts is an ulp off
    in about one case in seven)."""
    sq = (x * x).sum(dim=dim) + _EPS
    return torch.sqrt(sq.double()).to(sq.dtype)


def distance(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between two point sets, shape (...,)."""
    return safe_norm(x0 - x1)


def _safe_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 that returns 0 with zero gradient when both arguments vanish."""
    degenerate = (x * x + y * y) < _EPS
    x_safe = torch.where(degenerate, torch.ones_like(x), x)
    y_safe = torch.where(degenerate, torch.zeros_like(y), y)
    return torch.atan2(y_safe, x_safe)


def _vector_angle(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    cross = torch.cross(r0, r1, dim=-1)
    return _safe_atan2(safe_norm(cross), (r0 * r1).sum(dim=-1))


def bond_angle(x0: torch.Tensor, x1: torch.Tensor,
               x2: torch.Tensor) -> torch.Tensor:
    """Angle at x1 spanned by x0 and x2, in radians (0..pi)."""
    return _vector_angle(x1 - x0, x1 - x2)


def dihedral_angle(x0: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                   x3: torch.Tensor) -> torch.Tensor:
    """Signed dihedral of the 4 points around the x1-x2 axis, in (-pi, pi]."""
    r01 = x1 - x0
    r21 = x1 - x2
    r23 = x3 - x2
    n1 = torch.cross(r01, r21, dim=-1)
    n2 = torch.cross(r21, r23, dim=-1)
    rkj_normed = r21 / safe_norm(r21)[..., None]
    y = (torch.cross(n1, n2, dim=-1) * rkj_normed).sum(dim=-1)
    x = (n1 * n2).sum(dim=-1)
    return _safe_atan2(y, x)
