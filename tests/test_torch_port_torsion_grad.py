"""K5b, the backward of the port's torsion op, against the JAX package on the
CPU.

The JAX package's backward of `torsion_energy_fused` is `jax.vjp` of
`_energy_jnp` (its interpret path). Held against it here:
- `reference_torsion_energy_grad`, K5b's plain version (dpos and dk);
- a numpy float32 rehearsal of K5b's own arithmetic, written out step by
  step as `csrc/torsion.cu` does it: the trig-free U recurrence for
  dE/dphi, the hand backpropagation through atan2's inputs, the
  normalised r21 and the cross products, and dk's per-lane sums and
  segmented shuffle tree in the kernel's order (the kernel itself runs
  only on the card: test_torch_port_kernels.py);
- the K5b autograd Function (`torsion_energy_grad`) on CPU tensors, first
  and second order, against plain autograd through the plain version.
Inputs are seeded numpy arrays with degenerate tuples (four equal atoms,
every 7th) and zeroed k rows (every 5th), P in {1, 3, 6} and C in {1, 4,
32}; the rehearsal also at P = 10 (two passes of dk's chunk of 8) and C =
5 and 40 (partly filled warps; lanes walking two conformers).

Tolerance: gradients max |got - want| <= 1e-4 x max |want| per tensor (the
rule chip_smoke.py holds K5b to: near-collinear tuples have large
gradients in both versions, so an elementwise rule would be set by their
rounding); the Function against the plain version it wraps, 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu.ops import torsion_kernel as jtk
from grappa_tpu_torch.ops import torsion_kernel as tk

GRAD_RTOL = 1e-4
F32 = np.float32


def _inputs(t, c, n_per, seed=0):
    """pos (T, 4, 3, C), k (T, P), g (T, C) float32: distinct atoms, every
    7th tuple degenerate, every 5th k row zero."""
    rng = np.random.default_rng(seed)
    n_atoms = max(8, t)
    xyz = rng.normal(0, 2.0, size=(n_atoms, c, 3)).astype(F32)
    idxs = np.stack([rng.choice(n_atoms, size=4, replace=False)
                     for _ in range(t)])
    idxs[::7] = idxs[::7, :1]
    k = rng.normal(0, 0.5, size=(t, n_per)).astype(F32)
    k[::5] = 0.0
    g = rng.normal(size=(t, c)).astype(F32)
    pos = np.ascontiguousarray(xyz[idxs].transpose(0, 1, 3, 2))
    return pos, k, g


@jax.jit
def _jax_vjp(pos, k, g):
    return jax.vjp(jtk._energy_jnp, pos, k)[1](g)


def _jax_grad(pos, k, g):
    return [np.asarray(x) for x in _jax_vjp(pos, k, g)]


def _assert_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= GRAD_RTOL * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize('c', [1, 4, 32])
@pytest.mark.parametrize('n_per', [1, 3, 6])
def test_reference_grad_matches_jax_vjp(n_per, c):
    pos, k, g = _inputs(29, c, n_per, seed=n_per * 10 + c)
    dpos, dk = tk.reference_torsion_energy_grad(
        torch.tensor(pos), torch.tensor(k), torch.tensor(g))
    want_pos, want_k = _jax_grad(pos, k, g)
    _assert_close(dpos.numpy(), want_pos, 'dpos')
    _assert_close(dk.numpy(), want_k, 'dk')
    # degenerate tuples: zero gradient, as atan2's guard gives
    assert (dpos.numpy()[::7] == 0).all()
    dpos_only, none = tk.reference_torsion_energy_grad(
        torch.tensor(pos), torch.tensor(k), torch.tensor(g), need_k=False)
    assert none is None
    np.testing.assert_array_equal(dpos_only.numpy(), dpos.numpy())


# ------------------------------------------------- K5b's arithmetic, numpy
def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _k5b_numpy(pos, k, g, chunk=8):
    """K5b in float32, as torsion_grad_kernel computes it, over all (tuple,
    conformer) at once; returns (dpos, dk)."""
    t, _, _, c = pos.shape
    n_per = k.shape[1]
    q = [[pos[:, a, d, :] for d in range(3)] for a in range(4)]
    r01 = [q[1][d] - q[0][d] for d in range(3)]
    r21 = [q[1][d] - q[2][d] for d in range(3)]
    r23 = [q[3][d] - q[2][d] for d in range(3)]
    n1, n2 = _cross(r01, r21), _cross(r21, r23)
    m = _cross(n1, n2)
    norm21 = np.sqrt(_dot(r21, r21) + F32(1e-12))
    y = _dot(m, r21) / norm21
    x = _dot(n1, n2)
    r2 = x * x + y * y
    degenerate = r2 < F32(1e-12)
    r2_safe = np.where(degenerate, F32(1), r2)
    cos_phi = np.where(degenerate, F32(1), x / np.sqrt(r2_safe))

    # s = sum_n n k_n U_(n-1)(cos phi); dE/dphi = -sin phi s
    u_prev, u_cur = np.zeros_like(x), np.ones_like(x)
    s = np.zeros_like(x)
    for n in range(1, n_per + 1):
        s = s + F32(n) * k[:, n - 1, None] * u_cur
        u_prev, u_cur = u_cur, F32(2) * cos_phi * u_cur - u_prev
    g_phi = -g * s * y / np.sqrt(r2_safe)
    # atan2: dphi/dx = -y / r2, dphi/dy = x / r2; 0 where degenerate
    gx = np.where(degenerate, F32(0), -g_phi * y / r2_safe)
    gy = np.where(degenerate, F32(0), g_phi * x / r2_safe)

    # y = m.u with u = r21 / norm21; x = n1.n2; m = n1 x n2
    u = [r21[d] / norm21 for d in range(3)]
    gm = [gy * u[d] for d in range(3)]
    gu = [gy * m[d] for d in range(3)]
    gn1 = [a + gx * b for a, b in zip(_cross(n2, gm), n2)]
    gn2 = [a + gx * b for a, b in zip(_cross(gm, n1), n1)]
    gu_u = _dot(gu, u)
    gr21 = [(gu[d] - u[d] * gu_u) / norm21 for d in range(3)]
    # n1 = r01 x r21, n2 = r21 x r23
    gr01 = _cross(r21, gn1)
    gr21 = [a + b + e for a, b, e in zip(gr21, _cross(gn1, r01),
                                         _cross(r23, gn2))]
    gr23 = _cross(gn2, r21)
    dpos = np.stack([np.stack(v) for v in (
        [-a for a in gr01],
        [a + b for a, b in zip(gr01, gr21)],
        [-a - b for a, b in zip(gr21, gr23)],
        gr23)])                                    # (4, 3, T, C)
    dpos = dpos.transpose(2, 0, 1, 3)

    # dk[t, n-1] = sum_c g cos(n phi): segments of seg = min(C, 32) lanes
    # a tuple; lane c0 sums conformers c0, c0 + seg, ... in order, then a
    # shuffle tree of offsets 1, 2, 4, 8, 16 into the segment's lane 0;
    # chunk periodicities a pass, the recurrence restarted each pass
    seg = min(c, 32)
    dk = np.zeros_like(k)
    for n0 in range(0, n_per, chunk):
        c_prev, c_cur = np.ones_like(x), cos_phi
        for _ in range(n0):
            c_prev, c_cur = c_cur, F32(2) * cos_phi * c_cur - c_prev
        for j in range(min(chunk, n_per - n0)):
            term = g * c_cur                               # (T, C)
            lanes = np.zeros((t, seg), F32)
            for c_idx in range(c):
                lanes[:, c_idx % seg] += term[:, c_idx]
            o = 1
            while o < 32:
                for p in range(0, seg, 2 * o):
                    if p + o < seg:
                        lanes[:, p] += lanes[:, p + o]
                o *= 2
            dk[:, n0 + j] = lanes[:, 0]
            c_prev, c_cur = c_cur, F32(2) * cos_phi * c_cur - c_prev
    return dpos, dk


@pytest.mark.parametrize('c', [1, 4, 5, 32, 40])
@pytest.mark.parametrize('n_per', [1, 3, 6, 10])
def test_numpy_rehearsal_of_k5b_matches_jax_vjp(n_per, c):
    pos, k, g = _inputs(41, c, n_per, seed=100 + n_per * 10 + c)
    dpos, dk = _k5b_numpy(pos, k, g)
    assert dpos.dtype == F32 and dk.dtype == F32
    want_pos, want_k = _jax_grad(pos, k, g)
    _assert_close(dpos, want_pos, 'dpos')
    _assert_close(dk, want_k, 'dk')
    assert (dpos[::7] == 0).all()
    # zeroed k rows contribute no force, but their dk is still sum g cos
    assert (dpos[::5] == 0).all()
    assert np.abs(dk[::5]).max() > 0


# --------------------------------------------- the autograd Function, CPU
def _leaves(pos, k, g, grads):
    return [torch.tensor(a).requires_grad_(r)
            for a, r in zip((pos, k, g), grads)]


@pytest.mark.parametrize('need_k', [False, True])
def test_grad_function_first_order_matches_plain(need_k):
    """torsion_energy_grad with grad mode off (as a first-order backward
    calls it) and on: the plain version's numbers; dk only when asked."""
    pos, k, g = _inputs(23, 4, 6, seed=7)
    want = tk.reference_torsion_energy_grad(
        torch.tensor(pos), torch.tensor(k), torch.tensor(g), need_k)
    with torch.no_grad():
        got = tk.torsion_energy_grad(torch.tensor(pos), torch.tensor(k),
                                     torch.tensor(g), need_k)
    graph = tk.torsion_energy_grad(*_leaves(pos, k, g, (True,) * 3), need_k)
    assert graph[0].grad_fn is not None
    for out in (got, graph):
        torch.testing.assert_close(out[0].detach(), want[0], rtol=1e-6,
                                   atol=1e-6)
        if need_k:
            torch.testing.assert_close(out[1].detach(), want[1], rtol=1e-6,
                                       atol=1e-6)
        else:
            assert out[1] is None


@pytest.mark.parametrize('grads', [(True, True, True), (True, False, False),
                                   (False, True, False),
                                   (False, False, True)])
def test_grad_function_second_order_matches_plain_autograd(grads):
    """The Function's backward (the plain first-order version's vjp)
    against a double backward through the plain version; inputs that do
    not require grad get None."""
    pos, k, g = _inputs(31, 5, 3, seed=8)
    out = []
    for fn in (tk.torsion_energy_grad, tk.reference_torsion_energy_grad):
        leaves = _leaves(pos, k, g, grads)
        dpos, dk = fn(*leaves, True)
        loss = (dpos - 0.5).square().sum() + (dk * dk.detach()).sum()
        loss.backward()
        out.append([q.grad for q in leaves])
    for a, b, wanted in zip(*out, grads):
        if wanted:
            assert a is not None and torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert a is None and b is None


def test_force_loss_through_k5_and_k5b_matches_jax():
    """d/dk mean((dE/dpos - 1)^2) through TorsionEnergy (backward K5b,
    whose backward is the plain vjp) against the JAX package's fused op
    (interpret mode, backward jax.vjp of _energy_jnp)."""
    pos, k, g = _inputs(19, 4, 6, seed=9)
    tp = torch.tensor(pos, requires_grad=True)
    tkk = torch.tensor(k, requires_grad=True)
    (force,) = torch.autograd.grad(
        (tk.TorsionEnergy.apply(tp, tkk) * torch.tensor(g)).sum(), tp,
        create_graph=True)
    (got,) = torch.autograd.grad(torch.mean((force - 1.0) ** 2), tkk)

    def loss(kk):
        f = jax.grad(lambda p: jnp.sum(
            jtk.torsion_energy_fused(p, kk, True) * g))(jnp.asarray(pos))
        return jnp.mean((f - 1.0) ** 2)

    _assert_close(got.numpy(), np.asarray(jax.grad(loss)(jnp.asarray(k))),
                  'd/dk force loss')
