"""The port's torsion op K5 (grappa_tpu_torch.ops.torsion_kernel), the MM
energy's `use_fused_torsion` path and the streaming evaluator against the
JAX package on the CPU.

On the CPU `torsion_energy_fused` runs its plain version; the autograd
Function that wraps the kernel on the card is exercised here with the plain
forward, so its backward and double backward are checked too (the kernel
itself is held against the plain version in test_torch_port_kernels.py).
Inputs are seeded numpy arrays handed to both packages: those of
tests/test_torsion_kernel.py for the op, and each package's own
`make_moldata` (equal bit for bit) for the MM energy and the evaluator.
Tolerances: the op's forward rtol = atol = 2e-5; dE/dxyz rtol 1e-3 / atol
1e-4 and dE/dk rtol 1e-4 / atol 1e-5; the force loss's double gradient
w.r.t. k rtol 2e-3 / atol 1e-5 (the JAX file's tolerances); MM energy
rtol = atol = 1e-5, dE/dx rtol 1e-5 / atol 1e-4, the double backward
per-leaf relative L2 <= 1e-5 (test_torch_port_energy.py's); evaluator
metrics rtol 1e-5 (sums that cancel to about 0 to 1e-5 of their terms'
scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.graph_batch import TERMS
from grappa_tpu.data.synthetic import make_moldata as jax_make_moldata
from grappa_tpu.models import mm_energy as jmm
from grappa_tpu.ops import torsion_kernel as jtk
from grappa_tpu.train import evaluator as jev
from grappa_tpu_torch.data import MolGraph, collate
from grappa_tpu_torch.data.moldata import MolData
from grappa_tpu_torch.models import mm_energy
from grappa_tpu_torch.ops import torsion_energy_fused
from grappa_tpu_torch.ops import torsion_kernel as tk
from grappa_tpu_torch.train import evaluator

TOL = dict(rtol=1e-5, atol=1e-5)
# dE/dx sums bond terms of a few hundred kcal/mol/A, whose float32 spacing
# is 3e-5: test_torch_port_energy.py's gradient tolerance
GRAD_TOL = dict(rtol=1e-5, atol=1e-4)


def _inputs(seed=0, t=37, c=5, n_atoms=30, n_per=6):
    """tests/test_torsion_kernel.py's make_inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 2.0, size=(n_atoms, c, 3)).astype(np.float32)
    idxs = np.stack([rng.choice(n_atoms, size=4, replace=False)
                     for _ in range(t)]).astype(np.int32)
    k = rng.normal(0, 0.5, size=(t, n_per)).astype(np.float32)
    return xyz, idxs, k


def _torch_energy(xyz, idxs, k):
    return torsion_energy_fused(tk.gather_torsion_positions(xyz, idxs), k)


def _jax_energy(xyz, idxs, k):
    return jtk.torsion_energy_fused(jtk.gather_torsion_positions(xyz, idxs),
                                    k, True)


def test_gather_and_forward_match_jax():
    xyz, idxs, k = _inputs()
    pos = tk.gather_torsion_positions(torch.tensor(xyz),
                                      torch.tensor(idxs).long())
    assert pos.is_contiguous()
    np.testing.assert_array_equal(
        pos.numpy(), np.asarray(jtk.gather_torsion_positions(xyz, idxs)))
    got = torsion_energy_fused(pos, torch.tensor(k))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_jax_energy(xyz, idxs, k)),
                               rtol=2e-5, atol=2e-5)


def test_gradient_matches_jax():
    """d(total energy)/d(xyz) and /d(k) through the gather."""
    xyz, idxs, k = _inputs(seed=1)
    tx = torch.tensor(xyz, requires_grad=True)
    tkk = torch.tensor(k, requires_grad=True)
    _torch_energy(tx, torch.tensor(idxs).long(), tkk).sum().backward()
    gx, gk = jax.grad(lambda a, b: _jax_energy(a, idxs, b).sum(),
                      argnums=(0, 1))(jnp.asarray(xyz), jnp.asarray(k))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(tkk.grad.numpy(), np.asarray(gk), rtol=1e-4,
                               atol=1e-5)


def _force_loss_grad_torch(energy_fn, xyz, idxs, k):
    """d/dk mean((dE/dxyz - 1)^2): the training loss's path through the
    force."""
    tx = torch.tensor(xyz, requires_grad=True)
    tkk = torch.tensor(k, requires_grad=True)
    (force,) = torch.autograd.grad(energy_fn(tx, idxs, tkk).sum(), tx,
                                   create_graph=True)
    (g,) = torch.autograd.grad(torch.mean((force - 1.0) ** 2), tkk)
    return g


def test_double_gradient_matches_jax():
    xyz, idxs, k = _inputs(seed=2, t=11, c=3)

    def loss(kk):
        force = jax.grad(lambda a: _jax_energy(a, idxs, kk).sum())(
            jnp.asarray(xyz))
        return jnp.mean((force - 1.0) ** 2)

    got = _force_loss_grad_torch(_torch_energy, xyz,
                                 torch.tensor(idxs).long(), k)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.grad(loss)(jnp.asarray(k))),
                               rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize('through_function', [False, True])
def test_degenerate_positions_finite(through_function):
    """All-zero xyz: every tuple degenerate, energy and gradients finite
    (cos phi = 1, as atan2's guard gives phi = 0)."""
    xyz = torch.zeros((8, 4, 3), requires_grad=True)
    k = torch.ones((1, 6), requires_grad=True)
    pos = tk.gather_torsion_positions(xyz, torch.tensor([[0, 1, 2, 3]]))
    op = tk.TorsionEnergy.apply if through_function else torsion_energy_fused
    e = op(pos, k)
    (gx,) = torch.autograd.grad(e.sum(), xyz, create_graph=True)
    (gk,) = torch.autograd.grad(gx.square().sum() + e.sum(), k)
    torch.testing.assert_close(e, torch.full((1, 4), 6.0))
    assert torch.isfinite(gx).all() and torch.isfinite(gk).all()


def _via_function(xyz, idxs, k):
    return tk.TorsionEnergy.apply(tk.gather_torsion_positions(xyz, idxs), k)


def _via_plain(xyz, idxs, k):
    return tk.reference_torsion_energy(
        tk.gather_torsion_positions(xyz, idxs), k)


@pytest.mark.parametrize('grad_pos,grad_k', [(True, True), (True, False),
                                             (False, True)])
def test_function_backward_matches_plain_autograd(grad_pos, grad_k):
    """The Function's first-order backward (a call without create_graph, as
    MD forces and evaluation make it) against autograd through the plain
    version; inputs that do not require grad get None."""
    xyz, idxs, k = _inputs(seed=3, t=29, c=4)
    pos = tk.gather_torsion_positions(torch.tensor(xyz),
                                      torch.tensor(idxs).long())
    dy = torch.tensor(np.random.default_rng(4).normal(size=(29, 4)),
                      dtype=torch.float32)
    out = []
    for fn in (tk.TorsionEnergy.apply, tk.reference_torsion_energy):
        p = pos.clone().requires_grad_(grad_pos)
        kk = torch.tensor(k).requires_grad_(grad_k)
        y = fn(p, kk)
        y.backward(dy)
        assert y.grad_fn is not None
        out.append((y.detach(), p.grad, kk.grad))
    (y1, gp1, gk1), (y2, gp2, gk2) = out
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    for a, b, wanted in ((gp1, gp2, grad_pos), (gk1, gk2, grad_k)):
        if wanted:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert a is None and b is None


def test_function_double_backward_reaches_k():
    """Under create_graph=True the Function's backward stays in the graph:
    the force loss's gradient w.r.t. k matches the plain version's."""
    xyz, idxs, k = _inputs(seed=5, t=17, c=3)
    ti = torch.tensor(idxs).long()
    got = _force_loss_grad_torch(_via_function, xyz, ti, k)
    want = _force_loss_grad_torch(_via_plain, xyz, ti, k)
    assert got.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ MM energy
def _batches(seeds, n_confs=4):
    jmds = [jax_make_moldata(seed=s, n_confs=n_confs) for s in seeds]
    tmds = [MolData.from_dict(m.to_dict()) for m in jmds]
    jb = jax_collate([JaxMolGraph.from_moldata(m) for m in jmds],
                     n_confs=n_confs)
    tb = collate([MolGraph.from_moldata(m) for m in tmds], n_confs=n_confs,
                 device='cpu')
    return jb, tb


def _params(batch, seed=0, n_per=(6, 3)):
    """Seeded parameters shaped like the model's output for `batch`."""
    rng = np.random.default_rng(seed)
    n = {t: batch.terms[t].idxs.shape[0] for t in TERMS}
    return {
        'n2_k': rng.uniform(300, 900, n['n2']),
        'n2_eq': rng.uniform(1.0, 1.6, n['n2']),
        'n3_k': rng.uniform(50, 150, n['n3']),
        'n3_eq': rng.uniform(1.7, 2.2, n['n3']),
        'n4_k': rng.normal(0, 1, (n['n4'], n_per[0])),
        'n4_improper_k': rng.normal(0, 1, (n['n4_improper'], n_per[1])),
    }


def _torch(p, grad=False):
    return {k: torch.tensor(np.asarray(v, np.float32), requires_grad=grad)
            for k, v in p.items()}


def _jax(p):
    return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize('offset', [False, True])
def test_fused_torsion_flag_matches_jax_unfused(offset):
    """energy_and_gradient with use_fused_torsion=True, and its double
    backward, against the JAX package's Chebyshev path (its fused path needs
    a TPU); with offset_torsion=True the port takes the Chebyshev path, as
    the JAX package does. (pooled_energy's parity under the flag is
    test_torch_port_energy.py::test_torsion_offset_and_fused_torsion_flag.)"""
    jb, tb = _batches([0, 1, 2])
    p = _params(jb, seed=7)
    e, g = mm_energy.energy_and_gradient(tb, _torch(p), offset, True)
    je, jg = jmm.energy_and_gradient(jb, _jax(p), offset)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL)

    tp = _torch(p, grad=True)
    _, g = mm_energy.energy_and_gradient(tb, tp, offset, True)
    grads = torch.autograd.grad(torch.square(g).sum(), list(tp.values()))
    want = jax.grad(lambda pp: jnp.sum(jnp.square(
        jmm.energy_and_gradient(jb, pp, offset)[1])))(_jax(p))
    for key, a in zip(tp, grads):
        assert np.isfinite(a.numpy()).all(), key
        assert _rel_l2(a.numpy(), np.asarray(want[key])) <= 1e-5, key


# ------------------------------------------------------------ evaluator
def _evaluator_inputs():
    jb, tb = _batches([3, 4, 5, 6])
    p = _params(jb, seed=8)
    e, g = mm_energy.energy_and_gradient(tb, _torch(p),
                                         use_fused_torsion=True)
    return jb, tb, e, g


def test_evaluator_pool_and_early_stopping_match_jax():
    jb, tb, e, g = _evaluator_inputs()
    names = ['spice', 'rna', 'spice', 'pepconf']
    ours, theirs = evaluator.StreamingEvaluator(), jev.StreamingEvaluator()
    for ev, batch, ee, gg in ((ours, tb, e, g),
                              (theirs, jb, jnp.asarray(e.numpy()),
                               jnp.asarray(g.numpy()))):
        ev.step(batch, ee, gg, names)
        ev.step(batch, ee * 1.01, gg * 0.9, names[::-1])
    got, want = ours.pool(reset=False), theirs.pool(reset=False)
    assert set(got) == set(want) == {'spice', 'rna', 'pepconf', 'avg'}
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for key, v in want[name].items():
            assert np.isfinite(got[name][key])
            np.testing.assert_allclose(got[name][key], v, rtol=1e-5,
                                       err_msg=f'{name}.{key}')
    np.testing.assert_allclose(evaluator.early_stopping_loss(got),
                               jev.early_stopping_loss(want), rtol=1e-5)
    assert evaluator.early_stopping_loss(ours.pool()) > 0
    assert ours.pool() == {}
    assert evaluator.early_stopping_loss({}) == float('inf')


def test_per_mol_full_stats_match_jax():
    jb, tb, e, g = _evaluator_inputs()
    got = evaluator._per_mol_full_stats(tb, e, g)
    want = jev._per_mol_full_stats(jb, jnp.asarray(e.numpy()),
                                   jnp.asarray(g.numpy()))
    assert set(got) == set(want)
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    # the two reference sums cancel to about 0, so they are held to 1e-5 of
    # sum |term| <= sqrt(count * sum term^2), the scale of their rounding
    atol = {'eref_sum': np.sqrt(want['n_e'] * want['eref_sq']).max(),
            'gref_sum': np.sqrt(3 * want['n_vec'] * want['gref_sq']).max()}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-5,
                                   atol=1e-5 * atol.get(key, 0.0),
                                   err_msg=key)
