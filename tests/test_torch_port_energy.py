"""The port's MM energy path (grappa_tpu_torch.models.geometry, mm_energy,
data.moldata, data.synthetic, MolGraph.from_moldata) against the JAX
package's on the CPU.

Molecules come from each package's own `make_moldata` with the same seeds
(their arrays must be equal, bit for bit) and cross over through
`MolData.to_dict` / `from_dict`. Parameter dicts are seeded numpy arrays
handed to both. Tolerances: energies, gradients and pooled terms rtol 1e-5,
atol 1e-5 (float32 with sums in another order); the double backward
(gradient w.r.t. the parameters of sum (dE/dx)^2) per-leaf relative L2
error <= 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.graph_batch import TERMS
from grappa_tpu.data.synthetic import make_moldata as jax_make_moldata
from grappa_tpu.models import mm_energy as jmm
from grappa_tpu_torch.data import MolGraph, PadSpec, collate
from grappa_tpu_torch.data.moldata import MolData
from grappa_tpu_torch.data.synthetic import make_moldata
from grappa_tpu_torch.models import geometry, mm_energy
from grappa_tpu_torch.train.loss import LossWeights, molwise_loss

TOL = dict(rtol=1e-5, atol=1e-5)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a, b, equal_nan=a.dtype.kind == 'f'))


def _batches(seeds, n_confs=4, pad=None):
    jmds = [jax_make_moldata(seed=s, n_confs=n_confs) for s in seeds]
    tmds = [MolData.from_dict(m.to_dict()) for m in jmds]
    jb = jax_collate([JaxMolGraph.from_moldata(m) for m in jmds],
                     n_confs=n_confs)
    tb = collate([MolGraph.from_moldata(m) for m in tmds], pad=pad,
                 n_confs=n_confs, device='cpu')
    return jmds, jb, tb


def _params(batch, seed=0, n_per=(6, 3)):
    """Seeded parameters shaped like the model's output for `batch`."""
    rng = np.random.default_rng(seed)
    n = {t: batch.terms[t].idxs.shape[0] for t in TERMS}
    return {
        'n2_k': rng.uniform(300, 900, n['n2']), 'n2_eq':
        rng.uniform(1.0, 1.6, n['n2']),
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


@pytest.mark.parametrize('seed,learnable', [(0, False), (7, False),
                                            (123, False), (3, True)])
def test_make_moldata_equals_jax(seed, learnable):
    a = jax_make_moldata(seed=seed, n_confs=4, learnable=learnable).to_dict()
    b = make_moldata(seed=seed, n_confs=4, learnable=learnable).to_dict()
    assert set(a) == set(b)
    for key in a:
        assert _equal(a[key], b[key]), key


def test_moldata_round_trips_through_npz(tmp_path):
    md = make_moldata(seed=2, n_confs=3)
    md.save(tmp_path / 'md.npz')
    back = MolData.load(tmp_path / 'md.npz').to_dict()
    for key, val in md.to_dict().items():
        assert _equal(val, back[key]), key


def test_from_moldata_and_collate_equal_jax():
    _, jb, tb = _batches([0, 1, 2])
    for t in TERMS:
        for field in ('idxs', 'mask', 'mol', 'k_ref', 'eq_ref'):
            a, b = getattr(jb.terms[t], field), getattr(tb.terms[t], field)
            if a is None:
                assert b is None
                continue
            assert np.array_equal(np.asarray(a), b.numpy(), equal_nan=True)
    for field in ('node_mask', 'node_mol', 'neighbors', 'neighbor_mask',
                  'xyz', 'conf_mask', 'energy_ref', 'gradient_ref'):
        assert np.array_equal(np.asarray(getattr(jb, field)),
                              getattr(tb, field).numpy()), field
    for name, v in jb.feats.items():
        assert np.array_equal(np.asarray(v), tb.feats[name].numpy()), name
    np.testing.assert_array_equal(np.asarray(jb.atoms_per_mol()),
                                  tb.atoms_per_mol().numpy())


def test_geometry_matches_jax():
    from grappa_tpu.models import geometry as jgeo
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 1.5, (4, 50, 3)).astype(np.float32)
    pts[:, 0] = 0.0                      # degenerate: all four points equal
    tp = [torch.tensor(x) for x in pts]
    for name, args in (('distance', 2), ('bond_angle', 3),
                       ('dihedral_angle', 4)):
        got = getattr(geometry, name)(*tp[:args]).numpy()
        want = np.asarray(getattr(jgeo, name)(*pts[:args]))
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def test_internal_coordinates_match_jax():
    """internal_coordinates: each term's bond lengths, angles and proper /
    improper dihedrals (T, C) on a seeded two-molecule batch, against the
    JAX package's at atol 1e-5 + rtol 1e-5 (float32 geometry)."""
    _, jb, tb = _batches([3, 8], n_confs=5)
    got = mm_energy.internal_coordinates(tb, tb.xyz)
    want = jmm.internal_coordinates(jb, jb.xyz)
    assert set(got) == set(want) == set(TERMS)
    for t in TERMS:
        assert got[t].shape == tuple(want[t].shape), t
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   rtol=1e-5, atol=1e-5, err_msg=t)


def test_energy_and_gradient_match_jax_and_the_oracle():
    jmds, jb, tb = _batches([0, 1, 2, 3])
    p = _params(jb)
    e, g = mm_energy.energy_and_gradient(tb, _torch(p))
    je, jg = jmm.energy_and_gradient(jb, _jax(p))
    np.testing.assert_allclose(e.numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-4)
    for key, v in mm_energy.pooled_energy(tb, _torch(p), tb.xyz).items():
        np.testing.assert_allclose(
            v.numpy(), np.asarray(jmm.pooled_energy(jb, _jax(p),
                                                    jb.xyz)[key]),
            **TOL, err_msg=key)
    np.testing.assert_allclose(
        mm_energy.centered(e, tb.conf_mask).numpy(),
        np.asarray(jmm.centered(je, jb.conf_mask)), **TOL)

    # the classical parameters reproduce the float64 oracle's targets
    ref = {k: torch.nan_to_num(getattr(tb.terms[k[:-3] if k.endswith('_eq')
                                                else k[:-2]],
                                       'eq_ref' if k.endswith('_eq')
                                       else 'k_ref'))
           for k in ('n2_k', 'n2_eq', 'n3_k', 'n3_eq', 'n4_k',
                     'n4_improper_k')}
    e_ref, g_ref = mm_energy.energy_and_gradient(tb, ref)
    real = tb.node_mask.numpy()
    np.testing.assert_allclose(
        mm_energy.centered(e_ref, tb.conf_mask).numpy(),
        tb.energy_ref.numpy(), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(g_ref.numpy()[real],
                               tb.gradient_ref.numpy()[real], rtol=1e-3,
                               atol=2e-2)


def test_torsion_offset_and_fused_torsion_flag():
    _, jb, tb = _batches([5])
    p = _params(jb, seed=1)
    for offset in (False, True):
        got = mm_energy.pooled_energy(tb, _torch(p), tb.xyz, offset)
        want = jmm.pooled_energy(jb, _jax(p), jb.xyz, offset)
        np.testing.assert_allclose(got['energy_n4'].numpy(),
                                   np.asarray(want['energy_n4']), **TOL)
        # use_fused_torsion: K5's path (its plain version here), or the
        # Chebyshev path under the offset, as in the JAX package
        fused = mm_energy.pooled_energy(tb, _torch(p), tb.xyz, offset,
                                        use_fused_torsion=True)
        for key in want:
            np.testing.assert_allclose(fused[key].numpy(),
                                       np.asarray(want[key]), **TOL,
                                       err_msg=key)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_double_backward_matches_jax_grad_of_grad():
    """d/dparams of sum((dE/dx)^2): the loss's path through the gradient."""
    _, jb, tb = _batches([0, 1])
    p = _params(jb, seed=2)

    tp = _torch(p, grad=True)
    _, g = mm_energy.energy_and_gradient(tb, tp)
    got = torch.autograd.grad(torch.square(g).sum(), list(tp.values()))

    def f(pp):
        return jnp.sum(jnp.square(jmm.energy_and_gradient(jb, pp)[1]))
    want = jax.grad(f)(_jax(p))
    for (key, _), a in zip(tp.items(), got):
        assert np.isfinite(a.numpy()).all(), key
        assert _rel_l2(a.numpy(), np.asarray(want[key])) <= 1e-5, key


def test_degenerate_geometry_stays_finite():
    """All-zero coordinates: finite energy, dE/dx and parameter gradient
    (no jitter, the epsilon-safe geometry)."""
    _, jb, tb = _batches([1])
    tb.xyz = torch.zeros_like(tb.xyz)
    tp = _torch(_params(jb, seed=3), grad=True)
    e, g = mm_energy.energy_and_gradient(tb, tp)
    grads = torch.autograd.grad(e.sum() + torch.square(g).sum(),
                                list(tp.values()))
    assert torch.isfinite(e).all() and torch.isfinite(g).all()
    assert all(torch.isfinite(x).all() for x in grads)


def test_padding_changes_nothing():
    """The same molecule under a larger PadSpec (more atoms, tuples and
    conformers): identical energies and dE/dx on the real atoms and
    conformers, exactly zero dE/dx on padded atoms, and identical loss
    and parameter gradients on the real tuples (zero on padded ones)."""
    weights = LossWeights(1.0, 0.8, 1e-3, 1e-3, 1e-3)
    _, jb, small = _batches([4])
    graphs = [MolGraph.from_moldata(make_moldata(seed=4, n_confs=4))]
    big = collate(graphs, pad=PadSpec(
        n_nodes=small.xyz.shape[0] + 40,
        n_tuples={t: small.terms[t].idxs.shape[0] + 30 for t in TERMS},
        n_confs=6), n_confs=6, device='cpu')
    p = _params(big, seed=5)
    n_small = {t: small.terms[t].idxs.shape[0] for t in TERMS}
    p_small = {k: v[:n_small['n4_improper' if 'improper' in k
                             else k[:2]]] for k, v in p.items()}
    out = []
    for batch, pp in ((small, p_small), (big, p)):
        tp = _torch(pp, grad=True)
        e, g = mm_energy.energy_and_gradient(batch, tp)
        loss, _ = molwise_loss(batch, tp, weights)
        out.append((e, g, loss, torch.autograd.grad(loss,
                                                    list(tp.values()))))
    (e0, g0, l0, d0), (e1, g1, l1, d1) = out
    l0, l1 = float(l0.detach()), float(l1.detach())
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    n, c = g0.shape[0], g0.shape[1]
    real = small.node_mask
    np.testing.assert_allclose(e1[:, :c].detach().numpy(),
                               e0.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g1[:n, :c][real].detach().numpy(),
                               g0[real].detach().numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.all(g1[~big.node_mask] == 0)
    for key, a, b in zip(p, d0, d1):
        t = 'n4_improper' if 'improper' in key else key[:2]
        m = small.terms[t].mask.numpy()
        np.testing.assert_allclose(b[:n_small[t]].numpy()[m],
                                   a.numpy()[m], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
        assert torch.all(b[n_small[t]:] == 0), key
