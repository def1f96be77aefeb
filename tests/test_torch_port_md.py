"""The port's molecular dynamics (grappa_tpu_torch.md) against the JAX
package's `grappa_tpu.md` on the CPU, and the JAX package's MD tests
(tests/test_md.py) ported.

Molecules come from each package's own `make_moldata` with the same seed
(equal bit for bit); parameters are the batch's reference parameters, as in
tests/test_md.py. Deterministic runs (NVE, minimisation) start from the same
numpy-made coordinates and velocities in both packages and agree to rtol =
atol = 1e-4 (float32 integration over tens to hundreds of steps, sums in
another order). Langevin noise comes from a torch.Generator, whose numbers
are not JAX's, so the thermostat is checked statistically, as JAX's test
checks it. NVE conservation doubles as a check that the forces are the
gradient of the potential.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grappa_tpu import md as jmd
from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.synthetic import make_moldata as jax_make_moldata
from grappa_tpu_torch import md
from grappa_tpu_torch.data import MolGraph, PadSpec, collate
from grappa_tpu_torch.data.graph_batch import TERMS
from grappa_tpu_torch.data.synthetic import make_moldata

PARAM_KEYS = (('n2_k', 'n2', 'k_ref'), ('n2_eq', 'n2', 'eq_ref'),
              ('n3_k', 'n3', 'k_ref'), ('n3_eq', 'n3', 'eq_ref'),
              ('n4_k', 'n4', 'k_ref'), ('n4_improper_k', 'n4_improper',
                                        'k_ref'))
TOL = dict(rtol=1e-4, atol=1e-4)


def _ref_params(batch):
    """The batch's reference parameters, NaNs (padding) zeroed."""
    return {key: torch.nan_to_num(getattr(batch.terms[t], field))
            for key, t, field in PARAM_KEYS}


def _setup(seed=3, n_confs=1, pad=None):
    mdata = make_moldata(seed=seed, n_confs=n_confs, learnable=True,
                         conf_noise=0.05)
    batch = collate([MolGraph.from_moldata(mdata)], pad=pad, n_confs=n_confs,
                    device='cpu')
    masses = md.masses_from_molecules([mdata.molecule], batch.xyz.shape[0],
                                      device='cpu')
    return mdata, batch, _ref_params(batch), masses


def _jax_setup(seed=3, n_confs=4):
    mdata = jax_make_moldata(seed=seed, n_confs=n_confs, learnable=True,
                             conf_noise=0.05)
    batch = jax_collate([JaxMolGraph.from_moldata(mdata)], n_confs=n_confs)
    params = {key: jnp.nan_to_num(getattr(batch.terms[t], field))
              for key, t, field in PARAM_KEYS}
    masses = jmd.masses_from_molecules([mdata.molecule], batch.xyz.shape[0])
    return batch, params, masses


def _v0(batch, masses, seed, temperature=300.0):
    """Maxwell-Boltzmann velocities made with numpy, for both packages."""
    rng = np.random.default_rng(seed)
    m = np.asarray(masses)
    sigma = np.sqrt(md.KB * temperature / m)[:, None, None]
    v = sigma * rng.normal(size=tuple(batch.xyz.shape))
    return (v * np.asarray(batch.node_mask)[:, None, None]).astype(np.float32)


def test_masses_and_kinetic_energy_equal_jax():
    mdata, batch, _, masses = _setup(n_confs=4)
    jbatch, _, jmasses = _jax_setup(n_confs=4)
    np.testing.assert_array_equal(masses.numpy(), np.asarray(jmasses))
    v = _v0(batch, masses, seed=0)
    np.testing.assert_allclose(
        md.kinetic_energy(batch, masses, torch.tensor(v)).numpy(),
        np.asarray(jmd.kinetic_energy(jbatch, jmasses, jnp.asarray(v))),
        rtol=1e-6)
    assert md.TIME_UNIT_FS == jmd.TIME_UNIT_FS and md.KB == jmd.KB


def test_nve_and_minimize_match_jax():
    """50 velocity-Verlet steps and 300 minimisation steps from the same
    numpy xyz0 / v0 in both packages."""
    _, batch, params, masses = _setup(n_confs=4)
    jbatch, jparams, jmasses = _jax_setup(n_confs=4)
    v0 = _v0(batch, masses, seed=1)
    out = md.simulate(batch, params, masses, dt_fs=0.5, n_steps=50,
                      v0=torch.tensor(v0))
    jout = jmd.simulate(jbatch, jparams, jmasses, dt_fs=0.5, n_steps=50,
                        v0=jnp.asarray(v0))
    for key in ('potential', 'kinetic', 'xyz', 'velocities'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   **TOL, err_msg=key)

    rng = np.random.default_rng(2)
    x0 = (batch.xyz.numpy() + 0.05 * rng.normal(size=batch.xyz.shape)
          ).astype(np.float32)
    x_min = md.minimize(batch, params, n_steps=300, lr=5e-4,
                        xyz0=torch.tensor(x0))
    jx_min = jmd.minimize(jbatch, jparams, n_steps=300, lr=5e-4,
                          xyz0=jnp.asarray(x0))
    np.testing.assert_allclose(x_min.numpy(), np.asarray(jx_min), **TOL)


def test_nve_energy_conservation():
    """Velocity Verlet at 0.2 fs conserves E_tot = KE + PE to a small
    fraction of the energy scale over 800 steps."""
    _, batch, params, masses = _setup()
    v0 = md.maxwell_boltzmann_velocities(batch, masses, 300.0,
                                         torch.Generator().manual_seed(1))
    out = md.simulate(batch, params, masses, dt_fs=0.2, n_steps=800, v0=v0)
    total = (out['potential'][:, 0, 0] + out['kinetic'][:, 0, 0]).numpy()
    drift = np.abs(total - total[0]).max()
    scale = max(np.abs(out['kinetic'][:, 0, 0].numpy()).mean(), 1.0)
    assert np.isfinite(total).all()
    assert drift < 0.05 * scale, (drift, scale)


def test_md_replicas_independent_and_pad_invariant():
    """Conformer columns are independent replicas, and a larger PadSpec
    does not change the dynamics."""
    mdata, batch, params, masses = _setup(n_confs=4)
    v0 = md.maxwell_boltzmann_velocities(batch, masses, 300.0,
                                         torch.Generator().manual_seed(2))
    out = md.simulate(batch, params, masses, dt_fs=0.5, n_steps=50, v0=v0)

    # replica 0 alone reproduces column 0 of the 4-replica run
    b1 = collate([MolGraph.from_moldata(mdata)], n_confs=1, device='cpu')
    out1 = md.simulate(b1, params, masses, dt_fs=0.5, n_steps=50,
                       xyz0=batch.xyz[:, :1], v0=v0[:, :1])
    np.testing.assert_allclose(out1['potential'][:, 0, 0].numpy(),
                               out['potential'][:, 0, 0].numpy(), **TOL)

    # bigger padding -> identical trajectory energies
    big = PadSpec(n_nodes=batch.xyz.shape[0] + 32,
                  n_tuples={t: int(batch.terms[t].mask.shape[0]) + 64
                            for t in TERMS},
                  n_confs=4)
    bbig = collate([MolGraph.from_moldata(mdata)], pad=big, n_confs=4,
                   device='cpu')
    m_big = md.masses_from_molecules([mdata.molecule], bbig.xyz.shape[0],
                                     device='cpu')
    n = batch.xyz.shape[0]
    v_big = torch.zeros_like(bbig.xyz)
    v_big[:n] = v0
    x_big = torch.zeros_like(bbig.xyz)
    x_big[:n] = batch.xyz
    out_big = md.simulate(bbig, _ref_params(bbig), m_big, dt_fs=0.5,
                          n_steps=50, xyz0=x_big, v0=v_big)
    np.testing.assert_allclose(out_big['potential'][:, 0].numpy(),
                               out['potential'][:, 0].numpy(), **TOL)
    # padded atoms never move
    assert torch.all(out_big['xyz'][n:] == 0)


def test_langevin_thermalizes():
    """BAOAB at 300 K: mean kinetic energy approaches (3N/2) kT."""
    mdata, batch, params, masses = _setup(seed=5)
    n_atoms = len(mdata.molecule.atoms)
    out = md.simulate(batch, params, masses, dt_fs=0.5, n_steps=1500,
                      temperature=300.0, friction_per_ps=20.0, seed=7)
    ke = out['kinetic'][:, 0, 0].numpy()
    target = 1.5 * n_atoms * md.KB * 300.0
    mean_ke = ke[500:].mean()   # after equilibration
    assert np.isfinite(ke).all()
    assert 0.6 * target < mean_ke < 1.4 * target, (mean_ke, target)


def test_trajectory_recording_and_minimize():
    _, batch, params, masses = _setup(seed=9)
    out = md.simulate(batch, params, masses, dt_fs=0.5, n_steps=40,
                      temperature=300.0, seed=3, record_every=10)
    assert out['trajectory'].shape == (4,) + tuple(batch.xyz.shape)
    assert out['potential'].shape[0] == 40
    # the last frame is the final position
    assert torch.equal(out['trajectory'][-1], out['xyz'])
    with pytest.raises(ValueError, match='multiple'):
        md.simulate(batch, params, masses, n_steps=41, record_every=10)

    # jitter the geometry, minimize -> potential decreases
    x0 = batch.xyz + 0.05 * torch.randn(batch.xyz.shape,
                                        generator=torch.Generator()
                                        .manual_seed(0))
    force = md.make_force_fn(batch, params)
    _, e_before = force(x0)
    x_min = md.minimize(batch, params, n_steps=300, lr=5e-4, xyz0=x0)
    _, e_after = force(x_min)
    assert float(e_after[0, 0]) < float(e_before[0, 0])
