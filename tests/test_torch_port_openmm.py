"""The port's OpenMM, OpenFF and Kimmdy wrappers, its mapped-SMILES parser,
`MolData.from_smiles` and `assign_torsion_parameters` against the JAX
package's, on the CPU (device='cpu').

openmm, openff.toolkit, rdkit and kimmdy run through the repo's doubles
(tests/openmm_double.py, openff_double.py, kimmdy_double.py), installed for
this module as the JAX package's own tests install them. Both packages'
wrappers run on the same double objects; the model's predictions come from
one pair of force fields on the same weights (the small config, the flax
init moved by seeded numpy noise, crossing over as the JAX package exports
it). Everything outside the model is the same arithmetic in both packages
and is compared exactly; predicted parameters at the predict tolerance
(rtol 1e-4 / atol 1e-5 in grappa units), torsion entries that the hard
cutoff (|k| > 1e-4) zeroes on one side only left out. The double's
energies are finite differences in Python, so the energy paths run on a
7-atom molecule and two conformers.
"""
import copy
import sys

import jax
import numpy as np
import pytest

import kimmdy_double
import openff_double
import openmm_double
from test_openmm_wrapper import (_capped_hyp_pdb, build_system,
                                 build_topology, improper_sets)

from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data import moldata as jmoldata
from grappa_tpu.data import parameters as jparameters
from grappa_tpu.data import smiles as jsmiles
from grappa_tpu.data.synthetic import (embed_conformers, random_molecule,
                                       random_parameters)
from grappa_tpu.models.grappa_model import get_small_model_config, make_model
from grappa_tpu.train.export import build_model_dict
from grappa_tpu.wrappers import hyp_dop as jhyp
from grappa_tpu.wrappers import kimmdy_adapter as jkim
from grappa_tpu.wrappers import openff_utils as joff
from grappa_tpu.wrappers import openmm_wrapper as jomm
from grappa_tpu.wrappers import star_forcefield as jstar
from grappa_tpu.wrappers.gromacs_wrapper import (
    ANGLE_EQ_FACTOR, ANGLE_K_FACTOR, BOND_EQ_FACTOR, BOND_K_FACTOR,
    TORSION_K_FACTOR, TORSION_PHASE_FACTOR)
from grappa_tpu_torch.data import moldata as tmoldata
from grappa_tpu_torch.data import parameters as tparameters
from grappa_tpu_torch.data import smiles as tsmiles
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.wrappers import hyp_dop as thyp
from grappa_tpu_torch.wrappers import kimmdy_adapter as tkim
from grappa_tpu_torch.wrappers import openff_utils as toff
from grappa_tpu_torch.wrappers import openmm_wrapper as tomm
from grappa_tpu_torch.wrappers import star_forcefield as tstar

RTOL, ATOL, CUTOFF = 1e-4, 1e-5, 1e-4
# (seed, n_atoms) of random_molecule(charge_model='amber99'): the 14-atom
# molecule of tests/test_openmm_wrapper.py and a 7-atom one with an
# improper centre; in neither does an improper's atom set form a proper
SYSTEMS = {'mol14': (12, 14), 'mol7': (0, 7)}
ETHANOL = '[C:1]([H:4])([H:5])([H:6])[C:2]([H:7])([H:8])[O:3][H:9]'
METHANOL = '[C:1]([H:3])([H:4])([H:5])[O:2][H:6]'
RINGY = ('[C:1]1([H:6])([H:7])[C:2]([H:8])=[C:3]([H:9])[C:4]([H:10])='
         '[C:5]1[H:11]')
FORMAMIDE = '[C:1](=[O:2])([N:3]([H:5])[H:6])[H:4]'
BENZENE = ('[c:1]1([H:7])[c:2]([H:8])[c:3]([H:9])[c:4]([H:10])'
           '[c:5]([H:11])[c:6]1[H:12]')


@pytest.fixture(scope='module', autouse=True)
def doubles():
    for double in (openmm_double, openff_double, kimmdy_double):
        double.install()
    yield
    for double in (openmm_double, openff_double, kimmdy_double):
        double.uninstall()


@pytest.fixture(scope='module')
def pair():
    """(JAX OpenmmGrappa, the port's on the CPU) with the same weights."""
    cfg = get_small_model_config()
    model = make_model(cfg)
    batch = jax_collate([JaxMolGraph.from_molecule(random_molecule(seed=0))])
    params = jax.jit(model.init)(jax.random.key(0), batch)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: jax.numpy.asarray(a + rng.normal(0, 0.05, a.shape),
                                    np.float32), jax.device_get(params))
    model_dict = build_model_dict(params, {'model_config': cfg}, model=model)
    return (jomm.OpenmmGrappa(model, params, {'model_config': cfg}),
            tomm.OpenmmGrappa.from_model_dict(model_dict, device='cpu'))


@pytest.fixture(scope='module')
def systems():
    """{name: (molecule, classical parameters, system, topology)}."""
    out = {}
    for name, (seed, n_atoms) in SYSTEMS.items():
        mol = random_molecule(seed=seed, n_atoms=n_atoms,
                              charge_model='amber99')
        params = random_parameters(mol, seed=3)
        out[name] = (mol, params, build_system(mol, params),
                     build_topology(mol))
    return out


def _as_port(p):
    return tparameters.Parameters(**vars(p))


def _port_molecule(mol):
    return Molecule.from_dict(mol.to_dict())


def _mol(m):
    out = {k: np.asarray(getattr(m, k)) for k in (
        'atoms', 'bonds', 'angles', 'propers', 'impropers',
        'atomic_numbers', 'partial_charges')}
    out['features'] = dict(m.additional_features)
    out['charge_model'] = m.charge_model
    return out


def _dump(system):
    """Every force's entries through the openmm API, in grappa units (A,
    rad, kcal/mol): [(force name, [entry, ...]), ...]."""
    import openmm
    import openmm.unit as u
    kcal, ang, rad, e = (u.kilocalorie_per_mole, u.angstrom, u.radian,
                         u.elementary_charge)
    out = []
    for f in system.getForces():
        if isinstance(f, openmm.HarmonicBondForce):
            rows = [(a, b, eq.value_in_unit(ang),
                     k.value_in_unit(kcal / ang ** 2))
                    for a, b, eq, k in map(f.getBondParameters,
                                           range(f.getNumBonds()))]
        elif isinstance(f, openmm.HarmonicAngleForce):
            rows = [(a, b, c, eq.value_in_unit(rad),
                     k.value_in_unit(kcal / rad ** 2))
                    for a, b, c, eq, k in map(f.getAngleParameters,
                                              range(f.getNumAngles()))]
        elif isinstance(f, openmm.PeriodicTorsionForce):
            rows = [(a, b, c, d, n, ph.value_in_unit(rad),
                     k.value_in_unit(kcal))
                    for a, b, c, d, n, ph, k in map(
                        f.getTorsionParameters, range(f.getNumTorsions()))]
        elif isinstance(f, openmm.NonbondedForce):
            rows = [(q.value_in_unit(e), s, eps)
                    for q, s, eps in map(f.getParticleParameters,
                                         range(f.getNumParticles()))]
        else:
            rows = []
        out.append((f.getName(), rows))
    return out


def _dumps_agree(got, want):
    """Two parametrized systems: the classical entries exactly, the
    predicted values at the predict tolerance; torsion entries present on
    one side only (the k cutoff) must sit at the cutoff."""
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        if name == 'grappa_torsions':
            gd = {r[:5]: r[5:] for r in g}
            wd = {r[:5]: r[5:] for r in w}
            for key in gd.keys() & wd.keys():
                np.testing.assert_allclose(gd[key], wd[key], rtol=RTOL,
                                           atol=ATOL, err_msg=str(key))
            lone = [d[key][1] for d, o in ((gd, wd), (wd, gd))
                    for key in d.keys() - o.keys()]
            assert len(lone) <= 2 and all(k <= CUTOFF + ATOL for k in lone)
            continue
        assert len(g) == len(w), name
        for a, b in zip(g, w):
            if name in ('HarmonicBondForce', 'HarmonicAngleForce'):
                n_ids = len(a) - 2
                assert a[:n_ids] == b[:n_ids]
                np.testing.assert_allclose(a[n_ids:], b[n_ids:], rtol=RTOL,
                                           atol=ATOL)
            else:
                assert a == b, name


def test_subtopology_matches_jax(systems):
    from openmm.app import Element
    mol = systems['mol14'][0]
    top = build_topology(mol)
    chain = top.addChain('W')
    wat = top.addResidue('HOH', chain)
    o = top.addAtom('O', Element.getByAtomicNumber(8), wat)
    for name in ('H1', 'H2'):
        top.addBond(o, top.addAtom(name, Element.getByAtomicNumber(1), wat))
    top.addAtom('NA', Element.getByAtomicNumber(11),
                top.addResidue('NA+', chain))
    top.addAtom('X', Element.getByAtomicNumber(6),
                top.addResidue('LIG', chain))

    def view(sub):
        return ([(a.name, a.element.atomic_number, a.id, a.residue.name)
                 for a in sub.atoms()],
                [(a.id, b.id) for a, b in sub.bonds()])
    for exclude in (None, {'lig'}):
        want = view(jomm.get_subtopology(top, exclude))
        got = view(tomm.get_subtopology(top, exclude))
        assert got == want
    assert len(got[0]) == len(mol.atoms)


@pytest.mark.parametrize('name', list(SYSTEMS))
def test_molecule_and_classical_parameters_match_jax(systems, name):
    mol, params, system, top = systems[name]
    for charges in (None, np.linspace(-0.5, 0.5, len(mol.atoms))):
        want = jomm.molecule_from_openmm(system, top, partial_charges=charges)
        got = tomm.molecule_from_openmm(system, top, partial_charges=charges)
        np.testing.assert_equal(_mol(got), _mol(want))
    assert improper_sets(got.impropers) == improper_sets(mol.impropers)
    want = jomm._classical_parameters_from_openmm(system, mol)
    got = tomm._classical_parameters_from_openmm(system, _port_molecule(mol))
    np.testing.assert_equal(vars(got), vars(want))
    np.testing.assert_allclose(got.bond_k, params.bond_k, rtol=1e-6)


@pytest.mark.parametrize('name', list(SYSTEMS))
def test_write_to_system_matches_jax(systems, name):
    mol, _, system, _ = systems[name]
    new = random_parameters(mol, seed=99)
    want = jomm.write_to_system(copy.deepcopy(system), new)
    got = tomm.write_to_system(copy.deepcopy(system), _as_port(new))
    assert _dump(got) == _dump(want)
    for keep, remove in (((), ('Nonbonded',)), (('Nonbonded', 'CMM'), ())):
        assert _dump(tomm.remove_forces_from_system(
            copy.deepcopy(got), keep=keep, remove=remove)) == _dump(
            jomm.remove_forces_from_system(copy.deepcopy(want), keep=keep,
                                           remove=remove))
    charges = np.linspace(-0.3, 0.3, len(mol.atoms))
    assert _dump(tomm.set_partial_charges(copy.deepcopy(got), charges)) \
        == _dump(jomm.set_partial_charges(copy.deepcopy(want), charges))


@pytest.mark.parametrize('name', list(SYSTEMS))
def test_parametrize_system_matches_jax(pair, systems, tmp_path, name):
    jax_ff, ff = pair
    _, _, system, top = systems[name]
    # the port's plots (matplotlib, slow) of the smaller system only
    plots = tmp_path if name == 'mol7' else None
    want = jax_ff.parametrize_system(copy.deepcopy(system), top,
                                     check_eq_values=False)
    got = ff.parametrize_system(copy.deepcopy(system), top,
                                check_eq_values=False, plot_dir=plots)
    _dumps_agree(_dump(got), _dump(want))
    assert plots is None or sorted(p.name for p in plots.iterdir()) == [
        'grappa_parameters.png', 'parameter_comparison.png',
        'reference_parameters.png']


def test_identity_oracle():
    """tests/test_openmm_wrapper.py's identity oracle on the port alone: a
    'model' that predicts the system's own classical parameters, through
    molecule_from_openmm -> predict -> write_to_system, leaves the
    system's energies and gradients as they were (to 1e-3)."""
    seed, n_atoms = SYSTEMS['mol7']
    mol = random_molecule(seed=seed, n_atoms=n_atoms, charge_model='amber99')
    orig = build_system(mol, random_parameters(mol, seed=3))
    xyz = embed_conformers(mol, n_confs=2, seed=21)
    ref_energy, ref_gradient = tomm.get_energies(orig, xyz)

    class IdentityGrappa(tomm.OpenmmGrappa):
        def __init__(self):    # no model needed
            self.config = {}

        def predict(self, molecule, check_eq_values=True):
            return tomm._classical_parameters_from_openmm(orig, molecule)

    system = copy.deepcopy(orig)
    IdentityGrappa().parametrize_system(system, build_topology(mol))
    assert 'grappa_torsions' in [f.getName() for f in system.getForces()]
    energy, gradient = tomm.get_energies(system, xyz)
    np.testing.assert_allclose(energy, ref_energy, atol=1e-3)
    np.testing.assert_allclose(gradient, ref_gradient, atol=1e-3)


def test_moldata_from_openmm_system_matches_jax(systems):
    mol, _, system, top = systems['mol7']
    xyz = embed_conformers(mol, n_confs=2, seed=8)
    rng = np.random.default_rng(0)
    energy = rng.normal(0, 5, size=2)
    gradient = rng.normal(0, 2, size=xyz.shape)
    for grad in (gradient, None):
        want = jomm.moldata_from_openmm_system(
            system, top, xyz, energy, grad, mol_id='m', ff_name='ff')
        got = tomm.moldata_from_openmm_system(
            system, top, xyz, energy, grad, mol_id='m', ff_name='ff')
        assert isinstance(got, tmoldata.MolData)
        np.testing.assert_equal(got.to_dict(), want.to_dict())


def _residues(top, names_zs):
    from openmm.app import Element
    chain = top.addChain('A')
    out = []
    for res, names, zs in names_zs:
        r = top.addResidue(res, chain)
        out.append({n: top.addAtom(n, Element.getByAtomicNumber(z), r)
                    for n, z in zip(names, zs)})
    return out


def test_hyp_dop_and_star_forcefield_match_jax(pair):
    """HYP / DOP bond repair on an ALA-HYP-DOP-ALA chain, the star patch,
    and createSystem + parametrize_system of a capped HYP peptide through
    each package's amber99sbildn*."""
    from openmm.app import Topology
    assert thyp.RESIDUE_BONDS == jhyp.RESIDUE_BONDS
    assert tstar.STAR_RESIDUES == jstar.STAR_RESIDUES
    assert tstar.build_star_patch_xml() == jstar.build_star_patch_xml()
    backbone = (['N', 'CA', 'C', 'O', 'CB'], [7, 6, 6, 8, 6])
    layout = [('ALA', *backbone)]
    for res in ('HYP', 'DOP'):
        names = [a[0] for a in tstar.STAR_RESIDUES[res][0]]
        layout.append((res, names, [6] * len(names)))
    layout.append(('ALA', *backbone))
    added, bonds = [], []
    for mod in (jhyp, thyp):
        top = Topology()
        ala = _residues(top, layout)[0]
        top.addBond(ala['N'], ala['CA'])
        added.append((mod.add_nonstandard_residue_bonds(top),
                      mod.add_nonstandard_residue_bonds(top)))
        bonds.append([(a.index, b.index) for a, b in top.bonds()])
    assert added[0] == added[1] and added[1][1] == 0
    assert bonds[0] == bonds[1]

    jax_ff, ff = pair
    made = []
    for star, grappa in ((jstar, jax_ff), (tstar, ff)):
        top = star.topology_from_pdb(_capped_hyp_pdb())
        system = star.get_openmm_forcefield('amber99sbildn*').createSystem(
            top)
        made.append((_dump(system), [(a.index, b.index)
                                     for a, b in top.bonds()],
                     _dump(grappa.parametrize_system(
                         system, top, check_eq_values=False))))
    assert made[1][:2] == made[0][:2]
    _dumps_agree(made[1][2], made[0][2])


@pytest.mark.parametrize('smiles', [ETHANOL, RINGY, METHANOL])
def test_openff_featurisers_match_jax(smiles):
    off = [mod.get_openff_molecule(smiles) for mod in (joff, toff)]
    assert ([a.atomic_number for a in off[1].atoms]
            == [a.atomic_number for a in off[0].atoms])
    for fn in ('get_sp_hybridization_encoding', 'get_is_aromatic'):
        np.testing.assert_array_equal(getattr(toff, fn)(off[1]),
                                      getattr(joff, fn)(off[0]))
    n = len(off[0].atoms)
    charges = np.linspace(-0.4, 0.4, n).astype(np.float32)
    for o in off:
        o.partial_charges = openff_double.FFQuantity(charges)
    for kwargs in ({}, {'partial_charges': np.zeros(n)},
                   {'impropers': 'amber'}):
        np.testing.assert_equal(
            _mol(toff.molecule_from_openff(off[1], **kwargs)),
            _mol(joff.molecule_from_openff(off[0], **kwargs)))
    np.testing.assert_equal(
        _mol(toff.molecule_from_smiles(smiles, partial_charges=charges)),
        _mol(joff.molecule_from_smiles(smiles, partial_charges=charges)))


@pytest.mark.parametrize('fallback', [False, True])
def test_moldata_from_smiles_matches_jax(monkeypatch, fallback):
    rng = np.random.default_rng(1)
    xyz = rng.uniform(0, 3, (2, 6, 3))
    energy = rng.normal(0, 1, 2)
    gradient = rng.normal(0, 1, (2, 6, 3))
    charges = np.linspace(-0.3, 0.3, 6)
    if fallback:
        def boom(*args, **kwargs):
            raise RuntimeError('no classical parameters')
        monkeypatch.setattr(jomm, 'moldata_from_openmm_system', boom)
        monkeypatch.setattr(tomm, 'moldata_from_openmm_system', boom)
        with pytest.raises(RuntimeError):
            tmoldata.MolData.from_smiles(METHANOL, xyz, energy, gradient,
                                         partial_charges=charges)
    out = [mod.MolData.from_smiles(METHANOL, xyz, energy, gradient,
                                   partial_charges=charges,
                                   allow_nan_params=fallback)
           for mod in (jmoldata, tmoldata)]
    assert isinstance(out[1], tmoldata.MolData)
    assert out[1].mapped_smiles == METHANOL
    np.testing.assert_equal(out[1].to_dict(), out[0].to_dict())
    assert np.isnan(out[1].classical_parameters.bond_k).all() == fallback


SMILES = [ETHANOL, METHANOL, RINGY, FORMAMIDE, BENZENE, '[NH4+].[Cl-]',
          'C%12CC%12', 'C/C=C\\C(=O)Br', '[13CH3:1][Se:2]', 'C1CC',
          '[C:1][C:1]', '1CC1', 'C(C', 'CC)', '*C', '[Xx]', 'C[', 'C$C%1']


@pytest.mark.parametrize('smiles', SMILES)
def test_parse_mapped_smiles_matches_jax(smiles):
    out = []
    for mod in (jsmiles, tsmiles):
        try:
            out.append(mod.parse_mapped_smiles(smiles))
        except mod.SmilesError as e:
            out.append(('SmilesError', str(e)))
    np.testing.assert_equal(out[1], out[0])
    assert issubclass(tsmiles.SmilesError, ValueError)


def _torsion_molecules():
    """tests/test_data_model.py's molecules: a chain 0-1-2-3 with a centre
    1 bonded to 4 (two propers, three improper versions) and a plain
    4-chain."""
    star = dict(atoms=[0, 1, 2, 3, 4], bonds=[(0, 1), (1, 2), (2, 3), (1, 4)],
                impropers=[(0, 2, 1, 4)], atomic_numbers=[6, 6, 6, 6, 8],
                partial_charges=[0.0] * 5)
    chain = dict(atoms=[0, 1, 2, 3], bonds=[(0, 1), (1, 2), (2, 3)],
                 impropers=[], atomic_numbers=[6] * 4,
                 partial_charges=[0.0] * 4)
    return star, chain


def _torsion_cases(mol):
    proper = tuple(int(x) for x in mol.propers[0])
    if not len(mol.impropers):
        return {'negative_pi': ([proper], [1.5], [-np.pi], [2], False),
                'near_two_pi': ([proper, proper], [1.0, 0.5],
                                [2 * np.pi - 1e-3, 0.0], [3, 3], False)}
    imp0 = tuple(int(x) for x in mol.impropers[0])
    anti = (imp0[0], imp0[2], imp0[1], imp0[3])
    return {
        'fold_and_accumulate': ([proper[::-1], proper, anti], [1.0, 0.5, -2.0],
                                [0.0] * 3, [2] * 3, False),
        'conflicting_phases': ([proper, proper], [1.0, 1.0],
                               [0.0, np.pi / 2], [1, 1], False),
        'antisymmetric_phase': ([anti], [1.0], [1.0], [2], False),
        'antisymmetric_skipped': ([anti], [1.0], [1.0], [2], True),
        'no_canonical_tuple': ([(0, 3, 4, 2)], [1.0], [0.0], [1], False),
        'periodicity_too_high': ([proper], [1.0], [0.0], [7], False),
        'improper_twice': ([imp0, imp0], [1.0, 1.0], [0.0, 0.0], [1, 1],
                           False),
    }


TORSION_CASES = [(i, case) for i, mol in enumerate(_torsion_molecules())
                 for case in _torsion_cases(Molecule(**mol))]


@pytest.mark.parametrize('mol_idx,case', TORSION_CASES,
                         ids=[c for _, c in TORSION_CASES])
def test_assign_torsion_parameters_matches_jax(mol_idx, case):
    from grappa_tpu.data.molecule import Molecule as JaxMolecule
    spec = _torsion_molecules()[mol_idx]
    out = []
    for mod, cls in ((jparameters, JaxMolecule), (tparameters, Molecule)):
        torsions, ks, phases, pers, skip = _torsion_cases(cls(**spec))[case]
        try:
            out.append(mod.assign_torsion_parameters(
                cls(**spec), torsions, ks, phases, pers,
                allow_skip_improper=skip))
        except ValueError as e:
            out.append(('ValueError', str(e)))
    np.testing.assert_equal(out[1], out[0])


def test_assign_torsion_parameters_on_engine_torsions(systems):
    """The flat torsion lists of the systems' PeriodicTorsionForce."""
    import openmm
    for mol, _, system, _ in systems.values():
        force = next(f for f in system.getForces()
                     if isinstance(f, openmm.PeriodicTorsionForce))
        rows = [force.getTorsionParameters(i)
                for i in range(force.getNumTorsions())]
        lists = ([tuple(int(x) for x in r[:4]) for r in rows],
                 [r[6].value_in_unit(openmm.unit.kilocalorie_per_mole)
                  for r in rows],
                 [r[5].value_in_unit(openmm.unit.radian) for r in rows],
                 [int(r[4]) for r in rows])
        np.testing.assert_equal(
            tparameters.assign_torsion_parameters(
                _port_molecule(mol), *lists, allow_skip_improper=True),
            jparameters.assign_torsion_parameters(
                mol, *lists, allow_skip_improper=True))


def _kimmdy_view(top):
    out = {}
    for store in ('bonds', 'angles'):
        out[store] = {k: (v.funct, v.c0, v.c1)
                      for k, v in getattr(top, store).items()}
    for store in ('proper_dihedrals', 'improper_dihedrals'):
        out[store] = {k: (v.funct, {n: (d.funct, d.c0, d.c1, d.periodicity)
                                    for n, d in v.dihedrals.items()})
                      for k, v in getattr(top, store).items()}
    return out


def _kimmdy_agree(got, want):
    """Keys, functs and periodicities exactly; each written value at the
    predict tolerance times its unit factor plus half a printed unit."""
    def close(a, b, factor, decimals):
        if a is None or b is None:
            assert a == b
            return
        tol = ATOL * factor + RTOL * abs(float(b)) + 0.5 * 10 ** -decimals
        assert abs(float(a) - float(b)) <= tol, (a, b)

    for store, (f0, d0), (f1, d1) in (
            ('bonds', (BOND_EQ_FACTOR, 6), (BOND_K_FACTOR, 4)),
            ('angles', (ANGLE_EQ_FACTOR, 4), (ANGLE_K_FACTOR, 4))):
        assert got[store].keys() == want[store].keys()
        for key, (funct, c0, c1) in got[store].items():
            assert funct == want[store][key][0]
            close(c0, want[store][key][1], f0, d0)
            close(c1, want[store][key][2], f1, d1)
    for store in ('proper_dihedrals', 'improper_dihedrals'):
        assert got[store].keys() == want[store].keys()
        for key, (funct, dih) in got[store].items():
            w_funct, w_dih = want[store][key]
            assert funct == w_funct and dih.keys() == w_dih.keys()
            for n, (f, c0, c1, per) in dih.items():
                wf, wc0, wc1, wper = w_dih[n]
                assert (f, per) == (wf, wper)
                if (abs(float(c1)) / TORSION_K_FACTOR > CUTOFF) != (
                        abs(float(wc1)) / TORSION_K_FACTOR > CUTOFF):
                    continue
                close(c0, wc0, TORSION_PHASE_FACTOR, 4)
                close(c1, wc1, TORSION_K_FACTOR, 6)


def test_build_molecule_from_kimmdy_matches_jax():
    mol = random_molecule(seed=4, n_atoms=12, charge_model='amber99')
    top = kimmdy_double.topology_from_molecule(mol, radicals=[3])
    for nrs in (None, {'1', '2', '3'}, {'2', '3', '4', '5', '9'}):
        np.testing.assert_equal(
            _mol(tkim.build_molecule_from_kimmdy(top, nrs)),
            _mol(jkim.build_molecule_from_kimmdy(top, nrs)))


@pytest.mark.parametrize('focus', [None, {'1'}], ids=['full', 'partial'])
def test_kimmdy_parameterizer_matches_jax(pair, focus):
    jax_ff, ff = pair
    mol = random_molecule(seed=7, n_atoms=24, charge_model='amber99')
    views = []
    for mod, grappa in ((jkim, jax_ff), (tkim, ff)):
        top = kimmdy_double.topology_from_molecule(mol)
        parameterizer = mod.make_kimmdy_parameterizer(grappa)()
        assert parameterizer.parameterize_topology(top, focus) is top
        views.append(_kimmdy_view(top))
    _kimmdy_agree(views[1], views[0])
    rewritten = [k for k, v in views[1]['bonds'].items() if v[1] is not None]
    assert 0 < len(rewritten) <= len(views[1]['bonds'])
    assert (len(rewritten) < len(views[1]['bonds'])) == (focus is not None)


ENGINE_CALLS = {
    'openmm': [
        lambda m: m['omm'].get_subtopology(None),
        lambda m: m['omm'].molecule_from_openmm(None, None),
        lambda m: m['omm'].write_to_system(None, None),
        lambda m: m['omm'].get_energies(None, None),
        lambda m: m['omm'].remove_forces_from_system(None, keep=('x',)),
        lambda m: m['omm'].set_partial_charges(None, []),
        lambda m: m['omm'].OpenmmGrappa.parametrize_system(None, None, None),
        lambda m: m['omm'].moldata_from_openmm_system(None, None, None, None),
        lambda m: m['hyp'].add_nonstandard_residue_bonds(None),
        lambda m: m['star'].get_openmm_forcefield('amber99sbildn*'),
        lambda m: m['star'].topology_from_pdb(''),
    ],
    'openff': [
        lambda m: m['off'].get_openff_molecule(ETHANOL),
        lambda m: m['off'].get_openmm_system(ETHANOL),
        lambda m: m['off'].molecule_from_openff(None),
        lambda m: m['off'].molecule_from_smiles(ETHANOL),
        lambda m: m['md'].MolData.from_smiles(ETHANOL, None, None),
    ],
    'rdkit': [lambda m: m['off'].get_sp_hybridization_encoding(None),
              lambda m: m['off'].get_is_aromatic(None)],
    'kimmdy': [lambda m: m['kim'].build_molecule_from_kimmdy(None),
               lambda m: m['kim'].make_kimmdy_parameterizer(None)],
}
BLOCKED = {'openmm': ('openmm', 'openmm.app', 'openmm.unit'),
           'openff': ('openff', 'openff.toolkit'),
           'rdkit': ('rdkit',), 'kimmdy': ('kimmdy',)}


@pytest.mark.parametrize('engine', list(ENGINE_CALLS))
def test_missing_engine_raises_like_jax(monkeypatch, engine):
    """Without the engine each entry point raises the JAX package's clear
    ImportError, and nothing is emulated."""
    for name in BLOCKED[engine]:
        monkeypatch.setitem(sys.modules, name, None)
    packages = [dict(omm=jomm, hyp=jhyp, star=jstar, off=joff, kim=jkim,
                     md=jmoldata),
                dict(omm=tomm, hyp=thyp, star=tstar, off=toff, kim=tkim,
                     md=tmoldata)]
    for call in ENGINE_CALLS[engine]:
        messages = []
        for mods in packages:
            with pytest.raises(ImportError) as err:
                call(mods)
            messages.append(str(err.value))
        assert messages[1] == messages[0]
        assert engine in messages[1]
