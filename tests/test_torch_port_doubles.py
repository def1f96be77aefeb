"""The port-only doubles (tests/torch_{openmm,openff,kimmdy}_double.py)
against the repo's doubles, and the port's wrappers on them against the JAX
package's wrappers on the JAX package's doubles, on the CPU.

The port's copies differ from the originals only in their imports (the
port's units, mapped-SMILES parser, ring sizes and masses), so that they
run where the JAX package cannot. Each double is installed alone: a
fixture builds the same inputs under one double, then under the other,
and the numbers must agree. Everything outside the model is the same
arithmetic and is compared exactly; predicted parameters at
tests/test_torch_port_openmm.py's tolerances (its `_dumps_agree` and
`_kimmdy_agree`).
"""
import contextlib
import json
from pathlib import Path

import numpy as np
import pytest

import kimmdy_double
import openff_double
import openmm_double
import torch_kimmdy_double
import torch_openff_double
import torch_openmm_double
from test_openmm_wrapper import _capped_hyp_pdb
from test_torch_port_openmm import (ETHANOL, FORMAMIDE, METHANOL, RINGY,
                                    _dump, _dumps_agree, _kimmdy_agree,
                                    _kimmdy_view, _mol)

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu import cli as jcli
from grappa_tpu.data.synthetic import (embed_conformers, random_molecule,
                                       random_parameters)
from grappa_tpu.models.grappa_model import get_small_model_config, make_model
from grappa_tpu.train.export import build_model_dict
from grappa_tpu.wrappers import kimmdy_adapter as jkim
from grappa_tpu.wrappers import openff_utils as joff
from grappa_tpu.wrappers import openmm_wrapper as jomm
from grappa_tpu_torch import cli
from grappa_tpu_torch.constants import ATOMIC_MASSES
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.synthetic import \
    random_molecule as port_random_molecule
from grappa_tpu_torch.wrappers import kimmdy_adapter as tkim
from grappa_tpu_torch.wrappers import openff_utils as toff
from grappa_tpu_torch.wrappers import openmm_wrapper as tomm

JAX = (openmm_double, openff_double, kimmdy_double)
PORT = (torch_openmm_double, torch_openff_double, torch_kimmdy_double)
SMILES = [ETHANOL, METHANOL, RINGY, FORMAMIDE]


@contextlib.contextmanager
def installed(doubles):
    for d in doubles:
        d.install()
    try:
        yield
    finally:
        for d in doubles:
            d.uninstall()


def build_topology(mol, residue='MOL', top=None):
    """The molecule as one residue of an openmm Topology (the installed
    double's)."""
    from openmm.app import Element, Topology
    top = top or Topology()
    res = top.addResidue(residue, top.addChain('A'))
    atoms = [top.addAtom(f'X{i}', Element.getByAtomicNumber(int(z)), res)
             for i, z in enumerate(mol.atomic_numbers)]
    for a, b in mol.bonds_by_index():
        top.addBond(atoms[int(a)], atoms[int(b)])
    return top


def build_system(mols_params, system=None):
    """A System (the installed double's) carrying each molecule's
    classical parameters, atoms in order, with 1-2 / 1-3 exceptions;
    tests/test_openmm_wrapper.py's build_system over several molecules."""
    import openmm
    import openmm.unit as u
    kcal, ang, rad = (u.kilocalorie_per_mole, u.angstrom, u.radian)
    system = openmm.System()
    forces = (openmm.NonbondedForce(), openmm.HarmonicBondForce(),
              openmm.HarmonicAngleForce(), openmm.PeriodicTorsionForce())
    nonbonded, bond_force, angle_force, torsion_force = forces
    off = 0
    for mol, params in mols_params:
        for z, q in zip(mol.atomic_numbers, mol.partial_charges):
            system.addParticle(ATOMIC_MASSES.get(int(z), 12.0))
            nonbonded.addParticle(float(q) * u.elementary_charge,
                                  0.3 * u.nanometer,
                                  0.1 * u.kilojoule_per_mole)
        idx = {k: np.asarray(v) + off
               for k, v in mol.tuple_indices().items()}
        for a, b in idx['n2']:
            nonbonded.addException(int(a), int(b), 0.0, 0.1 * u.nanometer,
                                   0.0)
        for a, _, c in idx['n3']:
            nonbonded.addException(int(a), int(c), 0.0, 0.1 * u.nanometer,
                                   0.0)
        for i, (a, b) in enumerate(idx['n2']):
            bond_force.addBond(int(a), int(b),
                               float(params.bond_eq[i]) * ang,
                               float(params.bond_k[i]) * kcal / ang ** 2)
        for i, (a, b, c) in enumerate(idx['n3']):
            angle_force.addAngle(int(a), int(b), int(c),
                                 float(params.angle_eq[i]) * rad,
                                 float(params.angle_k[i]) * kcal / rad ** 2)
        for tuples, ks, phases in ((idx['n4'], params.proper_ks,
                                    params.proper_phases),
                                   (idx['n4_improper'], params.improper_ks,
                                    params.improper_phases)):
            for i, t in enumerate(tuples):
                for n in range(ks.shape[1]):
                    if np.isnan(ks[i, n]) or ks[i, n] == 0.0:
                        continue
                    torsion_force.addTorsion(*(int(x) for x in t), n + 1,
                                             float(phases[i, n]) * rad,
                                             float(ks[i, n]) * kcal)
        off += len(mol.atoms)
    for f in forces:
        system.addForce(f)
    return system


@pytest.fixture(scope='module')
def pair():
    """(JAX OpenmmGrappa, the port's on the CPU) with the same weights:
    tests/test_torch_port_openmm.py's pair."""
    import jax
    from grappa_tpu.data import MolGraph, collate
    cfg = get_small_model_config()
    model = make_model(cfg)
    batch = collate([MolGraph.from_molecule(random_molecule(seed=0))])
    params = jax.jit(model.init)(jax.random.key(0), batch)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: jax.numpy.asarray(a + rng.normal(0, 0.05, a.shape),
                                    np.float32), jax.device_get(params))
    model_dict = build_model_dict(params, {'model_config': cfg}, model=model)
    return (jomm.OpenmmGrappa(model, params, {'model_config': cfg}),
            tomm.OpenmmGrappa.from_model_dict(model_dict, device='cpu'))


def linked(cls, first, second):
    """One molecule of `first` and `second` joined by a bond between the
    lowest-degree heavy atom of each (atoms renumbered 0.., second's after
    first's), as a Molecule of `cls`; and first's atom count. The OpenMM
    wrapper parametrizes one connected molecule."""
    def anchor(m):
        deg = np.bincount(np.asarray(m.bonds_by_index()).ravel(),
                          minlength=len(m.atoms))
        heavy = [i for i, z in enumerate(m.atomic_numbers) if int(z) > 1]
        return min(heavy, key=lambda i: (deg[i], i))
    n = len(first.atoms)
    bonds = [tuple(int(x) for x in b) for b in first.bonds_by_index()]
    bonds += [tuple(int(x) + n for x in b) for b in second.bonds_by_index()]
    bonds.append((anchor(first), anchor(second) + n))
    ids = {int(a): i for i, a in enumerate(first.atoms)}
    ids2 = {int(a): i + n for i, a in enumerate(second.atoms)}
    impropers = ([tuple(ids[int(x)] for x in t) for t in first.impropers]
                 + [tuple(ids2[int(x)] for x in t)
                    for t in second.impropers])
    return cls(
        atoms=list(range(n + len(second.atoms))), bonds=bonds,
        impropers=impropers,
        atomic_numbers=list(first.atomic_numbers)
        + list(second.atomic_numbers),
        partial_charges=list(first.partial_charges)
        + list(second.partial_charges),
        charge_model='amber99'), n


def _linked_system():
    """A 7-atom residue MOL bonded to a 6-atom residue LIG, with classical
    parameters."""
    from grappa_tpu.data.molecule import Molecule as JaxMolecule
    mol, n = linked(JaxMolecule,
                    random_molecule(seed=0, n_atoms=7,
                                    charge_model='amber99'),
                    random_molecule(seed=5, n_atoms=6,
                                    charge_model='amber99'))
    return mol, n, random_parameters(mol, seed=3)


def _plain(x):
    """A dump with each unit Quantity as (value, unit's repr): the two
    doubles' Quantity classes are distinct types."""
    if hasattr(x, 'value_in_unit'):
        return ('Quantity', _plain(x.value), repr(x.unit))
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _system_and_topology(mol, n, params):
    """The System and a two-residue Topology (MOL: atoms below n, LIG)."""
    from openmm.app import Element, Topology
    top = Topology()
    chain = top.addChain('A')
    res = [top.addResidue(r, chain) for r in ('MOL', 'LIG')]
    atoms = [top.addAtom(f'X{i}', Element.getByAtomicNumber(int(z)),
                         res[int(i >= n)])
             for i, z in enumerate(mol.atomic_numbers)]
    for a, b in mol.bonds_by_index():
        top.addBond(atoms[int(a)], atoms[int(b)])
    return build_system([(mol, params)]), top


def test_doubles_import_only_the_port():
    for d in PORT:
        text = Path(d.__file__).read_text()
        assert 'from grappa_tpu.' not in text
        assert 'from grappa_tpu import' not in text
        assert 'import jax' not in text
    for d, orig in zip(PORT, JAX):
        assert [n for n in dir(d) if not n.startswith('_')] == [
            n for n in dir(orig) if not n.startswith('_')]


def test_openmm_double_energies_and_units_match_jax():
    """The same System under each double: energies and finite-difference
    forces at two conformers, particle masses and the unit algebra's
    numbers, equal."""
    mol, n, params = _linked_system()
    xyz = embed_conformers(mol, n_confs=2, seed=21)
    out = []
    for doubles, omm in ((JAX, jomm), (PORT, tomm)):
        with installed(doubles[:1]):
            import openmm.unit as u
            system, _ = _system_and_topology(mol, n, params)
            energy, gradient = omm.get_energies(system, xyz)
            masses = [system.getParticleMass(i).value_in_unit(u.dalton)
                      for i in range(system.getNumParticles())]
            units = [(1.0 * u.kilocalorie_per_mole / u.angstrom ** 2
                      ).value_in_unit(u.kilojoule_per_mole / u.nanometer ** 2),
                     (2.0 * u.radian).value_in_unit(u.degree),
                     (0.5 * u.elementary_charge).value_in_unit(
                         u.elementary_charge)]
            out.append((energy, gradient, masses, units))
    for got, want in zip(out[1], out[0]):
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(out[1][0]).all() and out[1][1].shape == xyz.shape


@pytest.mark.parametrize('smiles', SMILES)
def test_openff_double_parses_like_jax(smiles):
    """Mapped SMILES through each openff double: atoms, bonds, impropers,
    rdkit's hybridization / aromaticity, and the molecule and System the
    wrappers build from them."""
    out = []
    for doubles, off in ((JAX, joff), (PORT, toff)):
        with installed(doubles[:2]):
            mol = off.get_openff_molecule(smiles)
            rd = mol.to_rdkit()
            system = off.get_openmm_system(smiles)[0]
            out.append((
                [a.atomic_number for a in mol.atoms],
                [(b.atom1_index, b.atom2_index) for b in mol.bonds],
                [tuple(a.molecule_atom_index for a in t)
                 for t in mol.smirnoff_impropers],
                [(str(a.GetHybridization()), a.GetIsAromatic())
                 for a in rd.GetAtoms()],
                off.get_sp_hybridization_encoding(mol),
                _mol(off.molecule_from_smiles(smiles)),
                _plain(_dump(system))))
    np.testing.assert_equal(out[1], out[0])


def test_kimmdy_double_topologies_match_jax():
    mol = random_molecule(seed=4, n_atoms=12, charge_model='amber99')
    port_mol = port_random_molecule(seed=4, n_atoms=12,
                                    charge_model='amber99')
    views = []
    for double, m in ((kimmdy_double, mol), (torch_kimmdy_double, port_mol)):
        top = double.topology_from_molecule(m, radicals=[3])
        views.append((_kimmdy_view(top),
                      {nr: (a.mass, a.charge, a.is_radical)
                       for nr, a in top.atoms.items()}))
    assert views[1] == views[0]


@pytest.mark.parametrize('exclude', [None, {'LIG'}], ids=['whole', 'lig'])
def test_parametrize_system_on_port_doubles_matches_jax(pair, exclude):
    """OpenmmGrappa.parametrize_system: the port's on the port's double
    against the JAX package's on the JAX double, whole and with a residue
    excluded (whose entries, the link's among them, stay as they
    were)."""
    jax_ff, ff = pair
    mol, n, params = _linked_system()
    dumps = []
    for doubles, grappa in ((JAX, jax_ff), (PORT, ff)):
        with installed(doubles[:1]):
            system, top = _system_and_topology(mol, n, params)
            before = _plain(_dump(system))
            grappa.parametrize_system(system, top, check_eq_values=False,
                                      exclude_residues=exclude)
            dumps.append((before, _plain(_dump(system))))
    assert dumps[1][0] == dumps[0][0]
    _dumps_agree(dumps[1][1], dumps[0][1])
    def lig(rows):
        return [r for r in rows if max(r[:len(r) - 2]) >= n]
    before, after = dict(dumps[1][0]), dict(dumps[1][1])
    for name in ('HarmonicBondForce', 'HarmonicAngleForce'):
        assert lig(before[name])
        assert (lig(after[name]) == lig(before[name])) == (
            exclude is not None), name


def test_openff_predict_on_port_double_matches_jax(pair):
    """molecule_from_smiles -> predict on each package's doubles."""
    jax_ff, ff = pair
    out = []
    for doubles, off, grappa in ((JAX, joff, jax_ff), (PORT, toff, ff)):
        with installed(doubles[:2]):
            mol = off.molecule_from_smiles(ETHANOL)
            out.append(grappa.predict(mol, check_eq_values=False))
    for field in ('bond_k', 'bond_eq', 'angle_k', 'angle_eq', 'proper_ks',
                  'improper_ks'):
        np.testing.assert_allclose(getattr(out[1], field),
                                   getattr(out[0], field), rtol=1e-4,
                                   atol=1e-5, err_msg=field)


@pytest.mark.parametrize('focus', [None, {'1'}], ids=['full', 'partial'])
def test_kimmdy_parameterizer_on_port_double_matches_jax(pair, focus):
    jax_ff, ff = pair
    mol = random_molecule(seed=7, n_atoms=24, charge_model='amber99')
    port_mol = Molecule.from_dict(mol.to_dict())
    views = []
    for doubles, kim, grappa, m in ((JAX, jkim, jax_ff, mol),
                                    (PORT, tkim, ff, port_mol)):
        with installed(doubles[2:]):
            top = doubles[2].topology_from_molecule(m, radicals=[5])
            parameterizer = kim.make_kimmdy_parameterizer(grappa)()
            assert parameterizer.parameterize_topology(top, focus) is top
            views.append(_kimmdy_view(top))
    _kimmdy_agree(views[1], views[0])


def _tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def test_from_pdb_npz_on_port_double_matches_jax(tmp_path, capsys):
    """`dataset from-pdb-npz` (the star force field types the HYP ring):
    the port's CLI on the port's double writes what the JAX CLI writes on
    the JAX double, byte for byte."""
    rng = np.random.default_rng(0)
    src = tmp_path / 'pdb_npz'
    src.mkdir()
    pdb = _capped_hyp_pdb()
    for name, seq in (('ACE-HYP-NME', 'ACE-HYP-NME'),
                      ('skipme', 'ACE-HID-NME')):
        np.savez(src / f'{name}.npz', **{
            'n1 xyz': rng.uniform(0, 20, (27, 2, 3)),
            'n1 grad_qm': rng.normal(0, 1, (27, 2, 3)),
            'g u_qm': rng.normal(0, 1, (1, 2)),
            'pdb': np.asarray([line + '\n' for line in pdb.splitlines()]),
            'sequence': seq})
    stats = {}
    for pkg, doubles, main in (('jax', JAX, jcli.main),
                               ('port', PORT, cli.main)):
        with installed(doubles[:1]):
            got = []
            for name, extra in (('peptides', []),
                                ('no_params', ['--no-params'])):
                main(['dataset', 'from-pdb-npz', '-s', str(src), '-t',
                      str(tmp_path / pkg / name), '--skip-residues', 'HID']
                     + extra)
                line = json.loads(capsys.readouterr().out)
                got.append({k: v for k, v in line.items() if k != 'target'})
            stats[pkg] = got
    assert stats['port'] == stats['jax']
    assert stats['port'][0] == {'total': 2, 'written': 1, 'skipped': 1,
                                'errors': 0, 'confs': 2}
    assert _tree(tmp_path / 'port') == _tree(tmp_path / 'jax')
