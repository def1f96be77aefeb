"""OpenMM integration: parametrize openmm Systems with a grappa_tpu_torch
model.

Counterpart of `grappa_tpu.wrappers.openmm_wrapper`; `OpenmmGrappa`
subclasses the port's `api.Grappa` (`(model, config, device)`).

Counterpart of the reference wrapper + utils (reference: src/grappa/wrappers/
openmm_wrapper.py:16-83 and utils/openmm_utils.py:20-340). OpenMM is an
*optional interop dependency*: everything here is import-gated and the core
framework never depends on it. Semantics preserved:

  * `get_subtopology` strips water/ion residues before building the Molecule
  * `molecule_from_openmm`: bonds/elements from the topology, improper
    torsion sets from the system's PeriodicTorsionForce, charges from the
    NonbondedForce (or given explicitly)
  * `write_to_system`: overwrite existing harmonic bond/angle entries in
    place, zero every existing torsion covered by the prediction, then append
    fresh proper+improper PeriodicTorsionForce entries
  * `OpenmmGrappa.parametrize_system(system, topology)` ties it together
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np

from grappa_tpu_torch import topology as topo
from grappa_tpu_torch.api import Grappa
from grappa_tpu_torch.constants import IMPROPER_CENTRAL_IDX
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.parameters import Parameters

WATER_RESIDUES = {'HOH', 'WAT', 'SOL', 'TIP', 'TIP3', 'TIP4', 'TIP5', 'T3P',
                  'T4P', 'SPC', 'SPCE'}
ION_RESIDUES = {'NA', 'CL', 'K', 'MG', 'CA', 'ZN', 'LI', 'RB', 'CS', 'F',
                'BR', 'I', 'NA+', 'CL-', 'K+', 'MG2+', 'CA2+', 'ZN2+'}


def _require_openmm():
    if importlib.util.find_spec('openmm') is None:
        raise ImportError(
            "openmm is not installed; the OpenMM wrapper is an optional "
            "interop path (pip/conda install openmm)")


def get_subtopology(openmm_topology, exclude_residues: Optional[Set[str]] = None):
    """New topology without water/ion residues; atom indices preserved via
    atom.id (set to the original index)."""
    _require_openmm()
    from openmm.app import Topology

    exclude = {r.upper() for r in (exclude_residues or set())} \
        | WATER_RESIDUES | ION_RESIDUES
    sub = Topology()
    chains: Dict = {}
    residues: Dict = {}
    atom_map: Dict = {}
    for atom in openmm_topology.atoms():
        res = atom.residue
        if res.name.upper().strip() in exclude:
            continue
        chain = res.chain
        if chain not in chains:
            chains[chain] = sub.addChain(chain.id)
        if res not in residues:
            residues[res] = sub.addResidue(res.name, chains[chain], res.id)
        atom_map[atom] = sub.addAtom(atom.name, atom.element, residues[res],
                                     id=str(atom.index))
    for a, b in openmm_topology.bonds():
        if a in atom_map and b in atom_map:
            sub.addBond(atom_map[a], atom_map[b])
    return sub


def molecule_from_openmm(openmm_system, openmm_topology,
                         partial_charges=None,
                         charge_model: str = 'amber99') -> Molecule:
    """Build a Molecule from an openmm system + (sub)topology
    (reference semantics: Molecule.from_openmm_system, Molecule.py:179-267)."""
    _require_openmm()
    import openmm
    import openmm.unit as unit

    top_atoms = list(openmm_topology.atoms())
    if openmm_system.getNumParticles() > len(top_atoms):
        atom_idxs = [int(a.id) for a in top_atoms]
    elif openmm_system.getNumParticles() == len(top_atoms):
        atom_idxs = list(range(openmm_system.getNumParticles()))
    else:
        raise ValueError("system has fewer particles than the topology")
    idx_set = set(atom_idxs)
    pos = {idx: i for i, idx in enumerate(atom_idxs)}

    atom_pos = {a: i for i, a in enumerate(top_atoms)}  # O(1) per lookup
    bonds = [(atom_pos[a], atom_pos[b])
             for a, b in openmm_topology.bonds()]
    # bonds above are indices into top_atoms == indices into atom_idxs
    nbrs = topo.neighbor_map(bonds)

    all_torsions = []
    for force in openmm_system.getForces():
        if isinstance(force, openmm.PeriodicTorsionForce):
            for i in range(force.getNumTorsions()):
                *torsion, _, _, _ = force.getTorsionParameters(i)
                if all(t in idx_set for t in torsion):
                    all_torsions.append(tuple(pos[t] for t in torsion))
    _, impropers = topo.classify_torsions(all_torsions, nbrs,
                                          IMPROPER_CENTRAL_IDX)

    if partial_charges is None:
        charges_all = None
        for force in openmm_system.getForces():
            if isinstance(force, openmm.NonbondedForce):
                charges_all = [
                    force.getParticleParameters(i)[0].value_in_unit(
                        unit.elementary_charge)
                    for i in atom_idxs]
        partial_charges = charges_all
    partial_charges = list(np.asarray(partial_charges, dtype=np.float32))

    atomic_numbers = [a.element.atomic_number for a in top_atoms]
    return Molecule(
        atoms=atom_idxs,
        bonds=[(atom_idxs[a], atom_idxs[b]) for a, b in bonds],
        impropers=[tuple(atom_idxs[i] for i in imp) for imp in impropers],
        atomic_numbers=atomic_numbers,
        partial_charges=partial_charges,
        improper_in_correct_format=True,
        charge_model=charge_model,
    )


def write_to_system(openmm_system, parameters: Parameters):
    """Write predicted parameters into the system in place
    (reference semantics: openmm_utils.write_to_system, :160-287)."""
    _require_openmm()
    import openmm
    import openmm.unit as u

    kcal = u.kilocalorie_per_mole
    ang = u.angstrom
    rad = u.radian

    bond_lookup = {tuple(sorted(map(int, b))): i
                   for i, b in enumerate(parameters.bonds)}
    angle_lookup = {}
    for i, a in enumerate(parameters.angles):
        a = tuple(map(int, a))
        angle_lookup[a] = i
        angle_lookup[a[::-1]] = i

    covered_torsion_atoms: Set[frozenset] = set()
    if parameters.propers is not None:
        for t in parameters.propers:
            covered_torsion_atoms.add(frozenset(map(int, t)))
    if parameters.impropers is not None:
        for t in parameters.impropers:
            covered_torsion_atoms.add(frozenset(map(int, t)))

    for force in openmm_system.getForces():
        if isinstance(force, openmm.HarmonicBondForce):
            for i in range(force.getNumBonds()):
                a, b, _, _ = force.getBondParameters(i)
                key = tuple(sorted((int(a), int(b))))
                if key in bond_lookup:
                    j = bond_lookup[key]
                    force.setBondParameters(
                        i, a, b,
                        parameters.bond_eq[j] * ang,
                        parameters.bond_k[j] * kcal / ang ** 2)
        elif isinstance(force, openmm.HarmonicAngleForce):
            for i in range(force.getNumAngles()):
                a, b, c, _, _ = force.getAngleParameters(i)
                key = (int(a), int(b), int(c))
                if key in angle_lookup:
                    j = angle_lookup[key]
                    force.setAngleParameters(
                        i, a, b, c,
                        parameters.angle_eq[j] * rad,
                        parameters.angle_k[j] * kcal / rad ** 2)
        elif isinstance(force, openmm.PeriodicTorsionForce):
            for i in range(force.getNumTorsions()):
                a, b, c, d, per, phase, _ = force.getTorsionParameters(i)
                if frozenset((int(a), int(b), int(c), int(d))) in covered_torsion_atoms:
                    force.setTorsionParameters(i, a, b, c, d, per, phase,
                                               0.0 * kcal)

    torsion_force = openmm.PeriodicTorsionForce()
    torsion_force.setName('grappa_torsions')
    for tuples, ks, phases in ((parameters.propers, parameters.proper_ks,
                                parameters.proper_phases),
                               (parameters.impropers, parameters.improper_ks,
                                parameters.improper_phases)):
        if tuples is None:
            continue
        for i, t in enumerate(tuples):
            a, b, c, d = (int(x) for x in t)
            for n in range(ks.shape[1]):
                if ks[i, n] == 0.0:
                    continue
                torsion_force.addTorsion(a, b, c, d, n + 1,
                                         phases[i, n] * rad,
                                         float(ks[i, n]) * kcal)
    openmm_system.addForce(torsion_force)
    return openmm_system


def get_energies(openmm_system, xyz: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-conformer (energy kcal/mol, gradient kcal/mol/A) via an openmm
    Context loop (reference: openmm_utils.get_energies, :58-88)."""
    _require_openmm()
    import openmm
    import openmm.unit as u

    integrator = openmm.VerletIntegrator(0.001 * u.picoseconds)
    platform = openmm.Platform.getPlatformByName('Reference')
    context = openmm.Context(openmm_system, integrator, platform)
    energies, gradients = [], []
    for conf in xyz:
        context.setPositions(conf * u.angstrom)
        state = context.getState(getEnergy=True, getForces=True)
        energies.append(state.getPotentialEnergy().value_in_unit(
            u.kilocalorie_per_mole))
        forces = state.getForces(asNumpy=True).value_in_unit(
            u.kilocalorie_per_mole / u.angstrom)
        gradients.append(-np.asarray(forces))
    return np.array(energies), np.array(gradients)


def remove_forces_from_system(openmm_system, keep: Sequence[str] = (),
                              remove: Sequence[str] = ()):
    """Remove forces by class-name substring (keep XOR remove semantics)."""
    _require_openmm()
    assert bool(keep) != bool(remove), "specify exactly one of keep/remove"
    i = 0
    while i < openmm_system.getNumForces():
        name = openmm_system.getForce(i).__class__.__name__
        match_remove = any(s.lower() in name.lower() for s in remove)
        match_keep = any(s.lower() in name.lower() for s in keep)
        if (remove and match_remove) or (keep and not match_keep):
            openmm_system.removeForce(i)
        else:
            i += 1
    return openmm_system


def set_partial_charges(openmm_system, charges: Sequence[float]):
    _require_openmm()
    import openmm
    import openmm.unit as u
    for force in openmm_system.getForces():
        if isinstance(force, openmm.NonbondedForce):
            for i, q in enumerate(charges):
                _, sigma, eps = force.getParticleParameters(i)
                force.setParticleParameters(i, q * u.elementary_charge,
                                            sigma, eps)
    return openmm_system


class OpenmmGrappa(Grappa):
    """Grappa with `parametrize_system(system, topology)` for OpenMM."""

    def parametrize_system(self, system, topology,
                           charge_model: str = 'amber99',
                           exclude_residues: Optional[Set[str]] = None,
                           partial_charges=None,
                           check_eq_values: bool = True,
                           plot_dir: Optional[str] = None):
        """plot_dir: write grappa_parameters.png / reference_parameters.png
        / parameter_comparison.png there (reference semantics:
        openmm_wrapper.py:62-72 — the classical parameters already in the
        system are the comparison baseline)."""
        _require_openmm()
        sub = get_subtopology(topology, exclude_residues)
        molecule = molecule_from_openmm(system, sub,
                                        partial_charges=partial_charges,
                                        charge_model=charge_model)
        params = self.predict(molecule, check_eq_values=check_eq_values)
        if plot_dir is not None:
            from pathlib import Path
            from grappa_tpu_torch.plotting import (compare_parameters,
                                             plot_parameters)
            out = Path(plot_dir)
            out.mkdir(parents=True, exist_ok=True)
            plot_parameters(params, str(out / 'grappa_parameters.png'),
                            title='Grappa')
            try:
                reference = _classical_parameters_from_openmm(system,
                                                              molecule)
            except Exception:
                reference = None   # no classical bonded forces to compare
            if reference is not None:
                plot_parameters(reference,
                                str(out / 'reference_parameters.png'),
                                title='Reference')
                compare_parameters(params, reference,
                                   str(out / 'parameter_comparison.png'),
                                   xlabel='Grappa', ylabel='Reference')
        return write_to_system(system, params)


def moldata_from_openmm_system(openmm_system, openmm_topology,
                               xyz: np.ndarray, energy: np.ndarray,
                               gradient: Optional[np.ndarray] = None,
                               mol_id: Optional[str] = None,
                               charge_model: str = 'amber99',
                               ff_name: str = 'reference_ff'):
    """Dataset-creation path: build a MolData whose bonded reference targets
    come from the given openmm system (reference semantics:
    MolData.from_openmm_system, MolData.py:420-518).

    energy/gradient are the QM values (kcal/mol, kcal/mol/A, xyz in A); the
    nonbonded contribution of the classical system is subtracted to form the
    training targets; classical bonded parameters are extracted for
    regularisation; improper-only reference energies are stored as well.
    """
    _require_openmm()
    import copy as _copy
    from grappa_tpu_torch.data.moldata import MolData

    molecule = molecule_from_openmm(openmm_system, openmm_topology,
                                    charge_model=charge_model)

    # nonbonded-only system: remove all bonded forces
    nonbonded_system = remove_forces_from_system(
        _copy.deepcopy(openmm_system), keep=('Nonbonded', 'CMMotion'))
    nb_energy, nb_gradient = get_energies(nonbonded_system, xyz)

    # full classical energies for comparison metrics
    ff_energy, ff_gradient = get_energies(openmm_system, xyz)

    # classical bonded parameters (for regularisation + statistics)
    classical_params = _classical_parameters_from_openmm(
        openmm_system, molecule)

    if gradient is None:
        gradient = np.zeros_like(xyz)
        nb_gradient = np.zeros_like(xyz)

    energy_ref = energy - nb_energy
    energy_ref = energy_ref - energy_ref.mean()
    md = MolData(
        molecule=molecule, xyz=np.asarray(xyz, np.float32),
        energy=np.asarray(energy, np.float32),
        gradient=np.asarray(gradient, np.float32),
        energy_ref=np.asarray(energy_ref, np.float32),
        gradient_ref=np.asarray(gradient - nb_gradient, np.float32),
        mol_id=mol_id or 'openmm-molecule',
        classical_parameters=classical_params,
        ff_energy={ff_name: np.asarray(ff_energy, np.float32)},
        ff_gradient={ff_name: np.asarray(ff_gradient, np.float32)},
        ff_nonbonded_energy={ff_name: np.asarray(nb_energy, np.float32)},
        ff_nonbonded_gradient={ff_name: np.asarray(nb_gradient, np.float32)},
    )
    return md


def _classical_parameters_from_openmm(openmm_system, molecule: Molecule):
    """Extract harmonic bond/angle + periodic torsion parameters from an
    openmm system into the molecule's tuple order (reference semantics:
    Parameters.from_openmm_system / from_lists, Parameters.py:143-424).
    Torsion disambiguation is the shared assign_torsion_parameters logic."""
    _require_openmm()
    import openmm
    import openmm.unit as u
    from grappa_tpu_torch.data.parameters import (
        Parameters, assign_torsion_parameters)

    kcal = u.kilocalorie_per_mole
    ang = u.angstrom
    rad = u.radian

    params = Parameters.get_nan_params(molecule)
    bond_lookup = {tuple(sorted(map(int, b))): i
                   for i, b in enumerate(molecule.bonds)}
    angle_lookup = {}
    for i, a in enumerate(molecule.angles):
        a = tuple(map(int, a))
        angle_lookup[a] = i
        angle_lookup[a[::-1]] = i

    torsions, t_ks, t_phases, t_pers = [], [], [], []
    for force in openmm_system.getForces():
        if isinstance(force, openmm.HarmonicBondForce):
            for i in range(force.getNumBonds()):
                a, b, eq, k = force.getBondParameters(i)
                key = tuple(sorted((int(a), int(b))))
                if key in bond_lookup:
                    j = bond_lookup[key]
                    params.bond_eq[j] = eq.value_in_unit(ang)
                    params.bond_k[j] = k.value_in_unit(kcal / ang ** 2)
        elif isinstance(force, openmm.HarmonicAngleForce):
            for i in range(force.getNumAngles()):
                a, b, c, eq, k = force.getAngleParameters(i)
                key = (int(a), int(b), int(c))
                if key in angle_lookup:
                    j = angle_lookup[key]
                    params.angle_eq[j] = eq.value_in_unit(rad)
                    params.angle_k[j] = k.value_in_unit(kcal / rad ** 2)
        elif isinstance(force, openmm.PeriodicTorsionForce):
            for i in range(force.getNumTorsions()):
                a, b, c, d, per, phase, k = force.getTorsionParameters(i)
                torsions.append((int(a), int(b), int(c), int(d)))
                t_ks.append(k.value_in_unit(kcal))
                t_phases.append(phase.value_in_unit(rad))
                t_pers.append(int(per))

    (params.proper_ks, params.proper_phases, params.improper_ks,
     params.improper_phases) = assign_torsion_parameters(
        molecule, torsions, t_ks, t_phases, t_pers,
        allow_skip_improper=True)
    return params
