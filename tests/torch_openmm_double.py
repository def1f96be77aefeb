"""A first-party stand-in for the openmm API surface used by grappa_tpu_torch
(the port's copy of tests/openmm_double.py with the port's imports, so
that it runs where the JAX package cannot).

The real openmm is not installable in this environment, so the import-gated
wrapper code (grappa_tpu_torch/wrappers/openmm_wrapper.py, hyp_dop.py) could never
execute. This double implements exactly the classes/functions those wrappers
touch — System, the three bonded forces, NonbondedForce, Topology, Context
with a numpy energy/force evaluator — with openmm's semantics:

  * unit algebra backed by grappa_tpu_torch.units (raw numbers mean openmm's md
    unit system: nm, kJ/mol, radian, elementary charge, ps)
  * HarmonicBondForce  E = k/2 (r - r0)^2
  * HarmonicAngleForce E = k/2 (theta - theta0)^2
  * PeriodicTorsionForce E = k (1 + cos(n phi - phase))
  * NonbondedForce: Coulomb + Lennard-Jones over all pairs, Lorentz-
    Berthelot combination, pair exceptions REPLACE the default interaction
  * Context forces by central finite differences of the total energy (f64)

Install with `install()` (registers openmm/openmm.unit/openmm.app in
sys.modules so importlib.util.find_spec finds them), remove with
`uninstall()`. Test-only code: the shipped wrappers are unchanged.
"""
from __future__ import annotations

import importlib.machinery
import sys
import types
from typing import Dict, List, Optional

import numpy as np

from grappa_tpu_torch import units as U

# openmm md-unit-system defaults for raw (unit-less) numbers
_NM = U.nanometer
_KJ = U.kilojoule_per_mole
_RAD = U.radian
_E0 = U.elementary_charge
_PS = U.picosecond

# evaluation units
_ANG = U.angstrom
_KCAL = U.kilocalorie_per_mole

# ONE_4PI_EPS0 = 138.935456 kJ mol^-1 nm e^-2  ->  kcal mol^-1 A e^-2
COULOMB_CONSTANT = 138.935456 / 4.184 * 10.0

_FD_EPS = 1e-4          # finite-difference step (A) for Context forces


def _q(value, default_unit: U.Unit) -> U.Quantity:
    if isinstance(value, U.Quantity):
        return value
    return U.Quantity(value, default_unit)


# ---------------------------------------------------------------------------
# forces
class Force:
    def __init__(self):
        self._name = self.__class__.__name__

    def setName(self, name: str):
        self._name = name

    def getName(self) -> str:
        return self._name

    def _energy(self, xyz: np.ndarray) -> float:   # xyz (n, 3) in A
        return 0.0


class CMMotionRemover(Force):
    pass


class HarmonicBondForce(Force):
    def __init__(self):
        super().__init__()
        self._bonds: List[list] = []

    def addBond(self, a, b, length, k) -> int:
        self._bonds.append([int(a), int(b), _q(length, _NM),
                            _q(k, _KJ / _NM ** 2)])
        return len(self._bonds) - 1

    def getNumBonds(self) -> int:
        return len(self._bonds)

    def getBondParameters(self, i: int):
        return tuple(self._bonds[i])

    def setBondParameters(self, i: int, a, b, length, k):
        self._bonds[i] = [int(a), int(b), _q(length, _NM),
                          _q(k, _KJ / _NM ** 2)]

    def _energy(self, xyz):
        e = 0.0
        for a, b, eq, k in self._bonds:
            r = float(np.linalg.norm(xyz[a] - xyz[b]))
            e += 0.5 * k.value_in_unit(_KCAL / _ANG ** 2) * (
                r - eq.value_in_unit(_ANG)) ** 2
        return e


class HarmonicAngleForce(Force):
    def __init__(self):
        super().__init__()
        self._angles: List[list] = []

    def addAngle(self, a, b, c, angle, k) -> int:
        self._angles.append([int(a), int(b), int(c), _q(angle, _RAD),
                             _q(k, _KJ / _RAD ** 2)])
        return len(self._angles) - 1

    def getNumAngles(self) -> int:
        return len(self._angles)

    def getAngleParameters(self, i: int):
        return tuple(self._angles[i])

    def setAngleParameters(self, i: int, a, b, c, angle, k):
        self._angles[i] = [int(a), int(b), int(c), _q(angle, _RAD),
                           _q(k, _KJ / _RAD ** 2)]

    def _energy(self, xyz):
        e = 0.0
        for a, b, c, eq, k in self._angles:
            v1 = xyz[a] - xyz[b]
            v2 = xyz[c] - xyz[b]
            cos = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
            theta = float(np.arccos(np.clip(cos, -1.0, 1.0)))
            e += 0.5 * k.value_in_unit(_KCAL / _RAD ** 2) * (
                theta - eq.value_in_unit(_RAD)) ** 2
        return e


def _dihedral(p0, p1, p2, p3) -> float:
    b1 = p1 - p0
    b2 = p2 - p1
    b3 = p3 - p2
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    m = np.cross(n1, b2 / np.linalg.norm(b2))
    return float(np.arctan2(np.dot(m, n2), np.dot(n1, n2)))


class PeriodicTorsionForce(Force):
    def __init__(self):
        super().__init__()
        self._torsions: List[list] = []

    def addTorsion(self, a, b, c, d, periodicity, phase, k) -> int:
        self._torsions.append([int(a), int(b), int(c), int(d),
                               int(periodicity), _q(phase, _RAD), _q(k, _KJ)])
        return len(self._torsions) - 1

    def getNumTorsions(self) -> int:
        return len(self._torsions)

    def getTorsionParameters(self, i: int):
        return tuple(self._torsions[i])

    def setTorsionParameters(self, i: int, a, b, c, d, periodicity, phase, k):
        self._torsions[i] = [int(a), int(b), int(c), int(d),
                             int(periodicity), _q(phase, _RAD), _q(k, _KJ)]

    def _energy(self, xyz):
        e = 0.0
        for a, b, c, d, per, phase, k in self._torsions:
            phi = _dihedral(xyz[a], xyz[b], xyz[c], xyz[d])
            e += k.value_in_unit(_KCAL) * (
                1.0 + np.cos(per * phi - phase.value_in_unit(_RAD)))
        return e


class NonbondedForce(Force):
    def __init__(self):
        super().__init__()
        self._particles: List[list] = []
        self._exceptions: List[list] = []

    def addParticle(self, charge, sigma, epsilon) -> int:
        self._particles.append([_q(charge, _E0), _q(sigma, _NM),
                                _q(epsilon, _KJ)])
        return len(self._particles) - 1

    def getNumParticles(self) -> int:
        return len(self._particles)

    def getParticleParameters(self, i: int):
        return tuple(self._particles[i])

    def setParticleParameters(self, i: int, charge, sigma, epsilon):
        self._particles[i] = [_q(charge, _E0), _q(sigma, _NM),
                              _q(epsilon, _KJ)]

    def addException(self, p1, p2, chargeProd, sigma, epsilon) -> int:
        self._exceptions.append([int(p1), int(p2),
                                 _q(chargeProd, _E0 ** 2), _q(sigma, _NM),
                                 _q(epsilon, _KJ)])
        return len(self._exceptions) - 1

    def getNumExceptions(self) -> int:
        return len(self._exceptions)

    def getExceptionParameters(self, i: int):
        return tuple(self._exceptions[i])

    def _energy(self, xyz):
        n = len(self._particles)
        q = np.array([p[0].value_in_unit(_E0) for p in self._particles])
        sig = np.array([p[1].value_in_unit(_ANG) for p in self._particles])
        eps = np.array([p[2].value_in_unit(_KCAL) for p in self._particles])
        excluded = {frozenset((e[0], e[1])) for e in self._exceptions}

        e = 0.0
        for i in range(n):
            for j in range(i + 1, n):
                if frozenset((i, j)) in excluded:
                    continue
                r = float(np.linalg.norm(xyz[i] - xyz[j]))
                e += COULOMB_CONSTANT * q[i] * q[j] / r
                s = 0.5 * (sig[i] + sig[j])          # Lorentz-Berthelot
                ep = np.sqrt(eps[i] * eps[j])
                sr6 = (s / r) ** 6
                e += 4.0 * ep * (sr6 ** 2 - sr6)
        for p1, p2, qq, s, ep in self._exceptions:
            qq = qq.value_in_unit(_E0 ** 2)
            s = s.value_in_unit(_ANG)
            ep = ep.value_in_unit(_KCAL)
            if qq == 0.0 and ep == 0.0:
                continue
            r = float(np.linalg.norm(xyz[p1] - xyz[p2]))
            sr6 = (s / r) ** 6 if s > 0 else 0.0
            e += COULOMB_CONSTANT * qq / r + 4.0 * ep * (sr6 ** 2 - sr6)
        return e


# ---------------------------------------------------------------------------
# system / context
class System:
    def __init__(self):
        self._masses: List[U.Quantity] = []
        self._forces: List[Force] = []

    def addParticle(self, mass) -> int:
        self._masses.append(_q(mass, U.dalton))
        return len(self._masses) - 1

    def getNumParticles(self) -> int:
        return len(self._masses)

    def getParticleMass(self, i: int):
        return self._masses[i]

    def addForce(self, force: Force) -> int:
        self._forces.append(force)
        return len(self._forces) - 1

    def getForces(self) -> List[Force]:
        return self._forces

    def getNumForces(self) -> int:
        return len(self._forces)

    def getForce(self, i: int) -> Force:
        return self._forces[i]

    def removeForce(self, i: int):
        del self._forces[i]


class VerletIntegrator:
    def __init__(self, step_size):
        self.step_size = _q(step_size, _PS)


class Platform:
    _instances: Dict[str, "Platform"] = {}

    def __init__(self, name: str):
        self.name = name

    @staticmethod
    def getPlatformByName(name: str) -> "Platform":
        return Platform._instances.setdefault(name, Platform(name))


class _State:
    def __init__(self, energy_kcal: Optional[float],
                 forces_kcal_ang: Optional[np.ndarray]):
        self._energy = energy_kcal
        self._forces = forces_kcal_ang

    def getPotentialEnergy(self) -> U.Quantity:
        return U.Quantity(self._energy, _KCAL)

    def getForces(self, asNumpy: bool = False):
        forces = self._forces if asNumpy else [f for f in self._forces]
        return U.Quantity(np.asarray(forces), _KCAL / _ANG)


class Context:
    def __init__(self, system: System, integrator=None, platform=None):
        self._system = system
        self._xyz: Optional[np.ndarray] = None

    def setPositions(self, positions):
        xyz = _q(positions, _NM).value_in_unit(_ANG)
        self._xyz = np.asarray(xyz, np.float64)

    def _total_energy(self, xyz: np.ndarray) -> float:
        return float(sum(f._energy(xyz) for f in self._system.getForces()))

    def getState(self, getEnergy: bool = False, getForces: bool = False,
                 **_ignored) -> _State:
        assert self._xyz is not None, "setPositions first"
        energy = self._total_energy(self._xyz) if getEnergy else None
        forces = None
        if getForces:
            n = self._xyz.shape[0]
            forces = np.zeros((n, 3))
            for i in range(n):
                for k in range(3):
                    xp = self._xyz.copy()
                    xm = self._xyz.copy()
                    xp[i, k] += _FD_EPS
                    xm[i, k] -= _FD_EPS
                    # force = -dE/dx
                    forces[i, k] = -(self._total_energy(xp)
                                     - self._total_energy(xm)) / (2 * _FD_EPS)
        return _State(energy, forces)


# ---------------------------------------------------------------------------
# app: topology
_SYMBOLS = [
    'X', 'H', 'He', 'Li', 'Be', 'B', 'C', 'N', 'O', 'F', 'Ne', 'Na', 'Mg',
    'Al', 'Si', 'P', 'S', 'Cl', 'Ar', 'K', 'Ca', 'Sc', 'Ti', 'V', 'Cr',
    'Mn', 'Fe', 'Co', 'Ni', 'Cu', 'Zn', 'Ga', 'Ge', 'As', 'Se', 'Br', 'Kr',
    'Rb', 'Sr', 'Y', 'Zr', 'Nb', 'Mo', 'Tc', 'Ru', 'Rh', 'Pd', 'Ag', 'Cd',
    'In', 'Sn', 'Sb', 'Te', 'I',
]


class Element:
    _by_number: Dict[int, "Element"] = {}

    def __init__(self, atomic_number: int, symbol: str):
        self.atomic_number = atomic_number
        self.symbol = symbol

    @classmethod
    def getByAtomicNumber(cls, z: int) -> "Element":
        if z not in cls._by_number:
            symbol = _SYMBOLS[z] if z < len(_SYMBOLS) else f'E{z}'
            cls._by_number[z] = Element(z, symbol)
        return cls._by_number[z]


class Chain:
    def __init__(self, id, topology: "Topology"):
        self.id = id
        self.topology = topology
        self._residues: List["Residue"] = []

    def residues(self):
        return iter(self._residues)


class Residue:
    def __init__(self, name: str, chain: Chain, id):
        self.name = name
        self.chain = chain
        self.id = id
        self._atoms: List["Atom"] = []

    def atoms(self):
        return iter(self._atoms)


class Atom:
    def __init__(self, name: str, element: Element, residue: Residue,
                 index: int, id):
        self.name = name
        self.element = element
        self.residue = residue
        self.index = index
        self.id = id


class Topology:
    def __init__(self):
        self._chains: List[Chain] = []
        self._atoms: List[Atom] = []
        self._bonds: List[tuple] = []

    def addChain(self, id=None) -> Chain:
        chain = Chain(id if id is not None else str(len(self._chains)), self)
        self._chains.append(chain)
        return chain

    def addResidue(self, name: str, chain: Chain, id=None) -> Residue:
        n_res = sum(len(c._residues) for c in self._chains)
        residue = Residue(name, chain, id if id is not None else str(n_res))
        chain._residues.append(residue)
        return residue

    def addAtom(self, name: str, element: Element, residue: Residue,
                id=None) -> Atom:
        index = len(self._atoms)
        atom = Atom(name, element, residue, index,
                    id if id is not None else str(index))
        self._atoms.append(atom)
        residue._atoms.append(atom)
        return atom

    def addBond(self, a: Atom, b: Atom):
        self._bonds.append((a, b))

    def atoms(self):
        return iter(self._atoms)

    def bonds(self):
        return iter(self._bonds)

    def chains(self):
        return iter(self._chains)

    def residues(self):
        for chain in self._chains:
            yield from chain._residues

    def getNumAtoms(self) -> int:
        return len(self._atoms)




# ---------------------------------------------------------------------------
# PDBFile + ForceField (XML template matching) — enough to execute the
# star-forcefield machinery (grappa_tpu_torch/wrappers/star_forcefield.py):
# get_openmm_forcefield('amber99sbildn*') -> createSystem on a PDB-derived
# topology. Mirrors openmm behavior: PDBFile bonds standard residues from a
# built-in library and leaves unknown residues (HYP/DOP) unbonded;
# ForceField matches residue templates by atom-name set and raises when no
# template fits. 'amber99sbildn.xml' resolves to a built-in minimal
# standard-residue library (ACE/NME/ALA/GLY) with amber-like classes.

_ELEMENT_Z = {'H': 1, 'C': 6, 'N': 7, 'O': 8, 'S': 16, 'P': 15}

# minimal standard-residue library standing in for openmm's amber99sbildn:
# (atom name, class, element, mass, charge)
_STD_RESIDUES = {
    'ACE': [('HH31', 'HC', 'H', 1.008, 0.1123), ('CH3', 'CT', 'C', 12.01, -0.3662),
            ('HH32', 'HC', 'H', 1.008, 0.1123), ('HH33', 'HC', 'H', 1.008, 0.1123),
            ('C', 'C', 'C', 12.01, 0.5972), ('O', 'O', 'O', 16.00, -0.5679)],
    'NME': [('N', 'N', 'N', 14.01, -0.4157), ('H', 'H', 'H', 1.008, 0.2719),
            ('CH3', 'CT', 'C', 12.01, -0.149), ('HH31', 'H1', 'H', 1.008, 0.0976),
            ('HH32', 'H1', 'H', 1.008, 0.0976), ('HH33', 'H1', 'H', 1.008, 0.0976)],
    'ALA': [('N', 'N', 'N', 14.01, -0.4157), ('H', 'H', 'H', 1.008, 0.2719),
            ('CA', 'CT', 'C', 12.01, 0.0337), ('HA', 'H1', 'H', 1.008, 0.0823),
            ('CB', 'CT', 'C', 12.01, -0.1825), ('HB1', 'HC', 'H', 1.008, 0.0603),
            ('HB2', 'HC', 'H', 1.008, 0.0603), ('HB3', 'HC', 'H', 1.008, 0.0603),
            ('C', 'C', 'C', 12.01, 0.5973), ('O', 'O', 'O', 16.00, -0.5679)],
}
_STD_BONDS = {
    'ACE': [('HH31', 'CH3'), ('CH3', 'HH32'), ('CH3', 'HH33'), ('CH3', 'C'),
            ('C', 'O')],
    'NME': [('N', 'H'), ('N', 'CH3'), ('CH3', 'HH31'), ('CH3', 'HH32'),
            ('CH3', 'HH33')],
    'ALA': [('N', 'H'), ('N', 'CA'), ('CA', 'HA'), ('CA', 'CB'),
            ('CB', 'HB1'), ('CB', 'HB2'), ('CB', 'HB3'), ('CA', 'C'),
            ('C', 'O')],
}
# LJ by class (sigma nm, epsilon kJ/mol), amber-like
_STD_LJ = {
    'C': (3.39967e-01, 3.59824e-01), 'CT': (3.39967e-01, 4.57730e-01),
    'CA': (3.39967e-01, 3.59824e-01), 'N': (3.25000e-01, 7.11280e-01),
    'O': (2.95992e-01, 8.78640e-01), 'OH': (3.06647e-01, 8.80314e-01),
    'H': (1.06908e-01, 6.56888e-02), 'H1': (2.47135e-01, 6.56888e-02),
    'HC': (2.64953e-01, 6.56888e-02), 'HA': (2.59964e-01, 6.27600e-02),
    'HO': (0.0, 0.0),
}
# class-pair harmonic bonds (r0 nm, k kJ/mol/nm^2) with an element fallback
_STD_BOND_PARAMS = {
    frozenset(('C', 'O')): (0.1229, 476976.0),
    frozenset(('C', 'N')): (0.1335, 410032.0),
    frozenset(('C', 'CT')): (0.1522, 265265.6),
    frozenset(('CT', 'CT')): (0.1526, 259408.0),
    frozenset(('CT', 'N')): (0.1449, 282001.6),
    frozenset(('CT', 'OH')): (0.1410, 267776.0),
    frozenset(('OH', 'HO')): (0.0960, 462750.4),
    frozenset(('CA', 'CA')): (0.1400, 392459.2),
    frozenset(('CT', 'CA')): (0.1510, 265265.6),
    frozenset(('C', 'CA')): (0.1409, 392459.2),
    frozenset(('CA', 'OH')): (0.1364, 376560.0),
    frozenset(('C', 'OH')): (0.1364, 376560.0),
}
_H_BOND = (0.1090, 284512.0)


class PDBFile:
    """Minimal PDB parser: ATOM/HETATM records -> Topology + positions.

    Bonds: intra-residue bonds for residues in the built-in standard
    library plus peptide C-N links between consecutive STANDARD residues;
    unknown residues (HYP/DOP) get no bonds — exactly the situation the
    star force field's topology repair exists for."""

    def __init__(self, path):
        self.topology = Topology()
        self.positions = []
        chain = None
        chain_id = None
        residue = None
        res_key = None
        for line in open(path):
            if not line.startswith(('ATOM', 'HETATM')):
                continue
            name = line[12:16].strip()
            res_name = line[17:20].strip()
            cid = line[21]
            res_seq = line[22:26].strip()
            x, y, z = (float(line[30:38]), float(line[38:46]),
                       float(line[46:54]))
            elem = line[76:78].strip() or name[0]
            if chain is None or cid != chain_id:
                chain = self.topology.addChain(cid)
                chain_id = cid
                res_key = None
            if res_key != (cid, res_seq):
                residue = self.topology.addResidue(res_name, chain, res_seq)
                res_key = (cid, res_seq)
            znum = _ELEMENT_Z.get(elem.upper()[:1], 6)
            self.topology.addAtom(name, Element.getByAtomicNumber(znum),
                                  residue, None)
            self.positions.append((x / 10.0, y / 10.0, z / 10.0))  # nm
        # standard-residue bonds + peptide links
        for ch in self.topology.chains():
            residues = list(ch.residues())
            for i, res in enumerate(residues):
                atoms = {a.name: a for a in res.atoms()}
                for n1, n2 in _STD_BONDS.get(res.name.upper(), []):
                    if n1 in atoms and n2 in atoms:
                        self.topology.addBond(atoms[n1], atoms[n2])
                if i > 0 and res.name.upper() in _STD_BONDS \
                        and residues[i - 1].name.upper() in _STD_BONDS:
                    prev = {a.name: a for a in residues[i - 1].atoms()}
                    if 'C' in prev and 'N' in atoms:
                        self.topology.addBond(prev['C'], atoms['N'])


class ForceField:
    """XML residue-template force field: template matching by residue name
    + atom-name set; charges/LJ per type; class-based harmonic bonds,
    connectivity-derived angles/torsions with generic amber-like values."""

    def __init__(self, *files):
        # type -> (class, element, mass); type -> (charge, sigma, epsilon)
        self.types: Dict[str, tuple] = {}
        self.nonbonded: Dict[str, tuple] = {}
        # residue name -> [(atom name, type)]
        self.residues: Dict[str, list] = {}
        for f in files:
            if str(f).endswith('amber99sbildn.xml'):
                self._load_std()
            else:
                self._load_xml(f)

    def _load_std(self):
        for res, atoms in _STD_RESIDUES.items():
            entries = []
            for name, klass, element, mass, charge in atoms:
                t = f'std-{res}-{name}'
                self.types[t] = (klass, element, mass)
                self.nonbonded[t] = (charge,) + _STD_LJ[klass]
                entries.append((name, t))
            self.residues[res] = entries

    def _load_xml(self, path):
        import xml.etree.ElementTree as ET
        root = ET.parse(str(path)).getroot()
        for t in root.findall('./AtomTypes/Type'):
            self.types[t.get('name')] = (t.get('class'), t.get('element'),
                                         float(t.get('mass')))
        for t in root.findall('./NonbondedForce/Atom'):
            self.nonbonded[t.get('type')] = (
                float(t.get('charge')), float(t.get('sigma')),
                float(t.get('epsilon')))
        for res in root.findall('./Residues/Residue'):
            self.residues[res.get('name')] = [
                (a.get('name'), a.get('type'))
                for a in res.findall('Atom')]

    def createSystem(self, topology, **kwargs):
        system = System()
        nonbonded = NonbondedForce()
        atom_class = {}
        for res in topology.residues():
            template = self.residues.get(res.name.upper())
            res_atoms = list(res.atoms())
            if template is None or (
                    {a.name for a in res_atoms} != {n for n, _ in template}):
                raise ValueError(
                    f'No template found for residue {res.name} '
                    f'(atoms {sorted(a.name for a in res_atoms)})')
            by_name = dict(template)
            for atom in res_atoms:
                t = by_name[atom.name]
                klass, _elem, mass = self.types[t]
                charge, sigma, eps = self.nonbonded[t]
                system.addParticle(mass)
                nonbonded.addParticle(charge, sigma, eps)
                atom_class[atom.index] = klass

        bonds = [(a.index, b.index) for a, b in topology.bonds()]
        neighbor: Dict[int, set] = {}
        for i, j in bonds:
            neighbor.setdefault(i, set()).add(j)
            neighbor.setdefault(j, set()).add(i)

        bond_force = HarmonicBondForce()
        for i, j in bonds:
            ci, cj = atom_class[i], atom_class[j]
            if ci.startswith('H') or cj.startswith('H'):
                r0, k = _H_BOND
            else:
                r0, k = _STD_BOND_PARAMS.get(frozenset((ci, cj)),
                                             (0.1500, 250000.0))
            bond_force.addBond(i, j, r0, k)
        system.addForce(bond_force)

        angle_force = HarmonicAngleForce()
        for j in sorted(neighbor):
            ns = sorted(neighbor[j])
            for ai in range(len(ns)):
                for bi in range(ai + 1, len(ns)):
                    angle_force.addAngle(ns[ai], j, ns[bi],
                                         1.9111355, 400.0)
        system.addForce(angle_force)

        torsion_force = PeriodicTorsionForce()
        seen = set()
        for j, k in bonds:
            for i in neighbor[j] - {k}:
                for l in neighbor[k] - {j}:
                    if i == l:
                        continue
                    key = (i, j, k, l) if (i, j, k, l) < (l, k, j, i) \
                        else (l, k, j, i)
                    if key in seen:
                        continue
                    seen.add(key)
                    torsion_force.addTorsion(*key, 3, 0.0, 0.6508444)
        system.addForce(torsion_force)
        system.addForce(nonbonded)
        return system


# ---------------------------------------------------------------------------
# module assembly
def _module(name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
    return mod


def build_modules():
    openmm = _module('openmm')
    for cls in (Force, CMMotionRemover, HarmonicBondForce,
                HarmonicAngleForce, PeriodicTorsionForce, NonbondedForce,
                System, VerletIntegrator, Platform, Context):
        setattr(openmm, cls.__name__, cls)

    unit = _module('openmm.unit')
    unit.Quantity = U.Quantity
    unit.Unit = U.Unit
    for name, u in (
            ('nanometer', U.nanometer), ('nanometers', U.nanometer),
            ('angstrom', U.angstrom), ('angstroms', U.angstrom),
            ('radian', U.radian), ('radians', U.radian),
            ('degree', U.degree), ('degrees', U.degree),
            ('picosecond', U.picosecond), ('picoseconds', U.picosecond),
            ('femtosecond', U.femtosecond), ('femtoseconds', U.femtosecond),
            ('dalton', U.dalton), ('daltons', U.dalton), ('amu', U.dalton),
            ('elementary_charge', U.elementary_charge),
            ('kilojoule_per_mole', U.kilojoule_per_mole),
            ('kilojoules_per_mole', U.kilojoule_per_mole),
            ('kilocalorie_per_mole', U.kilocalorie_per_mole),
            ('kilocalories_per_mole', U.kilocalorie_per_mole),
            ('mole', U.mole),
    ):
        setattr(unit, name, u)

    app = _module('openmm.app')
    for cls in (Topology, Chain, Residue, Atom, Element, PDBFile, ForceField):
        setattr(app, cls.__name__, cls)

    openmm.unit = unit
    openmm.app = app
    return openmm, unit, app


def install():
    """Register the double as openmm/openmm.unit/openmm.app in sys.modules."""
    openmm, unit, app = build_modules()
    sys.modules['openmm'] = openmm
    sys.modules['openmm.unit'] = unit
    sys.modules['openmm.app'] = app
    return openmm


def uninstall():
    for name in ('openmm', 'openmm.unit', 'openmm.app'):
        sys.modules.pop(name, None)
