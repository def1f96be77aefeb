"""A minimal stand-in for the kimmdy API surface used by
grappa_tpu_torch.wrappers.kimmdy_adapter (test double; the port's copy of
tests/kimmdy_double.py with the port's imports, so that it runs where the
JAX package cannot).

Mirrors kimmdy's data layout: a Topology whose atoms/bonds/angles/
proper_dihedrals/improper_dihedrals are dicts keyed by str atom-nr tuples,
atomic record types (Bond/Angle/Dihedral/MultipleDihedrals) as plain
attribute holders, and the Parameterizer plugin base class. Atom numbers
are 1-based strings like in real GROMACS/kimmdy topologies.

Install with install(), remove with uninstall().
"""
from __future__ import annotations

import importlib.machinery
import sys
import types
from typing import Dict, Optional

from grappa_tpu_torch.constants import ATOMIC_MASSES


class Parameterizer:
    """kimmdy.plugins.Parameterizer base (the real one is an ABC with a
    parameterize_topology hook)."""

    def __init__(self, *args, **kwargs):
        pass


class Atom:
    def __init__(self, nr: str, mass: float, charge: float,
                 is_radical: bool = False):
        self.nr = nr
        self.mass = mass
        self.charge = charge
        self.is_radical = is_radical


class Bond:
    def __init__(self, ai, aj, funct='1', c0=None, c1=None):
        self.ai, self.aj = ai, aj
        self.funct, self.c0, self.c1 = funct, c0, c1


class Angle:
    def __init__(self, ai, aj, ak, funct='1', c0=None, c1=None):
        self.ai, self.aj, self.ak = ai, aj, ak
        self.funct, self.c0, self.c1 = funct, c0, c1


class Dihedral:
    def __init__(self, ai, aj, ak, al, funct='9', c0=None, c1=None,
                 periodicity='1'):
        self.ai, self.aj, self.ak, self.al = ai, aj, ak, al
        self.funct, self.c0, self.c1 = funct, c0, c1
        self.periodicity = periodicity


class MultipleDihedrals:
    def __init__(self, ai, aj, ak, al, funct='9',
                 dihedrals: Optional[Dict[str, Dihedral]] = None):
        self.ai, self.aj, self.ak, self.al = ai, aj, ak, al
        self.funct = funct
        self.dihedrals = dihedrals or {}


class Topology:
    """Dict-based topology like kimmdy.topology.topology.Topology."""

    def __init__(self):
        self.atoms: Dict[str, Atom] = {}
        self.bonds: Dict[tuple, Bond] = {}
        self.angles: Dict[tuple, Angle] = {}
        self.proper_dihedrals: Dict[tuple, MultipleDihedrals] = {}
        self.improper_dihedrals: Dict[tuple, MultipleDihedrals] = {}


def topology_from_molecule(mol, radicals=()):
    """Build a kimmdy-style Topology from a grappa Molecule (atom ids become
    1-based nrs; tuple dicts prefilled with unparametrized entries).

    Deliberately uses DIFFERENT tuple orders than grappa's canonical ones —
    every second proper stored reversed, impropers stored as ONE entry per
    atom set in sorted order (real kimmdy/GROMACS topologies do not follow
    grappa's conventions) — so adapter tests exercise the clear-and-replace
    semantics rather than key-identity luck."""
    top = Topology()
    ids = [int(a) for a in mol.atoms]
    nr_of = {a: str(i + 1) for i, a in enumerate(ids)}
    for a, z, q in zip(ids, mol.atomic_numbers, mol.partial_charges):
        top.atoms[nr_of[a]] = Atom(nr_of[a], ATOMIC_MASSES[int(z)], float(q),
                                   is_radical=a in set(radicals))
    for a, b in mol.bonds:
        key = (nr_of[int(a)], nr_of[int(b)])
        top.bonds[key] = Bond(*key)
    for a, b, c in mol.angles:
        key = (nr_of[int(a)], nr_of[int(b)], nr_of[int(c)])
        top.angles[key] = Angle(*key)
    for i, t in enumerate(mol.propers):
        key = tuple(nr_of[int(x)] for x in t)
        if i % 2:
            key = key[::-1]
        top.proper_dihedrals[key] = MultipleDihedrals(*key, funct='9')
    seen_improper_sets = set()
    for t in mol.impropers:
        atom_set = frozenset(int(x) for x in t)
        if atom_set in seen_improper_sets:
            continue          # one entry per set, like a real topology
        seen_improper_sets.add(atom_set)
        key = tuple(nr_of[x] for x in sorted(atom_set))
        top.improper_dihedrals[key] = MultipleDihedrals(*key, funct='4')
    return top


def _module(name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
    return mod


def install():
    kimmdy = _module('kimmdy')
    plugins = _module('kimmdy.plugins')
    plugins.Parameterizer = Parameterizer
    topology_mod = _module('kimmdy.topology')
    atomic = _module('kimmdy.topology.atomic')
    for cls in (Atom, Bond, Angle, Dihedral, MultipleDihedrals):
        setattr(atomic, cls.__name__, cls)
    topology_mod.atomic = atomic
    kimmdy.plugins = plugins
    kimmdy.topology = topology_mod
    for name, mod in (('kimmdy', kimmdy), ('kimmdy.plugins', plugins),
                      ('kimmdy.topology', topology_mod),
                      ('kimmdy.topology.atomic', atomic)):
        sys.modules[name] = mod


def uninstall():
    for name in ('kimmdy', 'kimmdy.plugins', 'kimmdy.topology',
                 'kimmdy.topology.atomic'):
        sys.modules.pop(name, None)
