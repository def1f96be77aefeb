"""GROMACS integration: parametrize topology files with a grappa_tpu_torch
model.

Counterpart of `grappa_tpu.wrappers.gromacs_wrapper`. `GromacsGrappa`
subclasses the port's `api.Grappa`, so it is built as `(model, config,
device)` and its forwards run on the model's device (CUDA unless the
caller asks for another): one `predict_many` a moleculetype.

Counterpart of the reference wrapper + kimmdy glue (reference:
src/grappa/wrappers/gromacs_wrapper.py:31-86 and utils/kimmdy_utils.py:
62-240), built on the self-contained topology parser instead of kimmdy:

  * build a Molecule per [moleculetype] (ids = atom nrs, elements inferred
    from masses, charges from the [atoms] section)
  * predict bonded parameters, convert kcal/A/rad -> kJ/nm/deg
  * rewrite [bonds] (funct 1), [angles] (funct 1), [dihedrals] (funct 9
    propers with one line per periodicity, funct 4 periodic impropers)
  * partial re-parametrization: restrict predictions to a neighborhood of
    focus atoms (2 x field_of_view hops — the kimmdy radical workflow)

Water and monoatomic-ion molecule types are skipped.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

import numpy as np

from grappa_tpu_torch import constants, topology as topo
from grappa_tpu_torch.api import Grappa
from grappa_tpu_torch.data.molecule import Molecule
from grappa_tpu_torch.data.parameters import Parameters
from grappa_tpu_torch.wrappers.gromacs_topology import (
    SKIP_MOLECULES, GromacsTopology, MoleculeType)

KJ_PER_KCAL = 4.184
NM_PER_ANGSTROM = 0.1
DEG_PER_RAD = 180.0 / np.pi

# grappa -> gromacs conversion factors
BOND_EQ_FACTOR = NM_PER_ANGSTROM                      # A -> nm
BOND_K_FACTOR = KJ_PER_KCAL / NM_PER_ANGSTROM ** 2    # kcal/A^2 -> kJ/nm^2
ANGLE_EQ_FACTOR = DEG_PER_RAD                         # rad -> deg
ANGLE_K_FACTOR = KJ_PER_KCAL                          # kcal/rad^2 -> kJ/rad^2
TORSION_K_FACTOR = KJ_PER_KCAL
TORSION_PHASE_FACTOR = DEG_PER_RAD


def element_from_mass(mass: float) -> int:
    """Atomic number whose standard mass is closest (tolerates rounding;
    rejects heavy-hydrogen repartitioned topologies with a clear error)."""
    masses = np.array(list(constants.ATOMIC_MASSES.values()))
    numbers = np.array(list(constants.ATOMIC_MASSES.keys()))
    idx = int(np.argmin(np.abs(masses - mass)))
    if abs(masses[idx] - mass) > 0.3:
        raise ValueError(
            f"cannot infer element from mass {mass}; united-atom or "
            f"hydrogen-mass-repartitioned topologies are not supported — "
            f"provide standard atomic masses")
    return int(numbers[idx])


def _atomic_number(atom: Dict, type_info: Optional[Dict]) -> int:
    """Element resolution: [atomtypes] at.num column, else the atom row's
    mass, else the [atomtypes] mass. A missing mass is an ERROR — silently
    defaulting an unknown atom to hydrogen would produce garbage
    parameters without any signal."""
    info = (type_info or {}).get(atom['type'])
    if info is not None and info[0] is not None:
        return int(info[0])
    mass = atom['mass']
    if mass is None and info is not None:
        mass = info[1]
    if mass is None:
        raise ValueError(
            f"atom nr {atom['nr']} (type {atom['type']!r}) has no mass "
            f"column and no [atomtypes] entry — cannot infer the element; "
            f"parse the topology with resolve_includes=True or add masses")
    return element_from_mass(mass)


def molecule_from_moleculetype(mol_type: MoleculeType,
                               charge_model: str = 'amber99',
                               atom_filter: Optional[Set[int]] = None,
                               type_info: Optional[Dict] = None
                               ) -> Molecule:
    """type_info: GromacsTopology.atomtype_info() of the owning topology —
    used to resolve elements for atoms whose rows omit the mass column."""
    atoms = mol_type.atoms()
    if atom_filter is not None:
        atoms = [a for a in atoms if a['nr'] in atom_filter]
    keep = {a['nr'] for a in atoms}
    bonds = [(a, b) for a, b in mol_type.bonds() if a in keep and b in keep]
    impropers = [t for t in mol_type.improper_tuples()
                 if all(x in keep for x in t)]
    atomic_numbers = [_atomic_number(a, type_info) for a in atoms]
    return Molecule(
        atoms=[a['nr'] for a in atoms],
        bonds=bonds,
        impropers=impropers,
        atomic_numbers=atomic_numbers,
        partial_charges=[a['charge'] for a in atoms],
        improper_in_correct_format=False,
        charge_model=charge_model,
    )


def _connected_components(bonds: Iterable[Tuple[int, int]],
                          nodes: Set[int]) -> List[Set[int]]:
    """Connected components of the subgraph induced by `nodes` (single
    isolated atoms are dropped — nothing bonded to predict)."""
    nbrs = topo.neighbor_map([(a, b) for a, b in bonds
                              if a in nodes and b in nodes])
    seen: Set[int] = set()
    comps: List[Set[int]] = []
    for start in sorted(nodes):
        if start in seen:
            continue
        comp = {start}
        frontier = [start]
        while frontier:
            nxt = []
            for a in frontier:
                for b in nbrs.get(a, ()):
                    if b not in comp:
                        comp.add(b)
                        nxt.append(b)
            frontier = nxt
        seen |= comp
        if len(comp) >= 2:
            comps.append(comp)
    return comps


def fov_neighborhood(bonds: Iterable[Tuple[int, int]], focus: Set[int],
                     hops: int) -> Set[int]:
    """All atoms within `hops` bond steps of the focus set (inclusive)."""
    nbrs = topo.neighbor_map(list(bonds))
    current = set(focus)
    for _ in range(hops):
        grown = set(current)
        for a in current:
            grown.update(nbrs.get(a, ()))
        if grown == current:
            break
        current = grown
    return current


def gromacs_parameter_rows(params: Parameters,
                           apply_nrs: Optional[Set[int]] = None
                           ) -> Dict[str, List[str]]:
    """Parameters (grappa units) -> formatted topology rows per section."""
    def ok(tup):
        return apply_nrs is None or all(int(x) in apply_nrs for x in tup)

    rows: Dict[str, List[str]] = {'bonds': [], 'angles': [],
                                  'propers': [], 'impropers': []}
    for i, (a, b) in enumerate(params.bonds):
        if not ok((a, b)):
            continue
        rows['bonds'].append(
            f"{a:6d} {b:6d}  1  {params.bond_eq[i] * BOND_EQ_FACTOR:12.6f} "
            f"{params.bond_k[i] * BOND_K_FACTOR:14.4f}")
    for i, (a, b, c) in enumerate(params.angles):
        if not ok((a, b, c)):
            continue
        rows['angles'].append(
            f"{a:6d} {b:6d} {c:6d}  1  "
            f"{params.angle_eq[i] * ANGLE_EQ_FACTOR:12.4f} "
            f"{params.angle_k[i] * ANGLE_K_FACTOR:14.4f}")
    for key, tuples, ks, phases, funct in (
            ('propers', params.propers, params.proper_ks,
             params.proper_phases, 9),
            ('impropers', params.impropers, params.improper_ks,
             params.improper_phases, 4)):
        if tuples is None:
            continue
        for i, tup in enumerate(tuples):
            if not ok(tup):
                continue
            a, b, c, d = (int(x) for x in tup)
            for n in range(ks.shape[1]):
                rows[key].append(
                    f"{a:6d} {b:6d} {c:6d} {d:6d}  {funct}  "
                    f"{phases[i, n] * TORSION_PHASE_FACTOR:10.4f} "
                    f"{ks[i, n] * TORSION_K_FACTOR:12.6f}  {n + 1}")
    return rows


def filter_parameters(params: Parameters,
                      apply_nrs: Set[int]) -> Parameters:
    """Parameters restricted to tuples whose atoms all lie in apply_nrs
    (what a partial reparametrization actually writes)."""
    def mask(tuples):
        return np.array([all(int(x) in apply_nrs for x in t)
                         for t in tuples], bool)

    mb = mask(params.bonds)
    ma = mask(params.angles)
    mp = mask(params.propers)
    mi = mask(params.impropers) if params.impropers is not None else None
    return Parameters(
        atoms=params.atoms,
        bonds=params.bonds[mb], bond_k=params.bond_k[mb],
        bond_eq=params.bond_eq[mb],
        angles=params.angles[ma], angle_k=params.angle_k[ma],
        angle_eq=params.angle_eq[ma],
        propers=params.propers[mp], proper_ks=params.proper_ks[mp],
        proper_phases=params.proper_phases[mp],
        impropers=None if mi is None else params.impropers[mi],
        improper_ks=None if mi is None else params.improper_ks[mi],
        improper_phases=None if mi is None else params.improper_phases[mi],
    )


class GromacsGrappa(Grappa):
    """Grappa with a `parametrize(top_path, out_path)` GROMACS entry point."""

    def parametrize(self, top_path: Union[str, Path],
                    out_path: Union[str, Path] = None,
                    charge_model: str = 'amber99',
                    focus_nrs: Optional[Set[int]] = None,
                    check_eq_values: bool = True,
                    resolve_includes: bool = False) -> GromacsTopology:
        """resolve_includes inlines #include'd molecule .itp files present
        next to the topology (their parametrized content then lives in the
        output .top); absent force-field includes stay verbatim."""
        top_path = Path(top_path)
        out_path = Path(out_path) if out_path else top_path.with_name(
            top_path.stem + '_grappa' + top_path.suffix)
        top = GromacsTopology.parse(top_path, resolve_includes=resolve_includes)

        # predictions of this run, per moleculetype: [(Parameters,
        # apply_nrs or None), ...] — one entry per connected component.
        # Consumers (e.g. grappa_gmx --plot) read these instead of
        # re-deriving the FOV subgraphs and re-running the model.
        self.last_predictions: Dict[str, List] = {}

        for mol_type in top.molecule_types():
            if mol_type.name.upper() in SKIP_MOLECULES:
                continue
            if len(mol_type.atom_rows()) < 2:
                continue
            self._parametrize_moleculetype(
                top, mol_type, charge_model=charge_model,
                focus_nrs=focus_nrs, check_eq_values=check_eq_values)

        top.save(out_path)
        return top

    def _parametrize_moleculetype(self, top: GromacsTopology,
                                  mol_type: MoleculeType, charge_model: str,
                                  focus_nrs: Optional[Set[int]],
                                  check_eq_values: bool = True):
        bonds = mol_type.bonds()
        if not bonds:
            return
        if focus_nrs:
            # kimmdy-style partial reparametrization: predict on a double
            # field-of-view neighborhood, apply within a single one
            apply_nrs = fov_neighborhood(bonds, set(focus_nrs),
                                         self.field_of_view)
            build_nrs = fov_neighborhood(bonds, apply_nrs,
                                         self.field_of_view)
        else:
            apply_nrs = None
            build_nrs = None

        type_info = top.atomtype_info()
        if build_nrs is None:
            components = [None]
        else:
            # several distant focus atoms (e.g. two radical sites from a
            # homolysis) can make the field-of-view subgraph disconnected;
            # predict per connected component instead of rejecting
            components = _connected_components(bonds, build_nrs)
        all_rows: Dict[str, List[str]] = {'bonds': [], 'angles': [],
                                          'propers': [], 'impropers': []}
        comp_mols = [molecule_from_moleculetype(
            mol_type, charge_model=charge_model, atom_filter=comp,
            type_info=type_info) for comp in components]
        # one padded forward for all components (predict_many)
        all_params = self.predict_many(comp_mols,
                                       check_eq_values=check_eq_values)
        for comp, params in zip(components, all_params):
            comp_apply = (apply_nrs if comp is None
                          else apply_nrs & comp)
            if hasattr(self, 'last_predictions'):
                self.last_predictions.setdefault(
                    mol_type.name, []).append((params, comp_apply))
            rows = gromacs_parameter_rows(params, comp_apply)
            for k in all_rows:
                all_rows[k] += rows[k]
        rows = all_rows

        if apply_nrs is None:
            mol_type.section('bonds').replace_data(rows['bonds'])
            if mol_type.section('angles') is None:
                top._append_section(mol_type, 'angles')
            mol_type.section('angles').replace_data(rows['angles'])
            prop_sec, imp_sec = top.ensure_dihedral_sections(mol_type)
            prop_sec.replace_data(rows['propers'])
            imp_sec.replace_data(rows['impropers'])
        else:
            self._merge_partial(top, mol_type, rows, apply_nrs)

    @staticmethod
    def _merge_partial(top: GromacsTopology, mol_type: MoleculeType,
                       rows: Dict[str, List[str]], apply_nrs: Set[int]):
        """Replace only entries whose atoms all lie inside apply_nrs."""
        def outside(row_tokens, arity):
            return not all(int(x) in apply_nrs for x in row_tokens[:arity])

        for name, arity, new_key in (('bonds', 2, 'bonds'),
                                     ('angles', 3, 'angles')):
            sec = mol_type.section(name)
            if sec is None:
                continue
            kept = [' '.join(r) for r in sec.data_rows() if outside(r, arity)]
            sec.replace_data(kept + rows[new_key])

        prop_sec, imp_sec = top.ensure_dihedral_sections(mol_type)
        for sec, key, functs in ((prop_sec, 'propers', ('9', '1')),
                                 (imp_sec, 'impropers', ('4', '2'))):
            # remove ONLY rows being rewritten (inside apply_nrs AND of a
            # funct this pass replaces); everything else — other functs
            # (e.g. RB funct 3, or funct-4 rows living in a mixed
            # dihedrals section) and rows outside the focus — survives
            kept = [' '.join(r) for r in sec.data_rows()
                    if len(r) < 5 or r[4] not in functs or outside(r, 4)]
            sec.replace_data(kept + rows[key])
