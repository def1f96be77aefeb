"""amber99sbildn* ("-star") force field machinery: HYP / DOP support.

Counterpart of `grappa_tpu.wrappers.star_forcefield` (the port's own
copy of the residue templates).

Counterpart of the reference's `get_openmm_forcefield` + `topology_from_pdb`
(reference: src/grappa/utils/openmm_utils.py:291-340) and its shipped
`amber99sbildn-star_.xml`. The reference distributes a full 480 kB merged
XML; here the same capability is built first-party as a *patch*: openmm
already ships `amber99sbildn.xml`, so only the two non-standard residue
templates (hydroxyproline HYP, dihydroxyphenylalanine DOP) plus their atom
types and nonbonded parameters need to be generated and passed to
`openmm.app.ForceField` alongside the stock file — the class-based bonded
parameters of amber99sbildn then apply to the new types automatically.

The residue template data below (atom names, amber99 atom classes,
elements, masses, partial charges, LJ sigma/epsilon in openmm units, and
the template bond graph) are the scientific parameters of the reference's
XML residue entries (amber99sbildn-star_.xml: HYP types 1983-1997, DOP
types 1961-1982) — parameter values define force-field semantics and must
match for parity, exactly like IMPROPER_CENTRAL_IDX.

All openmm interaction is import-gated; the test suite executes this module
against the first-party openmm double (tests/openmm_double.py).
"""
from __future__ import annotations

import importlib
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

# (atom name, amber class, element, mass, charge e, sigma nm, epsilon kJ/mol)
HYP_ATOMS: List[Tuple[str, str, str, float, float, float, float]] = [
    ('N',    'N',  'N', 14.01,  -0.25480, 3.25000e-01, 7.11280e-01),
    ('CD2',  'CT', 'C', 12.01,   0.05950, 3.39967e-01, 4.57730e-01),
    ('HD21', 'H1', 'H', 1.008,   0.07000, 2.47135e-01, 6.56888e-02),
    ('HD22', 'H1', 'H', 1.008,   0.07000, 2.47135e-01, 6.56888e-02),
    ('CG',   'CT', 'C', 12.01,   0.04000, 3.39967e-01, 4.57730e-01),
    ('HG',   'H1', 'H', 1.008,   0.04160, 2.47135e-01, 6.56888e-02),
    ('OD1',  'OH', 'O', 16.00,  -0.61340, 3.06647e-01, 8.80314e-01),
    ('HD1',  'HO', 'H', 1.008,   0.38510, 0.0,         0.0),
    ('CB',   'CT', 'C', 12.01,   0.02030, 3.39967e-01, 4.57730e-01),
    ('HB1',  'HC', 'H', 1.008,   0.04260, 2.64953e-01, 6.56888e-02),
    ('HB2',  'HC', 'H', 1.008,   0.04260, 2.64953e-01, 6.56888e-02),
    ('CA',   'CT', 'C', 12.01,   0.00470, 3.39967e-01, 4.57730e-01),
    ('HA',   'H1', 'H', 1.008,   0.07700, 2.47135e-01, 6.56888e-02),
    ('C',    'C',  'C', 12.01,   0.58960, 3.39967e-01, 3.59824e-01),
    ('O',    'O',  'O', 16.00,  -0.57480, 2.95992e-01, 8.78640e-01),
]
HYP_BOND_IDXS = [(0, 1), (0, 11), (1, 2), (1, 3), (1, 4), (4, 5), (4, 6),
                 (4, 8), (6, 7), (8, 9), (8, 10), (8, 11), (11, 12),
                 (11, 13), (13, 14)]
HYP_EXTERNAL = [13, 0]          # C (to next residue's N), N (to prev C)

DOP_ATOMS: List[Tuple[str, str, str, float, float, float, float]] = [
    ('N',   'N',  'N', 14.01,  -0.41570, 3.25000e-01, 7.11280e-01),
    ('H',   'H',  'H', 1.008,   0.27190, 1.06908e-01, 6.56888e-02),
    ('CA',  'CT', 'C', 12.01,  -0.09192, 3.39967e-01, 4.57730e-01),
    ('HA',  'H1', 'H', 1.008,   0.12423, 2.47135e-01, 6.56888e-02),
    ('CB',  'CT', 'C', 12.01,  -0.07334, 3.39967e-01, 4.57730e-01),
    ('HB1', 'HC', 'H', 1.008,   0.07485, 2.64953e-01, 6.56888e-02),
    ('HB2', 'HC', 'H', 1.008,   0.07485, 2.64953e-01, 6.56888e-02),
    ('CG',  'CA', 'C', 12.01,   0.00415, 3.39967e-01, 3.59824e-01),
    ('CD1', 'CA', 'C', 12.01,  -0.18682, 3.39967e-01, 3.59824e-01),
    ('HD1', 'HA', 'H', 1.008,   0.19644, 2.59964e-01, 6.27600e-02),
    ('CE1', 'CA', 'C', 12.01,  -0.34668, 3.39967e-01, 3.59824e-01),
    ('HE1', 'HA', 'H', 1.008,   0.18979, 2.59964e-01, 6.27600e-02),
    ('CZ',  'C',  'C', 12.01,   0.25093, 3.39967e-01, 3.59824e-01),
    ('OH1', 'OH', 'O', 16.00,  -0.66648, 3.06647e-01, 8.80314e-01),
    ('HH1', 'HO', 'H', 1.008,   0.47708, 0.0,         0.0),
    ('CE2', 'CA', 'C', 12.01,   0.36462, 3.39967e-01, 3.59824e-01),
    ('OH2', 'OH', 'O', 16.00,  -0.63628, 3.06647e-01, 8.80314e-01),
    ('HH2', 'HO', 'H', 1.008,   0.47708, 0.0,         0.0),
    ('CD2', 'CA', 'C', 12.01,  -0.33398, 3.39967e-01, 3.59824e-01),
    ('HD2', 'HA', 'H', 1.008,   0.21588, 2.59964e-01, 6.27600e-02),
    ('C',   'C',  'C', 12.01,   0.59730, 3.39967e-01, 3.59824e-01),
    ('O',   'O',  'O', 16.00,  -0.56790, 2.95992e-01, 8.78640e-01),
]
DOP_BOND_IDXS = [(0, 1), (0, 2), (2, 3), (2, 4), (2, 20), (4, 5), (4, 6),
                 (4, 7), (7, 8), (7, 18), (8, 9), (8, 10), (10, 11),
                 (10, 12), (12, 13), (12, 15), (13, 14), (15, 16), (16, 17),
                 (15, 18), (18, 19), (20, 21)]
DOP_EXTERNAL = [20, 0]

STAR_RESIDUES = {
    'HYP': (HYP_ATOMS, HYP_BOND_IDXS, HYP_EXTERNAL),
    'DOP': (DOP_ATOMS, DOP_BOND_IDXS, DOP_EXTERNAL),
}


def residue_bond_templates() -> Dict[str, List[Tuple[str, str]]]:
    """Intra-residue bonds by atom name, for topology repair (hyp_dop.py)."""
    out = {}
    for res, (atoms, bonds, _) in STAR_RESIDUES.items():
        names = [a[0] for a in atoms]
        out[res] = [(names[i], names[j]) for i, j in bonds]
    return out


def build_star_patch_xml() -> str:
    """ForceField patch XML adding the HYP/DOP residue templates.

    Passed to openmm.app.ForceField TOGETHER WITH amber99sbildn.xml: the
    atom types reference stock amber99 classes, so amber99sbildn's
    class-based bonded parameters apply to the new residues automatically.
    """
    lines = ['<ForceField>', ' <AtomTypes>']
    for res, (atoms, _, _) in STAR_RESIDUES.items():
        for name, klass, element, mass, *_ in atoms:
            lines.append(
                f'  <Type name="grappa-star-{res}-{name}" class="{klass}" '
                f'element="{element}" mass="{mass}"/>')
    lines.append(' </AtomTypes>')
    lines.append(' <Residues>')
    for res, (atoms, bonds, external) in STAR_RESIDUES.items():
        lines.append(f'  <Residue name="{res}">')
        for name, *_ in atoms:
            lines.append(f'   <Atom name="{name}" '
                         f'type="grappa-star-{res}-{name}"/>')
        for i, j in bonds:
            lines.append(f'   <Bond from="{i}" to="{j}"/>')
        for i in external:
            lines.append(f'   <ExternalBond from="{i}"/>')
        lines.append('  </Residue>')
    lines.append(' </Residues>')
    lines.append(' <NonbondedForce coulomb14scale="0.8333333333333334" '
                 'lj14scale="0.5">')
    for res, (atoms, _, _) in STAR_RESIDUES.items():
        for name, _klass, _el, _mass, charge, sigma, epsilon in atoms:
            lines.append(
                f'  <Atom type="grappa-star-{res}-{name}" charge="{charge}" '
                f'sigma="{sigma}" epsilon="{epsilon}"/>')
    lines.append(' </NonbondedForce>')
    lines.append('</ForceField>')
    return '\n'.join(lines)


def _require_openmm():
    if importlib.util.find_spec('openmm') is None:
        raise ImportError('openmm is required for force-field construction')


class StarForceField:
    """amber99sbildn + HYP/DOP patch; repairs the topology before
    createSystem (openmm.PDBFile cannot infer the non-standard residues'
    bonds — reference openmm_utils.py:321-337)."""

    def __init__(self, forcefield):
        self.ff = forcefield

    def createSystem(self, topology, *args, **kwargs):
        from grappa_tpu_torch.wrappers.hyp_dop import (
            add_nonstandard_residue_bonds)
        add_nonstandard_residue_bonds(topology)
        return self.ff.createSystem(topology, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.ff, name)


def get_openmm_forcefield(name: str, *args, **kwargs):
    """Name with or without .xml; 'amber99sbildn*' / 'amber99sbildn-star'
    resolves to amber99sbildn + the first-party HYP/DOP patch."""
    _require_openmm()
    from openmm.app import ForceField
    if name.endswith('.xml'):
        name = name[:-4]
    if name in ('amber99sbildn*', 'amber99sbildn-star'):
        patch_dir = Path(tempfile.mkdtemp(prefix='grappa_star_'))
        patch_path = patch_dir / 'amber99sbildn-star-patch.xml'
        patch_path.write_text(build_star_patch_xml())
        ff = ForceField('amber99sbildn.xml', str(patch_path), *args, **kwargs)
        return StarForceField(ff)
    return ForceField(name + '.xml', *args, **kwargs)


def topology_from_pdb(pdbstring: str):
    """openmm Topology from a PDB file content string (reference
    openmm_utils.py:291-303)."""
    _require_openmm()
    from openmm.app import PDBFile
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / 'input.pdb'
        path.write_text(pdbstring)
        return PDBFile(str(path)).topology
