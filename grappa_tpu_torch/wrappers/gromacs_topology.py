"""Self-contained GROMACS topology (.top/.itp) reader/writer.

Counterpart of `grappa_tpu.wrappers.gromacs_topology` (the port's own
copy: pure Python, nothing of it runs on the card).

The reference delegates GROMACS I/O to the external kimmdy package
(reference: src/grappa/wrappers/gromacs_wrapper.py:31-86); this module makes
the framework standalone: it parses the directive structure of a topology
file, exposes per-[moleculetype] views of the bonded sections, lets the
wrapper replace bonded parameters, and writes the file back with all
untouched lines (preprocessor directives, comments, unknown sections)
preserved verbatim.

Supported for editing: [atoms], [bonds] (funct 1), [angles] (funct 1),
[dihedrals] (funct 9 propers, funct 4 periodic impropers). Everything else
round-trips untouched.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

_SECTION_RE = re.compile(r'^\s*\[\s*(\S+)\s*\]\s*(;.*)?$')

# residue/molecule names never parametrized (water & monoatomic ions)
SKIP_MOLECULES = {
    'SOL', 'WAT', 'HOH', 'TIP3', 'TIP4', 'TIP5', 'SPC', 'SPCE',
    'NA', 'CL', 'K', 'MG', 'CA', 'ZN', 'NA+', 'CL-', 'K+', 'MG2+', 'CA2+',
}


@dataclass
class Section:
    name: str
    header_line: str
    rows: List[str] = field(default_factory=list)   # raw lines (with comments)

    def data_rows(self) -> List[List[str]]:
        """Tokenized non-comment, non-preprocessor rows."""
        out = []
        for line in self.rows:
            stripped = line.split(';')[0].strip()
            if not stripped or stripped.startswith('#'):
                continue
            out.append(stripped.split())
        return out

    def replace_data(self, new_rows: Sequence[str]):
        """Swap all data lines for new ones; keep leading comment lines."""
        kept = []
        for line in self.rows:
            stripped = line.split(';')[0].strip()
            if not stripped or stripped.startswith('#'):
                kept.append(line)
            else:
                break  # comments after data start are dropped with the data
        self.rows = kept + [str(r) for r in new_rows]


@dataclass
class MoleculeType:
    """One [moleculetype] block: its own section plus following sections."""
    sections: List[Section]

    @property
    def name(self) -> str:
        rows = self.sections[0].data_rows()
        return rows[0][0] if rows else ''

    def section(self, name: str) -> Optional[Section]:
        for s in self.sections:
            if s.name == name:
                return s
        return None

    def all_sections(self, name: str) -> List[Section]:
        return [s for s in self.sections if s.name == name]

    def atom_rows(self) -> List[List[str]]:
        sec = self.section('atoms')
        return sec.data_rows() if sec else []

    def atoms(self) -> List[Dict]:
        """[{nr, type, resnr, residue, atom, cgnr, charge, mass}]"""
        out = []
        for row in self.atom_rows():
            entry = {
                'nr': int(row[0]), 'type': row[1], 'resnr': int(row[2]),
                'residue': row[3], 'atom': row[4], 'cgnr': int(row[5]),
                'charge': float(row[6]) if len(row) > 6 else 0.0,
                'mass': float(row[7]) if len(row) > 7 else None,
            }
            out.append(entry)
        return out

    def bonds(self) -> List[Tuple[int, int]]:
        sec = self.section('bonds')
        if sec is None:
            return []
        return [(int(r[0]), int(r[1])) for r in sec.data_rows()]

    def dihedral_rows(self) -> List[Tuple[Section, List[str]]]:
        out = []
        for sec in self.all_sections('dihedrals'):
            for row in sec.data_rows():
                out.append((sec, row))
        return out

    def proper_tuples(self) -> List[Tuple[int, int, int, int]]:
        return [tuple(int(x) for x in row[:4])
                for _, row in self.dihedral_rows()
                if len(row) >= 5 and row[4] in ('9', '1')]

    def improper_tuples(self) -> List[Tuple[int, int, int, int]]:
        return [tuple(int(x) for x in row[:4])
                for _, row in self.dihedral_rows()
                if len(row) >= 5 and row[4] in ('4', '2')]


@dataclass
class GromacsTopology:
    """The whole file: a flat list of raw lines and Sections, in order."""
    elements: List[Union[str, Section]]

    @classmethod
    def parse(cls, source: Union[str, Path],
              resolve_includes: bool = False) -> 'GromacsTopology':
        """Parse a .top/.itp file or literal text. With resolve_includes,
        #include "file.itp" lines whose target exists relative to the source
        file are inlined (force-field includes that are absent, e.g.
        amber99.ff/..., are kept verbatim)."""
        is_path = (isinstance(source, Path)
                   or ('\n' not in str(source) and Path(str(source)).exists()))
        base_dir = Path(source).parent if is_path else Path('.')
        text = Path(source).read_text() if is_path else str(source)

        lines = text.splitlines()
        if resolve_includes:
            lines = cls._inline_includes(lines, base_dir, depth=0)

        elements: List[Union[str, Section]] = []
        current: Optional[Section] = None
        for line in lines:
            m = _SECTION_RE.match(line)
            if m:
                current = Section(name=m.group(1).lower(), header_line=line)
                elements.append(current)
            elif current is not None and not line.strip().startswith('['):
                current.rows.append(line)
            else:
                elements.append(line)
        return cls(elements)

    @staticmethod
    def _inline_includes(lines, base_dir: Path, depth: int):
        if depth > 8:
            raise ValueError("include nesting too deep (cycle?)")
        out: List[str] = []
        for line in lines:
            stripped = line.strip()
            if stripped.startswith('#include'):
                m = re.search(r'#include\s+"([^"]+)"', stripped)
                target = base_dir / m.group(1) if m else None
                if target is not None and target.exists():
                    out.append(f'; inlined from {m.group(1)}')
                    out.extend(GromacsTopology._inline_includes(
                        target.read_text().splitlines(), target.parent,
                        depth + 1))
                    continue
            out.append(line)
        return out

    def write(self) -> str:
        out: List[str] = []
        for el in self.elements:
            if isinstance(el, Section):
                out.append(el.header_line)
                out.extend(el.rows)
            else:
                out.append(el)
        return '\n'.join(out) + '\n'

    def save(self, path: Union[str, Path]):
        Path(path).write_text(self.write())

    def atomtype_info(self) -> Dict[str, Tuple[Optional[int], Optional[float]]]:
        """{type name: (atomic number or None, mass or None)} from the
        global [atomtypes] sections. Column layouts vary (optional bonded
        type / at.num columns); the particle-type letter (A/S/V/D) anchors
        the row: mass is two fields before it, and the field before the
        mass is the atomic number when it parses as a small integer."""
        info: Dict[str, Tuple[Optional[int], Optional[float]]] = {}
        for el in self.elements:
            if not (isinstance(el, Section) and el.name == 'atomtypes'):
                continue
            for row in el.data_rows():
                ptype_idx = next(
                    (i for i, f in enumerate(row)
                     if i >= 3 and f in ('A', 'S', 'V', 'D')), None)
                if ptype_idx is None or ptype_idx < 2:
                    continue
                try:
                    mass = float(row[ptype_idx - 2])
                except ValueError:
                    continue
                atnum: Optional[int] = None
                if ptype_idx >= 3:
                    try:
                        cand = int(row[ptype_idx - 3])
                        if 0 < cand < 119:
                            atnum = cand
                    except ValueError:
                        pass
                info[row[0]] = (atnum, mass)
        return info

    def molecule_types(self) -> List[MoleculeType]:
        """Group sections into [moleculetype] blocks."""
        mols: List[MoleculeType] = []
        current: Optional[List[Section]] = None
        for el in self.elements:
            if not isinstance(el, Section):
                continue
            if el.name == 'moleculetype':
                if current:
                    mols.append(MoleculeType(current))
                current = [el]
            elif el.name in ('system', 'molecules'):
                if current:
                    mols.append(MoleculeType(current))
                    current = None
            elif current is not None:
                current.append(el)
        if current:
            mols.append(MoleculeType(current))
        return mols

    def ensure_dihedral_sections(self, mol: MoleculeType
                                 ) -> Tuple[Section, Section]:
        """Return (proper_section, improper_section), creating the improper
        one after the last dihedrals section if missing."""
        dihedral_secs = mol.all_sections('dihedrals')
        propers = [s for s in dihedral_secs
                   if any(r[4] in ('9', '1') for r in s.data_rows()
                          if len(r) >= 5)]
        impropers = [s for s in dihedral_secs
                     if any(r[4] in ('4', '2') for r in s.data_rows()
                            if len(r) >= 5)]
        prop = propers[0] if propers else (
            dihedral_secs[0] if dihedral_secs else None)
        if prop is None:
            prop = self._append_section(mol, 'dihedrals')
        imp = impropers[0] if impropers else None
        if imp is None or imp is prop:
            imp = self._append_section(mol, 'dihedrals', after=prop)
        return prop, imp

    def _append_section(self, mol: MoleculeType, name: str,
                        after: Optional[Section] = None) -> Section:
        anchor = after or mol.sections[-1]
        idx = self.elements.index(anchor)
        sec = Section(name=name, header_line=f'[ {name} ]')
        self.elements.insert(idx + 1, sec)
        mol.sections.insert(mol.sections.index(anchor) + 1, sec)
        return sec
