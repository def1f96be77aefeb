"""SI-based unit algebra, free of any MD-engine dependency.

Mirrors the semantics of the reference unit system (reference:
src/grappa/units.py:6-120 defines an openmm-like Unit/Quantity built on the
seven SI base dimensions) but is written from scratch as a compact,
hashable, immutable implementation.

A :class:`Unit` is a scale factor relative to coherent SI units together
with an exponent vector over the seven SI base dimensions
(m, kg, s, A, K, mol, cd). A :class:`Quantity` is a value (scalar or
numpy array) together with a Unit.
"""
from __future__ import annotations

import numpy as np
from dataclasses import dataclass
from typing import Tuple, Union

# order of the SI base dimensions in the exponent tuple
_DIMS = ("m", "kg", "s", "A", "K", "mol", "cd")
_ZERO = (0, 0, 0, 0, 0, 0, 0)


def _dim_add(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(x + y for x, y in zip(a, b))


def _dim_sub(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(x - y for x, y in zip(a, b))


def _dim_mul(a: Tuple[int, ...], k: int) -> Tuple[int, ...]:
    return tuple(x * k for x in a)


@dataclass(frozen=True)
class Unit:
    """A physical unit: SI scale factor + base-dimension exponents."""

    scale: float
    dims: Tuple[int, int, int, int, int, int, int] = _ZERO
    name: str = ""

    # make `np.ndarray * unit` defer to Unit.__rmul__ (one Quantity holding
    # the array) instead of numpy broadcasting into an object array
    __array_ufunc__ = None

    def __mul__(self, other: "Unit") -> "Unit":
        if isinstance(other, Unit):
            return Unit(self.scale * other.scale, _dim_add(self.dims, other.dims),
                        f"{self.name}*{other.name}" if self.name and other.name else "")
        if isinstance(other, (int, float, np.number, np.ndarray)):
            # unit * value: same Quantity as value * unit (openmm accepts
            # both orders; __array_ufunc__ = None stops numpy from
            # broadcasting Unit into an object array first)
            return Quantity(other, self)
        return NotImplemented

    def __rmul__(self, other):
        # np.number covers numpy scalars (np.float32(…) * unit)
        if isinstance(other, (int, float, np.number, np.ndarray)):
            return Quantity(other, self)
        return NotImplemented

    def __truediv__(self, other: "Unit") -> "Unit":
        if isinstance(other, Unit):
            return Unit(self.scale / other.scale, _dim_sub(self.dims, other.dims),
                        f"{self.name}/{other.name}" if self.name and other.name else "")
        return NotImplemented

    def __rtruediv__(self, other):
        # 1.0 / picosecond — the standard openmm inverse-unit idiom
        if isinstance(other, (int, float, np.number, np.ndarray)):
            return Quantity(other, self ** -1)
        return NotImplemented

    def __pow__(self, k: int) -> "Unit":
        return Unit(self.scale ** k, _dim_mul(self.dims, k),
                    f"{self.name}**{k}" if self.name else "")

    def conversion_factor_to(self, other: "Unit") -> float:
        if self.dims != other.dims:
            raise ValueError(
                f"Incompatible units: dims {self.dims} vs {other.dims}")
        return self.scale / other.scale

    def is_compatible(self, other: "Unit") -> bool:
        return self.dims == other.dims

    def __repr__(self):
        return self.name or f"Unit(scale={self.scale}, dims={self.dims})"


class Quantity:
    """A value with a unit; value may be a scalar or numpy array."""

    __array_ufunc__ = None   # numpy defers to our reflected operators

    def __init__(self, value: Union[float, np.ndarray], unit: Unit):
        self.value = value
        self.unit = unit

    def value_in_unit(self, unit: Unit):
        return self.value * self.unit.conversion_factor_to(unit)

    def in_units_of(self, unit: Unit) -> "Quantity":
        return Quantity(self.value_in_unit(unit), unit)

    def __mul__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.value * other.value, self.unit * other.unit)
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit * other)
        return Quantity(self.value * other, self.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.value / other.value, self.unit / other.unit)
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit / other)
        return Quantity(self.value / other, self.unit)

    def __rtruediv__(self, other):
        # scalar / Quantity -> Quantity in the inverse unit
        if isinstance(other, (int, float, np.number, np.ndarray)):
            return Quantity(other / self.value, self.unit ** -1)
        return NotImplemented

    def __add__(self, other: "Quantity"):
        return Quantity(self.value + other.value_in_unit(self.unit), self.unit)

    def __sub__(self, other: "Quantity"):
        return Quantity(self.value - other.value_in_unit(self.unit), self.unit)

    def __neg__(self):
        return Quantity(-self.value, self.unit)

    def __eq__(self, other):
        if not isinstance(other, Quantity):
            return NotImplemented
        return self.unit.is_compatible(other.unit) and np.allclose(
            self.value, other.value_in_unit(self.unit))

    def __repr__(self):
        return f"Quantity({self.value}, {self.unit})"


# ------------------------------------------------------------------
# base units (coherent SI)
meter = Unit(1.0, (1, 0, 0, 0, 0, 0, 0), "meter")
kilogram = Unit(1.0, (0, 1, 0, 0, 0, 0, 0), "kilogram")
second = Unit(1.0, (0, 0, 1, 0, 0, 0, 0), "second")
ampere = Unit(1.0, (0, 0, 0, 1, 0, 0, 0), "ampere")
kelvin = Unit(1.0, (0, 0, 0, 0, 1, 0, 0), "kelvin")
mole = Unit(1.0, (0, 0, 0, 0, 0, 1, 0), "mole")
candela = Unit(1.0, (0, 0, 0, 0, 0, 0, 1), "candela")

dimensionless = Unit(1.0, _ZERO, "dimensionless")
radian = Unit(1.0, _ZERO, "radian")
degree = Unit(np.pi / 180.0, _ZERO, "degree")

# lengths
nanometer = Unit(1e-9, meter.dims, "nanometer")
angstrom = Unit(1e-10, meter.dims, "angstrom")

# mass
gram = Unit(1e-3, kilogram.dims, "gram")
dalton = Unit(1.66053906660e-27, kilogram.dims, "dalton")
amu = dalton

# time
picosecond = Unit(1e-12, second.dims, "picosecond")
femtosecond = Unit(1e-15, second.dims, "femtosecond")

# energy: joule = kg m^2 / s^2
joule = Unit(1.0, (2, 1, -2, 0, 0, 0, 0), "joule")
kilojoule = Unit(1e3, joule.dims, "kilojoule")
calorie = Unit(4.184, joule.dims, "calorie")
kilocalorie = Unit(4184.0, joule.dims, "kilocalorie")

# molar energies (energy / mol)
kilojoule_per_mol = kilojoule / mole
kilojoule_per_mol = Unit(kilojoule_per_mol.scale, kilojoule_per_mol.dims,
                         "kilojoule_per_mol")
kilocalorie_per_mol = kilocalorie / mole
kilocalorie_per_mol = Unit(kilocalorie_per_mol.scale, kilocalorie_per_mol.dims,
                           "kilocalorie_per_mol")
# aliases matching common naming
kilojoule_per_mole = kilojoule_per_mol
kilocalorie_per_mole = kilocalorie_per_mol
kcal_per_mol = kilocalorie_per_mol
kj_per_mol = kilojoule_per_mol

# charge
coulomb = Unit(1.0, (0, 0, 1, 1, 0, 0, 0), "coulomb")
elementary_charge = Unit(1.602176634e-19, coulomb.dims, "elementary_charge")

# convenience: GROMACS unit system
GROMACS_LENGTH = nanometer
GROMACS_ENERGY = kilojoule_per_mol
GROMACS_ANGLE = degree

__all__ = [
    "Unit", "Quantity", "meter", "kilogram", "second", "ampere", "kelvin",
    "mole", "candela", "dimensionless", "radian", "degree", "nanometer",
    "angstrom", "gram", "dalton", "amu", "picosecond", "femtosecond", "joule",
    "kilojoule", "calorie", "kilocalorie", "kilojoule_per_mol",
    "kilocalorie_per_mol", "kilojoule_per_mole", "kilocalorie_per_mole",
    "kcal_per_mol", "kj_per_mol", "coulomb", "elementary_charge",
    "GROMACS_LENGTH", "GROMACS_ENERGY", "GROMACS_ANGLE",
]
