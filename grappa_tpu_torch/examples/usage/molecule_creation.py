"""Building a Molecule from lists (reference:
examples/wrapper_construction/molecule_creation.py).

A Molecule needs: unique atom ids (identifiers, not necessarily indices --
sub-molecules of a larger topology can keep the parent's numbering), bonds
as id pairs, improper torsion tuples (order-insensitive: grappa detects the
central atom and canonicalizes; impropers cannot be inferred from the graph
because force fields only use some of the candidates), atomic numbers and
partial charges in atom-id order.

    python -m grappa_tpu_torch.examples.usage.molecule_creation
"""
import numpy as np

from grappa_tpu_torch.data import Molecule


def main(argv=None):
    # methane, with ids starting at 1 to show ids are not indices
    methane = Molecule(
        atoms=[1, 2, 3, 4, 5],
        bonds=[(1, 2), (1, 3), (1, 4), (1, 5)],
        impropers=[],
        atomic_numbers=[6, 1, 1, 1, 1],
        partial_charges=[-0.4, 0.1, 0.1, 0.1, 0.1],
    )
    print(methane)
    print("angles:", methane.angles.tolist())
    print("propers:", methane.propers.tolist())      # none in methane

    # a trivalent center: give the improper as an unordered 4-tuple
    formaldehyde = Molecule(
        atoms=[0, 1, 2, 3],
        bonds=[(0, 1), (0, 2), (0, 3)],
        impropers=[(1, 2, 0, 3)],
        atomic_numbers=[6, 8, 1, 1],
        partial_charges=[0.45, -0.45, 0.0, 0.0],
    )
    # three cyclic versions are stored, central atom at index 2 (the
    # reference's improper convention; energy is invariant over the
    # remaining permutations)
    print("canonical impropers:", formaldehyde.impropers.tolist())

    # round-trips
    same = Molecule.from_dict(methane.to_dict())
    assert np.array_equal(same.bonds, methane.bonds)
    print("npz/json round-trip OK")
    return methane, formaldehyde


if __name__ == '__main__':
    main()
