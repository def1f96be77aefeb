"""Parametrizing an OpenMM system (reference: examples/usage/
openmm_wrapper.py). Requires openmm, its force-field files and a model
(tag or file); without openmm it stops with openmm's ImportError.

Workflow: build your solvated system with a classical force field as usual;
grappa then overwrites the BONDED parameters of the non-water / non-ion
part (bonds, angles, torsions) and leaves nonbonded parameters (charges,
LJ, solvent) untouched.

    python -m grappa_tpu_torch.examples.usage.openmm_wrapper \
        [--pdb protein.pdb] [--tag grappa-1.2] [--device cpu]
"""
import argparse

from grappa_tpu_torch.wrappers.openmm_wrapper import OpenmmGrappa


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m grappa_tpu_torch.examples.usage.openmm_wrapper')
    ap.add_argument('--pdb', default='protein.pdb')
    ap.add_argument('--tag', default='grappa-1.2',
                    help='model tag or file')
    ap.add_argument('--device', default=None,
                    help='where the model runs (default: CUDA)')
    args = ap.parse_args(argv)

    from openmm import unit
    from openmm.app import ForceField, Modeller, PDBFile

    pdb = PDBFile(args.pdb)
    classical_ff = ForceField('amber99sbildn.xml', 'tip3p.xml')

    modeller = Modeller(pdb.topology, pdb.positions)
    modeller.deleteWater()
    modeller.addHydrogens(classical_ff)
    modeller.addSolvent(classical_ff, model='tip3p',
                        padding=1.0 * unit.nanometers)
    topology = modeller.getTopology()
    system = classical_ff.createSystem(topology)

    # charge_model tells grappa how the charges were derived ('amber99' for
    # classical protein FFs, 'am1BCC' for small-molecule charges)
    ff = OpenmmGrappa.from_tag(args.tag, device=args.device)
    system = ff.parametrize_system(system, topology, charge_model='amber99',
                                   plot_dir='.')   # writes parameter plots

    # `system` is a normal openmm System: simulate, minimize, export as
    # usual. For HYP/DOP-containing PDBs, repair the topology first:
    #   from grappa_tpu_torch.wrappers.hyp_dop import (
    #       add_nonstandard_residue_bonds)
    #   add_nonstandard_residue_bonds(topology)
    return system


if __name__ == '__main__':
    main()
