#!/usr/bin/env bash
# Reparametrizing a GROMACS topology with the port (reference:
# examples/usage/gromacs_wrapper.sh). The .top parser / writer is
# self-contained: no kimmdy / gromacs python tooling needed. The model runs
# on CUDA; add --device cpu to run it on the CPU.

# full reparametrization of the bonded terms (solvent/ions untouched):
python -m grappa_tpu_torch.cli gmx -f topol.top -o topol_grappa.top \
    -t grappa-1.2

# partial reparametrization around given atom numbers (the radical
# workflow: only tuples within the model's field of view change):
python -m grappa_tpu_torch.cli gmx -f topol.top -o topol_partial.top \
    -t grappa-1.2 --focus 1 2 3

# with a parameter violin plot of what was written:
python -m grappa_tpu_torch.cli gmx -f topol.top -o topol_grappa.top \
    -t grappa-1.2 -p parameters.png

# then run GROMACS as usual: gmx grompp -f minim.mdp -c conf.gro \
#     -p topol_grappa.top -o em.tpr && gmx mdrun -deffnm em
