"""MD-engine wrappers of the port (counterpart of `grappa_tpu.wrappers`)."""
from grappa_tpu_torch.wrappers.gromacs_topology import GromacsTopology
from grappa_tpu_torch.wrappers.gromacs_wrapper import GromacsGrappa

__all__ = ["GromacsTopology", "GromacsGrappa"]
# OpenmmGrappa is intentionally not imported eagerly: openmm is optional.
