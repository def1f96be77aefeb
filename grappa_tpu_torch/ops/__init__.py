from grappa_tpu_torch.ops.torsion_kernel import torsion_energy_fused

__all__ = ["torsion_energy_fused"]
