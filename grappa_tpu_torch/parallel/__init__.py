"""Multi-device training and atom-sharded MD on torch.distributed (the
JAX package's grappa_tpu.parallel): `dp` data parallelism and the
conformer-sharded energy, `sp` the atom-sharded forward, train step and
MD batch."""
from grappa_tpu_torch.parallel.dp import (
    Mesh, make_conf_sharded_energy_fn, make_dp_eval_step,
    make_dp_scan_epoch_step, make_dp_train_step, make_mesh, replicate,
    shard_batches, stack_loss_weights)
from grappa_tpu_torch.parallel.sp import (
    AtomShard, atom_sharded_pad_spec, make_atom_sharded_forward,
    make_atom_sharded_train_step, shard_batch_by_atoms)

__all__ = [
    "Mesh", "make_mesh", "make_dp_train_step", "make_dp_scan_epoch_step",
    "make_dp_eval_step", "shard_batches", "make_conf_sharded_energy_fn",
    "replicate", "stack_loss_weights", "AtomShard", "atom_sharded_pad_spec",
    "make_atom_sharded_forward", "make_atom_sharded_train_step",
    "shard_batch_by_atoms",
]
