"""Runnable examples of the port, one module a script, in the layout of the
JAX package's examples/ tree:

    python -m grappa_tpu_torch.examples.usage.molecule_creation
    python -m grappa_tpu_torch.examples.usage.dataset [--device cpu]
    python -m grappa_tpu_torch.examples.usage.inspect_models [--device cpu]
    python -m grappa_tpu_torch.examples.usage.molecular_dynamics [--device cpu]
    python -m grappa_tpu_torch.examples.usage.openmm_wrapper   (needs openmm)
    grappa_tpu_torch/examples/usage/gromacs_wrapper.sh
    python -m grappa_tpu_torch.examples.wrapper_construction.interface
    python -m grappa_tpu_torch.examples.training.train_small [--device cpu]
    python -m grappa_tpu_torch.examples.reproduction.reproduce [--device cpu]
    python -m grappa_tpu_torch.examples.evaluation.evaluate [--device cpu]

Each runs on CUDA unless --device names another, and does its work in
`main(argv)`: importing a module runs nothing. Models and datasets resolve
by tag through the offline-first cache (GRAPPA_TPU_CACHE or
~/.cache/grappa_tpu); a tag that is not there is downloaded, and the
examples that try a released tag fall back to synthetic data or a random
model when that fails.
"""
