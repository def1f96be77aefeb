"""The port's host data layer (grappa_tpu_torch.data, topology, features)
against the JAX package's, and the port's import boundary.

Molecules are made with grappa_tpu.data.synthetic.random_molecule and handed
to the port through Molecule.to_dict() -> the port's Molecule.from_dict, or
rebuilt by the port from the same seed. Arrays must be equal, not close:
this layer is integer bookkeeping and float32 copies.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.graph_batch import TERMS
from grappa_tpu.data.loader import bucketed_pad_spec as jax_pad_spec
from grappa_tpu.data.synthetic import random_molecule as jax_random_molecule
from grappa_tpu_torch.data import MolGraph, Molecule, collate
from grappa_tpu_torch.data.loader import bucketed_pad_spec
from grappa_tpu_torch.data.synthetic import random_molecule

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _mols(seeds, **kw):
    return [jax_random_molecule(seed=s, **kw) for s in seeds]


def _equal_dicts(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize('seed', [0, 3, 11])
def test_molecule_roundtrip_and_rebuild(seed):
    """from_dict keeps every array; building from the same seed runs the
    port's own topology (angles, propers, impropers) and features (ring,
    degree, mass, charge model) and must give the JAX package's arrays."""
    jm = jax_random_molecule(seed=seed, n_atoms=30)
    _equal_dicts(Molecule.from_dict(jm.to_dict()).to_dict(), jm.to_dict())
    _equal_dicts(random_molecule(seed=seed, n_atoms=30).to_dict(),
                 jm.to_dict())


@pytest.mark.parametrize('n_mols', [1, 5, 32])
def test_bucketed_pad_spec_matches(n_mols):
    jms = _mols(range(n_mols))
    port = bucketed_pad_spec(
        [MolGraph.from_molecule(Molecule.from_dict(m.to_dict()))
         for m in jms], n_confs=1)
    ref = jax_pad_spec([JaxMolGraph.from_molecule(m) for m in jms], n_confs=1)
    assert (port.n_nodes, port.n_tuples, port.n_confs) == (
        ref.n_nodes, ref.n_tuples, ref.n_confs)


def test_collate_matches_jax():
    jms = _mols(range(5), atom_range=(8, 30))
    jgraphs = [JaxMolGraph.from_molecule(m) for m in jms]
    graphs = [MolGraph.from_molecule(Molecule.from_dict(m.to_dict()))
              for m in jms]
    jpad = jax_pad_spec(jgraphs, n_confs=1)
    ref = jax_collate(jgraphs, pad=jpad, n_confs=1)
    got = collate(graphs, pad=bucketed_pad_spec(graphs, n_confs=1),
                  n_confs=1, device='cpu')
    assert got.num_mols == ref.num_mols
    for name in ('node_mask', 'node_mol', 'neighbors', 'neighbor_mask', 'xyz',
                 'conf_mask', 'energy_ref', 'gradient_ref'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    _equal_dicts({k: v.numpy() for k, v in got.feats.items()}, ref.feats)
    for t in TERMS:
        for name in ('idxs', 'mask', 'mol', 'k_ref', 'eq_ref'):
            a, b = getattr(got.terms[t], name), getattr(ref.terms[t], name)
            assert (a is None) == (b is None), (t, name)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f'{t}.{name}')


def test_collate_puts_the_batch_on_the_card_by_default(monkeypatch):
    graphs = [MolGraph.from_molecule(random_molecule(seed=1))]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collate(graphs)
    assert collate(graphs, device='cpu').xyz.device.type == 'cpu'


def test_import_without_jax():
    """grappa_tpu_torch and every module in it import with jax, flax and
    grappa_tpu blocked, and with yaml blocked: the training run writes and
    reads its config without pyyaml. The MD engines (openmm, openff,
    rdkit, kimmdy) and matplotlib are blocked too: the wrappers and the
    lazy top-level names resolve without them, and an engine's entry point
    raises a clear ImportError. grappa_tpu_torch.parallel holds every
    public function of the JAX package's parallel.dp and parallel.sp under
    its name. The port's copies of the MD-engine doubles import too."""
    modules = sorted(
        '.'.join(p.relative_to(ROOT).with_suffix('').parts)
        .replace('.__init__', '')
        for p in (ROOT / 'grappa_tpu_torch').rglob('*.py'))
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'grappa_tpu', 'yaml',\n"
            "          'openmm', 'openff', 'rdkit', 'kimmdy',\n"
            "          'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "sys.path.insert(0, 'tests')\n"
            "for m in ('torch_openmm_double', 'torch_openff_double',\n"
            "          'torch_kimmdy_double'):\n"
            "    importlib.import_module(m)\n"
            "import grappa_tpu_torch as g\n"
            "from grappa_tpu_torch.wrappers import GromacsGrappa\n"
            "assert g.GromacsGrappa is GromacsGrappa\n"
            "assert g.MolData.__name__ == 'MolData'\n"
            "assert g.Dataset.__name__ == 'Dataset'\n"
            "try:\n"
            "    g.OpenmmGrappa.parametrize_system(None, None, None)\n"
            "    raise AssertionError('no ImportError')\n"
            "except ImportError as e:\n"
            "    assert 'openmm is not installed' in str(e), e\n"
            "from grappa_tpu_torch import parallel\n"
            "for n in ('make_mesh', 'shard_batches', 'make_dp_train_step',\n"
            "          'make_dp_scan_epoch_step', 'make_dp_eval_step',\n"
            "          'make_conf_sharded_energy_fn', 'replicate',\n"
            "          'stack_loss_weights', 'atom_sharded_pad_spec',\n"
            "          'shard_batch_by_atoms', 'make_atom_sharded_forward',\n"
            "          'make_atom_sharded_train_step'):\n"
            "    assert callable(getattr(parallel, n)), n\n"
            "for m in ('grappa_tpu', 'openmm', 'openff', 'rdkit', 'kimmdy',\n"
            "          'matplotlib'):\n"
            "    assert sys.modules.get(m) is None, m\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split('.')[0])
    return roots


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = sorted((ROOT / 'grappa_tpu_torch').rglob('*.py'))
    files += [ROOT / 'chip_smoke.py', ROOT / 'sass_compare.py']
    # the port's copies of the MD-engine doubles, which chip_smoke.py
    # installs on the card's machine
    files += [ROOT / 'tests' / f'torch_{engine}_double.py'
              for engine in ('openmm', 'openff', 'kimmdy')]
    assert len(files) > 20
    # the training run's, the evaluation's, the command line's, the data
    # tools' and sweep's modules, the drivers and the examples are among
    # them
    port = ROOT / 'grappa_tpu_torch'
    for name in ('native.py', 'zoo.py', 'data/dataset.py', 'data/loader.py',
                 'train/config.py', 'train/logging.py', 'train/trainer.py',
                 'train/export.py', 'train/eval_model.py', 'train/run.py',
                 'cli.py', 'published.py', 'train/report.py',
                 'train/torch_compat.py', 'espaloma_split.py',
                 'data/dataset_creation.py', 'data/espaloma_pipeline.py',
                 'train/sweep.py', 'experiments/benchmark.py',
                 'experiments/rehearsal.py', 'experiments/smoke.py',
                 'experiments/convergence.py',
                 'examples/usage/openmm_wrapper.py',
                 'examples/training/train_small.py'):
        assert port / name in files, name
    for path in files:
        assert path.exists(), path
    banned = {'jax', 'jaxlib', 'flax', 'optax', 'grappa_tpu'}
    for path in files:
        assert not _imported_roots(path) & banned, path
