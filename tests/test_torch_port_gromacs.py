"""The port's GROMACS path (grappa_tpu_torch.wrappers.gromacs_topology /
gromacs_wrapper, plotting and `cli gmx`) against the JAX package's, on the
CPU (device='cpu').

One module-scoped pair of force fields on the same weights (the small
config, the flax init moved by seeded numpy noise, crossing over as the
JAX package exports it, as tests/test_torch_port_api.py does) parametrizes
tests/test_gromacs.py's topologies. The JAX package's files are written
once per module. The written `.top` files are compared line for line:
comments, section headers, atom ids, functs and periodicities exactly;
each parameter at the predict tolerance (rtol 1e-4 / atol 1e-5 in grappa
units), times its unit factor, plus half a unit of its printed precision.
Torsion rows whose k the hard cutoff (|k| > 1e-4) zeroes on one side only
are left out: there a last-ulp difference flips k and its phase.
"""
import re

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu import cli as jcli
from grappa_tpu import plotting as jplot
from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.parameters import Parameters as JaxParameters
from grappa_tpu.data.synthetic import random_molecule, random_parameters
from grappa_tpu.models.grappa_model import get_small_model_config, make_model
from grappa_tpu.train.export import build_model_dict, save_model_dict
from grappa_tpu.wrappers import gromacs_topology as jtop
from grappa_tpu.wrappers import gromacs_wrapper as jgw
from grappa_tpu_torch import cli, plotting
from grappa_tpu_torch.data.parameters import Parameters
from grappa_tpu_torch.wrappers import gromacs_topology as ttop
from grappa_tpu_torch.wrappers import gromacs_wrapper as tgw
from test_gromacs import (ATOMTYPES_TOP, MESSY_TOP, MIXED_DIHEDRALS_TOP,
                          TOP_TEXT)

RTOL, ATOL, CUTOFF = 1e-4, 1e-5, 1e-4
SECTION = re.compile(r'^\s*\[\s*(\S+)\s*\]')
# (unit factor, printed decimals) of each numeric column a written row has
COLUMNS = {
    'bonds': {3: (tgw.BOND_EQ_FACTOR, 6), 4: (tgw.BOND_K_FACTOR, 4)},
    'angles': {4: (tgw.ANGLE_EQ_FACTOR, 4), 5: (tgw.ANGLE_K_FACTOR, 4)},
    'dihedrals': {5: (tgw.TORSION_PHASE_FACTOR, 4),
                  6: (tgw.TORSION_K_FACTOR, 6)},
}
ITP = ("[ moleculetype ]\nETH 3\n[ atoms ]\n"
       " 1 CT 1 ETH C1 1 -0.1 12.011\n 2 CT 1 ETH C2 2 -0.1 12.011\n"
       " 3 HC 1 ETH H1 3 0.05 1.008\n 4 HC 1 ETH H2 4 0.05 1.008\n"
       "[ bonds ]\n 1 2 1 0.15 2000\n 1 3 1 0.11 2000\n 2 4 1 0.11 2000\n")
INCLUDE_TOP = ('#include "amber99.ff/forcefield.itp"\n#include "mol.itp"\n\n'
               '[ system ]\ne\n[ molecules ]\nETH 1\n')
# name: (topology text, focus_nrs, resolve_includes)
CASES = {
    'butane': (TOP_TEXT, None, False),
    'butane_focus': (TOP_TEXT, {1}, False),
    'chain_focus_mixed_functs': (MIXED_DIHEDRALS_TOP, {1}, False),
    'chain_two_components': (MIXED_DIHEDRALS_TOP, {1, 30}, False),
    'massless_atomtypes': (ATOMTYPES_TOP, None, False),
    'include': (INCLUDE_TOP, None, True),
}
# the command with every flag that changes what it writes, once (the JAX
# package's command compiles its model anew on each call)
CLI_CASES = {'cli_focus_plot': ['--focus', '1']}


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """(JAX GromacsGrappa, the port's on the CPU, the model file) with the
    same weights."""
    cfg = get_small_model_config()
    model = make_model(cfg)
    batch = jax_collate([JaxMolGraph.from_molecule(random_molecule(seed=0))])
    params = jax.jit(model.init)(jax.random.key(0), batch)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: jax.numpy.asarray(a + rng.normal(0, 0.05, a.shape),
                                    np.float32), jax.device_get(params))
    model_dict = build_model_dict(params, {'model_config': cfg}, model=model)
    path = tmp_path_factory.mktemp('model') / 'model.npz'
    save_model_dict(model_dict, path)
    return (jgw.GromacsGrappa(model, params, {'model_config': cfg}),
            tgw.GromacsGrappa.from_model_dict(model_dict, device='cpu'),
            path)


def _inputs(root, text):
    root.mkdir(parents=True, exist_ok=True)
    (root / 'mol.itp').write_text(ITP)
    top = root / 'in.top'
    top.write_text(text)
    return top


def _parametrize(ff, root, case):
    text, focus, includes = CASES[case]
    out = root / 'out.top'
    ff.parametrize(_inputs(root, text), out, focus_nrs=focus,
                   check_eq_values=False, resolve_includes=includes)
    return out.read_text(), ff.last_predictions


def _cli(main, root, case, model_path, *flags):
    top = _inputs(root, TOP_TEXT)
    out, plot = root / 'out.top', root / 'plot.png'
    flags = [*CLI_CASES[case], *flags] + (
        ['-p', str(plot)] if 'plot' in case else [])
    assert main(['gmx', '-f', str(top), '-o', str(out), '-t',
                 str(model_path)] + flags) == 0
    assert 'plot' not in case or plot.exists()
    return out.read_text(), None


@pytest.fixture(scope='module')
def jax_outputs(pair, tmp_path_factory):
    """Every case's file (and last_predictions) from the JAX package, once."""
    jax_ff, _, model_path = pair
    root = tmp_path_factory.mktemp('jax')
    out = {case: _parametrize(jax_ff, root / case, case) for case in CASES}
    out.update({case: _cli(jcli.main, root / case, case, model_path)
                for case in CLI_CASES})
    return out


def _written_rows_agree(got, want):
    """Line for line; returns the torsion rows left out by the cutoff."""
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want)
    section, flips = None, 0
    for g, w in zip(got, want):
        m = SECTION.match(w)
        if m:
            section = m.group(1).lower()
        if g == w:
            continue
        gt, wt = g.split(), w.split()
        cols = COLUMNS.get(section)
        assert cols and len(gt) == len(wt), (g, w)
        k_col = 6 if section == 'dihedrals' else None
        if k_col is not None:
            kg, kw = (abs(float(t[k_col])) / tgw.TORSION_K_FACTOR
                      for t in (gt, wt))
            if (kg > CUTOFF) != (kw > CUTOFF):
                flips += 1
                assert gt[:5] + gt[7:] == wt[:5] + wt[7:], (g, w)
                continue
        for i, (a, b) in enumerate(zip(gt, wt)):
            if i not in cols:
                assert a == b, (g, w)
                continue
            factor, decimals = cols[i]
            tol = ATOL * factor + RTOL * abs(float(b)) + 0.5 * 10 ** -decimals
            assert abs(float(a) - float(b)) <= tol, (g, w, tol)
    return flips


def _params_agree(g, w):
    for name in ('atoms', 'bonds', 'angles', 'propers', 'impropers'):
        np.testing.assert_array_equal(getattr(g, name), getattr(w, name),
                                      err_msg=name)
    for name in ('bond_k', 'bond_eq', 'angle_k', 'angle_eq'):
        np.testing.assert_allclose(getattr(g, name), getattr(w, name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for ks, phases in (('proper_ks', 'proper_phases'),
                       ('improper_ks', 'improper_phases')):
        a, b = getattr(g, ks), getattr(w, ks)
        keep = (a > CUTOFF) == (b > CUTOFF)
        assert keep.size == 0 or keep.mean() > 0.99, ks
        np.testing.assert_allclose(a[keep], b[keep], rtol=RTOL, atol=ATOL,
                                   err_msg=ks)
        np.testing.assert_array_equal(getattr(g, phases)[keep & (a > CUTOFF)],
                                      getattr(w, phases)[keep & (b > CUTOFF)])


@pytest.mark.parametrize('case', [*CASES, *CLI_CASES])
def test_written_topology_matches_jax(pair, jax_outputs, tmp_path, case):
    _, ff, model_path = pair
    if case in CLI_CASES:
        got, preds = _cli(cli.main, tmp_path, case, model_path,
                          '--device', 'cpu')
    else:
        got, preds = _parametrize(ff, tmp_path, case)
    want, want_preds = jax_outputs[case]
    flips = _written_rows_agree(got, want)
    assert flips <= 2, flips
    if preds is None:
        return
    # the predictions each run wrote, per moleculetype and component
    assert preds.keys() == want_preds.keys()
    for name in preds:
        assert len(preds[name]) == len(want_preds[name])
        for (g, g_apply), (w, w_apply) in zip(preds[name], want_preds[name]):
            assert g_apply == w_apply
            _params_agree(g, w)
    if case == 'chain_two_components':
        assert len(preds['CHAIN']) == 2


def test_cli_gmx_runs_on_the_card_by_default(pair, tmp_path, monkeypatch):
    """Without --device the command asks for CUDA and refuses to fall back
    to the CPU by itself."""
    _, _, model_path = pair
    top = _inputs(tmp_path, TOP_TEXT)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(['gmx', '-f', str(top), '-o', str(tmp_path / 'o.top'),
                  '-t', str(model_path)])
    assert not (tmp_path / 'o.top').exists()


def _as_port(p):
    return Parameters(**{k: getattr(p, k) for k in (
        'atoms', 'bonds', 'bond_k', 'bond_eq', 'angles', 'angle_k',
        'angle_eq', 'propers', 'proper_ks', 'proper_phases', 'impropers',
        'improper_ks', 'improper_phases')})


def _unit_params(P):
    """tests/test_gromacs.py's hand-made parameters in grappa units."""
    return P(atoms=np.array([1, 2, 3, 4]),
             bonds=np.array([[1, 2]]), bond_k=np.array([700.0]),
             bond_eq=np.array([1.5]),
             angles=np.array([[1, 2, 3]]), angle_k=np.array([100.0]),
             angle_eq=np.array([np.pi / 2]),
             propers=np.array([[1, 2, 3, 4]]),
             proper_ks=np.array([[2.0, 0.0]]),
             proper_phases=np.array([[np.pi, 0.0]]),
             impropers=np.array([[1, 3, 2, 4]]),
             improper_ks=np.array([[1.0]]),
             improper_phases=np.array([[0.0]]))


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ('ValueError', str(e))


def _molecule(mol):
    return {k: np.asarray(getattr(mol, k)) for k in (
        'atoms', 'bonds', 'angles', 'propers', 'impropers',
        'atomic_numbers', 'partial_charges')}


CHAIN = [(1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (7, 8), (8, 9)]
MASSES = (12.011, 1.008, 15.999, 14.007, 32.06, 35.45, 3.024, 0.0)
# name: f(topology module, wrapper module, Parameters class) -> a value
HELPERS = {
    'element_from_mass': lambda t, w, P: [
        _outcome(lambda m=m: w.element_from_mass(m)) for m in MASSES],
    'fov_neighborhood': lambda t, w, P: [
        w.fov_neighborhood(CHAIN, focus, hops)
        for focus in ({1}, {3}, {1, 9}, {42}) for hops in (0, 1, 2, 99)],
    'connected_components': lambda t, w, P: [
        w._connected_components(CHAIN, nodes)
        for nodes in ({1, 2, 3, 8, 9}, {1, 5, 7}, set(range(1, 10)))],
    'filter_parameters': lambda t, w, P: [
        vars(w.filter_parameters(p, keep))
        for p in (_params_in(P, 5, 1), _params_in(P, 9, 2))
        for keep in (set(range(6)), set(range(3, 12)), set())],
    'gromacs_parameter_rows': lambda t, w, P: [
        w.gromacs_parameter_rows(p, apply)
        for p in (_unit_params(P), _params_in(P, 5, 1))
        for apply in (None, {1, 2, 3}, set(range(8)))],
    'parse_and_write': lambda t, w, P: [
        (top.write(), [m.name for m in top.molecule_types()],
         [(m.atoms(), m.bonds(), m.proper_tuples(), m.improper_tuples())
          for m in top.molecule_types()])
        for top in (t.GromacsTopology.parse(text) for text in (
            TOP_TEXT, MESSY_TOP, MIXED_DIHEDRALS_TOP, ATOMTYPES_TOP))],
    'atomtype_info': lambda t, w, P: [
        t.GromacsTopology.parse(text).atomtype_info() for text in (
            MESSY_TOP, ATOMTYPES_TOP,
            '[ atomtypes ]\n; name mass charge ptype sigma epsilon\n'
            '  OW    15.9994  0.000   A      0.31507  0.63639\n'
            '  MW    0        0.000   D      0.0      0.0\n'
            '  XX    bad      0.000   A\n')],
    'molecule_from_moleculetype': lambda t, w, P: [
        _outcome(lambda text=text, info=info, keep=keep: _molecule(
            w.molecule_from_moleculetype(
                t.GromacsTopology.parse(text).molecule_types()[0],
                atom_filter=keep,
                type_info=(t.GromacsTopology.parse(text).atomtype_info()
                           if info else None))))
        for text, info, keep in ((TOP_TEXT, False, None),
                                 (TOP_TEXT, False, {1, 2, 3, 5}),
                                 (ATOMTYPES_TOP, True, None),
                                 (ATOMTYPES_TOP, False, None),
                                 (MIXED_DIHEDRALS_TOP, False, None))],
    'ensure_dihedral_sections': lambda t, w, P: [
        (top.ensure_dihedral_sections(top.molecule_types()[0])[0].rows,
         top.write())
        for top in (t.GromacsTopology.parse(text) for text in (
            TOP_TEXT, MESSY_TOP, MIXED_DIHEDRALS_TOP))],
}


def _params_in(P, n_atoms, seed):
    """Random parameters of a seeded molecule, in the package's class."""
    p = random_parameters(random_molecule(seed=seed, n_atoms=n_atoms),
                          seed=seed)
    return p if P is JaxParameters else _as_port(p)


@pytest.mark.parametrize('helper', list(HELPERS))
def test_topology_helpers_match_jax(helper):
    """The parser and the pure helpers on the same inputs, the JAX
    package's result against the port's (exactly: the same arithmetic)."""
    want = HELPERS[helper](jtop, jgw, JaxParameters)
    got = HELPERS[helper](ttop, tgw, Parameters)
    np.testing.assert_equal(got, want)


def test_plot_parameters_matches_jax(tmp_path):
    mols = [random_molecule(seed=s, n_atoms=10 + s) for s in range(3)]
    jax_params = [random_parameters(m, seed=s) for s, m in enumerate(mols)]
    params = [_as_port(p) for p in jax_params]
    for key, _ in plotting._PARAM_PANELS:
        np.testing.assert_array_equal(
            np.concatenate([plotting._values(p, key) for p in params]),
            np.concatenate([jplot._values(p, key) for p in jax_params]))
    np.testing.assert_equal(plotting._detailed_panels(params),
                            jplot._detailed_panels(jax_params))
    for mod, ps in ((plotting, params), (jplot, jax_params)):
        out = tmp_path / f'{mod.__name__}.png'
        assert mod.plot_parameters(ps, filename=str(out), title='x') is None
        assert out.stat().st_size > 0
