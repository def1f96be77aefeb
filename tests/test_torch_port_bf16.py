"""The port's bfloat16 mode (compute_dtype / gnn_compute_dtype /
heads_compute_dtype; the ops' mm_dtype) against the JAX package's on the
CPU.

The JAX package has two bf16 semantics, and the port matches each on its
own path:
  * the fused ops (K1-K3, `mm_dtype=jnp.bfloat16`): both operands of every
    dense product rounded to bf16, the products summed in float32, outputs
    float32. The JAX Pallas kernels run in interpret mode; the port's
    wrappers run their plain versions on the CPU.
  * the flax modules (`nn.Dense(dtype=bfloat16)`): every Dense output
    rounded to bf16, the bias added and the elu taken in bf16, cast back to
    float32 where flax casts. The flax model is applied eagerly: under
    `jax.jit` XLA on the CPU keeps the excess precision of fused bf16
    elementwise chains, which is neither semantics.

The parity rule (RULE): for every output, mean |port - JAX_bf16| <= 0.1 x
mean |JAX_bf16 - JAX_f32| (the bf16 effect), and the port's bf16 differs
from its float32. It is checked for the three ops, for each stage of the
model alone (the GNN on the batch; the four writers on the JAX bf16
model's own embedding) and for the whole model. Measured ratios: the ops
2e-5 to 4e-3; the fused model 3e-5 to 6e-3 (stages and end to end); the
eager model's GNN 0.013, its writers alone up to 0.0095, end to end up to
0.072 (n4_improper_k).

The whole model sits closest to the rule, and by the nature of bf16, not
of the port: a float32 difference of a few ulps (the two packages sum in
other orders) flips a bf16 rounding now and then, the flipped operand
moves its product by a whole bf16 ulp, and every later rounding spreads
it. With the same model jittered instead by numpy noise (scale 0.05,
tests/test_torch_port_model.py's `_perturb`), the eager model measured up
to 0.23 and the fused up to 0.10 end to end, while each stage alone
stayed <= 0.02; the JAX bf16 model against itself with every weight moved
by one float32 ulp differs by 0.01-0.09. So a change that only reorders
float32 sums can move the end-to-end ratios; the stage checks are the
ones that single out a wrong bf16 semantics.

Max errors are bounded too, by what was measured with margin: an op's
max |port - JAX_bf16| <= 0.25 x its max bf16 effect (measured up to 0.15,
K1), a model output's <= 1.0 x (measured up to 0.66, the eager model's
n3_eq). Torsion ks that the hard cutoff sends to zero on one side only
are left out, as in tests/test_torch_port_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.loader import bucketed_pad_spec as jax_pad_spec
from grappa_tpu.data.synthetic import random_molecule
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.models.heads import PERMUTATIONS, WRONG_SYMMETRY_IMPROPER
from grappa_tpu.ops import fused_block as fb
from grappa_tpu.ops import fused_gnn as fg
from grappa_tpu.ops import fused_symmetriser as fs
from grappa_tpu.train.torch_compat import stats_from_model
from grappa_tpu_torch.api import Grappa
from grappa_tpu_torch.data import MolGraph, Molecule, collate
from grappa_tpu_torch.data.dataset import Dataset
from grappa_tpu_torch.data.loader import bucketed_pad_spec
from grappa_tpu_torch.data.synthetic import make_dataset
from grappa_tpu_torch.models import grappa_model as tgm
from grappa_tpu_torch.ops import _cuda
from grappa_tpu_torch.ops import fused_block as tfb
from grappa_tpu_torch.ops import fused_gnn as tfg
from grappa_tpu_torch.ops import fused_symmetriser as tfs
from grappa_tpu_torch.train import trainer as ttr
from grappa_tpu_torch.train.eval_model import eval_model
from grappa_tpu_torch.train.loss import LossWeights
from grappa_tpu_torch.weights import state_dict_from_flax

RULE = 0.1
OP_MAX = 0.25
MODEL_MAX = 1.0
CUTOFF = 1e-4
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret():
    fb.INTERPRET = fs.INTERPRET = fg.INTERPRET = True
    yield
    fb.INTERPRET = fs.INTERPRET = fg.INTERPRET = False


def _ratio(port, j16, j32, keep=None):
    """(mean |port - j16| / mean |j16 - j32|, the same of the maxima)."""
    port, j16, j32 = (np.asarray(a, np.float64) for a in (port, j16, j32))
    if keep is not None:
        port, j16, j32 = port[keep], j16[keep], j32[keep]
    err, eff = np.abs(port - j16), np.abs(j16 - j32)
    return err.mean() / eff.mean(), err.max() / eff.max()


# ------------------------------------------------------------ the ops
def _dense(rng, n_in, n_out):
    return {'kernel': rng.normal(0, 1 / np.sqrt(n_in), (n_in, n_out))
            .astype(np.float32),
            'bias': rng.normal(0, 0.1, n_out).astype(np.float32)}


def _norm(rng, n):
    return {'scale': (1 + rng.normal(0, 0.1, n)).astype(np.float32),
            'bias': rng.normal(0, 0.1, n).astype(np.float32)}


def _lin(p):
    return (torch.tensor(p['kernel'].T.copy()), torch.tensor(p['bias']))


def _ln(p):
    return torch.tensor(p['scale']), torch.tensor(p['bias'])


def _op_check(port16, port32, j16, j32):
    mean_ratio, max_ratio = _ratio(port16, j16, j32)
    assert mean_ratio <= RULE, mean_ratio
    assert max_ratio <= OP_MAX, max_ratio
    assert not torch.equal(port16, port32)


def test_gnn_block_bf16_matches_pallas():
    """K1: the three products in bf16, scores and message sum float32."""
    n, f, heads, d = 50, 64, 4, 6
    rng = np.random.default_rng(n)
    feat = rng.normal(0, 1, (n, f)).astype(np.float32)
    neighbors = rng.integers(0, n, (n, d))
    mask = (rng.random((d, n)) > 0.3).astype(np.float32)
    mask[:, -3:] = 0.0
    nbr = feat[neighbors.T]
    hn = rng.normal(0, 1, (n, f)).astype(np.float32)
    p = {'head_reducer': _dense(rng, f, f),
         'interaction_norm': _norm(rng, f),
         'si_dense1': _dense(rng, f, 4 * f),
         'si_dense2': _dense(rng, 4 * f, f)}
    tp = (*_lin(p['head_reducer']), *_ln(p['interaction_norm']),
          *_lin(p['si_dense1']), *_lin(p['si_dense2']))
    args = (feat, nbr, hn, mask, p, jnp.uint32(0), heads, 0.0, True)
    j16 = fg.fused_gnn_block(*args, jnp.bfloat16, 32)
    j32 = fg.fused_gnn_block(*args, None, 32)
    targs = [torch.tensor(a) for a in (feat, nbr, hn, mask)]
    _op_check(tfg.fused_gnn_block(*targs, tp, heads, mm_dtype=BF16),
              tfg.fused_gnn_block(*targs, tp, heads), j16, j32)


@pytest.mark.parametrize('s', [2, 3, 4])
def test_transformer_block_bf16_matches_pallas(s):
    """K2 at every arity: QKV, out_proj and the FF products in bf16."""
    t, f, heads, hid = 40, 64, 4, 64
    rng = np.random.default_rng(s)
    x = rng.normal(0, 1, (s, t, f)).astype(np.float32)
    p = {'norm1': _norm(rng, f),
         'attn': {'in_proj': _dense(rng, f, 3 * f),
                  'out_proj': _dense(rng, f, f)},
         'ff': {'norm': _norm(rng, f), 'linear1': _dense(rng, f, hid),
                'linear2': _dense(rng, hid, f)}}
    tp = (*_ln(p['norm1']), *_lin(p['attn']['in_proj']),
          *_lin(p['attn']['out_proj']), *_ln(p['ff']['norm']),
          *_lin(p['ff']['linear1']), *_lin(p['ff']['linear2']))
    args = (x, p, jnp.uint32(0), heads, 0.0, True)
    j16 = fb.fused_transformer_block(*args, jnp.bfloat16)
    j32 = fb.fused_transformer_block(*args, None)
    _op_check(tfb.fused_transformer_block(torch.tensor(x), tp, heads,
                                          mm_dtype=BF16),
              tfb.fused_transformer_block(torch.tensor(x), tp, heads),
              j16, j32)


@pytest.mark.parametrize('perms', [PERMUTATIONS['n4'],
                                   WRONG_SYMMETRY_IMPROPER],
                         ids=['2_perms', '6_perms'])
def test_symmetriser_bf16_matches_pallas(perms):
    """K3: every layer's two products in bf16 (3 layers, skips in the
    middle one)."""
    t, f, width, out, n_layers = 30, 32, 48, 6, 3
    s = len(perms[0])
    rng = np.random.default_rng(len(perms))
    x = rng.normal(0, 1, (s, t, f)).astype(np.float32)
    p = {}
    for i in range(n_layers):
        n_in = s * f if i == 0 else width
        n_out = out if i == n_layers - 1 else width
        p[f'mlp_{i}'] = {'norm': _norm(rng, n_in),
                         'linear1': _dense(rng, n_in, width),
                         'linear2': _dense(rng, width, n_out)}
    layers = [(*_ln(p[f'mlp_{i}']['norm']), *_lin(p[f'mlp_{i}']['linear1']),
               *_lin(p[f'mlp_{i}']['linear2'])) for i in range(n_layers)]
    j16 = fs.fused_symmetriser(x, p, perms, n_layers, jnp.bfloat16)
    j32 = fs.fused_symmetriser(x, p, perms, n_layers, None)
    _op_check(tfs.fused_symmetriser(torch.tensor(x), layers, perms,
                                    mm_dtype=BF16),
              tfs.fused_symmetriser(torch.tensor(x), layers, perms),
              j16, j32)


def test_ops_refuse_other_mm_dtypes():
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match='mm_dtype'):
        tfs.fused_symmetriser(x, [(torch.ones(16), torch.zeros(16),
                                   torch.zeros(4, 16), torch.zeros(4),
                                   torch.zeros(2, 4), torch.zeros(2))],
                              ((0, 1),), mm_dtype=torch.float16)


# ------------------------------------------------------------ the model
def _outputs_close(got, want, want32, batch, mean_rule, max_rule):
    """Each output key of the port against the JAX model's, both bf16,
    over the real tuples; cutoff flips left out."""
    ratios = {}
    for key, ref in want.items():
        term = ('n4_improper' if key.startswith('n4_im')
                else key.rsplit('_', 1)[0])
        real = np.asarray(batch.terms[term].mask)
        a = np.asarray(got[key])[real]
        b, b32 = np.asarray(ref)[real], np.asarray(want32[key])[real]
        assert a.shape == b.shape and np.isfinite(a).all(), key
        keep = ((np.abs(a) > CUTOFF) == (np.abs(b) > CUTOFF)) & \
            ((np.abs(b32) > CUTOFF) == (np.abs(b) > CUTOFF))
        assert keep.mean() > 0.98, key
        ratios[key] = _ratio(a, b, b32, keep)
    for key, (mean_ratio, max_ratio) in ratios.items():
        assert mean_ratio <= mean_rule, (key, ratios)
        assert max_ratio <= max_rule, (key, ratios)
    return ratios


class _Fixture:
    """The JAX model's weights (flax init, jittered as tests/test_model.py
    does so the zero-initialised branches carry signal), a batch of 3
    molecules, and the outputs each JAX configuration gives, computed once
    per configuration."""

    def __init__(self):
        cfg = jgm.get_small_model_config()
        jms = [random_molecule(seed=s, atom_range=(8, 24)) for s in range(3)]
        jg = [JaxMolGraph.from_molecule(m) for m in jms]
        tg = [MolGraph.from_molecule(Molecule.from_dict(m.to_dict()))
              for m in jms]
        self.jb = jax_collate(jg, pad=jax_pad_spec(jg, 1), n_confs=1)
        self.tb = collate(tg, pad=bucketed_pad_spec(tg, 1), n_confs=1,
                          device='cpu')
        self.cfg = cfg
        jmodel = jgm.make_model(cfg)
        params = jax.jit(jmodel.init)(jax.random.key(0), self.jb)
        leaves, treedef = jax.tree.flatten(params)
        keys = jax.random.split(jax.random.key(42), len(leaves))
        self.params = jax.tree.unflatten(treedef, [
            leaf + 0.05 * jax.random.normal(k, leaf.shape, leaf.dtype)
            for leaf, k in zip(leaves, keys)])
        self.sd = state_dict_from_flax(self.params, cfg,
                                       stats_from_model(jmodel))
        self._jax = {}

    def jax(self, **over):
        """The JAX model's outputs and its GNN's embedding (captured from
        the same call): bf16 applied eagerly (see the module doc), float32
        under jit."""
        key = tuple(sorted(over.items()))
        if key not in self._jax:
            m = jgm.make_model(dict(self.cfg, **over))
            bf16 = 'bfloat16' in over.values()

            def run(params, batch):
                out, state = m.apply(params, batch,
                                     capture_intermediates=True)
                return out, state['intermediates']['gnn']['__call__'][0]

            out, h = (run if bf16 else jax.jit(run))(self.params, self.jb)
            self._jax[key] = ({k: np.asarray(v) for k, v in out.items()},
                              np.asarray(h))
        return self._jax[key]

    def port(self, **over):
        m = tgm.make_model(dict(self.cfg, **over))
        m.load_state_dict(self.sd, strict=True)
        return m.eval()


@pytest.fixture(scope='module')
def fixture():
    fb.INTERPRET = fs.INTERPRET = fg.INTERPRET = True
    return _Fixture()


def _flags(fused):
    return dict(fused_gnn=fused, fused_heads=fused)


def _heads(model, h, tb):
    w = model.parameter_writer
    n2_k, n2_eq = w.bond_writer(h, tb.terms['n2'].idxs)
    n3_k, n3_eq = w.angle_writer(h, tb.terms['n3'].idxs)
    return {'n2_k': n2_k, 'n2_eq': n2_eq, 'n3_k': n3_k, 'n3_eq': n3_eq,
            'n4_k': w.proper_writer(h, tb.terms['n4'].idxs),
            'n4_improper_k': w.improper_writer(
                h, tb.terms['n4_improper'].idxs)}


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'eager'])
def test_model_bf16_stages_match_jax(fixture, fused):
    """RULE for each stage alone: the GNN's embedding on the batch, then
    the four writers on the JAX bf16 model's own embedding. fused: the
    ops' plain versions against the Pallas kernels in interpret mode;
    eager: the modules against flax's."""
    fx, flags = fixture, _flags(fused)
    model = fx.port(compute_dtype='bfloat16', **flags)
    tb, real = fx.tb, np.asarray(fixture.jb.node_mask)
    want, h16 = fx.jax(compute_dtype='bfloat16', **flags)
    want32, h32 = fx.jax(**flags)
    with torch.no_grad():
        h = model.gnn(tb.feats, tb.neighbors, tb.neighbor_mask)
        # the JAX bf16 model's heads see its own GNN output, h16
        heads = _heads(model, torch.tensor(h16), tb)
    mean_ratio, max_ratio = _ratio(h.numpy()[real], h16[real], h32[real])
    assert mean_ratio <= RULE and max_ratio <= MODEL_MAX, (mean_ratio,
                                                           max_ratio)
    _outputs_close({k: v.numpy() for k, v in heads.items()}, want, want32,
                   fx.jb, RULE, MODEL_MAX)


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'eager'])
def test_model_bf16_matches_jax_end_to_end(fixture, fused):
    """The whole bf16 model against the JAX package's at RULE (the module
    doc gives the margin); its outputs are float32 and differ from the
    port's float32 model's."""
    fx, flags = fixture, _flags(fused)
    with torch.no_grad():
        got = fx.port(compute_dtype='bfloat16', **flags)(fx.tb)
        got32 = fx.port(**flags)(fx.tb)
    for key in got:
        assert got[key].dtype == torch.float32, key
        assert not torch.equal(got[key], got32[key]), key
    _outputs_close({k: v.numpy() for k, v in got.items()},
                   fx.jax(compute_dtype='bfloat16', **flags)[0],
                   fx.jax(**flags)[0], fx.jb, RULE, MODEL_MAX)


def test_stage_overrides_compose(fixture):
    """gnn_compute_dtype and heads_compute_dtype each change only their own
    stage (the port's counterpart of tests/test_model.py::
    test_per_stage_compute_dtype), and both together are
    compute_dtype='bfloat16' bit for bit; same state_dict throughout."""
    fx, tb = fixture, fixture.tb
    models = {name: fx.port(**over) for name, over in (
        ('f32', {}), ('gnn', {'gnn_compute_dtype': 'bfloat16'}),
        ('heads', {'heads_compute_dtype': 'bfloat16'}),
        ('both', {'gnn_compute_dtype': 'bfloat16',
                  'heads_compute_dtype': 'bfloat16'}),
        ('all', {'compute_dtype': 'bfloat16'}),
        ('all_but_gnn', {'compute_dtype': 'bfloat16',
                         'gnn_compute_dtype': 'float32'}))}
    with torch.no_grad():
        h = {k: m.gnn(tb.feats, tb.neighbors, tb.neighbor_mask)
             for k, m in models.items()}
        out = {k: m(tb) for k, m in models.items()}
        heads_on_f32 = {k: _heads(models[k], h['f32'], tb)
                        for k in ('f32', 'gnn')}
    assert torch.equal(h['heads'], h['f32'])
    assert torch.equal(h['all_but_gnn'], h['f32'])
    assert not torch.equal(h['gnn'], h['f32'])
    for key in out['f32']:
        assert torch.equal(heads_on_f32['gnn'][key],
                           heads_on_f32['f32'][key]), key
        assert torch.equal(out['both'][key], out['all'][key]), key
        assert torch.equal(out['all_but_gnn'][key], out['heads'][key]), key
    assert any(not torch.equal(out['heads'][k], out['f32'][k])
               for k in out['f32'])


def test_bf16_model_dict_predicts(fixture):
    """A bf16 model dict (the float32 parameter tree, the config naming
    the dtype) loads through Grappa.from_model_dict and predicts float32
    parameters that differ from the float32 model's."""
    fx = fixture
    mol = Molecule.from_dict(random_molecule(seed=5, atom_range=(10, 14))
                             .to_dict())
    preds = {}
    for dtype in ('float32', 'bfloat16'):
        cfg = dict(fx.cfg, compute_dtype=dtype)
        ff = Grappa.from_model_dict(
            {'state_dict': fx.sd, 'config': {'model_config': cfg}},
            device='cpu')
        preds[dtype] = ff.predict(mol, check_eq_values=False)
    a, b = preds['float32'].bond_k, preds['bfloat16'].bond_k
    assert np.isfinite(b).all() and b.dtype == np.float32
    assert not np.array_equal(a, b)


def _floats(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _floats(v)]
    return list(np.ravel(np.asarray(tree, np.float64)))


def test_eval_model_runs_bf16_forward_only(fixture):
    """eval_model takes a bf16 model as it is: the forward in bf16 (no
    gradient of a parameter), energies and dE/dx in float32; finite
    metrics that differ from the float32 model's."""
    fx = fixture
    ds = Dataset.from_moldata(make_dataset(n_mols=3, n_confs=2, seed=1))
    metrics = {}
    for dtype in ('float32', 'bfloat16'):
        model = fx.port(compute_dtype=dtype)
        metrics[dtype] = _floats(eval_model(model, ds, n_bootstrap=10,
                                            device='cpu')['grappa_tpu'])
        assert all(p.grad is None for p in model.parameters())
    assert np.isfinite(metrics['bfloat16']).all()
    assert metrics['bfloat16'] != metrics['float32']


# ------------------------------------------------------------ the card
class _FakeLib:
    """Stands in for the kernel library on the CPU: the forward and
    backward entry points write nothing and record (entry, mm_bf16)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith('_scratch'):
            return lambda *a: 16
        if name.endswith(('_fwd', '_bwd')):
            # mm_bf16 is the argument before the stream
            return lambda *a: self.calls.append((name[-3:], a[-2])) or 0
        raise AssertionError(f'{name} must not run')


def _simulate_card(monkeypatch, names=None):
    """on_cuda answers True (for the ops in `names`, else for all), the
    library is a _FakeLib, and outputs the kernels would write are zeros."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, 'on_cuda', lambda tensors, name: (
        names is None or name in names) or _on_cuda(tensors, name))
    monkeypatch.setattr(_cuda, 'lib', lambda: lib)
    monkeypatch.setattr(_cuda, 'stream_of', lambda t: 0)
    monkeypatch.setattr(torch, 'empty', torch.zeros)
    monkeypatch.setattr(torch, 'empty_like', torch.zeros_like)
    return lib


_on_cuda = _cuda.on_cuda
_COUNTS = ('launches', 'bf16_launches', 'bwd_launches', 'bf16_bwd_launches')


def _counts(op):
    return [getattr(op, c) for c in _COUNTS]


def _launch_k1(bf16):
    n, f, d = 6, 8, 2
    feat = torch.randn(n, f, requires_grad=True)
    p = [torch.randn(s) for s in ((f, f), (f,), (f,), (f,), (4 * f, f),
                                  (4 * f,), (f, 4 * f), (f,))]
    return tfg.fused_gnn_block(feat, torch.randn(d, n, f), torch.randn(n, f),
                               torch.ones(d, n), p, 2, mm_dtype=bf16)


def _launch_k2(bf16):
    f = 8
    x = torch.randn(2, 3, f, requires_grad=True)
    p = [torch.randn(s) for s in ((f,), (f,), (3 * f, f), (3 * f,), (f, f),
                                  (f,), (f,), (f,), (f, f), (f,), (f, f),
                                  (f,))]
    return tfb.fused_transformer_block(x, p, 2, mm_dtype=bf16)


def _launch_k3(bf16):
    x = torch.randn(2, 3, 4, requires_grad=True)
    layer = [torch.randn(s) for s in ((8,), (8,), (5, 8), (5,), (2, 5),
                                      (2,))]
    return tfs.fused_symmetriser(x, [layer], ((0, 1), (1, 0)),
                                 mm_dtype=bf16)


@pytest.mark.parametrize('launch,op', [
    (_launch_k1, tfg.fused_gnn_block),
    (_launch_k2, tfb.fused_transformer_block),
    (_launch_k3, tfs.fused_symmetriser)], ids=['K1', 'K2', 'K3'])
def test_bf16_backward_on_card_launches_bf16_kernels(monkeypatch, launch,
                                                     op):
    """On a CUDA tensor the bf16 forward and its backward launch the
    kernels with mm_bf16 = 1, counted apart from the float32 launches
    (bf16_launches, bf16_bwd_launches); no float32 kernel runs in their
    place. The float32 op launches with mm_bf16 = 0. The card is simulated:
    on_cuda answers True and the library is a fake."""
    lib = _simulate_card(monkeypatch)
    before = _counts(op)
    launch(BF16).sum().backward()
    assert lib.calls == [('fwd', 1), ('bwd', 1)]
    assert _counts(op) == [before[0], before[1] + 1, before[2],
                           before[3] + 1]
    launch(None).sum().backward()
    assert lib.calls[2:] == [('fwd', 0), ('bwd', 0)]
    assert _counts(op) == [before[0] + 1, before[1] + 1, before[2] + 1,
                           before[3] + 1]


def test_bf16_train_step_on_card_and_cpu(fixture, monkeypatch):
    """make_train_step (and so the Trainer) takes a bf16 model for the
    card: on a simulated card a step launches each fused op's bf16 forward
    and backward once a block and no float32 kernel; on the CPU the same
    step runs through the plain versions and moves the weights, as in the
    JAX package."""
    fx = fixture
    ops = (tfg.fused_gnn_block, tfb.fused_transformer_block,
           tfs.fused_symmetriser)
    w = LossWeights(torch.tensor(1.0), torch.tensor(0.8),
                    torch.full((fx.tb.num_mols,), 1e-3), torch.tensor(1e-3),
                    torch.tensor(1e-3))
    with monkeypatch.context() as m:
        lib = _simulate_card(m, {op.__name__ for op in ops})
        model = fx.port(compute_dtype='bfloat16', fused_gnn=True,
                        fused_heads=True)
        step = ttr.make_train_step(model, ttr.make_optimizer())
        before = [_counts(op) for op in ops]
        step(fx.tb, w, 1e-3, torch.Generator().manual_seed(0))
        got = [[a - b for a, b in zip(_counts(op), was)]
               for op, was in zip(ops, before)]
    blocks = (fx.cfg['gnn_attentional_layers'],
              4 * fx.cfg['bond_transformer_depth'], 4)
    assert got == [[0, n, 0, n] for n in blocks], got
    assert {flag for _, flag in lib.calls} == {1}
    model = fx.port(compute_dtype='bfloat16', fused_gnn=True,
                    fused_heads=True)
    step = ttr.make_train_step(model, ttr.make_optimizer())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _ = step(fx.tb, w, 1e-3, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    assert any(not torch.equal(before[k], v)
               for k, v in model.state_dict().items())
