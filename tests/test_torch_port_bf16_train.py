"""The port's bfloat16 training (the fused ops' bf16 backward; a bf16
model's loss gradients and train step) against the JAX package's on the
CPU.

The JAX kernels' backward rounds both operands of every backward product
to bf16, the incoming gradient's descendants included (`_dot_tn` /
`_dot_nt` with mm_dtype=bfloat16, grappa_tpu/ops/fused_block.py:112-134),
and sums in float32. The port's plain versions reach it through
`_cuda.mm_linear`, whose bf16 product has that backward. The Pallas
kernels run in interpret mode. The flax model runs eagerly where its bf16
Dense chains matter (the eager model; under jax.jit XLA on the CPU keeps
their excess precision: tests/test_torch_port_bf16.py's module doc) and
jitted without excess precision where that gives the eager bits (the
fused model, `_compiled`).

The rule (RULE), as for the forward: for every gradient, mean |port -
JAX_bf16| <= 0.1 x mean |JAX_bf16 - JAX_f32| (the bf16 effect on that
gradient), and the port's bf16 gradient differs from its float32 one. A
gradient that bf16 cannot move (a bias gradient summing the incoming
gradient, which no product touches) has no effect to measure and must
agree with JAX's to float32 sums instead. Where a float32 sum in another
order flips a bf16 rounding, the flip spreads through the later roundings
(as the forward's do), so a gradient also passes within
SPREAD = 1.25 x JAX's own bf16 gradient under a one-ulp change of every
input and weight. Ops: max <= 0.25 x the effect's max (OP_MAX), or that
spread.

Measured (mean ratios). The ops at the op tests' shapes: K1b 2e-5 to
5e-3, K2b 1e-5 to 4e-3 (S = 3) and 3e-3 to 0.04 (S = 4), K3b up to 0.089
(2 permutations, where JAX's own spread is 0.15-0.53 and one max ratio,
0.27, is the spread's own) and 0.027 (6). With mm_linear's former
straight-through backward (dy left unrounded) every op test fails: 0.63
to 0.92.

The small model (2 molecules x 2 conformers, dropout off, weights jittered
as tests/test_model.py:246-255 does), stage by stage (the GNN's
parameter gradients for JAX's bf16 gradient at its output; the writers'
for JAX's bf16 embedding as input) and end to end: fused 0.013 median,
0.068 max; eager 0.010 median, 0.103 max (JAX's own spread there 0.099).
Two bf16 semantics of the eager modules differ from flax's on the CPU.
jax.nn.elu differentiates expm1 by its output, g (expm1(x) + 1), with
each step rounded to bf16, where torch's elu backward rounds g exp(x)
once. That differed in a fifth of the elements, put the eager weights'
gradients at 0.1-0.34, and is repaired (`models.layers.elu`). A bias
that flax's Dense(dtype=bfloat16) adds in bf16 gets as gradient the
bf16 cotangent summed by XLA's CPU reduce in bf16: 4.8x the error of a
float32 sum of the same values on 64 rows, where torch (and XLA on the
TPU) sum in float32. Those biases (`_bf16_dense_biases`: the writers'
RepProjector, and every eager bf16 Dense) are held at BIAS_RULE = 1.0 of
the effect: measured 0.19-0.52 fused, up to 0.69 eager. One bf16
`make_train_step` against JAX's: the loss at RULE, Adam's first moments
at RULE (BIAS_RULE for those biases).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from grappa_tpu.data import MolGraph as JaxMolGraph
from grappa_tpu.data import collate as jax_collate
from grappa_tpu.data.synthetic import make_moldata as jax_make_moldata
from grappa_tpu.models import grappa_model as jgm
from grappa_tpu.models.heads import PERMUTATIONS, WRONG_SYMMETRY_IMPROPER
from grappa_tpu.ops import fused_block as fb
from grappa_tpu.ops import fused_gnn as fg
from grappa_tpu.ops import fused_symmetriser as fs
from grappa_tpu.train import loss as jloss
from grappa_tpu.train.torch_compat import stats_from_model
from grappa_tpu_torch.data import MolGraph, collate
from grappa_tpu_torch.data.moldata import MolData
from grappa_tpu_torch.models import grappa_model as tgm
from grappa_tpu_torch.ops import fused_block as tfb
from grappa_tpu_torch.ops import fused_gnn as tfg
from grappa_tpu_torch.ops import fused_symmetriser as tfs
from grappa_tpu_torch.train import loss as tloss
from grappa_tpu_torch.weights import (parameters_from_flax,
                                      state_dict_from_flax)

RULE = 0.1
OP_MAX = 0.25
SPREAD = 1.25
BIAS_RULE = 1.0
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret():
    fb.INTERPRET = fs.INTERPRET = fg.INTERPRET = True
    yield
    fb.INTERPRET = fs.INTERPRET = fg.INTERPRET = False


def _ratio(port, j16, j32):
    """(mean |port - j16| / mean |j16 - j32|, the same of the maxima);
    None where bf16 leaves the gradient as it is."""
    port, j16, j32 = (np.asarray(a, np.float64) for a in (port, j16, j32))
    err, eff = np.abs(port - j16), np.abs(j16 - j32)
    scale = max(float(np.abs(j32).max()), 1e-30)
    if eff.max() <= 1e-6 * scale:
        assert err.max() <= 1e-5 * scale, (err.max(), scale)
        return None
    return err.mean() / eff.mean(), err.max() / eff.max()


def _check_grads(got16, got32, want16, want32, want_ulp, names,
                 max_rule=OP_MAX, rules=None):
    """Each gradient's mean ratio at its rule (`rules[name]`, else RULE)
    and max ratio at max_rule (None: unchecked), or within SPREAD x JAX's
    own bf16 gradient under a one-ulp change of every input, where that
    floor is higher: `want_ulp()` gives those gradients (None: no floor),
    computed only when a ratio is over its rule. Returns {name: (mean
    ratio, max ratio[, floor's mean, floor's max])}."""
    rules = rules or {}
    ratios = {}
    for name, a, a32, b, b32 in zip(names, got16, got32, want16, want32):
        assert np.isfinite(a).all(), name
        r = _ratio(a, b, b32)
        if r is None:
            continue
        ratios[name] = r
        assert not np.array_equal(a, a32), name
    assert ratios
    over = lambda name, mean, mx: (
        mean > rules.get(name, RULE)
        or (max_rule is not None and mx > max_rule))
    if want_ulp is None or not any(over(k, *r) for k, r in ratios.items()):
        floors = {}
    else:
        ulp = dict(zip(names, want_ulp()))
        floors = {k: _ratio(ulp[k], *(dict(zip(names, w))[k]
                                       for w in (want16, want32)))
                  for k in ratios}
    for name, (mean_ratio, max_ratio) in ratios.items():
        floor = floors.get(name) or (0.0, 0.0)
        ratios[name] = (mean_ratio, max_ratio) + tuple(floors.get(name, ()))
        assert mean_ratio <= max(rules.get(name, RULE),
                                 SPREAD * floor[0]), (name, ratios)
        if max_rule is not None:
            assert max_ratio <= max(max_rule, SPREAD * floor[1]), (name,
                                                                   ratios)
    return ratios


def _ulp(tree, seed):
    """Every float32 leaf moved by one ulp in a seeded random direction."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.nextafter(
        np.asarray(a, np.float32), np.where(
            rng.random(np.shape(a)) < 0.5, -np.inf, np.inf).astype(
                np.float32)), tree)


# ------------------------------------------------------------ the ops
def _dense(rng, n_in, n_out):
    return {'kernel': rng.normal(0, 1 / np.sqrt(n_in), (n_in, n_out))
            .astype(np.float32),
            'bias': rng.normal(0, 0.1, n_out).astype(np.float32)}


def _norm(rng, n):
    return {'scale': (1 + rng.normal(0, 0.1, n)).astype(np.float32),
            'bias': rng.normal(0, 0.1, n).astype(np.float32)}


def _torch_layout(leaves):
    """A JAX (kernel, bias) / (scale, bias) sequence in torch Linear
    layout: kernels (in, out) -> weights (out, in)."""
    return [np.asarray(a).T if np.ndim(a) == 2 else np.asarray(a)
            for a in leaves]


def _lin(p):
    return [p['kernel'], p['bias']]


def _ln(p):
    return [p['scale'], p['bias']]


def _port_grads(fn, inputs, dy, mm_dtype):
    leaves = [torch.tensor(np.ascontiguousarray(a)).requires_grad_(True)
              for a in inputs]
    y = fn(*leaves, mm_dtype)
    return [g.numpy() for g in torch.autograd.grad(y, leaves,
                                                    torch.tensor(dy))]


def _jax_grads(fn, primals, dy, flatten):
    """JAX's gradients in bf16, in float32, and a callable giving them in
    bf16 with every primal one ulp away."""
    def grads(args, mm_dtype):
        _, vjp = jax.vjp(lambda *a: fn(*a, mm_dtype), *args)
        return [np.asarray(g) for g in flatten(vjp(jnp.asarray(dy)))]
    return (grads(primals, jnp.bfloat16), grads(primals, None),
            lambda: grads(_ulp(primals, 1), jnp.bfloat16))


def test_gnn_block_bf16_grads_match_pallas():
    """K1b: the six backward products in bf16 (scores, softmax, LayerNorm
    and attention backward float32): dfeat, dnbr, dhn and the 8 parameter
    gradients."""
    n, f, heads, d = 50, 64, 4, 6
    rng = np.random.default_rng(n)
    feat = rng.normal(0, 1, (n, f)).astype(np.float32)
    mask = (rng.random((d, n)) > 0.3).astype(np.float32)
    mask[:, -3:] = 0.0
    nbr = feat[rng.integers(0, n, (n, d)).T]
    hn = rng.normal(0, 1, (n, f)).astype(np.float32)
    p = {'head_reducer': _dense(rng, f, f),
         'interaction_norm': _norm(rng, f),
         'si_dense1': _dense(rng, f, 4 * f),
         'si_dense2': _dense(rng, 4 * f, f)}
    order = ('head_reducer', 'interaction_norm', 'si_dense1', 'si_dense2')
    flat = lambda tree: [a for k in order for a in (
        _ln(tree[k]) if k == 'interaction_norm' else _lin(tree[k]))]
    dy = rng.normal(0, 1, (n, f)).astype(np.float32)
    jfn = lambda a, b, c, q, mm: fg.fused_gnn_block(
        a, b, c, mask, q, jnp.uint32(0), heads, 0.0, True, mm, 32)
    jflat = lambda g: [*g[:3], *_torch_layout(flat(g[3]))]
    tfn = lambda a, b, c, *q: tfg.fused_gnn_block(
        a, b, c, torch.tensor(mask), q[:-1], heads, mm_dtype=q[-1])
    inputs = [feat, nbr, hn, *_torch_layout(flat(p))]
    names = ['dfeat', 'dnbr', 'dhn', 'dwr', 'dbr', 'dg2', 'db2', 'dw1',
             'dc1', 'dw2', 'dc2']
    _check_grads(_port_grads(tfn, inputs, dy, BF16),
                 _port_grads(tfn, inputs, dy, None),
                 *_jax_grads(jfn, (feat, nbr, hn, p), dy, jflat), names)


@pytest.mark.parametrize('s', [3, 4])
def test_transformer_block_bf16_grads_match_pallas(s):
    """K2b: the eight backward products in bf16 (LayerNorm and attention
    backward float32): dx and the 12 parameter gradients, at
    tests/test_torch_port_bf16.py's shapes. With mm_linear's former
    straight-through backward dx, dW1 and dWq erred by 0.70-0.74 of the
    bf16 effect."""
    t, f, heads, hid = 40, 64, 4, 64
    rng = np.random.default_rng(s)
    x = rng.normal(0, 1, (s, t, f)).astype(np.float32)
    p = {'norm1': _norm(rng, f),
         'attn': {'in_proj': _dense(rng, f, 3 * f),
                  'out_proj': _dense(rng, f, f)},
         'ff': {'norm': _norm(rng, f), 'linear1': _dense(rng, f, hid),
                'linear2': _dense(rng, hid, f)}}
    flat = lambda tree: (_ln(tree['norm1']) + _lin(tree['attn']['in_proj'])
                         + _lin(tree['attn']['out_proj'])
                         + _ln(tree['ff']['norm'])
                         + _lin(tree['ff']['linear1'])
                         + _lin(tree['ff']['linear2']))
    dy = rng.normal(0, 1, (s, t, f)).astype(np.float32)
    jfn = lambda a, q, mm: fb.fused_transformer_block(
        a, q, jnp.uint32(0), heads, 0.0, True, mm)
    jflat = lambda g: [g[0], *_torch_layout(flat(g[1]))]
    tfn = lambda a, *q: tfb.fused_transformer_block(a, q[:-1], heads,
                                                    mm_dtype=q[-1])
    inputs = [x, *_torch_layout(flat(p))]
    names = ['dx', 'dg1', 'db1', 'dwq', 'dbq', 'dwo', 'dbo', 'dg2', 'db2',
             'dw1', 'dc1', 'dw2', 'dc2']
    _check_grads(_port_grads(tfn, inputs, dy, BF16),
                 _port_grads(tfn, inputs, dy, None),
                 *_jax_grads(jfn, (x, p), dy, jflat), names)


@pytest.mark.parametrize('perms', [PERMUTATIONS['n4'],
                                   WRONG_SYMMETRY_IMPROPER],
                         ids=['2_perms', '6_perms'])
def test_symmetriser_bf16_grads_match_pallas(perms):
    """K3b: every layer's four backward products in bf16 (3 layers, the
    middle one with its skip): dx and each layer's 6 gradients."""
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
    flat = lambda tree: [a for i in range(n_layers) for a in (
        _ln(tree[f'mlp_{i}']['norm']) + _lin(tree[f'mlp_{i}']['linear1'])
        + _lin(tree[f'mlp_{i}']['linear2']))]
    dy = rng.normal(0, 1, (t, out)).astype(np.float32)
    jfn = lambda a, q, mm: fs.fused_symmetriser(a, q, perms, n_layers, mm)
    jflat = lambda g: [g[0], *_torch_layout(flat(g[1]))]

    def tfn(a, *q):
        layers = [q[6 * i:6 * i + 6] for i in range(n_layers)]
        return tfs.fused_symmetriser(a, layers, perms, mm_dtype=q[-1])

    inputs = [x, *_torch_layout(flat(p))]
    names = ['dx'] + [f'layer {i} {k}' for i in range(n_layers)
                      for k in ('dg', 'db', 'dw1', 'dc1', 'dw2', 'dc2')]
    _check_grads(_port_grads(tfn, inputs, dy, BF16),
                 _port_grads(tfn, inputs, dy, None),
                 *_jax_grads(jfn, (x, p), dy, jflat), names)


# ------------------------------------------------------------ the model
def _compiled(fn, *args):
    """fn(*args) jitted without XLA's excess precision, so every bf16
    rounding of flax's modules and of the Pallas kernels (interpret mode)
    is kept: the fused bf16 model's outputs then equal the eager call's
    (checked on this batch: bit for bit but one n3_k entry, 1.5e-5). The
    eager model's do not (its bf16 Dense chains fuse): it runs eagerly."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_allow_excess_precision': False})(*args)


def _jitter(params, key=42):
    """tests/test_model.py:246-255's jitter: the zero-initialised residual
    branches carry signal, so a dtype change there shows. Each leaf gets
    0.05 x jax.random.normal(its key, its shape); the draws of one shape
    are made in one vmapped call (the same bits as a call a leaf, for one
    compile a shape instead of one a leaf) and added in numpy float32 (the
    same rounding as JAX's eager add)."""
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.key(key), len(leaves))
    groups = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault((leaf.shape, np.dtype(leaf.dtype)), []).append(i)

    def draw(keys):
        out = [None] * len(leaves)
        for (shape, dtype), idx in groups.items():
            noise = jax.vmap(lambda k: jax.random.normal(k, shape, dtype))(
                keys[np.asarray(idx)])
            for j, i in enumerate(idx):
                out[i] = noise[j]
        return out

    return jax.tree.unflatten(treedef, [
        jnp.asarray(np.asarray(leaf) + leaf.dtype.type(0.05) * np.asarray(n))
        for leaf, n in zip(leaves, jax.jit(draw)(keys))])


class _Model:
    """The small model's weights (flax init, jittered), a dropout-free
    batch of 2 molecules x 2 conformers and JAX's loss gradients in each
    configuration, computed once: the parameters' and the GNN output's
    (a zero probe added to it), and that output itself."""

    def __init__(self):
        from grappa_tpu.models.gnn import GrappaGNN
        self.GrappaGNN = GrappaGNN
        self.cfg = jgm.get_small_model_config()
        jmds = [jax_make_moldata(seed=s, n_confs=2) for s in (0, 1)]
        tmds = [MolData.from_dict(m.to_dict()) for m in jmds]
        self.jb = jax_collate([JaxMolGraph.from_moldata(m) for m in jmds],
                              n_confs=2)
        self.tb = collate([MolGraph.from_moldata(m) for m in tmds],
                          n_confs=2, device='cpu')
        m = self.jb.num_mols
        self.jw = jloss.LossWeights(
            energy=jnp.float32(1.0), gradient=jnp.float32(0.8),
            param=jnp.full(m, 1e-3, jnp.float32),
            proper_reg=jnp.float32(1e-3), improper_reg=jnp.float32(1e-3))
        self.tw = tloss.LossWeights(1.0, 0.8, torch.full((m,), 1e-3), 1e-3,
                                    1e-3)
        jmodel = jgm.make_model(self.cfg)
        self.params = _jitter(jax.jit(jmodel.init)(jax.random.key(0),
                                                   self.jb))
        self.stats = stats_from_model(jmodel)
        self._grads = {}

    def _loss(self, cfg):
        """(params, probe) -> (loss, GNN output): the JAX model's loss with
        `probe` added to its GNN's output."""
        import flax.linen as nn
        model = jgm.make_model(cfg)

        def tap(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if (isinstance(context.module, self.GrappaGNN)
                    and context.method_name == '__call__'):
                tap.h = out + tap.probe
                return tap.h
            return out

        def loss(params, probe):
            tap.probe = probe
            with nn.intercept_methods(tap):
                pred = model.apply(params, self.jb)
            return jloss.molwise_loss(self.jb, pred, self.jw)[0], tap.h
        return loss

    def grads(self, fused, dtype='bfloat16', ulp=False):
        """{'loss', 'params' (port names), 'g_h', 'h'} of JAX's model."""
        key = (fused, dtype, ulp)
        if key not in self._grads:
            cfg = dict(self.cfg, compute_dtype=dtype, fused_gnn=fused,
                       fused_heads=fused)
            params = _ulp(self.params, 2) if ulp else self.params
            n = self.jb.xyz.shape[0]
            probe = jnp.zeros((n, self.cfg['graph_node_features']),
                              jnp.float32)
            fn = jax.value_and_grad(self._loss(cfg), argnums=(0, 1),
                                    has_aux=True)
            if fused or dtype == 'float32':
                (loss, h), (g, g_h) = _compiled(fn, params, probe)
            else:
                (loss, h), (g, g_h) = fn(params, probe)
            self._grads[key] = dict(
                loss=float(loss), params=parameters_from_flax(
                    jax.device_get(g), self.cfg),
                g_h=np.asarray(g_h), h=np.asarray(h))
        return self._grads[key]

    def port(self, fused, dtype='bfloat16'):
        model = tgm.make_model(dict(self.cfg, compute_dtype=dtype,
                                    fused_gnn=fused, fused_heads=fused))
        model.load_state_dict(state_dict_from_flax(self.params, self.cfg,
                                                   self.stats), strict=True)
        return model.train()


@pytest.fixture(scope='module')
def model_fx():
    return _Model()


def _writers(model, h, tb):
    w = model.parameter_writer
    n2_k, n2_eq = w.bond_writer(h, tb.terms['n2'].idxs)
    n3_k, n3_eq = w.angle_writer(h, tb.terms['n3'].idxs)
    return {'n2_k': n2_k, 'n2_eq': n2_eq, 'n3_k': n3_k, 'n3_eq': n3_eq,
            'n4_k': w.proper_writer(h, tb.terms['n4'].idxs),
            'n4_improper_k': w.improper_writer(
                h, tb.terms['n4_improper'].idxs)}


def _port_stage_grads(model, fx, j16):
    """The port's GNN parameter gradients for JAX's bf16 gradient at the
    GNN output, and its writers' for JAX's bf16 GNN output as input."""
    tb = fx.tb
    named = dict(model.named_parameters())
    gnn = {k: v for k, v in named.items() if k.startswith('gnn.')}
    h = model.gnn(tb.feats, tb.neighbors, tb.neighbor_mask)
    out = dict(zip(gnn, torch.autograd.grad(
        h, list(gnn.values()), torch.tensor(j16['g_h']),
        allow_unused=True)))
    heads = {k: v for k, v in named.items() if k not in gnn}
    loss, _ = tloss.molwise_loss(tb, _writers(model, torch.tensor(j16['h']),
                                              tb), fx.tw)
    out.update(zip(heads, torch.autograd.grad(loss, list(heads.values()),
                                              allow_unused=True)))
    return {k: (torch.zeros_like(named[k]) if g is None else g).numpy()
            for k, g in out.items()}


def _model_grads(model, fx):
    loss, _ = tloss.molwise_loss(fx.tb, model(fx.tb), fx.tw)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return float(loss.detach()), {
        n: (torch.zeros_like(p) if g is None else g).numpy()
        for n, p, g in zip(names, params, grads)}


def _bf16_dense_biases(model, fx, monkeypatch):
    """The names of the biases the port adds in bf16 (`layers.dense` with
    dtype bf16: flax's Dense(dtype=bfloat16) bias), found by running the
    model once."""
    from grappa_tpu_torch.models import gnn, heads, layers
    seen = set()
    plain = layers.dense

    def dense(x, weight, bias=None, dtype=None):
        if bias is not None and dtype == torch.bfloat16:
            seen.add(id(bias))
        return plain(x, weight, bias, dtype)

    with monkeypatch.context() as m:
        for module in (gnn, heads, layers):
            m.setattr(module, 'dense', dense)
        with torch.no_grad():
            model(fx.tb)
    return {k for k, v in model.named_parameters() if id(v) in seen}


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'eager'])
def test_model_bf16_gradients_match_jax(model_fx, fused, monkeypatch):
    """The small bf16 model's loss gradients: each stage alone (the GNN
    for JAX's gradient at its output, the writers on JAX's embedding) and
    end to end, at RULE or within SPREAD x JAX's own spread under a
    one-ulp weight change; the biases added in bf16 at BIAS_RULE. Every
    gradient finite and unlike float32's; the loss at RULE. fused: the
    ops' plain versions against the Pallas kernels (interpret mode);
    eager: the modules against flax's."""
    fx = model_fx
    j16, j32 = fx.grads(fused), fx.grads(fused, 'float32')
    names = list(j16['params'])
    model = fx.port(fused)
    rules = dict.fromkeys(_bf16_dense_biases(model, fx, monkeypatch),
                          BIAS_RULE)
    want = [[d['params'][k].numpy() for k in names] for d in (j16, j32)]
    ulp = lambda: [fx.grads(fused, ulp=True)['params'][k].numpy()
                   for k in names]
    loss16, got16 = _model_grads(model, fx)
    loss32, got32 = _model_grads(fx.port(fused, 'float32'), fx)
    got32 = [got32[k] for k in names]
    stages = _port_stage_grads(model, fx, j16)
    for got in (stages, got16):
        _check_grads([got[k] for k in names], got32, *want, ulp, names,
                     max_rule=None, rules=rules)
    assert abs(loss16 - j16['loss']) <= RULE * abs(j16['loss'] - j32['loss'])
    assert loss16 != loss32


def test_train_step_bf16_matches_jax(model_fx):
    """One bf16 make_train_step of the fused model (the ops' plain
    versions) against the JAX package's make_train_step (Pallas in
    interpret mode): the loss at RULE of its bf16 effect, and Adam's
    first moments (0.1 x the gradients clipped to global norm 10) at
    RULE, or at BIAS_RULE for the biases added in bf16. The effect is
    bf16's on the gradients at the bf16 step's clip factor: the float32
    gradients clipped by the float32 norm would also move every moment by
    the norm's own bf16 change (0.8% here), which cancels up to ~40% of
    a tensor's effect and would hold the port to the clipping's
    arithmetic rather than the gradients' (port 0.06 of the gradient
    effect on fc.weight, 0.10 of the clipped)."""
    import optax
    from grappa_tpu.train import trainer as jtrainer
    from grappa_tpu_torch.train import trainer as ttrainer
    fx = model_fx
    cfg = dict(fx.cfg, compute_dtype='bfloat16', fused_gnn=True,
               fused_heads=True)
    tx = jtrainer.make_optimizer()
    step = jtrainer.make_train_step(jgm.make_model(cfg), tx, donate=False)
    _, opt_state, loss, _ = _compiled(step, fx.params, tx.init(fx.params),
                                      fx.jb, fx.jw, jnp.float32(1e-3),
                                      jax.random.key(3))
    adam = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    want16 = parameters_from_flax(jax.device_get(adam.mu), fx.cfg)
    g16, g32 = fx.grads(True), fx.grads(True, 'float32')
    norm = np.sqrt(sum(float((g.double() ** 2).sum())
                       for g in g16['params'].values()))
    clip = min(1.0, 10.0 / norm)               # make_optimizer's grad_clip
    want32 = {k: (0.1 * clip * g.numpy()).astype(np.float32)
              for k, g in g32['params'].items()}
    model = fx.port(True)
    opt = ttrainer.make_optimizer()
    got_loss, _ = ttrainer.make_train_step(model, opt)(
        fx.tb, fx.tw, 1e-3, torch.Generator().manual_seed(0))
    assert abs(float(got_loss) - float(loss)) <= RULE * abs(
        float(loss) - g32['loss'])
    names = list(want16)
    mu32 = [want32[k] for k in names]
    rules = dict.fromkeys(
        [k for k in names if k.endswith('rep_projector.mlp.0.bias')],
        BIAS_RULE)
    _check_grads([opt.mu[k].numpy() for k in names], mu32,
                 [want16[k].numpy() for k in names], mu32, None, names,
                 max_rule=None, rules=rules)
