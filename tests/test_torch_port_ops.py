"""Port ops K1-K3 (grappa_tpu_torch.ops) against the JAX package's Pallas
kernels (interpreter mode on the CPU) and its plain references, forward and
backward, and the port's plain Philox dropout.

On the CPU the port's wrappers run their plain PyTorch versions; the same
numpy inputs go through the JAX Pallas kernel (INTERPRET flipped in a
fixture, as tests/test_fused_ops.py does), the JAX reference function or
flax module, and the port. Tolerance rtol=atol=2e-5 (float32, as
tests/test_fused_ops.py), for outputs and for every gradient (autograd
through the plain version against jax.grad through the Pallas op,
deterministic). Dropout is checked against the port's own plain version:
Philox cannot give the TPU's bits. The CUDA kernels themselves are
compared with the plain versions by tests/test_torch_port_kernels.py
(marked `cuda`; they skip without a card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grappa_tpu.models.heads import (PERMUTATIONS, WRONG_SYMMETRY_IMPROPER,
                                     Symmetriser)
from grappa_tpu.ops import fused_block as fb
from grappa_tpu.ops import fused_gnn as fg
from grappa_tpu.ops import fused_symmetriser as fs
from grappa_tpu_torch.ops import fused_block as tfb
from grappa_tpu_torch.ops import fused_gnn as tfg
from grappa_tpu_torch.ops import fused_symmetriser as tfs
from grappa_tpu_torch.ops import philox

RTOL = ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret():
    fb.INTERPRET = fs.INTERPRET = fg.INTERPRET = True
    yield
    fb.INTERPRET = fs.INTERPRET = fg.INTERPRET = False


# ------------------------------------------------------------ inputs
def _dense(rng, n_in, n_out):
    return {'kernel': rng.normal(0, 1 / np.sqrt(n_in), (n_in, n_out))
            .astype(np.float32),
            'bias': rng.normal(0, 0.1, n_out).astype(np.float32)}


def _norm(rng, n):
    return {'scale': (1 + rng.normal(0, 0.1, n)).astype(np.float32),
            'bias': rng.normal(0, 0.1, n).astype(np.float32)}


def _lin(p):
    """flax Dense leaf -> torch Linear (weight (out, in), bias)."""
    return (torch.tensor(p['kernel'].T.copy()), torch.tensor(p['bias']))


def _ln(p):
    return torch.tensor(p['scale']), torch.tensor(p['bias'])


def gnn_params(rng, f, hid):
    """Every leaf non-zero: head_reducer and si_dense2 are zero-initialised
    in the model, where they would hide a wrong attention / FF."""
    return {'head_reducer': _dense(rng, f, f),
            'interaction_norm': _norm(rng, f),
            'si_dense1': _dense(rng, f, hid),
            'si_dense2': _dense(rng, hid, f)}


def gnn_torch(p):
    return (*_lin(p['head_reducer']), *_ln(p['interaction_norm']),
            *_lin(p['si_dense1']), *_lin(p['si_dense2']))


def block_params(rng, f, hid):
    return {'norm1': _norm(rng, f),
            'attn': {'in_proj': _dense(rng, f, 3 * f),
                     'out_proj': _dense(rng, f, f)},
            'ff': {'norm': _norm(rng, f), 'linear1': _dense(rng, f, hid),
                   'linear2': _dense(rng, hid, f)}}


def block_torch(p):
    return (*_ln(p['norm1']), *_lin(p['attn']['in_proj']),
            *_lin(p['attn']['out_proj']), *_ln(p['ff']['norm']),
            *_lin(p['ff']['linear1']), *_lin(p['ff']['linear2']))


def sym_params(rng, width, hidden, out, n_layers):
    tree = {}
    for i in range(n_layers):
        n_in = width if i == 0 else hidden
        n_out = out if i == n_layers - 1 else hidden
        tree[f'mlp_{i}'] = {'norm': _norm(rng, n_in),
                            'linear1': _dense(rng, n_in, hidden),
                            'linear2': _dense(rng, hidden, n_out)}
    return tree


def sym_torch(p, n_layers):
    return [(*_ln(p[f'mlp_{i}']['norm']), *_lin(p[f'mlp_{i}']['linear1']),
             *_lin(p[f'mlp_{i}']['linear2'])) for i in range(n_layers)]


def gnn_inputs(rng, n, f, d):
    feat = rng.normal(0, 1, (n, f)).astype(np.float32)
    neighbors = rng.integers(0, n, (n, d))
    mask = (rng.random((d, n)) > 0.3).astype(np.float32)
    mask[:, -3:] = 0.0              # padding atoms: every slot masked
    # a masked slot that holds the largest score of its row must still be
    # left out: point it at the node itself (the largest dot product)
    neighbors[0, 0] = 0
    mask[0, 0] = 0.0
    nbr = feat[neighbors.T]                         # (D, N, F)
    hn = rng.normal(0, 1, (n, f)).astype(np.float32)
    return feat, nbr, hn, mask


# ------------------------------------------------------------ K1
@pytest.mark.parametrize('n,f,heads,d', [(50, 64, 4, 6), (37, 128, 8, 8)])
def test_gnn_block_matches_pallas(n, f, heads, d):
    rng = np.random.default_rng(n)
    feat, nbr, hn, mask = gnn_inputs(rng, n, f, d)
    p = gnn_params(rng, f, 4 * f)
    y_pallas = fg.fused_gnn_block(feat, nbr, hn, mask, p, jnp.uint32(0),
                                  heads, 0.0, True, None, 32)
    y_ref = fg.reference_gnn_block(feat, nbr, hn, mask, p, n_heads=heads)
    y = tfg.fused_gnn_block(*map(torch.tensor, (feat, nbr, hn, mask)),
                            gnn_torch(p), heads)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), RTOL, ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), RTOL, ATOL)


def test_gnn_block_all_masked_rows_get_zero_attention():
    """Padding atoms (every slot masked) take no message: their output is
    the FF of LN(head_reducer bias + hn) alone."""
    rng = np.random.default_rng(3)
    n, f, heads, d = 8, 32, 4, 3
    feat, nbr, hn, mask = gnn_inputs(rng, n, f, d)
    p = gnn_torch(gnn_params(rng, f, 4 * f))
    args = [torch.tensor(a) for a in (feat, nbr, hn, mask)]
    y = tfg.fused_gnn_block(*args, p, heads)
    args[1] = torch.randn(d, n, f)          # other messages, same padding
    y2 = tfg.fused_gnn_block(*args, p, heads)
    torch.testing.assert_close(y2[-3:], y[-3:], rtol=0, atol=0)


# ------------------------------------------------------------ K2
@pytest.mark.parametrize('s', [2, 3, 4])
def test_transformer_block_matches_pallas(s):
    t, f, heads = 70, 128, 8                # T=70: ragged tile (block_t 64)
    rng = np.random.default_rng(10 + s)
    x = rng.normal(0, 1, (s, t, f)).astype(np.float32)
    p = block_params(rng, f, f)
    y_pallas = fb.fused_transformer_block(x, p, jnp.uint32(0), heads, 0.0,
                                          True, None, 64)
    y_ref = fb.reference_block(x, p, n_heads=heads)
    y = tfb.fused_transformer_block(torch.tensor(x), block_torch(p), heads)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), RTOL, ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), RTOL, ATOL)


# ------------------------------------------------------------ K3
@pytest.mark.parametrize('perms,out', [
    (PERMUTATIONS['n2'], 2), (PERMUTATIONS['n3'], 2),
    (PERMUTATIONS['n4_improper'], 6), (WRONG_SYMMETRY_IMPROPER, 6)],
    ids=['n2', 'n3', 'n4_improper', 'wrong_symmetry'])
def test_symmetriser_matches_pallas_and_flax(perms, out):
    s, t, f, hidden, n_layers = len(perms[0]), 70, 64, 64, 3
    rng = np.random.default_rng(20 + len(perms) + s)
    x = rng.normal(0, 1, (s, t, f)).astype(np.float32)
    p = sym_params(rng, s * f, hidden, out, n_layers)
    y_pallas = fs.fused_symmetriser(x, p, perms, n_layers, None, 32)
    mod = Symmetriser(permutations=perms, hidden_feats=hidden,
                      out_feats=out, n_layers=n_layers)
    y_flax = mod.apply({'params': p}, x.transpose(1, 0, 2), True)
    y = tfs.fused_symmetriser(torch.tensor(x), sym_torch(p, n_layers), perms)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), RTOL, ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_flax), RTOL, ATOL)


# ------------------------------------------------------------ wrappers
def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, (2, 5, 30)).astype(np.float32))
    p = block_torch(block_params(rng, 30, 30))
    with pytest.raises(ValueError, match='divisible'):
        tfb.fused_transformer_block(x, p, n_heads=4)
    with pytest.raises(ValueError, match='needs a seed'):
        tfb.fused_transformer_block(x, p, 5, dropout_rate=0.1, training=True)
    with pytest.raises(ValueError, match=r'\[0, 1\)'):
        tfb.fused_transformer_block(x, p, 5, dropout_rate=1.0, training=True,
                                    seed=1)
    feat, nbr, hn, mask = map(torch.tensor, gnn_inputs(rng, 6, 8, 2))
    with pytest.raises(ValueError, match='shape mismatch'):
        tfg.fused_gnn_block(feat, nbr[:, :5], hn, mask,
                            gnn_torch(gnn_params(rng, 8, 32)), 2)
    with pytest.raises(ValueError, match='orderings'):
        tfs.fused_symmetriser(x, sym_torch(sym_params(rng, 60, 8, 2, 2), 2),
                              ((0, 0), (1, 0)))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(0, 1, (3, 4, 16)).astype(np.float32))
    before = tfb.fused_transformer_block.launches
    tfb.fused_transformer_block(x, block_torch(block_params(rng, 16, 16)), 4)
    assert tfb.fused_transformer_block.launches == before


# ------------------------------------------------------------ backward
def _torch_grads(fn, arrays, dy):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    fn(*leaves).backward(torch.tensor(dy))
    return [t.grad.numpy() for t in leaves]


def _assert_grads(got, want, names):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g, np.asarray(w).reshape(g.shape), RTOL,
                                   ATOL, err_msg=name)


def _flax_grad_list(gtree, order):
    """Gradient tree of a flax param tree -> torch-layout list (kernels
    transposed) in the fused op's parameter order."""
    out = []
    for path in order:
        node = gtree
        for k in path:
            node = node[k]
        node = np.asarray(node)
        out.append(node.T if node.ndim == 2 else node)
    return out


@pytest.mark.parametrize('n,f,heads,d', [(45, 64, 4, 6), (29, 128, 8, 8)])
def test_gnn_block_backward_matches_pallas(n, f, heads, d):
    rng = np.random.default_rng(100 + n)
    feat, nbr, hn, mask = gnn_inputs(rng, n, f, d)
    p = gnn_params(rng, f, 4 * f)
    dy = rng.normal(0, 1, (n, f)).astype(np.float32)

    def jax_loss(feat, nbr, hn, p):
        y = fg.fused_gnn_block(feat, nbr, hn, mask, p, jnp.uint32(0), heads,
                               0.0, True, None, 32)
        return jnp.sum(y * dy)
    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(feat, nbr, hn, p)
    got = _torch_grads(
        lambda a, b, c, *q: tfg.fused_gnn_block(a, b, c, torch.tensor(mask),
                                                q, heads),
        [feat, nbr, hn, *[t.numpy() for t in gnn_torch(p)]], dy)
    _assert_grads(got[:3], want[:3], ['feat', 'nbr', 'hn'])
    _assert_grads(got[3:], _flax_grad_list(want[3], fg.PARAM_ORDER),
                  [str(q) for q in fg.PARAM_ORDER])
    # masked slots and all-masked (padding) rows take exactly zero
    assert np.all(got[1][mask == 0] == 0)


@pytest.mark.parametrize('s', [2, 3, 4])
def test_transformer_block_backward_matches_pallas(s):
    t, f, heads = 37, 64, 4
    rng = np.random.default_rng(40 + s)
    x = rng.normal(0, 1, (s, t, f)).astype(np.float32)
    p = block_params(rng, f, 96)
    dy = rng.normal(0, 1, (s, t, f)).astype(np.float32)

    def jax_loss(x, p):
        y = fb.fused_transformer_block(x, p, jnp.uint32(0), heads, 0.0,
                                       True, None, 32)
        return jnp.sum(y * dy)
    want = jax.grad(jax_loss, argnums=(0, 1))(x, p)
    got = _torch_grads(lambda a, *q: tfb.fused_transformer_block(a, q, heads),
                       [x, *[q.numpy() for q in block_torch(p)]], dy)
    _assert_grads(got[:1], want[:1], ['x'])
    _assert_grads(got[1:], _flax_grad_list(want[1], fb.PARAM_ORDER),
                  [str(q) for q in fb.PARAM_ORDER])


@pytest.mark.parametrize('perms,out', [
    (PERMUTATIONS['n3'], 2), (WRONG_SYMMETRY_IMPROPER, 6)],
    ids=['n3', 'wrong_symmetry'])
def test_symmetriser_backward_matches_pallas(perms, out):
    s, t, f, hidden, n_layers = len(perms[0]), 37, 32, 48, 3
    rng = np.random.default_rng(60 + len(perms))
    x = rng.normal(0, 1, (s, t, f)).astype(np.float32)
    p = sym_params(rng, s * f, hidden, out, n_layers)
    dy = rng.normal(0, 1, (t, out)).astype(np.float32)

    def jax_loss(x, p):
        return jnp.sum(fs.fused_symmetriser(x, p, perms, n_layers, None, 16)
                       * dy)
    want = jax.grad(jax_loss, argnums=(0, 1))(x, p)
    flat = [q.numpy() for layer in sym_torch(p, n_layers) for q in layer]
    got = _torch_grads(
        lambda a, *q: tfs.fused_symmetriser(
            a, [q[6 * i:6 * i + 6] for i in range(n_layers)], perms),
        [x, *flat], dy)
    _assert_grads(got[:1], want[:1], ['x'])
    order = fs._layer_paths(n_layers)
    _assert_grads(got[1:], _flax_grad_list(want[1], order),
                  [str(q) for q in order])


# ------------------------------------------------------------ Philox dropout
def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = philox.philox4x32(*map(t, ctr), *key)
        assert [int(w) for w in got] == list(want)


def test_philox_mask_is_a_function_of_seed_stream_and_index():
    m = philox.dropout_mask(11, 0, (40, 50), 0.3)
    # the same flat index gives the same bit whatever the shape
    assert torch.equal(m.reshape(-1),
                       philox.dropout_mask(11, 0, (2000,), 0.3))
    assert torch.equal(m.reshape(-1)[:700],
                       philox.dropout_mask(11, 0, (700,), 0.3))
    assert not torch.equal(m, philox.dropout_mask(11, 1, (40, 50), 0.3))
    assert not torch.equal(m, philox.dropout_mask(12, 0, (40, 50), 0.3))
    assert set(torch.unique(m).tolist()) == {0.0, philox.keep_scale(0.3)}


@pytest.mark.parametrize('rate', [0.1, 0.3, 0.5])
def test_philox_keep_fraction_within_4_sigma(rate):
    n = 200_000
    keep = float((philox.dropout_mask(7, 1, (n,), rate) > 0).float().mean())
    assert abs(keep - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n)


def test_plain_ops_with_dropout_equal_the_ops_fed_the_masks():
    """Forward and backward: the plain op with dropout at a seed equals the
    deterministic reference fed the dumped masks by hand."""
    rng = np.random.default_rng(5)
    feat, nbr, hn, mask = map(torch.tensor, gnn_inputs(rng, 30, 32, 4))
    pg = [q.requires_grad_(True) for q in gnn_torch(gnn_params(rng, 32,
                                                               128))]
    x = torch.tensor(rng.normal(0, 1, (3, 20, 32)).astype(np.float32))
    pb = [q.requires_grad_(True) for q in block_torch(block_params(rng, 32,
                                                                   32))]
    cases = [
        (lambda: tfg.fused_gnn_block(feat, nbr, hn, mask, pg, 4, 0.3, True, 9),
         lambda m: tfg.reference_gnn_block(feat, nbr, hn, mask, pg, 4, m),
         tfg.dropout_masks(9, feat.shape, 0.3, device='cpu'), pg),
        (lambda: tfb.fused_transformer_block(x, pb, 4, 0.5, True, 10),
         lambda m: tfb.reference_block(x, pb, 4, m),
         tfb.dropout_masks(10, x.shape, 0.5, device='cpu'), pb)]
    for op, ref, masks, params in cases:
        y = op()
        y_ref = ref(masks)
        torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
        g = torch.autograd.grad(y.square().sum(), params)
        g_ref = torch.autograd.grad(y_ref.square().sum(), params)
        for a, b in zip(g, g_ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert all((m == 0).any() for m in masks)     # masks drop
