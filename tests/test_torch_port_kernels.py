"""The port's CUDA kernels (K1-K3 forward, K1b-K3b backward, dropout and the
K1m / K2m mask dump) against their plain PyTorch versions on the card.
Every test here needs a CUDA device: it carries the `cuda` marker and skips
without one.

This file imports neither JAX nor grappa_tpu, so it also runs on a machine
without JAX (`python -m pytest tests/test_torch_port_kernels.py
--noconftest`; the suite's conftest imports JAX). Shapes cover the serving
path's and the edges the kernels mask: ragged rows, head widths below a
warp (dh=9, 16), reductions that are not a multiple of the GEMM's K step,
D < 8 slots, 1-3 symmetriser layers, 6 permutations. Tolerance: forward
outputs elementwise |kernel - plain| <= 1e-4 + 1e-4 |plain| (float32 sums
in another order); gradients max |kernel - plain| <= 1e-4 * max |plain|
per tensor (weight gradients sum thousands of rows, so an element that
cancels to near 0 carries the error of its larger terms). Backward: the
kernel's gradients against autograd through the plain version on the same
inputs, dropout masks from the same seed. Masks: bit-equal to the plain
Philox.
"""
import numpy as np
import pytest
import torch

from grappa_tpu_torch.models.heads import (PERMUTATIONS,
                                           WRONG_SYMMETRY_IMPROPER)
from grappa_tpu_torch.ops import fused_block as tfb
from grappa_tpu_torch.ops import fused_gnn as tfg
from grappa_tpu_torch.ops import fused_symmetriser as tfs
from grappa_tpu_torch.ops import philox

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


def _params(gen, shapes, device):
    """Weights ~ N(0, 1/fan_in); 'g' LayerNorm scales around 1; 'b' biases
    around 0 -- every entry non-zero."""
    out = []
    for shape, kind in shapes:
        t = torch.randn(shape, generator=gen)
        t = (t / np.sqrt(shape[1]) if kind == 'w'
             else 1 + 0.1 * t if kind == 'g' else 0.1 * t)
        out.append(t.to(device))
    return out


def _gnn_case(device, n, f, d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    feat = torch.randn((n, f), generator=gen)
    neighbors = torch.randint(0, n, (n, d), generator=gen)
    neighbors[0, 0] = 0                  # masked slot holding the row max
    mask = (torch.rand((d, n), generator=gen) > 0.3).float()
    mask[0, 0] = 0.0
    mask[:, -3:] = 0.0                   # padding rows: every slot masked
    nbr = feat[neighbors.t()].contiguous()
    hn = torch.randn((n, f), generator=gen)
    hid = 4 * f
    p = _params(gen, [((f, f), 'w'), ((f,), 'b'), ((f,), 'g'), ((f,), 'b'),
                      ((hid, f), 'w'), ((hid,), 'b'), ((f, hid), 'w'),
                      ((f,), 'b')], device)
    return [a.to(device) for a in (feat, nbr, hn, mask)], p


def _block_case(device, s, t, f, hid, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((s, t, f), generator=gen).to(device)
    p = _params(gen, [((f,), 'g'), ((f,), 'b'), ((3 * f, f), 'w'),
                      ((3 * f,), 'b'), ((f, f), 'w'), ((f,), 'b'),
                      ((f,), 'g'), ((f,), 'b'), ((hid, f), 'w'),
                      ((hid,), 'b'), ((f, hid), 'w'), ((f,), 'b')], device)
    return x, p


def _sym_case(device, s, t, f, width, out, n_layers, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((s, t, f), generator=gen).to(device)
    layers = []
    for i in range(n_layers):
        n_in = s * f if i == 0 else width
        n_out = out if i == n_layers - 1 else width
        layers.append(_params(gen, [
            ((n_in,), 'g'), ((n_in,), 'b'), ((width, n_in), 'w'),
            ((width,), 'b'), ((n_out, width), 'w'), ((n_out,), 'b')],
            device))
    return x, layers


@pytest.mark.parametrize('n,f,heads,d', [
    (50, 64, 4, 6), (33, 36, 4, 3), (1376, 512, 16, 8)])
def test_gnn_kernel_matches_plain(cuda, n, f, heads, d):
    args, p = _gnn_case(cuda, n, f, d)
    before = tfg.fused_gnn_block.launches
    y = tfg.fused_gnn_block(*args, p, heads)
    torch.cuda.synchronize()
    assert tfg.fused_gnn_block.launches == before + 1
    torch.testing.assert_close(y, tfg.reference_gnn_block(*args, p, heads),
                               **TOL)


@pytest.mark.parametrize('s,t,f,heads,hid', [
    (2, 70, 512, 8, 512), (3, 1720, 512, 8, 512), (4, 2152, 512, 8, 512),
    (4, 33, 64, 4, 96), (3, 5, 36, 4, 20)])
def test_block_kernel_matches_plain(cuda, s, t, f, heads, hid):
    x, p = _block_case(cuda, s, t, f, hid)
    before = tfb.fused_transformer_block.launches
    y = tfb.fused_transformer_block(x, p, heads)
    torch.cuda.synchronize()
    assert tfb.fused_transformer_block.launches == before + 1
    torch.testing.assert_close(y, tfb.reference_block(x, p, heads), **TOL)


@pytest.mark.parametrize('perms,t,f,width,out,n_layers', [
    (PERMUTATIONS['n4'], 2152, 512, 256, 12, 3),
    (WRONG_SYMMETRY_IMPROPER, 552, 512, 256, 6, 3),
    (PERMUTATIONS['n2'], 70, 36, 64, 1, 1),
    (PERMUTATIONS['n3'], 101, 64, 48, 2, 2)])
def test_symmetriser_kernel_matches_plain(cuda, perms, t, f, width, out,
                                          n_layers):
    x, layers = _sym_case(cuda, len(perms[0]), t, f, width, out, n_layers)
    before = tfs.fused_symmetriser.launches
    y = tfs.fused_symmetriser(x, layers, perms)
    torch.cuda.synchronize()
    assert tfs.fused_symmetriser.launches == before + 1
    torch.testing.assert_close(
        y, tfs.reference_symmetriser(x, layers, perms), **TOL)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, p = _block_case(cuda, 2, 16, 64, 64)
    with pytest.raises(TypeError, match='float32'):
        tfb.fused_transformer_block(x.double(), [q.double() for q in p], 4)
    with pytest.raises(ValueError, match='contiguous'):
        tfb.fused_transformer_block(x.transpose(0, 1).contiguous()
                                    .transpose(0, 1), p, 4)
    with pytest.raises(ValueError, match='one CUDA device or all on the CPU'):
        tfb.fused_transformer_block(x.cpu(), p, 4)
    with pytest.raises(ValueError, match='slots'):
        x5, p5 = _block_case(cuda, 5, 4, 16, 16)
        tfb.fused_transformer_block(x5, p5, 4)
    args, pg = _gnn_case(cuda, 10, 16, 9)
    with pytest.raises(ValueError, match='neighbour slots'):
        tfg.fused_gnn_block(*args, pg, 4)
    with pytest.raises(ValueError, match='needs a seed'):
        tfb.fused_transformer_block(x, p, 4, dropout_rate=0.5, training=True)


def test_small_model_fused_matches_eager_on_card(cuda):
    """The whole small model on the card: kernels vs the eager modules."""
    from grappa_tpu_torch import Grappa
    from grappa_tpu_torch.data.synthetic import random_molecule
    from grappa_tpu_torch.models.grappa_model import (get_small_model_config,
                                                      make_model)
    cfg = get_small_model_config()
    gen = torch.Generator().manual_seed(0)
    eager = make_model(dict(cfg, fused_gnn=False, fused_heads=False),
                       generator=gen)
    with torch.no_grad():
        for q in eager.parameters():
            q.add_(0.05 * torch.randn(q.shape, generator=gen))
    fused = make_model(cfg)                     # 'auto': kernels on CUDA
    fused.load_state_dict(eager.state_dict())
    mols = [random_molecule(seed=s) for s in range(5)]
    a = Grappa(eager, device=cuda).predict_many(mols, check_eq_values=False)
    before = tfg.fused_gnn_block.launches
    b = Grappa(fused, device=cuda).predict_many(mols, check_eq_values=False)
    assert tfg.fused_gnn_block.launches == before + 2
    for pa, pb in zip(a, b):
        for k in ('bond_k', 'bond_eq', 'angle_k', 'angle_eq'):
            np.testing.assert_allclose(getattr(pb, k), getattr(pa, k),
                                       rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- backward
GRAD_RTOL = 1e-4


def _grads(fn, inputs, dy):
    """Gradients of <fn(*inputs), dy> w.r.t. every input."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    y.backward(dy)
    return y.detach(), [t.grad for t in leaves]


def _assert_grads(got, want, names):
    for g, w, name in zip(got, want, names):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert torch.isfinite(g).all(), name
        assert err <= GRAD_RTOL * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize('n,f,heads,d,rate', [
    (50, 64, 4, 6, 0.0), (33, 36, 4, 3, 0.3), (1376, 512, 16, 8, 0.3)])
def test_gnn_backward_matches_plain(cuda, n, f, heads, d, rate):
    (feat, nbr, hn, mask), p = _gnn_case(cuda, n, f, d)
    dy = torch.randn((n, f), generator=torch.Generator().manual_seed(7))
    dy = dy.to(cuda)
    seed = 1234 if rate else None
    kernel = lambda a, b, c, *q: tfg.fused_gnn_block(
        a, b, c, mask, q, heads, rate, True, seed)
    masks = (tuple(m.to(cuda) for m in philox.dump_masks(
        seed, (n, f), rate, torch.device('cpu'))) if rate else None)
    plain = lambda a, b, c, *q: tfg.reference_gnn_block(
        a, b, c, mask, q, heads, masks)
    before = tfg.fused_gnn_block.bwd_launches
    y_k, g_k = _grads(kernel, [feat, nbr, hn, *p], dy)
    torch.cuda.synchronize()
    assert tfg.fused_gnn_block.bwd_launches == before + 1
    y_p, g_p = _grads(plain, [feat, nbr, hn, *p], dy)
    torch.testing.assert_close(y_k, y_p, **TOL)
    _assert_grads(g_k, g_p, ['feat', 'nbr', 'hn', 'wr', 'br', 'g2', 'b2',
                             'w1', 'c1', 'w2', 'c2'])
    # masked slots and padding rows take exactly zero
    assert bool((g_k[1][mask == 0] == 0).all())


@pytest.mark.parametrize('s,t,f,heads,hid,rate', [
    (2, 70, 512, 8, 512, 0.5), (3, 101, 64, 4, 96, 0.0),
    (4, 2152, 512, 8, 512, 0.5), (3, 5, 36, 4, 20, 0.5)])
def test_block_backward_matches_plain(cuda, s, t, f, heads, hid, rate):
    x, p = _block_case(cuda, s, t, f, hid)
    dy = torch.randn((s, t, f), generator=torch.Generator().manual_seed(8))
    dy = dy.to(cuda)
    seed = 99 if rate else None
    masks = (tuple(m.to(cuda) for m in philox.dump_masks(
        seed, (s, t, f), rate, torch.device('cpu'))) if rate else None)
    before = tfb.fused_transformer_block.bwd_launches
    y_k, g_k = _grads(lambda a, *q: tfb.fused_transformer_block(
        a, q, heads, rate, True, seed), [x, *p], dy)
    torch.cuda.synchronize()
    assert tfb.fused_transformer_block.bwd_launches == before + 1
    y_p, g_p = _grads(lambda a, *q: tfb.reference_block(a, q, heads, masks),
                      [x, *p], dy)
    torch.testing.assert_close(y_k, y_p, **TOL)
    _assert_grads(g_k, g_p, ['x', 'g1', 'b1', 'wq', 'bq', 'wo', 'bo', 'g2',
                             'b2', 'w1', 'c1', 'w2', 'c2'])


@pytest.mark.parametrize('perms,t,f,width,out,n_layers', [
    (PERMUTATIONS['n4'], 2152, 512, 256, 12, 3),
    (WRONG_SYMMETRY_IMPROPER, 552, 512, 256, 6, 3),
    (PERMUTATIONS['n2'], 70, 36, 64, 1, 1),
    (PERMUTATIONS['n3'], 101, 64, 48, 2, 2)])
def test_symmetriser_backward_matches_plain(cuda, perms, t, f, width, out,
                                            n_layers):
    x, layers = _sym_case(cuda, len(perms[0]), t, f, width, out, n_layers)
    flat = [q for layer in layers for q in layer]
    dy = torch.randn((t, out), generator=torch.Generator().manual_seed(9))
    dy = dy.to(cuda)
    split = lambda q: [q[6 * i:6 * i + 6] for i in range(n_layers)]
    before = tfs.fused_symmetriser.bwd_launches
    y_k, g_k = _grads(lambda a, *q: tfs.fused_symmetriser(a, split(q), perms),
                      [x, *flat], dy)
    torch.cuda.synchronize()
    assert tfs.fused_symmetriser.bwd_launches == before + 1
    y_p, g_p = _grads(lambda a, *q: tfs.reference_symmetriser(
        a, split(q), perms), [x, *flat], dy)
    torch.testing.assert_close(y_k, y_p, **TOL)
    _assert_grads(g_k, g_p, ['x'] + [f'layer{i}.{k}' for i in range(n_layers)
                                     for k in ('g', 'b', 'w1', 'c1', 'w2',
                                               'c2')])


def test_backward_kernels_are_deterministic(cuda):
    """No atomics: two runs of each backward give the same bits."""
    (feat, nbr, hn, mask), p = _gnn_case(cuda, 700, 128, 8)
    dy = torch.randn_like(feat)
    fn = lambda a, b, c, *q: tfg.fused_gnn_block(a, b, c, mask, q, 8, 0.3,
                                                 True, 5)
    runs = [_grads(fn, [feat, nbr, hn, *p], dy)[1] for _ in range(2)]
    x, pb = _block_case(cuda, 4, 900, 128, 128)
    dyb = torch.randn_like(x)
    fb = lambda a, *q: tfb.fused_transformer_block(a, q, 4, 0.5, True, 6)
    runs_b = [_grads(fb, [x, *pb], dyb)[1] for _ in range(2)]
    xs, layers = _sym_case(cuda, 4, 900, 128, 64, 12, 3)
    flat = [q for layer in layers for q in layer]
    dys = torch.randn((900, 12), device=cuda)
    fs = lambda a, *q: tfs.fused_symmetriser(
        a, [q[6 * i:6 * i + 6] for i in range(3)], PERMUTATIONS['n4'])
    runs_s = [_grads(fs, [xs, *flat], dys)[1] for _ in range(2)]
    for a, b in (runs, runs_b, runs_s):
        for ga, gb in zip(a, b):
            assert torch.equal(ga, gb)


# ---------------------------------------------------------------- masks
@pytest.mark.parametrize('op,shape,rate', [
    (tfg, (1376, 512), 0.3), (tfb, (4, 2152, 512), 0.5), (tfg, (3, 5), 0.1)])
def test_mask_dump_is_bit_equal_to_plain_philox(cuda, op, shape, rate):
    before = op.dropout_masks.launches
    m1, m2 = op.dropout_masks(77, shape, rate, device=cuda)
    torch.cuda.synchronize()
    assert op.dropout_masks.launches == before + 1
    for stream, m in ((0, m1), (1, m2)):
        want = philox.dropout_mask(77, stream, shape, rate, device=cuda)
        assert torch.equal(m, want)
    keep = float((m1 > 0).float().mean())
    n = m1.numel()
    assert abs(keep - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n) + 1e-9


def test_dropout_forward_uses_the_dumped_masks(cuda):
    """The kernels' forward with dropout equals the plain version fed the
    dumped masks by hand."""
    (feat, nbr, hn, mask), p = _gnn_case(cuda, 300, 64, 5)
    m = tfg.dropout_masks(3, feat.shape, 0.3, device=cuda)
    y = tfg.fused_gnn_block(feat, nbr, hn, mask, p, 4, 0.3, True, 3)
    torch.testing.assert_close(
        y, tfg.reference_gnn_block(feat, nbr, hn, mask, p, 4, m), **TOL)
    x, pb = _block_case(cuda, 3, 200, 64, 64)
    mb = tfb.dropout_masks(4, x.shape, 0.5, device=cuda)
    yb = tfb.fused_transformer_block(x, pb, 4, 0.5, True, 4)
    torch.testing.assert_close(yb, tfb.reference_block(x, pb, 4, mb), **TOL)
