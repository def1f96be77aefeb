"""The port's CUDA kernels (K1-K3) against their plain PyTorch versions on
the card. Every test here needs a CUDA device: it carries the `cuda` marker
and skips without one.

This file imports neither JAX nor grappa_tpu, so it also runs on a machine
without JAX (`python -m pytest tests/test_torch_port_kernels.py
--noconftest`; the suite's conftest imports JAX). Shapes cover the serving
path's and the edges the kernels mask: ragged rows, head widths below a
warp (dh=9, 16), reductions that are not a multiple of the GEMM's K step,
D < 8 slots, 1-3 symmetriser layers, 6 permutations. Tolerance: elementwise
|kernel - plain| <= 1e-4 + 1e-4 |plain| (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

from grappa_tpu_torch.models.heads import (PERMUTATIONS,
                                           WRONG_SYMMETRY_IMPROPER)
from grappa_tpu_torch.ops import fused_block as tfb
from grappa_tpu_torch.ops import fused_gnn as tfg
from grappa_tpu_torch.ops import fused_symmetriser as tfs

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
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match='training slice'):
        tfb.fused_transformer_block(x, p, 4).sum().backward()


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
