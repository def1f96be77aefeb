"""K3: the Symmetriser on x (S, T, F) -> (T, out).

Counterpart of `grappa_tpu/ops/fused_symmetriser.py::fused_symmetriser`
(forward): a shared FeedForward stack applied to every symmetry-permuted
flattening of each tuple's (S, F) features, summed over the permutations.
The JAX op has no plain reference function; its counterpart is the flax
`Symmetriser` module, and here `reference_symmetriser`.

On a CUDA tensor `fused_symmetriser` launches the hand-written kernel in
`csrc/fused_symmetriser.cu` (its note gives the card's bound and the
design); on a CPU tensor it runs `reference_symmetriser`.
`fused_symmetriser.launches` counts kernel launches.

`layers` holds one tuple per FeedForward layer, in torch layout:
    (norm1.weight, norm1.bias, linear1.weight, linear1.bias,
     linear2.weight, linear2.bias)
The first and last layers have no skip; the middle ones add their
normalised input, as `models.heads.Symmetriser`.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from grappa_tpu_torch.models.layers import LN_EPS
from grappa_tpu_torch.ops import _cuda

MAX_PERMUTATIONS = 6   # the kernel's permutation table
MAX_ARITY = 4


def reference_symmetriser(x, layers: Sequence[Sequence[torch.Tensor]],
                          permutations: Sequence[Tuple[int, ...]]
                          ) -> torch.Tensor:
    """Plain PyTorch version on x (S, T, F) -> (T, out). A layer whose norm
    parameters are None has no LayerNorm (the model's layer_norm=False)."""
    s, t, f = x.shape
    n_layers = len(layers)
    out = None
    for perm in permutations:
        h = x[list(perm)].permute(1, 0, 2).reshape(t, s * f)
        for i, (g, b, w1, c1, w2, c2) in enumerate(layers):
            hn = (h if g is None
                  else F.layer_norm(h, (h.shape[-1],), g, b, LN_EPS))
            o = F.linear(F.elu(F.linear(hn, w1, c1)), w2, c2)
            h = o + hn if 0 < i < n_layers - 1 else o
        out = h if out is None else out + h
    return out


def _check(x, layers, permutations):
    if x.dim() != 3:
        raise ValueError(f"fused_symmetriser takes x (S, T, F), got shape "
                         f"{tuple(x.shape)}")
    s, _, f = x.shape
    if not permutations or any(sorted(p) != list(range(s))
                               for p in permutations):
        raise ValueError(f"permutations must be orderings of range({s}), "
                         f"got {permutations}")
    if not layers:
        raise ValueError("fused_symmetriser needs at least one layer")
    width = s * f
    for i, layer in enumerate(layers):
        if len(layer) != 6:
            raise ValueError(f"layer {i}: expected 6 tensors")
        g, b, w1, c1, w2, c2 = layer
        hid, out = w1.shape[0], w2.shape[0]
        want = [(width,), (width,), (hid, width), (hid,), (out, hid), (out,)]
        got = [tuple(p.shape) for p in layer]
        if got != want:
            raise ValueError(f"layer {i}: shapes {got}, expected {want}")
        if 0 < i < len(layers) - 1 and out != width:
            raise ValueError(f"layer {i} has a skip, so its output width "
                             f"{out} must equal its input width {width}")
        width = out


class _SymmetriserKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, permutations, n_layers, *flat):
        s, t, f = x.shape
        layers = [flat[6 * i:6 * i + 6] for i in range(n_layers)]
        dims = (ctypes.c_int * (3 * n_layers))(*[
            d for (_, _, w1, _, w2, _) in layers
            for d in (w1.shape[1], w1.shape[0], w2.shape[0])])
        perms = (ctypes.c_int * (len(permutations) * s))(
            *[j for p in permutations for j in p])
        ptrs = (ctypes.c_void_p * len(flat))(*[p.data_ptr() for p in flat])
        lib = _cuda.lib()
        scratch = torch.empty(
            lib.grappa_fused_symmetriser_scratch(len(permutations), t,
                                                 n_layers, dims),
            dtype=torch.float32, device=x.device)
        y = torch.empty((t, layers[-1][4].shape[0]), dtype=torch.float32,
                        device=x.device)
        rc = lib.grappa_fused_symmetriser_fwd(
            x.data_ptr(), s, t, f, perms, len(permutations), ptrs, dims,
            n_layers, scratch.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        _cuda.check(rc, 'grappa_fused_symmetriser_fwd')
        fused_symmetriser.launches += 1
        return y

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the fused Symmetriser kernel has no backward yet: it comes with "
            "the training slice of the port (ROADMAP.md, K3b)")


def fused_symmetriser(x, layers: Sequence[Sequence[torch.Tensor]],
                      permutations: Sequence[Tuple[int, ...]]
                      ) -> torch.Tensor:
    """Symmetriser on x (S, T, F) -> (T, out_feats) (see module doc)."""
    layers = [tuple(layer) for layer in layers]
    permutations = tuple(tuple(int(j) for j in p) for p in permutations)
    _check(x, layers, permutations)
    flat = [p for layer in layers for p in layer]
    if not _cuda.on_cuda((x, *flat), 'fused_symmetriser'):
        return reference_symmetriser(x, layers, permutations)
    if x.shape[0] > MAX_ARITY or len(permutations) > MAX_PERMUTATIONS:
        raise ValueError(
            f"the kernel takes up to {MAX_ARITY} slots and "
            f"{MAX_PERMUTATIONS} permutations, got S={x.shape[0]} and "
            f"{len(permutations)}")
    return _SymmetriserKernel.apply(x, permutations, len(layers), *flat)


fused_symmetriser.launches = 0
