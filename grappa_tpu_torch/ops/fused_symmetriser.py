"""K3 / K3b: the Symmetriser on x (S, T, F) -> (T, out), forward and
backward.

Counterpart of `grappa_tpu/ops/fused_symmetriser.py::fused_symmetriser`
(forward and custom_vjp backward): a shared FeedForward stack applied to
every symmetry-permuted flattening of each tuple's (S, F) features, summed
over the permutations. No dropout. The JAX op has no plain reference
function; its counterpart is the flax `Symmetriser` module, and here
`reference_symmetriser`.

On CUDA tensors `fused_symmetriser` launches the hand-written kernels in
`csrc/fused_symmetriser.cu`: the forward, and in the backward a kernel
chain that recomputes each permutation's chain and returns dx and every
parameter gradient summed over the permutations (the source notes give the
card's bound and the design). On CPU tensors it runs
`reference_symmetriser`, and autograd differentiates it.
`fused_symmetriser.launches` and `fused_symmetriser.bwd_launches` count
kernel launches.

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
from torch.autograd.function import once_differentiable

from grappa_tpu_torch.models.layers import LN_EPS
from grappa_tpu_torch.ops import _cuda

MAX_PERMUTATIONS = 6   # the kernel's permutation table
MAX_ARITY = 4
MAX_LAYERS = 16        # the backward kernel's layer table


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


def _layer_dims(layers):
    """ctypes (in, hid, out) per layer."""
    return (ctypes.c_int * (3 * len(layers)))(*[
        d for (_, _, w1, _, w2, _) in layers
        for d in (w1.shape[1], w1.shape[0], w2.shape[0])])


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


class _SymmetriserKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, permutations, n_layers, *flat):
        s, t, f = x.shape
        layers = [flat[6 * i:6 * i + 6] for i in range(n_layers)]
        dims = _layer_dims(layers)
        perms = (ctypes.c_int * (len(permutations) * s))(
            *[j for p in permutations for j in p])
        lib = _cuda.lib()
        scratch = torch.empty(
            lib.grappa_fused_symmetriser_scratch(len(permutations), t,
                                                 n_layers, dims),
            dtype=torch.float32, device=x.device)
        y = torch.empty((t, layers[-1][4].shape[0]), dtype=torch.float32,
                        device=x.device)
        rc = lib.grappa_fused_symmetriser_fwd(
            x.data_ptr(), s, t, f, perms, len(permutations), _pointers(flat),
            dims, n_layers, scratch.data_ptr(), y.data_ptr(),
            _cuda.stream_of(x))
        _cuda.check(rc, 'grappa_fused_symmetriser_fwd')
        fused_symmetriser.launches += 1
        ctx.save_for_backward(x, *flat)
        ctx.permutations, ctx.n_layers = permutations, n_layers
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, *flat = ctx.saved_tensors
        dy = _cuda.grad_output(dy, x, 'fused_symmetriser')
        s, t, f = x.shape
        n_layers, permutations = ctx.n_layers, ctx.permutations
        dims = _layer_dims([flat[6 * i:6 * i + 6] for i in range(n_layers)])
        perms = (ctypes.c_int * (len(permutations) * s))(
            *[j for p in permutations for j in p])
        lib = _cuda.lib()
        scratch = torch.empty(
            lib.grappa_fused_symmetriser_bwd_scratch(
                s, f, len(permutations), t, n_layers, dims),
            dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        grads = [torch.empty_like(p) for p in flat]
        rc = lib.grappa_fused_symmetriser_bwd(
            x.data_ptr(), s, t, f, perms, len(permutations), _pointers(flat),
            dims, n_layers, dy.data_ptr(), scratch.data_ptr(), dx.data_ptr(),
            _pointers(grads), _cuda.stream_of(x))
        _cuda.check(rc, 'grappa_fused_symmetriser_bwd')
        fused_symmetriser.bwd_launches += 1
        return (dx, None, None, *grads)


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
    if (x.shape[0] > MAX_ARITY or len(permutations) > MAX_PERMUTATIONS
            or len(layers) > MAX_LAYERS):
        raise ValueError(
            f"the kernel takes up to {MAX_ARITY} slots, {MAX_PERMUTATIONS} "
            f"permutations and {MAX_LAYERS} layers, got S={x.shape[0]}, "
            f"{len(permutations)} and {len(layers)}")
    return _SymmetriserKernel.apply(x, permutations, len(layers), *flat)


fused_symmetriser.launches = 0
fused_symmetriser.bwd_launches = 0
