"""K3 / K3b: the Symmetriser on x (S, T, F) -> (T, out), forward and
backward.

Counterpart of `grappa_tpu/ops/fused_symmetriser.py::fused_symmetriser`
(forward and custom_vjp backward): a shared FeedForward stack applied to
every symmetry-permuted flattening of each tuple's (S, F) features, summed
over the permutations. No dropout. The JAX op has no plain reference
function; its counterpart is the flax `Symmetriser` module, and here
`reference_symmetriser`.

On CUDA tensors `fused_symmetriser` launches the hand-written kernels in
`csrc/fused_symmetriser.cu`, both running their products on the tensor
cores (`csrc/tc_gemm.cuh` in float32, `csrc/wg_gemm.cuh` in bf16 mode):
the forward, whose scratch (each layer's normalised input -- for the first
layer the permuted rows of x, normalised -- activation and input, the
first layer's row statistics; in bf16 mode also the bf16 copies the
products read and the weights in bf16, the first layer's normalised rows
in bf16 alone) is allocated on every call, `torch.inference_mode()`
included, since its own products read it, and is kept by autograd; and in
the backward a kernel chain that reads it and returns dx and every
parameter gradient summed over the permutations (the source notes give
the card's bound and the design). On CPU tensors it runs
`reference_symmetriser`, and autograd differentiates it.
`fused_symmetriser.launches` and `fused_symmetriser.bwd_launches` count
kernel launches, `fused_symmetriser.bf16_launches` and
`fused_symmetriser.bf16_bwd_launches` the forward's and the backward's in
bf16 mode.

`mm_dtype=torch.bfloat16` is the JAX op's bf16 mode: every layer's two
products round both operands to bf16 and sum in float32; LayerNorms, elu,
the skips and the sum over permutations stay float32. The backward's
four products a layer round both operands too, the incoming gradient's
descendants included (the JAX op's _dot_tn / _dot_nt). On the card both
are the kernels' bf16 mode; on the CPU autograd differentiates the plain
version through `_cuda.mm_linear`, whose bf16 product rounds its
backward's operands alike.

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
MAX_LAYERS = 16        # the kernels' layer table


def reference_symmetriser(x, layers: Sequence[Sequence[torch.Tensor]],
                          permutations: Sequence[Tuple[int, ...]],
                          mm_dtype=None) -> torch.Tensor:
    """Plain PyTorch version on x (S, T, F) -> (T, out). A layer whose norm
    parameters are None has no LayerNorm (the model's layer_norm=False).
    `mm_dtype`: None or torch.bfloat16 (the products' operands rounded to
    bf16)."""
    bf16 = _cuda.mm_bf16(mm_dtype)
    s, t, f = x.shape
    n_layers = len(layers)
    out = None
    for perm in permutations:
        h = x[list(perm)].permute(1, 0, 2).reshape(t, s * f)
        for i, (g, b, w1, c1, w2, c2) in enumerate(layers):
            hn = (h if g is None
                  else F.layer_norm(h, (h.shape[-1],), g, b, LN_EPS))
            o = _cuda.mm_linear(F.elu(_cuda.mm_linear(hn, w1, c1, bf16)),
                                w2, c2, bf16)
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
    def forward(ctx, x, permutations, n_layers, bf16, *flat):
        s, t, f = x.shape
        layers = [flat[6 * i:6 * i + 6] for i in range(n_layers)]
        dims = _layer_dims(layers)
        perms = (ctypes.c_int * (len(permutations) * s))(
            *[j for p in permutations for j in p])
        lib = _cuda.lib()
        scratch = torch.empty(
            lib.grappa_fused_symmetriser_scratch(len(permutations), t,
                                                 n_layers, dims, int(bf16)),
            dtype=torch.float32, device=x.device)
        y = torch.empty((t, layers[-1][4].shape[0]), dtype=torch.float32,
                        device=x.device)
        rc = lib.grappa_fused_symmetriser_fwd(
            x.data_ptr(), s, t, f, perms, len(permutations), _pointers(flat),
            dims, n_layers, scratch.data_ptr(), y.data_ptr(), int(bf16),
            _cuda.stream_of(x))
        _cuda.check(rc, 'grappa_fused_symmetriser_fwd')
        if bf16:
            fused_symmetriser.bf16_launches += 1
        else:
            fused_symmetriser.launches += 1
        # the scratch holds the forward's intermediates, which the backward
        # reads
        ctx.save_for_backward(x, scratch, *flat)
        ctx.permutations, ctx.n_layers, ctx.bf16 = (permutations, n_layers,
                                                    bf16)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, saved, *flat = ctx.saved_tensors
        dy = _cuda.grad_output(dy, x, 'fused_symmetriser')
        s, t, f = x.shape
        n_layers, permutations = ctx.n_layers, ctx.permutations
        dims = _layer_dims([flat[6 * i:6 * i + 6] for i in range(n_layers)])
        perms = (ctypes.c_int * (len(permutations) * s))(
            *[j for p in permutations for j in p])
        lib = _cuda.lib()
        scratch = torch.empty(
            lib.grappa_fused_symmetriser_bwd_scratch(
                len(permutations), t, n_layers, dims, int(ctx.bf16)),
            dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        grads = [torch.empty_like(p) for p in flat]
        rc = lib.grappa_fused_symmetriser_bwd(
            x.data_ptr(), s, t, f, perms, len(permutations), _pointers(flat),
            dims, n_layers, dy.data_ptr(), saved.data_ptr(),
            scratch.data_ptr(), dx.data_ptr(), _pointers(grads),
            int(ctx.bf16), _cuda.stream_of(x))
        _cuda.check(rc, 'grappa_fused_symmetriser_bwd')
        if ctx.bf16:
            fused_symmetriser.bf16_bwd_launches += 1
        else:
            fused_symmetriser.bwd_launches += 1
        return (dx, None, None, None, *grads)


def fused_symmetriser(x, layers: Sequence[Sequence[torch.Tensor]],
                      permutations: Sequence[Tuple[int, ...]],
                      mm_dtype=None) -> torch.Tensor:
    """Symmetriser on x (S, T, F) -> (T, out_feats) (see module doc).
    mm_dtype: None (float32) or torch.bfloat16 (the bf16 mode)."""
    layers = [tuple(layer) for layer in layers]
    permutations = tuple(tuple(int(j) for j in p) for p in permutations)
    _check(x, layers, permutations)
    bf16 = _cuda.mm_bf16(mm_dtype)
    flat = [p for layer in layers for p in layer]
    if not _cuda.on_cuda((x, *flat), 'fused_symmetriser'):
        return reference_symmetriser(x, layers, permutations, mm_dtype)
    if (x.shape[0] > MAX_ARITY or len(permutations) > MAX_PERMUTATIONS
            or len(layers) > MAX_LAYERS):
        raise ValueError(
            f"the kernel takes up to {MAX_ARITY} slots, {MAX_PERMUTATIONS} "
            f"permutations and {MAX_LAYERS} layers, got S={x.shape[0]}, "
            f"{len(permutations)} and {len(layers)}")
    return _SymmetriserKernel.apply(x, permutations, len(layers), bf16,
                                    *flat)


fused_symmetriser.launches = 0
fused_symmetriser.bf16_launches = 0
fused_symmetriser.bwd_launches = 0
fused_symmetriser.bf16_bwd_launches = 0
