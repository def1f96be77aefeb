"""Build the port's CUDA kernels from `grappa_tpu_torch/csrc/`, load them,
and check what the ops hand them.

At first use every `.cu` file is compiled for `sm_90a` by its own `nvcc`
process (all started together), and the objects are linked into one shared
library with a plain C interface, loaded with ctypes. `fused_gnn_rows.cu`
and `fused_block_rows.cu` build K1's and K2's files a second time with the
sharded Drop (`csrc/common.cuh`): their `_rows` entry points draw a rank's
rows of the unsharded dropout masks on an atom-sharded batch, so the entry
points every other path calls keep their code. The library's name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. The build directory `grappa_tpu_torch/build/` is
listed in `.gitignore`. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / 'build'
SOURCES = ('fused_gnn.cu', 'fused_block.cu', 'fused_symmetriser.cu',
           'dropout.cu', 'torsion.cu', 'fused_gnn_rows.cu',
           'fused_block_rows.cu')
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-Xcompiler', '-fPIC')

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL, _U = ctypes.c_longlong, ctypes.c_uint32
_DROP = [_U, _U, _F, _I]      # seed, keep threshold, keep scale, on
# the `_rows` entry points': then the sharded axis's global rows, first row
_DROP_ROWS = _DROP + [_LL, _LL]
# C entry points: name -> (restype, argtypes); pointers and the stream are
# c_void_p so ctypes never cuts a 64-bit address to an int
_SIGNATURES = {
    'grappa_fused_gnn_scratch': (_LL, [_I] * 4),
    'grappa_fused_gnn_fwd': (_I, [_P] * 12 + _DROP + [_P] * 2 + [_I] * 5
                             + [_F, _I, _P]),
    'grappa_fused_gnn_bwd_scratch': (_LL, [_I] * 4),
    'grappa_fused_gnn_bwd': (_I, [_P] * 8 + _DROP + [_P] * 13 + [_I] * 5
                             + [_F, _I, _P]),
    'grappa_fused_block_scratch': (_LL, [_I] * 5),
    'grappa_fused_block_fwd': (_I, [_P] * 13 + _DROP + [_P] * 2 + [_I] * 5
                               + [_F, _I, _P]),
    'grappa_fused_block_bwd_scratch': (_LL, [_I] * 5),
    'grappa_fused_block_bwd': (_I, [_P] * 14 + _DROP + [_P] * 15
                               + [_I] * 5 + [_F, _I, _P]),
    'grappa_fused_symmetriser_scratch': (_LL, [_I, _I, _I, _P, _I]),
    'grappa_fused_symmetriser_fwd': (
        _I, [_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P]),
    'grappa_fused_symmetriser_bwd_scratch': (_LL, [_I, _I, _I, _P, _I]),
    'grappa_fused_symmetriser_bwd': (
        _I, [_P, _I, _I, _I, _P, _I, _P, _P, _I] + [_P] * 5 + [_I, _P]),
    'grappa_fused_gnn_fwd_rows': (_I, [_P] * 12 + _DROP_ROWS + [_P] * 2
                                  + [_I] * 5 + [_F, _I, _P]),
    'grappa_fused_gnn_bwd_rows': (_I, [_P] * 8 + _DROP_ROWS + [_P] * 13
                                  + [_I] * 5 + [_F, _I, _P]),
    'grappa_fused_block_fwd_rows': (_I, [_P] * 13 + _DROP_ROWS + [_P] * 2
                                    + [_I] * 5 + [_F, _I, _P]),
    'grappa_fused_block_bwd_rows': (_I, [_P] * 14 + _DROP_ROWS + [_P] * 15
                                    + [_I] * 5 + [_F, _I, _P]),
    'grappa_dropout_masks': (_I, [_U, _U, _F, _LL, _P, _P, _P]),
    'grappa_dropout_masks_rows': (_I, [_U, _U, _F, _LL, _I, _LL, _LL, _LL,
                                       _P, _P, _P]),
    'grappa_torsion_energy': (_I, [_P, _P, _P, _I, _I, _I, _P]),
    'grappa_torsion_grad': (_I, [_P] * 5 + [_I] * 3 + [_P]),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME', '') + '/bin/nvcc',
                 '/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or ''):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(' '.join(FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in ('.cu', '.cuh'):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile and link the kernels (if this source hash is not built yet);
    returns the library path. verbose=True adds `-Xptxas -v` and returns
    nvcc's output on stderr of the build (registers, spills, smem)."""
    so = BUILD_DIR / f'libgrappa_kernels_{_digest()}.so'
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = list(FLAGS) + (['-Xptxas', '-v'] if verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace('.cu', '.o'))
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *flags, '-c', str(CSRC / src), '-o', obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            if verbose and out:
                print(out, flush=True)
            if proc.returncode:
                failed.append(f'{src}:\n{out}')
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
        tmp_so = os.path.join(tmp, 'lib.so')
        link = subprocess.run([nvcc, *FLAGS, '-shared', '-o', tmp_so, *objs],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError('nvcc link failed:\n' + link.stdout
                               + link.stderr)
        os.replace(tmp_so, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA error {rc} at launch')


def on_cuda(tensors: Sequence[torch.Tensor], name: str) -> bool:
    """True when every tensor is a contiguous float32 tensor on one CUDA
    device (the kernel's input), False when every one lies on the CPU (the
    plain version's); raises on anything else. Reads each tensor's flags
    directly: wrappers call it on every launch."""
    first = tensors[0]
    if not first.is_cuda:
        if all(t.device.type == 'cpu' for t in tensors):
            return False
        _mixed(tensors, name)
    index = first.get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            _mixed(tensors, name)
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return True


def _mixed(tensors: Sequence[torch.Tensor], name: str) -> None:
    raise ValueError(f"{name}: all tensors must lie on one CUDA device or "
                     f"all on the CPU, got "
                     f"{sorted({str(t.device) for t in tensors})}")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on t's device (read as a raw
    handle, without building a torch.cuda.Stream object).

    `torch._C._cuda_getCurrentRawStream` is private (checked on torch
    2.11); tests/test_torch_port_kernels.py holds it against
    `torch.cuda.current_stream().cuda_stream`, so a rename fails there."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def grad_output(dy: torch.Tensor, like: torch.Tensor, name: str
                ) -> torch.Tensor:
    """The incoming gradient as the backward kernel takes it: float32,
    contiguous, on the forward's device and in its output's shape."""
    if dy.device != like.device or dy.dtype != torch.float32:
        raise TypeError(f"{name}: the gradient must be float32 on "
                        f"{like.device}, got {dy.dtype} on {dy.device}")
    return dy.contiguous()


def mm_bf16(mm_dtype) -> bool:
    """The kernels' product mode for `mm_dtype`: True for torch.bfloat16
    (each product's operands rounded to bf16, the products summed in
    float32, as the JAX kernels' mm_dtype=jnp.bfloat16), False for None or
    torch.float32; raises on anything else."""
    if mm_dtype in (None, torch.float32):
        return False
    if mm_dtype == torch.bfloat16:
        return True
    raise ValueError(f"mm_dtype must be None, torch.float32 or "
                     f"torch.bfloat16, got {mm_dtype!r}")


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest even), kept in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class _Bf16Linear(torch.autograd.Function):
    """x w^T + b with x and w rounded to bf16 and float32 sums. Its backward
    rounds the incoming gradient as well as the other operand of each
    product, as the JAX kernels' backward does (_dot_nt / _dot_tn with
    mm_dtype=bfloat16): dx = r(dy) r(w), dw = r(dy)^T r(x), db = sum dy,
    all summed in float32. Differentiating the forward's casts instead
    (a straight-through round) would leave dy unrounded."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = _round_bf16(x), _round_bf16(w)
        ctx.save_for_backward(xr, wr)
        ctx.has_bias = b is not None
        return F.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, dy):
        xr, wr = ctx.saved_tensors
        dyr = _round_bf16(dy)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = dyr @ wr
        if ctx.needs_input_grad[1]:
            dw = dyr.reshape(-1, wr.shape[0]).t() @ xr.reshape(-1,
                                                               wr.shape[1])
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.reshape(-1, wr.shape[0]).sum(0)
        return dx, dw, db


def mm_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              bf16: bool) -> torch.Tensor:
    """A plain version's product x w^T + b; with bf16, x and w are rounded
    to bf16 (nearest even) and the product is summed in float32, the bias
    added in float32 (the JAX kernels' _dot with mm_dtype=bfloat16), and
    its gradients round their operands alike (`_Bf16Linear`)."""
    if bf16:
        return _Bf16Linear.apply(x, w, b)
    return F.linear(x, w, b)


def head_scale(dh: int) -> float:
    """Attention score scale 1/sqrt(dh) rounded once to float32, as the
    JAX kernels' np.float32(1 / np.sqrt(dh))."""
    return float(np.float32(1.0 / np.sqrt(dh)))
