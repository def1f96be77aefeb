"""Build the port's CUDA kernels from `grappa_tpu_torch/csrc/`, load them,
and check what the ops hand them.

At first use every `.cu` file is compiled for `sm_90a` by its own `nvcc`
process (all started together), and the objects are linked into one shared
library with a plain C interface, loaded with ctypes. The library's name
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
from typing import Iterable, Optional

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / 'build'
SOURCES = ('fused_gnn.cu', 'fused_block.cu', 'fused_symmetriser.cu',
           'dropout.cu')
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-Xcompiler', '-fPIC')

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL, _U = ctypes.c_longlong, ctypes.c_uint32
_DROP = [_U, _U, _F, _I]      # seed, keep threshold, keep scale, on
# C entry points: name -> (restype, argtypes); pointers and the stream are
# c_void_p so ctypes never cuts a 64-bit address to an int
_SIGNATURES = {
    'grappa_fused_gnn_scratch': (_LL, [_I, _I, _I]),
    'grappa_fused_gnn_fwd': (_I, [_P] * 12 + _DROP + [_P] * 2 + [_I] * 5
                             + [_F, _P]),
    'grappa_fused_gnn_bwd_scratch': (_LL, [_I, _I, _I]),
    'grappa_fused_gnn_bwd': (_I, [_P] * 13 + _DROP + [_P] * 12 + [_I] * 5
                             + [_F, _P]),
    'grappa_fused_block_scratch': (_LL, [_I, _I, _I, _I]),
    'grappa_fused_block_fwd': (_I, [_P] * 13 + _DROP + [_P] * 2 + [_I] * 5
                               + [_F, _P]),
    'grappa_fused_block_bwd_scratch': (_LL, [_I, _I, _I, _I]),
    'grappa_fused_block_bwd': (_I, [_P] * 14 + _DROP + [_P] * 14
                               + [_I] * 5 + [_F, _P]),
    'grappa_fused_symmetriser_scratch': (_LL, [_I, _I, _I, _P]),
    'grappa_fused_symmetriser_fwd': (
        _I, [_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P]),
    'grappa_fused_symmetriser_bwd_scratch': (_LL, [_I] * 5 + [_P]),
    'grappa_fused_symmetriser_bwd': (
        _I, [_P, _I, _I, _I, _P, _I, _P, _P, _I] + [_P] * 5),
    'grappa_dropout_masks': (_I, [_U, _U, _F, _LL, _P, _P, _P]),
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


def on_cuda(tensors: Iterable[torch.Tensor], name: str) -> bool:
    """True when every tensor is a contiguous float32 tensor on one CUDA
    device (the kernel's input), False when every one lies on the CPU (the
    plain version's); raises on anything else."""
    tensors = list(tensors)
    devices = {t.device.type for t in tensors}
    if devices == {'cpu'}:
        return False
    if devices != {'cuda'} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all tensors must lie on one CUDA device "
                         f"or all on the CPU, got {sorted(devices)}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return True


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def grad_output(dy: torch.Tensor, like: torch.Tensor, name: str
                ) -> torch.Tensor:
    """The incoming gradient as the backward kernel takes it: float32,
    contiguous, on the forward's device and in its output's shape."""
    if dy.device != like.device or dy.dtype != torch.float32:
        raise TypeError(f"{name}: the gradient must be float32 on "
                        f"{like.device}, got {dy.dtype} on {dy.device}")
    return dy.contiguous()


def head_scale(dh: int) -> float:
    """Attention score scale 1/sqrt(dh) rounded once to float32, as the
    JAX kernels' np.float32(1 / np.sqrt(dh))."""
    return float(np.float32(1.0 / np.sqrt(dh)))
