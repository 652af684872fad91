"""The host block-sparse tensordot's GEMM tasks, run by a C++ loop.

:func:`~tenpy_tpu_torch.linalg.np_conserved.tensordot` matches charge
blocks by a plan of small GEMM tasks.  Run from Python, each task costs
microseconds of interpreter time, which on block-heavy models (the x-k
Hubbard cylinder's environments, the mixer's split) is the host's wall.
``host_gemm.cpp`` runs the same tasks in the same order, each output
block written by its first task and added to by the others, as the
Python loop does.

BLAS: torch's own (MKL in the PyTorch builds this runs on, statically in
``libtorch_cpu``): the addresses of its exported ``dgemm_``/``zgemm_`` are
handed to the loop, so the loop links nothing, and it runs the same GEMM
code as ``torch.matmul`` on the host.  Threads: MKL's, which torch sets
(``torch.set_num_threads``), as for the Python loop.

Build: ``g++`` compiles the source at first use into
``build/tenpy_tpu_torch/`` at the root of the checkout, under a name keyed
on a hash of the source and the flags; concurrent processes build to their
own temporary names and ``os.replace`` the result.  It is not part of the
``nvcc`` build (:mod:`tenpy_tpu_torch._build`) and needs no card.  A build
or load that fails raises with the compiler's output: there is no
fallback.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from .._build import BUILD_DIR

__all__ = ['SOURCE', 'build', 'library', 'run_tasks']

SOURCE = Path(__file__).resolve().parent / 'host_gemm.cpp'
GXX_FLAGS = ['-O2', '-std=c++17', '-shared', '-fPIC']
_GEMM_NAMES = {torch.float64: 'dgemm_', torch.complex128: 'zgemm_'}


def build():
    """Compile the executor if needed; returns the shared library's path."""
    h = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f'host_gemm_{h.hexdigest()[:16]}.so'
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f'.{os.getpid()}.tmp')
    try:
        res = subprocess.run(['g++', *GXX_FLAGS, '-o', str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the host GEMM executor does not build: {e}") \
            from e
    if res.returncode != 0:
        raise RuntimeError(f"the host GEMM executor does not build: g++ "
                           f"failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def library():
    """``(lib, gemm)``: the loaded executor and the addresses of torch's
    ``dgemm_``/``zgemm_`` by dtype."""
    lib = ctypes.CDLL(str(build()))
    p = ctypes.c_void_p
    lib.host_gemm_run.argtypes = [p, ctypes.c_int64, p, p, p, p, p]
    lib.host_gemm_run.restype = ctypes.c_int64
    torch_cpu = Path(torch.__file__).resolve().parent / 'lib' / \
        'libtorch_cpu.so'
    blas = ctypes.CDLL(str(torch_cpu))
    gemm = {}
    for dtype, name in _GEMM_NAMES.items():
        try:
            gemm[dtype] = ctypes.cast(getattr(blas, name), p).value
        except AttributeError:
            raise RuntimeError(f"{torch_cpu} exports no {name}: the host "
                               f"GEMM executor needs torch's BLAS") from None
    return lib, gemm


def run_tasks(dtype, a_ptrs, b_ptrs, c_ptrs, dims, first):
    """Run GEMM tasks: int64 arrays of the operands' and outputs' addresses
    (row-major, contiguous, of ``dtype``: float64 or complex128), int32
    ``dims`` (n, 3) of ``(m, k, n)`` and uint8 ``first`` (1: write, 0:
    add).  The caller keeps every buffer alive and sized."""
    lib, gemm = library()
    arrays = [np.ascontiguousarray(a_ptrs, np.int64),
              np.ascontiguousarray(b_ptrs, np.int64),
              np.ascontiguousarray(c_ptrs, np.int64),
              np.ascontiguousarray(dims, np.int32),
              np.ascontiguousarray(first, np.uint8)]
    n = len(arrays[0])
    if not all(len(x) == n for x in arrays) or arrays[3].shape != (n, 3):
        raise ValueError("task arrays of different lengths")
    rc = lib.host_gemm_run(gemm[dtype], n, *(x.ctypes.data for x in arrays))
    if rc != 0:
        raise ValueError(f"host GEMM task {rc - 1} has a negative dimension")
