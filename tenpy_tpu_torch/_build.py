"""Build and load the port's CUDA kernels (``nvcc`` -> shared library -> ctypes).

The sources in ``csrc/`` have a plain C interface.  At first use each
``.cu`` file there is compiled for Hopper (``sm_90a``) by an ``nvcc`` of
its own, all started together, and the objects are linked into one shared
library in ``build/tenpy_tpu_torch/`` at the root of the checkout.  Its
file name is keyed on a hash of every file under ``csrc/`` (headers
included) and of the flags, so any changed source rebuilds and an
unchanged tree loads at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ['BUILD_DIR', 'CSRC', 'build', 'library']

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'tenpy_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v']


def _nvcc():
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and (Path(cand) / 'bin' / 'nvcc').exists():
            return str(Path(cand) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _source_hash():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob('*') if p.is_file()):
        h.update(str(path.relative_to(CSRC)).encode() + b'\0')
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernel library if needed.

    Returns ``(path, seconds, log)``: the shared library, the build's wall
    time (0 when it was already built) and the compiler's output (register
    and shared-memory use per kernel, from ``-Xptxas -v``)."""
    so = BUILD_DIR / f'tenpy_tpu_torch_{_source_hash()}.so'
    log_path = so.with_suffix('.log')
    if so.exists():
        return so, 0., log_path.read_text() if log_path.exists() else ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f'{os.getpid()}.tmp'
    nvcc = _nvcc()
    t0 = time.time()
    objs, procs = [], []
    for src in sorted(CSRC.glob('*.cu')):
        obj = so.with_name(f'{so.stem}_{src.stem}.{tag}.o')
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate()[0] for p in procs]
    log = ''.join(outs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    tmp = so.with_suffix(f'.{tag}')
    if not failed:
        res = subprocess.run([nvcc, '-shared', '-o', str(tmp),
                              *(str(o) for o in objs)],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        failed = [res.returncode] if res.returncode != 0 else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.time() - t0
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return so, seconds, log


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built at first call), with typed entry
    points ``packed_contract``, ``packed_contract_max_buckets``,
    ``packed_contract_thin_tile``, ``packed_contract_error_string``,
    ``jacobi_svd_sweeps``, ``jacobi_svd_max_threads`` and
    ``jacobi_svd_error_string``."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.packed_contract.argtypes = [i32, i32, ptr, ptr, i32, i32, i32, ptr,
                                    ptr, i32, ptr]
    lib.packed_contract.restype = i32
    for name in ('packed_contract_max_buckets', 'packed_contract_thin_tile'):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.jacobi_svd_sweeps.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, i32,
                                      ptr, ptr]
    lib.jacobi_svd_sweeps.restype = i32
    lib.jacobi_svd_max_threads.argtypes = []
    lib.jacobi_svd_max_threads.restype = i32
    for name in ('packed_contract_error_string', 'jacobi_svd_error_string'):
        getattr(lib, name).argtypes = [i32]
        getattr(lib, name).restype = ctypes.c_char_p
    return lib
