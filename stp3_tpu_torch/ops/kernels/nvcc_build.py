"""Build a CUDA source into a shared library with nvcc, or a host C
source with the host's C compiler, and load it with ctypes (plain C
interface; no PyTorch headers, so a build takes seconds).

The library lands in ``build/kernels/`` at the repository root, named by
a hash of the sources, the headers under ``csrc/``, the compiler and the
flags: an edited source or header builds anew, an unchanged one is loaded
from the previous build. A build writes a temporary file and renames it
into place, so processes that build the same library at once are safe.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
CC_FLAGS = ('-O3', '-shared', '-fPIC')

_LOADED: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found on PATH, in $CUDA_HOME/bin or '
                           '/usr/local/cuda/bin')
    return path


def _cc() -> str:
    for name in ('cc', 'gcc'):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError('no host C compiler: neither cc nor gcc is on PATH')


def load_library(name: str, sources: Sequence[str]) -> Tuple[ctypes.CDLL, dict]:
    """Build (if needed) and load the CUDA ``sources`` (file names under
    csrc/) with nvcc.

    Returns (library, info); info holds 'path', 'built' (False when an
    earlier build was reused), 'seconds' and nvcc's '-Xptxas -v' 'log'
    (kept beside the library, so a reused build reports it too).
    """
    return _load(name, sources, _nvcc, NVCC_FLAGS, sorted(CSRC.glob('*.cuh')))


def load_host_library(name: str, sources: Sequence[str]) -> Tuple[ctypes.CDLL, dict]:
    """``load_library`` for host C ``sources`` under csrc/, built with the
    ``cc`` (or ``gcc``) on PATH and ``-O3 -shared -fPIC``."""
    return _load(name, sources, _cc, CC_FLAGS, sorted(CSRC.glob('*.h')))


def _load(name, sources, compiler, flags, headers) -> Tuple[ctypes.CDLL, dict]:
    if name in _LOADED:
        return _LOADED[name]
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256(' '.join(flags).encode())
    for p in paths + headers:                           # the headers they may include
        digest.update(p.read_bytes())
    lib_path = BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'
    log_path = lib_path.with_suffix('.log')
    info = {'path': str(lib_path), 'built': False, 'seconds': 0.0,
            'log': log_path.read_text() if log_path.exists() else ''}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler(), *flags, '-o', tmp, *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info['seconds'] = time.perf_counter() - t0
        info['log'] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f'{cmd[0]} failed ({proc.returncode}):\n'
                               f'{" ".join(cmd)}\n{info["log"]}')
        log_path.write_text(info['log'])
        os.replace(tmp, lib_path)      # atomic: no half-written library
        info['built'] = True
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, info)
    return lib, info
