"""Builds the hand-written CUDA kernels and binds them with ctypes.

Every ``csrc/*.cu`` holds one kernel family behind a plain C entry point
that launches on the stream it is given and returns ``cudaGetLastError()``;
``csrc/*.cuh`` holds device helpers that sources include.
Each source is compiled on its own by ``nvcc`` for ``sm_90a`` into a
shared library under ``build/repro_torch_kernels/`` at the repository root
(listed in ``.gitignore``); all sources build in parallel, once per
content hash, at the first launch of any kernel. The libraries are loaded
with ``ctypes``: pointers and the stream go as ``c_void_p``.

No torch headers are compiled, so a build takes seconds. A failed build
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_all", "function", "check"]

CSRC = Path(__file__).resolve().with_name("csrc")
# <repository root>/build/repro_torch_kernels
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
# held around the first build and load of a kernel: threads that reach an
# unbuilt kernel together (the server's consumers) start nvcc once
_load_lock = threading.Lock()


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda)")


def _target(src: Path) -> Path:
    """The library of ``src``, named by a hash of its bytes, of every
    ``csrc/*.cuh`` header (which it may include) and of the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together. Returns
    {kernel source stem: library path}; each library's nvcc output (with
    ptxas's registers, spills and shared memory per kernel) is kept beside
    it as ``.log``. Raises on any failed build."""
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    for s in todo:
        tmp = out[s.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for s, tmp, cmd, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
            continue
        out[s.stem].with_suffix(".log").write_text(log)
        os.replace(tmp, out[s.stem])   # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def function(lib: str, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<lib>.cu``, built and loaded at
    first use (once, under a lock, whichever thread gets there first),
    returning int (a ``cudaError_t``)."""
    key = f"{lib}.{name}"
    fn = _fns.get(key)
    if fn is None:
        with _load_lock:
            fn = _fns.get(key)
            if fn is None:
                if lib not in _libs:
                    paths = build_all()
                    if lib not in paths:
                        raise RuntimeError(f"no CUDA source csrc/{lib}.cu")
                    _libs[lib] = ctypes.CDLL(str(paths[lib]))
                fn = getattr(_libs[lib], name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _fns[key] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
