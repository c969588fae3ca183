"""Build hand-written CUDA sources into shared libraries and load them.

Each ``kernels/csrc/*.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) at first use into ``build/torch_kernels/``
at the root of the checkout, named by a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused.  The library
is loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).

This module lives outside ``kernels/`` on purpose: the repo's lint treats
every ``kernels/*.py`` other than ``__init__``, ``ops`` and ``ref`` as a
kernel module that needs an oracle and a dispatcher entry.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# name -> (restype, argtypes) per exported C function, set once at load
Signatures = Dict[str, Tuple[object, List[object]]]

_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: Path) -> Path:
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Iterable[Path]) -> Dict[Path, Tuple[Path, str]]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together.  Returns ``{source: (library,
    compiler output)}``; raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[Path, Tuple[Path, str]] = {}
    procs = []
    for src in sources:
        src = Path(src)
        lib = library_path(src)
        if lib.exists():
            out[src] = (lib, "")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, lib)         # atomic: readers never see half a file
        out[src] = (lib, log)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def load_library(source: Path, signatures: Signatures) -> ctypes.CDLL:
    """Build (if needed) and load ``source``; declare each exported
    function's ``restype``/``argtypes`` from ``signatures``.  Called on
    every launch, so the cache hit touches no file system."""
    lib = _loaded.get(source)
    if lib is None:
        path, _ = build_all([source])[source]
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _loaded[source] = lib
    return lib
