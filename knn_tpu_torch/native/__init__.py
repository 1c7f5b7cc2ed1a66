"""Native (C++) components of the port: the ARFF parser (``arff/arff_c.cc``)
and the serial/threaded runtime kernel (``runtime/knn_runtime.cc``), the
port's own copies of the JAX package's sources, bound with :mod:`ctypes`.

Each source builds at first use with the ambient C++ compiler (``$CXX``,
else ``g++``, else ``c++``) into ``build/knn_tpu_torch/native/`` at the
repository root, as ``lib<name>-<hash>.so``, the hash covering the source
and the flags, so an edited source rebuilds. Concurrent processes (pytest
workers) build one at a time under a file lock, each into a per-process
temporary file renamed into place, so none loads half a file.

A missing compiler means the native components are unavailable: an
``OSError``, which the backend registry and the ARFF loader treat as such.
A compile that fails raises :class:`NativeBuildError`, which nothing
swallows.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUILD_DIR = ROOT.parent.parent / "build" / "knn_tpu_torch" / "native"

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

#: library name -> (source, link flags)
SOURCES = {
    "knn_arff": (ROOT / "arff" / "arff_c.cc", ("-lpthread",)),
    "knn_runtime": (ROOT / "runtime" / "knn_runtime.cc", ("-lpthread",)),
}


class NativeBuildError(RuntimeError):
    """The C++ source exists and a compiler was found, but compilation failed.

    Deliberately NOT an OSError: the backend registry treats OSError as
    "native backends unavailable", which is right for a missing compiler
    but would hide a broken build.
    """


def compiler() -> "str | None":
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def library_path(name: str) -> Path:
    """Where library ``name`` builds to, named by a hash of its source and
    the compiler flags."""
    src, link = SOURCES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + link).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """The path of library ``name``, compiled first if it is not built.
    Raises ``OSError`` when no C++ compiler is found and
    :class:`NativeBuildError` when the compile fails."""
    out = library_path(name)
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise OSError(f"no C++ compiler ($CXX, g++, c++): the native {name} "
                      "library is unavailable")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        src, link = SOURCES[name]
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(src), *link]
        t0 = time.monotonic()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"building {out.name} failed:\n$ {' '.join(cmd)}\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    from knn_tpu_torch.obs import devprof

    devprof.record_build("cxx", name, (time.monotonic() - t0) * 1e3)
    return out


_lock = threading.Lock()
_loaded: "dict[str, ctypes.CDLL]" = {}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed. ``signatures``
    maps each C entry to ``(argtypes, restype)``; they are declared once,
    when the library is first loaded."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for entry, (argtypes, restype) in signatures.items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes, restype
            _loaded[name] = lib
    return lib
