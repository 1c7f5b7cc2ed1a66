"""Build the port's CUDA sources (``knn_tpu_torch/csrc/*.cu``) at first use.

Each ``csrc/<name>.cu`` becomes ``build/knn_tpu_torch/lib<name>-<hash>.so``
at the repository root: ``nvcc`` with a plain C ABI, loaded with
:mod:`ctypes` (no PyTorch headers, so a build takes seconds). The hash
covers every source and header in ``csrc/`` and the flags, so an edited
source rebuilds. Nothing is downloaded and nothing falls back: a missing
``nvcc`` or a refused source raises :class:`CompileError` with the
compiler's own message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from knn_tpu_torch.resilience.errors import CompileError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "knn_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: "dict[str, ctypes.CDLL]" = {}


def nvcc_path() -> "str | None":
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, named by a hash of every file in
    ``csrc/`` and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> "tuple[Path, Path, subprocess.Popen, float] | None":
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library is built.
    Output goes to a per-process temporary name, renamed into place when
    the compile succeeds, so a concurrent build never loads half a file."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    if nvcc is None:
        raise CompileError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            f"cannot build {CSRC / (name + '.cu')}", transient=False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return out, tmp, proc, t0


def _finish(name: str, started) -> None:
    out, tmp, proc, t0 = started
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise CompileError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{err.strip()}",
                           transient=False)
    os.replace(tmp, out)
    from knn_tpu_torch.obs import devprof

    devprof.record_build("nvcc", name, (time.monotonic() - t0) * 1e3)


def build_all() -> "list[Path]":
    """Build every ``csrc/*.cu`` not built yet, one ``nvcc`` per source,
    all started together. Returns the library paths."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    return [library_path(n) for n in names]


def load_library(name: str, signatures: "dict | None" = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C entry to ``(argtypes, restype)``; they are
    declared once, when the library is first loaded."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(library_path(name)))
            for entry, (argtypes, restype) in (signatures or {}).items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes, restype
            _loaded[name] = lib
    return lib
