"""Build and load the CUDA kernel library (plain C interface, ``ctypes``).

The sources under ``repro_torch/csrc/`` are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <sources>

into ``build/repro_torch/`` at the root of the checkout, keyed by a hash
of the sources, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is.  The compiler's output (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept beside the library as
``<name>-<hash>.log``.  :func:`build_all` compiles several libraries at
once, one ``nvcc`` process each.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
#: ``<checkout>/build/repro_torch`` (``src/repro_torch/kernels`` is three
#: levels below the checkout root).
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: name -> seconds this process's build of that library took (0.0: it
#: was built already)
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(sources: Sequence[pathlib.Path]) -> str:
    """A hash of the flags, the sources and every shared header
    (``csrc/*.cuh``, which a source may include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, sources: Sequence[str]) -> pathlib.Path:
    paths = [CSRC / s for s in sources]
    return BUILD_DIR / f"{name}-{_digest(paths)}.so"


def build(name: str, sources: Sequence[str]) -> pathlib.Path:
    """Compile ``sources`` (names under ``csrc/``) into one shared library
    unless the hash-keyed library already exists; returns its path."""
    out = library_path(name, sources)
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in sources]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return out


def build_all(libs: Sequence[Tuple[str, Sequence[str]]]
              ) -> Dict[str, pathlib.Path]:
    """Build every ``(name, sources)`` library at once: one ``nvcc`` per
    library, all started together; raises if any build fails."""
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        futures = {name: pool.submit(build, name, srcs)
                   for name, srcs in libs}
    return {name: f.result() for name, f in futures.items()}


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build if needed and ``dlopen`` the library (once per process)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _LIBS[name] = lib
        return lib


def build_log(name: str, sources: Sequence[str]) -> Optional[str]:
    """The compiler output kept beside the library, if it was built."""
    log = library_path(name, sources).with_suffix(".log")
    return log.read_text() if log.exists() else None
