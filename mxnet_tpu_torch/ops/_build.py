"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) at first use into ``ops/_build/`` (listed in
``.gitignore``). The library's file name carries a digest of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: importing the port on a machine without
``nvcc`` or a GPU builds nothing.

The JAX package has no counterpart: its Pallas kernels are traced and
compiled by JAX itself.
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
from typing import Dict, Iterable, Optional

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "nvcc_path",
           "build", "build_log", "load"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -Xptxas -v writes each kernel's registers, shared memory and spills to the
# build log beside the library; it does not change the code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """``{name: path}`` of every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise FileNotFoundError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the port's CUDA kernels are built on a machine with the CUDA "
        "toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(name.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 where the library already existed). Raises
    ``RuntimeError`` with the compiler's output if a build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise KeyError(f"no CUDA source for {unknown} in {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for n, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[n] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, lib)      # atomic: readers never see half a file
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n} (rc {rc}):\n"
                          + lib.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """The compiler's output from building ``name`` (ptxas register and
    spill report included), or '' if it was not built here."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
