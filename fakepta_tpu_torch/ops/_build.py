"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own (``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC -Xptxas -v
-split-compile=0``, the last compiling a source's kernels on every core)
into ``<name>-<hash>.so`` under ``fakepta_tpu_torch/build/kernels/``, beside
the sources it is built from (``FAKEPTA_TORCH_BUILD_DIR`` names another
directory, for an installation that cannot write there). Each library has a
plain C interface (no PyTorch headers, so a build takes seconds). The hash
covers the source, every shared ``csrc/*.cuh`` header and the flags, so a
stale library is never loaded. No ``--use_fast_math``: the megakernel's
Fourier bases need accurate ``sincosf``. Several kernels build in parallel,
one ``nvcc`` process each; ptxas' register and spill report comes back with
every build.
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

from ..obs import metrics

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = Path(os.environ.get("FAKEPTA_TORCH_BUILD_DIR")
                 or PACKAGE / "build" / "kernels")
KERNELS = ("binned_corr", "megakernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: nvcc processes this process has started (a replica that finds every
#: library already built starts none)
nvcc_starts = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin); the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def start_nvcc(src: Path, dst: Path) -> subprocess.Popen:
    """Start one nvcc process compiling ``src`` (headers from ``csrc/``)
    into the library ``dst``; its output is the compiler's log."""
    global nvcc_starts
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(dst),
           str(src)]
    nvcc_starts += 1
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every missing library in ``names`` (default: all kernels),
    one nvcc process per source, all started together.

    Returns ``{name: compiler output}`` (ptxas' register and spill report)
    for the sources it compiled. Raises with the compiler's output if any
    build fails. The seconds spent go to the active metrics collector as
    ``kernels.build_s`` (a run's report reads them as its ``compile_s``).
    """
    t0 = time.perf_counter()
    names = tuple(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        dst = library_path(name)
        if dst.exists():
            continue
        tmp = dst.with_name(f"{dst.name}.{os.getpid()}.tmp")
        procs[name] = (start_nvcc(CSRC / f"{name}.cu", tmp), tmp, dst)
    logs, failed = {}, []
    for name, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, dst)
    if procs:
        metrics.observe("kernels.build_s", time.perf_counter() - t0)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.fpt_error_string.restype = ctypes.c_char_p
            lib.fpt_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib.fpt_error_string(int(rc)).decode(errors="replace")
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc} "
                           f"({msg})")
