"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so <name>.cu

Libraries go to ``build/repro_torch_kernels/`` at the root of the checkout,
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads at once.  Nothing is built when a module is
imported: the first launch of a kernel builds it (``library``), and
``build_all`` builds every source in parallel, one ``nvcc`` each.

This module is also the one boundary between Python and the kernels' C
entry points.  ``entry`` binds an entry once (its ``argtypes``, an ``int``
``cudaError_t`` return); ``launch`` calls it under the tensors' device on
that device's current stream (the entry's last argument), raises on a
nonzero return and, on success, adds one to ``LAUNCHES[count]``.
``LAUNCHES`` is the one host-side launch counter: a kernel's wrapper names
the key it counts under, and ``launch.compile.CompiledStep`` reads the
counter at capture and adds the captured launches back on every replay.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
#: Compiler output (ptxas register/shared-memory report) per built source.
BUILD_LOGS: dict[str, str] = {}
#: Kernel calls by key (the wrapper's ``count``) since import, or since a
#: caller last cleared or set them.
LAUNCHES: collections.Counter[str] = collections.Counter()


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(name: str, nvcc: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile every source that has no up-to-date library, all at once."""
    todo = [n for n in names if not library_path(n).is_file()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        started = {n: _start(n, nvcc) for n in todo}
        failed = []
        for n, (proc, tmp, out) in started.items():
            log, _ = proc.communicate()
            BUILD_LOGS[n] = log
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)   # atomic: a reader never sees half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: library_path(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        path = build_all((name,))[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]


@functools.cache
def entry(name: str, symbol: str, argtypes: tuple = ()):
    """``symbol`` of ``csrc/<name>.cu``'s library, bound once: its
    ``argtypes`` and an ``int`` return."""
    fn = getattr(library(name), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def launch(name: str, symbol: str, argtypes: tuple, device: torch.device,
           *args, count: str | None) -> None:
    """Call the kernel entry ``symbol`` of ``csrc/<name>.cu`` with ``args``
    and ``device``'s current stream; ``argtypes`` end with the stream's.

    A nonzero return raises; a zero one adds one to ``LAUNCHES[count]``
    (None counts nothing).
    """
    fn = entry(name, symbol, argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel {symbol} failed: cudaError {rc}")
    if count is not None:
        LAUNCHES[count] += 1
