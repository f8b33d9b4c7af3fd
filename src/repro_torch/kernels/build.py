"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/kernels/<name>-<digest>.so`` at the repository
root (``build/`` is git-ignored).  The digest covers the sources and the
flags, so an edited kernel is rebuilt at its first use and a stale library
is never loaded.  :func:`build` compiles every missing library with one
``nvcc`` process per source, all started together.  Every library also
exports ``repro_<kernel>_resources``, which :func:`resources` reads: the
registers, shared memory and residency of a kernel at a launch
configuration, for the budget pass of ``analysis/kernel_check.py``.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("stiefel_project", "retract", "ring_mix", "multi_hop_mix",
           "quant_mix", "multi_hop_mix_quant", "flash_attention",
           "flash_attention_bwd", "paged_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; known: {KERNELS}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, in
    parallel.  Returns the seconds each compile took (0.0 when cached);
    raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not library_path(n).exists() for n in names) else ""
    jobs = {}
    seconds = {n: 0.0 for n in names}
    for n in names:
        out = library_path(n)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[n] = (proc, tmp, out, time.perf_counter())
    failed = []
    for n, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


class Resources(ctypes.Structure):
    """``ReproResources`` of ``csrc/common.cuh``: one kernel's resources at
    one launch configuration, as the card reports them."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "regs", "local_bytes", "static_smem", "dyn_smem", "threads",
        "cluster", "resident")]


def resources(name: str, entry: str, *args: int) -> dict:
    """What ``entry`` (a ``repro_*_resources`` function of kernel library
    ``name``) reports for the integer arguments ``args``: registers a
    thread, local bytes a thread, static and dynamic shared memory a
    block, threads a block, blocks a cluster, and the blocks an SM (no
    cluster) or clusters the card (a cluster) holds at once.  Raises if
    the card refuses the configuration."""
    fn = getattr(library(name), entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(Resources)]
    fn.restype = ctypes.c_int
    out = Resources()
    check(name, fn(*args, ctypes.byref(out)))
    return {f: getattr(out, f) for f, _ in Resources._fields_}


def check(name: str, code: int) -> None:
    """Raise if a kernel library's C entry point reported a CUDA error."""
    if code != 0:
        msg = library(name).repro_error_string(code).decode()
        raise RuntimeError(f"{name} kernel: CUDA error {code}: {msg}")
