"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into
`build/ray_tpu_torch/lib<name>-<hash>.so` at the repo root, where the
hash covers the sources and the flags, so an edited kernel never loads a
stale library. The sources have a plain C interface (pointers, sizes and
the stream as arguments; each entry returns `cudaGetLastError()`), so
no PyTorch header is compiled: a build takes seconds, not minutes.
Building happens at first use, never at import: the first `load` of a
checkout builds every missing library, one nvcc per source, all at once,
so the builds overlap instead of adding up one first call after another.
A file lock keeps concurrent processes from compiling the same library
twice.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
SOURCES = ("rms_norm", "flash_fwd", "flash_bwd", "paged_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Sources of many template instances, which nvcc optimises in parallel on
# every core: paged_decode's 36 kernels take 23 s in one thread, 12.7 s so
# (H100 host, 8 cores). The same registers, spills and shared memory.
SPLIT_COMPILE = ("paged_decode",)


def flags(name: str) -> tuple:
    """nvcc's flags for `csrc/<name>.cu`."""
    if name in SPLIT_COMPILE:
        return NVCC_FLAGS + ("-split-compile", "0")
    return NVCC_FLAGS


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of ray_tpu_torch are built at first use")
    return found


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed by sources and flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among `names` (default: all), one
    nvcc per source, in parallel. Raises with nvcc's output on failure.
    The compiler's messages (registers, shared memory, spills from
    `-Xptxas -v`) are kept beside each library as `.log`."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for n, lib in out.items():
            if lib.exists():
                continue
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc(), *flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT),
                        tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            out[n].with_suffix(".log").write_bytes(log)
            if proc.returncode != 0:
                failed.append(f"{n}.cu:\n{log.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the library of `csrc/<name>.cu`, building every missing one
    first. Callers keep the result (each op module loads its kernel
    once)."""
    lib = ctypes.CDLL(str(build()[name]))
    lib.rtt_error_string.argtypes = [ctypes.c_int]
    lib.rtt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.rtt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
