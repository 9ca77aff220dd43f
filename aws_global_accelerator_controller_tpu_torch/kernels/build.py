"""Build the port's CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and links into one shared library
with a plain C interface, built at first use into
``build/torch_kernels/`` of the checkout under a name that hashes the
sources and flags, so an edited source never loads a stale library.
Nothing here runs at import: this module imports on a machine without
``nvcc`` or a card, where only the kernels' plain versions run.

Each C entry point takes device pointers, sizes and a stream, launches
on that stream, and returns ``cudaGetLastError()``.  A :class:`Kernel`
binds one entry point, launches it on PyTorch's current stream, raises
on a non-zero return, and counts its launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: every bound entry point, so a caller can zero or read all counts
KERNELS: List["Kernel"] = []

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA toolkit is needed to build the kernels")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link one library;
    returns its path (reused when the same sources were built before)."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"libagac_kernels_{_digest()}.so"
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log.decode(errors='replace')}")
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise KernelBuildError(
                "linking the kernels failed:\n"
                + link.stdout.decode(errors="replace"))
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The kernels' library, built and loaded once per process."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            lib.agac_error_string.argtypes = [ctypes.c_int]
            lib.agac_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    """Launches by kernel name; entry points that share a name (K5's send
    and sum) add up."""
    out: dict = {}
    for k in KERNELS:
        out[k.name] = out.get(k.name, 0) + k.launches
    return out


class Kernel:
    """One C entry point of the library.  Arguments are tensors (passed
    as device pointers) or ints; the current stream of the tensors'
    device is appended.  ``launches`` counts successful launches."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self._argtypes = [*argtypes, ctypes.c_void_p]
        self._fn = None
        self.launches = 0
        KERNELS.append(self)

    def _bind(self):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, device: torch.device, *args) -> None:
        fn = self._bind()
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*ptrs, stream)
        if err != 0:
            msg = library().agac_error_string(err).decode()
            raise KernelLaunchError(
                f"{self.symbol} failed: CUDA error {err} ({msg})")
        self.launches += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The device all of ``tensors`` lie on, which must be one CUDA
    device: a kernel wrapper launches or raises, never falls back."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{dev}")
    return dev
