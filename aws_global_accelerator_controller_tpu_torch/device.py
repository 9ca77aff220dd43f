"""Device resolution and the device probe (kernel K1).

The counterpart of the JAX package's ``compat/capability.py`` and
``jaxenv.py``, cut to what the port needs.  There is no ladder of
rungs: an entry point runs on the card (``device="cuda"``, the default)
or, when the caller asks for it, on the CPU (``device="cpu"``).  A
default that finds no CUDA device raises :class:`DeviceError`; nothing
falls back to the CPU on its own.

On first use of each CUDA device, :func:`resolve_device` launches the
probe kernel (``csrc/probe.cu``, the port of
``compat/capability.py::CapabilityRegistry._tiny_kernel``) on an
(8, 128) f32 tile and refuses the device unless the answer is exactly
twice the input.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Set, Union

import torch

from .kernels.build import Kernel, require_cuda

Device = Union[str, torch.device]

#: the (major, minor) compute capability the kernels are built for
#: (``sm_90a``: Hopper)
KERNEL_CAPABILITY = (9, 0)

_PROBE = Kernel("probe_double", "agac_probe_double",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong])

_lock = threading.Lock()
_probed: Set[int] = set()


class DeviceError(RuntimeError):
    """The requested device cannot run the port."""


def probe_double_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel K1."""
    return x * 2.0


def probe_double(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` for a float32 tensor: kernel K1 on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return probe_double_reference(x)
    dev = require_cuda("probe_double", x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe_double takes a contiguous float32 tensor")
    out = torch.empty_like(x)
    if x.numel():
        _PROBE(dev, x, out, x.numel())
    return out


def _probe(dev: torch.device) -> None:
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != KERNEL_CAPABILITY:
        raise DeviceError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}; the port's kernels are built for sm_90a "
            f"(Hopper)")
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=dev).reshape(8, 128)
    got = probe_double(x)
    if not torch.equal(got.cpu(), x.cpu() * 2.0):
        raise DeviceError(f"the probe kernel answered wrong on {dev}")


def resolve_device(device: Device = "cuda") -> torch.device:
    """The torch device to run on.  ``"cpu"`` is taken as asked; a CUDA
    device (``"cuda"``, the current one, or ``"cuda:N"``) must exist and
    pass the probe kernel (run once per device and process)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise DeviceError(f"unsupported device {device!r}: the port runs "
                          f"on 'cuda', or on 'cpu' when asked")
    if not torch.cuda.is_available():
        raise DeviceError(
            "no CUDA device is visible: the port runs on the card by "
            "default; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise DeviceError(
            f"{device!r} does not exist: {torch.cuda.device_count()} CUDA "
            f"device(s) are visible")
    with _lock:
        if dev.index not in _probed:
            _probe(dev)
            _probed.add(dev.index)
    return dev
