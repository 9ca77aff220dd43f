"""Carry model params from the JAX package into the port, bit-exactly.

The JAX model's params are a dict of arrays; ``np.asarray`` turns each
into numpy (bfloat16 arrays keep their dtype, named ``bfloat16``).
bfloat16 crosses as its 16-bit pattern: viewed as ``uint16`` on the
numpy side and as ``torch.bfloat16`` on the torch side, so no value is
rounded on the way.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import Device, resolve_device


def params_from_jax(np_params: Dict[str, object],
                    device: Device = "cuda") -> Dict[str, torch.Tensor]:
    """``{name: array}`` (numpy, or anything ``np.asarray`` takes) ->
    ``{name: tensor}`` on ``device``, bfloat16 bit for bit."""
    dev = resolve_device(device)
    out = {}
    for name, value in np_params.items():
        a = np.asarray(value)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(
                np.ascontiguousarray(a).view(np.uint16).copy()
            ).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        out[name] = t.to(dev)
    return out
