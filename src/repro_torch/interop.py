"""Carrying data between numpy and the port's tensors, and choosing a device.

The port's data enter as numpy arrays: the Fig. 2 workload draws its
matrices with numpy from seeds (``benchmarks/matmul_scaling.py``), and a
test hands the same arrays to the JAX package and to the port.  So these
functions are what put identical inputs into both.

* bfloat16 has no numpy dtype of its own.  JAX's arrays come out of
  ``np.asarray`` as ``ml_dtypes.bfloat16``; they cross as a ``uint16`` view,
  so the bits arrive unchanged.
* Arrays that are not writable (every array ``np.asarray`` makes of a JAX
  array) are copied first: ``torch.from_numpy`` would share read-only memory
  and warns on it.
* A parameter tree of the JAX package (nested dicts of arrays, from
  ``jax.device_get``) crosses whole with :func:`params_from_numpy`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def resolve_device(device: Optional[Device] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  With no device given and no card present this raises — the
    port never carries on on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU with the kernels' plain versions")
    return torch.device("cuda", torch.cuda.current_device())


def tensor_from_numpy(a: np.ndarray, device: Device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, bit for bit (bfloat16 included)."""
    a = np.require(np.asarray(a), requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array, bit for bit.  bfloat16 comes back as
    ``ml_dtypes.bfloat16`` (the dtype JAX's arrays use), imported only for
    that dtype."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16) \
            .view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Dict[str, Any], device: Device) -> Dict[str, Any]:
    """A parameter tree of nested dicts of numpy arrays (the JAX package's
    ``init_params`` tree after ``jax.device_get``) as the same tree of
    tensors on ``device``, key for key and bit for bit, bfloat16 included."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
