"""Mesh construction, for one device.

Port of ``repro/parallel/mesh.py`` (``make_mesh_for`` :58,
``single_device_mesh`` :68).  The reference builds a ``jax.sharding.Mesh``
over its devices; the port runs on one card, so a mesh here describes that
device under the axis names the rule tables use, each of size 1.  A mesh of
more than one device is intra-op SPMD, ROADMAP §1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..interop import Device, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes over ``device``."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device


def make_mesh_for(n_devices: int, model_parallel: int = 1, pods: int = 1,
                  device: Optional[Device] = None) -> Mesh:
    """The reference's generic mesh builder; here only ``n_devices == 1``."""
    if n_devices != 1 or model_parallel != 1 or pods != 1:
        raise NotImplementedError(
            f"a mesh of {n_devices} devices (model_parallel="
            f"{model_parallel}, pods={pods}) is intra-op SPMD, which comes "
            f"with ROADMAP §1 item 8; the port runs on one device")
    return single_device_mesh(device)


def single_device_mesh(device: Optional[Device] = None) -> Mesh:
    """The (1, 1) mesh over ("data", "model") on ``device`` (the card
    unless another is named)."""
    return Mesh(("data", "model"), (1, 1), resolve_device(device))
