"""Parallel layouts (``repro/parallel/`` in the reference), as a one-device
stand-in: the mesh and the model-facing sharding context.  Meshes of more
than one device, the collectives, compression and pipelining come with
intra-op SPMD (ROADMAP §1 item 8)."""
from .mesh import Mesh, make_mesh_for, single_device_mesh
from .sharding import ShardingCtx

__all__ = ["Mesh", "make_mesh_for", "single_device_mesh", "ShardingCtx"]
