"""Parallel layouts (``repro/parallel/`` in the reference): device meshes
over a ``torch.distributed`` world (``mesh``), the model-facing sharding
context (``sharding``), the mesh-level collectives (``collectives``), int8
gradient compression (``compression``) and the GPipe pipeline over a mesh
axis (``pipeline``).  Tensor parallelism inside the launchers is ROADMAP §1
item 8b."""
from .mesh import (Mesh, init_world, destroy_world, spawn_world,
                   make_mesh_for, make_production_mesh, single_device_mesh)
from .sharding import ShardingCtx, act_spec, param_shardings
from . import collectives, compression, pipeline

__all__ = ["Mesh", "init_world", "destroy_world", "spawn_world",
           "make_mesh_for", "make_production_mesh", "single_device_mesh",
           "ShardingCtx", "act_spec", "param_shardings", "collectives",
           "compression", "pipeline"]
