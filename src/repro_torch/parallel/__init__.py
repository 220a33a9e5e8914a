"""Parallel layouts (``repro/parallel/`` in the reference): device meshes
over a ``torch.distributed`` world (``mesh``), the model-facing sharding
context (``sharding``), the mesh-level collectives (``collectives``), int8
gradient compression (``compression``) and the GPipe pipeline over a mesh
axis (``pipeline``).  The launchers' ``--tp`` runs the models on a
``(data, model)`` mesh of the world the process is a rank of
(``mesh.launcher_mesh``), their parameters laid out by
``sharding.distribute_params``."""
from .mesh import (Mesh, init_world, destroy_world, spawn_world,
                   join_launcher_world, launcher_mesh, make_mesh_for,
                   make_production_mesh, single_device_mesh)
from .sharding import (Sharding, ShardingCtx, act_spec, distribute_params,
                       param_shardings)
from . import collectives, compression, pipeline

__all__ = ["Mesh", "init_world", "destroy_world", "spawn_world",
           "join_launcher_world", "launcher_mesh", "make_mesh_for",
           "make_production_mesh", "single_device_mesh", "Sharding",
           "ShardingCtx", "act_spec", "distribute_params", "param_shardings",
           "collectives", "compression", "pipeline"]
