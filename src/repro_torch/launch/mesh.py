"""Mesh entry point: the mesh builders and the world helpers, with the
launchers' own (``launcher_mesh``: join the world the environment names and
lay the ``(N / tp, tp)`` mesh over it).

Port of ``repro/launch/mesh.py`` (:1-8), which re-exports
``parallel/mesh.py``.  Functions only: importing this module initialises no
process group and touches no device.
"""
from ..parallel.mesh import (destroy_world, init_world,
                             join_launcher_world, launcher_mesh,
                             make_mesh_for, make_production_mesh,
                             single_device_mesh, spawn_world)

__all__ = ["make_production_mesh", "make_mesh_for", "single_device_mesh",
           "init_world", "destroy_world", "spawn_world",
           "join_launcher_world", "launcher_mesh"]
