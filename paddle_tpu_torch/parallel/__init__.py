"""Parallel training of the port (paddle_tpu/parallel counterpart): the
strategy config, meshes and `MeshTrainer`, on one device for now
(meshes over torch.distributed are ROADMAP.md item 10)."""

from paddle_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh
from paddle_tpu_torch.parallel.strategy import (
    DistStrategy, GradientScaleStrategy, ReduceStrategy)
from paddle_tpu_torch.parallel.trainer import MeshTrainer

__all__ = ["DistStrategy", "GradientScaleStrategy", "Mesh", "MeshConfig",
           "MeshTrainer", "ReduceStrategy", "make_mesh"]
