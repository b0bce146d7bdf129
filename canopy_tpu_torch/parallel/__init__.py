"""Mesh parallelism: sharded quantification over torch.distributed meshes."""

from .mesh import make_mesh, mesh_shape  # noqa: F401
from .quantify import (sharded_cutset_quantifier,  # noqa: F401
                       sharded_uncertainty_step)
