"""Distribution on torch.distributed (kytpu/dist): ("tile", "spp") process
meshes, sharded renders and train steps, multi-process film tiles, elastic
tile rendering."""

from kytpu_torch.dist.mesh import Mesh, default_mesh_shape, make_mesh
from kytpu_torch.dist.shard import (render_sharded, render_sharded_pallas,
                                    render_tiles)

__all__ = ["Mesh", "make_mesh", "default_mesh_shape", "render_sharded",
           "render_sharded_pallas", "render_tiles"]
