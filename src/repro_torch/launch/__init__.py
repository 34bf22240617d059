from .mesh import HostMesh, axis_sizes, make_host_mesh, make_mesh, make_production_mesh

__all__ = ["HostMesh", "make_host_mesh", "make_mesh", "make_production_mesh", "axis_sizes"]
