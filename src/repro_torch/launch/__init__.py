from .mesh import HostMesh, make_host_mesh

__all__ = ["HostMesh", "make_host_mesh"]
