"""Launch helpers of the port (``mesh.VirtualMesh``)."""
