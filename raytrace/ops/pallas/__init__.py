"""Pallas kernels for the GPU (Triton route): the fused bounce loop
for sphere/free-triangle scenes and the mesh nearest-hit walk."""
