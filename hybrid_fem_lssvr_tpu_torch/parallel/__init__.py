"""Distributed solves on ``torch.distributed`` (device meshes, the five
collectives, the 1D SPIKE solve, the 2D and 3D slab, grid and graded
solves) and the ADI line sweeps."""
