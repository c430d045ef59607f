"""Parallelism over ranks, one process per card: data parallelism and the
rank grid (``parallel/dist.py``), and the mesh's model axis for the NeRF
(``parallel/mesh.py``)."""
