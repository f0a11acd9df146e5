"""Tensor parallelism across torch.distributed ranks: the mesh's sizes
(``mesh.py``), the reference's sharding rules and each rank's cut of a
parameter (``shardings.py``), and rank start-up with its two process
groups (``distributed.py``)."""
