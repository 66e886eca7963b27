"""Parallel paths: data parallelism over ``torch.distributed``
(``mesh.py``), multi-process execution (``multihost.py``) and
tensor-parallel voxel tables (``tp.py``). Counterpart of
``evdeblurnerf_tpu/parallel/``; its ``compat.py`` (a JAX version shim) has
no counterpart."""
