"""Multi-rank training, rendering and serving over ``torch.distributed``:
the port of ``ucnerf_tpu.parallel``.

JAX runs one process that sees a mesh of devices and gets its collectives
from ``shard_map`` and the SPMD partitioner.  The port runs one process
per rank, a process group per mesh axis (``mesh.py``), spawned by the
entry points themselves (``launch.py``), with autograd-aware collectives
(``collectives.py``), the view-sharded cascade's hook (``mvs_views.py``)
and the three train modes (``sharding.py``); the sharded eval render is
``train/loop.py::make_eval_render`` given the mesh.
"""
