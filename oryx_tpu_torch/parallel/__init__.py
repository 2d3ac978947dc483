"""Device mesh and sharding helpers (the Spark-cluster analogue;
counterpart of ``oryx_tpu/parallel``).

Where the reference distributes work as Spark RDD partitions over YARN
executors (SURVEY.md §2.12), the port shards tensors over the shards of a
:class:`~oryx_tpu_torch.parallel.mesh.Mesh` and combines them with the
mesh's collectives: copies within a process, ``torch.distributed``
across processes.
"""

from oryx_tpu_torch.parallel.mesh import (  # noqa: F401
    get_mesh,
    data_sharding,
    replicated,
    shard_rows,
)
