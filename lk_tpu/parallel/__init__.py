"""Multi-device scaling: device meshes, stream data-parallelism, spatial sharding.

The reference is strictly single-threaded (SURVEY.md §2.5); scale here comes
from two orthogonal mesh axes:

* ``data`` — independent dashcam streams (embarrassingly parallel, the
  primary axis; no cross-stream communication);
* ``spatial`` — row-sharding of large frames for the dense flow path, with
  device-to-device halo exchange via shard_map + ppermute (the framework's
  sequence/context-parallel analogue).

Tensor/pipeline/expert parallelism have no counterpart in this workload
(there are no weight matrices to shard); the mapping is documented here so
the capability matrix is explicit.
"""

from lk_tpu.parallel.auto import sharded_dense_pyramidal_lk  # noqa: F401
from lk_tpu.parallel.mesh import make_mesh, stream_sharding  # noqa: F401
from lk_tpu.parallel.spatial import (  # noqa: F401
    halo_exchange,
    spatial_dense_lk_level,
)
from lk_tpu.parallel.streams import shard_pipeline_step  # noqa: F401
