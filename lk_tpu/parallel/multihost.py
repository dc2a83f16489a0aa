"""Multi-host scale-out: ``jax.distributed`` wiring + global-mesh helpers.

The reference is one OS process end-to-end (SURVEY.md §2.5/§5.8 — no
threads, no multiprocessing, no communication backend).  Across hosts the
framework's natural layout is:

- **streams (data axis) across hosts over the network** — streams are
  independent (zero collectives in the compiled step), so the slow
  inter-host fabric carries no traffic; each host decodes only the streams
  whose shards it owns (``process_stream_slice``).
- **spatial sharding inside a host** — the halo exchanges of
  ``parallel/spatial.py`` ride neighbor ``ppermute``s, so the spatial axis
  must map to devices joined by the fast local links.
  ``global_stream_mesh`` keeps ``data`` outermost (contiguous process
  blocks → network) and ``spatial`` innermost (a host's local devices).

The coordinator address, process count, and process id are passed to
``jax.distributed.initialize()`` explicitly (as in the 2-process CPU test,
tests/test_multihost.py), with gloo cross-process collectives on CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_collectives: Optional[str] = "gloo",
) -> None:
    """Initialize the JAX distributed runtime for this process.

    With no arguments, relies on ``jax.distributed.initialize`` cluster
    auto-detection (managed clusters only).  Otherwise pass the coordinator's
    ``host:port`` plus this process's rank.  ``cpu_collectives`` selects the
    cross-process collective implementation when running on the CPU backend
    (gloo is the portable choice; "mpi" if launched under mpirun).
    """
    if cpu_collectives is not None:
        try:  # only consulted by the CPU backend; harmless elsewhere
            jax.config.update(
                "jax_cpu_collectives_implementation", cpu_collectives
            )
        except Exception:
            pass  # older jax without the flag
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_stream_mesh(
    spatial: int = 1,
    axis_names: Sequence[str] = ("data", "spatial"),
) -> Mesh:
    """Global mesh over every device of every process.

    ``data`` (streams) is the outermost axis: with jax's process-major
    global device order, consecutive ``data`` rows land on the same process
    first — stream parallelism never sends traffic between hosts, and the
    ``spatial`` axis stays inside each host's local devices.
    """
    devs = np.array(jax.devices())
    n = devs.size
    assert n % spatial == 0, (n, spatial)
    return Mesh(devs.reshape(n // spatial, spatial), axis_names)


def process_stream_slice(mesh: Mesh, n_streams: int, axis: str = "data"):
    """Which rows of the global stream batch THIS process must produce.

    Host-side decode is per-process: each host only opens/decodes the
    streams backing its addressable shards.  Returns ``slice(lo, hi)``.
    """
    axis_size = mesh.shape[axis]
    assert n_streams % axis_size == 0, (n_streams, axis_size)
    per_shard = n_streams // axis_size
    # rows owned = shards of the data axis whose devices are addressable
    mine = sorted(
        i for i, devs in enumerate(
            np.array(mesh.devices).reshape(axis_size, -1)
        ) if all(d.process_index == jax.process_index() for d in devs)
    )
    if not mine:  # spatial axis spans processes: every host feeds all rows
        return slice(0, n_streams)
    lo, hi = mine[0], mine[-1] + 1
    assert mine == list(range(lo, hi)), "data shards must be contiguous"
    return slice(lo * per_shard, hi * per_shard)


def host_local_to_global(x, mesh: Mesh, spec: P):
    """Lift this process's local shard(s) into a global jax.Array.

    ``x``'s leading axis is the process-local slice of the global batch
    (``process_stream_slice``); the result is the globally-sharded array the
    jitted pipeline consumes.
    """
    from jax.experimental import multihost_utils

    return multihost_utils.host_local_array_to_global_array(x, mesh, spec)


def global_to_host_local(x, mesh: Mesh, spec: P):
    """Inverse of :func:`host_local_to_global` for draining outputs."""
    from jax.experimental import multihost_utils

    return multihost_utils.global_array_to_host_local_array(x, mesh, spec)


def read_replicated(x) -> np.ndarray:
    """Host value of a fully-replicated global array (one local shard)."""
    return np.asarray(x.addressable_data(0))
