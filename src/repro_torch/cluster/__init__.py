"""Multi-process bootstrap + elastic re-sharding for the (seed, step, shard) grid.

- bootstrap: ``torch.distributed`` init (gloo for CPU work, NCCL on cards),
  the process mesh whose ranks own contiguous blocks of shard positions, and
  each process's block of a step's batch.
- elastic:   worker-count changes as a pure remap of the logical (step, shard)
  grid — each worker replays only the shards its new layout owns; deltas are
  merged and applied once per step, so the continued run matches the original
  layout to float-summation order.
- heartbeat: per-host liveness stamps as a registered state kind ("hb") —
  gathered/merged through the EngineState wire format and published as
  ``cluster.*`` gauges (repro_torch.obs).
"""
from repro_torch.cluster.bootstrap import (  # noqa: F401
    Mesh,
    global_rows,
    global_shard_batch,
    initialize,
    is_multiprocess,
    local_shards,
    make_mesh,
    process_count,
    process_index,
    process_mesh,
    shutdown,
)
from repro_torch.cluster.heartbeat import (  # noqa: F401
    Heartbeat,
    beat,
    gather,
    publish,
    publish_local,
)
from repro_torch.cluster.elastic import (  # noqa: F401
    apply_step,
    continue_elastic,
    merge_deltas,
    partial_step_delta,
    worker_shards,
)
