"""Streaming sketch engine on one device (paper §I, IV–VI).

- engine:       StreamEngine — source → sketch → accumulate → finalize.
- accumulators: constant-memory delta/apply algebra (Thm-4 mean, Thm-6 cov,
                mini-batch streaming sparsified K-means).
- state:        the reference's flat-array state layout, read, written,
                merged and checkpointed.
- queued:       QueueSource — pushed chunks behind the (seed, step, shard)
                source contract.
"""
from repro_torch.stream.accumulators import (  # noqa: F401
    KMeansState,
    MomentState,
    kmeans_assign,
    kmeans_finalize,
    kmeans_init,
    moment_finalize_cov,
    moment_finalize_mean,
    moment_init,
)
from repro_torch.stream.engine import (  # noqa: F401
    EngineState,
    StreamEngine,
    StreamKMeansConfig,
    StreamResult,
    batch_key,
    normalize_source,
)
from repro_torch.stream.queued import QueueSource  # noqa: F401
from repro_torch.stream.state import (  # noqa: F401
    engine_from_arrays,
    engine_merge,
    engine_to_arrays,
    from_arrays,
    load_engine,
    merge,
    save_engine,
    to_arrays,
)
