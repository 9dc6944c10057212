"""Query-time inference over precomputed fast-SPSD factors (port of
``repro.serve``).

``build_artifact`` (training side) -> ``save_artifact`` /
``load_or_rebuild`` (the warm-boot factor store on
``repro_torch.checkpoint``) -> ``serve_kernel_model`` (one rectangular
cross launch per query bucket).  The continuous-batching loop lives in
``repro_torch.launch.serve_kernel``; appended-row maintenance (one thin
launch per batch, delta checkpoints, staleness-triggered re-sketch) in
``repro_torch.serve.incremental``.
"""
from repro_torch.serve.artifact import (  # noqa: F401
    TASKS,
    KernelModelArtifact,
    artifact_from_tree,
    artifact_to_tree,
    build_artifact,
    load_artifact,
    load_or_rebuild,
    save_artifact,
)
from repro_torch.serve.engine import (  # noqa: F401
    QueryRequest,
    QueryResult,
    answer_batch,
    dense_krr_head,
    dense_krr_oracle,
    dense_oracle,
    parity_gap,
    plan_buckets,
    serve_kernel_model,
)
from repro_torch.serve.incremental import (  # noqa: F401
    DeltaRecord,
    GenerationStats,
    IncrementalMaintainer,
    IncrementalState,
    StalenessPolicy,
    append_rows,
    compact,
    gc_superseded_deltas,
    init_state,
    is_delta_step,
    load_artifact_chain,
    load_chain,
    save_delta,
)
