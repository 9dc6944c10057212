"""Deterministic, restartable data pipeline of the port."""
from repro_torch.data.pipeline import (  # noqa: F401
    BinCorpus,
    DataState,
    SyntheticLM,
    host_batch_slice,
    make_pipeline,
)
