"""Optimizers, schedules and the sketched gradient compressor of the port
(port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    Optimizer,
    adafactor,
    adamw,
    lion,
    make_optimizer,
)
from repro_torch.optim.schedule import warmup_cosine, warmup_linear  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    CompressorState,
    countsketch_compress,
    countsketch_decompress,
    make_gradient_compressor,
)
