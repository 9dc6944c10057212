from repro_torch.core import (adaptive, cur, instrument,  # noqa: F401
                              kernelop, leverage, selection,
                              sketched_attention, sketch, spsd, sweep)
from repro_torch.core.instrument import CountingOperator  # noqa: F401
from repro_torch.core.kernelop import (DenseSPSD, LinearKernel,  # noqa: F401
                                       PairwiseKernel, RBFKernel,
                                       SPSDOperator, as_operator)
from repro_torch.core.spsd import (SPSDApprox, fast_model,  # noqa: F401
                                   fast_model_from_C, fast_model_with_error,
                                   relative_error)
