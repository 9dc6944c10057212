from repro_torch.core import (adaptive, cur, eig, instrument,  # noqa: F401
                              kernelop, leverage, selection,
                              sketched_attention, sketch, spsd, sweep)
from repro_torch.core.adaptive import uniform_adaptive2_indices  # noqa: F401
from repro_torch.core.cur import (CURApprox, adaptive_row_indices,  # noqa: F401
                                  blocked_right_sketch, drineas08_U,
                                  fast_U_cur, fast_cur, optimal_U,
                                  optimal_cur)
from repro_torch.core.eig import (EigResult, approx_eigh,  # noqa: F401
                                  kpca_features, kpca_transform,
                                  misalignment, spectral_embedding,
                                  streaming_subspace_eigh, woodbury_solve)
from repro_torch.core.instrument import CountingOperator  # noqa: F401
from repro_torch.core.kernelop import (DenseSPSD, LinearKernel,  # noqa: F401
                                       PairwiseKernel, RBFKernel,
                                       SPSDOperator, as_operator)
from repro_torch.core.spsd import (SPSDApprox, bucket_by_size,  # noqa: F401
                                   fast_model, fast_model_batched,
                                   fast_model_from_C, fast_model_ragged,
                                   fast_model_with_error, relative_error)
from repro_torch.core.sweep import (mesh_data_size,  # noqa: F401
                                    sweep_operator, sweep_panels)
