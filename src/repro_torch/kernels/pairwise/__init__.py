from repro_torch.kernels.pairwise import kernel, ops, ref, signsplit, specs  # noqa: F401
from repro_torch.kernels.pairwise.specs import (KernelSpec, get_spec,  # noqa: F401
                                                register_kernel,
                                                registered_kernels, stat_only)
from repro_torch.kernels.pairwise import calibrate  # noqa: F401
from repro_torch.kernels.pairwise.calibrate import (calibrate_sigma,  # noqa: F401
                                                    register_calibration,
                                                    stat_quantile)
