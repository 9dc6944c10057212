"""The port's hand-written CUDA kernels, one library per source
(``pairwise``: B1/B2, ``landmark``: B5, ``flash``: B6).

``rbf_ops`` binds the ``rbf`` spec onto the pairwise kernels
(``repro_torch.kernels.rbf_sketch.ops``), as the reference re-exports it."""
from repro_torch.kernels.rbf_sketch import ops as rbf_ops  # noqa: F401


def libraries():
    """Every CUDA library of the port, for ``build.build_all``."""
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.landmark_attention import build as lm_build
    from repro_torch.kernels.pairwise import build as pw_build
    return (pw_build.LIBRARY, lm_build.LIBRARY, fa_build.LIBRARY)
