"""Device and random-generator defaults of the port.

Entry points run on the CUDA device unless the caller names another one:
``default_device()`` is ``cuda`` and raises when no CUDA device is visible —
there is no silent fallback to the CPU.  Tests and CPU users pass
``device="cpu"``, where every kernel wrapper runs its plain PyTorch version.

Randomness comes from explicit ``torch.Generator`` objects (the counterpart
of the reference's JAX keys).  A draw happens on the generator's own device
and the result is moved to the target device, so a CPU generator can feed a
CUDA model and the same seed gives the same numbers on either device.
"""
from __future__ import annotations

from typing import Optional

import torch

#: seed of the generator used when a randomized entry point gets none — the
#: counterpart of the reference's ``DEFAULT_PROBE_SEED``: deterministic
#: across runs, and callers who want fresh draws pass a generator.
DEFAULT_SEED = 0


def default_device() -> torch.device:
    """The CUDA device; raises when CUDA is absent (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless the caller asks for "
            "the CPU, and no CUDA device is visible; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, ``default_device()`` when None."""
    return default_device() if device is None else torch.device(device)


def generator_or_default(
        generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or a new one seeded with ``DEFAULT_SEED`` on the CPU.

    Default draws are made on the CPU so they do not depend on the device
    the model runs on.
    """
    if generator is not None:
        return generator
    return torch.Generator(device="cpu").manual_seed(DEFAULT_SEED)
