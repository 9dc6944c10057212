"""Entry functions of user-registered ``KernelSpec``s (only a Python
``entry_fn``), one per op family and statistic, shared by the CPU tests of
their lowering (``test_torch_user_spec.py``) and the card tests of their
kernels (``test_torch_cuda.py``).  Imports torch only."""
from __future__ import annotations

import torch


def cauchy_entry(gamma: float):
    return lambda t: 1.0 / (1.0 + gamma * t)


def matern52(t):
    r = torch.sqrt(torch.clamp(t, min=0.0)) * (5.0 ** 0.5 / 1.5)
    return (1.0 + r + r * r / 3.0) * torch.exp(-r)


#: (name, statistic, entry): one per op family and statistic
ENTRIES = (
    ("cauchy", "sqdist", cauchy_entry(0.5)),
    ("rational_quadratic", "sqdist", lambda t: (1 + t / 3.0) ** -2.0),
    ("matern52", "sqdist", matern52),
    ("exp_dot", "dot", lambda t: torch.exp(0.1 * t)),
    ("inverse_square_l1", "l1dist", lambda t: (1 + t) ** -2),
    ("compact", "sqdist",
     lambda t: torch.where(t < 1, (1 - t) ** 2, torch.zeros_like(t))),
    ("transcendental", "dot",
     lambda t: torch.sigmoid(t) - torch.tanh(-t) + torch.expm1(-t.abs())
     * torch.log1p(t.abs()) / 3 + torch.rsqrt(1 + t.abs())),
    ("powers", "sqdist",
     lambda t: t ** 5 + t ** 0.5 + t ** 3 + t ** 1.7 - t ** -0.5 + t ** 0
     + t ** -1 - t ** -3),
    ("compare_clamp", "dot",
     lambda t: (t <= 2).float() * t + (t > 5) * 2.0
     + torch.maximum(t, 3 - t) - torch.minimum(t, torch.tensor(0.25))
     + torch.clamp(t, 0.5, 3.0) - t.clamp_min(1) + torch.clamp_max(t, 2)),
    ("constants", "l1dist",
     lambda t: torch.full_like(t, 0.3) + torch.ones_like(t) * 2.0 / (t + 1)
     - torch.log(t + 1e-3) * torch.tensor(0.1) + (-t)),
)

#: the entries whose every op is correctly rounded in f32 (no exp, log,
#: tanh, powf …): their CUDA evaluation equals torch's on the CPU bit for bit
CORRECTLY_ROUNDED = ("cauchy", "rational_quadratic", "inverse_square_l1",
                     "compact", "compare_clamp")
