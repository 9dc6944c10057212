from repro_torch.kernels.flash_attention import grad, kernel, ops, ref  # noqa: F401
