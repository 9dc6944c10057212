from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: F401
