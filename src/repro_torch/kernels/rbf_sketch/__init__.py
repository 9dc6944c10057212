from repro_torch.kernels.rbf_sketch import kernel, ops, ref  # noqa: F401
