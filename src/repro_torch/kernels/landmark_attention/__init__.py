from repro_torch.kernels.landmark_attention import kernel, ops, ref  # noqa: F401
