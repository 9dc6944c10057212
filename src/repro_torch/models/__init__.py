"""Model stack of the port: layers, attention (GQA, sliding window, MLA,
landmark decode), the MoE FFN, transformer blocks and the decoder-only LM."""
