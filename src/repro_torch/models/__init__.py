"""Model stack of the port: layers, attention, transformer blocks and the
decoder-only LM (dense attention family)."""
