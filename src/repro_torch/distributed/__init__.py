"""Data-parallel meshes for the sweep engine (``sharding``)."""
