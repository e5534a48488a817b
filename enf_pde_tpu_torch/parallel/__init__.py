"""Data-parallel training and coordinate-sharded decode (``parallel/mesh.py``)."""
