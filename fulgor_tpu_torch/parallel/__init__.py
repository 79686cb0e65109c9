"""Query steps sharded over a (data, colour) grid of devices (mesh.py)."""
