"""Query steps sharded over a (data, colour) grid of devices (mesh.py),
and pseudoalign sharded over processes (multihost.py)."""
