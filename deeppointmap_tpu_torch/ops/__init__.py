"""Geometry ops: sampling (K1), neighbour queries (K2), normals, Kabsch,
information matrix."""
