"""Cluster token service of the port (decision path)."""
