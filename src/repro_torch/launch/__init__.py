"""Launchers of the port: serve.py (the LM serving entry point) and
mesh.py (the serving shards' device assignment)."""
