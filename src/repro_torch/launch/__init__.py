"""Launchers of the port: serve.py (the LM serving entry point)."""
