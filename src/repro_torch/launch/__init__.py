"""Launchers and launch tooling of the port: serve.py and train.py (the
LM entry points), mesh.py (meshes and the serving shards' devices),
distributed_init.py, specs.py (per-cell specs and sharding rules),
collectives.py (collective bytes), roofline.py (operation and byte
counts) and dryrun.py (the meta-device dry run)."""
