"""Launchers of the port: ``python -m repro_torch.launch.serve`` (the
trace server's JSON-lines TCP front end; ``--demo`` for an in-process
smoke run)."""
