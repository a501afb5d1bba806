"""Launchers of the port: ``python -m repro_torch.launch.serve`` (the
trace server's JSON-lines TCP front end; ``--demo`` for an in-process
smoke run), ``python -m repro_torch.launch.train`` (the LLM trainer's
loop: checkpoints, resume, SIGTERM), and ``roofline`` (the analytic FLOP and HBM-byte counts of an
LLM cell, the bound beside a measured time)."""
