"""Twins of the repository's probes in benchmarks/, one module each:
each runs as `python -m facerecon_tpu_torch.benchmarks.<name>` with the
reference's environment variables and defaults, plus `--device` (default
cuda, which raises without a card unless it is "cpu")."""
