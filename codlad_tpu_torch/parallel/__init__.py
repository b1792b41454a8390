"""Sequence parallelism (sequence.py) and the multi-rank dry run (dryrun.py)."""
