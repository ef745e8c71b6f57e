"""Core FastPGT algorithms (search, prune, commit, builders, eval, tuner)."""
