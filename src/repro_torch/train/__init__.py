"""Checkpoints on disk (the reference's ``repro.train.checkpoint`` protocol)."""
