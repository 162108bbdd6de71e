"""Checkpoints in the reference's format (twin of ``repro.checkpoint``)."""
