"""Fault tolerance (twin of ``repro.runtime``)."""
