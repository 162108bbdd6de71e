"""Deterministic synthetic data pipeline (twin of ``repro.data``)."""
