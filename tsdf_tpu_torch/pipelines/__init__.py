"""Fusion pipelines."""
