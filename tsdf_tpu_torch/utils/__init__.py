"""Test and smoke fixtures."""
