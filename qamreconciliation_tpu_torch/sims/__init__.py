"""Sweep engine and CLIs."""
