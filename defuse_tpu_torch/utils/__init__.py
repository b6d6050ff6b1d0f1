"""Profiling helpers for the port."""
