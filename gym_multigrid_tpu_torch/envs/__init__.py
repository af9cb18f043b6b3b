"""Env families of the port (Collect so far)."""
