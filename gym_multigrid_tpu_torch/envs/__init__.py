"""Env families of the port: Collect and Capture-the-Flag so far."""
