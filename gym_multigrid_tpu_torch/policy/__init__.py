"""Scripted opponent policies of the port (the static CtF tables so far)."""
