"""Capture-the-Flag opponent policies."""
