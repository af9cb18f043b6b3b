"""Env families of the port: Collect, Capture-the-Flag, Maze and Wildfire."""
