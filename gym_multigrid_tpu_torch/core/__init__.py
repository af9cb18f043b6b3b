"""Static tables of the port: colors, directions, world schemas."""
