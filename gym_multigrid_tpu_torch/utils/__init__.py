"""Host-side helpers of the port (map loading)."""
