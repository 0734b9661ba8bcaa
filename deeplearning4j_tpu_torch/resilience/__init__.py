"""Error types."""
