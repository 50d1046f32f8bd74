"""Data pipelines of the port (the synthetic token stream)."""
