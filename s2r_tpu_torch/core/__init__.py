"""Device and dtype resolution."""
