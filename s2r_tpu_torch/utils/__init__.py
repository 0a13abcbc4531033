"""Host-side helpers: summaries and class-balancing weights."""
