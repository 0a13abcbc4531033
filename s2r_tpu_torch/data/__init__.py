"""Input normalization constants and the rgb8 ingest."""
