"""Per-layer and end-to-end metric readers, one file a metric: ``read(run)``."""
