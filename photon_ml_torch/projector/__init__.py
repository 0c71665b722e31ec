"""Per-entity dimensionality reduction for random-effect training."""
