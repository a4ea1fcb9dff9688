"""Flash attention over a full sequence (the cache-free causal forward)."""
