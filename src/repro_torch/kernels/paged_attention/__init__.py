"""Paged-attention decode over a block-table KV pool."""
