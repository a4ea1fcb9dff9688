"""Fused index-embed demultiplexer (prefill and decode forms)."""
