"""Fused Hadamard multiplexer."""
