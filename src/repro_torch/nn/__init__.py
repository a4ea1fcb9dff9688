"""Layers, activations, initializers and attention (PyTorch port of
``repro.nn``)."""
