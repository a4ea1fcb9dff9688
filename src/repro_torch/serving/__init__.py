"""Serving: the lock-step multiplexed engine."""
