"""Checkpoint loading and trajectory metrics."""
