"""Synthetic worlds and sequence simulation."""
