"""Pose-graph factor arrays and the LM solver."""
