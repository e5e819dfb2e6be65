"""Checkpoints (save and load, in the JAX package's format), trajectory
metrics and profiling (torch.profiler traces, a stage timer)."""
