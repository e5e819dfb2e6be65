"""ICP ops: the plain PyTorch version (icp) and the CUDA kernel K1 (icp_cuda)."""
