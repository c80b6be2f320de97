"""Fused filter + multi-sum kernel (CUDA) and its plain version."""
