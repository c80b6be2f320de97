"""Fused join-probe aggregate kernel (CUDA) and its plain version."""
