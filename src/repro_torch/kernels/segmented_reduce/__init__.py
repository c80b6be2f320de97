"""Grouped multi-aggregate kernel (CUDA) and its plain version."""
