"""Pallas kernels for the GPU (Triton route) on the sweep's hot path."""
