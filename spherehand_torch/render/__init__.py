"""Rendering: triangle z-buffer (plain PyTorch and CUDA kernels) and
Gaussian joint heatmaps."""
