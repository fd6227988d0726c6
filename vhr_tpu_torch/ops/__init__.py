"""Tensor ops: ROI geometry, ROI reductions, sliding windows, kernels."""
