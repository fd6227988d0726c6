"""Degradation plugins: controlled video corruption for robustness sweeps."""
