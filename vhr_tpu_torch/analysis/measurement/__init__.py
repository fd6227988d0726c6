"""Measurement plugins: video path in, (N, 2) [t_sec, bpm] out."""
