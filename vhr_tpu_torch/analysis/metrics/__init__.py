"""Metric plugins: plot(truth, results, x_label, output_dir)."""
