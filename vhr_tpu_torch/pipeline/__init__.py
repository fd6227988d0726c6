"""End-to-end measures built from the ops."""
