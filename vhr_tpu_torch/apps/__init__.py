"""Command-line apps of the port (live, served)."""
