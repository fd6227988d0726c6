"""Face localization models."""
