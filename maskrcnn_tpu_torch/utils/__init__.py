"""Utilities: the progress bar and instance overlays."""
