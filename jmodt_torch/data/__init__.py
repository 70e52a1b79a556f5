"""Synthetic input frames."""
