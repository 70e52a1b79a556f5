"""The training step, plain routes."""
