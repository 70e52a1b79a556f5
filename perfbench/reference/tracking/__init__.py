"""The tracker with its state on the device, plain routes."""
