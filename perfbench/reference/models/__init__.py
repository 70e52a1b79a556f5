"""PointRCNN modules and the detection step, plain routes."""
