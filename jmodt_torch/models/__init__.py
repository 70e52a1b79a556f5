"""PointRCNN modules and the detection step."""
