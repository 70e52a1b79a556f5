"""Host-side KITTI utilities: calibration, label records, output writers and
a PNG reader."""
