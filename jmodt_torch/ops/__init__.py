"""Point and box operators; kernels in jmodt_torch/csrc."""
