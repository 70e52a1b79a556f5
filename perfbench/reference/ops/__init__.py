"""Point and box operators, plain tensor ops."""
