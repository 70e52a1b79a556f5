"""Training: loss composition, optimizer, train / val steps, the epoch
trainer and checkpoints (counterpart of `jmodt_tpu/train`)."""
