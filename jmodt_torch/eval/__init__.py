"""Offline evaluation (counterpart of `jmodt_tpu/eval`): KITTI detection AP
(`detection_ap`), CLEAR-MOT tracking metrics (`clear_mot`) and the two-stage
entry point `python -m jmodt_torch.eval` (`__main__`).  This `__init__`
imports none of them, so the entry point starts without loading the
evaluators it may not need."""
