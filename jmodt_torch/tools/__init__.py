"""Command-line tools around a trained detector (counterparts of the JAX
package's `tools/*.py`): each runs as `python -m jmodt_torch.tools.<name>`.

- `export_torch_weights`: a port checkpoint -> a reference PointRCNN `.pth`.
- `oracle_ap`: the AP ceiling of a split, its own ground truth fed back as
  detections.
- `recall_diagnosis`: where a detector loses ground truth, by range and
  box height.
- `synthetic_ladder`: the three-stage train -> eval -> track ladder on a
  synthetic KITTI-format tree; `ladder_report` renders its log.
- `viewer`: bird's-eye and 3D renders of a tracked sequence (matplotlib,
  host only).
"""
