"""PyTorch + CUDA port of jmodt_tpu (joint 3D detection and tracking).

The JAX package `jmodt_tpu` stays the reference; this package mirrors its
module layout and names and imports nothing of it (nor JAX).  Entry points:
`models.point_rcnn.build_detector`, `models.inference.make_detection_step`,
`tracking.init_state`, `tracking.make_device_tracker_step`,
`pipeline.make_joint_step` and `weights.load_jax_variables`; each runs on
the CUDA card unless it is given `device="cpu"`.
"""
