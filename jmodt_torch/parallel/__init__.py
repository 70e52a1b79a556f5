"""Data-parallel training over processes (counterpart of
`jmodt_tpu/parallel`, its data axis)."""
