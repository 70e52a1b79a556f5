"""Online tracking (counterpart of `jmodt_tpu/tracking`): the tracker with
its state on the device, for one stream or S streams in lockstep.  The
host tracker is not ported yet."""

from jmodt_torch.tracking.device_tracker import (DeviceTracker, TrackerState,
                                                 init_batched_state,
                                                 init_state,
                                                 make_batched_tracker_step,
                                                 make_device_tracker_step)

__all__ = ['DeviceTracker', 'TrackerState', 'init_batched_state',
           'init_state', 'make_batched_tracker_step',
           'make_device_tracker_step']
