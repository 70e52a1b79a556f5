"""Online tracking (counterpart of `jmodt_tpu/tracking`): the tracker with
its state on the device.  The host tracker is not ported yet."""

from jmodt_torch.tracking.device_tracker import (DeviceTracker, TrackerState,
                                                 init_state,
                                                 make_device_tracker_step)

__all__ = ['DeviceTracker', 'TrackerState', 'init_state',
           'make_device_tracker_step']
