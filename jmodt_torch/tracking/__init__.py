"""Online tracking (counterpart of `jmodt_tpu/tracking`): the host tracker
(Kalman and track lifecycle on the host, affinity on the device, MIP or
Hungarian assignment) and the tracker with its state on the device, for one
stream or S streams in lockstep."""

from jmodt_torch.tracking.device_tracker import (DeviceTracker, TrackerState,
                                                 init_batched_state,
                                                 init_state,
                                                 make_batched_tracker_step,
                                                 make_device_tracker_step)
from jmodt_torch.tracking.kalman import Kalman
from jmodt_torch.tracking.track import Track
from jmodt_torch.tracking.tracker import Tracker

__all__ = ['DeviceTracker', 'Kalman', 'Track', 'Tracker', 'TrackerState',
           'init_batched_state', 'init_state', 'make_batched_tracker_step',
           'make_device_tracker_step']
