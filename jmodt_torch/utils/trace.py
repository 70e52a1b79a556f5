"""Spans at the port's layer boundaries (counterpart of
`jmodt_tpu/utils/runtime.py::annotate`).

`span(name)` is a context manager and `spanned(name)` a decorator; both
open `torch.profiler.record_function(name)` while a profiler is recording
and nothing otherwise.  The ranges then sit in the profiler's trace on the
clock of its device events (`torch.profiler`), or become NVTX ranges
(`torch.autograd.profiler.emit_nvtx`, for `nsys`).  There is no switch of
their own: the profiler being on is the switch, and the spans leave with
its trace.  Off, a span costs a call into the profiler's C state and a
branch; an ungated `record_function` costs microseconds even with the
profiler off, and a frame opens about fifty spans.

The names, from the root of a call down (`jmodt.kernel.<name>` around each
wrapper of a hand-written kernel, its torch glue included):

    jmodt.joint > jmodt.upload, jmodt.detection > jmodt.backbone > ...,
        jmodt.top_k, jmodt.tracker > jmodt.tracker.predict, ..., jmodt.pack
    jmodt.train_step > jmodt.upload, jmodt.forward > jmodt.backbone, ...,
        jmodt.forward.rcnn; jmodt.backward, jmodt.optimizer
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

# true under torch.profiler and under emit_nvtx alike
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager holding the range `name` open while a profiler
    records."""
    if _recording():
        return record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: the function's calls run inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
