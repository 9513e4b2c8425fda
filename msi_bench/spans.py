"""Host spans from the benchmark's side: for a traced block, each named
call into the program runs inside a `torch.profiler.record_function` of its
name, so that the trace can say what the host was doing between two device
operations. Outside the block the program is as it was."""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def spans(targets):
    """targets: (module, attribute) pairs, each wrapped for the block in a
    record_function named "<module's last part>.<attribute>"."""
    saved = []

    def wrap(fn, name):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned

    try:
        for mod, attr in targets:
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr,
                    wrap(fn, f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}"))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
