"""Profiling and timing instrumentation.

The reference's observability is a wall-clock helper that forces dask
compute (reference: modules/parcel_test.py:19-35) plus the dask dashboard;
the equivalents here are a ``block_until_ready``-aware timer, a
columns/sec throughput counter (the framework's headline unit), and a
context manager around ``jax.profiler`` for on-device traces viewable in
TensorBoard/Perfetto.
"""

import contextlib
import time

import jax


def sync(out):
    """Wait for the device work behind every leaf of ``out`` to finish."""
    return jax.block_until_ready(out)


def time_function(f, *args, **kwargs):
    """(result, seconds) of ``f(*args)`` with device work forced to finish —
    the analogue of the reference's ``time_function`` (its ``.load()`` is
    our device sync)."""
    start = time.perf_counter()
    res = f(*args, **kwargs)
    sync(res)
    return res, time.perf_counter() - start


def infer_columns(args):
    """Column count implied by the first array argument: the product of
    its leading (batch) dims.  A 1-D first argument is ambiguous (a batch
    of points or one column of levels); treat it as a batch — pointwise
    (elementwise) functions are the common 1-D case.  Pass ``columns=``
    explicitly to time a single column."""
    first = jax.tree_util.tree_leaves(args)[0]
    if first.ndim <= 1:
        return int(first.shape[0]) if first.ndim else 1
    columns = 1
    for d in first.shape[:-1]:
        columns *= d
    return columns


def columns_per_second(f, *args, columns=None, iters=5, warmup=1,
                       **kwargs):
    """Steady-state throughput of ``f`` in columns/sec.

    ``columns`` defaults to ``infer_columns(args)`` (all batch dims =
    columns, the framework's unit of work).
    Returns (columns_per_sec, seconds_per_iter).
    """
    if columns is None:
        columns = infer_columns(args)
    for _ in range(warmup):
        sync(f(*args, **kwargs))
    t0 = time.perf_counter()
    outs = [f(*args, **kwargs) for _ in range(iters)]
    for out in outs:
        sync(out)
    sec = (time.perf_counter() - t0) / iters
    return columns / sec, sec


@contextlib.contextmanager
def trace(log_dir='/tmp/xparcel_trace'):
    """On-device profiler trace around a block::

        with utils.trace('/tmp/tr'):
            run(dat)

    View with TensorBoard's profile plugin or Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Accumulating named wall-clock sections (host-side)::

        tm = Timer()
        with tm('ingest'): ...
        with tm('solve'): ...
        print(tm.report())
    """

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = (self.sections.get(name, 0.0) +
                                   time.perf_counter() - t0)

    def report(self):
        total = sum(self.sections.values()) or 1.0
        lines = [f'{k:20s} {v:9.3f}s  {100 * v / total:5.1f}%'
                 for k, v in sorted(self.sections.items(),
                                    key=lambda kv: -kv[1])]
        return '\n'.join(lines)
