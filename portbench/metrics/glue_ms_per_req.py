"""glue_ms_per_req.<family>: profiler device milliseconds of every kernel
that is not one of the port's seven (csrc/), per completed request: the
torch ops between the port's kernels.  Copies and memsets are not kernels
and are not counted."""

from portbench.trace import is_copy


def read(td):
    if not td.requests:
        return None
    ms = sum(t - s for s, t, n in td.device if not is_copy(n) and td.kernel_of(n) is None) * 1e3
    return ms / td.requests
