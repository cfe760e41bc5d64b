"""The share of the traced window in which no operation (kernel, copy or
set) ran on the device, from the profiler's trace."""


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    busy = trace.busy_s()
    return (1 - busy / trace.window_s) * 100 if busy > 0 else None
