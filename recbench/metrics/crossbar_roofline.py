"""The crossbar kernel's share of its roofline: the least time of the
window's requests (``recbench.work``: bytes and operations counted from the
queries and widths alone, against the H100's published peaks) over the
device time of the kernel ``crossbar_reduce_kernel`` in the trace."""

KERNEL = "crossbar_reduce_kernel"


def read(run):
    trace, least = run["trace"], run["least_time_s"]
    if trace is None or not least:
        return None
    kernel_s = trace.op_seconds(KERNEL)
    return least / kernel_s * 100 if kernel_s > 0 else None
