"""The share of the window's dispatched slots that the crossbar kernel
takes down its READ path, from the program's ``read_slots`` and ``slots``
counters (``repro_torch.core.trace``, on in a traced run): a slot with at
most one nonzero bitmap entry reads that row, the rest take the MAC path."""


def read(run):
    program = run["program"]
    if program is None:
        return None
    counters = program["window"]["counters"]
    slots = counters.get("slots", 0)
    return counters.get("read_slots", 0) / slots * 100 if slots > 0 else None
