"""The ones a MAC slot of the window sums, on average: the program's
``mac_ones`` over its ``slots`` less ``read_slots`` (``repro_torch.core.
trace``, on in a traced run).  A MAC slot sums the nonzero bitmap entries
of one tile for one block of queries, at most ``q_block × group_size`` of
them: how full the paper's crossbar MAC operations are.

The READ/MAC split is the card's kernel's (its plain version on CPU
tensors sums every slot alike), so a window in which the kernel did not
launch (its ``launches`` counter) reads nothing, and neither does a
program without the counter."""


def read(run):
    program = run["program"]
    before, after = run["counters"]
    a, b = before.get("launches"), after.get("launches")
    if program is None or a is None or b is None or b <= a:
        return None
    counters = program["window"]["counters"]
    mac_slots = counters.get("slots", 0) - counters.get("read_slots", 0)
    if "mac_ones" not in counters or mac_slots <= 0:
        return None
    return counters["mac_ones"] / mac_slots
