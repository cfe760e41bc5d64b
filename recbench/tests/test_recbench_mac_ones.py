"""``kernel.ones_per_mac_slot``: the program's ``mac_ones`` over its MAC
slots, read from a traced run in which the card's kernel launched, within
a slot's ``q_block × group_size``; nothing from an untraced run, a window
without a launch (the CPU's plain version has no MAC path), or a program
that lacks the counter."""

import pytest

from _recbench_tiny import run_tiny
from recbench.run import load_reader

NAME = "kernel.ones_per_mac_slot"
#: a MAC slot's most ones: the tiny configurations' q_block × group_size
CEILING = 8 * 16


@pytest.fixture(scope="module")
def reader(tiny_root):
    return load_reader(tiny_root, NAME)


def launched(run, n=10):
    """``run`` as if the kernel had launched ``n`` times in its window."""
    return dict(run, counters=({"launches": 0}, {"launches": n}))


# the identical-tables form, and the list form (one-hot beside 100-hot)
@pytest.mark.parametrize("cell", ["tiny.cooc", "tiny-tables.cooc"])
def test_a_traced_run_reads_the_ones_of_its_mac_slots(tiny_root, reader, cell):
    untraced_line, untraced = run_tiny(tiny_root, cell, traced=False)
    assert untraced["program"] is None and reader.read(launched(untraced)) is None
    line, run = run_tiny(tiny_root, cell, traced=True)
    # on the CPU the kernel's plain version ran: no launch, nothing to read
    assert reader.read(run) is None and NAME not in line["metrics"]
    counters = run["program"]["window"]["counters"]
    mac_slots = counters["slots"] - counters["read_slots"]
    assert mac_slots > 0 and counters["mac_ones"] >= 2 * mac_slots
    value = reader.read(launched(run))
    assert value == counters["mac_ones"] / mac_slots
    assert 2 <= value <= CEILING


@pytest.mark.parametrize("counters", [
    {"slots": 10, "read_slots": 4},                      # a program without the counter
    {"slots": 10, "read_slots": 10, "mac_ones": 0},      # every slot read
    {},
])
def test_nothing_to_read_gives_nothing(reader, counters):
    run = launched({"program": {"window": {"counters": counters, "spans": {}}}})
    assert reader.read(run) is None
    assert reader.read(dict(run, program=None)) is None


def test_a_window_without_a_launch_reads_nothing(reader):
    run = launched({"program": {"window": {"counters": {"slots": 10, "read_slots": 4,
                                                        "mac_ones": 30}, "spans": {}}}})
    assert reader.read(run) == 5.0
    for before, after in (({"launches": 3}, {"launches": 3}), ({"launches": None},
                                                                {"launches": None})):
        assert reader.read(dict(run, counters=(before, after))) is None
