"""The traced run's readings: the program's spans kept off the device
timeline and put to the card's idle gaps, and the readers of the
program's spans and counters."""

import pytest

from _recbench_tiny import run_tiny
from recbench import trace
from recbench.run import load_reader

PROGRAM = {"serve.request", "serve.compile", "compile.activations", "serve.dispatch"}
#: the window, the program's spans on the host, and the card's operations
HOST = [(trace.WINDOW, False, 100.0, 110.0),
        ("serve.request", False, 101.0, 105.0), ("serve.compile", False, 101.0, 103.0),
        ("compile.activations", False, 101.5, 102.5), ("serve.dispatch", False, 103.0, 104.0),
        ("serve.request", False, 106.0, 109.0), ("aten::add", False, 106.5, 106.6)]
DEVICE = [("kernel", True, 103.5, 104.5), ("copy", True, 104.0, 104.2),
          ("kernel", True, 109.5, 111.0), ("before", True, 99.0, 99.5)]
#: the same spans as the profiler repeats them on the card's timeline
REPEATED = [(trace.WINDOW, True, 100.0, 110.0), ("serve.request", True, 101.0, 105.0),
            ("serve.dispatch", True, 103.2, 104.0), ("serve.request", True, 106.0, 109.0)]


def test_program_spans_stay_off_the_device_timeline():
    plain = trace.read_events(HOST + DEVICE, PROGRAM)
    repeated = trace.read_events(HOST + REPEATED + DEVICE, PROGRAM)
    assert repeated.ops == plain.ops == [("kernel", 103.5, 104.5), ("copy", 104.0, 104.2),
                                         ("kernel", 109.5, 110.0)]
    assert repeated.busy_s() == plain.busy_s() == pytest.approx(1.5)
    # a host operation that is not a program span is no host span
    assert {n for n, _, _ in repeated.host} == {"serve.request", "serve.compile",
                                                "compile.activations", "serve.dispatch"}
    assert repeated.idle_gaps() == plain.idle_gaps()


def test_idle_gaps_go_to_the_innermost_span():
    gaps = dict(trace.read_events(HOST + REPEATED + DEVICE, PROGRAM).idle_gaps())
    assert gaps == pytest.approx({
        trace.WINDOW: 1.0 + 1.0 + 0.5,          # before, between and after the requests
        "serve.request": 0.5 + 3.0,             # the first's end, after the kernel; the second
        "serve.compile": 0.5 + 0.5,             # around compile.activations
        "compile.activations": 1.0,
        "serve.dispatch": 0.5,                  # until the kernel starts
    })
    assert sum(gaps.values()) == pytest.approx(10.0 - 1.5)


def test_idle_gaps_past_the_top_fold_into_other():
    # spans end to end, each shorter than the one before, over the window
    names = [f"span{i:02d}" for i in range(2 * trace.TOP)]
    ends = [0.0]
    for i in range(len(names)):
        ends.append(ends[-1] + 2 * trace.TOP - i)
    host = [(trace.WINDOW, False, 0.0, ends[-1])]
    host += [(n, False, ends[i], ends[i + 1]) for i, n in enumerate(names)]
    t = trace.read_events(host, names)
    gaps = t.idle_gaps()
    assert len(gaps) == trace.TOP and gaps[-1][0] == trace.OTHER
    assert [n for n, _ in gaps[:-1]] == names[:trace.TOP - 1]
    assert sum(s for _, s in gaps) == pytest.approx(t.window_s)


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.read_events(DEVICE, PROGRAM)


READERS = ["compile.activations_ms_per_request", "plan.cooccurrence_s", "plan.grouping_s",
           "kernel.read_slot_share"]


@pytest.fixture(scope="module")
def runs(tiny_root):
    return {traced: run_tiny(tiny_root, "tiny.cooc", traced=traced) for traced in (False, True)}


@pytest.mark.parametrize("name", READERS)
def test_program_readers_read_a_traced_run_alone(tiny_root, runs, name):
    reader = load_reader(tiny_root, name)
    untraced_line, untraced = runs[False]
    line, traced = runs[True]
    assert untraced["program"] is None and reader.read(untraced) is None
    value = reader.read(traced)
    assert value is not None and value > 0
    assert line["metrics"][name]["value"] == value
    if name == "kernel.read_slot_share":
        assert value <= 100


def test_the_program_totals_split_plan_from_window(runs):
    line, run = runs[True]
    plan, window = run["program"]["plan"], run["program"]["window"]
    assert {"plan.cooccurrence", "plan.grouping", "plan.image"} <= set(plan["spans"])
    assert not {n for n in window["spans"] if n.startswith("plan.")}
    # each request of the window, and none of the warm-up's
    assert window["spans"]["serve.request"][1] == line["attempted"]
    assert window["counters"]["slots"] >= window["counters"]["read_slots"] >= 0
    gaps = line["breakdown"]["idle_gaps"]
    assert gaps and sum(s for _, s in gaps) == pytest.approx(
        line["device"]["window_s"] - line["device"]["busy_s"], rel=1e-6)
