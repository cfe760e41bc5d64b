"""Crossbar kernel launches over the window (the kernel wrapper's
``launches`` counter), per request."""


def read(run):
    before, after = run["counters"]
    a, b = before.get("launches"), after.get("launches")
    if a is None or b is None or not run["attempted"] or b <= a:
        return None
    return (b - a) / run["attempted"]
