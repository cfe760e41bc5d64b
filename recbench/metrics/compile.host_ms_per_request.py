"""The server's own host compile time (its ``report()["serve"]
["host_compile_s"]`` counter) over the window, per request."""


def read(run):
    before, after = run["counters"]
    a, b = before.get("host_compile_s"), after.get("host_compile_s")
    if a is None or b is None or not run["attempted"] or b <= a:
        return None
    return (b - a) / run["attempted"] * 1e3
