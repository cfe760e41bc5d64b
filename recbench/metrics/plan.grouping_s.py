"""The program's ``plan.grouping`` span over the server's construction,
summed over the tables (one a table; ``repro_torch.core.trace``, on in a
traced run)."""


def read(run):
    program = run["program"]
    if program is None:
        return None
    seconds, calls = program["plan"]["spans"].get("plan.grouping", (0.0, 0))
    return seconds if calls else None
