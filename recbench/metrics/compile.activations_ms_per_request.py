"""The program's ``compile.activations`` span over the window, per request:
``compile_activations``, the stage of the host compile that runs once a
table (``repro_torch.core.trace``, on in a traced run)."""


def read(run):
    program = run["program"]
    if program is None or not run["attempted"]:
        return None
    seconds, calls = program["window"]["spans"].get("compile.activations", (0.0, 0))
    return seconds / run["attempted"] * 1e3 if calls else None
