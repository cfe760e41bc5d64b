"""Process start to the first timed request: the tables made on the
device, the catalogue and the plan history, the server's plan build and
image, and the warm-up requests (host clock)."""


def read(run):
    return run["setup_s"]
