"""The server's constructor, from the call to a device synchronize after
it: co-occurrence, grouping, replication, layout, the shard plan and the
image copied to the device (host clock)."""


def read(run):
    return run["plan_build_s"]
