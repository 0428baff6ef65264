"""The device's idle share in the profiled sub-window of a traced run:
one minus the union of its activities' intervals over the host's seconds
around the sub-window."""


def read(outcome, ctx):
    p = outcome.profile
    if not p or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
