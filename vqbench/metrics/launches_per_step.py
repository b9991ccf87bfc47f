"""``launches_per_step``: the device's kernels, copies and sets in the
traced window over its steps (a window of eq. 8, a tick of eq. 9): what
``engine/mesh.py`` launches a step."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.steps
