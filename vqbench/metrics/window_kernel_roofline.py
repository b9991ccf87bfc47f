"""``window_kernel_roofline``: the window kernel's (``csrc/vq_window.cu``,
resident or streaming route) share of its bound, in %: the launches in the
traced window times the bound of one call at the cell's shapes
(``yardstick.window_bound_s``), over their device time by kernel name."""

from vqbench import yardstick

PATTERN = r"window_(resident|stream)_kernel"


def read(ctx):
    calls = ctx.trace.kernels(PATTERN)
    if not calls:
        return None
    p = ctx.plan
    device_s = sum(d for _, _, d in calls) * 1e-6
    bound = yardstick.window_bound_s(p.m, p.tau, p.kappa, p.d)
    return 100.0 * len(calls) * bound / device_s
