"""``blocked_kernel_roofline``: the blocked kernel's (``csrc/vq_blocked.cu``:
at one point a worker, the argmin engine's sweep with the statistics) share
of its bound, in %, where the traced window's per-step statistics took the
blocked route alone (the program's ``vq_fused.launches_blocked`` counter
moved and its delta counter did not): the sweep launches times the bound
of one call at (M, 1) x kappa x d (``yardstick.delta_bound_s``: the same
reads and writes), over their device time."""

from vqbench import yardstick

PATTERN = r"sweep_kernel"
#: The program's launch counters this reader takes the route from.
COUNTERS = {"blocked": "repro_torch.kernels.vq_fused.launches_blocked",
            "delta": "repro_torch.kernels.vq_assign.launches"}


def read(ctx):
    if ctx.counts.get("blocked", 0) <= 0 or ctx.counts.get("delta", 0) > 0:
        return None
    calls = ctx.trace.kernels(PATTERN)
    if not calls:
        return None
    p = ctx.plan
    device_s = sum(d for _, _, d in calls) * 1e-6
    bound = yardstick.delta_bound_s(p.m, 1, p.kappa, p.d)
    return 100.0 * len(calls) * bound / device_s
