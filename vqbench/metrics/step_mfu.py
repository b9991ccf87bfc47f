"""``step_mfu``: the traced jobs' share of the H100's f32 peak, in %.

The operations are the benchmark's count of what a job's steps need
(``yardstick.job_flops``: the eq.-1 steps, the merges and the evals, from
the cell's shapes), over the traced window's wall time at 67 TFLOP/s (the
program runs its products in f32 with TF32 off).
"""

from vqbench import yardstick


def read(ctx):
    if ctx.trace.busy_s <= 0.0:
        return None
    p = ctx.plan
    flops = ctx.jobs * yardstick.job_flops(
        p.step, m=p.m, kappa=p.kappa, d=p.d, tau=p.tau,
        points=p.job_points, n_eval=p.n_eval, eval_every=p.eval_every)
    return 100.0 * flops / (ctx.trace.window_s * yardstick.PEAK_F32_FLOPS)
