"""Elastic resharding on the PyTorch port: the worker set grows and shrinks
mid-run.

The port's counterpart of ``examples/elastic_vq.py``: an 8->4->8 run of the
paper's delta scheme (eq. 8) where each worker-set change is a
**resharding event, not a restart**: at the scheduled window the engine
integrates the departing workers' in-flight deltas (eq. 8 on the stale
window, damped by staleness), checkpoints the shared prototypes, re-slices
the stacked workers and the sample pool over the new M, and resumes;
compared against the fixed-M oracle on the same total sample budget.  The
data is drawn with numpy from the seed (``synthetic.numpy_mixture``).

    PYTHONPATH=src python examples/elastic_vq_torch.py [--device cpu]
"""

import argparse
import math
import tempfile

from repro_torch import device as device_lib
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import schemes
from repro_torch.data import synthetic
from repro_torch.engine import (ElasticMeshExecutor, InstantNetwork,
                                ResizeSchedule)

M0, N, D, KAPPA, TAU = 8, 2000, 8, 16, 10
SCHEDULE = ((60, 4), (120, 8))
SEED = 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device_lib.pin_full_f32()
    dev = device_lib.resolve(args.device)
    w0, data = (t.to(dev) for t in synthetic.numpy_mixture(SEED, M0, N, D,
                                                           KAPPA))
    eval_data = data[:, :500].contiguous()

    print(f"device: {dev}, M0={M0} workers stacked on it, tau={TAU}, "
          f"budget={M0 * N} points\n")

    oracle = schemes.scheme_delta(w0, data, eval_data, tau=TAU)

    with tempfile.TemporaryDirectory() as td:
        ex = ElasticMeshExecutor(ResizeSchedule(SCHEDULE),
                                 network=InstantNetwork(),
                                 checkpointer=Checkpointer(td), device=dev)
        res = ex.run("delta", w0, data, eval_data, tau=TAU)
        for ev in ex.resize_events:
            print(f"resize @window {ev.window:>3}: M {ev.old_m} -> "
                  f"{ev.new_m}  (late points merged: {ev.late_points}, "
                  f"event cost {ev.wall_s * 1e3:.1f} ms, "
                  f"checkpoint step {ev.checkpoint_step})")

    c_el, c_or = float(res.distortion[-1]), float(oracle.distortion[-1])
    print(f"\n{'':>18} {'windows':>8} {'C(final)':>10}")
    print(f"{'fixed M=8 oracle':>18} {len(oracle.distortion):>8} "
          f"{c_or:>10.5f}")
    print(f"{'elastic 8-4-8':>18} {len(res.distortion):>8} {c_el:>10.5f}")
    print(f"\nrelative gap: {abs(c_el - c_or) / c_or:.4f} "
          f"(acceptance bar: 1e-2) — a worker-set change costs a resharding "
          f"event,\nnot a restart, and the displacement merge stays on the "
          f"oracle's convergence path.")
    if not math.isfinite(c_el):
        raise SystemExit("the elastic run's distortion is not finite")


if __name__ == "__main__":
    main()
