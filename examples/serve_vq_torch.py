"""Train-while-serve on the PyTorch port: a live elastic training run
hot-swaps the codebook under a quantization service taking traffic.

The port's counterpart of ``examples/serve_vq.py``, both halves at once: an
``ElasticMeshExecutor`` runs the delta scheme (eq. 8) through an 8->4->8
worker resize and publishes the shared prototypes into a versioned
``CodebookStore`` at window boundaries, while a ``QuantizeService``
micro-batches an open-loop query stream (geometric arrivals, the Section 4
cloud model) onto the lookup engine (the assign kernel on the card).  No
request fails, served versions only move forward, and the final responses
come from the freshest codebook.  The data is drawn with numpy from the
seed (``synthetic.numpy_mixture``).

    PYTHONPATH=src python examples/serve_vq_torch.py [--device cpu]
"""

import argparse
import threading

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.data import synthetic
from repro_torch.engine import (ElasticMeshExecutor, GeometricDelayNetwork,
                                InstantNetwork, ResizeSchedule)
from repro_torch.kernels import ref
from repro_torch.serve import (CodebookStore, QuantizeService, ShardedLookup,
                               run_load)

M0, N, D, KAPPA, TAU = 8, 1000, 8, 16, 10
N_REQUESTS = 800
SEED = 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device_lib.pin_full_f32()
    dev = device_lib.resolve(args.device)
    w0, data = (t.to(dev) for t in synthetic.numpy_mixture(SEED, M0, N, D,
                                                           KAPPA))
    eval_data = data[:, :200].contiguous()

    store = CodebookStore(w0, device=dev)  # version 1: the untrained init
    n_windows = N // TAU
    schedule = ResizeSchedule([(n_windows // 3, max(1, M0 // 2)),
                               (2 * n_windows // 3, M0)])
    trainer_ex = ElasticMeshExecutor(schedule, network=InstantNetwork(),
                                     on_window=store.publisher(),
                                     publish_every=5, device=dev)
    print(f"device: {dev} — training M {M0}->{max(1, M0 // 2)}->{M0}, "
          f"publishing every 5 windows; serving with geometric arrivals\n")

    errors = []

    def train():
        try:
            trainer_ex.run("delta", w0, data, eval_data, tau=TAU)
        except Exception as e:  # reported after the join
            errors.append(e)

    trainer = threading.Thread(target=train, name="trainer")
    lookup = ShardedLookup(device=dev)
    with QuantizeService(store, lookup, max_delay_s=2e-3) as service:
        trainer.start()
        report = run_load(service, n_requests=N_REQUESTS, d=D,
                          rows_per_request=4,
                          network=GeometricDelayNetwork(0.5), tick_s=2e-4,
                          generator=torch.Generator().manual_seed(SEED))
        trainer.join()
    if errors:
        raise errors[0]

    st = service.stats
    print(f"load:  {report.summary()}")
    print(f"batch: {st.flushes} flushes, mean fill {st.mean_fill:.1f} rows "
          f"(full={st.full_flushes}, deadline={st.deadline_flushes})")
    for ev in trainer_ex.resize_events:
        print(f"       resize @window {ev.window}: M {ev.old_m} -> "
              f"{ev.new_m} under live load")
    print(f"store: {store.version} versions published; served "
          f"{report.versions_min}..{report.versions_max}")

    if report.failed:
        raise SystemExit("hot-swap must not fail a single request")
    if not report.versions_monotonic:
        raise SystemExit("served versions must only move forward")

    # the service's answers are the real argmin: replay one query against
    # the exact snapshot that served it
    snap = store.latest()
    z = np.random.default_rng(SEED).standard_normal((5, D)).astype(np.float32)
    with QuantizeService(store, lookup) as service:
        resp = service.quantize(z)
    w_served = snap.w_device.cpu()
    a_ref, _ = ref.vq_assign_ref(torch.from_numpy(z), w_served)
    if not np.array_equal(resp.assign, a_ref.numpy()):
        raise SystemExit("a served answer differs from the plain argmin")
    flat_eval = eval_data.reshape(-1, D).cpu()
    c0 = float(ref.distortion_ref(flat_eval, w0.cpu()))
    c1 = float(ref.distortion_ref(flat_eval, w_served))
    print(f"\nfinal served codebook: version {snap.version} "
          f"(distortion {c1:.5f} vs {c0:.5f} at v1) — training improved "
          f"the live service without a restart or a dropped request.")


if __name__ == "__main__":
    main()
