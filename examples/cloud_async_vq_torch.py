"""The paper's Section-4 cloud architecture on the PyTorch port: worker
THREADS + a dedicated reducer merging displacement messages through a
versioned blob store, no synchronization barrier anywhere, with an injected
straggler to show the scheme's tolerance (the reason the paper removed
barriers).

The port's counterpart of ``examples/cloud_async_vq.py``: each worker's
round is one window-kernel launch on the card, the store a device tensor
(``core.async_runtime``).  The data is drawn with numpy from the seed
(``synthetic.numpy_mixture``).

    PYTHONPATH=src python examples/cloud_async_vq_torch.py [--device cpu]
"""

import argparse

from repro_torch import device as device_lib
from repro_torch.core import async_runtime
from repro_torch.data import synthetic

M, N, D, KAPPA = 8, 3000, 8, 16
DURATION_S = 2.0
SEED = 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device_lib.pin_full_f32()
    dev = device_lib.resolve(args.device)
    w0, data = (t.to(dev) for t in synthetic.numpy_mixture(SEED, M, N, D,
                                                           KAPPA))

    print(f"{M} worker threads + 1 reducer, tau=10, {DURATION_S:g}s wall "
          f"clock, on {dev}")
    w, stats, trace = async_runtime.run_async_vq(
        data, w0, tau=10, duration_s=DURATION_S, comm_delay_s=0.002)
    print("distortion over wall time:",
          " -> ".join(f"{d_:.4f}" for _, d_ in trace[::5]))
    print("points/worker:", [s.points for s in stats])

    print("\nsame run with worker 0 slowed 100x (straggler):")
    w2, stats2, trace2 = async_runtime.run_async_vq(
        data, w0, tau=10, duration_s=DURATION_S, comm_delay_s=0.002,
        straggler={0: 100.0})
    print("distortion over wall time:",
          " -> ".join(f"{d_:.4f}" for _, d_ in trace2[::5]))
    print("points/worker:", [s.points for s in stats2])
    print("\nno barrier => the straggler only slows itself; global "
          "convergence continues (paper Section 4).")


if __name__ == "__main__":
    main()
