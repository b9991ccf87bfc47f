"""Quickstart on the PyTorch port: the paper in 60 seconds.

The port's counterpart of ``examples/quickstart.py``: runs the three
parallelization schemes on the synthetic mixture and prints the wall-time
distortion curves, Figures 1-3 of Durut, Patra & Rossi in one table.  The
data is drawn with numpy from the seed (``synthetic.numpy_mixture``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Next stops: ``mesh_vq_torch.py`` (the schemes on the stacked-worker
executor), ``elastic_vq_torch.py`` (resize the worker set mid-run), and
``serve_vq_torch.py`` (a live training run hot-swaps the codebook under a
micro-batched quantization service).
"""

import argparse

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import async_vq, schemes
from repro_torch.data import synthetic

M, N, D, KAPPA, TAU = 10, 3000, 8, 16, 10
SEED = 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device_lib.pin_full_f32()
    dev = device_lib.resolve(args.device)
    w0, data = (t.to(dev) for t in synthetic.numpy_mixture(SEED, M, N, D,
                                                           KAPPA))
    eval_data = data[:, :1000].contiguous()

    seq = schemes.scheme_sequential(w0, data[0], eval_data, tau=TAU)
    avg = schemes.scheme_average(w0, data, eval_data, tau=TAU)
    dlt = schemes.scheme_delta(w0, data, eval_data, tau=TAU)
    asy = async_vq.scheme_async(w0, data, eval_data, tau=TAU, p_delay=0.5,
                                generator=torch.Generator().manual_seed(SEED))

    ticks = [100, 500, 1000, 2000, 3000]

    def at(res, t):
        i = int(np.searchsorted(res.wall_ticks.cpu().numpy(), t))
        return float(res.distortion[min(i, len(res.distortion) - 1)])

    print(f"{'wall tick':>10} {'sequential':>11} {'averaging':>10} "
          f"{'delta':>8} {'async':>8}")
    for t in ticks:
        print(f"{t:>10} {at(seq, t):>11.4f} {at(avg, t):>10.4f} "
              f"{at(dlt, t):>8.4f} {at(asy, t):>8.4f}")
    print("\npaper's claims: averaging ~ sequential (Sec. 2, no speed-up); "
          "delta << sequential (Sec. 3); async ~ delta (Sec. 4).")


if __name__ == "__main__":
    main()
