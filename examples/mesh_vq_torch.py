"""The paper's three schemes on the PyTorch port's stacked-worker executor.

The port's counterpart of ``examples/mesh_vq.py``: the ``MeshExecutor``
stacks the M workers on one device (one window-kernel launch a window on
the card, merges through the dense transport, masked merges for the async
staleness model), checked live against the ``SimExecutor`` oracles on the
same data and the same round lengths.  The data is drawn with numpy from
the seed (``synthetic.numpy_mixture``).

    PYTHONPATH=src python examples/mesh_vq_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch import device as device_lib
from repro_torch.data import synthetic
from repro_torch.engine import (GeometricDelayNetwork, InstantNetwork,
                                get_executor)

M, N, D, KAPPA, TAU = 8, 2000, 8, 16, 10
SEED = 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device_lib.pin_full_f32()
    dev = device_lib.resolve(args.device)
    w0, data = (t.to(dev) for t in synthetic.numpy_mixture(SEED, M, N, D,
                                                           KAPPA))
    eval_data = data[:, :500].contiguous()

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name}), M={M} workers stacked on it, "
          f"tau={TAU}\n")

    nets = {"average": InstantNetwork(), "delta": InstantNetwork(),
            "async_delta": GeometricDelayNetwork(p_delay=0.5)}
    print(f"{'scheme':>12} {'backend':>8} {'C(final)':>10} {'ticks':>6}  "
          f"|mesh - sim|")
    for scheme, net in nets.items():
        sim = get_executor("sim", network=net, device=dev)
        mesh = get_executor("mesh", network=net, device=dev)
        # one seed, so both draw the same async round lengths
        r_sim = sim.run(scheme, w0, data, eval_data, tau=TAU,
                        generator=torch.Generator().manual_seed(SEED))
        r_mesh = mesh.run(scheme, w0, data, eval_data, tau=TAU,
                          generator=torch.Generator().manual_seed(SEED))
        gap = float((r_sim.distortion - r_mesh.distortion).abs().max())
        for label, r in (("sim", r_sim), ("mesh", r_mesh)):
            print(f"{scheme:>12} {label:>8} {float(r.distortion[-1]):>10.5f} "
                  f"{int(r.wall_ticks[-1]):>6}"
                  + (f"  {gap:.2e}" if label == "mesh" else ""))

    print("\nthe mesh curves replay the paper's simulated results with the "
          "workers stacked on one device;\nasync uses the Section-4 "
          "geometric-delay cloud model on both backends (same draw).")


if __name__ == "__main__":
    main()
