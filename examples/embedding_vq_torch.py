"""The paper's algorithm on a model's own tensor, on the PyTorch port:
cluster an LM's token-embedding table with the asynchronous delta scheme
(eq. 9, the original large-dataset clustering use), then assign every row
to its code with the assign kernel.

The port's counterpart of ``examples/embedding_vq.py``.  By default the
table is granite-8b's smoke config's (512 x 128); ``--full`` draws the
published config's weights on the card and clusters its (49,152 x 4,096)
table.  The weights are random, from the seed.

    PYTHONPATH=src python examples/embedding_vq_torch.py [--device cpu]
    PYTHONPATH=src python examples/embedding_vq_torch.py --full

The table is split over M workers (the paper's data distribution);
``core.async_vq.scheme_async`` runs eq. 9 on them; ``ops.distortion``
scores the whole table (eq. 2) before and after through the assign
kernel's min distances; and ``ops.vq_assign`` assigns every row.
"""

import argparse

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.core import async_vq
from repro_torch.kernels import ops
from repro_torch.models.api import get_api

M, TAU, KAPPA, N_EVAL = 8, 10, 64, 64
P_DELAY = 0.5
SEED = 0


def cluster(table: torch.Tensor, *, seed: int = SEED) -> dict:
    """Eq. 9 over the rows of ``table`` (V, d) f32, split over M workers,
    from KAPPA rows drawn with numpy from ``seed``.  Returns the distortion
    before and after, the codebook, and the assignment of every row with
    its min distance."""
    v, d = table.shape
    n = v // M * M
    data = table[:n].reshape(M, -1, d).contiguous()
    rows = np.random.default_rng(seed).choice(n, KAPPA, replace=False)
    w0 = table[torch.from_numpy(rows).to(table.device)].contiguous()
    before = float(ops.distortion(table, w0))
    res = async_vq.scheme_async(
        w0, data, data[:, :N_EVAL].contiguous(), tau=TAU, p_delay=P_DELAY,
        generator=torch.Generator().manual_seed(seed))
    w = res.w_shared.contiguous()
    after = float(ops.distortion(table, w))
    assign, mind = ops.vq_assign(table, w)
    return {"before": before, "after": after, "w": w, "assign": assign,
            "mind": mind}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_8b", choices=registry.ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="the published config's table (the card)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device_lib.pin_full_f32()
    dev = device_lib.resolve(args.device)
    cfg = (registry.get_config(args.arch) if args.full
           else registry.get_smoke_config(args.arch))
    params = get_api(cfg).init(SEED, device=dev)
    table = params["embed"].float().contiguous()           # (V, D)
    del params
    v, d = table.shape
    print(f"clustering {v} x {d} embedding table of {cfg.name} into "
          f"{KAPPA} codes ({M} workers, tau {TAU}, eq. 9 at p_delay "
          f"{P_DELAY}) on {dev}")
    out = cluster(table)
    before, after = out["before"], out["after"]
    print(f"distortion: {before:.5f} -> {after:.5f} "
          f"({(1 - after / before) * 100:.1f}% reduction)")
    sizes = torch.bincount(out["assign"].long(), minlength=KAPPA).cpu()
    print(f"code usage: min={int(sizes.min())} "
          f"median={int(sizes.median())} max={int(sizes.max())} "
          f"(of {v} rows)")
    if not after < before:
        raise SystemExit("the distortion did not fall")


if __name__ == "__main__":
    main()
