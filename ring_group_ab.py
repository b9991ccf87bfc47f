#!/usr/bin/env python3
"""Times one checkout's group ring (``comm.ring.ring_all_reduce_group``,
one worker a process sharing one CUDA card) beside ``dist.all_reduce`` on
the same group, and G2's ring run, for comparison with another checkout.

In worlds of 4 and 8 ranks at (M, 524,288): ``dist.all_reduce``'s ms a
call before the checkout's ring has mapped anything, then ``chip_smoke.py``
G1 (``chip_smoke._g1_hops``): G1_CALLS calls back to back held against
``ring_all_reduce_plain`` bit for bit, masked and unmasked, their hop
launches and host waits (barriers and synchronizes), the ms a call of the
ring and of ``dist.all_reduce`` in turns (host clock, every rank, each the
mean of 5 calls enqueued back to back), one hop's device time, and each
step's time on rank 0 (an empty list where the checkout's ring has no
``step_events``).  Then G2's ring leg, ``torchrun`` sync delta over the
ring in 8 processes at 52 windows, and its ms a window.

    python3 ring_group_ab.py [--src DIR]

imports ``repro_torch`` from DIR (default: this checkout's ``src``) in
every rank and builds DIR's kernels, so two checkouts are compared on one
card by running it on each in turns (an older checkout unpacked with ``git
archive`` into a directory that ``.gitignore`` lists):

    python3 ring_group_ab.py --src OLD/src; python3 ring_group_ab.py
    python3 ring_group_ab.py; python3 ring_group_ab.py --src OLD/src

Prints one JSON line: ``src``, ``card`` (nvidia-smi's name and power
limit), for each world size rank 0's readings and every rank's checks, and
``g2_ring_window_ms``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import chip_smoke as cs


def _world(rank: int, world, cfg: dict) -> dict:
    """``dist.all_reduce``'s ms a call on a group of the world before any
    group ring has run in it, then G1 on this rank."""
    import torch

    from repro_torch.distributed import process_group
    from repro_torch.topology import Topology
    g = Topology.flat(world.world_size).make_groups().groups[0]
    y = torch.zeros(cfg["pg_n"], device=world.device)
    first = cs._pg_timed(lambda: process_group.all_reduce(y, "sum", g), g,
                         cfg["iters"], world.device)
    return {**cs._g1_hops(rank, world, cfg), "all_reduce_first_ms": first}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(cs.ROOT / "src"),
                    help="directory holding the repro_torch package")
    opts = ap.parse_args()
    src = Path(opts.src).resolve()
    if not (src / "repro_torch").is_dir():
        cs.fail(f"no repro_torch package under {src}")
    sys.path.insert(0, str(src))
    os.environ["PYTHONPATH"] = str(src)       # every rank imports DIR's
    import torch
    if not torch.cuda.is_available():
        cs.fail("ring_group_ab.py needs a CUDA card")
    from repro_torch.distributed import process_group
    from repro_torch.kernels import _build
    _build.library()                          # built before the ranks start
    cfg = {"g1_sizes": {w: (cs.PG_N,) for w in cs.PG_WORLDS},
           "pg_n": cs.PG_N, "iters": cs.PG_ITERS}
    res = {"src": str(src), "card": cs.card_line()}
    for w in cs.PG_WORLDS:
        outs = process_group.spawn(_world, w, cfg, device="cuda")
        g1 = outs[0]
        res[str(w)] = {
            "ring_ms": g1["times"][cs.PG_N]["group ring"],
            "all_reduce_ms": g1["times"][cs.PG_N]["dist.all_reduce"],
            "all_reduce_first_ms": g1["all_reduce_first_ms"],
            "barrier_ms": g1["barrier_ms"], "hop_ms": g1["hop_ms"],
            "step_ms": g1["step_ms"],
            "checks": [[list(key), ok, launched, len(waits)]
                       for o in outs for key, ok, launched, waits
                       in o["checks"]]}
    with tempfile.TemporaryDirectory(prefix="ring_ab_") as tmp_:
        tmp = Path(tmp_)
        out = tmp / "g2.pt"
        cs._torchrun(cs.M, cs.g2_full([]) + cs.G2_LEGS["ring delta"]
                     + ["--save-result", str(out)], tmp, "G2 ring delta",
                     {**os.environ, "OMP_NUM_THREADS": "1"})
        g2 = torch.load(out)
        res["g2_ring_window_ms"] = g2["wall_s"] / len(g2["distortion"]) * 1e3
    print(json.dumps(res))


if __name__ == "__main__":
    main()
