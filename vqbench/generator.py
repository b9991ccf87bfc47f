"""The one generator of the benchmark's inputs: a cell's configuration,
traffic mix and job length give a ``Plan``, and ``make_inputs`` draws its
stream, each shard's starting codebook and each shard's round lengths from
the seed.

The stream is the paper's synthetic data: an isotropic Gaussian mixture
over ``n_centers`` centers drawn uniformly in ``[0, 1]^d`` with noise
``noise``, M workers x ``points_per_worker`` points.  It is cut into shards
of ``job_points`` points a worker, laid out shard-major, so a job's data
is one contiguous (M, job_points, d) block.  A shard's starting codebook
is kappa distinct points of the stream, drawn at random for that shard
(the paper's initialisation; a shard may hold fewer than kappa points),
and its round lengths (eq. 9, where the mix draws them) are ``tau`` plus
Geometric(``p_delay``) extra ticks, ``floor(log u / log(1 - p))`` with u
uniform on [1e-7, 1).  Everything is made from the seed in a few large
calls on the device, except the round lengths, a small host table.  Every
seed gives the same sizes and the same work; only the values differ.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: Rows of the stream a center-adding pass takes at once (bounds the
#: temporary to 256 MiB).
_ROWS_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one cell runs: the shapes, the scheme and the job length."""

    scheme: str             # MeshExecutor.run's scheme, the launcher's --scheme
    flags: tuple            # the traffic mix's own launcher flags
    reference: str          # "<module>.<function>" of vqbench/reference
    step: str               # "window" (tau points a worker) or "tick" (one)
    p_delay: float | None   # round lengths' extra-delay probability, or None
    m: int                  # stacked workers
    kappa: int
    d: int
    tau: int
    eps0: float
    decay: float
    points_per_worker: int  # the stream held on the device, a worker
    job_points: int         # a job's points a worker (eq. 9: its ticks)
    n_eval: int             # eval points a worker (the shard's first)
    eval_every: int         # eq. 9: ticks between evals
    n_centers: int
    noise: float

    @property
    def shards(self) -> int:
        return self.points_per_worker // self.job_points

    @property
    def steps(self) -> int:
        """The steps of one job: its windows, or its ticks."""
        return self.job_points // self.tau if self.step == "window" \
            else self.job_points

    @property
    def rounds(self) -> int:
        """Round lengths a worker a job: the executor's (M, n // tau + 2)."""
        return self.job_points // self.tau + 2

    @property
    def points_per_job(self) -> int:
        """Points stepped in one job, all workers together."""
        return self.m * self.job_points


def make_plan(config: dict, traffic: dict, cell: dict) -> Plan:
    """A cell's plan from its configuration, traffic mix and cell files."""
    job_points = int(cell["job_points"])
    data = config["data"]
    lengths = traffic.get("round_lengths")
    plan = Plan(
        scheme=traffic["scheme"], flags=tuple(traffic.get("flags", ())),
        reference=traffic["reference"], step=traffic["step"],
        p_delay=None if lengths is None else float(lengths["p_delay"]),
        m=int(config["workers"]), kappa=int(config["kappa"]),
        d=int(config["d"]), tau=int(config["tau"]),
        eps0=float(config["eps0"]), decay=float(config["decay"]),
        points_per_worker=int(config["points_per_worker"]),
        job_points=job_points,
        n_eval=min(int(traffic["n_eval"]), job_points),
        eval_every=int(traffic["eval_every"]),
        n_centers=int(data["n_centers"]), noise=float(data["noise"]))
    if plan.step not in ("window", "tick"):
        raise ValueError(f"a step is a 'window' or a 'tick', not "
                         f"{plan.step!r}")
    if plan.shards < 1 or job_points < plan.tau:
        raise ValueError(f"job_points {job_points} must be at least tau and "
                         f"at most points_per_worker")
    if plan.m * plan.shards * job_points < plan.kappa:
        raise ValueError("the stream holds fewer points than kappa")
    if plan.steps % plan.eval_every:
        raise ValueError(f"a job's last eval must close it: its {plan.steps} "
                         f"steps are not a multiple of eval_every "
                         f"{plan.eval_every}")
    return plan


def shrink(plan: Plan, **sizes) -> Plan:
    """The plan at other sizes (tests on the CPU)."""
    out = dataclasses.replace(plan, **sizes)
    return dataclasses.replace(out, n_eval=min(out.n_eval, out.job_points))


@dataclasses.dataclass
class Inputs:
    """The benchmark's inputs, which both the program and the reference get:
    the stream (shards, M, job_points, d), each shard's starting-codebook
    rows (shards, kappa) into the stream's (shards * M * job_points, d)
    points, and
    each shard's round lengths (shards, M, rounds) int32 on the host, or
    None where the mix draws none."""

    stream: torch.Tensor
    w0_rows: torch.Tensor
    lengths: torch.Tensor | None

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.stream, self.w0_rows))


def _geometric_lengths(gen: torch.Generator, shape, *, tau: int,
                       p_delay: float) -> torch.Tensor:
    u01 = torch.rand(shape, generator=gen, dtype=torch.float32)
    lo = torch.tensor(1e-7, dtype=torch.float32)
    u = torch.maximum(lo, u01 * (1.0 - lo) + lo)
    den = torch.tensor(math.log1p(-p_delay) if p_delay < 1.0 else -math.inf,
                       dtype=torch.float32)
    extra = torch.clamp(torch.floor(torch.log(u) / den).to(torch.int32),
                        min=0)
    return tau + extra


def make_inputs(plan: Plan, seed: int, device: torch.device) -> Inputs:
    """Draw the cell's inputs from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s, m, p, d = plan.shards, plan.m, plan.job_points, plan.d
    centers = torch.rand((plan.n_centers, d), generator=gen, device=device)
    stream = torch.randn((s, m, p, d), generator=gen, device=device)
    stream.mul_(plan.noise)
    which = torch.randint(0, plan.n_centers, (s * m * p,), generator=gen,
                          device=device)
    flat = stream.view(-1, d)
    step = max(1, _ROWS_ELEMS // d)
    for lo in range(0, flat.shape[0], step):
        flat[lo:lo + step] += centers[which[lo:lo + step]]
    del which
    w0_rows = torch.stack([
        torch.randperm(s * m * p, generator=gen, device=device)[: plan.kappa]
        for _ in range(s)])
    lengths = None
    if plan.p_delay is not None:
        host = torch.Generator()
        host.manual_seed(seed)
        lengths = _geometric_lengths(host, (s, m, plan.rounds), tau=plan.tau,
                                     p_delay=plan.p_delay)
    return Inputs(stream=stream, w0_rows=w0_rows, lengths=lengths)


def job_inputs(plan: Plan, inputs: Inputs, job: int, *,
               points: int | None = None):
    """(w0 (kappa, d), data (M, points, d), eval_data (M, n_eval, d),
    lengths (M, points // tau + 2) or None) of job ``job`` on shard ``job mod
    shards``; ``points`` (default: the job length) cuts the job short, for
    the warm-up."""
    shard = job % plan.shards
    block = inputs.stream[shard]
    points = plan.job_points if points is None else points
    w0 = inputs.stream.view(-1, plan.d)[inputs.w0_rows[shard]]
    data = block[:, :points]
    eval_data = block[:, : plan.n_eval]
    lengths = (None if inputs.lengths is None
               else inputs.lengths[shard, :, : points // plan.tau + 2])
    return w0, data, eval_data, lengths
