#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA:

  1. prints the card's name and power limit, builds the port's CUDA kernels
     from src/repro_torch/kernels/csrc with nvcc, and prints the build time;
  2. holds each kernel against its plain PyTorch version on the card at the
     slice's width (M=8 workers, kappa=4096, d=128, tau=10): the window
     kernel over 20 windows, the delta kernel at batch 1 (the per-step
     shape) and batch 1000 (the eval shape), and both at a ragged shape
     that divides none of their block sizes;
  3. checks that the window kernel gives the same codebook, bit for bit, as
     the per-step path through the delta kernel, window by window; then
     the argmin engine's two routes in the delta kernel (the one-launch
     sweep at B = 1, 2 and 8, the tiled argmin at B = 9), each against the
     plain version and, bit for bit, against the assign kernel's (assign,
     mind); the sweep called
     1,000 times back to back on new points, each result against the
     plain version, and replayed 10 times from a CUDA graph holding two
     sweeps, each replay equal to eager calls bit for bit and the tickets
     0 after; the window plan (``vq_fused._window_plan``) at d=128, at
     d=3072 and under a 100,000 B budget, with how many resident clusters
     the card holds at once; and the window kernel's resident route at M =
     1 and 3, at a ragged kappa with register rows and at kappa = 5, and
     its streaming route at d=128 under that budget, against the per-step
     path, bit for bit;
  4. holds the assign kernel against its plain version at the serving
     flush shape (128 x 4096 x 128), the eval shape ((8, 1000) x 4096 x
     128), the ragged shape and the eq.-9 tick's (8, 1) x 4096 x 3072 (the
     last against the plain version in float64, see BLOCKED_REF), and
     against the delta kernel's (assign, min distance), which it must
     equal bit for bit; then the tiled argmin (B > 8) at B = 9, 128 and
     1000 (and 9 at d=3072) against the sweep over the same points taken 8
     at a time, (assign, mind) bit for bit, each call one CUDA launch (the
     engine's host count, ``vq_assign.cuda_launches``);
  5. drives the main path, ``repro_torch.launch.train --mode vq --executor
     mesh``, on 8 x 125,000 points for ``--scheme delta`` and then
     ``--scheme average``, and the per-step (``fused=False``) route on the
     first 2,000 points of each worker, with every kernel's launch count
     set to 0 before each run and read after it;
  6. compares each run's first 20 windows with the port's own oracles
     (``core.schemes.scheme_delta`` / ``scheme_average``) on the card;
  7. serves the delta run's codebook with ``repro_torch.launch.serve --mode
     vq`` (kappa=4096, d=128): 10,000 one-vector requests under the
     geometric arrival process, then 10,000 saturating ones; checks that
     none failed, that versions are monotonic, that 1,000 sampled responses
     equal the plain version, and that the assign kernel ran once per flush
     and warm-up; then four more geometric legs, with the launcher's
     ``gc.freeze()`` off, on, on, off, read what the freeze does to p99;
  8. runs eq. 9, ``--scheme async_delta --network geometric``, on 8 x
     25,000 points (cut from 125,000, ASYNC_TICKS): one delta-kernel launch per tick and no window-kernel
     launch, its first 200 ticks held against the port's oracle
     (``core.async_vq.scheme_async``) on the same round lengths, and its
     final distortion below the initial one and below twice the sync delta
     run's;
  9. holds the top-k kernel against its plain version on the card, bit for
     bit (vals, idx, residual), with one counted launch a call, at (8,
     524,288) with k = 5,242, 524, 1 and 524,288, the window displacement
     also at k = its rows' non-zero counts and those +- 1 (the T = 0 early
     exit on either side), at a ragged (3, 40,040) with k = 37, on a
     tie-heavy input (mostly zeros of both signs, repeated magnitudes of
     both signs) with k cutting through a tie, and on 0.5 tie runs across
     every slice boundary of the (8, 524,288) row, cut at a boundary; and
     prints the launch plan of each shape (8-block clusters, slice length);
  10. runs the sparse transport: ``--scheme delta --transport sparse
     --compress-frac 0.01`` on 8 x 125,000 points, which must give the
     dense delta run's curve and codebook bit for bit (k = 5,242 keeps every
     entry a window can touch, tau * d = 1,280), with one top-k launch per
     window and 3,669,400,000 B of merge wire per worker; the lossy
     ``--compress-frac 0.001`` (k = 524) on 8 x 20,000 points, its first 20
     windows held bit for bit against a loop written out here (window
     kernel, payload + residual, the plain selection, the sum); and eq. 9
     over the sparse transport for 10,000 ticks on the dense eq.-9 run's
     round lengths, whose curve must equal the dense run's head bit for bit;
  11. holds the blocked assign+delta kernel against the delta kernel, bit
     for bit (assign, mind, counts, zsum), at (8, 1) and (8, 1000) x 4096 x
     128; against its plain version at d=3072 ((8, 1), (8, 8) and (8,
     1000) x 4096, the epilogue also on a residual with +0 and -0 entries)
     and at ragged shapes, past the sweep's staging limit (d=8000 at B =
     1, 9 and 13), with its epilogue equal to the eager expression on its
     own outputs bit for bit; each blocked call at B <= 8 one CUDA launch;
     and ``ops.vq_delta_topk``'s blocked branch
     against its full-kernel branch at d=128, bit for bit;
  12. runs eq. 9 at d=128 through the blocked route (the shared-memory
     budget forced down) for 2,000 ticks, which must equal the dense run's
     head bit for bit with one blocked launch per tick;
  13. drives eq. 9 on a 3072-wide embedding codebook (kappa=4096, M=8,
     2,000 ticks per worker, cut for time) through the launcher: one
     blocked launch per tick and no delta or window launch, distortion
     falling, its first 200 ticks held against ``scheme_async`` under the
     flip rule and, with ``fused=False`` (assign kernel + ``index_add_``),
     equal to the blocked route bit for bit; then the sync delta scheme at
     that width on 8 x 2,000 points, the window kernel against the
     per-step loop through the blocked kernel, window by window, bit for
     bit;
  14. runs the tile tuner's search on the eq.-9 shape and shows the tuned
     tiles give the untuned tiles' bits;
  15. holds the ring all-reduce kernel against its plain version, bit for
     bit, with one launch a call, at (8, 524,288) (a window's displacement,
     N(0, 1) entries, and N(0, 1) under a 0/1 mask), (8, 1) (the eval
     payload), ragged (3, 40,040) and (5, 1,000,003), (8, 524,285) (chunk
     a multiple of 4, N not), (5, 999,996) (the float4 route with a short
     last chunk, plain and masked), and (8, 12,582,912) (the d=3072
     payload, 402.7 MB), and prints the largest |ring - torch.sum| as a
     read-out (the orders differ); then the top-k kernel on the d=3072
     payload at k = 1% (402.7 MB, past L2), bit for bit;
  16. drives ``--scheme delta --transport ring`` on 8 x 125,000 points
     through the launcher: 12,500 window and 25,000 ring launches (merge and
     eval) and no other, 3,670,016 B of merge wire a window, its curve and
     codebook held against the dense delta run's (CURVE_RTOL, ROWS_FRAC),
     its first 200 windows equal bit for bit to runs over
     ``RingTransport().plain()`` and ``quant[identity:ring]`` and held
     against a dense run of those windows; ``--scheme average --transport
     ring`` on 8 x 2,000 points (400 ring launches) against dense average;
     eq. 9 over the masked ring for 10,000 ticks on the dense eq.-9 run's
     round lengths (20,000 delta and 22,000 ring launches), its curve and
     codebook held against a dense eq.-9 run of those ticks and its first
     2,000 ticks equal to the plain-ring run bit for bit; and
     ``--transport ring --wire-quant int8`` on 8 x 20,000 points (917,508 B
     of wire a window, 4,000 ring launches, distortion falling);
  17. runs the comm layer at full width, M = 8 as 2 host groups of 4
     (``--hosts 2``): the top-k kernel on a tier-1 payload ((2, 524,288),
     k = 1,024, and (2, 1) at k = 1) and the ring kernel on a host group's
     rows ((4, 524,288)) against their plain versions, bit for bit; both
     tiers dense on 8 x 20,000 points, equal bit for bit to the flat dense
     run (3,145,728 / 2,097,152 B a window on tiers 0 / 1), and over
     ``--transport ring`` to the flat ring run with the same ring launches;
     a sparse tier 1 (k = 1,024) at full depth: 12,500 window and top-k
     launches, 3,145,728 / 8,192 B a window, its first 20 windows held
     against ``use_kernels=False`` and its final distortion within 25% of
     the flat dense run's; eq. 9 over the hierarchy for 10,000 ticks (a
     delta and a top-k launch a tick) and, with a dense tier 1, equal to the
     flat eq.-9 run over 2,000 ticks bit for bit; ``--merge dynamic`` at
     threshold 0 equal to plain delta bit for bit (7 B of probe a window),
     then at full depth at T, the median probe of that leg, and over
     ``--wire-quant int8`` (cut); ``--quorum`` without lateness equal to
     plain delta bit for bit, then ``--network geometric --p-delay 0.2`` at
     full depth (late worker-windows as the numpy late matrix counts them,
     3,670,023 B a window); the ``Tier1BudgetController`` from frac 0.5 in
     chunks of 100 windows, its trajectory equal to the ladder replayed on
     the host, the top-k kernel at each k of it against plain; times the
     two new kernel shapes and traces 200 windows of the sparse-tier-1
     leg;
  18. runs chaos, elastic resizes and checkpoints (``elastic_legs``), each
     leg with the launch counts set to 0 before it and read after: E1,
     ``--resize 4000:4,8000:8 --ckpt-dir`` at full depth through the
     launcher, observed (``--metrics``: its ``resize_events``,
     ``late_delta_points`` and ``resize`` spans == its ``ResizeStats``, a
     divergence launch a window)
     (14,499 windows, 40 late points, 14,500 window launches: one
     is the late delta's, over the departing workers' (4, tau, d) stack),
     its first 4,000 windows equal bit for bit to the fixed-M delta run,
     its final distortion within 1e-2 of it, one 2,097,152 B ``late_delta``
     record, checkpoints at 4,000 and 8,000, each resize's ``wall_s`` and
     checkpoint save time printed; E2, ``--resume`` from step 8,000, equal
     to E1's last 6,499 windows bit for bit; E3, ``checkpoint_every=750``
     on 20,000 points a worker (cut), resumed from step 1,500 bit for bit;
     E4, ``--hosts 2 --tier1-transport xla --resize 500:4,1000:8`` on
     20,000 points (cut), equal bit for bit to the flat elastic run, its
     late delta charged 2,097,152 B on tier 1; E5, ``--chaos
     7:kill=2,slow=1,part=1`` at full depth, resizes with cause
     ``chaos_kill`` at the kill windows and the late worker-windows equal
     to the segments' numpy late matrices, observed too (``chaos_kills``
     twice the kills, the reference's count; ``chaos_late_worker_windows``
     == the late matrices); E6, eq. 9 over a
     ``ChaosNetwork`` (a slowdown, a kill) for 10,000 ticks (cut), one
     delta launch a tick, the dead worker's rounds never completing, its
     first 200 ticks held against ``scheme_async``;
  19. runs the thread runtime, training while serving and the trace/metrics
     layer (``threads_serving_obs_legs``), each leg with the launch counts
     set to 0 before it and read after: T1, ``--executor thread --scheme
     async_delta`` on 8 x 125,000 points for 5 s (one window launch at (1,
     tau, d) a round: window launches == the workers' pushes, no other
     launch; every worker pushes; the distortion falls; points/s, rounds/s,
     the stale-read share, the inbox's peak depth and the window plan at
     M = 1 printed; T1 again without the inbox's bound, a read-out; and
     rounds/s at M = 1, 2, 4 for 1 s each, a read-out); T2, a 50x
     straggler for 3 s (worker 0 takes fewer points than each other); T3,
     ``--comm-delay-s 0.01`` for 3 s; T4, 8 threads x 200
     ``BlobStore.apply(+1)`` on a (4096, 128) device tensor (version 1,600,
     every entry 1600.0); S1, ``launch.serve --train-publish`` (an elastic
     trainer at M = 8, 4, 8 on 8 x 20,000 points publishing every 10
     windows, 10,000 geometric requests): no failure, monotonic versions,
     more than one served, 1 + its ``on_window`` calls published, window
     launches == windows + late deltas and assign launches == flushes +
     warm-ups, 1,000 sampled answers == plain on their version's codebook,
     the trace clean with flush, load and window spans, p50/p99 beside
     phase 7's; O1, the divergence kernel (an observed window's
     ``||w_local - w_shared||^2`` in one pass; no TPU kernel's counterpart)
     against its plain version at (8, 4096, 128), a ragged and a
     misaligned shape, one launch a call, and 1,000 calls back to back
     with the same bits and the tickets left 0; then ``--scheme delta`` on
     8 x 25,000 points (O1_POINTS, cut from full depth), two pairs of bare
     and observed runs in turns (``--trace --metrics``, the collector run
     before each): curve and codebook the same bits in every run, 2,500
     divergence launches an observed run, ``windows_total`` 2,500, the
     ``comm_*`` counters ==
     ``CommLog.summarize``, 3,670,016 B of merge a window, their wall
     ratio a read-out; the divergence kernel's inputs captured on the
     observed path for 20 windows, its outputs and the emitted
     ``codebook_divergence`` series against plain; the gate: 16 pairs of
     500-window blocks, bare and observed in turns in one process, the
     reference's estimator (the smaller of the best-of-16 ratio and the
     median pair ratio) <= 1.03; and eq. 9 for 5,000 ticks, two pairs of
     bare and observed runs in turns, bit for bit, their ratios a
     read-out;
  20. runs the roofline profiler, the report, the comm dry run and the
     examples (queue 1, items 6b and 7), hung where it can be on runs the
     script already makes: P1, O1's two observed sync delta runs carry
     ``--profile``: each one attribution with consistency <= 0.15 (the
     reference's bar), its four terms summing to the attributed window,
     ``collective_bytes_per_window`` x 2,500 == the run's ``CommLog``
     logical bytes, loops (2,500 windows, 10 steps), the
     ``roofline_efficiency`` gauges and ``attributed_*_ns`` counters in the
     registry, each term printed in us a window with the card's name and
     power limit (O1's bits and launch counts hold as before); P2, O1's
     observed eq.-9 run (5,000 ticks) carries a ``Profiler``: 500
     nominal windows, the same checks; P3, E1 carries ``--profile``: one
     attribution over its 3 M-segments, the same checks; P5, the d=3072
     sync run (2,000 points a worker) carries ``--profile``, its terms and
     consistency a read-out (one divergence launch a window); then, all at
     once as subprocesses: P4, ``python -m repro_torch.launch.train
     --mode vq --executor mesh --scheme average --profile`` on 8 x 20,000 points
     (exit 0, its export's loops and consistency), ``--executor sim
     --profile`` (exit 2), and the export rendered by ``python -m
     repro_torch.obs.report --profile`` (the attribution section in the
     HTML); P6, ``python -m repro_torch.launch.dryrun --comm`` (exit 0, its
     bytes == ``BENCH_comm.json`` and ``BENCH_hier.json``, the adapt cells
     held to ``BENCH_adapt.json``'s prices); P7, the five VQ
     ``examples/*_torch.py`` and ``train_lm_torch.py`` (its 80.75 M-parameter
     model, 300 steps, a simulated failure and restart) (exit 0), with
     their wall seconds;
  21. runs one worker a process on the one card (``process_group_legs``;
     gloo over CUDA tensors, NCCL refusing two ranks on one device; the
     kernels are built here before any rank starts): G1, the hop kernel
     (``csrc/vq_ring_hop.cu``, the ring's hops over CUDA IPC, waiting for
     each other on the card through stream waits on the ranks' progress
     counters) in worlds of 4 and 8 ranks at (M, 524,288) and (4,
     1,000,003): 3 calls back to back on different inputs with no host
     sync between them, every rank's results == ``ring_all_reduce_plain``
     of the stacked rows bit for bit, masked and unmasked, with 2 (M - 1)
     hop launches a call and no ``dist.barrier`` or synchronize among them;
     its ms a call beside ``dist.all_reduce``'s on the same group (in
     turns, each the mean of 5 calls enqueued back to back), each step of
     one call on rank 0's stream, its waits on the neighbours included
     (CUDA events), one hop's device time and the one-card fold's; G2,
     ``torchrun --standalone
     --nproc-per-node 8 -m repro_torch.launch.train --scheme delta
     --transport ring`` at the slice's width cut to 52 windows, its
     codebook == the stacked ring run's bit for bit (first checking that a
     (1, tau, d) window launch and a (1, n, d) eval give row i of the
     (8, ...) ones; where they do not, the legs are held at rtol=1e-4,
     atol=1e-6), each rank's launches read from the launcher (52 window
     and 1,456 hop launches a rank); then, through the executor in G1's
     world of 8 (the launcher's inputs, no torchrun start of ~30 s each),
     the dense gloo transport on 52 windows at rtol=1e-4 against the
     stacked ring and ``average`` over the ring on 60 windows bit for bit;
     each window's wall beside the stacked run's; G3,
     eq. 9 in 4 processes for 1,200 ticks over the group ring on the
     stacked run's round lengths, == the stacked masked ring bit for bit,
     one delta launch a rank a tick; G4, ``shard_batch`` and
     ``shard_kappa`` at kappa 4,096 and 4,099 (d 128, 128-row flushes) ==
     direct bit for bit on every rank; G5, the dvq group window step ==
     the stacked one, the minibatch step over 2 x 2 ranks == the unsharded
     step (assignments, counts), and ``launch.dryrun --arch paper_vq``'s
     two cells exit 0 with their terms; G6, NCCL at world size 1, its
     dense group sum == the stacked one (the multi-GPU leg is unverified
     on one card);
  22. runs the LM serving path (``lm_serving_legs``, queue 1, item 8a): (a)
     the main path, ``repro_torch.launch.serve --mode lm --arch granite_8b``
     at the published config (36 layers, d_model 4,096, bf16, 8.25 B
     params drawn from the seed on the card) with the launcher's defaults,
     3 waves of 4 requests x 16 prompt tokens + 16 generated, no kernel
     of the port's own launched (the reference runs this path on XLA):
     init seconds, prefill ms and decode ms a token against the
     weight-read bound, tok/s, the peak device memory, and one wave under
     torch.profiler (busy share, device operations a step); (b) on the
     same model: ``run_lm`` twice from the same seed draws the same
     weights and serves the same greedy tokens, prefill's last logits == forward's, teacher-forced decode vs
     ``forward`` within LM_DECODE_REL, and the int8 serve step
     (``quantize_tree``, dequantized a layer at a time): logits'
     correlation with bf16 > LM_CORR, its ms a step in turns with bf16's;
     (e) the paper's algorithm on the model's (49,152 x 4,096) embedding
     table (``examples/embedding_vq_torch.py``'s ``cluster``: eq. 9 on 8
     workers, kappa 64): the distortion falls, 3 assign launches, the
     assign kernel against its plain version in float64 (flips only at
     near-ties, counts moved by the flips only, min distances under the
     FLIP_REL rule, eq. 2 == the mean of those min distances within
     DIV_RTOL), and its time; (c) the other nine configs at full width,
     at full depth where their bf16 weights are under LM_FULL_DEPTH_GB
     and at LM_CUT_LAYERS layers otherwise (the cut printed; MoE
     dropless), one wave each whose prefill + decode logits match
     ``forward``'s within LM_DECODE_REL, with the count of logits that
     differ and layer 0's projections whose rows take other bits at the
     decode step's M than at the forward's (the gap's source); the MoE
     also served again (the same bits), its layer-0 MoE over the block
     == one token at a time, and one wave at the published
     capacity_factor served twice (finite, the same bits); hymba at its 32 layers with a 1,152-token prompt (past its 1,024
     window) and 16 decode steps; (d) the ten smoke configs in f32 with
     TF32 off, the card's forward and prefill + 4 decode steps == the
     CPU's at rtol=1e-4, atol=1e-5;
  23. runs LM training on one card (``lm_training_legs``, queue 1, item
     8b-1), with no kernel of the port's own in the train step (the
     reference runs it on XLA): (a) the main path, ``repro_torch.launch.train
     --mode lm --arch granite_8b`` through ``run_lm`` at the published width
     (d_model 4,096, GQA 32/8, d_ff 14,336, vocab 49,152, bf16) with the
     depth cut to 8 of 36 layers (2.148 B params; AdamW's 12 B a parameter
     is 99 GB at 36) and the launcher's defaults (8 x 64 tokens, lr 1e-3,
     AdamW, the state donated), 40 steps (60 until item 26): every loss
     and grad norm finite,
     the last 10 steps' mean loss below the first 10's, the peak memory;
     then 5 steps timed and traced (ms a step, tok/s, busy share, the
     largest kernels) beside the bound (6 N T FLOPs at the bf16 peak plus
     AdamW's 22 B a parameter at the HBM rate); hymba-1.5b, mamba2-2.7b
     and whisper-tiny at full depth and olmoe and internvl2 at 2 layers,
     full width, 5 steps each (10 until item 26; finite, the params
     moved); (b) granite-8b
     at 2 layers (838.9 M params, an 8.4 GB checkpoint; the free disk
     printed): two straight 20-step runs bit for bit, and 20 steps with
     ``--ckpt-every 10``, the step-20 checkpoint removed, ``--resume`` from
     step 10 == the straight run bit for bit; (c) the ten smoke configs in
     f32 with TF32 off, one step's loss and grads and the params after 3
     SGD steps, the card == the CPU at rtol=1e-4, atol=1e-5 x max|x|; (d)
     the window step, granite-8b at 2 layers with M = 2 replicas (every
     replica keeps its AdamW state: M = 4 does not fit) and whisper-tiny
     with M = 8, tau = 2, each merge for 2 windows (AdamW; DELTA and
     DELTA_SPARSE also under SGD at frac 0.01 and 1.0): loss finite, step
     == 2 tau, params moved, the merged params one tensor the replicas
     share under ALLREDUCE, AVERAGE and DELTA, a residual at frac 0.01,
     DELTA_SPARSE at frac 1.0 == DELTA bit for bit under SGD, one top-k
     launch a float leaf a sparse merge; the top-k kernel on the captured
     merge payloads of the embedding ((2, 201,326,592), k = 2,013,265) and
     the final norm ((2, 4,096), k = 40) against its plain version, bit
     for bit, and timed at (4, 201,326,592) in turns with ``torch.topk``;
  24. runs the paper's cloud merges with one worker a process
     (``cloud_process_legs``, queue 1, item 9c-1), after item 21, in a
     spawned world of 8 ranks on the card (G7's eq. 9 in 4), every leg
     built as the launcher builds it over the world's groups, held
     against the stacked run of the same configuration, with every rank's
     launches counted: G7, ``--transport sparse --compress-frac 0.01``,
     60 windows (cut), codebook and curve == the stacked sparse run bit
     for bit, 293,552 B of merge wire a merge, a top-k launch a merge, and
     eq. 9 over sparse in 4 processes for 1,200 ticks (cut) == the stacked
     run; G8, ``--hosts 2 --transport ring`` with the default sparse tier 1
     (k = 1,024), 60 windows, == the stacked run bit for bit (the ring
     tier 0 keeps the stacked fold), 3,145,728 / 8,192 B a window; G9,
     ``--quorum --network geometric --p-delay 0.2``, 60 windows, late
     worker-windows == the stacked run's and the numpy late matrix's; G10,
     ``--merge dynamic`` over the ring, 60 windows each (cut): at
     threshold 0 == ``--scheme delta`` over the ring bit for bit, at item
     17's T every rank's trigger bits == the stacked run's; G11, the
     tier-1 controller from frac 0.5 in chunks of 30 windows, every
     rank's frac sequence == the stacked run's; G12, ``--chaos
     7:kill=0,slow=1,part=1 --hosts 2``, late worker-windows == the
     stacked run's and the schedule's matrix; G13, G7's width over the
     ring through ``launch.train.run_vq`` with ``--trace --metrics
     --profile`` (rank 0 writes the files): ``check_trace`` clean, the
     ``comm_*`` mirror == the ``CommLog``, the profiler's non-host terms
     == the stacked run's, a divergence launch a window on every rank;
     each leg's wall a window beside the stacked run's; the top-k kernel
     at a rank's (1, 524,288) payload against plain and timed beside
     ``torch.topk``;
  25. runs elastic runs and the quantization service with one worker a
     process (``elastic_serve_process_legs``, queue 1, item 9c-2), after
     item 24, in one spawned world of 8 ranks on the card, each leg held
     against the stacked run of the same configuration, every rank's
     launches counted: G14, ``--resize 100:4,200:8 --ckpt-dir`` (E1's shape
     cut to 2,500 points a worker, 299 windows; 3,000 until item 26):
     codebook and curve == the
     stacked run bit for bit or, where gloo's sums take another order,
     the curve within rtol 1e-4 (its largest gap printed), resize events,
     late points and the whole ``CommLog`` (the ``late_delta`` record) ==
     the stacked run's, every rank's window launches == the windows of the
     segments it took part in plus its late delta, its wall a window and
     each resize's ``wall_s`` beside the stacked run's; G15, ``--resume``
     from G14's step-200 checkpoint and from its step-100 one (ranks 4-7
     idle until the grow), each == the straight G14 run's suffix bit for
     bit; G16, ``--chaos 7:kill=2,slow=1,part=1`` on 100 windows, the kills
     resizes 8 -> 7 -> 6, events and late worker-windows == the stacked
     run's; G17, ``--hosts 2 --tier1-transport xla --resize 50:4,100:8``,
     200 windows, per-tier bytes == the stacked run's and the late delta
     on tier 1; G18, ``launch.serve --mode vq`` over the 8 ranks at kappa
     4,096, d 128 (the ``shard_kappa`` plan) and with ``shard_batch``
     forced (``ShardedLookup(mode=)``), 10,000 geometric requests each: 0
     failed, versions monotonic, 1,000 sampled responses == plain, every
     flush and warm-up == the one-process direct plan on its own batch bit
     for bit, every rank's assign launches == flushes + warm-ups, q/s and
     p50/p99 beside item 7's direct serve; G19, ``--train-publish`` over
     the 8 ranks (S1's shape cut to 2,000 points a worker, a publication
     a window): 0 failed,
     versions monotonic, at least 2 versions served, the publications and
     the trainer's events == the stacked run's; to pay for it, item 8's
     eq. 9 went from 125,000 ticks to 25,000, O1's four runs from 12,500
     windows to 2,500 and its eq.-9 pairs from 20,000 ticks to 5,000, the
     sparse and ring eq.-9 legs, eq. 9 over the hierarchy and E6 from
     20,000 ticks to 10,000, and G2 from 200 windows to 100; to pay for
     item 26, G2's ring and gloo legs went to 52 windows, item 24's legs
     from 200 windows to 100 and G16 from 200 to 100; to pay for item 27,
     item 24's legs went to 60 windows and item 26's L2 to 3 steps;
  26. runs the LM's placement over processes (``placement_legs``, queue
     1, item 8b-2), after item 23, in one spawned world of 2 ranks sharing
     the card (gloo over CUDA tensors; NCCL refuses two ranks on one
     device) and one torchrun start, with no kernel of the port's own (the
     reference compiles this path with XLA; every rank's counts 0), each
     leg against the one-process run: L1, ``torchrun --standalone
     --nproc-per-node 2 -m repro_torch.launch.train --mode lm --arch
     granite_8b --smoke --data-axis 2``, 20 steps with ``--ckpt-every 10``
     (the straight run through the launcher's torchrun path inside the
     world), the step-20 checkpoint moved aside and ``--resume`` from step
     10 under torchrun == the straight run bit for bit, rank 0's lines the
     reference's; L2, granite-8b at its published width through ``run_lm``
     over the (2, 1) grid, its depth the smaller of what the memory rule
     allows (two AdamW replicas on the card, the gloo staging on the host)
     and PL_L2_LAYERS, 10 steps (finite, the ranks equal, ms a step beside
     the one-process run at that depth on rank 0, each rank's peak), the
     f32 bucket's all-reduce timed alone, and in f32 with TF32 off 3 SGD
     steps == the one-process step on the whole batch at rtol=1e-4,
     atol=1e-5 max|x|; L3, olmoe-1b-7b at its published config and full
     depth (64 experts, 32 a rank, dropless) with ``moe_ep`` over a (1, 2)
     grid: forward logits == the one-process forward within LM_DECODE_REL,
     each rank's expert leaves == its ``local_shard``, and in f32 at 2
     layers logits, loss and every grad == the one-process ``moe_apply``
     run (L2's rule); L4, granite-8b at its published width and 4 layers,
     2 stages of 2 over a (2, 1, 1) grid, 4 microbatches of 8 x 64 tokens:
     the bf16 loss within PP_BF16_RTOL of the plain loss, in f32 the loss
     and grads == the plain ones (L2's rule), a forward + backward's wall
     beside the one-process one; L5, ``python -m
     repro_torch.launch.dryrun --all`` as a subprocess beside the world:
     exit 0, 80 records, the skips ``cell_applicable``'s, every one of the
     64 ok records with a numeric collective term lowered from the placed
     program (item 27 (d)), granite-8b x train_4k at 16x16 printed, and the
     roofline's LM terms on one device at item 22's decode and item 23's
     step; L2 runs 3 steps (10 until item 27);
  27. runs the reference's placement as a program (``tensor_parallel_legs``,
     queue 1, item 8c), after item 26, in one spawned world of 2 ranks
     sharing the card (gloo over CUDA tensors), granite-8b at its published
     width (d_model 4,096, GQA 32/8, d_ff 14,336, vocab 49,152) cut to 2
     layers, each leg against the one-process run: (a) tensor parallelism
     and the sequence-parallel residual stream over a (1, 2) grid, one
     forward + backward + gradient sync of 4 x 64 tokens: the bf16 loss
     within PP_BF16_RTOL, in f32 (TF32 off) the loss and every gradient
     shard within TP_GRAD_RTOL of its leaf's largest; (b) FSDP and data
     parallelism over a (2, 1) grid, one f32 AdamW step: loss, grad norm
     and each rank's param shards at L2's rule where |g| >= TP_RESOLVED of
     its leaf's largest (every entry a read-out), then one f32 SGD step
     over the same grid: loss, grad norm and every entry of each rank's
     param shards at L2's rule; (c) greedy decoding of 4
     rows (item 22's batch), a 16-token prompt and 8 tokens, over the
     cache's 24 positions split over the (1, 2) grid, in f32 (bf16's
     near-ties can flip a greedy token between two summation orders):
     tokens == one process; each placed step's collectives by kind, as
     its ranks recorded them, == ``hlo_analysis.lower_cell``'s for the
     same step; every rank's kernel counts 0 (no kernel on this path); the
     ms of each leg beside one process;
  28. times each kernel (the delta sweep also at each kchunk the tuner
     weighs; the assign kernel at the flush, the eval and (8, 1) x 4096 x
     3072; the blocked kernel at (8, 1) x 4096 x 3072 with and without the
     epilogue and at (8, 1) x 4096 x 128; the window kernel also at M = 1,
     the thread runtime's round; the divergence kernel), its plain version,
     its bound
     and, for the top-k
     kernel, ``torch.topk`` (selection only, also on the d=3072 payload),
     for the ring kernel ``torch.sum(x, dim=0)`` (each in turns with its
     library call), all on one yardstick (``kernel_ms``: CUDA events around
     each call, 1 GiB read before it to flush L2, so inputs come from
     device memory as the bound assumes), beside each kernel's CUDA-event time
     over back-to-back calls (L2 warm, the wrapper's host time included);
     and traces 200 windows of the
     sync delta path (bare, then observed), 1,000 ticks of the eq.-9 path, 200 windows of the
     sparse eq.-8 path, 200 windows of the ring sync path and 200 ticks of
     the 3072-wide eq.-9 path with torch.profiler (device time by kernel, the
     device's idle share), after timing 200 dense and ring sync windows in
     turns on the host clock;
  29. prints one ``{"kernels": [...]}`` line (window, delta, assign,
      top-k, blocked, ring and the ring's hop kernel), the card line
      again, and last
      ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Any failed check exits non-zero before the result lines; an exception
prints its traceback to stdout first.  It needs no network and imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the slice's width: a SIFT1M-shaped deployment (see PERF.md)
M, N_PER, D, KAPPA, TAU, N_EVAL, SEED = 8, 125_000, 128, 4096, 10, 1000, 0
CHECK_WINDOWS = 20      # windows held against the plain version / oracle
UNFUSED_POINTS = 2000   # depth of the per-step (fused=False) leg
PROFILE_WINDOWS = 200   # windows traced by torch.profiler
PROFILE_TICKS = 1000    # eq.-9 ticks traced by torch.profiler
FLUSH_ROWS = 128        # the service's padded flush (batch_align)
SERVE_REQUESTS = 10_000  # one-vector requests, SIFT1M's query-set size
SERVE_SAMPLE = 1000     # served rows held against the plain version
ASYNC_CHECK_TICKS = 200  # eq.-9 ticks held against the oracle
P_DELAY = 0.5           # the paper's geometric delay parameter
SPARSE_FRAC = 0.01      # the launcher's --compress-frac default
LOSSY_FRAC = 0.001      # k = 524 < tau * d: the selection drops entries
LOSSY_POINTS = 20_000   # depth of the lossy sparse eq.-8 leg
SPARSE_TICKS = 10_000   # depth of the sparse and ring eq.-9 legs (cut from
                        # 20,000, 11.9 + 7.7 s and the dense comparison
                        # on an H100 at 700 W, to pay for item 25)
# a text-embedding-3-large-shaped codebook (see PERF.md): d=3072 is past
# the delta kernel's shared memory, so every step takes the blocked kernel
WIDE_D = 3072
WIDE_POINTS = 2000      # ticks (points) per worker, cut for time
BLOCKED_TICKS = 2000    # depth of the d=128 eq.-9 leg, blocked route
# below the window kernel's smallest block (the streaming route's 3,216 B at
# d=128, 26,768 B at d=3072) and the delta kernel's (17,536 B at d=128)
# shared memory: forces the blocked route
FORCE_BUDGET = 1024
# below the resident window block (232,436 B at d=128), above the streaming
# one: the window kernel streams its codebook at d=128
STREAM_BUDGET = 100_000
RING_PLAIN_WINDOWS = 200  # sync windows held bitwise against the plain ring
RING_PLAIN_TICKS = 2000   # eq.-9 ticks held bitwise against the plain ring
RING_AVG_POINTS = 2000    # depth of the ring average leg
RING_MASK = (1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0)  # a 0/1 mask over M=8
# the comm layer's legs: M = 8 as 2 host groups of 4 workers
HOSTS = 2
COMM_POINTS = 20_000    # points (or ticks) per worker of a cut leg
HIER_ASYNC_TICKS = 10_000  # eq. 9 over --hosts 2 (cut from COMM_POINTS: 18.0
                           # s on an H100 at 700 W, to pay for item 25)
COMM_CHECK_TICKS = 2000  # eq.-9 ticks of the dense-tier-1 == flat check
QUORUM_P_DELAY = 0.2    # 0.8^11 = 8.6% of worker-windows late at tau = 10
CTL_FRAC0 = 0.5         # the controller leg's starting tier-1 frac
CTL_DCN = 262_144       # its tier-1 bytes a tick: frac 0.5 takes 8 ticks
CTL_PUBLISH = 100       # its windows a chunk
# the elastic legs (queue 1, item 5a): E1's schedule at full depth, the
# periodic checkpoint of E3, E4's host-group schedule on COMM_POINTS, E5's
# chaos spec, and E6's faults over eq. 9 (a slowdown inside the ticks held
# against the oracle, a kill later)
ELASTIC_RESIZE = ((4000, 4), (8000, 8))
CKPT_EVERY = 750
HIER_RESIZE = ((500, 4), (1000, 8))
CHAOS_SPEC = "7:kill=2,slow=1,part=1"
E6_FAULTS = ((5, "slow", 3, 10), (500, "kill", 6))
E6_TICKS = 10_000       # E6's depth (cut from COMM_POINTS: 10.0 s on an
                        # H100 at 700 W, to pay for item 25); worker 6's
                        # 500th round lands near tick 5,500
# the thread runtime, training while serving and the trace/metrics layer
# (queue 1, items 5b and 6a): T1's and T2/T3's wall seconds; S1's points a
# worker (2,333 trainer windows at M = 8, 4, 8) and windows a publication;
# the eq.-9 ticks of O1's read-out
T1_SECONDS = 5.0
T23_SECONDS = 3.0
S1_POINTS = 20_000
S1_PUBLISH = 10
O1_TICKS = 5_000        # O1's eq.-9 pairs (cut from 20,000: four runs at
                        # ~0.45 ms a tick, to pay for item 25)
# eq. 9 on the main path (item 8), ticks a worker: cut from N_PER (125,000
# ticks at 0.4 ms, 50.45 s on an H100 at 700 W) to pay for item 25; the
# sparse, ring and blocked eq.-9 legs hold their heads against this run,
# so it stays past their ticks
ASYNC_TICKS = 25_000
# O1's full-depth runs, cut from N_PER points a worker (four runs of 12,500
# windows, 9.0-9.4 s each and a 5.5 s trace export per observed run on an
# H100 at 700 W) to pay for item 25
O1_POINTS = 25_000
# O1's full-depth runs, two bare/observed pairs in turns: the bits, the
# counters and the trace at full depth, their wall ratio a read-out.  The
# gate's measurement is O1_BLOCK_PAIRS pairs of O1_BLOCK_WINDOWS-window
# blocks in one process, each pair's order the reverse of the last's: a
# one-card machine shares its CPU cores, a sync window's host work is not
# far below its device time, and a stretch the host slows then spoils a
# few pairs of a median instead of one of two full runs; a host busy all
# through slows most pairs, and the best of N still finds quiet blocks
O1_ORDER = (False, True, True, False)
O1_BLOCK_WINDOWS = 500
O1_BLOCK_PAIRS = 16
# O1's capture of the divergence kernel's inputs on the observed path
O1_CAPTURE_WINDOWS = 20

# the roofline profiler, the report, the dry run and the examples (queue 1,
# items 6b and 7): P4's launcher run, points a worker (cut); the examples
# run as subprocesses, beside P4's and P6's, all at once
P4_POINTS = 20_000
EXAMPLES = ("quickstart", "mesh_vq", "elastic_vq", "serve_vq",
            "cloud_async_vq", "train_lm")
SUBPROCESS_TIMEOUT_S = 300
# item 21, one worker a process on the one card (gloo over CUDA tensors, the
# ring's hops over CUDA IPC)
PG_WORLDS = (4, 8)       # G1's worlds
PG_N = KAPPA * D         # G1's payload: a window's displacement
PG_RAGGED = 1_000_003    # G1's ragged payload, at 4 ranks
PG_ITERS = 5             # G1's timed calls a reading
G1_CALLS = 3             # G1's calls back to back, each on new inputs
G2_POINTS = 520          # 52 windows of the 8-process ring run (cut from
                         # 200, 97 ms a window on an H100 at 700 W, to pay
                         # for item 25, then from 100 for item 26; 8 x 520
                         # points still seed kappa = 4,096)
G2_XLA_POINTS = 520      # 52 windows of the 8-process gloo run, cut
G2_AVG_POINTS = 600      # 60 windows of the 8-process average run, cut
G2_LEGS = {"ring delta": ["--scheme", "delta", "--transport", "ring",
                          "--points", str(G2_POINTS)],
           "xla delta": ["--scheme", "delta", "--transport", "xla",
                         "--points", str(G2_XLA_POINTS)],
           "ring average": ["--scheme", "average", "--transport", "ring",
                            "--points", str(G2_AVG_POINTS)]}
# (M * points >= KAPPA: w0 is KAPPA of the points)
G3_M, G3_TICKS = 4, 1_200  # eq. 9 in 4 processes, cut
G4_KAPPAS = (4096, 4099)   # the lookup plans' codebooks, one ragged
G5_BATCH = 1024          # the 2 x 2 minibatch step's points
# item 24, the paper's cloud merges over processes (8 ranks, G7's eq. 9 in
# G3_M ranks for G3_TICKS ticks): windows cut for the gloo handshakes
CLOUD_POINTS = 600       # 60 windows a leg (G7-G9, G11-G13), cut (from
                         # 200 to pay for item 26: 0.8-1.0 s a window of
                         # the 8 ranks' legs together on an H100 at 700 W;
                         # from 100 for item 27; 8 x 600 points still seed
                         # kappa = 4,096)
G11_PUBLISH = 30         # G11's windows a chunk: 2 chunks in 60 windows
G10_POINTS = 600         # 60 windows a G10 leg (3 group rings a window), cut
G12_CHAOS = "7:kill=0,slow=1,part=1"   # no kill: G16 (item 25) kills
# item 25, elastic runs and serving over processes (8 ranks): E1's, E4's
# and E5's shapes cut for the gloo handshakes (27-40 ms a window, item 24)
G14_POINTS = 2_500       # 250 windows a worker (E1: 12,500; 300 until item
                         # 26)
G14_RESIZE = "100:4,200:8"
G15_FROM = (200, 100)    # G14's checkpoints a resume starts from
G16_POINTS = 1_000       # 100 windows (E5's chaos spec at full depth: 12,500;
                         # 200 until item 26, 55-62 ms a window)
G17_POINTS = 2_000       # 200 windows (E4: 2,000)
G17_RESIZE = "50:4,100:8"
G19_POINTS = 2_000       # S1's trainer cut to 200 windows a worker
G19_PUBLISH = 1          # a publication a window: over processes a window
                         # takes ~40 ms, so S1's 10 would leave a 1 s load
                         # one or two versions to serve
# item 22, the LM serving path: the launcher's default arch at its published
# size (its defaults: 3 waves of 4 requests, 16-token prompts, 16 tokens
# generated), then the other nine configs at full width, at full depth where
# their bf16 weights are under LM_FULL_DEPTH_GB and at LM_CUT_LAYERS
# otherwise; hymba at a prompt that is a multiple of the SSD chunk and past
# its 1,024 window
LM_ARCH = "granite_8b"
LM_FULL_DEPTH_GB = 21.0   # starcoder2-7b's published dims: 10.1 B, 20.2 GB
LM_CUT_LAYERS = 2
LM_PROMPT, LM_GEN = 16, 8      # (c): a config's wave (hymba: below)
HYMBA_PROMPT, HYMBA_GEN = 1152, 16
LM_QUANT_STEPS = 10            # (b): timed decode steps a reading
LM_CORR = 0.999                # (b): int8 logits' correlation with bf16
# bf16 against bf16, as max |gap| over max |logits| (both sides round every
# product to bf16, in orders that differ with the shapes)
LM_PREFILL_REL = 0.0           # prefill's last logits vs forward's: one math
LM_DECODE_REL = 0.05           # teacher-forced decode vs forward
LM_BF16_PEAK = 989e12          # bf16 dense FLOP/s of an H100 SXM at 700 W
# item 23, LM training on one card: the launcher's default arch at its
# published width with its depth cut to fit AdamW's 12 B a parameter (36
# layers: 99 GB), the launcher's defaults (64 x 8 tokens a step, lr 1e-3);
# the other families at full depth where their state fits, else 2 layers;
# the determinism, resume and window legs at 2 layers; the window step's
# replicas (granite: M = 2, every replica's AdamW state is kept; whisper:
# the paper's 8)
LMT_LAYERS = 8                 # granite-8b: 2.148 B params, 25.8 GB state
LMT_STEPS = 40                 # 60 until item 26
LMT_TIMED = 5                  # steps timed and traced after the run
LMT_OTHERS = (("hymba_1p5b", None), ("mamba2_2p7b", None),
              ("whisper_tiny", None), ("olmoe_1b_7b", 2),
              ("internvl2_76b", 2))
LMT_OTHER_STEPS = 5            # 10 until item 26
LMT_CUT = 2                    # (b) and (d): 838.9 M params
LMT_DET_STEPS = 20             # (b): --ckpt-every 10, then --resume
LMT_WINDOWS = 2                # (d): windows a merge
LMT_TAU = 2
LMT_WINDOW_M = (("granite_8b", 2), ("whisper_tiny", 8))
LMT_TOPK_M = 4                 # (e): the top-k kernel's timed payload rows
# item 26, the LM's placement over processes: 2 ranks sharing the card over
# gloo (NCCL refuses two ranks on one device)
PL_L1_STEPS = 20               # L1: --ckpt-every 10, then --resume from 10
PL_L2_STEPS = 3                # 10 until item 27 (3.6 s a step)
# L2's depth: the memory rule allows 7 of item 23's 8 layers (1.93 B params),
# but gloo moves the f32 bucket at 0.8-1.0 GB/s between two ranks on one
# H100 at 700 W (7.72 GB in 7.8-9.7 s): 10 s a step, 100 s for 10 steps, past
# the item's 150 s; 2 layers take ~3.7 s a step
PL_L2_LAYERS = 2
PL_CARD_BYTES_A_PARAM = 16     # L2: AdamW's 12 B, the bucket's 4 B
PL_RANK_SLACK = 3 << 30        # L2: a rank's context, activations, caches
PL_ALLREDUCE_REPS = 1          # L2: the bucket's all-reduce, timed alone
PL_SGD_STEPS = 3               # L2: the f32 steps against one process
PL_SGD_LR = 0.1
PL_L3_ROWS, PL_L3_SEQ = 2, 64  # L3: the batch of the EP forward
PL_L4_LAYERS = 4               # L4: 2 stages of 2 layers
PL_L4_MICRO = 4
PL_L4_ROWS, PL_L4_SEQ = 8, 64
PP_BF16_RTOL = 2e-3            # L4: the reference's bar on the bf16 loss
# item 27, the placement as a program: 2 ranks sharing the card over gloo;
# granite-8b at its published width cut to TP_LAYERS layers
TP_LAYERS = 2
TP_ROWS, TP_SEQ = 4, 64        # (a), (b): the batch of a step
TP_GRAD_RTOL = 1e-4            # (a): f32 grads, of each leaf's largest
TP_LR = 1e-3                   # (b): one AdamW step
TP_RESOLVED = 1e-3             # (b): |g| past AdamW's eps by 1e3 and more
TP_PROMPT, TP_GEN, TP_DECODE_ROWS = 16, 8, 4   # (c): item 22's batch
# read before each call kernel_ms times: 20 times the H100's 50 MB L2, and
# ~0.3 ms of device time in which the host enqueues the call
L2_FLUSH_BYTES = 1 << 30

# Tolerances.  cuBLAS accumulates z @ w^T in another order than the
# kernels, so a near-tie can flip an assignment: a flip is accepted when the
# exact (f64) distances of the two rows differ by at most FLIP_REL times
# ||z||^2 + ||w||^2, the magnitude that cancels in the expanded distance
# (16 f32 ulps of it).  Min distances carry the same rounding.
FLIP_REL = 2e-6
# zsum at batch 1000 is a sum of a few points taken in another order
ZSUM_RTOL, ZSUM_ATOL = 1e-5, 1e-5
# BLOCKED_REF: the blocked kernel is held against its plain version run on
# the inputs cast to float64, under the same FLIP_REL rule.  At d=3072 the
# f32 plain version's batched cuBLAS product can sum all 3,072 terms of a
# distance into one f32 accumulator, with errors past FLIP_REL, while the
# kernel's 32 lane sums of 96 terms stay well inside it: in f32 the
# reference would be the less accurate side (check_blocked prints both).
# A flip moves one row on one side only; the oracle's first windows agree to
# CURVE_RTOL on the curve and in all but ROWS_FRAC of the codebook rows.
CURVE_RTOL, ROW_ATOL, ROWS_FRAC = 1e-3, 1e-4, 0.01
# the divergence kernel sums a worker's 524,288 squared differences in
# another order than torch.sum: f32 relative rounding of a few 1e-7
DIV_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_flush = []  # the buffer kernel_ms reads, made at its first call


def kernel_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median time of one call of fn, the yardstick of every kernel, plain
    and library time this script reports: CUDA events just before and
    after each of ``iters`` calls, with ``L2_FLUSH_BYTES`` read just before
    the first event, so the call finds none of its inputs in L2, as the
    bound (bytes over the HBM rate) assumes.  A read leaves L2 clean: a write would
    leave dirty lines that the timed call pays to write back.  The read
    also keeps the card busy while the host enqueues the call, so the
    wrapper's host time is left out where it is shorter than the read
    (~0.3 ms); ``time_ms`` counts it."""
    import torch
    if not _flush:
        _flush.append(torch.zeros(L2_FLUSH_BYTES // 4, device="cuda"))
    for _ in range(warmup):
        fn()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in marks:
        _flush[0].sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in marks)[iters // 2]


def in_turns(kernel, library, iters: int) -> tuple[list, list]:
    """``kernel_ms`` of a kernel and of the library call it is held
    against, in turns (kernel, library, library, kernel): two readings
    each, in ms."""
    order = (kernel, library, library, kernel)
    got = [kernel_ms(fn, iters) for fn in order]
    return [got[0], got[3]], [got[1], got[2]]


def mean(xs) -> float:
    return sum(xs) / len(xs)


def r4(xs) -> list:
    """Readings in ms to 0.1 us, for printing."""
    return [round(x, 4) for x in xs]


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time in ms: bytes over the H100's HBM rate or f32 FLOPs
    over its peak outside the tensor cores (``distributed.roofline``; every
    kernel runs on the f32 pipes), whichever is larger."""
    from repro_torch.distributed.roofline import HBM_BW, PEAK_FLOPS
    t_bytes = bytes_moved / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flip_gap_ok(z, w, a_k: int, a_p: int) -> tuple[bool, float]:
    """Is a flip between rows a_k (kernel) and a_p (plain) a near-tie?"""
    z64 = z.double()
    dk = float(((z64 - w[a_k].double()) ** 2).sum())
    dp = float(((z64 - w[a_p].double()) ** 2).sum())
    scale = float((z64 ** 2).sum() + (w[a_p].double() ** 2).sum())
    return abs(dk - dp) <= FLIP_REL * scale, abs(dk - dp)


def check_ragged(dev) -> None:
    """Both kernels at shapes that divide none of their block sizes (d not
    a multiple of 32, kappa not of 8, 32 or 256, B not of 8): the window
    kernel against the per-step delta-kernel path (bitwise) and the plain
    version, the delta kernel against the plain version."""
    import torch

    from repro_torch.core import vq
    from repro_torch.kernels import vq_assign, vq_fused

    m, tau, kappa, d, b = 3, 7, 1001, 40, 37
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    zwin = torch.rand((m, tau, d), generator=gen, device=dev)
    w0 = torch.rand((kappa, d), generator=gen, device=dev)
    eps = vq.default_steps(torch.arange(1, tau + 1, device=dev))
    wk = vq_fused.vq_window(zwin, w0, eps)
    w = w0.expand(m, kappa, d).contiguous()
    for s in range(tau):
        counts, zsum, _, _ = vq_assign.vq_delta(
            zwin[:, s].unsqueeze(1).contiguous(), w)
        w = w - eps[s] * (counts.unsqueeze(-1) * w - zsum)
    win_plain = bool(torch.equal(wk, vq_fused.vq_window_plain(zwin, w0, eps)))
    z = torch.rand((m, b, d), generator=gen, device=dev)
    ck, zk, mk, ak = vq_assign.vq_delta(z, wk)
    cp, zp, mp, ap = vq_assign.vq_delta_plain(z, wk)
    flips = int((ak != ap).sum())
    print(f"check ragged shapes (M={m}, tau={tau}, kappa={kappa}, d={d}, "
          f"B={b}): window == per-step path {torch.equal(w, wk)}, window == "
          f"plain {win_plain}, delta flips {flips}, max |mind diff| "
          f"{float((mk - mp).abs().max()):.3e}")
    if not torch.equal(w, wk):
        fail("ragged shapes: window kernel differs from the per-step path")
    if flips or not (torch.equal(ck, cp) and torch.allclose(
            zk, zp, rtol=ZSUM_RTOL, atol=ZSUM_ATOL)):
        fail("ragged shapes: delta kernel disagrees with the plain version")
    if not win_plain:
        fail("ragged shapes: window kernel differs from the plain version")


def check_routes(dev, data, w0, wb) -> None:
    """The delta kernel's two routes and the window kernel's plans.

    Delta: the one-launch sweep (B <= 8) at B = 1, 2 and 8 and the passes
    at B = 9, each against the plain version (flips only at near-ties,
    counts and zsum exact where the assignments agree) and, bit for bit,
    against the assign kernel's (assign, mind), which always takes the
    passes; then the sweep at B = 1 called 1,000 times back to back, on a
    new point each call, each result against the plain version (a ticket
    or partial left stale by a call would show in the next), and replayed
    from a CUDA graph two sweeps a replay, its tickets read back as 0.
    Window: the plan at the slice's width, at d=3072 and under
    ``STREAM_BUDGET``, with how many resident clusters the card holds at
    once (M must fit one wave); the resident route at M = 1 and 3 (M = 8
    runs in phase 2), at a ragged kappa with register rows and at kappa = 5
    (blocks with no row), and the streaming route at d=128 under
    ``STREAM_BUDGET`` at M = 1 and 3, each against the per-step path
    through the delta kernel, bit for bit."""
    import torch

    from repro_torch.core import vq
    from repro_torch.kernels import vq_assign, vq_fused

    def against_plain(z, w, label):
        ck, zk, mk, ak = vq_assign.vq_delta(z, w)
        cp, zp, mp, ap = vq_assign.vq_delta_plain(z, w)
        aa, ma = vq_assign.vq_assign(z, w)
        if not (same_bits(ak, aa) and same_bits(mk, ma)):
            fail(f"delta {label}: (assign, mind) differ from the assign "
                 f"kernel's")
        flipped = (ak != ap).nonzero().tolist()
        for j, b in flipped:
            ok, gap = flip_gap_ok(z[j, b], w[j], int(ak[j, b]), int(ap[j, b]))
            if not ok:
                fail(f"delta {label}: worker {j} point {b}: {int(ak[j, b])} "
                     f"vs plain {int(ap[j, b])}, gap {gap:.3e}")
        if not flipped and not (torch.equal(ck, cp) and torch.equal(zk, zp)):
            fail(f"delta {label}: counts/zsum differ from the plain version")
        return len(flipped), float((mk - mp).abs().max())

    for b in (1, 2, 8, 9):
        route = vq_assign.argmin_plan(M, b, KAPPA, D, 1).route
        n_flip, err = against_plain(data[:, 100:100 + b].contiguous(), wb,
                                    f"B={b}")
        print(f"check delta route {route} at ({M}, {b}) x {KAPPA} x {D}: "
              f"== assign kernel bitwise, {n_flip} flips vs plain, max "
              f"|mind diff| {err:.3e}")
    bad, flips = [], 0
    for i in range(1000):
        z = data[:, 200 + i:201 + i].contiguous()
        ck, zk, mk, ak = vq_assign.vq_delta(z, wb)
        cp, zp, mp, ap = vq_assign.vq_delta_plain(z, wb)
        agree = ak == ap
        exact = (torch.equal(ck[agree[:, 0]], cp[agree[:, 0]])
                 and torch.equal(zk[agree[:, 0]], zp[agree[:, 0]]))
        if not bool(agree.all()):
            flips += int((~agree).sum())
            for j in (~agree[:, 0]).nonzero()[:, 0].tolist():
                ok, gap = flip_gap_ok(z[j, 0], wb[j], int(ak[j, 0]),
                                      int(ap[j, 0]))
                if not ok:
                    bad.append((i, j, gap))
        # one point a worker: one count of 1 in each worker's row
        if not exact or not torch.equal(ck.sum(dim=1),
                                        torch.ones_like(mk[:, 0])):
            bad.append((i, "counts/zsum"))
    print(f"check delta sweep, 1,000 calls back to back at ({M}, 1): "
          f"{len(bad)} bad, {flips} flips at near-ties")
    if bad:
        fail(f"delta sweep back to back: {bad[:5]}")
    # two sweeps captured in one CUDA graph, as a graph of eq.-9 ticks will
    # hold them, replayed on 10 new pairs of points.  The warm-up runs on
    # the capture stream, so the sweep's scratch (tickets zeroed once) is
    # made there before the capture and the graph holds the two launches
    # only: a ticket the kernel did not put back would leave no last block
    # in the next sweep, and the tickets must read 0 after the replays.
    z1 = data[:, 1300:1301].contiguous()
    z2 = data[:, 1400:1401].contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        vq_assign.vq_delta(z1, wb)
    side.synchronize()
    tickets = vq_assign._scratch[(z1.device, side.cuda_stream)][0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = (vq_assign.vq_delta(z1, wb), vq_assign.vq_delta(z2, wb))
    if vq_assign._scratch[(z1.device, side.cuda_stream)][0] is not tickets:
        fail("the delta sweep made new scratch inside the graph capture")
    replays = 0
    for i in range(10):
        z1.copy_(data[:, 1301 + i:1302 + i])
        z2.copy_(data[:, 1401 + i:1402 + i])
        graph.replay()
        eager = (vq_assign.vq_delta(z1.clone(), wb),
                 vq_assign.vq_delta(z2.clone(), wb))
        replays += all(same_bits(a, b) for got, want in zip(captured, eager)
                       for a, b in zip(got, want))
    torch.cuda.synchronize()
    left = int(tickets.count_nonzero())
    print(f"check delta sweep in a CUDA graph (2 sweeps a replay): "
          f"{replays} of 10 replays == eager calls bitwise, {left} tickets "
          f"left non-zero")
    if replays != 10 or left:
        fail("the delta sweep replayed from a CUDA graph differs from an "
             "eager call, or left a ticket behind")

    main = vq_fused._window_plan(M, KAPPA, D)
    held = vq_fused.window_clusters(main)
    print(f"window plan ({M}, {KAPPA}, {D}): {main}; the card holds {held} "
          f"such clusters at once; ({M}, {KAPPA}, {WIDE_D}): "
          f"{vq_fused._window_plan(M, KAPPA, WIDE_D)}; ({M}, {KAPPA}, {D}) "
          f"under a {STREAM_BUDGET:,} B budget: "
          f"{vq_fused._window_plan(M, KAPPA, D, STREAM_BUDGET)}")
    if not main.resident or held < M:
        fail(f"the window plan {main} does not run M={M} workers in one wave "
             f"({held} clusters at once)")
    eps = vq.default_steps(torch.arange(1, TAU + 1, device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    cases = [(m, data[:m, :TAU].contiguous(), w0, smem) for m in (1, 3)
             for smem in (vq_assign.SMEM_MAX, STREAM_BUDGET)]
    w_rag = torch.rand((4001, D), generator=gen, device=dev)
    cases.append((3, torch.rand((3, TAU, D), generator=gen, device=dev),
                  w_rag, vq_assign.SMEM_MAX))
    # 5 rows: blocks 5-7 of each cluster hold none
    cases.append((2, data[:2, :TAU].contiguous(), w0[:5].contiguous(),
                  vq_assign.SMEM_MAX))
    for m, zwin, w_start, smem in cases:
        plan = vq_fused._window_plan(m, w_start.shape[0], D, smem)
        route = "resident" if plan.resident else "streaming"
        wk = vq_fused.vq_window(zwin, w_start, eps, smem)
        w = w_start.expand(m, *w_start.shape).contiguous()
        for s in range(TAU):
            counts, zsum, _, _ = vq_assign.vq_delta(
                zwin[:, s].unsqueeze(1).contiguous(), w)
            w = w - eps[s] * (counts.unsqueeze(-1) * w - zsum)
        print(f"check window {route} M={m}, kappa={w_start.shape[0]} "
              f"({plan.rows} rows a block, {plan.reg_rows} in registers, "
              f"{smem:,} B budget): == per-step delta path bitwise "
              f"{same_bits(wk, w)}")
        if plan.resident != (smem == vq_assign.SMEM_MAX) or not same_bits(
                wk, w):
            fail(f"window M={m}, kappa={w_start.shape[0]}: the {route} "
                 f"route differs from the per-step path")


def tie_heavy(dev, m: int, n: int) -> tuple:
    """(m, n) mostly zeros of both signs, 500 distinct magnitudes above 1,
    2,000 of magnitude 0.5 and 3,000 of 0.25 (both signs) per row, in
    random places; and ks that cut through the 0.5, 0.25 and zero ties."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.zeros((m, n), device=dev)
    sign = torch.where(torch.rand((m, n), generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    x = x * sign                                   # -0.0 where sign < 0
    perm = torch.argsort(torch.rand((m, n), generator=gen, device=dev), dim=1)
    big = 1.0 + torch.rand((m, 500), generator=gen, device=dev)
    vals = torch.cat([big, torch.full((m, 2000), 0.5, device=dev),
                      torch.full((m, 3000), 0.25, device=dev)], dim=1)
    x.scatter_(1, perm[:, :5500], vals * torch.gather(sign, 1, perm[:, :5500]))
    return x, (1500, 4000, 6734)


def tie_runs(dev, m: int, n: int) -> tuple:
    """(m, n) of zeros of both signs with a run of 64 entries of magnitude
    0.5 (both signs) centred on every multiple of 32,768 inside the row
    (every slice boundary of the 8-block cluster at n = 524,288, and the
    midpoints between), and 3 distinct magnitudes in [1, 2) between each
    pair of runs; and ks whose cut falls at a run's centre (a slice
    boundary), 10 entries past it, at the last 0.5, and in the zeros
    40,000 entries on (across many warps' segments)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    sign = torch.where(torch.rand((m, n), generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    x = torch.zeros((m, n), device=dev) * sign     # -0.0 where sign < 0
    pos = torch.arange(n, device=dev)
    run = ((pos + 32) % 32_768 < 64) & (pos >= 32) & (pos < n - 32)
    x[:, run] = 0.5 * sign[:, run]
    big = torch.tensor([b + 32_768 * j for j in range(n // 32_768)
                        for b in (8_000, 16_000, 24_000)], device=dev)
    x[:, big] = (1.0 + torch.rand((m, big.numel()), generator=gen,
                                  device=dev)) * sign[:, big]
    n_big, n_half = big.numel(), int(run.sum())
    return x, (n_big + 7 * 64 + 32, n_big + 7 * 64 + 42, n_big + n_half,
               n_big + n_half + 40_000)


def topk_equal(full, k: int, label: str) -> None:
    """The top-k kernel against its plain version, bit for bit, with one
    counted launch for the call."""
    from repro_torch.kernels import vq_fused
    before = vq_fused.launches_topk
    got = vq_fused.vq_topk(full, k)
    launched = vq_fused.launches_topk - before
    want = vq_fused.vq_topk_plain(full, k)
    same = [same_bits(a, b) for a, b in zip(got, want)]
    if not all(same) or launched != 1:
        fail(f"top-k {label}, k={k}: kernel differs from the plain version "
             f"(vals, idx, residual bitwise equal: {same}) or launched "
             f"{launched} times")


def topk_plan_line(full) -> str:
    """The launch plan of the top-k kernel on full: cluster and slice."""
    from repro_torch.kernels import vq_fused
    m, n = full.shape
    plan = vq_fused._topk_plan(m, n, 1)
    return (f"({m}, {n}): {m} clusters of {plan.cluster} blocks, slice "
            f"{plan.slice_len:,}")


def check_topk(dev, payload, normal, ks) -> None:
    """The top-k kernel against its plain version at the main path's shape
    (a window's displacement and N(0, 1) entries) at each of ``ks``, the
    displacement at k = its rows' non-zero counts and those counts +- 1
    (the T = 0 early exit on either side), ragged, tie-heavy, and with tie
    runs across the slice boundaries."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n = KAPPA * D
    nz_rows = (payload != 0).sum(dim=1).tolist()
    nz_ks = sorted({c + d for c in (min(nz_rows), max(nz_rows))
                    for d in (-1, 0, 1) if 1 <= c + d <= n})
    for full, label, kk in ((payload, "window displacement", ks + tuple(nz_ks)),
                            (normal, "N(0, 1)", ks)):
        for k in kk:
            topk_equal(full, k, f"({M}, {n}) {label}")
    ragged = torch.randn((3, 40_040), generator=gen, device=dev)
    topk_equal(ragged, 37, "ragged (3, 40040)")
    ties, tie_ks = tie_heavy(dev, 4, 100_003)
    for k in tie_ks:
        topk_equal(ties, k, "tie-heavy (4, 100003)")
    runs, run_ks = tie_runs(dev, M, n)
    for k in run_ks:
        topk_equal(runs, k, f"tie runs ({M}, {n})")
    print(f"check top-k vs plain, bitwise (vals, idx, residual), one launch "
          f"a call: ({M}, {n}) window displacement (non-zero per row "
          f"{nz_rows}) at k = {ks} and {nz_ks} and N(0, 1) at k = {ks}; "
          f"ragged (3, 40040) at k = 37; tie-heavy (4, 100003) at k = "
          f"{tie_ks}; 0.5 tie runs across every slice boundary ({M}, {n}) "
          f"at k = {run_ks}: all equal")
    print(f"top-k plans: {topk_plan_line(payload)}; "
          f"{topk_plan_line(ragged)}; {topk_plan_line(ties)}")


def check_assign(z, w, label: str, f64: bool = False) -> tuple[int, float]:
    """The assign kernel against its plain version (flips only at
    near-ties, min distances within FLIP_REL of the cancelled magnitude;
    with ``f64`` the plain version run on the inputs cast to float64, see
    BLOCKED_REF) and against the delta kernel's (assign, mind), bit for
    bit.  Returns (flips, max |mind diff| off flipped rows)."""
    import torch

    from repro_torch.kernels import vq_assign

    ak, mk = vq_assign.vq_assign(z, w)
    ap, mp = (vq_assign.vq_assign_plain(z.double(), w.double()) if f64
              else vq_assign.vq_assign_plain(z, w))
    _, _, md, ad = vq_assign.vq_delta(z, w)
    same = torch.equal(ak, ad) and torch.equal(mk, md)
    if z.dim() == 2:
        z, w, ak, ap, mk, mp = (x[None] for x in (z, w, ak, ap, mk, mp))
    flips = (ak != ap).nonzero().tolist()
    for j, b in flips:
        ok, gap = flip_gap_ok(z[j, b], w[j], int(ak[j, b]), int(ap[j, b]))
        if not ok:
            fail(f"assign {label}: worker {j} row {b}: {int(ak[j, b])} vs "
                 f"plain {int(ap[j, b])}, gap {gap:.3e}: not a near-tie")
    keep = ak == ap
    w2 = (w.double() ** 2).sum(-1)
    scale = (z.double() ** 2).sum(-1) + torch.gather(w2, 1, ak.long())
    err = (mk.double() - mp.double()).abs()
    if bool(((err > FLIP_REL * scale) & keep).any()):
        fail(f"assign {label}: min distances differ from the plain version")
    max_err = float(err[keep].max()) if bool(keep.any()) else 0.0
    print(f"check assign {label} vs plain{' in f64' if f64 else ''}: "
          f"{len(flips)} flips of "
          f"{ak.numel()}, max |mind diff| {max_err:.3e}; == delta kernel's "
          f"(assign, mind) bitwise: {same}")
    if not same:
        fail(f"assign {label}: the assign kernel differs from the delta "
             f"kernel's assignment")
    return len(flips), max_err


def check_served(run) -> None:
    """Sampled served rows against the plain version at the version that
    served them."""
    import numpy as np
    import torch

    from repro_torch.kernels import vq_assign

    pairs = [(q, r) for q, r in run.report.samples if r is not None]
    if len(pairs) < SERVE_SAMPLE:
        fail(f"serving: only {len(pairs)} sampled responses")
    flips = 0
    max_err = 0.0
    for version in sorted({r.version for _, r in pairs}):
        snap = run.store.get(version)
        if snap is None:
            fail(f"serving: version {version} is gone from the store")
        w = snap.w_device
        sel = [(q, r) for q, r in pairs if r.version == version]
        z = torch.from_numpy(np.concatenate([q for q, _ in sel])).to(w.device)
        got_a = torch.from_numpy(np.concatenate([r.assign for _, r in sel]))
        got_m = torch.from_numpy(np.concatenate([r.mindist for _, r in sel]))
        ap, mp = vq_assign.vq_assign_plain(z, w)
        ap, mp = ap.cpu(), mp.cpu()
        for b in (got_a != ap).nonzero()[:, 0].tolist():
            ok, gap = flip_gap_ok(z[b], w, int(got_a[b]), int(ap[b]))
            if not ok:
                fail(f"serving: row {b} served {int(got_a[b])}, plain "
                     f"{int(ap[b])}, gap {gap:.3e}: not a near-tie")
            flips += 1
        keep = got_a == ap
        scale = ((z.double() ** 2).sum(-1)
                 + (w.double() ** 2).sum(-1)[got_a.long().to(w.device)]).cpu()
        err = (got_m.double() - mp.double()).abs()
        if bool(((err > FLIP_REL * scale) & keep).any()):
            fail("serving: served min distances differ from the plain "
                 "version")
        max_err = max(max_err, float(err[keep].max()))
    print(f"check served rows vs plain: {len(pairs)} rows, {flips} flips, "
          f"max |mind diff| {max_err:.3e}")


def serve_leg(serve, codebook, extra: list[str], label: str):
    """One run of the serving launcher at full width, with the assign
    kernel's count set to 0 before it and checked after it."""
    from repro_torch.kernels import vq_assign

    argv = ["--mode", "vq", "--kappa", str(KAPPA), "--dim", str(D),
            "--requests", str(SERVE_REQUESTS), "--seed", str(SEED)] + extra
    pauses: list[tuple[int, float]] = []   # (generation, ms) per GC pass
    started: list[float] = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((info["generation"],
                           (time.perf_counter() - started.pop()) * 1e3))

    vq_assign.launches_assign = vq_assign.launches = 0
    gc.callbacks.append(on_gc)
    try:
        run = serve.run_vq(serve.parse_args(argv), codebook=codebook,
                           sample=SERVE_SAMPLE)
    finally:
        gc.callbacks.remove(on_gc)
    launches = vq_assign.launches_assign
    full = [ms for gen, ms in pauses if gen == 2]
    print(f"serving ({label}): {len(pauses)} garbage-collector passes, "
          f"{len(full)} full, longest full pass {max(full, default=0.0):.1f} "
          f"ms, longest pass {max((ms for _, ms in pauses), default=0.0):.1f}"
          f" ms")
    if run.rc != 0 or run.report is None:
        fail(f"serving ({label}): the launcher exited {run.rc}")
    rep, st = run.report, run.stats
    print(f"serving ({label}): {rep.qps:.1f} q/s, {rep.rows_per_s:.1f} "
          f"rows/s, p50 {rep.p50_ms:.3f} ms, p99 {rep.p99_ms:.3f} ms, "
          f"{st.flushes} flushes (full {st.full_flushes}, deadline "
          f"{st.deadline_flushes}), mean fill {st.mean_fill:.2f} rows, "
          f"{st.warmups} warm-ups, assign launches {launches}, delta "
          f"launches {vq_assign.launches}")
    if rep.failed or not rep.versions_monotonic:
        fail(f"serving ({label}): {rep.failed} failed, monotonic "
             f"{rep.versions_monotonic}")
    if launches != st.flushes + st.warmups or launches == 0:
        fail(f"serving ({label}): {launches} assign launches for "
             f"{st.flushes} flushes and {st.warmups} warm-ups")
    if vq_assign.launches:
        fail(f"serving ({label}): the delta kernel ran on the read path")
    check_served(run)
    return run, launches


def freeze_ab(serve, codebook, extra: list[str]) -> None:
    """What the launcher's ``gc.freeze()`` of its start-up heap buys, read
    on one machine: geometric legs with the freeze as shipped and with
    ``gc.freeze`` a no-op, in the order off, on, on, off."""
    real = gc.freeze
    p99 = {False: [], True: []}
    for frozen in (False, True, True, False):
        gc.freeze = real if frozen else (lambda: None)
        try:
            run, _ = serve_leg(serve, codebook, extra,
                               f"geometric, freeze {'on' if frozen else 'off'}")
        finally:
            gc.freeze = real
        p99[frozen].append(run.report.p99_ms)
    print(f"gc freeze A/B (geometric, order off/on/on/off): p99 ms off "
          f"{p99[False]}, on {p99[True]}")


def profile(label: str, run, units: int, unit: str) -> dict | None:
    """Where the time goes: device time per kernel name from
    ``torch.profiler`` over one call of ``run`` (after one untraced
    warm-up call), per ``unit``, and the device's busy and idle share of the
    profiled wall time.  Returns the wall, the busy time (us) and the
    device operations the trace holds, or None when it saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    run()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    n_ops = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            n_ops += 1
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    busy = sum(by_name.values())
    if busy == 0.0:
        print(f"profile {label}: the profiler saw no device time (not "
              f"measured)")
        return None
    per = 1.0 / units
    print(f"profile ({units} {unit}s of {label}): wall {wall_us * per:.1f} "
          f"us/{unit} with the profiler on, device busy {busy * per:.1f} "
          f"us/{unit}, idle share {1.0 - busy / wall_us:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us * per:9.2f} us/{unit}  {name[:100]}")
    return {"wall_us": wall_us, "busy_us": busy, "ops": n_ops}


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.comm import ring
    from repro_torch.kernels import vq_assign, vq_fused
    vq_fused.launches = vq_fused.launches_blocked = 0
    vq_fused.launches_topk = vq_fused.launches_divergence = 0
    vq_assign.launches = vq_assign.launches_assign = 0
    ring.launches_ring = ring.launches_ring_hop = 0


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from repro_torch.comm import ring
    from repro_torch.kernels import vq_assign, vq_fused
    return {"window": vq_fused.launches, "delta": vq_assign.launches,
            "assign": vq_assign.launches_assign,
            "blocked": vq_fused.launches_blocked,
            "topk": vq_fused.launches_topk, "ring": ring.launches_ring}


def expect_counts(label: str, **want) -> dict:
    """Every kernel's launch count since ``zero_counts``, the divergence
    kernel's too (no TPU kernel's counterpart, so not in
    ``launch_counts``): those named in ``want`` must equal it, every other
    must be 0."""
    from repro_torch.kernels import vq_fused
    counts = {**launch_counts(), "divergence": vq_fused.launches_divergence}
    if counts != {k: want.get(k, 0) for k in counts}:
        fail(f"{label}: launches {counts}, expected {want} and no other")
    return counts


def same_bits(a, b) -> bool:
    """Equal to the bit (float tensors compared as their int32 words)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def one_launch(fn, label: str) -> None:
    """Fail unless one call of fn launches one CUDA kernel (the argmin
    engine's host count, ``vq_assign.cuda_launches``)."""
    from repro_torch.kernels import vq_assign
    before = vq_assign.cuda_launches()
    fn()
    launched = vq_assign.cuda_launches() - before
    if launched != 1:
        fail(f"{label}: {launched} CUDA kernel launches, expected one")


def check_ring(x, label: str, mask=None) -> None:
    """The ring kernel against its plain version, bit for bit, with one
    launch for the call; prints the largest |ring - torch.sum| (a read-out:
    the two add in different orders)."""
    import torch

    from repro_torch.comm import ring

    before = ring.launches_ring
    got = ring.ring_all_reduce(x, mask)
    launched = ring.launches_ring - before
    want = ring.ring_all_reduce_plain(x, mask)
    dense = torch.sum(x if mask is None else mask[:, None] * x, dim=0)
    err = float((got - dense).abs().max())
    print(f"check ring {label} {tuple(x.shape)}: == plain bitwise "
          f"{same_bits(got, want)}, launches {launched}; max |ring - "
          f"torch.sum| {err:.3e}")
    if not (same_bits(got, want) and launched == 1):
        fail(f"ring {label}: the kernel differs from the plain version, or "
             f"it launched {launched} times")


def held_to(label: str, curve, ref_curve, w=None, ref_w=None) -> None:
    """A run against a reference run of the same inputs: the curve within
    CURVE_RTOL and, where codebooks are given, all but ROWS_FRAC of their
    rows within ROW_ATOL (the rule the oracle checks use)."""
    c_err = float(((curve - ref_curve).abs() / ref_curve.abs()).max())
    rows = 0
    if w is not None:
        rows = int(((w - ref_w).abs() > ROW_ATOL).any(dim=1).sum())
    print(f"check {label}: max rel curve diff {c_err:.3e} (rtol "
          f"{CURVE_RTOL}), curve bitwise equal {same_bits(curve, ref_curve)}"
          + ("" if w is None else f", codebook rows off by > {ROW_ATOL}: "
             f"{rows} of {w.shape[0]}"))
    if c_err > CURVE_RTOL or rows > ROWS_FRAC * (0 if w is None
                                                 else w.shape[0]):
        fail(f"{label}: the runs disagree")


def check_blocked(z, w, label: str, residual=None) -> float:
    """The blocked kernel against its plain version evaluated in float64
    (the same code on the inputs cast to f64; see BLOCKED_REF): flips only
    at near-ties; counts exact and equal to the kernel's own assignment's
    histogram; zsum within ZSUM_RTOL/ATOL of its own assignment's f64 sums
    and of the plain zsum off flipped rows; min distances within FLIP_REL of
    the cancelled magnitude; the epilogue equal, bit for bit, to the eager
    ``counts * w - zsum + residual`` on the kernel's own outputs.  The f32
    plain version's own flips against the f64 one are counted and printed.
    Returns max |mind diff| off flipped points."""
    import torch

    from repro_torch.kernels import vq_fused

    out = vq_fused.vq_delta_blocked(z, w, residual=residual)
    ck, zk, mk, ak = out[:4]
    cp, zp, mp64, ap = vq_fused.vq_delta_blocked_plain(z.double(),
                                                        w.double())
    cp, zp = cp.float(), zp.float()
    _, _, m32, a32 = vq_fused.vq_delta_blocked_plain(z, w)
    f32_flips = int((a32 != ap).sum())
    m, b, d = z.shape
    kappa = w.shape[1]
    dev = z.device
    diff = (ak != ap).nonzero().tolist()
    touched = torch.zeros((m, kappa), dtype=torch.bool, device=dev)
    for j, i in diff:
        ok, gap = flip_gap_ok(z[j, i], w[j], int(ak[j, i]), int(ap[j, i]))
        if not ok:
            fail(f"blocked {label}: worker {j} point {i}: {int(ak[j, i])} vs "
                 f"plain {int(ap[j, i])}, gap {gap:.3e}: not a near-tie")
        touched[j, int(ak[j, i])] = touched[j, int(ap[j, i])] = True
    counts_own = torch.zeros((m, kappa), device=dev).scatter_add_(
        1, ak.long(), torch.ones_like(mk))
    zsum_own = torch.zeros((m, kappa, d), dtype=torch.float64,
                           device=dev).index_put_(
        (torch.arange(m, device=dev)[:, None].expand(m, b), ak.long()),
        z.double(), accumulate=True)
    keep = ~touched
    z_err = float((zk - zp).abs()[keep].max())
    if not (torch.equal(ck, counts_own) and torch.equal(ck[keep], cp[keep])
            and torch.allclose(zk, zsum_own.float(), rtol=ZSUM_RTOL,
                               atol=ZSUM_ATOL)
            and torch.allclose(zk[keep], zp[keep], rtol=ZSUM_RTOL,
                               atol=ZSUM_ATOL)):
        fail(f"blocked {label}: counts/zsum disagree with the plain version")
    kept_pt = ak == ap
    w2 = (w.double() ** 2).sum(-1)
    scale = (z.double() ** 2).sum(-1) + torch.gather(w2, 1, ak.long())
    err = (mk.double() - mp64).abs()
    if bool(((err > FLIP_REL * scale) & kept_pt).any()):
        fail(f"blocked {label}: min distances differ from the plain version")
    m_err = float(err[kept_pt].max()) if bool(kept_pt.any()) else 0.0
    f32_err = float((m32.double() - mp64).abs()[a32 == ap].max())
    epi = "no residual"
    if residual is not None:
        if not same_bits(out[4], ck.unsqueeze(-1) * w - zk + residual):
            fail(f"blocked {label}: the epilogue differs from the eager "
                 f"expression on the kernel's own counts and zsum")
        epi = "epilogue == eager bitwise"
    print(f"check blocked {label} vs plain in f64: {len(diff)} flips of "
          f"{ak.numel()}, counts exact, max |zsum diff| off flipped rows "
          f"{z_err:.3e}, max |mind diff| {m_err:.3e}, {epi}; the f32 plain "
          f"version (cuBLAS) against the f64 one: {f32_flips} flips, max "
          f"|mind diff| {f32_err:.3e}")
    return m_err


def comm_layer_legs(dev, w0, data, eval_data, runs, lengths, payload,
                    normal_payload) -> None:
    """The comm layer on stacked workers at full width: M = 8 as 2 host
    groups of 4, the dynamic and the quorum merge, the tier-1 controller
    (the module docstring's item 17)."""
    import torch

    from repro_torch import comm
    from repro_torch.comm import ring
    from repro_torch.comm.sweep import acceptance_sparse_frac
    from repro_torch.core import vq
    from repro_torch.engine import Tier1BudgetController, Topology
    from repro_torch.engine import merge as merge_lib
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import (FixedLatencyNetwork,
                                            GeometricDelayNetwork,
                                            InstantNetwork)
    from repro_torch.kernels import vq_fused
    from repro_torch.launch import train

    topo = Topology.from_spec(M, hosts=HOSTS)
    wph = topo.workers_per_host
    n_flat = KAPPA * D
    logical = 4 * n_flat
    t0_wire = comm.ring_wire_bytes(logical, wph)          # 3,145,728
    t1_dense = comm.ring_wire_bytes(logical, HOSTS)       # 2,097,152
    frac1 = acceptance_sparse_frac(KAPPA, D)              # 1/512
    k1 = comm.topk_count(n_flat, frac1)                   # 1,024
    t1_sparse = (HOSTS - 1) * k1 * 8                      # 8,192
    n_windows = N_PER // TAU
    cw = COMM_POINTS // TAU

    # the kernels at the slice's new shapes: a tier-1 payload (the host
    # groups' summed displacements) and a host group's rows
    partial = payload.view(HOSTS, wph, -1).sum(1).contiguous()
    normal1 = normal_payload[:HOSTS].contiguous()
    for full, label in ((partial, "tier-1 partial"), (normal1, "N(0, 1)")):
        topk_equal(full, k1, f"({HOSTS}, {n_flat}) {label}")
    topk_equal(partial[:, :1].contiguous(), 1, f"({HOSTS}, 1) one-entry leaf")
    print(f"check top-k vs plain, bitwise, one launch: ({HOSTS}, {n_flat}) "
          f"tier-1 partial and N(0, 1) at k = {k1}, ({HOSTS}, 1) at k = 1: "
          f"equal; plan {topk_plan_line(partial)}")
    for x, label in ((payload[:wph].contiguous(), "a host group's "
                      "displacement"),
                     (normal_payload[:wph].contiguous(), "a host group, "
                      "N(0, 1)")):
        check_ring(x, label)

    def flat_args(points, *extra):
        return ["--executor", "mesh", "--workers", str(M), "--points",
                str(points), "--dim", str(D), "--kappa", str(KAPPA), "--tau",
                str(TAU), "--seed", str(SEED)] + list(extra)

    def leg(label, argv, **want):
        zero_counts()
        res, ex, wall = train.run_vq(train.parse_args(argv))
        counts = expect_counts(label, **want)
        pts = M * int(argv[argv.index("--points") + 1])
        print(f"leg {label}: wall {wall:.2f} s ({wall / pts * 1e6:.3f} "
              f"us/point), launches {counts}, C first "
              f"{float(res.distortion[0]):.6f} last "
              f"{float(res.distortion[-1]):.6f}")
        if not (bool(torch.isfinite(res.distortion).all())
                and res.w_shared.shape == (KAPPA, D)
                and float(res.distortion[-1]) < float(res.distortion[0])):
            fail(f"{label}: result not finite, of the wrong shape, or not "
                 f"going down")
        return res, ex, counts

    def tiers(ex, windows):
        by = ex.last_comm["by_tag"]["merge"]["by_tier"]
        return (by[0]["wire_bytes"] // windows, by[1]["wire_bytes"] // windows,
                by[0]["wire_bytes"] % windows + by[1]["wire_bytes"] % windows)

    def same_run(a, b):
        return (same_bits(a.distortion, b.distortion)
                and same_bits(a.w_shared, b.w_shared))

    # -- leg 1: both tiers dense == the flat run, bit for bit -----------------
    inst = ["--network", "instant", "--scheme", "delta"]
    cut = flat_args(COMM_POINTS, *inst)
    flat, _, _ = leg("flat delta (cut)", cut, window=cw)
    hier_d, ex_hd, _ = leg("--hosts 2 --tier1-transport xla (cut)",
                           cut + ["--hosts", str(HOSTS), "--tier1-transport",
                                  "xla"], window=cw)
    per0, per1, rem = tiers(ex_hd, cw)
    print(f"check hier dense == flat dense, bitwise (curve, codebook): "
          f"{same_run(hier_d, flat)}; tier wire a window {per0:,} / {per1:,} "
          f"B")
    if not same_run(hier_d, flat) or (per0, per1, rem) != (t0_wire, t1_dense,
                                                            0):
        fail("hier dense: differs from the flat run, or tier bytes wrong")
    flat_r, _, cr = leg("flat ring delta (cut)", cut + ["--transport", "ring"],
                        window=cw, ring=2 * cw)
    hier_r, ex_hr, chr_ = leg(
        "--transport ring --hosts 2 --tier1-transport xla (cut)",
        cut + ["--transport", "ring", "--hosts", str(HOSTS),
               "--tier1-transport", "xla"], window=cw, ring=2 * cw)
    print(f"check hier ring (one ring launch over {M} rows a reduce) == flat "
          f"ring, bitwise: {same_run(hier_r, flat_r)}; ring launches "
          f"{chr_['ring']} == {cr['ring']}")
    if not same_run(hier_r, flat_r) or tiers(ex_hr, cw) != (t0_wire,
                                                           t1_dense, 0):
        fail("hier ring: differs from the flat ring run")

    # -- leg 2: a sparse tier 1 at full depth (the headline) -----------------
    sp_args = flat_args(N_PER, *inst) + ["--hosts", str(HOSTS)]
    hier_s, ex_hs, _ = leg("--hosts 2 (sparse tier 1, k = "
                                   f"{k1:,}), full depth", sp_args,
                                   window=n_windows, topk=n_windows)
    per0, per1, rem = tiers(ex_hs, n_windows)
    c_flat = float(runs["delta"][0].distortion[-1])
    gap = float(hier_s.distortion[-1]) / c_flat - 1.0
    print(f"check hier sparse: tier wire a window {per0:,} / {per1:,} B "
          f"({t1_dense // per1}x less than dense tier 1); final C "
          f"{float(hier_s.distortion[-1]):.6f} vs flat dense {c_flat:.6f} "
          f"({gap:+.4f})")
    if (per0, per1, rem) != (t0_wire, t1_sparse, 0) or abs(gap) >= 0.25:
        fail("hier sparse: tier bytes wrong or final distortion past 25% of "
             "the flat dense run's")
    head = data[:, : CHECK_WINDOWS * TAU]
    plain = MeshExecutor(InstantNetwork(), use_kernels=False, device=dev,
                         transport=comm.HierarchicalTransport(
                             "xla", comm.get_transport("sparse", frac=frac1),
                             topology=topo)).run(
        "delta", w0, head, eval_data, tau=TAU)
    held_to(f"hier sparse first {CHECK_WINDOWS} windows vs use_kernels=False",
            hier_s.distortion[:CHECK_WINDOWS], plain.distortion)

    # -- leg 3: eq. 9 over the hierarchy --------------------------------------
    geo = ["--scheme", "async_delta", "--network", "geometric", "--p-delay",
           str(P_DELAY)]
    n_t = HIER_ASYNC_TICKS
    res_ha, ex_ha, _ = leg("eq. 9 --hosts 2 (sparse tier 1), cut",
                           flat_args(n_t, *geo) + ["--hosts", str(HOSTS)],
                           delta=n_t, topk=n_t)
    per0, per1, _ = tiers(ex_ha, n_t)
    print(f"eq. 9 over the hierarchy: tier wire a tick {per0:,} / {per1:,} "
          f"B, one delta and one top-k launch a tick")
    if (per0, per1) != (t0_wire, t1_sparse):
        fail("eq. 9 hier: tier bytes wrong")
    n_c = COMM_CHECK_TICKS
    lc = lengths[:, : n_c // TAU + 2]
    flat_a = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev).run(
        "async_delta", w0, data[:, :n_c], eval_data, tau=TAU, lengths=lc)
    hier_a = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev,
                          transport=comm.HierarchicalTransport(
                              "xla", "xla", topology=topo)).run(
        "async_delta", w0, data[:, :n_c], eval_data, tau=TAU, lengths=lc)
    print(f"check eq. 9 hier dense == flat, {n_c} ticks, bitwise: "
          f"{same_run(hier_a, flat_a)}")
    if not same_run(hier_a, flat_a):
        fail("eq. 9 hier dense differs from the flat run")

    # -- leg 4: the dynamic merge ---------------------------------------------
    dyn0, ex_d0, _ = leg("--merge dynamic --divergence-thresh 0 (cut)",
                         cut + ["--merge", "dynamic"], window=cw)
    probe = ex_d0.last_comm["by_tag"]["probe"]
    print(f"check dynamic at 0 == plain delta, bitwise: "
          f"{same_run(dyn0, flat)}; probe wire {probe['wire_bytes'] // cw} B "
          f"a window, merges {ex_d0.last_comm['by_tag']['merge']['calls']}")
    if (not same_run(dyn0, flat) or probe["wire_bytes"] != 7 * cw
            or ex_d0.last_comm["by_tag"]["merge"]["calls"] != cw):
        fail("dynamic at threshold 0 differs from the plain delta run")
    # T: the median probe of the threshold-0 leg, sum_i ||Delta_i||^2 a
    # window, from the plain delta loop written out over the same points
    w_srd, data_c, _ = train.make_inputs(train.parse_args(cut), dev)
    drifts = []
    eps_c = vq.default_steps(torch.arange(1, cw * TAU + 1, device=dev))
    for i in range(cw):
        span = slice(i * TAU, (i + 1) * TAU)
        delta = merge_lib.tree_sub_f32(w_srd, vq_fused.vq_window(
            data_c[:, span].contiguous(), w_srd, eps_c[span]))
        drifts.append((delta * delta).sum(dim=(1, 2)).sum())
        w_srd = merge_lib.tree_apply_delta(w_srd, torch.sum(delta, dim=0))
    drifts = torch.stack(drifts).cpu()
    thresh = float(drifts.median())
    if not same_bits(w_srd, flat.w_shared):
        fail("the loop written out for the probe differs from the delta run")
    print(f"dynamic threshold T = {thresh:.6e}: the median probe of the "
          f"threshold-0 leg's {cw} windows (first {float(drifts[0]):.4e}, "
          f"last {float(drifts[-1]):.4e})")
    dyn_args = ["--merge", "dynamic", "--divergence-thresh", repr(thresh)]
    zero_counts()
    res_dt, ex_dt, wall_dt = train.run_vq(train.parse_args(
        flat_args(N_PER, *inst) + dyn_args))
    counts_dt = expect_counts("dynamic at T", window=n_windows)
    n_trig = int(ex_dt.last_triggers.sum())
    by = ex_dt.last_comm["by_tag"]
    dense_w = comm.ring_wire_bytes(logical, M)
    print(f"leg --merge dynamic at T, full depth: wall {wall_dt:.2f} s "
          f"({wall_dt / (M * N_PER) * 1e6:.3f} us/point), launches "
          f"{counts_dt}, n_triggered {n_trig} of {n_windows}, merge wire "
          f"{by['merge']['wire_bytes']:,} B, probe wire "
          f"{by['probe']['wire_bytes']:,} B (plain delta "
          f"{n_windows * dense_w:,} B); final C "
          f"{float(res_dt.distortion[-1]):.6f} vs plain delta {c_flat:.6f}")
    if (by["merge"]["wire_bytes"] != n_trig * dense_w
            or by["probe"]["wire_bytes"] != 7 * n_windows
            or not bool(torch.isfinite(res_dt.distortion).all())):
        fail("dynamic at T: wire not re-priced to the triggered windows")
    zero_counts()
    res_dq, ex_dq, wall_dq = train.run_vq(train.parse_args(
        cut + dyn_args + ["--wire-quant", "int8"]))
    expect_counts("dynamic at T over int8", window=cw)
    n_trig_q = int(ex_dq.last_triggers.sum())
    by_q = ex_dq.last_comm["by_tag"]
    print(f"leg --merge dynamic at T --wire-quant int8 (cut): wall "
          f"{wall_dq:.2f} s, n_triggered {n_trig_q} of {cw}, merge wire "
          f"{by_q['merge']['wire_bytes']:,} B, probe wire "
          f"{by_q['probe']['wire_bytes']:,} B; final C "
          f"{float(res_dq.distortion[-1]):.6f}")
    if (by_q["merge"]["wire_bytes"] != n_trig_q * (dense_w // 4 + 4)
            or by_q["probe"]["wire_bytes"] != 5 * cw
            or not bool(torch.isfinite(res_dq.distortion).all())):
        fail("dynamic over int8: wire wrong or curve not finite")

    # -- leg 5: the quorum merge ----------------------------------------------
    q0, ex_q0, _ = leg("--quorum --network instant (cut)", cut + ["--quorum"],
                       window=cw)
    print(f"check quorum without lateness == plain delta, bitwise: "
          f"{same_run(q0, flat)}")
    if not same_run(q0, flat):
        fail("quorum without lateness differs from the plain delta run")
    q_args = flat_args(N_PER, "--scheme", "delta", "--network", "geometric",
                       "--p-delay", str(QUORUM_P_DELAY), "--quorum")
    res_q, ex_q, _ = leg("--quorum --network geometric --p-delay "
                                f"{QUORUM_P_DELAY}, full depth", q_args,
                                window=n_windows)
    late = GeometricDelayNetwork(QUORUM_P_DELAY).late_matrix(M, n_windows,
                                                             TAU)
    q_wire = comm.ring_wire_bytes(logical + 4, M)
    merge_q = ex_q.last_comm["by_tag"]["merge"]
    print(f"quorum: late worker-windows {ex_q.last_late_worker_windows:,} "
          f"(numpy late_matrix {int(late.sum()):,}, "
          f"{late.mean():.4f} of {late.size:,}); merge wire "
          f"{merge_q['wire_bytes'] // n_windows:,} B a window; final C "
          f"{float(res_q.distortion[-1]):.6f} vs plain delta {c_flat:.6f}")
    if (ex_q.last_late_worker_windows != int(late.sum())
            or merge_q["wire_bytes"] != n_windows * q_wire
            or q_wire != 3_670_023):
        fail("quorum: late count or merge wire wrong")

    # -- leg 6: the tier-1 controller -----------------------------------------
    net = FixedLatencyNetwork(latency_ticks=1, dcn_bytes_per_tick=CTL_DCN)
    ctl = Tier1BudgetController(net)
    hier_c = comm.HierarchicalTransport(
        "xla", comm.get_transport("sparse", frac=CTL_FRAC0), topology=topo)
    ex_c = MeshExecutor(net, transport=hier_c, tier1_controller=ctl,
                        publish_every=CTL_PUBLISH, device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_c = ex_c.run("delta", w0, data[:, :COMM_POINTS], eval_data, tau=TAU)
    res_c.distortion.cpu()
    wall_c = time.perf_counter() - t0
    counts_c = expect_counts("tier-1 controller", window=cw, topk=cw)
    replay, ks = [], []
    shadow = comm.get_transport("sparse", frac=CTL_FRAC0)
    replica = Tier1BudgetController(net)
    for _ in range(cw // CTL_PUBLISH):
        k = comm.topk_count(n_flat, shadow.frac)
        ks.append(k)
        replay.append(replica.update(shadow, (HOSTS - 1) * k * 8))
    by_c = ex_c.last_comm["by_tag"]["merge"]["by_tier"][1]
    want_wire = sum(CTL_PUBLISH * (HOSTS - 1) * k * 8 for k in ks)
    print(f"leg tier-1 controller ({cw // CTL_PUBLISH} chunks of "
          f"{CTL_PUBLISH} windows, dcn {CTL_DCN:,} B a tick): wall "
          f"{wall_c:.2f} s, launches {counts_c}, frac after each chunk "
          f"{ex_c.last_tier1_fracs}, host replay {replay}; tier-1 wire "
          f"{by_c['wire_bytes']:,} B (replayed {want_wire:,}); ticks a "
          f"window {int(res_c.wall_ticks[0])}")
    if ex_c.last_tier1_fracs != replay or by_c["wire_bytes"] != want_wire:
        fail("tier-1 controller: trajectory or bytes differ from the host "
             "replay")
    for k in sorted(set(ks)):
        topk_equal(partial, k, f"({HOSTS}, {n_flat}) controller ladder")
    print(f"check top-k vs plain, bitwise, at every k of the ladder "
          f"{sorted(set(ks))}: equal")

    # -- the new kernel shapes, timed -----------------------------------------
    warm = time_ms(lambda: vq_fused.vq_topk(partial, k1), 100)
    tk, tl = in_turns(lambda: vq_fused.vq_topk(partial, k1),
                      lambda: torch.topk(partial.abs(), k1, dim=1), 50)
    tp = kernel_ms(lambda: vq_fused.vq_topk_plain(partial, k1), 5)
    tb = bound(4 * 2 * HOSTS * n_flat + 8 * HOSTS * k1, HOSTS * n_flat)
    print(f"timing top-k ({HOSTS}, {n_flat}), k={k1}, tier-1 partial: kernel "
          f"{r4(tk)} ms, torch.topk(|x|) {r4(tl)} ms (in turns), plain "
          f"{tp:.4f} ms, bound {tb[0]:.4f} ms ({tb[1]}); warm {warm:.4f} ms")
    xg = normal_payload[:wph].contiguous()
    rk, rl = in_turns(lambda: ring.ring_all_reduce(xg),
                      lambda: torch.sum(xg, dim=0), 200)
    rp = kernel_ms(lambda: ring.ring_all_reduce_plain(xg), 10)
    rb = bound(4 * (wph + 1) * n_flat, (wph - 1) * n_flat)
    print(f"timing ring ({wph}, {n_flat}): kernel {r4(rk)} ms, "
          f"torch.sum(x, dim=0) {r4(rl)} ms (in turns), plain {rp:.4f} ms, "
          f"bound {rb[0]:.4f} ms ({rb[1]})")

    # where the time goes: 200 windows of leg 2
    hs_ex = MeshExecutor(InstantNetwork(), device=dev,
                         transport=comm.HierarchicalTransport(
                             "xla", comm.get_transport("sparse", frac=frac1),
                             topology=topo))
    profile("--hosts 2, sparse tier 1",
            lambda: hs_ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU],
                              eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")


def pool_windows(total: int, m: int, boundaries) -> tuple[int, int]:
    """``(windows, late points)`` an elastic run takes from a pool of
    ``total`` points starting at ``m`` workers, with ``boundaries`` the
    ``(window, new M)`` resizes in order: a shrink first takes its departing
    workers' window of points, where the pool still holds it."""
    cursor = win = late = 0
    for at, new_m in boundaries:
        seg = min((total - cursor) // (m * TAU), at - win)
        cursor += seg * m * TAU
        win += seg
        if win < at:
            return win, late
        need = (m - new_m) * TAU
        if new_m < m and total - cursor >= need:
            cursor += need
            late += need
        m = new_m
    return win + (total - cursor) // (m * TAU), late


def elastic_legs(dev, w0, data, eval_data, runs) -> None:
    """Chaos, elastic resizes and checkpoints on stacked workers at full
    width (the module docstring's item 18, legs E1-E6)."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import async_vq
    from repro_torch.engine import (ChaosNetwork, ChaosSchedule,
                                    ElasticMeshExecutor,
                                    GeometricDelayNetwork, InstantNetwork)
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.launch import train

    late_b = 4 * KAPPA * D                                # 2,097,152
    fixed = runs["delta"][0]
    c_fixed = float(fixed.distortion[-1])

    def argv(points, *extra):
        return ["--executor", "mesh", "--workers", str(M), "--points",
                str(points), "--dim", str(D), "--kappa", str(KAPPA), "--tau",
                str(TAU), "--seed", str(SEED), "--network", "instant",
                "--scheme", "delta"] + list(extra)

    def spec(schedule):
        return ",".join(f"{w}:{m}" for w, m in schedule)

    def events(ex):
        return [(e.window, e.old_m, e.new_m, e.late_points, e.cause)
                for e in ex.resize_events]

    def same_run(a, b):
        return (same_bits(a.distortion, b.distortion)
                and same_bits(a.w_shared, b.w_shared))

    def elastic(label, args, windows, late_launches):
        zero_counts()
        res, ex, wall = train.run_vq(train.parse_args(args))
        # an observed window also launches the divergence kernel
        counts = expect_counts(label, window=windows + late_launches,
                               divergence=windows if ex.metrics else 0)
        if ex.metrics is not None:
            check_resize_obs(label, ex)
        curve = res.distortion
        print(f"leg {label}: wall {wall:.2f} s, {windows:,} windows, "
              f"launches {counts}, C first {float(curve[0]):.6f} last "
              f"{float(curve[-1]):.6f}; resizes "
              + "; ".join(f"@{e.window} M {e.old_m} -> {e.new_m} "
                          f"({e.cause}, late points {e.late_points}, wall_s "
                          f"{e.wall_s * 1e3:.2f} ms, checkpoint save "
                          f"{e.checkpoint_s * 1e3:.2f} ms)"
                          for e in ex.resize_events))
        if not (len(curve) == windows and res.w_shared.shape == (KAPPA, D)
                and bool(torch.isfinite(curve).all())
                and float(curve[-1]) < float(curve[0])):
            fail(f"{label}: result not finite, of the wrong length, or not "
                 f"going down")
        return res, ex, wall

    with tempfile.TemporaryDirectory(prefix="elastic_ckpt_") as tmp:
        # -- E1: --resize at full depth through the launcher -----------------
        ck1 = str(Path(tmp) / "e1")
        e1_args = argv(N_PER, "--resize", spec(ELASTIC_RESIZE), "--ckpt-dir",
                       ck1)
        n1, late1 = pool_windows(M * N_PER, M, ELASTIC_RESIZE)
        # observed (--metrics turns the tracer and the registry on) and
        # profiled (P3)
        res1, ex1, _ = elastic("E1 --resize " + spec(ELASTIC_RESIZE),
                               e1_args + ["--metrics",
                                          str(Path(tmp) / "e1.jsonl"),
                                          "--profile",
                                          str(Path(tmp) / "e1.prof.json")],
                               n1, 1)
        w_first = ELASTIC_RESIZE[0][0]
        head_ok = same_bits(res1.distortion[:w_first],
                            fixed.distortion[:w_first])
        gap = float(res1.distortion[-1]) / c_fixed - 1.0
        late = ex1.last_comm["by_tag"].get("late_delta")
        steps = Checkpointer(ck1).all_steps()
        print(f"check E1: first {w_first} windows == the fixed-M delta run "
              f"bitwise {head_ok}; final C {float(res1.distortion[-1]):.6f} "
              f"vs fixed-M {c_fixed:.6f} ({gap:+.4%}); late points "
              f"{late1}; late_delta {late}; checkpoints {steps}")
        want_ev, m_prev = [], M
        for w, m_new in ELASTIC_RESIZE:
            want_ev.append((w, m_prev, m_new, max(0, m_prev - m_new) * TAU,
                            "schedule"))
            m_prev = m_new
        if (not head_ok or abs(gap) > 1e-2 or events(ex1) != want_ev
                or late != {"calls": 1, "logical_bytes": late_b,
                            "wire_bytes": late_b}
                or steps != [w for w, _ in ELASTIC_RESIZE]):
            fail(f"E1: events {events(ex1)} (expected {want_ev}), the head, "
                 f"the final distortion, the late-delta record or the "
                 f"checkpoints are wrong")
        # P3: one attribution over the three M-segments
        check_attribution("P3 E1", ex1, segments=len(ELASTIC_RESIZE) + 1,
                          loops=[[("window", w), ("step", TAU)]
                                 for w in segment_windows(M * N_PER, M,
                                                          ELASTIC_RESIZE)])

        # -- E2: resume from E1's last checkpoint -----------------------------
        n2 = n1 - ELASTIC_RESIZE[-1][0]
        res2, ex2, _ = elastic("E2 --resume", e1_args + ["--resume"], n2, 0)
        ok2 = (same_bits(res2.distortion, res1.distortion[-n2:])
               and same_bits(res2.w_shared, res1.w_shared)
               and ex2.resize_events == [])
        print(f"check E2: the resumed {n2:,} windows == E1's suffix, curve "
              f"and codebook bitwise: {ok2}")
        if not ok2:
            fail("E2: the resumed run differs from E1's suffix")

        # -- E3: periodic checkpoints, no resize (cut) ------------------------
        cut = data[:, :COMM_POINTS]
        ck3 = Checkpointer(str(Path(tmp) / "e3"))
        n3 = COMM_POINTS // TAU

        def e3(resume):
            return ElasticMeshExecutor(
                [], network=InstantNetwork(), checkpointer=ck3,
                checkpoint_every=CKPT_EVERY, resume=resume, device=dev)

        zero_counts()
        t0 = time.perf_counter()
        res3 = e3(False).run("delta", w0, cut, eval_data, tau=TAU)
        res3.distortion.cpu()
        wall3 = time.perf_counter() - t0
        expect_counts("E3", window=n3)
        steps3 = ck3.all_steps()
        last3 = n3 // CKPT_EVERY * CKPT_EVERY
        zero_counts()
        res3b = e3(True).run("delta", w0, cut, eval_data, tau=TAU)
        expect_counts("E3 resume", window=n3 - last3)
        ok3 = (same_bits(res3b.distortion, res3.distortion[last3:])
               and same_bits(res3b.w_shared, res3.w_shared)
               and same_bits(res3.distortion, fixed.distortion[:n3]))
        print(f"check E3 (checkpoint_every={CKPT_EVERY}, {n3:,} windows, "
              f"wall {wall3:.2f} s): checkpoints {steps3}; resumed from "
              f"{last3} == the suffix, and the run == the fixed-M run's "
              f"head, bitwise: {ok3}")
        if not ok3 or steps3[-1] != last3:
            fail("E3: periodic checkpoint or resume differs")

    # -- E4: whole host groups leave and return, dense tiers (cut) ------------
    n4, late4 = pool_windows(M * COMM_POINTS, M, HIER_RESIZE)
    flat4, _, _ = elastic("E4 flat --resize " + spec(HIER_RESIZE),
                          argv(COMM_POINTS, "--resize", spec(HIER_RESIZE)),
                          n4, 1)
    hier4, ex4, _ = elastic(
        f"E4 --hosts {HOSTS} --tier1-transport xla",
        argv(COMM_POINTS, "--resize", spec(HIER_RESIZE), "--hosts",
             str(HOSTS), "--tier1-transport", "xla"), n4, 1)
    late4b = ex4.last_comm["by_tag"]["late_delta"]
    print(f"check E4: hier dense == flat elastic, bitwise: "
          f"{same_run(hier4, flat4)}; late points {late4}; late_delta "
          f"{late4b}")
    if (not same_run(hier4, flat4)
            or late4b["by_tier"] != {1: {"calls": 1, "logical_bytes": late_b,
                                         "wire_bytes": late_b}}):
        fail("E4: hier differs from the flat elastic run, or the late delta "
             "is not charged to tier 1")

    # -- E5: chaos at full depth ----------------------------------------------
    sched = ChaosSchedule.from_spec(CHAOS_SPEC, windows=N_PER // TAU, m=M,
                                    hosts=2)
    kills = [e.window for e in sched.kill_events]
    bounds = [(w, M - 1 - i) for i, w in enumerate(kills)]
    n5, late5 = pool_windows(M * N_PER, M, bounds)
    with tempfile.TemporaryDirectory(prefix="e5_obs_") as tmp5:
        res5, ex5, _ = elastic(f"E5 --chaos {CHAOS_SPEC}",
                               argv(N_PER, "--chaos", CHAOS_SPEC, "--metrics",
                                    str(Path(tmp5) / "e5.jsonl")), n5,
                               len(kills))
    net5 = ChaosNetwork(InstantNetwork(), sched)
    want_late, lo = 0, 0
    for (at, _), m in zip(bounds + [(n5, None)], [M] + [m for _, m in
                                                         bounds]):
        want_late += int(net5.late_matrix(m, at - lo, TAU,
                                          window0=lo).sum())
        lo = at
    fired = [(e.window, e.cause) for e in ex5.resize_events]
    print(f"check E5: {sched.describe()}; resizes {fired}; late "
          f"worker-windows {ex5.last_late_worker_windows:,} (numpy late "
          f"matrices of the segments {want_late:,}); final C "
          f"{float(res5.distortion[-1]):.6f} vs the plain delta run's "
          f"{c_fixed:.6f}")
    if (fired != [(w, "chaos_kill") for w in kills]
            or ex5.last_late_worker_windows != want_late
            or sum(e.late_points for e in ex5.resize_events) != late5):
        fail("E5: chaos kills or late worker-windows differ")
    # the reference counts a kill twice in chaos_kills: at its resize, and
    # as a scheduled event of the segment that starts at its window
    mt5 = ex5.metrics
    obs5 = (mt5.counter("chaos_kills").value,
            mt5.counter("chaos_late_worker_windows").value)
    print(f"check E5 metrics: chaos_kills {obs5[0]:.0f} (2 x {len(kills)} "
          f"kills, the reference's count), chaos_late_worker_windows "
          f"{obs5[1]:.0f} (numpy late matrices {want_late})")
    if obs5 != (2 * len(kills), want_late):
        fail("E5: chaos metrics differ from the kills and late matrices")

    # -- E6: eq. 9 over a ChaosNetwork (cut) ----------------------------------
    net6 = ChaosNetwork(GeometricDelayNetwork(P_DELAY),
                        ChaosSchedule(E6_FAULTS, hosts=2))
    n6 = E6_TICKS
    lengths6 = net6.round_lengths(torch.Generator().manual_seed(SEED), M,
                                  n6 // TAU + 2, TAU)
    zero_counts()
    t0 = time.perf_counter()
    res6 = MeshExecutor(net6, device=dev).run(
        "async_delta", w0, data[:, :n6], eval_data, tau=TAU,
        lengths=lengths6)
    curve6 = res6.distortion.cpu()
    wall6 = time.perf_counter() - t0
    counts6 = expect_counts("E6", delta=n6)
    dones = async_vq.done_mask(lengths6, M, n6, TAU, torch.device("cpu"))
    (k_win, _, k_target), = [f for f in E6_FAULTS if f[1] == "kill"]
    last = int(lengths6[k_target, :k_win].to(torch.int64).sum())
    dead_ok = bool(dones[last, k_target]) and not bool(
        dones[last + 1:, k_target].any())
    print(f"leg E6 eq. 9 over ChaosNetwork {E6_FAULTS}, {n6:,} ticks: wall "
          f"{wall6:.2f} s, launches {counts6}, C first {float(curve6[0]):.6f}"
          f" last {float(curve6[-1]):.6f}; worker {k_target}'s last round "
          f"lands at tick {last}, none after: {dead_ok}")
    if not (dead_ok and bool(torch.isfinite(curve6).all())
            and float(curve6[-1]) < float(curve6[0])):
        fail("E6: the dead worker's rounds complete, or the curve is wrong")
    n_c = ASYNC_CHECK_TICKS
    lc = lengths6[:, : n_c // TAU + 2]
    oracle = async_vq.scheme_async(w0, data[:, :n_c], eval_data, tau=TAU,
                                   lengths=lc)
    short = MeshExecutor(net6, device=dev).run(
        "async_delta", w0, data[:, :n_c], eval_data, tau=TAU, lengths=lc)
    held_to(f"E6 first {n_c} ticks vs scheme_async", res6.distortion[
        : n_c // 10], oracle.distortion, short.w_shared, oracle.w_shared)
    if not (torch.equal(short.wall_ticks, oracle.wall_ticks)
            and same_bits(short.distortion, res6.distortion[: n_c // 10])):
        fail("E6: the first ticks' run differs from the main run's head")


def check_resize_obs(label: str, ex) -> None:
    """An observed elastic run's resize metrics and spans against its
    ``ResizeStats``."""
    mt, tr = ex.metrics, ex.tracer
    stats = ex.resize_events
    spans = [(s.attrs["window"], s.attrs["old_m"], s.attrs["new_m"],
              s.attrs["cause"]) for s in tr.spans("resize")]
    got = (mt.counter("resize_events").value,
           mt.counter("late_delta_points").value,
           mt.histogram("resize_wall_s").count)
    want = (len(stats), sum(e.late_points for e in stats), len(stats))
    print(f"check {label} obs: resize_events {got[0]:.0f}, "
          f"late_delta_points {got[1]:.0f}, resize spans {spans} == "
          f"ResizeStats {want}")
    if got != want or spans != [(e.window, e.old_m, e.new_m, e.cause)
                                for e in stats]:
        fail(f"{label}: resize metrics or spans differ from ResizeStats")


def segment_windows(total: int, m: int, boundaries) -> list[int]:
    """The windows of each segment an elastic run takes from a pool of
    ``total`` points (``pool_windows``' walk, segment by segment)."""
    cursor = win = 0
    out = []
    for at, new_m in boundaries:
        seg = min((total - cursor) // (m * TAU), at - win)
        out.append(seg)
        cursor += seg * m * TAU
        win += seg
        if win < at:
            return out
        need = (m - new_m) * TAU
        if new_m < m and total - cursor >= need:
            cursor += need
        m = new_m
    return out + [(total - cursor) // (m * TAU)]


def check_attribution(label: str, ex, *, loops, segments: int = 1) -> dict:
    """A profiled run's one attribution (P1-P3): consistency within the
    reference's bar (0.15), the four terms summing to the attributed window,
    ``collective_bytes_per_window`` x windows equal to the run's ``CommLog``
    logical bytes without its host records (exactly for one segment; for
    several, to the rounding of the window weights), the programs' loops
    (``loops``: one list a program), the gauges and counters in the registry
    where one is attached; prints each term in us a window beside the card."""
    from repro_torch.obs.profile import TERMS
    prof = ex.profiler
    if len(prof.attributions) != 1:
        fail(f"{label}: {len(prof.attributions)} attributions, expected one")
    a = prof.attributions[0]
    terms = {k: a[f"t_{k}_s"] for k in TERMS}
    logical = sum(r.logical_bytes * r.calls for r in ex.transport.log.records
                  if r.op != "host")
    coll = a["collective_bytes_per_window"] * a["n_windows"]
    bytes_ok = (coll == logical if segments == 1
                else abs(coll - logical) <= 1e-12 * logical)
    sum_ok = (abs(sum(terms.values()) - a["attributed_window_s"])
              <= 1e-12 * a["attributed_window_s"])
    got_loops = sorted(p.loops for p in prof.programs.values())
    metrics_ok = True
    if ex.metrics is not None:
        names = {(r["name"], r["labels"].get("term"))
                 for r in ex.metrics.snapshot()}
        labels = {"scheme": a["scheme"], "transport": a["transport"]}
        for k in TERMS:
            want_ns = terms[k] * a["n_windows"] * 1e9
            got_ns = ex.metrics.counter(f"attributed_{k}_ns", **labels).value
            metrics_ok &= (("roofline_efficiency", k) in names
                           and (f"attributed_{k}_ns", None) in names
                           and abs(got_ns - want_ns) <= 1e-9 * want_ns
                           and ex.metrics.gauge("roofline_efficiency",
                                                term=k, **labels).value
                           == a["efficiency"][k])
    print(f"profile {label} ({card_line()}): window wall "
          f"{a['window_wall_s'] * 1e6:.1f} us = "
          + " + ".join(f"{k} {v * 1e6:.1f}" for k, v in terms.items())
          + f" us; consistency {a['consistency']:.4f}; "
          f"{a['collective_bytes_per_window']:,.1f} B a window x "
          f"{a['n_windows']:,} windows == CommLog {logical:,} B {bytes_ok}; "
          f"segments {a['segments']}; loops {got_loops}; workers a device "
          f"{a['workers_per_device']}; gauges and counters "
          f"{'in the registry' if ex.metrics is not None else 'no registry'}"
          f" {metrics_ok}")
    if (a["consistency"] > 0.15 or not sum_ok or not bytes_ok
            or got_loops != sorted(loops) or a["segments"] != segments
            or not metrics_ok):
        fail(f"{label}: the attribution is off (consistency, the terms' sum, "
             f"the bytes, the loops, the segments or the registry)")
    return a


def subprocess_legs(tmp: Path) -> None:
    """P4, P6 and P7 (the module docstring's item 20): the launcher's
    ``--profile`` and its refusal off the mesh, the dry run, and the VQ
    examples with ``train_lm_torch.py``, each a subprocess, all started at once (the card runs them
    side by side; their walls are read-outs); then the report render of
    P4's export."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    py = sys.executable
    prof_out = tmp / "p4.prof.json"
    dry_out = tmp / "p6.dryrun.json"
    cmds = {
        "P4 train --profile": [
            py, "-m", "repro_torch.launch.train", "--mode", "vq",
            "--executor", "mesh", "--scheme", "average", "--workers", str(M),
            "--points", str(P4_POINTS), "--dim", str(D), "--kappa",
            str(KAPPA), "--tau", str(TAU), "--seed", str(SEED),
            "--profile", str(prof_out)],
        "P4 --executor sim --profile": [
            py, "-m", "repro_torch.launch.train", "--mode", "vq",
            "--executor", "sim",
            "--profile", str(tmp / "sim.prof.json")],
        "P6 dryrun --comm": [py, "-m", "repro_torch.launch.dryrun",
                             "--comm", "--out", str(dry_out)],
        **{f"P7 {stem}_torch.py": [py, str(ROOT / "examples"
                                          / f"{stem}_torch.py")]
           for stem in EXAMPLES},
    }
    want_rc = {name: 2 if "sim" in name else 0 for name in cmds}
    logs = {name: tmp / f"leg{i}.log" for i, name in enumerate(cmds)}
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, cmd in cmds.items():
            with open(logs[name], "w") as log:
                procs[name] = subprocess.Popen(
                    cmd, cwd=tmp, env=env, stdout=log,
                    stderr=subprocess.STDOUT)
        # each one's wall: from the common start to its exit
        walls = {}
        while len(walls) < len(procs):
            if time.perf_counter() - t0 > SUBPROCESS_TIMEOUT_S:
                fail(f"subprocess legs still running after "
                     f"{SUBPROCESS_TIMEOUT_S} s: "
                     f"{sorted(set(procs) - set(walls))}")
            for name, proc in procs.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = {name: path.read_text() for name, path in logs.items()}
    for name, proc in procs.items():
        lines = outs[name].strip().splitlines()
        print(f"leg {name}: exit {proc.returncode} (expected "
              f"{want_rc[name]}) after {walls[name]:.2f} s (side by side); "
              f"last line: {lines[-1] if lines else ''}")
        if proc.returncode != want_rc[name]:
            print(outs[name])
            fail(f"{name}: exit {proc.returncode}, expected {want_rc[name]}")
    for line in outs["P4 train --profile"].splitlines():
        if line.startswith(("profile", "scheme", "average", "done")):
            print(f"  P4: {line}")
    doc = json.loads(prof_out.read_text())
    (a,) = doc["attributions"]
    p4_loops = [[list(x) for x in p["loops"]] for p in doc["programs"].values()]
    print(f"check P4 export: {len(doc['attributions'])} attribution, "
          f"consistency {a['consistency']:.4f}, {a['n_windows']:,} windows, "
          f"loops {p4_loops}")
    if (a["consistency"] > 0.15 or a["n_windows"] != P4_POINTS // TAU
            or p4_loops != [[["window", P4_POINTS // TAU], ["step", TAU]]]):
        fail("P4: the launcher's profile export is off")
    html = tmp / "perf_report.html"
    rep = subprocess.run(
        [py, "-m", "repro_torch.obs.report", "--dir", str(ROOT), "--out",
         str(html), "--profile", str(prof_out)], cwd=tmp, env=env,
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S)
    text = html.read_text() if html.exists() else ""
    print(f"check P4 report: exit {rep.returncode}, {len(text):,} B of HTML, "
          f"attribution section {'Roofline attribution' in text}, the "
          f"export named {prof_out.name in text}; {rep.stdout.strip()}")
    if (rep.returncode != 0 or "Roofline attribution" not in text
            or prof_out.name not in text):
        fail(f"P4: the report did not render the export: {rep.stderr}")

    # P6: the dry run's bytes against the committed baselines
    recs = json.loads(dry_out.read_text())

    def bench(name):
        return [r for r in json.loads((ROOT / name).read_text())["results"]
                if r.get("kind") == "cell"]

    bad = []
    for c in bench("BENCH_comm.json"):
        got = next(r for r in recs if r["arch"] == "comm"
                   and r["shape"] == c["scheme"]
                   and r["transport"] == c["transport"])
        bad += [("comm", c["scheme"], c["transport"], k) for k in (
            "merge_wire_bytes", "merge_logical_bytes") if got[k] != c[k]]
    for c in bench("BENCH_hier.json"):
        if c["variant"] == "flat":
            continue
        got = next(r for r in recs if r["arch"] == "comm_hier"
                   and r["shape"] == c["scheme"]
                   and r["transport"] == c["variant"])
        bad += [("hier", c["scheme"], c["variant"], k) for k in (
            "merge_wire_bytes", "tier0_wire_bytes", "tier1_wire_bytes")
            if got[k] != c[k]]
    # BENCH_adapt.json's dynamic cell does not reproduce under the JAX the
    # repo runs (ROADMAP, reference caveats): its per-merge prices hold
    for c in bench("BENCH_adapt.json"):
        got = next(r for r in recs if r["arch"] == "comm_adapt"
                   and r["merge"] == c["merge"] and r["quant"] == c["quant"])
        if c["merge"] == "fixed":
            bad += [("adapt", "fixed", c["quant"], k) for k in (
                "merge_wire_bytes", "probe_wire_bytes", "total_wire_bytes")
                if got[k] != c[k]]
        elif (got["merge_wire_bytes"] != got["n_triggered"]
              * (c["merge_wire_bytes"] // c["n_triggered"])
              or got["probe_wire_bytes"] != c["probe_wire_bytes"]
              or not 0 < got["n_triggered"] < got["n_windows"]):
            bad.append(("adapt", "dynamic", c["quant"], got["n_triggered"]))
    print(f"check P6 dry run on the card: {len(recs)} records; bytes == "
          f"BENCH_comm.json / BENCH_hier.json, adapt held to "
          f"BENCH_adapt.json's prices: {bad or 'all'}")
    if bad:
        fail(f"P6: the dry run's bytes differ from the baselines: {bad}")


# -- item 21: one worker a process --------------------------------------------

def _pg_timed(fn, group, iters: int, dev) -> float:
    """ms a call of fn on this rank, every rank calling it at once: the
    host clock between a device sync and a group barrier at each end, over
    ``iters`` calls enqueued back to back, so a call that does not wait on
    the host (the group ring) is read as the mean of a pipeline, not as one
    call's latency."""
    import torch.distributed as dist

    from repro_torch import device as device_lib
    fn()
    device_lib.synchronize(dev)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    device_lib.synchronize(dev)
    dist.barrier(group=group)
    return (time.perf_counter() - t0) / iters * 1e3


@contextlib.contextmanager
def _host_waits():
    """Counts the host waits made inside the block: ``dist.barrier``,
    ``torch.cuda.synchronize`` and ``torch.cuda.Stream.synchronize``
    calls, by name, in the list it yields."""
    from unittest import mock

    import torch
    import torch.distributed as dist
    seen = []

    def counted(name, fn):
        def call(*args, **kwargs):
            seen.append(name)
            return fn(*args, **kwargs)
        return call

    with mock.patch.object(dist, "barrier",
                           counted("dist.barrier", dist.barrier)), \
            mock.patch.object(torch.cuda, "synchronize",
                              counted("torch.cuda.synchronize",
                                      torch.cuda.synchronize)), \
            mock.patch.object(torch.cuda.Stream, "synchronize",
                              counted("Stream.synchronize",
                                      torch.cuda.Stream.synchronize)):
        yield seen


def _g1_hops(rank: int, world, cfg: dict) -> dict:
    """G1 on this rank: G1_CALLS group-ring calls back to back on different
    inputs, with no host wait between them, each against
    ring_all_reduce_plain of the stacked rows on the card, bit for bit,
    masked and unmasked; the hop launches and host waits of those calls;
    the ring's time beside dist.all_reduce's on the same group; and on rank
    0 one hop's device time and each step's time, its waits on the
    neighbours included (``ring.step_events``)."""
    import torch

    from repro_torch.comm import ring
    from repro_torch.distributed import process_group
    from repro_torch.kernels import _build
    from repro_torch.topology import Topology
    dev = world.device
    w = world.world_size
    g = Topology.flat(w).make_groups().groups[0]
    out = {"checks": [], "times": {}}
    for n in cfg["g1_sizes"][w]:
        xs = []
        for i in range(G1_CALLS):
            gen = torch.Generator(device=dev).manual_seed(SEED + 21 + i)
            xs.append(torch.randn((w, n), generator=gen, device=dev))
        mask = (torch.arange(w, device=dev) % 3 != 1).to(torch.float32)
        ring.ring_all_reduce_group(xs[0][rank], g)   # the handle exchange
        for masked in (False, True):
            m = mask if masked else None
            before = ring.launches_ring_hop
            with _host_waits() as waits:
                got = [ring.ring_all_reduce_group(
                    x[rank], g, None if m is None else m[rank:rank + 1])
                    for x in xs]
            launched = ring.launches_ring_hop - before
            ok = all(same_bits(a, ring.ring_all_reduce_plain(x, m))
                     for a, x in zip(got, xs))
            out["checks"].append(((w, n, masked), ok, launched, waits))
        if n != cfg["pg_n"]:
            continue
        x = xs[0]
        y = x[rank].clone()
        out["barrier_ms"] = _pg_timed(lambda: process_group.barrier(g), g,
                                      cfg["iters"] * 5, dev)
        legs = {"group ring": lambda: ring.ring_all_reduce_group(x[rank], g),
                "dist.all_reduce": lambda: process_group.all_reduce(
                    y, "sum", g)}
        times = {k: [] for k in legs}
        for k in ("group ring", "dist.all_reduce", "dist.all_reduce",
                  "group ring"):
            times[k].append(_pg_timed(legs[k], g, cfg["iters"], dev))
        out["times"][n] = times
        if dev.type != "cuda":
            continue
        lib = _build.library()
        # each step's time on rank 0's stream (its waits on the neighbours'
        # counters, its kernel, its counter write), in a call after a synced
        # barrier
        process_group.barrier(g)
        ring.step_events = [] if rank == 0 else None
        try:
            ring.ring_all_reduce_group(x[rank], g)
        finally:
            events, ring.step_events = ring.step_events, None
        torch.cuda.synchronize()
        if rank == 0:
            out["step_ms"] = [a.elapsed_time(b) for a, b in events]
        process_group.barrier(g)
        if rank == 0:
            # one reduce-scatter hop's device time: the kernel alone, rank 0
            # launching while the others wait at the barrier below
            st = ring._staging[(id(g), w * (-(-n // w)))]
            chunk = -(-n // w)
            stream = _build.current_stream(dev)
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(21)]
            for a, b in ev:
                a.record()
                _build.check(lib.vq_ring_hop_f32(st.left, st.mine, 0, chunk,
                                                 1, stream), "hop")
                b.record()
            torch.cuda.synchronize()
            out["hop_ms"] = sorted(a.elapsed_time(b) for a, b in ev)[10]
        process_group.barrier(g)
    return out


def _pg_world4(rank: int, world, cfg: dict) -> dict:
    """G1 at 4 ranks, then G3 (eq. 9), G4 (the lookup plans) and G5 (the
    dvq steps) in the same world."""
    import torch

    from repro_torch.comm import ring
    from repro_torch.core import dvq
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import GeometricDelayNetwork
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.serve.lookup import ShardedLookup
    from repro_torch.topology import Topology
    out = {"g1": _g1_hops(rank, world, cfg)}
    dev = world.device
    flat = Topology.flat(world.world_size).make_groups()
    g = flat.groups[0]
    # G3: eq. 9 over the group ring on the parent's round lengths
    args = train.parse_args(cfg["g3_args"])
    w0, data, eval_data = train.make_inputs(args, dev)
    ex = MeshExecutor(GeometricDelayNetwork(P_DELAY), transport="ring",
                      group=flat, device=dev)
    zero_counts()
    res = ex.run("async_delta", w0, data, eval_data, tau=TAU,
                 lengths=torch.from_numpy(cfg["g3_lengths"]))
    counts = {**launch_counts(), "ring_hop": ring.launches_ring_hop}
    out["g3"] = (res.w_shared.cpu(), res.distortion.cpu(), counts,
                 ex.last_comm)
    # G4: both sharded plans against the direct plan, bit for bit
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    z = torch.randn((FLUSH_ROWS, D), generator=gen, device=dev)
    out["g4"] = []
    for kappa in cfg["g4_kappas"]:
        w = torch.randn((kappa, D), generator=gen, device=dev)
        a, m = ops.vq_assign(z, w)
        for mode in ("shard_batch", "shard_kappa"):
            ga, gm = ShardedLookup(mode=mode, group=g, device=dev).assign(z, w)
            out["g4"].append((kappa, mode, same_bits(ga, a)
                              and same_bits(gm, m)))
    # G5: the group window step against the stacked one, and the minibatch
    # step over (data 2, model 2) against the unsharded step
    zwin = data[:, :TAU].contiguous()
    step_g = dvq.make_window_vq_step(tau=TAU, group=g, transport="ring")
    step_s = dvq.make_window_vq_step(tau=TAU, transport="ring")
    wg, _ = step_g(w0, 0, zwin[rank:rank + 1])
    ws, _ = step_s(w0, 0, zwin)
    out["g5_window"] = (same_bits(wg, ws), float((wg - ws).abs().max()))
    grid = Topology.flat(world.world_size).make_groups(model=2)
    rows = cfg["g5_batch"] // 2
    zb = data[0, :cfg["g5_batch"]].contiguous()
    di, mi = grid.index("data"), grid.index("model")
    k_local = w0.shape[0] // 2
    step_m = dvq.make_minibatch_vq_step(data_group=grid.group("data"),
                                        model_group=grid.group("model"))
    c, _, a = step_m.stats(w0[mi * k_local:(mi + 1) * k_local].contiguous(),
                           zb[di * rows:(di + 1) * rows].contiguous())
    cf, _, af = dvq.make_minibatch_vq_step().stats(w0, zb)
    out["g5_minibatch"] = (
        bool(torch.equal(a, af[di * rows:(di + 1) * rows])),
        bool(torch.equal(c, cf[mi * k_local:(mi + 1) * k_local])))
    return out


def _pg_world8(rank: int, world, cfg: dict) -> dict:
    """G1 at 8 ranks, then G2's gloo and average legs through the executor
    (the launcher's inputs and executor, without a torchrun start each)."""
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import InstantNetwork
    from repro_torch.launch import train
    from repro_torch.topology import Topology
    out = {"g1": _g1_hops(rank, world, cfg), "g2": {}}
    flat = Topology.flat(world.world_size).make_groups()
    for name, argv in cfg["g2_legs"].items():
        args = train.parse_args(argv)
        w0, data, eval_data = train.make_inputs(args, world.device)
        ex = MeshExecutor(InstantNetwork(), transport=args.transport,
                          group=flat, device=world.device)
        t0 = time.perf_counter()
        res = ex.run(args.scheme, w0, data, eval_data, tau=TAU)
        wall = time.perf_counter() - t0     # run() ends synced and barriered
        out["g2"][name] = {"w_shared": res.w_shared.cpu(),
                           "distortion": res.distortion.cpu(),
                           "wall_s": wall}
    return out


def _check_g1(label: str, outs: list) -> dict:
    """Every rank's G1 checks: G1_CALLS calls back to back, each == plain
    bit for bit, 2 (M - 1) hops a call and no host wait among them."""
    for r, o in enumerate(outs):
        for (w, n, masked), ok, launched, waits in o["g1"]["checks"]:
            want = G1_CALLS * 2 * (w - 1)
            print(f"check G1 hop kernel ({w}, {n:,}){' masked' if masked else ''}"
                  f" rank {r}: {G1_CALLS} calls back to back == plain "
                  f"bitwise {ok}, hop launches {launched} (want {want}), "
                  f"host waits {len(waits)} (want 0)")
            if not ok or launched != want or waits:
                fail(f"G1 {label}: the group ring on rank {r} differs from "
                     f"the plain version, launched {launched} hops or "
                     f"waited on the host ({waits})")
    return outs[0]["g1"]


def g2_full(cpu: list) -> list:
    """The launcher's arguments that G2's legs share (``G2_LEGS`` adds
    each leg's own): M workers at the slice's width."""
    return ["--mode", "vq", "--executor", "mesh", "--workers", str(M),
            "--dim", str(D), "--kappa", str(KAPPA), "--tau", str(TAU),
            "--seed", str(SEED), "--network", "instant", *cpu]


def _torchrun(n: int, argv: list, tmp: Path, label: str, env: dict
              ) -> tuple[str, float]:
    """``torchrun --standalone --nproc-per-node n -m
    repro_torch.launch.train argv``; returns (its output, its wall s)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
           *argv]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                         text=True, timeout=SUBPROCESS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:])
        print(res.stderr[-4000:])
        fail(f"{label}: torchrun exited {res.returncode}")
    return res.stdout, wall


def _per_rank_launches(text: str) -> dict:
    line = next(x for x in text.splitlines()
                if x.startswith("launches per rank: "))
    return json.loads(line[len("launches per rank: "):])


def _process_curve_rule(label, got, want, window_eq: bool, eval_eq: bool
                        ) -> None:
    """A process run against the stacked run: codebook and curve bit for
    bit where a (1, tau, d) window and a (1, n, d) eval give row i of the
    (M, ...) ones; the curve at rtol=1e-6 where only the eval differs; both
    at rtol=1e-4, atol=1e-6 where the window does."""
    import torch
    w_eq = same_bits(got["w_shared"], want["w_shared"])
    c_eq = same_bits(got["distortion"], want["distortion"])
    c_err = float(((got["distortion"] - want["distortion"]).abs()
                   / want["distortion"].abs()).max())
    w_err = float((got["w_shared"] - want["w_shared"]).abs().max())
    print(f"check {label}: codebook bitwise {w_eq} (max |diff| {w_err:.3e}),"
          f" curve bitwise {c_eq} (max rel {c_err:.3e}); per-window wall "
          f"{got['wall_s'] / len(got['distortion']) * 1e3:.3f} ms (processes)"
          f" vs {want['wall_s'] / len(want['distortion']) * 1e3:.3f} ms "
          f"(stacked)")
    if window_eq:
        ok = w_eq and (c_eq if eval_eq else c_err <= 1e-6)
    else:
        ok = (torch.allclose(got["w_shared"], want["w_shared"], rtol=1e-4,
                             atol=1e-6)
              and torch.allclose(got["distortion"], want["distortion"],
                                 rtol=1e-4, atol=1e-6))
    if not ok:
        fail(f"{label}: the process run and the stacked run disagree")


def process_group_legs(dev, w0, data, eval_data) -> dict:
    """Item 21 (G1-G6): one worker a process on the one card.  Returns the
    hop kernel's numbers for the kernels line."""
    import contextlib
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import comm
    from repro_torch.comm import ring
    from repro_torch.core import vq
    from repro_torch.distributed import process_group
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import GeometricDelayNetwork
    from repro_torch.kernels import vq_fused
    from repro_torch.launch import dryrun, train
    from repro_torch.topology import Topology
    t_item = time.perf_counter()
    # every leg's w0 is KAPPA of its M x points: cuts stop there
    for label, m, pts in (("G2 ring", M, G2_POINTS),
                          ("G2 gloo", M, G2_XLA_POINTS),
                          ("G2 average", M, G2_AVG_POINTS),
                          ("G3", G3_M, G3_TICKS)):
        if m * pts < KAPPA:
            fail(f"{label}: {m} x {pts} points cannot seed kappa={KAPPA}")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    cpu = ["--device", "cpu"] if dev.type == "cpu" else []

    # the finding G2 rests on: a (1, tau, d) window launch (and a (1, n, d)
    # eval) against row i of the (M, tau, d) one
    zwin = data[:, :TAU].contiguous()
    eps = vq.default_steps(torch.arange(1, TAU + 1, device=dev))
    whole = vq_fused.vq_window(zwin, w0, eps)
    window_eq = all(same_bits(vq_fused.vq_window(zwin[i:i + 1], w0, eps)[0],
                              whole[i]) for i in range(M))
    ev_whole = vq.distortion(eval_data, w0)
    eval_eq = all(same_bits(vq.distortion(eval_data[i:i + 1], w0)[0],
                            ev_whole[i]) for i in range(M))
    print(f"check G2 premise: a (1, {TAU}, {D}) window launch == row i of "
          f"the ({M}, {TAU}, {D}) launch bitwise: {window_eq}; a (1, "
          f"{N_EVAL}, {D}) eval == row i of the ({M}, {N_EVAL}, {D}) eval "
          f"bitwise: {eval_eq}")

    # G1 + G3-G5 in a world of 4, then G1 and two G2 legs in a world of 8
    full8, legs = g2_full(cpu), G2_LEGS
    full4 = ["--mode", "vq", "--executor", "mesh", "--workers", str(G3_M),
             "--points", str(G3_TICKS), "--dim", str(D), "--kappa",
             str(KAPPA), "--tau", str(TAU), "--seed", str(SEED), "--network",
             "geometric",
             "--p-delay", str(P_DELAY), "--scheme", "async_delta", *cpu]
    lengths = GeometricDelayNetwork(P_DELAY).round_lengths(
        torch.Generator().manual_seed(SEED + 3), G3_M,
        G3_TICKS // TAU + 2, TAU)
    cfg = {"g1_sizes": {4: (PG_N, PG_RAGGED), 8: (PG_N,)}, "pg_n": PG_N,
           "iters": PG_ITERS, "g3_args": full4,
           "g3_lengths": np.asarray(lengths), "g4_kappas": G4_KAPPAS,
           "g5_batch": G5_BATCH,
           "g2_legs": {k: full8 + legs[k] for k in ("xla delta",
                                                    "ring average")}}
    t0 = time.perf_counter()
    outs4 = process_group.spawn(_pg_world4, 4, cfg, device=dev)
    print(f"world of 4 ranks (G1, G3-G5): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    outs8 = process_group.spawn(_pg_world8, 8, cfg, device=dev)
    print(f"world of 8 ranks (G1, G2's gloo and average legs): "
          f"{time.perf_counter() - t0:.1f} s")
    g1 = {4: _check_g1("4 ranks", outs4), 8: _check_g1("8 ranks", outs8)}
    hop = {}
    for w in PG_WORLDS:
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        x = torch.randn((w, PG_N), generator=gen, device=dev)
        fold = kernel_ms(lambda: ring.ring_all_reduce(x), 50)
        plain = kernel_ms(lambda: ring.ring_all_reduce_plain(x), 5)
        t = g1[w]["times"][PG_N]
        # every rank reads its row and writes the sum: 8 M N bytes; the
        # hops move M (M - 1) 20 chunk bytes (reduce-scatter 12, all-gather
        # 8 a chunk), all through the one card's HBM
        fb = bound(8 * w * PG_N, (w - 1) * PG_N)
        chunk = -(-PG_N // w)
        hb = bound(w * (w - 1) * 20 * chunk, 0)
        hop[w] = {"ms": mean(t["group ring"]), "library_ms":
                  mean(t["dist.all_reduce"]), "plain_ms": plain,
                  "bound": fb, "fold_ms": fold}
        steps = g1[w]["step_ms"]
        print(f"timing G1 group ring ({w}, {PG_N:,}), {w} processes: "
              f"{r4(t['group ring'])} ms a call, dist.all_reduce (gloo, "
              f"CUDA tensors) {r4(t['dist.all_reduce'])} ms (in turns, host "
              f"clock, every rank; each the mean of {PG_ITERS} calls "
              f"enqueued back to back); a group barrier "
              f"{g1[w]['barrier_ms']:.4f} ms; one hop's device time "
              f"{g1[w].get('hop_ms', float('nan')):.4f} ms; the one-card "
              f"fold on the stacked rows {fold:.4f} ms; plain "
              f"{plain:.4f} ms; bound {fb[0]:.4f} ms ({fb[1]}; the hops' own "
              f"bytes {hb[0]:.4f} ms)")
        if len(steps) != 2 * w - 1:
            fail(f"G1 ({w} ranks): rank 0 timed {len(steps)} steps of a "
                 f"call, want {2 * w - 1}")
        mid = sorted(steps)[len(steps) // 2]
        print(f"timing G1 group ring ({w}, {PG_N:,}): each of the "
              f"{len(steps)} steps of one call on rank 0's stream, its waits "
              f"on the neighbours' counters, its kernel and its counter "
              f"write (CUDA events): {r4(steps)} ms; median {mid:.4f}, max "
              f"{max(steps):.4f}, sum {sum(steps):.4f} ms")

    # G3: eq. 9 in 4 processes on the stacked run's round lengths
    args4 = train.parse_args(full4)
    w04, data4, eval4 = train.make_inputs(args4, dev)
    st = MeshExecutor(GeometricDelayNetwork(P_DELAY), transport="ring",
                      device=dev).run("async_delta", w04, data4, eval4,
                                      tau=TAU, lengths=lengths)
    w3, c3, counts3, last3 = outs4[0]["g3"]
    eq_w, eq_c = same_bits(w3, st.w_shared.cpu()), same_bits(
        c3, st.distortion.cpu())
    c_err = float(((c3 - st.distortion.cpu()).abs()
                   / st.distortion.cpu().abs()).max())
    print(f"check G3 eq. 9 in {G3_M} processes ({G3_TICKS:,} ticks) vs the "
          f"stacked masked ring: codebook bitwise {eq_w}, curve bitwise "
          f"{eq_c} (max rel {c_err:.3e}); rank 0's launches {counts3}")
    bad = [r for r, o in enumerate(outs4)
           if o["g3"][2]["delta"] != G3_TICKS or o["g3"][2]["window"]]
    if bad:
        fail(f"G3: ranks {bad} did not launch one delta kernel a tick")
    if window_eq and not (eq_w and (eq_c if eval_eq else c_err <= 1e-6)):
        fail("G3: the process run differs from the stacked masked ring")
    if not window_eq and c_err > 1e-4:
        fail("G3: the process run's curve is off")

    # G4, G5
    for r, o in enumerate(outs4):
        if not all(ok for _, _, ok in o["g4"]):
            fail(f"G4: rank {r}: a sharded plan differs from direct: "
                 f"{o['g4']}")
        if not (o["g5_window"][0] or not window_eq):
            fail(f"G5: rank {r}: the group window step differs from the "
                 f"stacked one by {o['g5_window'][1]:.3e}")
        if not all(o["g5_minibatch"]):
            fail(f"G5: rank {r}: the 2 x 2 minibatch step's assignments or "
                 f"counts differ from the unsharded step's")
    print(f"check G4 lookup plans ({FLUSH_ROWS} x kappa {G4_KAPPAS} x {D}, "
          f"4 processes): shard_batch and shard_kappa == direct bitwise on "
          f"every rank")
    print(f"check G5 dvq: group window step == stacked "
          f"{[o['g5_window'][0] for o in outs4]}; 2 x 2 minibatch step == "
          f"unsharded (assignments, counts) on every rank")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--arch", "paper_vq", *cpu])
    for line in buf.getvalue().splitlines():
        print(f"  G5 dry run: {line}")
    if rc != 0 or not all(f"OK   paper_vq x {s}" in buf.getvalue()
                          for s in ("vq_stream", "vq_batch")):
        fail(f"G5: the paper_vq dry run exited {rc}")

    with tempfile.TemporaryDirectory(prefix="pg_legs_") as tmp_:
        tmp = Path(tmp_)

        # G2: the paper's sync scheme in 8 processes, through torchrun (the
        # gloo and average legs ran in the world of 8 above)
        got = dict(outs8[0]["g2"])
        for name, res in got.items():
            print(f"G2 {name} in {M} processes (executor, world of 8): "
                  f"{res['wall_s']:.2f} s wall, C(final)="
                  f"{float(res['distortion'][-1]):.5f}")
        text = {}
        for name in ("ring delta",):
            out = tmp / f"{name.replace(' ', '_')}.pt"
            text[name], wall = _torchrun(
                M, full8 + legs[name] + ["--save-result", str(out)], tmp,
                f"G2 {name}", env)
            got[name] = torch.load(out)
            print(f"G2 {name} in {M} processes: torchrun {wall:.1f} s; "
                  + " | ".join(x for x in text[name].splitlines()
                               if x.startswith(("process group", "done",
                                                "comm["))))
        want = {}
        stacked = {**legs, "ring delta, xla's depth": [
            "--scheme", "delta", "--transport", "ring", "--points",
            str(G2_XLA_POINTS)]}
        for name in ("ring delta", "ring average", "ring delta, xla's depth"):
            out = tmp / f"stacked_{len(want)}.pt"
            with contextlib.redirect_stdout(io.StringIO()):
                rc = train.main(full8 + stacked[name]
                                + ["--save-result", str(out)])
            if rc != 0:
                fail(f"G2 stacked {name}: exit {rc}")
            want[name] = torch.load(out)
            if name in got:
                _process_curve_rule(f"G2 {name} ({M} processes vs stacked)",
                                    got[name], want[name], window_eq,
                                    eval_eq)
        ref = want["ring delta, xla's depth"]
        held_to("G2 xla delta (gloo) vs the stacked ring run",
                got["xla delta"]["distortion"], ref["distortion"],
                got["xla delta"]["w_shared"], ref["w_shared"])
        c_err = float(((got["xla delta"]["distortion"] - ref["distortion"])
                       .abs() / ref["distortion"].abs()).max())
        if c_err > 1e-4:
            fail(f"G2 xla delta: curve off by {c_err:.3e} (rtol 1e-4)")
        counts2 = _per_rank_launches(text["ring delta"])
        windows = G2_POINTS // TAU
        want_hops = 2 * windows * 2 * (M - 1)     # merge + eval a window
        print(f"check G2 ring delta launches per rank: {counts2} (want "
              f"window {windows}, ring_hop {want_hops})")
        if (counts2["window"] != [windows] * M
                or counts2["ring_hop"] != [want_hops] * M
                or any(any(counts2[k]) for k in counts2
                       if k not in ("window", "ring_hop"))):
            fail("G2 ring delta: the processes' launches are off")

    # G6: NCCL at world size 1
    if dev.type == "cuda":
        with tempfile.TemporaryDirectory(prefix="nccl1_") as tmp_:
            process_group.init("nccl", rank=0, world_size=1,
                               store=dist.FileStore(f"{tmp_}/store", 1),
                               device="cuda")
            try:
                g = Topology.flat(1).make_groups().groups[0]
                x = data[:1, :1000].reshape(1, -1).contiguous()
                got6 = comm.XlaTransport(group=g).all_reduce(x)[0]
                want6 = comm.XlaTransport().all_reduce(x)[0]
                ok6 = same_bits(got6, want6)
            finally:
                process_group.destroy()
        print(f"check G6 NCCL at world size 1: dense group all-reduce == "
              f"stacked xla sum (M = 1) bitwise {ok6}; the multi-GPU NCCL "
              f"leg is unverified on this one-card machine")
        if not ok6:
            fail("G6: the NCCL all-reduce differs from the stacked sum")
    print(f"item 21 (one worker a process): {time.perf_counter() - t_item:.1f}"
          f" s")
    return {"launches": sum(counts2["ring_hop"]), "hop": hop[8]}


# -- item 24: the paper's cloud merges over processes ---------------------------

def _cloud_counts() -> dict:
    """Every wrapper's launch count in this process, the divergence and
    hop kernels' too."""
    from repro_torch.comm import ring
    from repro_torch.kernels import vq_fused
    return {**launch_counts(), "divergence": vq_fused.launches_divergence,
            "ring_hop": ring.launches_ring_hop}


def _cloud_world(rank: int, world, cfg: dict) -> dict:
    """Item 24's legs on this rank: each built as the launcher builds it
    (``train.build_executor`` over the world's groups) or, G11, as item
    17's controller leg is; G13 through ``train.run_vq`` with rank 0
    writing the files.  Returns each leg's result, launches and wall."""
    import contextlib
    import io

    import torch

    from repro_torch.distributed import process_group
    from repro_torch.engine import Tier1BudgetController
    from repro_torch.engine.mesh import MeshExecutor, process_transport
    from repro_torch.engine.network import FixedLatencyNetwork
    from repro_torch.launch import train
    from repro_torch.topology import Topology
    dev = world.device
    train.N_EVAL = cfg["n_eval"]
    groups = {}
    out = {}

    def grid(hosts: int):
        topo = Topology.from_spec(world.world_size, hosts=hosts)
        process_group.set_topology(topo)
        if hosts not in groups:
            groups[hosts] = topo.make_groups()
        return topo, groups[hosts]

    for name, argv in cfg["legs"].items():
        if name not in cfg["here"][world.world_size]:
            continue
        args = train.parse_args(argv)
        topo, g = grid(args.hosts)
        # the launcher's report and prints stay out of the script's output
        quiet = contextlib.redirect_stdout(io.StringIO())
        if name == "G13":
            zero_counts()
            t0 = time.perf_counter()
            with quiet:
                res, ex, _ = train.run_vq(args, groups=g, dev=dev)
        else:
            w0, data, eval_data = train.make_inputs(args, dev)
            if name == "G11":
                net = FixedLatencyNetwork(latency_ticks=1,
                                          dcn_bytes_per_tick=CTL_DCN)
                ex = MeshExecutor(net, transport=process_transport(
                    "xla", g, topo, tier1="sparse", tier1_frac=CTL_FRAC0),
                    tier1_controller=Tier1BudgetController(net),
                    publish_every=G11_PUBLISH, group=g, device=dev)
            else:
                with quiet:
                    ex = train.build_executor(args, dev, groups=g)
            zero_counts()
            t0 = time.perf_counter()
            # eq. 9's round lengths as the launcher draws them
            res = ex.run(args.scheme, w0, data, eval_data, tau=TAU,
                         eps0=args.eps0,
                         generator=torch.Generator().manual_seed(args.seed))
        wall = time.perf_counter() - t0      # run() ends synced, barriered
        out[name] = {"w_shared": res.w_shared.cpu(),
                     "distortion": res.distortion.cpu(), "wall_s": wall,
                     "comm": ex.last_comm, "counts": _cloud_counts(),
                     "late": ex.last_late_worker_windows,
                     "fracs": list(ex.last_tier1_fracs),
                     "triggers": (None if ex.last_triggers is None
                                  else ex.last_triggers.cpu())}
    return out


def _median_probe(dev, points: int) -> float:
    """Item 17's dynamic threshold rule at ``points`` a worker: the median
    over its windows of the threshold-0 leg's probe, sum_i ||Delta_i||^2,
    from the plain delta loop written out."""
    import torch

    from repro_torch.core import vq
    from repro_torch.engine import merge as merge_lib
    from repro_torch.kernels import vq_fused
    from repro_torch.launch import train
    w_srd, data_c, _ = train.make_inputs(train.parse_args(
        ["--mode", "vq", "--workers", str(M), "--points", str(points),
         "--dim", str(D), "--kappa", str(KAPPA), "--seed", str(SEED),
         "--device", dev.type]), dev)
    n = points // TAU
    eps = vq.default_steps(torch.arange(1, n * TAU + 1, device=dev))
    drifts = []
    for i in range(n):
        span = slice(i * TAU, (i + 1) * TAU)
        delta = merge_lib.tree_sub_f32(w_srd, vq_fused.vq_window(
            data_c[:, span].contiguous(), w_srd, eps[span]))
        drifts.append((delta * delta).sum(dim=(1, 2)).sum())
        w_srd = merge_lib.tree_apply_delta(w_srd, torch.sum(delta, dim=0))
    return float(torch.stack(drifts).cpu().median())


def cloud_process_legs(dev, w0, data, eval_data) -> None:
    """Item 24 (G7-G13): the paper's cloud merges with one worker a process
    on the one card, each leg against the stacked run of the same
    configuration."""
    import contextlib
    import io
    import shutil

    import torch

    from repro_torch import comm
    from repro_torch import device as device_lib
    from repro_torch.core import vq
    from repro_torch.distributed import process_group
    from repro_torch.engine import Tier1BudgetController, Topology
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import (FixedLatencyNetwork,
                                            GeometricDelayNetwork)
    from repro_torch.kernels import vq_fused
    from repro_torch.launch import train
    from repro_torch.obs import check as obs_check
    t_item = time.perf_counter()
    for label, m, pts in (("G7-G9, G11-G13", M, CLOUD_POINTS),
                          ("G10", M, G10_POINTS),
                          ("G7 eq. 9", G3_M, G3_TICKS)):
        if m * pts < KAPPA:
            fail(f"{label}: {m} x {pts} points cannot seed kappa={KAPPA}")
    cpu = ["--device", "cpu"] if dev.type == "cpu" else []

    def base(m, pts, *extra):
        return ["--mode", "vq", "--executor", "mesh", "--workers", str(m),
                "--points", str(pts), "--dim", str(D), "--kappa", str(KAPPA),
                "--tau", str(TAU), "--seed", str(SEED), "--network",
                "instant", *cpu, *extra]

    dyn = ["--scheme", "delta", "--transport", "ring", "--merge", "dynamic"]
    # item 17's rule over G10's own windows: its T (the median of 2,000
    # windows) is below every drift of the first few hundred, which would
    # all trigger
    thresh = _median_probe(dev, G10_POINTS)
    legs = {
        "G7": base(M, CLOUD_POINTS, "--scheme", "delta", "--transport",
                   "sparse", "--compress-frac", str(SPARSE_FRAC)),
        "G7 eq. 9": base(G3_M, G3_TICKS, "--scheme", "async_delta",
                         "--transport", "sparse", "--compress-frac",
                         str(SPARSE_FRAC), "--network", "geometric",
                         "--p-delay", str(P_DELAY)),
        "G8": base(M, CLOUD_POINTS, "--scheme", "delta", "--transport",
                   "ring", "--hosts", str(HOSTS)),
        "G9": base(M, CLOUD_POINTS, "--scheme", "delta", "--quorum",
                   "--network", "geometric", "--p-delay",
                   str(QUORUM_P_DELAY)),
        "G10 at 0": base(M, G10_POINTS, *dyn),
        "G10 at T": base(M, G10_POINTS, *dyn, "--divergence-thresh",
                         repr(thresh)),
        "G11": base(M, CLOUD_POINTS, "--scheme", "delta", "--hosts",
                    str(HOSTS)),
        "G12": base(M, CLOUD_POINTS, "--scheme", "delta", "--hosts",
                    str(HOSTS), "--chaos", G12_CHAOS),
    }
    # (a leg's own --network comes after base's: argparse keeps the last)
    tmp = Path(tempfile.mkdtemp(prefix="cloud_legs_"))
    files = {k: str(tmp / f) for k, f in (("trace", "g13.trace.json"),
                                           ("metrics", "g13.metrics.jsonl"),
                                           ("profile", "g13.prof.json"))}
    legs["G13"] = base(M, CLOUD_POINTS, "--scheme", "delta", "--transport",
                       "ring", "--trace", files["trace"], "--metrics",
                       files["metrics"], "--profile", files["profile"])
    cfg = {"legs": legs, "n_eval": N_EVAL,
           "here": {8: [k for k in legs if k != "G7 eq. 9"],
                    G3_M: ["G7 eq. 9"]}}

    # the premise of the bit-for-bit legs, as in item 21
    zwin = data[:, :TAU].contiguous()
    eps = vq.default_steps(torch.arange(1, TAU + 1, device=dev))
    whole = vq_fused.vq_window(zwin, w0, eps)
    window_eq = all(same_bits(vq_fused.vq_window(zwin[i:i + 1], w0, eps)[0],
                              whole[i]) for i in range(M))
    ev_whole = vq.distortion(eval_data, w0)
    eval_eq = all(same_bits(vq.distortion(eval_data[i:i + 1], w0)[0],
                            ev_whole[i]) for i in range(M))
    print(f"check G7-G13 premise: (1, {TAU}, {D}) window == row i "
          f"{window_eq}, (1, {N_EVAL}, {D}) eval == row i {eval_eq}")

    t0 = time.perf_counter()
    outs = process_group.spawn(_cloud_world, M, cfg, device=dev)
    print(f"world of {M} ranks (G7-G13): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    outs4 = process_group.spawn(_cloud_world, G3_M, cfg, device=dev)
    print(f"world of {G3_M} ranks (G7's eq. 9): "
          f"{time.perf_counter() - t0:.1f} s")
    got = {**outs[0], **outs4[0]}
    ranks = {k: [o[k] for o in (outs4 if k == "G7 eq. 9" else outs)]
             for k in legs}

    def stacked(argv):
        """The stacked run of a leg's configuration, through the
        launcher."""
        with contextlib.redirect_stdout(io.StringIO()):
            res, ex, wall = train.run_vq(train.parse_args(argv), dev=dev)
        return ({"w_shared": res.w_shared.cpu(),
                 "distortion": res.distortion.cpu(), "wall_s": wall}, ex)

    def every_rank_same(name):
        rs = ranks[name]
        for r, o in enumerate(rs[1:], 1):
            if not (same_bits(o["w_shared"], rs[0]["w_shared"])
                    and same_bits(o["distortion"], rs[0]["distortion"])
                    and o["comm"] == rs[0]["comm"]
                    and o["late"] == rs[0]["late"]
                    and o["fracs"] == rs[0]["fracs"]):
                fail(f"{name}: rank {r} read another run than rank 0")

    def launches(name, **want):
        for r, o in enumerate(ranks[name]):
            c = o["counts"]
            if c != {k: want.get(k, 0) for k in c}:
                fail(f"{name}: rank {r} launched {c}, expected {want} and "
                     f"no other")
        print(f"check {name} launches per rank: {ranks[name][0]['counts']} "
              f"on each of {len(ranks[name])} ranks")

    def wall_line(name, n, want, unit="window"):
        g = got[name]
        print(f"wall {name}: {g['wall_s'] / n * 1e3:.3f} ms a {unit} in "
              f"processes vs {want['wall_s'] / n * 1e3:.3f} ms stacked "
              f"({n} {unit}s)")

    def gloo_rule(name, want):
        """A leg whose tier-0 or flat sums are gloo's (another order than
        the stacked sum): its curve at rtol 1e-4, its codebook under
        ``held_to``'s rule, as item 21's G2 gloo leg."""
        g = got[name]
        held_to(f"{name}, {M} processes (gloo sums) vs stacked",
                g["distortion"], want["distortion"], g["w_shared"],
                want["w_shared"])
        c_err = float(((g["distortion"] - want["distortion"]).abs()
                       / want["distortion"].abs()).max())
        print(f"check {name}: curve max rel {c_err:.3e} (rtol 1e-4), "
              f"codebook bitwise {same_bits(g['w_shared'], want['w_shared'])}")
        if c_err > 1e-4:
            fail(f"{name}: curve off by {c_err:.3e}")

    n_win = CLOUD_POINTS // TAU
    n_flat = KAPPA * D
    k7 = comm.topk_count(n_flat, SPARSE_FRAC)

    # G7: the sparse transport over the group
    for name in legs:
        every_rank_same(name)
    want7, ex7 = stacked(legs["G7"])
    _process_curve_rule("G7 sparse, 8 processes vs stacked", got["G7"],
                        want7, window_eq, eval_eq)
    wire7 = got["G7"]["comm"]["by_tag"]["merge"]["wire_bytes"] // n_win
    print(f"check G7 merge wire {wire7:,} B a merge (want {7 * k7 * 8:,}); "
          f"== stacked CommLog {got['G7']['comm'] == ex7.last_comm}")
    if (wire7 != (M - 1) * k7 * 8 or wire7 != 293_552
            or got["G7"]["comm"] != ex7.last_comm):
        fail("G7: merge wire or the CommLog differ from the stacked run")
    launches("G7", window=n_win, topk=n_win)
    wall_line("G7", n_win, want7)
    want7a, ex7a = stacked(legs["G7 eq. 9"])
    eq_w = same_bits(got["G7 eq. 9"]["w_shared"], want7a["w_shared"])
    eq_c = same_bits(got["G7 eq. 9"]["distortion"], want7a["distortion"])
    print(f"check G7 eq. 9 over sparse in {G3_M} processes ({G3_TICKS:,} "
          f"ticks) vs stacked: codebook bitwise {eq_w}, curve bitwise "
          f"{eq_c}; CommLog equal {got['G7 eq. 9']['comm'] == ex7a.last_comm}")
    if window_eq and not (eq_w and (eq_c or not eval_eq)):
        fail("G7 eq. 9: the process run differs from the stacked run")
    if got["G7 eq. 9"]["comm"] != ex7a.last_comm:
        fail("G7 eq. 9: the CommLog differs from the stacked run's")
    launches("G7 eq. 9", delta=G3_TICKS, topk=G3_TICKS)
    wall_line("G7 eq. 9", G3_TICKS, want7a, "tick")

    # G8: --hosts 2, the ring tier 0 and a sparse tier 1
    want8, ex8 = stacked(legs["G8"])
    _process_curve_rule("G8 --hosts 2 ring tier 0 + sparse tier 1, 8 "
                        "processes vs stacked", got["G8"], want8, window_eq,
                        eval_eq)
    by8 = got["G8"]["comm"]["by_tag"]["merge"]["by_tier"]
    t0b, t1b = by8[0]["wire_bytes"] // n_win, by8[1]["wire_bytes"] // n_win
    print(f"check G8 per-tier wire {t0b:,} / {t1b:,} B a window (want "
          f"3,145,728 / 8,192); == stacked CommLog "
          f"{got['G8']['comm'] == ex8.last_comm}")
    if (t0b, t1b) != (3_145_728, 8_192) or got["G8"]["comm"] != ex8.last_comm:
        fail("G8: per-tier bytes or the CommLog differ")
    hops8 = n_win * 2 * 2 * (M // HOSTS - 1)      # merge + eval, 4-rank ring
    launches("G8", window=n_win, topk=n_win, ring_hop=hops8)
    wall_line("G8", n_win, want8)

    # G9: the quorum merge under geometric stragglers
    want9, ex9 = stacked(legs["G9"])
    late = GeometricDelayNetwork(QUORUM_P_DELAY).late_matrix(M, n_win, TAU)
    print(f"check G9 quorum late worker-windows {got['G9']['late']} "
          f"(stacked {ex9.last_late_worker_windows}, numpy "
          f"{int(late.sum())})")
    if not (got["G9"]["late"] == ex9.last_late_worker_windows
            == int(late.sum()) > 0) or got["G9"]["comm"] != ex9.last_comm:
        fail("G9: late worker-windows or the CommLog differ")
    gloo_rule("G9", want9)
    launches("G9", window=n_win)
    wall_line("G9", n_win, want9)

    # G10: the dynamic merge over the ring
    n10 = G10_POINTS // TAU
    delta10, _ = stacked(base(M, G10_POINTS, "--scheme", "delta",
                              "--transport", "ring"))
    eq0 = (same_bits(got["G10 at 0"]["w_shared"], delta10["w_shared"])
           and same_bits(got["G10 at 0"]["distortion"],
                         delta10["distortion"]))
    print(f"check G10 dynamic at 0 in processes == stacked ring delta, "
          f"bitwise: {eq0}")
    if not eq0 and window_eq and eval_eq:
        fail("G10: dynamic at threshold 0 differs from delta over the ring")
    want10, ex10 = stacked(legs["G10 at T"])
    bits = got["G10 at T"]["triggers"]
    print(f"check G10 dynamic at T = {thresh:.6e}: triggers "
          f"{int(bits.sum())} of {n10}, == stacked bits "
          f"{torch.equal(bits, ex10.last_triggers)} (every rank the same)")
    for r, o in enumerate(ranks["G10 at T"]):
        if not torch.equal(o["triggers"], ex10.last_triggers):
            fail(f"G10: rank {r}'s trigger bits differ from the stacked run")
    # the probe, the masked merge (every window: the trigger is its mask)
    # and the eval each take a ring reduce
    for name in ("G10 at 0", "G10 at T"):
        launches(name, window=n10, ring_hop=n10 * 3 * 2 * (M - 1))
    merges = int(bits.sum())
    if not 0 < merges < n10:
        fail(f"G10: {merges} of {n10} windows merged at T: no test of the "
             f"trigger")
    wall_line("G10 at 0", n10, delta10)
    wall_line("G10 at T", n10, want10)

    # G11: the tier-1 controller
    net = FixedLatencyNetwork(latency_ticks=1, dcn_bytes_per_tick=CTL_DCN)
    topo = Topology.from_spec(M, hosts=HOSTS)
    ex11 = MeshExecutor(net, transport=comm.HierarchicalTransport(
        "xla", comm.get_transport("sparse", frac=CTL_FRAC0), topology=topo),
        tier1_controller=Tier1BudgetController(net),
        publish_every=G11_PUBLISH, device=dev)
    a11 = train.parse_args(legs["G11"])
    w011, data11, eval11 = train.make_inputs(a11, dev)
    device_lib.synchronize(dev)
    t0 = time.perf_counter()
    r11 = ex11.run("delta", w011, data11, eval11, tau=TAU)
    r11.distortion.cpu()
    want11 = {"w_shared": r11.w_shared.cpu(),
              "distortion": r11.distortion.cpu(),
              "wall_s": time.perf_counter() - t0}
    print(f"check G11 controller fracs on every rank "
          f"{[o['fracs'] for o in ranks['G11']][:1]} x {M}, stacked "
          f"{ex11.last_tier1_fracs}")
    if any(o["fracs"] != ex11.last_tier1_fracs for o in ranks["G11"]):
        fail("G11: a rank's frac sequence differs from the stacked run's")
    if got["G11"]["comm"] != ex11.last_comm:
        fail("G11: the CommLog differs from the stacked run's")
    gloo_rule("G11", want11)
    launches("G11", window=n_win, topk=n_win)
    wall_line("G11", n_win, want11)

    # G12: chaos without kills over --hosts 2
    want12, ex12 = stacked(legs["G12"])
    late12 = ex12.network.late_matrix(M, n_win, TAU)
    print(f"check G12 chaos {G12_CHAOS}: late worker-windows "
          f"{got['G12']['late']} (stacked {ex12.last_late_worker_windows}, "
          f"the schedule's matrix {int(late12.sum())})")
    if not (got["G12"]["late"] == ex12.last_late_worker_windows
            == int(late12.sum()) > 0) or got["G12"]["comm"] != ex12.last_comm:
        fail("G12: the late matrix or the CommLog differ")
    gloo_rule("G12", want12)
    # the (delta, count) payload's two leaves each take a top-k on tier 1
    launches("G12", window=n_win, topk=2 * n_win)
    wall_line("G12", n_win, want12)

    # G13: G7's width over the ring, observed and profiled; rank 0's files
    sfiles = {k: str(tmp / f"stacked.{k}") for k in files}
    argv13 = [x for x in legs["G13"]]
    for k in files:
        argv13[argv13.index(files[k])] = sfiles[k]
    want13, ex13 = stacked(argv13)
    _process_curve_rule("G13 observed ring, 8 processes vs stacked",
                        got["G13"], want13, window_eq, eval_eq)
    with open(files["trace"]) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    problems = obs_check.check_trace(events, expect_spans=["merge", "window"])
    from repro_torch.obs.metrics import load_jsonl
    mirror = {}
    for rec in load_jsonl(files["metrics"]):
        if rec["name"] == "comm_wire_bytes":
            tag = rec["labels"]["tag"]
            mirror[tag] = mirror.get(tag, 0) + rec["value"]
    want_mirror = {t: v["wire_bytes"]
                   for t, v in got["G13"]["comm"]["by_tag"].items()}
    with open(files["profile"]) as f:
        prof = json.load(f)["attributions"][0]
    sprof = ex13.profiler.attributions[0]
    keys = ("t_compute_s", "t_memory_s", "t_collective_s", "window_flops",
            "window_hbm_bytes", "collective_bytes_per_window", "m",
            "workers_per_device")
    same_terms = all(prof[k] == sprof[k] for k in keys)
    print(f"check G13 check_trace: {problems or 'clean'}; comm_* mirror "
          f"{mirror} == CommLog {mirror == want_mirror}; profiler non-host "
          f"terms == stacked {same_terms} ({', '.join(f'{k} {prof[k]}' for k in keys)}); "
          f"host {prof['t_host_s'] * 1e6:.1f} us a window in processes vs "
          f"{sprof['t_host_s'] * 1e6:.1f} stacked")
    if problems or mirror != want_mirror or not same_terms:
        fail("G13: the trace, the comm_* mirror or the profiler's terms")
    launches("G13", window=n_win, divergence=n_win,
             ring_hop=n_win * 3 * 2 * (M - 1))
    wall_line("G13", n_win, want13)
    shutil.rmtree(tmp, ignore_errors=True)

    # the top-k kernel at the rank's (1, N) payload
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    x1 = torch.randn((1, n_flat), generator=gen, device=dev)
    topk_equal(x1, k7, f"(1, {n_flat}) a rank's payload")
    tk, tl = in_turns(lambda: vq_fused.vq_topk(x1, k7),
                      lambda: torch.topk(x1.abs(), k7, dim=1), 50)
    tp = kernel_ms(lambda: vq_fused.vq_topk_plain(x1, k7), 5)
    tb = bound(4 * 2 * n_flat + 8 * k7, n_flat)
    print(f"timing top-k (1, {n_flat:,}), k={k7:,}, one rank's payload: "
          f"kernel {r4(tk)} ms, torch.topk(|x|) {r4(tl)} ms (in turns), plain "
          f"{tp:.4f} ms, bound {tb[0]:.4f} ms ({tb[1]})")
    print(f"item 24 (the cloud merges over processes): "
          f"{time.perf_counter() - t_item:.1f} s")


# -- item 25: elastic runs and serving over processes --------------------------

def _elastic_serve_world(rank: int, world, cfg: dict) -> dict:
    """Item 25's legs on this rank: G14-G17 built as the launcher builds
    them over the world (``train.build_executor``), G15's resumes each from
    a directory holding one of G14's steps (rank 0 copies it), then G18's
    and G19's serving through ``serve.run_vq`` over a group spanning the
    world (rank 0 serves, the others follow).  Returns each leg's result,
    launches and wall."""
    import contextlib
    import functools
    import io
    import shutil

    import torch

    from repro_torch.distributed import process_group
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.serve import lookup as lookup_lib
    from repro_torch.topology import Topology
    dev = world.device
    train.N_EVAL = cfg["n_eval"]
    out = {}
    groups = {}
    for name, argv in cfg["train"].items():
        args = train.parse_args(argv)
        topo = Topology.from_spec(world.world_size, hosts=args.hosts)
        process_group.set_topology(topo)
        if args.hosts not in groups:
            groups[args.hosts] = topo.make_groups()
        if args.resume:
            if rank == 0:
                step = Path(cfg["ckpt"]) / f"step_{cfg['from'][name]:09d}"
                shutil.copytree(step, Path(args.ckpt_dir) / step.name)
            process_group.barrier()
        w0, data, eval_data = train.make_inputs(args, dev)
        # the launcher's prints stay out of the script's output
        with contextlib.redirect_stdout(io.StringIO()):
            ex = train.build_executor(args, dev, groups=groups[args.hosts])
        zero_counts()
        t0 = time.perf_counter()
        res = ex.run(args.scheme, w0, data, eval_data, tau=TAU,
                     eps0=args.eps0)
        wall = time.perf_counter() - t0      # run() ends synced, barriered
        out[name] = {"w_shared": res.w_shared.cpu(),
                     "distortion": res.distortion.cpu(), "wall_s": wall,
                     "comm": ex.last_comm, "counts": _cloud_counts(),
                     "late": ex.last_late_worker_windows,
                     "events": _event_rows(ex),
                     "resize_s": [e.wall_s for e in ex.resize_events]}
    g = process_group.world_group()
    assign, make = lookup_lib.ShardedLookup.assign, serve.ShardedLookup
    for name, leg in cfg["serve"].items():
        args = serve.parse_args(leg["argv"])
        calls = []

        def recorded(self, z, w):
            a, m = assign(self, z, w)
            calls.append((z, w, a, m))
            return a, m

        if rank == 0 and leg["record"]:
            lookup_lib.ShardedLookup.assign = recorded
        if leg["mode"]:
            serve.ShardedLookup = functools.partial(make, mode=leg["mode"])
        zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                run = serve.run_vq(args, codebook=leg["codebook"],
                                   sample=cfg["sample"] if rank == 0 else 0,
                                   keep=1_000_000, group=g, dev=dev)
        finally:
            lookup_lib.ShardedLookup.assign = assign
            serve.ShardedLookup = make
        o = {"rc": run.rc, "wall_s": time.perf_counter() - t0,
             "counts": _cloud_counts(), "stats": run.stats}
        if rank == 0:
            rep = run.report
            # every flush and warm-up against the one-process direct plan
            # on its own batch, after the counts were read (these launches
            # are no part of the leg)
            same = 0
            for z, w, a, m in calls:
                da, dm = ops.vq_assign(torch.as_tensor(z, device=dev), w)
                same += same_bits(a, da) and same_bits(m, dm)
            served = range(rep.versions_min, rep.versions_max + 1)
            o.update(report=rep, out=buf.getvalue(), direct=(same,
                                                             len(calls)),
                     codebooks={v: run.store.get(v).w for v in served},
                     published=run.store.version,
                     events=(None if run.trainer is None
                             else _event_rows(run.trainer)))
        out[name] = o
        calls.clear()
    return out


def _event_rows(ex) -> list:
    """An elastic run's resize events as (window, old M, new M, late
    points, cause)."""
    return [(e.window, e.old_m, e.new_m, e.late_points, e.cause)
            for e in ex.resize_events]


def _rank_windows(total: int, boundaries, kills: int = 0) -> list[int]:
    """Each rank's window launches in an elastic run over a pool of
    ``total`` points from M workers: the windows of the segments it took
    part in, and one late-delta launch where it left at a shrink (the
    pool holding its window).  ``boundaries``: the (window, new M) resizes
    in order."""
    segs = segment_windows(total, M, boundaries)
    ms = [M] + [m for _, m in boundaries]
    per = [sum(w for w, m in zip(segs, ms) if r < m) for r in range(M)]
    cursor, m = 0, M
    for (_, new_m), w in zip(boundaries, segs):
        cursor += w * m * TAU
        if new_m < m and total - cursor >= (m - new_m) * TAU:
            cursor += (m - new_m) * TAU
            for r in range(new_m, m):
                per[r] += 1
        m = new_m
    return per


def elastic_serve_process_legs(dev, trained, geo_run) -> None:
    """Item 25 (G14-G19): elastic runs and the quantization service with
    one worker a process on the one card, each leg against the stacked run
    of the same configuration (G18 against item 7's one-process serve)."""
    import contextlib
    import io
    import shutil

    from repro_torch.distributed import process_group
    from repro_torch.launch import serve, train
    t_item = time.perf_counter()
    for label, pts in (("G14", G14_POINTS), ("G16", G16_POINTS),
                       ("G17", G17_POINTS), ("G19", G19_POINTS)):
        if M * pts < KAPPA:
            fail(f"{label}: {M} x {pts} points cannot seed kappa={KAPPA}")
    cpu = ["--device", "cpu"] if dev.type == "cpu" else []
    tmp = Path(tempfile.mkdtemp(prefix="elastic_legs_"))

    def base(pts, *extra):
        return ["--mode", "vq", "--executor", "mesh", "--workers", str(M),
                "--points", str(pts), "--dim", str(D), "--kappa", str(KAPPA),
                "--tau", str(TAU), "--seed", str(SEED), "--network",
                "instant", "--scheme", "delta", *cpu, *extra]

    g14 = base(G14_POINTS, "--resize", G14_RESIZE, "--ckpt-dir")
    legs = {"G14": g14 + [str(tmp / "g14")]}
    for step in G15_FROM:
        legs[f"G15 from {step}"] = g14 + [str(tmp / f"g15_{step}"),
                                          "--resume"]
    legs["G16"] = base(G16_POINTS, "--chaos", CHAOS_SPEC)
    legs["G17"] = base(G17_POINTS, "--hosts", str(HOSTS),
                       "--tier1-transport", "xla", "--resize", G17_RESIZE)
    served = ["--mode", "vq", "--kappa", str(KAPPA), "--dim", str(D),
              "--requests", str(SERVE_REQUESTS), "--seed", str(SEED),
              "--network", "geometric", "--p-delay", str(P_DELAY), *cpu]
    g19 = served + ["--train-publish", "--points", str(G19_POINTS), "--tau",
                    str(TAU), "--publish-every", str(G19_PUBLISH)]
    codebook = trained.cpu()
    serve_legs = {
        "G18 shard_kappa": {"argv": served, "mode": None, "record": True,
                            "codebook": codebook},
        "G18 shard_batch": {"argv": served, "mode": "shard_batch",
                            "record": True, "codebook": codebook},
        "G19": {"argv": g19, "mode": None, "record": False,
                "codebook": None}}
    cfg = {"train": legs, "serve": serve_legs, "n_eval": N_EVAL,
           "sample": SERVE_SAMPLE, "ckpt": str(tmp / "g14"),
           "from": {f"G15 from {s}": s for s in G15_FROM}}

    t0 = time.perf_counter()
    outs = process_group.spawn(_elastic_serve_world, M, cfg, device=dev)
    print(f"world of {M} ranks (G14-G19): {time.perf_counter() - t0:.1f} s")
    got = outs[0]

    def stacked(argv):
        """The stacked run of a leg's configuration, through the
        launcher."""
        with contextlib.redirect_stdout(io.StringIO()):
            res, ex, wall = train.run_vq(train.parse_args(argv), dev=dev)
        return ({"w_shared": res.w_shared.cpu(),
                 "distortion": res.distortion.cpu(), "wall_s": wall,
                 "comm": ex.last_comm, "events": _event_rows(ex),
                 "late": ex.last_late_worker_windows,
                 "resize_s": [e.wall_s for e in ex.resize_events]})

    def every_rank_same(name):
        for r, o in enumerate(outs[1:], 1):
            mine, lead = o[name], got[name]
            if not (same_bits(mine["w_shared"], lead["w_shared"])
                    and same_bits(mine["distortion"], lead["distortion"])
                    and all(mine[k] == lead[k]
                            for k in ("comm", "late", "events"))):
                fail(f"{name}: rank {r} returned another run than rank 0")

    def launches(name, windows):
        for r, o in enumerate(outs):
            c = o[name]["counts"]
            want = {k: windows[r] if k == "window" else 0 for k in c}
            if c != want:
                fail(f"{name}: rank {r} launched {c}, expected {want}")
        print(f"check {name} window launches per rank: "
              f"{[o[name]['counts']['window'] for o in outs]} (segments "
              f"taken part in + late deltas), no other kernel")

    def gloo_rule(name, want):
        """Codebook and curve == the stacked run's bits, or, where gloo's
        sums take another order than the stacked sum, the curve within
        rtol 1e-4 (its largest gap printed) and the codebook under
        ``held_to``'s rule, as item 24's G9."""
        g = got[name]
        w_eq = same_bits(g["w_shared"], want["w_shared"])
        c_eq = same_bits(g["distortion"], want["distortion"])
        c_err = float(((g["distortion"] - want["distortion"]).abs()
                       / want["distortion"].abs()).max())
        print(f"check {name} vs stacked: codebook bitwise {w_eq}, curve "
              f"bitwise {c_eq}, curve max rel gap {c_err:.3e} (rtol 1e-4)")
        if not (w_eq and c_eq):
            held_to(f"{name}, {M} processes (gloo sums) vs stacked",
                    g["distortion"], want["distortion"], g["w_shared"],
                    want["w_shared"])
            if c_err > 1e-4:
                fail(f"{name}: curve off by {c_err:.3e}")

    def walls(name, want):
        g, n = got[name], len(got[name]["distortion"])
        print(f"wall {name}: {g['wall_s'] / n * 1e3:.3f} ms a window in "
              f"processes vs {want['wall_s'] / n * 1e3:.3f} ms stacked ({n} "
              f"windows); resize wall_s (ms) "
              f"{[round(x * 1e3, 3) for x in g['resize_s']]} in processes "
              f"vs {[round(x * 1e3, 3) for x in want['resize_s']]} stacked")

    def elastic_leg(name, want, total, boundaries):
        every_rank_same(name)
        g = got[name]
        print(f"check {name} events {g['events']} == stacked "
              f"{g['events'] == want['events']}; late_delta "
              f"{g['comm']['by_tag'].get('late_delta')} == stacked "
              f"{g['comm'] == want['comm']} (the whole CommLog); late "
              f"worker-windows {g['late']} (stacked {want['late']})")
        if (g["events"] != want["events"] or g["comm"] != want["comm"]
                or g["late"] != want["late"]):
            fail(f"{name}: events, the CommLog or the late worker-windows "
                 f"differ from the stacked run's")
        gloo_rule(name, want)
        launches(name, _rank_windows(total, boundaries))
        walls(name, want)

    def resizes(spec):
        return [tuple(int(x) for x in e.split(":")) for e in spec.split(",")]

    # G14: 8 -> 4 -> 8 over processes
    want14 = stacked(base(G14_POINTS, "--resize", G14_RESIZE, "--ckpt-dir",
                          str(tmp / "stacked14")))
    b14 = resizes(G14_RESIZE)
    elastic_leg("G14", want14, M * G14_POINTS, b14)
    if [e[:3] for e in got["G14"]["events"]] != [(100, 8, 4), (200, 4, 8)]:
        fail(f"G14: events {got['G14']['events']}")

    # G15: resumes from G14's step-200 and step-100 checkpoints
    for step in G15_FROM:
        name = f"G15 from {step}"
        every_rank_same(name)
        g, s = got[name], got["G14"]
        n = len(g["distortion"])
        ok = (0 < n < len(s["distortion"])
              and same_bits(g["w_shared"], s["w_shared"])
              and same_bits(g["distortion"], s["distortion"][-n:])
              and g["events"] == [e for e in s["events"] if e[0] > step])
        print(f"check {name}: {n} windows, codebook and curve == the "
              f"straight G14 run's suffix, bitwise: {ok}; events "
              f"{g['events']}; {g['wall_s'] / n * 1e3:.3f} ms a window")
        if not ok:
            fail(f"{name}: the resumed run differs from the straight run")
    # resumed launches: the segments after the step; from 100 ranks 4-7
    # sit out until the grow at 200
    segs14 = segment_windows(M * G14_POINTS, M, b14)
    after = {200: [segs14[2]] * M,
             100: [segs14[1] + segs14[2]] * 4 + [segs14[2]] * 4}
    for step in G15_FROM:
        launches(f"G15 from {step}", after[step])

    # G16: E5's chaos spec, the kills as resizes 8 -> 7 -> 6
    want16 = stacked(legs["G16"])
    kills = [(e[0], e[2]) for e in want16["events"]]
    print(f"check G16 {CHAOS_SPEC}: kills {kills}")
    if [e[1:3] for e in want16["events"]] != [(8, 7), (7, 6)]:
        fail(f"G16: the stacked run's kills {want16['events']}")
    elastic_leg("G16", want16, M * G16_POINTS, kills)

    # G17: E4's shape, whole host groups leave and return
    want17 = stacked(legs["G17"])
    elastic_leg("G17", want17, M * G17_POINTS, resizes(G17_RESIZE))
    late = got["G17"]["comm"]["by_tag"]["late_delta"]
    tiers = {t: v["wire_bytes"] for t, v in
             got["G17"]["comm"]["by_tag"]["merge"]["by_tier"].items()}
    print(f"check G17 per-tier merge wire {tiers} == stacked; late delta "
          f"on tier 1: {late.get('by_tier')}")
    if set(late.get("by_tier", {})) != {1}:
        fail("G17: the late delta is not charged to tier 1")

    # G18: the service over 8 ranks, both sharded plans
    geo = geo_run.report
    for name in ("G18 shard_kappa", "G18 shard_batch"):
        g = got[name]
        rep, st = g["report"], g["stats"]
        plan = name.split()[1]
        for r, o in enumerate(outs):
            oo = o[name]
            c = oo["counts"]
            want_a = oo["stats"].flushes + oo["stats"].warmups
            if oo["rc"] != 0 or c != {k: want_a if k == "assign" else 0
                                      for k in c}:
                fail(f"{name}: rank {r} exited {oo['rc']}, launched {c} "
                     f"for {want_a} flushes and warm-ups")
        same, n_calls = g["direct"]
        print(f"{name}: {rep.summary()}; {st.flushes} flushes (full "
              f"{st.full_flushes}, deadline {st.deadline_flushes}), "
              f"{st.warmups} warm-ups, assign launches per rank "
              f"{[o[name]['counts']['assign'] for o in outs]}; every call "
              f"== the direct plan bitwise: {same} of {n_calls}; vs item "
              f"7's one-process direct serve {geo.qps:.1f} q/s, p50 "
              f"{geo.p50_ms:.3f} ms, p99 {geo.p99_ms:.3f} ms")
        if f"plan={plan}" not in g["out"]:
            fail(f"{name}: the service did not take the {plan} plan")
        if rep.failed or not rep.versions_monotonic or same != n_calls:
            fail(f"{name}: {rep.failed} failed, monotonic "
                 f"{rep.versions_monotonic}, {same} of {n_calls} calls "
                 f"== direct")
        check_served(_served_run(g, dev))

    # G19: training while serving, the trainer over the world
    g = got["G19"]
    rep = g["report"]
    for r, o in enumerate(outs):
        oo = o["G19"]
        want_a = oo["stats"].flushes + oo["stats"].warmups
        if oo["rc"] != 0 or oo["counts"]["assign"] != want_a:
            fail(f"G19: rank {r} exited {oo['rc']}, {oo['counts']} for "
                 f"{want_a} flushes and warm-ups")
    with contextlib.redirect_stdout(io.StringIO()):
        ref = serve.run_vq(serve.parse_args(g19), sample=SERVE_SAMPLE,
                           keep=1_000_000)
    print(f"G19 --train-publish over {M} ranks: {rep.summary()}; "
          f"published {g['published']} (stacked {ref.store.version}), "
          f"trainer events {g['events']}; window launches per rank "
          f"{[o['G19']['counts']['window'] for o in outs]}; stacked: "
          f"{ref.report.summary()}")
    if (rep.failed or not rep.versions_monotonic or rep.n_versions < 2
            or g["published"] != ref.store.version
            or g["events"] != _event_rows(ref.trainer)):
        fail("G19: failed requests, versions, publications or the "
             "trainer's events")
    check_served(_served_run(g, dev))
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"item 25 (elastic runs and serving over processes): "
          f"{time.perf_counter() - t_item:.1f} s")


def _served_run(leg: dict, dev):
    """A serving leg's rank-0 report and the codebooks it served, in the
    shape ``check_served`` reads."""
    import types

    import torch

    def get(version):
        w = leg["codebooks"].get(version)
        return None if w is None else types.SimpleNamespace(
            w_device=torch.as_tensor(w, device=dev))

    return types.SimpleNamespace(report=leg["report"],
                                 store=types.SimpleNamespace(get=get))


# -- item 26: the LM's placement over processes --------------------------------

def _allclose_ratio(got, want, rtol: float = 1e-4) -> float:
    """max |got - want| / (atol + rtol |want|) with atol = 1e-5 max |want|
    (item 23 (c)'s rule): <= 1 holds."""
    want = want.float()
    got = got.float()
    atol = 1e-5 * float(want.abs().max())
    den = atol + rtol * want.abs()
    return float(((got - want).abs() / den.clamp(min=1e-30)).max())


def _tree_ratio(got, want, rtol: float = 1e-4) -> float:
    from repro_torch.optim.optimizers import tree_leaves
    return max(_allclose_ratio(a, b, rtol)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _lm_layers_params(cfg, layers: int) -> int:
    import dataclasses
    return dataclasses.replace(cfg, n_layers=layers).n_params()


def _placement_world(rank: int, world, cfg: dict) -> dict:
    """Item 26's legs on this rank of a world of 2 (gloo over CUDA tensors,
    the ranks sharing the card): L1's straight run through the launcher's
    torchrun path, L2 data parallelism (``run_lm`` over the (2, 1) grid, the
    bucket's all-reduce alone, rank 0's one-process run at the same depth,
    3 f32 SGD steps against the one-process step on the whole batch), L3
    expert parallelism over a (1, 2) grid and L4 the pipeline over a (2, 1,
    1) grid, each against the one-process run on this rank.  Returns this
    rank's readings."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch

    from repro_torch import device as device_lib
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.distributed import process_group, sharding
    from repro_torch.launch import train
    from repro_torch.models import common
    from repro_torch.models.api import get_api
    from repro_torch.optim import optimizers
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.topology import grid_groups, make_host_groups
    from repro_torch.training import pipeline, steps

    device_lib.pin_full_f32()
    if cfg["smoke"]:                   # the CPU rehearsal's widths
        registry.get_config = registry.get_smoke_config
    dev = world.device
    cuda = dev.type == "cuda"
    cpu = [] if cuda else ["--device", "cpu"]
    zero_counts()
    out: dict = {}

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def reset_peak():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

    def peak_gib():
        return (torch.cuda.max_memory_allocated(dev) / 2**30 if cuda
                else None)

    def timed(fn, reps: int = 3) -> tuple:
        """(the last result, the median wall ms of ``reps`` calls after a
        warm-up, each between device syncs; None with no reps)."""
        res = fn()
        if not reps:
            return res, None
        walls = []
        for _ in range(reps):
            del res
            device_lib.synchronize(dev)
            t0 = time.perf_counter()
            res = fn()
            device_lib.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        return res, sorted(walls)[reps // 2]

    # -- L1: the launcher's torchrun path, the straight run -----------------
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world.world_size),
                      LOCAL_RANK=str(rank))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = train.main(cfg["l1"])
    out["l1"] = {"code": code, "log": buf.getvalue()}
    if rank == 0:       # the parent's --resume under torchrun may start
        Path(cfg["l1_done"]).touch()

    full = registry.get_config("granite_8b")
    groups = make_host_groups(data=2)
    sizes = common.layout_sizes(groups)
    coords = sharding.layout_coords(groups)
    data_group = groups.group("data")

    # -- L2 (a): data parallelism at the chosen depth -----------------------
    cut = dataclasses.replace(full, n_layers=cfg["l2_layers"])
    args = train.parse_args(["--mode", "lm", "--arch", "granite_8b",
                             "--steps", str(PL_L2_STEPS), "--seed",
                             str(SEED), "--log-every", str(PL_L2_STEPS),
                             *cpu])
    free()
    reset_peak()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = train.run_lm(args, cfg=cut, groups=groups, dev=dev)
    n = sum(x.numel() for x in tree_leaves(run.state["params"]))
    l2 = {"losses": run.losses.float().numpy(),
          "gnorms": run.grad_norms.float().numpy(), "wall_s": run.wall_s,
          "peak_gib": peak_gib(), "n_params": n, "log": buf.getvalue()}
    del run
    free()
    bucket = torch.ones(n + 1, dtype=torch.float32, device=dev)
    walls = []
    for _ in range(PL_ALLREDUCE_REPS):
        device_lib.synchronize(dev)
        process_group.barrier()
        t0 = time.perf_counter()
        process_group.all_reduce(bucket, "sum", data_group)
        device_lib.synchronize(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    l2["allreduce_ms"] = walls
    l2["bucket_ok"] = bool((bucket == 2.0 ** PL_ALLREDUCE_REPS).all())
    del bucket
    free()
    if rank == 0:      # the one-process run at this depth, rank 1 waiting
        with contextlib.redirect_stdout(io.StringIO()):
            one = train.run_lm(args, cfg=cut, dev=dev)
        l2["one_wall_s"] = one.wall_s
        l2["one_losses"] = one.losses.float().numpy()
        del one
        free()
    process_group.barrier()

    # -- L2 (b): 3 f32 SGD steps against the one-process step ---------------
    c32 = dataclasses.replace(full, n_layers=LMT_CUT, dtype=torch.float32)
    sgd = optimizers.sgd(PL_SGD_LR)
    dcfg = DataConfig(c32.vocab, 64, 8, SEED)
    batches = [lm_batch(dcfg, i, device=dev) for i in range(PL_SGD_STEPS)]
    plain = steps.make_train_step(c32, sgd)
    st = steps.init_train_state(c32, sgd, SEED, device=dev)
    want = []
    for b in batches:
        st, m = plain(st, b)
        want.append(torch.stack([m["loss"], m["grad_norm"]]))
    want_params = st["params"]
    del st
    free()
    dp = steps.make_train_step(c32, sgd, data_group=data_group)
    st = steps.init_train_state(c32, sgd, SEED, device=dev)
    bspecs = sharding.batch_specs(c32, sizes, batches[0])
    got = []
    for b in batches:
        st, m = dp(st, sharding.local_tree(b, bspecs, sizes, coords))
        got.append(torch.stack([m["loss"], m["grad_norm"]]))
    l2["sgd_metrics_ratio"] = _allclose_ratio(torch.stack(got),
                                              torch.stack(want))
    l2["sgd_params_ratio"] = _tree_ratio(st["params"], want_params)
    l2["sgd_loss"] = [float(x[0]) for x in got]
    out["l2"] = l2
    del st, want_params, batches
    free()

    # -- L3: expert parallelism over a (1, 2) grid --------------------------
    ep_groups = grid_groups(np.arange(2).reshape(1, 2), ("data", "model"))
    model_group = ep_groups.group("model")
    ep_sizes = common.layout_sizes(ep_groups)
    ep_coords = sharding.layout_coords(ep_groups)
    ocfg = registry.get_config("olmoe_1b_7b")
    # capacity E: dropless at any T, as item 22 serves it
    ocfg = dataclasses.replace(ocfg, capacity_factor=float(ocfg.n_experts))
    l3: dict = {"layers": ocfg.n_layers, "experts": ocfg.n_experts}

    def ep_forward(c, params, batch):
        common.set_run_options(moe_ep=True, model_group=model_group)
        try:
            return get_api(c).forward(params, batch)
        finally:
            common.set_run_options(moe_ep=False, model_group=None)

    def ep_loss(c, params, batch):
        common.set_run_options(moe_ep=True, model_group=model_group)
        try:
            return steps.loss_and_grads(get_api(c).loss_fn, params, batch)
        finally:
            common.set_run_options(moe_ep=False, model_group=None)

    reset_peak()
    api = get_api(ocfg)
    params = api.init(SEED, device=dev)
    batch = lm_batch(DataConfig(ocfg.vocab, PL_L3_SEQ, PL_L3_ROWS, SEED), 0,
                     device=dev)
    with torch.no_grad():
        ref, l3["one_ms"] = timed(lambda: api.forward(params, batch))
        ep = sharding.moe_ep_params(ocfg, params, ep_groups)
        e_loc = ocfg.n_experts // 2
        lo = rank * e_loc
        l3["shard_ok"] = all(
            torch.equal(ep["blocks"][k], params["blocks"][k][:, lo:lo + e_loc])
            for k in ("w_gate", "w_up", "w_down"))
        l3["shard_shapes"] = [tuple(ep["blocks"][k].shape)
                              for k in ("w_gate", "w_up", "w_down")]
        del params
        free()
        logits, l3["ep_ms"] = timed(lambda: ep_forward(ocfg, ep, batch))
    l3["gap"] = _rel_gap(logits, ref)
    l3["n_diff"] = int((logits != ref).sum())
    l3["peak_gib"] = peak_gib()
    del ep, ref, logits
    free()
    o32 = dataclasses.replace(ocfg, n_layers=LMT_CUT, dtype=torch.float32)
    api = get_api(o32)
    params = api.init(SEED, device=dev)
    batch = lm_batch(DataConfig(o32.vocab, PL_L3_SEQ, PL_L3_ROWS, SEED), 0,
                     device=dev)
    loss_w, grads_w = steps.loss_and_grads(api.loss_fn, params, batch)
    with torch.no_grad():
        logits_w = api.forward(params, batch)
    ep = sharding.moe_ep_params(o32, params, ep_groups)
    grads_w = sharding.moe_ep_params(o32, grads_w, ep_groups)
    del params
    free()
    loss_g, grads_g = ep_loss(o32, ep, batch)
    with torch.no_grad():
        logits_g = ep_forward(o32, ep, batch)
    l3["f32_logits_ratio"] = _allclose_ratio(logits_g, logits_w)
    l3["f32_loss_ratio"] = _allclose_ratio(loss_g, loss_w)
    l3["f32_grads_ratio"] = _tree_ratio(grads_g, grads_w)
    out["l3"] = l3
    del ep, grads_w, grads_g, logits_w, logits_g
    free()

    # -- L4: the pipeline over a (2, 1, 1) grid -----------------------------
    pp_groups = grid_groups(np.arange(2).reshape(2, 1, 1),
                            ("pod", "data", "model"))
    l4: dict = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        gcfg = dataclasses.replace(full, n_layers=PL_L4_LAYERS, dtype=dtype)
        api = get_api(gcfg)
        params = api.init(SEED, device=dev)
        batch = lm_batch(DataConfig(gcfg.vocab, PL_L4_SEQ, PL_L4_ROWS, SEED),
                         0, device=dev)
        pp = pipeline.make_pp_loss_fn(gcfg, pp_groups, n_micro=PL_L4_MICRO)
        sp = pipeline.stage_params(params, pp_groups)
        reps = 1 if dtype == torch.bfloat16 else 0     # timed in bf16 only
        (loss_w, grads_w), one_ms = timed(
            lambda: steps.loss_and_grads(api.loss_fn, params, batch), reps)
        grads_w = pipeline.stage_params(grads_w, pp_groups)
        (loss_p, grads_p), pp_ms = timed(
            lambda: steps.loss_and_grads(pp, sp, batch), reps)
        l4[label] = {"loss": float(loss_p), "plain": float(loss_w),
                     "rel": abs(float(loss_p) - float(loss_w))
                     / abs(float(loss_w)),
                     "loss_ratio": _allclose_ratio(loss_p, loss_w),
                     "grads_ratio": _tree_ratio(grads_p, grads_w),
                     "pp_ms": pp_ms, "one_ms": one_ms,
                     "evals": len(pp.transport.log.records)}
        del params, sp, grads_w, grads_p
        free()
    out["l4"] = l4
    from repro_torch.kernels import vq_fused
    out["counts"] = {**launch_counts(),
                     "divergence": vq_fused.launches_divergence}
    return out


def placement_legs(dev) -> None:
    """Item 26 (L1-L5): the LM's placement over processes, in one spawned
    world of 2 ranks on the card and one torchrun start, each leg against
    the one-process run of the same configuration."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed import process_group, roofline

    t_item = time.perf_counter()
    card = card_line()
    smoke = dev.type == "cpu"
    cpu = ["--device", "cpu"] if smoke else []
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    tmp = Path(tempfile.mkdtemp(prefix="placement_legs_"))

    # L5 runs beside the world: host arithmetic, no device
    dry_out = tmp / "dryrun_lm.json"
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", str(dry_out)], cwd=tmp, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    # L2's depth: the deepest of item 23's that fits two AdamW replicas on
    # the card (12 B a parameter of state, the grads' 2 B, the f32 bucket's
    # 4 B and new grads' 2 B while it unpacks) and the gloo staging of two
    # f32 buckets on the host, one bucket under 2^31 entries
    full = registry.get_config("granite_8b")
    if smoke:
        layers = 2
    else:
        gc.collect()
        torch.cuda.empty_cache()
        card_free = torch.cuda.mem_get_info()[0]
        host_free = _host_available()
        fits = 0
        for depth in range(LMT_LAYERS, LMT_CUT - 1, -1):
            n = _lm_layers_params(full, depth)
            if (2 * (PL_CARD_BYTES_A_PARAM * n + PL_RANK_SLACK) <= card_free
                    and 2 * 2 * 4 * n <= host_free and n + 1 < 2**31):
                fits = depth
                break
        layers = min(fits, PL_L2_LAYERS)
        print(f"L2 depth: the memory rule allows {fits} of item 23's "
              f"{LMT_LAYERS} layers (card free {card_free / 2**30:.2f} GiB, "
              f"host available {host_free / 2**30:.2f} GiB); run at "
              f"{layers} ({_lm_layers_params(full, max(layers, 1)):,} "
              f"params), gloo's bucket rate bounding the time")
        if layers < LMT_CUT:
            fail(f"L2: not even {LMT_CUT} layers fit two replicas")

    ck = tmp / "l1"
    l1 = ["--mode", "lm", "--arch", "granite_8b", "--smoke", "--data-axis",
          "2", "--steps", str(PL_L1_STEPS), "--ckpt-every", "10",
          "--log-every", "10", "--ckpt-dir", str(ck), "--seed", str(SEED),
          *cpu]
    done = tmp / "l1_straight_done"
    cfg = {"smoke": smoke, "l1": l1, "l2_layers": layers,
           "l1_done": str(done)}
    straight = tmp / "l1_straight"
    straight.mkdir()
    last = f"step_{PL_L1_STEPS:09d}"
    resumed: dict = {}
    stop = threading.Event()

    def resume_l1():
        """Once the world's straight run is done: its step-20 checkpoint
        moved aside (a crash), then ``--resume`` under torchrun, beside the
        world's L2-L4."""
        while not done.exists():
            if stop.wait(0.2):
                return
        shutil.move(str(ck / last), str(straight / last))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
             *l1, "--resume"], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=SUBPROCESS_TIMEOUT_S)
        resumed.update(code=res.returncode, out=res.stdout, err=res.stderr,
                       wall=time.perf_counter() - t0)

    resumer = threading.Thread(target=resume_l1)
    resumer.start()
    t0 = time.perf_counter()
    try:
        outs = process_group.spawn(_placement_world, 2, cfg, device=dev)
    finally:
        stop.set()
        resumer.join()
    print(f"world of 2 ranks (L1 straight, L2-L4; L1's resume beside it): "
          f"{time.perf_counter() - t0:.1f} s")

    # -- L1 -------------------------------------------------------------------
    if resumed.get("code") != 0:
        print(resumed.get("out", "")[-4000:])
        print(resumed.get("err", "")[-4000:])
        fail(f"L1 --resume: torchrun exited {resumed.get('code')}")
    res_out, res_wall = resumed["out"], resumed["wall"]
    a, b = ck / last, straight / last
    names = sorted(p.name for p in b.iterdir())
    same = names == sorted(p.name for p in a.iterdir()) and all(
        (np.load(a / f).tobytes() == np.load(b / f).tobytes()
         and np.load(a / f).dtype == np.load(b / f).dtype)
        for f in names if f.endswith(".npy"))
    log0 = outs[0]["l1"]["log"]
    first = log0.splitlines()[0] if log0 else ""
    want_lines = [f"step {s:5d}  loss" for s in (10, PL_L1_STEPS)]
    lines_ok = (all(x in log0 for x in want_lines)
                and "mesh={'data': 2, 'model': 1}" in first
                and f"done: {PL_L1_STEPS} steps" in log0
                and outs[1]["l1"]["log"] == ""
                and "resumed from step 10" in res_out
                and "done: 10 steps" in res_out)
    # "step 20  loss ...  gnorm ..." without the tok/s, straight and resumed
    loss20, loss20r = ([x.split("  tok/s")[0] for x in text.splitlines()
                        if x.startswith(f"step {PL_L1_STEPS:5d}")]
                       for text in (log0, res_out))
    print(f"L1 torchrun --nproc-per-node 2 launch.train --mode lm --arch "
          f"granite_8b --smoke --data-axis 2: {PL_L1_STEPS} steps, ckpt "
          f"every 10 (exit codes {[o['l1']['code'] for o in outs]}); the "
          f"step-{PL_L1_STEPS} checkpoint removed, --resume from 10 under "
          f"torchrun ({res_wall:.1f} s): step-{PL_L1_STEPS} state == the "
          f"straight run's bit for bit: {same}; lines: {first!r}, "
          f"{loss20[:1]} / resumed {loss20r[:1]}")
    if not (same and lines_ok and all(o["l1"]["code"] == 0 for o in outs)
            and loss20 and loss20 == loss20r):
        print(log0)
        print(res_out)
        fail("L1: the torchrun run, its lines or its resume")

    # -- L2 -------------------------------------------------------------------
    l2 = [o["l2"] for o in outs]
    n = l2[0]["n_params"]
    step_ms = l2[0]["wall_s"] / PL_L2_STEPS * 1e3
    one_ms = l2[0]["one_wall_s"] / PL_L2_STEPS * 1e3
    ar = sorted(l2[0]["allreduce_ms"])[len(l2[0]["allreduce_ms"]) // 2]
    gap = float(np.max(np.abs(l2[0]["losses"] - l2[0]["one_losses"])
                       / np.abs(l2[0]["one_losses"])))
    print(f"L2 granite-8b at its published width, {layers} layers ({n:,} "
          f"params), data parallel over 2 ranks, {PL_L2_STEPS} steps of 8 x "
          f"64 tokens: loss {l2[0]['losses'][0]:.4f} -> "
          f"{l2[0]['losses'][-1]:.4f}; {step_ms:.1f} ms a step (the "
          f"one-process run at this depth on rank 0: {one_ms:.1f}); the f32 "
          f"bucket's all-reduce ({4 * (n + 1) / 1e9:.2f} GB) alone: "
          f"{[round(x, 1) for x in l2[0]['allreduce_ms']]} ms (median "
          f"{ar:.1f}), sum right {all(x['bucket_ok'] for x in l2)}; peak "
          f"device memory a rank {[x['peak_gib'] for x in l2]} GiB; losses "
          f"vs the one-process run's, max rel {gap:.3e} (bf16, read-out); "
          f"{card}")
    if not (all(np.isfinite(x["losses"]).all() and np.isfinite(
            x["gnorms"]).all() for x in l2)
            and np.array_equal(l2[0]["losses"], l2[1]["losses"])
            and all(x["bucket_ok"] for x in l2)):
        fail("L2: losses not finite, ranks disagree, or the bucket's sum")
    ratios = [(x["sgd_metrics_ratio"], x["sgd_params_ratio"]) for x in l2]
    print(f"L2 f32 (TF32 off), {LMT_CUT} layers, {PL_SGD_STEPS} SGD steps: "
          f"data parallel vs the one-process step on the whole batch, "
          f"|gap| / (atol + rtol |want|) at rtol 1e-4, atol 1e-5 max|x| "
          f"(<= 1 holds): loss and grad norm {[r[0] for r in ratios]}, "
          f"params {[r[1] for r in ratios]}; losses {l2[0]['sgd_loss']}")
    if max(max(r) for r in ratios) > 1.0:
        fail("L2: the f32 data-parallel steps differ from the one-process "
             "step")

    # -- L3 -------------------------------------------------------------------
    l3 = [o["l3"] for o in outs]
    print(f"L3 olmoe-1b-7b at its published config, {l3[0]['layers']} "
          f"layers, {l3[0]['experts']} experts, {l3[0]['experts'] // 2} a "
          f"rank (dropless), "
          f"moe_ep over 2 ranks: forward logits vs the one-process forward, "
          f"max rel gap {[x['gap'] for x in l3]} (bound {LM_DECODE_REL}), "
          f"{[x['n_diff'] for x in l3]} logits differ; forward "
          f"{[round(x['ep_ms'], 2) for x in l3]} ms (one process "
          f"{[round(x['one_ms'], 2) for x in l3]}); expert leaves == "
          f"local_shard {[x['shard_ok'] for x in l3]}, shapes "
          f"{l3[0]['shard_shapes']}; peak {[x['peak_gib'] for x in l3]} GiB")
    print(f"L3 f32 at {LMT_CUT} layers vs the one-process moe_apply run "
          f"(rule as L2): logits {[x['f32_logits_ratio'] for x in l3]}, loss "
          f"{[x['f32_loss_ratio'] for x in l3]}, every grad "
          f"{[x['f32_grads_ratio'] for x in l3]}")
    if not all(x["gap"] <= LM_DECODE_REL and x["shard_ok"]
               and max(x["f32_logits_ratio"], x["f32_loss_ratio"],
                       x["f32_grads_ratio"]) <= 1.0 for x in l3):
        fail("L3: expert parallelism differs from the one-process MoE")

    # -- L4 -------------------------------------------------------------------
    l4 = [o["l4"] for o in outs]
    for label in ("bf16", "f32"):
        r = [x[label] for x in l4]
        print(f"L4 granite-8b at its published width, {PL_L4_LAYERS} layers, "
              f"2 stages of {PL_L4_LAYERS // 2}, n_micro {PL_L4_MICRO}, "
              f"{PL_L4_ROWS} x {PL_L4_SEQ} tokens, {label}: pipelined loss "
              f"{r[0]['loss']:.6f} vs plain {r[0]['plain']:.6f} (rel "
              f"{r[0]['rel']:.3e}); loss ratio {[x['loss_ratio'] for x in r]},"
              f" grads ratio {[x['grads_ratio'] for x in r]} (rule as L2"
              f"{'; a read-out in bf16' if label == 'bf16' else ''}); "
              f"forward + backward {[x['pp_ms'] for x in r]} ms "
              f"pipelined, {[x['one_ms'] for x in r]} ms one "
              f"process; eval records {[x['evals'] for x in r]}")
    if not (all(x["bf16"]["rel"] <= PP_BF16_RTOL for x in l4)
            and all(max(x["f32"]["loss_ratio"], x["f32"]["grads_ratio"])
                    <= 1.0 for x in l4)
            and l4[0]["bf16"]["loss"] == l4[1]["bf16"]["loss"]):
        fail("L4: the pipelined loss or grads differ from the plain ones")

    counts = [o["counts"] for o in outs]
    if any(any(c.values()) for c in counts):
        fail(f"L1-L4: a kernel of the port's own launched {counts}; the "
             f"reference runs this path on XLA")

    # -- L5 -------------------------------------------------------------------
    text, _ = dry.communicate(timeout=SUBPROCESS_TIMEOUT_S)
    recs = json.loads(dry_out.read_text()) if dry_out.exists() else []
    skips = 2 * sum(not registry.cell_applicable(registry.get_config(a), c)[0]
                    for a in registry.ARCH_IDS for c in registry.SHAPES)
    got_skips = sum(r["status"] == "skipped" for r in recs)
    cell = next((r for r in recs if r["arch"] == "granite_8b"
                 and r["shape"] == "train_4k" and r["mesh"] == "16x16"), None)
    oks = [r for r in recs if r["status"] == "ok"]
    lowered = sum(isinstance(r["roofline"]["t_collective"], float)
                  and r["roofline"]["collective_note"] == "lowered"
                  for r in oks)
    if dry.returncode != 0 or len(recs) != 80 or got_skips != skips \
            or cell is None or any(r["status"] == "error" for r in recs) \
            or lowered != len(oks) or len(oks) != 64:
        print(text[-4000:])
        fail(f"L5: dryrun --all exited {dry.returncode}, {len(recs)} records, "
             f"{got_skips} skipped (cell_applicable: {skips}), {lowered} of "
             f"{len(oks)} ok records with a lowered collective term")
    t = cell["roofline"]
    print(f"L5 dryrun --all: exit 0, {len(recs)} records, {got_skips} "
          f"skipped (== cell_applicable's {skips}), {lowered} of {len(oks)} "
          f"ok records with a numeric collective term; granite-8b x train_4k "
          f"[16x16]: {cell['memory']['argument_bytes'] / 2**30:.3f} GiB of "
          f"arguments a device, compute {t['t_compute']:.4f} s, memory "
          f"{t['t_memory']:.4f} s, collective {t['t_collective']:.4f} s "
          f"({t['collective_note']}: {cell['collectives']['total_bytes']:,}"
          f" B), dominant {t['dominant']}, MFU bound "
          f"{t['mfu_bound']:.3f}")
    # the roofline's LM half at item 22's decode and item 23's step, one
    # device: beside the hand bounds those items print
    one = roofline.MeshShape(1, 1, 1)
    dec = roofline.roofline_terms(
        full, registry.ShapeCell("item22", "decode", 32, 4), one, None)
    t23 = dataclasses.replace(full, n_layers=LMT_LAYERS)
    trn = roofline.roofline_terms(
        t23, registry.ShapeCell("item23", "train", 64, 8), one, None)
    print(f"L5 roofline_terms on one device: item 22's decode (granite-8b, "
          f"batch 4, 32 positions) compute {dec['t_compute'] * 1e3:.3f} ms, "
          f"memory {dec['t_memory'] * 1e3:.3f} ms ({dec['device_bytes']:,.0f}"
          f" B: weights {dec['bytes_detail']['weights']:,.0f}, cache "
          f"{dec['bytes_detail']['cache']:,.0f}); item 23's step ({LMT_LAYERS}"
          f" layers, 8 x 64 tokens) compute {trn['t_compute'] * 1e3:.3f} ms "
          f"({trn['device_flops']:,.0f} FLOPs, full remat), memory "
          f"{trn['t_memory'] * 1e3:.3f} ms ({trn['device_bytes']:,.0f} B: "
          f"weights {trn['bytes_detail']['weights']:,.0f}, optimizer "
          f"{trn['bytes_detail']['opt']:,.0f}, activations "
          f"{trn['bytes_detail']['activations']:,.0f}); {card}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"item 26 (the LM's placement over processes): "
          f"{time.perf_counter() - t_item:.1f} s")


# -- item 27: the placement as a program ----------------------------------------

def _grads_rtol_ratio(got, want) -> float:
    """max over leaves of max|got - want| / (TP_GRAD_RTOL max|want|):
    <= 1 holds."""
    from repro_torch.optim.optimizers import tree_leaves
    return max(float((a.float() - b.float()).abs().max())
               / (TP_GRAD_RTOL * float(b.float().abs().max()) or 1e-30)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _tensor_parallel_world(rank: int, world, cfg: dict) -> dict:
    """Item 27's legs on this rank of a world of 2 sharing the card: (a)
    tensor and sequence parallelism over a (1, 2) grid, one forward and
    backward in bf16 (timed) and f32 against the one-process run; (b) FSDP
    and data parallelism over a (2, 1) grid, one f32 AdamW step against
    the one-process step; (c) greedy decoding over a sequence-split cache
    on the (1, 2) grid in f32 against one process.  Each placed leg records
    its collectives.  Returns this rank's readings."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import device as device_lib
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.distributed import process_group, sharding
    from repro_torch.models import common
    from repro_torch.models.api import get_api
    from repro_torch.optim import optimizers
    from repro_torch.topology import grid_groups
    from repro_torch.training import steps

    device_lib.pin_full_f32()
    if cfg["smoke"]:                   # the CPU rehearsal's widths
        registry.get_config = registry.get_smoke_config
    dev = world.device
    cuda = dev.type == "cuda"
    zero_counts()
    full = registry.get_config("granite_8b")
    tp = grid_groups(np.arange(2).reshape(1, 2), ("data", "model"))
    dp = grid_groups(np.arange(2).reshape(2, 1), ("data", "model"))
    out: dict = {}

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def sync():
        device_lib.synchronize(dev)

    def wall(fn) -> tuple:
        """(fn's result, its wall ms between device syncs)."""
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, (time.perf_counter() - t0) * 1e3

    def placed(groups, fsdp: bool, fn):
        common.set_run_options(layout=groups, fsdp=fsdp)
        try:
            return fn()
        finally:
            common.set_run_options(layout=None, fsdp=False)

    def shard(tree, groups, c, fsdp: bool):
        sizes = common.layout_sizes(groups)
        return sharding.local_tree(
            tree, sharding.param_specs(c, sizes, use_fsdp=fsdp), sizes,
            sharding.layout_coords(groups))

    # -- (a) TP + SP on model = 2 ---------------------------------------------
    a: dict = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        c = dataclasses.replace(full, n_layers=TP_LAYERS, dtype=dtype)
        api = get_api(c)
        params = api.init(SEED, device=dev)
        batch = lm_batch(DataConfig(c.vocab, TP_SEQ, TP_ROWS, SEED), 0,
                         device=dev)

        def one():
            return steps.loss_and_grads(api.loss_fn, params, batch)

        def run():
            with process_group.record_collectives() as log:
                loss, grads = steps.loss_and_grads(api.loss_fn, local, batch)
                pl = common.placement(c)
                loss, grads = steps.sync_grads(pl, loss, grads)
                steps.clip_placed(pl, grads, 1.0)
            return loss, grads, log.bytes_by_kind()

        one()                                    # warm-up
        (loss_w, grads_w), one_ms = wall(one)
        grads_w = shard(grads_w, tp, c, False)
        local = shard(params, tp, c, False)
        del params
        free()
        placed(tp, False, run)                   # warm-up
        (loss_p, grads_p, by), tp_ms = wall(lambda: placed(tp, False, run))
        a[label] = {"loss": float(loss_p), "plain": float(loss_w),
                    "rel": abs(float(loss_p) - float(loss_w))
                    / abs(float(loss_w)),
                    "grads_ratio": _grads_rtol_ratio(grads_p, grads_w),
                    "tp_ms": tp_ms, "one_ms": one_ms, "bytes": by}
        del local, grads_w, grads_p
        free()
    out["a"] = a

    # -- (b) FSDP + DP on data = 2: one AdamW step --------------------------------
    c = dataclasses.replace(full, n_layers=TP_LAYERS, dtype=torch.float32)
    opt = optimizers.adamw(TP_LR)
    st = steps.init_train_state(c, opt, SEED, device=dev)
    batch = lm_batch(DataConfig(c.vocab, TP_SEQ, TP_ROWS, SEED), 0,
                     device=dev)
    (st_w, m_w), one_ms = wall(lambda: steps.make_train_step(c, opt)(
        st, batch))
    want = shard(st_w["params"], dp, c, True)
    # AdamW's first moment after one step is (1 - b1) x the clipped grads
    mu_w = shard(st_w["opt_state"].mu, dp, c, True)
    del st_w
    local = shard(st["params"], dp, c, True)
    del st
    free()
    lst = {"params": local, "opt_state": opt.init(local),
           "step": torch.zeros((), dtype=torch.int32, device=dev)}
    sizes = common.layout_sizes(dp)
    lb = sharding.local_tree(batch, sharding.batch_specs(c, sizes, batch),
                             sizes, sharding.layout_coords(dp))
    step = steps.make_train_step(c, opt)

    def fsdp_step():
        with process_group.record_collectives() as log:
            res = step(lst, lb)
        return res, log.bytes_by_kind()

    ((lst2, m_p), by), fsdp_ms = wall(lambda: placed(dp, True, fsdp_step))
    mu_p = lst2["opt_state"].mu
    # AdamW's step is lr g / (|g| + eps), which turns a rounding-level
    # difference of a gradient near 0 into one of up to 2 lr: the params
    # are held at L2's rule where |g| >= TP_RESOLVED of its leaf's largest
    resolved = optimizers.tree_map(
        lambda m: m.abs() >= TP_RESOLVED * m.abs().max(), mu_w)
    out["b"] = {"params_ratio": _tree_ratio(
                    optimizers.tree_map(torch.masked_select, lst2["params"],
                                        resolved),
                    optimizers.tree_map(torch.masked_select, want,
                                        resolved)),
                "params_ratio_all": _tree_ratio(lst2["params"], want),
                "grads_ratio": _grads_rtol_ratio(mu_p, mu_w),
                "resolved": sum(int(x.sum()) for x in
                                optimizers.tree_leaves(resolved)),
                "metrics_ratio": _allclose_ratio(
                    torch.stack([m_p["loss"], m_p["grad_norm"]]),
                    torch.stack([m_w["loss"], m_w["grad_norm"]])),
                "loss": float(m_p["loss"]), "plain": float(m_w["loss"]),
                "fsdp_ms": fsdp_ms, "one_ms": one_ms, "bytes": by,
                "local": sum(x.numel() for x in
                             optimizers.tree_leaves(lst2["params"]))}
    del lst, lst2, want, local, mu_p, mu_w, resolved
    free()
    # one f32 SGD step over the same placement: its update, lr x the
    # clipped grads, has no |g| + eps to magnify a rounding-level gap, so
    # every entry is held at L2's rule, as item 26's L2 holds its steps
    sgd = optimizers.sgd(PL_SGD_LR)
    st = steps.init_train_state(c, sgd, SEED, device=dev)
    st_w, m_w = steps.make_train_step(c, sgd)(st, batch)
    want = shard(st_w["params"], dp, c, True)
    local = shard(st["params"], dp, c, True)
    del st, st_w
    free()
    lst = {"params": local, "opt_state": sgd.init(local),
           "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step = steps.make_train_step(c, sgd)
    lst2, m_p = placed(dp, True, lambda: step(lst, lb))
    out["b"]["sgd_params_ratio"] = _tree_ratio(lst2["params"], want)
    out["b"]["sgd_moved_ratio"] = _tree_ratio(local, want)   # the step's size
    out["b"]["sgd_metrics_ratio"] = _allclose_ratio(
        torch.stack([m_p["loss"], m_p["grad_norm"]]),
        torch.stack([m_w["loss"], m_w["grad_norm"]]))
    del lst, lst2, want, local, lb, batch
    free()

    # -- (c) decode on a sequence-split cache, model = 2 ----------------------
    api = get_api(c)
    params = api.init(SEED, device=dev)
    prompt = lm_batch(DataConfig(c.vocab, TP_PROMPT, TP_DECODE_ROWS, SEED),
                      0, device=dev)["tokens"]
    max_len = TP_PROMPT + TP_GEN

    def greedy(p):
        """The tokens, and the collectives of the prefill and of the first
        decode step (bytes by kind)."""
        with torch.no_grad():
            with process_group.record_collectives() as pre:
                logits, cache = api.prefill(p, {"tokens": prompt}, max_len)
            toks = [logits.argmax(-1)]
            dec = None
            for _ in range(TP_GEN - 1):
                with process_group.record_collectives() as log:
                    logits, cache = api.decode_step(p, cache,
                                                    toks[-1][:, None])
                dec = log.bytes_by_kind() if dec is None else dec
                toks.append(logits[:, 0].argmax(-1))
        return torch.stack(toks, 1), pre.bytes_by_kind(), dec

    (tok_w, *_), one_ms = wall(lambda: greedy(params))
    local = shard(params, tp, c, False)
    del params
    free()
    (tok_p, pre, dec), tp_ms = wall(lambda: placed(tp, False,
                                                   lambda: greedy(local)))
    out["c"] = {"equal": bool(torch.equal(tok_p, tok_w)),
                "tokens": tok_p.cpu().tolist(), "tp_ms": tp_ms,
                "one_ms": one_ms, "prefill_bytes": pre, "decode_bytes": dec}
    del local
    free()
    out["counts"] = launch_counts()
    return out


def tensor_parallel_legs(dev) -> None:
    """Item 27 (a)-(c): the reference's placement as a program, in one
    spawned world of 2 ranks on the card, each leg against the one-process
    run, and each placed step's recorded collectives against
    ``distributed.hlo_analysis.lower_cell``'s figure for the same step.
    (d) is item 26's L5."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed import hlo_analysis, process_group

    t_item = time.perf_counter()
    card = card_line()
    smoke = dev.type == "cpu"
    t0 = time.perf_counter()
    outs = process_group.spawn(_tensor_parallel_world, 2, {"smoke": smoke},
                               device=dev)
    print(f"world of 2 ranks ((a)-(c)): {time.perf_counter() - t0:.1f} s")
    full = (registry.get_smoke_config if smoke
            else registry.get_config)("granite_8b")

    def lowered(dtype, sizes, fsdp, cell=None):
        c = dataclasses.replace(full, n_layers=TP_LAYERS, dtype=dtype)
        cell = cell or registry.ShapeCell("item27", "train", TP_SEQ,
                                          TP_ROWS)
        return hlo_analysis.lower_cell(c, cell, sizes,
                                       use_fsdp=fsdp)["bytes_by_kind"]

    tp_sizes, dp_sizes = {"data": 1, "model": 2}, {"data": 2, "model": 1}
    ok = True
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        r = [o["a"][label] for o in outs]
        want = lowered(dtype, tp_sizes, False)
        same = all(x["bytes"] == want for x in r)
        print(f"27(a) granite-8b at its published width, {TP_LAYERS} layers,"
              f" {TP_ROWS} x {TP_SEQ} tokens, TP + SP over model = 2, "
              f"{label}: loss {r[0]['loss']:.6f} vs one process "
              f"{r[0]['plain']:.6f} (rel {[x['rel'] for x in r]}); grads "
              f"max|gap| / ({TP_GRAD_RTOL} max|want|) a leaf "
              f"{[x['grads_ratio'] for x in r]}; forward + backward + sync "
              f"{[round(x['tp_ms'], 1) for x in r]} ms (one process "
              f"{[round(x['one_ms'], 1) for x in r]}); recorded bytes by kind"
              f" {r[0]['bytes']} vs lower_cell {want}: equal {same}")
        ok &= same
        if label == "bf16":
            ok &= all(x["rel"] <= PP_BF16_RTOL for x in r)
        else:
            ok &= all(x["grads_ratio"] <= 1.0 and x["rel"] <= TP_GRAD_RTOL
                      for x in r)
    if not ok:
        fail("27(a): TP + SP differs from one process, or its recorded "
             "collectives from the lowered step")
    b = [o["b"] for o in outs]
    want = lowered(torch.float32, dp_sizes, True)
    same = all(x["bytes"] == want for x in b)
    print(f"27(b) FSDP + DP over data = 2, f32, one AdamW step (lr {TP_LR}):"
          f" loss {b[0]['loss']:.6f} vs one process {b[0]['plain']:.6f}; "
          f"|gap| / (atol + rtol |want|) at rtol 1e-4, atol 1e-5 max|x| (<= 1"
          f" holds): loss and grad norm {[x['metrics_ratio'] for x in b]}; "
          f"the clipped grads' shards (AdamW's first moment) max|gap| / "
          f"({TP_GRAD_RTOL} max|want|) {[x['grads_ratio'] for x in b]}; "
          f"each rank's params where |g| >= {TP_RESOLVED} of its leaf's "
          f"largest ({[x['resolved'] for x in b]} of {b[0]['local']:,}) "
          f"{[x['params_ratio'] for x in b]}, at every entry "
          f"{[x['params_ratio_all'] for x in b]} (a read-out); the step "
          f"{[round(x['fsdp_ms'], 1) for x in b]} ms (one process "
          f"{[round(x['one_ms'], 1) for x in b]}); recorded bytes by kind "
          f"{b[0]['bytes']} vs lower_cell {want}: equal {same}")
    print(f"27(b) FSDP + DP over data = 2, f32, one SGD step (lr "
          f"{PL_SGD_LR}) against one process, L2's rule at every entry (<= 1"
          f" holds): params {[x['sgd_params_ratio'] for x in b]}, loss and "
          f"grad norm {[x['sgd_metrics_ratio'] for x in b]}; the params "
          f"before the step, on the same rule "
          f"{[x['sgd_moved_ratio'] for x in b]}")
    if not (same and all(max(x["params_ratio"], x["metrics_ratio"],
                             x["grads_ratio"], x["sgd_params_ratio"],
                             x["sgd_metrics_ratio"]) <= 1.0 for x in b)):
        fail("27(b): the FSDP steps differ from one process, or their "
             "recorded collectives from the lowered step")
    c = [o["c"] for o in outs]
    want_pre = lowered(torch.float32, tp_sizes, False, registry.ShapeCell(
        "item27", "prefill", TP_PROMPT, TP_DECODE_ROWS))
    want_dec = lowered(torch.float32, tp_sizes, False, registry.ShapeCell(
        "item27", "decode", TP_PROMPT + TP_GEN, TP_DECODE_ROWS))
    same = all(x["prefill_bytes"] == want_pre and x["decode_bytes"]
               == want_dec for x in c)
    print(f"27(c) greedy decoding, {TP_DECODE_ROWS} rows, {TP_PROMPT}-token "
          f"prompt, {TP_GEN} tokens, the cache's {TP_PROMPT + TP_GEN} "
          f"positions split over model = 2, f32: tokens == one process "
          f"{[x['equal'] for x in c]} ({c[0]['tokens'][0]}...); prefill + "
          f"decode {[round(x['tp_ms'], 1) for x in c]} ms (one process "
          f"{[round(x['one_ms'], 1) for x in c]}); recorded bytes by kind: "
          f"prefill {c[0]['prefill_bytes']} vs lower_cell {want_pre}, one "
          f"decode step {c[0]['decode_bytes']} vs lower_cell {want_dec}: "
          f"equal {same}; {card}")
    if not (same and all(x["equal"] for x in c)):
        fail("27(c): decoding over the split cache differs from one process,"
             " or its recorded collectives from the lowered cells")
    counts = [o["counts"] for o in outs]
    if any(any(v.values()) for v in counts):
        fail(f"27: a kernel of the port's own launched {counts}; the "
             f"reference runs this path on XLA")
    print(f"item 27 (the placement as a program): "
          f"{time.perf_counter() - t_item:.1f} s")


def _host_available() -> int:
    """MemAvailable from /proc/meminfo, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


# -- item 22: the LM serving path ---------------------------------------------

def _nbytes(tree) -> int:
    """Bytes of a tree's tensors (a quantized leaf's q and scale)."""
    from repro_torch.models.quantization import _leaves
    return sum(x.numel() * x.element_size()
               for leaf in _leaves(tree)
               for x in ((leaf,) if hasattr(leaf, "numel")
                         else (leaf.q, leaf.scale)))


def lm_bounds(cfg, params, b: int, t: int, max_len: int) -> dict:
    """Least times (ms) of a decode step at batch b and of a prefill of
    b x t tokens: the weights a step must read (every layer's, the head and
    the final norm; b or b x t embedding rows) with the cache and the logits
    over the HBM rate, or the matmuls' operations over the bf16 peak,
    whichever is larger."""
    from repro_torch.distributed.roofline import HBM_BW
    from repro_torch.models.quantization import _leaves
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    w_bytes = (_nbytes(params["blocks"]) + _nbytes(head)
               + _nbytes(params["final_norm"]))
    per_tok = 2 * (sum(x.numel() for x in _leaves(params["blocks"])
                       if x.dim() >= 3) + head.numel())
    row = cfg.d_model * params["embed"].element_size()
    cache = 2 * cfg.n_layers * b * max_len * cfg.n_kv_heads * cfg.head_dim \
        * 2
    logits = b * cfg.vocab * 2
    attn = 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * b * t * t
    out = {}
    for name, n_tok, extra, flops in (
            ("decode", b, cache + logits, per_tok * b),
            ("prefill", b * t, cache + logits, per_tok * b * t + attn)):
        t_bytes = (w_bytes + n_tok * row + extra) / HBM_BW * 1e3
        t_ops = flops / LM_BF16_PEAK * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
    out["weight_bytes"] = w_bytes
    return out


def _rel_gap(got, want) -> float:
    """max |got - want| over max |want|, in f32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _wave_logits(api, params, batch: dict, gen: int, max_len: int,
                 teacher=None):
    """Prefill, then ``gen`` decode steps (greedy, or fed ``teacher``'s
    tokens): (the logits of each step, prefill's first, (B, gen + 1, V);
    the tokens fed)."""
    import torch
    logits, cache = api.prefill(params, batch, max_len)
    outs, fed = [logits], []
    for s in range(gen):
        tok = (teacher[:, s:s + 1] if teacher is not None
               else torch.argmax(outs[-1], dim=-1)[:, None])
        fed.append(tok)
        logits, cache = api.decode_step(params, cache, tok)
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1), torch.cat(fed, dim=1)


def check_lm_config(dev, arch: str, *, prompt: int, gen: int, batch: int,
                    layers: int | None = None, seed: int = SEED) -> dict:
    """One wave of a config at full width (``layers`` cuts its depth):
    prefill + greedy decode, against ``forward`` over the prompt and the
    tokens decoded (prefill-by-decode == forward, at LM_DECODE_REL).
    Returns its readings."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.serve import lm_batch
    from repro_torch.models.api import get_api
    from repro_torch.models.common import layer_slice, rms_norm

    cfg = registry.get_config(arch)
    cut = ""
    if layers is not None and layers < cfg.n_layers:
        cut = f", cut from {cfg.n_layers} to {layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=layers)
    published = cfg
    if cfg.family == "moe":
        # capacity E: cap = T * k, dropless at any T (a token's k units go
        # to k experts); dropping is the one legitimate divergence of a
        # T-token forward from one-token decode steps
        cut += f", capacity_factor {cfg.n_experts} (dropless)"
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    api = get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b_in = lm_batch(cfg, batch, prompt,
                    torch.Generator(device=dev).manual_seed(seed), dev)
    toks = b_in["tokens"]
    pre = cfg.img_tokens if cfg.family == "vlm" else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, fed = _wave_logits(api, params, b_in, gen, pre + prompt + gen)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits.float()).all()):
        fail(f"LM {arch}: logits not finite")
    # forward over what the cache saw.  whisper's prefill leaves its
    # self-cache empty (the reference's quirk): its decode steps are
    # positions 0.. of the tokens fed
    if cfg.family == "encdec":
        f_in = {**b_in, "tokens": fed}
        want = api.forward(params, f_in)[:, :gen]
        got = logits[:, 1:]
    else:
        seq = torch.cat([toks, fed], dim=1)
        if cfg.family in ("ssm", "hybrid") and seq.shape[1] > 128:
            # the SSD chunk: pad to a multiple of 128; causal, so the
            # padding moves no earlier position
            pad = -seq.shape[1] % 128
            seq = torch.cat([seq, seq[:, :pad]], dim=1)
        want = api.forward(params, {**b_in, "tokens": seq})[
            :, pre + prompt - 1: pre + prompt + gen]
        got = logits
    gap = _rel_gap(got, want)
    n_diff = int((got != want).sum())
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"LM {arch} ({cfg.family}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_params():,} params{cut}): weights drawn in "
          f"{init_s:.2f} s; a wave of {batch} x {prompt} + {gen} in "
          f"{wave_s:.2f} s; prefill-by-decode vs forward max rel gap "
          f"{gap:.3e} (bound {LM_DECODE_REL}), {n_diff} of {want.numel()} "
          f"logits differ; peak {peak:.2f} GiB")
    if gap > LM_DECODE_REL:
        fail(f"LM {arch}: prefill + decode differ from forward by {gap:.3e}")
    # where the gap comes from: a decode step multiplies `batch` rows, the
    # forward all of them, and cuBLAS picks its kernel (its summation
    # order) by the shape.  Layer 0's projections whose rows take other
    # bits in the two calls; where none do and attention agrees, the gap
    # reads 0
    lp = layer_slice(params.get("blocks", params.get("dec_blocks")), 0)
    n_rows = batch * (prompt + gen)
    gen_r = torch.Generator(device=dev).manual_seed(seed)
    mats = sorted(k for k, w in lp.items()
                  if w.dim() == 2 and not k.startswith("conv"))
    moved = []
    for k in mats:
        rows = torch.randn((n_rows, lp[k].shape[0]), generator=gen_r,
                           device=dev).to(cfg.dtype)
        if not torch.equal(rows @ lp[k], torch.cat(
                [rows[i:i + batch] @ lp[k] for i in range(0, n_rows, batch)])):
            moved.append(k)
    print(f"LM {arch}: layer 0's projections whose rows take other bits "
          f"at M = {batch} than at M = {n_rows}: {moved} of {mats}")
    if cfg.family == "moe":
        # a dropless MoE's expert matmuls are batched over experts: layer
        # 0's MoE over the prompt block against one token at a time
        from repro_torch.models import blocks
        h = rms_norm(params["embed"][toks], lp["mlp_norm"], cfg.norm_eps)
        m_blk = blocks.moe_apply(cfg, lp, h)
        m_one = torch.cat([blocks.moe_apply(cfg, lp, h[:, j:j + 1])
                           for j in range(prompt)], dim=1)
        again, fed2 = _wave_logits(api, params, b_in, gen,
                                   prompt + gen)
        print(f"LM {arch} dropless: layer 0's MoE over the {prompt}-token "
              f"block == one token at a time, bitwise "
              f"{torch.equal(m_blk, m_one)} ({int((m_blk != m_one).sum())} "
              f"of {m_one.numel()} differ); the wave served again: the same "
              f"bits {torch.equal(again, logits) and torch.equal(fed2, fed)}")
        if not (torch.equal(again, logits) and torch.equal(fed2, fed)):
            fail(f"LM {arch}: the dropless wave served again differs")
        # the published capacity_factor, which drops units: the same wave
        # served twice, finite and the same bits both times
        api_p = get_api(published)
        w1, f1 = _wave_logits(api_p, params, b_in, gen, prompt + gen)
        w2, f2 = _wave_logits(api_p, params, b_in, gen, prompt + gen)
        finite = bool(torch.isfinite(w1.float()).all())
        same = torch.equal(w1, w2) and torch.equal(f1, f2)
        print(f"LM {arch} at its published capacity_factor "
              f"{published.capacity_factor}: a wave's logits finite "
              f"{finite}, the same bits served twice {same}; rel gap to the "
              f"dropless wave's prefill logits "
              f"{_rel_gap(w1[:, 0], logits[:, 0]):.3e}")
        if not (finite and same):
            fail(f"LM {arch}: the published capacity's wave is not finite "
                 f"or not deterministic")
    del params
    return {"gap": gap, "wave_s": wave_s}


def lm_serving_legs(dev) -> None:
    """The LM serving path (the module docstring's item 22, (a)-(e))."""
    import dataclasses
    import importlib.util

    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import vq_assign
    from repro_torch.launch import serve
    from repro_torch.models import quantization
    from repro_torch.models.api import get_api
    from repro_torch.training import steps

    t_item = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    # -- (a) the main path: launch.serve --mode lm --arch granite_8b -------
    zero_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    args = serve.parse_args(["--mode", "lm", "--arch", LM_ARCH, "--seed",
                             str(SEED)])
    t0 = time.perf_counter()
    run = serve.run_lm(args)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    counts = expect_counts("LM serving (no kernel of the port's own: the "
                           "reference runs this path on XLA)")
    cfg, params = run.cfg, run.params
    b, t, g = args.batch, args.prompt, args.gen
    bounds = lm_bounds(cfg, params, b, t, t + g)
    if run.rc != 0 or [tuple(x.shape) for x in run.tokens] != \
            [(b, g)] * args.waves:
        fail(f"LM serving: rc {run.rc}, tokens "
             f"{[tuple(x.shape) for x in run.tokens]}")
    if cfg.n_layers != 36 or cfg.d_model != 4096 or \
            cfg.dtype != torch.bfloat16:
        fail(f"LM serving ran {cfg}, not granite-8b's published config")
    print(f"LM (a) {cfg.name}, {cfg.n_params():,} params "
          f"({bounds['weight_bytes'] / 1e9:.2f} GB of layer, head and norm "
          f"weights in {str(cfg.dtype).split('.')[-1]}): load + init + "
          f"{args.waves} waves {wall:.2f} s, "
          f"init {run.init_s:.2f} s; prefill ms "
          f"{[round(x, 2) for x in run.prefill_ms]} (bound "
          f"{bounds['prefill'][0]:.3f} ms, {bounds['prefill'][1]}); decode "
          f"ms a token {[round(x, 3) for x in run.decode_ms]} (bound "
          f"{bounds['decode'][0]:.3f} ms, {bounds['decode'][1]}); "
          f"{run.tok_s:,.1f} tok/s; peak device memory {peak:.2f} GiB; "
          f"launches {counts}; {card_line()}")

    api = get_api(cfg)
    prefill = steps.make_prefill_step(cfg, max_len=t + g)
    serve_step = steps.make_serve_step(cfg)
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (b, t), generator=gen_t,
                            device=dev)

    def one_wave():
        logits, cache = prefill(params, {"tokens": prompts})
        tok = torch.argmax(logits, dim=-1)[:, None]
        for _ in range(g):
            logits, cache = serve_step(params, cache, tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return tok

    prof = profile(f"{cfg.name} serving, one wave of {b} x {t} + {g}",
                   one_wave, g, "token")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_wave()
    torch.cuda.synchronize()
    wave_us = (time.perf_counter() - t0) * 1e6
    if prof is not None:
        # the profiler slows the host that issues the launches: the busy
        # share is also read against the same wave's wall without it
        print(f"LM (a) one wave: wall {wave_us / 1e3:.2f} ms without the "
              f"profiler, {prof['wall_us'] / 1e3:.2f} ms with it; device "
              f"busy {prof['busy_us'] / 1e3:.2f} ms: busy share "
              f"{prof['busy_us'] / wave_us:.3f} of the plain wall "
              f"({prof['busy_us'] / prof['wall_us']:.3f} of the profiled "
              f"one); {prof['ops'] / (g + 1):.0f} device operations a step "
              f"(prefill + {g} decode steps)")

    # -- (b) checks on the same model --------------------------------------
    again = serve.run_lm(args)
    same_w = all(torch.equal(x, y) for x, y in zip(
        quantization._leaves(params), quantization._leaves(again.params)))
    same = all(torch.equal(x, y) for x, y in zip(run.tokens, again.tokens))
    del again
    print(f"LM (b) the same seed, run twice through run_lm: the same "
          f"weights {same_w}, the same greedy tokens {same}")
    if not (same and same_w):
        fail("LM serving: the same seed gave other weights or tokens")
    logits_p, _ = prefill(params, {"tokens": prompts})
    full = api.forward(params, {"tokens": prompts})
    gap_p = _rel_gap(logits_p, full[:, -1])
    dec, _ = _wave_logits(api, params, {"tokens": prompts[:, :1]},
                          t - 1, t, teacher=prompts[:, 1:])
    gap_d = _rel_gap(dec, full)
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    print(f"LM (b) prefill's last logits vs forward's: max rel gap "
          f"{gap_p:.3e} (bound {LM_PREFILL_REL}); teacher-forced decode "
          f"of {t} positions vs forward: max rel gap {gap_d:.3e} (bound "
          f"{LM_DECODE_REL}), argmax agreement {agree:.4f}, max |logits| "
          f"{float(full.float().abs().max()):.3f}")
    if gap_p > LM_PREFILL_REL or gap_d > LM_DECODE_REL:
        fail("LM serving: prefill or decode differ from forward")
    t0 = time.perf_counter()
    qp = quantization.quantize_tree(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    err = quantization.quantization_error(params, qp)
    qstep = steps.make_serve_step(cfg, quantized=True)
    max_len = t + 4 * (LM_QUANT_STEPS + 3)
    _, c_full = api.prefill(params, {"tokens": prompts}, max_len)
    _, c_q = api.prefill(params, {"tokens": prompts}, max_len)
    tok = prompts[:, -1:]
    lf, c_full = serve_step(params, c_full, tok)
    lq, c_q = qstep(qp, c_q, tok)
    corr = float(torch.corrcoef(torch.stack(
        [lf.float().ravel(), lq.float().ravel()]))[0, 1])
    state = {"full": c_full, "q": c_q}

    def step_full():
        state["full"] = serve_step(params, state["full"], tok)[1]

    def step_q():
        state["q"] = qstep(qp, state["q"], tok)[1]

    ms = {"full": [], "q": []}
    for name in ("full", "q", "q", "full"):
        fn = step_full if name == "full" else step_q
        ms[name].append(time_ms(fn, LM_QUANT_STEPS, warmup=1))
    print(f"LM (b) int8 weight-only ({_nbytes(qp) / 1e9:.2f} GB with its "
          f"scales, quantized in {quant_s:.2f} s, max relative error "
          f"{err:.4f}): logits' correlation with bf16 {corr:.6f} (bound > "
          f"{LM_CORR}); ms a decode step in turns (bf16, int8, int8, bf16): "
          f"bf16 {r4(ms['full'])}, int8 {r4(ms['q'])}")
    if not corr > LM_CORR:
        fail(f"LM serving: int8 logits' correlation {corr}")
    del qp, state, c_full, c_q

    # -- (e) the paper's algorithm on granite-8b's embedding table ---------
    spec = importlib.util.spec_from_file_location(
        "embedding_vq_torch", ROOT / "examples" / "embedding_vq_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    table = params["embed"].float().contiguous()
    del params, run, full, dec, logits_p
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    out = example.cluster(table, seed=SEED)
    torch.cuda.synchronize()
    vq_s = time.perf_counter() - t0
    counts = expect_counts("embedding VQ", assign=3)
    w = out["w"]
    ap, mp = vq_assign.vq_assign_plain(table.double(), w.double())
    ak = out["assign"]
    flips = (ak != ap).nonzero().flatten().tolist()
    # min distances off flipped rows within FLIP_REL of the cancelled
    # magnitude; eq. 2 (ops.distortion, the mean of the same kernel's min
    # distances) against the f64 mean of those min distances at DIV_RTOL
    kept = ak == ap
    scale = (table.double() ** 2).sum(-1) \
        + (w.double() ** 2).sum(-1)[ak.long()]
    m_err = (out["mind"].double() - mp).abs()
    m_max = float(m_err[kept].max()) if bool(kept.any()) else 0.0
    m_bad = int(((m_err > FLIP_REL * scale) & kept).sum())
    d_want = float(out["mind"].double().mean())
    d_gap = abs(out["after"] - d_want) / d_want
    for r in flips:
        ok, gap = flip_gap_ok(table[r], w, int(ak[r]), int(ap[r]))
        if not ok:
            fail(f"embedding VQ: row {r}: {int(ak[r])} vs plain "
                 f"{int(ap[r])}, gap {gap:.3e}: not a near-tie")
    kappa = w.shape[0]
    ck = torch.bincount(ak.long(), minlength=kappa)
    cp = torch.bincount(ap.long(), minlength=kappa)
    moved = int((ck - cp).abs().sum())
    print(f"LM (e) eq. 9 on the {tuple(table.shape)} embedding table, "
          f"kappa {kappa}: distortion {out['before']:.5f} -> "
          f"{out['after']:.5f} in {vq_s:.2f} s; the assign kernel vs plain "
          f"in f64: {len(flips)} flips (near-ties) of {ak.numel()}, counts "
          f"moved {moved} (2 x flips at most), max |mind diff| {m_max:.3e} "
          f"({m_bad} rows past {FLIP_REL} x (|z|^2 + |w|^2)); eq. 2 vs the "
          f"f64 mean of the min distances: rel gap {d_gap:.3e} (bound "
          f"{DIV_RTOL}); launches {counts}")
    if moved > 2 * len(flips) or not out["after"] < out["before"]:
        fail("embedding VQ: counts differ beyond the flips, or the "
             "distortion did not fall")
    if m_bad or d_gap > DIV_RTOL:
        fail("embedding VQ: the assign kernel's min distances or eq. 2 "
             "differ from the plain version")
    a_ms = kernel_ms(lambda: vq_assign.vq_assign(table, w), 20)
    a_plain = kernel_ms(lambda: vq_assign.vq_assign_plain(table, w), 10)
    v, d = table.shape
    a_bound = bound(4 * (v * d + kappa * d + 2 * v),
                    v * kappa * (2 * d + 3) + v * d)
    print(f"timing assign ({v} x {kappa} x {d}, the embedding table): "
          f"kernel {a_ms:.4f} ms, plain {a_plain:.4f} ms, bound "
          f"{a_bound[0]:.4f} ms ({a_bound[1]})")
    del table, out, w
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the other nine configs at full width --------------------------
    for arch in registry.ARCH_IDS:
        if arch == LM_ARCH:
            continue
        full_cfg = registry.get_config(arch)
        layers = None
        if full_cfg.n_params() * 2 / 1e9 > LM_FULL_DEPTH_GB:
            layers = LM_CUT_LAYERS
        if full_cfg.family == "hybrid":
            check_lm_config(dev, arch, prompt=HYMBA_PROMPT, gen=HYMBA_GEN,
                            batch=1, layers=layers)
        else:
            check_lm_config(dev, arch, prompt=LM_PROMPT, gen=LM_GEN,
                            batch=args.batch, layers=layers)
        gc.collect()
        torch.cuda.empty_cache()

    # the main path as a user types it, and the two LM examples at the
    # published width, as subprocesses beside (d)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    py = sys.executable
    cmds = {
        "launch.serve --mode lm --arch granite_8b": [
            py, "-m", "repro_torch.launch.serve", "--mode", "lm", "--arch",
            LM_ARCH],
        "embedding_vq_torch.py --full": [
            py, str(ROOT / "examples" / "embedding_vq_torch.py"), "--arch",
            LM_ARCH, "--full"],
        "serve_lm_torch.py": [
            py, str(ROOT / "examples" / "serve_lm_torch.py")],
    }
    want_out = {
        "launch.serve --mode lm --arch granite_8b": (
            f"wave {args.waves - 1}: generated {g} tokens x {b} requests",
            f"served {args.waves * b} requests, {args.waves * b * g} tokens"),
        "embedding_vq_torch.py --full": ("of 49152 rows",),
        "serve_lm_torch.py": ("decode throughput",),
    }
    t_sub = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
             for name, cmd in cmds.items()}

    # -- (d) the card against the CPU, f32 with TF32 pinned off ------------
    worst = 0.0
    for arch in registry.ARCH_IDS:
        small = registry.get_smoke_config(arch)
        api_s = get_api(small)
        p_cpu = api_s.init(SEED, device="cpu")
        p_dev = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                     if isinstance(v, dict) else v.to(dev))
                 for k, v in p_cpu.items()}
        b_cpu = serve.lm_batch(small, 2, 16,
                               torch.Generator().manual_seed(SEED), "cpu")
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        want = api_s.forward(p_cpu, b_cpu)
        got = api_s.forward(p_dev, b_dev).cpu()
        max_len = 24 + (small.img_tokens if small.family == "vlm" else 0)
        want_w, fed = _wave_logits(api_s, p_cpu, b_cpu, 4, max_len)
        got_w, _ = _wave_logits(api_s, p_dev, b_dev, 4, max_len,
                                teacher=fed.to(dev))
        for x, y, what in ((got, want, "forward"),
                           (got_w.cpu(), want_w, "prefill + 4 decode")):
            if not torch.allclose(x, y, rtol=1e-4, atol=1e-5):
                fail(f"LM (d) {arch} {what}: the card differs from the CPU "
                     f"by {float((x - y).abs().max()):.3e}")
            worst = max(worst, float(((x - y).abs()
                                      / (1e-5 + y.abs())).max()))
    print(f"LM (d) the ten smoke configs in f32 (TF32 off), forward and "
          f"prefill + 4 greedy decode steps: the card == the CPU at "
          f"rtol=1e-4, atol=1e-5 (worst |gap| / (1e-5 + |cpu|) "
          f"{worst:.3e})")
    for name, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for other in procs.values():
                other.kill()
            fail(f"{name}: still running after {SUBPROCESS_TIMEOUT_S} s")
        lines = out.strip().splitlines()
        print(f"LM subprocess {name}: exit {proc.returncode} "
              f"{time.perf_counter() - t_sub:.1f} s after the start; "
              + "; ".join(lines[-3:]))
        if proc.returncode != 0 or not all(w in out for w in want_out[name]):
            print(out)
            fail(f"{name}: exit {proc.returncode} or its lines missing")
    print(f"item 22 (the LM serving path): {time.perf_counter() - t_item:.1f}"
          f" s")


# -- item 23: LM training on one card ---------------------------------------

def _lm_train_batch(cfg, step: int, dev, *, rows: int = 8, seq: int = 64,
                    lead: tuple = ()) -> dict:
    """The launcher's step-indexed batch (``data.pipeline.lm_batch``) and,
    for the stub frontends, frames or patch embeddings from the same
    step's seed; ``lead`` stacks that many steps on a leading dim (a
    window's (tau, B, ...))."""
    import torch

    from repro_torch.data.pipeline import DataConfig, lm_batch
    if lead:
        parts = [_lm_train_batch(cfg, step * lead[0] + s, dev, rows=rows,
                                 seq=seq) for s in range(lead[0])]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    batch = lm_batch(DataConfig(cfg.vocab, seq, rows, SEED), step,
                     device=dev)
    gen = torch.Generator().manual_seed(SEED * 1000 + step)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (rows, cfg.encoder_frames, cfg.d_model), generator=gen).to(
                dev, cfg.dtype)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (rows, cfg.img_tokens, cfg.d_model), generator=gen).to(
                dev, cfg.dtype)
    return batch


def _leaves_equal(a, b) -> bool:
    import torch

    from repro_torch.optim.optimizers import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _moved(before, after) -> float:
    from repro_torch.optim.optimizers import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(before), tree_leaves(after)))


def lm_training_legs(dev) -> None:
    """LM training on one card (the module docstring's item 23, (a)-(e))."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import torch

    from repro_torch import comm
    from repro_torch.configs import registry
    from repro_torch.distributed.roofline import HBM_BW
    from repro_torch.kernels import vq_fused
    from repro_torch.launch import train
    from repro_torch.models.api import get_api
    from repro_torch.optim import optimizers
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.training import steps

    t_item = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()

    # -- (a) the main path: launch.train --mode lm --arch granite_8b -------
    full = registry.get_config("granite_8b")
    cfg = dataclasses.replace(full, n_layers=LMT_LAYERS)
    print(f"LM train (a) granite-8b at its published width (d_model "
          f"{cfg.d_model}, GQA {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {str(cfg.dtype).split('.')[-1]}),"
          f" depth cut: n_layers "
          f"{full.n_layers} -> {cfg.n_layers} (AdamW's 12 B a parameter: "
          f"{12 * full.n_params() / 1e9:.1f} GB at 36 layers, "
          f"{12 * cfg.n_params() / 1e9:.1f} GB at {cfg.n_layers})")
    args = train.parse_args(["--mode", "lm", "--arch", "granite_8b",
                             "--steps", str(LMT_STEPS), "--seed", str(SEED)])
    zero_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run = train.run_lm(args, cfg=cfg)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    counts = expect_counts("LM training (no kernel of the port's own: the "
                           "reference runs this path on XLA)")
    losses, gnorms = run.losses.float(), run.grad_norms.float()
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    print(f"LM train (a) {LMT_STEPS} steps of {args.batch} x "
          f"{args.seq_len} tokens: loss {float(losses[0]):.4f} -> "
          f"{float(losses[-1]):.4f} (mean of the first 10 {first:.4f}, "
          f"of the last 10 {last:.4f}); grad norm {float(gnorms[0]):.3f} "
          f"-> {float(gnorms[-1]):.3f}; wall {run.wall_s:.2f} s "
          f"({run.wall_s / LMT_STEPS * 1e3:.1f} ms a step with the "
          f"launcher's log reads); peak device memory {peak:.2f} GiB; "
          f"launches {counts}; {card}")
    if not (torch.isfinite(losses).all() and torch.isfinite(gnorms).all()):
        fail("LM train (a): a loss or grad norm is not finite")
    if not last < first:
        fail(f"LM train (a): the loss did not fall ({first} -> {last})")

    # -- (e) read-outs on the same state: step time, trace, the bound ------
    opt = optimizers.adamw(optimizers.cosine_schedule(
        args.lr, warmup=20, total=args.steps))
    step_fn = steps.make_train_step(cfg, opt, donate=True)
    state = run.state
    del run
    batches = [_lm_train_batch(cfg, LMT_STEPS + i, dev)
               for i in range(LMT_TIMED)]

    def timed_steps():
        nonlocal state
        for b in batches:
            state, _ = step_fn(state, b)

    timed_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed_steps()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / LMT_TIMED * 1e3
    prof = profile(f"granite-8b training at {LMT_LAYERS} layers",
                   timed_steps, LMT_TIMED, "step")
    n = sum(x.numel() for x in tree_leaves(state["params"]))
    tokens = args.batch * args.seq_len
    t_ops = 6 * n * tokens / LM_BF16_PEAK * 1e3
    t_opt = 22 * n / HBM_BW * 1e3
    print(f"LM train (e) granite-8b at {LMT_LAYERS} layers, {n:,} params: "
          f"{step_ms:.2f} ms a step, {tokens / step_ms * 1e3:,.0f} tok/s "
          f"(host clock, {LMT_TIMED} steps between device syncs); busy "
          f"share {prof['busy_us'] / prof['wall_us']:.3f} of the profiled "
          f"wall, {prof['busy_us'] / LMT_TIMED / 1e3:.2f} ms busy a step"
          if prof else "LM train (e) no device time seen (not measured)")
    print(f"LM train (e) bound: 6 x {n:,} x {tokens} tokens = "
          f"{6 * n * tokens / 1e12:.2f} TFLOP, {t_ops:.2f} ms at "
          f"{LM_BF16_PEAK / 1e12:.0f} TFLOP/s; AdamW's 22 B a parameter "
          f"(read p, g, mu, nu; write p, mu, nu), {22 * n / 1e9:.1f} GB, "
          f"{t_opt:.2f} ms at {HBM_BW / 1e12:.2f} TB/s; {t_ops + t_opt:.2f} "
          f"ms in all; peak {peak:.2f} GiB; {card}")
    del state, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # -- (a) the other families: full depth where the state fits -----------
    for arch, layers in LMT_OTHERS:
        other = registry.get_config(arch)
        if layers is not None:
            other = dataclasses.replace(other, n_layers=layers)
        opt_o = optimizers.adamw(1e-3)
        step_o = steps.make_train_step(other, opt_o, donate=True)
        torch.cuda.reset_peak_memory_stats()
        st = steps.init_train_state(other, opt_o, SEED, device=dev)
        before = tree_map(lambda x: x.clone(), st["params"])
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LMT_OTHER_STEPS):
            st, met = step_o(st, _lm_train_batch(other, i, dev))
            out.append(torch.stack([met["loss"], met["grad_norm"]]))
        out = torch.stack(out).float().cpu()
        wall = time.perf_counter() - t0
        moved = _moved(before, st["params"])
        depth = registry.get_config(arch).n_layers
        print(f"LM train (a) {other.name} ({other.family}, "
              f"{other.n_layers} of {depth} layers, full width, "
              f"{other.n_params():,} params): "
              f"{LMT_OTHER_STEPS} steps in {wall:.2f} s, loss "
              f"{float(out[0, 0]):.4f} -> {float(out[-1, 0]):.4f}, grad norm "
              f"{float(out[0, 1]):.3f} -> {float(out[-1, 1]):.3f}, params "
              f"moved {moved:.3e}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not torch.isfinite(out).all() or not moved > 0:
            fail(f"LM train (a) {arch}: not finite, or the params did not "
                 f"move")
        del st, before
        gc.collect()
        torch.cuda.empty_cache()

    # -- (b) determinism and --resume, 2 layers at full width --------------
    cut = dataclasses.replace(full, n_layers=LMT_CUT)
    base = ["--mode", "lm", "--arch", "granite_8b", "--steps",
            str(LMT_DET_STEPS), "--seed", str(SEED), "--log-every", "10"]
    with contextlib.redirect_stdout(io.StringIO()):
        one = train.run_lm(train.parse_args(base), cfg=cut)
        two = train.run_lm(train.parse_args(base), cfg=cut)
    same = _leaves_equal(one.state, two.state)
    del two
    with tempfile.TemporaryDirectory(prefix="lm_ckpt_") as tmp:
        free = shutil.disk_usage(tmp).free / 1e9
        print(f"LM train (b) {cut.n_params():,} params, a checkpoint of "
              f"{10 * cut.n_params() / 1e9:.1f} GB (bf16 params, f32 mu "
              f"and nu); {free:.1f} GB free where it is written")
        ck = base + ["--ckpt-every", "10", "--ckpt-dir", tmp]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train.run_lm(train.parse_args(ck), cfg=cut)
        saved = time.perf_counter() - t0
        shutil.rmtree(os.path.join(tmp, f"step_{LMT_DET_STEPS:09d}"))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            resumed = train.run_lm(train.parse_args(ck + ["--resume"]),
                                   cfg=cut)
        resume_s = time.perf_counter() - t0
    resumed_ok = (_leaves_equal(one.state, resumed.state)
                  and resumed.start == 10
                  and torch.equal(one.losses[10:], resumed.losses))
    print(f"LM train (b) two straight {LMT_DET_STEPS}-step runs: params "
          f"and moments equal bit for bit: {same}; {LMT_DET_STEPS} steps "
          f"checkpointing every 10 ({saved:.1f} s), the step-20 checkpoint "
          f"removed, --resume from step {resumed.start} ({resume_s:.1f} s): "
          f"== the straight run bit for bit: {resumed_ok}; "
          + "; ".join(x for x in log.getvalue().splitlines()
                      if x.startswith("resumed")))
    if not (same and resumed_ok):
        fail("LM train (b): a straight run or --resume is not bit for bit")
    del one, resumed
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the card against the CPU, f32 with TF32 pinned off ------------
    worst = 0.0
    for arch in registry.ARCH_IDS:
        small = registry.get_smoke_config(arch)
        api_s = get_api(small)
        p_cpu = api_s.init(SEED, device="cpu")
        p_dev = tree_map(lambda x: x.to(dev), p_cpu)
        b_cpu = _lm_train_batch(small, 3, "cpu", rows=2, seq=16)
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        l_cpu, g_cpu = steps.loss_and_grads(api_s.loss_fn, p_cpu, b_cpu)
        l_dev, g_dev = steps.loss_and_grads(api_s.loss_fn, p_dev, b_dev)
        sgd = optimizers.sgd(0.1)
        st_c = {"params": p_cpu, "opt_state": sgd.init(p_cpu),
                "step": torch.zeros((), dtype=torch.int32)}
        st_d = tree_map(lambda x: x, {"params": p_dev,
                                      "opt_state": sgd.init(p_dev),
                                      "step": st_c["step"].to(dev)})
        sgd_step = steps.make_train_step(small, sgd)
        for i in range(3):
            bc = _lm_train_batch(small, 10 + i, "cpu", rows=2, seq=16)
            st_c, _ = sgd_step(st_c, bc)
            st_d, _ = sgd_step(st_d, {k: v.to(dev) for k, v in bc.items()})
        pairs = [("loss", l_dev.cpu()[None], l_cpu[None])]
        pairs += [(f"grad {i}", a.cpu(), b) for i, (a, b) in enumerate(zip(
            tree_leaves(g_dev), tree_leaves(g_cpu)))]
        pairs += [(f"param {i} after 3 SGD steps", a.cpu(), b)
                  for i, (a, b) in enumerate(zip(
                      tree_leaves(st_d["params"]),
                      tree_leaves(st_c["params"])))]
        for what, x, y in pairs:
            atol = 1e-5 * max(float(y.abs().max()), 1e-30)
            if not torch.allclose(x, y, rtol=1e-4, atol=atol):
                fail(f"LM train (c) {arch} {what}: the card differs from "
                     f"the CPU by {float((x - y).abs().max()):.3e}")
            worst = max(worst, float(((x - y).abs() / (atol + y.abs()))
                                     .max()))
    print(f"LM train (c) the ten smoke configs in f32 (TF32 off): one "
          f"step's loss and every grad leaf, and the params after 3 SGD "
          f"steps: the card == the CPU at rtol=1e-4, atol=1e-5 x max|x| "
          f"(worst |gap| / (atol + |cpu|) {worst:.3e})")

    # -- (d) the window step: the paper's merges over an LM -----------------
    captured = {}
    topk_counts = {}
    for arch, m in LMT_WINDOW_M:
        wcfg = (cut if arch == "granite_8b" else registry.get_config(arch))
        n_float = len(tree_leaves(get_api(wcfg).init(device="meta")))
        rows = max(8, m)
        windows = [_lm_train_batch(wcfg, w, dev, rows=rows,
                                   lead=(LMT_TAU,))
                   for w in range(LMT_WINDOWS)]
        finals = {}
        for merge in steps.Merge:
            for opt_name in (("adamw", "sgd") if merge in (
                    steps.Merge.DELTA, steps.Merge.DELTA_SPARSE)
                    else ("adamw",)):
                fracs = ((0.01, 1.0) if merge is steps.Merge.DELTA_SPARSE
                         and opt_name == "sgd" else (0.01,))
                for frac in fracs:
                    opt_w = (optimizers.adamw(1e-3) if opt_name == "adamw"
                             else optimizers.sgd(0.05))
                    tsp = (comm.get_transport("sparse", frac=frac)
                           if merge is steps.Merge.DELTA_SPARSE else None)
                    if (tsp is not None and arch == "granite_8b"
                            and opt_name == "adamw"):
                        orig = tsp.select

                        def select(full_, k, orig=orig):
                            size = full_.shape[1]
                            if size in (cut.vocab * cut.d_model,
                                        cut.d_model) and (
                                    size not in captured):
                                captured[size] = (full_.clone(), k)
                            return orig(full_, k)
                        tsp.select = select
                    torch.cuda.reset_peak_memory_stats()
                    st = steps.init_window_state(wcfg, opt_w, SEED, merge,
                                                 tsp, workers=m, device=dev)
                    w_start = steps.replica(st["params"], 0)
                    step_w = steps.make_window_step(
                        wcfg, opt_w, workers=m, tau=LMT_TAU, merge=merge,
                        transport=tsp)
                    zero_counts()
                    losses = []
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for b in windows:
                        st, met = step_w(st, b)
                        losses.append(met["loss"])
                    losses = torch.stack(losses).float().cpu()
                    wall = time.perf_counter() - t0
                    want = ({"topk": n_float * LMT_WINDOWS}
                            if tsp is not None else {})
                    got = expect_counts(
                        f"LM window {arch} {merge.value}", **want)
                    if tsp is not None:
                        topk_counts[f"{arch} {opt_name} frac {frac}"] = \
                            got["topk"]
                    shared = all(x.stride(0) == 0
                                 for x in tree_leaves(st["params"]))
                    steps_ok = bool(torch.all(st["step"]
                                              == LMT_TAU * LMT_WINDOWS))
                    moved = _moved(w_start, steps.replica(st["params"], 0))
                    resid = (max(float(r.abs().max())
                                 for r in tree_leaves(st["residual"]))
                             if "residual" in st else None)
                    print(f"LM window {arch} M={m} tau={LMT_TAU} "
                          f"{merge.value} ({opt_name}"
                          f"{f', frac {frac}' if tsp is not None else ''}): "
                          f"{LMT_WINDOWS} windows in {wall:.2f} s, loss "
                          f"{[round(float(x), 4) for x in losses]}, step "
                          f"{int(st['step'][0])}, params moved {moved:.3e}, "
                          f"replicas share the merged params: {shared}"
                          + (f", largest |residual| {resid:.3e}"
                             if resid is not None else "")
                          + f"; peak "
                          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} "
                          f"GiB")
                    if not (torch.isfinite(losses).all() and steps_ok
                            and moved > 0):
                        fail(f"LM window {arch} {merge.value}: loss not "
                             f"finite, step not {LMT_TAU * LMT_WINDOWS}, "
                             f"or the params did not move")
                    if merge in (steps.Merge.ALLREDUCE, steps.Merge.AVERAGE,
                                 steps.Merge.DELTA) and not shared:
                        fail(f"LM window {arch} {merge.value}: the replicas' "
                             f"merged params are not one")
                    if (merge is steps.Merge.DELTA_SPARSE and frac == 0.01
                            and not resid > 0):
                        fail(f"LM window {arch}: frac 0.01 left no residual")
                    if opt_name == "sgd":
                        finals[merge.value, frac] = steps.replica(
                            st["params"], 0)
                    del st, w_start
                    gc.collect()
                    torch.cuda.empty_cache()
        lossless = _leaves_equal(finals["delta", 0.01],
                                 finals["delta_sparse", 1.0])
        print(f"LM window {arch} (SGD): delta_sparse at frac 1.0 == delta "
              f"over {LMT_WINDOWS} windows bit for bit: {lossless}")
        if not lossless:
            fail(f"LM window {arch}: lossless sparse differs from delta")
        del finals, windows
    print(f"LM window top-k launches (one a float leaf a sparse merge): "
          f"{topk_counts}")

    # the top-k kernel on the LM's payloads, against its plain version
    for size, (full_, k) in sorted(captured.items()):
        topk_equal(full_, k, f"LM payload {tuple(full_.shape)}")
        print(f"check top-k on the LM's captured merge payload "
              f"{tuple(full_.shape)}, k={k:,}: == plain bit for bit; "
              + topk_plan_line(full_))
    emb, k_emb = captured[cut.vocab * cut.d_model]
    big = torch.cat([emb] * (LMT_TOPK_M // emb.shape[0]))
    del captured
    gc.collect()
    torch.cuda.empty_cache()
    tk, tl = in_turns(lambda: vq_fused.vq_topk(big, k_emb),
                      lambda: torch.topk(big.abs(), k_emb, dim=1), 3)
    n_big = big.shape[1]
    # the plain version (a stable sort of 4 x 201 M entries, ~20 GB of
    # transients): one warm-up, one timed call
    tp = kernel_ms(lambda: vq_fused.vq_topk_plain(big, k_emb), 1, warmup=1)
    tb = bound(4 * 2 * LMT_TOPK_M * n_big + 8 * LMT_TOPK_M * k_emb,
               LMT_TOPK_M * n_big)
    print(f"timing top-k {tuple(big.shape)}, k={k_emb:,} (granite-8b's "
          f"embedding delta, captured from the sparse merge and stacked "
          f"to {LMT_TOPK_M} rows): kernel {r4(tk)} ms, torch.topk(|x|) "
          f"{r4(tl)} ms (in turns; selection only), plain {tp:.4f} ms, "
          f"bound {tb[0]:.4f} ms ({tb[1]}); {topk_plan_line(big)}; {card}")
    del big, emb
    gc.collect()
    torch.cuda.empty_cache()
    print(f"item 23 (LM training): {time.perf_counter() - t_item:.1f} s")


def threads_serving_obs_legs(dev, w0, data, eval_data, runs, geo_run,
                             lengths) -> None:
    """The thread runtime, training while serving, and the trace/metrics
    layer at full width (the module docstring's item 19, legs T1-T4, S1
    and O1)."""
    import statistics
    import threading

    import torch

    from repro_torch.core import async_runtime, vq
    from repro_torch.engine import get_executor
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import (GeometricDelayNetwork,
                                            InstantNetwork)
    from repro_torch.kernels import _build, vq_assign, vq_fused
    from repro_torch.launch import serve, train
    from repro_torch.obs import MetricsRegistry, Profiler, Tracer, \
        check_trace, load_trace

    thread_argv = ["--executor", "thread", "--scheme", "async_delta",
                   "--workers", str(M), "--points", str(N_PER), "--dim",
                   str(D), "--kappa", str(KAPPA), "--tau", str(TAU), "--seed",
                   str(SEED), "--network", "instant"]

    def thread_leg(label, run, duration_s):
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        res, ex = run()
        stats = ex.last_stats
        pushes = sum(s.pushes for s in stats)
        points = sum(s.points for s in stats)
        stale = sum(s.stale_reads for s in stats)
        counts = expect_counts(label, window=pushes)
        curve = res.distortion
        print(f"leg {label}: {points / duration_s:,.0f} points/s, "
              f"{pushes / duration_s:,.0f} rounds/s, stale-read share "
              f"{stale / max(pushes, 1):.3f}, inbox peak "
              f"{max(s.inbox_peak for s in stats)} deltas (bound "
              f"{async_runtime.INBOX_PER_WORKER * len(stats) or 'none'}), "
              f"launches {counts}, points by "
              f"worker {[s.points for s in stats]}, C first "
              f"{float(curve[0]):.6f} last {float(curve[-1]):.6f} over "
              f"{len(curve)} samples to {float(res.wall_ticks[-1]):.2f} s, "
              f"peak device memory above the leg's start "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**20:.0f} MiB")
        if not (all(s.pushes > 0 for s in stats)
                and bool(torch.isfinite(curve).all())
                and float(curve[-1]) < float(curve[0])
                and res.w_shared.shape == (KAPPA, D)):
            fail(f"{label}: a worker never pushed, or the distortion did not "
                 f"fall")
        return stats

    # -- T1: the thread runtime through the launcher --------------------------
    plan1 = vq_fused._window_plan(1, KAPPA, D)
    print(f"thread runtime's window launch at (1, {TAU}, {D}): resident "
          f"{plan1.resident}, one cluster of {vq_fused.CLUSTER_BLOCKS} blocks "
          f"of {plan1.threads} threads (on {vq_fused.CLUSTER_BLOCKS} of the "
          f"card's {torch.cuda.get_device_properties(0).multi_processor_count}"
          f" SMs)")

    def t1():
        res, ex, _ = train.run_vq(train.parse_args(
            thread_argv + ["--duration-s", str(T1_SECONDS)]))
        return res, ex

    thread_leg(f"T1 --executor thread, {T1_SECONDS} s", t1, T1_SECONDS)
    # a read-out: T1 with no bound on the inbox (the reference's queue), to
    # show what the bound does to the backlog, the memory and the curve
    bound = async_runtime.INBOX_PER_WORKER
    async_runtime.INBOX_PER_WORKER = 0
    try:
        thread_leg(f"T1 without the inbox's bound (a read-out), "
                   f"{T1_SECONDS} s", t1, T1_SECONDS)
    finally:
        async_runtime.INBOX_PER_WORKER = bound
    # a read-out: rounds/s as the workers grow (the threads share the
    # interpreter lock, and every PyTorch call hands it over)
    scaling = {}
    for m in (1, 2, 4):
        zero_counts()
        ex = get_executor("thread", duration_s=1.0, device=dev)
        ex.run("async_delta", w0, data[:m], eval_data[:m], tau=TAU)
        pushes = sum(s.pushes for s in ex.last_stats)
        expect_counts(f"thread runtime at M = {m}", window=pushes)
        scaling[m] = pushes
    print(f"thread runtime, rounds/s over 1 s by M: {scaling} (a read-out)")

    # -- T2: a 50x straggler; T3: 10 ms communication delays -----------------
    def t2():
        ex = get_executor("thread", duration_s=T23_SECONDS,
                          straggler={0: 50.0}, device=dev)
        return ex.run("async_delta", w0, data, eval_data, tau=TAU), ex

    stats2 = thread_leg(f"T2 straggler {{0: 50}}, {T23_SECONDS} s", t2,
                        T23_SECONDS)
    if not all(stats2[0].points < s.points for s in stats2[1:]):
        fail("T2: the straggler did not lag every other worker")

    def t3():
        res, ex, _ = train.run_vq(train.parse_args(
            thread_argv + ["--duration-s", str(T23_SECONDS),
                           "--comm-delay-s", "0.01"]))
        return res, ex

    thread_leg(f"T3 --comm-delay-s 0.01, {T23_SECONDS} s", t3, T23_SECONDS)

    # -- T4: the store's atomic apply on a device tensor ----------------------
    store = async_runtime.BlobStore(torch.zeros((KAPPA, D), device=dev))
    writers, per_writer = 8, 200

    def hammer():
        for _ in range(per_writer):
            store.apply(lambda w: w + 1.0)

    threads = [threading.Thread(target=hammer) for _ in range(writers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    version, value = store.get()
    exact = (not any(th.is_alive() for th in threads)
             and version == writers * per_writer
             and torch.equal(value, torch.full_like(value,
                                                    writers * per_writer)))
    print(f"check T4: {writers} threads x {per_writer} BlobStore.apply(+1) "
          f"on a ({KAPPA}, {D}) device tensor: version {version}, every "
          f"entry {writers * per_writer}.0: {exact}")
    if not exact:
        fail("T4: the store lost an update")

    # -- S1: training while serving -------------------------------------------
    with tempfile.TemporaryDirectory(prefix="s1_obs_") as tmp:
        trace_path, metrics_path = Path(tmp) / "s1.json", Path(tmp) / "s1.jsonl"
        zero_counts()
        run = serve.run_vq(serve.parse_args(
            ["--mode", "vq", "--train-publish", "--kappa", str(KAPPA),
             "--dim", str(D), "--points", str(S1_POINTS), "--tau", str(TAU),
             "--publish-every", str(S1_PUBLISH), "--requests",
             str(SERVE_REQUESTS), "--network", "geometric", "--p-delay",
             str(P_DELAY), "--seed", str(SEED), "--trace", str(trace_path),
             "--metrics", str(metrics_path)]),
            sample=SERVE_SAMPLE, keep=1_000_000)
        if run.rc != 0 or run.report is None:
            fail(f"S1: the serving launcher exited {run.rc}")
        rep, st, trainer = run.report, run.stats, run.trainer
        n_w = S1_POINTS // TAU
        bounds = [(max(1, n_w // 3), M // 2), (max(2, 2 * n_w // 3), M)]
        segs = segment_windows(M * S1_POINTS, M, bounds)
        windows = sum(segs)
        lates = sum(1 for e in trainer.resize_events if e.late_points)
        publishes = sum(-(-w // S1_PUBLISH) for w in segs)
        counts = expect_counts("S1", window=windows + lates,
                               assign=st.flushes + st.warmups,
                               divergence=windows)
        events = load_trace(str(trace_path))
        errs = check_trace(events, expect_spans=["flush", "load", "window"],
                           expect_merge_tiers={"flat"})
        geo = geo_run.report
        print(f"leg S1 --train-publish: {rep.summary()}; trainer windows "
              f"{windows:,} (segments {segs}), late deltas {lates}, "
              f"published {run.store.version} (1 + {publishes} on_window "
              f"calls), launches {counts}; p50 {rep.p50_ms:.3f} ms, p99 "
              f"{rep.p99_ms:.3f} ms while training vs phase 7's geometric "
              f"leg p50 {geo.p50_ms:.3f} ms, p99 {geo.p99_ms:.3f} ms; trace "
              f"{sum(1 for e in events if e.get('ph') == 'X'):,} spans, "
              f"check_trace {errs or 'clean'}")
        if (rep.failed or not rep.versions_monotonic or rep.n_versions < 2
                or run.store.version != 1 + publishes
                or trainer.metrics.counter("windows_total",
                                           scheme="delta").value != windows
                or errs):
            fail("S1: failed requests, versions, publications, windows or "
                 "the trace are wrong")
        check_served(run)

    # -- O1: the instrumentation's cost and exactness at full depth ----------
    # the divergence kernel against its plain version: a window's results
    # and their merge, a ragged shape (4-byte loads) and a misaligned one
    eps = vq.default_steps(torch.arange(1, TAU + 1, device=dev))
    w_fin = vq_fused.vq_window(data[:, :TAU].contiguous(), w0, eps)
    w_new = w0 - torch.sum(w0 - w_fin, dim=0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    ragged = torch.randn((3, 37, 5), generator=gen, device=dev)
    shifted = torch.randn(3 * 4096 * 128 + 1, generator=gen,
                          device=dev)[1:].view(3, 4096, 128)
    div_err = 0.0
    for a, b, label in ((w_fin, w_new, f"({M}, {KAPPA}, {D}) a window"),
                        (ragged, ragged[0] * 0.5, "(3, 37, 5)"),
                        (shifted, shifted[1] * 0.5,
                         "(3, 4096, 128) misaligned")):
        before = vq_fused.launches_divergence
        got = vq_fused.vq_divergence(a, b)
        want = vq_fused.vq_divergence_plain(a, b)
        rel = float(((got - want).abs() / want.abs()).max())
        div_err = max(div_err, float((got - want).abs().max()))
        print(f"check divergence kernel vs plain {label}: max rel diff "
              f"{rel:.3e}, one launch {vq_fused.launches_divergence - before}")
        if rel > DIV_RTOL or vq_fused.launches_divergence - before != 1:
            fail(f"divergence kernel {label}: {rel:.3e} from plain")
    # its last block combines through a ticket: 1,000 calls back to back
    # give the first call's bits, and leave the stream's tickets at 0
    first = vq_fused.vq_divergence(w_fin, w_new)
    again = [vq_fused.vq_divergence(w_fin, w_new) for _ in range(1000)]
    tickets = vq_assign._sweep_scratch(
        w_fin.device, _build.current_stream(w_fin.device), 1, 1)[0]
    same = all(same_bits(first, x) for x in again)
    print(f"check divergence kernel 1,000 calls back to back: bits equal "
          f"{same}, tickets left {int(tickets.abs().sum())}")
    if not same or bool(tickets.any()):
        fail("divergence kernel: bits moved between calls, or a ticket "
             "was left set")
    o1_windows = O1_POINTS // TAU
    fixed = None     # the first run's result: every other equals it
    full = ["--executor", "mesh", "--scheme", "delta", "--workers", str(M),
            "--points", str(O1_POINTS), "--dim", str(D), "--kappa",
            str(KAPPA), "--tau", str(TAU), "--seed", str(SEED), "--network",
            "instant"]
    walls = {False: [], True: []}
    with tempfile.TemporaryDirectory(prefix="o1_obs_") as tmp:
        for i, observed in enumerate(O1_ORDER):
            # P1: the observed runs carry the profiler too
            argv = full + (["--trace", str(Path(tmp) / f"o1_{i}.json"),
                            "--metrics", str(Path(tmp) / f"o1_{i}.jsonl"),
                            "--profile", str(Path(tmp) / f"o1_{i}.prof.json")]
                           if observed else [])
            # no earlier run's objects for the collector to walk in this one
            gc.collect()
            zero_counts()
            t_all = time.perf_counter()
            res, ex, wall = train.run_vq(train.parse_args(argv))
            t_all = time.perf_counter() - t_all
            expect_counts(f"O1 {'observed' if observed else 'bare'}",
                          window=o1_windows,
                          divergence=o1_windows if observed else 0)
            walls[observed].append(wall)
            if fixed is None:
                fixed = (res.distortion.clone(), res.w_shared.clone())
            if not (same_bits(res.distortion, fixed[0])
                    and same_bits(res.w_shared, fixed[1])):
                fail("O1: an observed run differs from a bare one")
            if not observed:
                del res, ex
                continue
            check_attribution(f"P1 O1 observed run {i}", ex,
                              loops=[[("window", o1_windows), ("step", TAU)]])
            mt = ex.metrics
            by_tag = ex.last_comm["by_tag"]
            mirror = {tag: {f: int(mt.counter(
                f"comm_{f}", tag=tag, tier="flat", transport="xla").value)
                for f in ("calls", "logical_bytes", "wire_bytes")}
                for tag in by_tag}
            per_window = by_tag["merge"]["wire_bytes"] / o1_windows
            # the first observed run's trace is read back (each is ~50 MB)
            checked = i == O1_ORDER.index(True)
            errs = check_trace(
                load_trace(str(Path(tmp) / f"o1_{i}.json")),
                expect_merge_tiers={"flat"},
                expect_counters=["distortion", "codebook_divergence"]
            ) if checked else []
            print(f"leg O1 observed run {i}: wall {wall:.2f} s (with the "
                  f"trace export {t_all:.2f} s), windows_total "
                  f"{mt.counter('windows_total', scheme='delta').value:.0f}, "
                  f"comm_* {mirror} == CommLog.summarize "
                  f"{ {t: {f: v[f] for f in mirror[t]} for t, v in by_tag.items()} }"
                  f", merge {per_window:,.0f} B a window, "
                  f"{len(ex.tracer.spans()):,} spans, check_trace "
                  f"{(errs or 'clean') if checked else 'not read'}")
            if (mt.counter("windows_total", scheme="delta").value
                    != o1_windows or per_window != 3_670_016 or errs
                    or any(mirror[t] != {f: v[f] for f in mirror[t]}
                           for t, v in by_tag.items())):
                fail("O1: windows_total, the comm mirror, the merge bytes "
                     "or the trace are wrong")
            del res, ex, mt
    ratios = [o / b for o, b in zip(walls[True], walls[False])]
    print(f"O1 {O1_POINTS:,} points a worker (--scheme delta, in the order "
          f"{['observed' if o else 'bare' for o in O1_ORDER]}): walls bare "
          f"{[round(w, 3) for w in walls[False]]} s, "
          f"observed {[round(w, 3) for w in walls[True]]} s, pair ratios "
          f"{[round(r, 4) for r in ratios]} (a read-out)")

    # the divergence kernel on the observed path: its inputs captured at
    # each launch, its outputs against the plain version, and the emitted
    # codebook_divergence series the mean of the plain values
    from repro_torch.engine import mesh as mesh_mod
    launched = []
    kernel = mesh_mod.ops.vq_divergence

    def capture(w_fin, w_srd):
        out = kernel(w_fin, w_srd)
        launched.append((w_fin.clone(), w_srd.clone(), out))
        return out

    ex_c = MeshExecutor(InstantNetwork(), tracer=Tracer(),
                        metrics=MetricsRegistry(), device=dev)
    mesh_mod.ops.vq_divergence = capture
    try:
        ex_c.run("delta", w0, data[:, : O1_CAPTURE_WINDOWS * TAU], eval_data,
                 tau=TAU)
    finally:
        mesh_mod.ops.vq_divergence = kernel
    plain = [vq_fused.vq_divergence_plain(a, b) for a, b, _ in launched]
    cap_rel = max(float(((o - q).abs() / q.abs()).max())
                  for (_, _, o), q in zip(launched, plain))
    series = [c.value for c in ex_c.tracer.counters("codebook_divergence")]
    want = [float(q.mean()) for q in plain]
    series_rel = max((abs(g - w) / abs(w) for g, w in zip(series, want)),
                     default=float("inf"))
    print(f"check O1 divergence kernel on the observed path "
          f"({len(launched)} windows captured): max rel diff from plain "
          f"{cap_rel:.3e}, codebook_divergence series vs the plain mean "
          f"{series_rel:.3e} (tolerance {DIV_RTOL:g})")
    if (len(launched) != O1_CAPTURE_WINDOWS or len(series) != len(want)
            or cap_rel > DIV_RTOL or series_rel > DIV_RTOL):
        fail("O1: the observed path's divergence differs from plain")
    del launched, plain, ex_c

    # the gate: short blocks, bare and observed in turns, in one process
    bdata = data[:, : O1_BLOCK_WINDOWS * TAU]
    blocks = {False: [], True: []}

    def block(observed):
        kw = ({"tracer": Tracer(), "metrics": MetricsRegistry()}
              if observed else {})
        ex_b = MeshExecutor(InstantNetwork(), device=dev, **kw)
        gc.collect()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex_b.run("delta", w0, bdata, eval_data, tau=TAU).distortion.cpu()
        blocks[observed].append(time.perf_counter() - t0)
        expect_counts("O1 block", window=O1_BLOCK_WINDOWS,
                      divergence=O1_BLOCK_WINDOWS if observed else 0)

    for i in range(O1_BLOCK_PAIRS):
        for observed in ((False, True) if i % 2 == 0 else (True, False)):
            block(observed)
    # the reference's estimator for its bar (benchmarks/run.py:619-629,
    # 679): the smaller of the best-of-N ratio and the median pair ratio,
    # since host noise only adds time and a real cost inflates both
    bratios = [o / b for o, b in zip(blocks[True], blocks[False])]
    median = statistics.median(bratios)
    best = min(blocks[True]) / min(blocks[False])
    ratio = min(best, median)
    print(f"check O1 ({O1_BLOCK_PAIRS} pairs of {O1_BLOCK_WINDOWS}-window "
          f"blocks of --scheme delta, in turns): walls bare "
          f"{[round(w, 4) for w in blocks[False]]} s, observed "
          f"{[round(w, 4) for w in blocks[True]]} s, pair ratios "
          f"{[round(r, 4) for r in bratios]}; median pair {median:.4f}, "
          f"best of {O1_BLOCK_PAIRS} {best:.4f}: overhead {ratio:.4f} (bar "
          f"1.03, the reference's max_overhead and estimator)")
    if ratio > 1.03:
        fail(f"O1: instrumentation costs {ratio:.4f}x the bare run's wall")

    # eq. 9, cut: bits and a read-out of the ratio (host-bound path), bare
    # and observed in turns
    n9 = O1_TICKS
    l9 = lengths[:, : n9 // TAU + 2]
    out9, walls9 = {}, {False: [], True: []}
    for observed in O1_ORDER:
        kw = {}
        if observed:
            # P2: the observed run carries the profiler too
            kw = {"tracer": Tracer(), "metrics": MetricsRegistry()}
            kw["profiler"] = Profiler(metrics=kw["metrics"])
        ex9 = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev, **kw)
        gc.collect()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res9 = ex9.run("async_delta", w0, data[:, :n9], eval_data, tau=TAU,
                       lengths=l9)
        res9.distortion.cpu()
        walls9[observed].append(time.perf_counter() - t0)
        out9[observed] = (res9, ex9)
        expect_counts("O1 eq. 9", delta=n9)
    (r_b, _), (r_o, ex_o) = out9[False], out9[True]
    same9 = (same_bits(r_b.distortion, r_o.distortion)
             and same_bits(r_b.w_shared, r_o.w_shared))
    rounds = ex_o.metrics.counter("async_rounds_total",
                                  scheme="async_delta").value
    errs9 = check_trace(ex_o.tracer.chrome_events(),
                        expect_merge_tiers={"flat"},
                        expect_counters=["distortion"])
    ratios9 = [o / b for o, b in zip(walls9[True], walls9[False])]
    print(f"check O1 eq. 9 ({n9:,} ticks, bare and observed in turns): "
          f"observed == bare bitwise {same9}; walls bare "
          f"{[round(w, 2) for w in walls9[False]]} s, observed "
          f"{[round(w, 2) for w in walls9[True]]} s, pair ratios "
          f"{[round(r, 4) for r in ratios9]} (a read-out: host-bound); "
          f"async_rounds_total {rounds:.0f}; check_trace {errs9 or 'clean'}")
    if not same9 or errs9:
        fail("O1 eq. 9: the observed run differs from the bare one, or its "
             "trace is not clean")
    a9 = check_attribution("P2 O1 eq. 9", ex_o, loops=[[("tick", n9)]])
    if a9["n_windows"] != n9 // TAU:
        fail(f"P2: {a9['n_windows']} nominal windows, expected {n9 // TAU}")


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch is not beside chip_smoke.py; run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    from repro_torch import comm
    from repro_torch import device as device_lib
    from repro_torch.comm import ring
    from repro_torch.core import async_vq, schemes, vq
    from repro_torch.engine import get_executor
    from repro_torch.engine import merge as merge_lib
    from repro_torch.engine.mesh import MeshExecutor
    from repro_torch.engine.network import (GeometricDelayNetwork,
                                            InstantNetwork)
    from repro_torch.kernels import _build, autotune, ops, vq_assign, vq_fused
    from repro_torch.launch import serve, train

    device_lib.pin_full_f32()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- inputs at the slice's width ------------------------------------------
    full = ["--executor", "mesh", "--workers", str(M), "--points", str(N_PER),
            "--dim", str(D), "--kappa", str(KAPPA), "--tau", str(TAU),
            "--seed", str(SEED), "--network", "instant"]
    args = train.parse_args(full + ["--scheme", "delta"])
    w0, data, eval_data = train.make_inputs(args, dev)
    if not ops.window_fits(KAPPA, D) or not ops.delta_fits(D):
        fail("the slice's width does not fit the kernels' shared memory")

    # -- 2+3. kernels vs plain, and the window-vs-per-step card contract ------
    eps_all = vq.default_steps(
        torch.arange(1, CHECK_WINDOWS * TAU + 1, device=dev))
    w_srd = w0
    flips, gaps, unexplained = 0, [], 0
    win_equal = win_total = 0
    win_err = contract_err = mind_err = 0.0
    contract_ok = True
    for i in range(CHECK_WINDOWS):
        span = slice(i * TAU, (i + 1) * TAU)
        zwin = data[:, span].contiguous()
        eps = eps_all[span]
        wk = vq_fused.vq_window(zwin, w_srd, eps)
        wp = vq_fused.vq_window_plain(zwin, w_srd, eps)
        w = w_srd.expand(M, KAPPA, D).contiguous()
        flipped = set()
        for s in range(TAU):
            z = zwin[:, s].unsqueeze(1).contiguous()
            ck, zk, mk, ak = vq_assign.vq_delta(z, w)
            cp, zp, mp, ap = vq_assign.vq_delta_plain(z, w)
            for j in range(M):
                a_k, a_p = int(ak[j, 0]), int(ap[j, 0])
                if a_k != a_p:
                    ok, gap = flip_gap_ok(z[j, 0], w[j], a_k, a_p)
                    flips += 1
                    gaps.append(gap)
                    if not ok:
                        fail(f"window {i} step {s} worker {j}: assignment "
                             f"{a_k} vs plain {a_p} with distance gap "
                             f"{gap:.3e}: not a near-tie")
                    flipped.add(j)
                    continue
                if not (torch.equal(ck[j], cp[j]) and torch.equal(zk[j], zp[j])):
                    fail(f"window {i} step {s} worker {j}: counts/zsum of "
                         f"the delta kernel differ from the plain version")
                mind_err = max(mind_err, abs(float(mk[j, 0] - mp[j, 0])))
                scale = float((z[j, 0].double() ** 2).sum()
                              + (w[j, a_k].double() ** 2).sum())
                if abs(float(mk[j, 0] - mp[j, 0])) > FLIP_REL * scale:
                    fail(f"window {i} step {s} worker {j}: min distance "
                         f"{float(mk[j, 0])} vs plain {float(mp[j, 0])}")
            h = ck.unsqueeze(-1) * w - zk
            w = w - eps[s] * h
        if not torch.equal(w, wk):
            contract_ok = False
            contract_err = max(contract_err, float((w - wk).abs().max()))
        for j in range(M):
            win_total += 1
            if torch.equal(wk[j], wp[j]):
                win_equal += 1
            elif j not in flipped:  # a difference no flip explains
                unexplained += 1
                win_err = max(win_err, float((wk[j] - wp[j]).abs().max()))
        w_srd = w_srd - torch.sum(w_srd - wk, dim=0)   # eq. 8
    print(f"check window vs plain ({CHECK_WINDOWS} windows x {M} workers, "
          f"kappa={KAPPA}, d={D}, tau={TAU}): {win_equal}/{win_total} "
          f"worker-windows bitwise equal, max |diff| without a flip "
          f"{win_err:.3e}, {unexplained} unexplained")
    print(f"check delta batch 1 vs plain ({CHECK_WINDOWS * TAU} steps x {M}): "
          f"counts/zsum exact where assignments agree, max |mind diff| "
          f"{mind_err:.3e}, {flips} flips, gaps "
          f"{[f'{g:.2e}' for g in gaps]}")
    if unexplained:
        fail(f"{unexplained} worker-windows differ from the plain version "
             f"without an assignment flip")
    print(f"check card contract (window kernel == per-step delta-kernel "
          f"path, bitwise, {CHECK_WINDOWS} windows): "
          f"{'holds' if contract_ok else 'BROKEN'}"
          + ("" if contract_ok else f", max |diff| {contract_err:.3e}"))
    if not contract_ok:
        fail("the window kernel and the per-step delta-kernel path differ")

    check_ragged(dev)
    check_routes(dev, data, w0, wk.contiguous())
    # the first window's displacement w0 - w_local: the sparse transport's
    # payload, zero outside the <= tau rows each worker touched
    # -- 9. the top-k kernel ----------------------------------------------------
    payload = merge_lib.tree_sub_f32(w0, vq_fused.vq_window(
        data[:, :TAU].contiguous(), w0, eps_all[:TAU])).reshape(M, -1)
    normal_payload = torch.randn(
        (M, KAPPA * D), generator=torch.Generator(device=dev).manual_seed(
            SEED + 5), device=dev)
    k_main = max(1, int(SPARSE_FRAC * KAPPA * D))
    k_l = max(1, int(LOSSY_FRAC * KAPPA * D))
    check_topk(dev, payload, normal_payload, (k_main, k_l, 1, KAPPA * D))

    # delta kernel at the eval shape, against plain and its own assignment
    wb = wk.contiguous()
    ck, zk, mk, ak = vq_assign.vq_delta(eval_data, wb)
    cp, zp, mp, ap = vq_assign.vq_delta_plain(eval_data, wb)
    diff = (ak != ap).nonzero().tolist()
    touched = torch.zeros((M, KAPPA), dtype=torch.bool, device=dev)
    for j, b in diff:
        ok, gap = flip_gap_ok(eval_data[j, b], wb[j], int(ak[j, b]),
                              int(ap[j, b]))
        if not ok:
            fail(f"batch 1000: worker {j} point {b} flip gap {gap:.3e}")
        touched[j, int(ak[j, b])] = touched[j, int(ap[j, b])] = True
    counts_own = torch.zeros((M, KAPPA), device=dev).scatter_add_(
        1, ak.long(), torch.ones_like(mk))
    zsum_own = torch.zeros((M, KAPPA, D), dtype=torch.float64,
                           device=dev).index_put_(
        (torch.arange(M, device=dev)[:, None].expand(M, N_EVAL), ak.long()),
        eval_data.double(), accumulate=True)
    keep = ~touched
    b_err = float((zk - zp).abs()[keep].max())
    if not (torch.equal(ck, counts_own) and torch.equal(ck[keep], cp[keep])
            and torch.allclose(zk, zsum_own.float(), rtol=ZSUM_RTOL,
                               atol=ZSUM_ATOL)
            and torch.allclose(zk[keep], zp[keep], rtol=ZSUM_RTOL,
                               atol=ZSUM_ATOL)):
        fail("batch 1000: counts/zsum disagree with the plain version")
    b_mind = float((mk - mp).abs().max())
    print(f"check delta batch {N_EVAL} vs plain: {len(diff)} flips, counts "
          f"exact off flipped rows, max |zsum diff| {b_err:.3e} "
          f"(rtol {ZSUM_RTOL}, atol {ZSUM_ATOL}), max |mind diff| "
          f"{b_mind:.3e}")

    # -- 4. the assign kernel: flush, eval and ragged shapes ------------------
    wide = ["--executor", "mesh", "--workers", str(M), "--points",
            str(WIDE_POINTS), "--dim", str(WIDE_D), "--kappa", str(KAPPA),
            "--tau", str(TAU), "--seed", str(SEED)]
    wide_async = wide + ["--scheme", "async_delta", "--network", "geometric",
                         "--p-delay", str(P_DELAY)]
    w0w, dataw, evalw = train.make_inputs(train.parse_args(wide_async), dev)
    zq = data[0, :FLUSH_ROWS].contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    zr = torch.rand((3, 37, 40), generator=gen, device=dev)
    wr = torch.rand((3, 1001, 40), generator=gen, device=dev)
    assign_err = 0.0
    for z, w, label in ((zq, wb[0], f"flush {FLUSH_ROWS} x {KAPPA} x {D}"),
                        (eval_data, wb, f"eval ({M}, {N_EVAL}) x {KAPPA} x "
                                        f"{D}"),
                        (zr, wr, "ragged (M=3, kappa=1001, d=40, B=37)")):
        assign_err = max(assign_err, check_assign(z, w, label)[1])
    # the eq.-9 tick's shape at d=3072 (the fused=False leg's), the sweep;
    # against the plain version in float64 and the blocked kernel, bitwise
    w_tick = (w0w + 0.01 * torch.randn(
        (M, KAPPA, WIDE_D), generator=torch.Generator(device=dev).manual_seed(
            SEED + 12), device=dev)).contiguous()
    z_tick = dataw[:, :1].contiguous()
    check_assign(z_tick, w_tick, f"({M}, 1) x {KAPPA} x {WIDE_D}", f64=True)
    a_t, m_t = vq_assign.vq_assign(z_tick, w_tick)
    _, _, m_b, a_b = vq_fused.vq_delta_blocked(z_tick, w_tick)
    if not (same_bits(a_t, a_b) and same_bits(m_t, m_b)):
        fail(f"assign ({M}, 1) x {KAPPA} x {WIDE_D} differs from the blocked "
             f"kernel's (assign, mind)")
    one_launch(lambda: vq_assign.vq_assign(z_tick, w_tick),
               f"assign ({M}, 1) x {WIDE_D}")
    del w_tick
    # the tiled argmin (B > 8) against the sweep over the same points
    # taken 8 at a time: one engine, one order, the same bits
    w_wide9 = w0w.expand(M, KAPPA, WIDE_D).contiguous()
    for z, w, label in ((eval_data[:, :9].contiguous(), wb, f"B=9, d={D}"),
                        (eval_data[:, :128].contiguous(), wb,
                         f"B=128, d={D}"),
                        (eval_data, wb, f"B={N_EVAL}, d={D}"),
                        (evalw[:, :9].contiguous(), w_wide9,
                         f"B=9, d={WIDE_D}")):
        a_k, m_k = vq_assign.vq_assign(z, w)
        parts = [vq_assign.vq_assign(
            z[:, i:i + vq_assign.SMALL_B].contiguous(), w)
            for i in range(0, z.shape[1], vq_assign.SMALL_B)]
        same = (same_bits(a_k, torch.cat([q[0] for q in parts], dim=1))
                and same_bits(m_k, torch.cat([q[1] for q in parts], dim=1)))
        print(f"check tiled argmin ({M}, {label}) == the sweep over the same "
              f"points 8 at a time, bitwise (assign, mind): {same}")
        if not same:
            fail(f"the tiled argmin ({label}) differs from the sweep")
    del w_wide9
    one_launch(lambda: vq_assign.vq_assign(zq, wb[0]), "assign flush")
    one_launch(lambda: vq_assign.vq_assign(eval_data, wb), "assign eval")
    print(f"check assign launches: one CUDA kernel a call at ({M}, 1) x "
          f"{WIDE_D} (the sweep), the flush and the eval (the tiled argmin)")

    # -- 5+6. the main path, and its first windows against the oracles -------
    runs = {}
    for scheme in ("delta", "average"):
        zero_counts()
        res, executor, wall = train.run_vq(
            train.parse_args(full + ["--scheme", scheme]))
        counts = {"window": vq_fused.launches, "delta": vq_assign.launches}
        if vq_fused.launches_blocked:
            fail(f"{scheme}: the blocked kernel ran at d={D}")
        n_windows = N_PER // TAU
        curve = res.distortion.cpu()
        print(f"main path --scheme {scheme}: C first {float(curve[0]):.6f} "
              f"last {float(curve[-1]):.6f}, wall {wall:.2f} s "
              f"({wall / (M * N_PER) * 1e6:.3f} us/point), launches {counts}")
        if counts["window"] != n_windows:
            fail(f"{scheme}: window kernel launched {counts['window']} times, "
                 f"expected {n_windows}")
        if (res.w_shared.shape != (KAPPA, D) or len(curve) != n_windows
                or not bool(torch.isfinite(curve).all())
                or not bool(torch.isfinite(res.w_shared).all())):
            fail(f"{scheme}: result of the wrong shape or not finite")
        if not float(curve[-1]) < float(curve[0]):
            fail(f"{scheme}: distortion did not go down")
        runs[scheme] = (res, counts, wall)

    head = data[:, : CHECK_WINDOWS * TAU]
    for scheme, oracle_fn in (("delta", schemes.scheme_delta),
                              ("average", schemes.scheme_average)):
        oracle = oracle_fn(w0, head, eval_data, tau=TAU)
        short = MeshExecutor(InstantNetwork(), device=dev).run(
            scheme, w0, head, eval_data, tau=TAU)
        held_to(f"{scheme} first {CHECK_WINDOWS} windows vs scheme_{scheme}",
                runs[scheme][0].distortion[:CHECK_WINDOWS],
                oracle.distortion, short.w_shared, oracle.w_shared)
        ticks_ok = torch.equal(short.wall_ticks, oracle.wall_ticks)
        print(f"check {scheme} first {CHECK_WINDOWS} windows vs "
              f"scheme_{scheme}: ticks equal {ticks_ok}")
        if not ticks_ok:
            fail(f"{scheme}: first windows' ticks differ from the oracle's")

    vq_fused.launches = vq_assign.launches = 0
    unfused = MeshExecutor(InstantNetwork(), fused=False, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_u = unfused.run("delta", w0, data[:, :UNFUSED_POINTS], eval_data,
                        tau=TAU)
    curve_u = res_u.distortion.cpu()
    wall_u = time.perf_counter() - t0
    counts_u = {"window": vq_fused.launches, "delta": vq_assign.launches}
    print(f"main path fused=False (per-step delta kernel), --scheme delta, "
          f"{UNFUSED_POINTS} points/worker: C last {float(curve_u[-1]):.6f}, "
          f"wall {wall_u:.2f} s, launches {counts_u} (one delta launch "
          f"at batch 1 is one CUDA kernel launch, the sweep)")
    if counts_u["delta"] != (UNFUSED_POINTS // TAU) * TAU or counts_u["window"]:
        fail(f"fused=False leg: launches {counts_u}")
    fused_head = runs["delta"][0].distortion[: UNFUSED_POINTS // TAU].cpu()
    if not torch.equal(curve_u, fused_head):
        fail("fused=False curve differs from the window kernel's")
    print("check fused vs fused=False curves (first "
          f"{UNFUSED_POINTS // TAU} windows): bitwise equal")

    # -- 7. serving the delta run's codebook ----------------------------------
    trained = runs["delta"][0].w_shared
    geometric = ["--network", "geometric", "--p-delay", str(P_DELAY)]
    geo_run, serve_launches = serve_leg(serve, trained, geometric,
                                        "geometric arrivals")
    serve_leg(serve, trained, ["--network", "instant", "--tick-ms", "0"],
              "saturating")
    freeze_ab(serve, trained, geometric)

    # -- 8. eq. 9 at full width ------------------------------------------------
    zero_counts()
    args_a = train.parse_args(
        ["--executor", "mesh", "--scheme", "async_delta", "--workers", str(M),
         "--points", str(ASYNC_TICKS), "--dim", str(D), "--kappa", str(KAPPA),
         "--tau", str(TAU), "--seed", str(SEED), "--network", "geometric",
         "--p-delay", str(P_DELAY)])
    res_a, ex_a, wall_a = train.run_vq(args_a)
    # the launcher's own inputs at this depth (a draw of ASYNC_TICKS points
    # a worker, not a prefix of the N_PER draw): the checks against this
    # run's head take them
    w0_a, data_a, eval_a = train.make_inputs(args_a, dev)
    counts_a = {"window": vq_fused.launches, "delta": vq_assign.launches}
    curve_a = res_a.distortion.cpu()
    merge_a = ex_a.last_comm["by_tag"]["merge"]
    print(f"main path --scheme async_delta: C first {float(curve_a[0]):.6f} "
          f"last {float(curve_a[-1]):.6f}, wall {wall_a:.2f} s "
          f"({wall_a / (M * ASYNC_TICKS) * 1e6:.3f} us/point), launches "
          f"{counts_a}, merge wire {merge_a['wire_bytes']:,} B over "
          f"{merge_a['calls']:,} masked reduces")
    if counts_a["delta"] != ASYNC_TICKS or counts_a["window"] or (
            vq_fused.launches_blocked):
        fail(f"async_delta: launches {counts_a}, expected {ASYNC_TICKS} "
             f"delta and no window or blocked launch")
    c_sync = float(runs["delta"][0].distortion[-1])
    if (len(curve_a) != ASYNC_TICKS // 10
            or res_a.w_shared.shape != (KAPPA, D)
            or not bool(torch.isfinite(curve_a).all())):
        fail("async_delta: result of the wrong shape or not finite")
    if not (float(curve_a[-1]) < float(curve_a[0])
            and float(curve_a[-1]) < 2.0 * c_sync):
        fail(f"async_delta: final distortion {float(curve_a[-1]):.6f} not "
             f"below the initial one and 2x the sync delta run's {c_sync:.6f}")
    n_c = ASYNC_CHECK_TICKS
    lengths = GeometricDelayNetwork(P_DELAY).round_lengths(
        torch.Generator().manual_seed(SEED), M, ASYNC_TICKS // TAU + 2, TAU)
    lengths_c = lengths[:, : n_c // TAU + 2]
    oracle_a = async_vq.scheme_async(w0_a, data_a[:, :n_c], eval_a, tau=TAU,
                                     lengths=lengths_c)
    short_a = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev).run(
        "async_delta", w0_a, data_a[:, :n_c], eval_a, tau=TAU,
        lengths=lengths_c)
    head_a = res_a.distortion[: n_c // 10]
    held_to(f"async_delta first {n_c} ticks vs scheme_async", head_a,
            oracle_a.distortion, short_a.w_shared, oracle_a.w_shared)
    ticks_ok = torch.equal(short_a.wall_ticks, oracle_a.wall_ticks)
    head_ok = torch.equal(short_a.distortion, head_a)
    print(f"check async_delta first {n_c} ticks: ticks equal {ticks_ok}, "
          f"short run's curve == main run's head {head_ok}")
    if not (ticks_ok and head_ok):
        fail("async_delta: first ticks disagree with the oracle")

    # -- 10. the sparse transport ---------------------------------------------
    n_windows = N_PER // TAU
    vq_fused.launches = vq_fused.launches_topk = vq_assign.launches = 0
    res_s, ex_s, wall_s = train.run_vq(train.parse_args(
        full + ["--scheme", "delta", "--transport", "sparse",
                "--compress-frac", str(SPARSE_FRAC)]))
    counts_s = {"window": vq_fused.launches, "topk": vq_fused.launches_topk,
                "delta": vq_assign.launches}
    merge_s = ex_s.last_comm["by_tag"]["merge"]
    res_d, _, wall_d = runs["delta"]
    curve_s = res_s.distortion.cpu()
    same_curve = torch.equal(res_s.distortion, res_d.distortion)
    same_w = torch.equal(res_s.w_shared, res_d.w_shared)
    print(f"main path --scheme delta --transport sparse --compress-frac "
          f"{SPARSE_FRAC} (k={k_main}): C first {float(curve_s[0]):.6f} last "
          f"{float(curve_s[-1]):.6f}, wall {wall_s:.2f} s "
          f"({wall_s / (M * N_PER) * 1e6:.3f} us/point; dense delta "
          f"{wall_d / (M * N_PER) * 1e6:.3f}), launches {counts_s}, merge "
          f"wire {merge_s['wire_bytes']:,} B per worker; curve == dense "
          f"{same_curve}, codebook == dense {same_w}")
    if (counts_s["topk"] != n_windows or counts_s["window"] != n_windows
            or counts_s["delta"]):
        fail(f"sparse delta: launches {counts_s}, expected {n_windows} "
             f"top-k and window launches")
    if merge_s["wire_bytes"] != n_windows * (M - 1) * k_main * 8:
        fail(f"sparse delta: merge wire {merge_s['wire_bytes']:,} B")
    if not (same_curve and same_w):
        fail("sparse delta at k >= tau * d differs from the dense run")

    # lossy: k = 524 < tau * d, error feedback at work
    lossy_full = ["--executor", "mesh", "--workers", str(M), "--points",
                  str(LOSSY_POINTS), "--dim", str(D), "--kappa", str(KAPPA),
                  "--tau", str(TAU), "--seed", str(SEED), "--network",
                  "instant", "--scheme", "delta"]
    lossy_args = train.parse_args(lossy_full + [
        "--transport", "sparse", "--compress-frac", str(LOSSY_FRAC)])
    vq_fused.launches = vq_fused.launches_topk = 0
    res_l, _, wall_l = train.run_vq(lossy_args)
    counts_l = {"window": vq_fused.launches, "topk": vq_fused.launches_topk}
    res_ld, _, _ = train.run_vq(train.parse_args(lossy_full))
    curve_l = res_l.distortion.cpu()
    lw = LOSSY_POINTS // TAU
    if counts_l != {"window": lw, "topk": lw}:
        fail(f"lossy sparse delta: launches {counts_l}")
    if not (bool(torch.isfinite(curve_l).all())
            and float(curve_l[-1]) < float(curve_l[0])):
        fail("lossy sparse delta: curve not finite or not going down")
    w0l, datal, evall = train.make_inputs(lossy_args, dev)
    eps_l = vq.default_steps(torch.arange(1, lw * TAU + 1, device=dev))
    w_hand, curve_hand = w0l, []
    resid = torch.zeros((M, KAPPA * D), device=dev)
    for i in range(CHECK_WINDOWS):
        span = slice(i * TAU, (i + 1) * TAU)
        wk = vq_fused.vq_window(datal[:, span].contiguous(), w_hand,
                                eps_l[span])
        full_p = merge_lib.tree_sub_f32(w_hand, wk).reshape(M, -1) + resid
        vals, idx, resid = vq_fused.vq_topk_plain(full_p, k_l)
        sent = torch.zeros_like(full_p).scatter_(1, idx.long(), vals)
        w_hand = merge_lib.tree_apply_delta(
            w_hand, torch.sum(sent.view(M, KAPPA, D), dim=0))
        curve_hand.append(torch.mean(vq.distortion(evall, w_hand), dim=0))
    curve_hand = torch.stack(curve_hand)
    short_l = get_executor(
        "mesh", network=InstantNetwork(),
        transport=comm.get_transport("sparse", frac=LOSSY_FRAC),
        device=dev).run("delta", w0l, datal[:, : CHECK_WINDOWS * TAU],
                        evall, tau=TAU)
    hand_ok = (torch.equal(res_l.distortion[:CHECK_WINDOWS], curve_hand)
               and torch.equal(short_l.distortion, curve_hand)
               and torch.equal(short_l.w_shared, w_hand))
    print(f"lossy sparse delta --compress-frac {LOSSY_FRAC} (k={k_l}), "
          f"{LOSSY_POINTS} points/worker: C first {float(curve_l[0]):.6f} "
          f"last {float(curve_l[-1]):.6f} (dense at the same depth "
          f"{float(res_ld.distortion[-1]):.6f}), wall {wall_l:.2f} s, "
          f"launches {counts_l}; first {CHECK_WINDOWS} windows == the loop written out "
          f"(window kernel, payload + residual, plain selection, sum): "
          f"{hand_ok}")
    if not hand_ok:
        fail("lossy sparse delta differs from the loop written out")

    # eq. 9 over the sparse transport, on the dense run's round lengths
    n_t = SPARSE_TICKS
    vq_fused.launches = vq_fused.launches_topk = vq_assign.launches = 0
    sparse_async = get_executor(
        "mesh", network=GeometricDelayNetwork(P_DELAY),
        transport=comm.get_transport("sparse", frac=SPARSE_FRAC), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_sa = sparse_async.run("async_delta", w0_a, data_a[:, :n_t], eval_a,
                              tau=TAU, lengths=lengths[:, : n_t // TAU + 2])
    curve_sa = res_sa.distortion.cpu()
    wall_sa = time.perf_counter() - t0
    counts_sa = {"window": vq_fused.launches, "topk": vq_fused.launches_topk,
                 "delta": vq_assign.launches}
    merge_sa = sparse_async.last_comm["by_tag"]["merge"]
    head_ok = torch.equal(res_sa.distortion, res_a.distortion[: n_t // 10])
    print(f"eq. 9 --transport sparse --compress-frac {SPARSE_FRAC}, {n_t} "
          f"ticks: C last {float(curve_sa[-1]):.6f}, wall {wall_sa:.2f} s "
          f"({wall_sa / (M * n_t) * 1e6:.3f} us/point; dense eq. 9 "
          f"{wall_a / (M * ASYNC_TICKS) * 1e6:.3f}), launches {counts_sa}, merge "
          f"wire {merge_sa['wire_bytes']:,} B; curve == dense eq.-9 head "
          f"{head_ok}")
    if counts_sa != {"window": 0, "topk": n_t, "delta": n_t}:
        fail(f"sparse eq. 9: launches {counts_sa}")
    if merge_sa["wire_bytes"] != n_t * (M - 1) * k_main * 8:
        fail(f"sparse eq. 9: merge wire {merge_sa['wire_bytes']:,} B")
    if not head_ok:
        fail("sparse eq. 9 at k >= the in-flight entries differs from the "
             "dense run's head")

    # -- 11. the blocked kernel: vs the delta kernel, vs plain ----------------
    gen_b = torch.Generator(device=dev).manual_seed(SEED + 6)
    z1 = data[:, :1].contiguous()
    for z, label in ((z1, "batch 1"), (eval_data, f"batch {N_EVAL}")):
        same = [same_bits(a, b) for a, b in zip(
            vq_fused.vq_delta_blocked(z, wb), vq_assign.vq_delta(z, wb))]
        print(f"check blocked == delta kernel, {label} (M={M}, kappa={KAPPA}"
              f", d={D}), bitwise (counts, zsum, mind, assign): {same}")
        if not all(same):
            fail(f"blocked kernel differs from the delta kernel, {label}")
    resid_b = 0.01 * torch.randn((M, KAPPA, D), generator=gen_b, device=dev)
    for z, label in ((z1, "batch 1"), (eval_data, f"batch {N_EVAL}")):
        same = [same_bits(a, b) for a, b in zip(
            ops.vq_delta_topk(z, wb, resid_b, frac=SPARSE_FRAC),
            ops.vq_delta_topk(z, wb, resid_b, frac=SPARSE_FRAC,
                              budget_bytes=FORCE_BUDGET))]
        print(f"check ops.vq_delta_topk blocked branch == full-kernel branch, "
              f"{label}, d={D}, bitwise (vals, idx, residual): {same}")
        if not all(same):
            fail(f"vq_delta_topk's blocked branch differs, {label}")

    if ops.delta_fits(WIDE_D) or not ops.window_fits(KAPPA, WIDE_D):
        fail(f"d={WIDE_D}: expected the blocked route and the window kernel")
    ww = (w0w + 0.01 * torch.randn((M, KAPPA, WIDE_D), generator=gen_b,
                                   device=dev)).contiguous()
    resid_w = 0.01 * torch.randn((M, KAPPA, WIDE_D), generator=gen_b,
                                 device=dev)
    z1w = dataw[:, :1].contiguous()
    blocked_err = 0.0
    for z, label in ((z1w, f"({M}, 1) x {KAPPA} x {WIDE_D}"),
                     (evalw, f"({M}, {N_EVAL}) x {KAPPA} x {WIDE_D}")):
        blocked_err = max(blocked_err, check_blocked(z, ww, label, resid_w))
    zr, wr, rr = (torch.rand(shape, generator=gen_b, device=dev)
                  for shape in ((3, 37, 3000), (3, 1001, 3000),
                                (3, 1001, 3000)))
    check_blocked(zr, wr, "ragged (M=3, kappa=1001, d=3000, B=37)", rr)
    zr, wr = (torch.rand(shape, generator=gen_b, device=dev)
              for shape in ((2, 13, 8000), (2, 300, 8000)))
    check_blocked(zr, wr, "points read in place (M=2, kappa=300, d=8000, "
                  "B=13)")
    # the epilogue at B <= 8 on +0 and -0 residual entries (and w's own
    # signs), at the tick's width and past the sweep's staging limit
    resid_pm = resid_w.clone()
    resid_pm[..., 0::3] = 0.0
    resid_pm[..., 1::3] = -0.0
    for b in (1, 8):
        check_blocked(dataw[:, :b].contiguous(), ww,
                      f"({M}, {b}) x {KAPPA} x {WIDE_D}, residual with +-0 "
                      f"entries", resid_pm)
    for b in (1, 9):
        zr, wr, rr = (torch.randn(shape, generator=gen_b, device=dev)
                      for shape in ((2, b, 8000), (2, 300, 8000),
                                    (2, 300, 8000)))
        rr[..., 0::3] = 0.0
        rr[..., 1::3] = -0.0
        check_blocked(zr, wr, f"(M=2, kappa=300, d=8000, B={b}), residual "
                      f"with +-0 entries", rr)
    del resid_pm
    z8w = dataw[:, :8].contiguous()
    for fn, label in (
            (lambda: vq_fused.vq_delta_blocked(z1w, ww), f"({M}, 1)"),
            (lambda: vq_fused.vq_delta_blocked(z1w, ww, residual=resid_w),
             f"({M}, 1) with the epilogue"),
            (lambda: vq_fused.vq_delta_blocked(z8w, ww, residual=resid_w),
             f"({M}, 8) with the epilogue"),
            (lambda: vq_fused.vq_delta_blocked(z1, wb), f"({M}, 1), d={D}")):
        one_launch(fn, f"blocked {label}")
    print(f"check blocked launches at B <= 8: one CUDA kernel a call at "
          f"({M}, 1) and ({M}, 8) x {KAPPA} x {WIDE_D}, with and without the "
          f"epilogue, and at ({M}, 1) x {KAPPA} x {D}")

    # -- 12. eq. 9 at d=128 through the blocked route -------------------------
    n_b = BLOCKED_TICKS
    zero_counts()
    forced = MeshExecutor(GeometricDelayNetwork(P_DELAY),
                          smem_budget_bytes=FORCE_BUDGET, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_f = forced.run("async_delta", w0_a, data_a[:, :n_b], eval_a,
                       tau=TAU, lengths=lengths[:, : n_b // TAU + 2])
    curve_f = res_f.distortion.cpu()
    wall_f = time.perf_counter() - t0
    counts_f = launch_counts()
    head_ok = torch.equal(res_f.distortion, res_a.distortion[: n_b // 10])
    print(f"eq. 9 at d={D} through the blocked route (smem budget "
          f"{FORCE_BUDGET} B), {n_b} ticks: C last {float(curve_f[-1]):.6f}, "
          f"wall {wall_f:.2f} s, launches {counts_f}; curve == dense eq.-9 "
          f"head {head_ok}")
    if counts_f != {"window": 0, "delta": 0, "assign": 0, "blocked": n_b,
                    "topk": 0, "ring": 0}:
        fail(f"eq. 9 through the blocked route: launches {counts_f}")
    if not head_ok:
        fail("eq. 9 through the blocked route differs from the dense run")

    # -- 13. eq. 9 and the sync scheme on a 3072-wide codebook ----------------
    zero_counts()
    res_w, _, wall_w = train.run_vq(train.parse_args(wide_async))
    counts_w = launch_counts()
    curve_w = res_w.distortion.cpu()
    print(f"main path --scheme async_delta --dim {WIDE_D} --kappa {KAPPA}, "
          f"{WIDE_POINTS} ticks: C first {float(curve_w[0]):.6f} last "
          f"{float(curve_w[-1]):.6f}, wall {wall_w:.2f} s "
          f"({wall_w / WIDE_POINTS * 1e3:.3f} ms/tick), launches {counts_w}")
    if counts_w != {"window": 0, "delta": 0, "assign": 0,
                    "blocked": WIDE_POINTS, "topk": 0, "ring": 0}:
        fail(f"eq. 9 at d={WIDE_D}: launches {counts_w}, expected one "
             f"blocked launch per tick and nothing else")
    if (len(curve_w) != WIDE_POINTS // 10
            or res_w.w_shared.shape != (KAPPA, WIDE_D)
            or not bool(torch.isfinite(curve_w).all())
            or not bool(torch.isfinite(res_w.w_shared).all())):
        fail(f"eq. 9 at d={WIDE_D}: result of the wrong shape or not finite")
    if not float(curve_w[-1]) < float(curve_w[0]):
        fail(f"eq. 9 at d={WIDE_D}: distortion did not go down")
    n_c = ASYNC_CHECK_TICKS
    lengths_w = GeometricDelayNetwork(P_DELAY).round_lengths(
        torch.Generator().manual_seed(SEED), M, WIDE_POINTS // TAU + 2, TAU)
    lengths_wc = lengths_w[:, : n_c // TAU + 2]
    oracle_w = async_vq.scheme_async(w0w, dataw[:, :n_c], evalw, tau=TAU,
                                     lengths=lengths_wc)
    short_w = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev).run(
        "async_delta", w0w, dataw[:, :n_c], evalw, tau=TAU,
        lengths=lengths_wc)
    zero_counts()
    unfused_w = MeshExecutor(GeometricDelayNetwork(P_DELAY), fused=False,
                             device=dev).run(
        "async_delta", w0w, dataw[:, :n_c], evalw, tau=TAU,
        lengths=lengths_wc)
    counts_u = launch_counts()
    head_w = res_w.distortion[: n_c // 10]
    held_to(f"eq. 9 at d={WIDE_D}, first {n_c} ticks vs scheme_async",
            head_w, oracle_w.distortion, short_w.w_shared, oracle_w.w_shared)
    ticks_ok = torch.equal(short_w.wall_ticks, oracle_w.wall_ticks)
    head_ok = torch.equal(short_w.distortion, head_w)
    via_ok = (torch.equal(unfused_w.distortion, short_w.distortion)
              and same_bits(unfused_w.w_shared, short_w.w_shared))
    print(f"check eq. 9 at d={WIDE_D}, first {n_c} ticks: ticks equal "
          f"{ticks_ok}, short run == main run's head {head_ok}; fused=False "
          f"(assign kernel + index_add_, launches {counts_u}) == blocked "
          f"route bitwise {via_ok}")
    if not (ticks_ok and head_ok):
        fail(f"eq. 9 at d={WIDE_D}: first ticks disagree with the oracle")
    if counts_u["assign"] != n_c or counts_u["blocked"] or not via_ok:
        fail(f"eq. 9 at d={WIDE_D}, fused=False: launches {counts_u}, equal "
             f"to the blocked route {via_ok}")

    wide_sync = wide + ["--scheme", "delta", "--network", "instant"]
    n_wwin = WIDE_POINTS // TAU
    zero_counts()
    # P5: profiled, a read-out (a profiler turns observation on: one
    # divergence launch a window)
    with tempfile.TemporaryDirectory(prefix="p5_") as tmp5:
        res_ws, ex_ws, wall_ws = train.run_vq(train.parse_args(
            wide_sync + ["--profile", str(Path(tmp5) / "p5.prof.json")]))
    counts_ws = launch_counts()
    div_ws = vq_fused.launches_divergence
    (a5,) = ex_ws.profiler.attributions
    modeled5 = sum(a5[f"t_{k}_s"] for k in ("compute", "memory",
                                             "collective"))
    print(f"profile P5 --dim {WIDE_D}, {WIDE_POINTS} points a worker "
          f"({card}): window wall {a5['window_wall_s'] * 1e6:.1f} us, "
          f"compute {a5['t_compute_s'] * 1e6:.1f} + memory "
          f"{a5['t_memory_s'] * 1e6:.1f} + collective "
          f"{a5['t_collective_s'] * 1e6:.1f} = modeled {modeled5 * 1e6:.1f} "
          f"us ({modeled5 / a5['window_wall_s']:.3f} of the wall), host "
          f"{a5['t_host_s'] * 1e6:.1f} us, consistency "
          f"{a5['consistency']:.4f} (a read-out: the hand count charges two "
          f"codebook reads a step); divergence launches {div_ws}")
    if div_ws != n_wwin:
        fail(f"P5: {div_ws} divergence launches, expected {n_wwin}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_wf = MeshExecutor(InstantNetwork(), smem_budget_bytes=FORCE_BUDGET,
                          device=dev).run("delta", w0w, dataw, evalw, tau=TAU)
    curve_wf = res_wf.distortion.cpu()
    wall_wf = time.perf_counter() - t0
    counts_wf = launch_counts()
    eps_w = vq.default_steps(torch.arange(1, n_wwin * TAU + 1, device=dev))
    w_srd, win_same = w0w, 0
    for i in range(n_wwin):
        span = slice(i * TAU, (i + 1) * TAU)
        zwin = dataw[:, span].contiguous()
        wk = vq_fused.vq_window(zwin, w_srd, eps_w[span])
        w = w_srd.expand(M, KAPPA, WIDE_D).contiguous()
        for s in range(TAU):
            cs, zs = ops.vq_delta_routed(zwin[:, s].unsqueeze(1).contiguous(),
                                         w, budget_bytes=FORCE_BUDGET)
            w = w - eps_w[span][s] * (cs.unsqueeze(-1) * w - zs)
        if not same_bits(w, wk):
            fail(f"d={WIDE_D} window {i}: the window kernel differs from the "
                 f"per-step loop through the blocked kernel, max |diff| "
                 f"{float((w - wk).abs().max()):.3e}")
        win_same += 1
        w_srd = w_srd - torch.sum(w_srd - wk, dim=0)   # eq. 8
    sync_same = (torch.equal(res_wf.distortion, res_ws.distortion)
                 and same_bits(res_wf.w_shared, res_ws.w_shared))
    curve_ws = res_ws.distortion.cpu()
    print(f"main path --scheme delta --dim {WIDE_D}, {WIDE_POINTS} "
          f"points/worker: C first {float(curve_ws[0]):.6f} last "
          f"{float(curve_ws[-1]):.6f}, wall {wall_ws:.2f} s, launches "
          f"{counts_ws}; per-step through the blocked kernel (smem budget "
          f"{FORCE_BUDGET} B): wall {wall_wf:.2f} s, launches {counts_wf}, "
          f"curve and codebook == window route bitwise {sync_same}; window "
          f"kernel == per-step blocked loop, bitwise, {win_same} of {n_wwin} "
          f"windows")
    if (counts_ws["window"] != n_wwin or counts_ws["blocked"]
            or counts_ws["delta"]):
        fail(f"sync delta at d={WIDE_D}: launches {counts_ws}")
    if counts_wf["blocked"] != WIDE_POINTS or counts_wf["window"]:
        fail(f"sync delta at d={WIDE_D} through the blocked route: launches "
             f"{counts_wf}")
    if not sync_same:
        fail(f"sync delta at d={WIDE_D}: the blocked per-step route differs "
             f"from the window route")
    if not float(curve_ws[-1]) < float(curve_ws[0]):
        fail(f"sync delta at d={WIDE_D}: distortion did not go down")

    # -- 14. the tile tuner ---------------------------------------------------
    legacy = autotune.legacy_tiles()
    model_pick = autotune.pick_tiles(1, KAPPA, WIDE_D, m=M, device=dev,
                                     kind="delta_blocked")
    autotune.reset("search")
    t0 = time.perf_counter()
    tuned = autotune.pick_tiles(1, KAPPA, WIDE_D, m=M, device=dev,
                                kind="delta_blocked")
    t_search = time.perf_counter() - t0
    autotune.reset("cache")
    for z in (z1w, evalw):
        same = [same_bits(a, b) for a, b in zip(
            vq_fused.vq_delta_blocked(z, ww, residual=resid_w,
                                      kchunk=tuned.kchunk, bk=tuned.bk),
            vq_fused.vq_delta_blocked(z, ww, residual=resid_w,
                                      kchunk=legacy.kchunk, bk=legacy.bk))]
        if not all(same):
            fail(f"tuned tiles {tuned} change bits against {legacy}: {same}")
    tile_ms = {legacy: [], tuned: [], model_pick: []}
    for cfg in (legacy, tuned, model_pick, model_pick, tuned, legacy):
        tile_ms[cfg].append(time_ms(lambda: vq_fused.vq_delta_blocked(
            z1w, ww, kchunk=cfg.kchunk, bk=cfg.bk), 50))
    print(f"tuner search at ({M}, 1) x {KAPPA} x {WIDE_D}: picked {tuned} in "
          f"{t_search:.2f} s (model's pick {model_pick}, untuned {legacy}); "
          f"tuned == untuned bitwise at batch 1 and {N_EVAL} (counts, zsum, "
          f"mind, assign, delta); ms per launch (order untuned, tuned, model, "
          f"model, tuned, untuned): "
          f"{ {str(k): [round(x, 4) for x in v]
              for k, v in tile_ms.items()} }")

    # -- 15. the ring kernel against its plain version ------------------------
    ring_mask = torch.tensor(RING_MASK, device=dev)
    gen_r = torch.Generator(device=dev).manual_seed(SEED + 7)
    wide_payload = torch.randn((M, KAPPA * WIDE_D), generator=gen_r,
                               device=dev)
    eval_payload = vq.distortion(eval_data, w0).view(M, 1).contiguous()
    for x, label, mask in (
            (payload, "window displacement", None),
            (normal_payload, "N(0, 1)", None),
            (normal_payload, "N(0, 1), 0/1 mask", ring_mask),
            (eval_payload, "eval payload", None),
            (torch.randn((3, 40_040), generator=gen_r, device=dev),
             "ragged", None),
            (torch.randn((5, 1_000_003), generator=gen_r, device=dev),
             "ragged", None),
            (torch.randn((M, KAPPA * D - 3), generator=gen_r, device=dev),
             "chunk a multiple of 4, N not", None),
            (torch.randn((5, 999_996), generator=gen_r, device=dev),
             "float4 route, short last chunk", None),
            (torch.randn((5, 999_996), generator=gen_r, device=dev),
             "float4 route, 0/1 mask", ring_mask[:5].contiguous()),
            (wide_payload, f"d={WIDE_D} payload", None)):
        check_ring(x, label, mask)
    # the top-k kernel past its shared memory: the d=3072 payload at 1%
    k_wide = max(1, int(SPARSE_FRAC * KAPPA * WIDE_D))
    topk_equal(wide_payload, k_wide, f"d={WIDE_D} payload")
    print(f"check top-k vs plain, bitwise, one launch: ({M}, "
          f"{KAPPA * WIDE_D}) d={WIDE_D} payload at k = {k_wide}: equal; "
          f"plan {topk_plan_line(wide_payload)}")

    # -- 16. the ring transport: sync delta, average, eq. 9, int8 wire --------
    n_windows = N_PER // TAU
    ring_wire = comm.ring_wire_bytes(4 * KAPPA * D, M)
    zero_counts()
    res_r, ex_r, wall_r = train.run_vq(train.parse_args(
        full + ["--scheme", "delta", "--transport", "ring"]))
    counts_r = expect_counts("ring delta", window=n_windows,
                             ring=2 * n_windows)
    merge_r = ex_r.last_comm["by_tag"]["merge"]
    res_d, _, wall_d = runs["delta"]
    print(f"main path --scheme delta --transport ring: C first "
          f"{float(res_r.distortion[0]):.6f} last "
          f"{float(res_r.distortion[-1]):.6f}, wall {wall_r:.2f} s "
          f"({wall_r / (M * N_PER) * 1e6:.3f} us/point; dense delta "
          f"{wall_d / (M * N_PER) * 1e6:.3f}), launches {counts_r}, merge "
          f"wire {ring_wire:,} B a window, {merge_r['wire_bytes']:,} B in all")
    if merge_r["wire_bytes"] != n_windows * ring_wire:
        fail(f"ring delta: merge wire {merge_r['wire_bytes']:,} B")
    if (res_r.w_shared.shape != (KAPPA, D)
            or not bool(torch.isfinite(res_r.distortion).all())
            or not float(res_r.distortion[-1]) < float(res_r.distortion[0])):
        fail("ring delta: result of the wrong shape, not finite or not "
             "going down")
    held_to(f"ring delta vs dense delta, all {n_windows} windows",
            res_r.distortion, res_d.distortion, res_r.w_shared,
            res_d.w_shared)
    n_p = RING_PLAIN_WINDOWS
    short = {}
    for name, transport in (
            ("ring", comm.get_transport("ring")),
            ("dense", comm.get_transport("xla")),
            ("plain ring", comm.RingTransport().plain()),
            ("quant[identity:ring]",
             comm.get_transport("quant", inner="ring", mode="identity"))):
        zero_counts()
        short[name] = MeshExecutor(InstantNetwork(), transport=transport,
                                   device=dev).run(
            "delta", w0, data[:, : n_p * TAU], eval_data, tau=TAU)
        expect_counts(f"{name} delta, {n_p} windows", window=n_p,
                      ring=0 if name in ("dense", "plain ring") else 2 * n_p)
    held_to(f"ring delta vs dense delta, first {n_p} windows",
            short["ring"].distortion, short["dense"].distortion,
            short["ring"].w_shared, short["dense"].w_shared)
    for name in ("plain ring", "quant[identity:ring]"):
        same = (same_bits(short[name].distortion, res_r.distortion[:n_p])
                and same_bits(short[name].w_shared, short["ring"].w_shared))
        print(f"check ring delta first {n_p} windows == {name} run, bitwise "
              f"(curve, codebook): {same}")
        if not same:
            fail(f"ring delta differs from the {name} run")

    avg = ["--executor", "mesh", "--workers", str(M), "--points",
           str(RING_AVG_POINTS), "--dim", str(D), "--kappa", str(KAPPA),
           "--tau", str(TAU), "--seed", str(SEED), "--network", "instant",
           "--scheme", "average"]
    n_avg = RING_AVG_POINTS // TAU
    zero_counts()
    res_ra, _, wall_ra = train.run_vq(train.parse_args(
        avg + ["--transport", "ring"]))
    expect_counts("ring average", window=n_avg, ring=2 * n_avg)
    res_da, _, _ = train.run_vq(train.parse_args(avg))
    print(f"--scheme average --transport ring, {RING_AVG_POINTS} "
          f"points/worker: wall {wall_ra:.2f} s, {2 * n_avg} ring launches")
    held_to(f"ring average vs dense average, {n_avg} windows",
            res_ra.distortion, res_da.distortion, res_ra.w_shared,
            res_da.w_shared)

    n_t = SPARSE_TICKS
    zero_counts()
    ring_async = MeshExecutor(GeometricDelayNetwork(P_DELAY),
                              transport="ring", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_rq = ring_async.run("async_delta", w0, data[:, :n_t], eval_data,
                            tau=TAU, lengths=lengths[:, : n_t // TAU + 2])
    curve_rq = res_rq.distortion.cpu()
    wall_rq = time.perf_counter() - t0
    counts_rq = expect_counts("ring eq. 9", delta=n_t, ring=n_t + n_t // 10)
    merge_rq = ring_async.last_comm["by_tag"]["merge"]
    print(f"eq. 9 --transport ring (masked ring every tick), {n_t} ticks: C "
          f"last {float(curve_rq[-1]):.6f}, wall {wall_rq:.2f} s "
          f"({wall_rq / (M * n_t) * 1e6:.3f} us/point; dense eq. 9 "
          f"{wall_a / (M * ASYNC_TICKS) * 1e6:.3f}), launches {counts_rq}, merge "
          f"wire {merge_rq['wire_bytes']:,} B")
    if merge_rq["wire_bytes"] != n_t * ring_wire:
        fail(f"ring eq. 9: merge wire {merge_rq['wire_bytes']:,} B")
    dense_async = MeshExecutor(GeometricDelayNetwork(P_DELAY),
                               device=dev).run(
        "async_delta", w0, data[:, :n_t], eval_data, tau=TAU,
        lengths=lengths[:, : n_t // TAU + 2])
    held_to(f"ring eq. 9 vs dense eq. 9, {n_t} ticks", res_rq.distortion,
            dense_async.distortion, res_rq.w_shared, dense_async.w_shared)
    n_pt = RING_PLAIN_TICKS
    plain_async = MeshExecutor(
        GeometricDelayNetwork(P_DELAY), transport=comm.RingTransport().plain(),
        device=dev).run("async_delta", w0, data[:, :n_pt], eval_data, tau=TAU,
                        lengths=lengths[:, : n_pt // TAU + 2])
    same = same_bits(plain_async.distortion, res_rq.distortion[: n_pt // 10])
    print(f"check ring eq. 9 first {n_pt} ticks == the plain-ring run, "
          f"bitwise: {same}")
    if not same:
        fail("ring eq. 9 differs from the plain-ring run")

    q_args = train.parse_args(lossy_full + ["--transport", "ring",
                                            "--wire-quant", "int8"])
    lw = LOSSY_POINTS // TAU
    zero_counts()
    res_q, ex_q, wall_q = train.run_vq(q_args)
    counts_q = expect_counts("int8 over ring", window=lw, ring=2 * lw)
    merge_q = ex_q.last_comm["by_tag"]["merge"]
    curve_q = res_q.distortion.cpu()
    print(f"--transport ring --wire-quant int8, {LOSSY_POINTS} points/worker:"
          f" C first {float(curve_q[0]):.6f} last {float(curve_q[-1]):.6f} "
          f"(dense at the same depth {float(res_ld.distortion[-1]):.6f}), "
          f"wall {wall_q:.2f} s, launches {counts_q}, merge wire "
          f"{merge_q['wire_bytes'] // lw:,} B a window "
          f"({merge_q['wire_bytes']:,} B in all)")
    # int8: a quarter of the f32 ring's bytes and each worker's f32 scale
    if merge_q["wire_bytes"] != lw * (ring_wire // 4 + 4):
        fail(f"int8 over ring: merge wire {merge_q['wire_bytes']:,} B")
    if not (bool(torch.isfinite(curve_q).all())
            and float(curve_q[-1]) < float(curve_q[0])):
        fail("int8 over ring: curve not finite or not going down")

    comm_layer_legs(dev, w0, data, eval_data, runs, lengths, payload,
                    normal_payload)
    elastic_legs(dev, w0, data, eval_data, runs)
    threads_serving_obs_legs(dev, w0, data, eval_data, runs, geo_run, lengths)
    with tempfile.TemporaryDirectory(prefix="subprocess_legs_") as tmp:
        subprocess_legs(Path(tmp))
    pg = process_group_legs(dev, w0, data, eval_data)
    cloud_process_legs(dev, w0, data, eval_data)
    elastic_serve_process_legs(dev, trained, geo_run)
    lm_serving_legs(dev)
    lm_training_legs(dev)
    placement_legs(dev)
    tensor_parallel_legs(dev)

    # -- 28. timing at the main path's shapes ---------------------------------
    # every kernel, plain and library time by kernel_ms (L2 cold, host time
    # hidden); "warm" is time_ms over back-to-back wrapper calls (L2 warm,
    # the wrapper's host time included), a read-out beside it
    zwin = data[:, :TAU].contiguous()
    eps = eps_all[:TAU].contiguous()
    win_ms = kernel_ms(lambda: vq_fused.vq_window(zwin, w0, eps), 200)
    win_warm = time_ms(lambda: vq_fused.vq_window(zwin, w0, eps), 200)
    win_plain = kernel_ms(lambda: vq_fused.vq_window_plain(zwin, w0, eps), 10)
    win_bound = bound(4 * (M * TAU * D + KAPPA * D + TAU + M * KAPPA * D),
                      TAU * M * KAPPA * (2 * D + 3))
    z1 = data[:, :1].contiguous()
    d1_ms = kernel_ms(lambda: vq_assign.vq_delta(z1, wb), 200)
    d1_warm = time_ms(lambda: vq_assign.vq_delta(z1, wb), 200)
    d1_plain = kernel_ms(lambda: vq_assign.vq_delta_plain(z1, wb), 50)

    def delta_bound(b):
        return bound(4 * (M * b * D + M * KAPPA * D + M * KAPPA
                          + M * KAPPA * D + 2 * M * b),
                     M * b * KAPPA * (2 * D + 3) + M * b * D)

    d1_bound = delta_bound(1)
    by_kchunk = {kc: round(kernel_ms(
        lambda: vq_assign.vq_delta(z1, wb, kchunk=kc), 100), 4)
        for kc in autotune.KCHUNK_CANDIDATES}
    kc_pick = autotune.pick_tiles(1, KAPPA, D, m=M, device=dev,
                                  kind="delta").kchunk
    de_ms = kernel_ms(lambda: vq_assign.vq_delta(eval_data, wb), 20)
    de_plain = kernel_ms(lambda: vq_assign.vq_delta_plain(eval_data, wb), 10)
    de_bound = delta_bound(N_EVAL)
    print(f"timing window (M={M}, tau={TAU}, kappa={KAPPA}, d={D}): kernel "
          f"{win_ms:.4f} ms (warm {win_warm:.4f}), plain {win_plain:.4f} ms, "
          f"bound {win_bound[0]:.4f} ms ({win_bound[1]})")
    # the thread runtime's round: one worker, one cluster of 8 blocks
    zround = data[:1, :TAU].contiguous()
    w1_ms = kernel_ms(lambda: vq_fused.vq_window(zround, w0, eps), 200)
    w1_warm = time_ms(lambda: vq_fused.vq_window(zround, w0, eps), 200)
    w1_plain = kernel_ms(lambda: vq_fused.vq_window_plain(zround, w0, eps),
                         10)
    w1_bound = bound(4 * (TAU * D + KAPPA * D + TAU + KAPPA * D),
                     TAU * KAPPA * (2 * D + 3))
    print(f"timing window (M=1, tau={TAU}, kappa={KAPPA}, d={D}, the thread "
          f"runtime's round): kernel {w1_ms:.4f} ms (warm {w1_warm:.4f}), "
          f"plain {w1_plain:.4f} ms, bound {w1_bound[0]:.4f} ms "
          f"({w1_bound[1]})")
    # the divergence kernel (no TPU kernel's counterpart: an observed
    # window's codebook divergence) at the window's shape
    wfin = vq_fused.vq_window(zwin, w0, eps)
    dv_ms = kernel_ms(lambda: vq_fused.vq_divergence(wfin, w0), 200)
    dv_warm = time_ms(lambda: vq_fused.vq_divergence(wfin, w0), 200)
    dv_plain = kernel_ms(lambda: vq_fused.vq_divergence_plain(wfin, w0), 200)
    dv_bound = bound(4 * (M + 1) * KAPPA * D, 3 * M * KAPPA * D)
    print(f"timing divergence (M={M}, kappa={KAPPA}, d={D}): kernel "
          f"{dv_ms:.4f} ms (warm {dv_warm:.4f}), plain {dv_plain:.4f} ms, "
          f"bound {dv_bound[0]:.4f} ms ({dv_bound[1]})")
    print(f"timing delta batch 1: kernel {d1_ms:.4f} ms (warm "
          f"{d1_warm:.4f}), plain {d1_plain:.4f} ms, bound "
          f"{d1_bound[0]:.4f} ms ({d1_bound[1]}); the sweep by kchunk "
          f"{by_kchunk} ms, the tuner's pick {kc_pick}")
    print(f"timing delta batch {N_EVAL}: kernel {de_ms:.4f} ms, plain "
          f"{de_plain:.4f} ms, bound {de_bound[0]:.4f} ms ({de_bound[1]})")
    zf = torch.randn((FLUSH_ROWS, D), device=dev)
    wt = trained.contiguous()
    af_ms = kernel_ms(lambda: vq_assign.vq_assign(zf, wt), 200)
    af_warm = time_ms(lambda: vq_assign.vq_assign(zf, wt), 200)
    af_plain = kernel_ms(lambda: vq_assign.vq_assign_plain(zf, wt), 200)

    def assign_bound(m, b):
        return bound(4 * (m * b * D + m * KAPPA * D + 2 * m * b),
                     m * b * KAPPA * (2 * D + 3) + m * b * D)

    af_bound = assign_bound(1, FLUSH_ROWS)
    ae_ms = kernel_ms(lambda: vq_assign.vq_assign(eval_data, wb), 20)
    ae_plain = kernel_ms(lambda: vq_assign.vq_assign_plain(eval_data, wb), 10)
    ae_bound = assign_bound(M, N_EVAL)
    print(f"timing assign flush ({FLUSH_ROWS} x {KAPPA} x {D}): kernel "
          f"{af_ms:.4f} ms (warm {af_warm:.4f}), plain {af_plain:.4f} ms, "
          f"bound {af_bound[0]:.4f} ms ({af_bound[1]})")
    print(f"timing assign eval (({M}, {N_EVAL}) x {KAPPA} x {D}): kernel "
          f"{ae_ms:.4f} ms, plain {ae_plain:.4f} ms, bound "
          f"{ae_bound[0]:.4f} ms ({ae_bound[1]})")
    # the fused=False leg's shape at d=3072: read the codebooks once
    at_ms = kernel_ms(lambda: vq_assign.vq_assign(z1w, ww), 100)
    at_plain = kernel_ms(lambda: vq_assign.vq_assign_plain(z1w, ww), 20)
    at_bound = bound(4 * (M * WIDE_D + M * KAPPA * WIDE_D + 2 * M),
                     M * KAPPA * (2 * WIDE_D + 3) + M * WIDE_D)
    print(f"timing assign ({M}, 1) x {KAPPA} x {WIDE_D}: kernel "
          f"{at_ms:.4f} ms, plain {at_plain:.4f} ms, bound "
          f"{at_bound[0]:.4f} ms ({at_bound[1]})")
    def blocked_bound(d, epilogue):
        # batch 1: read z, w (and the residual); write counts, zsum, mind,
        # assign (and delta); the distance and the one-point sums (and the
        # epilogue's three operations an element)
        big = M * KAPPA * d
        n_in = M * d + big * (2 if epilogue else 1)
        n_out = M * KAPPA + big * (2 if epilogue else 1) + 2 * M
        flops = M * KAPPA * (2 * d + 3) + M * d + (3 * big if epilogue else 0)
        return bound(4 * (n_in + n_out), flops)

    bl_ms = kernel_ms(lambda: vq_fused.vq_delta_blocked(z1w, ww), 100)
    bl_warm = time_ms(lambda: vq_fused.vq_delta_blocked(z1w, ww), 100)
    bl_plain = kernel_ms(lambda: vq_fused.vq_delta_blocked_plain(z1w, ww), 20)
    bl_bound = blocked_bound(WIDE_D, False)
    be_ms = kernel_ms(lambda: vq_fused.vq_delta_blocked(
        z1w, ww, residual=resid_w), 100)
    be_plain = kernel_ms(lambda: vq_fused.vq_delta_blocked_plain(
        z1w, ww, resid_w), 20)
    be_bound = blocked_bound(WIDE_D, True)
    pair = {"blocked": [], "delta": []}
    for name in ("blocked", "delta", "delta", "blocked"):
        fn = vq_fused.vq_delta_blocked if name == "blocked" else (
            vq_assign.vq_delta)
        pair[name].append(kernel_ms(lambda: fn(z1, wb), 200))
    b128_plain = kernel_ms(lambda: vq_fused.vq_delta_blocked_plain(z1, wb),
                           50)
    b128_bound = blocked_bound(D, False)
    print(f"timing blocked ({M}, 1) x {KAPPA} x {WIDE_D}: kernel {bl_ms:.4f} "
          f"ms (warm {bl_warm:.4f}), plain {bl_plain:.4f} ms, bound "
          f"{bl_bound[0]:.4f} ms ({bl_bound[1]}); with the epilogue: kernel "
          f"{be_ms:.4f} ms, plain {be_plain:.4f} ms, bound {be_bound[0]:.4f} "
          f"ms ({be_bound[1]})")
    print(f"timing blocked ({M}, 1) x {KAPPA} x {D} beside the delta kernel "
          f"(order blocked, delta, delta, blocked): blocked {pair['blocked']}"
          f" ms, delta {pair['delta']} ms, plain {b128_plain:.4f} ms, bound "
          f"{b128_bound[0]:.4f} ms ({b128_bound[1]})")
    print("library_ms: null for the window, delta, assign and blocked "
          "kernels: none of their functions is one PyTorch call (an argmin "
          "fused with a scatter, a loop of dependent steps, and the "
          "squared-distance argmin with its min: torch.cdist returns "
          "distances, not the argmin and min)")
    # top-k and ring: the kernel and its library call in turns (kernel,
    # library, library, kernel)
    topk_t = {}
    n_flat = KAPPA * D
    for k in (k_main, k_l):
        warm = time_ms(lambda: vq_fused.vq_topk(payload, k), 100)
        tk, tl = in_turns(lambda: vq_fused.vq_topk(payload, k),
                          lambda: torch.topk(payload.abs(), k, dim=1), 50)
        tp = kernel_ms(lambda: vq_fused.vq_topk_plain(payload, k), 5)
        tb = bound(4 * 2 * M * n_flat + 8 * M * k, M * n_flat)
        tn = kernel_ms(lambda: vq_fused.vq_topk(normal_payload, k), 50)
        topk_t[k] = (mean(tk), tp, mean(tl), tb)
        print(f"timing top-k ({M}, {n_flat}), k={k}, window displacement: "
              f"kernel {r4(tk)} ms, torch.topk(|x|) {r4(tl)} ms (in turns; "
              f"selection only: no signed values, no residual), plain "
              f"{tp:.4f} ms, bound {tb[0]:.4f} ms ({tb[1]}); kernel on N(0, "
              f"1) entries {tn:.4f} ms; warm {warm:.4f} ms")
    n_wide = KAPPA * WIDE_D
    warm = time_ms(lambda: vq_fused.vq_topk(wide_payload, k_wide), 20)
    tk, tl = in_turns(lambda: vq_fused.vq_topk(wide_payload, k_wide),
                      lambda: torch.topk(wide_payload.abs(), k_wide, dim=1),
                      10)
    tp = kernel_ms(lambda: vq_fused.vq_topk_plain(wide_payload, k_wide), 2)
    tb = bound(4 * 2 * M * n_wide + 8 * M * k_wide, M * n_wide)
    print(f"timing top-k ({M}, {n_wide}), k={k_wide}, d={WIDE_D} payload "
          f"(N(0, 1)): kernel {r4(tk)} ms, torch.topk(|x|) {r4(tl)} ms (in "
          f"turns), plain {tp:.4f} ms, bound {tb[0]:.4f} ms ({tb[1]}); warm "
          f"{warm:.4f} ms")
    ring_t = {}
    for x, iters in ((normal_payload, 200), (wide_payload, 20)):
        re_ = time_ms(lambda: ring.ring_all_reduce(x), iters)
        le = time_ms(lambda: torch.sum(x, dim=0), iters)
        rk, rl = in_turns(lambda: ring.ring_all_reduce(x),
                          lambda: torch.sum(x, dim=0), iters)
        rp = kernel_ms(lambda: ring.ring_all_reduce_plain(x),
                       max(3, iters // 20))
        # read x once, write one row; (M - 1) additions an entry
        rb = bound(4 * (M + 1) * x.shape[1], (M - 1) * x.shape[1])
        ring_t[x.shape[1]] = (mean(rk), rp, mean(rl), rb)
        print(f"timing ring {tuple(x.shape)}: kernel {r4(rk)} ms, "
              f"torch.sum(x, dim=0) {r4(rl)} ms (in turns; another order), "
              f"plain {rp:.4f} ms, bound {rb[0]:.4f} ms ({rb[1]}); warm: "
              f"kernel {re_:.4f} ms, torch.sum {le:.4f} ms")
    sync_ex = MeshExecutor(InstantNetwork(), device=dev)
    ring_ex = MeshExecutor(InstantNetwork(), transport="ring", device=dev)
    turns = {sync_ex: [], ring_ex: []}
    for ex in (sync_ex, ring_ex, ring_ex, sync_ex):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU], eval_data,
               tau=TAU).distortion.cpu()
        turns[ex].append((time.perf_counter() - t0) / PROFILE_WINDOWS * 1e6)
    print(f"sync delta, {PROFILE_WINDOWS} windows in turns (dense, ring, "
          f"ring, dense), us a window on the host clock: dense "
          f"{[round(t, 1) for t in turns[sync_ex]]}, ring "
          f"{[round(t, 1) for t in turns[ring_ex]]}")
    profile("--scheme delta, fused",
            lambda: sync_ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU],
                                eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")
    from repro_torch.obs import MetricsRegistry, Tracer
    obs_ex = MeshExecutor(InstantNetwork(), tracer=Tracer(),
                          metrics=MetricsRegistry(), device=dev)
    profile("--scheme delta, fused, observed",
            lambda: obs_ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU],
                               eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")
    async_ex = MeshExecutor(GeometricDelayNetwork(P_DELAY), device=dev)
    profile("--scheme async_delta",
            lambda: async_ex.run("async_delta", w0,
                                 data[:, :PROFILE_TICKS], eval_data, tau=TAU),
            PROFILE_TICKS, "tick")
    sparse_ex = MeshExecutor(
        InstantNetwork(), transport=comm.get_transport("sparse",
                                                       frac=SPARSE_FRAC),
        device=dev)
    profile(f"--scheme delta --transport sparse --compress-frac {SPARSE_FRAC}",
            lambda: sparse_ex.run("delta", w0,
                                  data[:, : PROFILE_WINDOWS * TAU],
                                  eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")
    profile("--scheme delta --transport ring",
            lambda: ring_ex.run("delta", w0, data[:, : PROFILE_WINDOWS * TAU],
                                eval_data, tau=TAU),
            PROFILE_WINDOWS, "window")
    profile(f"--scheme async_delta --dim {WIDE_D}",
            lambda: async_ex.run("async_delta", w0w,
                                 dataw[:, :ASYNC_CHECK_TICKS], evalw,
                                 tau=TAU),
            ASYNC_CHECK_TICKS, "tick")

    kernels = [
        {"name": "vq_window", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_window.cu",
         "replaces": "src/repro/kernels/vq_fused.py:232",
         "launches": runs["delta"][1]["window"], "max_abs_err": win_err,
         "ms": win_ms, "plain_ms": win_plain, "bound_ms": win_bound[0],
         "bound_by": win_bound[1], "library_ms": None},
        {"name": "vq_delta", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_delta.cu",
         "replaces": "src/repro/kernels/vq_assign.py:108",
         "launches": counts_a["delta"], "max_abs_err": mind_err,
         "ms": d1_ms, "plain_ms": d1_plain, "bound_ms": d1_bound[0],
         "bound_by": d1_bound[1], "library_ms": None},
        {"name": "vq_assign", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_delta.cu",
         "replaces": "src/repro/kernels/vq_assign.py:33",
         "launches": serve_launches, "max_abs_err": assign_err,
         "ms": af_ms, "plain_ms": af_plain, "bound_ms": af_bound[0],
         "bound_by": af_bound[1], "library_ms": None},
        {"name": "vq_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_topk.cu",
         "replaces": "src/repro/kernels/vq_fused.py:191",
         "launches": counts_s["topk"], "max_abs_err": 0.0,
         "ms": topk_t[k_main][0], "plain_ms": topk_t[k_main][1],
         "bound_ms": topk_t[k_main][3][0], "bound_by": topk_t[k_main][3][1],
         "library_ms": topk_t[k_main][2]},
        {"name": "vq_delta_blocked", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_blocked.cu",
         "replaces": "src/repro/kernels/vq_fused.py:46",
         "launches": counts_w["blocked"], "max_abs_err": blocked_err,
         "ms": bl_ms, "plain_ms": bl_plain, "bound_ms": bl_bound[0],
         "bound_by": bl_bound[1], "library_ms": None},
        {"name": "vq_ring", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_ring.cu",
         "replaces": "src/repro/comm/ring.py:40",
         "launches": counts_r["ring"], "max_abs_err": 0.0,
         "ms": ring_t[KAPPA * D][0], "plain_ms": ring_t[KAPPA * D][1],
         "bound_ms": ring_t[KAPPA * D][3][0],
         "bound_by": ring_t[KAPPA * D][3][1],
         "library_ms": ring_t[KAPPA * D][2]},
        {"name": "vq_ring_hop", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vq_ring_hop.cu",
         "replaces": "src/repro/comm/ring.py:40",
         "launches": pg["launches"], "max_abs_err": 0.0,
         "ms": pg["hop"]["ms"], "plain_ms": pg["hop"]["plain_ms"],
         "bound_ms": pg["hop"]["bound"][0],
         "bound_by": pg["hop"]["bound"][1],
         "library_ms": pg["hop"]["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        # the run still fails; its traceback goes where the result would
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        sys.exit(1)
