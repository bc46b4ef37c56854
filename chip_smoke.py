#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                 # every phase (the default)
    python3 chip_smoke.py --phases build kernels

Phases, in order (any failure exits non-zero; no phase catches its own):

1. ``build``: print the card's name and power limit, compile every CUDA
   kernel from ``fakepta_tpu_torch/csrc`` (one nvcc per source, in
   parallel) and print the build seconds, ptxas' register report and the
   number of ``HMMA`` (tensor-core) instructions in each kernel's SASS
   (``cuobjdump -sass``); it fails if the kernels of
   ``binned_correlation``, ``binned_correlation_vpu`` or ``chunk_stats``'
   projection pass have none, or if the float64 kernels
   (``binned_correlation_f64``'s ``corr_f64_kernel`` and
   ``chunk_stats_f64``'s ``project_f64_kernel``) have no ``DMMA`` (FP64
   tensor-core) instruction.
2. ``kernels``: at the flagship shapes (R = 1024 realizations, 100 pulsars,
   780 TOAs), hold each kernel against its plain torch version on the same
   inputs, at both precisions, and time kernel, plain version, the
   byte/FLOP bound and (where one exists) a single PyTorch library call;
   the sharded kernels at a psr shard's rows (PL = 25 or 50) against the
   whole array. For ``binned_correlation`` also its tiling and the 'f32'
   mode's 3xTF32 arithmetic emulated on 16 realizations against float64;
   for ``binned_correlation_vpu`` its tiling and realizations per block;
   for ``chunk_stats`` and ``chunk_stats_sharded`` the time of each of
   their two passes (projection, then ``binned_correlation``'s kernel)
   beside the whole, and pass 1's library time: one ``torch.einsum`` of
   the projection against a prebuilt dense basis at the row's shape (R,
   rows, K, T), at full fp32 for 'f32' (matmul precision set for the call)
   and on bf16 operands for 'bf16'. Then the float64 kernels on one chunk
   of the float64 flagship: ``binned_correlation_f64`` (PL = 100 and 50)
   within 1e-6 of the scale at 'f32' and 1e-5 at 'bf16' (float32 outputs),
   ``chunk_stats_f64`` (PL = 100) and ``chunk_stats_sharded_f64`` (PL = 50)
   within 1e-12 at 'f32' (float64 throughout) and the bf16 bound under
   bf16 storage, each against its plain version on the card, with a
   bit-identical rerun, its bound (FP64 tensor cores at 67 TFLOP/s) and
   its plain version's time; ``binned_correlation_f64``'s library time is
   a ``torch.einsum`` at float64, and ``chunk_stats_f64`` has none (one
   ``torch.einsum`` at float64 of its projection against a prebuilt basis
   is timed beside its pass-1 time).
3. ``engine``: run ``EnsembleSimulator`` on the flagship batch with an HD
   background for ``stat_path`` ``"fused"``, ``"fused"`` with
   ``pallas_mxu_binning=False`` (``"fused-vpu"``) and ``"mega"`` at
   ``'f32'`` and ``'bf16'``; each must agree with the ``"einsum"`` path, rerun
   bit-identically and launch its kernel (launch counts are zeroed just
   before these runs and read just after). A small array is also held
   against the CPU engine.
4. ``mesh``: the flagship batch on ``make_mesh(["cuda:0"] * S,
   psr_shards=S)`` for S = 2 and 4, every path (einsum, fused, fused with
   ``pallas_mxu_binning=False``, mega) at both precisions: each must agree
   with the 1-shard einsum run, rerun bit-identically and launch its
   kernel once per shard and chunk (counts zeroed just before, read just
   after). The shards of such a mesh run one after another on the one
   card. A small array at one pulsar per shard is held against the CPU
   engine on the same mesh shape. On the 2-shard ``"mega"`` mesh (#4 at
   PL = 50) a depth-2 run must equal a depth-0 run bit for bit, and a
   1-shard run's checkpoint, cut after its first chunk, must resume there
   with the stored chunk unchanged and within the mesh bounds of the
   unbroken 1-shard run. Then TOA sharding, on the einsum path (the only
   one that takes it): the flagship at ``toa_shards`` 2 and 4 and on a
   psr 2 x toa 2 mesh, ``ipta_dr3`` at ``toa_shards=2`` and the flagship's
   OS lane with its null stream at ``toa_shards=2``, each at both
   precisions within rtol 5e-5 of the 1-shard einsum run (the JAX
   package's bound), rerun bit-identically, launching no kernel.
5. ``scenarios``: the scenario registry's arrays. ``ng15``, uncut (68
   pulsars padded to 512 TOAs, four backend bands, white hyperprior
   draws), built by ``registry.get("ng15").build(device="cuda")``: each
   kernel held against its plain version and timed at its shapes (PL = 68
   and a 2-shard mesh's PL = 34), then ``run(4096, chunk=1024)`` on
   ``"einsum"`` f32 (the yardstick), ``"fused"``, ``"fused"`` with
   ``pallas_mxu_binning=False`` and ``"mega"`` at both precisions, each
   held to the einsum run with bit-identical reruns and its kernel's
   launches. The flagship with BASELINE config 8's ``NoiseSampling``
   (per-pulsar red U(-17, -13) x U(1, 5), GWB amplitude U(-15, -14)) and
   config 11's ``WhiteSampling`` (efac U(0.5, 2.5), log10_tnequad U(-8,
   -5)) on ``"fused"`` the same way; a zero-width ``NoiseSampling`` run
   equal to the fixed-PSD run bit for bit; ``ng15`` on
   ``make_mesh(["cuda:0"] * 2, psr_shards=2)`` through every path, within
   the mesh bounds of the 1-shard einsum run; ``ng15`` reduced against the
   CPU engine.
6. ``signals``: ``ipta_dr3`` uncut (120 pulsars padded to 896 TOA slots,
   seven backend bands, per-pulsar red hyperprior draws, an anisotropic
   background, a CGW source and a BayesEphem Jupiter-mass draw per
   realization), built by ``registry.get("ipta_dr3").build(device="cuda")``:
   each kernel held against its plain version and timed at its shapes
   (PL = 120 and a 2-shard mesh's PL = 60, K = 320), then ``run(4096,
   chunk=1024)`` on ``"einsum"`` f32 (the yardstick), ``"fused"``,
   ``"fused"`` with ``pallas_mxu_binning=False`` and ``"mega"`` at both
   precisions (bit-identical reruns, kernel launches, ``peak_hbm_bytes``);
   the 2-shard mesh through every path within the mesh bounds; a
   checkpointed cut-and-resume round on ``"mega"``; the device time of one
   chunk split into keys, draws, Roemer, CGW and the statistic from the
   engine's spans in one ``torch.profiler``-traced step, and the Roemer
   term's mass-only shortcut against its full difference form (bit for
   bit, both timed). Then the flagship
   with BASELINE config 6 (a fixed Jupiter-mass ``RoemerConfig``), config
   9 (``CGWSampling``) and config 9 with the pulsar term and sampled
   distances (the host's per-chunk bulk staging timed) on ``"fused"``.
7. ``run``: the run loop at the flagship's full width, on ``"fused"``,
   ``"fused"`` with ``pallas_mxu_binning=False`` and ``"mega"`` at both
   precisions: ``run(4096, chunk=1024, pipeline_depth=d)`` for d = 0..3,
   bit-identical, each with its realizations/s and its allocator peak
   (which must stay under one bare step's peak plus the packed buffers the
   loop may hold, plus 2 MiB of allocator rounding per live large block);
   the checkpointed depth-2 run beside the plain one
   (``ckpt_wait_s``, ``pipeline_stall_s``); a checkpointed run cut by its
   progress callback after 3 chunks and resumed, and again with a torn
   chunk file rolled back, both bit-identical to the unbroken run with the
   checkpoint files gone after; a 1024-slot cohort of RNG lanes, each lane
   bit-identical to the lane alone at the same chunk and within tolerance
   of its solo run. Then one pipelined cut-and-resume round of ``ng15`` on
   ``"mega"``. Every run's launches are counted (zeroed just before, read
   just after).
8. ``detect``: the detection lane. Every kernel held against its plain
   version and timed at the OS lane's shapes: the main launch (16 + 3 OS
   weight slots, NB = 19; K = 320 for ``chunk_stats``), the null stream's
   (NB = 4, the GWB-free stage set K = 260), on the shared set and a
   2-shard mesh's rows, ``os="hd"``'s (NB = 17) and ``ipta_dr3``'s. Then
   the flagship's ``run(4096, chunk=1024, os=OSSpec(orf=("hd",
   "monopole", "dipole"), null=True))`` on ``"einsum"`` f32 (the
   yardstick), ``"fused"``, ``"fused"`` with ``pallas_mxu_binning=False``
   and ``"mega"`` at both precisions: amp2 and null amp2 within 1e-4 (f32)
   / 1e-2 (bf16) of max|amp2| of the einsum run, the curves within the
   engine's bounds, reruns bit-identical, each kernel launched twice per
   chunk (the main launch and the null stream's); one traced step per path
   split into keys, draws, statistic and the null stream; ``os="hd"``
   without the null stream through every path; every path on a 2-shard
   psr mesh; ``DetectionRun`` on the flagship batch (its launches counted,
   its artifact loaded back) and ``python -m fakepta_tpu_torch.detect run
   --npsr 100 --ntoa 780 --nreal 4096 --chunk 1024 --out build/detect.jsonl``
   in a subprocess (exit 0, the artifact loads); ``ipta_dr3`` uncut on
   ``"fused"`` with an HD and its own anisotropic template and the null
   stream (``peak_hbm_bytes``).
9. ``facade``: the reference-compatible facade on the card. BASELINE
   configs 1 (``Pulsar`` of 520 TOAs, ``add_white_noise(seed=1)``) and 2
   (10 pulsars, ``add_noise_array`` red noise, seed 2) in injections/s
   after a warm-up, between synchronizations; ``make_fake_array(npsrs=100,
   Tobs=15, ntoas=780, isotropic=True, gaps=True, toaerr=1e-7, pdist=1,
   backends=["NUPPI"])`` timed; its pickle round trip through
   ``save_array`` / ``load_array(device="cuda")`` with the residuals equal;
   the example's ``copy_array`` replay of the shipped noisedict and custom
   models, on the card against the CPU within 1e-5 of scale. Then the
   array packed by ``PulsarBatch.from_pulsars`` (ragged TOAs under a mask,
   per-pulsar Tspan) with the flagship's HD background (K = 320 on mega):
   ``run(2048, chunk=1024)`` on ``"einsum"`` f32 (the yardstick), ``"fused"``,
   ``"fused"`` with ``pallas_mxu_binning=False`` and ``"mega"`` at both
   precisions and on a 2-shard mega mesh, held as in the engine phase;
   each kernel against its plain version and timed at the batch's shapes;
   the same batch cut to a TOA width with ``T % 4 != 0`` (the kernels'
   scalar staging) through every path at f32 and each kernel measured
   there; the replayed array against the CPU engine.
10. ``correlated``: the facade's correlated signals on the card. BASELINE
   config 3 (45 pulsars of 780 TOAs, an HD background at A = 2e-15,
   gamma = 13/3, 30 bins, through the batched whole-array path) in
   injections/s, re-injected, after a warm-up, between synchronizations,
   and the same draw replayed on the CPU within 1e-5 of each pulsar's
   scale; a ragged ``make_fake_array(npsrs=45, gaps=True)`` through the
   per-pulsar path; config 4 (100 pulsars with an ephemeris: DM noise, the
   HD background and a Jupiter-mass Roemer delay) in injections/s;
   ``add_common_correlated_noise_gp`` on 16 x 400 TOAs (a 6400 x 6400
   host float64 Cholesky), bit-equal to the CPU's draw, then replaced by
   the factorized draw; the example's flow (``examples/make_fake_array.py``:
   noises, the background, a CGW) through ``save_array`` / ``load_array``
   with the background re-injected on the card and on the CPU. Then config
   3's array packed by ``PulsarBatch.from_pulsars`` through ``"fused"``
   and ``"mega"`` at both precisions against the einsum run, and each
   kernel against its plain version at its shapes (PL = 45).
11. ``infer``: the likelihood lane (``run(lnlike=...)``) at the flagship's
   full width: red and DM at the batch's PSDs and a 30-bin CURN with free
   amplitude and slope (2M = 320 columns per pulsar) on a 5 x 5 grid.
   ``run(4096, chunk=1024, lnlike=...)`` on ``"einsum"`` f32 (the
   yardstick), then every path (einsum, fused, fused with
   ``pallas_mxu_binning=False``, mega) at both precisions and a 2-shard
   mega mesh (#4): curves and autos within the engine's bounds, the lanes
   within ``LANE_ULPS`` float32 ULP of the magnitudes the lane's sums add
   (its theta differences too), reruns bit-identical, each kernel
   launched once per shard and chunk, and the same run without the lane
   timed beside it; the einsum lane on a psr 2 x toa 2 mesh; one traced
   chunk per path split into the statistic, ``lnlike_moments`` and
   ``lnlike``; modes ``grad`` and ``fisher`` on ``"fused"`` at the full
   chunk with their peak memory; a fixed float64 flagship-width residual
   (``include=("det",)``) against a dense host float64 oracle per pulsar,
   with ``python -m fakepta_tpu_torch.infer run --npsr 100 --ntoa 780
   --nreal 4096 --chunk 1024`` in a subprocess beside it (exit 0, the
   artifact loads); ``InferenceRun`` at ``examples/likelihood_grid.py``'s
   at-scale line.
12. ``faults``: the recovery policy on the flagship (``run(2048,
   chunk=1024)``): a transient failure injected at ``mc.dispatch`` chunk 1
   on ``"mega"`` is retried bit-identically, and so is a
   ``torch.OutOfMemoryError`` raised at a dispatch by a stub; an injected
   kernel failure steps ``mega -> fused`` (3072 realizations, chunk 0 on
   mega and chunks 1-2 on fused, at f32 and bf16), each rung's chunks
   within the path's bound of the unfaulted mega run (1e-5 / 1e-2 of the
   curve scale), the rungs' kernels launched and counted,
   ``faults.degradations`` and ``meta["degraded_path"]`` saying so, and a
   second kernel failure, on the fused rung, raises (the port has no
   fallback from a kernel to the plain einsum path); the port's own launch
   error raised by a stub on a fused run propagates; a precision fault
   steps the fused path's bf16 to f32, bit-identical to its f32 run; a
   poisoned chunk fails with a flight-recorder dump; a torn checkpoint
   append kills the run and the resume rolls back, bit-identical; a hung
   writer meets
   ``RecoveryPolicy(watchdog_s=0.25)``'s ``WatchdogTimeout``. Every other
   phase's engine runs are held to zero degradations and the statistic
   path they asked for (the default policy must stay quiet).
13. ``sample``: the sampler at the flagship's full width (``flagship_100``,
   100 pulsars x 780 TOAs, red and DM at the batch's PSDs, a 30-bin CURN
   with free amplitude and slope: 2M = 320 columns per pulsar), float32,
   16 chains x 2 temps, ``n_leapfrog`` 8, warmup 16, 16 post steps, thin 2,
   segment 16 (the step counts are the only cuts): the Laplace fit's
   seconds, steps/s, ms per gradient evaluation, launches per leapfrog step
   and the device's idle share in one traced two-step segment, peak memory
   and R-hat; at 4 steps (on the staged moments and fit): a rerun, a
   checkpointed depth-0 run cut after one segment and resumed, and the
   ``real=2`` and ``psr=2`` meshes on ``cuda:0``, each bit-identical to
   the depth-2 one-shard run; the card against the CPU in the same process
   (the CPU's Laplace mode within 1e-9; for the first 4 chains, the
   initial lnL and the first
   leapfrog proposal's lnL within 4 float32 ULP of the magnitudes its sums
   add; the initial gradient and the first proposal's z, per tempering
   rung, within 4 times the CPU's float32 distance from the float64
   sampler's at the same state, the float32 floor of the same algorithm);
   a
   ``FactorizedRun`` of a 30-bin free-spectrum CURN (8 lanes of
   ``FS_LANE_BINS`` = 4) at 4 post steps; ``python -m
   fakepta_tpu_torch.sample run`` at half its default steps and warm-up
   (``SAMPLE_CLI_STEPS``; exit 0, the artifact
   loads).
14. ``stream``: streaming ingestion at config 14's accelerator shape
   (``benchmarks/suite.py:546-549``: a float64 template of 100 pulsars x
   780 TOAs over 15 yr, red 30 and DM 100 bins, ``default_stream_model(
   nbin=10)``: C = 280 columns; 780 TOAs a pulsar of history in two
   blocks, then 8-TOA epochs, ECORR epochs of 15 yr / 64, ``watch="hd"``).
   ``stream.bench.run_append_ab`` at config 14 (best-of-3 append against
   restage, ``append_speedup_x``, rebuckets, and ``stream_recompiles``,
   0 by construction in the port: a built kernel key is never built
   again); the watched stream's appends with the rolling OS update (the
   steady appends build no kernel and leave the bytes live on the card
   flat), its moments against a restage within 1e-8 relative, against the CPU
   port's on the same blocks within 1e-10 of each array's max
   (amp2 and snr within 1e-9), a rerun bit-identical, a psr-2 mesh on
   ``cuda:0`` within 1e-10 (bit identity reported); a checkpointed stream
   whose ``torn`` append rolls back and resumes bit-identically; the OS
   update's ms (CUDA events); ``PosteriorRefresher`` two cycles (float64,
   8 chains x 2 temps, ``n_leapfrog`` 4, 8 steps after a warmup of 8,
   segment 8: the step counts are the cut), the second warm-started with
   no more Newton steps, promotion following the R-hat gate; and
   ``FactorizedRefresher`` at config 18 part 2's shapes
   (``benchmarks/suite.py:743-746, 795-836``: 16 pulsars x 96 TOAs, 16
   free-spectrum bins, ``lane_bins=1``, 40-wide epochs, 96 steps, segment
   32, cut to 8 steps after an 8-step warm-up, segment 8): the
   single-bin sinusoid epoch
   touches exactly one lane, and ``fs_refresh_ms`` against
   ``fs_full_refresh_ms`` (``fs_recompiles`` reads 0 by construction);
   last, two traced steady appends (their launches, equal in number,
   copies and the device's idle share). No
   kernel of #1-#4 is on this path (the stream is library linear algebra,
   as the JAX stream is XLA outside any Pallas kernel).
15. ``multiproc``: the flagship on meshes that span processes
   (:func:`fakepta_tpu_torch.parallel.mesh.initialize_multihost`, one rank
   a subprocess of this script joined through a FileStore, each with a
   deadline): two ranks on cuda:0 under gloo by default; with
   ``--mesh-cards N`` >= 2, groups of 1, 2 and N ranks, one card each under
   NCCL. On the real N x psr 1 and real 1 x psr N meshes, ``run(2048,
   chunk=1024)`` on every path (einsum, fused, fused with
   ``pallas_mxu_binning=False``, mega) at f32 and bf16 (the 1- and 2-rank
   timing groups: fused f32 only): every rank's result bit-identical to
   rank 0's and to the one-process mesh of the same shape (``["cuda:0"] *
   N``, run by rank 0), each rank's kernel launched once per chunk
   (counts zeroed just before, read just after) and the run's report
   carrying its rank, the rank count and the backend; realizations/s per
   rank count beside the one-process mesh's. Rank 0 holds #1-#4 at its
   per-rank shapes against their plain versions. Then the OS lane with the
   null stream and the likelihood lane on the psr mesh (the likelihood
   lane on the real mesh too), bit-identical to the one-process mesh;
   checkpoint files on rank 0 only, deleted at the end; the psr fused
   run's event-log shards merged by ``obs.trace.build_trace`` into pid
   lanes {0..N-1}, each with dispatch spans; a ``SamplingRun`` of the
   flagship model (8 chains x 2 temps, 4 steps: the cut) on both meshes,
   chains bit-identical to the one-process run's; config 14's watched
   stream (100 pulsars x 780 TOAs of history in two blocks, then 8-TOA
   epochs, float64, HD) on the real 1 x psr N mesh with a checkpoint per
   rank: moments, lnL and every append's OS amp2 and snr bit-identical on
   every rank and to the one-process psr N mesh, checkpoint files on rank
   0 only, the append ms per rank beside the one-process mesh's;
   ``tune.search`` over every rank's entry (the flagship, 3 candidates,
   one probe chunk each, ``force=True``), each probe's launches of #1-#4
   counted on every rank (zeroed just before it) and held to its path's
   kernel, one TunedConfig on every rank, one store file, rank 0's
   artifact alone, and a warm second search with 0 probes; the sampler
   on the cross layout (real 2 x psr 2 x toa 2, entry (r, s, t) on rank
   (2r + s + t) mod N), chains bit-identical to the one-process run's;
   and per rank one einsum chunk on the psr mesh, its host enqueue
   against the time until the card is done and the card's traced busy
   time.
16. ``tune``: the tuner on ``flagship_100`` uncut on one card, with a
   fresh store under ``build/tune/``: the fingerprint of ``cuda:0`` (it
   must read the card's memory), then ``tune.search(batch, gwb,
   nreal_hint=4096, budget_s=60, max_candidates=8, force=True)`` with every
   kernel count zeroed just before and read just after, each probe's
   knobs, realizations/s, ``probe_s`` and peak bytes printed. It fails
   unless the hand-set candidate (einsum, chunk 1024, depth 2) was probed
   and the choice delivers at least its rate, a ``fused`` and a ``mega``
   probe completed (launching #1 and #3 through ``run()``) with none
   degraded, and the artifact reads as tuned; a second search must be
   warm (zero probes in under 1 s); ``run(4096, tuned=True)`` from the
   store must apply the stored knobs, bit-identical to the same knobs
   given explicitly (its launches counted too), and it and one chunk of
   each completed fused or mega probe's knobs must agree with the einsum
   path at the same seed, chunk and precision (TOL); then, reported and
   not gated, ``run(4096)`` at chunk 1024 against the tuned chunk, for the
   hand-set and the chosen family, in turns; a run after
   ``warm_start`` and after ``clear_executables`` must be bit-identical,
   the first chunk's device time after ``warm_start`` reported beside a
   steady chunk's; and a ``SamplingRun`` of the flagship model (8 chains x
   2 temps, 4 steps: the cut) must take the stored pipeline depth with
   ``tuned=True``, bit-identical to that depth given explicitly.
17. ``serve``: the serving layer on the card at the flagship's widths
   (``ArraySpec(npsr=100, ntoa=780, n_red=30, n_dm=100, gwb_ncomp=30)``,
   built by the warm pool on the port's default served path, ``fused``
   bf16, the default ladder 16 ... 1024). ``serve.run_loadgen`` of 64
   ``sim`` requests (sizes 4, 8, 16, 32) with the serial baseline and 3
   verified responses, then of 16 ``os`` requests with 2 verified: every
   request served, each verified response bit-identical to the request
   alone at its bucket and within the bf16 bound of its solo run, no
   steady kernel build (``serve_steady_compiles``), no failed, retried,
   evicted or cancelled dispatch; p50 / p99, qps per card, coalescing,
   pad waste, the serial rate and speedup and the warm-up seconds per
   bucket printed. A coalesced cohort of three detection requests with
   the null stream, each equal to itself alone and, with its curves, to
   the einsum path on the same lanes (bf16 bounds). A ``python -m
   fakepta_tpu_torch.serve replica --port 0`` subprocess: its banner, one
   line each of ``sim`` (equal to the same request in process), ``os``
   with the null stream, ``ping``, ``stats``, ``telemetry`` and
   ``metrics``, then ``python -m fakepta_tpu_torch.obs top HOST:PORT
   --iterations 1`` and ``obs alerts HOST:PORT`` (exit 0); the replica is
   stopped. ``obs gate`` on the loadgen's saved report against the
   committed ``BENCH_r*.json`` history: exit 0, the card's ``'gpu'`` row
   banding against none of the JAX rounds' rows. No kernel may be built
   in the phase. Then ``binned_correlation`` at bf16 on the served
   simulator's residuals at R = 16 and R = 1024 against its plain version
   and timed (plain, ``einsum("rpt,rqt,npq->rn")``, bound), and at any
   shape the served path launched that no earlier phase measured. Every
   served run passes the run guard (zero degradations); the launches of
   the load generator, the cohort and the in-process request are counted
   (zeroed just before each, read just after).
18. ``fleet``: the serve fleet at the serve phase's flagship widths
   (``SERVE_SPEC``, K = 320, the default ladder 16 ... 1024, ``fused``
   bf16). Two ``python -m fakepta_tpu_torch.serve replica`` subprocesses
   share ``cuda:0`` (with ``--mesh-cards N``, N replicas, one a card)
   behind the consistent-hash router (``SocketReplica``,
   ``ServeFleet``). ``run_fleet_loadgen`` over 4 specs (distinct
   ``data_seed``) serves 16 ``os`` (hd) requests, then 128 ``sim``
   requests (sizes 4, 8, 16, 32) beside the one-pool baseline with no
   kill, then the same 128 again, killing the first spec's owner at half
   the submissions: every request served (no lost request, no timeout,
   no failed dispatch, no steady build), the sampled and every
   failed-over response bit for bit the same request served alone at its
   bucket here, one replica death and at least one failover; each replica's
   ready seconds, memory and #1 launches by bucket (read over the
   protocol before and after each round, the killed replica's just
   before its kill) printed. ``run_elastic_loadgen`` with 3 socket
   replicas (2 specs, ladder 16 and 32): one wedged by a ``fleet.heartbeat``
   hang (the breaker must open), one killed, one joined by the
   autoscaler, which must start no nvcc and build nothing; nothing lost,
   no timeout. On two in-process replicas: a ``SamplingSession`` of the
   flagship's 30-bin free-spectrum CURN (4 chains, 4 warm-up and 8 post
   steps in segments of 4: the step counts are the cut) whose owner is
   killed at its third segment migrates once and ends, with its streamed
   segments, bit for bit the uninterrupted run (run on its owner beside
   the elastic round, whose fault plan arms no site it checks); three 8-TOA appends
   through the fleet land on one replica, their moments within 1e-10 of a
   direct ``StreamState``'s. No kernel is built in the phase (here or in
   a replica). Then ``binned_correlation`` at bf16 at every cohort shape
   the fleet launched (R = 16 ... 1024; NB = 17 for ``os``) that no
   earlier phase measured, against its plain version and timed.
19. ``gateway``: the gateway on the card at the flagship's widths
   (``registry.get("flagship_100").serve_spec()``, ``SERVE_SPEC``, the
   fleet ladder 16 and 32, ``fused`` bf16). ``run_gateway_loadgen`` with
   suite config 16's traffic (3 tenants, 96 requests of sizes 1, 2 and 4
   over 3 specs and 12 Zipf identities, seed 11, ``max_inflight`` 6) in
   front of two in-process replicas on ``cuda:0`` (with ``--mesh-cards
   N``, N replicas, one a card), a background appender feeding a
   gateway-opened stream that is cut over onto a 2x Tspan template at half
   the submissions: it must lose nothing, conserve the stream's TOAs and
   bit-verify every store hit against the request served alone; the row
   must read ``gw_hit_rate`` >= 0.5 and ``gw_device_s_saved``,
   ``gw_verified`` and ``gw_cutover_ms`` above 0, with #1's launches by
   bucket read from each pool. #1 is held against its plain version and
   timed at each cohort shape the round dispatched. A cold ``Gateway``
   with a new ``ResultStore`` over the round's directory then serves each
   identity once: every response a hit, bit for bit the request served
   alone, and no launch of #1 while it runs. Last, ``ng15``'s cadence tail
   (4 observing windows of ``append_schedule``, as ``as_append_requests``)
   through ``Gateway.serve``: the stream must hold every TOA. No kernel is
   built in the phase.
20. ``golden``: the golden-run harness
   (``fakepta_tpu_torch.scenarios.golden``) on ``cuda:0``. ``golden_run``
   on ``flagship_100``, ``ng15`` and ``ipta_dr3`` at full spec with suite
   config 17's knobs (``benchmarks/suite.py:700``: ``nreal=32``,
   ``chunk=16``, ``serve_requests=16``, ``max_append_blocks=8``, 48
   sampler steps after 24 warm-up steps on ``ng15``, 16 after 8 on the
   others: the step counts are the cut): every lane runs (the ensemble on
   the default ``fused`` bf16 path, the CURN free-spectrum sampler, the
   serve pool with a verified answer, bit for bit alone, and the cadence
   stream with its append-equals-restage oracle within 1e-7), each row is
   printed as one JSON line, must carry the JAX row's keys with
   ``platform`` 'gpu', an allocator peak, no recompile, no steady build and
   no fault, is saved with ``save_row`` and loaded and gated by the port's
   ``obs gate`` (no comparable history). Then ``memory_lane("ska_10k",
   chunk=32)`` over 1,000, 2,500, 5,000 and 10,000 pulsars uncut (one call
   a point, so each point's simulator serves its kernel row and is gone
   before the next), on ``cuda:0`` (``--mesh-cards N``: N cards, one psr
   shard each): each point's peak, chunk model, ratio, build seconds and
   host peak against the machine's RAM printed; it fails unless every
   point is within ``MEM_BOUND_FACTOR``; then the JAX default sweep's
   small points, 8 and 16 pulsars at ``chunk=8``, where the fixed term
   (the cuBLAS / cuBLASLt workspaces the run reports as
   ``static_reservation_bytes``) outweighs the chunk model: each point's
   raw peak, model and fixed term printed, and it fails unless ``peak /
   (model + static)`` is within the bound. The launches of #1 are counted
   (zeroed just before each run, read just after) and tallied by shape
   (R, PL, PF, T); #1 is held against its plain version and timed at every
   shared-set shape it was launched at: the ensemble lanes' R = 16 (PL =
   100, 68, 120), the serve lanes' cohorts and solo checks, and the memory
   lane's R = 32 up to PL = PF = 10,000 and R = 8 at PL = 8 and 16.
21. ``f64``: the float64 path on the card. The flagship
   (``registry.get("flagship_100").build(dtype=torch.float64)``: 100
   pulsars x 780 TOAs, K = 320, every stage) on its default path, which
   must be ``"einsum"``: ``run(4096, chunk=1024)`` after a one-chunk
   warm-up, timed in turns with the float32 einsum run at the same shape
   and chunk (f32, f64, f64, f32), finite float64 curves whose mean auto
   is within 5% of the float32 run's, and no kernel launched. Then the
   float64 flagship on the kernel paths, ``"fused"`` and ``"mega"`` at
   'f32' and 'bf16', ``run(2048, chunk=1024)`` each after a warm-up, in
   turns with the float64 einsum run (einsum, the four, the four
   reversed, einsum), each held to the einsum run's curves within 1e-6 of
   the scale ('f32') or 1e-2 ('bf16'), with the float64 kernel launches
   counted (zeroed just before each run, read just after): one
   ``binned_correlation_f64`` a chunk on fused, one ``chunk_stats_f64``
   (``fpt_project_f64`` then ``fpt_binned_corr_f64``) on mega, none on
   einsum; and one ``"mega"`` run at 'f32' on a psr-2 mesh on the card
   (#4's local+full set, ``chunk_stats_sharded_f64`` twice a chunk). Then
   ``"mega"`` at 'f32' with three OS lanes (hd, monopole, dipole) and the
   null stream, so pass 1 runs at K = 320 (NB = 19) and at the null
   stream's GWB-free K = 260 (NB = 4): ``chunk_stats_f64`` first held to
   its plain version and timed at both shapes on one chunk, then
   ``run(2048, chunk=1024, os=...)`` in turns with the float64 einsum run
   of the same lanes (einsum, mega, mega, einsum), the curves, autos and
   every amp2 lane within 1e-6 of their scale, the mega rerun
   bit-identical and ``chunk_stats_f64`` launched twice a chunk. The
   reduced flagship at float64 on the card against the same run on the CPU
   within 1e-12 of the curve scale (the CPU tests' float64 bound),
   correlations too.
   Then the facade at float64: BASELINE config 2's ``add_noise_array``
   (10 pulsars) in injections/s in turns with its float32 twin, and a
   ``make_fake_array(npsrs=100, ntoas=780, gaps=True, dtype=
   torch.float64)`` with the correlated HD background
   (``add_common_correlated_noise``) timed beside the float32 array and
   held against the same seeds on the CPU within 1e-12 of each pulsar's
   residual scale.
22. ``profile`` (only when asked for): per statistic path, the device time
   of one flagship chunk split into key derivation, draws + residual
   assembly and the statistic, plus torch.profiler's busiest kernels; then
   one 4-shard einsum chunk's host enqueue time against each card's busy
   time (over ``--mesh-cards`` cards).

The last lines are the kernel table as JSON (one entry per kernel and
shape the main path launched it at), the card line, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
Details go to ``build/chip_smoke.json`` too.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense)
PEAK_HBM_BPS = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP64_TC_FLOPS = 67e12

NREAL = 4096
CHUNK = 1024
TOL = {"f32": 1e-5, "bf16": 1e-2}
# the detection lane: amp2 and null amp2 within this share of max|amp2| of
# the einsum run (the JAX package's bound, tests/test_detect.py), three ORF
# templates with the paired null stream
OS_TOL = {"f32": 1e-4, "bf16": 1e-2}
DETECT_ORFS = ("hd", "monopole", "dipole")
# the toa rows: the JAX package's toa-sharding bound
TOA_RTOL = 5e-5
# the mesh phase: psr shard counts on one card, a shorter run, and the JAX
# package's own mesh-invariance bounds
MESH_SHARDS = (2, 4)
MESH_NREAL = 2048
MESH_TOL = {"f32": 1e-5, "bf16": 5e-3}
# a psr shard's rows in the kernel rows (100 pulsars over 4 and 2 shards)
SHARD_PL = (25, 50)
# the run phase: realizations per run, pipeline depths, a 1024-slot lane
# cohort
RUN_NREAL = 4096
RUN_DEPTHS = (0, 1, 2, 3)
RUN_LANES = ((11, 300), (22, 500), (33, 224))
# the most a live large-pool block of the caching allocator can exceed its
# request by, with room: a reused block is split only when more than 1 MiB
# would be left over, so a peak may read up to that much high per block
ALLOCATOR_GRANULE = 2 << 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict, iters: int) -> dict:
    """Time each variant twice in the order a, b, b, a (one card, one call)
    and return each variant's mean of the two."""
    order = list(fns) + list(fns)[::-1]
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(time_ms(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in got.items()}


def bound(bytes_moved: float, fp32_flops: float, bf16_flops: float,
          tf32_flops: float = 0.0, fp64_flops: float = 0.0):
    """(bound ms, 'bytes' | 'operations'): the larger of the byte time and
    the operation time at the card's published peaks (float64 operations
    at the FP64 tensor cores' rate, the fastest the card runs them)."""
    t_bytes = bytes_moved / PEAK_HBM_BPS
    t_ops = (fp32_flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
             + tf32_flops / PEAK_TF32_FLOPS
             + fp64_flops / PEAK_FP64_TC_FLOPS)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def stat_flops(R: int, PL: int, PF: int, T: int, NB: int, shared: bool):
    """(correlation FLOPs, binning FLOPs) that the statistic needs. With one
    operand set (res_local is res_full) each (P, P) block is symmetric, so
    only its P(P+1)/2 distinct pairs are needed: the binning folds
    w + w^T onto them, one multiply-add per pair and slot."""
    pairs = PL * (PL + 1) / 2 if shared else PL * PF
    return 2.0 * R * pairs * T, 2.0 * R * NB * pairs


def compare(got, want, prec: str, what: str, tol=None, rtol=None,
            ntoa: int = 128) -> dict:
    """Max abs/rel error of (curves, autos) against a reference; raises
    past the tolerance (``tol``, default TOL[prec], times max |reference
    curve| for the curves, relative for the autos). ``rtol`` instead holds
    each curve value within ``rtol`` of its reference plus 1e-7 of the
    scale per 128 of the ``ntoa`` TOA slots summed, and the autos within
    ``rtol``: the JAX package's toa-sharding bound (rtol 5e-5, 1e-7 of the
    scale at its test's 128 TOAs), its absolute term grown with the sum
    whose float32 rounding it bounds."""
    import torch
    gc, ga = (torch.as_tensor(x).double().cpu() for x in got)
    wc, wa = (torch.as_tensor(x).double().cpu() for x in want)
    if gc.shape != wc.shape or ga.shape != wa.shape:
        raise AssertionError(f"{what}: shape {tuple(gc.shape)} != "
                             f"{tuple(wc.shape)}")
    if not (torch.isfinite(gc).all() and torch.isfinite(ga).all()):
        raise AssertionError(f"{what}: non-finite output")
    scale = float(wc.abs().max())
    err_c = float((gc - wc).abs().max())
    err_a = float((ga - wa).abs().max())
    # an auto slot of zero weights (the null stream's) must come out zero
    rel_a = float(((ga - wa).abs() / wa.abs().clamp_min(1e-300)).max())
    tol = TOL[prec] if tol is None else tol
    atol = 1e-7 * max(ntoa / 128, 1.0)
    row = {"what": what, "precision": prec, "max_abs_err": max(err_c, err_a),
           "curves_err_over_scale": err_c / scale, "autos_rel_err": rel_a,
           "tolerance": tol if rtol is None
           else f"rtol {rtol} + {atol:.3g} of scale"}
    print(f"  {what} [{prec}]: curves max|d|/scale {err_c / scale:.3e}, "
          f"autos max rel {rel_a:.3e} (tolerance {row['tolerance']})",
          flush=True)
    if rtol is None:
        bad = err_c > tol * scale or rel_a > tol
    else:
        bad = bool(((gc - wc).abs() > rtol * wc.abs() + atol * scale).any()
                   or rel_a > rtol)
    if bad:
        raise AssertionError(f"{what} [{prec}] outside tolerance: {row}")
    return row


def os_compare(got: dict, want: dict, prec: str, what: str,
               tol=None) -> dict:
    """Each ORF's amp2 (and null amp2 where the run has the null stream)
    against the reference run's within ``tol`` (default OS_TOL[prec], the
    JAX package's bound for the fused OS lanes) of its max|amp2|; raises
    past it."""
    errs = {}
    for orf in got["os"]["orfs"]:
        g, w = got["os"]["stats"][orf], want["os"]["stats"][orf]
        scale = float(np.abs(w["amp2"]).max())
        for k in ("amp2", "null_amp2"):
            if k not in g:
                continue
            if not np.isfinite(g[k]).all() or g[k].shape != w[k].shape:
                raise AssertionError(f"{what} {orf}/{k}: shape "
                                     f"{g[k].shape} or non-finite values")
            errs[f"{orf}/{k}"] = float(np.abs(g[k] - w[k]).max()) / scale
    worst = max(errs.values())
    tol = OS_TOL[prec] if tol is None else tol
    print(f"  {what} [{prec}]: OS lanes max|d|/max|amp2| {worst:.3e} "
          f"(tolerance {tol:g})", flush=True)
    if worst > tol:
        raise AssertionError(f"{what} [{prec}] OS lanes outside tolerance: "
                             f"{errs}")
    return {"os_err_over_scale": errs, "os_tolerance": tol}


def flagship_sim(stat_path: str, mesh=None, batch=None, **kw):
    """The registry's ``flagship_100`` (its batch and HD background) on
    ``mesh`` (default: a 1x1 mesh on the card); ``kw`` adds engine
    arguments, ``batch`` replaces the registry's batch."""
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    from fakepta_tpu_torch.scenarios import registry
    scn = registry.get("flagship_100")
    parts = scn.batch_parts(device="cuda")
    if mesh is None:
        kw["device"] = "cuda"
    kw = dict(scn.sim_kwargs(*parts), **kw)
    return EnsembleSimulator(parts[0] if batch is None else batch,
                             stat_path=stat_path, mesh=mesh, **kw)


def small_gwb(batch):
    """An HD background on a small test array's grid (4 bins)."""
    from fakepta_tpu_torch import spectrum as spectrum_lib
    from fakepta_tpu_torch.parallel.montecarlo import GWBConfig
    f = np.arange(1, 5) / float(batch.tspan_common)
    return GWBConfig(psd=spectrum_lib.powerlaw(f, log10_A=-13.5,
                                               gamma=13 / 3).numpy())


def counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    return {"binned_correlation": bc.launches,
            "binned_correlation_vpu": bc.vpu_launches,
            "chunk_stats": mk.launches,
            "chunk_stats_sharded": mk.sharded_launches,
            "binned_correlation_f64": bc.f64_launches,
            "chunk_stats_f64": mk.f64_launches,
            "chunk_stats_sharded_f64": mk.f64_sharded_launches}


def shape_tag(pl: int, pf: int, t: int, nb=None, k=None) -> str:
    """A kernel launch's shape: rows, columns and TOAs, and where it is not
    the plain run's (16 weight slots, the array's own K), its weight slots
    ``nb`` and, for chunk_stats, its GP columns ``k``."""
    tag = f"PL={pl} PF={pf} T={t}"
    if nb is not None:
        tag += f" NB={nb}"
    if k is not None:
        tag += f" K={k}"
    return tag


def lane_shapes(sim, path: str, shards: int, n_os: int) -> tuple:
    """(the main launch's shape, the null stream's) of a run with ``n_os``
    OS lanes on ``sim`` over ``shards`` psr shards: NB = nbins + n_os + 1
    and n_os + 1; on the mega path K of the full and the GWB-free stage
    sets."""
    from fakepta_tpu_torch.ops import megakernel as mk
    npsr, t = sim.batch.npsr, sim.batch.max_toa
    k = (mk.stage_k(sim._mega_tables[0]), mk.stage_k(sim._mega_stages_null)
         ) if path == "mega" else (None, None)
    return (shape_tag(npsr // shards, npsr, t, sim.nbins + n_os + 1, k[0]),
            shape_tag(npsr // shards, npsr, t, n_os + 1, k[1]))


def add_launches(report: dict, shape: str, moved: dict) -> None:
    """Add main-path launch counts ``{kernel: n}`` made at ``shape`` to
    ``report["launches_by_shape"][kernel][shape]``."""
    by = report.setdefault("launches_by_shape", {})
    for name, n in moved.items():
        if n:
            by.setdefault(name, {})
            by[name][shape] = by[name].get(shape, 0) + n


def reset_counts() -> None:
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    bc.launches = bc.vpu_launches = bc.f64_launches = 0
    mk.launches = mk.sharded_launches = 0
    mk.f64_launches = mk.f64_sharded_launches = 0


def sass_counts(path, opcodes=("HMMA", "DMMA")) -> dict:
    """{opcode: {kernel: number of its instructions}} in a built library's
    SASS (``cuobjdump -sass``, from the toolkit beside nvcc, read once)."""
    from fakepta_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    got, fn = {op: {} for op in opcodes}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            for op in opcodes:
                got[op][fn] = 0
        elif fn is not None:
            for op in opcodes:
                if op in line:
                    got[op][fn] += 1
    return got


def phase_build(report: dict) -> None:
    from fakepta_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {len(logs)} sources compiled in "
          f"{report['build_s']:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"  {name}: {line.strip()}")
    report["hmma"], sass = {}, {}
    for name in _build.KERNELS:
        _build.load(name)
        sass[name] = sass_counts(_build.library_path(name))
        report["hmma"][name] = counts = sass[name]["HMMA"]
        for fn, n in counts.items():
            print(f"  {name}: {n:5d} HMMA in {fn}")
    for name, lib, kernel in (
            ("binned_correlation", "binned_corr", "mma_corr_kernel"),
            ("binned_correlation_vpu", "binned_corr", "vpu_corr_kernel"),
            ("chunk_stats", "megakernel", "project_kernel")):
        mma = {fn: n for fn, n in report["hmma"][lib].items()
               if kernel in fn}
        if not mma or min(mma.values()) == 0:
            raise AssertionError(f"{name}'s kernels run no tensor-core "
                                 f"instruction: {mma}")
    report["dmma"] = {}
    for name, lib, kernel in (
            ("binned_correlation_f64", "binned_corr", "corr_f64_kernel"),
            ("chunk_stats_f64", "megakernel", "project_f64_kernel")):
        dmma = {fn: n for fn, n in sass[lib]["DMMA"].items()
                if kernel in fn}
        report["dmma"][name] = dmma
        for fn, n in dmma.items():
            print(f"  {lib}: {n:5d} DMMA in {fn}")
        if not dmma or min(dmma.values()) == 0:
            raise AssertionError(f"{name}'s kernels run no FP64 "
                                 f"tensor-core instruction: {dmma}")


def kernel_rows(rows: dict, name: str, tag: str, kernel, plain, library,
                nbytes, flops, iters: int, precs=("bf16", "f32"),
                tol=None) -> None:
    """Hold ``kernel(prec)`` against ``plain(prec)`` at each precision and
    time kernel, plain version and ``library`` (one PyTorch call, or None)
    beside the bound from ``nbytes(prec)`` and ``flops(prec)`` ((fp32,
    bf16[, tf32[, fp64]]) FLOPs, each at that type's peak). ``tol``: the
    bound per precision (default TOL). Rows go to
    ``rows[(name, prec, tag)]``."""
    import torch
    kernel_ms = in_turns({p: (lambda p=p: kernel(p)) for p in precs}, iters)
    plain_ms = in_turns({p: (lambda p=p: plain(p)) for p in precs},
                        max(5, iters // 2))
    library_ms = time_ms(library, 10) if library is not None else None
    for prec in precs:
        got = kernel(prec)
        want = plain(prec)
        torch.cuda.synchronize()
        row = compare(got, want, prec, f"{name} {tag} vs plain",
                      tol=None if tol is None else tol[prec])
        row.update(ms=kernel_ms[prec], plain_ms=plain_ms[prec],
                   library_ms=library_ms, shape=tag)
        row["bound_ms"], row["bound_by"] = bound(nbytes(prec),
                                                 *flops(prec))
        rows[(name, prec, tag)] = row
        lib = ("" if library_ms is None
               else f", library {library_ms:.4f} ms")
        print(f"  {name} {tag} [{prec}]: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms{lib}, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']})", flush=True)


def mega_route_flops(prec: str, corr: float, other: float, proj: float):
    """(fp32, bf16, tf32) FLOPs that chunk_stats' work needs: the
    projection's ``proj`` FLOPs on the TF32 tensor cores, three times over
    at 'f32' (3xTF32) and twice under bf16 storage (the coefficients are
    exact in TF32, so their lo part is 0), then :func:`corr_flops_split`
    for the rest."""
    fp32, bf16, tf32 = corr_flops_split(prec, corr, other)
    return fp32, bf16, tf32 + (3 if prec == "f32" else 2) * proj


def corr_flops_split(prec: str, corr: float, other: float):
    """(fp32, bf16, tf32) FLOPs of a correlation and its binning: the
    correlation on the tensor cores, at 'f32' three times over at the TF32
    rate (3xTF32), in the bf16 mode, whose operands are bf16, once at the
    bf16 rate; the binning at fp32."""
    return (other, 0.0, 3 * corr) if prec == "f32" else (other, corr, 0.0)


def mma_details(rows: dict, res_l, res_f, w, nbins: int, tag: str) -> None:
    """binned_correlation's tiling at this shape, and the 'f32' mode's
    3xTF32 arithmetic, emulated in plain torch on 16 realizations, against
    float64."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    tiling = bc.mma_tiling(res_l.shape[1], res_f.shape[1])
    print(f"  binned_correlation {tag}: tiling {tiling}", flush=True)
    a, b = res_l[:16], res_f[:16]
    f64 = torch.einsum("rpt,rqt,npq->rn", a.double(), b.double(), w.double())
    emu = compare(bc.binned_correlation_3xtf32(a, b, w, nbins),
                  (f64[:, :nbins], f64[:, nbins]), "f32",
                  f"3xTF32 emulation {tag} vs float64")
    for p in ("bf16", "f32"):
        rows[("binned_correlation", p, tag)].update(
            tiling=tiling._asdict(), emulation_vs_f64=emu)


def vpu_details(rows: dict, pl: int, pf: int, nb: int, tag: str) -> None:
    """binned_correlation_vpu's tiling and realizations per block at this
    shape, per precision."""
    from fakepta_tpu_torch.ops import binned_corr as bc
    for p in ("bf16", "f32"):
        t = bc.vpu_tiling(pl, pf, nb, p, shared=pl == pf)
        print(f"  binned_correlation_vpu {tag} [{p}]: tiling {t.mma}, "
              f"rb {t.rb}, ldc {t.ldc}, {t.smem} B shared memory",
              flush=True)
        rows[("binned_correlation_vpu", p, tag)].update(
            tiling=t.mma._asdict(), rb=t.rb, smem=t.smem)


def mega_details(rows: dict, name: str, tag: str, operands: dict,
                 times, scales, w_l, kw: dict, stages, nbins: int,
                 proj_rows: int) -> None:
    """chunk_stats' two passes at this shape, timed alone in turns at both
    precisions (pass 1: the projection, ``megakernel._launch_project``;
    pass 2: ``binned_correlation``'s kernel on its residuals), and pass 1's
    library time: one ``torch.einsum`` of the projection against a
    prebuilt dense basis over the pass's ``proj_rows`` rows (a psr shard's
    local rows, then the full set), at full fp32 for 'f32' and on bf16
    operands for 'bf16' (the basis build not timed; chunk_stats never
    calls it); raises unless a rerun of the whole function is
    bit-identical."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    t = mk.project_tiling(operands["f32"][0].shape[0], times.shape[2],
                          proj_rows, scales.shape[0])
    print(f"  {name} {tag}: projection tiling {t}", flush=True)
    local = {p: tuple(kw[p].values()) or (None,) * 4 for p in operands}
    res = {p: mk._launch_project(*operands[p], times, scales, stages,
                                 local[p]) for p in operands}
    fns = {}
    for p in operands:
        fns[("pass1", p)] = (lambda p=p: mk._launch_project(
            *operands[p], times, scales, stages, local[p]))
        fns[("pass2", p)] = (lambda p=p: bc.binned_correlation(
            res[p][0], res[p][1], w_l, nbins, precision=p))
    ms = in_turns(fns, 10)
    basis = mk.dense_basis(times, scales, stages)
    coef = operands["f32"][1]
    # pass 1's library call at the row's own shape: the rows the pass
    # projects (the local rows, then the full set, on a psr shard)
    pl = proj_rows - coef.shape[1] if proj_rows > coef.shape[1] else 0
    lib_coef = (torch.cat([coef[:, :pl], coef], 1) if pl else coef)
    lib_basis = (torch.cat([basis[:pl], basis], 0) if pl else basis)
    lib_ops = {"f32": (lib_coef.contiguous(), lib_basis.contiguous()),
               "bf16": (lib_coef.to(torch.bfloat16),
                        lib_basis.to(torch.bfloat16))}

    def library(p):
        a, b = lib_ops[p]
        if p == "f32":
            with mk.full_f32():
                return torch.einsum("rpk,ptk->rpt", a, b)
        return torch.einsum("rpk,ptk->rpt", a, b)

    lib_ms = in_turns({p: (lambda p=p: library(p)) for p in operands}, 10)
    for p in operands:
        runs = [mk.chunk_stats(*operands[p], times, scales, w_l,
                               stages=stages, nbins=nbins, precision=p,
                               **kw[p]) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"{name} {tag} [{p}] rerun is not "
                                 f"bit-identical")
        row = rows[(name, p, tag)]
        row.update(pass1_ms=ms[("pass1", p)], pass2_ms=ms[("pass2", p)],
                   pass1_library_ms=lib_ms[p],
                   projection_tiling=t._asdict(), rerun_identical=True)
        print(f"  {name} {tag} [{p}]: pass 1 {row['pass1_ms']:.4f} ms, "
              f"pass 2 {row['pass2_ms']:.4f} ms, whole {row['ms']:.4f} ms; "
              f"pass-1 library (einsum rpk,ptk->rpt at {proj_rows} rows, "
              f"prebuilt basis, {p}) {lib_ms[p]:.4f} ms", flush=True)


def phase_kernels(report: dict) -> None:
    """Every kernel at the flagship's shapes (the shared set, and a 2- and
    4-shard mesh's rows), then the float64 kernels on the float64
    flagship's."""
    measure_kernels(report, flagship_sim("fused"), SHARD_PL, "kernels")
    measure_f64_kernels(report)


#: the float64 kernels' bounds against their plain versions: float64
#: outputs at the CPU tests' float64 bound, the fused kernel's float32 ones
#: at 'f32' (pair sums and slots each rounded once to float32) and 'bf16'
#: (float32 sums of the same bf16 products in another order); chunk_stats'
#: bf16 storage at TOL's
F64_KERNEL_TOL = {"binned_correlation_f64": {"f32": 1e-6, "bf16": 1e-5},
                  "chunk_stats_f64": {"f32": 1e-12, "bf16": TOL["bf16"]}}
#: a psr shard's rows in the float64 rows (the f64 phase's 2-shard mesh)
F64_SHARD_PL = 50


def rerun_identical(fn, what: str) -> bool:
    """Raise unless two calls of ``fn`` return bit-identical tensors."""
    import torch
    a, b = fn(), fn()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what} rerun is not bit-identical")
    return True


def f64_chunk_rows(rows: dict, base, coefs, times, scales, w, stages,
                   nbins: int, pls, tag, precs=("f32", "bf16")) -> None:
    """chunk_stats at float64 held to its plain version and timed (rows
    ``rows[(name, prec, tag(pl))]``) on the shared set (pl = P) and a psr
    shard's first pl rows, with pass 1 alone beside its float64 einsum and
    its bound, and a rerun bit-identical. 'f32' stores base and coef at
    float64, 'bf16' in bfloat16 (as the engine does); the tables and
    weights float64."""
    import torch
    from fakepta_tpu_torch.ops import megakernel as mk
    R, P, T = base.shape
    NB, K, S = w.shape[0], mk.stage_k(stages), scales.shape[0]
    operands = {"f32": (base, coefs),
                "bf16": (base.to(torch.bfloat16), coefs.to(torch.bfloat16))}
    operands = {p: operands[p] for p in precs}
    basis = mk.dense_basis(times, scales, stages)

    def local(x, pl):
        return x[:, :pl].contiguous()

    for pl in pls:
        shared = pl == P
        name = "chunk_stats_f64" if shared else "chunk_stats_sharded_f64"
        kw = {p: {} if shared else dict(
            base_local=local(operands[p][0], pl),
            coef_local=local(operands[p][1], pl),
            times_local=local(times, pl), scales_local=local(scales, pl))
            for p in operands}
        w_l = w if shared else local(w, pl)
        rows_read = pl if shared else pl + P
        corr, binf = stat_flops(R, pl, P, T, NB, shared=shared)
        proj = 2.0 * R * rows_read * K * T
        kernel_rows(
            rows, name, tag(pl),
            lambda p, kw=kw, ww=w_l: mk.chunk_stats(
                *operands[p], times, scales, ww, stages=stages, nbins=nbins,
                precision=p, **kw[p]),
            lambda p, kw=kw, ww=w_l: mk.chunk_stats_plain(
                *operands[p], times, scales, ww, stages=stages, nbins=nbins,
                precision=p, **kw[p]),
            None,
            lambda p, n=rows_read, pl=pl: (
                (8 if p == "f32" else 2) * R * n * (T + K)
                + 8.0 * ((2 + S) * n * T + NB * pl * P)
                + (8 if p == "f32" else 4) * R * NB),
            lambda p, c=corr, b=binf, j=proj: (
                (0.0, 0.0, 0.0, j + c + b) if p == "f32"
                else mega_route_flops(p, c, b, j)),
            iters=10, precs=tuple(operands), tol=F64_KERNEL_TOL[
                "chunk_stats_f64"])
        local_ops = {p: tuple(kw[p].values()) or (None,) * 4
                     for p in operands}
        lib_coef = torch.cat([coefs[:, :pl], coefs], 1) if not shared \
            else coefs
        lib_basis = torch.cat([basis[:pl], basis], 0) if not shared \
            else basis
        ms = in_turns({p: (lambda p=p: mk._launch_project(
            *operands[p], times, scales, stages, local_ops[p]))
            for p in operands}, 10)
        lib_ms = time_ms(lambda: torch.einsum("rpk,ptk->rpt", lib_coef,
                                              lib_basis), 10)
        for p in operands:
            row = rows[(name, p, tag(pl))]
            # pass 1's own bound: base and coef read, the residuals written
            # (float64, or float32 under bf16 storage) and the tables read,
            # against its products on the FP64 tensor cores (the TF32 ones,
            # two products, under bf16 storage)
            p1_bytes = ((8 if p == "f32" else 2) * R * rows_read * (T + K)
                        + (8 if p == "f32" else 4) * R * rows_read * T
                        + 8.0 * (2 + S) * rows_read * T)
            p1_flops = ((0.0, 0.0, 0.0, proj) if p == "f32"
                        else (0.0, 0.0, 2 * proj))
            p1_bound, p1_by = bound(p1_bytes, *p1_flops)
            row.update(pass1_ms=ms[p], pass1_library_ms=lib_ms,
                       pass1_bound_ms=p1_bound, pass1_bound_by=p1_by,
                       rerun_identical=rerun_identical(
                           lambda p=p, kw=kw, ww=w_l: mk.chunk_stats(
                               *operands[p], times, scales, ww,
                               stages=stages, nbins=nbins, precision=p,
                               **kw[p]), f"{name} [{p}]"))
            print(f"  {name} {tag(pl)} [{p}]: pass 1 {ms[p]:.4f} ms of "
                  f"{row['ms']:.4f} ms, its bound {p1_bound:.4f} ms "
                  f"({p1_by}); pass-1 library (einsum rpk,ptk->rpt at "
                  f"float64, {rows_read} rows, prebuilt basis) "
                  f"{lib_ms:.4f} ms", flush=True)


def measure_f64_kernels(report: dict) -> None:
    """The float64 kernels held against their plain versions and timed on
    one chunk of the float64 flagship's own residuals (module docstring,
    phase 2): binned_correlation_f64 on the shared set and a 2-shard
    mesh's rows, chunk_stats_f64 on the shared set and
    chunk_stats_sharded_f64 on the shard's local+full set. The launches
    made here are not counted."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.scenarios import registry
    from fakepta_tpu_torch.utils import rng

    sim = registry.get("flagship_100").build(device="cuda",
                                              dtype=torch.float64)
    keys = _chunk_keys(rng.key(7, device="cuda"), 0, CHUNK)
    with torch.no_grad():
        res = sim._residuals(keys)
        base, coefs = sim._residuals(keys, split_gp=True)
    torch.cuda.synchronize()
    w = sim._stat_weights
    stages, times, scales = sim._mega_tables
    nbins = sim.nbins
    R, P, T = res.shape
    NB, K = w.shape[0], mk.stage_k(stages)
    print(f"kernels f64: R={R} P={P} T={T} K={K} NB={NB}", flush=True)
    rows = {}

    def local(x, pl):
        return x[:, :pl].contiguous()

    name = "binned_correlation_f64"
    for pl in (P, F64_SHARD_PL):
        shared = pl == P
        res_l, w_l = (res, w) if shared else (local(res, pl), local(w, pl))
        corr, binf = stat_flops(R, pl, P, T, NB, shared=shared)
        nbytes = (8.0 * (R * (pl if shared else pl + P) * T + NB * pl * P)
                  + 4.0 * R * NB)
        kernel_rows(
            rows, name, shape_tag(pl, P, T),
            lambda p, a=res_l, ww=w_l: bc.binned_correlation(
                a, res, ww, nbins, precision=p),
            lambda p, a=res_l, ww=w_l: bc.binned_correlation_plain(
                a, res, ww, nbins, precision=p),
            lambda a=res_l, ww=w_l: torch.einsum("rpt,rqt,npq->rn", a, res,
                                                 ww),
            lambda p, n=nbytes: n,
            lambda p, c=corr, b=binf: ((0.0, 0.0, 0.0, c + b) if p == "f32"
                                       else (0.0, c, 0.0, b)),
            iters=20, tol=F64_KERNEL_TOL[name])
        for p in ("f32", "bf16"):
            rows[(name, p, shape_tag(pl, P, T))]["rerun_identical"] = \
                rerun_identical(lambda a=res_l, ww=w_l, p=p:
                                bc.binned_correlation(a, res, ww, nbins,
                                                      precision=p),
                                f"{name} PL={pl} [{p}]")

    f64_chunk_rows(rows, base, coefs, times, scales, w, stages, nbins,
                   (P, F64_SHARD_PL), lambda pl: shape_tag(pl, P, T))
    report.setdefault("kernels", {}).update(
        {"/".join(k): v for k, v in rows.items()})
    # launches made to compare with the plain versions do not count
    reset_counts()


def measure_kernels(report: dict, sim, shard_pls, what: str, spec=None,
                    null: bool = False) -> None:
    """Hold each kernel against its plain version and time it, on one
    chunk of ``sim``'s own residuals: the shared operand set, and a psr
    shard's first PL rows for each PL in ``shard_pls``. Rows go to
    ``report["kernels"]``; the launches made here are not counted. With
    ``spec`` (an OSSpec) the weights are its OS lane's: the main launch's
    (bins, OS slots, auto), or with ``null`` the null stream's (OS slots
    and a zero auto) on the 0xD7 stream's own residuals and, for
    chunk_stats, its GWB-free stage set; the shape tags then carry NB and
    K."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _NULL_TAG, _chunk_keys
    from fakepta_tpu_torch.utils import rng

    keys = _chunk_keys(rng.key(7, device="cuda"), 0, CHUNK)
    if null:
        keys = rng.fold_in(keys, _NULL_TAG)
    with torch.no_grad():
        res = sim._residuals(keys, null=null)
        base, coefs = sim._residuals(keys, split_gp=True, null=null)
    torch.cuda.synchronize()
    w = sim._stat_weights
    stages, times, scales = sim._mega_tables
    if spec is not None:
        main, w_null = sim._prepare_lanes(spec).weights[id(sim._full)]
        w = w_null if null else main
        stages = sim._mega_stages_null if null else stages
    nbins = w.shape[0] - 1
    R, P, T = res.shape
    NB = w.shape[0]
    K = mk.stage_k(stages)
    S = scales.shape[0]

    def tag(pl, mega=False):
        """This measurement's shape tag at pl rows."""
        if spec is None:
            return shape_tag(pl, P, T)
        return shape_tag(pl, P, T, NB, K if mega else None)

    valid = float(sim.batch.mask.float().mean())
    print(f"{what}: R={R} P={P} T={T} K={K} NB={NB}, {valid:.4f} of the "
          f"TOA slots valid", flush=True)
    rows = {}

    def local(x, pl):
        """A psr shard's first pl rows, as a tensor of their own."""
        return x[:, :pl].contiguous()

    # -- binned_correlation (#1) and its mxu_binning=False variant (#2) --
    # shared: the single-device path's one operand set (symmetric block);
    # PL < PF: a psr shard's rows against the gathered array, at each shard
    # width the mesh phase launches; both multiply on the TF32 tensor cores
    for name, fn in (("binned_correlation", bc.binned_correlation),
                     ("binned_correlation_vpu", bc.binned_correlation_vpu)):
        for pl in (P,) + tuple(shard_pls):
            shared = pl == P
            res_l, w_l = (res, w) if shared else (local(res, pl),
                                                  local(w, pl))
            corr, binf = stat_flops(R, pl, P, T, NB, shared=shared)
            nbytes = 4.0 * (R * (pl if shared else pl + P) * T
                            + NB * pl * P + R * NB)
            kernel_rows(
                rows, name, tag(pl),
                lambda p, fn=fn, a=res_l, ww=w_l: fn(a, res, ww, nbins,
                                                     precision=p),
                lambda p, a=res_l, ww=w_l: bc.binned_correlation_plain(
                    a, res, ww, nbins, precision=p),
                lambda a=res_l, ww=w_l: torch.einsum("rpt,rqt,npq->rn", a,
                                                     res, ww),
                lambda p, n=nbytes: n,
                lambda p, c=corr, b=binf: corr_flops_split(p, c, b),
                iters=20)
            if name == "binned_correlation":
                mma_details(rows, res_l, res, w_l, nbins, tag(pl))
            else:
                vpu_details(rows, pl, P, NB, tag(pl))

    # -- chunk_stats: shared set (#3), local+full set (#4) ----------------
    # two passes: the projection (3xTF32 tensor-core products, two passes
    # under bf16 storage), then binned_correlation's kernel; the bytes
    # are the function's own, inputs once and output once (the residuals'
    # round trip between the passes is the design's, not the work's).
    # The bf16 mode stores base and coefficients in bfloat16, as the engine
    operands = {"f32": (base, coefs),
                "bf16": (base.to(torch.bfloat16), coefs.to(torch.bfloat16))}
    for pl in (P,) + tuple(shard_pls):
        shared = pl == P
        name = "chunk_stats" if shared else "chunk_stats_sharded"
        if shared:
            kw = {p: {} for p in operands}
            w_l = w
        else:
            kw = {p: dict(base_local=local(operands[p][0], pl),
                          coef_local=local(operands[p][1], pl),
                          times_local=local(times, pl),
                          scales_local=local(scales, pl))
                  for p in operands}
            w_l = local(w, pl)
        rows_read = pl if shared else pl + P
        corr, binf = stat_flops(R, pl, P, T, NB, shared=shared)
        proj = 2.0 * R * rows_read * K * T
        kernel_rows(
            rows, name, tag(pl, mega=True),
            lambda p, kw=kw, ww=w_l: mk.chunk_stats(
                *operands[p], times, scales, ww, stages=stages, nbins=nbins,
                precision=p, **kw[p]),
            lambda p, kw=kw, ww=w_l: mk.chunk_stats_plain(
                *operands[p], times, scales, ww, stages=stages, nbins=nbins,
                precision=p, **kw[p]),
            None,
            lambda p, n=rows_read, pl=pl: (
                (4 if p == "f32" else 2) * R * n * (T + K)
                + 4.0 * ((2 + S) * n * T + NB * pl * P + R * NB)),
            lambda p, c=corr, b=binf, j=proj: mega_route_flops(p, c, b, j),
            iters=10, precs=("f32", "bf16"))
        mega_details(rows, name, tag(pl, mega=True), operands, times,
                     scales, w_l, kw, stages, nbins, rows_read)
    report.setdefault("kernels", {}).update(
        {"/".join(k): dict(v, valid_toa_share=valid)
         for k, v in rows.items()})
    # launches made to compare with the plain versions do not count
    reset_counts()


#: the kernel each engine path launches on one shard, and on a psr-sharded
#: mesh
PATH_KERNEL = {"fused": "binned_correlation",
               "fused-vpu": "binned_correlation_vpu", "mega": "chunk_stats"}
SHARDED_KERNEL = dict(PATH_KERNEL, mega="chunk_stats_sharded")


def timed_run(sim, nreal: int, precision: str, seed: int = 1, **run_kw):
    """(output, wall seconds) of one ``run(nreal, chunk=CHUNK)``, between
    two synchronizations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.run(nreal, seed=seed, chunk=CHUNK, precision=precision,
                  **run_kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def yardstick(label: str, sim, nreal: int = NREAL, seed: int = 1,
              **run_kw) -> tuple:
    """The einsum path's f32 run after a one-chunk warm-up: the reference
    every kernel path is held to, and its realizations/s."""
    sim.run(CHUNK, seed=99, chunk=CHUNK, **run_kw)
    out, dt = timed_run(sim, nreal, "f32", seed, **run_kw)
    row = {"realizations_per_s": nreal / dt, "wall_s": dt}
    print(f"{label}: einsum [f32] {nreal / dt:.1f} realizations/s "
          f"({dt:.3f} s for {nreal})", flush=True)
    return out, row


def drive_paths(report: dict, label: str, sims: dict, ref, shape: str,
                nreal: int = NREAL, seed: int = 1, tol=None, shards: int = 1,
                warm: bool = True, precs=("f32", "bf16"), os=None,
                rtol=None) -> dict:
    """The main path: each ``sims[path]`` at each precision, with every
    kernel count zeroed just before and read just after. Each run (after a
    one-chunk warm-up when ``warm``) is timed, rerun and held to ``ref``
    (default tolerance TOL[prec]; ``rtol``: :func:`compare`'s elementwise
    bound); the rerun must be bit-identical and the path's kernel launched
    ``shards`` times per chunk. Adds the launches to ``report`` at
    ``shape`` and returns one row per path and precision.

    ``os``: every run carries that OS lane (an ORF name or an OSSpec), its
    amp2 lanes are held to ``ref``'s (:func:`os_compare`), and with the
    null stream the kernel launches twice per chunk, at the two shapes of
    :func:`lane_shapes` (``shape`` is then only the einsum rows' label)."""
    from fakepta_tpu_torch.detect import as_spec
    spec = None if os is None else as_spec(os)
    run_kw = {} if os is None else {"os": os}
    per_chunk = 2 if spec is not None and spec.null else 1
    nchunks = -(-nreal // CHUNK)
    reset_counts()
    runs = {}
    for path, sim in sims.items():
        for prec in precs:
            before = counts()
            if warm:
                sim.run(CHUNK, seed=99, chunk=CHUNK, precision=prec,
                        **run_kw)
            out, dt = timed_run(sim, nreal, prec, seed, **run_kw)
            again = sim.run(nreal, seed=seed, chunk=CHUNK, precision=prec,
                            **run_kw)
            moved = {k: v - before[k] for k, v in counts().items()
                     if v != before[k]}
            runs[(path, prec)] = (out, again, dt, moved)
            if spec is None:
                add_launches(report, shape, moved)
            else:
                main, null = lane_shapes(sim, path, shards, len(spec.orfs))
                add_launches(report, main,
                             {k: v // per_chunk for k, v in moved.items()})
                if per_chunk == 2:
                    add_launches(report, null,
                                 {k: v // 2 for k, v in moved.items()})
    rows = {}
    kernels = PATH_KERNEL if shards == 1 else SHARDED_KERNEL
    for (path, prec), (out, again, dt, moved) in runs.items():
        sim = sims[path]
        want = {kernels[path]: shards * per_chunk * (int(warm) + 2 * nchunks)
                } if path in kernels else {}
        if moved != want:
            raise AssertionError(f"{label} {path} [{prec}] launched "
                                 f"{moved}, expected {want}")
        row = compare((out["curves"], out["autos"]),
                      (ref["curves"], ref["autos"]), prec,
                      f"{label} {path} vs einsum",
                      tol=None if tol is None else tol[prec], rtol=rtol,
                      ntoa=sim.batch.max_toa)
        identical = (np.array_equal(out["curves"], again["curves"])
                     and np.array_equal(out["autos"], again["autos"]))
        if spec is not None:
            row.update(os_compare(out, ref, prec, f"{label} {path} vs "
                                                   f"einsum"))
            identical = identical and all(
                np.array_equal(out["os"]["stats"][o][k],
                               again["os"]["stats"][o][k])
                for o in out["os"]["orfs"]
                for k in ("amp2", "null_amp2") if k in out["os"]["stats"][o])
        if not identical:
            raise AssertionError(f"{label} {path} [{prec}] rerun is not "
                                 f"bit-identical")
        if out["curves"].shape != (nreal, sim.nbins):
            raise AssertionError(f"{label} {path}: curves shape "
                                 f"{out['curves'].shape}")
        peak = again["report"].memory.get("peak_hbm_bytes")
        row.update(realizations_per_s=nreal / dt, wall_s=dt,
                   kernel_launches=moved, rerun_identical=identical,
                   peak_hbm_bytes=peak)
        rows[f"{path}/{prec}"] = row
        print(f"{label}: {path} [{prec}] {nreal / dt:.1f} realizations/s "
              f"({dt:.3f} s), launches {moved}, rerun bit-identical, "
              f"peak_hbm_bytes {peak}", flush=True)
    return rows


def phase_engine(report: dict) -> None:
    sims = {p: flagship_sim(p.split("-")[0],
                            pallas_mxu_binning=p != "fused-vpu")
            for p in ("einsum", "fused", "fused-vpu", "mega")}
    ref, row = yardstick("engine", sims.pop("einsum"))
    npsr, ntoa = sims["fused"].batch.npsr, sims["fused"].batch.max_toa
    eng = {"einsum/f32": row}
    eng.update(drive_paths(report, "engine", sims, ref,
                           shape_tag(npsr, npsr, ntoa)))
    report["engine"] = eng

    # a small array against the CPU engine (the plain versions)
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    small = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    gwb = small_gwb(small)
    cpu = EnsembleSimulator(small, gwb=gwb, stat_path="einsum",
                            device="cpu").run(64, seed=3, chunk=32)
    for path in ("fused", "fused-vpu", "mega"):
        gpu = EnsembleSimulator(small, gwb=gwb, stat_path=path.split("-")[0],
                                pallas_mxu_binning=path != "fused-vpu",
                                device="cuda").run(64, seed=3, chunk=32,
                                                   precision="f32")
        compare((gpu["curves"], gpu["autos"]),
                (cpu["curves"], cpu["autos"]), "f32",
                f"small array: cuda {path} vs cpu einsum")


def phase_mesh(report: dict, cards: int = 1) -> None:
    """The flagship batch on ``make_mesh(["cuda:0"] * S, psr_shards=S)``
    for every statistic path at both precisions, held against the 1-shard
    einsum run, rerun bit-identically, with each path's kernel launched
    once per shard and chunk; then a small array at one pulsar per shard
    against the CPU engine on the same mesh shape. With ``cards`` > 1 the
    flagship meshes span that many cards instead (the rest of the factor
    goes to the real axis), so shards run on cards of their own."""
    import torch
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator

    nchunks = -(-MESH_NREAL // CHUNK)
    counters = {"einsum": (), "fused": ("binned_correlation",),
                "fused-vpu": ("binned_correlation_vpu",),
                "mega": ("chunk_stats_sharded",)}
    ref_sim = flagship_sim("einsum")
    refs = {p: ref_sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=p)
            for p in ("f32", "bf16")}

    def sim_for(path, shards):
        devices = (["cuda:0"] * shards if cards == 1
                   else [f"cuda:{i}" for i in range(cards)])
        return flagship_sim(path.split("-")[0],
                            mesh=make_mesh(devices, psr_shards=shards),
                            pallas_mxu_binning=path != "fused-vpu")

    where = ("shards run one after another on one card" if cards == 1
             else f"over {cards} cards")

    sims = {(path, s): sim_for(path, s)
            for s in MESH_SHARDS for path in counters}
    torch.cuda.synchronize()

    # the sharded path: launch counts zeroed just before, read just after
    reset_counts()
    rows = {}
    for (path, shards), sim in sims.items():
        for prec in ("f32", "bf16"):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=prec)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            again = sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=prec)
            moved = {k: v - before[k] for k, v in counts().items()
                     if v != before[k]}
            # once per chunk, real shard and psr shard, in each of 2 runs
            n_real = sim.mesh.shape["real"]
            want = {k: 2 * nchunks * n_real * shards
                    for k in counters[path]}
            if moved != want:
                raise AssertionError(f"mesh {path} x{shards} [{prec}] "
                                     f"launched {moved}, expected {want}")
            npsr = sim.batch.npsr
            add_launches(report, shape_tag(npsr // shards, npsr,
                                           sim.batch.max_toa), moved)
            row = compare((out["curves"], out["autos"]),
                          (refs[prec]["curves"], refs[prec]["autos"]), prec,
                          f"mesh {path} psr_shards={shards} vs 1-shard "
                          f"einsum", tol=MESH_TOL[prec])
            identical = all(np.array_equal(out[k], again[k])
                            for k in ("curves", "autos"))
            if not identical:
                raise AssertionError(f"mesh {path} x{shards} [{prec}] "
                                     f"rerun is not bit-identical")
            row.update(realizations_per_s=MESH_NREAL / dt, wall_s=dt,
                       kernel_launches=moved, rerun_identical=identical)
            rows[f"{path}/x{shards}/{prec}/{cards} card(s)"] = row
            print(f"mesh: {path} psr_shards={shards} [{prec}] "
                  f"{MESH_NREAL / dt:.1f} realizations/s ({dt:.3f} s; "
                  f"{where}), launches {moved}, rerun bit-identical",
                  flush=True)

    # the run loop on a sharded mesh: depth 2 against depth 0, bit for bit
    sim = sims[("mega", 2)]
    npsr = sim.batch.npsr
    for prec in ("f32", "bf16"):
        outs = {}
        for d in (0, 2):
            outs[d], dt, n = counted(
                report, shape_tag(npsr // 2, npsr, sim.batch.max_toa),
                "chunk_stats_sharded", lambda: sim.run(
                    MESH_NREAL, seed=5, chunk=CHUNK, precision=prec,
                    pipeline_depth=d),
                want=nchunks * sim.mesh.shape["real"] * 2)
            rows[f"mega/x2/{prec}/depth{d}"] = {
                "realizations_per_s": MESH_NREAL / dt, "launches": n}
        assert_identical(outs[2], outs[0], f"mesh mega psr_shards=2 "
                                           f"[{prec}] depth 2 against depth 0")
        rates = [rows[f"mega/x2/{prec}/depth{d}"]["realizations_per_s"]
                 for d in (0, 2)]
        print(f"mesh: mega psr_shards=2 [{prec}] depth 2 bit-identical to "
              f"depth 0 ({rates[0]:.1f} / {rates[1]:.1f} realizations/s)",
              flush=True)

    # the resumed stream does not depend on the mesh: a 1-shard run cut
    # after its first chunk resumes on the 2-shard mega mesh, keeps the
    # stored chunk bit for bit and lands within the mesh bound of the
    # unbroken 1-shard run
    ckdir = os.path.join(HERE, "build", "mesh_resume")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    for prec in ("f32", "bf16"):
        ck = os.path.join(ckdir, f"mesh_{prec}.npz")
        try:
            ref_sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=prec,
                        pipeline_depth=2, checkpoint=ck,
                        progress=kill_after(1))
        except Kill:
            pass
        else:
            raise AssertionError(f"mesh resume [{prec}]: the cut run "
                                 f"finished")
        out, _, n = counted(
            report, shape_tag(npsr // 2, npsr, sim.batch.max_toa),
            "chunk_stats_sharded", lambda: sim.run(
                MESH_NREAL, seed=5, chunk=CHUNK, precision=prec,
                pipeline_depth=2, checkpoint=ck),
            want=(nchunks - 1) * sim.mesh.shape["real"] * 2)
        want = refs[prec]
        if not all(np.array_equal(out[k][:CHUNK], want[k][:CHUNK])
                   for k in ("curves", "autos")):
            raise AssertionError(f"mesh resume [{prec}]: the stored chunk "
                                 f"changed")
        if ckpt_family(ck):
            raise AssertionError(f"mesh resume [{prec}]: "
                                 f"{ckpt_family(ck)} left")
        row = compare((out["curves"], out["autos"]),
                      (want["curves"], want["autos"]), prec,
                      "mesh mega psr_shards=2 resumed from a 1-shard "
                      "checkpoint vs the unbroken 1-shard einsum run",
                      tol=MESH_TOL[prec])
        row["launches"] = n
        rows[f"mega/x2/{prec}/resumed_from_1_shard"] = row
    shutil.rmtree(ckdir, ignore_errors=True)
    rows.update(toa_rows(report, ref_sim, refs, cards))
    report["mesh"] = rows

    # one pulsar per shard, against the CPU engine on the same mesh shape
    from fakepta_tpu_torch.batch import PulsarBatch
    small = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    gwb = small_gwb(small)
    cpu = EnsembleSimulator(small, gwb=gwb, stat_path="einsum",
                            mesh=make_mesh(["cpu"] * 8, psr_shards=8)
                            ).run(64, seed=3, chunk=32)
    for path in counters:
        gpu = EnsembleSimulator(
            small, gwb=gwb, stat_path=path.split("-")[0],
            pallas_mxu_binning=path != "fused-vpu",
            mesh=make_mesh(["cuda:0"] * 8, psr_shards=8)).run(
                64, seed=3, chunk=32, precision="f32")
        compare((gpu["curves"], gpu["autos"]),
                (cpu["curves"], cpu["autos"]), "f32",
                f"small array psr_shards=8: cuda {path} vs cpu einsum")


def toa_rows(report: dict, ref_sim, refs: dict, cards: int) -> dict:
    """TOA sharding (the einsum path only): the flagship at toa_shards 2
    and 4 and on a psr 2 x toa 2 mesh, ipta_dr3 at toa_shards 2 (448 TOA
    slots a window) and the flagship's OS lane with its null stream at
    toa_shards 2, each at both precisions against the 1-shard einsum run at
    the same precision (the JAX package's bound, rtol 5e-5; the OS lanes
    within OS_TOL), rerun bit-identically, launching no kernel. Over one
    card (cells in turn) or ``cards`` cards."""
    from fakepta_tpu_torch.detect import OSSpec
    from fakepta_tpu_torch.parallel.mesh import make_mesh

    def mesh(psr, toa):
        n = psr * toa
        devices = (["cuda:0"] * n if cards == 1
                   else [f"cuda:{i}" for i in range(cards)])
        return make_mesh(devices, psr_shards=psr, toa_shards=toa)

    spec = OSSpec(orf=DETECT_ORFS, null=True)
    ipta_refs = {p: ipta_sim("einsum").run(MESH_NREAL, seed=5, chunk=CHUNK,
                                           precision=p)
                 for p in ("f32", "bf16")}
    os_refs = {p: ref_sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=p,
                              os=spec) for p in ("f32", "bf16")}
    cases = {
        "flagship toa_shards=2": (lambda: flagship_sim("einsum",
                                                       mesh=mesh(1, 2)),
                                  refs, None),
        "flagship toa_shards=4": (lambda: flagship_sim("einsum",
                                                       mesh=mesh(1, 4)),
                                  refs, None),
        "flagship psr_shards=2 toa_shards=2": (
            lambda: flagship_sim("einsum", mesh=mesh(2, 2)), refs, None),
        "ipta_dr3 toa_shards=2": (lambda: ipta_sim("einsum", mesh=mesh(1, 2)),
                                  ipta_refs, None),
        "flagship os null toa_shards=2": (
            lambda: flagship_sim("einsum", mesh=mesh(1, 2)), os_refs, spec),
    }
    out = {}
    for label, (build, ref, os_spec) in cases.items():
        sim = build()
        npsr, t = sim.batch.npsr, sim.batch.max_toa
        toa = sim.mesh.shape["toa"]
        for prec in ("f32", "bf16"):
            got = drive_paths(
                report, f"mesh {label}", {"einsum": sim}, ref[prec],
                shape_tag(npsr // sim.mesh.shape["psr"], npsr, t // toa),
                nreal=MESH_NREAL, seed=5, warm=False, precs=(prec,),
                os=os_spec, rtol=TOA_RTOL)
            for k, v in got.items():
                out[f"{label} {k}"] = v
        del sim
    return out


def ng15_sim(path: str, mesh=None, **kw):
    """The registry's ``ng15``, uncut, through its own entry point, on the
    card (or ``mesh``) with statistic path ``path``."""
    from fakepta_tpu_torch.scenarios import registry
    return registry.get("ng15").build(
        mesh=mesh, device=None if mesh is not None else "cuda",
        stat_path=path.split("-")[0],
        pallas_mxu_binning=path != "fused-vpu", **kw)


def pinned_flagship(stat_path: str):
    """(fixed, pinned): the flagship with zero-width NoiseSampling ranges
    at its own red and GWB parameters, and the fixed-PSD flagship whose red
    PSD and GWB PSD hold the float32 values the sampler computes on the
    card (the same operations on the same device)."""
    import torch
    from fakepta_tpu_torch import spectrum as spectrum_lib
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.parallel.montecarlo import (GWBConfig,
                                                       NoiseSampling)
    from fakepta_tpu_torch.scenarios import registry
    scn = registry.get("flagship_100")
    batch = scn.batch_parts(device="cuda")[0]

    def full(ndim, v):
        return torch.full((1,) * ndim, v, dtype=torch.float32, device="cuda")

    f_red = torch.arange(1, scn.n_red + 1, dtype=torch.float32,
                         device="cuda") * batch.df_own[:, None]
    f_gwb = torch.arange(1, scn.gwb_ncomp + 1, dtype=torch.float32,
                         device="cuda") * (1.0 / batch.tspan_common)
    leaves = batch.numpy()
    leaves["red_psd"] = spectrum_lib.powerlaw(
        f_red, full(3, scn.red_log10_A), full(3, scn.red_gamma))[0].cpu() \
        .numpy()
    gwb_psd = spectrum_lib.powerlaw(
        f_gwb, full(2, scn.gwb_log10_A), full(2, scn.gwb_gamma))[0].cpu() \
        .numpy()
    fixed = flagship_sim(
        stat_path, batch=PulsarBatch.from_numpy(leaves, device="cuda"),
        gwb=GWBConfig(psd=gwb_psd))
    pin = [NoiseSampling("red", log10_A=(scn.red_log10_A,) * 2,
                         gamma=(scn.red_gamma,) * 2),
           NoiseSampling("gwb", log10_A=(scn.gwb_log10_A,) * 2,
                         gamma=(scn.gwb_gamma,) * 2)]
    return fixed, flagship_sim(stat_path, noise_sample=pin)


def phase_scenarios(report: dict) -> None:
    """The scenario registry's arrays on the card (module docstring, phase
    5): ng15 uncut through every path, its kernels at its shapes, the
    flagship with BASELINE configs 8 and 11's draws, and ng15 on a 2-shard
    mesh. Each main-path run zeroes the kernel counts just before it and
    reads them just after."""
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.parallel.montecarlo import (NoiseSampling,
                                                       WhiteSampling)
    out = {}

    # -- ng15, uncut: 68 pulsars padded to 512 TOAs, four backend bands ---
    ref, out["ng15 einsum/f32"] = yardstick("scenarios ng15",
                                            ng15_sim("einsum"))
    sims = {p: ng15_sim(p) for p in ("fused", "fused-vpu", "mega")}
    batch = sims["fused"].batch
    npsr, ntoa = batch.npsr, batch.max_toa
    print(f"scenarios ng15: {npsr} pulsars x {ntoa} TOA slots "
          f"({float(batch.mask.float().mean()):.4f} valid), "
          f"{batch.sys_mask.shape[1]} backend bands, white hyperprior "
          f"draws; stages {sims['mega'].include}", flush=True)
    measure_kernels(report, sims["fused"], (npsr // 2,), "scenarios ng15")
    for k, v in drive_paths(report, "scenarios ng15", sims, ref,
                            shape_tag(npsr, npsr, ntoa)).items():
        out[f"ng15 {k}"] = v

    # -- the flagship with BASELINE config 8's and config 11's draws ------
    flag_npsr = 100
    configs = {
        "config 8": dict(noise_sample=[
            NoiseSampling("red", log10_A=(-17.0, -13.0), gamma=(1.0, 5.0)),
            NoiseSampling("gwb", log10_A=(-15.0, -14.0),
                          gamma=(13 / 3, 13 / 3))]),
        "config 11": dict(white_sample=WhiteSampling(
            efac=(0.5, 2.5), log10_tnequad=(-8.0, -5.0)),
            # the flagship's raw squared TOA error, no efac or EQUAD baked in
            toaerr2=np.full((flag_npsr, 780), 1e-7 ** 2)),
    }
    for name, kw in configs.items():
        label = f"scenarios flagship {name}"
        ref, out[f"flagship {name} einsum/f32"] = yardstick(
            label, flagship_sim("einsum", **kw))
        rows = drive_paths(report, label, {"fused": flagship_sim("fused",
                                                                 **kw)},
                           ref, shape_tag(flag_npsr, flag_npsr, 780))
        for k, v in rows.items():
            out[f"flagship {name} {k}"] = v

    # a zero-width NoiseSampling run is the fixed-PSD run, bit for bit
    fixed, pinned = pinned_flagship("fused")
    reset_counts()
    for prec in ("f32", "bf16"):
        a = fixed.run(2 * CHUNK, seed=6, chunk=CHUNK, precision=prec)
        b = pinned.run(2 * CHUNK, seed=6, chunk=CHUNK, precision=prec)
        if not all(np.array_equal(a[k], b[k]) for k in ("curves", "autos")):
            raise AssertionError(f"zero-width NoiseSampling [{prec}] is not "
                                 f"the fixed-PSD run bit for bit")
    add_launches(report, shape_tag(flag_npsr, flag_npsr, 780), counts())
    out["flagship zero-width NoiseSampling"] = {"bit_identical": True}
    print("scenarios flagship: zero-width NoiseSampling equals the "
          "fixed-PSD run bit for bit (fused, f32 and bf16)", flush=True)

    # -- ng15 on two psr shards of the card (34 pulsars each) -------------
    ref = ng15_sim("einsum").run(MESH_NREAL, seed=5, chunk=CHUNK,
                                 precision="f32")
    mesh = make_mesh(["cuda:0"] * 2, psr_shards=2)
    sims = {p: ng15_sim(p, mesh=mesh) for p in ("einsum", "fused",
                                                "fused-vpu", "mega")}
    rows = drive_paths(report, "scenarios ng15 psr_shards=2", sims, ref,
                       shape_tag(npsr // 2, npsr, ntoa), nreal=MESH_NREAL,
                       seed=5, tol=MESH_TOL, shards=2, warm=False)
    for k, v in rows.items():
        out[f"ng15 psr_shards=2 {k}"] = v

    # ng15 reduced: the card against the CPU engine (the plain versions)
    from fakepta_tpu_torch.scenarios import registry
    small = registry.get("ng15").reduced(max_psr=16, max_toa=128)
    cpu = small.build(device="cpu", stat_path="einsum").run(64, seed=3,
                                                           chunk=32)
    for path in ("fused", "mega"):
        gpu = small.build(device="cuda", stat_path=path).run(
            64, seed=3, chunk=32, precision="f32")
        compare((gpu["curves"], gpu["autos"]),
                (cpu["curves"], cpu["autos"]), "f32",
                f"ng15 reduced: cuda {path} vs cpu einsum")
    report["scenarios"] = out


def ipta_sim(path: str, mesh=None, **kw):
    """The registry's ``ipta_dr3``, uncut, through its own entry point, on
    the card (or ``mesh``) with statistic path ``path``."""
    from fakepta_tpu_torch.scenarios import registry
    return registry.get("ipta_dr3").build(
        mesh=mesh, device=None if mesh is not None else "cuda",
        stat_path=path.split("-")[0],
        pallas_mxu_binning=path != "fused-vpu", **kw)


def chunk_split(sim, path: str, label: str = "signals ipta_dr3",
                lanes=None) -> dict:
    """Device ms of one chunk step by the engine's spans (keys; residuals,
    which hold the sampled Roemer and CGW terms; the statistic) in one
    ``torch.profiler``-traced step. Each span appears on the device
    timeline as an annotation from its first kernel to its last: its
    ``busy`` is the time of the kernels inside it, its ``extent`` the
    annotation's length (idle gaps included). Draws = residuals - roemer -
    cgw. ``lanes`` (:meth:`EnsembleSimulator._prepare_lanes`): the step
    carries that OS lane, whose null stream is the span ``null``, or that
    likelihood lane: its residual moments ``lnlike_moments``, its
    factorizations and solves ``lnlike`` and, on the mega path, the
    projection of the split coefficients it reads, ``gp_project``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fakepta_tpu_torch.utils import rng

    prec = sim._resolve_precision(path, None)
    base = rng.key(11, device="cuda")
    with torch.no_grad():
        sim.step(base, 0, CHUNK, path, prec, lanes=lanes)         # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            sim.step(base, CHUNK, CHUNK, path, prec, lanes=lanes)
            torch.cuda.synchronize()
        step_ms = time_ms(lambda: sim.step(base, 2 * CHUNK, CHUNK, path,
                                           prec, lanes=lanes), 2, warmup=0)
    reset_counts()
    names = ("keys", "residuals", "roemer", "cgw", "statistic", "null",
             "gp_project", "lnlike_moments", "lnlike")
    spans, kernels = {}, []
    for ev in p.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        tr = ev.time_range
        if ev.name in names:
            spans.setdefault(ev.name, []).append((tr.start, tr.end))
        else:
            kernels.append((tr.start, tr.elapsed_us() / 1e3))
    if "residuals" not in spans:
        raise AssertionError(f"chunk split [{path}]: the traced step has no "
                             f"span on the device timeline: {sorted(spans)}")
    row = {"path": path, "precision": prec, "step_ms": step_ms,
           "device_busy_ms": sum(d for _, d in kernels),
           "kernel_launches": len(kernels)}
    for name, ivs in spans.items():
        inside = [(t, d) for t, d in kernels
                  if any(lo <= t < hi for lo, hi in ivs)]
        row[f"{name}_ms"] = sum(d for _, d in inside)
        row[f"{name}_launches"] = len(inside)
        row[f"{name}_extent_ms"] = sum(hi - lo for lo, hi in ivs) / 1e3
    for key in ("ms", "launches", "extent_ms"):
        row[f"draws_{key}"] = row[f"residuals_{key}"] - sum(
            row.get(f"{n}_{key}", 0) for n in ("roemer", "cgw"))
    print(f"{label} chunk split [{path}, {prec}], kernel ms "
          f"(launches; span extent ms): " + ", ".join(
              f"{n} {row.get(n + '_ms', 0):.3f} "
              f"({row.get(n + '_launches', 0)}; "
              f"{row.get(n + '_extent_ms', 0):.3f})"
              for n in ("keys", "draws", "roemer", "cgw", "statistic",
                        "null", "gp_project", "lnlike_moments", "lnlike")
              if n in spans or n in ("keys", "draws", "statistic"))
          + f"; traced step device busy {row['device_busy_ms']:.3f} ms over "
          f"{len(kernels)} kernel launches; untraced step {step_ms:.3f} ms",
          flush=True)
    return row


def roemer_shortcut(sim) -> dict:
    """The sampled Roemer term of one chunk, mass-only draws through the
    engine's shortcut and through the full difference form (every orbit
    perturbation its (R, 1, 1) zero draw, as the engine would pass them
    without the shortcut): the two must agree bit for bit; each is timed
    between CUDA events."""
    import torch
    from fakepta_tpu_torch.models.roemer import roemer_delay_dev
    from fakepta_tpu_torch.parallel import montecarlo as tmc
    from fakepta_tpu_torch.utils import rng

    sh = sim._full
    state, scales, zero = sh.signals.roemer[0]
    keys = tmc._chunk_keys(rng.key(11, device="cuda"), 0, CHUNK)
    # the engine's per-realization draws, (R, 1, 1) each; the orbit
    # perturbations' scales are zero, so theirs are signed zeros
    d = rng.normal(rng.fold_in(rng.fold_in(keys, tmc._ROEMER_TAG), 0), 7) \
        * scales
    full = {name: d[:, i].reshape(-1, 1, 1)
            for i, name in enumerate(tmc._ROEMER_PARAMS)}
    if not all(zero[1:]):
        raise AssertionError(f"ipta_dr3's Roemer draws are not mass-only: "
                             f"{zero}")
    with torch.no_grad():
        got = roemer_delay_dev(state, sh.batch.pos, d_mass=full["d_mass"])
        want = roemer_delay_dev(state, sh.batch.pos, **full)
        if not torch.equal(got, want):
            raise AssertionError("the mass-only Roemer shortcut differs from "
                                 "the full difference form")
        row = {"shortcut_ms": time_ms(lambda: roemer_delay_dev(
            state, sh.batch.pos, d_mass=full["d_mass"]), 3, warmup=1),
            "difference_form_ms": time_ms(lambda: roemer_delay_dev(
                state, sh.batch.pos, **full), 3, warmup=1),
            "bit_identical": True}
    print(f"signals ipta_dr3 Roemer term, mass-only draws: shortcut "
          f"{row['shortcut_ms']:.3f} ms, full difference form "
          f"{row['difference_form_ms']:.3f} ms, bit-identical", flush=True)
    return row


def phase_signals(report: dict) -> None:
    """CGW and BayesEphem signals on the card (module docstring, phase
    ``signals``): ipta_dr3 uncut through every path, its kernels at its
    shapes, its 2-shard mesh, a checkpointed round on mega, the per-stage
    chunk split, and the flagship with BASELINE configs 6 and 9. Each
    main-path run zeroes the kernel counts just before it and reads them
    just after."""
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.parallel.montecarlo import (CGWSampling,
                                                       RoemerConfig)
    from fakepta_tpu_torch.scenarios import registry
    out = {}

    # -- ipta_dr3, uncut --------------------------------------------------
    yard = ipta_sim("einsum")
    ref, out["ipta_dr3 einsum/f32"] = yardstick("signals ipta_dr3", yard)
    sims = {p: ipta_sim(p) for p in ("fused", "fused-vpu", "mega")}
    batch = sims["fused"].batch
    npsr, ntoa = batch.npsr, batch.max_toa
    sig = sims["fused"]._full.signals
    shape_row = {
        "spec_hash": registry.get("ipta_dr3").spec_hash(), "pulsars": npsr,
        "toa_slots": ntoa, "valid_share": float(batch.mask.float().mean()),
        "backend_bands": int(batch.sys_mask.shape[1]),
        "K": mk.stage_k(sims["mega"]._mega_tables[0]),
        "roemer_bodies": len(sig.roemer), "cgw_sources": len(sig.cgw),
        "stages": list(sims["mega"].include)}
    out["ipta_dr3 shape"] = shape_row
    print(f"signals ipta_dr3 ({shape_row['spec_hash']}): {npsr} pulsars x "
          f"{ntoa} TOA slots ({shape_row['valid_share']:.4f} valid), "
          f"{shape_row['backend_bands']} backend bands, K = "
          f"{shape_row['K']}, {len(sig.roemer)} sampled body, "
          f"{len(sig.cgw)} sampled source; stages {sims['mega'].include}",
          flush=True)
    measure_kernels(report, sims["fused"], (npsr // 2,), "signals ipta_dr3")
    for k, v in drive_paths(report, "signals ipta_dr3", sims, ref,
                            shape_tag(npsr, npsr, ntoa)).items():
        out[f"ipta_dr3 {k}"] = v
    out["ipta_dr3 chunk split"] = {
        p: chunk_split(s, p) for p, s in (("einsum", yard),
                                          ("fused", sims["fused"]),
                                          ("mega", sims["mega"]))}
    out["ipta_dr3 roemer shortcut"] = roemer_shortcut(sims["fused"])

    # -- a checkpointed cut-and-resume round on mega ----------------------
    ckdir = os.path.join(HERE, "build", "signals_phase")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    shape = shape_tag(npsr, npsr, ntoa)
    for prec in ("f32", "bf16"):
        want, _, _ = counted(report, shape, "chunk_stats",
                             lambda: sims["mega"].run(
                                 NREAL, seed=21, chunk=CHUNK, precision=prec,
                                 pipeline_depth=2), want=NREAL // CHUNK)
        out[f"ipta_dr3 mega/{prec} resume"] = resume_round(
            report, "signals ipta_dr3 mega", sims["mega"], prec,
            "chunk_stats", shape, ckdir, want, NREAL, torn=False)
    shutil.rmtree(ckdir, ignore_errors=True)

    # -- ipta_dr3 on two psr shards of the card (60 pulsars each) ---------
    ref = yard.run(MESH_NREAL, seed=5, chunk=CHUNK, precision="f32")
    mesh = make_mesh(["cuda:0"] * 2, psr_shards=2)
    msims = {p: ipta_sim(p, mesh=mesh) for p in ("einsum", "fused",
                                                 "fused-vpu", "mega")}
    rows = drive_paths(report, "signals ipta_dr3 psr_shards=2", msims, ref,
                       shape_tag(npsr // 2, npsr, ntoa), nreal=MESH_NREAL,
                       seed=5, tol=MESH_TOL, shards=2, warm=False)
    for k, v in rows.items():
        out[f"ipta_dr3 psr_shards=2 {k}"] = v
    del msims, sims, yard

    # -- the flagship with BASELINE config 6 and config 9 -----------------
    toas_abs = registry.get("flagship_100").batch_parts(device="cpu")[1]
    tref = float(toas_abs.mean())
    configs = {
        "config 6": dict(roemer=RoemerConfig("jupiter",
                                             d_mass=1e-4 * 1.899e27)),
        "config 9": dict(cgw_sample=CGWSampling(tref=tref)),
        # config 9 with the pulsar term and sampled distances (1 +- 0.2 kpc):
        # each chunk's retarded-phase bulks are staged on the host
        "config 9 psrterm": dict(
            cgw_sample=CGWSampling(tref=tref, psrterm=True,
                                   sample_pdist=True),
            pdist=np.tile([1.0, 0.2], (100, 1))),
    }
    for name, kw in configs.items():
        label = f"signals flagship {name}"
        ref, out[f"flagship {name} einsum/f32"] = yardstick(
            label, flagship_sim("einsum", toas_abs=toas_abs, **kw))
        sim = flagship_sim("fused", toas_abs=toas_abs, **kw)
        rows = drive_paths(report, label, {"fused": sim}, ref,
                           shape_tag(100, 100, 780))
        for k, v in rows.items():
            out[f"flagship {name} {k}"] = v
    # the host's bulk staging in the last run: chunk 0's before the loop,
    # each later chunk's right after the previous dispatch
    staged = [e["dur"] for e in sim.last_report.timeline
              if e["name"] in ("stage_inputs", "precompute")]
    if len(staged) != NREAL // CHUNK:
        raise AssertionError(f"psrterm bulks staged {len(staged)} times for "
                             f"{NREAL // CHUNK} chunks")
    out["flagship config 9 psrterm bulk staging ms"] = [
        1e3 * d for d in staged]
    print(f"signals flagship config 9 psrterm: host bulk staging per chunk "
          f"{', '.join(f'{1e3 * d:.3f}' for d in staged)} ms", flush=True)
    report["signals"] = out


class Kill(Exception):
    """Raised by a progress callback to cut a checkpointed run."""


def kill_after(n_chunks: int):
    """A progress callback that ends the run once ``n_chunks`` chunks have
    drained (each of them checkpointed first)."""
    def boom(done, nreal):
        if done >= n_chunks * CHUNK:
            raise Kill
    return boom


def counted(report: dict, shape: str, kernel: str, fn, want=None):
    """Run ``fn`` (one main-path run) with every kernel count zeroed just
    before and read just after; adds the launches to ``report`` at
    ``shape``. Raises unless only ``kernel`` was launched, ``want`` times
    when given. Returns (fn's result or the exception it raised, wall
    seconds between two synchronizations, launches)."""
    import torch
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = fn()
    except Kill as exc:
        # without its traceback: that holds this frame, and a cycle
        # through it would keep the cut run's simulator on the card
        result = exc.with_traceback(None)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moved = {k: v for k, v in counts().items() if v}
    add_launches(report, shape, moved)
    if set(moved) != {kernel} or (want is not None
                                  and moved[kernel] != want):
        raise AssertionError(f"launched {moved}, expected {kernel} x "
                             f"{want if want is not None else 'some'}")
    return result, dt, moved[kernel]


def assert_identical(a: dict, b: dict, what: str) -> None:
    if not all(np.array_equal(a[k], b[k]) for k in ("curves", "autos")):
        raise AssertionError(f"{what} is not bit-identical")


def ckpt_family(ck: str) -> list:
    """The checkpoint's files (the flight-recorder dump of a cut run
    aside)."""
    d, name = os.path.split(ck)
    return sorted(p for p in os.listdir(d) if p.startswith(name))


def step_working_set(sim, prec: str, steps: int = 3) -> int:
    """Peak allocated bytes of a bare chunk step (with its key), the
    simulator's resident tensors included: the largest over ``steps``
    steps at successive offsets, each alone, once the allocator's cache is
    warm (a cached block may be up to 1 MB larger than the request, so a
    first step on a cold cache reads low). Their launches are not
    counted."""
    import torch
    peaks = []
    for i in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            packed, _ = sim.step(sim._base_key(21), i * CHUNK, CHUNK,
                                 sim.stat_path, prec)
        torch.cuda.synchronize()
        del packed
        peaks.append(torch.cuda.max_memory_allocated())
    reset_counts()
    return max(peaks)


def resume_round(report: dict, label: str, sim, prec: str, kernel: str,
                 shape: str, ckdir: str, want: dict, nreal: int,
                 torn: bool) -> dict:
    """A depth-2 checkpointed run cut after 3 chunks, then resumed; with
    ``torn`` the second chunk file is truncated before the resume and must
    roll back. Holds the result to ``want`` bit for bit and checks that the
    checkpoint's files are gone. Returns the round's row."""
    ck = os.path.join(ckdir, f"{label.replace(' ', '_')}_{prec}.npz")
    cut, _, n_cut = counted(report, shape, kernel, lambda: sim.run(
        nreal, seed=21, chunk=CHUNK, precision=prec, pipeline_depth=2,
        checkpoint=ck, progress=kill_after(3)))
    if not isinstance(cut, Kill):
        raise AssertionError(f"{label} [{prec}]: the cut run finished")
    saved = [p for p in ckpt_family(ck) if ".c0" in p]
    if len(saved) < 3:
        raise AssertionError(f"{label} [{prec}]: {saved} after the cut")
    if torn:
        path = ck + ".c000001.npz"
        with open(path, "rb") as fh:
            data = fh.read()
        with open(path, "wb") as fh:
            fh.write(data[:len(data) // 2])
    n_chunks = -(-nreal // CHUNK)
    resumed_chunks = n_chunks - (1 if torn else len(saved))
    out, _, n_res = counted(report, shape, kernel, lambda: sim.run(
        nreal, seed=21, chunk=CHUNK, precision=prec, pipeline_depth=2,
        checkpoint=ck), want=resumed_chunks)
    assert_identical(out, want, f"{label} [{prec}] resumed run")
    rolled = out["report"].counters.get("faults.rollbacks", 0)
    if rolled != (len(saved) - 1 if torn else 0):
        raise AssertionError(f"{label} [{prec}]: {rolled} chunks rolled "
                             f"back")
    if ckpt_family(ck):
        raise AssertionError(f"{label} [{prec}]: {ckpt_family(ck)} left")
    what = "torn chunk rolled back" if torn else "resumed"
    print(f"{label} [{prec}]: cut after {len(saved)} checkpointed chunks "
          f"({n_cut} launches), {what}: {n_res} chunks, {rolled} rolled "
          f"back, bit-identical, checkpoint files gone", flush=True)
    return {"cut_launches": n_cut, "resumed_launches": n_res,
            "chunks_saved_at_cut": len(saved), "rolled_back": rolled,
            "bit_identical": True}


def run_round(report: dict, label: str, sim, prec: str, kernel: str,
              shape: str, ckdir: str) -> dict:
    """The run loop on one path and precision (module docstring, phase
    ``run``): depths 0-3, the checkpointed run and its cut/resume and
    torn-chunk rounds, the lane cohort, the report and its peak memory."""
    import torch
    row = {}
    sim.run(CHUNK, seed=99, chunk=CHUNK, precision=prec)      # warm-up
    working = step_working_set(sim, prec)
    nchunks = RUN_NREAL // CHUNK
    outs = {}
    for d in RUN_DEPTHS:
        outs[d], dt, n = counted(report, shape, kernel, lambda: sim.run(
            RUN_NREAL, seed=21, chunk=CHUNK, precision=prec,
            pipeline_depth=d), want=nchunks)
        rep = outs[d]["report"]
        summ = rep.summary()
        # the packed buffers the loop may hold: the ring's bound when
        # pipelined; the serial loop keeps every chunk's until the end
        ring = rep.memory.get("packed_depth_bound_bytes",
                              nchunks * rep.memory["packed_buffer_bytes"])
        peak = rep.memory["peak_hbm_bytes"]
        # what the allocator may add: one granule per live large block
        # (the run reset the peak counts when it started)
        blocks = torch.cuda.memory_stats()["active.large_pool.peak"]
        slack = ALLOCATOR_GRANULE * blocks
        if peak > working + ring + slack:
            raise AssertionError(
                f"{label} [{prec}] depth {d}: peak {peak} B over the step's "
                f"working set {working} B + the packed buffers {ring} B + "
                f"{blocks} large blocks' allocator slack {slack} B")
        assert_identical(outs[d], outs[RUN_DEPTHS[0]],
                         f"{label} [{prec}] depth {d} against depth 0")
        row[f"depth{d}"] = {
            "realizations_per_s": RUN_NREAL / dt, "wall_s": dt,
            "launches": n, "pipeline_stall_s": summ["pipeline_stall_s"],
            "peak_hbm_bytes": peak, "packed_ring_bytes": ring,
            "step_working_set_bytes": working,
            "live_large_blocks_peak": blocks, "allocator_slack_bytes": slack,
            "execute_s": [c.get("execute_s") for c in rep.chunks]}
        print(f"{label} [{prec}] depth {d}: {RUN_NREAL / dt:.1f} "
              f"realizations/s ({dt:.3f} s), stall "
              f"{summ['pipeline_stall_s']:.4f} s, peak {peak} B <= step "
              f"working set {working} B + packed buffers {ring} B + "
              f"slack {slack} B ({blocks} large blocks; "
              f"{working + ring - peak} B under the bound without it), "
              f"bit-identical to depth 0", flush=True)
    print(f"{label} [{prec}] depth 3 report: "
          f"{json.dumps(outs[3]['report'].summary())}", flush=True)

    # the checkpointed depth-2 run, unbroken, beside the plain one
    ck = os.path.join(ckdir, f"full_{label.replace(' ', '_')}_{prec}.npz")
    full, dt, n = counted(report, shape, kernel, lambda: sim.run(
        RUN_NREAL, seed=21, chunk=CHUNK, precision=prec, pipeline_depth=2,
        checkpoint=ck), want=nchunks)
    assert_identical(full, outs[2], f"{label} [{prec}] checkpointed run")
    if ckpt_family(ck):
        raise AssertionError(f"{label} [{prec}]: {ckpt_family(ck)} left")
    summ = full["report"].summary()
    row["checkpointed"] = {
        "realizations_per_s": RUN_NREAL / dt, "wall_s": dt, "launches": n,
        "ckpt_wait_s": summ["ckpt_wait_s"],
        "pipeline_stall_s": summ["pipeline_stall_s"],
        "uncheckpointed_realizations_per_s":
            row["depth2"]["realizations_per_s"]}
    print(f"{label} [{prec}] checkpointed depth 2: {RUN_NREAL / dt:.1f} "
          f"realizations/s beside {row['depth2']['realizations_per_s']:.1f} "
          f"without; ckpt_wait_s {summ['ckpt_wait_s']:.4f}, "
          f"pipeline_stall_s {summ['pipeline_stall_s']:.4f}", flush=True)
    row["resume"] = resume_round(report, label, sim, prec, kernel, shape,
                                 ckdir, outs[2], RUN_NREAL, torn=False)
    row["torn"] = resume_round(report, label, sim, prec, kernel, shape,
                               ckdir, outs[2], RUN_NREAL, torn=True)

    # a 1024-slot cohort of lanes: each lane bit for bit its lane alone at
    # the same chunk, and within tolerance of its solo run
    cohort, _, _ = counted(report, shape, kernel, lambda: sim.run(
        CHUNK, chunk=CHUNK, precision=prec, lanes=RUN_LANES), want=1)
    lanes, pos = {}, 0
    for s, n in RUN_LANES:
        alone, _, _ = counted(report, shape, kernel, lambda: sim.run(
            CHUNK, chunk=CHUNK, precision=prec, lanes=[(s, n)]), want=1)
        mine = {k: cohort[k][pos:pos + n] for k in ("curves", "autos")}
        assert_identical(mine, {k: alone[k][:n] for k in ("curves",
                                                          "autos")},
                         f"{label} [{prec}] lane ({s}, {n}) against it alone")
        solo, _, _ = counted(report, shape, kernel,
                             lambda: sim.run(n, seed=s, chunk=n,
                                             precision=prec), want=1)
        lanes[f"{s}x{n}"] = compare(
            (mine["curves"], mine["autos"]), (solo["curves"], solo["autos"]),
            prec, f"{label} lane ({s}, {n}) vs run({n}, seed={s})")
        pos += n
    row["lanes"] = lanes
    print(f"{label} [{prec}]: lanes {list(RUN_LANES)} each bit-identical to "
          f"the lane alone at chunk {CHUNK}", flush=True)
    return row


def phase_run(report: dict) -> None:
    """The run loop on the card (module docstring, phase 6): every path at
    the flagship's full width through :func:`run_round`, then one
    pipelined checkpoint-resume round of ng15 on ``"mega"``."""
    import torch
    ckdir = os.path.join(HERE, "build", "run_phase")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    out = {}
    for path in ("fused", "fused-vpu", "mega"):
        sim = flagship_sim(path.split("-")[0],
                           pallas_mxu_binning=path != "fused-vpu")
        shape = shape_tag(sim.batch.npsr, sim.batch.npsr, sim.batch.max_toa)
        for prec in ("f32", "bf16"):
            out[f"{path}/{prec}"] = run_round(report, f"run {path}", sim,
                                              prec, PATH_KERNEL[path],
                                              shape, ckdir)
        del sim
        torch.cuda.empty_cache()
    sim = ng15_sim("mega")
    shape = shape_tag(sim.batch.npsr, sim.batch.npsr, sim.batch.max_toa)
    for prec in ("f32", "bf16"):
        want, _, _ = counted(report, shape, "chunk_stats", lambda: sim.run(
            NREAL, seed=21, chunk=CHUNK, precision=prec, pipeline_depth=2),
            want=NREAL // CHUNK)
        out[f"ng15 mega/{prec}"] = resume_round(
            report, "run ng15 mega", sim, prec, "chunk_stats", shape, ckdir,
            want, NREAL, torn=False)
    shutil.rmtree(ckdir, ignore_errors=True)
    report["run"] = out


def lane_launches(report: dict, sim, path: str, n_os: int,
                  moved: dict) -> None:
    """Add an OS-lane run's launches, half at the main launch's shape and
    half at the null stream's (:func:`lane_shapes`, one shard)."""
    main, null = lane_shapes(sim, path, 1, n_os)
    add_launches(report, main, {k: v // 2 for k, v in moved.items()})
    add_launches(report, null, {k: v // 2 for k, v in moved.items()})


def phase_detect(report: dict) -> None:
    """The detection lane on the card (module docstring, phase
    ``detect``): every kernel at the OS lane's slot counts and the null
    stream's stage set, the flagship through every path with three ORF
    lanes and the null stream, ``os="hd"`` alone, a 2-shard mesh,
    ``DetectionRun`` and the CLI, and ipta_dr3 uncut on ``"fused"``. Each
    main-path run zeroes the kernel counts just before it and reads them
    just after."""
    import torch
    from fakepta_tpu_torch.detect import DetectionRun, OSSpec
    from fakepta_tpu_torch.obs.report import RunReport
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.scenarios import registry
    out = {}
    spec = OSSpec(orf=DETECT_ORFS, null=True)
    n_os = len(DETECT_ORFS)
    paths = ("einsum", "fused", "fused-vpu", "mega")
    sims = {p: flagship_sim(p.split("-")[0],
                            pallas_mxu_binning=p != "fused-vpu")
            for p in paths}

    # -- the kernels at the lane's shapes: the main launch (NB = 19; K =
    # 320 on chunk_stats) and the null stream's (NB = 4, K = 260), on the
    # shared set and a 2-shard mesh's rows; os="hd"'s main launch (NB = 17)
    for null in (False, True):
        measure_kernels(report, sims["mega"], (50,),
                        f"detect {'null' if null else 'main'} launch",
                        spec=spec, null=null)
    measure_kernels(report, sims["mega"], (), "detect os=hd launch",
                    spec=OSSpec(orf="hd"))

    # -- the flagship, three ORF lanes with the null stream, every path ---
    yard = sims.pop("einsum")
    ref, out["flagship os+null einsum/f32"] = yardstick(
        "detect flagship os+null", yard, os=spec)
    for k, v in drive_paths(report, "detect flagship os+null", sims, ref,
                            shape_tag(100, 100, 780), os=spec).items():
        out[f"flagship os+null {k}"] = v
    out["flagship os+null chunk split"] = {
        p: chunk_split(s, p, "detect flagship os+null",
                       s._prepare_lanes(spec))
        for p, s in (("einsum", yard), ("fused", sims["fused"]),
                     ("mega", sims["mega"]))}
    # os="hd" alone, without the null stream (the hd lane of the same
    # keys is the reference run's)
    for k, v in drive_paths(report, "detect flagship os=hd",
                            {"einsum": yard, **sims}, ref,
                            shape_tag(100, 100, 780), os="hd").items():
        out[f"flagship os=hd {k}"] = v

    # -- every path on a 2-shard psr mesh, shards in turn on the card -----
    mref = yard.run(MESH_NREAL, seed=5, chunk=CHUNK, precision="f32",
                    os=spec)
    mesh = make_mesh(["cuda:0"] * 2, psr_shards=2)
    msims = {p: flagship_sim(p.split("-")[0], mesh=mesh,
                             pallas_mxu_binning=p != "fused-vpu")
             for p in paths}
    for k, v in drive_paths(report, "detect flagship os+null psr_shards=2",
                            msims, mref, shape_tag(50, 100, 780),
                            nreal=MESH_NREAL, seed=5, tol=MESH_TOL,
                            shards=2, warm=False, os=spec).items():
        out[f"flagship os+null psr_shards=2 {k}"] = v
    del msims, sims, yard
    torch.cuda.empty_cache()

    # -- DetectionRun on the flagship batch (the engine's default path:
    # "fused", bf16 operands), its artifact, and the CLI in a subprocess --
    scn = registry.get("flagship_100")
    parts = scn.batch_parts(device="cuda")
    study = DetectionRun(parts[0], gwb=scn.sim_kwargs(*parts)["gwb"],
                         os=DETECT_ORFS, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = study.run(NREAL, seed=2, chunk=CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moved = {k: v for k, v in counts().items() if v}
    if moved != {"binned_correlation": 2 * (NREAL // CHUNK)}:
        raise AssertionError(f"DetectionRun launched {moved}")
    lane_launches(report, study.sim, "fused", n_os, moved)
    art = study.save(os.path.join(HERE, "build", "detect_study.jsonl"))
    loaded = RunReport.load(art).summary()
    if any(loaded.get(k) != v for k, v in res["summary"].items()):
        raise AssertionError("DetectionRun's artifact does not load with "
                             "its summary")
    out["DetectionRun flagship"] = dict(
        res["summary"], realizations_per_s=NREAL / dt, launches=moved,
        os_real_per_s_per_chip=loaded["os_real_per_s_per_chip"])
    print(f"detect DetectionRun flagship: {NREAL / dt:.1f} realizations/s, "
          f"launches {moved}, summary {json.dumps(res['summary'])}",
          flush=True)
    del study, res
    cli_out = os.path.join(HERE, "build", "detect.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fakepta_tpu_torch.detect", "run", "--npsr",
         "100", "--ntoa", "780", "--nreal", "4096", "--chunk", "1024",
         "--out", cli_out], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the detection CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    rep = RunReport.load(cli_out)
    if rep.meta.get("platform") != "gpu" or not rep.meta["os"]["null"]:
        raise AssertionError(f"the CLI's artifact: {rep.meta}")
    out["CLI"] = dict(row, wall_s=time.perf_counter() - t0,
                      device_kind=rep.meta["device_kind"])
    print(f"detect CLI: exit 0 in {out['CLI']['wall_s']:.1f} s, "
          f"{json.dumps(row)}; artifact loads", flush=True)

    # -- ipta_dr3 uncut on "fused", HD and its own anisotropic template ---
    ipta = registry.get("ipta_dr3")
    ispec = OSSpec(orf=("hd", "anisotropic"), h_map=ipta.gwb_h_map(),
                   null=True)
    iref, out["ipta_dr3 os+null einsum/f32"] = yardstick(
        "detect ipta_dr3 os+null", ipta_sim("einsum"), os=ispec)
    fused = ipta_sim("fused")
    for null in (False, True):
        measure_kernels(report, fused, (),
                        f"detect ipta_dr3 {'null' if null else 'main'} "
                        f"launch", spec=ispec, null=null)
    for k, v in drive_paths(report, "detect ipta_dr3 os+null",
                            {"fused": fused}, iref,
                            shape_tag(120, 120, 896), os=ispec).items():
        out[f"ipta_dr3 os+null {k}"] = v
    report["detect"] = out


#: the facade phase: the flagship-width array's seed, realizations per run
#: on its batch, and the per-TOA leaves of a batch (the TOA axis last)
FACADE_SEED = 2024
FACADE_NREAL = 2048
TOA_LEAVES = ("t_own", "t_common", "mask", "freqs", "sigma2", "epoch_idx",
              "ecorr_amp", "sys_mask")


def injection_rate(fn, n_injections: int, iters: int) -> float:
    """Injections per second of ``fn`` (``n_injections`` per call) over
    ``iters`` calls after one warm-up call, between synchronizations."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return n_injections * iters / (time.perf_counter() - t0)


def injection_trace(fn) -> dict:
    """One traced call of ``fn``: its CUDA kernel launches, host-device
    copies and device busy milliseconds (``torch.profiler``), beside the
    call's wall milliseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    row = {"kernels": 0, "copies": 0, "busy_ms": 0.0, "wall_ms": 1e3 * wall}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        row["copies" if "Memcpy" in ev.name else "kernels"] += 1
        row["busy_ms"] += ev.time_range.elapsed_us() / 1e3
    return row


def trim_toas(batch, width: int):
    """``batch`` cut to its first ``width`` TOA slots (every valid TOA must
    fit them): a facade batch at a width that from_pulsars' 128-slot
    padding never gives."""
    from fakepta_tpu_torch.batch import PulsarBatch
    leaves = batch.numpy()
    if leaves["mask"][:, width:].any():
        raise AssertionError(f"valid TOAs beyond slot {width}")
    for k in TOA_LEAVES:
        leaves[k] = leaves[k][..., :width]
    return PulsarBatch.from_numpy(leaves, device=batch.device)


def facade_gwb(batch):
    """The flagship's HD background (2e-15, 13/3, 30 bins) on a batch's
    own grid."""
    from fakepta_tpu_torch import spectrum as spectrum_lib
    from fakepta_tpu_torch.parallel.montecarlo import GWBConfig
    f = np.arange(1, 31) / float(batch.tspan_common)
    return GWBConfig(psd=spectrum_lib.powerlaw(f, float(np.log10(2e-15)),
                                               13 / 3).numpy())


def check_gp_consistent(psrs, signals, what: str, updates: int = 1) -> None:
    """Each pulsar's residuals equal the sum of its stored signals'
    reconstructions (finite, on the card) within 1e-5 of their scale times
    the square root of the float32 residual ``updates`` made: each
    re-injection adds its own rounding, as a random walk."""
    for p in psrs:
        if p._res_dev is not None and not p._res_dev.is_cuda:
            raise AssertionError(f"{what}: {p.name}'s residuals left the "
                                 f"card")
        res = p.residuals
        rec = p.reconstruct_signal(signals)
        if not (np.isfinite(res).all() and np.abs(res).max() > 0):
            raise AssertionError(f"{what}: {p.name} residuals not finite "
                                 f"or zero")
        err = np.abs(res - rec).max() / np.abs(rec).max()
        if err > 1e-5 * updates ** 0.5:
            raise AssertionError(f"{what}: {p.name} residuals differ from "
                                 f"their signals by {err:.3e} of scale")


def phase_facade(report: dict) -> None:
    """The reference-compatible facade on the card (module docstring,
    phase 9)."""
    import torch
    from fakepta_tpu_torch import constants as const
    from fakepta_tpu_torch import fake_pta as fp
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    from fakepta_tpu_torch.utils import io as fio

    rows = {}
    # BASELINE configs 1 and 2 (benchmarks/suite.py:162-190)
    toas = np.linspace(0, 10 * const.yr, 520)
    psr = fp.Pulsar(toas, 1e-6, 1.0, 1.0, seed=0, device="cuda")
    rows["config1_injections_per_s"] = injection_rate(
        lambda: psr.add_white_noise(seed=1), 1, 200)
    if not np.isfinite(psr.residuals).all():
        raise AssertionError("config 1: non-finite residuals")
    psrs10 = [fp.Pulsar(toas, 1e-6, 1.0 + 0.1 * k, 0.3 * k, seed=k,
                        device="cuda") for k in range(10)]
    rows["config2_injections_per_s"] = injection_rate(
        lambda: fp.add_noise_array(psrs10, signal="red_noise",
                                   spectrum="powerlaw", log10_A=-14.0,
                                   gamma=13 / 3, seed=2), 10, 50)
    check_gp_consistent(psrs10, ["red_noise"], "config 2", updates=51)
    for name, fn in (("config1", lambda: psr.add_white_noise(seed=1)),
                     ("config2", lambda: fp.add_noise_array(
                         psrs10, signal="red_noise", log10_A=-14.0,
                         gamma=13 / 3, seed=2))):
        rows[f"{name}_trace"] = injection_trace(fn)
    print(f"facade: config 1 {rows['config1_injections_per_s']:.1f} "
          f"white injections/s (1 pulsar, 520 TOAs); config 2 "
          f"{rows['config2_injections_per_s']:.1f} red injections/s (10 "
          f"pulsars, 30 bins, add_noise_array); one traced call each: "
          f"{rows['config1_trace']} / {rows['config2_trace']}", flush=True)

    # the flagship-width array, with the reference's gaps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psrs = fp.make_fake_array(npsrs=100, Tobs=15.0, ntoas=780,
                              isotropic=True, gaps=True, toaerr=1e-7,
                              pdist=1.0, backends=["NUPPI"], seed=FACADE_SEED,
                              device="cuda")
    torch.cuda.synchronize()
    rows["make_fake_array_s"] = time.perf_counter() - t0
    kept = np.array([len(p.toas) for p in psrs])
    rows["kept_toas"] = {"min": int(kept.min()), "mean": float(kept.mean()),
                         "max": int(kept.max())}
    for p in psrs[:10]:
        # what the red and DM signals leave is the white draw: its spread
        # within 20% of the noisedict's sigma (efac 1, tnequad 1e-8 s)
        white = p.residuals - p.reconstruct_signal(["red_noise", "dm_gp"])
        sigma = np.sqrt(np.mean(p.toaerrs ** 2) + 1e-16)
        if not (np.isfinite(white).all()
                and abs(white.std() / sigma - 1) < 0.2):
            raise AssertionError(f"make_fake_array: {p.name} white part "
                                 f"{white.std():.3e} s, expected {sigma:.3e}")
    print(f"facade: make_fake_array(npsrs=100, ntoas=780, gaps) "
          f"{rows['make_fake_array_s']:.3f} s, kept TOAs {rows['kept_toas']}",
          flush=True)

    # the pickle round trip
    path = os.path.join(HERE, "build", "facade", "psrs.pkl")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    t0 = time.perf_counter()
    fio.save_array(psrs, path)
    loaded = fio.load_array(path, device="cuda")
    rows["pickle_roundtrip_s"] = time.perf_counter() - t0
    for a, b in zip(loaded, psrs):
        if a.name != b.name or not np.array_equal(
                a.residuals, np.asarray(b.residuals, np.float64)):
            raise AssertionError(f"pickle round trip: {b.name} changed")
    loaded[0].add_red_noise(log10_A=-14.0, gamma=13 / 3, seed=3)
    if not loaded[0]._res_dev.is_cuda:
        raise AssertionError("a loaded pulsar injected off the card")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)

    # the example's copy_array replay, on the card and on the CPU
    data = os.path.join(HERE, "examples", "simulated_data")
    nd = fio.load_noisedict(os.path.join(data, "noisedict_example.json"))
    cm = fio.load_custom_models(os.path.join(data,
                                             "custom_models_example.json"))
    replays = {}
    for dev in ("cuda", "cpu"):
        src = fp.make_fake_array(npsrs=8, Tobs=10.0, ntoas=100,
                                 isotropic=True, toaerr=1e-6, seed=1234,
                                 device=dev)
        if {p.name for p in src} != set(cm):
            raise AssertionError("the shipped custom models name other "
                                 "pulsars")
        cp = fp.copy_array(src, nd, cm, seed=42, device=dev)
        for p in cp:
            p.make_ideal()
            p.add_white_noise()
            p.add_red_noise()
            p.add_dm_noise()
        replays[dev] = cp
    worst = 0.0
    for a, b in zip(replays["cuda"], replays["cpu"]):
        ra, rb = a.residuals, b.residuals
        worst = max(worst, float(np.abs(ra - rb).max() / np.abs(rb).max()))
    if worst > 1e-5:
        raise AssertionError(f"copy_array replay: card vs CPU {worst:.3e} "
                             f"of scale")
    rows["replay_card_vs_cpu_over_scale"] = worst
    print(f"facade: pickle round trip {rows['pickle_roundtrip_s']:.3f} s "
          f"(residuals equal); copy_array replay of the shipped JSONs, "
          f"card vs CPU {worst:.3e} of scale", flush=True)

    # the array through the engine: every path, both precisions, and a
    # 2-shard mega mesh, held to the einsum run
    batch = PulsarBatch.from_pulsars(psrs, device="cuda")
    gwb = facade_gwb(batch)
    P, T = batch.npsr, batch.max_toa
    sims = {p: EnsembleSimulator(batch, gwb=gwb, stat_path=p.split("-")[0],
                                 pallas_mxu_binning=p != "fused-vpu",
                                 device="cuda")
            for p in ("einsum", "fused", "fused-vpu", "mega")}
    print(f"facade batch: P={P} T={T}, "
          f"{float(batch.mask.float().mean()):.4f} of the TOA slots valid",
          flush=True)
    ref, row = yardstick("facade", sims.pop("einsum"), nreal=FACADE_NREAL)
    rows["einsum/f32"] = row
    rows.update(drive_paths(report, "facade", sims, ref,
                            shape_tag(P, P, T), nreal=FACADE_NREAL))
    mesh_sim = EnsembleSimulator(batch, gwb=gwb, stat_path="mega",
                                 mesh=make_mesh(["cuda:0"] * 2,
                                                psr_shards=2))
    rows.update({f"x2/{k}": v for k, v in drive_paths(
        report, "facade psr_shards=2", {"mega": mesh_sim}, ref,
        shape_tag(P // 2, P, T), nreal=FACADE_NREAL, tol=MESH_TOL,
        shards=2).items()})
    measure_kernels(report, sims["fused"], (P // 2,), "facade kernels")

    # the same batch at T % 4 != 0: the kernels at their scalar staging
    n_max = int(batch.mask.sum(1).max())
    width = n_max + 1 if n_max % 4 == 0 else n_max
    odd = trim_toas(batch, width)
    odd_sims = {p: EnsembleSimulator(odd, gwb=gwb, stat_path=p.split("-")[0],
                                     pallas_mxu_binning=p != "fused-vpu",
                                     device="cuda")
                for p in ("einsum", "fused", "fused-vpu", "mega")}
    odd_ref, row = yardstick(f"facade T={width}", odd_sims.pop("einsum"),
                             nreal=CHUNK)
    rows[f"T{width}/einsum/f32"] = row
    rows.update({f"T{width}/{k}": v for k, v in drive_paths(
        report, f"facade T={width}", odd_sims, odd_ref,
        shape_tag(P, P, width), nreal=CHUNK, precs=("f32",)).items()})
    measure_kernels(report, odd_sims["fused"], (P // 2,),
                    f"facade kernels T={width}")

    # a small facade array on the card against the CPU engine
    small = PulsarBatch.from_pulsars(replays["cpu"], n_red=50, n_dm=110,
                                     device="cpu")
    sgwb = facade_gwb(small)
    cpu = EnsembleSimulator(small, gwb=sgwb, stat_path="einsum",
                            device="cpu").run(64, seed=3, chunk=32)
    for path in ("fused", "fused-vpu", "mega"):
        gpu = EnsembleSimulator(small.to("cuda"), gwb=sgwb,
                                stat_path=path.split("-")[0],
                                pallas_mxu_binning=path != "fused-vpu",
                                device="cuda").run(64, seed=3, chunk=32,
                                                   precision="f32")
        compare((gpu["curves"], gpu["autos"]),
                (cpu["curves"], cpu["autos"]), "f32",
                f"replayed array: cuda {path} vs cpu einsum")
    report["facade"] = rows


#: the correlated phase: realizations per run on config 3's batch, and the
#: joint-covariance draw's array (16 pulsars x 400 TOAs: a 6400 x 6400
#: host float64 Cholesky)
CORR_NREAL = 2048
GP_ARRAY = (16, 400)


def config3_array(device: str):
    """BASELINE config 3's array (benchmarks/suite.py:193): 45 pulsars of
    780 TOAs over 15 years, sigma 1e-7 s."""
    from fakepta_tpu_torch import constants as const
    from fakepta_tpu_torch import fake_pta as fp
    return [fp.Pulsar(np.linspace(0, 15 * const.yr, 780), 1e-7,
                      np.arccos(np.cos(0.07 * k * np.pi)),
                      0.41 * k % (2 * np.pi), seed=k, device=device)
            for k in range(45)]


def config3_injection(psrs, seed: int = 3):
    """Config 3's HD background (A = 2e-15, gamma = 13/3, 30 bins)."""
    from fakepta_tpu_torch import correlated_noises as cn
    return cn.add_common_correlated_noise(
        psrs, orf="hd", log10_A=float(np.log10(2e-15)), gamma=13 / 3,
        seed=seed)


def worst_over_scale(a_psrs, b_psrs) -> float:
    """Max over pulsars of max|res_a - res_b| over max|res_b|."""
    worst = 0.0
    for a, b in zip(a_psrs, b_psrs):
        ra, rb = a.residuals, b.residuals
        if not np.isfinite(ra).all():
            raise AssertionError(f"{a.name}: non-finite residuals")
        worst = max(worst, float(np.abs(ra - rb).max() / np.abs(rb).max()))
    return worst


def phase_correlated(report: dict) -> None:
    """The facade's correlated signals on the card (module docstring,
    phase 10)."""
    import torch
    from fakepta_tpu_torch import correlated_noises as cn
    from fakepta_tpu_torch import fake_pta as fp
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.ephemeris import Ephemeris
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    from fakepta_tpu_torch.utils import io as fio

    rows = {}
    # -- config 3: the batched whole-array path, re-injected --------------
    psrs3 = config3_array("cuda")
    rows["config3_injections_per_s"] = injection_rate(
        lambda: config3_injection(psrs3), 1, 20)
    check_gp_consistent(psrs3, ["gw_common"], "config 3", updates=21)
    rows["config3_trace"] = injection_trace(lambda: config3_injection(psrs3))
    # the same draw replayed on the CPU from the same seed
    card, host = config3_array("cuda"), config3_array("cpu")
    config3_injection(card)
    config3_injection(host)
    rows["config3_card_vs_cpu_over_scale"] = worst_over_scale(card, host)
    coef = max(float(np.abs(a.signal_model["gw_common"]["fourier"]
                            - b.signal_model["gw_common"]["fourier"]).max()
                     / np.abs(b.signal_model["gw_common"]["fourier"]).max())
               for a, b in zip(card, host))
    rows["config3_coefficients_card_vs_cpu_rel"] = coef
    if rows["config3_card_vs_cpu_over_scale"] > 1e-5 or coef > 1e-5:
        raise AssertionError(f"config 3 card vs CPU: {rows}")
    print(f"correlated: config 3 {rows['config3_injections_per_s']:.2f} HD "
          f"GWB injections/s (45 pulsars x 780 TOAs, batched path, "
          f"re-injected); traced call {rows['config3_trace']}; card vs CPU "
          f"residuals {rows['config3_card_vs_cpu_over_scale']:.3e} of scale,"
          f" coefficients {coef:.3e} relative", flush=True)

    # -- a ragged make_fake_array of 45: the per-pulsar fallback ----------
    ragged = fp.make_fake_array(npsrs=45, Tobs=15.0, ntoas=780,
                                isotropic=True, gaps=True, toaerr=1e-7,
                                seed=45, device="cuda")
    for p in ragged:
        p.make_ideal()
    rows["ragged45_injections_per_s"] = injection_rate(
        lambda: config3_injection(ragged), 1, 5)
    check_gp_consistent(ragged, ["gw_common"], "ragged 45", updates=6)
    print(f"correlated: make_fake_array(npsrs=45, gaps) "
          f"{rows['ragged45_injections_per_s']:.2f} HD GWB injections/s "
          f"(ragged TOAs, per-pulsar path, re-injected)", flush=True)

    # -- config 4: 100 pulsars, DM + GWB + BayesEphem Roemer --------------
    from fakepta_tpu_torch import constants as const
    ephem = Ephemeris()
    t0 = time.perf_counter()
    psrs4 = [fp.Pulsar(np.linspace(0, 15 * const.yr, 780), 1e-7,
                       np.arccos(1 - 2 * ((k + 0.5) / 100)),
                       2.39996 * k % (2 * np.pi), seed=k, ephem=ephem,
                       device="cuda") for k in range(100)]
    rows["config4_array_s"] = time.perf_counter() - t0
    jup = ephem.planets["jupiter"]["mass"]

    def config4():
        fp.add_noise_array(psrs4, signal="dm_gp", spectrum="powerlaw",
                           log10_A=-13.8, gamma=3.0, seed=4)
        cn.add_common_correlated_noise(psrs4, orf="hd",
                                       log10_A=float(np.log10(2e-15)),
                                       gamma=13 / 3, seed=5)
        cn.add_roemer_delay(psrs4, "jupiter", d_mass=1e-4 * jup)

    rows["config4_injections_per_s"] = injection_rate(config4, 1, 5)
    rows["config4_trace"] = injection_trace(config4)
    for p in psrs4:
        if not np.isfinite(p.residuals).all():
            raise AssertionError(f"config 4: {p.name} non-finite")
    print(f"correlated: config 4 {rows['config4_injections_per_s']:.3f} "
          f"full-array injections/s (100 pulsars x 780 TOAs: DM + HD GWB + "
          f"Jupiter Roemer; the array with its ephemeris built in "
          f"{rows['config4_array_s']:.2f} s); traced call "
          f"{rows['config4_trace']}", flush=True)

    # -- the joint-covariance draw, then its factorized replacement -------
    npsr, ntoa = GP_ARRAY
    gp = {}
    for side, dev in (("card", "cuda"), ("host", "cpu")):
        gp[side] = [fp.Pulsar(np.linspace(0, 10 * const.yr, ntoa), 1e-7,
                             np.arccos(1 - 2 * ((k + 0.5) / npsr)),
                             2.39996 * k % (2 * np.pi), seed=k, device=dev)
                   for k in range(npsr)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cn.add_common_correlated_noise_gp(gp["card"], orf="hd", log10_A=-14.7,
                                      gamma=13 / 3, seed=6)
    torch.cuda.synchronize()
    rows["gp_draw_s"] = time.perf_counter() - t0
    cn.add_common_correlated_noise_gp(gp["host"], orf="hd", log10_A=-14.7,
                                      gamma=13 / 3, seed=6)
    for a, b in zip(*gp.values()):
        if not np.array_equal(a.signal_model["gw_common"]["realization"],
                              b.signal_model["gw_common"]["realization"]):
            raise AssertionError("the joint-covariance draw differs "
                                 "between card and CPU")
    check_gp_consistent(gp["card"], ["gw_common"], "gp draw")
    for psrs in gp.values():
        config3_injection(psrs, seed=7)         # replaces the realization
    check_gp_consistent(gp["card"], ["gw_common"], "gp replaced", updates=2)
    rows["gp_card_vs_cpu_over_scale"] = worst_over_scale(gp["card"],
                                                         gp["host"])
    if rows["gp_card_vs_cpu_over_scale"] > 1e-5:
        raise AssertionError(f"gp replacement card vs CPU: {rows}")
    print(f"correlated: add_common_correlated_noise_gp on {npsr} x {ntoa} "
          f"TOAs ({npsr * ntoa} x {npsr * ntoa} host float64 Cholesky) "
          f"{rows['gp_draw_s']:.2f} s, bit-equal to the CPU's; replaced by "
          f"the factorized draw, card vs CPU "
          f"{rows['gp_card_vs_cpu_over_scale']:.3e} of scale", flush=True)

    # -- the example's flow (examples/make_fake_array.py:84) and a pickle -
    path = os.path.join(HERE, "build", "correlated", "psrs.pkl")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    ex = fp.make_fake_array(npsrs=25, Tobs=10.0, ntoas=400, isotropic=True,
                            gaps=True, toaerr=1e-7, pdist=1.0,
                            backends=["NUPPI"], seed=84, device="cuda")
    for p in ex:
        p.make_ideal()
        p.add_white_noise()
        for add in (p.add_red_noise, p.add_dm_noise, p.add_chromatic_noise):
            add(log10_A=-14.0, gamma=3.0)
    cn.add_common_correlated_noise(ex, log10_A=-15.0, gamma=13 / 3,
                                   orf="hd", seed=84)
    cgw = dict(costheta=0.12, phi=3.2, cosinc=0.3, log10_mc=9.2,
               log10_fgw=-8.3, log10_h=-13.5, phase0=1.6, psi=1.2)
    for p in ex:
        p.add_cgw(psrterm=True, **cgw)
    fio.save_array(ex, path)
    loaded = {side: fio.load_array(path, device=dev)
              for side, dev in (("card", "cuda"), ("host", "cpu"))}
    for a, b in zip(loaded["card"], ex):
        if not np.array_equal(a.residuals, np.asarray(b.residuals,
                                                      np.float64)):
            raise AssertionError(f"pickle round trip: {b.name} changed")
    worst = 0.0
    for psrs in loaded.values():
        before = [p.residuals for p in psrs]
        old = [p.reconstruct_signal(["gw_common"]) for p in psrs]
        cn.add_common_correlated_noise(psrs, log10_A=-14.5, gamma=13 / 3,
                                       orf="hd", seed=85)
        for p, r0, o in zip(psrs, before, old):
            new = p.reconstruct_signal(["gw_common"])
            d = (p.residuals - r0) - (new - o)
            worst = max(worst, float(np.abs(d).max() / np.abs(r0).max()))
    rows["example_reinjection_over_scale"] = worst
    rows["example_card_vs_cpu_over_scale"] = worst_over_scale(
        loaded["card"], loaded["host"])
    if worst > 1e-5 or rows["example_card_vs_cpu_over_scale"] > 1e-5:
        raise AssertionError(f"the example's flow: {rows}")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    print(f"correlated: the example's flow (25 pulsars, noises, GWB, CGW) "
          f"through save_array / load_array, the GWB re-injected on the "
          f"loaded arrays: residual change = signal change within "
          f"{worst:.3e} of scale, card vs CPU "
          f"{rows['example_card_vs_cpu_over_scale']:.3e}", flush=True)

    # -- config 3's array through the engine, fused and mega --------------
    with warnings.catch_warnings():
        # the engine draws the background from its GWBConfig, not from the
        # pulsars' stored entries (from_pulsars says so per pulsar)
        warnings.simplefilter("ignore", UserWarning)
        batch = PulsarBatch.from_pulsars(psrs3, device="cuda")
    gwb = facade_gwb(batch)
    P, T = batch.npsr, batch.max_toa
    sims = {p: EnsembleSimulator(batch, gwb=gwb, stat_path=p,
                                 device="cuda")
            for p in ("einsum", "fused", "mega")}
    ref, rows["engine einsum/f32"] = yardstick(
        "correlated config 3 batch", sims.pop("einsum"), nreal=CORR_NREAL)
    rows.update({f"engine {k}": v for k, v in drive_paths(
        report, "correlated config 3 batch", sims, ref, shape_tag(P, P, T),
        nreal=CORR_NREAL).items()})
    measure_kernels(report, sims["fused"], (), "correlated kernels")
    report["correlated"] = rows


#: the likelihood phase: the flagship model's grid (red and DM at the
#: batch's own PSDs, a 30-bin CURN with free amplitude and slope: 2M = 320
#: GP columns per pulsar) and the float32 lane bound: LANE_ULPS float32 ULP
#: of U, the magnitudes the lane's float32 sums add
#: (tests/test_torch_infer_engine.py derives it)
INFER_GRID = (5, 5)
LANE_ULPS = 4
EPS32 = float(np.finfo(np.float32).eps)
#: the float64 oracle: relative bound, and the theta points (pulsar p at
#: point p % 3)
ORACLE_RTOL = 1e-9
ORACLE_POINTS = (0, 12, 24)


def flagship_model():
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         LikelihoodSpec)
    return LikelihoodSpec(components=(
        ComponentSpec("red", spectrum="batch"),
        ComponentSpec("dm", spectrum="batch"),
        ComponentSpec("curn", nbin=30, free=(
            FreeParam("log10_A", (-15.3, -14.1)),
            FreeParam("gamma", (2.0, 6.0))))))


def lane_unit(sim, spec, seed: int, nreal: int) -> float:
    """eps32 times U for ``sim``'s run at ``seed``: the largest
    white-weighted residual power of a realization in the run, plus
    sum |ln sigma2|, plus the largest over theta of sum (|ln phi| + 2
    |ln L_jj|), in float64 on the card."""
    import torch
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.infer import build
    from fakepta_tpu_torch.ops import woodbury
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng
    b64 = PulsarBatch.from_numpy(sim.batch.numpy(), device="cuda",
                                 dtype=torch.float64)
    w = woodbury._masked_weights(b64.sigma2, b64.mask)
    power = 0.0
    with torch.no_grad():
        for c in range(0, nreal, CHUNK):
            res = sim._residuals(_chunk_keys(rng.key(seed, device="cuda"),
                                             c, CHUNK)).double()
            power = max(power, float((w * res ** 2).sum((-1, -2)).max()))
            del res
    lndet_n = float(torch.where(b64.mask, b64.sigma2.log().abs(),
                                torch.zeros_like(b64.sigma2)).sum())
    compiled = build(spec.model, b64)
    M = woodbury.finish_fixed(woodbury.fixed_parts(
        compiled.basis(b64), b64.sigma2, b64.mask))[0]
    norm = 0.0
    for t in np.atleast_2d(spec.theta):
        phi = compiled.phi(torch.as_tensor(t, device="cuda"), b64)
        chol, _ = woodbury.lnlike_factors(M, phi)
        diag = torch.diagonal(chol, dim1=-2, dim2=-1)
        phi = torch.clamp(phi, min=woodbury._phi_floor(phi.dtype))
        norm = max(norm, float(phi.log().abs().sum()
                               + 2 * diag.log().abs().sum()))
    return EPS32 * (power + lndet_n + norm)


def lane_compare(got: dict, want: dict, unit: float, what: str,
                 keys=("lnl",)) -> dict:
    """The likelihood lanes against a reference's within LANE_ULPS * unit
    (grad: times 2 ln 10), the theta differences lnl - lnl[:, :1] too;
    raises past the bound."""
    bound = LANE_ULPS * unit
    row = {}
    for k in keys:
        g, w = got["lnlike"][k], want["lnlike"][k]
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError(f"{what} {k}: shape {g.shape} or "
                                 f"non-finite values")
        row[f"{k}_max_abs_err"] = float(np.abs(g - w).max())
        scale = 2 * np.log(10.0) if k == "grad" else 1.0
        if row[f"{k}_max_abs_err"] > bound * scale:
            raise AssertionError(f"{what} {k}: {row} over {bound * scale}")
    g, w = got["lnlike"]["lnl"], want["lnlike"]["lnl"]
    row["theta_diff_max_abs_err"] = float(np.abs(
        (g - g[:, :1]) - (w - w[:, :1])).max())
    if row["theta_diff_max_abs_err"] > bound:
        raise AssertionError(f"{what} theta differences: {row} over {bound}")
    lnl_max = float(np.abs(w).max())
    row.update(bound=bound, max_abs_lnl=lnl_max,
               bound_over_max_lnl=bound / lnl_max)
    print(f"  {what}: lnl max|d| {row['lnl_max_abs_err']:.4g}, theta diffs "
          f"{row['theta_diff_max_abs_err']:.4g} (bound {bound:.4g} = "
          f"{LANE_ULPS} ULP of U, {bound / lnl_max:.3e} of max|lnl| "
          f"{lnl_max:.6g})", flush=True)
    return row


def lane_runs(report: dict, label: str, sims: dict, ref, spec, unit: float,
              shape: str, nreal: int = NREAL, shards: int = 1,
              precs=("f32", "bf16"), rtol=None) -> dict:
    """The main path with the likelihood lane: each ``sims[path]`` at each
    precision after a one-chunk warm-up, timed, rerun and held to ``ref``
    (curves and autos at TOL[prec] of the einsum run, lanes within the
    lane bound); the rerun bit-identical, lanes included; the path's
    kernel launched ``shards`` times per chunk (counts zeroed just before,
    read just after); then the same run without the lane, timed.
    ``rtol``: :func:`compare`'s elementwise bound (the toa rows')."""
    kernels = PATH_KERNEL if shards == 1 else SHARDED_KERNEL
    nchunks = -(-nreal // CHUNK)
    rows = {}
    for path, sim in sims.items():
        for prec in precs:
            reset_counts()
            sim.run(CHUNK, seed=99, chunk=CHUNK, precision=prec,
                    lnlike=spec)
            out, dt = timed_run(sim, nreal, prec, lnlike=spec)
            again = sim.run(nreal, seed=1, chunk=CHUNK, precision=prec,
                            lnlike=spec)
            moved = {k: v for k, v in counts().items() if v}
            want = ({kernels[path]: shards * (1 + 2 * nchunks)}
                    if path in kernels else {})
            if moved != want:
                raise AssertionError(f"{label} {path} [{prec}] launched "
                                     f"{moved}, expected {want}")
            add_launches(report, shape, moved)
            row = compare((out["curves"], out["autos"]),
                          (ref["curves"], ref["autos"]), prec,
                          f"{label} {path} vs einsum",
                          tol=MESH_TOL[prec] if shards > 1 else None,
                          rtol=rtol, ntoa=sim.batch.max_toa)
            row.update(lane_compare(out, ref, unit,
                                    f"{label} {path} [{prec}] lanes vs "
                                    f"einsum f32"))
            same = all(np.array_equal(out[k], again[k])
                       for k in ("curves", "autos")) and np.array_equal(
                out["lnlike"]["lnl"], again["lnlike"]["lnl"])
            if not same:
                raise AssertionError(f"{label} {path} [{prec}] rerun is not "
                                     f"bit-identical")
            sim.run(CHUNK, seed=99, chunk=CHUNK, precision=prec)
            _, dt0 = timed_run(sim, nreal, prec)
            reset_counts()
            row.update(realizations_per_s=nreal / dt, wall_s=dt,
                       without_lane_realizations_per_s=nreal / dt0,
                       lane_s_per_chunk=(dt - dt0) / nchunks,
                       kernel_launches=moved, rerun_identical=True,
                       peak_hbm_bytes=again["report"].memory.get(
                           "peak_hbm_bytes"))
            rows[f"{path}/{prec}"] = row
            print(f"{label}: {path} [{prec}] {nreal / dt:.1f} "
                  f"realizations/s with the lane, {nreal / dt0:.1f} "
                  f"without ({1e3 * (dt - dt0) / nchunks:.1f} ms of lane "
                  f"per {CHUNK}-realization chunk), launches {moved}, "
                  f"rerun bit-identical, peak_hbm_bytes "
                  f"{row['peak_hbm_bytes']}", flush=True)
    return rows


def dense_oracle(batch64, W, compiled, theta) -> np.ndarray:
    """(P,) host float64 lnL of the fixed residual ``W`` per pulsar, pulsar
    p at theta point ``p % K``: the dense covariance N + T phi T^T over its
    valid TOAs, Cholesky-factorized (one 780-square factorization a
    pulsar)."""
    import torch
    from scipy.linalg import cho_factor, cho_solve
    tmat = compiled.basis(batch64).cpu().numpy()
    sigma2 = batch64.sigma2.cpu().numpy()
    mask = batch64.mask.cpu().numpy()
    phis = [compiled.phi(torch.as_tensor(t, device=batch64.device),
                         batch64).cpu().numpy() for t in theta]
    out = np.zeros(batch64.npsr)
    for p in range(batch64.npsr):
        v = mask[p]
        T, r = tmat[p][v], W[p][v]
        C = np.diag(sigma2[p][v]) + (T * phis[p % len(theta)][p]) @ T.T
        c = cho_factor(C, lower=True)
        out[p] = -0.5 * (r @ cho_solve(c, r)
                         + 2 * np.log(np.diag(c[0])).sum()
                         + v.sum() * np.log(2 * np.pi))
    return out


def infer_oracle(out: dict, model, theta) -> None:
    """A fixed flagship-width residual in float64: the det lane against
    the dense host oracle, per pulsar at ORACLE_POINTS, and the lane's
    sums against its per-pulsar terms, within ORACLE_RTOL."""
    import torch
    from fakepta_tpu_torch.infer import InferSpec
    from fakepta_tpu_torch.infer import build
    from fakepta_tpu_torch.ops import woodbury
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    from fakepta_tpu_torch.scenarios import registry

    scn = registry.get("flagship_100")
    b64 = scn.batch_parts(dtype=torch.float64, device="cuda")[0]
    W = np.random.default_rng(5).standard_normal(
        tuple(b64.t_own.shape)) * 1e-7
    sim64 = EnsembleSimulator(b64, include=("det",), waveform=W,
                              stat_path="einsum", device="cuda")
    pts = list(ORACLE_POINTS)
    det = sim64.run(8, seed=0, chunk=8, lnlike=InferSpec(
        model=model, theta=theta[pts]))["lnlike"]["lnl"]
    compiled = build(model, b64)
    want = dense_oracle(b64, W, compiled, theta[pts])
    # the lane's own per-pulsar terms, in float64 on the card: each
    # pulsar against the oracle at its point, their sums against the lane
    tmat = compiled.basis(b64)
    M, lndetN, nv, _ = woodbury.finish_fixed(woodbury.fixed_parts(
        tmat, b64.sigma2, b64.mask))
    d0, dT = woodbury.finish_res(woodbury.res_parts(
        torch.as_tensor(W, device="cuda"), tmat, b64.sigma2, b64.mask))
    per_psr = np.stack([woodbury.lnlike_from_moments(
        d0, dT, M, lndetN, nv, compiled.phi(torch.as_tensor(
            t, device="cuda"), b64)).cpu().numpy() for t in theta[pts]])
    mine = per_psr[np.arange(b64.npsr) % len(pts), np.arange(b64.npsr)]
    err_psr = float((np.abs(mine - want) / np.abs(want)).max())
    err_sum = float((np.abs(det - per_psr.sum(1)) / np.abs(det)).max())
    if err_psr > ORACLE_RTOL or err_sum > ORACLE_RTOL \
            or not (det == det[:1]).all():
        raise AssertionError(f"infer float64 oracle: per pulsar {err_psr}, "
                             f"sum {err_sum}")
    out["float64 oracle"] = {"per_pulsar_rel_err": err_psr,
                             "sum_rel_err": err_sum, "rtol": ORACLE_RTOL,
                             "points": pts}
    print(f"infer flagship float64 det lane: each pulsar against the dense "
          f"host oracle at theta point {pts}[p % {len(pts)}] "
          f"{err_psr:.3e}, the lane's sums against its per-pulsar terms "
          f"{err_sum:.3e} relative (bound {ORACLE_RTOL:g})", flush=True)
    del sim64, b64


def phase_infer(report: dict) -> None:
    """The likelihood lane on the card (module docstring, phase 11)."""
    import torch
    from fakepta_tpu_torch.infer import (InferenceRun, InferSpec,
                                         lanes_per_point, theta_grid)
    from fakepta_tpu_torch.obs.report import RunReport
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.parallel.montecarlo import GWBConfig

    out = {}
    t_phase = time.perf_counter()
    steps = out.setdefault("step_s", {})

    def stamp(what: str) -> None:
        """The phase's elapsed seconds at the end of a step."""
        steps[what] = time.perf_counter() - t_phase
        print(f"infer: {what} done at {steps[what]:.1f} s", flush=True)

    model = flagship_model()
    theta = theta_grid(model, INFER_GRID)
    spec = InferSpec(model=model, theta=theta)
    paths = ("einsum", "fused", "fused-vpu", "mega")
    sims = {p: flagship_sim(p.split("-")[0],
                            pallas_mxu_binning=p != "fused-vpu")
            for p in paths}
    yard = sims.pop("einsum")
    if "chunk_stats/f32/" + shape_tag(100, 100, 780) not in report.get(
            "kernels", {}):
        # the lane leaves the kernels' shapes as the kernels phase has
        # them; measured here when that phase did not run
        measure_kernels(report, sims["mega"], (50,), "infer kernels")
    unit = lane_unit(yard, spec, 1, NREAL)
    stamp("sims, kernels and the lane bound")
    ref, out["flagship einsum/f32"] = yardstick("infer flagship", yard,
                                                lnlike=spec)
    shape = shape_tag(100, 100, 780)
    out.update({f"flagship {k}": v for k, v in lane_runs(
        report, "infer flagship", {"einsum": yard, **sims}, ref, spec, unit,
        shape).items()})
    stamp("every path")
    mesh = make_mesh(["cuda:0"] * 2, psr_shards=2)
    msim = flagship_sim("mega", mesh=mesh)
    out.update({f"flagship psr_shards=2 {k}": v for k, v in lane_runs(
        report, "infer flagship psr_shards=2", {"mega": msim}, ref, spec,
        unit, shape_tag(50, 100, 780), shards=2).items()})
    del msim
    tsim = flagship_sim("einsum", mesh=make_mesh(["cuda:0"] * 4,
                                                 psr_shards=2, toa_shards=2))
    out.update({f"flagship psr2xtoa2 {k}": v for k, v in lane_runs(
        report, "infer flagship psr_shards=2 toa_shards=2",
        {"einsum": tsim}, ref, spec, unit, shape, shards=2,
        precs=("f32",), rtol=TOA_RTOL).items()})
    del tsim
    stamp("meshes")
    out["chunk split"] = {
        p: chunk_split(s, p, "infer flagship", lanes=s._prepare_lanes(
            None, spec)) for p, s in (("einsum", yard),
                                      ("fused", sims["fused"]),
                                      ("mega", sims["mega"]))}
    stamp("chunk splits")

    # -- grad and fisher on "fused" at the full chunk --------------------
    fused = sims["fused"]
    for mode in ("grad", "fisher"):
        mspec = InferSpec(model=model, theta=theta, mode=mode)
        got, dt, n = counted(report, shape, "binned_correlation",
                             lambda: fused.run(2 * CHUNK, seed=1,
                                               chunk=CHUNK, lnlike=mspec),
                             want=2)
        lanes_ = got["lnlike"]
        if not all(np.isfinite(v).all() for k, v in lanes_.items()
                   if k in ("lnl", "grad", "fisher")):
            raise AssertionError(f"infer {mode}: non-finite lanes")
        lane_compare({"lnlike": {"lnl": lanes_["lnl"]}},
                     {"lnlike": {"lnl": ref["lnlike"]["lnl"][:2 * CHUNK]}},
                     unit, f"infer flagship fused {mode}: lnl vs einsum")
        row = {"realizations_per_s": 2 * CHUNK / dt, "wall_s": dt,
               "launches": n, "chunk": CHUNK,
               "lanes": lanes_per_point(mode, theta.shape[1]),
               "peak_hbm_bytes": got["report"].memory.get("peak_hbm_bytes")}
        if mode == "fisher":
            H = lanes_["fisher"]
            asym = float(np.abs(H - np.swapaxes(H, -1, -2)).max()
                         / np.abs(H).max())
            row["fisher_asymmetry_rel"] = asym
            if asym > 1e-3:
                raise AssertionError(f"infer fisher: asymmetric by {asym}")
        out[f"flagship fused {mode}"] = row
        print(f"infer flagship fused [{mode}]: {row['realizations_per_s']:.1f}"
              f" realizations/s at chunk {CHUNK} (K = {len(theta)} points, "
              f"{row['lanes']} lanes each), peak_hbm_bytes "
              f"{row['peak_hbm_bytes']}", flush=True)
    del sims, yard, fused, ref
    stamp("grad and fisher")
    torch.cuda.empty_cache()

    # -- the CLI in a subprocess, beside the float64 oracle below (neither
    # is timed) ----------------------------------------------------------
    cli_out = os.path.join(HERE, "build", "infer.jsonl")
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "fakepta_tpu_torch.infer", "run", "--npsr",
         "100", "--ntoa", "780", "--nreal", str(NREAL), "--chunk",
         str(CHUNK), "--out", cli_out], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        infer_oracle(out, model, theta)
        stdout, stderr = cli.communicate(timeout=600)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    if cli.returncode != 0:
        raise AssertionError(f"the likelihood CLI exited {cli.returncode}: "
                             f"{stderr[-2000:]}")
    row = json.loads(stdout.strip().splitlines()[-1])
    rep = RunReport.load(cli_out)
    if rep.meta.get("platform") != "gpu" or rep.meta["lnlike"]["k"] != 25:
        raise AssertionError(f"the CLI's artifact: {rep.meta}")
    out["CLI"] = dict(row, wall_s=time.perf_counter() - t_cli)
    print(f"infer CLI (beside the float64 oracle): exit 0 in "
          f"{out['CLI']['wall_s']:.1f} s, {json.dumps(row)}; artifact loads",
          flush=True)
    stamp("float64 oracle and CLI")

    # -- InferenceRun at the example's at-scale line, and the CLI --------
    from fakepta_tpu_torch import spectrum as spectrum_lib
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         LikelihoodSpec)
    batch = PulsarBatch.synthetic(npsr=100, ntoa=780, tspan_years=15.0,
                                  toaerr=1e-7, n_red=10, n_dm=10,
                                  red_log10_A=-14.5, dm_log10_A=-14.5,
                                  seed=0, device="cuda")
    f = np.arange(1, 11) / float(batch.tspan_common)
    psd = spectrum_lib.powerlaw(f, log10_A=-13.2, gamma=13 / 3).numpy()
    emodel = LikelihoodSpec(components=(
        ComponentSpec("red", spectrum="batch"),
        ComponentSpec("dm", spectrum="batch"),
        ComponentSpec("curn", nbin=10, free=(
            FreeParam("log10_A", (-13.8, -12.6)),
            FreeParam("gamma", (2.0, 6.0))))))
    study = InferenceRun(batch, emodel, gwb=GWBConfig(psd=psd, orf="curn"),
                         grid_shape=INFER_GRID, truth=(-13.2, 13 / 3),
                         include=("white", "red", "dm", "gwb"),
                         device="cuda")
    res, dt, n = counted(report, shape_tag(100, 100, 780),
                         "binned_correlation",
                         lambda: study.run(NREAL, seed=1, chunk=CHUNK),
                         want=NREAL // CHUNK)
    art = study.save(os.path.join(HERE, "build", "infer_study.jsonl"))
    loaded = RunReport.load(art).summary()
    if any(loaded.get(k) != v for k, v in res["summary"].items()):
        raise AssertionError("InferenceRun's artifact does not load with "
                             "its summary")
    out["InferenceRun example"] = dict(
        res["summary"], realizations_per_s=NREAL / dt, launches=n,
        lnlike_evals_per_s_per_chip=loaded["lnlike_evals_per_s_per_chip"])
    print(f"infer InferenceRun (examples/likelihood_grid.py --npsr 100 "
          f"--ntoa 780 --nreal {NREAL}): {NREAL / dt:.1f} realizations/s, "
          f"{n} launches, summary {json.dumps(res['summary'])}", flush=True)
    del study, res
    stamp("InferenceRun")
    report["infer"] = out


# ---------------------------------------------------------------------------
# the recovery default on every run, and the faults and sample phases
# ---------------------------------------------------------------------------

#: the faults phase's runs: the flagship at two chunks (three for the
#: path ladder, one chunk per rung)
FAULT_NREAL = 2048
#: recovery outside the faults phase: every EnsembleSimulator.run of every
#: phase is held to zero degradations and the statistic path it asked for
GUARD = {"faults_allowed": False, "runs": 0}


def guard_runs() -> None:
    """Wrap ``EnsembleSimulator.run`` for this process: every run (the
    phases', and those DetectionRun and InferenceRun make) must report no
    ``faults.degradations``, no ``degraded_path`` and the statistic path it
    asked for, so a broken kernel fails the smoke instead of passing on a
    lower rung of the default recovery ladder. The faults phase, which
    injects the degradations, lifts the check around its own runs."""
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    real = EnsembleSimulator.run

    def run(self, *args, **kw):
        out = real(self, *args, **kw)
        if not GUARD["faults_allowed"]:
            rep = out["report"]
            asked = "einsum" if kw.get("keep_corr") else (
                rep.meta.get("tuned", {}).get("knobs", {}).get("path")
                or self.stat_path)
            deg = rep.counters.get("faults.degradations", 0)
            if deg or "degraded_path" in rep.meta \
                    or out["statistic_path"] != asked:
                raise AssertionError(
                    f"a run degraded: asked for {asked}, ran "
                    f"{out['statistic_path']}, {deg} degradation(s), meta "
                    f"{rep.meta.get('degraded_path')}")
            GUARD["runs"] += 1
        return out

    EnsembleSimulator.run = run


def fault_run(sim, nreal: int, prec: str, plan=None, **kw):
    """One flagship run under the chaos harness's ``plan`` (or none), with
    every kernel count zeroed just before: (output, launches moved)."""
    import torch
    from fakepta_tpu_torch import faults
    reset_counts()
    GUARD["faults_allowed"] = True
    try:
        if plan is None:
            out = sim.run(nreal, seed=1, chunk=CHUNK, precision=prec, **kw)
        else:
            with faults.inject(plan):
                out = sim.run(nreal, seed=1, chunk=CHUNK, precision=prec,
                              **kw)
    finally:
        GUARD["faults_allowed"] = False
    torch.cuda.synchronize()
    return out, {k: v for k, v in counts().items() if v}


def phase_faults(report: dict) -> None:
    """The recovery policy on the card (module docstring, phase 12)."""
    import torch
    from fakepta_tpu_torch import faults

    out = {}
    t_phase = time.perf_counter()
    steps = out.setdefault("step_s", {})

    def stamp(what: str) -> None:
        steps[what] = time.perf_counter() - t_phase
        print(f"faults: {what} done at {steps[what]:.1f} s", flush=True)

    fast = faults.RecoveryPolicy(backoff_s=0.001, max_backoff_s=0.01)
    shape = shape_tag(100, 100, 780)
    mega = flagship_sim("mega")
    ref, moved = fault_run(mega, FAULT_NREAL, "f32")
    add_launches(report, shape, moved)

    # a transient failure at chunk 1's dispatch: the same keys again
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "transient", at=(1,))])
    got, moved = fault_run(mega, FAULT_NREAL, "f32", plan, recovery=fast)
    add_launches(report, shape, moved)
    assert_identical(got, ref, "faults: transient retry on mega")
    if got["report"].counters.get("faults.retries") != 1 or \
            moved != {"chunk_stats": FAULT_NREAL // CHUNK}:
        raise AssertionError(f"faults: transient retry {moved}, "
                             f"{got['report'].counters}")
    out["transient"] = {"retries": 1, "launches": moved}
    print(f"faults transient at mc.dispatch chunk 1 (mega f32): retried "
          f"once, bit-identical, launches {moved}", flush=True)

    # torch's out-of-memory error at a dispatch, from a stub
    real_step, calls = mega.step, []

    def oom_step(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 1.00 GiB (stub)")
        return real_step(*a, **kw)

    mega.step = oom_step
    try:
        got, moved = fault_run(mega, FAULT_NREAL, "f32")
    finally:
        del mega.step
    add_launches(report, shape, moved)
    assert_identical(got, ref, "faults: out-of-memory retry")
    if got["report"].counters.get("faults.retries") != 1:
        raise AssertionError("faults: the out-of-memory error was not "
                             "retried once")
    out["oom"] = {"retries": 1, "launches": moved}
    print("faults torch.OutOfMemoryError at mc.dispatch chunk 1: retried "
          "once after empty_cache, bit-identical", flush=True)
    stamp("retries")

    # the path ladder mega -> fused: chunk 0 on mega, chunks 1-2 on fused;
    # a second kernel failure, on the fused rung, ends the run, and so does
    # the port's own launch error on a fused run (no fallback to einsum)
    nl = 3 * CHUNK
    for prec in ("f32", "bf16"):
        want, moved = fault_run(mega, nl, prec)
        add_launches(report, shape, moved)
        plan = faults.FaultPlan(
            [faults.FaultSpec("mc.dispatch", "degrade", at=(1,))])
        got, moved = fault_run(mega, nl, prec, plan, recovery=fast)
        add_launches(report, shape, moved)
        rep = got["report"]
        if (got["statistic_path"], got["precision"]) != ("fused", prec) \
                or rep.counters.get("faults.degradations") != 1 \
                or rep.meta.get("degraded_path") != "fused" \
                or moved != {"chunk_stats": 1, "binned_correlation": 2}:
            raise AssertionError(f"faults ladder [{prec}]: "
                                 f"{got['statistic_path']}, {moved}, "
                                 f"{rep.counters}")
        scale = float(np.abs(want["curves"]).max())
        errs = {}
        for rung, (lo, hi) in (("mega", (0, CHUNK)),
                               ("fused", (CHUNK, 3 * CHUNK))):
            errs[rung] = float(np.abs(got["curves"][lo:hi]
                                      - want["curves"][lo:hi]).max()
                               / scale)
            if errs[rung] > TOL[prec]:
                raise AssertionError(f"faults ladder [{prec}] {rung}: "
                                     f"{errs[rung]} of the curve scale")
        if errs["mega"] != 0.0:
            raise AssertionError("faults ladder: the undegraded chunk moved")
        plan = faults.FaultPlan(
            [faults.FaultSpec("mc.dispatch", "degrade", at=(1, 3))])
        try:
            fault_run(mega, nl, prec, plan, recovery=fast)
            raise AssertionError(f"faults ladder [{prec}]: a kernel "
                                 f"failure on the fused rung did not fail")
        except faults.DegradeFault as exc:
            del exc
        out[f"ladder {prec}"] = {"launches": moved, "err_over_scale": errs,
                                 "fused_failure": "raised"}
        print(f"faults ladder [{prec}]: mega -> fused, 1 degradation, "
              f"launches {moved}, each rung against the unfaulted mega run "
              f"{errs} of the curve scale (bound {TOL[prec]:g}); a second "
              f"kernel failure, on fused, raised DegradeFault", flush=True)
    stamp("path ladder")

    # bf16 -> f32 on the fused path
    fused = flagship_sim("fused")
    want, moved = fault_run(fused, FAULT_NREAL, "f32")
    add_launches(report, shape, moved)
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "precision", at=(0,))])
    got, moved = fault_run(fused, FAULT_NREAL, "bf16", plan, recovery=fast)
    add_launches(report, shape, moved)
    assert_identical(got, want, "faults: bf16 -> f32")
    if got["precision"] != "f32" or \
            got["report"].meta.get("degraded_precision") != "f32":
        raise AssertionError("faults: the precision ladder did not step")
    out["precision"] = {"launches": moved}
    print(f"faults precision (fused bf16): stepped to f32, bit-identical "
          f"to the f32 run, launches {moved}", flush=True)

    # the port's own launch error on a fused run, under the default policy:
    # it propagates (a stub raises it; no fallback to the einsum path)
    real_fused = fused.step

    def bad_launch(*a, **kw):
        if a[3] == "fused":
            raise RuntimeError("binned_correlation failed to launch: CUDA "
                               "error 9 (invalid configuration argument) "
                               "(stub)")
        return real_fused(*a, **kw)

    fused.step = bad_launch
    try:
        fault_run(fused, FAULT_NREAL, "f32")
        raise AssertionError("faults: a launch failure on fused did not "
                             "fail")
    except RuntimeError as exc:
        if "failed to launch" not in str(exc):
            raise
    finally:
        del fused.step
    out["fused_launch_failure"] = "raised"
    print("faults: the port's launch error on a fused run (stub) raised "
          "under the default policy", flush=True)

    # poison: loud, with a flight-recorder dump
    dump_dir = os.path.join(HERE, "build", "flightrec_faults")
    shutil.rmtree(dump_dir, ignore_errors=True)
    os.makedirs(dump_dir)
    os.environ["FAKEPTA_TORCH_FLIGHTREC_DIR"] = dump_dir
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "poison", at=(1,))])
    try:
        fault_run(fused, FAULT_NREAL, "f32", plan, recovery=fast)
        raise AssertionError("faults: a poisoned chunk did not fail")
    except FloatingPointError as exc:
        del exc
    finally:
        del os.environ["FAKEPTA_TORCH_FLIGHTREC_DIR"]
    dumps = [f for f in os.listdir(dump_dir) if f.startswith("flightrec-")]
    if not dumps:
        raise AssertionError("faults: the poisoned run left no dump")
    out["poison"] = {"dump": dumps[0]}
    print(f"faults poison at chunk 1: FloatingPointError, flight-recorder "
          f"dump {dumps[0]}", flush=True)

    # a torn checkpoint append, then the resume
    ck = os.path.join(HERE, "build", "faults_ck.npz")
    for f in ckpt_family(ck):
        os.remove(os.path.join(HERE, "build", f))
    plan = faults.FaultPlan(
        [faults.FaultSpec("ckpt.append", "torn", at=(1,))])
    try:
        fault_run(fused, FAULT_NREAL, "f32", plan, recovery=fast,
                  checkpoint=ck)
        raise AssertionError("faults: the torn write did not kill the run")
    except faults.KillFault as exc:
        del exc
    got, moved = fault_run(fused, FAULT_NREAL, "f32", recovery=fast,
                           checkpoint=ck)
    assert_identical(got, want, "faults: torn checkpoint resume")
    if got["report"].counters.get("faults.rollbacks") != 1 or \
            ckpt_family(ck):
        raise AssertionError("faults: the torn chunk was not rolled back")
    out["torn"] = {"rollbacks": 1, "launches": moved}
    print("faults torn ckpt.append at chunk 1: KillFault, resume rolled "
          "back one chunk, bit-identical", flush=True)

    # a hung writer under the watchdog
    plan = faults.FaultPlan(
        [faults.FaultSpec("pipeline.writer", "hang", at=(0,), hang_s=2.0)])
    t0 = time.perf_counter()
    try:
        fault_run(fused, FAULT_NREAL, "f32", plan,
                  recovery=faults.RecoveryPolicy(watchdog_s=0.25))
        raise AssertionError("faults: a hung drain did not time out")
    except faults.WatchdogTimeout as exc:
        del exc
    out["watchdog"] = {"deadline_s": 0.25,
                       "abort_s": time.perf_counter() - t0}
    print(f"faults writer hang: WatchdogTimeout at the 0.25 s deadline "
          f"({out['watchdog']['abort_s']:.2f} s with the hung thread's "
          f"join)", flush=True)
    stamp("precision, poison, torn, watchdog")
    report["faults"] = out


# the sample phase: the flagship likelihood model at full width, the step
# counts cut (SAMPLE_SPEC, SAMPLE_POST, MESH_POST)
SAMPLE_SPEC = dict(n_chains=16, n_temps=2, n_leapfrog=8, warmup=16, thin=2)
SAMPLE_POST = 16
SAMPLE_SEGMENT = 16
SAMPLE_MESH_POST = 4
FS_POST = 4
# the sampler CLI's (steps, warmup): half its defaults (400, 200), which
# set the phase's end
SAMPLE_CLI_STEPS = (200, 100)
#: chains of the card-against-CPU transition (each with both rungs)
CARD_CPU_CHAINS = 4


def sample_unit(study, theta) -> tuple:
    """(U_lnl, U_grad): eps32 times the magnitudes a float32 lnL and its
    whitened gradient add at ``theta``, from host float64 per-pulsar terms
    (the lane bound of tests/lane_bound.py, for the sampler's sums)."""
    import torch
    from fakepta_tpu_torch.ops import woodbury
    m, lndet, nv, d0, dt = (torch.as_tensor(x) for x in study._mom64)
    phi = study.compiled.phi(torch.as_tensor(theta), study._nsb64)
    chol, lnnorm = woodbury.lnlike_factors(m, phi)
    y = torch.linalg.solve_triangular(chol, dt[..., None], upper=False)
    quad = (y[..., 0] ** 2).sum(-1)
    phi = torch.clamp(phi, min=woodbury._phi_floor(phi.dtype))
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    mag = (d0.abs() + quad.abs() + lndet.abs() + phi.log().abs().sum(-1)
           + 2 * diag.log().abs().sum(-1) + nv * woodbury.LN_2PI)
    eps32 = float(np.finfo(np.float32).eps)
    # phi_j d lnL / d phi_j = -1/2 (1 - S^-1_jj / phi_j - b_j^2 / phi_j),
    # b = S^-1 dT: the magnitudes of its three terms, carried to the
    # whitened z by |d ln phi / d theta| <= 2 ln 10, |d theta / d v| <=
    # (hi - lo) / 4 and the largest column sum of C
    sdiag = torch.diagonal(torch.cholesky_inverse(chol), dim1=-2, dim2=-1)
    b = torch.cholesky_solve(dt[..., None], chol)[..., 0]
    terms = 0.5 * (1.0 + sdiag / phi + b * b / phi)
    bounds = np.asarray(study.compiled.bounds)
    scale = (2 * np.log(10.0) * float((bounds[:, 1] - bounds[:, 0]).max())
             / 4 * float(np.abs(study.chol_cov).sum(0).max()))
    return eps32 * float(mag.sum()), eps32 * float(terms.sum()) * scale


def phase_sample(report: dict) -> None:
    """The sampler on the card (module docstring, phase 13)."""
    import dataclasses
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         LikelihoodSpec)
    from fakepta_tpu_torch.obs.report import RunReport
    from fakepta_tpu_torch.ops import mcmc
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.sample import (FactorizedRun, FactorizedSpec,
                                          SampleSpec, SamplingRun)
    from fakepta_tpu_torch.scenarios import registry
    from fakepta_tpu_torch.tune import defaults as tune_defaults
    from fakepta_tpu_torch.utils import rng

    out = {"cuts": {"post_steps": SAMPLE_POST, "warmup": 16,
                    "segment": SAMPLE_SEGMENT, "mesh_post_steps":
                    SAMPLE_MESH_POST, "factorized_post_steps": FS_POST,
                    "widths": "flagship_100 uncut: 100 pulsars x 780 TOAs, "
                              "2M = 320 columns"}}
    t_phase = time.perf_counter()
    steps = out.setdefault("step_s", {})

    def stamp(what: str) -> None:
        steps[what] = time.perf_counter() - t_phase
        print(f"sample: {what} done at {steps[what]:.1f} s", flush=True)

    print(f"sample cuts: {json.dumps(out['cuts'])}", flush=True)
    batch = registry.get("flagship_100").batch_parts(device="cuda")[0]
    spec = SampleSpec(model=flagship_model(), **SAMPLE_SPEC)
    t0 = time.perf_counter()
    study = SamplingRun(batch, spec, device="cuda", data_seed=1)
    out["laplace_s"] = time.perf_counter() - t0
    out["laplace_iters"] = study.laplace_iters
    print(f"sample flagship: data, moments and Laplace fit in "
          f"{out['laplace_s']:.2f} s ({study.laplace_iters} Newton steps, "
          f"host float64), mode {study.mode_theta.tolist()}", flush=True)
    stamp("staging and Laplace")

    kw = dict(seed=1, segment=SAMPLE_SEGMENT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = study.run(SAMPLE_POST, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = a["report"].meta["sample"]["steps"]
    if not np.isfinite(a["theta"]).all() or a["theta"].shape != (
            SAMPLE_POST // 2, 16, 2):
        raise AssertionError(f"sample: draws {a['theta'].shape}")
    row = {"wall_s": wall, "steps": total, "steps_per_s": total / wall,
           "chain_steps_per_s": total * 32 / wall,
           "summary": a["summary"],
           "peak_hbm_bytes": a["report"].memory.get("peak_hbm_bytes")}
    stamp("run")

    # one gradient evaluation, and one traced two-step segment
    vg = study._vg(0)
    state = study._init_state(1)
    z = state["z"]
    row["ms_per_grad_eval"] = time_ms(lambda: vg(z), 5, warmup=1)
    base = rng.key(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        study._segment(state, base, 0, 2, 16)
        torch.cuda.synchronize()
    traced_wall = time.perf_counter() - t0
    busy, launches = 0.0, 0
    for ev in p.events():
        if ev.device_type == DeviceType.CUDA:
            busy += ev.time_range.elapsed_us() / 1e3
            launches += 1
    row["traced_segment"] = {
        "steps": 2, "wall_ms": 1e3 * traced_wall, "device_busy_ms": busy,
        "kernel_launches": launches,
        "launches_per_leapfrog_step": launches / (2 * spec.n_leapfrog),
        "device_idle_share": max(0.0, 1.0 - busy / (1e3 * traced_wall))}
    out["flagship"] = row
    print(f"sample flagship (float32, 16 chains x 2 temps, n_leapfrog "
          f"{spec.n_leapfrog}, {total} steps): {row['steps_per_s']:.3f} "
          f"steps/s "
          f"({row['chain_steps_per_s']:.1f} chain steps/s), "
          f"{row['ms_per_grad_eval']:.2f} ms per gradient evaluation, "
          f"{row['traced_segment']['launches_per_leapfrog_step']:.0f} "
          f"launches per leapfrog step, device idle "
          f"{row['traced_segment']['device_idle_share']:.3f} of a traced "
          f"segment, peak_hbm_bytes {row['peak_hbm_bytes']}, summary "
          f"{json.dumps(a['summary'])}", flush=True)
    stamp("gradient timing and traced segment")

    # the CLI at half its default steps, in a subprocess on the card while
    # the invariances, the CPU comparison and the factorized run below go
    # on (its timing shares the host and the card with them)
    cli_out = os.path.join(HERE, "build", "sample.jsonl")
    t_cli = time.perf_counter()
    cli_proc = subprocess.Popen(
        [sys.executable, "-m", "fakepta_tpu_torch.sample", "run", "--out",
         cli_out, "--steps", str(SAMPLE_CLI_STEPS[0]), "--warmup",
         str(SAMPLE_CLI_STEPS[1])], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    try:
        # the invariances at SAMPLE_MESH_POST steps (no warmup, segment of
        # half of them), each study on the staged moments and the fit above:
        # a rerun, a depth-0 checkpointed run cut after one segment and
        # resumed, and the real=2 and psr=2 meshes on cuda:0, each
        # bit-identical to the depth-2 one-shard run
        mspec = dataclasses.replace(spec, warmup=0)
        mkw = dict(seed=2, segment=SAMPLE_MESH_POST // 2)

        def short(mesh=None):
            return SamplingRun(batch, mspec, mesh=mesh,
                               device=None if mesh else "cuda",
                               moments=study._mom64,
                               warm_from=study.laplace_state())

        one = short()
        ref = one.run(SAMPLE_MESH_POST, **mkw)
        inv = {"rerun": one.run(SAMPLE_MESH_POST, **mkw)}
        ck = os.path.join(HERE, "build", "sample_ck.json")
        for f in ckpt_family(ck):
            os.remove(os.path.join(HERE, "build", f))

        def cut(done, total_):
            if done >= SAMPLE_MESH_POST // 2:
                raise Kill

        try:
            one.run(SAMPLE_MESH_POST, checkpoint=ck, pipeline_depth=0,
                    progress=cut, **mkw)
            raise AssertionError("sample: the cut did not cut")
        except Kill as exc:
            del exc
        if not ckpt_family(ck):
            raise AssertionError("sample: the cut run left no checkpoint")
        inv["depth 0, cut and resumed"] = one.run(
            SAMPLE_MESH_POST, checkpoint=ck, pipeline_depth=0, **mkw)
        if ckpt_family(ck):
            raise AssertionError("sample: the resumed run left its files")
        for real, psr in ((2, 1), (1, 2)):
            mesh = make_mesh(["cuda:0"] * (real * psr), psr_shards=psr)
            inv[f"real={real} psr={psr}"] = short(mesh).run(SAMPLE_MESH_POST,
                                                            **mkw)
        same = {k: bool(np.array_equal(v["theta"], ref["theta"])
                        and v["diag"]["accept_rate_by_temp"]
                        == ref["diag"]["accept_rate_by_temp"])
                for k, v in inv.items()}
        out["bit_identical"] = same
        if not all(same.values()):
            raise AssertionError(f"sample: not bit-identical to the one-shard "
                                 f"depth-2 run: {same}")
        print(f"sample invariances ({SAMPLE_MESH_POST} steps, segment "
              f"{SAMPLE_MESH_POST // 2}): {same}", flush=True)
        del one, inv
        stamp("rerun, depth 0 resume and meshes")

        # the card against the CPU in this process: the Laplace mode (the CPU
        # study's own fit of the staged moments), then the first transition's
        # proposal from the same state and momenta
        host = PulsarBatch.from_numpy(batch.numpy(), device="cpu")
        t0 = time.perf_counter()
        cpu = SamplingRun(host, spec, device="cpu", moments=study._mom64)
        out["cpu_laplace_s"] = time.perf_counter() - t0
        mode_err = float(np.abs(cpu.mode_v - study.mode_v).max())
        if mode_err > 1e-9:
            raise AssertionError(f"sample: Laplace mode {mode_err} off the "
                                 f"CPU's")
        keys = rng.fold_in(rng.fold_in(rng.fold_in(rng.fold_in(
            base, 0xA5), 0)[None, :], torch.arange(16, device="cuda"))[
                :, None, :], torch.arange(2, device="cuda"))
        # the first CARD_CPU_CHAINS chains (both rungs): the CPU's float32
        # factorizations take seconds an evaluation at the full 32 rows
        nc = CARD_CPU_CHAINS
        mom, _ = mcmc.transition_draws(keys, 2, torch.float32)
        mom, z = mom[:nc], z[:nc]
        betas, eps = study._rows[0]["betas"], study._rows[0]["eps"]
        parts0 = tuple(state[k][:nc]
                       for k in ("lnl", "glnl", "lnpri", "glnpri"))
        z1, _, p1 = mcmc.leapfrog(vg, z, parts0, mom, eps[None, :, None],
                                  spec.n_leapfrog, betas)
        cvg = cpu._vg(0)
        cz0 = z.cpu()
        cparts = cvg(cz0)
        cz1, _, cp1 = mcmc.leapfrog(cvg, cz0, cparts, mom.cpu(),
                                    eps.cpu()[None, :, None],
                                    spec.n_leapfrog, betas.cpu())
        cstate = dict(zip(("lnl", "glnl", "lnpri", "glnpri"), cparts))

        def err(a, b) -> float:
            """max |a - b| where both are finite; the non-finite entries (a
            trajectory that left float32's range) must be the same ones."""
            a, b = a.cpu(), b
            ok = torch.isfinite(a) & torch.isfinite(b)
            if not torch.equal(ok, torch.isfinite(a)) or \
                    not torch.equal(ok, torch.isfinite(b)):
                raise AssertionError("sample card vs CPU: the non-finite "
                                     "entries differ")
            return float((a - b)[ok].abs().max()) if ok.any() else 0.0

        lnl_err = err(p1[0], cp1[0])
        l0_err = err(state["lnl"][:nc], cstate["lnl"])
        u_lnl, u_g = sample_unit(cpu, cpu.mode_theta)
        # the float64 reference at the same whitened state: the sampler on
        # a float64 copy of the batch, on the staged moments (the host
        # float64 fit warm from the study's mode: the same whitening to
        # 1e-9, far below the float32 errors held), its gradient and its
        # float64 trajectory from the same momenta. The card's float32
        # gradient and proposal are held to it within LANE_ULPS times the
        # float32 error the CPU's float32 run of the same algorithm shows
        # there (A's conditioning enters both alike; U_grad does not see
        # it): a wrong card gradient fails, the float32 floor does not
        b64 = PulsarBatch.from_numpy(
            {k: (v.astype(np.float64) if isinstance(v, np.ndarray)
                 and np.issubdtype(v.dtype, np.floating) else v)
             for k, v in batch.numpy().items()}, device="cuda")
        s64 = SamplingRun(b64, spec, device="cuda", moments=study._mom64,
                          warm_from=study.laplace_state())
        white_err = max(float(np.abs(s64.mode_v - study.mode_v).max()),
                        float(np.abs(s64.chol_cov - study.chol_cov).max()))
        if white_err > 1e-9:
            raise AssertionError(f"sample: the float64 study's whitening is "
                                 f"{white_err} off the float32 study's")
        vg64 = s64._vg(0)
        z64 = z.double()
        parts64 = vg64(z64)
        z1_64, _, p1_64 = mcmc.leapfrog(
            vg64, z64, parts64, mom.double(),
            s64._rows[0]["eps"][None, :, None], spec.n_leapfrog,
            s64._rows[0]["betas"])
        torch.cuda.synchronize()
        del s64, b64

        def rung_err(a, b) -> list:
            """max |a - b| per tempering rung (a, b (C, T, D)), on the
            host in float64, over the entries finite in both (a trajectory
            that left float32's range; err() below holds the card's and
            the CPU's non-finite entries to be the same ones)."""
            a = a.detach().cpu().double()
            b = b.detach().cpu().double()
            d = torch.where(torch.isfinite(a) & torch.isfinite(b),
                            (a - b).abs(), torch.zeros_like(a))
            return [float(x) for x in d.amax(dim=(0, 2))]

        g64 = parts64[1]
        g_card = rung_err(state["glnl"][:nc], g64)
        g_cpu = rung_err(cstate["glnl"], g64)
        g_mag = [float(x) for x in
                 g64.detach().abs().amax(dim=(0, 2)).cpu()]
        z_card = rung_err(z1, z1_64)
        z_cpu = rung_err(cz1, z1_64)
        g_bound = [LANE_ULPS * max(c, u_g) for c in g_cpu]
        # the proposal's floor: the CPU's float32 distance from the
        # float64 trajectory, at least one float32 rounding of z itself
        z_mag = [float(x) for x in
                 z1_64.detach().abs().amax(dim=(0, 2)).cpu()]
        eps32 = float(np.finfo(np.float32).eps)
        z_bound = [LANE_ULPS * max(c, eps32 * m)
                   for c, m in zip(z_cpu, z_mag)]
        z_err = err(z1, cz1)
        out["card_vs_cpu"] = {
            "laplace_mode_err": mode_err, "lnl0_err": l0_err,
            "proposal_finite": int(torch.isfinite(cp1[0]).sum()),
            "proposal_lnl_err": lnl_err, "proposal_z_err": z_err,
            "U_lnl": u_lnl, "U_grad": u_g, "lnl_bound": LANE_ULPS * u_lnl,
            "vs_float64_by_rung": {
                "betas": [float(x) for x in betas.cpu()],
                "glnl_max_abs": g_mag, "glnl_err_card": g_card,
                "glnl_err_cpu": g_cpu, "glnl_bound": g_bound,
                "proposal_z_err_card": z_card,
                "proposal_z_err_cpu": z_cpu, "proposal_z_bound": z_bound}}
        print(f"sample card vs CPU (same batch, float32, chains 0-"
              f"{nc - 1}): Laplace mode "
              f"{mode_err:.2e}; initial lnl {l0_err:.3g}, first proposal's "
              f"lnl {lnl_err:.3g} (bound {LANE_ULPS} U = "
              f"{LANE_ULPS * u_lnl:.3g}); proposal z card - CPU "
              f"{z_err:.3g}", flush=True)
        print(f"sample card vs float64 by rung (betas "
              f"{out['card_vs_cpu']['vs_float64_by_rung']['betas']}): "
              f"initial gradient (max |g| {g_mag}) card {g_card}, CPU "
              f"{g_cpu}, bound {g_bound} (U_grad {u_g:.3g}); first "
              f"proposal's z card {z_card}, CPU {z_cpu}, bound {z_bound}",
              flush=True)
        if max(l0_err, lnl_err) > LANE_ULPS * u_lnl \
                or any(c > b for c, b in zip(g_card, g_bound)) \
                or any(c > b for c, b in zip(z_card, z_bound)):
            raise AssertionError(f"sample card vs CPU and float64: "
                                 f"{out['card_vs_cpu']}")
        del cpu, host
        stamp("card against the CPU")

        # a factorized free-spectrum CURN on the same batch
        fs_model = LikelihoodSpec(components=(
            ComponentSpec("red", spectrum="batch"),
            ComponentSpec("dm", spectrum="batch"),
            ComponentSpec("curn", nbin=30, spectrum="free_spectrum", free=(
                FreeParam("log10_rho", (-9.0, -5.0), per_bin=True),))))
        fs_spec = SampleSpec(model=fs_model, n_chains=16, n_temps=2,
                             n_leapfrog=8, warmup=8, thin=2)
        t0 = time.perf_counter()
        fr = FactorizedRun(batch, FactorizedSpec(fs_spec,
                                                 tune_defaults.FS_LANE_BINS),
                           device="cuda", data_seed=1)
        fs_build = time.perf_counter() - t0
        res = fr.run(FS_POST, seed=1, segment=FS_POST)
        if fr.lane_count != 8 or res["theta"].shape[2] != 30 or \
                not np.isfinite(res["theta"]).all():
            raise AssertionError(f"sample factorized: {fr.lane_count} lanes, "
                                 f"{res['theta'].shape}")
        out["factorized"] = dict(res["summary"], build_s=fs_build)
        print(f"sample factorized 30-bin free spectrum: {fr.lane_count} lanes "
              f"of FS_LANE_BINS = {tune_defaults.FS_LANE_BINS}, built in "
              f"{fs_build:.2f} s, {json.dumps(res['summary'])}", flush=True)
        del fr, res
        stamp("factorized")
    except BaseException:
        cli_proc.kill()
        cli_proc.wait()
        raise

    # the CLI started above
    try:
        stdout, stderr = cli_proc.communicate(timeout=600)
    finally:
        if cli_proc.poll() is None:
            cli_proc.kill()
            cli_proc.wait()
    if cli_proc.returncode != 0:
        raise AssertionError(f"the sampler CLI exited {cli_proc.returncode}"
                             f": {stderr[-2000:]}")
    cli_row = json.loads(stdout.strip().splitlines()[-1])
    rep = RunReport.load(cli_out)
    if rep.meta.get("platform") != "gpu" or not np.isfinite(
            cli_row["rhat_max"]):
        raise AssertionError(f"the sampler CLI's artifact: {rep.meta}")
    out["CLI"] = dict(cli_row, wall_s=time.perf_counter() - t_cli)
    print(f"sample CLI ({SAMPLE_CLI_STEPS[0]} steps after "
          f"{SAMPLE_CLI_STEPS[1]} warm-up, beside the CPU comparison and the "
          f"factorized run): exit 0 in {out['CLI']['wall_s']:.1f} s, "
          f"{json.dumps(cli_row)}; artifact loads", flush=True)
    stamp("CLI")
    report["sample"] = out


# the stream phase: config 14's accelerator shape (benchmarks/suite.py:
# 546-549) and config 18 part 2's (:743-746, :795-836)
STREAM_YR = 365.25 * 86400.0
STREAM_SHAPE = dict(npsr=100, ntoa=780, tspan_years=15.0, n_red=30,
                    n_dm=100, nbin=10, history=780, epoch_width=8,
                    ecorr_dt=15.0 * STREAM_YR / 64)
#: epoch appends after the two history blocks (the first is a warm-up),
#: as many as ``run_append_ab`` makes at its 3 repeats
STREAM_EPOCHS = 4
#: the append-against-restage oracle's bound (JAX tests/test_stream.py:113)
STREAM_ORACLE_RTOL = 1e-8
#: card against the CPU port, and a psr-2 mesh against one shard
STREAM_CPU_RTOL = 1e-10
STREAM_OS_RTOL = 1e-9
#: PosteriorRefresher: float64, 8 chains x 2 temps, n_leapfrog 4; the
#: step counts are the cut
REFRESH_SPEC = dict(n_chains=8, n_temps=2, n_leapfrog=4, warmup=8)
REFRESH_STEPS = 8
REFRESH_SEGMENT = 8
#: FactorizedRefresher at config 18 part 2: 16 pulsars x 96 TOAs, 16
#: free-spectrum bins, lane_bins 1, 40-wide epochs; the suite's warm-up
#: 32, 96 steps and segment 32 cut to 8, 8 and 8 (123.1 s uncut, NVIDIA
#: H100 80GB HBM3, 700.00 W). A lane runs its warmup rounded up to whole
#: segments, then the steps: 8 + 8 = 16 steps a lane here, 32 + 96 = 128
#: uncut
FS_STREAM = dict(npsr=16, ntoa=96, nbin=16, width=40, warmup=8, steps=8,
                 segment=8)


def stream_blocks(shape: dict, seed: int = 0) -> list:
    """Config 14's blocks as ``stream.bench.run_append_ab`` appends them:
    the history in two halves, a warm-up epoch, then STREAM_EPOCHS - 1
    steady epochs of ``epoch_width`` TOAs (append keyword arguments)."""
    from fakepta_tpu_torch.stream.bench import config_blocks
    return config_blocks(npsr=shape["npsr"],
                         tspan_years=shape["tspan_years"],
                         history=shape["history"],
                         epoch_width=shape["epoch_width"],
                         epochs=STREAM_EPOCHS, seed=seed)


def live_bytes() -> int:
    """Bytes of the live tensors on the card as requested, not as the
    caching allocator rounded them: a steady append may get its new ``M``
    in a cached 60 MiB block or an exact 62.72 MB one, which moves
    ``memory_allocated()`` with no change in what is live."""
    import torch
    return int(torch.cuda.memory_stats()["requested_bytes.all.current"])


def dispatched_ops(fn) -> list:
    """The aten ops that ``fn()`` dispatches, in order, each with the
    shape, dtype and device of its tensor arguments: the work the card is
    asked to do, recorded on the host as it is asked for, so no event is
    lost (the profiler's CUDA trace of one steady append counted 39, 45 or
    74 kernels from run to run, NVIDIA H100 80GB HBM3, 700.00 W)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            flat, _ = tree_flatten((args, kwargs))
            ops.append((str(func), tuple(
                (tuple(a.shape), str(a.dtype), a.device.type)
                for a in flat if isinstance(a, torch.Tensor))))
            return func(*args, **kwargs)

    with Record():
        fn()
    return ops


def moments_rel_err(got, want) -> float:
    """Max over the five moment arrays of max|got - want| over max|want|
    (M entries scale like 1/sigma^2 ~ 1e14: absolute bounds mean
    nothing)."""
    worst = 0.0
    for g, w in zip(got, want):
        g = g.detach().cpu().double()
        w = w.detach().cpu().double()
        scale = max(float(w.abs().max()), 1e-300)
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def phase_stream(report: dict) -> None:
    """Streaming ingestion on the card (module docstring, phase 14)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fakepta_tpu_torch import constants as const
    from fakepta_tpu_torch import faults
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         LikelihoodSpec)
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.sample import SampleSpec
    from fakepta_tpu_torch.stream import (FactorizedRefresher,
                                          PosteriorRefresher,
                                          StreamCheckpoint, StreamState,
                                          default_stream_model)
    from fakepta_tpu_torch.stream.bench import run_append_ab

    card = card_line()
    shape = dict(STREAM_SHAPE)
    out = {"cuts": {"refresh": dict(REFRESH_SPEC, n_steps=REFRESH_STEPS,
                                    segment=REFRESH_SEGMENT),
                    "factorized": dict(FS_STREAM),
                    "widths": "config 14 uncut: 100 pulsars, 780 TOAs of "
                              "history, C = 280, float64"}}
    t_phase = time.perf_counter()
    steps = out.setdefault("step_s", {})

    def stamp(what: str) -> None:
        steps[what] = time.perf_counter() - t_phase
        print(f"stream: {what} done at {steps[what]:.1f} s", flush=True)

    print(f"stream cuts: {json.dumps(out['cuts'])}", flush=True)

    # config 14's A/B row, as the JAX suite's config14 runs it
    ab = run_append_ab(**shape, device="cuda", seed=0)
    out["append_ab"] = ab
    print(f"stream append A/B (config 14: 100 psr x 780 TOAs of history, "
          f"8-TOA epochs, ECORR 64 epochs, float64) on {card}: best-of-3 "
          f"append {ab['append_latency_ms']} ms, restage "
          f"{ab['restage_ms']} ms, append_speedup_x "
          f"{ab['append_speedup_x']}, rebuckets {ab['stream_rebuckets']}, "
          f"stream_recompiles {ab['stream_recompiles']} (0 by construction: "
          f"a built kernel key is never built again)", flush=True)
    stamp("append A/B")

    # the watched stream: history, then epochs, HD rolling statistic
    template = PulsarBatch.synthetic(
        npsr=shape["npsr"], ntoa=shape["ntoa"],
        tspan_years=shape["tspan_years"], n_red=shape["n_red"],
        n_dm=shape["n_dm"], seed=0, dtype=torch.float64, device="cpu")
    model = default_stream_model(nbin=shape["nbin"])
    kw = dict(ecorr_dt=shape["ecorr_dt"], watch="hd")
    blocks = stream_blocks(shape)

    def drive(stream, upto=None):
        return [stream.append(**b) for b in blocks[:upto]]

    stream = StreamState(template, model, device="cuda", **kw)
    infos, built, alloc = [], [], []
    for b in blocks:
        infos.append(stream.append(**b))
        built.append(stream.compiles)
        alloc.append(live_bytes())
    lat = [i["latency_ms"] for i in infos[3:]]
    m_card = stream.moments()
    # what an append at built rungs does: no kernel build after the
    # warm-up epoch, and the bytes live on the card flat over the steady
    # appends
    steady = {"builds": built[-1] - built[2], "live_bytes": alloc[3:]}
    if steady["builds"] or len(set(alloc[3:])) != 1 \
            or not all(np.isfinite(i["snr"]) for i in infos):
        raise AssertionError(f"stream steady appends: {steady}, "
                             f"{infos[-1]}")
    oracle = moments_rel_err(m_card, stream.restage_moments())
    if oracle > STREAM_ORACLE_RTOL:
        raise AssertionError(f"stream: append vs restage {oracle:.3e}")
    out["watched"] = {"append_watch_ms_best": min(lat),
                      "append_watch_ms": lat,
                      "history_append_ms": [i["latency_ms"]
                                            for i in infos[:2]],
                      "n_toas": infos[-1]["n_toas"],
                      "block_bucket": infos[-1]["block_bucket"],
                      "epoch_capacity": infos[-1]["epoch_capacity"],
                      "stats": stream.stats(), "oracle_rel_err": oracle,
                      "steady": steady}
    print(f"stream watched (hd): append with the OS update best "
          f"{min(lat)} ms of {lat}, history blocks "
          f"{out['watched']['history_append_ms']} ms; steady appends: "
          f"{steady['builds']} kernel builds, live bytes "
          f"{steady['live_bytes']}; append vs restage "
          f"{oracle:.3e} relative (bound {STREAM_ORACLE_RTOL}); "
          f"{json.dumps(stream.stats())}", flush=True)
    stamp("watched stream")

    # the CPU port on the same blocks, a rerun, a psr-2 mesh on cuda:0
    cpu = StreamState(template, model, device="cpu", **kw)
    cinfos = drive(cpu)
    cpu_err = moments_rel_err(m_card, cpu.moments())
    os_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-300)
                 for a, b in zip(infos, cinfos) for k in ("amp2", "snr"))
    again = StreamState(template, model, device="cuda", **kw)
    drive(again)
    rerun = all(torch.equal(a, b) for a, b in zip(again.moments(), m_card))
    mesh = StreamState(template, model,
                       mesh=make_mesh(["cuda:0"] * 2, psr_shards=2), **kw)
    drive(mesh)
    mesh_err = moments_rel_err(mesh.moments(), m_card)
    mesh_bits = all(torch.equal(a, b)
                    for a, b in zip(mesh.moments(), m_card))
    out["card_vs_cpu_rel_err"] = cpu_err
    out["os_card_vs_cpu_rel_err"] = os_err
    out["rerun_bit_identical"] = rerun
    out["mesh_psr2_rel_err"] = mesh_err
    out["mesh_psr2_bit_identical"] = mesh_bits
    print(f"stream card vs CPU moments {cpu_err:.3e} (bound "
          f"{STREAM_CPU_RTOL}), OS amp2/snr {os_err:.3e} (bound "
          f"{STREAM_OS_RTOL}); rerun bit-identical {rerun}; psr-2 mesh on "
          f"cuda:0 {mesh_err:.3e} (bound {STREAM_CPU_RTOL}), bit-identical "
          f"{mesh_bits}", flush=True)
    if cpu_err > STREAM_CPU_RTOL or os_err > STREAM_OS_RTOL or not rerun \
            or mesh_err > STREAM_CPU_RTOL:
        raise AssertionError("stream: card vs CPU, rerun or mesh")
    del cpu, again, mesh
    stamp("CPU, rerun and mesh")

    # checkpoint: resume bit-identical, a torn append rolled back
    ck = os.path.join(HERE, "build", "stream.ckpt")
    StreamCheckpoint(ck).delete()
    first = StreamState(template, model, device="cuda", checkpoint=ck, **kw)
    drive(first, 3)
    want = first.moments()
    plan = faults.FaultPlan([faults.FaultSpec("ingest.append", "torn",
                                              at=(0,))])
    with faults.inject(plan):
        try:
            first.append(**blocks[3])
            raise AssertionError("stream: the torn append did not kill")
        except faults.KillFault as exc:
            del exc
    resumed = StreamState(template, model, device="cuda", checkpoint=ck,
                          **kw)
    rolled = (resumed.appends, resumed.rolled_back)
    resume_bits = all(torch.equal(a, b)
                      for a, b in zip(resumed.moments(), want))
    for b in blocks[3:]:
        resumed.append(**b)
    continued = all(torch.equal(a, b)
                    for a, b in zip(resumed.moments(), m_card))
    resumed._ckpt.delete()
    out["checkpoint"] = {"appends_after_rollback": rolled[0],
                         "rolled_back": rolled[1],
                         "resume_bit_identical": resume_bits,
                         "continued_bit_identical": continued}
    print(f"stream checkpoint: torn append rolled back "
          f"(appends {rolled[0]}, rolled_back {rolled[1]}), resume "
          f"bit-identical {resume_bits}, continued to the end "
          f"bit-identical {continued}", flush=True)
    if rolled != (3, 1) or not resume_bits or not continued:
        raise AssertionError(f"stream checkpoint: {out['checkpoint']}")
    del first, resumed
    stamp("checkpoint")

    # the rolling OS: ms per update on the card
    watcher = stream._watcher()
    m_now = stream.moments()
    os_ms = time_ms(lambda: watcher.statistic(m_now[0], m_now[4]), 10)
    out["os_update_ms"] = os_ms
    print(f"stream OS update (P = 100, C = 280, float64): {os_ms:.3f} ms "
          f"on the card (CUDA events), last {json.dumps(watcher.last)}",
          flush=True)
    stamp("OS timing")

    # PosteriorRefresher: two cycles, the second warm
    spec = SampleSpec(model=model, **REFRESH_SPEC)
    ref = PosteriorRefresher(stream, spec, device="cuda")
    rkw = dict(segment=REFRESH_SEGMENT)
    c1 = ref.refresh(REFRESH_STEPS, seed=1, **rkw)
    # one more epoch (inside the built rungs), then the warm cycle
    stream.append(**stream_blocks(shape, seed=9)[-1])
    c2 = ref.refresh(REFRESH_STEPS, seed=2, **rkw)
    gate = [bool(np.isfinite(c["rhat_max"]) and c["rhat_max"] <= ref.rhat_gate)
            for c in (c1, c2)]
    out["refresh"] = {"cycles": [c1, c2], "gate": ref.rhat_gate,
                      "ms_per_cycle": [c1["latency_ms"], c2["latency_ms"]]}
    print(f"stream PosteriorRefresher (float64, 8 chains x 2 temps, "
          f"n_leapfrog 4, {REFRESH_STEPS} steps + warmup "
          f"{REFRESH_SPEC['warmup']}): cycle 1 {json.dumps(c1)}; cycle 2 "
          f"{json.dumps(c2)}", flush=True)
    if not (c2["warm_started"] and c2["chains_warm_started"]) \
            or c2["laplace_iters"] > c1["laplace_iters"] \
            or [c1["promoted"], c2["promoted"]] != gate:
        raise AssertionError(f"stream refresh: {out['refresh']}")
    stamp("posterior refresher")

    # FactorizedRefresher at config 18 part 2's shapes
    fs = FS_STREAM
    tspan_s = 10.0 * const.yr
    fs_model = LikelihoodSpec(components=(
        ComponentSpec(target="red", spectrum="batch"),
        ComponentSpec(target="dm", spectrum="batch"),
        ComponentSpec(target="curn", nbin=fs["nbin"],
                      spectrum="free_spectrum",
                      free=(FreeParam("log10_rho", (-9.0, -5.0),
                                      per_bin=True),))))
    ftpl = PulsarBatch.synthetic(npsr=fs["npsr"], ntoa=fs["ntoa"],
                                 tspan_years=10.0, n_red=4, n_dm=4, seed=3,
                                 device="cpu")
    fstream = StreamState(ftpl, fs_model, device="cuda")
    rng = np.random.default_rng(0)
    p, w = fs["npsr"], fs["width"]
    t0 = np.sort(rng.uniform(0, 0.9 * tspan_s, (p, w)), axis=1)
    fstream.append(t0, rng.normal(0, 1e-7, (p, w)),
                   sigma2=np.full((p, w), 1e-14))
    s_spec = SampleSpec(model=fs_model, n_chains=2, warmup=fs["warmup"],
                        n_leapfrog=3)
    fref = FactorizedRefresher(fstream, s_spec, lane_bins=1, rhat_gate=1e9,
                               device="cuda")
    cold = fref.refresh(fs["steps"], seed=1, segment=fs["segment"])
    te = np.tile((np.arange(w) / w * tspan_s)[None], (p, 1))
    fstream.append(te, 1e-6 * np.sin(2 * np.pi * (2.0 / tspan_s) * te),
                   sigma2=np.full((p, w), 1e-14))
    incr = fref.refresh(fs["steps"], seed=2, segment=fs["segment"])
    fstream.append(te, rng.normal(0, 1e-7, te.shape),
                   sigma2=np.full((p, w), 1e-14))
    full = fref.refresh(fs["steps"], seed=3, segment=fs["segment"],
                        force_all=True)
    out["factorized"] = {
        "cold": cold, "incremental": incr, "full": full,
        "fs_refresh_ms": incr["fs_refresh_ms"],
        "fs_full_refresh_ms": full["fs_refresh_ms"],
        "fs_refresh_speedup_x": round(full["fs_refresh_ms"]
                                      / max(incr["fs_refresh_ms"], 1e-9), 2),
        "fs_recompiles": incr["fs_recompiles"] + full["fs_recompiles"]}
    print(f"stream FactorizedRefresher (config 18 part 2: 16 psr x 96 TOAs, "
          f"16 bins, lane_bins 1, {fs['steps']} steps, segment "
          f"{fs['segment']}) on {card}: cold {cold['fs_refresh_ms']} ms "
          f"({cold['fs_lanes_touched']} lanes), the sinusoid epoch touched "
          f"{incr['fs_lanes_touched']} lane(s) / {incr['fs_bins_touched']} "
          f"bin(s) in {incr['fs_refresh_ms']} ms, full refresh "
          f"{full['fs_refresh_ms']} ms, fs_recompiles "
          f"{out['factorized']['fs_recompiles']} (0 by construction: a "
          f"lane's SamplingRun has no trace to rebuild)", flush=True)
    if incr["fs_lanes_touched"] != 1 or incr["fs_bins_touched"] != 1 \
            or not (cold["promoted"] and incr["promoted"]) \
            or not np.isfinite(fref.posterior["theta"]).all():
        raise AssertionError(f"stream factorized: {out['factorized']}")
    stamp("factorized refresher")

    # a steady append runs the same work: two steady appends of the A/B's
    # stream (no watch) dispatch the same aten ops at the same shapes,
    # recorded on the host; then one traced steady append's kernel
    # launches, copies and device busy time against wall time, as the
    # profiler's CUDA trace reports them (reported, not held: the trace
    # counted 39, 45 or 74 launches for the same append from run to run,
    # once with its one host-to-device copy missing). Last, so that no
    # timing above runs after a profiler run.
    plain = StreamState(template, model, device="cuda",
                        ecorr_dt=shape["ecorr_dt"])
    drive(plain, 3)
    ops = [dispatched_ops(lambda b=b: plain.append(**b))
           for b in blocks[3:5]]
    on_card = [sum(any(d == "cuda" for _, _, d in args) for _, args in o)
               for o in ops]
    out["steady_dispatch"] = {"ops": [len(o) for o in ops],
                              "ops_on_card": on_card,
                              "equal": ops[0] == ops[1]}
    print(f"stream steady appends (8 TOAs, no watch): aten ops dispatched "
          f"{out['steady_dispatch']['ops']} ({on_card} on the card), the "
          f"same ops at the same shapes {ops[0] == ops[1]}", flush=True)
    if ops[0] != ops[1] or not on_card[0]:
        raise AssertionError(f"stream steady appends dispatched "
                             f"{out['steady_dispatch']}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plain.append(**blocks[5])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, launches, copies = 0.0, 0, []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            busy += ev.time_range.elapsed_us() / 1e3
            if "memcpy" in ev.name.lower():
                copies.append(ev.name)
            else:
                launches += 1
    traced = {"wall_ms": wall, "device_busy_ms": busy,
              "kernel_launches": launches, "copies": len(copies),
              "copy_kinds": sorted(set(copies)),
              "device_idle_share": max(0.0, 1 - busy / wall)}
    out["traced_append"] = traced
    print(f"stream traced steady append (8 TOAs, no watch; the trace's "
          f"counts are reported, not held): {json.dumps(traced)}",
          flush=True)
    del plain
    stamp("traced append")
    report["stream"] = out


# -- multiproc: one rank per card (or per share of one card) ----------------

#: realizations per multi-process run (two chunks), the deadline of a rank
#: group, and the sampler's cut (the flagship's widths, fewer chains and
#: steps)
MP_NREAL = 2048
MP_DEADLINE_S = 420
MP_PATHS = ("einsum", "fused", "fused-vpu", "mega")
MP_SAMPLE_SPEC = dict(n_chains=8, n_temps=2, n_leapfrog=4, warmup=0,
                      thin=2)
MP_SAMPLE_STEPS = 4
MP_SENTINEL = "MULTIPROC_INIT_OK"
#: the tuner across ranks: a small frontier, one probe chunk each
MP_TUNE = dict(nreal_hint=4096, budget_s=60.0, max_candidates=3,
               probe_chunks=1)


def cross_entries(entries, n_real: int = 2, n_psr: int = 2,
                  n_toa: int = 2) -> list:
    """A (real, psr, toa) grid of ``entries``' ranks (one device each)
    with entry (r, s, t) on rank (r * n_psr + s + t) % ranks: on two ranks
    the psr gather of every toa window and each toa cell cross ranks; on
    four, ranks 1 and 3 own toa 1 entries only in one row."""
    from fakepta_tpu_torch.parallel.mesh import MeshDevice
    n = len(entries)
    return [MeshDevice((r * n_psr + s + t) % n, entries[(r * n_psr + s + t)
                                                        % n].device)
            for r in range(n_real) for s in range(n_psr)
            for t in range(n_toa)]


def digest(*arrays) -> str:
    """sha256 of the arrays' bytes: equal digests are equal bits."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def batch_digest(batch) -> str:
    """:func:`digest` over every field of a PulsarBatch."""
    host = batch.numpy()
    return digest(*(host[k] for k in sorted(host)))


def out_digest(out: dict) -> str:
    parts = [out["curves"], out["autos"]]
    if "os" in out:
        for orf in out["os"]["orfs"]:
            st = out["os"]["stats"][orf]
            parts += [st[k] for k in ("amp2", "null_amp2") if k in st]
    if "lnlike" in out:
        parts.append(out["lnlike"]["lnl"])
    return digest(*parts)


def mp_rank(rank: int, n: int, run_dir: str, shared: bool,
            full: bool) -> int:
    """One rank of the multiproc phase (``chip_smoke.py --mp-rank R``): it
    joins the group through a FileStore in ``run_dir``, drives the flagship
    on its multi-process meshes (real n x psr 1 and real 1 x psr n) and
    prints one JSON line; rank 0 also runs each one-process mesh of the
    same shape on cuda:0 and, with ``full``, holds #1-#4 at its per-rank
    shapes against their plain versions."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from fakepta_tpu_torch.detect import OSSpec
    from fakepta_tpu_torch.infer import InferSpec, theta_grid
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel import mesh as mesh_lib
    from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                       _chunk_keys)
    from fakepta_tpu_torch.scenarios import registry
    from fakepta_tpu_torch.utils import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0 if shared else rank)
    torch.cuda.set_device(dev)
    guard_runs()
    mesh_lib.initialize_multihost(f"file://{run_dir}/store", n, rank,
                                  local_devices=[dev], timeout_s=300.0)
    print(MP_SENTINEL, file=sys.stderr, flush=True)
    res = {"rank": rank, "ranks": n, "backend": mesh_lib.backend(),
           "device": str(dev), "runs": {}, "ref": {}, "kernels": {},
           "case_s": {}}
    entries = mesh_lib.global_devices()
    meshes = {"real": mesh_lib.make_mesh(entries),
              "psr": mesh_lib.make_mesh(entries, psr_shards=n)}
    ones = {"real": mesh_lib.make_mesh(["cuda:0"] * n),
            "psr": mesh_lib.make_mesh(["cuda:0"] * n, psr_shards=n)}
    scn = registry.get("flagship_100")
    parts = scn.batch_parts(device=str(dev))
    batch, P, T = parts[0], parts[0].npsr, parts[0].max_toa
    res["batch_digest"] = batch_digest(batch)
    paths = MP_PATHS if full else ("fused",)
    precs = ("f32", "bf16") if full else ("f32",)

    def sim_on(mesh, path):
        return EnsembleSimulator(batch, stat_path=path.split("-")[0],
                                 mesh=mesh,
                                 pallas_mxu_binning=path != "fused-vpu",
                                 **scn.sim_kwargs(*parts))

    def sync_barrier():
        torch.cuda.synchronize(dev)
        dist.barrier()

    if full and rank == 0:
        # #1-#4 at this rank's shapes (its psr shard's rows against the
        # gathered array; its real block of the whole array), against
        # their plain versions; launches here are not counted
        sim = sim_on(meshes["psr"], "mega")
        sh = sim._shards[0][0]
        keys = _chunk_keys(rng.key(7, device=dev), 0, CHUNK)
        with torch.no_grad():
            full_res = sim._residuals(keys)
            loc = sim._residuals(keys, shard=sh)
            base, coefs = sim._residuals(keys, split_gp=True)
            lb, lc = sim._residuals(keys, split_gp=True, shard=sh)
        # the whole array's weights stay on the host on a psr mesh
        w, nb = sim._stat_weights.to(dev), sim.nbins
        stages, times, scales = sim._mega_tables
        r_real = CHUNK // n
        for prec in ("f32", "bf16"):
            cast = (lambda x: x) if prec == "f32" else (
                lambda x: x.to(torch.bfloat16))
            holds = {
                f"binned_correlation/{shape_tag(P // n, P, T)}": (
                    bc.binned_correlation, bc.binned_correlation_plain,
                    (loc, full_res, sh.weights, nb), {}),
                # the tuner's fused probes: the whole array, this rank's
                # real block
                f"binned_correlation/{shape_tag(P, P, T)} R={r_real}": (
                    bc.binned_correlation, bc.binned_correlation_plain,
                    (full_res[:r_real], full_res[:r_real], w, nb), {}),
                f"binned_correlation_vpu/{shape_tag(P // n, P, T)}": (
                    bc.binned_correlation_vpu, bc.binned_correlation_plain,
                    (loc, full_res, sh.weights, nb), {}),
                f"chunk_stats/{shape_tag(P, P, T)} R={r_real}": (
                    mk.chunk_stats, mk.chunk_stats_plain,
                    (cast(base[:r_real]), cast(coefs[:r_real]), times,
                     scales, w), dict(stages=stages, nbins=nb)),
                f"chunk_stats_sharded/{shape_tag(P // n, P, T)}": (
                    mk.chunk_stats, mk.chunk_stats_plain,
                    (cast(base), cast(coefs), times, scales, sh.weights),
                    dict(stages=stages, nbins=nb, base_local=cast(lb),
                         coef_local=cast(lc), times_local=sh.times,
                         scales_local=sh.scales))}
            for what, (kern, plain, args, kw) in holds.items():
                got = kern(*args, precision=prec, **kw)
                want = plain(*args, precision=prec, **kw)
                torch.cuda.synchronize(dev)
                row = compare(got, want, prec, f"multiproc rank 0 {what} "
                              f"vs plain")
                res["kernels"][f"{what}/{prec}"] = row["max_abs_err"]
        del full_res, loc, base, coefs, lb, lc, sim

    # the main path: each mesh, path and precision; counts zeroed just
    # before the timed run and read just after
    nchunks = -(-MP_NREAL // CHUNK)
    for mname, mesh in meshes.items():
        for path in paths:
            sim = sim_on(mesh, path)
            for prec in precs:
                sim.run(CHUNK, seed=99, chunk=CHUNK, precision=prec)
                extra = {}
                if mname == "psr" and path == "fused" and prec == "f32":
                    extra = {"eventlog": os.path.join(run_dir, "shards")}
                sync_barrier()
                reset_counts()
                t0 = time.perf_counter()
                out = sim.run(MP_NREAL, seed=5, chunk=CHUNK, precision=prec,
                              **extra)
                sync_barrier()
                dt = time.perf_counter() - t0
                moved = {k: v for k, v in counts().items() if v}
                kern = (PATH_KERNEL if mname == "real"
                        else SHARDED_KERNEL).get(path)
                want = {kern: nchunks} if kern else {}
                if moved != want:
                    raise AssertionError(f"multiproc rank {rank} {mname} "
                                         f"{path} [{prec}] launched {moved},"
                                         f" expected {want}")
                if not np.isfinite(out["curves"]).all() or \
                        out["curves"].shape != (MP_NREAL, 15):
                    raise AssertionError(f"multiproc {mname} {path}: "
                                         f"curves {out['curves'].shape}")
                meta = out["report"].meta
                res["runs"][f"{mname}/{path}/{prec}"] = {
                    "digest": out_digest(out),
                    "realizations_per_s": MP_NREAL / dt, "wall_s": dt,
                    "launches": moved,
                    "shape": (shape_tag(P, P, T) if mname == "real"
                              else shape_tag(P // n, P, T)),
                    "process_index": meta["process_index"],
                    "process_count": meta["process_count"],
                    "backend": meta["backend"]}
                if rank == 0:
                    ref_sim = sim_on(ones[mname], path)
                    ref_sim.run(CHUNK, seed=99, chunk=CHUNK, precision=prec)
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    ref = ref_sim.run(MP_NREAL, seed=5, chunk=CHUNK,
                                      precision=prec)
                    torch.cuda.synchronize(dev)
                    res["ref"][f"{mname}/{path}/{prec}"] = {
                        "digest": out_digest(ref),
                        "realizations_per_s": MP_NREAL / (
                            time.perf_counter() - t0)}
                    del ref_sim
            del sim

    if full:
        # the OS lane with its null stream and the likelihood lane, on the
        # psr mesh, where the pulsar gather crosses ranks
        theta = theta_grid(flagship_model(), (2, 2))
        lanes = {"os": dict(os=OSSpec(orf=("hd", "monopole"), null=True)),
                 "lnlike": dict(lnlike=InferSpec(model=flagship_model(),
                                                 theta=theta))}
        for lname, kw in lanes.items():
            for mname in ("psr",) if lname == "os" else ("psr", "real"):
                sim = sim_on(meshes[mname], "fused")
                reset_counts()
                out = sim.run(MP_NREAL, seed=5, chunk=CHUNK,
                              precision="f32", **kw)
                moved = {k: v for k, v in counts().items() if v}
                res["runs"][f"{mname}/{lname}/f32"] = {
                    "digest": out_digest(out), "launches": moved,
                    "shape": (shape_tag(P // n, P, T) if mname == "psr"
                              else shape_tag(P, P, T))}
                if rank == 0:
                    ref = sim_on(ones[mname], "fused").run(
                        MP_NREAL, seed=5, chunk=CHUNK, precision="f32", **kw)
                    res["ref"][f"{mname}/{lname}/f32"] = {
                        "digest": out_digest(ref)}
                del sim
                dist.barrier()

        # checkpoints: rank 0 alone appends (each rank's own directory,
        # listed after every chunk) and deletes
        sim = sim_on(meshes["psr"], "fused")
        mine = os.path.join(run_dir, f"ck{rank}")
        os.makedirs(mine)
        seen = []
        sim.run(MP_NREAL, seed=5, chunk=CHUNK, precision="f32",
                checkpoint=os.path.join(mine, "mc"),
                progress=lambda d, t: seen.append(sorted(os.listdir(mine))))
        res["ckpt_files_mid_run"] = seen
        res["ckpt_files_after"] = sorted(os.listdir(mine))
        del sim

        # the sampler: chains over 'real' across ranks, then the pulsar
        # rows over 'psr'; every study starts its Laplace fit from one
        # single-card fit, so the one-process studies see the same fit
        from fakepta_tpu_torch.sample import SampleSpec, SamplingRun
        spec = SampleSpec(model=flagship_model(), **MP_SAMPLE_SPEC)
        t0 = time.perf_counter()
        warm = SamplingRun(batch, spec, device=str(dev),
                           data_seed=1).laplace_state()
        res["laplace_s"] = time.perf_counter() - t0
        res["sample"], res["sample_ref"] = {}, {}
        for mname, mesh in meshes.items():
            study = SamplingRun(batch, spec, mesh=mesh, data_seed=1,
                                warm_from=warm)
            sync_barrier()
            t0 = time.perf_counter()
            got = study.run(MP_SAMPLE_STEPS, seed=1, segment=MP_SAMPLE_STEPS)
            sync_barrier()
            res["sample"][mname] = {"digest": digest(got["theta"]),
                                    "wall_s": time.perf_counter() - t0,
                                    "finite": bool(np.isfinite(
                                        got["theta"]).all())}
            if rank == 0:
                ref = SamplingRun(batch, spec, mesh=ones[mname],
                                  data_seed=1, warm_from=warm).run(
                    MP_SAMPLE_STEPS, seed=1, segment=MP_SAMPLE_STEPS)
                res["sample_ref"][mname] = {"digest": digest(ref["theta"])}
            dist.barrier()
        mp_stream_search_sampler(res, rank, n, run_dir, dev, entries,
                                 meshes, ones, batch, parts, scn, warm)

    # one traced einsum chunk on the psr mesh: the host enqueue against
    # the time until this rank's card is done, and its busy time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim = sim_on(meshes["psr"], "einsum")
    key = rng.key(13, device=dev)
    with torch.no_grad():
        sim.step(key, 0, CHUNK, "einsum", "f32")
        enq, step = [], []
        for i in range(3):
            sync_barrier()
            t0 = time.perf_counter()
            sim.step(key, (i + 1) * CHUNK, CHUNK, "einsum", "f32")
            enq.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize(dev)
            step.append(1e3 * (time.perf_counter() - t0))
        sync_barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            sim.step(key, 0, CHUNK, "einsum", "f32")
            torch.cuda.synchronize(dev)
    # busy: the union of the card's kernel intervals (kernels on two
    # streams, the collectives' beside the compute, overlap), with and
    # without the collectives' own kernels, which wait on the other ranks
    def union_ms(evs) -> float:
        total, hi = 0.0, None
        for lo, up in sorted((ev.time_range.start, ev.time_range.end)
                             for ev in evs):
            if hi is None or lo > hi:
                total += up - lo
                hi = up
            elif up > hi:
                total += up - hi
                hi = up
        return total / 1e3

    on_card = [ev for ev in p.events() if ev.device_type == DeviceType.CUDA]
    comm = [ev for ev in on_card if "nccl" in ev.name.lower()]
    res["profile"] = {"enqueue_ms": sum(enq) / len(enq),
                      "step_ms": sum(step) / len(step),
                      "device_busy_ms": union_ms(on_card),
                      "compute_busy_ms": union_ms(
                          [ev for ev in on_card
                           if "nccl" not in ev.name.lower()]),
                      "collective_kernel_ms": sum(
                          ev.time_range.elapsed_us() for ev in comm) / 1e3,
                      "kernel_launches": len({
                          (ev.name, ev.time_range.start)
                          for ev in p.events()
                          if ev.device_type == DeviceType.CUDA})}
    dist.barrier()
    print(json.dumps(res), flush=True)
    mesh_lib.shutdown_multihost()
    return 0


def mp_stream_search_sampler(res: dict, rank: int, n: int, run_dir: str,
                             dev, entries, meshes, ones, batch, parts, scn,
                             warm) -> None:
    """The multiproc phase's stream, tuner and toa-sampler cases on one
    rank (``res`` gains ``stream``, ``search`` and ``sample_toa``; rank 0
    also the one-process references)."""
    import torch
    import torch.distributed as dist
    from fakepta_tpu_torch import tune
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.parallel import mesh as mesh_lib
    from fakepta_tpu_torch.sample import SampleSpec, SamplingRun
    from fakepta_tpu_torch.stream import StreamState, default_stream_model
    search_mod = sys.modules["fakepta_tpu_torch.tune.search"]
    P, T = batch.npsr, batch.max_toa

    def sync_barrier():
        torch.cuda.synchronize(dev)
        dist.barrier()

    # the stream at config 14's widths on the real 1 x psr n mesh: the
    # history, a warm-up epoch and the steady 8-TOA epochs, watched (HD)
    t_case = time.perf_counter()
    shape = dict(STREAM_SHAPE)
    template = PulsarBatch.synthetic(
        npsr=shape["npsr"], ntoa=shape["ntoa"],
        tspan_years=shape["tspan_years"], n_red=shape["n_red"],
        n_dm=shape["n_dm"], seed=0, dtype=torch.float64, device="cpu")
    model = default_stream_model(nbin=shape["nbin"])
    blocks = stream_blocks(shape)

    def streamed(mesh, **kw):
        st = StreamState(template, model, mesh=mesh,
                         ecorr_dt=shape["ecorr_dt"], watch="hd", **kw)
        infos = [st.append(**b) for b in blocks]
        mom = st.moments()
        return {"digest": digest(*(m.cpu().numpy() for m in mom)),
                "lnl": st.lnlike(st.theta_ref),
                "os": [[i["amp2"], i["snr"]] for i in infos],
                "append_ms": [i["latency_ms"] for i in infos],
                "finite": bool(all(np.isfinite(i["snr"]) for i in infos))}

    ck = os.path.join(run_dir, f"sck{rank}")
    os.makedirs(ck)
    sync_barrier()
    got = streamed(meshes["psr"], checkpoint=os.path.join(ck, "s.ckpt"))
    got["ckpt_files"] = sorted(os.listdir(ck))
    res["stream"] = got
    if rank == 0:
        res["stream_ref"] = streamed(ones["psr"])
    sync_barrier()
    res["case_s"]["stream"] = time.perf_counter() - t_case

    # tune.search over every rank's entry: the flagship, a small frontier;
    # each probe's launches counted on this rank, zeroed just before it
    t_case = time.perf_counter()
    gwb = scn.sim_kwargs(*parts)["gwb"]
    store_dir = os.path.join(run_dir, "tune")
    store = os.path.join(store_dir, "tuned.json")
    probes = []
    inner = search_mod.run_probe

    def counted_probe(sim, cand, **kw):
        reset_counts()
        rec = inner(sim, cand, **kw)
        moved = {k: v for k, v in counts().items() if v}
        probes.append({"knobs": cand.knobs(), "launches": moved,
                       "shape": shape_tag(P // cand.psr_shards, P, T)})
        return rec

    search_mod.run_probe = counted_probe
    try:
        sync_barrier()
        t0 = time.perf_counter()
        cfg, info = tune.search(batch, gwb=gwb, mesh_devices=entries,
                                force=True, store=store,
                                artifact=os.path.join(
                                    run_dir, f"tune{rank}.jsonl"),
                                **MP_TUNE)
        search_s = time.perf_counter() - t0
    finally:
        search_mod.run_probe = inner
    sync_barrier()
    t0 = time.perf_counter()
    cfg2, info2 = tune.search(batch, gwb=gwb, mesh_devices=entries,
                              store=store, **MP_TUNE)
    if rank == 0:
        res["search_holds"] = hold_probe_kernels(probes, n, dev, batch,
                                                 parts, scn)
    res["search"] = {
        "cfg": cfg.to_json(), "probes": info["probes"], "search_s": search_s,
        "probe_launches": probes,
        "rates": [r["real_per_s_per_chip"] for r in info["records"]],
        "store_files": sorted(os.listdir(store_dir)),
        "artifact": os.path.exists(os.path.join(run_dir,
                                                f"tune{rank}.jsonl")),
        "warm": {"cfg": cfg2.to_json(), "probes": info2["probes"],
                 "warm": info2["warm"], "s": time.perf_counter() - t0}}
    sync_barrier()
    res["case_s"]["search"] = time.perf_counter() - t_case

    # the sampler with psr 2 x toa 2 on the cross layout (real 2)
    t_case = time.perf_counter()
    spec = SampleSpec(model=flagship_model(), **MP_SAMPLE_SPEC)
    cross = mesh_lib.make_mesh(cross_entries(entries), psr_shards=2,
                               toa_shards=2)
    study = SamplingRun(batch, spec, mesh=cross, data_seed=1,
                        warm_from=warm)
    sync_barrier()
    t0 = time.perf_counter()
    got = study.run(MP_SAMPLE_STEPS, seed=1, segment=MP_SAMPLE_STEPS)
    sync_barrier()
    res["sample_toa"] = {"digest": digest(got["theta"]),
                         "wall_s": time.perf_counter() - t0,
                         "finite": bool(np.isfinite(got["theta"]).all())}
    if rank == 0:
        ref = SamplingRun(batch, spec, mesh=mesh_lib.make_mesh(
            [str(dev)] * 8, psr_shards=2, toa_shards=2), data_seed=1,
            warm_from=warm).run(MP_SAMPLE_STEPS, seed=1,
                                segment=MP_SAMPLE_STEPS)
        res["sample_toa_ref"] = {"digest": digest(ref["theta"])}
    del study
    dist.barrier()
    res["case_s"]["sample_toa"] = time.perf_counter() - t_case


def hold_probe_kernels(probes: list, n: int, dev, batch, parts,
                       scn) -> dict:
    """Each kernel the search's probes launched, at a probe's per-rank
    shape (its chunk's real block of the whole array: the probes ran on
    real n x psr 1 meshes) and precision, against its plain version on the
    same inputs; these launches only compare and are not counted."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                       _chunk_keys)
    from fakepta_tpu_torch.utils import rng
    P, T = batch.npsr, batch.max_toa
    held, sims = {}, {}
    for p in probes:
        knobs = p["knobs"]
        if not p["launches"]:
            continue
        if knobs["psr_shards"] != 1:
            raise AssertionError(f"multiproc search: a psr-sharded probe "
                                 f"{knobs} (held only at psr 1 here)")
        path = knobs["path"]
        if path not in sims:
            sims[path] = EnsembleSimulator(batch, stat_path=path,
                                           device=str(dev),
                                           **scn.sim_kwargs(*parts))
        sim = sims[path]
        prec = sim._resolve_precision(path, knobs["precision"])
        r_rank = knobs["chunk"] // n
        what = f"{PATH_KERNEL[path]}/{shape_tag(P, P, T)} R={r_rank}/{prec}"
        if what in held:
            continue
        keys = _chunk_keys(rng.key(7, device=dev), 0, r_rank)
        w, nb = sim._stat_weights.to(dev), sim.nbins
        with torch.no_grad():
            if path == "mega":
                base, coefs = sim._residuals(keys, split_gp=True)
                cast = (lambda x: x) if prec == "f32" else (
                    lambda x: x.to(torch.bfloat16))
                stages, times, scales = sim._mega_tables
                args = (cast(base), cast(coefs), times, scales, w)
                kw = dict(stages=stages, nbins=nb)
                kern, plain = mk.chunk_stats, mk.chunk_stats_plain
            else:
                res = sim._residuals(keys)
                args, kw = (res, res, w, nb), {}
                kern, plain = ((bc.binned_correlation_vpu
                                if path == "fused-vpu" else
                                bc.binned_correlation),
                               bc.binned_correlation_plain)
            got = kern(*args, precision=prec, **kw)
            want = plain(*args, precision=prec, **kw)
        torch.cuda.synchronize(dev)
        held[what] = compare(got, want, prec, f"multiproc rank 0 probe "
                             f"{what} vs plain")["max_abs_err"]
        del args, got, want
    reset_counts()
    return held


def check_stream_search_sampler(report: dict, got: list, n: int) -> dict:
    """The phase's checks of :func:`mp_stream_search_sampler`'s results
    (``got`` in rank order); returns the row's additions."""
    r0 = got[0]
    st = r0["stream"]
    if not st["finite"] or any(
            g["stream"][k] != st[k] for g in got for k in ("digest", "lnl",
                                                           "os")) or any(
            r0["stream_ref"][k] != st[k] for k in ("digest", "lnl", "os")):
        raise AssertionError("multiproc stream: moments, lnL or OS differ "
                             "across ranks or from the one-process mesh")
    if not st["ckpt_files"] or any(g["stream"]["ckpt_files"]
                                   for g in got[1:]):
        raise AssertionError("multiproc stream: checkpoint files beyond "
                             "rank 0, or none on rank 0")
    for r, g in enumerate(got):
        print(f"multiproc {n} ranks stream (config 14, psr {n}) rank {r}: "
              f"append ms {g['stream']['append_ms']}", flush=True)
    print(f"multiproc {n} ranks stream: one-process psr {n} mesh append "
          f"ms {r0['stream_ref']['append_ms']}; moments, lnL and OS "
          f"bit-identical on every rank, checkpoint files on rank 0 only",
          flush=True)
    sr = r0["search"]
    for r, g in enumerate(got):
        s = g["search"]
        if s["cfg"] != sr["cfg"] or s["warm"]["cfg"] != sr["cfg"] or \
                not s["warm"]["warm"] or s["warm"]["probes"] or \
                s["store_files"] != ["tuned.json"] or \
                s["artifact"] != (r == 0) or s["probes"] != sr["probes"]:
            raise AssertionError(f"multiproc search rank {r}: {s}")
        launched = {}
        for p in s["probe_launches"]:
            add_launches(report, p["shape"], p["launches"])
            for k, v in p["launches"].items():
                launched[k] = launched.get(k, 0) + v
        print(f"multiproc {n} ranks tune.search rank {r}: {s['probes']} "
              f"probes in {s['search_s']:.2f} s, rates {s['rates']}, "
              f"launches during the probes {launched}; warm search "
              f"{s['warm']['s']:.3f} s, 0 probes", flush=True)
    paths = {p["knobs"]["path"] for p in sr["probe_launches"]}
    for p in sr["probe_launches"]:
        kern = (PATH_KERNEL if p["knobs"]["psr_shards"] == 1
                else SHARDED_KERNEL).get(p["knobs"]["path"])
        if kern and not p["launches"].get(kern):
            raise AssertionError(f"multiproc search: probe {p['knobs']} "
                                 f"launched {p['launches']}")
    print(f"multiproc {n} ranks tune.search: one TunedConfig on every rank "
          f"({json.dumps(sr['cfg']['knobs'])}), one store file, probed "
          f"paths {sorted(paths)}; rank 0 held the probes' kernels against "
          f"their plain versions, max abs err "
          f"{json.dumps(r0['search_holds'])}", flush=True)
    sa = r0["sample_toa"]
    if not sa["finite"] or any(g["sample_toa"]["digest"] != sa["digest"]
                               for g in got) or \
            r0["sample_toa_ref"]["digest"] != sa["digest"]:
        raise AssertionError("multiproc sampler psr 2 x toa 2: chains differ "
                             "across ranks or from the one-process mesh")
    print(f"multiproc {n} ranks sampler (cross, real 2 x psr 2 x toa 2): "
          f"chains bit-identical, {sa['wall_s']:.2f} s for "
          f"{MP_SAMPLE_STEPS} steps; case seconds "
          f"{json.dumps(r0['case_s'])}", flush=True)
    return {"case_s": r0["case_s"],
            "stream_append_ms": [g["stream"]["append_ms"] for g in got],
            "stream_one_process_append_ms": r0["stream_ref"]["append_ms"],
            "search": [{"probes": g["search"]["probes"],
                        "search_s": g["search"]["search_s"],
                        "probe_launches": g["search"]["probe_launches"]}
                       for g in got],
            "tuned_knobs": sr["cfg"]["knobs"],
            "search_holds_max_abs_err": r0["search_holds"],
            "sample_toa_wall_s": sa["wall_s"]}


def run_rank_group(n: int, shared: bool, full: bool, run_dir: str) -> list:
    """Start ``n`` ranks of this script, wait for all of them within
    MP_DEADLINE_S, and return their JSON results in rank order; a rank
    that fails or passes the deadline fails the phase (every rank is
    stopped)."""
    os.makedirs(run_dir)
    # every rank is on this host: the collectives' sockets use loopback
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, logs = [], []
    for r in range(n):
        out_p = os.path.join(run_dir, f"rank{r}.out")
        err_p = os.path.join(run_dir, f"rank{r}.err")
        logs.append((out_p, err_p))
        with open(out_p, "w") as out_f, open(err_p, "w") as err_f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-rank",
                 str(r), "--mp-ranks", str(n), "--mp-dir", run_dir]
                + (["--mp-shared"] if shared else [])
                + (["--mp-full"] if full else []),
                stdout=out_f, stderr=err_f, cwd=HERE, env=env))
    t_end = time.monotonic() + MP_DEADLINE_S
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(t_end - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                with open(logs[r][1]) as fh:
                    tail = "\n".join(fh.read().strip().splitlines()[-25:])
                why = ("passed its deadline" if rc is None
                       else f"exited {rc}")
                raise AssertionError(f"multiproc: rank {r} of {n} {why}:\n"
                                     f"{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for out_p, _ in logs:
        with open(out_p) as fh:
            results.append(json.loads(fh.read().strip().splitlines()[-1]))
    return results


def phase_multiproc(report: dict, cards: int = 1) -> None:
    """The flagship on multi-process meshes (module docstring, phase 15):
    two ranks on cuda:0 under gloo by default; with ``cards`` >= 2, groups
    of 1, 2 and ``cards`` ranks, one card each (NCCL), the last with every
    check."""
    import torch
    from fakepta_tpu_torch.obs.trace import (build_trace, load_reports,
                                             validate_trace)
    from fakepta_tpu_torch.parallel.mesh import make_mesh

    if cards == 1:
        groups = ((2, True, True),)
    else:
        groups = tuple((n, False, n == cards)
                       for n in sorted({1, 2, cards}) if n <= cards)
    root = os.path.join(HERE, "build", "multiproc",
                        time.strftime("%Y%m%d-%H%M%S"))
    from fakepta_tpu_torch.scenarios import registry
    want_batch = batch_digest(
        registry.get("flagship_100").batch_parts(device="cuda")[0])
    rows = {}
    for n, shared, full in groups:
        run_dir = os.path.join(root, f"ranks{n}")
        t0 = time.perf_counter()
        got = run_rank_group(n, shared, full, run_dir)
        wall = time.perf_counter() - t0
        r0 = got[0]
        if any(g["batch_digest"] != want_batch for g in got):
            raise AssertionError(f"multiproc {n} ranks: a rank's flagship "
                                 f"batch differs from the one-process one")
        want_backend = "gloo" if shared else "nccl"
        for r, g in enumerate(got):
            for name, run in g["runs"].items():
                if run["digest"] != r0["runs"][name]["digest"]:
                    raise AssertionError(f"multiproc {n} ranks {name}: rank "
                                         f"{r} differs from rank 0")
                if "process_index" in run and (
                        run["process_index"] != r
                        or run["process_count"] != n
                        or (n > 1 and run["backend"] != want_backend)):
                    raise AssertionError(f"multiproc {name} rank {r}: meta "
                                         f"{run}")
                add_launches(report, run["shape"], run["launches"])
        for name, ref in r0["ref"].items():
            if r0["runs"][name]["digest"] != ref["digest"]:
                raise AssertionError(f"multiproc {n} ranks {name}: not "
                                     f"bit-identical to the one-process "
                                     f"mesh of the same shape")
        row = {"ranks": n, "backend": r0["backend"],
               "cards": 1 if shared else n, "wall_s": wall,
               "realizations_per_s": {
                   k: [g["runs"][k].get("realizations_per_s")
                       for g in got] for k in r0["runs"]
                   if "realizations_per_s" in r0["runs"][k]},
               "one_process_realizations_per_s": {
                   k: v.get("realizations_per_s")
                   for k, v in r0["ref"].items()},
               "profile": [g["profile"] for g in got]}
        for k, rate in row["realizations_per_s"].items():
            one = row["one_process_realizations_per_s"].get(k)
            print(f"multiproc {n} rank(s) ({row['backend']}, "
                  f"{row['cards']} card(s)) {k}: {rate[0]:.1f} "
                  f"realizations/s; one-process mesh of the same shape "
                  f"{one if one is None else f'{one:.1f}'}", flush=True)
        for r, prof in enumerate(row["profile"]):
            print(f"multiproc {n} rank(s) rank {r}: einsum psr chunk host "
                  f"enqueue {prof['enqueue_ms']:.3f} ms, step "
                  f"{prof['step_ms']:.3f} ms, card busy (union of kernel "
                  f"intervals) {prof['device_busy_ms']:.3f} ms, "
                  f"{prof['compute_busy_ms']:.3f} ms without the "
                  f"collectives' kernels ({prof['collective_kernel_ms']:.3f}"
                  f" ms) over {prof['kernel_launches']} kernels",
                  flush=True)
        if full:
            if not any(f for f in r0["ckpt_files_mid_run"]) or any(
                    f for g in got[1:] for f in g["ckpt_files_mid_run"]):
                raise AssertionError("multiproc: checkpoint files beyond "
                                     "rank 0, or none on rank 0")
            if any(g["ckpt_files_after"] for g in got):
                raise AssertionError("multiproc: checkpoint not deleted")
            shards = sorted(
                os.path.join(run_dir, "shards", f)
                for f in os.listdir(os.path.join(run_dir, "shards")))
            trace = build_trace(load_reports(shards))
            validate_trace(trace)
            pids = {ev["pid"] for ev in trace["traceEvents"]}
            if pids != set(range(n)):
                raise AssertionError(f"multiproc trace pid lanes {pids}")
            for pid in pids:
                if not any(ev["pid"] == pid and ev["ph"] == "X"
                           and ev["name"] == "dispatch"
                           for ev in trace["traceEvents"]):
                    raise AssertionError(f"multiproc trace: no dispatch "
                                         f"span on pid {pid}")
            for mname, s in r0["sample"].items():
                if not s["finite"] or any(
                        g["sample"][mname]["digest"] != s["digest"]
                        for g in got) or \
                        r0["sample_ref"][mname]["digest"] != s["digest"]:
                    raise AssertionError(f"multiproc sampler {mname}: "
                                         f"chains differ across ranks or "
                                         f"from the one-process run")
            row.update(check_stream_search_sampler(report, got, n))
            row.update(kernels_max_abs_err=r0["kernels"],
                       laplace_s=r0["laplace_s"],
                       sample_wall_s={k: v["wall_s"]
                                      for k, v in r0["sample"].items()},
                       trace_pids=sorted(pids))
            print(f"multiproc {n} ranks: every run bit-identical across "
                  f"ranks and to the one-process mesh, checkpoint files on "
                  f"rank 0 only, trace pid lanes {sorted(pids)}, sampler "
                  f"chains bit-identical", flush=True)
        rows[f"ranks{n}"] = row
    if cards > 1:
        # the same shapes on the one-process mesh over the same cards
        for mname, shards in (("real", 1), ("psr", cards)):
            sim = flagship_sim("fused", mesh=make_mesh(
                [f"cuda:{i}" for i in range(cards)], psr_shards=shards))
            sim.run(CHUNK, seed=99, chunk=CHUNK, precision="f32")
            sync_all()
            t0 = time.perf_counter()
            sim.run(MP_NREAL, seed=5, chunk=CHUNK, precision="f32")
            sync_all()
            rate = MP_NREAL / (time.perf_counter() - t0)
            rows[f"one_process_{cards}_cards/{mname}/fused/f32"] = rate
            print(f"multiproc: one-process {cards}-card mesh {mname} fused "
                  f"[f32] {rate:.1f} realizations/s", flush=True)
            del sim
        torch.cuda.empty_cache()
    report["multiproc"] = rows


#: the tune phase: the workload scale the search tunes for, its probe
#: budget and frontier cap, and the sampler check's chain steps
TUNE_NREAL = 4096
TUNE_BUDGET_S = 60.0
TUNE_MAX_CANDIDATES = 8


def hold_to_einsum(tuned: dict, records: list) -> dict:
    """The kernels at the chunks the tuner ran them: ``tuned`` (the
    ``run(TUNE_NREAL, seed=1, tuned=True)`` output) and one chunk of each
    completed fused or mega probe's knobs, each held to the einsum path at
    the same seed, chunk and precision with :func:`compare` at TOL[prec]
    (the engine phase's bound). Launches here only compare, and are not
    counted."""
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    ref_sim = flagship_sim("einsum")
    refs = {}

    def hold(got: dict, nreal: int, seed: int, chunk: int, what: str):
        prec = got["precision"]
        key = (nreal, seed, chunk, prec)
        if key not in refs:
            refs[key] = ref_sim.run(nreal, seed=seed, chunk=chunk,
                                    precision=prec)
        ref = refs[key]
        return compare((got["curves"], got["autos"]),
                       (ref["curves"], ref["autos"]), prec,
                       f"tune: {what} {got['statistic_path']} at chunk "
                       f"{chunk} vs einsum")

    chunk = tuned["report"].meta["tuned"]["knobs"]["chunk"]
    rows = {"run(tuned=True)": hold(tuned, TUNE_NREAL, 1, chunk,
                                    "run(tuned=True)")}
    for rec in records:
        k = rec["knobs"]
        tag = f"probe {k['path']}/{k['precision']}/chunk {k['chunk']}"
        if k["path"] == "einsum" or tag in rows:
            continue
        s = k["psr_shards"]
        sim = flagship_sim(k["path"], mesh=None if s == 1 else make_mesh(
            ["cuda:0"] * s, psr_shards=s))
        got = sim.run(k["chunk"], seed=3, chunk=k["chunk"],
                      precision=k["precision"])
        rows[tag] = hold(got, k["chunk"], 3, k["chunk"], tag)
    return rows


def chunk_ab(knobs: dict, prec: str) -> dict:
    """The chunk alone, reported and not gated: ``run(TUNE_NREAL)`` at
    chunk 1024 against the tuned chunk (4096 when the tuned one is 1024),
    at equal realizations, for the hand-set family (einsum f32, depth 2)
    and the chosen one (its path, precision and depth), each timed in turns
    (one warm run each, then a, b, b, a; CUDA events)."""
    chunks = (CHUNK, knobs["chunk"] if knobs["chunk"] != CHUNK
              else TUNE_NREAL)
    fams = {"hand-set einsum/f32 depth 2": ("einsum", "f32", 2),
            f"chosen {knobs['path']}/{prec} depth "
            f"{knobs['pipeline_depth']}": (knobs["path"], prec,
                                           knobs["pipeline_depth"])}
    rows = {}
    for fam, (path, p, depth) in fams.items():
        sim = flagship_sim(path)
        fns = {c: (lambda c=c: sim.run(TUNE_NREAL, seed=5, chunk=c,
                                       precision=p, pipeline_depth=depth))
               for c in chunks}
        for fn in fns.values():
            fn()
        got = {c: [] for c in chunks}
        for c in chunks + chunks[::-1]:
            got[c].append(time_ms(fns[c], 1, warmup=0))
        ms = {c: sum(v) / len(v) for c, v in got.items()}
        rate = {c: TUNE_NREAL / (ms[c] / 1e3) for c in chunks}
        rows[fam] = {f"chunk {c}": {"ms": ms[c], "real_per_s": rate[c]}
                     for c in chunks}
        rows[fam]["ratio"] = rate[chunks[1]] / rate[chunks[0]]
        print(f"tune: chunk A/B {fam}, run({TUNE_NREAL}): chunk "
              f"{chunks[0]} {rate[chunks[0]]:.1f}/s, chunk {chunks[1]} "
              f"{rate[chunks[1]]:.1f}/s (x{rows[fam]['ratio']:.4f})",
              flush=True)
    return rows


def phase_tune(report: dict) -> None:
    """The tuner on the flagship, uncut, on one card (module docstring,
    phase 16)."""
    import torch
    from fakepta_tpu_torch import tune
    from fakepta_tpu_torch.obs import flightrec
    from fakepta_tpu_torch.obs.report import RunReport
    from fakepta_tpu_torch.sample import SampleSpec, SamplingRun
    from fakepta_tpu_torch.scenarios import registry
    from fakepta_tpu_torch.tune import defaults as tune_defaults

    t_phase = time.perf_counter()
    out = report.setdefault("tune", {})
    store_dir = os.path.join(HERE, "build", "tune")
    shutil.rmtree(store_dir, ignore_errors=True)
    store = os.path.join(store_dir, "tuned.json")
    devices = ["cuda:0"]
    fp = tune.fingerprint(devices)
    out["fingerprint"] = fp.as_dict()
    print(f"tune: fingerprint {json.dumps(fp.as_dict())} ({fp.hash})",
          flush=True)
    if fp.platform != "gpu" or fp.hbm_bytes != \
            torch.cuda.get_device_properties(0).total_memory:
        raise AssertionError(f"tune: the fingerprint misreads the card: "
                             f"{fp}")
    scn = registry.get("flagship_100")
    parts = scn.batch_parts(device="cuda")
    batch, gwb = parts[0], scn.sim_kwargs(*parts)["gwb"]
    npsr, ntoa = batch.npsr, batch.max_toa
    shape = shape_tag(npsr, npsr, ntoa)

    # the main path: the search, every count zeroed just before
    flightrec.clear()
    reset_counts()
    t0 = time.perf_counter()
    cfg, info = tune.search(batch, gwb=gwb, mesh_devices=devices,
                            nreal_hint=TUNE_NREAL, budget_s=TUNE_BUDGET_S,
                            max_candidates=TUNE_MAX_CANDIDATES, force=True,
                            store=store, artifact=os.path.join(
                                store_dir, "tune.jsonl"))
    search_s = time.perf_counter() - t0
    moved = {k: v for k, v in counts().items() if v}
    add_launches(report, shape, moved)
    notes = [e["name"] for e in flightrec.snapshot()]
    for rec in info["records"]:
        print(f"tune: probe {json.dumps(rec['knobs'])}: "
              f"{rec['real_per_s_per_chip']:.1f} realizations/s, probe_s "
              f"{rec['probe_s']:.3f}, peak_hbm_bytes "
              f"{rec['peak_hbm_bytes']}", flush=True)
    print(f"tune: search {search_s:.1f} s, {info['probes']} probes, chose "
          f"{json.dumps(cfg.knobs)}, metrics {json.dumps(cfg.metrics)}, "
          f"launches {moved}", flush=True)
    out.update(search_s=search_s, probes=info["probes"],
               records=info["records"], knobs=cfg.knobs,
               metrics=cfg.metrics, search_launches=moved,
               failed_probes=notes.count("tune_probe_failed"))
    default = tune.default_candidate(TUNE_NREAL, len(devices)).knobs()
    if not any(r["knobs"] == default for r in info["records"]):
        raise AssertionError(f"tune: the hand-set candidate {default} was "
                             f"not probed")
    # holds by construction (the choice is the best of the probe records,
    # the hand-set's among them): a check of search()'s bookkeeping, not
    # an A/B; the chunk A/B below is the controlled reading
    if cfg.metrics["real_per_s_per_chip"] < \
            cfg.metrics["hand_set_real_per_s_per_chip"]:
        raise AssertionError(f"tune: the choice delivers less than the "
                             f"hand-set candidate: {cfg.metrics}")
    paths = {r["knobs"]["path"] for r in info["records"]}
    if not {"fused", "mega"} <= paths:
        raise AssertionError(f"tune: no completed fused and mega probes: "
                             f"{paths}")
    if "tune_probe_degraded" in notes:
        raise AssertionError("tune: a probe degraded off its candidate")
    if not (moved.get("binned_correlation") and moved.get("chunk_stats")):
        raise AssertionError(f"tune: the fused and mega probes did not "
                             f"launch #1 and #3 through run(): {moved}")
    if RunReport.load(os.path.join(store_dir, "tune.jsonl")).summary()[
            "tuned"] != 1:
        raise AssertionError("tune: the artifact does not read as tuned")

    # a second search is warm: one store read, no probe
    t0 = time.perf_counter()
    cfg2, info2 = tune.search(batch, gwb=gwb, mesh_devices=devices,
                              nreal_hint=TUNE_NREAL, store=store)
    warm_s = time.perf_counter() - t0
    out["warm_search_s"] = warm_s
    print(f"tune: warm search {warm_s:.3f} s, {info2['probes']} probes",
          flush=True)
    if not info2["warm"] or info2["probes"] or warm_s >= 1.0 \
            or cfg2.knobs != cfg.knobs:
        raise AssertionError(f"tune: the second search was not warm: "
                             f"{info2}, {warm_s:.3f} s")

    # run(tuned=True) from the store against the same knobs given
    # explicitly; their launches count
    knobs = cfg.knobs
    prec = knobs["precision"]
    run_kw = dict(chunk=knobs["chunk"], pipeline_depth=knobs["pipeline_depth"],
                  precision=prec)
    old_env = os.environ.get(tune_defaults.TUNE_DIR_ENV)
    os.environ[tune_defaults.TUNE_DIR_ENV] = store_dir
    try:
        reset_counts()
        tuned = flagship_sim("fused").run(TUNE_NREAL, seed=1, tuned=True)
        explicit = flagship_sim(knobs["path"]).run(TUNE_NREAL, seed=1,
                                                   **run_kw)
        moved = {k: v for k, v in counts().items() if v}
        add_launches(report, shape, moved)
        applied = tuned["report"].meta.get("tuned", {}).get("knobs", {})
        want = {k: knobs[k] for k in ("chunk", "pipeline_depth", "path",
                                      "precision") if knobs[k] is not None}
        print(f"tune: run(tuned=True) applied {json.dumps(applied)} on "
              f"{tuned['statistic_path']} [{tuned['precision']}], "
              f"launches {moved}", flush=True)
        if applied != want or tuned["report"].summary().get("tuned") != 1:
            raise AssertionError(f"tune: run(tuned=True) applied {applied}, "
                                 f"the store holds {want}")
        assert_identical(tuned, explicit, "tune: run(tuned=True) vs the "
                                          "explicit knobs")
        out["vs_einsum"] = hold_to_einsum(tuned, info["records"])
        out["chunk_ab"] = chunk_ab(knobs, tuned["precision"])

        # warm_start, then clear_executables: each run bit-identical
        sim = flagship_sim(knobs["path"])
        t0 = time.perf_counter()
        warm_start_s = sim.warm_start(knobs["chunk"], precision=prec)
        first = sim.run(TUNE_NREAL, seed=1, **run_kw)
        sim.clear_executables()
        again = sim.run(TUNE_NREAL, seed=1, **run_kw)
        for got, what in ((first, "after warm_start"),
                          (again, "after clear_executables")):
            assert_identical(got, explicit, f"tune: a run {what}")
            if got["report"].compile_s:
                raise AssertionError(f"tune: a run {what} built kernels")
        lat = {"warm_start_s": warm_start_s,
               "first_chunk_execute_s": first["report"].chunks[0].get(
                   "execute_s"),
               "steady_chunk_execute_s": again["report"].chunks[0].get(
                   "execute_s"),
               "first_run_total_s": first["report"].total_s,
               "steady_run_total_s": again["report"].total_s}
        out["warm_start"] = lat
        print(f"tune: warm_start {warm_start_s:.3f} s; then the first "
              f"chunk's device time {lat['first_chunk_execute_s']:.4f} s "
              f"against a steady chunk's {lat['steady_chunk_execute_s']:.4f}"
              f" s (runs {lat['first_run_total_s']:.3f} / "
              f"{lat['steady_run_total_s']:.3f} s); reruns bit-identical",
              flush=True)

        # the sampler takes the store's pipeline depth
        spec = SampleSpec(model=flagship_model(), **MP_SAMPLE_SPEC)
        study = SamplingRun(batch, spec, device="cuda", data_seed=1)
        kw = dict(seed=1, segment=MP_SAMPLE_STEPS)
        s_tuned = study.run(MP_SAMPLE_STEPS, tuned=True, **kw)
        study.warm_start(MP_SAMPLE_STEPS, segment=MP_SAMPLE_STEPS)
        s_explicit = study.run(MP_SAMPLE_STEPS,
                               pipeline_depth=knobs["pipeline_depth"], **kw)
        got = s_tuned["report"].meta.get("tuned")
        print(f"tune: SamplingRun.run(tuned=True) took {got} at depth "
              f"{s_tuned['report'].meta['pipeline_depth']}", flush=True)
        if got != {"knobs": {"pipeline_depth": knobs["pipeline_depth"]}} \
                or not np.array_equal(s_tuned["theta"],
                                      s_explicit["theta"]):
            raise AssertionError(f"tune: the sampler did not take the "
                                 f"stored depth bit-identically: {got}")
    finally:
        if old_env is None:
            os.environ.pop(tune_defaults.TUNE_DIR_ENV, None)
        else:
            os.environ[tune_defaults.TUNE_DIR_ENV] = old_env
    out["phase_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()


#: the serve phase's spec: the flagship's widths (P = 100, T = 780, red
#: 30 and DM 100 bins, a 30-bin HD background; K = 320 on mega), built
#: by ``ArraySpec.build``: the port's default served path, fused bf16
SERVE_SPEC = dict(npsr=100, ntoa=780, n_red=30, n_dm=100, gwb_ncomp=30)
SERVE_REQUESTS = 64
SERVE_OS_REQUESTS = 16
#: a served cohort of detection requests with the null stream: (n, seed)
SERVE_NULL_COHORT = ((5, 41), (9, 42), (7, 43))
SERVE_DEADLINE_S = 300


def served_kernel_rows(report: dict, sim, R: int, tag: str, spec=None,
                       null: bool = False) -> dict:
    """#1 (``binned_correlation``) at bf16 on ``R`` realizations of the
    served simulator's own residuals, against its plain version (TOL), timed
    beside its plain version, one ``einsum("rpt,rqt,npq->rn")`` library
    call and the bound; with ``spec`` the OS lane's weights (the null
    stream's with ``null``). Rows go to ``report["kernels"]`` under
    ``tag``; the launches made here only compare and are not counted."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.parallel.montecarlo import _NULL_TAG, _chunk_keys
    from fakepta_tpu_torch.utils import rng

    keys = _chunk_keys(rng.key(7, device="cuda"), 0, R)
    if null:
        keys = rng.fold_in(keys, _NULL_TAG)
    with torch.no_grad():
        res = sim._residuals(keys, null=null)
    w = sim._stat_weights
    if spec is not None:
        main, w_null = sim._prepare_lanes(spec).weights[id(sim._full)]
        w = w_null if null else main
    torch.cuda.synchronize()
    _, P, T = res.shape
    NB = w.shape[0]
    corr, binf = stat_flops(R, P, P, T, NB, shared=True)
    nbytes = 4.0 * (R * P * T + NB * P * P + R * NB)
    rows = {}
    kernel_rows(
        rows, "binned_correlation", tag,
        lambda p: bc.binned_correlation(res, res, w, NB - 1, precision=p),
        lambda p: bc.binned_correlation_plain(res, res, w, NB - 1,
                                              precision=p),
        lambda: torch.einsum("rpt,rqt,npq->rn", res, res, w),
        lambda p: nbytes, lambda p: corr_flops_split(p, corr, binf),
        iters=20, precs=("bf16",))
    report.setdefault("kernels", {}).update(
        {"/".join(k): dict(v, realizations=R) for k, v in rows.items()})
    reset_counts()
    return rows[("binned_correlation", "bf16", tag)]


def read_line(proc, timeout_s: float) -> str:
    """One stdout line of ``proc`` within ``timeout_s``, else kill it and
    raise."""
    import threading
    got = []
    reader = threading.Thread(target=lambda: got.append(
        proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout_s)
    if not got:
        proc.kill()
        raise AssertionError(f"no line from {proc.args[:4]} in "
                             f"{timeout_s} s")
    return got[0]


def serve_protocol(out: dict, pool, spec) -> None:
    """A ``replica --port 0`` subprocess on the card: its banner, one line
    of each served and inline kind (the sim answer equal to the same
    request through ``pool``, in process), then ``obs top`` and ``obs
    alerts`` against its socket; the replica is stopped at the end."""
    import socket
    from fakepta_tpu_torch.serve import SimRequest

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in SERVE_SPEC.items()]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fakepta_tpu_torch.serve", "replica",
         "--port", "0", *flags], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        banner = json.loads(read_line(proc, 180))
        if banner.get("event") != "ready" or banner.get("n_devices") != 1:
            raise AssertionError(f"serve: replica banner {banner}")
        port = banner["port"]
        out["replica_ready_s"] = time.perf_counter() - t0
        lines = {
            "sim": {"id": "sim", "kind": "sim", "n": 8, "seed": 7},
            "os": {"id": "os", "kind": "os", "n": 4, "seed": 8,
                   "null": True},
            "ping": {"id": "ping", "kind": "ping"},
            "stats": {"id": "stats", "kind": "stats"},
            "telemetry": {"id": "telemetry", "kind": "telemetry"},
            "metrics": {"id": "metrics", "kind": "metrics"}}
        replies = {}
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=SERVE_DEADLINE_S) as conn:
            rfile = conn.makefile("rb")
            for name, line in lines.items():
                conn.sendall((json.dumps(line) + "\n").encode())
                replies[name] = json.loads(rfile.readline())
        for name, rep in replies.items():
            if not rep.get("ok") or rep.get("id") != name:
                raise AssertionError(f"serve: replica answered {name} with "
                                     f"{str(rep)[:300]}")
        sim = replies["sim"]
        curves = np.asarray(sim["curves"], dtype=np.float32)
        autos = np.asarray(sim["autos"], dtype=np.float32)
        hd = replies["os"]["os"]["hd"]
        if curves.shape != (8, spec.nbins) or autos.shape != (8,) \
                or len(hd["amp2"]) != 4 or len(hd["null_amp2"]) != 4 \
                or not np.isfinite(curves).all():
            raise AssertionError(f"serve: replica answer shapes "
                                 f"{curves.shape}, {autos.shape}, "
                                 f"{sorted(hd)}")
        want = pool.serve(SimRequest(spec=spec, n=8, seed=7),
                          timeout=SERVE_DEADLINE_S)
        if want.bucket != sim["bucket"] or not (
                np.array_equal(curves, want.curves)
                and np.array_equal(autos, want.autos)):
            raise AssertionError("serve: the replica's sim answer differs "
                                 "from the same request in process")
        if replies["ping"] != {"id": "ping", "ok": True, "pong": True} \
                or replies["stats"]["stats"]["serve_requests"] < 2 \
                or replies["stats"]["health"]["state"] != "healthy" \
                or "slo" not in replies["telemetry"]["telemetry"] \
                or 'fakepta_up{replica="self"} 1' not in \
                replies["metrics"]["metrics"]:
            raise AssertionError(f"serve: inline kinds {replies['stats']}")
        out["replica_stats"] = replies["stats"]["stats"]
        for verb in (["top", f"127.0.0.1:{port}", "--iterations", "1"],
                     ["alerts", f"127.0.0.1:{port}"]):
            cli = subprocess.run(
                [sys.executable, "-m", "fakepta_tpu_torch.obs", *verb],
                cwd=HERE, env=env, capture_output=True, text=True,
                timeout=180)
            print(f"serve: obs {verb[0]} -> exit {cli.returncode}\n"
                  + "\n".join("  " + ln for ln in
                              cli.stdout.strip().splitlines()), flush=True)
            if cli.returncode != 0 or not cli.stdout.strip():
                raise AssertionError(f"serve: obs {verb[0]} failed: "
                                     f"{cli.stderr[-2000:]}")
            out[f"obs_{verb[0]}"] = cli.stdout
        if not out["obs_top"].startswith("fleet: 1 replicas"):
            raise AssertionError(f"serve: obs top printed {out['obs_top']}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    out["protocol_s"] = time.perf_counter() - t0
    print(f"serve: protocol against a replica subprocess (ready in "
          f"{out['replica_ready_s']:.1f} s): sim, os+null, ping, stats, "
          f"telemetry, metrics, obs top, obs alerts in "
          f"{out['protocol_s']:.1f} s", flush=True)


def serve_gate(out: dict, path: str) -> None:
    """``obs gate`` on the loadgen's saved report against the committed
    history: the card's 'gpu' row bands against no JAX round."""
    from fakepta_tpu_torch.obs import gate
    cli = subprocess.run(
        [sys.executable, "-m", "fakepta_tpu_torch.obs", "gate", path,
         "--fail-on-regression"], cwd=HERE, capture_output=True, text=True,
        timeout=180, env=dict(os.environ, PYTHONPATH=HERE))
    print("serve: obs gate -> exit "
          f"{cli.returncode}: {cli.stdout.strip()}", flush=True)
    if cli.returncode != 0 or "no comparable history" not in cli.stdout \
            or "platform='gpu'" not in cli.stdout:
        raise AssertionError(f"serve: obs gate: {cli.stdout} "
                             f"{cli.stderr[-2000:]}")
    row = gate.load_row(path)
    history = gate.load_history(gate.resolve_history(
        [os.path.join(HERE, gate.DEFAULT_HISTORY_GLOB)]),
        warn=lambda m: print(f"serve: gate history: {m}", flush=True))
    results = gate.gate_row(row, history)
    if row["platform"] != "gpu" or not history or not results or any(
            r.verdict != "info" or r.n_history for r in results):
        raise AssertionError(f"serve: the card row banded against the "
                             f"history: {row.get('platform')}, "
                             f"{[vars(r) for r in results][:5]}")
    out["gate"] = {"history_rows": len(history), "metrics": len(results)}


def phase_serve(report: dict) -> None:
    """Serving on the card (module docstring, phase ``serve``)."""
    import torch
    from fakepta_tpu_torch.detect import OSSpec
    from fakepta_tpu_torch.ops import _build
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    from fakepta_tpu_torch.serve import ArraySpec, OSRequest, ServePool
    from fakepta_tpu_torch.serve.loadgen import DEFAULT_SIZES, run_loadgen

    t_phase = time.perf_counter()
    out = report.setdefault("serve", {})
    spec = ArraySpec(**SERVE_SPEC)
    serve_dir = os.path.join(HERE, "build", "serve")
    shutil.rmtree(serve_dir, ignore_errors=True)
    os.makedirs(serve_dir)
    _build.build()
    # a kernel built from here on fails the phase
    nvcc = {"starts": 0}
    real_start = _build.start_nvcc

    def counted_start(*a, **kw):
        nvcc["starts"] += 1
        return real_start(*a, **kw)

    _build.start_nvcc = counted_start
    runs0 = GUARD["runs"]
    plain = shape_tag(spec.npsr, spec.npsr, spec.ntoa)
    gates = ("serve_failed", "serve_dispatch_retries", "serve_evictions",
             "serve_steady_compiles", "serve_retraces",
             "serve_deadline_cancelled")
    try:
        # 1. + 2.: the load generator, sim then os, each with its launches
        rows = {}
        for kind, n_req, verify, baseline in (
                ("sim", SERVE_REQUESTS, 3, True),
                ("os", SERVE_OS_REQUESTS, 2, False)):
            reset_counts()
            t0 = time.perf_counter()
            row = run_loadgen(
                spec, n_requests=n_req, sizes=DEFAULT_SIZES, kind=kind,
                verify=verify, baseline=baseline,
                report_path=(os.path.join(serve_dir, "serve.jsonl")
                             if kind == "sim" else None))
            torch.cuda.synchronize()
            moved = {k: v for k, v in counts().items() if v}
            tag = plain if kind == "sim" else shape_tag(
                spec.npsr, spec.npsr, spec.ntoa, spec.nbins + 2)
            add_launches(report, tag, moved)
            row.update(loadgen_s=time.perf_counter() - t0, launches=moved)
            rows[kind] = row
            print(f"serve: loadgen {kind} x{n_req}: p50 "
                  f"{row['serve_p50_ms']} ms, p99 {row['serve_p99_ms']} ms, "
                  f"{row['serve_qps_per_chip']} qps/card, coalesce "
                  f"{row['coalesce_factor']}, pad waste "
                  f"{row['pad_waste_frac']}, serial "
                  f"{row.get('serve_serial_qps_per_chip')} qps/card, "
                  f"speedup x{row.get('serve_speedup_x')}; warm-up s by "
                  f"bucket {row['serve_warm_s_by_bucket']}; verified "
                  f"{row['serve_verified']} (solo distance "
                  f"{row['serve_verify_err']}); launches {moved}; "
                  f"{row['loadgen_s']:.1f} s", flush=True)
            bad = {k: row[k] for k in gates if row[k]}
            if bad or row["serve_requests"] != n_req \
                    or row["serve_verified"] != verify \
                    or not moved.get("binned_correlation"):
                raise AssertionError(f"serve: loadgen {kind} gates: {bad}, "
                                     f"{row['serve_requests']} served, "
                                     f"{row['serve_verified']} verified, "
                                     f"launches {moved}")
        out["loadgen"] = rows

        # a served cohort of detection requests with the null stream, each
        # response equal to its request alone and, with the cohort's
        # curves, to the einsum path on the same lanes (bf16 bounds)
        pool = ServePool()
        try:
            reset_counts()
            futs = [pool.submit(OSRequest(spec=spec, n=n, seed=s,
                                          null=True))
                    for n, s in SERVE_NULL_COHORT]
            res = [f.result(timeout=SERVE_DEADLINE_S) for f in futs]
            moved = {k: v for k, v in counts().items() if v}
            n_bc = moved.get("binned_correlation", 0)
            if not n_bc or n_bc % 2:
                raise AssertionError(f"serve: the null cohort launched "
                                     f"{moved}")
            main_tag, null_tag = lane_shapes(
                pool._pool.get(spec.spec_hash(), spec).sim, "fused", 1, 1)
            add_launches(report, main_tag, {"binned_correlation": n_bc // 2})
            add_launches(report, null_tag, {"binned_correlation": n_bc // 2})
            sim = pool._pool.get(spec.spec_hash(), spec).sim
            batch, gwb = spec.parts(device="cuda")
            ref = EnsembleSimulator(batch, gwb=gwb, nbins=spec.nbins,
                                    stat_path="einsum", device="cuda")
            os_spec = OSSpec(orf="hd", null=True)
            bucket = res[0].bucket
            lanes = [(s, n) for n, s in SERVE_NULL_COHORT]
            want = ref.run(bucket, chunk=bucket, lanes=lanes,
                           pipeline_depth=0, os=os_spec)
            pos, cohort = 0, {"bucket": bucket,
                              "cohort": [r.cohort_requests for r in res]}
            for (n, s), r in zip(SERVE_NULL_COHORT, res):
                alone = sim.run(bucket, chunk=bucket, lanes=[(s, n)],
                                pipeline_depth=0, os=os_spec)
                got_os, alone_os = r.os["stats"]["hd"], \
                    alone["os"]["stats"]["hd"]
                if not (np.array_equal(r.curves, alone["curves"][:n])
                        and all(np.array_equal(got_os[k], alone_os[k][:n])
                                for k in ("amp2", "null_amp2"))):
                    raise AssertionError(f"serve: OS request {s} differs "
                                         f"from itself alone")
                sl = slice(pos, pos + n)
                pos += n
                lane = {"os": {"orfs": ["hd"], "stats": {"hd": {
                    k: got_os[k] for k in ("amp2", "null_amp2")}}}}
                ref_lane = {"os": {"orfs": ["hd"], "stats": {"hd": {
                    k: want["os"]["stats"]["hd"][k][sl]
                    for k in ("amp2", "null_amp2")}}}}
                cohort[f"seed {s}"] = dict(
                    compare((r.curves, r.autos),
                            (want["curves"][sl], want["autos"][sl]),
                            "bf16", f"serve: cohort lane {s} vs einsum"),
                    **os_compare(lane, ref_lane, "bf16",
                                 f"serve: cohort lane {s} OS vs einsum"))
            if {r.cohort_requests for r in res} != {len(res)}:
                raise AssertionError(f"serve: the null cohort did not "
                                     f"coalesce: {cohort['cohort']}")
            out["null_cohort"] = cohort
            slo = pool.slo_summary()
            if any(slo[k] for k in gates):
                raise AssertionError(f"serve: null cohort gates {slo}")

            # 3. the protocol, against a replica subprocess
            reset_counts()
            serve_protocol(out, pool, spec)
            add_launches(report, plain, {k: v for k, v in counts().items()
                                         if v})
        finally:
            pool.close()
    finally:
        _build.start_nvcc = real_start
    if nvcc["starts"]:
        raise AssertionError(f"serve: {nvcc['starts']} kernel build(s) "
                             f"after warm-up")

    # 4. the gate on step 1's saved report
    serve_gate(out, os.path.join(serve_dir, "serve.jsonl"))

    # 5. #1 at served sizes: R = 16 and 1024 (bf16), and any shape the
    # served path launched at that no earlier phase measured
    kernels = report.setdefault("kernels", {})
    out["kernels"] = {}
    for R in (16, 1024):
        out["kernels"][f"R={R}"] = served_kernel_rows(
            report, sim, R, f"{plain} R={R}")
    for tag, kw in ((plain, {}),
                    (main_tag, {"spec": OSSpec(orf="hd")}),
                    (null_tag, {"spec": os_spec, "null": True})):
        if f"binned_correlation/bf16/{tag}" not in kernels:
            out["kernels"][tag] = served_kernel_rows(report, sim, 1024, tag,
                                                     **kw)

    # 6. bookkeeping: every served run went through the run guard
    out["guard_runs"] = GUARD["runs"] - runs0
    if out["guard_runs"] <= 0:
        raise AssertionError("serve: no engine run passed the run guard")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve: {out['guard_runs']} engine runs, none degraded; phase "
          f"{out['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()


FLEET_SPECS = 4
FLEET_REQUESTS = 128
FLEET_OS_REQUESTS = 16
FLEET_KILL_AT = 0.5
#: the elastic round: replicas, requests, sizes and specs (the flagship's
#: widths; the counts are the cut)
FLEET_ELASTIC = dict(n_replicas=3, n_requests=32, sizes=(1, 2, 4),
                     n_specs=2)
#: the sampling session: the flagship's 30-bin free-spectrum CURN, cut in
#: steps (4 warm-up and 8 post steps in segments of 4)
FLEET_SESSION = dict(n_steps=8, seed=3, segment=4, nbin=30, n_chains=4,
                     warmup=4, n_leapfrog=4)
FLEET_APPENDS = 3
FLEET_APPEND_RTOL = 1e-10


def fleet_kernel_counts(replicas) -> dict:
    """{replica id: its process's kernel summary} of the live ones."""
    return {rid: r.kernel_summary(timeout=120.0)
            for rid, r in replicas.items() if r.alive}


def fleet_launch_delta(before: dict, after: dict) -> dict:
    """{kernel: {bucket: launches}} made between two readings (summed over
    replicas; a replica absent from ``before`` counts from zero)."""
    out: dict = {}
    for rid, summ in after.items():
        old = before.get(rid, {}).get("launches_by_bucket", {})
        for k, by in summ.get("launches_by_bucket", {}).items():
            for b, n in by.items():
                d = n - old.get(k, {}).get(b, 0)
                if d:
                    out.setdefault(k, {})
                    out[k][b] = out[k].get(b, 0) + d
    return out


def fleet_appends(out: dict, flt, spec, device: str) -> None:
    """``FLEET_APPENDS`` 8-TOA epochs of the flagship array through the
    fleet (stream affinity: one owner), their moments held to a direct
    :class:`StreamState` on the same blocks within FLEET_APPEND_RTOL."""
    from fakepta_tpu_torch.serve import AppendRequest, StreamRequest
    from fakepta_tpu_torch.stream import StreamState

    rng = np.random.default_rng(18)
    span = 15.0 * STREAM_YR
    blocks = []
    for k in range(FLEET_APPENDS):
        lo, hi = 0.2 * span + 0.1 * k * span, 0.2 * span + 0.1 * (k + 1) * span
        t = np.sort(rng.uniform(lo, hi, (spec.npsr, 8)), axis=1)
        blocks.append((t, rng.normal(0.0, 1e-7, (spec.npsr, 8))))
    t0 = time.perf_counter()
    infos = [flt.serve(AppendRequest(stream="fleet", toas=t, residuals=r,
                                     spec=spec), timeout=SERVE_DEADLINE_S)
             for t, r in blocks]
    append_s = time.perf_counter() - t0
    owners = {i["replica"] for i in infos}
    stats = flt.serve(StreamRequest(stream="fleet"), timeout=SERVE_DEADLINE_S)
    if len(owners) != 1 or stats["replica"] not in owners \
            or stats["n_toas"] != FLEET_APPENDS * 8 * spec.npsr:
        raise AssertionError(f"fleet: stream affinity {owners}, {stats}")
    state = flt.replicas[stats["replica"]].pool._stream_mgr._streams[
        "fleet"].state
    direct = StreamState(spec.parts(device="cpu")[0], device=device)
    for t, r in blocks:
        direct.append(t, r)
    err = moments_rel_err(state.moments(), direct.moments())
    out["appends"] = {"n": FLEET_APPENDS, "toas": stats["n_toas"],
                      "replica": stats["replica"], "rel_err": err,
                      "append_ms": [i["latency_ms"] for i in infos],
                      "total_s": append_s}
    print(f"fleet: {FLEET_APPENDS} 8-TOA appends through the fleet on "
          f"{stats['replica']} in {append_s:.2f} s; moments vs a direct "
          f"StreamState {err:.3e} (bound {FLEET_APPEND_RTOL})", flush=True)
    if not err <= FLEET_APPEND_RTOL:
        raise AssertionError(f"fleet: appended moments off by {err}")


def fleet_elastic(out: dict, spec, devices) -> None:
    """The elastic round on socket replicas: wedge, kill and join; nothing
    lost, no timeout, the breaker opened and the joined replica started no
    nvcc and built nothing."""
    from fakepta_tpu_torch.serve import HealthConfig, ServeConfig
    from fakepta_tpu_torch.serve.loadgen import run_elastic_loadgen

    t0 = time.perf_counter()
    erow = run_elastic_loadgen(
        spec, transport="process", config=ServeConfig(
            buckets=(16, 32)), devices=devices, verify=2,
        health_config=HealthConfig(
            period_s=0.05, probe_deadline_s=0.5, suspect_after=2,
            wedged_after=4, close_after=2, backoff_base_s=0.05,
            backoff_cap_s=0.2), **FLEET_ELASTIC)
    erow["loadgen_s"] = time.perf_counter() - t0
    out["elastic"] = erow
    print(f"fleet: elastic round ({FLEET_ELASTIC['n_replicas']} "
          f"replicas, wedge {erow['fleet_wedged_replica']} -> "
          f"{erow['fleet_wedge_state']}, kill "
          f"{erow['fleet_killed_replica']}, join "
          f"{erow.get('fleet_joined_replica')}): lost "
          f"{erow['fleet_lost_requests']}, timeouts "
          f"{erow['fleet_timeouts']}, failovers "
          f"{erow['fleet_failovers']}, breaker opens "
          f"{erow.get('fleet_breaker_opens')}, joined replica nvcc "
          f"{erow.get('fleet_join_nvcc_starts')} / steady builds "
          f"{erow.get('fleet_join_steady_compiles')}; "
          f"{erow['loadgen_s']:.1f} s", flush=True)
    if erow["fleet_lost_requests"] or erow["fleet_timeouts"] \
            or erow["fleet_joins"] < 1 \
            or erow.get("fleet_join_nvcc_starts") != 0 \
            or erow.get("fleet_join_steady_compiles") != 0 \
            or erow["fleet_wedge_state"] not in ("suspect", "wedged"):
        raise AssertionError(f"fleet: elastic round {erow}")


def fleet_session_reference(flt, spec) -> dict:
    """The flagship CURN session's uninterrupted run on its ring owner (no
    fault plan: it runs beside the elastic round, whose plan arms only the
    ``fleet.heartbeat`` site), with its build and run seconds."""
    from fakepta_tpu_torch.serve import SampleSessionSpec

    sess = SampleSessionSpec(spec=spec, **FLEET_SESSION)
    owner = flt.ring.owner(sess.session_hash())
    t0 = time.perf_counter()
    run = flt.replicas[owner].sampling_run(sess)
    t1 = time.perf_counter()
    ref = run.run(sess.n_steps, seed=sess.seed, segment=sess.segment,
                  pipeline_depth=0)
    return {"theta": ref["theta"], "build_s": t1 - t0,
            "run_s": time.perf_counter() - t1}


def fleet_session(out: dict, flt, spec, ck_dir: str, ref: dict) -> None:
    """The flagship CURN session with replica affinity: the owner killed at
    its third segment (``sample.segment`` kill), the session migrates to
    the sibling, resumes at the segment-boundary checkpoint and ends bit
    for bit the uninterrupted run ``ref`` (:func:`fleet_session_reference`;
    and so do its streamed segments)."""
    from fakepta_tpu_torch import faults
    from fakepta_tpu_torch.serve import SampleSessionSpec

    sess = SampleSessionSpec(spec=spec, **FLEET_SESSION)
    owner = flt.ring.owner(sess.session_hash())
    ref_s = ref["build_s"] + ref["run_s"]
    streamed = {}
    plan = faults.FaultPlan(
        [faults.FaultSpec("sample.segment", "kill", at=(2,))])
    t0 = time.perf_counter()
    with faults.inject(plan):
        got = flt.start_session(sess, os.path.join(ck_dir, "session")).run(
            on_segment=lambda i, a: streamed.setdefault(i, np.array(a)))
    sess_s = time.perf_counter() - t0
    kept = np.concatenate([streamed[i] for i in sorted(streamed)])
    info = dict(got["session"], owner=owner, draws=list(got["theta"].shape),
                reference_s=ref_s, reference_build_s=ref["build_s"],
                session_s=sess_s,
                rhat_max=got["summary"].get("rhat_max"))
    out["session"] = info
    print(f"fleet: sample session {info['hash'][:10]} ({sess.nbin}-bin "
          f"CURN, {sess.n_chains} chains, {sess.n_steps} steps): owner "
          f"{owner} killed at segment 2, resumed on {info['replica']} "
          f"({info['migrations']} migration) in {sess_s:.1f} s, the "
          f"uninterrupted run {ref_s:.1f} s ({ref['build_s']:.1f} s of it "
          f"the SamplingRun's build)", flush=True)
    if info["migrations"] != 1 or info["replica"] == owner \
            or not np.array_equal(got["theta"], ref["theta"]) \
            or not np.array_equal(kept, ref["theta"]):
        raise AssertionError(f"fleet: the migrated session is not the "
                             f"uninterrupted run: {info}")


def phase_fleet(report: dict, cards: int = 1) -> None:
    """The serve fleet on the card (module docstring, phase ``fleet``)."""
    import torch
    from fakepta_tpu_torch.detect import OSSpec
    from fakepta_tpu_torch.ops import _build
    from fakepta_tpu_torch.serve import (ArraySpec, LocalReplica,
                                         ServeConfig, ServeFleet, loadgen)
    from fakepta_tpu_torch.serve.loadgen import (DEFAULT_SIZES,
                                                 run_fleet_loadgen)

    t_phase = time.perf_counter()
    out = report.setdefault("fleet", {})
    spec = ArraySpec(**SERVE_SPEC)
    fleet_dir = os.path.join(HERE, "build", "fleet")
    shutil.rmtree(fleet_dir, ignore_errors=True)
    os.makedirs(fleet_dir)
    devices = [f"cuda:{i}" for i in range(cards)]
    n_rep = max(2, cards)
    _build.build()
    nvcc0 = _build.nvcc_starts
    plain = shape_tag(spec.npsr, spec.npsr, spec.ntoa)
    os_tag = shape_tag(spec.npsr, spec.npsr, spec.ntoa, spec.nbins + 2)
    gates = ("fleet_failed", "fleet_timeouts", "fleet_lost_requests",
             "fleet_steady_compiles", "fleet_retraces")
    launched = {}
    # 1. + 2.: the load on socket replicas (one card shared, or a card
    # each): os; sim beside the one-pool baseline, no kill; then the same
    # sim list again, killing the first spec's owner at half of it
    config = ServeConfig()
    t0 = time.perf_counter()
    flt = loadgen._build_fleet(n_rep, "process", spec, config, None,
                               devices=devices)
    out["spawn_s"] = time.perf_counter() - t0
    rows = {}
    try:
        for name, kind, n_req, kw in (
                ("os", "os", FLEET_OS_REQUESTS, dict(verify=2)),
                ("sim", "sim", FLEET_REQUESTS, dict(verify=3,
                                                    baseline=True)),
                ("kill", "sim", FLEET_REQUESTS, dict(
                    verify=3, kill_one_at=FLEET_KILL_AT))):
            before = fleet_kernel_counts(flt.replicas)
            t0 = time.perf_counter()
            row = run_fleet_loadgen(
                spec, fleet=flt, n_requests=n_req, sizes=DEFAULT_SIZES,
                kind=kind, n_specs=FLEET_SPECS, config=config,
                devices=devices, **kw)
            after = fleet_kernel_counts(flt.replicas)
            if "fleet_killed_kernels" in row:
                # read just before the kill: the launches of the cohorts
                # then in flight on it are not counted
                after[row["fleet_killed_replica"]] = \
                    row["fleet_killed_kernels"]
            moved = fleet_launch_delta(before, after)
            row.update(loadgen_s=time.perf_counter() - t0,
                       launches_by_bucket=moved, replica_kernels=after)
            tag = plain if kind == "sim" else os_tag
            for k, by in moved.items():
                for b, n in by.items():
                    add_launches(report, f"{tag} R={b}", {k: n})
                    launched[(tag, int(b))] = kind
            rows[name] = row
            print(f"fleet: {name} round, {kind} x{n_req} over {n_rep} "
                  f"socket replicas on {devices}: "
                  f"{row['fleet_qps_per_chip']} qps/card, p50 "
                  f"{row['fleet_p50_ms']} ms, p99 {row['fleet_p99_ms']} "
                  f"ms, warm hit {row['fleet_warm_hit_rate']}, failovers "
                  f"{row['fleet_failovers']}, lost "
                  f"{row['fleet_lost_requests']}, timeouts "
                  f"{row['fleet_timeouts']}, speedup "
                  f"x{row.get('fleet_speedup_x')} (one pool "
                  f"{row.get('fleet_solo_qps')} qps); ready s "
                  f"{row['fleet_ready_s']}; verified "
                  f"{row.get('fleet_verified')} "
                  f"({row.get('fleet_verified_failover')} failed over); "
                  f"#1 launches by bucket {moved}; "
                  f"{row['loadgen_s']:.1f} s", flush=True)
            print("fleet: replica memory (bytes) " + json.dumps(
                {rid: k.get("memory") for rid, k in after.items()}),
                flush=True)
            bad = {k: row[k] for k in gates if row.get(k)}
            nb = sum(moved.get("binned_correlation", {}).values())
            if bad or row["fleet_requests"] != n_req or not nb \
                    or set(moved) != {"binned_correlation"}:
                raise AssertionError(f"fleet: {name} gates {bad}, "
                                     f"{row['fleet_requests']} served, "
                                     f"launches {moved}")
        # every failed-over response was verified bit for bit inside the
        # load generator (it raises on a mismatch)
        kill_row = rows["kill"]
        if kill_row["fleet_replica_deaths"] != 1 \
                or kill_row["fleet_failovers"] < 1:
            raise AssertionError(f"fleet: the kill round {kill_row}")
        nv = {rid: k["nvcc_starts"] for rid, k in
              kill_row["replica_kernels"].items()}
        if any(nv.values()):
            raise AssertionError(f"fleet: replicas started nvcc {nv}")
    finally:
        flt.close()
    out["load"] = rows

    # 3. the elastic round: wedge, kill and join (socket replicas; the
    # joined replica must start no nvcc), with the sampling session's
    # uninterrupted run on two in-process replicas beside it
    local = ServeFleet([LocalReplica(f"s{i}", device=devices[0],
                                     index=i) for i in range(2)])
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            ref = ex.submit(fleet_session_reference, local, spec)
            fleet_elastic(out, spec, devices)
            ref = ref.result()

        # 4. + 5.: the session, migrated once, and stream appends (their
        # moments and chains are read here)
        fleet_session(out, local, spec, fleet_dir, ref)
        fleet_appends(out, local, spec, devices[0])
    finally:
        local.close()
    built = _build.nvcc_starts - nvcc0
    if built:
        raise AssertionError(f"fleet: {built} kernel build(s) in the phase")

    # 6. #1 at the cohort shapes the fleet launched (bf16), each held
    # against its plain version and timed, unless an earlier phase did
    kernels = report.setdefault("kernels", {})
    sim = spec.build(device=devices[0])
    out["kernels"] = {}
    for (tag, b), kind in sorted(launched.items()):
        full = f"{tag} R={b}"
        if f"binned_correlation/bf16/{full}" in kernels:
            continue
        out["kernels"][full] = served_kernel_rows(
            report, sim, b, full,
            spec=OSSpec(orf="hd") if kind == "os" else None)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"fleet: phase {out['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()


#: the gateway round: suite config 16's traffic (3 tenants, 96 requests
#: of sizes 1, 2 and 4 over 3 specs and 12 identities at Zipf s = 1.4,
#: seed 11, max_inflight 6, a cutover at half) on in-process replicas
GATEWAY_TRAFFIC = dict(n_tenants=3, n_requests=96, sizes=(1, 2, 4),
                       seed=11, n_specs=3, n_identities=12, zipf_s=1.4,
                       max_inflight=6, cutover_at=0.5)
#: the ng15 cadence tail replayed through the gateway (observing windows)
GATEWAY_NG15_BLOCKS = 4


def gateway_identities(spec) -> dict:
    """{(spec hash, seed, n): request} of every identity the gateway round
    asks for (its own request list, :func:`make_tenant_requests`)."""
    import dataclasses as dc
    from fakepta_tpu_torch.serve.loadgen import make_tenant_requests

    t = GATEWAY_TRAFFIC
    specs = [dc.replace(spec, data_seed=100 + i)
             for i in range(t["n_specs"])]
    reqs, _ = make_tenant_requests(specs, t["n_requests"], t["sizes"],
                                   n_identities=t["n_identities"],
                                   seed=t["seed"], zipf_s=t["zipf_s"])
    return {(r.spec.spec_hash(), r.seed, r.n): r for r in reqs}


def phase_gateway(report: dict, cards: int = 1) -> None:
    """The gateway on the card (module docstring, phase ``gateway``)."""
    import torch
    from fakepta_tpu_torch.gateway import Gateway, ResultStore, Tenant
    from fakepta_tpu_torch.ops import _build
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.scenarios import cadence, registry
    from fakepta_tpu_torch.serve import (ArraySpec, ServeConfig,
                                         StreamRequest, loadgen)
    from fakepta_tpu_torch.tune import defaults as tune_defaults

    t_phase = time.perf_counter()
    out = report.setdefault("gateway", {})
    spec = registry.get("flagship_100").serve_spec()
    if spec != ArraySpec(**SERVE_SPEC):
        raise AssertionError(f"gateway: flagship serve_spec {spec}")
    store_dir = os.path.join(HERE, "build", "gateway")
    shutil.rmtree(store_dir, ignore_errors=True)
    devices = [f"cuda:{i}" for i in range(cards)]
    n_rep = max(2, cards)
    config = ServeConfig(buckets=tune_defaults.DEFAULT_FLEET_BUCKETS)
    plain = shape_tag(spec.npsr, spec.npsr, spec.ntoa)
    _build.build()
    nvcc0 = _build.nvcc_starts

    # 1. run_gateway_loadgen at the flagship's widths; its fleet is kept
    # (the wrapper below) so each pool's launches by bucket can be read
    fleets = []
    build_fleet = loadgen._build_fleet

    def keep_fleet(*a, **kw):
        fleets.append(build_fleet(*a, **kw))
        return fleets[-1]

    loadgen._build_fleet = keep_fleet
    reset_counts()
    t0 = time.perf_counter()
    try:
        row = loadgen.run_gateway_loadgen(
            spec, n_replicas=n_rep, store_dir=store_dir, config=config,
            devices=devices, **GATEWAY_TRAFFIC)
    finally:
        loadgen._build_fleet = build_fleet
    row["loadgen_s"] = time.perf_counter() - t0
    moved = counts()
    by_bucket: dict = {}
    for r in fleets[0].replicas.values():
        for k, by in r.kernel_summary()["launches_by_bucket"].items():
            for b, n in by.items():
                by_bucket.setdefault(k, {})
                by_bucket[k][b] = by_bucket[k].get(b, 0) + n
    pooled = sum(by_bucket.get("binned_correlation", {}).values())
    for b, n in by_bucket.get("binned_correlation", {}).items():
        add_launches(report, f"{plain} R={b}", {"binned_correlation": n})
    row.update(launches=moved, launches_by_bucket=by_bucket)
    out["row"] = row
    gw_row = {k: v for k, v in row.items() if k.startswith("gw_")}
    print(f"gateway: {GATEWAY_TRAFFIC['n_requests']} requests of "
          f"{GATEWAY_TRAFFIC['n_tenants']} tenants over {n_rep} in-process "
          f"replicas on {devices}: {json.dumps(gw_row)}; "
          f"#1 launches {moved['binned_correlation']} ({pooled} in the "
          f"pools' dispatches, by bucket {by_bucket}); "
          f"{row['loadgen_s']:.1f} s", flush=True)
    if row["gw_hit_rate"] < 0.5 or row["gw_device_s_saved"] <= 0.0 \
            or row["gw_verified"] <= 0 or row["gw_cutover_ms"] <= 0.0 \
            or not pooled or moved["binned_correlation"] < pooled \
            or any(n for k, n in moved.items()
                   if k != "binned_correlation"):
        raise AssertionError(f"gateway: the round's gates {row}")

    # 2. #1 at every cohort shape the round dispatched, against its plain
    # version (bf16, the served precision) and timed
    sim = spec.build(device=devices[0])
    out["kernels"] = {}
    for b in sorted(int(b) for b in by_bucket["binned_correlation"]):
        full = f"{plain} R={b}"
        out["kernels"][full] = served_kernel_rows(report, sim, b, full)
    del sim

    # 3. a cold gateway with a new ResultStore over the round's directory,
    # in front of a new fleet on the same devices: every identity is a
    # hit, equal bit for bit to the same request served alone at its
    # bucket (the check the round held its hits to), and #1 never runs
    tenants = [Tenant("cold", "tok-cold")]
    flt = loadgen._build_fleet(n_rep, "inproc", spec, config, None,
                               devices=devices)
    gw = Gateway(flt, tenants, store=ResultStore(store_dir))
    try:
        idents = gateway_identities(spec)
        reset_counts()
        t0 = time.perf_counter()
        cold = {k: gw.serve(r, token="tok-cold", timeout=SERVE_DEADLINE_S)
                for k, r in sorted(idents.items())}
        cold_s = time.perf_counter() - t0
        cold_moved = counts()
        summ = gw.gateway_summary()
        sims: dict = {}
        for (sh, seed, n), res in cold.items():
            r = idents[(sh, seed, n)]
            if sh not in sims:
                # built the way a pool builds one (serve/pool.py)
                sims[sh] = r.spec.build(mesh=make_mesh([devices[0]]))
            alone = sims[sh].run(res.bucket, chunk=res.bucket,
                                 lanes=[(seed, n)], pipeline_depth=0)
            if res.replica != "gateway-cache" \
                    or not np.array_equal(alone["curves"][:n], res.curves) \
                    or not np.array_equal(alone["autos"][:n], res.autos):
                raise AssertionError(f"gateway: the cold store's answer for "
                                     f"{(sh, seed, n)} ({res.replica}) is "
                                     f"not the request served alone")
        del sims
        out["cold"] = {"identities": len(cold), "hits": summ["hits"],
                       "dispatched": summ["dispatched"],
                       "launches": cold_moved, "s": cold_s}
        print(f"gateway: cold gateway over the round's store: "
              f"{summ['hits']} hits of {len(cold)} identities, "
              f"{summ['dispatched']} dispatched, #1 launches "
              f"{cold_moved['binned_correlation']}, each bit for bit the "
              f"request served alone; {cold_s:.2f} s", flush=True)
        if summ["hits"] != len(cold) or summ["dispatched"] \
                or any(cold_moved.values()):
            raise AssertionError(f"gateway: cold round {out['cold']}")

        # 4. ng15's cadence tail through the gateway as served appends
        ng15 = registry.get("ng15")
        blocks = cadence.append_schedule(ng15,
                                         max_blocks=GATEWAY_NG15_BLOCKS)
        appends = cadence.as_append_requests(blocks, "gw-ng15",
                                             spec=ng15.serve_spec())
        t0 = time.perf_counter()
        infos = [gw.serve(req, token="tok-cold", timeout=SERVE_DEADLINE_S)
                 for _t, req in appends]
        tail_s = time.perf_counter() - t0
        st = gw.serve(StreamRequest(stream="gw-ng15"), token="tok-cold",
                      timeout=SERVE_DEADLINE_S)
        want = sum(int(b.counts.sum()) for b in blocks)
        out["ng15_tail"] = {"blocks": len(blocks), "toas": int(st["n_toas"]),
                            "want": want, "s": tail_s,
                            "append_ms": [i["latency_ms"] for i in infos]}
        print(f"gateway: ng15 cadence tail, {len(blocks)} observing windows "
              f"as served appends ({[b.toas.shape[1] for b in blocks]} "
              f"TOAs wide): the stream holds {st['n_toas']} TOAs of "
              f"{want}; {tail_s:.2f} s", flush=True)
        if int(st["n_toas"]) != want:
            raise AssertionError(f"gateway: ng15 tail {out['ng15_tail']}")
    finally:
        gw.close()
    built = _build.nvcc_starts - nvcc0
    if built:
        raise AssertionError(f"gateway: {built} kernel build(s) in the "
                             f"phase")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"gateway: phase {out['phase_s']:.1f} s on {card_line()}",
          flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# golden runs and the ska_10k memory lane
# ---------------------------------------------------------------------------

#: the golden rows: suite config 17's knobs (benchmarks/suite.py:700), its
#: 48 post-warm-up sampler steps on ng15 only, 16 after 8 on the others
GOLDEN_NAMES = ("flagship_100", "ng15", "ipta_dr3")
GOLDEN_KNOBS = dict(nreal=32, chunk=16, serve_requests=16,
                    max_append_blocks=8)
GOLDEN_SAMPLE = {"ng15": (48, 24)}
GOLDEN_SAMPLE_CUT = (16, 8)
#: the memory lane: ska_10k uncut at chunk 32, up to 10,000 pulsars (each
#: point a multiple of 1, 2 and 4 psr shards)
MEM_CHUNK = 32
MEM_SWEEP = (1000, 2500, 5000, 10000)
#: and the JAX default sweep's small points, where the fixed library
#: workspaces outweigh the chunk model (the card test's sweep)
MEM_SMALL_CHUNK = 8
MEM_SMALL_SWEEP = (8, 16)
#: the keys every golden row must carry (the JAX row's, all lanes on)
GOLDEN_KEYS = ("metric", "value", "unit", "platform", "scenario",
               "spec_hash", "steady_real_per_s_per_chip",
               "scn_real_per_s_per_chip", "peak_hbm_bytes",
               "scn_peak_hbm_bytes", "model_bytes_per_chunk",
               "ess_per_s_per_chip", "scn_ess_per_s_per_chip",
               "serve_p50_ms", "serve_p99_ms", "append_latency_ms",
               "scn_append_p99_ms", "stream_appends", "stream_recompiles")


def tally_launches(shapes: dict):
    """Tally #1's launches by shape while the main path runs: wrap
    ``binned_corr.binned_correlation`` (the engine and the serve scheduler
    look it up at each call) so each launch its wrapper counted is also
    added to ``shapes[(R, PL, PF, T)]``. Returns the function that
    restores the wrapper."""
    from fakepta_tpu_torch.ops import binned_corr as bc
    real = bc.binned_correlation

    def tally(res_local, res_full, weights, nbins, precision="bf16"):
        n0 = bc.launches
        out = real(res_local, res_full, weights, nbins, precision=precision)
        if bc.launches != n0:
            key = (int(res_local.shape[0]), int(res_local.shape[1]),
                   int(res_full.shape[1]), int(res_local.shape[2]))
            shapes[key] = shapes.get(key, 0) + bc.launches - n0
        return out

    bc.binned_correlation = tally
    return lambda: setattr(bc, "binned_correlation", real)


def keep_builds(sims: list):
    """Keep every simulator ``Scenario.build`` makes in ``sims`` (the
    golden run's ensemble lane, a memory-lane point) for the kernel rows.
    Returns the function that restores ``build``."""
    from fakepta_tpu_torch.scenarios import registry
    real = registry.Scenario.build

    def build(self, *a, **kw):
        sims.append(real(self, *a, **kw))
        return sims[-1]

    registry.Scenario.build = build
    return lambda: setattr(registry.Scenario, "build", real)


def traced(fn, shapes: dict, sims: list):
    """``fn()`` with every kernel count zeroed just before and read just
    after, #1's launches tallied by shape and the scenario builds kept:
    (result, launches moved). Fails unless #1 alone was launched, every
    launch tallied."""
    undo = [tally_launches(shapes), keep_builds(sims)]
    reset_counts()
    try:
        got = fn()
    finally:
        for u in undo:
            u()
    moved = counts()
    if not moved["binned_correlation"] or \
            moved["binned_correlation"] != sum(shapes.values()) or \
            any(n for k, n in moved.items() if k != "binned_correlation"):
        raise AssertionError(f"golden: launches {moved}, #1 by shape "
                             f"{shapes}")
    return got, moved


def golden_tag(key) -> str:
    r, pl, pf, t = key
    return f"{shape_tag(pl, pf, t)} R={r}"


def golden_kernel_rows(report: dict, shapes: dict, sims: dict) -> None:
    """#1 against its plain version and timed at every shape in
    ``shapes`` that no earlier measurement covered, on the simulator of
    ``sims`` whose (P, T) it is (the shared operand set)."""
    for key in sorted(shapes):
        r, pl, pf, t = key
        tag = golden_tag(key)
        if pl != pf or f"binned_correlation/bf16/{tag}" in \
                report.get("kernels", {}):
            continue
        served_kernel_rows(report, sims[(pl, t)], r, tag)


def phase_golden(report: dict, cards: int = 1) -> None:
    """Golden runs and the ska_10k memory lane (module docstring, phase
    ``golden``)."""
    import gc

    import torch
    from fakepta_tpu_torch.obs import gate
    from fakepta_tpu_torch.ops import _build
    from fakepta_tpu_torch.scenarios import golden, registry

    t_phase = time.perf_counter()
    out = report.setdefault("golden", {"rows": {}, "s": {}})
    gdir = os.path.join(HERE, "build", "golden")
    shutil.rmtree(gdir, ignore_errors=True)
    os.makedirs(gdir)
    _build.build()
    history = gate.load_history(gate.resolve_history(
        [os.path.join(HERE, gate.DEFAULT_HISTORY_GLOB)]),
        warn=lambda m: print(f"golden: gate history: {m}", flush=True))

    # 1. a golden row per scenario, full spec on cuda:0
    for name in GOLDEN_NAMES:
        steps, warmup = GOLDEN_SAMPLE.get(name, GOLDEN_SAMPLE_CUT)
        shapes, built = {}, []
        t0 = time.perf_counter()
        row, _ = traced(lambda: golden.golden_run(
            name, device="cuda:0", sample_steps=steps,
            sample_warmup=warmup,
            report_path=os.path.join(gdir, f"{name}.jsonl"),
            **GOLDEN_KNOBS), shapes, built)
        secs = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        missing = [k for k in GOLDEN_KEYS if k not in row]
        if missing or row["platform"] != "gpu" \
                or row["peak_hbm_bytes"] <= 0 or row["stream_recompiles"] \
                or row.get("serve_steady_compiles") \
                or any(row[k] for k in ("faults_retries",
                                        "faults_degradations",
                                        "faults_rollbacks")) \
                or not np.isfinite(row["value"]) or row["value"] <= 0:
            raise AssertionError(f"golden {name}: row {row}, missing "
                                 f"{missing}")
        path = os.path.join(gdir, f"{name}.json")
        golden.save_row(row, path)
        loaded = gate.load_row(path)
        results = gate.gate_row(loaded, history)
        if json.dumps(loaded) != json.dumps(row) or not results or any(
                r.verdict != "info" or r.n_history for r in results):
            raise AssertionError(f"golden {name}: obs gate on the saved row "
                                 f"{[vars(r) for r in results][:5]}")
        for key, n in shapes.items():
            add_launches(report, golden_tag(key), {"binned_correlation": n})
        sims = {(s.batch.npsr, s.batch.max_toa): s for s in built}
        spec_sim = registry.get(name).serve_spec().build(device="cuda:0")
        sims.setdefault((spec_sim.batch.npsr, spec_sim.batch.max_toa),
                        spec_sim)
        golden_kernel_rows(report, shapes, sims)
        del built, sims, spec_sim
        out["rows"][name] = row
        out["s"][name] = secs
        print(f"golden {name}: {secs:.1f} s, #1 launches by (R, PL, PF, T) "
              f"{dict(sorted(shapes.items()))}; the row gates against no "
              f"history ({len(results)} metrics)", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    # 2. the memory lane: ska_10k uncut, a point at a time so each point's
    # simulator serves its kernel row and is gone before the next point
    devices = [f"cuda:{i}" for i in range(cards)]
    points = []
    lane = None
    for n in MEM_SWEEP:
        shapes, built = {}, []
        lane, _ = traced(lambda: golden.memory_lane(
            "ska_10k", chunk=MEM_CHUNK, sweep=(n,), devices=devices),
            shapes, built)
        p = lane["points"][0]
        points.append(p)
        for key, k in shapes.items():
            add_launches(report, golden_tag(key), {"binned_correlation": k})
        # the shared set's shapes (one card); a psr shard's rows are not
        # measured here
        golden_kernel_rows(report, shapes, {
            (s.batch.npsr, s.batch.max_toa): s for s in built})
        del built
        gc.collect()
        torch.cuda.empty_cache()
        print(f"golden memory lane ska_10k npsr={n} on {devices} "
              f"(psr_shards {lane['psr_shards']}): peak "
              f"{p['peak_hbm_bytes'] / 1e9:.3f} GB, model "
              f"{p['model_bytes_per_chunk'] / 1e9:.3f} GB + fixed "
              f"{p['static_reservation_bytes'] / 1e6:.3f} MB (resident after "
              f"the build {p['resident_bytes'] / 1e9:.3f} GB), ratio "
              f"{p['ratio']} (bound {lane['bound_factor']}), ok {p['ok']}; "
              f"build {p['build_s']:.1f} s, host peak "
              f"{p['host_peak_bytes'] / 2**30:.1f} GiB of "
              f"{lane['host_ram_bytes'] / 2**30:.1f} GiB RAM; #1 by "
              f"(R, PL, PF, T) {shapes}", flush=True)
    out["memory_lane"] = dict(lane, points=points,
                              ok=all(p["ok"] for p in points))
    if not out["memory_lane"]["ok"]:
        raise AssertionError(f"golden: the memory lane broke its bound: "
                             f"{points}")

    # 3. the small points, where the fixed term outweighs the model
    shapes, built = {}, []
    small, _ = traced(lambda: golden.memory_lane(
        "ska_10k", chunk=MEM_SMALL_CHUNK, sweep=MEM_SMALL_SWEEP,
        devices=devices), shapes, built)
    for key, k in shapes.items():
        add_launches(report, golden_tag(key), {"binned_correlation": k})
    golden_kernel_rows(report, shapes, {
        (s.batch.npsr, s.batch.max_toa): s for s in built})
    del built
    for p in small["points"]:
        print(f"golden memory lane ska_10k npsr={p['npsr']} chunk "
              f"{p['chunk']}: peak {p['peak_hbm_bytes'] / 1e6:.3f} MB, "
              f"model {p['model_bytes_per_chunk'] / 1e6:.3f} MB + fixed "
              f"{p['static_reservation_bytes'] / 1e6:.3f} MB, ratio "
              f"{p['ratio']} (bound {small['bound_factor']}), ok "
              f"{p['ok']}", flush=True)
    out["memory_lane_small"] = small
    if not small["ok"]:
        raise AssertionError(f"golden: the memory lane's small points broke "
                             f"their bound: {small['points']}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"golden: phase {out['phase_s']:.1f} s on {card_line()}",
          flush=True)


# ---------------------------------------------------------------------------
# the float64 path
# ---------------------------------------------------------------------------

#: the f64 phase: the flagship's realizations in turns with float32, the
#: reduced flagship's card-vs-CPU bound (the CPU tests' float64 bound),
#: config 2's repeats and the facade array's width
F64_NREAL = 4096
F64_TOL = 1e-12
F64_CPU_NREAL = 64
F64_AUTO_RTOL = 0.05
F64_CONFIG2_ITERS = 50
F64_ARRAY = dict(npsrs=100, Tobs=15.0, ntoas=780, isotropic=True, gaps=True,
                 toaerr=1e-7, pdist=1.0, backends=["NUPPI"], seed=FACADE_SEED)


def f64_array(device: str, dtype):
    """The flagship-width facade array with the correlated HD background:
    (pulsars, seconds between synchronizations)."""
    import torch
    from fakepta_tpu_torch import correlated_noises as cn
    from fakepta_tpu_torch import fake_pta as fp
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    psrs = fp.make_fake_array(**F64_ARRAY, device=device, dtype=dtype)
    cn.add_common_correlated_noise(psrs, orf="hd", log10_A=-14.5,
                                   gamma=13 / 3, components=30, seed=7)
    res = [p.residuals for p in psrs]
    return psrs, res, time.perf_counter() - t0


#: the kernel paths at float64 against the float64 einsum run: 'f32' at the
#: fused kernel's float32 pair sums, 'bf16' at TOL's; realizations a timed
#: run (two chunks: the phase's budget)
F64_PATH_TOL = {"f32": 1e-6, "bf16": TOL["bf16"]}
F64_PATH_NREAL = 2048


def f64_kernel_paths(report: dict, scn, ein) -> dict:
    """The float64 flagship on the kernel paths (module docstring, phase
    21), in turns with ``ein``, the float64 einsum simulator; the launches
    go to ``report`` at their shapes. Returns the rows."""
    import torch
    from fakepta_tpu_torch.parallel.mesh import make_mesh

    f64 = torch.float64
    P, T = ein.batch.npsr, ein.batch.max_toa
    nchunks = -(-F64_PATH_NREAL // CHUNK)
    sims = {path: scn.build(device="cuda", dtype=f64, stat_path=path)
            for path in ("fused", "mega")}
    variants = [("fused", "f32"), ("fused", "bf16"), ("mega", "f32"),
                ("mega", "bf16")]
    for path, prec in variants:
        sims[path].run(CHUNK, seed=99, chunk=CHUNK, precision=prec)
    want = {"einsum": {}, "fused": {"binned_correlation_f64": nchunks},
            "mega": {"chunk_stats_f64": nchunks}}
    rates, outs = {}, {}
    for v in ["einsum"] + variants + variants[::-1] + ["einsum"]:
        sim, prec = (ein, "f32") if v == "einsum" else (sims[v[0]], v[1])
        key = v if v == "einsum" else "/".join(v)
        reset_counts()
        got, dt = timed_run(sim, F64_PATH_NREAL, prec, seed=1)
        moved = {k: n for k, n in counts().items() if n}
        if moved != want[key.split("/")[0]]:
            raise AssertionError(f"f64: {key} launched {moved}")
        add_launches(report, shape_tag(P, P, T), moved)
        rates.setdefault(key, []).append(F64_PATH_NREAL / dt)
        if key not in outs:
            outs[key] = (got, moved)
        elif not (np.array_equal(got["curves"], outs[key][0]["curves"])
                  and np.array_equal(got["autos"], outs[key][0]["autos"])):
            raise AssertionError(f"f64: {key} rerun is not bit-identical")
    ref = outs["einsum"][0]
    rows = {"einsum": {"realizations_per_s": rates["einsum"]}}
    for path, prec in variants:
        key = f"{path}/{prec}"
        got, moved = outs[key]
        kind = np.float32 if path == "fused" else np.float64
        if got["curves"].dtype != kind or got["statistic_path"] != path:
            raise AssertionError(f"f64: {key} returned "
                                 f"{got['curves'].dtype} curves on "
                                 f"{got['statistic_path']}")
        row = compare((got["curves"], got["autos"]),
                      (ref["curves"], ref["autos"]), prec,
                      f"f64 {key} vs einsum float64",
                      tol=F64_PATH_TOL[prec])
        row.update(realizations_per_s=rates[key], kernel_launches=moved,
                   rerun_identical=True,
                   ratio_to_einsum=float(np.mean(rates[key])
                                         / np.mean(rates["einsum"])))
        rows[key] = row
    # #4 at float64: the mega path on a psr-2 mesh on the card
    mesh_sim = scn.build(mesh=make_mesh(["cuda:0"] * 2, psr_shards=2),
                         dtype=f64, stat_path="mega")
    mesh_sim.run(CHUNK, seed=99, chunk=CHUNK, precision="f32")
    reset_counts()
    got, dt = timed_run(mesh_sim, F64_PATH_NREAL, "f32", seed=1)
    moved = {k: n for k, n in counts().items() if n}
    if moved != {"chunk_stats_sharded_f64": 2 * nchunks}:
        raise AssertionError(f"f64: the psr-2 mega run launched {moved}")
    add_launches(report, shape_tag(P // 2, P, T), moved)
    row = compare((got["curves"], got["autos"]),
                  (ref["curves"], ref["autos"]), "f32",
                  "f64 mega psr-2 vs einsum float64", tol=F64_PATH_TOL["f32"])
    row.update(realizations_per_s=F64_PATH_NREAL / dt,
               kernel_launches=moved)
    rows["mega_psr2/f32"] = row
    reset_counts()
    line = ", ".join(
        f"{k} {' / '.join(f'{r:.1f}' for r in v['realizations_per_s'])}"
        if isinstance(v["realizations_per_s"], list)
        else f"{k} {v['realizations_per_s']:.1f}" for k, v in rows.items())
    print(f"f64 flagship kernel paths, {F64_PATH_NREAL} realizations at "
          f"chunk {CHUNK}, in turns (realizations/s): {line}; float64 kernel "
          f"launches per run: fused {rows['fused/f32']['kernel_launches']}, "
          f"mega {rows['mega/f32']['kernel_launches']} (each one "
          f"fpt_project_f64 and one fpt_binned_corr_f64), psr-2 mega "
          f"{rows['mega_psr2/f32']['kernel_launches']}, einsum none",
          flush=True)
    return rows


def f64_lane_run(report: dict, scn, ein) -> dict:
    """The float64 flagship on mega with three OS lanes and the null stream
    (module docstring, phase 21): pass 1 at K = 320 under the main launch
    (NB = 19) and at the null stream's GWB-free K = 260 (NB = 4), first
    held to its plain version and timed at both shapes on one chunk, then
    the run in turns with the float64 einsum run of the same lanes, held to
    it at F64_PATH_TOL (curves, autos and every amp2 lane) and rerun bit
    for bit. Returns the run's row."""
    import torch
    from fakepta_tpu_torch.detect import OSSpec
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _NULL_TAG, _chunk_keys
    from fakepta_tpu_torch.utils import rng

    spec = OSSpec(orf=DETECT_ORFS, null=True)
    sim = scn.build(device="cuda", dtype=torch.float64, stat_path="mega")
    P, T = sim.batch.npsr, sim.batch.max_toa
    main_w, null_w = sim._prepare_lanes(spec).weights[id(sim._full)]
    rows = {}
    for null in (False, True):
        keys = _chunk_keys(rng.key(7, device="cuda"), 0, CHUNK)
        if null:
            keys = rng.fold_in(keys, _NULL_TAG)
        with torch.no_grad():
            base, coefs = sim._residuals(keys, split_gp=True, null=null)
        stages = sim._mega_stages_null if null else sim._mega_tables[0]
        w = null_w if null else main_w
        f64_chunk_rows(rows, base, coefs, *sim._mega_tables[1:], w, stages,
                       w.shape[0] - 1, (P,),
                       lambda pl, w=w, k=mk.stage_k(stages): shape_tag(
                           pl, P, T, w.shape[0], k), precs=("f32",))
    report.setdefault("kernels", {}).update(
        {"/".join(k): v for k, v in rows.items()})
    nchunks = -(-F64_PATH_NREAL // CHUNK)
    sim.run(CHUNK, seed=99, chunk=CHUNK, precision="f32", os=spec)
    outs, rates = {}, {"einsum": [], "mega": []}
    for path in ("einsum", "mega", "mega", "einsum"):
        reset_counts()
        got, dt = timed_run(ein if path == "einsum" else sim,
                            F64_PATH_NREAL, "f32", seed=1, os=spec)
        moved = {k: n for k, n in counts().items() if n}
        want = {} if path == "einsum" else {"chunk_stats_f64": 2 * nchunks}
        if moved != want:
            raise AssertionError(f"f64 os+null {path} launched {moved}")
        if path == "mega":
            lane_launches(report, sim, "mega", len(DETECT_ORFS), moved)
        rates[path].append(F64_PATH_NREAL / dt)
        outs.setdefault(path, []).append(got)
    reset_counts()
    got, again = outs["mega"]
    lanes = [(o, k) for o in got["os"]["orfs"] for k in ("amp2", "null_amp2")]
    if not (np.array_equal(got["curves"], again["curves"])
            and np.array_equal(got["autos"], again["autos"])
            and all(np.array_equal(got["os"]["stats"][o][k],
                                   again["os"]["stats"][o][k])
                    for o, k in lanes)):
        raise AssertionError("f64 os+null mega: rerun is not bit-identical")
    ref = outs["einsum"][0]
    row = compare((got["curves"], got["autos"]),
                  (ref["curves"], ref["autos"]), "f32",
                  "f64 mega os+null vs einsum float64",
                  tol=F64_PATH_TOL["f32"])
    row.update(os_compare(got, ref, "f32", "f64 mega os+null vs einsum "
                          "float64", tol=F64_PATH_TOL["f32"]))
    row.update(realizations_per_s=rates["mega"],
               einsum_realizations_per_s=rates["einsum"],
               kernel_launches={"chunk_stats_f64": 2 * nchunks},
               rerun_identical=True)
    print(f"f64 flagship os+null ({len(DETECT_ORFS)} ORFs, null stream), "
          f"{F64_PATH_NREAL} realizations at chunk {CHUNK}, in turns "
          f"(realizations/s): einsum float64 "
          f"{' / '.join(f'{r:.1f}' for r in rates['einsum'])}, mega "
          f"{' / '.join(f'{r:.1f}' for r in rates['mega'])}; "
          f"chunk_stats_f64 launched {2 * nchunks} times a run (K = 320 "
          f"and 260), rerun bit-identical", flush=True)
    return row


def phase_f64(report: dict) -> None:
    """The float64 path on the card (module docstring, phase 21)."""
    import torch
    from fakepta_tpu_torch import fake_pta as fp
    from fakepta_tpu_torch.scenarios import registry

    f64 = torch.float64
    t_phase = time.perf_counter()
    out = report.setdefault("f64", {})
    scn = registry.get("flagship_100")

    # 1. the flagship: float64 on its default path, in turns with float32
    sims = {"f32": scn.build(device="cuda", stat_path="einsum"),
            "f64": scn.build(device="cuda", dtype=f64)}
    if sims["f64"].stat_path != "einsum" or \
            sims["f64"].batch.dtype != f64:
        raise AssertionError(f"f64: the float64 flagship defaults to "
                             f"{sims['f64'].stat_path}")
    for sim in sims.values():
        sim.run(CHUNK, seed=99, chunk=CHUNK)
    reset_counts()
    rates, outs = {"f32": [], "f64": []}, {}
    for name in ("f32", "f64", "f64", "f32"):
        got, dt = timed_run(sims[name], F64_NREAL, "f32", seed=1)
        rates[name].append(F64_NREAL / dt)
        outs[name] = got
    moved = counts()
    if any(moved.values()):
        raise AssertionError(f"f64: the einsum runs launched {moved}")
    c64, a32, a64 = (outs["f64"]["curves"], outs["f32"]["autos"],
                     outs["f64"]["autos"])
    drift = abs(a64.mean() / a32.mean() - 1)
    if c64.dtype != np.float64 or not np.isfinite(c64).all() or \
            outs["f64"]["statistic_path"] != "einsum" or \
            drift > F64_AUTO_RTOL:
        raise AssertionError(f"f64: flagship curves {c64.dtype}, finite "
                             f"{np.isfinite(c64).all()}, mean auto off the "
                             f"float32 run's by {drift:.3g}")
    out["flagship"] = {"realizations_per_s": rates,
                       "ratio_f64_f32": float(np.mean(rates["f64"])
                                              / np.mean(rates["f32"])),
                       "mean_auto_drift": float(drift),
                       "peak_hbm_bytes": outs["f64"]["report"].memory.get(
                           "peak_hbm_bytes")}
    print(f"f64 flagship (100 x 780, K = 320) einsum, {F64_NREAL} "
          f"realizations at chunk {CHUNK}, in turns: float32 "
          f"{rates['f32'][0]:.1f} / {rates['f32'][1]:.1f}, float64 "
          f"{rates['f64'][0]:.1f} / {rates['f64'][1]:.1f} realizations/s "
          f"(x{out['flagship']['ratio_f64_f32']:.3f}); mean auto within "
          f"{drift:.2e} of float32; no kernel launched", flush=True)
    out["kernel_paths"] = f64_kernel_paths(report, scn, sims["f64"])
    out["kernel_paths"]["mega_os_null/f32"] = f64_lane_run(report, scn,
                                                           sims["f64"])
    del sims, outs
    torch.cuda.empty_cache()

    # 2. the reduced flagship at float64: the card against the CPU
    small = scn.reduced()
    got = {dev: small.build(device=dev, dtype=f64).run(
        F64_CPU_NREAL, seed=3, chunk=F64_CPU_NREAL // 2, keep_corr=True)
        for dev in ("cuda", "cpu")}
    err = {k: float(np.abs(got["cuda"][k] - got["cpu"][k]).max()
                    / np.abs(got["cpu"][k]).max())
           for k in ("curves", "autos", "corr")}
    if any(e > F64_TOL for e in err.values()):
        raise AssertionError(f"f64: the card's reduced run against the "
                             f"CPU's: {err}")
    out["card_vs_cpu"] = dict(err, npsr=small.npsr, ntoa=small.ntoa)
    print(f"f64 reduced flagship ({small.npsr} pulsars): card against CPU, "
          f"max error over scale {err} (bound {F64_TOL})", flush=True)

    # 3. the facade at float64: config 2 in turns, the array on the card
    # against the CPU
    toas = np.linspace(0, 10 * 365.25 * 86400.0, 520)
    arrays = {dt: [fp.Pulsar(toas, 1e-6, 1.0 + 0.1 * k, 0.3 * k, seed=k,
                             device="cuda", dtype=dt) for k in range(10)]
              for dt in (torch.float32, f64)}
    inj = {"float32": [], "float64": []}
    for dt in (torch.float32, f64, f64, torch.float32):
        inj[str(dt).split(".")[1]].append(injection_rate(
            lambda dt=dt: fp.add_noise_array(
                arrays[dt], signal="red_noise", log10_A=-14.0,
                gamma=13 / 3, seed=2), 10, F64_CONFIG2_ITERS))
    if any(p.residuals.dtype != np.float64 for p in arrays[f64]):
        raise AssertionError("f64: config 2 left non-float64 residuals")
    array_s = {}
    _, _, array_s["float32"] = f64_array("cuda", torch.float32)
    card, card_res, array_s["float64"] = f64_array("cuda", f64)
    _, cpu_res, array_s["float64_cpu"] = f64_array("cpu", f64)
    worst = max(float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(card_res, cpu_res))
    if worst > F64_TOL or any(r.dtype != np.float64 for r in card_res):
        raise AssertionError(f"f64: the card's array against the CPU's: "
                             f"{worst:.3e} of scale")
    n_inj = 3 * len(card) + 1    # white, red, DM a pulsar; the background
    out["facade"] = {"config2_injections_per_s": inj,
                     "array_s": array_s,
                     "array_injections_per_s": {
                         k: n_inj / v for k, v in array_s.items()},
                     "card_vs_cpu": worst}
    print(f"f64 facade: config 2 in turns float32 "
          f"{inj['float32'][0]:.1f} / {inj['float32'][1]:.1f}, float64 "
          f"{inj['float64'][0]:.1f} / {inj['float64'][1]:.1f} "
          f"injections/s; make_fake_array(100 x 780, gaps) + HD background "
          f"({n_inj} injections) float32 {array_s['float32']:.3f} s, "
          f"float64 {array_s['float64']:.3f} s on the card "
          f"({array_s['float64_cpu']:.3f} s on the CPU), card against CPU "
          f"{worst:.2e} of scale (bound {F64_TOL})", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"f64: phase {out['phase_s']:.1f} s on {card_line()}", flush=True)


def phase_profile(report: dict, cards: int = 1) -> None:
    """Where one flagship chunk's device time goes, per statistic path:
    CUDA-event times of the key derivation, the draws + residual assembly
    and the statistic, then torch.profiler's busiest kernels; then the host
    and device time of one sharded chunk (:func:`profile_sharded_step`)."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng

    prof = {}
    base_key = rng.key(11, device="cuda")
    for path in ("einsum", "fused", "mega"):
        sim = flagship_sim(path)
        prec = sim._resolve_precision(path, None)
        stages, times, scales = sim._mega_tables
        w = sim._stat_weights
        with torch.no_grad():
            keys = _chunk_keys(base_key, 0, CHUNK)
            split = path == "mega"
            resid = sim._residuals(keys, split_gp=split)

            def statistic():
                if path == "einsum":
                    return torch.einsum(
                        "rpq,npq->rn",
                        torch.einsum("rpt,rqt->rpq", resid, resid), w)
                if path == "fused":
                    return bc.binned_correlation(resid, resid, w, sim.nbins,
                                                 precision=prec)
                return mk.chunk_stats(resid[0], resid[1], times, scales, w,
                                      stages=stages, nbins=sim.nbins,
                                      precision=prec)

            row = {"precision": prec,
                   "keys_ms": time_ms(lambda: _chunk_keys(
                       base_key, 0, CHUNK), 5, warmup=1),
                   "residuals_ms": time_ms(lambda: sim._residuals(
                       keys, split_gp=split), 3, warmup=1),
                   "statistic_ms": time_ms(statistic, 3, warmup=1),
                   "step_ms": time_ms(lambda: sim.step(
                       base_key, 0, CHUNK, path, prec), 3, warmup=1)}
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                sim.step(base_key, 0, CHUNK, path, prec)
                torch.cuda.synchronize()
            row["profiled_wall_ms"] = 1e3 * (time.perf_counter() - t0)
            kern = []
            for ev in p.key_averages():
                # kernel rows only: the aten rows repeat their kernels' time
                if ev.device_type != DeviceType.CUDA:
                    continue
                dev_us = getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0))
                if dev_us:
                    kern.append((dev_us / 1e3, ev.count, ev.key[:90]))
            kern.sort(reverse=True)
            row["device_busy_ms"] = sum(k[0] for k in kern)
            row["n_kernel_launches"] = sum(k[1] for k in kern)
            row["top_kernels"] = kern[:6]
        reset_counts()
        prof[path] = row
        print(f"profile {path} [{prec}] per {CHUNK}-realization chunk: "
              f"keys {row['keys_ms']:.3f} ms, draws+residuals "
              f"{row['residuals_ms']:.3f} ms, statistic "
              f"{row['statistic_ms']:.3f} ms, step {row['step_ms']:.3f} ms; "
              f"profiled step: device busy {row['device_busy_ms']:.3f} ms "
              f"of {row['profiled_wall_ms']:.3f} ms wall, "
              f"{row['n_kernel_launches']} kernel launches", flush=True)
        for ms, count, name in row["top_kernels"]:
            print(f"    {ms:9.3f} ms  x{count:<5d} {name}")
    report["profile"] = prof
    report["profile_mesh"] = profile_sharded_step(cards)


def sync_all() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def profile_sharded_step(cards: int, shards: int = 4) -> dict:
    """Host against device time of one sharded flagship chunk (einsum path,
    ``psr_shards=shards``; its shards on cuda:0 in turn, or spread over
    ``cards`` cards as the mesh phase spreads them): the host time until
    ``step`` returns (the enqueue), the time until every card is done, and
    each card's kernel busy time in one torch.profiler-traced step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.utils import rng

    devices = (["cuda:0"] * shards if cards == 1
               else [f"cuda:{i}" for i in range(cards)])
    sim = flagship_sim("einsum", mesh=make_mesh(devices, psr_shards=shards))
    key = rng.key(13, device="cuda")
    enq, full = [], []
    with torch.no_grad():
        sim.step(key, 0, CHUNK, "einsum", "f32")                # warm-up
        for i in range(3):
            sync_all()
            t0 = time.perf_counter()
            sim.step(key, (i + 1) * CHUNK, CHUNK, "einsum", "f32")
            enq.append(1e3 * (time.perf_counter() - t0))
            sync_all()
            full.append(1e3 * (time.perf_counter() - t0))
        sync_all()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            sim.step(key, 0, CHUNK, "einsum", "f32")
            sync_all()
    busy, launches = {}, {}
    for ev in p.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = f"cuda:{ev.device_index}"
        busy[dev] = busy.get(dev, 0.0) + ev.time_range.elapsed_us() / 1e3
        launches[dev] = launches.get(dev, 0) + 1
    row = {"path": "einsum", "precision": "f32", "psr_shards": shards,
           "cards": cards, "mesh_shape": dict(sim.mesh.shape),
           "enqueue_ms": sum(enq) / len(enq),
           "step_ms": sum(full) / len(full),
           "device_busy_ms": busy, "kernel_launches": launches}
    print(f"profile sharded step (einsum [f32], psr_shards={shards}, "
          f"{cards} card(s), mesh {row['mesh_shape']}) per {CHUNK}-"
          f"realization chunk: host enqueue {row['enqueue_ms']:.3f} ms, "
          f"step to every card done {row['step_ms']:.3f} ms; traced step "
          f"device busy {', '.join(f'{d} {ms:.3f} ms' for d, ms in sorted(busy.items()))}; "
          f"kernel launches {launches}", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", nargs="+",
                    default=["build", "kernels", "engine", "mesh",
                             "scenarios", "signals", "run", "detect",
                             "facade", "correlated", "infer", "faults",
                             "sample", "stream", "multiproc", "tune",
                             "serve", "fleet", "gateway", "golden", "f64"],
                    choices=["build", "kernels", "engine", "mesh",
                             "scenarios", "signals", "run", "detect",
                             "facade", "correlated", "infer", "faults",
                             "sample", "stream", "multiproc", "tune",
                             "serve", "fleet", "gateway", "golden", "f64",
                             "profile"])
    ap.add_argument("--mesh-cards", type=int, default=1,
                    help="cards the mesh, multiproc and profile phases' "
                         "flagship meshes and the fleet and gateway "
                         "phases' replicas span (default 1: every shard, "
                         "both multiproc ranks and both fleet and gateway "
                         "replicas on cuda:0)")
    # one rank of the multiproc phase (the phase starts them)
    ap.add_argument("--mp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mp-ranks", type=int, default=2,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mp-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mp-shared", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mp-full", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import fakepta_tpu_torch  # noqa: F401  (fails outside a checkout)
    if args.mp_rank is not None:
        return mp_rank(args.mp_rank, args.mp_ranks, args.mp_dir,
                       args.mp_shared, args.mp_full)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    guard_runs()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()
    report = {"card": card, "phases": args.phases, "phase_s": {}}
    phases = {"build": phase_build, "kernels": phase_kernels,
              "engine": phase_engine,
              "mesh": lambda r: phase_mesh(r, args.mesh_cards),
              "scenarios": phase_scenarios, "signals": phase_signals,
              "run": phase_run, "detect": phase_detect,
              "facade": phase_facade, "correlated": phase_correlated,
              "infer": phase_infer, "faults": phase_faults,
              "sample": phase_sample, "stream": phase_stream,
              "multiproc": lambda r: phase_multiproc(r, args.mesh_cards),
              "tune": phase_tune, "serve": phase_serve,
              "fleet": lambda r: phase_fleet(r, args.mesh_cards),
              "gateway": lambda r: phase_gateway(r, args.mesh_cards),
              "golden": lambda r: phase_golden(r, args.mesh_cards),
              "f64": phase_f64,
              "profile": lambda r: phase_profile(r, args.mesh_cards)}
    for name, phase in phases.items():
        if name in args.phases:
            t0 = time.perf_counter()
            phase(report)
            report["phase_s"][name] = time.perf_counter() - t0
            print(f"phase {name}: {report['phase_s'][name]:.1f} s",
                  flush=True)
    report["total_s"] = time.perf_counter() - t_start
    report["recovery_guard_runs"] = GUARD["runs"]
    print(f"recovery default: {GUARD['runs']} engine runs, each with zero "
          f"degradations on the statistic path it asked for", flush=True)

    # one entry per kernel and shape that the main path launched it at or
    # the phases measured it at (the flagship's shared operand set and its
    # 2- and 4-shard meshes' PL = 50 and 25; ng15's PL = 68 and its 2-shard
    # mesh's PL = 34; ipta_dr3's PL = 120 and 60; the detection lane's
    # weight-slot counts NB and chunk_stats' K where they are not the plain
    # run's; the facade batch's PL = 100 and 50 at its own TOA width and
    # at a width with T % 4 != 0; the serve phase's R = 16 and R = 1024
    # and the fleet and gateway phases' cohort buckets, tagged with R),
    # each with the launches made at that shape in the main-path runs (0
    # where none was made)
    table = []
    specs = (("binned_correlation", "bf16",
              "fakepta_tpu_torch/csrc/binned_corr.cu",
              "fakepta_tpu/ops/pallas_kernels.py:160"),
             ("binned_correlation_vpu", "bf16",
              "fakepta_tpu_torch/csrc/binned_corr.cu",
              "fakepta_tpu/ops/pallas_kernels.py:223"),
             ("chunk_stats", "f32",
              "fakepta_tpu_torch/csrc/megakernel.cu",
              "fakepta_tpu/ops/megakernel.py:281"),
             ("chunk_stats_sharded", "f32",
              "fakepta_tpu_torch/csrc/megakernel.cu",
              "fakepta_tpu/ops/megakernel.py:384"),
             ("binned_correlation_f64", "f32",
              "fakepta_tpu_torch/csrc/binned_corr.cu",
              "fakepta_tpu/ops/pallas_kernels.py:160"),
             ("chunk_stats_f64", "f32",
              "fakepta_tpu_torch/csrc/megakernel.cu",
              "fakepta_tpu/ops/megakernel.py:281"),
             ("chunk_stats_sharded_f64", "f32",
              "fakepta_tpu_torch/csrc/megakernel.cu",
              "fakepta_tpu/ops/megakernel.py:384"))
    kernels = report.get("kernels", {})
    by_shape = report.get("launches_by_shape", {})
    for name, prec, source, replaces in specs:
        shapes = dict(by_shape.get(name, {}))
        for k in kernels:
            if k.startswith(name + "/"):
                shapes.setdefault(k.split("/")[2], 0)
        for shape, n in shapes.items():
            row = kernels.get(f"{name}/{prec}/{shape}", {})
            table.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "precision": prec, "shape": shape,
                "launches": n, "max_abs_err": row.get("max_abs_err"),
                "ms": row.get("ms"), "plain_ms": row.get("plain_ms"),
                "bound_ms": row.get("bound_ms"),
                "bound_by": row.get("bound_by"),
                "library_ms": row.get("library_ms")})
    report["table"] = table
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    print(f"total {report['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": table}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
