#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA H100, end to end.

    python3 chip_smoke.py

Phases, each printed as a JSON line:

  1. build    compile the CUDA kernels in src/repro_torch/kernels/csrc/ with
              nvcc for sm_90a into build/repro_torch_kernels/, all sources
              at once;
  2. kernels  each kernel against its plain PyTorch version on the card, on
              the same inputs, over dtypes and row widths (f32 F=256, bf16
              F=2048, f32 F=100, f32 (3, 5), f16 F=16), for the lock
              kernel the ring and pairwise schedules with and without
              elided rounds, the fence kernel over 2, 4 and 8 groups, and
              the hierarchy's stage-2 kernel on meshes (2, 2), (2, 4),
              (4, 2), (8, 8) and (16, 4) over dense, banded, skewed and
              all-local counts and three leader permutations.  K3 and K4
              run by their rules (the bulk-copy K3 and the clustered K4
              for 16-byte rows on aligned bases, the per-round K4 and the
              warp-per-row K3 for 60-byte rows and bases 4 bytes off) and
              again by the kernels they replaced, forced on the same
              inputs, each launching the counters expected; K2 likewise
              (its bucket kernel for buckets of 16-byte multiples on
              aligned bases, the warp-per-row kernel for (3, 5) float32
              rows at cap 5, 1-byte rows at cap 5 and bases 4 bytes off),
              also on 4-byte and 2-byte rows, a bucket ending in a tail
              chunk, C = 0, G > 1 and P = 1; K4 also at
              P=64 with every round elided but one and at P=300 (16-byte
              rows, a first phase of 298 entries: one cluster launch, and
              the step kernel cutting the phase over two launches).  K1
              from run tables (``gather_runs``) by its rule and by the
              warp-per-row kernel it replaced: each dtype's pack, its
              write-through and its zeroing unpack, a base 4 bytes off
              (which must take the warp-per-row kernel), and random tables
              with one source and two at rows of 16 B, 1 KiB and 32 KiB.
              Tolerance: every output byte equal (the kernels
              only move rows; invalid rows are +0.0, with NaN planted
              where their index points);
  3. main     the persistent alltoallv plan through ``alltoallv_init`` on
              ``VirtualMesh((P,), ("x",))`` for fence x pallas, fence x fused,
              lock x pallas x ring and lock x pallas x pairwise, at
              A: P=8, dense, 1024 rows of 256 f32 per pair (1 MiB messages),
                 the top of benchmarks/msg_sweep.py, and
              B: P=64 virtual ranks, the hugetrace-like skewed pattern of
                 benchmarks/sparse_pattern.py with base_rows=64, 256 f32 rows.
              Valid rows must equal the numpy oracle
              (``core.reference.alltoallv_global``) bit for bit.  The kernel
              counters are zeroed just before and read just after: every
              kernel must have launched and no plain version may have run;
              each lock epoch is one launch of the clustered K4
              (``a2a_lock_cluster``), each fused epoch one bulk K3
              (``a2a_fence_fused_bulk``), every pack and unpack one K1 from
              its run table (``gather_rows_runs``), and no replaced kernel
              runs.  Then every kernel against its plain version, bytes
              equal, on each config's own send buffer, baked tables, run
              tables and lock round capacities (ring and pairwise), K1, K3
              and K4 also by the kernels they replaced, K1's unpack writing
              through (stale window bytes kept) and zeroing, K3 with NaN
              planted;
  3b. hier    the leader-combined hierarchy through ``alltoallv_init`` on
              ``VirtualMesh((P_outer, P_inner), ("o", "i"))``,
              variant="fence_hierarchy" x pack_impl {pallas, fused}, at A
              on meshes (2, 4) and (4, 2) and at B on (8, 8) and (16, 4),
              plus B (8, 8) fused with each group's leader roles reversed
              and an all-local pattern (B's counts inside each group of 8);
              then ``plan.embed()`` at A and B for fence x {pallas, fused},
              lock x pallas and fence_hierarchy x fused (A's flat plans
              take the identity fast path, B's the full embedded body).
              Valid rows must equal the oracle and the flat fence x pallas
              plan on the same mesh bit for bit; embed() must equal
              start() on valid rows, be zero on padding and make the
              launches its path implies.  Counters zeroed before, read
              after: the stage-2 kernel launches once per fused epoch
              (zero times all-local), K1 three times per epoch (the s1
              pack, the s3 pack from the stage-2 rows and the send buffer
              as two sources, the unpack; twice all-local), no
              ``torch.cat`` takes the send buffer and no plain version
              runs.  Then K1's packs and unpack (by rule and by the
              warp-per-row kernel), the stage-2 kernel and the grouped
              fence kernel against their plain versions on every hierarchy
              plan's own tables;
  3c. serve   slice 3.  The fused unpack-gather-matmul kernel (K6) against
              its plain version over float32 and bfloat16, E in {1, 8, 64},
              N in {8, 64, 128, 136, 256}, D in {100, 128, 2048}, F in
              {72, 1024}, with repeated indices, zeros in the mask, the last
              expert all invalid (E > 1) and NaN/inf planted in the rows
              that only invalid entries reference, plus bf16 calls with F=60,
              an unaligned x and an unaligned w: invalid rows must be +0.0
              exactly, the rest within 2e-5 (float32) or 8e-3 (bfloat16) x
              max|plain|, and each case must launch the one kernel
              ``gather_matmul.kernel_for`` names (wgmma for bf16 with D and F
              multiples of 8 and aligned bases, mma.sync for the other bf16
              calls, CUDA cores for float32).  Then OLMoE-1B-7B at full width
              and depth (16 layers, bf16, weights from a seeded generator on
              the card) through ``ServeEngine.generate`` on
              ``VirtualMesh((1, 8), ("data", "model"))`` (EP 8): 4 prompts of
              128 tokens, 16 new tokens, counters zeroed before and read
              after: exactly 32 wgmma K6 and 32 K2 launches per forward and
              no other kernel (the mma.sync K6 included) or plain version;
              prefill ms, decode ms per token and tokens/s.  K6 and K2 at the serve shapes (the layer's own
              row tables and weights) against their plain versions and timed.
              Then OLMoE at full width, depth 2, float32, the same weights on
              the card and on the CPU (TF32 off): prefill and decode logits
              within 1e-3 x max|logit|, equal greedy tokens, equal kept
              routing entries per MoE call;
  4. times    CUDA events, warm-up, median of 20 runs of 5 calls each:
              ``ms`` with the card idle when the first call is enqueued,
              as a caller's would be (a fifth of one call's host enqueue
              can show), and beside it ``queued_ms``, the same calls
              queued behind a ~2 ms GPU sleep (the device's time alone).
              K2's bucket kernel at A, B, B with 4-byte rows (the codec
              scale channel), the training exchange [8, 20480, 2048] bf16
              and (after phase 10) the gradient sync's [2, 2C] fp32, beside
              the warp-per-row kernel (new, old, old, new), its bound, plain
              version, ``view·transpose·contiguous``, enqueue time and its
              times at other chunk sizes.  Each kernel at
              config A (gated bytes equal to its plain version) beside its
              bound, its plain version, the one PyTorch call that computes
              the same function on A's dense pattern (index_select, or the
              bucket transpose) and the host time to enqueue it; K1-K4
              also at B (the library call one index_select over the flat
              source plus a zero row, with the composed index); K1, K3 and
              K4 beside the times of the kernels they replaced on the same
              inputs (new, old, old, new) and the card's write floors
              (K1: ``copy_floor_ms``, a ``Tensor.copy_`` of the output's
              bytes, and ``zero_fill_ms``), K1 for its pack and its
              write-through unpack; the stage-2 kernel likewise at B (8, 8); every epoch at A and B,
              hierarchy plans included, beside its design bound (every
              pass over padded layouts) and its payload bound (valid rows
              only) and with its plan's INIT seconds (host, compile, and
              the run tables' share of compile); persistent plans that
              pack as the baseline does; the non-persistent baseline;
              each pass of the B (8, 8) fused hierarchy epoch.  K6 (``gather_matmul``, its wgmma
              kernel) is timed at the serve path's prefill and decode shapes
              beside its bound (bytes over 3.35 TB/s against operations over
              989 TFLOP/s), its plain version, ``index_select`` +
              ``torch.bmm``, the host enqueue time (the tensor-map encode
              included) and the mma.sync design's times it replaced.

  8. slice 8 ``autotune_path``: ``alltoallv_init(..., variant="auto",
              pack_impl="fused")`` at A on (8,), B on (64,) and B on (8, 8):
              each arm's time, the winner, ``n_amortize``, the sweep's
              seconds and the change in ``INIT_STATS``; the winner's valid
              rows bit-equal to the oracle, a second INIT of the pattern on
              the same cache runs no sweep, ``embeddable=True`` never picks
              ragged; one B sweep with the ``variant@codec`` arms of
              ``error_tol=0.5/127`` and its ``codec_fits``; OLMoE-1B-7B's MoE
              dispatch at the serve path's prefill shape with
              ``a2a_variant="auto"``, its embedded exchange bit-equal to the
              fence layer's.  ``breakeven_path``: ``breakeven.measure`` of
              fence x fused, lock x pallas and ragged against the
              non-persistent fence at A and B (t_init: a cold INIT's host
              and compile seconds), then fence x fused over 1 KiB to 1 MiB
              messages at P=8.  ``obs_path``: with tracing on, an A INIT, 20
              epochs and an auto sweep; the Chrome trace validated, the
              auto plan's break-even residual in the Prometheus text, the
              A epoch's host time with tracing off and on.  Counters zeroed
              before each of the first two, read after.

  9. slice 9 ``planstore_path``: with ``capture_init_requests()`` on, cold
              INITs into a fresh plan store (a temporary directory), a
              fresh ``PlanCache`` each: A and B ``fence x fused`` and
              ``lock x pallas``, B's (8, 8) fused hierarchy, the A (8,),
              B (64,) and B (8, 8) auto sweeps and the OLMoE MoE
              dispatch's auto decision at the prefill shape; one epoch
              each.  Then a second process on the card (``python3
              chip_smoke.py --planstore-child STORE OUT.json``, which
              prints nothing) loads the kernels and replays the captured
              records against the store twice, one epoch per plan, and
              measures the flat plans' t_persist and t_mpi.  Every warm
              plan must bake no table, run no autotune burst, hit the
              store, be ``warm_loaded`` where its variant stores tables
              (ragged stores none, as in JAX), resolve to the cold
              variant, give valid rows bit-equal to the cold plan's and
              to the oracle, and make the cold epoch's launches.  Then a
              store populated by a CPU INIT of A must miss on the card
              (and a CPU file under the card's key is invalid), and
              ``python -m repro_torch.planstore warm-check`` runs cold,
              then warm with ``--assert-warm``.  Cold and warm INIT and
              compile ms with their spans (``store_get``, ``store_merge``,
              bakes, ``plan_compile``), the sweep seconds skipped, and
              ``n_breakeven`` with the warm and the cold t_init.

 10. slice 10 ``train_path`` (after every timing phase, with the earlier
              plans dropped): OLMoE-1B-7B at full width with 4 of its 16
              layers (``dataclasses.replace(..., n_layers=4)``: its
              training state, 16 bytes per parameter, fits the card at 4),
              bf16, seeded weights, EP 8 on ``VirtualMesh((1, 8))``,
              train_4k's length 4096 at global batch 4, trained 6 steps
              through ``launch.steps.make_train_bundle`` and
              ``train.Trainer`` (remat per layer, AdamW with fp32 master
              weights).  Counters zeroed just before that run and read
              just after: per step 24 K2 and 16 wgmma K6 launches (4
              layers x dispatch and combine x forward, recomputation and
              backward; K6 forward and recomputation) and nothing else,
              no plain version.  Gates: every loss finite and the last
              below the first; a Trainer from the same seed checkpoints
              at step 3 into a temporary directory and a fresh one
              resumed from it gives steps 4-6 within 1e-2 relative
              (bit-equal or not is reported; two 21 GiB checkpoints are
              written, under the card machine's 45 GiB of disk writes);
              every expert weight's gradient finite, non-zero for each
              (layer, expert) that kept a routed entry in the step and
              exactly zero for one that kept none (at random init a few
              do); the exchange's vjp at the layer's dispatch shape
              through K2 bit-equal to the plain exchange's on the card;
              K6 against its plain version at the training shape (N =
              2560 rows per expert) within 8e-3 x max|plain|;
              ``persistent_rs_sync`` on ``VirtualMesh((2, 4))`` over a
              >= 1 GiB prefix of the gradient tree, timed by part (the
              INIT of its reduce-scatter and allgatherv plans, a first
              call that must hit the plan cache, a second call) returns
              it bit for bit with one K2 launch per call, K2 timed at its
              shape, and its error-feedback form on a >= 256 MiB prefix
              matches a CPU copy within one int8 step;
              ``python3 -m
              repro_torch.launch.train --reduced --mesh 1,8 --steps 3``
              twice against one plan store, the second with
              ``--assert-warm-init``.  Step ms (host clock, the card
              idle at each step's end; median of steps 2-6), tokens/s,
              peak memory and launches per step.

 11. slice 12 ``mesh_path`` (after phase 10, its state freed): the MoE
              layer on every mesh the JAX package takes, at full width
              (OLMoE-1B-7B's d_model 2048, 64 experts, top-8, d_expert
              1024, bf16 seeded weights, T's 4 x 4096 tokens: 2,048 tokens
              and capacity 320 on each of 8 virtual ranks in every
              layout): ``(1, 8)``; ``(2, 4)`` (2 data shards of EP 4, one
              K2 launch per hop for both); ``(2, 2, 2)`` under
              ``hier_ep`` (EP 4 over (pod, model)), flat fence and
              ``fence_hierarchy`` with ``pack_impl`` jnp, pallas and fused;
              ``(2, 1, 4)`` under ``hier_ep`` (EP 8), jnp and fused; and
              overlap depth 2 (chunk c+1's dispatch on a second stream) on
              ``(2, 4)`` and ``(2, 1, 4)``.  Each forward and backward with
              the counters zeroed just before and read just after: the
              K2, K1, K5 and K6 launches the layout implies, no plain
              version; output, aux losses and gradients bit-equal to
              ``(1, 8)``'s (depth 2: the expert weights' gradients within
              8e-3 x max); forward and forward+backward ms; the exchange's
              vjp at its own shape bit-equal to the plain fence's.  Then
              T's 6 training steps again on ``(2, 4)`` and on ``(2, 1,
              4)`` under ``hier_ep`` with ``fence_hierarchy`` (no
              checkpoint): per step 24 and 48 K2 and 16 wgmma K6
              launches and nothing else, finite falling losses equal to
              phase 10's bit for bit, step ms, tokens/s, peak memory.
              Since slice 13 T's attention at 4096 tokens takes the flash
              path (``models/attention.py``), as the JAX package's does, in
              phases 10 and 11 alike.

 12. slice 13 ``families_path`` (after phase 11, its state freed): the
              attention-only families.  Moonshot-v1-16B-A3B at full width
              with 24 of its 48 layers (``dataclasses.replace(...,
              n_layers=24)``: 29.6 GB of bf16 weights; the fp32 draw of
              ``normal_init`` peaks near 63.5 GB there) served through
              ``ServeEngine.generate`` on ``VirtualMesh((1, 8))`` (EP 8,
              fence dispatch, shared experts, top-6): 4 prompts of 128
              tokens, 16 new tokens, counters zeroed just before and read
              just after: exactly 48 wgmma K6 and 48 K2 per forward and
              nothing else, no plain version; finite bf16 logits; K6 at its
              served prefill shape (F = 1408, 11 wgmma F-tiles) against its
              plain version within 8e-3 x max|plain|, timed beside its
              bound and ``index_select`` + ``torch.bmm``.  OLMo-1B at full
              size (16 dense layers, bf16) served the same way: no kernel
              launch and no plain version; then at depth 2, float32, its
              logits on the card within 1e-3 x max|logit| of the CPU's and
              equal greedy tokens.  The flash path against the direct one
              at T's attention shape (B 4, S 4096, 16 x 128, bf16): forward
              and forward+backward ms and peak GiB of each, output and dq,
              dk, dv within 2e-2 x max|direct|.  ``ulysses_attention`` at
              OLMo-1B's attention width (B 2, S 4096) on ``(8,)`` (fence)
              and ``(2, 4)`` ("pod", "model", ``fence_hierarchy``) against
              ``_attend`` on the card (8e-3 x max|_attend|; bit-equal
              reported), its K2 launches per call (four head exchanges, two
              epochs each under the hierarchy, plus what the positions
              gather launches) and ms beside ``_attend``'s.  The pod-aware
              reduce on ``(2, 4)`` ("pod", "data") over ``[8, 2048, 4096]``
              fp32: plan-backed, raw and flat within 1e-5 x max|flat| of
              each other, the plan pair's INIT seconds, the plan path's K2
              launches per call (one reduce-scatter epoch per pod) and each
              path's ms.

 13. slice 14 ``ssm_families_path`` (after phase 12, its state freed): the
              state-space, audio and vision families, one model on the card
              at a time, each bf16 seeded at full width and served at S's
              batch on ``VirtualMesh((1, 8))``, counters zeroed just before
              the counted run and read just after.  Jamba-v0.1 with 8 of its
              32 layers (``dataclasses.replace(..., n_layers=8)``: one whole
              period, 7 Mamba and attention at slot 4, 4 MoE layers of 16
              experts top-2 and 4 dense FFNs; 13.3 B parameters, 26.6 GB;
              32 layers would be 103 GB) through ``ServeEngine.generate``:
              exactly 8 K2 (bucket kernel) and 8 wgmma K6 per forward and
              nothing else, no plain version, finite logits; K6 at its
              served prefill shape (E 16, N 128, D 4096: 64 D-stages of the
              weight ring, F 14336: 112 F-tiles, 1.88 GB of w) against its
              plain version within 8e-3 x max|plain| (gate and up), timed
              beside its bound and ``index_select`` + ``torch.bmm``; K2 at
              its prefill and decode shapes.  xLSTM-125m and Whisper-base
              whole through the engine (Whisper: 1500 stub frames, 8 prompt
              tokens, float32 frames so the encoder runs in float32) and
              InternVL2-26B with 24 of its 48 layers through its prefill
              and decode bundles (256 stub patches at width 3200 and 128
              text tokens; no engine serves the vlm family): no kernel
              launch, finite logits.  Then each family's reduced config
              (float32; Jamba at depth 8) on the card and on the CPU with
              the same weights: every forward's logits within 1e-3 x
              max|logit|, equal greedy tokens and kept routing entries.
              Prefill ms, decode ms per token, tokens/s, init seconds and
              peak GiB per model.

 14. slice 15 ``resilience_path`` (after phase 13, its state freed): the
              resilience layer (``repro_torch.runtime``), every driven part
              with its launches counted from a snapshot just before to one
              just after (checks against plain versions outside), no plain
              version in any of them, every epoch's valid rows bit-equal
              to the oracle on the card.  (a) B on (8, 8), ``variant=
              "auto"``, ``pack_impl="fused"``, a plan store: chaos stalls
              every epoch from epoch 6, a background ``ReplanManager``
              (monitor threshold 1.6, window 4, sustain 2, warm-up 6)
              re-plans in a sandbox on a stream of its own while the live
              epochs run; the sweep must have re-measured and the stored
              verdict carry its ``replan`` provenance; then ``force_swap``
              to the sweep's runner-up: the old plan keeps no window slot,
              table or run table and ``memory_allocated`` falls by at least
              its window's bytes.  (b) B ``fence_hierarchy`` x ``fused`` on
              (8, 8) with ``rank_slow`` 3.0 on a carrying leader from epoch
              6 (weight 0.05): rung 0 only (one schedule bake, no autotune
              burst), the slow rank out of the carrying set, K5 launched
              every epoch on the re-baked plan and then held with K1 and K2
              to its plain version on that plan's tables; epoch p50 before,
              while slowed and after (readings).  (c) A ``fence`` x
              ``fused``: window-allocation failures, a poisoned store, an
              ``fsremote://`` store failing a quarter of its calls, step and
              device-loss faults through ``run_with_recovery``: every kind
              fires.  (d) T's width, 4 layers and batch on (2, 1, 4) under
              ``hier_ep``, ``fence_hierarchy`` with the dispatch's
              ``pack_impl`` set to ``fused`` (``moe_pack_impl``), 14 steps
              clean, then 14 with ``TrainerConfig(replan=True)`` and
              ``rank_slow`` 3.0 on a carrying leader from step 4: one
              ``leader_rebake`` event (step 11) demoting it, losses
              bit-equal to the clean run's, K5 and K6 launched after the
              swap and K5 at the model's shape bytes-equal to its plain
              version.  (e) T on (1, 8) with ``a2a_variant="auto"`` and
              ``replan_at=2``: one forced event, a swap exactly when the
              verdict changes, T's losses.  (f) runs in phase 10, between
              the step-3 checkpoint's write and its (1, 8) resume (which
              removes it): T's captured INIT requests resharded onto
              (2, 4) (``reshard_plans``), the checkpoint restored there
              through ``load_to_mesh`` with no checkpoint written, steps
              4-6 equal to T's.

 15. slice 16 ``train_rest_path`` (after phase 14, its state freed): the
              rest of training.  Each run's counters are zeroed just before
              it and read just after: exactly the launches below, no plain
              version.  (a) T (phase 10's config, batch and 6 steps) with
              ``a2a_variant="lock"``: 24 clustered K4 and 16 wgmma K6 per
              step (K4 in the forward, the recomputation and the backward),
              losses bit-equal to phase 10's fence losses, step ms, peak.
              (b) T under ``wire_codec="bf16"`` (T's rows are bf16, so the
              codec is lossless): 24 K2 and 16 K6 per step, losses within
              1e-2 of phase 10's (and whether bit-equal).  (c) T under int8
              and fp8, 2 steps each, then one gradient: int8's expert
              weights get exactly zero (the JAX package's semantics: round
              and the scale lanes' bitcast carry no gradient, so only
              forward and recomputation exchange: 16 K2 per step), the
              router's gradient finite and non-zero; fp8's gradients all
              finite (24 K2 per step); K2's bucket rule on the 2052-byte
              wire rows.  (d) embedded vjps at the main shapes: A's
              identity and B's table-driven fence and lock (``jnp``), B's
              (8, 8) ragged hierarchy (``jnp``, ``pallas``), G's allgatherv
              (fence, lock, (2, 4) hierarchy) and reduce-scatter (fence,
              lock): each backward's launches as designed and its gradient
              bytes-equal to the same backward run by the plain versions on
              the card; forward and backward ms.  (e) Moonshot-v1-16B-A3B
              at full width with 2 of its 48 layers, 6 steps of train_4k's
              4 x 4096 tokens on (1, 8): 12 K2 and 8 wgmma K6 per step,
              finite losses, the last below the first, step ms, tokens/s,
              peak.  No checkpoint is written.
 16. slice 17 ``dryrun_path`` (after phase 15, its state freed): the
              roofline and the dry run.  (a) ``launch.dryrun.run_cell`` on
              the host for olmoe-1b-7b train_4k and decode_32k on the
              single-pod production mesh on ``meta``: FLOPs per card,
              memory per rank, the dominant term, seconds.  (b) T (phase
              10's config, batch and mesh): one step traced on ``meta``
              under ``roofline.trace.StepCounter``, then one real step on
              the card under a second counter, the kernel counters zeroed
              just before it: kernel calls per kernel (24 K2 and 16 K6),
              FLOPs and collective wire bytes exactly equal between the
              two, every call a launch, no plain version; the meta trace's
              ``memory_one_card`` beside the step's
              ``torch.cuda.max_memory_allocated``; T's roofline terms and
              ``mfu`` from phase 10's measured step time, beside the card's
              name and power limit.  (c) S's prefill and decode bundles
              (phase 3's shapes): the same equality of calls (32 K2 and 32
              K6 per forward) and FLOPs.
 17. slice 18 ``procs_path`` (after phase 16, its state freed): ranks in
              processes.  Whether MPS runs.  A (P=8 dense, 1 MiB per pair)
              on 8 processes and the paper's irregular pattern
              (``hugetrace_like_counts(16, 64)``, 1 KiB f32 rows: 10,001
              rows, 9.77 MiB) on 16, spawned by
              ``repro_torch.testing.dist_cases.spawn`` (kernels built here
              first), one ``ProcessMesh`` rank each on this card: fence x
              {jnp, pallas, fused}, lock x pallas x {ring, pairwise} and the
              non-persistent baseline, each rank's valid rows bytes-equal
              (sha256) to the oracle and to the one-process ``VirtualMesh``
              plan run here on the same inputs.  Counters zeroed just
              before each rank's plans and read just after, summed over
              ranks: the peer K2, K3 (tile kernel), K4, the signal kernel
              and K1 from run tables launched, no one-process exchange
              kernel and no plain version; on every rank each plan's
              epochs launch exactly ``PROCS_EPOCH_LAUNCHES`` (slice 19: a
              fence or lock epoch is one peer K2 or K4 launch and no signal
              kernel).  Then each peer kernel against its plain version
              across the processes (every rank's window and pad bytes equal
              after the same epoch of each, from a sentinel window and
              zeroed pads, and the largest difference of its values; the
              peer K4 also at 60-byte rows; the warp K3 peer kernel, which
              the path never takes, on 60-byte rows through the fused
              plan's tables), a slow consumer (rank 0 reads epoch e's
              window after a ~50 ms GPU sleep while the others start epoch
              e+1, for the fence and the lock: it must read epoch e's
              rows), and, on rank 0 alone with the grid it uses, each
              kernel's time (and queued), its plain version's, its bound,
              ``torch._foreach_copy_`` of the same buckets, the host
              enqueue time, CTAs per rank, registers and local bytes, the
              flags at system scope, and grid sweeps.  INIT with and
              without the window registration and epoch p50 by CUDA events
              on each rank (the max over ranks) beside the one-process
              figures.  Last, both stalled-rank cases on 4 processes with a
              2 s flag timeout: every other rank's WAIT raises the named
              flag error within 2-4 s, and no group hangs.

``python3 chip_smoke.py --one-process-kernels`` times only the one-process
K2 bucket, K3 tile and K4 cluster kernels at A and B (``ms`` and
``queued_ms``).  Copied beside another tree's ``src/``, it times that
tree's kernels: two trees are compared in one chip call as parent, change,
change, parent.

Before the last line it prints the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, and the ``{"kernels": [...]}`` line.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero before printing it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.roofline import hw  # noqa: E402  (the repo's src/ above)

# H100 SXM HBM3 bandwidth (NVIDIA data sheet): the bound of a byte mover.
HBM_BYTES_PER_S = hw.HBM_BW
# Chunk sizes at which K2's bucket kernel is also timed (bytes).
FENCE_CHUNK_SWEEP = (2048, 4096, 8192, 16384, 32768, 65536)
FEATURE = 256                       # float32 per row: 1 KiB rows
ITERS = 20
MAIN_RUNS = (("fence", "pallas", "ring"), ("fence", "fused", "ring"),
             ("lock", "pallas", "ring"), ("lock", "pallas", "pairwise"))
# Launches of one epoch of each flat plan at A and B (1 KiB rows): the
# fence exchange is one bucket-kernel K2 launch, the lock epoch one
# clustered K4 launch, the fused epoch one bulk K3, and every pack and
# unpack one K1 from its run table.
MAIN_EPOCH_LAUNCHES = {
    ("fence", "pallas"): {"gather_rows_runs": 2, "a2a_fence_bulk": 1},
    ("fence", "fused"): {"a2a_fence_fused_bulk": 1, "gather_rows_runs": 1},
    ("lock", "pallas"): {"gather_rows_runs": 2, "a2a_lock_cluster": 1},
}
# The redesigned kernels and the kernels they replace on the paths.
REPLACED_KERNELS = {"a2a_fence_bulk": "a2a_fence",
                    "a2a_lock_cluster": "a2a_lock",
                    "a2a_fence_fused_bulk": "a2a_fence_fused",
                    "gather_rows_runs": "gather_rows"}
# Hierarchy plans of the main path: (P_outer, P_inner) meshes per config.
HIER_MESHES = {"A": ((2, 4), (4, 2)), "B": ((8, 8), (16, 4))}
HIER_IMPLS = ("pallas", "fused")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def same_bytes(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def expect_same(name, got, want) -> None:
    """Raise unless ``got`` and ``want`` hold the same bytes."""
    import torch
    torch.cuda.synchronize()
    if not same_bytes(got, want):
        diff = (got.float() - want.float()).abs()
        raise AssertionError(f"{name}: outputs differ "
                             f"(max |diff| {diff.nan_to_num(1e30).max().item()})")


# Cycles of the GPU sleep queued ahead of a timed run (about 2 ms on an
# H100 SXM): long enough for the host to enqueue the run's calls behind it.
LEAD_CYCLES = 4_000_000


def median_ms(fn, iters=ITERS, inner=5, warmup=3, queued=False) -> float:
    """Median over ``iters`` runs of the device time of one call, each run
    timed with CUDA events around ``inner`` back-to-back calls.  The card
    starts idle, as a caller's would, so the first call's host enqueue and
    a host that paces the card show in the time.  With ``queued`` the
    stream first runs a GPU sleep, so the calls are enqueued before the
    first one starts and the time is the device's alone."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(LEAD_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_ms(fn) -> dict:
    """``ms`` and ``queued_ms`` of ``fn`` (``median_ms`` without and with
    the GPU sleep ahead)."""
    return {"ms": median_ms(fn), "queued_ms": median_ms(fn, queued=True)}


def paired_ms(new, old, **kw) -> tuple[dict, dict]:
    """``device_ms`` of a kernel and of the one it replaced on the same
    inputs, each way timed in the order new, old, old, new; each reading is
    the mean of its two medians.  ``kw`` goes to ``median_ms``."""
    pair = ({}, {})
    for key, queued in (("ms", False), ("queued_ms", True)):
        t = [median_ms(f, queued=queued, **kw) for f in (new, old, old, new)]
        pair[0][key], pair[1][key] = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    return pair


def median_host_ms(fn, iters=ITERS, warmup=3) -> float:
    """Median host time of ``fn`` (which ends by waiting for the device)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def median_enqueue_ms(fn, iters=ITERS, inner=5, warmup=3) -> float:
    """Median host time to enqueue one call of ``fn`` on an idle stream.
    Where it reaches the device time of the call, the host paces the card."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def counted(fn):
    """``fn()`` and the kernel launches it made, by counter."""
    from repro_torch.kernels import _build

    before = _build.counts()
    return fn(), launches_since(before)


def offset_copy(t, nbytes: int):
    """A contiguous copy of ``t`` whose base lies ``nbytes`` past a 16-byte
    aligned address."""
    import torch
    flat = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8,
                       device=t.device)
    out = flat[nbytes:nbytes + t.numel() * t.element_size()].view(t.dtype)
    out = out.view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == nbytes
    return out


def check_redesigned(name, rule, twin, plain, want_rule, want_twin) -> int:
    """A redesigned kernel's wrapper (its rule) and the kernel it replaced,
    forced on
    the same inputs: each must launch the counters named, and each must be
    bytes-equal to the plain version (so to each other).  Returns 2."""
    got, ran = counted(rule)
    if ran != want_rule:
        raise AssertionError(f"{name}: launched {ran}, the rule names {want_rule}")
    old, ran_old = counted(twin)
    if ran_old != want_twin:
        raise AssertionError(f"{name} replaced kernel: launched {ran_old}")
    want = plain()
    expect_same(name, got, want)
    expect_same(f"{name} replaced kernel", old, want)
    return 2


def k2_counter(plan) -> str:
    """The K2 counter an epoch of ``plan`` launches on the card: the kernel
    ``a2a_fence``'s rule names for its wire rows at its capacity."""
    from repro_torch.kernels import a2a_fence

    return a2a_fence.fence_cuda_kernel(plan.wire_row_bytes, plan.capacity).name


def check_fence(name, packed, p, cap, groups=1, want_rule=None) -> int:
    """K2 by its rule (the bucket kernel, or the warp-per-row kernel) and
    by the warp-per-row kernel forced, against the plain version.  With
    ``want_rule`` the rule must name that kernel.  Returns 2."""
    from repro_torch.kernels import a2a_fence

    rule = a2a_fence.fence_kernel_for(packed, cap)
    if want_rule is not None and rule != want_rule:
        raise AssertionError(f"{name}: the K2 rule names {rule}, not {want_rule}")
    counter = (a2a_fence.FENCE_BULK if rule == "bulk" else a2a_fence.FENCE).name
    return check_redesigned(
        name, lambda: a2a_fence.rma_alltoallv_fence(packed, p, cap, groups),
        lambda: a2a_fence.fence_warp_kernel(packed, p, cap, groups),
        lambda: a2a_fence.rma_alltoallv_fence_plain(packed, p, cap, groups),
        {counter: 1}, {a2a_fence.FENCE.name: 1})


def check_fused(name, x, src, valid, p, cap) -> int:
    """K3 by its rule and by the warp-per-row kernel, against the plain
    version."""
    from repro_torch.kernels import a2a_fence

    counter = a2a_fence.FUSED_BULK.name if a2a_fence.fused_kernel_for(
        x) == "bulk" else a2a_fence.FUSED.name
    return check_redesigned(
        name, lambda: a2a_fence.rma_alltoallv_fence_fused(x, src, valid, p, cap),
        lambda: a2a_fence.fence_fused_warp_kernel(x, src, valid, p, cap),
        lambda: a2a_fence.rma_alltoallv_fence_fused_plain(x, src, valid, p, cap),
        {counter: 1}, {a2a_fence.FUSED.name: 1})


def check_lock(name, packed, p, cap, rcaps, sched) -> int:
    """K4 by its rule and by the per-round kernel (one launch per phase),
    against the plain version."""
    from repro_torch.kernels import a2a_lock

    phases = len(a2a_lock.step_launches(a2a_lock.lock_steps(p, cap, rcaps,
                                                             sched)))
    want = ({a2a_lock.CLUSTER.name: 1} if a2a_lock.kernel_for(packed) == "cluster"
            else {a2a_lock.KERNEL.name: phases})
    return check_redesigned(
        name, lambda: a2a_lock.rma_alltoallv_lock(packed, p, cap, rcaps, sched),
        lambda: a2a_lock.lock_step_kernel(packed, p, cap, rcaps, sched),
        lambda: a2a_lock.rma_alltoallv_lock_plain(packed, p, cap, rcaps, sched),
        want, {a2a_lock.KERNEL.name: phases})


def check_gather(name, x, idx, valid, runs=None, x2=None, window=None,
                 want_rule=None) -> int:
    """K1 by its rule (with the run table ``runs``) and by the warp-per-row
    kernel, forced on the same inputs, against the plain version on the
    concatenated sources.  With ``window`` each call writes through into a
    copy of it, whose invalid rows must keep their stale bytes.  Returns 2."""
    import torch
    from repro_torch.kernels import gather_rows as g

    copies = [None if window is None else window.clone() for _ in range(3)]
    rule = g.kernel_for(x, copies[0], x2, runs)
    if want_rule is not None and rule != want_rule:
        raise AssertionError(f"{name}: the rule names {rule}, not {want_rule}")
    joint = x if x2 is None else torch.cat([x, x2], dim=1)
    return check_redesigned(
        name, lambda: g.gather_rows(x, idx, valid, copies[0], x2=x2, runs=runs),
        lambda: g.gather_warp_kernel(x, idx, valid, copies[1], x2=x2),
        lambda: g.gather_rows_plain(joint, idx, valid, copies[2]),
        {g.RUNS.name if rule == "runs" else g.KERNEL.name: 1},
        {g.KERNEL.name: 1})


def check_kernels(device) -> int:
    import numpy as np
    import torch
    from repro_torch.core import metadata as md
    from repro_torch.kernels import a2a_fence, a2a_hier, a2a_lock, gather_rows
    from repro_torch.testing.patterns import banded_counts

    p = 8
    gen = torch.Generator(device=device).manual_seed(0)
    n_cases = 0

    def check(name, got, want):
        nonlocal n_cases
        expect_same(name, got, want)
        n_cases += 1

    def rand(shape, dtype):
        t = torch.randn(shape, generator=gen, device=device).to(dtype)
        # Row 0 of every rank feeds the invalid rows' (unused) source index:
        # a NaN there must not leak into the zeroed padding.
        t[:, 0] = float("nan")
        return t

    cases = [(torch.float32, (256,)), (torch.bfloat16, (2048,)),
             (torch.float32, (100,)), (torch.float32, (3, 5)),
             (torch.float16, (16,))]
    for ci, (dtype, feat) in enumerate(cases):
        tag = f"{dtype}{feat}"
        counts = np.random.default_rng(ci).integers(0, 40, size=(p, p))
        cap = md.global_capacity(counts)
        send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
        recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
        t = md.baked_index_tables(counts, cap, recv_rows)
        src, valid, rsrc, rvalid = (torch.tensor(a, device=device) for a in (
            t.pack_src, t.pack_valid, t.unpack_src, t.unpack_valid))
        x = rand((p, send_rows) + feat, dtype)

        packed = gather_rows.gather_rows(x, src, valid)
        check(f"gather_rows pack {tag}", packed,
              gather_rows.gather_rows_plain(x, src, valid))
        win = rand((p, recv_rows) + feat, dtype)
        w1, w2 = win.clone(), win.clone()
        gather_rows.gather_rows(packed, rsrc, rvalid, out=w1)
        gather_rows.gather_rows_plain(packed, rsrc, rvalid, out=w2)
        check(f"gather_rows unpack write-through {tag}", w1, w2)
        # K1 from the tables' run tables: by its rule (the run kernel for
        # 16-byte rows) and by the warp-per-row kernel
        rb = gather_rows.row_bytes(x)
        runs_p = gather_rows.bake_runs(src, valid, rb)
        runs_u = gather_rows.bake_runs(rsrc, rvalid, rb)
        n_cases += check_gather(f"gather_rows runs pack {tag}", x, src, valid,
                                runs_p)
        n_cases += check_gather(f"gather_rows runs unpack write-through {tag}",
                                packed, rsrc, rvalid, runs_u, window=win)
        n_cases += check_gather(f"gather_rows runs unpack zeroing {tag}",
                                packed, rsrc, rvalid, runs_u)
        n_cases += check_gather(f"gather_rows runs pack {tag} base+4",
                                offset_copy(x, 4), src, valid, runs_p,
                                want_rule="warp")

        # K2: every capacity is a multiple of 8, so the bucket kernel for
        # every width here; 4 bytes off an aligned base, the warp kernel
        n_cases += check_fence(f"a2a_fence {tag}", packed, p, cap,
                               want_rule="bulk")
        n_cases += check_fence(f"a2a_fence {tag} base+4",
                               offset_copy(packed, 4), p, cap,
                               want_rule="warp")
        n_cases += check_fused(f"a2a_fence_fused {tag}", x, src, valid, p, cap)
        # the same send buffer 4 bytes past an aligned base: the rule's
        # replaced kernel
        n_cases += check_fused(f"a2a_fence_fused {tag} base+4",
                               offset_copy(x, 4), src, valid, p, cap)

        for pattern, cnt in (("skewed", counts), ("banded", banded_counts(p))):
            for sched in ("ring", "pairwise"):
                caps = (md.xor_round_capacities(cnt) if sched == "pairwise"
                        else md.ring_round_capacities(cnt))
                for rc_name, rcaps in (("elided", caps), ("full", None)):
                    n_cases += check_lock(
                        f"a2a_lock {sched} {pattern} {rc_name} {tag}",
                        packed, p, cap, rcaps, sched)
        n_cases += check_lock(f"a2a_lock ring base+4 {tag}",
                              offset_copy(packed, 4), p, cap,
                              md.ring_round_capacities(counts), "ring")
        # The fence kernel over groups: the hierarchy's inner all-to-alls,
        # at cap 5: 300-byte buckets of (3, 5) float32 rows take the warp
        # kernel, the others (16-byte multiples) the bucket kernel.
        for groups in (2, 4, 8):
            inner = p // groups
            grouped = rand((p, inner * 5) + feat, dtype)
            n_cases += check_fence(
                f"a2a_fence groups={groups} {tag}", grouped, inner, 5, groups,
                want_rule="warp" if feat == (3, 5) else "bulk")
    # K2's bucket kernel on the shapes its chunking must get right, each
    # against the plain version and the warp kernel: 4-byte and 2-byte
    # rows, buckets that end in a tail chunk (41,600 bytes: five 8 KiB
    # chunks and one of 640), buckets of several chunks at 1 KiB rows,
    # C = 0, G > 1 and P = 1; by rule and forced, 1-byte rows at cap 5 on
    # the warp kernel.
    for label, g, pk, cap, feat, dtype, rule in (
            ("4-byte rows", 1, 64, 488, (), torch.float32, "bulk"),
            ("2-byte rows", 1, 8, 488, (), torch.bfloat16, "bulk"),
            ("2-byte rows G=2", 2, 8, 24, (), torch.float16, "bulk"),
            ("tail chunk", 2, 3, 40, (260,), torch.float32, "bulk"),
            ("64 KiB buckets", 1, 8, 64, (256,), torch.float32, "bulk"),
            ("C=0", 1, 8, 0, (256,), torch.float32, "bulk"),
            ("C=0 G=4", 4, 2, 0, (), torch.float32, "bulk"),
            ("P=1", 1, 1, 488, (), torch.float32, "bulk"),
            ("P=1 G=8", 8, 1, 16, (4,), torch.float32, "bulk"),
            ("1-byte rows cap 5", 2, 8, 5, (), torch.uint8, "warp")):
        shape = (g * pk, pk * cap) + feat
        if dtype == torch.uint8:
            packed = torch.randint(0, 256, shape, generator=gen, device=device,
                                   dtype=dtype)
        else:
            packed = torch.randn(shape, generator=gen, device=device).to(dtype)
        n_cases += check_fence(f"a2a_fence {label}", packed, pk, cap, g,
                               want_rule=rule)
    # The bucket kernel's launcher refuses what the rule never sends it: a
    # base 4 bytes off, and 5-byte buckets.  Nothing is launched.
    aligned = torch.randn((p, p * 8, 4), generator=gen, device=device)
    for label, bad, cap, g in (("base+4", offset_copy(aligned, 4), 8, 1),
                               ("5-byte buckets", packed, 5, 2)):
        try:
            a2a_fence.fence_bulk_kernel(bad, p, cap, g)
        except RuntimeError as e:
            if "invalid argument" not in str(e):
                raise
        else:
            raise AssertionError(f"a2a_fence_bulk took {label}")
        n_cases += 1
    # K3 for any tables, not only a plan's: random source rows and a random
    # valid mask, so a tile's valid rows form many runs (some of one row,
    # some descending), and tiles of 8 and 32 rows.
    rng = np.random.default_rng(7)
    for dtype, feat in ((torch.float32, (256,)), (torch.float16, (16,))):
        cap, send_rows = 70, 50
        src = rng.integers(0, send_rows, (p, p * cap)).astype(np.int32)
        run = rng.random((p, p * cap)) < 0.5  # half the rows continue a run
        for j in range(1, p * cap):
            src[:, j] = np.where(run[:, j], (src[:, j - 1] + 1) % send_rows,
                                 src[:, j])
        valid = rng.random((p, p * cap)) < 0.7
        valid[:, cap:3 * cap] = False  # whole buckets with no valid row
        x = rand((p, send_rows) + feat, dtype)
        n_cases += check_fused(f"a2a_fence_fused random tables {dtype}{feat}",
                               x, torch.tensor(src, device=device),
                               torch.tensor(valid, device=device), p, cap)
    # Every round elided (all traffic local): the local bucket's own launch.
    local = np.diag(np.full(p, 9))
    cap = md.global_capacity(local)
    packed = torch.randn((p, p * cap, 16), generator=gen, device=device)
    n_cases += check_lock("a2a_lock all rounds elided", packed, p, cap,
                          md.ring_round_capacities(local), "ring")
    # P=64, every round elided but one (ring round 5, pairwise round 5):
    # the local bucket, 62 zero buckets and the one active round in one
    # phase.
    big = 64
    ranks = np.arange(big)
    for sched, tgt in (("ring", (ranks + 5) % big), ("pairwise", ranks ^ 5)):
        one = np.diag(np.full(big, 3))
        one[ranks, tgt] = 7
        cap = md.global_capacity(one)
        caps = (md.xor_round_capacities(one) if sched == "pairwise"
                else md.ring_round_capacities(one))
        assert int((np.asarray(caps)[1:] > 0).sum()) == 1
        packed = rand((big, big * cap, 256), torch.float32)
        n_cases += check_lock(f"a2a_lock P=64 one active round {sched}",
                              packed, big, cap, caps, sched)

    # K1 from run tables of any table, not only a plan's: random source
    # rows (repeated, descending, runs), random padding, one rank all
    # invalid; one source and two (split at 60 rows); rows of 16 B, 1 KiB
    # and 32 KiB, chunks cut at 64 B..16 KiB; pack and write-through.
    rng = np.random.default_rng(11)
    n, s_rows = 300, 120
    for feat, chunk in (((4,), 64), ((256,), 4096), ((256,), None),
                        ((8192,), None)):
        idx = rng.integers(0, s_rows, (p, n))
        run = rng.random((p, n)) < 0.6
        for j in range(1, n):
            idx[:, j] = np.where(run[:, j], (idx[:, j - 1] + 1) % s_rows,
                                 idx[:, j])
        valid = rng.random((p, n)) < 0.8
        valid[2] = False
        xs = rand((p, s_rows) + feat, torch.float32)
        win = rand((p, n) + feat, torch.float32)
        ti, tv = (torch.tensor(a, device=device) for a in (idx.astype(np.int32),
                                                           valid))
        rb = gather_rows.row_bytes(xs)
        for split in (None, 60):
            runs = gather_rows.bake_runs(ti, tv, rb, split, chunk)
            x1, x2 = ((xs, None) if split is None else
                      (xs[:, :split].contiguous(), xs[:, split:].contiguous()))
            tag = f"{rb} B rows, chunks {chunk}, split {split}"
            n_cases += check_gather(f"gather_rows runs random {tag}", x1, ti,
                                    tv, runs, x2=x2, want_rule="runs")
            n_cases += check_gather(f"gather_rows runs random write-through "
                                    f"{tag}", x1, ti, tv, runs, x2=x2,
                                    window=win, want_rule="runs")
    # P=300, 16-byte rows, traffic in ring rounds 1, 7 and 297 only: the
    # first phase carries 298 entries, which the step kernel cuts into two
    # launches; the cluster kernel takes one CTA per cluster.
    big = 300
    ranks = np.arange(big)
    sparse = np.diag(np.full(big, 3))
    for r, c in ((1, 2), (7, 5), (big - 3, 1)):
        sparse[ranks, (ranks + r) % big] = c
    cap = md.global_capacity(sparse)
    caps = md.ring_round_capacities(sparse)
    if len(a2a_lock.lock_steps(big, cap, caps, "ring")[0]) <= a2a_lock.MAX_STEP_ROUNDS:
        raise AssertionError("P=300: the first phase must exceed one launch")
    packed = rand((big, big * cap, 4), torch.float32)
    n_cases += check_lock("a2a_lock P=300 ring, 3 active rounds", packed, big,
                          cap, caps, "ring")

    # The hierarchy's stage-2 kernel: meshes x count patterns x leader
    # permutations, the dtypes and row widths taken in turn.
    hier_cases = [(torch.float32, (256,)), (torch.bfloat16, (2048,)),
                  (torch.float32, (3, 5)), (torch.float32, ()),
                  (torch.float16, (16,))]
    perms = {"identity": lambda po, pi: None,
             "reversed": lambda po, pi: [list(range(pi))[::-1]] * po,
             "rotated": lambda po, pi: [list(range(1, pi)) + [0]] * po}
    turn = 0
    for po, pi in ((2, 2), (2, 4), (4, 2), (8, 8), (16, 4)):
        pp = po * pi
        rng = np.random.default_rng(pp + po)
        dense = rng.integers(1, 13, (pp, pp))
        skewed = rng.integers(0, 4, (pp, pp))
        skewed[:, -1] *= 9
        skewed[0, :] *= 5
        group = np.arange(pp) // pi
        local = dense * (group[:, None] == group[None, :])
        for pattern, cnt in (("dense", dense), ("banded", banded_counts(pp)),
                             ("skewed", skewed), ("all-local", local)):
            recv_rows = max(md.round_up(md.max_total_recv(cnt), 8), 8)
            for perm_name, perm in perms.items():
                dtype, feat = hier_cases[turn % len(hier_cases)]
                turn += 1
                sched = md.hier_two_stage_schedule(cnt, po, pi, recv_rows,
                                                   leader_perm=perm(po, pi))
                s1_rows = pi * sched.s1_cap
                s1 = (rand((pp, s1_rows) + feat, dtype) if s1_rows
                      else torch.empty((pp, 0) + feat, dtype=dtype, device=device))
                tables = [torch.tensor(a, device=device) for a in (
                    sched.s2_src, sched.s2_valid, md.hier_stage2_from(sched),
                    md.hier_row_rounds(sched))]
                check(f"a2a_hier {po}x{pi} {pattern} {perm_name} {dtype}{feat}",
                      a2a_hier.rma_hier_leader_exchange(s1, *tables),
                      a2a_hier.rma_hier_leader_exchange_plain(s1, *tables))
    return n_cases


# ---------------------------------------------------------------------------
# Phase 3: the main path through the public entry points
# ---------------------------------------------------------------------------


def make_config(name, counts, device):
    import numpy as np
    import torch
    from repro_torch.core import metadata as md, reference
    p = counts.shape[0]
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    bufs = reference.make_testbufs(counts, (FEATURE,), np.float32, send_rows)
    expect = reference.alltoallv_global(bufs, counts, recv_rows)
    x = torch.from_numpy(bufs.reshape(p * send_rows, FEATURE)).to(device)
    return {"name": name, "p": p, "counts": counts, "send_rows": send_rows,
            "recv_rows": recv_rows, "expect": expect, "x": x,
            "rc": md.recv_counts(counts)}


def check_against_oracle(label, got, cfg) -> None:
    import numpy as np
    got = got.cpu().numpy().reshape(cfg["p"], cfg["recv_rows"], FEATURE)
    for r in range(cfg["p"]):
        n = int(cfg["rc"][r].sum())
        if not np.array_equal(got[r, :n].view(np.uint32),
                              cfg["expect"][r, :n].view(np.uint32)):
            raise AssertionError(f"{label}: rank {r} differs from the oracle")


def run_main_path(configs, device):
    from repro_torch.core import PlanCache, alltoallv_init
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh

    plans = {}
    per_epoch = {}
    _build.reset_counts()
    for cfg in configs:
        mesh = VirtualMesh((cfg["p"],), ("x",))
        for variant, pack_impl, sched in MAIN_RUNS:
            label = f"{cfg['name']}:{variant}x{pack_impl}" + (
                f"x{sched}" if variant == "lock" else "")
            before = _build.counts()
            plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                                  axis="x", variant=variant,
                                  pack_impl=pack_impl, lock_schedule=sched,
                                  cache=PlanCache())
            out = plan.wait(plan.start(cfg["x"]))
            per_epoch[label] = launches_since(before)
            check_against_oracle(label, out, cfg)
            plans[label] = (plan, cfg)
            want = MAIN_EPOCH_LAUNCHES[(variant, pack_impl)]
            if per_epoch[label] != want:
                raise AssertionError(f"{label}: launches {per_epoch[label]}, "
                                     f"want {want}")
    launches = path_launches("main path", [plan for plan, _ in plans.values()])
    no_replaced_kernels("main path", launches)
    return plans, per_epoch, launches


def no_replaced_kernels(path, launches) -> None:
    """The redesigned K3 and K4 replace their earlier kernels on the paths:
    raise if one of those launched."""
    ran = {k: launches[k] for k in REPLACED_KERNELS.values() if launches.get(k)}
    if ran:
        raise AssertionError(f"{path}: replaced kernels launched {ran}")


def launches_since(before) -> dict:
    """Kernel launches since the counter snapshot ``before``, by kernel."""
    from repro_torch.kernels import _build

    after = _build.counts()
    return {k: after[k]["launches"] - before[k]["launches"] for k in after
            if after[k]["launches"] != before[k]["launches"]}


def path_launches(path, plans) -> dict:
    """Every kernel's launches since the counters were zeroed; raise unless
    each kernel of the path's plans launched and no plain version ran."""
    from repro_torch.kernels import _build

    counts = _build.counts()
    wanted = {k.name for plan in plans for k in plan.kernels()}
    missing = sorted(k for k in wanted if counts[k]["launches"] == 0)
    plain = [k for k, v in counts.items() if v["plain_calls"] != 0]
    if missing or plain:
        raise AssertionError(f"{path}: kernels not launched {missing}, "
                             f"plain versions called {plain}")
    return {k: v["launches"] for k, v in counts.items()}


def check_at_main_shapes(cfg, plans, device) -> int:
    """Each kernel against its plain version on the main path's own inputs:
    the config's send buffer, the plans' baked tables and run tables and
    the lock plans' round capacities (ring and pairwise); K1, K3 and K4 by
    their rules and by the kernels they replaced; K1's unpack writing
    through into a window of stale bytes and zeroing (embed()'s)."""
    import torch
    from repro_torch.kernels import a2a_fence, gather_rows

    name = cfg["name"]
    fence = plans[f"{name}:fencexpallas"][0]
    p, cap = fence.p, fence.capacity
    x = cfg["x"].view(p, cfg["send_rows"], FEATURE)
    src, valid, rsrc, rvalid = fence.compile()._tables
    runs = fence.run_tables
    packed = gather_rows.gather_rows(x, src, valid, runs=runs["pack"])
    n = check_gather(f"{name}: gather_rows pack", x, src, valid, runs["pack"],
                     want_rule="runs")
    buckets = a2a_fence.rma_alltoallv_fence(packed, p, cap)
    n += check_fence(f"{name}: a2a_fence", packed, p, cap, want_rule="bulk")
    # the codec's scale side channel: 4-byte rows at the plan's capacity
    scales = torch.randn((p, p * cap), device=device)
    n += check_fence(f"{name}: a2a_fence 4-byte rows", scales, p, cap,
                     want_rule="bulk")
    n += check_fused(f"{name}: a2a_fence_fused", x, src, valid, p, cap)
    # NaN in row 0 of every rank, which the invalid entries' index points at
    xn = x.clone()
    xn[:, 0] = float("nan")
    n += check_fused(f"{name}: a2a_fence_fused NaN planted", xn, src, valid,
                     p, cap)
    gen = torch.Generator(device=device).manual_seed(1)
    win = torch.randn((p, cfg["recv_rows"], FEATURE), generator=gen,
                      device=device)
    n += check_gather(f"{name}: gather_rows unpack write-through", buckets,
                      rsrc, rvalid, runs["unpack"], window=win, want_rule="runs")
    n += check_gather(f"{name}: gather_rows unpack zeroing (embed)", buckets,
                      rsrc, rvalid, runs["unpack"], want_rule="runs")
    for sched in ("ring", "pairwise"):
        lock = plans[f"{name}:lockxpallasx{sched}"][0]
        assert lock.capacity == cap
        rcaps = lock.round_capacities
        n += check_lock(f"{name}: a2a_lock {sched}", packed, p, cap, rcaps,
                        sched)
    return n


# ---------------------------------------------------------------------------
# Phase 3b: the leader-combined hierarchy and embed()
# ---------------------------------------------------------------------------


def hier_label(cfg, mesh, impl, tag="") -> str:
    return f"{cfg['name']}:fence_hierarchy{mesh[0]}x{mesh[1]}x{impl}{tag}"


def valid_rows_equal(label, got, want, cfg) -> None:
    import numpy as np
    got = got.cpu().numpy().reshape(cfg["p"], cfg["recv_rows"], FEATURE)
    want = want.cpu().numpy().reshape(cfg["p"], cfg["recv_rows"], FEATURE)
    for r in range(cfg["p"]):
        n = int(cfg["rc"][r].sum())
        if not np.array_equal(got[r, :n].view(np.uint32),
                              want[r, :n].view(np.uint32)):
            raise AssertionError(f"{label}: rank {r} differs")


@contextlib.contextmanager
def cats_reading(t):
    """Within the block, every ``torch.cat`` one of whose inputs starts at
    ``t``'s address (a view of ``t``) is recorded in the list yielded."""
    import torch

    real, calls = torch.cat, []

    def cat(tensors, *args, **kw):
        if any(u.data_ptr() == t.data_ptr() for u in tensors):
            calls.append([tuple(u.shape) for u in tensors])
        return real(tensors, *args, **kw)

    torch.cat = cat
    try:
        yield calls
    finally:
        torch.cat = real


def run_hier_path(configs, device):
    """fence_hierarchy plans and embed() at A and B, through the public
    entry points, with the kernel counters zeroed before and read after.
    A hierarchy epoch launches K1 from its run tables for the s1 pack, the
    two-source s3 pack and the unpack (the s3 pack and the unpack when
    all-local) and concatenates nothing with the send buffer."""
    import numpy as np
    import torch
    from repro_torch.core import PlanCache, alltoallv_init
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh

    plans, per_epoch, cats = {}, {}, {}
    _build.reset_counts()

    def epoch(label, cfg, mesh, **kw):
        before = _build.counts()
        plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                              cache=PlanCache(), **kw)
        with cats_reading(cfg["x"]) as cats[label]:
            out = plan.wait(plan.start(cfg["x"]))
        per_epoch[label] = launches_since(before)
        check_against_oracle(label, out, cfg)
        plans[label] = (plan, cfg)
        return plan, out

    cfg_a, cfg_b = configs
    b_group = np.arange(cfg_b["p"]) // 8
    cfg_local = make_config("B-local", cfg_b["counts"] * (
        b_group[:, None] == b_group[None, :]), device)
    runs = [(cfg, mesh, impl, None, "") for cfg in (cfg_a, cfg_b)
            for mesh in HIER_MESHES[cfg["name"]] for impl in HIER_IMPLS]
    runs.append((cfg_b, (8, 8), "fused", [list(range(8))[::-1]] * 8,
                 "xreversed"))
    runs.append((cfg_local, (8, 8), "fused", None, ""))
    flat = {}
    for cfg, mesh, impl, perm, tag in runs:
        vm = VirtualMesh(mesh, ("o", "i"))
        key = (cfg["name"], mesh)
        if key not in flat:
            _, out = epoch(f"{cfg['name']}:fence{mesh[0]}x{mesh[1]}xpallas",
                           cfg, vm, axis=("o", "i"), variant="fence",
                           pack_impl="pallas")
            flat[key] = out.clone()
        label = hier_label(cfg, mesh, impl, tag)
        plan, out = epoch(label, cfg, vm, axis=("o", "i"),
                          variant="fence_hierarchy", pack_impl=impl,
                          hier_leader_perm=perm)
        valid_rows_equal(f"{label} vs flat fence", out, flat[key], cfg)
        k5 = per_epoch[label].get("a2a_hier", 0)
        want_k5 = int(impl == "fused" and plan.hierarchy_remote_needed)
        remote = plan.hierarchy_remote_needed
        if (k5 != want_k5 or per_epoch[label].get(k2_counter(plan), 0) != (
                2 if remote else 1)
                or per_epoch[label].get("gather_rows_runs", 0) != (
                    3 if remote else 2)
                or per_epoch[label].get("gather_rows", 0) or cats[label]):
            raise AssertionError(f"{label}: launches {per_epoch[label]}, "
                                 f"cats of the send buffer {cats[label]}")
    if plans[hier_label(cfg_local, (8, 8), "fused")][0].hierarchy_remote_needed:
        raise AssertionError("B-local must be all-local")

    # embed() at A and B: equal to start() on valid rows, zero on padding.
    # A is uniform, so its flat plans take the identity fast path (the bare
    # exchange); B is ragged, so its flat plans run the full embedded body
    # (pack, exchange, unpack into zeroed padding).
    embeds = [(cfg, variant, impl, mesh)
              for cfg, hmesh in ((cfg_a, (2, 4)), (cfg_b, (8, 8)))
              for variant, impl, mesh in (
                  ("fence", "pallas", (cfg["p"],)),
                  ("fence", "fused", (cfg["p"],)),
                  ("lock", "pallas", (cfg["p"],)),
                  ("fence_hierarchy", "fused", hmesh))]
    embed_plans = {}
    for cfg, variant, impl, mesh in embeds:
        p, feat = cfg["p"], (FEATURE,)
        x = cfg["x"]
        label = f"{cfg['name']}:embed {variant}x{impl}"
        axis = ("x",) if len(mesh) == 1 else ("o", "i")
        plan = alltoallv_init(cfg["counts"], feat, "float32",
                              VirtualMesh(mesh, axis),
                              axis=axis[0] if len(mesh) == 1 else axis,
                              variant=variant, pack_impl=impl,
                              cache=PlanCache())
        embed_plans[label] = (plan, cfg)
        if plan.identity_maps != (cfg is cfg_a and len(mesh) == 1):
            raise AssertionError(f"{label}: identity_maps {plan.identity_maps}")
        before = _build.counts()
        got = plan.embed()(x.view((p, plan.send_rows) + feat))
        per_epoch[label] = launches_since(before)
        before = _build.counts()
        started = plan.wait(plan.start(x))
        want = embed_launches(plan, launches_since(before))
        if per_epoch[label] != want:
            raise AssertionError(f"{label}: launches {per_epoch[label]}, "
                                 f"want {want}")
        check_against_oracle(label, got, cfg)
        valid_rows_equal(f"{label} vs start", got, started, cfg)
        pad_rows = 0
        for r in range(p):
            pad = got[r, int(cfg["rc"][r].sum()):]
            pad_rows += pad.shape[0]
            if pad.contiguous().view(torch.uint8).any():
                raise AssertionError(f"{label}: padding of rank {r} not zero")
        if cfg is cfg_b and pad_rows == 0:
            raise AssertionError(f"{label}: B must leave padding rows")
        # the redesigned K4 and K3 on the embedded path: one clustered lock
        # launch per embed, one bulk K3 launch per non-identity fused embed
        redesigned = {"lock": "a2a_lock_cluster",
                      "fused": "a2a_fence_fused_bulk"}
        key = {("lock", "pallas"): "lock", ("fence", "fused"): "fused"}.get(
            (variant, impl))
        if (key is not None and not (key == "fused" and plan.identity_maps)
                and per_epoch[label].get(redesigned[key]) != 1):
            raise AssertionError(f"{label}: launches {per_epoch[label]}")
    launches = path_launches(
        "hierarchy path",
        [plan for plan, _ in list(plans.values()) + list(embed_plans.values())])
    no_replaced_kernels("hierarchy path", launches)
    return plans, embed_plans, per_epoch, launches


def embed_launches(plan, start) -> dict:
    """The launches one embedded epoch must make, from those of one start()
    of the same plan: the identity fast path keeps only the exchange; the
    hierarchy's embedded unpack is the reference gather, not K1."""
    if plan.identity_maps:
        want = ({"a2a_lock_cluster": 1} if plan.spec.variant == "lock"
                else {k2_counter(plan): 1})
    else:
        want = dict(start)
        if plan.hier_schedule is not None and "gather_rows_runs" in want:
            want["gather_rows_runs"] -= 1
    return {k: v for k, v in want.items() if v}


def check_hier_at_main_shapes(plans) -> int:
    """K1 (the s1 pack, the two-source s3 pack and the write-through unpack,
    from the plan's run tables, by rule and by the warp-per-row kernel), the
    stage-2 kernel and the grouped fence kernel against their plain versions
    on the tables of every hierarchy plan of the path (A and B, every mesh,
    leader perm and pack_impl, the all-local pattern and the embedded
    plans); the stage-2 kernel also with NaN planted in the stage-1 rows
    that invalid slab rows point at.  An all-local plan has no stage 1 or
    2: its s3 pack reads the send buffer alone."""
    import math
    import torch
    from repro_torch.kernels import a2a_fence, a2a_hier, gather_rows

    n = 0
    for label, (plan, cfg) in plans.items():
        if plan.hier_schedule is None:
            continue
        sched, t = plan.hier_schedule, plan.compile()._tables
        runs = plan.run_tables
        po, pi, p = sched.p_outer, sched.p_inner, plan.p
        x = cfg["x"].view(p, cfg["send_rows"], FEATURE)
        s3_src, s3_x2 = x, None
        if sched.remote_needed:
            s1_send = gather_rows.gather_rows(x, t[0], t[1], runs=runs["s1"])
            n += check_gather(f"{label}: gather_rows s1 pack", x, t[0], t[1],
                              runs["s1"], want_rule="runs")
            s1 = a2a_fence.rma_alltoallv_fence(s1_send, pi, sched.s1_cap, po)
            n += check_fence(f"{label}: a2a_fence groups stage 1", s1_send,
                             pi, sched.s1_cap, po, want_rule="bulk")
            s2 = a2a_hier.rma_hier_leader_exchange(s1, t[2], t[3], t[8], t[9])
            expect_same(f"{label}: a2a_hier", s2,
                        a2a_hier.rma_hier_leader_exchange_plain(
                            s1, t[2], t[3], t[8], t[9]))
            s1n = s1.clone()
            bad = ~t[3]
            ranks = torch.arange(p, device=x.device)[:, None].expand_as(bad)
            s1n[ranks[bad], t[2][bad].long()] = math.nan
            expect_same(f"{label}: a2a_hier NaN planted",
                        a2a_hier.rma_hier_leader_exchange(s1n, t[2], t[3],
                                                          t[8], t[9]),
                        a2a_hier.rma_hier_leader_exchange_plain(
                            s1n, t[2], t[3], t[8], t[9]))
            s3_src, s3_x2 = s2, x
            n += 2
        s3_send = gather_rows.gather_rows(s3_src, t[4], t[5], x2=s3_x2,
                                          runs=runs["s3"])
        n += check_gather(f"{label}: gather_rows s3 pack"
                          + (" (two sources)" if s3_x2 is not None else ""),
                          s3_src, t[4], t[5], runs["s3"], x2=s3_x2,
                          want_rule="runs")
        s3 = a2a_fence.rma_alltoallv_fence(s3_send, pi, sched.s3_cap, po)
        n += check_fence(f"{label}: a2a_fence groups stage 3", s3_send, pi,
                         sched.s3_cap, po, want_rule="bulk")
        gen = torch.Generator(device=x.device).manual_seed(2)
        win = torch.randn((p, cfg["recv_rows"], FEATURE), generator=gen,
                          device=x.device)
        n += check_gather(f"{label}: gather_rows unpack write-through", s3,
                              t[6], t[7], runs["unpack"], window=win,
                              want_rule="runs")
    return n


# ---------------------------------------------------------------------------
# Phase 4: times on the card
# ---------------------------------------------------------------------------


def time_kernels(configs, plans, device):
    """K1 (redesigned) at A and B, pack and write-through unpack; K2
    (redesigned) at A, B, B with 4-byte rows and the training exchange
    (``time_fence``; the gradient sync's shape is added after phase 10);
    K3 and K4 (redesigned) at A and B: each kernel's time, bound, plain
    time, library call, and the host time to enqueue one call, and the
    times of the kernels they replaced."""
    import torch
    from repro_torch.kernels import a2a_fence, gather_rows

    rows, enqueue = [], {}
    k1 = {(cfg["name"], mode): row for cfg in configs
          for mode, row in time_gather(cfg, plans, device).items()}
    row = dict(k1[("A", "pack")])
    row.update({"name": "gather_rows", "counter": "gather_rows_runs",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/gather_rows.cu",
                "replaces": "src/repro/kernels/gather_rows.py:82",
                "design": "one chunk of the INIT-baked run table per block "
                          f"(at most {gather_rows.RUN_CHUNK_BYTES} bytes of "
                          "consecutive rows, or of zero rows), moved by "
                          "16-byte register copies, 4 loads per thread ahead "
                          "of its stores; zero chunks stored from registers "
                          "or skipped in write-through mode",
                "max_abs_err": max(r["max_abs_err"] for r in k1.values())})
    for (name, mode), r in k1.items():
        if (name, mode) != ("A", "pack"):
            row[f"{name}_{mode}"] = r
    rows.append(row)
    enqueue["gather_rows"] = row["enqueue_ms"]

    k2 = {}
    for cfg in configs:
        name = cfg["name"]
        fence = plans[f"{name}:fencexpallas"][0]
        p, cap = fence.p, fence.capacity
        x = cfg["x"].view(p, cfg["send_rows"], FEATURE)
        src, valid, _, _ = fence.compile()._tables
        packed = gather_rows.gather_rows(x, src, valid,
                                         runs=fence.run_tables["pack"])
        k2[name] = time_fence(name, packed, p, cap)
        del packed
    # B's codec scale side channel: 4-byte rows at B's capacity
    b_plan = plans["B:fencexpallas"][0]
    gen = torch.Generator(device=device).manual_seed(8)
    scales = torch.randn((b_plan.p, b_plan.p * b_plan.capacity),
                         generator=gen, device=device)
    k2["B_4byte_rows"] = time_fence("B 4-byte rows", scales, b_plan.p,
                                    b_plan.capacity)
    del scales
    # the training path's MoE exchange (forward and backward)
    ep, cap, d = TRAIN_EXCHANGE
    x = torch.randn((ep, ep * cap, d), generator=gen, device=device).to(
        torch.bfloat16)
    k2["train_exchange"] = time_fence("train exchange", x, ep, cap)
    del x
    row = {"name": "a2a_fence_bulk", "counter": "a2a_fence_bulk",
           "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/a2a_fence.cu",
           "replaces": "src/repro/kernels/a2a_fence.py:102",
           "design": "each bucket one contiguous copy of C x row_bytes "
                     "bytes, cut into chunks of at most "
                     f"{a2a_fence.FENCE_CHUNK_BYTES} bytes, one chunk per "
                     "block in output order, 16-byte register copies with "
                     "4 loads per thread ahead of its stores; the "
                     "warp-per-row kernel (counter a2a_fence) keeps buckets "
                     "that are not 16-byte multiples and unaligned bases",
           **k2["A"], **{k: v for k, v in k2.items() if k != "A"}}
    rows.append(row)
    enqueue["a2a_fence_bulk"] = row["enqueue_ms"]

    timed = {cfg["name"]: time_redesigned(cfg, plans, device) for cfg in configs}
    for name in ("a2a_fence_fused_bulk", "a2a_lock_cluster"):
        row = dict(timed["A"][name])
        row["B"] = {k: v for k, v in timed["B"][name].items()
                    if k not in ("name", "counter", "route", "source",
                                 "replaces", "design")}
        rows.append(row)
        enqueue[name] = row["enqueue_ms"]
    return rows, enqueue


def time_fence(tag, packed, p, cap, groups=1, iters=ITERS, inner=5) -> dict:
    """K2 on ``packed``: the bucket kernel its rule names and the
    warp-per-row kernel forced on the same inputs (``paired_ms``), each
    gated bytes-equal to the plain version; the plain version, the bucket
    transpose as the library call (``view·transpose·contiguous``), the
    host enqueue time and ``zero_fill_ms``; the bound: every bucket byte
    read once and written once.  ``chunk_sweep_queued_ms``: the bucket
    kernel's queued time at other chunk sizes (``FENCE_CHUNK_BYTES`` is
    the one the wrapper takes)."""
    import math
    import torch
    from repro_torch.kernels import a2a_fence

    if a2a_fence.fence_kernel_for(packed, cap) != "bulk":
        raise AssertionError(f"{tag}: the K2 rule names "
                             f"{a2a_fence.fence_kernel_for(packed, cap)}")
    feat = tuple(packed.shape[2:])

    def kern():
        return a2a_fence.rma_alltoallv_fence(packed, p, cap, groups)

    def old():
        return a2a_fence.fence_warp_kernel(packed, p, cap, groups)

    def plain():
        return a2a_fence.rma_alltoallv_fence_plain(packed, p, cap, groups)

    def library():
        return packed.view((groups, p, p, cap) + feat).transpose(1, 2).contiguous()

    got, ran = counted(kern)
    if ran != {a2a_fence.FENCE_BULK.name: 1}:
        raise AssertionError(f"{tag}: K2 launched {ran}")
    want = plain()
    expect_same(f"{tag}: a2a_fence_bulk at timing", got, want)
    err = float((got.float() - want.float()).abs().max().item())
    del want
    expect_same(f"{tag}: a2a_fence replaced kernel at timing", old(), got)
    expect_same(f"{tag}: a2a_fence library call", library().view(got.shape),
                got)
    rb = math.prod(feat) * packed.element_size()
    nbytes = 2 * packed.numel() * packed.element_size()
    kw = {"iters": iters, "inner": inner}
    new_ms, old_ms = paired_ms(kern, old, **kw)
    out = {
        "config": tag, "shape": list(packed.shape),
        "dtype": str(packed.dtype).split(".")[-1], "groups": groups, "p": p,
        "capacity": cap, "row_bytes": rb, "bucket_bytes": cap * rb,
        "chunks": len(a2a_fence.fence_chunks(groups, p, cap, rb)),
        "chunk_bytes": a2a_fence.FENCE_CHUNK_BYTES, "max_abs_err": err,
        **new_ms, "plain_ms": median_ms(plain, **kw),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "bytes": nbytes,
        "library_ms": median_ms(library, **kw),
        "library_queued_ms": median_ms(library, queued=True, **kw),
        "library": "view·transpose·contiguous",
        "enqueue_ms": median_enqueue_ms(kern, **kw),
        "zero_fill_ms": median_ms(torch.empty_like(got).zero_, **kw),
        "replaced_kernel": {"counter": a2a_fence.FENCE.name, **old_ms,
                            "enqueue_ms": median_enqueue_ms(old, **kw)},
        "chunk_sweep_queued_ms": {
            c: median_ms(lambda c=c: a2a_fence.fence_bulk_kernel(
                packed, p, cap, groups, c), queued=True, **kw)
            for c in FENCE_CHUNK_SWEEP}}
    del got
    return out


def floors(out) -> dict:
    """The card's floors for writing ``out``'s bytes: ``copy_floor_ms``, one
    ``Tensor.copy_`` of a buffer of that size into another (read and write),
    and ``zero_fill_ms``, one ``zero_`` of it (write only); each also
    queued (``..._queued_ms``)."""
    import torch

    a, b = torch.empty_like(out), torch.empty_like(out)
    res = {}
    for name, fn in (("copy_floor", lambda: a.copy_(b)), ("zero_fill", a.zero_)):
        t = device_ms(fn)
        res[f"{name}_ms"], res[f"{name}_queued_ms"] = t["ms"], t["queued_ms"]
    return res


def time_gather(cfg, plans, device) -> dict:
    """K1 on one config's own inputs: the pack (the fence plan's send buffer
    and pack table) and the write-through unpack (the exchanged buckets
    into a window of stale bytes, the unpack table).  For each: the run
    kernel the rule names with the plan's run table, the warp-per-row
    kernel it replaced, forced on the same inputs (``paired_ms``), the
    plain version, one
    ``index_select`` over the flat source with a zero row appended (outside
    the timed call) and the composed index (it zeroes invalid rows: for the
    unpack it is gated against K1's zeroing form), the host enqueue time
    and the card's floors for the output.  The bound: the valid rows read
    once, the rows written once (every row for the pack, the valid rows for
    the write-through unpack) and the run table read once."""
    import torch
    from repro_torch.kernels import a2a_fence, gather_rows as g

    name = cfg["name"]
    fence = plans[f"{name}:fencexpallas"][0]
    p, cap, rb = fence.p, fence.capacity, fence.row_bytes
    x = cfg["x"].view(p, cfg["send_rows"], FEATURE)
    src, valid, rsrc, rvalid = fence.compile()._tables
    runs = fence.run_tables
    packed = g.gather_rows(x, src, valid, runs=runs["pack"])
    buckets = a2a_fence.rma_alltoallv_fence(packed, p, cap)
    del packed
    gen = torch.Generator(device=device).manual_seed(6)
    window = torch.randn((p, cfg["recv_rows"], FEATURE), generator=gen,
                         device=device)
    ranks = torch.arange(p, device=device)[:, None]
    out = {}
    cases = {"pack": (x, src, valid, None, runs["pack"]),
             "unpack": (buckets, rsrc, rvalid, window, runs["unpack"])}
    for mode, (xs, idx, ok, win, run) in cases.items():
        if g.kernel_for(xs, win, None, run) != "runs":
            raise AssertionError(f"{name}: K1 {mode}: the rule names "
                                 f"{g.kernel_for(xs, win, None, run)}")
        rows_in = xs.shape[1]
        flat = torch.cat([xs.reshape(-1, FEATURE), xs.new_zeros((1, FEATURE))])
        lib_idx = torch.where(ok, idx.long() + ranks * rows_in,
                              p * rows_in).reshape(-1)

        def kern():
            return g.gather_rows(xs, idx, ok, win, runs=run)

        def old():
            return g.gather_warp_kernel(xs, idx, ok, win)

        def plain():
            return g.gather_rows_plain(xs, idx, ok, win)

        def library():
            return torch.index_select(flat, 0, lib_idx)

        def stale():
            return None if win is None else win.clone()

        got = g.gather_rows(xs, idx, ok, stale(), runs=run)
        want = g.gather_rows_plain(xs, idx, ok, stale())
        expect_same(f"{name}: K1 {mode} at timing", got, want)
        expect_same(f"{name}: K1 {mode} replaced kernel at timing",
                    g.gather_warp_kernel(xs, idx, ok, stale()), want)
        zeroing = g.gather_rows(xs, idx, ok, runs=run)
        expect_same(f"{name}: K1 {mode} library call",
                    library().view(zeroing.shape), zeroing)
        n_valid = int(ok.sum().item())
        written = n_valid if win is not None else ok.numel()
        chunks = run.chunks
        nbytes = (n_valid + written) * rb + chunks.numel() * chunks.element_size()
        new_ms, old_ms = paired_ms(kern, old)
        out[mode] = {
            "config": name, "mode": mode,
            "max_abs_err": float((got.float() - want.float()).abs().max().item()),
            **new_ms, "plain_ms": median_ms(plain),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "bytes": nbytes,
            "library_ms": median_ms(library),
            "library_queued_ms": median_ms(library, queued=True),
            "library": "index_select over the flat source + zero row",
            "enqueue_ms": median_enqueue_ms(kern), **floors(got),
            "chunks": chunks.shape[0], "chunk_bytes": g.RUN_CHUNK_BYTES,
            "replaced_kernel": {"counter": "gather_rows", **old_ms,
                                "enqueue_ms": median_enqueue_ms(old)}}
        del got, want, zeroing, flat, lib_idx
    return out


def time_redesigned(cfg, plans, device) -> dict:
    """K3 and K4 on one config's own inputs (its send buffer, the fence
    plan's tables, the ring lock plan's round capacities): the kernel the
    rule names, the kernel it replaced forced on the same inputs, the plain
    version and one library call, each gated bytes-equal to the plain
    version; the bound (every input read once, every output written once)
    and the host enqueue time.  The library call is one ``index_select``
    over the flat source with a zero row appended (outside the timed call)
    and the composed index (invalid rows point at the zero row); for K4 at
    the dense config A it stays the bucket transpose.  ``zero_fill_ms`` is
    one ``zero_`` of a buffer the size of the output: the card's measured
    time to write those bytes alone, below which no kernel that writes
    them can go."""
    import torch
    from repro_torch.kernels import a2a_fence, a2a_lock, gather_rows

    name = cfg["name"]
    fence = plans[f"{name}:fencexpallas"][0]
    rcaps = plans[f"{name}:lockxpallasxring"][0].round_capacities
    p, cap, rb, sr = fence.p, fence.capacity, fence.row_bytes, cfg["send_rows"]
    x = cfg["x"].view(p, sr, FEATURE)
    src, valid, _, _ = fence.compile()._tables
    packed = gather_rows.gather_rows(x, src, valid,
                                     runs=fence.run_tables["pack"])
    ranks = torch.arange(p, device=device)
    bucket_rows = p * p * cap

    def zero_row(t):
        return torch.cat([t.reshape(-1, FEATURE), t.new_zeros((1, FEATURE))])

    # K3: out[tgt][s*C + k] = valid[s][tgt*C + k] ? x[s][src[s][tgt*C + k]] : 0
    flat_x = zero_row(x)
    k3_idx = torch.where(valid, src.long() + ranks[:, None] * sr, p * sr)
    k3_idx = k3_idx.view(p, p, cap).transpose(0, 1).reshape(-1)
    # K4 (ring): out[tgt][i*C + k] = k < cap_r ? packed[i][tgt*C + k] : 0,
    # r = (tgt - i) % P, round 0 at the full capacity
    flat_p = zero_row(packed)
    tgt, org = ranks[:, None, None], ranks[None, :, None]
    k = torch.arange(cap, device=device)[None, None, :]
    caps_t = torch.tensor([cap] + [min(int(c), cap) for c in rcaps[1:]],
                          device=device)
    k4_idx = torch.where(k < caps_t[(tgt - org) % p], (org * p + tgt) * cap + k,
                         bucket_rows).reshape(-1)
    n_valid = int(valid.sum().item())
    lock_read_rows = p * cap + p * sum(min(int(c), cap) for c in rcaps[1:])
    active = a2a_lock.active_clusters(device.index)
    if name == "A":
        def k4_library():
            return packed.view(p, p, cap, FEATURE).transpose(0, 1).contiguous()
        k4_library_name = "view·transpose·contiguous"
    else:
        def k4_library():
            return torch.index_select(flat_p, 0, k4_idx)
        k4_library_name = "index_select over the flat packed buffer + zero row"

    specs = {
        "a2a_fence_fused_bulk": dict(
            source="src/repro_torch/kernels/csrc/a2a_fence.cu",
            replaces="src/repro/kernels/a2a_fence.py:237",
            design="one 8 KiB output tile inside one bucket per block; one "
                   "TMA bulk load per run of consecutive source rows into "
                   "the block's stage and one bulk store per tile; "
                   "all-invalid tiles stored as zeros from registers",
            kern=lambda: a2a_fence.rma_alltoallv_fence_fused(x, src, valid, p, cap),
            rule=a2a_fence.fused_kernel_for(x), want_rule="bulk",
            replaced=lambda: a2a_fence.fence_fused_warp_kernel(x, src, valid, p, cap),
            replaced_counter="a2a_fence_fused", replaced_launches=1,
            plain=lambda: a2a_fence.rma_alltoallv_fence_fused_plain(
                x, src, valid, p, cap),
            library=lambda: torch.index_select(flat_x, 0, k3_idx),
            library_name="index_select over the flat send buffer + zero row",
            geometry={"tile_rows": a2a_fence.fused_tile_rows(rb)},
            nbytes=n_valid * rb + 5 * src.numel() + bucket_rows * rb),
        "a2a_lock_cluster": dict(
            source="src/repro_torch/kernels/csrc/a2a_lock.cu",
            replaces="src/repro/kernels/a2a_lock.py:74",
            design="one launch per epoch: one thread-block cluster per origin "
                   "rank, its CTAs splitting each round's bucket bytes, TMA "
                   "bulk copies through an 8-stage shared-memory ring, a "
                   "cluster barrier after each round",
            kern=lambda: a2a_lock.rma_alltoallv_lock(packed, p, cap, rcaps, "ring"),
            rule=a2a_lock.kernel_for(packed), want_rule="cluster",
            replaced=lambda: a2a_lock.lock_step_kernel(packed, p, cap, rcaps, "ring"),
            replaced_counter="a2a_lock",
            replaced_launches=len(a2a_lock.lock_steps(p, cap, rcaps, "ring")),
            plain=lambda: a2a_lock.rma_alltoallv_lock_plain(
                packed, p, cap, rcaps, "ring"),
            library=k4_library, library_name=k4_library_name,
            geometry={"clusters": p, "cluster_ctas": a2a_lock.lock_cluster_size(
                p, active), "active_clusters_by_size": active},
            nbytes=lock_read_rows * rb + bucket_rows * rb),
    }
    out = {}
    for kname, sp in specs.items():
        if sp["rule"] != sp["want_rule"]:
            raise AssertionError(f"{name}: {kname}: the rule names {sp['rule']}")
        got, want, old = sp["kern"](), sp["plain"](), sp["replaced"]()
        expect_same(f"{name}: {kname} at timing", got, want)
        expect_same(f"{name}: {kname} replaced kernel at timing", old, want)
        expect_same(f"{name}: {kname} library call",
                    sp["library"]().view(got.shape), got)
        new_ms, old_ms = paired_ms(sp["kern"], sp["replaced"])
        out[kname] = {
            "name": kname, "counter": kname, "route": "cuda",
            "source": sp["source"], "replaces": sp["replaces"],
            "design": sp["design"], "config": name,
            "max_abs_err": float((got.float() - want.float()).abs().max().item()),
            **new_ms, "plain_ms": median_ms(sp["plain"]),
            "bound_ms": bound_ms(sp["nbytes"]), "bound_by": "bytes",
            "bytes": sp["nbytes"], "library_ms": median_ms(sp["library"]),
            "library_queued_ms": median_ms(sp["library"], queued=True),
            "library": sp["library_name"],
            "enqueue_ms": median_enqueue_ms(sp["kern"]),
            "zero_fill_ms": median_ms(torch.empty_like(got).zero_),
            "zero_fill_queued_ms": median_ms(torch.empty_like(got).zero_,
                                             queued=True),
            "geometry": sp["geometry"],
            "replaced_kernel": {"counter": sp["replaced_counter"],
                                "launches_per_call": sp["replaced_launches"],
                                **old_ms,
                                "enqueue_ms": median_enqueue_ms(sp["replaced"])},
        }
    return out


def time_hier_kernel(plan, cfg):
    """The stage-2 kernel at B (8, 8) on the plan's own tables: its time,
    bound, plain time, library call and enqueue time."""
    import torch
    from repro_torch.core import variants
    from repro_torch.kernels import a2a_hier

    sched, t = plan.hier_schedule, plan.compile()._tables
    p, rb = plan.p, plan.row_bytes
    x = cfg["x"].view(p, cfg["send_rows"], FEATURE)
    s1 = variants.inner_all_to_all(variants.pack_rows(x, t[0], t[1]),
                                   sched.p_outer, sched.p_inner, sched.s1_cap)
    args = (s1, t[2], t[3], t[8], t[9])
    s1_rows, total_s2 = s1.shape[1], sched.total_s2

    # Library call: one index_select over the flat stage-1 buffer with a
    # zero row appended (outside the timed call); the index composes
    # s2_from with s2_src, and invalid rows point at the zero row.
    flat = torch.cat([s1.reshape(p * s1_rows, FEATURE),
                      s1.new_zeros((1, FEATURE))])
    src = t[8].long()[:, t[9].long()]
    rows = torch.arange(total_s2, device=s1.device)[None, :]
    srcc = src.clamp(min=0)
    read = (src >= 0) & t[3][srcc, rows]
    idx = torch.where(read, srcc * s1_rows + t[2][srcc, rows].long(),
                      p * s1_rows).reshape(-1)

    def kern():
        return a2a_hier.rma_hier_leader_exchange(*args)

    def plain():
        return a2a_hier.rma_hier_leader_exchange_plain(*args)

    def library():
        return torch.index_select(flat, 0, idx)

    got, want = kern(), plain()
    expect_same("B (8, 8): a2a_hier at timing", got, want)
    expect_same("B (8, 8): a2a_hier library call", library().view(got.shape), got)
    # Each slab row read once, every output row written once, 5 bytes of
    # index and mask per output row, the row->round and source tables.
    nbytes = ((int(read.sum().item()) + p * total_s2) * rb + 5 * p * total_s2
              + 2 * total_s2 + 4 * t[8].numel())
    row = {
        "name": "a2a_hier", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/a2a_hier.cu",
        "replaces": "src/repro/kernels/a2a_hier.py:183",
        "max_abs_err": float((got.float() - want.float()).abs().max().item()),
        **device_ms(kern), "plain_ms": median_ms(plain),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "bytes": nbytes,
        "library_ms": median_ms(library),
        "library_queued_ms": median_ms(library, queued=True), "shape": "B (8, 8)",
    }
    return row, median_enqueue_ms(kern)


def time_hier_passes(plan, cfg) -> dict:
    """Each pass of one fused hierarchy epoch on its own, on the plan's
    tables and run tables (CUDA events, median of 20), beside the pass's
    bound; and the unfused stage 2 (``stage2_leader_ppermute``) for
    comparison.  The s3 pack reads the stage-2 rows and the send buffer as
    two sources: no concatenation."""
    import numpy as np
    import torch
    from repro_torch.core import variants
    from repro_torch.kernels import a2a_fence, a2a_hier, gather_rows

    s, t = plan.hier_schedule, plan.compile()._tables
    runs = plan.run_tables
    p, rb = plan.p, plan.row_bytes
    po, pi = s.p_outer, s.p_inner
    x = cfg["x"].view(p, cfg["send_rows"], FEATURE)
    n1, n2, n3 = s.s1_src.size, s.s2_src.size, s.s3_src.size
    s1_send = gather_rows.gather_rows(x, t[0], t[1], runs=runs["s1"])
    s1 = a2a_fence.rma_alltoallv_fence(s1_send, pi, s.s1_cap, po)
    s2 = a2a_hier.rma_hier_leader_exchange(s1, t[2], t[3], t[8], t[9])
    s3_send = gather_rows.gather_rows(s2, t[4], t[5], x2=x, runs=runs["s3"])
    s3 = a2a_fence.rma_alltoallv_fence(s3_send, pi, s.s3_cap, po)
    win = torch.zeros((p, cfg["recv_rows"], FEATURE), device=x.device)
    src = np.asarray(t[8].cpu())[:, np.asarray(t[9].cpu())]
    read = (src >= 0) & s.s2_valid[np.maximum(src, 0), np.arange(s.total_s2)]

    def run_bytes(name):
        chunks = runs[name].chunks
        return chunks.numel() * chunks.element_size()

    passes = {
        "s1 pack (K1)": (
            lambda: gather_rows.gather_rows(x, t[0], t[1], runs=runs["s1"]),
            (int(s.s1_valid.sum()) + n1) * rb + run_bytes("s1")),
        "s1 fence (K2 groups)": (
            lambda: a2a_fence.rma_alltoallv_fence(s1_send, pi, s.s1_cap, po),
            2 * n1 * rb),
        "stage 2 (K5)": (
            lambda: a2a_hier.rma_hier_leader_exchange(s1, t[2], t[3], t[8], t[9]),
            (int(read.sum()) + n2) * rb + 5 * n2),
        "stage 2 (stage2_leader_ppermute)": (
            lambda: variants.stage2_leader_ppermute(s1, t[2], t[3], s, t[8]),
            (int(s.s2_valid.sum()) + n2) * rb + 5 * n2 + 2 * n2 * rb),
        "s3 pack (K1, two sources)": (
            lambda: gather_rows.gather_rows(s2, t[4], t[5], x2=x,
                                            runs=runs["s3"]),
            (int(s.s3_valid.sum()) + n3) * rb + run_bytes("s3")),
        "s3 fence (K2 groups)": (
            lambda: a2a_fence.rma_alltoallv_fence(s3_send, pi, s.s3_cap, po),
            2 * n3 * rb),
        "unpack (K1 write-through)": (
            lambda: gather_rows.gather_rows(s3, t[6], t[7], out=win,
                                            runs=runs["unpack"]),
            2 * int(s.unpack_valid.sum()) * rb + run_bytes("unpack")),
    }
    return {name: {**device_ms(fn), "bound_ms": bound_ms(nbytes)}
            for name, (fn, nbytes) in passes.items()}


def hier_design_bytes(plan) -> int:
    """Least bytes one hierarchy epoch moves, every pass over the schedule's
    padded layouts: s1 pack, grouped fence, stage 2, s3 pack (two sources;
    "jnp" concatenates them first), grouped fence, write-through unpack."""
    import numpy as np
    from repro_torch.core import metadata as md

    s, p, rb = plan.hier_schedule, plan.p, plan.row_bytes
    n1, n2, n3 = s.s1_src.size, s.s2_src.size, s.s3_src.size
    tables = 5 * (n1 + n2 + n3 + s.unpack_src.size)
    total = (int(s.s3_valid.sum()) + n3) * rb + 2 * n3 * rb        # s3 pack, fence
    total += 2 * int(s.unpack_valid.sum()) * rb                     # unpack
    if s.remote_needed:
        total += (int(s.s1_valid.sum()) + n1) * rb + 2 * n1 * rb    # s1 pack, fence
        if plan.spec.pack_impl == "fused":
            src = md.hier_stage2_from(s)[:, md.hier_row_rounds(s)]
            rows = np.arange(s.total_s2)[None, :]
            read = (src >= 0) & s.s2_valid[np.maximum(src, 0), rows]
            total += (int(read.sum()) + n2) * rb                    # K5
            tables += 2 * s.total_s2 + 4 * src.shape[0] * s.n_macro
        else:
            total += (int(s.s2_valid.sum()) + n2) * rb + 2 * n2 * rb  # pack, selects
        if plan.spec.pack_impl == "jnp":
            total += 2 * (n2 + p * plan.send_rows) * rb             # cat
    return total + tables


def design_bytes(plan) -> int:
    """Least bytes one epoch of this design moves: each pass reads its input
    rows once and writes its output rows once, padded buckets included."""
    if plan.hier_schedule is not None:
        return hier_design_bytes(plan)
    spec, p, cap, rb = plan.spec, plan.p, plan.capacity, plan.row_bytes
    t = plan.index_tables
    n_pack_valid = int(t.pack_valid.sum())
    n_unpack_valid = int(t.unpack_valid.sum())
    tables = (t.pack_src.size * 5 + t.unpack_src.size * 5)
    bucket_rows = p * p * cap
    unpack = n_unpack_valid * 2 * rb
    if spec.pack_impl == "fused":
        return n_pack_valid * rb + bucket_rows * rb + unpack + tables
    pack = n_pack_valid * rb + bucket_rows * rb
    if spec.variant == "fence":
        exchange = 2 * bucket_rows * rb
    else:
        caps = plan.round_capacities
        read = p * cap + p * sum(min(int(c), cap) for c in caps[1:])
        exchange = read * rb + bucket_rows * rb
    return pack + exchange + unpack + tables


def payload_bytes(plan) -> int:
    """Least bytes any alltoallv of this pattern moves: every valid row read
    once and written once, plus the plan's index tables."""
    if plan.hier_schedule is not None:
        s = plan.hier_schedule
        tables = 5 * sum(t.size for t in s.tables[::2])
        return 2 * int(plan.send_counts.sum()) * plan.row_bytes + tables
    t = plan.index_tables
    tables = (t.pack_src.size * 5 + t.unpack_src.size * 5)
    return (int(t.pack_valid.sum()) + int(t.unpack_valid.sum())) \
        * plan.row_bytes + tables


def time_epochs(plans, hier_plans, configs, device):
    import torch
    from repro_torch.core import PlanCache, alltoallv_init
    from repro_torch.core.baseline import make_nonpersistent
    from repro_torch.launch.mesh import VirtualMesh

    timed = dict(plans)
    timed.update((k, v) for k, v in hier_plans.items() if "fence_hierarchy" in k)
    # Persistent plans that pack as the baseline does (index_select + mask):
    # the persistence gain apart from K1.
    for cfg in configs:
        mesh = VirtualMesh((cfg["p"],), ("x",))
        for variant in ("fence", "lock"):
            plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                                  axis="x", variant=variant, pack_impl="jnp",
                                  cache=PlanCache())
            label = f"{cfg['name']}:{variant}xjnp" + (
                "xring" if variant == "lock" else "")
            check_against_oracle(label, plan.wait(plan.start(cfg["x"])), cfg)
            timed[label] = (plan, cfg)
    out = {}
    for label, (plan, cfg) in timed.items():
        x = cfg["x"]
        out[label] = {
            "device_ms": median_ms(lambda: plan.start(x)),
            "epoch_ms": median_host_ms(lambda: plan.wait(plan.start(x))),
            "enqueue_ms": median_enqueue_ms(lambda: plan.start(x)),
            "design_bound_ms": bound_ms(design_bytes(plan)),
            "payload_bound_ms": bound_ms(payload_bytes(plan)),
            "init_host_seconds": plan.init_host_seconds,
            "init_compile_seconds": plan.init_compile_seconds,
            "init_run_table_seconds": plan.init_run_table_seconds,
        }
    for cfg in configs:
        p = cfg["p"]
        cnts = torch.tensor(cfg["counts"].reshape(-1), dtype=torch.int32,
                            device=device)
        fence_plan = plans[f"{cfg['name']}:fencexpallas"][0]
        for variant in ("fence", "lock"):
            exe = make_nonpersistent(
                VirtualMesh((p,), ("x",)), axis="x", p=p,
                capacity=fence_plan.capacity, send_rows=cfg["send_rows"],
                recv_rows=cfg["recv_rows"], feature_shape=(FEATURE,),
                dtype=torch.float32, variant=variant)
            got = exe(cfg["x"], cnts)
            check_against_oracle(f"{cfg['name']}:baseline {variant}", got, cfg)

            def call_and_wait():
                exe(cfg["x"], cnts)
                torch.cuda.synchronize()

            out[f"{cfg['name']}:baseline_{variant}"] = {
                "device_ms": median_ms(lambda: exe(cfg["x"], cnts)),
                "epoch_ms": median_host_ms(call_and_wait),
                "enqueue_ms": median_enqueue_ms(lambda: exe(cfg["x"], cnts)),
                "payload_bound_ms": bound_ms(payload_bytes(fence_plan)),
            }
    return out


# ---------------------------------------------------------------------------
# Slice 3: K6 and OLMoE-1B-7B serving through the persistent MoE dispatch
# ---------------------------------------------------------------------------

# H100 SXM dense peaks (NVIDIA data sheet): bf16 on the tensor cores, float32
# on the CUDA cores.
PEAK_FLOPS = {"bfloat16": hw.PEAK_FLOPS_BF16, "float32": hw.PEAK_FLOPS_FP32}
K6_TOL = {"float32": 2e-5, "bfloat16": 8e-3}     # x max|plain|
# The counter of each kernel ``gather_matmul.kernel_for`` can name.
K6_COUNTERS = {"wgmma": "gather_matmul_wgmma", "mma_sync": "gather_matmul",
               "cuda_core": "gather_matmul"}
# The mma.sync design's times at the serve shapes, which the wgmma kernel
# replaced on the serve path (H100 80GB HBM3, 700.00 W, CUDA events, median
# of 20, this script's gather_matmul_times phase).
K6_MMA_SYNC_MS = {"prefill": 0.5086, "decode": 0.3536}
SERVE = {"batch": 4, "prompt": 128, "tokens": 16, "mesh": (1, 8)}
VS_CPU = {"batch": 2, "prompt": 32, "tokens": 4, "layers": 2}


def k6_error(got, want) -> tuple[float, float]:
    """max|kernel - plain| and max|plain|, in float32."""
    return (float((got.float() - want.float()).abs().max().item()),
            float(want.float().abs().max().item()))


def k6_case(gm, gen, device, dtype, e, n, d, f, shift_x=0, shift_w=0):
    """One K6 case against its plain version: repeated indices, zeros in
    the mask, the last expert all invalid (E > 1), NaN (row r-2) and inf
    (row r-1) in rows that only invalid entries read.  ``shift_x`` and
    ``shift_w`` start x or w that many elements past an aligned base.
    Returns (err / max|plain|, the counter of the kernel that ran)."""
    import torch
    from repro_torch.kernels import _build

    name = str(dtype).split(".")[-1]
    r = 3 * n + 2
    x = torch.randn((r * d + shift_x,), generator=gen, device=device).to(dtype)
    x = x[shift_x:].view(r, d)
    w = (torch.randn((e * d * f + shift_w,), generator=gen, device=device)
         * d ** -0.5).to(dtype)[shift_w:].view(e, d, f)
    idx = torch.randint(0, r - 2, (e, n), generator=gen, device=device,
                        dtype=torch.int32)
    idx[:, ::5] = idx[:, :1].clone()
    valid = torch.rand((e, n), generator=gen, device=device) < 0.7
    valid[0, 0] = False
    if e > 1:
        valid[-1] = False
    idx[~valid] = (r - 2) + (torch.arange(
        int((~valid).sum()), device=device) % 2).int()
    x[r - 2], x[r - 1] = float("nan"), float("inf")
    label = f"{name} E{e} N{n} D{d} F{f} x+{shift_x} w+{shift_w}"
    counter = K6_COUNTERS[gm.kernel_for(x, w)]
    before = _build.counts()
    got = gm.gather_matmul_kernel(x, idx, valid, w)
    ran = {k: v["launches"] - before[k]["launches"]
           for k, v in _build.counts().items()
           if v["launches"] != before[k]["launches"]}
    if ran != {counter: 1}:
        raise AssertionError(f"gather_matmul {label}: launched {ran}, the rule "
                             f"names {counter}")
    want = gm.gather_matmul_plain(x, idx, valid, w)
    torch.cuda.synchronize()
    bits = got[~valid].view(torch.int16 if dtype != torch.float32 else torch.int32)
    if bits.any():
        raise AssertionError(f"gather_matmul {label}: invalid rows are not +0.0")
    err, ref = k6_error(got, want)
    if not err <= K6_TOL[name] * ref:
        raise AssertionError(f"gather_matmul {label}: max|diff| {err} > "
                             f"{K6_TOL[name]} x {ref}")
    return err / ref, counter


def check_gather_matmul(device) -> dict:
    """K6 against its plain version over dtypes and shapes (``k6_case``).
    Invalid output rows must be +0.0 exactly; the rest within K6_TOL x
    max|plain| (both sum in float32, in another order, and round once).
    Every case must launch the kernel the wrapper's rule names; the bf16
    calls of the sweep with D=100, F=60 or an unaligned base are the ones
    it sends to the mma.sync kernel.  Returns the case count, the worst
    ratio err / max|plain| per dtype, and per kernel its case count and
    the (dtype, D, F, offsets) it took."""
    import torch
    from repro_torch.kernels import gather_matmul as gm

    gen = torch.Generator(device=device).manual_seed(3)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    by_kernel: dict = {}
    cases = [(dtype, e, n, d, f, 0, 0)
             for dtype in (torch.float32, torch.bfloat16)
             for e in (1, 8, 64) for n in (8, 64, 128, 136, 256)
             for d in (100, 128, 2048) for f in (72, 1024)]
    cases += [(torch.bfloat16, 8, 64, 128, 60, 0, 0),
              (torch.bfloat16, 8, 128, 2048, 1024, 1, 0),
              (torch.bfloat16, 8, 64, 128, 1024, 0, 4),
              # Moonshot's gate/up at its served prefill: F = 1408, 11 tiles
              (torch.bfloat16, 64, 64, 2048, 1408, 0, 0)]
    for dtype, e, n, d, f, sx, sw in cases:
        ratio, counter = k6_case(gm, gen, device, dtype, e, n, d, f, sx, sw)
        name = str(dtype).split(".")[-1]
        worst[name] = max(worst[name], ratio)
        k = by_kernel.setdefault(counter, {"cases": 0, "took": set()})
        k["cases"] += 1
        k["took"].add(f"{name} D{d} F{f} x+{sx} w+{sw}")
    for k in by_kernel.values():
        k["took"] = sorted(k["took"])
    return {"cases": len(cases), "worst_err_over_max_plain": worst,
            "by_kernel": by_kernel}


def k6_serve_inputs(params, device, rows_per_expert, e_loc=8, d=2048,
                    slot="slot0"):
    """K6's inputs at a serve shape on EP 8 (defaults: a 64-expert model,
    OLMoE or Moonshot; Jamba passes its 2 experts per rank, D 4096 and its
    first MoE slot): the receive buffer ``[8*8*e_loc*ck, d]`` (random
    bf16), the MoE layer's own row table and mask for that chunk geometry,
    and the slot's first layer's gate weights."""
    import torch
    from repro_torch.models import moe

    ep = 8
    ck = rows_per_expert // ep
    idx, valid = moe._ffn_tables(ep, e_loc, ck, device)
    gen = torch.Generator(device=device).manual_seed(4)
    x = torch.randn((ep * ep * e_loc * ck, d), generator=gen,
                    device=device).to(torch.bfloat16)
    return x, idx, valid, params[slot]["moe"]["w_gate"][0]


def k6_bound(x, idx, valid, w) -> tuple[float, str, int, int]:
    """Least time for K6's work on these inputs: every referenced x row,
    the index and mask, w of every expert with a valid row, and the output,
    each moved once, against 2*D*F operations per valid row."""
    import torch
    e, n = idx.shape
    d, f, b = x.shape[1], w.shape[2], x.element_size()
    rows = int(torch.unique(idx[valid]).numel())
    live = int(valid.any(1).sum().item())
    nbytes = rows * d * b + 5 * e * n + live * d * f * b + e * n * f * b
    flops = 2 * int(valid.sum().item()) * d * f
    name = str(x.dtype).split(".")[-1]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def k6_readings(label, x, idx, valid, w, timed=True) -> dict:
    """K6 (the wgmma kernel, as the rule must name for these inputs) on
    one layer's inputs: kernel and the library composition (index_select +
    torch.bmm, exact here because every row of the serve tables is valid)
    each gated against the plain version within 8e-3 x max|plain|; with
    ``timed`` also the kernel's, plain version's and library's times, the
    host enqueue time (the tensor-map encode included) and the bound."""
    import dataclasses

    import torch
    from repro_torch.kernels import gather_matmul as gm

    if not bool(valid.all()):
        raise AssertionError(f"gather_matmul at {label}: the tables must be "
                             f"all valid")
    if gm.kernel_for(x, w) != "wgmma":
        raise AssertionError(f"gather_matmul at {label}: the rule names "
                             f"{gm.kernel_for(x, w)}, not wgmma")
    flat = idx.reshape(-1).long()

    def kern():
        return gm.gather_matmul_kernel(x, idx, valid, w)

    def plain():
        return gm.gather_matmul_plain(x, idx, valid, w)

    def library():
        return torch.bmm(x.index_select(0, flat).view(*idx.shape, -1), w)

    got, want = kern(), plain()
    err, ref = k6_error(got, want)
    lib_err, _ = k6_error(library(), got)
    tol = K6_TOL["bfloat16"] * ref
    # written so that a NaN anywhere fails: NaN <= tol is False
    if not (bool(torch.isfinite(got).all()) and err <= tol and lib_err <= tol):
        raise AssertionError(f"gather_matmul at {label}: {err}, library "
                             f"{lib_err} (max|plain| {ref}), finite "
                             f"{bool(torch.isfinite(got).all())}")
    out = {"shape": {"E": idx.shape[0], "N": idx.shape[1], "D": x.shape[1],
                     "F": w.shape[2], "R": x.shape[0], "dtype": "bfloat16"},
           "max_abs_err": err, "max_abs_plain": ref}
    if not timed:
        return out
    bound, bound_by, nbytes, flops = k6_bound(x, idx, valid, w)
    out.update({
        **device_ms(kern), "plain_ms": median_ms(plain),
        "library_ms": median_ms(library),
        "library_queued_ms": median_ms(library, queued=True),
        "enqueue_ms": median_enqueue_ms(kern),
        "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
        "flops": flops,
        "geometry": dataclasses.asdict(gm.wgmma_geometry(
            idx.shape[0], idx.shape[1], w.shape[2])),
    })
    return out


def time_gather_matmul(params, device) -> dict:
    """K6 at the prefill (N=128) and decode (N=64) shapes of the serve
    path (``k6_readings``), and the mma.sync design's times beside them."""
    out = {}
    for shape, n in (("prefill", 128), ("decode", 64)):
        out[shape] = k6_readings(shape, *k6_serve_inputs(params, device, n))
        out[shape]["mma_sync_design_ms"] = K6_MMA_SYNC_MS[shape]
    return out


def time_serve_exchange(plans) -> dict:
    """K2 (the fence exchange of the MoE dispatch and combine) at the serve
    path's prefill and decode shapes, on the backing plans' embedded
    epochs: the bucket kernel and the warp-per-row kernel gated against the
    plain version, their times, the plain version's, the bucket transpose
    as the library call, and the bound (every bucket row read and written
    once)."""
    import torch
    from repro_torch.kernels import a2a_fence

    out = {}
    for shape, plan in plans.items():
        a2a = plan.a2a
        p, cap = a2a.p, a2a.capacity
        gen = torch.Generator(device=a2a.mesh.device).manual_seed(5)
        x = torch.randn((p, p * cap, a2a.spec.feature_shape[0]), generator=gen,
                        device=a2a.mesh.device).to(a2a.dtype)
        check_fence(f"serve {shape}: a2a_fence", x, p, cap, want_rule="bulk")
        out[shape] = {
            "shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "kernel": k2_counter(a2a),
            "ms": median_ms(lambda: a2a_fence.rma_alltoallv_fence(x, p, cap)),
            "replaced_kernel_ms": median_ms(
                lambda: a2a_fence.fence_warp_kernel(x, p, cap)),
            "plain_ms": median_ms(lambda: a2a_fence.rma_alltoallv_fence_plain(x, p, cap)),
            "library_ms": median_ms(lambda: x.view(p, p, cap, -1).transpose(0, 1)
                                    .contiguous()),
            "bound_ms": bound_ms(2 * x.numel() * x.element_size()),
        }
    return out


def serve_forwards(eng, prompts, n_tokens):
    """Prefill and greedy decode of a decoder-only model through the
    engine's bundles (``family_forwards``): the last-position logits of
    every forward (float32, on the CPU), the tokens and the kept routing
    entries of every MoE call."""
    import torch
    tokens = torch.as_tensor(prompts, dtype=torch.int32, device=eng.device)
    return family_forwards(eng.cfg, eng.params, eng.prefill_bundle,
                           eng.decode_bundle, (tokens,), prompts.shape[1],
                           eng.max_seq, n_tokens)


def run_serve_path(device):
    """OLMoE-1B-7B at full width and depth (16 layers, bf16, weights from a
    seeded generator on the card) served through ``ServeEngine.generate`` on
    ``VirtualMesh((1, 8))``: EP 8, 8 experts per rank, persistent fence
    dispatch.  The kernel counters are zeroed just before and read just
    after; every forward must launch exactly 32 K6 (its wgmma kernel) and
    32 K2 kernels and no other kernel (the mma.sync K6 included) or plain
    version."""
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.serve import ServeEngine

    cfg = get("olmoe-1b-7b")
    b, s, n = SERVE["batch"], SERVE["prompt"], SERVE["tokens"]
    mesh = VirtualMesh(SERVE["mesh"], ("data", "model"))
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, mesh, batch=b, prompt_len=s, max_seq=s + n + 8, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    eng.generate(prompts, 2)                                   # warm-up
    _build.reset_counts()
    toks, stats = eng.generate(prompts, n)
    counts = _build.counts()
    forwards = n                                # one prefill + n-1 decode steps
    per_kernel = {k: v["launches"] for k, v in counts.items()}
    want = {k: 0 for k in per_kernel}
    want["gather_matmul_wgmma"] = want[k2_counter(eng.moe_plan.a2a)] = (
        2 * cfg.n_layers * forwards)
    plain = {k: v["plain_calls"] for k, v in counts.items() if v["plain_calls"]}
    if per_kernel != want or plain:
        raise AssertionError(f"serve path: launches {per_kernel}, want {want}; "
                             f"plain versions called {plain}")
    if toks.shape != (b, n) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"serve path: tokens {toks.shape} out of range")
    # argmax of NaN logits is still in range, so read the bf16 logits of a
    # prefill and a decode step too (after the counted run: not counted)
    logits, _, _ = serve_forwards(eng, prompts, 2)
    if not all(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()) for lg in logits):
        raise AssertionError("serve path: non-finite bf16 logits")
    plan = eng.moe_plan
    total_s = stats.prefill_seconds + (n - 1) * stats.decode_seconds_per_token
    result = {
        "config": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
        "mesh": list(SERVE["mesh"]), "batch": b, "prompt": s, "new_tokens": n,
        "init_seconds": init_s,
        "prefill_ms": stats.prefill_seconds * 1e3,
        "decode_ms_per_token": stats.decode_seconds_per_token * 1e3,
        "decode_tokens_per_s": b / stats.decode_seconds_per_token,
        "tokens_per_s": b * n / total_s,
        "launches_per_forward": {k: v // forwards for k, v in per_kernel.items()},
        "decode_plan": {"ep": plan.ep_size, "t_loc": plan.tokens_per_shard,
                        "capacity": plan.capacity,
                        "prefill_capacity": eng.prefill_bundle.moe_plan.capacity},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    # One decode step timed with CUDA events (median of 10, 2 steps each):
    # with the host pacing the card this is the step's wall time on the
    # stream, the denominator of the kernels' shares in PERF.md.
    cache_len = s + n + 8
    caches = [{k: torch.zeros((cfg.n_layers, b, cache_len, cfg.n_kv_heads,
                               cfg.head_dim), dtype=torch.bfloat16, device=device)
               for k in ("k", "v")}]
    tok = torch.zeros((b, 1), dtype=torch.int32, device=device)
    with torch.no_grad():
        result["decode_step_event_ms"] = median_ms(
            lambda: eng.decode_bundle(eng.params, caches, tok, s), iters=10,
            inner=2)
    return eng, result, per_kernel


def run_serve_vs_cpu(device, arch="olmoe-1b-7b") -> dict:
    """``arch`` (OLMoE; OLMo-1B in phase 12) at full width, depth 2,
    float32, the same weights on the card and on the CPU (where every
    kernel takes its plain version): prefill and decode logits within 1e-3
    x max|logit|, equal greedy tokens and equal kept routing entries per
    MoE call.  TF32 is off for float32 products and convolutions on the
    card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get(arch), n_layers=VS_CPU["layers"],
                              param_dtype="float32")
    b, s, n = VS_CPU["batch"], VS_CPU["prompt"], VS_CPU["tokens"]
    params, _ = api.init_model(cfg, torch.Generator(device=device).manual_seed(1),
                               device)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        mesh = VirtualMesh(SERVE["mesh"], ("data", "model"),
                           device=None if dev == "cuda" else "cpu")
        eng = ServeEngine(cfg, mesh, batch=b, prompt_len=s, max_seq=s + n,
                          params=params)
        runs[dev] = serve_forwards(eng, prompts, n)
        del eng
    (lg_g, tok_g, kept_g), (lg_c, tok_c, kept_c) = runs["cuda"], runs["cpu"]
    errs = []
    for i, (a, c) in enumerate(zip(lg_g, lg_c)):
        # the real vocabulary only: padded ids hold the -1e9 mask
        a, c = a[:, :cfg.vocab_size], c[:, :cfg.vocab_size]
        err, ref = float((a - c).abs().max()), float(c.abs().max())
        errs.append(err / ref)
        if not err <= 1e-3 * ref:
            raise AssertionError(f"serve vs CPU: forward {i} logits differ by {err} "
                                 f"(max|logit| {ref})")
    if not np.array_equal(tok_g, tok_c) or kept_g != kept_c:
        raise AssertionError(f"serve vs CPU: tokens {tok_g.tolist()} vs "
                             f"{tok_c.tolist()}, kept {kept_g} vs {kept_c}")
    return {"config": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
            "batch": b, "prompt": s, "tokens": n, "tf32": False,
            "max_err_over_max_logit": max(errs),
            "kept_per_moe_call": kept_g, "greedy_tokens_equal": True}


# ---------------------------------------------------------------------------
# Slice 7: the ragged variant, the allgatherv and reduce-scatter families,
# and the wire codecs
# ---------------------------------------------------------------------------

# Config G: the widest row of benchmarks/collective_sweep.py (2048 f32, 8
# KiB) on its ragged_counts(8, seed=5) x 16: one hot rank, up to ~1.8k rows.
G = {"p": 8, "feature": 2048, "scale": 16, "hier_mesh": (2, 4)}
PATTERN_RUNS = (("allgatherv", "fence"), ("allgatherv", "lock"),
                ("allgatherv", "fence_hierarchy"), ("reduce_scatter", "fence"),
                ("reduce_scatter", "lock"))
CODECS = ("bf16", "int8", "fp8")
CODEC_RUNS = (("fence", "jnp"), ("fence", "pallas"), ("fence", "fused"),
              ("lock", "pallas"), ("fence_hierarchy", "fused"))
CODEC_HIER_MESH = {"A": (2, 4), "B": (8, 8)}
RAGGED_SENTINEL = -1234.5
# serve_codec: OLMoE-1B-7B's MoE dispatch under int8, tolerance as declared
# by the codec (0.5/127 of each row's max).
SERVE_CODEC = {"codec": "int8", "codec_tol": 0.5 / 127, "tokens": 5}


def epoch_times(plan, x) -> dict:
    """``device_ms``, ``queued_ms`` and ``enqueue_ms`` of ``plan.start(x)``."""
    return {"device_ms": median_ms(lambda: plan.start(x)),
            "queued_ms": median_ms(lambda: plan.start(x), queued=True),
            "enqueue_ms": median_enqueue_ms(lambda: plan.start(x))}


def run_ragged_path(configs, plans, device):
    """The ragged plan at A and B: valid rows bit-equal to the oracle and to
    the fence x fused plan, rows past each rank's recv count keeping the
    sentinel the slot was filled with, one ``gather_rows_runs`` launch per
    epoch and nothing else; K1 on the ragged run table bytes-equal to its
    plain version over the whole window (untouched rows included).  Counters
    zeroed before the path, read after it."""
    import torch
    from repro_torch.core import PlanCache, alltoallv_init
    from repro_torch.kernels import _build, gather_rows
    from repro_torch.launch.mesh import VirtualMesh

    fused_out = {}
    for cfg in configs:
        fused = plans[f"{cfg['name']}:fencexfused"][0]
        fused_out[cfg["name"]] = fused.wait(fused.start(cfg["x"])).clone()
    _build.reset_counts()
    ragged = {}
    for cfg in configs:
        label = f"{cfg['name']}:ragged"
        plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32",
                              VirtualMesh((cfg["p"],), ("x",)), axis="x",
                              variant="ragged", cache=PlanCache())
        plan.compile()
        win = plan.window.materialize(plan.global_recv_shape, device)
        win.fill_(RAGGED_SENTINEL)
        out, ran = counted(lambda: plan.wait(plan.start(cfg["x"])))
        if ran != {gather_rows.RUNS.name: 1}:
            raise AssertionError(f"{label}: launches {ran}, want one "
                                 "gather_rows_runs")
        check_against_oracle(label, out, cfg)
        valid_rows_equal(label, out, fused_out[cfg["name"]], cfg)
        got = out.view(cfg["p"], cfg["recv_rows"], FEATURE)
        for r in range(cfg["p"]):
            if not bool((got[r, int(cfg["rc"][r].sum()):]
                         == RAGGED_SENTINEL).all()):
                raise AssertionError(f"{label}: rank {r} lost stale rows")
        ragged[label] = (plan, cfg)
    launches = path_launches("ragged path", [p for p, _ in ragged.values()])
    cases = 0
    for label, (plan, cfg) in ragged.items():
        idx, valid = plan._tables
        xf = cfg["x"].view(1, -1, FEATURE)
        stale = torch.full((1, plan.p * plan.recv_rows, FEATURE),
                           RAGGED_SENTINEL, device=device)
        cases += check_gather(f"{label}: gather_rows ragged write-through", xf,
                              idx, valid, plan.run_tables["ragged"],
                              window=stale, want_rule="runs")
    return ragged, launches, cases


def ragged_payload_bytes(plan) -> int:
    """Every valid row read once and written once, plus the run table."""
    table = plan.run_tables["ragged"].chunks
    return (2 * int(plan.send_counts.sum()) * plan.row_bytes
            + table.numel() * table.element_size())


def time_ragged(ragged, plans) -> dict:
    out = {}
    for label, (plan, cfg) in ragged.items():
        fused = plans[f"{cfg['name']}:fencexfused"][0]
        x = cfg["x"]
        out[label] = {**epoch_times(plan, x),
                      "payload_bound_ms": bound_ms(ragged_payload_bytes(plan)),
                      "run_table_chunks": int(plan.run_tables["ragged"]
                                              .chunks.shape[0]),
                      "init_host_seconds": plan.init_host_seconds,
                      "init_compile_seconds": plan.init_compile_seconds,
                      "init_run_table_seconds": plan.init_run_table_seconds,
                      "fence_x_fused": {**epoch_times(fused, x),
                                        "payload_bound_ms": bound_ms(
                                            payload_bytes(fused))}}
    return out


def run_patterns_path(device) -> tuple[dict, dict]:
    """Config G through ``allgatherv_init`` and ``reduce_scatter_init``:
    every plan bit-equal to its pattern's numpy reference on integer-valued
    float32 rows (the sums are exact); the reduce-scatter fence epoch one
    K2 launch, the other epochs none (plain tensor ops).  Counters zeroed
    before, read after; device and enqueue times of each plan."""
    import numpy as np
    import torch
    from repro_torch.core import (PlanCache, allgatherv_init, patterns,
                                  reduce_scatter_init)
    from repro_torch.kernels import _build, a2a_fence
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.testing.patterns import ragged_counts

    counts = ragged_counts(G["p"], seed=5) * G["scale"]
    f = G["feature"]
    inits = {"allgatherv": allgatherv_init, "reduce_scatter": reduce_scatter_init}
    _build.reset_counts()
    runs = {}
    for k, (coll, variant) in enumerate(PATTERN_RUNS):
        label = f"G:{coll}x{variant}"
        if variant == "fence_hierarchy":
            mesh, axis = VirtualMesh(G["hier_mesh"], ("o", "i")), ("o", "i")
        else:
            mesh, axis = VirtualMesh((G["p"],), ("x",)), "x"
        plan = inits[coll](counts, (f,), "float32", mesh, axis=axis,
                           variant=variant, cache=PlanCache())
        gen = torch.Generator(device=device).manual_seed(20 + k)
        x = torch.randint(-64, 64, (plan.p * plan.send_rows, f), generator=gen,
                          device=device).float()
        out, ran = counted(lambda: plan.wait(plan.start(x)))
        # the reduce-scatter fence epoch: one K2 launch, of the kernel its
        # plan names; the other plans launch nothing
        want_ran = {k.name: 1 for k in plan.kernels()}
        if len(want_ran) != ((coll, variant) == ("reduce_scatter", "fence")):
            raise AssertionError(f"{label}: plan kernels {want_ran}")
        if ran != want_ran:
            raise AssertionError(f"{label}: launches {ran}, want {want_ran}")
        ref = patterns.get(coll).reference(
            x.view(plan.p, plan.send_rows, f).cpu().numpy(), counts,
            plan.recv_rows)
        valid = torch.from_numpy(plan.index_tables.unpack_valid).to(device)
        got = out.view(plan.p, plan.recv_rows, f)[valid]
        expect_same(f"{label} vs reference", got,
                    torch.from_numpy(ref).to(device)[valid])
        runs[label] = (plan, x)
    launches = path_launches("patterns path", [p for p, _ in runs.values()])
    times = {}
    for label, (plan, x) in runs.items():
        rows = int(plan.index_tables.unpack_valid.sum())
        times[label] = {**epoch_times(plan, x), "recv_rows_valid": rows,
                        "send_rows": plan.send_rows, "recv_rows": plan.recv_rows,
                        "kernels": [kk.name for kk in plan.kernels()]}
    return {"counts": counts.tolist(), "row_bytes": 4 * f, "plans": times}, \
        launches


def codec_oracle(cfg, codec, device) -> dict:
    """``cfg`` with its oracle recomputed on ``decode(encode(x))`` by the
    port's codec on the card (the exchanges move bytes exactly and encode
    works per row, so a codec'd plan's valid rows must equal it)."""
    import numpy as np
    from repro_torch.core import reference
    from repro_torch.parallel import wirecodec

    c = wirecodec.get(codec)
    dec = c.decode(*c.encode(cfg["x"]), cfg["x"].dtype)
    bufs = dec.view(cfg["p"], cfg["send_rows"], FEATURE).cpu().numpy()
    return {**cfg, "expect": reference.alltoallv_global(
        bufs, cfg["counts"], cfg["recv_rows"])}


def run_codec_path(configs, device) -> tuple[dict, dict, dict]:
    """Every codec of ``CODECS`` over ``CODEC_RUNS`` at A and B (the
    hierarchy on (2, 4) at A, (8, 8) at B): valid rows bit-equal to the
    oracle of ``decode(encode(x))``, every kernel the plan names launched
    and no plain version.  Device time beside the identity plan's, the wire
    bytes.  Counters zeroed before, read after.  Returns the times, the
    launches and the plans, by label."""
    from repro_torch.core import PlanCache, alltoallv_init
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh

    def build(cfg, variant, impl, codec):
        if variant == "fence_hierarchy":
            mesh = VirtualMesh(CODEC_HIER_MESH[cfg["name"]], ("o", "i"))
            axis = ("o", "i")
        else:
            mesh, axis = VirtualMesh((cfg["p"],), ("x",)), "x"
        return alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                              axis=axis, variant=variant, pack_impl=impl,
                              codec=codec, error_tol=0.1, cache=PlanCache())

    _build.reset_counts()
    coded = {}
    for cfg in configs:
        for codec in CODECS:
            ocfg = codec_oracle(cfg, codec, device)
            for variant, impl in CODEC_RUNS:
                label = f"{cfg['name']}:{variant}x{impl}@{codec}"
                plan = build(cfg, variant, impl, codec)
                check_against_oracle(label, plan.wait(plan.start(cfg["x"])),
                                     ocfg)
                coded[label] = (plan, cfg)
    launches = path_launches("codec path", [p for p, _ in coded.values()])
    times = {}
    for cfg in configs:
        for variant, impl in CODEC_RUNS:
            ident = build(cfg, variant, impl, "identity")
            check_against_oracle(f"{cfg['name']}:{variant}x{impl}", ident.wait(
                ident.start(cfg["x"])), cfg)
            base = epoch_times(ident, cfg["x"])
            for codec in CODECS:
                label = f"{cfg['name']}:{variant}x{impl}@{codec}"
                plan = coded[label][0]
                side = 4 if plan._side_channel else 0
                valid = int(plan.send_counts.sum())
                times[label] = {
                    **epoch_times(plan, cfg["x"]),
                    "identity_device_ms": base["device_ms"],
                    "identity_queued_ms": base["queued_ms"],
                    "wire_row_bytes": plan.wire_row_bytes,
                    "scale_side_channel_bytes_per_row": side,
                    "payload_wire_bytes": valid * (plan.wire_row_bytes + side),
                    "payload_identity_bytes": valid * plan.row_bytes,
                    "kernels": [k.name for k in plan.kernels()]}
    return times, launches, coded


def time_codec_passes(plan, cfg) -> dict:
    """Each pass of one codec'd ``fence x pallas`` epoch on its own (CUDA
    events, median of 20), beside the pass's bound: the encode, K1's pack
    and K2's exchange of the wire rows, the scale side channel (reference
    pack, K2 on 4-byte rows, reference unpack), K1's zeroing unpack, the
    decode and the window write-through."""
    import torch
    from repro_torch.core import variants
    from repro_torch.core.plan import _write_through
    from repro_torch.kernels import a2a_fence, gather_rows

    p, cap, c = plan.p, plan.capacity, plan.codec
    s, r = cfg["send_rows"], cfg["recv_rows"]
    src, valid, rsrc, rvalid = plan.compile()._tables
    runs = plan.run_tables
    xr = cfg["x"].view(p * s, FEATURE)
    wire, scales = c.encode(xr)
    wire, scales = wire.view(p, s, FEATURE), scales.view(p, s, 1)
    packed = gather_rows.gather_rows(wire, src, valid, runs=runs["pack"])
    buckets = a2a_fence.rma_alltoallv_fence(packed, p, cap)
    sc_packed = variants.pack_rows(scales, src, valid)
    sc_buckets = a2a_fence.rma_alltoallv_fence(sc_packed, p, cap)
    out = gather_rows.gather_rows(buckets, rsrc, rvalid, runs=runs["unpack"])
    sc_out = variants.unpack_rows(sc_buckets, rsrc, rvalid)
    dec = c.decode(out.view(p * r, FEATURE), sc_out.view(p * r, 1),
                   torch.float32).view(p, r, FEATURE)
    win = torch.zeros_like(dec)
    n_send, n_pad, n_recv = p * s, p * p * cap, p * r
    wb, nv = plan.wire_row_bytes, int(plan.send_counts.sum())
    passes = {
        "encode": (lambda: c.encode(xr),
                   n_send * (plan.row_bytes + wb + 4)),
        "pack (K1)": (lambda: gather_rows.gather_rows(wire, src, valid,
                                                      runs=runs["pack"]),
                      (nv + n_pad) * wb),
        "fence (K2)": (lambda: a2a_fence.rma_alltoallv_fence(packed, p, cap),
                       2 * n_pad * wb),
        "scale pack (pack_rows)": (
            lambda: variants.pack_rows(scales, src, valid), (nv + n_pad) * 4),
        "scale fence (K2, 4-byte rows)": (
            lambda: a2a_fence.rma_alltoallv_fence(sc_packed, p, cap),
            2 * n_pad * 4),
        "scale unpack (unpack_rows)": (
            lambda: variants.unpack_rows(sc_buckets, rsrc, rvalid),
            (nv + n_recv) * 4),
        "unpack (K1, zeroing)": (
            lambda: gather_rows.gather_rows(buckets, rsrc, rvalid,
                                            runs=runs["unpack"]),
            (nv + n_recv) * wb),
        "decode": (lambda: c.decode(out.view(p * r, FEATURE),
                                    sc_out.view(p * r, 1), torch.float32),
                   n_recv * (wb + 4 + plan.row_bytes)),
        "write-through (where + copy_)": (
            lambda: _write_through(win, dec, rvalid),
            2 * nv * plan.row_bytes),
    }
    return {name: {**device_ms(fn), "bound_ms": bound_ms(nbytes)}
            for name, (fn, nbytes) in passes.items()}


@contextlib.contextmanager
def plain_k2_k6():
    """Send the MoE layer's K2 and K6 calls to their plain versions on the
    card (the yardstick of ``serve_codec``'s gate)."""
    from repro_torch.kernels import a2a_fence, gather_matmul, ops

    saved = ops.rma_alltoallv_fence, ops.gather_matmul
    ops.rma_alltoallv_fence = a2a_fence.rma_alltoallv_fence_plain
    ops.gather_matmul = gather_matmul.gather_matmul_plain
    try:
        yield
    finally:
        ops.rma_alltoallv_fence, ops.gather_matmul = saved


def run_serve_codec(eng, device) -> tuple[dict, dict]:
    """OLMoE-1B-7B (config S) with the MoE dispatch under int8 wire rows, on
    the serve path's seeded weights: layer 0's MoE output through K2 and K6
    must equal the same layer with their plain versions on the card within
    K6's bf16 tolerance; then 1 prefill and 4 decode tokens (counters zeroed
    before, read after: 32 K2 and 32 wgmma K6 per forward, nothing else),
    prefill and decode ms, and the largest |logit difference| against the
    identity-codec engine (reported, not gated)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import moe, transformer
    from repro_torch.parallel.sharding import axis_rules
    from repro_torch.serve import ServeEngine

    base = eng.cfg
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, wire_codec=SERVE_CODEC["codec"],
        codec_tol=SERVE_CODEC["codec_tol"]))
    b, s, n = SERVE["batch"], SERVE["prompt"], SERVE_CODEC["tokens"]
    cod = ServeEngine(cfg, eng.mesh, batch=b, prompt_len=s, max_seq=eng.max_seq,
                      params=eng.params)
    plan = cod.prefill_bundle.moe_plan
    layer0 = transformer._index_tree(cod.params["slot0"], 0)["moe"]
    gen = torch.Generator(device=device).manual_seed(9)
    h = torch.randn((b, s, cfg.d_model), generator=gen, device=device).to(
        torch.bfloat16)
    with torch.no_grad(), axis_rules(cod.prefill_bundle.rules, cod.mesh):
        y, ran = counted(lambda: moe.apply_moe(layer0, h, cfg.moe, plan)[0])
        with plain_k2_k6():
            y_plain, ran_plain = counted(
                lambda: moe.apply_moe(layer0, h, cfg.moe, plan)[0])
    k2 = k2_counter(plan.a2a)
    want = {k2: 2, "gather_matmul_wgmma": 2}
    if ran != want or ran_plain:
        raise AssertionError(f"serve_codec layer 0: launches {ran} (want "
                             f"{want}), plain run launched {ran_plain}")
    err = float((y.float() - y_plain.float()).abs().max())
    ref = float(y_plain.float().abs().max())
    if not err <= K6_TOL["bfloat16"] * ref:
        raise AssertionError(f"serve_codec layer 0: |y - y_plain| {err} over "
                             f"{K6_TOL['bfloat16']} x {ref}")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (b, s)).astype(np.int32)
    cod.generate(prompts, 2)                                  # warm-up
    _build.reset_counts()
    toks, stats = cod.generate(prompts, n)
    counts = _build.counts()
    per_kernel = {k: v["launches"] for k, v in counts.items() if v["launches"]}
    want = {k2: 2 * cfg.n_layers * n,
            "gather_matmul_wgmma": 2 * cfg.n_layers * n}
    plain = {k: v["plain_calls"] for k, v in counts.items() if v["plain_calls"]}
    if per_kernel != want or plain:
        raise AssertionError(f"serve_codec: launches {per_kernel}, want {want}; "
                             f"plain versions called {plain}")
    lg_c, tok_c, _ = serve_forwards(cod, prompts, n)
    lg_i, tok_i, _ = serve_forwards(eng, prompts, n)
    v = cfg.vocab_size
    if not all(bool(torch.isfinite(lg[:, :v]).all()) for lg in lg_c):
        raise AssertionError("serve_codec: non-finite logits")
    dlogit = [float((a[:, :v] - c[:, :v]).abs().max()) for a, c in zip(lg_c, lg_i)]
    a2a = plan.a2a
    result = {
        "config": cfg.name, "codec": SERVE_CODEC["codec"],
        "codec_tol": SERVE_CODEC["codec_tol"], "batch": b, "prompt": s,
        "new_tokens": n, "layer0_max_abs_err": err, "layer0_max_abs_plain": ref,
        "layer0_tolerance": f"{K6_TOL['bfloat16']} x max|plain|",
        "prefill_ms": stats.prefill_seconds * 1e3,
        "decode_ms_per_token": stats.decode_seconds_per_token * 1e3,
        "launches_per_forward": {k: c // n for k, c in per_kernel.items()},
        "wire_row": {"features": list(a2a.spec.feature_shape),
                     "dtype": str(a2a.dtype).split(".")[-1],
                     "bytes": a2a.row_bytes},
        "max_abs_dlogit_vs_identity": max(dlogit),
        "max_abs_dlogit_per_forward": dlogit,
        "max_abs_logit_identity": max(float(lg[:, :v].abs().max()) for lg in lg_i),
        "greedy_tokens_equal_identity": bool(np.array_equal(tok_c, tok_i)),
    }
    del cod
    return result, per_kernel


# ---------------------------------------------------------------------------
# Slice 8: variant="auto", the break-even model and the observability layer
# ---------------------------------------------------------------------------

# (config, mesh shape, axis names, exchange axis) of each auto sweep.
AUTO_SWEEPS = (("A", (8,), ("x",), "x"), ("B", (64,), ("x",), "x"),
               ("B", (8, 8), ("o", "i"), ("o", "i")))
AUTO_CODEC_TOL = 0.5 / 127          # admits int8 and bf16, not fp8
# (variant, pack_impl) of each plan held against the non-persistent fence.
BREAKEVEN_RUNS = (("fence", "fused"), ("lock", "pallas"), ("ragged", "jnp"))
# Rows of 256 f32 per pair at P=8, dense: 1 KiB to 1 MiB messages.
SIZE_SWEEP_ROWS = (1, 4, 32, 256, 1024)
OBS_EPOCHS = 20


def auto_label(name, shape) -> str:
    return f"{name}:auto{'x'.join(map(str, shape))}"


def check_auto_output(label, plan, cfg, device) -> None:
    """The winner's epoch against the oracle (of ``decode(encode(x))`` when
    a codec arm won), valid rows bit-equal."""
    want = cfg if plan.spec.codec == "identity" else codec_oracle(
        cfg, plan.spec.codec, device)
    check_against_oracle(label, plan.wait(plan.start(cfg["x"])), want)


def sweep_row(plan, before, seconds) -> dict:
    from repro_torch.core import INIT_STATS

    after = INIT_STATS.as_dict()
    choice = plan.auto_choice
    return {"arm_ms": {a: t * 1e3 for a, t in choice["times"].items()},
            "winner": f"{choice['variant']}@{choice['codec']}",
            "pack_impl": plan.spec.pack_impl,
            "n_amortize": choice["breakeven"]["n_amortize"],
            "sweep_seconds": choice["breakeven"]["sweep_seconds"],
            "init_seconds": seconds,
            "init_stats_delta": {k: after[k] - before[k] for k in (
                "autotune_sweeps", "autotune_bursts", "cold_inits")}}


def free_except(cache, keep) -> None:
    """FREE every plan of ``cache`` but ``keep`` (the sweeps' losers)."""
    for plan in cache._plans.values():
        if all(plan is not k for k in keep):
            plan.free()


def run_autotune_path(configs, device):
    """``alltoallv_init(..., variant="auto", pack_impl="fused")`` at A on
    (8,), B on (64,) and B on (8, 8): the winner's valid rows bit-equal to
    the oracle, a second INIT of the pattern on the same cache runs no
    sweep, ``embeddable=True`` never picks ragged; one B sweep with the
    ``variant@codec`` arms an error_tol of 0.5/127 admits; the MoE dispatch
    of OLMoE-1B-7B at the serve path's prefill shape with
    ``a2a_variant="auto"``, its embedded exchange bit-equal to the fence
    layer's on the same rows.  Counters zeroed before, read after."""
    import dataclasses
    import torch
    from repro_torch.configs import get
    from repro_torch.core import INIT_STATS, PlanCache, alltoallv_init
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

    by_name = {c["name"]: c for c in configs}
    sweeps, swept = {}, []
    _build.reset_counts()

    def auto(cfg, mesh, axis, cache, **kw):
        before, t0 = INIT_STATS.as_dict(), time.perf_counter()
        plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                              axis=axis, variant="auto", pack_impl="fused",
                              cache=cache, **kw)
        return plan, sweep_row(plan, before, time.perf_counter() - t0)

    for name, shape, axes, axis in AUTO_SWEEPS:
        cfg, label = by_name[name], auto_label(name, shape)
        mesh, cache = VirtualMesh(shape, axes), PlanCache()
        plan, row = auto(cfg, mesh, axis, cache)
        check_auto_output(label, plan, cfg, device)
        sweeps_now = INIT_STATS.autotune_sweeps
        again, _ = auto(cfg, mesh, axis, cache)
        if again is not plan or INIT_STATS.autotune_sweeps != sweeps_now:
            raise AssertionError(f"{label}: a second INIT swept again")
        keep = [plan]
        if len(axes) == 1:
            emb, row["embeddable"] = auto(cfg, mesh, axis, cache,
                                          embeddable=True)
            if emb.spec.variant == "ragged":
                raise AssertionError(f"{label}: embeddable picked ragged")
            check_auto_output(label + ":embeddable", emb, cfg, device)
            keep.append(emb)
        sweeps[label] = row
        swept += list(cache._plans.values())
        free_except(cache, keep)
    # The codec arms' 4-byte scale rows take K4's step kernel by its rule:
    # the identity sweeps alone must launch no replaced kernel.
    no_replaced_kernels("autotune path", {k: v["launches"] for k, v in
                                          _build.counts().items()})

    cfg, cache = by_name["B"], PlanCache()
    plan, row = auto(cfg, VirtualMesh((64,), ("x",)), "x", cache,
                     error_tol=AUTO_CODEC_TOL)
    check_auto_output("B:auto64@codecs", plan, cfg, device)
    row["codec_fits"] = plan.auto_choice["codec_fits"]
    row["error_tol"] = AUTO_CODEC_TOL
    sweeps["B:auto64@codecs"] = row
    swept += list(cache._plans.values())
    free_except(cache, [plan])

    ocfg = get("olmoe-1b-7b")
    mesh = VirtualMesh(SERVE["mesh"], ("data", "model"))
    n_tokens = SERVE["batch"] * SERVE["prompt"]
    layers = {}
    with axis_rules(DEFAULT_RULES, mesh):
        for variant in ("fence", "auto"):
            cache = PlanCache()
            before, t0 = INIT_STATS.as_dict(), time.perf_counter()
            layers[variant] = moe.MoEDispatchPlan.build(
                dataclasses.replace(ocfg.moe, a2a_variant=variant), n_tokens,
                mesh, d_model=ocfg.d_model, dtype=torch.bfloat16, cache=cache)
            seconds = time.perf_counter() - t0
            swept += list(cache._plans.values())
    a2a = layers["auto"].a2a
    if layers["auto"].variant != a2a.auto_choice["variant"] or \
            a2a.auto_choice["variant"] == "ragged":
        raise AssertionError(f"MoE auto resolved to {layers['auto'].variant}")
    gen = torch.Generator(device=device).manual_seed(8)
    rows = torch.randn(a2a.global_send_shape, generator=gen,
                       device=device).to(a2a.dtype)
    expect_same("S: MoE auto embedded exchange", a2a.embed()(rows),
                layers["fence"].a2a.embed()(rows))
    sweeps["S:moe_prefill_auto"] = {
        **sweep_row(a2a, before, seconds), "layer_variant":
        layers["auto"].variant, "send_shape": list(a2a.global_send_shape),
        "dtype": "bfloat16"}
    return sweeps, path_launches("autotune path", swept)


def run_breakeven_path(configs, device):
    """``breakeven.measure`` of fence x fused, lock x pallas and ragged
    against the non-persistent fence (``core.baseline``) at A and B, with
    t_init = ``init_host_seconds`` + ``init_compile_seconds`` of a cold
    INIT; then fence x fused over 1 KiB to 1 MiB messages at P=8, dense.
    Every plan and baseline output bit-equal to the oracle on valid rows.
    Counters zeroed before, read after."""
    import numpy as np
    import torch
    from repro_torch.core import PlanCache, alltoallv_init, breakeven
    from repro_torch.core.baseline import make_nonpersistent
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh

    def measure(cfg, variant, pack_impl):
        p, mesh = cfg["p"], VirtualMesh((cfg["p"],), ("x",))
        plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                              axis="x", variant=variant, pack_impl=pack_impl,
                              cache=PlanCache()).compile()
        label = f"{cfg['name']}:{variant}x{pack_impl}"
        check_against_oracle(label, plan.wait(plan.start(cfg["x"])), cfg)
        base = make_nonpersistent(
            mesh, axis="x", p=p, capacity=plan.capacity,
            send_rows=cfg["send_rows"], recv_rows=cfg["recv_rows"],
            feature_shape=(FEATURE,), dtype=torch.float32)
        cnts = torch.tensor(cfg["counts"].reshape(-1), dtype=torch.int32,
                            device=device)
        check_against_oracle(label + " baseline", base(cfg["x"], cnts), cfg)
        t_init = plan.init_host_seconds + plan.init_compile_seconds
        be = breakeven.measure(lambda: plan.start(cfg["x"]),
                               lambda: base(cfg["x"], cnts), t_init=t_init)
        row = {"init_host_seconds": plan.init_host_seconds,
               "init_compile_seconds": plan.init_compile_seconds,
               "t_init": t_init, "t_persist_ms": be.t_persist * 1e3,
               "t_mpi_ms": be.t_mpi * 1e3, "savings_pct": be.savings_pct,
               "n_breakeven": be.n_breakeven if math.isfinite(be.n_breakeven)
               else None}
        return plan, label, row

    _build.reset_counts()
    plans, out, sizes = [], {}, {}
    for cfg in configs:
        for variant, pack_impl in BREAKEVEN_RUNS:
            plan, label, out[label] = measure(cfg, variant, pack_impl)
            plans.append(plan)
    for rows in SIZE_SWEEP_ROWS:
        cfg = make_config(f"msg{rows}", np.full((8, 8), rows, np.int64),
                          device)
        plan, _, row = measure(cfg, "fence", "fused")
        sizes[f"{rows * FEATURE * 4 / 1024:g} KiB"] = row
        plans.append(plan)
    launches = path_launches("breakeven path", plans)
    no_replaced_kernels("breakeven path", launches)
    return out, sizes, launches


def run_obs_path(configs, device) -> dict:
    """With ``TRACER`` on: an A fence x fused INIT and 20 epochs, then one
    auto sweep whose winner runs 20 epochs timed start+wait and recorded
    through ``record_epoch``.  The Chrome trace must validate with init,
    init.bake or init.autotune, and execute spans; ``render_metrics()``
    must hold the auto plan's ``repro_breakeven_residual``.  Then the A
    epoch's host times with tracing off and on (off, on, on, off)."""
    import tempfile
    from repro_torch.core import EXEC_TELEMETRY, PlanCache, alltoallv_init
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.obs import (TRACER, check_breakeven, render_metrics,
                                 validate_trace, write_trace)

    cfg = next(c for c in configs if c["name"] == "A")
    x, mesh = cfg["x"], VirtualMesh((cfg["p"],), ("x",))
    # The earlier phases ran these plans' digests too (dispatch samples):
    # the rings read here hold this phase's epochs alone.
    EXEC_TELEMETRY.reset()
    TRACER.enable()
    try:
        plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                              axis="x", variant="fence", pack_impl="fused",
                              cache=PlanCache())
        for _ in range(OBS_EPOCHS):
            plan.wait(plan.start(x))
        auto = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                              axis="x", variant="auto", pack_impl="fused",
                              cache=PlanCache())
        auto.record_starts = False
        for _ in range(OBS_EPOCHS):
            t0 = time.perf_counter()
            auto.wait(auto.start(x))
            auto.record_epoch(time.perf_counter() - t0)
        snap = TRACER.snapshot()
    finally:
        TRACER.reset()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        n_events = len(write_trace(path, snap)["traceEvents"])
        summary = validate_trace(path, expect_cats=("init", "execute"))
    if not (summary["by_cat"].get("init.bake")
            or summary["by_cat"].get("init.autotune")):
        raise AssertionError(f"trace has no bake or autotune span: {summary}")
    digest = auto.signature.digest
    metrics = render_metrics()
    if f'repro_breakeven_residual{{digest="{digest}"}}' not in metrics:
        raise AssertionError("no repro_breakeven_residual for the auto plan")
    residual = next(r for r in check_breakeven() if r["digest"] == digest)

    def epoch():
        plan.wait(plan.start(x))

    def traced(on):
        if on:
            TRACER.enable()
        try:
            return {"epoch_host_ms": median_host_ms(epoch),
                    "enqueue_ms": median_enqueue_ms(lambda: plan.start(x))}
        finally:
            TRACER.reset()

    reads = [traced(on) for on in (False, True, True, False)]
    overhead = {state: {k: (reads[i][k] + reads[j][k]) / 2 for k in reads[i]}
                for state, (i, j) in (("off", (0, 3)), ("on", (1, 2)))}
    return {"trace_events": n_events, "spans_by_category": summary["by_cat"],
            "warm_inits": summary["warm_inits"],
            "cold_inits": summary["cold_inits"],
            "auto_winner": auto.spec.variant,
            "breakeven_residual": residual,
            "residual_measure": "start+wait host wall time through "
                                "record_epoch (record_starts off)",
            "dispatch_ring_p50_ms": plan.epoch_ring.summary()["p50_s"] * 1e3,
            "tracing": overhead}


# ---------------------------------------------------------------------------
# Slice 9: the persistent plan store, cold in this process, warm in a second
# ---------------------------------------------------------------------------

# (config, variant, pack_impl) of the flat plans INITed into the store.
PLANSTORE_FLAT = (("A", "fence", "fused"), ("A", "lock", "pallas"),
                  ("B", "fence", "fused"), ("B", "lock", "pallas"))
PLANSTORE_HIER = ("B", (8, 8), "fused")
PLANSTORE_TIMEOUT = 300             # seconds, per subprocess


def valid_rows_sha(plan, out) -> str:
    """sha256 of every rank's valid rows (those below its recv count),
    rank by rank, as raw bytes."""
    import hashlib
    import torch
    out = out.reshape((plan.p, plan.recv_rows) + plan.spec.feature_shape)
    h = hashlib.sha256()
    for r, n in enumerate(plan.recv_counts.sum(axis=1)):
        h.update(out[r, :int(n)].contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def planstore_epoch(entry, plan, by_name, device) -> dict:
    """Compile ``plan`` and run one epoch on its entry's input (the
    config's send buffer, or seeded bf16 rows for the MoE dispatch): the
    launches it made, the sha256 of its valid rows, checked against the
    oracle."""
    import numpy as np
    import torch
    from repro_torch.core import reference
    from repro_torch.kernels import _build
    spans = {}
    with span_ms(spans):
        plan.compile()
    cfg = by_name.get(entry["config"])
    if cfg is not None:
        x = cfg["x"]
    else:
        gen = torch.Generator(device=device).manual_seed(8)
        x = torch.randn(plan.global_send_shape, generator=gen,
                        device=device).to(plan.dtype)
    before = _build.counts()
    out = plan.wait(plan.start(x))
    launches = launches_since(before)
    if cfg is not None:
        check_against_oracle(entry["label"], out, cfg)
    else:
        sends = x.view(torch.int16).cpu().numpy().reshape(plan.p,
                                                          plan.send_rows, -1)
        want = reference.alltoallv_global(sends, plan.send_counts,
                                          plan.recv_rows)
        got = out.view(torch.int16).cpu().numpy().reshape(want.shape)
        for r, n in enumerate(plan.recv_counts.sum(axis=1)):
            if not np.array_equal(got[r, :n], want[r, :n]):
                raise AssertionError(f"{entry['label']}: rank {r} differs "
                                     "from the oracle")
    return {"launches": launches, "sha": valid_rows_sha(plan, out),
            "compile_spans_ms": spans,
            "init_compile_seconds": plan.init_compile_seconds,
            "init_run_table_seconds": plan.init_run_table_seconds}


@contextlib.contextmanager
def span_ms(totals):
    """Trace the block (``obs.spans.TRACER``) and add each span's
    milliseconds into ``totals`` by span name."""
    from repro_torch.obs import TRACER
    TRACER.enable()
    try:
        yield totals
    finally:
        for name, _, _, _, dur, _, _ in TRACER.snapshot()["records"]:
            totals[name] = totals.get(name, 0.0) + dur * 1e3
        TRACER.reset()


def planstore_row(entry, plan, call_seconds, stats) -> dict:
    """What one INIT cost and gave: its wall time, the plan's host,
    compile and run-table seconds, the INIT counters it moved."""
    row = {"label": entry["label"], "config": entry["config"],
           "variant": plan.spec.variant, "pack_impl": plan.spec.pack_impl,
           "digest": plan.signature.digest, "warm_loaded": plan.warm_loaded,
           "stores_tables": (plan.index_tables is not None
                             or plan.hier_schedule is not None),
           "init_call_seconds": call_seconds,
           "init_host_seconds": plan.init_host_seconds,
           "init_stats": stats}
    if plan.auto_choice is not None:
        row["auto"] = {"winner": plan.auto_choice["variant"],
                       "codec": plan.auto_choice.get("codec", "identity"),
                       "sweep_seconds":
                           plan.auto_choice["breakeven"]["sweep_seconds"]}
    return row


def init_ms(row) -> dict:
    return {m: row[f"init_{m}_seconds"] * 1e3
            for m in ("call", "host", "compile", "run_table")}


def planstore_t_init(row) -> float:
    """The INIT a process pays before its first epoch: the INIT call (store
    lookups and publishes included) and the compile."""
    return row["init_call_seconds"] + row["init_compile_seconds"]


def breakeven_terms(plan, cfg, device):
    """``breakeven.measure``'s t_persist and t_mpi of ``plan`` against the
    non-persistent fence on the config's send buffer (as ``run_breakeven_path``
    measures them)."""
    import torch
    from repro_torch.core import breakeven
    from repro_torch.core.baseline import make_nonpersistent
    base = make_nonpersistent(
        plan.mesh, axis="x", p=cfg["p"], capacity=plan.capacity,
        send_rows=cfg["send_rows"], recv_rows=cfg["recv_rows"],
        feature_shape=(FEATURE,), dtype=torch.float32)
    cnts = torch.tensor(cfg["counts"].reshape(-1), dtype=torch.int32,
                        device=device)
    check_against_oracle(f"{cfg['name']} baseline", base(cfg["x"], cnts), cfg)
    be = breakeven.measure(lambda: plan.start(cfg["x"]),
                           lambda: base(cfg["x"], cnts), t_init=0.0)
    return be.t_persist, be.t_mpi


def planstore_configs(device):
    import numpy as np
    from repro_torch.testing.patterns import hugetrace_like_counts
    return [make_config("A", np.full((8, 8), 1024, np.int64), device),
            make_config("B", hugetrace_like_counts(64, 64), device)]


def run_planstore_cold(configs, device, root):
    """INIT every plan of the phase through the public entry points, with
    ``capture_init_requests()`` on, a fresh ``PlanCache`` each and the
    store in ``root``: A and B fence x fused and lock x pallas, B's (8, 8)
    fused hierarchy, the A (8,), B (64,) and B (8, 8) auto sweeps and the
    OLMoE MoE dispatch's auto decision at the prefill shape; one epoch each.
    Returns the plans, their rows and the captured requests."""
    import dataclasses
    import torch
    from repro_torch.configs import get
    from repro_torch.core import (INIT_STATS, PlanCache, alltoallv_init,
                                  capture_init_requests)
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules
    from repro_torch.planstore import PlanStore

    by_name = {c["name"]: c for c in configs}
    store = PlanStore(root)
    inits = []                   # (entry, thunk) in request order
    for name, variant, pack_impl in PLANSTORE_FLAT:
        inits.append(({"label": f"{name}:{variant}x{pack_impl}",
                       "config": name},
                      lambda c=by_name[name], v=variant, i=pack_impl:
                      alltoallv_init(c["counts"], (FEATURE,), "float32",
                                     VirtualMesh((c["p"],), ("x",)),
                                     axis="x", variant=v, pack_impl=i,
                                     cache=PlanCache(), store=store)))
    name, mesh, impl = PLANSTORE_HIER
    inits.append(({"label": hier_label(by_name[name], mesh, impl),
                   "config": name},
                  lambda c=by_name[name], m=mesh, i=impl:
                  alltoallv_init(c["counts"], (FEATURE,), "float32",
                                 VirtualMesh(m, ("o", "i")), axis=("o", "i"),
                                 variant="fence_hierarchy", pack_impl=i,
                                 cache=PlanCache(), store=store)))
    for name, shape, axes, axis in AUTO_SWEEPS:
        inits.append(({"label": auto_label(name, shape), "config": name},
                      lambda c=by_name[name], s=shape, a=axes, x=axis:
                      alltoallv_init(c["counts"], (FEATURE,), "float32",
                                     VirtualMesh(s, a), axis=x,
                                     variant="auto", pack_impl="fused",
                                     cache=PlanCache(), store=store)))
    ocfg = get("olmoe-1b-7b")
    omesh = VirtualMesh(SERVE["mesh"], ("data", "model"))

    def moe_auto():
        with axis_rules(DEFAULT_RULES, omesh):
            return moe.MoEDispatchPlan.build(
                dataclasses.replace(ocfg.moe, a2a_variant="auto"),
                SERVE["batch"] * SERVE["prompt"], omesh,
                d_model=ocfg.d_model, dtype=torch.bfloat16,
                cache=PlanCache(), store=store).a2a
    inits.append(({"label": "S:moe_prefill_auto", "config": "S"}, moe_auto))

    plans, rows = [], []
    with capture_init_requests() as reqs:
        for entry, init in inits:
            before, spans = INIT_STATS.as_dict(), {}
            with span_ms(spans):
                t0 = time.perf_counter()
                plan = init()
                seconds = time.perf_counter() - t0
            after = INIT_STATS.as_dict()
            row = planstore_row(entry, plan, seconds,
                                {k: after[k] - before[k] for k in after})
            row["init_spans_ms"] = spans
            row.update(planstore_epoch(entry, plan, by_name, device))
            rows.append(row)
            plans.append(plan)
    if len(reqs) != len(rows):
        raise AssertionError(f"captured {len(reqs)} INIT requests for "
                             f"{len(rows)} INITs")
    return plans, rows, list(reqs)


def card():
    """The current CUDA device."""
    import torch
    return torch.device("cuda", torch.cuda.current_device())


def planstore_child(root, out_path) -> int:
    """The second process: load the kernels (as the first did at its build
    phase), then replay the captured requests against the store in
    ``root`` twice (``prewarm.init_from_request``, a fresh cache and store
    handle each; round 1 is the process's first INIT of each pattern,
    round 2 the same again), one epoch per plan, and the flat plans'
    t_persist and t_mpi; write the rows to ``out_path``.  Prints no
    result line."""
    import torch
    if not torch.cuda.is_available():
        return 1
    from repro_torch.core import INIT_STATS, PlanCache
    from repro_torch.kernels import _build
    from repro_torch.planstore import PlanStore, prewarm

    device = card()
    with open(os.path.join(root, "cold.json")) as f:
        cold = json.load(f)
    configs = planstore_configs(device)
    by_name = {c["name"]: c for c in configs}
    _build.build()
    t0 = time.perf_counter()
    for k in _build.KERNELS.values():
        k._load()
    kernel_load_seconds = time.perf_counter() - t0
    _build.reset_counts()
    rounds, plans, every = [], {}, []
    for _ in range(2):
        for plan in plans.values():
            plan.free()
        plans, rows = {}, []
        for entry, req in zip(cold["rows"], cold["requests"]):
            INIT_STATS.reset()
            spans = {}
            with span_ms(spans):
                t0 = time.perf_counter()
                plan = prewarm.init_from_request(
                    req, PlanStore(root), cache=PlanCache(), device=device)
                seconds = time.perf_counter() - t0
            row = planstore_row(entry, plan, seconds, INIT_STATS.as_dict())
            row["init_spans_ms"] = spans
            row.update(planstore_epoch(entry, plan, by_name, device))
            rows.append(row)
            plans[entry["label"]] = plan
        rounds.append(rows)
        every += list(plans.values())
    launches = path_launches("planstore warm process", every)
    no_replaced_kernels("planstore warm process", launches)
    terms = {}
    for name, variant, pack_impl in PLANSTORE_FLAT:
        label = f"{name}:{variant}x{pack_impl}"
        terms[label] = breakeven_terms(plans[label], by_name[name], device)
    with open(out_path, "w") as f:
        json.dump({"rounds": rounds, "launches": launches,
                   "kernel_load_seconds": kernel_load_seconds,
                   "breakeven_terms": terms}, f)
    return 0


def planstore_stale_check(cfg, device, root) -> dict:
    """A store populated by a CPU INIT of the config's pattern misses on
    the card (a cold INIT, which publishes under the card's kind); the CPU
    file copied under the card's key is an invalid entry and INIT stays
    cold."""
    import shutil
    from repro_torch.core import INIT_STATS, PlanCache, alltoallv_init
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.planstore import PlanStore

    def init(dev):
        before = INIT_STATS.as_dict()
        plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32",
                              VirtualMesh((cfg["p"],), ("x",), device=dev),
                              axis="x", variant="fence", pack_impl="fused",
                              cache=PlanCache(), store=PlanStore(root))
        after = INIT_STATS.as_dict()
        return plan, {k: after[k] - before[k] for k in after}

    cpu_plan, cpu_stats = init("cpu")
    card, miss = init(device)
    if card.warm_loaded or miss["store_misses"] != 1 or \
            miss["table_bakes"] != 1 or miss["store_hits"]:
        raise AssertionError(f"a CPU store warmed the card: {miss}")
    sig = card.signature
    store = PlanStore(root)
    shutil.copy(store.path_for(sig, "cpu"), store.path_for(sig, device))
    again, invalid = init(device)
    if again.warm_loaded or invalid["store_invalid"] != 1 or \
            invalid["table_bakes"] != 1:
        raise AssertionError(f"a CPU file under the card's key: {invalid}")
    check_against_oracle("stale check", again.wait(again.start(cfg["x"])), cfg)
    for p in (card, again):
        p.free()
    return {"cpu_init": cpu_stats, "card_init": miss,
            "cpu_file_under_card_key": invalid,
            "kinds": [store.kind_for("cpu"), store.kind_for(device)]}


def planstore_cli(root) -> list:
    """``python -m repro_torch.planstore warm-check --store root`` twice,
    the second time with ``--assert-warm``: cold, then warm."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out = []
    for extra in ([], ["--assert-warm"]):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.planstore",
                            "warm-check", "--store", root, *extra],
                           capture_output=True, text=True, cwd=HERE, env=env,
                           timeout=PLANSTORE_TIMEOUT)
        if r.returncode != 0:
            raise AssertionError(f"warm-check {extra} failed:\n"
                                 f"{r.stderr[-3000:]}")
        rep = json.loads(r.stdout)
        out.append({"seconds": time.perf_counter() - t0, "warm": rep["warm"],
                    "chosen_variant": rep["chosen_variant"],
                    "device_kind": rep["device_kind"],
                    "init_stats": rep["init_stats"]})
    if out[0]["warm"] or not out[1]["warm"] or \
            out[0]["chosen_variant"] != out[1]["chosen_variant"]:
        raise AssertionError(f"warm-check: {out}")
    return out


def run_planstore_path(device):
    """Cold INITs into a fresh store in this process
    (``run_planstore_cold``), then ``python3 chip_smoke.py
    --planstore-child`` replays the captured requests against the same
    directory.  Gates: every warm plan bakes no table, runs no burst, hits
    the store and (where its variant stores tables) is ``warm_loaded``;
    resolves to the cold run's variant; has valid rows bit-equal to the
    cold plan's (and the oracle, checked in both processes); makes the
    cold epoch's launches.  Then the stale check and the CLI.  Counters
    zeroed before, read after (this process's)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import breakeven
    from repro_torch.kernels import _build

    root = tempfile.mkdtemp(prefix="planstore-")
    try:
        configs = planstore_configs(device)
        _build.reset_counts()
        plans, cold, reqs = run_planstore_cold(configs, device,
                                               os.path.join(root, "store"))
        launches = path_launches("planstore path", plans)
        no_replaced_kernels("planstore path", launches)
        for plan in plans:
            plan.free()
        del plans
        torch.cuda.empty_cache()
        with open(os.path.join(root, "store", "cold.json"), "w") as f:
            json.dump({"rows": cold, "requests": reqs}, f)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--planstore-child", os.path.join(root, "store"),
                            os.path.join(root, "warm.json")],
                           capture_output=True, text=True, cwd=HERE,
                           timeout=PLANSTORE_TIMEOUT)
        child_seconds = time.perf_counter() - t0
        if r.returncode != 0 or r.stdout.strip():
            raise AssertionError(f"warm process failed (rc {r.returncode}):\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        with open(os.path.join(root, "warm.json")) as f:
            warm = json.load(f)
        table, bad = {}, []
        for i, c in enumerate(cold):
            ws = [rows[i] for rows in warm["rounds"]]
            for w in ws:
                s = w["init_stats"]
                if not (s["table_bakes"] == 0 and s["autotune_bursts"] == 0
                        and s["store_hits"] >= 1
                        and (w["warm_loaded"] or not c["stores_tables"])
                        and w["variant"] == c["variant"]
                        and w["pack_impl"] == c["pack_impl"]
                        and w["sha"] == c["sha"]
                        and w["launches"] == c["launches"]):
                    bad.append((c["label"], c, w))
            table[c["label"]] = {
                "variant": c["variant"], "warm_loaded": ws[0]["warm_loaded"],
                "launches_per_epoch": ws[0]["launches"],
                "warm_init_stats": ws[0]["init_stats"],
                "cold_ms": init_ms(c), "warm_ms": init_ms(ws[0]),
                "warm_again_ms": init_ms(ws[1]),
                "spans_ms": {k: {**r["init_spans_ms"],
                                 **r["compile_spans_ms"]}
                             for k, r in (("cold", c), ("warm", ws[0]),
                                          ("warm_again", ws[1]))}}
            if "auto" in c:
                table[c["label"]]["auto_sweep_seconds_skipped"] = \
                    c["auto"]["sweep_seconds"]
        if bad:
            raise AssertionError(f"planstore: warm plans off the contract: "
                                 f"{bad}")
        be = {}
        for label, (t_persist, t_mpi) in warm["breakeven_terms"].items():
            i = next(i for i, x in enumerate(cold) if x["label"] == label)
            t_init = {"cold": planstore_t_init(cold[i]),
                      "warm": planstore_t_init(warm["rounds"][0][i]),
                      "warm_again": planstore_t_init(warm["rounds"][1][i])}
            be[label] = {"t_persist_ms": t_persist * 1e3,
                         "t_mpi_ms": t_mpi * 1e3}
            for k, t in t_init.items():
                n = breakeven.n_breakeven(t, t_mpi, t_persist)
                be[label][f"t_init_{k}_ms"] = t * 1e3
                be[label][f"n_breakeven_{k}"] = n if math.isfinite(n) else None
        stale = planstore_stale_check(configs[0], device,
                                      os.path.join(root, "stale"))
        cli = planstore_cli(os.path.join(root, "cli"))
        total = {k: launches.get(k, 0) + warm["launches"].get(k, 0)
                 for k in set(launches) | set(warm["launches"])}
        return ({"plans": table, "breakeven": be, "stale": stale,
                 "warm_check_cli": cli, "warm_process_seconds": child_seconds,
                 "warm_kernel_load_seconds": warm["kernel_load_seconds"],
                 "launches_cold": launches,
                 "launches_warm": warm["launches"]}, total)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phase 10: OLMoE-1B-7B at full width, 4 of its 16 layers (its training
# state, 16 bytes per parameter, does not fit the card at 16), train_4k's
# sequence of 4096 at global batch 4 (16,384 tokens per step).
TRAIN = {"layers": 4, "seq": 4096, "batch": 4, "mesh": (1, 8), "steps": 6,
         "ckpt_every": 3}
# Kernel launches per MoE layer and step: dispatch and combine, each in the
# forward, the recomputation (remat) and the backward (the exchange's
# cotangent goes back through K2); K6 gate and up in the forward and the
# recomputation (its backward is plain PyTorch, as in JAX).
TRAIN_K2_PER_LAYER, TRAIN_K6_PER_LAYER = 6, 4
TRAIN_SYNC_BYTES = 2**30            # the gradient-sync prefix, fp32 bytes
TRAIN_EF_BYTES = 2**28              # its error-feedback check's prefix
# The MoE exchange of the training path: EP ranks, bucket capacity (the
# dispatch's chunk_peer_rows) and d_model; ``exchange_vjp_check`` holds the
# path's own shape to it, ``time_kernels`` times K2 at it.
TRAIN_EXCHANGE = (8, 2560, 2048)


def train_setup(device):
    """The phase's config, shape, mesh and schedule, as the launcher makes
    them for ``--steps 6``."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.train import ScheduleConfig

    cfg = dataclasses.replace(get("olmoe-1b-7b"), n_layers=TRAIN["layers"])
    shape = ShapeConfig("train_4k", "train", TRAIN["seq"], TRAIN["batch"])
    mesh = VirtualMesh(TRAIN["mesh"], ("data", "model"))
    n = TRAIN["steps"]
    sched = ScheduleConfig(kind="cosine", peak_lr=3e-4,
                           warmup_steps=max(n // 10, 1), total_steps=n,
                           decay_steps=max(n // 5, 1))
    return cfg, shape, mesh, sched


def exchange_vjp_check(plan, device) -> dict:
    """The gradient of one MoE exchange's input through the K2 backward
    against the plain exchange's on the card, at the layer's dispatch
    shape (``TRAIN_EXCHANGE``): outputs and gradients bit-equal, two
    launches of the K2 kernel the plan names; then K2 by its rule and the
    warp-per-row kernel against the plain version at that shape."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import a2a_fence

    rows = plan.ep_size * plan.chunk_peer_rows
    gen = torch.Generator(device).manual_seed(5)
    x = torch.randn((plan.ep_size, rows, plan.a2a.spec.feature_shape[0]),
                    generator=gen, device=device).to(torch.bfloat16)
    ep, cap, d = TRAIN_EXCHANGE
    if tuple(x.shape) != (ep, ep * cap, d) or plan.a2a.capacity != cap:
        raise AssertionError(f"train exchange: shape {tuple(x.shape)}, "
                             f"capacity {plan.a2a.capacity}, want "
                             f"{TRAIN_EXCHANGE}")
    cot = torch.randn(x.shape, generator=gen, device=device).to(torch.bfloat16)
    counter = _build.KERNELS[k2_counter(plan.a2a)]
    before = counter.launches
    xk = x.clone().requires_grad_(True)
    yk = plan.a2a.embed()(xk)
    (gk,) = torch.autograd.grad(yk, xk, cot)
    k2 = counter.launches - before
    xp = x.clone().requires_grad_(True)
    yp = a2a_fence.rma_alltoallv_fence_plain(xp, plan.ep_size,
                                             plan.chunk_peer_rows)
    (gp,) = torch.autograd.grad(yp, xp, cot)
    expect_same("train exchange forward", yk.detach(), yp.detach())
    expect_same("train exchange backward", gk, gp)
    if k2 != 2:
        raise AssertionError(f"train exchange vjp: {k2} K2 launches, want 2")
    check_fence("train exchange", x, ep, cap, want_rule="bulk")
    return {"shape": list(x.shape), "dtype": "bfloat16", "k2_launches": k2,
            "k2_counter": counter.name, "forward": "bit-equal",
            "backward": "bit-equal", "k2_vs_plain": "bytes equal"}


def k6_train_check(plan, params) -> dict:
    """K6 (its wgmma kernel) against its plain version at the training
    path's shape: the layer's own row table for the dispatch's chunk
    geometry, a random bf16 receive buffer, layer 0's gate and up
    weights; within 8e-3 x max|plain|, as at the serve shapes."""
    import torch
    from repro_torch.kernels import gather_matmul as gm
    from repro_torch.models import moe

    x, idx, valid, _ = k6_serve_inputs(params, params["embed"]["table"].device,
                                       plan.ep_size * plan.chunk_capacity)
    out = {}
    for name in ("w_gate", "w_up"):
        w = params["slot0"]["moe"][name][0]
        if gm.kernel_for(x, w) != "wgmma":
            raise AssertionError(f"train K6 {name}: {gm.kernel_for(x, w)}")
        got = gm.gather_matmul_kernel(x, idx, valid, w)
        want = gm.gather_matmul_plain(x, idx, valid, w)
        err, scale = k6_error(got, want)
        if not (bool(torch.isfinite(got).all()) and err <= 8e-3 * scale):
            raise AssertionError(f"train K6 {name}: max|diff| {err} against "
                                 f"max|plain| {scale}")
        out[name] = {"max_abs_err": err, "max_abs_plain": scale}
    return {"shape": {"x": list(x.shape), "idx": list(idx.shape),
                      "w": list(w.shape)}, **out}


def expert_grad_check(cfg, grads, kept) -> dict:
    """Every expert weight's gradient finite; non-zero for each (layer,
    expert) that kept at least one routed entry in the step (``kept``:
    ``moe.count_kept(per_expert=True)`` of its forward, one ``[E]`` array
    per layer), and exactly zero for one that kept none (it took no part
    in the loss)."""
    import numpy as np
    import torch
    kept = np.stack(kept[:cfg.n_layers])                   # [layers, E]
    out = {"experts_without_entries": [[int(l), int(e)] for l, e in
                                       np.argwhere(kept == 0)]}
    for name in ("w_gate", "w_up", "w_down"):
        g = grads["slot0"]["moe"][name].float()          # [layers, E, ., .]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"train path: non-finite {name} gradient")
        per_expert = g.abs().amax(dim=(-2, -1)).cpu().numpy()
        bad = np.argwhere((per_expert > 0) != (kept > 0))
        if len(bad):
            raise AssertionError(
                f"train path: {name} gradient zero where entries were kept, "
                f"or non-zero where none were, at (layer, expert) "
                f"{bad.tolist()[:16]}; kept {kept[tuple(bad.T)].tolist()[:16]}")
        out[name] = {"min_abs_max_routed": float(per_expert[kept > 0].min()),
                     "experts": list(per_expert.shape)}
    return out


def sync_prefix(grads, nbytes=None) -> dict:
    """Leading leaves of the gradient tree (tree order) whose fp32 size is
    at least ``nbytes`` (default ``TRAIN_SYNC_BYTES``), as a flat dict."""
    nbytes = TRAIN_SYNC_BYTES if nbytes is None else nbytes
    from repro_torch._tree import leaves_with_paths
    out, total = {}, 0
    for path, g in leaves_with_paths(grads):
        out[path.replace("/", ".")] = g
        total += g.numel() * 4
        if total >= nbytes:
            break
    return out


def run_grad_sync(grads, device) -> dict:
    """``persistent_rs_sync`` on ``VirtualMesh((2, 4), ("data", "model"))``
    over a >= 1 GiB prefix of the step's gradient tree, timed by part: the
    INIT of its reduce-scatter and allgatherv plans (``reduce_scatter_init``
    and ``allgatherv_init`` with the sync's own arguments, into the process
    plan cache: host bake and upload), then the first ``sync(tree)`` (which
    must hit the cache: no INIT, no table bake) and a second one on the
    same tree, the per-step cost.  Each call gives the tree back bit for
    bit (two equal fp32 addends sum and halve exactly) and launches one K2,
    the kernel the reduce-scatter plan names.  Then K2 at the sync's own
    shape (``time_fence`` on its padded buffer).  Then the error-feedback
    form on the card against the same function on a CPU copy, over a >=
    256 MiB prefix: synced gradients and residuals within one int8 step of
    each leaf."""
    import numpy as np
    import torch
    from repro_torch.core import (INIT_STATS, allgatherv_init, metadata as md,
                                  reduce_scatter_init)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.train import grad as grad_util

    tree = sync_prefix(grads)
    leaves, nbytes = list(tree), sum(g.numel() * 4 for g in tree.values())
    n = nbytes // 4
    mesh = VirtualMesh((2, 4), ("data", "model"))
    n_dp = mesh.shape["data"]
    cap = md.round_up(-(-n // n_dp), md.TILE_ROWS)
    counts = np.full(n_dp, cap, np.int64)
    sync = grad_util.persistent_rs_sync(mesh, ("data",))
    init_s = {}
    cold = INIT_STATS.as_dict()
    for name, init in (("reduce_scatter_init", reduce_scatter_init),
                       ("allgatherv_init", allgatherv_init)):
        t0 = time.perf_counter()
        plan = init(counts, (), torch.float32, mesh, axis="data",
                    embeddable=True)
        torch.cuda.synchronize()
        init_s[name] = time.perf_counter() - t0
        if name == "reduce_scatter_init":
            rs_plan = plan
    del plan
    warm = INIT_STATS.as_dict()
    k2 = k2_counter(rs_plan)
    calls = []
    for call in ("first", "second"):
        _build.reset_counts()
        t0 = time.perf_counter()
        out = sync(tree)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v["launches"] for k, v in _build.counts().items()
                    if v["launches"]}
        for k, g in tree.items():
            expect_same(f"grad sync {call} call {k}", out[k], g)
        del out
        if launches != {k2: 1}:
            raise AssertionError(f"grad sync {call} call: launches "
                                 f"{launches}, want one {k2}")
        calls.append({"call": call, "seconds": seconds, "launches": launches})
    after = INIT_STATS.as_dict()
    if after != warm:
        raise AssertionError(f"grad sync: the calls missed the plan cache "
                             f"(INIT stats {warm} -> {after})")
    # K2 at the sync's shape, on the buffer ``_wire`` builds
    padded = torch.zeros((n_dp, n_dp * cap), device=device)
    off = 0
    for g in tree.values():
        padded[:, off:off + g.numel()] = g.reshape(-1).float()
        off += g.numel()
    k2_times = time_fence("grad sync", padded, n_dp, cap, iters=5, inner=1)
    del padded
    torch.cuda.empty_cache()
    init_stats = {k: after[k] - cold[k] for k in after if after[k] != cold[k]}
    # The error-feedback form on a smaller prefix: its first sync INITs
    # two more plans, whose host bake grows with the prefix.
    tree = sync_prefix(grads, TRAIN_EF_BYTES)
    err = {k: torch.zeros(g.shape, dtype=torch.float32, device=device)
           for k, g in tree.items()}
    ef = grad_util.persistent_rs_sync(mesh, ("data",), error_feedback=True)
    g_card, e_card = ef(tree, err)
    cpu_mesh = VirtualMesh((2, 4), ("data", "model"), device="cpu")
    ef_cpu = grad_util.persistent_rs_sync(cpu_mesh, ("data",),
                                          error_feedback=True)
    tree_cpu = {k: g.cpu() for k, g in tree.items()}
    g_cpu, e_cpu = ef_cpu(tree_cpu, {k: e.cpu() for k, e in err.items()})
    worst = 0.0
    for k in tree:
        step = max(float(tree_cpu[k].float().abs().max()), 1e-12) / 127.0
        dg = float((g_card[k].float().cpu() - g_cpu[k].float()).abs().max())
        de = float((e_card[k].cpu() - e_cpu[k]).abs().max())
        worst = max(worst, dg / step, de / step)
        if not dg <= step or not de <= step:
            raise AssertionError(f"grad sync EF {k}: card and CPU differ by "
                                 f"{dg}, {de} (one int8 step {step})")
    return {"mesh": [2, 4], "leaves": leaves, "fp32_bytes": nbytes,
            "capacity": cap, "init_seconds": init_s,
            "init_stats": init_stats,
            "first_call_seconds": calls[0]["seconds"],
            "second_call_seconds": calls[1]["seconds"],
            "seconds_init_plus_first_call": sum(init_s.values())
            + calls[0]["seconds"],
            "calls": calls, "k2_at_sync_shape": k2_times,
            "identity": "bit-equal", "error_feedback_leaves": list(tree),
            "error_feedback_vs_cpu_in_int8_steps": worst}


def run_train_launcher(root) -> list:
    """``python3 -m repro_torch.launch.train --arch olmoe-1b-7b --reduced
    --mesh 1,8 --steps 3`` twice against one plan store, the second with
    ``--assert-warm-init``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "olmoe-1b-7b", "--reduced", "--mesh", "1,8", "--steps", "3",
           "--plan-store", os.path.join(root, "launcher-store")]
    out = []
    for extra in ([], ["--assert-warm-init"]):
        t0 = time.perf_counter()
        r = subprocess.run(cmd + extra, capture_output=True, text=True,
                           timeout=600, env=env, cwd=HERE)
        if r.returncode != 0 or "'final_step': 3" not in r.stdout or (
                extra and "ASSERT-WARM-INIT OK" not in r.stdout):
            raise AssertionError(f"train launcher {extra}: rc {r.returncode}\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        out.append({"args": extra, "seconds": time.perf_counter() - t0,
                    "warm": bool(extra)})
    return out


def run_train_path(device):
    """OLMoE-1B-7B at full width with 4 layers, bf16, trained through
    ``launch.steps.make_train_bundle`` and ``train.Trainer`` on
    ``VirtualMesh((1, 8))`` (EP 8, the persistent fence dispatch): 6 steps
    of 4 x 4096 tokens, uninterrupted.  Counters zeroed just before that
    run, read just after: K2 and K6 (wgmma) launches per step as
    predicted, nothing else launched, no plain version run.  Gates: finite
    losses, the last below the first.  Then the checkpoint: a second
    Trainer from the same seed takes steps 1-3 and checkpoints at step 3
    into a temporary directory (the state it is given: no step-0 save),
    and a fresh Trainer resumes from it and must give steps 4-6 within
    1e-2 of the uninterrupted run.  A checkpoint is 21 GiB (the fp32
    master, m and v; the bf16 params are the master's cast), and the card
    machine's disk takes 45 GiB of writes per call: two checkpoints are
    written.  Then every expert's gradient finite, non-zero where the
    expert kept routed entries and zero where it kept none, the exchange
    vjp bit-equal to the plain exchange's, K6 at the training shape
    against its plain version, the gradient sync
    (``run_grad_sync``) and the launcher twice against one plan store."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.core import capture_init_requests
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import api as model_api
    from repro_torch.models import attention, moe
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import grad as grad_util

    t_phase = time.perf_counter()
    cfg, shape, mesh, sched = train_setup(device)
    root = tempfile.mkdtemp(prefix="train-")
    ckpt_dir = os.path.join(root, "ckpt")
    n, at = TRAIN["steps"], TRAIN["ckpt_every"]

    def trainer(steps, ckpt):
        return Trainer(bundle, TrainerConfig(
            n_steps=steps, ckpt_dir=ckpt_dir if ckpt else None,
            ckpt_every=at, ckpt_keep=1, log_every=1, seed=0))

    def free(*objs):
        del objs
        gc.collect()
        torch.cuda.empty_cache()

    try:
        t0 = time.perf_counter()
        # The INIT requests of T's bundle, for the elastic resume of phase
        # 14 (f); capturing them changes nothing in T.
        with capture_init_requests() as captured:
            bundle = steps_mod.make_train_bundle(cfg, shape, mesh,
                                                 sched=sched)
        init_requests = list(captured)
        bundle_s = time.perf_counter() - t0
        plan = bundle.moe_plan

        # The uninterrupted run: the main path, counted.
        run = trainer(n, ckpt=False)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        run.run()
        counts = _build.counts()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v["launches"] for k, v in counts.items()}
        plain = {k: v["plain_calls"] for k, v in counts.items()
                 if v["plain_calls"]}
        want = {k: 0 for k in launches}
        want[k2_counter(plan.a2a)] = TRAIN_K2_PER_LAYER * cfg.n_layers * n
        want["gather_matmul_wgmma"] = TRAIN_K6_PER_LAYER * cfg.n_layers * n
        if launches != want or plain:
            raise AssertionError(f"train path: launches {launches}, want "
                                 f"{want}; plain versions called {plain}")
        history = [dict(h) for h in run.history]
        losses = [h["loss"] for h in history]
        if len(losses) != n or not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"train path: losses {losses}")
        # Each step's host time, the card idle at its end (the loop reads
        # every metric back): what the Trainer feeds the plan's ring.
        times = [float(t) for t in plan.a2a.epoch_ring.last(n)]
        ring_count = plan.a2a.epoch_ring.count
        free(run)
        del run

        # Steps 1-3 again, checkpointed at step 3; then a fresh Trainer.
        t0 = time.perf_counter()
        writer = trainer(at, ckpt=True)
        writer.init_state()
        writer.run()
        write_s = time.perf_counter() - t0
        first_again = [h["loss"] for h in writer.history]
        del writer
        free()
        # Phase 14 (f), here because the step-3 checkpoint is read back
        # and removed below: the resume onto (2, 4), which writes nothing.
        elastic = run_elastic_resume(cfg, shape, sched, ckpt_dir,
                                     init_requests, losses, root)
        free()
        t0 = time.perf_counter()
        resumed = trainer(n, ckpt=True)
        if not resumed.try_resume() or resumed.start_step != at:
            raise AssertionError("resume: no step-3 checkpoint")
        load_s = time.perf_counter() - t0
        # Read back: its blocks may serve the next write.
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{at:09d}"))
        resumed.run()
        resume_s = time.perf_counter() - t0
        again = {h["step"]: h["loss"] for h in resumed.history}
        first = {h["step"]: h["loss"] for h in history}
        if sorted(again) != list(range(at, n)):
            raise AssertionError(f"resume ran steps {sorted(again)}")
        rel = max(abs(again[s] - first[s]) / abs(first[s]) for s in again)
        if not rel <= 1e-2:
            raise AssertionError(f"resume: losses {again} against {first}")
        bit_equal = all(again[s] == first[s] for s in again)
        on_disk = sorted(os.listdir(ckpt_dir))

        # Gradients of one step from the trained state: every expert's.
        batch = resumed.pipe.batch_at(n)
        params = resumed.params
        del resumed
        free()

        def loss_fn(p, b):
            return model_api.model_loss(p, cfg, b, moe_plan=plan, remat=True)

        with bundle.trace_context(), moe.count_kept(per_expert=True) as kept:
            _, _, grads = grad_util.value_and_grad(loss_fn, params, batch)
        k6 = k6_train_check(plan, params)
        del params
        free()
        experts = expert_grad_check(cfg, grads, kept)
        vjp = exchange_vjp_check(plan, device)
        sync = run_grad_sync(grads, device)
        del grads
        free()
        launcher = run_train_launcher(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    step_s = statistics.median(times[1:])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    result = {
        "config": cfg.name, "layers": cfg.n_layers,
        "cut": "dataclasses.replace(get('olmoe-1b-7b'), n_layers=4): full "
               "width, 4 of 16 layers",
        "dtype": cfg.param_dtype, "mesh": list(TRAIN["mesh"]),
        "batch": TRAIN["batch"], "seq": TRAIN["seq"], "steps": n,
        "tokens_per_step": tokens, "bundle_seconds": bundle_s,
        "attention": "flash" if attention.use_flash(TRAIN["seq"], TRAIN["seq"])
        else "direct",
        "losses": losses, "grad_norms": [h["grad_norm"] for h in history],
        "step_seconds": times, "step_ms_median_2_6": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "peak_memory_gib": peak / 2**30,
        "launches_per_step": {k: v // n for k, v in launches.items() if v},
        "moe_plan": {"ep": plan.ep_size, "t_loc": plan.tokens_per_shard,
                     "capacity": plan.capacity, "variant": plan.variant},
        "epoch_ring_samples": ring_count,
        "checkpoint": {"write_run_seconds": write_s,
                       "steps_1_3_again": first_again,
                       "steps_1_3_bit_equal": first_again == losses[:at],
                       "load_seconds": load_s, "on_disk_after": on_disk},
        "resume": {"seconds": resume_s,
                   "losses": [again[s] for s in sorted(again)],
                   "max_rel_diff": rel, "bit_equal": bit_equal},
        "expert_grads": experts, "exchange_vjp": vjp, "k6_vs_plain": k6,
        "grad_sync": sync,
        "launcher": launcher,
        "init_requests": len(init_requests),
        "phase_seconds": time.perf_counter() - t_phase,
        "elastic": elastic,
    }
    return result, launches


def run_elastic_resume(cfg, shape, sched, ckpt_dir, requests, t_losses,
                       root) -> dict:
    """Phase 14 (f): T's step-3 checkpoint, written on (1, 8), resumed onto
    ``VirtualMesh((2, 4))``.  ``runtime.replan.reshard_plans`` projects the
    INIT requests captured around T's bundle build onto the new mesh and
    prewarms a plan store with them; a Trainer on (2, 4) restores through
    ``ckpt.reshard.load_to_mesh`` (``Trainer._restore``) from a
    ``CheckpointManager`` that is detached before the run, so no
    checkpoint is written.  Counters zeroed just before steps 4-6, read
    just after: 24 K2 and 16 wgmma K6 launches per step, nothing else, no
    plain version.  Gate: the losses of steps 4-6 equal T's bit for bit."""
    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.planstore import PlanStore
    from repro_torch.runtime import reshard_plans
    from repro_torch.train import Trainer, TrainerConfig

    n, at = TRAIN["steps"], TRAIN["ckpt_every"]
    mesh = VirtualMesh((2, 4), ("data", "model"))
    t0 = time.perf_counter()
    report = reshard_plans(requests, mesh,
                           store=PlanStore(os.path.join(root, "elastic")))
    reshard_s = time.perf_counter() - t0
    bundle = steps_mod.make_train_bundle(cfg, shape, mesh, sched=sched)
    run = Trainer(bundle, TrainerConfig(n_steps=n, ckpt_dir=None, log_every=1,
                                        seed=0))
    t0 = time.perf_counter()
    run.ckpt = CheckpointManager(ckpt_dir)
    if not run.try_resume() or run.start_step != at:
        raise AssertionError("elastic resume: no step-3 checkpoint")
    run.ckpt = None
    load_s = time.perf_counter() - t0
    _build.reset_counts()
    run.run()
    counts = _build.counts()
    launches = {k: v["launches"] for k, v in counts.items() if v["launches"]}
    plain = {k: v["plain_calls"] for k, v in counts.items() if v["plain_calls"]}
    want = {k2_counter(bundle.moe_plan.a2a): TRAIN_K2_PER_LAYER * cfg.n_layers
            * (n - at),
            "gather_matmul_wgmma": TRAIN_K6_PER_LAYER * cfg.n_layers * (n - at)}
    if launches != want or plain:
        raise AssertionError(f"elastic resume: launches {launches}, want "
                             f"{want}; plain versions called {plain}")
    losses = [h["loss"] for h in run.history]
    if losses != t_losses[at:]:
        raise AssertionError(f"elastic resume: losses {losses} differ from "
                             f"T's {t_losses[at:]}")
    if os.listdir(ckpt_dir) != [f"step_{at:09d}"]:
        raise AssertionError(f"elastic resume wrote {os.listdir(ckpt_dir)}")
    out = {"from_mesh": list(TRAIN["mesh"]), "to_mesh": [2, 4],
           "requests": len(requests),
           "resharded": [{k: r.get(k) for k in ("variant", "p", "axis_sizes",
                                                 "warm", "resharded_from")}
                         for r in report["resharded"]],
           "skipped": report["skipped"], "reshard_seconds": reshard_s,
           "load_seconds": load_s, "losses": losses,
           "losses_equal_T": True, "moe_plan_variant": bundle.moe_plan.variant,
           "launches": launches}
    del run, bundle
    torch.cuda.empty_cache()
    return out


# Phase 11: the MoE layer and training on every mesh the JAX package takes.
# name -> (mesh shape, axis names, rule profile).  Every layout puts 2,048
# tokens on each of its 8 virtual ranks at T's 4 x 4096 tokens; (1, 8) is
# T's own.
MESH_LAYOUTS = {"1x8": ((1, 8), ("data", "model"), "default"),
                "2x4": ((2, 4), ("data", "model"), "default"),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"), "hier_ep"),
                "2x1x4": ((2, 1, 4), ("pod", "data", "model"), "hier_ep")}
# (layout, a2a variant, pack_impl, overlap depth) of the layer checks; the
# first is the reference every other is held to bit for bit.
MESH_LAYER_CASES = (("1x8", "fence", "jnp", 1), ("2x4", "fence", "jnp", 1),
                    ("2x2x2", "fence", "jnp", 1),
                    ("2x2x2", "fence_hierarchy", "jnp", 1),
                    ("2x2x2", "fence_hierarchy", "pallas", 1),
                    ("2x2x2", "fence_hierarchy", "fused", 1),
                    ("2x1x4", "fence_hierarchy", "jnp", 1),
                    ("2x1x4", "fence_hierarchy", "fused", 1),
                    ("2x4", "fence", "jnp", 2),
                    ("2x1x4", "fence_hierarchy", "jnp", 2))
# Layouts trained at full width, and their K2 launches per MoE layer and
# step (the hierarchy's two hops per exchange).
MESH_TRAIN = (("2x4", "fence", TRAIN_K2_PER_LAYER),
              ("2x1x4", "fence_hierarchy", 2 * TRAIN_K2_PER_LAYER))
MOE_GRADS = ("router", "w_gate", "w_up", "w_down", "x")


def mesh_layer_launches(variant, impl) -> tuple[dict, dict]:
    """Launches of one MoE layer's forward and of its backward (no remat):
    dispatch and combine each one K2 (two under the hierarchy: hops 1 and
    3), both ways; under the hierarchy with ``pallas`` and ``fused`` its s1
    and s3 packs (K1 from run tables) and with ``fused`` its stage 2 (K5);
    K6 gate and up in the forward (its backward is plain PyTorch)."""
    hier = variant == "fence_hierarchy"
    per = {"a2a_fence_bulk": 2 if hier else 1}
    if hier and impl != "jnp":
        per["gather_rows_runs"] = 2
    if hier and impl == "fused":
        per["a2a_hier"] = 1
    bwd = {k: 2 * v for k, v in per.items()}
    return dict(bwd, gather_matmul_wgmma=2), bwd


def mesh_layer_inputs(device) -> dict:
    """OLMoE-1B-7B's MoE layer at full width (d_model 2048, 64 experts,
    top-8, d_expert 1024), bf16 weights from a seeded generator on the
    card, T's 4 x 4096 tokens and a cotangent (a mean over the tokens, as
    the loss)."""
    import torch
    from repro_torch.configs import get

    cfg = get("olmoe-1b-7b")
    m, d = cfg.moe, cfg.d_model
    gen = torch.Generator(device).manual_seed(7)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    b, s = TRAIN["batch"], TRAIN["seq"]
    prm = {"router": rnd((d, m.n_experts), d ** -0.5),
           "w_gate": rnd((m.n_experts, d, m.d_expert), d ** -0.5),
           "w_up": rnd((m.n_experts, d, m.d_expert), d ** -0.5),
           "w_down": rnd((m.n_experts, m.d_expert, d), m.d_expert ** -0.5)}
    return {"cfg": cfg,
            "prm": {k: v.requires_grad_(True) for k, v in prm.items()},
            "x": rnd((b, s, d), 1.0).requires_grad_(True),
            "cot": rnd((b, s, d), 1.0 / (b * s)),
            "aux_cot": torch.tensor([0.5, -0.25], device=device)}


def mesh_layer_plan(inp, case, cache):
    """The case's mesh, rules, MoE config and dispatch plan, built as the
    train bundle builds it (tokens per data shard for T's shape)."""
    import dataclasses
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import RULE_PROFILES, axis_rules

    name, variant, impl, depth = case
    shape, axes, rules = MESH_LAYOUTS[name]
    mesh, rules = VirtualMesh(shape, axes), RULE_PROFILES[rules]
    cfg = inp["cfg"]
    mcfg = dataclasses.replace(cfg.moe, a2a_variant=variant,
                               overlap_chunks=depth)
    tshape = ShapeConfig("train_4k", "train", TRAIN["seq"], TRAIN["batch"])
    with axis_rules(rules, mesh):
        plan = moe.MoEDispatchPlan.build(
            mcfg, steps_mod._moe_tokens_per_shard(cfg, tshape, mesh), mesh,
            d_model=cfg.d_model, dtype=torch.bfloat16, pack_impl=impl,
            cache=cache)
    return mesh, rules, mcfg, plan


def mesh_layer_run(inp, mesh, rules, mcfg, plan, grad=True):
    """One forward (and backward) of the layer: ``(y, aux, grads)``."""
    import torch
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import axis_rules

    prm, x = inp["prm"], inp["x"]
    with axis_rules(rules, mesh), torch.set_grad_enabled(grad):
        y, aux = moe.apply_moe(prm, x, mcfg, plan)
    if not grad:
        return y, aux, None
    grads = torch.autograd.grad(
        [y, aux], [prm[n] for n in MOE_GRADS[:4]] + [x],
        [inp["cot"], inp["aux_cot"]])
    return y, aux, grads


def mesh_exchange_vjp(plan, n_dp, device) -> dict:
    """The layer's exchange at its own shape, ``embed(groups=n_dp)``,
    through the kernels, against the plain fence exchange (the flat
    all-to-all of each data group): output and input gradient bit-equal."""
    import torch
    from repro_torch.kernels import a2a_fence

    ep, rows = plan.ep_size, plan.chunk_peer_rows
    gen = torch.Generator(device).manual_seed(9)
    x = torch.randn((n_dp * ep, ep * rows, plan.a2a.spec.feature_shape[0]),
                    generator=gen, device=device).to(torch.bfloat16)
    cot = torch.randn(x.shape, generator=gen, device=device).to(torch.bfloat16)
    xk = x.clone().requires_grad_(True)
    yk = plan.a2a.embed(n_dp)(xk)
    (gk,) = torch.autograd.grad(yk, xk, cot)
    xp = x.clone().requires_grad_(True)
    yp = a2a_fence.rma_alltoallv_fence_plain(xp, ep, rows, n_dp)
    (gp,) = torch.autograd.grad(yp, xp, cot)
    expect_same(f"mesh exchange {plan.variant} forward", yk.detach(),
                yp.detach())
    expect_same(f"mesh exchange {plan.variant} backward", gk, gp)
    return {"shape": list(x.shape), "groups": n_dp, "forward": "bit-equal",
            "backward": "bit-equal"}


def run_mesh_layers(device) -> tuple[dict, dict]:
    """Every ``MESH_LAYER_CASES`` entry: the layer's launches in the
    forward and the backward (counters zeroed just before each, read just
    after; no plain version), its output finite, and output, aux losses
    and gradients bit-equal to the (1, 8) reference, except that a depth-2
    run's expert weight gradients (a sum over two chunks' partial
    products) are held within 8e-3 x max|reference|; forward and
    forward+backward ms; the exchange's vjp against the plain one."""
    import torch
    from repro_torch.core import PlanCache
    from repro_torch.kernels import _build
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import axis_rules, batch_ways

    inp = mesh_layer_inputs(device)
    cache = PlanCache()
    ref, rows, launches = None, {}, {}
    tokens = TRAIN["batch"] * TRAIN["seq"]
    for case in MESH_LAYER_CASES:
        label = "-".join(str(c) for c in case)
        name, variant, impl, depth = case
        mesh, rules, mcfg, plan = mesh_layer_plan(inp, case, cache)
        with axis_rules(rules, mesh):
            n_dp = batch_ways(tokens, mesh)
        _build.reset_counts()
        with moe.count_kept() as kept:
            y, aux, _ = mesh_layer_run(inp, mesh, rules, mcfg, plan,
                                       grad=False)
        fwd_counts = _build.counts()
        _build.reset_counts()
        y, aux, grads = mesh_layer_run(inp, mesh, rules, mcfg, plan)
        both = _build.counts()
        got_fwd = {k: v["launches"] for k, v in fwd_counts.items()
                   if v["launches"]}
        got_all = {k: v["launches"] for k, v in both.items() if v["launches"]}
        plain = {k: fwd_counts[k]["plain_calls"] + v["plain_calls"]
                 for k, v in both.items()
                 if fwd_counts[k]["plain_calls"] + v["plain_calls"]}
        # Each chunk of a depth-k pipeline makes one chunk's launches.
        want_fwd, want_bwd = (
            {k: v * depth for k, v in want.items()}
            for want in mesh_layer_launches(plan.variant, impl))
        want_all = {k: want_fwd.get(k, 0) + want_bwd.get(k, 0)
                    for k in set(want_fwd) | set(want_bwd)}
        got_bwd = {k: got_all.get(k, 0) - got_fwd.get(k, 0)
                   for k in got_all if got_all.get(k, 0) - got_fwd.get(k, 0)}
        if got_fwd != want_fwd or got_all != want_all or plain:
            raise AssertionError(
                f"mesh layer {label}: launches forward {got_fwd} (want "
                f"{want_fwd}), forward+backward {got_all} (want {want_all}); "
                f"plain versions {plain}")
        if plan.variant != variant:
            raise AssertionError(f"mesh layer {label}: variant {plan.variant}")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"mesh layer {label}: non-finite output")
        row = {"mesh": list(MESH_LAYOUTS[name][0]),
               "rules": MESH_LAYOUTS[name][2], "data_shards": n_dp,
               "ep": plan.ep_size, "axis": plan.axis,
               "t_loc": plan.tokens_per_shard, "capacity": plan.capacity,
               "experts_per_rank": plan.e_local,
               "rows_per_pair": plan.chunk_peer_rows,
               "overlap_chunks": plan.overlap_chunks,
               "kept_entries": kept[0],
               "launches_forward": got_fwd, "launches_backward": got_bwd}
        if ref is None:
            ref = (y.detach(), aux.detach(), [g.detach() for g in grads])
            row["reference"] = True
        else:
            expect_same(f"mesh layer {label} output", y, ref[0])
            expect_same(f"mesh layer {label} aux", aux, ref[1])
            worst = {}
            for n, g, want in zip(MOE_GRADS, grads, ref[2]):
                if depth == 1 or n in ("router", "x"):
                    expect_same(f"mesh layer {label} d{n}", g, want)
                    continue
                err = float((g.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                worst[n] = {"max_abs_diff": err, "max_abs_ref": scale,
                            "equal_fraction": float(
                                (g == want).float().mean())}
                if not err <= 8e-3 * scale:
                    raise AssertionError(f"mesh layer {label} d{n}: "
                                         f"{err} against {scale}")
            row["vs_reference"] = ("output, aux and every gradient "
                                   "bit-equal" if depth == 1 else
                                   "output, aux, router and input gradients "
                                   "bit-equal; expert weights within 8e-3 x "
                                   "max")
            if worst:
                row["expert_grads_vs_depth_1"] = worst
        del y, aux, grads

        def fwd(inp=inp, m=(mesh, rules, mcfg, plan)):
            return mesh_layer_run(inp, *m, grad=False)

        def fwd_bwd(inp=inp, m=(mesh, rules, mcfg, plan)):
            return mesh_layer_run(inp, *m)

        row["forward_ms"] = median_ms(fwd, iters=5, inner=1, warmup=1)
        row["forward_backward_ms"] = median_ms(fwd_bwd, iters=5, inner=1,
                                               warmup=1)
        if depth == 1 and plan.a2a is not None and case[0] != "1x8" \
                and impl in ("jnp", "fused"):
            row["exchange_vjp"] = mesh_exchange_vjp(plan, n_dp, device)
        for k, v in got_all.items():
            launches[k] = launches.get(k, 0) + v
        rows[label] = row
        torch.cuda.empty_cache()
    streams = [str(d) for d in moe._SIDE_STREAMS]
    if not streams:
        raise AssertionError("mesh layer: depth 2 ran no side stream")
    return {"cases": rows, "side_streams": streams}, launches


def run_mesh_train(device) -> tuple[dict, dict]:
    """OLMoE-1B-7B with T's 4 full-width layers, 6 steps of 4 x 4096
    tokens, through ``make_train_bundle`` and ``Trainer`` on each
    ``MESH_TRAIN`` layout (no checkpoint).  Counters zeroed just before
    each run, read just after: per step the layout's K2 launches and 16
    wgmma K6, nothing else, no plain version.  Gates: finite losses, the
    last below the first.  Step ms (median of steps 2-6, the ring T
    reads), tokens/s, peak memory, and whether the losses equal T's."""
    import dataclasses
    import gc
    import torch
    from repro_torch.core import reset_global_plan_cache
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.parallel.sharding import RULE_PROFILES
    from repro_torch.train import Trainer, TrainerConfig

    cfg0, shape, _, sched = train_setup(device)
    n = TRAIN["steps"]
    out, launches = {}, {}
    for name, variant, k2_per_layer in MESH_TRAIN:
        cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
            cfg0.moe, a2a_variant=variant))
        dims, axes, rules = MESH_LAYOUTS[name]
        mesh = VirtualMesh(dims, axes)
        t0 = time.perf_counter()
        bundle = steps_mod.make_train_bundle(cfg, shape, mesh, sched=sched,
                                             rules=RULE_PROFILES[rules])
        bundle_s = time.perf_counter() - t0
        plan = bundle.moe_plan
        run = Trainer(bundle, TrainerConfig(n_steps=n, ckpt_dir=None,
                                            log_every=1, seed=0))
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        run.run()
        counts = _build.counts()
        peak = torch.cuda.max_memory_allocated()
        got = {k: v["launches"] for k, v in counts.items() if v["launches"]}
        plain = {k: v["plain_calls"] for k, v in counts.items()
                 if v["plain_calls"]}
        want = {"a2a_fence_bulk": k2_per_layer * cfg.n_layers * n,
                "gather_matmul_wgmma": TRAIN_K6_PER_LAYER * cfg.n_layers * n}
        if got != want or plain:
            raise AssertionError(f"mesh train {name}: launches {got}, want "
                                 f"{want}; plain versions called {plain}")
        losses = [h["loss"] for h in run.history]
        if len(losses) != n or not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"mesh train {name}: losses {losses}")
        times = [float(t) for t in plan.a2a.epoch_ring.last(n)]
        step_s = statistics.median(times[1:])
        tokens = TRAIN["batch"] * TRAIN["seq"]
        out[name] = {
            "mesh": list(dims), "rules": rules, "variant": plan.variant,
            "pack_impl": plan.a2a.spec.pack_impl,
            "moe_plan": {"ep": plan.ep_size, "axis": plan.axis,
                         "t_loc": plan.tokens_per_shard,
                         "capacity": plan.capacity,
                         "experts_per_rank": plan.e_local},
            "bundle_seconds": bundle_s, "losses": losses,
            "grad_norms": [h["grad_norm"] for h in run.history],
            "step_seconds": times, "step_ms_median_2_6": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "peak_memory_gib": peak / 2**30,
            "launches_per_step": {k: v // n for k, v in got.items()}}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        del run, bundle, plan
        reset_global_plan_cache()
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


def run_mesh_path(device, t_losses) -> tuple[dict, dict]:
    """Phase 11: the layer checks, then the two trainings; T's losses
    (phase 10, (1, 8)) beside each layout's, which must equal them: every
    layout routes the same 2,048 tokens on each rank at the same
    capacity, so the same rows take the same ops."""
    t_phase = time.perf_counter()
    layers, layer_launches = run_mesh_layers(device)
    train, train_launches = run_mesh_train(device)
    for name, row in train.items():
        row["losses_equal_T"] = row["losses"] == t_losses
        if not row["losses_equal_T"]:
            raise AssertionError(f"mesh train {name}: losses {row['losses']}"
                                 f" differ from T's {t_losses}")
    launches = dict(layer_launches)
    for k, v in train_launches.items():
        launches[k] = launches.get(k, 0) + v
    return ({"layer": layers, "train": train, "T_losses": t_losses,
             "phase_seconds": time.perf_counter() - t_phase}, launches)


# ---------------------------------------------------------------------------
# Phase 12: the attention-only families (slice 13)
# ---------------------------------------------------------------------------

# Moonshot-v1-16B-A3B served at full width with 24 of its 48 layers: the
# weights are 29.6 GB of bf16 there, and ``normal_init`` draws each stacked
# tensor in fp32 and scales it into a second fp32 tensor before the cast,
# so w_down's draw peaks near 63.5 GB (48 layers: ~126 GB; 32: ~84 GB).
FAMILIES = {"moonshot_layers": 24, "batch": 4, "prompt": 128, "tokens": 16,
            "mesh": (1, 8)}
# T's attention shape: B, S, heads x head_dim (MHA), bf16.
FLASH_CARD = {"b": 4, "s": 4096, "heads": 16, "head_dim": 128}
FLASH_TOL = 2e-2                    # x max|direct|, bf16 outputs
# Ulysses at OLMo-1B's attention width: B, S, heads x head_dim, bf16;
# name -> (mesh shape, axis names, sequence axis, hier).
ULYSSES_CARD = {"b": 2, "s": 4096, "heads": 16, "head_dim": 128}
ULYSSES_MESHES = {"8": ((8,), ("model",), "model", False),
                  "2x4": ((2, 4), ("pod", "model"), ("pod", "model"), True)}
ULYSSES_TOL = 8e-3                  # x max|_attend|, bf16 outputs
REDUCE_CARD = (8, 2048, 4096)       # [pod x data ranks, rows, features] fp32


def free_card() -> float:
    """Drop the global plans and cached blocks; the GiB still allocated."""
    import gc
    import torch
    from repro_torch.core import reset_global_plan_cache

    reset_global_plan_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def k6_moonshot(eng) -> dict:
    """K6 at Moonshot's served prefill shape (64 experts, N = 8 ranks x
    the prefill plan's capacity, D 2048, F 1408: 11 wgmma F-tiles) on the
    MoE layer's own row table: layer 0's gate weights gated and timed, its
    up weights gated (``k6_readings``)."""
    plan = eng.prefill_bundle.moe_plan
    x, idx, valid, w_gate = k6_serve_inputs(eng.params, eng.device,
                                            plan.ep_size * plan.capacity)
    out = k6_readings("Moonshot gate", x, idx, valid, w_gate)
    up = k6_readings("Moonshot up", x, idx, valid,
                     eng.params["slot0"]["moe"]["w_up"][0], timed=False)
    out["up_max_abs_err"] = up["max_abs_err"]
    out["f_tiles"] = -(-w_gate.shape[2] // 128)
    return out


def run_moonshot_serve(device) -> tuple[dict, dict, dict]:
    """Moonshot-v1-16B-A3B at full width with 24 of 48 layers (bf16 seeded
    weights on the card; shared experts, top-6, rope theta 50 000, F =
    1408) served through ``ServeEngine.generate`` on ``VirtualMesh((1,
    8))`` (EP 8, fence dispatch): 4 prompts of 128 tokens, 16 new tokens.
    Counters zeroed just before, read just after: every forward launches
    exactly 48 wgmma K6 and 48 K2 and nothing else, no plain version.
    Then finite bf16 logits of a prefill and a decode step, and K6 at the
    served shape (``k6_moonshot``)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch._tree import leaves
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get("moonshot-v1-16b-a3b"),
                              n_layers=FAMILIES["moonshot_layers"])
    b, s, n = FAMILIES["batch"], FAMILIES["prompt"], FAMILIES["tokens"]
    mesh = VirtualMesh(FAMILIES["mesh"], ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, mesh, batch=b, prompt_len=s, max_seq=s + n + 8,
                      seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in leaves(eng.params))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    eng.generate(prompts, 2)                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    toks, stats = eng.generate(prompts, n)
    counts = _build.counts()
    serve_peak = torch.cuda.max_memory_allocated()
    per_kernel = {k: v["launches"] for k, v in counts.items()}
    want = {k: 0 for k in per_kernel}
    want["gather_matmul_wgmma"] = want[k2_counter(eng.moe_plan.a2a)] = (
        2 * cfg.n_layers * n)
    plain = {k: v["plain_calls"] for k, v in counts.items() if v["plain_calls"]}
    if per_kernel != want or plain:
        raise AssertionError(f"Moonshot serve: launches {per_kernel}, want "
                             f"{want}; plain versions called {plain}")
    if toks.shape != (b, n) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"Moonshot serve: tokens {toks.shape} out of range")
    logits, _, _ = serve_forwards(eng, prompts, 2)
    if not all(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all())
               for lg in logits):
        raise AssertionError("Moonshot serve: non-finite bf16 logits")
    k6 = k6_moonshot(eng)
    plan = eng.moe_plan
    total_s = stats.prefill_seconds + (n - 1) * stats.decode_seconds_per_token
    result = {
        "config": cfg.name, "layers": cfg.n_layers,
        "cut": "dataclasses.replace(get('moonshot-v1-16b-a3b'), n_layers=24): "
               "full width, 24 of 48 layers",
        "params": n_params, "dtype": cfg.param_dtype,
        "mesh": list(FAMILIES["mesh"]), "batch": b, "prompt": s,
        "new_tokens": n, "init_seconds": init_s,
        "init_peak_gib": init_peak / 2**30,
        "prefill_ms": stats.prefill_seconds * 1e3,
        "decode_ms_per_token": stats.decode_seconds_per_token * 1e3,
        "decode_tokens_per_s": b / stats.decode_seconds_per_token,
        "tokens_per_s": b * n / total_s,
        "launches_per_forward": {k: v // n for k, v in per_kernel.items() if v},
        "decode_plan": {"ep": plan.ep_size, "t_loc": plan.tokens_per_shard,
                        "capacity": plan.capacity,
                        "prefill_capacity": eng.prefill_bundle.moe_plan.capacity},
        "serve_peak_gib": serve_peak / 2**30,
        "logits_finite": True,
    }
    del eng
    return result, per_kernel, k6


def run_olmo_serve(device) -> tuple[dict, dict]:
    """OLMo-1B at full size (16 dense layers, ``nonparametric_ln``, tied
    embeddings, bf16 seeded) through ``ServeEngine.generate``, the same
    batch as Moonshot's: no kernel launches and no plain version (the
    dense FFN and attention are plain PyTorch, as in JAX).  Then OLMo at
    depth 2 on the card against the CPU (``run_serve_vs_cpu``)."""
    import numpy as np
    import torch
    from repro_torch._tree import leaves
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.serve import ServeEngine

    cfg = get("olmo-1b")
    b, s, n = FAMILIES["batch"], FAMILIES["prompt"], FAMILIES["tokens"]
    mesh = VirtualMesh(FAMILIES["mesh"], ("data", "model"))
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, mesh, batch=b, prompt_len=s, max_seq=s + n + 8,
                      seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if eng.moe_plan is not None or eng.prefill_bundle.moe_plan is not None:
        raise AssertionError("OLMo serve: a dense model built a MoE plan")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    eng.generate(prompts, 2)
    _build.reset_counts()
    toks, stats = eng.generate(prompts, n)
    counts = _build.counts()
    ran = {k: v for k, v in counts.items()
           if v["launches"] or v["plain_calls"]}
    if ran:
        raise AssertionError(f"OLMo serve: kernels or plain versions ran {ran}")
    logits, _, _ = serve_forwards(eng, prompts, 2)
    if not all(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all())
               for lg in logits):
        raise AssertionError("OLMo serve: non-finite bf16 logits")
    total_s = stats.prefill_seconds + (n - 1) * stats.decode_seconds_per_token
    result = {
        "config": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
        "params": sum(t.numel() for t in leaves(eng.params)),
        "batch": b, "prompt": s, "new_tokens": n, "init_seconds": init_s,
        "prefill_ms": stats.prefill_seconds * 1e3,
        "decode_ms_per_token": stats.decode_seconds_per_token * 1e3,
        "tokens_per_s": b * n / total_s, "launches": 0,
    }
    del eng
    free_card()
    result["vs_cpu"] = dict(run_serve_vs_cpu(device, cfg.name),
                            tolerance="1e-3 x max|logit|")
    return result, {k: v["launches"] for k, v in counts.items()}


def peak_gib(fn) -> float:
    """Peak GiB allocated while ``fn`` runs, above what was held before."""
    import torch
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**30


def run_flash_vs_direct(device) -> dict:
    """The flash path against the direct one at T's attention shape (B 4,
    S 4096, 16 heads x 128, bf16, causal by positions), on the same
    inputs: forward and forward+backward ms (CUDA events, median of 5)
    and the peak GiB of each above the inputs, max|flash - direct| on the
    output and on dq, dk and dv, each within FLASH_TOL x max|direct|."""
    import torch
    from repro_torch.models import attention

    b, s, h, d = (FLASH_CARD[k] for k in ("b", "s", "heads", "head_dim"))
    if not attention.use_flash(s, s):
        raise AssertionError("flash: apply_attention would not take it at T")
    gen = torch.Generator(device=device).manual_seed(8)
    q = torch.randn((b, s, h, 1, d), generator=gen, device=device).to(torch.bfloat16)
    k = torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16)
    do = torch.randn((b, s, h, 1, d), generator=gen, device=device).to(torch.bfloat16)
    pos = torch.arange(s, device=device)[None].expand(b, s)
    mask = pos[:, :, None] >= pos[:, None, :]
    scale = d ** -0.5
    for t in (q, k, v):
        t.requires_grad_(True)
    paths = {
        "flash": lambda: attention._flash_attention(q, k, v, pos, pos, True,
                                                    scale),
        "direct": lambda: attention._direct_attention(q, k, v, mask, scale),
    }
    out = {}
    results = {}
    for name, fwd in paths.items():
        def step(fwd=fwd):
            o = fwd()
            return (o,) + torch.autograd.grad(o, (q, k, v), do)

        with torch.no_grad():
            fwd_ms = median_ms(fwd, iters=5, inner=1, warmup=1)
            fwd_peak = peak_gib(fwd)
        results[name] = [t.detach() for t in step()]
        out[name] = {"forward_ms": fwd_ms,
                     "fwd_bwd_ms": median_ms(step, iters=5, inner=1, warmup=1),
                     "forward_peak_gib": fwd_peak,
                     "fwd_bwd_peak_gib": peak_gib(step)}
    errs = {}
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        f, dr = results["flash"][i].float(), results["direct"][i].float()
        err, ref = float((f - dr).abs().max()), float(dr.abs().max())
        errs[name] = {"max_abs_diff": err, "max_abs_direct": ref}
        if not (bool(torch.isfinite(f).all()) and err <= FLASH_TOL * ref):
            raise AssertionError(f"flash vs direct {name}: {err} (max {ref})")
    out.update({"shape": dict(FLASH_CARD, dtype="bfloat16"), "errors": errs,
                "tolerance": f"{FLASH_TOL} x max|direct|"})
    return out


def run_ulysses_card(device) -> tuple[dict, dict]:
    """``ulysses_attention`` at OLMo-1B's attention width (B 2, S 4096, 16
    heads x 128, MHA, bf16) on ``(8,)`` with the fence head exchange and
    on ``(2, 4)`` ("pod", "model") with ``fence_hierarchy``, held against
    ``_attend`` on the card (bit-equal reported; ULYSSES_TOL x max|_attend|
    gated).  The counters are zeroed just before one call and read just
    after: four head exchanges (K2, one epoch each flat, two under the
    hierarchy) and whatever the positions gather launches, no plain
    version.  ms of the call against ``_attend`` alone."""
    import torch
    from repro_torch.kernels import _build, a2a_fence
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.models import ulysses
    from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

    b, s, h, d = (ULYSSES_CARD[k] for k in ("b", "s", "heads", "head_dim"))
    gen = torch.Generator(device=device).manual_seed(9)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    pos = torch.arange(s, device=device, dtype=torch.int32)[None].expand(b, s)
    with torch.no_grad():
        want = ulysses._attend(q, k, v, pos, True)
        attend_ms = median_ms(lambda: ulysses._attend(q, k, v, pos, True),
                              iters=5, inner=1)
    out = {"shape": dict(ULYSSES_CARD, dtype="bfloat16"),
           "attend_ms": attend_ms, "tolerance": f"{ULYSSES_TOL} x max|_attend|"}
    launches: dict = {}
    for tag, (shape, names, axis, hier) in ULYSSES_MESHES.items():
        mesh = VirtualMesh(shape, names)
        with axis_rules(DEFAULT_RULES, mesh), torch.no_grad():
            plan = ulysses.UlyssesPlan.build(h, d, mesh, axis=axis, hier=hier)
            ulysses.ulysses_attention(q, k, v, pos, plan)      # INIT, warm-up
            _build.reset_counts()
            got = ulysses.ulysses_attention(q, k, v, pos, plan)
            counts = _build.counts()
            ms = median_ms(lambda: ulysses.ulysses_attention(q, k, v, pos, plan),
                           iters=5, inner=1)
        ran = {kk: vv["launches"] for kk, vv in counts.items() if vv["launches"]}
        plain = {kk: vv["plain_calls"] for kk, vv in counts.items()
                 if vv["plain_calls"]}
        k2 = a2a_fence.FENCE_BULK.name
        if plain or ran.get(k2, 0) < 4 * (2 if hier else 1):
            raise AssertionError(f"ulysses {tag}: launches {ran}, plain {plain}")
        err, ref = (float((got.float() - want.float()).abs().max()),
                    float(want.float().abs().max()))
        if not (bool(torch.isfinite(got).all()) and err <= ULYSSES_TOL * ref):
            raise AssertionError(f"ulysses {tag}: max|diff| {err} (max {ref})")
        for kk, vv in ran.items():
            launches[kk] = launches.get(kk, 0) + vv
        out[tag] = {"mesh": list(shape), "axis": axis, "hier": hier,
                    "launches_per_call": ran,
                    "head_exchange_k2": 4 * (2 if hier else 1),
                    "positions_gather_launches": ran.get(k2, 0)
                    - 4 * (2 if hier else 1),
                    "bit_equal_to_attend": bool(torch.equal(got, want)),
                    "max_abs_diff": err, "max_abs_attend": ref, "ms": ms,
                    "over_attend": ms / attend_ms}
    return out, launches


def run_reduce_card(device) -> tuple[dict, dict]:
    """The pod-aware reduce on ``VirtualMesh((2, 4), ("pod", "data"))``
    over ``[8, 2048, 4096]`` fp32 (each rank's 32 MiB shard): plan-backed
    (a reduce-scatter fence epoch per pod, K2; the cross-pod sum; the
    allgatherv's bare gather), raw and flat, held against each other
    within rtol 1e-5 of max|flat|.  The INIT seconds of the plan pair on
    a fresh plan cache, the plan path's launches per call (counters zeroed
    just before, read just after) and each path's ms."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

    mesh = VirtualMesh((2, 4), ("pod", "data"))
    x = torch.randn(REDUCE_CARD, generator=torch.Generator(device=device)
                    .manual_seed(10), device=device)
    t0 = time.perf_counter()
    rs, ag, cap = collectives.plan_rs_ag_pair(REDUCE_CARD[1], REDUCE_CARD[2:],
                                              torch.float32, "data", mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    calls = {
        "plan": lambda: collectives.hierarchical_psum_mean(
            x, "data", "pod", scatter_dim=0, mesh=mesh),
        "raw": lambda: collectives.hierarchical_psum_mean(
            x, "data", "pod", scatter_dim=0),
        "flat": lambda: collectives.flat_psum_mean(x, ("pod", "data")),
    }
    out = {"shape": list(REDUCE_CARD), "dtype": "float32", "capacity": cap,
           "pair_init_seconds": init_s, "tolerance": "1e-5 x max|flat|"}
    with axis_rules(DEFAULT_RULES, mesh), torch.no_grad():
        res = {name: fn() for name, fn in calls.items()}
        _build.reset_counts()
        calls["plan"]()
        counts = _build.counts()
        for name, fn in calls.items():
            out[f"{name}_ms"] = median_ms(fn, iters=10, inner=1)
    ran = {k: v["launches"] for k, v in counts.items() if v["launches"]}
    plain = {k: v["plain_calls"] for k, v in counts.items() if v["plain_calls"]}
    if plain or ran != {k2_counter(rs): 2}:
        raise AssertionError(f"reduce: launches {ran}, plain {plain}")
    ref = float(res["flat"].abs().max())
    for name in ("plan", "raw"):
        err = float((res[name] - res["flat"]).abs().max())
        out[f"{name}_max_abs_diff"] = err
        if not err <= 1e-5 * ref:
            raise AssertionError(f"reduce {name} vs flat: {err} (max {ref})")
    out["launches_per_plan_call"] = ran
    return out, ran


def run_families_path(device) -> tuple[dict, dict, dict]:
    """Phase 12: Moonshot served, OLMo-1B served and held against the CPU,
    flash against direct, Ulysses, the pod-aware reduce.  Returns the
    readings, the launches of the counted runs by kernel, and K6's row at
    Moonshot's shape."""
    t_phase = time.perf_counter()
    out, launches = {}, {}

    def add(ran):
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    out["moonshot"], ran, k6 = run_moonshot_serve(device)
    out["moonshot"]["seconds"] = time.perf_counter() - t0
    add(ran)
    out["held_after_moonshot_gib"] = free_card()
    t0 = time.perf_counter()
    out["olmo"], ran = run_olmo_serve(device)
    out["olmo"]["seconds"] = time.perf_counter() - t0
    add(ran)
    free_card()
    t0 = time.perf_counter()
    out["flash_vs_direct"] = run_flash_vs_direct(device)
    out["flash_vs_direct"]["seconds"] = time.perf_counter() - t0
    free_card()
    t0 = time.perf_counter()
    out["ulysses"], ran = run_ulysses_card(device)
    out["ulysses"]["seconds"] = time.perf_counter() - t0
    add(ran)
    free_card()
    t0 = time.perf_counter()
    out["reduce"], ran = run_reduce_card(device)
    out["reduce"]["seconds"] = time.perf_counter() - t0
    add(ran)
    free_card()
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out, launches, k6


# ---------------------------------------------------------------------------
# Slice 14: the state-space, audio and vision families
# ---------------------------------------------------------------------------

# Served at S's batch on (1, 8): 4 x 128 prompt tokens, 16 generated;
# Whisper: 1500 stub frames (its 30 s window) and 8 prompt tokens, as the
# serve launchers make them; InternVL2: 256 stub patches and 128 text
# tokens.  Jamba at 8 of 32 layers (one whole period), InternVL2 at 24 of 48.
SSM = {"jamba_layers": 8, "internvl_layers": 24, "batch": 4, "prompt": 128,
       "tokens": 16, "mesh": (1, 8), "whisper_frames": 1500,
       "whisper_prompt": 8}
# The reduced configs (depth 8 for Jamba) on the card against the CPU.
SSM_VS_CPU = {"batch": 2, "prompt": 32, "tokens": 4, "frames": 256}
SSM_VS_CPU_TOL = 1e-3               # x max|logit|, float32, TF32 off
SSM_ARCHS = ("jamba-v0.1-52b", "xlstm-125m", "whisper-base", "internvl2-26b")


def family_inputs(cfg, b, s, seed, frames):
    """The serve inputs of ``cfg``'s family as numpy arrays, made as the
    serve launchers make them: tokens ``[b, s]``; audio: ``frames`` stub
    frames (normal x 0.02, float32) and the first 8 tokens; vlm:
    ``frontend_len`` stub patches (normal x 0.02) and the tokens.  Returns
    (arrays, prefill cache length, first decode position)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "audio":
        fr = (rng.standard_normal((b, frames, cfg.d_model)) * 0.02).astype(np.float32)
        tokens = tokens[:, :SSM["whisper_prompt"]]
        return (fr, tokens), frames, tokens.shape[1]
    if cfg.family == "vlm":
        pt = (rng.standard_normal((b, cfg.frontend_len, cfg.frontend_dim))
              * 0.02).astype(np.float32)
        n = cfg.frontend_len + s
        return (pt, tokens), n, n
    return (tokens,), s, s


def family_tensors(arrays, cfg, device) -> tuple:
    """The inputs on ``device``: tokens int32, frames float32 (the encoder
    runs in float32), patches in the weights' dtype."""
    import torch
    from repro_torch.configs.base import torch_dtype
    out = []
    for a in arrays:
        t = torch.as_tensor(a, device=device)
        if cfg.family == "vlm" and t.dim() == 3:
            t = t.to(torch_dtype(cfg.param_dtype))
        out.append(t)
    return tuple(out)


def family_bundles(cfg, mesh, b, prompt_len, max_seq):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps as steps_mod
    return (steps_mod.make_prefill_bundle(
                cfg, ShapeConfig("serve_prefill", "prefill", prompt_len, b), mesh),
            steps_mod.make_decode_bundle(
                cfg, ShapeConfig("serve_decode", "decode", max_seq, b), mesh))


def family_forwards(cfg, params, pre, dec, inputs, index0, max_seq, n_tokens):
    """Prefill and greedy decode through the bundles, returning every
    forward's last-position logits (float32, on the CPU), the tokens and
    the kept routing entries of every MoE call; the decode steps' logits
    come from ``transformer.forward`` (``whisper.decode`` for audio), the
    decode bundle's own function."""
    import torch
    from repro_torch.models import moe, transformer, whisper
    from repro_torch.parallel.sharding import axis_rules
    from repro_torch.serve.engine import grow_caches

    logits_all, toks = [], []
    with torch.no_grad(), moe.count_kept() as kept:
        logits, caches = pre(params, *inputs)
        caches = grow_caches(caches, max_seq)
        for i in range(n_tokens):
            logits_all.append(logits.float().cpu())
            nxt = torch.argmax(logits.float(), -1).to(torch.int32)[:, None]
            toks.append(nxt.cpu())
            if i + 1 == n_tokens:
                break
            with axis_rules(dec.rules, dec.mesh):
                if cfg.family == "audio":
                    lg, caches = whisper.decode(params, cfg, nxt, None,
                                                caches=caches,
                                                cache_index=index0 + i,
                                                remat=False)
                else:
                    lg, _, caches = transformer.forward(
                        params, cfg, nxt, moe_plan=dec.moe_plan, caches=caches,
                        cache_index=index0 + i)
            logits = lg[:, -1]
    return logits_all, torch.cat(toks, 1).numpy(), list(kept)


def bundle_generate(pre, dec, params, inputs, index0, max_seq, n_tokens):
    """``ServeEngine.generate``'s loop on the bundles alone (the vlm
    family, which neither engine serves): tokens, prefill seconds and
    decode seconds per token on the host clock, the card synchronised."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import grow_caches

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = pre(params, *inputs)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        caches = grow_caches(caches, max_seq)
        nxt = torch.argmax(logits.float(), -1).to(torch.int32)[:, None]
        out = [nxt.cpu().numpy()]
        t0 = time.perf_counter()
        for i in range(n_tokens - 1):
            nxt, caches = dec(params, caches, nxt, index0 + i)
            out.append(nxt.cpu().numpy())
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / max(n_tokens - 1, 1)
    return np.concatenate(out, 1), t_pre, t_dec


def serve_family(cfg, device, cut=None):
    """``cfg`` at full width served on ``VirtualMesh((1, 8))`` at S's
    batch, bf16 seeded weights drawn on the card: through
    ``ServeEngine.generate`` (audio with its stub frames), the vlm family
    through its prefill and decode bundles.  A warm-up of 2 tokens, then
    the counted run of 16 (counters zeroed just before, read just after),
    then the bf16 logits of a prefill and a decode step (not counted), all
    finite.  Returns (readings, launches by kernel, the engine or None,
    the params)."""
    import numpy as np
    import torch
    from repro_torch._tree import leaves
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine

    b, n = SSM["batch"], SSM["tokens"]
    arrays, prompt_len, index0 = family_inputs(cfg, b, SSM["prompt"], 0,
                                               SSM["whisper_frames"])
    max_seq = prompt_len + n + 8
    mesh = VirtualMesh(SSM["mesh"], ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = None
    if cfg.family == "vlm":
        params, _ = api.init_model(cfg, torch.Generator(device=device)
                                   .manual_seed(0), device)
        pre, dec = family_bundles(cfg, mesh, b, prompt_len, max_seq)
    else:
        eng = ServeEngine(cfg, mesh, batch=b, prompt_len=prompt_len,
                          max_seq=max_seq, seed=0)
        params, pre, dec = eng.params, eng.prefill_bundle, eng.decode_bundle
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    inputs = family_tensors(arrays, cfg, device)

    def generate(n_tok):
        if eng is None:
            return bundle_generate(pre, dec, params, inputs, index0, max_seq,
                                   n_tok)
        toks, st = eng.generate(arrays[-1], n_tok, frames=(
            arrays[0] if cfg.family == "audio" else None))
        return toks, st.prefill_seconds, st.decode_seconds_per_token

    generate(2)                                                # warm-up
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    toks, t_pre, t_dec = generate(n)
    counts = _build.counts()
    serve_peak = torch.cuda.max_memory_allocated()
    per_kernel = {k: v["launches"] for k, v in counts.items()}
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    want = {k: 0 for k in per_kernel}
    if n_moe:
        want["gather_matmul_wgmma"] = want[k2_counter(eng.moe_plan.a2a)] = (
            2 * n_moe * n)
    plain = {k: v["plain_calls"] for k, v in counts.items() if v["plain_calls"]}
    if per_kernel != want or plain:
        raise AssertionError(f"{cfg.name} serve: launches {per_kernel}, want "
                             f"{want}; plain versions called {plain}")
    if toks.shape != (b, n) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name} serve: tokens {toks.shape} out of range")
    logits, _, _ = family_forwards(cfg, params, pre, dec, inputs, index0,
                                   max_seq, 2)
    if not all(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all())
               for lg in logits):
        raise AssertionError(f"{cfg.name} serve: non-finite bf16 logits")
    total_s = t_pre + (n - 1) * t_dec
    result = {
        "config": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
        "cut": cut or "none: every layer",
        "params": sum(t.numel() for t in leaves(params)),
        "dtype": cfg.param_dtype, "mesh": list(SSM["mesh"]), "batch": b,
        "prefill_inputs": {k: list(v.shape) for k, v in
                           zip(("frames" if cfg.family == "audio" else "patches",
                                "tokens")[-len(inputs):], inputs)},
        "new_tokens": n, "driven_by": ("ServeEngine.generate" if eng is not None
                                       else "prefill and decode bundles"),
        "init_seconds": init_s, "init_peak_gib": init_peak / 2**30,
        "prefill_ms": t_pre * 1e3, "decode_ms_per_token": t_dec * 1e3,
        "decode_tokens_per_s": b / t_dec, "tokens_per_s": b * n / total_s,
        "launches_per_forward": {k: v // n for k, v in per_kernel.items() if v},
        "serve_peak_gib": serve_peak / 2**30, "logits_finite": True,
    }
    return result, per_kernel, eng, params


def family_vs_cpu(arch, device) -> dict:
    """``arch``'s reduced config (float32; Jamba at its 8 layers) on the
    card and on the CPU with the same weights and inputs, through the
    prefill and decode bundles on ``VirtualMesh((1, 8))``: every forward's
    logits within SSM_VS_CPU_TOL x max|logit|, equal greedy tokens and
    kept routing entries.  TF32 is off for float32 products."""
    import numpy as np
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.models import api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced(arch)
    b, n = SSM_VS_CPU["batch"], SSM_VS_CPU["tokens"]
    arrays, prompt_len, index0 = family_inputs(cfg, b, SSM_VS_CPU["prompt"], 1,
                                               SSM_VS_CPU["frames"])
    max_seq = prompt_len + n
    params, _ = api.init_model(cfg, torch.Generator(device=device).manual_seed(1),
                               device)
    runs = {}
    for dev in ("cuda", "cpu"):
        mesh = VirtualMesh(SSM["mesh"], ("data", "model"),
                           device=None if dev == "cuda" else "cpu")
        p = params if dev == "cuda" else tree_map(lambda t: t.cpu(), params)
        pre, dec = family_bundles(cfg, mesh, b, prompt_len, max_seq)
        runs[dev] = family_forwards(cfg, p, pre, dec,
                                    family_tensors(arrays, cfg, mesh.device),
                                    index0, max_seq, n)
    (lg_g, tok_g, kept_g), (lg_c, tok_c, kept_c) = runs["cuda"], runs["cpu"]
    errs = []
    for i, (a, c) in enumerate(zip(lg_g, lg_c)):
        a, c = a[:, :cfg.vocab_size], c[:, :cfg.vocab_size]
        err, ref = float((a - c).abs().max()), float(c.abs().max())
        errs.append(err / ref)
        if not err <= SSM_VS_CPU_TOL * ref:
            raise AssertionError(f"{arch} vs CPU: forward {i} logits differ by "
                                 f"{err} (max|logit| {ref})")
    if not np.array_equal(tok_g, tok_c) or kept_g != kept_c:
        raise AssertionError(f"{arch} vs CPU: tokens {tok_g.tolist()} vs "
                             f"{tok_c.tolist()}, kept {kept_g} vs {kept_c}")
    return {"config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": "float32", "batch": b, "prefill_len": prompt_len,
            "tokens": n, "tf32": False, "max_err_over_max_logit": max(errs),
            "kept_per_moe_call": kept_g, "greedy_tokens_equal": True}


def k6_jamba(eng) -> dict:
    """K6 at Jamba's served prefill shape on EP 8 (16 experts, 2 per rank,
    N = 8 ranks x the prefill plan's capacity, D 4096: 64 D-stages of the
    TMA weight ring, F 14336: 112 F-tiles) on the MoE layer's own row
    table, against its plain version (``k6_readings``): the first MoE
    slot's gate weights gated and timed, its up weights gated."""
    plan = eng.prefill_bundle.moe_plan
    e_loc = eng.cfg.moe.n_experts // plan.ep_size
    x, idx, valid, w_gate = k6_serve_inputs(
        eng.params, eng.device, plan.ep_size * plan.capacity, e_loc=e_loc,
        d=eng.cfg.d_model, slot="slot1")
    out = k6_readings("Jamba gate", x, idx, valid, w_gate)
    up = k6_readings("Jamba up", x, idx, valid,
                     eng.params["slot1"]["moe"]["w_up"][0], timed=False)
    out["up_max_abs_err"] = up["max_abs_err"]
    out["f_tiles"] = -(-w_gate.shape[2] // 128)
    out["d_stages"] = -(-w_gate.shape[1] // 64)
    out["w_bytes"] = w_gate.numel() * w_gate.element_size()
    return out


def run_ssm_families_path(device) -> tuple[dict, dict, dict, dict]:
    """Phase 13: Jamba-v0.1 (8 of 32 layers) served through the persistent
    MoE dispatch, K6 and K2 at its serve shapes; xLSTM-125m and
    Whisper-base whole and InternVL2-26B (24 of 48 layers) served; each
    family's reduced config on the card against the CPU.  One model on the
    card at a time.  Returns the readings, the launches of the counted runs
    by kernel, K6's row at Jamba's shape and K2's at its serve shapes."""
    import dataclasses

    from repro_torch.configs import get

    t_phase = time.perf_counter()
    out, launches = {}, {}
    cuts = {
        "jamba-v0.1-52b": (SSM["jamba_layers"],
                           "dataclasses.replace(get('jamba-v0.1-52b'), "
                           "n_layers=8): full width, 8 of 32 layers (one "
                           "period: 7 Mamba, attention at slot 4, 4 MoE)"),
        "internvl2-26b": (SSM["internvl_layers"],
                          "dataclasses.replace(get('internvl2-26b'), "
                          "n_layers=24): full width, 24 of 48 layers"),
    }
    k6 = k2 = None
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        cfg, cut = get(arch), None
        if arch in cuts:
            cfg, cut = dataclasses.replace(cfg, n_layers=cuts[arch][0]), cuts[arch][1]
        res, ran, eng, params = serve_family(cfg, device, cut)
        if arch == "jamba-v0.1-52b":
            k6 = k6_jamba(eng)
            k2 = time_serve_exchange({"prefill": eng.prefill_bundle.moe_plan,
                                      "decode": eng.moe_plan})
        del eng, params
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v
        out[f"held_after_{arch}_gib"] = free_card()
    t0 = time.perf_counter()
    out["vs_cpu"] = {arch: family_vs_cpu(arch, device) for arch in SSM_ARCHS}
    out["vs_cpu"]["tolerance"] = f"{SSM_VS_CPU_TOL} x max|logit|"
    out["vs_cpu"]["seconds"] = time.perf_counter() - t0
    free_card()
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out, launches, k6, k2


# ---------------------------------------------------------------------------
# Phase 14: resilience (slice 15)
# ---------------------------------------------------------------------------

# The skew monitor and ladder of parts (a) and (b), as the JAX dist cases
# replan_hot_swap and leader_rebake_recovery set them; the trainer's monitor
# is its own (warm-up 4, window 4, sustain 2, threshold 1.75).
RESILIENCE = {"mesh": (8, 8), "threshold": 1.6, "window": 4, "sustain": 2,
              "warmup": 6, "stall_from": 6, "stall_seconds": 0.03,
              "sweep_iters": 2, "slow": 3.0, "slow_weight": 0.05,
              "steady_epochs": 14, "deadline_s": 300}
# Part (d): the trainer's steps (warm-up 4 + two hot windows of 4 trip the
# monitor after step 11, two steps run on the re-elected schedule) and
# its chaos spec: 3x on a carrying leader from step 4, 5 % of that once
# demoted.
RESILIENCE_TRAIN = {"steps": 14, "slow": 3.0, "slow_from": 4,
                    "slow_weight": 0.05, "mesh": (2, 1, 4)}


def oracle_on_card(cfg):
    """The config's oracle on the card as int32 bits, rows past each rank's
    recv count zeroed, and the valid-row mask: a whole window compares with
    one ``torch.equal``, with no copy to the host."""
    import torch
    p, rr = cfg["p"], cfg["recv_rows"]
    n = torch.as_tensor(cfg["rc"].sum(axis=1), device=cfg["x"].device)
    mask = (torch.arange(rr, device=n.device)[None, :] < n[:, None])[..., None]
    want = torch.from_numpy(cfg["expect"]).to(n.device).view(torch.int32)
    return torch.where(mask, want, 0), mask


def equal_on_card(label, got, oracle) -> None:
    import torch
    want, mask = oracle
    got = got.view(want.shape[0], want.shape[1], -1).view(torch.int32)
    if not torch.equal(torch.where(mask, got, 0), want):
        raise AssertionError(f"{label}: valid rows differ from the oracle")


def carrying_ranks(plan) -> set:
    return {int(r) for rnd in plan.hier_schedule.round_perms
            for pair in rnd for r in pair}


def driven_since(label, before) -> dict:
    """``launches_since(before)``; raise if a plain version ran since the
    counter snapshot ``before``."""
    from repro_torch.kernels import _build

    after = _build.counts()
    plain = {k: after[k]["plain_calls"] - before[k]["plain_calls"]
             for k in after
             if after[k]["plain_calls"] != before[k]["plain_calls"]}
    if plain:
        raise AssertionError(f"{label}: plain versions called {plain}")
    return launches_since(before)


def add_launches(total, more) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def resilience_hot_swap(cfg, device, root) -> tuple[dict, dict]:
    """Part (a), the JAX case ``replan_hot_swap`` at B: an auto plan
    (``pack_impl="fused"``) on (8, 8) with a plan store; chaos stalls
    every epoch from epoch 6 on, a background ``ReplanManager`` re-plans
    on sustained skew (rung 1: the hierarchy plan's monitor names no rank),
    then ``force_swap`` to the sweep's runner-up.  Every epoch, before,
    during the sweep, across and after the swaps, bit-equal to the oracle;
    the sweep re-measured; the stored verdict carries the replan
    provenance; the old plan keeps no window slot, table or run table and
    ``memory_allocated`` falls by at least its window's bytes."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.core import (EXEC_TELEMETRY, INIT_STATS, PlanCache,
                                  alltoallv_init)
    from repro_torch.core.autotune import _candidate_spec, decision_signature
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.planstore import PlanStore
    from repro_torch.runtime import ChaosInjector, PlanSkewMonitor, ReplanManager

    R = RESILIENCE
    EXEC_TELEMETRY.reset()
    mesh = VirtualMesh(R["mesh"], ("o", "i"))
    oracle = oracle_on_card(cfg)
    store = PlanStore(os.path.join(root, "store"))
    cache = PlanCache()
    before = _build.counts()
    t0 = time.perf_counter()
    plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                          axis=("o", "i"), variant="auto", pack_impl="fused",
                          cache=cache, store=store,
                          autotune_iters=R["sweep_iters"])
    init_s = time.perf_counter() - t0
    free_except(cache, [plan])          # the INIT sweep's losers
    spec0 = plan.spec
    equal_on_card("hot swap: first epoch", plan.wait(plan.start(cfg["x"])),
                  oracle)
    sweeps0 = INIT_STATS.autotune_sweeps
    plan.record_starts = False          # the driver times whole epochs
    monitor = PlanSkewMonitor(EXEC_TELEMETRY.ring(plan.signature.digest),
                              threshold=R["threshold"], window=R["window"],
                              sustain=R["sustain"], warmup=R["warmup"])
    mgr = ReplanManager(plan, mesh, cache, store=store, monitor=monitor,
                        iters=R["sweep_iters"], background=True)
    inj = ChaosInjector(seed=0, stall_steps=range(R["stall_from"], 10_000),
                        stall_seconds=R["stall_seconds"])
    epochs, during_sweep = [], 0
    t_trigger = t_done = e_trigger = None
    deadline = time.time() + R["deadline_s"]
    for e in range(10_000):
        sweeping = mgr._thread is not None and mgr._thread.is_alive()
        t0 = time.perf_counter()
        inj.maybe_stall(e)
        cur = mgr.plan
        out = cur.wait(cur.start(cfg["x"]))
        dt = time.perf_counter() - t0
        cur.record_epoch(dt)
        epochs.append(dt)
        equal_on_card(f"hot swap: epoch {e}", out, oracle)
        during_sweep += sweeping
        stage = mgr._ladder_stage
        mgr.observe()
        if e_trigger is None and mgr._ladder_stage != stage:
            e_trigger, t_trigger = e, time.perf_counter()
        if e == R["stall_from"] + R["window"] - 1 and mgr.events:
            raise AssertionError("hot swap: one hot window triggered")
        if mgr.replans_completed >= 1:
            t_done = time.perf_counter()
            break
        if time.time() > deadline:
            raise AssertionError("hot swap: the re-plan never completed")
    cur = mgr.plan                      # the re-plan's plan, one epoch
    equal_on_card("hot swap: after the re-plan",
                  cur.wait(cur.start(cfg["x"])), oracle)
    del out
    if not (inj.injected["stall"] > 0 and during_sweep > 0
            and INIT_STATS.autotune_sweeps > sweeps0):
        raise AssertionError(f"hot swap: stalls {inj.injected['stall']}, "
                             f"epochs during the sweep {during_sweep}, "
                             f"sweeps {sweeps0} -> "
                             f"{INIT_STATS.autotune_sweeps}")
    sig = decision_signature(spec0, mesh)
    fresh = cache.auto_choices[(sig, mesh.device)]
    stored = store.get_auto(sig, mesh.device)
    if (fresh["replan"]["kind"] != "sustained_skew"
            or not fresh["replan"]["ratio"] > R["threshold"]
            or fresh["replan"]["prev_variant"] != spec0.variant
            or stored is None
            or stored["replan"]["ratio"] != fresh["replan"]["ratio"]):
        raise AssertionError(f"hot swap: verdict {fresh}, stored {stored}")
    replanned = mgr.events[-1]

    # The forced swap to the sweep's runner-up.
    live = mgr.plan
    times = {v.partition("@")[0]: t for v, t in fresh["times"].items()}
    runner = min((v for v in times if v != live.spec.variant), key=times.get)
    alt = cache.get(_candidate_spec(spec0, runner), mesh, store=store)
    window_bytes = sum(t.numel() * t.element_size()
                       for t in live.window._slots.values())
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if not mgr.force_swap(alt, reason="operator"):
        raise AssertionError("hot swap: force_swap installed nothing")
    swap_s = time.perf_counter() - t0
    held1 = torch.cuda.memory_allocated()
    if (live.window._slots or live._tables is not None or live.run_tables
            or live._pack is not None or live._packs is not None
            or live._stage2 is not None or mgr.plan is not alt):
        raise AssertionError("hot swap: the old plan kept its state")
    if not held0 - held1 >= window_bytes > 0:
        raise AssertionError(f"hot swap: memory fell {held0 - held1} bytes, "
                             f"the old window held {window_bytes}")
    for e2 in range(3):
        equal_on_card(f"hot swap: after the forced swap {e2}",
                      alt.wait(alt.start(cfg["x"])), oracle)
    swap = EXEC_TELEMETRY.swaps[-1]
    if swap["variant_to"] != runner or swap["new"] != alt.signature.digest:
        raise AssertionError(f"hot swap: swap log {swap}")
    mgr.close()
    launches = driven_since("hot swap", before)
    for pl in cache._plans.values():
        pl.free()
    pre = statistics.median(epochs[1:R["stall_from"]])
    out = {"mesh": list(R["mesh"]), "init_seconds": init_s,
           "initial_variant": spec0.variant, "initial_times_ms": {
               k: v * 1e3 for k, v in (plan.auto_choice or {}).get(
                   "times", {}).items()},
           "replan": {"event": replanned["event"],
                      "variant_to": replanned.get("variant_to",
                                                  live.spec.variant),
                      "times_ms": {k: v * 1e3 for k, v in
                                   fresh["times"].items()},
                      "ratio": fresh["replan"]["ratio"]},
           "epochs_to_trigger": e_trigger,
           "epochs_after_injection_to_trigger": e_trigger - R["stall_from"] + 1,
           "replan_seconds": t_done - t_trigger,
           "epochs_during_sweep": during_sweep,
           "epoch_ms_p50_before_stall": pre * 1e3,
           "forced": {"from": live.spec.variant, "to": runner,
                      "swap_seconds": swap_s,
                      "window_bytes": window_bytes,
                      "memory_fell_bytes": held0 - held1},
           "events": [(ev["event"], ev.get("kind")) for ev in mgr.events],
           "stalls": inj.injected["stall"]}
    return out, launches


def resilience_leader_rebake(cfg, device) -> tuple[dict, dict, int]:
    """Part (b), the JAX case ``leader_rebake_recovery`` at B,
    ``fence_hierarchy`` x ``fused`` on (8, 8): ``rank_slow`` 3.0 on a
    carrying leader from epoch 6 (weight 0.05 once demoted) trips the
    monitor, whose rank attribution names it; rung 0 and nothing above it
    (one schedule bake, no autotune burst); the slow rank leaves the
    carrying set; every epoch bit-equal to the oracle; on the re-baked
    plan K5 launches under the new permutation, and then K1, K2 and K5 on
    its tables are held bytes-equal to their plain versions
    (``check_hier_at_main_shapes``).  The epoch p50 before injection,
    while slowed and after the re-bake are readings, not gates: the stall
    is a host sleep over a ~1 ms epoch."""
    from repro_torch.kernels import _build
    from repro_torch.core import (EXEC_TELEMETRY, INIT_STATS, PlanCache,
                                  alltoallv_init)
    from repro_torch.core import metadata as md
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.runtime import ChaosInjector, PlanSkewMonitor, ReplanManager

    R = RESILIENCE
    EXEC_TELEMETRY.reset()
    mesh = VirtualMesh(R["mesh"], ("o", "i"))
    oracle = oracle_on_card(cfg)
    cache = PlanCache()
    before = _build.counts()
    plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                          axis=("o", "i"), variant="fence_hierarchy",
                          pack_impl="fused", cache=cache)
    equal_on_card("leader re-bake: first epoch",
                  plan.wait(plan.start(cfg["x"])), oracle)
    bursts0, bakes0 = INIT_STATS.autotune_bursts, INIT_STATS.table_bakes
    slow = min(carrying_ranks(plan))
    inj = ChaosInjector(seed=0, rank_slow={slow: R["slow"]},
                        rank_slow_from=R["stall_from"],
                        rank_slow_weight=R["slow_weight"])
    monitor = PlanSkewMonitor(EXEC_TELEMETRY.ring(plan.signature.digest),
                              threshold=R["threshold"], window=R["window"],
                              sustain=R["sustain"], warmup=R["warmup"],
                              digest=plan.signature.digest)
    mgr = ReplanManager(plan, mesh, cache, monitor=monitor, background=False)

    def run_epoch(e):
        cur = mgr.plan
        cur.record_starts = False
        t0 = time.perf_counter()
        out = cur.wait(cur.start(cfg["x"]))
        work = time.perf_counter() - t0
        extra = inj.maybe_rank_stall(e, carrying_ranks(cur), work)
        cur.record_epoch(work + extra)
        for r, t in inj.scale_rank_times(
                e, {r: work for r in range(cur.p)}).items():
            EXEC_TELEMETRY.record_rank(cur.signature.digest, r, t)
        equal_on_card(f"leader re-bake: epoch {e}", out, oracle)
        return work + extra

    times, deadline = [], time.time() + R["deadline_s"]
    for e in range(10_000):
        times.append(run_epoch(e))
        t0 = time.perf_counter()
        mgr.observe()
        if mgr.replans_completed >= 1:
            rebake_s = time.perf_counter() - t0
            break
        if time.time() > deadline:
            raise AssertionError("leader re-bake never installed")
    ev, new = mgr.events[-1], mgr.plan
    if (mgr.leader_rebakes != 1 or ev["event"] != "swap"
            or ev["kind"] != "leader_rebake" or ev["worst_rank"] != slow
            or new.spec.variant != "fence_hierarchy"
            or slow in carrying_ranks(new)
            or INIT_STATS.autotune_bursts != bursts0
            or INIT_STATS.table_bakes != bakes0 + 1
            or plan.window._slots or plan._tables is not None
            or EXEC_TELEMETRY.rank_summary(new.signature.digest)):
        raise AssertionError(f"leader re-bake: events {mgr.events}, bursts "
                             f"{INIT_STATS.autotune_bursts - bursts0}, bakes "
                             f"{INIT_STATS.table_bakes - bakes0}")
    e_swap = e
    steady, k5_before = [], _build.counts()
    for e2 in range(e_swap + 1, e_swap + 1 + R["steady_epochs"]):
        dt = run_epoch(e2)
        if e2 >= e_swap + 4:
            steady.append(dt)
        mgr.observe()
    steady_launches = driven_since("leader re-bake steady", k5_before)
    if steady_launches.get("a2a_hier", 0) != R["steady_epochs"]:
        raise AssertionError(f"leader re-bake: K5 launched "
                             f"{steady_launches} in {R['steady_epochs']} "
                             "epochs on the re-baked plan")
    launches = driven_since("leader re-bake", before)
    mgr.close()
    perm = [list(r) for r in new.spec.hier_leader_perm]
    if md.leader_perm_is_identity(new.spec.hier_leader_perm):
        raise AssertionError("leader re-bake: identity permutation")
    cases = check_hier_at_main_shapes(
        {f"B:fence_hierarchy8x8xfused re-baked {perm}": (new, cfg)})
    pre = statistics.median(times[1:R["stall_from"]])
    slowed = statistics.median(times[R["stall_from"]:e_swap + 1])
    post = statistics.median(steady)
    out = {"mesh": list(R["mesh"]), "slow_rank": slow, "factor": R["slow"],
           "weight": R["slow_weight"], "leader_perm": perm,
           "epochs_to_rebake": e_swap,
           "rebake_seconds": rebake_s,
           "schedule_bakes": 1, "autotune_bursts": 0,
           "epoch_ms_p50": {"before_injection": pre * 1e3,
                            "slowed": slowed * 1e3,
                            "after_rebake": post * 1e3},
           "after_over_before": post / pre,
           "k5_launches_on_rebaked_plan": steady_launches["a2a_hier"],
           "kernels_vs_plain_cases": cases,
           "events": [ev["event"] for ev in mgr.events],
           "rank_slow_injections": inj.injected["rank_slow"]}
    for pl in cache._plans.values():
        pl.free()
    return out, launches, cases


def resilience_chaos(cfg, device, root) -> tuple[dict, dict]:
    """Part (c), the JAX case ``chaos_recovery`` at A (P=8, ``fence`` x
    ``fused``): window-allocation failures retried, every store entry
    poisoned and read as a miss, an ``fsremote://...?fail_rate=`` store
    degrading to misses, step and device-loss faults through
    ``run_with_recovery`` (device loss rebuilds the plan first).  Gates:
    each kind's counter fired; every epoch bit-equal to the oracle."""
    from repro_torch.kernels import _build
    from repro_torch.core import INIT_STATS, PlanCache, WindowCache, alltoallv_init
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.planstore import parse_store_url
    from repro_torch.runtime import (ChaosError, ChaosInjector, RetryPolicy,
                                     classify_failure, run_with_recovery)

    mesh = VirtualMesh((cfg["p"],), ("x",))
    oracle = oracle_on_card(cfg)
    store = parse_store_url(
        f"fsremote://{root}/remote?fail_rate=0.25&seed=11")
    inj = ChaosInjector(seed=3, window_fail_rate=0.5, fail_steps=(4,),
                        device_loss_steps=(8,), stall_steps=(6,),
                        stall_seconds=0.05)
    state = {"rebuilds": 0, "plan_rebuild_hook": 0, "attempts": 0}
    before = _build.counts()

    def rebuild(err=None):
        for _ in range(50):
            state["attempts"] += 1
            try:
                cache = PlanCache(
                    window_cache=inj.wrap_window_cache(WindowCache()))
                if "plan" in state:
                    state["plan"].free()
                state["plan"] = alltoallv_init(
                    cfg["counts"], (FEATURE,), "float32", mesh, axis="x",
                    variant="fence", pack_impl="fused", cache=cache,
                    store=store)
                state["rebuilds"] += 1
                return
            except ChaosError:
                continue
        raise AssertionError("chaos: window allocation never succeeded")

    rebuild()
    poisoned = inj.poison_store(store)
    INIT_STATS.reset()
    done = set()

    def run_step(step):
        inj.step_hook(step)
        plan = state["plan"]
        equal_on_card(f"chaos: step {step}",
                      plan.wait(plan.start(cfg["x"])), oracle)
        done.add(step)
        return {}

    def rebuild_plans(err):
        state["plan_rebuild_hook"] += 1
        if classify_failure(err) != "device_loss":
            raise AssertionError(f"chaos: {err} is not device loss")
        rebuild(err)

    policy = RetryPolicy(max_restarts=5, backoff_seconds=0.0, decay_after=2)
    final = run_with_recovery(
        run_step, restore=lambda: (max(done) + 1) if done else 0,
        start_step=0, n_steps=12, policy=policy, rebuild_plans=rebuild_plans)
    launches = driven_since("chaos", before)
    s = INIT_STATS.as_dict()
    fired = {k: v for k, v in inj.injected.items() if k != "rank_slow"}
    if (final != 12 or done != set(range(12)) or not all(fired.values())
            or inj.injected["step"] != 1 or inj.injected["device"] != 1
            or state["plan_rebuild_hook"] != 1 or state["rebuilds"] < 2
            or s["store_invalid"] + store.errors < 1 or s["cold_inits"] < 1
            or policy.restarts > 1):
        raise AssertionError(f"chaos: final {final}, injected {inj.injected}"
                             f", state {state}, init {s}, store "
                             f"{store.stats}, restarts {policy.restarts}")
    state["plan"].free()
    return ({"injected": dict(inj.injected), "poisoned": poisoned,
             "rebuilds": state["rebuilds"],
             "allocation_attempts": state["attempts"],
             "restarts_left": policy.restarts, "init_stats": s,
             "store": {k: store.stats[k] for k in ("hits", "misses",
                                                   "invalid", "errors")}},
            launches)


@contextlib.contextmanager
def moe_pack_impl(impl):
    """``make_train_bundle`` builds the MoE dispatch with
    ``MoEDispatchPlan.build``'s default ``pack_impl="jnp"``, as the JAX
    bundle does (neither takes another); inside this block every build
    uses ``impl``, so a trainer's bundle and its rebuilds run the
    hierarchy's packs on K1 and its stage 2 on K5."""
    from repro_torch.models import moe

    build = moe.MoEDispatchPlan.__dict__["build"]

    def with_impl(*a, **kw):
        return build.__func__(*a, **{**kw, "pack_impl": impl})

    moe.MoEDispatchPlan.build = staticmethod(with_impl)
    try:
        yield
    finally:
        moe.MoEDispatchPlan.build = build


def k5_at_plan(label, plan, device) -> float:
    """K5 against its plain version on a hierarchy plan's own tables, at
    its rows' shape: the s1 pack (K1) and stage 1 (K2) of a seeded send
    buffer feed it.  Returns ``max_abs_err`` (0: bytes equal)."""
    import torch
    from repro_torch.kernels import a2a_fence, a2a_hier, gather_rows

    sched, t = plan.hier_schedule, plan.compile()._tables
    gen = torch.Generator(device=device).manual_seed(14)
    x = torch.randn(plan.global_send_shape, generator=gen, device=device
                    ).to(plan.dtype).view(plan.p, plan.send_rows, -1)
    s1_send = gather_rows.gather_rows(x, t[0], t[1],
                                      runs=plan.run_tables.get("s1"))
    s1 = a2a_fence.rma_alltoallv_fence(s1_send, sched.p_inner, sched.s1_cap,
                                       sched.p_outer)
    got = a2a_hier.rma_hier_leader_exchange(s1, t[2], t[3], t[8], t[9])
    want = a2a_hier.rma_hier_leader_exchange_plain(s1, t[2], t[3], t[8], t[9])
    expect_same(label, got, want)
    return float((got.float() - want.float()).abs().max())


def resilience_train_rebake(device, t_setup) -> tuple[dict, dict]:
    """Part (d): OLMoE-1B-7B at T's width, 4 layers and batch on
    ``VirtualMesh((2, 1, 4))`` under ``hier_ep`` (EP 8 over (pod, model)),
    ``fence_hierarchy`` x ``fused`` (K5 in the model), 14 steps twice: a
    clean run, then ``TrainerConfig(replan=True)`` with ``rank_slow`` 3.0
    on a carrying leader from step 4.  Gates: one ``leader_rebake`` event
    whose permutation drops the slow rank from the carrying set; every
    step's loss bit-equal to the clean run's; K5 and K6 launched in the
    steps after the swap, and K5 on the re-baked plan at the model's shape
    bytes-equal to its plain version; no plain version on the path."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import _build
    from repro_torch.core import EXEC_TELEMETRY, reset_global_plan_cache
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.parallel.sharding import RULE_PROFILES
    from repro_torch.runtime import ChaosInjector
    from repro_torch.train import ScheduleConfig, Trainer, TrainerConfig

    RT = RESILIENCE_TRAIN
    cfg0, shape, _, _ = t_setup
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, a2a_variant="fence_hierarchy"))
    mesh = VirtualMesh(RT["mesh"], ("pod", "data", "model"))
    n = RT["steps"]
    sched = ScheduleConfig(kind="cosine", peak_lr=3e-4,
                           warmup_steps=max(n // 10, 1), total_steps=n,
                           decay_steps=max(n // 5, 1))

    def train(tcfg, chaos=None, hook=None):
        with moe_pack_impl("fused"):
            bundle = steps_mod.make_train_bundle(
                cfg, shape, mesh, sched=sched, rules=RULE_PROFILES["hier_ep"])
            run = Trainer(bundle, tcfg, chaos=chaos)
            t0 = time.perf_counter()
            result = run.run(failure_hook=hook)
        return run, result, time.perf_counter() - t0

    before = _build.counts()
    clean, _, clean_s = train(TrainerConfig(n_steps=n, log_every=100, seed=0))
    clean_losses = [h["loss"] for h in clean.history]
    clean_times = [float(t) for t in
                   clean._backing_a2a().epoch_ring.last(n)]
    slow = min(carrying_ranks(clean._backing_a2a()))
    del clean
    reset_global_plan_cache()
    gc.collect()
    torch.cuda.empty_cache()

    spec = (f"rank_slow={slow}:{RT['slow']},rank_slow_from={RT['slow_from']},"
            f"rank_slow_weight={RT['slow_weight']}")
    snaps = {}

    def hook(step):
        snaps[step] = _build.counts()

    # The clean run fed the same plan's rank rings: the chaos run starts
    # from none, as a fresh process would.
    EXEC_TELEMETRY.reset()
    torch.cuda.reset_peak_memory_stats()
    run, result, chaos_s = train(
        TrainerConfig(n_steps=n, log_every=100, seed=0, replan=True),
        chaos=ChaosInjector.parse(spec), hook=hook)
    peak = torch.cuda.max_memory_allocated()
    launches = driven_since("trainer rung 0", before)
    events = result["replans"]
    if len(events) != 1 or events[0]["kind"] != "leader_rebake" \
            or events[0]["worst_rank"] != slow:
        raise AssertionError(f"trainer rung 0: events {events}")
    ev = events[0]
    a2a = run._backing_a2a()
    if slow in carrying_ranks(a2a) or \
            [list(r) for r in a2a.spec.hier_leader_perm] != ev["leader_perm"]:
        raise AssertionError(f"trainer rung 0: plan perm "
                             f"{a2a.spec.hier_leader_perm}, event {ev}")
    losses = [h["loss"] for h in run.history]
    if losses != clean_losses:
        raise AssertionError(f"trainer rung 0: losses {losses} differ from "
                             f"the clean run's {clean_losses}")
    after = driven_since("trainer rung 0 after the swap",
                         snaps[ev["step"] + 1])
    if not (after.get("a2a_hier") and after.get("gather_matmul_wgmma")):
        raise AssertionError(f"trainer rung 0: launched {after} after the "
                             "swap")
    times = [float(t) for t in a2a.epoch_ring.last(n - ev["step"] - 1)]
    k5_err = k5_at_plan("trainer rung 0: K5 at the model's shape", a2a,
                        device)
    steps_after = n - ev["step"] - 1
    out = {"config": cfg.name, "layers": cfg.n_layers, "mesh": list(RT["mesh"]),
           "rules": "hier_ep", "variant": "fence_hierarchy",
           "pack_impl": a2a.spec.pack_impl, "steps": n, "chaos": spec,
           "event": {k: ev[k] for k in ("step", "worst_rank", "leader_perm",
                                         "ratio", "worst_rank_ratio",
                                         "seconds")},
           "losses": losses, "losses_equal_clean": True,
           "clean_step_seconds": clean_times,
           "step_ms_clean_median_2_14": statistics.median(clean_times[1:]) * 1e3,
           "step_ms_after_rebake": [t * 1e3 for t in times],
           "clean_run_seconds": clean_s, "chaos_run_seconds": chaos_s,
           "peak_memory_gib": peak / 2**30,
           "launches_per_step_after_swap": {k: v / steps_after
                                            for k, v in after.items()},
           "k5_at_model_shape": {"rows": [a2a.p, a2a.send_rows,
                                          a2a.spec.feature_shape[0]],
                                 "dtype": str(a2a.dtype),
                                 "max_abs_err": k5_err},
           "injected": result["chaos"]}
    del run
    reset_global_plan_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def resilience_train_forced(device, t_setup, t_losses) -> tuple[dict, dict]:
    """Part (e): T on (1, 8) with the MoE's ``a2a_variant="auto"`` and
    ``replan_at=2``, T's 6 steps.  Gates: one ``forced`` event; a hot swap
    exactly when the sandbox's verdict changes the variant; losses
    bit-equal to T's."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import _build
    from repro_torch.core import reset_global_plan_cache
    from repro_torch.launch import steps as steps_mod
    from repro_torch.train import Trainer, TrainerConfig

    cfg0, shape, mesh, sched = t_setup
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, a2a_variant="auto"))
    n = TRAIN["steps"]
    before = _build.counts()
    t0 = time.perf_counter()
    bundle = steps_mod.make_train_bundle(cfg, shape, mesh, sched=sched)
    bundle_s = time.perf_counter() - t0
    initial = bundle.moe_plan.a2a.auto_choice
    run = Trainer(bundle, TrainerConfig(n_steps=n, log_every=100, seed=0,
                                        replan_at=2))
    result = run.run()
    launches = driven_since("trainer forced re-plan", before)
    events = result["replans"]
    if len(events) != 1 or events[0]["kind"] != "forced":
        raise AssertionError(f"forced re-plan: events {events}")
    ev = events[0]
    if ev["swapped"] != (ev["variant_to"] != ev["variant_from"]) or \
            run.moe_plan.variant != ev["variant_to"]:
        raise AssertionError(f"forced re-plan: event {ev}, live "
                             f"{run.moe_plan.variant}")
    losses = [h["loss"] for h in run.history]
    if losses != t_losses:
        raise AssertionError(f"forced re-plan: losses {losses} differ from "
                             f"T's {t_losses}")
    out = {"mesh": list(TRAIN["mesh"]), "steps": n, "bundle_seconds": bundle_s,
           "initial": {"variant": initial["variant"],
                       "times_ms": {k: v * 1e3
                                    for k, v in initial["times"].items()}},
           "event": {k: ev[k] for k in ("step", "variant_from", "variant_to",
                                         "swapped", "seconds")},
           "losses": losses, "losses_equal_T": True}
    del run, bundle
    reset_global_plan_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def run_resilience_path(device, t_losses, elastic) -> tuple[dict, dict]:
    """Phase 14: parts (a)-(e) here, (f) in phase 10 (``elastic``, with
    its launches).  Returns the readings and the launches of every driven
    part, by kernel (checks against the plain versions excluded)."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.testing.patterns import hugetrace_like_counts

    t_phase = time.perf_counter()
    out, launches = {}, {}
    root = tempfile.mkdtemp(prefix="resilience-")
    try:
        a = make_config("A", np.full((8, 8), 1024, np.int64), device)
        b = make_config("B", hugetrace_like_counts(64, 64), device)
        t0 = time.perf_counter()
        out["hot_swap_B"], ran = resilience_hot_swap(b, device, root)
        out["hot_swap_B"]["seconds"] = time.perf_counter() - t0
        add_launches(launches, ran)
        free_card()
        t0 = time.perf_counter()
        out["leader_rebake_B"], ran, _ = resilience_leader_rebake(b, device)
        out["leader_rebake_B"]["seconds"] = time.perf_counter() - t0
        add_launches(launches, ran)
        t0 = time.perf_counter()
        out["chaos_A"], ran = resilience_chaos(a, device, root)
        out["chaos_A"]["seconds"] = time.perf_counter() - t0
        add_launches(launches, ran)
        del a, b
        free_card()
        t_setup = train_setup(device)
        t0 = time.perf_counter()
        out["trainer_rung0"], ran = resilience_train_rebake(device, t_setup)
        out["trainer_rung0"]["seconds"] = time.perf_counter() - t0
        add_launches(launches, ran)
        t0 = time.perf_counter()
        out["trainer_forced"], ran = resilience_train_forced(
            device, t_setup, t_losses)
        out["trainer_forced"]["seconds"] = time.perf_counter() - t0
        add_launches(launches, ran)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["elastic"] = elastic
    add_launches(launches, elastic["launches"])
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out, launches


# ---------------------------------------------------------------------------
# Phase 15: the rest of training (slice 16)
# ---------------------------------------------------------------------------

# The lossy codecs' declared tolerance (admits bf16, int8 and fp8); steps of
# parts (c) and (e); Moonshot's depth (train_4k's batch, seq and mesh are
# T's).
TRAIN_REST = {"codec_tol": 0.1, "codec_steps": 2, "moonshot_layers": 2,
              "timing_iters": 5}
# K2 launches per MoE layer and step under each codec: int8's wire rows
# carry no gradient, so neither exchange runs in the backward.
TRAIN_REST_K2_PER_LAYER = {"bf16": 6, "int8": 4, "fp8": 6}


@contextlib.contextmanager
def plain_exchanges():
    """Send the plan epochs' K1, K2 and K4 calls to their plain versions
    on the card (the yardstick of part (d))."""
    import torch
    from repro_torch.kernels import a2a_fence, a2a_lock, gather_rows, ops

    def plain_gather(x, idx, valid, out=None, *, x2=None, runs=None):
        return gather_rows.gather_rows_plain(
            x if x2 is None else torch.cat([x, x2], dim=1), idx, valid, out)

    saved = ops.rma_alltoallv_fence, ops.rma_alltoallv_lock, ops.gather_rows
    ops.rma_alltoallv_fence = a2a_fence.rma_alltoallv_fence_plain
    ops.rma_alltoallv_lock = a2a_lock.rma_alltoallv_lock_plain
    ops.gather_rows = plain_gather
    try:
        yield
    finally:
        (ops.rma_alltoallv_fence, ops.rma_alltoallv_lock,
         ops.gather_rows) = saved


def rest_train_run(label, cfg, steps, want_per_step, mesh_dims=None):
    """``make_train_bundle`` and ``Trainer`` for ``steps`` steps of T's
    shape (no checkpoint), counters zeroed just before the run and read
    just after: exactly ``want_per_step`` (by counter, as a function of the
    bundle's MoE plan) times ``steps``, no plain version.  Returns the
    trainer, the row and the launches."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as steps_mod
    from repro_torch.train import Trainer, TrainerConfig

    _, shape, mesh, sched = train_setup(None)
    t0 = time.perf_counter()
    bundle = steps_mod.make_train_bundle(cfg, shape, mesh,
                                         sched=sched_for(sched, steps))
    bundle_s = time.perf_counter() - t0
    plan = bundle.moe_plan
    run = Trainer(bundle, TrainerConfig(n_steps=steps, ckpt_dir=None,
                                        log_every=1, seed=0))
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    run.run()
    counts = _build.counts()
    peak = torch.cuda.max_memory_allocated()
    got = {k: v["launches"] for k, v in counts.items() if v["launches"]}
    plain = {k: v["plain_calls"] for k, v in counts.items()
             if v["plain_calls"]}
    want = {k: v * steps for k, v in want_per_step(plan).items()}
    if got != want or plain:
        raise AssertionError(f"{label}: launches {got}, want {want}; plain "
                             f"versions called {plain}")
    losses = [h["loss"] for h in run.history]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: losses {losses}")
    times = [float(t) for t in plan.a2a.epoch_ring.last(steps)]
    step_s = statistics.median(times[1:])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    row = {"variant": plan.variant, "codec": plan.codec,
           "wire_row_bytes": plan.a2a.wire_row_bytes,
           "moe_plan": {"ep": plan.ep_size, "t_loc": plan.tokens_per_shard,
                        "capacity": plan.capacity,
                        "experts_per_rank": plan.e_local},
           "bundle_seconds": bundle_s, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in run.history],
           "step_seconds": times, "step_ms_median_2_n": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "peak_memory_gib": peak / 2**30,
           "launches_per_step": {k: v // steps for k, v in got.items()}}
    return run, bundle, row, got


def sched_for(sched, steps):
    """``sched`` for ``steps`` steps, as the launcher makes it."""
    import dataclasses
    return dataclasses.replace(sched, warmup_steps=max(steps // 10, 1),
                               total_steps=steps,
                               decay_steps=max(steps // 5, 1))


def add_counts(total, more) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def rest_codec_grads(codec, run, bundle) -> dict:
    """One gradient of T's loss from the trained state under ``codec``:
    int8's expert weights exactly zero and its router's finite and
    non-zero; every fp8 gradient finite."""
    import torch
    from repro_torch._tree import leaves_with_paths
    from repro_torch.models import api as model_api
    from repro_torch.train import grad as grad_util

    cfg = bundle.meta["cfg"]

    def loss_fn(p, b):
        return model_api.model_loss(p, cfg, b, moe_plan=bundle.moe_plan,
                                    remat=True)

    with bundle.trace_context():
        _, _, grads = grad_util.value_and_grad(
            loss_fn, run.params, run.pipe.batch_at(TRAIN_REST["codec_steps"]))
    moe_g = grads["slot0"]["moe"]
    out = {name: float(moe_g[name].float().abs().max())
           for name in ("router", "w_gate", "w_up", "w_down")}
    finite = all(bool(torch.isfinite(g).all())
                 for _, g in leaves_with_paths(grads))
    if not finite:
        raise AssertionError(f"train rest {codec}: a non-finite gradient")
    if not (0 < out["router"] and math.isfinite(out["router"])):
        raise AssertionError(f"train rest {codec}: router gradient {out}")
    if codec == "int8" and any(out[n] != 0 for n in ("w_gate", "w_up",
                                                       "w_down")):
        raise AssertionError(f"train rest int8: expert gradients {out}, "
                             "want exactly zero")
    return {"max_abs": out, "all_finite": finite}


def rest_vjp_plans(device):
    """Part (d)'s plans and send buffers: A's and B's fence and lock
    (``jnp``), B's (8, 8) hierarchy (``jnp``, ``pallas``), G's allgatherv
    and reduce-scatter; label -> (plan, x, the launches one backward makes
    by design)."""
    import numpy as np
    import torch
    from repro_torch.core import (PlanCache, allgatherv_init, alltoallv_init,
                                  reduce_scatter_init)
    from repro_torch.kernels import a2a_fence, a2a_lock
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.testing.patterns import hugetrace_like_counts, ragged_counts

    def k2(plan, rows_bytes):
        return a2a_fence.fence_cuda_kernel(rows_bytes, plan.capacity).name

    out = {}
    for name, counts in (("A", np.full((8, 8), 1024, np.int64)),
                         ("B", hugetrace_like_counts(64, 64))):
        cfg = make_config(name, counts, device)
        mesh = VirtualMesh((cfg["p"],), ("x",))
        for variant in ("fence", "lock"):
            plan = alltoallv_init(counts, (FEATURE,), "float32", mesh,
                                  axis="x", variant=variant, embeddable=True,
                                  cache=PlanCache())
            rb = plan.row_bytes
            want = ({k2(plan, rb): 1} if variant == "fence" else
                    {a2a_lock.cuda_kernel(rb).name: 1})
            out[f"{name}:{variant}xjnp"] = (plan, cfg["x"], want)
        if name == "B":
            vm = VirtualMesh((8, 8), ("o", "i"))
            for impl in ("jnp", "pallas"):
                plan = alltoallv_init(counts, (FEATURE,), "float32", vm,
                                      axis=("o", "i"),
                                      variant="fence_hierarchy",
                                      pack_impl=impl, embeddable=True,
                                      cache=PlanCache())
                want = {k2(plan, plan.row_bytes): 1}
                if impl == "pallas":
                    want["gather_rows_runs"] = 2
                out[f"B:fence_hierarchy8x8x{impl}"] = (plan, cfg["x"], want)
    counts = ragged_counts(G["p"], seed=5) * G["scale"]
    f = G["feature"]
    for k, (coll, variant) in enumerate(PATTERN_RUNS):
        if variant == "fence_hierarchy":
            mesh, axis = VirtualMesh(G["hier_mesh"], ("o", "i")), ("o", "i")
        else:
            mesh, axis = VirtualMesh((G["p"],), ("x",)), "x"
        init = allgatherv_init if coll == "allgatherv" else reduce_scatter_init
        plan = init(counts, (f,), "float32", mesh, axis=axis, variant=variant,
                    cache=PlanCache())
        gen = torch.Generator(device=device).manual_seed(40 + k)
        x = torch.randn((plan.p * plan.send_rows, f), generator=gen,
                        device=device)
        # The allgatherv's backward is the reduce-scatter over the same
        # counts (a fence for its hierarchy): one K2; the reduce-scatter's
        # is the allgatherv, plain tensor ops.
        want = ({k2(plan, 4 * f): 1} if coll == "allgatherv"
                and variant != "lock" else {})
        out[f"G:{coll}x{variant}"] = (plan, x, want)
    return out


def run_rest_vjps(device) -> tuple[dict, dict]:
    """Part (d): each plan's embedded epoch forward and backward, launches
    counted around each; the gradient bytes-equal to the same backward run
    by the plain versions (``plain_exchanges``); forward and backward ms
    (``median_ms``: the card idle at the first call, and queued behind a
    GPU sleep, the device's time alone)."""
    import torch

    rows, launches = {}, {}
    for label, (plan, x, want) in rest_vjp_plans(device).items():
        fn = plan.embed()
        xg = x.detach().clone().requires_grad_(True)
        y, fwd = counted(lambda: fn(xg))
        gen = torch.Generator(device=device).manual_seed(7)
        ct = torch.randn(y.shape, generator=gen, device=device)
        (gx,), bwd = counted(lambda: torch.autograd.grad(y, xg, ct,
                                                         retain_graph=True))
        if bwd != want:
            raise AssertionError(f"train rest vjp {label}: backward launches "
                                 f"{bwd}, want {want}")
        with plain_exchanges():
            xp = x.detach().clone().requires_grad_(True)
            yp = plan.embed()(xp)
            (gp,) = torch.autograd.grad(yp, xp, ct)
        expect_same(f"train rest vjp {label} forward", y.detach(), yp.detach())
        expect_same(f"train rest vjp {label} backward", gx, gp)
        add_counts(launches, fwd)
        add_counts(launches, bwd)
        it = TRAIN_REST["timing_iters"]

        def backward():
            torch.autograd.grad(y, xg, ct, retain_graph=True)

        with torch.no_grad():
            fwd_t = {"ms": median_ms(lambda: fn(x), iters=it),
                     "queued_ms": median_ms(lambda: fn(x), iters=it,
                                            queued=True)}
        bwd_t = {"ms": median_ms(backward, iters=it),
                 "queued_ms": median_ms(backward, iters=it, queued=True)}
        rows[label] = {
            "body": ("identity (self-adjoint)" if getattr(
                plan, "identity_maps", False) else "table-driven"),
            "send_rows": plan.send_rows, "recv_rows": plan.recv_rows,
            "row_bytes": plan.row_bytes, "forward_launches": fwd,
            "backward_launches": bwd, "backward_vs_plain": "bytes equal",
            "forward_ms": fwd_t["ms"], "forward_queued_ms": fwd_t["queued_ms"],
            "backward_ms": bwd_t["ms"],
            "backward_queued_ms": bwd_t["queued_ms"]}
        del y, xg, gx, yp, xp, gp
    return rows, launches


def run_train_rest_path(device, t_losses) -> tuple[dict, dict]:
    """Phase 15 (see the module docstring)."""
    import dataclasses
    import gc
    import torch
    from repro_torch._tree import leaves
    from repro_torch.configs import get
    from repro_torch.core import reset_global_plan_cache
    from repro_torch.kernels import a2a_fence, a2a_lock

    t_phase = time.perf_counter()
    cfg0, _, _, _ = train_setup(device)
    n, k6 = TRAIN["steps"], TRAIN_K6_PER_LAYER * cfg0.n_layers
    out, launches = {}, {}

    def free(*objs):
        del objs
        reset_global_plan_cache()
        gc.collect()
        torch.cuda.empty_cache()

    def with_moe(cfg, **kw):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))

    # (a) T under the lock.
    t0 = time.perf_counter()
    run, bundle, row, got = rest_train_run(
        "train rest lock", with_moe(cfg0, a2a_variant="lock"), n,
        lambda plan: {a2a_lock.cuda_kernel(plan.a2a.wire_row_bytes).name:
                      TRAIN_K2_PER_LAYER * cfg0.n_layers,
                      "gather_matmul_wgmma": k6})
    row["losses_equal_T"] = row["losses"] == t_losses
    if not row["losses_equal_T"]:
        raise AssertionError(f"train rest lock: losses {row['losses']} "
                             f"differ from T's {t_losses}")
    row["seconds"] = time.perf_counter() - t0
    out["lock"] = row
    add_counts(launches, got)
    free(run, bundle)
    del run, bundle

    # (b) and (c): T under each codec.
    for codec in ("bf16", "int8", "fp8"):
        t0 = time.perf_counter()
        steps = n if codec == "bf16" else TRAIN_REST["codec_steps"]
        per_layer = TRAIN_REST_K2_PER_LAYER[codec]
        run, bundle, row, got = rest_train_run(
            f"train rest {codec}", with_moe(
                cfg0, wire_codec=codec, codec_tol=TRAIN_REST["codec_tol"]),
            steps,
            lambda plan, pl=per_layer: {
                k2_counter(plan.a2a): pl * cfg0.n_layers,
                "gather_matmul_wgmma": k6})
        plan = bundle.moe_plan
        a2a = plan.a2a
        row["k2_rule"] = {
            "kernel": k2_counter(a2a),
            "row_bytes": a2a.wire_row_bytes,
            "bucket_rows": a2a.capacity,
            "bucket_bytes": a2a.capacity * a2a.wire_row_bytes,
            "bucket_bytes_16_multiple":
                a2a.capacity * a2a.wire_row_bytes % 16 == 0}
        if k2_counter(a2a) != a2a_fence.FENCE_BULK.name:
            raise AssertionError(f"train rest {codec}: K2 {row['k2_rule']}")
        if codec == "bf16":
            rel = max(abs(a - b) / abs(b) for a, b in zip(row["losses"],
                                                          t_losses))
            row["losses_equal_T"] = row["losses"] == t_losses
            row["max_rel_diff_T"] = rel
            if not rel <= 1e-2:
                raise AssertionError(f"train rest bf16: losses "
                                     f"{row['losses']} against T's {t_losses}")
        else:
            row["grads"] = rest_codec_grads(codec, run, bundle)
        row["seconds"] = time.perf_counter() - t0
        out[codec] = row
        add_counts(launches, got)
        free(run, bundle, plan, a2a)
        del run, bundle, plan, a2a

    # (d) the embedded vjps at the main shapes.
    t0 = time.perf_counter()
    vjps, vjp_launches = run_rest_vjps(device)
    out["embedded_vjps"] = {"plans": vjps,
                            "seconds": time.perf_counter() - t0}
    add_counts(launches, vjp_launches)
    free()

    # (e) Moonshot-v1-16B-A3B, 2 of its 48 layers.
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get("moonshot-v1-16b-a3b"),
                              n_layers=TRAIN_REST["moonshot_layers"])
    run, bundle, row, got = rest_train_run(
        "train rest moonshot", cfg, n,
        lambda plan: {k2_counter(plan.a2a): TRAIN_K2_PER_LAYER * cfg.n_layers,
                      "gather_matmul_wgmma": TRAIN_K6_PER_LAYER * cfg.n_layers})
    if not row["losses"][-1] < row["losses"][0]:
        raise AssertionError(f"train rest moonshot: losses {row['losses']}")
    n_params = sum(p.numel() for p in leaves(run.params))
    row.update({"config": cfg.name, "layers": cfg.n_layers,
                "cut": "dataclasses.replace(get('moonshot-v1-16b-a3b'), "
                       "n_layers=2): full width, 2 of 48 layers",
                "params": n_params, "batch": TRAIN["batch"],
                "seq": TRAIN["seq"], "seconds": time.perf_counter() - t0})
    out["moonshot"] = row
    add_counts(launches, got)
    free(run, bundle)
    del run, bundle
    out["T_losses"] = t_losses
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out, launches


# ---------------------------------------------------------------------------
# Slice 17: the roofline and the dry run
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("olmoe-1b-7b", "train_4k"), ("olmoe-1b-7b", "decode_32k"))


def counted_step(bundle, inputs):
    """One step of ``bundle`` on ``inputs`` under a fresh step counter, the
    kernel counters zeroed just before it; returns the counter, the
    launches and plain calls it made, and its seconds."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun

    _build.reset_counts()
    t0 = time.perf_counter()
    _, counter = dryrun.trace_step(bundle, inputs)
    if bundle.mesh.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _build.counts()
    return counter, {
        "launches": {k: v["launches"] for k, v in counts.items()
                     if v["launches"]},
        "plain_calls": {k: v["plain_calls"] for k, v in counts.items()
                        if v["plain_calls"]},
        "seconds": seconds}


def meta_vs_card(label, make_bundle, cfg, shape, want_calls) -> dict:
    """``make_bundle(mesh)`` on a ``meta`` mesh traced, then on the card run
    once, each under a step counter: calls per kernel, FLOPs and collective
    wire bytes must be equal, the calls ``want_calls``, each a launch on the
    card and no plain version called."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import VirtualMesh

    out = {}
    counters = {}
    for where in ("meta", "card"):
        mesh = VirtualMesh(TRAIN["mesh"] if shape.kind == "train"
                           else SERVE["mesh"], ("data", "model"),
                           device="meta" if where == "meta" else None)
        bundle = make_bundle(mesh)
        inputs = dryrun.step_inputs(bundle, cfg, shape, mesh.device)
        if where == "card":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        counter, run = counted_step(bundle, inputs)
        if where == "card":
            run["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        counters[where] = counter
        out[where] = {"flops": counter.flops,
                      "bytes_accessed": counter.bytes_accessed,
                      "calls": {k: v for k, v in counter.calls().items() if v},
                      "wire_bytes": counter.stats().total_wire_bytes,
                      "collectives": counter.stats().to_json()["counts"],
                      "live_peak_bytes": counter.live_peak_bytes, **run}
        del bundle, inputs
        free_card()
    meta, card = out["meta"], out["card"]
    launched = {}
    for name, n in card["launches"].items():
        kid = _build.KERNELS[name].kid
        launched[kid] = launched.get(kid, 0) + n
    problems = []
    if meta["calls"] != card["calls"] or meta["calls"] != want_calls:
        problems.append(f"calls meta {meta['calls']} card {card['calls']} "
                        f"want {want_calls}")
    if launched != card["calls"]:
        problems.append(f"card launches {card['launches']} are not its calls")
    if meta["flops"] != card["flops"]:
        problems.append(f"FLOPs meta {meta['flops']} card {card['flops']}")
    if meta["wire_bytes"] != card["wire_bytes"]:
        problems.append(f"wire bytes meta {meta['wire_bytes']} card "
                        f"{card['wire_bytes']}")
    if meta["plain_calls"] or card["plain_calls"] or meta["launches"]:
        problems.append(f"plain calls {meta['plain_calls']} / "
                        f"{card['plain_calls']}, meta launches "
                        f"{meta['launches']}")
    if problems:
        raise AssertionError(f"dryrun path {label}: " + "; ".join(problems))
    out["equal"] = ["calls per kernel", "flops", "wire_bytes"]
    out["counters"] = counters
    return out


def run_dryrun_path(device, t_step_ms) -> dict:
    """Phase 16 (docstring): the dry run of two full-size cells on the
    host, T's step and S's forwards traced on ``meta`` against the same
    work run on the card, T's roofline and ``mfu`` from ``t_step_ms``."""
    import tempfile
    from repro_torch.configs import SHAPES, ShapeConfig, get
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import analyze

    t_phase = time.perf_counter()
    out = {"cells": {}}
    # (a) Two cells of the catalogue, traced on meta on the host.
    mesh = make_production_mesh(multi_pod=False, device="meta")
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape_name in DRYRUN_CELLS:
            rec = dryrun.run_cell(get(arch), SHAPES[shape_name], mesh,
                                  "pod256", tmp)
            r = rec["roofline"]
            out["cells"][f"{arch}:{shape_name}"] = {
                "flops_per_chip": r["flops_per_chip"],
                "memory_per_rank": rec["memory_per_rank"],
                "memory_one_card": rec["memory_one_card"],
                "n_micro": rec["n_micro"], "dominant": r["dominant"],
                "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                "collective_s": r["collective_s"],
                "useful_ratio": r["useful_ratio"],
                "plan_inits": len(rec["plan_inits"]),
                "seconds_bundle": rec["seconds_bundle"],
                "seconds_trace": rec["seconds_trace"]}

    # (b) T: one step traced on meta against one step on the card.
    cfg, shape, _, sched = train_setup(device)
    n_moe = cfg.n_layers
    t = meta_vs_card(
        "T", lambda m: steps_mod.make_train_bundle(cfg, shape, m, sched=sched),
        cfg, shape,
        {"K2": TRAIN_K2_PER_LAYER * n_moe, "K6": TRAIN_K6_PER_LAYER * n_moe})
    counter = t.pop("counters")["meta"]
    roof = analyze.analyze(
        cfg, shape, "T (1, 8) on one card", 1,
        {"flops": counter.flops, "bytes accessed": counter.bytes_accessed},
        counter.stats(), peak_memory=counter.live_peak_bytes
    ).with_step(t_step_ms / 1e3)
    t["memory_one_card_gib"] = counter.live_peak_bytes / 2**30
    t["max_memory_allocated_gib"] = t["card"]["max_memory_allocated"] / 2**30
    t["memory_ratio"] = (counter.live_peak_bytes
                         / t["card"]["max_memory_allocated"])
    t["roofline"] = roof.to_json()
    t["counted_over_model_flops"] = counter.flops / roof.model_flops
    t["gpu"] = gpu_line()
    out["T"] = t

    # (c) S's prefill and decode bundles: 2 K2 and 2 K6 per MoE layer.
    cfg_s = get("olmoe-1b-7b")
    b, s, n = SERVE["batch"], SERVE["prompt"], SERVE["tokens"]
    per_forward = {"K2": 2 * cfg_s.n_layers, "K6": 2 * cfg_s.n_layers}
    for kind, shape_s in (
            ("prefill", ShapeConfig("serve_prefill", "prefill", s, b)),
            ("decode", ShapeConfig("serve_decode", "decode", s + n + 8, b))):
        res = meta_vs_card(
            f"S {kind}", lambda m, sh=shape_s: steps_mod.make_bundle(
                cfg_s, sh, m), cfg_s, shape_s, per_forward)
        res.pop("counters")
        out[f"S_{kind}"] = res
    launches = {}
    for part in (out["T"], out["S_prefill"], out["S_decode"]):
        add_launches(launches, part["card"]["launches"])
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out, launches


# ---------------------------------------------------------------------------
# Phase 17: ranks in processes
# ---------------------------------------------------------------------------

# The process path's plans: (variant, pack_impl, lock_schedule).
PROCS_RUNS = (("fence", "jnp", "ring"), ("fence", "pallas", "ring"),
              ("fence", "fused", "ring"), ("lock", "pallas", "ring"),
              ("lock", "pallas", "pairwise"))
PROCS_ITERS = 10
# The slow consumer's GPU sleep: about 50 ms on an H100 SXM (cycles).
SLOW_CYCLES = 100_000_000
# Launches of one epoch of each process plan on every rank: the peer K2 and
# K4 run their whole epoch, flags included, in one launch; the peer K3
# keeps a signal kernel on each side of its puts.
PROCS_EPOCH_LAUNCHES = {
    ("fence", "jnp"): {"a2a_fence_peer": 1},
    ("fence", "pallas"): {"gather_rows_runs": 2, "a2a_fence_peer": 1},
    ("fence", "fused"): {"a2a_fence_fused_peer": 1, "gather_rows_runs": 1,
                         "rma_signal": 2},
    ("lock", "pallas"): {"gather_rows_runs": 2, "a2a_lock_peer": 1},
}
# The stalled-rank cases of phase 17: ranks and the flag timeout (s); every
# other rank's WAIT must raise within [timeout, 2 x timeout].
PROCS_STALL_RANKS = 4
PROCS_STALL_TIMEOUT = 2.0
# The peer kernels the process path must launch, and the ones it must not.
PROCS_KERNELS = ("a2a_fence_peer", "a2a_fence_fused_peer", "a2a_lock_peer",
                 "rma_signal", "gather_rows_runs")
PROCS_ABSENT = ("a2a_fence_fused_peer_warp", "gather_rows", "a2a_fence",
                "a2a_fence_bulk", "a2a_fence_fused", "a2a_fence_fused_bulk",
                "a2a_lock", "a2a_lock_cluster")
# The slow consumer's rows: 16 int32 (tags of 21 bits of place).
SLOW_FEATURE = 16


def procs_label(run) -> str:
    variant, impl, sched = run
    return f"{variant}x{impl}" + (f"x{sched}" if variant == "lock" else "")


def procs_counts(name):
    """A: P=8 dense, 1 MiB per pair; H16: the paper's irregular pattern at
    P=16 (B's hugetrace-like counts, base 64)."""
    import numpy as np
    from repro_torch.testing.patterns import hugetrace_like_counts
    return (np.full((8, 8), 1024, np.int64) if name == "A"
            else hugetrace_like_counts(16, 64))


def valid_sha(rows, n: int) -> str:
    """sha256 of the first ``n`` rows' bytes (a numpy array or tensor)."""
    import hashlib
    import numpy as np
    a = rows.cpu().numpy() if hasattr(rows, "cpu") else rows
    return hashlib.sha256(np.ascontiguousarray(a[:n]).tobytes()).hexdigest()


def mps_state() -> dict:
    """Whether the CUDA MPS control daemon or server runs on this machine,
    and the card's compute mode."""
    r = subprocess.run(["pgrep", "-a", "-f", "nvidia-cuda-mps"],
                       capture_output=True, text=True, timeout=30)
    procs = [ln for ln in r.stdout.splitlines() if "pgrep" not in ln]
    pipe = os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps")
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    return {"on": bool(procs), "mps_processes": procs, "pipe_dir": pipe,
            "pipe_dir_exists": os.path.exists(pipe), "compute_mode": mode}


def procs_event_ms(fn, sync, iters) -> list:
    """Device ms of each of ``iters`` calls of ``fn`` (CUDA events around
    the enqueue), ``sync()`` after each."""
    import torch
    out = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        sync()
        out.append(a.elapsed_time(b))
    return out


def procs_tagged(p, cap, feat, rank, k, device):
    """Rank ``rank``'s send buckets of epoch ``k`` as int32 ``[P*C, F]``:
    each value names its rank, epoch and place."""
    import torch
    n = p * cap * feat
    if n >= 1 << 21:
        raise ValueError(f"{n} values do not fit the tag's 21 bits")
    idx = torch.arange(n, dtype=torch.int32, device=device)
    return (((rank * 4 + k) << 21) | idx).reshape(p * cap, feat)


def procs_slow_consumer(mesh, cap, feat) -> dict:
    """Rank 0 delays its read of epoch e's window (a GPU sleep queued after
    the epoch) while the others start epoch e+1; rank 0 must still read
    epoch e's rows, and every rank epoch e+1's.  Fence (K2) and lock (K4)."""
    import torch
    from repro_torch.core.window import SharedRegion
    from repro_torch.kernels import a2a_fence, a2a_lock
    p, me = mesh.world_size, mesh.rank
    region = SharedRegion(mesh, p * cap * feat * 4)
    win = region.win
    out = {}
    for variant in ("fence", "lock"):
        def epoch(k):
            packed = procs_tagged(p, cap, feat, me, k, mesh.device)
            if variant == "fence":
                a2a_fence.rma_alltoallv_fence_peer(packed, win, cap)
            else:
                a2a_lock.rma_alltoallv_lock_peer(packed, win, cap)

        def want(k):
            return torch.cat([procs_tagged(p, cap, feat, j, k, mesh.device)
                              [me * cap:(me + 1) * cap] for j in range(p)])

        mesh.barrier()
        epoch(1)
        snap = None
        if me == 0:
            torch.cuda._sleep(SLOW_CYCLES)
            snap = win.view(p * cap, (feat,), torch.int32).clone()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        epoch(2)
        b.record()
        torch.cuda.synchronize()
        got = win.view(p * cap, (feat,), torch.int32)
        ok = bool(torch.equal(got, want(2)))
        if me == 0:
            ok = ok and bool(torch.equal(snap, want(1)))
        oks = mesh.all_gather_object((ok, a.elapsed_time(b)))
        if not all(o for o, _ in oks):
            raise AssertionError(f"slow consumer ({variant}): ranks "
                                 f"{[r for r, (o, _) in enumerate(oks) if not o]}"
                                 f" read the wrong epoch")
        out[variant] = {"held": True, "rank0_read_epoch_e": True,
                        "others_epoch_e1_ms_max": max(t for _, t in oks[1:]),
                        "rank0_epoch_e1_ms": oks[0][1]}
    region.free()
    return out


def procs_kernel_checks(mesh, plans, x) -> dict:
    """Each peer kernel against its plain version across the processes, at
    this config's shapes (the plans' own packs and tables): both run the
    same epoch on a window filled with a sentinel and on zeroed pads, and
    every rank's window and pad must hold the same bytes after each (the
    K2 and K4 epochs, flags included, are one launch each).  The peer K4
    also at 60-byte rows (its 4-byte form) and at 6-byte rows (3 float16)
    on a base 6 bytes past an aligned one (its byte form); the peer K2's
    byte form on those 6-byte rows and on 60-byte rows at an odd capacity
    (buckets not 16-byte multiples); both kernels on a window registered
    under an uneven geometry (half the ranks planted with half the K4
    CTAs: every rank must take the fewest); and the warp K3 peer kernel,
    which the path's rows never take, on 60-byte rows through the fused
    plan's tables.  Then, on rank 0 alone while the others wait at a
    barrier, each kernel's time beside its plain version's, its bound and
    ``torch._foreach_copy_`` of the same buckets (one PyTorch call doing
    the same copies), with the grid it really uses (``procs_times``)."""
    import numpy as np
    import torch
    from repro_torch.core.window import SharedRegion
    from repro_torch.kernels import a2a_fence, a2a_lock, rma_signal
    from repro_torch.testing import dist_cases
    p, me = mesh.world_size, mesh.rank
    fence, fused = plans["fencexpallas"], plans["fencexfused"]
    cap = fence.capacity
    xs = x.unsqueeze(0)
    packed = fence._pack(xs, fence._tables[0], fence._tables[1])[0]
    fsrc, fvalid = fused._tables[0][0], fused._tables[1][0]
    caps = {s: plans[f"lockxpallasx{s}"].round_capacities
            for s in ("ring", "pairwise")}
    # 60-byte rows (3 x 5 float32) through the fused plan's tables: the
    # warp-per-row K3 peer kernel, which the path's 1 KiB rows never take;
    # and 60-byte send buckets for the peer K4.
    rng = np.random.default_rng(me)
    xw = torch.from_numpy(rng.standard_normal(
        (x.shape[0], 3, 5)).astype(np.float32)).to(mesh.device)
    packed60 = torch.from_numpy(rng.standard_normal(
        (p * cap, 15)).astype(np.float32)).to(mesh.device)
    if a2a_fence.fused_peer_kernel_for(xw) is not a2a_fence.FUSED_PEER_WARP:
        raise AssertionError("60-byte rows must take the warp K3 peer kernel")
    if a2a_lock.lock_peer_width(60, packed60.data_ptr()) != 4:
        raise AssertionError("60-byte rows must take the 4-byte peer K4")
    # 6-byte rows (3 float16) 6 bytes past an aligned base: the byte forms.
    packed6 = torch.from_numpy(rng.standard_normal(
        (p * cap + 1, 3)).astype(np.float16)).to(mesh.device)[1:]
    cap_odd = cap - 1
    packed60_odd = packed60[:p * cap_odd]
    if a2a_lock.lock_peer_width(6, packed6.data_ptr()) != 1:
        raise AssertionError("6-byte rows must take the byte peer K4")
    if (cap * 6) % 16 == 0 and packed6.data_ptr() % 16 == 0:
        raise AssertionError("6-byte rows must take the peer K2's byte form")
    if (cap_odd * 60) % 16 == 0:
        raise AssertionError("an odd capacity must give buckets that are "
                             "not 16-byte multiples")
    region = SharedRegion(mesh, fence.exposed_bytes)
    win = region.win
    sync = torch.cuda.synchronize
    checks = {}

    def held(label, kernel_epoch, plain_epoch, dtype=torch.float32, w=None):
        """Both versions of epoch ``e`` (one epoch number for both) on a
        sentinel-filled window and zeroed pads (``w``, default ``win``):
        every rank's window and pad bytes must be equal; ``max_abs_err`` is
        the largest difference of the window's values as ``dtype``, over
        the ranks."""
        w = win if w is None else w
        e = w.next_epoch()
        got = []
        for fn in (kernel_epoch, plain_epoch):
            w.local.fill_(0x5A)
            w.pad.zero_()
            sync()
            mesh.barrier()
            fn(e)
            sync()
            mesh.barrier()
            got.append(torch.cat([w.local, w.pad.view(torch.uint8)]).clone())
        n = w.local.numel()
        a, b = (g[:n].view(dtype).double() for g in got)
        err = float((a - b).abs().max().item()) if a.numel() else 0.0
        same = mesh.all_gather_object((bool(torch.equal(*got)), err))
        bad = [r for r, (s, _) in enumerate(same) if not s]
        if bad:
            raise AssertionError(f"{label}: kernel and plain version differ on "
                                 f"ranks {bad} (window or pad)")
        checks[label] = {"bytes_equal_on_every_rank": True,
                         "window_and_pad": True,
                         "max_abs_err": max(e for _, e in same)}

    held("a2a_fence_peer",
         lambda e: a2a_fence.rma_alltoallv_fence_peer(packed, win, cap, e),
         lambda e: a2a_fence.rma_alltoallv_fence_peer_plain(packed, win, cap,
                                                            e))
    held("a2a_fence_fused_peer",
         lambda e: a2a_fence.rma_alltoallv_fence_fused_peer(
             x, fsrc, fvalid, win, cap, e),
         lambda e: a2a_fence.rma_alltoallv_fence_fused_peer_plain(
             x, fsrc, fvalid, win, cap, e))
    held("a2a_fence_fused_peer_warp",
         lambda e: a2a_fence.rma_alltoallv_fence_fused_peer(
             xw, fsrc, fvalid, win, cap, e),
         lambda e: a2a_fence.rma_alltoallv_fence_fused_peer_plain(
             xw, fsrc, fvalid, win, cap, e))
    for s in ("ring", "pairwise"):
        held(f"a2a_lock_peer:{s}",
             lambda e, s=s: a2a_lock.rma_alltoallv_lock_peer(
                 packed, win, cap, caps[s], s, e),
             lambda e, s=s: a2a_lock.rma_alltoallv_lock_peer_plain(
                 packed, win, cap, caps[s], s, e))
    held("a2a_lock_peer:60-byte rows",
         lambda e: a2a_lock.rma_alltoallv_lock_peer(packed60, win, cap,
                                                    caps["ring"], "ring", e),
         lambda e: a2a_lock.rma_alltoallv_lock_peer_plain(
             packed60, win, cap, caps["ring"], "ring", e))
    held("a2a_lock_peer:6-byte rows",
         lambda e: a2a_lock.rma_alltoallv_lock_peer(packed6, win, cap,
                                                    caps["ring"], "ring", e),
         lambda e: a2a_lock.rma_alltoallv_lock_peer_plain(
             packed6, win, cap, caps["ring"], "ring", e), torch.float16)
    held("a2a_fence_peer:6-byte rows",
         lambda e: a2a_fence.rma_alltoallv_fence_peer(packed6, win, cap, e),
         lambda e: a2a_fence.rma_alltoallv_fence_peer_plain(packed6, win,
                                                            cap, e),
         torch.float16)
    held("a2a_fence_peer:60-byte rows, odd capacity",
         lambda e: a2a_fence.rma_alltoallv_fence_peer(packed60_odd, win,
                                                      cap_odd, e),
         lambda e: a2a_fence.rma_alltoallv_fence_peer_plain(
             packed60_odd, win, cap_odd, e))
    held("rma_signal",
         lambda e: rma_signal.rma_signal(win, rma_signal.ROUND, e),
         lambda e: rma_signal.rma_signal_plain(win, rma_signal.ROUND, e),
         torch.int64)
    mesh.barrier()
    region.free()
    # An uneven geometry: the first half of the ranks report half the K4
    # CTAs (as ranks that share their card with twice as many would).
    full = win.lock_ctas
    mine = max(1, full // 2) if me < p // 2 else full
    with dist_cases.planted_geometry(lock_ctas=mine):
        uneven = SharedRegion(mesh, fence.exposed_bytes)
    uw = uneven.win
    if uw.lock_ctas != max(1, full // 2) or uw.pad.numel() != \
            rma_signal.pad_len(p, uw.lock_ctas):
        raise AssertionError(f"uneven geometry: rank {me} took "
                             f"{uw.lock_ctas} K4 CTAs, not {max(1, full // 2)}")
    held("a2a_lock_peer:uneven geometry",
         lambda e: a2a_lock.rma_alltoallv_lock_peer(packed, uw, cap,
                                                    caps["ring"], "ring", e),
         lambda e: a2a_lock.rma_alltoallv_lock_peer_plain(
             packed, uw, cap, caps["ring"], "ring", e), w=uw)
    held("a2a_fence_peer:uneven geometry",
         lambda e: a2a_fence.rma_alltoallv_fence_peer(packed, uw, cap, e),
         lambda e: a2a_fence.rma_alltoallv_fence_peer_plain(packed, uw, cap,
                                                            e), w=uw)
    checks["uneven_geometry"] = {"lock_ctas": uw.lock_ctas,
                                 "lock_ctas_even": full,
                                 "fence_ctas": uw.fence_ctas}
    mesh.barrier()
    uneven.free()
    times = procs_times(mesh, fence, packed, x, xw, fsrc, fvalid, caps,
                        packed60)
    return {"checks": checks, "times": times}


def procs_times(mesh, fence, packed, x, xw, fsrc, fvalid, caps, packed60):
    """Rank 0 alone, the others at a barrier, on a region of its own whose
    pad says every peer has opened, closed and put every epoch (2^62): each
    peer kernel's ``ms`` and ``queued_ms``, its plain version, one
    ``torch._foreach_copy_`` of the same copies where there is one, its
    bound (the bytes moved, each read once and written once), the host
    enqueue time, the grid it launches (CTAs per rank) and the registers
    and local (spill) bytes per thread the card reports.  The peer K2 and
    K4 run their whole epochs (flags included) with a fresh epoch number
    per call, also with their flags at system scope; queued, K2 over a
    sweep of grids up to one block per chunk (the grid its puts had before
    the redesign), and K4 on fewer CTAs than its budget."""
    import itertools
    import torch
    from repro_torch.core.window import SharedRegion
    from repro_torch.kernels import a2a_fence, a2a_lock, rma_signal
    p, me = mesh.world_size, mesh.rank
    cap, rb = fence.capacity, fence.row_bytes
    times = {}
    timing = SharedRegion(mesh, fence.exposed_bytes)
    tw = timing.win
    if me == 0:
        tw.pad.fill_(1 << 62)
        epochs = itertools.count(1)
        idx = mesh.device.index
        bucket = cap * rb
        dst = [t[0:bucket] for t in tw.peers]
        srcb = packed.reshape(-1).view(torch.uint8)
        src = [srcb[t * bucket:(t + 1) * bucket] for t in range(p)]

        def k2(ctas=None):
            return lambda: a2a_fence.fence_peer_kernel(packed, tw, cap,
                                                       next(epochs), ctas)

        chunks = a2a_fence.fence_peer_grid(tw, cap, rb, ctas=1 << 30)
        grid = a2a_fence.fence_peer_grid(tw, cap, rb)
        info = a2a_fence.peer_info(idx, True)
        times["a2a_fence_peer"] = {
            **device_ms(k2()),
            "plain_ms": median_ms(lambda: a2a_fence.rma_alltoallv_fence_peer_plain(
                packed, tw, cap, next(epochs))),
            "library_ms": median_ms(lambda: torch._foreach_copy_(dst, src)),
            "library_queued_ms": median_ms(
                lambda: torch._foreach_copy_(dst, src), queued=True),
            "enqueue_ms": median_enqueue_ms(k2()),
            "ctas": grid, "chunks": chunks,
            "registers": info["registers"], "local_bytes": info["local_bytes"],
            "resident_ctas_card": a2a_fence.peer_resident_ctas(idx),
            "grid_sweep_queued_ms": {g: median_ms(k2(g), queued=True)
                                     for g in sorted(
                {max(1, grid // 4), max(1, grid // 2), grid, 2 * grid,
                 chunks})},
            "bytes": 2 * p * bucket, "launches_per_epoch": 1}
        n_valid = int(fvalid.sum())
        times["a2a_fence_fused_peer"] = {
            **device_ms(lambda: a2a_fence.fence_fused_peer_kernel(
                x, fsrc, fvalid, tw, cap)),
            "plain_ms": median_ms(lambda: a2a_fence.fence_fused_peer_puts_plain(
                x, fsrc, fvalid, tw, cap)),
            "library_ms": None,
            "bytes": n_valid * rb + p * cap * 5 + p * bucket}
        wrb = 60
        times["a2a_fence_fused_peer_warp"] = {
            **device_ms(lambda: a2a_fence.fence_fused_peer_kernel(
                xw, fsrc, fvalid, tw, cap)),
            "plain_ms": median_ms(lambda: a2a_fence.fence_fused_peer_puts_plain(
                xw, fsrc, fvalid, tw, cap)),
            "library_ms": None,
            "bytes": n_valid * wrb + p * cap * 5 + p * cap * wrb}
        ring = a2a_lock.lock_peer_steps(p, cap, caps["ring"], "ring")
        moved = sum(c for step in ring for _, c in step) * rb
        rsrc, rdst = [], []
        for step in ring:
            for r, c in step:
                t = (me + r) % p
                rsrc.append(srcb[t * bucket:t * bucket + c * rb])
                rdst.append(tw.peers[t][0:c * rb])

        def k4(buf=packed):
            return lambda: a2a_lock.lock_peer_kernel(
                buf, tw, cap, caps["ring"], "ring", next(epochs))

        info = a2a_lock.peer_info(idx, 16)
        k4_ms = device_ms(k4())
        times["a2a_lock_peer"] = {
            **k4_ms,
            "plain_ms": median_ms(lambda: a2a_lock.rma_alltoallv_lock_peer_plain(
                packed, tw, cap, caps["ring"], "ring", next(epochs))),
            "library_ms": median_ms(lambda: torch._foreach_copy_(rdst, rsrc)),
            "library_queued_ms": median_ms(
                lambda: torch._foreach_copy_(rdst, rsrc), queued=True),
            "enqueue_ms": median_enqueue_ms(k4()),
            "ctas": tw.lock_ctas, "phases": len(ring),
            "ms_per_round": k4_ms["ms"] / len(ring),
            "queued_ms_per_round": k4_ms["queued_ms"] / len(ring),
            "registers": info["registers"], "local_bytes": info["local_bytes"],
            "resident_ctas_card": a2a_lock.peer_resident_ctas(idx),
            "rows60_ms": median_ms(k4(packed60)),
            "bytes": 2 * moved, "launches_per_epoch": 1}
        # The same two epochs with their flags at system scope, which a
        # peer on another card needs (here every rank shares the card).
        scope = tw.sys_scope
        tw.sys_scope = True
        times["a2a_fence_peer"]["sys_scope"] = device_ms(k2())
        times["a2a_lock_peer"]["sys_scope"] = device_ms(k4())
        tw.sys_scope = scope
        # The K4 on fewer CTAs (round slots) than its budget: rank 0's view
        # of the preset pad is the same whatever the slot count.
        budget = tw.lock_ctas
        sweep = {}
        for g in sorted({max(1, budget // 4), max(1, budget // 2), budget}):
            tw.lock_ctas = g
            sweep[g] = median_ms(k4(), queued=True)
        tw.lock_ctas = budget
        times["a2a_lock_peer"]["ctas_sweep_queued_ms"] = sweep
        for name in ("a2a_fence_peer", "a2a_lock_peer"):
            times[name]["scope"] = "system" if scope else "gpu"
        # The signal kernel as the peer K3's epoch launches it: one flag
        # per peer.
        times["rma_signal"] = {
            **device_ms(lambda: rma_signal.rma_signal(
                tw, rma_signal.OPEN, 1, wait=False)),
            "plain_ms": median_ms(lambda: rma_signal.rma_signal_plain(
                tw, rma_signal.OPEN, 1, wait=False)),
            "library_ms": None, "bytes": 2 * 8 * (p - 1)}
        for row in times.values():
            row["bound_ms"] = bound_ms(row["bytes"])
    torch.cuda.synchronize()
    mesh.barrier()
    timing.free()
    return times


def procs_child(mesh, name, counts, oracle, one_process, iters=PROCS_ITERS):
    """One rank of phase 17 (runs in its own process): every plan of
    ``PROCS_RUNS`` and the baseline, their INIT and epoch times, valid rows
    against the oracle's and the one-process plan's digests; then the
    kernel checks and the slow consumer, none of them counted."""
    import numpy as np
    import torch
    from repro_torch.core import PlanCache, alltoallv_init, metadata as md, reference
    from repro_torch.core.baseline import make_nonpersistent
    from repro_torch.kernels import _build
    counts = np.asarray(counts, np.int64)
    p, me = mesh.world_size, mesh.rank
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    bufs = reference.make_testbufs(counts, (FEATURE,), np.float32, send_rows)
    x = torch.from_numpy(np.ascontiguousarray(bufs[me])).to(mesh.device)
    n = int(md.recv_counts(counts)[me].sum())
    for k in _build.KERNELS.values():
        k._load()
    sync = torch.cuda.synchronize
    runs, plans = {}, {}
    _build.reset_counts()
    for run in PROCS_RUNS:
        label = procs_label(run)
        t0 = time.perf_counter()
        plan = alltoallv_init(counts, (FEATURE,), "float32", mesh, axis="x",
                              variant=run[0], pack_impl=run[1],
                              lock_schedule=run[2], cache=PlanCache(),
                              store=False)
        plan.compile()
        init_s = time.perf_counter() - t0
        before = _build.counts()
        sha = valid_sha(plan.wait(plan.start(x)), n)
        if sha != oracle[me] or sha != one_process[label][me]:
            raise AssertionError(f"rank {me} {label}: valid rows differ from "
                                 f"the oracle or the one-process plan")
        ms = procs_event_ms(lambda: plan.start(x), sync, iters)
        per_epoch = PROCS_EPOCH_LAUNCHES[run[:2]]
        ran = launches_since(before)
        if ran != {k: v * (iters + 1) for k, v in per_epoch.items()}:
            raise AssertionError(f"rank {me} {label}: {iters + 1} epochs "
                                 f"launched {ran}, not {per_epoch} each")
        runs[label] = {"launches_per_epoch": per_epoch, "init_s": init_s,
                       "register_s": plan.init_register_seconds,
                       "init_without_register_s":
                           init_s - plan.init_register_seconds,
                       "epoch_ms_p50": statistics.median(ms),
                       "epoch_ms_min": min(ms), "epoch_ms_max": max(ms)}
        plans[label] = plan
    fence = plans["fencexjnp"]
    t0 = time.perf_counter()
    exe = make_nonpersistent(mesh, axis="x", p=p, capacity=fence.capacity,
                             send_rows=send_rows, recv_rows=fence.recv_rows,
                             feature_shape=(FEATURE,), dtype=torch.float32)
    register_s = time.perf_counter() - t0
    row = torch.as_tensor(counts[me], dtype=torch.int32, device=mesh.device)
    if valid_sha(exe(x, row), n) != oracle[me]:
        raise AssertionError(f"rank {me} baseline: valid rows differ")
    sync()
    ms = procs_event_ms(lambda: exe(x, row), sync, iters)
    runs["baseline:fence"] = {"register_s": register_s,
                              "epoch_ms_p50": statistics.median(ms),
                              "epoch_ms_min": min(ms), "epoch_ms_max": max(ms)}
    sync()
    cnt = _build.counts()
    plain = {k: v["plain_calls"] for k, v in cnt.items() if v["plain_calls"]}
    if plain:
        raise AssertionError(f"rank {me}: plain versions ran on the path {plain}")
    launches = {k: v["launches"] for k, v in cnt.items() if v["launches"]}
    checks = procs_kernel_checks(mesh, plans, x)
    slow = procs_slow_consumer(mesh, fence.capacity, SLOW_FEATURE)
    for plan in plans.values():
        plan.free()
    return {"rank": me, "runs": runs, "launches": launches, "slow": slow,
            **checks}


def run_procs_path(device) -> tuple[dict, dict, list]:
    """Phase 17: A on 8 processes and the P=16 hugetrace pattern on 16, one
    process per rank on this card; beside each, the one-process plans on
    ``VirtualMesh`` at the same config."""
    import numpy as np
    import torch
    from repro_torch.core import PlanCache, alltoallv_init, metadata as md
    from repro_torch.core.baseline import make_nonpersistent
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.testing import dist_cases
    out = {"mps": mps_state(), "configs": {}}
    launches, rows = {}, {}
    for name in ("A", "H16"):
        counts = procs_counts(name)
        cfg = make_config(name, counts, device)
        p, rr = cfg["p"], cfg["recv_rows"]
        rc = cfg["rc"].sum(axis=1)
        oracle = [valid_sha(cfg["expect"][r], int(rc[r])) for r in range(p)]
        mesh = VirtualMesh((p,), ("x",))
        one = {}
        for run in PROCS_RUNS:
            label = procs_label(run)
            t0 = time.perf_counter()
            plan = alltoallv_init(counts, (FEATURE,), "float32", mesh,
                                  axis="x", variant=run[0], pack_impl=run[1],
                                  lock_schedule=run[2], cache=PlanCache(),
                                  store=False)
            plan.compile()
            init_s = time.perf_counter() - t0
            got = plan.wait(plan.start(cfg["x"])).view(p, rr, FEATURE)
            shas = [valid_sha(got[r], int(rc[r])) for r in range(p)]
            if shas != oracle:
                raise AssertionError(f"{name} one-process {label}: valid rows "
                                     f"differ from the oracle")
            one[label] = {"init_s": init_s, "shas": shas,
                          "epoch_ms": median_ms(lambda: plan.start(cfg["x"]))}
            plan.free()
        cap = md.global_capacity(counts)
        base = make_nonpersistent(mesh, axis="x", p=p, capacity=cap,
                                  send_rows=cfg["send_rows"], recv_rows=rr,
                                  feature_shape=(FEATURE,), dtype=torch.float32)
        flat = torch.as_tensor(counts.reshape(-1), dtype=torch.int32,
                               device=device)
        one["baseline:fence"] = {"epoch_ms": median_ms(
            lambda: base(cfg["x"], flat))}
        del cfg, base, plan, got
        free_card()
        t0 = time.perf_counter()
        ranks = dist_cases.spawn(
            procs_child, p, None, timeout=900, name=name,
            counts=counts.tolist(), oracle=oracle,
            one_process={k: v.get("shas") for k, v in one.items()})
        seconds = time.perf_counter() - t0
        summed = {}
        for res in ranks:
            add_launches(summed, res["launches"])
        missing = [k for k in PROCS_KERNELS if not summed.get(k)]
        extra = {k: summed[k] for k in PROCS_ABSENT if summed.get(k)}
        if missing or extra:
            raise AssertionError(f"{name} procs path: kernels not launched "
                                 f"{missing}, launched {extra}")
        add_launches(launches, summed)
        per_run = {}
        for label in ranks[0]["runs"]:
            rs = [res["runs"][label] for res in ranks]
            per_run[label] = {
                "epoch_ms_p50_max_over_ranks": max(r["epoch_ms_p50"] for r in rs),
                "epoch_ms_p50_min_over_ranks": min(r["epoch_ms_p50"] for r in rs),
                "one_process_epoch_ms": one[label]["epoch_ms"],
                **({"launches_per_epoch_on_every_rank":
                        rs[0]["launches_per_epoch"],
                    "init_s_max": max(r["init_s"] for r in rs),
                    "init_without_register_s_max":
                        max(r["init_without_register_s"] for r in rs),
                    "register_s_max": max(r["register_s"] for r in rs),
                    "one_process_init_s": one[label]["init_s"]}
                   if "init_s" in rs[0] else
                   {"register_s_max": max(r["register_s"] for r in rs)})}
        out["configs"][name] = {
            "p": p, "seconds": seconds, "launches_summed_over_ranks": summed,
            "oracle": "every rank's valid rows bytes-equal to the oracle and "
                      "to the one-process VirtualMesh plan (sha256)",
            "runs": per_run, "kernel_checks": ranks[0]["checks"],
            "slow_consumer": ranks[0]["slow"], "kernel_times_rank0":
                ranks[0]["times"]}
        rows[name] = ranks[0]["times"]
    out["stalled"] = procs_stalled()
    meta = {"a2a_fence_peer": ("src/repro/kernels/a2a_fence.py:102",
                               "csrc/a2a_fence.cu", "fencexpallas"),
            "a2a_fence_fused_peer": ("src/repro/kernels/a2a_fence.py:237",
                                     "csrc/a2a_fence.cu", "fencexfused"),
            "a2a_lock_peer": ("src/repro/kernels/a2a_lock.py:74",
                              "csrc/a2a_lock.cu", "lockxpallasxring"),
            "rma_signal": ("src/repro/kernels/a2a_fence.py:102",
                           "csrc/rma_signal.cu", None)}
    kernel_rows = []
    for kname, (replaces, source, run) in meta.items():
        a = rows["A"][kname]
        err = max(c["max_abs_err"] for cfg in out["configs"].values()
                  for label, c in cfg["kernel_checks"].items()
                  if label.split(":")[0] == kname)
        kernel_rows.append({
            "name": kname, "route": "cuda", "counter": kname,
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": replaces, "launches": launches.get(kname, 0),
            "launches_by_path": {"procs": launches.get(kname, 0)},
            "max_abs_err": err, "bound_by": "bytes", **a,
            "shape": "A (P=8, 1 MiB per pair), rank 0 alone",
            "epoch_ms_p50": (out["configs"]["A"]["runs"][run]
                             ["epoch_ms_p50_max_over_ranks"] if run else None),
            "H16": rows["H16"][kname]})
    return out, launches, kernel_rows


def procs_stalled() -> dict:
    """Both stalled-rank cases on ``PROCS_STALL_RANKS`` processes of this
    card with a ``PROCS_STALL_TIMEOUT`` flag timeout: the last rank lives
    but never starts its epoch; every other rank's WAIT must raise the
    named flag error (its rank, epoch 1, the open or round flag of the
    stalled rank: ``dist_cases._stalled`` checks it) within one to two
    timeouts, and the group must end (the harness kills it at 120 s)."""
    from repro_torch.testing import dist_cases
    out = {}
    for case in ("stalled_rank", "stalled_rank_lock"):
        t0 = time.perf_counter()
        ranks = dist_cases.spawn(dist_cases.PORT_CASES[case], PROCS_STALL_RANKS,
                                 None, timeout=120,
                                 flag_timeout=PROCS_STALL_TIMEOUT)
        seconds = [r["seconds"] for r in ranks if not r.get("stalled")]
        if (len(seconds) != PROCS_STALL_RANKS - 1 or not all(
                PROCS_STALL_TIMEOUT <= t <= 2 * PROCS_STALL_TIMEOUT
                for t in seconds)):
            raise AssertionError(f"{case}: the other ranks raised after "
                                 f"{seconds} s, not within "
                                 f"[{PROCS_STALL_TIMEOUT}, "
                                 f"{2 * PROCS_STALL_TIMEOUT}]")
        out[case] = {"ranks": PROCS_STALL_RANKS,
                     "flag_timeout_s": PROCS_STALL_TIMEOUT,
                     "errors": [r["error"] for r in ranks if "error" in r],
                     "seconds": seconds,
                     "group_seconds": time.perf_counter() - t0}
    return out


def one_process_kernels(device) -> dict:
    """``--one-process-kernels``: the one-process K2 bucket, K3 tile and K4
    cluster kernels at A and B on their main-path inputs (the fence plan's
    pack and tables, the ring lock plan's round capacities), each kernel's
    ``ms`` and ``queued_ms``.  Copied beside another tree's ``src/`` the
    script times that tree's kernels, so two trees are compared in one chip
    call as parent, change, change, parent."""
    import numpy as np
    from repro_torch.core import PlanCache, alltoallv_init
    from repro_torch.kernels import a2a_fence, a2a_lock, gather_rows
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.testing.patterns import hugetrace_like_counts
    out = {}
    for name, counts in (("A", np.full((8, 8), 1024, np.int64)),
                         ("B", hugetrace_like_counts(64, 64))):
        cfg = make_config(name, counts, device)
        mesh = VirtualMesh((cfg["p"],), ("x",))
        fence, lock = (alltoallv_init(
            counts, (FEATURE,), "float32", mesh, axis="x", variant=v,
            pack_impl="pallas", cache=PlanCache(), store=False).compile()
            for v in ("fence", "lock"))
        p, cap = fence.p, fence.capacity
        x = cfg["x"].view(p, cfg["send_rows"], FEATURE)
        src, valid = fence._tables[:2]
        packed = gather_rows.gather_rows(x, src, valid,
                                         runs=fence.run_tables["pack"])
        caps = lock.round_capacities
        out[name] = {
            "a2a_fence_bulk": device_ms(
                lambda: a2a_fence.rma_alltoallv_fence(packed, p, cap)),
            "a2a_fence_fused_bulk": device_ms(
                lambda: a2a_fence.fence_fused_bulk_kernel(x, src, valid, p,
                                                          cap)),
            "a2a_lock_cluster": device_ms(
                lambda: a2a_lock.lock_cluster_kernel(packed, p, cap, caps,
                                                     "ring"))}
        del cfg, fence, lock, x, src, valid, packed
        free_card()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA device only", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.testing.patterns import hugetrace_like_counts

    if sys.argv[1:2] == ["--planstore-child"]:
        return planstore_child(*sys.argv[2:4])
    device = card()
    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda})
    if sys.argv[1:2] == ["--one-process-kernels"]:
        emit({"tree": HERE, "build_seconds": _build.build(),
              "one_process_kernels": one_process_kernels(device)})
        return 0

    t0 = time.perf_counter()
    per_source = _build.build()
    for k in _build.KERNELS.values():
        k._load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": per_source})

    emit({"phase": "kernels_vs_plain", "cases": check_kernels(device),
          "tolerance": "bytes equal"})

    configs = [
        make_config("A", np.full((8, 8), 1024, np.int64), device),
        make_config("B", hugetrace_like_counts(64, 64), device),
    ]
    plans, per_epoch, launches = run_main_path(configs, device)
    emit({"phase": "main_path", "launches": launches,
          "launches_per_epoch": per_epoch, "oracle": "valid rows bit-equal"})
    emit({"phase": "kernels_vs_plain_main_shapes",
          "cases": sum(check_at_main_shapes(c, plans, device) for c in configs),
          "tolerance": "bytes equal"})

    hier_plans, embed_plans, hier_per_epoch, hier_launches = run_hier_path(
        configs, device)
    emit({"phase": "hier_path", "launches": hier_launches,
          "launches_per_epoch": hier_per_epoch,
          "oracle": "valid rows bit-equal to the oracle and to the flat "
                    "fence plan; embed() equal to start(), zero padding"})
    emit({"phase": "kernels_vs_plain_hier_shapes",
          "cases": check_hier_at_main_shapes({**hier_plans, **embed_plans}),
          "tolerance": "bytes equal"})

    ragged, ragged_launches, ragged_cases = run_ragged_path(configs, plans,
                                                           device)
    emit({"phase": "ragged_path", "launches": ragged_launches,
          "kernels_vs_plain_cases": ragged_cases,
          "oracle": "valid rows bit-equal to the oracle and to fence x fused; "
                    "rows past each recv count keep the slot's sentinel; one "
                    "gather_rows_runs launch per epoch"})
    patterns_out, patterns_launches = run_patterns_path(device)
    emit({"phase": "patterns_path", "gpu": gpu, "launches": patterns_launches,
          "oracle": "bit-equal to each pattern's numpy reference "
                    "(integer-valued float32)", **patterns_out})
    codec_times, codec_launches, codec_plans = run_codec_path(configs, device)
    emit({"phase": "codec_path", "gpu": gpu, "launches": codec_launches,
          "oracle": "valid rows bit-equal to the oracle of decode(encode(x))",
          "plans": codec_times})
    emit({"phase": "codec_passes", "gpu": gpu, "plan": "B:fencexpallas@int8",
          "passes": time_codec_passes(*codec_plans["B:fencexpallas@int8"])})
    del codec_plans
    t0 = time.perf_counter()
    sweeps, auto_launches = run_autotune_path(configs, device)
    emit({"phase": "autotune_path", "gpu": gpu,
          "seconds": time.perf_counter() - t0, "launches": auto_launches,
          "oracle": "winner's valid rows bit-equal to the oracle; a second "
                    "INIT sweeps no more; embeddable never ragged; MoE auto "
                    "exchange bit-equal to the fence layer's",
          "sweeps": sweeps})
    t0 = time.perf_counter()
    breakeven_out, breakeven_sizes, breakeven_launches = run_breakeven_path(
        configs, device)
    emit({"phase": "breakeven_path", "gpu": gpu,
          "seconds": time.perf_counter() - t0, "launches": breakeven_launches,
          "baseline": "core.baseline non-persistent fence",
          "estimator": "interleaved min of 4 bursts, 50 calls, each blocked "
                       "until the card is idle",
          "plans": breakeven_out, "message_sizes_fence_x_fused": breakeven_sizes})
    t0 = time.perf_counter()
    obs = run_obs_path(configs, device)
    emit({"phase": "obs_path", "gpu": gpu,
          "seconds": time.perf_counter() - t0, **obs})
    t0 = time.perf_counter()
    planstore, planstore_launches = run_planstore_path(device)
    emit({"phase": "planstore_path", "gpu": gpu,
          "seconds": time.perf_counter() - t0,
          "oracle": "every warm plan: no table bake, no autotune burst, a "
                    "store hit, warm_loaded where its variant stores tables, "
                    "the cold variant, valid rows bit-equal to the cold "
                    "plan's and the oracle, the cold epoch's launches",
          "t_init": "INIT call (store lookups and publishes) + compile",
          **planstore})
    emit({"phase": "gather_matmul_vs_plain", **check_gather_matmul(device),
          "tolerance": {"float32": "2e-5 x max|plain|",
                        "bfloat16": "8e-3 x max|plain|",
                        "invalid rows": "+0.0 exactly"}})
    eng, serve, serve_launches = run_serve_path(device)
    emit({"phase": "serve_path", "gpu": gpu, **serve})
    k6 = time_gather_matmul(eng.params, device)
    k6["a2a_fence_at_serve_shapes"] = time_serve_exchange(
        {"prefill": eng.prefill_bundle.moe_plan, "decode": eng.moe_plan})
    serve_codec, serve_codec_launches = run_serve_codec(eng, device)
    emit({"phase": "serve_codec", "gpu": gpu, **serve_codec})
    del eng
    torch.cuda.empty_cache()
    emit({"phase": "serve_vs_cpu", **run_serve_vs_cpu(device),
          "tolerance": "logits within 1e-3 x max|logit|"})
    emit({"phase": "gather_matmul_times", "gpu": gpu, **k6})

    kernels, enqueue_ms = time_kernels(configs, plans, device)
    k5_row, enqueue_ms["a2a_hier"] = time_hier_kernel(
        *hier_plans["B:fence_hierarchy8x8xfused"])
    kernels.append(k5_row)
    pre = k6["prefill"]
    kernels.append({
        "name": "gather_matmul", "route": "cuda", "counter": "gather_matmul_wgmma",
        "design": "wgmma m64n128k16 from a 3-stage shared-memory ring: w by "
                  "TMA (producer warp, mbarriers), gathered rows by cp.async "
                  "(consumer warpgroups); one block per (expert, 128 columns "
                  "of F) covering all rows, so each w tile is read once",
        "source": "src/repro_torch/kernels/csrc/gather_matmul.cu",
        "replaces": "src/repro/kernels/gather_matmul.py:94",
        "max_abs_err": pre["max_abs_err"], "ms": pre["ms"],
        "queued_ms": pre["queued_ms"],
        "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"], "bytes": pre["bytes"],
        "library_ms": pre["library_ms"],
        "library_queued_ms": pre["library_queued_ms"], "shape": "OLMoE prefill",
        "decode": {k: k6["decode"][k] for k in (
            "ms", "queued_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_queued_ms", "max_abs_err")}})
    enqueue_ms["gather_matmul"] = pre["enqueue_ms"]
    for row in kernels:
        name = row.get("counter", row["name"])
        by_path = {"flat": launches.get(name, 0),
                   "hierarchy": hier_launches.get(name, 0),
                   "serve": serve_launches.get(name, 0),
                   "ragged": ragged_launches.get(name, 0),
                   "patterns": patterns_launches.get(name, 0),
                   "codec": codec_launches.get(name, 0),
                   "serve_codec": serve_codec_launches.get(name, 0),
                   "autotune": auto_launches.get(name, 0),
                   "breakeven": breakeven_launches.get(name, 0),
                   "planstore": planstore_launches.get(name, 0)}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    emit({"phase": "kernel_times", "gpu": gpu, "enqueue_ms": enqueue_ms})
    emit({"phase": "hier_passes", "gpu": gpu, "plan": "B:fence_hierarchy8x8xfused",
          "passes": time_hier_passes(*hier_plans["B:fence_hierarchy8x8xfused"])})
    emit({"phase": "epoch_times", "gpu": gpu,
          "epochs": time_epochs(plans, hier_plans, configs, device)})
    emit({"phase": "ragged_times", "gpu": gpu, "epochs": time_ragged(ragged, plans)})

    # Phase 10 needs the card's memory: drop every earlier plan first.
    del plans, hier_plans, embed_plans, ragged, configs
    held = free_card()
    train, train_launches = run_train_path(device)
    elastic = train.pop("elastic")      # phase 14 (f), printed there
    emit({"phase": "train_path", "gpu": gpu, "held_before_gib": held, **train})
    # Phase 11 after T's state is freed.
    held = free_card()
    mesh, mesh_launches = run_mesh_path(device, train["losses"])
    emit({"phase": "mesh_path", "gpu": gpu, "held_before_gib": held, **mesh})
    # Phase 12 after the mesh path's state is freed.
    held = free_card()
    families, families_launches, k6_moonshot_row = run_families_path(device)
    emit({"phase": "families_path", "gpu": gpu, "held_before_gib": held,
          **families})
    # Phase 13 after phase 12's models are freed.
    held = free_card()
    ssm, ssm_launches, k6_jamba_row, k2_jamba = run_ssm_families_path(device)
    emit({"phase": "ssm_families_path", "gpu": gpu, "held_before_gib": held,
          **ssm, "k6_at_jamba": k6_jamba_row, "k2_at_jamba": k2_jamba})
    # Phase 14 after phase 13's models are freed.
    held = free_card()
    resilience, resilience_launches = run_resilience_path(
        device, train["losses"], elastic)
    emit({"phase": "resilience_path", "gpu": gpu, "held_before_gib": held,
          "launches": resilience_launches, **resilience})
    # Phase 15 after phase 14's state is freed.
    held = free_card()
    train_rest, train_rest_launches = run_train_rest_path(device,
                                                          train["losses"])
    emit({"phase": "train_rest_path", "gpu": gpu, "held_before_gib": held,
          "launches": train_rest_launches, **train_rest})
    # Phase 16 after phase 15's state is freed.
    held = free_card()
    dryrun_out, dryrun_launches = run_dryrun_path(
        device, train["step_ms_median_2_6"])
    emit({"phase": "dryrun_path", "gpu": gpu, "held_before_gib": held,
          "launches": dryrun_launches, **dryrun_out})
    for row in kernels:
        name = row.get("counter", row["name"])
        row["launches_by_path"]["resilience"] = resilience_launches.get(
            name, 0)
        row["launches_by_path"]["train"] = train_launches.get(name, 0)
        row["launches_by_path"]["mesh"] = mesh_launches.get(name, 0)
        row["launches_by_path"]["families"] = families_launches.get(name, 0)
        row["launches_by_path"]["ssm_families"] = ssm_launches.get(name, 0)
        row["launches_by_path"]["train_rest"] = train_rest_launches.get(
            name, 0)
        row["launches_by_path"]["dryrun"] = dryrun_launches.get(name, 0)
        row["launches"] = sum(row["launches_by_path"].values())
        if name == "a2a_fence_bulk":
            row["jamba"] = {k: k2_jamba["prefill"][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "library_ms")}
        if name == "a2a_fence_bulk":
            row["grad_sync"] = train["grad_sync"]["k2_at_sync_shape"]
        if name == "gather_matmul_wgmma":
            row["moonshot"] = {k: k6_moonshot_row[k] for k in (
                "shape", "f_tiles", "ms", "queued_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_queued_ms", "max_abs_err")}
            row["jamba"] = {k: k6_jamba_row[k] for k in (
                "shape", "f_tiles", "d_stages", "ms", "queued_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_queued_ms",
                "max_abs_err", "up_max_abs_err")}

    # Phase 17 after phase 16's state is freed: ranks in processes.
    held = free_card()
    t0 = time.perf_counter()
    procs, procs_launches, procs_rows = run_procs_path(device)
    emit({"phase": "procs_path", "gpu": gpu, "held_before_gib": held,
          "seconds": time.perf_counter() - t0, **procs})
    for row in kernels:
        name = row.get("counter", row["name"])
        row["launches_by_path"]["procs"] = procs_launches.get(name, 0)
        row["launches"] = sum(row["launches_by_path"].values())
    kernels.extend(procs_rows)

    print(gpu_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
