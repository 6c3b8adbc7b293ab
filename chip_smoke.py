#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--k 22] [--tau 64]

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. ``device``  the card's name and power limit (``nvidia-smi``).
2. ``build``   nvcc builds each CUDA source in ``src/repro_torch/kernels/
               csrc`` (one process per source, all at once) and Triton
               compiles the GMM step, with their seconds and ptxas lines;
               ``cuobjdump -sass`` counts the tensor-core instructions of
               the flash libraries (``HGMMA`` for wgmma, ``HMMA`` for
               mma.sync), which must be there; a ``RecompileWatch``
               counts the builds as compile events (K2's first launch must
               report one).
3. ``data``    songs-sim at the paper's Songs widths (n = 237,698,
               dim = 5000, 16 genres, rank ~89), generated on the card.
4. ``kernels`` every kernel against its plain PyTorch version on the card,
               at test shapes and at the main path's shapes; K3 also
               against its exact oracle, under the blocked scan's index
               contract.
5. ``solve``   the sequential path: ``solve_dmmc(setting="sequential",
               metric="cosine", variant="sum", engine="host")`` with launch
               counts set to 0 before and read after. K1 is held to its
               plain version at the solve's coreset rows, and the final
               stage on the plain pdist must select the same points. Then
               the same solve on the plain versions (``force="ref"``) must
               give the same centres, coreset and selection (or a GMM tie,
               printed), and the same value with the diagonal out.
6. ``stream``  the streaming path (Alg. 2 blocked scan, radius variant,
               ``block_size=128``): ``stream_coreset`` on the kernel path;
               the same stream through ``ingest_batch(force="ref")`` in
               batches of 16,384 rows must give the same state bit for bit;
               blocked must equal per-point on a 2,048-point prefix; a
               64-block window under the profiler must show at most 5
               CUDA kernels a block (printed per block: kernels, copies,
               K3 launches, replays, recomputes); K3's stats route at the
               main path's shape against the final centers, and its fused
               route (the scan's) against its plain version on 8 blocks
               after the mid-pass state and 8 against the final one (z
               equal on quiet rows, a flag differing only near a
               boundary); then ``solve_dmmc(setting="streaming")`` with
               launch counts set to 0 before and read after, whose coreset
               must be the scan's snapshot.
7. ``timing``  each kernel, its plain version and (K1) a library call, at
               the inputs the main path gave it, with the least time the
               card could take for the same work; K3's two routes with
               their device time per launch and cluster shape; the GMM
               loop alone.
8. ``engines`` the batched final-stage engines on the solve's own
               coreset (m rows, songs-sim genres and caps, k, D from K1):
               ``_final_solve`` with ``engine="jit_sum"`` and ``"auto"``
               (which must run jit_sum) selects what ``engine="host"``
               selects; a batch of 32 sum queries (k 4..k, caps at most the
               genre caps, allow masks dropping ~25% of the rows, gamma 0 or
               0.01) through ``JitSumBatchEngine`` equals the host engine
               query for query, or diverges first at a printed float tie
               (batch synced, median of 3, beside the host loop and B = 1);
               16 transversal queries (genre + up to two labels, gamma 3)
               against the host engine under the ``TransversalMatroid``;
               16 star and 16 tree ``jit_greedy`` queries equal to the same
               engine on the CPU; ``solve_stacked`` over 4 lanes (cosine and
               raw-Euclidean D, two sets of caps each) bit-identical to
               per-lane solves. The phase runs under ``obs`` spans and a
               ``RecompileWatch``: runs 2 and 3 of the timed batch compile
               nothing (vacuous while no engine path compiles: eager
               PyTorch reaches no nvcc, Triton or dynamo compile there);
               profiles of the batch stopped after its greedy seed and
               after one sweep give kernels per v-step and the busy share.
               Launch counts are read around the phase, which
               runs after the stream and the timing, so it leaves no state
               in their numbers.
9. ``serve``   songs-sim served through ``DiversityService(metric=
               "cosine", block_size=128)`` on the card, launch counts set
               to 0 before it and read after its main path: ``warmup(d)``
               (builds K3's and K1's libraries); tenants ``default``
               (the genre caps), ``tight`` (caps halved, floor 1; it
               shares ``default``'s entry when the keys are equal, which
               the line prints) and ``uniform``; the first half in
               batches of 16,384 host rows through ``ingest``, the rest
               through ``submit`` while a second thread runs
               ``query_batch`` on ``default``, then ``flush()``. Checks:
               the published snapshot (``src_idx``, the epoch triple)
               equals ``ingest_batch_donated`` called directly on the
               same batches (each normalized on the card); every
               concurrent answer names an epoch published before it
               returned; ``min_epoch=flush()`` answers from the newest
               epoch; 32 sum queries select with ``engine="auto"`` what
               ``"host"`` selects, and ``host`` what ``final_solve``
               selects on the snapshot's coreset; each tenant's D within
               K1's tolerance of the plain pdist on its entry's points; a
               second batch on one epoch launches no K1; K1's launches
               equal the cache's builds; the first ingest after warmup
               compiles nothing. Printed: ingest points/s through
               ``ingest`` and ``submit`` + ``flush`` beside the
               ``stream`` phase's, publish latency, materializations,
               staleness p50/p99, K1 build seconds per tenant,
               ``query_batch`` seconds at B = 1 and 32 for ``auto`` and
               ``host`` (median of 3), the cost model's last decisions,
               and whether the snapshot equals the ``stream`` phase's.
10. ``durable`` songs-sim (the ``serve`` phase's batches) served by a
               ``ReplicaSet`` on the card: a primary and one hot standby,
               each with its own write-ahead log and checkpoints
               (``checkpoint_every=4, keep=2``) in a ``tempfile.mkdtemp()``
               directory (its free space printed; removed at the end),
               through the coalescing frontend, tenants ``default`` and
               ``uniform``, launch counts set to 0 before it. The batches
               go in through ``rs.submit`` while 8 threads run
               ``rs.query_batch`` (4 sum queries each, both tenants); a
               seeded ``FaultRule(site="worker.loop", kind="crash")`` kills
               the primary's worker half-way, and the set fails over to
               the standby (a read of the dead primary before the
               promotion is retried, and counted). Checks: the crash fired,
               ``last_failover`` names the promotion, ``n_offered`` is n
               and every acknowledged batch applied; the promoted
               primary's snapshot (``src_idx``, epoch triple) equals the
               ``serve`` phase's direct scan; every concurrent answer
               names an epoch published before it returned; 32 host
               queries from 8 threads through the coalescer select what a
               single caller's direct path selects, query for query, on
               one epoch, with groups of more than one call on average;
               ``IntegrityAuditor`` is clean, and a swapped-in entry whose
               ``D`` on the card, then whose ``D_host``, is off by +10 is
               a ``pdist`` violation; ``HealthMonitor.probe()`` is
               healthy; after ``rs.close()``, ``DiversityService.restore``
               of the promoted replica's directory, as closed and then
               with its newest checkpoint torn (the older checkpoint and
               the log's tail), equals the direct scan, launches K3 at
               least once a replayed block and answers as the promoted
               primary did. Printed: durable ingest points/s beside the
               ``serve`` phase's, WAL bytes, append seconds (crc + write)
               a batch, compactions, checkpoints with bytes and save ms,
               standby lag, failover seconds, restore seconds, coalescing
               (groups, calls a group, queue wait p50/p99, stacked
               solves, stale reads) and ``query_batch`` latency under
               coalescing beside the ``serve`` phase's direct path.
11. ``mapreduce`` songs-sim in the MapReduce setting on an in-process
               mesh of 8 positions on the card (``make_mesh((8,),
               ("data",), devices=["cuda"] * 8)``: ell = 8, the largest of
               ``benchmarks/fig3_mapreduce.py``, tau 64 so 8 centers a
               shard): (a) ``solve_dmmc(setting="mapreduce",
               metric="cosine", variant="sum", engine="host")`` without
               and with ``round2_tau=16``, launch counts set to 0 before
               and read after (K2 8 x 8 a round-1 solve plus 16, K1 once a
               final stage); (b) the same two solves on the plain versions
               (``force="ref"``) give the same coreset and selection (or
               part at a GMM tie, printed, as in ``solve``) and values
               equal with the diagonal out; (c) each selection a basis of
               the partition matroid, round 2 smaller than round 1, no
               overflow, the union's rows the points its ``src_idx``
               names; (d) both values beside the ``solve`` phase's
               sequential value, against the reference test's bounds
               (MR >= 0.95 x, round 2 >= 0.90 x; printed, not gated);
               (e) ``distributed_coreset`` with tau 64: K2 8 x 64
               launches, the centers of ``gmm_fixed`` on the whole array
               (or a printed tie), radius and delta within 1e-5, a
               non-empty coreset, and no host sync inside the traversal
               (``torch.cuda.set_sync_debug_mode``); (f) a
               ``StreamRuntime`` with 4 shards under
               ``placement="shard_map"`` over the ``serve`` phase's
               batches equals ``placement="vmap"`` bit for bit (state,
               epoch triple, fingerprint), and its checkpoint restores to
               it. Printed: seconds of each solve beside the sequential's,
               one reducer's SeqCoreset seconds, the union size, the
               global GMM's seconds beside ``gmm_fixed``'s, each
               placement's ingest seconds, the launches of (a), (e), (f).
12. ``lm``     the serving path of the LM stack at zamba2-7b's full width
               (81 Mamba2 layers, one shared attention block applied 13
               times, bf16, random weights from ``LM.init`` at ``--seed``):
               (a) K4 (flash forward) and K6 (SSD intra-chunk) against
               their plain versions at test shapes and at one layer's own
               inputs, captured from a prefill; (b) ``Engine.generate`` for
               24 prompts of 1,024 tokens and 16 new tokens, with launch
               counts set to 0 before and read after, then the same on the
               plain versions (``force="ref"``). The prefill run block by
               block on the plain path, each block also on the kernel path
               from the same input, must agree within 2e-2 of the largest
               value (each block's output, and the logits of the last);
               end to end, the prefill logits must agree within 2e-2 of
               the largest logit or within twice the difference that one
               bf16 step on 1e-4 of the embedding makes on the plain path
               (this random-weight model's own sensitivity); with the
               weights upcast to f32 (no bf16 rounding between layers) the
               two prefills' logits must agree within 2e-2; and the
               greedy tokens wherever the plain top-2 gap clears twice the
               logit difference; (c) the diverse selection of
               ``examples/serving_diverse.py``: each continuation embedded
               as the mean of ``forward``'s output, then ``solve_dmmc(k=6,
               tau=12, setting="sequential", metric="cosine")`` under a
               partition matroid of 4 intents with caps of 2, launch counts
               read around it; (d) one prefill and one decode step under
               the profiler, then K4 and K6 timed at the slice's shapes
               beside their plain versions, their bounds and (K4)
               ``scaled_dot_product_attention``, with K4's route (bf16:
               the tensor cores), TFLOP/s and kernel / library ratio.
13. ``train``   the training path at smollm-135m's full width and depth
               (bf16, random weights, batch 16 x 2,048, diverse selection
               on): (a) K5 (flash backward) against its plain version at
               test shapes, and K5 and K4 at one layer's own inputs,
               captured from a backward; (b) five steps of
               ``make_train_step`` with launch counts set to 0 before and
               read after (K2, K4, K5); the selection on plain GMM must
               pick the same batches; the same five steps on the plain
               versions: step i's loss within 2 (i + 1) times the largest
               difference that one bf16 step on 1e-4 of the embedding
               makes on the plain path up to step i; in f32, the step-0
               loss within 1e-5 and every gradient leaf within 1e-3
               relative L2; (c) ``launch.train.main`` preempted by SIGTERM
               after step 4, resumed to 6, equal to an uninterrupted run
               bit for bit; (d) step time, tokens/s, peak memory, a step
               under the profiler, and K5 beside its plain version, its
               bound and the backward of ``scaled_dot_product_attention``
               (route, TFLOP/s, ratio).
14. ``train_sharded`` training sharded over a data axis (FSDP) on an
               in-process ``("data",)`` mesh whose positions all sit on
               the one card (they run in turn; NCCL takes no two ranks on
               one GPU, so no collective crosses a wire here):
               smollm-135m at full width and depth, 16 x 2,048, bf16, 3
               steps on 4 positions (diverse selection inside, launch
               counts set to 0 before and read after: K2 tau a step, K4
               and K5 4 x the unsharded step's) against 3 unsharded steps
               from the same state under the ``train`` phase's bf16 rule
               (three nudged unsharded runs give its floor); in f32 at 4 x
               1,024, one step on 4 positions against one unsharded (loss
               within 1e-5, every parameter and moment leaf within 1e-3
               relative L2), then a second, a checkpoint, restored onto 2
               positions for a third, against 3 unsharded steps to the
               same limits; zamba2-7b at full width and one super block
               (6 layers, the least depth whose shared attention block
               trains), f32, 1 step on 2 positions against unsharded
               (K4, K5, K6, K6b inside), then 3 warm steps of each arm,
               alternating, for their median step times. Printed: both
               arms' step times and peaks, each position's share of
               parameter and optimizer bytes from the specs, each arm's
               launches (the kernels line's column sums the sharded steps
               of all three, each counted from its own reset), and that
               the NCCL run did not run (one card).
15. ``train_tp`` tensor-parallel training (the reference's
               ``param_specs(..., tp="model")``) on in-process ``("data",
               "model")`` meshes of the one card, each position computing
               its own heads, MLP columns and vocab columns: smollm-135m
               at full width and depth on (2, 3) (3 query heads and 1 kv
               head a position), 16 x 2,048, bf16, 3 steps (diverse
               selection inside, launch counts set to 0 before and read
               after: K4 and K5 6 x the unsharded step's, each call on a
               sixth of its B x heads rows) against 3 unsharded steps from
               the same state under the ``train`` phase's bf16 rule, then
               2 warm steps of each arm, alternating, for the step times,
               and one more of each under the profiler (busy share, top
               kernels);
               in f32 at 4 x 1,024, one step against one unsharded (loss
               within 1e-5, every parameter and moment leaf within 1e-3
               relative L2); musicgen-medium at full width and 4 of its 48
               layers on (1, 4) (6 heads a position, GELU, untied head),
               one bf16 step against one unsharded under the same rule,
               K4 and K5 4 x. Each arm's step-0 collective bytes by kind
               (the data axis's gathers and reduce-scatters, the model
               axis's reduce-outs, copy-ins and max) must equal the dry
               run's count for its shape (``dryrun.fsdp_collectives`` with
               ``tp``, ``dryrun.tp_collectives``). In each arm K4 and K5
               are held against their plain versions at the inputs of
               their first calls on a position's own heads (the ``train``
               phase's tolerances), after the arm's launches are read.
               Printed: step times, peaks and those bytes beside the
               unsharded arms'.
16. ``dryrun``  the port's dry run (``launch/dryrun.py``) of the ``train``
               phase's own cell, smollm-135m at 16 x 2,048 on one position,
               counted on meta tensors (no kernel launches: the counts are
               read around it and must stay 0): its ``argument_bytes``
               within 1% of what ``init_train_state`` and the batch
               allocate on the card; its predicted peak against the peak
               of the traced program itself (one plain-path step from that
               state) and against the ``train`` phase's measured peak,
               both ratios within ``DRYRUN_PEAK_BAND``; one full-size
               production cell on meta (``DRYRUN_FULL_CELL``), timed.
               Printed on a line of its own: MODEL_FLOPS of the cell over
               the ``train`` phase's step time at 989 TFLOP/s, the port's
               first share of a whole step.
17. ``examples`` the five twins of ``examples/*.py``
               (``python -m repro_torch.examples.<name>``) on the card at
               their default sizes, all at once, each a subprocess that
               must exit 0 within ``EXAMPLES_TIMEOUT_S``; each one's
               seconds and its kernel launches (``diverse_training``'s are
               in its two ``launch.train`` children), logs under
               ``build/chip_smoke_examples/``.
18. ``train_ssm`` the training path of the ssm and hybrid families: (a) K6b
               (the SSD intra-chunk backward) against its plain version at
               test shapes (q 1, 16, 48, 100, 256; per-cell B and C, and
               the model's layout with B and C shared by the heads), and at
               one Mamba2 layer's own inputs, captured from a backward of
               (b), each gradient within 2e-4 of the plain version's
               largest entry and bit-identical on a repeat; (b)
               mamba2-2.7b at its full width and 16 of its 64 layers
               (bf16, random weights) trained at batch 8 x 2,048 (q = 256, 8
               chunks), diverse selection on: 3 steps of
               ``make_train_step`` with launch counts set to 0 before and
               read after (K6 twice a layer a step with remat, K6b once,
               K2 tau a step, the flash kernels never), the same batches
               on the plain versions and with the embedding nudged three
               times (the ``train`` phase's bf16 loss rule, its floor the
               largest of the three nudges), a repeated first step
               bit-identical, an f32 gradient check on 1 x 2,048 (loss
               within 1e-5, every leaf within 1e-3 relative L2); step
               time, tokens/s, peak memory, a profiled step, K6 and K6b
               timed at the captured inputs beside their plain versions
               and bounds, and K6b checked and timed at zamba2-7b's layer
               shape (16 x 112 cells of (256, 64, 64), seeded), each
               timing with K6b's grid, head slices, shared memory,
               registers and blocks an SM; (c) zamba2-7b at full width
               and 12 layers (2 super blocks, each with the shared
               attention block; full depth does not fit one card for
               training), one step at batch 2 x 2,048 through K4, K5, K6
               and K6b in one graph, its launches counted, against the
               plain path under the rules of (b).
19. ``train_tp_ssm`` the ssm and hybrid families trained tensor parallel
               (ROADMAP step 13.8) on in-process ``("data", "model")``
               meshes of the one card, each position running its own
               Mamba2 heads (``in_proj`` and the conv gathered whole over
               the model axis, B and C whole): (a) mamba2-2.7b at full
               width and 8 of its 64 layers, the ``train_ssm`` batch 8 x
               2,048 (diverse selection before the counts), bf16, 3 steps
               each on (1, 2) and (2, 2) (40 of 80 heads a position: K6
               and K6b on 64 and 32 x 40 cells of (256, 64, 128)) against
               3 unsharded kernel-path steps from the same parameters
               under the ``train`` phase's bf16 rule (three nudged
               unsharded runs), then 2 warm steps of each arm for its step
               time; launch counts set to 0 before and read after (K6 and
               K6b once a position as often as unsharded, each call's
               cells and heads the position's share), each arm's step-0
               collective bytes equal to the dry run's, its peak, K6 and
               K6b against their plain versions at each position's
               first-call inputs of one more step (outside the counts and
               the peak), K6 and K6b timed at a (1, 2) position's inputs;
               one f32 step at 2 layers on 1 x 2,048 on (1, 2) against
               one unsharded (loss within 1e-6 relative; every leaf of
               the gradient, read as the first moment, and of the second
               moment within 1e-4 relative L2; the parameters' worst leaf
               printed beside what an unsharded step on the plain path
               differs by there);
               (b) zamba2-7b at full width and one super block on (1, 2)
               (56 of 112 Mamba heads and 16 of 32 attention heads a
               position), the ``train_sharded`` batch 2 x 1,024, 3 bf16
               steps against unsharded by the same rules, K4 and K5 of
               the shared block held and counted as K6 and K6b are, and
               its f32 step on 1 x 1,024.
20. ``moe``    the moe family at full width and reduced depth (bf16,
               random weights): (a) phi3.5-moe-42b-a6.6b at 16 of its 32
               layers (top-2 of 16 experts, capacity 1.25: 160 slots a
               sequence) serving 8 prompts of 1,024 tokens + 16 new, and
               (b) llama4-maverick-400b-a17b at one ``moe_pair`` (top-1 of
               128 experts, 10 slots) serving 4 x 1,024 + 8, each through
               ``Engine.generate`` on the kernel path (launch counts set to
               0 before and read after: K4 once an attention layer) and on
               the plain path: K4 against its plain version at the first
               layer's captured inputs (GQA 32/8, 40/8, hd 128); the
               greedy tokens as in ``lm``; the kept share of the prefill's
               routes and the share of (layer, token, choice) routes that
               the two paths' prefills agree on; the kernel path's prefill
               logits against a plain prefill routed as the kernel path
               routed (a near-tie's flip changes a token wholly, and these
               random-weight models carry it to every later token), within
               2e-2 of the largest logit or twice what nudged embeddings
               move them, each replayed flip a near-tie; (c) phi3.5-moe at
               2 layers trained at batch 4 x 2,048: K5 at a layer's
               captured backward, 3 AdamW steps with launch counts (K4 12,
               K5 6) against the plain path under the ``train`` phase's
               nudge rule, the aux on both paths, an f32 gradient check at
               1 layer on 1 x 1,024 (the plain path replaying the kernel
               path's routes); K4 and K5 timed at phi3.5-moe's shapes
               beside SDPA and their bounds; (d) the same 2-layer
               phi3.5-moe, parameters and batches trained on meshes of
               in-process positions of the card (ROADMAP steps 13.5 item
               1 and 13.9): FSDP on (2,) ("data") and (2, 2) ("data",
               "model": 16 heads, 4 kv heads and 8 of the 16 experts a
               position), 3 steps each: every microbatch's routing pass
               (the blocks without gradients, no head) before the
               gradient passes, which replay its routes with the expert
               counts summed over the data positions; launch counts (K4
               3 x and K5 1 x layers x positions a step), the rows of
               every K4/K5 call (B x heads over the positions), K4 and K5
               against their plain versions at a position's first-call
               inputs, the bf16 losses against the unsharded kernel path
               under the ``train`` phase's nudge rule (nudges on the
               kernel path), collective bytes a position equal to the dry
               run's count, step time, peak and the routing pass's share
               of the step beside the unsharded step's; then one f32 step
               at 1 layer on 2 x 1,024 on both meshes against the
               unsharded f32 step (routes replayed from it, each flip a
               near-tie; loss within 1e-5, every parameter and moment
               leaf within 1e-3 relative L2); K4 and K5 timed at the
               (2, 2) mesh's per-position shape.
21. ``vlm``    llama-3.2-vision-90b at full width: (a) 2 of its 20 super
               blocks (10 layers) serving 4 prompts of 1,024 tokens + 16
               new over seeded image embeddings (4 x 1,024 x 8,192, 0.1 x
               normal) on both paths as in ``moe`` (K4 10 launches a
               prefill: 8 self-attention, 2 cross attention; K4 checked at
               the first cross-attention layer's inputs: 256 x 1,024 x
               1,024 x 128, not causal); (b) 1 super block, batch 2 x
               1,024 with images: the loss and every gradient leaf on the
               kernel path (K4 10, K5 5 launches) within twice what nudged
               embeddings move them on the plain path (no AdamW step: the
               f32 moments would not fit beside the weights and
               gradients); K5 checked at the cross attention's captured
               backward; K4 and K5 timed at the cross-attention shape
               beside SDPA and their bounds.
22. ``train_tp_heads`` tensor parallel for the vlm (ROADMAP step 13.10)
               and with the heads resharded where the model axis does not
               divide the kv heads (step 13.11), on in-process ``("data",
               "model")`` meshes of the one card: (a) the ``vlm`` phase's
               training block (llama-3.2-vision-90b at full width, one
               super block, 2 x 1,024 with 1,024 image tokens, bf16) on
               (1, 2) (32 heads and 4 kv heads a position) and (1, 16) (4
               heads a position, their kv head's ``wk``/``wv`` columns
               half on each of two positions, regrouped): ``LM.tp_loss``
               and its gradients, no AdamW (as ``vlm``), with launch
               counts set to 0 before and read after (K4 and K5 on every
               position, causal and cross, as often as unsharded, each
               call on 2 x its heads' rows), the loss and every gradient
               leaf within twice what nudged embeddings move the plain
               path's (the ``vlm`` rule), the collective bytes equal to
               the dry run's, K4 and K5 against their plain versions at
               each position's captured inputs, causal and cross, a warm
               forward and backward's time and the peak; (b) smollm-135m
               at full width on (2, 4) (2, 2, 2 and 3 of its 9 heads a
               position; ``wq``, ``wk``, ``wv`` and ``wo`` regrouped), 16
               x 2,048 random tokens, 3 bf16 AdamW steps against 3
               unsharded ones under the ``train`` phase's nudge rule, 2
               warm steps of each for the step times, launches, rows and
               bytes as in (a), K4 and K5 at each position's captured
               inputs, and one f32 step at 4 x 1,024 against one
               unsharded (``train_tp``'s f32 rule); K4 and K5 timed at
               the cross attention's per-position shapes on (1, 2) and
               (1, 16) and the self-attention's on (1, 16), beside SDPA
               and their bounds.
23. ``serve_tp`` prefill and greedy decode on in-process ``("data",
               "model")`` meshes of the one card (ROADMAP step 13.12),
               ``Engine(..., mesh=)`` over ``LM.tp_prefill`` and
               ``LM.tp_decode_step``, each position holding its slices of
               the parameters and of the caches: (a) zamba2-7b at full
               width and depth on (2, 2) (56 of 112 Mamba heads and 16 of
               32 attention heads a position), the ``lm`` phase's traffic
               (24 x 1,024 prompts + 16 new tokens, bf16, the same seeded
               weights and prompts), against the unsharded ``Engine``: the
               mesh's greedy run with launch counts and collective bytes
               set to 0 before and read after (K4 once an attention layer
               and K6 once a Mamba2 layer, per position and data row, each
               K4 call on a row's rows x the position's heads; the bytes
               equal to the dry run's ``serve_collectives``, to the byte),
               the share of greedy tokens equal to the unsharded run's,
               then a run fed the unsharded run's tokens: the prefill's
               and every decode step's logits within 2e-2 of the largest
               logit, or within twice what one bf16 step on 1e-4 of the
               embedding moves the unsharded run's (the ``lm`` rule);
               ``prefill_s``, decode ms a token and the peak beside the
               unsharded run's (the unsharded weights freed before the
               mesh's run); K4 and K6 against their plain versions at a
               position's captured inputs and timed there beside their
               bounds (and SDPA); the same model at 12 layers in f32 on 4
               x 1,024 prompts + 4 tokens, every step's logits within 1e-4
               of the largest unsharded logit; (b) smollm-135m at full
               width and depth on (2, 4) (2, 2, 2 and 3 of its 9 heads a
               position, its 3 kv heads regrouped: a kv head read by two
               positions is cached on both), 16 x 1,024 + 16, held the
               same way.
24. ``serve_tp_layouts`` the reference's "hd" and "seq" kv cache layouts
               (ROADMAP step 13.13): granite-3-8b at full width and depth
               (40 layers, 32 heads, 8 kv heads, hd 128; bf16, seeded
               weights), 4 x 1,024 prompts + 8 greedy tokens into
               ``Engine(max_len=2056)`` caches, served unsharded once and
               on (1, 16) under ``cache_mode="auto"`` (the reference's
               pick, "hd": 2 query heads and 8 of the 128 columns of every
               kv head a position) and on (1, 4) under "seq" (514 slots a
               position; the decode's writes cross from position 1 to 2
               at slot 1,028), each held as ``serve_tp``'s arms are
               (launches, bytes equal to ``serve_collectives(mode=)``,
               the logits' nudge rule, tokens free running and fed the
               unsharded ones, prefill s, decode ms a token and peak
               beside the unsharded run's, K4 at position 0's captured
               inputs), with a position's cache bytes beside the "heads"
               layout's on the same mesh; K4 timed at each arm's
               per-position shape; the same model at 4 layers in f32 on
               2 x 256 + 4 in both layouts, logits within 1e-4 of the
               largest and every token equal.

The last two lines are the kernel table and ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the repository beside it, it fails.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit). The card
# multiplies f32 operands on its tensor cores (TF32, and 3xTF32 at f32
# accuracy), so the operation part of every f32 kernel's bound takes the
# TF32 rate: no f32 kernel can beat its own bound.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12  # dense, tensor cores
BF16_FLOPS_PER_S = 989e12  # dense, tensor cores

PDIST_SHAPES = [(8, 8, 4), (33, 17, 7), (128, 64, 32), (200, 300, 25),
                (5, 1000, 3)]
GMM_SHAPES = [(16, 4), (100, 25), (1025, 7), (64, 128),
              (64, 32)]  # the last: the train pipeline's pool x embedding
PRECHECK_SHAPES = [(8, 5, 4), (37, 17, 7), (128, 33, 100), (200, 129, 25),
                   (128, 257, 100)]
CUDA_SOURCES = ("pdist", "precheck", "flash_fwd", "flash_bwd", "ssd",
                "ssd_bwd")
# (BH, Sq, Skv, hd, causal): tests/test_kernels.py's FLASH_SHAPES, then
# hd in {64, 112, 128} with S off the 64-row tile, causal and not, then
# edges of the bf16 tensor-core tiles (hd 40 and 256, S off 128 rows)
FLASH_SHAPES = [(4, 64, 64, 16, True), (2, 48, 80, 32, False),
                (3, 33, 33, 8, True), (1, 128, 128, 64, True),
                (2, 96, 32, 16, False), (3, 100, 100, 64, True),
                (2, 200, 200, 112, True), (2, 130, 257, 112, False),
                (2, 70, 70, 128, True), (2, 90, 150, 128, False),
                (2, 255, 129, 40, True), (2, 129, 255, 256, False)]
# the SASS of the tensor-core routes: flash_fwd and ssd_bwd must hold
# wgmma, flash_bwd and ssd wgmma or mma.sync
TENSOR_CORE_SASS = {"flash_fwd": ("HGMMA",), "flash_bwd": ("HGMMA", "HMMA"),
                    "ssd": ("HGMMA", "HMMA"), "ssd_bwd": ("HGMMA",)}
# (g, q, p, n): tests/test_kernels.py's SSD_SHAPES, then model widths; each
# takes the per_cell route
SSD_SHAPES = [(2, 16, 8, 4), (3, 32, 16, 8), (1, 64, 32, 16), (4, 8, 64, 32),
              (5, 256, 64, 64), (3, 256, 64, 128), (7, 100, 64, 64)]
# (batch * chunks, heads, q): the model's layout, B and C stride-0 head
# views, which takes the shared_bc route (q = 16 packs four heads a block)
SSD_MODEL_SHAPES = [(6, 8, 256), (6, 12, 16)]
# (g, q, p, n) of K6b with per-cell B and C: q 1 and 16 (one partial tile),
# 48, 100 and 256 (the model's chunk), then q, p and n off every tile;
# then (batch * chunks, heads, q, n) in the model's layout, B and C shared
# by the heads (shared_bc), the last a head count that no head slice
# divides
SSD_BWD_SHAPES = [(3, 1, 16, 8), (4, 16, 64, 64), (3, 48, 64, 128),
                  (2, 100, 64, 72), (3, 256, 64, 128), (2, 200, 33, 100)]
SSD_BWD_MODEL_SHAPES = [(2, 8, 1, 128), (6, 112, 16, 64), (3, 12, 48, 128),
                        (4, 80, 256, 128), (3, 13, 100, 64)]
# zamba2-7b's layer shape for K6b (batch 2 x 2,048: 16 batch * chunks x
# 112 heads of (256, 64, 64)), from seeded inputs
SSD_BWD_HYBRID_SHAPE = (16, 112, 256, 64)
SSD_BWD_TOL = 2e-4  # of each gradient's largest entry, as K6's tests
# rows of x against itself (K1's sym route): the songs-sim solve's coreset
# (327 at seed 0) and k * tau
PDIST_SELF_ROWS = (327, 1408)
LM_ARCH = "zamba2-7b"
LM_BATCH, LM_PROMPT, LM_STEPS = 24, 1024, 16  # examples/serving_diverse.py:24
LM_K, LM_TAU, LM_INTENTS, LM_CAP = 6, 12, 4, 2
LM_LOGIT_TOL = 2e-2
LM_HEADS = 32  # zamba2-7b's attention heads (BH = batch x heads)
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 2048, 5  # SmolLM-135M's context
TRAIN_CLI_STEPS, TRAIN_PREEMPT_AT = 6, 4
TRAIN_F32_LOSS_TOL, TRAIN_F32_GRAD_TOL = 1e-5, 1e-3
# the train_sharded phase: positions of the in-process data axis on the
# one card, the f32 check's batch, the elastic restore's positions, and
# zamba2-7b at one super block (shared_attn_every = 6 layers: at fewer the
# plan has no super block, and the shared attention block would get no
# gradient)
SHARD_POSITIONS, SHARD_STEPS, SHARD_NUDGES = 4, 3, 3
SHARD_F32_BATCH, SHARD_F32_SEQ, SHARD_RESTORE_ONTO = 4, 1024, 2
SHARD_HYBRID_LAYERS, SHARD_HYBRID_POSITIONS = 6, 2
SHARD_HYBRID_BATCH, SHARD_HYBRID_SEQ = 2, 1024
SHARD_HYBRID_TIMED = 3  # warm steps of each arm behind the step times
# the train_tp phase: tensor parallel on in-process ("data", "model")
# meshes of the one card: smollm-135m on (2, 3) (9 heads and 3 kv heads:
# 3 and 1 a position), its f32 check's batch, and musicgen-medium at full
# width and 4 of its 48 layers on (1, 4) (24 heads: 6 a position)
TP_MESH, TP_STEPS, TP_NUDGES, TP_TIMED = (2, 3), 3, 3, 2
TP_F32_BATCH, TP_F32_SEQ = 4, 1024
TP_AUDIO_ARCH, TP_AUDIO_LAYERS, TP_AUDIO_MESH = "musicgen-medium", 4, (1, 4)
TRAIN_SSM_ARCH = "mamba2-2.7b"
TRAIN_SSM_BATCH, TRAIN_SSM_SEQ, TRAIN_SSM_STEPS = 8, 2048, 3
# the train_ssm phase's mamba2-2.7b at 16 of its 64 layers (cut from 64 to
# make room for serve_tp within the script's time)
TRAIN_SSM_LAYERS = 16
# the train_tp_ssm phase: mamba2-2.7b at full width and 8 of its 64
# layers (the TRAIN_SSM_* batch) on (1, 2) and (2, 2) (40 of 80 heads a
# position), its f32 check at 2 layers on 1 x 2,048; zamba2-7b at one
# super block (the SHARD_HYBRID_* batch) on (1, 2) (56 of 112 Mamba heads
# and 16 of 32 attention heads a position), its f32 check on 1 x 1,024:
# the loss within 1e-6 relative of the unsharded step's, every gradient
# and second-moment leaf within 1e-4 relative L2 (the card tests' rule for
# a mesh step; 3.3e-5 and 5.2e-5 were the most measured on an H100)
TP_SSM_LAYERS, TP_SSM_MESHES, TP_SSM_TIMED = 8, ((1, 2), (2, 2)), 2
TP_SSM_F32_LAYERS, TP_SSM_F32_BATCH = 2, 1
TP_HYBRID_MESH, TP_HYBRID_F32_BATCH = (1, 2), 1
TP_SSM_F32_LOSS_TOL, TP_SSM_F32_TOL = 1e-6, 1e-4
TRAIN_SSM_F32_BATCH = 1  # the f32 copy of 2.83 B parameters and its grads
TRAIN_SSM_NUDGES = 3  # independent nudged embeddings behind the bf16 floor
# zamba2-7b trained at full width: 12 of its 81 layers (2 super blocks),
# since 6.8 B parameters x (2 + 2 + 8) bytes (bf16 weights and gradients,
# f32 moments) exceed one card before any activation
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_BATCH = "zamba2-7b", 12, 2
# the moe family at full width and reduced depth (weights bf16): phi3.5-moe
# served at 16 of 32 layers (21.07 B parameters, 42.1 GB), llama4-maverick
# at one moe_pair (2 of 48 layers, 18.43 B, 36.9 GB; top-1 of 128 experts:
# capacity 10 a sequence at S = 1,024), phi3.5-moe trained at 2 layers
# (2.86 B: weights, gradients and f32 moments 34.3 GB), its f32 gradient
# check at 1 layer on 1 x 1,024
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_STEPS = "phi3.5-moe-42b-a6.6b", 16, 8, 16
MAV_ARCH, MAV_LAYERS, MAV_BATCH, MAV_STEPS = ("llama4-maverick-400b-a17b",
                                              2, 4, 8)
MOE_PROMPT = 1024
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = (2, 4,
                                                                     2048, 3)
MOE_F32_LAYERS, MOE_F32_SEQ = 1, 1024
# the same phi3.5-moe training on meshes of the card: FSDP on 2 positions
# and ("data", "model") (2, 2); the f32 check's rows (2: one a data row)
MOE_MESHES = ((2,), (2, 2))
MOE_MESH_F32_BATCH = 2
# the vlm family: llama-3.2-vision-90b served at 2 of its 20 super blocks
# (10 layers, 10.66 B, 21.3 GB) with seeded image embeddings of 1,024
# tokens (tests/test_models.py:19's 0.1 x normal), trained at 1 super
# block (6.38 B, 12.8 GB): f32 moments beside it would not fit one card,
# so a forward and backward against the plain path, no AdamW step
VLM_ARCH, VLM_SUPERS, VLM_BATCH, VLM_PROMPT, VLM_STEPS = (
    "llama-3.2-vision-90b", 2, 4, 1024, 16)
VLM_TRAIN_SUPERS, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ = 1, 2, 1024
# the train_tp_heads phase: the vlm phase's training block on (1, 2) and
# (1, 16) in-process positions of the card, and smollm-135m at full width
# and depth on (2, 4) (the TRAIN_* batch, random tokens; its f32 step at
# TP_F32_BATCH x TP_F32_SEQ)
TP_HEADS_VLM_MESHES = ((1, 2), (1, 16))
TP_HEADS_MESH, TP_HEADS_LAYERS = (2, 4), 30
# the serve_tp phase: zamba2-7b at full width and depth on (2, 2) with the
# lm phase's traffic (LM_BATCH x LM_PROMPT + LM_STEPS), its f32 check at 12
# layers (2 super blocks) on 4 prompts and 4 steps within 1e-4 of the
# largest logit; smollm-135m at full width and depth on (2, 4), 16 x 1,024
# + 8
SERVE_TP_MESH = (2, 2)
SERVE_TP_F32_LAYERS, SERVE_TP_F32_BATCH, SERVE_TP_F32_STEPS = 12, 4, 4
SERVE_TP_F32_TOL = 1e-4
SERVE_TP_SMOLLM_MESH, SERVE_TP_SMOLLM_BATCH = (2, 4), 16
# the serve_tp_layouts phase: granite-3-8b at full width and depth in the
# reference's kv cache layouts, "auto" (its pick: "hd") on (1, 16) and
# "seq" on (1, 4), 4 x 1,024 prompts + 8 greedy tokens into caches of
# 2,056 slots (514 a position under "seq": the decode writes slots 1,024 to
# 1,030, crossing from position 1 to 2 at 1,028); its f32 check at 4 of 40
# layers on 2 x 256 + 4 in both layouts
LAYOUTS_ARCH = "granite-3-8b"
LAYOUTS_BATCH, LAYOUTS_PROMPT, LAYOUTS_STEPS, LAYOUTS_MAX_LEN = (4, 1024, 8,
                                                                 2056)
LAYOUTS_ARMS = (((1, 16), "auto"), ((1, 4), "seq"))
LAYOUTS_F32_LAYERS, LAYOUTS_F32_BATCH, LAYOUTS_F32_PROMPT = 4, 2, 256
LAYOUTS_F32_STEPS = 4
# the dryrun phase: the train phase's own cell counted on meta tensors at
# one position; the band its predicted peak must keep against the measured
# peaks (PERF.md section 6, PR 26: stated before the first chip run); the
# arguments within 1% of what init_train_state allocates; one full-size
# production cell on meta, timed
DRYRUN_PEAK_BAND = (0.90, 1.05)
DRYRUN_ARG_TOL = 0.01
DRYRUN_FULL_CELL = ("llama4-maverick-400b-a17b", "decode_32k", "single")
BF16_FLOPS_PER_S_DENSE = 989e12  # the step share's denominator
# the examples phase: the five twins of examples/*.py at their own default
# sizes, all at once, each a subprocess
EXAMPLES = ("quickstart", "streaming_topics", "diversity_service",
            "serving_diverse", "diverse_training")
EXAMPLES_TIMEOUT_S = 900
BLOCK = 128  # the streaming scan's block size on the main path
INGEST_BATCH = 16_384
PREFIX = 2048
TIE_RTOL = 1e-5
ENGINE_QUERIES, ENGINE_TV_QUERIES, ENGINE_GREEDY_QUERIES = 32, 16, 16
ENGINE_K_MIN = 4
ENGINE_TV_GAMMA = 3  # labels a row: wikipedia-sim, dmmc_paper.py:20-22
ENGINE_LANES = 4
# the mapreduce phase: ell = 8 is the largest of benchmarks/fig3_mapreduce.py:54,
# round 2 at tau 16 as tests/test_distributed.py:43; 4 shards for shard_map
MR_SHARDS, MR_ROUND2_TAU, MR_PLACEMENT_SHARDS = 8, 16, 4
MR_SEQ_FLOOR, MR_ROUND2_FLOOR = 0.95, 0.90  # tests/test_distributed.py:54-56


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, *, warmup: int = 3, reps: int = 20) -> float:
    """Median of CUDA-event timings of ``fn`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float,
             peak: float = TF32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_profile(fn, count: str = "", scope: str = "") -> dict:
    """Run ``fn`` once under ``torch.profiler`` and read the card's kernel
    events: their summed time, the span from the first kernel's start to
    the last one's end, the host wall time of the window (the profiler
    adds host overhead to it), the busy share of the span, the kernels
    with the most time, and how many of the device events are copies or
    fills (``Memcpy``/``Memset``), how many kernels, (``count``) how
    many events have that string in their name, and (``scope``) how many
    host events are that ``record_function`` scope."""
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
    # a record_function range also shows on the device timeline (a user
    # annotation spanning its kernels): count it as a scope, not a kernel
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    scopes = {e.name for e in host if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in scopes]
    scoped = sum(1 for e in host if e.name == scope) if scope else None
    if not kernels:
        return dict(wall_ms=wall * 1e3, device_ms=None,
                    note="the profiler showed no device events")
    by_name: dict[str, list] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us() / 1e3
        entry[1] += 1
    busy = sum(v[0] for v in by_name.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    copies = sum(v[1] for n, v in by_name.items()
                 if n.startswith(("Memcpy", "Memset")))
    return dict(wall_ms=wall * 1e3, device_ms=busy, span_ms=span,
                busy_share_of_span=busy / span if span else None,
                busy_share_of_wall=busy / (wall * 1e3),
                kernels=len(kernels), copies=copies,
                launches=len(kernels) - copies,
                counted=(sum(v[1] for n, v in by_name.items() if count in n)
                         if count else None), scope_count=scoped,
                top=[dict(name=n[:80], ms=v[0], count=v[1]) for n, v in top])


def device_profile_pure(fn, **kw) -> dict:
    """``device_profile`` of a ``fn`` that may run again (it leaves no
    state behind): the profiler now and then hands back a window with no
    device events, and then the window is taken again, up to 3 times."""
    for _ in range(3):
        prof = device_profile(fn, **kw)
        if prof["device_ms"] is not None:
            break
    return prof


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = dict(
        phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
    )
    emit(info)
    return info


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch import obs
    from repro_torch.kernels import _build, ops

    watch = obs.RecompileWatch()  # the builds are the port's compile events

    def build(name: str) -> float:
        t0 = time.perf_counter()
        _build.library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        nvcc_s = dict(zip(CUDA_SOURCES, pool.map(build, CUDA_SOURCES)))
    nvcc_wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.randn(100, 25, device="cuda")
    ops.gmm_update(x, x[0], torch.full((100,), torch.inf, device="cuda"),
                   torch.ones(100, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln or "C75" in ln]
             for name, log in _build.BUILD_LOG.items()}
    sass = {name: _tensor_core_sass(_build.library(name)._name)
            for name in TENSOR_CORE_SASS}
    for name, ops_ in TENSOR_CORE_SASS.items():
        check(sum(sass[name][op] for op in ops_) > 0,
              f"{name}: no {' or '.join(ops_)} in its SASS: {sass[name]}")
    events = watch.by_source()
    watch.close()
    # nvcc reports only a build it ran (a library already on disk is no
    # event); K2's first launch in a process always compiles or loads
    check(events.get("triton", 0) >= 1,
          f"K2's first launch reported no Triton compile event: {events}")
    emit(dict(phase="build", nvcc_s=nvcc_s, nvcc_wall_s=nvcc_wall_s,
              triton_first_compile_s=triton_s, tensor_core_sass=sass,
              compile_events=events, ptxas=ptxas))


def _tensor_core_sass(lib_path: str) -> dict:
    """Counts of tensor-core instructions in a built library's SASS
    (``cuobjdump -sass``): HGMMA (wgmma) and HMMA (mma.sync)."""
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "HMMA")}


def phase_data(seed: int):
    import torch
    from repro_torch.core import geometry
    from repro_torch.data import songs_sim

    t0 = time.perf_counter()
    points, cats, caps, spec = songs_sim(seed=seed, device="cuda")
    torch.cuda.synchronize()
    emit(dict(phase="data", n=points.shape[0], dim=points.shape[1],
              genres=int(caps.size), caps=caps.tolist(),
              rank=int(caps.sum()), seconds=time.perf_counter() - t0))
    x_norm = geometry.normalize_for_metric(points, "cosine")
    return points, x_norm, cats, caps, spec


def _first_max_is_tie(md_plain, i: int, j: int) -> bool:
    a, b = float(md_plain[i]), float(md_plain[j])
    return abs(a - b) <= TIE_RTOL * max(abs(a), abs(b))


def _check_precheck(x, c, cv, what: str, *, exact_ties: bool = False) -> dict:
    """K3 against its plain version (``force="ref"``) and its exact oracle
    (``force="exact"``): distances within 1e-4 (1e30 and above compared
    as float32 max), ``z`` equal wherever second - dmin > 2 margin, the
    pair {z, z2} equal wherever third - dmin > 2 margin, and every index
    below T. Where the exact distance is 0 (a stream point that is itself
    a center), the plain matmul form keeps ~sqrt(1e-7 |x|^2) of
    cancellation noise, more than 1e-4: there the kernel is held to the
    plain version within 2 margins instead. ``exact_ties``: the indices
    must equal the exact oracle's on every row (duplicated centers)."""
    import torch
    from repro_torch.kernels import ops

    got = ops.center_precheck(x, c, cv)
    plain = ops.center_precheck(x, c, cv, force="ref")
    exact = ops.center_precheck(x, c, cv, force="exact")
    torch.cuda.synchronize()
    margin = got[5]
    err_plain = err_exact = over_margin = 0.0
    for i in (0, 2, 4):
        zero = exact[i] == 0
        check(bool(torch.all((got[i] - plain[i]).abs()[zero]
                             <= 2 * margin[zero])),
              f"precheck {what}: output {i} at distance 0 off by > 2 margin")
        for want, name in ((plain[i], "plain"), (exact[i], "exact")):
            check(bool(torch.equal(got[i] < 1e30, want < 1e30)),
                  f"precheck {what}: output {i} masks differently from "
                  f"the {name} version")
            fin = (want < 1e30) & ~zero if name == "plain" else want < 1e30
            err = float((got[i] - want)[fin].abs().max()) if fin.any() else 0.0
            check(bool(torch.allclose(got[i][fin], want[fin], rtol=1e-4,
                                      atol=1e-4)),
                  f"precheck {what}: output {i} max abs err {err} vs {name}")
            if name == "plain":
                err_plain = max(err_plain, err)
            else:
                err_exact = max(err_exact, err)
                if fin.any():
                    over_margin = max(over_margin, float(
                        ((got[i] - want).abs() / margin)[fin].max()))
    T = c.shape[0]
    for z in (got[1], got[3]):
        check(bool(torch.all((z >= 0) & (z < T))),
              f"precheck {what}: index outside [0, T)")
    dmin_r, z_r, sec_r, z2_r, third_r, _ = exact
    safe_z = (sec_r - dmin_r) > 2 * margin
    check(bool(torch.equal(got[1][safe_z], z_r[safe_z])),
          f"precheck {what}: z differs where the gap clears the margin")
    safe_pair = (third_r - dmin_r) > 2 * margin
    pair = torch.sort(torch.stack([got[1], got[3]]), dim=0).values
    pair_r = torch.sort(torch.stack([z_r, z2_r]), dim=0).values
    check(bool(torch.equal(pair[:, safe_pair], pair_r[:, safe_pair])),
          f"precheck {what}: {{z, z2}} differs where the gap clears the "
          f"margin")
    if exact_ties:
        check(bool(torch.equal(got[1], z_r) and torch.equal(got[3], z2_r)),
              f"precheck {what}: first-index ties differ from the oracle")
    return dict(kernel="center_precheck", shape=[x.shape[0], T, x.shape[1]],
                what=what, max_abs_err=err_plain,
                max_abs_err_vs_exact=err_exact,
                max_err_over_margin=over_margin,
                z_checked=int(safe_z.sum()), pair_checked=int(safe_pair.sum()),
                tol=1e-4, ok=True)


def _check_block_precheck(xb, st, what: str) -> dict:
    """K3's fused route against ``ref.block_precheck`` on the plain path,
    for a block against a scan state, with that state's thresholds (the
    radius variant's thr = 2 R, and the diameter flags at x1 and 2 R):
    z equal on every row where both flags are off; a flag that differs
    only where the plain path's comparison lies within 2 margins (the
    third center) or 2 SLACK (the refined comparisons) of its boundary;
    two calls bit-identical."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    R = float(st.R)
    thr = r2 = float(np.float32(2.0) * np.float32(R))
    out = dict(what=what, shape=[xb.shape[0], st.centers.shape[0],
                                 xb.shape[1]],
               centers=int(st.cvalid.sum()))
    for variant, x1, r2_ in (("radius", None, None),
                             ("diameter", st.x1, r2)):
        got = ops.block_precheck(xb, st.centers, st.cvalid, x1, thr, r2_)
        again = ops.block_precheck(xb, st.centers, st.cvalid, x1, thr, r2_)
        plain = ops.block_precheck(xb, st.centers, st.cvalid, x1, thr, r2_,
                                   force="ref")
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              f"fused precheck {what} ({variant}): two calls differ")
        z, f = got[0], got[1] != 0
        z_r, f_r = plain[0], plain[1] != 0
        dmin_e, z1, _, z2, third_e, margin = ops.center_precheck(
            xb, st.centers, st.cvalid, force="ref")
        cv, c = st.cvalid, st.centers
        d1e = torch.where(cv[z1.long()], ref.point_dist(c[z1.long()], xb),
                          ref._F32_MAX)
        d2e = torch.where(cv[z2.long()], ref.point_dist(c[z2.long()], xb),
                          ref._F32_MAX)
        dmin = torch.minimum(d1e, d2e)
        both_off = ~f & ~f_r
        check(torch.equal(z[both_off], z_r[both_off]),
              f"fused precheck {what} ({variant}): z differs on a quiet row")
        slack = 2 * ref.SLACK
        near = (((third_e - dmin_e) - 2 * margin).abs() <= 2 * margin) | (
            (d1e - d2e).abs() <= slack * dmin) | (
            (dmin - thr).abs() <= slack * thr)
        if x1 is not None:
            d1 = ref.point_dist(xb, x1[None, :])
            near |= (d1 - r2).abs() <= slack * r2
        differ = f != f_r
        check(bool(torch.all(near[differ])),
              f"fused precheck {what} ({variant}): a flag differs away "
              f"from every boundary")
        out[variant] = dict(flags=int(f.sum()), plain_flags=int(f_r.sum()),
                            differing=int(differ.sum()),
                            z_checked=int(both_off.sum()))
    return out


def _precheck_cases(g):
    """K3's test shapes, all-invalid centers, and duplicated centers."""
    import torch

    for B, T, d in PRECHECK_SHAPES:
        x = torch.randn(B, d, generator=g, device="cuda") * 3
        c = torch.randn(T, d, generator=g, device="cuda") * 3
        cv = torch.rand(T, generator=g, device="cuda") > 0.2
        yield x, c, cv, "random", False
    x = torch.ones(8, 4, device="cuda")
    yield x, torch.zeros(5, 4, device="cuda"), torch.zeros(
        5, dtype=torch.bool, device="cuda"), "all invalid", False
    base = torch.randn(3, 64, generator=g, device="cuda")
    c = base[torch.tensor([2, 0, 1, 0, 2, 1, 0] * 10, device="cuda")]
    cv = torch.ones(70, dtype=torch.bool, device="cuda")
    cv[1] = False
    # points near (not on) a base vector: the plain matmul form leaves
    # ~1e-3 of cancellation noise on a zero distance
    x = base[torch.tensor([0, 1, 2] * 40, device="cuda")] + 0.5 * torch.randn(
        120, 64, generator=g, device="cuda")
    yield x, c.contiguous(), cv, "duplicated centers", True


def phase_kernels(x_norm, m_slice: int, seed: int) -> float:
    """Each kernel against its plain version; returns K2's max abs error at
    the main path's shape."""
    import torch
    from repro_torch.kernels import ops, pdist

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    lines, k2_err = [], None
    for x, c, cv, what, ties in _precheck_cases(g):
        lines.append(_check_precheck(x, c, cv, what, exact_ties=ties))
    rows = x_norm[:m_slice].contiguous()
    cases = [(n, m, d, None) for n, m, d in PDIST_SHAPES]
    cases.append((m_slice, m_slice, x_norm.shape[1], rows))
    for n, m, d, data in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            if data is None:
                x = torch.randn(n, d, generator=g, device="cuda").to(dtype)
                y = torch.randn(m, d, generator=g, device="cuda").to(dtype)
            else:
                x = y = data.to(dtype)
            got = ops.pairwise_sqdist(x, y)
            route = pdist.last_route
            want = ops.pairwise_sqdist(x, y, force="ref")
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
            ok = ok and route == ("full" if data is None else "sym")
            lines.append(dict(kernel="pdist", shape=[n, m, d],
                              dtype=str(dtype), route=route,
                              max_abs_err=err, tol=tol, ok=ok))
            check(ok, f"pdist {n}x{m}x{d} {dtype} ({route}): max abs err "
                      f"{err}")
    # x against itself (the sym route): D == D^T bit for bit, a zero
    # diagonal, two calls bit-identical, within the tolerance of the plain
    # version
    for m in PDIST_SELF_ROWS:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            x = x_norm[:m].to(dtype)
            got = ops.pairwise_sqdist(x, x)
            route, splits = pdist.last_route, pdist.last_splits
            again = ops.pairwise_sqdist(x, x)
            want = ops.pairwise_sqdist(x, x, force="ref")
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            sym = bool(torch.equal(got, got.T))
            diag0 = int(torch.count_nonzero(torch.diagonal(got))) == 0
            same = bool(torch.equal(got, again))
            ok = (route == "sym" and sym and diag0 and same
                  and bool(torch.allclose(got, want, rtol=tol, atol=tol)))
            lines.append(dict(kernel="pdist", what="x against itself",
                              shape=[m, m, x.shape[1]], dtype=str(dtype),
                              route=route, splits=splits, max_abs_err=err,
                              tol=tol, symmetric_bitwise=sym,
                              zero_diagonal=diag0, repeat_bitwise=same,
                              ok=ok))
            check(ok, f"pdist self {m}x{x.shape[1]} {dtype}: route {route}, "
                      f"D == D^T {sym}, zero diagonal {diag0}, repeat "
                      f"{same}, max abs err {err}")

    n_full = x_norm.shape[0]
    for n, d in GMM_SHAPES + [(n_full, x_norm.shape[1])]:
        if n == n_full:
            x = x_norm
            valid = torch.ones(n, dtype=torch.bool, device="cuda")
            md0 = torch.full((n,), torch.inf, device="cuda")
            md, far, _ = ops.gmm_update(x, x[0], md0, valid, force="ref")
            z = x[int(far)]
        else:
            x = torch.randn(n, d, generator=g, device="cuda")
            z = torch.randn(d, generator=g, device="cuda")
            md = torch.rand(n, generator=g, device="cuda") * 2.5 + 0.5
            valid = torch.rand(n, generator=g, device="cuda") > 0.1
        nm, fi, fv = ops.gmm_update(x, z, md, valid)
        nm_r, fi_r, fv_r = ops.gmm_update(x, z, md, valid, force="ref")
        torch.cuda.synchronize()
        err = float((nm - nm_r).abs().max())
        check(bool(torch.allclose(nm, nm_r, rtol=1e-5, atol=1e-5)),
              f"gmm_step {n}x{d}: new_min max abs err {err}")
        i, j = int(fi), int(fi_r)
        tie = i != j and _first_max_is_tie(nm_r, i, j)
        check(i == j or tie, f"gmm_step {n}x{d}: far_idx {i} != {j}")
        lines.append(dict(kernel="gmm_step", shape=[n, d], max_abs_err=err,
                          tol=1e-5, far_idx=i, far_idx_plain=j, tie=tie,
                          far_val=float(fv), far_val_plain=float(fv_r),
                          ok=True))
        if n == n_full:
            k2_err = err
    emit(dict(phase="kernels", checks=lines))
    return k2_err


def _solve(points, cats, caps, spec, k, tau, force=None):
    from repro_torch.core import solve_dmmc

    return solve_dmmc(points, k, spec, cats=cats, caps=caps, tau=tau,
                      metric="cosine", variant="sum", engine="host",
                      force=force, device="cuda")


def _first_divergence_is_tie(x_norm, centers, centers_ref,
                             valid=None) -> tuple[int, bool]:
    """At the first position where the two center sequences differ, whether
    the plain min-distances of the two picks are equal within TIE_RTOL."""
    import torch
    from repro_torch.kernels import ops

    t = int(next(i for i, (a, b) in enumerate(zip(centers, centers_ref))
                 if a != b))
    n, dev = x_norm.shape[0], x_norm.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    md = torch.full((n,), torch.inf, device=dev)
    for c in centers_ref[:t]:
        md, _, _ = ops.gmm_update(x_norm, x_norm[int(c)], md, valid,
                                  force="ref", device=dev)
    return t, _first_max_is_tie(md, int(centers[t]), int(centers_ref[t]))


def _value_without_diagonal(x_norm, coreset_indices, indices, force) -> float:
    """The sum diversity of ``indices`` over the coreset matrix (K1 or
    plain) with the diagonal taken out. The plain matmul form leaves
    cancellation noise of up to ~1e-3 on the diagonal, and the host
    solver's sum value includes it (in the reference too); the kernel's
    diagonal is exact."""
    import numpy as np
    import torch
    from repro_torch.core import coreset_distance_matrix, selection_value

    rows = x_norm.index_select(
        0, torch.as_tensor(coreset_indices, device="cuda"))
    D = coreset_distance_matrix(rows, force=force)
    np.fill_diagonal(D, 0.0)
    local = np.searchsorted(coreset_indices, indices)
    return selection_value(D, local, "sum")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _check_pdist_at(rows, what: str) -> float:
    """K1 against its plain version on ``rows`` against themselves, as
    ``coreset_distance_matrix`` calls it; returns the max abs error."""
    import torch
    from repro_torch.kernels import ops

    got = ops.pairwise_sqdist(rows, rows)
    want = ops.pairwise_sqdist(rows, rows, force="ref")
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4)),
          f"pdist at {what} {list(rows.shape)}: max abs err {err}")
    return err


def phase_solve(points, x_norm, cats, caps, spec, k: int, tau: int):
    import numpy as np
    import torch
    from repro_torch.core import PartitionMatroid
    from repro_torch.core.solve import _final_solve
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launches()
    sol = _solve(points, cats, caps, spec, k, tau)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    process_peak = torch.cuda.max_memory_allocated()
    # the solve's own footprint: its input points plus what it allocated
    # above the level before it (the script's x_norm is not the solve's)
    solve_peak = points.numel() * points.element_size() + process_peak - before

    check(launches["gmm_update"] == tau,
          f"K2 launched {launches['gmm_update']} times, expected tau={tau}")
    check(launches["pairwise_sqdist"] >= 1, "K1 was not launched")
    check(len(sol.indices) == k, f"{len(sol.indices)} points selected, k={k}")
    check(PartitionMatroid(cats[:, 0], caps).is_independent(
        list(sol.indices)), "solution violates the partition matroid")
    check(np.isfinite(sol.diversity) and sol.diversity > 0,
          f"diversity {sol.diversity}")
    check(0 < sol.coreset_size <= k * tau,
          f"coreset size {sol.coreset_size} outside (0, k*tau]")

    # K1 at the input the main path gave it (the solve's coreset rows,
    # a partial tile at m = 327), and the final stage on the solve's own
    # coreset with the plain pdist: the same selection, whatever GMM did
    sel = np.sort(sol.indices)
    rows = x_norm.index_select(
        0, torch.as_tensor(sol.coreset_indices, device="cuda"))
    k1_err = _check_pdist_at(rows, "the solve's coreset")
    fs_idx, _ = _final_solve(x_norm, cats, spec, caps, k,
                             sol.coreset_indices, "sum", force="ref")
    check(np.array_equal(np.sort(fs_idx), sel),
          "final stage on the plain pdist selects other indices")

    ref = _solve(points, cats, caps, spec, k, tau, force="ref")
    same_centers = np.array_equal(sol.info["centers"], ref.info["centers"])
    tie_at = rel = rel_with_diag = None
    if not same_centers:
        tie_at, tie = _first_divergence_is_tie(
            x_norm, sol.info["centers"], ref.info["centers"])
        check(tie, f"GMM centers diverge at {tie_at} without a tie")
    else:
        check(np.array_equal(sol.coreset_indices, ref.coreset_indices),
              "coreset differs from the plain path")
        check(np.array_equal(sel, np.sort(ref.indices)),
              "selected indices differ from the plain path")
        mine = _value_without_diagonal(x_norm, sol.coreset_indices,
                                       sol.indices, None)
        plain = _value_without_diagonal(x_norm, ref.coreset_indices,
                                        ref.indices, "ref")
        rel = _rel(mine, plain)
        rel_with_diag = _rel(sol.diversity, ref.diversity)
        check(rel <= 1e-5, f"diversity differs by {rel} relative")
    out = dict(
        phase="solve", n=points.shape[0], dim=points.shape[1], k=k, tau=tau,
        coreset_s=sol.timings["coreset_s"], solver_s=sol.timings["solver_s"],
        total_s=sol.timings["total_s"], gmm_s=sol.info["gmm_s"],
        extract_s=sol.info["extract_s"], coreset_size=sol.coreset_size,
        diversity=sol.diversity, solve_peak_device_bytes=solve_peak,
        process_peak_device_bytes=process_peak, launches=launches,
        pdist_max_abs_err_at_coreset=k1_err,
        plain=dict(coreset_s=ref.timings["coreset_s"],
                   gmm_s=ref.info["gmm_s"], extract_s=ref.info["extract_s"],
                   solver_s=ref.timings["solver_s"],
                   total_s=ref.timings["total_s"], diversity=ref.diversity,
                   coreset_size=ref.coreset_size),
        same_centers=same_centers, center_tie_at=tie_at,
        same_coreset=bool(np.array_equal(sol.coreset_indices,
                                         ref.coreset_indices)),
        same_indices=bool(np.array_equal(sol.indices, ref.indices)),
        diversity_rel_diff_without_diagonal=rel,
        diversity_rel_diff_with_diagonal=rel_with_diag,
    )
    emit(out)
    return sol, launches


def _mr_solve(points, cats, caps, spec, k, tau, mesh, round2, force=None):
    from repro_torch.core import solve_dmmc

    return solve_dmmc(points, k, spec, cats=cats, caps=caps, tau=tau,
                      metric="cosine", variant="sum", engine="host",
                      setting="mapreduce", mesh=mesh, round2_tau=round2,
                      force=force, device="cuda")


def _mr_divergence(x_norm, blocks, spec, caps, k, tau_local, mesh, round2):
    """Where the kernel and plain MapReduce coresets part: the first shard
    whose GMM centers differ (or, with round 2, the union's GMM), and
    whether they part at a tie. Runs only when the two paths differ."""
    import torch
    from repro_torch.core import gmm_fixed, mapreduce_coreset

    for s in range(mesh.axis_size(("data",))):
        xs, vs = blocks[0][s], blocks[2][s]
        got = gmm_fixed(xs, vs, tau_local, device=xs.device).centers.tolist()
        want = gmm_fixed(xs, vs, tau_local, force="ref",
                         device=xs.device).centers.tolist()
        if got != want:
            t, tie = _first_divergence_is_tie(xs, got, want, vs)
            return dict(where=f"shard {s}", at=t, tie=tie)
    if round2 is not None:
        cs, _ = mapreduce_coreset(mesh, *blocks, spec, caps, k, tau_local)
        dev = cs.points.device
        got = gmm_fixed(cs.points, cs.valid, round2,
                        device=dev).centers.tolist()
        want = gmm_fixed(cs.points, cs.valid, round2, force="ref",
                         device=dev).centers.tolist()
        if got != want:
            t, tie = _first_divergence_is_tie(cs.points, got, want, cs.valid)
            return dict(where="round 2", at=t, tie=tie)
    return dict(where=None, at=None, tie=False)


def phase_mapreduce(points, x_norm, sol, cats, caps, spec, k: int, tau: int,
                    serve: dict) -> dict:
    """The MapReduce setting, the global GMM and the ``shard_map``
    placement on songs-sim (module docstring, phase 11)."""
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import (
        PartitionMatroid,
        distributed_coreset,
        epoch_stats,
        gmm_fixed,
        mapreduce_coreset,
        seq_coreset,
    )
    from repro_torch.core.distributed_gmm import _global_gmm_shard
    from repro_torch.core.solve import _padded_shards
    from repro_torch.kernels import ops
    from repro_torch.launch import make_mesh
    from repro_torch.serve.diversity import DurabilityConfig, StreamRuntime

    t_phase = time.perf_counter()
    n = points.shape[0]
    L = MR_SHARDS
    tau_local = max(1, tau // L)
    mesh = make_mesh((L,), ("data",), devices=["cuda"] * L)
    cats2 = np.asarray(cats, np.int32).reshape(n, 1)

    # (a) the kernel path, launch counts read around the two solves; the
    # shards' K2 launches may compile Triton specialisations the earlier
    # phases did not need (counted here), so each solve is timed again
    # warm after (b)
    watch = obs.RecompileWatch()
    torch.cuda.synchronize()
    ops.reset_launches()
    mr = {r2: _mr_solve(points, cats2, caps, spec, k, tau, mesh, r2)
          for r2 in (None, MR_ROUND2_TAU)}
    torch.cuda.synchronize()
    launches_solve = ops.launch_counts()
    compiles = dict(events=watch.by_source(),
                    seconds=sum(watch.seconds_by_key().values()))
    k2_want = 2 * L * tau_local + MR_ROUND2_TAU
    check(launches_solve["gmm_update"] == k2_want,
          f"mapreduce K2 launched {launches_solve['gmm_update']} times, "
          f"expected {k2_want}")
    check(launches_solve["pairwise_sqdist"] >= 2,
          "mapreduce: K1 was not launched by each final stage")

    # (b) the plain path: the same union, coreset and selection, or a tie
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    blocks = _padded_shards(
        (x_norm, torch.as_tensor(cats2, device="cuda"), valid), L)
    plain, parity = {}, {}
    for r2, got in mr.items():
        ref = _mr_solve(points, cats2, caps, spec, k, tau, mesh, r2,
                        force="ref")
        plain[r2] = ref
        same = bool(np.array_equal(got.coreset_indices, ref.coreset_indices))
        out = dict(same_coreset=same, same_indices=bool(
            np.array_equal(np.sort(got.indices), np.sort(ref.indices))))
        if same:
            check(out["same_indices"],
                  f"mapreduce round2={r2}: selection differs from the "
                  f"plain path")
            mine = _value_without_diagonal(x_norm, got.coreset_indices,
                                           got.indices, None)
            theirs = _value_without_diagonal(x_norm, ref.coreset_indices,
                                             ref.indices, "ref")
            out["diversity_rel_diff_without_diagonal"] = _rel(mine, theirs)
            check(out["diversity_rel_diff_without_diagonal"] <= 1e-5,
                  f"mapreduce round2={r2}: values differ by "
                  f"{out['diversity_rel_diff_without_diagonal']}")
        else:
            out["divergence"] = _mr_divergence(x_norm, blocks, spec, caps, k,
                                               tau_local, mesh, r2)
            check(out["divergence"]["tie"],
                  f"mapreduce round2={r2}: the coreset differs from the "
                  f"plain path without a GMM tie: {out['divergence']}")
        parity["round1" if r2 is None else "round2"] = out
    warm = {r2: _mr_solve(points, cats2, caps, spec, k, tau, mesh, r2)
            for r2 in mr}

    # (c) independence, round 2 smaller, no overflow, rows that map back
    matroid = PartitionMatroid(cats2[:, 0], caps)
    for r2, got in mr.items():
        check(len(got.indices) == k and matroid.is_independent(
            list(got.indices)), f"mapreduce round2={r2}: not a basis")
        check(got.info["overflow"] == 0,
              f"mapreduce round2={r2}: overflow {got.info['overflow']}")
        check(got.info["shards"] == L, f"shards {got.info['shards']}")
    check(mr[MR_ROUND2_TAU].coreset_size < mr[None].coreset_size,
          f"round 2 ({mr[MR_ROUND2_TAU].coreset_size}) is not smaller than "
          f"round 1 ({mr[None].coreset_size})")
    union, ovf = mapreduce_coreset(mesh, *blocks, spec, caps, k, tau_local)
    uv = union.valid
    check(int(ovf) == 0, f"union overflow {int(ovf)}")
    check(bool(torch.equal(union.points[uv],
                           x_norm[union.src_idx[uv].long()])),
          "the union's rows are not the points its src_idx names")
    check(np.array_equal(np.unique(union.src_idx[uv].cpu().numpy()),
                         mr[None].coreset_indices),
          "the union's src_idx set is not the solve's coreset")
    # one reducer's work: SeqCoreset on shard 0, synced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq_coreset(blocks[0][0], blocks[1][0], blocks[2][0], spec, caps, k,
                tau_local, base_index=0, device="cuda")
    torch.cuda.synchronize()
    reducer_s = time.perf_counter() - t0

    # (d) quality against the sequential solve (reported, not gated)
    quality = dict(
        sequential=sol.diversity, mapreduce=mr[None].diversity,
        mapreduce_round2=mr[MR_ROUND2_TAU].diversity,
        ratio=mr[None].diversity / sol.diversity,
        ratio_round2=mr[MR_ROUND2_TAU].diversity / sol.diversity)
    quality["meets_bounds"] = bool(
        quality["ratio"] >= MR_SEQ_FLOOR
        and quality["ratio_round2"] >= MR_ROUND2_FLOOR)

    # (e) the global GMM: one traversal over the 8 shards on K2
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    g_cs, g_radius, g_delta = distributed_coreset(mesh, *blocks, spec, caps,
                                                  k, tau)
    torch.cuda.synchronize()
    global_s = time.perf_counter() - t0
    launches_global = ops.launch_counts()
    check(launches_global["gmm_update"] == L * tau,
          f"global GMM launched K2 {launches_global['gmm_update']} times, "
          f"expected {L * tau}")
    check(int(g_cs.valid.sum()) > 0, "the global GMM coreset is empty")
    # the traversal alone, under the sync debugger: no read to the host
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            g_centers = _global_gmm_shard(mesh, blocks[0], blocks[2], tau,
                                          ("data",))[3]
            launch_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    traversal_s = time.perf_counter() - t0
    syncs = [str(w.message) for w in caught if "ynchroniz" in str(w.message)]
    check(not syncs, f"the global GMM traversal synced with the host "
                     f"{len(syncs)} times: {syncs[:2]}")
    traversal_profile = device_profile_pure(
        lambda: _global_gmm_shard(mesh, blocks[0], blocks[2], tau,
                                  ("data",)), count="gmm_step")
    t0 = time.perf_counter()
    single = gmm_fixed(x_norm, valid, tau, device=x_norm.device)
    torch.cuda.synchronize()
    gmm_fixed_s = time.perf_counter() - t0
    g_list = g_centers.tolist()
    s_list = single.centers.tolist()
    g_tie_at = None
    if g_list != s_list:
        g_tie_at, tie = _first_divergence_is_tie(x_norm, g_list, s_list)
        check(tie, f"global GMM centers diverge at {g_tie_at} without a tie")
    else:
        check(_rel(float(g_radius), float(single.radius)) <= 1e-5,
              f"global GMM radius {float(g_radius)} vs "
              f"{float(single.radius)}")
        check(_rel(float(g_delta), float(single.delta)) <= 1e-5,
              f"global GMM delta {float(g_delta)} vs {float(single.delta)}")

    # (f) the shard_map placement over the serve phase's batches: the
    # vmap runtime's state bit for bit, then a checkpoint and restore
    P, C = serve["P"], serve["C"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_map-")
    try:
        rts = {}
        for pl in ("vmap", "shard_map"):
            dur = (DurabilityConfig(dir=tmp, checkpoint_every=10 ** 9)
                   if pl == "shard_map" else None)
            rt = StreamRuntime(spec, k, tau=tau, caps=caps, metric="cosine",
                               num_shards=MR_PLACEMENT_SHARDS, placement=pl,
                               block_size=BLOCK, durability=dur,
                               device="cuda")
            torch.cuda.synchronize()
            if pl == "shard_map":
                ops.reset_launches()
            t0 = time.perf_counter()
            for a, b in serve["spans"]:
                rt.ingest_sharded(P[a:b], C[a:b])
            torch.cuda.synchronize()
            rts[pl] = (rt, time.perf_counter() - t0)
            if pl == "shard_map":
                launches_placement = ops.launch_counts()
        (rv, vmap_s), (rs, shard_map_s) = rts["vmap"], rts["shard_map"]
        check(rs.placement == "shard_map", f"placement {rs.placement}")
        check(launches_placement["center_precheck"] >= 1,
              "the shard_map drive launched no K3")
        _assert_states_equal(rs.state, rv.state, "shard_map vs vmap")
        triple = [int(v) for v in epoch_stats(rs.state)]
        check(triple == [int(v) for v in epoch_stats(rv.state)],
              "shard_map epoch triple differs from vmap")
        check(rs.fingerprint == rv.fingerprint,
              "shard_map fingerprint differs from vmap")
        t0 = time.perf_counter()
        check(rs.checkpoint(force=True) is not None, "no checkpoint saved")
        rs.close()
        back = StreamRuntime.restore(tmp, device="cuda")
        restore_s = time.perf_counter() - t0
        check(back.placement == "shard_map",
              f"restored placement {back.placement}")
        _assert_states_equal(back.state, rs.state, "restored shard_map")
        check(back.fingerprint == rs.fingerprint
              and back.n_offered == rs.n_offered,
              "the restored runtime differs from the one that saved")
        back.close()
        rv.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches = {name: launches_solve[name] + launches_global[name]
                + launches_placement[name] for name in launches_solve}
    timings = {("round1" if r2 is None else "round2"): dict(
        coreset_s=m.timings["coreset_s"], solver_s=m.timings["solver_s"],
        total_s=m.timings["total_s"], coreset_size=m.coreset_size,
        warm_coreset_s=warm[r2].timings["coreset_s"],
        warm_solver_s=warm[r2].timings["solver_s"],
        warm_total_s=warm[r2].timings["total_s"],
        plain_coreset_s=plain[r2].timings["coreset_s"],
        plain_total_s=plain[r2].timings["total_s"])
        for r2, m in mr.items()}
    emit(dict(
        phase="mapreduce", n=n, dim=points.shape[1], k=k, tau=tau,
        shards=L, tau_local=tau_local, round2_tau=MR_ROUND2_TAU,
        sequential=dict(coreset_s=sol.timings["coreset_s"],
                        solver_s=sol.timings["solver_s"],
                        total_s=sol.timings["total_s"],
                        coreset_size=sol.coreset_size),
        mapreduce=timings, compiles_in_first_solves=compiles,
        reducer_coreset_s=reducer_s,
        union_size=int(uv.sum()), union_capacity=int(uv.numel()),
        parity=parity, quality=quality,
        global_gmm=dict(seconds=global_s, traversal_s=traversal_s,
                        traversal_launch_s=launch_s,
                        gmm_fixed_s=gmm_fixed_s,
                        same_centers=g_list == s_list, tie_at=g_tie_at,
                        radius=float(g_radius), delta=float(g_delta),
                        gmm_fixed_radius=float(single.radius),
                        gmm_fixed_delta=float(single.delta),
                        coreset_size=int(g_cs.valid.sum()),
                        k2_launches=launches_global["gmm_update"],
                        host_syncs_in_traversal=len(syncs),
                        traversal_profile=traversal_profile),
        shard_map=dict(shards=MR_PLACEMENT_SHARDS, equals_vmap=True,
                       epoch_triple=triple, vmap_ingest_s=vmap_s,
                       shard_map_ingest_s=shard_map_s, restore_s=restore_s,
                       restored_equal=True),
        launches_solve=launches_solve, launches_global=launches_global,
        launches_placement=launches_placement, launches=launches,
        seconds=time.perf_counter() - t_phase))
    return dict(launches=launches, quality=quality)


def _engine_ctx(D, spec, cats, caps, device):
    """A SolveContext over one coreset matrix, with the host oracle the
    host engine needs (per-query caps applied)."""
    import numpy as np
    from repro_torch.core import PartitionMatroid, TransversalMatroid
    from repro_torch.core.solvers import SolveContext

    if spec.kind == "transversal":
        matroid = TransversalMatroid(cats, spec.num_categories)
        return SolveContext(D=D, spec=spec, cats=cats, device=device,
                            matroid_fn=lambda s: matroid)
    return SolveContext(
        D=D, spec=spec, cats=cats, caps=caps, device=device,
        matroid_fn=lambda s: PartitionMatroid(
            cats, caps if s.caps is None else np.asarray(s.caps)))


def _sum_specs(rng, m: int, n: int, k_max: int, caps):
    """n sum queries: k in [4, k_max], caps at most ``caps`` (None: the
    context's), an allow mask dropping ~25% of the rows, gamma 0 or 0.01."""
    import numpy as np
    from repro_torch.core.solvers import SolveSpec

    out = []
    for _ in range(n):
        qcaps = None if caps is None else tuple(
            int(c) for c in rng.integers(1, np.asarray(caps) + 1))
        out.append(SolveSpec(
            k=int(rng.integers(ENGINE_K_MIN, k_max + 1)), variant="sum",
            gamma=float(rng.choice([0.0, 0.01])), caps=qcaps,
            allow=rng.random(m) >= 0.25))
    return out


def _jit_sum_rows(ctx, specs, max_sweeps: int) -> list:
    """Queries through the batched sum solver, stopped after
    ``max_sweeps`` sweeps (0: the greedy seed); their selections."""
    import torch
    from repro_torch.core.solvers import jit_sum
    from repro_torch.core.solvers.matching import cats_onehot

    dev = jit_sum.engine_device(ctx)
    B = len(specs)
    kmax = jit_sum.bucket_pow2(max(s.k for s in specs))
    allow, ks, gammas = jit_sum.pad_query_arrays(ctx, specs, B)
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    if ctx.spec.kind == "transversal":
        oh = cats_onehot(ctx.cats, ctx.spec.num_categories)
        sel, nsel, _ = jit_sum.solve_sum_batch_transversal(
            put(ctx.D), put(oh), put(allow), put(ks), put(gammas),
            kmax=kmax, max_sweeps=max_sweeps)
    else:
        cats1, caps = jit_sum.partition_arrays(ctx, specs, B)
        sel, nsel, _ = jit_sum.solve_sum_batch(
            put(ctx.D), put(cats1), put(caps), put(allow), put(ks),
            put(gammas), kmax=kmax, max_sweeps=max_sweeps)
    sel, nsel = sel.cpu().tolist(), nsel.cpu().tolist()
    return [row[:n] for row, n in zip(sel, nsel)]


def _sweep_min_margin(D, matroid, idxs, gamma: float, X) -> float:
    """Replay one host local-search sweep from X (``local_search_sum``'s
    loop, in float64) and return the smallest relative margin of any swap
    test it makes: |new_div - threshold| / div."""
    import numpy as np

    D = np.asarray(D, np.float64)
    X = list(X)
    inside = set(X)
    div = D[np.ix_(X, X)].sum() / 2.0
    row = {u: D[u, X].sum() for u in X}
    best = np.inf
    for v in idxs:
        if v in inside:
            continue
        dv = D[v, X].sum()
        for u in list(X):
            new_div = div - row[u] + dv - D[u, v]
            thr = max(div * (1.0 + gamma), div)
            best = min(best, abs(new_div - thr) / max(abs(div), 1e-30))
            if new_div <= thr:
                continue
            Xm = [w for w in X if w != u] + [v]
            if not matroid.is_independent(Xm):
                continue
            X, div = Xm, new_div
            inside.discard(u)
            inside.add(v)
            row = {w: D[w, X].sum() for w in X}
            break
    return float(best)


def _sum_divergence(ctx, spec, got, want) -> dict:
    """Where the batched engine's selection first leaves the host's: the
    first sweep count s (0: the greedy seed) after which the two differ,
    and whether that stage's decision was a float tie (two greedy gains,
    or a swap test and its threshold, within TIE_RTOL)."""
    import numpy as np
    from repro_torch.core.solvers import local_search_sum

    matroid = ctx.matroid_fn(spec)
    idxs = spec.candidate_idxs(ctx.size)
    D = np.asarray(ctx.D, np.float64)
    prev = None
    for s in range(65):
        host, _v, _n = local_search_sum(ctx.D, matroid, spec.k, idxs,
                                        gamma=spec.gamma, max_sweeps=s)
        jit = _jit_sum_rows(ctx, [spec], s)[0]
        if host != jit:
            break
        prev = host
    else:  # pragma: no cover - equal at every stage, so equal at the end
        return dict(stage=None, tie=False, got=got, want=want)
    if s == 0:
        i = next((i for i, (a, b) in enumerate(zip(host, jit)) if a != b),
                 min(len(host), len(jit)))
        if i == min(len(host), len(jit)):  # one stopped early: not a tie
            return dict(stage=0, margin=None, tie=False, got=got, want=want)
        pre = host[:i]
        gain = [D[v, pre].sum() if pre else D[v].sum()
                for v in (host[i], jit[i])]
        margin = abs(gain[0] - gain[1]) / max(abs(gain[0]), abs(gain[1]))
    else:
        margin = _sweep_min_margin(D, matroid, idxs, spec.gamma, prev)
    return dict(stage=s, margin=margin, tie=bool(margin <= TIE_RTOL),
                got=got, want=want)


def _greedy_divergence(D, got, want, variant: str) -> dict:
    """At the first slot where two greedy selections differ, whether the
    two picks' objectives (float64, over the common prefix) tie."""
    import numpy as np
    from repro_torch.core import diversity

    i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    pre = list(want[:i])
    if i >= min(len(got), len(want)):
        return dict(slot=i, tie=False)
    D = np.asarray(D, np.float64)
    if not pre:
        vals = [D[got[i]].sum(), D[want[i]].sum()]
    else:
        vals = [diversity(D[np.ix_(pre + [v], pre + [v])], variant)
                for v in (got[i], want[i])]
    margin = abs(vals[0] - vals[1]) / max(abs(vals[0]), abs(vals[1]))
    return dict(slot=i, margin=margin, tie=bool(margin <= TIE_RTOL))


def _median_s(fn, reps: int = 3, after_first=None) -> tuple:
    """(median seconds, the results) of ``reps`` runs of ``fn``, each
    synced (the engines return host arrays, so a run ends in a device
    sync); ``after_first`` is called between the first run and the
    second."""
    times, outs = [], []
    for i in range(reps):
        if i == 1 and after_first is not None:
            after_first()
        t0 = time.perf_counter()
        outs.append(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), outs


def _compare_sum(ctx, specs, got, want, what: str) -> dict:
    """Each batched selection equal to the host engine's (in order), or
    diverging first at a printed tie."""
    diverged = []
    for i, (a, b) in enumerate(zip(got, want)):
        ga, gb = a.local_indices.tolist(), b.local_indices.tolist()
        if ga == gb:
            check(a.value == b.value, f"{what} query {i}: equal selections, "
                  f"values {a.value} != {b.value}")
            continue
        div = _sum_divergence(ctx, specs[i], ga, gb)
        diverged.append(dict(query=i, **div))
        check(div["tie"], f"{what} query {i}: the engines diverge without a "
              f"tie: {div}")
    return dict(queries=len(specs), equal=len(specs) - len(diverged),
                diverged_at_tie=diverged)


def phase_engines(points, x_norm, sol, cats, caps, spec, k: int,
                  seed: int) -> dict:
    """The batched final-stage engines on the solve's own coreset (see the
    module docstring, phase 8)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import MatroidSpec, coreset_distance_matrix
    from repro_torch.core.solve import _final_solve
    from repro_torch.core.solvers import (
        JIT_SUM, SolveSpec, get_engine, partition_by_engine, select_engine,
        solve_stacked,
    )
    from repro_torch.kernels import ops

    dev = x_norm.device
    rng = np.random.default_rng(seed + 18)
    sub = np.asarray(sol.coreset_indices, np.int64)
    m = sub.size
    cats_sub = np.asarray(cats, np.int32)[sub]
    watch = obs.RecompileWatch()
    buf = obs.default_buffer()
    buf.clear()
    host = get_engine("host_local_search")
    out = dict(phase="engines", m=m, k=k)
    ops.reset_launches()

    # 1. the final stage: jit_sum and auto on the card select as host does
    with obs.span("engines.final_stage", cat="chip_smoke"):
        rows = x_norm.index_select(0, torch.as_tensor(sub, device=dev))
        D = coreset_distance_matrix(rows, device=dev)  # K1
        ctx = _engine_ctx(D, spec, cats_sub, caps, dev)
        check(select_engine(ctx, SolveSpec(k=k)).name == "jit_sum",
              "engine='auto' does not resolve to jit_sum on the card")
        picks = {}
        for eng in ("jit_sum", "auto", "host"):
            buf_n = len(buf.drain())
            idx, val = _final_solve(x_norm, cats, spec, caps, k, sub, "sum",
                                    engine=eng)
            ran = [s.args["engine"] for s in buf.drain()[buf_n:]
                   if s.name == "final_solve"]
            picks[eng] = dict(indices=idx, value=val, engine=ran[-1])
        check(picks["auto"]["engine"] == "jit_sum",
              f"engine='auto' ran {picks['auto']['engine']}")
        final_same = picks["jit_sum"]["indices"] == picks["host"]["indices"]
        final_div = None
        if not final_same:
            loc = lambda ix: np.searchsorted(sub, ix).tolist()  # noqa: E731
            final_div = _sum_divergence(
                ctx, SolveSpec(k=k), loc(picks["jit_sum"]["indices"]),
                loc(picks["host"]["indices"]))
            check(final_div["tie"], f"final stage: jit_sum and host diverge "
                  f"without a tie: {final_div}")
        check(picks["auto"]["indices"] == picks["jit_sum"]["indices"],
              "engine='auto' and engine='jit_sum' select other indices")
        out["final_stage"] = dict(
            same_as_host=final_same, divergence=final_div,
            engines={e: p["engine"] for e, p in picks.items()},
            diversity=picks["jit_sum"]["value"])

    # 2. a batch of 32 sum queries against the host engine
    with obs.span("engines.sum_batch", cat="chip_smoke"):
        specs = _sum_specs(rng, m, ENGINE_QUERIES, k, caps)
        groups = partition_by_engine(ctx, specs, engine="auto")
        check(groups == {"jit_sum": list(range(len(specs)))},
              f"auto routed the batch as {groups}")
        # runs 2 and 3 of the median are the steady-state window: the
        # same batch again must compile nothing and select the same
        batch_s, runs = _median_s(lambda: JIT_SUM.solve_batch(ctx, specs),
                                  after_first=watch.reset)
        steady = watch.total()
        check(steady == 0, f"a second identical batch compiled: "
              f"{watch.by_key()}")
        got = runs[0]
        check(all(a.local_indices.tolist() == b.local_indices.tolist()
                  for again in runs[1:] for a, b in zip(got, again)),
              "a repeated batch differs")
        one_s, _ = _median_s(lambda: JIT_SUM.solve_batch(ctx, specs[:1]))
        t0 = time.perf_counter()
        want = host.solve_batch(ctx, specs)
        host_s = time.perf_counter() - t0
        sum_cmp = _compare_sum(ctx, specs, got, want, "sum batch")
        # kernels a v-step: one sweep's launches less the greedy seed's
        seed = device_profile(lambda: _jit_sum_rows(ctx, specs, 0))
        prof = device_profile(lambda: _jit_sum_rows(ctx, specs, 1),
                              scope="solver/jit_sum/sweep")
        check(prof.get("scope_count") == 1,
              f"the profiled batch ran no sweep: {prof}")
        out["sum_batch"] = dict(
            B=len(specs), jit_sum_s=batch_s, jit_sum_b1_s=one_s,
            host_loop_s=host_s, host_per_query_s=host_s / len(specs),
            speedup=host_s / batch_s, steady_state_recompiles=steady,
            kernels_per_v_step=(prof.get("launches", 0)
                                - seed.get("launches", 0)) / m,
            busy_share_of_span=prof.get("busy_share_of_span"),
            busy_share_of_wall=prof.get("busy_share_of_wall"),
            profiled_device_ms=prof.get("device_ms"),
            profiled_wall_ms=prof.get("wall_ms"), **sum_cmp)
        for name, secs in (("jit_sum", batch_s), ("host_local_search",
                                                  host_s)):
            obs.histogram("chip_smoke.engines.batch_s",
                          engine=name).observe(secs)

    # 3. a transversal view of the coreset: genre + up to two labels
    with obs.span("engines.transversal", cat="chip_smoke"):
        h = spec.num_categories
        cats_tv = np.full((m, ENGINE_TV_GAMMA), -1, np.int32)
        cats_tv[:, 0] = cats_sub[:, 0]
        for j in range(1, ENGINE_TV_GAMMA):
            extra = rng.random(m) < 0.5
            cats_tv[extra, j] = rng.integers(0, h, int(extra.sum()))
        tv_spec = MatroidSpec("transversal", num_categories=h,
                              gamma=ENGINE_TV_GAMMA)
        ctx_tv = _engine_ctx(D, tv_spec, cats_tv, None, dev)
        tv_specs = _sum_specs(rng, m, ENGINE_TV_QUERIES, min(k, h), None)
        tv_s, (got,) = _median_s(
            lambda: JIT_SUM.solve_batch(ctx_tv, tv_specs), reps=1)
        t0 = time.perf_counter()
        want = host.solve_batch(ctx_tv, tv_specs)
        host_tv_s = time.perf_counter() - t0
        out["transversal"] = dict(
            B=len(tv_specs), h=h, gamma=ENGINE_TV_GAMMA, jit_sum_s=tv_s,
            host_loop_s=host_tv_s,
            **_compare_sum(ctx_tv, tv_specs, got, want, "transversal"))

    # 4. jit_greedy: star and tree on the card against the CPU run
    with obs.span("engines.greedy", cat="chip_smoke"):
        greedy = get_engine("jit_greedy")
        ctx_cpu = _engine_ctx(D, spec, cats_sub, caps, "cpu")
        res = {}
        for variant in ("star", "tree"):
            g_specs = [dataclasses.replace(s, variant=variant, gamma=0.0)
                       for s in _sum_specs(rng, m, ENGINE_GREEDY_QUERIES, k,
                                           caps)]
            g_s, (got,) = _median_s(
                lambda: greedy.solve_batch(ctx, g_specs), reps=1)
            t0 = time.perf_counter()
            want = greedy.solve_batch(ctx_cpu, g_specs)
            cpu_s = time.perf_counter() - t0
            diverged = []
            for i, (a, b) in enumerate(zip(got, want)):
                ga, gb = a.local_indices.tolist(), b.local_indices.tolist()
                if ga != gb:
                    dv = _greedy_divergence(D, ga, gb, variant)
                    diverged.append(dict(query=i, **dv))
                    check(dv["tie"], f"jit_greedy {variant} query {i}: card "
                          f"and CPU diverge without a tie: {dv}")
            res[variant] = dict(B=len(g_specs), card_s=g_s, cpu_s=cpu_s,
                                equal=len(g_specs) - len(diverged),
                                diverged_at_tie=diverged)
        out["greedy"] = res

    # 5. stacked lanes: cosine and raw-Euclidean D, two sets of caps each
    with obs.span("engines.stacked", cat="chip_smoke"):
        raw = points.index_select(0, torch.as_tensor(sub, device=dev))
        D_raw = coreset_distance_matrix(raw, device=dev)  # K1
        tight = np.maximum(1, np.asarray(caps) // 2).astype(np.int32)
        lanes = []
        for Dl in (D, D_raw):
            for lane_caps in (np.asarray(caps, np.int32), tight):
                lctx = _engine_ctx(Dl, spec, cats_sub, lane_caps, dev)
                lanes.append((lctx, _sum_specs(rng, m, 8, k, None)))
        stacked_s, (stacked,) = _median_s(lambda: solve_stacked(lanes),
                                          reps=1)
        t0 = time.perf_counter()
        per_lane = [JIT_SUM.solve_batch(lctx, ls) for lctx, ls in lanes]
        per_lane_s = time.perf_counter() - t0
        for t, (a_sols, b_sols) in enumerate(zip(stacked, per_lane)):
            for i, (a, b) in enumerate(zip(a_sols, b_sols)):
                check(a.local_indices.tolist() == b.local_indices.tolist()
                      and a.value == b.value,
                      f"stacked lane {t} row {i} differs from its per-lane "
                      f"solve: {a} != {b}")
        out["stacked"] = dict(lanes=len(lanes), rows=sum(
            len(ls) for _c, ls in lanes), stacked_s=stacked_s,
            per_lane_s=per_lane_s, bit_identical=True)

    launches = ops.launch_counts()
    check(launches["pairwise_sqdist"] >= 2, "K1 was not launched")
    spans = [s for s in buf.drain() if s.name.startswith("engines.")]
    out.update(
        launches=launches, spans=len(spans),
        metrics_series=len(obs.metrics_snapshot()),
        recompiles_by_key=watch.by_key(),
        span_s={s.name: s.dur_us / 1e6 for s in spans})
    watch.close()
    emit(out)
    return dict(launches=launches)


def _serve_queries(rng, n: int, k_max: int, caps, genres: int) -> list:
    """n sum queries as the ``engines`` phase draws them (k in [4, k_max],
    caps at most the genre caps, gamma 0 or 0.01), with a category filter
    of 3/4 of the genres in place of its row mask on every other one."""
    import numpy as np
    from repro_torch.serve.diversity import DiversityQuery

    out = []
    for i in range(n):
        allowed = None if i % 2 == 0 else frozenset(
            int(g) for g in rng.choice(genres, genres * 3 // 4,
                                       replace=False))
        out.append(DiversityQuery(
            k=int(rng.integers(ENGINE_K_MIN, k_max + 1)),
            caps=tuple(int(c) for c in rng.integers(1, np.asarray(caps) + 1)),
            allowed_cats=allowed, gamma=float(rng.choice([0.0, 0.01]))))
    return out


def phase_serve(points, cats, caps, spec, k: int, tau: int, seed: int,
                st_stream, stream_points_per_s: float) -> dict:
    """songs-sim served through ``DiversityService`` (module docstring,
    phase 9)."""
    import threading
    import types

    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import (
        MatroidSpec,
        PartitionMatroid,
        epoch_fingerprint,
        epoch_stats,
        final_solve,
        geometry,
        ingest_batch_donated,
        init_stream_state,
        snapshot_coreset,
    )
    from repro_torch.core.compose import compact_coreset
    from repro_torch.core.final_solve import coreset_distance_matrix
    from repro_torch.kernels import ops
    from repro_torch.serve.diversity import (
        DistanceCache,
        DiversityQuery,
        DiversityService,
    )

    t_phase = time.perf_counter()
    # songs-sim on the host once, outside every timed window: a client's
    # batches arrive on the host
    P = points.cpu().numpy()
    C = np.asarray(cats, np.int32).reshape(-1, 1)
    n, d = P.shape
    half = n // 2
    first = [(a, min(half, a + INGEST_BATCH))
             for a in range(0, half, INGEST_BATCH)]
    rest = [(a, min(n, a + INGEST_BATCH)) for a in range(half, n, INGEST_BATCH)]
    stream_cs = snapshot_coreset(st_stream)
    stream_src = stream_cs.src_idx[stream_cs.valid].cpu().numpy()

    # the cache's K1 builds on the card, each timed (synced)
    builds = []

    def k1_build(pts):
        t0 = time.perf_counter()
        D = coreset_distance_matrix(pts, device="cuda", host=False)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        return D

    reg = obs.MetricsRegistry()
    watch = obs.RecompileWatch()
    history: dict[int, float] = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    svc = DiversityService(
        spec, k, tau=tau, caps=caps, metric="cosine", block_size=BLOCK,
        registry=reg, device="cuda",
        cache=DistanceCache(k1_build, registry=reg, device="cuda"))
    rt, fe = svc.runtime, svc.frontend
    rt.on_publish = lambda snap: history.__setitem__(snap.epoch,
                                                     snap.published_at)
    t0 = time.perf_counter()
    warm = svc.warmup(d=d)
    warmup_s = time.perf_counter() - t0
    warmup_events = watch.by_source()
    tight_caps = np.maximum(np.asarray(caps) // 2, 1).astype(np.int32)
    tenants = dict(default=fe.default_tenant,
                   tight=fe.register_tenant("tight", caps=tight_caps),
                   uniform=fe.register_tenant("uniform",
                                              spec=MatroidSpec("uniform")))
    tight_shares = tenants["tight"].key == tenants["default"].key
    watch.reset()

    # the first half through ingest()
    ingest_s, first_ingest_events = 0.0, None
    for a, b in first:
        t0 = time.perf_counter()
        svc.ingest(P[a:b], C[a:b])
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
        if first_ingest_events is None:
            first_ingest_events = watch.by_source()
    check(not first_ingest_events,
          f"the first ingest after warmup compiled: {first_ingest_events}")
    e_half = rt.refresh().epoch

    # the rest through submit() while a second thread queries `default`
    loop, loop_errors, stop = [], [], threading.Event()
    loop_qs = [DiversityQuery(k=k)] * 4

    def query_loop():
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                rs = fe.query_batch(loop_qs, engine="host")
                loop.append((rs[0].epoch, time.monotonic(),
                             time.perf_counter() - t0))
        except BaseException as exc:  # surfaced by the check below
            loop_errors.append(exc)

    th = threading.Thread(target=query_loop, daemon=True)
    th.start()
    t0 = time.perf_counter()
    for a, b in rest:
        rt.submit(P[a:b], C[a:b])
    e_flush = fe.flush()
    submit_s = time.perf_counter() - t0
    stop.set()
    th.join(120.0)
    check(not th.is_alive() and not loop_errors,
          f"the query loop failed: {loop_errors}")
    check(len(loop) > 0, "the query loop answered nothing")
    for e, t_ans, _dt in loop:
        check(e in history and history[e] <= t_ans,
              f"a concurrent answer named epoch {e}, unpublished when it "
              f"was answered")
    fresh = fe.query_batch([DiversityQuery(k=k)], min_epoch=e_flush,
                           engine="host")[0]
    newest = rt.latest()
    check(fresh.epoch == newest.epoch >= e_flush,
          f"min_epoch=flush() answered epoch {fresh.epoch}, newest "
          f"{newest.epoch}")

    # each tenant once on the newest epoch (K1 per cold key), then a
    # second batch on the same epoch: no K1
    per_tenant = {}
    for name in tenants:
        nb = len(builds)
        t0 = time.perf_counter()
        r = fe.query(DiversityQuery(k=k), tenant=name, engine="host")
        per_tenant[name] = dict(
            query_s=time.perf_counter() - t0, from_cache=r.from_cache,
            k1_build_s=builds[-1] if len(builds) > nb else None,
            size=r.coreset_size, diversity=r.diversity)
    b0, k1_0 = svc.cache.stats.builds, ops.launch_counts()["pairwise_sqdist"]
    for name in tenants:
        fe.query_batch(loop_qs, tenant=name, engine="host")
    check(svc.cache.stats.builds == b0
          and ops.launch_counts()["pairwise_sqdist"] == k1_0,
          "a second batch on the same epoch launched K1")

    # query_batch at B = 1 and 32, auto and host (synced, median of 3)
    qs = _serve_queries(np.random.default_rng(seed + 9), ENGINE_QUERIES, k,
                        caps, int(np.asarray(caps).size))
    timing, answers = {}, {}
    for B in (1, ENGINE_QUERIES):
        for engine in ("auto", "host"):
            s, outs = _median_s(
                lambda: fe.query_batch(qs[:B], engine=engine))
            timing[f"{engine}_b{B}_s"] = s
            answers[(engine, B)] = outs[0]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    main_path_s = time.perf_counter() - t_phase
    check(launches["center_precheck"] >= -(-n // BLOCK),
          f"K3 launched {launches['center_precheck']} times on the serve "
          f"path")
    check(launches["pairwise_sqdist"] == svc.cache.stats.builds >= 2,
          f"K1 launches {launches['pairwise_sqdist']} != cache builds "
          f"{svc.cache.stats.builds}")
    auto_engines = sorted({r.engine
                           for r in answers[("auto", ENGINE_QUERIES)]})

    # checks off the counted path: the direct scan of the same batches,
    # each step of a batch timed on its own (synced): the runtime's
    # finite check, the copy to the card, the normalization, the scan
    # and the fingerprint
    snap = rt.latest()
    st = init_stream_state(d, 1, spec, k, tau, device="cuda")
    steps = dict(finite_check_s=0.0, copy_s=0.0, normalize_s=0.0,
                 scan_s=0.0, fingerprint_s=0.0)

    def timed(step, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[step] += time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    for a, b in first + rest:
        m = b - a
        pad = -m % BLOCK
        pts, cts = P[a:b], C[a:b]
        timed("finite_check_s", lambda: bool(np.isfinite(pts).all()))
        if pad:
            pts = np.concatenate([pts, np.zeros((pad, d), np.float32)])
            cts = np.concatenate([cts, np.full((pad, 1), -1, np.int32)])
        x = timed("copy_s", lambda: torch.as_tensor(pts, device="cuda"))
        pn = timed("normalize_s",
                   lambda: geometry.normalize_for_metric(x, "cosine"))
        st = timed("scan_s", lambda: ingest_batch_donated(
            st, pn, cts, np.arange(m + pad) < m, spec, caps, k, tau,
            base_index=a, block_size=BLOCK))
        timed("fingerprint_s", lambda: epoch_fingerprint(st))
    direct_s = time.perf_counter() - t0
    _, _, direct_src = compact_coreset(snapshot_coreset(st))
    triple = [int(v) for v in epoch_stats(rt.state)]
    direct_triple = [int(v) for v in epoch_stats(st)]
    check(np.array_equal(snap.src_idx, direct_src),
          "the published snapshot is not the direct scan's")
    check(triple == direct_triple,
          f"epoch triple {triple} != the direct scan's {direct_triple}")
    same_as_stream = bool(np.array_equal(snap.src_idx, stream_src))
    stream_diff = None if same_as_stream else dict(
        served=len(snap.src_idx), stream=len(stream_src),
        only_served=sorted(set(snap.src_idx.tolist())
                           - set(stream_src.tolist()))[:8],
        only_stream=sorted(set(stream_src.tolist())
                           - set(snap.src_idx.tolist()))[:8])

    # auto against host on the same entry, query for query
    t_def = tenants["default"]
    entry = svc.cache.lookup(t_def.key, snap.fingerprint)
    ctx = fe._solve_context(t_def, snap, entry)
    specs = [fe._solve_spec(entry, q) for q in qs]

    def sols(rs):
        return [types.SimpleNamespace(local_indices=r.local_indices,
                                      value=r.diversity) for r in rs]

    auto_vs_host = _compare_sum(ctx, specs,
                                sols(answers[("auto", ENGINE_QUERIES)]),
                                sols(answers[("host", ENGINE_QUERIES)]),
                                "serve auto vs host")
    # host against core.final_solve on the snapshot's coreset
    D = coreset_distance_matrix(snap.points, device="cuda")
    fs_sel, fs_val = final_solve(D, PartitionMatroid(snap.cats[:, 0], caps),
                                 k, "sum", engine="host", device="cuda")
    check(fresh.local_indices.tolist() == fs_sel
          and fresh.diversity == fs_val,
          f"host selects {fresh.local_indices.tolist()}, final_solve "
          f"{fs_sel}")
    # each tenant's D against the plain pdist on its entry's points
    k1_err = {}
    for name, t in tenants.items():
        e = svc.cache.lookup(t.key, snap.fingerprint)
        check(e is not None and e.D.is_cuda, f"{name}: no entry on the card")
        pts = torch.as_tensor(e.points, device="cuda")
        want = ops.pairwise_sqdist(pts, pts, force="ref", device=pts.device)
        got = e.D * e.D
        k1_err[name] = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4)),
              f"{name}: entry D off the plain pdist by {k1_err[name]}")
    stale = reg.histogram("serve.epoch.staleness_s")
    publish = reg.histogram("serve.epoch.publish_latency_s")
    loop_s = sorted(dt for _e, _t, dt in loop)
    svc.close()
    watch.close()
    emit(dict(
        phase="serve", n=n, dim=d, k=k, tau=tau, block_size=BLOCK,
        batch=INGEST_BATCH, metric="cosine", warmup=warm, warmup_s=warmup_s,
        warmup_compile_events=warmup_events,
        first_ingest_compile_events=first_ingest_events or {},
        tight_shares_default_entry=tight_shares,
        ingest_points_per_s=half / ingest_s, ingest_s=ingest_s,
        submit_flush_points_per_s=(n - half) / submit_s,
        submit_flush_s=submit_s,
        stream_phase_points_per_s=stream_points_per_s,
        epochs_published=rt.epochs_published, epoch_half=e_half,
        epoch_flush=e_flush, newest_epoch=newest.epoch,
        materializations=rt.snapshot_materializations,
        publish_latency_s=publish.describe(),
        staleness_s=dict(p50=stale.quantile(0.5), p99=stale.quantile(0.99),
                         count=stale.count),
        concurrent_queries=dict(
            batches=len(loop), queries_a_batch=len(loop_qs),
            epochs_seen=sorted({e for e, _t, _dt in loop}),
            median_s=loop_s[len(loop_s) // 2], max_s=loop_s[-1]),
        per_tenant=per_tenant, k1_builds_s=builds,
        k1_entry_max_abs_err=k1_err, query_batch=timing,
        auto_engines=auto_engines, auto_vs_host=auto_vs_host,
        cost_model_decisions=fe.cost_model.decisions()[-8:],
        coreset_size=snap.size, epoch_triple=triple,
        snapshot_equals_direct_scan=True, direct_scan_s=direct_s,
        direct_scan_steps_s=steps,
        snapshot_equals_stream_phase=same_as_stream,
        stream_phase_difference=stream_diff, launches=launches,
        cache=svc.cache.stats.snapshot(), main_path_s=main_path_s,
        seconds=time.perf_counter() - t_phase))
    # the durable phase serves the same batches and holds its replicas to
    # this direct scan
    return dict(launches=launches, P=P, C=C, spans=first + rest,
                direct_src=direct_src, direct_triple=direct_triple,
                ingest_points_per_s=half / ingest_s,
                submit_flush_points_per_s=(n - half) / submit_s,
                query_batch=timing,
                concurrent_median_s=loop_s[len(loop_s) // 2])


DURABLE_QUERY_THREADS, DURABLE_QUERIES = 8, 4
DURABLE_CKPT_EVERY, DURABLE_KEEP = 4, 2


def _timed_method(obj, name: str, log: list) -> None:
    """Wrap ``obj.name`` so each call appends its seconds to ``log``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log.append(time.perf_counter() - t0)

    setattr(obj, name, timed)


def phase_durable(spec, caps, k: int, tau: int, seed: int, serve: dict,
                  stream_points_per_s: float) -> dict:
    """songs-sim served by a primary and a hot standby with logs and
    checkpoints, through the coalescing frontend (module docstring,
    phase 10)."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import MatroidSpec, epoch_stats
    from repro_torch.kernels import ops
    from repro_torch.serve.diversity import (
        DiversityQuery,
        DiversityService,
        DurabilityConfig,
        FaultPlan,
        FaultPolicy,
        FaultRule,
        HealthMonitor,
        IntegrityAuditor,
        ReplicaSet,
        list_checkpoints,
    )
    from repro_torch.serve.diversity import runtime as runtime_mod

    t_phase = time.perf_counter()
    P, C, spans = serve["P"], serve["C"], serve["spans"]
    n = P.shape[0]
    genres = int(np.asarray(caps).size)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_durable-")
    saves = []  # (seconds, bytes) of each checkpoint file written
    save_checkpoint = runtime_mod.save_checkpoint

    def timed_save(path, *args, **kwargs):
        t0 = time.perf_counter()
        out = save_checkpoint(path, *args, **kwargs)
        saves.append((time.perf_counter() - t0, os.path.getsize(path)))
        return out

    runtime_mod.save_checkpoint = timed_save
    try:
        free = shutil.disk_usage(tmp)
        reg = obs.MetricsRegistry()
        crash_at = len(spans) // 2
        plan = FaultPlan(seed, [FaultRule(site="worker.loop", kind="crash",
                                          after=crash_at, times=1)])
        torch.cuda.synchronize()
        ops.reset_launches()
        rs = ReplicaSet.create(
            spec, k, tau=tau, caps=caps, metric="cosine", block_size=BLOCK,
            dir=tmp, n_standbys=1, registry=reg, faults=plan,
            fault_policy=FaultPolicy(max_worker_restarts=0),
            durability=DurabilityConfig(dir="",
                                        checkpoint_every=DURABLE_CKPT_EVERY,
                                        keep=DURABLE_KEEP),
            device="cuda")
        rs.register_tenant("uniform", spec=MatroidSpec("uniform"))
        replicas = [rs.primary] + rs.standbys
        # every publication of either replica, by epoch: the earliest
        # publish stamp (taken before the snapshot is visible)
        published: dict[int, float] = {}
        pub_mu = threading.Lock()

        def on_publish(snap):
            with pub_mu:
                t = published.get(snap.epoch, math.inf)
                published[snap.epoch] = min(t, snap.published_at)

        appends = {r.name: [] for r in replicas}
        compactions = {r.name: [] for r in replicas}
        for r in replicas:
            r.runtime.on_publish = on_publish
            _timed_method(r.runtime._wal, "append", appends[r.name])
            _timed_method(r.runtime._wal, "compact", compactions[r.name])

        # 8 query threads on both tenants while the stream goes in
        rng = np.random.default_rng(seed + 10)
        thread_qs = []
        for i in range(DURABLE_QUERY_THREADS):
            if i % 2 == 0:
                thread_qs.append(("default", _serve_queries(
                    rng, DURABLE_QUERIES, k, caps, genres)))
            else:
                thread_qs.append(("uniform", [
                    DiversityQuery(k=int(rng.integers(ENGINE_K_MIN, k + 1)))
                    for _ in range(DURABLE_QUERIES)]))
        answers, retried, errors = [], [], []
        ans_mu = threading.Lock()
        stop = threading.Event()

        def query_loop(tenant, qs):
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    rs_ = rs.query_batch(qs, tenant=tenant)
                except RuntimeError as exc:
                    # between the primary's death and the promotion a
                    # read of the dead primary raises; a client retries
                    if plan.fired("worker.loop") and (
                            "ingest worker failed" in str(exc)
                            or "closed" in str(exc)):
                        with ans_mu:
                            retried.append(repr(exc))
                        continue
                    errors.append(exc)
                    return
                except BaseException as exc:  # surfaced by the check below
                    errors.append(exc)
                    return
                t_ans = time.monotonic()
                with ans_mu:
                    answers.append((rs_[0].epoch, t_ans,
                                    time.perf_counter() - t0))

        threads = [threading.Thread(target=query_loop, args=tq, daemon=True)
                   for tq in thread_qs]
        t0 = time.perf_counter()
        for i, (a, b) in enumerate(spans):
            rs.submit(P[a:b], C[a:b])
            rs.observe_lag()
            if i == 0:  # the readers start on the first published epoch
                rs.flush()
                for th in threads:
                    th.start()
        e_flush = rs.flush()
        ingest_s = time.perf_counter() - t0
        stop.set()
        for th in threads:
            th.join(300.0)
        check(not any(th.is_alive() for th in threads) and not errors,
              f"the durable query threads failed: {errors}")
        check(len(answers) > 0, "the durable query threads answered nothing")
        # the crash fired and the standby took over with every acked batch
        check(plan.fired("worker.loop") == 1,
              "the primary's crash did not fire")
        fo = rs.last_failover
        check(fo is not None and fo["promoted"] == "standby-0"
              and rs.primary.name == "standby-0",
              f"no promotion after the crash: {fo}")
        prt = rs.primary.runtime
        check(prt.n_offered == n and prt._applied_seq == rs.acked_seq
              and rs.stats()["acked_batches"] == len(spans),
              f"n_offered {prt.n_offered} != {n} or applied seq "
              f"{prt._applied_seq} != acked {rs.acked_seq}")
        snap = prt.latest()
        triple = [int(v) for v in epoch_stats(prt.state)]
        check(np.array_equal(snap.src_idx, serve["direct_src"])
              and triple == serve["direct_triple"],
              f"the promoted primary's snapshot is not the direct scan's "
              f"(triple {triple} vs {serve['direct_triple']})")
        check(not rs.standbys, "a standby remains after the failover")
        for e, t_ans, _dt in answers:
            check(published.get(e, math.inf) <= t_ans,
                  f"a concurrent answer named epoch {e}, unpublished when "
                  f"it was answered")

        # coalesced against direct: 32 host queries from 8 threads, then
        # the same 32 from one caller, on the same epoch
        fe = rs.primary.frontend
        groups0 = reg.counter("serve.coalesce.groups").value
        calls = [(t, list(qs)) for t, qs in thread_qs]
        co_out = [None] * len(calls)
        barrier = threading.Barrier(len(calls))

        def coalesced(i, tenant, qs):
            barrier.wait()
            co_out[i] = fe.query_batch(qs, tenant=tenant, engine="host")

        cths = [threading.Thread(target=coalesced, args=(i, t, qs))
                for i, (t, qs) in enumerate(calls)]
        t0 = time.perf_counter()
        for th in cths:
            th.start()
        for th in cths:
            th.join(300.0)
        coalesced_s = time.perf_counter() - t0
        check(all(o is not None for o in co_out),
              "a coalesced caller got no answer")
        solo0 = reg.counter("serve.coalesce.solo").value
        t0 = time.perf_counter()
        direct = {t: fe.query_batch(
            [q for tt, qs in calls if tt == t for q in qs], tenant=t,
            engine="host") for t in ("default", "uniform")}
        direct_s = time.perf_counter() - t0
        check(reg.counter("serve.coalesce.solo").value == solo0 + 2,
              "the single caller did not take the direct path")
        pos = {"default": 0, "uniform": 0}
        for (t, qs), out in zip(calls, co_out):
            for q, got in zip(qs, out):
                want = direct[t][pos[t]]
                pos[t] += 1
                check(got.indices.tolist() == want.indices.tolist()
                      and got.diversity == want.diversity
                      and got.epoch == want.epoch == e_flush,
                      f"{t}: coalesced {got.indices.tolist()} (epoch "
                      f"{got.epoch}) != direct {want.indices.tolist()} "
                      f"(epoch {want.epoch})")
        gcalls = reg.histogram("serve.coalesce.group_calls")
        check(reg.counter("serve.coalesce.groups").value > 0
              and gcalls.count and gcalls.sum / gcalls.count > 1.0,
              f"no coalescing: {gcalls.describe()}")

        # audit: clean; a swapped-in entry off by +10 on the card, then
        # on the host, is a pdist violation; the entry goes back
        aud = IntegrityAuditor(rs)
        reports = aud.audit_once()
        check(all(r.ok for r in reports),
              f"audit: {[r.violations for r in reports]}")
        cache = fe.cache
        key = fe.default_tenant.key
        entry = cache.lookup(key, snap.fingerprint)
        check(entry is not None and entry.D.is_cuda,
              "no default entry on the card")
        caught = {}
        for where in ("card", "host"):
            bad = dataclasses.replace(
                entry, D=entry.D + 10.0 if where == "card" else entry.D,
                D_host=entry.D_host + 10.0 if where == "host"
                else entry.D_host)
            with cache._mu:
                cache._entries[key] = bad
            try:
                viol = [v for r in aud.audit_once() for v in r.violations
                        if v.startswith("pdist")]
            finally:
                with cache._mu:
                    cache._entries[key] = entry
            check(bool(viol), f"a corrupt D on the {where} went unseen")
            caught[where] = viol[0]
        check(all(r.ok for r in aud.audit_once()),
              "the audit is not clean after the entry went back")
        health = HealthMonitor(rs).probe()
        check(health["healthy"], f"unhealthy after the failover: {health}")
        want_q = [DiversityQuery(k=k)] + _serve_queries(
            np.random.default_rng(seed + 11), 3, k, caps, genres)
        promoted_ans = fe.query_batch(want_q, engine="host")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        main_path_s = time.perf_counter() - t_phase
        check(launches["center_precheck"] >= 1
              and launches["pairwise_sqdist"] >= 1,
              f"K3 or K1 not launched on the durable path: {launches}")

        stats = rs.stats()
        lag = reg.histogram("serve.replication.lag_batches")
        failover_s = reg.histogram("serve.replication.failover_s")
        wait = reg.histogram("serve.coalesce.queue_wait_s")
        wal_bytes = reg.counter("serve.wal.bytes").value
        ckpt_saved = reg.counter("serve.ckpt.saved").value
        qlat = sorted(dt for _e, _t, dt in answers)
        promoted_dir = os.path.join(tmp, "standby-0")
        rs.close()
        rs_saves = list(saves)  # the set's, its parting save included

        # restore the promoted replica's directory, as closed, then with
        # its newest checkpoint torn (the older one and the log's tail)
        restores = []
        for torn in (False, True):
            if torn:
                newest = list_checkpoints(promoted_dir)[-1]
                with open(newest, "r+b") as f:
                    f.truncate(64)
            k3_0 = ops.launch_counts()["center_precheck"]
            t0 = time.perf_counter()
            svc = DiversityService.restore(promoted_dir, device="cuda")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            rep = svc.runtime.restore_report
            k3 = ops.launch_counts()["center_precheck"] - k3_0
            rsnap = svc.runtime.latest()
            rtriple = [int(v) for v in epoch_stats(svc.runtime.state)]
            check(np.array_equal(rsnap.src_idx, serve["direct_src"])
                  and rtriple == serve["direct_triple"],
                  f"restore (torn={torn}) is not the direct scan")
            check(rep["checkpoint"] is not None
                  and svc.runtime.state.dp.is_cuda
                  and (rep["replayed_batches"] >= 1 or not torn),
                  f"restore (torn={torn}): {rep}")
            blocks = sum(-(-int(b - a) // BLOCK) for a, b in spans
                         [len(spans) - rep["replayed_batches"]:])
            check(k3 >= blocks,
                  f"K3 launched {k3} times restoring {blocks} blocks")
            got_q = svc.query_batch(want_q, engine="host")
            check([r.indices.tolist() for r in got_q]
                  == [r.indices.tolist() for r in promoted_ans],
                  f"the restored service (torn={torn}) selects otherwise")
            restores.append(dict(
                torn_newest=torn, checkpoint=os.path.basename(
                    rep["checkpoint"]),
                replayed_batches=rep["replayed_batches"],
                replayed_points=rep["replayed_points"],
                restore_s=rep["restore_s"], wall_s=wall_s,
                k3_launches=k3, replayed_blocks=blocks))
            svc.close()
        launches = ops.launch_counts()
    finally:
        runtime_mod.save_checkpoint = save_checkpoint
        shutil.rmtree(tmp, ignore_errors=True)
    emit(dict(
        phase="durable", n=n, dim=P.shape[1], k=k, tau=tau, block_size=BLOCK,
        batch=INGEST_BATCH, batches=len(spans), replicas=2,
        checkpoint_every=DURABLE_CKPT_EVERY, keep=DURABLE_KEEP,
        tmp_free_bytes=free.free, crash_after_batches=crash_at,
        durable_ingest_points_per_s=n / ingest_s, durable_ingest_s=ingest_s,
        serve_ingest_points_per_s=serve["ingest_points_per_s"],
        serve_submit_flush_points_per_s=serve["submit_flush_points_per_s"],
        stream_phase_points_per_s=stream_points_per_s,
        wal_bytes_written=wal_bytes,
        wal_append_s={name: dict(batches=len(v), median=statistics.median(v),
                                 max=max(v)) for name, v in appends.items()
                      if v},
        wal_compactions={name: dict(count=len(v), total_s=sum(v))
                         for name, v in compactions.items()},
        checkpoints=dict(saved=ckpt_saved, files=len(rs_saves),
                         bytes=[b for _s, b in rs_saves],
                         save_ms=[1e3 * s for s, _b in rs_saves]),
        standby_lag_batches=dict(p50=lag.quantile(0.5), max=lag.describe()[
            "max"], samples=lag.count),
        failover=dict(failover_s=failover_s.describe()["max"],
                      reason=fo["reason"], applied_seq=fo["applied_seq"],
                      acked_seq=fo["acked_seq"],
                      drained_calls=fo["drained_calls"]),
        restores=restores,
        coalesce=dict(groups=reg.counter("serve.coalesce.groups").value,
                      groups_in_check=reg.counter(
                          "serve.coalesce.groups").value - groups0,
                      calls_per_group=gcalls.sum / gcalls.count,
                      queue_wait_s=dict(p50=wait.quantile(0.5),
                                        p99=wait.quantile(0.99)),
                      stacked_solves=reg.counter(
                          "serve.coalesce.stacked_solves").value,
                      solo=reg.counter("serve.coalesce.solo").value,
                      stale_reads=reg.counter(
                          "serve.replication.stale_reads").value,
                      coalesced_32_s=coalesced_s, direct_32_s=direct_s),
        query_batch_under_coalescing_s=dict(
            batches=len(qlat), queries_a_batch=DURABLE_QUERIES,
            threads=DURABLE_QUERY_THREADS, p50=qlat[len(qlat) // 2],
            p99=qlat[min(len(qlat) - 1, int(0.99 * len(qlat)))],
            max=qlat[-1], epochs_seen=len({e for e, _t, _d in answers}),
            retried_during_failover=len(retried)),
        serve_direct_query_batch_s=serve["query_batch"],
        serve_concurrent_median_s=serve["concurrent_median_s"],
        audit=dict(replicas=len(reports), checks=aud.total_checks,
                   caught_card=caught["card"], caught_host=caught["host"]),
        health=dict(healthy=health["healthy"], primary=health["primary"]),
        acked_batches=stats["acked_batches"], launches=launches,
        main_path_s=main_path_s, seconds=time.perf_counter() - t_phase))
    return dict(launches=launches)


def _assert_states_equal(a, b, what: str) -> None:
    import torch
    from repro_torch.core import StreamState

    for f in StreamState._fields:
        check(bool(torch.equal(getattr(a, f), getattr(b, f))),
              f"{what}: field {f} differs")


def phase_stream(points, x_norm, cats, caps, spec, k: int, tau: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import (
        PartitionMatroid,
        epoch_fingerprint,
        ingest_batch,
        init_stream_state,
        snapshot_coreset,
        solve_dmmc,
        stream_coreset,
    )
    from repro_torch.core import streaming
    from repro_torch.core.solve import _final_solve
    from repro_torch.kernels import ops, precheck

    n, d = x_norm.shape
    valid = np.ones(n, bool)
    blocks = -(-n // BLOCK)

    # A: one pass on the kernel path
    torch.cuda.synchronize()
    ops.reset_launches()
    streaming.reset_scan_counts()
    t0 = time.perf_counter()
    cs_a, st_a = stream_coreset(x_norm, cats, valid, spec, caps, k, tau,
                                block_size=BLOCK, device="cuda")
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches_a = ops.launch_counts()
    counts_a = streaming.scan_counts()
    check(launches_a["center_precheck"] >= blocks,
          f"K3 launched {launches_a['center_precheck']} < {blocks} times")
    check(launches_a["gmm_update"] == 0, "K2 launched on the streaming path")
    fp_a = epoch_fingerprint(st_a)

    # B: the plain path, resumed batch by batch as the serving runtime does;
    # the state after the batch that crosses n / 2 is kept (mid-pass)
    t0 = time.perf_counter()
    st_b = init_stream_state(d, cats.shape[1], spec, k, tau, device="cuda")
    st_mid = None
    for off in range(0, n, INGEST_BATCH):
        end = min(n, off + INGEST_BATCH)
        st_b = ingest_batch(st_b, x_norm[off:end], cats[off:end],
                            valid[off:end], spec, caps, k, tau,
                            base_index=off, block_size=BLOCK, force="ref")
        fp_b = epoch_fingerprint(st_b)
        if st_mid is None and end >= n // 2:
            st_mid, mid_end = st_b, end
    torch.cuda.synchronize()
    plain_stream_s = time.perf_counter() - t0
    _assert_states_equal(st_a, st_b, "kernel pass vs plain batched resume")
    check(fp_a == fp_b, "epoch fingerprints differ")

    # blocked == per-point on a prefix (a per-point pass syncs per point)
    t0 = time.perf_counter()
    _, st_pp = stream_coreset(x_norm[:PREFIX], cats[:PREFIX], valid[:PREFIX],
                              spec, caps, k, tau, block_size=1,
                              device="cuda")
    torch.cuda.synchronize()
    per_point_s = time.perf_counter() - t0
    _, st_bl = stream_coreset(x_norm[:PREFIX], cats[:PREFIX], valid[:PREFIX],
                              spec, caps, k, tau, block_size=BLOCK,
                              device="cuda")
    _assert_states_equal(st_pp, st_bl, f"blocked vs per-point, {PREFIX} pts")

    # a steady-state window on the card: 64 blocks resumed into a copy of
    # the final state, under the profiler; a block should cost one K3
    # launch and one copy to the host
    off = (n // 2) // BLOCK * BLOCK
    def window_run():
        # ingest_batch works on a copy of st_a; the counts are the last
        # window's
        nonlocal before
        before = streaming.scan_counts()
        ingest_batch(st_a, x_norm[off:off + 64 * BLOCK],
                     cats[off:off + 64 * BLOCK], valid[off:off + 64 * BLOCK],
                     spec, caps, k, tau, base_index=off, block_size=BLOCK)

    before = None
    window = device_profile_pure(window_run, count="precheck")
    window_counts = {key: v - before[key]
                     for key, v in streaming.scan_counts().items()}
    per_block = dict(device_events=window["kernels"] / 64,
                     kernels=window["launches"] / 64,
                     copies=window["copies"] / 64,
                     k3_launches=window["counted"] / 64,
                     scan_counts=window_counts)
    check(per_block["kernels"] <= 5,
          f"{per_block['kernels']} CUDA kernels a block in the window")

    # K3 at the main path's shape: stream blocks against the final centers
    k3_lines = [
        _check_precheck(x_norm[b * BLOCK:(b + 1) * BLOCK], st_a.centers,
                        st_a.cvalid, f"songs-sim block {b}, final centers")
        for b in np.linspace(0, blocks - 2, 8).astype(int)
    ]
    # K3's fused route (the scan's) against its plain version on 8 blocks
    # after the mid-pass state and 8 of the whole stream against the final
    # one, with that state's thresholds, radius and diameter flags
    fused_lines = []
    for st_x, lo, what in ((st_mid, mid_end, "mid-pass"),
                           (st_a, 0, "final")):
        for b in np.linspace(lo // BLOCK, blocks - 2, 8).astype(int):
            fused_lines.append(_check_block_precheck(
                x_norm[b * BLOCK:(b + 1) * BLOCK], st_x,
                f"songs-sim block {b}, {what} centers"))

    # the streaming solve, with launch counts read around it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launches()
    sol = solve_dmmc(points, k, spec, cats=cats, caps=caps, tau=tau,
                     setting="streaming", metric="cosine", variant="sum",
                     engine="host", device="cuda")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    solve_peak = (points.numel() * points.element_size()
                  + torch.cuda.max_memory_allocated() - before)
    snap = snapshot_coreset(st_a)
    check(np.array_equal(sol.coreset_indices,
                         snap.src_idx[snap.valid].cpu().numpy()),
          "streaming solve's coreset is not the scan's snapshot")
    check(launches["center_precheck"] >= blocks,
          f"K3 launched {launches['center_precheck']} < {blocks} times")
    check(launches["pairwise_sqdist"] >= 1, "K1 was not launched")
    check(launches["gmm_update"] == 0, "K2 launched on the streaming path")
    check(len(sol.indices) == k, f"{len(sol.indices)} points selected, k={k}")
    check(PartitionMatroid(cats[:, 0], caps).is_independent(
        list(sol.indices)), "solution violates the partition matroid")
    check(np.isfinite(sol.diversity) and sol.diversity > 0,
          f"diversity {sol.diversity}")
    rows = x_norm.index_select(
        0, torch.as_tensor(sol.coreset_indices, device="cuda"))
    k1_err = _check_pdist_at(rows, "the streaming coreset")
    fs_idx, _ = _final_solve(x_norm, cats, spec, caps, k,
                             sol.coreset_indices, "sum", force="ref")
    check(np.array_equal(np.sort(fs_idx), np.sort(sol.indices)),
          "final stage on the plain pdist selects other indices")
    emit(dict(
        phase="stream", n=n, dim=d, k=k, tau=tau, block_size=BLOCK,
        variant="radius", stream_s=stream_s, points_per_s=n / stream_s,
        plain_batched_stream_s=plain_stream_s,
        per_point_prefix_s=per_point_s, prefix=PREFIX,
        scan_counts=counts_a, pass_launches=launches_a,
        centers=int(st_a.cvalid.sum()), R=float(st_a.R),
        coreset_s=sol.timings["coreset_s"], solver_s=sol.timings["solver_s"],
        total_s=sol.timings["total_s"], coreset_size=sol.coreset_size,
        diversity=sol.diversity, solve_peak_device_bytes=solve_peak,
        launches=launches, pdist_max_abs_err_at_coreset=k1_err,
        profiled_window_64_blocks=window, window_per_block=per_block,
        k3_cluster=precheck.last_plan, k3_main_path=k3_lines,
        k3_fused_main_path=fused_lines,
    ))
    return dict(st=st_a, launches=launches, points_per_s=n / stream_s,
                k3_err=max(line["max_abs_err"] for line in k3_lines))


def _time_precheck(x_norm, st) -> dict:
    """K3's two routes and their plain versions on a block of the stream
    against the scan's final center buffer, (128, 65, 5000) on the main
    path: (b) the fused block precheck, which the scan launches, with the
    final state's thresholds (radius variant); (a) the stats route, the
    TPU kernel's function. Bounds count the valid centers only: the kernel
    reads no invalid row."""
    from repro_torch.kernels import ops, precheck, ref

    xb = x_norm[:BLOCK]
    c, cv = st.centers, st.cvalid
    B, d = xb.shape
    T = c.shape[0]
    tv = int(cv.sum())
    thr = 2.0 * float(st.R)
    reads = (B * d + tv * d) * 4 + T
    dots = 2 * B * tv * d + 2 * (B + tv) * d
    b_a, by_a = bound_ms(reads + 5 * B * 4, dots + 6 * B * tv)
    # the fused route also refines two candidates (a difference and an
    # FMA a column) and writes (2, B) int32
    b_b, by_b = bound_ms(reads + 2 * B * 4, dots + 6 * B * tv + 6 * B * d)

    def stats():
        return precheck.center_precheck_stats(xb, c, cv)

    def fused():
        return precheck.block_precheck(xb, c, cv, None, thr,
                                       ref.SLACK * thr, 0.0, 0.0)

    def device_us(fn) -> tuple[float, dict]:
        prof = device_profile_pure(lambda: [fn() for _ in range(20)],
                                   count="precheck")
        us = (None if prof["device_ms"] is None
              else prof["device_ms"] / 20 * 1e3)
        return us, prof

    def per_call(prof):
        return None if prof.get("counted") is None else prof["counted"] / 20

    us_a, prof_a = device_us(stats)
    us_b, prof_b = device_us(fused)
    return dict(
        kernel_ms=time_ms(fused),
        plain_ms=time_ms(lambda: ops.block_precheck(xb, c, cv, None, thr,
                                                    None, force="ref")),
        op_ms=time_ms(lambda: ops.block_precheck(xb, c, cv, None, thr,
                                                 None)),
        device_us_per_launch=us_b, launches_per_call=per_call(prof_b),
        profile_20_launches=prof_b, bound_ms=b_b, bound_by=by_b,
        library_ms=None,
        stats_route=dict(
            kernel_ms=time_ms(stats),
            plain_ms=time_ms(lambda: ref.center_precheck_matmul(xb, c, cv)),
            op_with_margin_ms=time_ms(lambda: ops.center_precheck(xb, c,
                                                                  cv)),
            device_us_per_launch=us_a,
            launches_per_call=per_call(prof_a),
            profile_20_launches=prof_a, bound_ms=b_a, bound_by=by_a),
        cluster=precheck.last_plan, shape=[B, T, d], valid_centers=tv,
    )


def _time_pdist(rows, what: str) -> dict:
    """K1, its plain version and the library call on (m, d) rows against
    themselves, as ``coreset_distance_matrix`` calls it."""
    import torch
    from repro_torch.kernels import ops, pdist, ref

    m, d = rows.shape

    def library():
        xn = torch.sum(rows * rows, dim=1)
        return torch.addmm(xn[:, None] + xn[None, :], rows, rows.T,
                           alpha=-2.0)

    err = _check_pdist_at(rows, what)
    # x is y: the rows are read once, and the least work is the upper
    # triangle's dots (the sym route), the row norms and its epilogue
    b, by = bound_ms(m * d * rows.element_size() + m * m * 4,
                     m * (m + 1) * d + 2 * m * d + 2 * m * (m + 1))
    return dict(
        max_abs_err=err, route=pdist.last_route, splits=pdist.last_splits,
        kernel_ms=time_ms(lambda: ops.pairwise_sqdist(rows, rows)),
        plain_ms=time_ms(lambda: ref.pairwise_sqdist(rows, rows)),
        library_ms=time_ms(library), bound_ms=b, bound_by=by,
        shape=[m, m, d],
    )


def phase_timing(x_norm, sol, m_slice: int, st) -> dict:
    import torch
    from repro_torch.core import geometry
    from repro_torch.core.gmm import gmm
    from repro_torch.kernels import ops, ref

    # K1 on the main path's own input, the coreset rows of the solve, and
    # at the largest coreset a partition EXTRACT can keep (k * tau rows)
    k1 = _time_pdist(x_norm.index_select(
        0, torch.as_tensor(sol.coreset_indices, device="cuda")),
        "the solve's coreset")
    k1_k_tau = _time_pdist(x_norm[:m_slice].contiguous(), "k*tau rows")
    # K2 on the main path's input: all points, a center, running minima
    n, d = x_norm.shape
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    z = x_norm[int(sol.info["centers"][1])]
    md = ops.gmm_update(x_norm, x_norm[0],
                        torch.full((n,), torch.inf, device="cuda"), valid)[0]
    k2_b, k2_by = bound_ms(n * d * 4 + d * 4 + n * 4 + n + n * 4,
                           3 * n * d + 3 * n)
    k2 = dict(
        kernel_ms=time_ms(lambda: ops.gmm_update(x_norm, z, md, valid)),
        plain_ms=time_ms(lambda: ref.gmm_update(x_norm, z, md, valid)),
        library_ms=None, bound_ms=k2_b, bound_by=k2_by, shape=[n, d],
    )
    # the solve's GMM stage alone (tau launches of K2 and the loop's small
    # ops), and its set-up (the cosine normalisation of the points)
    tau = len(sol.info["centers"])
    loop = dict(
        gmm_loop_ms=time_ms(lambda: gmm(x_norm, valid, tau), warmup=1,
                            reps=5),
        normalize_ms=time_ms(
            lambda: geometry.normalize_for_metric(x_norm, "cosine"),
            warmup=1, reps=5),
        tau=tau,
    )
    # K3 on a block of the stream against the scan's final centers
    k3 = _time_precheck(x_norm, st)
    emit(dict(phase="timing", pdist=k1, pdist_k_tau=k1_k_tau, gmm_step=k2,
              gmm=loop, center_precheck=k3))
    return dict(pdist=k1, gmm_step=k2, center_precheck=k3)


def _check_flash(q, k, v, causal: bool, what: str) -> dict:
    """K4 against its plain version: o within 1e-4 for f32 inputs and 1e-2
    of the largest |o| for bf16 (a bf16 rounding or two), lse within
    1e-4 (both compute in f32)."""
    import torch
    from repro_torch.kernels import ops

    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    o_r, lse_r = ops.flash_attention_fwd(q, k, v, causal=causal,
                                         force="ref")
    torch.cuda.synchronize()
    err = float((o.float() - o_r.float()).abs().max())
    lse_err = float((lse - lse_r).abs().max())
    if q.dtype == torch.float32:
        tol = 1e-4
        ok = bool(torch.allclose(o, o_r, rtol=tol, atol=tol))
    else:
        tol = 1e-2 * float(o_r.float().abs().max())
        ok = bool(torch.allclose(o.float(), o_r.float(), rtol=1e-2,
                                 atol=tol))
    ok = ok and bool(torch.allclose(lse, lse_r, rtol=1e-4, atol=1e-4))
    line = dict(kernel="flash_attention_fwd", what=what,
                shape=[q.shape[0], q.shape[1], k.shape[1], q.shape[2]],
                causal=causal, dtype=str(q.dtype), max_abs_err=err,
                lse_max_abs_err=lse_err, tol=tol, ok=ok)
    check(ok, f"flash {what} {line['shape']} {q.dtype}: max abs err {err}, "
              f"lse {lse_err}")
    return line


def _check_ssd(xbar, loga, B, C, what: str, route: str) -> dict:
    """K6 against its plain version: y and state within 2e-4 of the
    largest |y| (|state|), the tolerance of the reference's SSD tests; and
    the route the launch took."""
    import torch
    from repro_torch.kernels import ops, ssd

    y, s, _, _ = ops.ssd_intra_chunk(xbar, loga, B, C)
    got_route = ssd.last_route
    y_r, s_r, _, _ = ops.ssd_intra_chunk(xbar, loga, B, C, force="ref")
    torch.cuda.synchronize()
    errs, oks = [], []
    for got, want in ((y, y_r), (s, s_r)):
        scale = max(1.0, float(want.abs().max()))
        errs.append(float((got - want).abs().max()))
        oks.append(bool(torch.allclose(got, want, rtol=2e-4,
                                       atol=2e-4 * scale)))
    oks.append(got_route == route)
    line = dict(kernel="ssd_intra_chunk", what=what,
                shape=[*xbar.shape[:-2], *xbar.shape[-2:], B.shape[-1]],
                b_c_shape=list(B.shape), route=got_route,
                max_abs_err=errs[0], state_max_abs_err=errs[1],
                tol_rel_to_max=2e-4, ok=all(oks))
    check(all(oks), f"ssd {what} {line['shape']} ({got_route}, expected "
                    f"{route}): max abs err y {errs[0]}, state {errs[1]}")
    return line


class _OpsWrap:
    """While entered, each ``ops`` function named in NAMES is replaced by
    ``self._wrap(name, fn)`` (the model looks the op up on ``ops`` at
    every call); leaving puts the functions back."""

    NAMES: tuple = ()

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.orig = ops, {}
        for name in self.NAMES:
            self.orig[name] = fn = getattr(ops, name)
            setattr(ops, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        raise NotImplementedError

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


class _Capture(_OpsWrap):
    """Keeps a copy of the inputs of the first call of each named ``ops``
    function while it is entered, of K6's first call at each chunk length
    q (under ``ssd_intra_chunk@q<q>``) and of K4's and K5's first
    non-causal call (under ``flash_attention_fwd@full``,
    ``flash_attention_bwd@full``: a vlm's cross attention); the calls
    themselves go on as usual."""

    NAMES = ("flash_attention_fwd", "flash_attention_bwd", "ssd_intra_chunk",
             "ssd_intra_chunk_bwd")

    def __enter__(self):
        self.args = {}
        return super().__enter__()

    def _wrap(self, name, fn):
        def call(*args, **kw):
            keys = [name]
            if name == "ssd_intra_chunk":
                keys.append(f"{name}@q{args[0].shape[-2]}")
            if name.startswith("flash") and not kw.get("causal", True):
                keys.append(f"{name}@full")
            missing = [key for key in keys if key not in self.args]
            if missing:
                saved = ([a.clone() for a in args], kw)
                for key in missing:
                    self.args[key] = saved
            return fn(*args, **kw)
        return call


class _NonCausal(_OpsWrap):
    """While entered, counts the K4 and K5 launches of the calls made with
    ``causal=False`` (a vlm's cross attention): each such call's share of
    ``ops.launch_counts()``, read just before and just after it, summed
    per op in ``counts``."""

    NAMES = ("flash_attention_fwd", "flash_attention_bwd")

    def __enter__(self):
        self.counts = dict.fromkeys(self.NAMES, 0)
        return super().__enter__()

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if kw.get("causal", True):
                return fn(*args, **kw)
            before = self.ops.launch_counts()[name]
            out = fn(*args, **kw)
            self.counts[name] += self.ops.launch_counts()[name] - before
            return out
        return call


def _first_divergence(tok, tok_r, lg, lg_r, d0: float) -> tuple:
    """Per request: the first step whose greedy token differs between the
    kernel and plain paths. Each must be a near-tie: the plain path's
    top-2 gap at most twice the larger of the prefill's logit difference
    d0 and that step's own. Returns (first step or None, rows equal)."""
    import torch

    first, equal = None, 0
    for b in range(tok.shape[0]):
        diff = (tok[b] != tok_r[b]).nonzero()
        if diff.numel() == 0:
            equal += 1
            continue
        t = int(diff[0])
        top2 = torch.topk(lg_r[b, t].float(), 2).values
        gap = float(top2[0] - top2[1])
        d = max(d0, float((lg[b, t].float() - lg_r[b, t].float()).abs().max()))
        check(gap <= 2 * d, f"request {b}: greedy token differs at step {t} "
                            f"with top-2 gap {gap} > 2 x {d}")
        first = t if first is None else min(first, t)
    return first, equal


def _attn_pairs(sq: int, skv: int, causal: bool) -> int:
    """The (query, key) pairs attention computes: k <= q when causal (the
    model's causal calls have sq == skv), all of them otherwise."""
    return sq * (sq + 1) // 2 if causal else sq * skv


def _time_flash(q, k, v, heads: int = LM_HEADS, causal: bool = True) -> dict:
    """K4, its plain version and SDPA at the captured (BH, S, hd) inputs
    (q's S may differ from k's and v's when not causal)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, ref

    bh, sq, hd = q.shape
    skv = k.shape[1]
    q4 = q.view(bh // heads, heads, sq, hd)
    k4, v4 = (t.view(bh // heads, heads, skv, hd) for t in (k, v))
    esz = q.element_size()
    # q, o and k, v once each, lse written
    nbytes = (2 * sq + 2 * skv) * bh * hd * esz + bh * sq * 4
    flops = 4 * hd * bh * _attn_pairs(sq, skv, causal)  # q.k and p.v
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else TF32_FLOPS_PER_S
    b, by = bound_ms(nbytes, flops, peak)
    res = dict(
        kernel_ms=time_ms(lambda: flash.flash_attention_fwd(q, k, v, causal)),
        route=flash.last_route["fwd"],
        plain_ms=time_ms(lambda: ref.flash_attention_fwd(q, k, v, causal),
                         warmup=1, reps=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal)),
        bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
        shape=[bh, sq, skv, hd], causal=causal, dtype=str(q.dtype))
    return _rates(res)


def _rates(res: dict) -> dict:
    """Adds achieved TFLOP/s (the function's FLOP over the kernel's time)
    and the kernel's time over the library call's."""
    res["tflop_per_s"] = res["flops"] / res["kernel_ms"] / 1e9
    res["kernel_over_library"] = res["kernel_ms"] / res["library_ms"]
    return res


def _time_ssd(xbar, loga, B, C) -> dict:
    """K6 and its plain version at the captured inputs (one layer's cells:
    batch * chunk by head, B and C shared by the heads)."""
    from repro_torch.kernels import ref, ssd

    *lead, q, p = xbar.shape
    n = B.shape[-1]
    cells = lead[0] * lead[1]
    tri = q * (q + 1) // 2
    # B and C shared by the heads: the least work computes the causal
    # C B^T once per (batch, chunk)
    gram_cells = lead[0] if B.shape[1] == C.shape[1] == 1 else cells
    # causal C B^T, (C B^T * L) xbar with the decay mask, the state product
    flops = (gram_cells * tri * 2 * n
             + cells * (tri * (2 * p + 1) + 2 * q * n * p))
    nbytes = 4 * (2 * cells * q * p + cells * q + cells * n * p
                  + 2 * lead[0] * q * n)  # B, C: one copy per (b, chunk)
    b, by = bound_ms(nbytes, flops)
    ssd.ssd_intra_chunk(xbar, loga, B, C)
    return dict(
        route=ssd.last_route,
        kernel_ms=time_ms(lambda: ssd.ssd_intra_chunk(xbar, loga, B, C)),
        plain_ms=time_ms(lambda: ref.ssd_intra_chunk(xbar, loga, B, C),
                         warmup=1, reps=5),
        library_ms=None,
        library_note="no single PyTorch call computes the decay-masked "
                     "C B^T product and the chunk state",
        bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
        shape=[lead[0], lead[1], q, p, n])


def _blockwise_prefill(lm, params, prompts, g) -> dict:
    """The prefill of ``prompts`` block by block on the plain path. Each
    block also runs on the kernel path from the same input: its output
    must agree within LM_LOGIT_TOL of the largest |x|, and the logits
    from the last block's kernel output within LM_LOGIT_TOL of the largest
    |logit|. Beside it, the plain path from an embedding nudged by one
    bf16 step on 1e-4 of its entries: the difference that the model's own
    bf16 sensitivity makes, the noise floor of an end-to-end comparison.
    Returns the last position's plain and nudged logits and the errors."""
    import torch
    from repro_torch.models.model import block_apply_full

    B, S = prompts.shape
    x = params["embed"][prompts]
    hit = torch.rand(x.shape, generator=g, device=x.device) < 1e-4
    xn = torch.where(hit, (x.float() * (1 + 2**-7)).to(x.dtype), x)
    ctx_k = lm.context(params, B, S)
    ctx_r = lm.context(params, B, S, force="ref")
    worst, worst_at = 0.0, None
    for si, i, kind, p in lm.blocks(params):
        yk, _, _ = block_apply_full(kind, p, x, ctx_k, want_cache=False)
        x, _, _ = block_apply_full(kind, p, x, ctx_r, want_cache=False)
        xn, _, _ = block_apply_full(kind, p, xn, ctx_r, want_cache=False)
        err = float((yk.float() - x.float()).abs().max()
                    / x.float().abs().max())
        if err > worst:
            worst, worst_at = err, f"seg{si}[{i}] {kind}"
    lg_k, lg_r, lg_n = (lm.head(params, h[:, -1:])[:, 0].float()
                        for h in (yk, x, xn))
    scale = float(lg_r.abs().max())
    lg_err = float((lg_k - lg_r).abs().max()) / scale
    check(worst <= LM_LOGIT_TOL, f"a block's kernel path is off by {worst} "
                                 f"of max|x| at {worst_at}")
    check(lg_err <= LM_LOGIT_TOL, f"logits from the last block's kernel "
                                  f"output off by {lg_err} of max|logit|")
    return dict(plain=lg_r, nudged=lg_n, block_max_rel_err=worst,
                block_max_rel_err_at=worst_at,
                last_block_logit_max_rel_err=lg_err)


def _f32_prefill(lm, params, prompts) -> dict:
    """The same prefill with the weights upcast to f32 (no bf16 rounding
    between the layers), on the kernel path and on the plain path: the
    last position's logits must agree within LM_LOGIT_TOL of the largest
    |logit|."""
    import dataclasses

    import torch
    from repro_torch.models import LM
    from repro_torch.models.model import tree_map

    lm32 = LM(dataclasses.replace(lm.cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    t0 = time.perf_counter()
    lg = lm32.prefill(p32, prompts)[0]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    lg_r = lm32.prefill(p32, prompts, force="ref")[0]
    del p32
    torch.cuda.empty_cache()
    d = float((lg - lg_r).abs().max())
    scale = float(lg_r.abs().max())
    check(d <= LM_LOGIT_TOL * scale, f"f32 prefill logits differ by {d} > "
                                     f"{LM_LOGIT_TOL} x {scale}")
    return dict(logit_max_abs_diff=d, logit_max_abs=scale,
                logit_max_rel_diff=d / scale, prefill_s=prefill_s)


def phase_lm(seed: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import MatroidSpec, solve_dmmc
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves
    from repro_torch.serve.engine import Engine

    cfg = get_config(LM_ARCH)
    lm = LM(cfg)
    max_len = LM_PROMPT + LM_STEPS
    t0 = time.perf_counter()
    params = lm.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                            device="cuda")

    # (a) kernel checks: test shapes, then one layer's own inputs
    lines = []
    for bh, sq, skv, hd, causal in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(bh, s, hd, generator=g, device="cuda")
                       .to(dtype) for s in (sq, skv, skv))
            lines.append(_check_flash(q, k, v, causal, "test shape"))
    for gg, q, p, n in SSD_SHAPES:
        xb = torch.randn(gg, q, p, generator=g, device="cuda")
        la = -(torch.rand(gg, q, generator=g, device="cuda") * 0.39 + 0.01)
        Bm, Cm = (torch.randn(gg, q, n, generator=g, device="cuda")
                  for _ in range(2))
        lines.append(_check_ssd(xb, la, Bm, Cm, "test shape", "per_cell"))
    for bc, heads, q in SSD_MODEL_SHAPES:
        # the model's layout: a permuted view of (B * chunks, q, H, P), B
        # and C (B * chunks, 1, q, N), broadcast over the heads
        p_, n_ = 64, 64
        xb = torch.randn(bc, q, heads, p_, generator=g,
                         device="cuda").permute(0, 2, 1, 3)
        la = -(torch.rand(bc, q, heads, generator=g, device="cuda") * 0.39
               + 0.01).permute(0, 2, 1)
        Bm, Cm = (torch.randn(bc, 1, q, n_, generator=g, device="cuda")
                  for _ in range(2))
        lines.append(_check_ssd(xb, la, Bm, Cm, "model layout", "shared_bc"))
    with _Capture() as cap:  # also the warm-up of the serving run
        lm.prefill(params, prompts, cache_len=max_len)
    torch.cuda.synchronize()
    fa, fkw = cap.args["flash_attention_fwd"]
    sa, _ = cap.args["ssd_intra_chunk"]
    lines.append(_check_flash(*fa, fkw["causal"], "first attention layer"))
    lines.append(_check_ssd(*sa, "first Mamba2 layer", "shared_bc"))
    emit(dict(phase="lm_kernels", checks=lines))

    # (b) serving: the kernel path, then the plain path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng = Engine(lm, params, max_len)
    tok, lg = eng.generate(prompts, LM_STEPS, return_logits=True)
    torch.cuda.synchronize()
    serve_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    timings = dict(eng.timings)
    supers = lm.plan[0][1]
    check(serve_launches["flash_attention_fwd"] == supers,
          f"K4 launched {serve_launches['flash_attention_fwd']} times in "
          f"generate, expected {supers}")
    check(serve_launches["ssd_intra_chunk"] == cfg.n_layers,
          f"K6 launched {serve_launches['ssd_intra_chunk']} times in "
          f"generate, expected {cfg.n_layers}")
    check(tok.shape == (LM_BATCH, LM_STEPS) and bool(torch.isfinite(lg).all()),
          "generate gave tokens of another shape or non-finite logits")
    eng_r = Engine(lm, params, max_len, force="ref")
    tok_r, lg_r = eng_r.generate(prompts, LM_STEPS, return_logits=True)
    torch.cuda.synchronize()
    check(ops.launch_counts() == serve_launches,
          "the plain path launched a kernel")
    d0 = float((lg[:, 0].float() - lg_r[:, 0].float()).abs().max())
    scale = float(lg_r[:, 0].float().abs().max())
    bw = _blockwise_prefill(lm, params, prompts, g)
    d_loop = float((bw["plain"] - lg_r[:, 0].float()).abs().max())
    d_nudge = float((bw["nudged"] - bw["plain"]).abs().max())
    # end to end: within the tolerance, or within twice the difference
    # that one bf16 step on 1e-4 of the embedding makes on the plain path
    check(d0 <= max(LM_LOGIT_TOL * scale, 2 * d_nudge),
          f"prefill logits differ by {d0}: over {LM_LOGIT_TOL} x {scale} "
          f"and over twice the plain path's noise floor {d_nudge}")
    first, rows_equal = _first_divergence(tok, tok_r, lg, lg_r, d0)
    f32 = _f32_prefill(lm, params, prompts)
    dec_steps = timings["decode_steps"]
    emit(dict(
        phase="lm_serve", arch=LM_ARCH, batch=LM_BATCH, prompt=LM_PROMPT,
        new_tokens=LM_STEPS, max_len=max_len, dtype=cfg.dtype,
        params=lm.param_count(), param_bytes=param_bytes, init_s=init_s,
        prefill_s=timings["prefill_s"],
        prompt_tokens_per_s=LM_BATCH * LM_PROMPT / timings["prefill_s"],
        decode_ms_per_token=timings["decode_s"] / dec_steps * 1e3,
        decode_tokens_per_s=LM_BATCH * dec_steps / timings["decode_s"],
        peak_device_bytes=peak, launches=serve_launches,
        plain=dict(prefill_s=eng_r.timings["prefill_s"],
                   decode_ms_per_token=eng_r.timings["decode_s"]
                   / dec_steps * 1e3),
        prefill_logit_max_abs_diff=d0, prefill_logit_max_abs=scale,
        prefill_logit_max_rel_diff=d0 / scale,
        nudged_plain_logit_max_abs_diff=d_nudge,
        blockwise_plain_vs_engine_plain_max_abs_diff=d_loop,
        blockwise=dict((k, v) for k, v in bw.items()
                       if k not in ("plain", "nudged")),
        f32_prefill=f32,
        requests_with_equal_tokens=rows_equal,
        first_divergent_step=first,
    ))
    del lg, lg_r, eng, eng_r

    # (c) the diverse selection of examples/serving_diverse.py
    torch.cuda.synchronize()
    ops.reset_launches()
    seqs = torch.cat([prompts, tok.long()], dim=1)
    t0 = time.perf_counter()
    with _Capture() as cap_e:  # K6's first call at the embedding's chunk
        hidden, _, _ = lm.forward(params, seqs)
    emb = hidden.mean(dim=1, dtype=torch.float32)
    del hidden
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    ea = [key for key in cap_e.args if key.startswith("ssd_intra_chunk@q")]
    check(len(ea) == 1, f"embedding forward ran K6 at chunk lengths {ea}")
    sa_e, _ = cap_e.args[ea[0]]
    del cap_e
    intents = (np.arange(LM_BATCH) % LM_INTENTS).astype(np.int32)[:, None]
    caps = np.full(LM_INTENTS, LM_CAP, np.int32)
    spec = MatroidSpec("partition", num_categories=LM_INTENTS, gamma=1)
    sol = solve_dmmc(emb, LM_K, spec, cats=intents, caps=caps, tau=LM_TAU,
                     setting="sequential", metric="cosine", device="cuda")
    torch.cuda.synchronize()
    select_launches = ops.launch_counts()
    check(bool(torch.isfinite(emb).all()) and emb.shape == (
        LM_BATCH, cfg.vocab_padded), "embeddings of another shape or "
                                     "non-finite")
    check(select_launches["flash_attention_fwd"] == supers
          and select_launches["ssd_intra_chunk"] == cfg.n_layers,
          f"embedding forward launched {select_launches}")
    check(select_launches["gmm_update"] == LM_TAU
          and select_launches["pairwise_sqdist"] >= 1,
          f"selection launched {select_launches}")
    counts = np.bincount(intents[sol.indices, 0], minlength=LM_INTENTS)
    check(len(sol.indices) == LM_K and counts.max() <= LM_CAP,
          f"selection {sol.indices} breaks the caps ({counts})")
    check(np.isfinite(sol.diversity) and sol.diversity > 0,
          f"diversity {sol.diversity}")
    ref_sol = solve_dmmc(emb, LM_K, spec, cats=intents, caps=caps,
                         tau=LM_TAU, setting="sequential", metric="cosine",
                         force="ref", device="cuda")
    emit(dict(phase="lm_select", embed_forward_s=embed_s,
              seq_len=seqs.shape[1], selected=sorted(sol.indices.tolist()),
              intent_counts=counts.tolist(), diversity=sol.diversity,
              solve_s=sol.timings["total_s"], launches=select_launches,
              plain_selected=sorted(ref_sol.indices.tolist()),
              same_selection_as_plain=bool(np.array_equal(
                  np.sort(sol.indices), np.sort(ref_sol.indices)))))

    # (d) where a prefill's and a decode step's time goes (profiled), and
    # K4 and K6 at the slice's inputs
    del emb, seqs
    _, caches = lm.prefill(params, prompts, cache_len=max_len)
    prof_prefill = device_profile(
        lambda: lm.prefill(params, prompts, cache_len=max_len))
    prof_decode = device_profile(
        lambda: lm.decode_step(params, tok[:, :1], caches, LM_PROMPT))
    del caches
    k4 = _time_flash(*fa)
    k6 = _time_ssd(*sa)
    k6_e_line = _check_ssd(*sa_e, "first Mamba2 layer of the embedding "
                                  "forward", "shared_bc")
    k6_e = _time_ssd(*sa_e)
    emit(dict(phase="lm_timing", profiled_prefill=prof_prefill,
              profiled_decode_step=prof_decode, flash_attention_fwd=k4,
              ssd_intra_chunk=k6, ssd_intra_chunk_embedding=k6_e,
              ssd_embedding_check=k6_e_line))
    lm_launches = {name: serve_launches[name] + select_launches[name]
                   for name in serve_launches}
    return dict(launches=lm_launches, k4=k4, k6=k6, k6_e=k6_e,
                k6_e_launches=select_launches["ssd_intra_chunk"],
                k4_err=lines[-2]["max_abs_err"], k6_err=lines[-1]["max_abs_err"],
                k6_e_err=k6_e_line["max_abs_err"])


def _check_flash_bwd(q, k, v, o, lse, do, causal: bool, what: str) -> dict:
    """K5 against its plain version: dq, dk and dv within 1e-4 (f32) or
    1e-2 (bf16: a rounding or two of the output) of each gradient's
    largest |value| (a model's gradients are ~1e-7 and smaller)."""
    import torch
    from repro_torch.kernels import ops

    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   force="ref")
    torch.cuda.synchronize()
    tol = 1e-4 if q.dtype == torch.float32 else 1e-2
    errs, rels, ok = [], [], True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        errs.append(float((g - w).abs().max()))
        rels.append(errs[-1] / scale if scale else errs[-1])
        ok = ok and rels[-1] <= tol
    line = dict(kernel="flash_attention_bwd", what=what,
                shape=[q.shape[0], q.shape[1], k.shape[1], q.shape[2]],
                causal=causal, dtype=str(q.dtype), max_abs_err=max(errs),
                dq_dk_dv_max_abs_err=errs, dq_dk_dv_err_rel_to_max=rels,
                tol_rel_to_max=tol, ok=ok)
    check(ok, f"flash bwd {what} {line['shape']} {q.dtype}: errors {rels} "
              f"of the largest |gradient|")
    return line


def _fresh_state(params, opt_cfg):
    import torch
    from repro_torch.models.model import tree_map
    from repro_torch.train import adamw_init

    p = tree_map(lambda t: t.detach().clone(), params)
    return {"params": p, "opt": adamw_init(p, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device="cuda")}


def _clone_state(state):
    from repro_torch.models.model import tree_map

    return tree_map(lambda t: t.clone(), state)


def _run_steps(lm, params, batches, opt_cfg, force=None) -> list:
    """The slice's steps from a copy of ``params`` on ``batches``; the
    per-step losses."""
    from repro_torch.train import make_train_step

    state = _fresh_state(params, opt_cfg)
    step = make_train_step(lm, opt_cfg, force=force)
    losses = []
    for b in batches:
        state, m = step(state, {"tokens": b})
        losses.append(m["loss"])
    return [float(x) for x in losses]


def _state_diff(a, b) -> tuple[float, list]:
    """Largest |a - b| over the leaves of two states, and the paths of the
    leaves that differ."""
    from repro_torch.train.checkpoint import _paths

    worst, paths = 0.0, []
    for (key, x), (_, y) in zip(_paths(a), _paths(b)):
        if not bool((x == y).all()):
            paths.append(key)
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return worst, paths


def _train_f32_check(lm, params, tokens) -> dict:
    """The config in f32 (weights upcast): the loss and every gradient leaf
    of one step on the kernel path against the plain path."""
    import dataclasses

    import torch
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves, tree_map

    lm32 = LM(dataclasses.replace(lm.cfg, dtype="float32"))
    out = {}
    for force in (None, "ref"):
        p32 = tree_map(lambda t: t.detach().float().requires_grad_(True),
                       params)
        loss, _ = lm32.loss(p32, tokens, force=force)
        grads = torch.autograd.grad(loss, tree_leaves(p32))
        out[force] = (float(loss.detach()), grads)
        del p32, loss
    (lk, gk), (lr, gr) = out[None], out["ref"]
    loss_rel = abs(lk - lr) / abs(lr)
    grad_rel = max(float((a - b).norm() / (b.norm() + 1e-30))
                   for a, b in zip(gk, gr))
    del out, gk, gr
    torch.cuda.empty_cache()
    check(loss_rel <= TRAIN_F32_LOSS_TOL,
          f"f32 step-0 loss differs by {loss_rel} relative")
    check(grad_rel <= TRAIN_F32_GRAD_TOL,
          f"an f32 gradient leaf differs by {grad_rel} relative L2")
    return dict(loss=lk, loss_plain=lr, loss_rel_diff=loss_rel,
                grad_max_rel_l2_diff=grad_rel)


def _train_cli(seed: int, exact: bool, spread: float) -> dict:
    """``launch.train.main`` in process: an uninterrupted run of
    TRAIN_CLI_STEPS steps; the same run sent SIGTERM after step
    TRAIN_PREEMPT_AT (it must checkpoint and return); the same command
    again, which must resume there. Its losses and final checkpoint must
    equal the uninterrupted run's bit for bit (or within ``spread`` where
    a repeated step was not bit-identical)."""
    import os
    import shutil
    import signal

    import numpy as np
    from repro_torch.launch import train as launch_train
    from repro_torch.train import CheckpointManager

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_CLI_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt-every", "100", "--log-every", "1", "--seed", str(seed)]

    def preempt(step: int) -> None:
        if step == TRAIN_PREEMPT_AT:
            os.kill(os.getpid(), signal.SIGTERM)

    t0 = time.perf_counter()
    full = launch_train.main(argv + ["--ckpt-dir", str(root / "a")])
    full_s = time.perf_counter() - t0
    first = launch_train.main(argv + ["--ckpt-dir", str(root / "b")],
                              after_step=preempt)
    saved = CheckpointManager(str(root / "b")).all_steps()
    check(saved == [TRAIN_PREEMPT_AT] and len(first) == TRAIN_PREEMPT_AT,
          f"preempted run: checkpoints {saved}, {len(first)} steps")
    rest = launch_train.main(argv + ["--ckpt-dir", str(root / "b")])
    check(len(rest) == TRAIN_CLI_STEPS - TRAIN_PREEMPT_AT,
          f"resumed run took {len(rest)} steps")
    loss_diff = max(abs(a - b) for a, b in zip(first + rest, full))
    arr_diff = 0.0
    final = f"step_{TRAIN_CLI_STEPS:010d}/arrays.npz"
    with np.load(root / "a" / final) as za, np.load(root / "b" / final) as zb:
        check(sorted(za.files) == sorted(zb.files), "checkpoint keys differ")
        for key in za.files:
            a, b = za[key], zb[key]
            if a.dtype == np.uint16:  # bf16 bits
                a, b = (x.astype(np.uint32) << 16 for x in (a, b))
                a, b = a.view(np.float32), b.view(np.float32)
            arr_diff = max(arr_diff, float(np.max(np.abs(
                a.astype(np.float64) - b.astype(np.float64)), initial=0.0)))
    shutil.rmtree(root, ignore_errors=True)
    if exact:
        check(loss_diff == 0.0 and arr_diff == 0.0,
              f"resumed run differs from the uninterrupted one: losses by "
              f"{loss_diff}, checkpoint by {arr_diff}")
    else:
        check(arr_diff <= spread, f"resumed run's checkpoint differs by "
                                  f"{arr_diff} > the repeat spread {spread}")
    check(all(np.isfinite(full)), f"non-finite CLI losses {full}")
    return dict(steps=TRAIN_CLI_STEPS, preempted_at=TRAIN_PREEMPT_AT,
                losses=full, resumed_losses=rest,
                loss_max_abs_diff=loss_diff,
                checkpoint_max_abs_diff=arr_diff,
                uninterrupted_run_s=full_s)


def _time_flash_bwd(q, k, v, o, lse, do, heads: int,
                    causal: bool = True) -> dict:
    """K5, its plain version and the backward alone of SDPA at one layer's
    captured (BH, S, hd) inputs (q's S may differ from k's and v's when
    not causal)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, ref

    bh, sq, hd = q.shape
    skv = k.shape[1]
    esz = q.element_size()
    # q, o, do read and dq written; k, v read and dk, dv written; lse read
    nbytes = (4 * sq + 4 * skv) * bh * hd * esz + bh * sq * 4
    # S, dP, dv, dq, dk: five products over the attended pairs
    flops = 5 * 2 * hd * bh * _attn_pairs(sq, skv, causal)
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else TF32_FLOPS_PER_S
    b, by = bound_ms(nbytes, flops, peak)
    q4 = q.view(bh // heads, heads, sq, hd).detach().requires_grad_(True)
    k4, v4 = (t.view(bh // heads, heads, skv, hd).detach()
              .requires_grad_(True) for t in (k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    do4 = do.view(bh // heads, heads, sq, hd)
    res = dict(
        kernel_ms=time_ms(lambda: flash.flash_attention_bwd(
            q, k, v, o, lse, do, causal)),
        route=flash.last_route["bwd"],
        plain_ms=time_ms(lambda: ref.flash_attention_bwd(
            q, k, v, o, lse, do, causal), warmup=1, reps=5),
        library_ms=time_ms(lambda: torch.autograd.grad(
            out, (q4, k4, v4), do4, retain_graph=True)),
        library_note=f"the backward alone of scaled_dot_product_attention("
                     f"is_causal={causal}): autograd.grad after one forward",
        bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
        shape=[bh, sq, skv, hd], causal=causal, dtype=str(q.dtype))
    del out
    return _rates(res)


def phase_train(seed: int) -> dict:
    import statistics as st

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.train import AdamWConfig, make_train_step

    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the driver's optimizer rule (launch/train.py) for a run of this length
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS,
                          warmup_steps=min(100, TRAIN_STEPS // 10 + 1))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)

    # (a) K5 at test shapes, then at one layer's own inputs, captured from a
    # backward of the slice (the last layer's, the first in the backward)
    lines = []
    for bh, sq, skv, hd, causal in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(bh, n, hd, generator=g, device="cuda")
                       .to(dtype) for n in (sq, skv, skv))
            o, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                             force="ref")
            do = torch.randn(bh, sq, hd, generator=g, device="cuda").to(dtype)
            lines.append(_check_flash_bwd(q, k, v, o, lse, do, causal,
                                          "test shape"))
    pipe = Pipeline(data_cfg)
    warm = pipe.batch_at(0)["tokens"]
    with _Capture() as cap:  # also the warm-up of the training run
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = lm.loss(live, warm)
        torch.autograd.grad(loss, tree_leaves(live))
        del live, loss
    torch.cuda.synchronize()
    fa, fkw = cap.args["flash_attention_fwd"]
    ba, bkw = cap.args["flash_attention_bwd"]
    lines.append(_check_flash_bwd(*ba, bkw["causal"],
                                  "a layer's backward (the last layer)"))
    k5_err = lines[-1]["max_abs_err"]
    lines.append(_check_flash(*fa, fkw["causal"],
                              "a training layer's forward (the first)"))
    emit(dict(phase="train_kernels", checks=lines))

    # (b) five steps on the kernel path, launch counts read around them
    # (the data selection included), then the same batches on the plain path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state = _fresh_state(params, opt_cfg)
    step = make_train_step(lm, opt_cfg)
    picked, losses = [], []
    for i in range(TRAIN_STEPS):
        picked.append(pipe.batch_at(i))
        state, m = step(state, {"tokens": picked[-1]["tokens"]})
        losses.append(m["loss"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    run_peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    tau = data_cfg.selector_tau
    want = dict(gmm_update=TRAIN_STEPS * tau,
                flash_attention_fwd=TRAIN_STEPS * 2 * cfg.n_layers,
                flash_attention_bwd=TRAIN_STEPS * cfg.n_layers,
                pairwise_sqdist=0, center_precheck=0, ssd_intra_chunk=0,
                ssd_intra_chunk_bwd=0)
    check(launches == want, f"train launches {launches}, expected {want}")
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    # the selection on plain GMM picks the same sequences (K2 at the
    # pipeline's own shape)
    pipe_r = Pipeline(data_cfg, force="ref")
    for i, b in enumerate(picked):
        b_r = pipe_r.batch_at(i)
        check(torch.equal(b["tokens"], b_r["tokens"])
              and torch.equal(b["domains"], b_r["domains"]),
              f"step {i}: the batch differs from the plain selection's")
    batches = [b["tokens"] for b in picked]
    losses_r = _run_steps(lm, params, batches, opt_cfg, force="ref")
    check(ops.launch_counts() == launches, "the plain path launched a kernel")
    hit = torch.rand(params["embed"].shape, generator=g, device="cuda") < 1e-4
    nudged = dict(params, embed=torch.where(
        hit, (params["embed"].float() * (1 + 2**-7)).to(torch.bfloat16),
        params["embed"]))
    losses_n = _run_steps(lm, nudged, batches, opt_cfg, force="ref")
    del nudged, hit
    # bf16: step 0 differs only by the forward's roundings, and within
    # twice what the nudge moves; each later step adds one step's rounding
    # differences (Adam's normalised update turns them into lr-sized
    # moves), so step i may differ by 2 (i + 1) times the largest nudge
    # difference so far
    diffs = [abs(a - b) for a, b in zip(losses, losses_r)]
    floors = [abs(a - b) for a, b in zip(losses_n, losses_r)]
    limits = [2 * (i + 1) * max(floors[:i + 1]) for i in range(len(diffs))]
    for i, (d, lim) in enumerate(zip(diffs, limits)):
        check(d <= lim, f"step {i}: kernel and plain losses differ by {d}, "
                        f"over 2 x {i + 1} x the nudge's {lim / 2 / (i + 1)}")
    # a repeated step from one state: is the step deterministic?
    s1, s2 = _clone_state(state), _clone_state(state)
    s1, m1 = step(s1, {"tokens": batches[0]})
    s2, m2 = step(s2, {"tokens": batches[0]})
    spread, differing = _state_diff(s1, s2)
    exact = not differing and float(m1["loss"]) == float(m2["loss"])
    del s1, s2
    f32 = _train_f32_check(lm, params, batches[0])
    emit(dict(phase="train_steps", arch=TRAIN_ARCH, batch=TRAIN_BATCH,
              seq=TRAIN_SEQ, steps=TRAIN_STEPS, params=lm.param_count(),
              init_s=init_s, run_s=run_s, launches=launches,
              run_peak_device_bytes=run_peak, losses=losses,
              plain_losses=losses_r, nudged_plain_losses=losses_n,
              loss_abs_diffs=diffs, nudge_abs_diffs=floors,
              loss_abs_diff_limits=limits, same_batches_as_plain=True,
              repeat_step_bit_identical=exact,
              repeat_step_max_abs_diff=spread,
              repeat_step_differing_leaves=differing, f32=f32))

    # (c) the CLI: preempted, resumed, equal to the uninterrupted run
    cli = _train_cli(seed, exact, spread)
    emit(dict(phase="train_cli", **cli))

    # (d) where a step's time goes: step time (selection included), peak
    # memory, one step under the profiler, K5 (and K4) at the slice's inputs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_times, data_times = [], []
    for i in range(TRAIN_STEPS, TRAIN_STEPS + 3):
        t0 = time.perf_counter()
        tok = pipe.batch_at(i)["tokens"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, {"tokens": tok})
        float(m["loss"])
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        data_times.append(t1 - t0)
    peak = torch.cuda.max_memory_allocated()
    step_s = st.median(step_times)
    prof = device_profile(lambda: step(state, {"tokens": pipe.batch_at(
        TRAIN_STEPS + 3)["tokens"]}))
    heads = cfg.n_heads
    k5 = _time_flash_bwd(*ba, heads)
    k4 = _time_flash(*fa, heads=heads)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit(dict(phase="train_timing", step_s=step_s, step_times_s=step_times,
              data_select_s=st.median(data_times),
              tokens_per_s=tokens / step_s, peak_device_bytes=peak,
              profiled_step=prof, flash_attention_bwd=k5,
              flash_attention_fwd_train_shape=k4))
    del state, params
    torch.cuda.empty_cache()
    return dict(launches=launches, k5=k5, k5_err=k5_err, step_s=step_s,
                peak=peak)


def _on_positions(state, specs, n: int):
    """A copy of ``state`` placed on an in-process ("data",) mesh of ``n``
    positions of the card, and the mesh."""
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as sh

    mesh = make_mesh((n,), ("data",), devices=["cuda"] * n)
    return sh.shard_tree(state, specs, mesh, donate=True), mesh


def _rel_leaves(a, b) -> dict:
    """Each leaf's relative L2 difference of two trees of one structure
    (``a`` gathered where it is sharded), by path; 0-d leaves left out."""
    from repro_torch.models import sharding as sh
    from repro_torch.train.checkpoint import _paths

    if isinstance(a, sh.ShardedTree):
        a = sh.gather_tree(a)
    return {k: float((x.double() - y.double()).norm()
                     / (y.double().norm() + 1e-30))
            for (k, x), (_, y) in zip(_paths(a), _paths(b)) if x.dim()}


def _leaves_rel(sharded, plain, part: str) -> tuple[float, str]:
    """The largest relative L2 difference over the leaves of ``part``
    ("params", or "opt" for the moments: after a first step, m is 0.1 x
    the clipped gradient) of a sharded state (gathered) and an unsharded
    one, and that leaf's path."""
    rels = _rel_leaves(sharded[part], plain[part])
    worst = max(rels, key=rels.get)
    return rels[worst], worst


def _step_synced(step, state, batch) -> tuple:
    """One step with the card synced before and after: (state, loss,
    seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    return state, loss, time.perf_counter() - t0


def _f32_pair(what: str, loss, loss_plain, sharded=None,
              plain=None) -> dict:
    """The f32 rule: the loss within TRAIN_F32_LOSS_TOL; given the two
    states, every parameter leaf and every moment leaf within
    TRAIN_F32_GRAD_TOL relative L2 (the worst of each printed, with its
    leaf)."""
    loss_rel = abs(loss - loss_plain) / abs(loss_plain)
    check(loss_rel <= TRAIN_F32_LOSS_TOL,
          f"{what}: sharded and unsharded f32 losses differ by {loss_rel} "
          f"relative")
    out = dict(loss=loss, loss_unsharded=loss_plain, loss_rel_diff=loss_rel)
    for part in ("params", "opt") if sharded is not None else ():
        rel, leaf = _leaves_rel(sharded, plain, part)
        check(rel <= TRAIN_F32_GRAD_TOL,
              f"{what}: leaf {part}/{leaf} differs by {rel} relative L2")
        out[f"{part}_max_rel_l2_diff"] = rel
        out[f"{part}_worst_leaf"] = leaf
    return out


def phase_train_sharded(seed: int) -> dict:
    """Training sharded over a data axis (FSDP) on in-process positions of
    the one card, against the unsharded step (see the module's list)."""
    import dataclasses
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import make_mesh
    from repro_torch.models import LM
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import tree_map
    from repro_torch.train import (
        AdamWConfig, CheckpointManager, abstract_train_state,
        make_train_step,
    )
    from repro_torch.train.train_state import state_specs

    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg)
    params = lm.init(seed, device="cuda")
    opt_cfg = AdamWConfig(total_steps=SHARD_STEPS,
                          warmup_steps=min(100, SHARD_STEPS // 10 + 1))
    specs = state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                       tp=None), opt_cfg)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=seed)
    pipe = Pipeline(data_cfg)
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    # (a) the main path: 3 steps on 4 positions, the selection inside
    state, mesh = _on_positions(_fresh_state(params, opt_cfg), specs,
                                SHARD_POSITIONS)
    step = make_train_step(lm, opt_cfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    batches, losses, times = [], [], []
    for i in range(SHARD_STEPS):
        batches.append(pipe.batch_at(i)["tokens"])
        state, loss, dt = _step_synced(step, state,
                                       {"tokens": batches[-1]})
        losses.append(loss)
        times.append(dt)
    launches = ops.launch_counts()
    arms = dict(smollm=launches)
    peak = torch.cuda.max_memory_allocated()
    del state, step
    want = dict(gmm_update=SHARD_STEPS * data_cfg.selector_tau,
                flash_attention_fwd=SHARD_STEPS * SHARD_POSITIONS * 2
                * cfg.n_layers,
                flash_attention_bwd=SHARD_STEPS * SHARD_POSITIONS
                * cfg.n_layers,
                pairwise_sqdist=0, center_precheck=0, ssd_intra_chunk=0,
                ssd_intra_chunk_bwd=0)
    check(launches == want, f"train_sharded launches {launches}, "
                            f"expected {want}")
    # the unsharded arm on the same batches, and its nudged runs
    torch.cuda.reset_peak_memory_stats()
    plain = _fresh_state(params, opt_cfg)
    step = make_train_step(lm, opt_cfg)
    ops.reset_launches()
    plain_losses, plain_times = [], []
    for b in batches:
        plain, loss, dt = _step_synced(step, plain, {"tokens": b})
        plain_losses.append(loss)
        plain_times.append(dt)
    plain_launches = ops.launch_counts()
    plain_peak = torch.cuda.max_memory_allocated()
    del plain
    nudged = [_run_steps(lm, _nudged(params, g), batches, opt_cfg)
              for _ in range(SHARD_NUDGES)]
    diffs, floors, limits = _loss_rule(losses, plain_losses, nudged)
    check(all(map(math.isfinite, losses)), f"non-finite {losses}")
    abstract = abstract_train_state(lm, opt_cfg)
    one = make_mesh((1,), ("data",), devices=["cuda"])
    share = {key: dict(
        whole_bytes=sh.local_bytes(abstract[key], specs[key], one),
        position_bytes=sh.local_bytes(abstract[key], specs[key], mesh))
        for key in ("params", "opt")}
    emit(dict(phase="train_sharded_mesh", positions=SHARD_POSITIONS,
              devices=[str(d) for d in mesh.devices],
              note="every position sits on the one card and they run in "
                   "turn: the peak is not FSDP's saving, each "
                   "position's bytes below are",
              bytes_per_position=share))
    emit(dict(phase="train_sharded_steps", arch=TRAIN_ARCH,
              batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=SHARD_STEPS,
              positions=SHARD_POSITIONS, launches=launches,
              unsharded_launches=plain_launches, losses=losses,
              unsharded_losses=plain_losses,
              nudged_unsharded_losses=nudged, loss_abs_diffs=diffs,
              nudge_abs_diffs=floors, loss_abs_diff_limits=limits,
              step_s=statistics.median(times), step_times_s=times,
              unsharded_step_s=statistics.median(plain_times),
              unsharded_step_times_s=plain_times,
              peak_device_bytes=peak,
              unsharded_peak_device_bytes=plain_peak))

    # (b) f32 at 4 x 1,024: a step on 4 positions against unsharded,
    # then a second, a checkpoint restored onto 2, a third
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.detach().float(), params)
    toks = [b[:SHARD_F32_BATCH, :SHARD_F32_SEQ].contiguous()
            for b in batches]
    plain = _fresh_state(p32, opt_cfg)
    pstep = make_train_step(lm32, opt_cfg)
    state, m4 = _on_positions(_fresh_state(p32, opt_cfg), specs,
                              SHARD_POSITIONS)
    del p32
    sstep = make_train_step(lm32, opt_cfg, mesh=m4)
    pl, sl = [], []
    f32_launches = {}
    for i in range(2):
        plain, loss, _dt = _step_synced(pstep, plain,
                                        {"tokens": toks[i]})
        pl.append(loss)
        ops.reset_launches()
        state, loss, _dt = _step_synced(sstep, state,
                                        {"tokens": toks[i]})
        f32_launches = _add_counts(f32_launches, ops.launch_counts())
        sl.append(loss)
        if i == 0:
            first = _f32_pair("f32 step", sl[0], pl[0], state, plain)
    root = Path(__file__).resolve().parent / "build" / \
        "chip_smoke_ckpt_sharded"
    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(str(root))
    t0 = time.perf_counter()
    mgr.save(2, state)
    mgr.wait()
    save_s = time.perf_counter() - t0
    del state
    t0 = time.perf_counter()
    m2 = make_mesh((SHARD_RESTORE_ONTO,), ("data",),
                   devices=["cuda"] * SHARD_RESTORE_ONTO)
    state = mgr.restore(2, abstract_train_state(lm32, opt_cfg), mesh=m2,
                        specs=specs)
    restore_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    ops.reset_launches()
    state, loss, _dt = _step_synced(
        make_train_step(lm32, opt_cfg, mesh=m2), state,
        {"tokens": toks[2]})
    f32_launches = _add_counts(f32_launches, ops.launch_counts())
    arms["f32"] = f32_launches
    sl.append(loss)
    plain, loss, _dt = _step_synced(pstep, plain, {"tokens": toks[2]})
    pl.append(loss)
    elastic = _f32_pair("elastic restore", sl[-1], pl[-1], state,
                        plain)
    for i in range(len(sl)):
        _f32_pair(f"f32 step {i}", sl[i], pl[i])
    del state, plain
    emit(dict(phase="train_sharded_f32", batch=SHARD_F32_BATCH,
              seq=SHARD_F32_SEQ, positions=SHARD_POSITIONS,
              first_step=first, restored_onto=SHARD_RESTORE_ONTO,
              losses=sl, unsharded_losses=pl, elastic=elastic,
              launches=f32_launches,
              save_s=save_s, restore_s=restore_s))
    del params
    torch.cuda.empty_cache()

    # (c) zamba2-7b at full width, one super block, f32, 2 positions
    cfg_h = dataclasses.replace(get_config(HYBRID_ARCH),
                                n_layers=SHARD_HYBRID_LAYERS,
                                dtype="float32")
    lm_h = LM(cfg_h)
    specs_h = state_specs(sh.param_specs(lm_h.abstract_params(),
                                         ("data",), tp=None), opt_cfg)
    tok_h = torch.randint(0, cfg_h.vocab, (SHARD_HYBRID_BATCH,
                                           SHARD_HYBRID_SEQ),
                          generator=g, device="cuda")
    p_h = lm_h.init(seed, device="cuda")
    plain = _fresh_state(p_h, opt_cfg)
    pstep = make_train_step(lm_h, opt_cfg)
    plain, loss_p, _dt = _step_synced(pstep, plain, {"tokens": tok_h})
    state, mh = _on_positions(_fresh_state(p_h, opt_cfg), specs_h,
                              SHARD_HYBRID_POSITIONS)
    del p_h
    sstep = make_train_step(lm_h, opt_cfg, mesh=mh)
    ops.reset_launches()
    state, loss_s, _dt = _step_synced(sstep, state, {"tokens": tok_h})
    hybrid_launches = ops.launch_counts()
    arms["zamba2"] = hybrid_launches
    hybrid = _f32_pair("zamba2-7b f32 step", loss_s, loss_p, state,
                       plain)
    # warm step times, the arms alternating: the median of a few each
    plain_times, times = [], []
    for _ in range(SHARD_HYBRID_TIMED):
        plain, _loss, dt = _step_synced(pstep, plain, {"tokens": tok_h})
        plain_times.append(dt)
        state, _loss, dt = _step_synced(sstep, state, {"tokens": tok_h})
        times.append(dt)
    del state, plain, pstep, sstep
    supers = SHARD_HYBRID_LAYERS // cfg_h.shared_attn_every
    check(hybrid_launches["ssd_intra_chunk_bwd"] > 0
          and hybrid_launches["flash_attention_bwd"] == supers
          * SHARD_HYBRID_POSITIONS,
          f"zamba2-7b sharded launches {hybrid_launches}")
    emit(dict(phase="train_sharded_hybrid", arch=HYBRID_ARCH,
              layers=SHARD_HYBRID_LAYERS, params=lm_h.param_count(),
              batch=SHARD_HYBRID_BATCH, seq=SHARD_HYBRID_SEQ,
              positions=SHARD_HYBRID_POSITIONS, launches=hybrid_launches,
              step_s=statistics.median(times), step_times_s=times,
              unsharded_step_s=statistics.median(plain_times),
              unsharded_step_times_s=plain_times, **hybrid))
    n_cards = torch.cuda.device_count()
    emit(dict(phase="train_sharded_nccl", ran=False,
              why=(f"{n_cards} card: NCCL takes no two ranks on one GPU"
                   if n_cards < 2 else
                   f"{n_cards} cards: this script drives one card; the "
                   f"multi-rank run is held across gloo ranks on the CPU"),
              cards=n_cards))
    torch.cuda.empty_cache()
    # the column: every sharded step of the phase, each arm counted from
    # its own reset (the unsharded arms and the kernel checks excluded)
    total = {}
    for counts in arms.values():
        total = _add_counts(total, counts)
    emit(dict(phase="train_sharded_launches", arms=arms, total=total))
    return dict(launches=total)


class _HeadRows(_OpsWrap):
    """While entered, the rows (B x heads, the first dim of q) of every K4
    and K5 call, per op, and a copy of the inputs of each op's first call
    (``args[name]``, as ``_Capture`` keeps them)."""

    NAMES = ("flash_attention_fwd", "flash_attention_bwd")

    def __enter__(self):
        self.rows = {name: set() for name in self.NAMES}
        self.args = {}
        return super().__enter__()

    def _wrap(self, name, fn):
        def call(q, *args, **kw):
            self.rows[name].add(int(q.shape[0]))
            if name not in self.args:
                self.args[name] = ([a.clone() for a in (q, *args)], kw)
            return fn(q, *args, **kw)
        return call


def _tp_kernel_checks(hr: _HeadRows, what: str) -> list:
    """K4 and K5 against their plain versions on the inputs of their first
    calls on a position's own heads in a tensor-parallel step (K4: the
    first layer's forward; K5: the last layer's backward), at the
    ``train`` phase's tolerances. Called after the step's launches are
    read, so these launches count on no path."""
    fa, fkw = hr.args["flash_attention_fwd"]
    ba, bkw = hr.args["flash_attention_bwd"]
    return [_check_flash(*fa, fkw["causal"],
                         f"{what}: a position's heads, the first layer's "
                         f"forward"),
            _check_flash_bwd(*ba, bkw["causal"],
                             f"{what}: a position's heads, the last "
                             f"layer's backward")]


def _tp_place(lm, params, opt_cfg, shape):
    """A fresh state from ``params`` placed by the tensor-parallel specs on
    an in-process ("data", "model") mesh of ``shape`` positions of the
    card, and the mesh."""
    import math as _m

    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.train.train_state import state_specs

    mesh = make_mesh(shape, ("data", "model"),
                     devices=["cuda"] * _m.prod(shape))
    specs = state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                       tp="model"), opt_cfg)
    return sh.shard_tree(_fresh_state(params, opt_cfg), specs, mesh,
                         donate=True), mesh


def _tp_dry(lm, shape, batch: int, seq: int) -> dict:
    """The dry run's count of one tensor-parallel step's collective bytes
    a position, by kind: the data axis's and the model axis's."""
    from repro_torch.launch import dryrun
    from repro_torch.train.train_state import StepConfig

    want = dict(dryrun.fsdp_collectives(lm, StepConfig(), shape[0], batch,
                                        tp=shape[1]))
    want.update(dryrun.tp_collectives(lm, StepConfig(), shape[0], shape[1],
                                      (batch, seq)))
    return want


def _tp_step_counted(step, state, batch) -> tuple:
    """One synced step with the collective counters cleared before it:
    (state, loss, seconds, collective bytes by kind)."""
    from repro_torch.launch.mesh import collective_bytes, \
        reset_collective_bytes

    reset_collective_bytes()
    state, loss, dt = _step_synced(step, state, batch)
    return state, loss, dt, collective_bytes()


def _tp_launch_rule(what: str, launches, plain, n_pos: int,
                    rows, plain_rows) -> None:
    """K4 and K5 launch ``n_pos`` times as often as on the unsharded step,
    each call on 1/n_pos of its rows (B x heads)."""
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        check(launches[name] == n_pos * plain[name] > 0,
              f"{what}: {name} launched {launches[name]} times, expected "
              f"{n_pos} x the unsharded {plain[name]}")
        (full,) = plain_rows[name]
        check(rows[name] == {full // n_pos},
              f"{what}: {name} ran on rows {sorted(rows[name])}, expected "
              f"{full // n_pos} (the unsharded {full} / {n_pos})")


def phase_train_tp(seed: int) -> dict:
    """Tensor-parallel training on in-process ("data", "model") meshes of
    the one card, against the unsharded step (see the module's list)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_map
    from repro_torch.train import AdamWConfig, make_train_step

    n_pos = TP_MESH[0] * TP_MESH[1]
    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg)
    params = lm.init(seed, device="cuda")
    opt_cfg = AdamWConfig(total_steps=TP_STEPS,
                          warmup_steps=min(100, TP_STEPS // 10 + 1))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=seed)
    pipe = Pipeline(data_cfg)
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    # (a) the main path: smollm-135m on (2, 3), the selection inside
    state, mesh = _tp_place(lm, params, opt_cfg, TP_MESH)
    step = make_train_step(lm, opt_cfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    batches, losses, times, colls = [], [], [], None
    with _HeadRows() as hr:
        for i in range(TP_STEPS):
            batches.append(pipe.batch_at(i)["tokens"])
            state, loss, dt, c = _tp_step_counted(step, state,
                                                  {"tokens": batches[-1]})
            if i == 0:
                colls = c
            losses.append(loss)
            times.append(dt)
    launches = ops.launch_counts()
    arms = dict(smollm=launches)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain = _fresh_state(params, opt_cfg)
    pstep = make_train_step(lm, opt_cfg)
    ops.reset_launches()
    plain_losses, plain_times = [], []
    with _HeadRows() as hr_plain:
        for b in batches:
            plain, loss, dt = _step_synced(pstep, plain, {"tokens": b})
            plain_losses.append(loss)
            plain_times.append(dt)
    plain_launches = ops.launch_counts()
    plain_peak = torch.cuda.max_memory_allocated()
    # warm steps of both arms, alternating, for the step times
    warm, plain_warm = [], []
    for _ in range(TP_TIMED):
        state, _l, dt = _step_synced(step, state, {"tokens": batches[-1]})
        warm.append(dt)
        plain, _l, dt = _step_synced(pstep, plain, {"tokens": batches[-1]})
        plain_warm.append(dt)
    # one more warm step of each under the profiler: busy share, kernels
    prof = device_profile(lambda: step(state, {"tokens": batches[-1]}))
    plain_prof = device_profile(lambda: pstep(plain,
                                              {"tokens": batches[-1]}))
    del state, plain, step, pstep
    _tp_launch_rule("train_tp smollm", launches, plain_launches, n_pos,
                    hr.rows, hr_plain.rows)
    kernel_lines = _tp_kernel_checks(hr, "train_tp smollm bf16")
    want = dict(gmm_update=TP_STEPS * data_cfg.selector_tau,
                pairwise_sqdist=0, center_precheck=0, ssd_intra_chunk=0,
                ssd_intra_chunk_bwd=0)
    check(all(launches[k] == n for k, n in want.items()),
          f"train_tp launches {launches}, expected {want} beside K4/K5")
    dry = _tp_dry(lm, TP_MESH, TRAIN_BATCH, TRAIN_SEQ)
    check(colls == dry, f"train_tp collective bytes {colls}, the dry run "
                        f"counts {dry}")
    nudged = [_run_steps(lm, _nudged(params, g), batches, opt_cfg)
              for _ in range(TP_NUDGES)]
    diffs, floors, limits = _loss_rule(losses, plain_losses, nudged)
    check(all(map(math.isfinite, losses)), f"non-finite {losses}")
    emit(dict(phase="train_tp_steps", arch=TRAIN_ARCH, mesh=list(TP_MESH),
              axes=["data", "model"], heads_per_position=[
                  cfg.n_heads // TP_MESH[1], cfg.n_kv // TP_MESH[1]],
              batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TP_STEPS,
              launches=launches, unsharded_launches=plain_launches,
              k4_k5_rows={k: sorted(v) for k, v in hr.rows.items()},
              unsharded_k4_k5_rows={k: sorted(v)
                                    for k, v in hr_plain.rows.items()},
              losses=losses, unsharded_losses=plain_losses,
              nudged_unsharded_losses=nudged, loss_abs_diffs=diffs,
              nudge_abs_diffs=floors, loss_abs_diff_limits=limits,
              step_s=statistics.median(warm), step_times_s=times,
              warm_step_times_s=warm,
              unsharded_step_s=statistics.median(plain_warm),
              unsharded_step_times_s=plain_times,
              unsharded_warm_step_times_s=plain_warm,
              peak_device_bytes=peak, unsharded_peak_device_bytes=plain_peak,
              profiled_step=prof, unsharded_profiled_step=plain_prof,
              collective_bytes=colls, dryrun_collective_bytes=dry,
              note="every position sits on the one card and they run in "
                   "turn, so the sums cross no wire; the bytes are what "
                   "one position would send"))

    # (b) f32 at 4 x 1,024: one step on (2, 3) against one unsharded
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.detach().float(), params)
    toks = batches[0][:TP_F32_BATCH, :TP_F32_SEQ].contiguous()
    plain = _fresh_state(p32, opt_cfg)
    plain, loss_p, _dt = _step_synced(make_train_step(lm32, opt_cfg), plain,
                                      {"tokens": toks})
    state, m32 = _tp_place(lm32, p32, opt_cfg, TP_MESH)
    del p32
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with _HeadRows() as hr32:
        state, loss_s, dt32, c32 = _tp_step_counted(
            make_train_step(lm32, opt_cfg, mesh=m32), state,
            {"tokens": toks})
    arms["f32"] = ops.launch_counts()
    peak32 = torch.cuda.max_memory_allocated()
    kernel_lines += _tp_kernel_checks(hr32, "train_tp f32")
    f32 = _f32_pair("train_tp f32 step", loss_s, loss_p, state, plain)
    dry32 = _tp_dry(lm32, TP_MESH, TP_F32_BATCH, TP_F32_SEQ)
    check(c32 == dry32, f"train_tp f32 collective bytes {c32}, the dry "
                        f"run counts {dry32}")
    del state, plain, params
    torch.cuda.empty_cache()
    emit(dict(phase="train_tp_f32", mesh=list(TP_MESH), batch=TP_F32_BATCH,
              seq=TP_F32_SEQ, launches=arms["f32"], step_s=dt32,
              peak_device_bytes=peak32, collective_bytes=c32,
              dryrun_collective_bytes=dry32, **f32))

    # (c) musicgen-medium at full width, 4 of 48 layers, on (1, 4)
    n_a = TP_AUDIO_MESH[0] * TP_AUDIO_MESH[1]
    cfg_a = dataclasses.replace(get_config(TP_AUDIO_ARCH),
                                n_layers=TP_AUDIO_LAYERS)
    lm_a = LM(cfg_a)
    p_a = lm_a.init(seed, device="cuda")
    tok_a = [torch.randint(0, cfg_a.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=g, device="cuda")]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with _HeadRows() as hr_plain:
        plain, loss_p, dt_p = _step_synced(make_train_step(lm_a, opt_cfg),
                                           _fresh_state(p_a, opt_cfg),
                                           {"tokens": tok_a[0]})
    plain_launches = ops.launch_counts()
    plain_peak = torch.cuda.max_memory_allocated()
    del plain
    state, m_a = _tp_place(lm_a, p_a, opt_cfg, TP_AUDIO_MESH)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with _HeadRows() as hr:
        state, loss_s, dt_s, c_a = _tp_step_counted(
            make_train_step(lm_a, opt_cfg, mesh=m_a), state,
            {"tokens": tok_a[0]})
    arms["musicgen"] = launches_a = ops.launch_counts()
    peak_a = torch.cuda.max_memory_allocated()
    del state
    kernel_lines += _tp_kernel_checks(hr, "train_tp musicgen bf16")
    _tp_launch_rule("train_tp musicgen", launches_a, plain_launches, n_a,
                    hr.rows, hr_plain.rows)
    dry_a = _tp_dry(lm_a, TP_AUDIO_MESH, TRAIN_BATCH, TRAIN_SEQ)
    check(c_a == dry_a, f"train_tp musicgen collective bytes {c_a}, the "
                        f"dry run counts {dry_a}")
    nudged = [_run_steps(lm_a, _nudged(p_a, g), tok_a, opt_cfg)
              for _ in range(TP_NUDGES)]
    diffs, floors, limits = _loss_rule([loss_s], [loss_p], nudged)
    check(math.isfinite(loss_s), f"non-finite {loss_s}")
    del p_a
    torch.cuda.empty_cache()
    emit(dict(phase="train_tp_audio", arch=TP_AUDIO_ARCH,
              layers=TP_AUDIO_LAYERS, params=lm_a.param_count(),
              mesh=list(TP_AUDIO_MESH), heads_per_position=[
                  cfg_a.n_heads // TP_AUDIO_MESH[1],
                  cfg_a.n_kv // TP_AUDIO_MESH[1]],
              batch=TRAIN_BATCH, seq=TRAIN_SEQ, launches=launches_a,
              unsharded_launches=plain_launches,
              k4_k5_rows={k: sorted(v) for k, v in hr.rows.items()},
              loss=loss_s, unsharded_loss=loss_p,
              nudged_unsharded_losses=nudged, loss_abs_diffs=diffs,
              nudge_abs_diffs=floors, loss_abs_diff_limits=limits,
              step_s=dt_s, unsharded_step_s=dt_p,
              note="one step each, cold: the times include first-call "
                   "costs",
              peak_device_bytes=peak_a,
              unsharded_peak_device_bytes=plain_peak,
              collective_bytes=c_a, dryrun_collective_bytes=dry_a))
    total = {}
    for counts in arms.values():
        total = _add_counts(total, counts)
    emit(dict(phase="train_tp_kernels", checks=kernel_lines))
    emit(dict(phase="train_tp_launches", arms=arms, total=total))
    return dict(launches=total)


def _add_counts(a: dict, b: dict) -> dict:
    """Two launch-count dicts summed key by key."""
    return {k: a.get(k, 0) + b.get(k, 0) for k in a.keys() | b.keys()}


def _check_ssd_bwd(xbar, loga, B, C, dy, ds, what: str, route: str) -> dict:
    """K6b against its plain version: dxbar, dloga, dB and dC each within
    SSD_BWD_TOL of the plain version's largest |entry|, the shapes the
    plain version gives, the route the launch took, and a second launch
    bit-identical to the first."""
    import torch
    from repro_torch.kernels import ops, ssd_bwd

    got = ops.ssd_intra_chunk_bwd(xbar, loga, B, C, dy, ds)
    got_route = ssd_bwd.last_route
    again = ops.ssd_intra_chunk_bwd(xbar, loga, B, C, dy, ds)
    want = ops.ssd_intra_chunk_bwd(xbar, loga, B, C, dy, ds, force="ref")
    torch.cuda.synchronize()
    names = ("dxbar", "dloga", "dB", "dC")
    errs, rels = {}, {}
    ok = got_route == route
    for name, a, w in zip(names, got, want):
        ok = ok and a.shape == w.shape
        scale = float(w.abs().max())
        errs[name] = float((a - w).abs().max())
        rels[name] = errs[name] / scale if scale else errs[name]
        ok = ok and rels[name] <= SSD_BWD_TOL
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = ok and repeat
    line = dict(kernel="ssd_intra_chunk_bwd", what=what,
                shape=[*xbar.shape, B.shape[-1]], b_c_shape=list(B.shape),
                route=got_route, max_abs_err=max(errs.values()),
                max_abs_errs=errs, err_rel_to_max=rels,
                tol_rel_to_max=SSD_BWD_TOL, repeat_bit_identical=repeat,
                ok=ok)
    check(ok, f"ssd bwd {what} {line['shape']} ({got_route}, expected "
              f"{route}): errors {rels} of the largest |gradient|, repeat "
              f"bit-identical {repeat}")
    return line


def _time_ssd_bwd(xbar, loga, B, C, dy, ds) -> dict:
    """K6b and its plain version at one layer's captured inputs (batch *
    chunk by head cells, B and C shared by the heads)."""
    from repro_torch.kernels import ref, ssd_bwd

    *lead, q, p = xbar.shape
    n = B.shape[-1]
    cells = lead[0] * lead[1]
    groups = lead[0] if B.shape[1] == C.shape[1] == 1 else cells
    tri = q * (q + 1) // 2
    # per cell: dM = dy xbar^T and M^T dy over the causal pairs, (B w)
    # dstate and xbar dstate^T, ~8 operations a pair for L, M, dG and the
    # row and column sums; per B and C: C B^T, dG B and dG^T C
    flops = (cells * (2 * 2 * tri * p + 2 * 2 * q * n * p + 8 * tri)
             + groups * 3 * 2 * tri * n)
    # xbar, dy, dxbar; dstate; loga, dloga; B, C, dB, dC
    nbytes = 4 * (3 * cells * q * p + cells * n * p + 2 * cells * q
                  + 4 * groups * q * n)
    b, by = bound_ms(nbytes, flops)
    ssd_bwd.ssd_intra_chunk_bwd(xbar, loga, B, C, dy, ds)
    res = dict(
        route=ssd_bwd.last_route,
        design=ssd_bwd.describe(lead[0], lead[1], q, n, groups < cells,
                                xbar.device.index),
        kernel_ms=time_ms(lambda: ssd_bwd.ssd_intra_chunk_bwd(
            xbar, loga, B, C, dy, ds)),
        plain_ms=time_ms(lambda: ref.ssd_intra_chunk_bwd(
            xbar, loga, B, C, dy, ds), warmup=1, reps=5),
        library_ms=None,
        library_note="no single PyTorch call computes the backward of the "
                     "decay-masked C B^T product and the chunk state",
        bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
        shape=[lead[0], lead[1], q, p, n])
    res["tflop_per_s"] = flops / res["kernel_ms"] / 1e9
    return res


def _state_digest(state) -> list:
    """Per leaf of a train state: its path and two exact integer sums of
    its bits (plain and position-weighted, in int64). Two states with the
    same digest are equal bit for bit but for a collision of both sums."""
    import torch
    from repro_torch.train.checkpoint import _paths

    out = []
    for key, t in _paths(state):
        v = t.detach().reshape(-1)
        if v.dtype.is_floating_point:
            v = v.view({2: torch.int16, 4: torch.int32}[v.element_size()])
        v = v.to(torch.int64)
        pos = torch.arange(1, v.numel() + 1, dtype=torch.int64,
                           device=v.device)
        out.append((key, int(v.sum()), int((v * pos).sum())))
        del v, pos
    return out


def _loss_rule(losses, plain, nudged) -> tuple[list, list, list]:
    """The ``train`` phase's bf16 rule: step i's kernel and plain losses
    differ by at most 2 (i + 1) times the largest difference that a
    nudged embedding makes on the plain path up to step i. ``nudged``
    holds the plain path's losses under several independent nudges; a
    step's floor is the largest of their differences (one nudge's
    difference spreads over two orders of magnitude from draw to draw)."""
    diffs = [abs(a - b) for a, b in zip(losses, plain)]
    floors = [max(abs(run[i] - b) for run in nudged)
              for i, b in enumerate(plain)]
    limits = [2 * (i + 1) * max(floors[:i + 1]) for i in range(len(diffs))]
    for i, (d, lim) in enumerate(zip(diffs, limits)):
        check(d <= lim, f"step {i}: kernel and plain losses differ by {d}, "
                        f"over 2 x {i + 1} x the nudge's {lim / 2 / (i + 1)}")
    return diffs, floors, limits


def _nudged(params, g):
    """``params`` with one bf16 step up on 1e-4 of the embedding's
    entries."""
    import torch

    hit = torch.rand(params["embed"].shape, generator=g, device="cuda") < 1e-4
    return dict(params, embed=torch.where(
        hit, (params["embed"].float() * (1 + 2**-7)).to(torch.bfloat16),
        params["embed"]))


def phase_dryrun(seed: int, train: dict) -> dict:
    """The port's dry run of the ``train`` phase's own cell, held to the
    card (see the module's list)."""
    import torch
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.train import (
        AdamWConfig, init_train_state, make_train_step,
    )
    from repro_torch.train.train_state import StepConfig

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train_16x2048", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS,
                          warmup_steps=min(100, TRAIN_STEPS // 10 + 1))
    ops.reset_launches()
    t0 = time.perf_counter()
    cell = dryrun.count_cell(cfg, shape,
                             dryrun.meta_mesh((1, 1), ("data", "model")),
                             opt_cfg=opt_cfg, step_cfg=StepConfig())
    trace_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(not any(launches.values()), f"the dry run launched {launches}")
    lm, mem = cell["lm"], cell["memory"]
    predicted = mem["argument_bytes"] + mem["output_bytes"] \
        + mem["temp_bytes"] - mem["alias_bytes"]

    # (a) the arguments against what the state and the batch take
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    state = init_train_state(lm, seed, opt_cfg, device="cuda")
    tokens = torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                         device="cuda")
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    arg_rel = abs(allocated - mem["argument_bytes"]) / mem["argument_bytes"]
    check(arg_rel <= DRYRUN_ARG_TOL,
          f"argument_bytes {mem['argument_bytes']} against {allocated} "
          f"allocated: {arg_rel:.4f} relative, over {DRYRUN_ARG_TOL}")

    # (b) the traced program itself, the plain path's step, on the card
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(lm, opt_cfg, force="ref")
    t0 = time.perf_counter()
    state, m = step(state, {"tokens": tokens})
    torch.cuda.synchronize()
    plain_step_s = time.perf_counter() - t0
    plain_peak = torch.cuda.max_memory_allocated() - before
    del state, m, tokens
    torch.cuda.empty_cache()
    lo, hi = DRYRUN_PEAK_BAND
    r_plain = predicted / plain_peak
    r_train = predicted / train["peak"]
    check(lo <= r_plain <= hi,
          f"predicted peak {predicted} / the plain step's {plain_peak} = "
          f"{r_plain:.4f}, outside {DRYRUN_PEAK_BAND}")
    check(lo <= r_train <= hi,
          f"predicted peak {predicted} / the train phase's {train['peak']} "
          f"= {r_train:.4f}, outside {DRYRUN_PEAK_BAND}")

    # (c) one full-size production cell on meta
    arch, shape_name, mesh_kind = DRYRUN_FULL_CELL
    t0 = time.perf_counter()
    full = dryrun.count_cell(get_config(arch), SHAPES[shape_name],
                             dryrun.production_mesh(mesh_kind))
    full_s = time.perf_counter() - t0
    check(not any(ops.launch_counts().values()),
          "the full-size dry run launched a kernel")
    dev = cell["per_device"]
    emit(dict(phase="dryrun", arch=TRAIN_ARCH, batch=TRAIN_BATCH,
              seq=TRAIN_SEQ, positions=1, trace_s=trace_s,
              ops=cell["counted"]["ops"], per_device=dev,
              counted=cell["counted"], kernels=[
                  {key: k[key] for key in ("kernel", "launches",
                                           "plain_flops", "kernel_flops",
                                           "plain_bytes", "kernel_bytes")}
                  for k in cell["kernels"]],
              memory=mem, argument_bytes=mem["argument_bytes"],
              allocated_bytes=allocated, argument_rel_diff=arg_rel,
              predicted_peak_bytes=predicted,
              plain_step_peak_bytes=plain_peak, plain_step_s=plain_step_s,
              train_phase_peak_bytes=train["peak"],
              peak_ratio_plain=r_plain, peak_ratio_train=r_train,
              peak_band=DRYRUN_PEAK_BAND, full_cell=dict(
                  arch=arch, shape=shape_name, mesh=mesh_kind,
                  seconds=full_s, ops=full["counted"]["ops"],
                  per_device=full["per_device"],
                  peak_estimate_gib=full["memory"]["peak_estimate_gib"])))
    # the port's first share of a whole step: MODEL_FLOPS over the measured
    # step time at the bf16 dense peak
    mf = dryrun.model_flops(cfg, shape, lm)
    share = mf / (train["step_s"] * BF16_FLOPS_PER_S_DENSE)
    emit(dict(phase="dryrun_step_share", arch=TRAIN_ARCH,
              model_flops=mf, step_s=train["step_s"],
              peak_flops=BF16_FLOPS_PER_S_DENSE, step_share=share,
              kernel_path_flops=dev["flops"],
              kernel_path_share=dev["flops"] / (
                  train["step_s"] * BF16_FLOPS_PER_S_DENSE)))
    return dict(launches=launches, step_share=share)


_EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "from repro_torch.kernels import ops\n"
    "name = sys.argv[1]\n"
    "sys.argv = [name] + sys.argv[2:]\n"
    "ops.reset_launches()\n"
    "runpy.run_module('repro_torch.examples.' + name, run_name='__main__')\n"
    "print('LAUNCHES ' + json.dumps(ops.launch_counts()))\n")


def phase_examples() -> dict:
    """The five twins of ``examples/*.py`` on the card, each a subprocess,
    all at once (see the module's list)."""
    import os
    import shutil

    import torch
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    out = root / "build" / "chip_smoke_examples"
    shutil.rmtree(out, ignore_errors=True)  # a rerun would resume training
    out.mkdir(parents=True)
    args = {"diversity_service": ["--out-dir", str(out)],
            "diverse_training": ["--ckpt-dir", str(out / "ckpt")]}
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = {}
    ends: dict = {}
    t0 = time.perf_counter()
    try:
        for name in EXAMPLES:
            log = open(out / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", _EXAMPLE_RUNNER, name,
                 *args.get(name, [])], cwd=root, env=env, stdout=log,
                stderr=subprocess.STDOUT), log)
        while len(ends) < len(procs) \
                and time.perf_counter() - t0 < EXAMPLES_TIMEOUT_S:
            for name, (proc, _log) in procs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - t0
            time.sleep(0.2)
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    results = {}
    for name, (proc, _log) in procs.items():
        text = (out / f"{name}.log").read_text()
        if proc.returncode != 0 or name not in ends:
            sys.stderr.write(text[-4000:])
        check(name in ends, f"the {name} twin ran past "
                            f"{EXAMPLES_TIMEOUT_S} s")
        check(proc.returncode == 0,
              f"the {name} twin exited {proc.returncode}")
        counts = [json.loads(line[len("LAUNCHES "):])
                  for line in text.splitlines()
                  if line.startswith("LAUNCHES ")]
        results[name] = dict(seconds=ends[name],
                             launches=counts[-1] if counts else None,
                             log_tail=text.strip().splitlines()[-3:])
    launches = {k: 0 for k in ops.launch_counts()}
    for r in results.values():
        for k, n in (r["launches"] or {}).items():
            launches[k] += n
    emit(dict(phase="examples", wall_s=time.perf_counter() - t0,
              examples=results, launches=launches,
              note="diverse_training's kernels launch in its two "
                   "launch.train children, not counted here"))
    return dict(launches=launches)


def phase_train_ssm(seed: int) -> dict:
    import dataclasses
    import statistics as st

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.train import AdamWConfig, make_train_step

    g = torch.Generator(device="cuda").manual_seed(seed + 3)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def decays(*shape):
        return -(torch.rand(*shape, generator=g, device="cuda") * 0.39 + 0.01)

    # (a) K6b at test shapes: per-cell B and C, then the model's layout
    lines = []
    for gg, q, p, n in SSD_BWD_SHAPES:
        lines.append(_check_ssd_bwd(
            randn(gg, q, p), decays(gg, q), randn(gg, q, n), randn(gg, q, n),
            randn(gg, q, p), randn(gg, n, p), "test shape", "per_cell"))
    for bc, heads, q, n in SSD_BWD_MODEL_SHAPES:
        p = 64
        lines.append(_check_ssd_bwd(
            randn(bc, q, heads, p).permute(0, 2, 1, 3),
            decays(bc, q, heads).permute(0, 2, 1), randn(bc, 1, q, n),
            randn(bc, 1, q, n), randn(bc, q, heads, p).permute(0, 2, 1, 3),
            randn(bc, heads, n, p), "model layout", "shared_bc"))

    # (b) mamba2-2.7b at full width and TRAIN_SSM_LAYERS layers; K6b and K6
    # at one layer's own inputs, captured from a backward of the slice (K6:
    # the first layer's forward; K6b: the last layer's, the first in the
    # backward)
    cfg = dataclasses.replace(get_config(TRAIN_SSM_ARCH),
                              n_layers=TRAIN_SSM_LAYERS)
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt_cfg = AdamWConfig(total_steps=TRAIN_SSM_STEPS,
                          warmup_steps=min(100, TRAIN_SSM_STEPS // 10 + 1))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SSM_SEQ,
                          global_batch=TRAIN_SSM_BATCH, seed=seed)
    pipe = Pipeline(data_cfg)
    with _Capture() as cap:  # also the warm-up of the training run
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = lm.loss(live, pipe.batch_at(0)["tokens"])
        torch.autograd.grad(loss, tree_leaves(live))
        del live, loss
    torch.cuda.synchronize()
    sa, _ = cap.args["ssd_intra_chunk"]
    ba, _ = cap.args["ssd_intra_chunk_bwd"]
    del cap
    lines.append(_check_ssd_bwd(*ba, "a layer's backward (the last layer)",
                                "shared_bc"))
    k6b_err = lines[-1]["max_abs_err"]
    lines.append(_check_ssd(*sa, "a training layer's forward (the first)",
                            "shared_bc"))
    k6_err = lines[-1]["max_abs_err"]
    emit(dict(phase="train_ssm_kernels", checks=lines))
    k6b = _time_ssd_bwd(*ba)
    k6 = _time_ssd(*sa)
    emit(dict(phase="train_ssm_kernel_timing", ssd_intra_chunk_bwd=k6b,
              ssd_intra_chunk_train_shape=k6))
    del ba, sa
    torch.cuda.empty_cache()

    # the steps on the kernel path, launch counts read around them (the
    # data selection included); the state after the first step kept as
    # its digest for the repeat below
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state = _fresh_state(params, opt_cfg)
    step = make_train_step(lm, opt_cfg)
    batches, losses, step_times = [], [], []
    digest = None
    for i in range(TRAIN_SSM_STEPS):
        t0 = time.perf_counter()
        batches.append(pipe.batch_at(i)["tokens"])
        state, m = step(state, {"tokens": batches[-1]})
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        if i == 0:
            digest = _state_digest(state)
    launches = ops.launch_counts()
    run_peak = torch.cuda.max_memory_allocated()
    L, tau = cfg.n_layers, data_cfg.selector_tau
    want = dict(gmm_update=TRAIN_SSM_STEPS * tau,
                flash_attention_fwd=0, flash_attention_bwd=0,
                pairwise_sqdist=0, center_precheck=0,
                ssd_intra_chunk=TRAIN_SSM_STEPS * 2 * L,
                ssd_intra_chunk_bwd=TRAIN_SSM_STEPS * L)
    check(launches == want, f"train_ssm launches {launches}, expected {want}")
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    prof = device_profile(lambda: step(state, {"tokens": pipe.batch_at(
        TRAIN_SSM_STEPS)["tokens"]}))
    del state, m
    torch.cuda.empty_cache()
    # the same batches on the plain path, and with the embedding nudged
    ops.reset_launches()
    losses_r = _run_steps(lm, params, batches, opt_cfg, force="ref")
    check(not any(ops.launch_counts().values()),
          f"the plain path launched {ops.launch_counts()}")
    losses_n = [_run_steps(lm, _nudged(params, g), batches, opt_cfg,
                           force="ref") for _ in range(TRAIN_SSM_NUDGES)]
    diffs, floors, limits = _loss_rule(losses, losses_r, losses_n)
    # a repeated first step from a fresh state: the same bits
    s1, m1 = step(_fresh_state(params, opt_cfg), {"tokens": batches[0]})
    repeat = _state_digest(s1) == digest and float(m1["loss"]) == losses[0]
    del s1, m1
    torch.cuda.empty_cache()
    check(repeat, "a repeated step from a fresh state gave other bits")
    f32 = _train_f32_check(lm, params, batches[0][:TRAIN_SSM_F32_BATCH])
    step_s = st.median(step_times)
    tokens = TRAIN_SSM_BATCH * TRAIN_SSM_SEQ
    emit(dict(phase="train_ssm_steps", arch=TRAIN_SSM_ARCH,
              batch=TRAIN_SSM_BATCH, seq=TRAIN_SSM_SEQ, chunk=cfg.ssd_chunk,
              steps=TRAIN_SSM_STEPS, params=lm.param_count(), init_s=init_s,
              launches=launches, losses=losses, plain_losses=losses_r,
              nudged_plain_losses=losses_n, loss_abs_diffs=diffs,
              nudge_abs_diffs=floors, loss_abs_diff_limits=limits,
              repeat_step_bit_identical=repeat,
              f32=dict(f32, batch=TRAIN_SSM_F32_BATCH)))
    emit(dict(phase="train_ssm_timing", step_s=step_s,
              step_times_s=step_times, tokens_per_s=tokens / step_s,
              peak_device_bytes=run_peak, profiled_step=prof))
    del params, batches
    torch.cuda.empty_cache()

    # K6b at zamba2-7b's layer shape, seeded (its captured inputs come only
    # with the 12-layer model of (c)); after the steps, so that nothing it
    # leaves allocated (a library's workspace) is in their peak
    bc, heads, q, n = SSD_BWD_HYBRID_SHAPE
    hb = (randn(bc, q, heads, 64).permute(0, 2, 1, 3),
          decays(bc, q, heads).permute(0, 2, 1), randn(bc, 1, q, n),
          randn(bc, 1, q, n), randn(bc, q, heads, 64).permute(0, 2, 1, 3),
          randn(bc, heads, n, 64))
    check_h = _check_ssd_bwd(*hb, "zamba2-7b's layer shape (seeded)",
                             "shared_bc")
    k6b_h = _time_ssd_bwd(*hb)
    del hb
    torch.cuda.empty_cache()
    emit(dict(phase="train_ssm_kernels_hybrid_shape", checks=[check_h],
              ssd_intra_chunk_bwd_hybrid_shape=k6b_h))
    k6b_h_err = check_h["max_abs_err"]

    # (c) zamba2-7b at full width, 12 layers: K4, K5, K6 and K6b in one
    # graph, one step against the plain path
    cfg_h = dataclasses.replace(get_config(HYBRID_ARCH),
                                n_layers=HYBRID_LAYERS)
    lm_h = LM(cfg_h)
    params_h = lm_h.init(seed, device="cuda")
    toks = torch.randint(0, cfg_h.vocab, (HYBRID_BATCH, TRAIN_SSM_SEQ),
                         generator=g, device="cuda")
    opt_h = AdamWConfig(total_steps=1, warmup_steps=1)
    _run_steps(lm_h, params_h, [toks], opt_h)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    loss_h = _run_steps(lm_h, params_h, [toks], opt_h)
    torch.cuda.synchronize()
    step_h = time.perf_counter() - t0
    launches_h = ops.launch_counts()
    peak_h = torch.cuda.max_memory_allocated()
    supers = HYBRID_LAYERS // cfg_h.shared_attn_every
    want_h = dict(gmm_update=0, pairwise_sqdist=0, center_precheck=0,
                  flash_attention_fwd=2 * supers, flash_attention_bwd=supers,
                  ssd_intra_chunk=2 * HYBRID_LAYERS,
                  ssd_intra_chunk_bwd=HYBRID_LAYERS)
    check(launches_h == want_h,
          f"zamba2 step launches {launches_h}, expected {want_h}")
    loss_hr = _run_steps(lm_h, params_h, [toks], opt_h, force="ref")
    loss_hn = [_run_steps(lm_h, _nudged(params_h, g), [toks], opt_h,
                          force="ref") for _ in range(TRAIN_SSM_NUDGES)]
    f32_h = _train_f32_check(lm_h, params_h, toks)
    d_h, f_h, l_h = _loss_rule(loss_h, loss_hr, loss_hn)
    emit(dict(phase="train_ssm_hybrid", arch=HYBRID_ARCH,
              layers=HYBRID_LAYERS, of_layers=get_config(HYBRID_ARCH).n_layers,
              supers=supers, batch=HYBRID_BATCH, seq=TRAIN_SSM_SEQ,
              params=lm_h.param_count(), step_s=step_h,
              peak_device_bytes=peak_h, launches=launches_h, loss=loss_h,
              plain_loss=loss_hr, nudged_plain_losses=loss_hn,
              loss_abs_diff=d_h, nudge_abs_diff=f_h, loss_abs_diff_limit=l_h,
              f32=f32_h))
    del params_h
    torch.cuda.empty_cache()
    both = {name: launches[name] + launches_h[name] for name in launches}
    return dict(launches=both, k6b=k6b, k6b_err=k6b_err, k6=k6,
                k6_err=k6_err, k6b_h=k6b_h, k6b_h_err=k6b_h_err,
                k6b_h_launches=launches_h["ssd_intra_chunk_bwd"])


class _SsdCells(_OpsWrap):
    """While entered, the (batch x chunk cells, heads) of every K6 and K6b
    call, per op, and copies of the inputs of each op's first ``keep``
    calls (a block runs its model positions in turn, so these are each
    position's first)."""

    NAMES = ("ssd_intra_chunk", "ssd_intra_chunk_bwd")

    def __init__(self, keep: int = 0):
        self.keep = keep

    def __enter__(self):
        self.cells = {name: set() for name in self.NAMES}
        self.args = {name: [] for name in self.NAMES}
        return super().__enter__()

    def _wrap(self, name, fn):
        def call(xbar, *args, **kw):
            self.cells[name].add(tuple(xbar.shape[:2]))
            if len(self.args[name]) < self.keep:
                self.args[name].append([a.clone() for a in (xbar, *args)])
            return fn(xbar, *args, **kw)
        return call


def _ssm_arm(step, state, batches, keep: int) -> dict:
    """``batches`` through ``step`` from ``state``, synced: the losses and
    times, the step-0 collective bytes, the launches, K6/K6b cells and
    K4/K5 rows of every call, and the peak; then TP_SSM_TIMED warm steps
    for the step time; then, with ``keep``, one more step keeping each
    position's first K6, K6b (``_SsdCells``), K4 and K5 (``_HeadRows``)
    inputs, outside the peak and the counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import collective_bytes, \
        reset_collective_bytes

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, times, colls = [], [], None
    with _SsdCells() as sc, _HeadRows() as hr:
        for i, b in enumerate(batches):
            reset_collective_bytes()
            state, loss, dt = _step_synced(step, state, {"tokens": b})
            if i == 0:
                colls = collective_bytes()
            losses.append(loss)
            times.append(dt)
    out = dict(losses=losses, step_times_s=times, collective_bytes=colls,
               launches=ops.launch_counts(),
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               cells={k: sorted(v) for k, v in sc.cells.items()},
               rows={k: sorted(v) for k, v in hr.rows.items()})
    warm = []
    for _ in range(TP_SSM_TIMED):
        state, _l, dt = _step_synced(step, state, {"tokens": batches[-1]})
        warm.append(dt)
    out.update(warm_step_times_s=warm, step_s=statistics.median(warm))
    if keep:
        with _SsdCells(keep) as cap, _HeadRows() as hcap:
            state, _l, _dt = _step_synced(step, state,
                                          {"tokens": batches[-1]})
        out["args"], out["flash"] = cap.args, hcap
    del state, step
    torch.cuda.empty_cache()
    return out


def _ssm_tp_rule(what: str, arm: dict, plain: dict, shape) -> None:
    """K6 and K6b launch once a position as often as on the unsharded step,
    each call on a data row's share of its batch x chunk cells and 1/tp
    of its heads; K4 and K5 likewise (a hybrid's shared block), on 1/n of
    its B x heads rows."""
    n_dp, tp = shape
    for name in ("ssd_intra_chunk", "ssd_intra_chunk_bwd",
                 "flash_attention_fwd", "flash_attention_bwd"):
        got, want = arm["launches"][name], plain["launches"][name]
        check(got == n_dp * tp * want,
              f"{what}: {name} launched {got} times, expected {n_dp * tp} "
              f"x the unsharded {want}")
    for name in ("ssd_intra_chunk", "ssd_intra_chunk_bwd"):
        ((cells, heads),) = plain["cells"][name]
        check(plain["launches"][name] > 0
              and arm["cells"][name] == [(cells // n_dp, heads // tp)],
              f"{what}: {name} ran on (cells, heads) {arm['cells'][name]}, "
              f"expected {(cells // n_dp, heads // tp)} (the unsharded "
              f"{(cells, heads)} over {shape})")
    for name, rows in plain["rows"].items():
        want = [r // (n_dp * tp) for r in rows]
        check(arm["rows"][name] == want,
              f"{what}: {name} ran on rows {arm['rows'][name]}, expected "
              f"{want}")


def _ssm_tp_checks(arm: dict, what: str) -> list:
    """K6 and K6b (and K4 and K5 where the arm ran them) against their
    plain versions at each position's first-call inputs of a warm step
    (K6: the first layer's forward; K6b: the last layer's backward), at
    the ``train_ssm`` and ``train`` phases' tolerances. Called after the
    arm's launches are read, so these launches count on no path."""
    lines = []
    for j, a in enumerate(arm["args"]["ssd_intra_chunk"]):
        lines.append(_check_ssd(*a, f"{what}: position {j}'s heads, the "
                                    f"first layer's forward", "shared_bc"))
    for j, a in enumerate(arm["args"]["ssd_intra_chunk_bwd"]):
        lines.append(_check_ssd_bwd(*a, f"{what}: call {j} of the last "
                                        f"layer's backward (a position's "
                                        f"heads)", "shared_bc"))
    if arm["flash"].args:
        lines += _tp_kernel_checks(arm["flash"], what)
    return lines


def _tp_f32(lm, params, tokens, opt_cfg, shape, phase: str) -> dict:
    """One f32 step on ``shape`` against one unsharded, both on the kernel
    path from ``params`` upcast, emitted as ``phase`` before it is
    checked: the loss within TP_SSM_F32_LOSS_TOL relative; every leaf of
    the gradient (read as the first moment, 0.1 x the clipped gradient)
    and of the second moment within TP_SSM_F32_TOL relative L2 (the split
    halves the K of the f32 GEMMs and reorders the sums, and the 3xTF32
    K6 and K6b round anew on other inputs; a per-head vector's gradient,
    A_log's most, cancels over the tokens); the collective bytes the dry
    run's. Printed per part, its worst leaf beside what one more
    unsharded step on the plain path (``force="ref"``) differs by there;
    the parameters too, not held to a limit: AdamW's first update is g /
    (|g| + eps) an entry, so a zero-initialised leaf (conv_b) is that
    alone, and its entries whose gradient cancels to ~eps are decided by
    the order of the sums (the plain path's step differs there too)."""
    import dataclasses

    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_map
    from repro_torch.train import make_train_step

    lm32 = LM(dataclasses.replace(lm.cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.detach().float(), params)
    plain, loss_p, _dt = _step_synced(make_train_step(lm32, opt_cfg),
                                      _fresh_state(p32, opt_cfg),
                                      {"tokens": tokens})
    ref, loss_r, _dt = _step_synced(make_train_step(lm32, opt_cfg,
                                                    force="ref"),
                                    _fresh_state(p32, opt_cfg),
                                    {"tokens": tokens})
    state, mesh = _tp_place(lm32, p32, opt_cfg, shape)
    del p32
    ops.reset_launches()
    state, loss_s, _dt, colls = _tp_step_counted(
        make_train_step(lm32, opt_cfg, mesh=mesh), state,
        {"tokens": tokens})
    dry = _tp_dry(lm32, shape, *tokens.shape)
    out = dict(phase=phase, arch=lm.cfg.name, layers=lm.cfg.n_layers,
               mesh=list(shape), batch=tokens.shape[0], seq=tokens.shape[1],
               loss=loss_s, loss_unsharded=loss_p, loss_plain_path=loss_r,
               loss_rel_diff=abs(loss_s - loss_p) / abs(loss_p),
               launches=ops.launch_counts(), collective_bytes=colls,
               dryrun_collective_bytes=dry)
    over = []
    for name, sub, held in (("grad", lambda t: t["opt"]["m"], True),
                            ("second_moment", lambda t: t["opt"]["v"], True),
                            ("params", lambda t: t["params"], False)):
        got = _rel_leaves(sub(state), sub(plain))
        floor = _rel_leaves(sub(ref), sub(plain))
        worst = max(got, key=got.get)
        out[name] = dict(max_rel_l2_diff=got[worst], worst_leaf=worst,
                         plain_path_rel_l2_diff_there=floor[worst],
                         plain_path_max_rel_l2_diff=max(floor.values()))
        over += [f"{name} {k}: {d}" for k, d in got.items()
                 if held and d > TP_SSM_F32_TOL]
    del state, plain, ref
    torch.cuda.empty_cache()
    emit(out)
    check(out["loss_rel_diff"] <= TP_SSM_F32_LOSS_TOL,
          f"{phase}: f32 losses differ by {out['loss_rel_diff']} relative")
    check(colls == dry, f"{phase}: f32 collective bytes {colls}, the dry "
                        f"run counts {dry}")
    check(not over, f"{phase}: f32 leaves over {TP_SSM_F32_TOL} relative "
                    f"L2: {over}")
    return out


def phase_train_tp_ssm(seed: int) -> dict:
    """The ssm and hybrid families trained tensor parallel on in-process
    ("data", "model") meshes of the one card, against the unsharded step
    (see the module's list)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.models import LM
    from repro_torch.models.mamba import mamba_dims
    from repro_torch.train import AdamWConfig, make_train_step

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    cfg = dataclasses.replace(get_config(TRAIN_SSM_ARCH),
                              n_layers=TP_SSM_LAYERS)
    lm = LM(cfg)
    params = lm.init(seed, device="cuda")
    opt_cfg = AdamWConfig(total_steps=TRAIN_SSM_STEPS,
                          warmup_steps=min(100, TRAIN_SSM_STEPS // 10 + 1))
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SSM_SEQ,
                               global_batch=TRAIN_SSM_BATCH, seed=seed))
    batches = [pipe.batch_at(i)["tokens"] for i in range(TRAIN_SSM_STEPS)]
    heads = mamba_dims(cfg)[1]
    # (a) mamba2-2.7b: the unsharded kernel path, then each mesh
    plain = _ssm_arm(make_train_step(lm, opt_cfg),
                     _fresh_state(params, opt_cfg), batches, 0)
    nudged = [_run_steps(lm, _nudged(params, g), batches, opt_cfg)
              for _ in range(TRAIN_SSM_NUDGES)]
    arms, kernel_lines, timing = {}, [], {}
    for shape in TP_SSM_MESHES:
        what = f"train_tp_ssm mamba2 {shape}"
        state, mesh = _tp_place(lm, params, opt_cfg, shape)
        arm = _ssm_arm(make_train_step(lm, opt_cfg, mesh=mesh), state,
                       batches, shape[1])
        del state
        arms[f"mamba2 {shape}"] = arm["launches"]
        _ssm_tp_rule(what, arm, plain, shape)
        kernel_lines += _ssm_tp_checks(arm, what)
        dry = _tp_dry(lm, shape, TRAIN_SSM_BATCH, TRAIN_SSM_SEQ)
        check(arm["collective_bytes"] == dry,
              f"{what}: collective bytes {arm['collective_bytes']}, the "
              f"dry run counts {dry}")
        check(all(map(math.isfinite, arm["losses"])),
              f"{what}: non-finite {arm['losses']}")
        diffs, floors, limits = _loss_rule(arm["losses"], plain["losses"],
                                           nudged)
        if shape == TP_SSM_MESHES[0]:
            # K6 and K6b timed at a position's own cells of a layer
            timing = dict(k6=_time_ssd(*arm["args"]["ssd_intra_chunk"][0]),
                          k6b=_time_ssd_bwd(
                              *arm["args"]["ssd_intra_chunk_bwd"][0]))
            timing["k6_err"] = kernel_lines[0]["max_abs_err"]
            timing["k6b_err"] = kernel_lines[shape[1]]["max_abs_err"]
        arm.pop("args"), arm.pop("flash")
        emit(dict(phase="train_tp_ssm_steps", arch=TRAIN_SSM_ARCH,
                  layers=TP_SSM_LAYERS, params=lm.param_count(),
                  mesh=list(shape), axes=["data", "model"],
                  heads_per_position=heads // shape[1],
                  batch=TRAIN_SSM_BATCH, seq=TRAIN_SSM_SEQ, **arm,
                  unsharded=plain, nudged_unsharded_losses=nudged,
                  loss_abs_diffs=diffs, nudge_abs_diffs=floors,
                  loss_abs_diff_limits=limits, dryrun_collective_bytes=dry,
                  note="every position sits on the one card and they run "
                       "in turn, so the sums cross no wire; the bytes are "
                       "what one position would send"))
    emit(dict(phase="train_tp_ssm_kernel_timing",
              ssd_intra_chunk=timing["k6"],
              ssd_intra_chunk_bwd=timing["k6b"]))
    del params, batches
    torch.cuda.empty_cache()
    # the f32 check at 2 layers on 1 x 2,048, on the first mesh
    cfg32 = dataclasses.replace(cfg, n_layers=TP_SSM_F32_LAYERS)
    lm32 = LM(cfg32)
    toks = torch.randint(0, cfg.vocab, (TP_SSM_F32_BATCH, TRAIN_SSM_SEQ),
                         generator=g, device="cuda")
    f32 = _tp_f32(lm32, lm32.init(seed, device="cuda"), toks, opt_cfg,
                  TP_SSM_MESHES[0], "train_tp_ssm_f32")
    arms["mamba2 f32"] = f32["launches"]

    # (b) zamba2-7b at one super block on (1, 2)
    cfg_h = dataclasses.replace(get_config(HYBRID_ARCH),
                                n_layers=SHARD_HYBRID_LAYERS)
    lm_h = LM(cfg_h)
    p_h = lm_h.init(seed, device="cuda")
    tok_h = [torch.randint(0, cfg_h.vocab, (SHARD_HYBRID_BATCH,
                                            SHARD_HYBRID_SEQ),
                           generator=g, device="cuda")
             for _ in range(TRAIN_SSM_STEPS)]
    plain_h = _ssm_arm(make_train_step(lm_h, opt_cfg),
                       _fresh_state(p_h, opt_cfg), tok_h, 0)
    nudged_h = [_run_steps(lm_h, _nudged(p_h, g), tok_h, opt_cfg)
                for _ in range(TRAIN_SSM_NUDGES)]
    what = f"train_tp_ssm zamba2 {TP_HYBRID_MESH}"
    state, mesh = _tp_place(lm_h, p_h, opt_cfg, TP_HYBRID_MESH)
    arm = _ssm_arm(make_train_step(lm_h, opt_cfg, mesh=mesh), state, tok_h,
                   TP_HYBRID_MESH[1])
    del state
    arms["zamba2"] = arm["launches"]
    _ssm_tp_rule(what, arm, plain_h, TP_HYBRID_MESH)
    check(arm["launches"]["flash_attention_bwd"] > 0,
          f"{what}: the shared block's K5 never ran")
    kernel_lines += _ssm_tp_checks(arm, what)
    dry = _tp_dry(lm_h, TP_HYBRID_MESH, SHARD_HYBRID_BATCH, SHARD_HYBRID_SEQ)
    check(arm["collective_bytes"] == dry,
          f"{what}: collective bytes {arm['collective_bytes']}, the dry run "
          f"counts {dry}")
    check(all(map(math.isfinite, arm["losses"])),
          f"{what}: non-finite {arm['losses']}")
    diffs, floors, limits = _loss_rule(arm["losses"], plain_h["losses"],
                                       nudged_h)
    arm.pop("args"), arm.pop("flash")
    emit(dict(phase="train_tp_ssm_hybrid", arch=HYBRID_ARCH,
              layers=SHARD_HYBRID_LAYERS, params=lm_h.param_count(),
              mesh=list(TP_HYBRID_MESH), heads_per_position=[
                  mamba_dims(cfg_h)[1] // TP_HYBRID_MESH[1],
                  cfg_h.n_heads // TP_HYBRID_MESH[1]],
              batch=SHARD_HYBRID_BATCH, seq=SHARD_HYBRID_SEQ, **arm,
              unsharded=plain_h, nudged_unsharded_losses=nudged_h,
              loss_abs_diffs=diffs, nudge_abs_diffs=floors,
              loss_abs_diff_limits=limits, dryrun_collective_bytes=dry))
    f32_h = _tp_f32(lm_h, p_h, tok_h[0][:TP_HYBRID_F32_BATCH], opt_cfg,
                    TP_HYBRID_MESH, "train_tp_ssm_hybrid_f32")
    arms["zamba2 f32"] = f32_h["launches"]
    del p_h
    torch.cuda.empty_cache()
    total = {}
    for counts in arms.values():
        total = _add_counts(total, counts)
    emit(dict(phase="train_tp_ssm_kernels", checks=kernel_lines))
    emit(dict(phase="train_tp_ssm_launches", arms=arms, total=total))
    return dict(launches=total, **timing)


class _Routes:
    """While entered, records the experts (``eidx``) and kept masks of
    every ``moe_route`` call on a sequence of ``seq`` tokens (a prefill's
    or a training forward's; decode steps pass), in call order. With
    ``replay`` (another run's recorded experts, in the same order) each
    call routes to the recorded experts instead, and the (layer, token)
    rows where its own choice differed are counted, each with the gap
    between its own probability and the replayed expert's."""

    def __init__(self, seq=None, replay=None):
        self.seq, self.replay = seq, replay

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.orig = moe, moe.moe_route
        self.eidx, self.keep, self.flips, self.gap = [], [], 0, 0.0
        moe.moe_route = self._call
        return self

    def _call(self, x, router, **kw):
        r = self.orig(x, router, **kw)
        if kw.get("eidx") is not None:
            return r  # the model replays its own recorded route
        if self.seq is not None and x.shape[1] != self.seq:
            return r
        if self.replay is not None:
            want = self.replay[len(self.eidx)]
            rows = (want != r.eidx).any(-1)
            if bool(rows.any()):
                probs = r.probs[rows]
                own = probs.gather(-1, r.eidx[rows]).min(-1).values
                theirs = probs.gather(-1, want[rows]).min(-1).values
                self.flips += int(rows.sum())
                self.gap = max(self.gap, float((own - theirs).max()))
            r = self.orig(x, router, eidx=want, **kw)
        self.eidx.append(r.eidx.clone())
        self.keep.append(r.keep.clone())
        return r

    def __exit__(self, *exc):
        self.moe.moe_route = self.orig

    def kept_share(self) -> float:
        return (sum(int(k.sum()) for k in self.keep)
                / sum(k.numel() for k in self.keep))

    def agreement(self, other) -> float:
        """The share of (layer, token, choice) routes equal in two runs."""
        same = sum(int((a == b).sum()) for a, b in zip(self.eidx, other.eidx))
        return same / sum(a.numel() for a in self.eidx)


def _nudged_logits(lm, params, prompts, g, img=None,
                   routes=None) -> "torch.Tensor":
    """The last position's logits of a plain-path prefill whose embedding
    is nudged by one bf16 step on 1e-4 of its entries: the model's own
    bf16 sensitivity. With ``routes`` it is routed to those experts, and
    the largest gap between its own choice's probability and the
    replayed expert's comes with the logits."""
    import torch
    from repro_torch.models.model import block_apply_full

    B, S = prompts.shape
    x = params["embed"][prompts]
    hit = torch.rand(x.shape, generator=g, device=x.device) < 1e-4
    x = torch.where(hit, (x.float() * (1 + 2**-7)).to(x.dtype), x)
    ctx = lm.context(params, B, S, img=img, force="ref")
    with _Routes(seq=S, replay=routes) as rt:
        for _, _, kind, p in lm.blocks(params):
            x, _, _ = block_apply_full(kind, p, x, ctx, want_cache=False)
    return lm.head(params, x[:, -1:])[:, 0].float(), rt.gap


def _serve_family(lm, params, prompts, steps: int, g, attn_layers: int,
                  img=None, cross_layers: int = 0) -> dict:
    """``Engine.generate`` of ``prompts`` and ``steps`` new tokens on the
    kernel path (launch counts set to 0 before and read after: K4 once an
    attention layer, cross attention included, and ``cross_layers`` of
    those launches from not-causal calls, counted apart) and on the plain
    path; the greedy tokens as in the ``lm`` phase. K4 is held to its
    plain version at the first attention layer's captured inputs (and
    the first cross-attention layer's): that is the kernel's gate. The
    prefill logits must agree within LM_LOGIT_TOL of the largest logit
    or within twice the largest difference that TRAIN_SSM_NUDGES nudged
    embeddings make on the plain path. With experts, a route may go the
    other way on the two paths and change a token's output wholly, and
    the model (random weights) carries such a flip to every later token;
    so that comparison is made between the kernel path's prefill and a
    plain prefill routed as the kernel path routed, the nudged ones
    routed so too. Each replayed flip is counted, and its lead (the
    plain path's own choice's probability over the replayed expert's)
    must be at most LM_LOGIT_TOL or at most twice the largest lead that
    a nudged prefill's own choices take over the replayed experts: no
    larger than the model's own bf16 sensitivity. On random weights that
    sensitivity can be large (phi3.5-moe's, PERF.md §6), and then this
    model-level comparison says little of the kernel. Printed beside it:
    the kept share of the kernel path's prefill routes and the share of
    (layer, token, choice) routes on which the two paths' own prefills
    agree."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine

    B, P = prompts.shape
    max_len = P + steps
    with _Capture() as cap:  # also the warm-up
        lm.prefill(params, prompts, img, cache_len=max_len)
    torch.cuda.synchronize()
    fa, fkw = cap.args["flash_attention_fwd"]
    checks = [_check_flash(*fa, fkw["causal"], "first attention layer")]
    cross = cap.args.get("flash_attention_fwd@full")
    if cross is not None:
        checks.append(_check_flash(*cross[0], False,
                                   "first cross-attention layer"))
    del cap
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with _Routes(seq=P) as rk, _NonCausal() as nc:
        eng = Engine(lm, params, max_len)
        tok, lg = eng.generate(prompts, steps, img, return_logits=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches["flash_attention_fwd"] == attn_layers,
          f"K4 launched {launches['flash_attention_fwd']} times in generate, "
          f"expected {attn_layers}")
    want_nc = dict(flash_attention_fwd=cross_layers, flash_attention_bwd=0)
    check(nc.counts == want_nc, f"not-causal K4/K5 launches in generate "
                                f"{nc.counts}, expected {want_nc}")
    check(tok.shape == (B, steps) and bool(torch.isfinite(lg).all()),
          "generate gave tokens of another shape or non-finite logits")
    with _Routes(seq=P) as rr:
        eng_r = Engine(lm, params, max_len, force="ref")
        tok_r, lg_r = eng_r.generate(prompts, steps, img, return_logits=True)
    torch.cuda.synchronize()
    check(ops.launch_counts() == launches, "the plain path launched a kernel")
    d0 = float((lg[:, 0].float() - lg_r[:, 0].float()).abs().max())
    first, rows_equal = _first_divergence(tok, tok_r, lg, lg_r, d0)
    routes = rk.eidx or None
    lg_h = lg_r[:, 0].float()
    with _Routes(seq=P, replay=routes) as rh:  # routed as the kernel path
        if routes is not None:
            lg_h = lm.prefill(params, prompts, img, force="ref")[0].float()
    d_held = float((lg[:, 0].float() - lg_h).abs().max())
    scale = float(lg_h.abs().max())
    nudges, nudge_gaps = [], []
    for _ in range(TRAIN_SSM_NUDGES):
        lg_n, gap_n = _nudged_logits(lm, params, prompts, g, img, routes)
        nudges.append(float((lg_n - lg_h).abs().max()))
        nudge_gaps.append(gap_n)
    check(rh.gap <= max(LM_LOGIT_TOL, 2 * max(nudge_gaps)),
          f"a replayed route's lead {rh.gap} (the plain path's own "
          f"choice's probability over the replayed expert's) is over "
          f"{LM_LOGIT_TOL} and twice the nudges' {max(nudge_gaps)}")
    check(d_held <= max(LM_LOGIT_TOL * scale, 2 * max(nudges)),
          f"prefill logits differ by {d_held}: over {LM_LOGIT_TOL} x "
          f"{scale} and over twice the plain path's noise floor "
          f"{max(nudges)}")
    dec = eng.timings["decode_steps"]
    out = dict(
        batch=B, prompt=P, new_tokens=steps, params=lm.param_count(),
        active_params=lm.active_param_count(),
        prefill_s=eng.timings["prefill_s"],
        prompt_tokens_per_s=B * P / eng.timings["prefill_s"],
        decode_ms_per_token=eng.timings["decode_s"] / dec * 1e3,
        peak_device_bytes=peak, launches=launches,
        launches_not_causal=nc.counts,
        plain=dict(prefill_s=eng_r.timings["prefill_s"],
                   decode_ms_per_token=eng_r.timings["decode_s"] / dec
                   * 1e3),
        prefill_logit_max_abs_diff=d0,
        held_prefill_logit_max_abs_diff=d_held,
        held_prefill_logit_max_abs=scale,
        nudged_plain_logit_max_abs_diffs=nudges,
        requests_with_equal_tokens=rows_equal, first_divergent_step=first,
        checks=checks)
    if rk.eidx:
        check(len(rk.eidx) == len(rr.eidx), "the paths routed other layers")
        out.update(moe_layers=len(rk.eidx), kept_share=rk.kept_share(),
                   plain_kept_share=rr.kept_share(),
                   route_agreement=rk.agreement(rr),
                   replayed_route_flips=rh.flips,
                   replayed_route_max_gap=rh.gap,
                   nudged_replayed_route_max_gaps=nudge_gaps)
    return dict(line=out, fa=(fa, fkw["causal"]),
                cross=None if cross is None else cross[0])


def _moe_f32_check(lm, params, tokens) -> dict:
    """``_train_f32_check`` for a MoE model: the plain path replays the
    kernel path's routes (a near-tie may go the other way under f32
    rounding; such flips are counted, and each must be a near-tie), and
    neither checkpoints its blocks, so each layer routes once."""
    import dataclasses

    import torch
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves, tree_map

    lm32 = LM(dataclasses.replace(lm.cfg, dtype="float32"))
    out, routes = {}, None
    for force in (None, "ref"):
        p32 = tree_map(lambda t: t.detach().float().requires_grad_(True),
                       params)
        with _Routes(replay=routes) as rt:
            loss, m = lm32.loss(p32, tokens, remat=False, force=force)
        grads = torch.autograd.grad(loss, tree_leaves(p32))
        out[force] = (float(loss.detach()), float(m["aux"].detach()), grads)
        routes = rt.eidx if routes is None else routes
        del p32, loss
    (lk, ak, gk), (lr, ar, gr) = out[None], out["ref"]
    loss_rel = abs(lk - lr) / abs(lr)
    grad_rel = max(float((a - b).norm() / (b.norm() + 1e-30))
                   for a, b in zip(gk, gr))
    del out, gk, gr
    torch.cuda.empty_cache()
    check(rt.gap <= 1e-4, f"a replayed f32 route was no near-tie: its "
                          f"probability {rt.gap} under the plain path's own")
    check(loss_rel <= TRAIN_F32_LOSS_TOL,
          f"f32 step-0 loss differs by {loss_rel} relative")
    check(grad_rel <= TRAIN_F32_GRAD_TOL,
          f"an f32 gradient leaf differs by {grad_rel} relative L2")
    return dict(loss=lk, loss_plain=lr, aux=ak, aux_plain=ar,
                loss_rel_diff=loss_rel, grad_max_rel_l2_diff=grad_rel,
                replayed_route_flips=rt.flips, replayed_route_max_gap=rt.gap)


def phase_moe(seed: int) -> dict:
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.models.moe import capacity
    from repro_torch.train import AdamWConfig

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    # (a), (b) serving at full width, reduced depth
    lines, k4 = {}, None
    for arch, layers, batch, steps in (
            (MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_STEPS),
            (MAV_ARCH, MAV_LAYERS, MAV_BATCH, MAV_STEPS)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        lm = LM(cfg)
        t0 = time.perf_counter()
        params = lm.init(seed, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = torch.randint(0, cfg.vocab, (batch, MOE_PROMPT),
                                generator=g, device="cuda")
        res = _serve_family(lm, params, prompts, steps, g, layers)
        add(res["line"]["launches"])
        line = dict(phase="moe_serve", arch=arch, layers=layers,
                    of_layers=get_config(arch).n_layers, plan=lm.plan,
                    experts=cfg.n_experts, top_k=cfg.top_k,
                    capacity_factor=cfg.capacity_factor,
                    capacity=capacity(MOE_PROMPT, cfg.top_k,
                                      cfg.capacity_factor, cfg.n_experts),
                    param_bytes=sum(t.numel() * t.element_size()
                                    for t in tree_leaves(params)),
                    init_s=init_s, **res["line"])
        emit(line)
        lines[arch] = line
        if arch == MOE_ARCH:  # K4 at phi's GQA 32/8 layer
            k4 = _time_flash(*res["fa"][0], heads=cfg.n_heads)
        del params, res, prompts
        torch.cuda.empty_cache()

    # (c) phi training at full width, MOE_TRAIN_LAYERS layers
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    lm = LM(cfg)
    params = lm.init(seed, device="cuda")
    batches = [torch.randint(0, cfg.vocab, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ),
                             generator=g, device="cuda")
               for _ in range(MOE_TRAIN_STEPS)]
    opt_cfg = AdamWConfig(total_steps=MOE_TRAIN_STEPS, warmup_steps=1)
    with _Capture() as cap:  # also the warm-up
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, m = lm.loss(live, batches[0])
        torch.autograd.grad(loss, tree_leaves(live))
        aux = float(m["aux"].detach())
        del live, loss, m
    torch.cuda.synchronize()
    ba, bkw = cap.args["flash_attention_bwd"]
    del cap
    k5_line = _check_flash_bwd(*ba, bkw["causal"], "a phi3.5-moe layer's "
                                                   "backward")
    with torch.no_grad():
        aux_r = float(lm.loss(params, batches[0], force="ref")[1]["aux"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    losses = _run_steps(lm, params, batches, opt_cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    train_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict(gmm_update=0, pairwise_sqdist=0, center_precheck=0,
                flash_attention_fwd=MOE_TRAIN_STEPS * 2 * MOE_TRAIN_LAYERS,
                flash_attention_bwd=MOE_TRAIN_STEPS * MOE_TRAIN_LAYERS,
                ssd_intra_chunk=0, ssd_intra_chunk_bwd=0)
    check(train_launches == want,
          f"moe train launches {train_launches}, expected {want}")
    add(train_launches)
    check(all(map(math.isfinite, losses)) and aux > 0,
          f"losses {losses}, aux {aux}")
    losses_r = _run_steps(lm, params, batches, opt_cfg, force="ref")
    losses_n = [_run_steps(lm, _nudged(params, g), batches, opt_cfg,
                           force="ref") for _ in range(TRAIN_SSM_NUDGES)]
    diffs, floors, limits = _loss_rule(losses, losses_r, losses_n)
    host = tree_map(lambda t: t.cpu(), params)  # (d) places from here
    del params
    torch.cuda.empty_cache()
    cfg1 = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS)
    lm1 = LM(cfg1)
    params1 = lm1.init(seed, device="cuda")
    tok1 = torch.randint(0, cfg.vocab, (1, MOE_F32_SEQ), generator=g,
                         device="cuda")
    f32 = _moe_f32_check(lm1, params1, tok1)
    host1 = tree_map(lambda t: t.cpu(), params1)
    del params1
    torch.cuda.empty_cache()
    emit(dict(phase="moe_train", arch=MOE_ARCH, layers=MOE_TRAIN_LAYERS,
              batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
              steps=MOE_TRAIN_STEPS, params=lm.param_count(),
              run_s=run_s, step_s=run_s / MOE_TRAIN_STEPS,
              peak_device_bytes=peak, launches=train_launches,
              losses=losses, plain_losses=losses_r,
              nudged_plain_losses=losses_n, loss_abs_diffs=diffs,
              nudge_abs_diffs=floors, loss_abs_diff_limits=limits,
              aux_step0=aux, aux_step0_plain=aux_r, k5_check=k5_line,
              f32=dict(f32, layers=MOE_F32_LAYERS, seq=MOE_F32_SEQ)))
    k5 = _time_flash_bwd(*ba, cfg.n_heads, bkw["causal"])
    emit(dict(phase="moe_timing", flash_attention_fwd_phi=k4,
              flash_attention_bwd_phi=k5))
    del ba
    torch.cuda.empty_cache()
    mesh = _moe_mesh_arms(lm, host, batches, opt_cfg, g)
    del host, batches
    mesh_f32 = _moe_mesh_f32(lm1, host1, g)
    del host1
    torch.cuda.empty_cache()
    return dict(launches=launches, k4=k4, k5=k5,
                mesh_launches=_add_counts(mesh["launches"],
                                          mesh_f32["launches"]),
                k4_tp=mesh["k4_tp"], k5_tp=mesh["k5_tp"],
                k4_tp_err=mesh["k4_tp_err"], k5_tp_err=mesh["k5_tp_err"],
                k4_tp_launches=mesh["k4_tp_launches"],
                k5_tp_launches=mesh["k5_tp_launches"],
                k4_err=lines[MOE_ARCH]["checks"][0]["max_abs_err"],
                k5_err=k5_line["max_abs_err"],
                k4_launches=lines[MOE_ARCH]["launches"]["flash_attention_fwd"],
                k5_launches=train_launches["flash_attention_bwd"])


def _mesh_state(lm, host, opt_cfg, shape):
    """A fresh train state from the host parameters ``host``, placed on an
    in-process mesh of ``shape`` positions of the card by ``param_specs``
    (FSDP over ("data",), or tensor parallel over ("data", "model")), and
    the mesh."""
    import math as _m

    import torch
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import tree_map
    from repro_torch.train import adamw_init
    from repro_torch.train.train_state import state_specs

    axes = ("data", "model")[:len(shape)]
    mesh = make_mesh(shape, axes, devices=["cuda"] * _m.prod(shape))
    specs = state_specs(sh.param_specs(
        lm.abstract_params(), ("data",),
        tp="model" if len(shape) == 2 else None), opt_cfg)
    p = tree_map(lambda t: t.to("cuda", copy=True), host)
    state = {"params": p, "opt": adamw_init(p, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    del p
    return sh.shard_tree(state, specs, mesh, donate=True), mesh


def _mesh_dry(lm, shape, batch: int, seq: int) -> dict:
    """The dry run's count of one step's collective bytes a position on a
    ("data",) or ("data", "model") mesh of ``shape``, by kind."""
    from repro_torch.launch import dryrun
    from repro_torch.train.train_state import StepConfig

    tp = shape[1] if len(shape) == 2 else 1
    want = dict(dryrun.fsdp_collectives(lm, StepConfig(), shape[0], batch,
                                        tp=tp))
    want.update(dryrun.tp_collectives(lm, StepConfig(), shape[0], tp,
                                      (batch, seq)))
    return want


class _RouteClock:
    """While entered, ``lm.route`` and ``lm.tp_route`` (the sharded step's
    routing pass) run between two syncs of the card, their seconds added
    to ``seconds``."""

    def __init__(self, lm):
        self.lm, self.seconds = lm, 0.0

    def __enter__(self):
        import torch

        def timed(fn):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                return out
            return call

        self.lm.route = timed(self.lm.route)
        self.lm.tp_route = timed(self.lm.tp_route)
        return self

    def __exit__(self, *exc):
        del self.lm.route, self.lm.tp_route


def _moe_mesh_arms(lm, host, batches, opt_cfg, g) -> dict:
    """(d) of the ``moe`` phase: the unsharded kernel path's steps (timed,
    with their peak) and its nudged runs, then each of MOE_MESHES (see the
    module's list)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import tree_map
    from repro_torch.train import make_train_step

    cfg = lm.cfg
    B, S = batches[0].shape
    L = cfg.n_layers
    params = tree_map(lambda t: t.to("cuda"), host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain = _fresh_state(params, opt_cfg)
    pstep = make_train_step(lm, opt_cfg)
    plain_losses, plain_times = [], []
    for b in batches:
        plain, loss, dt = _step_synced(pstep, plain, {"tokens": b})
        plain_losses.append(loss)
        plain_times.append(dt)
    plain_peak = torch.cuda.max_memory_allocated()
    del plain, pstep
    nudged = [_run_steps(lm, _nudged(params, g), batches, opt_cfg)
              for _ in range(TRAIN_SSM_NUDGES)]
    del params
    torch.cuda.empty_cache()
    total, kernel_lines, out = {}, [], {}
    for shape in MOE_MESHES:
        n_pos = math.prod(shape)
        tp = shape[1] if len(shape) == 2 else 1
        state, mesh = _mesh_state(lm, host, opt_cfg, shape)
        step = make_train_step(lm, opt_cfg, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        losses, times, route_s, colls = [], [], [], None
        with _HeadRows() as hr, _RouteClock(lm) as rc:
            for i, b in enumerate(batches):
                rc.seconds = 0.0
                state, loss, dt, c = _tp_step_counted(step, state,
                                                      {"tokens": b})
                if i == 0:
                    colls = c
                losses.append(loss)
                times.append(dt)
                route_s.append(rc.seconds)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        del state, step
        torch.cuda.empty_cache()
        what = f"moe_train_mesh {tuple(shape)}"
        steps = len(batches)
        want = dict(gmm_update=0, pairwise_sqdist=0, center_precheck=0,
                    flash_attention_fwd=3 * steps * L * n_pos,
                    flash_attention_bwd=steps * L * n_pos,
                    ssd_intra_chunk=0, ssd_intra_chunk_bwd=0)
        check(launches == want, f"{what}: launches {launches}, expected "
                                f"{want} (the routing pass, the forward "
                                f"and its recompute; the backward)")
        rows = (B // shape[0]) * (cfg.n_heads // tp)
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            check(hr.rows[name] == {rows},
                  f"{what}: {name} ran on rows {sorted(hr.rows[name])}, "
                  f"expected {rows} (B / data positions x heads / model "
                  f"positions)")
        kernel_lines += _tp_kernel_checks(hr, f"{what} bf16")
        dry = _mesh_dry(lm, shape, B, S)
        check(colls == dry, f"{what}: collective bytes {colls}, the dry run "
                            f"counts {dry}")
        check(all(map(math.isfinite, losses)), f"{what}: losses {losses}")
        diffs, floors, limits = _loss_rule(losses, plain_losses, nudged)
        total = _add_counts(total, launches)
        warm = statistics.median(times[1:])
        line = dict(
            phase="moe_train_mesh", arch=cfg.name, layers=L,
            mesh=list(shape), axes=list(mesh.axis_names),
            heads_per_position=[cfg.n_heads // tp, cfg.n_kv // tp],
            experts_per_position=cfg.n_experts // tp, batch=B, seq=S,
            steps=steps, launches=launches, k4_k5_rows=rows,
            losses=losses, unsharded_losses=plain_losses,
            nudged_unsharded_losses=nudged, loss_abs_diffs=diffs,
            nudge_abs_diffs=floors, loss_abs_diff_limits=limits,
            step_times_s=times, step_s=warm,
            unsharded_step_times_s=plain_times,
            unsharded_step_s=statistics.median(plain_times[1:]),
            routing_pass_s=route_s,
            routing_pass_share=sum(route_s[1:]) / sum(times[1:]),
            peak_device_bytes=peak, unsharded_peak_device_bytes=plain_peak,
            collective_bytes=colls, dryrun_collective_bytes=dry,
            note="the positions sit on the one card and run in turn; the "
                 "routing pass is timed between syncs, which the step "
                 "times include")
        emit(line)
        out[tuple(shape)] = dict(hr=hr, launches=launches)
    # K4 and K5 timed at the (2, 2) arm's first-call inputs: a position's
    # 16 heads of 2 rows
    hr = out[MOE_MESHES[-1]]["hr"]
    fa, fkw = hr.args["flash_attention_fwd"]
    ba, bkw = hr.args["flash_attention_bwd"]
    tp = MOE_MESHES[-1][1]
    k4 = _time_flash(*fa, heads=cfg.n_heads // tp, causal=fkw["causal"])
    k5 = _time_flash_bwd(*ba, cfg.n_heads // tp, bkw["causal"])
    last = out[MOE_MESHES[-1]]["launches"]
    emit(dict(phase="moe_train_mesh_kernels", checks=kernel_lines,
              flash_attention_fwd_tp=k4, flash_attention_bwd_tp=k5))
    del out, hr, fa, ba
    torch.cuda.empty_cache()
    return dict(launches=total, k4_tp=k4, k5_tp=k5,
                k4_tp_err=kernel_lines[-2]["max_abs_err"],
                k5_tp_err=kernel_lines[-1]["max_abs_err"],
                k4_tp_launches=last["flash_attention_fwd"],
                k5_tp_launches=last["flash_attention_bwd"])


def _moe_mesh_f32(lm1, host1, g) -> dict:
    """(d)'s f32 step: the 1-layer phi3.5-moe in f32 on MOE_MESH_F32_BATCH
    x MOE_F32_SEQ, one unsharded step (its forward's routes recorded), then
    one on each of MOE_MESHES replaying them (each flip a near-tie), held
    to it by the f32 rule."""
    import dataclasses

    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_map
    from repro_torch.train import AdamWConfig, make_train_step

    lm32 = LM(dataclasses.replace(lm1.cfg, dtype="float32"))
    L, S = lm32.cfg.n_layers, MOE_F32_SEQ
    host32 = tree_map(lambda t: t.float(), host1)
    opt_cfg = AdamWConfig(total_steps=1, warmup_steps=1)
    toks = torch.randint(0, lm32.cfg.vocab, (MOE_MESH_F32_BATCH, S),
                         generator=g, device="cuda")
    batch = {"tokens": toks}
    plain = _fresh_state(tree_map(lambda t: t.to("cuda"), host32), opt_cfg)
    with _Routes(seq=S) as rt:
        plain, loss_p, _dt = _step_synced(make_train_step(lm32, opt_cfg),
                                          plain, batch)
    routes = rt.eidx[:L]  # the forward's (remat's recompute routes again)
    total, lines, kernel_lines = {}, [], []
    for shape in MOE_MESHES:
        n_dp = shape[0]
        rows = MOE_MESH_F32_BATCH // n_dp
        replay = [e[r * rows:(r + 1) * rows] for r in range(n_dp)
                  for e in routes]
        state, mesh = _mesh_state(lm32, host32, opt_cfg, shape)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with _HeadRows() as hr, _Routes(seq=S, replay=replay) as rs:
            state, loss_s, dt, c = _tp_step_counted(
                make_train_step(lm32, opt_cfg, mesh=mesh), state, batch)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        what = f"moe_train_mesh f32 {tuple(shape)}"
        check(rs.gap <= 1e-4, f"{what}: a replayed route was no near-tie: "
                              f"its probability {rs.gap} under the "
                              f"sharded step's own choice")
        f32 = _f32_pair(what, loss_s, loss_p, state, plain)
        dry = _mesh_dry(lm32, shape, MOE_MESH_F32_BATCH, S)
        check(c == dry, f"{what}: collective bytes {c}, the dry run counts "
                        f"{dry}")
        kernel_lines += _tp_kernel_checks(hr, what)
        del state
        torch.cuda.empty_cache()
        total = _add_counts(total, launches)
        lines.append(dict(mesh=list(shape), launches=launches, step_s=dt,
                          peak_device_bytes=peak, collective_bytes=c,
                          dryrun_collective_bytes=dry,
                          replayed_route_flips=rs.flips,
                          replayed_route_max_gap=rs.gap, **f32))
    del plain
    torch.cuda.empty_cache()
    emit(dict(phase="moe_train_mesh_f32", layers=L,
              batch=MOE_MESH_F32_BATCH, seq=S, arms=lines,
              checks=kernel_lines))
    return dict(launches=total)


def _grads(lm, params, tokens, img, force=None) -> tuple:
    """(loss, gradient leaves) of one forward and backward."""
    import torch
    from repro_torch.models.model import tree_leaves, tree_map

    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = lm.loss(live, tokens, img, force=force)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss.detach()), grads


def phase_vlm(seed: int) -> dict:
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    full = get_config(VLM_ARCH)
    e = full.cross_attn_every

    # (a) serving, VLM_SUPERS super blocks, the image embeddings seeded
    cfg = dataclasses.replace(full, n_layers=VLM_SUPERS * e)
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab, (VLM_BATCH, VLM_PROMPT),
                            generator=g, device="cuda")
    img = (torch.randn(VLM_BATCH, cfg.n_img_tokens, cfg.d_model, generator=g,
                       device="cuda") * 0.1).to(lm.dtype)
    res = _serve_family(lm, params, prompts, VLM_STEPS, g, cfg.n_layers, img,
                        cross_layers=VLM_SUPERS)
    serve_launches = res["line"]["launches"]
    serve_nc = res["line"]["launches_not_causal"]
    emit(dict(phase="vlm_serve", arch=VLM_ARCH, layers=cfg.n_layers,
              of_layers=full.n_layers, supers=VLM_SUPERS,
              n_img_tokens=cfg.n_img_tokens,
              param_bytes=sum(t.numel() * t.element_size()
                              for t in tree_leaves(params)),
              init_s=init_s, **res["line"]))
    k4_err = res["line"]["checks"][-1]["max_abs_err"]
    k4 = _time_flash(*res["cross"], heads=cfg.n_heads, causal=False)
    del params, res, prompts, img
    torch.cuda.empty_cache()

    # (b) training, VLM_TRAIN_SUPERS super block: loss and every gradient
    # leaf on the kernel path against the plain path, each leaf's
    # difference within twice the largest that a nudged embedding makes
    cfg = dataclasses.replace(full, n_layers=VLM_TRAIN_SUPERS * e)
    lm = LM(cfg)
    params = lm.init(seed, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (VLM_TRAIN_BATCH, VLM_TRAIN_SEQ),
                           generator=g, device="cuda")
    img = (torch.randn(VLM_TRAIN_BATCH, cfg.n_img_tokens, cfg.d_model,
                       generator=g, device="cuda") * 0.1).to(lm.dtype)
    with _Capture() as cap:  # also the warm-up
        _grads(lm, params, tokens, img)
    torch.cuda.synchronize()
    ba = cap.args["flash_attention_bwd@full"][0]
    del cap
    k5_line = _check_flash_bwd(*ba, False, "a cross-attention layer's "
                                           "backward")
    loss_r, g_r = _grads(lm, params, tokens, img, force="ref")
    floors = [0.0] * len(g_r)
    loss_n = []
    for _ in range(TRAIN_SSM_NUDGES):
        ln, g_n = _grads(lm, _nudged(params, g), tokens, img, force="ref")
        loss_n.append(ln)
        floors = [max(f, float((a.float() - b.float()).norm()))
                  for f, a, b in zip(floors, g_n, g_r)]
        del g_n
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _NonCausal() as nc:
        loss_k, g_k = _grads(lm, params, tokens, img)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    train_launches = ops.launch_counts()
    train_nc = nc.counts
    peak = torch.cuda.max_memory_allocated()
    want = dict(gmm_update=0, pairwise_sqdist=0, center_precheck=0,
                flash_attention_fwd=2 * cfg.n_layers,
                flash_attention_bwd=cfg.n_layers,
                ssd_intra_chunk=0, ssd_intra_chunk_bwd=0)
    check(train_launches == want,
          f"vlm train launches {train_launches}, expected {want}")
    # the cross attention's: twice in the checkpointed forward, once back
    want_nc = dict(flash_attention_fwd=2 * VLM_TRAIN_SUPERS,
                   flash_attention_bwd=VLM_TRAIN_SUPERS)
    check(train_nc == want_nc, f"not-causal K4/K5 launches in training "
                               f"{train_nc}, expected {want_nc}")
    diffs = [float((a.float() - b.float()).norm()) for a, b in zip(g_k, g_r)]
    norms = [float(b.float().norm()) for b in g_r]
    del g_k
    torch.cuda.empty_cache()
    worst = max(range(len(diffs)),
                key=lambda i: diffs[i] / (2 * floors[i] + 1e-30))
    loss_floor = max(abs(x - loss_r) for x in loss_n)
    check(abs(loss_k - loss_r) <= 2 * loss_floor,
          f"vlm loss differs by {abs(loss_k - loss_r)}, over twice the "
          f"nudge's {loss_floor}")
    check(all(d <= 2 * f for d, f in zip(diffs, floors)),
          f"vlm gradient leaf {worst} differs by {diffs[worst]}, over twice "
          f"the nudge's {floors[worst]}")
    emit(dict(phase="vlm_train", arch=VLM_ARCH, layers=cfg.n_layers,
              supers=VLM_TRAIN_SUPERS, batch=VLM_TRAIN_BATCH,
              seq=VLM_TRAIN_SEQ, params=lm.param_count(), fwd_bwd_s=step_s,
              peak_device_bytes=peak, launches=train_launches,
              launches_not_causal=train_nc, loss=loss_k,
              plain_loss=loss_r, nudged_plain_losses=loss_n,
              grad_leaves=len(diffs),
              grad_rel_l2_diff_max=max(d / (n + 1e-30)
                                       for d, n in zip(diffs, norms)),
              grad_diff_over_nudge_max=diffs[worst] / (floors[worst]
                                                       + 1e-30),
              k5_check=k5_line))
    k5 = _time_flash_bwd(*ba, cfg.n_heads, False)
    emit(dict(phase="vlm_timing", flash_attention_fwd_cross=k4,
              flash_attention_bwd_cross=k5))
    del ba
    torch.cuda.empty_cache()
    launches = {name: serve_launches[name] + train_launches[name]
                for name in serve_launches}
    # the training block, its inputs, the plain path's loss and gradients
    # and the nudge floors, for the train_tp_heads phase
    train = dict(lm=lm, params=params, tokens=tokens, img=img, loss=loss_r,
                 grads=g_r, floors=floors, loss_floor=loss_floor,
                 fwd_bwd_s=step_s, peak=peak, launches=train_launches,
                 launches_not_causal=train_nc)
    # K4 and K5 at the cross-attention shape: the not-causal launches
    # counted in the two runs
    return dict(launches=launches, train=train, k4=k4, k5=k5, k4_err=k4_err,
                k5_err=k5_line["max_abs_err"],
                k4_launches=(serve_nc["flash_attention_fwd"]
                             + train_nc["flash_attention_fwd"]),
                k5_launches=(serve_nc["flash_attention_bwd"]
                             + train_nc["flash_attention_bwd"]))


class _HeadCalls(_OpsWrap):
    """While entered, per K4/K5 op and causal flag: how many calls ran on
    how many rows (B x heads), and copies of the inputs of the first
    ``keep`` calls. With ``keep`` the positions that hold heads, those are
    a call a position, in position order: a layer's forward calls them in
    turn, and the backward reaches every position's call at the last
    layer of a kind before any other."""

    NAMES = ("flash_attention_fwd", "flash_attention_bwd")

    def __init__(self, keep: int):
        self.keep = keep

    def __enter__(self):
        import collections

        self.rows = collections.Counter()
        self.args = collections.defaultdict(list)
        return super().__enter__()

    def _wrap(self, name, fn):
        def call(q, *args, **kw):
            key = (name, bool(kw.get("causal", True)))
            self.rows[(*key, int(q.shape[0]))] += 1
            if len(self.args[key]) < self.keep:
                self.args[key].append(([a.clone() for a in (q, *args)], kw))
            return fn(q, *args, **kw)
        return call

    def table(self) -> list:
        """[op, causal, rows, calls] of every kind of call, sorted."""
        return [[*k, n] for k, n in sorted(self.rows.items())]

    def by_op(self) -> dict:
        """Calls by (op, causal)."""
        out: dict = {}
        for (name, causal, _rows), n in self.rows.items():
            out[name, causal] = out.get((name, causal), 0) + n
        return out


def _heads_launch_rule(what: str, calls: _HeadCalls, plain: dict,
                       heads: list, rows: int, n_dp: int) -> None:
    """K4 and K5 launch, for each causal flag, ``n_dp`` x (the positions
    with heads) times as often as on the unsharded step (``plain``: its
    calls by (op, causal)), each call on ``rows`` x the position's heads;
    a position without heads launches nothing."""
    for (name, causal), n in plain.items():
        want: dict = {}
        for h in heads:
            if h:
                want[rows * h] = want.get(rows * h, 0) + n_dp * n
        got = {r: c for (op, cz, r), c in calls.rows.items()
               if op == name and cz == causal}
        check(got == want and n > 0,
              f"{what}: {name} (causal {causal}) ran {got} (rows: calls), "
              f"expected {want} from {n} unsharded calls and heads {heads} "
              f"a position")


def _heads_kernel_checks(calls: _HeadCalls, what: str) -> list:
    """K4 and K5 against their plain versions at each position's captured
    inputs (``_HeadCalls``), causal and not; outside any count."""
    lines = []
    for (name, causal), saved in sorted(calls.args.items()):
        fwd = name == "flash_attention_fwd"
        for j, (args, _kw) in enumerate(saved):
            label = (f"{what}: position {j}'s "
                     f"{'causal' if causal else 'cross'} attention, the "
                     f"{'first' if fwd else 'last'} layer's "
                     f"{'forward' if fwd else 'backward'}")
            line = (_check_flash(*args, causal, label) if fwd else
                    _check_flash_bwd(*args, causal, label))
            lines.append({k: line[k] for k in ("kernel", "what", "shape",
                                               "causal", "max_abs_err",
                                               "ok")})
    return lines


def _tp_live(lm, params, mesh) -> tuple:
    """Each position's model slices of ``params`` (copies) as leaves that
    require grad, a replicated leaf the first position's on every one (as
    the sharded step's ``tp_grad_fn``): (trees, leaves, each leaf's model
    dim)."""
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import tree_leaves
    from repro_torch.train.train_state import _unflatten

    specs = sh.param_specs(lm.abstract_params(), ("data",), tp="model")
    tree = sh.shard_tree(params, specs, mesh)
    dims = [sh.split_dims(sp, "model")[1]
            for sp in sh.spec_leaves(params, specs)]
    first = [t.requires_grad_(True) for t in tree_leaves(tree.shards[0])]
    lives = [first] + [
        [t.requires_grad_(True) if d is not None else f
         for t, f, d in zip(tree_leaves(shard), first, dims)]
        for shard in tree.shards[1:]]
    return ([_unflatten(shard, live)
             for shard, live in zip(tree.shards, lives)], lives, dims)


def _tp_grads(lm, parts, lives, tokens, img, group) -> tuple:
    """(loss, each leaf's gradients): ``LM.tp_loss`` and its backward over
    ``group``'s positions; a leaf's are the positions' slices, or the
    first position's alone for a replicated leaf."""
    import torch

    loss, _ = lm.tp_loss(parts, tokens, group, img=img)
    uniq = list({id(t): t for live in lives for t in live}.values())
    by_id = dict(zip(map(id, uniq), torch.autograd.grad(loss, uniq)))
    del uniq
    grads = [[by_id[id(live[i])] for live in lives]
             for i in range(len(lives[0]))]
    return float(loss.detach()), grads


def _whole_diffs(grads, dims, want) -> list:
    """Each leaf's ||gradient - want|| (L2, f32), the positions' slices
    put together along the leaf's model dim one leaf at a time; the
    slices are dropped as they are read."""
    import torch

    out = []
    for i, (d, w) in enumerate(zip(dims, want)):
        g = grads[i][0] if d is None else torch.cat(grads[i], d)
        grads[i] = None
        out.append(float((g.float() - w.float()).norm()))
        del g
    return out


def _vlm_tp_arm(ref: dict, shape) -> dict:
    """The ``vlm`` phase's training block on an in-process (1, n) mesh of
    the card (see the module's ``train_tp_heads`` (a))."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, make_mesh
    from repro_torch.launch.mesh import (ModelGroup, collective_bytes,
                                         reset_collective_bytes)
    from repro_torch.models.model import head_range
    from repro_torch.train.train_state import StepConfig

    lm = ref["lm"]
    cfg = lm.cfg
    n = shape[1]
    what = f"train_tp_heads vlm {tuple(shape)}"
    mesh = make_mesh(shape, ("data", "model"), devices=["cuda"] * n)
    group = ModelGroup(mesh, "model", list(range(n)))
    heads = [hi - lo for lo, hi in (head_range(cfg.n_heads, n, j)
                                    for j in range(n))]
    parts, lives, dims = _tp_live(lm, ref["params"], mesh)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reset_collective_bytes()
    t0 = time.perf_counter()
    with _HeadCalls(sum(1 for h in heads if h)) as calls:
        loss, grads = _tp_grads(lm, parts, lives, ref["tokens"], ref["img"],
                                group)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    colls = collective_bytes()
    peak = torch.cuda.max_memory_allocated()
    # the loss and every gradient leaf against the plain path's
    diffs = _whole_diffs(grads, dims, ref["grads"])
    del grads
    floors = ref["floors"]
    worst = max(range(len(diffs)),
                key=lambda i: diffs[i] / (2 * floors[i] + 1e-30))
    check(abs(loss - ref["loss"]) <= 2 * ref["loss_floor"],
          f"{what}: the loss differs from the plain path's by "
          f"{abs(loss - ref['loss'])}, over twice the nudge's "
          f"{ref['loss_floor']}")
    check(all(d <= 2 * f for d, f in zip(diffs, floors)),
          f"{what}: gradient leaf {worst} differs by {diffs[worst]}, over "
          f"twice the nudge's {floors[worst]}")
    # every position launches as often as the unsharded step, causal and
    # cross, on its own heads' rows
    nc = ref["launches_not_causal"]
    plain = {}
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        plain[name, False] = nc[name]
        plain[name, True] = ref["launches"][name] - nc[name]
    _heads_launch_rule(what, calls, plain, heads, ref["tokens"].shape[0], 1)
    dry = dryrun.tp_collectives(lm, StepConfig(), 1, n,
                                tuple(ref["tokens"].shape))
    check(colls == dry, f"{what}: collective bytes {colls}, the dry run "
                        f"counts {dry}")
    # a warm forward and backward
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _l, grads = _tp_grads(lm, parts, lives, ref["tokens"], ref["img"],
                          group)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del grads, parts, lives
    torch.cuda.empty_cache()
    checks = _heads_kernel_checks(calls, what)
    emit(dict(phase="train_tp_heads_vlm", arch=VLM_ARCH,
              layers=cfg.n_layers, mesh=list(shape), axes=["data", "model"],
              heads_per_position=heads, kv_heads=cfg.n_kv,
              kv_regrouped=bool(cfg.n_kv % n),
              batch=ref["tokens"].shape[0], seq=ref["tokens"].shape[1],
              n_img_tokens=cfg.n_img_tokens, launches=launches,
              k4_k5_calls_by_rows=calls.table(), loss=loss,
              plain_loss=ref["loss"], loss_nudge_floor=ref["loss_floor"],
              grad_leaves=len(diffs),
              grad_diff_over_nudge_max=diffs[worst] / (floors[worst]
                                                       + 1e-30),
              worst_grad_leaf=worst, fwd_bwd_s=warm_s,
              cold_fwd_bwd_s=cold_s,
              unsharded_fwd_bwd_s=ref["fwd_bwd_s"],
              peak_device_bytes=peak, held_before_bytes=held,
              unsharded_peak_device_bytes=ref["peak"],
              collective_bytes=colls, dryrun_collective_bytes=dry,
              checks=checks,
              note="the positions run in turn on the one card, so the sums "
                   "cross no wire (the bytes are what one position would "
                   "send); the peak holds the unsharded parameters and the "
                   "plain path's gradients beside the positions' slices"))
    return dict(launches=launches, calls=calls)


def phase_train_tp_heads(seed: int, vlm_train: dict) -> dict:
    """Tensor parallel for the vlm and with the heads resharded on
    in-process ("data", "model") meshes of the one card (see the module's
    list); ``vlm_train`` is the ``vlm`` phase's training block, its inputs
    and its plain path's gradients, freed here."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import head_range, tree_map
    from repro_torch.train import AdamWConfig, make_train_step

    arms, timing, errs, at = {}, {}, {}, {}
    # (a) the vlm's training block on (1, 2) and (1, 16)
    for shape in TP_HEADS_VLM_MESHES:
        res = _vlm_tp_arm(vlm_train, shape)
        n = shape[1]
        arms[f"vlm_1x{n}"] = res["launches"]
        heads = vlm_train["lm"].cfg.n_heads // n
        kinds = [("cross", False)] + ([("self", True)]
                                      if n == TP_HEADS_VLM_MESHES[-1][1]
                                      else [])
        by_op = res["calls"].by_op()
        for kind, causal in kinds:
            fa = res["calls"].args["flash_attention_fwd", causal][0][0]
            ba = res["calls"].args["flash_attention_bwd", causal][0][0]
            at[f"k4_{kind}_{n}"] = by_op["flash_attention_fwd", causal]
            at[f"k5_{kind}_{n}"] = by_op["flash_attention_bwd", causal]
            timing[f"k4_{kind}_{n}"] = _time_flash(*fa[:3], heads=heads,
                                                   causal=causal)
            timing[f"k5_{kind}_{n}"] = _time_flash_bwd(*ba, heads=heads,
                                                       causal=causal)
            errs[f"k4_{kind}_{n}"] = _check_flash(
                *fa[:3], causal, f"vlm on (1, {n}): the timed "
                                 f"{kind}")["max_abs_err"]
            errs[f"k5_{kind}_{n}"] = _check_flash_bwd(
                *ba, causal, f"vlm on (1, {n}): the timed "
                             f"{kind}")["max_abs_err"]
        del res
        torch.cuda.empty_cache()
    vlm_train.clear()
    torch.cuda.empty_cache()

    # (b) smollm-135m at full width on (2, 4): the axis divides neither its
    # 9 heads nor its 3 kv heads
    n_dp, tp = TP_HEADS_MESH
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TP_HEADS_LAYERS)
    lm = LM(cfg)
    heads = [hi - lo for lo, hi in (head_range(cfg.n_heads, tp, j)
                                    for j in range(tp))]
    params = lm.init(seed, device="cuda")
    opt_cfg = AdamWConfig(total_steps=TP_STEPS,
                          warmup_steps=min(100, TP_STEPS // 10 + 1))
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    batches = [torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                             generator=g, device="cuda")
               for _ in range(TP_STEPS)]
    what = f"train_tp_heads smollm {TP_HEADS_MESH}"
    state, mesh = _tp_place(lm, params, opt_cfg, TP_HEADS_MESH)
    step = make_train_step(lm, opt_cfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, times, colls = [], [], None
    with _HeadCalls(sum(1 for h in heads if h)) as calls:
        for i, b in enumerate(batches):
            state, loss, dt, c = _tp_step_counted(step, state, {"tokens": b})
            if i == 0:
                colls = c
            losses.append(loss)
            times.append(dt)
    arms["smollm"] = launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain = _fresh_state(params, opt_cfg)
    pstep = make_train_step(lm, opt_cfg)
    plain_losses, plain_times = [], []
    with _HeadCalls(0) as plain_calls:
        for b in batches:
            plain, loss, dt = _step_synced(pstep, plain, {"tokens": b})
            plain_losses.append(loss)
            plain_times.append(dt)
    plain_peak = torch.cuda.max_memory_allocated()
    warm, plain_warm = [], []
    for _ in range(TP_TIMED):
        state, _l, dt = _step_synced(step, state, {"tokens": batches[-1]})
        warm.append(dt)
        plain, _l, dt = _step_synced(pstep, plain, {"tokens": batches[-1]})
        plain_warm.append(dt)
    del state, plain, step, pstep
    torch.cuda.empty_cache()
    _heads_launch_rule(what, calls, plain_calls.by_op(), heads,
                       TRAIN_BATCH // n_dp, n_dp)
    kernel_lines = _heads_kernel_checks(calls, f"{what} bf16")
    table = calls.table()
    del calls
    dry = _tp_dry(lm, TP_HEADS_MESH, TRAIN_BATCH, TRAIN_SEQ)
    check(colls == dry, f"{what}: collective bytes {colls}, the dry run "
                        f"counts {dry}")
    check(bool(dry.get("regroup")), f"{what}: no regroup counted")
    nudged = [_run_steps(lm, _nudged(params, g), batches, opt_cfg)
              for _ in range(TP_NUDGES)]
    diffs, floors, limits = _loss_rule(losses, plain_losses, nudged)
    check(all(map(math.isfinite, losses)), f"non-finite {losses}")
    emit(dict(phase="train_tp_heads_smollm", arch=TRAIN_ARCH,
              layers=cfg.n_layers, mesh=list(TP_HEADS_MESH),
              axes=["data", "model"], heads_per_position=heads,
              kv_heads=cfg.n_kv, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              steps=TP_STEPS, launches=launches, k4_k5_calls_by_rows=table,
              losses=losses, unsharded_losses=plain_losses,
              nudged_unsharded_losses=nudged, loss_abs_diffs=diffs,
              nudge_abs_diffs=floors, loss_abs_diff_limits=limits,
              step_s=statistics.median(warm), step_times_s=times,
              warm_step_times_s=warm,
              unsharded_step_s=statistics.median(plain_warm),
              unsharded_step_times_s=plain_times,
              unsharded_warm_step_times_s=plain_warm,
              peak_device_bytes=peak, unsharded_peak_device_bytes=plain_peak,
              collective_bytes=colls, dryrun_collective_bytes=dry,
              checks=kernel_lines))

    # its f32 step at TP_F32_BATCH x TP_F32_SEQ on (2, 4) against one
    # unsharded
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.detach().float(), params)
    del params
    toks = batches[0][:TP_F32_BATCH, :TP_F32_SEQ].contiguous()
    plain, loss_p, _dt = _step_synced(make_train_step(lm32, opt_cfg),
                                      _fresh_state(p32, opt_cfg),
                                      {"tokens": toks})
    state, m32 = _tp_place(lm32, p32, opt_cfg, TP_HEADS_MESH)
    del p32
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with _HeadCalls(sum(1 for h in heads if h)) as calls32:
        state, loss_s, dt32, c32 = _tp_step_counted(
            make_train_step(lm32, opt_cfg, mesh=m32), state,
            {"tokens": toks})
    arms["smollm_f32"] = ops.launch_counts()
    peak32 = torch.cuda.max_memory_allocated()
    f32 = _f32_pair(f"{what} f32 step", loss_s, loss_p, state, plain)
    del state, plain
    torch.cuda.empty_cache()
    dry32 = _tp_dry(lm32, TP_HEADS_MESH, TP_F32_BATCH, TP_F32_SEQ)
    check(c32 == dry32, f"{what} f32: collective bytes {c32}, the dry run "
                        f"counts {dry32}")
    kernel_lines32 = _heads_kernel_checks(calls32, f"{what} f32")
    del calls32
    emit(dict(phase="train_tp_heads_smollm_f32", mesh=list(TP_HEADS_MESH),
              batch=TP_F32_BATCH, seq=TP_F32_SEQ, launches=arms["smollm_f32"],
              step_s=dt32, peak_device_bytes=peak32, collective_bytes=c32,
              dryrun_collective_bytes=dry32, checks=kernel_lines32, **f32))
    total: dict = {}
    for counts in arms.values():
        total = _add_counts(total, counts)
    emit(dict(phase="train_tp_heads_timing", launches_at=at, errors=errs,
              **timing))
    emit(dict(phase="train_tp_heads_launches", arms=arms, total=total))
    # K4 and K5 at the vlm arms' shapes: their launches there (part of the
    # total), their errors at the timed inputs and their times
    return dict(launches=total, timing=timing, errs=errs, launches_at=at)


def _nudged_embed(params, g) -> dict:
    """``params`` with one bf16 step on 1e-4 of the embedding's entries
    (the ``lm`` phase's noise floor; the other leaves shared)."""
    import torch

    emb = params["embed"]
    hit = torch.rand(emb.shape, generator=g, device=emb.device) < 1e-4
    return dict(params, embed=torch.where(
        hit, (emb.float() * (1 + 2**-7)).to(emb.dtype), emb))


def _serve_dry(lm, shape, batch: int, prompt: int, steps: int,
               mode: str = "heads", cache_len=None) -> dict:
    """The dry run's count of a position's model-axis bytes by kind in one
    ``generate``: a prefill and ``steps - 1`` decode steps, in the kv
    cache layout ``mode`` with caches of ``cache_len`` slots."""
    from repro_torch.launch.dryrun import serve_collectives

    n_dp, tp = shape
    rows = batch // n_dp if batch % n_dp == 0 else batch
    want = dict(serve_collectives(lm, tp, rows, prompt, "prefill", mode,
                                  cache_len))
    for k, v in serve_collectives(lm, tp, rows, prompt, "decode", mode,
                                  cache_len).items():
        want[k] = want.get(k, 0) + (steps - 1) * v
    return want


def _serve_plain(lm, params: dict, prompts, steps: int, g, max_len: int,
                 nudge: bool = True) -> dict:
    """The unsharded engine's greedy run (tokens, logits, launches, K4
    calls, peak, timings) and, in bf16, the noise floor of a nudged
    embedding fed the same tokens."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng0 = Engine(lm, params, max_len)
    with _HeadCalls(0) as plain_calls:
        tok0, lg0 = eng0.generate(prompts, steps, return_logits=True)
    out = dict(tok=tok0, logits=lg0, launches=ops.launch_counts(),
               calls=plain_calls.by_op(),
               peak=torch.cuda.max_memory_allocated(),
               timings=dict(eng0.timings), nudged=None)
    del eng0
    if nudge:
        out["nudged"] = Engine(lm, _nudged_embed(params, g),
                               max_len).generate(
            prompts, steps, return_logits=True, forced=tok0[:, :-1])[1]
    return out


def _serve_tp_arm(lm, params: dict, prompts, steps: int, shape, g,
                  what: str, rule_tol: float = LM_LOGIT_TOL,
                  nudge: bool = True, cache_mode: str = "heads",
                  max_len=None, plain=None) -> dict:
    """One model served unsharded and on an in-process ``shape`` mesh of
    the card (see the module's ``serve_tp``), its kv caches in the layout
    ``cache_mode``, ``max_len`` slots (default prompt + steps). Takes
    ``params`` over: the caller's dict is emptied, so that the mesh's run
    holds its slices and not the whole tree beside them. ``plain``: the
    unsharded run (``_serve_plain``) of the same weights and prompts, made
    here where None."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import make_mesh
    from repro_torch.launch.mesh import collective_bytes, \
        reset_collective_bytes
    from repro_torch.models.model import head_range, tree_leaves
    from repro_torch.models.sharding import resolve_cache_mode
    from repro_torch.serve.engine import Engine

    cfg = lm.cfg
    n_dp, tp = shape
    B, P = prompts.shape
    max_len = max_len or P + steps
    heads = [hi - lo for lo, hi in (head_range(cfg.n_heads, tp, j)
                                    for j in range(tp))]
    # (1) unsharded: the greedy run, and (bf16) the noise floor of a
    # nudged embedding fed the same tokens
    if plain is None:
        plain = _serve_plain(lm, params, prompts, steps, g, max_len, nudge)
    tok0, lg0, lg_n = plain["tok"], plain["logits"], plain["nudged"]
    plain_launches, plain_peak = plain["launches"], plain["peak"]
    plain_t = plain["timings"]
    # (2) the mesh: placed from the whole tree, which then goes
    mesh = make_mesh(shape, ("data", "model"),
                     devices=["cuda"] * (n_dp * tp))
    eng = Engine(lm, dict(params), max_len, mesh=mesh,
                 cache_mode=cache_mode)
    params.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reset_collective_bytes()
    with _Capture() as cap, _HeadCalls(1) as calls:
        tok1, lg1 = eng.generate(prompts, steps, return_logits=True)
    launches = ops.launch_counts()
    colls = collective_bytes()
    peak = torch.cuda.max_memory_allocated()
    t = dict(eng.timings)
    tok2, lg2 = eng.generate(prompts, steps, return_logits=True,
                             forced=tok0[:, :-1])
    del eng
    torch.cuda.empty_cache()
    # launches: K4 once an attention layer per position with heads and
    # data row, on its rows x heads; K6 once a Mamba2 layer per position
    # and data row
    rows = B // n_dp if B % n_dp == 0 else B
    _heads_launch_rule(what, calls, plain["calls"], heads, rows, n_dp)
    check(launches["flash_attention_fwd"] == n_dp * sum(
        1 for h in heads if h) * plain_launches["flash_attention_fwd"],
        f"{what}: K4 launched {launches['flash_attention_fwd']} times")
    check(launches["ssd_intra_chunk"] == n_dp * tp
          * plain_launches["ssd_intra_chunk"],
          f"{what}: K6 launched {launches['ssd_intra_chunk']} times, "
          f"expected {n_dp} x {tp} x {plain_launches['ssd_intra_chunk']}")
    others = {k: v for k, v in launches.items()
              if k not in ("flash_attention_fwd", "ssd_intra_chunk")}
    check(not any(others.values()), f"{what}: launched {others}")
    dry = _serve_dry(lm, shape, B, P, steps, cache_mode, max_len)
    check(colls == dry, f"{what}: collective bytes {colls}, the dry run "
                        f"counts {dry}")
    # logits: each step's, fed the unsharded run's tokens
    scale = float(lg0.float().abs().max())
    d_tp = [float((lg2[:, s].float() - lg0[:, s].float()).abs().max())
            for s in range(steps)]
    d_nudge = ([float((lg_n[:, s].float() - lg0[:, s].float()).abs().max())
                for s in range(steps)] if lg_n is not None else [0.0] * steps)
    limits = [max(rule_tol * scale, 2 * dn) for dn in d_nudge]
    check(all(d <= lim for d, lim in zip(d_tp, limits)),
          f"{what}: logits differ by {d_tp} from the unsharded run's, "
          f"limits {limits} (max |logit| {scale})")
    check(tok1.shape == tok0.shape and bool(torch.isfinite(lg1).all()),
          f"{what}: tokens of another shape or non-finite logits")
    checks = [_check_flash(*calls.args["flash_attention_fwd", True][0][0][:3],
                           True, f"{what}: position 0's first attention "
                                 f"layer")] if calls.args else []
    if "ssd_intra_chunk" in cap.args:
        checks.append(_check_ssd(*cap.args["ssd_intra_chunk"][0],
                                 f"{what}: position 0's first Mamba2 layer",
                                 "shared_bc"))
    def cache_bytes(mode):  # the largest position's, in ``mode``
        return max(sum(t.numel() * t.element_size() for t in tree_leaves(
            lm.init_caches(rows, max_len, device="meta", tp=tp, j=j,
                           mode=mode))) for j in range(tp))

    return dict(
        cache_mode=resolve_cache_mode(cfg, tp, cache_mode), max_len=max_len,
        cache_bytes_per_position=cache_bytes(cache_mode),
        heads_cache_bytes_per_position=cache_bytes("heads"),
        launches=launches, plain_launches=plain_launches,
        k4_calls_by_rows=calls.table(), collective_bytes=colls,
        dryrun_collective_bytes=dry, heads_per_position=heads,
        prefill_s=t["prefill_s"],
        decode_ms_per_token=t["decode_s"] / t["decode_steps"] * 1e3,
        peak_device_bytes=peak, unsharded_prefill_s=plain_t["prefill_s"],
        unsharded_decode_ms_per_token=(plain_t["decode_s"]
                                       / plain_t["decode_steps"] * 1e3),
        unsharded_peak_device_bytes=plain_peak,
        logit_max_abs=scale, step_logit_abs_diffs=d_tp,
        nudge_abs_diffs=d_nudge, step_logit_limits=limits,
        step_logit_max_rel_diff=max(d_tp) / scale,
        within_rule_tol_alone=max(d_tp) <= rule_tol * scale,
        greedy_tokens_equal_share=float((tok1 == tok0).float().mean()),
        forced_picks_equal_share=float((tok2 == tok0).float().mean()),
        checks=[{k: c[k] for k in ("kernel", "what", "shape", "max_abs_err",
                                   "ok")} for c in checks],
        captured=dict(k4=(calls.args["flash_attention_fwd", True][0][0][:3]
                          if calls.args else None),
                      k6=cap.args.get("ssd_intra_chunk", (None,))[0]))


def phase_serve_tp(seed: int) -> dict:
    """Serving on in-process ("data", "model") meshes of the one card (see
    the module's ``serve_tp``)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # (a) zamba2-7b at full width and depth on (2, 2): the lm phase's
    # weights and prompts
    cfg = get_config(LM_ARCH)
    lm = LM(cfg)
    params = lm.init(seed, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                            device="cuda")
    what = f"serve_tp zamba2 {SERVE_TP_MESH}"
    z = _serve_tp_arm(lm, params, prompts, LM_STEPS, SERVE_TP_MESH, g, what)
    del params
    cap = z.pop("captured")
    k4 = _time_flash(*cap["k4"], heads=z["heads_per_position"][0])
    k6 = _time_ssd(*cap["k6"])
    del cap
    torch.cuda.empty_cache()
    emit(dict(phase="serve_tp_zamba2", arch=LM_ARCH, layers=cfg.n_layers,
              mesh=list(SERVE_TP_MESH), axes=["data", "model"],
              batch=LM_BATCH, prompt=LM_PROMPT, new_tokens=LM_STEPS,
              dtype=cfg.dtype, nvidia_smi=smi, **z))
    # its f32 check at SERVE_TP_F32_LAYERS layers
    cfg32 = dataclasses.replace(cfg, n_layers=SERVE_TP_F32_LAYERS,
                                dtype="float32")
    lm32 = LM(cfg32)
    p32 = lm32.init(seed, device="cuda")
    f32 = _serve_tp_arm(lm32, p32, prompts[:SERVE_TP_F32_BATCH],
                        SERVE_TP_F32_STEPS, SERVE_TP_MESH, g,
                        f"{what} f32", rule_tol=SERVE_TP_F32_TOL,
                        nudge=False)
    del p32
    f32.pop("captured")
    torch.cuda.empty_cache()
    emit(dict(phase="serve_tp_zamba2_f32", layers=SERVE_TP_F32_LAYERS,
              mesh=list(SERVE_TP_MESH), batch=SERVE_TP_F32_BATCH,
              prompt=LM_PROMPT, new_tokens=SERVE_TP_F32_STEPS, **f32))
    # (b) smollm-135m at full width and depth on (2, 4)
    cfg_s = get_config(TRAIN_ARCH)
    lm_s = LM(cfg_s)
    p_s = lm_s.init(seed, device="cuda")
    prompts_s = torch.randint(0, cfg_s.vocab,
                              (SERVE_TP_SMOLLM_BATCH, LM_PROMPT),
                              generator=g, device="cuda")
    what_s = f"serve_tp smollm {SERVE_TP_SMOLLM_MESH}"
    sm = _serve_tp_arm(lm_s, p_s, prompts_s, LM_STEPS, SERVE_TP_SMOLLM_MESH,
                       g, what_s)
    del p_s
    cap_s = sm.pop("captured")
    k4_s = _time_flash(*cap_s["k4"], heads=sm["heads_per_position"][0])
    del cap_s
    torch.cuda.empty_cache()
    emit(dict(phase="serve_tp_smollm", arch=TRAIN_ARCH,
              layers=cfg_s.n_layers, mesh=list(SERVE_TP_SMOLLM_MESH),
              axes=["data", "model"], kv_heads=cfg_s.n_kv,
              batch=SERVE_TP_SMOLLM_BATCH, prompt=LM_PROMPT,
              new_tokens=LM_STEPS, dtype=cfg_s.dtype, nvidia_smi=smi, **sm))
    emit(dict(phase="serve_tp_timing", flash_attention_fwd=k4,
              ssd_intra_chunk=k6, flash_attention_fwd_smollm=k4_s,
              nvidia_smi=smi))
    total = _add_counts(_add_counts(z["launches"], f32["launches"]),
                        sm["launches"])
    return dict(launches=total, k4=k4, k6=k6, k4_s=k4_s,
                k4_launches=z["launches"]["flash_attention_fwd"],
                k6_launches=z["launches"]["ssd_intra_chunk"],
                k4_s_launches=sm["launches"]["flash_attention_fwd"],
                k4_err=z["checks"][0]["max_abs_err"],
                k6_err=z["checks"][1]["max_abs_err"],
                k4_s_err=sm["checks"][0]["max_abs_err"])


def phase_serve_tp_layouts(seed: int) -> dict:
    """granite-3-8b served on in-process ("data", "model") meshes of the
    one card in the reference's "hd" and "seq" kv cache layouts (see the
    module's ``serve_tp_layouts``)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = get_config(LAYOUTS_ARCH)
    lm = LM(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    prompts = torch.randint(0, cfg.vocab, (LAYOUTS_BATCH, LAYOUTS_PROMPT),
                            generator=g, device="cuda")
    params = lm.init(seed, device="cuda")
    plain = _serve_plain(lm, params, prompts, LAYOUTS_STEPS, g,
                         LAYOUTS_MAX_LEN)
    arms, timing = {}, {}
    for shape, mode in LAYOUTS_ARMS:
        if not params:  # the last arm took them over: the same draws
            params = lm.init(seed, device="cuda")
        what = f"serve_tp_layouts granite {shape} {mode}"
        a = _serve_tp_arm(lm, params, prompts, LAYOUTS_STEPS, shape, g, what,
                          cache_mode=mode, max_len=LAYOUTS_MAX_LEN,
                          plain=plain)
        layout = a["cache_mode"]
        check(layout == ("hd" if mode == "auto" else mode),
              f"{what}: the layout is {layout}")
        if layout == "seq":  # the decode's writes cross a slot boundary
            per = LAYOUTS_MAX_LEN // shape[1]
            first, last = LAYOUTS_PROMPT, LAYOUTS_PROMPT + LAYOUTS_STEPS - 2
            check(first // per != last // per,
                  f"{what}: slots {first}-{last} lie on one position")
        cap = a.pop("captured")
        timing[layout] = _time_flash(*cap["k4"],
                                     heads=a["heads_per_position"][0])
        del cap
        torch.cuda.empty_cache()
        emit(dict(phase=f"serve_tp_layouts_{layout}", arch=LAYOUTS_ARCH,
                  layers=cfg.n_layers, mesh=list(shape),
                  axes=["data", "model"], cache_mode_arg=mode,
                  batch=LAYOUTS_BATCH, prompt=LAYOUTS_PROMPT,
                  new_tokens=LAYOUTS_STEPS, dtype=cfg.dtype,
                  nvidia_smi=smi, **a))
        arms[layout] = a
    del params, plain
    torch.cuda.empty_cache()
    # the f32 check at LAYOUTS_F32_LAYERS layers, both layouts
    lm32 = LM(dataclasses.replace(cfg, n_layers=LAYOUTS_F32_LAYERS,
                                  dtype="float32"))
    p32 = lm32.init(seed, device="cuda")
    pr32 = prompts[:LAYOUTS_F32_BATCH, :LAYOUTS_F32_PROMPT]
    plain32 = _serve_plain(lm32, p32, pr32, LAYOUTS_F32_STEPS, g,
                           LAYOUTS_F32_PROMPT + LAYOUTS_F32_STEPS,
                           nudge=False)
    total: dict = {}
    for shape, mode in LAYOUTS_ARMS:
        if not p32:
            p32 = lm32.init(seed, device="cuda")
        what = f"serve_tp_layouts granite {shape} {mode} f32"
        a = _serve_tp_arm(lm32, p32, pr32, LAYOUTS_F32_STEPS, shape, g, what,
                          rule_tol=SERVE_TP_F32_TOL, nudge=False,
                          cache_mode=mode, plain=plain32)
        a.pop("captured")
        check(a["greedy_tokens_equal_share"] == 1.0
              and a["forced_picks_equal_share"] == 1.0,
              f"{what}: tokens differ from the unsharded run's")
        emit(dict(phase=f"serve_tp_layouts_{a['cache_mode']}_f32",
                  layers=LAYOUTS_F32_LAYERS, mesh=list(shape),
                  batch=LAYOUTS_F32_BATCH, prompt=LAYOUTS_F32_PROMPT,
                  new_tokens=LAYOUTS_F32_STEPS, **a))
        total = _add_counts(total, a["launches"])
    del p32, plain32
    torch.cuda.empty_cache()
    for a in arms.values():
        total = _add_counts(total, a["launches"])
    emit(dict(phase="serve_tp_layouts_timing", nvidia_smi=smi,
              **{f"flash_attention_fwd_{k}": t for k, t in timing.items()}))
    return dict(launches=total, k4=timing,
                k4_launches={k: a["launches"]["flash_attention_fwd"]
                             for k, a in arms.items()},
                k4_err={k: a["checks"][0]["max_abs_err"]
                        for k, a in arms.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=22, help="rank/4, as in Fig. 1")
    ap.add_argument("--tau", type=int, default=64)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fails without the repository beside it
    from repro_torch.device import disable_tf32

    disable_tf32()
    t_start = time.perf_counter()
    laps: dict = {}
    mark = [t_start]

    def lap(name: str) -> None:
        """The seconds since the last lap, as ``name``'s."""
        now = time.perf_counter()
        laps[name] = now - mark[0]
        mark[0] = now

    dev = phase_device()
    phase_build()
    lap("device_build")
    points, x_norm, cats, caps, spec = phase_data(args.seed)
    k2_err = phase_kernels(x_norm, args.k * args.tau, args.seed)
    lap("data_kernels")
    sol, launches = phase_solve(points, x_norm, cats, caps, spec, args.k,
                                args.tau)
    stream = phase_stream(points, x_norm, cats, caps, spec, args.k, args.tau)
    times = phase_timing(x_norm, sol, args.k * args.tau, stream["st"])
    lap("solve_stream_timing")
    # after the stream and the timing, so no state it leaves behind is in
    # their numbers
    engines = phase_engines(points, x_norm, sol, cats, caps, spec, args.k,
                            args.seed)
    lap("engines")
    serve = phase_serve(points, cats, caps, spec, args.k, args.tau,
                        args.seed, stream["st"], stream["points_per_s"])
    lap("serve")
    durable = phase_durable(spec, caps, args.k, args.tau, args.seed, serve,
                            stream["points_per_s"])
    lap("durable")
    mr = phase_mapreduce(points, x_norm, sol, cats, caps, spec, args.k,
                         args.tau, serve)
    lap("mapreduce")
    del points, x_norm, cats, stream["st"], serve["P"]
    torch.cuda.empty_cache()
    lm = phase_lm(args.seed)
    torch.cuda.empty_cache()  # the zamba2 weights went with phase_lm
    lap("lm")
    train = phase_train(args.seed)
    torch.cuda.empty_cache()
    lap("train")
    train_sharded = phase_train_sharded(args.seed)
    torch.cuda.empty_cache()
    lap("train_sharded")
    train_tp = phase_train_tp(args.seed)
    torch.cuda.empty_cache()
    lap("train_tp")
    dry = phase_dryrun(args.seed, train)
    torch.cuda.empty_cache()
    lap("dryrun")
    examples = phase_examples()
    torch.cuda.empty_cache()
    lap("examples")
    train_ssm = phase_train_ssm(args.seed)
    torch.cuda.empty_cache()
    lap("train_ssm")
    train_tp_ssm = phase_train_tp_ssm(args.seed)
    torch.cuda.empty_cache()
    lap("train_tp_ssm")
    moe = phase_moe(args.seed)
    torch.cuda.empty_cache()
    lap("moe")
    vlm = phase_vlm(args.seed)
    lap("vlm")
    train_tp_heads = phase_train_tp_heads(args.seed, vlm.pop("train"))
    torch.cuda.empty_cache()
    lap("train_tp_heads")
    serve_tp = phase_serve_tp(args.seed)
    torch.cuda.empty_cache()
    lap("serve_tp")
    layouts = phase_serve_tp_layouts(args.seed)
    torch.cuda.empty_cache()
    lap("serve_tp_layouts")

    # launches: the sum over the main paths, each read around its own run
    # (per path beside it)
    per_path = {name: dict(sequential=launches[name],
                           engines=engines["launches"][name],
                           streaming=stream["launches"][name],
                           serve=serve["launches"][name],
                           durable=durable["launches"][name],
                           mapreduce=mr["launches"][name],
                           lm=lm["launches"][name],
                           train=train["launches"][name],
                           train_sharded=train_sharded["launches"][name],
                           train_tp=train_tp["launches"][name],
                           dryrun=dry["launches"][name],
                           examples=examples["launches"][name],
                           train_ssm=train_ssm["launches"][name],
                           train_tp_ssm=train_tp_ssm["launches"][name],
                           moe=moe["launches"][name],
                           moe_mesh=moe["mesh_launches"][name],
                           vlm=vlm["launches"][name],
                           train_tp_heads=train_tp_heads["launches"][name],
                           serve_tp=serve_tp["launches"][name],
                           serve_tp_layouts=layouts["launches"][name])
                for name in launches}
    total = {name: sum(v.values()) for name, v in per_path.items()}
    for name, n in total.items():
        check(n >= 1, f"{name} was launched on no main path")
    csrc = "src/repro_torch/kernels"
    k3 = times["center_precheck"]
    table = [
        dict(name="pairwise_sqdist", route="cuda",
             source=f"{csrc}/csrc/pdist.cu",
             replaces="src/repro/kernels/pdist.py:50",
             launches=total["pairwise_sqdist"],
             launches_per_path=per_path["pairwise_sqdist"],
             max_abs_err=times["pdist"]["max_abs_err"],
             ms=times["pdist"]["kernel_ms"],
             plain_ms=times["pdist"]["plain_ms"],
             bound_ms=times["pdist"]["bound_ms"],
             bound_by=times["pdist"]["bound_by"],
             library_ms=times["pdist"]["library_ms"]),
        dict(name="gmm_update", route="triton", source=f"{csrc}/gmm_step.py",
             replaces="src/repro/kernels/gmm_step.py:44",
             launches=total["gmm_update"],
             launches_per_path=per_path["gmm_update"],
             max_abs_err=k2_err,
             ms=times["gmm_step"]["kernel_ms"],
             plain_ms=times["gmm_step"]["plain_ms"],
             bound_ms=times["gmm_step"]["bound_ms"],
             bound_by=times["gmm_step"]["bound_by"], library_ms=None),
        # K3 as the scan launches it (the fused route); the stats route,
        # the TPU kernel's own function, beside it
        dict(name="center_precheck", route="cuda",
             source=f"{csrc}/csrc/precheck.cu",
             replaces="src/repro/kernels/precheck.py:92",
             launches=total["center_precheck"],
             launches_per_path=per_path["center_precheck"],
             max_abs_err=stream["k3_err"], ms=k3["kernel_ms"],
             plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=None,
             kernel_route="fused", device_us=k3["device_us_per_launch"],
             stats_route={key: k3["stats_route"][key] for key in (
                 "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                 "device_us_per_launch")}),
        dict(name="flash_attention_fwd", route="cuda",
             source=f"{csrc}/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash.py:75",
             launches=total["flash_attention_fwd"],
             launches_per_path=per_path["flash_attention_fwd"],
             max_abs_err=lm["k4_err"], ms=lm["k4"]["kernel_ms"],
             plain_ms=lm["k4"]["plain_ms"], bound_ms=lm["k4"]["bound_ms"],
             bound_by=lm["k4"]["bound_by"],
             library_ms=lm["k4"]["library_ms"]),
        dict(name="flash_attention_bwd", route="cuda",
             source=f"{csrc}/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash.py:219",
             launches=total["flash_attention_bwd"],
             launches_per_path=per_path["flash_attention_bwd"],
             max_abs_err=train["k5_err"], ms=train["k5"]["kernel_ms"],
             plain_ms=train["k5"]["plain_ms"],
             bound_ms=train["k5"]["bound_ms"],
             bound_by=train["k5"]["bound_by"],
             library_ms=train["k5"]["library_ms"]),
        # K4 and K5 at the moe and vlm shapes: their launches are part of
        # the moe and vlm counts above
        dict(name="flash_attention_fwd_gqa", route="cuda",
             source=f"{csrc}/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash.py:75",
             launches=moe["k4_launches"], max_abs_err=moe["k4_err"],
             ms=moe["k4"]["kernel_ms"], plain_ms=moe["k4"]["plain_ms"],
             bound_ms=moe["k4"]["bound_ms"], bound_by=moe["k4"]["bound_by"],
             library_ms=moe["k4"]["library_ms"], shape=moe["k4"]["shape"],
             note="phi3.5-moe's self-attention (GQA 32/8, hd 128), causal"),
        dict(name="flash_attention_fwd_cross", route="cuda",
             source=f"{csrc}/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash.py:75",
             launches=vlm["k4_launches"], max_abs_err=vlm["k4_err"],
             ms=vlm["k4"]["kernel_ms"], plain_ms=vlm["k4"]["plain_ms"],
             bound_ms=vlm["k4"]["bound_ms"], bound_by=vlm["k4"]["bound_by"],
             library_ms=vlm["k4"]["library_ms"], shape=vlm["k4"]["shape"],
             note="llama-3.2-vision's cross attention over 1,024 image "
                  "tokens, not causal"),
        dict(name="flash_attention_bwd_gqa", route="cuda",
             source=f"{csrc}/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash.py:219",
             launches=moe["k5_launches"], max_abs_err=moe["k5_err"],
             ms=moe["k5"]["kernel_ms"], plain_ms=moe["k5"]["plain_ms"],
             bound_ms=moe["k5"]["bound_ms"], bound_by=moe["k5"]["bound_by"],
             library_ms=moe["k5"]["library_ms"], shape=moe["k5"]["shape"],
             note="phi3.5-moe's training layer, causal"),
        # K4 and K5 on a position's heads of phi3.5-moe's layer on the
        # (2, 2) mesh: their launches are part of the moe_mesh count
        dict(name="flash_attention_fwd_moe_tp", route="cuda",
             source=f"{csrc}/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash.py:75",
             launches=moe["k4_tp_launches"], max_abs_err=moe["k4_tp_err"],
             ms=moe["k4_tp"]["kernel_ms"], plain_ms=moe["k4_tp"]["plain_ms"],
             bound_ms=moe["k4_tp"]["bound_ms"],
             bound_by=moe["k4_tp"]["bound_by"],
             library_ms=moe["k4_tp"]["library_ms"],
             shape=moe["k4_tp"]["shape"],
             note="phi3.5-moe trained on (2, 2): 16 heads and 4 kv heads a "
                  "position, causal"),
        dict(name="flash_attention_bwd_moe_tp", route="cuda",
             source=f"{csrc}/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash.py:219",
             launches=moe["k5_tp_launches"], max_abs_err=moe["k5_tp_err"],
             ms=moe["k5_tp"]["kernel_ms"], plain_ms=moe["k5_tp"]["plain_ms"],
             bound_ms=moe["k5_tp"]["bound_ms"],
             bound_by=moe["k5_tp"]["bound_by"],
             library_ms=moe["k5_tp"]["library_ms"],
             shape=moe["k5_tp"]["shape"],
             note="phi3.5-moe trained on (2, 2): a position's heads, "
                  "causal"),
        dict(name="flash_attention_bwd_cross", route="cuda",
             source=f"{csrc}/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash.py:219",
             launches=vlm["k5_launches"], max_abs_err=vlm["k5_err"],
             ms=vlm["k5"]["kernel_ms"], plain_ms=vlm["k5"]["plain_ms"],
             bound_ms=vlm["k5"]["bound_ms"], bound_by=vlm["k5"]["bound_by"],
             library_ms=vlm["k5"]["library_ms"], shape=vlm["k5"]["shape"],
             note="llama-3.2-vision's cross attention, training, not "
                  "causal"),
    ]
    # K4 and K5 on a position's heads of llama-3.2-vision's layers in the
    # train_tp_heads phase: their launches are part of its count above
    heads = train_tp_heads
    for key, note in (("cross_2", "the cross attention on (1, 2): 32 heads "
                                  "and 4 kv heads a position, not causal"),
                      ("cross_16", "the cross attention on (1, 16): 4 heads "
                                   "a position, their kv head regrouped, "
                                   "not causal"),
                      ("self_16", "the self-attention on (1, 16): 4 heads a "
                                  "position, causal")):
        for k, name, src, rep in (
                ("k4", "flash_attention_fwd", "flash_fwd.cu",
                 "src/repro/kernels/flash.py:75"),
                ("k5", "flash_attention_bwd", "flash_bwd.cu",
                 "src/repro/kernels/flash.py:219")):
            t = heads["timing"][f"{k}_{key}"]
            table.append(dict(
                name=f"{name}_vlm_tp_{key}", route="cuda",
                source=f"{csrc}/csrc/{src}", replaces=rep,
                launches=heads["launches_at"][f"{k}_{key}"],
                max_abs_err=heads["errs"][f"{k}_{key}"], ms=t["kernel_ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                shape=t["shape"], note=note))
    # K4 and K6 on a position's heads in the serve_tp phase: their launches
    # are part of its count above
    for key, k, name, src, rep, note in (
            ("k4", "k4", "flash_attention_fwd_serve_tp", "flash_fwd.cu",
             "src/repro/kernels/flash.py:75",
             "zamba2-7b served on (2, 2): 16 of 32 heads of a data row's 12 "
             "prompts a position, causal"),
            ("k4_s", "k4_s", "flash_attention_fwd_serve_tp_smollm",
             "flash_fwd.cu", "src/repro/kernels/flash.py:75",
             "smollm-135m served on (2, 4): 2 of 9 heads of a data row's 8 "
             "prompts a position (3 on the last), causal"),
            ("k6", "k6", "ssd_intra_chunk_serve_tp", "ssd.cu",
             "src/repro/kernels/ssd.py:53",
             "zamba2-7b served on (2, 2): 56 of 112 Mamba heads of a data "
             "row's 12 prompts a position")):
        t = serve_tp[k]
        table.append(dict(
            name=name, route="cuda", source=f"{csrc}/csrc/{src}",
            replaces=rep, launches=serve_tp[f"{key}_launches"],
            max_abs_err=serve_tp[f"{key}_err"], ms=t["kernel_ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            shape=t["shape"], note=note))
    # K4 on a position's heads in the serve_tp_layouts phase: its launches
    # are part of its count above
    for key, note in (
            ("hd", "granite-3-8b served on (1, 16) under 'auto' ('hd'): 2 "
                   "of 32 heads of 4 prompts a position, causal"),
            ("seq", "granite-3-8b served on (1, 4) under 'seq': 8 of 32 "
                    "heads of 4 prompts a position, causal")):
        t = layouts["k4"][key]
        table.append(dict(
            name=f"flash_attention_fwd_serve_tp_{key}", route="cuda",
            source=f"{csrc}/csrc/flash_fwd.cu",
            replaces="src/repro/kernels/flash.py:75",
            launches=layouts["k4_launches"][key],
            max_abs_err=layouts["k4_err"][key], ms=t["kernel_ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            shape=t["shape"], note=note))
    table += [
        dict(name="ssd_intra_chunk", route="cuda",
             source=f"{csrc}/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:53",
             launches=total["ssd_intra_chunk"],
             launches_per_path=per_path["ssd_intra_chunk"],
             max_abs_err=lm["k6_err"], ms=lm["k6"]["kernel_ms"],
             plain_ms=lm["k6"]["plain_ms"], bound_ms=lm["k6"]["bound_ms"],
             bound_by=lm["k6"]["bound_by"], library_ms=None,
             shape=lm["k6"]["shape"], kernel_route=lm["k6"]["route"]),
        # K6 at the embedding forward's chunk (q = 16): its launches are
        # those of that forward, part of the lm count above
        dict(name="ssd_intra_chunk_q16", route="cuda",
             source=f"{csrc}/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:53",
             launches=lm["k6_e_launches"],
             max_abs_err=lm["k6_e_err"], ms=lm["k6_e"]["kernel_ms"],
             plain_ms=lm["k6_e"]["plain_ms"],
             bound_ms=lm["k6_e"]["bound_ms"],
             bound_by=lm["k6_e"]["bound_by"], library_ms=None,
             shape=lm["k6_e"]["shape"], kernel_route=lm["k6_e"]["route"]),
        # K6 at the training shape of mamba2-2.7b (q = 256, n = 128): its
        # launches are those of the train_ssm path, part of the count above
        dict(name="ssd_intra_chunk_train", route="cuda",
             source=f"{csrc}/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:53",
             launches=train_ssm["launches"]["ssd_intra_chunk"],
             max_abs_err=train_ssm["k6_err"],
             ms=train_ssm["k6"]["kernel_ms"],
             plain_ms=train_ssm["k6"]["plain_ms"],
             bound_ms=train_ssm["k6"]["bound_ms"],
             bound_by=train_ssm["k6"]["bound_by"], library_ms=None,
             shape=train_ssm["k6"]["shape"],
             kernel_route=train_ssm["k6"]["route"]),
        # K6 on a position's 40 of mamba2-2.7b's 80 heads on (1, 2): its
        # launches are part of the train_tp_ssm count above
        dict(name="ssd_intra_chunk_tp", route="cuda",
             source=f"{csrc}/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:53",
             launches=train_tp_ssm["launches"]["ssd_intra_chunk"],
             max_abs_err=train_tp_ssm["k6_err"],
             ms=train_tp_ssm["k6"]["kernel_ms"],
             plain_ms=train_tp_ssm["k6"]["plain_ms"],
             bound_ms=train_tp_ssm["k6"]["bound_ms"],
             bound_by=train_tp_ssm["k6"]["bound_by"], library_ms=None,
             shape=train_tp_ssm["k6"]["shape"],
             kernel_route=train_tp_ssm["k6"]["route"]),
        # K6b replaces no TPU kernel: the JAX package differentiates its
        # jnp chunked SSD with jax.grad
        dict(name="ssd_intra_chunk_bwd", route="cuda",
             source=f"{csrc}/csrc/ssd_bwd.cu",
             replaces="src/repro/models/mamba.py:60",
             replaces_note="no Pallas kernel: jax.grad of ssd_chunked's "
                           "intra-chunk einsums, the backward of "
                           "src/repro/kernels/ssd.py:53",
             launches=total["ssd_intra_chunk_bwd"],
             launches_per_path=per_path["ssd_intra_chunk_bwd"],
             max_abs_err=train_ssm["k6b_err"],
             ms=train_ssm["k6b"]["kernel_ms"],
             plain_ms=train_ssm["k6b"]["plain_ms"],
             bound_ms=train_ssm["k6b"]["bound_ms"],
             bound_by=train_ssm["k6b"]["bound_by"], library_ms=None,
             shape=train_ssm["k6b"]["shape"],
             kernel_route=train_ssm["k6b"]["route"],
             design=train_ssm["k6b"]["design"]),
        # K6b at zamba2-7b's layer shape: its launches are those of the
        # 12-layer zamba2-7b step, part of the count above
        dict(name="ssd_intra_chunk_bwd_hybrid", route="cuda",
             source=f"{csrc}/csrc/ssd_bwd.cu",
             replaces="src/repro/models/mamba.py:60",
             launches=train_ssm["k6b_h_launches"],
             max_abs_err=train_ssm["k6b_h_err"],
             ms=train_ssm["k6b_h"]["kernel_ms"],
             plain_ms=train_ssm["k6b_h"]["plain_ms"],
             bound_ms=train_ssm["k6b_h"]["bound_ms"],
             bound_by=train_ssm["k6b_h"]["bound_by"], library_ms=None,
             shape=train_ssm["k6b_h"]["shape"],
             kernel_route=train_ssm["k6b_h"]["route"],
             design=train_ssm["k6b_h"]["design"]),
        # K6b on a position's heads on (1, 2), as K6 above
        dict(name="ssd_intra_chunk_bwd_tp", route="cuda",
             source=f"{csrc}/csrc/ssd_bwd.cu",
             replaces="src/repro/models/mamba.py:60",
             launches=train_tp_ssm["launches"]["ssd_intra_chunk_bwd"],
             max_abs_err=train_tp_ssm["k6b_err"],
             ms=train_tp_ssm["k6b"]["kernel_ms"],
             plain_ms=train_tp_ssm["k6b"]["plain_ms"],
             bound_ms=train_tp_ssm["k6b"]["bound_ms"],
             bound_by=train_tp_ssm["k6b"]["bound_by"], library_ms=None,
             shape=train_tp_ssm["k6b"]["shape"],
             kernel_route=train_tp_ssm["k6b"]["route"],
             design=train_tp_ssm["k6b"]["design"]),
    ]
    emit(dict(phase="done", seconds=time.perf_counter() - t_start,
              phase_seconds=laps))
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
