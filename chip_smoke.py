#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases, each of which raises (exit code != 0) on failure:

1. device — the card's name and power limit from ``nvidia-smi``;
2. build — ``nvcc`` builds ``src/repro_torch/csrc/*.cu`` for sm_90a; prints
   each kernel's ``-Xptxas -v`` spill and register lines and fails if an
   instance of the interaction_dot forward or backward kernel spills, if
   one of ``hash_layer_kernel`` or ``alloc_offsets_kernel`` has a stack
   frame or spills, or if any of them has no report;
3. feature_hash — both ``dlrm`` FE programs (cross_features: 8 columns,
   16 ops; sparse_ids: 10 columns, 10 ops) at N = 512, 8,192, 262,144 and
   1,048,576 rows and field sizes 2**20 and 1000, on ids with negatives and
   values >= 2**31 before narrowing: kernel == plain version exactly. The
   launch floor (the device time of ``zero_()`` on one element) and each
   program's time above it; times (per call, median of 21 groups of 10
   calls: device-only, and with the Python wrapper), bounds, and at
   N = 8,192 a second turn of kernel, floor, floor, kernel in the same
   call. Each program's share of its byte bound is read at N = 1,048,576
   with its inputs rotated over at least 3 column blocks and 150 MB, so no
   call finds them in the 50 MB L2; at 262,144 (19-25 MB a call, which the
   L2 holds) no share is read. A share above 100 % anywhere fails the phase;
4. interaction_dot — B = 512, 8,192 and 65,536, F = 27, D = 128: kernel within
   rtol/atol 1e-5 of the plain version (another fp32 summation order);
   times, byte bound, and ``torch.bmm`` + tril gather as the library
   yardstick; the kernel's share of its bound and its ratio to the library,
   and a second turn of kernel, library, library, kernel in the same call;
5. interaction_dot backward — B = 8,192 and 65,536, F = 27, D = 128: kernel
   within 1e-5 of the plain version, relative to the largest gradient;
   times, byte bound, and the scatter of dy + ``torch.bmm`` as the library
   yardstick; the kernel's share of its bound and its ratio to the library,
   and a second turn of kernel, library, library, kernel in the same call;
6. mempool_alloc — N = 1, 5 (the device feed's block at 8,192 rows), 1,024,
   1,025, 1,000,000 and 2**23: kernel == plain version bit for bit; times,
   bound, ``torch.cumsum`` of the aligned sizes as the library yardstick,
   at N = 1,000,000 a second turn of kernel, library, library, kernel in
   the same call, and the host entry ``plan_block`` and
   ``ArenaPool.alloc_block`` per call. The share of the byte bound and the
   ratio to ``torch.cumsum`` are read at N = 2**23 with the sizes rotated
   over at least 3 blocks and 150 MB, past the L2; a share above 100 %
   fails the phase;
7. serving, full width — ``dlrm-mlperf`` with every vocabulary capped at
   10,000,000 rows (a 25.8 GiB fp32 table on the card; the full Criteo-1TB
   table is 89.5 GiB and does not fit in 80 GB), weights from a seeded
   ``torch.Generator``, 8 requests of 512 rows through ``FeaturePlan.run`` ->
   ``ModelFeed.apply`` -> ``serve_step``: pCTR finite and in (0, 1), the
   kernels launched 2 and 1 times per batch, and the first batch equal to
   the same path with every kernel swapped for its plain version (atol 1e-5);
8. training, full width — the same capped ``dlrm-mlperf``, 8,192 rows per
   step, through ``FeaturePlan.run`` -> ``DeviceFeeder.stage`` ->
   ``ModelFeed.make_step(make_sparse_train_step(cfg, adamw(1e-3)))``: staged
   slots bit-equal to the plan's output and to the plan's output with
   ``feature_hash`` swapped for its plain version; on the first batch the
   kernel path against the plain path (interaction forward and backward
   swapped for autograd of the plain forward) — loss within rtol 1e-5, working-row
   gradients within 1e-5 of the largest and not zero, updated working rows
   within 1e-6; then 1 warm-up and 8 timed steps with finite losses,
   launches per step (feature_hash 2, interaction forward 1, backward 1,
   mempool_alloc 1 per staged batch, ws_grad 1), ms per step with its breakdown, and
   the device's idle share under the profiler; the device reads of one
   step's function under ``SyncRecorder``: the loss alone, where
   ``scatter_rows`` in its old 0-d index form adds six;
9. embedding_bag — the JAX package's six test shapes and the training
   batch's interest bag (B = 8,192 rows, L = 16 ``batch_seq_ids`` deduped
   into a working set of U rows, weights ``batch_seq_mask``, D = 128):
   kernel == plain version for L = 1, else within 1e-5 of the largest
   output; device and call times, the byte bound, the plain version and
   ``F.embedding_bag`` as the library yardstick (the byte bound counts
   each distinct row that a live slot reads once); one ``bag_lookup`` call
   at the full-width shape is the launch count of its path. The share of
   the bound and the ratio to ``F.embedding_bag`` are read at B = 65,536,
   L = 16, U = 2**20 (a 512 MiB table), D = 128, uniform ids with 80 % of
   slots live, ids and weights rotated over 3 blocks: past the L2; a share
   above 100 % fails the phase;
10. streaming, full width — the main path: ``launch.train.run_streaming``
   (``--device-feed arena``) over 10 raw-log shards of 8,192 rows written
   by ``write_log_shards``: shard readers, the FE worker on its own stream,
   the feeder thread writing FE output into the arena, the sparse step.
   One warm-up step (its loss equal to the slice-2 plain loop's on the
   same first shard with the same params, rtol 1e-6), then runs of 8
   steps in turns with a serial loop that does the runner's work in one
   thread (the same loader, arena feed and step; order serial, stream,
   stream, serial, serial, stream), then two of each with the
   interpreter's switch interval cut to 0.5 ms (the GIL probe): losses
   finite, launches per step equal to the plain loop's, wall ms per step
   (the runner's ``wall_seconds``; the serial loop's from its first read
   to its last sync), the runner's FE / train / wall seconds and overlap,
   the feed's counts, and each loop's device idle share under the
   profiler over steps 2-9 of one 10-step epoch, and at its unprofiled
   wall; then the driver with its defaults, ``--adapt eager`` and
   ``--no-donate`` (``streaming_flags``: vocabularies capped at
   ``FLAG_VOCAB_CAP``, each run from the same seeded state over the same
   shards): losses bit for bit the default's, launches per step the
   default's, the adaptation's dispatches and host seconds a step, the
   feed's donated and fresh arenas, each run's peak allocated; then a
   checkpoint round trip at the smoke config.
11. hierarchy, full width — ``run_streaming`` with ``--embedding hierarchy``
   (``--device-feed on``, ``--host-cache-rows 100000``, the JAX driver's
   default): the hierarchical PS's file (SSD tier) <- host row cache <-
   the working set on the card, the ps-feeder thread pulling batch i+1's
   rows while batch i trains, the write-back pushing them after the step.
   ``dlrm-mlperf`` at full width with every vocabulary capped at 2,000,000
   rows: a PS file of 13,110,446 rows x 129 fp32 (6.3 GiB) in a temporary
   directory, its init timed. 10 shards of 8,192 rows; runs of 8 steps in
   turns (hierarchy, table, table, hierarchy) with ``--embedding table``
   started from the same rows (loaded onto the card from the PS file) and
   the same dense params: ms per step, the PS stats per step (pull, wait
   and push seconds, fixups, host hit rate, SSD reads, evictions),
   launches per step (feature_hash 2, interaction_dot forward 1 and
   backward 1, mempool_alloc 1 per staged batch), and each backend's
   device idle share under the profiler. The two backends' losses (the
   first step's exactly, all within rtol ``HIER_LOSS_RTOL``) and, after
   each pair of turns, every row of the PS file against the table (rows
   within ``HIER_ROW_ATOL``, accumulators within rtol ``HIER_ACCUM_RTOL``;
   the rows touched and the rows not bit-equal counted).
12. JAX curves — the eleven smoke curves of ``tests/data/jax_loss_curves.npz``
   (written by ``tests/jax_curves.py`` with JAX on the CPU; read here with
   numpy alone, through ``tests/curve_fixture.py``): from JAX's init
   params, the streaming driver's chains of ``dlrm-mlperf`` and ``bst``
   (``--spec dlrm`` or ``--spec bst``, ``--device-feed arena
   --fault-tolerant`` over the shards the port's ``write_log_shards``
   writes with the curve's seed and sizes) and the in-memory driver's
   chain of ``dlrm-mlperf``, ``dcn-v2``, ``autoint``, ``bst``, ``yi-9b``,
   ``qwen2.5-14b``, ``deepseek-moe-16b``, ``deepseek-v2-236b`` and
   ``pna``, 24 steps each at the smoke configs, every loss within
   ``CURVE_RTOL`` of JAX's, and each chain's launches (none on the LM and
   PNA chains); and ``full/pna``, published PNA on a Cora-size graph, 5
   steps of full-graph training. The PNA chains are chaotic: their first
   loss within rtol 1e-5, every loss within ``curve_fixture.PNA_RTOL``
   (from ``tests/rehearse_pna.py``);
13. in-memory, full width — ``run_in_memory`` (``run_training`` over
   ``synthetic_batch`` with the sparse step, the JAX driver's default path)
   for ``dlrm-mlperf`` (capped as in phase 7), ``dcn-v2`` (published,
   uncapped: 187,767,808 rows x 16) and ``autoint`` (published), one after
   another, each freed before the next, at 8,192 rows per step: the first
   step against the CPU on the same params and batch (loss, dense and
   working-row gradients within the ``FIRST_*`` bounds), 1 warm-up and 8
   timed steps (ms per step, losses, launches per step: ``interaction_dot``
   1 and 1 for ``dlrm-mlperf``, none for the others; ``ws_grad`` 1 for all), the device idle share
   at the unprofiled wall, 8 serving batches of 512 rows through
   ``serve_step`` (p50, p99 as the max of 8, logits against the CPU's within
   ``LOGIT_TOL``, the share of pCTRs inside (1e-6, 1 - 1e-6)) and the peak
   memory;
14. BST, published width (arXiv:1905.06874: 5,010,432 padded rows x 32 =
   0.60 GiB), after every earlier phase has freed its table: the fixture's
   ``full/bst`` curve (8 steps of 8,192 rows from ``numpy_params``, the
   first loss within ``FULL_FIRST_RTOL`` of JAX's and every loss within
   ``FULL_RTOL``); the in-memory driver as in phase 13 (the first step
   against the CPU with the heavy rows' bounds beside their |g|, 1 warm-up
   and 8 timed steps, the idle share, no kernel launched but ``ws_grad``
   once a step); the streaming
   driver with ``--spec bst --device-feed arena --fault-tolerant`` over 8
   shards of 8,192 rows (the first loss against the plain loop's,
   ``feature_hash`` and ``mempool_alloc`` once per batch); 8 requests of
   512 raw rows through the ``bst`` spec (p50, p99 as the max of 8, logits
   against the CPU's within ``LOGIT_TOL``, ``feature_hash`` once per
   request); one user against 10^6 candidates in one ``retrieval_score``
   call (median of 3, the first 512 scores against the same candidates
   scored alone within 1e-5, 512 candidates spread over the range against
   the CPU's scores within ``LOGIT_TOL`` through sigmoid's slope); the peak
   memory of each part;
15. traced streaming, full width — phase 10's cell with the tracer on
   (``launch.train.run_streaming``, ``--device-feed arena
   --fault-tolerant``, 8 steps, after one untraced run of it and of the
   serial loop): the exported trace gated by ``python -m
   repro_torch.obs.validate --require-tracks 4 --require-overlap fe.
   train.``, the ``fe.layer`` spans on the FE worker's track, the launches;
   then the serial loop traced the same way (no requirement on its
   tracks); for each thread of either run, its wall time split into queue
   waits (time in ``queue.Queue.get``/``put``, the tracer's wait spans
   beside it), CUDA syncs and copies (the profiler's runtime calls on that
   thread), CPU time (``/proc/self/task/<id>/stat``) and the rest;
16. mesh, full width — phase 10's cell trained by the mesh step at 1x1 on
   an NCCL group of one (``--mesh 1x1 --compress off``) in turns with the
   sparse step from the same params (sparse, mesh, mesh, sparse; 8 steps a
   run): every loss, param, Adam moment and accumulator bit for bit, ms
   per step of both, the launches of the mesh path (``feature_hash`` 2,
   ``interaction_dot`` 1 and 1 per step, ``mempool_alloc`` 1 per staged
   batch); then ``--compress bf16`` and ``int8`` over the same 16 steps
   from the same params: after one step every element of every touched
   row within the codec's wire error carried through Adagrad, after 16
   the largest drift of an embedding row from the uncompressed run within
   ``MESH_DRIFT_BOUND`` (from ``tests/rehearse_mesh.py``), the dense
   drift beside it, the residual non-zero, the comm
   stats' bytes those of ``CommPlan.for_step`` from the shapes, and the
   codec's encode time per step on the device under the profiler. Between
   the two, the mesh run again under ``--fault-tolerant --chaos
   kill@1:read,transient@2:read:1 --lease-timeout 0.2`` (``MESH_CHAOS``):
   its losses bit for bit the run without chaos, its launches the same,
   and its ``chaos: fired`` line the schedule's.
17. check and cost — ``run_check`` on the card for ``ads_ctr`` x
   ``dlrm-mlperf``, ``dlrm`` x ``dlrm-mlperf`` and ``bst`` x ``bst``: exit
   0, ``mempool_alloc`` launched twice each (the aliasing tri-oracle's
   kernel planner, packed and split layouts), findings equal to the same
   call with ``device="cpu"``; three mutants that must fail (one offset of
   the kernel's plan moved by 128: AL204; an ``.item()`` in a fused FE
   layer: EF301; ``scatter_rows`` in its old 0-d index form in the sparse
   step: EF303); a hand-built layout of 20,000 slots, past the kernel's
   8,192-request tile, clean; a 130-op hash program at 8,192 rows in three
   launches, equal to ``hash_layer_ref``, and a 130-op layer clean through
   ``verify_plan``; ``verify_plan``, ``verify_model_feed`` and
   ``scan_preset`` on the capped ``dlrm-mlperf`` at 8,192 rows with
   ``torch.cuda.memory_allocated`` unchanged; ``step_cost`` of that step
   equal to :func:`dlrm_step_flops`, its achieved TFLOP/s over phase 8's
   step time; and the streaming driver with ``--check --metrics`` over 4
   shards of 8,192 rows: the registry's ``check``, ``hlo`` and
   ``pipeline`` tiers, ``hlo.flops`` the formula's, the losses bit for bit
   those of the same run without the flags, launches the same plus the
   preflight's two planner runs.
18. the dense LM family at yi-9b's published width (arXiv:2403.04652; 48
   layers, d 4096, 32 heads over 4 KV heads, d_ff 11,008, vocab 64,000,
   bf16, weights from a seeded ``torch.Generator``), every line with the
   card's name and power limit: ``flash_attention`` in fp32 against
   ``attention_ref`` in float64 at ``LM_FLASH_SHAPES`` (causal and not,
   GQA groups 8 and 1, S not a multiple of the block), forward and dq, dk,
   dv within ``FLASH64_TOL``, its bf16 forward timed beside SDPA's (off
   the path); at 48 layers greedy decode after two 16-token prompts, each
   step's logits against ``prefill`` of the prefix within
   ``LM_DECODE_TOL``, a prefill of 1 x 32,768 tokens (ms, tokens/s, peak
   GiB) and decode of 8 sequences against a 32,768-slot cache (ms a step);
   the first training step at 1 layer of full width, card bf16 against the
   CPU in fp32 from the same params (loss, each gradient norm); training
   at 16 of 48 layers, AdamW and ``grad_accum`` 8 through the in-memory
   driver (1 + 4 steps of 64 x 64 tokens: losses falling, ms a step, peak
   GiB; the executed FLOPs of ``step_cost`` and the model FLOPs, each over
   the step time, against the dense bf16 peak), then the train_4k shape
   (8 x 4,096 tokens), timed at its second step; no kernel launched on any
   LM path. The bounds come from
   ``tests/rehearse_lm.py``.
19. the MoE LMs and PNA, every line with the card's name and power limit:
   deepseek-moe-16b (arXiv:2401.06066) at its published width and all 28
   layers, and deepseek-v2-236b (arXiv:2405.04434) at its published width
   and ``MLA_LAYERS`` = 5 (1 dense + 4 MoE) of 60, bf16, weights from a
   seeded ``torch.Generator``: greedy decode against ``prefill`` at the
   capacity factor where nothing drops (``n_experts / top_k``; ROADMAP
   C25) within ``MOE_DECODE_TOL``, with the ``(token, layer)`` routes that
   flip between them (C26); a prefill of 1 x 32,768 tokens and decode of
   ``MOE_DECODE_BATCH`` sequences against 32,768 slots at the published
   factor (ms, tokens/s, peak GiB, the pairs the capacity drops, executed
   and model FLOPs over the time); deepseek-moe-16b's first step at 1
   dense + 1 MoE layer, card bf16 against the CPU in fp32 (loss and
   gradient norms within ``MOE_FIRST_*``, the flipped routes), then
   training at 1 dense + 3 MoE layers through the in-memory driver (1 + 4
   steps of 64 x 64 tokens, losses falling) and the train_4k shape, as
   phase 18; PNA at its published width (4 layers, d_hidden 75) on three
   ``GNN_SHAPES``: ``full_graph_sm`` (Cora's sizes), ``molecule`` (128
   graphs) and ``minibatch_lg`` (1,024 seeds, fanouts (15, 10), a
   ``NeighborSampler`` subgraph of a synthetic graph of Reddit's 232,965
   nodes a step, the loss masked to the seeds), each's first step in fp32
   against float64 on the card within ``PNA_FIRST_*``, then AdamW steps
   (ms, losses, peak, the sampler's host ms, FLOPs); no kernel launched on
   any of these paths. The bounds come from ``tests/rehearse_lm.py`` and
   ``tests/rehearse_pna.py``.
20. dry run — ``repro_torch.launch.dryrun``: (a) every cell of
   ``tests/test_configs.py``'s variant list built on both production
   meshes (16x16 and 2x16x16, abstract): at least 50 built each, the skips
   ``long_500k``'s, and each arch's largest per-device
   ``state_bytes_exact`` against the card's ``total_memory``; (b) the CLI
   ``python -m repro_torch.launch.dryrun --arch pna --both-meshes`` in a
   subprocess: exit 0 and 8 records ``ok`` with the state bytes of (a);
   (c) the ``DRYRUN_CELLS`` at a 1x1 mesh, materialised on the card
   (``materialize``: params from ``init_params``, ids in range) and run
   once as a warm-up and once measured (``measure_on_device``): the
   materialised bytes equal ``state_bytes_exact``, their allocation within
   the allocator's slack, the measured transient peak above the predicted
   one (``step_peak_bytes`` less the arguments) by 0 to
   ``transient_bound`` (the bound PERF.md stated before the first run),
   the wall ms and ``step_flops`` over it, and no kernel launched but the
   sparse step's ``ws_grad``, once in each of the two calls of each
   recsys ``train_batch`` cell; (d) ``DRYRUN_OVER``, reported
   from the dry run alone as over one card and not run; (e) one device's
   figures: rank 0 of every cell with a per-device call (the LM cells and
   PNA's node-sharded shapes) on both meshes, on meta under a fake process
   group of 256 or 512 (``dryrun.per_device_record``), started before
   phase 1 in ``DRYRUN_WORKERS`` spawned processes at nice 19 and
   collected here: per cell its seconds, FLOPs, op bytes, peak, argument
   bytes and collective bytes by kind (each figured cell with FLOPs,
   collectives and a peak above its arguments; every LM ``train_4k`` and
   ``pna x ogb_products`` on both meshes figured, qwen2.5-32b's and
   deepseek-v2-236b's ``train_4k`` on 2x16x16 with their 16 rows a
   microbatch over 32 data ranks among them; a cell the mesh form cannot
   take says so); (f) rank 0 of the first
   ``DRYRUN_RANK_RUNS`` of ``DRYRUN_RANK_CELLS`` on 16x16 whose predicted
   peak fits ``DRYRUN_FIT``, on the card (``measure_rank_on_device``: its
   shards drawn there, one warm-up and one measured step under a fake
   group of 256 on ``cuda``, one rank's compute with no communication;
   qwen2.5-32b's ``decode_32k`` among them, its cache the ``cache_specs``
   block), and rank 0 of ``DRYRUN_MULTI_POD_CELL`` (qwen2.5-32b's
   ``train_4k`` on 2x16x16, one row a microbatch) under a fake group of
   512 where its predicted peak fits (else the line says why not): the
   drawn bytes equal ``per_device_arg_bytes``, the transient
   peak off the per-device prediction by ``-step_functional_per_device``
   to ``transient_bound``, the wall ms, and no kernel launched.
21. model parallel — the mesh forms of ``launch/mesh.py`` and
   ``models/{moe,gnn,transformer}.py``, every line with the card's name and
   power limit, fp32 with TF32 off: (a) on a 1x1 model mesh (an NCCL group
   of one): deepseek-moe-16b at 1 dense + 1 MoE layer of full width, one
   ``make_train_step(mesh=)`` step against the ``mesh=None`` step from the
   same params at its routes (the loss and every gradient, never updated
   params, ROADMAP C6; the route flips beside it), ``serve_step(mesh=)``
   against the plain decode at ``no_drop``'s factor and the plain step's
   routes (C25, C26), PNA's ``forward_sharded`` and node-sharded step on
   ``full_graph_sm`` in float64 against ``forward`` and the plain step;
   (b) the rank bodies in turn at full width (one process drives one
   card; NCCL refuses two ranks on it): deepseek-v2-236b's MoE layer (160
   experts, ``shard_ff_over_data``) as the eight bodies of a 2x4 mesh
   against ``moe_ffn`` on each data shard, one yi-9b layer as tp=4
   column/row bodies against the layer, and the split decode: one layer
   each of yi-9b at tp=4, qwen2.5-32b at tp=16 (40 heads do not split)
   and deepseek-v2-236b's MLA at tp=4, 8 rows against 32,768 slots, as
   the attention bodies in turn (their gathers concatenations, their
   psums sums in rank order) each against its ``cache_specs`` block,
   against the global decode of the layer (on ``y - x``) and the blocks'
   written slot against the global cache's, cut by ``cache_specs``; (c) PNA's forward on
   ``ogb_products`` at its published size (2,449,029 nodes padded to a
   multiple of 8, 61,859,140 edges, ``partition_edges`` on the host) as 8
   node-shard bodies in turn, each layer's 512 sampled destination nodes
   recomputed in float64 on the host from the card's previous layer, the
   ms a layer and the peak allocated and reserved GiB (C27). The bounds
   come from ``tests/rehearse_model_parallel.py``.
22. examples — the port's five examples (``repro_torch.examples``) through
   their ``main`` on the card (``EXAMPLE_RUNS``): ``stream_train`` for the
   ``ads_ctr``, ``dlrm`` and ``bst`` specs with ``--device-feed on`` and
   ``ads_ctr`` with ``off`` (8 shards of 1,024 rows), ``quickstart``,
   ``serve_ctr --requests 1024``, ``train_ctr_e2e --steps 100`` (reduced
   from 300; its 409.6 MB PS file in a temporary directory) and
   ``mesh_train --mesh 1x1`` (one card, one NCCL rank): each run's ``OK``
   line, its wall time and its launches, each counted from 0: at least one
   ``feature_hash`` launch in each, ``mempool_alloc`` in the ``on`` runs,
   ``interaction_dot`` forward and backward in ``mesh_train``, and one
   ``embedding_bag`` launch a request batch in ``serve_ctr`` (its scoring
   pass pools the behaviour sequence with ``bag_lookup``); ``serve_ctr``'s
   pCTRs in (0, 1), its p50 and p99, and on its last request batch (B =
   256, L = 48, its warmed 65,536 x 16 table) the kernel's pooling against
   the plain version within ``sum_order_bound`` (two fp32 summation orders
   over L), both timed there beside the bound and ``F.embedding_bag``.
23. ws_grad (run after phase 5) — the working set's gradient kernels
   (``kernels/ws_grad``, the backward of ``gather_rows``) on the ids of the
   benchmark's ``dlrm-mlperf.train-zipf`` cell, drawn by ``portbench``'s
   traffic generator (power law 1.05; the vocabulary-3 field's first id
   takes half the rows) and deduped as the step does, D = 128: at the
   sparse step's 8,192 rows (N = cap = 212,992), with the same working set
   cut to half its slots and every 97th position -2**31 (what the
   hierarchy's capped working set gives), and at the cell's 65,536 rows
   (N = cap = 1,703,936): every element within (min(c, 128) + ceil(c /
   128) + 1) 2^-24 S of ``ws_grad_ref`` in float64 (c terms, S their
   absolute sum), every unreferenced slot exactly 0 over NaN-filled
   memory, two calls bit-equal, one launch a call; at 8,192 and 65,536
   rows the op's device and call times (keys, sort and sums), the
   ``ws_grad_`` kernels' time by name under the profiler, the byte bound
   4 (N D + cap D + 2 N) and the kernels' share of it (above 105 % fails
   the phase), ``ws_grad_ref`` as the plain version and autograd's index
   backward through ``take_rows`` (the path it replaced) as the library
   yardstick.

The line before the last is the ``kernels`` JSON record. Each kernel's
record gives its launches on the streaming path (``embedding_bag``: on
``serve_ctr``'s scoring path, phase 22) and its times at that path's shape
(8,192 rows; N = 5 for ``mempool_alloc``; ``embedding_bag`` at phase 9's
training-batch bag, and at ``serve_ctr``'s shape under
``serve_ctr_*``; ``ws_grad`` also at the training cell's shape under
``cell_*``), with every path's launches under
``launches_by_path`` (``check``: phase 17's three ``run_check`` calls),
and, for the kernels whose bound is read past the L2,
``share_of_bound`` with its ``share_of_bound_shape``; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout
of the repository, it exits non-zero and prints no result.

  python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper), dense, at 700 W.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12                      # FMA counted as 2, outside the tensor cores
INT32_OPS = 132 * 64 * 1.98e9           # 64 INT32 lanes per SM x 132 SMs x 1.98 GHz
# 32-bit integer operations per row of each feature_hash op (modulo as one):
# fmix32 is 3 shifts + 3 xors + 2 multiplies.
HASH_OPS_PER_ROW = {"cross": 2 * 8 + 3, "hash": 8 + 1, "mod": 3}

VOCAB_CAP = 10_000_000
BATCH = 512                             # serve_p99 request batch of the JAX configs
N_BATCHES = 8
LARGE_B = 65_536                        # the interaction kernels' large-batch check
TRAIN_ROWS = 8192                       # per-card share of a 65,536-row global batch on 8 cards
TRAIN_STEPS = 8                         # timed, after one warm-up step
STREAM_SHARDS = 10                      # raw-log shards of TRAIN_ROWS rows for the streaming path
# the driver's --adapt eager / --no-donate runs beside the default: vocabularies
# capped lower (13.86 GiB of table): without donation the driver holds the run's
# first params, the step's input and its clone, three tables at once
FLAG_VOCAB_CAP = 5_000_000
HIER_VOCAB_CAP = 2_000_000              # the hierarchy phase's vocabularies (its PS file's init time)
HIER_HOST_CACHE_ROWS = 100_000          # --host-cache-rows default of the JAX driver
# the hierarchy and table backends run the same ops on the same values, so
# the first loss is equal; from step 2 on the rows may differ in the last bits
# if a reduction adds in another order (the working-set gather's index
# backward, ROADMAP C14), which Adam and the first steps' loss swings widen
# (rehearsed on the CPU, where threaded reductions reorder: after 16 steps up
# to 1.9e-5 in the losses, 1.7e-6 in the rows, 1.6e-5 in the accumulators)
HIER_LOSS_RTOL = 1e-4
HIER_ROW_ATOL = 1e-5                    # rows are uniform in +-1/sqrt(128) = +-0.088
HIER_ACCUM_RTOL = 1e-4
BAG_SHAPES = ((4, 3, 10, 8), (300, 16, 700, 64), (256, 48, 512, 128),   # the JAX package's
              (33, 5, 1, 16), (1, 1, 2, 8), (1024, 4, 2000, 32))        # tests: (B, L, U, D)
ALLOC_NS = (1, 5, 1024, 1025, 1_000_000)  # mempool_alloc request counts checked and timed
ALLOC_HBM_N = 1 << 23                   # mempool_alloc's HBM bound is read at this N
BAG_HBM_SHAPE = (65_536, 16, 1 << 20, 128)  # embedding_bag's (B, L, U, D), a 512 MiB table
WS_GRAD_CELL = "dlrm-mlperf.train-zipf"   # phase 23 draws its ids with this cell's traffic
WS_GRAD_SEED = 4_053_559_201            # phase 23's ids and gradient
LR = 1e-3                               # --lr default of the JAX package's launch/train.py
HBM_ROWS = 1 << 20                      # feature_hash's HBM bound is read at this N,
HBM_ROTATION_BYTES = 150e6              # its inputs rotated over >= 3 blocks and this many bytes
TIMING_GROUPS = 21                      # times are medians over 21 groups
CALLS_PER_GROUP = 10                    # of 10 calls each
SLEEP_CYCLES_PER_S = 1.98e9             # torch.cuda._sleep counts SM clock cycles


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _median_ms(torch, fn, groups: int, per: int) -> float:
    """Median over ``groups`` groups of ``per`` calls each of the time per
    call between CUDA events recorded on the stream around each group (a
    group amortizes the event's own cost over ``per`` calls)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(groups + 1)]
    events[0].record()
    for g in range(groups):
        for _ in range(per):
            fn()
        events[g + 1].record()
    events[-1].synchronize()
    return statistics.median(events[g].elapsed_time(events[g + 1]) / per
                             for g in range(groups))


def call_ms(torch, fn, groups: int = TIMING_GROUPS, per: int = CALLS_PER_GROUP) -> float:
    """What a caller pays per call, launch overhead included: calls issued
    one after another from an idle device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _median_ms(torch, fn, groups, per)


def device_ms(torch, fn, groups: int = TIMING_GROUPS, per: int = CALLS_PER_GROUP) -> float:
    """Device time per call: the calls are queued behind a sleep kernel that
    outlasts their host time, so their kernels run back to back and the
    events between them see device work only."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    sleep_s = min(3.0 * groups * per * host_s + 1e-3, 4.0)
    torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
    return _median_ms(torch, fn, groups, per)


def timings(torch, fn, groups: int = TIMING_GROUPS, per: int = CALLS_PER_GROUP):
    return device_ms(torch, fn, groups, per), call_ms(torch, fn, groups, per)


def host_ms(fn, groups: int = TIMING_GROUPS, per: int = CALLS_PER_GROUP) -> float:
    """Median over groups of the host wall time per call (for host code and
    calls that end in their own synchronization)."""
    fn()
    times = []
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / per)
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, rate: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_feature_hash(torch, dev):
    import numpy as np
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.ops import narrow_int32
    from repro_torch.kernels.feature_hash.ops import run_hash_layer
    from repro_torch.kernels.feature_hash.ref import hash_layer_ref

    # the launch floor: the device time of a launch that does almost nothing
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = device_ms(torch, one.zero_)
    print(f"feature_hash launch floor (zero_ of one element) ms={floor_ms:.7f}")

    def share_of(what: str, b_ms: float, ms: float) -> float:
        share = b_ms / ms
        check(share <= 1.0, f"feature_hash {what}: {share:.3f} of its bound, above 100 %: "
                            "the timing or the count is wrong")
        return share

    main = dict.fromkeys(("ms", "call_ms", "plain_ms", "plain_call_ms", "bytes", "ops"), 0.0)
    pair_turns, floors = [0.0] * 3, [floor_ms]
    hbm = {}
    for field_size in (1 << 20, 1000):
        plan = featureplan.compile(get_spec("dlrm"), field_size=field_size)
        for op in ("cross_features", "sparse_ids"):
            slots, prog = plan.graph.ops[op].fn.hash_layer
            for n in (BATCH, TRAIN_ROWS, 262_144, HBM_ROWS):
                rng = np.random.default_rng(n + field_size)
                ids = rng.integers(-(2**33), 2**33, (len(slots), n)).astype(np.int64)
                ids[:, :4] = [5, -7, 2**31 + 5, 2**32 + 3]
                cols = narrow_int32(torch.from_numpy(ids).to(dev))
                got = run_hash_layer(cols, prog)
                want = hash_layer_ref(cols, program=prog)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"feature_hash {op} N={n} field_size={field_size} != plain version")
                del got, want
                nbytes = (len(slots) + len(prog)) * n * 4
                ops = sum(HASH_OPS_PER_ROW[k] for k, *_ in prog) * n
                b_ms, b_by = bound(nbytes, ops, INT32_OPS)
                head = (f"feature_hash {op:<14} K={len(slots):<2} ops={len(prog):<2} N={n:<7} "
                        f"field_size={field_size:<7} exact=True")
                if n == HBM_ROWS:
                    # each call reads a column block that the L2 no longer
                    # holds: the blocks are rotated, at least 3 of them and
                    # HBM_ROTATION_BYTES in all
                    k = max(3, math.ceil(HBM_ROTATION_BYTES / cols.nbytes))
                    blocks = [cols] + [cols.roll(4097 * r, dims=1) for r in range(1, k)]
                    rotation = itertools.cycle(blocks)
                    ms = device_ms(torch, lambda: run_hash_layer(next(rotation), prog))
                    share = share_of(f"{op} N={n}", b_ms, ms)
                    print(f"{head} ms={ms:.7f} bound_ms={b_ms:.7f} ({b_by}) "
                          f"share_of_bound={share:.3f} (inputs rotated over {k} column blocks, "
                          f"{k * cols.nbytes / 1e6:.1f} MB, past the L2) "
                          f"above_floor_ms={ms - floor_ms:.7f}")
                    if field_size == 1 << 20:
                        hbm[op] = {"ms": ms, "bound_ms": b_ms, "share_of_bound": share,
                                   "blocks": k, "mb": k * cols.nbytes / 1e6}
                    del blocks, rotation, cols
                    torch.cuda.empty_cache()
                    continue

                def kernel():
                    return run_hash_layer(cols, prog)

                ms, c_ms = timings(torch, kernel)
                # some 400 small launches per plain call: 2 calls stay inside
                # the launch queue while the sleep kernel holds the device
                plain_ms, plain_c_ms = timings(
                    torch, lambda: hash_layer_ref(cols, program=prog), groups=2, per=1)
                times = (f"ms={ms:.7f} call_ms={c_ms:.7f} plain_ms={plain_ms:.5f} "
                         f"plain_call_ms={plain_c_ms:.5f} bound_ms={b_ms:.7f} ({b_by})")
                if n == 262_144:
                    # 19-25 MB per call: the L2 keeps it from one call to the
                    # next, so no share of the HBM bound is read here
                    print(f"{head} {times} (inputs L2-resident) "
                          f"above_floor_ms={ms - floor_ms:.7f}")
                    continue
                print(f"{head} {times} share_of_bound={share_of(f'{op} N={n}', b_ms, ms):.3f} "
                      f"above_floor_ms={ms - floor_ms:.7f}")
                if n == TRAIN_ROWS and field_size == 1 << 20:
                    # a second turn in the same call: kernel, floor, floor, kernel
                    turn = [device_ms(torch, fn) for fn in (kernel, one.zero_, one.zero_, kernel)]
                    print(f"feature_hash {op:<14} N={n} turns (kernel, floor, floor, kernel after "
                          f"the first pair): kernel_ms={[ms, turn[0], turn[3]]} "
                          f"floor_ms={[floor_ms, turn[1], turn[2]]}")
                    for t, k_ms in enumerate((ms, turn[0], turn[3])):
                        pair_turns[t] += k_ms
                    floors += turn[1:3]
                    for key, val in (("ms", ms), ("call_ms", c_ms), ("plain_ms", plain_ms),
                                     ("plain_call_ms", plain_c_ms), ("bytes", nbytes),
                                     ("ops", ops)):
                        main[key] += val
    b_ms, b_by = bound(main["bytes"], main["ops"], INT32_OPS)
    print(f"feature_hash pair N={TRAIN_ROWS} field_size={1 << 20}: ms={main['ms']:.7f} "
          f"call_ms={main['call_ms']:.7f} bound_ms={b_ms:.7f} ({b_by}) "
          f"share_of_bound={share_of('pair', b_ms, main['ms']):.3f} "
          f"floor_ms={floor_ms:.7f} above_two_floors_ms={main['ms'] - 2 * floor_ms:.7f} "
          f"pair_turns_ms={pair_turns} floors_ms={floors}")
    return {"name": "feature_hash", "route": "cuda",
            "source": "src/repro_torch/csrc/feature_hash.cu",
            "replaces": "src/repro/kernels/feature_hash/kernel.py:66",
            "max_abs_err": 0, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "call_ms": main["call_ms"], "plain_call_ms": main["plain_call_ms"],
            "shape": f"N={TRAIN_ROWS}: cross_features + sparse_ids, one launch each",
            "floor_ms": floor_ms, "turns_kernel_ms": pair_turns, "turns_floor_ms": floors,
            "share_of_bound": {op: rec["share_of_bound"] for op, rec in hbm.items()},
            "share_of_bound_shape": (f"N={HBM_ROWS}, field_size={1 << 20}, inputs rotated "
                                     "past the L2: " + ", ".join(
                                         f"{op} over {rec['blocks']} column blocks "
                                         f"({rec['mb']:.1f} MB)" for op, rec in hbm.items())),
            "hbm_ms": {op: rec["ms"] for op, rec in hbm.items()},
            "hbm_bound_ms": {op: rec["bound_ms"] for op, rec in hbm.items()}}


def phase_interaction_dot(torch, dev):
    from repro_torch.kernels.interaction_dot.ops import pairwise_dots
    from repro_torch.kernels.interaction_dot.ref import dot_interaction_ref

    f, d = 27, 128
    p = f * (f - 1) // 2
    rows, cols = torch.tril_indices(f, f, -1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    record, worst = None, 0.0
    for b in (BATCH, TRAIN_ROWS, LARGE_B):
        x = torch.randn((b, f, d), generator=gen, device=dev)
        got = pairwise_dots(x)
        want = dot_interaction_ref(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = float((got - want).abs().max())
        worst = max(worst, err)

        def library():  # one batched product, then the triangle's gather
            return torch.bmm(x, x.mT)[:, rows, cols]

        ms, c_ms = timings(torch, lambda: pairwise_dots(x))
        plain_ms, plain_c_ms = timings(torch, lambda: dot_interaction_ref(x))
        library_ms, library_c_ms = timings(torch, library)
        # a second turn in the same call: kernel, library, library, kernel
        turn = [device_ms(torch, fn) for fn in (lambda: pairwise_dots(x), library, library,
                                                lambda: pairwise_dots(x))]
        kernel_ms, lib_ms = [ms, turn[0], turn[3]], [library_ms, turn[1], turn[2]]
        b_ms, b_by = bound(b * f * d * 4 + b * p * 4, 2 * b * p * d, FP32_FLOPS)
        print(f"interaction_dot B={b:<6} F={f} D={d} max_abs_err={err:.3e} ms={ms:.5f} "
              f"call_ms={c_ms:.5f} plain_ms={plain_ms:.5f} plain_call_ms={plain_c_ms:.5f} "
              f"library_ms={library_ms:.5f} library_call_ms={library_c_ms:.5f} "
              f"bound_ms={b_ms:.6f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.3f} vs_library={ms / library_ms:.3f}")
        print(f"interaction_dot B={b:<6} turns (kernel, library, library, kernel "
              f"after the first pair): kernel_ms={[round(t, 7) for t in kernel_ms]} "
              f"library_ms={[round(t, 7) for t in lib_ms]} "
              f"kernel_below_library_in_every_turn={max(kernel_ms) < min(lib_ms)}")
        if b == TRAIN_ROWS:
            record = {"name": "interaction_dot", "route": "cuda",
                      "source": "src/repro_torch/csrc/interaction_dot.cu",
                      "replaces": "src/repro/kernels/interaction_dot/kernel.py:43",
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library_ms, "call_ms": c_ms,
                      "plain_call_ms": plain_c_ms, "library_call_ms": library_c_ms,
                      "shape": f"B={b} F={f} D={d}",
                      "share_of_bound": b_ms / ms, "vs_library": ms / library_ms,
                      "turns_kernel_ms": kernel_ms, "turns_library_ms": lib_ms}
        del x, got, want
    record["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return record


def phase_interaction_bwd(torch, dev):
    from repro_torch.kernels.interaction_dot.ops import pairwise_dots_backward
    from repro_torch.kernels.interaction_dot.ref import dot_interaction_bwd_ref

    f, d = 27, 128
    p = f * (f - 1) // 2
    rows, cols = torch.tril_indices(f, f, -1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    record, worst = None, 0.0
    for b in (TRAIN_ROWS, LARGE_B):
        x = torch.randn((b, f, d), generator=gen, device=dev)
        dy = torch.randn((b, p), generator=gen, device=dev)
        got = pairwise_dots_backward(x, dy)
        want = dot_interaction_bwd_ref(x, dy)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= 1e-5 * scale,
              f"interaction_dot backward B={b}: max abs err {err} > 1e-5 x {scale}")
        worst = max(worst, err)

        def library():  # scatter dy into G, then one batched product
            g = torch.zeros((b, f, f), device=dev)
            g[:, rows, cols] = dy
            return torch.bmm(g + g.mT, x)

        ms, c_ms = timings(torch, lambda: pairwise_dots_backward(x, dy))
        plain_ms, plain_c_ms = timings(torch, lambda: dot_interaction_bwd_ref(x, dy))
        library_ms, library_c_ms = timings(torch, library)
        # a second turn in the same call: kernel, library, library, kernel
        turn = [device_ms(torch, fn) for fn in (lambda: pairwise_dots_backward(x, dy),
                                                library, library,
                                                lambda: pairwise_dots_backward(x, dy))]
        kernel_ms, lib_ms = [ms, turn[0], turn[3]], [library_ms, turn[1], turn[2]]
        b_ms, b_by = bound(b * (2 * f * d + p) * 4, 2 * b * f * (f - 1) * d, FP32_FLOPS)
        print(f"interaction_dot_backward B={b:<6} F={f} D={d} max_abs_err={err:.3e} "
              f"max_abs_grad={scale:.3e} ms={ms:.5f} call_ms={c_ms:.5f} plain_ms={plain_ms:.5f} "
              f"plain_call_ms={plain_c_ms:.5f} library_ms={library_ms:.5f} "
              f"library_call_ms={library_c_ms:.5f} bound_ms={b_ms:.6f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.3f} vs_library={ms / library_ms:.3f}")
        print(f"interaction_dot_backward B={b:<6} turns (kernel, library, library, kernel "
              f"after the first pair): kernel_ms={[round(t, 7) for t in kernel_ms]} "
              f"library_ms={[round(t, 7) for t in lib_ms]} "
              f"kernel_below_library_in_every_turn={max(kernel_ms) < min(lib_ms)}")
        if b == TRAIN_ROWS:
            record = {"name": "interaction_dot_backward", "route": "cuda",
                      "source": "src/repro_torch/csrc/interaction_dot.cu",
                      "replaces": "src/repro/kernels/interaction_dot/kernel.py:43",
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms, "call_ms": c_ms, "plain_call_ms": plain_c_ms,
                      "library_call_ms": library_c_ms, "shape": f"B={b} F={f} D={d}",
                      "share_of_bound": b_ms / ms, "vs_library": ms / library_ms,
                      "turns_kernel_ms": kernel_ms, "turns_library_ms": lib_ms}
        del x, dy, got, want
    record["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return record


def ws_grad_inputs(torch, rows, dev, seed: int):
    """(g f32[N, 128], inverse int32[N], cap = N): the benchmark's training
    cell's ids at ``rows`` rows (the cell's own when None), drawn by
    ``portbench``'s traffic generator over its ``dlrm-mlperf``
    vocabularies and deduped into N slots, as the step's default capacity
    does, and a seeded gradient of the gathered rows."""
    from portbench import spec as bench_spec
    from portbench import traffic, weights
    from repro_torch.embedding.dedup import dedup

    cell = bench_spec.load_cell(WS_GRAD_CELL, bench_spec.load_benchmark(ROOT))
    mix = dict(cell.mix, rows=rows or cell.mix["rows"], batches=1)
    sparse = traffic.make_batches(cell.config, mix, seed, dev)[0]["sparse"]
    ids = traffic.global_ids(cell.config, sparse.to(dev), weights.offsets(cell.config))
    n = ids.numel()
    _, inverse, _ = dedup(ids.reshape(-1), capacity=n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((n, int(cell.config["embed_dim"])), generator=gen, device=dev)
    return g, inverse, n


def ws_grad_against_float64(torch, got, g, inverse, cap):
    """The kernels' bound against the float64 segment sum (``ws_grad_ref``
    on the same inputs in float64): slot s and column j of c terms within
    (min(c, CHUNK) + ceil(c / CHUNK) + 1) 2^-24 S_sj, S_sj the sum of |g|
    over its terms; a slot with no term exactly 0. Returns the worst error
    over its bound, the distinct slots and the longest run."""
    from repro_torch.kernels.ws_grad.ops import CHUNK
    from repro_torch.kernels.ws_grad.ref import ws_grad_ref

    idx = inverse.to(torch.int64)
    valid = (idx >= -cap) & (idx < cap)
    c = torch.bincount(torch.where(idx < 0, idx + cap, idx)[valid],
                       minlength=cap).to(torch.float64)[:, None]
    s = ws_grad_ref(g.double().abs(), inverse, cap)
    bound64 = (c.clamp_max(CHUNK) + torch.ceil(c / CHUNK) + 1) * 2.0**-24 * s
    del s
    ratio = (got.double() - ws_grad_ref(g.double(), inverse, cap)).abs_().div_(
        bound64.clamp_min_(1e-300))
    worst = float(ratio.max())
    empty = c[:, 0] == 0
    check(bool((got[empty] == 0).all()), "ws_grad: an unreferenced slot is not 0")
    check(worst <= 1.0, f"ws_grad against float64: worst error {worst:.3f}x its bound")
    return worst, int((~empty).sum()), int(c.max())


def _kernel_ms(torch, fn, reps: int = 5):
    """Device ms a call of each kernel name under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] += e.time_range.elapsed_us() / 1e3 / reps
    return out


def phase_ws_grad(torch, dev):
    """Phase 23: the working set's gradient kernels (``kernels/ws_grad``)
    at the sparse step's shape and at the training cell's."""
    from repro_torch.embedding.dedup import take_rows
    from repro_torch.kernels.ws_grad.ops import gather_rows, ws_grad
    from repro_torch.kernels.ws_grad.ref import ws_grad_ref

    t_phase = time.perf_counter()
    record = None
    for rows, tag in ((TRAIN_ROWS, "path"), (TRAIN_ROWS, "overflow"), (None, "cell")):
        g, inverse, cap = ws_grad_inputs(torch, rows, dev, WS_GRAD_SEED)
        if tag == "overflow":       # the hierarchy's working set: cap < unique, -2**31 dropped
            cap = int(inverse.max()) // 2
            inverse[::97] = -(2**31)
        n, d = g.shape
        junk = torch.full((2 * cap * d,), math.nan, device=dev)   # every row must be written
        del junk
        before = gather_rows.launches
        got = ws_grad(g, inverse, cap)
        again = ws_grad(g, inverse, cap)
        torch.cuda.synchronize()
        check(gather_rows.launches == before + 2,
              f"ws_grad {tag}: {gather_rows.launches - before} launches for 2 calls")
        check(torch.equal(got, again), f"ws_grad {tag}: two calls differ")
        del again
        worst, distinct, longest = ws_grad_against_float64(torch, got, g, inverse, cap)
        del got
        torch.cuda.empty_cache()
        shape = f"N={n} cap={cap} D={d}"
        print(f"ws_grad {tag} [{CARD}] {WS_GRAD_CELL}'s ids, {shape}, {distinct:,} distinct "
              f"slots, longest run {longest:,}: "
              f"worst error {worst:.4f} of its bound against float64; two calls bit-equal; "
              f"unreferenced slots 0")
        if tag == "overflow":
            del g, inverse
            continue

        rows_leaf = torch.zeros((cap, d), device=dev, requires_grad=True)
        out = take_rows(rows_leaf, inverse)

        def library():  # autograd's index backward through take_rows (the parent's path)
            return torch.autograd.grad(out, rows_leaf, g, retain_graph=True)

        ms, c_ms = timings(torch, lambda: ws_grad(g, inverse, cap))
        plain_ms, plain_c_ms = timings(torch, lambda: ws_grad_ref(g, inverse, cap), 7, 2)
        library_ms, library_c_ms = timings(torch, library, 7, 2)
        by_name = _kernel_ms(torch, lambda: ws_grad(g, inverse, cap))
        kernels_ms = sum(t for k, t in by_name.items() if "ws_grad_" in k)
        lib_by_name = _kernel_ms(torch, library, 2)
        index_ms = sum(t for k, t in lib_by_name.items() if "indexing_backward" in k)
        b_ms, b_by = bound(4 * (n * d + cap * d + 2 * n), 0, FP32_FLOPS)
        print(f"ws_grad {tag} [{CARD}] {shape}: ms={ms:.7f} call_ms={c_ms:.7f} "
              f"ws_grad_kernels_ms={kernels_ms:.7f} "
              + " ".join(f"{k[:60]}={t:.7f}" for k, t in by_name.most_common(6))
              + f" plain_ms={plain_ms:.7f} plain_call_ms={plain_c_ms:.7f} "
              f"library_ms={library_ms:.7f} library_call_ms={library_c_ms:.7f} "
              f"(indexing_backward_kernel {index_ms:.7f}) bound_ms={b_ms:.7f} ({b_by}) "
              f"kernels_share_of_bound={b_ms / kernels_ms:.4f} op_share_of_bound={b_ms / ms:.4f} "
              f"vs_library={ms / library_ms:.4f}")
        check(b_ms / kernels_ms <= 1.05, f"ws_grad {tag}: {b_ms / kernels_ms:.3f} of its bound")
        fig = {"ms": ms, "call_ms": c_ms, "kernels_ms": kernels_ms, "plain_ms": plain_ms,
               "plain_call_ms": plain_c_ms, "library_ms": library_ms,
               "library_call_ms": library_c_ms, "library_index_backward_ms": index_ms,
               "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / kernels_ms,
               "op_share_of_bound": b_ms / ms, "vs_library": ms / library_ms,
               "max_err_over_bound": worst, "distinct": distinct, "longest_run": longest,
               "shape": shape}
        if tag == "path":
            record = dict({"name": "ws_grad", "route": "cuda",
                           "source": "src/repro_torch/csrc/ws_grad.cu",
                           "replaces": None}, **fig)
        else:
            record.update({f"cell_{k}": v for k, v in fig.items()})
        del out, rows_leaf, g, inverse
        torch.cuda.empty_cache()
    print(f"ws_grad phase: {time.perf_counter() - t_phase:.1f} s")
    return record


def phase_mempool_alloc(torch, dev):
    import numpy as np
    from repro_torch.core.mempool import ArenaPool
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.kernels.mempool_alloc.ops import alloc_offsets, plan_block
    from repro_torch.kernels.mempool_alloc.ref import alloc_offsets_ref

    layout = featureplan.compile(get_spec("dlrm")).feed_layout()
    feed_sizes = layout.sizes(TRAIN_ROWS)
    record = None
    for n in ALLOC_NS + (ALLOC_HBM_N,):
        sizes = (feed_sizes if n == len(feed_sizes)
                 else np.random.default_rng(n).integers(0, 1 << 16, n))
        host = torch.tensor(np.asarray(sizes), dtype=torch.int32)
        sizes_d = host.to(dev)
        offsets, head = alloc_offsets(sizes_d)
        want_offsets, want_head = alloc_offsets_ref(host)
        torch.cuda.synchronize()
        check(torch.equal(offsets.cpu(), want_offsets) and torch.equal(head.cpu(), want_head),
              f"mempool_alloc N={n} != plain version")
        del offsets, want_offsets
        aligned = (sizes_d + 127) // 128 * 128
        # each size read once, each offset and the head written once; an
        # align, an add and a compare per request
        b_ms, b_by = bound(8 * n + 4, 3 * n, INT32_OPS)
        if n == ALLOC_HBM_N:
            # each call reads sizes that the L2 no longer holds: the blocks
            # are rotated, at least 3 of them and HBM_ROTATION_BYTES in all;
            # the library reads the aligned sizes, rotated the same way
            k = max(3, math.ceil(HBM_ROTATION_BYTES / sizes_d.nbytes))
            blocks = [sizes_d] + [sizes_d.roll(4097 * r) for r in range(1, k)]
            lib_blocks = [aligned] + [aligned.roll(4097 * r) for r in range(1, k)]
            rotation, lib_rotation = itertools.cycle(blocks), itertools.cycle(lib_blocks)
            ms = device_ms(torch, lambda: alloc_offsets(next(rotation)))
            library_ms = device_ms(
                torch, lambda: torch.cumsum(next(lib_rotation), 0, dtype=torch.int32))
            share = b_ms / ms
            check(share <= 1.0, f"mempool_alloc N={n}: {share:.3f} of its bound, above "
                                "100 %: the timing or the count is wrong")
            print(f"mempool_alloc N={n} exact=True head={int(head[0])} ms={ms:.7f} "
                  f"bound_ms={b_ms:.7f} ({b_by}) share_of_bound={share:.3f} "
                  f"library_ms={library_ms:.7f} vs_library={ms / library_ms:.3f} (inputs "
                  f"rotated over {k} blocks, {k * sizes_d.nbytes / 1e6:.1f} MB, past the L2)")
            record.update({"share_of_bound": share, "hbm_ms": ms, "hbm_bound_ms": b_ms,
                           "hbm_library_ms": library_ms, "hbm_vs_library": ms / library_ms,
                           "share_of_bound_shape": (
                               f"N={n}, sizes rotated over {k} blocks "
                               f"({k * sizes_d.nbytes / 1e6:.1f} MB), past the L2")})
            del blocks, lib_blocks, rotation, lib_rotation
            continue

        def kernel():
            return alloc_offsets(sizes_d)

        def library():
            return torch.cumsum(aligned, 0, dtype=torch.int32)

        ms, c_ms = timings(torch, kernel)
        plain_ms, plain_c_ms = timings(torch, lambda: alloc_offsets_ref(sizes_d))
        library_ms, library_c_ms = timings(torch, library)
        print(f"mempool_alloc N={n:<7} exact=True head={int(head[0])} ms={ms:.7f} "
              f"call_ms={c_ms:.7f} plain_ms={plain_ms:.5f} plain_call_ms={plain_c_ms:.5f} "
              f"library_ms={library_ms:.7f} library_call_ms={library_c_ms:.7f} "
              f"bound_ms={b_ms:.8f} ({b_by})")
        if n == 1_000_000:
            # a second turn in the same call: kernel, library, library, kernel
            turn = [device_ms(torch, fn) for fn in (kernel, library, library, kernel)]
            kernel_ms, lib_ms = [ms, turn[0], turn[3]], [library_ms, turn[1], turn[2]]
            print(f"mempool_alloc N={n} turns (kernel, library, library, kernel after the "
                  f"first pair): kernel_ms={[round(t, 7) for t in kernel_ms]} "
                  f"library_ms={[round(t, 7) for t in lib_ms]}")
            record.update({"turns_1e6_kernel_ms": kernel_ms, "turns_1e6_library_ms": lib_ms})
        if n == len(feed_sizes):
            record = {"name": "mempool_alloc", "route": "cuda",
                      "source": "src/repro_torch/csrc/mempool_alloc.cu",
                      "replaces": "src/repro/kernels/mempool_alloc/kernel.py:60",
                      "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library_ms, "call_ms": c_ms,
                      "plain_call_ms": plain_c_ms, "library_call_ms": library_c_ms,
                      "shape": f"N={n}: the dlrm feed layout's slots at {TRAIN_ROWS} rows"}
    torch.cuda.empty_cache()
    stream = torch.cuda.Stream(dev)
    record["plan_block_ms"] = host_ms(lambda: plan_block(feed_sizes, device=dev, stream=stream))
    pool = ArenaPool(layout.arena_bytes(TRAIN_ROWS))

    def host_block():
        pool.reset()
        pool.alloc_block(feed_sizes)

    record["host_alloc_block_ms"] = host_ms(host_block)
    print(f"mempool_alloc host entry N={len(feed_sizes)}: plan_block (H2D, kernel, D2H, event "
          f"wait) ms={record['plan_block_ms']:.5f}; host ArenaPool.alloc_block "
          f"ms={record['host_alloc_block_ms']:.5f}")
    return record


def scatter_rows_0d_index(table, idx, values, valid):
    """``repro_torch.embedding.table.scatter_rows`` as it was, indexing with
    the 0-d ``argmax`` tensor: an ``.item()`` for each of its three reads of
    the first valid slot (phases 8 and 17 count and catch them)."""
    import torch

    first = valid.to(torch.int32).argmax()
    any_valid = valid[first]
    anchor = torch.where(any_valid, idx[first].to(torch.int64), 0)
    at = torch.where(valid, idx.to(torch.int64), anchor)
    fill_value = torch.where(any_valid, values[first], table[0])
    keep = valid.reshape((-1,) + (1,) * (values.dim() - 1))
    table.index_copy_(0, at, torch.where(keep, values, fill_value))


def calibrate_output_layer(torch, params, cfg, plan, feed, dev) -> None:
    """Random weights on the raw counts of the dlrm spec give logits of
    10-40, where an fp32 sigmoid is exactly 1 and a comparison of pCTRs
    tests nothing. Rescale the last top-MLP layer so the logits of one
    warm-up request have unit spread around the logit of its click rate."""
    from repro_torch.fe.datagen import gen_views
    from repro_torch.models import recsys as R

    batch = feed.apply(feed.select(plan.run(gen_views(BATCH, seed=99), device=dev)))
    logits = R.forward(params, cfg, batch)
    rate = min(max(float(batch["label"].mean()), 0.01), 0.5)
    scale = 1.0 / float(logits.std())
    last = len(cfg.top_mlp) - 1
    params[f"top_w{last}"] *= scale
    params[f"top_b{last}"] = ((params[f"top_b{last}"] - float(logits.mean())) * scale
                              + math.log(rate / (1.0 - rate)))


def phase_end_to_end(torch, dev):
    from repro_torch.configs.dlrm_mlperf import CONFIG
    from repro_torch.core.metakernel import ExecutionStats
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views
    from repro_torch.kernels.feature_hash import ops as hash_ops
    from repro_torch.kernels.feature_hash.ref import hash_layer_ref
    from repro_torch.kernels.interaction_dot import ops as interaction_ops
    from repro_torch.kernels.interaction_dot.ref import dot_interaction_ref
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import recsys as R

    cfg = capped_config()
    full_gib = sum(CONFIG.vocab_sizes) * CONFIG.embed_dim * 4 / 2**30
    gib = cfg.padded_rows * cfg.embed_dim * 4 / 2**30
    print(f"reduced: vocabularies capped at {VOCAB_CAP:,} rows: {cfg.multi_table().total_rows:,} "
          f"rows ({cfg.padded_rows:,} padded) = {gib:.1f} GiB fp32 on the card; the full "
          f"Criteo-1TB table is {sum(CONFIG.vocab_sizes):,} rows = {full_gib:.1f} GiB")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    plan = featureplan.compile(get_spec("dlrm"))
    feed = plan.model_feed(cfg, rows_hint=BATCH)
    calibrate_output_layer(torch, params, cfg, plan, feed, dev)
    torch.cuda.synchronize()
    print(f"setup: params {sum(v.numel() for v in params.values()):,} on {dev}, "
          f"dedup capacity {feed.dedup_capacity}, {time.perf_counter() - t0:.2f} s")

    serve_requests(plan, feed, params, cfg, [gen_views(BATCH, seed=98)], device=dev)  # warm-up
    requests = [gen_views(BATCH, seed=100 + i) for i in range(N_BATCHES)]
    stats = ExecutionStats()
    hash_ops.run_hash_layer.launches = 0
    interaction_ops.pairwise_dots.launches = 0
    scores, latency = serve_requests(plan, feed, params, cfg, requests, device=dev, stats=stats)
    launches = {"feature_hash": hash_ops.run_hash_layer.launches,
                "interaction_dot": interaction_ops.pairwise_dots.launches}

    check(launches["feature_hash"] == 2 * N_BATCHES, f"feature_hash launches {launches}")
    check(launches["interaction_dot"] == N_BATCHES, f"interaction_dot launches {launches}")
    check(stats.n_device_dispatches == N_BATCHES, f"FE dispatches {stats.n_device_dispatches}")
    for s in scores:
        check(tuple(s.shape) == (BATCH,) and s.dtype == torch.float32, "pCTR shape/dtype")
        check(bool(torch.isfinite(s).all()), "pCTR finite")
        check(bool(((s > 0) & (s < 1)).all()), "pCTR in (0, 1)")

    with mock.patch.object(hash_ops, "run_hash_layer",
                           lambda cols, program: hash_layer_ref(cols, program=program)), \
            mock.patch.object(interaction_ops, "pairwise_dots", dot_interaction_ref):
        (plain,), _ = serve_requests(plan, feed, params, cfg, requests[:1], device=dev)
    err = float((scores[0] - plain).abs().max())
    check(err <= 1e-5, f"first batch pCTR vs plain-version path: max abs err {err}")

    lat_ms = [t * 1e3 for t in latency]
    p50 = float(statistics.median(lat_ms))
    p99 = float(sorted(lat_ms)[min(len(lat_ms) - 1, math.ceil(0.99 * len(lat_ms)) - 1)])
    all_s = torch.cat(scores)
    print(f"end_to_end dlrm-mlperf batches={N_BATCHES} batch={BATCH} "
          f"latency_ms={[round(t, 3) for t in lat_ms]} p50_ms={p50:.3f} p99_ms={p99:.3f} "
          f"pctr_mean={float(all_s.mean()):.4f} pctr_min={float(all_s.min()):.3e} "
          f"pctr_max={float(all_s.max()):.4f} plain_path_max_abs_err={err:.3e} "
          f"launches={launches} fe_dispatches={stats.n_device_dispatches} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
    print(f"end_to_end breakdown per request: fe_host_ops_ms={stats.host_seconds * 1e3 / N_BATCHES:.3f} "
          f"fe_device_ops_issue_ms={stats.device_seconds * 1e3 / N_BATCHES:.3f} "
          f"feed_and_model_ms={sum(lat_ms) / N_BATCHES - (stats.host_seconds + stats.device_seconds) * 1e3 / N_BATCHES:.3f}")
    profile_device(torch, "request", 4, lambda: serve_requests(
        plan, feed, params, cfg, requests[:4], device=dev))
    return launches


def _union_ms(spans, lo: float, hi: float) -> float:
    """Milliseconds of [lo, hi] (profiler microseconds) covered by at least
    one of ``spans``: kernels of concurrent streams count once."""
    covered, end = 0.0, lo
    for start, stop in sorted(spans):
        start, stop = max(start, end), min(stop, hi)
        if stop > start:
            covered += stop - start
            end = stop
    return covered / 1e3


def profile_device(torch, unit: str, n: int, run, mark: str = "") -> None:
    """torch.profiler over ``run()``, which does ``n`` units of work (requests
    or steps) and ends in a synchronize: the device's busy share (time with
    at least one kernel or copy running) and the kernels and host-side torch
    ops that take the time (the profiler's own overhead inflates the wall
    time). With ``mark``, the name of a ``record_function`` range opened at
    the start of each unit, the window runs from the second unit's start to
    the last one's (without set-up and the first unit), and the gaps
    between unit starts are printed. Returns the device's busy and wall ms
    per unit and the device ms per unit of each kernel name, or None when
    the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()
    n_run = n
    lo, hi, window = -math.inf, math.inf, "whole run"
    if mark:
        # the host-side ranges (the profiler mirrors each on the device's
        # timeline as a user annotation, which is not device work)
        starts = sorted(e.time_range.start for e in events if e.name == mark
                        and e.device_type == torch.autograd.DeviceType.CPU)
        check(len(starts) == n and n >= 3, f"profile: {len(starts)} {mark} ranges for {n} {unit}s")
        lo, hi, n = starts[1], starts[-1], n - 2
        wall_ms = (hi - lo) / 1e3 / n
        gaps = [round((b - a) / 1e3, 1) for a, b in zip(starts, starts[1:])]
        window = f"{unit}s 2-{n + 1} of {n_run}; ms between {unit} starts {gaps}"
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name != mark and lo <= e.time_range.start < hi]
    if not device:
        print("profile: the profiler recorded no device events; device busy share not measured")
        return None
    kernels = collections.Counter()
    counts = collections.Counter()
    for e in device:
        kernels[e.name] += e.time_range.elapsed_us() / 1e3 / n
        counts[e.name] += 1
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    busy_ms = _union_ms(spans, max(lo, min(a for a, _ in spans)), hi) / n
    print(f"profile: {n} {unit}s ({window}) wall_ms_per_{unit}={wall_ms:.3f} "
          f"device_busy_ms_per_{unit}={busy_ms:.3f} device_idle_share={1 - busy_ms / wall_ms:.3f} "
          f"device_events_per_{unit}={len(device) / n:.1f}")
    for name, ms in kernels.most_common(10):
        print(f"profile device {ms:8.4f} ms/{unit} x{counts[name] // n:<3} {name[:90]}")
    cpu = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in cpu[:8]:
        print(f"profile host (whole run) {e.self_cpu_time_total / 1e3 / n_run:8.4f} ms/{unit} "
              f"x{e.count // n_run:<4} {e.key[:90]}")
    return busy_ms, wall_ms, kernels


def capped_config(cap: int = VOCAB_CAP):
    from repro_torch.configs.dlrm_mlperf import CONFIG

    return dataclasses.replace(
        CONFIG, vocab_sizes=tuple(min(v, cap) for v in CONFIG.vocab_sizes))


def phase_training(torch, dev):
    from repro_torch.core.devicefeed import DeviceFeeder
    from repro_torch.core.metakernel import ExecutionStats
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views
    from repro_torch.kernels.feature_hash import ops as hash_ops
    from repro_torch.kernels.feature_hash.ref import hash_layer_ref
    from repro_torch.kernels.interaction_dot import ops as interaction_ops
    from repro_torch.kernels.interaction_dot.ref import dot_interaction_ref
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    cfg = capped_config()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    plan = featureplan.compile(get_spec("dlrm"))
    feed = plan.model_feed(cfg)                 # dedup capacity: rows x 26
    calibrate_output_layer(torch, params, cfg, plan, feed, dev)
    train_step, init = R.make_sparse_train_step(cfg, adamw(LR))
    opt = init(params)
    feeder = DeviceFeeder(plan.feed_layout(), rows_hint=TRAIN_ROWS, device=dev)
    step = feed.make_step(train_step, fence_cb=feeder.donation_fence)
    views = [gen_views(TRAIN_ROWS, seed=200 + i) for i in range(TRAIN_STEPS + 3)]
    torch.cuda.synchronize()
    print(f"training setup: {TRAIN_ROWS} rows/step, working set {TRAIN_ROWS * cfg.n_sparse:,} rows "
          f"x {cfg.embed_dim}, feed layout {plan.feed_layout().slot_names} = "
          f"{plan.feed_layout().arena_bytes(TRAIN_ROWS):,} arena bytes, "
          f"{time.perf_counter() - t0:.2f} s")

    # First batch: the FE output against the same plan with feature_hash
    # swapped for its plain version, the staged slots, then the kernel path
    # against the plain path (the interaction's forward and backward kernels
    # swapped for autograd of the plain forward) on the same inputs.
    env = plan.run(views[0], device=dev)
    with mock.patch.object(hash_ops, "run_hash_layer",
                           lambda cols, program: hash_layer_ref(cols, program=program)):
        env_plain = plan.run(views[0], device=dev)
    for k in plan.output_slots:
        check(torch.equal(env[k], env_plain[k]),
              f"{k} at {TRAIN_ROWS} rows: feature_hash kernel path != plain version")
    del env_plain
    staged = feeder.stage(env)
    for k in plan.output_slots:
        check(torch.equal(staged[k], env[k]), f"staged {k} != plan output")
    batch = feed.apply(feed.select(staged))
    plain_path = mock.patch.object(interaction_ops, "pairwise_dots", dot_interaction_ref)
    ws = R.sparse_grads(params, cfg, batch)
    with plain_path:
        ws_plain = R.sparse_grads(params, cfg, batch)
    n = int(ws.n_unique)
    check(torch.equal(ws.unique, ws_plain.unique), "working sets differ")
    loss, loss_plain = float(ws.loss), float(ws_plain.loss)
    check(math.isfinite(loss) and abs(loss - loss_plain) <= 1e-5 * abs(loss_plain),
          f"first-step loss {loss} vs plain path {loss_plain}")
    g, g_plain = ws.working_grad[:n], ws_plain.working_grad[:n]
    g_scale = float(g_plain.abs().max())
    g_err = float((g - g_plain).abs().max())
    g_nonzero = int((g.abs().amax(dim=1) > 0).sum())
    check(g_scale > 0 and g_err <= 1e-5 * g_scale,
          f"working-row gradients: max abs err {g_err} vs max {g_scale}")
    check(g_nonzero >= 0.99 * n, f"only {g_nonzero} of {n} working rows have a gradient")
    dense_rel = max(float((ws.dense_grads[k] - ws_plain.dense_grads[k]).abs().max())
                    / max(float(ws_plain.dense_grads[k].abs().max()), 1e-30)
                    for k in ws.dense_grads)
    del ws_plain

    ids = ws.unique[:n].to(torch.int64)
    dense_names = [k for k in params if k != "embed"]
    saved_rows = params["embed"][ids].clone()
    saved_accum = opt["embed_accum"][ids].clone()
    saved_dense = {k: params[k].clone() for k in dense_names}
    saved_moments = {m: {k: t.clone() for k, t in opt["dense"][m].items()} for m in ("m", "v")}
    saved_step = opt["dense"]["step"]
    with plain_path:
        params, opt, m_plain = train_step(params, opt, batch)
    rows_plain = params["embed"][ids].clone()
    params["embed"][ids] = saved_rows            # undo the plain step
    opt["embed_accum"][ids] = saved_accum
    for k in dense_names:
        params[k].copy_(saved_dense[k])
    for m in ("m", "v"):
        for k, t in saved_moments[m].items():
            opt["dense"][m][k].copy_(t)
    opt["dense"]["step"] = saved_step
    params, opt, m = step(params, opt, staged)  # the warm-up step, kernel path
    rows = params["embed"][ids]
    rows_err = float((rows - rows_plain).abs().max())
    rows_moved = float((rows - saved_rows).abs().max())
    check(rows_err <= 1e-6 and rows_moved > 0,
          f"updated working rows: kernel vs plain max abs err {rows_err}, moved {rows_moved}")
    check(abs(float(m["loss"]) - float(m_plain["loss"])) <= 1e-5 * abs(float(m_plain["loss"])),
          f"step loss {float(m['loss'])} vs plain path {float(m_plain['loss'])}")
    print(f"training first step: loss={loss:.6f} plain_loss={loss_plain:.6f} unique={n:,} "
          f"of {ws.n_ids:,} ids; working-row grad max_abs_err={g_err:.3e} max_abs={g_scale:.3e} "
          f"nonzero_rows={g_nonzero:,}/{n:,}; dense grads max rel err={dense_rel:.3e}; "
          f"updated rows max_abs_err={rows_err:.3e} (moved up to {rows_moved:.3e})")
    del ws, saved_rows, saved_accum, rows_plain

    _reset_launches()
    before = dataclasses.replace(feeder.stats)
    stats = ExecutionStats()
    losses, step_ms = [], []
    for views_i in views[1:1 + TRAIN_STEPS]:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, feeder.stage(plan.run(views_i, device=dev, stats=stats)))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _read_launches()
    staged_batches = feeder.stats.batches - before.batches
    check(launches == {"feature_hash": 2 * TRAIN_STEPS, "interaction_dot": TRAIN_STEPS,
                       "interaction_dot_backward": TRAIN_STEPS, "mempool_alloc": staged_batches,
                       "ws_grad": TRAIN_STEPS}
          and staged_batches == TRAIN_STEPS, f"training launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")

    per = 1e3 / TRAIN_STEPS
    fe_host = stats.host_seconds * per
    fe_dev = stats.device_seconds * per
    d2h = (feeder.stats.d2h_seconds - before.d2h_seconds) * per
    place = (feeder.stats.place_seconds - before.place_seconds) * per
    h2d = (feeder.stats.h2d_seconds - before.h2d_seconds) * per - d2h
    mean_ms = sum(step_ms) / TRAIN_STEPS
    print(f"training dlrm-mlperf steps={TRAIN_STEPS} rows={TRAIN_ROWS} losses={losses} "
          f"step_ms={[round(t, 3) for t in step_ms]} mean_ms={mean_ms:.3f} "
          f"median_ms={statistics.median(step_ms):.3f} launches={launches} "
          f"rows_per_s={TRAIN_ROWS * 1e3 / mean_ms:.0f} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
    print(f"training breakdown per step: fe_host_ops_ms={fe_host:.3f} "
          f"fe_device_ops_issue_ms={fe_dev:.3f} feed_d2h_roundtrip_ms={d2h:.3f} "
          f"feed_placement_ms={place:.3f} feed_h2d_issue_ms={h2d:.3f} "
          f"adapt_and_step_ms={mean_ms - fe_host - fe_dev - d2h - place - h2d:.3f}; "
          f"feeder {feeder.stats.summary()}; train feed {feed.stats.summary()}")

    def two_steps():
        nonlocal params, opt
        for views_i in views[1 + TRAIN_STEPS:]:
            params, opt, _ = step(params, opt, feeder.stage(plan.run(views_i, device=dev)))

    profile_device(torch, "step", 2, two_steps)

    # device reads of one step (its step function, _record's loss read
    # included), with scatter_rows as it is and in its old 0-d index form
    from repro_torch.check.effects import SyncRecorder
    from repro_torch.embedding import table as table_mod

    reads = {}
    forms = (("index_select", table_mod.scatter_rows), ("0-d index", scatter_rows_0d_index))
    for form, fn in forms:
        staged = feeder.stage(plan.run(views[1], device=dev))
        rec = SyncRecorder()
        with mock.patch.object(table_mod, "scatter_rows", fn), rec:
            params, opt, _ = step(params, opt, staged)
        reads[form] = rec.syncs
    check(reads["index_select"] == ["_local_scalar_dense"]
          and reads["0-d index"].count("_local_scalar_dense") == 7,
          f"device reads per step: {reads}")
    print(f"training device reads per step: {len(reads['index_select'])} with scatter_rows' "
          f"index_select (the loss in _record), {len(reads['0-d index'])} with its old 0-d "
          f"index form ({reads['0-d index']})")
    step_ms = {"step": mean_ms, "adapt_and_step": mean_ms - fe_host - fe_dev - d2h - place - h2d}
    return launches, step_ms


def phase_embedding_bag(torch, dev):
    import numpy as np
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views
    from repro_torch.kernels.embedding_bag.ops import bag_lookup
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    # the full-width shape: a training batch's interest bag, its ids deduped
    # into a working set of U rows
    plan = featureplan.compile(get_spec("dlrm"))
    env = plan.run(gen_views(TRAIN_ROWS, seed=700), device=dev)
    unique, inverse = torch.unique(env["batch_seq_ids"], return_inverse=True)
    full = (inverse.to(torch.int32).contiguous(), env["batch_seq_mask"].contiguous(),
            unique.numel(), 128)
    del env
    gen = torch.Generator(device=dev).manual_seed(3)
    record, worst = None, 0.0
    for shape in BAG_SHAPES + (None,):
        if shape is None:
            ids, w, u, d = full
            b, l = ids.shape
        else:
            b, l, u, d = shape
            rng = np.random.default_rng(b * l + u)
            ids = torch.from_numpy(rng.integers(0, u, (b, l)).astype(np.int32)).to(dev)
            w = torch.from_numpy(((rng.random((b, l)) < 0.8) * rng.random((b, l)))
                                 .astype(np.float32)).to(dev)
        table = torch.randn((u, d), generator=gen, device=dev)
        got = bag_lookup(ids, w, table)
        want = embedding_bag_ref(ids, w, table)
        torch.cuda.synchronize()
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max())
        check(err == 0 if l == 1 else err <= 1e-5 * scale,
              f"embedding_bag B={b} L={l} U={u} D={d}: max abs err {err} vs max {scale}")
        worst = max(worst, err)
        nnz = int((w != 0).sum())
        rows = int(torch.unique(ids[w != 0]).numel())   # distinct rows a live slot reads
        ms, c_ms = timings(torch, lambda: bag_lookup(ids, w, table))
        plain_ms, plain_c_ms = timings(torch, lambda: embedding_bag_ref(ids, w, table))
        ids64 = ids.to(torch.int64)
        library_ms, library_c_ms = timings(torch, lambda: torch.nn.functional.embedding_bag(
            ids64, table, mode="sum", per_sample_weights=w))
        # ids and weights read once, each distinct live row once, the output
        # written once; an FMA per live slot and column
        b_ms, b_by = bound(8 * b * l + 4 * d * rows + 4 * b * d, 2 * d * nnz, FP32_FLOPS)
        print(f"embedding_bag B={b:<5} L={l:<2} U={u:<6} D={d:<3} nnz={nnz:<7} rows={rows:<6} "
              f"max_abs_err={err:.3e} max_abs_out={scale:.3e} ms={ms:.5f} call_ms={c_ms:.5f} "
              f"plain_ms={plain_ms:.5f} plain_call_ms={plain_c_ms:.5f} "
              f"library_ms={library_ms:.5f} library_call_ms={library_c_ms:.5f} "
              f"bound_ms={b_ms:.6f} ({b_by})")
        if shape is None:
            record = {"name": "embedding_bag", "route": "cuda",
                      "source": "src/repro_torch/csrc/embedding_bag.cu",
                      "replaces": "src/repro/kernels/embedding_bag/kernel.py:61",
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms, "call_ms": c_ms, "plain_call_ms": plain_c_ms,
                      "library_call_ms": library_c_ms,
                      "shape": f"B={b} L={l} U={u} D={d} nnz={nnz} rows={rows}: a training batch's "
                               f"interest bag over its deduped working set"}
            # its path: one call of the entry point at the full-width shape
            bag_lookup.launches = 0
            bag_lookup(ids, w, table)
            launches = {"embedding_bag": bag_lookup.launches}
            check(launches["embedding_bag"] == 1, f"bag_lookup launches {launches}")
        del ids, w, table, got, want
    record["max_abs_err"] = worst
    torch.cuda.empty_cache()

    # the share of the bound past the L2: a 512 MiB table, uniform ids, 80 %
    # of slots live at random weights, ids and weights rotated over 3 blocks
    b, l, u, d = BAG_HBM_SHAPE
    table = torch.randn((u, d), generator=gen, device=dev)
    rng = np.random.default_rng(b * l + u)
    blocks = []
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, u, (b, l)).astype(np.int32)).to(dev)
        w = torch.from_numpy(((rng.random((b, l)) < 0.8) * rng.random((b, l)))
                             .astype(np.float32)).to(dev)
        blocks.append((ids, w, ids.to(torch.int64)))
    ids, w, _ = blocks[0]
    got = bag_lookup(ids, w, table)
    want = embedding_bag_ref(ids, w, table)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= 1e-5 * scale,
          f"embedding_bag B={b} L={l} U={u} D={d}: max abs err {err} vs max {scale}")
    del got, want
    record["max_abs_err"] = max(worst, err)
    rows = [int(torch.unique(i[x != 0]).numel()) for i, x, _ in blocks]
    nnz = [int((x != 0).sum()) for _, x, _ in blocks]
    # as above, averaged over the blocks the calls cycle through
    b_ms, b_by = bound(8 * b * l + 4 * d * statistics.mean(rows) + 4 * b * d,
                       2 * d * statistics.mean(nnz), FP32_FLOPS)
    rotation, lib_rotation = itertools.cycle(blocks), itertools.cycle(blocks)

    def kernel():
        ids, w, _ = next(rotation)
        return bag_lookup(ids, w, table)

    def library():
        _, w, ids64 = next(lib_rotation)
        return torch.nn.functional.embedding_bag(ids64, table, mode="sum", per_sample_weights=w)

    ms, library_ms = device_ms(torch, kernel), device_ms(torch, library)
    share = b_ms / ms
    check(share <= 1.0, f"embedding_bag B={b} U={u}: {share:.3f} of its bound, above 100 %: "
                        "the timing or the count is wrong")
    shape = (f"B={b} L={l} U={u} D={d}, uniform ids, 80 % live; ids and weights rotated "
             f"over {len(blocks)} blocks, rows={rows}: past the L2")
    print(f"embedding_bag {shape} max_abs_err={err:.3e} max_abs_out={scale:.3e} ms={ms:.7f} "
          f"bound_ms={b_ms:.7f} ({b_by}) share_of_bound={share:.3f} "
          f"library_ms={library_ms:.7f} vs_library={ms / library_ms:.3f}")
    record.update({"share_of_bound": share, "share_of_bound_shape": shape, "hbm_ms": ms,
                   "hbm_bound_ms": b_ms, "hbm_library_ms": library_ms,
                   "hbm_vs_library": ms / library_ms})
    del table, blocks, rotation, lib_rotation, ids, w
    torch.cuda.empty_cache()
    return record, launches


def _reset_launches():
    from repro_torch.kernels.feature_hash import ops as hash_ops
    from repro_torch.kernels.interaction_dot import ops as interaction_ops
    from repro_torch.kernels.mempool_alloc import ops as alloc_ops
    from repro_torch.kernels.ws_grad import ops as ws_ops

    hash_ops.run_hash_layer.launches = 0
    interaction_ops.pairwise_dots.launches = 0
    interaction_ops.pairwise_dots_backward.launches = 0
    alloc_ops.alloc_offsets.launches = 0
    ws_ops.gather_rows.launches = 0


def _read_launches():
    from repro_torch.kernels.feature_hash import ops as hash_ops
    from repro_torch.kernels.interaction_dot import ops as interaction_ops
    from repro_torch.kernels.mempool_alloc import ops as alloc_ops
    from repro_torch.kernels.ws_grad import ops as ws_ops

    return {"feature_hash": hash_ops.run_hash_layer.launches,
            "interaction_dot": interaction_ops.pairwise_dots.launches,
            "interaction_dot_backward": interaction_ops.pairwise_dots_backward.launches,
            "mempool_alloc": alloc_ops.alloc_offsets.launches,
            "ws_grad": ws_ops.gather_rows.launches}


STEP_MARK = "chip_smoke.step"


def marked_steps(torch):
    """Patch ``make_sparse_train_step`` and ``make_hierarchy_train_step`` so
    that every step they build opens a ``record_function`` range named
    :data:`STEP_MARK` (the profiler's steady-state window)."""
    from repro_torch.models import recsys as R

    def marked(real):
        def make(cfg, opt):
            raw, init = real(cfg, opt)

            def step(*a):
                with torch.profiler.record_function(STEP_MARK):
                    return raw(*a)
            return step, init
        return make

    stack = contextlib.ExitStack()
    for name in ("make_sparse_train_step", "make_hierarchy_train_step"):
        stack.enter_context(mock.patch.object(R, name, marked(getattr(R, name))))
    return stack


def serial_loop(torch, dev, a, plan, cfg, opt, state, steps):
    """The streaming runner's work in one thread, in series: the same loader
    (its reader threads, --fault-tolerant order), the arena binding's FE
    layers and feeder, the same sparse step, for ``steps`` steps of the
    shards in ``a.data_dir`` (``a`` the driver's parsed args). Timed like
    the runner's wall: from the first batch's read to the last step's sync.
    Returns ms per step, the losses, the launches and the new state."""
    from repro_torch.core.metakernel import run_layers
    from repro_torch.io.dataset import ShardDataset
    from repro_torch.io.stream import StreamingLoader
    from repro_torch.models import recsys as R

    loader = StreamingLoader(ShardDataset(a.data_dir), workers=a.stream_workers,
                             prefetch=a.stream_prefetch, epochs=1, shuffle=True,
                             seed=0, columns=plan.required_columns, ordered=True)
    ab = plan.arena_binding(split_sparse_fields=True)
    mf = plan.model_feed(dataclasses.replace(cfg, dedup_capacity=0),
                         split_sparse_fields=True, rows_hint=loader.rows_hint)
    feeder = ab.make_feeder(rows_hint=loader.rows_hint, device=dev)
    step = mf.make_step(R.make_sparse_train_step(mf.config, opt)[0],
                        fence_cb=feeder.donation_fence)
    _reset_launches()
    losses, batches = [], iter(loader)
    t0 = time.perf_counter()
    try:
        for raw in itertools.islice(batches, steps):
            env = dict(raw)
            run_layers(ab.layers, env, device=dev)
            p, o, m = step(state["params"], state["opt"], feeder.stage(env))
            state = {"params": p, "opt": o}
            losses.append(float(m["loss"]))
        feeder.flush()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        batches.close()
        loader.close()
    return ms, losses, _read_launches(), state


def phase_streaming(torch, dev):
    from repro_torch.configs import get_arch
    from repro_torch.core.devicefeed import DeviceFeeder
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import write_log_shards
    from repro_torch.io.dataset import ShardDataset
    from repro_torch.io.shardfmt import ShardReader
    from repro_torch.launch import train
    from repro_torch.models import recsys as R
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import adamw

    cfg = capped_config()
    spec = get_arch("dlrm-mlperf")
    data_dir = tempfile.mkdtemp(prefix="fbshards_")
    ckpt_dir = tempfile.mkdtemp(prefix="fbckpt_")
    switch_interval = sys.getswitchinterval()
    try:
        t0 = time.perf_counter()
        write_log_shards(data_dir, n_shards=STREAM_SHARDS, rows_per_shard=TRAIN_ROWS, seed=0)
        shard_mib = sum(e.nbytes for e in ShardDataset(data_dir).shards) / 2**20
        torch.cuda.reset_peak_memory_stats(dev)
        opt = adamw(LR)
        params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        plan = featureplan.compile(get_spec("dlrm"))
        calibrate_output_layer(torch, params, cfg, plan, plan.model_feed(cfg), dev)
        _, init = R.make_sparse_train_step(cfg, opt)
        state = {"params": params, "opt": init(params)}
        torch.cuda.synchronize()
        print(f"streaming setup: {STREAM_SHARDS} shards x {TRAIN_ROWS} rows ({shard_mib:.1f} MiB) "
              f"in {data_dir}, full-width params, {time.perf_counter() - t0:.2f} s")

        def args(steps, *extra):
            # --fault-tolerant: shards in plan order, so every run sees the
            # same batches
            return train.parse_args(["--arch", "dlrm-mlperf", "--data-dir", data_dir,
                                     "--spec", "dlrm", "--device-feed", "arena",
                                     "--fault-tolerant", "--steps", str(steps),
                                     "--device", dev.type, *extra])

        # the slice-2 plain loop's loss on the loader's first shard with
        # these params (copy feed, one thread)
        first = ShardDataset(data_dir).epoch_order(0, shuffle=True, seed=0)[0]
        mf_plain = plan.model_feed(cfg, rows_hint=TRAIN_ROWS)
        feeder = DeviceFeeder(plan.feed_layout(), rows_hint=TRAIN_ROWS, device=dev)
        staged = feeder.stage(plan.run(ShardReader(first.path).read_all(plan.required_columns),
                                       device=dev))
        loss_plain = float(R.sparse_grads(state["params"], mf_plain.config,
                                          mf_plain.apply(mf_plain.select(staged))).loss)
        feeder.donation_fence()
        del staged, feeder
        _, warm = train.run_streaming(args(1), spec, cfg, state, opt)   # warm-up step
        check(abs(warm[0] - loss_plain) <= 1e-6 * abs(loss_plain),
              f"first streaming loss {warm[0]} vs the plain loop's {loss_plain}")

        def serial(steps=TRAIN_STEPS):
            nonlocal state
            ms, losses, launches, state = serial_loop(torch, dev, args(steps), plan, cfg, opt,
                                                      state, steps)
            return ms, losses, launches

        def streaming():
            _reset_launches()        # the main path: counts from 0, read just after
            t0 = time.perf_counter()
            stats, losses = train.run_streaming(args(TRAIN_STEPS), spec, cfg, state, opt)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
            return stats.wall_seconds * 1e3 / stats.batches, losses, _read_launches(), stats, call_ms

        # runs in turns; then the GIL probe: the same turns with the
        # interpreter's switch interval cut from 5 ms to 0.5 ms
        order = ("serial", "stream", "stream", "serial", "serial", "stream",
                 "stream@0.5ms", "serial@0.5ms", "serial@0.5ms", "stream@0.5ms")
        runs = []
        for kind in order:
            if kind.endswith("@0.5ms"):
                sys.setswitchinterval(5e-4)
            res = serial() if kind.startswith("serial") else streaming()
            runs.append((kind,) + res)
            check(len(res[1]) == TRAIN_STEPS and all(math.isfinite(x) for x in res[1]),
                  f"{kind} losses {res[1]}")
        sys.setswitchinterval(switch_interval)
        per_step = {"feature_hash": 2, "interaction_dot": 1, "interaction_dot_backward": 1,
                    "mempool_alloc": 1, "ws_grad": 1}
        for kind, ms, losses, launches, *rest in runs:
            check(launches == {k: n * TRAIN_STEPS for k, n in per_step.items()},
                  f"{kind} launches {launches}")
            line = (f"streaming run={kind} steps={TRAIN_STEPS} wall_ms_per_step={ms:.3f} "
                    f"losses={[round(x, 5) for x in losses]} launches={launches}")
            if rest:
                s, call_ms = rest
                f = s.feed
                line += (f" call_ms_per_step={call_ms:.3f} "
                         f"train_ms_per_step={s.train_seconds * 1e3 / s.batches:.3f} "
                         f"fe_seconds={s.fe_seconds:.4f} train_seconds={s.train_seconds:.4f} "
                         f"adapt_seconds={s.adapt_seconds:.4f} wall_seconds={s.wall_seconds:.4f} "
                         f"overlap_seconds={s.overlap_seconds:.4f} "
                         f"overlap_fraction={s.overlap_fraction:.4f} "
                         f"fe_host_ops_s={s.exec_stats.host_seconds:.4f} "
                         f"fe_device_issue_s={s.exec_stats.device_seconds:.4f} "
                         f"feed_copies_elided={f.copies_elided} feed_d2h_s={f.d2h_seconds:.4f} "
                         f"feed_place_s={f.place_seconds:.4f} feed_h2d_s={f.h2d_seconds:.4f} "
                         f"feed_stall_s={f.stall_seconds:.4f} fresh_arenas={f.fresh_arenas} "
                         f"ingest_consumer_stall_s={s.ingest.consumer_stall_seconds:.4f}")
            print(line)
        by_kind = collections.defaultdict(list)
        for kind, ms, *_ in runs:
            by_kind[kind].append(round(ms, 3))
        print(f"streaming vs serial loop, wall ms per step (same loader, feed and step; "
              f"order {', '.join(order)}): {dict(by_kind)} "
              f"peak_mem_gib={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
        launches = runs[1][3]
        # each loop over one epoch (10 steps) under the profiler; beside it
        # the idle share that its device time gives at the unprofiled wall
        with marked_steps(torch):
            profiled = {"serial": profile_device(torch, "step", STREAM_SHARDS,
                                                 lambda: serial(STREAM_SHARDS), mark=STEP_MARK),
                        "stream": profile_device(torch, "step", STREAM_SHARDS,
                                                 lambda: train.run_streaming(
                                                     args(STREAM_SHARDS), spec, cfg, state, opt),
                                                 mark=STEP_MARK)}
        for kind, res in profiled.items():
            if res is not None:
                wall = statistics.median(by_kind[kind])
                print(f"streaming idle share of {kind}: device busy {res[0]:.3f} ms/step "
                      f"(profiled) over its unprofiled median wall {wall:.3f} ms/step = "
                      f"{1 - res[0] / wall:.3f}")
        del state, params
        torch.cuda.empty_cache()
        flag_launches = streaming_flags(torch, dev, args, spec, plan, opt, per_step)

        # checkpoint round trip at the smoke config (a full-width save is 26 GiB)
        smoke = spec.smoke()
        small = {"params": R.init_params(smoke, torch.Generator(device=dev).manual_seed(1))}
        small["opt"] = R.make_sparse_train_step(smoke, opt)[1](small["params"])
        _, losses = train.run_streaming(
            args(4, "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "2"),
            spec, smoke, small, opt)
        fresh = {"params": R.init_params(smoke, torch.Generator(device=dev).manual_seed(2))}
        fresh["opt"] = R.make_sparse_train_step(smoke, opt)[1](fresh["params"])
        step_no, fresh = CheckpointManager(ckpt_dir).restore_latest(fresh)
        same = all(torch.equal(fresh["params"][k], v) for k, v in small["params"].items())
        same = same and torch.equal(fresh["opt"]["embed_accum"], small["opt"]["embed_accum"])
        check(step_no == 3 and same and fresh["opt"]["dense"]["step"] == 4,
              f"checkpoint round trip: step {step_no}, equal {same}")
        print(f"checkpoint round trip (smoke config): saved steps 1 and 3, restored step "
              f"{step_no} equal to the trained state; losses={[round(x, 5) for x in losses]}")
    finally:
        sys.setswitchinterval(switch_interval)
        shutil.rmtree(data_dir, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches, flag_launches


def streaming_flags(torch, dev, args, spec, plan, opt, per_step):
    """The stream cell through the driver with its defaults, ``--adapt eager``
    and ``--no-donate``, each from the same seeded state (restored from a
    host copy) over the same shards: losses bit for bit the default's, each
    run's kernels launched as the default's are; the adaptation's
    dispatches and host seconds a step and each run's peak allocated."""
    from torch.utils._pytree import tree_map

    from repro_torch.launch import train
    from repro_torch.models import recsys as R

    cfg = capped_config(FLAG_VOCAB_CAP)
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    calibrate_output_layer(torch, params, cfg, plan, plan.model_feed(cfg), dev)
    def copy_to(where):
        return lambda t: t.to(where, copy=True) if isinstance(t, torch.Tensor) else t

    host = tree_map(copy_to("cpu"), {"params": params,
                                     "opt": R.make_sparse_train_step(cfg, opt)[1](params)})
    del params
    torch.cuda.empty_cache()
    table_gib = sum(min(v, FLAG_VOCAB_CAP) for v in cfg.vocab_sizes) * cfg.embed_dim * 4 / 2**30
    runs, launches_by_flag = {}, {}
    for flags in ((), ("--adapt", "eager"), ("--no-donate",)):
        state = tree_map(copy_to(dev), host)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        stats, losses = train.run_streaming(args(TRAIN_STEPS, *flags), spec, cfg, state, opt)
        torch.cuda.synchronize(dev)
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        del state
        torch.cuda.empty_cache()
        name = " ".join(flags) or "default"
        tf, fd = stats.train_feed, stats.feed
        runs[name] = losses
        launches_by_flag[f"stream {name}"] = launches
        print(f"streaming flags [{CARD}] {name} (vocabularies capped at {FLAG_VOCAB_CAP:,}: "
              f"{table_gib:.2f} GiB table): losses {[round(x, 5) for x in losses]}; "
              f"adapt_dispatches_per_step {tf.adapt_dispatches_per_step:.1f}, "
              f"dispatches_per_step {tf.dispatches_per_step:.1f}, adapt_seconds a step "
              f"{tf.adapt_seconds / max(tf.steps, 1):.6f}, fused_steps {tf.fused_steps}; "
              f"feed donated {fd.donated}, fresh_arenas {fd.fresh_arenas}; wall ms a step "
              f"{stats.wall_seconds * 1e3 / stats.batches:.3f}; peak allocated {peak:.2f} GiB; "
              f"launches {launches}")
        check(len(losses) == TRAIN_STEPS and losses == runs["default"],
              f"streaming {name}: losses {losses} against the default's {runs['default']}")
        check(launches == {k: n * TRAIN_STEPS for k, n in per_step.items()},
              f"streaming {name} launches {launches}")
        if flags == ("--adapt", "eager"):
            check(tf.fused_steps == 0 and tf.adapt_dispatches_per_step > 0
                  and tf.dispatches_per_step == tf.adapt_dispatches_per_step + 1,
                  f"streaming --adapt eager counts: {tf}")
        if flags == ("--no-donate",):
            check(fd.donated == 0 and fd.fresh_arenas > 0, f"streaming --no-donate feed: {fd}")
    return launches_by_flag


TRACE_WAIT_SPANS = ("train.wait_batch", "io.wait_shard", "io.backpressure")


def _proc_cpu_s(native_id: int) -> float:
    """utime + stime of one thread of this process, from
    ``/proc/self/task/<native_id>/stat`` (fields 14 and 15), in seconds."""
    import os

    with open(f"/proc/self/task/{native_id}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()   # from field 3 (state) on
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def thread_split(torch, run, main_window=None):
    """Run ``run()`` under ``torch.profiler`` (CUDA activity: the runtime
    calls, each with the system id of the thread that made it) and return,
    per thread that worked in it, where its wall time went:

    * ``wall``: from the thread's start to its end (the calling thread:
      over ``main_window``, an ``(object, attribute)`` whose call is
      bracketed, else over the whole ``run()``);
    * ``queue``: time inside ``queue.Queue.get``/``put`` (every wait span of
      the tracer lies inside one; the runner's own queue hand-offs have
      none);
    * ``sync``: CUDA runtime calls that block the host, the profiler's
      ``cuda*Synchronize`` and ``cudaMemcpy*`` on that thread (its exported
      trace gives each runtime call the id of its thread: the native id or
      the thread's ``pthread_t`` cut to 32 bits);
    * ``cpu``: utime + stime from ``/proc`` read at start and end
      (``thread_time`` beside it);
    * ``rest``: wall less the three, the time the thread was neither on the
      CPU nor in a named wait (the GIL, other locks, I/O, page faults, a
      wait for a free core). A sync that spins on the CPU counts twice, so
      ``rest`` is a lower bound.

    Returns ``{native_id: {...}}`` and the profiler's runtime call names per
    thread."""
    import queue
    import threading

    from torch.profiler import ProfilerActivity, profile

    rec, lock, aliases = {}, threading.Lock(), {}
    qwait = collections.defaultdict(float)

    def timed(body, name):
        tid = threading.get_native_id()
        ident = threading.get_ident() & 0xFFFFFFFF
        with lock:
            for alias in (tid, ident, abs(ident - (1 << 32) if ident >> 31 else ident)):
                aliases[alias] = tid
        w0, c0, t0 = time.perf_counter(), _proc_cpu_s(tid), time.thread_time()
        try:
            return body()
        finally:
            w, c, t = (time.perf_counter() - w0, _proc_cpu_s(tid) - c0,
                       time.thread_time() - t0)
            with lock:
                r = rec.setdefault(tid, {"name": name, "wall": 0.0, "cpu": 0.0,
                                         "thread_time": 0.0})
                r["wall"] += w
                r["cpu"] += c
                r["thread_time"] += t

    real_run = threading.Thread.run

    def thread_run(self):
        timed(lambda: real_run(self), self.name)

    def queue_timed(real):
        def call(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return real(self, *a, **k)
            finally:
                d = time.perf_counter() - t0
                with lock:
                    qwait[threading.get_native_id()] += d
        return call

    me = threading.current_thread().name
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(threading.Thread, "run", thread_run))
        stack.enter_context(mock.patch.object(queue.Queue, "get", queue_timed(queue.Queue.get)))
        stack.enter_context(mock.patch.object(queue.Queue, "put", queue_timed(queue.Queue.put)))
        if main_window is not None:
            obj, attr = main_window
            real = getattr(obj, attr)
            stack.enter_context(mock.patch.object(
                obj, attr, lambda *a, **k: timed(lambda: real(*a, **k), me)))
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
        if main_window is None:
            timed(run, me)
        else:
            run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(str(Path(d) / "prof.json"))
        with open(Path(d) / "prof.json") as f:
            events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    calls = collections.defaultdict(collections.Counter)
    for e in events:
        if e.get("cat") == "cuda_runtime" and "dur" in e:
            calls[aliases.get(e["tid"], e["tid"])][e["name"]] += e["dur"] / 1e6
    for tid, r in rec.items():
        r["queue"] = qwait.get(tid, 0.0)
        r["sync"] = sum(s for n, s in calls.get(tid, {}).items()
                        if "Synchronize" in n or "Memcpy" in n)
        r["cuda_runtime"] = sum(calls.get(tid, {}).values())
        r["rest"] = r["wall"] - r["queue"] - r["sync"] - r["cpu"]
    unmatched = {t: round(sum(c.values()), 4) for t, c in calls.items() if t not in rec}
    return rec, calls, unmatched


def wait_spans_by_thread(trace):
    """Seconds of the tracer's wait spans (:data:`TRACE_WAIT_SPANS`) per
    thread name (never per track id: ROADMAP C10)."""
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    out, open_ = collections.defaultdict(float), {}
    for e in trace["traceEvents"]:
        if e["ph"] == "B":
            open_.setdefault(e["tid"], []).append((e["name"], e["ts"]))
        elif e["ph"] == "E" and open_.get(e["tid"]):
            name, ts = open_[e["tid"]].pop()
            if name in TRACE_WAIT_SPANS:
                out[names.get(e["tid"], "?")] += (e["ts"] - ts) / 1e6
    return out


def phase_traced_streaming(torch, dev):
    """Phase 15: the streaming cell of phase 10 with the tracer on, and the
    serial loop beside it, each traced over 8 steps after an untraced run of
    each in the same call; the runner's trace gated by the port's validator
    (``--require-tracks 4 --require-overlap fe. train.``); per thread, its
    wall split into queue waits, CUDA syncs and copies, CPU time and the
    rest (:func:`thread_split`)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import write_log_shards
    from repro_torch.launch import train
    from repro_torch.models import recsys as R
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.train.optimizer import adamw

    cfg = capped_config()
    spec = get_arch("dlrm-mlperf")
    data_dir = tempfile.mkdtemp(prefix="fbtrace_")
    try:
        write_log_shards(data_dir, n_shards=STREAM_SHARDS, rows_per_shard=TRAIN_ROWS, seed=0)
        opt = adamw(LR)
        params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        plan = featureplan.compile(get_spec("dlrm"))
        calibrate_output_layer(torch, params, cfg, plan, plan.model_feed(cfg), dev)
        state = {"params": params, "opt": R.make_sparse_train_step(cfg, opt)[1](params)}

        def args(steps):
            return train.parse_args(["--arch", "dlrm-mlperf", "--data-dir", data_dir,
                                     "--spec", "dlrm", "--device-feed", "arena",
                                     "--fault-tolerant", "--steps", str(steps),
                                     "--device", dev.type])

        train.run_streaming(args(1), spec, cfg, state, opt)          # warm-up step
        untraced = {}
        stats, _ = train.run_streaming(args(TRAIN_STEPS), spec, cfg, state, opt)
        untraced["stream"] = stats.wall_seconds * 1e3 / stats.batches
        untraced["serial"], _, _, state = serial_loop(torch, dev, args(TRAIN_STEPS), plan, cfg,
                                                      opt, state, TRAIN_STEPS)
        per_step = {"feature_hash": 2, "interaction_dot": 1, "interaction_dot_backward": 1,
                    "mempool_alloc": 1, "ws_grad": 1}
        launches = None
        for kind in ("stream", "serial"):
            tracer = Tracer(enabled=True)
            prev = set_tracer(tracer)
            box = {}
            try:
                if kind == "stream":
                    def run():
                        _reset_launches()    # the traced main path: from 0, read just after
                        box["stats"], box["losses"] = train.run_streaming(
                            args(TRAIN_STEPS), spec, cfg, state, opt)
                        box["launches"] = _read_launches()
                    rec, calls, unmatched = thread_split(torch, run, (PipelinedRunner, "run"))
                    s = box["stats"]
                    traced_ms = s.wall_seconds * 1e3 / s.batches
                else:
                    def run():
                        box["ms"], box["losses"], box["launches"], box["state"] = serial_loop(
                            torch, dev, args(TRAIN_STEPS), plan, cfg, opt, state, TRAIN_STEPS)
                    rec, calls, unmatched = thread_split(torch, run)
                    state = box["state"]
                    traced_ms = box["ms"]
            finally:
                set_tracer(prev)
            check(len(box["losses"]) == TRAIN_STEPS
                  and all(math.isfinite(x) for x in box["losses"]),
                  f"traced {kind} losses {box['losses']}")
            check(box["launches"] == {k: n * TRAIN_STEPS for k, n in per_step.items()},
                  f"traced {kind} launches {box['launches']}")
            if kind == "stream":
                launches = box["launches"]
            path = str(Path(data_dir) / f"trace_{kind}.json")
            trace = tracer.export(path)
            gate = ([] if kind == "serial" else
                    ["--require-tracks", "4", "--require-overlap", "fe.", "train."])
            res = subprocess.run([sys.executable, "-m", "repro_torch.obs.validate", path, *gate],
                                 capture_output=True, text=True, env={"PYTHONPATH": str(SRC)})
            print(f"traced {kind}: python -m repro_torch.obs.validate {Path(path).name} "
                  f"{' '.join(gate)} -> exit {res.returncode}")
            for ln in res.stdout.splitlines():
                print(f"  {ln}")
            check(res.returncode == 0, f"the {kind} trace fails the validator: {res.stderr}")
            tracks = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
                      if e["ph"] == "M" and e["name"] == "thread_name"}
            fe_thread = "fe-worker" if kind == "stream" else "MainThread"
            layers = [e for e in trace["traceEvents"] if e["ph"] == "B"
                      and e["name"] == "fe.layer" and tracks[e["tid"]] == fe_thread]
            check(len(layers) == TRAIN_STEPS * len(plan.layers),
                  f"{len(layers)} fe.layer spans on {fe_thread}")
            waits = wait_spans_by_thread(trace)
            # each super-layer's time on the FE thread (the fe.layer spans)
            layer_ms, opened = collections.defaultdict(float), {}
            for e in trace["traceEvents"]:
                if e.get("name") != "fe.layer" or tracks.get(e["tid"]) != fe_thread:
                    continue
                if e["ph"] == "B":
                    opened[e["tid"]] = (e["args"], e["ts"])
                elif e["ph"] == "E":
                    a, ts = opened.pop(e["tid"])
                    key = (a["layer"], a["host_ops"], a["dispatches"])
                    layer_ms[key] += (e["ts"] - ts) / 1e3 / TRAIN_STEPS
            print(f"traced {kind}: {TRAIN_STEPS} steps, wall ms per step {traced_ms:.3f} traced, "
                  f"{untraced[kind]:.3f} untraced earlier in this phase; "
                  f"{len(trace['traceEvents'])} trace events; launches {box['launches']}; "
                  f"fe.layer spans on {fe_thread}: {len(layers)}")
            print(f"traced {kind}: fe.layer ms per step on {fe_thread}: " + ", ".join(
                f"layer {li} (host ops {h}, dispatches {d}) {ms:.3f}"
                for (li, h, d), ms in sorted(layer_ms.items())))
            print(f"traced {kind} split (ms per step; rest = wall - queue - sync - cpu; "
                  f"thread_time beside /proc's cpu):")
            for tid, r in sorted(rec.items(), key=lambda kv: kv[1]["name"]):
                top = ", ".join(f"{n} {s * 1e3 / TRAIN_STEPS:.3f}"
                                for n, s in calls.get(tid, collections.Counter()).most_common(4))
                print(f"  thread={r['name']} wall={r['wall'] * 1e3 / TRAIN_STEPS:.3f} "
                      f"queue={r['queue'] * 1e3 / TRAIN_STEPS:.3f} "
                      f"(wait spans {waits.get(r['name'], 0.0) * 1e3 / TRAIN_STEPS:.3f}) "
                      f"sync={r['sync'] * 1e3 / TRAIN_STEPS:.3f} "
                      f"cpu={r['cpu'] * 1e3 / TRAIN_STEPS:.3f} "
                      f"(thread_time {r['thread_time'] * 1e3 / TRAIN_STEPS:.3f}) "
                      f"rest={r['rest'] * 1e3 / TRAIN_STEPS:.3f} "
                      f"cuda_runtime={r['cuda_runtime'] * 1e3 / TRAIN_STEPS:.3f} [{top}]")
            if unmatched:
                print(f"  cuda runtime seconds on threads not started in the run: {unmatched}")
            check(any(r["name"] == fe_thread and r["cuda_runtime"] > 0 for r in rec.values()),
                  f"no CUDA runtime calls matched to {fe_thread}")
        del state, params
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    return launches


# phase 16's bound on the largest drift of an embedding row after 16 steps
# from the uncompressed run: 4x the largest that tests/rehearse_mesh.py reads
# on the CPU over six inits (seeds 0-4 at a 50,000-row cap, seed 0 at
# 500,000), rounded up. The drift follows the trajectory its init starts,
# and over inits it spreads 50x (a ReLU that flips on a hot row); the sharp
# check is the one-step bound of _one_step_row_check
MESH_SEED = 0                           # phase 16's params (tests/rehearse_mesh.py varies it)
MESH_HOST_INIT = False                  # draw them on the host (tests/rehearse_mesh.py --host-init)
MESH_DRIFT_BOUND = {"bf16": 2.3e-3, "int8": 2.2e-2}
MESH_CHAOS = ("--chaos", "kill@1:read,transient@2:read:1", "--lease-timeout", "0.2")


def _diff_stats(torch, a, b, chunk=1 << 22):
    """``(max |a - b|, sum (a - b)^2)`` over two same-shaped tensors, in row
    chunks (a full-width table's difference would take another 26 GB); ``b``
    may lie on another device."""
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    rows = max(1, chunk // max(a2.shape[1], 1))
    mx, sq = 0.0, 0.0
    for i in range(0, a2.shape[0], rows):
        d = (a2[i:i + rows] - b2[i:i + rows].to(a2.device)).to(torch.float64)
        mx, sq = max(mx, float(d.abs().max())), sq + float(d.square().sum())
    return mx, sq


MESH_EMBED_LR = 0.01                    # make_mesh_train_step's Adagrad default
MESH_ACC0 = 0.1                         # and its initial accumulator


def _one_step_row_check(torch, codec, host_embed, idx_off, rows_off, acc_off, one, idx_one):
    """Largest ``|change| / bound`` over every element of the rows one step
    touched, and their count: the codec run's row step against the off
    run's, from the same params and batch (so the same gradient ``g``).

    Adagrad's row step is ``lr g / sqrt(acc)``, so with the wire's ``g'``
    exactly ``s' - s = lr (g' - g) / sqrt(acc') + s (sqrt(acc) -
    sqrt(acc')) / sqrt(acc')``, each accumulator read from its run. The
    codec's wire error bounds ``|g' - g|``: bf16 rounds to nearest,
    within ``2^-8 |g|``; int8 within half its scale, ``max |g| / 127 / 2``
    over the working set (no residual on it). ``g`` is read back from the
    off run's step, ``s sqrt(acc) / lr``; eight fp32 roundings of the
    rows and steps are the slack. The bound comes from the codec's
    arithmetic, not from a reading."""
    idx = torch.unique(torch.cat([idx_off, idx_one]))
    pos = torch.searchsorted(idx_off, idx).clamp(max=max(idx_off.numel() - 1, 0))
    hit = idx_off[pos] == idx if idx_off.numel() else torch.zeros_like(idx, dtype=torch.bool)
    f64 = torch.float64
    row0 = host_embed[idx.cpu()].to(idx.device, f64)
    s_off = torch.where(hit[:, None], rows_off[pos].to(f64), row0) - row0
    a_off = torch.where(hit, acc_off[pos].to(f64), torch.full_like(row0[:, 0], MESH_ACC0))
    s_one = one["params"]["embed"][idx].to(f64) - row0
    a_one = one["opt"]["embed_accum"][idx].to(f64)
    g = s_off * a_off.sqrt()[:, None] / MESH_EMBED_LR
    if codec == "bf16":
        wire = 2.0 ** -8 * g.abs()
    else:
        wire = (g.abs().max() / 127 / 2 * (1 + 1e-5)).expand_as(g)
    bound = (MESH_EMBED_LR * wire / a_one.sqrt()[:, None]
             + s_off.abs() * ((a_off.sqrt() - a_one.sqrt()).abs() / a_one.sqrt())[:, None]
             + 8 * 2.0 ** -24 * (row0.abs() + s_off.abs() + s_one.abs()))
    ratio = (s_one - s_off).abs() / bound.clamp(min=1e-300)    # 0 where both are 0
    return float(ratio.max()), int(idx.numel())


def _bit_equal(torch, a, b, chunk=1 << 22) -> bool:
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    rows = max(1, chunk // max(a2.shape[1], 1))
    return all(torch.equal(a2[i:i + rows].view(torch.int32), b2[i:i + rows].view(torch.int32))
               for i in range(0, a2.shape[0], rows))


def phase_mesh(torch, dev):
    """Phase 16: the streaming cell (phase 10's shards and params) trained
    by the mesh step at 1x1 on an NCCL group of one: ``--mesh 1x1
    --compress off`` in turns with the sparse step (no ``--mesh``) from the
    same params (sparse, mesh, mesh, sparse; 8 steps a run), every loss,
    param and accumulator bit for bit the sparse step's, ms per step of
    both, the launches of the mesh path; then ``--compress bf16`` and
    ``int8`` from the same params: one step's rows against one ``off``
    step's within the codec's own error (:func:`_one_step_row_check`),
    then over the same two runs the largest row drift from the ``off``
    run within :data:`MESH_DRIFT_BOUND` (from ``tests/rehearse_mesh.py``),
    the residual non-zero, the comm
    stats' bytes the plan's, and the codec's encode time per step from
    the profiler."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import write_log_shards
    from repro_torch.launch import train
    from repro_torch.models import recsys as R
    from repro_torch.train import compression
    from repro_torch.train.optimizer import adamw

    cfg = capped_config()
    spec = get_arch("dlrm-mlperf")
    data_dir = tempfile.mkdtemp(prefix="fbmesh_")
    try:
        write_log_shards(data_dir, n_shards=STREAM_SHARDS, rows_per_shard=TRAIN_ROWS, seed=0)
        opt = adamw(LR)
        gen = torch.Generator(device="cpu" if MESH_HOST_INIT else dev).manual_seed(MESH_SEED)
        params = {k: v.to(dev) for k, v in R.init_params(cfg, gen).items()}
        plan = featureplan.compile(get_spec("dlrm"))
        calibrate_output_layer(torch, params, cfg, plan, plan.model_feed(cfg), dev)
        init = R.make_sparse_train_step(cfg, opt)[1]
        capacity = plan.model_feed(dataclasses.replace(cfg, dedup_capacity=0),
                                   split_sparse_fields=True,
                                   rows_hint=TRAIN_ROWS).config.dedup_capacity
        host_embed = params["embed"].to("cpu", copy=True)   # each codec run starts here
        dense0 = {k: v.clone() for k, v in params.items() if k != "embed"}

        def fresh():
            p = {k: v.clone() for k, v in dense0.items()}
            p["embed"] = host_embed.to(dev, copy=True)
            return {"params": p, "opt": init(p)}

        def args(*extra, steps=TRAIN_STEPS):
            return train.parse_args(["--arch", "dlrm-mlperf", "--data-dir", data_dir,
                                     "--spec", "dlrm", "--device-feed", "arena",
                                     "--fault-tolerant", "--steps", str(steps),
                                     "--device", dev.type, *extra])

        def run(state, *extra, steps=TRAIN_STEPS):
            _reset_launches()
            stats, losses = train.run_streaming(args(*extra, steps=steps), spec, cfg, state, opt)
            return stats, losses, _read_launches()

        def changed_rows(embed, chunk=1 << 17):
            """Rows of ``embed`` that differ from the initial table."""
            out = []
            for i in range(0, embed.shape[0], chunk):
                d = (embed[i:i + chunk] != host_embed[i:i + chunk].to(dev)).any(1)
                out.append(d.nonzero().squeeze(1) + i)
            return torch.cat(out)

        # the NCCL group of one and its communicator (made at the first
        # collective) before the timed turns, as every later run finds them
        from repro_torch.launch.mesh import make_train_mesh
        make_train_mesh(1, 1, device=dev)
        warm = torch.ones(1, device=dev)
        dist.all_reduce(warm)
        torch.cuda.synchronize()
        states = {"sparse": {"params": params, "opt": init(params)}, "mesh": fresh()}
        flags = {"sparse": (), "mesh": ("--mesh", "1x1", "--compress", "off")}
        per_step = {"feature_hash": 2, "interaction_dot": 1, "interaction_dot_backward": 1,
                    "mempool_alloc": 1, "ws_grad": 1}
        losses, ms, launches = collections.defaultdict(list), collections.defaultdict(list), None
        for kind in ("sparse", "mesh", "mesh", "sparse"):
            stats, ls, n = run(states[kind], *flags[kind])
            check(n == {k: v * TRAIN_STEPS for k, v in per_step.items()},
                  f"{kind} launches {n}")
            if kind == "mesh" and launches is None:
                launches = n            # the mesh path's: from 0 just before, read just after
                check(stats.comm is not None and stats.comm.steps == TRAIN_STEPS,
                      f"mesh comm stats {stats.comm}")
            losses[kind].append(ls)
            ms[kind].append(round(stats.wall_seconds * 1e3 / stats.batches, 3))
        check(dist.is_initialized() and dist.get_backend() == "nccl"
              and dist.get_world_size() == 1, "the 1x1 mesh's group is not NCCL of one")
        sp, me = states["sparse"], states["mesh"]
        same_params = all(_bit_equal(torch, sp["params"][k], me["params"][k])
                          for k in sp["params"])
        same_accum = _bit_equal(torch, sp["opt"]["embed_accum"], me["opt"]["embed_accum"])
        same_dense = sp["opt"]["dense"]["step"] == me["opt"]["dense"]["step"] and all(
            torch.equal(sp["opt"]["dense"][m][k], me["opt"]["dense"][m][k])
            for m in ("m", "v") for k in sp["opt"]["dense"][m])
        check(losses["sparse"] == losses["mesh"] and same_params and same_accum and same_dense,
              f"1x1 mesh vs sparse step: losses equal {losses['sparse'] == losses['mesh']}, "
              f"params {same_params}, accumulators {same_accum}, dense state {same_dense}")
        print(f"mesh 1x1 --compress off vs the sparse step (turns sparse, mesh, mesh, sparse; "
              f"{TRAIN_STEPS} steps a run): bit for bit equal losses "
              f"{losses['sparse'] == losses['mesh']}, params {same_params}, accumulators "
              f"{same_accum}, Adam state {same_dense}; wall ms per step sparse {ms['sparse']} "
              f"mesh {ms['mesh']}; "
              f"mesh launches {launches}; losses {[round(x, 5) for x in losses['mesh'][0]]}")
        del states["sparse"], sp, params
        torch.cuda.empty_cache()

        # the same mesh run under chaos (a reader killed, reaped after the
        # short lease and reissued; a transient read retried): the ordered
        # stream yields the same batches, so the same losses and launches
        st, log = fresh(), io.StringIO()
        with contextlib.redirect_stdout(log):
            _, ls, n = run(st, "--mesh", "1x1", "--compress", "off", *MESH_CHAOS)
        lines = [ln for ln in log.getvalue().splitlines() if ln.startswith(("chaos:", "fault:"))]
        fired = [ln for ln in lines if ln.startswith("chaos: fired")]
        check(ls == losses["mesh"][0] and n == launches
              and fired == ["chaos: fired {'kill': 1, 'transient': 1}"],
              f"mesh 1x1 under chaos: losses equal {ls == losses['mesh'][0]}, launches {n} "
              f"(without chaos {launches}), {lines}")
        print(f"mesh 1x1 --compress off {' '.join(MESH_CHAOS)}: losses bit for bit the run "
              f"without chaos {ls == losses['mesh'][0]}, launches {n}; " + "; ".join(lines))
        del st
        torch.cuda.empty_cache()

        # one step from the same params, off: the touched rows, their values
        # and accumulators (a second full table would not fit beside these)
        one = fresh()
        run(one, "--mesh", "1x1", "--compress", "off", steps=1)
        idx_off = changed_rows(one["params"]["embed"])
        rows_off = one["params"]["embed"][idx_off].clone()
        acc_off = one["opt"]["embed_accum"][idx_off].clone()
        del one
        torch.cuda.empty_cache()
        row_step = None                 # the off run's (largest, sum of squares)
        for codec in ("bf16", "int8"):
            one = fresh()
            run(one, "--mesh", "1x1", "--compress", codec, steps=1)
            ratio, n_rows = _one_step_row_check(torch, codec, host_embed, idx_off, rows_off,
                                                acc_off, one, changed_rows(one["params"]["embed"]))
            check(ratio <= 1.0, f"{codec}: one step's rows off their bound, |change| / bound "
                                f"{ratio}")
            print(f"mesh 1x1 --compress {codec}, one step from the off run's params, each "
                  f"element of the {n_rows} touched rows against the off step's, bounded by the "
                  f"codec's wire error carried through Adagrad: largest |change| / bound "
                  f"{ratio:.6g} (bound 1)")
            del one
            torch.cuda.empty_cache()
            st = fresh()
            encode = "_bf16_encode" if codec == "bf16" else "_int8_encode"
            real = getattr(compression, encode)

            def marked(*a, real=real):
                with torch.profiler.record_function("comm.encode"):
                    return real(*a)

            with mock.patch.object(compression, encode, marked), torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA]) as prof:
                stats, ls1, _ = run(st, "--mesh", "1x1", "--compress", codec)
            _, ls2, _ = run(st, "--mesh", "1x1", "--compress", codec)
            # the host range's device time is its kernels'; the profiler also
            # mirrors the range on the device's timeline, which is not work
            enc = [e for e in prof.events() if e.name == "comm.encode"
                   and e.device_type == torch.autograd.DeviceType.CPU]
            enc_ms = (sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                          for e in enc) / 1e3 / TRAIN_STEPS)
            calls = len(enc) / TRAIN_STEPS
            # Adam moves every dense param by about lr a step whatever its
            # gradient (ROADMAP C6), so the dense drift is read, not bounded;
            # a row's Adagrad step scales with its gradient. Each drift is
            # also read beside the off run's own step from the same params
            dense_rel, dense_drift = 0.0, 0.0
            for k in me["params"]:
                if k != "embed":
                    mx, sq = _diff_stats(torch, st["params"][k], me["params"][k])
                    step_sq = _diff_stats(torch, me["params"][k], dense0[k])[1]
                    dense_drift = max(dense_drift, mx)
                    dense_rel = max(dense_rel, math.sqrt(sq / step_sq) if step_sq else math.inf)
            row_drift, row_sq = _diff_stats(torch, st["params"]["embed"], me["params"]["embed"])
            if row_step is None:
                row_step = _diff_stats(torch, me["params"]["embed"], host_embed)
            rows_rel = row_drift / row_step[0]
            rows_rel_l2 = math.sqrt(row_sq / row_step[1])
            bound = MESH_DRIFT_BOUND[codec]
            res = float(st["opt"]["comm_residual"].abs().max())
            comm = stats.comm
            ids = R.batch_id_count(cfg, TRAIN_ROWS)
            want = compression.CommPlan.for_step(
                n_pods=1, inner=1, compress=codec, hierarchical=True, capacity=capacity,
                embed_dim=cfg.embed_dim, n_dense_elems=R.dense_param_elems(cfg),
                local_capacity=ids, ids_per_device=ids)
            bytes_ok = (comm.plan == want and comm.steps == TRAIN_STEPS
                        and comm.interpod_bytes_total
                        == TRAIN_STEPS * want.interpod_bytes_per_step)
            check(row_drift <= bound and res > 0
                  and bytes_ok and all(math.isfinite(x) for x in ls1 + ls2),
                  f"{codec}: rows' drift {row_drift} (bound {bound}), "
                  f"residual {res}, comm bytes as planned {bytes_ok}")
            print(f"mesh 1x1 --compress {codec} after {2 * TRAIN_STEPS} steps: largest drift "
                  f"from the off run of an embedding row {row_drift:.6g} (bound {bound}), of a "
                  f"dense param {dense_drift:.6g} (not bounded: Adam caps it); beside the off "
                  f"run's own step: rows {rows_rel:.6g} (L2 {rows_rel_l2:.6g}; largest row step "
                  f"{row_step[0]:.6g}), largest dense leaf (L2) {dense_rel:.6g}; "
                  f"max |residual| {res:.6g}; comm {comm.summary()} (plan == CommPlan.for_step "
                  f"{bytes_ok}); encode {enc_ms:.4f} device ms per step over {calls:.0f} "
                  f"calls per step (profiled run); losses {[round(x, 5) for x in ls1 + ls2]}")
            del st
            torch.cuda.empty_cache()
        del me, states
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    return launches


def phase_hierarchy(torch, dev):
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.configs.dlrm_mlperf import CONFIG
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import write_log_shards
    from repro_torch.launch import train
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    cfg = dataclasses.replace(
        CONFIG, vocab_sizes=tuple(min(v, HIER_VOCAB_CAP) for v in CONFIG.vocab_sizes))
    spec = get_arch("dlrm-mlperf")
    data_dir = tempfile.mkdtemp(prefix="fbshards_")
    ps_dir = tempfile.mkdtemp(prefix="fbps_")
    try:
        write_log_shards(data_dir, n_shards=STREAM_SHARDS, rows_per_shard=TRAIN_ROWS, seed=0)

        def args(embedding, steps=TRAIN_STEPS):
            # --fault-tolerant: shards in plan order, so every run sees the
            # same batches
            return train.parse_args(["--arch", "dlrm-mlperf", "--data-dir", data_dir,
                                     "--spec", "dlrm", "--device-feed", "on",
                                     "--fault-tolerant", "--steps", str(steps),
                                     "--embedding", embedding, "--ps-dir", ps_dir,
                                     "--host-cache-rows", str(HIER_HOST_CACHE_ROWS),
                                     "--device", dev.type])

        t0 = time.perf_counter()
        ps = train.open_ps(args("hierarchy"), cfg)    # the driver's own file and init
        init_s = time.perf_counter() - t0
        rows, dim, path = ps.total_rows, ps.dim, ps.path
        nbytes = rows * dim * 4
        print(f"hierarchy setup (reduced: every vocabulary capped at {HIER_VOCAB_CAP:,} rows; "
              f"the full Criteo-1TB table has 187,767,399): PS file {rows:,} rows x {dim} fp32 "
              f"= {nbytes / 2**30:.2f} GiB in {ps_dir}, init {init_s:.2f} s "
              f"= {nbytes / init_s / 1e9:.3f} GB/s; host cache {HIER_HOST_CACHE_ROWS:,} rows")

        # The table backend's state: the same rows, loaded onto the card from
        # the file, and the same dense params.
        t0 = time.perf_counter()
        opt = adamw(LR)
        dense = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              include_embed=False)
        embed = torch.zeros((cfg.padded_rows, cfg.embed_dim), dtype=torch.float32, device=dev)
        accum = torch.full((cfg.padded_rows,), 0.1, dtype=torch.float32, device=dev)
        chunk = 1 << 20
        for s in range(0, rows, chunk):
            block = torch.from_numpy(np.array(ps._ssd[s:s + chunk])).to(dev)
            embed[s:s + len(block)] = block[:, :-1]
            accum[s:s + len(block)] = block[:, -1]
        del ps, block
        params = dict(dense, embed=embed)
        plan = featureplan.compile(get_spec("dlrm"))
        calibrate_output_layer(torch, params, cfg, plan, plan.model_feed(cfg), dev)
        table = {"params": params, "opt": R.make_sparse_train_step(cfg, opt)[1](params)}
        table["opt"]["embed_accum"].copy_(accum)
        del accum
        dense = {k: v.clone() for k, v in params.items() if k != "embed"}
        hier = {"params": dense, "opt": R.make_hierarchy_train_step(cfg, opt)[1](dense)}
        torch.cuda.synchronize()
        print(f"hierarchy table backend: {rows:,} rows loaded onto the card from the PS file, "
              f"{time.perf_counter() - t0:.2f} s")

        states = {"hierarchy": hier, "table": table}
        per_step = {"feature_hash": 2, "interaction_dot": 1, "interaction_dot_backward": 1,
                    "mempool_alloc": 1, "ws_grad": 1}

        def run(kind, steps=TRAIN_STEPS):
            _reset_launches()        # the path: counts from 0, read just after
            stats, losses = train.run_streaming(args(kind, steps), spec, cfg, states[kind], opt)
            torch.cuda.synchronize()
            launches = _read_launches()
            check(len(losses) == steps and all(math.isfinite(x) for x in losses),
                  f"{kind} losses {losses}")
            check(launches == {k: n * steps for k, n in per_step.items()}
                  and stats.feed.batches == steps, f"{kind} launches {launches}")
            return stats.wall_seconds * 1e3 / stats.batches, losses, launches, stats

        def compare_rows():
            """The PS file against the table backend's rows, on the card:
            rows touched (an accumulator moved in either), rows not bit-equal,
            and the largest differences over all rows."""
            mm = np.memmap(path, dtype=np.float32, mode="r", shape=(rows, dim))
            touched, differ, row_err, acc_err = 0, 0, 0.0, 0.0
            t_embed, t_accum = table["params"]["embed"], table["opt"]["embed_accum"]
            for s in range(0, rows, chunk):
                block = torch.from_numpy(np.array(mm[s:s + chunk])).to(dev)
                t_rows, t_acc = t_embed[s:s + len(block)], t_accum[s:s + len(block)]
                touched += int(((t_acc != 0.1) | (block[:, -1] != 0.1)).sum())
                differ += int(((block[:, :-1] != t_rows).any(dim=1)
                               | (block[:, -1] != t_acc)).sum())
                row_err = max(row_err, float((block[:, :-1] - t_rows).abs().max()))
                acc_err = max(acc_err, float(((block[:, -1] - t_acc).abs() / t_acc).max()))
            del mm
            return touched, differ, row_err, acc_err

        order = ("hierarchy", "table", "table", "hierarchy")
        runs = []
        for i, kind in enumerate(order):
            runs.append((kind,) + run(kind))
            if i % 2:
                (_, _, a, *_), (_, _, b, *_) = runs[-2:]
                losses_h, losses_t = (a, b) if runs[-2][0] == "hierarchy" else (b, a)
                loss_err = max(abs(x - y) / abs(y) for x, y in zip(losses_h, losses_t))
                touched, differ, row_err, acc_err = compare_rows()
                print(f"hierarchy vs table after {(i + 1) // 2 * TRAIN_STEPS} steps each: "
                      f"losses max rel err={loss_err:.3e} (first step equal: "
                      f"{losses_h[0] == losses_t[0]}; all bit-equal: {losses_h == losses_t}); "
                      f"rows touched={touched:,} of {rows:,}, not bit-equal={differ:,}, "
                      f"max abs err={row_err:.3e}, accumulators max rel err={acc_err:.3e}")
                check(i > 1 or losses_h[0] == losses_t[0],
                      f"first hierarchy loss {losses_h[0]} != table loss {losses_t[0]}")
                check(loss_err <= HIER_LOSS_RTOL and row_err <= HIER_ROW_ATOL
                      and acc_err <= HIER_ACCUM_RTOL and touched > 0,
                      f"hierarchy vs table: losses {losses_h} vs {losses_t}, rows {row_err}, "
                      f"accumulators {acc_err}, touched {touched}")
        for kind, ms, losses, launches, stats in runs:
            line = (f"hierarchy run={kind} steps={TRAIN_STEPS} wall_ms_per_step={ms:.3f} "
                    f"losses={[round(x, 5) for x in losses]} launches_per_step="
                    f"{ {k: n / TRAIN_STEPS for k, n in launches.items()} } "
                    f"fe_seconds={stats.fe_seconds:.4f} train_seconds={stats.train_seconds:.4f} "
                    f"wall_seconds={stats.wall_seconds:.4f}")
            if stats.ps is not None:
                f, t, n = stats.ps.stats, stats.ps.tier, TRAIN_STEPS
                line += (f" ps_stage_s_per_step={stats.ps_seconds / n:.4f} "
                         f"pull_s_per_step={f.pull_seconds / n:.4f} "
                         f"wait_s_per_step={f.wait_seconds / n:.4f} "
                         f"push_s_per_step={f.push_seconds / n:.4f} "
                         f"fixups_per_step={f.fixups / n:.3f} "
                         f"fixup_rows_per_step={f.fixup_rows / n:.1f} "
                         f"pulled_rows_per_step={t.pulled_rows / n:.1f} "
                         f"host_hit_rate={t.host_hit_rate:.4f} "
                         f"ssd_reads_per_step={t.ssd_reads / n:.1f} "
                         f"evictions_per_step={t.evictions / n:.1f}")
            print(line)
        by_kind = collections.defaultdict(list)
        for kind, ms, *_ in runs:
            by_kind[kind].append(round(ms, 3))
        print(f"hierarchy vs table, wall ms per step (order {', '.join(order)}): "
              f"{dict(by_kind)} peak_mem_gib={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
        with marked_steps(torch):
            profiled = {kind: profile_device(
                torch, "step", STREAM_SHARDS,
                lambda kind=kind: train.run_streaming(args(kind, STREAM_SHARDS), spec, cfg,
                                                      states[kind], opt), mark=STEP_MARK)
                for kind in ("hierarchy", "table")}
        for kind, res in profiled.items():
            if res is not None:
                wall = statistics.median(by_kind[kind])
                print(f"hierarchy idle share of {kind}: device busy {res[0]:.3f} ms/step "
                      f"(profiled) over its unprofiled median wall {wall:.3f} ms/step = "
                      f"{1 - res[0] / wall:.3f}")
        launches = runs[0][3]
        del states, hier, table, params, dense, embed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
        shutil.rmtree(ps_dir, ignore_errors=True)
    return launches


# Card against JAX, every loss of the four curves of tests/data/jax_loss_curves.npz
# (written in PERF.md before the first chip run): fp32 sums in another order,
# compounded over 24 steps (the port's CPU chains reach 3.2e-7; Adam-updated
# params are not compared)
CURVE_RTOL = 1e-4
INMEM_ARCHS = ("dlrm-mlperf", "dcn-v2", "autoint")
SERVE_INTERIOR = 1e-6                   # a pCTR strictly inside (1e-6, 1 - 1e-6) is not saturated
# The first full-width step, card against the CPU (written in PERF.md before
# the first chip run, from fp32 against fp64 on the CPU at these shapes,
# tests/rehearse_first_step.py). Loss: rtol FIRST_LOSS_RTOL. Dense gradients,
# per element: within FIRST_DENSE_TOL x the tensor's largest |gradient|.
# Working-row gradients, per element: within FIRST_ROW_TOL x max(S_rj, G),
# S_rj the sum of |g_j| over the occurrences of row r in the batch (the
# CPU's gradient of each occurrence) and G the largest |g| of one
# occurrence; a ReLU within rounding of its kink may take the other side on
# the card, so up to FIRST_ROW_EXCEPTIONS rows may miss that bound, each
# within FIRST_ROW_FLIP_TOL x max(S_rj, G). The index backward alone, on the
# card: each working row's gradient within (c_r + 1) x 2**-24 x S'_rj of the
# float64 sum of the card's own gradients of its c_r occurrences (S' their
# |g_j| summed): any order of c_r - 1 fp32 additions stays within
# (c_r - 1) x 2**-24 x S' (to first order), and each side is rounded once.
FIRST_LOSS_RTOL = 1e-5
FIRST_DENSE_TOL = 1e-2
FIRST_ROW_TOL = 1e-2
FIRST_ROW_EXCEPTIONS = 16
FIRST_ROW_FLIP_TOL = 0.5
# serving logits, card against the CPU, per element: LOGIT_TOL x (|l| + max |l|)
LOGIT_TOL = 1e-4


def phase_jax_curves(torch, dev):
    """The smoke curves of the fixture and ``full/pna`` on the card
    (``tests/curve_fixture.py`` reads it with numpy alone and runs the
    port's chain of each curve, as the CPU parity test does): each chain
    from JAX's init params (or the fixture's numpy-drawn ones) through the
    port's entry point (``run_in_memory``, ``run_training`` on the one
    graph of ``full/pna``, or ``run_streaming`` over shards the port's
    ``write_log_shards`` writes with the curve's seed and sizes), every
    loss within ``CURVE_RTOL``; the chaotic PNA curves their first loss
    within ``PNA_FIRST_RTOL`` and every loss within ``PNA_RTOL`` (from
    ``tests/rehearse_pna.py``). Returns the launches of each chain."""
    sys.path.insert(0, str(ROOT / "tests"))
    import curve_fixture

    from repro_torch.configs import get_arch

    by_path, devs = {}, {}
    fixture = curve_fixture.load()
    for curve in sorted(curve_fixture.SMOKE_CURVES) + ["full/pna"]:   # full/bst: phase 14
        entry = fixture[curve]
        kind, arch = curve.split("/")
        _reset_launches()        # this path: counts from 0, read just after
        losses = curve_fixture.port_losses(curve, entry, dev)
        torch.cuda.synchronize()
        got = by_path[f"curve {curve}"] = _read_launches()
        steps = int(entry["steps"])
        dlrm = {"interaction_dot": 1, "interaction_dot_backward": 1} if arch == "dlrm-mlperf" else {}
        # the dlrm spec's FE runs two feature_hash layers, the bst spec's one
        per_step = (dict(dlrm, feature_hash=2 if arch == "dlrm-mlperf" else 1, mempool_alloc=1)
                    if kind == "stream" else dlrm)
        if get_arch(arch).family == "recsys":   # the sparse step: one ws_grad a step
            per_step = dict(per_step, ws_grad=1)
        check(got == {k: per_step.get(k, 0) * steps for k in got}, f"{curve} launches {got}")
        want = [float(x) for x in entry["losses"]]
        check(len(losses) == len(want), f"{curve}: {len(losses)} losses for {len(want)}")
        dev_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        first_rel = abs(losses[0] - want[0]) / abs(want[0])
        devs[curve] = dev_rel
        rtol = curve_fixture.PNA_RTOL.get(curve, CURVE_RTOL)
        first_rtol = curve_fixture.PNA_FIRST_RTOL if curve in curve_fixture.PNA_RTOL else rtol
        print(f"jax curve {curve}: {len(losses)} steps at batch {int(entry['batch'])}, "
              f"lr {float(entry['lr'])}; max relative deviation from JAX {dev_rel:.3e} "
              f"(rtol {rtol}); first {losses[0]:.6f} (JAX {want[0]:.6f}, {first_rel:.3e}, rtol "
              f"{first_rtol}) last {losses[-1]:.6f} (JAX {want[-1]:.6f}); launches {got}")
        check(dev_rel <= rtol and first_rel <= first_rtol,
              f"{curve}: losses {losses} vs JAX {want}")
    print(f"jax curves: max relative deviation per curve {json.dumps(devs)}; these curves are "
          f"at the smoke configs, because JAX could not run the full-width dlrm-mlperf, "
          f"dcn-v2 and autoint tables on the CPU that wrote them (full/bst: phase 14; full/pna "
          f"is PNA at its published width)")
    return by_path


def inmemory_config(arch):
    """``dlrm-mlperf`` capped as in phases 7-10 (its full table does not fit
    in 80 GB); DCN-v2 and AutoInt at their published widths, uncapped."""
    from repro_torch.configs import get_arch

    return capped_config() if arch == "dlrm-mlperf" else get_arch(arch).config


def _dense_grad_check(name, got, want, tol):
    """Per element: |got - want| <= tol x max |want|. Returns the largest
    |got - want| / max |want|."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
    check(rel <= tol, f"dense gradient {name}: max abs err {err} vs max |g| {scale}")
    return rel


def site_shapes(torch, cfg, batch):
    """The batch's id sites (``collect_gids``) and their shapes, and the flat
    ids over the sites in sorted order (the order of the step's inverse)."""
    from repro_torch.models import recsys as R

    gids = R.collect_gids(cfg, batch)
    sites = sorted(gids)
    return {s: tuple(gids[s].shape) for s in sites}, torch.cat([gids[s].reshape(-1) for s in sites])


def occurrence_grads(torch, params, cfg, batch, working, inverse):
    """The loss gradient of each occurrence of a working row (one row per
    sample and id site, f32[n_ids, D]): the sparse step's backward with every
    occurrence its own working row, so nothing is summed over occurrences.
    ``inverse`` maps each of the batch's ids to its row of ``working``."""
    from repro_torch.embedding.dedup import take_rows
    from repro_torch.models import recsys as R

    occ = take_rows(working, inverse)
    ident = torch.arange(occ.shape[0], dtype=torch.int32, device=occ.device)
    return R.working_set_grads(params, cfg, batch, occ, ident, torch.tensor(occ.shape[0]),
                               ident, site_shapes(torch, cfg, batch)[0]).working_grad


def row_grad_ratios(torch, got, want, occ_want, inverse, n):
    """Working-row gradients ``got`` against ``want`` (the first ``n`` rows):
    per element |got - want| / max(S_rj, G), S_rj the sum of |g_j| over the
    occurrences of row r in ``occ_want`` (f32[n_ids, D], the gradient of
    each occurrence, :func:`occurrence_grads`) and G its largest |g|.
    Returns (ratios f64[n, D], the bounds' scale max(S_rj, G), G, the
    occurrences of each row f64[n, 1])."""
    idx = inverse.reshape(-1).to(torch.int64)
    s = torch.zeros((n, got.shape[1]), dtype=torch.float64)
    s.index_add_(0, idx, occ_want.double().abs())
    big_g = float(occ_want.abs().max())
    scale = s.clamp_min(big_g)
    counts = torch.bincount(idx, minlength=n).to(torch.float64)[:, None]
    return (got[:n].double() - want[:n].double()).abs() / scale, scale, big_g, counts


def index_backward_ratios(torch, got, occ_got, inverse, n):
    """The index backward alone: working-row gradients ``got`` (the first
    ``n`` rows) against the float64 sum of their occurrences' gradients
    ``occ_got`` (the same step's, :func:`occurrence_grads`), per element
    over the bound (c_r + 1) x 2**-24 x S'_rj, S'_rj the sum of |g_j| over
    the c_r occurrences. Returns (ratios f64[n, D], bounds f64[n, D])."""
    idx = inverse.reshape(-1).to(torch.int64)
    occ = occ_got.double()
    total = torch.zeros((n, got.shape[1]), dtype=torch.float64).index_add_(0, idx, occ)
    s = torch.zeros((n, got.shape[1]), dtype=torch.float64).index_add_(0, idx, occ.abs())
    counts = torch.bincount(idx, minlength=n).to(torch.float64)[:, None]
    bound = (counts + 1) * 2.0 ** -24 * s
    err = (got[:n].double() - total).abs()
    ratio = torch.where(bound > 0, err / bound.clamp_min(1e-300),
                        torch.where(err > 0, math.inf, 0.0))
    return ratio, bound


def heavy_rows(torch, want, counts, bounds, k=3):
    """The ``k`` working rows of the most occurrences: for each, c_r, the
    largest |gradient| of the row and each named bound at that element."""
    out = []
    for r in counts[:, 0].argsort(descending=True)[:k].tolist():
        j = int(want[r].abs().argmax())
        out.append(f"c={int(counts[r, 0]):,} |g|={float(want[r, j].abs()):.3e} "
                   + " ".join(f"{name}={float(b[r, j]):.3e}" for name, b in bounds.items()))
    return "; ".join(out)


def first_step_against_cpu(torch, cfg, params, batch, dev):
    """One sparse step's loss and gradients on the card against the CPU on
    the same params and batch: the working set is deduped and gathered on
    the card and copied over, so the CPU needs no copy of the table. The
    index backward is also checked alone, against the card's own gradient
    of each occurrence. The bounds are ``FIRST_*`` above. Returns a
    printable summary."""
    from repro_torch.embedding.dedup import FILL, dedup, take_rows
    from repro_torch.models import recsys as R

    ws = R.sparse_grads(params, cfg, batch)                       # the card's step
    n = int(ws.n_unique)
    shapes, gids = site_shapes(torch, cfg, batch)
    unique, inverse, n_cpu = dedup(gids.cpu(), capacity=ws.unique.shape[0])
    check(torch.equal(unique, ws.unique.cpu()) and int(n_cpu) == n,
          "the CPU's working set differs from the card's")
    working = take_rows(params["embed"], torch.where(ws.unique == FILL, 0, ws.unique)).cpu()
    dense = {k: v.cpu() for k, v in params.items() if k != "embed"}
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    ref = R.working_set_grads(dense, cfg, batch_cpu, working, unique, n_cpu, inverse, shapes)
    loss, loss_cpu = float(ws.loss), float(ref.loss)
    check(math.isfinite(loss) and abs(loss - loss_cpu) <= FIRST_LOSS_RTOL * abs(loss_cpu),
          f"first step loss {loss} vs the CPU's {loss_cpu}")
    dense_rel = {k: _dense_grad_check(k, ws.dense_grads[k].cpu(), g, FIRST_DENSE_TOL)
                 for k, g in ref.dense_grads.items()}
    got = ws.working_grad[:n].cpu()
    occ_card = occurrence_grads(torch, params, cfg, batch, ws.working, inverse.to(dev)).cpu()
    idx_ratio, idx_bound = index_backward_ratios(torch, got, occ_card, inverse, n)
    del occ_card
    check(float(idx_ratio.max()) <= 1.0,
          f"index backward: a working row's gradient is {float(idx_ratio.max())} x its "
          f"bound from the sum of its occurrences' gradients")
    occ_cpu = occurrence_grads(torch, dense, cfg, batch_cpu, working, inverse)
    ratio, scale, big_g, counts = row_grad_ratios(torch, got, ref.working_grad, occ_cpu,
                                                  inverse, n)
    del occ_cpu
    over = ratio.amax(dim=1) > FIRST_ROW_TOL
    n_over = int(over.sum())
    worst = int(ratio.amax(dim=1).argmax())
    check(big_g > 0 and n_over <= FIRST_ROW_EXCEPTIONS
          and float(ratio.max()) <= FIRST_ROW_FLIP_TOL,
          f"working-row gradients: {n_over} rows over {FIRST_ROW_TOL} x max(S_rj, G) "
          f"(G={big_g}), largest ratio {float(ratio.max())} at a row of "
          f"{int(counts[worst])} occurrences")
    nonzero = int((ws.working_grad[:n].abs().amax(dim=1) > 0).sum())
    check(nonzero >= 0.99 * n, f"only {nonzero} of {n} working rows have a gradient")
    want = ref.working_grad[:n].double()
    # the bounds beside the values they bound, on the rows of many occurrences
    heavy = counts[:, 0] >= 64
    jmax = want.abs().argmax(dim=1, keepdim=True)
    top = want.abs().gather(1, jmax)[heavy]
    idx_share = float((idx_bound.gather(1, jmax)[heavy] / top).max()) if heavy.any() else 0.0
    row_share = (float((FIRST_ROW_TOL * scale.gather(1, jmax)[heavy] / top).max())
                 if heavy.any() else 0.0)
    heaviest = heavy_rows(torch, want, counts,
                          {"index_bound": idx_bound, "row_bound": FIRST_ROW_TOL * scale})
    k_worst = max(dense_rel, key=dense_rel.get)
    return (f"loss {loss:.9f} cpu {loss_cpu:.9f} (rel {abs(loss - loss_cpu) / abs(loss_cpu):.2e}, "
            f"rtol {FIRST_LOSS_RTOL}); {n:,} working rows, occurrences up to "
            f"{int(counts.max()):,}, G={big_g:.3e}; index backward on the card: largest "
            f"|card - sum of its occurrences| / ((c_r + 1) 2^-24 S'_rj) "
            f"{float(idx_ratio.max()):.3e} (bound 1); row grads card vs cpu: largest "
            f"|card - cpu| / max(S_rj, G) {float(ratio.max()):.3e} at a row of "
            f"{int(counts[worst])} occurrences, rows over {FIRST_ROW_TOL}: {n_over} (up to "
            f"{FIRST_ROW_EXCEPTIONS}, each within {FIRST_ROW_FLIP_TOL}); max abs err "
            f"{float((got.double() - want).abs().max()):.3e} vs max |g| "
            f"{float(want.abs().max()):.3e}; rows of 64 or more occurrences: "
            f"{int(heavy.sum()):,}, at each one's largest |g| the index bound is at most "
            f"{idx_share:.3e} of it and the card-vs-cpu bound at most {row_share:.3e}; "
            f"heaviest rows: {heaviest}; dense grads: largest |card - cpu| / max|g| {dense_rel[k_worst]:.3e} "
            f"({k_worst}; tol {FIRST_DENSE_TOL})")


def logits_against_cpu(torch, cfg, params, dense, batch):
    """The logits of ``batch`` on the card against the CPU's (``dense``:
    the dense params on the CPU; the rows of each id site gathered from the
    card's table), per element within ``LOGIT_TOL`` x (|l| + max |l|).
    Returns the largest |card - cpu| / (|l| + max |l|)."""
    from repro_torch.models import recsys as R

    with torch.no_grad():
        got = R.forward(params, cfg, batch).cpu()
        rows = {f"_rows_{site}": params["embed"][g.to(torch.int64)].cpu()
                for site, g in R.collect_gids(cfg, batch).items()}
        ref = R.forward(dense, cfg, dict({k: v.cpu() for k, v in batch.items()}, **rows))
    scale = ref.abs() + float(ref.abs().max())
    check(bool(torch.isfinite(got).all()) and bool(((got - ref).abs() <= LOGIT_TOL * scale).all()),
          f"serving logits: max abs err {float((got - ref).abs().max())} "
          f"(max |l| {float(ref.abs().max())})")
    return float(((got - ref).abs() / scale).max())


def serve_against_cpu(torch, cfg, params, dev):
    """8 synthetic batches of ``BATCH`` rows, label removed, through
    ``serve_step`` (as the JAX ``launch/serve.py`` scores an arch); each
    batch's logits on the card against the CPU's on the same rows (gathered
    from the card's table). Returns a printable summary."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import recsys as R

    batches = []
    for i in range(N_BATCHES + 1):
        b = synthetic_batch("recsys", cfg, BATCH, i, device=dev)
        b.pop("label")
        batches.append(b)
    R.serve_step(params, cfg, batches[0])                          # warm-up
    torch.cuda.synchronize()
    scores, lat_ms = [], []
    for b in batches[1:]:
        t0 = time.perf_counter()
        scores.append(R.serve_step(params, cfg, b))
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    dense = {k: v.cpu() for k, v in params.items() if k != "embed"}
    logit_err = max(logits_against_cpu(torch, cfg, params, dense, b) for b in batches[1:])
    p = torch.cat(scores)
    interior = float(((p > SERVE_INTERIOR) & (p < 1 - SERVE_INTERIOR)).float().mean())
    return (f"serve batches={N_BATCHES} batch={BATCH} latency_ms={[round(t, 3) for t in lat_ms]} "
            f"p50_ms={statistics.median(lat_ms):.3f} p99_ms={max(lat_ms):.3f} (max of "
            f"{N_BATCHES}); logits vs the CPU: largest |card - cpu| / (|l| + max|l|) "
            f"{logit_err:.3e} (tol {LOGIT_TOL}); pctr mean {float(p.mean()):.4f} min "
            f"{float(p.min()):.3e} max {float(p.max()):.6f}, share inside "
            f"({SERVE_INTERIOR}, 1 - {SERVE_INTERIOR}) {interior:.4f}")


def ids_per_row(cfg):
    """Packed ids one sample looks up (BST: the sequence and the target
    item, then the other fields)."""
    return cfg.seq_len + cfg.n_sparse if cfg.kind == "bst" else cfg.n_sparse


def train_in_memory(torch, dev, arch, cfg, tag):
    """The in-memory driver at full width for one arch: ``run_in_memory``
    (``run_training`` over ``synthetic_batch`` with the sparse step) at
    ``TRAIN_ROWS`` rows, the first step against the CPU, 1 warm-up and
    ``TRAIN_STEPS`` timed steps, launches per step, and the device idle
    share at the unprofiled wall. Returns (params, state, opt, launches of
    the timed run, a summary dict); lines are printed under ``tag``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    spec = get_arch(arch)
    t0 = time.perf_counter()
    opt = adamw(LR)
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    state = {"params": params, "opt": R.make_sparse_train_step(cfg, opt)[1](params)}
    torch.cuda.synchronize()
    n_dense = sum(v.numel() for k, v in params.items() if k != "embed")
    print(f"{tag} setup: {cfg.padded_rows:,} padded rows x {cfg.embed_dim} = "
          f"{cfg.padded_rows * cfg.embed_dim * 4 / 2**30:.2f} GiB table and "
          f"{cfg.padded_rows * 4 / 2**30:.2f} GiB of Adagrad accumulators on the card, "
          f"{n_dense:,} dense params, working-set capacity "
          f"{cfg.dedup_capacity or TRAIN_ROWS * ids_per_row(cfg):,}, "
          f"{time.perf_counter() - t0:.2f} s")
    batch0 = train.synthetic_batch(spec.family, cfg, TRAIN_ROWS, 0, device=dev)
    print(f"{tag} first step against the CPU (same params and batch): "
          f"{first_step_against_cpu(torch, cfg, params, batch0, dev)}")
    del batch0

    def args(steps):
        return train.parse_args(["--arch", arch, "--steps", str(steps),
                                 "--batch", str(TRAIN_ROWS), "--device", dev.type])

    train.run_in_memory(args(1), spec, cfg, state, opt)         # warm-up step
    torch.cuda.synchronize()
    marks = []
    real_batch = train.synthetic_batch

    def timed_batch(*a, **kw):
        marks.append(time.perf_counter())      # step k's batch: step k-1 has synced
        return real_batch(*a, **kw)

    _reset_launches()        # the path: counts from 0, read just after
    with mock.patch.object(train, "synthetic_batch", timed_batch):
        stats, losses = train.run_in_memory(args(TRAIN_STEPS + 1), spec, cfg, state, opt)
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches = _read_launches()
    steps = TRAIN_STEPS + 1
    ms = (end - marks[1]) * 1e3 / TRAIN_STEPS               # steps 1..8 of 0..8
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{arch} losses {losses}")
    per_step = {"interaction_dot": 1, "interaction_dot_backward": 1} if cfg.kind == "dlrm" else {}
    per_step["ws_grad"] = 1                     # the sparse step's one backward a step
    want = {k: per_step.get(k, 0) * steps for k in launches}
    check(launches == want, f"{arch} launches {launches}, expected {want}")
    print(f"{tag} train (run_in_memory: run_training + synthetic_batch) "
          f"rows={TRAIN_ROWS} steps={TRAIN_STEPS} (after 1 warm-up; step 0 of this run "
          f"untimed) ms_per_step={ms:.3f} losses={[round(x, 5) for x in losses]} "
          f"fe_seconds={stats.fe_seconds:.4f} train_seconds={stats.train_seconds:.4f} "
          f"launches_per_step={ {k: n / steps for k, n in launches.items()} }"
          + ("" if per_step else " (no TPU kernel on this path in either package)"))
    with marked_steps(torch):
        prof = profile_device(torch, "step", STREAM_SHARDS,
                              lambda: train.run_in_memory(args(STREAM_SHARDS), spec, cfg,
                                                          state, opt), mark=STEP_MARK)
    idle = None if prof is None else 1 - prof[0] / ms
    if prof is not None:
        # the working-set gather's backward (ROADMAP B1: the ws_grad kernels)
        ws_bwd = sum(t for name, t in prof[2].items() if "ws_grad_" in name)
        print(f"{tag} idle share at the unprofiled wall: device busy {prof[0]:.3f} "
              f"ms/step (profiled) over {ms:.3f} ms/step = {idle:.3f}; the gather's "
              f"backward (B1, ws_grad kernels) {ws_bwd:.4f} ms/step")
    summary = {"ms_per_step": ms, "losses": losses, "idle_share": idle,
               "launches_per_step": {k: n / steps for k, n in launches.items()}}
    return params, state, opt, launches, summary


def phase_in_memory(torch, dev):
    """The in-memory driver at full width, one arch after another, each
    freed before the next: :func:`train_in_memory`, then serving. Returns
    the launches of each arch's timed run."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "fp32 matmuls are not full fp32 (TF32 is on)")
    by_path, summary = {}, {}
    for arch in INMEM_ARCHS:
        cfg = inmemory_config(arch)
        torch.cuda.reset_peak_memory_stats(dev)
        params, state, opt, by_path[f"loop {arch}"], summary[arch] = train_in_memory(
            torch, dev, arch, cfg, f"inmem {arch}")
        print(f"inmem {arch} {serve_against_cpu(torch, cfg, params, dev)}")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        summary[arch]["peak_mem_gib"] = peak
        del state, params, opt
        torch.cuda.empty_cache()
        print(f"inmem {arch} peak_mem_gib={peak:.2f}; freed, "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB left allocated")
    print(f"inmem summary: {json.dumps(summary)}")
    return by_path


# full/bst, the card against JAX (written in PERF.md before the first chip
# run, from the port's CPU chain with 1 and with 8 threads, which
# tests/rehearse_bst.py prints: the first loss equal, then 1.5e-5 at step 2
# growing to 3.64e-4): the first loss within FULL_FIRST_RTOL (a dense param
# 1e-3 off moves it by 2.6e-5 or more) and every loss within FULL_RTOL
FULL_FIRST_RTOL = 1e-5
FULL_RTOL = 2e-3
BST_SHARDS = 8                          # the BST streaming run: 8 shards of TRAIN_ROWS rows
RETRIEVAL_CANDIDATES = 1_000_000
RETRIEVAL_ALONE = 512                   # the first candidates, scored again on their own
RETRIEVAL_SAMPLE = 512                  # candidates spread over the range, scored on the CPU


def bst_serve_against_cpu(torch, cfg, params, dev):
    """``N_BATCHES`` requests of ``BATCH`` raw rows through the ``bst`` spec
    (``serve_requests``: ``FeaturePlan.run`` -> ``ModelFeed.apply`` ->
    ``serve_step``), after one warm-up; each request's logits against the
    CPU's on the same model batch, with the rows gathered from the card's
    table. Returns (a printable summary, the launches of the timed
    requests)."""
    from repro_torch.core.metakernel import ExecutionStats
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import gen_views
    from repro_torch.launch.serve import serve_requests, spec_for

    plan = featureplan.compile(get_spec(spec_for(cfg)))
    feed = plan.model_feed(cfg, rows_hint=BATCH)
    serve_requests(plan, feed, params, cfg, [gen_views(BATCH, seed=98)], device=dev)  # warm-up
    requests = [gen_views(BATCH, seed=100 + i) for i in range(N_BATCHES)]
    stats = ExecutionStats()
    _reset_launches()        # the path: counts from 0, read just after
    scores, latency = serve_requests(plan, feed, params, cfg, requests, device=dev, stats=stats)
    torch.cuda.synchronize()
    launches = _read_launches()
    check(launches == {"feature_hash": N_BATCHES, "interaction_dot": 0,
                       "interaction_dot_backward": 0, "mempool_alloc": 0, "ws_grad": 0},
          f"bst serving launches {launches}")
    dense = {k: v.cpu() for k, v in params.items() if k != "embed"}
    logit_err = max(logits_against_cpu(torch, cfg, params, dense,
                                       feed.apply(feed.select(plan.run(views, device=dev))))
                    for views in requests)
    lat_ms = [t * 1e3 for t in latency]
    p = torch.cat(scores)
    interior = float(((p > SERVE_INTERIOR) & (p < 1 - SERVE_INTERIOR)).float().mean())
    return (f"serve (raw views through the bst spec) requests={N_BATCHES} batch={BATCH} "
            f"latency_ms={[round(t, 3) for t in lat_ms]} p50_ms={statistics.median(lat_ms):.3f} "
            f"p99_ms={max(lat_ms):.3f} (max of {N_BATCHES}) fe_host_ops_ms_per_request="
            f"{stats.host_seconds * 1e3 / N_BATCHES:.3f}; logits vs the CPU: largest "
            f"|card - cpu| / (|l| + max|l|) {logit_err:.3e} (tol {LOGIT_TOL}); pctr mean "
            f"{float(p.mean()):.4f} min {float(p.min()):.3e} max {float(p.max()):.6f}, share "
            f"inside ({SERVE_INTERIOR}, 1 - {SERVE_INTERIOR}) {interior:.4f}; launches "
            f"{launches}"), launches


def bst_retrieval(torch, cfg, params, dev):
    """One user against ``RETRIEVAL_CANDIDATES`` candidates in one
    ``retrieval_score`` call, timed (median of 3, each ending in a
    synchronize); the first ``RETRIEVAL_ALONE`` candidates scored again in
    a call of their own; ``RETRIEVAL_SAMPLE`` candidates spread over the
    range scored on the CPU (dense params, rows gathered from the card's
    table) and held to the card's scores. Returns a printable summary."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import recsys as R

    user = synthetic_batch("recsys", cfg, 1, 7, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    cand = torch.randint(0, cfg.vocab_sizes[cfg.item_field], (RETRIEVAL_CANDIDATES,),
                         generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) / 2**30
    times, scores = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        scores = R.retrieval_score(params, cfg, user, cand)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    alone = R.retrieval_score(params, cfg, user, cand[:RETRIEVAL_ALONE])
    err = float((scores[:RETRIEVAL_ALONE] - alone).abs().max())
    check(tuple(scores.shape) == (RETRIEVAL_CANDIDATES,) and bool(torch.isfinite(scores).all())
          and bool(((scores > 0) & (scores < 1)).all()), "retrieval scores not finite in (0, 1)")
    check(err <= 1e-5, f"retrieval: the first {RETRIEVAL_ALONE} scores differ from the same "
                       f"candidates scored alone by {err}")
    # the sample on the CPU: the user row repeated, the candidate in the item
    # field; the pCTRs within LOGIT_TOL x (|l| + max |l|) of the logits, read
    # through sigmoid's slope (at most 1/4) plus one ulp of each pCTR
    idx = torch.linspace(0, RETRIEVAL_CANDIDATES - 1, RETRIEVAL_SAMPLE,
                         dtype=torch.float64).round().to(torch.int64)
    ref_batch = {k: v.cpu().repeat((RETRIEVAL_SAMPLE,) + (1,) * (v.dim() - 1))
                 for k, v in user.items() if k != "label"}
    ref_batch["sparse"][:, cfg.item_field] = cand.cpu()[idx]
    dense = {k: v.cpu() for k, v in params.items() if k != "embed"}
    with torch.no_grad():
        rows = {f"_rows_{site}": params["embed"][g.to(dev, torch.int64)].cpu()
                for site, g in R.collect_gids(cfg, ref_batch).items()}
        ref = R.forward(dense, cfg, dict(ref_batch, **rows))
    got = scores.cpu()[idx]
    diff = (got - torch.sigmoid(ref)).abs()
    bound = 0.25 * LOGIT_TOL * (ref.abs() + float(ref.abs().max())) + 2.0 ** -23
    check(bool((diff <= bound).all()),
          f"retrieval: {int((diff > bound).sum())} of {RETRIEVAL_SAMPLE} sampled scores off the "
          f"CPU's, max abs err {float(diff.max()):.3e}")
    n_seq = RETRIEVAL_CANDIDATES * (cfg.seq_len + 1)
    return (f"retrieval candidates={RETRIEVAL_CANDIDATES:,} in one call ms={statistics.median(times):.3f} "
            f"(median of {[round(t, 3) for t in times]}) score_mean={float(scores.mean()):.4f} "
            f"first_{RETRIEVAL_ALONE}_alone_max_abs_err={err:.3e} {RETRIEVAL_SAMPLE}_spread_vs_cpu "
            f"max_abs_err={float(diff.max()):.3e} (largest share of its bound "
            f"{float((diff / bound).max()):.3e}) peak_mem_gib={peak:.2f} "
            f"(allocated before the call {base:.2f}); dedup_capacity 0, so the working set "
            f"of the sequence site has {n_seq:,} slots and the other fields' "
            f"{RETRIEVAL_CANDIDATES * (cfg.n_sparse - 1):,}; the attention scores alone are "
            f"f32[{RETRIEVAL_CANDIDATES}, {cfg.n_heads}, {cfg.seq_len + 1}, {cfg.seq_len + 1}] = "
            f"{RETRIEVAL_CANDIDATES * cfg.n_heads * (cfg.seq_len + 1) ** 2 * 4 / 1e9:.1f} GB")


def bst_streaming(torch, cfg, state, opt, dev):
    """``run_streaming`` with ``--spec bst --device-feed arena
    --fault-tolerant`` over ``BST_SHARDS`` shards of ``TRAIN_ROWS`` rows:
    the first loss against the plain loop's on the same shard and state,
    one warm-up run of 1 step, then ``TRAIN_STEPS`` steps with the
    launches of the path. Returns (a printable summary, the launches)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.devicefeed import DeviceFeeder
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import write_log_shards
    from repro_torch.io.dataset import ShardDataset
    from repro_torch.io.shardfmt import ShardReader
    from repro_torch.launch import train
    from repro_torch.models import recsys as R

    spec = get_arch("bst")
    data_dir = tempfile.mkdtemp(prefix="fbshards_bst_")
    try:
        t0 = time.perf_counter()
        write_log_shards(data_dir, n_shards=BST_SHARDS, rows_per_shard=TRAIN_ROWS, seed=0)
        write_s = time.perf_counter() - t0
        plan = featureplan.compile(get_spec("bst"))

        def args(steps):
            return train.parse_args(["--arch", "bst", "--data-dir", data_dir, "--spec", "bst",
                                     "--device-feed", "arena", "--fault-tolerant",
                                     "--steps", str(steps), "--device", dev.type])

        first = ShardDataset(data_dir).epoch_order(0, shuffle=True, seed=0)[0]
        mf_plain = plan.model_feed(cfg, rows_hint=TRAIN_ROWS)
        feeder = DeviceFeeder(plan.feed_layout(), rows_hint=TRAIN_ROWS, device=dev)
        staged = feeder.stage(plan.run(ShardReader(first.path).read_all(plan.required_columns),
                                       device=dev))
        loss_plain = float(R.sparse_grads(state["params"], mf_plain.config,
                                          mf_plain.apply(mf_plain.select(staged))).loss)
        feeder.donation_fence()
        del staged, feeder
        _, warm = train.run_streaming(args(1), spec, cfg, state, opt)   # warm-up step
        check(abs(warm[0] - loss_plain) <= 1e-6 * abs(loss_plain),
              f"first bst streaming loss {warm[0]} vs the plain loop's {loss_plain}")
        _reset_launches()        # the path: counts from 0, read just after
        stats, losses = train.run_streaming(args(TRAIN_STEPS), spec, cfg, state, opt)
        torch.cuda.synchronize()
        launches = _read_launches()
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
              f"bst streaming losses {losses}")
        want = {"feature_hash": TRAIN_STEPS, "interaction_dot": 0, "interaction_dot_backward": 0,
                "mempool_alloc": TRAIN_STEPS, "ws_grad": TRAIN_STEPS}
        check(launches == want, f"bst streaming launches {launches}, expected {want}")
        ms = stats.wall_seconds * 1e3 / stats.batches
        return (f"stream (--spec bst --device-feed arena --fault-tolerant, {BST_SHARDS} shards "
                f"x {TRAIN_ROWS} rows written in {write_s:.2f} s) steps={TRAIN_STEPS} "
                f"wall_ms_per_step={ms:.3f} fe_seconds={stats.fe_seconds:.4f} "
                f"train_seconds={stats.train_seconds:.4f} "
                f"overlap_fraction={stats.overlap_fraction:.4f} first_loss={warm[0]:.6f} "
                f"plain_loop_first_loss={loss_plain:.6f} losses={[round(x, 5) for x in losses]} "
                f"launches={launches} (feature_hash 1 and mempool_alloc 1 per batch)"), launches
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def phase_bst(torch, dev):
    """BST at its published width (0.60 GiB table), after every earlier
    phase has freed its state: the ``full/bst`` curve from ``numpy_params``
    against JAX's, the in-memory driver (:func:`train_in_memory`), the
    streaming driver with the ``bst`` spec, serving through the ``bst``
    spec and retrieval over 10^6 candidates, with the peak memory of each
    part. Returns the launches of each path."""
    sys.path.insert(0, str(ROOT / "tests"))
    import curve_fixture
    from repro_torch.configs import get_arch

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "fp32 matmuls are not full fp32 (TF32 is on)")
    cfg = get_arch("bst").config
    by_path, summary = {}, {}

    def peak(part):
        gib = torch.cuda.max_memory_allocated(dev) / 2**30
        summary[f"{part}_peak_mem_gib"] = gib
        print(f"bst {part} peak_mem_gib={gib:.2f}")
        torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"bst: published config (arXiv:1905.06874), {cfg.padded_rows:,} padded rows x "
          f"{cfg.embed_dim} = {cfg.padded_rows * cfg.embed_dim * 4 / 2**30:.2f} GiB table; "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated before the phase")

    entry = curve_fixture.load()["full/bst"]
    _reset_launches()        # the path: counts from 0, read just after
    t0 = time.perf_counter()
    losses = curve_fixture.port_losses("full/bst", entry, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = by_path["bst full curve"] = _read_launches()
    want = [float(x) for x in entry["losses"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    print(f"bst full/bst curve ({int(entry['steps'])} steps of {int(entry['batch'])} rows from "
          f"numpy_params seed {int(entry['seed'])}, {secs:.2f} s with the draw): losses "
          f"{[round(x, 6) for x in losses]} JAX {[round(x, 6) for x in want]}; relative "
          f"deviation per step {[f'{x:.2e}' for x in rel]} (first within {FULL_FIRST_RTOL}, "
          f"all within {FULL_RTOL}); launches {launches} (BST runs no TPU kernel in either "
          f"package; ws_grad once a step)")
    check(len(losses) == len(want) and rel[0] <= FULL_FIRST_RTOL and max(rel) <= FULL_RTOL,
          f"full/bst: losses {losses} vs JAX {want}")
    check(launches == dict(dict.fromkeys(launches, 0), ws_grad=len(want)),
          f"full/bst launches {launches}")
    summary["full_curve_rel"] = rel
    peak("full_curve")

    params, state, opt, by_path["bst loop"], summary["train"] = train_in_memory(
        torch, dev, "bst", cfg, "bst")
    peak("train")
    line, by_path["bst stream"] = bst_streaming(torch, cfg, state, opt, dev)
    print(f"bst {line}")
    peak("stream")
    line, by_path["bst serve"] = bst_serve_against_cpu(torch, cfg, params, dev)
    print(f"bst {line}")
    peak("serve")
    print(f"bst {bst_retrieval(torch, cfg, params, dev)}")
    del state, params, opt
    torch.cuda.empty_cache()
    print(f"bst summary: {json.dumps(summary)}; freed, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB left allocated")
    return by_path


CHECK_PAIRS = (("ads_ctr", "dlrm-mlperf"), ("dlrm", "dlrm-mlperf"), ("bst", "bst"))
CHECK_SLOTS = 20_000                    # a layout past the allocator kernel's 8,192-request tile
CHECK_SHARDS = 4                        # --check --metrics streaming runs: 4 steps of TRAIN_ROWS
CHECK_HASH_OPS = 130                    # a hash program of three launches (64 + 64 + 2 ops)


def dlrm_step_flops(cfg, rows: int) -> int:
    """Matrix-product FLOPs of one DLRM train step, written down before the
    count: every MLP layer's forward, weight-gradient and input-gradient
    GEMM (2 * rows * in * out each), less the input gradient of the first
    bottom layer (the dense input takes none), plus the interaction
    kernels' lower pairs (2 * rows * P * D forward, 4 * rows * P * D
    backward, P = F(F-1)/2 for F = n_sparse + 1 fields)."""
    f, d = cfg.n_sparse + 1, cfg.embed_dim
    p = f * (f - 1) // 2
    dims = [cfg.n_dense, *cfg.bot_mlp]
    layers = list(zip(dims, dims[1:]))
    top = [cfg.bot_mlp[-1] + p, *cfg.top_mlp]
    layers += list(zip(top, top[1:]))
    gemms = sum(3 * 2 * rows * i * o for i, o in layers) - 2 * rows * layers[0][0] * layers[0][1]
    return gemms + 6 * rows * p * d


def _findings(report):
    return sorted((f.rule, f.severity, f.location, f.message) for f in report.findings)


def phase_check(torch, dev, step_ms):
    """17: the static checks and the step's cost on the card. ``step_ms``
    is phase 8's mean step, whole and its adapt-and-step share."""
    import io

    import torch.distributed as dist

    from repro_torch.check import aliasing, effects, planverify, run_check
    from repro_torch.configs import get_arch
    from repro_torch.core.devicefeed import FeedLayout, SlotSpec
    from repro_torch.fe import featureplan, get_spec
    from repro_torch.fe.datagen import write_log_shards
    from repro_torch.launch import train
    from repro_torch.launch.hlo_stats import step_cost
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw

    t_phase = time.perf_counter()
    # run_check on the card: the kernel planner among the aliasing oracles
    _reset_launches()
    for preset, arch in CHECK_PAIRS:
        before = _read_launches()["mempool_alloc"]
        t0 = time.perf_counter()
        card = run_check(preset, arch, device=dev.type)
        card_s = time.perf_counter() - t0
        launched = _read_launches()["mempool_alloc"] - before
        cpu = run_check(preset, arch, device="cpu")
        check(card.exit_code == 0 and not card.crashed,
              f"run_check {preset} x {arch} on the card: exit {card.exit_code}, {card.crashed}\n"
              + card.render())
        check(launched == 2, f"run_check {preset} x {arch}: mempool_alloc launched {launched} "
                             f"times, want 2 (packed and split layouts)")
        check(_findings(card) == _findings(cpu) and card.analyzers_run == cpu.analyzers_run,
              f"run_check {preset} x {arch}: card findings differ from the CPU's")
        print(f"check run_check preset={preset} arch={arch} exit={card.exit_code} "
              f"analyzers={card.analyzers_run} findings={len(card.findings)} "
              f"mempool_alloc_launches={launched} seconds={card_s:.3f} (= device='cpu' findings)")
    launches = _read_launches()

    # three mutants that must fail on the card
    plan = featureplan.compile(get_spec("dlrm"))
    layout = plan.feed_layout(split_sparse_fields=True)
    real_plan_block = aliasing.plan_block

    def moved(sizes, **kw):
        offsets, total = real_plan_block(sizes, **kw)
        offsets = offsets.copy()
        offsets[1] += 128
        return offsets, total

    with mock.patch.object(aliasing, "plan_block", moved):
        mutant = aliasing.check_feed_layout(layout, TRAIN_ROWS, device=dev, location="mutant")
    check("AL204" in {f.rule for f in mutant}, f"kernel plan moved by 128: {mutant}")
    fused = next(ex for ex in plan.layers if ex.fused_fn is not None)

    def syncing(env, inner=fused.fused_fn):
        _ = env[fused.device_input_slots[0]].sum().item()
        return inner(env)

    env, _ = planverify.abstract_flow(plan, TRAIN_ROWS)
    layers = [dataclasses.replace(ex, fused_fn=syncing) if ex is fused else ex
              for ex in plan.layers]
    ef = effects.scan_executables(layers, env)
    check([f.rule for f in ef] == ["EF301"], f"fused layer with .item(): {ef}")
    smoke_mf = plan.model_feed(get_arch("dlrm-mlperf").smoke(), split_sparse_fields=True)
    smoke_raw, _ = R.make_sparse_train_step(smoke_mf.config, adamw(LR))
    with mock.patch("repro_torch.embedding.table.scatter_rows", scatter_rows_0d_index):
        ef3 = effects.check_step(smoke_mf.make_step(smoke_raw).boundary,
                                 effects.abstract_step_args(plan, smoke_mf, rows=TRAIN_ROWS),
                                 expect_donation=True)
    check([f.rule for f in ef3] == ["EF303"] and "_local_scalar_dense" in ef3[0].message,
          f"sparse step with the 0-d index scatter_rows: {ef3}")
    print(f"check mutants: kernel plan offset moved by 128 -> "
          f"{sorted({f.rule for f in mutant})}; .item() in fused layer {fused.index} -> "
          f"{[f.rule for f in ef]} ({ef[0].message[:80]}...); the 0-d index scatter_rows in "
          f"the sparse step -> {[f.rule for f in ef3]} ({ef3[0].message[:60]}...)")

    # a hand-built layout past the kernel's one-block tile
    from repro_torch.kernels.mempool_alloc import ops as alloc_ops
    big = FeedLayout(slots=tuple(SlotSpec(f"s{i:05d}", 1 + i % 7, "float32", rank1=i % 7 == 0)
                                 for i in range(CHECK_SLOTS)))
    before = _read_launches()["mempool_alloc"]
    big_findings = aliasing.check_feed_layout(big, 3, device=dev)
    check(big_findings == [] and _read_launches()["mempool_alloc"] == before + 1,
          f"{CHECK_SLOTS}-slot layout: {big_findings[:3]}")
    print(f"check {CHECK_SLOTS}-slot layout (kernel tile {alloc_ops.tile()}, multi-block form): "
          f"clean against the shadow plan, the host prefix sum and ArenaPool")

    # a hash program past one launch's ops: consecutive launches, bit for bit
    from repro_torch.fe.spec import Hash, SparseOutput
    from repro_torch.kernels.feature_hash import ops as hash_ops
    from repro_torch.kernels.feature_hash.ref import hash_layer_ref

    gen = torch.Generator(device=dev).manual_seed(17)
    cols = torch.randint(-2**31, 2**31 - 1, (3, TRAIN_ROWS), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    kinds = ("cross", "hash", "mod")
    prog = tuple((kinds[i % 3], i % 3, (i + 1) % 3, 7 + 13 * i) for i in range(CHECK_HASH_OPS))
    before = hash_ops.run_hash_layer.launches
    got = hash_ops.run_hash_layer(cols, prog)
    n_launch = hash_ops.run_hash_layer.launches - before
    check(n_launch == -(-CHECK_HASH_OPS // hash_ops.OPS_PER_LAUNCH)
          and torch.equal(got, hash_layer_ref(cols, program=prog)),
          f"{CHECK_HASH_OPS}-op program: {n_launch} launches, equal to the plain version: "
          f"{torch.equal(got, hash_layer_ref(cols, program=prog))}")
    base = get_spec("ads_ctr")
    extra = tuple(Hash(f"f_user_{i}", "user_id") for i in range(CHECK_HASH_OPS - 4))
    wide = featureplan.compile(dataclasses.replace(
        base, transforms=base.transforms + extra,
        outputs=tuple(dataclasses.replace(o, fields=o.fields + tuple(t.name for t in extra))
                      if isinstance(o, SparseOutput) else o for o in base.outputs)))
    wide_findings = planverify.verify_plan(wide, rows=TRAIN_ROWS)
    check(wide_findings == [], f"{CHECK_HASH_OPS}-op layer: {wide_findings[:3]}")
    print(f"check {CHECK_HASH_OPS}-op hash program at N={TRAIN_ROWS}: {n_launch} launches of at "
          f"most {hash_ops.OPS_PER_LAUNCH} ops, equal to hash_layer_ref bit for bit; a "
          f"{CHECK_HASH_OPS}-op layer of ads_ctr through verify_plan on meta: clean")

    # full-width scans at TRAIN_ROWS rows, on meta tensors: nothing allocated
    cfg = capped_config()
    mf = plan.model_feed(cfg, split_sparse_fields=True, rows_hint=TRAIN_ROWS)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    scans = planverify.verify_plan(plan, rows=TRAIN_ROWS)
    scans += planverify.verify_model_feed(mf, plan.feed_layout(split_sparse_fields=True))
    scans += effects.scan_preset(plan, mf, rows=TRAIN_ROWS, device=dev)
    scan_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem1, peak = torch.cuda.memory_allocated(dev), torch.cuda.max_memory_allocated(dev)
    check(scans == [], "full-width scans: " + "; ".join(f.render() for f in scans))
    check(mem1 == mem0, f"full-width scans allocated {mem1 - mem0} bytes")
    check(not dist.is_initialized(), "the mesh scan left its process group")
    print(f"check full-width scans (dlrm x capped dlrm-mlperf, {TRAIN_ROWS} rows, table "
          f"{sum(cfg.vocab_sizes):,} x {cfg.embed_dim}): verify_plan, verify_model_feed, "
          f"scan_preset clean in {scan_s:.3f} s; memory_allocated {mem0} -> {mem1}, "
          f"peak above it {peak - mem0} bytes")

    # the full-width step's cost, held to the formula written above
    raw, _ = R.make_sparse_train_step(mf.config, adamw(LR))
    args = effects.abstract_step_args(plan, mf, rows=TRAIN_ROWS)
    tot = step_cost(mf.make_step(raw).boundary, *args)
    want = dlrm_step_flops(cfg, TRAIN_ROWS)
    check(tot.flops == want, f"step_cost FLOPs {tot.flops} vs the formula's {want}")
    check(torch.cuda.memory_allocated(dev) == mem0, "step_cost allocated")
    step_ms, share_ms = step_ms["step"], step_ms["adapt_and_step"]
    print(f"check step_cost dlrm-mlperf (capped) rows={TRAIN_ROWS}: flops={tot.flops:.0f} "
          f"(formula {want}) op_bytes={tot.op_bytes:.0f}; "
          f"phase 8 step {step_ms:.3f} ms -> {tot.flops / step_ms / 1e9:.3f} TFLOP/s achieved "
          f"({tot.flops / share_ms / 1e9:.3f} TFLOP/s over its adapt_and_step share "
          f"{share_ms:.3f} ms; fp32 peak 67 TFLOP/s)")

    # the streaming driver with --check --metrics, bit for bit the plain run
    data_dir = tempfile.mkdtemp(prefix="fbcheck_")
    try:
        write_log_shards(data_dir, n_shards=CHECK_SHARDS, rows_per_shard=TRAIN_ROWS, seed=0)
        spec = get_arch("dlrm-mlperf")
        runs = {}
        for flags in ((), ("--check", "--metrics")):
            opt = adamw(LR)
            params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
            calibrate_output_layer(torch, params, cfg, plan, plan.model_feed(cfg), dev)
            state = {"params": params, "opt": R.make_sparse_train_step(cfg, opt)[1](params)}
            a = train.parse_args(["--arch", "dlrm-mlperf", "--data-dir", data_dir, "--spec",
                                  "dlrm", "--device-feed", "arena", "--fault-tolerant",
                                  "--steps", str(CHECK_SHARDS), "--device", dev.type, *flags])
            out = io.StringIO()
            _reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                # main() runs the preflight so, but its _run trains only the
                # smoke config; the driver's own dispatch is driven below
                a.check_report = train._preflight(a) if a.check else None
                _, losses = train.run_streaming(a, spec, cfg, state, opt)
            runs[flags] = (losses, _read_launches(), out.getvalue(), time.perf_counter() - t0)
            del state, params
            torch.cuda.empty_cache()
        (plain, plain_n, _, plain_s), (flagged, flagged_n, text, flagged_s) = runs.values()
        check(flagged == plain and all(math.isfinite(x) for x in plain),
              f"--check --metrics losses {flagged} vs plain {plain}")
        check(flagged_n == dict(plain_n, mempool_alloc=plain_n["mempool_alloc"] + 2),
              f"--check --metrics launches {flagged_n} vs plain {plain_n} (+2 planner runs)")
        reg = json.loads(text.partition("metrics:\n")[2])
        tiers = {k.split(".")[0] for k in reg}
        check({"check", "hlo", "pipeline"} <= tiers, f"registry tiers {sorted(tiers)}")
        check(reg["check.exit_code"] == 0 and reg["hlo.flops"] == dlrm_step_flops(cfg, TRAIN_ROWS),
              f"registry check/hlo: {reg['check.exit_code']} {reg['hlo.flops']}")
        hlo_line = next(ln for ln in text.splitlines() if ln.startswith("hlo/step"))
        print(f"check streaming --check --metrics (capped full width, {CHECK_SHARDS} steps of "
              f"{TRAIN_ROWS} rows): losses bit for bit the unflagged run's {plain}; launches "
              f"{flagged_n} (unflagged {plain_n}); wall {flagged_s:.2f} s vs {plain_s:.2f} s; "
              f"{hlo_line}; registry tiers {sorted(tiers)}, {len(reg)} keys; hlo.flops="
              f"{reg['hlo.flops']:.0f} hlo.op_bytes={reg['hlo.op_bytes']:.0f}")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # the driver's own dispatch, main(): the preflight once, before any
    # data, then _run on the smoke config; losses bit for bit as above
    smoke_dir = tempfile.mkdtemp(prefix="fbcheck_main_")
    try:
        write_log_shards(smoke_dir, n_shards=CHECK_SHARDS, rows_per_shard=256, seed=0)
        argv = ["--arch", "dlrm-mlperf", "--data-dir", smoke_dir, "--spec", "dlrm",
                "--device-feed", "arena", "--fault-tolerant", "--steps", str(CHECK_SHARDS),
                "--device", dev.type]
        mains = []
        for flags in ([], ["--check", "--metrics"]):
            out = io.StringIO()
            _reset_launches()
            with contextlib.redirect_stdout(out):
                _, losses = train.main(argv + flags)
            mains.append((losses, _read_launches(), out.getvalue()))
        (plain, plain_n, _), (flagged, flagged_n, text) = mains
        check(flagged == plain and all(math.isfinite(x) for x in plain),
              f"main --check --metrics losses {flagged} vs plain {plain}")
        check(flagged_n == dict(plain_n, mempool_alloc=plain_n["mempool_alloc"] + 2)
              and text.count("check: 4 analyzers") == 1,
              f"main --check --metrics: launches {flagged_n} vs plain {plain_n} (+2 for one "
              f"preflight), {text.count('check: 4 analyzers')} reports")
        reg = json.loads(text.partition("metrics:\n")[2])
        tiers = {k.split(".")[0] for k in reg}
        check({"check", "hlo", "pipeline"} <= tiers and reg["check.exit_code"] == 0
              and reg["hlo.flops"] > 0, f"main --metrics registry tiers {sorted(tiers)}")
        print(f"check train.main --check --metrics (smoke config, {CHECK_SHARDS} steps of 256 "
              f"rows): one preflight (mempool_alloc {flagged_n['mempool_alloc']} vs "
              f"{plain_n['mempool_alloc']} unflagged), losses bit for bit {plain}, registry "
              f"tiers {sorted(tiers)}")
    finally:
        shutil.rmtree(smoke_dir, ignore_errors=True)
    print(f"check phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ phase 18: LM
LM_ARCH = "yi-9b"                       # arXiv:2403.04652, the smallest LM of the repo
LM_PREFILL_SEQ = 32_768                 # the JAX prefill_32k sequence (reduced: batch 32 to 1)
LM_DECODE_BATCH = 8                     # reduced: decode_32k's batch 128 needs 384 GiB of cache
LM_DECODE_SLOTS = 32_768
LM_DECODE_LEN = 32_000                  # the cache's valid length while decode is timed
LM_DECODE_STEPS = 8                     # timed, after one warm-up step
LM_PROMPT = 16                          # greedy decode after a prompt of 16 tokens, two prompts
LM_GREEDY = 4
LM_FIRST_BATCH = 8                      # the first step at 1 layer: 8 sequences of 64
LM_TRAIN_LAYERS = 16                    # reduced: AdamW + grad_accum state at 48 layers is 141 GB
LM_TRAIN_BATCH = 64                     # --batch default of the driver: 64 sequences of 64
LM_TRAIN_STEPS = 4                      # the driver's run, after one warm-up step
LM_TRAIN_4K = (8, 4096)                 # the train_4k shape (reduced: batch 256 to 8)
BF16_DENSE_PEAK = 989e12                # H100 SXM dense bf16 (data sheet), at 700 W
LM_FLASH_SHAPES = ((1, 2048, 32, 4, 128, True),     # yi's heads (GQA group 8), 4 blocks
                   (2, 1000, 8, 8, 64, False),      # group 1, S not a multiple of the block
                   (1, 1500, 32, 4, 128, True))     # group 8, padded last block
# Bounds from tests/rehearse_lm.py on the CPU at full width, written in
# PERF.md before the chip run that used them. Decode against prefill (max
# |diff| over max |logit|, bf16, 48 layers): the geometric mean of the
# largest correct reading (6.082e-2) and the smallest of three planted
# decode faults (8.826e-1), 3.81x from each. The rest 4x the largest
# reading: the first step's loss and each tensor's gradient norm, bf16
# against fp32 at 1 layer (relative); flash attention in fp32 against
# float64 (max |diff| over max |reference|), its GEMMs summed over K one
# product after another as a GPU k-loop sums them.
LM_DECODE_TOL = 0.232
LM_FIRST_LOSS_RTOL = 4.37e-4
LM_FIRST_NORM_RTOL = 9.49e-4
FLASH64_TOL = 1.55e-5
CARD = ""                               # the card's name and power limit (nvidia-smi), set by main


def lm_rel(torch, a, ref) -> float:
    """max |a - ref| over max |ref|, in float64."""
    return float((a.double() - ref.double()).abs().max() / ref.double().abs().max())


def lm_greedy_decode(torch, params, cfg, prompt, steps):
    """``serve_step`` over ``prompt`` (B, P) from an empty cache, then
    ``steps`` greedy tokens. Returns the tokens and the logits of the last
    prompt position and of each greedy step but the last (each the logits
    ``prefill`` of the prefix gives at its last position)."""
    from repro_torch.models import transformer as T

    b, p = prompt.shape
    cache = T.make_cache(cfg, b, p + steps, device=prompt.device)
    toks, logits = prompt, []
    for t in range(p + steps - 1):
        lg, cache = T.serve_step(params, toks[:, t:t + 1], cache, t, cfg)
        if t >= p - 1:
            logits.append(lg)
            if t + 1 >= toks.shape[1]:
                toks = torch.cat([toks, lg.argmax(-1, keepdim=True).to(toks.dtype)], dim=1)
    return toks, logits


def lm_decode_against_prefill(torch, params, cfg, prompt, steps):
    """The greedy decode's logits against ``prefill`` of each prefix, same
    params and dtype: the largest max |diff| over max |logit| of a step."""
    from repro_torch.models import transformer as T

    toks, dec = lm_greedy_decode(torch, params, cfg, prompt, steps)
    return max(lm_rel(torch, lg, T.prefill(params, toks[:, :prompt.shape[1] + i], cfg))
               for i, lg in enumerate(dec))


def lm_first_step(torch, params, cfg, batch):
    """The first step's loss and each tensor's gradient norm (float64)."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import flatten, unflatten

    leaves = {k: v.detach().requires_grad_(True) for k, v in flatten(params).items()}
    with torch.enable_grad():
        loss = T.lm_loss(unflatten(leaves), batch["tokens"], batch["labels"], cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: float(g.double().norm()) for k, g in zip(leaves, grads)}


def lm_model_flops(cfg, tokens) -> int:
    """A training step's model FLOPs: 6 N T for the N params that multiply
    (all but the embedding) over T tokens, plus causal attention's
    6 L H Dh S T (its two GEMMs, half the scores kept, forward and
    backward), S unpadded. No checkpoint recompute, no padding."""
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    n = T.param_count(cfg) - cfg.vocab * cfg.d_model
    return 6 * n * b * s + 6 * cfg.n_layers * cfg.n_heads * cfg.head_dim * s * b * s


def lm_flops_line(executed, model, ms) -> str:
    peak = BF16_DENSE_PEAK / 1e12
    return (f"executed (step_cost: checkpoint recompute, flash's padding to its 512 blocks, "
            f"flash's fp32 GEMMs) {executed / 1e12:.3f} TFLOP, {executed / ms / 1e9:.2f} "
            f"TFLOP/s ({executed / ms / 1e9 / peak * 100:.2f} % of the dense bf16 peak); "
            f"model (6 N T + causal attention) {model / 1e12:.3f} TFLOP, "
            f"{model / ms / 1e9:.2f} TFLOP/s ({model / ms / 1e9 / peak * 100:.2f} %)")


def lm_cast(params, dtype, device=None):
    from repro_torch.train.optimizer import flatten, unflatten
    return unflatten({k: v.to(device=device, dtype=dtype) for k, v in flatten(params).items()})


def lm_flash_errors(torch, shape, dev, seed=0):
    """Flash attention in fp32 against ``attention_ref`` in float64 on
    ``dev``: max |diff| over max |reference| of the output and of dq, dk, dv."""
    from repro_torch.models.attention import attention_ref, flash_attention

    b, s, h, hk, dh, causal = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(sh, generator=g, device=dev) for sh in
                   ((b, s, h, dh), (b, s, hk, dh), (b, s, hk, dh), (b, s, h, dh)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    out.backward(do)
    got = [out.detach()] + [t.grad for t in leaves]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    ref = attention_ref(*leaves, causal=causal, compute_dtype=torch.float64)
    ref.backward(do.double())
    want = [ref.detach()] + [t.grad for t in leaves]
    return {n: lm_rel(torch, a, w) for n, a, w in zip(("out", "dq", "dk", "dv"), got, want)}


def lm_flash_phase(torch, dev):
    """(d): flash attention against float64 at ``LM_FLASH_SHAPES``; the
    bf16 forward's time beside SDPA's (off the path: a yardstick only)."""
    import torch.nn.functional as F

    from repro_torch.models.attention import flash_attention

    _reset_launches()
    for shape in LM_FLASH_SHAPES:
        errs = lm_flash_errors(torch, shape, dev)
        b, s, h, hk, dh, causal = shape
        q = torch.randn((b, s, h, dh), device=dev, dtype=torch.bfloat16)
        k = torch.randn((b, s, hk, dh), device=dev, dtype=torch.bfloat16)
        v = torch.randn((b, s, hk, dh), device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            ms = device_ms(torch, lambda: flash_attention(q, k, v, causal=causal), 5, 2)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 5, 2)
        print(f"lm flash [{CARD}] (B, S, H, Hk, Dh, causal)={shape}: fp32 against float64 "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (bound {FLASH64_TOL:.1e}); bf16 forward {ms:.4f} ms, "
              f"SDPA (library, off the path) {sdpa:.4f} ms, ratio {ms / sdpa:.2f}x")
        check(max(errs.values()) <= FLASH64_TOL, f"flash {shape} against float64: {errs}")
        del q, k, v
    torch.cuda.empty_cache()
    return _read_launches()


def lm_serving_phase(torch, dev, by_path):
    """(a): yi-9b at 48 layers and full width, bf16, params from a seeded
    generator: greedy decode against prefill, a 32,768-token prefill, and
    decode of a batch of 8 against a 32,768-slot cache."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    cfg = get_arch(LM_ARCH).config
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = T.param_count(cfg)
    print(f"lm serve [{CARD}] {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
          f"{n:,} params, {n * 2 / 2**30:.2f} GiB bf16, drawn in {time.perf_counter() - t0:.2f} s")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, LM_PROMPT)).astype(np.int32)).to(dev)
    _reset_launches()
    dev_rel = lm_decode_against_prefill(torch, params, cfg, prompt, LM_GREEDY)
    print(f"lm serve [{CARD}] decode against prefill: {LM_PROMPT}-token prompts x 2, "
          f"{LM_GREEDY} greedy steps, largest max|diff|/max|logit| {dev_rel:.3e} "
          f"(bound {LM_DECODE_TOL})")
    check(dev_rel <= LM_DECODE_TOL, f"decode against prefill {dev_rel}")

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LM_PREFILL_SEQ)).astype(np.int32)).to(dev)
    T.prefill(params, toks[:, :1024], cfg)              # warm-up at one tile of 1,024
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits = T.prefill(params, toks, cfg)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "prefill logits not finite")
    print(f"lm serve [{CARD}] prefill: 1 x {LM_PREFILL_SEQ} tokens in {pre_s * 1e3:.3f} ms, "
          f"{LM_PREFILL_SEQ / pre_s:.1f} tokens/s, peak {peak:.2f} GiB")
    by_path["lm prefill"] = _read_launches()
    del toks, logits

    _reset_launches()
    cache = T.make_cache(cfg, LM_DECODE_BATCH, LM_DECODE_SLOTS, device=dev)
    cache_len = torch.tensor(LM_DECODE_LEN, device=dev)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (LM_DECODE_BATCH, 1)).astype(np.int32)).to(dev)
    T.serve_step(params, tok, cache, cache_len, cfg)    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(LM_DECODE_STEPS):
        lg, cache = T.serve_step(params, tok, cache, cache_len + 1 + i, cfg)
        tok = lg.argmax(-1, keepdim=True).to(torch.int32)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / LM_DECODE_STEPS
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(bool(torch.isfinite(lg).all()), "decode logits not finite")
    cache_gib = sum(t.numel() * t.element_size() for t in cache.values()) / 2**30
    print(f"lm serve [{CARD}] decode: batch {LM_DECODE_BATCH} against {LM_DECODE_SLOTS:,} slots "
          f"({cache_gib:.2f} GiB cache, {LM_DECODE_LEN:,} valid), {ms:.3f} ms per token step "
          f"({LM_DECODE_BATCH / ms * 1e3:.1f} tokens/s), peak {peak:.2f} GiB")
    by_path["lm decode"] = _read_launches()
    del cache, params
    torch.cuda.empty_cache()


def lm_first_step_against_cpu(torch, dev):
    """(b), first: the first step at 1 layer of full width, card bf16
    against CPU fp32 from the same params and batch."""
    import dataclasses as dc

    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    cfg = dc.replace(get_arch(LM_ARCH).config, n_layers=1, grad_accum=1)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = train.synthetic_batch("lm", cfg, LM_FIRST_BATCH, 0, device=dev)
    loss, norms = lm_first_step(torch, params, cfg, batch)
    t0 = time.perf_counter()
    cpu_loss, cpu_norms = lm_first_step(
        torch, lm_cast(params, torch.float32, "cpu"), dc.replace(cfg, dtype=torch.float32),
        {k: v.cpu() for k, v in batch.items()})
    loss_rel = abs(loss - cpu_loss) / cpu_loss
    worst = max(norms, key=lambda k: abs(norms[k] - cpu_norms[k]) / cpu_norms[k])
    norm_rel = abs(norms[worst] - cpu_norms[worst]) / cpu_norms[worst]
    print(f"lm train [{CARD}] first step at 1 layer of full width, card bf16 against CPU fp32 "
          f"({time.perf_counter() - t0:.1f} s on the CPU): loss {loss:.6f} vs {cpu_loss:.6f}, "
          f"relative {loss_rel:.3e} (bound {LM_FIRST_LOSS_RTOL:.3e}); worst gradient norm "
          f"{worst} relative {norm_rel:.3e} (bound {LM_FIRST_NORM_RTOL:.3e})")
    check(loss_rel <= LM_FIRST_LOSS_RTOL and norm_rel <= LM_FIRST_NORM_RTOL,
          f"first step: loss {loss_rel}, norm {norm_rel} ({worst})")
    del params
    torch.cuda.empty_cache()


def lm_training_phase(torch, dev, by_path):
    """(b): yi-9b at full width and ``LM_TRAIN_LAYERS`` layers (reduced),
    ``make_train_step`` with AdamW and ``grad_accum=8`` through
    ``run_training`` as the driver runs it, then one step of the train_4k
    shape; ms per step, peak GiB, ``step_cost``'s FLOPs and the achieved
    TFLOP/s, executed and model FLOPs, against the dense bf16 peak."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch import hlo_stats, train
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import adamw

    lm_first_step_against_cpu(torch, dev)
    spec = get_arch(LM_ARCH)
    cfg = dc.replace(spec.config, n_layers=LM_TRAIN_LAYERS)
    t0 = time.perf_counter()
    opt = adamw(LR)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    state = {"params": params, "opt": opt.init(params)}
    torch.cuda.synchronize()
    n = T.param_count(cfg)
    state_gib = torch.cuda.memory_allocated(dev) / 2**30
    print(f"lm train [{CARD}] {LM_ARCH} at {LM_TRAIN_LAYERS} of 48 layers, full width: "
          f"{n:,} params, params and AdamW moments {state_gib:.2f} GiB, "
          f"grad_accum {cfg.grad_accum}, {time.perf_counter() - t0:.2f} s")

    def args(steps, batch=LM_TRAIN_BATCH):
        return train.parse_args(["--arch", LM_ARCH, "--steps", str(steps), "--batch",
                                 str(batch), "--device", dev.type])

    _reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    _, warm = train.run_in_memory(args(1), spec, cfg, state, opt)     # warm-up step
    torch.cuda.synchronize()
    marks = []
    real_batch = train.synthetic_batch

    def timed_batch(*a, **kw):
        marks.append(time.perf_counter())      # step k's batch: step k-1 has synced
        return real_batch(*a, **kw)

    with mock.patch.object(train, "synthetic_batch", timed_batch):
        _, losses = train.run_in_memory(args(LM_TRAIN_STEPS), spec, cfg, state, opt)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    losses = warm + losses
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"lm training losses {losses}")
    step = T.make_train_step(cfg, opt)
    batch = train.synthetic_batch("lm", cfg, LM_TRAIN_BATCH, 0, device=dev)
    flops = hlo_stats.step_cost(step, *hlo_stats.abstractify(
        (state["params"], state["opt"], batch))).flops
    med = statistics.median(ms)
    print(f"lm train [{CARD}] driver (run_training + synthetic_batch, {LM_TRAIN_BATCH} x 64 "
          f"tokens, {LM_TRAIN_STEPS} steps after 1 warm-up): ms per step "
          f"{[round(x, 3) for x in ms]}, losses {[round(x, 5) for x in losses]}, peak "
          f"{peak:.2f} GiB; at the median step, "
          + lm_flops_line(flops, lm_model_flops(cfg, batch["tokens"]), med))

    b4, s4 = LM_TRAIN_4K
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b4, s4)).astype(np.int32)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    flops4 = hlo_stats.step_cost(step, *hlo_stats.abstractify(
        (state["params"], state["opt"], batch))).flops
    torch.cuda.reset_peak_memory_stats(dev)
    ms4, loss4 = [], []
    for _ in range(2):                         # a warm-up step at this shape, then the timed one
        t0 = time.perf_counter()
        state["params"], state["opt"], m = step(state["params"], state["opt"], batch)
        loss4.append(float(m["loss"]))         # reads the loss back: the step has ended
        ms4.append((time.perf_counter() - t0) * 1e3)
    peak4 = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(math.isfinite(x) for x in loss4), f"train_4k losses {loss4}")
    print(f"lm train [{CARD}] train_4k-shaped step ({b4} x {s4} tokens, grad_accum "
          f"{cfg.grad_accum}: flash over 8 x 8 blocks each way): {ms4[1]:.3f} ms (the first "
          f"at this shape {ms4[0]:.3f} ms), losses {[round(x, 5) for x in loss4]}, peak "
          f"{peak4:.2f} GiB; " + lm_flops_line(flops4, lm_model_flops(cfg, toks), ms4[1]))
    by_path["lm train"] = _read_launches()
    del state, params, batch, toks
    torch.cuda.empty_cache()


def phase_lm(torch, dev):
    """Phase 18: the dense LM family on the card (see the module docstring).
    Returns the launches of each LM path (no TPU kernel lies on them)."""
    t_phase = time.perf_counter()
    by_path = {"lm flash": lm_flash_phase(torch, dev)}
    lm_serving_phase(torch, dev, by_path)
    lm_training_phase(torch, dev, by_path)
    for path, n in by_path.items():
        check(not any(n.values()), f"{path} launched a kernel: {n}")
    print(f"lm phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path


# ------------------------------------------------- phase 19: MoE, MLA, PNA
MOE_ARCH = "deepseek-moe-16b"           # arXiv:2401.06066, 28 layers at full width
MLA_ARCH = "deepseek-v2-236b"           # arXiv:2405.04434
MLA_LAYERS = 5                          # reduced: 1 dense + 4 MoE of 60 (all 60 are 439 GiB)
MOE_DECODE_BATCH = {MOE_ARCH: 4,        # reduced: decode_32k's batch 128 (8 need 56 GiB of cache)
                    MLA_ARCH: 8}        # reduced: decode_32k's batch 128
MOE_FIRST_LAYERS = 2                    # the first step's check: 1 dense + 1 MoE layer
MOE_TRAIN_LAYERS = 4                    # reduced: 1 dense + 3 MoE of 28 (AdamW: 16 B a param)
PNA_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")   # ogb_products: phase 21
PNA_STEPS = 8                           # timed, after one warm-up step
PNA_SAMPLED_STEPS = 4                   # minibatch_lg: a new sample each step
REDDIT_NODES = 232_965                  # minibatch_lg's graph: Reddit's node count
REDDIT_IN_DEGREE = 16                   # reduced: Reddit's 114.6M edges are a mean in-degree of 492
# Bounds from tests/rehearse_lm.py (MoE) and tests/rehearse_pna.py on the
# CPU, written in PERF.md before the chip run that used them. Decode
# against prefill at the decode's routes (max |diff| over max |logit|,
# bf16, at this phase's depths, seeds 0 and 1): the geometric mean of the
# largest correct reading (2.239e-2; 1.591e-2) and the smallest planted
# fault's (1.494e-1, an expert's slot + 1; 8.977e-2, the same), 2.58x and
# 2.38x from each. The first step at 1 dense + 1 MoE layer, bf16 against
# fp32 at the bf16 routes: 4x the largest reading (loss 2.092e-5, gradient
# norm 3.884e-4).
MOE_DECODE_TOL = {MOE_ARCH: 5.78e-2, MLA_ARCH: 3.78e-2}
MOE_FIRST_LOSS_RTOL = 8.37e-5
MOE_FIRST_NORM_RTOL = 1.55e-3
# PNA's first step in fp32 against float64, 4x the largest of the three
# shapes' readings (minibatch_lg's loss 1.220e-6 and in_w's norm 7.416e-4).
PNA_FIRST_LOSS_RTOL = 4.88e-6
PNA_FIRST_NORM_RTOL = 2.97e-3


@contextlib.contextmanager
def moe_routes(log):
    """Append each ``moe._route`` call's experts, ``top_e (T, k)``, to ``log``."""
    from repro_torch.models import moe as M

    real = M._route

    def logged(x, router, c):
        out = real(x, router, c)
        log.append(out[0].detach())
        return out

    with mock.patch.object(M, "_route", logged):
        yield log


@contextlib.contextmanager
def forced_routes(routes):
    """``moe._route`` with each MoE layer's experts, ``top_e``, taken from
    ``routes`` (one a layer, in the order the layers' routers are first
    seen, so a checkpoint's recompute gets its layer's again), the combine
    weights and the aux from the call's own fp32 scores at those experts.
    Two paths compared under it compute the same function at the same
    routes: no flip between them (ROADMAP C26) moves the reading."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import moe as M

    by_router = {}

    def forced(x, router, c):
        key = router.data_ptr()
        if key not in by_router:
            by_router[key] = routes[len(by_router)].to(x.device, torch.int64)
        top_e = by_router[key]
        probs = torch.softmax(torch.matmul(x.to(torch.float32), router.to(torch.float32)), -1)
        top_p = probs.gather(1, top_e)
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
        fe = F.one_hot(top_e[:, 0], c.n_experts).to(torch.float32).mean(dim=0)
        return top_e.to(torch.int32), top_p, c.n_experts * torch.sum(fe * probs.mean(dim=0))

    with mock.patch.object(M, "_route", forced):
        yield


def route_flips(torch, a, b) -> int:
    """The ``(token, layer)`` routes of two logs, call by call, whose sets
    of experts differ."""
    return sum(int((torch.sort(x.cpu(), -1).values != torch.sort(y.cpu(), -1).values)
                   .any(-1).sum()) for x, y in zip(a, b, strict=True))


def dropped_pairs(log, c) -> int:
    """The ``(token, k)`` pairs that the capacity of ``c`` drops in the
    calls of a route log."""
    from repro_torch.models import moe as M
    return sum(int((~M._dispatch_indices(te, c, M.capacity(te.shape[0], c))[3]).sum())
               for te in log)


def no_drop(cfg):
    """``cfg`` at the capacity factor ``n_experts / top_k``, where no pair
    can drop: decode (a call of B tokens) and prefill (B x S) compute the
    same function only there (ROADMAP C25)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def moe_decode_against_prefill(torch, params, cfg, prompt, steps):
    """``lm_greedy_decode`` against ``prefill`` of each prefix at the
    decode's routes (:func:`forced_routes`): the largest max |diff| over
    max |logit|; beside it the ``(token, layer)`` routes of the longest
    prefix, run with its own routes, that differ from the decode's, out of
    how many; and the tokens and prefill logits (for the rehearsal's
    faults)."""
    from repro_torch.models import transformer as T

    b, p = prompt.shape
    n_moe = cfg.n_moe_layers
    dec_log = []
    with moe_routes(dec_log):
        toks, dec = lm_greedy_decode(torch, params, cfg, prompt, steps)

    def dec_routes(t):          # positions 0..t of each MoE layer, in prefill's token order
        return [torch.stack([dec_log[u * n_moe + j] for u in range(t + 1)], 1)
                .reshape(b * (t + 1), -1) for j in range(n_moe)]

    out = {"rel": 0.0, "toks": toks, "prefills": []}
    for i, lg in enumerate(dec):
        t = p - 1 + i                   # the serve_step call that gave these logits
        with forced_routes(dec_routes(t)):
            pre = T.prefill(params, toks[:, :t + 1], cfg)
        out["prefills"].append(pre)
        out["rel"] = max(out["rel"], lm_rel(torch, lg, pre))
    free = []
    with moe_routes(free):
        T.prefill(params, toks[:, :t + 1], cfg)
    out["flips"] = route_flips(torch, free, dec_routes(t))
    out["routes"] = b * (t + 1) * n_moe
    return out


def moe_first_routes(torch, params, cfg, tokens):
    """The route log of a forward of ``tokens`` (no grad: one call a layer)."""
    from repro_torch.models import transformer as T

    log = []
    with torch.no_grad(), moe_routes(log):
        T.hidden_states(params, tokens, cfg)
    return log


def moe_first_step_against_cpu(torch, dev):
    """The first step at ``MOE_FIRST_LAYERS`` (1 dense + 1 MoE) of
    deepseek-moe-16b's full width, card bf16 against CPU fp32 from the same
    params and batch, with the routes that flip between the two."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch(MOE_ARCH).config, n_layers=MOE_FIRST_LAYERS, grad_accum=1)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = train.synthetic_batch("lm", cfg, LM_FIRST_BATCH, 0, device=dev)
    loss, norms = lm_first_step(torch, params, cfg, batch)
    routes = moe_first_routes(torch, params, cfg, batch["tokens"])
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = lm_cast(params, torch.float32, "cpu")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    with forced_routes(routes):                 # the card's routes: no flip moves the reading
        cpu_loss, cpu_norms = lm_first_step(torch, p32, cfg32, cpu_batch)
    flips = route_flips(torch, routes, moe_first_routes(torch, p32, cfg32, cpu_batch["tokens"]))
    loss_rel = abs(loss - cpu_loss) / cpu_loss
    worst = max(norms, key=lambda k: abs(norms[k] - cpu_norms[k]) / cpu_norms[k])
    norm_rel = abs(norms[worst] - cpu_norms[worst]) / cpu_norms[worst]
    n_routes = sum(r.shape[0] for r in routes)
    print(f"moe train [{CARD}] first step at 1 dense + 1 MoE layer of full width, card bf16 "
          f"against CPU fp32 at the card's routes ({time.perf_counter() - t0:.1f} s on the "
          f"CPU): loss {loss:.6f} vs "
          f"{cpu_loss:.6f}, relative {loss_rel:.3e} (bound {MOE_FIRST_LOSS_RTOL:.3e}); worst "
          f"gradient norm {worst} relative {norm_rel:.3e} (bound {MOE_FIRST_NORM_RTOL:.3e}); "
          f"{flips} of {n_routes} (token, layer) routes of the CPU's own differ from the card's")
    check(loss_rel <= MOE_FIRST_LOSS_RTOL and norm_rel <= MOE_FIRST_NORM_RTOL,
          f"moe first step: loss {loss_rel}, norm {norm_rel} ({worst})")
    del params
    torch.cuda.empty_cache()


def moe_model_flops(cfg, tokens, train: bool, context: int = 0) -> int:
    """Model FLOPs of a forward (``train``: and backward, 3x) over tokens
    (B, S): 2 N T for the N params that multiply a token (all but the
    embedding; of the routed experts only ``top_k``), plus causal
    attention's two GEMMs over half the scores, L H (D_qk + D_v) S T; no
    checkpoint recompute, no padding, no capacity slots. A decode step
    (``context``, S = 1) attends to ``context`` cached positions in full:
    2 L H (D_qk + D_v) context B."""
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    m = cfg.moe
    routed = 3 * cfg.d_model * m.d_ff_expert
    n = (T.param_count(cfg) - cfg.vocab * cfg.d_model
         - cfg.n_moe_layers * (m.n_experts - m.top_k) * routed)
    if cfg.attn == "mla":
        dqk, dv = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim, cfg.mla.v_head_dim
    else:
        dqk = dv = cfg.head_dim
    attn = 2 * context * b if context else s * b * s
    fwd = 2 * n * b * s + cfg.n_layers * cfg.n_heads * (dqk + dv) * attn
    return 3 * fwd if train else fwd


def moe_serving(torch, dev, by_path, arch):
    """(a), (c): ``arch`` at full width (deepseek-v2-236b at ``MLA_LAYERS``
    layers), bf16, params from a seeded generator: greedy decode against
    prefill at the no-drop capacity factor (with the routes that flip), a
    32,768-token prefill and a decode step of ``MOE_DECODE_BATCH[arch]``
    against 32,768 slots at the published one (with the pairs it drops)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch import hlo_stats
    from repro_torch.models import transformer as T

    cfg = get_arch(arch).config
    if arch == MLA_ARCH:
        cfg = dataclasses.replace(cfg, n_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = T.param_count(cfg)
    m = cfg.moe
    attn = (f"MLA {cfg.n_heads} heads, kv_lora_rank {cfg.mla.kv_lora_rank}" if cfg.attn == "mla"
            else f"{cfg.n_heads} heads over {cfg.n_kv} KV heads")
    print(f"moe serve [{CARD}] {arch}: {cfg.n_layers} layers ({cfg.first_k_dense} dense, "
          f"{cfg.n_moe_layers} MoE), d {cfg.d_model}, {attn}, {m.n_experts} routed experts top "
          f"{m.top_k} + {m.n_shared} shared of d_ff {m.d_ff_expert}, vocab {cfg.vocab}: {n:,} "
          f"params, {n * 2 / 2**30:.2f} GiB bf16, drawn in {time.perf_counter() - t0:.2f} s "
          f"(allocator: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved)")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, LM_PROMPT)).astype(np.int32)).to(dev)
    _reset_launches()
    r = moe_decode_against_prefill(torch, params, no_drop(cfg), prompt, LM_GREEDY)
    tol = MOE_DECODE_TOL[arch]
    print(f"moe serve [{CARD}] {arch} decode against prefill at capacity factor "
          f"{m.n_experts / m.top_k:.3f} (no drops) and the decode's routes: {LM_PROMPT}-token "
          f"prompts x 2, {LM_GREEDY} greedy steps, largest max|diff|/max|logit| "
          f"{r['rel']:.3e} (bound {tol}); {r['flips']} of {r['routes']} (token, layer) routes "
          f"of the longest prefill with its own routes differ from the decode's")
    check(r["rel"] <= tol, f"{arch} decode against prefill {r['rel']}")
    del r

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LM_PREFILL_SEQ)).astype(np.int32)).to(dev)
    T.prefill(params, toks[:, :1024], cfg)              # warm-up at one tile of 1,024
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    log = []
    with moe_routes(log):
        t0 = time.perf_counter()
        logits = T.prefill(params, toks, cfg)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits not finite")
    flops = hlo_stats.step_cost(T.prefill, params, toks, cfg).flops
    model = moe_model_flops(cfg, toks, train=False)
    pairs = LM_PREFILL_SEQ * m.top_k * cfg.n_moe_layers
    print(f"moe serve [{CARD}] {arch} prefill: 1 x {LM_PREFILL_SEQ} tokens in "
          f"{pre_s * 1e3:.3f} ms, {LM_PREFILL_SEQ / pre_s:.1f} tokens/s, peak {peak:.2f} GiB; "
          f"{dropped_pairs(log, m):,} of {pairs:,} (token, k) pairs dropped at capacity factor "
          f"{m.capacity_factor}; " + lm_flops_line(flops, model, pre_s * 1e3))
    by_path[f"moe prefill {arch}"] = _read_launches()
    del toks, logits, log
    torch.cuda.empty_cache()                  # free the prefill's cached blocks for the cache

    _reset_launches()
    bsz = MOE_DECODE_BATCH[arch]
    cache = T.make_cache(cfg, bsz, LM_DECODE_SLOTS, device=dev)
    cache_len = torch.tensor(LM_DECODE_LEN, device=dev)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (bsz, 1)).astype(np.int32)).to(dev)
    T.serve_step(params, tok, cache, cache_len, cfg)    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    log = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with moe_routes(log):
        start.record()
        for i in range(LM_DECODE_STEPS):
            lg, cache = T.serve_step(params, tok, cache, cache_len + 1 + i, cfg)
            tok = lg.argmax(-1, keepdim=True).to(torch.int32)
        end.record()
        end.synchronize()
    ms = start.elapsed_time(end) / LM_DECODE_STEPS
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(bool(torch.isfinite(lg).all()), f"{arch} decode logits not finite")
    cache_gib = sum(t.numel() * t.element_size() for t in cache.values()) / 2**30
    pairs = LM_DECODE_STEPS * bsz * m.top_k * cfg.n_moe_layers
    flops = hlo_stats.step_cost(T.serve_step, params, tok, cache, cache_len, cfg).flops
    model = moe_model_flops(cfg, tok, train=False, context=LM_DECODE_LEN + 1)
    print(f"moe serve [{CARD}] {arch} decode: batch {bsz} against {LM_DECODE_SLOTS:,} slots "
          f"({cache_gib:.2f} GiB cache, {LM_DECODE_LEN:,} valid), {ms:.3f} ms per token step "
          f"({bsz / ms * 1e3:.1f} tokens/s), peak {peak:.2f} GiB; {dropped_pairs(log, m)} of "
          f"{pairs} (token, k) pairs dropped at capacity factor {m.capacity_factor} (capacity "
          f"{max(math.ceil(bsz * m.top_k / m.n_experts * m.capacity_factor), 1)} a call); "
          + lm_flops_line(flops, model, ms))
    by_path[f"moe decode {arch}"] = _read_launches()
    del cache, params, log
    torch.cuda.empty_cache()


def moe_training(torch, dev, by_path):
    """(b): deepseek-moe-16b at full width and ``MOE_TRAIN_LAYERS`` layers
    (1 dense + 3 MoE), AdamW and ``grad_accum`` 8 through the in-memory
    driver (1 + 4 steps of 64 x 64 tokens), then the train_4k shape, as
    phase 18 trains yi-9b; the pairs dropped in the driver's steps."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.launch import hlo_stats, train
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import adamw

    moe_first_step_against_cpu(torch, dev)
    spec = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(spec.config, n_layers=MOE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    opt = adamw(LR)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    state = {"params": params, "opt": opt.init(params)}
    torch.cuda.synchronize()
    n = T.param_count(cfg)
    print(f"moe train [{CARD}] {MOE_ARCH} at {MOE_TRAIN_LAYERS} of 28 layers, full width: "
          f"{n:,} params, params and AdamW moments "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, grad_accum {cfg.grad_accum}, "
          f"{time.perf_counter() - t0:.2f} s")

    def args(steps):
        return train.parse_args(["--arch", MOE_ARCH, "--steps", str(steps), "--batch",
                                 str(LM_TRAIN_BATCH), "--device", dev.type])

    _reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    _, warm = train.run_in_memory(args(1), spec, cfg, state, opt)     # warm-up step
    torch.cuda.synchronize()
    marks, log = [], []
    real_batch = train.synthetic_batch

    def timed_batch(*a, **kw):
        marks.append(time.perf_counter())      # step k's batch: step k-1 has synced
        return real_batch(*a, **kw)

    with mock.patch.object(train, "synthetic_batch", timed_batch):
        with moe_routes(log):
            _, losses = train.run_in_memory(args(LM_TRAIN_STEPS), spec, cfg, state, opt)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    losses = warm + losses
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"moe training losses {losses}")
    step = T.make_train_step(cfg, opt)
    batch = train.synthetic_batch("lm", cfg, LM_TRAIN_BATCH, 0, device=dev)
    flops = hlo_stats.step_cost(step, *hlo_stats.abstractify(
        (state["params"], state["opt"], batch))).flops
    # the routes of the forwards and of the checkpoints' recomputes alike
    pairs = sum(r.shape[0] for r in log) * cfg.moe.top_k
    print(f"moe train [{CARD}] driver (run_training + synthetic_batch, {LM_TRAIN_BATCH} x 64 "
          f"tokens, {LM_TRAIN_STEPS} steps after 1 warm-up): ms per step "
          f"{[round(x, 3) for x in ms]}, losses {[round(x, 5) for x in losses]}, peak "
          f"{peak:.2f} GiB; {dropped_pairs(log, cfg.moe):,} of {pairs:,} (token, k) pairs "
          f"dropped (forwards and recomputes, {LM_TRAIN_BATCH * 64 // cfg.grad_accum} tokens a "
          f"microbatch); at the median step, "
          + lm_flops_line(flops, moe_model_flops(cfg, batch["tokens"], True),
                          statistics.median(ms)))

    b4, s4 = LM_TRAIN_4K
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b4, s4)).astype(np.int32)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    flops4 = hlo_stats.step_cost(step, *hlo_stats.abstractify(
        (state["params"], state["opt"], batch))).flops
    torch.cuda.reset_peak_memory_stats(dev)
    ms4, loss4 = [], []
    for _ in range(2):                         # a warm-up step at this shape, then the timed one
        t0 = time.perf_counter()
        state["params"], state["opt"], m = step(state["params"], state["opt"], batch)
        loss4.append(float(m["loss"]))         # reads the loss back: the step has ended
        ms4.append((time.perf_counter() - t0) * 1e3)
    peak4 = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(math.isfinite(x) for x in loss4), f"moe train_4k losses {loss4}")
    print(f"moe train [{CARD}] train_4k-shaped step ({b4} x {s4} tokens, grad_accum "
          f"{cfg.grad_accum}): {ms4[1]:.3f} ms (the first at this shape {ms4[0]:.3f} ms), "
          f"losses {[round(x, 5) for x in loss4]}, peak {peak4:.2f} GiB; "
          + lm_flops_line(flops4, moe_model_flops(cfg, toks, True), ms4[1]))
    by_path["moe train"] = _read_launches()
    del state, params, batch, toks, log
    torch.cuda.empty_cache()


def pna_graph_batches(torch, shape, dev, seed=0):
    """The batches of one ``GNN_SHAPES`` shape on ``dev``, as a function of
    the step: a fixed graph for ``full_graph_sm`` (Cora's sizes) and
    ``molecule`` (128 graphs of 30 nodes and 64 edges); for
    ``minibatch_lg`` a new ``NeighborSampler`` subgraph a step over a
    synthetic graph of ``REDDIT_NODES`` nodes, its loss masked to the 1,024
    seed rows. Returns ``batch(step) -> (batch, host ms)``."""
    import numpy as np

    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.models import gnn as G

    info = GNN_SHAPES[shape]
    d, classes = info["d_feat"], info["n_classes"]

    def put(g):
        return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
                for k, v in g.items()}

    if info["kind"] == "full":
        fixed = put(G.random_graph(info["n_nodes"], info["n_edges"], d, classes, seed=seed))
        return lambda step: (fixed, 0.0)
    if info["kind"] == "graphs":
        rng = np.random.default_rng(seed)
        ng, npg, epg = info["n_graphs"], info["nodes_per"], info["edges_per"]
        off = np.repeat(np.arange(ng) * npg, epg)
        fixed = put({"features": rng.normal(size=(ng * npg, d)).astype(np.float32),
                     "src": (rng.integers(0, npg, ng * epg) + off).astype(np.int32),
                     "dst": (rng.integers(0, npg, ng * epg) + off).astype(np.int32),
                     "graph_ids": np.repeat(np.arange(ng), npg).astype(np.int32),
                     "labels": rng.integers(0, classes, ng).astype(np.int32),
                     "n_graphs": ng})
        return lambda step: (fixed, 0.0)
    graph = G.random_graph(REDDIT_NODES, REDDIT_NODES * REDDIT_IN_DEGREE, d, classes, seed=seed)
    sampler = G.NeighborSampler.from_edges(REDDIT_NODES, graph["src"].astype(np.int64),
                                           graph["dst"].astype(np.int64), seed=seed)
    rng = np.random.default_rng(seed + 1)

    def sampled(step):
        t0 = time.perf_counter()
        seeds = rng.choice(REDDIT_NODES, info["seeds"], replace=False)
        nodes, src, dst, seed_rows = sampler.sample(seeds, info["fanout"])
        mask = np.zeros(len(nodes), np.float32)
        mask[seed_rows] = 1.0
        g = {"features": graph["features"][nodes], "src": src, "dst": dst,
             "labels": graph["labels"][nodes], "label_mask": mask}
        return put(g), (time.perf_counter() - t0) * 1e3

    return sampled


def pna_first_step(torch, params, cfg, batch):
    """The first step's loss and each param's gradient norm (float64)."""
    from repro_torch.models import gnn as G

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = G.loss_fn(leaves, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: float(g.double().norm()) for k, g in zip(leaves, grads)}


def pna_first_step_against_fp64(torch, params, cfg, batch):
    """The first step in fp32 against float64 from the same params and
    batch, on their device: the relative loss error and the worst
    gradient norm's, with its param."""
    loss, norms = pna_first_step(torch, params, cfg, batch)
    b64 = dict(batch, features=batch["features"].double())
    loss64, norms64 = pna_first_step(torch, {k: v.double() for k, v in params.items()},
                                     dataclasses.replace(cfg, dtype=torch.float64), b64)
    worst = max(norms64, key=lambda k: abs(norms[k] - norms64[k]) / max(norms64[k], 1e-30))
    return (abs(loss - loss64) / loss64,
            abs(norms[worst] - norms64[worst]) / max(norms64[worst], 1e-30), worst)


def pna_model_flops(cfg, batch) -> float:
    """The JAX package's PNA model FLOPs (``configs/base.gnn_cell``): the
    message and update MLPs, 3x the forward."""
    e, n = batch["src"].shape[0], batch["features"].shape[0]
    per_edge = 2.0 * 2 * cfg.d_hidden * cfg.d_hidden
    per_node = 2.0 * (cfg.d_hidden * 13) * cfg.d_hidden
    return 3.0 * cfg.n_layers * (per_edge * e + per_node * n)


def pna_phase(torch, dev, by_path):
    """(d): PNA at its published width (4 layers, d_hidden 75) on three
    ``GNN_SHAPES``: the first step in fp32 against float64 on the card,
    then 1 + ``PNA_STEPS`` AdamW steps of ``make_train_step`` (a new
    sample each step for ``minibatch_lg``: the sampler's host ms beside the
    step's ms)."""
    from repro_torch.configs.base import gnn_config_for
    from repro_torch.launch import hlo_stats
    from repro_torch.models import gnn as G
    from repro_torch.train.optimizer import adamw

    for shape in PNA_SHAPES:
        cfg = gnn_config_for("pna", shape)
        batches = pna_graph_batches(torch, shape, dev)
        # drawn on the host, so the CPU rehearsal (tests/rehearse_pna.py) starts from these bits
        params = {k: v.to(dev)
                  for k, v in G.init_params(cfg, torch.Generator().manual_seed(0)).items()}
        _reset_launches()
        batch, host0 = batches(0)
        loss_rel, norm_rel, worst = pna_first_step_against_fp64(torch, params, cfg, batch)
        opt = adamw(LR)
        state = opt.init(params)
        step = G.make_train_step(cfg, opt)
        flops = hlo_stats.step_cost(step, *hlo_stats.abstractify((params, state, batch))).flops
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        steps = PNA_SAMPLED_STEPS if shape == "minibatch_lg" else PNA_STEPS
        losses, ms, host, sizes = [], [], [host0], []
        for i in range(steps + 1):
            if i:
                batch, h = batches(i)
                host.append(h)
            sizes.append((batch["features"].shape[0], batch["src"].shape[0]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))        # reads the loss back: the step has ended
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check(all(math.isfinite(x) for x in losses), f"pna {shape} losses {losses}")
        if shape != "minibatch_lg":                # a fixed batch: the loss falls
            check(losses[-1] < losses[0], f"pna {shape} losses {losses}")
        med = statistics.median(ms[1:])
        model = pna_model_flops(cfg, batch)
        sampled = (f"; sampler (host) ms {[round(x, 3) for x in host]}, subgraphs (nodes, "
                   f"edges) {sizes}" if shape == "minibatch_lg" else
                   f"; (nodes, edges) {sizes[0]}")
        print(f"pna [{CARD}] {shape} (d_in {cfg.d_in}, {cfg.n_classes} classes"
              f"{', graph-level' if cfg.graph_level else ''}): first step fp32 against float64 "
              f"loss {loss_rel:.3e} (bound {PNA_FIRST_LOSS_RTOL:.3e}), worst gradient norm "
              f"{worst} {norm_rel:.3e} (bound {PNA_FIRST_NORM_RTOL:.3e}); {steps} steps after 1 "
              f"warm-up: ms {[round(x, 3) for x in ms[1:]]} (warm-up {ms[0]:.3f}), losses "
              f"{[round(x, 4) for x in losses]}, peak {peak:.3f} GiB{sampled}; at the median "
              f"step, executed (step_cost) {flops / 1e9:.3f} GFLOP, "
              f"{flops / med / 1e9:.4f} TFLOP/s; model (JAX's gnn_cell formula) "
              f"{model / 1e9:.3f} GFLOP, {model / med / 1e9:.4f} TFLOP/s")
        check(loss_rel <= PNA_FIRST_LOSS_RTOL and norm_rel <= PNA_FIRST_NORM_RTOL,
              f"pna {shape} first step: loss {loss_rel}, norm {norm_rel} ({worst})")
        by_path[f"pna {shape}"] = _read_launches()
        del params, state, batch, batches
        torch.cuda.empty_cache()


def phase_moe(torch, dev):
    """Phase 19: the MoE LMs and PNA on the card (see the module
    docstring). Returns the launches of each path (no TPU kernel lies on
    them)."""
    t_phase = time.perf_counter()
    by_path = {}
    moe_serving(torch, dev, by_path, MOE_ARCH)
    moe_training(torch, dev, by_path)
    moe_serving(torch, dev, by_path, MLA_ARCH)
    pna_phase(torch, dev, by_path)
    for path, n in by_path.items():
        check(not any(n.values()), f"{path} launched a kernel: {n}")
    print(f"moe phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path


DRYRUN_CELLS = (("pna", "full_graph_sm"), ("pna", "molecule"), ("pna", "minibatch_lg"),
                ("dcn-v2", "serve_p99"), ("dcn-v2", "train_batch"),
                ("autoint", "serve_p99"), ("autoint", "train_batch"),
                ("bst", "serve_p99"), ("bst", "train_batch"), ("bst", "retrieval_cand"))
DRYRUN_OVER = (("dlrm-mlperf", "serve_p99"), ("pna", "ogb_products"))   # over one card
DRYRUN_FIT = 70 * 2**30                 # a 1x1 cell runs on the card if its step peak is at most this
DRYRUN_MIN_BUILT = 50                   # tests/test_configs.py's floor
DRYRUN_WORKERS = 6                      # (e): worker processes (nice 19) for the per-device meta passes
DRYRUN_RANK_CELLS = (("yi-9b", "train_4k"), ("pna", "ogb_products"), ("qwen2.5-32b", "decode_32k"),
                     ("yi-9b", "prefill_32k"), ("deepseek-moe-16b", "train_4k"))
DRYRUN_RANK_RUNS = 3                    # (f): rank 0 of the first 3 16x16 cells whose rank fits
DRYRUN_MULTI_POD_CELL = ("qwen2.5-32b", "train_4k")   # (f): rank 0 of 512, 1 row a microbatch


def dryrun_variants(arch_id, family):
    """``tests/test_configs.py``'s variant list."""
    variants = ["base"]
    if family == "recsys":
        variants += ["nodedup", "cap_expected", "batchall"]
    if family == "gnn":
        variants += ["halo_bf16"]
    if arch_id == "yi-9b":
        variants += ["puredp", "accum4"]
    if arch_id == "deepseek-v2-236b":
        variants += ["accum8", "accum8+cf100"]
    return variants


def start_per_device_passes():
    """Phase 20 (e)'s meta passes: rank 0 of every cell with a per-device
    call (the LM cells, PNA's node-sharded shapes) on both production meshes
    (``dryrun.per_device_record``: the rank's program on meta under a fake
    process group of the mesh's size). Submitted before phase 1 to
    ``DRYRUN_WORKERS`` spawned processes at nice 19, the costliest first,
    so they take the host's idle cores while phases 1-19 drive the card.
    Returns the pool (``terminate()`` stops it) and ``{target: result}``."""
    import multiprocessing

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    targets = []
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch_id in list_archs():
            for shape in get_arch(arch_id).shapes:
                if get_arch(arch_id).build_cell(shape, mesh).per_device is not None:
                    targets.append((arch_id, shape, multi_pod))
    rank = {"train_4k": 0, "prefill_32k": 1}
    targets.sort(key=lambda t: (rank.get(t[1], 2), t[0] != "deepseek-v2-236b"))
    pool = multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS, initializer=os.nice,
                                                      initargs=(19,))
    return pool, {t: pool.apply_async(D.per_device_record, t) for t in targets}


def phase_dryrun(torch, dev, per_device):
    """Phase 20: the dry run (see the module docstring); ``per_device`` is
    :func:`start_per_device_passes`' pool and results. Returns the launches
    of (c)'s runs on the card (no TPU kernel lies on them; (f)'s are checked
    to be none)."""
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.core.sharding import Mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(dev).total_memory
    # (a) every cell of the variant list on both production meshes
    largest, pna_state = {}, {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        name = "2x16x16" if multi_pod else "16x16"
        built, skips = 0, {}
        for arch_id in list_archs():
            spec = get_arch(arch_id)
            for shape in spec.shapes:
                for variant in dryrun_variants(arch_id, spec.family):
                    cell = spec.build_cell(shape, mesh, variant=variant)
                    if cell.skip:
                        skips[(arch_id, shape, variant)] = cell.skip
                        continue
                    built += 1
                    n = D.state_bytes_exact(cell)
                    largest[arch_id] = max(largest.get(arch_id, (0, "")),
                                           (n, f"{shape} {variant} on {name}"))
                    if arch_id == "pna" and variant == "base":
                        pna_state[(name, shape)] = n
        skipped = {shape for _, shape, _ in skips}
        print(f"dryrun {name}: {built} cells built, {len(skips)} skipped ({sorted(skipped)})")
        check(built >= DRYRUN_MIN_BUILT, f"dryrun {name}: {built} cells built")
        check(skipped == {"long_500k"} and all("sub-quadratic" in r for r in skips.values()),
              f"dryrun skips {skips}")
    for arch_id, (n, where) in sorted(largest.items()):
        print(f"dryrun [{CARD}] {arch_id}: largest state per device {n / 2**30:.3f} GiB "
              f"({where}), the card's total_memory {total / 2**30:.2f} GiB")
    # (b) the CLI as a user runs it
    out = ROOT / "build" / "dryrun" / "chip_smoke_pna.json"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "pna",
                           "--both-meshes", "--out", str(out)],
                          env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"dryrun CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    recs = json.loads(out.read_text())
    check(len(recs) == 8 and all(r["status"] == "ok" for r in recs),
          f"dryrun CLI records {[(r['shape'], r['status']) for r in recs]}")
    for r in recs:
        check(r["memory"]["state_bytes_exact"] == pna_state[(r["mesh"], r["shape"])]
              and r["step_flops"] > 0, f"dryrun CLI record {r}")
    print(f"dryrun CLI (--arch pna --both-meshes): exit 0, {len(recs)} records ok in "
          f"{time.perf_counter() - t0:.1f} s")
    # (c) the 1x1 predictions that fit one card, checked on it
    one = Mesh({"data": 1, "model": 1})
    _reset_launches()
    for arch_id, shape in DRYRUN_CELLS:
        cell = get_arch(arch_id).build_cell(shape, one)
        fig = D.step_figures(cell)
        check(fig["step_peak_bytes"] <= DRYRUN_FIT,
              f"dryrun {arch_id} x {shape}: 1x1 peak {fig['step_peak_bytes']} over the fit")
        state = D.state_bytes_exact(cell)
        m = D.measure_on_device(cell, dev)
        predicted = fig["step_peak_bytes"] - m["arg_bytes"]
        excess, bound = m["transient"] - predicted, D.transient_bound(fig)
        print(f"dryrun [{CARD}] {arch_id} x {shape} (1x1): state {state:,} B, materialised "
              f"{m['arg_bytes']:,} B in {m['n_leaves']} leaves, allocated "
              f"{m['arg_allocated']:,} B (slack bound {m['arg_slack']:,}); transient peak "
              f"measured {m['transient']:,} B, predicted {predicted:,} B, excess {excess:,} B "
              f"(bound [0, {bound:,}]: 512 x {fig['step_max_live']} live + 1 MiB x "
              f"{fig['step_max_live_large']} large + workspace {fig['step_workspace']:,}); "
              f"{m['ms']:.3f} ms, step_flops {fig['step_flops']:.4e}, "
              f"{fig['step_flops'] / m['ms'] / 1e9:.4f} TFLOP/s")
        check(m["arg_bytes"] == state, f"dryrun {arch_id} x {shape}: materialised "
              f"{m['arg_bytes']} B, state_bytes_exact {state} B")
        check(0 <= m["arg_allocated"] - m["arg_bytes"] <= m["arg_slack"],
              f"dryrun {arch_id} x {shape}: allocated {m['arg_allocated']} for "
              f"{m['arg_bytes']} B")
        check(0 <= excess <= bound, f"dryrun {arch_id} x {shape}: transient {m['transient']} "
              f"against predicted {predicted} (bound {bound})")
    launches = _read_launches()
    # measure_call runs each cell twice; a recsys train cell's sparse step
    # launches ws_grad once a call, and nothing else launches a kernel
    trains = sum(get_arch(a).family == "recsys" and sh == "train_batch" for a, sh in DRYRUN_CELLS)
    want = dict.fromkeys(launches, 0)
    want["ws_grad"] = 2 * trains
    check(launches == want, f"dryrun 1x1 cells on the card: launches {launches}, want {want}")
    # (d) the cells over one card, from the dry run alone
    for arch_id, shape in DRYRUN_OVER:
        cell = get_arch(arch_id).build_cell(shape, one)
        fig = D.step_figures(cell)
        print(f"dryrun [{CARD}] {arch_id} x {shape} (1x1): state "
              f"{D.state_bytes_exact(cell) / 2**30:.3f} GiB, step peak "
              f"{fig['step_peak_bytes'] / 2**30:.3f} GiB: over the card's "
              f"{total / 2**30:.2f} GiB, not run")
        check(fig["step_peak_bytes"] > total, f"dryrun {arch_id} x {shape} fits one card")
    # (e) the per-device passes, started before phase 1 (one device's figures)
    pool, pending = per_device
    t0 = time.perf_counter()
    recs = {t: r.get() for t, r in pending.items()}
    pool.close()
    pool.join()
    waited = time.perf_counter() - t0
    for (arch_id, shape, multi_pod), r in recs.items():
        where = f"dryrun per device [{CARD}] {arch_id} x {shape} ({r['mesh']}, rank 0 of " \
                f"{512 if multi_pod else 256}, fake group on meta)"
        if r["per_device"] is None:
            print(f"{where}: none in {r['seconds']:.1f} s ({r['per_device_reason']})")
            check("does not split" in r["per_device_reason"]
                  or "not evenly divisible" in r["per_device_reason"],
                  f"dryrun per device {arch_id} x {shape}: {r['per_device_reason']}")
            continue
        coll = {k: f"{v:.4e}" for k, v in r["collective_bytes_per_device"].items()}
        print(f"{where}: {r['seconds']:.1f} s; flops {r['step_flops_per_device']:.4e}, op_bytes "
              f"{r['step_op_bytes_per_device']:.4e}, peak "
              f"{r['step_peak_bytes_per_device'] / 2**30:.3f} GiB, args "
              f"{r['per_device_arg_bytes'] / 2**30:.3f} GiB (factor "
              f"{r.get('per_device_arg_factor', 1.0):.3f} of state_bytes_exact), collectives "
              f"{r['collective_total_bytes']:.4e} B {coll}")
        check(r["step_flops_per_device"] > 0 and r["collective_total_bytes"] > 0
              and r["step_peak_bytes_per_device"] > r["per_device_arg_bytes"] > 0,
              f"dryrun per device {arch_id} x {shape}: {r}")
    figured = {(a, s, m) for (a, s, m), r in recs.items() if r["per_device"] is not None}
    must = {(a, "train_4k", m) for a in list_archs() if get_arch(a).family == "lm"
            for m in (False, True)}
    must |= {("pna", "ogb_products", False), ("pna", "ogb_products", True)}
    check(must <= figured, f"dryrun per device: no figures for {sorted(must - figured)}")
    print(f"dryrun per device: {len(recs)} cells ({len(figured)} with figures) in "
          f"{DRYRUN_WORKERS} workers at nice 19 beside phases 1-19, "
          f"{sum(r['seconds'] for r in recs.values()):.1f} s of passes; phase 20 waited "
          f"{waited:.1f} s for them")
    # (f) rank 0 of 16x16 cells, and of the 2x16x16 cell, on the card: its
    # shards drawn there, one step under a fake group of the mesh's size on
    # cuda (one rank's compute, no communication)
    _reset_launches()

    def rank_run(arch_id, shape, multi_pod):
        """Rank 0 of the cell on the card against its prediction; False
        where the prediction is over the fit (nothing run)."""
        r = recs[(arch_id, shape, multi_pod)]
        mesh = make_production_mesh(multi_pod=multi_pod)
        name, world = ("2x16x16", 512) if multi_pod else ("16x16", 256)
        if r["step_peak_bytes_per_device"] > DRYRUN_FIT:
            print(f"dryrun rank 0 [{CARD}] {arch_id} x {shape} ({name}): predicted peak "
                  f"{r['step_peak_bytes_per_device'] / 2**30:.2f} GiB, over the fit of "
                  f"{DRYRUN_FIT / 2**30:.0f} GiB: not run")
            return False
        cell = get_arch(arch_id).build_cell(shape, mesh)
        m = D.measure_rank_on_device(cell, mesh.shape, dev)
        predicted = r["step_peak_bytes_per_device"] - r["per_device_arg_bytes"]
        excess, bound = m["transient"] - predicted, D.transient_bound(r, "_per_device")
        below = r["step_functional_per_device"]
        print(f"dryrun rank 0 [{CARD}] {arch_id} x {shape} ({name}, fake group of {world} on "
              f"cuda): args {m['arg_bytes']:,} B drawn in {m['n_leaves']} leaves, allocated "
              f"{m['arg_allocated']:,} B (slack bound {m['arg_slack']:,}); transient peak "
              f"measured {m['transient']:,} B, predicted {predicted:,} B, excess {excess:,} B "
              f"(bound [-{below:,}, {bound:,}]: the largest functional backward output below; "
              f"512 x {r['step_max_live_per_device']} live + 1 MiB x "
              f"{r['step_max_live_large_per_device']} large + workspace "
              f"{r['step_workspace_per_device']:,}); one rank's compute, no communication: "
              f"{m['ms']:.3f} ms, {r['step_flops_per_device'] / m['ms'] / 1e9:.4f} TFLOP/s")
        check(m["arg_bytes"] == r["per_device_arg_bytes"], f"dryrun rank 0 {arch_id} x {shape}: "
              f"drew {m['arg_bytes']} B, predicted {r['per_device_arg_bytes']} B")
        check(0 <= m["arg_allocated"] - m["arg_bytes"] <= m["arg_slack"],
              f"dryrun rank 0 {arch_id} x {shape}: allocated {m['arg_allocated']}")
        check(-below <= excess <= bound, f"dryrun rank 0 {arch_id} x {shape}: transient "
              f"{m['transient']} against predicted {predicted} (bounds -{below}, {bound})")
        return True

    ran = []
    for arch_id, shape in DRYRUN_RANK_CELLS:
        r = recs.get((arch_id, shape, False))
        if len(ran) == DRYRUN_RANK_RUNS or r is None or r["per_device"] is None:
            continue
        if rank_run(arch_id, shape, False):
            ran.append((arch_id, shape))
    check(len(ran) == DRYRUN_RANK_RUNS, f"dryrun rank 0 on the card: ran {ran}")
    rank_run(*DRYRUN_MULTI_POD_CELL, True)
    rank_launches = _read_launches()
    check(not any(rank_launches.values()), f"dryrun rank 0 launched a kernel: {rank_launches}")
    print(f"dryrun phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------- phase 21
MP_SEED = 0
MP_STEP_LAYERS = 2                      # (a): 1 dense + 1 MoE layer of deepseek-moe-16b
MP_STEP_BATCH = (2, 512)                # (a): 2 sequences of 512 (reduced: train_4k's 256 x 4,096)
MP_DECODE_BATCH = 4                     # (a): decode of 4 sequences (the phase 19 batch)
MP_DECODE_SLOTS = 64
MP_DECODE_STEPS = 16
MP_EP_TOKENS = 4096                     # (b): deepseek-v2-236b's MoE layer, 2,048 a data shard
MP_EP_SHAPE = {"data": 2, "model": 4}
MP_TP_SEQ = 2048                        # (b): one yi-9b layer on 1 x 2,048 tokens
MP_TP = 4
MP_DECODE_BODIES = (("yi-9b", 4), ("qwen2.5-32b", 16), ("deepseek-v2-236b", 4))  # (b): arch, tp
MP_DECODE_ROWS = 8                      # (b): a data rank's rows of decode_32k's 128 on 16x16
OGB_SHARDS = 8                          # (c): ogb_products' node-shard bodies
OGB_SAMPLE = 512                        # (c): destination nodes recomputed in float64 a layer
# Bounds from tests/rehearse_model_parallel.py on the CPU (fp32, PNA's 1x1
# check float64; TF32 off on the card), stated in PERF.md before the first
# card run: 4x the larger of the correct reading and a legitimate
# reordering's (the same function in another summation order: flash and the
# CE at half their blocks, the edges shuffled, float64 against fp32), rounded
# up to 1 or 5 x 10^k; every planted fault reads above its bound. Readings
# are max |diff| over max |reference| (gradients: the worst leaf). TP's is
# the geometric mean of that side and its smallest fault instead: the card's
# GEMMs part two fp32 orders further than the CPU's (PERF.md section 6).
MP_STEP_LOSS_RTOL = 5e-6                # correct 0, reorder 9.4e-7; a fault 6.1e-4
MP_STEP_GRAD_TOL = 5e-6
MP_DECODE_TOL = 5e-6                    # correct 0, reorder 9.4e-7; an expert's w2 1e-3 off 2.7e-5
MP_PNA_TOL = 1e-11                      # float64: correct 1.7e-12, reorder 1.3e-15; fault 2.8e-5
MP_PNA_GRAD_TOL = 1e-9                  # float64: correct 2.4e-10, reorder 6.1e-13; fault 5.4e-3
MP_EP_TOL = 5e-6                        # correct 1.9e-7, reorder 6.7e-7; fault 4.0e-4
MP_TP_TOL = 1.98e-5                     # on y - x: correct 8.5e-7, reorder 5.3e-7; fault 4.6e-4
MP_DECODE_BODY_TOL = 5e-6               # on y - x: correct 6.9e-7, reorder 7.4e-7; fault 9.2e-6
MP_DECODE_CACHE_TOL = 5e-6              # the written slot: correct 0, reorder 4.0e-7; fault 9.3e-4
OGB_TOL = 1e-5                          # fp32 bodies against float64: 1.3e-6; a 1e-3 fault 9.0e-4


def grads_rel(torch, got, want):
    """The worst leaf's max |diff| over its max |value|, and the leaf."""
    from repro_torch.train.optimizer import flatten

    g, w = flatten(got), flatten(want)
    rel = {k: lm_rel(torch, g[k], w[k]) for k in w}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def mp_config(torch, cfg, layers):
    """``cfg`` at ``layers`` layers in fp32, one microbatch a step."""
    return dataclasses.replace(cfg, n_layers=layers, dtype=torch.float32, grad_accum=1)


def mp_lm_step(torch, params, cfg, batch, mesh=None, mutate=None):
    """One ``make_train_step`` step through ``model_parallel_ranks.Capture``
    (the update returns the gradients: never Adam-updated params, ROADMAP
    C6) from ``params`` (global; on a mesh cut by ``shard_params`` and
    ``mutate``d): (loss, gradients, global)."""
    from model_parallel_ranks import Capture
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    if mesh is None:
        p = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
        grads, _, m = T.make_train_step(cfg, Capture())(p, {}, batch)
        return float(m["loss"]), grads
    specs = T.param_specs(cfg)
    local = M.shard_params(params, specs, mesh)
    if mutate:
        mutate(local)
    grads, _, m = T.make_train_step(cfg, Capture(), mesh=mesh)(local, {}, batch)
    return float(m["loss"]), M.unshard_params(grads, specs, mesh)


def mp_lm_routes(torch, params, cfg, tokens, mesh=None):
    """The route log of one forward (no grad), global or on ``mesh``."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    log = []
    with torch.no_grad(), moe_routes(log):
        if mesh is None:
            T.hidden_states(params, tokens, cfg)
        else:
            T.hidden_states(M.shard_params(params, T.param_specs(cfg), mesh), tokens, cfg,
                            mesh=mesh)
    return log


def mp_step_against_global(torch, params, cfg, batch, mesh, mutate=None):
    """(a) ``make_train_step(mesh=)`` against ``mesh=None`` from the same
    params and batch, the mesh step at the global one's routes: (loss rel,
    worst gradient rel, its leaf, route flips, routes)."""
    log = []
    with moe_routes(log):
        loss, grads = mp_lm_step(torch, params, cfg, batch)
    routes = log[:cfg.n_moe_layers]                 # the forward's calls, one a layer
    with forced_routes(routes):
        m_loss, m_grads = mp_lm_step(torch, params, cfg, batch, mesh, mutate)
    flips = route_flips(torch, routes, mp_lm_routes(torch, params, cfg, batch["tokens"], mesh))
    rel, worst = grads_rel(torch, m_grads, grads)
    return (abs(m_loss - loss) / abs(loss), rel, worst, flips,
            sum(int(r.shape[0]) for r in routes))


def mp_decode_against_plain(torch, params, cfg, tokens, slots, mesh, mutate=None):
    """(a) ``serve_step(mesh=)`` against the plain decode at the no-drop
    factor (ROADMAP C25), each step at the plain step's routes (C26):
    (the largest logits rel, route flips, routes)."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    ncfg = no_drop(cfg)
    local = M.shard_params(params, T.param_specs(ncfg), mesh)
    if mutate:
        mutate(local)
    dev = tokens.device
    cache = T.make_cache(ncfg, tokens.shape[0], slots, device=dev)
    mcache = T.make_cache(ncfg, tokens.shape[0], slots, device=dev, mesh=mesh)
    rel, flips, n = 0.0, 0, 0
    for t in range(tokens.shape[1]):
        log = []
        with moe_routes(log):
            want, cache = T.serve_step(params, tokens[:, t:t + 1], cache, t, ncfg)
        free = []
        with moe_routes(free):                  # the mesh's own routes, on a copy of its cache
            T.serve_step(local, tokens[:, t:t + 1], {k: v.clone() for k, v in mcache.items()},
                         t, ncfg, mesh=mesh)
        flips += route_flips(torch, log, free)
        n += sum(int(r.shape[0]) for r in log)
        with forced_routes(log):
            got, mcache = T.serve_step(local, tokens[:, t:t + 1], mcache, t, ncfg, mesh=mesh)
        rel = max(rel, lm_rel(torch, got, want))
    return rel, flips, n


def mp_pna_against_forward(torch, params, cfg, batch, mesh, mutate=None):
    """(a) ``forward_sharded`` and the node-sharded train step (one rank)
    against ``forward`` and the plain step: (logits rel, worst gradient
    rel, its param)."""
    from model_parallel_ranks import Capture
    from repro_torch.models import gnn as G

    n = batch["features"].shape[0]
    src, dst, _ = G.partition_edges(batch["src"].cpu().numpy(), batch["dst"].cpu().numpy(), n, 1)
    sharded = dict(batch, src=torch.from_numpy(src).to(batch["src"].device),
                   dst=torch.from_numpy(dst).to(batch["dst"].device))
    p = {k: v.clone() for k, v in params.items()}
    if mutate:
        mutate(p)
    axes = ("data", "model")
    with torch.no_grad():
        want = G.forward(params, cfg, batch)
        got = G.forward_sharded(p, cfg, sharded, mesh=mesh, node_axes=axes)
    g_want, _, _ = G.make_train_step(cfg, Capture())(dict(params), {}, batch)
    g_got, _, _ = G.make_train_step(cfg, Capture(), mesh=mesh, node_axes=axes)(
        dict(p), {}, sharded)
    rel, worst = grads_rel(torch, g_got, g_want)
    return lm_rel(torch, got, want), rel, worst


def mp_pna_inputs(torch, dev):
    """(a)'s PNA: the published width on ``full_graph_sm``, in float64 (in
    fp32 two correct summation orders part by more than a fault would
    move it, ROADMAP C28)."""
    from repro_torch.configs.base import gnn_config_for
    from repro_torch.models import gnn as G

    cfg = dataclasses.replace(gnn_config_for("pna", "full_graph_sm"), dtype=torch.float64)
    batch, _ = pna_graph_batches(torch, "full_graph_sm", dev)(0)
    batch = dict(batch, features=batch["features"].double())
    params = {k: v.to(dev) for k, v in
              G.init_params(cfg, torch.Generator().manual_seed(MP_SEED)).items()}
    return cfg, params, batch


def mp_ep_params(torch, c, d_model, dev, seed=MP_SEED):
    """A MoE layer's params (global, fp32) drawn on ``dev`` as
    ``transformer.init_params`` draws them: normal(0, 1) x 0.02."""
    from repro_torch.models import moe as MO

    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(s, generator=gen, device=dev).mul_(0.02)
            for k, s in MO.moe_params_shape(d_model, c).items()}


def mp_ep_in_turn(torch, params, x, c, shape, mutate=None):
    """(b) the EP bodies of a ``shape`` mesh in turn against ``moe_ffn`` on
    each data shard: (the worst shard's rel, the bodies' ms, the local ms)."""
    import model_parallel_ranks as MR
    from repro_torch.models import moe as MO

    with torch.no_grad():
        t0 = time.perf_counter()
        outs, _ = MR.moe_in_turn(params, x, c, shape, mutate=mutate)
        _sync(torch, x)
        t_bodies = (time.perf_counter() - t0) * 1e3
        rows = x.shape[0] // shape["data"]
        t0 = time.perf_counter()
        wants = [MO.moe_ffn(params, x[d * rows:(d + 1) * rows], c)[0]
                 for d in range(shape["data"])]
        _sync(torch, x)
        t_local = (time.perf_counter() - t0) * 1e3
    return max(lm_rel(torch, o, w) for o, w in zip(outs, wants)), t_bodies, t_local


def mp_tp_in_turn(torch, layer, x, cfg, n_tp, mutate=None):
    """(b) one dense layer as ``n_tp`` column/row bodies in turn against
    the layer, read on the layer's update ``y - x`` (the residual would
    hide a fault of the bodies): (rel, the bodies' ms, the layer's ms)."""
    import model_parallel_ranks as MR
    from repro_torch.models import transformer as T

    with torch.no_grad():
        t0 = time.perf_counter()
        got = MR.tp_layer_in_turn(layer, x, cfg, n_tp, mutate=mutate)
        _sync(torch, x)
        t_bodies = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want, _ = T._dense_block(layer, x, cfg)
        _sync(torch, x)
        t_layer = (time.perf_counter() - t0) * 1e3
    return lm_rel(torch, got - x, want - x), t_bodies, t_layer


def mp_decode_layer(torch, arch, dev, seed=MP_SEED):
    """(b) ``arch``'s config at one layer in fp32 and that layer's params
    at full width (its first: a dense FFN, MLA's too), drawn on ``dev`` as
    ``init_params`` draws them: normal(0, 1) x 0.02, the norms 1."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch(arch).config, n_layers=1, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layer = {k: (torch.ones(s[1:], device=dev) if "norm" in k else
                 torch.randn(s[1:], generator=gen, device=dev).mul_(0.02))
             for k, s in sorted(T.param_shapes(cfg)["dense_layers"].items())}
    return cfg, layer


def mp_decode_in_turn(torch, layer, x, cache, cfg, n_tp, cache_len=LM_DECODE_LEN, mutate=None):
    """(b) one dense layer's decode of ``x`` (B, 1, d) as ``n_tp`` attention
    bodies in turn (``model_parallel_ranks.tp_decode_in_turn``), each
    against its ``cache_specs`` block of ``cache`` (one layer), against the
    global decode of the layer on ``cache`` (which it writes), read on the
    layer's update ``y - x``; and the slot the bodies wrote in their blocks
    against the global cache's slot cut by ``cache_specs``: (rel, cache
    rel, the bodies' ms, the layer's ms)."""
    import model_parallel_ranks as MR
    from repro_torch.models import transformer as T

    blocks = MR.cache_blocks(cache, cfg, n_tp)
    with torch.no_grad():
        _sync(torch, x)
        t0 = time.perf_counter()
        got = MR.tp_decode_in_turn(layer, x, blocks, cache_len, cfg, n_tp, mutate=mutate)
        _sync(torch, x)
        t_bodies = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = T._decode_layer(layer, x, cache, 0, cache_len, cfg)
        _sync(torch, x)
        t_layer = (time.perf_counter() - t0) * 1e3
    slot = {k: v[:, :, cache_len:cache_len + 1] for k, v in cache.items()}
    cache_rel = max(lm_rel(torch, b[k][:, :, cache_len:cache_len + 1], w[k])
                    for b, w in zip(blocks, MR.cache_blocks(slot, cfg, n_tp)) for k in w)
    return lm_rel(torch, got - x, want - x), cache_rel, t_bodies, t_layer


def mp_decode_inputs(torch, cfg, rows, slots, dev, seed=MP_SEED):
    """(b) a decode step's ``x`` (rows, 1, d) and a one-layer global cache
    of ``slots`` slots, normal(0, 1) in fp32, drawn on ``dev``."""
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    x = torch.randn((rows, 1, cfg.d_model), generator=gen, device=dev)
    cache = {k: torch.randn(v.shape, generator=gen, device=dev)
             for k, v in sorted(T.make_cache(cfg, rows, slots, abstract=True).items())}
    return x, cache


def _sync(torch, x):
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def ogb_graph(n_real, n_edges, n_shards, seed=MP_SEED):
    """A synthetic graph of ``n_real`` nodes (padded to a multiple of
    ``n_shards``) and ``n_edges`` uniform edges among the real nodes, its
    edges partitioned by destination on the host: (src_p, dst_p, per,
    n_nodes, src, dst, host ms)."""
    import numpy as np

    from repro_torch.models import gnn as G

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_real, n_edges, dtype=np.int64)
    dst = rng.integers(0, n_real, n_edges, dtype=np.int64)
    n = -(-n_real // n_shards) * n_shards
    t0 = time.perf_counter()
    src_p, dst_p, per = G.partition_edges(src, dst, n, n_shards)
    return src_p, dst_p, per, n, src, dst, (time.perf_counter() - t0) * 1e3


def pna_layer_f64(params, i, h, src, dst, nodes, c):
    """PNA layer ``i`` for the rows ``nodes`` in float64 on the host from
    the previous layer's ``h`` (numpy rows on demand: ``h(idx)``) and the
    edges ``src -> dst`` into them (numpy)."""
    import numpy as np

    w = {k: params[f"l{i}_{k}"].double().cpu().numpy() for k in ("msg_w", "msg_b", "upd_w",
                                                                  "upd_b")}
    pos = {int(v): j for j, v in enumerate(nodes)}
    d_idx = np.array([pos[int(v)] for v in dst], np.int64)
    h_nodes, h_src = h(nodes), h(src)
    m = np.maximum(np.concatenate([h_nodes[d_idx], h_src], 1) @ w["msg_w"] + w["msg_b"], 0.0)
    k, dh = len(nodes), m.shape[1]
    deg = np.bincount(d_idx, minlength=k).astype(np.float64)
    s = np.zeros((k, dh))
    np.add.at(s, d_idx, m)
    sq = np.zeros((k, dh))
    np.add.at(sq, d_idx, m * m)
    mx = np.full((k, dh), -np.inf)
    np.maximum.at(mx, d_idx, m)
    mn = np.full((k, dh), np.inf)
    np.minimum.at(mn, d_idx, m)
    has = (deg > 0)[:, None]
    ds = np.maximum(deg, 1.0)[:, None]
    mean = s / ds
    std = np.sqrt(np.maximum(sq / ds - mean * mean, 0.0) + 1e-5)
    agg = np.concatenate([mean, np.where(has, mx, 0.0), np.where(has, mn, 0.0), std], 1)
    logd = np.log1p(deg)[:, None]
    scaled = np.concatenate([agg, agg * logd / c.delta, agg * c.delta / np.maximum(logd, 1e-5)],
                            1)
    return np.maximum(np.concatenate([h_nodes, scaled], 1) @ w["upd_w"] + w["upd_b"], 0.0)


def ogb_forward(torch, dev, cfg, graph, n_sample=OGB_SAMPLE, mutate=None, seed=MP_SEED):
    """(c) PNA's forward over ``graph`` (:func:`ogb_graph`) as its node-shard
    bodies in turn (per layer every shard's body over the previous layer's
    whole ``h``: the halo all-gather's output), and per layer ``n_sample``
    destination nodes recomputed in float64 on the host. Returns (logits,
    per-layer rel, per-layer ms)."""
    import numpy as np

    from repro_torch.models import gnn as G

    src_p, dst_p, per, n, src, dst, _ = graph
    shards = len(src_p) // per
    rows = n // shards
    params = {k: v.to(dev) for k, v in
              G.init_params(cfg, torch.Generator().manual_seed(seed)).items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((n, cfg.d_in), generator=gen, device=dev)
    rng = np.random.default_rng(seed + 1)
    real = int(src.max()) + 1
    sample = np.sort(rng.choice(real, n_sample, replace=False))
    sel = np.isin(dst, sample)
    s_src, s_dst = src[sel], dst[sel]
    sp = [(torch.from_numpy(src_p[k * per:(k + 1) * per]).to(dev),
           G.local_dst(torch.from_numpy(dst_p[k * per:(k + 1) * per]).to(dev), k, rows))
          for k in range(shards)]
    rels, ms = [], []
    with torch.no_grad():
        h = torch.relu(feats @ params["in_w"] + params["in_b"])
        for i in range(cfg.n_layers):
            lp = G.layer_params(params, i)
            if mutate:
                lp = mutate(i, lp)
            _sync(torch, h)
            t0 = time.perf_counter()
            h_next = torch.cat([G._pna_layer_local(lp, h, h[k * rows:(k + 1) * rows], s_k, d_k,
                                                   cfg, rows) for k, (s_k, d_k) in enumerate(sp)])
            _sync(torch, h)
            ms.append((time.perf_counter() - t0) * 1e3)

            def rows_of(idx, h=h):
                return h[torch.from_numpy(np.asarray(idx)).to(dev)].double().cpu().numpy()

            want = pna_layer_f64(params, i, rows_of, s_src, s_dst, sample, cfg)
            got = h_next[torch.from_numpy(sample).to(dev)].double().cpu().numpy()
            rels.append(float(np.abs(got - want).max() / np.abs(want).max()))
            h = h_next
        logits = h @ params["out_w"] + params["out_b"]
    return logits, rels, ms


def mp_mesh_part(torch, dev):
    """(a) the mesh forms on a 1x1 NCCL group at full width."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import gnn_config_for
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    from repro_torch.models import gnn as G
    from repro_torch.models import transformer as T

    mesh = M.make_model_mesh(1, 1, device=dev)
    check(dist.get_backend() == "nccl", f"the 1x1 model mesh runs on {dist.get_backend()}")
    cfg = mp_config(torch, get_arch(MOE_ARCH).config, MP_STEP_LAYERS)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(MP_SEED))
    b, s = MP_STEP_BATCH
    gen = torch.Generator(device=dev).manual_seed(MP_SEED + 2)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": tokens}
    t0 = time.perf_counter()
    loss_rel, grad_rel, worst, flips, n_routes = mp_step_against_global(torch, params, cfg,
                                                                        batch, mesh)
    print(f"model parallel [{CARD}] (a) deepseek-moe-16b at 1 dense + 1 MoE layer of full "
          f"width, fp32, {b} x {batch['tokens'].shape[1]} tokens: make_train_step(mesh=1x1 NCCL) "
          f"against mesh=None at its routes: loss {loss_rel:.3e} (bound {MP_STEP_LOSS_RTOL:.2e}), "
          f"worst gradient {worst} {grad_rel:.3e} (bound {MP_STEP_GRAD_TOL:.2e}); {flips} of "
          f"{n_routes} routes of the mesh's own differ ({time.perf_counter() - t0:.1f} s)")
    check(loss_rel <= MP_STEP_LOSS_RTOL and grad_rel <= MP_STEP_GRAD_TOL,
          f"mesh step: loss {loss_rel}, gradient {grad_rel} ({worst})")
    toks = batch["tokens"][:MP_DECODE_BATCH, :MP_DECODE_STEPS]
    dec_rel, dec_flips, dec_n = mp_decode_against_plain(torch, params, cfg, toks,
                                                        MP_DECODE_SLOTS, mesh)
    print(f"model parallel [{CARD}] (a) serve_step(mesh=1x1) against the plain decode, "
          f"{MP_DECODE_BATCH} sequences x {MP_DECODE_STEPS} steps at the no-drop factor and the "
          f"plain step's routes: logits {dec_rel:.3e} (bound {MP_DECODE_TOL:.2e}); {dec_flips} "
          f"of {dec_n} routes differ")
    check(dec_rel <= MP_DECODE_TOL, f"mesh decode {dec_rel}")
    del params
    torch.cuda.empty_cache()
    pcfg, pparams, pbatch = mp_pna_inputs(torch, dev)
    p_rel, pg_rel, p_worst = mp_pna_against_forward(torch, pparams, pcfg, pbatch, mesh)
    print(f"model parallel [{CARD}] (a) PNA full_graph_sm (published width, float64) "
          f"forward_sharded on the 1x1 mesh against forward: logits {p_rel:.3e} (bound {MP_PNA_TOL:.2e}), the "
          f"node-sharded step's worst gradient {p_worst} {pg_rel:.3e} (bound "
          f"{MP_PNA_GRAD_TOL:.2e})")
    check(p_rel <= MP_PNA_TOL and pg_rel <= MP_PNA_GRAD_TOL, f"pna sharded {p_rel} {pg_rel}")
    dist.destroy_process_group()


def mp_bodies_part(torch, dev):
    """(b) the rank bodies in turn at full width."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    v2 = get_arch(MLA_ARCH).config
    params = mp_ep_params(torch, v2.moe, v2.d_model, dev)
    gen = torch.Generator(device=dev).manual_seed(MP_SEED + 1)
    x = torch.randn((MP_EP_TOKENS, v2.d_model), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rel, t_bodies, t_local = mp_ep_in_turn(torch, params, x, v2.moe, MP_EP_SHAPE)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"model parallel [{CARD}] (b) deepseek-v2-236b's MoE layer (160 experts top 6, d "
          f"5120, f 1536, shard_ff_over_data), fp32, {MP_EP_TOKENS} tokens as the "
          f"{MP_EP_SHAPE['data']}x{MP_EP_SHAPE['model']} mesh's 8 bodies in turn (the f-gather "
          f"a concatenation, the psum a sum in rank order) against moe_ffn on each data shard: "
          f"{rel:.3e} (bound {MP_EP_TOL:.2e}); bodies {t_bodies:.3f} ms, local {t_local:.3f} "
          f"ms, peak {peak:.3f} GiB")
    check(rel <= MP_EP_TOL, f"EP bodies {rel}")
    del params, x
    torch.cuda.empty_cache()
    yi = dataclasses.replace(get_arch(LM_ARCH).config, n_layers=1, dtype=torch.float32)
    full = T.init_params(yi, torch.Generator(device=dev).manual_seed(MP_SEED))
    layer = {k: v[0] for k, v in full["dense_layers"].items()}
    del full
    x = torch.randn((1, MP_TP_SEQ, yi.d_model), generator=gen, device=dev)
    rel, t_bodies, t_layer = mp_tp_in_turn(torch, layer, x, yi, MP_TP)
    print(f"model parallel [{CARD}] (b) one yi-9b layer (32 heads over 4 KV, d 4096, d_ff "
          f"11,008), fp32, 1 x {MP_TP_SEQ} tokens as tp={MP_TP} column/row bodies in turn "
          f"against the layer: {rel:.3e} (bound {MP_TP_TOL:.2e}); bodies {t_bodies:.3f} ms, "
          f"layer {t_layer:.3f} ms")
    check(rel <= MP_TP_TOL, f"TP bodies {rel}")
    del layer, x
    torch.cuda.empty_cache()


def mp_decode_part(torch, dev):
    """(b) the split decode's attention bodies in turn at full width."""
    for arch, n_tp in MP_DECODE_BODIES:
        cfg, layer = mp_decode_layer(torch, arch, dev)
        x, cache = mp_decode_inputs(torch, cfg, MP_DECODE_ROWS, LM_DECODE_SLOTS, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rel, cache_rel, t_bodies, t_layer = mp_decode_in_turn(torch, layer, x, cache, cfg, n_tp)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        kind = (f"MLA, latent {cfg.mla.kv_lora_rank} over {n_tp}" if cfg.attn == "mla" else
                f"{cfg.n_heads} heads over {cfg.n_kv} KV, head_dim {cfg.head_dim} over {n_tp}")
        print(f"model parallel [{CARD}] (b) split decode: one {arch} layer ({kind}), fp32, "
              f"{MP_DECODE_ROWS} rows at cache_len {LM_DECODE_LEN:,} of {LM_DECODE_SLOTS:,} slots, "
              f"as tp={n_tp} attention bodies in turn against their cache_specs blocks, against "
              f"the global decode of the layer: {rel:.3e} (bound {MP_DECODE_BODY_TOL:.2e}); the "
              f"written slot against the global cache's {cache_rel:.3e} (bound "
              f"{MP_DECODE_CACHE_TOL:.2e}); bodies {t_bodies:.3f} ms, layer {t_layer:.3f} ms, "
              f"peak {peak:.3f} GiB")
        check(rel <= MP_DECODE_BODY_TOL and cache_rel <= MP_DECODE_CACHE_TOL,
              f"decode bodies {arch}: {rel}, cache {cache_rel}")
        del layer, x, cache
        torch.cuda.empty_cache()


def mp_ogb_part(torch, dev):
    """(c) ``ogb_products`` forward at its published size."""
    import numpy as np

    from repro_torch.configs.base import GNN_SHAPES, gnn_config_for

    info = GNN_SHAPES["ogb_products"]
    cfg = gnn_config_for("pna", "ogb_products")
    t0 = time.perf_counter()
    graph = ogb_graph(info["n_nodes"], info["n_edges"], OGB_SHARDS)
    t_graph = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    logits, rels, ms = ogb_forward(torch, dev, cfg, graph)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    reserved = torch.cuda.max_memory_reserved(dev) / 2**30
    n = graph[3]
    ok = bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (n, cfg.n_classes)
    print(f"model parallel [{CARD}] (c) PNA ogb_products (published: {info['n_nodes']:,} nodes "
          f"padded to {n:,}, {info['n_edges']:,} edges, d_in {cfg.d_in}, 4 layers of 75, "
          f"{cfg.n_classes} classes), fp32, forward as {OGB_SHARDS} node-shard bodies in turn "
          f"({graph[2]:,} edges a shard; the graph and partition_edges on the host "
          f"{t_graph:.1f} s, of it partition_edges {graph[6]:.0f} ms): ms a layer "
          f"{[round(x, 3) for x in ms]} ({sum(ms):.3f} ms in all), {OGB_SAMPLE} destination "
          f"nodes a layer against float64 on the host {[f'{r:.3e}' for r in rels]} (bound "
          f"{OGB_TOL:.2e}); logits finite and ({n:,}, {cfg.n_classes}): {ok}; peak allocated "
          f"{peak:.3f} GiB, reserved {reserved:.3f} GiB")
    check(ok and max(rels) <= OGB_TOL, f"ogb_products forward: {rels} {ok}")
    del logits, graph
    torch.cuda.empty_cache()


def phase_model_parallel(torch, dev):
    """Phase 21: the model-parallel forms (see the module docstring).
    Returns the launches of its paths (no TPU kernel lies on them)."""
    t_phase = time.perf_counter()
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))     # model_parallel_ranks: the in-turn bodies
    by_path = {}
    for name, part in (("mesh 1x1", mp_mesh_part), ("rank bodies", mp_bodies_part),
                       ("decode bodies", mp_decode_part), ("ogb_products", mp_ogb_part)):
        _reset_launches()
        part(torch, dev)
        by_path[f"model parallel {name}"] = _read_launches()
    for path, n in by_path.items():
        check(not any(n.values()), f"{path} launched a kernel: {n}")
    print(f"model parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path


# phase 22: each run is (example, its arguments, the kernels it must launch)
EXAMPLE_RUNS = (
    ("stream_train", ("--spec", "ads_ctr", "--device-feed", "on"), ("feature_hash", "mempool_alloc")),
    ("stream_train", ("--spec", "dlrm", "--device-feed", "on"), ("feature_hash", "mempool_alloc")),
    ("stream_train", ("--spec", "bst", "--device-feed", "on"), ("feature_hash", "mempool_alloc")),
    ("stream_train", ("--spec", "ads_ctr", "--device-feed", "off"), ("feature_hash",)),
    ("quickstart", (), ("feature_hash",)),
    ("serve_ctr", ("--requests", "1024"), ("feature_hash", "embedding_bag")),
    ("train_ctr_e2e", ("--steps", "100"), ("feature_hash",)),     # reduced: 300 steps
    ("mesh_train", ("--mesh", "1x1"), ("feature_hash", "interaction_dot",
                                       "interaction_dot_backward", "ws_grad")),
)
EXAMPLE_OUT_LINES = 6                   # the last lines of each example's output, printed


def _example_launches():
    from repro_torch.kernels.embedding_bag.ops import bag_lookup

    return dict(_read_launches(), embedding_bag=bag_lookup.launches)


def _reset_example_launches():
    from repro_torch.kernels.embedding_bag.ops import bag_lookup

    _reset_launches()
    bag_lookup.launches = 0


def serve_ctr_pooling(torch, out, record):
    """``serve_ctr``'s last request batch, its warmed table: the kernel's
    pooling against the plain version within ``sum_order_bound`` (two fp32
    orders of the sum over L; ROADMAP C14), and both
    timed at that shape beside the bound and ``F.embedding_bag``."""
    from repro_torch.examples import serve_ctr as S
    from repro_torch.kernels.embedding_bag.ops import bag_lookup
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref, sum_order_bound

    table = out["params"]["embed"].detach()
    ids = torch.remainder(out["batch"]["batch_seq_ids"], S.TABLE).to(torch.int32).contiguous()
    mask = out["batch"]["batch_seq_mask"].contiguous()
    got = bag_lookup(ids, mask, table)
    want = embedding_bag_ref(ids, mask, table)
    err = (got - want).abs()
    over = int((err > sum_order_bound(ids, mask, table)).sum())
    b, l = ids.shape
    u, d = table.shape
    check(over == 0, f"serve_ctr pooling B={b} L={l}: {over} elements past the two-orders bound")
    nnz = int((mask != 0).sum())
    rows = int(torch.unique(ids[mask != 0]).numel())
    ms, c_ms = timings(torch, lambda: bag_lookup(ids, mask, table))
    plain_ms = device_ms(torch, lambda: embedding_bag_ref(ids, mask, table))
    ids64 = ids.to(torch.int64)
    library_ms = device_ms(torch, lambda: torch.nn.functional.embedding_bag(
        ids64, table, mode="sum", per_sample_weights=mask))
    b_ms, b_by = bound(8 * b * l + 4 * d * rows + 4 * b * d, 2 * d * nnz, FP32_FLOPS)
    print(f"serve_ctr pooling B={b} L={l} U={u} D={d} nnz={nnz} rows={rows} "
          f"max_abs_err={float(err.max()):.3e} (kernel in slot order l = 0..{l - 1}, "
          f"bound 2 L 2^-24 sum|w t|) ms={ms:.7f} call_ms={c_ms:.7f} plain_ms={plain_ms:.7f} "
          f"library_ms={library_ms:.7f} bound_ms={b_ms:.7f} ({b_by}) "
          f"share_of_bound={b_ms / ms:.3f} [{CARD}]")
    record["max_abs_err"] = max(record["max_abs_err"], float(err.max()))
    record.update({"serve_ctr_shape": f"B={b} L={l} U={u} D={d} nnz={nnz} rows={rows}",
                   "serve_ctr_ms": ms, "serve_ctr_call_ms": c_ms,
                   "serve_ctr_plain_ms": plain_ms, "serve_ctr_library_ms": library_ms,
                   "serve_ctr_bound_ms": b_ms})


def phase_examples(torch, dev, bag_record):
    """Phase 22: the port's five examples on the card, through their
    ``main``; each run's counts set to 0 just before it and read just
    after."""
    import importlib

    import numpy as np

    t_phase = time.perf_counter()
    by_path = {}
    for name, argv, want in EXAMPLE_RUNS:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmp:
            flag = {"stream_train": "--data-dir", "train_ctr_e2e": "--workdir",
                    "mesh_train": "--data-dir"}.get(name)
            args = (list(argv) + ([flag, os.path.join(tmp, "d")] if flag else [])
                    + ["--device", dev.type])
            buf = io.StringIO()
            _reset_example_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = mod.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = _example_launches()
        tag = f"example {name} {' '.join(argv)}".rstrip()
        by_path[tag] = n
        lines = buf.getvalue().splitlines()
        for ln in lines[-EXAMPLE_OUT_LINES:]:
            print(f"  {name}: {ln}")
        check(lines[-1] == f"{name} OK", f"{tag}: no OK line, last line {lines[-1:]}")
        check(all(n[k] >= 1 for k in want), f"{tag}: a kernel of its path not launched: {n}")
        print(f"{tag}: wall {wall:.3f} s, launches {n} [{CARD}]")
        if name == "serve_ctr":
            lat = out["latency_ms"]
            check(bool(((out["scores"] > 0) & (out["scores"] < 1)).all()),
                  "serve_ctr: a pCTR outside (0, 1)")
            check(n["embedding_bag"] == len(lat), f"serve_ctr: {n['embedding_bag']} bag "
                  f"launches for {len(lat)} request batches")
            print(f"serve_ctr latency p50 {float(np.percentile(lat, 50))} ms p99 "
                  f"{float(np.percentile(lat, 99))} ms over {len(lat)} batches of 256 "
                  f"[{CARD}]")
            serve_ctr_pooling(torch, out, bag_record)
        del out
        torch.cuda.empty_cache()
    print(f"examples phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # fp32 matmuls stay in full fp32 (the default); the kernel-vs-plain
    # comparisons and the JAX parity tolerances assume it
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    result = build.build()
    build.library()
    print(f"build: {result.library.relative_to(ROOT)} in {result.seconds:.2f} s")
    for ln in result.ptxas_log.splitlines():
        if "Function properties" in ln or "spill" in ln or "registers" in ln:
            print(f"ptxas: {ln.strip()}")
    clean = "0 bytes spill stores, 0 bytes spill loads"
    for kernel, want in (("dot_interaction_kernel", clean), ("dot_interaction_bwd_kernel", clean),
                         ("hash_layer_kernel", "0 bytes stack frame, " + clean),
                         ("alloc_offsets_kernel", "0 bytes stack frame, " + clean)):
        spills = [ln for ln in build.ptxas_lines(result.ptxas_log, kernel) if "spill" in ln]
        check(bool(spills) and all(want in ln for ln in spills),
              f"{kernel} has a stack frame, spills or has no ptxas report: {spills}")

    per_device = start_per_device_passes()      # phase 20's meta passes, beside phases 1-19
    try:
        return _phases(torch, dev, per_device)
    finally:
        per_device[0].terminate()


def _phases(torch, dev, per_device) -> int:
    records = {"feature_hash": phase_feature_hash(torch, dev),
               "interaction_dot": phase_interaction_dot(torch, dev),
               "interaction_dot_backward": phase_interaction_bwd(torch, dev),
               "ws_grad": phase_ws_grad(torch, dev),
               "mempool_alloc": phase_mempool_alloc(torch, dev)}
    records["embedding_bag"], bag_launches = phase_embedding_bag(torch, dev)
    by_path = {"serve": phase_end_to_end(torch, dev)}
    torch.cuda.empty_cache()                    # each full-width phase frees its table
    by_path["train"], step_ms = phase_training(torch, dev)
    torch.cuda.empty_cache()
    by_path["stream"], flag_launches = phase_streaming(torch, dev)
    by_path.update(flag_launches)
    torch.cuda.empty_cache()
    by_path["hierarchy"] = phase_hierarchy(torch, dev)
    torch.cuda.empty_cache()
    by_path.update(phase_jax_curves(torch, dev))
    by_path.update(phase_in_memory(torch, dev))
    by_path.update(phase_bst(torch, dev))
    torch.cuda.empty_cache()
    by_path["stream_traced"] = phase_traced_streaming(torch, dev)
    torch.cuda.empty_cache()
    by_path["mesh"] = phase_mesh(torch, dev)
    torch.cuda.empty_cache()
    by_path["check"] = phase_check(torch, dev, step_ms)
    torch.cuda.empty_cache()
    by_path.update(phase_lm(torch, dev))
    torch.cuda.empty_cache()
    by_path.update(phase_moe(torch, dev))
    torch.cuda.empty_cache()
    by_path["dry run"] = phase_dryrun(torch, dev, per_device)
    torch.cuda.empty_cache()
    by_path.update(phase_model_parallel(torch, dev))
    torch.cuda.empty_cache()
    by_path.update(phase_examples(torch, dev, records["embedding_bag"]))
    by_path["bag_lookup"] = bag_launches
    for name, rec in records.items():
        # the streaming path runs four of the kernels, serve_ctr's scoring
        # embedding_bag; each record is timed at its path's shape (and
        # embedding_bag's also at phase 9's training-batch bag)
        main_path = "example serve_ctr --requests 1024" if name == "embedding_bag" else "stream"
        rec["launches"] = by_path[main_path][name]
        rec["launches_by_path"] = {path: n[name] for path, n in by_path.items() if name in n}
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
