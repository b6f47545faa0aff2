"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, count and power limit;
2. build: compiles every CUDA kernel of the port from source (``nvcc``
   for sm_90a) and reports registers, shared memory and spills, and each
   flash kernel's dynamic shared memory and blocks an SM; every flash
   kernel (the forward, dq and the dk/dv template, split and fused, in
   every type mix, bf16 and 3xTF32, at head dims 32, 64, 128 and 256)
   runs on the tensor cores (the bf16 forward, dq and dk/dv template at 64
   and 128 on wgmma with TMA), the wide route (head dims above 256) is built
   in every type mix, the ragged kernel at every template width (and the
   wide one) in both types, the paged decode kernel in both, and no kernel
   of the port may spill;
3. kernel_vs_plain: the ragged paged attention kernel against its plain
   PyTorch version at the serving shapes of Llama-3-8B (nh 32, kvh 8,
   hd 128, page 64, bf16): a 512-token prefill chunk over a context of
   many pages, decode rows up to 4096 tokens of context (split over the
   KV axis by the decode core: the slice count and each part's bytes are
   printed), padding rows, a partial last page and trash-page table slots;
   times both with CUDA events (the kernel also by CUDA-graph replay,
   ``device_ms``); then a smaller batch at head dims 32 (nh
   8, kvh 8), 80, 96, 100, 256, 264 and 512, which the kernel reads in
   place (at a template width at or above them up to 256, through the
   decode core above), in bf16 and fp32;
4. main_path: the serving ``Engine`` at Llama-3-8B widths (all 32
   layers, random bf16 weights from seed 0) serves 8 requests, one of
   them sampled and two sharing a 1024-token header through the prefix
   cache, and must launch the kernel 32 times per unified step; the
   engine replays captured CUDA graphs (``core/capture.py``): the
   warm-up request captures them, ``compile_count`` (at most
   ``2**prefill_rows``) must not change over the measured run; the
   sampler's device time over the step's logits, argmax against the
   sampled path that the captured step always takes
   (``sample_head_ms``);
   ``step_profile`` then reads where a step's device time goes
   (``torch.profiler`` over two more requests) and must see the kernel
   by name 32 times per replayed step (a window that shows fewer is read
   once more, ``PROFILE_REREADS``: CUPTI loses records now and then);
5. oracle: a 2-layer fp32 model at the same widths, where the captured
   engine's temperature-0 tokens must equal an eager engine's
   (``capture.eager()``) and the port's dense ``generate``;
6. flash_vs_plain: the four flash-attention kernels (forward, fused
   backward, split dq and dk/dv backward) against their plain PyTorch
   versions at the training path's shapes -- Llama-3-8B widths (b 2,
   s 4096, h 32, d 128) with the (fp32, fp32, bf16), all-fp32 and
   all-bf16 q/k/v the LLaMA path and its peers feed, GPT-2 widths (b 4,
   s 1024, h 12, d 64, every type mix), BERT-base's attention (b 16,
   s 512, h 12, d 64, not causal; bf16 and fp32, phase 17's route, its
   bound over every pair and SDPA non-causal beside it) -- and on small
   masked cases, not causal too,
   (segment-id tuples, causal offsets, sq != sk, fully-masked rows,
   s = 1000; head dims 64, 128, 32 and 256, 96 and 200 through the
   wrappers' zero padding to 128 and 256, and 320 and 512 on the wide
   route, 320 padded to 384), and times the wide route at head dim 512;
   times
   each kernel, its plain version and PyTorch's own attention
   (``scaled_dot_product_attention`` on all-bf16 and on all-fp32 inputs,
   only as a yardstick; it takes no mixed types) with CUDA events around
   the calls, host work included, and the kernels and SDPA's forward
   also around replays of a CUDA graph of one call (``device_ms``, the
   device's time alone), SDPA's backward by the kernel times
   ``torch.profiler`` reads (``library_device_ms``);
7. train_main_path: ``graph("define_and_run")`` -> placeholders ->
   ``GPTLMHeadModel`` -> ``AdamOptimizer(lr=3e-4).minimize`` ->
   ``g.run(loss, [loss, train_op], feeds, num_micro_batches=2)`` for six
   steps on one seeded batch, at Llama-3-8B widths (4 layers, seq 4096,
   global batch 4) and GPT-2 small (12 layers, seq 1024, global batch 8),
   random bf16 weights; the loss must fall and each flash kernel launch
   once per layer, micro-batch and step on the backward the byte rule
   picks, every launch a tensor-core kernel on its route (3xTF32 for the
   LLaMA path's fp32 and mixed attention; for GPT-2 the forward and the
   fused backward on wgmma, ``wgmma_launches``; neither path runs the bf16
   split dq, whose row of the kernel table says so); the step is
   captured at the first run and replayed (one plan, one graph), and
   ``train_profile`` then reads two more steps with ``torch.profiler``,
   which must see each flash kernel by name once per layer, micro-batch
   and step;
8. train_oracle: 2-layer fp32 models at both widths train three steps on
   the card (kernels, captured step) and on the CPU (plain versions,
   eager) from the same weights and batches; losses and parameters must
   agree;
9. latent_kernel_vs_plain: the latent (MLA) ragged paged attention kernel
   against its plain version at the serving shapes of Llama-3-8B's widths
   in the MLA layout (nh 32, d_c 512, d_r 64, page 64, bf16 pages; the
   batch of phase 3), then at GPT-2 small's (nh 12, d_c 256, no rope)
   with bf16, int8 and nf4 pages written by ``quantize_rows``; each case
   names its route and must launch once on it (bf16 pages on wgmma in two
   bf16 terms, the others on the TF32 tensor cores in split terms); times
   both (the kernel also by CUDA-graph replay, ``device_ms``, and the
   Llama batch's decode rows and chunk row apart, both ways);
10. paged_decode_vs_plain: the paged decode kernel against its plain
    version at Llama-3-8B's shapes (nh 32, kvh 8, hd 128, page 64), batch
    8 and 64, contexts 1 to 4096 with one empty request and partial last
    pages, bf16 and fp32 (the kernel launches the decode core, split over
    the KV axis); times both; small batches at head dims 80, 96, 100, 256,
    264 and 512 (read in place);
    then ``ops.paged_attention_decode`` itself is driven for 8 decode
    steps of 32 layers at batch 8;
11. mla_main_path: phase 4's traffic on Llama-3-8B's widths in the MLA
    layout (``mla_config(llama3_8b_config(), 512, 64)``, all 32 layers,
    random bf16 weights from seed 0): the latent kernel 32 times per
    unified step, every launch on the wgmma route (``wgmma_launches``),
    the full-head kernel never, replayed as in phase 4; then a
    ``step_profile``, which must see the wgmma kernel by name 32 times a
    step;
12. mla_quant_path: GPT-2 small's widths with ``kv_latent_dim=256`` and
    ``page_quant="int8"``, then ``"nf4"``: every request finishes, two
    fresh engines give equal tokens, 12 launches per unified step, none
    on the wgmma route;
13. mla_oracle: 2-layer fp32 MLA models at both widths (one converted
    from a full-head state by ``mla_state_from``), where the engine's
    temperature-0 tokens must equal the port's dense ``generate``, and
    a captured engine's an eager one's;
14. graft_entry: the LLaMA configuration of ``__graft_entry__.entry()``
    (vocab 1024, hidden 256, 4 layers, 8 heads of head dim 32, seq 128,
    batch 4, fp32) trains three steps on the card and on the CPU from the
    same weights, within phase 8's limits, through the 3xTF32 flash
    forward and fused backward at head dim 32; the same widths in bf16
    serve three requests through ``Engine`` (the ragged kernel at head dim
    32), whose temperature-0 tokens must equal ``generate``;
15. train_entry: ``main`` of ``examples/train_gpt_torch.py`` at its
    defaults (GPT-2 small's widths: vocab 50304, hidden 768, 12 layers, 12
    heads, seq 1024) in bf16, global batch 8, 20 steps on the native
    loader (its core built with ``g++``, the seconds printed) over a token
    file from seed 0 (uniform over 64 ids: the default stream, uniform
    over the whole vocabulary, leaves nothing to learn), saving the weights
    (``save_model``); the loss must fall, every flash launch on wgmma; a run
    resumed with ``--load`` must start at the saved weights' loss on its
    first batch (1e-3) and away from a fresh model's; ms/step, tokens/s
    (``StepProfiler``) and peak memory printed;
16. train_recipe: the same model and widths, one seeded batch, each
    variant against its parent in this run: recompute (``nothing_saveable``
    and ``dots_saveable``, captured) and ``cpu_offload`` (uncaptured) give
    the plain step's loss and gradients (the bf16 row limit), recompute
    launches every flash forward twice and its step peaks lower (each
    variant's step peak and the mean of 3 more steps printed); a
    GradScaler's skip inside a captured replay (an infinity written into
    an embedding element the step reads) leaves parameters, Adam's
    moments and step bitwise unchanged and halves the scale, and the next
    replay updates; SGD with momentum and Adafactor train 6 steps from the
    same weights; the fused cross entropy's chunk products take fp32
    results of bf16 operands (``torch.mm(out_dtype=)``), the op on the
    fused step's hidden states and head holds an fp32 cross entropy of
    the fp32 product (loss and each 64-token group's loss within 2e-6,
    dx and dw within 4e-3) and a planted route that rounds the chunk
    logits to bf16 must fail those limits; the fused step's loss is
    within 1e-3 of the fp32 cross entropy of the plain step's logits, its
    gradients as close to an fp32 model's as the plain step's (1.25x),
    its step peak lower;
    AdamW on a cosine lr, captured, equals an eager run (1e-4) with each
    replay's lr read back from the device; a checkpoint saved after 4 steps
    and loaded into a fresh graph gives steps 5-6 within 1e-4;
17. bert_pretrain: ``graph("define_and_run")`` -> placeholders ->
    ``BertForPreTraining`` at BERT-Base Uncased's published widths (vocab
    30522, hidden 768, 12 layers, 12 heads, intermediate 3072, 512
    positions, 2 segment types; random weights from seed 0, nothing cut)
    -> ``AdamOptimizer(lr=1e-5).minimize`` -> ``g.run(loss, [loss,
    train_op], feeds, num_micro_batches=2)``, seq 512, global batch 32 of
    seed-0 masked-LM and next-sentence data, six captured steps in fp32
    (TF32 off), then six built under ``ht.autocast("bfloat16")``: ms a
    step, tokens/s, peak memory, idle share, top kernels; the loss must
    fall, every flash launch be non-causal, 12 forward and 12 fused
    backward launches a micro-batch, on 3xTF32 in fp32 and on wgmma
    (``flash_fwd_wgmma_kernel<64>``, ``flash_bwd_dkv_wgmma_kernel<64,
    true>`` by name in the profile) in bf16; then a 2-layer fp32 BERT at
    the same widths (seq 128, batch 4) trains three steps on the card and
    on the CPU within phase 8's limits;
18. small_models: ``SimpleCNN`` and ``resnet18`` on CIFAR-10 shapes
    (batch 128), ``RNNLanguageModel`` with LSTM and GRU cells at the
    medium setting of Zaremba et al. 2014 (vocab 10000, hidden 650, 2
    layers, 35 steps, batch 20), ``WDL``, ``DeepFM`` and ``DCN`` in
    Criteo's layout (26 fields over 1,000,000 ids, dim 16, 13 dense,
    batch 2048) train three captured Adam steps each; the loss must fall
    and BatchNorm's running statistics stay at their defaults;
19. graph_layer: GPT-2 small's widths (as phase 15: vocab 50304, hidden
    768, 12 layers, 12 heads, seq 1024, untied head, bf16, Adam lr 3e-4,
    random weights from seed 0) through the graph layer: (a) placeholders
    of a ``SymbolicDim("batch")`` on ``set_shape_buckets([4, 8],
    pad_values={labels: -100})``, 12 captured steps at batch sizes drawn
    from seed 0 over 1-8: ``compile_count`` and the plan count 2, 144
    forward and 144 fused launches, the first padded step's loss within
    1e-3 of the same rows run unpadded at their size (``capture.eager()``,
    the same weights), a replayed step's ms at each bucket; (b) 3
    ``run_level="grad"`` runs then an ``update`` run at batch 8: the
    weights still during the GRAD runs, two captured plans of 12 forward
    and 12 fused launches each, the accumulator zeroed, the update within
    1 % of one Adam step on the fp32 sum of the four runs' gradients
    (phase 8's update rule), a replayed GRAD run's ms; (c) the forward at
    batch 4 in ``graph("eager")``, op by op: 12 forward launches, the
    logits within the bf16 row limit of a define-and-run
    ``COMPUTE_ONLY`` run's, its host ms; (d) ``graph("define_by_run")``:
    ``get_or_compute(logits)`` launches 12 forwards, ``get_or_compute(
    loss)`` on a loss built from those logits none (the cache), its loss
    within 1e-3 of (c)'s define-and-run loss, and after ``invalidate()``
    and a new ``feed`` 12 again.  Every flash launch on wgmma;
20. spec_decode: speculative decoding on the serving engine.  (a) Phase
    4's traffic at Llama-3-8B widths (16 of its 32 layers,
    ``SPEC_LAYERS``, random weights from seed 0, ``max_model_len``
    4096), bf16 then fp32 (TF32 off), on a non-spec engine and on one
    with ``SpecConfig(*draft_state_from(state, cfg, 2), k=4)``, on the
    same weights (the draft uploads none of them
    again): in fp32 every request's tokens equal, at temperature 0 and
    the sampled one; in bf16 a greedy request's tokens part only at a
    near tie, where a dense forward puts both tokens within 0.25 of its
    largest logit (ROADMAP §3 F5).  Each engine warmed up under every
    live mask first, its graphs pinned (2, and 5 in spec mode: 4 unified
    graphs and the draft's propose) and unchanged by the run; kernel 5
    once a layer and step, verify steps' launches read apart; tokens/s
    of both, the acceptance rate, tokens per verify row, the draft's
    propose and prefill ms and its prefills.  (b) The same in phase 11's
    MLA layout, kernel 6 on wgmma (bf16) and mma.sync (fp32).  (d) In
    fp32 at full head, the target as its own draft (all 16 layers, the
    same tensors) on phase 4's requests 0, 3 (sampled), 4 and 6: tokens
    equal to (a)'s non-spec engine's, drafts accepted, verify rows
    accepted whole and cut short (rewinds).  Kernel 5 against its plain
    version on a spec step's 8 verify rows of 5 tokens, timed beside the
    same tokens as decode rows; kernel 6 against its plain version
    (phase 9's limit) at the MLA spec step's 17 rows (8 decode rows, the
    512-token chunk, 8 verify rows of 5 tokens) on wgmma, timed by part.
    (c) chunks of 2 beside verify rows of 5 (k 4) at GPT-2 small's
    widths, 2 layers, fp32, the target as its own draft: tokens equal to
    a non-spec engine's and ``generate``'s, and a step that attends only
    ``chunk`` tokens a row (a planted fault) must give others.  Some
    draft must be accepted over the phase;
21. cluster: the cluster and SLO plane at Llama-3-8B widths (16 of its
    32 layers, ``CLUSTER_LAYERS``, random weights from seed 0), phase 4's
    traffic, pools of 160 pages of 64 (the traffic holds about 9.8k
    tokens), ``max_model_len`` 4096.  (a) ``EngineCluster`` of 2
    replicas, ``policy="prefix"``, fp32 (TF32 off) then bf16, on the monolithic engine's weights (the cluster
    uploads none again: peak memory with 1 and with 2 replicas, which must
    differ by less than a weight copy) and one shared unified step
    (graphs per pool 2 after a warm-up, unchanged by the run): 1
    replica's tokens equal the monolithic engine's in both types (the
    same batches); 2 replicas' fp32 tokens equal, bf16 greedy tokens
    part only at near ties, both tokens within ``SPEC_TIE_LIMIT`` of the
    largest logit of an fp32 forward of the same weights (the bf16
    forward's gaps beside it), the header's two users on one replica
    (the late prompt routed by a 16-page digest match), kernel 5 once a
    layer and replica step, tokens/s of the fleet and the monolithic
    engine, the router's decisions.  (b) Disaggregated, 1 prefill and 1
    decode replica, fp32: every request's pages through the
    ``LocalPageTransport`` and adopted by the decode replica, tokens
    equal; the payload bytes, each transfer's measured ``wall_s`` beside
    the H100 model's ``predicted_s``.  (c) Replica 1 killed after 8 steps
    of the run, fp32: its requests re-placed, the completed set whole,
    tokens equal, ``check_cluster_invariants`` after every step.  (d) One
    bf16 engine over a host KV tier with a pool of 56 pages: the
    header's pages evicted to the host and refetched for the late prompt
    (16 pages, its start at 1024 cached tokens), tokens against a
    160-page engine by (a)'s bf16 rule, in the full-head layout (kernel 5) and
    in phase 11's MLA layout (kernel 6 on wgmma); each record's
    ``wall_s`` beside its ``predicted_s``.  (e) ``Autoscaler`` over 2
    replicas on the JAX suite's mixed-class trace (synthetic clock):
    a scale-down and a scale-up, tokens equal a static fleet's, no class
    inversion;
22. mesh: the multi-GPU mesh on the one card.  The port's ``Launcher``
    starts 2 rank processes of this script once (``--mesh-rank``); each
    joins by ``rpc.distributed_init`` (gloo: NCCL refuses two ranks on
    one device) and builds each configuration in turn on its mesh, from
    the seed-0 weights and one seeded batch, each held against the same
    configuration trained in this process (captured, no mesh).  (a)
    fp32 (TF32 off), GPT-2 widths at 2 layers (vocab 50304, seq 256,
    global batch 4, 2 micro-batches, 3 Adam steps at phase 8's lr): dp 2;
    dp 2 with ZeRO 1, 2 and 3; tp 2; tp 2 with sp; dp 2 with the fp32
    grad-comm transport and flat state; losses within 1e-4 and the
    gathered weights' updates within 1 % (phase 8's limits).  (b) bf16 at
    GPT-2 small's full widths (12 layers, seq 1024, global batch 8, 3
    steps): dp 2 with ZeRO 2, and tp 2 with sp; (c) Llama-3-8B widths at
    2 layers (seq 4096, global batch 2, 4 steps), tp 2 with sp for 2
    steps, then hot-switched to dp 2 under ZeRO-2 for 2 (phase 25 (b)
    reads this run): losses
    falling and at every step within ``MESH_LOSS_LIMITS`` of one
    process's: (b)'s bf16 losses (one loss path in every layout) at most
    one bf16 spacing apart and equal at step 1, (c)'s fp32 losses within
    2 % (phase 8's update rule is (a)'s: bf16 rounding alone parts the
    layouts' bf16 weights by most of an update).  Every
    rank's flash launches a layer, micro-batch and step, on wgmma in (b)
    at 6 local heads under tp, on 3xTF32 in (a) and (c) (the split dq and
    dk/dv at 16 local heads in (c), then 32); ms a step, the backend, whether the
    step was captured (never, over gloo), each rank's ``comm_stats``
    summary.  (d) A mesh of size 1 on NCCL in this process: captured,
    its losses equal the run's without a mesh.  A failing or hanging
    rank fails the phase (every wait has a timeout; the launcher kills
    the group);
23. pipeline: pipelines on the one card.  (a) fp32 (TF32 off), GPT-2
    widths at 4 layers (seq 256, global batch 8 in 4 micro-batches,
    phase 8's steps and lr): ``GPTPipelineModel`` at pp 2 (on a spare
    axis) and pp 2 x tp 2 on 4 rank processes of ``mesh_rank_main``
    (gloo), against the one-process ``GPTPipelineModel(num_stages=1)``
    and the plain ``GPTLMHeadModel`` on the same weights (carried by
    ``models.convert``), both captured: losses within 1e-4 and the
    gathered weights' updates within 1 % (phase 8's limits); every
    rank's flash launches ``M + S - 1`` ticks of its layers forward,
    recomputed and backward a step, on 3xTF32, and ``M + S - 2`` staged
    hops each way (the last tick's carries nothing read and is left
    out), one collect and one input-gradient all-reduce over pp a step.
    (b) ``examples/train_gpt_torch.py --pp 2 --bf16 --global-batch 8
    --micro-batch 2`` at GPT-2 small's widths, 4 steps, its 2 stage ranks
    started by the port's ``Launcher`` (each runs the entry point's
    ``main`` as a rank): losses within
    ``PIPE_ENTRY_LOSS_STEPS`` bf16 spacings of the one-process entry
    point's from the same saved weights and token file, falling; each
    rank's flash launches exactly the tick count above on wgmma, and the
    hops and collects as in (a); ms a step by rank beside the one-process
    step.  (c) ``MPMDGPT`` at GPT-2 small's widths in bf16 (8
    micro-batches of 1 x 1024, 3 Adam steps): ``[[3, 3, 3, 3]]`` under
    1f1b and gpipe (equal at step 1, 1f1b's stash peaks <= 4 against
    gpipe's 8 and fewer bytes), ``[[2, 4, 3, 3]]`` and ``[[12]]``, each
    within ``MPMD_LOSS_REL`` of one stage's losses, its ``p2p_log`` equal
    to the schedule's ``p2p_events`` and its flash launches (recompute
    included) on wgmma; one more step of 1f1b and of ``[[12]]`` under
    ``torch.profiler`` gives the device's idle share.  ``[[12]]`` is
    held against the plain ``GPTLMHeadModel`` on the same weights
    (``gather_state`` under the plain names): in fp32 (TF32 off, phase
    8's steps and lr) losses within 1e-4 and updates within 1 %; in
    bf16 the step-1 loss within ``MPMD_PLAIN_BF16_STEPS`` bf16 spacings
    of the plain bf16 model's.
24. cp: context parallelism on the one card, each layout held against
    the same configuration trained in this process (no mesh, captured)
    from the seed-0 weights and one seeded batch.  (a) fp32 (TF32 off),
    GPT-2 widths at 2 layers (phase 22's (a): seq 256, global batch 4 in
    2 micro-batches, 3 Adam steps at phase 8's lr): the ring over
    ``{"dp": 2, "cp": 2}`` with ZeRO-2 and over ``{"cp": 2, "tp": 2}``
    with sp on 4 rank processes of ``mesh_rank_main``, the ring and
    Ulysses over ``{"cp": 2}`` on (b)'s 2 ranks before its cases (phase
    25 (a)'s cases follow on the 4 ranks' launch); losses
    within 1e-4 and the gathered weights' updates within 1 % (phase 8's
    limits).  (b) Llama-3-8B widths at 2
    layers (vocab 128256, hidden 4096, 32 heads, 8 KV heads, FFN 14336,
    bf16), one sequence of 8192 tokens (the config's ``max_seq_len``),
    4096 a rank over ``{"cp": 2}`` on 2 ranks of ``--cp-rank``, the ring
    and Ulysses, 2 Adam steps at lr 3e-4 (the cp gradient sum in 256 MB
    buckets): losses falling and within ``MESH_LOSS_LIMITS``' 2 % of one
    process at seq 8192.  Every rank's flash launches as the normal
    causal ring gives them (rank i of cp runs i + 1 pairs a layer) or
    one a layer under Ulysses, on 3xTF32, its ring hops (``ring/kv``,
    ``ring/dkv``, staged) or all-to-alls (``ulysses``) counted.  (c) On
    (b)'s ranks after training: ``ring_attention_sharded`` at (1, 4096
    a rank, 32, 128), normal and sym, bf16 and fp32 q/k with bf16 v,
    forward and gradients against the kernels over the whole sequence
    in one process; ``profile_ring_breakdown`` of both patterns (comm,
    attn, corr, grad ms a round).  In this process: kernels 1-4 at the
    ring's launch shapes (a causal and a full pair 4096 x 4096; sym
    head-causal 2048 x 2048, tail-causal 2048 x 4096 at offset 2048, COL
    4096 x 2048, ROW 2048 x 4096; a full pair with (q_ids, kv_ids) whose
    rows of a later document see no key: out 0, lse -inf, dq 0 exactly)
    and over the whole 8192-token sequence (Ulysses' 16 heads a rank,
    and the one-process run's 32) against their plain versions, the rows
    that see one key against the fp64 plain version within
    ``single_key_ulps``, with the forward and the backward timed beside
    their bounds.  Ms a step by rank beside one process's,
    comm bytes by kind and tag, flash launches by wrapper and route,
    peak memory by rank.  The launches of (a) and (b) join the kernel
    table's ``launches`` (``cp_launches``), (c)'s stand apart
    (``cp_check_launches``).
25. switch: hot switching (``DefineAndRunGraph.switch_strategy``,
    ``parallel.switch``), each switched run held against the same
    configuration trained in this process (no mesh, captured) from the
    seed-0 weights.  (a) fp32 (TF32 off), GPT-2 widths at 2 layers (phase
    22's (a), global batch 8 in 2 micro-batches, so that dp 4 takes a
    row of each; 6 Adam steps at phase 8's lr) on 4 rank processes of
    ``mesh_rank_main`` (phase 24's launch of 4 ranks) from ``{"dp": 4}``: flat ZeRO-2 switched after 3
    steps to ``{"dp": 2}`` on ranks [2, 3] (the flat buffers re-packed
    for the new dp; flat state takes no tp), and ZeRO-2 switched after 2
    steps to ``{"dp": 2, "tp": 2}`` with sp and after 4 to ``{"dp": 2}``
    on ranks [2, 3] (a subset; ranks 0-1 then hold nothing and take no
    step): losses within 1e-4 and updates within 1 % (phase 8's limits),
    every rank that holds a step the same loss; each switch's profile
    counts the bytes its ranks sent and received (moved), the model's
    parameters and Adam state (total) and the flat state (repack); each
    layout's flash launches as one a layer, micro-batch and step on
    3xTF32.  (b) Llama-3-8B widths at 2 layers (phase 22's (c), read from
    its run; global batch 2, seq 4096, bf16 weights) on 2 ranks: 2 steps
    under ``{"tp":
    2}`` with sp, a switch to ``{"dp": 2}`` under ZeRO-2 (Adam's moments
    move and chunk), 2 more steps; losses falling and within
    ``MESH_LOSS_LIMITS``' 2 % of one process's 4 steps; the switch's wall,
    moved and staged bytes, each rank's peak memory across it (their sum
    within the card), each layout's ms a step and flash launches (16
    local heads, then 32).  (c) On a size-1 NCCL mesh in this process:
    3 captured steps, a switch onto an identity mesh, 3 more: the old
    capture dropped and the plan captured again (``compile_count`` 1,
    ``captures_total`` 2), the losses equal bitwise the same run taken
    under ``capture.eager()``.  Then ``examples/train_malleus_torch.py``
    at its defaults on 4 gloo ranks of the card: its own gates (losses
    finite, continuous across the switch, falling), the measured
    straggler ratios, the switch history and its ranks' flash launches.
    The launches of (a) and the entry point join the kernel table's
    ``launches`` (``switch_launches``, ``switch_entry_launches``; (b)'s are
    phase 22's ``mesh_launches``).  Alone (``phase_switch()`` without
    phases 22 and 24 before it) the phase starts its own launches.

26. moe: mixture of experts and expert parallelism (``nn.moe``, the JAX
    package's MoE form: GShard top-k gates, un-gated experts, SwiGLU
    mapped to SiLU).  (a) ``make_moe_layer`` (top-2 of 8, d 1024, f 3584,
    1024 tokens, fp32, TF32 off) in both dispatch modes on the card
    against its CPU twin: out within the forward limit, the balance loss
    within 1e-5, every gradient within the backward limit;
    ``blocked_group_gemm`` against its CPU twin there, and at the serving
    chunk's shape (Mixtral's widths, 512 tokens, bf16) against the dense
    all-experts mix by the bf16 row rule, both timed.  (b) Mixtral-8x7B's
    widths (``MIXTRAL``: hidden 4096, 32 heads, 8 KV heads, expert FFN
    14336, 8 experts, top 2, vocab 32000) at 2 layers in bf16, random
    weights from seed 0, one seeded batch of 2 x 4096 in 2 micro-batches:
    3 Adam steps eagerly, then 3 captured from the same weights, within
    phase 8's limits, the loss falling, each flash kernel once a layer,
    micro-batch and step on 3xTF32; ms a step and peak memory.  (c)
    Phase 4's traffic at the same widths on a captured engine
    (``compile_count`` stable after the warm-up), fp32 (TF32 off) and
    bf16: the greedy requests' tokens equal the eager solo ``generate``'s
    in fp32; in bf16 they part from them only where the engine's token
    lies within ``SPEC_TIE_LIMIT`` of an fp32 forward's largest logit
    (``engine_tie_rule``, ``generate``'s gap printed beside it: bf16
    routing flips move its tokens too); kernel 5 once a layer and step,
    tokens/s.  (d) On phase 24's launch of 4
    ranks (its own, alone): GPT-2 small's widths at 2 layers with 8
    experts, top 2, fp32, over ``{"dp": 2, "ep": 2}`` and ``{"ep": 4}``,
    2 Adam steps, within phase 8's limits of one process; Mixtral's
    widths at 1 layer, seq 1024, bf16, one step over ``{"ep": 4}`` within
    2 % of one process; ms a step, the EP all-gathers' bytes by rank
    (tokens repeat over ep: no all-to-all), staged bytes.  The launches
    of (b), (c) and (d) join the kernel table's ``launches``
    (``moe_launches``).

27. runtime_planes: (a) the numeric sentry in a captured step at
    Llama-3-8B's widths (depth 32 -> 2, bf16, a batch of 2 x 4096, Adam
    with ``sentry=True``): 6 seeded cursors clean, then the same 6 with a
    ``grad_nan``, a ``grad_spike`` and (after the warm-up) a
    ``loss_spike`` attempt fed before three of them; each poisoned step
    leaves every variable, moment and the step counter ``torch.equal``
    to its state before, the clean losses equal the clean run's bitwise,
    ``compile_count`` and ``captures_total`` stay 1, and every step copies
    one tensor to the host (``host_reads``) as a run without the sentry
    does; the verdict lanes and ms a step with the sentry on and off.
    (b) On phase 24's launch of 4 ranks (its own, alone): the
    fault-tolerant trainer at GPT-2 small's widths (vocab 50257), depth
    12 -> 2, bf16, flat ZeRO-2 with ``grad_comm="fp32"``, the sentry,
    a generation every 4 steps, 2 kept, 16 steps, under ``FT_PLAN``:
    ``grad_nan`` at 3 (skipped), ``loss_spike`` at 6 (rewound),
    ``shard_corrupt`` at 9 (the restore falls back past it), the death
    of rank 3 at 10 (a stopped heartbeat; recovered on dp 2) and
    ``kill_mid_write`` at 11 (the generation of step 12 dies, 4 and 8
    survive); the counters equal the JAX trainer's on the plan
    (``FT_COUNTERS``, from tests/test_torch_ft.py), every rank returns
    the same run; a fault-free reference follows the trainer's layouts
    on the committed cursors (dp 4 to the death's resume step, a plain
    checkpoint, dp 2 on the survivors from it): the losses equal its
    bitwise before the death and within ``FT_LOSS_LIMIT`` (phase 22's one
    bf16 step: the loss is a bf16 number) after; the final fp32 master
    lies within ``FT_STATE_LIMIT`` of one generation's travel from its
    (the distance the reference covers in its last ``FT_EVERY`` steps),
    the step counters equal, and the trainer's master against the
    reference's one generation back must fail that limit (the control);
    MTTR and rebuild seconds, each generation's seconds and bytes, a
    background save from the final layout's ranks, peak memory a rank.
    (c) ``examples/train_gpt_torch.py --trace-out`` at phase 15's
    configuration for 6 steps: the trace passes
    ``obs.validate_chrome_trace`` and holds a ``train_step`` span a step;
    ms a step traced and untraced; ``OpProfiler`` over one forward and
    backward of GPT-2 small on the card: its top 10 op types and total
    against the eager step's wall.  The flash launches of (a), (b) and
    (c) join the kernel table's ``launches``
    (``runtime_planes_launches``).

Then the kernel table line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero; without a CUDA device it exits non-zero before
printing any result.
"""
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import hetu_tpu_torch as ht
from hetu_tpu_torch.core import capture
from hetu_tpu_torch.csrc.build import build
import hetu_tpu_torch.ops as port_ops
from hetu_tpu_torch.models import (DCN, WDL, BertConfig, BertForPreTraining,
                                   DeepFM, GPTConfig, GPTLMHeadModel,
                                   RNNLanguageModel, SimpleCNN, ctr_loss,
                                   draft_state_from, llama3_8b_config,
                                   llama_config, mla_config, mla_state_from,
                                   resnet18)
from hetu_tpu_torch.models.convert import (load_module_state, load_state,
                                           module_state_numpy, random_state,
                                           state_numpy, state_shapes)
from hetu_tpu_torch.models.generate import (_Params, _rotary_tables,
                                             decode_step, generate)
from hetu_tpu_torch.core.device import sm_count
from hetu_tpu_torch.ops import flash_attention as fa
from hetu_tpu_torch.ops.kv_split import core_splits
from hetu_tpu_torch.ops.paged_attention import (decode_core_info,
                                                paged_attention_cuda,
                                                paged_attention_reference)
from hetu_tpu_torch.ops.quantization import quantize_rows
from hetu_tpu_torch.ops.ragged_paged_attention import (
    latent_ragged_paged_attention_cuda,
    latent_ragged_paged_attention_reference, latent_route,
    latent_wgmma_info, ragged_paged_attention_cuda,
    ragged_paged_attention_reference, sample_rows)
from hetu_tpu_torch.fault import check_cluster_invariants
from hetu_tpu_torch.obs import SpanTracer
from hetu_tpu_torch.parallel.schedule import (
    generate_gpipe_schedule, generate_pipedream_flush_schedule)
from hetu_tpu_torch.serving import Engine, EngineCluster, SpecConfig
from hetu_tpu_torch.serving.slo import SLO_CLASSES, Autoscaler
from hetu_tpu_torch.utils import checkpoint as ht_ckpt
from tools.sdpa_times import sdpa_times

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_TF32_FLOPS = 495e12     # dense TF32 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3 bandwidth, H100 SXM


def product_rate(a, b):
    """The highest rate an H100 has for a product of operands of types
    ``a`` and ``b`` to the reference's accuracy (fp32 accumulation).
    bf16 by bf16 runs on the bf16 tensor cores.  An fp32 operand splits
    into two TF32 parts (3xTF32); a bf16 operand is exact in TF32 and has
    no second part, so fp32 by bf16 takes two TF32 products and fp32 by
    fp32 three: 495/2 and 495/3 TFLOP/s, both faster than fp32 FMA
    outside the tensor cores (67).  Quantized latent pages are priced by
    the terms the latent kernel takes (``LATENT_TERMS``)."""
    if a == b == torch.bfloat16:
        return H100_BF16_FLOPS
    return H100_TF32_FLOPS / (2 if torch.bfloat16 in (a, b) else 3)


# bf16 agreement, element by element within each row of the batch:
# |got - want| <= 2**-7 * |want| + rms(want over the row) / 32.  Both
# sides round their fp32 results to bf16, which differ by at most one
# ulp, at most 2**-7 of the value; the kernel also rounds its
# probabilities to bf16 before the second product, an error of about
# 0.2 % of the row's output RMS (about 1 % at its largest), well inside
# the floor.  The limit scales with each row's outputs, which shrink as
# 1 / sqrt(context): a fixed absolute limit would be as large as the
# outputs of the long rows.
BF16_REL = 2.0 ** -7
BF16_RMS_FLOOR = 1.0 / 32


def emit(obj):
    print(json.dumps(obj), flush=True)


def note(*parts):
    """A progress note on stderr (the results stay on the phase lines)."""
    print(*[p if isinstance(p, str) else json.dumps(p) for p in parts],
          file=sys.stderr, flush=True)


def cuda_time_ms(fn, warmup=2, iters=10):
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


def graph_ms(fn, iters=10):
    """Device time of one call of ``fn``: the call is captured once in a
    CUDA graph (after warm-up calls on a side stream) and the replays are
    timed with CUDA events, which leaves out the host's work between
    launches that ``cuda_time_ms`` counts when it outlasts the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    ms = cuda_time_ms(g.replay, warmup=2, iters=iters)
    del g
    return ms


def smi_line():
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device():
    smi = smi_line()
    print(smi, flush=True)
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **dev})
    return dev


# the flash kernels, all on the tensor cores: (kernel, head dim, q/k and v
# types); the bf16 forward, dq and dk/dv template run on wgmma at head dims
# 64 and 128 and on mma.sync at 32 and 256, and the wgmma kernels and the
# bf16 dk/dv template have no type arguments, the 3xTF32 dk/dv template
# only v's (q/k are fp32); split and fused instantiations of the dk/dv
# templates share a key, so phase 2 also counts 48
FLASH_HEAD_DIMS = (32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128)
FLASH_KERNELS = {
    *((kernel, hd, types) for kernel in ("flash_fwd_mma_kernel",
                                         "flash_bwd_dq_mma_kernel")
      for hd in FLASH_HEAD_DIMS for types in ("fp32/fp32", "fp32/bf16")),
    *((kernel, hd, "bf16/bf16") for kernel in ("flash_fwd_mma_kernel",
                                               "flash_bwd_dq_mma_kernel")
      for hd in FLASH_HEAD_DIMS if hd not in WGMMA_HEAD_DIMS),
    *(("flash_bwd_dkv_mma_kernel", hd, None) for hd in FLASH_HEAD_DIMS
      if hd not in WGMMA_HEAD_DIMS),
    *((kernel, hd, None) for kernel in ("flash_fwd_wgmma_kernel",
                                        "flash_bwd_dq_wgmma_kernel",
                                        "flash_bwd_dkv_wgmma_kernel")
      for hd in WGMMA_HEAD_DIMS),
    *(("flash_bwd_dkv_tf32_kernel", hd, types) for hd in FLASH_HEAD_DIMS
      for types in ("fp32/fp32", "fp32/bf16"))}
# the wide route's kernels (head dims above 256), in every type mix
FLASH_WIDE_KERNELS = {(kernel, types) for kernel in (
    "flash_fwd_wide_kernel", "flash_bwd_dq_wide_kernel",
    "flash_bwd_dkv_wide_kernel") for types in ("fp32/fp32", "bf16/bf16",
                                               "fp32/bf16")}
# the ragged kernel's template widths (0: above 256, through the decode
# core) and types, and the paged decode kernel's types
RAGGED_KERNELS = {(hd, bf16) for hd in (0, 32, 64, 128, 256)
                  for bf16 in (False, True)}
PAGED_KERNELS = {False, True}
# kernel 6's wgmma route (bf16 pages), templated on a consumer group's
# column chunks of 64
LATENT_WGMMA_KERNEL = "latent_ragged_paged_attention_wgmma_kernel"
# the flash type codes of ops/flash_attention.py
FLASH_CODES = {"fp32/fp32": 0, "bf16/bf16": 1, "fp32/bf16": 2}


def _template_types(head):
    """The q/k and v types of a flash kernel's mangled name ("fp32/bf16"),
    or None where it has no type arguments.  A repeated __nv_bfloat16 is
    mangled as a substitution (S<n>_); the 3xTF32 dk/dv template names
    v's type alone (its q/k are fp32)."""
    m = re.search(r"I(?:Li\d+E)?(f|13__nv_bfloat16)(f|13__nv_bfloat16|"
                  r"S\w*?_)", head)
    if m:
        return "/".join("fp32" if t == "f" else "bf16" for t in m.groups())
    m = re.search(r"dkv_tf32_kernelILi\d+E(f|13__nv_bfloat16)Lb", head)
    if m:
        return "fp32/" + ("fp32" if m.group(1) == "f" else "bf16")
    return None


# the routes hetu_flash_uses_tensor_cores reports
FLASH_ROUTES = {0: "cuda_cores", 1: "mma.sync", 2: "3xtf32", 3: "wgmma"}


def flash_route(entry, head_dim, types):
    """The route the library reports for C entry ``entry`` (0 forward, 1
    dq, 2 dk/dv) at this head dim and type mix."""
    return FLASH_ROUTES[fa._kernel_lib().hetu_flash_uses_tensor_cores(
        entry, head_dim, FLASH_CODES[types])]


def flash_occupancy():
    """Route, dynamic shared memory and blocks an SM of every flash kernel
    the entries launch, as the library and the card's occupancy calculator
    report them."""
    rows = []
    for entry, name in enumerate(("forward", "dq", "dk/dv")):
        for fused in ((False, True) if entry == 2 else (False,)):
            for types, code in FLASH_CODES.items():
                for hd in FLASH_HEAD_DIMS:
                    smem, blocks = fa._kernel_info(entry, hd, code, fused)
                    rows.append({"entry": name + (" fused" if fused else ""),
                                 "head_dim": hd, "types": types,
                                 "route": flash_route(entry, hd, types),
                                 "smem_bytes": smem, "blocks_per_sm": blocks})
    return rows


def phase_build():
    t0 = time.perf_counter()
    built = build()
    report = {}
    for name, info in built.items():
        entries = []
        for block in info["ptxas"].split("Compiling entry function")[1:]:
            head = block.splitlines()[0]
            hd = re.search(r"Li(\d+)E", head)
            regs = re.search(r"Used (\d+) registers", block)
            smem = re.search(r"(\d+) bytes smem", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", block)
            frame = re.search(r"(\d+) bytes stack frame", block)
            # the mangled name: <length><kernel name> after the file's hash
            kind = re.search(r"\d((?:flash|latent_ragged|ragged|paged)"
                             r"\w*?_kernel)", head)
            entries.append({
                "kernel": kind.group(1) if kind else head[:80],
                # flash, ragged: head_dim; latent: accumulator columns per
                # lane, then the page kind; paged decode: head_dim / 32
                "template_ints": [int(x) for x in
                                  re.findall(r"Li(\d+)E", head)],
                "head_dim": int(hd.group(1)) if hd else None,
                "types": _template_types(head),
                "bf16": "nv_bfloat16" in head,
                "fused": ("Lb1E" in head) if "dkv" in head else None,
                "registers": int(regs.group(1)) if regs else None,
                "static_smem_bytes": int(smem.group(1)) if smem else 0,
                "stack_frame_bytes": int(frame.group(1)) if frame else None,
                "spill_stores": int(spill.group(1)) if spill else None,
                "spill_loads": int(spill.group(2)) if spill else None})
        report[name] = {"so": info["so"], "cached": info["cached"],
                        "entries": entries}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": report, "flash_occupancy": flash_occupancy()})
    flash = [e for e in report["flash_attention"]["entries"]
             if e["kernel"].startswith("flash_")
             and "_wide_" not in e["kernel"]]
    got = {(e["kernel"], e["head_dim"], e["types"]) for e in flash}
    if len(flash) != 48 or got != FLASH_KERNELS:
        raise AssertionError(
            f"the tensor-core flash kernels (forward, dq, and dk/dv fused "
            f"and split, in every type mix, at head dims 32, 64, 128 and "
            f"256; the bf16 forward, dq and dk/dv on wgmma at 64 and 128) "
            f"must all be built: {flash}")
    wide = [(e["kernel"], e["types"])
            for e in report["flash_attention"]["entries"]
            if "_wide_" in e["kernel"]]
    if len(wide) != 9 or set(wide) != FLASH_WIDE_KERNELS:
        raise AssertionError(f"the wide flash kernels (forward, dq, dk/dv "
                             f"in every type mix) must all be built: {wide}")
    ragged = [(e["head_dim"] or 0, e["bf16"])
              for e in report["ragged_paged_attention"]["entries"]]
    paged = [e["bf16"] for e in report["paged_attention"]["entries"]]
    if sorted(ragged) != sorted(RAGGED_KERNELS) or \
            sorted(paged) != sorted(PAGED_KERNELS):
        raise AssertionError(f"the ragged kernel at every template width "
                             f"and the paged decode kernel, in bf16 and "
                             f"fp32, must all be built: {ragged}, {paged}")
    latent_wg = sorted(e["template_ints"][0] for e in
                       report["latent_ragged_paged_attention"]["entries"]
                       if e["kernel"] == LATENT_WGMMA_KERNEL)
    if latent_wg != [1, 2, 3, 4]:
        raise AssertionError(f"the latent wgmma kernel must be built for 1-4 "
                             f"column chunks a consumer group (d_c 64-512): "
                             f"{latent_wg}")
    spills = [(name, e["kernel"], e["template_ints"], e["types"])
              for name, r in report.items() for e in r["entries"]
              if e["spill_stores"] or e["spill_loads"]]
    if spills:
        raise AssertionError(f"kernels that spill: {spills}")
    return report


def ragged_work(q_lens, ctx_lens, maxp, nh, kvh, hd, itemsize):
    """Bytes the function must move and operations it must do for these
    rows, and the least time an H100 could take for them."""
    s = len(q_lens)
    kv_bytes = sum(c * kvh * hd * 2 * itemsize for c, q in
                   zip(ctx_lens, q_lens) if q > 0)
    qo_bytes = 2 * sum(q_lens) * nh * hd * itemsize
    meta = (s + (s + 1) + s * maxp + s) * 4
    flops = 4 * nh * hd * sum(c - q + j + 1 for q, c in zip(q_lens, ctx_lens)
                              for j in range(q))
    t_bytes = (kv_bytes + qo_bytes + meta) / H100_BYTES_PER_S
    t_ops = flops / H100_BF16_FLOPS
    return {"bytes": kv_bytes + qo_bytes + meta, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bf16_agreement(got, want, cu, q_lens):
    """Each row's largest |got - want| over its limit (BF16_REL * |want|
    + BF16_RMS_FLOOR * the row's output RMS), and the max abs error over
    every real token."""
    ratios, err = [], 0.0
    for i, n in enumerate(q_lens):
        if n == 0:
            continue
        g = got[int(cu[i]):int(cu[i]) + n].float()
        w = want[int(cu[i]):int(cu[i]) + n].float()
        d = (g - w).abs()
        limit = BF16_REL * w.abs() + BF16_RMS_FLOOR * w.pow(2).mean().sqrt()
        ratios.append((d / limit.clamp_min(1e-30)).max().item())
        err = max(err, d.max().item())
    return ratios, err


# fp32 agreement of the ragged kernel: |got - want| <= 2e-5 (the order of
# fp32 sums; both sides multiply in fp32)
RAGGED_FP32_TOL = 2e-5


# head dims of phase 3's small batches: 32 (the LLaMA config of
# ``__graft_entry__``, nh 8, kvh 8), and 80, 96, 100 and 256 (nh 8, kvh 2),
# which the kernel runs at the template width at or above them, and 264
# and 512, whose every token runs through the decode core
RAGGED_SMALL_HEAD_DIMS = {32: (8, 8), 80: (8, 2), 96: (8, 2), 100: (8, 2),
                          256: (8, 2), 264: (8, 2), 512: (8, 2)}


def ragged_small_batch(hd, nh, kvh):
    """The ragged kernel at head dim ``hd`` in bf16 and fp32: decode rows,
    a whole 64-token chunk, a row whose chunk is its whole context, a
    padding row and partial pages, against the plain version."""
    ps, max_q, maxp = 16, 64, 16
    q_lens = [1, 1, 0, 64, 37]
    ctx_lens = [200, 17, 0, 128, 37]
    cu = np.zeros(len(q_lens) + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    t = int(cu[-1]) + 3                       # trailing padding tokens
    rng = np.random.RandomState(3)
    num_pages = 1 + sum(-(-c // ps) for c in ctx_lens) + 2
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((len(q_lens), maxp), np.int32)
    k = 0
    for i, c in enumerate(ctx_lens):
        need = -(-c // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    real = np.zeros(t, bool)
    for i, n in enumerate(q_lens):
        real[cu[i]:cu[i] + n] = True
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        def dev(a, dt=None):
            x = torch.from_numpy(np.ascontiguousarray(a))
            return x.to(device="cuda", dtype=dt) if dt else x.cuda()
        args = (dev(rng.randn(t, nh, hd), dtype),
                dev(rng.randn(num_pages, ps, kvh, hd), dtype),
                dev(rng.randn(num_pages, ps, kvh, hd), dtype),
                dev(np.asarray(q_lens, np.int32)), dev(cu), dev(pt),
                dev(np.asarray(ctx_lens, np.int32)))
        got = ragged_paged_attention_cuda(*args, max_q=max_q)
        torch.cuda.synchronize()
        want = ragged_paged_attention_reference(*args, max_q=max_q)
        mask = torch.from_numpy(real).cuda()
        pad_nonzero = int(torch.count_nonzero(got[~mask]).item())
        if dtype == torch.bfloat16:
            ratio = max(bf16_agreement(got, want, cu, q_lens)[0])
        else:
            ratio = ((got - want).abs()[mask].max() / RAGGED_FP32_TOL).item()
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        out[name] = {"err_over_limit": ratio, "padding_nonzero": pad_nonzero}
        if not ratio <= 1.0 or pad_nonzero:
            raise AssertionError(f"ragged kernel at head dim {hd}, {name}: "
                                 f"{out[name]}")
    return {"q_lens": q_lens, "ctx_lens": ctx_lens, "nh": nh, "kvh": kvh,
            "hd": hd, "ps": ps, **out}


# phase 3's batch: the engine's layout of Llama-3-8B's serving shapes, 8
# decode slots (6 live, contexts 1 to 4096), then one 512-token chunk slot
RAGGED_SHAPES = {"nh": 32, "kvh": 8, "hd": 128, "ps": 64, "max_q": 512,
                 "maxp": 128}
RAGGED_Q_LENS = [1, 1, 1, 1, 1, 1, 0, 0, 512]
RAGGED_CTX_LENS = [4096, 3001, 1500, 65, 64, 1, 0, 0, 3000]
# the slots of the two padding rows (tokens 6 and 7) belong to no row
RAGGED_CU = [0, 1, 2, 3, 4, 5, 6, 7, 8, 520]


def ragged_serving_batch(q_lens=RAGGED_Q_LENS, ctx_lens=RAGGED_CTX_LENS,
                         cu=RAGGED_CU):
    """Phase 3's batch on the card (bf16 from seed 0), or the rows
    ``q_lens``/``ctx_lens`` at token offsets ``cu`` at its shapes: the
    kernel's arguments, and ``cu_q`` and the token count."""
    nh, kvh, hd, ps, maxp = (RAGGED_SHAPES[k] for k in
                             ("nh", "kvh", "hd", "ps", "maxp"))
    dev = torch.device("cuda")
    rows = len(q_lens)
    cu = np.asarray(cu, np.int32)
    t = int(cu[-1])
    num_pages = 1024
    rng = np.random.RandomState(0)
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((rows, maxp), np.int32)        # trash-page padding
    k = 0
    for i, c in enumerate(ctx_lens):
        need = -(-c // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q = rnd(t, nh, hd)
    kp, vp = rnd(num_pages, ps, kvh, hd), rnd(num_pages, ps, kvh, hd)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    args = (q, kp, vp, i32(q_lens), i32(cu), i32(pt), i32(ctx_lens))
    return args, cu, t


def ragged_serving_gate():
    """Phase 3's gate on its batch without raising: each live row's error
    over the bf16 limit, the max abs error and the nonzero padding
    outputs (``planted_faults`` reads it for the decode core's faults)."""
    args, cu, t = ragged_serving_batch()
    max_q = RAGGED_SHAPES["max_q"]
    got = ragged_paged_attention_cuda(*args, max_q=max_q)
    torch.cuda.synchronize()
    want = ragged_paged_attention_reference(*args, max_q=max_q)
    real = torch.zeros(t, dtype=torch.bool, device=got.device)
    for i, n in enumerate(RAGGED_Q_LENS):
        real[int(cu[i]):int(cu[i]) + n] = True
    ratios, err = bf16_agreement(got, want, cu, RAGGED_Q_LENS)
    return ratios, err, int(torch.count_nonzero(got[~real]).item())


def phase_kernel():
    nh, kvh, hd, ps, max_q, maxp = (RAGGED_SHAPES[k] for k in (
        "nh", "kvh", "hd", "ps", "max_q", "maxp"))
    dev = torch.device("cuda")
    q_lens, ctx_lens = RAGGED_Q_LENS, RAGGED_CTX_LENS
    rows = len(q_lens)
    args, cu, t = ragged_serving_batch()
    q, kp, vp = args[:3]

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    ratios, err, pad_nonzero = ragged_serving_gate()
    if not max(ratios) <= 1.0:
        raise AssertionError(
            f"kernel vs plain: error over the bf16 limit by {max(ratios)} "
            f"(per live row {ratios}); max abs err {err}")
    if pad_nonzero:
        raise AssertionError(f"{pad_nonzero} nonzero padding outputs")
    ms = cuda_time_ms(lambda: ragged_paged_attention_cuda(*args,
                                                          max_q=max_q),
                      warmup=3, iters=20)
    plain_ms = cuda_time_ms(lambda: ragged_paged_attention_reference(
        *args, max_q=max_q), warmup=1, iters=3)
    work = ragged_work(q_lens, ctx_lens, maxp, nh, kvh, hd, 2)
    # the decode core's KV split at these shapes (the wrapper's count) and
    # the slices each decode row reads
    n_splits = core_splits(sm_count(dev), rows, kvh, nh // kvh, maxp * ps)
    core = decode_core_info(hd, torch.bfloat16, ps, kvh, maxp, n_splits)
    core.update(n_splits=n_splits, live_slices=[
        -(-c // core["split_len"]) if q == 1 else 0
        for q, c in zip(q_lens, ctx_lens)])
    # the same batch split: its decode rows alone, its chunk alone
    parts = {}
    for part, keep in (("decode_rows", lambda i: i < 8),
                       ("chunk_row", lambda i: i == 8)):
        ql = [q if keep(i) else 0 for i, q in enumerate(q_lens)]
        pargs = (q, kp, vp, i32(ql)) + args[4:]
        pw = ragged_work(ql, ctx_lens, maxp, nh, kvh, hd, 2)
        call = lambda: ragged_paged_attention_cuda(  # noqa: E731
            *pargs, max_q=max_q)
        parts[part] = {
            "ms": cuda_time_ms(call, warmup=3, iters=20),
            "device_ms": graph_ms(call, iters=20),
            "bound_ms": pw["bound_ms"], "bound_by": pw["bound_by"],
            "bytes": pw["bytes"], "flops": pw["flops"]}
    out = {"max_abs_err": err,
           "limit": f"|got - want| <= {BF16_REL} * |want| + "
                    f"{BF16_RMS_FLOOR} * rms(want over the row)",
           "err_over_limit_by_row": ratios, "parts": parts,
           "decode_core": core,
           "padding_nonzero": pad_nonzero, "ms": ms,
           "device_ms": graph_ms(lambda: ragged_paged_attention_cuda(
               *args, max_q=max_q), iters=20), "plain_ms": plain_ms,
           "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
           "bytes": work["bytes"], "flops": work["flops"],
           "library_ms": None,
           "shapes": {"q_lens": q_lens, "ctx_lens": ctx_lens,
                      "nh": nh, "kvh": kvh, "hd": hd, "ps": ps,
                      "max_q": max_q, "maxp": maxp, "dtype": "bfloat16"},
           "head_dims": {str(hd): ragged_small_batch(hd, *heads) for hd, heads
                         in RAGGED_SMALL_HEAD_DIMS.items()}}
    emit({"phase": "kernel_vs_plain",
          "kernel": {"ragged_paged_attention": out}})
    return out


def device_kernels(prof):
    """``[(self device us, kernel name, calls)]`` of a profile's CUDA
    kernels, largest first."""
    kernels = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us, e.key, e.count))
    return sorted(kernels, reverse=True)


# CUPTI now and then loses a run of kernel records from a profiled window
# of replayed CUDA graphs, though every window replays the same graphs: a
# BERT-base step once showed 47 of its 48 forward flash kernels
# (``tools/profile_record_loss.py`` counts how often).  So a window that
# shows fewer launches than it made is profiled this many times more, and
# the last reading is held exactly.
PROFILE_REREADS = 1


def profiled_window(run, short=None):
    """Runs the window ``run()`` unprofiled, for its wall time, then under
    ``torch.profiler``, for its kernels.  Where ``short(kernels, run()'s
    result)`` says the profile shows fewer launches than the window made,
    a fresh window is profiled, at most ``PROFILE_REREADS`` times.  Returns
    ``(unprofiled wall s, profiled wall s, kernels, run()'s result under
    the profiler, rereads)``.  The profiler's own host cost inflates a
    replayed step several times over, so the idle share is read against
    the unprofiled wall."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    rereads = 0
    while True:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = device_kernels(prof)
        if (short is None or rereads == PROFILE_REREADS
                or not short(kernels, out)):
            return plain, wall, kernels, out, rereads
        rereads += 1


def attention_kernel(eng):
    """The name of the attention kernel ``eng``'s unified step launches:
    the ragged kernel, or for MLA the latent kernel of its pages' route."""
    pool = eng.pool
    if pool.latent_dim is None:
        return "ragged_paged_attention_kernel"
    if latent_route(pool.quant, pool.k_pages[0].dtype, pool.latent_dim,
                    pool.rope_dim, pool.page_size, eng.n_rows) == "wgmma":
        return LATENT_WGMMA_KERNEL
    return "latent_ragged_paged_attention_kernel"


def profile_steps(eng, rng, v, check=True):
    """Where a serving step's device time goes, after the measured run:
    the steps that serve two more requests (a 1000-token prompt in two
    chunks beside a decoding one), run once unprofiled and once under
    ``torch.profiler`` on fresh prompts of the same lengths
    (``profiled_window``).  Sums the CUDA kernels' own times by name;
    the idle share is 1 - busy / the unprofiled wall.  The steps replay
    captured CUDA graphs, so (with ``check``) the device must show the
    layout's attention kernel by name once per layer and unified step in
    the profiled window: the replays launch it (the wrappers' counters
    only add what the capture counted), by its name
    (``attention_kernel``)."""
    def window():
        calls0 = eng.executable_calls
        eng.add_request(rng.randint(1, v, size=100).tolist(), 24)
        eng.add_request(rng.randint(1, v, size=1000).tolist(), 8)
        steps = 0
        while eng.has_work:
            eng.step()
            steps += 1
        return steps, eng.executable_calls - calls0

    kernel = attention_kernel(eng)
    name = re.compile(rf"(?<!\w){kernel}\b")

    def calls(kernels):
        return sum(n for _, k, n in kernels if name.search(k))

    def short(kernels, out):
        return calls(kernels) < eng.cfg.num_layers * out[1]

    plain, wall, kernels, (steps, unified), rereads = profiled_window(
        window, short if check else None)
    seen = calls(kernels)
    if check and seen != eng.cfg.num_layers * unified:
        raise AssertionError(
            f"the profile saw {kernel} {seen} times in {unified} replayed "
            f"unified steps of {eng.cfg.num_layers} layers; the window's "
            f"kernels: {[(k[:90], n) for _, k, n in kernels]}")
    busy = sum(k[0] for k in kernels) / 1e6
    attn = sum(k[0] for k in kernels
               if "ragged_paged_attention" in k[1]) / 1e6
    return {"steps": steps, "unified_steps": unified,
            "profile_rereads": rereads, "attention_kernel": kernel,
            "attention_kernel_calls": seen, "unprofiled_wall_s": plain,
            "wall_s": wall, "device_busy_s": busy,
            "idle_share": (1.0 - busy / plain) if busy else None,
            "profiled_idle_share": (1.0 - busy / wall) if busy else None,
            "attention_s": attn,
            "attention_share_of_busy": attn / busy if busy else None,
            "compile_count": eng.compile_count,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n}
                    for us, k, n in kernels[:8]]}


def make_mix(rng, v, lens, header_len, tail):
    """Phase 4's prompts: one per entry of ``lens``, the third a
    ``header_len``-token header (whole pages) plus ``tail`` more, and a
    late prompt that shares the header."""
    header = rng.randint(1, v, size=header_len).tolist()
    prompts = [rng.randint(1, v, size=n).tolist() for n in lens]
    prompts[2] = header + prompts[2][:tail]
    return prompts, header + rng.randint(1, v, size=77).tolist()


# the request of phase 4's traffic that samples
MIX_SAMPLED = 3


def add_mix_request(eng, i, prompt, new):
    """Adds phase 4's request ``i``: greedy, or sampled if it is
    ``MIX_SAMPLED``."""
    sampled = i == MIX_SAMPLED
    return eng.add_request(prompt, new, temperature=0.8 if sampled else 0.0,
                           top_p=0.95 if sampled else 0.0,
                           seed=7 if sampled else 0)


def serve_mix(eng, prompts, late_prompt, new=32):
    """Serves ``prompts`` (one sampled, ``MIX_SAMPLED``), then the late
    prompt once the header's first user has finished, so that its header
    pages come from the prefix cache.  Returns the requests."""
    reqs = [add_mix_request(eng, i, p, new) for i, p in enumerate(prompts)]
    while reqs[2].state != "finished":
        eng.step()
    reqs.append(eng.add_request(late_prompt, new))
    eng.run()
    torch.cuda.synchronize()
    return reqs


def sample_head_ms(rows, vocab):
    """Device time (CUDA-graph replay) of ``sample_rows`` over ``[rows,
    vocab]`` fp32 logits, greedy rows only: the argmax path an eager step
    takes when no row samples, and the sort-based sampled path the
    captured step always takes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    logits = torch.randn(rows, vocab, generator=gen, device="cuda")
    zf = torch.zeros(rows, dtype=torch.float32, device="cuda")
    zi = torch.zeros(rows, dtype=torch.int32, device="cuda")
    return {path: graph_ms(lambda: sample_rows(logits, zf, zf, zi, zi, zi,
                                               sampled=sampled), iters=20)
            for path, sampled in (("argmax", False), ("sampled", True))}


def check_compile_count(eng, before, what):
    """The engine replays captured graphs: at most ``2**prefill_rows`` of
    them (one a live chunk-slot mask), none captured since ``before``
    was read, and ``metrics_summary`` reports the same count."""
    most = 2 ** eng.scheduler.prefill_rows
    now = eng.compile_count
    if not 1 <= now <= most or now != before or \
            eng.metrics_summary()["compile_count"] != now:
        raise AssertionError(f"{what}: compile_count {before} -> {now} "
                             f"(at most {most}, and stable)")


def eager_tokens(state, cfg, prompts, new, **kw):
    """Temperature-0 tokens of ``prompts`` from a fresh engine run
    eagerly on the card (``capture.eager()``): what a captured engine's
    tokens must equal."""
    eng = Engine(state, cfg, device="cuda", **kw)
    with capture.eager():
        reqs = [eng.add_request(p, new) for p in prompts]
        eng.run()
    if eng.compile_count:
        raise AssertionError("an eager engine captured a graph")
    return [r.out_tokens for r in reqs]


def phase_main_path(cfg, phase, model, counter, other_counter):
    """Serves phase 4's traffic at ``cfg``; ``counter`` is the attention
    kernel this layout must launch once per layer and unified step (on
    the wgmma route every time where ``attention_kernel`` names the
    latent wgmma kernel), ``other_counter`` the one it must never
    launch."""
    t0 = time.perf_counter()
    state = random_state(cfg, seed=0, device="cuda")
    n_params = sum(v.numel() for v in state.values())
    eng = Engine(state, cfg, num_pages=1024, page_size=64, max_batch=8,
                 chunk_size=512, prefill_rows=1, max_model_len=8192,
                 device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wgmma = attention_kernel(eng) == LATENT_WGMMA_KERNEL
    rng = np.random.RandomState(0)
    v = cfg.vocab_size
    mix = make_mix(rng, v, [32, 3000, 700, 1500, 64, 2200, 400],
                   header_len=1024, tail=200)       # 16 whole header pages
    # warm-up outside the measured run: one short request, whose prefill
    # step and decode step capture the two graphs (decode + chunk, decode
    # only) the measured run replays
    t1 = time.perf_counter()
    eng.add_request(rng.randint(1, v, size=16).tolist(), 2)
    eng.run()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t1
    calls0 = eng.executable_calls
    compiled = eng.compile_count
    torch.cuda.reset_peak_memory_stats()
    counter.launches = other_counter.launches = 0
    if wgmma:
        counter.wgmma_launches = 0
    t0 = time.perf_counter()
    reqs = serve_mix(eng, *mix)
    wall = time.perf_counter() - t0
    launches = counter.launches
    wgmma_launches = counter.wgmma_launches if wgmma else None
    calls = eng.executable_calls - calls0
    summary = eng.metrics_summary()
    if not all(r.state == "finished" and len(r.out_tokens) == 32
               for r in reqs):
        raise AssertionError("not every request finished with 32 tokens")
    toks = [t for r in reqs for t in r.out_tokens]
    if not all(0 <= t < v for t in toks):
        raise AssertionError("token id outside the vocabulary")
    if summary["prefix_cache_hits"] < 1:
        raise AssertionError("the shared header missed the prefix cache")
    if launches != cfg.num_layers * calls or other_counter.launches:
        raise AssertionError(
            f"kernel launches {launches} != {cfg.num_layers} x {calls} "
            f"unified steps, or the other layout's kernel ran "
            f"({other_counter.launches} launches)")
    if wgmma and wgmma_launches != launches:
        raise AssertionError(f"{wgmma_launches} of {launches} latent "
                             f"launches on the wgmma route")
    check_compile_count(eng, compiled, phase)
    ttfts = sorted(r.first_token_time - r.submit_time for r in reqs)
    out = {"model": model, "params": n_params, "layers": cfg.num_layers,
           "kv_bytes_per_token": eng.pool.kv_bytes_per_token,
           "setup_s": setup_s, "warmup_and_capture_s": warmup_s,
           "compile_count": eng.compile_count,
           "compile_count_in_summary": summary["compile_count"],
           "requests": len(reqs),
           "prompt_tokens": [len(r.prompt) for r in reqs],
           "generated_tokens": len(toks), "wall_s": wall,
           "tokens_per_s": len(toks) / wall,
           "ttft_p50_s": float(np.percentile(ttfts, 50)),
           "unified_steps": calls, "kernel_launches": launches,
           **({"wgmma_launches": wgmma_launches} if wgmma else {}),
           "prefix_cache_hits": summary["prefix_cache_hits"],
           "prefix_cache_tokens_saved":
               summary["prefix_cache_tokens_saved"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "sample_head_ms": sample_head_ms(eng.n_rows, v),
           "sampled_tokens": reqs[MIX_SAMPLED].out_tokens[:8]}
    emit({"phase": phase, **out})
    emit({"phase": "step_profile", "of": phase,
          **profile_steps(eng, rng, v)})
    del eng, state
    torch.cuda.empty_cache()
    return out


def phase_oracle():
    # full fp32 products on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_8b_config(num_layers=2, dtype="float32")
    state = random_state(cfg, seed=1, device="cuda")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in (300, 17, 129)]
    kw = dict(num_pages=64, page_size=64, max_batch=4, chunk_size=128)
    eng = Engine(state, cfg, device="cuda", **kw)
    reqs = [eng.add_request(p, 8) for p in prompts]
    eng.run()
    want = [generate(state, cfg, [p], 8, device="cuda")[0, len(p):]
            .tolist() for p in prompts]
    got = [r.out_tokens for r in reqs]
    if got != want:
        raise AssertionError(f"engine {got} != generate {want}")
    check_compile_count(eng, eng.compile_count, "oracle")
    eager = eager_tokens(state, cfg, prompts, 8, **kw)
    if eager != got:
        raise AssertionError(f"captured engine {got} != eager engine "
                             f"{eager}")
    emit({"phase": "oracle", "layers": 2, "dtype": "float32",
          "requests": len(prompts), "equal": True,
          "captured_equals_eager": True, "compile_count": eng.compile_count,
          "tokens": got})


# ---------------------------------------------------------------------------
# flash attention: kernels 1-4 against their plain versions (phase 6)
# ---------------------------------------------------------------------------

# (q/k dtype, v dtype) of the mixes the training path feeds: the bf16 LLaMA
# model's first layer (fp32 rotary tables promote q/k), its later layers
# (the fp32 attention output promotes the residual stream), GPT-2
FLASH_TYPES = {"fp32_qk_bf16_v": (torch.float32, torch.bfloat16),
               "fp32": (torch.float32, torch.float32),
               "bf16": (torch.bfloat16, torch.bfloat16)}
LLAMA_ATTN = (2, 4096, 32, 128)    # b (one micro-batch), s, h, d
GPT2_ATTN = (4, 1024, 12, 64)
BERT_ATTN = (16, 512, 12, 64)      # BERT-base, one micro-batch, not causal
# fp32 agreement, |got - want| <= tol * (1 + |want|): sums in another
# order over up to 4096 keys (forward), and over 4096 queries of products
# of products (backward)
FP32_FWD_TOL = 1e-4
FP32_BWD_TOL = 1e-3
# rows whose exact value cancels to 0 leave only the order of two fp32
# sums: they are held to 2**-16 of the tensor's RMS, far below one bf16
# ulp
CANCEL_FLOOR = 2.0 ** -16


def single_key_ulps(d):
    """The rounding bound of dq on a query row that sees exactly one key,
    in units of 2**-24 * scale * sum_d |do * v| * |k| (that key's v and
    k).  There p = 1, out = v and dp = delta, so dq = 0 exactly; what is
    left comes out of fp32 sums, each off by at most 2**-23 (a truncating
    accumulator) of its |terms| a term: delta (d terms: 2d units), the
    kernel's dP chain started at -delta (d + 1 terms summing to at most
    twice delta's: 4(d + 1)), its products on 3xTF32 (3 * 2**-22 each in
    fp32, 2**-22 with a bf16 v: 12d), times 1.1 for p (the bf16 kernels'
    rounded q * scale moves it by a few percent) and dS's rounding:
    under 24 (d + 1).  It holds for every draw of the inputs;
    ``tools/single_key_rows.py`` reads the kernels, the plain version and
    two faults of delta against it."""
    return 24 * (d + 1)
FLASH_REPLACES = {
    "flash_fwd": "hetu_tpu/ops/pallas/flash_attention.py:178",
    "flash_bwd_fused": "hetu_tpu/ops/pallas/flash_attention.py:325",
    "flash_bwd_dq": "hetu_tpu/ops/pallas/flash_attention.py:466",
    "flash_bwd_dkv": "hetu_tpu/ops/pallas/flash_attention.py:510"}


def flash_wrappers():
    return {"flash_fwd": fa.flash_fwd_cuda,
            "flash_bwd_fused": fa.flash_bwd_fused_cuda,
            "flash_bwd_dq": fa.flash_bwd_dq_cuda,
            "flash_bwd_dkv": fa.flash_bwd_dkv_cuda}


def flash_work(kernel, b, sq, sk, h, d, qk_dtype, v_dtype, causal=True,
               offset=0):
    """Bytes the function must move (each input read once, each output
    written once), operations over the (query, key) pairs this mask lets
    through, and the least time an H100 could take for them."""
    pairs = b * h * (sum(max(0, min(sk, i + offset + 1)) for i in range(sq))
                     if causal else sq * sk)
    qi = torch.empty((), dtype=qk_dtype).element_size()
    vi = torch.empty((), dtype=v_dtype).element_size()
    qo, kv, row = b * sq * h * d, b * sk * h * d, b * h * sq * 4

    # products of 2*d operations per pair, by their operand types: forward
    # s = q.k and o = p.v (p rounded to v's type); backward s, dp = do.v
    # (do in q's type), then dq = ds.k, dv = p.do, dk = ds.q (p and ds in
    # q's type)
    s, pv, dp = (qk_dtype, qk_dtype), (v_dtype, v_dtype), (qk_dtype, v_dtype)
    per = {"flash_fwd": [s, pv],
           "flash_bwd_dq": [s, dp, s],
           "flash_bwd_dkv": [s, dp, s, s],
           "flash_bwd_fused": [s, dp, s, s, s]}[kernel]
    t_ops = sum(2 * d * pairs / product_rate(*ab) for ab in per)
    nbytes = {"flash_fwd": qo * qi * 2 + kv * (qi + vi) + row,
              "flash_bwd_dq": qo * qi * 3 + kv * (qi + vi) + 2 * row,
              "flash_bwd_dkv": qo * qi * 2 + kv * (qi + vi) * 2 + 2 * row,
              "flash_bwd_fused": qo * qi * 4 + kv * (qi + vi) * 2 + row
              }[kernel]
    t_bytes = nbytes / H100_BYTES_PER_S
    return {"bytes": nbytes, "flops": 2 * d * pairs * len(per),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_inputs(b, sq, sk, h, d, types, seed):
    qk, vt = FLASH_TYPES[types]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(n, dt):
        return torch.randn((b, n, h, d), generator=gen, device="cuda").to(dt)
    return rnd(sq, qk), rnd(sk, qk), rnd(sk, vt), rnd(sq, qk)


def flash_agreement(got, want, dims, scaled, tol):
    """Largest |got - want| over its limit, and the max abs error.  The
    bf16 limit (``scaled``) is BF16_REL * |want| + BF16_RMS_FLOOR * the
    RMS of want over ``dims`` (each query's row of out/dq, each key's row
    of dk/dv: a causal key's gradient grows with the number of queries
    that see it, so one (batch, head) RMS would under-cover the first
    keys): one output ulp plus the probabilities the kernel rounds to
    bf16; plus CANCEL_FLOOR * the whole tensor's RMS for rows that cancel
    to rounding noise.  Else tol * (1 + |want|)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if scaled:
        limit = BF16_REL * w.abs() + BF16_RMS_FLOOR * \
            w.pow(2).mean(dim=dims, keepdim=True).sqrt() + \
            CANCEL_FLOOR * w.pow(2).mean().sqrt()
    else:
        limit = tol * (1 + w.abs())
    return (d / limit.clamp_min(1e-30)).max().item(), d.max().item()


def single_key_rows(b, sq, sk, causal, segs, offset, device):
    """[b, sq] bool: the query rows that see exactly one key.  Their p is
    1 on that key and out is its v, so delta = dp and dq is exactly 0."""
    split = fa._split_segments(segs, sq, sk)
    rows = torch.zeros((b, sq), dtype=torch.bool, device=device)
    for bi in range(b):
        mask = fa._visible(bi, sq, sk, causal, offset, split, device)
        if mask is not None:
            rows[bi] = mask.sum(dim=1) == 1
        elif sk == 1:
            rows[bi] = True
    return rows


def single_key_fp64(q, k, v, do, one, causal, segs, offset, scale):
    """The plain version in fp64 on the query rows of ``one`` ([b, sq]
    bool, rows that see exactly one key): (dq there [n, h, d] from a
    softmax over each row's visible keys, its out, delta and dS, all in
    fp64; each element's bound ``single_key_ulps``)."""
    b, sq, _, d = q.shape
    sk = k.shape[1]
    split = fa._split_segments(segs, sq, sk)
    dq64, bound = [], []
    unit = single_key_ulps(d) * 2.0 ** -24 * scale
    for bi in range(b):
        rows = one[bi].nonzero()[:, 0]
        if not len(rows):
            continue
        mask = fa._visible(bi, sq, sk, causal, offset, split, q.device)
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device) \
            if mask is None else mask
        kd, vd = k[bi].double(), v[bi].double()              # [sk, h, d]
        for r in rows.split(256):
            m = mask[r]                                        # [n, sk]
            qd, dod = q[bi, r].double(), do[bi, r].double()    # [n, h, d]
            s = torch.einsum("nhd,khd->hnk", qd, kd) * scale
            p = torch.softmax(s.masked_fill(~m[None], float("-inf")), -1)
            o = torch.einsum("hnk,khd->nhd", p, vd)
            dp = torch.einsum("nhd,khd->hnk", dod, vd)
            delta = (dod * o).sum(-1).transpose(0, 1)          # [h, n]
            ds = p * (dp - delta[..., None])
            dq64.append(torch.einsum("hnk,khd->nhd", ds, kd) * scale)
            j = m.int().argmax(-1)                             # its key
            terms = (dod * vd[j]).abs().sum(-1, keepdim=True)  # [n, h, 1]
            bound.append(unit * terms * kd[j].abs())
            del s, p, dp, ds
    return torch.cat(dq64), torch.cat(bound)


def flash_ratios(q, k, v, do, causal=True, segs=None, offset=0, tag=""):
    """Runs kernels 1-4 once on these inputs and holds each output against
    the plain versions: ``({kernel: (error over limit, max abs err)},
    (plain out, lse, delta), {name: the kernels' out, lse and dq})``.
    The backward kernels get the plain forward's out/lse, so each is
    checked on its own."""
    bf16_qk, bf16_v = q.dtype == torch.bfloat16, v.dtype == torch.bfloat16
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, segs, offset)
    torch.cuda.synchronize()
    ro, rl = fa.flash_fwd_reference(q, k, v, scale, causal, segs, offset)
    if not torch.equal(torch.isinf(lse), torch.isinf(rl)):
        raise AssertionError(f"{tag} forward: -inf rows of lse differ")
    res = {}
    live = torch.isfinite(rl)
    # the bf16 kernel rounds q * scale * log2(e) to bf16 as the reference
    # does (flash_attention.py:274), which moves lse by up to 2**-9 of the
    # scores: its lse is held at the fp32 limit against the plain version
    # on that rounded operand
    rl_q = rl if not bf16_qk else fa.flash_fwd_reference(
        (q.float() * (scale * fa.LOG2E)).to(q.dtype), k, v, 1 / fa.LOG2E,
        causal, segs, offset)[1]
    ratios = [flash_agreement(out, ro, (3,), bf16_v, FP32_FWD_TOL),
              flash_agreement(lse[live], rl_q[live], (0,), False,
                              FP32_FWD_TOL)]
    res["flash_fwd"] = (max(r[0] for r in ratios), ratios[0][1])
    want = list(fa.flash_bwd_reference(q, k, v, ro, rl, do, scale, causal,
                                       segs, offset))
    # dq of the rows that see one key is held against the fp64 plain
    # version within its rounding bound (``single_key_ulps``), and left
    # out of the bf16/fp32 rule below
    one = single_key_rows(q.shape[0], q.shape[1], k.shape[1], causal, segs,
                          offset, q.device)
    single = {"rows": int(one.sum().item())}
    if one.any():
        dq64, bound = single_key_fp64(q, k, v, do, one, causal, segs,
                                      offset, scale)

        def over_bound(dq):
            err = (dq[one].double() - dq64).abs()
            return (err / bound).max().item(), err.max().item()
        single["bound_max"] = bound.max().item()
        single["plain_over_bound"] = over_bound(want[0])[0]
    delta = torch.einsum("bshd,bshd->bsh", do.float(), ro.float())
    got = {"flash_bwd_fused": fa.flash_bwd_fused_cuda(
        q, k, v, ro, rl, do, scale, causal, segs, offset),
        "flash_bwd_dq": (fa.flash_bwd_dq_cuda(
            q, k, v, do, rl, delta, scale, causal, segs, offset),),
        "flash_bwd_dkv": fa.flash_bwd_dkv_cuda(
            q, k, v, do, rl, delta, scale, causal, segs, offset)}
    torch.cuda.synchronize()
    picks = {"flash_bwd_fused": (0, 1, 2), "flash_bwd_dq": (0,),
             "flash_bwd_dkv": (1, 2)}
    for name, outs in got.items():
        rs = []
        for g, i in zip(outs, picks[name]):
            if i == 0 and one.any():
                rs.append(over_bound(g))
                single[f"{name}_over_bound"] = rs[-1][0]
                g = torch.where(one[..., None, None], want[0], g)
            rs.append(flash_agreement(g, want[i], (3,), bf16_qk or
                                      (i == 2 and bf16_v), FP32_BWD_TOL))
        res[name] = (max(r[0] for r in rs), max(r[1] for r in rs))
    kernel_outs = {"out": out, "lse": lse,
                   "dq_fused": got["flash_bwd_fused"][0],
                   "dq_split": got["flash_bwd_dq"][0],
                   "single_key_rows": single}
    return res, (ro, rl, delta), kernel_outs


def check_flash(q, k, v, do, causal=True, segs=None, offset=0, tag=""):
    """:func:`flash_ratios`, raising on any kernel over its limit."""
    res, plain, kernel_outs = flash_ratios(q, k, v, do, causal, segs,
                                           offset, tag)
    for name, (ratio, err) in res.items():
        if not ratio <= 1.0:
            raise AssertionError(f"{tag} {name}: error over the limit by "
                                 f"{ratio} (max abs err {err})")
    return res, plain, kernel_outs


def library_times(b, s, h, d, types, seed=1, causal=True):
    """PyTorch's own attention at this shape on ``types`` ("bf16" or
    "fp32", its default backend with TF32 off; only as a yardstick: the
    port never calls it), on the inputs phase 6 gives the kernels (seed 1),
    causal or not: ``tools/sdpa_times.py``, which
    ``tools/compare_flash_kernels.py`` reads too.  SDPA takes no (fp32,
    fp32, bf16) q/k/v, so the mixed rows have no library time."""
    return sdpa_times(*flash_inputs(b, s, s, h, d, types, seed),
                      graph_ms=graph_ms, events_ms=cuda_time_ms,
                      causal=causal)


def phase_flash():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = {"llama/bf16": library_times(*LLAMA_ATTN, "bf16"),
           "llama/fp32": library_times(*LLAMA_ATTN, "fp32"),
           "gpt2/bf16": library_times(*GPT2_ATTN, "bf16"),
           "gpt2/fp32": library_times(*GPT2_ATTN, "fp32"),
           "bert/bf16": library_times(*BERT_ATTN, "bf16", causal=False),
           "bert/fp32": library_times(*BERT_ATTN, "fp32", causal=False)}
    shapes = {}
    for shape_name, (b, s, h, d), mixes, causal in (
            ("llama", LLAMA_ATTN, ("fp32_qk_bf16_v", "fp32", "bf16"), True),
            ("gpt2", GPT2_ATTN, ("bf16", "fp32_qk_bf16_v", "fp32"), True),
            ("bert", BERT_ATTN, ("bf16", "fp32"), False)):
        for types in mixes:
            q, k, v, do = flash_inputs(b, s, s, h, d, types, seed=1)
            scale = d ** -0.5
            res, (ro, rl, delta), outs = check_flash(
                q, k, v, do, causal, tag=f"{shape_name}/{types}")
            plain_fwd = cuda_time_ms(lambda: fa.flash_fwd_reference(
                q, k, v, scale, causal), warmup=1, iters=2)
            plain_bwd = cuda_time_ms(lambda: fa.flash_bwd_reference(
                q, k, v, ro, rl, do, scale, causal), warmup=1, iters=2)
            calls = {
                "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, scale,
                                                       causal),
                "flash_bwd_fused": lambda: fa.flash_bwd_fused_cuda(
                    q, k, v, ro, rl, do, scale, causal),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(
                    q, k, v, do, rl, delta, scale, causal),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(
                    q, k, v, do, rl, delta, scale, causal)}
            row = {"causal": causal}
            yard = lib.get(f"{shape_name}/{types}")
            for name, fn in calls.items():
                work = flash_work(name, b, s, s, h, d, q.dtype, v.dtype,
                                  causal)
                row[name] = {
                    "ms": cuda_time_ms(fn, warmup=2, iters=5),
                    "device_ms": graph_ms(fn, iters=5),
                    "plain_ms": plain_fwd if name == "flash_fwd"
                    else plain_bwd,
                    "library_ms": None if yard is None else
                    yard["fwd_ms" if name == "flash_fwd" else "bwd_ms"],
                    "library_device_ms": None if yard is None else
                    yard["fwd_device_ms" if name == "flash_fwd"
                         else "bwd_device_ms"],
                    "max_abs_err": res[name][1],
                    "err_over_limit": res[name][0], **work}
            row["single_key_rows"] = outs["single_key_rows"]
            shapes[f"{shape_name}/{types}"] = row
            del q, k, v, do, ro, rl, delta
            torch.cuda.empty_cache()
    # small masked cases: every kernel, every type mix; head dims 32 and
    # 256 (the kernels' own), 96 and 200 (zero-padded to 128 and 256 by
    # the wrappers), 512 and 320 (the wide route, 320 padded to 384);
    # not causal (BERT's route) at head dims 64 and 128, with a fully
    # masked half, segment tuples and sq != sk
    small = []
    for b, sq, sk, h, d, seg, offset, causal in (
            (2, 128, 128, 2, 64, "masked", 0, False),
            (1, 300, 300, 2, 64, None, 0, False),
            (1, 64, 192, 2, 128, "tuple", 0, False),
            (1, 200, 136, 2, 128, None, 0, False),
            (1, 64, 192, 2, 64, "tuple", 128, True),
            (2, 128, 128, 2, 128, "masked", 0, True),
            (1, 1000, 1000, 2, 128, None, 0, True),
            (1, 1000, 1000, 2, 64, "offset", -24, True),
            (2, 128, 128, 8, 32, "masked", 0, True),
            (1, 1000, 1000, 8, 32, "offset", -24, True),
            (1, 64, 192, 2, 96, "tuple", 128, True),
            (1, 1000, 1000, 2, 96, None, 0, True),
            (2, 128, 128, 2, 256, "masked", 0, True),
            (1, 1000, 1000, 2, 256, "offset", -24, True),
            (1, 64, 192, 2, 200, "tuple", 128, True),
            (1, 1000, 1000, 2, 200, None, 0, True),
            (2, 128, 128, 2, 512, "masked", 0, True),
            (1, 300, 300, 2, 512, "offset", -24, True),
            (1, 64, 192, 2, 320, "tuple", 128, True),
            (1, 300, 300, 2, 320, None, 0, True)):
        for types in FLASH_TYPES:
            q, k, v, do = flash_inputs(b, sq, sk, h, d, types, seed=2)
            segs = None
            if seg in ("tuple", "masked"):
                kv = torch.arange(sk, device="cuda", dtype=torch.int32) \
                    // (sk // 2)
                kv = kv[None].expand(b, sk).contiguous()
                qi = kv[:, sk - sq:].clone()
                if seg == "masked":
                    qi[:, sq // 2:] = 7          # ids that no key has
                segs = (qi, kv)
            res, _, got = check_flash(q, k, v, do, causal, segs, offset,
                                      tag=f"small {seg} {types}")
            empty = 0
            if seg == "masked" or (causal and offset < 0):
                # rows that see no key: out = 0, lse = -inf, dq = 0 exactly
                rows = slice(sq // 2, None) if seg == "masked" \
                    else slice(0, -offset)
                empty = sum(int(torch.count_nonzero(got[n][:, rows]).item())
                            for n in ("out", "dq_fused", "dq_split"))
                empty += int((got["lse"][:, :, rows] != float("-inf"))
                             .sum().item())
                if empty:
                    raise AssertionError(f"small {seg} {types}: {empty} "
                                         f"values of the empty rows are not "
                                         f"out = 0, lse = -inf, dq = 0")
            small.append({"b": b, "sq": sq, "sk": sk, "h": h, "d": d,
                          "causal": causal, "segments": seg,
                          "causal_offset": offset,
                          "types": types, "empty_rows_nonzero": empty,
                          "err_over_limit": {n: r[0] for n, r in res.items()}})
    emit({"phase": "flash_vs_plain", "shapes": shapes, "small_cases": small,
          "library": lib, "wide_route": flash_wide_times()})
    return shapes


# the wide route's timed shape: head dim 512, causal
FLASH_WIDE_ATTN = (1, 1024, 4, 512)


def flash_wide_times():
    """The four flash kernels on the wide route at ``FLASH_WIDE_ATTN`` in
    bf16 and fp32: each kernel's time (CUDA events around the calls) beside
    its bound and the plain version's, checked against the plain versions
    first.  A simple route, timed but not tuned."""
    b, s, h, d = FLASH_WIDE_ATTN
    out = {}
    for types in ("bf16", "fp32"):
        q, k, v, do = flash_inputs(b, s, s, h, d, types, seed=3)
        scale = d ** -0.5
        res, (ro, rl, delta), _ = check_flash(q, k, v, do,
                                              tag=f"wide {types}")
        calls = {
            "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, scale, True),
            "flash_bwd_fused": lambda: fa.flash_bwd_fused_cuda(
                q, k, v, ro, rl, do, scale, True),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, rl, delta, scale, True),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, do, rl, delta, scale, True)}
        plain = {"fwd": cuda_time_ms(lambda: fa.flash_fwd_reference(
            q, k, v, scale, True), warmup=1, iters=2),
            "bwd": cuda_time_ms(lambda: fa.flash_bwd_reference(
                q, k, v, ro, rl, do, scale, True), warmup=1, iters=2)}
        out[types] = {name: {
            "ms": cuda_time_ms(fn, warmup=1, iters=3),
            "plain_ms": plain["fwd" if name == "flash_fwd" else "bwd"],
            "err_over_limit": res[name][0],
            **flash_work(name, b, s, s, h, d, q.dtype, v.dtype)}
            for name, fn in calls.items()}
        del q, k, v, do, ro, rl, delta
        torch.cuda.empty_cache()
    return {"shape": dict(zip(("b", "s", "h", "d"), FLASH_WIDE_ATTN)),
            **out}


# ---------------------------------------------------------------------------
# the training step (phases 7 and 8)
# ---------------------------------------------------------------------------

def train_config(name):
    """(config, global batch, seq) of each main-path run."""
    if name == "llama3_8b_4_layers":
        # Adam at all 32 layers needs 8.03 B params x 12 B = 96 GB; depth
        # is cut to 4 (1.92 B params), widths are Meta's
        return llama3_8b_config(num_layers=4), 4, 4096
    return GPTConfig(dtype="bfloat16"), 8, 1024     # GPT-2 small, 124 M


def build_trainer(cfg, batch, seq, device, lr, seed=0):
    with ht.graph("define_and_run", create_new=True, device=device,
                  seed=seed) as g:
        ids = ht.parallel_placeholder("int32", (batch, seq), name="input_ids")
        labels = ht.parallel_placeholder("int32", (batch, seq),
                                         name="labels")
        model = GPTLMHeadModel(cfg)
        loss = model(ids, labels)
        train_op = ht.optim.AdamOptimizer(lr=lr).minimize(loss)
    return g, ids, labels, model, loss, train_op


def seeded_batch(vocab, batch, seq, seed):
    toks = np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def profile_train(g, loss, train_op, feeds, flash_per_step, steps=2,
                  check=True):
    """Where a training step's device time goes: ``steps`` more steps,
    unprofiled and then under ``torch.profiler`` (``profiled_window``);
    kernel time by name and the idle share (1 - busy / the unprofiled
    wall).  The steps replay the captured graph, so (with ``check``) the
    device must show each flash kernel by name as often as
    ``flash_per_step`` (kernel name prefix -> launches a step) says."""
    def window():
        for _ in range(steps):
            g.run(loss, [loss, train_op], feeds, num_micro_batches=2)

    want = {name: c * steps for name, c in flash_per_step.items()}

    def calls(kernels):
        return {name: sum(n for _, k, n in kernels if name in k)
                for name in flash_per_step}

    def short(kernels, _):
        seen = calls(kernels)
        return any(seen[name] < want[name] for name in want)

    plain, wall, kernels, _, rereads = profiled_window(
        window, short if check else None)
    busy = sum(k[0] for k in kernels) / 1e6
    flash = sum(k[0] for k in kernels if "flash_" in k[1]) / 1e6
    seen = calls(kernels)
    if check and seen != want:
        raise AssertionError(f"the profile saw flash kernels {seen} in "
                             f"{steps} replayed steps, want {want}")
    gemm = sum(k[0] for k in kernels
               if any(t in k[1] for t in ("gemm", "nvjet", "xmma"))) / 1e6
    return {"steps": steps, "profile_rereads": rereads,
            "unprofiled_wall_s": plain, "wall_s": wall,
            "device_busy_s": busy,
            "idle_share": (1.0 - busy / plain) if busy else None,
            "profiled_idle_share": (1.0 - busy / wall) if busy else None,
            "flash_kernel_calls": seen,
            "flash_kernels": {k: n for _, k, n in kernels if "flash_" in k},
            "flash_attention_s": flash, "matmul_s": gemm,
            "flash_share_of_busy": flash / busy if busy else None,
            "matmul_share_of_busy": gemm / busy if busy else None,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n}
                    for us, k, n in kernels[:12]]}


# phase 7: Adam steps and micro-batches of each main-path run
TRAIN_STEPS, TRAIN_MICRO = 6, 2


def phase_train(name):
    steps, micro = TRAIN_STEPS, TRAIN_MICRO
    cfg, batch, seq = train_config(name)
    t0 = time.perf_counter()
    g, ids, labels, model, loss, train_op = build_trainer(
        cfg, batch, seq, "cuda", lr=3e-4)
    # materializes the seeded random init (a loop variable here would keep
    # the last parameter, and so the whole graph, alive after the phase)
    n_params = sum(p.get_data().numel() for p in model.parameters())
    x, y = seeded_batch(cfg.vocab_size, batch, seq, seed=0)
    feeds = {ids: x, labels: y}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    wrappers = flash_wrappers()
    reset_flash_counts()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        l, upd = g.run(loss, [loss, train_op], feeds,
                       num_micro_batches=micro)
        losses.append(float(l))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if upd is not None:
            raise AssertionError("the update op's fetch is not None")
    launches = {n: fn.launches for n, fn in wrappers.items()}
    tensor_core = {n: fn.tensor_core_launches for n, fn in wrappers.items()}
    tf32 = {n: fn.tf32_launches for n, fn in wrappers.items()}
    wgmma = {n: fn.wgmma_launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses} not finite and falling")
    # the byte rule on the first layer's k: fp32 for the LLaMA model (its
    # fp32 rotary tables promote q/k; later layers run fp32 throughout),
    # bf16 for GPT-2
    k_dtype = torch.float32 if cfg.position == "rotary" else torch.bfloat16
    fused = fa._use_fused(seq, cfg.head_dim, k_dtype)
    each = cfg.num_layers * micro * steps
    want = {"flash_fwd": each, "flash_bwd_fused": each if fused else 0,
            "flash_bwd_dq": 0 if fused else each,
            "flash_bwd_dkv": 0 if fused else each}
    if launches != want:
        raise AssertionError(f"{name}: flash launches {launches} != {want}")
    # every launch runs on the tensor cores: for all-bf16 attention
    # (GPT-2) every kernel on wgmma at head dims 64 and 128; 3xTF32 for the
    # LLaMA path's fp32 and mixed attention (the mixed forward's P.V on
    # bf16)
    bf16 = k_dtype == torch.bfloat16
    on_wgmma = bf16 and fa._kernel_head_dim(cfg.head_dim) in WGMMA_HEAD_DIMS
    want_tc = dict(want)
    want_tf32 = {n: 0 if bf16 else c for n, c in want_tc.items()}
    want_wgmma = {n: c if on_wgmma else 0 for n, c in want_tc.items()}
    if tensor_core != want_tc or tf32 != want_tf32 or wgmma != want_wgmma:
        raise AssertionError(f"{name}: tensor-core flash launches "
                             f"{tensor_core} (3xTF32 {tf32}, wgmma {wgmma}) "
                             f"!= {want_tc} (3xTF32 {want_tf32}, wgmma "
                             f"{want_wgmma})")
    # one plan, captured once at the first step and replayed after it
    if len(g._plan_pool) != 1 or g.compile_count != 1:
        raise AssertionError(f"{name}: {len(g._plan_pool)} plans, "
                             f"{g.compile_count} captured graphs")
    steady = step_s[1:]
    out = {"config": name, "params": n_params, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
           "global_batch": batch, "seq": seq, "micro_batches": micro,
           "dtype": cfg.dtype, "setup_s": setup_s, "losses": losses,
           "step_s": step_s, "ms_per_step": 1e3 * float(np.mean(steady)),
           "tokens_per_s": batch * seq / float(np.mean(steady)),
           "peak_memory_bytes": peak, "flash_launches": launches,
           "tensor_core_launches": tensor_core, "tf32_launches": tf32,
           "wgmma_launches": wgmma,
           "backward": "fused" if fused else "split",
           "compile_count": g.compile_count}
    emit({"phase": "train_main_path", **out})
    per_step = cfg.num_layers * micro
    emit({"phase": "train_profile", "config": name,
          **profile_train(g, loss, train_op, feeds, {
              "flash_fwd_": per_step,
              "flash_bwd_dq_": 0 if fused else per_step,
              "flash_bwd_dkv_": per_step})})
    del g, ids, labels, model, loss, train_op, feeds
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the card-against-CPU training oracle (phases 8 and 14): Adam steps,
# micro-batches and lr
ORACLE_STEPS, ORACLE_MICRO, ORACLE_LR = 3, 2, 1e-6


def train_oracle_case(name, cfg, batch, seq, check=True):
    """``cfg`` trains ``ORACLE_STEPS`` steps of ``ORACLE_MICRO``
    micro-batches on the CPU (plain versions) and on the card (kernels)
    from the same weights and batch.  Losses within 1e-4
    relative (lr is small because one Adam step of 1e-4 on a full-width
    matrix already drives the loss on one batch from 7.7 to 3e-4, where a
    relative comparison reads rounding noise).  Parameters: for every
    tensor the card's update agrees with the CPU's to 1 % (|p_card - p_cpu|
    <= 0.01 |p_cpu - p_init|), and no element differs by more than 2 * lr
    * steps -- Adam moves an element by about lr a step whatever its
    gradient's size, so where a gradient cancels to rounding noise its
    sign, and so that step, can differ between the two sums.  Returns the
    report with ``within_limits``; raises past a limit if ``check``."""
    steps, lr = ORACLE_STEPS, ORACLE_LR
    x, y = seeded_batch(cfg.vocab_size, batch, seq, seed=1)
    runs, init = {}, None
    for dev in ("cpu", "cuda"):
        g, ids, labels, model, loss, train_op = build_trainer(
            cfg, batch, seq, dev, lr=lr, seed=1)
        if init is None:
            init = state_numpy(model)
        else:
            load_state(model, init)
        t0 = time.perf_counter()
        losses = [float(g.run(loss, [loss, train_op], {ids: x, labels: y},
                              num_micro_batches=ORACLE_MICRO)[0])
                  for _ in range(steps)]
        runs[dev] = (losses, state_numpy(model), time.perf_counter() - t0)
        del g, model
        gc.collect()
    return oracle_report(name, runs, init, lr, steps, check)


def oracle_report(name, runs, init, lr, steps, check):
    """``train_oracle_case``'s limits over ``runs`` (device -> (losses,
    final state, seconds)) from the weights ``init``."""
    (lc, pc, tc), (lg, pg, tg) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    upd_rel, max_abs = 0.0, 0.0
    for k in pc:
        diff = np.abs(pg[k] - pc[k])
        max_abs = max(max_abs, float(diff.max()))
        moved = float(np.linalg.norm(pc[k] - init[k]))
        if moved > 0:
            upd_rel = max(upd_rel, float(np.linalg.norm(diff)) / moved)
    report = {"losses_cpu": lc, "losses_card": lg, "loss_rel_diff": loss_rel,
              "param_update_rel_diff": upd_rel, "param_max_abs_diff": max_abs,
              "cpu_s": tc, "card_s": tg,
              "within_limits": loss_rel <= 1e-4 and upd_rel <= 1e-2 and
              max_abs <= 2 * lr * steps}
    if check and not report["within_limits"]:
        raise AssertionError(f"train oracle {name}: {report}")
    return report


def phase_train_oracle():
    """2-layer fp32 models at Llama-3-8B's and GPT-2's widths train on the
    card and on the CPU (``train_oracle_case``), seq 256, batch 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    for name, cfg in (
            ("llama_widths", llama3_8b_config(num_layers=2, vocab_size=1024,
                                              dtype="float32")),
            ("gpt2_widths", GPTConfig(num_layers=2, vocab_size=1024,
                                      dtype="float32"))):
        report[name] = train_oracle_case(name, cfg, 2, 256)
    emit({"phase": "train_oracle", "layers": 2, "dtype": "float32",
          "seq": 256, "steps": ORACLE_STEPS, "lr": ORACLE_LR, **report})
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# MLA latent serving and the paged decode op (phases 9-13)
# ---------------------------------------------------------------------------

# fp32 agreement of the latent and the paged decode kernels, |got - want| <=
# tol * (1 + |want|).  The paged decode kernel multiplies in fp32; the
# latent kernel in split TF32 terms (about 21 of fp32's 24 bits a product,
# errors near 1e-6 of the values), for bf16, int8 and nf4 pages alike; and
# the order of up to 4096 fp32 sums differs
PAGED_FP32_TOL = 1e-4
# the engine's token layout: 8 decode slots, then one 512-token chunk slot
LATENT_Q_LENS = [1, 1, 1, 1, 1, 1, 0, 0, 512]
LATENT_CU = [0, 1, 2, 3, 4, 5, 6, 7, 8, 520]


# TF32 products that fp32 q or p takes against latent pages of each kind
# to the reference's accuracy: int8 codes are exact in TF32 (int8's
# scale/127 is folded into the scores and into P in fp32), so only the fp32
# side splits (2); fp32 values and nf4's codebook values are not, so both
# split (3).  bf16 pages are priced by the wgmma route's scheme instead:
# fp32 q and p in two bf16 terms against the exact bf16 values, at the bf16
# rate (LATENT_BF16_TERMS)
LATENT_TERMS = {"bf16": 2, "int8": 2, "nf4": 3, "fp32": 3}
LATENT_BF16_TERMS = 2


def latent_work(q_lens, ctx_lens, ps, nh, d_c, d_r, c_bytes, r_bytes,
                kind):
    """Bytes the function must move (the pages each live row spans, q in,
    out), operations over the causally visible (query, key) pairs, and the
    least time an H100 could take for the arithmetic the reference defines
    (fp32 q and p by bf16 pages and their rope keys in two bf16 terms at
    989 TFLOP/s; by the latent pages of the other kinds in
    ``LATENT_TERMS[kind]`` TF32 products, q by the rope pages as
    ``product_rate``), with the one-term bf16 figure beside it."""
    quantized = kind in ("int8", "nf4")
    per_pos = c_bytes + d_r * r_bytes + (4 if quantized else 0)
    kv_bytes = sum(-(-c // ps) * ps * per_pos
                   for c, q in zip(ctx_lens, q_lens) if q > 0)
    live = sum(q_lens)
    qo_bytes = live * nh * ((d_c + d_r) + d_c) * 4
    pairs = sum(c - q + j + 1 for q, c in zip(q_lens, ctx_lens)
                for j in range(q))
    flops = 2 * nh * (2 * d_c + d_r) * pairs
    t_bytes = (kv_bytes + qo_bytes) / H100_BYTES_PER_S
    # q.c and p.c on the latent pages, q.r on the bf16 rope pages
    r_as = torch.bfloat16 if r_bytes == 2 else torch.float32
    if kind == "bf16":
        t_ops = 2 * nh * pairs * (2 * d_c + d_r) * LATENT_BF16_TERMS / \
            H100_BF16_FLOPS
    else:
        t_ops = 2 * nh * pairs * (
            2 * d_c * LATENT_TERMS[kind] / H100_TF32_FLOPS
            + d_r / product_rate(torch.float32, r_as))
    return {"bytes": kv_bytes + qo_bytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_at_bf16_peak":
                max(t_bytes, flops / H100_BF16_FLOPS) * 1e3}


def latent_case(name, nh, d_c, d_r, hd, ctx_lens, maxp, num_pages, kind,
                time_parts=False, check=True,
                layout=(LATENT_Q_LENS, LATENT_CU)):
    """One latent batch at the engine's layout (``layout``, its ``q_lens``
    and row offsets): kernel against plain version, padding tokens zero,
    times and bound.  ``check=False`` only reads the error over the limit
    (for kernels with planted faults)."""
    ps, max_q = 64, 512
    q_lens, cu = layout[0], np.asarray(layout[1], np.int32)
    t = int(cu[-1])
    rows = len(q_lens)
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((rows, maxp), np.int32)        # trash-page padding
    k = 0
    for i, c in enumerate(ctx_lens):
        need = -(-c // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    q = rnd(t, nh, d_c + d_r)
    lat = rnd(num_pages, ps, 1, d_c)
    quant = None if kind == "bf16" else kind
    r_pages = scale_pages = None
    if quant:
        c_pages, scale_pages = quantize_rows(lat, quant)
    else:
        c_pages = lat.bfloat16()
        if d_r:
            r_pages = rnd(num_pages, ps, 1, d_r).bfloat16()
    kw = dict(max_q=max_q, softmax_scale=(hd + d_r) ** -0.5,
              scale_pages=scale_pages, quant=quant, latent_dim=d_c)

    def run(fn, ql):
        return fn(q, c_pages, r_pages, i32(ql), i32(cu), i32(pt),
                  i32(ctx_lens), **kw)

    fn = latent_ragged_paged_attention_cuda
    before = (fn.launches, fn.wgmma_launches)
    got = run(fn, q_lens)
    torch.cuda.synchronize()
    route = latent_route(quant, c_pages.dtype, d_c, d_r, ps, rows)
    on_wgmma = fn.wgmma_launches - before[1]
    if fn.launches - before[0] != 1 or on_wgmma != (route == "wgmma"):
        raise AssertionError(f"{name}: one launch on the {route} route "
                             f"expected, got {fn.launches - before[0]} "
                             f"({on_wgmma} on wgmma)")
    want = run(latent_ragged_paged_attention_reference, q_lens)
    real = torch.zeros(t, dtype=torch.bool, device=dev)
    for i in range(rows):
        real[int(cu[i]):int(cu[i]) + q_lens[i]] = True
    d = (got - want).abs()
    ratio = (d / (PAGED_FP32_TOL * (1 + want.abs())))[real].max().item()
    err = d[real].max().item()
    pad_nonzero = int(torch.count_nonzero(got[~real]).item())
    if not check:
        return {"max_abs_err": err, "err_over_limit": ratio, "route": route}
    if not ratio <= 1.0 or not torch.isfinite(got).all():
        raise AssertionError(f"latent kernel vs plain, {name}: error over "
                             f"the fp32 limit by {ratio} (max abs {err})")
    if pad_nonzero:
        raise AssertionError(f"{name}: {pad_nonzero} nonzero padding outputs")
    c_bytes = c_pages.shape[-1] * c_pages.element_size()
    work = latent_work(q_lens, ctx_lens, ps, nh, d_c, d_r, c_bytes, 2,
                       kind)
    # the metadata on the card once, so that one call can be captured
    meta = [i32(a) for a in (q_lens, cu, pt, ctx_lens)]
    out = {"route": route, "wgmma_launches": on_wgmma,
           "max_abs_err": err, "err_over_limit": ratio,
           "limit": f"|got - want| <= {PAGED_FP32_TOL} * (1 + |want|)",
           "padding_nonzero": pad_nonzero,
           "ms": cuda_time_ms(lambda: run(latent_ragged_paged_attention_cuda,
                                          q_lens), warmup=2, iters=5),
           "device_ms": graph_ms(lambda: latent_ragged_paged_attention_cuda(
               q, c_pages, r_pages, *meta, **kw), iters=20),
           "plain_ms": cuda_time_ms(lambda: run(
               latent_ragged_paged_attention_reference, q_lens),
               warmup=1, iters=2),
           **work, "library_ms": None,
           "shapes": {"q_lens": q_lens, "ctx_lens": ctx_lens, "nh": nh,
                      "d_c": d_c, "d_r": d_r, "ps": ps, "max_q": max_q,
                      "maxp": maxp, "pages": kind}}
    if time_parts:
        # the same batch split: its decode rows alone, its chunk alone,
        # its verify rows alone (where the layout has them), each also by
        # CUDA-graph replay
        out["parts"] = {}
        for part, keep in (("decode_rows", lambda i: i < 8),
                           ("chunk_row", lambda i: i == 8),
                           ("verify_rows", lambda i: i > 8))[:2 + (rows > 9)]:
            ql = [n if keep(i) else 0 for i, n in enumerate(q_lens)]
            pw = latent_work(ql, ctx_lens, ps, nh, d_c, d_r, c_bytes, 2,
                             kind)
            pmeta = [i32(a) for a in (ql, cu, pt, ctx_lens)]
            out["parts"][part] = {
                "ms": cuda_time_ms(lambda: run(
                    latent_ragged_paged_attention_cuda, ql),
                    warmup=2, iters=5),
                "device_ms": graph_ms(
                    lambda: latent_ragged_paged_attention_cuda(
                        q, c_pages, r_pages, *pmeta, **kw), iters=20),
                "bound_ms": pw["bound_ms"], "bound_by": pw["bound_by"]}
    return out


# name -> (nh, d_c, d_r, head_dim, ctx_lens, maxp, num_pages, page kind)
LATENT_CASES = {"llama3_8b_mla/bf16": (
    32, 512, 64, 128, [4096, 3001, 1500, 65, 64, 1, 0, 0, 3000], 128, 1024,
    "bf16")}
LATENT_CASES.update({f"gpt2_mla/{kind}": (
    12, 256, 0, 64, [1024, 1000, 700, 65, 64, 1, 0, 0, 900], 16, 128, kind)
    for kind in ("bf16", "int8", "nf4")})


def phase_latent_kernel():
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    for name, shape in LATENT_CASES.items():
        cases[name] = latent_case(name, *shape,
                                  time_parts=name.startswith("llama"))
        torch.cuda.empty_cache()
    smem, blocks = latent_wgmma_info(512, 64, len(LATENT_Q_LENS))
    emit({"phase": "latent_kernel_vs_plain",
          "kernel": {"latent_ragged_paged_attention": cases},
          "wgmma_route": {"smem_bytes": smem, "blocks_per_sm": blocks,
                          "sms": sm_count(torch.device("cuda"))}})
    return {**cases["llama3_8b_mla/bf16"], "wgmma_smem_bytes": smem,
            "wgmma_blocks_per_sm": blocks}


def paged_work(seq_lens, nh, kvh, hd, dtype):
    """Bytes (K and V of every cached token once, q in, out) and
    operations of a paged decode batch, and the least time for them: q.k
    in q's and k's type, p.v with fp32 p."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    tokens = sum(seq_lens)
    nbytes = 2 * tokens * kvh * hd * itemsize \
        + 2 * len(seq_lens) * nh * hd * itemsize
    flops = 4 * nh * hd * tokens
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2 * nh * hd * tokens * (1 / product_rate(dtype, dtype)
                                    + 1 / product_rate(torch.float32, dtype))
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def paged_inputs(batch, dtype, seed):
    """A decode batch at Llama-3-8B's shapes: contexts 1 to 4096, one
    empty request, a partial last page, trash-page table slots."""
    nh, kvh, hd, ps, maxp = 32, 8, 128, 64, 64
    rng = np.random.RandomState(seed)
    seq_lens = rng.randint(1, 4097, size=batch)
    seq_lens[:5] = [4096, 1, 0, 4001, 65]
    num_pages = 1 + int(sum(-(-c // ps) for c in seq_lens))
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((batch, maxp), np.int32)
    k = 0
    for i, c in enumerate(seq_lens):
        need = -(-int(c) // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    args = (rnd(batch, nh, hd), rnd(num_pages, ps, kvh, hd),
            rnd(num_pages, ps, kvh, hd), torch.from_numpy(pt).cuda(),
            torch.from_numpy(seq_lens.astype(np.int32)).cuda())
    return args, [int(c) for c in seq_lens], (nh, kvh, hd)


def paged_agreement(got, want, seq_lens, dtype):
    """Largest |got - want| over its limit over the live requests (fp32:
    PAGED_FP32_TOL * (1 + |want|); bf16: the per-row bf16 limit, BF16_REL *
    |want| + BF16_RMS_FLOOR * the request's output RMS), the max abs
    error, and the number of nonzero outputs of empty requests."""
    live = torch.tensor([c > 0 for c in seq_lens], device=got.device)
    g, w = got[live].float(), want[live].float()
    d = (g - w).abs()
    if dtype == torch.bfloat16:
        limit = BF16_REL * w.abs() + BF16_RMS_FLOOR * \
            w.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()
    else:
        limit = PAGED_FP32_TOL * (1 + w.abs())
    return ((d / limit.clamp_min(1e-30)).max().item(), d.max().item(),
            int(torch.count_nonzero(got[~live]).item()))


# (seq_lens, nh, kvh, head dim) of phase 10's small batches: head dims the
# decode core reads in place, 100 with rows off the 16-byte boundaries, 264
# and 512 past 256; seq_len 0, partial pages, and the longer batches split
# over the KV axis
PAGED_SMALL_CASES = [([13, 5, 0, 24], 8, 2, 80),
                     ([300, 64, 0, 1000, 513], 8, 2, 96),
                     ([19, 8, 1], 4, 2, 100),
                     ([9, 17, 0, 1], 4, 4, 256),
                     ([300, 64, 0, 1000, 513], 8, 8, 256),
                     ([9, 17, 0, 1], 4, 4, 264),
                     ([300, 64, 0, 1000, 513], 8, 2, 512)]


def paged_small_head_dims():
    """The paged decode kernel on ``PAGED_SMALL_CASES`` in bf16 and fp32
    against its plain version (page size 16)."""
    out = []
    ps = 16
    for seq_lens, nh, kvh, hd in PAGED_SMALL_CASES:
        rng = np.random.RandomState(hd)
        maxp = -(-max(seq_lens) // ps)
        num_pages = 1 + sum(-(-c // ps) for c in seq_lens)
        perm = rng.permutation(np.arange(1, num_pages))
        pt = np.zeros((len(seq_lens), maxp), np.int32)
        k = 0
        for i, c in enumerate(seq_lens):
            need = -(-c // ps)
            pt[i, :need] = perm[k:k + need]
            k += need
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape):
                return torch.from_numpy(rng.randn(*shape).astype(
                    np.float32)).to(device="cuda", dtype=dtype)
            args = (rnd(len(seq_lens), nh, hd), rnd(num_pages, ps, kvh, hd),
                    rnd(num_pages, ps, kvh, hd), torch.from_numpy(pt).cuda(),
                    torch.tensor(seq_lens, dtype=torch.int32, device="cuda"))
            got = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            want = paged_attention_reference(*args)
            ratio, err, empty = paged_agreement(got, want, seq_lens, dtype)
            row = {"seq_lens": seq_lens, "nh": nh, "kvh": kvh, "hd": hd,
                   "dtype": str(dtype), "err_over_limit": ratio,
                   "max_abs_err": err, "empty_request_nonzero": empty}
            if not ratio <= 1.0 or empty or not torch.isfinite(got).all():
                raise AssertionError(f"paged decode kernel vs plain: {row}")
            out.append(row)
    return out


def phase_paged_decode():
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    for batch in (8, 64):
        for name, dtype in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32)):
            args, seq_lens, (nh, kvh, hd) = paged_inputs(batch, dtype,
                                                         seed=batch)
            got = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            want = paged_attention_reference(*args)
            ratio, err, empty = paged_agreement(got, want, seq_lens, dtype)
            if not ratio <= 1.0 or empty or not torch.isfinite(got).all():
                raise AssertionError(
                    f"paged decode kernel vs plain, batch {batch} {name}: "
                    f"over the limit by {ratio} (max abs {err}), {empty} "
                    f"nonzero outputs of the empty request")
            cases[f"batch{batch}/{name}"] = {
                "n_splits": core_splits(sm_count(args[0].device), batch, kvh,
                                        nh // kvh,
                                        args[3].shape[1] * args[1].shape[1]),
                "max_abs_err": err, "err_over_limit": ratio,
                "empty_request_nonzero": empty,
                "ms": cuda_time_ms(lambda: paged_attention_cuda(*args),
                                   warmup=3, iters=20),
                "device_ms": graph_ms(lambda: paged_attention_cuda(*args),
                                      iters=20),
                "plain_ms": cuda_time_ms(
                    lambda: paged_attention_reference(*args),
                    warmup=1, iters=3),
                **paged_work(seq_lens, nh, kvh, hd, args[0].dtype),
                "library_ms": None, "seq_lens_max": max(seq_lens),
                "tokens": sum(seq_lens)}
            del args, got, want
            torch.cuda.empty_cache()
    small = paged_small_head_dims()
    # the op's own entry point, as a decoder would call it: 8 steps of a
    # 32-layer model at batch 8, every request one token longer each step
    (q, kp, vp, pt, sl), seq_lens, (nh, kvh, hd) = paged_inputs(
        8, torch.bfloat16, seed=1)
    sl = torch.clamp(sl, max=4000)             # room to grow within 4096
    paged_attention_cuda.launches = 0
    steps, layers = 8, 32
    for _ in range(steps):
        sl = sl + 1
        for _ in range(layers):
            out = port_ops.paged_attention_decode(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    launches = paged_attention_cuda.launches
    want = paged_attention_reference(q, kp, vp, pt, sl)
    ratio, err, _ = paged_agreement(out, want, sl.tolist(), torch.bfloat16)
    if launches != steps * layers or tuple(out.shape) != (8, nh, hd) or \
            out.dtype != torch.bfloat16 or not ratio <= 1.0 or \
            not torch.isfinite(out).all():
        raise AssertionError(
            f"paged_attention_decode entry point: {launches} launches for "
            f"{steps} x {layers} calls, shape {tuple(out.shape)}, error "
            f"over the limit by {ratio}")
    emit({"phase": "paged_decode_vs_plain",
          "limit": {"bf16": f"|got - want| <= {BF16_REL} * |want| + "
                            f"{BF16_RMS_FLOOR} * rms(want over the request)",
                    "fp32": f"|got - want| <= {PAGED_FP32_TOL} * (1 + |want|)"},
          "kernel": {"paged_attention_decode": cases},
          "small_head_dims": small,
          "entry_point": {"steps": steps, "layers": layers, "batch": 8,
                          "launches": launches, "err_over_limit": ratio}})
    return cases["batch8/bf16"], launches


def phase_mla_quant():
    """GPT-2 small's widths in the MLA layout with quantized latent pages:
    the phase-4 traffic scaled to the 1024-token position table."""
    cfg = mla_config(GPTConfig(dtype="bfloat16"), kv_latent_dim=256)
    state = random_state(cfg, seed=0, device="cuda")
    v = cfg.vocab_size
    report = {}
    for quant in ("int8", "nf4"):
        runs = []
        for _ in range(2):
            eng = Engine(state, cfg, num_pages=256, page_size=64,
                         max_batch=8, chunk_size=512, prefill_rows=1,
                         device="cuda", page_quant=quant)
            rng = np.random.RandomState(0)
            mix = make_mix(rng, v, [32, 900, 300, 500, 64, 700, 400],
                           header_len=256, tail=100)
            latent_ragged_paged_attention_cuda.launches = 0
            latent_ragged_paged_attention_cuda.wgmma_launches = 0
            ragged_paged_attention_cuda.launches = 0
            t0 = time.perf_counter()
            reqs = serve_mix(eng, *mix)
            wall = time.perf_counter() - t0
            launches = latent_ragged_paged_attention_cuda.launches
            calls = eng.executable_calls
            toks = [r.out_tokens for r in reqs]
            if not all(r.state == "finished" and len(r.out_tokens) == 32
                       for r in reqs):
                raise AssertionError(f"{quant}: not every request finished "
                                     f"with 32 tokens")
            if not all(0 <= t < v for ts in toks for t in ts):
                raise AssertionError(f"{quant}: token id outside the "
                                     f"vocabulary")
            if launches != cfg.num_layers * calls or \
                    ragged_paged_attention_cuda.launches or \
                    latent_ragged_paged_attention_cuda.wgmma_launches:
                raise AssertionError(
                    f"{quant}: latent launches {launches} != "
                    f"{cfg.num_layers} x {calls} unified steps, or some on "
                    f"the wgmma route (quantized pages take mma.sync)")
            check_compile_count(eng, eng.compile_count, quant)
            runs.append(toks)
            summary = eng.metrics_summary()
            ttfts = sorted(r.first_token_time - r.submit_time for r in reqs)
        if runs[0] != runs[1]:
            raise AssertionError(f"{quant}: two fresh engines disagree")
        report[quant] = {
            "requests": len(reqs), "generated_tokens": 32 * len(reqs),
            "unified_steps": calls, "kernel_launches": launches,
            "launches_per_step": launches / calls,
            "kv_bytes_per_token": eng.pool.kv_bytes_per_token,
            "page_dtype": str(eng.pool.k_pages[0].dtype),
            "prefix_cache_hits": summary["prefix_cache_hits"],
            "compile_count": summary["compile_count"],
            "wall_s": wall, "tokens_per_s": 32 * len(reqs) / wall,
            "ttft_p50_s": float(np.percentile(ttfts, 50)),
            "two_engines_equal": True}
        del eng
    emit({"phase": "mla_quant_path",
          "model": "GPT-2 small widths, kv_latent_dim 256, random bf16 "
                   "weights (seed 0)", **report})
    del state
    torch.cuda.empty_cache()
    return report


def phase_mla_oracle():
    # full fp32 products on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    llama = mla_config(llama3_8b_config(num_layers=2, dtype="float32"),
                       kv_latent_dim=512, kv_rope_dim=64)
    gpt2 = GPTConfig(num_layers=2, dtype="float32")
    # the GPT-2 widths go through the converter from a full-head state
    gpt2_state, gpt2_mla = mla_state_from(
        random_state(gpt2, seed=1, device="cuda"), gpt2, kv_latent_dim=256)
    for name, cfg, state, lens in (
            ("llama3_8b_widths", llama,
             random_state(llama, seed=1, device="cuda"), (300, 17, 129)),
            ("gpt2_widths_converted", gpt2_mla, gpt2_state, (300, 17, 129))):
        rng = np.random.RandomState(1)
        prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
                   for n in lens]
        latent_ragged_paged_attention_cuda.launches = 0
        latent_ragged_paged_attention_cuda.wgmma_launches = 0
        kw = dict(num_pages=64, page_size=64, max_batch=4, chunk_size=128)
        eng = Engine(state, cfg, device="cuda", **kw)
        reqs = [eng.add_request(p, 8) for p in prompts]
        eng.run()
        want = [generate(state, cfg, [p], 8, device="cuda")[0, len(p):]
                .tolist() for p in prompts]
        got = [r.out_tokens for r in reqs]
        if got != want:
            raise AssertionError(f"{name}: engine {got} != generate {want}")
        if latent_ragged_paged_attention_cuda.launches != \
                cfg.num_layers * eng.executable_calls or \
                latent_ragged_paged_attention_cuda.wgmma_launches:
            raise AssertionError(f"{name}: the latent kernel did not run "
                                 f"once per layer and step on the mma.sync "
                                 f"route (fp32 pages)")
        check_compile_count(eng, eng.compile_count, name)
        eager = eager_tokens(state, cfg, prompts, 8, **kw)
        if eager != got:
            raise AssertionError(f"{name}: captured engine {got} != eager "
                                 f"engine {eager}")
        report[name] = {"equal": True, "captured_equals_eager": True,
                        "compile_count": eng.compile_count, "tokens": got,
                        "d_c": cfg.kv_latent_dim, "d_r": cfg.rope_dim}
        del eng, state
        torch.cuda.empty_cache()
    emit({"phase": "mla_oracle", "layers": 2, "dtype": "float32",
          "requests": 3, **report})


def graft_config(dtype):
    """The LLaMA configuration of ``__graft_entry__.entry()``: vocab 1024,
    hidden 256, 4 layers, 8 heads (head dim 32), seq 128."""
    return llama_config(vocab_size=1024, hidden_size=256, num_layers=4,
                        num_heads=8, max_seq_len=128, sp=False, dtype=dtype)


def phase_graft_entry():
    """Phase 14: the graft entry's LLaMA trains on the card against the CPU
    (``train_oracle_case``, batch 4, seq 128, fp32: 3xTF32 flash forward
    and, by the byte rule, the fused backward, at head dim 32), then serves
    in bf16 through ``Engine`` (the ragged kernel at head dim 32) with
    temperature-0 tokens equal to ``generate``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = graft_config("float32")
    wrappers = flash_wrappers()
    for fn in wrappers.values():
        fn.launches = fn.tensor_core_launches = fn.tf32_launches = 0
    train = train_oracle_case("graft_entry", cfg, 4, 128)
    launches = {n: fn.launches for n, fn in wrappers.items()}
    tf32 = {n: fn.tf32_launches for n, fn in wrappers.items()}
    each = cfg.num_layers * ORACLE_MICRO * ORACLE_STEPS
    fused = fa._use_fused(128, cfg.head_dim, torch.float32)
    want = {"flash_fwd": each, "flash_bwd_fused": each if fused else 0,
            "flash_bwd_dq": 0 if fused else each,
            "flash_bwd_dkv": 0 if fused else each}
    if launches != want or tf32 != want:
        raise AssertionError(f"graft entry: flash launches {launches} "
                             f"(3xTF32 {tf32}) != {want}")

    cfg16 = graft_config("bfloat16")
    state = random_state(cfg16, seed=0, device="cuda")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg16.vocab_size, size=n).tolist()
               for n in (100, 17, 64)]
    ragged_paged_attention_cuda.launches = 0
    eng = Engine(state, cfg16, num_pages=64, page_size=16, max_batch=4,
                 chunk_size=64, device="cuda")
    reqs = [eng.add_request(p, 8) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    serve_launches = ragged_paged_attention_cuda.launches
    want_tokens = [generate(state, cfg16, [p], 8, device="cuda")[0, len(p):]
                   .tolist() for p in prompts]
    got = [r.out_tokens for r in reqs]
    if got != want_tokens:
        raise AssertionError(f"graft entry bf16: engine {got} != generate "
                             f"{want_tokens}")
    if serve_launches != cfg16.num_layers * eng.executable_calls:
        raise AssertionError(f"graft entry bf16: {serve_launches} ragged "
                             f"launches for {eng.executable_calls} steps")
    check_compile_count(eng, eng.compile_count, "graft entry bf16")
    emit({"phase": "graft_entry", "head_dim": cfg.head_dim,
          "train": {"dtype": "float32", "batch": 4, "seq": 128,
                    "steps": ORACLE_STEPS, "flash_launches": launches,
                    "tf32_launches": tf32, **train},
          "serve": {"dtype": "bfloat16", "requests": len(prompts),
                    "equal": True, "tokens": got,
                    "compile_count": eng.compile_count,
                    "ragged_launches": serve_launches}})
    del eng, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the training entry point and its recipe (phases 15 and 16)
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
# examples/train_gpt_torch.py at its defaults (GPT-2 small's widths: vocab
# 50304, hidden 768, 12 layers, 12 heads, seq 1024) in bf16, global batch 8
ENTRY_ARGS = ["--bf16", "--global-batch", "8"]
ENTRY_STEPS = 20
ENTRY_LAYERS = 12            # the entry point's default depth
# the token file the phase writes: seed 0, uniform over 64 ids of the
# vocabulary.  The entry point's default stream is uniform over all 50304
# ids, which no model predicts better than uniformly (a loss of ln 50304
# = 10.83, where bf16 losses are 2**-4 apart), and a model on random
# weights starts close to that, so a falling loss needs a learnable
# stream
ENTRY_VOCAB_USED = 64


def entry_tokens(path):
    """64 batches of 8 x 1024 tokens, from seed 0, over ENTRY_VOCAB_USED
    ids of GPT-2 small's vocabulary."""
    rng = np.random.RandomState(0)
    ids = rng.choice(50304, ENTRY_VOCAB_USED, replace=False)
    np.save(path, ids[rng.randint(0, ENTRY_VOCAB_USED, 8 * 1024 * 64)]
            .astype(np.int32))


def load_entry():
    """``examples/train_gpt_torch.py`` as a module (its ``main``)."""
    spec = importlib.util.spec_from_file_location(
        "train_gpt_torch", os.path.join(ROOT, "examples",
                                        "train_gpt_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reset_flash_counts():
    for fn in flash_wrappers().values():
        for name in fa._COUNTS:
            setattr(fn, name, 0)


def flash_counts():
    """Each flash wrapper's launches since ``reset_flash_counts``, also by
    route, and the causal ones among them."""
    return {n: {"launches": fn.launches,
                "by_route": {"wgmma": fn.wgmma_launches,
                             "3xtf32": fn.tf32_launches,
                             "mma.sync": fn.tensor_core_launches -
                             fn.wgmma_launches - fn.tf32_launches},
                "causal": fn.causal_launches}
            for n, fn in flash_wrappers().items()}


def phase_train_entry():
    """Phase 15: ``main`` of ``examples/train_gpt_torch.py`` trains
    ``ENTRY_STEPS`` steps on the native loader, saves, and resumes; the
    resumed run's first loss must equal the saved weights' loss on that
    batch (1e-3) and differ from a fresh model's."""
    from hetu_tpu_torch.csrc.build import load_dataloader_core
    t0 = time.perf_counter()
    if load_dataloader_core() is None:
        raise AssertionError("the dataloader core did not build")
    core_s = time.perf_counter() - t0
    entry = load_entry()
    tmp = tempfile.mkdtemp(prefix="train_entry_")
    path = os.path.join(tmp, "gpt2_small.safetensors")
    data = os.path.join(tmp, "tokens.npy")
    entry_tokens(data)
    args = ENTRY_ARGS + ["--data", data]
    try:
        reset_flash_counts()
        run = entry.main(args + ["--steps", str(ENTRY_STEPS),
                                 "--save", path])
        launches = flash_counts()
        resumed = entry.main(args + ["--steps", "2", "--load", path])
        fresh = entry.main(args + ["--steps", "2"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = run["losses"]
    if run["loader"] != "native" or not np.isfinite(losses).all() or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train_entry: loader {run['loader']}, "
                             f"losses {losses} not finite and falling")
    # every layer's attention once a step, plus the forward that reads the
    # saved weights' loss; on the wgmma route in bf16 at head dim 64
    per = ENTRY_LAYERS * ENTRY_STEPS
    want = {"flash_fwd": per + ENTRY_LAYERS, "flash_bwd_fused": per,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    got = {n: c["launches"] for n, c in launches.items()}
    on_wgmma = {n: c["by_route"]["wgmma"] for n, c in launches.items()}
    if got != want or on_wgmma != want:
        raise AssertionError(f"train_entry: flash launches {launches}, "
                             f"want {want} on wgmma")
    r0, f0, saved = resumed["losses"][0], fresh["losses"][0], \
        run["saved_first_batch_loss"]
    if not abs(r0 - saved) <= 1e-3 or not abs(r0 - f0) > 1e-3:
        raise AssertionError(f"train_entry: resumed first loss {r0}, saved "
                             f"weights' {saved}, fresh model's {f0}")
    out = {"config": run["config"], "steps": ENTRY_STEPS,
           "loader": run["loader"], "loader_core_build_s": core_s,
           "ms_per_step": run["ms_per_step"],
           "tokens_per_s": run["tokens_per_s"],
           "timed_steps": run["timed_steps"],
           "first_loss": losses[0], "last_loss": losses[-1],
           "peak_memory_bytes": run["peak_memory_bytes"],
           "compile_count": run["compile_count"],
           "flash_launches": launches,
           "saved_first_batch_loss": saved, "resumed_first_loss": r0,
           "fresh_first_loss": f0,
           "data": f"seed 0, uniform over {ENTRY_VOCAB_USED} ids"}
    emit({"phase": "train_entry", **out})
    gc.collect()
    torch.cuda.empty_cache()
    return out


class GradCatcher(ht.optim.Optimizer):
    """An update that changes nothing and keeps the gradients of its eager
    run (a step's first call; the capture after it keeps nothing)."""

    def __init__(self):
        super().__init__(lr=0.0)
        self.grads = None

    def _apply_updates(self, graph, xs, grads, keep=None, check=None):
        if not (torch.cuda.is_available() and
                torch.cuda.is_current_stream_capturing()):
            self.grads = [g.detach().clone() for g in grads]


def grad_agreement(got, want):
    """The largest |got - want| over the bf16 row limit (``BF16_REL`` of
    the value plus ``BF16_RMS_FLOOR`` of the row's RMS, rows along the
    last dim) across every gradient; at most 1 passes."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        b2 = b.reshape(-1, b.shape[-1]) if b.ndim else b.reshape(1, 1)
        a2 = a.reshape(b2.shape)
        rms = b2.pow(2).mean(-1, keepdim=True).sqrt()
        lim = BF16_REL * b2.abs() + BF16_RMS_FLOOR * rms
        ratio = (a2 - b2).abs() / lim.clamp_min(1e-30)
        worst = max(worst, float(ratio.max()))
    return worst


def step_ms(run):
    """Mean host time of 3 more calls of ``run`` (the step's first calls
    done), the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / 3


def step_memory(run):
    """``run()``'s peak device memory: (peak bytes, peak above what was
    allocated before it)."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - base, out


# phase 16's model and batch: GPT-2 small's widths in bf16, one seeded
# batch of the entry point's global batch and sequence
RECIPE_BATCH, RECIPE_SEQ = 8, 1024
RECIPE_STEPS = 6
RECIPE_SGD_LR = 0.01
RECIPE_ADAFACTOR_LR = 1e-2
# The fused cross entropy's own gate: its loss, dx and dw on the step's
# hidden states and head against an fp32 cross entropy of the fp32
# product.  Its chunk products are exact products of bf16 values summed
# in fp32, so its loss differs from the reference by the order of fp32
# sums; dx and dw end in bf16 (about 2**-9 of each value, 1.7e-3 of the
# norm).  Rounding the chunk logits to bf16 instead errs by up to 2**-9
# of each logit: at random weights' logits (below 1) that is lost in dx
# and dw's own rounding and, in the mean over 8192 tokens, in errors of
# either sign, so the loss is also held in groups of 64 tokens, each the
# op's sum over the group, where that error stands 10-100 times above
# the limit.
FUSED_CE_GROUP = 64
FUSED_CE_LOSS_REL = 2e-6
FUSED_CE_GRAD_REL = 4e-3


def recipe_trainer(cfg, make_opts, init=None):
    """A GPT graph with one update op per optimizer of ``make_opts()``
    over the same loss; ``init`` (a state dict) is loaded."""
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as g:
        ids = ht.parallel_placeholder("int32", (RECIPE_BATCH, RECIPE_SEQ),
                                      name="input_ids")
        labels = ht.parallel_placeholder("int32", (RECIPE_BATCH, RECIPE_SEQ),
                                         name="labels")
        model = GPTLMHeadModel(cfg)
        loss = model(ids, labels)
        opts = make_opts()
        ops_ = [o[0].minimize(loss, grad_scaler=o[1]) for o in opts]
    if init is not None:
        load_state(model, init)
    return g, ids, labels, model, loss, [o[0] for o in opts], ops_


def grad_rel_errors(got, want):
    """Per tensor, ||got - want|| / ||want|| (Frobenius, fp32)."""
    return [float((a.float() - b.float()).norm() /
                  b.float().norm().clamp_min(1e-30))
            for a, b in zip(got, want)]


def recipe_variants(cfg, x, y):
    """One graph with four update ops over one loss: a gradient catcher
    (the plain step, recompute under both policies, offload), Adam with a
    GradScaler, SGD with momentum, Adafactor."""
    scaler = ht.GradScaler(init_scale=1024.0, growth_interval=1000)
    g, ids, labels, model, loss, opts, ops_ = recipe_trainer(
        cfg, lambda: [
            (GradCatcher(), None),
            (ht.optim.AdamOptimizer(lr=1e-4), scaler),
            (ht.optim.SGDOptimizer(lr=RECIPE_SGD_LR, momentum=0.9), None),
            (ht.optim.AdafactorOptimizer(lr=RECIPE_ADAFACTOR_LR), None)])
    feeds = {ids: x, labels: y}
    with ht.graph(g):
        logits_t = model.logits(ids)
    catcher = opts[0]
    init = {n: v.detach().clone() for n, v in model.state_dict().items()}
    variants = {}
    for name, ctx in (
            ("plain", contextlib.nullcontext),
            ("recompute_nothing_saveable", lambda: ht.recompute(graph=g)),
            ("recompute_dots_saveable",
             lambda: ht.recompute("dots_saveable", graph=g)),
            ("cpu_offload", lambda: ht.cpu_offload(graph=g))):
        reset_flash_counts()

        def two_steps():
            with ctx():
                return [float(g.run(loss, [loss, ops_[0]], feeds)[0])
                        for _ in range(2)]
        peak, above, ls = step_memory(two_steps)
        launches = flash_counts()
        with ctx():
            ms = step_ms(lambda: g.run(loss, [loss, ops_[0]], feeds))
        variants[name] = {"losses": ls, "peak_memory_bytes": peak,
                          "step_peak_above_resting_bytes": above,
                          "step_ms": ms, "captured": g.last_run_captured,
                          "flash_launches": launches,
                          "grads": catcher.grads}
    plain = variants["plain"]
    for name, v in variants.items():
        v["grad_err_over_limit"] = grad_agreement(v["grads"], plain["grads"])
        v["loss_rel_diff"] = abs(v["losses"][0] - plain["losses"][0]) / \
            abs(plain["losses"][0])
        note("train_recipe", name, {k: z for k, z in v.items()
                                    if k != "grads"})
        if name != "plain":
            del v["grads"]
    # recompute: the plain step's gradients, every attention forward run
    # twice, less memory; offload: the plain step's loss and gradients
    for name in ("recompute_nothing_saveable", "recompute_dots_saveable",
                 "cpu_offload"):
        v = variants[name]
        fwd = v["flash_launches"]["flash_fwd"]["launches"]
        want_fwd = plain["flash_launches"]["flash_fwd"]["launches"] * (
            1 if name == "cpu_offload" else 2)
        bad = [v["grad_err_over_limit"] > 1.0, v["loss_rel_diff"] > 1e-3,
               fwd != want_fwd, v["losses"][1] != v["losses"][0],
               name != "cpu_offload" and not v["captured"],
               name == "cpu_offload" and v["captured"],
               name != "cpu_offload" and
               not v["step_peak_above_resting_bytes"] <
               plain["step_peak_above_resting_bytes"]]
        if any(bad):
            raise AssertionError(
                f"train_recipe {name}: {bad} "
                f"{ {k: z for k, z in v.items() if k != 'grads'} }")
    if plain["flash_launches"]["flash_fwd"]["launches"] != \
            2 * cfg.num_layers:
        raise AssertionError(f"train_recipe: plain flash launches "
                             f"{plain['flash_launches']}")
    # the plain step's loss is a bf16 number (its logits, log-softmax and
    # mean are bf16: 2**-4 apart near 11); the same logits' cross entropy
    # in fp32 is the fused loss's reference
    (lg,) = g.run([logits_t], feed_dict=feeds)
    plain_fp32_loss = float(torch.nn.functional.cross_entropy(
        lg.float().reshape(-1, lg.shape[-1]),
        torch.as_tensor(y, device=lg.device).long().reshape(-1)))
    del lg

    # -- GradScaler: an overflow inside a captured replay ----------------
    # A scale overflows only gradients above 1 (bf16 keeps fp32's range,
    # and a scale tops out at 3.4e38; a scale of 3e38 overflows the scaled
    # loss, not gradients below 1), so the overflow is forced in the
    # forward: one embedding
    # element of a token in the batch is set to infinity, written in place
    # into the tensor the captured step reads, and the loss and every
    # gradient turn non-finite.  Restoring it makes the next step finite.
    st = scaler.init_state("cuda")
    adam = opts[1]
    scaler_losses = [float(g.run(loss, [loss, ops_[1]], feeds)[0])
                     for _ in range(2)]          # capture, then a replay
    wte = model.transformer.wte.weight.get_data()
    tok = int(x[0, 0])
    orig = wte[tok, 0].clone()
    with torch.no_grad():
        wte[tok, 0] = float("inf")
    before = ({n: v.clone() for n, v in model.state_dict().items()},
              {k: {t: v.clone() for t, v in adam._state[k].items()}
               for k in ("m", "v")}, adam._state["step"].clone())
    scale_before = float(st["scale"])
    overflow_loss = float(g.run(loss, [loss, ops_[1]], feeds)[0])
    unchanged = all(torch.equal(v, before[0][n])
                    for n, v in model.state_dict().items()) and all(
        torch.equal(adam._state[k][t], v) for k in ("m", "v")
        for t, v in before[1][k].items()) and \
        torch.equal(adam._state["step"], before[2])
    scale_after = float(st["scale"])
    with torch.no_grad():
        wte[tok, 0] = orig
    finite_loss = float(g.run(loss, [loss, ops_[1]], feeds)[0])
    updated = not any(torch.equal(v, before[0][n])
                      for n, v in model.state_dict().items()
                      if n.endswith("lm_head.weight"))
    step_after = float(adam._state["step"])
    del before
    scaler_out = {"losses": scaler_losses, "overflow_loss": overflow_loss,
                  "skip_left_state_bitwise_unchanged": unchanged,
                  "scale_before": scale_before,
                  "scale_after_overflow": scale_after,
                  "next_loss": finite_loss, "next_step_updated": updated,
                  "adam_step_after": step_after,
                  "captured": g.last_run_captured}
    note("train_recipe", "grad_scaler", scaler_out)
    if not (unchanged and scale_after == scale_before / 2 and updated and
            step_after == 3.0 and np.isfinite(scaler_losses).all() and
            not np.isfinite(overflow_loss) and np.isfinite(finite_loss) and
            g.last_run_captured):
        raise AssertionError(f"train_recipe GradScaler: {scaler_out}")

    # -- SGD (momentum 0.9) and Adafactor from the initial weights:
    # RECIPE_STEPS steps each, the loss falling --------------------------
    others = {}
    for name, op in (("sgd", ops_[2]), ("adafactor", ops_[3])):
        load_state(model, init)
        ls = [float(g.run(loss, [loss, op], feeds)[0])
              for _ in range(RECIPE_STEPS)]
        others[name] = ls
        note("train_recipe", name, ls)
        if not np.isfinite(ls).all() or not ls[-1] < ls[0]:
            raise AssertionError(f"train_recipe {name}: losses {ls}")
    return init, variants, plain_fp32_loss, scaler_out, others


def recipe_grads(cfg, x, y, init, **overrides):
    """Loss and gradients of ``cfg`` (with ``overrides``) from ``init``:
    two calls of a catcher step (a capture and a replay), and the step's
    hidden states (the final norm's output) and LM head."""
    c = GPTConfig(**{**cfg.__dict__, **overrides})
    g, ids, labels, model, loss, opts, ops_ = recipe_trainer(
        c, lambda: [(GradCatcher(), None)], init=init)
    feeds = {ids: x, labels: y}
    with ht.graph(g):
        hidden_t = model.transformer(ids)
    reset_flash_counts()

    def two_steps():
        return [float(g.run(loss, [loss, ops_[0]], feeds)[0])
                for _ in range(2)]
    peak, above, ls = step_memory(two_steps)
    launches = flash_counts()
    ms = step_ms(lambda: g.run(loss, [loss, ops_[0]], feeds))
    captured = g.last_run_captured
    (hidden,) = g.run([hidden_t], feed_dict=feeds)
    head = model.lm_head if model.lm_head is not None else \
        model.transformer.wte
    return {"losses": ls, "peak_memory_bytes": peak,
            "step_peak_above_resting_bytes": above, "step_ms": ms,
            "captured": captured, "flash_launches": launches,
            "grads": opts[0].grads,
            "hidden": hidden.reshape(-1, hidden.shape[-1]),
            "head": head.weight.get_data().detach().clone()}


def fused_ce_op_readings(x, w, y):
    """The fused cross entropy's relative errors on ``x`` [n, h] and
    ``w`` [vocab, h] (bf16) against an fp32 ``F.cross_entropy`` of
    ``x.float() @ w.float().T``: the loss, the worst ``FUSED_CE_GROUP``
    token group's loss (the op's sum over the group), dx and dw
    (Frobenius).  Also for a planted fault, the chunk products' logits
    rounded to bf16 (a bf16 ``torch.mm``), which the gate must refuse."""
    from unittest import mock
    from hetu_tpu_torch.ops import fused_ce
    y = torch.as_tensor(y, device=x.device).long().reshape(-1)
    xf = x.float().requires_grad_(True)
    wf = w.float().requires_grad_(True)
    per_token = torch.nn.functional.cross_entropy(xf @ wf.t(), y,
                                                  reduction="none")
    per_token.mean().backward()
    ref_loss = per_token.mean().detach()
    ref_groups = per_token.detach().reshape(-1, FUSED_CE_GROUP).sum(1)
    ref_dx, ref_dw = xf.grad, wf.grad
    del xf, wf, per_token

    def readings():
        xb = x.detach().clone().requires_grad_(True)
        wb = w.detach().clone().requires_grad_(True)
        loss = fused_ce.fused_linear_cross_entropy(xb, wb, y)
        loss.backward()
        with torch.no_grad():
            groups = torch.stack([
                fused_ce.fused_linear_cross_entropy(a, w, b, reduction="sum")
                for a, b in zip(x.reshape(-1, FUSED_CE_GROUP, x.shape[-1]),
                                y.reshape(-1, FUSED_CE_GROUP))])
        dx_err, dw_err = grad_rel_errors([xb.grad, wb.grad], [ref_dx, ref_dw])
        return {"loss_rel_err": float((loss.detach() - ref_loss).abs() /
                                      ref_loss),
                "group_loss_max_rel_err": float(
                    ((groups - ref_groups).abs() / ref_groups.abs()).max()),
                "dx_rel_err": dx_err, "dw_rel_err": dw_err}

    def within(r):
        return r["loss_rel_err"] <= FUSED_CE_LOSS_REL and \
            r["group_loss_max_rel_err"] <= FUSED_CE_LOSS_REL and \
            r["dx_rel_err"] <= FUSED_CE_GRAD_REL and \
            r["dw_rel_err"] <= FUSED_CE_GRAD_REL

    out = {"op": readings()}
    with mock.patch.object(fused_ce, "_mm32",
                           lambda a, b: torch.mm(a, b).float()):
        out["planted_bf16_logits"] = readings()
    out["limits"] = {"loss_rel": FUSED_CE_LOSS_REL,
                     "group": FUSED_CE_GROUP, "grad_rel": FUSED_CE_GRAD_REL}
    out["op_within"] = within(out["op"])
    out["planted_refused"] = not within(out["planted_bf16_logits"])
    return out


def recipe_schedule_and_resume(cfg, x, y, init):
    """AdamW on a cosine lr: captured against eager over RECIPE_STEPS
    steps, the lr each step applied read back from the device; the eager
    run saves a checkpoint two steps before the end, and a fresh graph
    loads it and takes the last two steps captured."""
    steps = RECIPE_STEPS
    sched = ht.optim.cosine_schedule(3e-4, 2, steps, 3e-5)
    tmp = tempfile.mkdtemp(prefix="train_recipe_")
    runs = {}
    try:
        for mode in ("captured", "eager", "resumed"):
            g, ids, labels, model, loss, opts, ops_ = recipe_trainer(
                cfg, lambda: [(ht.optim.AdamWOptimizer(
                    lr=sched, weight_decay=0.01), None)],
                init=init if mode != "resumed" else None)
            opt = opts[0]
            first = 0
            if mode == "resumed":
                first = ht_ckpt.load_checkpoint(model, opt, tmp,
                                                verify_exempt=True)["step"]
            ls, lrs = [], []
            with capture.eager() if mode == "eager" else \
                    contextlib.nullcontext():
                for i in range(first, steps):
                    ls.append(float(g.run(loss, [loss, ops_[0]],
                                          {ids: x, labels: y})[0]))
                    # the lr the step just applied, read from the device
                    lrs.append(float(opt._lr_at(opt._state["step"])))
                    if mode == "eager" and i + 1 == steps - 2:
                        ht_ckpt.save_checkpoint(model, opt, tmp, step=i + 1)
            runs[mode] = {"losses": ls, "lrs": lrs,
                          "compile_count": g.compile_count}
            note("train_recipe", mode, runs[mode])
            del g, ids, labels, model, loss, opts, ops_, opt
            gc.collect()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return sched, runs


def phase_train_recipe():
    """Phase 16: the recipe around the entry point's step at GPT-2 small's
    widths, each variant against its parent in this run (see the module
    docstring)."""
    cfg = GPTConfig(vocab_size=50304, dtype="bfloat16")
    steps = RECIPE_STEPS
    x, y = seeded_batch(cfg.vocab_size, RECIPE_BATCH, RECIPE_SEQ, seed=0)
    init, variants, plain_fp32_loss, scaler_out, others = recipe_variants(
        cfg, x, y)
    gc.collect()
    plain = variants["plain"]

    # -- fused cross entropy against the plain step ----------------------
    # The op itself is held to an fp32 cross entropy on the step's own
    # hidden states and head (``fused_ce_op_readings``), its chunk
    # products must take fp32 results of bf16 operands, and a planted
    # bf16-logits route must fail the same limits.  The steps: the two
    # bf16 steps round in different places (the plain step's logits,
    # log-softmax and their gradient in bf16; the fused op's in fp32), so
    # their gradients differ by more than the bf16 row limit allows, and
    # the bf16 body's rounding dominates both; each step's gradients are
    # held to an fp32 model's on the same weights, the fused step's about
    # as closely as the plain step's (1.25x its relative error), and the
    # row limit against the plain step is reported.
    fused = recipe_grads(cfg, x, y, init, fused_lm_ce=True)
    from hetu_tpu_torch.ops.fused_ce import product_route
    op_check = fused_ce_op_readings(fused.pop("hidden"), fused.pop("head"),
                                    y)
    gc.collect()
    ref = recipe_grads(cfg, x, y, init, dtype="float32")
    del ref["hidden"], ref["head"]
    e_plain = grad_rel_errors(plain["grads"], ref["grads"])
    e_fused = grad_rel_errors(fused["grads"], ref["grads"])
    ratio = max(f / max(p, 1e-30) for f, p in zip(e_fused, e_plain))
    fused.update(
        plain_loss_fp32_of_bf16_logits=plain_fp32_loss,
        fp32_model_loss=ref["losses"][0],
        loss_rel_diff=abs(fused["losses"][0] - plain_fp32_loss) /
        abs(plain_fp32_loss),
        loss_diff_to_plain_bf16=abs(fused["losses"][0] -
                                    plain["losses"][0]),
        grad_rel_err_vs_fp32={"fused_max": max(e_fused),
                              "plain_max": max(e_plain),
                              "worst_ratio_fused_over_plain": ratio},
        grad_err_over_row_limit_vs_plain=grad_agreement(fused["grads"],
                                                        plain["grads"]),
        chunk_products=product_route(torch.bfloat16, "cuda"),
        op_vs_fp32=op_check,
        logits_bytes=RECIPE_BATCH * RECIPE_SEQ * cfg.vocab_size * 2,
        logits_fp32_bytes=RECIPE_BATCH * RECIPE_SEQ * cfg.vocab_size * 4)
    del fused["grads"], ref["grads"]
    note("train_recipe", "fused_ce", fused)
    # the loss within 1e-3 of the fp32 cross entropy of the plain step's
    # logits, and so within one bf16 step (2**-4 near 11, at most 2**-3
    # for a loss of 16 and more) of the bf16 one
    if fused["chunk_products"] != "mm_out_dtype" \
            or not op_check["op_within"] or not op_check["planted_refused"] \
            or fused["loss_rel_diff"] > 1e-3 or ratio > 1.25 \
            or fused["loss_diff_to_plain_bf16"] > 2.0 ** -3 \
            or not fused["step_peak_above_resting_bytes"] < \
            plain["step_peak_above_resting_bytes"]:
        raise AssertionError(f"train_recipe fused CE: {fused}, plain step "
                             f"peak {plain['step_peak_above_resting_bytes']}")
    gc.collect()

    # -- a cosine lr, captured against eager, and a checkpoint resume ----
    sched, runs = recipe_schedule_and_resume(cfg, x, y, init)
    want_lrs = [float(sched(float(i))) for i in range(1, steps + 1)]
    cap, eag, res = runs["captured"], runs["eager"], runs["resumed"]
    sched_rel = max(abs(a - b) / abs(b)
                    for a, b in zip(cap["losses"], eag["losses"]))
    resume_rel = max(abs(a - b) / abs(b)
                     for a, b in zip(res["losses"], cap["losses"][-2:]))
    sched_out = {"captured": cap, "eager": eag, "want_lrs": want_lrs,
                 "loss_rel_diff": sched_rel}
    resume_out = {"resumed_losses": res["losses"], "at_step": steps - 2,
                  "uninterrupted_losses": cap["losses"][-2:],
                  "loss_rel_diff": resume_rel,
                  "compile_count": res["compile_count"]}
    if sched_rel > 1e-4 or len(set(cap["lrs"])) != steps or \
            np.abs(np.array(cap["lrs"]) - want_lrs).max() > \
            1e-6 * max(want_lrs) or cap["lrs"] != eag["lrs"] or \
            cap["compile_count"] != 1 or \
            not cap["losses"][-1] < cap["losses"][0]:
        raise AssertionError(f"train_recipe cosine schedule: {sched_out}")
    if resume_rel > 1e-4:
        raise AssertionError(f"train_recipe checkpoint resume: {resume_out}")
    del plain["grads"]
    out = {"config": {"vocab": cfg.vocab_size, "hidden": cfg.hidden_size,
                      "layers": cfg.num_layers, "heads": cfg.num_heads,
                      "seq": RECIPE_SEQ, "global_batch": RECIPE_BATCH,
                      "dtype": cfg.dtype},
           "variants": variants, "fused_ce": fused,
           "grad_scaler": scaler_out, "sgd_losses": others["sgd"],
           "adafactor_losses": others["adafactor"],
           "cosine_schedule": sched_out, "checkpoint_resume": resume_out}
    emit({"phase": "train_recipe", **out})
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# BERT-base pre-training and the small models (phases 17 and 18)
# ---------------------------------------------------------------------------

# BERT-Base Uncased at its published widths (Devlin et al. 2019, Google's
# bert_config.json): BertConfig's defaults, vocab 30522, hidden 768, 12
# layers, 12 heads, intermediate 3072, 512 positions, 2 segment types.
# Nothing is cut.  Seq 512, global batch 32 in 2 micro-batches.
BERT_BATCH, BERT_SEQ, BERT_MICRO, BERT_STEPS = 32, 512, 2, 6
# Adam without warmup: at 1e-4 (BERT's peak, reached after 10,000 warmup
# steps in its recipe) the 12-layer post-norm stack's loss climbs in the
# first steps on the card (11.19 -> 15.65 in fp32); 1e-5 falls from the
# first step
BERT_LR = 1e-5
BERT_MASK_ID = 103           # [MASK] in BERT-Base Uncased's vocabulary
BERT_MLM_RATE = 0.15
# phase 17's oracle: a 2-layer fp32 BERT at BERT-base's widths, batch 4 of
# seq 128, 3 steps at a small lr, so that the updates stay in the range
# where card and CPU agree step for step
BERT_ORACLE_LAYERS, BERT_ORACLE_BATCH, BERT_ORACLE_SEQ = 2, 4, 128
BERT_ORACLE_STEPS, BERT_ORACLE_LR = 3, 1e-6
# the flash kernels each dtype must run, as the profiler names them: fp32
# q/k/v on 3xTF32, bf16 (the attention op under autocast) on wgmma
BERT_KERNELS = {
    "float32": (r"flash_fwd_mma_kernel<64, float, float>",
                r"flash_bwd_dkv_tf32_kernel<64, float, (true|\(bool\)1)>"),
    "bfloat16": (r"flash_fwd_wgmma_kernel<64>",
                 r"flash_bwd_dkv_wgmma_kernel<64, (true|\(bool\)1)>")}


def bert_batch(vocab, batch, seq, seed=0):
    """Pre-training data from numpy seed ``seed``: ids uniform over the
    vocabulary, segment 0 for the first half of each sequence and 1 for
    the second, 15 % of positions masked ([MASK] in the input, the
    original id as the MLM label, -100 elsewhere), next-sentence labels
    0/1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    tt = np.zeros((batch, seq), np.int32)
    tt[:, seq // 2:] = 1
    masked = rng.rand(batch, seq) < BERT_MLM_RATE
    mlm = np.where(masked, ids, -100).astype(np.int32)
    ids = np.where(masked, BERT_MASK_ID, ids).astype(np.int32)
    nsp = rng.randint(0, 2, (batch,)).astype(np.int32)
    return ids, tt, mlm, nsp


def build_bert(cfg, batch, seq, device, lr, bf16=False, seed=0):
    """``BertForPreTraining(cfg)`` on a define-and-run graph, built under
    ``ht.autocast("bfloat16")`` with ``bf16``, and Adam: ``(graph,
    placeholders, model, loss, train op)``."""
    with ht.graph("define_and_run", create_new=True, device=device,
                  seed=seed) as g:
        phs = [ht.parallel_placeholder("int32", (batch, seq), name=n)
               for n in ("input_ids", "token_type_ids", "mlm_labels")]
        phs.append(ht.parallel_placeholder("int32", (batch,),
                                           name="nsp_labels"))
        with ht.autocast("bfloat16", enabled=bf16):
            model = BertForPreTraining(cfg)
            loss = model(*phs)
        train_op = ht.optim.AdamOptimizer(lr=lr).minimize(loss)
    return g, phs, model, loss, train_op


def bert_pretrain(bf16):
    """One dtype of phase 17: ``BERT_STEPS`` captured steps, their
    readings and gates."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BertConfig()
    dtype = "bfloat16" if bf16 else "float32"
    t0 = time.perf_counter()
    g, phs, model, loss, train_op = build_bert(cfg, BERT_BATCH, BERT_SEQ,
                                               "cuda", BERT_LR, bf16)
    n_params = sum(p.get_data().numel() for p in model.parameters())
    feeds = dict(zip(phs, bert_batch(cfg.vocab_size, BERT_BATCH, BERT_SEQ)))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def step():
        return g.run(loss, [loss, train_op], feeds,
                     num_micro_batches=BERT_MICRO)

    reset_flash_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(BERT_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        l, upd = step()
        losses.append(float(l))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if upd is not None:
            raise AssertionError("the update op's fetch is not None")
    counts = flash_counts()
    launches = {n: c["launches"] for n, c in counts.items()}
    by_route = {n: c["by_route"] for n, c in counts.items()}
    causal = {n: c["causal"] for n, c in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bert {dtype}: losses {losses} not finite "
                             f"and falling")
    # 12 layers, each one forward and one fused backward a micro-batch: the
    # byte rule 2 * 512 * 64 * (4 + itemsize) <= 4 MiB picks the fused
    # backward in both dtypes; 2 micro-batches a step
    per_step = cfg.num_layers * BERT_MICRO
    each = per_step * BERT_STEPS
    want = {"flash_fwd": each, "flash_bwd_fused": each, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    if not fa._use_fused(BERT_SEQ, cfg.head_dim,
                         torch.bfloat16 if bf16 else torch.float32):
        raise AssertionError("the byte rule does not pick the fused "
                             "backward at BERT's shape")
    route = "wgmma" if bf16 else "3xtf32"
    on_route = {n: r[route] for n, r in by_route.items()}
    if launches != want or on_route != want or any(causal.values()):
        raise AssertionError(f"bert {dtype}: flash launches {launches}, "
                             f"{by_route}, causal {causal}; want {want} on "
                             f"{route}, none causal")
    if len(g._plan_pool) != 1 or g.compile_count != 1:
        raise AssertionError(f"bert {dtype}: {len(g._plan_pool)} plans, "
                             f"{g.compile_count} captured graphs")
    prof = profile_train(g, loss, train_op, feeds, {
        "flash_fwd_": per_step, "flash_bwd_dq_": 0,
        "flash_bwd_dkv_": per_step})
    for pattern in BERT_KERNELS[dtype]:
        seen = sum(n for k, n in prof["flash_kernels"].items()
                   if re.search(pattern, k))
        if seen != per_step * prof["steps"]:
            raise AssertionError(f"bert {dtype}: the profile saw {seen} "
                                 f"launches of {pattern} in "
                                 f"{prof['steps']} steps, want "
                                 f"{per_step * prof['steps']}: "
                                 f"{prof['flash_kernels']}")
    steady = step_s[1:]
    out = {"config": "bert_base_uncased", "dtype": dtype,
           "autocast": "bfloat16" if bf16 else None, "params": n_params,
           "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "heads": cfg.num_heads, "ffn": cfg.ffn_size,
           "vocab": cfg.vocab_size, "global_batch": BERT_BATCH,
           "seq": BERT_SEQ, "micro_batches": BERT_MICRO, "lr": BERT_LR,
           "setup_s": setup_s, "losses": losses, "step_s": step_s,
           "ms_per_step": 1e3 * float(np.mean(steady)),
           "tokens_per_s": BERT_BATCH * BERT_SEQ / float(np.mean(steady)),
           "peak_memory_bytes": peak, "peak_above_start_bytes": peak - base,
           "flash_launches": launches, "flash_launches_by_route": by_route,
           "causal_flash_launches": causal,
           "compile_count": g.compile_count, "profile": prof}
    del g, phs, model, loss, train_op, feeds
    gc.collect()
    torch.cuda.empty_cache()
    return out


def bert_oracle():
    """A 2-layer fp32 BERT at BERT-base's widths trains
    ``BERT_ORACLE_STEPS`` steps on the CPU (plain versions) and on the card
    (kernels, captured step) from the same weights and batch, within phase
    8's limits (``oracle_report``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, seq = BERT_ORACLE_BATCH, BERT_ORACLE_SEQ
    steps, lr = BERT_ORACLE_STEPS, BERT_ORACLE_LR
    cfg = BertConfig(num_layers=BERT_ORACLE_LAYERS)
    data = bert_batch(cfg.vocab_size, batch, seq, seed=1)
    runs, init = {}, None
    for dev in ("cpu", "cuda"):
        g, phs, model, loss, train_op = build_bert(cfg, batch, seq, dev, lr,
                                                   seed=1)
        if init is None:
            init = module_state_numpy(model)
        else:
            load_module_state(model, init)
        feeds = dict(zip(phs, data))
        t0 = time.perf_counter()
        losses = [float(g.run(loss, [loss, train_op], feeds,
                              num_micro_batches=BERT_MICRO)[0])
                  for _ in range(steps)]
        runs[dev] = (losses, module_state_numpy(model),
                     time.perf_counter() - t0)
        del g, model
        gc.collect()
    return {"layers": BERT_ORACLE_LAYERS, "seq": seq, "batch": batch,
            "steps": steps, "lr": lr, **oracle_report("bert_base_2_layers", runs, init, lr,
                                      steps, True)}


def phase_bert_pretrain():
    """Phase 17: BERT-base pre-training in fp32 and under bf16 autocast,
    then its card-against-CPU oracle."""
    out = {"float32": bert_pretrain(bf16=False),
           "bfloat16": bert_pretrain(bf16=True)}
    emit({"phase": "bert_pretrain", **out, "oracle": bert_oracle()})
    torch.cuda.empty_cache()
    return out


# phase 18's models, with the sizes their sources give them: CIFAR-10
# images (batch 128, 3x32x32, 10 classes); the medium LSTM of Zaremba et
# al. 2014 (vocab 10000, hidden 650, 2 layers, 35 steps, batch 20), also
# with GRU cells; Criteo's layout (26 sparse fields over one shared table
# of 1,000,000 ids, embedding dim 16, 13 dense features, batch 2048)
SMALL_STEPS = 3
SMALL_LR = 1e-4
CIFAR = {"batch": 128, "shape": (3, 32, 32), "classes": 10}
PTB_MEDIUM = {"vocab": 10000, "hidden": 650, "layers": 2, "seq": 35,
              "batch": 20}
CRITEO = {"fields": 26, "vocab": 1_000_000, "dim": 16, "dense": 13,
          "batch": 2048}


def small_model_cases():
    """name -> (make model, [(dtype, array)] batch, loss(model, *phs))."""
    rng = np.random.RandomState(0)
    b = CIFAR["batch"]
    images = [("float32", rng.randn(b, *CIFAR["shape"]).astype(np.float32)),
              ("int32", rng.randint(0, CIFAR["classes"], (b,))
               .astype(np.int32))]
    toks = rng.randint(0, PTB_MEDIUM["vocab"],
                       (PTB_MEDIUM["batch"], PTB_MEDIUM["seq"] + 1))
    text = [("int32", toks[:, :-1].astype(np.int32)),
            ("int32", toks[:, 1:].astype(np.int32))]
    n = CRITEO["batch"]
    clicks = [("int32", rng.randint(0, CRITEO["vocab"],
                                    (n, CRITEO["fields"])).astype(np.int32)),
              ("float32", np.log1p(rng.exponential(
                  4.0, (n, CRITEO["dense"]))).astype(np.float32)),
              ("float32", (rng.rand(n) < 0.25).astype(np.float32))]
    ctr_args = (CRITEO["fields"], CRITEO["vocab"], CRITEO["dim"],
                CRITEO["dense"])

    def labelled(model, *phs):
        return model(*phs)

    def ctr(model, ids, dense, y):
        return ctr_loss(model(ids, dense), y)
    lm = (PTB_MEDIUM["vocab"], PTB_MEDIUM["hidden"])
    return {
        "simple_cnn": (lambda: SimpleCNN(CIFAR["classes"]), images,
                       labelled),
        "resnet18": (lambda: resnet18(CIFAR["classes"]), images, labelled),
        "lstm_lm": (lambda: RNNLanguageModel(
            *lm, "lstm", PTB_MEDIUM["layers"]), text, labelled),
        "gru_lm": (lambda: RNNLanguageModel(
            *lm, "gru", PTB_MEDIUM["layers"]), text, labelled),
        "wdl": (lambda: WDL(*ctr_args), clicks, ctr),
        "deepfm": (lambda: DeepFM(*ctr_args), clicks, ctr),
        "dcn": (lambda: DCN(*ctr_args), clicks, ctr)}


def phase_small_models():
    """Phase 18: each model trains ``SMALL_STEPS`` Adam steps on the card
    through the graph (captured after the first); the loss must fall, and
    BatchNorm's running statistics stay at their defaults, as under the
    JAX package's define-and-run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, (make, batch, loss_fn) in small_model_cases().items():
        t0 = time.perf_counter()
        with ht.graph("define_and_run", create_new=True, device="cuda",
                      seed=0) as g:
            phs = [ht.placeholder(dt, a.shape) for dt, a in batch]
            model = make()
            loss = loss_fn(model, *phs)
            train_op = ht.optim.AdamOptimizer(lr=SMALL_LR).minimize(loss)
        feeds = {p: a for p, (_, a) in zip(phs, batch)}
        losses, step_s = [], []
        for _ in range(SMALL_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(g.run(loss, [loss, train_op], feeds)[0]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: losses {losses} not finite and "
                                 f"falling")
        stats = {k: v for k, v in module_state_numpy(model).items()
                 if k.endswith(("running_mean", "running_var"))}
        moved = [k for k, v in stats.items()
                 if not np.array_equal(v, np.zeros_like(v) if
                                       k.endswith("mean") else np.ones_like(v))]
        if moved or g.compile_count != 1:
            raise AssertionError(f"{name}: running statistics {moved} moved "
                                 f"in define-and-run steps, or "
                                 f"{g.compile_count} captured graphs")
        out[name] = {"params": sum(p.get_data().numel()
                                   for p in model.parameters()),
                     "batch": [list(a.shape) for _, a in batch],
                     "losses": losses, "step_s": step_s,
                     "last_step_ms": 1e3 * step_s[-1],
                     "batchnorm_buffers_unchanged": len(stats),
                     "compile_count": g.compile_count,
                     "wall_s": time.perf_counter() - t0}
        del g, phs, model, loss, train_op, feeds
        gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "small_models", "steps": SMALL_STEPS, "lr": SMALL_LR,
          "cifar10": CIFAR, "ptb_medium": PTB_MEDIUM, "criteo": CRITEO,
          **out})
    return out


# ---------------------------------------------------------------------------
# the graph layer at GPT-2 small's widths (phase 19)
# ---------------------------------------------------------------------------

GRAPH_SEQ, GRAPH_LR, GRAPH_STEPS = 1024, 3e-4, 12
GRAPH_BUCKETS = [4, 8]
GRAPH_GRAD_RUNS, GRAPH_GRAD_BATCH, GRAPH_EAGER_BATCH = 3, 8, 4


def graph_trainer(cfg, init, batch, buckets=None):
    """A define-and-run GPT graph over placeholders of ``(batch,
    GRAPH_SEQ)`` (``batch`` may be a ``SymbolicDim``), Adam, the weights
    ``init`` (``None``: its own, from the graph's seed 0); with
    ``buckets`` the labels pad with -100."""
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as g:
        ids = ht.parallel_placeholder("int32", (batch, GRAPH_SEQ),
                                      name="input_ids")
        labels = ht.parallel_placeholder("int32", (batch, GRAPH_SEQ),
                                         name="labels")
        model = GPTLMHeadModel(cfg)
        loss = model(ids, labels)
        train_op = ht.optim.AdamOptimizer(lr=GRAPH_LR).minimize(loss)
        if buckets is not None:
            g.set_shape_buckets(buckets, pad_values={labels: -100})
    if init is not None:
        load_state(model, init)
    return g, ids, labels, model, loss, train_op


def flash_launch_counts():
    """The forward's and the fused backward's launches since
    ``reset_flash_counts``; every flash launch must have run on the wgmma
    route (bf16 at head dim 64)."""
    counts = flash_counts()
    if any(c["by_route"]["wgmma"] != c["launches"] for c in counts.values()):
        raise AssertionError(f"graph_layer: flash launches off the wgmma "
                             f"route: {counts}")
    return {n: c["launches"] for n, c in counts.items()
            if n in ("flash_fwd", "flash_bwd_fused")}


def plan_launches(entry):
    """The flash launches a captured plan adds on each replay."""
    names = {fn: n for n, fn in flash_wrappers().items()}
    return {names[fn]: c for (fn, attr), c in entry.step.launches.items()
            if fn in names and attr == "launches"}


def graph_buckets(cfg):
    """(a): a symbolic batch over buckets [4, 8], 12 captured steps at
    batch sizes drawn from seed 0 over 1-8; a padded step's loss against
    the same rows unpadded at their own size.  Returns the readings and
    the model's first weights (random, seed 0), which (b)-(d) start
    from."""
    sizes = [int(b) for b in np.random.RandomState(0).randint(1, 9,
                                                               GRAPH_STEPS)]
    if not set(GRAPH_BUCKETS) <= set(sizes) or \
            set(sizes) <= set(GRAPH_BUCKETS):
        raise AssertionError(f"graph_layer: sizes {sizes} miss a bucket or "
                             f"an unbucketed size")
    g, ids, labels, model, loss, op = graph_trainer(
        cfg, None, ht.SymbolicDim("batch"), GRAPH_BUCKETS)
    init = state_numpy(model)
    reset_flash_counts()
    losses, host_ms, padded = [], [], None
    for i, b in enumerate(sizes):
        x, y = seeded_batch(cfg.vocab_size, b, GRAPH_SEQ, seed=100 + i)
        if padded is None and b not in GRAPH_BUCKETS:
            # the weights before the first padded step, for its reference
            padded = {"step": i, "batch": b, "x": x, "y": y,
                      "weights": state_numpy(model)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(g.run(loss, [loss, op], {ids: x, labels: y})[0]))
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    launches = flash_launch_counts()
    want = {"flash_fwd": 12 * GRAPH_STEPS, "flash_bwd_fused": 12 * GRAPH_STEPS}
    compile_count, plans = g.compile_count, len(g._plan_pool)
    bucket_ms = {}
    for b in GRAPH_BUCKETS:
        x, y = seeded_batch(cfg.vocab_size, b, GRAPH_SEQ, seed=200 + b)
        bucket_ms[b] = step_ms(lambda: g.run(loss, [loss, op],
                                             {ids: x, labels: y}))
    if g.compile_count != compile_count:
        raise AssertionError("graph_layer: the timed steps captured again")
    del g, model, op
    gc.collect()
    # the same rows, unpadded, at their own size, from the same weights
    b = padded["batch"]
    g, ids, labels, model, loss, op = graph_trainer(cfg, padded["weights"],
                                                    b)
    with capture.eager():
        exact = float(g.run(loss, [loss, op], {ids: padded["x"],
                                               labels: padded["y"]})[0])
    del g, model, op
    gc.collect()
    got = losses[padded["step"]]
    out = {"batch_sizes": sizes, "buckets": GRAPH_BUCKETS,
           "losses": losses, "host_ms": host_ms,
           "compile_count": compile_count, "plans": plans,
           "flash_launches": launches,
           "step_ms_at_bucket": {str(k): v for k, v in bucket_ms.items()},
           "padded_step": {"step": padded["step"], "batch": b,
                           "bucket": min(x for x in GRAPH_BUCKETS if x >= b),
                           "loss": got, "exact_size_loss": exact,
                           "rel_diff": abs(got - exact) / abs(exact)}}
    if compile_count != 2 or plans != 2 or launches != want or \
            not np.isfinite(losses).all() or \
            out["padded_step"]["rel_diff"] > 1e-3:
        raise AssertionError(f"graph_layer buckets: {out}, want launches "
                             f"{want}")
    return out, init


def graph_grad_update(cfg, init):
    """(b): 3 GRAD runs then an UPDATE at batch 8, captured, against one
    eager Adam step on the sum of the four runs' gradients, summed as the
    run levels define it: in the parameters' dtype, the GRAD runs' in
    order and the UPDATE run's added to that sum.  The same step on the
    fp32 sum is reported beside it: Adam's first step moves an element by
    about lr times the sign of its gradient, so where the four gradients
    nearly cancel the bf16 sum's rounding flips that sign."""
    batches = [seeded_batch(cfg.vocab_size, GRAPH_GRAD_BATCH, GRAPH_SEQ,
                            seed=300 + i)
               for i in range(GRAPH_GRAD_RUNS + 1)]
    g, ids, labels, model, loss, op = graph_trainer(cfg, init,
                                                    GRAPH_GRAD_BATCH)
    params = [p.get_data() for p in model.parameters()]
    start = [p.clone() for p in params]
    reset_flash_counts()
    grad_ms, still, losses = [], True, []
    for i, (x, y) in enumerate(batches):
        level = "grad" if i < GRAPH_GRAD_RUNS else "update"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(g.run(loss, [loss, op], {ids: x, labels: y},
                                  run_level=level)[0]))
        torch.cuda.synchronize()
        if level == "grad":
            grad_ms.append((time.perf_counter() - t0) * 1e3)
            still &= all(torch.equal(a, b) for a, b in zip(params, start))
        if i == GRAPH_GRAD_RUNS - 1:
            # the GRAD runs' sums, to tell a wrong GRAD replay from a
            # wrong UPDATE when the update misses
            accum = [g._grad_accum.get(p.id) for p in model.parameters()]
            accum = [None if a is None else a.clone() for a in accum]
    launches = flash_launch_counts()
    by_plan = {e.level.value: plan_launches(e) for e in g._plan_pool.values()
               if e.step is not None}
    zeroed = all(float(a.abs().max()) == 0 for a in g._grad_accum.values())
    got = state_numpy(model)
    compile_count = g.compile_count
    del g, model, op, params, start
    gc.collect()
    # the reference: each run's gradients (eager), summed, then one Adam
    # step of the same optimizer code on fresh copies of the weights
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as rg:
        rids = ht.parallel_placeholder("int32", (GRAPH_GRAD_BATCH,
                                                 GRAPH_SEQ))
        rlab = ht.parallel_placeholder("int32", (GRAPH_GRAD_BATCH,
                                                 GRAPH_SEQ))
        rmodel = GPTLMHeadModel(cfg)
        rloss = rmodel(rids, rlab)
        xs = [p for _, p in rmodel.named_parameters()]
        grads = ht.gradients(rloss, xs)
    load_state(rmodel, init)
    runs = []
    with capture.eager():
        for x, y in batches:
            runs.append(rg.run(grads, feed_dict={rids: x, rlab: y}))
    total = [v.clone() for v in runs[0]]
    for gv in runs[1:-1]:
        for a, v in zip(total, gv):
            a.add_(v)
    grad_sum_rel = max(
        float((a.float() - t.float()).norm()) /
        max(float(t.float().norm()), 1e-30)
        for a, t in zip(accum, total) if a is not None)
    del accum
    sums = {"param_dtype": [v + a for v, a in zip(runs[-1], total)],
            "fp32": [sum(gv[i].float() for gv in runs)
                     for i in range(len(xs))]}
    del runs, total
    upd_rel, worst = {}, []
    for kind, total in sums.items():
        load_state(rmodel, init)
        ht.optim.AdamOptimizer(lr=GRAPH_LR)._apply_updates(rg, xs, total)
        want = state_numpy(rmodel)
        rel = {k: float(np.linalg.norm(got[k] - want[k])) /
               max(float(np.linalg.norm(want[k] - init[k])), 1e-30)
               for k in want}
        upd_rel[kind] = max(rel.values())
        if kind == "param_dtype":
            worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    del rg, rmodel, sums, total, grads, xs, want
    gc.collect()
    out = {"batch": GRAPH_GRAD_BATCH, "grad_runs": GRAPH_GRAD_RUNS,
           "losses": losses, "grad_run_host_ms": grad_ms,
           "replayed_grad_run_ms": float(np.mean(grad_ms[1:])),
           "weights_still_during_grad_runs": still,
           "accumulator_zeroed": zeroed, "compile_count": compile_count,
           "captured_plans": by_plan, "flash_launches": launches,
           "update_rel_diff_vs_summed_gradient_step": upd_rel,
           "update_rel_diff_worst": worst,
           "grad_sum_rel_diff_after_grad_runs": grad_sum_rel}
    per_run = {"flash_fwd": 12, "flash_bwd_fused": 12}
    if not still or not zeroed or compile_count != 2 or \
            upd_rel["param_dtype"] > 1e-2 or \
            by_plan != {"grad": per_run, "update": per_run} or \
            launches != {k: 4 * v for k, v in per_run.items()}:
        raise AssertionError(f"graph_layer grad/update: {out}")
    return out


def graph_eager_and_by_run(cfg, init):
    """(c) the forward at batch 4 in an eager graph, op by op, against a
    define-and-run COMPUTE_ONLY run; (d) a define-by-run graph's logits
    and then its loss from the cached logits, then a new feed."""
    b = GRAPH_EAGER_BATCH
    (x, y), (x2, y2) = (seeded_batch(cfg.vocab_size, b, GRAPH_SEQ, seed=s)
                        for s in (400, 401))
    # the define-and-run reference: logits and loss of one plan
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as g:
        ids = ht.parallel_placeholder("int32", (b, GRAPH_SEQ))
        lab = ht.parallel_placeholder("int32", (b, GRAPH_SEQ))
        model = GPTLMHeadModel(cfg)
        logits_t = model.logits(ids)
        loss_t = ht.nn.vocab_parallel_cross_entropy(logits_t, lab,
                                                    ignore_index=-100)
    load_state(model, init)
    want_logits, want_loss = g.run([logits_t, loss_t], feed_dict={
        ids: x, lab: y}, run_level="compute_only")
    want_loss = float(want_loss)
    del g, model
    # (c) eager
    with ht.graph("eager", create_new=True, device="cuda") as eg:
        emodel = GPTLMHeadModel(cfg)
        load_state(emodel, init)
        xt = torch.from_numpy(x).cuda()
        runs = []
        for _ in range(2):          # the first pays the host's first calls
            reset_flash_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_ops = len(eg.ops)
            logits = emodel.logits(xt)
            torch.cuda.synchronize()
            runs.append({"host_ms": (time.perf_counter() - t0) * 1e3,
                         "ops": len(eg.ops) - n_ops,
                         "flash_launches": flash_launch_counts()})
        eager_logits = logits.get_data()
    eager_err = grad_agreement([eager_logits], [want_logits])
    del eg, emodel, logits, eager_logits, want_logits
    gc.collect()
    # (d) define-by-run
    with ht.graph("define_by_run", create_new=True, device="cuda",
                  seed=0) as dg:
        dids = ht.parallel_placeholder("int32", (b, GRAPH_SEQ))
        dlab = ht.parallel_placeholder("int32", (b, GRAPH_SEQ))
        dmodel = GPTLMHeadModel(cfg)
        dlogits = dmodel.logits(dids)
        dloss = ht.nn.vocab_parallel_cross_entropy(dlogits, dlab,
                                                   ignore_index=-100)
    load_state(dmodel, init)
    dg.feed(dids, x)
    dg.feed(dlab, y)
    reads, first = [], None
    for name, t in (("logits", dlogits), ("loss_from_cache", dloss),
                    ("loss_after_invalidate", dloss)):
        if name == "loss_after_invalidate":
            dg.invalidate()
            dg.feed(dids, x2)
            dg.feed(dlab, y2)
        reset_flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = dg.get_or_compute(t)
        torch.cuda.synchronize()
        first = v if first is None else first
        reads.append({"fetch": name, "host_ms": (time.perf_counter() - t0)
                      * 1e3, "flash_launches": flash_launch_counts(),
                      **({"loss": float(v)} if v.ndim == 0 else {})})
    # the recomputation read the new feed: new logits in the cache
    new_logits = not torch.equal(first, dg._computed[dlogits.id])
    del dg, dmodel, first
    gc.collect()
    torch.cuda.empty_cache()
    eager = {"batch": b, "runs": runs, "host_ms": runs[1]["host_ms"],
             "logits_err_over_bf16_row_limit": eager_err,
             "define_and_run_loss": want_loss}
    by_run = {"batch": b, "reads": reads,
              "new_feed_gave_new_logits": new_logits}
    layers = {"flash_fwd": 12, "flash_bwd_fused": 0}
    none = {"flash_fwd": 0, "flash_bwd_fused": 0}
    if any(r["flash_launches"] != layers for r in runs) or eager_err > 1 \
            or [r["flash_launches"] for r in reads] != [layers, none,
                                                        layers] \
            or abs(reads[1]["loss"] - want_loss) > 1e-3 * abs(want_loss) \
            or not np.isfinite(reads[2]["loss"]) or not new_logits:
        raise AssertionError(f"graph_layer eager {eager}, define-by-run "
                             f"{by_run}")
    return eager, by_run


def phase_graph_layer():
    """Phase 19: the graph layer on GPT-2 small's widths (see the module
    docstring)."""
    cfg = GPTConfig(vocab_size=50304, dtype="bfloat16")
    t0 = time.perf_counter()
    buckets, init = graph_buckets(cfg)
    note("graph_layer", "buckets", buckets)
    grad = graph_grad_update(cfg, init)
    note("graph_layer", "grad_then_update", grad)
    eager, by_run = graph_eager_and_by_run(cfg, init)
    note("graph_layer", "eager", eager)
    note("graph_layer", "define_by_run", by_run)
    launches = {n: buckets["flash_launches"][n] + grad["flash_launches"][n]
                + sum(r["flash_launches"][n] for r in eager["runs"])
                + sum(r["flash_launches"][n] for r in by_run["reads"])
                for n in ("flash_fwd", "flash_bwd_fused")}
    out = {"config": {"vocab": cfg.vocab_size, "hidden": cfg.hidden_size,
                      "layers": cfg.num_layers, "heads": cfg.num_heads,
                      "seq": GRAPH_SEQ, "dtype": cfg.dtype,
                      "lr": GRAPH_LR, "weights": "random, seed 0"},
           "compile_count": buckets["compile_count"],
           "step_ms_at_bucket": buckets["step_ms_at_bucket"],
           "replayed_grad_run_ms": grad["replayed_grad_run_ms"],
           "eager_forward_host_ms": eager["host_ms"],
           "flash_launches": launches,
           "wall_s": time.perf_counter() - t0}
    emit({"phase": "graph_layer", **out})
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# speculative decoding on the serving engine (phase 20)
# ---------------------------------------------------------------------------

SPEC_K = 4
# the target's depth: Llama-3-8B's 32 layers cut to 16 to keep the smoke
# within its time (phase 26 came in; phase 4 serves all 32)
SPEC_LAYERS = 16
SPEC_DRAFT_LAYERS = 2
# the draft prefill's fp32 scores are num_heads x max_model_len**2 a layer
# (2.1 GB at 32 heads and 4096); phase 4's longest request is 3032 tokens
SPEC_MAX_MODEL_LEN = 4096
SPEC_NEW_TOKENS = 32
# page pools of (a) and (b): bf16, and fp32 pages (twice the bytes; the
# fp32 weights take 32 GB)
SPEC_PAGES = {"bfloat16": 1024, "float32": 256}
# (d): the fp32 full-head target as its own draft (all its layers, the
# same tensors) on phase 4's requests whose prompts and new tokens fit
# SPEC_ACCEPT_MAX_MODEL_LEN, the sampled one among them: the greedy
# requests' bursts are accepted whole, the sampled one's cut short
SPEC_ACCEPT_REQUESTS = (0, 3, 4, 6)
SPEC_ACCEPT_MAX_MODEL_LEN = 2048
SPEC_ACCEPT_NEW = 16
# bf16 spec tokens may part from the non-spec engine's only at a near tie:
# where a dense bf16 forward puts both tokens' logits within this of its
# largest (ROADMAP §3 F5).  On an H100 (tools/spec_divergence.py; logits
# near 5.3-6.1, std 1.28) the largest such gap was 0.058 at full head and
# 0.180 in the MLA layout, and bf16 rounding alone moved a gap between
# two tokens by up to 0.148 against an fp32 forward of the same weights;
# the limit is 8 bf16 steps at that size.  A token a fault picks lies
# whole logits below
SPEC_TIE_LIMIT = 0.25
# (c): verify rows of SPEC_K + 1 tokens beside chunks of 2, at GPT-2
# small's widths, 2 layers, fp32 (TF32 off), the target as its own draft
SPEC_NARROW_CHUNK = 2
SPEC_NARROW_LAYERS = 2
SPEC_NARROW_PROMPTS = (24, 9, 40)
SPEC_NARROW_NEW = 12
# kernels 5 and 6 at a spec step's batch: the 8 verify rows of SPEC_K + 1
# tokens at phase 4's contexts; kernel 6 also with its 8 decode rows and
# the 512-token chunk live (17 rows: the wgmma route)
SPEC_VERIFY_CTX = [48, 3016, 916, 1516, 80, 2216, 416, 1117]
SPEC_LATENT_LAYOUT = ([1] * 8 + [512] + [SPEC_K + 1] * 8,
                      list(range(9)) + [520 + (SPEC_K + 1) * j
                                        for j in range(9)])
SPEC_LATENT_CTX = [4096, 3001, 1500, 65, 64, 1, 700, 2, 3000] + \
    SPEC_VERIFY_CTX


def spec_engine(state, cfg, draft, **kw):
    """A serving engine of phase 20, speculative with ``draft`` (a
    ``(state, config)``) or not (``None``)."""
    return Engine(state, cfg, device="cuda",
                  spec=None if draft is None else SpecConfig(*draft,
                                                             k=SPEC_K),
                  **kw)


def spec_warmup(eng, v):
    """Warm-up outside the measured run, which steps under every live mask
    of ``prefill_rows=1``: a 2-token request (a chunk step, then a
    decode-only step: its last token has nothing left to draft), then a
    short prompt beside a 3-chunk one (verify rows beside a chunk, then
    verify rows alone)."""
    rng = np.random.RandomState(1)
    eng.add_request(rng.randint(1, v, size=16).tolist(), 2)
    eng.run()
    eng.add_request(rng.randint(1, v, size=16).tolist(), 6)
    eng.add_request(rng.randint(1, v, size=1100).tolist(), 3)
    eng.run()


def pinned_compile_count(eng):
    """The graphs an engine captures under every live mask: one a chunk
    slot mask, in spec mode times the verify region's two states, plus
    the draft's propose graph."""
    r = eng.scheduler.prefill_rows
    return 2 ** (r + 1) + 1 if eng.spec is not None else 2 ** r


def count_verify_rows(eng, counter):
    """Wraps ``eng``'s step and verify commit to tally the verify rows,
    the steps that carry them and ``counter``'s launches in those steps,
    and the verify rows accepted whole or cut short (whose positions
    past the accepted ones hold stale KV under the rewound ``pos``);
    returns the tally."""
    run, commit = eng._run_unified, eng._commit_verify
    vbase = eng.n_rows - eng.scheduler.max_batch
    tally = dict.fromkeys(("verify_rows", "verify_steps",
                           "verify_step_kernel_launches",
                           "verify_rows_accepted_whole",
                           "verify_rows_cut_short"), 0)

    def counted_run(rows):
        n = sum(1 for _, _, row in rows if row >= vbase)
        before = counter.launches
        produced = run(rows)
        tally["verify_rows"] += n
        if n:
            tally["verify_steps"] += 1
            tally["verify_step_kernel_launches"] += \
                counter.launches - before
        return produced

    def counted_commit(req, accepted, bonus, t0, dt):
        whole = accepted == len(req.spec_drafts)
        tally["verify_rows_accepted_whole" if whole
              else "verify_rows_cut_short"] += 1
        return commit(req, accepted, bonus, t0, dt)

    eng._run_unified, eng._commit_verify = counted_run, counted_commit
    return tally


def first_differences(got, want):
    """``[(request, first position where the tokens differ)]``."""
    return [(i, next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                     min(len(g), len(w))))
            for i, (g, w) in enumerate(zip(got, want)) if g != w]


def dense_logits(state, cfg, prefix):
    """The next-token logits after ``prefix`` from a dense forward (the
    port's ``generate`` path: no pages, no kernels), fp32 ``[vocab]``."""
    dev = torch.device("cuda")
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    n = len(prefix)
    shapes = (((1, n, 1, cfg.kv_latent_dim), (1, n, 1, cfg.rope_dim))
              if cfg.is_mla else ((1, n, cfg.kv_heads, cfg.head_dim),) * 2)
    caches = [tuple(torch.zeros(s, dtype=dt, device=dev) for s in shapes)
              for _ in range(cfg.num_layers)]
    cos, sin = _rotary_tables(cfg, n, dev)
    with torch.no_grad():
        return decode_step(cfg, _Params(state, cfg, dev), torch.tensor(
            [prefix], dtype=torch.int32, device=dev), caches, 0, cos,
            sin)[0].float()


def tie_gaps(state, cfg, prefix, tokens):
    """How far below a dense forward's largest logit after ``prefix``
    each of ``tokens`` lies, and the three largest logits."""
    logits = dense_logits(state, cfg, prefix)
    top = torch.topk(logits, 3)
    return ([top.values[0].item() - logits[t].item() for t in tokens],
            {"top": top.indices.tolist(), "logits": top.values.tolist()})


def near_ties(state, cfg, prompts, got, want, diffs, what):
    """At each greedy request's first difference (``diffs``), where a dense
    forward over the common prefix puts the non-spec and the spec token:
    both within ``SPEC_TIE_LIMIT`` of its largest logit, or the phase
    fails.  The sampled request is held in fp32 and in (d)."""
    rows = []
    for i, j in diffs:
        if i == MIX_SAMPLED:
            continue
        gaps, top = tie_gaps(state, cfg, prompts[i] + want[i][:j],
                             (want[i][j], got[i][j]))
        rows.append({"request": i, "position": j, "non_spec": want[i][j],
                     "spec": got[i][j], "gap_non_spec": gaps[0],
                     "gap_spec": gaps[1], **top})
    over = [r for r in rows if not max(r["gap_non_spec"], r["gap_spec"])
            <= SPEC_TIE_LIMIT]
    if over:
        emit({"phase": "spec_decode_mismatch", "of": what,
              "first_differences": diffs, "over_tie_limit": over})
        raise AssertionError(f"{what}: spec tokens part from the non-spec "
                             f"engine's off a near tie (limit "
                             f"{SPEC_TIE_LIMIT}): {over}")
    return rows


def spec_run(state, cfg, draft, serve, counter, what,
             max_model_len=SPEC_MAX_MODEL_LEN, time_draft=True):
    """Traffic (``serve(eng)``, which returns its requests) on a fresh
    engine of ``cfg`` after ``spec_warmup``: its tokens and readings.
    The captured graphs are pinned (``pinned_compile_count``) after the
    warm-up and after the run, and ``counter``, the layout's attention
    kernel, must launch once a layer and unified step of the run, verify
    steps included.  ``time_draft`` times the draft's programs alone."""
    v = cfg.vocab_size
    eng = spec_engine(state, cfg, draft, num_pages=SPEC_PAGES[cfg.dtype],
                      page_size=64, max_batch=8, chunk_size=512,
                      prefill_rows=1, max_model_len=max_model_len)
    if eng.spec is not None and eng.spec.own_bytes:
        raise AssertionError(f"{what}: the draft uploaded "
                             f"{eng.spec.own_bytes} bytes of its own")
    t0 = time.perf_counter()
    spec_warmup(eng, v)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    pinned = pinned_compile_count(eng)
    if eng.compile_count != pinned:
        raise AssertionError(f"{what}: {eng.compile_count} graphs after the "
                             f"warm-up, not {pinned}")
    eng.reset_metrics()
    tally = count_verify_rows(eng, counter)
    counter.launches = 0
    wgmma = attention_kernel(eng) == LATENT_WGMMA_KERNEL
    if wgmma:
        counter.wgmma_launches = 0
    t0 = time.perf_counter()
    reqs = serve(eng)
    wall = time.perf_counter() - t0
    m = eng.metrics_summary()
    launches = counter.launches
    if launches != cfg.num_layers * eng.executable_calls or \
            tally["verify_step_kernel_launches"] != \
            cfg.num_layers * tally["verify_steps"]:
        raise AssertionError(f"{what}: {launches} attention launches in "
                             f"{eng.executable_calls} steps, {tally}")
    if wgmma and counter.wgmma_launches != launches:
        raise AssertionError(f"{what}: {counter.wgmma_launches} of "
                             f"{launches} latent launches on wgmma")
    if eng.compile_count != pinned or m["compile_count"] != pinned:
        raise AssertionError(f"{what}: compile_count {eng.compile_count} "
                             f"after the run, not {pinned}")
    toks = [r.out_tokens for r in reqs]
    if not all(len(r.out_tokens) == r.max_new_tokens and
               all(0 <= x < v for x in r.out_tokens) for r in reqs):
        raise AssertionError(f"{what}: a request did not finish with its "
                             f"new tokens in the vocabulary")
    out = {"tokens_per_s": sum(map(len, toks)) / wall, "wall_s": wall,
           "warmup_and_capture_s": warmup_s, "unified_steps":
           eng.executable_calls, "rows_a_step": eng.n_rows,
           "attention_kernel": attention_kernel(eng),
           "kernel_launches": launches,
           **({"wgmma_launches": counter.wgmma_launches} if wgmma else {}),
           "compile_count": eng.compile_count,
           "prefix_cache_hits": m["prefix_cache_hits"]}
    if eng.spec is not None:
        spec = eng.spec
        vrows = tally["verify_rows"]
        out.update({
            "spec_proposed": m["spec_proposed"],
            "spec_accepted": m["spec_accepted"],
            "spec_bonus_tokens": m["spec_bonus_tokens"],
            "accept_rate": m["spec_accept_rate"], **tally,
            "tokens_per_verify_row": (m["spec_accepted"] +
                                      m["spec_bonus_tokens"]) / max(vrows, 1),
            "draft_prefills": spec.prefills,
            "draft_proposals": spec.proposals,
            "draft_cache_bytes": sum(t.numel() * t.element_size()
                                     for t in spec._kc + spec._vc),
            "draft_own_weight_bytes": spec.own_bytes})
    if eng.spec is not None and time_draft:
        # the draft's programs alone: a propose over all 8 slots (the
        # captured graph's replay, host copy and read-back included) at
        # the run's final contexts, and one prefill at [1, max_model_len]
        ctx = np.minimum([len(r.tokens) for r in reqs],
                         max_model_len - SPEC_K - 1)
        ctx = np.resize(ctx, spec.S).astype(np.int32)
        a = np.stack([np.full(spec.S, 7), np.full(spec.S, 9), ctx - 2,
                      ctx - 1, np.ones(spec.S)]).astype(np.int32)
        out["draft_propose_ms"] = cuda_time_ms(
            lambda: spec.compiled["draft_propose"](*a).cpu(), warmup=2,
            iters=10)
        toks_l = torch.randint(1, v, (1, spec.Lmax), dtype=torch.int32,
                               device="cuda")
        out["draft_prefill_ms"] = cuda_time_ms(
            lambda: spec.compiled["draft_prefill"](toks_l), warmup=1,
            iters=10)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return toks, out


def spec_accepting(state, cfg, prompts, want, counter, what):
    """(d): the target as its own draft (``draft_state_from`` at all its
    layers: the same tensors) on ``SPEC_ACCEPT_REQUESTS`` of ``prompts``
    (phase 4's, the sampled one among them), all at once: their tokens
    equal the non-spec engine's (``want``, its first ``SPEC_ACCEPT_NEW``),
    with drafts accepted, verify rows accepted whole (multi-token commits
    and a bonus token past the last draft) and verify rows cut short
    (rewinds of ``pos`` over stale KV)."""
    def serve(eng):
        reqs = [add_mix_request(eng, i, prompts[i], SPEC_ACCEPT_NEW)
                for i in SPEC_ACCEPT_REQUESTS]
        eng.run()
        torch.cuda.synchronize()
        return reqs

    got, run = spec_run(state, cfg, draft_state_from(state, cfg,
                                                     cfg.num_layers),
                        serve, counter, f"{what}, accepting draft",
                        max_model_len=SPEC_ACCEPT_MAX_MODEL_LEN,
                        time_draft=False)
    ref = [want[i][:SPEC_ACCEPT_NEW] for i in SPEC_ACCEPT_REQUESTS]
    out = {"requests": list(SPEC_ACCEPT_REQUESTS),
           "new_tokens": SPEC_ACCEPT_NEW,
           "max_model_len": SPEC_ACCEPT_MAX_MODEL_LEN,
           "draft_layers": cfg.num_layers, "equal": got == ref, **run}
    if got != ref or not run["spec_accepted"] or \
            not run["verify_rows_accepted_whole"] or \
            not run["verify_rows_cut_short"]:
        emit({"phase": "spec_decode_mismatch", "of": f"{what}, accepting "
              f"draft", "first_differences": first_differences(got, ref),
              **out})
        raise AssertionError(f"{what}, accepting draft: tokens equal "
                             f"{got == ref}, readings {run}")
    return out


def spec_pair(cfg, mix, counter, what, accepting=False):
    """(a) and (b): phase 4's traffic through a non-spec engine, then a
    spec engine with a ``SPEC_DRAFT_LAYERS``-layer self-draft, on the same
    random weights (seed 0, uploaded once).  In fp32 (TF32 off) every
    request's tokens must be equal, at temperature 0 and the sampled one.
    In bf16 a greedy request's tokens may part only at a near tie
    (``near_ties``): the non-spec engine's own bf16 tokens change with
    the batching alone (ROADMAP §3 F5, ``tools/spec_divergence.py``).
    ``accepting`` adds (d) on the same weights (``spec_accepting``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    state = random_state(cfg, seed=0, device="cuda")
    draft = draft_state_from(state, cfg, SPEC_DRAFT_LAYERS)

    def serve(eng):
        return serve_mix(eng, *mix, new=SPEC_NEW_TOKENS)

    want, plain = spec_run(state, cfg, None, serve, counter, what)
    got, spec = spec_run(state, cfg, draft, serve, counter, what)
    diffs = first_differences(got, want)
    out = {"dtype": cfg.dtype, "non_spec": plain, "spec": spec,
           "equal": not diffs, "first_differences": diffs,
           "sampled_tokens": got[MIX_SAMPLED][:8]}
    if diffs and cfg.dtype == "float32":
        emit({"phase": "spec_decode_mismatch", "of": what,
              "first_differences": diffs,
              "spec_tokens": [got[i] for i, _ in diffs],
              "non_spec_tokens": [want[i] for i, _ in diffs]})
        raise AssertionError(f"{what}: spec tokens differ from the non-spec "
                             f"engine's at (request, position) {diffs}")
    if diffs:
        out["near_ties"] = near_ties(state, cfg, mix[0] + [mix[1]], got,
                                     want, diffs, what)
    if accepting:
        out["accepting_draft"] = spec_accepting(state, cfg, mix[0], want,
                                                counter, what)
    del state, draft
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_verify_kernel():
    """Kernel 5 against its plain version on a spec step's verify rows,
    with the time of the same tokens as decode rows (the decode core)."""
    k1 = SPEC_K + 1
    rows = {}
    layouts = {
        "verify_rows": ([0] * 9 + [k1] * 8, [0] * 9 + SPEC_VERIFY_CTX,
                        list(range(9)) + [520 + k1 * j for j in range(9)]),
        "as_decode_rows": ([1] * (8 * k1), [c - k1 + 1 + j for c in
                                           SPEC_VERIFY_CTX
                                           for j in range(k1)],
                           list(range(8 * k1 + 1)))}
    nh, kvh, hd, maxp = (RAGGED_SHAPES[k] for k in ("nh", "kvh", "hd",
                                                    "maxp"))
    for name, (q_lens, ctx_lens, cu) in layouts.items():
        args, cu_np, t = ragged_serving_batch(q_lens, ctx_lens, cu)
        max_q = max(k1, 512) if name == "verify_rows" else 1
        call = lambda: ragged_paged_attention_cuda(  # noqa: E731
            *args, max_q=max_q)
        got = call()
        torch.cuda.synchronize()
        want = ragged_paged_attention_reference(*args, max_q=max_q)
        ratios, err = bf16_agreement(got, want, cu_np, q_lens)
        if not max(ratios) <= 1.0:
            raise AssertionError(f"kernel 5 on the {name}: error over the "
                                 f"bf16 limit by {max(ratios)}")
        work = ragged_work(q_lens, ctx_lens, maxp, nh, kvh, hd, 2)
        rows[name] = {"rows": len(q_lens), "tokens": sum(q_lens),
                      "max_abs_err": err, "ms": cuda_time_ms(call, warmup=3,
                                                             iters=20),
                      "device_ms": graph_ms(call, iters=20),
                      "plain_ms": cuda_time_ms(
                          lambda: ragged_paged_attention_reference(
                              *args, max_q=max_q), warmup=1, iters=3),
                      "bound_ms": work["bound_ms"],
                      "bound_by": work["bound_by"]}
    return rows


def spec_verify_latent_kernel():
    """Kernel 6 against its plain version (phase 9's limit) at the MLA spec
    step's layout, bf16 pages on wgmma: 8 decode rows, the 512-token
    chunk and 8 verify rows of ``SPEC_K + 1`` tokens, ``max_q`` 512;
    timed whole and by part."""
    return latent_case("llama3_8b_mla/bf16/spec_step", 32, 512, 64, 128,
                       SPEC_LATENT_CTX, 128, 1024, "bf16", time_parts=True,
                       layout=SPEC_LATENT_LAYOUT)


def spec_narrow():
    """(c): chunks of 2 beside verify rows of SPEC_K + 1 tokens, at GPT-2
    small's widths (2 layers, fp32, TF32 off), the target as its own
    draft (every draft accepted): the spec engine's tokens equal the
    non-spec engine's and ``generate``'s, and a step that attends only
    ``chunk`` tokens a row (the planted fault) does not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(num_layers=SPEC_NARROW_LAYERS, dtype="float32")
    state = random_state(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in SPEC_NARROW_PROMPTS]
    want = [generate(state, cfg, [p], SPEC_NARROW_NEW,
                     device="cuda")[0, len(p):].tolist() for p in prompts]
    runs = {}
    for name in ("non_spec", "spec", "planted_max_q_of_chunk"):
        eng = spec_engine(state, cfg, None if name == "non_spec"
                          else (state, cfg), num_pages=64, page_size=16,
                          max_batch=4, chunk_size=SPEC_NARROW_CHUNK)
        if name == "planted_max_q_of_chunk":
            eng._step_fn.max_q = eng._step_fn.chunk
        ragged_paged_attention_cuda.launches = 0
        reqs = [eng.add_request(p, SPEC_NARROW_NEW) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        m = eng.metrics_summary()
        runs[name] = {"tokens": [r.out_tokens for r in reqs],
                      "max_q": eng._step_fn.max_q,
                      "kernel_launches": ragged_paged_attention_cuda.launches,
                      "unified_steps": eng.executable_calls,
                      "spec_accepted": m["spec_accepted"],
                      "compile_count": eng.compile_count}
        del eng
    del state
    gc.collect()
    torch.cuda.empty_cache()
    spec, plain = runs["spec"], runs["non_spec"]
    if spec["tokens"] != want or plain["tokens"] != want \
            or runs["planted_max_q_of_chunk"]["tokens"] == want \
            or spec["max_q"] != SPEC_K + 1 or not spec["spec_accepted"] \
            or spec["kernel_launches"] != cfg.num_layers * \
            spec["unified_steps"]:
        raise AssertionError(f"spec narrow chunks: {runs}, generate {want}")
    return {"chunk_size": SPEC_NARROW_CHUNK, "k": SPEC_K,
            "layers": SPEC_NARROW_LAYERS, "dtype": "float32",
            "equal_to_generate_and_non_spec": True,
            "planted_fault_differs": True,
            **{n: {k: r[k] for k in r if k != "tokens"}
               for n, r in runs.items()}}


def phase_spec_decode():
    """Phase 20: speculative decoding on the serving engine (see the module
    docstring)."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    mix = make_mix(rng, 128256, [32, 3000, 700, 1500, 64, 2200, 400],
                   header_len=1024, tail=200)
    full, mla = {}, {}
    for dtype in ("bfloat16", "float32"):
        cfg = llama3_8b_config(num_layers=SPEC_LAYERS, dtype=dtype)
        full[dtype] = spec_pair(cfg, mix, ragged_paged_attention_cuda,
                                f"spec_decode full head {dtype}",
                                accepting=dtype == "float32")
        note("spec_decode", "full_head", full[dtype])
        mla[dtype] = spec_pair(
            mla_config(cfg, kv_latent_dim=512, kv_rope_dim=64), mix,
            latent_ragged_paged_attention_cuda, f"spec_decode MLA {dtype}")
        note("spec_decode", "mla", mla[dtype])
    verify_kernel = spec_verify_kernel()
    latent_verify = spec_verify_latent_kernel()
    narrow = spec_narrow()
    accepted = sum(r["spec"]["spec_accepted"]
                   for r in list(full.values()) + list(mla.values())) + \
        narrow["spec"]["spec_accepted"]
    if not accepted:
        raise AssertionError("spec_decode: no draft was ever accepted")
    smi = smi_line()
    out = {"config": {"model": "Llama-3-8B widths, random weights (seed "
                               "0), bf16 then fp32", "layers": SPEC_LAYERS,
                      "k": SPEC_K,
                      "draft_layers": SPEC_DRAFT_LAYERS,
                      "max_model_len": SPEC_MAX_MODEL_LEN,
                      "new_tokens": SPEC_NEW_TOKENS,
                      "requests": len(mix[0]) + 1},
           "full_head": full, "verify_kernel": verify_kernel, "mla": mla,
           "latent_verify_kernel": latent_verify,
           "narrow_chunks": narrow, "nvidia_smi": smi,
           "wall_s": time.perf_counter() - t0}
    emit({"phase": "spec_decode", **out})
    return out


# ---------------------------------------------------------------------------
# the cluster and SLO plane (phase 21)
# ---------------------------------------------------------------------------

# phase 4's traffic (8 prompts, the late one, 32 new tokens each) holds
# about 9.8k tokens: 155 pages of 64 a pool, plus the trash page
CLUSTER_PAGES = 160
# the replicas' depth, cut as phase 20's (``SPEC_LAYERS``)
CLUSTER_LAYERS = 16
CLUSTER_MAX_MODEL_LEN = 4096
CLUSTER_NEW = 32
CLUSTER_SHAPE = dict(page_size=64, max_batch=8, chunk_size=512,
                     prefill_rows=1, max_model_len=CLUSTER_MAX_MODEL_LEN)
# (c): the replica killed after this many cluster steps of the run
CLUSTER_KILL_STEP = 8
# (d): a pool too small to keep the header cached past the other
# requests (the largest needs 48 pages), with the host tier under it
HOST_TIER_PAGES = 56
# (e): the JAX suite's autoscale trace (tests/test_slo.py _mixed_trace:
# 8 prompts of 4-11 tokens over the three classes, one arrival a clock
# step, 6 new tokens) after 10 idle steps, on a synthetic clock
AUTOSCALE = dict(min_replicas=1, backlog_high=4, backlog_low=0,
                 hysteresis_steps=2, cooldown_steps=3, ttft_target=None)
AUTOSCALE_IDLE_STEPS = 10
AUTOSCALE_NEW = 6


def cluster_engine_kw(num_pages=CLUSTER_PAGES):
    return dict(CLUSTER_SHAPE, num_pages=num_pages, device="cuda")


def drive(obj, each=None, limit=5000):
    """Steps an engine or cluster until it is idle, calling ``each`` after
    every step."""
    n = 0
    while obj.has_work:
        obj.step()
        if each is not None:
            each(obj)
        n += 1
        if n > limit:
            raise AssertionError("did not drain")


def serve_cluster_mix(cl, prompts, late_prompt, each=None):
    """``serve_mix`` through a cluster: phase 4's requests (one sampled),
    then the late prompt once the header's first user has finished."""
    reqs = [add_mix_request(cl, i, p, CLUSTER_NEW)
            for i, p in enumerate(prompts)]
    while not reqs[2].done:
        cl.step()
        if each is not None:
            each(cl)
    reqs.append(cl.add_request(late_prompt, CLUSTER_NEW))
    drive(cl, each)
    torch.cuda.synchronize()
    return reqs


def warm_replicas(cl, v):
    """Two short requests, one a replica (least loaded), each a chunk step
    then a decode-only step: every replica captures its two graphs."""
    rng = np.random.RandomState(2)
    for _ in cl.replicas:
        cl.add_request(rng.randint(1, v, size=16).tolist(), 2)
    drive(cl)
    torch.cuda.synchronize()


def launches_check(counter, calls, cfg, what):
    if counter.launches != cfg.num_layers * calls:
        raise AssertionError(f"{what}: {counter.launches} attention launches "
                             f"in {calls} unified steps of {cfg.num_layers} "
                             f"layers")


def mono_run(state, cfg, mix, counter, what):
    """Phase 4's traffic on one engine (warmed up first): its tokens and
    tokens/s."""
    eng = Engine(state, cfg, **cluster_engine_kw())
    eng.add_request(np.random.RandomState(2).randint(
        1, cfg.vocab_size, size=16).tolist(), 2)
    eng.run()
    torch.cuda.synchronize()
    calls0, counter.launches = eng.executable_calls, 0
    if cfg.is_mla:
        counter.wgmma_launches = 0
    t0 = time.perf_counter()
    reqs = serve_mix(eng, *mix, new=CLUSTER_NEW)
    wall = time.perf_counter() - t0
    launches_check(counter, eng.executable_calls - calls0, cfg, what)
    toks = [r.out_tokens for r in reqs]
    out = {"tokens_per_s": sum(map(len, toks)) / wall, "wall_s": wall,
           "unified_steps": eng.executable_calls - calls0,
           "kernel_launches": counter.launches,
           **({"wgmma_launches": counter.wgmma_launches} if cfg.is_mla
              else {})}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return toks, out


def fleet_run(state, cfg, mix, counter, what, replicas=2, mode="replicated",
              kill_at=None, tracer=None, inspect=None, **kw):
    """Phase 4's traffic through an ``EngineCluster`` of ``replicas`` on
    one card (warmed up first, every replica's graphs then pinned in
    replicated mode): tokens and readings, with ``inspect(cluster)``'s
    readings merged in.  ``kill_at``: the replica killed after that many
    steps of the run, with ``check_cluster_invariants`` after every step.
    The peak memory counts from the weights alone: what earlier runs
    held is freed first."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cl = EngineCluster(state, cfg, num_replicas=replicas, mode=mode,
                       coordinator=False, tracer=tracer,
                       **cluster_engine_kw(), **kw)
    for r in cl.replicas:          # the cluster's own events only
        r.engine.set_tracer(None)
    pool_bytes = [r.engine.pool.page_bytes * r.engine.pool.num_pages
                  for r in cl.replicas]
    if mode == "replicated":
        warm_replicas(cl, cfg.vocab_size)
        graphs = [r.engine.compile_count for r in cl.replicas]
        if graphs != [2] * replicas:
            raise AssertionError(f"{what}: graphs per pool {graphs} after "
                                 f"the warm-up, not 2 each")
    calls0 = [r.engine.executable_calls for r in cl.replicas]
    counter.launches = 0
    steps = [0]

    def each(c):
        steps[0] += 1
        if kill_at is not None:
            check_cluster_invariants(c)
            if steps[0] == kill_at:
                c.kill_replica(1)

    t0 = time.perf_counter()
    reqs = serve_cluster_mix(cl, *mix, each=each)
    wall = time.perf_counter() - t0
    calls = sum(r.engine.executable_calls - c
                for r, c in zip(cl.replicas, calls0))
    launches_check(counter, calls, cfg, what)
    if mode == "replicated" and kill_at is None:
        graphs_after = [r.engine.compile_count for r in cl.replicas]
        if graphs_after != graphs:
            raise AssertionError(f"{what}: graphs per pool {graphs} -> "
                                 f"{graphs_after} over the run")
    if not {r.req_id for r in reqs} <= set(cl.finished) or cl.shed or \
            not all(len(r.out_tokens) == CLUSTER_NEW for r in reqs):
        raise AssertionError(f"{what}: the completed set is not whole")
    ms = cl.metrics_summary()
    toks = [r.out_tokens for r in reqs]
    out = {"replicas": replicas, "mode": mode,
           "tokens_per_s": sum(map(len, toks)) / wall, "wall_s": wall,
           "unified_steps": calls, "kernel_launches": counter.launches,
           "cluster_steps": steps[0],
           "req_ids": [r.req_id for r in reqs],
           "placement": [r.replica for r in reqs],
           "prefill_replica": [r.prefill_replica for r in reqs],
           "rerouted": [r.req_id for r in reqs if r.n_reroutes],
           "graphs_per_pool": [r.engine.compile_count for r in cl.replicas],
           "step_graphs": cl.replicas[0].engine._step_fn.compile_count,
           "pool_bytes": pool_bytes,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "peak_over_weights_bytes":
               torch.cuda.max_memory_allocated() - before,
           "prefix_cache_hits": ms["prefix_cache_hits"],
           "replica_deaths": ms["replica_deaths"],
           "requests_rerouted": ms["requests_rerouted"],
           "handoffs": ms["cluster_handoffs"],
           "preemptions": ms["preemptions"],
           **(inspect(cl) if inspect is not None else {})}
    cl.close()
    del cl
    gc.collect()
    torch.cuda.empty_cache()
    return toks, out


def route_decisions(tracer):
    return [{k: e.attrs[k] for k in ("req", "replica", "reason",
                                     "matched_pages")}
            for e in tracer.events() if e.name == "route"]


def tokens_rule(state, cfg, mix, got, want, what):
    """fp32 tokens equal, the sampled request's too; bf16 greedy tokens
    parting only at near ties, held in exact arithmetic: at each greedy
    request's first difference an fp32 forward of the same weights (TF32
    off) over the common prefix puts both tokens within
    ``SPEC_TIE_LIMIT`` of its largest logit (the dense bf16 forward's
    gaps printed beside it; the sampled request is held in fp32).  The
    bf16 forward is no judge here: its own rounding moved a pair's gap
    by 0.11 against the fp32 forward's (``tools/cluster_divergence.py``,
    PERF.md).  Returns the differences, read."""
    diffs = first_differences(got, want)
    if diffs and cfg.dtype == "float32":
        emit({"phase": "cluster_mismatch", "of": what,
              "first_differences": diffs})
        raise AssertionError(f"{what}: tokens differ from the monolithic "
                             f"engine's at (request, position) {diffs}")
    out = {"equal": not diffs, "first_differences": diffs,
           "tokens_differing": sum(a != b for g, w in zip(got, want)
                                   for a, b in zip(g, w))}
    if not diffs:
        return out
    exact = ({k: v.float() for k, v in state.items()},
             dataclasses.replace(cfg, dtype="float32"))
    prompts = mix[0] + [mix[1]]
    rows = []
    for i, j in diffs:
        if i == MIX_SAMPLED:
            continue
        prefix, toks = prompts[i] + want[i][:j], (want[i][j], got[i][j])
        gaps, top = tie_gaps(*exact, prefix, toks)
        bf16_gaps, bf16_top = tie_gaps(state, cfg, prefix, toks)
        rows.append({"request": i, "position": j, "monolithic": toks[0],
                     "other": toks[1], "fp32_gap_monolithic": gaps[0],
                     "fp32_gap_other": gaps[1], "fp32_top": top["top"],
                     "bf16_gap_monolithic": bf16_gaps[0],
                     "bf16_gap_other": bf16_gaps[1]})
    del exact
    gc.collect()
    torch.cuda.empty_cache()
    out["near_ties"] = rows
    over = [r for r in rows if not max(r["fp32_gap_monolithic"],
                                       r["fp32_gap_other"]) <= SPEC_TIE_LIMIT]
    if over:
        emit({"phase": "cluster_mismatch", "of": what,
              "first_differences": diffs, "over_tie_limit": over})
        raise AssertionError(f"{what}: tokens part from the monolithic "
                             f"engine's off a near tie (limit "
                             f"{SPEC_TIE_LIMIT}): {over}")
    return out


def cluster_replicated(cfg, mix):
    """(a) for one dtype, and in fp32 (b), (c) and (e) on the same
    weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    counter = ragged_paged_attention_cuda
    state = random_state(cfg, seed=0, device="cuda")
    weight_bytes = sum(t.numel() * t.element_size() for t in state.values())
    what = f"cluster {cfg.dtype}"
    want, mono = mono_run(state, cfg, mix, counter, f"{what} monolithic")
    out = {"dtype": cfg.dtype, "weight_bytes": weight_bytes,
           "monolithic": mono}
    fp32 = cfg.dtype == "float32"
    # one replica batches as the monolithic engine does: its tokens are
    # the engine's exactly, in either type
    got_1, one = fleet_run(state, cfg, mix, counter, f"{what}, 1 replica",
                           replicas=1)
    one["tokens_equal"] = got_1 == want
    out["one_replica"] = one
    note("cluster", "one replica", one)
    if got_1 != want:
        raise AssertionError(f"{what}, 1 replica: tokens differ from the "
                             f"monolithic engine's at "
                             f"{first_differences(got_1, want)}")
    tracer = SpanTracer()
    got, two = fleet_run(state, cfg, mix, counter, f"{what}, 2 replicas",
                         tracer=tracer, policy="prefix")
    two["router_decisions"] = route_decisions(tracer)
    header_users = (two["req_ids"][2], two["req_ids"][-1])
    if two["placement"][2] != two["placement"][-1] or \
            two["prefix_cache_hits"] < 1:
        raise AssertionError(f"{what}: the header's users {header_users} "
                             f"landed on {two['placement']}, cache hits "
                             f"{two['prefix_cache_hits']}")
    late = next(d for d in two["router_decisions"]
                if d["req"] == two["req_ids"][-1])
    if late["reason"] != "prefix_hit" or late["matched_pages"] < 16:
        raise AssertionError(f"{what}: the late prompt's route {late}")
    two["tokens"] = tokens_rule(state, cfg, mix, got, want, what)
    out["two_replicas"] = two
    grow = two["peak_memory_bytes"] - one["peak_memory_bytes"]
    out["peak_memory_two_minus_one_bytes"] = grow
    if not grow < weight_bytes:
        raise AssertionError(f"{what}: a second replica added {grow} bytes "
                             f"of peak memory, a weight copy is "
                             f"{weight_bytes}")
    if fp32:
        out["disaggregated"] = cluster_disaggregated(state, cfg, mix, want,
                                                     counter)
        note("cluster", "disaggregated", out["disaggregated"])
        got_k, kill = fleet_run(state, cfg, mix, counter,
                                f"{what}, killed replica",
                                kill_at=CLUSTER_KILL_STEP, policy="prefix")
        if kill["replica_deaths"] != 1 or not kill["rerouted"] or \
                got_k != want:
            raise AssertionError(f"{what}, killed replica: deaths "
                                 f"{kill['replica_deaths']}, re-routed "
                                 f"{kill['rerouted']}, tokens equal "
                                 f"{got_k == want}")
        kill["tokens_equal"] = True
        out["killed_replica"] = kill
        note("cluster", "killed replica", kill)
        out["autoscaler"] = cluster_autoscale(state, cfg, counter)
        note("cluster", "autoscaler", out["autoscaler"])
    launches = sum(r["kernel_launches"] for r in (
        mono, one, two, *([out["disaggregated"], out["killed_replica"]]
                          if fp32 else [])))
    if fp32:
        launches += out["autoscaler"]["kernel_launches"]
    out["kernel_launches"] = launches
    return state, out


def cluster_disaggregated(state, cfg, mix, want, counter):
    """(b): 1 prefill and 1 decode replica: every request's pages through
    the ``LocalPageTransport`` (its H100 model's ``predicted_s`` beside the
    measured ``wall_s``), every request adopted by the decode replica,
    tokens equal to the monolithic engine's."""
    what = "cluster disaggregated float32"

    def inspect(cl):
        recs = cl.transport.records
        return {"adoptions": [a["dst"] for a in cl._adoptions],
                "total_payload_bytes": cl.transport.total_payload_bytes,
                "total_wall_s": sum(r["wall_s"] for r in recs),
                "total_predicted_s": cl.transport.total_predicted_s,
                "model": cl.transport.cluster_spec.chip.name,
                "records": [{k: r[k] for k in ("src", "dst", "pages",
                                               "payload_bytes", "wall_s",
                                               "predicted_s", "epoch")}
                            for r in recs]}

    got, out = fleet_run(state, cfg, mix, counter, what,
                         mode="disaggregated", num_prefill=1,
                         inspect=inspect)
    n = len(mix[0]) + 1
    if got != want or out["handoffs"] != n or \
            out["adoptions"] != [1] * n or len(out["records"]) != n:
        raise AssertionError(f"{what}: tokens equal {got == want}, handoffs "
                             f"{out['handoffs']}, adoptions "
                             f"{out['adoptions']}")
    out["tokens_equal"] = True
    return out


def _mixed_trace(rng, n):
    out = []
    for i in range(n):
        size = int(rng.randint(4, 12))
        cls = SLO_CLASSES[int(rng.randint(3))]
        out.append(([int(t) for t in rng.randint(1, 90, size=size)],
                    cls, float(i)))
    return out


def autoscale_run(state, cfg, counter, autoscaler):
    """(e)'s trace on 2 replicas, on a synthetic clock (one unit a
    step), with ``autoscaler`` or a static fleet (``None``)."""
    clock = [0.0]
    cl = EngineCluster(state, cfg, num_replicas=2, coordinator=False,
                       policy="load", max_queue_depth=2,
                       autoscaler=autoscaler, time_fn=lambda: clock[0],
                       **cluster_engine_kw())
    trace = _mixed_trace(np.random.RandomState(11), 8)
    states = []

    def each(c):
        clock[0] += 1.0
        check_cluster_invariants(c)
        states.append([(r.alive, r.draining) for r in c.replicas])

    calls0 = [r.engine.executable_calls for r in cl.replicas]
    counter.launches = 0
    for _ in range(AUTOSCALE_IDLE_STEPS):
        cl.step()
        each(cl)
    t0 = clock[0]
    reqs = [cl.add_request(p, AUTOSCALE_NEW, arrival_time=t0 + arr,
                           slo_class=c) for p, c, arr in trace]
    drive(cl, each)
    torch.cuda.synchronize()
    calls = sum(r.engine.executable_calls - c
                for r, c in zip(cl.replicas, calls0))
    launches_check(counter, calls, cfg, "cluster autoscaler")
    ms = cl.metrics_summary()
    cl.close()
    active = [sum(a and not d for a, d in s) for s in states]
    return [r.out_tokens for r in reqs], {
        "scale_ups": ms["scale_ups"], "scale_downs": ms["scale_downs"],
        "class_inversions": ms["class_inversions"],
        "requests": len(reqs), "steps": len(states),
        "active_replicas_by_step": active,
        "unified_steps": calls, "kernel_launches": counter.launches}


def cluster_autoscale(state, cfg, counter):
    """(e): the autoscaler takes the fleet from 2 to 1 replica on the idle
    window and back to 2 under the trace; tokens equal a static fleet's,
    no class inversion."""
    got, auto = autoscale_run(state, cfg, counter, Autoscaler(**AUTOSCALE))
    want, static = autoscale_run(state, cfg, counter, None)
    if got != want or auto["scale_ups"] < 1 or auto["scale_downs"] < 1 or \
            auto["class_inversions"] or static["scale_ups"] or \
            static["scale_downs"]:
        raise AssertionError(f"cluster autoscaler: tokens equal "
                             f"{got == want}, {auto}, static {static}")
    auto["tokens_equal_static_fleet"] = True
    auto["kernel_launches"] += static["kernel_launches"]
    auto["static_fleet"] = static
    return auto


def host_tier_run(state, cfg, mix, counter, what):
    """(d): phase 4's traffic on one bf16 engine whose pool
    (``HOST_TIER_PAGES``) cannot keep the header cached, over a host tier:
    the header's pages go to the host and come back for the late prompt;
    tokens against an engine whose pool evicts nothing, by (a)'s rule.
    In the MLA layout every launch of both engines is on wgmma."""
    want, ref = mono_run(state, cfg, mix, counter, f"{what} reference")
    eng = Engine(state, cfg, host_tier=True,
                 **cluster_engine_kw(HOST_TIER_PAGES))
    counter.launches = 0
    wgmma = attention_kernel(eng) == LATENT_WGMMA_KERNEL
    if cfg.is_mla:
        counter.wgmma_launches = 0
    t0 = time.perf_counter()
    reqs = serve_mix(eng, *mix, new=CLUSTER_NEW)
    wall = time.perf_counter() - t0
    launches_check(counter, eng.executable_calls, cfg, what)
    if cfg.is_mla and (not wgmma or
                       counter.wgmma_launches != counter.launches or
                       ref["wgmma_launches"] != ref["kernel_launches"]):
        raise AssertionError(f"{what}: {counter.wgmma_launches} of "
                             f"{counter.launches} latent launches on wgmma, "
                             f"the reference's {ref['wgmma_launches']} of "
                             f"{ref['kernel_launches']}")
    ht_ = eng.host_tier
    recs = ht_.records
    refetch = [r for r in recs if r["dir"] == "refetch"]
    header_pages = 1024 // CLUSTER_SHAPE["page_size"]
    late = reqs[-1]
    if len(refetch) < header_pages or late.cached_tokens < 1024:
        raise AssertionError(f"{what}: {len(refetch)} pages refetched, the "
                             f"late prompt started at {late.cached_tokens} "
                             f"cached tokens")
    out = {"pool_pages": HOST_TIER_PAGES,
           "pool_bytes": eng.pool.page_bytes * eng.pool.num_pages,
           "page_bytes": eng.pool.page_bytes,
           "attention_kernel": attention_kernel(eng),
           "reference": ref, "wall_s": wall,
           "tokens_per_s": sum(len(r.out_tokens) for r in reqs) / wall,
           "unified_steps": eng.executable_calls,
           "kernel_launches": counter.launches + ref["kernel_launches"],
           **({"wgmma_launches": counter.wgmma_launches +
               ref["wgmma_launches"]} if wgmma else {}),
           "preemptions": eng.counters["preemptions"].value,
           "evicted_pages": ht_.evictions, "refetched_pages": ht_.hits,
           "refetch_bytes": ht_.refetch_bytes,
           "late_prompt_cached_tokens": late.cached_tokens,
           "model": ht_.transport.cluster_spec.chip.name,
           "evict": {"records": sum(r["dir"] == "evict" for r in recs),
                     "wall_s": sum(r["wall_s"] for r in recs
                                   if r["dir"] == "evict"),
                     "predicted_s": ht_.predicted_s("evict")},
           "refetch_records": [{k: r[k] for k in ("pages", "payload_bytes",
                                                  "wall_s", "predicted_s")}
                               for r in refetch]}
    out["tokens"] = tokens_rule(state, cfg, mix,
                                [r.out_tokens for r in reqs], want, what)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_cluster():
    """Phase 21: the cluster and SLO plane (see the module docstring)."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    mix = make_mix(rng, 128256, [32, 3000, 700, 1500, 64, 2200, 400],
                   header_len=1024, tail=200)
    replicated, state = {}, None
    for dtype in ("float32", "bfloat16"):
        cfg = llama3_8b_config(num_layers=CLUSTER_LAYERS, dtype=dtype)
        state = None                    # one dtype's weights at a time
        gc.collect()
        torch.cuda.empty_cache()
        state, replicated[dtype] = cluster_replicated(cfg, mix)
        note("cluster", dtype, {k: v for k, v in replicated[dtype].items()
                                if k in ("monolithic", "two_replicas")})
    host = {"full_head": host_tier_run(state, cfg, mix,
                                       ragged_paged_attention_cuda,
                                       "host tier full head bf16")}
    note("cluster", "host tier full head", host["full_head"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    mla = mla_config(cfg, kv_latent_dim=512, kv_rope_dim=64)
    state = random_state(mla, seed=0, device="cuda")
    host["mla"] = host_tier_run(state, mla, mix,
                                latent_ragged_paged_attention_cuda,
                                "host tier MLA bf16")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out = {"config": {"model": "Llama-3-8B widths, random weights (seed "
                               "0), fp32 (TF32 off) then bf16",
                      "layers": CLUSTER_LAYERS,
                      "requests": len(mix[0]) + 1,
                      "new_tokens": CLUSTER_NEW,
                      "pool_pages": CLUSTER_PAGES, **CLUSTER_SHAPE},
           "replicated": replicated, "host_tier": host,
           "nvidia_smi": smi_line(),
           "wall_s": time.perf_counter() - t0}
    emit({"phase": "cluster", **out})
    return out


# ---------------------------------------------------------------------------
# the multi-GPU mesh (phase 22)
# ---------------------------------------------------------------------------

# ranks of phase 22's group (two processes on the one card, over gloo)
MESH_RANKS = 2
# seconds a collective of the ranks may take, and the whole group
MESH_COLLECTIVE_TIMEOUT = 300.0
MESH_GROUP_TIMEOUT = 900.0
# (b) and (c): a rank's losses against the one-process run, at every
# step (``mesh_loss_gaps``).  (b)'s are bf16 numbers in both runs (one
# loss path), so they are equal or whole bf16 spacings apart
# (``bf16_steps``): at most one, and none at step 1 (the same weights
# and batch).  (c)'s LLaMA carries fp32 activations after layer 0 (its
# fp32 rotary tables), so its losses are fp32: a relative gap, which
# stays meaningful as the memorised batch's loss nears 0.
MESH_LOSS_LIMITS = {"gpt2_small_bf16": ("bf16_steps", 1),
                    "llama3_8b_2_layers": ("relative", 2e-2),
                    "llama3_8b_switch": ("relative", 2e-2),
                    "llama3_8b_cp_8192": ("relative", 2e-2),
                    "mixtral_1_layer": ("relative", 2e-2)}
MESH_ENV_JOB = "HETU_MESH_JOB"


def bf16_steps(a, b):
    """``|a - b|`` in units of the bf16 spacing at the larger of the two
    magnitudes (0.0625 from 8 to 16): 1.0 for neighbouring bf16
    numbers."""
    m = max(abs(a), abs(b))
    if m == 0:
        return 0.0
    return float(abs(a - b) / 2.0 ** (np.floor(np.log2(m)) - 7))


def mesh_loss_gaps(name, losses, ref_losses):
    """(b) and (c)'s losses against one process's: (unit, limit, the gap
    at each step, whether they hold ``MESH_LOSS_LIMITS``)."""
    unit, limit = MESH_LOSS_LIMITS[name]
    gaps = [bf16_steps(a, b) if unit == "bf16_steps" else
            abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    ok = bool(max(gaps) <= limit and
              (unit != "bf16_steps" or gaps[0] == 0))
    return unit, limit, gaps, ok


def mesh_config(name):
    """A phase-22 configuration: the model's config fields, global batch,
    seq, steps, lr and micro-batches, and a switched one's switches
    (plain data: the ranks get it in their job file)."""
    extra = {}
    if name == "gpt2_fp32_2_layers":            # (a): phase 8's limits
        cfg, batch, seq, steps, lr, micro = (
            GPTConfig(vocab_size=50304, num_layers=2, dtype="float32"), 4,
            256, ORACLE_STEPS, ORACLE_LR, 2)
    elif name == "gpt2_small_bf16":             # (b), the entry's widths
        cfg, batch, seq, steps, lr, micro = (
            GPTConfig(vocab_size=50304, dtype="bfloat16"), 8, 1024, 3,
            3e-4, 2)
    elif name == "llama3_8b_2_layers":          # (c)
        cfg, batch, seq, steps, lr, micro = (
            llama3_8b_config(num_layers=2), 2, 4096, 3, 3e-4, 1)
    elif name == "gpt2_fp32_b8_switch":         # phase 25 (a)
        cfg, batch, seq, steps, lr, micro = (
            GPTConfig(vocab_size=50304, num_layers=2, dtype="float32"), 8,
            256, SWITCH_STEPS, ORACLE_LR, 2)
    elif name == "llama3_8b_switch":            # (c), phase 25 (b)
        cfg, batch, seq, steps, lr, micro = (
            llama3_8b_config(num_layers=2), 2, 4096, 4, 3e-4, 1)
        extra["switches"] = SWITCH_FULL[4]
    elif name == "gpt2_moe_fp32_2_layers":      # phase 26 (d)
        cfg, batch, seq, steps, lr, micro = (
            GPTConfig(vocab_size=50304, num_layers=2, dtype="float32",
                      num_experts=8, moe_top_k=2, ep_axis="ep"), 4, 256, 2,
            ORACLE_LR, 2)
    elif name == "mixtral_1_layer":             # phase 26 (d)
        cfg, batch, seq, steps, lr, micro = (
            mixtral_config(num_layers=1, ep_axis="ep"), 1, 1024, 1, 3e-4,
            1)
    elif name == "llama3_8b_cp_8192":           # phase 24 (b)
        cfg, batch, seq, steps, lr, micro = (
            llama3_8b_config(num_layers=2), 1, CP_SEQ, 2, 3e-4, 1)
    else:
        raise ValueError(name)
    return {"name": name, "cfg": dataclasses.asdict(cfg), "batch": batch,
            "seq": seq, "steps": steps, "lr": lr, "micro": micro, **extra}


# (a) fp32 layouts, (b) bf16 at GPT-2 small, (c) Llama-3-8B widths:
# (name, config, mesh, sp, optimizer options)
MESH_CASES = [
    ("dp2", "gpt2_fp32_2_layers", {"dp": 2}, False, {}),
    ("dp2_zero1", "gpt2_fp32_2_layers", {"dp": 2}, False, {"zero": 1}),
    ("dp2_zero2", "gpt2_fp32_2_layers", {"dp": 2}, False, {"zero": 2}),
    ("dp2_zero3", "gpt2_fp32_2_layers", {"dp": 2}, False, {"zero": 3}),
    ("tp2", "gpt2_fp32_2_layers", {"tp": 2}, False, {}),
    ("tp2_sp", "gpt2_fp32_2_layers", {"tp": 2}, True, {}),
    ("dp2_flat_fp32", "gpt2_fp32_2_layers", {"dp": 2}, False,
     {"zero": 2, "grad_comm": "fp32", "flat_state": True}),
    ("dp2_zero2", "gpt2_small_bf16", {"dp": 2}, False, {"zero": 2}),
    ("tp2_sp", "gpt2_small_bf16", {"tp": 2}, True, {}),
    # (c), which phase 25 (b) reads too: tp 2 sp for 2 steps, then a hot
    # switch to dp 2 under ZeRO-2 for 2 more (``SWITCH_FULL``)
    ("tp2_sp_to_dp2_zero2", "llama3_8b_switch", {"tp": 2}, True,
     {"zero": 2}),
]


def mesh_train(spec, mesh=None, sp=False, opt_kw=None, weights=False,
               init_state=None, batch_xy=None):
    """A ``mesh_config`` trained from the seed-0 init on one seeded batch,
    on ``mesh`` or in one process: losses, ms a step (steps 2 on), the
    run's flash launches by wrapper and route, the collectives
    (``comm_stats``, also counted by kind, tag and axis), and with
    ``weights`` the initial and final global weights (numpy, fp32, under
    the plain model's normalised names).  A spec with ``"pipeline"``
    builds ``GPTPipelineModel`` with the mesh's pp stages (1 without one),
    its ``micro`` micro-batches running through the pipeline;
    ``init_state`` (plain names) replaces the seed-0 init, ``batch_xy``
    (ids, labels) the seeded batch.  A spec's ``"switches"`` (``{"after":
    step, "mesh": shape, "ranks": ranks or None}``) hot-switch the graph
    and the optimizer on a mesh run (``switch_strategy``; the one-process
    run takes none): each is read in ``switches`` (wall, the profile, the
    rank's sent, received and staged bytes, its peak memory across the
    switch), the flash launches and ms a step of each layout in
    ``segments``; a rank outside a mesh takes no step (its loss None)."""
    from hetu_tpu_torch.models.convert import (load_state, pipeline_state,
                                               plain_state)
    from hetu_tpu_torch.models.gpt_pipeline import GPTPipelineModel
    from hetu_tpu_torch.parallel import P, comm, create_mesh
    t_case = time.perf_counter()
    name = spec["name"]
    switch_list = spec.get("switches", [])
    cfg_kw = {**spec["cfg"], "sp": sp}
    if mesh is None or cfg_kw.get("cp_axis") not in mesh.axis_names:
        # the one-process run of a context-parallel case
        cfg_kw["cp_axis"] = None
    cfg = GPTConfig(**cfg_kw)
    batch, seq, steps = spec["batch"], spec["seq"], spec["steps"]
    lr, micro = spec["lr"], spec["micro"]
    piped = spec.get("pipeline", False)
    stages = mesh.axis_size("pp") if piped and mesh is not None else 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = P("dp", None) if mesh is not None else None
    with ht.graph("define_and_run", create_new=True, mesh=mesh, seed=0,
                  device=mesh.device if mesh is not None else "cuda") as g:
        ids = ht.parallel_placeholder("int32", (batch, seq), pspec=spec)
        labels = ht.parallel_placeholder("int32", (batch, seq), pspec=spec)
        if piped:
            model = GPTPipelineModel(cfg, num_stages=stages)
            loss = model(ids, labels, num_micro_batches=micro)
        else:
            model = GPTLMHeadModel(cfg)
            loss = model(ids, labels)
        opt = ht.optim.AdamOptimizer(lr=lr, **(opt_kw or {}))
        train_op = opt.minimize(loss)
    g.run([], run_level="alloc")
    if init_state is not None:
        if piped:
            model.load_state_dict(pipeline_state(init_state, cfg, stages))
        else:
            load_state(model, init_state)

    def gathered():
        got = {n: g.global_value(p).float().cpu().numpy().copy()
               for n, p in model.named_parameters()}
        return plain_state(got, cfg) if piped else \
            {_Params._norm(n): v for n, v in got.items()}
    init = gathered() if weights else None
    x, y = batch_xy if batch_xy is not None else \
        seeded_batch(cfg.vocab_size, batch, seq, seed=2)
    switches = {s_["after"]: s_ for s_ in switch_list} \
        if mesh is not None else {}
    reset_flash_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, done, segments = [], [], [], []

    def segment(first):
        """The flash launches and ms a step since the last boundary."""
        now = flash_counts()
        prev = segments[-1]["_counts"] if segments else None
        launches = {k: {"launches": v["launches"] - (
            prev[k]["launches"] if prev else 0), "by_route": {
                r: n - (prev[k]["by_route"][r] if prev else 0)
                for r, n in v["by_route"].items()}}
            for k, v in now.items()}
        times = [t for t in step_s[first:] if t is not None]
        segments.append({"mesh": dict(g.mesh.shape) if g.mesh is not None
                         else None, "ranks": list(g.mesh.ranks)
                         if g.mesh is not None else None,
                         "in_mesh": g.mesh is None or g.mesh.in_mesh,
                         "steps": len(step_s) - first, "flash": launches,
                         "ms_per_step": 1e3 * float(np.mean(
                             times[1:] or times)) if times else None,
                         "_counts": now})
    with comm.comm_stats() as st:
        first = 0
        for i in range(steps):
            sw = switches.get(i)
            if sw is not None:
                segment(first)
                first = i
                new = create_mesh(sw["mesh"], device=mesh.device,
                                  ranks=sw.get("ranks"))
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                prof = g.switch_strategy(new, optimizer=opt)
                torch.cuda.synchronize()
                done.append({"after": i, "mesh": sw["mesh"],
                             "ranks": list(new.ranks),
                             "wall_s": time.perf_counter() - t,
                             "profile": prof.as_dict(),
                             "sent_bytes": prof.sent_bytes,
                             "recv_bytes": prof.recv_bytes,
                             "staged_bytes": prof.staged_bytes,
                             "memory_before_bytes": before,
                             "memory_after_bytes":
                             torch.cuda.memory_allocated(),
                             "peak_memory_bytes":
                             torch.cuda.max_memory_allocated(),
                             "strategy": g.cur_strategy_id})
            if g.mesh is not None and not g.mesh.in_mesh:
                losses.append(None)
                step_s.append(None)
                continue
            torch.cuda.synchronize()
            t = time.perf_counter()
            l, _ = g.run(loss, [loss, train_op], {ids: x, labels: y},
                         num_micro_batches=1 if piped else micro)
            losses.append(float(l))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
        if switches:
            segment(first)
    held = [t for t in step_s if t is not None]
    out = {"config": name, "dtype": cfg.dtype, "global_batch": batch,
           "seq": seq, "steps": steps, "micro_batches": micro, "lr": lr,
           "losses": losses, "step_s": step_s,
           "ms_per_step": 1e3 * float(np.mean(held[1:] or held))
           if held else None,
           "captured": g.last_run_captured, "compile_count": g.compile_count,
           "captures_total": g.captures_total,
           "num_params": sum(int(np.prod(p.global_shape or p.shape))
                             for _, p in model.named_parameters()),
           "flash": flash_counts(), "comm": st.summary(),
           "comm_by_tag": comm_by_tag(st.records),
           "comm_bytes_by_tag": comm_by_tag(st.records, nbytes=True),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if switches:
        for seg in segments:
            seg.pop("_counts")
        out.update(switches=done, segments=segments,
                   holds_final=g.mesh.in_mesh and
                   g.mesh.rank == g.mesh.ranks[0])
    if weights and (g.mesh is None or g.mesh.in_mesh):
        out["init"], out["final"] = init, gathered()
    out["case_wall_s"] = time.perf_counter() - t_case
    del g, model, ids, labels, loss, train_op, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def comm_by_tag(records, nbytes=False):
    """Collective records counted (or with ``nbytes`` their payload bytes
    summed) by ``kind|tag|axis``, and whether staged."""
    out = {}
    for r in records:
        key = f"{r.kind}|{r.tag}|{r.axis}" + ("|staged" if r.staged else "")
        out[key] = out.get(key, 0) + (r.payload_bytes if nbytes else 1)
    return out


def mesh_flash_want(cfg, seq, steps, micro):
    """A rank's flash launches over a run: every layer once a micro-batch
    and step, the backward by the byte rule on the first layer's k (fp32
    for an fp32 model and for the LLaMA path, whose fp32 rotary tables
    promote q/k)."""
    k_dtype = torch.float32 if cfg.position == "rotary" or \
        cfg.dtype == "float32" else torch.bfloat16
    fused = fa._use_fused(seq, cfg.head_dim, k_dtype)
    each = cfg.num_layers * micro * steps
    return {"flash_fwd": each, "flash_bwd_fused": each if fused else 0,
            "flash_bwd_dq": 0 if fused else each,
            "flash_bwd_dkv": 0 if fused else each}


def mesh_rank_main(extra=None):
    """One rank of phase 22's group (run by the port's ``Launcher``): joins
    through ``rpc.distributed_init``, builds each configuration of the job
    on its mesh in turn, writes its readings; ``extra(job)``'s readings
    follow them (phase 24's ring checks)."""
    from hetu_tpu_torch.parallel import create_mesh
    from hetu_tpu_torch.rpc import distributed_init
    from hetu_tpu_torch.rpc.launcher import ENV_COORD
    with open(os.environ[MESH_ENV_JOB]) as f:
        job = json.load(f)
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    client = distributed_init(os.environ[ENV_COORD], job["ranks"],
                              device="cuda", timeout=MESH_COLLECTIVE_TIMEOUT)
    refs = {}
    results = []
    for case, spec, shape, sp, opt_kw in job["cases"]:
        if spec.get("kind") == "ft":
            # phase 27 (b): the fault-tolerant trainer over the world
            r = ft_rank(spec, opt_kw, os.path.join(
                os.path.dirname(job["out"]), "ft_ck"))
            r.update(case=case, rank=client.rank)
            results.append(r)
            continue
        mesh = create_mesh(shape, device="cuda")
        name = spec["name"]
        weights = name in job["weights"]
        r = mesh_train(spec, mesh, sp, opt_kw, weights=weights)
        r.update(case=case, mesh=shape, sp=sp, opt=opt_kw,
                 backend=mesh.backend, rank=client.rank)
        if weights:
            if r.get("holds_final", client.rank == 0):
                if name not in refs:
                    refs[name] = {k: dict(np.load(
                        f"{job['ref']}.{name}.{k}.npz"))
                        for k in ("init", "final")}
                r["weights"] = mesh_weight_report(refs[name], r)
            r.pop("init", None)
            r.pop("final", None)
        results.append(r)
    if extra is not None:
        results.append(extra(job))
    with open(job["out"] + f".{client.rank}.json", "w") as f:
        json.dump(results, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    client.exit()


def mesh_weight_report(ref, got):
    """Phase 8's update rule over the gathered weights: every tensor's
    update within 1 % of the one-process update, no element further than
    2 * lr * steps from it; both runs start from the same draw of the
    seed-0 init."""
    upd_rel, max_abs, init_abs = 0.0, 0.0, 0.0
    for k, want in ref["final"].items():
        init_abs = max(init_abs, float(np.abs(got["init"][k] -
                                              ref["init"][k]).max()))
        diff = np.abs(got["final"][k] - want)
        max_abs = max(max_abs, float(diff.max()))
        moved = float(np.linalg.norm(want - ref["init"][k]))
        if moved > 0:
            upd_rel = max(upd_rel, float(np.linalg.norm(diff)) / moved)
    if init_abs:
        raise AssertionError(f"the mesh run starts {init_abs} from the "
                             f"one-process run's weights")
    return {"param_update_rel_diff": upd_rel, "param_max_abs_diff": max_abs,
            "init_max_abs_diff": init_abs}


def mesh_runs(cases, compare=(), **group_kw):
    """The one-process run of every configuration of ``cases`` (``[case,
    mesh_config(...), mesh shape, sp, optimizer options]``), then the
    cases on the rank group (``group_kw`` to :func:`mesh_group`): (one-
    process readings by configuration, each rank's readings).  For the
    configurations in ``compare`` rank 0 also holds its gathered weights
    against the one-process run's."""
    refs = {}
    tmp = tempfile.mkdtemp(prefix="hetu_mesh_")
    try:
        for spec in {c[1]["name"]: c[1] for c in cases
                     if c[1].get("kind") != "ft"}.values():
            name = spec["name"]
            refs[name] = mesh_train(spec, weights=name in compare)
            if name in compare:
                for k in ("init", "final"):
                    np.savez(os.path.join(tmp, f"ref.{name}.{k}.npz"),
                             **refs[name].pop(k))
        note("mesh", "one-process runs", {
            n: {k: r[k] for k in ("losses", "ms_per_step", "captured")}
            for n, r in refs.items()})
        runs = mesh_group(cases, tmp, compare, **group_kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return refs, runs


def mesh_group(cases, tmp, compare=(), ranks=MESH_RANKS,
               flag="--mesh-rank", **fields):
    """``cases`` on ``ranks`` rank processes of this script (``flag``
    picks their main), started once by the port's ``Launcher``; each
    rank's readings.  ``fields`` go into the job file.  A failing or
    hanging rank fails the phase: the monitor has a timeout and the
    launcher kills the group."""
    from hetu_tpu_torch.rpc import Launcher
    job = os.path.join(tmp, "job.json")
    out = os.path.join(tmp, "out")
    with open(job, "w") as f:
        json.dump({"ranks": ranks, "cases": cases, "out": out,
                   "ref": os.path.join(tmp, "ref"),
                   "weights": sorted(compare), **fields}, f)
    # the ranks' host threads: a share of the cores each (the card does
    # the arithmetic; more threads only spin against each other)
    threads = str(max(1, (os.cpu_count() or 2) // (2 * ranks)))
    with Launcher([sys.executable, os.path.abspath(__file__), flag],
                  num_workers=ranks,
                  env={MESH_ENV_JOB: job, "OMP_NUM_THREADS": threads}) as lau:
        ok = lau.monitor(poll=0.2, timeout=MESH_GROUP_TIMEOUT)
    if ok != ranks:
        raise AssertionError(f"mesh ranks failed: {lau.events}")
    runs = []
    for r in range(ranks):
        with open(out + f".{r}.json") as f:
            runs.append(json.load(f))
    return runs


def mesh_nccl_size1(ref):
    """(d) A mesh of size 1 on NCCL (a process group of one rank in this
    process): the step is captured and its losses equal the run with no
    mesh."""
    import socket
    import torch.distributed as dist
    from hetu_tpu_torch.parallel import create_mesh, init_process_group
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    backend = init_process_group(0, 1, f"tcp://127.0.0.1:{port}",
                                 device="cuda", timeout=60.0)
    try:
        mesh = create_mesh({"dp": 1}, device="cuda")
        r = mesh_train(mesh_config("gpt2_fp32_2_layers"), mesh)
    finally:
        dist.destroy_process_group()
    if backend != "nccl" or mesh.backend != "nccl" or not r["captured"] or \
            r["losses"] != ref["losses"]:
        raise AssertionError(f"size-1 NCCL mesh: backend {backend}, "
                             f"captured {r['captured']}, losses "
                             f"{r['losses']} != {ref['losses']}")
    return {"backend": backend, "captured": r["captured"],
            "compile_count": r["compile_count"], "losses": r["losses"],
            "ms_per_step": r["ms_per_step"]}


def phase_mesh():
    """Phase 22: the multi-GPU mesh on the one card (see the module
    docstring)."""
    t0 = time.perf_counter()
    refs, runs = mesh_runs([[case, mesh_config(name), shape, sp, kw]
                            for case, name, shape, sp, kw in MESH_CASES],
                           compare={"gpt2_fp32_2_layers"})
    layouts = []
    for i, (case, name, shape, sp, opt_kw) in enumerate(MESH_CASES):
        ref = refs[name]
        per_rank = [rk[i] for rk in runs]
        r0 = per_rank[0]
        spec = mesh_config(name)
        cfg = GPTConfig(**spec["cfg"])
        lr, steps = spec["lr"], spec["steps"]
        tp = shape.get("tp", 1)
        want = mesh_flash_want(cfg, spec["seq"], steps, spec["micro"])
        row = {"layout": case, "config": name, "mesh": shape, "sp": sp,
               "opt": opt_kw, "backend": r0["backend"],
               "captured": r0["captured"], "losses": r0["losses"],
               "one_process_losses": ref["losses"],
               "ms_per_step": r0["ms_per_step"],
               "one_process_ms_per_step": ref["ms_per_step"],
               "local_heads": cfg.num_heads // tp,
               "comm_by_rank": [r["comm"] for r in per_rank],
               "flash_by_rank": [{k: v["launches"] for k, v in
                                  r["flash"].items()} for r in per_rank],
               "flash_routes_by_rank": [{k: v["by_route"] for k, v in
                                         r["flash"].items()}
                                        for r in per_rank],
               "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                             for r in per_rank]}
        if any(r["losses"] != r0["losses"] for r in per_rank):
            raise AssertionError(f"{case}/{name}: ranks' losses differ")
        if r0["backend"] != "gloo" or r0["captured"]:
            raise AssertionError(f"{case}/{name}: backend {r0['backend']}, "
                                 f"captured {r0['captured']}")
        for r in per_rank:
            got = {k: v["launches"] for k, v in r["flash"].items()}
            if got != want:
                raise AssertionError(f"{case}/{name} rank {r['rank']}: "
                                     f"flash launches {got} != {want}")
            route = "wgmma" if cfg.dtype == "bfloat16" and \
                cfg.position != "rotary" else "3xtf32"
            for k, v in r["flash"].items():
                if v["by_route"][route] != v["launches"]:
                    raise AssertionError(f"{case}/{name}: {k} launches "
                                         f"off the {route} route: {v}")
        if name == "gpt2_fp32_2_layers":
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(r0["losses"], ref["losses"]))
            row.update(loss_rel_diff=rel, **r0["weights"])
            if rel > 1e-4 or r0["weights"]["param_update_rel_diff"] > 1e-2 \
                    or r0["weights"]["param_max_abs_diff"] > \
                    2 * lr * steps:
                raise AssertionError(f"{case}: against one process {row}")
        else:
            unit, limit, gaps, ok = mesh_loss_gaps(name, r0["losses"],
                                                   ref["losses"])
            row["loss_gap"] = {"unit": unit, "limit": limit,
                               "by_step": gaps}
        note("mesh", case, name, {k: row[k] for k in (
            "losses", "one_process_losses", "ms_per_step",
            "one_process_ms_per_step") if k in row}, row.get("loss_gap"))
        if "loss_gap" in row and (
                not ok or not r0["losses"][-1] < r0["losses"][0]):
            raise AssertionError(f"{case}/{name}: losses {r0['losses']} "
                                 f"against one process {ref['losses']}: "
                                 f"{row['loss_gap']}")
        layouts.append(row)
    # phase 25 (b) reads (c)'s switch from here
    i = next(i for i, c in enumerate(MESH_CASES) if c[0] == SWITCH_FULL[0])
    SHARED["switch_full"] = (mesh_config(MESH_CASES[i][1]),
                             [rk[i] for rk in runs],
                             refs[MESH_CASES[i][1]])
    size1 = mesh_nccl_size1(refs["gpt2_fp32_2_layers"])
    launches = {k: sum(fl[k] for row in layouts
                       for fl in row["flash_by_rank"])
                for k in flash_wrappers()}
    by_route = {k: {route: sum(fl[k][route] for row in layouts
                               for fl in row["flash_routes_by_rank"])
                    for route in ("wgmma", "3xtf32", "mma.sync")}
                for k in flash_wrappers()}
    out = {"ranks": MESH_RANKS, "layouts": layouts, "nccl_size1": size1,
           "flash_launches_by_route": by_route,
           "one_process": {n: {k: r[k] for k in ("losses", "ms_per_step",
                                                  "captured")}
                           for n, r in refs.items()},
           "flash_launches": launches, "nvidia_smi": smi_line(),
           "wall_s": time.perf_counter() - t0}
    emit({"phase": "mesh", **out})
    return out


# ---------------------------------------------------------------------------
# pipelines (phase 23)
# ---------------------------------------------------------------------------

# (a) fp32 GPT-2 widths at 4 layers, seq 256, global batch 8 in 4
# micro-batches, phase 8's steps and lr: pp 2 (on a spare axis, so the
# group's 4 ranks run it twice) and pp 2 x tp 2, each against the
# one-process pipeline model and the plain model from the same weights
PIPE_ORACLE_RANKS = 4
PIPE_ORACLE_LAYOUTS = [("pp2", {"r": 2, "pp": 2}),
                       ("pp2_tp2", {"pp": 2, "tp": 2})]
# (b) the entry point at GPT-2 small's widths: 2 stage ranks, global batch
# 8 in 4 micro-batches of 2, 4 steps
PIPE_ENTRY_RANKS = 2
PIPE_ENTRY_STEPS = 4
PIPE_ENTRY_ARGS = ENTRY_ARGS + ["--micro-batch", "2"]
# (b)'s bf16 losses against the one-process entry point's, in bf16
# spacings (``bf16_steps``), at step 1 and at the steps after it: equal
# at all 4 steps in the first card runs (PERF.md, phase 23), so equal at
# step 1 (the same weights and batch) and at most one spacing after (a
# loss near a rounding midpoint may round either way)
PIPE_ENTRY_LOSS_STEPS = (0, 1)
# (c) MPMDGPT at GPT-2 small's widths in bf16: global batch 8 as 8
# micro-batches of 1 over phase 15's 64 ids, 3 Adam steps; layouts
# against one stage within one bf16 rounding of the loss, relative
MPMD_LAYOUTS = [("1f1b", [[3, 3, 3, 3]], "1f1b"),
                ("gpipe", [[3, 3, 3, 3]], "gpipe"),
                ("hetero", [[2, 4, 3, 3]], "1f1b"),
                ("one_stage", [[12]], "1f1b")]
MPMD_MICRO, MPMD_STEPS, MPMD_LR = 8, 3, 3e-4
MPMD_LOSS_REL = 2.0 ** -8
# the layouts whose extra step is profiled (device idle share)
MPMD_PROFILED = ("1f1b", "one_stage")
# (c)'s bf16 [[12]] step-1 loss (fp32) against the plain bf16 model's
# (rounded to bf16) on the same weights, in bf16 spacings: rounding alone
# parts them by up to half a spacing
MPMD_PLAIN_BF16_STEPS = 1


def pipe_oracle_config():
    """(a)'s configuration, in ``mesh_config``'s form."""
    return {"name": "gpt2_fp32_4_layers_pp",
            "cfg": dataclasses.asdict(GPTConfig(vocab_size=50304,
                                                num_layers=4,
                                                dtype="float32")),
            "batch": 8, "seq": 256, "steps": ORACLE_STEPS, "lr": ORACLE_LR,
            "micro": 4, "pipeline": True}


def pipe_flash_want(num_layers, stages, micro, steps, fused):
    """A pipeline rank's flash launches: every tick runs the stage's
    layers forward, again in the backward's recompute, and backward
    (``M + S - 1`` ticks a step, bubbles included)."""
    each = (micro + stages - 1) * (num_layers // stages) * steps
    return {"flash_fwd": 2 * each, "flash_bwd_fused": each if fused else 0,
            "flash_bwd_dq": 0 if fused else each,
            "flash_bwd_dkv": 0 if fused else each}


def pipe_hops(by_tag, micro, stages, steps):
    """A rank's pipeline collectives against the port's
    ``spmd_hop_schedule``: ``M + S - 2`` hops each way a step, staged
    through host memory (gloo, CUDA tensors), one collect and one
    all-reduce of the input's gradient over pp.  Returns the counts."""
    from hetu_tpu_torch.parallel.pipeline import spmd_hop_schedule
    sched = spmd_hop_schedule(micro, stages, with_aux=False)
    hops = by_tag.get("ppermute|pipeline/hop|pp|staged", 0)
    collect = by_tag.get("all_reduce|pipeline/collect|pp", 0)
    grad_in = by_tag.get("all_reduce||pp", 0)
    want = (2 * sched.count(("ppermute", "pipeline/hop")) * steps,
            sched.count(("all_reduce", "pipeline/collect")) * steps, steps)
    if (hops, collect, grad_in) != want:
        raise AssertionError(f"pipeline collectives {by_tag}: hops, "
                             f"collects, input-gradient reduces "
                             f"{(hops, collect, grad_in)} != {want}")
    return {"hops": hops, "collects": collect, "input_grad_reduces": grad_in}


def pipe_oracle():
    """(a): the one-process pipeline model and the plain model (from its
    weights) in this process, captured, then the layouts on
    ``PIPE_ORACLE_RANKS`` ranks of ``mesh_rank_main``: losses within 1e-4
    of both and the gathered weights' updates within 1 % of the
    one-process pipeline's (phase 8's rule)."""
    spec = pipe_oracle_config()
    name = spec["name"]
    cfg = GPTConfig(**spec["cfg"])
    ref = mesh_train(spec, weights=True)
    plain = mesh_train({**spec, "pipeline": False}, weights=True,
                       init_state=ref["init"])
    one = {"pipeline_losses": ref["losses"], "plain_losses": plain["losses"],
           "pipeline_ms_per_step": ref["ms_per_step"],
           "plain_ms_per_step": plain["ms_per_step"],
           "captured": [ref["captured"], plain["captured"]],
           **{f"plain_{k}": v for k, v in
              mesh_weight_report(ref, plain).items()}}
    rel = max(abs(a - b) / abs(b) for a, b in zip(plain["losses"],
                                                  ref["losses"]))
    if rel > 1e-4 or one["plain_param_update_rel_diff"] > 1e-2 or \
            not all(one["captured"]):
        raise AssertionError(f"pipeline oracle: one-process pipeline "
                             f"against the plain model {one}")
    tmp = tempfile.mkdtemp(prefix="hetu_pipe_")
    try:
        for k in ("init", "final"):
            np.savez(os.path.join(tmp, f"ref.{name}.{k}.npz"), **ref[k])
        cases = [[case, spec, shape, False, {}]
                 for case, shape in PIPE_ORACLE_LAYOUTS]
        runs = mesh_group(cases, tmp, {name}, ranks=PIPE_ORACLE_RANKS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fused = fa._use_fused(spec["seq"], cfg.head_dim, torch.float32)
    layouts = []
    for i, (case, shape) in enumerate(PIPE_ORACLE_LAYOUTS):
        per_rank = [rk[i] for rk in runs]
        r0 = per_rank[0]
        want = pipe_flash_want(cfg.num_layers, shape["pp"], spec["micro"],
                               spec["steps"], fused)
        for r in per_rank:
            got = {k: v["launches"] for k, v in r["flash"].items()}
            off = {k: v["launches"] - v["by_route"]["3xtf32"]
                   for k, v in r["flash"].items()}
            if got != want or any(off.values()):
                raise AssertionError(f"pipeline {case} rank {r['rank']}: "
                                     f"flash {r['flash']}, want {want} on "
                                     f"3xtf32")
            hops = pipe_hops(r["comm_by_tag"], spec["micro"], shape["pp"],
                             spec["steps"])
        rels = [max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], w))
                for w in (ref["losses"], plain["losses"])]
        row = {"layout": case, "mesh": shape, "losses": r0["losses"],
               "loss_rel_diff_pipeline": rels[0],
               "loss_rel_diff_plain": rels[1], **r0["weights"],
               "ms_per_step_by_rank": [r["ms_per_step"] for r in per_rank],
               "comm_by_rank": [r["comm"] for r in per_rank],
               "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                             for r in per_rank],
               "flash_launches_per_rank": want, "collectives_per_rank": hops,
               "backend": r0["backend"], "captured": r0["captured"]}
        note("pipeline", "oracle", case, {k: row[k] for k in (
            "losses", "loss_rel_diff_pipeline", "loss_rel_diff_plain",
            "param_update_rel_diff", "ms_per_step_by_rank")})
        if any(r["losses"] != r0["losses"] for r in per_rank) or \
                max(rels) > 1e-4 or r0["weights"][
                    "param_update_rel_diff"] > 1e-2 or \
                r0["weights"]["param_max_abs_diff"] > \
                2 * spec["lr"] * spec["steps"] or r0["captured"]:
            raise AssertionError(f"pipeline {case}: {row}")
        layouts.append(row)
    return {"config": name, "one_process": one, "layouts": layouts,
            "ranks": PIPE_ORACLE_RANKS,
            "flash": flash_totals(r["flash"] for rk in runs for r in rk)}


def flash_totals(runs):
    """Flash launches summed over runs' ``flash_counts``: by wrapper, and
    by wrapper and route."""
    total = {k: {"launches": 0, "by_route": {"wgmma": 0, "3xtf32": 0,
                                             "mma.sync": 0}}
             for k in flash_wrappers()}
    for fl in runs:
        for k, v in fl.items():
            total[k]["launches"] += v["launches"]
            for route, n in v["by_route"].items():
                total[k]["by_route"][route] += n
    return total


def pipe_entry_rank_main():
    """One stage rank of (b), started by the port's ``Launcher``: runs the
    entry point's ``main`` as a rank (it joins the group itself), with
    the flash counters and the collectives recorded, and writes them with
    its readings."""
    from hetu_tpu_torch.parallel import comm
    from hetu_tpu_torch.rpc.launcher import ENV_RANK
    with open(os.environ[MESH_ENV_JOB]) as f:
        job = json.load(f)
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    entry = load_entry()
    reset_flash_counts()
    with comm.comm_stats() as st:
        r = entry.main(job["argv"])
    rank = int(os.environ[ENV_RANK])
    r.update(rank=rank, flash=flash_counts(), comm=st.summary(),
             comm_by_tag=comm_by_tag(st.records))
    with open(job["out"] + f".{rank}.json", "w") as f:
        json.dump(r, f)


def pipe_entry():
    """(b): ``examples/train_gpt_torch.py --pp 2`` at GPT-2 small's widths
    in bf16 through the launcher, against the one-process entry point
    from the same weights and batches."""
    entry = load_entry()
    tmp = tempfile.mkdtemp(prefix="hetu_pipe_entry_")
    data = os.path.join(tmp, "tokens.npy")
    init = os.path.join(tmp, "init.safetensors")
    entry_tokens(data)
    args = PIPE_ENTRY_ARGS + ["--data", data]
    try:
        entry.main(args + ["--steps", "1", "--save", init])
        one = entry.main(args + ["--steps", str(PIPE_ENTRY_STEPS),
                                 "--load", init])
        argv = args + ["--steps", str(PIPE_ENTRY_STEPS), "--load", init,
                       "--pp", str(PIPE_ENTRY_RANKS)]
        runs = mesh_group([], tmp, ranks=PIPE_ENTRY_RANKS,
                          flag="--pipe-entry-rank", argv=argv)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = next(r for r in runs if r["rank"] == 0)
    M = r0["micro_batches"]
    want = pipe_flash_want(ENTRY_LAYERS, PIPE_ENTRY_RANKS, M,
                           PIPE_ENTRY_STEPS,
                           fa._use_fused(1024, 64, torch.bfloat16))
    per_rank = []
    for r in sorted(runs, key=lambda r: r["rank"]):
        got = {k: v["launches"] for k, v in r["flash"].items()}
        wg = {k: v["by_route"]["wgmma"] for k, v in r["flash"].items()}
        if got != want or wg != want:
            raise AssertionError(f"pipeline entry rank {r['rank']}: flash "
                                 f"{r['flash']}, want {want} on wgmma")
        per_rank.append({
            "rank": r["rank"], "ms_per_step": r["ms_per_step"],
            "peak_memory_bytes": r["peak_memory_bytes"],
            "collectives": pipe_hops(r["comm_by_tag"], M, PIPE_ENTRY_RANKS,
                                     PIPE_ENTRY_STEPS),
            "comm": r["comm"], "flash": r["flash"]})
    gaps = [bf16_steps(a, b) for a, b in zip(r0["losses"], one["losses"])]
    out = {"argv": argv, "layout": r0["layout"], "micro_batches": M,
           "losses": r0["losses"], "one_process_losses": one["losses"],
           "loss_gap_bf16_steps": gaps,
           "one_process_ms_per_step": one["ms_per_step"],
           "one_process_captured": one["captured"],
           "one_process_peak_memory_bytes": one["peak_memory_bytes"],
           "flash_launches_per_rank": want, "ranks": per_rank}
    note("pipeline", "entry", {k: out[k] for k in (
        "losses", "one_process_losses", "loss_gap_bf16_steps")},
        [r["ms_per_step"] for r in per_rank], one["ms_per_step"])
    if r0["layout"]["backend"] != "gloo" or r0["captured"] or \
            gaps[0] > PIPE_ENTRY_LOSS_STEPS[0] or \
            max(gaps) > PIPE_ENTRY_LOSS_STEPS[1] or \
            not np.isfinite(r0["losses"]).all() or \
            not r0["losses"][-1] < r0["losses"][0]:
        raise AssertionError(f"pipeline entry: {out}")
    out["flash"] = flash_totals(r["flash"] for r in per_rank)
    return out


def mpmd_batch(cfg):
    """(c)'s batch: ``MPMD_MICRO`` rows of 1024 tokens over phase 15's
    learnable stream of 64 ids (a falling loss in 3 steps)."""
    rng = np.random.RandomState(0)
    ids = rng.choice(cfg.vocab_size, ENTRY_VOCAB_USED, replace=False)
    toks = ids[rng.randint(0, ENTRY_VOCAB_USED, (MPMD_MICRO, 1025))]
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def mpmd_run(cfg, layers, schedule, profile=False):
    """(c): one ``MPMDGPT`` layout trained ``MPMD_STEPS`` Adam steps on
    ``mpmd_batch``: losses, ms a step, the stash peaks and bytes, the
    controller's seconds, peak memory (and the steps' peak above what was
    allocated before them), the flash launches and the p2p log against
    the schedule's events.  With ``profile``, one more step runs
    unprofiled and then under ``torch.profiler`` (``profiled_window``,
    after the launches are read): its device busy time and idle share
    beside the controller's share of the unprofiled wall."""
    from hetu_tpu_torch.models.gpt_mpmd import MPMDGPT
    from hetu_tpu_torch.parallel.pipeline_mpmd import MPMDAdam
    from hetu_tpu_torch.parallel.schedule import p2p_events
    model = MPMDGPT(cfg, stage_layers=layers, schedule=schedule, seed=0)
    opt = MPMDAdam(model.runtime, lr=MPMD_LR)
    x, y = mpmd_batch(cfg)

    def step():
        loss, grads, st = model.train_step(
            model.split_micro_batches(x, y, [MPMD_MICRO]))
        opt.apply(grads)
        return loss, st

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_flash_counts()
    losses, step_s, stats = [], [], None
    for _ in range(MPMD_STEPS):
        t = time.perf_counter()
        loss, stats = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(loss))
    S = len(layers[0])
    by_stage = [[] for _ in range(S)]
    for kind, fb, _, s, m, peer in model.runtime.p2p_log:
        by_stage[s].append((kind, fb, m, peer))
    gen = generate_pipedream_flush_schedule if schedule == "1f1b" \
        else generate_gpipe_schedule
    want_events = [[tuple(e) for e in st]
                   for st in p2p_events(gen(S, MPMD_MICRO))]
    out = {"stage_layers": layers, "schedule": schedule, "losses": losses,
           "ms_per_step": 1e3 * float(np.mean(step_s[1:])),
           "stash_peak": stats.stash_peak,
           "stash_peak_bytes": stats.stash_peak_bytes,
           "controller_ms": 1e3 * stats.controller_seconds,
           "sync_ms": 1e3 * stats.sync_seconds,
           "num_tasks": stats.num_tasks,
           "p2p_log_equals_events": by_stage == want_events,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "step_peak_bytes": torch.cuda.max_memory_allocated() - base,
           "flash": flash_counts()}
    if profile:
        ctrl = []      # the controller's seconds, the unprofiled step first

        def window():
            ctrl.append(step()[1].controller_seconds)

        plain, wall, kernels, _, _ = profiled_window(window)
        busy = sum(k[0] for k in kernels) / 1e6
        out["profile"] = {
            "unprofiled_wall_s": plain, "wall_s": wall,
            "device_busy_s": busy,
            "idle_share": 1.0 - busy / plain if busy else None,
            "controller_share_of_wall": ctrl[0] / plain,
            "kernels": sum(k[2] for k in kernels),
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n}
                    for us, k, n in kernels[:6]]}
        if not busy:
            raise AssertionError(f"mpmd {layers} {schedule}: the profile "
                                 f"shows no device time")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mpmd_flash_want(layers, steps, dtype):
    """An MPMD run's launches: a non-last stage's layers run forward, then
    again in the backward's recompute; the last stage's once, fused with
    its backward; every layer backward once."""
    fwd = sum(2 * n for n in layers[:-1]) + layers[-1]
    each = MPMD_MICRO * steps
    bwd = sum(layers) * each
    fused = fa._use_fused(1024, 64, dtype)
    return {"flash_fwd": fwd * each, "flash_bwd_fused": bwd if fused else 0,
            "flash_bwd_dq": 0 if fused else bwd,
            "flash_bwd_dkv": 0 if fused else bwd}


def mpmd_plain_state(state, cfg):
    """An ``MPMDGPT.gather_state`` snapshot (``layerN``, ``wte``, ``wpe``,
    ``ln_f``, ``head``) under the plain model's normalised names."""
    names = {"ln1": "ln_1", "ln2": "ln_2", "qkv": "attn.qkv",
             "attn_out": "attn.out", "mlp_up": "mlp.up",
             "mlp_down": "mlp.down"}
    out = {"wte.weight": state["wte"], "ln_f.weight": state["ln_f"]["g"]}
    if "b" in state["ln_f"]:
        out["ln_f.bias"] = state["ln_f"]["b"]
    if "wpe" in state:
        out["wpe"] = state["wpe"]
    if "head" in state:
        out["lm_head.weight"] = state["head"]
    for i in range(cfg.num_layers):
        for k, v in state[f"layer{i}"].items():
            if isinstance(v, dict):
                out[f"h{i}.{names[k]}.weight"] = v["g"]
                if "b" in v:
                    out[f"h{i}.{names[k]}.bias"] = v["b"]
            elif k.endswith("_b"):
                out[f"h{i}.{names[k[:-2]]}.bias"] = v
            else:
                out[f"h{i}.{names[k]}.weight"] = v
    return out


def mpmd_plain_oracle():
    """(c)'s ``[[12]]`` against the plain ``GPTLMHeadModel`` on the same
    weights (``gather_state`` under the plain names, ``load_state``) and
    ``mpmd_batch``: in fp32 (TF32 off), phase 8's steps and lr, losses
    within 1e-4 and the gathered updates within 1 % (phase 8's rule);
    the bf16 plain model's step-1 loss from the same weights, for the
    bf16 ``[[12]]`` run's (``MPMD_PLAIN_BF16_STEPS``)."""
    from hetu_tpu_torch.models.gpt_mpmd import MPMDGPT
    from hetu_tpu_torch.parallel.pipeline_mpmd import MPMDAdam
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(vocab_size=50304, dtype="float32")
    x, y = mpmd_batch(cfg)
    model = MPMDGPT(cfg, stage_layers=[[cfg.num_layers]], seed=0)
    opt = MPMDAdam(model.runtime, lr=ORACLE_LR)
    init = mpmd_plain_state(model.gather_state(), cfg)
    reset_flash_counts()
    losses = []
    for _ in range(ORACLE_STEPS):
        loss, grads, _ = model.train_step(
            model.split_micro_batches(x, y, [MPMD_MICRO]))
        opt.apply(grads)
        losses.append(float(loss))
    final = mpmd_plain_state(model.gather_state(), cfg)
    flash = flash_counts()
    del model, opt, grads
    gc.collect()
    torch.cuda.empty_cache()
    want = mpmd_flash_want([cfg.num_layers], ORACLE_STEPS, torch.float32)
    got = {k: v["launches"] for k, v in flash.items()}
    if got != want:
        raise AssertionError(f"mpmd fp32 oracle: flash {flash}, want "
                             f"{want}")
    spec = {"name": "gpt2_small_fp32_mpmd_oracle",
            "cfg": dataclasses.asdict(cfg), "batch": MPMD_MICRO,
            "seq": 1024, "steps": ORACLE_STEPS, "lr": ORACLE_LR,
            "micro": MPMD_MICRO}
    plain = mesh_train(spec, weights=True, init_state=init,
                       batch_xy=(x, y))
    report = mesh_weight_report(plain, {"init": init, "final": final})
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
    out = {"losses": losses, "plain_losses": plain["losses"],
           "loss_rel_diff": rel, **report,
           "plain_ms_per_step": plain["ms_per_step"]}
    if rel > 1e-4 or report["param_update_rel_diff"] > 1e-2 or \
            report["param_max_abs_diff"] > 2 * ORACLE_LR * ORACLE_STEPS:
        raise AssertionError(f"mpmd [[12]] against the plain model: {out}")
    bf16 = mesh_train({**spec, "cfg": dataclasses.asdict(
        GPTConfig(vocab_size=50304, dtype="bfloat16")), "steps": 1},
        init_state=init, batch_xy=(x, y))
    out["plain_bf16_step1_loss"] = bf16["losses"][0]
    return out, flash


def pipe_mpmd():
    """(c): ``MPMDGPT`` on the one card (every stage ``cuda:0``)."""
    oracle, oracle_flash = mpmd_plain_oracle()
    cfg = GPTConfig(vocab_size=50304, dtype="bfloat16")
    runs = {name: mpmd_run(cfg, layers, sched,
                           profile=name in MPMD_PROFILED)
            for name, layers, sched in MPMD_LAYOUTS}
    ref = runs["one_stage"]["losses"]
    for name, layers, _ in MPMD_LAYOUTS:
        r = runs[name]
        want = mpmd_flash_want(layers[0], MPMD_STEPS, torch.bfloat16)
        got = {k: v["launches"] for k, v in r["flash"].items()}
        wg = {k: v["by_route"]["wgmma"] for k, v in r["flash"].items()}
        r["loss_rel_diff"] = max(abs(a - b) / abs(b)
                                 for a, b in zip(r["losses"], ref))
        if got != want or wg != want or not r["p2p_log_equals_events"] or \
                r["loss_rel_diff"] > MPMD_LOSS_REL or \
                not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"mpmd {name}: {r}, want flash {want}")
        note("pipeline", "mpmd", name, r["losses"], r["ms_per_step"],
             r["stash_peak"], r["stash_peak_bytes"],
             r.get("profile", {}).get("idle_share"))
    # the bf16 [[12]] run's step-1 loss (fp32, from bf16 logits) against
    # the plain bf16 model's (rounded to bf16) on the same weights
    oracle["bf16_step1_gap_steps"] = bf16_steps(
        ref[0], oracle["plain_bf16_step1_loss"])
    note("pipeline", "mpmd", "plain", {k: oracle[k] for k in (
        "loss_rel_diff", "param_update_rel_diff", "bf16_step1_gap_steps")})
    if oracle["bf16_step1_gap_steps"] > MPMD_PLAIN_BF16_STEPS:
        raise AssertionError(f"mpmd bf16 [[12]] step-1 loss {ref[0]} "
                             f"against the plain model's: {oracle}")
    # the same forward at step 1; after it the flash backward's atomic dq
    # sums may part the two in the last bits
    a, b = runs["1f1b"], runs["gpipe"]
    S = len(MPMD_LAYOUTS[0][1][0])
    if a["losses"][0] != b["losses"][0] or \
            b["loss_rel_diff"] > MPMD_LOSS_REL or max(a["stash_peak"]) > S or \
            max(b["stash_peak"]) != MPMD_MICRO or \
            not max(a["stash_peak_bytes"]) < max(b["stash_peak_bytes"]):
        raise AssertionError(f"mpmd 1f1b {a} against gpipe {b}")
    return {"config": "GPT-2 small widths (vocab 50304), bf16, seq 1024",
            "micro_batches": MPMD_MICRO, "steps": MPMD_STEPS,
            "layouts": {n: {k: v for k, v in r.items() if k != "flash"}
                        for n, r in runs.items()},
            "plain_oracle": oracle,
            "flash": flash_totals([oracle_flash] +
                                  [r["flash"] for r in runs.values()])}


def phase_pipeline():
    """Phase 23: pipelines on the one card (see the module docstring)."""
    t0 = time.perf_counter()
    out, wall = {}, {}
    for part, fn in (("oracle", pipe_oracle), ("entry", pipe_entry),
                     ("mpmd", pipe_mpmd)):
        t = time.perf_counter()
        out[part] = fn()
        wall[part] = time.perf_counter() - t
    out["part_wall_s"] = wall
    total = flash_totals(out[k].pop("flash") for k in ("oracle", "entry",
                                                       "mpmd"))
    out.update(flash_launches={k: v["launches"] for k, v in total.items()},
               flash_launches_by_route={k: v["by_route"]
                                        for k, v in total.items()},
               nvidia_smi=smi_line(), wall_s=time.perf_counter() - t0)
    emit({"phase": "pipeline", **out})
    return out


# ---------------------------------------------------------------------------
# context parallelism (phase 24)
# ---------------------------------------------------------------------------

CP_SEQ = 8192                  # Llama-3-8B's max_seq_len: (b)'s sequence
CP_ATTN = (1, 4096, 32, 128)   # a rank's block of it over cp 2: (c)
CP_RING = {"cp_axis": "cp", "cp_impl": "ring"}
CP_ULYSSES = {"cp_axis": "cp", "cp_impl": "ulysses"}
# (a) fp32 GPT-2 widths at 2 layers, phase 8's limits: the 4-rank
# layouts on 4 ranks (dp 2 x cp 2 under ZeRO-2, whose cp sum acts on
# the rank's half of each gradient), the cp 2 layouts on (b)'s 2 ranks
# before its cases; (b) Llama-3-8B widths at 2 layers, one sequence of
# 8192 tokens, on 2 ranks, its 3 GB of gradients summed over cp in 256
# MB buckets (each gloo collective costs about 13 ms besides its bytes):
# (case, config, mesh, sp, config overrides, optimizer options)
CP_BUCKET_MB = 256
CP_LAYOUTS_4 = [
    ("dp2_cp2_ring_zero2", "gpt2_fp32_2_layers", {"dp": 2, "cp": 2},
     False, CP_RING, {"zero": 2}),
    ("cp2_tp2_sp_ring", "gpt2_fp32_2_layers", {"cp": 2, "tp": 2}, True,
     CP_RING, {}),
]
CP_LAYOUTS_2 = [
    ("cp2_ring", "gpt2_fp32_2_layers", {"cp": 2}, False, CP_RING, {}),
    ("cp2_ulysses", "gpt2_fp32_2_layers", {"cp": 2}, False, CP_ULYSSES,
     {}),
    ("cp2_ring", "llama3_8b_cp_8192", {"cp": 2}, False, CP_RING,
     {"bucket_mb": CP_BUCKET_MB}),
    ("cp2_ulysses", "llama3_8b_cp_8192", {"cp": 2}, False, CP_ULYSSES,
     {"bucket_mb": CP_BUCKET_MB}),
]
# (c): the kernels at the launch shapes (b) makes: the ring's on a block
# of CP_ATTN (sym halves of 2048), both type mixes; over the whole
# CP_SEQ, Ulysses' with the rank's 16 of the 32 heads in the LLaMA
# path's mix, and with all 32 (the one-process run's, and the reference
# of the sharded check on the ranks) in both: (name, sq, sk, heads,
# causal, causal offset, segments, type mixes)
_CS, _CH, _CN = CP_ATTN[1], CP_ATTN[1] // 2, CP_ATTN[2]
CP_KERNEL_TYPES = ("bf16", "fp32_qk_bf16_v")
CP_KERNEL_CASES = [
    ("normal_causal_pair", _CS, _CS, _CN, True, 0, None, CP_KERNEL_TYPES),
    ("normal_full_pair", _CS, _CS, _CN, False, 0, None, CP_KERNEL_TYPES),
    ("sym_head_causal", _CH, _CH, _CN, True, 0, None, CP_KERNEL_TYPES),
    ("sym_tail_causal", _CH, _CS, _CN, True, _CH, None, CP_KERNEL_TYPES),
    ("sym_col", _CS, _CH, _CN, False, 0, None, CP_KERNEL_TYPES),
    ("sym_row", _CH, _CS, _CN, False, 0, None, CP_KERNEL_TYPES),
    # rank 1's block against rank 0's, documents ending at 3000 and 6000:
    # the q rows of the third document see no key of this pair
    ("ids_full_pair", _CS, _CS, _CN, False, 0, "docs", CP_KERNEL_TYPES),
    ("ulysses_whole_seq", CP_SEQ, CP_SEQ, _CN // 2, True, 0, None,
     ("fp32_qk_bf16_v",)),
    ("whole_seq", CP_SEQ, CP_SEQ, _CN, True, 0, None, CP_KERNEL_TYPES),
]
# (c)'s draw of the inputs, not phase 6's: ``single_key_ulps`` holds for
# every draw
CP_KERNEL_SEED = 4


def cp_cases(layouts):
    """Phase 24's layouts as ``mesh_runs`` cases, the config carrying
    its cp overrides (dropped by ``mesh_train`` in the one-process run)."""
    out = []
    for case, name, shape, sp, over, opt_kw in layouts:
        spec = mesh_config(name)
        out.append([case, {**spec, "cfg": {**spec["cfg"], **over}}, shape,
                    sp, opt_kw])
    return out


def cp_flash_want(cfg, spec, shape, rank, impl):
    """A rank's flash launches over a run: under the normal causal ring
    rank ``i`` of cp runs ``i + 1`` pairs a layer (its own block causal,
    the earlier ranks' full; later ranks' blocks are empty pairs), the
    backward by the byte rule at the block's length; Ulysses one flash
    over the whole sequence a layer.  Micro-batches and steps as
    ``mesh_flash_want``."""
    coords = dict(zip(shape, (int(c) for c in np.unravel_index(
        rank, tuple(shape.values())))))
    k_dtype = torch.float32 if cfg.position == "rotary" or \
        cfg.dtype == "float32" else torch.bfloat16
    seq, each = spec["seq"], cfg.num_layers * spec["micro"] * spec["steps"]
    if impl == "ring":
        n = each * (coords["cp"] + 1)
        fused = fa._use_fused(seq // shape["cp"], cfg.head_dim, k_dtype)
    else:
        n = each
        fused = fa._use_fused(seq, cfg.head_dim, k_dtype)
    return {"flash_fwd": n, "flash_bwd_fused": n if fused else 0,
            "flash_bwd_dq": 0 if fused else n,
            "flash_bwd_dkv": 0 if fused else n}


def cp_comm_want(cfg, spec, shape, impl):
    """A rank's context-parallel collectives over a run, by
    ``kind|tag|axis``: the ring's k and v hops (``cp - 1`` a layer
    forward and as many backward; no segments, so no ids) and its dk, dv
    hops (``cp`` a layer), staged through host memory on gloo; Ulysses'
    four all-to-alls a layer each way."""
    cp = shape["cp"]
    each = cfg.num_layers * spec["micro"] * spec["steps"]
    if impl == "ring":
        return {"ppermute|ring/kv|cp|staged": each * 2 * (cp - 1) * 2,
                "ppermute|ring/dkv|cp|staged": each * cp * 2}
    return {"all_to_all|ulysses|cp": each * 8}


def cp_rank_checks(job):
    """(c) on each rank of (b)'s group, after the training cases:
    ``ring_attention_sharded`` on the rank's block of ``CP_ATTN`` over
    cp 2 (normal and sym, bf16 and the LLaMA path's fp32 q/k with bf16
    v), forward and gradients against the kernels over the whole
    sequence in one process (``fa._flash_fwd``/``_flash_bwd``; (c)'s
    ``whole_seq`` case holds them against the plain versions at that
    shape), by ``flash_agreement``; then ``profile_ring_breakdown`` of both patterns
    on the mixed types.  Its launches are counted apart from the main
    path's."""
    from hetu_tpu_torch.parallel import create_mesh
    from hetu_tpu_torch.parallel.ring_attention import (
        profile_ring_breakdown, ring_attention_sharded)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh({"cp": 2}, device="cuda")
    b, s_local, h, d = CP_ATTN
    s, scale = 2 * s_local, d ** -0.5
    blk = slice(mesh.axis_index("cp") * s_local,
                (mesh.axis_index("cp") + 1) * s_local)
    reset_flash_counts()
    sharded, profile = {}, {}
    for types in CP_KERNEL_TYPES:
        q, k, v, do = flash_inputs(b, s, s, h, d, types, seed=3)
        ro, rl = fa._flash_fwd(q, k, v, scale, True, None)
        want = fa._flash_bwd(scale, True, None, (q, k, v, ro, rl), do)
        bf16_qk = q.dtype == torch.bfloat16
        bf16_v = v.dtype == torch.bfloat16
        for pattern in ("normal", "sym"):
            loc = [x[:, blk].contiguous().requires_grad_(True)
                   for x in (q, k, v)]
            t = time.perf_counter()
            o = ring_attention_sharded(*loc, mesh, split_pattern=pattern)
            got = torch.autograd.grad(o, loc, grad_outputs=do[:, blk]
                                      .contiguous())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            ratios = {"out": flash_agreement(o.detach(), ro[:, blk], (3,),
                                             bf16_v, FP32_FWD_TOL)}
            for name, g, w, scaled in zip(
                    ("dq", "dk", "dv"), got, want,
                    (bf16_qk, bf16_qk, bf16_qk or bf16_v)):
                ratios[name] = flash_agreement(g, w[:, blk], (3,), scaled,
                                               FP32_BWD_TOL)
            sharded[f"{types}/{pattern}"] = {
                "err_over_limit": {n: r[0] for n, r in ratios.items()},
                "max_abs_err": {n: r[1] for n, r in ratios.items()},
                "fwd_bwd_wall_ms": 1e3 * wall}
            del o, got, loc
        if types == "fp32_qk_bf16_v":
            for pattern in ("normal", "sym"):
                rows = profile_ring_breakdown(
                    *(x[:, blk].contiguous() for x in (q, k, v)), mesh,
                    split_pattern=pattern, reps=3)
                profile[pattern] = [
                    {"round": r["round"],
                     **{f"{c[:-2]}_ms": 1e3 * r[c] for c in
                        ("comm_s", "attn_s", "corr_s", "grad_s")}}
                    for r in rows]
        del q, k, v, do, ro, rl, want
        torch.cuda.empty_cache()
    return {"rank": mesh.rank, "sharded": sharded, "profile": profile,
            "check_launches": flash_counts()}


def cp_kernel_checks():
    """(c) in this process: kernels 1-4 at each ring launch shape of
    ``CP_KERNEL_CASES`` in its type mixes against their plain versions
    (``check_flash``), the rows of the ids pair that see no key exactly
    out = 0, lse = -inf, dq = 0, and the forward and the backward the
    byte rule picks timed beside their bounds.  The causal pairs' first
    query row sees one key: its dq is held against the fp64 plain
    version within ``single_key_ulps``."""
    b, _, _, d = CP_ATTN
    out = []
    for name, sq, sk, h, causal, offset, seg, mixes in CP_KERNEL_CASES:
        for types in mixes:
            q, k, v, do = flash_inputs(b, sq, sk, h, d, types,
                                       seed=CP_KERNEL_SEED)
            segs, empty_rows = None, None
            if seg == "docs":
                qpos = torch.arange(sk, sk + sq, device="cuda")
                kpos = torch.arange(sk, device="cuda")
                q_ids = torch.where(qpos < 6000, 1, 2).to(torch.int32)
                kv_ids = torch.where(kpos < 3000, 0, 1).to(torch.int32)
                segs = (q_ids[None].contiguous(), kv_ids[None].contiguous())
                empty_rows = qpos >= 6000
            res, (ro, rl, delta), got = check_flash(
                q, k, v, do, causal, segs, offset, tag=f"cp {name} {types}")
            empty = None
            if empty_rows is not None:
                empty = sum(int(torch.count_nonzero(got[n][:, empty_rows])
                                .item())
                            for n in ("out", "dq_fused", "dq_split"))
                empty += int((got["lse"][:, :, empty_rows] !=
                              float("-inf")).sum().item())
                if empty or not bool(empty_rows.any()):
                    raise AssertionError(
                        f"cp {name} {types}: {empty} values of the rows "
                        f"that see no key are not out = 0, lse = -inf, "
                        f"dq = 0")
            scale = d ** -0.5
            fused = fa._use_fused(sk, d, k.dtype)
            fwd = cuda_time_ms(lambda: fa.flash_fwd_cuda(
                q, k, v, scale, causal, segs, offset), warmup=1, iters=3)
            if fused:
                bwd = cuda_time_ms(lambda: fa.flash_bwd_fused_cuda(
                    q, k, v, ro, rl, do, scale, causal, segs, offset),
                    warmup=1, iters=3)
            else:
                bwd = cuda_time_ms(lambda: (fa.flash_bwd_dq_cuda(
                    q, k, v, do, rl, delta, scale, causal, segs, offset),
                    fa.flash_bwd_dkv_cuda(q, k, v, do, rl, delta, scale,
                                          causal, segs, offset)),
                    warmup=1, iters=3)
            bwd_kernels = ("flash_bwd_fused",) if fused else \
                ("flash_bwd_dq", "flash_bwd_dkv")
            out.append({
                "case": name, "types": types, "b": b, "sq": sq, "sk": sk,
                "h": h, "d": d, "causal": causal, "causal_offset": offset,
                "segments": seg, "backward": "fused" if fused else "split",
                "err_over_limit": {n: r[0] for n, r in res.items()},
                "max_abs_err": {n: r[1] for n, r in res.items()},
                "single_key_rows": got["single_key_rows"],
                "empty_rows_nonzero": empty,
                "fwd_ms": fwd, "fwd_bound_ms": flash_work(
                    "flash_fwd", b, sq, sk, h, d, q.dtype, v.dtype, causal,
                    offset)["bound_ms"],
                "bwd_ms": bwd, "bwd_bound_ms": sum(flash_work(
                    n, b, sq, sk, h, d, q.dtype, v.dtype, causal,
                    offset)["bound_ms"] for n in bwd_kernels)})
            del q, k, v, do, ro, rl, delta, got
            torch.cuda.empty_cache()
    return out


def cp_layout_rows(layouts, cases, refs, runs):
    """Each layout against its one-process run: (a)'s fp32 losses within
    1e-4 and gathered weights within phase 8's update rule, (b)'s by
    ``MESH_LOSS_LIMITS`` and falling; every rank's flash launches and
    context-parallel collectives as ``cp_flash_want``/``cp_comm_want``
    say, on the 3xTF32 route; the readings by rank."""
    rows = []
    for i, ((case, name, shape, sp, over, _), c) in enumerate(
            zip(layouts, cases)):
        spec, ref = c[1], refs[name]
        cfg = GPTConfig(**spec["cfg"])
        per_rank = [rk[i] for rk in runs]
        r0 = per_rank[0]
        impl = over["cp_impl"]
        row = {"layout": case, "config": name, "impl": impl, "mesh": shape,
               "sp": sp, "backend": r0["backend"],
               "captured": r0["captured"], "losses": r0["losses"],
               "one_process_losses": ref["losses"],
               "ms_per_step_by_rank": [r["ms_per_step"] for r in per_rank],
               "one_process_ms_per_step": ref["ms_per_step"],
               "case_wall_s_by_rank": [r["case_wall_s"] for r in per_rank],
               "flash_by_rank": [{k: v["launches"] for k, v in
                                  r["flash"].items()} for r in per_rank],
               "flash_routes_by_rank": [{k: v["by_route"] for k, v in
                                         r["flash"].items()}
                                        for r in per_rank],
               "comm_bytes_by_tag_by_rank": [r["comm_bytes_by_tag"]
                                             for r in per_rank],
               "comm_by_rank": [r["comm"] for r in per_rank],
               "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                             for r in per_rank],
               "one_process_peak_memory_bytes": ref["peak_memory_bytes"]}
        if any(r["losses"] != r0["losses"] for r in per_rank) or \
                r0["backend"] != "gloo" or r0["captured"]:
            raise AssertionError(f"cp {case}/{name}: {row}")
        for r in per_rank:
            want = cp_flash_want(cfg, spec, shape, r["rank"], impl)
            got = {k: v["launches"] for k, v in r["flash"].items()}
            off = {k: v["launches"] - v["by_route"]["3xtf32"]
                   for k, v in r["flash"].items()}
            if got != want or any(off.values()):
                raise AssertionError(f"cp {case}/{name} rank {r['rank']}: "
                                     f"flash {r['flash']}, want {want} on "
                                     f"3xtf32")
            comm_want = cp_comm_want(cfg, spec, shape, impl)
            comm_got = {k: r["comm_by_tag"].get(k, 0) for k in comm_want}
            if comm_got != comm_want:
                raise AssertionError(f"cp {case}/{name} rank {r['rank']}: "
                                     f"collectives {comm_got} != "
                                     f"{comm_want}")
        if name == "gpt2_fp32_2_layers":
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(r0["losses"], ref["losses"]))
            row.update(loss_rel_diff=rel, **r0["weights"])
            if rel > 1e-4 or r0["weights"]["param_update_rel_diff"] > 1e-2 \
                    or r0["weights"]["param_max_abs_diff"] > \
                    2 * spec["lr"] * spec["steps"]:
                raise AssertionError(f"cp {case}: against one process {row}")
        else:
            unit, limit, gaps, ok = mesh_loss_gaps(name, r0["losses"],
                                                   ref["losses"])
            row["loss_gap"] = {"unit": unit, "limit": limit,
                               "by_step": gaps}
            if not ok or not r0["losses"][-1] < r0["losses"][0]:
                raise AssertionError(f"cp {case}/{name}: losses "
                                     f"{r0['losses']} against one process "
                                     f"{ref['losses']}: {row['loss_gap']}")
        note("cp", case, name, {k: row[k] for k in (
            "losses", "one_process_losses", "ms_per_step_by_rank",
            "one_process_ms_per_step", "peak_memory_bytes_by_rank")},
            row.get("loss_gap"))
        rows.append(row)
    return rows


def phase_cp():
    """Phase 24: context parallelism on the one card (see the module
    docstring)."""
    t0 = time.perf_counter()
    wall = {}
    cases_4 = cp_cases(CP_LAYOUTS_4)
    # phase 25 (a), phase 26 (d) and phase 27 (b) ride on this launch of 4
    # ranks (after its cases)
    sw_cases = switch_cases()
    ep_cases = moe_ep_cases()
    refs_4, runs_4 = mesh_runs(cases_4 + sw_cases + ep_cases + ft_cases(),
                               compare={"gpt2_fp32_2_layers",
                                        sw_cases[0][1]["name"],
                                        "gpt2_moe_fp32_2_layers"}, ranks=4)
    n4, n_sw, n_ep = len(cases_4), len(sw_cases), len(ep_cases)
    SHARED["switch_chains"] = (sw_cases, refs_4[sw_cases[0][1]["name"]],
                               [rk[n4:n4 + n_sw] for rk in runs_4])
    SHARED["moe_ep"] = (ep_cases, refs_4,
                        [rk[n4 + n_sw:n4 + n_sw + n_ep] for rk in runs_4])
    SHARED["ft"] = [rk[n4 + n_sw + n_ep] for rk in runs_4]
    runs_4 = [rk[:n4] for rk in runs_4]
    layouts = cp_layout_rows(CP_LAYOUTS_4, cases_4, refs_4, runs_4)
    wall["four_ranks"] = time.perf_counter() - t0
    t = time.perf_counter()
    cases_2 = cp_cases(CP_LAYOUTS_2)
    refs_2, runs_2 = mesh_runs(cases_2, compare={"gpt2_fp32_2_layers"},
                               ranks=2, flag="--cp-rank")
    layouts += cp_layout_rows(CP_LAYOUTS_2, cases_2, refs_2, runs_2)
    extra = [rk[len(cases_2)] for rk in runs_2]
    for x in extra:
        for key, r in x["sharded"].items():
            if not all(v <= 1.0 for v in r["err_over_limit"].values()):
                raise AssertionError(f"cp sharded {key} rank {x['rank']}: "
                                     f"{r}")
    wall["two_ranks"] = time.perf_counter() - t
    t = time.perf_counter()
    reset_flash_counts()
    kernels = cp_kernel_checks()
    check_launches = flash_counts()
    wall["kernels"] = time.perf_counter() - t
    total = flash_totals(r["flash"] for rk in runs_4 + runs_2
                         for r in rk if "flash" in r)
    checks = flash_totals([check_launches] +
                          [x["check_launches"] for x in extra])
    out = {"layouts": layouts, "kernel_cases": kernels,
           "sharded_by_rank": [{"rank": x["rank"], **x["sharded"]}
                               for x in extra],
           "ring_rounds_by_rank": [{"rank": x["rank"], **x["profile"]}
                                   for x in extra],
           "flash_launches": {k: v["launches"] for k, v in total.items()},
           "flash_launches_by_route": {k: v["by_route"]
                                       for k, v in total.items()},
           "check_launches": {k: v["launches"] for k, v in checks.items()},
           "part_wall_s": wall, "nvidia_smi": smi_line(),
           "wall_s": time.perf_counter() - t0}
    emit({"phase": "cp", **out})
    return out


# ---------------------------------------------------------------------------
# hot switching (phase 25)
# ---------------------------------------------------------------------------

SWITCH_STEPS = 6
SWITCH_RANKS = 4
# (a): phase 22 (a)'s fp32 GPT-2 widths at 2 layers from {"dp": 4} on 4
# ranks, global batch 8 in 2 micro-batches (dp 4 takes a row of each):
# (case, sp, optimizer options, switches).  Flat state takes no parameter
# a mesh axis splits (the pure-dp rule), so its chain stays on dp.
SWITCH_CHAINS = [
    ("flat_zero2_to_dp2_subset", False,
     {"zero": 2, "grad_comm": "fp32", "flat_state": True},
     [{"after": 3, "mesh": {"dp": 2}, "ranks": [2, 3]}]),
    ("zero2_to_dp2_tp2_sp_to_dp2_subset", True, {"zero": 2},
     [{"after": 2, "mesh": {"dp": 2, "tp": 2}, "ranks": None},
      {"after": 4, "mesh": {"dp": 2}, "ranks": [2, 3]}]),
]
# (b): Llama-3-8B widths at 2 layers, tp 2 sp for 2 steps, then dp 2 under
# ZeRO-2 (Adam's moments move and chunk) for 2 more, on 2 ranks
SWITCH_FULL = ("tp2_sp_to_dp2_zero2", {"tp": 2}, True, {"zero": 2},
               [{"after": 2, "mesh": {"dp": 2}, "ranks": None}])
SWITCH_ENTRY_ARGS = ["--device", "cuda", "--launch-timeout", "500"]
# what an earlier phase's launch ran for phase 25: (a)'s chains on phase
# 24's 4 ranks, (b) as phase 22's (c); phase 25 alone runs its own
SHARED = {}


def switch_cases():
    """(a)'s cases for ``mesh_rank_main`` from ``{"dp": 4}``."""
    base = mesh_config("gpt2_fp32_b8_switch")
    return [[case, dict(base, switches=sws), {"dp": 4}, sp, kw]
            for case, sp, kw, sws in SWITCH_CHAINS]


def switch_total_bytes(num_params, param_bytes, flat):
    """The bytes a switch's profile counts: the parameters, Adam's fp32 m
    and v (and the flat fp32 master), the step and the betas."""
    return num_params * (param_bytes + 4 * (3 if flat else 2)) + 4 + 8


def switch_rows(case, spec, per_rank, ref, flat):
    """A switched case across its ranks: every held step's loss equal on
    every rank, each switch's profile against the bytes its ranks sent
    and received (moved), the model's state bytes (total) and the flat
    state's (repack), each layout's flash launches on the 3xTF32 route."""
    cfg = GPTConfig(**spec["cfg"])
    n = ref["num_params"]
    held = []
    for j in range(spec["steps"]):
        vals = {r["losses"][j] for r in per_rank
                if r["losses"][j] is not None}
        if len(vals) != 1:
            raise AssertionError(f"{case}: step {j} losses {vals}")
        held.append(vals.pop())
    switches = []
    for k, sw in enumerate(per_rank[0]["switches"]):
        prof = sw["profile"]
        sent = sum(r["switches"][k]["sent_bytes"] for r in per_rank)
        recv = sum(r["switches"][k]["recv_bytes"] for r in per_rank)
        want = {"moved_bytes": sent, "total_bytes": switch_total_bytes(
                    n, torch.empty((), dtype=getattr(torch, cfg.dtype))
                    .element_size(), flat),
                "repack_bytes": n * 4 * 3 if flat else 0}
        got = {key: prof[key] for key in want}
        counts = [{key: v for key, v in r["switches"][k]["profile"].items()
                   if key != "seconds"} for r in per_rank]
        if got != want or recv != sent or \
                any(c != counts[0] for c in counts):
            raise AssertionError(f"{case} switch {k}: profile {prof} "
                                 f"against {want} (received {recv})")
        switches.append({
            "after": sw["after"], "mesh": sw["mesh"], "ranks": sw["ranks"],
            "profile": prof,
            "wall_s_by_rank": [r["switches"][k]["wall_s"] for r in per_rank],
            "sent_bytes_by_rank": [r["switches"][k]["sent_bytes"]
                                   for r in per_rank],
            "staged_bytes_by_rank": [r["switches"][k]["staged_bytes"]
                                     for r in per_rank],
            "peak_memory_bytes_by_rank": [r["switches"][k][
                "peak_memory_bytes"] for r in per_rank]})
    segments = []
    for si, seg in enumerate(per_rank[0]["segments"]):
        tp = seg["mesh"].get("tp", 1)
        rows = [r["segments"][si] for r in per_rank
                if r["segments"][si]["in_mesh"]]
        want = mesh_flash_want(cfg, spec["seq"], rows[0]["steps"],
                               spec["micro"])
        for row in rows:
            got = {k: v["launches"] for k, v in row["flash"].items()}
            if got != want or any(v["by_route"]["3xtf32"] != v["launches"]
                                  for v in row["flash"].values()):
                raise AssertionError(f"{case} layout {seg['mesh']}: flash "
                                     f"{row['flash']} against {want}")
        segments.append({"mesh": seg["mesh"], "ranks": seg["ranks"],
                         "local_heads": cfg.num_heads // tp,
                         "steps": rows[0]["steps"],
                         "ms_per_step_by_rank": [r["ms_per_step"]
                                                 for r in rows],
                         "flash_by_rank": [r["flash"] for r in rows]})
    return held, switches, segments


def switch_capture_check():
    """(c) On a size-1 NCCL mesh in this process: three captured steps,
    a switch onto an identity mesh (a new strategy id, the same layout),
    three more steps; the old capture is dropped and the plan captured
    again, and the losses equal bitwise the same six steps and switch
    taken eagerly (``capture.eager()``)."""
    import socket
    import torch.distributed as dist
    from hetu_tpu_torch.parallel import create_mesh, init_process_group
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    spec = dict(mesh_config("gpt2_fp32_2_layers"), steps=6,
                switches=[{"after": 3, "mesh": {"dp": 1}, "ranks": None}])
    backend = init_process_group(0, 1, f"tcp://127.0.0.1:{port}",
                                 device="cuda", timeout=60.0)
    try:
        captured = mesh_train(spec, create_mesh({"dp": 1}, device="cuda"))
        with capture.eager():
            eager = mesh_train(spec, create_mesh({"dp": 1}, device="cuda"))
    finally:
        dist.destroy_process_group()
    out = {"backend": backend, "captured": captured["captured"],
           "compile_count": captured["compile_count"],
           "captures_total": captured["captures_total"],
           "eager_captures": eager["captures_total"],
           "losses": captured["losses"], "eager_losses": eager["losses"],
           "switch": captured["switches"][0]["profile"]}
    if backend != "nccl" or not captured["captured"] or \
            captured["compile_count"] != 1 or \
            captured["captures_total"] != 2 or eager["captures_total"] or \
            captured["losses"] != eager["losses"]:
        raise AssertionError(f"capture after a switch: {out}")
    return out


def switch_entry():
    """``examples/train_malleus_torch.py`` at the JAX script's defaults on
    4 gloo ranks of the card from the launcher: its gates raise in the
    ranks; rank 0's readings, with its flash launches."""
    spec = importlib.util.spec_from_file_location(
        "train_malleus_torch",
        os.path.join(ROOT, "examples", "train_malleus_torch.py"))
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    t = time.perf_counter()
    # the ranks' host threads: a share of the cores each
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 2) //
                                            (2 * SWITCH_RANKS)))
    try:
        out = entry.main(SWITCH_ENTRY_ARGS)
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    out["wall_s"] = time.perf_counter() - t
    after = out["flash_launches"]["after_switch"]
    if not out["switched"] or not out["history"] or \
            not after["flash_fwd"]["launches"] or \
            not after["flash_bwd_fused"]["launches"] or \
            after["flash_fwd"]["launches"] <= \
            out["flash_launches"]["before_switch"]["flash_fwd"]["launches"]:
        raise AssertionError(f"malleus entry: {out}")
    return out


def phase_switch():
    """Phase 25: hot switching (see the module docstring).  (a) and (b)
    read phase 24's and phase 22's launches where those ran (their
    launches count there: (b)'s in ``mesh_launches``), else run their
    own."""
    t0 = time.perf_counter()
    if "switch_chains" in SHARED:
        cases, ref, runs = SHARED["switch_chains"]
        a_in = "phase 24's launch of 4 ranks"
    else:
        cases = switch_cases()
        refs, runs = mesh_runs(cases, compare={cases[0][1]["name"]},
                               ranks=SWITCH_RANKS)
        ref = refs[cases[0][1]["name"]]
        a_in = "its own launch"
    base = cases[0][1]
    lr, steps = base["lr"], base["steps"]
    chains = []
    for i, (case, sp, kw, sws) in enumerate(SWITCH_CHAINS):
        per_rank = [rk[i] for rk in runs]
        held, switches, segments = switch_rows(
            case, cases[i][1], per_rank, ref, kw.get("flat_state", False))
        rel = max(abs(a - b) / abs(b) for a, b in zip(held, ref["losses"]))
        weights = next(r["weights"] for r in per_rank if "weights" in r)
        row = {"case": case, "sp": sp, "opt": kw, "losses": held,
               "one_process_losses": ref["losses"], "loss_rel_diff": rel,
               **weights, "switches": switches, "layouts": segments}
        if rel > 1e-4 or weights["param_update_rel_diff"] > 1e-2 or \
                weights["param_max_abs_diff"] > 2 * lr * steps:
            raise AssertionError(f"{case}: against one process {row}")
        note("switch", case, {"losses": held, "loss_rel_diff": rel,
                              "update_rel": weights["param_update_rel_diff"]})
        chains.append(row)
    t_a = time.perf_counter() - t0
    case, shape, sp, kw, sws = SWITCH_FULL
    if "switch_full" in SHARED:
        full, per_rank, fref = SHARED["switch_full"]
        b_in = "phase 22's (c)"
    else:
        full = mesh_config("llama3_8b_switch")
        frefs, fruns = mesh_runs([[case, full, shape, sp, kw]])
        fref = frefs[full["name"]]
        per_rank = [rk[0] for rk in fruns]
        b_in = "its own launch"
    held, switches, segments = switch_rows(case, full, per_rank, fref, False)
    unit, limit, gaps, ok = mesh_loss_gaps(full["name"], held,
                                           fref["losses"])
    card = torch.cuda.get_device_properties(0).total_memory
    peaks = switches[0]["peak_memory_bytes_by_rank"]
    full_row = {"case": case, "mesh": shape, "sp": sp, "opt": kw,
                "losses": held, "one_process_losses": fref["losses"],
                "one_process_ms_per_step": fref["ms_per_step"],
                "loss_gap": {"unit": unit, "limit": limit, "by_step": gaps},
                "switch": switches[0], "layouts": segments,
                "card_memory_bytes": card}
    note("switch", case, {"losses": held, "loss_gap": gaps,
                          "switch_wall_s": switches[0]["wall_s_by_rank"],
                          "moved_bytes": switches[0]["profile"]
                          ["moved_bytes"]})
    if not ok or not held[-1] < held[0] or sum(peaks) > card:
        raise AssertionError(f"{case}: {full_row}")
    t_b = time.perf_counter() - t0 - t_a
    capture_row = switch_capture_check()
    t_c = time.perf_counter() - t0 - t_a - t_b
    entry = switch_entry()
    launches = {k: 0 for k in flash_wrappers()}
    by_route = {k: {route: 0 for route in ("wgmma", "3xtf32", "mma.sync")}
                for k in flash_wrappers()}
    for row in chains + ([full_row] if b_in == "its own launch" else []):
        for seg in row["layouts"]:
            for fl in seg["flash_by_rank"]:
                for k, v in fl.items():
                    launches[k] += v["launches"]
                    for route, m in v["by_route"].items():
                        by_route[k][route] += m
    out = {"ranks": {"a": SWITCH_RANKS, "b": MESH_RANKS}, "chains": chains,
           "full_width": full_row, "capture_after_switch": capture_row,
           "ran_in": {"a": a_in, "b": b_in},
           "entry": {k: entry[k] for k in (
               "pre", "post", "ratios", "switched", "strategy", "mesh",
               "ranks", "history", "flash_launches", "wall_s")},
           "one_process": {n: {k: r[k] for k in ("losses", "ms_per_step",
                                                  "captured")}
                           for n, r in ((base["name"], ref),
                                        (full["name"], fref))},
           "flash_launches": launches, "flash_launches_by_route": by_route,
           "entry_flash_launches": {
               k: v["launches"] for k, v in
               entry["flash_launches"]["after_switch"].items()},
           "part_wall_s": {"a": t_a, "b": t_b, "c": t_c,
                           "entry": entry["wall_s"]},
           "nvidia_smi": smi_line(), "wall_s": time.perf_counter() - t0}
    emit({"phase": "switch", **out})
    return out


# ---------------------------------------------------------------------------
# mixture of experts and expert parallelism (phase 26)
# ---------------------------------------------------------------------------

# Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1 config.json: hidden
# 4096, 32 heads, 8 KV heads, expert FFN 14336, 8 experts, top 2, vocab
# 32000, every layer MoE) in the JAX package's MoE form: un-gated
# experts (SwiGLU maps to SiLU), two matrices and biases an expert, the
# package's rope base (10000) and RMSNorm epsilon (1e-6)
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, num_heads=32,
               num_kv_heads=8, ffn_hidden_size=14336, num_experts=8,
               moe_top_k=2, moe_every=1, max_seq_len=32768, sp=False,
               dtype="bfloat16")
MOE_FORM = "JAX form: un-gated silu experts"
# (b): 2 layers, one sequence of 4096 a micro-batch, 2 micro-batches
MOE_TRAIN = {"layers": 2, "batch": 2, "seq": 4096, "micro": 2, "steps": 3,
             "lr": 3e-4}
# (a): the layer at reduced widths against its CPU twin, and the group
# GEMM at the serving chunk's shape
MOE_LAYER = {"d": 1024, "f": 3584, "experts": 8, "k": 2, "tokens": 1024,
             "capacity_factor": 1.25}
MOE_CHUNK = 512
# the device phase 26 holds against its CPU twins
MOE_DEVICE = "cuda"
# (d): on phase 24's launch of 4 ranks
MOE_EP_RANKS = 4
MOE_EP_LAYOUTS = [("dp2_ep2", "gpt2_moe_fp32_2_layers", {"dp": 2, "ep": 2}),
                  ("ep4", "gpt2_moe_fp32_2_layers", {"ep": 4}),
                  ("ep4", "mixtral_1_layer", {"ep": 4})]


def mixtral_config(**kw):
    return llama_config(**{**MIXTRAL, **kw})


def moe_ep_cases():
    """(d)'s cases for ``mesh_rank_main``."""
    return [[case, mesh_config(name), shape, False, {}]
            for case, name, shape in MOE_EP_LAYOUTS]


def moe_fp32_agreement(got, want, tol):
    """The fp32 rule of the kernels' checks, |got - want| <= tol (1 +
    |want|): the largest ratio to it and the largest error."""
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    return (float((err / (tol * (1 + want.abs()))).max()),
            float(err.max()))


def moe_layer_case(mode):
    """(a): ``make_moe_layer`` (top-2 of 8 experts, silu) on the card and
    on the CPU from the same weights and tokens, fp32 with TF32 off: out
    within the forward limit, the balance loss within 1e-5 relative, the
    gradient of every weight within the backward limit; the card's ms of
    forward and backward."""
    from hetu_tpu_torch.nn import make_moe_layer
    c = MOE_LAYER
    rng = np.random.RandomState(5)
    x = rng.randn(2, c["tokens"] // 2, c["d"]).astype(np.float32)
    state = None
    runs = {}
    for which, dev in (("cpu", "cpu"), ("card", MOE_DEVICE)):
        with ht.graph("define_and_run", create_new=True, device=dev,
                      seed=3) as g:
            xt = ht.placeholder("float32", x.shape, name="x")
            moe = make_moe_layer(c["d"], c["f"], c["experts"], k=c["k"],
                                 capacity_factor=c["capacity_factor"],
                                 activation="silu", dispatch_mode=mode)
            out, aux = moe(xt)
            loss = port_ops.functional.reduce_mean(out * out) + 0.01 * aux
            names = [n for n, _ in moe.named_parameters()]
            grads = g.make_gradients(loss, [p for _, p in
                                            moe.named_parameters()])
        if state is None:
            state = module_state_numpy(moe)
        else:
            load_module_state(moe, state)
        fetch = [out, aux] + grads
        vals = g.run(fetch, feed_dict={xt: x})
        ms = None
        if which == "card":
            ms = cuda_time_ms(lambda: g.run(fetch, feed_dict={xt: x}))
        runs[which] = ([v.detach() for v in vals], ms)
        del g, moe
    (want, _), (got, ms) = runs["cpu"], runs["card"]
    out_r = moe_fp32_agreement(got[0], want[0], FP32_FWD_TOL)
    aux_rel = abs(float(got[1]) - float(want[1])) / abs(float(want[1]))
    grads = {n: moe_fp32_agreement(a, b, FP32_BWD_TOL)
             for n, a, b in zip(names, got[2:], want[2:])}
    row = {"mode": mode, "out_err_over_limit": out_r[0],
           "out_max_abs_err": out_r[1], "aux_rel_diff": aux_rel,
           "grad_err_over_limit": {n: r[0] for n, r in grads.items()},
           "fwd_bwd_ms": ms}
    if out_r[0] > 1 or aux_rel > 1e-5 or \
            any(r[0] > 1 for r in grads.values()):
        raise AssertionError(f"MoE layer ({mode}) card against CPU: {row}")
    return row


def moe_gemm_cases():
    """(a): ``blocked_group_gemm`` on the card against its CPU twin at the
    reduced widths (fp32), then at the serving chunk's shape (Mixtral's
    widths, a 512-token chunk, bf16) against the dense all-experts mix on
    the card, with both timed: the group GEMM runs about k/E of the dense
    mix's products."""
    from hetu_tpu_torch.models.generate import (_moe_dense_mix,
                                                _moe_mlp_dispatched)
    from hetu_tpu_torch.nn.moe import ACTIVATIONS
    from hetu_tpu_torch.ops.moe_dispatch import blocked_group_gemm
    c = MOE_LAYER
    gen = torch.Generator().manual_seed(7)
    E, d, f, T, k = c["experts"], c["d"], c["f"], c["tokens"], c["k"]
    w = [torch.randn(s, generator=gen) * 0.02
         for s in ((E, d, f), (E, 1, f), (E, f, d), (E, 1, d))]
    x = torch.randn(T, d, generator=gen)
    topv, topi = torch.softmax(torch.randn(T, E, generator=gen), -1).sort(
        dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    act = ACTIVATIONS["silu"]
    want = blocked_group_gemm(x, topi, topv, *w, act)
    on = [t.to(MOE_DEVICE) for t in (x, topi, topv, *w)]
    got = blocked_group_gemm(*on[:3], *on[3:], act)
    r = moe_fp32_agreement(got, want, FP32_FWD_TOL)
    out = {"cpu_twin": {"tokens": T, "d": d, "f": f, "err_over_limit": r[0],
                        "max_abs_err": r[1],
                        "ms": cuda_time_ms(lambda: blocked_group_gemm(
                            *on[:3], *on[3:], act))}}
    if r[0] > 1:
        raise AssertionError(f"group GEMM card against CPU: {out}")
    cfg = mixtral_config(num_layers=1)
    E, d, f = cfg.num_experts, cfg.hidden_size, cfg.ffn_size
    g = torch.Generator(device=MOE_DEVICE).manual_seed(8)
    wt = [torch.randn(s, generator=g, device=MOE_DEVICE,
                      dtype=torch.bfloat16) * 0.02
          for s in ((E, d), (E, d, f), (E, 1, f), (E, f, d), (E, 1, d))]
    xs = torch.randn(1, MOE_CHUNK, d, generator=g, device=MOE_DEVICE,
                     dtype=torch.bfloat16)
    with torch.no_grad():
        disp = _moe_mlp_dispatched(cfg, xs, *wt)
        dense = _moe_dense_mix(cfg, xs, *wt)
        # the bf16 row rule of the kernels' checks
        err = (disp.float() - dense.float()).abs()
        lim = 2.0 ** -7 * dense.float().abs() + \
            dense.float().pow(2).mean(-1, keepdim=True).sqrt() / 32
        ratio = float((err / lim).max())
        disp_ms = cuda_time_ms(lambda: _moe_mlp_dispatched(cfg, xs, *wt))
        dense_ms = cuda_time_ms(lambda: _moe_dense_mix(cfg, xs, *wt))
    out["serving_chunk"] = {
        "tokens": MOE_CHUNK, "d": d, "f": f, "experts": E, "k": cfg.moe_top_k,
        "dtype": "bfloat16", "err_over_bf16_limit": ratio,
        "group_gemm_ms": disp_ms, "dense_mix_ms": dense_ms,
        "form": MOE_FORM}
    if ratio > 1:
        raise AssertionError(f"group GEMM against the dense mix: {out}")
    del wt, xs
    torch.cuda.empty_cache()
    return out


def moe_weights_gap(final, want, init, lr, steps):
    """Phase 8's update rule between two runs' final weights (device
    tensors by name) from ``init``: (update rel diff, max abs diff)."""
    upd_rel, max_abs = 0.0, 0.0
    for k, w in want.items():
        diff = (final[k].float() - w.float())
        max_abs = max(max_abs, float(diff.abs().max()))
        moved = float((w.float() - init[k].float()).norm())
        if moved > 0:
            upd_rel = max(upd_rel, float(diff.norm()) / moved)
    return upd_rel, max_abs


def moe_train():
    """(b): Mixtral's widths at 2 layers in bf16 (the LLaMA path), seeded
    random weights, one seeded batch of 2 x 4096 in 2 micro-batches, 3
    Adam steps eagerly (``capture.eager()``) and then 3 on the captured
    step from the same weights: losses and updates within phase 8's
    limits, the loss falling; each flash kernel once a layer,
    micro-batch and step on 3xTF32; ms a step, peak memory."""
    c = MOE_TRAIN
    cfg = mixtral_config(num_layers=c["layers"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = seeded_batch(cfg.vocab_size, c["batch"], c["seq"], seed=2)
    init = random_state(cfg, seed=0, device=MOE_DEVICE)
    runs = {}
    for how in ("eager", "captured"):
        g, ids, labels, model, loss, train_op = build_trainer(
            cfg, c["batch"], c["seq"], MOE_DEVICE, lr=c["lr"])
        load_state(model, init)
        feeds = {ids: x, labels: y}
        reset_flash_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        losses, step_s = [], []
        ctx = capture.eager() if how == "eager" else contextlib.nullcontext()
        with ctx:
            for _ in range(c["steps"]):
                t = time.perf_counter()
                losses.append(float(g.run(loss, [loss, train_op], feeds,
                                          num_micro_batches=c["micro"])[0]))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
        final = {_Params._norm(n): g.get_tensor_value(p).detach().clone()
                 for n, p in model.named_parameters()}
        runs[how] = {"losses": losses,
                     "ms_per_step": 1e3 * float(np.mean(step_s[1:])),
                     "step_s": step_s, "captured": g.last_run_captured,
                     "compile_count": g.compile_count,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "step_peak_bytes": torch.cuda.max_memory_allocated()
                     - before, "flash": flash_counts(), "_final": final}
        del g, ids, labels, model, loss, train_op, feeds
        gc.collect()
        torch.cuda.empty_cache()
    e, cp = runs["eager"], runs["captured"]
    upd_rel, max_abs = moe_weights_gap(cp.pop("_final"), e.pop("_final"),
                                       init, c["lr"], c["steps"])
    del init
    torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(e["losses"],
                                                        cp["losses"]))
    want = mesh_flash_want(cfg, c["seq"], c["steps"], c["micro"])
    for how, r in runs.items():
        got = {k: v["launches"] for k, v in r["flash"].items()}
        off = {k: v["launches"] - v["by_route"]["3xtf32"]
               for k, v in r["flash"].items()}
        if got != want or any(off.values()):
            raise AssertionError(f"MoE training ({how}): flash {r['flash']}"
                                 f", want {want} on 3xtf32")
    row = {"model": f"Mixtral-8x7B widths, {c['layers']} layers, "
           f"random bf16 weights (seed 0); {MOE_FORM}",
           "params": sum(int(np.prod(s)) for s in
                         state_shapes(cfg).values()),
           **{k: c[k] for k in ("batch", "seq", "micro", "steps", "lr")},
           "eager": e, "captured": cp, "loss_rel_diff": loss_rel,
           "param_update_rel_diff": upd_rel, "param_max_abs_diff": max_abs,
           "bitwise_equal_losses": e["losses"] == cp["losses"]}
    if not cp["captured"] or cp["compile_count"] != 1 or \
            loss_rel > 1e-4 or upd_rel > 1e-2 or \
            max_abs > 2 * c["lr"] * c["steps"] or \
            not cp["losses"][-1] < cp["losses"][0]:
        raise AssertionError(f"MoE training, captured against eager: {row}")
    return row


def engine_tie_rule(state, cfg, prompts, got, want, what):
    """bf16 greedy tokens of an engine (``got``) against a reference
    (``want``): at each greedy request's first difference an fp32 forward
    of the same weights (TF32 off) over the common prefix puts the
    engine's token within ``SPEC_TIE_LIMIT`` of its largest logit, or the
    phase fails; the reference token's gap is printed beside it.
    Returns the differences, read."""
    diffs = first_differences(got, want)
    out = {"equal": not diffs, "first_differences": diffs,
           "tokens_differing": sum(a != b for g, w in zip(got, want)
                                   for a, b in zip(g, w))}
    if not diffs:
        return out
    exact = ({k: v.float() for k, v in state.items()},
             dataclasses.replace(cfg, dtype="float32"))
    rows = []
    for i, j in diffs:
        if i == MIX_SAMPLED:
            continue
        gaps, top = tie_gaps(*exact, prompts[i] + want[i][:j],
                             (got[i][j], want[i][j]))
        rows.append({"request": i, "position": j, "engine": got[i][j],
                     "reference": want[i][j], "fp32_gap_engine": gaps[0],
                     "fp32_gap_reference": gaps[1], "fp32_top": top["top"]})
    del exact
    gc.collect()
    torch.cuda.empty_cache()
    out["near_ties"] = rows
    over = [r for r in rows if not r["fp32_gap_engine"] <= SPEC_TIE_LIMIT]
    if over:
        emit({"phase": "moe_mismatch", "of": what,
              "first_differences": diffs, "over_tie_limit": over})
        raise AssertionError(f"{what}: the engine's token lies off the fp32 "
                             f"forward's top by more than {SPEC_TIE_LIMIT}"
                             f": {over}")
    return out


def moe_serve(dtype):
    """(c) in one dtype: phase 4's traffic on a captured engine at
    Mixtral's widths, 2 layers (random weights from seed 0), after a
    warm-up that captures its graphs (``compile_count`` then stable);
    kernel 5 once a layer and unified step.  In fp32 (TF32 off) the
    greedy requests' tokens equal the eager solo ``generate``'s; in bf16
    each greedy request's tokens may part from the solo ``generate``'s
    only where the engine's token lies within ``SPEC_TIE_LIMIT`` of an
    fp32 forward's largest logit (``engine_tie_rule``).  The rule judges
    the engine's token alone: a bf16 gate logit a rounding away from a
    tie flips a top-2 expert in ``generate``'s own forward too, which
    moved its token 0.78 below the fp32 top on an H100 (PERF.md, phase
    26); ``generate``'s gap is printed beside the engine's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mixtral_config(num_layers=2, dtype=dtype)
    state = random_state(cfg, seed=0, device=MOE_DEVICE)
    eng = Engine(state, cfg, num_pages=256, page_size=64, max_batch=8,
                 chunk_size=MOE_CHUNK, prefill_rows=1, max_model_len=8192,
                 device=MOE_DEVICE)
    rng = np.random.RandomState(0)
    v = cfg.vocab_size
    mix = make_mix(rng, v, [32, 3000, 700, 1500, 64, 2200, 400],
                   header_len=1024, tail=200)
    t = time.perf_counter()
    eng.add_request(rng.randint(1, v, size=16).tolist(), 2)
    eng.run()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t
    compiled = eng.compile_count
    calls0 = eng.executable_calls
    ragged_paged_attention_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    reqs = serve_mix(eng, *mix)
    wall = time.perf_counter() - t
    launches = ragged_paged_attention_cuda.launches
    calls = eng.executable_calls - calls0
    check_compile_count(eng, compiled, f"moe serving {dtype}")
    if launches != cfg.num_layers * calls:
        raise AssertionError(f"moe serving {dtype}: kernel 5 launched "
                             f"{launches} times in {calls} steps")
    got = [list(r.out_tokens) for r in reqs]
    if not all(len(g_) == 32 for g_ in got):
        raise AssertionError("not every request finished with 32 tokens")
    peak = torch.cuda.max_memory_allocated()
    compile_count = eng.compile_count
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    prompts = mix[0] + [mix[1]]
    with torch.no_grad():
        solo = [got[i] if i == MIX_SAMPLED else
                generate(state, cfg, [p], 32, device=MOE_DEVICE)[0, len(p):]
                .tolist() for i, p in enumerate(prompts)]
    rule = tokens_rule(state, cfg, mix, got, solo,
                       f"moe serving {dtype}") if dtype == "float32" else \
        engine_tie_rule(state, cfg, prompts, got, solo,
                        f"moe serving {dtype}")
    rule["against"] = "eager solo generate"
    toks = sum(len(g_) for g_ in got)
    out = {"dtype": dtype, "compile_count": compile_count,
           "warmup_and_capture_s": warmup_s, "requests": len(reqs),
           "generated_tokens": toks, "wall_s": wall,
           "tokens_per_s": toks / wall, "unified_steps": calls,
           "kernel_launches": launches,
           "peak_memory_bytes": peak, "greedy_against_generate": rule}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_ep_rows(cases, refs, runs):
    """(d): each layout against its one-process run (captured): every rank
    the same loss; the fp32 GPT-2 layouts within 1e-4 and phase 8's
    update rule, Mixtral's by ``MESH_LOSS_LIMITS``' 2 %; every rank's
    flash launches one a layer, micro-batch and step on 3xTF32; the EP
    collectives' bytes by kind, tag and axis (``comm_stats``)."""
    rows = []
    for i, (case, spec, shape, sp, _) in enumerate(cases):
        name, ref = spec["name"], refs[spec["name"]]
        per_rank = [rk[i] for rk in runs]
        r0 = per_rank[0]
        cfg = GPTConfig(**spec["cfg"])
        row = {"layout": case, "config": name, "mesh": shape,
               "backend": r0["backend"], "losses": r0["losses"],
               "one_process_losses": ref["losses"],
               "ms_per_step_by_rank": [r["ms_per_step"] for r in per_rank],
               "one_process_ms_per_step": ref["ms_per_step"],
               "comm_bytes_by_tag_by_rank": [r["comm_bytes_by_tag"]
                                             for r in per_rank],
               "comm_by_rank": [r["comm"] for r in per_rank],
               "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                             for r in per_rank],
               "flash_by_rank": [{k: v["launches"] for k, v in
                                  r["flash"].items()} for r in per_rank],
               "flash_routes_by_rank": [{k: v["by_route"] for k, v in
                                         r["flash"].items()}
                                        for r in per_rank]}
        if any(r["losses"] != r0["losses"] for r in per_rank) or \
                r0["captured"]:
            raise AssertionError(f"moe ep {case}/{name}: {row}")
        want = mesh_flash_want(cfg, spec["seq"], spec["steps"],
                               spec["micro"])
        for r in per_rank:
            got = {k: v["launches"] for k, v in r["flash"].items()}
            if got != want or any(v["launches"] != v["by_route"]["3xtf32"]
                                  for v in r["flash"].values()):
                raise AssertionError(f"moe ep {case}/{name} rank "
                                     f"{r['rank']}: flash {r['flash']}")
            ep_bytes = sum(n for k, n in r["comm_bytes_by_tag"].items()
                           if k.startswith("all_gather|") and
                           k.split("|")[2] == "ep")
            if shape.get("ep", 1) > 1 and not ep_bytes:
                raise AssertionError(f"moe ep {case}: no all-gather over ep")
        row["ep_all_gather_bytes_by_rank"] = [
            sum(n for k, n in r["comm_bytes_by_tag"].items()
                if k.startswith("all_gather|") and k.split("|")[2] == "ep")
            for r in per_rank]
        row["staged_bytes_by_rank"] = [
            sum(n for k, n in r["comm_bytes_by_tag"].items()
                if k.endswith("|staged")) for r in per_rank]
        row["all_to_all_bytes_by_rank"] = [
            sum(n for k, n in r["comm_bytes_by_tag"].items()
                if k.startswith("all_to_all|")) for r in per_rank]
        if name == "gpt2_moe_fp32_2_layers":
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(r0["losses"], ref["losses"]))
            row.update(loss_rel_diff=rel, **r0["weights"])
            if rel > 1e-4 or r0["weights"]["param_update_rel_diff"] > 1e-2 \
                    or r0["weights"]["param_max_abs_diff"] > \
                    2 * spec["lr"] * spec["steps"]:
                raise AssertionError(f"moe ep {case}: against one process "
                                     f"{row}")
        else:
            unit, limit, gaps, ok = mesh_loss_gaps(name, r0["losses"],
                                                   ref["losses"])
            row["loss_gap"] = {"unit": unit, "limit": limit,
                               "by_step": gaps}
            row["form"] = MOE_FORM
            if not ok:
                raise AssertionError(f"moe ep {case}/{name}: {row}")
        note("moe", case, name, {k: row[k] for k in (
            "losses", "one_process_losses", "ms_per_step_by_rank",
            "ep_all_gather_bytes_by_rank")})
        rows.append(row)
    return rows


def phase_moe():
    """Phase 26: mixture of experts and expert parallelism (see the module
    docstring).  (d) reads phase 24's launch of 4 ranks where it ran, else
    starts its own."""
    t0 = time.perf_counter()
    wall = {}
    layer = [moe_layer_case(mode) for mode in ("capacity", "dropless")]
    gemm = moe_gemm_cases()
    wall["a"] = time.perf_counter() - t0
    t = time.perf_counter()
    train = moe_train()
    wall["b"] = time.perf_counter() - t
    t = time.perf_counter()
    serve = {d: moe_serve(d) for d in ("float32", "bfloat16")}
    wall["c"] = time.perf_counter() - t
    t = time.perf_counter()
    if "moe_ep" in SHARED:
        cases, refs, runs = SHARED["moe_ep"]
        d_in = "phase 24's launch of 4 ranks"
    else:
        cases = moe_ep_cases()
        refs, runs = mesh_runs(cases, compare={"gpt2_moe_fp32_2_layers"},
                               ranks=MOE_EP_RANKS)
        d_in = "its own launch"
    ep = moe_ep_rows(cases, refs, runs)
    wall["d"] = time.perf_counter() - t
    flash = flash_totals([train["eager"]["flash"], train["captured"]["flash"]]
                         + [r["flash"] for rk in runs for r in rk])
    out = {"form": MOE_FORM, "layer": layer, "group_gemm": gemm,
           "train": train, "serve": serve, "ep": ep, "ep_ran_in": d_in,
           "flash_launches": {k: v["launches"] for k, v in flash.items()},
           "flash_launches_by_route": {k: v["by_route"]
                                       for k, v in flash.items()},
           "ragged_launches": sum(s["kernel_launches"]
                                  for s in serve.values()),
           "part_wall_s": wall, "nvidia_smi": smi_line(),
           "wall_s": time.perf_counter() - t0}
    emit({"phase": "moe", **out})
    return out


# ---------------------------------------------------------------------------
# the runtime planes (phase 27)
# ---------------------------------------------------------------------------

# (a): Llama-3-8B widths, depth 32 -> 2, bf16, a batch of 2 x 4096 tokens
SENTRY_LAYERS, SENTRY_BATCH, SENTRY_SEQ, SENTRY_STEPS = 2, 2, 4096, 6
SENTRY_OFF_STEPS = 3
# the poisoned run: a poisoned attempt before clean step k (the loss spike
# after the sentry's warm-up of 2 clean steps)
SENTRY_POISON = {1: "grad_nan", 3: "grad_spike", 4: "loss_spike"}
# the calls that copy a tensor to the host
HOST_READS = ("item", "cpu", "tolist", "numpy", "__float__")

# (b): GPT-2 small's widths (vocab 50257), depth 12 -> 2, bf16, flat
# ZeRO-2, on phase 24's 4 ranks; the fault plan of tests/test_torch_ft.py
FT_PLAN = [(3, "grad_nan", 0), (6, "loss_spike", 0), (9, "shard_corrupt", 0),
           (10, "worker_death", 3), (11, "kill_mid_write", 0)]
FT_STEPS, FT_EVERY, FT_KEEP, FT_TTL = 16, 4, 2, 3.0
# the JAX trainer's counters on FT_PLAN (tests/test_torch_ft.py holds the
# port's to them on 4 CPU devices)
FT_COUNTERS = {"sentry_anomalies": 2, "steps_skipped": 2, "rewinds": 1,
               "restore_fallbacks": 1, "emergency_flushes": 0,
               "checkpoints_written": 4, "checkpoint_write_failures": 1,
               "worker_recoveries": 1}
# the loss is a bf16 number (2**-4 apart at 11): after the death the
# losses hold phase 22's rule for bf16 GPT-2 small, one bf16 step
FT_LOSS_LIMIT = MESH_LOSS_LIMITS["gpt2_small_bf16"]
# the final fp32 master's distance from the reference's, in units of the
# distance the reference travels in one generation (FT_EVERY steps): on
# an H100 a sound run parts 0.028 (the fused flash backward's dQ atomics
# add in no fixed order), the master against the reference's one
# generation back 1.0
FT_STATE_LIMIT = 0.25
FT_RANKS = 4

# (c): phase 15's configuration, traced, and the op profiler
TRACE_STEPS = 6


@contextlib.contextmanager
def host_reads():
    """Counts the calls that copy a CUDA tensor to the host."""
    box = [0]
    saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}

    def wrap(orig):
        def read(t, *a, **k):
            if t.is_cuda:
                box[0] += 1
            return orig(t, *a, **k)
        return read
    for n, orig in saved.items():
        setattr(torch.Tensor, n, wrap(orig))
    try:
        yield box
    finally:
        for n, orig in saved.items():
            setattr(torch.Tensor, n, orig)


def held_tensors(g, opt):
    """Every variable and optimizer tensor of the graph, by name."""
    out = {("var", k): v for k, v in g._var_data.items()}

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(prefix + (k,), v)
            elif isinstance(v, torch.Tensor):
                out[prefix + (k,)] = v
            elif isinstance(v, list):
                for i, t in enumerate(v):
                    out[prefix + (k, i)] = t
    walk(("opt",), opt._state)
    return out


class HostSnapshot:
    """The bytes of a set of device tensors copied to one pinned host
    buffer (the card has no room for a second copy of Adam's state at
    Llama-3-8B widths), and a bitwise comparison against them, chunk by
    chunk on the card."""

    CHUNK = 1 << 28

    def __init__(self, tensors):
        self.sizes = {k: t.numel() * t.element_size()
                      for k, t in tensors.items()}
        self.host = torch.empty(sum(self.sizes.values()), dtype=torch.uint8,
                                pin_memory=True)

    @staticmethod
    def _bytes(t):
        return t.detach().reshape(-1).view(torch.uint8)

    def take(self, tensors):
        off = 0
        for k, t in tensors.items():
            n = self.sizes[k]
            self.host[off:off + n].copy_(self._bytes(t), non_blocking=True)
            off += n
        torch.cuda.synchronize()

    def changed(self, tensors):
        """The names whose bytes differ from the snapshot."""
        out, off = [], 0
        for k, t in tensors.items():
            n, b = self.sizes[k], self._bytes(t)
            same = True
            for lo in range(0, n, self.CHUNK):
                hi = min(n, lo + self.CHUNK)
                dev = self.host[off + lo:off + hi].to(b.device,
                                                      non_blocking=True)
                if not torch.equal(dev, b[lo:hi]):
                    same = False
                    break
            if not same:
                out.append(str(k))
            off += n
        return out


def sentry_run(sentry, steps, poison=None):
    """(a)'s run: ``steps`` Adam steps of Llama-3-8B's widths at 2 layers
    on seeded cursors, captured; with ``poison`` a poisoned attempt (on a
    batch of its own) before the clean steps it names, each held bitwise
    against the state before it.  Each step's host reads are counted."""
    cfg = llama3_8b_config(num_layers=SENTRY_LAYERS)
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as g:
        ids = ht.parallel_placeholder("int32", (SENTRY_BATCH, SENTRY_SEQ),
                                      name="input_ids")
        labels = ht.parallel_placeholder("int32", (SENTRY_BATCH, SENTRY_SEQ),
                                         name="labels")
        model = GPTLMHeadModel(cfg)
        loss = model(ids, labels)
        opt = ht.optim.AdamOptimizer(lr=3e-4, sentry=sentry)
        train_op = opt.minimize(loss)
    g.run([], run_level="alloc")

    def one(x, y):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with host_reads() as box:
            l, _ = g.run(loss, [loss, train_op], {ids: x, labels: y})
            lv = float(l)
            v = opt.sentry.last_verdict() if opt.sentry is not None else None
        torch.cuda.synchronize()
        return lv, v, box[0], time.perf_counter() - t

    bad = seeded_batch(cfg.vocab_size, SENTRY_BATCH, SENTRY_SEQ, seed=99)
    losses, step_s, reads, poisoned = [], [], [], []
    graphs, snap = None, None
    for k in range(steps):
        if poison and k in poison:
            kind = poison[k]
            held = held_tensors(g, opt)
            if snap is None:
                snap = HostSnapshot(held)
            t = time.perf_counter()
            snap.take(held)
            snap_s = time.perf_counter() - t
            graphs_before = (g.compile_count, g.captures_total)
            g.inject_numeric_fault(kind)
            lv, v, n, dt = one(*bad)
            t = time.perf_counter()
            changed = snap.changed(held_tensors(g, opt))
            rec = {"kind": kind, "before_clean_step": k, "loss": lv,
                   "verdict": v, "tensors_held": len(held),
                   "bytes_held": sum(snap.sizes.values()),
                   "changed_tensors": changed, "host_reads": n,
                   "ms": dt * 1e3, "snapshot_s": snap_s,
                   "compare_s": time.perf_counter() - t,
                   "graphs": [g.compile_count, g.captures_total]}
            del held
            poisoned.append(rec)
            flag = {"grad_nan": "grad_nonfinite", "grad_spike": "grad_spike",
                    "loss_spike": "loss_spike"}[kind]
            if not (v["anomaly"] and v[flag]) or changed or \
                    (g.compile_count, g.captures_total) != graphs_before:
                raise AssertionError(f"sentry: the poisoned step {rec}")
        x, y = seeded_batch(cfg.vocab_size, SENTRY_BATCH, SENTRY_SEQ,
                            seed=100 + k)
        lv, v, n, dt = one(x, y)
        if v is not None and v["anomaly"]:
            raise AssertionError(f"sentry: clean step {k} judged {v}")
        losses.append(lv)
        step_s.append(dt)
        reads.append(n)
        if graphs is None:
            graphs = (g.compile_count, g.captures_total)
        elif (g.compile_count, g.captures_total) != graphs:
            raise AssertionError(f"sentry: graphs {graphs} -> "
                                 f"{(g.compile_count, g.captures_total)}")
    out = {"sentry": sentry, "losses": losses, "step_s": step_s,
           "ms_per_step": 1e3 * float(np.mean(step_s[1:])),
           "host_reads_a_step": reads, "poisoned": poisoned,
           "compile_count": g.compile_count,
           "captures_total": g.captures_total,
           "plans": len(g._plan_pool), "captured": g.last_run_captured,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    note("runtime_planes", "sentry run", {k: out[k] for k in (
        "sentry", "losses", "ms_per_step", "host_reads_a_step",
        "peak_memory_bytes")})
    del g, model, ids, labels, loss, train_op, opt, snap
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def sentry_in_captured_step():
    """(a): the clean run, the poisoned run on the same cursors and a run
    without the sentry; the clean steps' losses bitwise equal, every
    step one host read, one captured graph throughout."""
    clean = sentry_run(True, SENTRY_STEPS)
    chaos = sentry_run(True, SENTRY_STEPS, SENTRY_POISON)
    off = sentry_run(False, SENTRY_OFF_STEPS)
    if chaos["losses"] != clean["losses"]:
        raise AssertionError(f"sentry: clean losses {chaos['losses']} != "
                             f"{clean['losses']}")
    for r in (clean, chaos, off):
        if set(r["host_reads_a_step"]) != {1} or \
                (r["compile_count"], r["captures_total"], r["plans"]) != \
                (1, 1, 1) or not r["captured"]:
            raise AssertionError(f"sentry: a step's host reads "
                                 f"{r['host_reads_a_step']}, graphs "
                                 f"{r['compile_count']}/"
                                 f"{r['captures_total']}, plans "
                                 f"{r['plans']}")
    if any(p["host_reads"] != 1 for p in chaos["poisoned"]):
        raise AssertionError("sentry: a poisoned step read the host more "
                             "than once")
    return {"config": "llama3_8b_2_layers", "layers": SENTRY_LAYERS,
            "batch": SENTRY_BATCH, "seq": SENTRY_SEQ, "dtype": "bfloat16",
            "losses": clean["losses"],
            "poisoned": chaos["poisoned"],
            "ms_per_step_sentry_on": clean["ms_per_step"],
            "ms_per_step_poisoned_run": chaos["ms_per_step"],
            "ms_per_step_sentry_off": off["ms_per_step"],
            "host_reads_a_step": {"on": clean["host_reads_a_step"],
                                  "off": off["host_reads_a_step"]},
            "graphs": [chaos["compile_count"], chaos["captures_total"]],
            "peak_memory_bytes": max(r["peak_memory_bytes"]
                                     for r in (clean, chaos, off))}


def ft_spec():
    cfg = GPTConfig(vocab_size=50257, num_layers=2, dtype="bfloat16")
    return {"name": "gpt2_small_2_layers_ft", "kind": "ft",
            "cfg": dataclasses.asdict(cfg), "batch": 8, "seq": 1024,
            "lr": 3e-4, "steps": FT_STEPS}


def ft_cases():
    """(b)'s case for ``mesh_rank_main``."""
    return [["ft", ft_spec(), {"dp": FT_RANKS}, False,
             {"zero": 2, "grad_comm": "fp32", "flat_state": True}]]


def ft_rank(spec, opt_kw, ckdir):
    """(b) in one rank: the fault-tolerant trainer over the world's ranks
    under ``FT_PLAN`` (a worker a rank, heartbeats on a coordinator of
    rank 0), a background save of the final layout, then a fault-free run
    of the first layout on the committed cursors."""
    import torch.distributed as dist
    from hetu_tpu_torch.elastic import (FaultTolerantTrainer, TrainBuild,
                                        WorkerMonitor)
    from hetu_tpu_torch.fault import FaultEvent, FaultPlan
    from hetu_tpu_torch.parallel import P, create_mesh
    from hetu_tpu_torch.resilience import list_generations, verify_generation
    from hetu_tpu_torch.resilience.generations import generation_dir
    world = dist.get_world_size()
    cfg = GPTConfig(**{**spec["cfg"], "sp": False})
    batch, seq = spec["batch"], spec["seq"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_flash_counts()
    torch.cuda.reset_peak_memory_stats()

    def build(dp, ranks):
        mesh = create_mesh({"dp": dp}, device="cuda", ranks=list(ranks)[:dp])
        with ht.graph("define_and_run", create_new=True, mesh=mesh, seed=0,
                      device=mesh.device) as g:
            ids = ht.parallel_placeholder("int32", (batch, seq),
                                          pspec=P("dp", None))
            labels = ht.parallel_placeholder("int32", (batch, seq),
                                             pspec=P("dp", None))
            model = GPTLMHeadModel(cfg)
            loss = model(ids, labels)
            opt = ht.optim.AdamOptimizer(lr=spec["lr"], sentry=True,
                                         **opt_kw)
            train_op = opt.minimize(loss)
        if mesh.in_mesh:
            g.run([], run_level="alloc")

        def step_fn(cursor):
            x, y = seeded_batch(cfg.vocab_size, batch, seq, seed=500 + cursor)
            out = g.run(loss, [loss, train_op], {ids: x, labels: y})
            return float(out[0])
        return TrainBuild(graph=g, model=model, optimizer=opt,
                          step_fn=step_fn)

    t0 = time.perf_counter()
    mon = WorkerMonitor(world, list(range(world)), ttl=FT_TTL,
                        heartbeat_interval=0.1)
    tr = FaultTolerantTrainer(build, list(range(world)), monitor=mon,
                              checkpoint_dir=ckdir,
                              checkpoint_every=FT_EVERY,
                              keep_checkpoints=FT_KEEP)
    plan = FaultPlan(events=[FaultEvent(step=s, kind=k, target=t)
                             for s, k, t in FT_PLAN])
    losses = tr.train(FT_STEPS, fault_plan=plan)
    train_s = time.perf_counter() - t0
    out = {"losses": losses, "metrics": tr.metrics_summary(),
           "recoveries": [{k: v for k, v in r.items()
                           if k not in ("killed_at", "_t0")}
                          for r in tr.recoveries],
           "writes": tr.writes, "cursors": tr.committed_cursors(),
           "burned": list(tr.burned_cursors), "dp": tr.dp,
           "in_mesh": tr.build.graph.mesh.in_mesh,
           "generations": {str(s): verify_generation(
               generation_dir(ckdir, s))[0] for s in list_generations(ckdir)},
           "attempts": tr.attempts, "train_s": train_s}
    mon.close()
    if dist.get_rank() == 0:
        note("runtime_planes", "ft", {k: out[k] for k in (
            "losses", "metrics", "dp", "generations", "train_s")})
    # the multi-process background save of the final layout: the writer
    # threads meet at the coordinator's barriers; the mesh's first rank,
    # which writes the index and the marker last, reads the bytes
    g = tr.build.graph
    if g.mesh.in_mesh:
        d = os.path.join(ckdir, "background")
        torch.cuda.synchronize()
        t = time.perf_counter()
        h = ht_ckpt.save_checkpoint(tr.build.model, tr.build.optimizer, d,
                                    step=FT_STEPS, background=True)
        returned = time.perf_counter() - t
        h.wait(timeout=600)
        out["background_save"] = {"returned_s": returned,
                                  "seconds": time.perf_counter() - t}
        if g.mesh.position == 0:
            out["background_save"]["bytes"] = sum(
                os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["flash"] = flash_counts()
    # the fault-free reference on the committed cursors, along the
    # trainer's layouts (its launches apart): the first layout up to the
    # death's resume step, a plain checkpoint of it (no generation), the
    # survivors' layout from that checkpoint to the end, its fp32 master
    # kept one generation (FT_EVERY steps) before the end
    death = [r for r in tr.recoveries if r["kind"] == "worker_death"]
    pre = death[0]["resumed_from_step"] if death else len(out["cursors"])
    ref = build(world, list(range(world)))
    out["ref_losses"] = [ref.step_fn(c) for c in out["cursors"][:pre]]
    if death:
        d = os.path.join(ckdir, "reference")
        ht_ckpt.save_checkpoint(ref.model, ref.optimizer, d, step=pre)
        dist.barrier()
        del ref
        survivors = [r for r in range(world) if r not in death[0]["dead"]]
        ref = build(tr.dp, survivors)
        ht_ckpt.load_checkpoint(ref.model, ref.optimizer, d)
    if ref.graph.mesh.in_mesh:
        rest = out["cursors"][pre:]
        out["ref_losses"] += [ref.step_fn(c) for c in rest[:-FT_EVERY]]
        gen_before = [m.clone() for m in ref.optimizer._state["flat_master"]]
        out["ref_losses"] += [ref.step_fn(c) for c in rest[-FT_EVERY:]]
        # the final fp32 master against the reference's, in units of one
        # generation's travel (the reference's last FT_EVERY steps): the
        # card's atomics part them by rounding, a restore of another
        # generation or a rewind that lost or kept steps by about one
        mine = tr.build.optimizer._state["flat_master"]
        theirs = ref.optimizer._state["flat_master"]

        def sq(a, b):
            return sum(float((x.double() - y.double()).pow(2).sum())
                       for x, y in zip(a, b))
        out["state"] = {
            "chunks": len(mine),
            "unequal": sum(not torch.equal(x, y)
                           for x, y in zip(mine, theirs)),
            "max_abs_diff": max(float((x.double() - y.double()).abs().max())
                                for x, y in zip(mine, theirs)),
            "sq_gap": sq(mine, theirs),
            "sq_generation": sq(theirs, gen_before),
            "sq_control": sq(mine, gen_before),
            "step": [float(tr.build.optimizer._state["step"]),
                     float(ref.optimizer._state["step"])]}
        del gen_before
    tr.close()
    dist.barrier()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ft_rows(runs):
    """(b)'s gates over the ranks' readings."""
    first = runs[0]
    for r in runs:
        for key in ("losses", "metrics", "cursors", "burned", "dp"):
            if r[key] != first[key]:
                raise AssertionError(f"ft: rank {r['rank']} {key} "
                                     f"{r[key]} != {first[key]}")
    m = {k: first["metrics"][k] for k in FT_COUNTERS}
    if m != FT_COUNTERS:
        raise AssertionError(f"ft: counters {m} != JAX's {FT_COUNTERS}")
    death = [rec for rec in first["recoveries"]
             if rec["kind"] == "worker_death"]
    if len(death) != 1 or death[0]["dp"] != 2:
        raise AssertionError(f"ft: recoveries {first['recoveries']}")
    pre = death[0]["resumed_from_step"]
    got, want = first["losses"], first["ref_losses"]
    if got[:pre] != want[:pre]:
        raise AssertionError(f"ft: losses before the death {got[:pre]} != "
                             f"{want[:pre]}")
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    steps = [bf16_steps(a, b) for a, b in zip(got, want)]
    if len(got) != len(want) or not all(np.isfinite(got)) or \
            max(steps) > FT_LOSS_LIMIT[1]:
        raise AssertionError(f"ft: losses {got} against {want}: "
                             f"{max(steps)} bf16 steps > {FT_LOSS_LIMIT}")
    # the loss is too coarse to see a wrong restore (bf16, 2**-4 apart at
    # 11, and lr 3e-4 barely moves it): the final fp32 master over the
    # last mesh's ranks is held to the reference's, its gap within
    # FT_STATE_LIMIT of one generation's travel, the step counters equal;
    # the gate must fail the trainer's master against the reference's one
    # generation back (the control)
    states = [r["state"] for r in runs if "state" in r]
    if len(states) != first["dp"]:
        raise AssertionError(f"ft: {len(states)} ranks hold a state")
    travel = sum(st["sq_generation"] for st in states)
    gap = math.sqrt(sum(st["sq_gap"] for st in states) / travel)
    control = math.sqrt(sum(st["sq_control"] for st in states) / travel)
    if not gap <= FT_STATE_LIMIT < control or \
            any(st["step"][0] != st["step"][1] for st in states):
        raise AssertionError(f"ft: the final master {gap:.4g} generations "
                             f"from the reference's (limit "
                             f"{FT_STATE_LIMIT}, control {control:.4g}): "
                             f"{states}")
    if first["generations"].get("12") is not False or \
            not all(first["generations"].get(s) for s in ("4", "8")):
        raise AssertionError(f"ft: generations {first['generations']}")
    return {"config": "gpt2_small_2_layers", "ranks": len(runs),
            "plan": FT_PLAN, "losses": got, "ref_losses": want,
            "max_rel_loss_gap": max(rel), "loss_gap_bf16_steps": steps,
            "loss_limit": FT_LOSS_LIMIT, "bitwise_steps": pre,
            "final_master_gap_generations": gap,
            "control_gap_generations": control, "state_limit": FT_STATE_LIMIT,
            "final_state": states,
            "metrics": first["metrics"], "counters_jax": FT_COUNTERS,
            "recoveries": [{k: rec.get(k) for k in
                            ("kind", "reason", "dead", "resumed_from_step",
                             "rewound_steps", "restore_fallbacks", "dp",
                             "rebuild_s", "mttr_s")}
                           for rec in first["recoveries"]],
            "generation_writes": first["writes"],
            "background_save": [r.get("background_save") for r in runs],
            "generations": first["generations"],
            "in_mesh": [r["in_mesh"] for r in runs],
            "train_s": [r["train_s"] for r in runs],
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in runs]}


def trace_and_profile():
    """(c): ``examples/train_gpt_torch.py --trace-out`` at phase 15's
    configuration (GPT-2 small, 12 layers, bf16) for TRACE_STEPS steps,
    the same run untraced; then ``OpProfiler`` over one forward and
    backward of the model on the card against the eager step's wall."""
    from hetu_tpu_torch import obs
    from hetu_tpu_torch.utils import OpProfiler
    entry = load_entry()
    tmp = tempfile.mkdtemp(prefix="trace_")
    try:
        data = os.path.join(tmp, "tokens.npy")
        entry_tokens(data)
        path = os.path.join(tmp, "trace.json")
        args = ENTRY_ARGS + ["--data", data, "--steps", str(TRACE_STEPS),
                             "--log-every", str(TRACE_STEPS)]
        plain = entry.main(args)
        traced = entry.main(args + ["--trace-out", path])
        with open(path) as f:
            doc = json.load(f)
        obs.validate_chrome_trace(doc)
        steps = sum(1 for e in doc["traceEvents"]
                    if e["name"] == "train_step")
        if steps != TRACE_STEPS or traced["trace"]["train_steps"] != steps:
            raise AssertionError(f"trace: {steps} train_step spans, want "
                                 f"{TRACE_STEPS}")
        trace = {"events": traced["trace"]["events"],
                 "train_step_spans": steps, "bytes": os.path.getsize(path),
                 "ms_per_step_traced": traced["ms_per_step"],
                 "ms_per_step_untraced": plain["ms_per_step"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg, batch, seq = train_config("gpt2_small")
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as g:
        ids = ht.parallel_placeholder("int32", (batch, seq))
        labels = ht.parallel_placeholder("int32", (batch, seq))
        model = GPTLMHeadModel(cfg)
        loss = model(ids, labels)
        grads = g.make_gradients(loss, g.trainable_variables)
    g.run([], run_level="alloc")
    x, y = seeded_batch(cfg.vocab_size, batch, seq, seed=0)
    feeds = {ids: x, labels: y}
    with capture.eager():
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            g.run([loss] + grads, feed_dict=feeds, run_level="compute_only")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
    prof = OpProfiler(g)
    records = prof.profile([loss] + grads, feeds, warmup=1, iters=3)
    if not records or records[-1]["op_type"] != "gradients":
        raise AssertionError("op profiler: no backward record")
    by_type = prof.by_type()
    out = {"trace": trace, "op_profile": {
        "ops": len(records), "total_ms": prof.total() * 1e3,
        "eager_step_ms": 1e3 * float(np.mean(walls[1:])),
        "top_types_ms": {k: v * 1e3 for k, v in
                         list(by_type.items())[:10]},
        "top_ops": prof.summary(top=10).splitlines()}}
    del g, model, loss, grads, prof, records
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_runtime_planes():
    """Phase 27: the runtime planes (see the module docstring).  (b)
    reads phase 24's launch of 4 ranks where it ran, else starts its
    own."""
    t0 = time.perf_counter()
    wall = {}
    reset_flash_counts()
    sentry = sentry_in_captured_step()
    a_flash = flash_counts()
    wall["a"] = time.perf_counter() - t0
    t = time.perf_counter()
    if "ft" in SHARED:
        runs = SHARED["ft"]
        b_in = "phase 24's launch of 4 ranks"
    else:
        _, runs = mesh_runs(ft_cases(), ranks=FT_RANKS)
        runs = [rk[0] for rk in runs]
        b_in = "its own launch"
    ft = ft_rows(runs)
    wall["b"] = time.perf_counter() - t
    t = time.perf_counter()
    reset_flash_counts()
    trace = trace_and_profile()
    c_flash = flash_counts()
    wall["c"] = time.perf_counter() - t
    flash = flash_totals([a_flash, c_flash] + [r["flash"] for r in runs])
    out = {"sentry": sentry, "fault_tolerant": ft, "ft_ran_in": b_in,
           **trace,
           "flash_launches": {k: v["launches"] for k, v in flash.items()},
           "flash_launches_by_route": {k: v["by_route"]
                                       for k, v in flash.items()},
           "part_wall_s": wall, "nvidia_smi": smi_line(),
           "wall_s": time.perf_counter() - t0}
    emit({"phase": "runtime_planes", **out})
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    dev = phase_device()
    phase_build()
    kern = phase_kernel()
    main_out = phase_main_path(
        llama3_8b_config(), "main_path",
        "Llama-3-8B widths, random bf16 weights (seed 0)",
        ragged_paged_attention_cuda, latent_ragged_paged_attention_cuda)
    phase_oracle()
    flash = phase_flash()
    train = [phase_train(name) for name in ("llama3_8b_4_layers",
                                            "gpt2_small")]
    phase_train_oracle()
    latent = phase_latent_kernel()
    paged, paged_launches = phase_paged_decode()
    mla_out = phase_main_path(
        mla_config(llama3_8b_config(), kv_latent_dim=512, kv_rope_dim=64),
        "mla_main_path",
        "Llama-3-8B widths in the MLA layout (kv_latent_dim 512, "
        "kv_rope_dim 64), random bf16 weights (seed 0)",
        latent_ragged_paged_attention_cuda, ragged_paged_attention_cuda)
    quant = phase_mla_quant()
    phase_mla_oracle()
    phase_graft_entry()
    phase_train_entry()
    phase_train_recipe()
    bert = phase_bert_pretrain()
    phase_small_models()
    graph = phase_graph_layer()
    spec = phase_spec_decode()
    cluster = phase_cluster()
    mesh = phase_mesh()
    pipe = phase_pipeline()
    cpar = phase_cp()
    switch = phase_switch()
    moe = phase_moe()
    planes = phase_runtime_planes()
    # phase 20's measured runs, spec and non-spec, add their launches:
    # kernel 5 in the full-head runs, (d)'s and (c)'s, kernel 6 in the MLA
    # runs (bf16 pages on wgmma, fp32 pages on mma.sync)
    runs = ("spec", "non_spec")
    spec_full = sum(r[run]["kernel_launches"] for r in
                    spec["full_head"].values() for run in runs) + \
        spec["full_head"]["float32"]["accepting_draft"]["kernel_launches"] + \
        sum(spec["narrow_chunks"][run]["kernel_launches"] for run in runs)
    spec_mla = {d: sum(r[run]["kernel_launches"] for run in runs)
                for d, r in spec["mla"].items()}
    # phase 21's runs (a)-(e) add kernel 5's launches, (d)'s MLA run
    # kernel 6's (on wgmma)
    cluster_full = sum(r["kernel_launches"]
                       for r in cluster["replicated"].values()) + \
        cluster["host_tier"]["full_head"]["kernel_launches"]
    cluster_mla = cluster["host_tier"]["mla"]
    rows = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "hetu_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "hetu_tpu/ops/ragged_paged_attention.py:142",
        "launches": main_out["kernel_launches"] + spec_full + cluster_full
        + moe["ragged_launches"],
        "spec_decode_launches": spec_full,
        "cluster_launches": cluster_full,
        "moe_launches": moe["ragged_launches"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": None,
        "device_ms": kern["device_ms"],
        "verify_rows": spec["verify_kernel"]}]
    # each flash kernel at the main path's shape where it runs most: the
    # LLaMA layer-0 mix for the forward and the split backward, GPT-2 for
    # the fused backward; launches over both training runs, also by route
    # (the bf16 split dq, on wgmma, is launched by neither: 0 there), and
    # the route each type mix takes at these head dims
    where = {"flash_fwd": "llama/fp32_qk_bf16_v",
             "flash_bwd_dq": "llama/fp32_qk_bf16_v",
             "flash_bwd_dkv": "llama/fp32_qk_bf16_v",
             "flash_bwd_fused": "gpt2/bf16"}
    entries = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2,
               "flash_bwd_fused": 2}
    # phase 17's BERT runs (not causal), phase 19's graph layer, phase
    # 22's ranks, phase 23's pipelines and phase 24's context-parallel
    # ranks add their launches to the rows (phase 24's launches against
    # the plain versions stand apart, ``cp_check_launches``)
    bert_runs = list(bert.values())
    graph_launches = {n: graph["flash_launches"].get(n, 0)
                      for n in where}
    mesh_launches = mesh["flash_launches"]
    mesh_routes = mesh["flash_launches_by_route"]
    pipe_launches = pipe["flash_launches"]
    pipe_routes = pipe["flash_launches_by_route"]
    cp_launches = cpar["flash_launches"]
    cp_routes = cpar["flash_launches_by_route"]
    # phase 25's ranks (3xTF32 at their fp32 and LLaMA widths) and the
    # Malleus entry point's ranks (fp32, small: mma.sync, fused backward)
    sw_launches = {k: switch["flash_launches"][k] +
                   switch["entry_flash_launches"][k] for k in where}
    sw_routes = switch["flash_launches_by_route"]
    entry_fl = switch["entry"]["flash_launches"]["after_switch"]
    # phase 26's training runs (b) and expert-parallel ranks (d), 3xTF32
    moe_launches = moe["flash_launches"]
    moe_routes = moe["flash_launches_by_route"]
    # phase 27: (a) 3xTF32 (the Llama path), (b) and (c) on wgmma
    rt_launches = planes["flash_launches"]
    rt_routes = planes["flash_launches_by_route"]
    for name, at in where.items():
        wgmma = sum(t["wgmma_launches"][name] for t in train) + \
            sum(b["flash_launches_by_route"][name]["wgmma"]
                for b in bert_runs) + graph_launches[name] + \
            mesh_routes[name]["wgmma"] + pipe_routes[name]["wgmma"] + \
            cp_routes[name]["wgmma"] + sw_routes[name]["wgmma"] + \
            entry_fl[name]["wgmma"] + rt_routes[name]["wgmma"]
        tf32 = sum(t["tf32_launches"][name] for t in train) + \
            sum(b["flash_launches_by_route"][name]["3xtf32"]
                for b in bert_runs) + mesh_routes[name]["3xtf32"] + \
            pipe_routes[name]["3xtf32"] + cp_routes[name]["3xtf32"] + \
            sw_routes[name]["3xtf32"] + entry_fl[name]["3xtf32"] + \
            moe_routes[name]["3xtf32"] + rt_routes[name]["3xtf32"]
        mma = sum(t["tensor_core_launches"][name] - t["wgmma_launches"][name]
                  - t["tf32_launches"][name] for t in train) + \
            sum(b["flash_launches_by_route"][name]["mma.sync"]
                for b in bert_runs) + sw_routes[name]["mma.sync"] + \
            entry_fl[name]["tensor_core"] - entry_fl[name]["wgmma"] - \
            entry_fl[name]["3xtf32"] + rt_routes[name]["mma.sync"]
        r = flash[at][name]
        # the all-bf16 and the all-fp32 readings at both training shapes
        keys = ("ms", "device_ms", "bound_ms", "library_ms",
                "library_device_ms", "max_abs_err")
        bf16, fp32 = ({shape: {k: flash[f"{shape}/{types}"][name][k]
                               for k in keys}
                       for shape in ("llama", "gpt2")}
                      for types in ("bf16", "fp32"))
        # BERT-base's attention, not causal (phase 6)
        noncausal = {"shape": dict(zip(("b", "s", "h", "d"), BERT_ATTN)),
                     **{types: {k: flash[f"bert/{types}"][name][k]
                                for k in keys + ("plain_ms", "bound_by")}
                        for types in ("bf16", "fp32")}}
        rows.append({
            "name": name, "route": "cuda",
            "source": "hetu_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name], "types": at,
            "launches": sum(t["flash_launches"][name] for t in train) +
            sum(b["flash_launches"][name] for b in bert_runs) +
            graph_launches[name] + mesh_launches[name] + pipe_launches[name]
            + cp_launches[name] + sw_launches[name] + moe_launches[name]
            + rt_launches[name],
            "noncausal_launches": sum(b["flash_launches"][name]
                                      for b in bert_runs),
            "graph_layer_launches": graph_launches[name],
            "mesh_launches": mesh_launches[name],
            "mesh_launches_by_route": mesh_routes[name],
            "pipeline_launches": pipe_launches[name],
            "pipeline_launches_by_route": pipe_routes[name],
            "cp_launches": cp_launches[name],
            "cp_launches_by_route": cp_routes[name],
            "cp_check_launches": cpar["check_launches"][name],
            "switch_launches": sw_launches[name],
            "switch_launches_by_route": sw_routes[name],
            "switch_entry_launches": switch["entry_flash_launches"][name],
            "moe_launches": moe_launches[name],
            "moe_launches_by_route": moe_routes[name],
            "runtime_planes_launches": rt_launches[name],
            "runtime_planes_launches_by_route": rt_routes[name],
            "wgmma_launches": wgmma,
            "launches_by_route": {"wgmma": wgmma, "3xtf32": tf32,
                                  "mma.sync": mma},
            "routes": {f"{shape}/{types}": flash_route(entries[name], d,
                                                       types)
                       for shape, d in (("llama", LLAMA_ATTN[3]),
                                        ("gpt2", GPT2_ATTN[3]))
                       for types in FLASH_CODES},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "bf16": bf16, "fp32": fp32,
            "noncausal": noncausal})
    # the latent kernel at the MLA engine's unified-step batch, the paged
    # decode kernel at the engine's decode batch of 8 in bf16; no PyTorch
    # call attends through a page table, so no library time
    for name, source, replaces, launches, r in (
            ("latent_ragged_paged_attention",
             "hetu_tpu_torch/csrc/latent_ragged_paged_attention.cu",
             "hetu_tpu/ops/ragged_paged_attention.py:420",
             mla_out["kernel_launches"] + sum(spec_mla.values()) +
             cluster_mla["kernel_launches"], latent),
            ("paged_attention_decode",
             "hetu_tpu_torch/csrc/paged_attention.cu",
             "hetu_tpu/ops/paged_attention.py:113", paged_launches, paged)):
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            **({"device_ms": r["device_ms"]} if "device_ms" in r else {})})
    # kernel 6: its launches by route (phase 11 on wgmma, the quantized
    # pages of phase 12 on mma.sync), its parts and the route's occupancy
    lat = next(r for r in rows if r["name"] == "latent_ragged_paged_attention")
    lat.update({
        "kernel_route": latent["route"],
        "launches_by_route": {
            "wgmma": mla_out["wgmma_launches"] + sum(
                spec["mla"]["bfloat16"][run]["wgmma_launches"]
                for run in runs) + cluster_mla["wgmma_launches"],
            "mma.sync": mla_out["kernel_launches"] -
            mla_out["wgmma_launches"] + spec_mla["float32"]},
        "quant_path_launches": {"mma.sync": sum(
            q["kernel_launches"] for q in quant.values())},
        "spec_decode_launches": spec_mla,
        "cluster_launches": {"wgmma": cluster_mla["wgmma_launches"]},
        "spec_decode_kernel": {d: r["spec"]["attention_kernel"]
                               for d, r in spec["mla"].items()},
        "spec_decode_rows_a_step": spec["mla"]["bfloat16"]["spec"][
            "rows_a_step"],
        "verify_rows": spec["latent_verify_kernel"],
        **{k: latent[k] for k in ("parts", "wgmma_smem_bytes",
                                  "wgmma_blocks_per_sm")}})
    if not all(r["launches"] > 0 for r in rows):
        raise AssertionError(f"a kernel of the path was never launched: "
                             f"{[(r['name'], r['launches']) for r in rows]}")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--mesh-rank"]:
        mesh_rank_main()
        sys.exit(0)
    if sys.argv[1:] == ["--pipe-entry-rank"]:
        pipe_entry_rank_main()
        sys.exit(0)
    if sys.argv[1:] == ["--cp-rank"]:
        mesh_rank_main(extra=cp_rank_checks)
        sys.exit(0)
    sys.exit(main())
