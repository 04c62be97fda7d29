"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

It drives ``repro_torch`` only (no JAX, nothing of the ``repro`` package):

1. prints the card's name and power limit (``nvidia-smi``), builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` and prints the build
   time and ``ptxas`` resource lines, and counts the ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions of kernel 11's bf16 kernel in
   ``cuobjdump -sass`` of its library (it fails if either is 0);
2. holds each of the four fused Lorenzo kernels against its plain
   PyTorch version on the card, on ragged small sizes, on the shapes of
   the allreduce (one pipelined-ring piece and one sequential-ring chunk
   of the 646 MB run), on an overflowing stream and at the default
   ``lorenzo`` gradient sync's 16 MiB bucket: words ``[:cap]``, bw,
   anchor and nwords must be equal and every f32 output bitwise equal;
   prints the mismatch counts and, for rows 1-10, each kernel's median
   time over 10 back-to-back calls, over one call, and its kernels' device
   time (profiler) against its bound (the ring hop, kernel 2, without the
   f32 sum at the ring piece and with it at the bucket, as its paths call
   it); then kernel 2 on its single-pass design's edges, both ``emit_f32``
   modes and its total: one tile, part-full last tiles, outgoing
   capacities on and inside a tile, an incoming stream cut inside a tile,
   an overflowing stream, full-width random bits at the ring piece, 50
   back-to-back calls on one scratch, hop calls interleaved with entropy
   calls on the same stream, and from the profiler one
   ``hop_lookback_kernel`` and one ``hop_zero_tail_kernel`` launch per
   call; then kernel 1 on its single-pass design's
   edges (stream, bw, anchor and total bitwise): one tile, part-full last
   tiles, capacities on and inside a tile, an overflowing stream,
   NaN/Inf/saturating input, full-width random bits at the ring piece, 50
   back-to-back calls on one scratch, calls interleaved with hop and
   entropy calls, and from the profiler one ``qp_lookback_kernel`` and one
   ``qp_zero_tail_kernel`` launch per call; then kernels 3 and 4 on their
   single-pass design's edges (f32 by bits): one tile, part-full last
   tiles, all-zero widths, full-width random bits at the ring piece,
   streams cut on and inside a tile and far below their length,
   ``packed`` 1, 2 and 3 words off a 16-byte boundary and an unaligned
   ``acc``, 50 back-to-back calls on one scratch, calls interleaved with
   kernel 1, kernel 2 and entropy calls, a 0-block call raising, and from
   the profiler one ``ud_lookback_kernel`` launch per call; then kernels
   3, 7 and 10
   (lossy and lossless) with signalling NaNs and NaNs carrying payloads in
   ``acc``, by bits;
3. holds the three unfused kernels (``quantize``, ``dequantize``,
   ``dequantize_reduce``) against their plain versions the same way, on
   ragged sizes, on NaN, +-Inf and values past the int32 range of q, on
   codes whose prefix sum wraps in int32, and at the scatter's shape (8
   chunks of 20,187,500 elements, 630,912 rows in one ``quantize``); then
   kernels 6 and 7 on their tiled design's edges (f32 by bits): one tile
   and part-full last tiles, ``codes`` and ``acc`` 1, 2 and 3 words off a
   16-byte boundary, int32-wrapping codes at the scatter's shape, 50
   back-to-back calls, a 0-row call raising, and from the profiler one
   ``dq_tile_kernel`` launch per call and no ``dequantize_kernel``;
4. runs the allreduce, ``GZCommunicator("x").allreduce`` over a
   ``ThreadGroup`` of ranks on the card, at 646 MB per rank with 8 ranks
   (plan ``ring``, 2 pieces, profiled: the Lorenzo kernels' launches are
   checked against the schedule: 96 hop, 32 kernel 1 and 144
   ``ud_lookback_kernel`` launches of kernels 3 and 4),
   16 MB with 8 ranks (``redoub``)
   and 16 MB with 6 ranks (``redoub`` with the remainder stage), then a
   4 MB allreduce through the kernels and through the plain versions
   (bitwise equal);
5. runs this slice's main path, ``GZCommunicator("x").scatter`` of 646 MB
   at the root over 8 ranks (plan ``binomial``, 343,566,440 wire bytes,
   7 root chunk streams; non-root inputs are NaN, which must not count),
   profiled, and a 64 MB scatter over 6 ranks (the trimmed tree);
6. runs ``broadcast``, ``allgather`` and ``reduce_scatter`` (1 and 2
   pieces) and ``all_to_all`` at 16 MB per rank over 8 ranks, each once
   through the kernels and once through the plain versions (bitwise
   equal);
7. runs the two-pass paths, 16 MB x 8 allreduces with ``fused=False``
   (redoub and ring/2) and ``fused_hop=False`` (ring/2), each bitwise
   equal to the fused run on the same inputs, then the 646 MB x 8
   ``scatter`` with ``fused=False`` (the paper's gZ-Scatter on the
   two-pass codec: one ``quantize`` at the root, one ``dequantize`` per
   rank), profiled, bitwise equal to phase 5's fused scatter on the same
   input;
8. holds the three entropy kernels (``entropy_quantize_pack``,
   ``entropy_unpack_dequantize``, ``entropy_unpack_dequantize_reduce``)
   against their plain versions, lossy and lossless (stream, desc, anchor,
   total and both f32 outputs bitwise), at one 16 MiB gradient bucket and
   at the 646 MB payload, and on the single-pass look-back's edges: one
   tile, part-full last tiles, an all-zero stream, capacities on and
   inside a tile, full-width random bits at 646 MB, 50 back-to-back calls
   on one scratch; checks from the profiler that kernel 8 is two launches
   per call, kernels 9 and 10 one;
9. runs the 646 MB x 8 allreduce and the 646 MB scatter under
   ``lorenzo+entropy`` (phase ``codecs``);
10. runs the gradient sync of one minitron-8b decoder layer (973 MB per
    rank, 8 ranks, 59 buckets of 16 MiB) under ``lorenzo+entropy``,
    profiled (each entropy sub-kernel's launches and device time, the
    launch structure checked again), with its host floor at 1/256 size
    (phase ``grad-sync``);
11. the same sync under ``lorenzo`` (then profiled once: kernels 1, 2
    and 3's launches and device time, the launch structure checked), ``lossless``,
    ``passthrough`` and ``codec="auto"``, and at N = 6;
12. runs the degradation layer on the main paths with their real kernels
    (phase ``faults``): the 646 MB x 8 allreduce (ring/2) clean under
    ``verify_streams`` (bitwise the unguarded run, no flag), an injected
    overflow on rank 3, 8 NaNs on rank 5, and a round-1 wire bitflip
    under ``fallback`` (bitwise the rank-order lossless sum of the
    poisoned or sanitized inputs; the bitflip silent without
    ``verify_streams``, caught with it, missed at round 10,000), and
    ``raise`` (every rank raises the reference's message on a forced
    overflow, none on clean data); the 646 MB x 8 scatter with NaN on the
    root (the sanitized lossless scatter) and on a non-root (no flag);
    the gradient sync of one minitron-8b layer in 57 full buckets, every
    one overflowing under ``fallback`` (every leaf bitwise the lossless
    sum); every case with its health counters and the compressed pass's
    exact launches; then the clean allreduce timed with and without
    ``verify_streams`` (warm walls in turns, device busy and the
    checksum's launches and device time from one profile each) and the
    fallback of a forced overflow beside its compressed call;
13. runs the integer ring and the two-level allreduce (phase ``hier``):
    ``GZCommunicator(algo="intring")`` at 646 MB x 8 (every rank the same
    bits, within N 1.05 eb, kernel 5 launched once a rank and kernels
    1-4 never; profiled: kernel 5's device time beside the torch pack,
    unpack and prefix-sum ops; host floor) and at 16 MB x 8 (bitwise the
    port's CPU run on the same inputs; ``policy="accuracy"`` resolves
    ``intring``); ``GZHierCommunicator`` on ``make_hier_mesh(2, 4)`` at
    646 MB and ``A100_SLINGSHOT`` (hierarchical; the inter plan's
    launches; wall and device busy beside the flat 8-rank composite
    call), 4x2 at 16 MB, 2x4 at 16 MB on ``TPU_V5E`` (flat, bitwise the
    8-rank ``GZCommunicator``), the hier fallback of a forced overflow
    at 646 MB (bitwise the composite rank-order sum on every rank), and
    the gradient sync of one minitron-8b layer over ``("local", "node")``
    2x4 under ``lorenzo`` (every leaf within its bound, the bucket count,
    the inter plan's wire bytes);
14. checks that the all-to-all's backward and ``fsdp_all_gather``'s
    backward (the reduce-scatter) on a one-card ``ThreadGroup`` raise
    instead of hanging (phase ``c6``);
15. holds the flash-attention kernel (kernel 11; bf16 on the tensor-core
    route, f32 on the CUDA-core route, each counted) against its plain
    version at D = 32, 64 and 128, f32 and bf16, causal, causal with
    windows 64, 100, 128 and 1000, non-causal with Sq != Sk, ragged lengths
    and rows that see no key, the TMA edges in bf16 (Sq, Sk in {1, 127,
    129, 2049} at D = 64 and 128; H = 1 through ``flash_attention_bhsd``),
    and at the main path's shape (B=2, S=2048, H=32, D=128, bf16), timed
    there beside the plain version, SDPA and the bound, then checked and
    timed beside SDPA at B=8 S=2048 and B=2 S=8192 causal and S=4096
    non-causal (phase ``model``, as are 16-18);
16. runs this slice's main path, ``Model.loss_fn`` of minitron-8b at full
    width and depth (19.76 GB of bf16 weights from seed 0) on a B=2,
    S=2048 batch, through kernel 11 (32 launches, all on the tensor-core
    route) and through the chunked path (none), within 2e-3 of each other,
    profiled;
17. compares the full-sequence logits through kernel 11 at S=128 with 128
    ``decode_fn`` steps (rel <= 0.05);
18. runs ``repro_torch.launch.serve.serve`` at full size (batch 4, 16
    prompt and 32 generated tokens, cache 128) and prints its tokens per
    second;
19. runs this slice's main path, ``launch.training.make_train_step`` of
    internlm2-20b at every published width (d_model 6144, 48 heads, 8 kv
    heads, d_ff 16384, vocab 92544) with only the depth cut (48 -> 2
    layers), on a ``ThreadMesh((2, 1), ("data", "model"))`` of the card,
    ``fsdp=False``, the ring allreduce at eb 1e-4, remat ``"full"``, a
    global batch of 2 x 512 tokens, for 3 steps (phase ``train``, as are
    20-23): every step's loss finite, both ranks' params and AdamW state
    equal by bits, no leaf's sync flagged, kernels 1, 3 and 4 launched as
    every leaf's plan says (the wrappers' counts); one synced leaf within
    the allreduce's bound of the exact rank-order sum; each step's wall,
    then one more step profiled (device busy, the sync's share of it) and
    the peak memory;
20. holds one ``_sync_grads`` of seeded per-rank bf16 and f32 trees on 4
    ranks of the card (kernels 1-4) against the same call on the CPU
    (their plain versions): every leaf equal by bits, no flag set;
21. forces an overflow (``core/faults.py``) under ``skip_on_overflow`` at
    smoke size: the step is skipped with params and opt state equal by
    bits to its inputs, and the next clean step applies;
22. (the train CLI's smoke run, with its check that the final loss is
    below the first, is part of phase 35);
23. checks that kernel 11's entry points raise under grad on the card
    (training takes the chunked path) and run under ``no_grad``;
24. runs the ssm and hybrid families (phase ``ssm``): mamba2-780m (48
    layers, d_model 1536, 48 SSD heads of 64, d_state 128; 858,472,704
    parameters) and zamba2-2.7b (54 Mamba2 layers, d_model 2560, 80 SSD
    heads, d_state 64, one shared attention+MLP block of 32 heads of 80
    applied 9 times; 2,423,697,568 parameters), each at full width and
    depth from seed 0 in bf16: ``Model.loss_fn`` at B=2, S=2048 (finite,
    walls, one profiled call), the full-sequence logits against 320
    ``decode_fn`` steps (two SSD chunks, the second padded; rel <= 0.05),
    ``serve`` (mamba2-780m as its default ``--arch``); both smoke configs
    with f32 weights on the card and on the CPU (losses within rel 1e-5:
    no TF32); then phase 19's train step for mamba2-780m at full width
    and full depth;
25. runs the MLA family (phase ``mla``): minicpm3-4b (62 layers, d_model
    2560, 40 heads, q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v 64,
    d_ff 6400, vocab 73448 padded to 73728; 4,263,272,960 parameters) at
    full width and depth from seed 0 in bf16: ``Model.loss_fn`` at B=2,
    S=2048 (finite, walls, one profiled call with its bf16 and f32 GEMM
    time, one layer's attention and MLP timed apart), the full-sequence
    logits against 64 ``decode_fn`` steps in bf16 and with f32 weights
    (rel <= 0.05 in both), ``serve --arch minicpm3-4b``; the smoke config
    with f32 weights on the card and on the CPU through the chunked and
    the dense route (losses within rel 1e-5: no TF32); then phase 19's
    train step for minicpm3-4b at full width, depth cut 62 -> 28 (its
    kernels 1, 3 and 4 counts go into the kernels line, replacing phase
    24's);
26. runs the Mixture-of-Experts family (phase ``moe``) at full width, the
    depth cut only as far as the card's memory forces (``MOE_CUTS``):
    phi3.5-moe-42b-a6.6b (d_model 4096, 32 heads over 8 kv of 128, 16
    experts of d_ff 6400, top-2, capacity factor 1.25, vocab 32064 padded
    to 32256; 32 layers of 1,300,307,968 parameters), bf16 from seed 0:
    ``Model.loss_fn`` at B=2, S=2048 through kernel 11 (one launch a
    layer, counted: these go into the kernels line, replacing phase 16's)
    and through the chunked path, within 2e-3 of each other, profiled (the
    f32 expert GEMMs against the bf16 GEMMs and the rest); 128
    ``decode_fn`` steps against the full-sequence logits at capacity
    factor n_experts / top_k (nothing drops) and at 1.25 (the dropped
    share and the gap), logged; ``serve --arch phi3.5-moe-42b-a6.6b
    --smoke`` on the card and ``serve``'s greedy loop (batch 4, 16 + 32
    tokens) at the cut depth; the decode check again with f32 weights at
    12 layers, rel <= 0.05 (the gate: bf16 drifts with depth in the
    reference too, ``MOE_DECODE_NOTE``); llama4-scout-17b-a16e (top-1;
    d_model 5120, 40 heads, d_ff 8192, vocab 202048) at the cut depth:
    the loss forward, profiled; both smoke configs with f32 weights on the
    card and on the CPU (losses within rel 1e-5); then phase 19's train
    step for phi3.5-moe at full width, depth cut 32 -> 1 (its kernels 1, 3
    and 4 counts go into the kernels line, replacing phase 25's);
27. runs the encoder-decoder family (phase ``encdec``): kernel 11 at its
    four shapes (H=16, D=64: the forward's encoder 1024 x 1024 non-causal,
    decoder 2048 causal and cross attention 2048 x 1024 at B=2 in bf16,
    and a decode step's cross attention, one query row over 1024 frames
    at B=4, in bf16 and f32) against its plain version on the route its
    dtype takes (counted), timed beside SDPA and the bound; then
    seamless-m4t-medium (12 encoder and 12 decoder layers, d_model 1024,
    16 heads of 64, d_ff 4096, vocab 256206 padded to 256512, 1024 encoder
    frames; 978,384,896 parameters) at full width and depth from seed 0 in
    bf16: ``Model.loss_fn`` at B=2, S=2048 with (2, 1024, 1024) encoder
    frames through kernel 11 (36 launches: 12 non-causal, 12 causal, 12
    cross; these go into the kernels line, replacing phase 26's) and
    through the chunked path, within 2e-3 of each other, profiled (the f32
    unembed, the bf16 GEMMs and kernel 11); the full-sequence logits at
    S=128 against 128 ``decode_fn`` steps with the prefill's encoder
    output in the cache's ``enc_out``, both through kernel 11 (12 launches
    a step), in bf16 and in f32 (rel <= 0.05 in both); ``serve --arch
    seamless-m4t-medium``; the smoke config in f32 on the card and on the
    CPU (losses within rel 1e-5); then phase 19's train step for
    seamless-m4t-medium at full width and depth (its kernels 1, 3 and 4
    counts go into the kernels line, replacing phase 26's);
28. runs the prefix-frontend family (phase ``vlm``): internvl2-26b (48
    layers, d_model 6144, 48 heads over 8 kv of 128, d_ff 16384, vocab
    92553 padded to 92672, 256 prefix positions; 19,862,722,560
    parameters) at full width and depth from seed 0 in bf16:
    ``Model.loss_fn`` at B=2 over 256 prefix and 1792 text positions
    through kernel 11 (48 launches) and through the chunked path, within
    2e-3, profiled; the full-sequence logits of 128 text tokens against
    128 ``decode_fn`` steps (rel <= 0.05); ``serve --arch internvl2-26b``;
    the smoke config in f32 on the card and on the CPU;
29. runs this slice's main path (phase ``fsdp``): phase 19's train step
    (internlm2-20b at every published width, 2 layers, bf16 from seed 0,
    2 ranks of the card, 2 x 512 tokens, remat ``"full"``) with the
    weights sharded over ``data`` (``fsdp=True``; each rank its
    ``_local`` block), ``fsdp_gz`` the reference's ring at eb 1e-4 and
    the replicated norms synced through the ring at eb 1e-4, for 3 steps:
    every step's loss finite, the ranks' replicated leaves and their
    AdamW moments equal by bits, no gather, reduce-scatter or allreduce
    flagged, kernels 1, 3 and 4 launched as every gather's,
    reduce-scatter's and allreduce's plan says; at step 0 both ranks'
    gathered weights equal by bits and within eb (plus one bf16
    rounding) of the global weight, and the reduce-scattered
    ``blocks.mlp.wo`` (gathered along dim 1) within the reduce-scatter's
    bound of the exact rank-order sum of the recorded cotangents; then a
    profiled fourth step, its gathers and reduce-scatters again alone
    (their share of the step's device busy), the peak memory beside
    phase 19's; then one step of the smoke config on 4 ranks of the
    card, its launches counted from 0 and held against its gathers' and
    reduce-scatters' plans, kernel 2 on every hop (that count goes into
    the kernels line; kernels 1, 3 and 4's from the main path replace
    phase 27's), whose gathers (of its shards) and reduce-scatters (of
    its recorded cotangents) run again on the card and on the CPU (their
    plain versions): equal by bits;
30. runs tensor and expert parallelism (phase ``tp``), each model through
    ``launch.training.make_setup`` on a ``ThreadMesh((1, tp), ("data",
    "model"))`` of the card, every rank on its ``_local`` block of the
    global bf16 weights from seed 0, at every published width with only
    the depth cut (``TP_DENSE``, ``TP_MOE``): minitron-8b at tp = 4 (4 of
    32 layers; 8 q heads and 2 kv heads a rank) through ``_tp_family``, as
    phase 31's configs: ``Model.loss_fn`` at B=2, S=2048 through kernel 11
    (layers x ranks launches, counted from 0) against tp = 1 on the same
    weights within 0.02 (the reference's
    ``tests/_mp_model_parallel_child.py`` bound), every rank's loss equal,
    walls and busy share from one profiled call; 16 ``make_serve_step``
    steps at B=2 against tp = 1's ``decode_fn``, the last step's logits
    within 0.15 of tp 1's (``TP_DECODE_RTOL``); then phi3.5-moe-42b-a6.6b
    at tp = 16 (2 of 32 layers; one expert, 2 q heads and a kv head shared
    by 2 ranks a rank) at capacity factor n_experts / top_k: the loss
    through the exact expert dispatch, through the compressed one
    (``moe_dispatch_gz_eb`` 1e-4: kernel 5 once and kernel 4 tp times a
    dispatch and rank, two dispatches a layer, counted from 0 and held
    against that count, no call flagged) and at tp = 1, the exact one
    within 0.05 of tp = 1 (the reference child's MoE bound), the gaps and
    the dispatch's wire bytes beside its f32 payload's printed, both
    profiled; one ``make_serve_step`` step at B=4 < tp (the token-padding
    path) against tp = 1 within 0.15; at the config's 1.25 the dropped
    share and the gap, logged; every kernel 11 launch of both forwards
    against its plain version on its own payload, and kernels 5 and 4 on
    the captured dispatch payload against theirs (their launches go into
    the kernels line, replacing phase 27's for kernel 11, phase 13's for
    kernel 5 and phase 29's for kernel 4);
31. runs tensor parallelism of the other families (phase
    ``tp-families``), each row of ``TP_FAMILIES`` through ``_tp_family``
    as phase 30's minitron-8b, at every published width with only the
    depth cut: zamba2-2.7b at tp = 4 (12 of 54 layers, 2 shared
    applications; 20 SSD heads, 8 q and 8 kv heads a rank; the shared
    attention's D = 80 takes the chunked path), minicpm3-4b at tp = 8 (4
    of 62 layers; 5 MLA heads a rank, the latent replicated),
    seamless-m4t-medium at tp = 4 (every layer; 4 heads a rank in the
    encoder, the decoder's self and its cross attention) and internvl2-26b
    at tp = 16 (4 of 48 layers; 3 q heads a rank, a kv head shared by 2
    ranks): the loss against tp = 1 within 0.02, every rank's loss equal,
    kernel 11's launches counted from 0 and held against the plan
    (seamless (12 + 12 + 12) x 4 = 144, internvl2 4 x 16 = 64) and every
    launch against its plain version on its own local-head payload; the
    warm wall and busy share from one profiled call; 8
    ``make_serve_step`` steps at B=2 from an empty cache laid out by
    ``launch.shapes.decode_specs`` (seamless: 12 x 4 cross attention
    launches a step, each checked) against tp = 1's ``decode_fn``, the
    last step's logits within 0.15 of tp 1's (kernel 11's launches of
    this phase go into the kernels line, replacing phase 30's);
32. runs the tensor-parallel train step (phase ``tp-train``): phase 29's
    cell (internlm2-20b at every published width, 2 layers, bf16 from
    seed 0, 2 x 512 tokens, remat ``"full"``, the chunked attention,
    ``fsdp_gz`` and the norms' sync ring at eb 1e-4) on a ``(data 2,
    model 2)`` mesh: tp 1's loss of the same global weights and first
    batch, forward only, and the smoke config's step on a CPU
    ``ThreadMesh((2, 2))``; then four processes of this script (started
    with ``sys.executable``, never forked, each capped at 0.23 of the
    card) form a gloo ``transport.DistMesh`` on the one card, each its
    rank's ``_local`` block, and run 3 steps and a timed fourth of
    ``make_train_step`` (every collective on a card tensor staged through
    the host; the FSDP gathers' reduce-scatters and TP's backward
    collectives on each process's autograd thread, remat's recompute
    re-bound to the forward's handles, gathering each layer's weights
    again: the in-backward route a ``DistMesh`` takes); then
    the smoke config in f32 with ``fsdp_gz``: one step's gathers and
    reduce-scatters again alone on the card and on the host (the plain
    versions); then one exact step of it.  Checks: finite losses; step
    0's loss within 0.02 of tp 1's; the four processes' metrics equal by
    bits; every leaf a spec replicates and its AdamW moments equal by bits
    on the ranks that hold it, after every step; nothing flagged; kernels
    1, 3 and 4 launched per process as the gathers' (the recompute's
    regathers counted), reduce-scatters' and allreduces' plans say at the
    rank's shapes (kernel 2: none at data 2);
    at step 0, at the rank's own shapes, every gathered weight (kernels 1
    and 4) within the allgather's eb plus one bf16 rounding of its block
    of the global weights and equal by bits on the ``data`` peers, the
    layer-0 ``blocks.mlp.wo`` reduce-scatter (kernels 1 and 3) within its
    bound of the exact sum of both ``data`` ranks' cotangents, and
    ``final_norm``'s sync (the ``data`` ring, kernels 1 and 3, then the
    exact ``model`` sum) within its bound of the exact sum of the four
    ranks' gradients; the replay equal by bits between card and host,
    the card's launches as its plans say; the exact smoke step's loss and
    every synced gradient within 1e-5 (of each leaf's largest value) of
    the CPU's.  Printed per process: the warm step's wall, its gloo
    staging (ms and bytes, timed from after the queued device work), the
    peak memory of the steps after step 0 (beside the ``FsdpStep``
    route's 10.74 GB, PR 35) and the loss gap; no
    device-busy share (the processes time-slice the card).  A child that
    fails or outlives its timeout fails the phase: the others are killed
    and its log's tail printed.  Its kernels 1, 3 and 4 counts (the four
    processes' first 3 steps) go into the kernels line, replacing phase
    29's;
33. runs the context-parallel decode cache (phase ``cp-decode``):
    minitron-8b (4 of 32 layers), zamba2-2.7b (12 of 54) and
    seamless-m4t-medium (every layer) at every published width, bf16
    weights from seed 0 and their f32 copies (``cfg.dtype`` with them),
    each case a batch-1 decode whose plan ``launch.shapes.decode_plan``
    makes: ``long_500k`` (the 8192-slot ring, positions 520,188 on, slots
    4,092..4,099) and a 32,768-slot cache (positions 16,380 on); a global
    cache of seeded random values (k and v in the run's dtype) as a
    prefill would have left it, decoded 8 ``make_serve_step`` steps on a
    ``ThreadMesh`` of ``(data 2, model 2)`` (the context split over data,
    cp 2; minitron-8b also on ``(data 4, model 1)``, cp 4) and on the
    unsplit ``(1, tp)`` from a copy of it.  Checks, in f32: every step's
    logits within 1e-5 of the largest unsplit logit; every cache slot no
    step wrote, and the first attention layer's written rows, equal by
    bits, the rest of the cache within 1e-5 of its largest value; in bf16
    (``long_500k`` on the first split mesh) the gaps logged.  Kernel 11
    (seamless's cross attention, 12 launches a step and rank) counted
    from 0 in every run against that plan and every launch held against
    its plain version on its payload; its launches and the decode ms a
    step (split, unsplit) go into the kernels line, replacing phase 31's;
34. runs the backward-overlapped bucketed sync (phase ``overlap``): phase
    32's cell and four processes (the same children, ``--tp-train-child``
    with its overlap flag) with ``overlap_sync=True`` and ``grad_gz`` ring
    at eb 1e-4 on ``data``, buckets of the ``BucketPlan``'s size: each
    leaf in its bucket's hook, whose backward, on the process's autograd
    thread, sums the bucket's f32 vector over its sync signature (the
    compressed ``data`` allreduce, kernels 1, 3 and 4, then the exact
    ``model`` sum); 3 steps and a timed fourth.  Checks: step 0's loss
    equal by bits to the hook-less forward's of the same weights and
    batch; the four processes' metrics equal by bits; nothing flagged (the
    communicators' flags and every bucket's health bit); phase 32's step-0
    checks of the gathers and of the layer-0 ``blocks.mlp.wo``
    reduce-scatter; at step 0 each bucket that ran a collective within
    its allreduce's bound of the exact sum of the ranks' vectors (by bits
    the f32 rank-order sum where no communicator sums it), then synced
    again on the host (the plain versions, over the same ``DistMesh``),
    equal by bits to the card's; kernels 1, 3 and 4 launched per process
    as the buckets', gathers' (regathers counted) and reduce-scatters'
    plans say.  Printed: the buckets, each process's warm step wall, gloo
    staging, peak memory.  Its kernels 1, 3 and 4 counts (the four
    processes' first 3 steps) go into the kernels line, replacing phase
    32's;
35. runs the train CLI on a ``DistMesh`` (phase ``train-cli``):
    ``launch.train.train`` in children of this script (``--train-cli-child``,
    started with ``sys.executable``) given torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), each capped at 0.23 of the card.  First phase 19's
    cell through the CLI (internlm2-20b at every published width, 48 -> 2
    layers by ``registry.get`` cut in the child, seed 0, ``--batch 4 --seq
    512 --grad-gz ring --eb 1e-4 --steps 3 --dist-backend gloo``): four
    processes, a gloo ``DistMesh((4, 1))`` on the one card, the weights
    sharded over ``data`` (exact FSDP gathers and reduce-scatters on the
    in-backward route), the replicated leaves' ring sync through kernels
    1-4 (at 4 ranks the ring hops).  Checks: every process's losses,
    gnorms and lrs equal by bits at every step and finite, its printed
    lines equal but for the wall field; step 0's loss within rel 1e-6 of
    the one-rank loss of the same weights and first batch (forward only,
    in this process); no sync flagged; kernels 1-4 launched per process
    over the steps as the replicated leaves' allreduce plans say; at step
    0 the synced ``final_norm`` (replicated under FSDP) equal by bits on
    every process, within the ring allreduce's bound of the exact
    rank-order sum of the four processes' gradients, and equal by bits to
    the same sync again on the host (the plain versions, over the same
    ``DistMesh``).  Printed per
    process: each step's wall, gloo staging (ms and bytes) and peak
    memory, the staged share of the warm steps.  Then the smoke CLI
    (phase 22's argv, 12 steps, ``--ckpt-every 6``): four gloo processes
    against the ``ThreadMesh`` route in this process with the device count
    taken as 4 (data 4, ``FsdpStep``), and one NCCL process at world size 1
    against the one-rank ``ThreadMesh`` route: losses equal by bits,
    checkpoints equal file by file, every final loss below its first.  A
    child that fails or outlives its timeout fails the phase and the
    others are killed.  Its kernels 1-4 counts (the full-width run's four
    processes over its 3 steps) go into the kernels line, replacing phase
    34's.

Every collective run starts with the launch counts at 0 and must launch
each kernel exactly as often as its schedule says, stay within its error
bound, and not overflow (the ``faults`` phase's cases overflow or fail on
purpose and are held by bits to the lossless result instead).

``--phases`` takes a comma list of ``kernels`` (2-3, 8), ``allreduce`` (4),
``movers`` (5-7), ``codecs`` (9), ``grad-sync`` (10-11), ``faults`` (12),
``hier`` (13), ``c6`` (14), ``model`` (15-18), ``train`` (19-21, 23), ``ssm``
(24), ``mla`` (25), ``moe`` (26), ``encdec`` (27), ``vlm`` (28), ``fsdp``
(29), ``tp`` (30), ``tp-families`` (31), ``tp-train`` (32), ``cp-decode``
(33), ``overlap`` (34) and ``train-cli`` (35); a partial run prints no
result lines.

The third-to-last line is the card's ``nvidia-smi`` name and power
limit, the second-to-last one JSON object with a record per kernel, the
last ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; without a CUDA card, or without the package
beside it, it prints no result and exits 2.
"""
import contextlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import threading
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/lorenzo.cu"
ENTROPY_SOURCE = "src/repro_torch/kernels/csrc/entropy.cu"
ENTROPY_KERNELS = ("entropy_quantize_pack", "entropy_unpack_dequantize",
                   "entropy_unpack_dequantize_reduce")
ENTROPY_CODECS = ("lorenzo+entropy", "lossless")
REPLACES = {
    "quantize_pack": "src/repro/kernels/lorenzo.py:392",
    "unpack_reduce_repack": "src/repro/kernels/lorenzo.py:324",
    "unpack_dequantize_reduce": "src/repro/kernels/lorenzo.py:456",
    "unpack_dequantize": "src/repro/kernels/lorenzo.py:426",
    "quantize": "src/repro/kernels/lorenzo.py:110",
    "dequantize": "src/repro/kernels/lorenzo.py:134",
    "dequantize_reduce": "src/repro/kernels/lorenzo.py:491",
    "entropy_quantize_pack": "src/repro/kernels/entropy.py:230",
    "entropy_unpack_dequantize": "src/repro/kernels/entropy.py:263",
    "entropy_unpack_dequantize_reduce": "src/repro/kernels/entropy.py:289",
    "flash_attention": "src/repro/kernels/flash_attn.py:82",
}
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attn_sm90.cu"  # the bf16 route
FLASH_BF16_KERNEL = "flash_fwd_wgmma_kernel"
BF16_FLOPS_PER_S = 989.4e12  # H100 SXM dense bf16 tensor-core peak, data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, data sheet
MAIN_BYTES = 646_000_000  # per rank (allreduce) / at the root (scatter): Figs. 10, 12
SCATTER_WIRE_BYTES = 343_566_440  # benchmarks/BENCH_scatter.json, N = 8
MOVER_BYTES = 16_000_000  # per rank: the data movers and the two-pass paths
EB = 1e-4  # GZConfig's default end-to-end bound


def log(*a):
    print(*a, flush=True)


def ptxas_lines(log):
    """``kernel<template arguments>: registers ...; stack and spills`` for
    each entry function of an ``nvcc -Xptxas -v`` log.  The mangled name is
    read by its length prefixes (a namespace, then the kernel); a name of
    another shape is printed as it is."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = _kernel_name(m.group(1)), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split('Used', 1)[1].strip()}; {spill}")
            name = None
    return out


def _kernel_name(sym):
    m = re.match(r"_ZN(\d+)", sym) or re.match(r"_Z()", sym)
    if not m:
        return sym
    rest = sym[m.end() + int(m.group(1) or 0):]
    n = re.match(r"\d+", rest)
    if not n:
        return sym
    name = rest[n.end(): n.end() + int(n.group())]
    args = re.match(r"I((?:L[bi]\d+E)+)E", rest[n.end() + int(n.group()):])
    if args:
        vals = [("false", "true")[int(v)] if k == "b" else v
                for k, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
        name += f"<{', '.join(vals)}>"
    return name


def _reset_launches():
    from repro_torch.kernels import entropy, flash_attn, lorenzo

    lorenzo.reset_launch_counts()
    entropy.reset_launch_counts()
    flash_attn.reset_launch_counts()


def _launches():
    """Every kernel's launch count since the last reset (the entropy
    kernels under their ``entropy_`` names)."""
    from repro_torch.kernels import entropy, flash_attn, lorenzo

    return {**lorenzo.LAUNCHES, **{f"entropy_{k}": v for k, v in entropy.LAUNCHES.items()},
            **flash_attn.LAUNCHES}


def _device_events(prof):
    """The profile's device-side rows (kernels, copies, fills) with their
    device time.  A host op's row (``aten::mm``) also carries the device
    time of the kernels it launched, so summing every row counts those
    kernels twice; only the device rows are summed."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def _median_ms(fn, reps, calls=1):
    """Median over ``reps`` event pairs of the time per call, with ``calls``
    back-to-back calls between the two events (more than one keeps the
    device queue full, so the host's launch time stays out of the figure)."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return sorted(times)[len(times) // 2]


# The port's own kernels (csrc/lorenzo.cu, csrc/entropy.cu) by symbol.
OWN_KERNEL = re.compile(r"\(anonymous namespace\)::(ent_\w+_kernel|hop_\w+_kernel|"
                        r"qp_\w+_kernel|ud_\w+_kernel|quantize_front_kernel|"
                        r"dq_\w+_kernel)\b")


def _device_ms(fn, calls=10):
    """Device time per call of the port's kernels that ``fn`` launches,
    from the profiler over ``calls`` calls (no host time, no torch ops)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in _device_events(prof)
               if OWN_KERNEL.search(e.key)) / 1e3 / calls


def _random_walk(n, gen, device):
    """Seeded random-walk field: cumsum of N(0, 0.01) steps (f64 -> f32)."""
    import torch

    steps = torch.randn(n, dtype=torch.float64, generator=gen, device=device)
    return torch.cumsum(steps.mul_(0.01), 0).to(torch.float32)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def _mismatch(a, b):
    """(count, max |a - b|) of two equally shaped tensors, f32 compared by bits."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.float32:
        diff = a.view(torch.int32) != b.view(torch.int32)
        err = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
    else:
        diff = a != b
        err = (a.long() - b.long()).abs().max().item() if a.numel() else 0
    return int(diff.sum().item()), float(err)


def _compare(name, got, want):
    total, err = 0, 0.0
    for g, w in zip(got, want):
        m, e = _mismatch(g, w)
        total += m
        err = max(err, e)
    if total:
        raise AssertionError(f"{name}: {total} elements differ from the plain version")
    return err


def _bytes(name, n, nb, cap_in, words_in, cap_out, emit):
    """Bytes the function must move: each input read once, each output
    written once; a received stream is read only up to its true length."""
    meta = 8 * nb  # bw + anchor
    if name == "quantize_pack":
        return 4 * n + 4 * cap_out + meta
    read = 4 * min(words_in, cap_in) + meta
    if name == "unpack_dequantize":
        return read + 4 * n
    if name == "unpack_dequantize_reduce":
        return read + 8 * n
    return read + 4 * n + 4 * cap_out + meta + (4 * n if emit else 0)


def _log_time(r, tag):
    log(f"  {r['name']:<34} [{tag}] {r['ms']:.4f} ms back-to-back, "
        f"{r['one_call_ms']:.4f} ms one call, {r['device_ms']:.4f} ms of kernel time "
        f"(profiler); plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
        f"({r['bytes'] / 1e6:.1f} MB)")


def check_kernels(device, gen):
    import torch

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import lorenzo, ops

    piece_n = _main_piece_elems()
    chunk_n = -(-MAIN_BYTES // 4 // 8)
    eb_in = torch.full((), EB / 8, dtype=torch.float32, device=device)
    eb_out = torch.full((), EB / 7, dtype=torch.float32, device=device)
    cases = [  # (label, n, capacity_factor, timed)
        ("ragged", 2048 * 3 + 5, 0.6, False),
        ("ragged", 37, 0.6, False),
        ("ragged", 256 * 9 + 200, 2.0, False),
        ("overflow", 300_000, 0.05, False),
        ("ring-chunk", chunk_n, 0.6, False),
        ("ring-piece", piece_n, 0.6, True),
        # the default ``lorenzo`` grad sync's shape: one 16 MiB bucket
        ("16 MiB bucket", BUCKET_BYTES // 4, 0.6, True),
    ]
    records, timings = {}, []
    for label, n, cf, timed in cases:
        x2d = ops.to_blocks(_random_walk(n, gen, device) * 8.0)
        acc = ops.to_blocks(_random_walk(n, gen, device))
        nb = x2d.shape[0]
        cap = capacity_words_for(n, cf, ops.BLOCK)
        stream = lorenzo.quantize_pack_plain(x2d, eb_in, cap)[:3]
        words_in = int(stream[1].long().sum().item()) * 8
        # the hop in its path's mode: the ring piece without the f32 sum,
        # the bucket (the redoub carry) and the other cases with it
        hop_kw = {"emit_f32": label != "ring-piece", "return_total": True}
        calls = {
            "quantize_pack": ((x2d, eb_in, cap), {}),
            "unpack_reduce_repack": ((*stream, eb_in, acc, eb_out, cap), hop_kw),
            "unpack_dequantize_reduce": ((*stream, eb_in, acc), {}),
            "unpack_dequantize": ((*stream, eb_in), {}),
        }
        line = []
        for name, (args, kw) in calls.items():
            kern = getattr(lorenzo, name)
            plain = getattr(lorenzo, f"{name}_plain")
            got, want = kern(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = _compare(f"{name} [{label} n={n}]", got, want)
            if name in ("quantize_pack", "unpack_reduce_repack"):
                nw_got = int(got[1].long().sum()) * 8
                nw_want = int(want[1].long().sum()) * 8
                if nw_got != nw_want:
                    raise AssertionError(f"{name}: nwords {nw_got} != {nw_want}")
                if label == "overflow" and nw_got <= cap:
                    raise AssertionError(f"{name}: overflow case did not overflow")
                if int(got[-1]) != nw_got:
                    raise AssertionError(f"{name}: total {int(got[-1])} != 8 * sum(bw) {nw_got}")
            if name == "unpack_reduce_repack":
                other = {**kw, "emit_f32": not kw["emit_f32"]}  # the other mode too
                _compare(f"{name} [{label} n={n} emit_f32={other['emit_f32']}]",
                         kern(*args, **other), plain(*args, **other))
            line.append(f"{name}=0/{sum(g.numel() for g in got)}")
            if timed:
                emit = kw.get("emit_f32", False)
                nbytes = _bytes(name, nb * ops.BLOCK, nb, cap, words_in, cap, emit)
                rec = {
                    "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": REPLACES[name], "launches": None,
                    "max_abs_err": err,
                    "ms": _median_ms(lambda: kern(*args, **kw), 20, 10),
                    "one_call_ms": _median_ms(lambda: kern(*args, **kw), 20),
                    "device_ms": _device_ms(lambda: kern(*args, **kw)),
                    "plain_ms": _median_ms(lambda: plain(*args, **kw), 5),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "library_ms": None,
                    "shape": [nb, ops.BLOCK], "bytes": nbytes,
                }
                timings.append((label, rec))
                if label == "ring-piece":  # the allreduce's shape
                    records[name] = rec
        log(f"kernels vs plain [{label} n={n} cap={cap} nwords_in={words_in}]: "
            f"mismatches {' '.join(line)}")
    for label, r in timings:
        _log_time(r, label)
    _check_hop_edges(device, gen, eb_in, eb_out)
    _check_pack_edges(device, gen, eb_in)
    _check_unpack_edges(device, gen, eb_in, eb_out)
    _check_nan_acc(device, gen)
    return records


ENTROPY_SYMBOLS = r"ent_\w+_kernel"
LORENZO_SYMBOLS = r"hop_\w+_kernel|qp_\w+_kernel|ud_\w+_kernel|dq_\w+_kernel|quantize_front_kernel"


def _kernel_launches(events, symbols):
    """{kernel symbol: [device launches, device ms]} over a profile's device
    rows of the port's kernels whose names match ``symbols`` (a regex
    alternation)."""
    rows = {}
    for e in events:
        m = re.search(rf"::({symbols})(<[^>]*>)?", e.key)
        if m:
            row = rows.setdefault(m.group(1) + (m.group(2) or ""), [0, 0.0])
            row[0] += e.count
            row[1] += e.self_device_time_total / 1e3
    return rows


def _ud_summary(rows, kernel="ud_lookback_kernel"):
    """Kernels 3 and 4's (or, with ``dq_tile_kernel``, 7 and 6's) launches
    and device ms in ``_kernel_launches`` rows."""
    return ", ".join(f"{rows.get(k, [0, 0.0])[0]} {k} launches, "
                     f"{rows.get(k, [0, 0.0])[1]:.2f} ms"
                     for k in (f"{kernel}<true>", f"{kernel}<false>"))


class ProfileShortfall(AssertionError):
    """A profile that holds fewer launches of a kernel than the bound allows
    and no kernel more than its wrapper launched: what a lossy trace shows."""


def _check_counts(got, want, dropped, what):
    """Each kernel's profiled launches ``got`` within [(1 - dropped) *
    want, want]: more is an error, fewer a ``ProfileShortfall``."""
    if set(got) != set(want) or any(got[k] > want[k] for k in want):
        raise AssertionError(f"{what}: {got} for wrapper calls {want}")
    if any(got[k] < (1 - dropped) * want[k] for k in want):
        raise ProfileShortfall(f"{what}: {got} for wrapper calls {want}")


def _check_hop_launch_structure(rows, calls, label, dropped=0.0):
    """Every ``unpack_reduce_repack`` call is one ``hop_lookback_kernel``
    launch and one ``hop_zero_tail_kernel`` launch, every ``quantize_pack``
    call one ``qp_lookback_kernel`` and one ``qp_zero_tail_kernel``, every
    ``quantize`` call one ``quantize_front_kernel``, every call of kernels
    3 and 4 one ``ud_lookback_kernel`` and every call of kernels 6 and 7
    one ``dq_tile_kernel``.  ``calls`` are the Lorenzo
    wrappers' counts; ``dropped`` is the share of device events a long
    profile may lose (never gain)."""
    want = {"hop_lookback_kernel": calls["unpack_reduce_repack"],
            "hop_zero_tail_kernel": calls["unpack_reduce_repack"],
            "qp_lookback_kernel": calls["quantize_pack"],
            "qp_zero_tail_kernel": calls["quantize_pack"],
            "quantize_front_kernel": calls["quantize"],
            "ud_lookback_kernel": calls["unpack_dequantize"]
            + calls["unpack_dequantize_reduce"],
            "dq_tile_kernel": calls["dequantize"] + calls["dequantize_reduce"]}
    got = dict.fromkeys(want, 0)
    for sym, (count, _) in rows.items():
        base = sym.split("<")[0]
        if base not in got:
            raise AssertionError(f"{label}: {sym} launched {count} times")
        got[base] += count
    _check_counts(got, want, dropped, f"{label}: Lorenzo kernel launches")
    return got


def _check_hop_edges(device, gen, eb_in, eb_out):
    """Kernel 2 against its plain version, bitwise, on the single-pass
    design's edges (both ``emit_f32`` modes, the total too): one tile,
    part-full last tiles, outgoing capacities on and inside a tile, an
    incoming stream cut inside a tile, an overflowing stream, full-width
    random bits at the 646 MB ring piece; 50 back-to-back calls on one
    scratch, and hop calls interleaved with entropy calls on the same stream
    (one scratch allocator); then the launches per call from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import entropy, lorenzo, ops

    def hop_case(label, x2d, acc, cap_in, cap_out):
        stream = lorenzo.quantize_pack_plain(x2d, eb_in, cap_in)[:3]
        for emit in (False, True):
            args = (*stream, eb_in, acc, eb_out, cap_out)
            got = lorenzo.unpack_reduce_repack(*args, emit_f32=emit, return_total=True)
            want = lorenzo.unpack_reduce_repack_plain(*args, emit_f32=emit, return_total=True)
            torch.cuda.synchronize()
            _compare(f"unpack_reduce_repack [{label} emit_f32={emit}]", got, want)
        log(f"hop kernel vs plain [{label}, {x2d.shape[0]} rows, cap_in {cap_in}, cap_out "
            f"{cap_out}, {int(got[-1])} words out]: mismatches 0 in stream/bw/anchor/total/"
            f"f32, both emit_f32 modes")
        return got

    def walk(nb):
        return ops.to_blocks(_random_walk(nb * 256, gen, device) * 8.0)

    for nb in (32, 8, 40, 72):  # one tile; part-full last tiles
        x2d, acc = walk(nb), walk(nb) / 8.0
        hop_case("one tile" if nb == 32 else "part-full last tile", x2d, acc,
                 capacity_words_for(nb * 256, 0.6, 256), capacity_words_for(nb * 256, 0.6, 256))
    nb = 5 * 32
    x2d, acc = walk(nb), walk(nb) / 8.0
    ample = capacity_words_for(nb * 256, 2.0, 256)
    bw_out = lorenzo.unpack_reduce_repack_plain(
        *lorenzo.quantize_pack_plain(x2d, eb_in, ample)[:3], eb_in, acc, eb_out, 8)[1]
    for label, cap in _tile_caps((8 * bw_out.long()).tolist(), 3).items():
        if not int(hop_case(label, x2d, acc, ample, cap)[-1]) > cap:
            raise AssertionError(f"{label}: the outgoing stream does not overflow")
    bw_in = lorenzo.quantize_pack_plain(x2d, eb_in, 8)[1]
    hop_case("incoming stream cut inside a tile", x2d, acc,
             _tile_caps((8 * bw_in.long()).tolist(), 2)["cap inside a tile"], ample)
    if not int(hop_case("overflow", x2d, acc, ample, 64)[-1]) > 64:
        raise AssertionError("overflow case did not overflow")
    n = _main_piece_elems()
    bits = ops.to_blocks(_random_bits(n, gen, device))
    acc_bits = ops.to_blocks(_random_bits(n, gen, device))
    cap = capacity_words_for(n, 2.0, 256)
    got = hop_case("646 MB ring piece, full-width random bits", bits, acc_bits, cap, cap)
    full = int((got[1] == 32).sum())
    if full < 0.9 * bits.shape[0]:
        raise AssertionError(f"random bits: {full} of {bits.shape[0]} blocks at width 32")
    del bits, acc_bits, got

    n = BUCKET_BYTES // 4
    x2d, acc = ops.to_blocks(_random_walk(n, gen, device) * 8.0), \
        ops.to_blocks(_random_walk(n, gen, device))
    cap = capacity_words_for(n, 0.6, 256)
    stream = lorenzo.quantize_pack_plain(x2d, eb_in, cap)[:3]
    args = (*stream, eb_in, acc, eb_out, cap)
    want = lorenzo.unpack_reduce_repack_plain(*args, emit_f32=True, return_total=True)
    outs = [lorenzo.unpack_reduce_repack(*args, emit_f32=True, return_total=True)
            for _ in range(50)]
    for i, got in enumerate(outs):
        _compare(f"unpack_reduce_repack [back-to-back call {i}]", got, want)
    del outs
    ent = entropy.quantize_pack_plain(acc, eb_in, cap)
    ent_want = (ent, entropy.unpack_dequantize_reduce_plain(*ent[:3], eb_in, x2d))
    outs = []
    for _ in range(20):  # hop, entropy pack, hop, entropy unpack-reduce: one scratch
        outs.append(("hop", lorenzo.unpack_reduce_repack(*args, emit_f32=True,
                                                         return_total=True)))
        outs.append(("ent", entropy.quantize_pack(acc, eb_in, cap)))
        outs.append(("hop", lorenzo.unpack_reduce_repack(*args, emit_f32=True,
                                                         return_total=True)))
        outs.append(("red", (entropy.unpack_dequantize_reduce(*ent[:3], eb_in, x2d),)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"interleaved call {i} ({kind})", got,
                 want if kind == "hop" else ent_want[0] if kind == "ent" else (ent_want[1],))
    log("hop kernel vs plain [50 back-to-back calls at the 16 MiB bucket, one scratch; "
        "20 rounds interleaved with entropy calls on the same stream]: mismatches 0")
    del outs
    lorenzo.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lorenzo.unpack_reduce_repack(*args, emit_f32=True)
            lorenzo.unpack_reduce_repack(*args)
        torch.cuda.synchronize()
    rows = _kernel_launches(_device_events(prof), LORENZO_SYMBOLS)
    _check_hop_launch_structure(rows, lorenzo.LAUNCHES, "hop calls")
    log(f"hop kernel launches for 6 calls (16 MiB bucket): {rows}")
    del prof, stream, args, want, ent, ent_want
    torch.cuda.empty_cache()


def _check_pack_edges(device, gen, eb):
    """Kernel 1 against its plain version, bitwise (stream, bw, anchor and
    the total, which must be 8 * sum(bw)), on the single-pass design's
    edges: one tile, part-full last tiles, capacities on and inside a tile,
    an overflowing stream, NaN/Inf/saturating input, full-width random bits
    at the 646 MB ring piece; 50 back-to-back calls on one scratch, and
    calls interleaved with hop and entropy calls on the same stream; then
    the launches per call from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import entropy, lorenzo, ops

    def case(label, x2d, cap):
        got = lorenzo.quantize_pack(x2d, eb, cap)
        want = lorenzo.quantize_pack_plain(x2d, eb, cap)
        torch.cuda.synchronize()
        _compare(f"quantize_pack [{label}]", got, want)
        total = int(got[-1])
        if total != 8 * int(got[1].long().sum()):
            raise AssertionError(f"quantize_pack [{label}]: total {total} != 8 * sum(bw)")
        log(f"quantize_pack kernel vs plain [{label}, {x2d.shape[0]} rows, cap {cap}, "
            f"{total} words]: mismatches 0 in stream/bw/anchor/total")
        return got

    def walk(nb):
        return ops.to_blocks(_random_walk(nb * 256, gen, device) * 8.0)

    for nb in (32, 8, 40, 72):  # one tile; part-full last tiles
        case("one tile" if nb == 32 else "part-full last tile", walk(nb),
             capacity_words_for(nb * 256, 0.6, 256))
    x2d = walk(5 * 32)
    bw = lorenzo.quantize_pack_plain(x2d, eb, 8)[1]
    for label, cap in {**_tile_caps((8 * bw.long()).tolist(), 3), "overflow": 64}.items():
        if not int(case(label, x2d, cap)[-1]) > cap:
            raise AssertionError(f"{label}: the stream does not overflow")
    case("nan/inf/saturating", ops.to_blocks(_wild(300_000, gen, device)),
         capacity_words_for(300_000, 2.0, 256))
    n = _main_piece_elems()
    bits = ops.to_blocks(_random_bits(n, gen, device))
    got = case("646 MB ring piece, full-width random bits", bits,
               capacity_words_for(n, 2.0, 256))
    full = int((got[1] == 32).sum())
    if full < 0.9 * bits.shape[0]:
        raise AssertionError(f"random bits: {full} of {bits.shape[0]} blocks at width 32")
    del bits, got

    n = BUCKET_BYTES // 4
    x2d, acc = ops.to_blocks(_random_walk(n, gen, device) * 8.0), \
        ops.to_blocks(_random_walk(n, gen, device))
    cap = capacity_words_for(n, 0.6, 256)
    want = lorenzo.quantize_pack_plain(x2d, eb, cap)
    outs = [lorenzo.quantize_pack(x2d, eb, cap) for _ in range(50)]
    for i, got in enumerate(outs):
        _compare(f"quantize_pack [back-to-back call {i}]", got, want)
    hop_args = (*want[:3], eb, acc, eb, cap)
    hop_want = lorenzo.unpack_reduce_repack_plain(*hop_args, emit_f32=True, return_total=True)
    ent = entropy.quantize_pack_plain(acc, eb, cap)
    red_want = (entropy.unpack_dequantize_reduce_plain(*ent[:3], eb, x2d),)
    wants = {"qp": want, "hop": hop_want, "ent": ent, "red": red_want}
    outs = []
    for _ in range(20):  # one scratch for all: kernel 1, hop, entropy pack, kernel 1, reduce
        outs.append(("qp", lorenzo.quantize_pack(x2d, eb, cap)))
        outs.append(("hop", lorenzo.unpack_reduce_repack(*hop_args, emit_f32=True,
                                                         return_total=True)))
        outs.append(("ent", entropy.quantize_pack(acc, eb, cap)))
        outs.append(("qp", lorenzo.quantize_pack(x2d, eb, cap)))
        outs.append(("red", (entropy.unpack_dequantize_reduce(*ent[:3], eb, x2d),)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"interleaved call {i} ({kind})", got, wants[kind])
    log("quantize_pack kernel vs plain [50 back-to-back calls at the 16 MiB bucket, one "
        "scratch; 20 rounds interleaved with hop and entropy calls on the same stream]: "
        "mismatches 0")
    del outs, wants
    lorenzo.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lorenzo.quantize_pack(x2d, eb, cap)
        torch.cuda.synchronize()
    rows = _kernel_launches(_device_events(prof), LORENZO_SYMBOLS)
    _check_hop_launch_structure(rows, lorenzo.LAUNCHES, "quantize_pack calls")
    log(f"quantize_pack kernel launches for 3 calls (16 MiB bucket): {rows}")
    del prof, x2d, acc, want, hop_want, ent, red_want
    torch.cuda.empty_cache()


def _check_unpack_edges(device, gen, eb, eb_out):
    """Kernels 3 and 4 against their plain versions, f32 by bits, on the
    single-pass design's edges: one tile, part-full last tiles, all-zero
    widths, full-width random bits at the 646 MB ring piece (NaNs in acc
    too), streams cut on and inside a tile and far below their length,
    ``packed`` as a view 1, 2 and 3 words off a 16-byte boundary, ``acc``
    as an unaligned view; 50 back-to-back calls on one scratch, and calls
    interleaved on the same stream with kernel 1, kernel 2 and entropy
    calls; a 0-block call raises ``ValueError``; then one
    ``ud_lookback_kernel`` launch per call from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import entropy, lorenzo, ops

    def case(label, stream, acc):
        got = (lorenzo.unpack_dequantize(*stream, eb),
               lorenzo.unpack_dequantize_reduce(*stream, eb, acc))
        want = (lorenzo.unpack_dequantize_plain(*stream, eb),
                lorenzo.unpack_dequantize_reduce_plain(*stream, eb, acc))
        torch.cuda.synchronize()
        _compare(f"unpack_dequantize [{label}]", got[:1], want[:1])
        _compare(f"unpack_dequantize_reduce [{label}]", got[1:], want[1:])
        words = 8 * int(stream[1].long().sum())
        log(f"unpack kernels vs plain [{label}, {stream[1].shape[0]} rows, cap "
            f"{stream[0].shape[0]}, {words} words]: mismatches 0 by bits, kernels 3 and 4")
        return words

    def walk(nb):
        return ops.to_blocks(_random_walk(nb * 256, gen, device) * 8.0)

    def packed_of(x2d, cap):
        return lorenzo.quantize_pack_plain(x2d, eb, cap)[:3]

    for nb in (32, 8, 40, 72):  # one tile; part-full last tiles
        case("one tile" if nb == 32 else "part-full last tile",
             packed_of(walk(nb), capacity_words_for(nb * 256, 0.6, 256)), walk(nb) / 8.0)
    zero = packed_of(torch.zeros((40, 256), device=device), capacity_words_for(40 * 256, 0.6, 256))
    if case("all-zero widths", zero, walk(40) / 8.0) != 0:
        raise AssertionError("all-zero input: the stream is not empty")
    nb = 5 * 32
    x2d, acc = walk(nb), walk(nb) / 8.0
    ample = capacity_words_for(nb * 256, 2.0, 256)
    stream = packed_of(x2d, ample)
    case("ample capacity", stream, acc)
    for label, cap in {**_tile_caps((8 * stream[1].long()).tolist(), 3),
                       "cut far below the stream": 64}.items():
        if not case(label, packed_of(x2d, cap), acc) > cap:
            raise AssertionError(f"{label}: the stream is not cut")
    for k in (1, 2, 3):  # the stream pointer k words past a 16-byte boundary
        buf = torch.zeros(ample + 4, dtype=torch.int32, device=device)
        view = buf[k: k + ample]
        view.copy_(stream[0])
        case(f"packed {4 * k} bytes off a 16-byte boundary", (view, *stream[1:]), acc)
    buf = torch.empty(nb * 256 + 1, dtype=torch.float32, device=device)
    acc_view = buf[1:].view(nb, 256)
    acc_view.copy_(acc)
    case("acc 4 bytes off a 16-byte boundary", stream, acc_view)
    n = _main_piece_elems()
    bits = ops.to_blocks(_random_bits(n, gen, device))
    stream = packed_of(bits, capacity_words_for(n, 2.0, 256))
    full = int((stream[1] == 32).sum())
    if full < 0.9 * bits.shape[0]:
        raise AssertionError(f"random bits: {full} of {bits.shape[0]} blocks at width 32")
    case("646 MB ring piece, full-width random bits", stream,
         ops.to_blocks(_random_bits(n, gen, device)))
    del bits, stream, buf, acc_view
    words8 = torch.zeros(8, dtype=torch.int32, device=device)
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    for extra in ((), (torch.empty((0, 256), device=device),)):
        fn = lorenzo.unpack_dequantize_reduce if extra else lorenzo.unpack_dequantize
        try:
            fn(words8, empty, empty, eb, *extra)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__}: a 0-block call did not raise ValueError")

    n = BUCKET_BYTES // 4
    x2d, acc = ops.to_blocks(_random_walk(n, gen, device) * 8.0), \
        ops.to_blocks(_random_walk(n, gen, device))
    cap = capacity_words_for(n, 0.6, 256)
    stream = packed_of(x2d, cap)
    wants = {"ud": (lorenzo.unpack_dequantize_plain(*stream, eb),),
             "udr": (lorenzo.unpack_dequantize_reduce_plain(*stream, eb, acc),)}
    outs = []
    for _ in range(25):  # 50 calls back to back, one scratch
        outs.append(("ud", (lorenzo.unpack_dequantize(*stream, eb),)))
        outs.append(("udr", (lorenzo.unpack_dequantize_reduce(*stream, eb, acc),)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"unpack [back-to-back call {i} ({kind})]", got, wants[kind])
    del outs
    hop_args = (*stream, eb, acc, eb_out, cap)
    ent = entropy.quantize_pack_plain(acc, eb, cap)
    wants.update(qp=lorenzo.quantize_pack_plain(x2d, eb, cap),
                 hop=lorenzo.unpack_reduce_repack_plain(*hop_args, emit_f32=True,
                                                        return_total=True),
                 ent=ent, red=(entropy.unpack_dequantize_reduce_plain(*ent[:3], eb, x2d),))
    outs = []
    for _ in range(20):  # kernels 4, 1, 3, 2, entropy pack, 4, entropy reduce: one scratch
        outs.append(("ud", (lorenzo.unpack_dequantize(*stream, eb),)))
        outs.append(("qp", lorenzo.quantize_pack(x2d, eb, cap)))
        outs.append(("udr", (lorenzo.unpack_dequantize_reduce(*stream, eb, acc),)))
        outs.append(("hop", lorenzo.unpack_reduce_repack(*hop_args, emit_f32=True,
                                                         return_total=True)))
        outs.append(("ent", entropy.quantize_pack(acc, eb, cap)))
        outs.append(("ud", (lorenzo.unpack_dequantize(*stream, eb),)))
        outs.append(("red", (entropy.unpack_dequantize_reduce(*ent[:3], eb, x2d),)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"interleaved call {i} ({kind})", got, wants[kind])
    log("unpack kernels vs plain [50 back-to-back calls at the 16 MiB bucket, one scratch; "
        "20 rounds interleaved with kernel 1, kernel 2 and entropy calls on the same "
        "stream]: mismatches 0; a 0-block call raises ValueError")
    del outs, wants
    lorenzo.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lorenzo.unpack_dequantize(*stream, eb)
            lorenzo.unpack_dequantize_reduce(*stream, eb, acc)
        torch.cuda.synchronize()
    rows = _kernel_launches(_device_events(prof), LORENZO_SYMBOLS)
    _check_hop_launch_structure(rows, lorenzo.LAUNCHES, "unpack calls")
    if {k: c for k, (c, _) in rows.items()} != {"ud_lookback_kernel<true>": 3,
                                                 "ud_lookback_kernel<false>": 3}:
        raise AssertionError(f"unpack calls: launches {rows} for 3 calls of kernels 3 and 4")
    log(f"unpack kernel launches for 3 calls each of kernels 3 and 4 (16 MiB bucket): {rows}")
    del prof, x2d, acc, stream, ent
    torch.cuda.empty_cache()


# Signalling NaNs, then quiet ones and NaNs carrying payloads, as f32 bits.
NAN_BITS = (0x7F800001, 0xFF800001, 0x7FA5A5A5, 0xFFBFFFFF,
            0x7FC00000, 0xFFC00000, 0x7FC12345, 0xFFE00ABC, 0x7FFFFFFF)


def _nan_laden(n, gen, device, stride):
    """A random walk with the NaNs of ``NAN_BITS`` every ``stride`` elements
    and +-Inf every 53 and 59."""
    import torch

    x = _random_walk(n, gen, device)
    idx = torch.arange(0, n, stride, device=device)
    nans = torch.tensor(NAN_BITS, dtype=torch.int64, device=device).to(torch.int32)
    x.view(torch.int32)[idx] = nans[torch.arange(idx.numel(), device=device) % len(NAN_BITS)]
    x[11::53] = float("inf")
    x[13::59] = float("-inf")
    return x


def _check_nan_acc(device, gen):
    """Kernels 3, 7 and 10 (lossy and lossless) against their plain
    versions, by bits, with signalling NaNs and NaNs carrying payloads in
    ``acc`` (lossless: NaN values too, both NaN, and inf - inf): a NaN in
    acc comes out as itself, quieted, where the value is not NaN."""
    import torch

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.core.compressor import lossless_capacity_words
    from repro_torch.kernels import entropy, lorenzo, ops

    n = 300_000
    eb = torch.full((), EB, dtype=torch.float32, device=device)
    x2d = ops.to_blocks(_random_walk(n, gen, device) * 8.0)
    acc = ops.to_blocks(_nan_laden(n, gen, device, 37))
    vals = ops.to_blocks(_nan_laden(n, gen, device, 41))  # lossless values
    infs = torch.isinf(acc)
    vals[infs] = -acc[infs]
    cap = capacity_words_for(n, 0.6, 256)
    stream = lorenzo.quantize_pack_plain(x2d, eb, cap)[:3]
    codes, _, anchor = lorenzo.quantize_plain(x2d, eb)
    ent = entropy.quantize_pack_plain(x2d, eb, cap)
    ent_l = entropy.quantize_pack_plain(vals, eb, lossless_capacity_words(n), lossless=True)
    cases = {  # name: (kernel, plain, arguments, keywords, the values decoded)
        "unpack_dequantize_reduce": (lorenzo.unpack_dequantize_reduce,
                                     lorenzo.unpack_dequantize_reduce_plain,
                                     (*stream, eb, acc), {}, x2d),
        "dequantize_reduce": (lorenzo.dequantize_reduce, lorenzo.dequantize_reduce_plain,
                              (codes, anchor, eb, acc), {}, x2d),
        "entropy_unpack_dequantize_reduce": (
            entropy.unpack_dequantize_reduce, entropy.unpack_dequantize_reduce_plain,
            (*ent[:3], eb, acc), {}, x2d),
        "entropy_unpack_dequantize_reduce lossless": (
            entropy.unpack_dequantize_reduce, entropy.unpack_dequantize_reduce_plain,
            (*ent_l[:3], eb, acc), {"lossless": True}, vals),
    }
    nan = torch.isnan(acc)
    for name, (kern, plain, args, kw, values) in cases.items():
        got = kern(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        _compare(f"{name} [NaN in acc]", (got,), (want,))
        only = nan & ~torch.isnan(values)
        if not torch.equal(got.view(torch.int32)[only],
                           acc.view(torch.int32)[only] | 0x00400000):
            raise AssertionError(f"{name}: a NaN in acc did not come out as itself, quieted")
        log(f"{name} kernel vs plain [NaN in acc: {int(nan.sum())} NaNs, "
            f"{int(infs.sum())} infinities, {int((nan & ~only).sum())} NaN values under a "
            f"NaN acc]: mismatches 0 by bits")
    del x2d, acc, vals, stream, codes, ent, ent_l
    torch.cuda.empty_cache()


def _wild(n, gen, device):
    """Random-walk data with NaN, +-Inf and values whose q passes the int32
    range at eb = 1e-4 (the quantizer saturates them)."""
    import torch

    x = _random_walk(n, gen, device) * 100.0
    x[::97] = float("nan")
    x[5::89] = float("inf")
    x[7::83] = float("-inf")
    x[11::79] = 5e5
    x[13::71] = -1e30
    return x


def _wrapping_codes(nb, gen, device):
    """Full-range random codes and anchors: the in-block prefix sum wraps
    in int32 in nearly every block."""
    import torch

    codes = torch.randint(-2**31, 2**31, (nb, 256), generator=gen, device=device,
                          dtype=torch.int64).to(torch.int32)
    anchor = torch.randint(-2**31, 2**31, (nb,), generator=gen, device=device,
                           dtype=torch.int64).to(torch.int32)
    return codes, anchor


def _check_dequant_edges(device, gen, eb):
    """Kernels 6 and 7 against their plain versions, f32 by bits, on the
    tiled design's edges: one tile, full tiles and part-full last tiles
    (1, 7, 8, 31, 32, 33, 40, 72, 264 and 16,895 rows in 8-block tiles,
    16,896 and 16,929 rows in 32-block tiles), ``codes`` and ``acc`` as
    views 1, 2 and 3 words off a 16-byte boundary, int32-wrapping codes
    at the scatter's shape (630,912 rows), 50 back-to-back calls at one
    ``fused=False`` scatter chunk (78,864 rows); a 0-row call raises
    ``ValueError``; then,
    from the profiler, one ``dq_tile_kernel`` launch per call and no other
    Lorenzo kernel (the one-CTA-per-block ``dequantize_kernel`` included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import lorenzo, ops

    def case(label, codes, anchor, acc):
        got = (lorenzo.dequantize(codes, anchor, eb),
               lorenzo.dequantize_reduce(codes, anchor, eb, acc))
        want = (lorenzo.dequantize_plain(codes, anchor, eb),
                lorenzo.dequantize_reduce_plain(codes, anchor, eb, acc))
        torch.cuda.synchronize()
        _compare(f"dequantize [{label}]", got[:1], want[:1])
        _compare(f"dequantize_reduce [{label}]", got[1:], want[1:])
        log(f"unfused decode vs plain [{label}, {codes.shape[0]} rows]: mismatches 0 by "
            f"bits, kernels 6 and 7")

    def smooth(nb):
        x2d = (_random_walk(nb * 256, gen, device) * 8.0).view(nb, 256)
        codes, _, anchor = lorenzo.quantize_plain(x2d, eb)
        return codes, anchor, _random_walk(nb * 256, gen, device).view(nb, 256)

    for nb in (1, 7, 8, 31, 32, 33, 40, 72, 264, 16_895, 16_896, 16_929):
        tile = 32 if nb >= 16_896 else 8  # lz_dequantize's kWideRows
        label = "one tile" if nb == tile else "part-full last tile" if nb % tile else \
            "full tiles"
        case(f"{label} of {tile} blocks", *smooth(nb))
    nb = 72
    codes, anchor, acc = smooth(nb)
    for k in (1, 2, 3):  # both pointers k words past a 16-byte boundary
        cbuf = torch.zeros(nb * 256 + 4, dtype=torch.int32, device=device)
        abuf = torch.zeros(nb * 256 + 4, dtype=torch.float32, device=device)
        cview, aview = cbuf[k: k + nb * 256].view(nb, 256), abuf[k: k + nb * 256].view(nb, 256)
        cview.copy_(codes)
        aview.copy_(acc)
        case(f"codes and acc {4 * k} bytes off a 16-byte boundary", cview, anchor, aview)
    del cbuf, abuf, cview, aview
    rows = 8 * ops.n_blocks_for(MAIN_BYTES // 4 // 8)
    codes, anchor = _wrapping_codes(rows, gen, device)
    case("int32-wrapping codes at the scatter shape", codes, anchor,
         _random_walk(rows * 256, gen, device).view(rows, 256) * 1e6)
    del codes, anchor
    torch.cuda.empty_cache()
    for extra in ((), (torch.empty((0, 256), device=device),)):
        fn = lorenzo.dequantize_reduce if extra else lorenzo.dequantize
        try:
            fn(torch.zeros((0, 256), dtype=torch.int32, device=device),
               torch.zeros(0, dtype=torch.int32, device=device), eb, *extra)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__}: a 0-row call did not raise ValueError")

    codes, anchor, acc = smooth(ops.n_blocks_for(MAIN_BYTES // 4 // 8))
    wants = {"dq": lorenzo.dequantize_plain(codes, anchor, eb),
             "dqr": lorenzo.dequantize_reduce_plain(codes, anchor, eb, acc)}
    outs = []
    for _ in range(25):  # 50 calls back to back
        outs.append(("dq", lorenzo.dequantize(codes, anchor, eb)))
        outs.append(("dqr", lorenzo.dequantize_reduce(codes, anchor, eb, acc)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"unfused decode [back-to-back call {i} ({kind})]", (got,), (wants[kind],))
    log(f"unfused decode vs plain [50 back-to-back calls at one fused=False scatter chunk, "
        f"{codes.shape[0]} rows]: mismatches 0; a 0-row call raises ValueError")
    del outs, wants
    lorenzo.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lorenzo.dequantize(codes, anchor, eb)
            lorenzo.dequantize_reduce(codes, anchor, eb, acc)
        torch.cuda.synchronize()
    rows = _kernel_launches(_device_events(prof), LORENZO_SYMBOLS + "|dequantize_kernel")
    _check_hop_launch_structure(rows, lorenzo.LAUNCHES, "unfused decode calls")
    if {k: c for k, (c, _) in rows.items()} != {"dq_tile_kernel<true>": 3,
                                                 "dq_tile_kernel<false>": 3}:
        raise AssertionError(f"unfused decode calls: launches {rows} for 3 calls of kernels "
                             f"6 and 7")
    log(f"unfused decode kernel launches for 3 calls each of kernels 6 and 7 "
        f"({codes.shape[0]} rows): {rows}")
    del prof, codes, anchor, acc
    torch.cuda.empty_cache()


def _unfused_bytes(name, nb):
    """Bytes the unfused kernel must move: inputs once, outputs once."""
    n = nb * 256
    if name == "quantize":
        return 4 * n + 4 * n + 8 * nb  # x in; codes, bw, anchor out
    if name == "dequantize":
        return 4 * n + 4 * nb + 4 * n  # codes, anchor in; f32 out
    return 4 * n + 4 * nb + 8 * n  # + acc in


def check_unfused_kernels(device, gen):
    import torch

    from repro_torch.kernels import lorenzo, ops

    eb = torch.full((), EB, dtype=torch.float32, device=device)
    chunk_n = MAIN_BYTES // 4 // 8
    cases = [  # (label, x2d, timed)
        ("ragged n=37", ops.to_blocks(_random_walk(37, gen, device)), False),
        ("ragged n=6149", ops.to_blocks(_random_walk(2048 * 3 + 5, gen, device)), False),
        ("ragged n=2504", ops.to_blocks(_random_walk(256 * 9 + 200, gen, device)), False),
        ("nan/inf/saturating", ops.to_blocks(_wild(300_000, gen, device)), False),
    ]
    x = torch.zeros((8, ops.n_blocks_for(chunk_n) * ops.BLOCK), device=device)
    x[:, :chunk_n] = _random_walk(8 * chunk_n, gen, device).view(8, chunk_n)
    cases.append(("scatter shape", x.view(-1, ops.BLOCK), True))
    del x
    records = {}
    for label, x2d, timed in cases:
        nb = x2d.shape[0]
        acc = _random_walk(nb * ops.BLOCK, gen, device).view(nb, ops.BLOCK)
        got = lorenzo.quantize(x2d, eb)
        want = lorenzo.quantize_plain(x2d, eb)
        torch.cuda.synchronize()
        errs = {"quantize": _compare(f"quantize [{label}]", got, want)}
        codes, _, anchor = got
        calls = {
            "quantize": (x2d, eb),
            "dequantize": (codes, anchor, eb),
            "dequantize_reduce": (codes, anchor, eb, acc),
        }
        for name in ("dequantize", "dequantize_reduce"):
            errs[name] = _compare(f"{name} [{label}]",
                                  (getattr(lorenzo, name)(*calls[name]),),
                                  (getattr(lorenzo, f"{name}_plain")(*calls[name]),))
        log(f"unfused kernels vs plain [{label}, {nb} rows]: mismatches 0 in "
            f"codes/bw/anchor and both f32 outputs")
        if timed:
            for name, args in calls.items():
                kern = getattr(lorenzo, name)
                plain = getattr(lorenzo, f"{name}_plain")
                nbytes = _unfused_bytes(name, nb)
                records[name] = {
                    "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": REPLACES[name], "launches": None,
                    "max_abs_err": errs[name],
                    "ms": _median_ms(lambda: kern(*args), 20, 10),
                    "one_call_ms": _median_ms(lambda: kern(*args), 20),
                    "device_ms": _device_ms(lambda: kern(*args)),
                    "plain_ms": _median_ms(lambda: plain(*args), 3),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "library_ms": None,
                    "shape": [nb, ops.BLOCK], "bytes": nbytes,
                }
        del calls, got, want, codes, anchor, acc
    codes, anchor = _wrapping_codes(4096, gen, device)
    acc = _random_walk(4096 * 256, gen, device).view(4096, 256) * 1e6
    for name, args in (("dequantize", (codes, anchor, eb)),
                       ("dequantize_reduce", (codes, anchor, eb, acc))):
        _compare(f"{name} [int32 wrap]", (getattr(lorenzo, name)(*args),),
                 (getattr(lorenzo, f"{name}_plain")(*args),))
    log("unfused kernels vs plain [int32-wrapping prefix sums, 4096 rows]: mismatches 0")
    del codes, anchor, acc
    _check_dequant_edges(device, gen, eb)
    for r in records.values():
        _log_time(r, "scatter shape")
    torch.cuda.empty_cache()
    return records


def _main_piece_elems():
    from repro_torch.core.collectives import PIECE_QUANTUM

    n = MAIN_BYTES // 4
    quantum = 8 * 2 * PIECE_QUANTUM
    return -(-n // quantum) * quantum // 16


# ---------------------------------------------------------------------------
# Phase 3/4: the main path
# ---------------------------------------------------------------------------


def _expected_launches(plan, n):
    """Per-kernel launches of one call over all n ranks, from the
    schedule.  ``compress``, ``decompress`` and ``reduce`` are the
    codec's kernels: the fused Lorenzo kernels, with ``fused=False``
    ``quantize``, ``dequantize`` and ``dequantize_reduce``, or the entropy
    kernels 8-10 (the entropy codecs' ``fused=False`` stages and
    ``passthrough`` launch none); a reduce hop is one
    ``unpack_reduce_repack`` with the fused Lorenzo codec and hop, else a
    reduce and a compress.  The scatter and the all-to-all compress their
    Lorenzo chunks in one batched ``quantize``, other codecs chunk by
    chunk."""
    e = dict.fromkeys(_launches(), 0)
    if plan.codec == "lorenzo":
        comp, dec, red = (("quantize_pack", "unpack_dequantize", "unpack_dequantize_reduce")
                          if plan.fused else ("quantize", "dequantize", "dequantize_reduce"))
    elif plan.codec in ENTROPY_CODECS and plan.fused:
        comp, dec, red = ENTROPY_KERNELS
    else:
        return e
    if plan.op == "allreduce" and plan.algo == "intring":
        e["quantize"] += n  # one quantization per rank; packs and sums are torch ops
        return e
    chunked = plan.codec != "lorenzo"
    single_pass = plan.codec == "lorenzo" and plan.fused and plan.fused_hop
    p = plan.pipeline_chunks
    if plan.op in ("allreduce", "reduce_scatter") and plan.algo == "ring":
        hops = (n - 2) * p  # intermediate reduce hops per rank
        if single_pass:
            e["quantize_pack"] += p * n
            e["unpack_reduce_repack"] += hops * n
        else:
            e[comp] += (hops + p) * n
            e[red] += hops * n
        e[red] += p * n
        if plan.op == "allreduce":  # the allgather stage
            e[comp] += p * n
            e[dec] += p * n * n
    elif plan.op == "allreduce":  # redoub
        pw = 1 << (n.bit_length() - 1)
        rem, steps = n - pw, pw.bit_length() - 1
        hops = steps - 1 + (2 if rem else 0)
        e[comp] += n
        if single_pass:
            e["unpack_reduce_repack"] += hops * n
        else:
            e[comp] += hops * n
            e[red] += hops * n
        if not rem:
            e[red] += n
        e[dec] += rem
    elif plan.op == "allgather":
        e[comp] += p * n
        e[dec] += p * n * n
    elif plan.op == "broadcast":
        e[comp] += n
        e[dec] += n
    elif plan.op == "scatter":  # at the root only
        e[comp if chunked else "quantize"] += n if chunked else 1
        e[dec] += n
    elif plan.op == "all_to_all":
        e[comp if chunked else "quantize"] += n * n if chunked else n
        e[dec] += n * n
    return e


def _check_launches(plan, n, launches):
    expected = _expected_launches(plan, n)
    if launches != expected:
        raise AssertionError(f"{plan.op}: launch counts {launches} != schedule's {expected}")


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def run_allreduce(n, nbytes, device, gen, config_kw=None, label="", profile=False):
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n_elems = nbytes // 4
    xs, exact = [], None
    for _ in range(n):
        x = _random_walk(n_elems, gen, device)
        exact = x.double() if exact is None else exact.add_(x.double())
        xs.append(x)
    comm = GZCommunicator("x", config=GZConfig(**(config_kw or {})), axis_size=n,
                          device=device)
    plan = comm.plan("allreduce", (n_elems,))
    group = transport.ThreadGroup(n, device)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res = group.run(comm.allreduce, xs, axis_name="x")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    outs = [r.value for r in res]
    overflow = any(bool(r.overflow) for r in res)
    nonfinite = any(bool(r.nonfinite) for r in res)
    err = max((o.double() - exact).abs().max().item() for o in outs)
    bound = EB * 1.05 + exact.abs().max().item() * 1e-6
    spread = max((o != outs[0]).sum().item() for o in outs)
    log(f"allreduce {label} N={n} {nbytes / 1e6:.0f} MB/rank: algo={plan.algo} "
        f"pipeline_chunks={plan.pipeline_chunks} wire_bytes={plan.wire_bytes} "
        f"ratio={plan.ratio:.4f} wall={wall * 1e3:.1f} ms err={err:.3e} "
        f"bound={bound:.3e} overflow={overflow} rank_mismatch={spread} "
        f"launches={_nonzero(launches)}")
    _check_launches(plan, n, launches)
    if overflow or nonfinite:
        raise AssertionError(f"overflow={overflow} nonfinite={nonfinite}")
    if not err <= bound:
        raise AssertionError(f"error {err} exceeds the bound {bound}")
    if plan.algo == "ring" and spread:
        raise AssertionError(f"ring ranks differ in {spread} elements")
    del exact, res, outs
    if profile:
        _profile(group, comm.allreduce, xs, plan, intervals=(1e-4,))
    return plan, launches, wall


def _profile(group, fn, xs, plan, intervals=None):
    """Warm wall time of the same call ``fn`` (a communicator method),
    then one run under torch.profiler (device busy time, the kernels that
    take it, and the full names of those launched once per rank), then
    the same schedule at 256 KB per rank, where the device work is
    negligible: the host's floor for this schedule.  The floor and the
    full-size wall are taken at the interpreter's default switch interval
    and at each of ``intervals``.  Returns (the profile's device events,
    device busy ms, warm wall seconds, traced wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.comm import GZCommunicator

    t0 = time.perf_counter()
    group.run(fn, xs, axis_name="x")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    # Host-device syncs inside the collective would serialize the ranks.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            group.run(fn, xs, axis_name="x")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "called a synchronizing" in str(w.message)})
    log(f"host-device syncs inside the {plan.op}: {len(syncs)} kinds {syncs[:3]}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        group.run(fn, xs, axis_name="x")
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile: warm wall {warm * 1e3:.1f} ms; traced wall {traced * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %)")
    rows = _kernel_launches(events, LORENZO_SYMBOLS)
    got = _check_hop_launch_structure(rows, _expected_launches(plan, group.size),
                                      f"profiled {plan.op}", dropped=0.05)
    log(f"  Lorenzo launches in the profile (by kernel): {got}; "
        + "; ".join(f"{k} {c} x {ms:.2f} ms" for k, (c, ms) in sorted(rows.items())))
    log("  kernels 3 and 4 (ud_lookback_kernel<true> / <false>): "
        + _ud_summary(rows))
    log("  kernels 7 and 6 (dq_tile_kernel<true> / <false>): "
        + _ud_summary(rows, "dq_tile_kernel"))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
    for e in events:
        if e.count == group.size:
            log(f"  launched {e.count} times: {e.key} "
                f"({e.self_device_time_total / 1e3:.2f} ms)")
    small = GZCommunicator("x", config=plan.as_config(), axis_size=group.size,
                           device=xs[0].device)
    small_fn = getattr(small, plan.op)
    tiny = [x[: 1 << 16].clone() for x in xs]
    default_interval = sys.getswitchinterval()
    try:
        # The rank threads meet at a barrier per exchange; a woken thread
        # waits for the interpreter lock up to one switch interval.
        for interval in (default_interval, *(intervals or ())):
            sys.setswitchinterval(interval)
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                group.run(small_fn, tiny, axis_name="x")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            group.run(fn, xs, axis_name="x")
            torch.cuda.synchronize()
            full = time.perf_counter() - t0
            log(f"host floor: {plan.algo}/{plan.pipeline_chunks} at 256 KB/rank, "
                f"N={group.size}, switch interval {interval * 1e3:g} ms: warm wall "
                f"{min(walls[1:]) * 1e3:.1f} ms; at full size {full * 1e3:.1f} ms")
    finally:
        sys.setswitchinterval(default_interval)
    return events, busy, warm, traced


@contextlib.contextmanager
def _plain_kernels():
    """Route the kernel entry points to their plain versions (comparison
    only: the package itself never does this)."""
    from repro_torch.kernels import entropy, lorenzo

    saved = [(mod, k, getattr(mod, k)) for mod in (lorenzo, entropy) for k in mod.KERNELS]
    try:
        for mod, k, _ in saved:
            setattr(mod, k, getattr(mod, f"{k}_plain"))
        yield
    finally:
        for mod, k, v in saved:
            setattr(mod, k, v)


def kernels_vs_plain_allreduce(device):
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, 4_000_000 // 4
    for cfg in (GZConfig(), GZConfig(algo="ring", pipeline_chunks=2)):
        gen = torch.Generator(device=device).manual_seed(SEED + 4)
        xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
        comm = GZCommunicator("x", config=cfg, axis_size=n, device=device)
        group = transport.ThreadGroup(n, device)
        kern = group.run(comm.allreduce, xs, axis_name="x")
        with _plain_kernels():
            plain = group.run(comm.allreduce, xs, axis_name="x")
        torch.cuda.synchronize()
        mism = sum(int((a.value.view(torch.int32) != b.value.view(torch.int32)).sum())
                   for a, b in zip(kern, plain))
        algo = comm.plan("allreduce", (n_elems,)).algo
        log(f"allreduce 4 MB/rank N=8 {algo}: kernels vs plain mismatches={mism}")
        if mism:
            raise AssertionError(f"kernel path differs from the plain path in {mism}")


# ---------------------------------------------------------------------------
# Phases 5-7: the data movers and the two-pass paths
# ---------------------------------------------------------------------------


def _run(group, comm, op, xs):
    """One call of ``comm.<op>`` on every rank, launch counts from 0.
    Returns (results, launches, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res = group.run(getattr(comm, op), xs, axis_name="x")
    torch.cuda.synchronize()
    return res, _launches(), time.perf_counter() - t0


def _check_result(label, res, wants, err_scale):
    """Error of every rank's output against its f64 reference within
    1.05 eb + 1e-6 max|reference|, no overflow, no non-finite flag.
    Returns the largest error."""
    worst = 0.0
    for r, (out, want) in enumerate(zip((x.value for x in res), wants)):
        err = (out.double() - want).abs().max().item()
        bound = EB * 1.05 + want.abs().max().item() * err_scale
        if not err <= bound:
            raise AssertionError(f"{label}: rank {r} error {err} exceeds the bound {bound}")
        worst = max(worst, err)
    if any(bool(x.overflow) or bool(x.nonfinite) for x in res):
        raise AssertionError(f"{label}: overflow or non-finite flag set")
    return worst


def _bitwise_mismatches(a, b):
    """Elements of two runs' per-rank results whose f32 bits differ."""
    import torch

    return sum(int((x.value.view(torch.int32) != y.value.view(torch.int32)).sum())
               for x, y in zip(a, b))


def run_scatter(n, nbytes, device, gen, label, profile=False, codec="lorenzo", fused=True,
                fused_run=None):
    """``scatter`` of ``nbytes`` at the root over n ranks.  Non-root
    inputs are NaN: only the root's payload is significant.  With
    ``fused_run``, the (root input, results) of an earlier scatter, it
    scatters that input and must be bitwise equal to those results.
    Returns (plan, launches, wall, (root input, results))."""
    import torch

    from repro_torch.core import bitpack, transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator
    from repro_torch.kernels import lorenzo, ops

    n_elems = nbytes // 4 // n * n  # whole chunks
    x_full = _random_walk(n_elems, gen, device) if fused_run is None else fused_run[0]
    junk = torch.full_like(x_full, float("nan"))
    xs = [x_full] + [junk] * (n - 1)
    comm = GZCommunicator("x", config=GZConfig(codec=codec, fused=fused), axis_size=n,
                          device=device)
    plan = comm.plan("scatter", (n_elems,))
    streams = sum(h.chunk_slab[1] for rnd in plan.route_table.rounds for h in rnd
                  if h.sender == 0)
    group = transport.ThreadGroup(n, device)
    res, launches, wall = _run(group, comm, "scatter", xs)
    chunk = n_elems // n
    err = _check_result(f"scatter {label}", res,
                        [x_full[r * chunk:(r + 1) * chunk].double() for r in range(n)],
                        1e-6)
    log(f"scatter {label} N={n} {nbytes / 1e6:.0f} MB at the root, codec {codec}, "
        f"fused={fused}: algo={plan.algo} "
        f"pipeline_chunks={plan.pipeline_chunks} wire_bytes={plan.wire_bytes} "
        f"root_chunk_streams={streams} ratio={plan.ratio:.4f} cold wall "
        f"{wall * 1e3:.1f} ms err={err:.3e} launches={_nonzero(launches)}")
    if (plan.algo, plan.pipeline_chunks, streams) != ("binomial", 1, n - 1):
        raise AssertionError(f"scatter plan {plan.algo}/{plan.pipeline_chunks} with "
                             f"{streams} root streams")
    _check_launches(plan, n, launches)
    if fused_run is not None:
        mism = _bitwise_mismatches(res, fused_run[1])
        log(f"scatter {label}: vs the earlier run on the same input, mismatches={mism}")
        if mism:
            raise AssertionError(f"scatter {label}: differs from the earlier run in {mism}")
    if profile:
        _profile(group, comm.scatter, xs, plan)
        rows = ops.n_blocks_for(chunk)
        x2d = ops.to_blocks(x_full[:chunk])
        codes, bw, _ = lorenzo.quantize(x2d, ops.as_eb(EB, device))
        cap = plan.capacity_words
        ms = _median_ms(lambda: bitpack.pack(codes, bw, cap), 5)
        log(f"bitpack.pack (torch ops) at one chunk ({rows} rows, cap {cap}): {ms:.3f} ms "
            f"median; x {n} chunks = {n * ms:.2f} ms per scatter")
        if not fused:  # the two-pass decode's unpack, once per rank
            packed = bitpack.pack(codes, bw, cap)[0]
            ms = _median_ms(lambda: bitpack.unpack(packed, bw, ops.BLOCK), 5)
            log(f"bitpack.unpack (torch ops) at one chunk: {ms:.3f} ms median, once per rank")
    del xs, junk
    torch.cuda.empty_cache()
    return plan, launches, wall, (x_full, res)


def _movement_references(op, xs, n):
    """Per-rank f64 reference outputs of a data-movement op."""
    import torch

    chunk = xs[0].shape[0] // n
    if op == "broadcast":
        return [xs[0].double()] * n
    if op == "allgather":
        return [torch.cat(xs).double()] * n
    if op == "reduce_scatter":
        exact = sum(x.double() for x in xs)
        return [exact[r * chunk:(r + 1) * chunk] for r in range(n)]
    return [torch.cat([x[r * chunk:(r + 1) * chunk] for x in xs]).double()
            for r in range(n)]


def run_movers(device, gen):
    """broadcast, allgather (P = 1, 2), reduce_scatter (P = 1, 2) and
    all_to_all at 16 MB per rank over 8 ranks: error bound and launch
    counts, then bitwise equal to the same call through the plain
    versions."""
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, MOVER_BYTES // 4
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
    group = transport.ThreadGroup(n, device)
    for op, chunks in (("broadcast", 1), ("allgather", 1), ("allgather", 2),
                       ("reduce_scatter", 1), ("reduce_scatter", 2), ("all_to_all", 1)):
        comm = GZCommunicator("x", config=GZConfig(pipeline_chunks=chunks), axis_size=n,
                              device=device)
        plan = comm.plan(op, (n_elems,))
        res, launches, wall = _run(group, comm, op, xs)
        err = _check_result(op, res, _movement_references(op, xs, n), 1e-6)
        _check_launches(plan, n, launches)
        with _plain_kernels():
            plain = group.run(getattr(comm, op), xs, axis_name="x")
        torch.cuda.synchronize()
        mism = _bitwise_mismatches(res, plain)
        log(f"{op} {MOVER_BYTES / 1e6:.0f} MB/rank N={n} P={plan.pipeline_chunks}: algo={plan.algo} "
            f"wire_bytes={plan.wire_bytes} cold wall {wall * 1e3:.1f} ms err={err:.3e} "
            f"launches={_nonzero(launches)} kernels vs plain mismatches={mism}")
        if mism:
            raise AssertionError(f"{op}: kernel path differs from the plain path in {mism}")
        del res, plain
    torch.cuda.empty_cache()


def run_two_pass(device, gen):
    """16 MB x 8 allreduces with the two-pass codec (redoub, ring/2) and
    the two-kernel hop (ring/2): launch counts, and bitwise equal to the
    fused run on the same inputs.  Returns each variant's launches."""
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, MOVER_BYTES // 4
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
    exact = sum(x.double() for x in xs)
    group = transport.ThreadGroup(n, device)
    out = {}
    for base, variants in (({"algo": "redoub"}, ({"fused": False},)),
                           ({"algo": "ring", "pipeline_chunks": 2},
                            ({"fused": False}, {"fused_hop": False}))):
        fused = group.run(GZCommunicator("x", config=GZConfig(**base), axis_size=n,
                                         device=device).allreduce, xs, axis_name="x")
        for v in variants:
            comm = GZCommunicator("x", config=GZConfig(**base, **v), axis_size=n,
                                  device=device)
            plan = comm.plan("allreduce", (n_elems,))
            res, launches, wall = _run(group, comm, "allreduce", xs)
            label = f"{plan.algo}/{plan.pipeline_chunks} {v}"
            err = _check_result(label, res, [exact] * n, 1e-6)
            _check_launches(plan, n, launches)
            mism = _bitwise_mismatches(res, fused)
            log(f"two-pass allreduce {MOVER_BYTES / 1e6:.0f} MB/rank N={n} {label}: cold wall "
                f"{wall * 1e3:.1f} ms err={err:.3e} launches={_nonzero(launches)} "
                f"vs fused run mismatches={mism}")
            if mism:
                raise AssertionError(f"{label}: differs from the fused run in {mism}")
            out[(plan.algo, tuple(sorted(v)))] = launches
            del res
        del fused
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 8-12: the entropy kernels, the codec registry, the gradient sync
# ---------------------------------------------------------------------------

BUCKET_BYTES = 16 * 1024 * 1024  # SyncConfig's default bucket: 16,384 blocks
# One decoder layer of minitron-8b (src/repro/configs/minitron_8b.py: d_model
# 4096, 32 heads, 8 KV heads, head dim 128, d_ff 16384), in the JAX block's
# parameter names (src/repro/models/blocks.py): 243,277,824 f32 per rank.
MINITRON_LAYER = {
    "attn": {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
             "wo": (4096, 4096)},
    "ln1": (4096,),
    "ln2": (4096,),
    "mlp": {"wi": (4096, 16384), "wg": (4096, 16384), "wo": (16384, 4096)},
}
GRAD_SYNC_ELEMS = 243_277_824


def _random_bits(n, gen, device):
    """Full-range f32 bit patterns (NaN and Inf payloads included)."""
    import torch

    return torch.randint(-2**31, 2**31, (n,), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32).view(torch.float32)


def _entropy_bytes(name, nb, words, cap):
    """Bytes an entropy kernel must move: inputs once, outputs once; a
    received stream only to its true length, a packed one to its capacity
    (the words past the total are zeroed)."""
    n, meta = nb * 256, 8 * nb  # desc + anchor
    if name == "entropy_quantize_pack":
        return 4 * n + 4 * cap + meta + 4
    if name == "entropy_unpack_dequantize":
        return 4 * words + meta + 4 * n
    return 4 * words + meta + 8 * n  # + acc in


def _entropy_calls(stream, x2d, acc, eb, cap):
    """Kernels 8-10's (wrapper name, arguments) on one input and stream."""
    return {ENTROPY_KERNELS[0]: ("quantize_pack", (x2d, eb, cap)),
            ENTROPY_KERNELS[1]: ("unpack_dequantize", (*stream, eb)),
            ENTROPY_KERNELS[2]: ("unpack_dequantize_reduce", (*stream, eb, acc))}


def _time_entropy(tag, stream, x2d, acc, eb, cap, words, errs, lossless):
    """Kernels 8-10's records at one shape: median ms of 10 back-to-back
    calls per event pair (``ms``) and of one call per pair
    (``one_call_ms``, the host's launch included), the plain version's,
    and the bytes bound."""
    from repro_torch.kernels import entropy

    records, nb = {}, x2d.shape[0]
    for name, (fn, args) in _entropy_calls(stream, x2d, acc, eb, cap).items():
        kern, plain = getattr(entropy, fn), getattr(entropy, f"{fn}_plain")
        nbytes = _entropy_bytes(name, nb, words, cap)
        rec = records[name] = {
            "name": name, "route": "cuda", "source": ENTROPY_SOURCE,
            "replaces": REPLACES[name], "launches": None, "max_abs_err": errs[name],
            "ms": _median_ms(lambda: kern(*args, lossless=lossless), 20, 10),
            "one_call_ms": _median_ms(lambda: kern(*args, lossless=lossless), 20),
            "device_ms": _device_ms(lambda: kern(*args, lossless=lossless)),
            "plain_ms": _median_ms(lambda: plain(*args, lossless=lossless),
                                   1 if nb > 100_000 else 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "shape": [nb, 256], "bytes": nbytes,
        }
        _log_time(rec, tag)
    return records


def _tile_caps(words, tile):
    """Capacities that end a stream of per-block word counts ``words``
    exactly at the end of look-back tile ``tile`` and inside it (in its
    first non-empty block)."""
    from repro_torch.kernels import lookback

    r = lookback.TILE_BLOCKS
    first = next(w for w in words[tile * r:] if w)
    return {"cap on a tile boundary": sum(words[: (tile + 1) * r]),
            "cap inside a tile": sum(words[: tile * r]) + first // 2 + 1}


def _entropy_words(desc):
    from repro_torch.core import entropy as ent

    return (ent.split_desc(desc).long().sum(dim=1) * ent.SUB_WORDS_PER_BIT).tolist()


def _entropy_case(label, x2d, acc, eb, cap, lossless):
    """Kernels 8-10 against their plain versions on one input: stream
    words [:cap], desc, anchor, the total and both f32 outputs bitwise.
    Returns (each kernel's max |err|, the kernel's stream, total words)."""
    import torch

    from repro_torch.core import entropy as ent
    from repro_torch.kernels import entropy

    mode = "lossless" if lossless else "lossy"
    got = entropy.quantize_pack(x2d, eb, cap, lossless=lossless)
    want = entropy.quantize_pack_plain(x2d, eb, cap, lossless=lossless)
    torch.cuda.synchronize()
    errs = {ENTROPY_KERNELS[0]: _compare(f"entropy quantize_pack [{label} {mode}]", got, want)}
    words = int(got[3])
    if words != int(ent.packed_words(got[1])):
        raise AssertionError(f"{label} {mode}: total {words} != packed_words(desc)")
    calls = _entropy_calls(got[:3], x2d, acc, eb, cap)
    for name in ENTROPY_KERNELS[1:]:
        fn, args = calls[name]
        out = getattr(entropy, fn)(*args, lossless=lossless)
        errs[name] = _compare(f"entropy {fn} [{label} {mode}]", (out,),
                              (getattr(entropy, f"{fn}_plain")(*args, lossless=lossless),))
        if lossless and fn == "unpack_dequantize" and words <= cap:
            if not torch.equal(out.view(torch.int32), x2d.view(torch.int32)):
                raise AssertionError(f"{label}: lossless round trip is not exact")
        del out
    log(f"entropy kernels vs plain [{label} {mode}, {x2d.shape[0]} rows, cap {cap}, "
        f"{words} words]: mismatches 0 in stream/desc/anchor/total and both f32 outputs")
    return errs, got[:3], words


def _check_entropy_edges(device, gen, eb):
    """The look-back's edges beyond the data cases: capacities on and
    inside a tile, a part-full last tile (the unpack kernels take any
    block count; quantize_pack's is a multiple of the tile), and 50
    back-to-back calls of each kernel on one scratch, each compared."""
    import torch

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import entropy, ops

    nb5 = 5 * entropy.TILE_BLOCKS
    x2d = ops.to_blocks(_random_walk(nb5 * 256, gen, device))
    acc = _random_walk(nb5 * 256, gen, device).view(nb5, 256)
    for lossless in (False, True):
        packed, desc, anchor, _ = entropy.quantize_pack_plain(x2d, eb, nb5 * 256,
                                                              lossless=lossless)
        for label, cap in _tile_caps(_entropy_words(desc), 3).items():
            if not _entropy_case(label, x2d, acc, eb, cap, lossless)[2] > cap:
                raise AssertionError(f"{label}: the stream does not overflow")
        for nb in (45, 13, 1):
            for fn, extra in (("unpack_dequantize", ()),
                              ("unpack_dequantize_reduce", (acc[:nb],))):
                args = (packed, desc[:nb], anchor[:nb], eb, *extra)
                _compare(f"entropy {fn} [{nb} rows, part-full tile]",
                         (getattr(entropy, fn)(*args, lossless=lossless),),
                         (getattr(entropy, f"{fn}_plain")(*args, lossless=lossless),))
        log(f"entropy unpack kernels vs plain [45, 13 and 1 rows: a part-full last tile, "
            f"{'lossless' if lossless else 'lossy'}]: mismatches 0")

    n = BUCKET_BYTES // 4
    x2d = ops.to_blocks(_random_walk(n, gen, device))
    acc = _random_walk(n, gen, device).view(-1, 256)
    cap = capacity_words_for(n, 0.6, 256)
    want = entropy.quantize_pack_plain(x2d, eb, cap)
    calls = _entropy_calls(want[:3], x2d, acc, eb, cap)
    wants = {name: want if name == ENTROPY_KERNELS[0] else
             (getattr(entropy, f"{fn}_plain")(*args),) for name, (fn, args) in calls.items()}
    outs = [{name: getattr(entropy, fn)(*args) for name, (fn, args) in calls.items()}
            for _ in range(50)]
    for i, out in enumerate(outs):
        for name, got in out.items():
            _compare(f"{name} [back-to-back call {i}]",
                     got if isinstance(got, tuple) else (got,), wants[name])
    log("entropy kernels vs plain [50 back-to-back calls of each at the 16 MiB bucket, "
        "one scratch]: mismatches 0")
    del outs, wants
    torch.cuda.empty_cache()


def _check_entropy_launch_structure(rows, calls, label, dropped=0.0):
    """Kernel 8 is one look-back launch and one tail launch per call,
    kernels 9 and 10 one launch each, and nothing else runs.  Over
    a long traced window the profiler can lose a few device events (it
    kept 1,392 of 1,416 in a traced gradient sync on the H100), never add
    any: ``dropped`` is the share of launches it may miss."""
    want = {"ent_pack_lookback_kernel": calls["quantize_pack"],
            "ent_zero_tail_kernel": calls["quantize_pack"],
            "ent_unpack_lookback_kernel": calls["unpack_dequantize"]
            + calls["unpack_dequantize_reduce"]}
    got = dict.fromkeys(want, 0)
    for sym, (count, _) in rows.items():
        base = sym.split("<")[0]
        got[base] = got.get(base, 0) + count
    _check_counts(got, want, dropped, f"{label}: entropy kernel launches")


def check_entropy_kernels(device, gen):
    """Kernels 8-10 against their plain versions, bitwise, lossy and
    lossless, on ragged, zero-width, non-finite and overflowing inputs and
    the look-back's edges (one tile, an all-zero stream, full-width random
    bits at 646 MB, then ``_check_entropy_edges``); the launches each call
    makes, from the profiler; median ms at the 16 MiB bucket and the 646 MB
    payload."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.core.compressor import lossless_capacity_words
    from repro_torch.kernels import entropy, ops

    eb = torch.full((), EB, dtype=torch.float32, device=device)

    def zero_blocks(n):
        x = _random_walk(n, gen, device)
        x[256:768] = 0.0
        x[1024 + 64:1024 + 128] = x[1024 + 63]
        return x

    cases = [  # (label, x, capacity factor or None = lossless structural, timed)
        ("ragged n=37", _random_walk(37, gen, device), 0.6, False),
        ("one part-full tile n=2048", _random_walk(2048, gen, device), 0.6, False),
        ("one tile n=8192", _random_walk(8192, gen, device), 0.6, False),
        ("ragged n=6149", _random_walk(2048 * 3 + 5, gen, device), 0.6, False),
        ("ragged n=2504", _random_walk(256 * 9 + 200, gen, device), 2.0, False),
        ("zero blocks", zero_blocks(4096), 0.6, False),
        ("all zero", torch.zeros(64 * 256, device=device), 0.6, False),
        ("nan/inf/saturating", _wild(300_000, gen, device), 2.0, False),
        ("random bits", _random_bits(300_000, gen, device), 2.0, False),
        ("overflow", _random_bits(300_000, gen, device), 0.05, False),
        ("16 MiB bucket", _random_walk(BUCKET_BYTES // 4, gen, device), 0.6, True),
        ("646 MB", _random_walk(MAIN_BYTES // 4, gen, device), 0.6, True),
        ("646 MB random bits", _random_bits(MAIN_BYTES // 4, gen, device), 2.0, False),
    ]
    records = {}
    for label, x, cf, timed in cases:
        n = x.numel()
        x2d = ops.to_blocks(x)
        nb = x2d.shape[0]
        acc = _random_walk(nb * 256, gen, device).view(nb, 256)
        for lossless in (False, True):
            cap = (lossless_capacity_words(n) if lossless and cf != 0.05
                   else capacity_words_for(n, cf, 256))
            errs, stream, words = _entropy_case(label, x2d, acc, eb, cap, lossless)
            if (words > cap) != (cf == 0.05):
                raise AssertionError(f"{label}: {words} words for capacity {cap}")
            if label == "all zero" and words:
                raise AssertionError(f"all-zero input packed to {words} words")
            if label == "646 MB random bits" and lossless and not cap - 256 < words <= cap:
                raise AssertionError(f"full-width stream: {words} words, capacity {cap}")
            if label == "16 MiB bucket":  # launches per call, from the profiler
                calls = _entropy_calls(stream, x2d, acc, eb, cap)
                entropy.reset_launch_counts()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for fn, args in calls.values():
                        for _ in range(3):
                            getattr(entropy, fn)(*args, lossless=lossless)
                    torch.cuda.synchronize()
                rows = _kernel_launches(_device_events(prof), ENTROPY_SYMBOLS)
                _check_entropy_launch_structure(rows, entropy.LAUNCHES, label)
                log(f"entropy kernel launches for 3 calls of each ({label}): {rows}")
                del prof
            if timed:
                recs = _time_entropy(f"{label} {'lossless' if lossless else 'lossy'}",
                                     stream, x2d, acc, eb, cap, words, errs, lossless)
                if label == "16 MiB bucket" and not lossless:
                    records.update(recs)  # the main path's shape and mode
            del stream
        del x, x2d, acc
        torch.cuda.empty_cache()
    _check_entropy_edges(device, gen, eb)
    return records


def run_entropy_allreduce(device, gen):
    """The 646 MB x 8 allreduce under ``lorenzo+entropy``, then ``lorenzo``
    on the same inputs: plans, cold and warm walls, error, exact launch
    counts, provisioned wire bytes and true stream bytes."""
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, MAIN_BYTES // 4
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
    exact = sum(x.double() for x in xs)
    group = transport.ThreadGroup(n, device)
    out = {}
    for codec in ("lorenzo+entropy", "lorenzo"):
        comm = GZCommunicator("x", config=GZConfig(codec=codec), axis_size=n,
                              device=device)
        plan = comm.plan("allreduce", (n_elems,))
        res, launches, cold = _run(group, comm, "allreduce", xs)
        err = _check_result(f"allreduce {codec}", res, [exact] * n, 1e-6)
        _check_launches(plan, n, launches)
        del res
        _, _, warm = _run(group, comm, "allreduce", xs)
        c = plan.as_config().compressor().compress(xs[0], plan.eb_stage)
        true_bytes = int(c.payload_bytes())
        del c
        log(f"allreduce {MAIN_BYTES / 1e6:.0f} MB/rank N={n} codec {codec}: "
            f"algo={plan.algo} pipeline_chunks={plan.pipeline_chunks} "
            f"fused_hop={plan.fused_hop} notes={list(plan.notes)} "
            f"provisioned wire_bytes/rank={plan.wire_bytes} ratio={plan.ratio:.4f}; "
            f"true stream bytes of rank 0's payload compressed once at eb_stage "
            f"{plan.eb_stage:.3e}: {true_bytes} ({n_elems * 4 / true_bytes:.3f}x); "
            f"cold wall {cold * 1e3:.1f} ms, warm wall {warm * 1e3:.1f} ms, "
            f"err={err:.3e} launches={_nonzero(launches)}")
        out[codec] = (plan, launches, warm, true_bytes)
    if out["lorenzo+entropy"][0].wire_bytes != out["lorenzo"][0].wire_bytes:
        raise AssertionError("entropy and dense plans provision different wire bytes")
    if not out["lorenzo+entropy"][3] < out["lorenzo"][3]:
        raise AssertionError("the entropy stream is not shorter than the dense one")
    del xs, exact
    torch.cuda.empty_cache()
    return out


def _sync_for(codec, bucket_bytes=None):
    """The gradient sync's config: redoub, relative eb 1e-4, ``codec``,
    16 MiB buckets unless ``bucket_bytes`` is given."""
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.grad_sync import SyncConfig

    return SyncConfig(gz=GZConfig(eb=1e-4, algo="redoub", worst_case_budget=False,
                                  codec=codec), bucket_bytes=bucket_bytes or BUCKET_BYTES)


def _layer_grads(n, gen, device, shrink=1):
    """n per-rank gradient trees of the minitron-8b layer: seeded random
    walks, 1e-3 steps; ``shrink`` divides every leading dimension."""
    def leaf(shape):
        shape = (shape[0] // shrink,) + tuple(shape[1:])
        return (_random_walk(math.prod(shape), gen, device) * 1e-3).view(shape)

    def tree(spec):
        if isinstance(spec, dict):
            return {k: tree(v) for k, v in spec.items()}
        return leaf(spec)

    return [tree(MINITRON_LAYER) for _ in range(n)]


def _flat_leaves(tree):
    from repro_torch.core import grad_sync

    return grad_sync.tree_flatten(tree)[0]


def _sync_once(group, trees, sync, device):
    """One ``dp_allreduce_grads_stats`` on every rank, launch counts from
    0.  Returns (results, launches, wall seconds)."""
    import torch

    from repro_torch.core import grad_sync

    def body(tree):
        return grad_sync.dp_allreduce_grads_stats(tree, ("x",), sync, device=device)

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res = group.run(body, trees, axis_name="x")
    torch.cuda.synchronize()
    return res, _launches(), time.perf_counter() - t0


def _traced_sync(group, trees, sync, device, label, check):
    """``_sync_once`` under torch.profiler, its launch structure held by
    ``check(device events, launch counts)``.  A trace of a whole sync can
    lose device events (on the H100 up to 7 % of a sync's launches, in
    stretches at either end or inside; the wrappers' counts, checked
    exactly beside it, were right): a trace whose counts fall short of the
    bound (``ProfileShortfall``), and no more, is logged and taken again,
    at most three times.  Returns (device events, launch counts, traced
    wall seconds, what ``check`` returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res, calls, traced = _sync_once(group, trees, sync, device)
        del res
        events = _device_events(prof)
        try:
            return events, calls, traced, check(events, calls)
        except ProfileShortfall as e:
            log(f"{label}: {e}; taking the trace again")
    raise AssertionError(f"{label}: three traces fell short of the wrappers' launch counts")


def _check_sync(label, trees, res, sync, n, launches, device):
    """Every rank's leaves within sum(per-stage bounds) * scale +
    1e-6 max|exact| of the f64 sum, no flag set, and the launch counts
    exactly the per-bucket schedule times the bucket count."""
    import torch

    from repro_torch.core import buckets, error_budget, grad_sync, transport
    from repro_torch.core.comm import GZCommunicator

    leaves = [grad_sync.tree_flatten(t)[0] for t in trees]
    ledger = buckets.ledger_for([a.shape for a in leaves[0]], sync.bucket_bytes)
    plan = GZCommunicator("x", config=sync.gz, axis_size=n, device=device,
                          auto_depth=True).plan("allreduce", (ledger.bucket_elems,))
    scale = transport.ThreadGroup(n, device).run(
        lambda t: grad_sync._tree_scale([a.reshape(-1) for a in grad_sync.tree_flatten(t)[0]],
                                        transport.current("x")), trees)[0].item()
    hops = error_budget.lossy_hops(f"allreduce_{plan.algo}", n)
    worst, worst_ratio = 0.0, 0.0
    outs = [grad_sync.tree_flatten(out)[0] for out, _ in res]
    for i in range(len(leaves[0])):
        exact = sum(lv[i].double() for lv in leaves)
        bound = hops * plan.eb_stage * scale + 1e-6 * exact.abs().max().item()
        for r in range(n):
            err = (outs[r][i].double() - exact).abs().max().item()
            if not err <= bound:
                raise AssertionError(f"{label}: leaf {i} rank {r} error {err} > bound {bound}")
            worst, worst_ratio = max(worst, err), max(worst_ratio, err / bound)
        del exact
    stats = [st for _, st in res]
    if any(bool(st.overflow) or bool(st.nonfinite) for st in stats):
        raise AssertionError(f"{label}: overflow or non-finite flag set")
    expected = {k: v * ledger.n_buckets for k, v in _expected_launches(plan, n).items()}
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches} != schedule's {expected}")
    return plan, ledger, scale, worst, worst_ratio, stats[0]


def run_grad_sync(device, gen):
    """This slice's main path: ``dp_allreduce_grads_stats`` of one minitron-8b
    decoder layer (243,277,824 f32 per rank) over 8 ranks under
    ``lorenzo+entropy`` with 16 MiB buckets; cold and warm walls, a profiled
    warm run, the host floor (the tree and the buckets at 1/256 size); then
    ``lorenzo``, ``lossless``, ``passthrough`` and ``codec="auto"`` on the
    same inputs, and the N = 6 remainder stage.  Returns the launch counts
    of the N = 8 and N = 6 entropy runs."""
    import torch

    from repro_torch.core import transport

    n = 8
    torch.cuda.reset_peak_memory_stats()
    trees = _layer_grads(n, gen, device)
    total = sum(a.numel() for a in _flat_leaves(trees[0]))
    if total != GRAD_SYNC_ELEMS:
        raise AssertionError(f"layer tree has {total} elements")
    group = transport.ThreadGroup(n, device)
    sync = _sync_for("lorenzo+entropy")
    res, launches, cold = _sync_once(group, trees, sync, device)
    plan, ledger, scale, err, ratio, st = _check_sync(
        "grad sync entropy", trees, res, sync, n, launches, device)
    del res
    log(f"grad sync minitron-8b layer ({total} f32/rank = {total * 4 / 1e6:.0f} MB) "
        f"N={n} codec lorenzo+entropy: {ledger.n_buckets} buckets of {ledger.bucket_elems}; "
        f"plan {plan.algo}/{plan.pipeline_chunks} eb_stage={plan.eb_stage:.3e} "
        f"notes={list(plan.notes)}; scale {scale:.6e}; wire_bytes/rank {st.wire_bytes}; "
        f"cold wall {cold * 1e3:.1f} ms; max err {err:.3e} ({100 * ratio:.1f} % of the "
        f"bound); launches={_nonzero(launches)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    main_launches = launches
    _, _, warm = _sync_once(group, trees, sync, device)
    def entropy_calls(launches):
        return {k[len("entropy_"):]: v for k, v in launches.items() if k in ENTROPY_KERNELS}

    events, calls, traced, _ = _traced_sync(
        group, trees, sync, device, "grad sync entropy",
        lambda ev, launches: _check_entropy_launch_structure(
            _kernel_launches(ev, ENTROPY_SYMBOLS), entropy_calls(launches), "grad sync",
            dropped=0.05))
    calls = entropy_calls(calls)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"grad sync profile: warm wall {warm * 1e3:.1f} ms; traced wall "
        f"{traced * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (traced * 1e3):.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"  {e.count:>6} x {e.self_device_time_total / 1e3:8.2f} ms  {e.key[:160]}")
    rows = _kernel_launches(events, ENTROPY_SYMBOLS)
    for sym, (count, ms) in sorted(rows.items()):
        log(f"  entropy sub-kernel {sym}: {count} launches, {ms:.2f} ms of device time "
            f"({1e3 * ms / max(count, 1):.2f} us each)")
    log(f"  wrapper calls in the profiled sync: {calls}")
    del events
    small = _layer_grads(n, gen, device, shrink=256)
    small_sync = _sync_for("lorenzo+entropy", BUCKET_BYTES // 256)
    walls = [_sync_once(group, small, small_sync, device)[2] for _ in range(3)]
    log(f"grad sync host floor: the same tree and buckets at 1/256 size "
        f"({sum(a.numel() for a in _flat_leaves(small[0]))} f32/rank), warm wall "
        f"{min(walls[1:]) * 1e3:.1f} ms")
    del small

    results = {}
    for codec in ("lorenzo", "lossless", "passthrough", "auto"):
        s = _sync_for(codec)
        res, launches, wall = _sync_once(group, trees, s, device)
        p, _, _, err, ratio, st = _check_sync(f"grad sync {codec}", trees, res, s, n,
                                              launches, device)
        log(f"grad sync N={n} codec {codec}: resolved {p.codec} ({p.algo}/"
            f"{p.pipeline_chunks}) notes={list(p.notes)} wall {wall * 1e3:.1f} ms "
            f"max err {err:.3e} ({100 * ratio:.1f} % of the bound) wire_bytes/rank "
            f"{st.wire_bytes} launches={_nonzero(launches)}")
        if codec in ("lossless", "passthrough"):
            results[codec] = [_flat_leaves(out) for out, _ in res]
        del res
        if codec == "lorenzo":  # kernels 1 and 2 in the default sync, from the profiler
            events, calls, traced, got = _traced_sync(
                group, trees, s, device, "grad sync lorenzo",
                lambda ev, launches: _check_hop_launch_structure(
                    _kernel_launches(ev, LORENZO_SYMBOLS), launches, "grad sync lorenzo",
                    dropped=0.05))
            busy = sum(e.self_device_time_total for e in events) / 1e3
            rows = _kernel_launches(events, LORENZO_SYMBOLS)
            hop = [(c, ms) for k, (c, ms) in rows.items() if k.startswith("hop_lookback")]
            qp_ms = sum(ms for k, (_, ms) in rows.items() if k.startswith("qp_"))
            ud_ms = sum(ms for k, (_, ms) in rows.items() if k.startswith("ud_"))
            log(f"grad sync lorenzo profile: traced wall {traced * 1e3:.1f} ms, device busy "
                f"{busy:.1f} ms; kernel 2: {calls['unpack_reduce_repack']} calls, "
                f"{sum(c for c, _ in hop)} hop_lookback_kernel launches, "
                f"{sum(ms for k, (_, ms) in rows.items() if k.startswith('hop_')):.2f} ms of "
                f"device time with its tail launches; kernel 1: {calls['quantize_pack']} "
                f"calls, {qp_ms:.2f} ms of device time with its tail launches, "
                f"{qp_ms / n:.3f} ms per rank; kernel 3: "
                f"{calls['unpack_dequantize_reduce']} calls, {_ud_summary(rows)}, "
                f"{ud_ms / n:.3f} ms per rank; Lorenzo launches {got}; "
                + "; ".join(f"{k} {c} x {ms:.2f} ms" for k, (c, ms) in sorted(rows.items())))
            del events
    mism = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
               for ra, rb in zip(results["lossless"], results["passthrough"])
               for a, b in zip(ra, rb))
    log(f"grad sync lossless vs passthrough (both exact transports): mismatches {mism}")
    if mism:
        raise AssertionError(f"lossless differs from passthrough in {mism} elements")
    del results

    n6 = 6
    res, launches6, wall = _sync_once(transport.ThreadGroup(n6, device), trees[:n6],
                                      sync, device)
    p, _, _, err, ratio, _ = _check_sync("grad sync entropy N=6", trees[:n6], res, sync,
                                         n6, launches6, device)
    log(f"grad sync N={n6} codec lorenzo+entropy: {p.algo} with the remainder stage, "
        f"wall {wall * 1e3:.1f} ms max err {err:.3e} ({100 * ratio:.1f} % of the bound) "
        f"launches={_nonzero(launches6)}")
    del res, trees
    torch.cuda.empty_cache()
    return main_launches, launches6


def check_a2a_backward_on_threadgroup(device):
    """ROADMAP C6: the ``all_to_all`` backward on a one-card ThreadGroup
    runs on the autograd engine's device thread, where the ranks'
    exchanges cannot meet; it must raise (naming DistGroup) within
    seconds, under a watchdog, and neither hang nor succeed."""
    import torch

    from repro_torch.core import transport
    from repro_torch.core.comm import GZCommunicator

    n = 2
    comm = GZCommunicator("x", axis_size=n, device=device)
    xs = [torch.linspace(0, 1, 4096, device=device) + r for r in range(n)]
    outcome = []

    def body(x):
        x = x.clone().requires_grad_(True)
        comm.all_to_all(x).value.sum().backward()
        return x.grad

    def watched():
        try:
            transport.ThreadGroup(n, device).run(body, xs)
            outcome.append("backward succeeded")
        except RuntimeError as e:
            outcome.append(str(e))

    t0 = time.perf_counter()
    t = threading.Thread(target=watched, daemon=True)
    t.start()
    t.join(timeout=60)
    if t.is_alive():
        log("all_to_all backward on a one-card ThreadGroup: HUNG for 60 s")
        sys.stdout.flush()
        os._exit(1)  # the rank threads cannot be stopped; end the process
    msg = outcome[0]
    log(f"all_to_all backward on a one-card ThreadGroup: raised after "
        f"{time.perf_counter() - t0:.2f} s: {msg[:160]}")
    if "DistGroup" not in msg:
        raise AssertionError(f"all_to_all backward did not raise as expected: {msg}")
    check_fsdp_backward_on_threadgroup(device)


def check_fsdp_backward_on_threadgroup(device):
    """ROADMAP C6 for the FSDP gather: ``fsdp_all_gather`` under grad on a
    one-card ``ThreadMesh((2, 1))``; its backward (the reduce-scatter) runs
    on the autograd engine's device thread and must raise, naming the
    train step's route and DistGroup, within seconds, under a watchdog."""
    import torch

    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.grad_sync import SyncConfig, fsdp_all_gather
    from repro_torch.launch.mesh import ThreadMesh

    n = 2
    sync = SyncConfig(gz=GZConfig(eb=FSDP_EB, algo="ring"), relative_eb=False)
    xs = [torch.linspace(0, 1, 4096, device=device).reshape(64, 64) + r for r in range(n)]
    outcome = []

    def body(x):
        x = x.clone().requires_grad_(True)
        with torch.enable_grad():
            fsdp_all_gather(x, "data", sync).sum().backward()
        return x.grad

    def watched():
        try:
            ThreadMesh((n, 1), ("data", "model"), device).run(body, xs)
            outcome.append("backward succeeded")
        except RuntimeError as e:
            outcome.append(str(e))

    t0 = time.perf_counter()
    t = threading.Thread(target=watched, daemon=True)
    t.start()
    t.join(timeout=60)
    if t.is_alive():
        log("fsdp_all_gather backward on a one-card ThreadMesh: HUNG for 60 s")
        sys.stdout.flush()
        os._exit(1)  # the rank threads cannot be stopped; end the process
    msg = outcome[0]
    log(f"fsdp_all_gather backward on a one-card ThreadMesh: raised after "
        f"{time.perf_counter() - t0:.2f} s: {msg[:200]}")
    if "DistGroup" not in msg or "make_train_step" not in msg:
        raise AssertionError(f"fsdp_all_gather backward did not raise as expected: {msg}")


# ---------------------------------------------------------------------------
# Phase faults: the degradation layer at full size
# ---------------------------------------------------------------------------

FAULTS_SCATTER_NAN = 8  # poisoned positions of the NaN specs
# 57 full buckets of the layer's 243,277,824 f32 (17.07 MB each): under the
# default 16 MiB the 59th bucket holds 1,728 values and zeros, a stream
# that fits any capacity (one word per block at least), so it could not
# overflow.
FALLBACK_BUCKET_BYTES = GRAD_SYNC_ELEMS // 57 * 4


def _fold(parts):
    """Rank-order sum, the lossless fallback's (``transport.sum_across``)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _sanitized(x):
    import torch

    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def _health(op, want, label):
    """The health counters of the one call since the last clear: exactly
    ``want`` = (overflow, nonfinite, fell back) for ``op``."""
    from repro_torch.core import comm

    got = comm.health_stats()
    comm.clear_health_stats()
    o, nf, fb = want
    expect = {(op, "'x'"): {"calls": 1, "overflow": int(o), "nonfinite": int(nf),
                            "fallbacks": int(fb)}}
    if got != expect:
        raise AssertionError(f"{label}: health counters {got} != {expect}")


def _flags(res):
    """(overflow, nonfinite), which must be the same on every rank."""
    pairs = {(bool(r.overflow), bool(r.nonfinite)) for r in res}
    if len(pairs) != 1:
        raise AssertionError(f"ranks disagree on the flags: {pairs}")
    return pairs.pop()


def _equal_to(res, wants, label):
    """Every rank's value bitwise equal to its wanted tensor."""
    import torch

    mism = sum(int((r.value.view(torch.int32) != w.view(torch.int32)).sum())
               for r, w in zip(res, wants))
    if mism:
        raise AssertionError(f"{label}: {mism} elements differ")


def _fault_case(group, comm, op, xs, spec, plan, label, want_flags, wants):
    """One call under ``spec`` (or none): flags, the health counters, the
    compressed pass's exact launches (the lossless re-run launches no
    codec kernel) and, with ``wants``, bitwise values.  Returns (results,
    wall seconds)."""
    from repro_torch.core import faults

    with faults.inject(spec) if spec is not None else contextlib.nullcontext():
        res, launches, wall = _run(group, comm, op, xs)
    flags = _flags(res)
    log(f"faults {label}: flags (overflow, nonfinite) {flags}, wall {wall * 1e3:.1f} ms, "
        f"launches={_nonzero(launches)}")
    if want_flags is not None and flags != want_flags:
        raise AssertionError(f"{label}: flags {flags} != {want_flags}")
    _check_launches(plan, group.size, launches)
    if wants is not None:
        _equal_to(res, wants, label)
    fell_back = comm.config.on_overflow == "fallback" and any(flags)
    _health(op, flags + (fell_back,), label)
    return res, wall


def _checksum_profile(group, comm, xs, label):
    """Device busy time of one call, and the launches and device time of
    the stream checksum's kernels (the concatenation and the XOR fold)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        group.run(comm.allreduce, xs, axis_name="x")
        torch.cuda.synchronize()
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    xor = [e for e in events if "BitwiseXor" in e.key]
    cat = [e for e in events if "CatArrayBatchedCopy" in e.key]
    rows = {k: (sum(e.count for e in ev), sum(e.self_device_time_total for e in ev) / 1e3)
            for k, ev in (("xor", xor), ("cat", cat))}
    log(f"faults {label} profile: device busy {busy:.2f} ms; checksum XOR fold "
        f"{rows['xor'][0]} launches, {rows['xor'][1]:.2f} ms; concatenation "
        f"{rows['cat'][0]} launches, {rows['cat'][1]:.2f} ms")
    return busy, rows


def run_faults(device, gen):
    """The degradation layer on the port's main paths, with their real
    kernels: the 646 MB x 8 allreduce (ring/2) clean under
    ``verify_streams``, an injected overflow, a NaN and wire bitflips
    under ``fallback``, and ``raise``; the 646 MB x 8 scatter with NaN on
    the root and on a non-root; the gradient sync of one minitron-8b
    layer with every bucket overflowing under ``fallback``.  Values are
    checked by bits against the lossless rank-order sum, flags and health
    counters by the event, launches against the schedule; then the clean
    allreduce is timed with and without ``verify_streams`` and the
    fallback beside the compressed call."""
    import numpy as np
    import torch

    from repro_torch.core import buckets, comm as comm_mod, faults, grad_sync, transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, MAIN_BYTES // 4
    group = transport.ThreadGroup(n, device)
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]

    def communicator(**kw):
        return GZCommunicator("x", config=GZConfig(**kw), axis_size=n, device=device)

    flag = communicator()
    plan = flag.plan("allreduce", (n_elems,))
    if (plan.algo, plan.pipeline_chunks) != ("ring", 2):
        raise AssertionError(f"646 MB plan is {plan.algo}/{plan.pipeline_chunks}")
    comm_mod.clear_health_stats()
    comm_mod.enable_health_tracking(True)
    try:
        clean, _ = _fault_case(group, flag, "allreduce", xs, None, plan, "clean, flag",
                               (False, False), None)
        verify = communicator(verify_streams=True)
        _fault_case(group, verify, "allreduce", xs, None, plan, "clean, verify_streams",
                    (False, False), [r.value for r in clean])
        fallback = communicator(on_overflow="fallback")
        spec = faults.FaultSpec("overflow", ranks=(3,))
        noise = torch.from_numpy(faults._overflow_noise((n_elems,), spec)).to(device)
        _fault_case(group, fallback, "allreduce", xs, spec, plan, "overflow on rank 3",
                    (True, False), [_fold(xs[:3] + [noise] + xs[4:])] * n)
        del noise
        spec = faults.FaultSpec("nan", ranks=(5,), n=FAULTS_SCATTER_NAN)
        x5 = xs[5].clone()
        x5[torch.from_numpy(faults._poison_positions(n_elems, spec)).to(device)] = 0.0
        res, _ = _fault_case(group, fallback, "allreduce", xs, spec, plan,
                             "NaN on rank 5", None, [_fold(xs[:5] + [x5] + xs[6:])] * n)
        if not _flags(res)[1]:
            raise AssertionError("NaN on rank 5: the non-finite flag is not set")
        del x5, res
        spec = faults.FaultSpec("bitflip", ranks=(1,), rounds=(1,))
        res, _ = _fault_case(group, flag, "allreduce", xs, spec, plan,
                             "bitflip round 1, unguarded", (False, False), None)
        log(f"faults bitflip round 1, unguarded: {_bitwise_mismatches(res, clean)} elements "
            "differ from the clean run, silently")
        # 64 flips: some land inside the valid stream and corrupt values
        res, _ = _fault_case(group, flag, "allreduce", xs,
                             faults.FaultSpec("bitflip", ranks=(1,), rounds=(1,), n=64), plan,
                             "64 bitflips round 1, unguarded", (False, False), None)
        silent = _bitwise_mismatches(res, clean)
        log(f"faults 64 bitflips round 1, unguarded: {silent} elements differ from the clean "
            "run, no flag")
        if not silent:
            raise AssertionError("64 bitflips corrupted nothing: the hook misses the streams")
        del res
        guarded = communicator(on_overflow="fallback", verify_streams=True)
        _fault_case(group, guarded, "allreduce", xs, spec, plan,
                    "bitflip round 1, verify_streams + fallback", (True, False),
                    [_fold(xs)] * n)
        _fault_case(group, guarded, "allreduce", xs,
                    faults.FaultSpec("bitflip", ranks=(1,), rounds=(10_000,)), plan,
                    "bitflip round 10000, verify_streams + fallback", (False, False),
                    [r.value for r in clean])
        starved = dict(capacity_factor=0.02)  # a forced overflow, no injection
        raising = communicator(on_overflow="raise", **starved)
        messages = group.run(lambda x: _raise_message(raising, x), xs, axis_name="x")
        want = ("gZ collective degraded (allreduce over 'x'): overflow=True nonfinite=False"
                " — a compressed stream exceeded its provisioned capacity (or failed "
                "verification) or the input held NaN/Inf.  Use on_overflow='fallback' for "
                "in-trace lossless recovery, or 'flag' to only report.")
        if messages != [want] * n:
            raise AssertionError(f"raise policy: {messages[0]!r} on some rank, want {want!r}")
        _health("allreduce", (True, False, False), "raise on a forced overflow")
        _fault_case(group, communicator(on_overflow="raise"), "allreduce", xs, None, plan,
                    "clean, raise", (False, False), [r.value for r in clean])
        log(f"faults raise policy: every rank raised the reference's message: {want[:60]}...")
        del clean

        # Timing: the clean call with and without verify_streams, in turns,
        # and the fallback of a forced overflow beside its compressed call,
        # with the health counters (a host sync a call) off.
        comm_mod.enable_health_tracking(False)
        starved_flag = communicator(**starved)
        starved_fb = communicator(on_overflow="fallback", **starved)
        walls = {}
        for name, c in (("flag", flag), ("verify", verify), ("verify", verify),
                        ("flag", flag), ("flag", flag), ("verify", verify),
                        ("starved flag", starved_flag), ("starved fallback", starved_fb),
                        ("starved fallback", starved_fb), ("starved flag", starved_flag)):
            walls.setdefault(name, []).append(_run(group, c, "allreduce", xs)[2])
        for name, w in walls.items():
            log(f"faults timing 646 MB x 8 allreduce, {name}: warm walls "
                + ", ".join(f"{v * 1e3:.1f}" for v in w) + f" ms; min {min(w) * 1e3:.1f} ms")
        busy_flag, _ = _checksum_profile(group, flag, xs, "clean, flag")
        busy_verify, rows = _checksum_profile(group, verify, xs, "clean, verify_streams")
        comm_mod.enable_health_tracking(True)
        log(f"faults verify_streams overhead at 646 MB x 8: warm wall "
            f"{min(walls['verify']) * 1e3:.1f} vs {min(walls['flag']) * 1e3:.1f} ms "
            f"(+{(min(walls['verify']) / min(walls['flag']) - 1) * 100:.1f} %); device busy "
            f"{busy_verify:.2f} vs {busy_flag:.2f} ms; checksum kernels "
            f"{rows['xor'][0] + rows['cat'][0]} launches, "
            f"{rows['xor'][1] + rows['cat'][1]:.2f} ms; fallback wall "
            f"{min(walls['starved fallback']) * 1e3:.1f} ms beside the compressed call's "
            f"{min(walls['starved flag']) * 1e3:.1f} ms")
        del xs
        torch.cuda.empty_cache()

        # The scatter: NaN on the root recovers the sanitized lossless
        # scatter; NaN on a non-root does not trip the guard.
        x_full = _random_walk(n_elems // n * n, gen, device)
        chunk = x_full.shape[0] // n
        junk = torch.full_like(x_full, float("nan"))
        sx = [x_full] + [junk] * (n - 1)
        sc = communicator(on_overflow="fallback")
        splan = sc.plan("scatter", x_full.shape)
        clean, _ = _fault_case(group, communicator(), "scatter", sx, None, splan,
                               "scatter clean, flag", (False, False), None)
        _fault_case(group, sc, "scatter", sx, faults.FaultSpec("nan", ranks=(3,), n=8), splan,
                    "scatter NaN on rank 3 (non-root)", (False, False),
                    [r.value for r in clean])
        spec = faults.FaultSpec("nan", ranks=(0,), n=FAULTS_SCATTER_NAN)
        root = x_full.clone()
        root[torch.from_numpy(faults._poison_positions(root.numel(), spec)).to(device)] = 0.0
        res, _ = _fault_case(group, sc, "scatter", sx, spec, splan, "scatter NaN on the root",
                             None, [root[r * chunk:(r + 1) * chunk] for r in range(n)])
        if not _flags(res)[1]:
            raise AssertionError("scatter NaN on the root: the non-finite flag is not set")
        del x_full, junk, sx, clean, root, res
        torch.cuda.empty_cache()

        # The gradient sync: every bucket overflows and falls back.
        trees = _layer_grads(n, gen, device)
        sync = grad_sync.SyncConfig(
            gz=GZConfig(eb=1e-9, algo="redoub", worst_case_budget=False,
                        codec="lorenzo+entropy", capacity_factor=0.05,
                        on_overflow="fallback"),
            relative_eb=False, bucket_bytes=FALLBACK_BUCKET_BYTES)
        res, launches, wall = _sync_once(group, trees, sync, device)
        leaves = [_flat_leaves(t) for t in trees]
        ledger = buckets.ledger_for([a.shape for a in leaves[0]], sync.bucket_bytes)
        gplan = GZCommunicator("x", config=sync.gz, axis_size=n, device=device,
                               auto_depth=True).plan("allreduce", (ledger.bucket_elems,))
        expected = {k: v * ledger.n_buckets for k, v in _expected_launches(gplan, n).items()}
        if launches != expected:
            raise AssertionError(f"grad sync fallback: launches {launches} != {expected}")
        mism = 0
        outs = [_flat_leaves(out) for out, _ in res]
        for i in range(len(leaves[0])):
            want = _fold([lv[i] for lv in leaves])
            mism += sum(int((o[i].view(torch.int32) != want.view(torch.int32)).sum())
                        for o in outs)
        stats = {(bool(st.overflow), bool(st.nonfinite)) for _, st in res}
        health = comm_mod.health_stats()
        comm_mod.clear_health_stats()
        want_health = {("allreduce", "'x'"): {"calls": ledger.n_buckets,
                                              "overflow": ledger.n_buckets, "nonfinite": 0,
                                              "fallbacks": ledger.n_buckets}}
        log(f"faults grad sync minitron-8b layer N={n}, lorenzo+entropy at eb 1e-9, capacity "
            f"0.05, fallback: {ledger.n_buckets} buckets, wall {wall * 1e3:.1f} ms, "
            f"mismatches vs the lossless sum {mism}, stats {stats}, health {health}, "
            f"launches={_nonzero(launches)}")
        if mism or stats != {(True, False)} or health != want_health:
            raise AssertionError("grad sync fallback: values, flags or health counters wrong")
        del trees, res, outs, leaves
        torch.cuda.empty_cache()
    finally:
        comm_mod.enable_health_tracking(False)
        comm_mod.clear_health_stats()


def _raise_message(comm, x):
    """A rank's ``allreduce`` under the ``raise`` policy: the message it
    raised, or None."""
    try:
        comm.allreduce(x)
    except RuntimeError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Phase hier: the integer ring and the two-level node x local allreduce
# ---------------------------------------------------------------------------

HIER_AXES = ("node", "local")
# Device-event groups of the intring call's profile: kernel 5 and the
# torch ops around it (bitpack's pack and unpack, the final prefix sum).
INTRING_ROWS = (("kernel 5 (quantize_front_kernel)", r"quantize_front_kernel"),
                ("pack scatter-add (index_add_)", r"index_add|indexFunc"),
                ("unpack gathers (indexing)", r"index_elementwise|gather|index_kernel"),
                ("prefix sum (cumsum)", r"scan|cumsum"),
                ("reductions (amax)", r"reduce_kernel"),
                ("copies and fills", r"copy|fill|Memcpy|Memset|CatArray"),
                ("elementwise (shifts, xor, casts, adds)", r""))


def _mesh_call(m, fn, xs):
    """One call of ``fn`` on every rank of mesh ``m``, launch counts from
    0.  Returns (results, launches, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res = m.run(fn, xs)
    torch.cuda.synchronize()
    return res, _launches(), time.perf_counter() - t0


def _mesh_profile(m, fn, xs, label, check=None):
    """Warm wall of ``fn`` on mesh ``m`` (the second of two calls), then
    one call under torch.profiler: device busy and the top device rows.
    ``check(events, launches)`` holds the trace's launch structure; a
    trace that falls short of it (``ProfileShortfall``: the profiler lost
    device events) is taken again, at most three times.  Returns (warm
    wall seconds, device busy ms, device events)."""
    from torch.profiler import ProfilerActivity, profile

    _mesh_call(m, fn, xs)
    _, _, warm = _mesh_call(m, fn, xs)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res, launches, traced = _mesh_call(m, fn, xs)
        del res
        events = _device_events(prof)
        try:
            if check is not None:
                check(events, launches)
            break
        except ProfileShortfall as e:
            log(f"{label}: {e}; taking the trace again")
    else:
        raise AssertionError(f"{label}: three traces fell short of the wrappers' counts")
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"{label} profile: warm wall {warm * 1e3:.1f} ms; traced wall {traced * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.count:>6} x {e.self_device_time_total / 1e3:8.2f} ms  {e.key[:120]}")
    return warm, busy, events


def _check_intring_launch_structure(events, launches):
    """Every ``quantize`` call is one ``quantize_front_kernel`` launch and
    the intring call launches no other kernel of the port."""
    rows = _kernel_launches(events, LORENZO_SYMBOLS + "|" + ENTROPY_SYMBOLS)
    _check_hop_launch_structure(rows, launches, "intring", dropped=0.05)


def _intring_rows(events):
    """Device ms and launches of the intring call by ``INTRING_ROWS`` group."""
    out = {name: [0, 0.0] for name, _ in INTRING_ROWS}
    for e in events:
        for name, pattern in INTRING_ROWS:
            if re.search(pattern, e.key):
                out[name][0] += e.count
                out[name][1] += e.self_device_time_total / 1e3
                break
    return out


def _sum_exact(xs):
    exact = None
    for x in xs:
        exact = x.double() if exact is None else exact.add_(x.double())
    return exact


def _within(label, res, exact, bound):
    """Every rank's value within ``bound`` of ``exact``, no flag set.
    Returns the largest error."""
    err = max((r.value.double() - exact).abs().max().item() for r in res)
    if not err <= bound:
        raise AssertionError(f"{label}: error {err} exceeds the bound {bound}")
    if any(bool(r.overflow) or bool(r.nonfinite) for r in res):
        raise AssertionError(f"{label}: overflow or non-finite flag set")
    return err


def _hier_launches(hplan):
    """The hier call's kernel launches over all ranks: the inter plan's
    schedule over ``n_nodes`` ranks, once per local index (the intra
    stages are exact torch folds and copies)."""
    n_nodes, L = hplan.topology
    return {k: v * L for k, v in _expected_launches(hplan.inter, n_nodes).items()}


def run_hier(device):
    """The integer ring and the two-level allreduce, through the port's
    entry points on the card: ``GZCommunicator(algo="intring")`` at 646 MB
    x 8 (every rank the same bits, within N 1.05 eb, kernel 5 once a
    rank; profiled, host floor) and at 16 MB x 8 (bitwise the port's CPU
    run; ``policy="accuracy"``); ``GZHierCommunicator`` on a 2x4
    ``make_hier_mesh`` at 646 MB (hierarchical at ``A100_SLINGSHOT``,
    beside the flat 8-rank composite call), 4x2 at 16 MB, 2x4 at 16 MB on
    a flat fabric (bitwise the 8-rank ``GZCommunicator``), the hier
    fallback of a forced overflow at 646 MB; the gradient sync of one
    minitron-8b layer over ``("local", "node")`` 2x4.  Returns kernel 5's
    launches in the 646 MB intring call."""
    import torch

    from repro_torch.core import buckets, cost_model, error_budget, grad_sync, transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator, GZHierCommunicator
    from repro_torch.launch.mesh import ThreadMesh, make_hier_mesh

    n, n_elems = 8, MAIN_BYTES // 4
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
    exact = _sum_exact(xs)
    top = exact.abs().max().item()
    ring = ThreadMesh((n,), ("x",), device)

    # intring at 646 MB x 8
    intring = GZCommunicator("x", config=GZConfig(algo="intring"), axis_size=n, device=device)
    plan = intring.plan("allreduce", (n_elems,))
    torch.cuda.reset_peak_memory_stats()
    res, launches, cold = _mesh_call(ring, intring.allreduce, xs)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check_launches(plan, n, launches)
    if _nonzero(launches) != {"quantize": n}:
        raise AssertionError(f"intring launched {_nonzero(launches)}, expected quantize x {n}")
    spread = sum(int((r.value.view(torch.int32) != res[0].value.view(torch.int32)).sum())
                 for r in res)
    bound = n * 1.05 * EB + 1e-6 * top
    err = _within("intring 646 MB", res, exact, bound)
    log(f"intring N={n} {MAIN_BYTES / 1e6:.0f} MB/rank: plan {plan.algo} wire_bytes "
        f"{plan.wire_bytes} ratio {plan.ratio:.4f} capacity {plan.capacity_words} words; "
        f"cold wall {cold * 1e3:.1f} ms; err {err:.3e} (bound N 1.05 eb + 1e-6 max = "
        f"{bound:.3e}); ranks differing from rank 0 in {spread} elements; launches "
        f"{_nonzero(launches)}; peak memory {peak:.1f} GB")
    if spread:
        raise AssertionError(f"intring ranks differ in {spread} elements")
    del res
    k5_launches = launches["quantize"]
    warm, busy, events = _mesh_profile(ring, intring.allreduce, xs, "intring 646 MB",
                                       _check_intring_launch_structure)
    rows = _intring_rows(events)
    log("intring device time by group: " + "; ".join(
        f"{name} {c} launches {ms:.2f} ms ({100 * ms / max(busy, 1e-9):.1f} %)"
        for name, (c, ms) in rows.items()))
    small = GZCommunicator("x", config=plan.as_config(), axis_size=n, device=device)
    tiny = [x[: 1 << 16].clone() for x in xs]
    walls = [_mesh_call(ring, small.allreduce, tiny)[2] for _ in range(3)]
    log(f"intring host floor: 256 KB/rank, N={n}: warm wall {min(walls[1:]) * 1e3:.1f} ms "
        f"against {warm * 1e3:.1f} ms at 646 MB")
    del tiny

    # intring at 16 MB x 8: the card against the port's CPU run; the accuracy policy
    m_elems = MOVER_BYTES // 4
    xs16 = [_random_walk(m_elems, gen, device) for _ in range(n)]
    exact16 = _sum_exact(xs16)
    card, _, _ = _mesh_call(ring, intring.allreduce, xs16)
    cpu_comm = GZCommunicator("x", config=GZConfig(algo="intring"), axis_size=n, device="cpu")
    t0 = time.perf_counter()
    cpu = ThreadMesh((n,), ("x",), "cpu").run(cpu_comm.allreduce, [x.cpu() for x in xs16])
    cpu_s = time.perf_counter() - t0
    mism = sum(int((a.value.cpu().view(torch.int32) != b.value.view(torch.int32)).sum())
               for a, b in zip(card, cpu))
    log(f"intring 16 MB x {n}: card vs the port's CPU run ({cpu_s:.1f} s on the host): "
        f"mismatches {mism}")
    if mism or any(bool(r.overflow) for r in cpu):
        raise AssertionError(f"intring 16 MB: the card differs from the CPU run in {mism}")
    accuracy = GZCommunicator("x", config=GZConfig(), policy="accuracy", axis_size=n,
                              device=device)
    p_acc = accuracy.plan("allreduce", (m_elems,))
    acc, launches, wall = _mesh_call(ring, accuracy.allreduce, xs16)
    err = _within("accuracy policy", acc, exact16, n * 1.05 * EB + 1e-6 *
                  exact16.abs().max().item())
    mism = _bitwise_mismatches(acc, card)
    log(f"policy='accuracy' 16 MB x {n}: resolved {p_acc.algo}, wall {wall * 1e3:.1f} ms, "
        f"err {err:.3e}, vs the intring run mismatches {mism}, launches {_nonzero(launches)}")
    if p_acc.algo != "intring" or mism or _nonzero(launches) != {"quantize": n}:
        raise AssertionError(f"accuracy policy: {p_acc.algo}, {mism} mismatches")
    del card, cpu, acc

    # hier 2x4 at 646 MB on the port's default point, beside the flat composite call
    m24 = make_hier_mesh(2, 4, device=device)
    hier = GZHierCommunicator("node", "local", config=GZConfig(),
                              hw=cost_model.A100_SLINGSHOT, topology=(2, 4), device=device)
    hplan = hier.plan((n_elems,))
    if hplan.flat:
        raise AssertionError("hier 2x4 at A100_SLINGSHOT resolved flat")
    inter = hplan.inter
    res, launches, cold = _mesh_call(m24, hier.allreduce, xs)
    err = _within("hier 2x4 646 MB", res, exact, EB * 1.05 + 1e-6 * top)
    if launches != _hier_launches(hplan):
        raise AssertionError(f"hier launches {launches} != the inter plan's "
                             f"{_hier_launches(hplan)}")
    if {r.wire_bytes for r in res} != {hplan.inter_wire_bytes}:
        raise AssertionError("hier wire bytes are not the inter plan's")
    log(f"hier 2x4 {MAIN_BYTES / 1e6:.0f} MB/rank at {hier.hw.name}: flat={hplan.flat}; "
        f"inter plan {inter.algo}/{inter.pipeline_chunks} codec {inter.codec} over "
        f"{inter.axis_size} nodes at {inter.n_elems} f32 (eb_stage {inter.eb_stage:.3e}); "
        f"inter_wire_bytes {hplan.inter_wire_bytes} (flat plan {hplan.flat_plan.algo}/"
        f"{hplan.flat_plan.pipeline_chunks}: {hplan.flat_plan.wire_bytes}), intra "
        f"{hplan.intra_wire_bytes}; modeled {hplan.t_model * 1e3:.3f} ms vs flat "
        f"{hplan.t_flat * 1e3:.3f} ms; cold wall {cold * 1e3:.1f} ms; err {err:.3e}; "
        f"launches {_nonzero(launches)} ({_nonzero(_expected_launches(inter, 2))} per node "
        "pair)")
    del res
    h_warm, h_busy, _ = _mesh_profile(m24, hier.allreduce, xs, "hier 2x4 646 MB")
    flat = GZCommunicator(HIER_AXES, config=GZConfig(), axis_size=n, device=device)
    fplan = flat.plan("allreduce", (n_elems,))
    if (fplan.algo, fplan.pipeline_chunks, fplan.wire_bytes) != (
            hplan.flat_plan.algo, hplan.flat_plan.pipeline_chunks, hplan.flat_plan.wire_bytes):
        raise AssertionError(f"flat composite plan {fplan} is not the HierPlan's flat plan")
    res, launches, _ = _mesh_call(m24, flat.allreduce, xs)
    _within("flat composite 646 MB", res, exact, EB * 1.05 + 1e-6 * top)
    _check_launches(fplan, n, launches)
    del res
    f_warm, f_busy, _ = _mesh_profile(m24, flat.allreduce, xs, "flat composite 646 MB")
    log(f"hier vs flat at 646 MB x 8 on one card: warm wall {h_warm * 1e3:.1f} vs "
        f"{f_warm * 1e3:.1f} ms, device busy {h_busy:.1f} vs {f_busy:.1f} ms; inter-node "
        f"wire {hplan.inter_wire_bytes} vs {fplan.wire_bytes} bytes a rank "
        f"({fplan.wire_bytes / hplan.inter_wire_bytes:.2f}x less); one card has no "
        "inter-node link, so the walls do not show the link asymmetry")

    # the hier fallback of a forced overflow at 646 MB
    hfb = GZHierCommunicator("node", "local",
                             config=GZConfig(capacity_factor=0.02, on_overflow="fallback"),
                             hw=cost_model.A100_SLINGSHOT, topology=(2, 4), device=device)
    fbplan = hfb.plan((n_elems,))
    res, launches, wall = _mesh_call(m24, hfb.allreduce, xs)
    flags = {(bool(r.overflow), bool(r.nonfinite)) for r in res}
    want = _fold(xs)
    mism = sum(int((r.value.view(torch.int32) != want.view(torch.int32)).sum()) for r in res)
    log(f"hier fallback 2x4 {MAIN_BYTES / 1e6:.0f} MB, capacity_factor 0.02: flat="
        f"{fbplan.flat}; flags {flags}; vs the composite rank-order sum mismatches {mism}; "
        f"wall {wall * 1e3:.1f} ms (hier call {h_warm * 1e3:.1f} ms warm); launches "
        f"{_nonzero(launches)}")
    if fbplan.flat or flags != {(True, False)} or mism or launches != _hier_launches(fbplan):
        raise AssertionError("hier fallback: not flagged everywhere, not the exact sum, or "
                             "not the compressed pass's launches")
    del res, want, xs, exact

    # 4x2 at 16 MB; 2x4 at 16 MB on a flat fabric
    top16 = exact16.abs().max().item()
    h42 = GZHierCommunicator("node", "local", config=GZConfig(),
                             hw=cost_model.A100_SLINGSHOT, topology=(4, 2), device=device)
    p42 = h42.plan((m_elems,))
    res, launches, wall = _mesh_call(make_hier_mesh(4, 2, device=device), h42.allreduce, xs16)
    err = _within("hier 4x2 16 MB", res, exact16, EB * 1.05 + 1e-6 * top16)
    log(f"hier 4x2 16 MB/rank: flat={p42.flat} inter {p42.inter.algo}/"
        f"{p42.inter.pipeline_chunks} over {p42.inter.axis_size} nodes; wall "
        f"{wall * 1e3:.1f} ms; err {err:.3e}; launches {_nonzero(launches)}")
    if p42.flat or launches != _hier_launches(p42):
        raise AssertionError("hier 4x2: flat, or launches not the inter plan's")
    htpu = GZHierCommunicator("node", "local", config=GZConfig(), hw=cost_model.TPU_V5E,
                              topology=(2, 4), device=device)
    ptpu = htpu.plan((m_elems,))
    res, _, _ = _mesh_call(m24, htpu.allreduce, xs16)
    plain = GZCommunicator("x", config=GZConfig(), hw=cost_model.TPU_V5E, axis_size=n,
                           device=device)
    ref, _, _ = _mesh_call(ring, plain.allreduce, xs16)
    mism = _bitwise_mismatches(res, ref)
    log(f"hier 2x4 16 MB/rank at {htpu.hw.name} (no link asymmetry): flat={ptpu.flat} "
        f"({ptpu.flat_plan.algo}); vs the 8-rank GZCommunicator mismatches {mism}")
    if not ptpu.flat or mism:
        raise AssertionError("flat-fabric hier: not flat, or differs from the 8-rank call")
    del res, ref, xs16, exact16

    # the gradient sync of one minitron-8b layer over ("local", "node") 2x4
    trees = _layer_grads(n, gen, device)
    sync = _sync_for("lorenzo")
    names = ("local", "node")

    def body(t):
        return grad_sync.dp_allreduce_grads_stats(t, names, sync, device=device)

    res, launches, cold = _mesh_call(m24, body, trees)
    leaves = [grad_sync.tree_flatten(t)[0] for t in trees]
    ledger = buckets.ledger_for([a.shape for a in leaves[0]], sync.bucket_bytes)
    gplan = m24.run(lambda _: grad_sync._hier_comm(names, sync, device).plan(
        (ledger.bucket_elems,)), [None] * n)[0]
    scale = m24.run(lambda t: grad_sync._tree_scale(
        [a.reshape(-1) for a in grad_sync.tree_flatten(t)[0]],
        transport.current(names)), trees)[0].item()
    if gplan.flat:
        raise AssertionError("grad sync 2x4: the bucket plan resolved flat")
    hops = error_budget.lossy_hops(f"allreduce_{gplan.inter.algo}", gplan.inter.axis_size)
    worst = 0.0
    outs = [grad_sync.tree_flatten(out)[0] for out, _ in res]
    for i in range(len(leaves[0])):
        ex = _sum_exact([lv[i] for lv in leaves])
        bound = hops * gplan.inter.eb_stage * scale + 1e-6 * ex.abs().max().item()
        for r in range(n):
            e = (outs[r][i].double() - ex).abs().max().item()
            if not e <= bound:
                raise AssertionError(f"grad sync 2x4: leaf {i} rank {r} error {e} > {bound}")
            worst = max(worst, e / bound)
        del ex
    stats = [st for _, st in res]
    want_launches = {k: v * ledger.n_buckets for k, v in _hier_launches(gplan).items()}
    log(f"grad sync minitron-8b layer over {names} 2x4 (codec lorenzo): {ledger.n_buckets} "
        f"buckets of {ledger.bucket_elems}; bucket plan flat={gplan.flat}, inter "
        f"{gplan.inter.algo}/{gplan.inter.pipeline_chunks} over {gplan.inter.axis_size} "
        f"nodes; scale {scale:.6e}; wire_bytes/rank {stats[0].wire_bytes} (inter plan "
        f"{gplan.inter_wire_bytes} x {ledger.n_buckets}); cold wall {cold * 1e3:.1f} ms; "
        f"worst error {100 * worst:.1f} % of its bound; launches {_nonzero(launches)}")
    if any(bool(st.overflow) or bool(st.nonfinite) for st in stats) or \
            {(st.n_buckets, st.wire_bytes) for st in stats} != \
            {(ledger.n_buckets, gplan.inter_wire_bytes * ledger.n_buckets)} or \
            launches != want_launches:
        raise AssertionError(f"grad sync 2x4: flags, buckets, wire bytes or launches "
                             f"{launches} != {want_launches}")
    del res, outs, leaves
    _mesh_profile(m24, body, trees, "grad sync 2x4")
    del trees
    torch.cuda.empty_cache()
    return k5_launches


# ---------------------------------------------------------------------------
# Phases 15-18: the dense model's forward and serving path, kernel 11
# ---------------------------------------------------------------------------

MODEL_ARCH = "minitron-8b"  # src/repro/configs/minitron_8b.py, full width and depth
MODEL_SMOKE = False
MODEL_PARAMS = 9_882_046_464
MODEL_BATCH, MODEL_SEQ = 2, 2048
PREFILL_SEQ = 128
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_flash_kernel.py
SERVE_ARGV = ["--arch", "minitron-8b", "--batch", "4", "--prompt-len", "16", "--gen",
              "32", "--cache-len", "128"]


def check_flash_sass():
    """Kernel 11's bf16 kernel runs on Hopper's tensor cores and TMA: count
    the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in the
    SASS of its functions (``cuobjdump -sass`` of the built library) and
    fail if either is 0."""
    import re

    from repro_torch.kernels import build

    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    lib = build.build("flash_attn_sm90")["path"]
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {"HGMMA": 0, "UTMALDG": 0}
    funcs = 0
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if FLASH_BF16_KERNEL not in part.split("\n", 1)[0]:
            continue
        funcs += 1
        for op in counts:
            counts[op] += len(re.findall(rf"\b{op}\b", part))
    log(f"flash_attn_sm90 SASS: {funcs} {FLASH_BF16_KERNEL} functions, "
        f"{counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG")
    if not funcs or not all(counts.values()):
        raise AssertionError(f"kernel 11's bf16 kernel lacks wgmma or TMA in SASS: {counts}")


def check_flash_kernel(device, gen):
    """Phase 13: kernel 11 against its plain version on the card, at every
    head dim, both dtypes (bf16 on the tensor-core route, f32 on the
    CUDA-core route, counted), causal, causal with windows 64, 100, 128 and
    1000, non-causal with Sq != Sk, ragged lengths, rows that see no key,
    the bf16 edges that only TMA can get wrong (Sq, Sk in {1, 127, 129,
    2049} at D = 64 and 128, H = 1 through ``flash_attention_bhsd``), and
    the main path's shape (B=2, S=2048, H=32, D=128, bf16, causal), timed
    there beside the plain version, SDPA and the bound; then larger shapes
    checked and timed beside SDPA."""
    import torch

    from repro_torch.kernels import flash_attn

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, b, sq, sk, h, d, dtype, causal, window, timed)
        *[("causal", 2, 300, 300, 2, d, dt, True, 0, False)
          for d in (32, 64, 128) for dt in (f32, bf16)],
        *[("window", 1, 700, 700, 2, d, dt, True, w, False)
          for w in (64, 100, 128, 1000) for d, dt in ((64, f32), (128, bf16), (64, bf16))],
        ("non-causal", 2, 100, 300, 2, 64, f32, False, 0, False),
        ("non-causal", 2, 100, 300, 2, 128, bf16, False, 0, False),
        ("non-causal", 1, 2049, 129, 2, 64, bf16, False, 0, False),
        ("ragged", 3, 1000, 1000, 4, 32, bf16, True, 0, False),
        ("ragged", 1, 77, 77, 3, 64, f32, True, 0, False),
        ("no-key rows", 1, 300, 100, 2, 32, f32, True, 64, False),
        ("no-key rows", 1, 300, 100, 2, 128, bf16, True, 64, False),
        *[("TMA edges", 1, sq, sk, 2, d, bf16, True, 0, False)
          for d in (64, 128) for sq in (1, 127, 129, 2049) for sk in (1, 127, 129, 2049)],
        *[("H=1 bhsd", 6, 300, 300, 1, d, bf16, True, 0, False) for d in (32, 64, 128)],
        ("H=1 bhsd", 4, 129, 2049, 1, 128, bf16, False, 0, False),
        ("main", MODEL_BATCH, MODEL_SEQ, MODEL_SEQ, 32, 128, bf16, True, 0, True),
    ]
    record = None
    flash_attn.reset_launch_counts()
    calls = {"tensor_core_bf16": 0, "cuda_core_f32": 0}
    for label, b, sq, sk, h, d, dt, causal, window, timed in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device).to(dt)
                   for s in (sq, sk, sk))
        if label == "H=1 bhsd":  # the reference's (BH, S, D) call, H = 1 in the maps
            got = flash_attn.flash_attention_bhsd(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                                  causal=causal, window=window)[:, :, None]
        else:
            got = flash_attn.flash_attention(q, k, v, causal=causal, window=window)
        calls["tensor_core_bf16" if dt == bf16 else "cuda_core_f32"] += 1
        if flash_attn.ROUTES != calls:
            raise AssertionError(f"kernel 11 routes {flash_attn.ROUTES}, expected {calls}")
        want = flash_attn.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dt).removeprefix("torch.")]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        bad = int((diff > tol + tol * want.float().abs()).sum())
        log(f"flash_attention vs plain [{label} B={b} Sq={sq} Sk={sk} H={h} D={d} "
            f"{str(dt).removeprefix('torch.')} causal={causal} window={window}]: max |err| "
            f"{err:.3e} (atol = rtol = {tol:g}); {bad} of {got.numel()} outside")
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention [{label}] disagrees with its plain version")
        if timed:
            # causal, Sq = Sk: 4*D FLOPs (QK^T and PV) per unmasked (q, k) pair;
            # q, k, v read once and o written once
            flops = 4 * b * h * d * sq * (sq + 1) // 2
            nbytes = 4 * q.numel() * q.element_size()
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
            lib_err = float((lib.float() - want.float()).abs().max())
            record = {
                "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
                "replaces": REPLACES["flash_attention"], "launches": None,
                "max_abs_err": err,
                "ms": _median_ms(lambda: flash_attn.flash_attention(q, k, v), 20, 10),
                "plain_ms": _median_ms(lambda: flash_attn.flash_attention_plain(q, k, v), 5),
                "bound_ms": max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
                "bound_by": ("operations" if flops / BF16_FLOPS_PER_S
                             >= nbytes / HBM_BYTES_PER_S else "bytes"),
                "library_ms": _median_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 20, 10),
                "shape": [b, sq, h, d], "bytes": nbytes,
            }
            one_call = (_median_ms(lambda: flash_attn.flash_attention(q, k, v), 20),
                        _median_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 20))
            log(f"  flash_attention {record['ms']:.4f} ms  plain {record['plain_ms']:.3f} ms  "
                f"SDPA {record['library_ms']:.4f} ms (10 calls per event pair; one call per "
                f"pair, the host's launch included: kernel {one_call[0]:.4f} ms, SDPA "
                f"{one_call[1]:.4f} ms; max |SDPA - plain| {lib_err:.3e})  "
                f"bound {record['bound_ms']:.4f} ms ({flops / 1e9:.2f} GFLOP at "
                f"{BF16_FLOPS_PER_S / 1e12:g} TFLOP/s; {nbytes / 1e6:.1f} MB at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s)")
            del qt, kt, vt, lib
        del q, k, v, got, want, diff
    log(f"kernel 11 routes over phase 15: {calls}")
    # How the bf16 kernel scales against SDPA beyond the model's shape:
    # checked against the plain version, then timed (median of 10).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, h, causal in ((8, 2048, 32, True), (2, 8192, 32, True), (2, 4096, 16, False)):
        q, k, v = (torch.randn((b, s, h, 128), generator=gen, device=device).to(bf16)
                   for _ in range(3))
        got = flash_attn.flash_attention(q, k, v, causal=causal)
        want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
        tol = FLASH_TOL["bfloat16"]
        diff = (got.float() - want.float()).abs()
        bad = int((diff > tol + tol * want.float().abs()).sum())
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention [B={b} S={s}] disagrees with its plain version")
        del got, want, diff
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops = 4 * b * h * 128 * (s * (s + 1) // 2 if causal else s * s)
        ms = _median_ms(lambda: flash_attn.flash_attention(q, k, v, causal=causal), 10, 5)
        lib_ms = _median_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), 10, 5)
        log(f"  scaling B={b} S={s} H={h} D=128 causal={causal}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.0f} TFLOP/s), SDPA {lib_ms:.4f} ms "
            f"({flops / lib_ms / 1e9:.0f} TFLOP/s); {bad} outside the bf16 tolerance")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"flash_attention": record}


def _forward_logits(model, params, tokens, cross_kv=None):
    """Full-sequence logits at every position (the prefill reference of
    tests/test_prefill_decode_consistency.py); ``cross_kv``: the encdec
    encoder's output."""
    import torch

    from repro_torch.models.layers import embed_lookup, rms_norm, vocab_parallel_logits

    h = embed_lookup(tokens, params["embed"], model.ctx)
    h, _ = model._backbone(h, params, positions=torch.arange(h.shape[1], device=h.device),
                           cross_kv=cross_kv)
    h = rms_norm(h, params["final_norm"], model.cfg.norm_eps)
    return vocab_parallel_logits(h, params["unembed"], model.ctx)


def _decode_vs_prefill(model, params, tokens, prefill=None, enc_input=None):
    """The full-sequence logits of ``tokens`` (B, S) (through ``prefill``,
    another model on the same weights, where given; encdec: after its
    encoder over ``enc_input``) against S steps of ``model.decode_fn`` from
    a zero f32 cache (encdec: the prefill's encoder output in its
    ``enc_out``): (max rel err over the largest logit, prefill s, decode s,
    the cache's shapes, kernel 11's launches in the prefill and in the
    steps)."""
    prefill = prefill or model

    def forward():
        enc = None if enc_input is None else prefill._encode(params, enc_input)
        return _forward_logits(prefill, params, tokens, enc), enc

    n0 = _launches()["flash_attention"]
    (want, enc_out), prefill_s = _timed(forward)
    n1 = _launches()["flash_attention"]
    got, decode_s, cache = _decode_logits(model, params, tokens, enc_out)
    launches = (n1 - n0, _launches()["flash_attention"] - n1)
    rel = float((got - want).abs().max() / want.abs().max())
    return rel, prefill_s, decode_s, cache, launches


def _decode_logits(model, params, tokens, enc_out=None):
    """S steps of ``model.decode_fn`` over ``tokens`` (B, S) from a zero f32
    cache (encdec: ``enc_out``, the prefill's encoder output, copied into
    the cache's f32 ``enc_out``): (logits (B, S, V), seconds, the cache's
    shapes)."""
    import torch

    from repro_torch.models.attention import KVCacheSpec

    s = tokens.shape[1]
    spec = KVCacheSpec(s_total=s, cp_axis=None, cp_size=1)
    cache = {k: torch.zeros(v, dtype=torch.float32, device=tokens.device)
             for k, v in model.cache_defs(tokens.shape[0], spec).items()}
    if enc_out is not None:
        cache["enc_out"].copy_(enc_out)

    def decode_all():
        c = cache
        out = []
        for i in range(s):
            logits, c = model.decode_fn(params, c, tokens[:, i:i + 1], i, spec)
            out.append(logits[:, 0])
        return torch.stack(out, dim=1)

    got, decode_s = _timed(decode_all)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{model.cfg.arch_id}: non-finite decode logits")
    return got, decode_s, {k: tuple(v.shape) for k, v in cache.items()}


def _widths(cfg):
    """A config's published widths, for the log."""
    out = f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}"
    if cfg.ssm is not None:
        s = cfg.ssm
        out += (f", {s.n_heads(cfg.d_model)} SSD heads of {s.head_dim}, d_state {s.d_state}, "
                f"conv {s.conv_width}, chunk {s.chunk}")
    if cfg.n_heads:
        out += (f", {cfg.n_heads} attention heads ({cfg.n_kv_heads} kv) of {cfg.head_dim}, "
                f"d_ff {cfg.d_ff}")
    if cfg.attn_every:
        out += f" (one shared attention+MLP block after every {cfg.attn_every} layers)"
    if cfg.n_enc_layers:
        out += f", {cfg.n_enc_layers} encoder layers over {cfg.n_prefix} frames"
    elif cfg.n_prefix:
        out += f", {cfg.n_prefix} prefix positions before the text"
    return out + f", vocab {cfg.vocab}"


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_model(device):
    """Phases 16-18, this slice's main path.  16: ``Model.loss_fn`` of
    minitron-8b at full width and depth (32 layers, 19.76 GB of bf16
    weights drawn from seed 0 on the card) on one ``SyntheticStream`` batch
    of B=2, S=2048, with ``use_flash_kernel`` True (kernel 11 launched once
    per layer, counted) and False (the chunked path, no launch): both
    finite, within 2e-3 relative of each other; walls, and the device busy
    share and kernel 11's share of device time from one profiled call.  17:
    the full-sequence logits through kernel 11 at S=128 against 128 steps
    of ``decode_fn``, rel <= 0.05.  18: ``serve`` at full size (batch 4,
    16 + 32 tokens, cache 128).  Returns kernel 11's launches in the loss
    run."""
    import dataclasses
    import io

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.kernels import flash_attn
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    cfg = registry.get(MODEL_ARCH, smoke=MODEL_SMOKE)
    kcfg = dataclasses.replace(cfg, use_flash_kernel=True)
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _timed(lambda: Model(cfg, device=device, seed=SEED))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != MODEL_PARAMS:
        raise AssertionError(f"{cfg.arch_id}: {n_params} parameters, expected {MODEL_PARAMS}")
    params = model.params()
    kmodel = Model(kcfg, params=params, device=device)  # the same tensors
    log(f"model {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv_heads} kv), head dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters "
        f"({sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB "
        f"bf16) drawn from seed {SEED} in {init_s:.2f} s")
    batch = next(SyntheticStream(cfg, MODEL_BATCH, MODEL_SEQ, seed=SEED))

    with torch.inference_mode():
        # 16: the loss forward, through kernel 11 and through the chunked path
        _reset_launches()
        l1, cold1 = _timed(lambda: kmodel.loss_fn(params, batch))
        launches, routes = _launches(), dict(flash_attn.ROUTES)
        _reset_launches()
        l0, cold0 = _timed(lambda: model.loss_fn(params, batch))
        chunked_launches = _launches()
        l1, l0 = float(l1), float(l0)
        if _nonzero(launches) != {"flash_attention": cfg.n_layers}:
            raise AssertionError(f"loss forward with the kernel launched {_nonzero(launches)},"
                                 f" expected flash_attention x {cfg.n_layers}")
        if routes != {"tensor_core_bf16": cfg.n_layers, "cuda_core_f32": 0}:
            raise AssertionError(f"kernel 11 routes in the loss forward: {routes}, expected "
                                 f"tensor_core_bf16 x {cfg.n_layers}")
        if _nonzero(chunked_launches):
            raise AssertionError(f"chunked loss forward launched {_nonzero(chunked_launches)}")
        if not (math.isfinite(l0) and math.isfinite(l1)):
            raise AssertionError(f"non-finite loss: kernel {l1}, chunked {l0}")
        if abs(l1 - l0) > 2e-3 * max(abs(l0), 1.0):
            raise AssertionError(f"loss with kernel 11 {l1} vs chunked {l0}")
        _, warm1 = _timed(lambda: kmodel.loss_fn(params, batch))
        _, warm0 = _timed(lambda: model.loss_fn(params, batch))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, traced = _timed(lambda: kmodel.loss_fn(params, batch))
        events = _device_events(prof)
        busy = sum(e.self_device_time_total for e in events) / 1e3
        flash_events = [e for e in events if FLASH_BF16_KERNEL in e.key]
        flash_ms = sum(e.self_device_time_total for e in flash_events) / 1e3
        if sum(e.count for e in flash_events) != cfg.n_layers:
            raise AssertionError(f"profile shows {sum(e.count for e in flash_events)} "
                                 f"{FLASH_BF16_KERNEL} launches, expected {cfg.n_layers}")
        log(f"loss forward {cfg.arch_id} B={batch['tokens'].shape[0]} "
            f"S={batch['tokens'].shape[1]}: loss with kernel 11 {l1:.6f}, chunked {l0:.6f} "
            f"(|diff| {abs(l1 - l0):.3e}, bound {2e-3 * max(abs(l0), 1.0):.3e}; "
            f"ln(vocab) {math.log(cfg.vocab):.4f}); launches {_nonzero(launches)}; wall "
            f"kernel path cold {cold1 * 1e3:.1f} ms warm {warm1 * 1e3:.1f} ms, chunked "
            f"path cold {cold0 * 1e3:.1f} ms warm {warm0 * 1e3:.1f} ms; kernel 11 routes "
            f"{routes}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"profile (kernel path): traced wall {traced * 1e3:.1f} ms, device busy "
            f"{busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %); kernel 11 {flash_ms:.1f} ms "
            f"({100 * flash_ms / max(busy, 1e-9):.1f} % of device time, "
            f"{flash_ms / cfg.n_layers:.4f} ms per launch)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
        del prof, events, batch
        torch.cuda.empty_cache()

        # 17: decode against prefill (the prefill through kernel 11)
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, PREFILL_SEQ)).astype(np.int32)).to(device)
        _reset_launches()
        rel, prefill_s, decode_s, *_ = _decode_vs_prefill(model, params, tokens, prefill=kmodel)
        if _launches()["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"prefill and decode launched {_nonzero(_launches())}")
        log(f"decode vs prefill {cfg.arch_id} B=2 S={PREFILL_SEQ}: max rel err {rel:.4e} "
            f"(bound 0.05); prefill through kernel 11 {prefill_s * 1e3:.1f} ms, "
            f"{PREFILL_SEQ} decode steps {decode_s * 1e3:.1f} ms "
            f"({decode_s * 1e3 / PREFILL_SEQ:.2f} ms/step)")
        if not rel <= 0.05:
            raise AssertionError(f"decode/prefill mismatch: rel {rel}")
        del model, kmodel, params
        torch.cuda.empty_cache()

    # 18: serving at full size
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen, serve_s = _timed(lambda: serve(SERVE_ARGV + (["--smoke"] if MODEL_SMOKE else [])
                                            + ["--device", str(device)]))
    for line in out.getvalue().splitlines():
        log(f"serve: {line}")
    n_batch, n_gen = int(SERVE_ARGV[3]), int(SERVE_ARGV[7])
    if gen.shape != (n_batch, n_gen + 1):
        raise AssertionError(f"serve returned tokens of shape {gen.shape}")
    log(f"serve: {n_batch} x {int(SERVE_ARGV[5]) + n_gen} decode steps; wall with model "
        f"init {serve_s:.2f} s")
    torch.cuda.empty_cache()
    return launches["flash_attention"]


# ---------------------------------------------------------------------------
# Phases 19-21 and 23: the training path
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2-20b"  # src/repro/configs/internlm2_20b.py, every width as published
TRAIN_LAYERS = 2  # the only cut: depth (48 layers); 2 fit the card beside 2 replicas
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 512, 3  # the global batch over 2 data ranks
TRAIN_EB = 1e-4
TRAIN_CHECK_LEAF = ("blocks", "attn", "wo")  # the synced leaf held against the exact sum
# (shape, dtype) of the per-rank trees of phase 20; every leaf at least 4
# ring chunks of two 256-element blocks (a chunk padded to its block costs
# the block's bit width in every padded slot, and a far smaller leaf
# overflows the 0.6 capacity)
TRAIN_SMOKE_SYNC = {
    "embed": ((512, 128), "bfloat16"),
    "blocks": {"wq": ((2, 128, 256), "bfloat16"), "ln1": ((2, 2048), "float32")},
    "final_norm": ((2048,), "float32"),
    "big": ((200_000,), "float32"),
}
TRAIN_CLI_ARGV = ["--smoke", "--steps", "12", "--batch", "4", "--seq", "64", "--lr", "1e-3",
                  "--grad-gz", "ring"]


def _tree_equal(a, b):
    """Every leaf of two trees equal by bits (on the device)."""
    import torch

    from repro_torch.core.grad_sync import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and bool(torch.equal(
            x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
            y.view(torch.int16) if y.dtype == torch.bfloat16 else y))
        for x, y in zip(la, lb))


def _check_replicas(params, opt, label):
    for r in range(1, len(params)):
        if not (_tree_equal(params[0], params[r]) and _tree_equal(opt[0], opt[r])):
            raise AssertionError(f"{label}: rank {r}'s params or opt state differ from rank 0's")


@contextlib.contextmanager
def _watched_sync(record):
    """Wrap ``training._sync_grads`` for the train step: each call's
    ``degraded`` flag into ``record["degraded"]``; each rank's input and
    output of the leaf at the path ``record["check_leaf"]`` into
    ``record["leaf"]`` while ``record["keep_leaf"]``; each rank's arguments into
    ``record["args"]`` while ``record["keep_args"]`` (to run the sync
    again, alone, on the same gradients).  ``record["real"]`` is the
    unwrapped function."""
    from repro_torch.core import transport
    from repro_torch.launch import training

    real = record["real"] = training._sync_grads
    lock = threading.Lock()

    def leaf(tree):
        for k in record["check_leaf"]:
            tree = tree[k]
        return tree

    def wrapped(grads, specs, mesh_axes, grad_comms):
        out, degraded = real(grads, specs, mesh_axes, grad_comms)
        rank = transport.current("data").rank
        with lock:
            record["degraded"].append(degraded)
            if record.get("keep_leaf"):
                record["leaf"][rank] = (leaf(grads).float().clone(), leaf(out).float().clone())
            if record.get("keep_args"):
                record["args"][rank] = (grads, specs, mesh_axes, grad_comms)
        return out, degraded

    training._sync_grads = wrapped
    try:
        yield record
    finally:
        training._sync_grads = real


def _train_plan_launches(setup, n):
    """Kernel launches of one train step's gradient sync over all ranks:
    every leaf's allreduce plan over ``data``, from the schedule."""
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.models.parallel import torch_dtype

    comm = dict(setup.grad_comms)["data"]
    total = dict.fromkeys(_launches(), 0)
    for d in tree_flatten(setup.defs)[0]:
        plan = comm.plan("allreduce", d.shape, torch_dtype(d.dtype))
        for k, v in _expected_launches(plan, n).items():
            total[k] += v
    return total


def _step_timed(step, params, opt, batch):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    return params, opt, m, time.perf_counter() - t0


def run_train_full_width(device, arch=TRAIN_ARCH, layers=TRAIN_LAYERS,
                         check_leaf=TRAIN_CHECK_LEAF):
    """Phase 19 (and the ssm phase's train step): ``make_train_step`` of
    ``arch`` at every published width, depth cut to ``layers`` (None: the
    full depth), on a ``ThreadMesh((2, 1))`` of the card, ``fsdp=False``,
    the ring allreduce at eb 1e-4, remat ``"full"``, a global batch of 2 x
    512 tokens, ``TRAIN_STEPS`` steps and one more under the profiler, then
    that step's gradient sync again, alone, on the same gradients, under
    the profiler (its device busy over the step's is the sync's share).
    Checks every step: finite loss, both ranks' params and opt state equal
    by bits, no leaf flagged, kernels 1-4 launched as every leaf's plan
    says; once: the synced leaf at ``check_leaf`` within the allreduce's
    bound of the exact rank-order sum.  Returns the kernels' launches over
    the ``TRAIN_STEPS`` steps."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.core import error_budget
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch import shapes, training
    from repro_torch.launch.mesh import ThreadMesh
    from repro_torch.models.parallel import init_params
    from repro_torch.optim.adamw import adamw_init

    n = 2
    full = registry.get(arch)
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
    mesh = ThreadMesh((n, 1), ("data", "model"), device)
    setup = training.make_setup(cfg, mesh, fsdp=False, remat="full",
                                grad_gz=GZConfig(eb=TRAIN_EB, algo="ring"))
    _, bspecs = shapes.train_specs(
        cfg, shapes.InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh)
    step = training.make_train_step(setup, bspecs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = [init_params(setup.defs, gen, device)]
    params.append(tree_map(torch.clone, params[0]))
    opt = [adamw_init(p) for p in params]
    torch.cuda.synchronize()
    n_params = sum(math.prod(d.shape) for d in tree_flatten(setup.defs)[0])
    log(f"train {_widths(cfg)} as published; n_layers "
        f"{f'cut {full.n_layers} -> ' if cfg.n_layers != full.n_layers else ''}"
        f"{cfg.n_layers}; {n_params} parameters a rank "
        f"(bf16), {n} data ranks on one card, fsdp=False, grad_gz ring eb {TRAIN_EB}, "
        f"remat full; params and AdamW state drawn and zeroed in "
        f"{time.perf_counter() - t0:.2f} s")
    stream = SyntheticStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    want = _train_plan_launches(setup, n)
    record = {"degraded": [], "leaf": {}, "keep_leaf": True, "args": {},
              "check_leaf": check_leaf}
    total = dict.fromkeys(_launches(), 0)
    losses = []
    with _watched_sync(record):
        for s in range(TRAIN_STEPS):
            batch = next(stream)
            _reset_launches()
            params, opt, m, wall = _step_timed(step, params, opt, batch)
            launches = _launches()
            loss = float(m["loss"])
            losses.append(loss)
            if not math.isfinite(loss) or not math.isfinite(float(m["gnorm"])):
                raise AssertionError(f"train step {s}: loss {loss}, gnorm {float(m['gnorm'])}")
            _check_replicas(params, opt, f"train step {s}")
            if any(bool(d) for d in record["degraded"]) or len(record["degraded"]) != n:
                raise AssertionError(f"train step {s}: a leaf's sync was flagged "
                                     f"({[bool(d) for d in record['degraded']]})")
            record["degraded"].clear()
            if launches != want:
                raise AssertionError(f"train step {s}: launches {_nonzero(launches)} != the "
                                     f"plans' {_nonzero(want)}")
            for k, v in launches.items():
                total[k] += v
            if record.pop("keep_leaf", False):
                (g0, out0), (g1, out1) = record["leaf"][0], record["leaf"][1]
                exact = g0.double() + g1.double()
                plan = dict(setup.grad_comms)["data"].plan("allreduce", tuple(g0.shape),
                                                          torch.bfloat16)
                hops = error_budget.lossy_hops(f"allreduce_{plan.algo}", n)
                # the allreduce's bound, then the cast of its f32 result to bf16
                bound = hops * plan.eb_stage + 2.0 ** -8 * exact.abs().max().item()
                err = max((o.double() - exact).abs().max().item() for o in (out0, out1))
                if not err <= bound or not torch.equal(out0, out1):
                    raise AssertionError(f"synced {'.'.join(check_leaf)}: error {err} "
                                         f"> bound {bound}, or the ranks differ")
                log(f"train synced leaf {'.'.join(check_leaf)} {tuple(g0.shape)}: max "
                    f"error {err:.3e} vs the exact rank-order sum, bound {bound:.3e} "
                    f"(plan {plan.algo}/{plan.pipeline_chunks}, eb_stage "
                    f"{plan.eb_stage:.3e}); max |g| {exact.abs().max().item():.3e}")
                del g0, g1, out0, out1, exact
                record["leaf"].clear()
            log(f"train step {s}: loss {loss:.6f} gnorm {float(m['gnorm']):.4f} lr "
                f"{float(m['lr']):.3e}; wall {wall * 1e3:.1f} ms"
                f"{' (cold)' if s == 0 else ' (warm)'}; launches {_nonzero(launches)}")
        batch = next(stream)
        record["keep_args"] = True
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            params, opt, m, traced = _step_timed(step, params, opt, batch)
        record["keep_args"] = False
        _check_replicas(params, opt, "profiled train step")
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    own_ms = sum(e.self_device_time_total for e in events if OWN_KERNEL.search(e.key)) / 1e3
    log(f"train profile (one step): traced wall {traced * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %), kernels 1-4 {own_ms:.1f} ms; "
        f"loss {float(m['loss']):.6f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
    del prof, events
    # the profiled step's sync again, alone, on the same gradients
    args = [record["args"][r] for r in range(n)]
    record["args"].clear()
    torch.cuda.synchronize()
    _reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, sync_wall = _timed(lambda: mesh.run(lambda a: record["real"](*a), args))
    if _launches() != want:
        raise AssertionError(f"the sync alone launched {_nonzero(_launches())}, the plans say "
                             f"{_nonzero(want)}")
    del args
    events = _device_events(prof)
    sync_busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"train sync alone (the profiled step's gradients): traced wall "
        f"{sync_wall * 1e3:.1f} ms, device busy {sync_busy:.1f} ms = "
        f"{100 * sync_busy / max(busy, 1e-9):.1f} % of the step's device busy")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
    peak = torch.cuda.max_memory_allocated()
    log(f"train peak memory: {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated, both "
        f"ranks); losses {[round(x, 6) for x in losses]}; kernels over {TRAIN_STEPS} steps "
        f"{_nonzero(total)}")
    del params, opt, prof, events, m, step, setup
    torch.cuda.empty_cache()
    return total


def _smoke_sync_trees(n, device):
    """n per-rank trees of ``TRAIN_SMOKE_SYNC``: seeded f32 random walks of
    1e-5 steps (numpy), cast to each leaf's dtype on ``device``."""
    import numpy as np
    import torch

    from repro_torch.models.parallel import torch_dtype

    rng = np.random.default_rng(SEED)

    def tree(spec):
        if isinstance(spec, dict):
            return {k: tree(v) for k, v in spec.items()}
        shape, dtype = spec
        walk = np.cumsum(rng.normal(0, 1e-5, math.prod(shape)).astype(np.float32))
        return torch.from_numpy(walk.reshape(shape)).to(device).to(torch_dtype(dtype))

    return [tree(TRAIN_SMOKE_SYNC) for _ in range(n)]


def check_train_sync_vs_cpu(device):
    """Phase 20: one ``training._sync_grads`` of the same seeded per-rank
    bf16 and f32 trees on a 4-rank ``ThreadMesh`` of the card (the ring
    allreduce at eb 1e-4 through kernels 1-4: at 4 ranks the ring has
    intermediate hops) and of the CPU (their plain versions): every leaf
    equal by bits, no rank's flag set."""
    import torch

    from repro_torch.convert import tree_map
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.launch import training
    from repro_torch.launch.mesh import ThreadMesh

    n, axes = 4, ("data", "model")

    def sync(dev):
        comms = {"data": GZCommunicator.for_config("data", GZConfig(eb=TRAIN_EB, algo="ring"),
                                                   axis_size=n, device=dev)}
        trees = _smoke_sync_trees(n, dev)
        specs = tree_map(lambda a: (None,) * a.dim(), trees[0])
        torch.cuda.synchronize()
        _reset_launches()
        res = ThreadMesh((n, 1), axes, dev).run(
            lambda t: training._sync_grads(t, specs, axes, comms), trees)
        torch.cuda.synchronize()
        return res, _launches()

    card, launches = sync(device)
    plain, _ = sync(torch.device("cpu"))
    mism = 0
    for (a, fa), (b, fb) in zip(card, plain):
        for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
            x, y = x.cpu(), y
            if x.dtype == torch.bfloat16:
                x, y = x.view(torch.int16), y.view(torch.int16)
            mism += int((x != y).sum())
        if bool(fa) or bool(fb):
            raise AssertionError(f"train sync flagged: card {bool(fa)}, CPU {bool(fb)}")
    n_elems = sum(x.numel() for x in tree_flatten(plain[0][0])[0])
    log(f"train sync on the card vs the CPU: {n} ranks, {n_elems} elements a rank (bf16 and "
        f"f32 leaves), {mism} elements differ by bits; no flag on either; "
        f"launches on the card {_nonzero(launches)}")
    if mism:
        raise AssertionError(f"train sync: {mism} elements differ between card and CPU")
    for name in ("quantize_pack", "unpack_reduce_repack", "unpack_dequantize_reduce",
                 "unpack_dequantize"):
        if not launches[name]:
            raise AssertionError(f"train sync on the card did not launch {name}")


def check_train_skip(device):
    """Phase 21: ``skip_on_overflow`` at smoke size on a 2-rank mesh of the
    card: an overflow forced on rank 1 (``faults.FaultSpec("overflow")``)
    under ``on_overflow="flag"`` skips the step (``metrics["skipped"]``,
    params and opt state equal by bits to the step's inputs on both
    ranks); the next, clean step applies."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.core import faults
    from repro_torch.core.collectives import GZConfig
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch import shapes, training
    from repro_torch.launch.mesh import ThreadMesh
    from repro_torch.models.parallel import init_params
    from repro_torch.optim.adamw import adamw_init

    cfg = registry.get(TRAIN_ARCH, smoke=True)
    mesh = ThreadMesh((2, 1), ("data", "model"), device)
    # eb 1e-2: no bucket of these gradients overflows unless forced to
    setup = training.make_setup(cfg, mesh, fsdp=False, skip_on_overflow=True,
                                grad_gz=GZConfig(eb=1e-2, algo="ring", on_overflow="flag"))
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("t", 64, 4, "train"), mesh)
    step = training.make_train_step(setup, bspecs)
    p0 = init_params(setup.defs, torch.Generator(device=device).manual_seed(SEED), device)
    params = [p0, tree_map(torch.clone, p0)]
    opt = [adamw_init(p) for p in params]
    before = tree_map(torch.clone, (params, opt))
    stream = SyntheticStream(cfg, 4, 64, seed=SEED)
    with faults.inject(faults.FaultSpec("overflow", ranks=(1,))):
        params, opt, m = step(params, opt, next(stream))
    kept = all(_tree_equal(params[r], before[0][r]) and _tree_equal(opt[r], before[1][r])
               for r in range(2))
    if not bool(m["skipped"]) or not kept:
        raise AssertionError(f"forced overflow: skipped {bool(m['skipped'])}, state kept {kept}")
    params, opt, m2 = step(params, opt, next(stream))
    _check_replicas(params, opt, "the step after the skip")
    if bool(m2["skipped"]) or int(opt[0]["step"]) != 1 or _tree_equal(params[0], before[0][0]):
        raise AssertionError(f"the clean step after the skip: skipped {bool(m2['skipped'])}, "
                             f"step {int(opt[0]['step'])}")
    log(f"train skip: forced overflow on rank 1 -> skipped, params and opt state kept by bits "
        f"on both ranks (loss {float(m['loss']):.6f}); next step applied (loss "
        f"{float(m2['loss']):.6f}, step count {int(opt[0]['step'])})")


def check_flash_under_grad(device):
    """Phase 23: kernel 11's entry points raise under grad on the card,
    naming the chunked path; under ``no_grad`` the same call runs."""
    import torch

    from repro_torch.kernels import flash_attn

    q, k, v = (torch.randn(1, 256, 4, 64, device=device, dtype=torch.bfloat16,
                           generator=torch.Generator(device=device).manual_seed(i))
               for i in range(3))
    for name in ("flash_attention", "flash_attention_bhsd", "flash_attention_kernel"):
        fn = getattr(flash_attn, name)
        a, b, c = (q, k, v) if name != "flash_attention_bhsd" else (
            x.transpose(1, 2).reshape(4, 256, 64).contiguous() for x in (q, k, v))
        try:
            fn(a.requires_grad_(True), b, c)
        except RuntimeError as e:
            if "use_flash_kernel=False" not in str(e):
                raise
        else:
            raise AssertionError(f"flash_attn.{name} ran under grad")
        a.requires_grad_(False)
        with torch.no_grad():
            if not bool(torch.isfinite(fn(a, b, c)).all()):
                raise AssertionError(f"flash_attn.{name} under no_grad: non-finite output")
    log("kernel 11 under grad: flash_attention, flash_attention_bhsd and "
        "flash_attention_kernel raise on the card, naming use_flash_kernel=False; under "
        "no_grad they run")


def run_train(device):
    """Phases 19-21 and 23 (module docstring).  Returns the kernels'
    launches of phase 19's steps."""
    t0 = time.perf_counter()
    launches = run_train_full_width(device)
    check_train_sync_vs_cpu(device)
    check_train_skip(device)
    check_flash_under_grad(device)
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 24: the ssm and hybrid families
# ---------------------------------------------------------------------------

# full width and depth (src/repro/configs/mamba2_780m.py, zamba2_2_7b.py),
# each with its parameter count and its serve arguments
SSM_ARCHS = {
    "mamba2-780m": (858_472_704, []),  # serve's default --arch
    "zamba2-2.7b": (2_423_697_568, ["--arch", "zamba2-2.7b"]),
}
SSM_SMOKE = False
SSM_BATCH, SSM_SEQ = 2, 2048  # 8 SSD chunks of 256
SSM_PREFILL_SEQ = 320  # two chunks, the second padded
SSM_F32_SEQ = 320  # the smoke configs in f32, card against CPU
SSM_F32_TOL = 1e-5
SSM_TRAIN_ARCH = "mamba2-780m"
SSM_TRAIN_LEAF = ("blocks", "ssm", "w_out")
SSM_DECODE_NOTE = ("the reference's jitted bf16 decode leaves its prefill by more than "
                   "0.05 from about 12 layers on; scripts/ssm_decode_drift.py")


def _profiled_loss(tag, model, params, batch, detail=lambda events, busy: ""):
    """``model.loss_fn`` on ``batch`` under inference mode: finite; the cold
    and warm walls and the peak memory; the busy share, ``detail``'s text
    and the top device rows of one profiled call.  Returns the warm wall
    (s) and the profile's device busy (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    b, s = batch["tokens"].shape
    with torch.inference_mode():
        loss, cold = _timed(lambda: model.loss_fn(params, batch))
        loss = float(loss)
        if not math.isfinite(loss):
            raise AssertionError(f"{cfg.arch_id}: non-finite loss {loss}")
        _, warm = _timed(lambda: model.loss_fn(params, batch))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, traced = _timed(lambda: model.loss_fn(params, batch))
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"{tag} loss forward {cfg.arch_id} B={b} S={s}: loss {loss:.6f} "
        f"(ln(vocab) {math.log(cfg.vocab):.4f}); wall cold {cold * 1e3:.1f} ms, warm "
        f"{warm * 1e3:.1f} ms; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"{tag} profile {cfg.arch_id}: traced wall {traced * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %); kernel launches "
        f"{sum(e.count for e in events)}{detail(events, busy)}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
    del prof, events
    torch.cuda.empty_cache()
    return warm, busy


def _serve_steps(cfg, serve_argv, smoke, device):
    """``serve`` with ``serve_argv`` (and ``--smoke``) on ``device``: its
    lines, its tokens' shape checked, its ms a decode step."""
    import io

    import torch

    from repro_torch.launch.serve import serve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen, serve_s = _timed(lambda: serve(serve_argv + (["--smoke"] if smoke else [])
                                            + ["--device", str(device)]))
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"serve: {line}")
    m = re.search(r"decoded (\d+) tokens x(\d+) in ([\d.]+)s", lines[0])
    if not lines[0].startswith(f"arch={cfg.arch_id} ") or m is None or \
            gen.shape != (int(m.group(2)), int(m.group(1))):
        raise AssertionError(f"serve {serve_argv}: {lines[0]!r}, tokens {gen.shape}")
    n_steps = 16 + 32  # serve's default --prompt-len and --gen
    log(f"serve {cfg.arch_id}: {n_steps} decode steps of batch {gen.shape[0]}, "
        f"{float(m.group(3)) * 1e3 / n_steps:.2f} ms/step; wall with model init "
        f"{serve_s:.2f} s")
    torch.cuda.empty_cache()


def _ssm_forward(arch, n_want, serve_argv, device):
    """``arch`` at full width and depth from seed 0 (bf16): the loss
    forward at B=2, S=2048 (finite; cold and warm walls; busy share and
    top device rows of one profiled call), the full-sequence logits against
    ``SSM_PREFILL_SEQ`` steps of ``decode_fn`` (with the weights cast to
    f32: rel <= 0.05; in bf16 logged), then ``serve`` with
    ``serve_argv``."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.models.model import Model

    cfg = registry.get(arch, smoke=SSM_SMOKE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _timed(lambda: Model(cfg, device=device, seed=SEED))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != n_want:
        raise AssertionError(f"{cfg.arch_id}: {n_params} parameters, expected {n_want}")
    params = model.params()
    log(f"ssm {_widths(cfg)}; {n_params} parameters "
        f"({sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB) "
        f"drawn from seed {SEED} in {init_s:.2f} s")
    _profiled_loss("ssm", model, params,
                   next(SyntheticStream(cfg, SSM_BATCH, SSM_SEQ, seed=SEED)))
    with torch.inference_mode():
        # decode against prefill: two chunks, the second padded; gated with
        # the weights in f32 (bf16's rounding drifts apart over the depth,
        # in the reference as here: SSM_DECODE_NOTE), logged in bf16 too
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, SSM_PREFILL_SEQ)).astype(np.int32)).to(device)
        rel16, *_ = _decode_vs_prefill(model, params, tokens)
        params32 = tree_map(lambda t: t.to(torch.float32), params)
        del model, params
        torch.cuda.empty_cache()
        model32 = Model(cfg, params=params32, device=device)
        rel, prefill_s, decode_s, cache, _ = _decode_vs_prefill(model32, params32, tokens)
        log(f"ssm decode vs prefill {cfg.arch_id} B=2 S={SSM_PREFILL_SEQ}, f32 weights: max "
            f"rel err {rel:.4e} (bound 0.05); bf16 weights: {rel16:.4e} (not gated: "
            f"{SSM_DECODE_NOTE}); cache {cache}; f32 prefill {prefill_s * 1e3:.1f} ms, "
            f"{SSM_PREFILL_SEQ} decode steps {decode_s * 1e3:.1f} ms "
            f"({decode_s * 1e3 / SSM_PREFILL_SEQ:.2f} ms/step)")
        if not rel <= 0.05:
            raise AssertionError(f"{cfg.arch_id}: decode/prefill mismatch: rel {rel}")
        del model32, params32
        torch.cuda.empty_cache()
    _serve_steps(cfg, serve_argv, SSM_SMOKE, device)


def _check_ssm_f32_card_vs_cpu(device):
    """Both smoke configs with f32 weights (drawn on the CPU from seed 0,
    A_log, D and dt_bias then redrawn from a seeded normal so every SSD
    term matters) and one batch, on the card and on the CPU: the two losses
    within rel ``SSM_F32_TOL`` (the function is the same on both devices:
    no TF32, no other route)."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.models.model import Model

    rng = np.random.default_rng(SEED)
    for arch in SSM_ARCHS:
        cfg = registry.get(arch, smoke=True)
        params = tree_map(lambda t: t.to(torch.float32),
                          Model(cfg, device="cpu", seed=SEED).params())
        for name, mean in (("A_log", 0.0), ("D", 1.0), ("dt_bias", -1.0)):
            leaf = params["blocks"]["ssm"][name]
            leaf.copy_(torch.from_numpy(rng.normal(mean, 1.0, leaf.shape).astype(np.float32)))
        batch = next(SyntheticStream(cfg, 2, SSM_F32_SEQ, seed=SEED))
        on_card = tree_map(lambda t: t.to(device), params)
        with torch.inference_mode():
            cpu = float(Model(cfg, params=params, device="cpu").loss_fn(params, batch))
            card = float(Model(cfg, params=on_card, device=device).loss_fn(on_card, batch))
        rel = abs(card - cpu) / abs(cpu)
        log(f"ssm f32 {cfg.arch_id} B=2 S={SSM_F32_SEQ}: loss on the card {card:.9f}, on the "
            f"CPU {cpu:.9f}, rel {rel:.3e} (bound {SSM_F32_TOL:g})")
        if not rel <= SSM_F32_TOL:
            raise AssertionError(f"{cfg.arch_id} f32: card {card} vs CPU {cpu}, rel {rel}")


def run_ssm(device):
    """Phase 24 (module docstring).  Returns the kernels' launches of the
    mamba2-780m train steps."""
    t0 = time.perf_counter()
    for arch, (n_params, serve_argv) in SSM_ARCHS.items():
        _ssm_forward(arch, n_params, serve_argv, device)
    _check_ssm_f32_card_vs_cpu(device)
    launches = run_train_full_width(device, SSM_TRAIN_ARCH, None, SSM_TRAIN_LEAF)
    log(f"ssm phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 25: the MLA family
# ---------------------------------------------------------------------------

# full width and depth (src/repro/configs/minicpm3_4b.py): 62 layers, d_model
# 2560, 40 heads, q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v 64,
# d_ff 6400, vocab 73448 padded to 73728
MLA_ARCH = "minicpm3-4b"
MLA_PARAMS = 4_263_272_960
MLA_SMOKE = False
MLA_BATCH, MLA_SEQ = 2, 2048  # two latent chunks of mla_chunk 1024
MLA_PREFILL_SEQ = 64  # one chunk: the whole cache (128 until PR 38: room for train-cli)
MLA_F32_SEQ = 320
MLA_F32_CHUNKS = (128, 0)  # three chunks, the last padded; the dense route
MLA_F32_TOL = 1e-5
# the only cut: depth (62 layers).  Peak 60.69 GB at 24 layers, ~2.02 GB a
# layer (both ranks); 28 keep it near 69 GB, ~16 GB inside the card
MLA_TRAIN_LAYERS = 28
MLA_TRAIN_LEAF = ("blocks", "mla", "wo")
MLA_SERVE_ARGV = ["--arch", MLA_ARCH]


def _mla_attention_gflop(cfg, b, s):
    """The f32 latent attention's GFLOP in one layer's chunked forward:
    per chunk the nope and rope logits and the latent values over every
    (query, key) pair, then the absorb and the v up-projection."""
    m = cfg.mla
    h = cfg.n_heads
    chunk = min(cfg.mla_chunk or s, s)
    keys = -(-s // chunk) * chunk
    pairs = b * h * s * keys
    flop = 2 * pairs * (m.kv_lora_rank + m.qk_rope_head_dim + m.kv_lora_rank)
    flop += 2 * b * s * h * m.kv_lora_rank * (m.qk_nope_head_dim + m.v_head_dim)
    return flop / 1e9


def _gemm_split(events):
    """Device ms of the profile's f32 GEMMs (cuBLAS's CUDA-core kernels,
    ``f32f32`` and ``sgemm`` in their names), its bf16 GEMMs (the other
    GEMMs: tensor cores, ``nvjet`` on Hopper) and everything else."""
    out = {"f32 GEMM": 0.0, "bf16 GEMM": 0.0, "other": 0.0}
    for e in events:
        name = e.key.lower()
        kind = "other"
        if "f32f32" in name or "sgemm" in name:
            kind = "f32 GEMM"
        elif "gemm" in name or "nvjet" in name:
            kind = "bf16 GEMM"
        out[kind] += e.self_device_time_total / 1e3
    return out


def _family_detail(events, busy):
    """``_profiled_loss``'s detail: the device ms of the f32 GEMMs (the
    unembed), the bf16 GEMMs, kernel 11 and the rest."""
    split = _gemm_split(events)
    flash = sum(e.self_device_time_total for e in events if FLASH_BF16_KERNEL in e.key) / 1e3
    split["other"] -= flash
    split["kernel 11"] = flash
    return "".join(f"; {k} {v:.1f} ms ({100 * v / max(busy, 1e-9):.1f} %)"
                   for k, v in split.items())


def _family_loss(model, params, launches_want, detail=None):
    """``Model.loss_fn`` on one ``SyntheticStream`` batch at B=2, S=2048
    through kernel 11 (``launches_want`` launches, all on the tensor-core
    route) and through the chunked path (none), within 2e-3·max(|l0|, 1)
    (C7); the chunked wall; then the kernel path profiled
    (``_profiled_loss`` with ``detail``; default: the f32 and bf16 GEMMs'
    and kernel 11's device ms).  Returns kernel 11's launches."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.kernels import flash_attn
    from repro_torch.models.model import Model

    cfg = model.cfg
    kmodel = Model(dataclasses.replace(cfg, use_flash_kernel=True), params=params,
                   device=params["embed"].device)
    batch = next(SyntheticStream(cfg, MODEL_BATCH, MODEL_SEQ, seed=SEED))
    with torch.inference_mode():
        _reset_launches()
        l1 = float(kmodel.loss_fn(params, batch))
        launches, routes = _launches(), dict(flash_attn.ROUTES)
        _reset_launches()
        l0, cold0 = _timed(lambda: model.loss_fn(params, batch))
        chunked = _launches()
        l0 = float(l0)
        if _nonzero(launches) != {"flash_attention": launches_want} or \
                routes != {"tensor_core_bf16": launches_want, "cuda_core_f32": 0}:
            raise AssertionError(f"{cfg.arch_id} loss forward with the kernel launched "
                                 f"{_nonzero(launches)}, routes {routes}; expected "
                                 f"flash_attention x {launches_want} on the bf16 route")
        if _nonzero(chunked):
            raise AssertionError(f"{cfg.arch_id} chunked loss forward launched "
                                 f"{_nonzero(chunked)}")
        if not (math.isfinite(l0) and math.isfinite(l1)) or \
                abs(l1 - l0) > 2e-3 * max(abs(l0), 1.0):
            raise AssertionError(f"{cfg.arch_id} loss with kernel 11 {l1} vs chunked {l0}")
        _, warm0 = _timed(lambda: model.loss_fn(params, batch))
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        log(f"{cfg.family} loss forward {cfg.arch_id} {shapes}: with kernel 11 {l1:.6f}, "
            f"chunked {l0:.6f} (|diff| {abs(l1 - l0):.3e}, bound "
            f"{2e-3 * max(abs(l0), 1.0):.3e}); launches {_nonzero(launches)}, routes "
            f"{routes}; chunked path wall cold {cold0 * 1e3:.1f} ms, warm {warm0 * 1e3:.1f} ms")
    _profiled_loss(f"{cfg.family} (kernel 11)", kmodel, params, batch,
                   detail or _family_detail)
    del kmodel, batch
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def _mla_layer_split(model, params, device):
    """One layer's ``mla_train`` (the f32 latent attention and its bf16
    projections) and ``_mlp`` at the forward's shape, warm (second call),
    timed apart: (attention s, mlp s)."""
    import torch

    from repro_torch.models import blocks, mla
    from repro_torch.models.model import _layer

    cfg, ctx = model.cfg, model.ctx
    wl = _layer(params["blocks"], 0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    h = torch.randn((MLA_BATCH, MLA_SEQ, cfg.d_model), generator=gen, device=device,
                    dtype=torch.bfloat16)
    positions = torch.arange(MLA_SEQ, device=device)
    for _ in range(2):
        _, attn_s = _timed(lambda: mla.mla_train(h, wl["mla"], cfg, ctx, positions=positions))
    for _ in range(2):
        _, mlp_s = _timed(lambda: blocks._mlp(h, wl["mlp"], ctx))
    return attn_s, mlp_s


def _mla_forward(device):
    """minicpm3-4b at full width and depth from seed 0 (bf16): the loss
    forward at B=2, S=2048 (``_profiled_loss``, with the f32 and bf16
    GEMMs' device time; one layer's attention and MLP timed apart), the
    full-sequence logits against ``MLA_PREFILL_SEQ`` steps of ``decode_fn``
    in bf16 and with the weights cast to f32 (rel <= 0.05 in both), then
    ``serve --arch minicpm3-4b``."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.models.model import Model

    cfg = registry.get(MLA_ARCH, smoke=MLA_SMOKE)
    m = cfg.mla
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _timed(lambda: Model(cfg, device=device, seed=SEED))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != MLA_PARAMS:
        raise AssertionError(f"{cfg.arch_id}: {n_params} parameters, expected {MLA_PARAMS}")
    params = model.params()
    log(f"mla {_widths(cfg)}; MLA q_lora {m.q_lora_rank}, kv_lora {m.kv_lora_rank}, qk_nope "
        f"{m.qk_nope_head_dim}, qk_rope {m.qk_rope_head_dim}, v {m.v_head_dim}, mla_chunk "
        f"{cfg.mla_chunk}; vocab padded to {cfg.padded_vocab()}; {n_params} parameters "
        f"({sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB) "
        f"drawn from seed {SEED} in {init_s:.2f} s")
    warm, _ = _profiled_loss(
        "mla", model, params, next(SyntheticStream(cfg, MLA_BATCH, MLA_SEQ, seed=SEED)),
        lambda events, busy: "".join(
            f"; {k} {v:.1f} ms ({100 * v / max(busy, 1e-9):.1f} %)"
            for k, v in _gemm_split(events).items()))
    with torch.inference_mode():
        attn_s, mlp_s = _mla_layer_split(model, params, device)
        gflop = _mla_attention_gflop(cfg, MLA_BATCH, MLA_SEQ)
        log(f"mla one layer at B={MLA_BATCH} S={MLA_SEQ}, warm: mla_train "
            f"{attn_s * 1e3:.2f} ms ({gflop:.1f} GFLOP of f32 latent attention: "
            f"{gflop / attn_s / 1e3:.1f} TFLOP/s over the call), mlp {mlp_s * 1e3:.2f} ms; "
            f"x {cfg.n_layers} layers = "
            f"{cfg.n_layers * attn_s * 1e3:.1f} + {cfg.n_layers * mlp_s * 1e3:.1f} ms of the "
            f"{warm * 1e3:.1f} ms forward")

        # decode against prefill (one chunk: the whole cache), in bf16, then
        # with the weights cast to f32
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, MLA_PREFILL_SEQ)).astype(np.int32)).to(device)
        rel16, prefill16_s, decode16_s, *_ = _decode_vs_prefill(model, params, tokens)
        params32 = tree_map(lambda t: t.to(torch.float32), params)
        del model, params
        torch.cuda.empty_cache()
        model32 = Model(cfg, params=params32, device=device)
        rel, prefill_s, decode_s, cache, _ = _decode_vs_prefill(model32, params32, tokens)
        log(f"mla decode vs prefill {cfg.arch_id} B=2 S={MLA_PREFILL_SEQ}: bf16 weights max "
            f"rel err {rel16:.4e} (bound 0.05; prefill {prefill16_s * 1e3:.1f} ms, "
            f"{MLA_PREFILL_SEQ} decode steps {decode16_s * 1e3:.1f} ms = "
            f"{decode16_s * 1e3 / MLA_PREFILL_SEQ:.2f} ms/step); "
            f"f32 weights {rel:.4e} (bound 0.05; prefill {prefill_s * 1e3:.1f} ms, "
            f"{decode_s * 1e3 / MLA_PREFILL_SEQ:.2f} ms/step); cache {cache}")
        if not (rel <= 0.05 and rel16 <= 0.05):
            raise AssertionError(f"{cfg.arch_id}: decode/prefill mismatch: f32 rel {rel}, "
                                 f"bf16 rel {rel16}")
        del model32, params32
        torch.cuda.empty_cache()
    _serve_steps(cfg, MLA_SERVE_ARGV, MLA_SMOKE, device)


def _check_mla_f32_card_vs_cpu(device):
    """The smoke config with f32 weights (drawn on the CPU from seed 0) and
    one batch, on the card and on the CPU, through the chunked route (three
    chunks, the last padded) and the dense one: the two losses within rel
    ``MLA_F32_TOL`` (the function is the same on both devices: no TF32)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.models.model import Model

    smoke = registry.get(MLA_ARCH, smoke=True)
    params = tree_map(lambda t: t.to(torch.float32),
                      Model(smoke, device="cpu", seed=SEED).params())
    on_card = tree_map(lambda t: t.to(device), params)
    batch = next(SyntheticStream(smoke, 2, MLA_F32_SEQ, seed=SEED))
    for chunk in MLA_F32_CHUNKS:
        cfg = dataclasses.replace(smoke, mla_chunk=chunk)
        with torch.inference_mode():
            cpu = float(Model(cfg, params=params, device="cpu").loss_fn(params, batch))
            card = float(Model(cfg, params=on_card, device=device).loss_fn(on_card, batch))
        rel = abs(card - cpu) / abs(cpu)
        log(f"mla f32 {cfg.arch_id} mla_chunk {chunk} B=2 S={MLA_F32_SEQ}: loss on the card "
            f"{card:.9f}, on the CPU {cpu:.9f}, rel {rel:.3e} (bound {MLA_F32_TOL:g})")
        if not rel <= MLA_F32_TOL:
            raise AssertionError(f"{cfg.arch_id} f32 chunk {chunk}: card {card} vs CPU {cpu}, "
                                 f"rel {rel}")


def run_mla(device):
    """Phase 25 (module docstring).  Returns the kernels' launches of the
    minicpm3-4b train steps."""
    t0 = time.perf_counter()
    _mla_forward(device)
    _check_mla_f32_card_vs_cpu(device)
    launches = run_train_full_width(device, MLA_ARCH, MLA_TRAIN_LAYERS, MLA_TRAIN_LEAF)
    per_rank = {k: v / (2 * TRAIN_STEPS) for k, v in _nonzero(launches).items()}
    log(f"mla train step: both ranks' params and AdamW state equal by bits after every step, "
        f"no leaf flagged; kernel launches a step and rank {per_rank}")
    log(f"mla phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 26: the Mixture-of-Experts family
# ---------------------------------------------------------------------------

# full width (src/repro/configs/phi3_5_moe_42b.py, llama4_scout_17b_a16e.py);
# neither fits 80 GB whole (phi3.5-moe 83.75 GB of bf16 weights), so depth
# is cut, only as far as memory forces: (layers, parameters a layer, the
# rest: embed, unembed, final_norm)
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_SCOUT = "llama4-scout-17b-a16e"
# (the forward's peak at 24 layers 65.53 GB, 2.60 GB a layer; llama4-scout's
# at 12 layers 63.99 GB, 4.15 GB a layer: ~4 GB kept inside the card)
MOE_CUTS = {
    MOE_ARCH: (29, 1_300_307_968, 264_245_248),  # of 32 layers
    MOE_SCOUT: (15, 2_076_272_640, 2_070_942_720),  # of 48 layers
}
MOE_SMOKE = False
# 4096 tokens, as every forward's (``_family_loss``): phi3.5-moe's capacity 640
# slots an expert
MOE_BATCH, MOE_SEQ = MODEL_BATCH, MODEL_SEQ
MOE_PREFILL_SEQ = 128
MOE_F32_LAYERS = 12  # the f32-weight decode check: 62.4 GB of f32 weights
MOE_DECODE_NOTE = ("the reference's jitted bf16 decode leaves its prefill by 0.17 from 8 "
                   "layers on at d_model 128, nothing dropped; scripts/ssm_decode_drift.py "
                   "--archs phi3.5-moe-42b-a6.6b")
MOE_TRAIN_LAYERS = 1  # 1.565 B parameters a rank; 2 layers would need ~93 GB
MOE_TRAIN_LEAF = ("blocks", "moe", "wo")


def _moe_cfg(arch, **kw):
    """``arch`` at full width, depth cut to ``MOE_CUTS`` (the smoke config
    with ``MOE_SMOKE``), with the fields in ``kw``."""
    import dataclasses

    from repro_torch.configs import registry

    cfg = registry.get(arch, smoke=MOE_SMOKE)
    layers = cfg.n_layers if MOE_SMOKE else MOE_CUTS[arch][0]
    return dataclasses.replace(cfg, n_layers=layers, **kw)


def _moe_model(arch, device):
    """The cut model from seed 0 (bf16), its parameter count checked
    (``_family_model``)."""
    from repro_torch.configs import registry

    cfg = _moe_cfg(arch)
    layers, per_layer, rest = MOE_CUTS[arch]
    return _family_model(
        cfg, None if MOE_SMOKE else layers * per_layer + rest, device,
        f"; n_layers cut {registry.get(arch, smoke=MOE_SMOKE).n_layers} -> {cfg.n_layers}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, capacity factor {cfg.capacity_factor}")


def _moe_detail(cfg):
    """``_profiled_loss``'s detail for a moe forward at B, S = MOE_BATCH,
    MOE_SEQ: the f32 GEMMs' (the three expert contractions a layer, each
    (E, cap, d) x (E, d, ff), and the f32 unembed), the bf16 GEMMs' and
    the other device ms, and the f32 GEMMs' TFLOP/s."""
    from repro_torch.models.moe import moe_capacity

    t = MOE_BATCH * MOE_SEQ
    experts = 3 * 2 * cfg.n_experts * moe_capacity(t, cfg) * cfg.d_model * cfg.d_ff / 1e9
    unembed = 2 * t * cfg.d_model * cfg.padded_vocab() / 1e9
    gflop = experts * cfg.n_layers + unembed

    def detail(events, busy):
        split = _gemm_split(events)
        return "".join(f"; {k} {v:.1f} ms ({100 * v / max(busy, 1e-9):.1f} %)"
                       for k, v in split.items()) + \
            (f"; f32 GEMM work {gflop:.0f} GFLOP (the experts {experts:.0f} a layer, the "
             f"unembed {unembed:.0f}): {gflop / max(split['f32 GEMM'], 1e-9):.1f} TFLOP/s")

    return detail


@contextlib.contextmanager
def _counting_drops(record):
    """Append (dropped, slots) of each ``moe_route`` call to ``record``."""
    from repro_torch.models import moe

    real = moe.moe_route

    def wrapped(x, router, cfg, cap):
        r = real(x, router, cfg, cap)
        record.append((int((~r["keep"]).sum()), r["keep"].numel()))
        return r

    moe.moe_route = wrapped
    try:
        yield record
    finally:
        moe.moe_route = real


def _moe_decode_vs_prefill(model, params, tokens, device):
    """Decode steps against the full-sequence forward at ``capacity_factor
    = n_experts / top_k`` (cap = B·S: no slot drops, the same function as
    decode, whose B tokens fit cap 8 at any factor), and at the config's
    1.25 (its dropped share logged; not gated).  Returns (rel at the
    no-drop capacity, rel at 1.25, dropped, slots, decode s)."""
    import dataclasses

    from repro_torch.models.model import Model

    cfg = model.cfg
    nodrop = Model(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k),
                   params=params, device=device)
    got, decode_s, _ = _decode_logits(nodrop, params, tokens)
    drops = []
    with _counting_drops(drops):
        want = _forward_logits(nodrop, params, tokens)
    if any(d for d, _ in drops):
        raise AssertionError(f"{cfg.arch_id}: the no-drop prefill dropped {drops}")
    rel = float((got - want).abs().max() / want.abs().max())
    drops.clear()
    with _counting_drops(drops):
        want125 = _forward_logits(model, params, tokens)
    rel125 = float((got - want125).abs().max() / want125.abs().max())
    return rel, rel125, sum(d for d, _ in drops), sum(n for _, n in drops), decode_s


@contextlib.contextmanager
def _registry_cut(arch, layers):
    """``registry.get(arch)`` (full size) returns the config cut to
    ``layers``: ``serve`` at full width on one card."""
    import dataclasses

    from repro_torch.configs import registry

    real = registry.get

    def get(arch_id, *, smoke=False):
        cfg = real(arch_id, smoke=smoke)
        return dataclasses.replace(cfg, n_layers=layers) if arch_id == arch and not smoke \
            else cfg

    registry.get = get
    try:
        yield
    finally:
        registry.get = real


def _moe_forward(device):
    """phi3.5-moe at full width, the stated depth (``MOE_CUTS``), bf16 from
    seed 0: the loss forward at B=2, S=2048 through kernel 11 (one launch a
    layer) and through the chunked path (``_family_loss``, with the f32
    expert GEMMs' device ms and TFLOP/s); decode against prefill at S=128
    (``_moe_decode_vs_prefill``; logged: bf16 drifts with depth in the
    reference too, ``MOE_DECODE_NOTE``; ``_moe_f32_decode`` gates).
    Returns kernel 11's launches in the loss forward, the bf16 decode rel
    and the model's depth."""
    import numpy as np
    import torch

    model, params = _moe_model(MOE_ARCH, device)
    cfg = model.cfg
    flash = _family_loss(model, params, cfg.n_layers, _moe_detail(cfg))

    with torch.inference_mode():
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, MOE_PREFILL_SEQ)).astype(np.int32)).to(device)
        rel, rel125, dropped, slots, decode_s = _moe_decode_vs_prefill(model, params, tokens,
                                                                       device)
    log(f"moe decode vs prefill {cfg.arch_id} B=2 S={MOE_PREFILL_SEQ}, bf16 weights: at "
        f"capacity factor {cfg.n_experts / cfg.top_k:g} (nothing drops) max rel err "
        f"{rel:.4e} (not gated: {MOE_DECODE_NOTE}); at the config's {cfg.capacity_factor} "
        f"the prefill drops {dropped} of {slots} slots ({100 * dropped / slots:.2f} %) and "
        f"the gap is {rel125:.4e} (not gated); {MOE_PREFILL_SEQ} decode steps "
        f"{decode_s * 1e3:.1f} ms ({decode_s * 1e3 / MOE_PREFILL_SEQ:.2f} ms/step)")
    del model, params
    torch.cuda.empty_cache()
    return flash, rel, cfg.n_layers


def _moe_f32_decode(device, rel16):
    """phi3.5-moe with f32 weights (drawn in bf16 from seed 0, then cast
    leaf by leaf) at ``MOE_F32_LAYERS``: decode against prefill at the
    no-drop capacity, rel <= 0.05 (the gate, as C17 allows: bf16 drifts
    with depth in the reference too)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models.model import Model

    cfg = _moe_cfg(MOE_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=min(MOE_F32_LAYERS, cfg.n_layers))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params32 = Model(cfg, device=device, seed=SEED).params()

    def cast(tree):  # leaf by leaf: the bf16 and f32 copies never whole at once
        for k, v in tree.items():
            tree[k] = cast(v) if isinstance(v, dict) else v.detach().to(torch.float32)
        return tree

    cast(params32)
    model = Model(cfg, params=params32, device=device)
    with torch.inference_mode():
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, MOE_PREFILL_SEQ)).astype(np.int32)).to(device)
        rel, rel125, dropped, slots, decode_s = _moe_decode_vs_prefill(model, params32, tokens,
                                                                       device)
    log(f"moe decode vs prefill {cfg.arch_id} at {cfg.n_layers} layers, f32 weights: max rel "
        f"err {rel:.4e} at the no-drop capacity (bound 0.05, gated; bf16 at the cut depth "
        f"{rel16:.4e}, logged); at {cfg.capacity_factor} {dropped} of {slots} slots dropped, "
        f"gap {rel125:.4e}; {decode_s * 1e3 / MOE_PREFILL_SEQ:.2f} ms/step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not rel <= 0.05:
        raise AssertionError(f"{cfg.arch_id}: decode/prefill mismatch in f32: rel {rel}")
    del model, params32
    torch.cuda.empty_cache()


def _moe_scout_forward(device):
    """llama4-scout (top-1: no gate renormalisation; d_model 5120, 40
    heads, d_ff 8192, vocab 202048) at full width and the stated depth,
    bf16 from seed 0: the loss forward at B=2, S=2048, finite; walls, busy
    and the GEMM split of one profiled call."""
    import torch

    from repro_torch.data.pipeline import SyntheticStream

    model, params = _moe_model(MOE_SCOUT, device)
    _profiled_loss("moe", model, params,
                   next(SyntheticStream(model.cfg, MOE_BATCH, MOE_SEQ, seed=SEED)),
                   _moe_detail(model.cfg))
    del model, params
    torch.cuda.empty_cache()


def run_moe(device):
    """Phase 26 (module docstring).  Returns kernel 11's launches in the
    phi3.5-moe loss forward and the kernels' launches of the train
    steps."""
    import torch

    from repro_torch.configs import registry

    t0 = time.perf_counter()
    flash, rel16, layers = _moe_forward(device)
    # serving: the entry point on the card (smoke), then its greedy loop at
    # full width and the stated depth (32 layers need two cards: A11.7)
    _serve_steps(registry.get(MOE_ARCH, smoke=True), ["--arch", MOE_ARCH], True, device)
    torch.cuda.reset_peak_memory_stats()
    with _registry_cut(MOE_ARCH, layers):
        _serve_steps(_moe_cfg(MOE_ARCH), ["--arch", MOE_ARCH], MOE_SMOKE, device)
    log(f"moe serve peak memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    _moe_f32_decode(device, rel16)
    _moe_scout_forward(device)
    for arch in MOE_CUTS:  # f32 weights, cfg.dtype as the config has it (bf16)
        _check_f32_card_vs_cpu(arch, device, dtype=None)
    launches = run_train_full_width(device, MOE_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_LEAF)
    per_rank = {k: v / (2 * TRAIN_STEPS) for k, v in _nonzero(launches).items()}
    log(f"moe train step: both ranks' params and AdamW state equal by bits after every step, "
        f"no leaf flagged; kernel launches a step and rank {per_rank}")
    log(f"moe phase: {time.perf_counter() - t0:.1f} s")
    return flash, launches


# ---------------------------------------------------------------------------
# Phases 27-28: the encoder-decoder and prefix-frontend families
# ---------------------------------------------------------------------------

# full width and depth (src/repro/configs/seamless_m4t_medium.py): 12
# encoder and 12 decoder layers, d_model 1024, 16 heads of 64, d_ff 4096,
# vocab 256206 padded to 256512, 1024 encoder frames
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_PARAMS = 978_384_896
ENCDEC_SMOKE = False
ENCDEC_PREFILL_SEQ = 128
ENCDEC_TRAIN_LEAF = ("blocks", "cross", "wo")
# kernel 11 at the encdec path's shapes (H=16, D=64): the forward's three,
# then a decode step's cross attention (one query row over every encoder
# frame, serve's batch) on both routes: (label, B, Sq, Sk, causal, dtypes)
ENCDEC_FLASH_SHAPES = (("encoder", 2, 1024, 1024, False, ("bfloat16",)),
                       ("decoder", 2, 2048, 2048, True, ("bfloat16",)),
                       ("cross", 2, 2048, 1024, False, ("bfloat16",)),
                       ("decode cross", 4, 1, 1024, False, ("bfloat16", "float32")))
# full width and depth (src/repro/configs/internvl2_26b.py): 48 layers,
# d_model 6144, 48 heads over 8 kv of 128, d_ff 16384, vocab 92553 padded
# to 92672, 256 prefix positions before the text (internlm2-20b's tree)
VLM_ARCH = "internvl2-26b"
VLM_PARAMS = 19_862_722_560
VLM_SMOKE = False
VLM_PREFILL_SEQ = 128
FAMILY_F32_SEQ = 128
FAMILY_F32_TOL = 1e-5


def _family_model(cfg, n_want, device, note=""):
    """The model of ``cfg``, bf16 from seed 0, on a freed card; its
    parameter count checked against ``n_want`` (where given); ``note``
    goes into the log line after the widths."""
    import torch

    from repro_torch.models.model import Model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _timed(lambda: Model(cfg, device=device, seed=SEED))
    n_params = sum(p.numel() for p in model.parameters())
    if n_want is not None and n_params != n_want:
        raise AssertionError(f"{cfg.arch_id}: {n_params} parameters, expected {n_want}")
    log(f"{cfg.family} {_widths(cfg)}{note}; vocab padded to {cfg.padded_vocab()}; {n_params} "
        f"parameters ({sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f}"
        f" GB bf16) drawn from seed {SEED} in {init_s:.2f} s")
    return model, model.params()


def _check_encdec_flash_shapes(device):
    """Kernel 11 at the encdec path's shapes (``ENCDEC_FLASH_SHAPES``), in
    each dtype given: against its plain version (``FLASH_TOL``) on the
    route the dtype takes (counted), then timed (median of 20 event pairs
    around 10 calls) beside SDPA, the plain version (median of 3 calls)
    and the bound (4·D FLOPs a (query, key) pair that sees its key at the
    dtype's peak, 989.4 TFLOP/s in bf16, 67 in f32; q, k, v and o once
    at 3.35 TB/s)."""
    import torch

    from repro_torch.kernels import flash_attn

    gen = torch.Generator(device=device).manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, d = 16, 64
    cases = [(label, b, sq, sk, causal, dtype)
             for label, b, sq, sk, causal, dtypes in ENCDEC_FLASH_SHAPES for dtype in dtypes]
    for label, b, sq, sk, causal, dtype in cases:
        route = "tensor_core_bf16" if dtype == "bfloat16" else "cuda_core_f32"
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device).to(dt)
                   for s in (sq, sk, sk))
        flash_attn.reset_launch_counts()
        got = flash_attn.flash_attention(q, k, v, causal=causal)
        routes = dict(flash_attn.ROUTES)
        want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
        tol = FLASH_TOL[dtype]
        diff = (got.float() - want.float()).abs()
        bad = int((diff > tol + tol * want.float().abs()).sum())
        if routes != {"tensor_core_bf16": 0, "cuda_core_f32": 0, route: 1}:
            raise AssertionError(f"flash_attention [{label} {dtype}] took routes {routes}")
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention [{label} {dtype}] disagrees with its plain "
                                 f"version: {bad} outside")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops = 4 * b * h * d * (sq * (sq + 1) // 2 if causal else sq * sk)
        nbytes = q.element_size() * b * h * d * (2 * sq + 2 * sk)
        peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
        bound = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = _median_ms(lambda: flash_attn.flash_attention(q, k, v, causal=causal), 20, 10)
        lib_ms = _median_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), 20, 10)
        plain_ms = _median_ms(
            lambda: flash_attn.flash_attention_plain(q, k, v, causal=causal), 3)
        log(f"kernel 11 at the encdec {label} shape B={b} Sq={sq} Sk={sk} H={h} D={d} {dtype} "
            f"causal={causal}, {route} route: max |err| vs plain {float(diff.max()):.3e} "
            f"(atol = rtol = {tol:g}); kernel {ms:.4f} ms, SDPA {lib_ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; {100 * bound / ms:.1f} % of the bound)")
        del q, k, v, qt, kt, vt, got, want, diff
    torch.cuda.empty_cache()


def _encdec_decode(model, params, device):
    """seamless-m4t-medium's full-sequence logits at S=128 (1024 encoder
    frames) against 128 ``decode_fn`` steps, both through kernel 11, in bf16
    and with the weights and ``cfg.dtype`` in f32: rel <= 0.05 in both;
    kernel 11 launched once a decoder layer in each step (the cross
    attention, Sq = 1 over Sk = 1024)."""
    import dataclasses

    import torch

    from repro_torch.convert import tree_map
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.models.model import Model

    cfg = model.cfg
    batch = next(SyntheticStream(cfg, 2, ENCDEC_PREFILL_SEQ, seed=SEED))
    tokens = torch.from_numpy(batch["tokens"]).to(device)
    enc_input = torch.from_numpy(batch["enc_input"]).to(device)
    pre_want = cfg.n_enc_layers + 2 * cfg.n_layers
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = params if dtype == "bfloat16" else tree_map(lambda t: t.to(torch.float32), params)
        kmodel = Model(dataclasses.replace(cfg, dtype=dtype, use_flash_kernel=True), params=p,
                       device=device)
        _reset_launches()
        with torch.inference_mode():
            rel, prefill_s, decode_s, _, (pre, dec) = _decode_vs_prefill(
                kmodel, p, tokens, enc_input=enc_input)
        if (pre, dec) != (pre_want, ENCDEC_PREFILL_SEQ * cfg.n_layers):
            raise AssertionError(f"{cfg.arch_id} {dtype}: kernel 11 launched {pre} times in "
                                 f"the prefill, {dec} in the decode steps")
        out[dtype] = rel
        log(f"encdec decode vs prefill {cfg.arch_id} B=2 S={ENCDEC_PREFILL_SEQ} S_enc "
            f"{cfg.n_prefix}, {dtype} weights and cfg.dtype: max rel err {rel:.4e} (bound "
            f"0.05); prefill {prefill_s * 1e3:.1f} ms ({pre} kernel 11 launches), "
            f"{ENCDEC_PREFILL_SEQ} decode steps {decode_s * 1e3:.1f} ms "
            f"({decode_s * 1e3 / ENCDEC_PREFILL_SEQ:.2f} ms/step, "
            f"{dec // ENCDEC_PREFILL_SEQ} kernel 11 launches a step)")
        del p, kmodel
        torch.cuda.empty_cache()
    if not all(r <= 0.05 for r in out.values()):
        raise AssertionError(f"{cfg.arch_id}: decode/prefill mismatch {out}")


def _check_f32_card_vs_cpu(arch, device, dtype="float32"):
    """``arch``'s smoke config with f32 weights (drawn on the CPU from seed
    0), ``cfg.dtype`` set to ``dtype`` (None: the config's), and one batch,
    on the card and on the CPU: the two losses within rel
    ``FAMILY_F32_TOL`` (the function is the same on both devices: no
    TF32)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.models.model import Model

    cfg = registry.get(arch, smoke=True)
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype)
    params = tree_map(lambda t: t.to(torch.float32), Model(cfg, device="cpu", seed=SEED).params())
    on_card = tree_map(lambda t: t.to(device), params)
    prefix = cfg.n_prefix if cfg.family in ("vlm", "audio") else 0
    batch = next(SyntheticStream(cfg, 2, FAMILY_F32_SEQ + prefix, seed=SEED))
    with torch.inference_mode():
        cpu = float(Model(cfg, params=params, device="cpu").loss_fn(params, batch))
        card = float(Model(cfg, params=on_card, device=device).loss_fn(on_card, batch))
    rel = abs(card - cpu) / abs(cpu)
    log(f"{cfg.family} f32 {cfg.arch_id} {({k: tuple(v.shape) for k, v in batch.items()})}: "
        f"loss on the card {card:.9f}, on the CPU {cpu:.9f}, rel {rel:.3e} (bound "
        f"{FAMILY_F32_TOL:g})")
    if not rel <= FAMILY_F32_TOL:
        raise AssertionError(f"{cfg.arch_id} f32: card {card} vs CPU {cpu}, rel {rel}")


def run_encdec(device):
    """Phase 27 (module docstring).  Returns kernel 11's launches in the
    seamless-m4t-medium loss forward and the kernels' launches of its train
    steps."""
    import torch

    from repro_torch.configs import registry

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    _check_encdec_flash_shapes(device)
    model, params = _family_model(registry.get(ENCDEC_ARCH, smoke=ENCDEC_SMOKE), ENCDEC_PARAMS,
                                  device)
    cfg = model.cfg
    flash = _family_loss(model, params, cfg.n_enc_layers + 2 * cfg.n_layers)
    _encdec_decode(model, params, device)
    del model, params
    torch.cuda.empty_cache()
    _serve_steps(cfg, ["--arch", ENCDEC_ARCH], ENCDEC_SMOKE, device)
    _check_f32_card_vs_cpu(ENCDEC_ARCH, device)
    launches = run_train_full_width(device, ENCDEC_ARCH, None, ENCDEC_TRAIN_LEAF)
    per_rank = {k: v / (2 * TRAIN_STEPS) for k, v in _nonzero(launches).items()}
    log(f"encdec train step: both ranks' params and AdamW state equal by bits after every "
        f"step, no leaf flagged; kernel launches a step and rank {per_rank}")
    log(f"encdec phase: {time.perf_counter() - t0:.1f} s")
    return flash, launches


def run_vlm(device):
    """Phase 28 (module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    model, params = _family_model(registry.get(VLM_ARCH, smoke=VLM_SMOKE), VLM_PARAMS, device)
    cfg = model.cfg
    _family_loss(model, params, cfg.n_layers)
    # decode against prefill over text tokens (the reference's decode has
    # no prefix path), the prefill through kernel 11
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, VLM_PREFILL_SEQ)).astype(np.int32)).to(device)
    kmodel = Model(dataclasses.replace(cfg, use_flash_kernel=True), params=params,
                   device=device)
    with torch.inference_mode():
        rel, prefill_s, decode_s, cache, _ = _decode_vs_prefill(model, params, tokens,
                                                                prefill=kmodel)
    log(f"vlm decode vs prefill {cfg.arch_id} B=2 S={VLM_PREFILL_SEQ} text tokens, bf16: max "
        f"rel err {rel:.4e} (bound 0.05); prefill through kernel 11 {prefill_s * 1e3:.1f} ms, "
        f"{VLM_PREFILL_SEQ} decode steps {decode_s * 1e3:.1f} ms "
        f"({decode_s * 1e3 / VLM_PREFILL_SEQ:.2f} ms/step); cache {cache}")
    if not rel <= 0.05:
        raise AssertionError(f"{cfg.arch_id}: decode/prefill mismatch: rel {rel}")
    del model, kmodel, params
    torch.cuda.empty_cache()
    _serve_steps(cfg, ["--arch", VLM_ARCH], VLM_SMOKE, device)
    _check_f32_card_vs_cpu(VLM_ARCH, device)
    log(f"vlm phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 29: the FSDP train step
# ---------------------------------------------------------------------------

FSDP_EB = 1e-4  # the reference's fsdp_gz: GZConfig(eb, algo="ring") (src/repro/launch/dryrun.py)
FSDP_CHECK_LEAF = ("blocks", "mlp", "wo")  # gathered along dim 1
FSDP_SMOKE_N = 4  # ranks of the smoke check: the ring has N - 2 hops (kernel 2)
FSDP_SMOKE_BATCH, FSDP_SMOKE_SEQ = 4, 64
REPLICATED_PEAK_GB = 65.71  # phase 19's step with the weights replicated (PERF.md §5)
FSDP_STEP_PEAK_GB = 10.74  # phase 32's process through FsdpStep, before A11.8 (PERF.md §5)


def _leaf_paths(tree, prefix=()):
    """Each leaf's key path, in ``tree_flatten``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], prefix + (k,))]
    return [prefix]


def _fsdp_uses(setup):
    """[(leaf number, data dim, number of gathers a step, the gathered
    slice's shape)] of every sharded leaf: a leaf of the stacked layers is
    gathered once a layer, along its slice's dim."""
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.launch import training

    out = []
    defs = tree_flatten(setup.defs)[0]
    specs = training._leaf_specs(setup.defs, setup.specs)
    for i, (d, spec, path) in enumerate(zip(defs, specs, _leaf_paths(setup.defs))):
        dim = training._data_dim(spec, setup.ctx.fsdp_axis)
        if dim is None:
            continue
        if path[0] in ("blocks", "enc_blocks"):
            out.append((i, dim - 1, d.shape[0], tuple(d.shape[1:])))
        else:
            out.append((i, dim, 1, tuple(d.shape)))
    return out


def _fsdp_comm(sync, n, device):
    """The communicator ``grad_sync`` plans the FSDP collectives with
    (auto depth), sized to ``n`` ranks so that it plans off the ranks."""
    from repro_torch.core.comm import GZCommunicator

    return GZCommunicator.for_config("data", sync.gz, axis_size=n, device=device,
                                     auto_depth=True)


def _local_shapes(setup, sizes):
    """Each leaf's shape on one rank of a mesh of extents ``sizes``."""
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.launch import training

    return [tuple(x // math.prod(sizes[ax] for ax in training._axes_in_spec((e,)))
                  for x, e in zip(d.shape, spec))
            for d, spec in zip(tree_flatten(setup.defs)[0],
                               training._leaf_specs(setup.defs, setup.specs))]


def _rank_buckets(setup, sizes):
    """The bucket hooks' plan on one rank (``training._bucket_plan`` of the
    rank's local leaves): [(ops, [leaf number, ...])]."""
    import torch

    from repro_torch.launch import training

    leaves = [torch.empty(s, device="meta") for s in _local_shapes(setup, sizes)]
    return training._bucket_plan(leaves, training._leaf_specs(setup.defs, setup.specs),
                                 tuple(setup.mesh.axis_names), dict(setup.grad_comms),
                                 setup.bucket_bytes)


def _fsdp_plan_launches(setup, sizes, device, regather=False):
    """Kernel launches of one FSDP train step on one rank, from the
    schedules: every gather (``allgather`` of the rank's slice; with
    ``regather``, the in-backward route's, a layer's gathers once more in
    remat's recompute) and every reduce-scatter (of the gathered slice's
    cotangent) of every leaf sharded over ``data``, and the ``data``
    allreduces of the gradient sync at the rank's local shapes (``sizes``:
    the mesh's axis extents; a ``model`` extent above 1 splits them): one
    a leaf it replicates, or under ``setup.overlap_sync`` one a bucket
    (the f32 vector of its leaves).  The ``data`` group's ranks launch
    alike: ``_expected_launches`` counts over all of them."""
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.launch import training
    from repro_torch.models.parallel import torch_dtype

    n = sizes["data"]
    # no fsdp_sync: exact gathers and reduce-scatters, which launch no kernel
    sync = setup.ctx.fsdp_sync
    comm = None if sync is None else _fsdp_comm(sync, n, device)
    gcomm = dict(setup.grad_comms).get("data")
    specs = training._leaf_specs(setup.defs, setup.specs)
    total = dict.fromkeys(_launches(), 0)

    def split(entries):
        return math.prod(sizes[ax] for ax in training._axes_in_spec(entries))

    def add(plan, times=1):
        for k, v in _expected_launches(plan, n).items():
            total[k] += times * v

    paths = _leaf_paths(setup.defs)
    for leaf, _, uses, shape in _fsdp_uses(setup) if comm is not None else ():
        gathered = math.prod(shape) * n // split(specs[leaf])  # the rank's gathered slice
        recomputed = regather and setup.ctx.remat != "none" and \
            paths[leaf][0] in ("blocks", "enc_blocks")
        add(comm.plan("allgather", gathered // n), uses * (2 if recomputed else 1))
        add(comm.plan("reduce_scatter", gathered), uses)
    local = _local_shapes(setup, sizes)
    if gcomm is not None and setup.overlap_sync:
        for ops, idx in _rank_buckets(setup, sizes):
            if ("data", gcomm) in ops:
                add(gcomm.plan("allreduce", sum(math.prod(local[i]) for i in idx)))
    elif gcomm is not None:
        for d, spec, shape in zip(tree_flatten(setup.defs)[0], specs, local):
            if training._data_dim(spec, "data") is None:
                add(gcomm.plan("allreduce", shape, torch_dtype(d.dtype)))
    if any(v % n for v in total.values()):
        raise AssertionError(f"the plans' launches {_nonzero(total)} do not split over {n} "
                             f"ranks")
    return {k: v // n for k, v in total.items()}


@contextlib.contextmanager
def _watched_fsdp(record):
    """Wrap the FSDP step's pieces: every communicator call's degraded flag
    into ``record["flags"]``; while ``record["keep_gathers"]``, each rank's
    gathered weights by (rank, leaf, slice); for ``record["leaf"]`` (a
    leaf number) each rank's recorded cotangents of slice 0 (f32) and its
    reduce-scattered gradient of slice 0; while ``record["keep_records"]``,
    each rank's recorded (dim, cotangent) pairs."""
    from repro_torch.core.comm import GZCommunicator
    from repro_torch.core.grad_sync import FsdpStep

    run, gather, scatter = GZCommunicator._run, FsdpStep._gather, FsdpStep.reduce_scatter
    lock = threading.Lock()

    def watched_run(self, op, *a, **kw):
        res = run(self, op, *a, **kw)
        with lock:
            record["flags"].append((op, res.overflow | res.nonfinite))
        return res

    def watched_gather(self, x, dim, key):
        out = gather(self, x, dim, key)
        if record.get("keep_gathers"):
            leaf, index, _ = self._where[key]
            with lock:
                record["gathers"][(self.group.rank, leaf, index)] = self._memo[key]
        return out

    def watched_scatter(self, grads):
        rank, leaf = self.group.rank, record.get("leaf")
        mine = [(key, ct) for key, ct in self._records if self._where[key][:2] == (leaf, 0)]
        if record.get("keep_records"):
            with lock:
                record["records"][rank] = [(key[-1], ct) for key, ct in self._records]
        out = scatter(self, grads)
        if mine:
            with lock:
                record["leaf_cts"][rank] = [ct.float() for _, ct in mine]
                record["leaf_out"][rank] = out[leaf][0].float().clone()
        return out

    GZCommunicator._run, FsdpStep._gather = watched_run, watched_gather
    FsdpStep.reduce_scatter = watched_scatter
    try:
        yield record
    finally:
        GZCommunicator._run, FsdpStep._gather = run, gather
        FsdpStep.reduce_scatter = scatter


@contextlib.contextmanager
def _watched_in_backward(record, setup, params):
    """``_watched_fsdp`` for the in-backward route, in one process of a
    ``DistMesh`` whose rank holds ``params``: every communicator call's
    degraded flag into ``record["flags"]``; every gather
    (``fsdp_all_gather``'s forward, remat's regathers included) counted in
    ``record["n_gathers"]``; while ``record["keep_gathers"]``, the first
    gathered weight of each (leaf, slice) held at once against its slice
    of ``record["block"]`` (the leaves before their split over ``data``:
    the largest error past one bf16 rounding, the allgather's eb, a
    digest) into ``record["gathers"]``, and then dropped; for
    ``record["leaf"]``
    the cotangent of its slice 0 (f32) and its reduce-scattered gradient,
    in the leaf's layout, from the gather's backward."""
    from repro_torch.core import error_budget, grad_sync
    from repro_torch.core.comm import GZCommunicator
    from repro_torch.core.grad_sync import tree_flatten

    leaves = tree_flatten(params)[0]
    dims = {leaf: dim for leaf, dim, _, _ in _fsdp_uses(setup)}
    comm = _fsdp_comm(setup.ctx.fsdp_sync, setup.ctx.fsdp_size, leaves[0].device)
    by_storage = {leaves[i].untyped_storage().data_ptr(): i for i in dims}
    run, fn = GZCommunicator._run, grad_sync._FsdpAllGather
    forward, backward = fn.forward, fn.backward

    def slot(x):
        """(leaf, slice index or None) of a gathered shard, by its storage."""
        i = by_storage.get(x.untyped_storage().data_ptr())
        if i is None:
            return None
        leaf = leaves[i]
        if x.numel() == leaf.numel():
            return i, None
        return i, (x.storage_offset() - leaf.storage_offset()) // leaf.stride(0)

    def watched_run(self, op, *a, **kw):
        res = run(self, op, *a, **kw)
        record["flags"].append((op, res.overflow | res.nonfinite))
        return res

    def watched_forward(ctx, x, axis_name, sync):
        out = forward(ctx, x, axis_name, sync)
        ctx.slot = slot(x)
        record["n_gathers"] += 1
        if record.get("keep_gathers") and ctx.slot and ctx.slot not in record["gathers"]:
            leaf, index = ctx.slot
            w = record["block"][leaf] if index is None else record["block"][leaf][index]
            w = (w.movedim(dims[leaf], 0) if dims[leaf] else w).float()
            eb = error_budget.lossy_hops("allgather_ring", ctx.g.size) * \
                comm.plan("allgather", w.numel() // ctx.g.size).eb_stage
            over = ((out.float() - w).abs() - 2.0 ** -8 * w.abs()).max().item()
            record["gathers"][ctx.slot] = {"over": over, "eb": eb, "digest": _digest(out)}
        return out

    def watched_backward(ctx, ct):
        out = backward(ctx, ct)
        if ctx.slot == (record.get("leaf"), 0):
            record["leaf_cts"][ctx.g.rank] = [ct.float()]
            record["leaf_out"][ctx.g.rank] = out[0].movedim(0, dims[ctx.slot[0]]).float()
        return out

    GZCommunicator._run = watched_run
    fn.forward, fn.backward = staticmethod(watched_forward), staticmethod(watched_backward)
    try:
        yield record
    finally:
        GZCommunicator._run = run
        fn.forward, fn.backward = staticmethod(forward), staticmethod(backward)


@contextlib.contextmanager
def _watched_buckets(record):
    """Wrap the bucket hooks' sync (``training._sync_bucket``): each call's
    health bit into ``record["bucket_flags"]``, and while
    ``record["keep_buckets"]`` each call with a collective as (ops, its f32
    vector, the synced vector) into ``record["buckets"]``.
    ``record["real"]`` is the unwrapped function."""
    from repro_torch.launch import training

    real = record["real"] = training._sync_bucket

    def wrapped(vec, ops, handles):
        out, flag = real(vec, ops, handles)
        record["bucket_flags"].append(flag)
        if ops and record.get("keep_buckets"):
            record["buckets"].append((ops, vec.clone(), out.clone()))
        return out, flag

    training._sync_bucket = wrapped
    try:
        yield record
    finally:
        training._sync_bucket = real


def _check_fsdp_gathers(setup, whole, record, n, device):
    """The recorded ranks' gathered weights equal by bits, each within the
    allgather's eb (plus one bf16 rounding of the weight) of its slice of
    ``whole``: the weights before their split over ``data`` (the global
    ones, or a tensor-parallel rank's block of them)."""
    from repro_torch.core import error_budget
    from repro_torch.core.grad_sync import tree_flatten

    comm = _fsdp_comm(setup.ctx.fsdp_sync, n, device)
    leaves = tree_flatten(whole)[0]
    ranks = sorted({r for r, _, _ in record["gathers"]})
    worst, count = 0.0, 0
    for leaf, dim, uses, shape in _fsdp_uses(setup):
        for index in range(uses) if leaves[leaf].dim() > len(shape) else [None]:
            fulls = [record["gathers"][(r, leaf, index)] for r in ranks]
            w = leaves[leaf] if index is None else leaves[leaf][index]
            w = (w.movedim(dim, 0) if dim else w).float()
            plan = comm.plan("allgather", w.numel() // n)
            eb = error_budget.lossy_hops("allgather_ring", n) * plan.eb_stage
            if not all(_tree_equal(fulls[0], f) for f in fulls[1:]):
                raise AssertionError(f"FSDP gather of leaf {leaf} slice {index}: the ranks differ")
            over = ((fulls[0].float() - w).abs() - 2.0 ** -8 * w.abs()).max().item()
            if not over <= eb:
                raise AssertionError(f"FSDP gather of leaf {leaf} slice {index}: error past "
                                     f"one bf16 rounding {over} > eb {eb}")
            worst, count = max(worst, over), count + 1
    return worst, count


def _check_fsdp_leaf(setup, record, n, device, label="fsdp"):
    """The reduce-scattered gradient of ``FSDP_CHECK_LEAF``'s first layer
    on each recorded rank within the reduce-scatter's bound of the exact
    rank-order sum of the ``n`` ranks' recorded cotangents.  Returns the
    error and the bound."""
    from repro_torch.core import error_budget

    cts = [record["leaf_cts"][r][0] for r in range(n)]
    exact = cts[0].double()
    for ct in cts[1:]:
        exact = exact + ct.double()
    plan = _fsdp_comm(setup.ctx.fsdp_sync, n, device).plan("reduce_scatter", exact.numel())
    hops = error_budget.lossy_hops("reduce_scatter_ring", n)
    dim = [u[1] for u in _fsdp_uses(setup) if u[0] == record["leaf"]][0]
    rows = exact.shape[0] // n
    err = 0.0
    for r, out in record["leaf_out"].items():
        want = exact[r * rows:(r + 1) * rows]
        want = want.movedim(0, dim) if dim else want
        err = max(err, (out.double() - want).abs().max().item())
    # the reduce-scatter's bound, then the cast of its f32 result to bf16
    bound = hops * plan.eb_stage + 2.0 ** -8 * exact.abs().max().item()
    log(f"{label} reduce-scattered {'.'.join(FSDP_CHECK_LEAF)} (layer 0, gathered along dim "
        f"{dim}, cotangent {tuple(cts[0].shape)}): max error {err:.3e} vs the exact rank-order "
        f"sum, bound {bound:.3e} (plan {plan.algo}/{plan.pipeline_chunks}, eb_stage "
        f"{plan.eb_stage:.3e}, {hops} lossy hops); max |g| {exact.abs().max().item():.3e}")
    if not err <= bound:
        raise AssertionError(f"reduce-scattered {FSDP_CHECK_LEAF}: error {err} > bound {bound}")
    return err, bound


def _fsdp_step_replicas(setup, params, opt, label):
    """The ranks' replicated leaves and their AdamW moments equal by bits."""
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.launch import training

    specs = training._leaf_specs(setup.defs, setup.specs)
    rep = [i for i, s in enumerate(specs) if training._data_dim(s, "data") is None]
    for r in range(1, len(params)):
        for tree_a, tree_b in ((params[0], params[r]), (opt[0]["mu"], opt[r]["mu"]),
                               (opt[0]["nu"], opt[r]["nu"])):
            la, lb = tree_flatten(tree_a)[0], tree_flatten(tree_b)[0]
            if not all(_tree_equal(la[i], lb[i]) for i in rep):
                raise AssertionError(f"{label}: rank {r}'s replicated leaves or moments differ")
        if int(opt[0]["step"]) != int(opt[r]["step"]):
            raise AssertionError(f"{label}: the ranks' step counts differ")
    return len(rep)


def run_fsdp_full_width(device):
    """Phase 29's main path (module docstring).  Returns the kernels'
    launches over the ``TRAIN_STEPS`` steps."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.core import grad_sync, transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch import shapes, training
    from repro_torch.launch.mesh import ThreadMesh
    from repro_torch.models.parallel import init_params
    from repro_torch.optim.adamw import adamw_init

    n = 2
    full = registry.get(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    mesh = ThreadMesh((n, 1), ("data", "model"), device)
    setup = training.make_setup(cfg, mesh, remat="full",
                                fsdp_gz=GZConfig(eb=FSDP_EB, algo="ring"),
                                grad_gz=GZConfig(eb=TRAIN_EB, algo="ring"))
    if setup.ctx.fsdp_size != n:
        raise AssertionError(f"fsdp_size {setup.ctx.fsdp_size}")
    _, bspecs = shapes.train_specs(
        cfg, shapes.InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh)
    step = training.make_train_step(setup, bspecs)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    whole = init_params(setup.defs, gen, device)
    sizes, coords = {"data": n, "model": 1}, training._coords(mesh)
    params = [tree_map(torch.clone, training._local(whole, setup.specs, c, sizes))
              for c in coords]
    opt = [adamw_init(p) for p in params]
    torch.cuda.synchronize()
    uses = _fsdp_uses(setup)
    n_global = sum(math.prod(d.shape) for d in
                   grad_sync.tree_flatten(setup.defs)[0])
    n_rank = sum(p.numel() for p in grad_sync.tree_flatten(params[0])[0])
    log(f"fsdp {_widths(cfg)} as published; n_layers cut {full.n_layers} -> {cfg.n_layers}; "
        f"{n_global} parameters, {n_rank} a rank (bf16), {len(uses)} sharded leaves, "
        f"{sum(u[2] for u in uses)} gathers and reduce-scatters a step and rank; "
        f"{n} data ranks on one card, fsdp_gz ring eb {FSDP_EB}, grad_gz ring eb "
        f"{TRAIN_EB}, remat full; drawn and sharded in {time.perf_counter() - t0:.2f} s")
    stream = SyntheticStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    want = {k: v * n for k, v in
            _fsdp_plan_launches(setup, {"data": n, "model": 1}, device).items()}
    leaf_no = [i for i, p in enumerate(_leaf_paths(setup.defs)) if p == FSDP_CHECK_LEAF][0]
    record = {"flags": [], "gathers": {}, "keep_gathers": True, "leaf": leaf_no,
              "leaf_cts": {}, "leaf_out": {}, "records": {}}
    sync_record = {"degraded": [], "check_leaf": FSDP_CHECK_LEAF}
    total = dict.fromkeys(_launches(), 0)
    losses, walls = [], []
    with _watched_fsdp(record), _watched_sync(sync_record):
        for s in range(TRAIN_STEPS):
            batch = next(stream)
            _reset_launches()
            params, opt, m, wall = _step_timed(step, params, opt, batch)
            launches = _launches()
            loss = float(m["loss"])
            losses.append(loss)
            walls.append(wall)
            if not math.isfinite(loss) or not math.isfinite(float(m["gnorm"])):
                raise AssertionError(f"fsdp step {s}: loss {loss}, gnorm {float(m['gnorm'])}")
            n_rep = _fsdp_step_replicas(setup, params, opt, f"fsdp step {s}")
            flags = [op for op, f in record["flags"] if bool(f)]
            calls = len(record["flags"])
            if flags or any(bool(d) for d in sync_record["degraded"]):
                raise AssertionError(f"fsdp step {s}: flagged collectives {flags}")
            record["flags"].clear()
            sync_record["degraded"].clear()
            if launches != want:
                raise AssertionError(f"fsdp step {s}: launches {_nonzero(launches)} != the "
                                     f"plans' {_nonzero(want)}")
            for k, v in launches.items():
                total[k] += v
            if s == 0:
                worst, count = _check_fsdp_gathers(setup, whole, record, n, device)
                log(f"fsdp gathers of step 0: {count} gathered slices equal by bits on both "
                    f"ranks; worst error past one bf16 rounding {worst:.3e} (eb {FSDP_EB})")
                _check_fsdp_leaf(setup, record, n, device)
                record["keep_gathers"] = False
                record.pop("leaf")
                record["gathers"].clear()
                record["leaf_cts"].clear()
                record["leaf_out"].clear()
                del whole
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            log(f"fsdp step {s}: loss {loss:.6f} gnorm {float(m['gnorm']):.4f} lr "
                f"{float(m['lr']):.3e}; wall {wall * 1e3:.1f} ms"
                f"{' (cold)' if s == 0 else ' (warm)'}; {calls} collectives, none flagged; "
                f"{n_rep} replicated leaves and their moments equal on both ranks; launches "
                f"{_nonzero(launches)}")
        batch = next(stream)
        record["keep_records"] = True
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            params, opt, m, traced = _step_timed(step, params, opt, batch)
        record["keep_records"] = False
        _fsdp_step_replicas(setup, params, opt, "profiled fsdp step")
    peak = torch.cuda.max_memory_allocated()
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    own_ms = sum(e.self_device_time_total for e in events if OWN_KERNEL.search(e.key)) / 1e3
    log(f"fsdp profile (one step): traced wall {traced * 1e3:.1f} ms, device busy {busy:.1f} "
        f"ms ({100 * busy / (traced * 1e3):.1f} %), kernels 1-4 {own_ms:.1f} ms; loss "
        f"{float(m['loss']):.6f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
    del prof, events
    sync = setup.ctx.fsdp_sync

    def gathers(p):
        g = transport.current("data")
        leaves = grad_sync.tree_flatten(p)[0]
        for leaf, dim, count, shape in uses:
            for index in range(count) if leaves[leaf].dim() > len(shape) else [None]:
                x = leaves[leaf] if index is None else leaves[leaf][index]
                grad_sync._fsdp_gather_impl(x.movedim(dim, 0) if dim else x, g, "data", sync)

    def scatters(records):
        g = transport.current("data")
        for _, ct in records:
            grad_sync._fsdp_reduce_scatter_impl(ct, g, "data", sync)

    shares = {}
    for name, fn, inputs in (("gathers", gathers, params),
                             ("reduce-scatters", scatters,
                              [record["records"][r] for r in range(n)])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = _timed(lambda: mesh.run(fn, inputs))
        alone = sum(e.self_device_time_total for e in _device_events(prof)) / 1e3
        shares[name] = alone
        log(f"fsdp {name} alone (the profiled step's): traced wall {wall * 1e3:.1f} ms, device "
            f"busy {alone:.1f} ms = {100 * alone / max(busy, 1e-9):.1f} % of the step's busy")
        del prof
    record["records"].clear()
    warm = walls[1:]
    log(f"fsdp peak memory: {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated over the warm "
        f"and profiled steps, both ranks) against phase 19's replicated "
        f"{REPLICATED_PEAK_GB:.2f} GB; warm walls {[round(w * 1e3, 1) for w in warm]} ms; "
        f"losses {[round(x, 6) for x in losses]}; launches a step {_nonzero(want)}")
    del params, opt, m, step, setup
    torch.cuda.empty_cache()
    return total


@contextlib.contextmanager
def _kept_fsdp_calls(kept, gathered):
    """Wrap ``FsdpStep.reduce_scatter``: by the step's ``data`` rank, the
    numel of every slice the forward gathered into ``gathered``, and
    (shard slice, dim, cotangent) of every record, in canonical order,
    into ``kept`` (to run them again alone: ``_fsdp_replay``)."""
    from repro_torch.core.grad_sync import FsdpStep

    real = FsdpStep.reduce_scatter

    def slice_of(self, key):
        leaf, index, dim = self._where[key]
        return (self._leaves[leaf] if index is None else self._leaves[leaf][index]), dim

    def keeping(self, grads):
        gathered[self.group.rank] = [slice_of(self, key)[0].numel() for key in self._where]
        calls = []
        for key, ct in sorted(self._records, key=lambda kc: self._where[kc[0]][:2]):
            x, dim = slice_of(self, key)
            calls.append((x.detach(), dim, ct))
        kept[self.group.rank] = calls
        return real(self, grads)

    FsdpStep.reduce_scatter = keeping
    try:
        yield
    finally:
        FsdpStep.reduce_scatter = real


def _fsdp_replay(sync):
    """A rank's body that runs kept calls (``_kept_fsdp_calls``) again on
    the bound ``data`` handle: each shard's gather and each cotangent's
    reduce-scatter, [(gathered, reduce-scattered, overflow, nonfinite)]."""
    from repro_torch.core import grad_sync, transport

    def replay(calls):
        g = transport.current("data")
        out = []
        for x, dim, ct in calls:
            full = grad_sync._fsdp_gather_impl(x.movedim(dim, 0) if dim else x, g, "data", sync)
            rs, st = grad_sync._fsdp_reduce_scatter_impl(ct, g, "data", sync)
            out.append((full, rs, bool(st.overflow), bool(st.nonfinite)))
        return out

    return replay


def _fsdp_replay_plans(calls, comm, n):
    """Kernel launches of one rank's kept calls run again over ``n``
    ranks, summed over the ranks (``_expected_launches``)."""
    want = dict.fromkeys(_launches(), 0)
    for x, dim, ct in calls:
        for plan in (comm.plan("allgather", x.numel()), comm.plan("reduce_scatter", ct.numel())):
            for k, v in _expected_launches(plan, n).items():
                want[k] += v
    return want


def _replays_differ(card, cpu):
    """Elements that differ by bits between two runs of ``_fsdp_replay``
    (by rank), and the calls flagged; flags that differ raise."""
    import torch

    def bits(t):
        t = t.cpu()
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)

    mism = flagged = 0
    for rc, rp in zip(card, cpu):
        for (fa, ra, oa, na), (fb, rb, ob, nb) in zip(rc, rp):
            mism += int((bits(fa) != bits(fb)).sum())
            mism += int((bits(ra) != bits(rb)).sum())
            if (oa, na) != (ob, nb):
                raise AssertionError("FSDP replay: the card's and the CPU's flags differ")
            flagged += oa or na
    return mism, flagged


def check_fsdp_smoke_vs_cpu(device):
    """Phase 29's four-rank check: one train step's forward and backward of
    the smoke config on a ``ThreadMesh((4, 1))`` of the card, sharded,
    ``fsdp_gz`` ring, its launches counted from 0 and held against its
    gathers' and reduce-scatters' plans (kernel 2 on every hop); then
    every leaf's gather (of the step's shards) and reduce-scatter (of the
    step's recorded cotangents) again on the card and on the CPU (the
    plain versions): equal by bits, the same flags, the launches as the
    plans say.  Returns the step's launches."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.core.collectives import GZConfig
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch import shapes, training
    from repro_torch.launch.mesh import ThreadMesh
    from repro_torch.models.parallel import init_params

    n, axes = FSDP_SMOKE_N, ("data", "model")
    cfg = registry.get(TRAIN_ARCH, smoke=True)
    mesh = ThreadMesh((n, 1), axes, device)
    setup = training.make_setup(cfg, mesh, fsdp_gz=GZConfig(eb=FSDP_EB, algo="ring"))
    _, bspecs = shapes.train_specs(
        cfg, shapes.InputShape("t", FSDP_SMOKE_SEQ, FSDP_SMOKE_BATCH, "train"), mesh)
    whole = init_params(setup.defs, torch.Generator(device=device).manual_seed(SEED), device)
    sizes, coords = {"data": n, "model": 1}, training._coords(mesh)
    params = [tree_map(torch.clone, training._local(whole, setup.specs, c, sizes))
              for c in coords]
    batch = next(SyntheticStream(cfg, FSDP_SMOKE_BATCH, FSDP_SMOKE_SEQ, seed=SEED))
    kept, gathered = {}, {}
    with _kept_fsdp_calls(kept, gathered):
        torch.cuda.synchronize()
        _reset_launches()
        mesh.run(lambda a: training._loss_and_grads(setup.model, setup.ctx, a[0], setup.specs,
                                                   a[1], 1.0 / n),
                 [(params[r], training._local(batch, bspecs, coords[r], sizes))
                  for r in range(n)])
        torch.cuda.synchronize()
        step_launches = _launches()
    sync = setup.ctx.fsdp_sync
    comm = _fsdp_comm(sync, n, device)
    # the step's own launches: one gather a slice in the forward (the
    # recompute takes its result), one reduce-scatter a record after backward
    step_want = dict.fromkeys(_launches(), 0)
    plans = [comm.plan("allgather", numel) for numel in gathered[0]]
    plans += [comm.plan("reduce_scatter", ct.numel()) for _, _, ct in kept[0]]
    for plan in plans:
        for k, v in _expected_launches(plan, n).items():
            step_want[k] += v
    log(f"fsdp smoke step on {n} ranks of the card: {len(gathered[0])} gathers and "
        f"{len(kept[0])} reduce-scatters a rank; launches {_nonzero(step_launches)}, the "
        f"plans' {_nonzero(step_want)}")
    if step_launches != step_want or not step_launches["unpack_reduce_repack"]:
        raise AssertionError(f"fsdp smoke step: launches {_nonzero(step_launches)} != the "
                             f"plans' {_nonzero(step_want)}")

    replay = _fsdp_replay(sync)
    want = _fsdp_replay_plans(kept[0], comm, n)
    torch.cuda.synchronize()
    _reset_launches()
    card = mesh.run(replay, [kept[r] for r in range(n)])
    torch.cuda.synchronize()
    launches = _launches()
    cpu = ThreadMesh((n, 1), axes, "cpu").run(
        replay, [[(x.cpu(), dim, ct.cpu()) for x, dim, ct in kept[r]] for r in range(n)])
    mism, flagged = _replays_differ(card, cpu)
    log(f"fsdp smoke on {n} ranks of the card vs the CPU: {len(kept[0])} gathers and "
        f"reduce-scatters a rank on one step's shards and cotangents, {mism} elements differ "
        f"by bits; {flagged} calls flagged on both; launches on the card {_nonzero(launches)}, "
        f"the plans' {_nonzero(want)}")
    if mism:
        raise AssertionError(f"fsdp smoke: {mism} elements differ between card and CPU")
    if launches != want or not launches["unpack_reduce_repack"]:
        raise AssertionError(f"fsdp smoke: launches {_nonzero(launches)} != the plans' "
                             f"{_nonzero(want)}")
    return step_launches


def run_fsdp(device):
    """Phase 29 (module docstring).  Returns the kernels' launches of its
    main path's steps and of the four-rank step."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches = run_fsdp_full_width(device)
    smoke = check_fsdp_smoke_vs_cpu(device)
    log(f"fsdp phase: {time.perf_counter() - t0:.1f} s")
    return launches, smoke


# ---------------------------------------------------------------------------
# Phase 30: tensor and expert parallelism
# ---------------------------------------------------------------------------

# (arch, tp, layers or None for every layer): every published width; only
# the depth is cut, to keep the phase near 90 s on a slow host
TP_DENSE = ("minitron-8b", 4, 4)  # of 32 layers; 32 heads over 8 kv: 2 kv heads a rank
TP_MOE = ("phi3.5-moe-42b-a6.6b", 16, 2)  # of 32 layers; 16 experts: one a rank
TP_SMOKE = False
TP_DECODE_STEPS = 16  # the gate reads the last step's logits
TP_FAMILIES_DECODE_STEPS = 8  # the tp-families phase's (room for the overlap phase)
TP_TIMED_STEPS = 8  # a decode through kernel 11 is timed again without the checks
TP_MOE_DECODE_B = 4  # < tp: the token-padding path of the expert dispatch
TP_DISPATCH_EB = 1e-4  # benchmarks/moe_a2a_ablation.py's eb
# tests/_mp_model_parallel_child.py: the reference's own bounds between its
# (1, 1) and (2, 4) meshes
TP_RTOL = {"dense": 0.02, "moe": 0.05}
# the decode logits' max gap to tp 1 over their max |logit|: bf16 partial
# sums give 5.9e-3 to 4.3e-2 on the H100; a misplaced cache block gives O(1)
TP_DECODE_RTOL = 0.15
TP_CODEC = ("quantize", "unpack_dequantize")  # the compressed all-to-all's kernels


def _tp_cfg(spec, **kw):
    """``spec``'s config at full width (the smoke config with
    ``TP_SMOKE``), its depth cut, through kernel 11 where the family has it
    and the head dim is one of the kernel's (zamba2-2.7b's shared attention
    has D = 80 and takes the chunked path, as at tp = 1; MLA's latent
    attention is plain torch)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attn

    arch, _, layers = spec
    cfg = registry.get(arch, smoke=TP_SMOKE)
    flash = cfg.mla is None and cfg.head_dim in flash_attn.HEAD_DIMS
    if layers is not None and not TP_SMOKE:
        kw["n_layers"] = layers
    return dataclasses.replace(cfg, use_flash_kernel=flash, **kw)


def _tp_decode_gate(what, got, ref):
    """``got``'s logits finite, of ``ref``'s shape and within
    ``TP_DECODE_RTOL`` of it (max gap over max |ref|); returns that gap."""
    import torch

    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: decode logits {tuple(got.shape)}, "
                             f"tp 1 {tuple(ref.shape)}")
    rel = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
    if not rel <= TP_DECODE_RTOL:
        raise AssertionError(f"{what}: decode logits {rel:.4e} from tp 1's "
                             f"(bound {TP_DECODE_RTOL})")
    return rel


def _tp_setup(cfg, tp, whole, device):
    """``launch.training.make_setup`` on a ``ThreadMesh((1, tp))`` of the
    card, and each rank's ``_local`` block (views) of the global tree."""
    from repro_torch.launch import training
    from repro_torch.launch.mesh import ThreadMesh

    mesh = ThreadMesh((1, tp), ("data", "model"), device)
    setup = training.make_setup(cfg, mesh, fsdp=False, remat="none")
    sizes = {"data": 1, "model": tp}
    return setup, [training._local(whole, setup.specs, c, sizes)
                   for c in training._coords(mesh)]


def _tp_losses(setup, params, batch):
    """Every rank's ``loss_fn`` on its block, in rank order."""
    import torch

    def rank(p):
        with torch.no_grad():
            return setup.model.loss_fn(p, batch)

    return [float(x) for x in setup.mesh.run(rank, params)]


@contextlib.contextmanager
def _checked_flash(record):
    """Run every kernel 11 call's inputs through its plain version as well
    (no launch: the plain version is torch ops) and append (shape, dtype,
    causal, max |err|, count outside ``FLASH_TOL``) to ``record``, the last
    two as 0-d device tensors: nothing waits for the card here, so the
    checks do not serialize the rank threads (``_tp_flash_verdict`` reads
    them)."""
    import torch

    from repro_torch.kernels import flash_attn

    real = flash_attn.flash_attention
    lock = threading.Lock()

    def wrapped(q, k, v, *, causal=True, window=0):
        out = real(q, k, v, causal=causal, window=window)
        want = flash_attn.flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
        diff = (out.float() - want.float()).abs()
        bad = (diff > tol + tol * want.float().abs()).sum() + (~torch.isfinite(out)).sum()
        with lock:
            record.append((tuple(q.shape), tuple(k.shape), str(q.dtype), causal,
                           diff.max(), bad))
        return out

    flash_attn.flash_attention = wrapped
    try:
        yield record
    finally:
        flash_attn.flash_attention = real


def _tp_flash_verdict(tag, record, want):
    """Hold the checked calls of ``record`` against the plan (``want``
    launches) and their plain versions; log each payload shape's worst
    error."""
    from repro_torch.kernels import flash_attn

    launches = flash_attn.LAUNCHES["flash_attention"]
    if launches != want or len(record) != want:
        raise AssertionError(f"{tag}: kernel 11 launched {launches} times ({len(record)} "
                             f"checked), expected {want}")
    by_shape = {}
    for q, k, dtype, causal, err, bad in record:
        n, worst, outside = by_shape.get((q, k, dtype, causal), (0, 0.0, 0))
        by_shape[(q, k, dtype, causal)] = (n + 1, max(worst, float(err)), outside + int(bad))
    for (q, k, dtype, causal), (n, worst, outside) in sorted(by_shape.items()):
        log(f"  {tag}: kernel 11 vs plain on the rank's payload q {q} k {k} {dtype} "
            f"causal={causal}: {n} launches, max |err| {worst:.3e}, {outside} outside "
            f"atol = rtol = {FLASH_TOL[dtype.removeprefix('torch.')]:g}")
    if any(outside for _, _, outside in by_shape.values()):
        raise AssertionError(f"{tag}: kernel 11 disagrees with its plain version")
    return launches


@contextlib.contextmanager
def _watched_dispatch(record, payload):
    """Append (rank, wire bytes, f32 payload bytes, overflow, nonfinite) of
    every compressed all-to-all to ``record``, and rank 0's first payload
    to ``payload``."""
    from repro_torch.core import transport
    from repro_torch.core.comm import GZCommunicator

    real = GZCommunicator.all_to_all
    lock = threading.Lock()

    def wrapped(self, x, **kw):
        res = real(self, x, **kw)
        rank = transport.current(self.axis_name).rank
        with lock:
            if rank == 0 and not payload:
                payload.append(x.clone())
            record.append((rank, res.wire_bytes, x.numel() * x.element_size(),
                           bool(res.overflow), bool(res.nonfinite)))
        return res

    GZCommunicator.all_to_all = wrapped
    try:
        yield record
    finally:
        GZCommunicator.all_to_all = real


def _tp_profile(tag, fn):
    """The warm wall and the device busy of one profiled ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, warm = _timed(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced = _timed(fn)
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"{tag}: warm wall {warm * 1e3:.1f} ms; profiled wall {traced * 1e3:.1f} ms, device "
        f"busy {busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %), "
        f"{sum(e.count for e in events)} device rows")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
    del prof, events
    torch.cuda.empty_cache()
    return warm, busy


def _tp_gate(what, losses, want, rtol):
    """Every rank's loss finite and within ``rtol`` of ``want``; returns
    the largest relative gap."""
    gap = max(abs(x - want) for x in losses) / abs(want)
    if not all(math.isfinite(x) for x in losses) or not gap <= rtol:
        raise AssertionError(f"{what}: losses {losses} against {want} (rtol {rtol})")
    return gap


def _tp_family_plan(cfg, tp):
    """Kernel 11's launches on the path: (the loss forward's, a decode
    step's).  Each rank calls it once for every attention of a layer that
    goes through it: encdec's encoder, self and cross attention in the
    forward and its cross attention in a decode step; the dense, moe and
    vlm attention, and the hybrid's shared block, in the forward (their
    decode attends against the cache in plain torch).  zamba2-2.7b's
    shared block (D = 80) runs without kernel 11; the hybrid row counts
    its smoke config (D = 32) under ``TP_SMOKE``."""
    if not cfg.use_flash_kernel:
        return 0, 0
    if cfg.family == "encdec":
        return (cfg.n_enc_layers + 2 * cfg.n_layers) * tp, cfg.n_layers * tp
    if cfg.family == "hybrid":  # the shared block after each group of layers
        return cfg.n_layers // cfg.attn_every * tp, 0
    return cfg.n_layers * tp, 0


def _tp_family(spec, device, phase, steps=TP_DECODE_STEPS):
    """One config (``TP_DENSE`` or a row of ``TP_FAMILIES``) at tp on a
    ``ThreadMesh((1, tp))`` of the card (``_tp_setup``): the loss forward
    against tp = 1 on the same bf16 weights from seed 0 within
    ``TP_RTOL["dense"]``, every rank's loss equal by bits, kernel 11's
    launches counted from 0 and held against ``_tp_family_plan`` and each
    against its plain version; the warm wall and busy share from one
    profiled call; then ``steps`` steps of ``make_serve_step`` at
    B = 2 from an empty cache (encdec: ``enc_out`` the tp = 1 encoder's
    output of one batch), kernel 11 counted and checked the same way, the
    last step's logits against tp = 1's ``decode_fn`` within
    ``TP_DECODE_RTOL``; their ms a step, or, where kernel 11 ran in them,
    that of ``TP_TIMED_STEPS`` steps without the checks.  ``phase`` tags
    the log lines.  Returns kernel 11's launches."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch import shapes, training

    arch, tp, _ = spec
    cfg = _tp_cfg(spec)
    heads = []
    if cfg.ssm is not None:
        heads.append(f"{cfg.ssm.n_heads(cfg.d_model) // tp} SSD heads")
    if cfg.n_heads:
        heads.append(f"{cfg.padded_heads(tp) // tp} q heads")
    if cfg.n_heads and cfg.mla is None:
        heads.append(f"{max(cfg.n_kv_heads // tp, 1)} kv heads"
                     + (f" (one shared by {tp // cfg.n_kv_heads} ranks)"
                        if cfg.n_kv_heads < tp else ""))
    model, whole = _family_model(
        cfg, None, device, f"; {cfg.n_layers} layers, tp {tp}: {', '.join(heads)} a rank; "
        f"kernel 11 {'on' if cfg.use_flash_kernel else 'off'}")
    fwd_plan, step_plan = _tp_family_plan(cfg, tp)
    batch = next(SyntheticStream(cfg, MODEL_BATCH, MODEL_SEQ, seed=SEED))
    with torch.inference_mode():
        want, one_s = _timed(lambda: float(model.loss_fn(whole, batch)))
    setup, params = _tp_setup(cfg, tp, whole, device)
    record = []
    _reset_launches()
    with _checked_flash(record):
        losses, cold = _timed(lambda: _tp_losses(setup, params, batch))
    fwd = _tp_flash_verdict(f"{phase} {arch} forward", record, fwd_plan)
    gap = _tp_gate(f"{arch} tp {tp}", losses, want, TP_RTOL["dense"])
    if len(set(losses)) != 1:
        raise AssertionError(f"{arch} tp {tp}: the ranks' losses differ: {losses}")
    log(f"{phase} {arch} B={MODEL_BATCH} S={MODEL_SEQ}: tp {tp} loss {losses[0]:.6f} "
        f"against tp 1 {want:.6f}, rel gap {gap:.3e} (bound {TP_RTOL['dense']}); every "
        f"rank's loss equal by bits; kernel 11 launched {fwd} times (planned {fwd_plan}); "
        f"cold wall {cold * 1e3:.1f} ms (every launch checked), tp 1 {one_s * 1e3:.1f} ms")
    _tp_profile(f"{phase} {arch} tp {tp} loss forward",
                lambda: _tp_losses(setup, params, batch))

    # decode through make_serve_step, from an empty cache
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (2, steps)).astype(np.int32)).to(device)
    enc_out = None
    if cfg.family == "encdec":
        with torch.inference_mode():
            enc_out = model._encode(whole, torch.from_numpy(batch["enc_input"][:2]).to(device))
    shape = shapes.InputShape("tp-decode", steps, 2, "decode")
    cache, cspecs, _, tspec, plan = shapes.decode_specs(cfg, shape, setup.mesh, setup.model)
    step = training.make_serve_step(setup, cspecs, tspec, plan)

    def decode_all(n):
        c = {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in cache.items()}
        if enc_out is not None:
            c["enc_out"].copy_(enc_out)
        out = None
        for pos in range(n):
            out, _ = step(params, c, toks[:, pos:pos + 1], pos)
        return out, {k: tuple(v.shape) for k, v in c.items()}

    record = []
    _reset_launches()
    with _checked_flash(record), torch.no_grad():
        (got, cache_shapes), decode_s = _timed(lambda: decode_all(steps))
    dec = _tp_flash_verdict(f"{phase} {arch} decode", record, step_plan * steps)
    timed = steps
    if step_plan:  # time steps without the checks beside kernel 11
        timed = TP_TIMED_STEPS
        with torch.no_grad():
            _, decode_s = _timed(lambda: decode_all(timed))
    with torch.inference_mode():
        ref, ref_s, _ = _decode_logits(model, whole, toks, enc_out=enc_out)
    rel = _tp_decode_gate(f"{arch} tp {tp}", got, ref[:, -1:])
    log(f"{phase} {arch} decode: {steps} make_serve_step steps at B=2, tp {tp}: "
        f"{decode_s * 1e3 / timed:.2f} ms/step over {timed} steps (tp 1 decode_fn "
        f"{ref_s * 1e3 / steps:.2f} ms/step); kernel 11 launched {dec} times ({step_plan} a "
        f"step); global cache {cache_shapes}; the last step's logits {rel:.4e} from tp 1's "
        f"(bound {TP_DECODE_RTOL})")
    del model, whole, params, setup, step, enc_out
    torch.cuda.empty_cache()
    return fwd + dec


def _tp_moe(device):
    """phi3.5-moe at tp = 16 (``TP_MOE``), at capacity factor n_experts /
    top_k (nothing drops), with ``moe_dispatch_gz_eb`` = ``TP_DISPATCH_EB``:
    the loss through the compressed dispatch (kernels 5 and 4 launched as
    the code says: one ``quantize`` and tp ``unpack_dequantize`` a dispatch
    and rank, two dispatches a layer), through the exact dispatch and at tp
    = 1, the gaps printed, exact against tp = 1 within rtol 0.05; the
    dispatch's wire bytes beside the f32 payload's; one decode step at B =
    4 < tp (the token-padding path) against tp = 1; at the config's 1.25,
    the dropped share and the gap.  Kernel 11's launches in the compressed
    run are each held against the plain version.  Returns that run's
    launches, its captured dispatch payload and the config."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch import shapes, training

    arch, tp, _ = TP_MOE
    base = registry.get(arch, smoke=TP_SMOKE)
    nodrop = base.n_experts / base.top_k
    cfg = _tp_cfg(TP_MOE, capacity_factor=nodrop)
    model, whole = _family_model(
        cfg, None, device, f"; n_layers cut to {cfg.n_layers}, tp {tp}: "
        f"{cfg.n_experts // tp} expert and {cfg.n_heads // tp} q heads a rank, one kv head "
        f"shared by {tp // cfg.n_kv_heads} ranks, capacity factor {nodrop:g}")
    batch = next(SyntheticStream(cfg, MODEL_BATCH, MODEL_SEQ, seed=SEED))
    with torch.inference_mode():
        want = float(model.loss_fn(whole, batch))
    exact_setup, params = _tp_setup(cfg, tp, whole, device)
    exact, exact_s = _timed(lambda: _tp_losses(exact_setup, params, batch))
    gap = _tp_gate(f"{arch} tp {tp} exact", exact, want, TP_RTOL["moe"])

    gz_cfg = dataclasses.replace(cfg, moe_dispatch_gz_eb=TP_DISPATCH_EB)
    gz_setup, _ = _tp_setup(gz_cfg, tp, whole, device)
    dispatch, payload, flash = [], [], []
    _reset_launches()
    with _watched_dispatch(dispatch, payload), _checked_flash(flash):
        gz, gz_s = _timed(lambda: _tp_losses(gz_setup, params, batch))
    launches = _launches()
    n_dispatch = cfg.n_layers * 2 * tp
    want_launches = {"flash_attention": cfg.n_layers * tp, "quantize": n_dispatch,
                     "unpack_dequantize": n_dispatch * tp}
    got_launches = {k: launches[k] for k in want_launches}
    others = {k: v for k, v in _nonzero(launches).items() if k not in want_launches}
    if got_launches != want_launches or others:
        raise AssertionError(f"tp {tp} compressed dispatch: launches {_nonzero(launches)}, "
                             f"expected {want_launches}")
    if len(dispatch) != n_dispatch or any(ovf or bad for _, _, _, ovf, bad in dispatch):
        raise AssertionError(f"tp {tp}: {len(dispatch)} dispatches (expected {n_dispatch}), "
                             f"flags {[(o, b) for _, _, _, o, b in dispatch]}")
    _tp_flash_verdict(f"tp {arch} compressed", flash, cfg.n_layers * tp)
    gz_gap = _tp_gate(f"{arch} tp {tp} compressed", gz, want, TP_RTOL["moe"])
    gz_exact = max(abs(a - b) for a, b in zip(gz, exact)) / max(abs(x) for x in exact)
    wire = {w for _, w, _, _, _ in dispatch}
    dense = {d for _, _, d, _, _ in dispatch}
    log(f"tp {arch} B={MODEL_BATCH} S={MODEL_SEQ}, tp {tp}: rank losses exact dispatch "
        f"{min(exact):.6f}..{max(exact):.6f}, compressed (eb {TP_DISPATCH_EB:g}) "
        f"{min(gz):.6f}..{max(gz):.6f}, tp 1 {want:.6f}; rel gaps: exact vs tp 1 {gap:.3e} "
        f"(bound {TP_RTOL['moe']}; each rank's aux term covers its token slice), compressed "
        f"vs tp 1 {gz_gap:.3e}, compressed vs exact {gz_exact:.3e}; walls exact "
        f"{exact_s * 1e3:.1f} ms, compressed {gz_s * 1e3:.1f} ms (cold)")
    log(f"tp {arch} dispatch: {len(dispatch)} compressed all-to-alls ({cfg.n_layers} layers x "
        f"2 x {tp} ranks), none flagged; wire bytes a call {sorted(wire)} against the f32 "
        f"payload's {sorted(dense)} ({min(dense) / max(wire):.2f}x); kernel launches "
        f"{got_launches} (as planned)")
    _tp_profile(f"tp {arch} tp {tp} loss forward, compressed dispatch",
                lambda: _tp_losses(gz_setup, params, batch))
    _tp_profile(f"tp {arch} tp {tp} loss forward, exact dispatch",
                lambda: _tp_losses(exact_setup, params, batch))

    # one decode step at B = 4 < tp through make_serve_step
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (TP_MOE_DECODE_B, 1)).astype(np.int32)).to(device)
    shape = shapes.InputShape("tp-decode", 8, TP_MOE_DECODE_B, "decode")
    cache, cspecs, _, tspec, plan = shapes.decode_specs(cfg, shape, exact_setup.mesh,
                                                        exact_setup.model)
    cache = {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in cache.items()}
    step = training.make_serve_step(exact_setup, cspecs, tspec, plan)
    with torch.no_grad():
        got, step_s = _timed(lambda: step(params, cache, toks, 0)[0])
    with torch.inference_mode():
        cache1 = {k: torch.zeros(v, dtype=torch.float32, device=device)
                  for k, v in model.cache_defs(TP_MOE_DECODE_B, plan).items()}
        ref, _ = model.decode_fn(whole, cache1, toks, 0, plan)
    rel = _tp_decode_gate(f"{arch} tp {tp}", got, ref)
    log(f"tp {arch} decode step at B={TP_MOE_DECODE_B} < tp {tp} (the token slice padded "
        f"to {tp} rows): {step_s * 1e3:.1f} ms; logits {rel:.4e} from tp 1's (bound "
        f"{TP_DECODE_RTOL})")

    # at the config's capacity factor: slots drop
    drops = []
    cut_cfg = dataclasses.replace(cfg, capacity_factor=base.capacity_factor)
    cut_setup, _ = _tp_setup(cut_cfg, tp, whole, device)
    with _counting_drops(drops):
        cut = _tp_losses(cut_setup, params, batch)
    dropped, slots = sum(d for d, _ in drops), sum(n for _, n in drops)
    cut_gap = max(abs(a - b) for a, b in zip(cut, exact)) / max(abs(x) for x in exact)
    log(f"tp {arch} at capacity factor {base.capacity_factor}: {dropped} of {slots} slots "
        f"dropped ({100 * dropped / max(slots, 1):.2f} %); rel gap to the no-drop losses "
        f"{cut_gap:.3e} (logged)")
    del model, whole, params, exact_setup, gz_setup, cut_setup, cache, cache1, step
    torch.cuda.empty_cache()
    return launches, payload[0], gz_cfg


def _tp_check_kernels(a2a_x, gz_cfg, tp):
    """Kernels 5 and 4 on the captured dispatch payload (rank 0's first:
    its tp chunks quantized together, each stream unpacked) against their
    plain versions, by bits.  These launches are not counted."""
    import torch

    from repro_torch.core import collectives
    from repro_torch.kernels import lorenzo, ops
    from repro_torch.models.blocks import dispatch_comm
    from repro_torch.models.parallel import ParallelCtx

    chunk_n = a2a_x.numel() // tp
    rows = ops.n_blocks_for(chunk_n)
    x2d = torch.zeros((tp, rows * ops.BLOCK), dtype=torch.float32, device=a2a_x.device)
    x2d[:, :chunk_n] = a2a_x.reshape(tp, chunk_n)
    x2d = x2d.view(tp * rows, ops.BLOCK)
    eb = ops.as_eb(gz_cfg.moe_dispatch_gz_eb, a2a_x.device)
    _compare("tp quantize", lorenzo.quantize(x2d, eb), lorenzo.quantize_plain(x2d, eb))
    cfg = dispatch_comm(gz_cfg, ParallelCtx(tp_size=tp), a2a_x.device).config
    packed, bw, anchor, ovf = collectives._compress_chunks(
        a2a_x.reshape(tp, chunk_n), tp, chunk_n, cfg)
    if bool(ovf):
        raise AssertionError("tp: the captured dispatch payload overflows its capacity")
    for i in range(tp):
        args = (packed[i], bw[i], anchor[i], eb)
        _compare(f"tp unpack_dequantize [chunk {i}]", (lorenzo.unpack_dequantize(*args),),
                 (lorenzo.unpack_dequantize_plain(*args),))
    log(f"tp: quantize and unpack_dequantize vs plain on the captured dispatch payload "
        f"({tp} chunks of {chunk_n} f32, {rows} blocks each): mismatches 0")


def run_tp(device, records):
    """Phase 30 (module docstring).  Sets the kernels line's launches of
    kernel 11 (both main paths) and of kernels 5 and 4 (the compressed
    dispatch)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    flash_dense = _tp_family(TP_DENSE, device, "tp")
    launches, a2a_x, gz_cfg = _tp_moe(device)
    _tp_check_kernels(a2a_x, gz_cfg, TP_MOE[1])
    _record(records, "flash_attention")["launches"] = flash_dense + launches["flash_attention"]
    for name in TP_CODEC:
        _record(records, name)["launches"] = launches[name]
    del a2a_x
    torch.cuda.empty_cache()
    log(f"tp phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 31: tensor parallelism of the other families
# ---------------------------------------------------------------------------

# as ``TP_DENSE``
TP_FAMILIES = (
    ("zamba2-2.7b", 4, 12),  # of 54: 2 shared applications; 80 SSD heads, 20 a rank
    ("minicpm3-4b", 8, 4),  # of 62: 40 MLA heads, 5 a rank, no padding
    ("seamless-m4t-medium", 4, None),  # 12 + 12: 16 heads, 4 a rank
    ("internvl2-26b", 16, 4),  # of 48: 48 heads, 3 a rank; a kv head shared by 2 ranks
)


def run_tp_families(device, records):
    """Phase 31 (module docstring).  Sets the kernels line's launches of
    kernel 11 (this phase's forwards and decode steps)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    flash = 0
    for spec in TP_FAMILIES:
        flash += _tp_family(spec, device, "tp-families", TP_FAMILIES_DECODE_STEPS)
    _record(records, "flash_attention")["launches"] = flash
    log(f"tp-families phase: {time.perf_counter() - t0:.1f} s; kernel 11 launched {flash} "
        f"times")


# ---------------------------------------------------------------------------
# Phase 32: the tensor-parallel train step, one process per rank
# ---------------------------------------------------------------------------

# phase 29's cell (internlm2-20b, every published width, depth 48 -> 2,
# fsdp_gz and the norms' sync ring at eb 1e-4) at tp 2: NCCL puts no two
# ranks of a group on one GPU and CUDA runs a process's backward on one
# device thread, so the ranks are four processes over gloo (the card's
# tensors staged through the host), each capped at a quarter of the card
TP_TRAIN_MESH = (2, 2)  # (data, model)
TP_TRAIN_MEMORY_FRACTION = 0.23
TP_TRAIN_STEPS = 3  # and a timed fourth
TP_TRAIN_RTOL = 0.02  # step 0's loss against tp 1's (tests/_mp_model_parallel_child.py)
TP_TRAIN_SMOKE_RTOL = 1e-5  # the smoke step, card against the CPU (PERF.md section 2)
TP_TRAIN_TIMEOUT = 420  # seconds, the children together
TP_TRAIN_SMOKE = False  # the smoke config in place of internlm2-20b (a CPU rehearsal)
TP_TRAIN_SYNC_LEAF = ("final_norm",)  # replicated on every rank: the data ring, the model sum


def _tp_train_cfg(smoke):
    import dataclasses

    from repro_torch.configs import registry

    if smoke:  # wide enough that no norm's compressed sync overflows
        return dataclasses.replace(registry.get(TRAIN_ARCH, smoke=True), d_model=1024,
                                   n_heads=8, n_kv_heads=4, d_ff=1024)
    return dataclasses.replace(registry.get(TRAIN_ARCH), n_layers=TRAIN_LAYERS)


def _tp_train_setup(cfg, mesh, gz, shape, overlap=False):
    """The phase's setup on ``mesh`` and its batch specs at ``shape``
    (batch, seq): weights sharded over ``data``, remat full; with ``gz``
    the FSDP gathers and reduce-scatters and the norms' sync through the
    ring at ``FSDP_EB`` / ``TRAIN_EB``, else exact; with ``overlap`` the
    sync in the bucket hooks, buckets of the ``BucketPlan``'s size."""
    from repro_torch.core.collectives import GZConfig
    from repro_torch.launch import shapes, training

    setup = training.make_setup(
        cfg, mesh, remat="full",
        fsdp_gz=GZConfig(eb=FSDP_EB, algo="ring") if gz else None,
        grad_gz=GZConfig(eb=TRAIN_EB, algo="ring") if gz else None, overlap_sync=overlap)
    _, bspecs = shapes.train_specs(cfg, shapes.InputShape("train", shape[1], shape[0], "train"),
                                   mesh)
    return setup, bspecs


def _across(mesh, axis, t):
    """Every rank's ``t`` over ``axis`` of this process's ``DistMesh``, in
    the handle's rank order."""
    from repro_torch.core import transport

    (stacked,) = mesh.run(lambda x: transport.current(axis).all_gather((x,))[0], [t])
    return list(stacked.unbind(0))


def _tp_train_step0(setup, mesh, coord, sizes, record, sync_record, device):
    """Step 0's checks of the kernels at the rank's own shapes, in one
    process of the phase: every gathered weight within the allgather's eb
    (plus one bf16 rounding) of the rank's tensor-parallel block of the
    global weights (checked as it was gathered, ``_watched_in_backward``),
    one check a gathered leaf or layer slice; ``FSDP_CHECK_LEAF``'s
    layer-0 reduce-scatter within its bound of the exact sum of both
    ``data`` ranks' cotangents; where ``_sync_grads`` ran (not under the
    bucket hooks), ``TP_TRAIN_SYNC_LEAF``'s sync (the ``data`` ring, then
    the exact ``model`` sum) within its bound of the exact sum of the four
    ranks' gradients.  Returns the numbers and a digest of each gathered
    weight, for the parent to hold equal on the ``data`` peers."""
    import torch

    from repro_torch.core import error_budget
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.models.parallel import torch_dtype

    n, rank = sizes["data"], mesh.rank
    defs = tree_flatten(setup.defs)[0]
    want = {(leaf, index) for leaf, _, uses, shape in _fsdp_uses(setup)
            for index in (range(uses) if len(defs[leaf].shape) > len(shape) else [None])}
    checks = record["gathers"]
    if set(checks) != want:
        raise AssertionError(f"tp-train rank {rank}: gathered {sorted(checks)}, the uses "
                             f"{sorted(want)}")
    bad = {k: c for k, c in checks.items() if not c["over"] <= c["eb"]}
    if bad:
        raise AssertionError(f"tp-train rank {rank}: gathered weights past their eb: {bad}")
    worst, count = max(c["over"] for c in checks.values()), len(checks)
    digests = {f"{leaf}/{index}": c["digest"] for (leaf, index), c in checks.items()}

    ((_, (ct,)),) = record["leaf_cts"].items()
    record["leaf_cts"] = {r: [c] for r, c in enumerate(_across(mesh, "data", ct))}
    leaf_err, leaf_bound = _check_fsdp_leaf(setup, record, n, device,
                                            label=f"tp-train rank {rank}")
    out = {"gathers": count, "gather_worst": worst, "gather_digests": digests,
           "leaf_err": leaf_err, "leaf_bound": leaf_bound}
    if not sync_record["leaf"]:
        return out

    ((g, synced),) = sync_record["leaf"].values()
    sums = _across(mesh, "model", sum(x.double() for x in _across(mesh, "data", g)))
    exact = sum(sums)
    leaf_no = _leaf_paths(setup.defs).index(TP_TRAIN_SYNC_LEAF)
    dtype = torch_dtype(tree_flatten(setup.defs)[0][leaf_no].dtype)
    plan = dict(setup.grad_comms)["data"].plan("allreduce", tuple(g.shape), dtype)
    hops = error_budget.lossy_hops(f"allreduce_{plan.algo}", n)
    # each model rank's data ring and its cast to the leaf's dtype, then
    # the exact model sum's cast
    rounding = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23
    sync_bound = (sum(hops * plan.eb_stage + rounding * x.abs().max().item() for x in sums)
                  + rounding * synced.abs().max().item())
    sync_err = (synced.double() - exact).abs().max().item()
    log(f"tp-train rank {rank} synced {'.'.join(TP_TRAIN_SYNC_LEAF)} {tuple(g.shape)}: max "
        f"error {sync_err:.3e} vs the exact sum of the {n * sizes['model']} ranks, bound "
        f"{sync_bound:.3e} (plan {plan.algo}/{plan.pipeline_chunks}, eb_stage "
        f"{plan.eb_stage:.3e})")
    if not sync_err <= sync_bound:
        raise AssertionError(f"synced {TP_TRAIN_SYNC_LEAF}: error {sync_err} > bound "
                             f"{sync_bound}")
    return {**out, "sync_err": sync_err, "sync_bound": sync_bound}


def _cpu_comm(comm):
    """``comm`` on the CPU: the same knobs, so the same plans."""
    from repro_torch.core.comm import GZCommunicator

    return GZCommunicator(comm.axis_name, config=comm.config, policy=comm.policy, hw=comm.hw,
                          ratio=comm.ratio, axis_size=comm._axis_size, device="cpu",
                          auto_depth=comm._auto_depth)


def _overlap_step0(mesh, record):
    """Step 0's checks of the bucket hooks in one process of the overlap
    phase, for each bucket whose sync ran a collective
    (``_watched_buckets``): its synced vector against the exact sum of the
    ranks' vectors over its ops' axes, within the bound of the
    allreduces on the way (their lossy hops' ``eb_stage`` and an f32
    rounding of each partial sum), by bits against the f32 rank-order sum
    where no communicator sums it; then its sync again on the host (the
    plain versions: CPU communicators of the same plans, over the same
    ``DistMesh``), equal by bits to the card's.  Returns, by bucket, its
    size, error, bound and the elements that differ card/host."""
    import torch

    from repro_torch.core import error_budget, transport

    real = record["real"]
    out = []
    for ops, vec, synced in record["buckets"]:
        exact, bound, f32 = vec.double(), 0.0, vec
        for ax, comm in ops:
            exact = sum(_across(mesh, ax, exact))
            parts = _across(mesh, ax, torch.tensor(bound, dtype=torch.float64,
                                                   device=vec.device))
            bound = sum(float(b) for b in parts) + 2.0 ** -23 * exact.abs().max().item()
            if comm is None:
                f32 = None if f32 is None else _fold(_across(mesh, ax, f32))
            else:
                plan = comm.plan("allreduce", vec.numel())
                bound += error_budget.lossy_hops(f"allreduce_{plan.algo}",
                                                 comm.axis_size()) * plan.eb_stage
                f32 = None
        err = (synced.double() - exact).abs().max().item()
        if f32 is not None and not torch.equal(f32.view(torch.int32), synced.view(torch.int32)):
            raise AssertionError(f"overlap bucket {ops}: the exact sum differs from the "
                                 f"rank-order f32 sum by bits")
        if not err <= bound:
            raise AssertionError(f"overlap bucket of {vec.numel()} elements: error {err} > "
                                 f"bound {bound}")
        cpu_ops = tuple((ax, None if c is None else _cpu_comm(c)) for ax, c in ops)
        ((host, _),) = mesh.run(lambda v: real(v, cpu_ops, transport.bindings()), [vec.cpu()])
        mism = int((host.view(torch.int32) != synced.cpu().view(torch.int32)).sum())
        if mism:
            raise AssertionError(f"overlap bucket of {vec.numel()} elements: {mism} elements "
                                 f"differ between the card's sync and the host's")
        out.append({"ops": [[ax, c is not None] for ax, c in ops], "numel": vec.numel(),
                    "err": err, "bound": bound, "mism": mism})
    return out


def _tp_train_replay(mesh, coord, sizes, device):
    """The smoke config in f32 with ``fsdp_gz``: one step's forward and
    backward, then its gathers and reduce-scatters again alone on the card
    and on the host (the plain versions), through the same ``DistMesh``:
    equal by bits, the same flags, the card's launches as the plans say."""
    import torch

    from repro_torch.convert import tree_map
    from repro_torch.launch import training

    n, cuda = sizes["data"], device.type == "cuda"
    scfg, whole, batch = _tp_train_smoke_inputs()
    setup, bspecs = _tp_train_setup(scfg, mesh, True, (FSDP_SMOKE_BATCH, FSDP_SMOKE_SEQ))
    params = tree_map(lambda t: t.clone().to(device),
                      training._local(whole, setup.specs, coord, sizes))
    scale = 1.0 / (setup.ctx.tp_size * setup.ctx.fsdp_size)
    kept, gathered = {}, {}
    with _kept_fsdp_calls(kept, gathered):  # FsdpStep's records: every call, in order
        mesh.run(lambda a: training._loss_and_grads(setup.model, setup.ctx, a[0], setup.specs,
                                                   a[1], scale, deferred=True),
                 [(params, training._local(batch, bspecs, coord, sizes))])
    ((_, calls),) = kept.items()
    sync = setup.ctx.fsdp_sync
    replay = _fsdp_replay(sync)
    want = {k: v // n for k, v in
            _fsdp_replay_plans(calls, _fsdp_comm(sync, n, device), n).items()}
    if cuda:
        torch.cuda.synchronize()
    _reset_launches()
    card = mesh.run(replay, [calls])
    if cuda:
        torch.cuda.synchronize()
    launches = _launches()
    host = mesh.run(replay, [[(x.cpu(), dim, ct.cpu()) for x, dim, ct in calls]])
    mism, flagged = _replays_differ(card, host)
    log(f"tp-train rank {mesh.rank} replay ({scfg.arch_id}, f32, fsdp_gz): {len(calls)} "
        f"gathers and reduce-scatters, {mism} elements differ by bits between card and host, "
        f"{flagged} flagged on both; launches {_nonzero(launches)}, the plans' {_nonzero(want)}")
    if mism or (cuda and launches != want):
        raise AssertionError(f"tp-train replay: {mism} elements differ, launches "
                             f"{_nonzero(launches)} against the plans' {_nonzero(want)}")
    return {"calls": len(calls), "mism": mism, "flagged": flagged,
            "launches": _nonzero(launches), "want": _nonzero(want)}


def _digest(t) -> str:
    import hashlib

    import torch

    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _hookless_loss(setup, mesh, params, batch, sizes):
    """The loss metric the train step reports, from a forward of the same
    weights and batch under ``no_grad``, no hook installed (the loss is
    computed before any gradient sync)."""
    import torch

    from repro_torch.core import transport

    scale = 1.0 / (setup.ctx.tp_size * math.prod(sizes[ax] for ax in setup.ctx.dp_axes))

    def body(args):
        p, b = args
        with torch.no_grad():
            loss = setup.model.loss_fn(p, b) * scale
        loss = loss / scale
        for ax in setup.ctx.dp_axes:
            loss = transport.current(ax).sum_across(loss) / sizes[ax]
        return loss

    (loss,) = mesh.run(body, [(params, batch)])
    return float(loss)


def _tp_train_child(rank, port, out_dir, device_name, smoke, overlap=False):
    """One rank of the tp-train phase, or with ``overlap`` of the overlap
    phase (the same cell with the bucket hooks): its process's share of
    the card, the gloo ``DistMesh``, ``TP_TRAIN_STEPS`` steps and a timed
    fourth of the cell, step 0's checks of the kernels at the rank's
    shapes (``_tp_train_step0``; under ``overlap`` also
    ``_overlap_step0``); then, in the tp-train phase, the smoke config's
    replay (``_tp_train_replay``) and one exact step of it in f32.
    Writes ``rank<r>.json`` (each step's metrics by their bits, wall, gloo
    staging, launches against the plans, gathers, collectives flagged,
    digests of the leaves a spec replicates and of their AdamW moments,
    the step's peak memory and its peak through backward and the sync;
    step 0's checks and, in the tp-train phase, the replay's; the peak
    memory of the steps after step 0; under ``overlap`` the hook-less
    loss's bits and the buckets) and, in the tp-train phase,
    ``smoke<r>.npz`` (the exact step's loss and synced gradients)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.convert import tree_map
    from repro_torch.core import transport
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch import training
    from repro_torch.models.parallel import init_params
    from repro_torch.optim.adamw import adamw_init

    device = torch.device(device_name)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_per_process_memory_fraction(TP_TRAIN_MEMORY_FRACTION,
                                                   torch.cuda.current_device())

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n = math.prod(TP_TRAIN_MESH)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n,
                            rank=rank)
    try:
        mesh = transport.DistMesh(TP_TRAIN_MESH, ("data", "model"), device=device)
        sizes = training.mesh_axis_sizes(mesh)
        coord = training._coords(mesh)[rank]
        cfg = _tp_train_cfg(smoke)
        setup, bspecs = _tp_train_setup(cfg, mesh, True, (TRAIN_BATCH, TRAIN_SEQ), overlap)
        step = training.make_train_step(setup, bspecs)
        whole = init_params(setup.defs, torch.Generator(device=device).manual_seed(SEED),
                            device)
        params = tree_map(torch.clone, training._local(whole, setup.specs, coord, sizes))
        # the leaves before their split over data, for step 0's gathers
        block = tree_flatten(training._local(whole, setup.specs, {**coord, "data": 0},
                                             {**sizes, "data": 1}))[0]
        block = [t.clone() for t in block]
        del whole
        if cuda:
            torch.cuda.empty_cache()
        opt = adamw_init(params)
        sync()
        specs = training._leaf_specs(setup.defs, setup.specs)
        replicated = [i for i, s in enumerate(specs)
                      if set(mesh.axis_names) - training._axes_in_spec(s)]
        want = _fsdp_plan_launches(setup, sizes, device, regather=True)
        stream = SyntheticStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
        leaf_no = _leaf_paths(setup.defs).index(FSDP_CHECK_LEAF)
        record = {"flags": [], "gathers": {}, "keep_gathers": True, "block": block,
                  "leaf": leaf_no, "leaf_cts": {}, "leaf_out": {}, "n_gathers": 0,
                  "bucket_flags": [], "buckets": [], "keep_buckets": True}
        del block
        sync_record = {"degraded": [], "check_leaf": TP_TRAIN_SYNC_LEAF, "keep_leaf": True,
                       "leaf": {}}
        out = {"rank": rank, "coord": coord, "steps": [],
               "n_params": sum(p.numel() for p in tree_flatten(params)[0]),
               "replicated": {str(i): sorted(training._axes_in_spec(specs[i]))
                              for i in replicated}}
        if overlap:
            first = next(SyntheticStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED))
            loss = _hookless_loss(setup, mesh, params, training._local(first, bspecs, coord,
                                                                       sizes), sizes)
            out["hookless_bits"] = int(np.float32(loss).view(np.int32))
            out["buckets"] = [[[[ax, c is not None] for ax, c in ops], len(idx)]
                              for ops, idx in _rank_buckets(setup, sizes)]
            out["bucket_bytes"] = setup.bucket_bytes
        # the peak through forward, backward and the sync: read where the
        # gradient norm starts, before AdamW
        real_norm, peaks = training._global_grad_norm, []

        def norm(grads, *a):
            peaks.append(int(torch.cuda.max_memory_allocated(device)) if cuda else 0)
            return real_norm(grads, *a)

        training._global_grad_norm = norm
        with _watched_in_backward(record, setup, params), _watched_sync(sync_record), \
                _watched_buckets(record):
            for s in range(TP_TRAIN_STEPS + 1):
                batch = next(stream)
                if cuda and s:
                    torch.cuda.reset_peak_memory_stats()
                _reset_launches()
                record["n_gathers"] = 0
                staged0 = mesh.staged()
                sync()
                t0 = time.perf_counter()
                (params,), (opt,), m = step([params], [opt], batch)
                sync()
                wall = time.perf_counter() - t0
                staged = [a - b for a, b in zip(mesh.staged(), staged0)]
                launches = _launches()
                flagged = [op for op, f in record["flags"] if bool(f)]
                flagged += ["sync"] * sum(bool(d) for d in sync_record["degraded"])
                flagged += ["bucket"] * sum(bool(f) for f in record["bucket_flags"])
                record["flags"].clear()
                record["bucket_flags"].clear()
                sync_record["degraded"].clear()
                p_leaves, mu, nu = (tree_flatten(t)[0] for t in (params, opt["mu"], opt["nu"]))
                out["steps"].append({
                    "metrics": {k: float(v) for k, v in m.items()},
                    "bits": {k: int(np.float32(float(v)).view(np.int32)) for k, v in m.items()},
                    "wall_s": wall, "staged_bytes": int(staged[0]),
                    "staged_s": float(staged[1]), "launches": _nonzero(launches),
                    "launches_ok": launches == want or not cuda, "flagged": flagged,
                    "gathers": record["n_gathers"], "peak_backward_bytes": peaks[-1],
                    "peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0,
                    "digests": {str(i): [_digest(p_leaves[i]), _digest(mu[i]), _digest(nu[i])]
                                for i in replicated},
                    "opt_step": int(opt["step"])})
                if s == 0:
                    out["step0"] = _tp_train_step0(setup, mesh, coord, sizes, record,
                                                   sync_record, device)
                    if overlap:
                        out["buckets0"] = _overlap_step0(mesh, record)
                    record["keep_gathers"] = record["keep_buckets"] = False
                    record.pop("leaf")
                    record.pop("block")
                    sync_record["keep_leaf"] = False
                    for k in ("gathers", "leaf_cts", "leaf_out"):
                        record[k].clear()
                    record["buckets"].clear()
                    sync_record["leaf"].clear()
                    if cuda:
                        torch.cuda.empty_cache()
        training._global_grad_norm = real_norm
        out["want"] = _nonzero(want)
        out["peak_bytes"] = max(st["peak_bytes"] for st in out["steps"][1:])
        del params, opt, step, setup, m
        if cuda:
            torch.cuda.empty_cache()

        if not overlap:
            out["replay"] = _tp_train_replay(mesh, coord, sizes, device)
            # the smoke config in f32, exact collectives, one step's loss and
            # synced gradients, for the parent to hold against the CPU's
            scfg, whole, batch = _tp_train_smoke_inputs()
            ssetup, sbspecs = _tp_train_setup(scfg, mesh, False,
                                              (FSDP_SMOKE_BATCH, FSDP_SMOKE_SEQ))
            p = tree_map(lambda t: t.clone().to(device),
                         training._local(whole, ssetup.specs, coord, sizes))
            (loss, grads), = mesh.run(lambda a: _tp_train_smoke_step(ssetup, a), [
                (p, training._local(batch, sbspecs, coord, sizes))])
            np.savez(os.path.join(out_dir, f"smoke{rank}.npz"), loss=np.float32(loss),
                     **{f"g{i}": g.cpu().numpy() for i, g in enumerate(grads)})
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _tp_train_smoke_inputs():
    """The smoke config in f32, its global weights (drawn on the CPU from
    ``SEED``) and one global batch."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.convert import tree_map
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.models.model import Model
    from repro_torch.models.parallel import init_params

    cfg = dataclasses.replace(registry.get(TRAIN_ARCH, smoke=True), dtype="float32")
    defs = Model(cfg, params={}, device="cpu").param_defs()
    whole = tree_map(lambda t: t.to(torch.float32),
                     init_params(defs, torch.Generator().manual_seed(SEED), "cpu"))
    return cfg, whole, next(SyntheticStream(cfg, FSDP_SMOKE_BATCH, FSDP_SMOKE_SEQ, seed=SEED))


def _tp_train_smoke_step(setup, args):
    """One rank's loss (unscaled) and synced gradients (flatten order) of
    one train step, before AdamW (the in-backward FSDP route, as the step
    takes on a ``DistMesh`` and a CPU ``ThreadMesh``)."""
    from repro_torch.core.grad_sync import tree_flatten
    from repro_torch.launch import training

    params, batch = args
    scale = 1.0 / (setup.ctx.tp_size * setup.ctx.fsdp_size)
    loss, grads = training._loss_and_grads(setup.model, setup.ctx, params, setup.specs, batch,
                                           scale, deferred=False)
    grads, degraded = training._sync_grads(tree_flatten(params)[1](grads), setup.specs,
                                           tuple(setup.mesh.axis_names), {})
    if bool(degraded):
        raise AssertionError("tp-train smoke step: an exact sync flagged a leaf")
    return float(loss) / scale, [g.detach() for g in tree_flatten(grads)[0]]


def _tp_train_reference_loss(device, cfg, batch=TRAIN_BATCH):
    """tp 1's loss of ``cfg``'s global weights from ``SEED`` and first
    batch of ``batch`` x ``TRAIN_SEQ`` tokens, forward only (the chunked
    attention the train step takes), then freed."""
    import torch

    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.models.model import Model
    from repro_torch.models.parallel import init_params

    model = Model(cfg, params={}, device=device)
    whole = init_params(model.param_defs(), torch.Generator(device=device).manual_seed(SEED),
                        device)
    tokens = next(SyntheticStream(cfg, batch, TRAIN_SEQ, seed=SEED))
    with torch.no_grad():
        loss = float(Model(cfg, params=whole, device=device).loss_fn(whole, tokens))
    del whole, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return loss


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(argvs, out_dir, timeout, tag, envs=None):
    """Start one child per argument list (``sys.executable`` on this
    script, never a fork; ``envs`` their environments) and wait for all
    of them; a child that fails or outlives ``timeout`` fails the phase,
    the others are killed (none is left waiting in a gloo call for a peer
    that died) and a failed child's log's tail printed.  Returns the wall
    seconds."""
    n = len(argvs)
    envs = envs or [None] * n
    logs = [open(os.path.join(out_dir, f"log{r}.txt"), "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argvs[r]],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=envs[r])
             for r in range(n)]
    t0 = time.perf_counter()
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            if time.perf_counter() - t0 > timeout:
                failed = next(r for r, p in enumerate(procs) if p.poll() is None)
                break
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            time.sleep(0.5)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if failed is not None:
        with open(os.path.join(out_dir, f"log{failed}.txt")) as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"{tag}: child {failed} failed (exit {procs[failed].returncode}, "
                             f"{time.perf_counter() - t0:.1f} s); its log's tail:\n{tail}")
    return time.perf_counter() - t0


def _hand_back_card(device, tag):
    """Return this process's cached card memory before children that share
    the card start; log what is free."""
    import gc

    import torch

    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(device)
        log(f"{tag}: {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB of the card free before "
            f"the children start ({torch.cuda.memory_reserved(device) / 2 ** 30:.2f} GiB held "
            f"here)")


def _run_processes(device, smoke, overlap=False):
    """The phase's four children (``_run_children``, one a rank), started once
    this process has handed back the card memory it no longer uses (the
    children share the card with it): the wall seconds, each rank's JSON
    and, in the tp-train phase, its smoke npz."""
    import shutil
    import tempfile

    import numpy as np

    _hand_back_card(device, "overlap" if overlap else "tp-train")
    n = math.prod(TP_TRAIN_MESH)
    out_dir = tempfile.mkdtemp(prefix="overlap_" if overlap else "tp_train_")
    try:
        port = _free_port()
        wall = _run_children([["--tp-train-child", str(r), str(port), out_dir, str(device),
                               str(int(smoke)), str(int(overlap))] for r in range(n)],
                             out_dir, TP_TRAIN_TIMEOUT, "overlap" if overlap else "tp-train")
        ranks = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        smokes = None if overlap else [dict(np.load(os.path.join(out_dir, f"smoke{r}.npz")))
                                       for r in range(n)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return wall, ranks, smokes


def _check_process_steps(ranks, tag):
    """The checks of every step of the four processes: metrics equal by
    bits and finite, nothing flagged, launches as the plans say, AdamW's
    step count, every replicated leaf and its moments equal by bits on
    the ranks that hold it; then step 0's gathers equal by bits on the
    ``data`` peers.  Returns the kernels' launches over the first
    ``TP_TRAIN_STEPS`` steps of the four processes."""
    total = dict.fromkeys(_launches(), 0)
    for s in range(TP_TRAIN_STEPS + 1):
        bits = [rk["steps"][s]["bits"] for rk in ranks]
        if any(b != bits[0] for b in bits):
            raise AssertionError(f"{tag} step {s}: the processes' metrics differ: {bits}")
        m = ranks[0]["steps"][s]["metrics"]
        if not (math.isfinite(m["loss"]) and math.isfinite(m["gnorm"])):
            raise AssertionError(f"{tag} step {s}: loss {m['loss']}, gnorm {m['gnorm']}")
        for rk in ranks:
            st = rk["steps"][s]
            if st["flagged"] or not st["launches_ok"] or st["opt_step"] != s + 1:
                raise AssertionError(f"{tag} step {s} rank {rk['rank']}: flagged "
                                     f"{st['flagged']}, launches {st['launches']} against the "
                                     f"plans' {rk['want']}, AdamW step {st['opt_step']}")
            if s < TP_TRAIN_STEPS:
                for k, v in st["launches"].items():
                    total[k] += v
        # every replicated leaf and its moments, equal by bits on the ranks
        # that hold the same block (the same coordinates on its spec's axes)
        for leaf, axes in ranks[0]["replicated"].items():
            groups = {}
            for rk in ranks:
                key = tuple(rk["coord"][ax] for ax in axes)
                groups.setdefault(key, []).append(rk["steps"][s]["digests"][leaf])
            if any(any(d != g[0] for d in g) for g in groups.values()):
                raise AssertionError(f"{tag} step {s}: replicated leaf {leaf} differs")
        log(f"{tag} step {s}: loss {m['loss']:.6f} gnorm {m['gnorm']:.4f} lr {m['lr']:.3e} "
            f"overlap_modeled {m['overlap_modeled']:.6f}, equal by bits on the {len(ranks)} "
            f"processes; {len(ranks[0]['replicated'])} replicated leaves and their moments "
            f"equal on the ranks that hold them; nothing flagged; "
            f"{ranks[0]['steps'][s]['gathers']} gathers a process (remat's regathers "
            f"included); walls " + ", ".join(
                f"{rk['steps'][s]['wall_s'] * 1e3:.1f}" for rk in ranks) + " ms"
            f"{' (cold)' if s == 0 else ''}")
    # step 0's gathers equal by bits on the data peers (the same model
    # coordinate), each already within its eb in its process
    for j in range(TP_TRAIN_MESH[1]):
        peers = [rk["step0"]["gather_digests"] for rk in ranks if rk["coord"]["model"] == j]
        if any(d != peers[0] for d in peers[1:]):
            raise AssertionError(f"{tag} step 0: the gathered weights of model rank {j} "
                                 f"differ between its data ranks")
    return total


def _log_warm(ranks, tag, extra=lambda rk: ""):
    for rk in ranks:
        warm = rk["steps"][-1]
        log(f"{tag} rank {rk['rank']} {rk['coord']}: {rk['n_params']} parameters; warm "
            f"step {warm['wall_s'] * 1e3:.1f} ms; gloo staging {warm['staged_s'] * 1e3:.1f} ms "
            f"and {warm['staged_bytes'] / 1e9:.3f} GB a step; peak "
            f"{rk['peak_bytes'] / 1e9:.2f} GB (torch.cuda.max_memory_allocated; the FsdpStep "
            f"route's {FSDP_STEP_PEAK_GB} GB), {warm['peak_backward_bytes'] / 1e9:.2f} GB of it "
            f"through backward and the sync, before AdamW; launches a step "
            f"{warm['launches']} (the plans' {rk['want']}){extra(rk)}")


def run_tp_train(device, records):
    """Phase 32 (module docstring).  Sets the kernels line's launches of
    kernels 1, 3 and 4 (the four processes' steps)."""
    import numpy as np
    import torch

    from repro_torch.launch import training
    from repro_torch.launch.mesh import ThreadMesh

    t0 = time.perf_counter()
    smoke = TP_TRAIN_SMOKE
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_loss = _tp_train_reference_loss(device, _tp_train_cfg(smoke))
    cfg = _tp_train_cfg(smoke)
    log(f"tp-train {_widths(cfg)} as published; n_layers cut 48 -> {cfg.n_layers}; mesh "
        f"(data, model) {TP_TRAIN_MESH}: {math.prod(TP_TRAIN_MESH)} processes on one card over "
        f"a gloo DistMesh, each capped at {TP_TRAIN_MEMORY_FRACTION} of the card; fsdp_gz ring "
        f"eb {FSDP_EB} (the in-backward route), norms' sync ring eb {TRAIN_EB}, remat full, "
        f"chunked attention, {TRAIN_BATCH} x {TRAIN_SEQ} tokens; tp 1's loss of the same "
        f"weights and batch {ref_loss:.6f} ({time.perf_counter() - t0:.1f} s)")
    # the smoke step's reference: the same step on a CPU ThreadMesh
    scfg, whole, batch = _tp_train_smoke_inputs()
    cmesh = ThreadMesh(TP_TRAIN_MESH, ("data", "model"), "cpu")
    csetup, cbspecs = _tp_train_setup(scfg, cmesh, False, (FSDP_SMOKE_BATCH, FSDP_SMOKE_SEQ))
    sizes, coords = training.mesh_axis_sizes(cmesh), training._coords(cmesh)
    cpu = cmesh.run(lambda a: _tp_train_smoke_step(csetup, a), [
        (training._local(whole, csetup.specs, c, sizes), training._local(batch, cbspecs, c,
                                                                          sizes))
        for c in coords])
    wall, ranks, smokes = _run_processes(device, smoke)
    total = _check_process_steps(ranks, "tp-train")
    for rk in ranks:
        c, rp = rk["step0"], rk["replay"]
        log(f"tp-train rank {rk['rank']} step 0: {c['gathers']} gathered weights within eb "
            f"{FSDP_EB} of the global weights' block (worst past one bf16 rounding "
            f"{c['gather_worst']:.3e}), equal by bits on the data peers; reduce-scattered "
            f"{'.'.join(FSDP_CHECK_LEAF)} {c['leaf_err']:.3e} (bound {c['leaf_bound']:.3e}); "
            f"synced {'.'.join(TP_TRAIN_SYNC_LEAF)} {c['sync_err']:.3e} (bound "
            f"{c['sync_bound']:.3e}); replay of the smoke step's {rp['calls']} gathers and "
            f"reduce-scatters: {rp['mism']} elements differ card/host, launches "
            f"{rp['launches']} (the plans' {rp['want']})")
    gap = abs(ranks[0]["steps"][0]["metrics"]["loss"] - ref_loss) / abs(ref_loss)
    if not gap <= TP_TRAIN_RTOL:
        raise AssertionError(f"tp-train: step 0's loss {ranks[0]['steps'][0]['metrics']['loss']} "
                             f"is {gap:.3e} from tp 1's {ref_loss} (bound {TP_TRAIN_RTOL})")
    _log_warm(ranks, "tp-train", lambda rk: f"; loss gap to tp 1 {gap:.3e}")
    worst = 0.0
    for r, (sm, (closs, cgrads)) in enumerate(zip(smokes, cpu)):
        worst = max(worst, abs(float(sm["loss"]) - closs) / abs(closs))
        for i, g in enumerate(cgrads):
            g = g.numpy().astype(np.float64)
            gap_i = np.abs(sm[f"g{i}"].astype(np.float64) - g).max() / max(np.abs(g).max(), 1e-30)
            worst = max(worst, float(gap_i))
    log(f"tp-train smoke ({scfg.arch_id}, f32, exact collectives) on the {len(ranks)} "
        f"processes against a CPU ThreadMesh {TP_TRAIN_MESH}: loss and {len(cpu[0][1])} synced "
        f"gradients a rank, worst gap {worst:.3e} of the largest value (bound "
        f"{TP_TRAIN_SMOKE_RTOL})")
    if not worst <= TP_TRAIN_SMOKE_RTOL:
        raise AssertionError(f"tp-train smoke: card and CPU {worst:.3e} apart")
    for name in ("quantize_pack", "unpack_dequantize_reduce", "unpack_dequantize"):
        _record(records, name)["launches"] = total[name]
    log(f"tp-train phase: {time.perf_counter() - t0:.1f} s ({wall:.1f} s in the processes); "
        f"kernels over {TP_TRAIN_STEPS} steps and {len(ranks)} processes {_nonzero(total)}")


# ---------------------------------------------------------------------------
# Phase 34: the backward-overlapped bucketed sync
# ---------------------------------------------------------------------------


def run_overlap(device, records):
    """Phase 34 (module docstring).  Sets the kernels line's launches of
    kernels 1, 3 and 4 (the four processes' steps)."""
    import torch

    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = _tp_train_cfg(TP_TRAIN_SMOKE)
    wall, ranks, _ = _run_processes(device, TP_TRAIN_SMOKE, overlap=True)
    first = ranks[0]
    log(f"overlap: the tp-train cell ({cfg.arch_id}, {cfg.n_layers} layers, (data, model) "
        f"{TP_TRAIN_MESH}, four gloo processes) with overlap_sync: {len(first['buckets'])} "
        f"buckets a rank of {first['bucket_bytes']} bytes (the BucketPlan's), "
        f"{sum(1 for ops, _ in first['buckets'] if ops)} with a collective: "
        + "; ".join(f"{'+'.join(ax + ('(gz)' if gz else '') for ax, gz in ops) or 'none'} "
                    f"x {k} leaves" for ops, k in first["buckets"]))
    total = _check_process_steps(ranks, "overlap")
    for rk in ranks:
        loss0 = rk["steps"][0]["bits"]["loss"]
        if loss0 != rk["hookless_bits"]:
            raise AssertionError(f"overlap rank {rk['rank']}: step 0's loss bits {loss0} are "
                                 f"not the hook-less forward's {rk['hookless_bits']}")
        c = rk["step0"]
        log(f"overlap rank {rk['rank']} step 0: loss equal by bits to the hook-less forward's; "
            f"{c['gathers']} gathered weights within eb {FSDP_EB} (worst past one bf16 "
            f"rounding {c['gather_worst']:.3e}); reduce-scattered "
            f"{'.'.join(FSDP_CHECK_LEAF)} {c['leaf_err']:.3e} (bound {c['leaf_bound']:.3e}); "
            + "; ".join(f"bucket {b['ops']} of {b['numel']} elements {b['err']:.3e} from the "
                        f"exact sum (bound {b['bound']:.3e}), {b['mism']} elements differ "
                        f"card/host" for b in rk["buckets0"]))
    _log_warm(ranks, "overlap")
    for name in ("quantize_pack", "unpack_dequantize_reduce", "unpack_dequantize"):
        _record(records, name)["launches"] = total[name]
    log(f"overlap phase: {time.perf_counter() - t0:.1f} s ({wall:.1f} s in the processes); "
        f"kernels over {TP_TRAIN_STEPS} steps and {len(ranks)} processes {_nonzero(total)}")


# ---------------------------------------------------------------------------
# Phase 33: the context-parallel decode cache
# ---------------------------------------------------------------------------

# (arch, tp, layers as TP_DENSE's) and the (data, model) meshes that split
# the context of its batch-1 cache, each against the unsplit (1, tp)
CP_MODELS = (
    (("minitron-8b", 2, 4), ((2, 2), (4, 1))),  # of 32 layers; (4, 1) against (1, 1)
    (("zamba2-2.7b", 2, 12), ((2, 2),)),  # of 54 layers, as tp-families
    (("seamless-m4t-medium", 2, None), ((2, 2),)),  # 12 + 12
)
CP_STEPS = 8
CP_RTOL = 1e-5  # the f32 split logits' gap over the largest unsplit logit
# (decode shape, start position): long_500k's ring of 8192 slots from slot
# 4,092, and a batch-1 cache of 32,768 slots from 16,380; at cp 2 and 4 both
# runs write across a boundary between two data ranks' slices
CP_CASES = (("long_500k", 524_288 - 8192 + 4092), ("decode-32k-batch-1", 16_380))


def _cp_shape(name):
    from repro_torch.launch import shapes

    if name in shapes.INPUT_SHAPES:
        return shapes.INPUT_SHAPES[name]
    return shapes.InputShape(name, 32_768, 1, "decode")


def _bits_equal(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8),
                                              b.contiguous().view(torch.uint8))


def _cp_cache_gaps(split, whole, written, dtype):
    """Hold the split run's global cache against the unsplit run's: every
    k and v slot no step wrote equal by bits, on every rank (nothing
    written off its owner), and the first attention layer's written rows
    too (no combine lies on their way: the later layers' rows take its
    rounding through their inputs); ``enc_out`` by bits.  Returns each
    entry's largest gap over its largest unsplit value, gated at
    ``CP_RTOL`` in f32."""
    import torch

    gaps = {}
    for k in sorted(whole):
        a, b = split[k], whole[k]
        if k in ("k", "v"):
            keep = torch.ones(a.shape[2], dtype=torch.bool, device=a.device)
            keep[written] = False
            if not _bits_equal(a[:, :, keep], b[:, :, keep]):
                raise AssertionError(f"cp-decode {k}: a slot no step wrote differs")
            if not _bits_equal(a[0], b[0]):
                raise AssertionError(f"cp-decode {k}: the first attention layer's rows differ")
        if k == "enc_out" and not _bits_equal(a, b):
            raise AssertionError("cp-decode enc_out changed")
        gaps[k] = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        if dtype == "float32" and not gaps[k] <= CP_RTOL:
            raise AssertionError(f"cp-decode {k}: {gaps[k]:.3e} from the unsplit cache")
    return gaps


def _cp_run(tag, cfg, mesh_shape, whole, cache, shape, toks, start, device):
    """``CP_STEPS`` steps of ``make_serve_step`` for a batch-1 decode
    ``shape`` on a ``ThreadMesh`` of the card, the weights replicated over
    ``data``, from the global ``cache`` (written in place); kernel 11
    counted from 0 and every launch held against its plain version.
    Returns (each step's logits, seconds, the plan, kernel 11's
    launches)."""
    import torch

    from repro_torch.launch import shapes, training
    from repro_torch.launch.mesh import ThreadMesh

    mesh = ThreadMesh(mesh_shape, ("data", "model"), device)
    setup = training.make_setup(cfg, mesh, fsdp=False, remat="none")
    sizes = training.mesh_axis_sizes(mesh)
    params = [training._local(whole, setup.specs, c, sizes) for c in training._coords(mesh)]
    _, cspecs, _, tspec, plan = shapes.decode_specs(cfg, shape, mesh, setup.model)
    step = training.make_serve_step(setup, cspecs, tspec, plan)

    def run():
        return [step(params, cache, toks[:, i:i + 1], start + i)[0] for i in range(CP_STEPS)]

    record = []
    _reset_launches()
    with _checked_flash(record), torch.no_grad():
        logits, secs = _timed(run)
    launches = _tp_flash_verdict(
        tag, record, _tp_family_plan(cfg, mesh.size)[1] * CP_STEPS) if record else 0
    return logits, secs, plan, launches


def _cp_model(spec, meshes, device, stats):
    """One ``CP_MODELS`` row: in f32 (weights and ``cfg.dtype``, gated) for
    each ``CP_CASES`` case and split mesh, in bf16 (logged) for the first
    (``long_500k`` on the row's first mesh), a global cache of seeded
    random values (k and v in the run's dtype; the states and ``enc_out``
    f32) as a prefill would have left it, decoded ``CP_STEPS`` steps on the
    split mesh and on the unsplit ``(1, tp)`` from copies of it.  Returns
    kernel 11's launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.launch import shapes, training
    from repro_torch.launch.mesh import ThreadMesh

    arch, tp, _ = spec
    base = _tp_cfg(spec)
    model, bf16 = _family_model(base, None, device, f"; {base.n_layers} layers, tp {tp}, "
                                f"kernel 11 {'on' if base.use_flash_kernel else 'off'}")
    del model
    launches = 0
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        whole = bf16 if dtype == "bfloat16" else convert.tree_map(lambda p: p.float(), bf16)
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (1, CP_STEPS)).astype(np.int32)).to(device)
        for name, start in CP_CASES if dtype == "float32" else CP_CASES[:1]:
            shape = _cp_shape(name)
            for split in meshes if dtype == "float32" else meshes[:1]:
                unsplit = (1, split[1])
                umesh = ThreadMesh(unsplit, ("data", "model"), device)
                cache, _, _, _, _ = shapes.decode_specs(
                    cfg, shape, umesh, training.make_setup(cfg, umesh, fsdp=False).model,
                    cache_dtype=whole["embed"].dtype)
                gen = torch.Generator(device=device).manual_seed(SEED)
                whole_c = {k: torch.randn(v.shape, generator=gen, device=device).to(v.dtype)
                           for k, v in sorted(cache.items())}
                split_c = {k: v.clone() for k, v in whole_c.items()}
                tag = f"cp-decode {arch} {dtype} {name}"
                got, split_s, plan, n_split = _cp_run(f"{tag} {split}", cfg, split, whole,
                                                      split_c, shape, toks, start, device)
                want, whole_s, uplan, n_whole = _cp_run(f"{tag} {unsplit}", cfg, unsplit,
                                                        whole, whole_c, shape, toks, start,
                                                        device)
                launches += n_split + n_whole
                if (plan.cp_size, plan.s_local * plan.cp_size, uplan.cp_size) != \
                        (split[0], uplan.s_local, 1):
                    raise AssertionError(f"{tag}: plan {plan}, unsplit {uplan}")
                gap = 0.0
                for i, (g, w) in enumerate(zip(got, want)):
                    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                        raise AssertionError(f"{tag} step {i}: logits {tuple(g.shape)} "
                                             f"against {tuple(w.shape)}")
                    gap = max(gap, float((g.float() - w.float()).abs().max()
                                         / w.float().abs().max()))
                if dtype == "float32" and not gap <= CP_RTOL:
                    raise AssertionError(f"{tag} {split}: logits {gap:.3e} from the unsplit "
                                         f"decode (bound {CP_RTOL})")
                pos = start + np.arange(CP_STEPS)
                written = torch.from_numpy(pos % plan.window if plan.window else pos)
                gaps = _cp_cache_gaps(split_c, whole_c, written.to(device), dtype)
                ms = (1e3 * split_s / CP_STEPS, 1e3 * whole_s / CP_STEPS)
                stats.setdefault(arch, {})[f"{dtype} {name} {split}"] = [round(m, 3) for m in ms]
                log(f"{tag} (window {plan.window}, positions {start}..{start + CP_STEPS - 1}, "
                    f"slots {int(written[0])}..{int(written[-1])}): split {split}, cp "
                    f"{plan.cp_size}, {plan.s_local} slots a rank, against unsplit {unsplit}: "
                    f"logits max gap {gap:.3e} of the largest "
                    f"({'bound %g' % CP_RTOL if dtype == 'float32' else 'logged'}); cache gaps "
                    f"{', '.join(f'{k} {v:.3e}' for k, v in gaps.items())}, the unwritten "
                    f"slots and the first attention layer's rows equal by bits; "
                    f"{ms[0]:.2f} ms/step split, {ms[1]:.2f} unsplit; kernel 11 launched "
                    f"{n_split} + {n_whole} times")
                del split_c, whole_c, got, want
        del whole
    del bf16
    torch.cuda.empty_cache()
    return launches


def run_cp_decode(device, records):
    """Phase 33 (module docstring).  Sets the kernels line's launches of
    kernel 11 (seamless-m4t-medium's cross attention in this phase's decode
    steps) and adds the phase's decode ms a step (split, unsplit)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    stats, launches = {}, 0
    for spec, meshes in CP_MODELS:
        launches += _cp_model(spec, meshes, device, stats)
    rec = _record(records, "flash_attention")
    rec["launches"] = launches
    rec["cp_decode_ms_per_step"] = stats
    log(f"cp-decode phase: {time.perf_counter() - t0:.1f} s; kernel 11 launched {launches} "
        f"times, each within FLASH_TOL of its plain version")


# ---------------------------------------------------------------------------
# Phase 35: the training CLI on a DistMesh
# ---------------------------------------------------------------------------

# the train cell (internlm2-20b, every published width, depth 48 -> 2, the
# replicated leaves' sync ring at eb 1e-4) through the CLI: one process a
# rank of (data 4, model 1) under torchrun's variables, the card shared
# over gloo (NCCL puts no two ranks on one card, C24), each process capped
# at TP_TRAIN_MEMORY_FRACTION of it
TRAIN_CLI_RANKS = 4
TRAIN_CLI_FULL_ARGV = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
                       str(TRAIN_CLI_RANKS), "--seq", str(TRAIN_SEQ), "--grad-gz", "ring",
                       "--eb", str(TRAIN_EB), "--dist-backend", "gloo"]
TRAIN_CLI_SYNC_LEAF = ("final_norm",)  # replicated under FSDP: the data ring syncs it
TRAIN_CLI_LOSS_RTOL = 1e-6  # step 0's loss against the one-rank loss (measured 0.0 on the H100)
TRAIN_CLI_CKPT_EVERY = 6  # of TRAIN_CLI_ARGV's 12 steps: two checkpoints
TRAIN_CLI_TIMEOUT = 480  # seconds, a run's children together
TRAIN_CLI_SMOKE = False  # internlm2-20b's smoke config in the full-width run (a CPU rehearsal)


def _rank_env(rank, world, port):
    """torchrun's variables for ``rank`` of a one-host world of ``world``."""
    return {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _train_cli_child(out_path, cut, argv):
    """One process of the train-cli phase, under torchrun's variables:
    its share of the card, then ``launch.train.train(argv)`` (with ``cut``,
    ``registry.get`` cut to ``TRAIN_LAYERS``), the kernels' launches
    counted from 0 around it.  Writes ``out_path`` (JSON): the losses,
    each step's metrics by their bits, wall, gloo staging and peak memory,
    the printed lines, the launches against the plans', the syncs
    flagged, and ``TRAIN_CLI_SYNC_LEAF``'s step-0 sync (``_cli_sync_leaf``),
    its input and output gradient beside it (``.npz``)."""
    import io

    import numpy as np
    import torch

    from repro_torch.launch import train as cli
    from repro_torch.launch import training

    cuda = torch.device(argv[argv.index("--device") + 1]).type == "cuda"
    if cuda:
        torch.cuda.set_per_process_memory_fraction(
            TP_TRAIN_MEMORY_FRACTION, int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    steps, kept = [], {}
    real = cli.make_train_step

    def keeping(setup, bspecs):
        step = real(setup, bspecs)
        kept["setup"] = setup

        def run(params, opt, batch):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            staged0, t0 = setup.mesh.staged(), time.perf_counter()
            params, opt, m = step(params, opt, batch)
            if cuda:
                torch.cuda.synchronize()
            staged = [a - b for a, b in zip(setup.mesh.staged(), staged0)]
            steps.append({
                "metrics": {k: float(m[k]) for k in ("loss", "gnorm", "lr")},
                "bits": {k: int(np.float32(float(m[k])).view(np.int32))
                         for k in ("loss", "gnorm", "lr")},
                "wall_s": time.perf_counter() - t0, "staged_bytes": int(staged[0]),
                "staged_s": float(staged[1]),
                "peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0})
            if record.pop("keep_leaf", False):
                record["keep_args"] = False
                kept["leaf"] = _cli_sync_leaf(setup, record)
            return params, opt, m

        return run

    cli.make_train_step = keeping
    record = {"degraded": [], "check_leaf": TRAIN_CLI_SYNC_LEAF, "keep_leaf": True,
              "keep_args": True, "leaf": {}, "args": {}}
    out = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if cut:
            stack.enter_context(_registry_cut(TRAIN_ARCH, TRAIN_LAYERS))
        stack.enter_context(_watched_sync(record))
        stack.enter_context(contextlib.redirect_stdout(out))
        losses = cli.train(argv)
    wall = time.perf_counter() - t0
    launches = _launches()
    setup = kept["setup"]
    sizes = training.mesh_axis_sizes(setup.mesh)
    want = {k: v * len(steps) for k, v in
            _fsdp_plan_launches(setup, sizes, setup.mesh.device, regather=True).items()}
    print(out.getvalue(), end="")
    leaf, grads = kept["leaf"]
    np.savez(out_path[:-len(".json")] + ".npz", **grads)
    with open(out_path, "w") as f:
        json.dump({"rank": int(os.environ["RANK"]), "mesh": sizes, "losses": losses,
                   "steps": steps, "lines": out.getvalue().splitlines(), "wall_s": wall,
                   "launches": launches, "want": want,
                   "launches_ok": launches == want or not cuda,
                   "flagged": sum(bool(d) for d in record["degraded"]), "sync_leaf": leaf}, f)


def _cli_sync_leaf(setup, record):
    """Step 0's sync of ``TRAIN_CLI_SYNC_LEAF`` in one process of the
    train-cli phase (``_watched_sync``'s record): the same sync again on
    the host (the plain versions: CPU communicators of the same plans,
    over the same ``DistMesh``), its output's elements that differ by bits
    from the card's, the allreduce plan's error terms and flag; and the
    rank's input and output gradient in f32 (``in``, ``out``) for the
    parent to hold against the exact rank-order sum.  (None, {}) over
    NCCL, which carries no host tensor to replay."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import error_budget
    from repro_torch.launch import training

    rank = setup.mesh.rank
    g, synced = record["leaf"].pop(rank)
    grads, specs, mesh_axes, grad_comms = record["args"].pop(rank)
    if dist.get_backend() != "gloo":
        return None, {}
    leaf = grads
    for k in TRAIN_CLI_SYNC_LEAF:
        leaf, specs = leaf[k], specs[k]
    dtype = leaf.dtype
    del grads, leaf
    cpu_comms = {ax: _cpu_comm(c) for ax, c in grad_comms.items() if c is not None}
    ((host, degraded),) = setup.mesh.run(
        lambda x: record["real"]({"x": x}, {"x": specs}, mesh_axes, cpu_comms),
        [g.to(dtype).cpu()])
    host = host["x"].float()
    mism = int((host.view(torch.int32) != synced.cpu().view(torch.int32)).sum())
    plan = grad_comms["data"].plan("allreduce", tuple(g.shape), dtype)
    return ({"shape": list(g.shape), "dtype": str(dtype), "host_mism": mism,
             "host_flagged": bool(degraded), "algo": plan.algo, "chunks": plan.pipeline_chunks,
             "eb_stage": plan.eb_stage,
             "hops": error_budget.lossy_hops(f"allreduce_{plan.algo}",
                                             training.mesh_axis_sizes(setup.mesh)["data"])},
            {"in": g.cpu().numpy(), "out": synced.cpu().numpy()})


def _train_cli_runs(jobs, tag):
    """Run ``jobs`` ([(cut, argv, env)]) as children of this script
    together; each child's JSON in job order, its synced leaf's input and
    output gradient under ``grads``."""
    import shutil
    import tempfile

    import numpy as np

    out_dir = tempfile.mkdtemp(prefix="train_cli_")
    try:
        argvs = [["--train-cli-child", os.path.join(out_dir, f"cli{j}.json"), str(int(cut)),
                  *argv] for j, (cut, argv, _) in enumerate(jobs)]
        wall = _run_children(argvs, out_dir, TRAIN_CLI_TIMEOUT, tag,
                             [env for _, _, env in jobs])
        ranks = []
        for j in range(len(jobs)):
            with open(os.path.join(out_dir, f"cli{j}.json")) as f:
                ranks.append(json.load(f))
            with np.load(os.path.join(out_dir, f"cli{j}.npz")) as z:
                ranks[-1]["grads"] = {k: z[k] for k in z.files}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return wall, ranks


def _no_wall(line):
    return re.sub(r"\(\d+\.\ds\)$", "(wall)", line)


def _check_cli_processes(ranks, tag, flags=True):
    """Every process's metrics equal by bits at every step and finite,
    its printed lines equal but for the wall field, launches as the plans
    say and, with ``flags``, no sync flagged (the smoke config's norms
    overflow the ring's capacity at 4 ranks: a chunk of 32 elements
    padded to its 256-element block; their fallback is exact)."""
    for rk in ranks:
        if [st["bits"] for st in rk["steps"]] != [st["bits"] for st in ranks[0]["steps"]]:
            raise AssertionError(f"{tag}: process {rk['rank']}'s metrics differ from process "
                                 f"0's")
        if [_no_wall(x) for x in rk["lines"]] != [_no_wall(x) for x in ranks[0]["lines"]]:
            raise AssertionError(f"{tag}: process {rk['rank']} printed other lines:\n"
                                 + "\n".join(rk["lines"]))
        finite = all(math.isfinite(x) for x in rk["losses"])
        if not finite or (flags and rk["flagged"]) or not rk["launches_ok"]:
            raise AssertionError(f"{tag} process {rk['rank']}: losses {rk['losses']}, "
                                 f"{rk['flagged']} syncs flagged, launches "
                                 f"{_nonzero(rk['launches'])} against the plans' "
                                 f"{_nonzero(rk['want'])}")
    for line in ranks[0]["lines"]:
        log(f"{tag}: {line}")


def _check_cli_sync_leaf(ranks, tag, flagged=False):
    """``TRAIN_CLI_SYNC_LEAF``'s step-0 sync in every process
    (``_cli_sync_leaf``): the synced leaf equal by bits on every process
    and to its replay on the host, the same flag on the host as on the
    card, and within the allreduce's bound of the exact rank-order sum of
    the processes' inputs (its lossy hops' ``eb_stage``, then the cast of
    the f32 result to the leaf's dtype).  With ``flagged`` (the smoke
    config's norms overflow the ring at 4 ranks) the fallback's exact sum
    instead of the ring's."""
    import numpy as np

    leaf = ranks[0]["sync_leaf"]
    exact = sum(rk["grads"]["in"].astype(np.float64) for rk in ranks)
    rounding = 2.0 ** -8 if leaf["dtype"] == "torch.bfloat16" else 2.0 ** -23
    bound = leaf["hops"] * leaf["eb_stage"] + rounding * float(np.abs(exact).max())
    out0 = ranks[0]["grads"]["out"]
    for rk in ranks:
        out = rk["grads"]["out"]
        err = float(np.abs(out.astype(np.float64) - exact).max())
        if (rk["sync_leaf"]["host_mism"] or rk["sync_leaf"]["host_flagged"] != flagged
                or out.tobytes() != out0.tobytes() or not err <= bound):
            raise AssertionError(f"{tag} process {rk['rank']}: synced "
                                 f"{'.'.join(TRAIN_CLI_SYNC_LEAF)} error {err} (bound {bound}), "
                                 f"{rk['sync_leaf']['host_mism']} elements differ from the "
                                 f"host's replay, flagged {rk['sync_leaf']['host_flagged']} "
                                 f"(want {flagged}), or it differs from process 0's")
    log(f"{tag}: synced {'.'.join(TRAIN_CLI_SYNC_LEAF)} {tuple(leaf['shape'])} "
        f"{leaf['dtype']} at step 0: max error {err:.3e} vs the exact rank-order sum of the "
        f"{len(ranks)} processes' gradients, bound {bound:.3e} (plan {leaf['algo']}/"
        f"{leaf['chunks']}, {leaf['hops']} lossy hops, eb_stage {leaf['eb_stage']:.3e}"
        f"{', flagged: the exact fallback' if flagged else ''}); equal by bits on every "
        f"process and to its replay on the host (the plain versions)")


def _threadmesh_cli(argv, device_count):
    """The CLI's ``ThreadMesh`` route in this process, the host's device
    count taken as ``device_count`` (as ``tests/test_torch_train.py``
    takes it): its losses."""
    import io

    from repro_torch.launch import train as cli

    real = cli._device_count
    cli._device_count = lambda device: device_count
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return cli.train(argv)
    finally:
        cli._device_count = real


def _same_files(a, b):
    """The number of files under ``a``, each equal by bytes to its
    namesake under ``b``, and none of ``b``'s missing."""
    def names(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    if names(a) != names(b):
        raise AssertionError(f"checkpoints {a} and {b} hold other files")
    for n in names(a):
        with open(os.path.join(a, n), "rb") as x, open(os.path.join(b, n), "rb") as y:
            if x.read() != y.read():
                raise AssertionError(f"checkpoint file {n} differs between {a} and {b}")
    return len(names(a))


def _loss_bits(losses):
    import numpy as np

    return [int(np.float32(x).view(np.int32)) for x in losses]


def run_train_cli(device, records):
    """Phase 35 (module docstring).  Sets the kernels line's launches of
    kernels 1-4 (the full-width run's four processes over its steps)."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import registry

    t0 = time.perf_counter()
    dev = ["--device", str(device)]
    smoke = TRAIN_CLI_SMOKE
    cfg = registry.get(TRAIN_ARCH, smoke=smoke)
    if not smoke:
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_loss = _tp_train_reference_loss(device, cfg, batch=TRAIN_CLI_RANKS)
    _hand_back_card(device, "train-cli")
    log(f"train-cli {_widths(cfg)}; n_layers cut 48 -> {cfg.n_layers}; `launch.train.train` "
        f"in {TRAIN_CLI_RANKS} processes under torchrun's variables, a gloo DistMesh "
        f"({TRAIN_CLI_RANKS}, 1) on the one card, each capped at {TP_TRAIN_MEMORY_FRACTION} "
        f"of it; argv {' '.join(TRAIN_CLI_FULL_ARGV)}; tp 1's loss of the same weights and "
        f"first batch {ref_loss:.6f} ({time.perf_counter() - t0:.1f} s)")
    port = _free_port()
    argv = TRAIN_CLI_FULL_ARGV + dev + (["--smoke"] if smoke else [])
    wall, ranks = _train_cli_runs([(not smoke, argv, _rank_env(r, TRAIN_CLI_RANKS, port))
                                   for r in range(TRAIN_CLI_RANKS)], "train-cli")
    _check_cli_processes(ranks, "train-cli", flags=not smoke)
    if ranks[0]["mesh"] != {"data": TRAIN_CLI_RANKS, "model": 1}:
        raise AssertionError(f"train-cli: mesh {ranks[0]['mesh']}")
    loss0 = ranks[0]["losses"][0]
    gap = abs(loss0 - ref_loss) / abs(ref_loss)
    if not gap <= TRAIN_CLI_LOSS_RTOL:
        raise AssertionError(f"train-cli: step 0's loss {loss0} is {gap:.3e} from the one-rank "
                             f"loss {ref_loss} (bound {TRAIN_CLI_LOSS_RTOL})")
    _check_cli_sync_leaf(ranks, "train-cli", flagged=smoke)
    total = dict.fromkeys(_launches(), 0)
    for rk in ranks:
        for k, v in rk["launches"].items():
            total[k] += v
        warm = rk["steps"][1:]
        log(f"train-cli process {rk['rank']}: steps "
            + ", ".join(f"{st['wall_s'] * 1e3:.1f}" for st in rk["steps"])
            + " ms (step 0 cold); gloo staging "
            + ", ".join(f"{st['staged_s'] * 1e3:.1f} ms / {st['staged_bytes'] / 1e9:.3f} GB"
                        for st in rk["steps"])
            + f"; staged share of the warm steps "
            f"{sum(st['staged_s'] for st in warm) / sum(st['wall_s'] for st in warm):.3f}; "
            f"peak {max(st['peak_bytes'] for st in rk['steps']) / 1e9:.2f} GB "
            f"(torch.cuda.max_memory_allocated, a step); launches {_nonzero(rk['launches'])} "
            f"(the plans' {_nonzero(rk['want'])}); the CLI {rk['wall_s']:.1f} s")
    log(f"train-cli: step 0's loss {loss0:.6f} is {gap:.3e} from the one-rank loss (bound "
        f"{TRAIN_CLI_LOSS_RTOL}); the {len(ranks)} processes' losses, gnorms and lrs equal by bits "
        f"at every step, their lines equal but for the wall; {wall:.1f} s in the processes")

    # the smoke CLI: four gloo processes against the ThreadMesh route with
    # data 4, one NCCL process (world 1) against the one-rank ThreadMesh
    # route; losses and checkpoints by bits
    tmp = tempfile.mkdtemp(prefix="train_cli_ckpt_")
    try:
        dirs = {k: os.path.join(tmp, k) for k in ("thread4", "thread1", "dist4", "dist1")}

        def smoke_argv(key):
            return TRAIN_CLI_ARGV + dev + ["--ckpt-every", str(TRAIN_CLI_CKPT_EVERY),
                                           "--ckpt-dir", dirs[key]]

        port4, port1 = _free_port(), _free_port()
        # NCCL on the card; the CPU rehearsal has none
        backend = "nccl" if device.type == "cuda" else "gloo"
        jobs = [(False, smoke_argv("dist4") + ["--dist-backend", "gloo"],
                 _rank_env(r, TRAIN_CLI_RANKS, port4)) for r in range(TRAIN_CLI_RANKS)]
        jobs.append((False, smoke_argv("dist1") + ["--dist-backend", backend],
                     _rank_env(0, 1, port1)))
        wall_smoke, smokes = _train_cli_runs(jobs, "train-cli smoke")
        t1 = time.perf_counter()
        thread4 = _threadmesh_cli(smoke_argv("thread4"), TRAIN_CLI_RANKS)
        thread1 = _threadmesh_cli(smoke_argv("thread1"), 1)
        t_thread = time.perf_counter() - t1
        _check_cli_processes(smokes[:TRAIN_CLI_RANKS], "train-cli smoke", flags=False)
        for rk, want, what in [(rk, thread4, "the ThreadMesh route at data 4")
                               for rk in smokes[:TRAIN_CLI_RANKS]] + \
                [(smokes[-1], thread1, "the one-rank ThreadMesh route")]:
            if _loss_bits(rk["losses"]) != _loss_bits(want):
                raise AssertionError(f"train-cli smoke: process {rk['rank']} of mesh "
                                     f"{rk['mesh']}: losses {rk['losses']} differ from "
                                     f"{what}'s {want}")
        for losses in (thread4, thread1, smokes[0]["losses"], smokes[-1]["losses"]):
            if not losses[-1] < losses[0]:
                raise AssertionError(f"train-cli smoke: final loss {losses[-1]} not below "
                                     f"{losses[0]}")
        files4 = _same_files(dirs["dist4"], dirs["thread4"])
        files1 = _same_files(dirs["dist1"], dirs["thread1"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"train-cli smoke ({' '.join(TRAIN_CLI_ARGV)}, --ckpt-every {TRAIN_CLI_CKPT_EVERY}): "
        f"{TRAIN_CLI_RANKS} gloo processes, mesh {smokes[0]['mesh']}, losses equal by bits to "
        f"the ThreadMesh route's at data 4 (on the card through FsdpStep, C6), {files4} "
        f"checkpoint files equal by bytes; final loss {thread4[-1]:.6f} below the first "
        f"{thread4[0]:.6f}")
    log(f"train-cli smoke: one {backend} process at world size 1 (the first NCCL process group "
        f"on a card, C10; one rank, no multi-rank figure), mesh {smokes[-1]['mesh']}, losses "
        f"equal by bits to the one-rank ThreadMesh route's, {files1} checkpoint files equal by "
        f"bytes; final loss {thread1[-1]:.6f} below the first {thread1[0]:.6f}; the "
        f"processes {wall_smoke:.1f} s, then the ThreadMesh runs {t_thread:.1f} s")
    for name in ("quantize_pack", "unpack_reduce_repack", "unpack_dequantize_reduce",
                 "unpack_dequantize"):
        _record(records, name)["launches"] = total[name]
    log(f"train-cli phase: {time.perf_counter() - t0:.1f} s; kernels over {TRAIN_STEPS} steps "
        f"and {len(ranks)} processes {_nonzero(total)}")


PHASES = ("kernels", "allreduce", "movers", "codecs", "grad-sync", "faults", "hier", "c6",
          "model", "train", "ssm", "mla", "moe", "encdec", "vlm", "fsdp", "tp",
          "tp-families", "tp-train", "cp-decode", "overlap", "train-cli")


def _record(records, name):
    """The kernels-line record of ``name`` (a stub in a partial run
    without the kernel phase)."""
    return records.setdefault(name, {"name": name})


def main(argv=()) -> int:
    if argv and argv[0] == "--tp-train-child":  # one rank of phase 32 or 34
        sys.path.insert(0, str(SRC))
        rank, port, out_dir, device, smoke, overlap = argv[1:7]
        _tp_train_child(int(rank), int(port), out_dir, device, smoke == "1", overlap == "1")
        return 0
    if argv and argv[0] == "--train-cli-child":  # one process of phase 35
        sys.path.insert(0, str(SRC))
        _train_cli_child(argv[1], argv[2] == "1", list(argv[3:]))
        return 0
    phases = set(argv[argv.index("--phases") + 1].split(",")) if "--phases" in argv \
        else set(PHASES)
    if not phases <= set(PHASES):
        print(f"chip_smoke.py: --phases takes a comma list of {PHASES}", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    for name, rec in build.build_all().items():  # one nvcc per source, together
        log(f"built {name}.cu in {rec['seconds']:.1f} s")
        for line in ptxas_lines(rec["ptxas"]):
            log(f"  ptxas {name}.cu {line}")
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    check_flash_sass()
    gen = torch.Generator(device=device).manual_seed(SEED)
    records = {}
    if "kernels" in phases:
        records.update(check_kernels(device, gen))
        records.update(check_unfused_kernels(device, gen))
        records.update(check_entropy_kernels(device, gen))

    if "allreduce" in phases:
        plan, launches, _ = run_allreduce(8, MAIN_BYTES, device, gen, label="main",
                                          profile=True)
        if (plan.algo, plan.pipeline_chunks) != ("ring", 2):
            raise AssertionError(f"646 MB plan is {plan.algo}/{plan.pipeline_chunks}, "
                                 "expected ring/2")
        for name in ("quantize_pack", "unpack_reduce_repack", "unpack_dequantize_reduce",
                     "unpack_dequantize"):
            _record(records, name)["launches"] = launches[name]
        run_allreduce(8, 16_000_000, device, gen, label="16MB")
        run_allreduce(6, 16_000_000, device, gen, {"algo": "redoub"}, label="16MB")
        kernels_vs_plain_allreduce(device)
        torch.cuda.empty_cache()

    if "movers" in phases:
        # The paper's Fig. 12 scatter, then the other data movers.
        plan, launches, _, fused_run = run_scatter(8, MAIN_BYTES, device, gen, "main",
                                                   profile=True)
        if plan.wire_bytes != SCATTER_WIRE_BYTES:
            raise AssertionError(f"scatter wire bytes {plan.wire_bytes} != "
                                 f"{SCATTER_WIRE_BYTES}")
        _record(records, "quantize")["launches"] = launches["quantize"]
        run_scatter(6, 64_000_000, device, gen, "trimmed")
        run_movers(device, gen)
        two_pass = run_two_pass(device, gen)
        # The paper's gZ-Scatter on the two-pass codec, on the same input.
        plan, launches, _, _ = run_scatter(8, MAIN_BYTES, device, gen, "main", profile=True,
                                           fused=False, fused_run=fused_run)
        if plan.wire_bytes != SCATTER_WIRE_BYTES or \
                (launches["quantize"], launches["dequantize"]) != (1, 8):
            raise AssertionError(f"fused=False scatter: wire bytes {plan.wire_bytes}, "
                                 f"launches {_nonzero(launches)}")
        del fused_run
        torch.cuda.empty_cache()
        _record(records, "dequantize_reduce")["launches"] = \
            two_pass[("redoub", ("fused",))]["dequantize_reduce"]
        _record(records, "dequantize")["launches"] = two_pass[("ring", ("fused",))]["dequantize"]

    if "codecs" in phases:
        run_entropy_allreduce(device, gen)
        plan, *_ = run_scatter(8, MAIN_BYTES, device, gen, "main", codec="lorenzo+entropy")
        if plan.wire_bytes != SCATTER_WIRE_BYTES:
            raise AssertionError(f"entropy scatter wire bytes {plan.wire_bytes}")

    if "grad-sync" in phases:
        # This slice's main path: data-parallel gradient sync.
        main_launches, launches6 = run_grad_sync(device, gen)
        for name in ("entropy_quantize_pack", "entropy_unpack_dequantize_reduce"):
            _record(records, name)["launches"] = main_launches[name]
        _record(records, "entropy_unpack_dequantize")["launches"] = \
            launches6["entropy_unpack_dequantize"]

    if "faults" in phases:
        run_faults(device, gen)

    if "hier" in phases:
        # This slice's paths: intring (kernel 5 once a rank) and the hier allreduce.
        _record(records, "quantize")["launches"] = run_hier(device)
        torch.cuda.empty_cache()

    if "c6" in phases:
        check_a2a_backward_on_threadgroup(device)

    if "model" in phases:
        # This slice's main path: the dense model's forward and serving.
        records.update(check_flash_kernel(device, gen))
        _record(records, "flash_attention")["launches"] = run_model(device)

    if "train" in phases:
        # This slice's main path: the train step with its compressed gradient
        # sync (kernels 1, 3 and 4; at 2 ranks the ring has no intermediate hop,
        # so kernel 2 keeps its count from the allreduce phase).
        launches = run_train(device)
        for name in ("quantize_pack", "unpack_dequantize_reduce", "unpack_dequantize"):
            _record(records, name)["launches"] = launches[name]

    if "ssm" in phases:
        # This slice's main path: the ssm and hybrid families, and the
        # mamba2-780m train step's gradient sync (kernels 1, 3 and 4).
        launches = run_ssm(device)
        for name in ("quantize_pack", "unpack_dequantize_reduce", "unpack_dequantize"):
            _record(records, name)["launches"] = launches[name]

    if "mla" in phases:
        # This slice's main path: the MLA family, and the minicpm3-4b train
        # step's gradient sync (kernels 1, 3 and 4).
        launches = run_mla(device)
        for name in ("quantize_pack", "unpack_dequantize_reduce", "unpack_dequantize"):
            _record(records, name)["launches"] = launches[name]

    if "moe" in phases:
        # This slice's main path: the MoE family's forward through kernel 11,
        # and the phi3.5-moe train step's gradient sync (kernels 1, 3 and 4).
        flash, launches = run_moe(device)
        _record(records, "flash_attention")["launches"] = flash
        for name in ("quantize_pack", "unpack_dequantize_reduce", "unpack_dequantize"):
            _record(records, name)["launches"] = launches[name]

    if "encdec" in phases:
        # This slice's main path: the encoder-decoder's forward through kernel
        # 11's non-causal and cross modes, and the seamless-m4t-medium train
        # step's gradient sync (kernels 1, 3 and 4).
        flash, launches = run_encdec(device)
        _record(records, "flash_attention")["launches"] = flash
        for name in ("quantize_pack", "unpack_dequantize_reduce", "unpack_dequantize"):
            _record(records, name)["launches"] = launches[name]

    if "vlm" in phases:
        run_vlm(device)

    if "fsdp" in phases:
        # This slice's main path: the train step over sharded weights, its
        # compressed gathers (kernels 1 and 4), reduce-scatters (kernels 1
        # and 3) and the replicated leaves' sync; kernel 2 from the
        # four-rank step, where the ring has intermediate hops.
        launches, smoke = run_fsdp(device)
        for name in ("quantize_pack", "unpack_dequantize_reduce", "unpack_dequantize"):
            _record(records, name)["launches"] = launches[name]
        _record(records, "unpack_reduce_repack")["launches"] = smoke["unpack_reduce_repack"]

    if "tp" in phases:
        # This slice's main paths: tensor parallelism (kernel 11 on each
        # rank's heads) and the compressed expert dispatch (kernels 5 and 4).
        run_tp(device, records)

    if "tp-families" in phases:
        # This slice's main path: tensor parallelism of the ssm, hybrid,
        # MLA, encdec and vlm families (kernel 11 on each rank's heads).
        run_tp_families(device, records)

    if "tp-train" in phases:
        # This slice's main path: the tensor-parallel train step, four
        # processes of the card over gloo, with the FSDP gathers (kernels 1
        # and 4), reduce-scatters (kernels 1 and 3) and the norms' sync; its
        # kernels 1, 3 and 4 counts replace the fsdp phase's.
        run_tp_train(device, records)

    if "cp-decode" in phases:
        # This slice's main path: the context-parallel decode cache in every
        # family's decode and serve step (kernel 11 in seamless's cross
        # attention, on every rank at every step).
        run_cp_decode(device, records)

    if "overlap" in phases:
        # This slice's main path: the tp-train cell's step with the bucket
        # hooks syncing inside backward (kernels 1, 3 and 4 in the buckets'
        # allreduces, the FSDP gathers and reduce-scatters); its counts
        # replace the tp-train phase's.
        run_overlap(device, records)

    if "train-cli" in phases:
        # This slice's main path: the train CLI under torchrun's variables,
        # one process a rank of a gloo DistMesh on the card, the replicated
        # leaves' ring sync (kernels 1-4: at data 4 the ring hops); its
        # counts replace the overlap phase's.
        run_train_cli(device, records)

    log(f"chip_smoke.py: every phase passed in {time.perf_counter() - t0:.1f} s "
        f"(the kernel build included)")
    if phases != set(PHASES):
        log(f"partial run ({sorted(phases)}): every check passed; no result printed")
        return 0
    for r in records.values():
        if not r["launches"]:
            raise AssertionError(f"{r['name']}: not launched on its path")
    print(smi)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k not in ("shape", "bytes", "one_call_ms", "device_ms")}
        for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
