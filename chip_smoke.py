#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's serving paths (minicpm-2b, mamba2-2.7b, whisper-large-v3
and mixtral-8x7b, full width, random weights from a seed), its training
path (minicpm-2b), its sync and dense-cache serving paths and its prefix
cache (minicpm-2b) in phases 1-9, then its observability and crash
evacuation (minicpm-2b) in a tenth, its stochastic sampling, deadline
admission with parking and n-way forks (minicpm-2b) in an eleventh, its
speculative decoding (minitron-4b, mixtral-8x7b) in a twelfth, its
multi-server control plane with crash failover (minicpm-2b, minitron-4b)
in a thirteenth, its VLM family (paligemma-3b) in a fourteenth, its
hybrid family (zamba2-7b) in a fifteenth, the training of the MoE,
SSM, audio, VLM and hybrid families in a sixteenth, head-sharded
paged serving (``--pjit-decode``; minicpm-2b, codeqwen1.5-7b) in a
seventeenth, head-sharded serving of the SSM, audio, MoE, hybrid and VLM
families (mamba2-2.7b, whisper-large-v3, mixtral-8x7b, zamba2-7b,
paligemma-3b) in an eighteenth, the four examples
(``examples/torch_*.py``) in a nineteenth, head-sharded speculation,
ring layouts and the dense-view oracle (minitron-4b, mixtral-8x7b,
minicpm-2b) in a twentieth and head-sharded one-shot prefill and the
dense-view oracle of the SSM, audio, VLM and hybrid families
(mamba2-2.7b, whisper-large-v3, paligemma-3b, zamba2-7b) in a
twenty-first, which runs right after the eighteenth, on the weights it
kept; any failure exits non-zero.
Every phase prints its wall time.  The serving
phases run at the launcher's defaults, the prefix cache among them at the
category's retention (minicpm-2b, a frequency service, keeps the whole
pool; mixtral-8x7b, a latency service, a quarter), and print its counters:

1. the kernels against their plain PyTorch versions
   (``repro_torch.kernels.ref``) on random inputs, compared in f32 with
   atol = rtol = 1.6e-2 (about two bf16 steps of the output), and timed
   (kernel and library: CUDA-graph replay, so the host cannot pace the
   launches; plain versions: CUDA events) beside the plain version and the
   bound of the work:
   the four paged-attention kernels at minicpm-2b's shapes and at one GQA
   shape (minitron-4b's heads), beside ``scaled_dot_product_attention`` on
   the gathered dense view (a yardstick the port never calls), the two
   decode kernels also held by ``check_rows`` at every (slot, head) row,
   their dead slots zeros and repeated launches bit-identical, timed also
   at 32 slots all live with the path's 32 lengths (the dead-slot
   yardstick) and with all 512 slots live, each record with its share of
   the bound and its instances' ``ptxas`` registers and spills; the two
   chunk kernels also at odd shapes (T = 13 and 65, starts that are
   multiples of neither 64 nor the page, prefix-cache hit starts (150,
   mid-page, and a full-prompt hit's one row), prefixes of 20 and 100, a dead
   slot among four, mixtral's 32/8 heads at D = 128), every chunk case
   also held by ``check_rows``, its rows past chunk_len zeros, and
   repeated launches bit-identical, and at speculative decoding's verify
   launch (512 slots, T = 5, minitron-4b's 24/8 heads at D = 128, ragged
   starts; 32 slots speculating, then all 512), timed; the SSD
   scan at mamba2-2.7b's chunk-call shapes (80 heads, P = 64, N = 128, one
   group), its f32 final state held to atol = rtol = 1e-3 of its largest
   magnitude (no single PyTorch call computes the scan), on the 16-byte
   copy route, repeated launches bit-identical; flash attention
   at whisper-large-v3's encoder shape (1500 x 1500, 20 heads, D = 64) and
   cross-attention chunk shape (128 rows x 1500 keys) and one small case
   per mask option, its f32 log-sum-exp held to atol = rtol = 1e-3, its
   output also at every sequence position to 1e-2 of that position's norm
   (``check_rows``), and timed at the training shape (1 x 4096 x 4096, 36 heads, D = 64,
   causal); the flash backward at the training shape, timed, and at odd
   shapes (GQA, D = 128 and 256, a window, Lq != Lk, kv_len, q_offset,
   ragged tiles), its bf16 dq, dk and dv held to the plain version on the
   same bf16 inputs, also by ``check_rows``, beside the backward of ``scaled_dot_product_attention``
   (``torch.autograd.grad`` on a saved graph; CUDA events); dense
   decode attention at the cross-attention decode shape (128 slots, 1500
   keys, 20 heads), 32 and 128 slots live, and a windowed GQA case; both
   beside ``scaled_dot_product_attention`` on the same tensors; the
   grouped GEMM at mixtral-8x7b's decode shapes ((8, 512, 4096) @
   (8, 4096, 14336) and its down projection) and chunk shape (20 rows an
   expert), its bf16 output held to the f32 product of the same operands
   (also by ``check_rows``, repeated launches bit-identical), beside
   ``torch.bmm`` on the same tensors, each record with its route, its
   achieved TFLOP/s and its share of the bound, and at odd shapes (an
   unaligned one on the ``mma.sync`` route; on the TMA route ragged
   tiles, C = 1, 63, 64, 65 and 200, an lhs row stride above K); the bf16
   paged decode kernel at mixtral's
   attention shape (512 slots, 32 live, 32 heads over 8 KV heads, D = 128);
   and the dense chunked-prefill kernel at minicpm-2b's dense-view chunk
   shape (one slot, 128 rows at offset 64, S = 256, 36 heads, D = 64),
   beside ``scaled_dot_product_attention`` with the same boolean mask, and
   at odd shapes (GQA 32/8 at D = 128, per-row start and chunk_len with an
   empty row, a prefix past the first tile, T = 13, S = 300, T = 130 over
   three row tiles at start 63, S = 700 over eleven key tiles, K/V read in
   place from a wider buffer), also held by ``check_rows``, repeated
   launches bit-identical; the SSD scan's and the dense chunk kernel's
   records also carry their share of the bound and their ``ptxas``
   registers and spills; paligemma-3b's shapes (8 query heads on 1 kv
   head at D = 256): #1 and #2 at 512 slots with 32 live at 262-496
   keys, #3 and #4 at a first chunk (T = 288 from 0 with the 256-row
   prefix), a text chunk (T = 64 at 288) and a ragged one (T = 13), #6
   at the dense view's first and text chunks, #5 at the dense view's
   decode, #7 over 262 and 456 rows with the prefix, each held by
   ``check_rows``, repeats bit-identical, timed beside SDPA and the
   bound, with the D = 256 instances' registers and spills; zamba2-7b's
   shapes (32 query heads on 32 kv heads at D = 112): #1 and #2 at the
   plan's 256 slots with 32 live at 26-220 keys, #3 and #4 at a 128-row
   chunk from 64 and a ragged 13-row one, #6 at the dense view's 128-row
   chunk, #5 at the oracle's 128 slots, #7 over 200 causal rows, and the
   SSD scan at 112 heads, P = N = 64, held and timed the same way, with
   the D = 112 instances' registers and spills; each timed
   flash record also carries its achieved TFLOP/s (the operations the
   function needs over its graph-replay time) and the share of its bound
   it reaches, and the build prints every kernel's ``ptxas`` register and
   spill lines by kernel;
2. the launcher, ``repro_torch.launch.serve.main``: 8 requests, 16 new
   tokens, int8 KV (the plan's default for this frequency service);
3. a request wave through ``ServiceRuntime`` with prompts of 6-200 tokens
   and 40 new tokens each, once with int8 KV and once with bf16 KV;
4. the same wave through mamba2-2.7b's state path at 128 slots (the
   allocator's own ``user_bs``: its default 512 slots of SSD state would
   take 86 GB), every SSD scan launch on the 16-byte copy route;
5. the same wave through whisper-large-v3's encoder-decoder path at 128
   slots (its default 512 slots of cross K/V would take 125.8 GB), each
   request with seeded random frame embeddings, int8 self-attention KV;
6. the same wave through mixtral-8x7b's MoE path at the plan's 512 slots
   and bf16 KV, at full width and 16 of its 32 layers (all 32 layers'
   bf16 weights, 93.4 GB, do not fit the card; 16 take 46.96 GB), the
   expert FFN through the grouped GEMM kernel, every launch on its TMA
   route, capacity factor 1.25;
7. training through ``repro_torch.launch.train``: minicpm-2b at full
   width, bf16, AdamW at lr 1e-3, batch 2 x 4096 tokens in 2 microbatches,
   4 steps (finite losses and grad norms, the last loss below the first,
   exactly 160 flash forward and 80 flash backward launches a step: 40
   layers' forward and checkpointed recompute, and backward, per
   microbatch; the profiled second step of a fresh trainer was cut for
   the time limit: ``profile_step --train`` runs it);
8. the sync and dense-cache paths of minicpm-2b at full width: (a) the
   launcher with ``--mode sync``, ``--kvcache-impl dense`` and
   ``--no-chunked-prefill``, 8 requests of 16 new tokens each; (b) phase
   3's wave through the dense-view step (``paged_native=False``, the
   reference's oracle) at 128 slots and bf16 KV, exactly one dense chunk
   kernel launch a layer in each chunk and one dense decode launch a layer
   in each decode step; (c) the native step's logits (paged kernels #3
   and #1) against the dense-view step's (#6 and #5) over three chunks and
   three decode steps of one slot, to 2**-5 of their norm (each path's
   distance from its plain versions on the card, the chain's own bf16
   noise, printed beside it), and the three chunk steps' logits identical
   (#3 and #6 run one body); (d) phase 3's wave in sync mode (16 of its
   32 requests: the time limit);
9. the prefix cache on minicpm-2b at full width and the plan's 512 slots
   (``max_seq_len`` 256): 32 requests (of the wave's 64: the time limit;
   16 in the one-template pair),
   each a 150-token template (4 full
   pages and a 22-token partial tail) plus a tail of its own of 1-40
   tokens, 24 new tokens each (``profile_step.templated_wave``).  A donor
   is served to its eviction first, which indexes the template's partial
   tail; the other 31 are then submitted together.  In int8 KV (the bf16
   pair was cut for the script's time limit), with the cache on (-1) and
   off (0): on, at least 30 of the 31
   lookups hit, each hit reuses at least 128 tokens, at least 31 blocks are
   copied on write, and at least 31 x 128 fewer prompt tokens are computed
   than off.  Then two alternating templates at 8 retained blocks, on and
   off, where the LRU evicts.  In every pair each request's final-chunk
   logits agree to 2**-5 of their norm (phase 8 (c)'s rule for two correct
   bf16 chains) and the greedy chains that agree in full are counted; the
   tok/s, prefill chunks, prompt tokens computed and host wall per step
   (all steps, and decode-only steps) are printed on against off (the
   idle share of the on run's first 5 steps under ``torch.profiler`` was
   cut for the script's time limit), and copy-on-write on the card is
   checked exact (``torch.equal``) on
   minicpm-2b's int8 pools (values and scales) and bf16 pools;
10. observability and crash evacuation on minicpm-2b at full width and the
   plan's 512 slots: (a) the launcher with ``make obs-smoke``'s flags (6
   requests, 4 new tokens, ``--trace-out``, ``--metrics-out``,
   ``--calibrate-out`` into a temporary directory), its trace and metrics
   read back by the port's ``validate_chrome_trace`` and
   ``parse_prometheus_text``, the calibration's overrides printed; (b)
   phase 3's int8 wave untraced, then traced (a ``Tracer`` and a
   ``MetricsRegistry``; a second traced and untraced pair was cut for the
   script's time limit): every greedy chain equal to
   phase 3's, the paged-attention launches equal to phase 3's, the
   untraced and traced final-chunk logits identical, every request's
   timeline balanced (``request`` > ``queued``, ``prefill``, ``decode``,
   served), the TTFT, TPOT and queue-wait histograms counting all 32; it
   prints their median and p99 (interpolated in the histograms' buckets,
   as Prometheus does) and mean, and the tok/s and host wall per step of
   each run; (c) phase 3's int8 wave, traced, evacuated after
   ``EVACUATE_AFTER`` steps (queued, mid-prefill and decoding requests
   present), its requests resubmitted to the same runtime and served:
   the counters, ``StepStats.evacuated``, an arena with no live slot whose
   free and idle cached blocks are the pool, and two ``request`` roots in
   each resubmitted timeline (the first ``outcome="evacuated"``) are
   checked, the chains equal to phase 3's counted, and each resubmitted
   request's final-chunk logits held to phase 3's to 2**-5 of their norm
   where its chain differs;
11. threefry sampling, SDF admission and forks on minicpm-2b at full width
   (int8 KV and the launcher's defaults unless named): (a) the sampler on
   the card against the port's CPU sampler on identical float32 logits
   (512 rows of the 122,753-token vocabulary, seeds the row ids): counter
   keys, threefry words (int64) and uniforms bit-identical, every row's
   token equal with 32 and 512 rows live at temperature 0.8 and top_k 0
   and 50 (a differing row is printed with its top-two perturbed-score
   margin and passes only within twice its noise difference),
   ``speculative_verify`` at k = 4 greedy and stochastic equal, and the
   device time of each sampling call (CUDA events); (b) phase 3's int8
   wave at temperature 0.8 and top_k 50 twice (chains identical, tokens
   differing from phase 3's greedy chains counted: random weights put the
   last token's logit far above the rest, so none do at 0.8), its first
   8 requests at temperature ``HOT_T`` (tokens must differ; all 32 until
   the script's time limit cut them), and 4 requests of 4
   samples at ``HOT_T`` twice (12 forks sharing their prompt blocks, no
   prefill for forks, 12 copy-on-write copies, sibling chains distinct
   and repeatable); (c) the reference's goodput overload trace
   (``profile_step.goodput_trace``: the trace's 2-slot latency plan, bf16
   KV, a logical clock) under fifo and sdf, greedy (the trace at 0.8
   and with int8 KV were cut for the script's time limit): sdf on time
   at least 1.3x fifo, at least one preemption and as many resumes,
   chains identical across the policies, every request served or
   verdicted, the arenas empty at the end, the counts held beside the CPU
   test's on the toy config; (d) the launcher with
   ``--admission-policy sdf --deadline-s 30 --requests 8``;
12. speculative decoding (k = 4) on minitron-4b at full width and its
   plan (512 slots, bf16 KV, the prefix cache at a quarter's retention):
   (a) one ``verify_step_paged`` (#3, T = 5) against five
   ``decode_step_paged`` (#1) on copies of the same pools, 8 live slots
   of 512 at ragged lengths: logits and the K/V rows each wrote held to
   2**-5 of their norm at every row, nothing written outside the live
   rows but the trash page, the lengths returned unchanged; (b) phase
   3's wave's first 16 requests (the time limit) plain, with a self-draft
   (the target's own tensors) and with
   a 4-layer draft (views of the target's first 4 blocks, embedding,
   final norm and head; on the wave's first 8 requests, for the script's
   time limit): both launch verify, #3 launches at least 32 layers for
   each prefill chunk and verify launch, the self-draft commits at least 4
   tokens a slot-round, the 4-layer draft rolls back, every chain that
   splits from the plain run's does so where the plain run's top-two
   gap is below (a)'s largest logit difference (each split printed with
   its gap), and the two drafts' chains are identical; (c) the 4-layer
   draft at temperature 0.8 twice on the wave's first 8 requests
   (identical chains and verify launches); (d) the launcher with
   ``--archs minicpm-2b,minitron-4b --draft-arch minitron-4b`` (every
   request served, minicpm-2b's non-speculative note, verify launches);
   (e) mixtral-8x7b at full width and 2 of 32 layers with a self-draft,
   on phase 3's first 16 requests (the time limit), at its
   capacity factor 1.25 (the verify's drops and the splits
   printed) and at 8 (no drops, (a) repeated, the splits printed, a
   1-layer draft's chains identical to the self-draft's); each run's
   tok/s, speculation counters, launches and peak memory printed;
13. the multi-server control plane (SSSP placement, the handler, the ring
   sync, the ``ClusterSupervisor`` with fault injection and crash
   failover): (a) the launcher with ``--servers 2 --archs minicpm-2b
   --chaos-seed 2 --requests 24 --max-new-tokens 8`` at full width and
   the plan's 512 slots (server 0 crashes at logical t = 2.9 mid-burst and
   restarts at 6.4), and the same command with ``--device cpu`` on the
   reduced config: both exit 0, a crash failover and an evacuation, #2 and
   #4 launched, every counter of the ``served``, ``admission`` and
   ``fault tolerance`` lines and the rounds equal on the card and the CPU
   (the clock is logical); then ``--servers 3``, refused before anything
   is allocated with the sum in the message; (b) minicpm-2b (frequency,
   int8 KV) and minitron-4b (latency, bf16 KV) at full width, 128 slots
   each (``plan_for(full, bs=128)``), each placed on all three servers of
   the port's ``EdgeCloudControlPlane`` at demand 4.0, 24 requests a
   service (phase 3's prompts of 6-200 tokens, 16 new tokens, entry
   servers from seed 13) through the port's ``ClusterSupervisor`` with
   ``RetryPolicy(base_timeout_s=4.0)`` on its logical clock, failure-free
   and under ``CLUSTER_FAULTS`` (two dropped handoffs, a straggler, a
   corrupted digest, a crash of server 0 at 4.0 and its restart at 12.0):
   every rid accounted with no ``FAILED`` verdict, evacuations, failovers,
   dropped handoffs and straggler rounds, server 0 back up, every survivor
   runtime decoding, #1-#4 launched, and every chain that splits from the
   failure-free run's at a top-two gap below phase 12 (a)'s largest
   verify-vs-decode logit difference (``chain_splits``' rule), the splits
   counted by service; each run's wall, tok/s, rounds, outcomes, recovery
   counters and peak memory beside its static sum printed;
14. the VLM family: paligemma-3b at full width (18 layers, 8 query heads
   on 1 kv head at D = 256, 257,216-token vocabulary), random weights
   from seed 1, each request with random-normal image embeddings (its
   256-row bidirectional prefix) from seed 1, 512-token slots: (a) phase
   8 (c)'s native vs dense-view logits with a first chunk that carries
   the prefix; (b) phase 3's wave at the plan's 512 slots in bf16 and in
   int8 KV, and through the dense-view oracle at 512 slots (tok/s,
   launches, peak memory beside the static sum): the bf16 chains equal
   the oracle's or split where its top-two gap is below (a)'s largest
   logit difference; (c) one request through the sync path, its first
   token against one paged chunk's logits over the same prompt; (d) the
   launcher with ``--archs paligemma-3b --max-seq-len 512 --requests
   8``; phase 12 (e) also prints the router's top-k margins at mixtral's
   verify-chain splits;
15. the hybrid family: zamba2-7b at full width (81 Mamba-2 layers,
   d_model 3584, 112 SSM heads of P = N = 64; one shared attention+MLP
   block over concat(h, h0) every 6 layers, 13 applications of 32/32
   heads at D = 112; 32,000-token vocabulary), random weights from seed
   1, 256-token slots: (a) phase 8 (c)'s native vs dense-view logits;
   (b) phase 3's wave (16 of 32 requests: the time limit) in int8 KV at the
   plan's 256 slots (tok/s,
   launches, peak memory beside the static sum), then in bf16 KV and
   through the dense-view oracle at 128 slots (the oracle's gathered view
   does not fit beside a 256-slot bf16 arena) on its first 16 requests
   (the time limit): the first tokens equal,
   and fed the oracle's chains, the two paths' logits agree to
   ``HYBRID_PARITY_TOL`` at every position (splits printed with their
   gaps); (c) one request through the sync path, its first token
   against one paged chunk's logits over the same prompt; (d) the
   launcher with ``--archs zamba2-7b`` at its defaults;
16. training at full width through the launcher (``TRAIN_FAMILIES``):
   mamba2-2.7b, whisper-large-v3, paligemma-3b, zamba2-7b (Adafactor)
   and mixtral-8x7b (2 of 32 layers), 4 steps each: finite, falling
   losses, every step's launches equal to ``train_launches`` (the
   grouped GEMM's forward, dX and dW on the TMA route), peak memory
   beside the static size; phase 1 times #8 at D = 112, #9's dX and dW
   and #10 at these shapes;
17. head-sharded paged serving, the launcher's ``--pjit-decode`` on
   service meshes that list ``cuda:0`` tp times (``launch/steps.py``
   ``paged_decode_builder``): (a) minicpm-2b at its plan (512 slots, int8
   K/V, the prefix cache at its default) on phase 3's first 8 requests,
   40 new tokens, at tp = 1 (its chains must be phase 3's exactly) and at
   tp = 4 (9 heads a shard: every paged kernel launched 4 times a layer a
   step, first tokens equal, each decode step's logits over the slots fed
   the same tokens held to phase 8 (c)'s 2**-5 of their norm, splits
   printed with their top-two gaps); (b) codeqwen1.5-7b (D = 128, bf16
   K/V, random qkv biases, 32 slots) unsharded and at tp = 2 on 4
   requests, held the same way, and across ``cuda:0`` and ``cuda:1``
   where the machine has two cards (else the cross-card copies are
   printed as unchecked); (d) each decode step's CUDA-event time beside
   ``decode_cost_analysis`` at tp = 1 and 4 (the same FLOPs); (e) the
   launcher with ``--pjit-decode`` on the card's (1, device count) mesh;
   (c) #1-#4 at the shards' shapes (9 and 18 heads at D = 64;
   mistral-large-123b's 24 query heads on 2 kv heads at D = 128) against
   their plain versions by ``check_rows``, the tp = 4 shapes timed beside
   their bounds, each timed decode record's work equal to
   ``roofline/op_cost.py``'s rule;
18. head-sharded paged serving of the SSM, audio and MoE families on the
   service mesh ``[cuda:0] * 4`` (numerics and launches, not speed
   across cards), each family's shards drawn by ``init_sharded`` from
   phases 4-6's seed, on the first 8 of phases 4-6's 32 requests: (a1)
   each family at 2 layers (whisper 2 + 2), unsharded and at tp = 4 on the
   same weights, 8 new tokens, held by ``compare_runs``: the MoE
   router's inputs, call by call, to ``PARITY_TOL`` of their norm until
   a request's routing splits, and the split at a router tie (its gap
   under ``PARITY_TOL`` of the router logits' norm); every other request
   (at least half, a quarter for the MoE family) with its first token
   equal or split within one bf16 ulp, its final-chunk logits and each
   decode step's logits while it is fed the same tokens to
   ``PARITY_TOL`` of their norm, its first decode row always held; MoE
   drops equal in every chunk before its request's routing split; (a2)
   mamba2-2.7b and whisper-large-v3 at 128 slots and mixtral-8x7b at 16
   layers and 512 slots, 8 new tokens: every kernel of the path
   launched 4 times a layer a step (``TP_FAMILY_KERNELS``), first
   tokens, logits, chains and MoE drops against phases 4-6's rows of the
   same requests (recorded there), held as (a1) holds them for
   whisper-large-v3 and measured for the others: at full depth on random
   weights a rounding-level change moves mamba2's and mixtral's chains
   as far (``--tp-floor``); (c) each tp = 4 step's
   ``decode_cost_analysis`` against phases 4-6's: the kernels' FLOPs
   equal, the matmuls' those plus what the 3 further shards repeat
   (``repeated_flops``); (d) the launcher with ``--pjit-decode`` and
   mamba2-2.7b on the card's (1, 1) mesh, refused before anything is
   allocated (its plan's 512 slots of SSD state, 87 GB, exceed the card),
   and a (1, 4) mesh's share shown to fit; (b) the kernels at the shards'
   shapes, against their plain versions and timed beside their bounds
   (``tp_family_kernel_cases``).  Then the hybrid and VLM families
   (``TP_NEW_FAMILIES``): zamba2-7b at tp = 4 (8 query and 8 kv heads and
   28 SSD heads a shard, int8 pools, the plan's 256 slots) and
   paligemma-3b at tp = 2 and 4 (its one kv head's pool replicated on
   every shard, bf16, the plan's 512 slots), each on the first 8 requests
   of phase 15's (16) and 14's (32) waves: (a1) at 2 layers (zamba2 with
   its shared block applied after each: two applications), unsharded and
   at each tp on the same weights, held by
   ``compare_runs``, and (c) each tp step's ``decode_cost_analysis``
   against the unsharded one's (the replicated K/V projection and the B
   and C columns counted once a further shard); (a2) at full depth (81
   and 18 layers), every kernel launched tp times a layer (zamba2's
   attention kernels: an application) a step, the chains measured
   against phases 15's and 14's (``chain_agreement``); (d) the launcher
   with ``--pjit-decode`` and paligemma-3b; (b) #1 and #3 at paligemma's
   shard shapes (4 and 2 query heads on 1 kv head at D = 256, the first
   chunk with its 256-row prefix), #2, #4 and #10 at zamba2's;
19. the four examples through the port on the card, each ``main`` with
   ``--device cuda`` (their reduced configs, head dim 64:
   ``ops.card_config``): the quickstart, the §4.3 case study,
   serve_cluster at ``--requests 9 --chaos`` and train_small at
   ``--steps 20``, each checked on what it prints (every rid served or
   verdicted, the loss falling, the checkpoint read back);
20. speculation, the ring and the dense-view oracle split by heads over
   ``[cuda:0] * tp``: (a1) minitron-4b at full width and 2 layers with a
   self-draft through its shards (k = 4, phase 12's 512-slot plan) at tp
   = 2 and 4 against tp = 1 on 8 requests, every verify launch's logits
   held by ``check_rows`` at ``PARITY_TOL``, chains equal or split under
   the pair's logit difference; (a2) all 32 layers at tp = 4 on the first
   8 of phase 12 (b)'s 16 requests, its verify launches, accepted tokens
   a launch and draft steps printed beside phase 12 (b)'s self-draft and
   its chains against them, splits held under phase 12 (a)'s limit; (b)
   mixtral-8x7b at ``--max-seq-len`` 4352, over its 4096-token window
   (the ring: one-shot prefill (#7) and the dense-view decode step (#5)
   on every shard), 8 requests, request 0 a 4200-token prompt: (b1) 2
   layers at tp = 4
   against tp = 1, held by ``compare_runs``, (b2) 16 layers at tp = 4,
   served and first tokens; (c) minicpm-2b at 2 layers through the
   ``paged_native=False`` oracle (#5, #6) at tp = 4 against the native
   tp = 4 step; (d) every kernel of these paths launched exactly tp times
   a layer a step, the ring's ``decode_cost_analysis`` at tp = 4 equal in
   kernel FLOPs to tp = 1's, and #3 at the verify shape, #5 over the ring
   (and the unsharded ring beside it) and #7 in the one-shot prefill at
   the tp = 4 shards' shapes, against their plain versions and timed
   beside their bounds and SDPA;
21. (run right after phase 18, on the trees phase 18 drew and kept for
   it: mixtral-8x7b's runs there come first, so that its 47 GB of weights
   meet none of them) one-shot prefill (``--no-chunked-prefill``) and
   the dense-view oracle split by heads over ``[cuda:0] * 4`` for
   mamba2-2.7b, whisper-large-v3, paligemma-3b and zamba2-7b, in that
   order (each family's trees freed after it): (a1) 2 layers (whisper's
   encoder too; zamba2's shared block after both) with one-shot prefill
   at tp = 4 against tp = 1 (the whole tree through a one-shard mesh) on
   8 requests of 8 new tokens, held by ``compare_runs`` at ``PARITY_TOL``
   (the one-shot logits, first tokens, decode rows); (b) for whisper,
   paligemma and zamba2, the same 2 layers at tp = 4, bf16, 64 slots,
   through the ``paged_native=False`` oracle (dense views, #5 and #6)
   against the native step, held by ``compare_runs``, and the requests
   whose final-chunk logits are identical printed; (a2) the full depth
   at tp = 4 with one-shot prefill at phases 4's, 5's, 14's and 15's
   slots (128, 128, 512 and 256), 4 requests of 8 new tokens: their
   chains, measured against phase 18 (a2)'s, and each shard's arena;
   every kernel of each path launched exactly tp times a layer a step;
   (c) #5 and #6 over (b)'s dense views, #7 over a 200-row one-shot
   prompt and #10 over the same prompt at the new shard shapes (whisper
   5/5 at D = 64 and its cross-attention over 1500 frames, zamba2 8/8 at
   D = 112 and 28 SSD heads, paligemma 4/1 and 2/1 at D = 256 with its
   256-row prefix, mamba2 20 SSD heads), against their plain versions
   and timed beside their bounds and SDPA;

and a small-input check of each model's logits on the card against the
same model on the CPU (the plain versions): the paged steps, and the
dense ``prefill``/``prefill_chunk``/``decode_step`` of minicpm-2b,
mixtral-8x7b (and a ring of its window) and whisper-large-v3 and
mamba2-2.7b's one-shot prefill; of one sync-mode wave's tokens; of one
training step's loss and gradients for each family, and of one
attention layer's gradients.

The paged-attention launch counts are zeroed just before phase 2 and read
just after phase 3; the SSD scan's just before and after phase 4; every
count again just before phase 5, and flash and decode attention's read
just after it; every count again just before phase 6, and the grouped
GEMM's read just after it; every count again just before phase 7, and the
flash kernels' read just after it (the forward's record sums phases 5 and
7); every count again just before phase 8 (b), and the dense chunk
kernel's read just after it; every count again just before phase 9's
runs, whose paged-attention counts are read just after each run (and
printed, not put in the kernels' record); phase 10 (b) reads the
paged-attention counts before and after each of its runs and holds them
to phase 3's int8 wave's (printed, not put in the record); phase 11 (b)
and (c) print the paged-attention counts of their runs (the resumed and
forked slots' decode and chunk launches), not put in the record; every
count is zeroed just before phase 12 and read just after it (printed,
not put in the record), and phase 12 fails unless #1, #3 and #9
launched; every count is zeroed just before phase 13 and read just after
it (printed, not put in the record), and phase 13 fails unless #1-#4
launched; every count is zeroed just before each of phase 14's runs and
read just after it (the bf16 wave must launch #1 and #3, the int8 wave
#2 and #4, the oracle #5 and #6, the sync request #7), and those counts
are added to the record's and printed beside them as
``paligemma_launches``; phase 15's the same way (the int8 wave must also
launch the SSD scan, the sync request #7 and the scan), as
``zamba2_launches``; every count is zeroed just before each of phase
16's families and read just after it, and their sum is added to the
record's and printed beside it as ``train_families_launches`` (#7-#10
must launch); every count is zeroed just before phase 17 and read after
its launcher run (before (c)'s comparisons), added to the record's and
printed as ``tp_launches`` (#1-#4 must launch); every count is zeroed
just before phase 18 and read after (d), before (b)'s comparisons, added
to the record's and printed as ``tp_families_launches`` (#1-#5, #7, #9
and #10 must launch); every count is zeroed just before phase 19 and
read just after it, added to the record's and printed as
``examples_launches`` (#1-#4, #7, #8 and #10 must launch); every count
is zeroed just before phase 20 and read after (c), before (d)'s kernel
comparisons, added to the record's and printed as ``tp_paths_launches``
(#1, #3, #5, #6, #7 and #9 must launch, each exactly tp times a layer a
step of its path); every count is zeroed just before phase 21 and read
after (b), before (c)'s kernel comparisons, added to the record's and
printed as ``tp_oneshot_launches`` (#1, #2, #5, #6, #7 and #10 must
launch, each exactly tp times a layer a step of its path).
``python3 chip_smoke.py --across-cards`` on a machine with four cards
runs phases 17 and 18 across them instead (``across_cards``: the waves
over cuda:0-3 against ``[cuda:0] * 4`` bit for bit, the five families'
among them, mistral-large-123b, plain and with a self-draft,
mixtral-8x7b at all 32 layers at ``--max-seq-len`` 8192, past its
window, and four families at their full plans: mixtral-8x7b at all 32
layers, mamba2-2.7b and whisper-large-v3 at 512 slots, zamba2-7b at
256); ``python3 chip_smoke.py --across-cards-paths`` runs only
``across_cards_paths`` (mistral-large-123b plain and with its
self-draft, mixtral-8x7b's ring at 32 layers, and mamba2-2.7b's and
whisper-large-v3's 512-slot plans with one-shot prefill, each card's
per-slot state and peak memory), ``python3 chip_smoke.py
--across-cards-oneshot`` only the last (``across_cards_oneshot``); ``python3
chip_smoke.py --tp-witness`` runs only ``tp_kv_witness``, ``python3
chip_smoke.py --tp-floor`` only phase 4 and ``tp_floor``, and ``python3
chip_smoke.py --decode-attention [TREE]`` only #5 at every shape
``PERF.md`` records for it (``decode_attention_alone``; with TREE,
another checkout's #5 on the same inputs).  Every #5 case prints its
split count (``decode_attention.plan_splits``), and a timed one whose
bytes fit the 50 MB L2 also its ``cold_ms``.
The last two lines are the card (``nvidia-smi``'s name and power limit)
and ``{"ok": true, "device": ...}``; the line before them is the kernels'
JSON record.  Without a card, or without the repository around it, the
script fails before printing any result.
"""
import contextlib
import gc
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TOL = 1.6e-2
TRAIN_LR = "1e-3"
TRAIN_SHAPE = dict(B=1, Lq=4096, Lk=4096, Hq=36, Hkv=36, D=64)
SOURCES = {"paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "decode_attention":
               "src/repro_torch/kernels/csrc/decode_attention.cu",
           "chunk_prefill_attention":
               "src/repro_torch/kernels/csrc/chunk_attention.cu",
           "grouped_matmul": "src/repro_torch/kernels/csrc/grouped_matmul.cu"}
SSD_STATE_TOL = 1e-3
# a timed case whose bytes fit the card's 50 MB L2 is also timed cold:
# launches cycle through copies of its caches that together exceed 100 MB
L2_BYTES = 50e6
COLD_BYTES = 100e6
LSE_TOL = 1e-3
ROW_REL_TOL = 1e-2
ROW_FLOOR = 1e-5
PARITY_TOL = 2 ** -5
# phase 15's: zamba2-7b's bf16 chain is noisier than the attention
# decoders' (81 recurrent layers on random weights carry each rounding
# on in their state): each path's logits lie 0.09-0.13 of their norm from
# the same steps run with the plain attention versions on the card
# (phase 15 (a)'s floor), and fed the same tokens the native and
# dense-view paths part by 0.03 after one decode step, growing to
# 0.12-0.16 after some 15 and no further (phase 15 (b)'s replay); a
# kernel that drops or misplaces keys moves them by a multiple of that
HYBRID_PARITY_TOL = 2 ** -2
RECORD_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:466",
    "paged_decode_attention_quant":
        "src/repro/kernels/decode_attention.py:581",
    "paged_chunk_prefill_attention":
        "src/repro/kernels/decode_attention.py:305",
    "paged_chunk_prefill_attention_quant":
        "src/repro/kernels/decode_attention.py:675",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:85",
    "flash_attention": "src/repro/kernels/flash_attention.py:108",
    "flash_attention_bwd": "src/repro/kernels/flash_attention_bwd.py:156",
    "decode_attention": "src/repro/kernels/decode_attention.py:92",
    "chunk_prefill_attention": "src/repro/kernels/decode_attention.py:208",
    "grouped_matmul": "src/repro/kernels/moe_gemm.py:41",
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters=10, reps=5):
    """Median over ``reps`` of the mean time of ``iters`` launches (CUDA
    events, after one warm-up call).  Launches shorter than the host's
    time to issue them are paced by the host: ``graph_ms`` is the device's
    own time."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def graph_ms(fn, iters=20, reps=5):
    """The device's time per launch: ``iters`` launches captured in one
    CUDA graph, replayed between CUDA events ``reps`` times; the median.
    The host issues one replay, so it cannot pace the launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_pools(gen, rng, *, B, nblk, bs, Hkv, D, lens, quant):
    """A pool of B*nblk pages plus the trash page, each slot's table
    holding shuffled pages for its blocks below ``lens`` and the trash page
    past them."""
    import torch
    from repro_torch.kernels.quant import QuantPages, quantize
    P1 = B * nblk + 1
    pools = []
    for _ in range(2):
        x = torch.randn(P1, bs, Hkv, D, generator=gen, device="cuda")
        pools.append(QuantPages(*quantize(x)) if quant
                     else x.to(torch.bfloat16))
        del x
    phys = rng.permutation(P1 - 1).reshape(B, nblk)
    used = -(-np.asarray(lens) // bs)
    bt = np.where(np.arange(nblk)[None] < used[:, None], phys, P1 - 1)
    return pools[0], pools[1], torch.from_numpy(bt.astype(np.int32)).cuda()


def kv_bytes(keys, Hkv, D, quant):
    """Bytes of K and V rows (plus int8 scales) for ``keys`` tokens."""
    per = Hkv * D * (1 if quant else 2) + (Hkv * 4 if quant else 0)
    return 2 * keys * per


def bound(nbytes, flops):
    """The least time in ms for the card to move ``nbytes`` and compute
    ``flops``, at the peaks of ``repro_torch/roofline/analysis.py`` (the
    H100 SXM data sheet's HBM3 rate and dense bf16 rate), and which of the
    two bounds it."""
    from repro_torch.roofline.analysis import bound_ms
    return bound_ms(nbytes, flops)


def dense_view(pages, tables):
    """(B, Hkv, S, D) bf16 view gathered through the tables, for SDPA."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import QuantPages, dequantize
    if isinstance(pages, QuantPages):
        g = dequantize(ref.paged_gather_ref(pages.values, tables),
                       ref.paged_gather_ref(pages.scales, tables),
                       torch.bfloat16)
    else:
        g = ref.paged_gather_ref(pages, tables)
    return g.transpose(1, 2).contiguous()


def sdpa_fn(q, k, v, mask, Hq):
    """SDPA over (B, H, L, D) with GQA heads repeated up front."""
    import torch
    import torch.nn.functional as F
    rep = Hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def decode_case(gen, rng, *, B, Hq, Hkv, D, lens, quant, timed, nblk=8):
    import torch
    from repro_torch.kernels import ops, ref
    bs = 32
    lens = np.asarray(lens, np.int32)
    k, v, tables = make_pools(gen, rng, B=B, nblk=nblk, bs=bs, Hkv=Hkv,
                              D=D, lens=lens, quant=quant)
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    cl = torch.from_numpy(lens).cuda()
    kernel = lambda: ops.paged_decode_attention(q, k, v, tables, cl)
    out = kernel()
    want = ref.paged_decode_attention_ref(q.float(), k, v, tables, cl)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    check(not out[cl == 0].any(), "paged decode attention: a dead slot's "
          "rows are not zero")
    check(all(torch.equal(out, kernel()) for _ in range(2)),
          "paged decode attention: repeated launches differ")
    # every (slot, head) row held to its own norm
    rec = {"max_abs_err": err, **check_rows("out", out.reshape(1, -1, D),
                                            want.reshape(1, -1, D))}
    if not timed:
        return rec
    S = nblk * bs
    kd, vd = dense_view(k, tables), dense_view(v, tables)
    mask = (torch.arange(S, device="cuda")[None] < cl[:, None])[:, None,
                                                                 None]
    # what this data needs: q and table entries of the slots that hold
    # keys, their K/V once, every slot's length and output row
    keys = int(lens.sum())
    live = int((lens > 0).sum())
    nbytes = (live * Hq * D * 2 + q.numel() * 2 + B * 4
              + int((-(-lens // bs)).sum()) * 4
              + kv_bytes(keys, Hkv, D, quant))
    b_ms, b_by = bound(nbytes, 4 * D * Hq * keys)
    rec["work"] = (nbytes, 4 * D * Hq * keys)
    rec.update({"ms": graph_ms(kernel), "host_paced_ms": time_ms(kernel),
                "plain_ms": time_ms(lambda: ref.paged_decode_attention_ref(
                    q, k, v, tables, cl), iters=2, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(sdpa_fn(q[:, :, None], kd, vd, mask,
                                               Hq))})
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def chunk_case(gen, rng, *, B, T, Hq, Hkv, D, start, chunk_len, prefix_len,
               quant, timed, nblk=8):
    import torch
    from repro_torch.kernels import ops, ref
    bs = 32
    start = np.asarray(start, np.int32)
    chunk_len = np.asarray(chunk_len, np.int32)
    end = start + chunk_len
    k, v, tables = make_pools(gen, rng, B=B, nblk=nblk, bs=bs, Hkv=Hkv,
                              D=D, lens=np.maximum(end, 1), quant=quant)
    q = torch.randn(B, T, Hq, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    st, cl = torch.from_numpy(start).cuda(), torch.from_numpy(
        chunk_len).cuda()
    kernel = lambda: ops.paged_chunk_attention(q, k, v, tables, st, cl,
                                               prefix_len=prefix_len)
    out = kernel()
    want = ref.paged_chunk_attention_ref(q.float(), k, v, tables, st, cl,
                                         prefix_len=prefix_len)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    for b, n in enumerate(chunk_len.tolist()):
        check(not out[b, n:].any(), "paged chunk attention: a row past "
              "chunk_len is not zero")
    check(all(torch.equal(out, kernel()) for _ in range(2)),
          "paged chunk attention: repeated launches differ")
    rec = {"max_abs_err": err, **check_rows("out", out, want)}
    if not timed:
        return rec
    # what this data needs: per slot, the keys some live row can see (and
    # their table entries), the visible (row, key) pairs, the live rows' q,
    # every row's output and every slot's start and length
    keys = pairs = entries = 0
    for s, c in zip(start.tolist(), chunk_len.tolist()):
        if c:
            keys += s + c
            entries += -(-(s + c) // bs)
            pairs += sum(min(s + c, max(s + i + 1, prefix_len))
                         for i in range(c))
    nbytes = (int(chunk_len.sum()) * Hq * D * 2 + q.numel() * 2
              + entries * 4 + 2 * B * 4 + kv_bytes(keys, Hkv, D, quant))
    b_ms, b_by = bound(nbytes, 4 * D * Hq * pairs)
    rec["work"] = (nbytes, 4 * D * Hq * pairs)
    S = nblk * bs
    kpos = torch.arange(S, device="cuda")
    qpos = st[:, None] + torch.arange(T, device="cuda")[None]
    vis = (kpos[None, None] <= qpos[..., None]) | (kpos < prefix_len)
    vis &= kpos[None, None] < (st + cl)[:, None, None]
    kd, vd = dense_view(k, tables), dense_view(v, tables)
    rec.update({"ms": graph_ms(kernel), "host_paced_ms": time_ms(kernel),
                "plain_ms": time_ms(lambda: ref.paged_chunk_attention_ref(
                    q, k, v, tables, st, cl, prefix_len=prefix_len),
                    iters=3, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(sdpa_fn(q.transpose(1, 2), kd, vd,
                                               vis[:, None], Hq))})
    return rec


def ssd_case(gen, *, Bb, L, H=80, P=64, G=1, N=128, chunk=256, timed):
    """The SSD scan on x, B and C sliced from one projection (as the model
    passes them) with a nonzero initial state."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref, ssd_scan
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    proj = rand(Bb, L, H * P + 2 * G * N).to(torch.bfloat16)
    x = proj[..., :H * P].reshape(Bb, L, H, P)
    Bm = proj[..., H * P:H * P + G * N].reshape(Bb, L, G, N)
    Cm = proj[..., H * P + G * N:].reshape(Bb, L, G, N)
    dt = F.softplus(rand(Bb, L, H) - 2.0)
    A = -torch.exp(rand(H) * 0.5)
    D = rand(H)
    h0 = rand(Bb, H, P, N)
    run = lambda: ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                               initial_state=h0)
    plain = lambda: ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                                        initial_state=h0)
    route = ssd_scan.route(x, Bm, Cm, h0)
    check(route == "vec16", f"ssd_scan {(Bb, L)}: the model's projection "
          f"took the {route} copy route")
    before = ssd_scan.route_launches[route]
    y, h = run()
    check(ssd_scan.route_launches[route] == before + 1,
          f"ssd_scan {(Bb, L)} did not count its {route} launch")
    wy, wh = ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(), Cm.float(),
                                 D, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
          "ssd_scan: non-finite output")
    err = (y.float() - wy).abs().max().item()
    torch.testing.assert_close(y.float(), wy, atol=TOL, rtol=TOL)
    scale = wh.abs().max().item()
    torch.testing.assert_close(h, wh, atol=SSD_STATE_TOL * scale,
                               rtol=SSD_STATE_TOL)
    check(all(torch.equal(y, y2) and torch.equal(h, h2)
              for y2, h2 in (run() for _ in range(2))),
          "ssd_scan: repeated launches differ")
    rec = {"max_abs_err": err,
           "state_max_rel_err": (h - wh).abs().max().item() / scale,
           "ssd_route": route, "bit_identical_repeats": True}
    if not timed:
        return rec
    # what the function needs: x, dt, B, C, A, D and the initial state
    # read once, y and the final state written once; per chunk of q
    # tokens, C.B and M.x over the q(q+1)/2 causal pairs, C.h and the
    # state update over q*P*N each, 2 flops a multiply-add
    Q = min(chunk, max(8, L))
    pairs = qpn = 0
    for c0 in range(0, L, Q):
        q = min(Q, L - c0)
        pairs += q * (q + 1) // 2
        qpn += 2 * q * P * N
    flops = 2 * Bb * H * (pairs * (N + P) + qpn)
    nbytes = (Bb * L * (2 * H * P * 2 + H * 4 + 2 * G * N * 2)
              + 2 * Bb * H * P * N * 4 + 2 * H * 4)
    b_ms, b_by = bound(nbytes, flops)
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(plain, iters=3, reps=3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def check_rows(name, got, want, rel=ROW_REL_TOL):
    """Holds ``got`` to ``want`` at every sequence position (axis 1 of
    (B, L, ...)): the norm of the difference over the other axes is at
    most ``rel`` (ROW_REL_TOL unless given) of ``want``'s norm there, plus
    ROW_FLOOR per element
    (the rounding noise of a position whose true value is 0, such as dq of
    a row that sees one key).  Unlike atol it scales with each position's
    own size: at 4096 causal keys the late rows' out and the late keys' dk
    and dv are of the order of 1e-2, as large as TOL.  Returns the
    record's entries for ``name``: the normwise error of the whole
    tensor, the worst position's error as a share of its limit, and
    ``want``'s norm and largest magnitude."""
    g = got.float().transpose(0, 1).flatten(1)
    w = want.float().transpose(0, 1).flatten(1)
    diff = g - w
    limit = rel * w.norm(dim=1) + ROW_FLOOR * w.shape[1] ** 0.5
    worst = (diff.norm(dim=1) / limit).max().item()
    check(worst <= 1, f"{name}: a sequence position differs by {worst} of "
          f"its limit ({rel} of its norm + {ROW_FLOOR} an element)")
    return {f"{name}_rel_l2": (diff.norm() / w.norm()).item(),
            f"{name}_worst_row_of_limit": worst,
            f"{name}_ref_norm": w.norm().item(),
            f"{name}_ref_max": w.abs().max().item()}


def flash_case(gen, *, B, Lq, Lk, Hq, Hkv, D, timed, **mask):
    """Flash attention on q, k, v of the model's layout (B, L, H, D), out
    and lse against the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = rand(B, Lq, Hq, D), rand(B, Lk, Hkv, D), rand(B, Lk, Hkv, D)
    run = lambda: flash_attention.flash_attention(q, k, v, **mask)
    plain = lambda: ref.flash_attention_ref(q, k, v, **mask)
    out, lse = run()
    want, want_lse = ref.flash_attention_ref(q.float(), k.float(),
                                             v.float(), **mask)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
          "flash_attention: non-finite output")
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=LSE_TOL)
    lse_err = (lse - want_lse).abs().max().item()
    rec = {"max_abs_err": err, "lse_max_abs_err": lse_err,
           **check_rows("out", out, want)}
    if not timed:
        return rec
    causal = mask.get("causal", True)
    prefix = mask.get("prefix_len", 0)
    # what the function needs: q, k, v read once, out and lse written
    # once; 4*D flops for each visible (row, key) pair of each query head
    pairs = B * Hq * visible_pairs(Lq, Lk, causal, mask)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
        + 4 * lse.numel()
    b_ms, b_by = bound(nbytes, 4 * D * pairs)
    qt, kt, vt = sdpa_layout(q, k, v)
    # a prefix or a window needs SDPA's boolean mask; plain causal its
    # own flag
    pos = torch.arange(Lk, device="cuda")
    vis = (pos[None] <= pos[:Lq, None]) | (pos[None] < prefix)
    window = mask.get("window")
    if window is not None:
        vis = vis & (pos[None] > pos[:Lq, None] - window)
    sdpa = (dict(attn_mask=vis) if prefix or window is not None
            else dict(is_causal=causal))
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(plain, iters=2, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, **sdpa))})
    rec.update(achieved(4 * D * pairs, rec))
    return rec


def achieved(flops, rec):
    """A timed record's achieved rate (the function's needed operations
    over its graph-replay time) and the share of its bound it reaches."""
    return {"tflops": flops / (rec["ms"] * 1e-3) / 1e12,
            "bound_share": rec["bound_ms"] / rec["ms"]}


def visible_pairs(Lq, Lk, causal, mask):
    """(row, key) pairs a timed flash case computes: all of them, or the
    causal triangle of a square case, widened by a bidirectional prefix
    where it has one."""
    if not causal:
        return Lq * Lk
    check(Lq == Lk and set(mask) <= {"causal", "prefix_len", "window"},
          "only unmasked or causal square cases are timed")
    if mask.get("window") is not None:
        return sum(min(i + 1, mask["window"]) for i in range(Lq))
    prefix = mask.get("prefix_len", 0)
    return sum(min(Lk, max(i + 1, prefix)) for i in range(Lq))


def sdpa_layout(*ts):
    """(B, L, H, D) tensors -> contiguous (B, H, L, D), GQA heads repeated
    to the first tensor's count, for ``scaled_dot_product_attention``."""
    Hq = ts[0].shape[2]
    return [t.transpose(1, 2).repeat_interleave(Hq // t.shape[2], dim=1)
            .contiguous() for t in ts]


def flash_bwd_case(gen, *, B, Lq, Lk, Hq, Hkv, D, timed, **mask):
    """The flash backward on q, k, v and dout of the model's layout and the
    forward kernel's out and lse, against the plain version on the same
    bf16 inputs (which rounds dS and P to bf16 where the kernel does)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ref
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, dout = rand(B, Lq, Hq, D), rand(B, Lq, Hq, D)
    k, v = rand(B, Lk, Hkv, D), rand(B, Lk, Hkv, D)
    out, lse = flash_attention.flash_attention(q, k, v, **mask)
    run = lambda: flash_attention_bwd.flash_attention_bwd(
        q, k, v, out, lse, dout, **mask)
    plain = lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                **mask)
    got, want = run(), plain()
    torch.cuda.synchronize()
    errs, rows = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(g).all()),
              f"flash_attention_bwd: non-finite {name}")
        torch.testing.assert_close(g.float(), w.float(), atol=TOL, rtol=TOL)
        errs[name] = (g.float() - w.float()).abs().max().item()
        rows.update(check_rows(name, g, w))
    rec = {"max_abs_err": max(errs.values()), **{f"{n}_max_abs_err": e
                                                 for n, e in errs.items()},
           **rows}
    del got, want
    if not timed:
        return rec
    causal = mask.get("causal", True)
    # what the function needs: q, k, v, out, dout and lse read once, dq,
    # dk and dv written once; five products of 2*D flops for each visible
    # (row, key) pair of each query head (S, dP, dV, dK, dQ: P is not
    # stored, so S is part of the work)
    pairs = B * Hq * visible_pairs(Lq, Lk, causal, mask)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + out.numel() + dout.numel()) + 4 * lse.numel()
    b_ms, b_by = bound(nbytes, 5 * 2 * D * pairs)
    qt, kt, vt = (t.requires_grad_(True) for t in sdpa_layout(q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = sdpa_layout(dout)[0]
    library = lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                          retain_graph=True)
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(plain, iters=1, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(library)})
    rec.update(achieved(5 * 2 * D * pairs, rec))
    return rec


def training_kernels(gen):
    """The flash backward's record at the training path's shape, with
    max_abs_err over every case, and the flash forward timed at that
    shape (printed)."""
    import torch
    fwd = flash_case(gen, causal=True, timed=True, **TRAIN_SHAPE)
    print(f"  flash_attention, training shape (1 x 4096 x 4096, 36 heads, "
          f"D = 64, causal): {fwd}")
    rec = flash_bwd_case(gen, causal=True, timed=True, **TRAIN_SHAPE)
    errs = [rec["max_abs_err"]]
    small = dict(B=2, Lq=100, Lk=100, Hq=4, Hkv=4, D=64)
    cases = [
        dict(small, Hq=8, Hkv=2, D=128, causal=True),
        dict(small, Lq=70, Lk=90, Hq=2, Hkv=1, D=256, causal=True),
        dict(small, causal=True, window=17),
        dict(small, Lq=40, Lk=150, causal=False),
        dict(small, Lq=33, Lk=200, D=128, causal=True, q_offset=150,
             kv_len=170),
        dict(small, Lq=150, Lk=150, causal=True, prefix_len=100),
        dict(small, Lq=70, Lk=60, causal=True, window=5, kv_len=20),
        # several tiles of both kernels' streamed loops
        dict(small, B=1, Lq=300, Lk=300, causal=True),
        dict(small, B=1, Lq=300, Lk=300, causal=True, window=100),
        dict(small, B=1, Lq=200, Lk=230, Hq=4, Hkv=2, D=256, causal=True),
    ]
    worst = 0.0
    for case in cases:
        odd = flash_bwd_case(gen, timed=False, **case)
        errs.append(odd["max_abs_err"])
        worst = max(worst, *(odd[f"{n}_worst_row_of_limit"]
                             for n in ("dq", "dk", "dv")))
    rec["max_abs_err"] = max(errs)
    rec["odd_shapes_worst_row_of_limit"] = worst
    torch.cuda.empty_cache()
    return fwd, rec


def dense_decode_case(gen, *, B, S, Hq, Hkv, D, lens, timed, window=None):
    """Dense decode attention against the plain version, on caches laid
    out as the model's cross K/V state (B, S, Hkv, D): one launch a call
    whatever its split count (``decode_attention.plan_splits``), every
    (slot, head) row held to its norm, empty slots zeros, repeats
    bit-identical.  Timed cases also carry SDPA's time on the same caches,
    the bound and its share, and, where the bytes the call reads fit the
    50 MB L2, ``cold_ms``: launches that cycle through enough copies of
    the caches (over 100 MB) that each finds its own copy evicted."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, ref
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = rand(B, Hq, D), rand(B, S, Hkv, D), rand(B, S, Hkv, D)
    cl = torch.as_tensor(np.asarray(lens, np.int32)).cuda()
    run = lambda: decode_attention.decode_attention(q, k, v, cl,
                                                    window=window)
    before = decode_attention.launches["decode_attention"]
    out = run()
    check(decode_attention.launches["decode_attention"] == before + 1,
          "decode_attention: a call is not one launch")
    want = ref.decode_attention_ref(q.float(), k.float(), v.float(), cl,
                                    window=window)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    check(not out[cl == 0].any(), "decode_attention: an empty slot's row "
          "is not zero")
    check(torch.equal(out, run()), "decode_attention: repeated launches "
          "differ")
    nsplit, split_len = decode_attention.plan_splits(
        B, Hkv, S, D, decode_attention.sm_count(q.device))
    # every (slot, head) row held to its own norm
    rec = {"max_abs_err": err, "splits": nsplit, "split_len": split_len,
           **check_rows("out", out.reshape(1, -1, D),
                        want.reshape(1, -1, D))}
    if not timed:
        return rec
    check(window is None, "only unwindowed cases are timed")
    # what this data needs: q of the slots with keys, their visible K/V
    # rows once, every slot's length and output row
    keys = int(np.minimum(np.asarray(lens), S).sum())
    live = int((np.asarray(lens) > 0).sum())
    nbytes = (live * Hq * D * 2 + B * 4 + q.numel() * 2
              + 2 * keys * Hkv * D * 2)
    b_ms, b_by = bound(nbytes, 4 * D * Hq * keys)
    mask = (torch.arange(S, device="cuda")[None] < cl[:, None])[:, None,
                                                                 None]
    rep = Hq // Hkv
    kt = k.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(lambda: ref.decode_attention_ref(
                    q, k, v, cl), iters=2, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(
                    lambda: F.scaled_dot_product_attention(
                        q[:, :, None], kt, vt, attn_mask=mask))})
    rec["bound_share"] = b_ms / rec["ms"]
    del kt, vt
    if nbytes < L2_BYTES:
        rec["cold_ms"], rec["cold_copies"] = cold_decode_ms(
            decode_attention, q, k, v, cl, nbytes)
        rec["cold_bound_share"] = b_ms / rec["cold_ms"]
    return rec


def cold_decode_ms(module, q, k, v, cl, nbytes):
    """``graph_ms`` of ``module.decode_attention`` over launches that cycle
    through copies of the caches, together over COLD_BYTES, so that each
    launch finds the ``nbytes`` it reads evicted from the L2; and the
    number of copies."""
    copies = int(-(-COLD_BYTES // nbytes)) + 1
    kc = [k.clone() for _ in range(copies)]
    vc = [v.clone() for _ in range(copies)]
    order = itertools.cycle(range(copies))

    def cold():
        i = next(order)
        module.decode_attention(q, kc[i], vc[i], cl)

    return graph_ms(cold, iters=copies * -(-20 // copies)), copies


def decode_shapes():
    """#5 at every shape PERF.md records for it: (B, S, Hq, Hkv, D,
    lengths).  The ring over 4096 keys at its tp = 4 shard and at tp = 1,
    paligemma-3b's dense view (512 slots, 32 live at 262-496), whisper's
    cross-attention at its tp = 4 shard, zamba2-7b's dense view (phase 3's
    lengths), whisper's cross-attention at tp = 1 with 32 and 128 live."""
    cross = np.zeros(128, np.int64)
    cross[:32] = 1500
    return {"ring_tp4": (RING_BS, 4096, 8, 2, 128, np.full(RING_BS, 4096)),
            "ring_tp1": (RING_BS, 4096, 32, 8, 128, np.full(RING_BS, 4096)),
            "paligemma": (512, VLM_MAX_SEQ, 8, 1, 256, vlm_lens()),
            "whisper_tp4": (128, 1500, 5, 5, 64, cross),
            "zamba2": (128, HYBRID_MAX_SEQ, 32, 32, 112, phase3_lens(128)),
            "whisper_tp1": (128, 1500, 20, 20, 64, cross),
            "whisper_all_live": (128, 1500, 20, 20, 64, np.full(128, 1500))}


def decode_attention_alone(other):
    """``python3 chip_smoke.py --decode-attention [TREE]``: #5 alone, at
    ``decode_shapes``.  Without TREE each shape runs ``dense_decode_case``
    (held against the plain version, timed warm and cold beside SDPA and
    its bound), then its kernels' device times a call under torch.profiler
    (the split kernel and, with splits, the merge).  With TREE, another
    checkout's #5 (its ``src`` is imported instead of this one's: unpack the
    parent under a git-ignored directory) is timed warm and cold on the
    same inputs; run parent, this, this, parent in one call to compare."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build, decode_attention
    t0 = time.perf_counter()
    build.library("decode_attention")
    print(f"#5 build: {time.perf_counter() - t0:.1f} s ({build.BUILD_ROOT})")
    for kernel, line in ptxas_lines(build.build_log.get("decode_attention",
                                                        "")):
        print(f"  ptxas decode_attention {kernel}: {line}")
    for name, (B, S, Hq, Hkv, D, lens) in decode_shapes().items():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(33)
        if other:
            rand = lambda *s: torch.randn(*s, generator=gen,
                                          device="cuda").to(torch.bfloat16)
            q, k, v = rand(B, Hq, D), rand(B, S, Hkv, D), rand(B, S, Hkv, D)
            cl = torch.as_tensor(np.asarray(lens, np.int32)).cuda()
            keys = int(np.minimum(lens, S).sum())
            nbytes = (int((lens > 0).sum()) * Hq * D * 2 + B * 4
                      + q.numel() * 2 + 2 * keys * Hkv * D * 2)
            rec = {"ms": graph_ms(lambda: decode_attention.decode_attention(
                q, k, v, cl))}
            if nbytes < L2_BYTES:
                rec["cold_ms"] = cold_decode_ms(decode_attention, q, k, v, cl,
                                                nbytes)[0]
        else:
            rec = dense_decode_case(gen, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D,
                                    lens=lens, timed=True)
            rand = lambda *s: torch.randn(*s, generator=gen,
                                          device="cuda").to(torch.bfloat16)
            q, k, v = rand(B, Hq, D), rand(B, S, Hkv, D), rand(B, S, Hkv, D)
            cl = torch.as_tensor(np.asarray(lens, np.int32)).cuda()
            decode_attention.decode_attention(q, k, v, cl)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    decode_attention.decode_attention(q, k, v, cl)
                torch.cuda.synchronize()
            rec["kernel_us"] = {}
            for e in prof.key_averages():
                kern = re.search(r"(\w+_kernel)", e.key)
                if kern and e.device_time_total > 0:
                    rec["kernel_us"][kern[1]] = e.device_time_total / e.count
        print(f"  #5 {name}: {json.dumps(rec)}", flush=True)
        torch.cuda.empty_cache()


def whisper_kernels(gen):
    """Records of flash and decode attention at whisper-large-v3's
    main-path shapes; max_abs_err over every case of the kernel."""
    import torch
    whisper = dict(Hq=20, Hkv=20, D=64)
    records = {}
    # the encoder's self-attention (the record) and a decoder chunk's
    # cross-attention, a 128-row bucket against the 1500 frames
    rec = flash_case(gen, B=1, Lq=1500, Lk=1500, causal=False, timed=True,
                     **whisper)
    cross = flash_case(gen, B=1, Lq=128, Lk=1500, causal=False, timed=True,
                       **whisper)
    print(f"  flash_attention, cross-attention chunk shape: {cross}")
    errs, lse_errs = [rec["max_abs_err"], cross["max_abs_err"]], \
        [rec["lse_max_abs_err"], cross["lse_max_abs_err"]]
    small = dict(B=2, Lq=100, Lk=100, Hq=4, Hkv=4, D=64)
    cases = [
        dict(small, causal=True),
        dict(small, causal=True, window=17),
        dict(small, causal=True, prefix_len=70),
        dict(small, causal=True, window=9, prefix_len=30),
        dict(small, Lq=33, Lk=200, causal=True, q_offset=150, kv_len=170),
        dict(small, Hq=8, Hkv=2, causal=True),
        dict(small, Lq=70, Lk=150, D=128, causal=False),
        dict(small, Lq=70, Lk=150, D=256, Hkv=2, causal=True),
        dict(small, Lq=40, Lk=30, causal=True, window=4, kv_len=10),
        # several key and query tiles: the diagonal inside a tile, a
        # window's lower edge across tiles, a prefix past the first query
        # tile, D = 128 and 256 (32-key tiles)
        dict(small, B=1, Lq=300, Lk=300, causal=True),
        dict(small, B=1, Lq=300, Lk=300, causal=True, window=100),
        dict(small, B=1, Lq=200, Lk=200, causal=True, prefix_len=100),
        dict(small, B=1, Lq=260, Lk=260, D=128, causal=True, window=70),
        dict(small, B=1, Lq=200, Lk=230, Hkv=2, D=256, causal=False),
    ]
    for case in cases:
        r = flash_case(gen, timed=False, **case)
        errs.append(r["max_abs_err"])
        lse_errs.append(r["lse_max_abs_err"])
    rec["max_abs_err"], rec["lse_max_abs_err"] = max(errs), max(lse_errs)
    records["flash_attention"] = rec
    # phase 5's cross-attention decode: 128 slots, 32 live at the
    # encoder's 1500 keys (dead slots get length 0), then every slot live
    lens = np.zeros(128, np.int64)
    lens[:32] = 1500
    rec = dense_decode_case(gen, B=128, S=1500, lens=lens, timed=True,
                            **whisper)
    full = dense_decode_case(gen, B=128, S=1500, lens=np.full(128, 1500),
                             timed=True, **whisper)
    print(f"  decode_attention, all 128 slots live: {full}")
    gqa = dense_decode_case(gen, B=16, S=700, Hq=32, Hkv=8, D=128,
                            lens=np.linspace(0, 700, 16).astype(int),
                            window=100, timed=False)
    # keys split over warps: window edges inside splits (8 of 256 keys),
    # lengths one below, at and one above split boundaries
    edge = dense_decode_case(gen, B=4, S=2048, Hq=16, Hkv=4, D=64,
                             lens=[2048, 1000, 700, 0], window=300,
                             timed=False)
    L = edge["split_len"]
    bounds = dense_decode_case(gen, B=6, S=2048, Hq=16, Hkv=4, D=64,
                               lens=[L - 1, L, L + 1, 2 * L - 1, 2 * L + 1,
                                     0], timed=False)
    check(edge["splits"] > 2, f"the split cases do not split: {edge}")
    print(f"  decode_attention, split cases: window edges {edge}, "
          f"boundaries {bounds}")
    rec["max_abs_err"] = max(rec["max_abs_err"], full["max_abs_err"],
                             gqa["max_abs_err"], edge["max_abs_err"],
                             bounds["max_abs_err"])
    rec["all_live"] = vlm_record(full)
    rec["ptxas"] = ptxas_record("decode_attention")
    records["decode_attention"] = rec
    torch.cuda.empty_cache()
    return records


def dense_chunk_case(gen, *, B, T, S, Hq, Hkv, D, start, chunk_len,
                     prefix_len=0, timed=False):
    """The dense chunked-prefill kernel against the plain version on the
    same bf16 inputs, held by ``check_rows`` and atol = rtol = TOL; rows
    past chunk_len must be zeros.  Untimed cases read K and V in place
    from one wider (B, S, 2 * Hkv, D) buffer (head and sequence strides
    that are not the tensor's own); the timed one is one layer of the
    serving path's stacked dense view, contiguous."""
    import torch
    from repro_torch.kernels import chunk_attention, ops, ref
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q = rand(B, T, Hq, D)
    if timed:
        k, v = rand(B, S, Hkv, D), rand(B, S, Hkv, D)
    else:
        kv = rand(B, S, 2 * Hkv, D)
        k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]
    start = np.asarray(start, np.int32)
    chunk_len = np.asarray(chunk_len, np.int32)
    st, cl = (torch.from_numpy(a).cuda() for a in (start, chunk_len))
    out = ops.chunk_attention(q, k, v, st, cl, prefix_len=prefix_len)
    want = ref.chunk_attention_ref(q.float(), k.float(), v.float(), st, cl,
                                   prefix_len=prefix_len)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    for b, n in enumerate(chunk_len.tolist()):
        check(not out[b, n:].any(), "chunk_prefill_attention: a row past "
              "chunk_len is not zero")
    check(all(torch.equal(out, ops.chunk_attention(
        q, k, v, st, cl, prefix_len=prefix_len)) for _ in range(2)),
        "chunk_prefill_attention: repeated launches differ")
    rec = {"max_abs_err": err, "bit_identical_repeats": True,
           **check_rows("out", out, want)}
    if not timed:
        return rec
    # what this data needs: per slot, the K/V rows some live row can see,
    # read once, the live rows' q, every row's output, start and length;
    # 4*D flops for each visible (row, key) pair of each query head
    keys = pairs = 0
    for s0, c in zip(start.tolist(), chunk_len.tolist()):
        if c:
            keys += s0 + c
            pairs += sum(min(s0 + c, max(s0 + i + 1, prefix_len))
                         for i in range(c))
    nbytes = (int(chunk_len.sum()) * Hq * D * 2 + q.numel() * 2
              + 2 * B * 4 + 2 * keys * Hkv * D * 2)
    b_ms, b_by = bound(nbytes, 4 * D * Hq * pairs)
    kpos = torch.arange(S, device="cuda")
    qpos = st[:, None] + torch.arange(T, device="cuda")[None]
    vis = (kpos[None, None] <= qpos[..., None]) | (kpos < prefix_len)
    vis &= kpos[None, None] < (st + cl)[:, None, None]
    run = lambda: chunk_attention.chunk_prefill_attention(
        q, k, v, st, cl, prefix_len=prefix_len)
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(lambda: ref.chunk_attention_ref(
                    q, k, v, st, cl, prefix_len=prefix_len), iters=3,
                    reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(sdpa_fn(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    vis[:, None], Hq))})
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def chunk_kernels(gen):
    """The dense chunk kernel's record at minicpm-2b's chunk shape in the
    dense-view step (one slot, a 128-row bucket at offset 64, S = 256, 36
    heads, D = 64), beside SDPA with the same boolean mask; then odd
    shapes: mixtral's GQA 32/8 at D = 128 over B = 3 with per-row start
    and chunk_len (one row empty), a prefix of 40, T = 13 and S = 300 (not
    a multiple of the 64-key tile); minicpm's heads at S = 200 with a
    ragged row; MQA with a prefix; and more than one tile: T = 130 over
    three 64-row tiles at start 63, S = 700 over eleven key tiles, GQA
    32/8 at D = 128 with a prefix of 100.  max_abs_err and the worst row's
    share of its limit over every case; every case's repeated launches
    are bit-identical."""
    import torch
    rec = dense_chunk_case(gen, B=1, T=128, S=256, Hq=36, Hkv=36, D=64,
                           start=[64], chunk_len=[128], timed=True)
    cases = [
        dict(B=3, T=13, S=300, Hq=32, Hkv=8, D=128, start=[0, 40, 287],
             chunk_len=[13, 0, 13], prefix_len=40),
        dict(B=2, T=128, S=200, Hq=36, Hkv=36, D=64, start=[0, 100],
             chunk_len=[128, 77]),
        dict(B=1, T=40, S=97, Hq=8, Hkv=1, D=64, start=[57],
             chunk_len=[40], prefix_len=20),
        dict(B=2, T=130, S=256, Hq=36, Hkv=36, D=64, start=[63, 0],
             chunk_len=[130, 101]),
        dict(B=2, T=64, S=700, Hq=36, Hkv=36, D=64, start=[636, 300],
             chunk_len=[64, 64]),
        dict(B=2, T=128, S=400, Hq=32, Hkv=8, D=128, start=[0, 200],
             chunk_len=[128, 90], prefix_len=100),
    ]
    worst = rec["out_worst_row_of_limit"]
    for case in cases:
        r = dense_chunk_case(gen, **case)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        worst = max(worst, r["out_worst_row_of_limit"])
    rec["odd_shapes_worst_row_of_limit"] = worst
    torch.cuda.empty_cache()
    return rec


def gmm_case(gen, *, E, C, K, N, timed, route=None, lhs_pad=0):
    """The grouped GEMM on bf16 operands against the plain version on their
    f32 copies (what the kernel sums before its one rounding to bf16),
    held by atol = rtol = TOL and, at every row, by ``check_rows``;
    repeated launches must give identical outputs.  ``route``: the route
    the operands must take; ``lhs_pad`` > 0 reads lhs in place from a
    wider (E, C, K + lhs_pad) buffer (a row stride above K).  A timed
    record also carries its achieved TFLOP/s and share of the bound."""
    import torch
    from repro_torch.kernels import grouped_matmul, ref
    lhs = torch.randn(E, C, K + lhs_pad, generator=gen, device="cuda").to(
        torch.bfloat16)[:, :, :K]
    rhs = torch.randn(E, K, N, generator=gen, device="cuda").to(
        torch.bfloat16)
    which = grouped_matmul.route(lhs, rhs)
    check(route is None or which == route,
          f"grouped_matmul {(E, C, K, N)}: route {which}, not {route}")
    before = dict(grouped_matmul.route_launches)
    run = lambda: grouped_matmul.grouped_matmul(lhs, rhs)
    out = run()
    check(grouped_matmul.route_launches[which] == before[which] + 1,
          f"grouped_matmul {(E, C, K, N)} did not count its {which} launch")
    want = ref.grouped_matmul_ref(lhs.float(), rhs.float())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "grouped_matmul: non-finite output")
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    check(all(torch.equal(out, run()) for _ in range(2)),
          f"grouped_matmul {(E, C, K, N)}: repeated launches differ")
    # rows of (E, C, N): position c over experts and columns
    rec = {"max_abs_err": err, "gemm_route": which,
           "out_max_abs": want.abs().max().item(),
           **check_rows("out", out, want)}
    del out, want
    if not timed:
        return rec
    # what the function needs: both operands read once, the output written
    # once; 2 flops a multiply-add over every (expert, row, column, k)
    flops = 2 * E * C * K * N
    nbytes = 2 * (lhs.numel() + rhs.numel() + E * C * N)
    b_ms, b_by = bound(nbytes, flops)
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(lambda: ref.grouped_matmul_ref(
                    lhs, rhs), iters=2, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(lambda: torch.bmm(lhs, rhs))})
    rec.update(achieved(flops, rec))
    return rec


def mixtral_kernels(gen, rng):
    """The grouped GEMM's record at mixtral-8x7b's decode shape (every slot
    its own routing group: 512 rows an expert, gate/up projection), with
    max_abs_err over every case; and the bf16 paged decode and chunk
    kernels at mixtral's attention shapes, whose errors join those
    kernels' records."""
    import torch
    rec = gmm_case(gen, E=8, C=512, K=4096, N=14336, timed=True,
                   route="tma")
    errs = [rec["max_abs_err"]]
    for name, shape in (("decode down projection", (8, 512, 14336, 4096)),
                        ("chunk, 20 rows an expert", (8, 20, 4096, 14336))):
        E, C, K, N = shape
        r = gmm_case(gen, E=E, C=C, K=K, N=N, timed=True, route="tma")
        print(f"  grouped_matmul, {name} {shape}: {r}")
        errs.append(r["max_abs_err"])
        torch.cuda.empty_cache()
    # odd shapes: the unaligned one on the mma.sync route, the rest on the
    # TMA route (C around the 128-row tile, a ragged 256-column N tile, an
    # lhs row stride above K)
    odd = [((4, 50, 70, 33), "mma_sync", 0), ((8, 10, 200, 16), "tma", 0),
           ((4, 1, 256, 384), "tma", 0)]
    odd += [((4, C, 512, 264), "tma", 0) for C in (1, 63, 64, 65, 200)]
    odd += [((3, 70, 256, 200), "tma", 24)]
    for (E, C, K, N), route, pad in odd:
        r = gmm_case(gen, E=E, C=C, K=K, N=N, timed=False, route=route,
                     lhs_pad=pad)
        errs.append(r["max_abs_err"])
        rec["odd_shapes_worst_row_of_limit"] = max(
            rec.get("odd_shapes_worst_row_of_limit", 0.0),
            r["out_worst_row_of_limit"])
    rec["max_abs_err"] = max(errs)
    torch.cuda.empty_cache()
    # phase 6's decode attention: 512 slots, 32 live half-way through
    # generation, GQA 32 heads over 8 KV heads, D = 128
    lens = np.zeros(512, np.int64)
    lens[:32] = np.linspace(6, 200, 32).astype(int) + 20
    attn = decode_case(gen, rng, B=512, lens=lens, quant=False, timed=True,
                       Hq=32, Hkv=8, D=128)
    print(f"  paged_decode_attention, mixtral-8x7b shape (512 slots, 32 "
          f"live, 32/8 heads, D = 128): {attn}")
    # phase 6's chunked prefill: one slot a call, a 64-row bucket timed and
    # a ragged 32-row one checked, same heads
    mixtral = dict(Hq=32, Hkv=8, D=128, prefix_len=0, quant=False)
    chunk = chunk_case(gen, rng, B=1, T=64, start=[64], chunk_len=[64],
                       timed=True, **mixtral)
    print(f"  paged_chunk_prefill_attention, mixtral-8x7b shape (one slot, "
          f"64 rows, 32/8 heads, D = 128): {chunk}")
    chunk_err = max(chunk["max_abs_err"], chunk_case(
        gen, rng, B=1, T=32, start=[0], chunk_len=[19], timed=False,
        **mixtral)["max_abs_err"])
    torch.cuda.empty_cache()
    return rec, attn["max_abs_err"], chunk_err


def chunk_odd_cases(minicpm, gqa):
    """(heads, case) pairs of the paged chunk kernels' odd shapes: ragged
    slots with a dead one among four, a prefix of 0, 20 and 100 (past the
    first 64-row tile), T = 13 and 65 (ragged row tiles), starts that are
    multiples of neither 64 nor the 32-token page, chunks that start at a
    prefix-cache hit (mid-page, and a full-prompt hit's one valid row), at
    minicpm's heads, a GQA shape, and mixtral's 32/8 heads at D = 128."""
    mixtral = dict(Hq=32, Hkv=8, D=128)
    for shape in (minicpm, gqa, mixtral):
        for prefix_len in (0, 20, 100):
            yield shape, dict(B=4, T=128, start=[0, 40, 100, 200],
                              chunk_len=[128, 90, 0, 56],
                              prefix_len=prefix_len)
        yield shape, dict(B=4, T=13, start=[5, 37, 0, 77],
                          chunk_len=[13, 13, 0, 9], prefix_len=100)
        yield shape, dict(B=4, T=65, start=[3, 37, 0, 130],
                          chunk_len=[65, 60, 0, 1], prefix_len=0)
        # prefix-cache hits (phase 9): chunks from mid-page, after a
        # 150-token template, and a full-prompt hit's one row
        yield shape, dict(B=4, T=32, start=[150, 150, 0, 189],
                          chunk_len=[32, 8, 0, 1], prefix_len=0)


def verify_cases(rec, quant, heads):
    """The chunk kernel at phase 12's verify launch: 512 slots, T = SPEC_K
    + 1 = 5 rows (a 64-row tile holds 5 live rows), minitron-4b's 24/8
    heads at D = 128, ragged starts crossing pages; chunk_len 5 for 32
    slots and 0 for the rest, then for all 512.  Each case is held as the
    odd shapes are, timed, and put in ``rec`` under its name (its own
    generators, so that the other cases draw what they drew before)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rng = np.random.default_rng(2)
    T = SPEC_K + 1
    start = rng.integers(0, 256 - T + 1, 512)
    start[:8] = (0, 27, 28, 31, 32, 60, 100, 251)     # around page ends
    spec = np.zeros(512, np.int32)
    spec[::16] = T
    for name, cl in (("verify_32_of_512", spec),
                     ("verify_512_of_512", np.full(512, T, np.int32))):
        r = chunk_case(gen, rng, B=512, T=T, start=start, chunk_len=cl,
                       prefix_len=0, quant=quant, timed=True, **heads)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        rec["odd_shapes_worst_row_of_limit"] = max(
            rec["odd_shapes_worst_row_of_limit"],
            r["out_worst_row_of_limit"])
        rec[name] = {key: r[key] for key in (
            "ms", "host_paced_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "out_worst_row_of_limit")}
        rec[name]["bound_share"] = r["bound_ms"] / r["ms"]
        print(f"  paged_chunk_prefill_attention{'_quant' if quant else ''}"
              f", {name}: {rec[name]}")


def phase_kernels():
    """Returns {kernel name: record} at minicpm-2b's main-path shapes, with
    max_abs_err over every case of that kernel."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    minicpm = dict(Hq=36, Hkv=36, D=64)
    gqa = dict(Hq=24, Hkv=8, D=128)
    records = {}
    # phase 3's decode: 512 slots (the plan's capacity), 32 live at their
    # lengths half-way through generation, the other slots empty
    path_lens = phase3_lens(512)
    decode_ptxas = {kern: r for kern, r in ptxas_record(
        "paged_attention").items() if kern.startswith("paged_decode")}
    for quant in (False, True):
        tag = "_quant" if quant else ""
        rec = decode_case(gen, rng, B=512, lens=path_lens, quant=quant,
                          timed=True, **minicpm)
        # every slot live, ragged lengths over the slot budget crossing
        # page boundaries, trash past each length
        lens = rng.integers(1, 257, 512)
        lens[:4] = (1, 32, 33, 256)
        full = decode_case(gen, rng, B=512, lens=lens, quant=quant,
                           timed=True, **minicpm)
        print(f"  paged_decode_attention{tag}, all 512 slots live: {full}")
        rec["all_live"] = {key: full[key] for key in (
            "ms", "bound_ms", "bound_share", "library_ms", "max_abs_err",
            "out_worst_row_of_limit")}
        rec["gqa_err"] = max(full["max_abs_err"], decode_case(
            gen, rng, B=64, lens=rng.integers(0, 257, 64), quant=quant,
            timed=False, **gqa)["max_abs_err"])
        # the dead-slot yardstick: the same 32 lengths, 32 slots all live
        # (its own generators, so that every other case draws what it drew
        # before the yardstick was added)
        few_gen = torch.Generator(device="cuda")
        few_gen.manual_seed(1)
        few = decode_case(few_gen, np.random.default_rng(1), B=32,
                          lens=path_lens[:32], quant=quant, timed=True,
                          **minicpm)
        rec["gqa_err"] = max(rec["gqa_err"], few["max_abs_err"])
        rec["live32_of_32_ms"] = few["ms"]
        rec["ms_over_live32_of_32"] = rec["ms"] / few["ms"]
        rec["ptxas"] = {kern: r for kern, r in decode_ptxas.items()
                        if ("int8" in kern) == quant}
        records["paged_decode_attention" + tag] = rec
        # chunked prefill: the path's shape (one slot, a 128-row bucket)
        # timed; then odd shapes, each also held by check_rows
        rec = chunk_case(gen, rng, B=1, T=128, start=[64], chunk_len=[128],
                         prefix_len=0, quant=quant, timed=True, **minicpm)
        rec["odd_shapes_worst_row_of_limit"] = rec["out_worst_row_of_limit"]
        for shape, case in chunk_odd_cases(minicpm, gqa):
            r = chunk_case(gen, rng, quant=quant, timed=False, **shape,
                           **case)
            rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
            rec["odd_shapes_worst_row_of_limit"] = max(
                rec["odd_shapes_worst_row_of_limit"],
                r["out_worst_row_of_limit"])
        verify_cases(rec, quant, gqa)
        records["paged_chunk_prefill_attention" + tag] = rec
        torch.cuda.empty_cache()
    for rec in records.values():
        rec["max_abs_err"] = max(rec["max_abs_err"], rec.pop("gqa_err", 0.0))
    # SSD scan at mamba2-2.7b's chunk-call shapes: one slot, a 32- and a
    # 128-token bucket (one chunk each); the timed record is the 128 one.
    # Then two slots of 300 tokens in chunks of 256: two chunks, the second
    # ragged
    short = ssd_case(gen, Bb=1, L=32, timed=True)
    print(f"  ssd_scan, one slot, 32 tokens: {short}")
    rec = ssd_case(gen, Bb=1, L=128, timed=True)
    long = ssd_case(gen, Bb=2, L=300, timed=False)
    for key in ("max_abs_err", "state_max_rel_err"):
        rec[key] = max(rec[key], short[key], long[key])
    rec["ptxas"] = ptxas_record("ssd_scan")
    records["ssd_scan"] = rec
    records.update(whisper_kernels(gen))
    records["chunk_prefill_attention"] = chunk_kernels(gen)
    records["chunk_prefill_attention"]["ptxas"] = ptxas_record(
        "chunk_attention")
    _, records["flash_attention_bwd"] = training_kernels(gen)
    records["grouped_matmul"], attn_err, chunk_err = mixtral_kernels(gen,
                                                                    rng)
    for name, e in (("paged_decode_attention", attn_err),
                    ("paged_chunk_prefill_attention", chunk_err)):
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], e)
    vlm_kernels(records)
    hybrid_kernels(records)
    train_family_kernels(records)
    return records


# paligemma-3b (phase 14): 8 query heads on one kv head at D = 256
VLM_ARCH = "paligemma-3b"
VLM_HEADS = dict(Hq=8, Hkv=1, D=256)
VLM_MAX_SEQ = 512              # 256 prefix rows + up to 200 prompt + 40 new
# #3/#4 at phase 14's chunks: a first chunk (the 256-row prefix and a
# 32-token bucket), a text chunk after it and a ragged one
VLM_CHUNKS = {"first_t288": dict(B=1, T=288, start=[0], chunk_len=[288],
                                 prefix_len=256),
              "text_t64": dict(B=1, T=64, start=[288], chunk_len=[64],
                               prefix_len=0),
              "ragged_t13": dict(B=1, T=13, start=[352], chunk_len=[13],
                                 prefix_len=0)}
VLM_KEYS = ("ms", "host_paced_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "out_worst_row_of_limit")


def vlm_lens(B=512):
    """Phase 14's decode lengths: B slots, the first 32 live at 262-496
    keys (the prefix, a prompt of 6-200 tokens and the tokens so far),
    the rest empty."""
    lens = np.zeros(B, np.int64)
    lens[:32] = np.linspace(262, 496, 32).astype(int)
    return lens


def vlm_record(r):
    out = {k: r[k] for k in VLM_KEYS + ("splits", "cold_ms",
                                        "cold_bound_share") if k in r}
    out["bound_share"] = r["bound_ms"] / r["ms"]
    return out


def vlm_kernels(records):
    """paligemma-3b's shapes, each case held by ``check_rows`` with
    repeated launches bit-identical, timed beside SDPA on the same (or the
    gathered) tensors and the bound, and put in its kernel's record under
    "paligemma" with the D = 256 instances' ``ptxas`` registers and
    spills: #1 and #2 at 512 slots with 32 live at 262-496 keys; #3 and #4
    at ``VLM_CHUNKS``; #6 at the dense-view first and text chunks (S =
    512); #5 at the dense view's decode; #7 over 262 and 456 rows with a
    256-row prefix (the sync path's one-shot prefill).  Its own
    generators, so the other cases draw what they drew before."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    rng = np.random.default_rng(26)
    lens = vlm_lens()
    ptx = {k: v for k, v in ptxas_record("paged_attention").items()
           if ", 256" in k}
    for quant in (False, True):
        tag = "_quant" if quant else ""
        regs = {k: v for k, v in ptx.items() if ("int8" in k) == quant}
        rec = records["paged_decode_attention" + tag]
        r = decode_case(gen, rng, B=512, lens=lens, quant=quant, timed=True,
                        nblk=VLM_MAX_SEQ // 32, **VLM_HEADS)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        rec["paligemma"] = {**vlm_record(r), "ptxas": {
            k: v for k, v in regs.items() if k.startswith("paged_decode")}}
        rec = records["paged_chunk_prefill_attention" + tag]
        sub = {}
        for name, case in VLM_CHUNKS.items():
            r = chunk_case(gen, rng, quant=quant, timed=True,
                           nblk=VLM_MAX_SEQ // 32, **VLM_HEADS, **case)
            rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
            rec["odd_shapes_worst_row_of_limit"] = max(
                rec["odd_shapes_worst_row_of_limit"],
                r["out_worst_row_of_limit"])
            sub[name] = vlm_record(r)
        sub["ptxas"] = {k: v for k, v in regs.items()
                        if k.startswith("paged_chunk")}
        rec["paligemma"] = sub
        torch.cuda.empty_cache()
    rec = records["chunk_prefill_attention"]
    sub = {}
    for name in ("first_t288", "text_t64"):
        case = dict(VLM_CHUNKS[name])
        case.pop("B")
        r = dense_chunk_case(gen, B=1, S=VLM_MAX_SEQ, timed=True,
                             **VLM_HEADS, **case)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        sub[name] = vlm_record(r)
    sub["ptxas"] = {k: v for k, v in ptxas_record("chunk_attention").items()
                    if "256" in k}
    rec["paligemma"] = sub
    rec = records["decode_attention"]
    r = dense_decode_case(gen, B=512, S=VLM_MAX_SEQ, lens=lens, timed=True,
                          **VLM_HEADS)
    rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
    rec["paligemma"] = {**vlm_record(r), "ptxas": {
        k: v for k, v in ptxas_record("decode_attention").items()
        if "256" in k}}
    rec = records["flash_attention"]
    sub = {}
    for L in (262, 456):
        r = flash_case(gen, B=1, Lq=L, Lk=L, timed=True, causal=True,
                       prefix_len=256, **VLM_HEADS)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        sub[f"prefix256_rows{L}"] = vlm_record(r)
    sub["ptxas"] = {k: v for k, v in ptxas_record("flash_attention").items()
                    if "256" in k}
    rec["paligemma"] = sub
    for name in ("paged_decode_attention", "paged_decode_attention_quant",
                 "paged_chunk_prefill_attention",
                 "paged_chunk_prefill_attention_quant",
                 "chunk_prefill_attention", "decode_attention",
                 "flash_attention"):
        print(f"  {name}, paligemma-3b (8/1 heads, D = 256): "
              f"{json.dumps(records[name]['paligemma'])}")
    torch.cuda.empty_cache()


# zamba2-7b (phase 15): the shared block's 32 query heads on 32 kv heads at
# D = 112; 256 slots (the plan's), 256-token slot budgets
HYBRID_ARCH = "zamba2-7b"
HYBRID_HEADS = dict(Hq=32, Hkv=32, D=112)
HYBRID_MAX_SEQ = 256
HYBRID_PAIR_REQUESTS = 16      # phase 15 (b)'s waves, int8's included
# #3/#4 at phase 15's chunks: a 128-row bucket at 64 (phase 3's) and a
# ragged 13-row one at 150
HYBRID_CHUNKS = {"t128_at64": dict(B=1, T=128, start=[64], chunk_len=[128],
                                   prefix_len=0),
                 "ragged_t13": dict(B=1, T=13, start=[150], chunk_len=[13],
                                    prefix_len=0)}


def phase3_lens(B):
    """Phase 3's decode lengths: B slots, the first 32 live at their
    lengths half-way through generation (26-220 keys), the rest empty."""
    lens = np.zeros(B, np.int64)
    lens[:32] = np.linspace(6, 200, 32).astype(int) + 20
    return lens


def hybrid_kernels(records):
    """zamba2-7b's shapes (32/32 heads at D = 112: the paged decode at the
    D = 128 width over rows of 112, the other kernels' own D = 112
    instances), each case held by ``check_rows`` with repeated launches
    bit-identical, timed beside SDPA on the same (or the gathered) tensors
    and the bound, and put in its kernel's record under "zamba2" with the
    D = 112 instances' ``ptxas`` registers and spills: #1 and #2 at the
    plan's 256 slots with 32 live; #3 and #4 at ``HYBRID_CHUNKS``; #6 at
    the dense view's 128-row chunk (S = 256); #5 at the dense view's decode
    (the oracle's 128 slots); #7 over 200 rows (the sync path's one-shot
    prefill of the longest prompt); and #10 at the chunk call's shape (112
    heads, P = 64, N = 64, a 128-token bucket).  Its own generators, so
    the other cases draw what they drew before."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    rng = np.random.default_rng(27)
    d112 = lambda source: {k: v for k, v in ptxas_record(source).items()
                           if ", 112" in k or "<112" in k}
    ptx = d112("paged_attention")
    nblk = HYBRID_MAX_SEQ // 32
    for quant in (False, True):
        tag = "_quant" if quant else ""
        regs = {k: v for k, v in ptx.items() if ("int8" in k) == quant}
        rec = records["paged_decode_attention" + tag]
        r = decode_case(gen, rng, B=256, lens=phase3_lens(256), quant=quant,
                        timed=True, nblk=nblk, **HYBRID_HEADS)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        rec["zamba2"] = {**vlm_record(r), "ptxas": {
            k: v for k, v in regs.items() if k.startswith("paged_decode")}}
        rec = records["paged_chunk_prefill_attention" + tag]
        sub = {}
        for name, case in HYBRID_CHUNKS.items():
            r = chunk_case(gen, rng, quant=quant, timed=True, nblk=nblk,
                           **HYBRID_HEADS, **case)
            rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
            rec["odd_shapes_worst_row_of_limit"] = max(
                rec["odd_shapes_worst_row_of_limit"],
                r["out_worst_row_of_limit"])
            sub[name] = vlm_record(r)
        sub["ptxas"] = {k: v for k, v in regs.items()
                        if k.startswith("paged_chunk")}
        rec["zamba2"] = sub
        torch.cuda.empty_cache()
    rec = records["chunk_prefill_attention"]
    case = dict(HYBRID_CHUNKS["t128_at64"])
    case.pop("B")
    r = dense_chunk_case(gen, B=1, S=HYBRID_MAX_SEQ, timed=True,
                         **HYBRID_HEADS, **case)
    rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
    rec["zamba2"] = {"t128_at64": vlm_record(r),
                     "ptxas": d112("chunk_attention")}
    rec = records["decode_attention"]
    r = dense_decode_case(gen, B=128, S=HYBRID_MAX_SEQ, lens=phase3_lens(128),
                          timed=True, **HYBRID_HEADS)
    rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
    rec["zamba2"] = {**vlm_record(r), "ptxas": d112("decode_attention")}
    rec = records["flash_attention"]
    r = flash_case(gen, B=1, Lq=200, Lk=200, timed=True, causal=True,
                   **HYBRID_HEADS)
    rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
    rec["zamba2"] = {"causal_rows200": vlm_record(r),
                     "ptxas": d112("flash_attention")}
    rec = records["ssd_scan"]
    r = ssd_case(gen, Bb=1, L=128, H=112, P=64, G=1, N=64, timed=True)
    rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
    rec["state_max_rel_err"] = max(rec["state_max_rel_err"],
                                   r["state_max_rel_err"])
    rec["zamba2"] = {"chunk128_H112_P64_N64": vlm_record(r),
                     "ptxas": {k: v for k, v in ptxas_record(
                         "ssd_scan").items() if "64, 64" in k}}
    for name in ("paged_decode_attention", "paged_decode_attention_quant",
                 "paged_chunk_prefill_attention",
                 "paged_chunk_prefill_attention_quant",
                 "chunk_prefill_attention", "decode_attention",
                 "flash_attention", "ssd_scan"):
        print(f"  {name}, zamba2-7b (32/32 heads, D = 112; the SSD scan at "
              f"112 heads, P = N = 64): {json.dumps(records[name]['zamba2'])}")
    torch.cuda.empty_cache()


def train_family_kernels(records):
    """Phase 16's training shapes, each put in its kernel's record under
    "train" (its own generators, so the other cases draw what they drew
    before): #8 at zamba2-7b's D = 112 (1 x 4096 x 4096, 32/32 heads,
    causal; SDPA's backward beside it) and two ragged D = 112 cases, with
    the D = 112 instances' ``ptxas`` registers and spills; #9's two
    backward products at mixtral-8x7b's training microbatch (two routing
    groups of 2048 at capacity 640: C = 1280 rows an expert), dX (8, 1280,
    14336) @ (8, 14336, 4096) and dW (8, 4096, 1280) @ (8, 1280, 14336),
    on the TMA route, ``torch.bmm`` beside each; #10 over a 4096-token
    sequence in chunks of 256 at mamba2-2.7b's 80 heads (P = 64, N = 128)
    and zamba2-7b's 112 (P = N = 64), and ``_SsdScan``'s backward there
    (a recompute of the plain scan: plain PyTorch, CUDA events)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    rec = records["flash_attention_bwd"]
    r = flash_bwd_case(gen, B=1, Lq=4096, Lk=4096, Hq=32, Hkv=32, D=112,
                       causal=True, timed=True)
    sub = {"zamba2_1x4096_causal": {**vlm_record(r), "tflops": r["tflops"],
                                    "dq_worst_row_of_limit":
                                        r["dq_worst_row_of_limit"]}}
    errs = [r["max_abs_err"]]
    for case in (dict(B=2, Lq=70, Lk=90, Hq=4, Hkv=2, causal=True),
                 dict(B=1, Lq=300, Lk=300, Hq=4, Hkv=4, causal=True,
                      window=100)):
        errs.append(flash_bwd_case(gen, D=112, timed=False,
                                   **case)["max_abs_err"])
    rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
    sub["ptxas"] = {k: v for k, v in ptxas_record(
        "flash_attention_bwd").items() if "112" in k}
    rec["train"] = sub
    torch.cuda.empty_cache()
    rec = records["grouped_matmul"]
    sub = {}
    for name, (E, C, K, N) in (("dX", (8, 1280, 14336, 4096)),
                               ("dW", (8, 4096, 1280, 14336))):
        r = gmm_case(gen, E=E, C=C, K=K, N=N, timed=True, route="tma")
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        sub[name] = {**vlm_record(r), "tflops": r["tflops"]}
        torch.cuda.empty_cache()
    rec["train"] = sub
    rec = records["ssd_scan"]
    sub = {}
    for name, shape in (("mamba2", dict(H=80, P=64, N=128)),
                        ("zamba2", dict(H=112, P=64, N=64))):
        r = ssd_case(gen, Bb=1, L=4096, G=1, chunk=256, timed=True, **shape)
        for key in ("max_abs_err", "state_max_rel_err"):
            rec[key] = max(rec[key], r[key])
        sub[name] = {**vlm_record(r),
                     "backward_plain_recompute_ms": ssd_backward_ms(
                         gen, L=4096, **shape)}
        torch.cuda.empty_cache()
    rec["train"] = sub
    for name in ("flash_attention_bwd", "grouped_matmul", "ssd_scan"):
        print(f"  {name}, training shapes: "
              f"{json.dumps(records[name]['train'])}")


def ssd_backward_ms(gen, *, L, H, P, N, chunk=256):
    """CUDA-event time of ``_SsdScan``'s backward (the plain chunked
    scan's recompute and its gradient) over one L-token sequence, as
    ``ops.ssd_scan`` under autograd runs it; plain PyTorch, printed as
    such."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    proj = rand(1, L, H * P + 2 * N).to(torch.bfloat16)
    ins = [proj[..., :H * P].reshape(1, L, H, P), F.softplus(
        rand(1, L, H) - 2.0), -torch.exp(rand(H) * 0.5),
        proj[..., H * P:H * P + N].reshape(1, L, 1, N),
        proj[..., H * P + N:].reshape(1, L, 1, N), rand(H)]
    ins = [t.detach().requires_grad_(True) for t in ins]
    y, _ = ops.ssd_scan(*ins, chunk=chunk)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    grads = torch.autograd.grad(y, ins, dy, retain_graph=True)
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "ssd_scan backward: non-finite gradient")
    return time_ms(lambda: torch.autograd.grad(y, ins, dy,
                                               retain_graph=True),
                   iters=2, reps=3)


# ---------------------------------------------------------------------------
# phases 2 and 3: the serving main path
# ---------------------------------------------------------------------------

def prefix_counters(rt):
    """A runtime's prefix-cache totals, as the launcher prints them."""
    return (f"prefix cache {'on' if rt.prefix_cache_enabled else 'off'}: "
            f"{rt.prefix_hits} hits, {rt.prefix_hit_tokens} prompt tokens "
            f"reused, {rt.prefill_tokens_computed} computed, "
            f"{rt.prefix_cow_copies} COW copies, {rt.prefix_evictions} LRU "
            f"evictions")


def phase_launcher():
    from repro_torch.launch import serve
    rc = serve.main(["--archs", "minicpm-2b", "--requests", "8",
                     "--max-new-tokens", "16"])
    check(rc == 0, f"launcher exited {rc}")


def wave(kv_dtype, n_requests=32, new_tokens=40):
    import torch
    from repro_torch.kernels import paged_attention
    from repro_torch.launch.profile_step import wave_runtime
    torch.cuda.reset_peak_memory_stats()
    cfg, rt = wave_runtime(kv_dtype, n_requests, new_tokens)
    launches0 = dict(paged_attention.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(len(results) == n_requests,
          f"{kv_dtype} wave served {len(results)}/{n_requests}")
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    for t in toks.values():
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    n_tok = sum(len(t) for t in toks.values())
    grown = {k: paged_attention.launches[k] - launches0[k]
             for k in paged_attention.launches}
    print(f"phase 3 ({kv_dtype} KV): served {len(results)}/{n_requests}, "
          f"{n_tok} tokens in {dt:.3f} s = {n_tok / dt:.1f} tok/s, "
          f"{rt.decode_steps} decode steps, {rt.prefill_chunk_calls} "
          f"prefill chunks, launches {grown}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
          f"{prefix_counters(rt)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return toks, grown, n_tok / dt


def wave_mamba2(n_requests=32, new_tokens=40):
    """Phase 4: the request wave through mamba2-2.7b's state path."""
    import torch
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.profile_step import wave_runtime
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cfg, rt = wave_runtime(-1, n_requests, new_tokens, arch="mamba2-2.7b")
    mem_weights = torch.cuda.memory_allocated()
    check(rt.plan.max_in_flight == 128 and rt.plan.sticky,
          f"unexpected mamba2-2.7b plan {rt.plan}")
    decodes = record_decodes(rt, range(TP_FAMILY_REQUESTS))
    final = keep_final_logits(rt)
    ssd_scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = ssd_scan.launches["ssd_scan"]
    routes = dict(ssd_scan.route_launches)
    check(len(results) == n_requests,
          f"mamba2-2.7b wave served {len(results)}/{n_requests}")
    for r in results:
        t = np.asarray(r.tokens)
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    arena = rt.groups[0].arena
    # layer by layer: isfinite over a whole 21.5 GB stack would allocate
    # more than the stack itself
    check(all(bool(torch.isfinite(layer).all()) for st in arena.state
              for layer in st), "non-finite SSM state")
    check(launches > 0, "the mamba2-2.7b wave never launched ssd_scan")
    check(routes["vec16"] == launches,
          f"a mamba2-2.7b scan left the 16-byte copy route: {routes}")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"phase 4 (mamba2-2.7b, {arena.capacity} slots, "
          f"{arena.state_slot_bytes / 1e6:.1f} MB of state a slot): served "
          f"{len(results)}/{n_requests}, {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s, {rt.decode_steps} decode steps, "
          f"{rt.prefill_chunk_calls} prefill chunks, ssd_scan launches "
          f"{launches} (by copy route {routes}), memory (GB) before "
          f"{mem0 / 1e9:.2f}, with weights "
          f"{mem_weights / 1e9:.2f}, after "
          f"{torch.cuda.memory_allocated() / 1e9:.2f}, peak {peak / 1e9:.2f}, "
          f"{prefix_counters(rt)}")
    base = {"chains": {r.rid: np.asarray(r.tokens) for r in results},
            "decodes": decodes, "final": final, "drops": None,
            "cost": rt.decode_cost_analysis()}
    del rt, arena
    gc.collect()
    torch.cuda.empty_cache()
    return launches, base


def wave_whisper(n_requests=32, new_tokens=40):
    """Phase 5: the request wave through whisper-large-v3's encoder-decoder
    path; every launch count is zeroed just before it and read just after.
    Returns the counts."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.kernels.ops import launch_counts
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cfg, rt = wave_runtime(-1, n_requests, new_tokens,
                           arch="whisper-large-v3")
    mem_weights = torch.cuda.memory_allocated()
    check(rt.plan.max_in_flight == 128 and rt.kv_dtype == "int8",
          f"unexpected whisper-large-v3 plan {rt.plan}")
    decodes = record_decodes(rt, range(TP_FAMILY_REQUESTS))
    final = keep_final_logits(rt)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == n_requests,
          f"whisper-large-v3 wave served {len(results)}/{n_requests}")
    for r in results:
        t = np.asarray(r.tokens)
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    arena = rt.groups[0].arena
    check(arena.state_slot_bytes == 245_760_000,
          f"cross K/V state is {arena.state_slot_bytes} B a slot")
    # layer by layer: isfinite over a whole 15.7 GB stack would allocate
    # more than the stack itself
    check(all(bool(torch.isfinite(layer).all()) for st in arena.state
              for layer in st), "non-finite cross K/V state")
    for name in ("flash_attention", "decode_attention",
                 "paged_decode_attention_quant",
                 "paged_chunk_prefill_attention_quant"):
        check(launches[name] > 0,
              f"the whisper-large-v3 wave never launched {name}: {launches}")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"phase 5 (whisper-large-v3, {arena.capacity} slots, "
          f"{arena.state_slot_bytes / 1e6:.2f} MB of cross K/V a slot, "
          f"{rt.kv_dtype} KV): served {len(results)}/{n_requests}, {n_tok} "
          f"tokens in {dt:.3f} s = {n_tok / dt:.1f} tok/s, "
          f"{rt.decode_steps} decode steps, {rt.prefill_chunk_calls} "
          f"prefill chunks, launches {launches}, memory (GB) before "
          f"{mem0 / 1e9:.2f}, with weights {mem_weights / 1e9:.2f}, after "
          f"{torch.cuda.memory_allocated() / 1e9:.2f}, peak {peak / 1e9:.2f}, "
          f"{prefix_counters(rt)}")
    print("phase 5 greedy tokens: " + json.dumps(
        [np.asarray(r.tokens).tolist() for r in
         sorted(results, key=lambda r: r.rid)]))
    base = {"chains": {r.rid: np.asarray(r.tokens) for r in results},
            "decodes": decodes, "final": final, "drops": None,
            "cost": rt.decode_cost_analysis()}
    del rt, arena
    gc.collect()
    torch.cuda.empty_cache()
    return launches, base


def wave_mixtral(n_requests=32, new_tokens=40):
    """Phase 6: the request wave through mixtral-8x7b's MoE path at 16 of
    its 32 layers; every launch count is zeroed just before it and read
    just after.  Returns the counts."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.kernels import grouped_matmul
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models import moe
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cfg, rt = wave_runtime(-1, n_requests, new_tokens, arch="mixtral-8x7b")
    mem_weights = torch.cuda.memory_allocated()
    check((cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts,
           cfg.moe_capacity_factor) == (16, 4096, 14336, 8, 1.25)
          and rt.plan.max_in_flight == 512 and rt.kv_dtype == "bf16",
          f"unexpected mixtral-8x7b wave {cfg} {rt.plan}")
    decodes = record_decodes(rt, range(TP_FAMILY_REQUESTS))
    final = keep_final_logits(rt)
    chunk_drops = record_chunk_drops(rt)
    stats = moe.MOE_DROP_STATS
    stats.flush()
    drop0, assigned0 = stats.dropped, stats.assigned
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, step_drops = [], []
    for _ in range(10_000):
        if not (rt.pending() or rt.in_flight()):
            break
        st = rt.step(max_wait_s=0.0)
        results.extend(st.results)
        step_drops.append(st.moe_dropped_tokens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    routes = dict(grouped_matmul.route_launches)
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == n_requests,
          f"mixtral-8x7b wave served {len(results)}/{n_requests}")
    for r in results:
        t = np.asarray(r.tokens)
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    calls = rt.decode_steps + rt.prefill_chunk_calls
    check(launches["grouped_matmul"] == 3 * cfg.num_layers * calls,
          f"grouped_matmul launched {launches['grouped_matmul']} times, "
          f"not 3 a layer in each of {calls} steps and chunks")
    check(routes["tma"] == launches["grouped_matmul"],
          f"a grouped GEMM launch of the wave left the TMA route: {routes}")
    for name in ("grouped_matmul", "paged_decode_attention",
                 "paged_chunk_prefill_attention"):
        check(launches[name] > 0,
              f"the mixtral-8x7b wave never launched {name}: {launches}")
    arena = rt.groups[0].arena
    check(all(bool(torch.isfinite(layer).all()) for pool in arena.pages
              for layer in pool), "non-finite K/V pools")
    dropped = stats.dropped - drop0
    assigned = stats.assigned - assigned0
    check(dropped == sum(step_drops), "per-step drops do not add up")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"phase 6 (mixtral-8x7b, {cfg.num_layers} of 32 layers, "
          f"{arena.capacity} slots, {rt.kv_dtype} KV): served "
          f"{len(results)}/{n_requests}, {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s, {rt.decode_steps} decode steps, "
          f"{rt.prefill_chunk_calls} prefill chunks, launches {launches}, "
          f"grouped GEMM routes {routes}, "
          f"expert-capacity drops {dropped:.0f} of {assigned:.0f} "
          f"assignments ({dropped / max(assigned, 1.0):.4f}), memory (GB) "
          f"before {mem0 / 1e9:.2f}, with weights {mem_weights / 1e9:.2f}, "
          f"after {torch.cuda.memory_allocated() / 1e9:.2f}, peak "
          f"{peak / 1e9:.2f}, {prefix_counters(rt)}")
    print("phase 6 greedy tokens: " + json.dumps(
        [np.asarray(r.tokens).tolist() for r in
         sorted(results, key=lambda r: r.rid)]))
    check(sum(chunk_drops.values()) == dropped,
          "phase 6: the chunks' drops are not the wave's")
    base = {"chains": {r.rid: np.asarray(r.tokens) for r in results},
            "decodes": decodes, "final": final, "drops": chunk_drops,
            "cost": rt.decode_cost_analysis()}
    del rt, arena
    gc.collect()
    torch.cuda.empty_cache()
    return launches, base


# ---------------------------------------------------------------------------
# phase 8: the sync and dense-cache paths
# ---------------------------------------------------------------------------

def phase_dense_launchers():
    """Phase 8 (a): the launcher at full width in sync mode, with the dense
    cache, and with one-shot prefill."""
    import torch
    from repro_torch.launch import serve
    for flags in (["--mode", "sync"], ["--kvcache-impl", "dense"],
                  ["--no-chunked-prefill"]):
        rc = serve.main(["--archs", "minicpm-2b", "--requests", "8",
                         "--max-new-tokens", "16", *flags])
        check(rc == 0, f"launcher {flags} exited {rc}")
        gc.collect()
        torch.cuda.empty_cache()


def wave_oracle(n_requests=32, new_tokens=40):
    """Phase 8 (b): phase 3's wave through the dense-view step
    (``paged_native=False``, the reference's oracle) at 128 slots, bf16
    KV; every launch count is zeroed just before it and read just after.
    Returns (the counts, tokens by rid)."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch.profile_step import wave_runtime
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cfg, rt = wave_runtime("bf16", n_requests, new_tokens, bs=128,
                           paged_native=False)
    check(rt.plan.max_in_flight == 128 and not rt.paged_native
          and rt.chunked_prefill and rt.kv_dtype == "bf16",
          f"unexpected oracle runtime {rt.plan}")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == n_requests,
          f"oracle wave served {len(results)}/{n_requests}")
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    for t in toks.values():
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    check(launches["chunk_prefill_attention"]
          == cfg.num_layers * rt.prefill_chunk_calls > 0,
          f"chunk_prefill_attention launched "
          f"{launches['chunk_prefill_attention']} times, not "
          f"{cfg.num_layers} in each of {rt.prefill_chunk_calls} chunks")
    check(launches["decode_attention"] == cfg.num_layers * rt.decode_steps
          > 0, f"decode_attention launched {launches['decode_attention']} "
          f"times, not {cfg.num_layers} in each of {rt.decode_steps} steps")
    check(not any(n for k, n in launches.items() if k.startswith("paged")),
          f"the oracle launched a paged kernel: {launches}")
    n_tok = sum(len(t) for t in toks.values())
    print(f"phase 8 (b) oracle wave (minicpm-2b, dense-view step, "
          f"{rt.plan.max_in_flight} slots, bf16 KV): served "
          f"{len(results)}/{n_requests}, {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s, {rt.decode_steps} decode steps, "
          f"{rt.prefill_chunk_calls} prefill chunks, launches {launches}, "
          f"memory (GB) before {mem0 / 1e9:.2f}, peak {peak / 1e9:.2f}, "
          f"{prefix_counters(rt)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, toks


def parity_logits(cfg, params, chunks=(64, 64, 37), steps=3,
                  embeddings=None, max_seq_len=256):
    """One slot of two in two bf16 arenas: a prompt of ``chunks`` (64-row
    buckets, the last ragged) through ``prefill_chunk_paged`` and through
    ``prefill_chunk`` on the arena's dense view (the rows written back by
    ``append_rows``), then ``steps`` decode steps through
    ``decode_step_paged`` and ``decode_step`` on the dense view, both fed
    the native step's greedy token; the second slot is dead.  A VLM's
    first chunk carries ``embeddings`` (1, prefix_len, d_model), its image
    prefix.  Returns each step's (native, dense-view) f32 logits (1, V)
    and both arenas' lengths."""
    import torch
    from repro_torch.models.registry import model_api
    from repro_torch.serving.arena import KVArena
    api = model_api(cfg)
    prompt = np.random.default_rng(17).integers(0, cfg.vocab_size,
                                                sum(chunks))
    arenas = [KVArena(cfg, api.init_cache, capacity=2,
                      max_seq_len=max_seq_len, block_size=32,
                      kv_dtype="bf16", device="cuda") for _ in range(2)]
    for a in arenas:
        a.reset_len(a.alloc(max_seq_len))
        a.reset_len(a.alloc(max_seq_len))
    native, dense = arenas
    bt = native.device_block_tables()[:1]
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    rows, pos = [], 0
    for c in chunks:
        toks = np.zeros((1, 64), np.int64)
        toks[0, :c] = prompt[pos:pos + c]
        batch = {"tokens": torch.from_numpy(toks).cuda()}
        n_rows = 64
        if embeddings is not None and pos == 0:
            batch["embeddings"] = embeddings
            n_rows += cfg.prefix_len
        cl = torch.tensor([c], dtype=torch.int32, device="cuda")
        lg_n, nc = api.prefill_chunk_paged(
            params, cfg, batch, native.assemble(
                native.pages, native.slot_state(0), native.lens[:1]),
            bt, chunk_len=cl, block_size=32)
        native.lens[0] = nc["len"][0]
        st = dense.lens[:1]
        view = dense.dense_view(dense.pages, bt)
        lg_d, dc = api.prefill_chunk(
            params, cfg, batch, dense.assemble(view, dense.slot_state(0), st),
            chunk_len=cl)
        dense.append_rows(dense.pages, dense.disassemble(dc)[0], st, one,
                          bt, n_tokens=n_rows, valid_tokens=dc["len"] - st)
        dense.lens[0] = dc["len"][0]
        rows.append((lg_n.float(), lg_d.float()))
        pos += c
    live = torch.tensor([True, False], device="cuda")
    tables = native.device_block_tables()
    for _ in range(steps):
        tok = torch.zeros(2, dtype=torch.int32, device="cuda")
        tok[0] = rows[-1][0][0].argmax()
        lg_n, nc = api.decode_step_paged(
            params, cfg, tok, native.assemble(native.pages, native.state,
                                              native.lens),
            tables, live, block_size=32)
        native.lens = nc["len"]
        view = dense.dense_view(dense.pages, tables)
        lg_d, dc = api.decode_step(
            params, cfg, tok, dense.assemble(view, dense.state, dense.lens),
            live=live)
        dense.append_rows(dense.pages, dense.disassemble(dc)[0], dense.lens,
                          live, tables)
        dense.lens = dc["len"]
        rows.append((lg_n[:1].float(), lg_d[:1].float()))
    torch.cuda.synchronize()
    return rows, native.lens.tolist(), dense.lens.tolist()


@contextlib.contextmanager
def plain_attention():
    """Within the block the models' attention calls (paged and dense chunk
    and decode) run the plain versions on the card's tensors, f32 math
    with a bf16 output: the yardstick for the noise of a full-width bf16
    chain."""
    from repro_torch.kernels import ops, ref
    swap = {"paged_chunk_attention": ref.paged_chunk_attention_ref,
            "paged_decode_attention": ref.paged_decode_attention_ref,
            "chunk_attention": ref.chunk_attention_ref,
            "decode_attention": ref.decode_attention_ref}
    saved = {name: getattr(ops, name) for name in swap}
    for name, fn in swap.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def logits_parity(chunks=(64, 64, 37), steps=3):
    """Phase 8 (c): ``parity_logits`` on minicpm-2b at full width in bf16:
    the native path runs the paged kernels #3 and #1, the dense-view path
    #6 and #5.  Each step's logits agree to PARITY_TOL of their norm.  The
    limit comes from the noise of the chain itself: 40 layers of random
    bf16 weights amplify one bf16 rounding that two correct kernels place
    differently into a few percent of the logits' norm, so the same steps
    also run with the plain versions on the card, and each path's distance
    from its plain run (the floor) is printed beside the limit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config("minicpm-2b")
    params = transformer.init(1, cfg, "cuda")
    hold_logits_parity("phase 8 (c)", cfg, params, chunks, steps)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def attention_layers(cfg):
    """The attention launches a step makes: one a layer, or for the hybrid
    one an application of its shared block."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def hold_logits_parity(label, cfg, params, chunks=(64, 64, 37), steps=3,
                       embeddings=None, max_seq_len=256, limit=PARITY_TOL):
    """``parity_logits`` held as phase 8 (c) holds it (see
    ``logits_parity``), each step to ``limit`` of the logits' norm;
    returns the per-step report."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    extra = cfg.prefix_len if embeddings is not None else 0
    reset_launches()
    rows, lens_n, lens_d = parity_logits(cfg, params, chunks, steps,
                                         embeddings, max_seq_len)
    grown = launch_counts()
    n = len(chunks) * attention_layers(cfg)
    for name, want in (("paged_chunk_prefill_attention", n),
                       ("chunk_prefill_attention", n),
                       ("paged_decode_attention",
                        steps * attention_layers(cfg)),
                       ("decode_attention", steps * attention_layers(cfg))):
        check(grown[name] == want, f"logits parity launched {grown}")
    check(lens_n == lens_d == [sum(chunks) + extra + steps, 0],
          f"lengths {lens_n} vs {lens_d}")
    with plain_attention():
        plain, _, _ = parity_logits(cfg, params, chunks, steps, embeddings,
                                    max_seq_len)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    report = []
    for i, ((a, b), (pa, pb)) in enumerate(zip(rows, plain)):
        check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
              "non-finite logits")
        report.append({"step": i, "max_abs_diff": (a - b).abs().max().item(),
                       "norm": b.norm().item(), "rel_l2": rel(a, b),
                       "floor": max(rel(a, pa), rel(b, pb)),
                       "identical": torch.equal(a, b)})
    print(f"{label} logits, native (kernels #3, #1) vs dense view "
          f"(#6, #5), {cfg.name} full width, limit {limit} of the "
          f"norm (floor: each path against its plain versions): {report}")
    print(f"{label} the {len(chunks)} chunk steps' rel_l2 (#3 and #6 "
          f"share one body, so 0): "
          f"{[r['rel_l2'] for r in report[:len(chunks)]]}")
    for r in report:
        check(r["rel_l2"] <= limit,
              f"native vs dense-view logits at step {r['step']}: "
              f"|diff| / |logits| = {r['rel_l2']} > {limit}")
    # #3 and #6 run one body (chunk_tiles.cuh) in one tile and sum order,
    # and the dense view holds the pages' values, so until the first
    # decode step (#1 against #5) the two chains are one computation
    for r in report[:len(chunks)]:
        check(r["identical"], f"native vs dense-view logits at chunk step "
              f"{r['step']} differ (rel_l2 {r['rel_l2']}): the chunk "
              f"kernels share one body and must agree bit for bit")
    return report


SYNC_REQUESTS = 16             # phase 8 (d)'s wave: 16 of 32


def wave_sync(n_requests=32, new_tokens=40):
    """Phase 8 (d): phase 3's wave in sync mode (run-to-completion
    batches, left-padded prompts, a dense bf16 cache a batch); returns its
    tokens per second and peak memory."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch.profile_step import wave_runtime
    torch.cuda.reset_peak_memory_stats()
    cfg, rt = wave_runtime("bf16", n_requests, new_tokens, mode="sync")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == n_requests,
          f"sync wave served {len(results)}/{n_requests}")
    for r in results:
        t = np.asarray(r.tokens)
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    check(launches["flash_attention"] > 0 and launches["decode_attention"]
          > 0, f"the sync wave did not launch flash and decode attention: "
          f"{launches}")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"phase 8 (d) sync wave (minicpm-2b, bf16 dense cache): served "
          f"{len(results)}/{n_requests}, {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s, {rt.oneshot_prefills} one-shot "
          f"prefills, {rt.decode_steps} decode steps, launches {launches}, "
          f"peak memory {peak / 1e9:.2f} GB, {prefix_counters(rt)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the prefix cache on templated requests
# ---------------------------------------------------------------------------

def keep_final_logits(rt):
    """Wraps ``rt._run_chunk`` to keep each request's last final-chunk
    logits; returns the dict they go into."""
    final = {}
    run_chunk = rt._run_chunk

    def keep_final(arena, s, T):
        logits, n = run_chunk(arena, s, T)
        if s.consumed >= len(s.req.tokens):
            final[s.req.rid] = logits[0].clone()
        return logits, n
    rt._run_chunk = keep_final
    return final


def templated_run(kv_dtype, prefix_cache, params, templates=1,
                  n_requests=64):
    """One run of phase 9: ``profile_step.templated_wave`` at full width
    (the plan's 512 slots, ``max_seq_len`` 256), its donors served to
    their eviction, then the other requests submitted together and stepped
    until they drain.  Returns the run's record: tokens and final-chunk
    logits by rid, the hit each lookup after the donors found, counters
    and step walls (each step ends in a host read of the sampled tokens,
    so its wall includes the device's work)."""
    import torch
    from repro_torch.kernels import paged_attention
    from repro_torch.launch.profile_step import serve_donors, templated_wave
    # the last run's runtime lives in reference cycles (its wrapped chunk
    # step, the prefix index's hooks): collect it before the next arena
    gc.collect()
    torch.cuda.empty_cache()
    cfg, rt, donors, others = templated_wave(kv_dtype, prefix_cache,
                                             templates, params=params,
                                             n_requests=n_requests)
    check(rt.plan.max_in_flight == 512 and rt.max_seq_len == 256
          and rt.kv_dtype == kv_dtype and rt.paged_native
          and rt.prefix_cache_enabled == (prefix_cache != 0),
          f"unexpected templated runtime {rt.plan}")
    final = keep_final_logits(rt)
    results = list(serve_donors(rt, donors))
    hits = []
    pc = rt.groups[0].prefix
    if pc is not None:
        record = pc.record
        pc.record = lambda hit, n: (
            hits.append(0 if hit is None else hit.tokens), record(hit, n))
    before = dict(computed=rt.prefill_tokens_computed,
                  chunks=rt.prefill_chunk_calls, steps=rt.decode_steps,
                  hits=rt.prefix_hits, cow=rt.prefix_cow_copies,
                  evictions=rt.prefix_evictions)
    launches0 = dict(paged_attention.launches)
    for req in others:
        rt.submit(req)
    walls, decode_only = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10_000):
        if not (rt.pending() or rt.in_flight()):
            break
        ts = time.perf_counter()
        st = rt.step(max_wait_s=0.0)
        walls.append(time.perf_counter() - ts)
        if st.decode_steps and not st.prefill_chunk_tokens:
            decode_only.append(walls[-1])
        results.extend(st.results)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(len(results) == len(donors) + len(others),
          f"templated wave served {len(results)}/"
          f"{len(donors) + len(others)}")
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    for t in toks.values():
        check(len(t) == others[0].max_new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    check(sorted(final) == sorted(toks), "a request's final chunk is missing")
    for rid, lg in final.items():
        check(bool(torch.isfinite(lg).all()), f"non-finite logits, rid {rid}")
    n_tok = sum(len(toks[r.rid]) for r in others)
    rec = {"kv": kv_dtype, "prefix_cache": prefix_cache,
           "templates": templates, "enabled": rt.prefix_cache_enabled,
           "requests": len(results), "tok_s": n_tok / dt, "wall_s": dt,
           "steps": len(walls),
           "host_wall_ms_per_step": 1e3 * float(np.mean(walls)),
           "median_wall_ms_per_step": 1e3 * float(np.median(walls)),
           "decode_only_steps": len(decode_only),
           "decode_only_wall_ms": (1e3 * float(np.mean(decode_only))
                                   if decode_only else None),
           "lookups": len(hits), "hits": sum(h > 0 for h in hits),
           "min_hit_tokens": min((h for h in hits if h), default=0),
           "computed": rt.prefill_tokens_computed - before["computed"],
           "chunks": rt.prefill_chunk_calls - before["chunks"],
           "decode_steps": rt.decode_steps - before["steps"],
           "hit_tokens": rt.prefix_hit_tokens,
           "cow": rt.prefix_cow_copies - before["cow"],
           "evictions": rt.prefix_evictions,
           "evictions_in_wave": rt.prefix_evictions - before["evictions"],
           "launches": {k: paged_attention.launches[k] - launches0[k]
                        for k in paged_attention.launches}}
    print(f"phase 9 run ({kv_dtype} KV, prefix_cache={prefix_cache}, "
          f"{templates} template(s)): {rec}, {prefix_counters(rt)}")
    return rec, toks, final


def cow_exact():
    """Copy-on-write on the card is an exact copy: a minicpm-2b arena
    (int8, then bf16 pools) with random pages, two registered blocks of one
    slot shared into another and copied by one ``cow_blocks``; the copies'
    values (and int8 scales) equal the sources' bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.arena import KVArena
    from repro_torch.kernels.quant import QuantPages
    cfg = get_config("minicpm-2b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    out = {}
    for kv in ("int8", "bf16"):
        a = KVArena(cfg, transformer.init_cache, capacity=2, max_seq_len=256,
                    block_size=32, kv_dtype=kv, device="cuda")
        tensors = [t for p in a.pages for t in (
            (p.values, p.scales) if isinstance(p, QuantPages) else (p,))]
        for t in tensors:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device="cuda", dtype=torch.int8))
            else:
                t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
        src_slot = a.alloc(256)
        src = a._slot_blocks[src_slot][3:5]
        for b in a._slot_blocks[src_slot][:5]:
            a.register(b)
        dst_slot = a.alloc(256, shared=a._slot_blocks[src_slot][:5])
        copied = a.cow_blocks([(dst_slot, 3), (dst_slot, 4)])
        torch.cuda.synchronize()
        dst = a._slot_blocks[dst_slot][3:5]
        check(copied == 2 and a.cow_calls == 1 and not set(src) & set(dst),
              f"{kv} copy-on-write copied {copied} in {a.cow_calls} calls")
        exact = all(torch.equal(t[:, dst], t[:, src]) for t in tensors)
        check(exact, f"{kv} copy-on-write is not an exact copy")
        out[kv] = {"tensors": len(tensors), "blocks": copied, "exact": exact}
        del a, tensors
    torch.cuda.empty_cache()
    print(f"phase 9 copy-on-write on the card (minicpm-2b pools, values and "
          f"int8 scales compared with torch.equal): {out}")


def phase_templated():
    """Phase 9: minicpm-2b's templated wave with the prefix cache on (the
    category's -1) and off (0) in int8 KV, then two alternating templates
    at 8 retained blocks, on and off; each request's final-chunk
    logits are held to the cache-off run's to PARITY_TOL of their norm
    (two correct bf16 chains, as in phase 8 (c)); then the copy-on-write
    check (the on run's first steps under ``torch.profiler`` were cut for
    the script's time limit: ``profile_step --templated`` runs them).
    Every launch count is zeroed just before the runs and read just
    after.  Returns the counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models.registry import model_api
    cfg = get_config("minicpm-2b")
    params = model_api(cfg).init(1, cfg, "cuda")
    rel = lambda a, b: ((a.float() - b.float()).norm()
                        / b.float().norm()).item()
    reset_launches()
    # (the bf16 pair, 39 s of drains, was cut for the script's time limit:
    # cow_exact still holds bf16 pools' copy-on-write; so were each
    # pair's last 32 requests, 85 s of drains, and the one-template
    # pair's 16 more)
    for kv, knob, templates, n in (("int8", -1, 1, 16), ("int8", 8, 2, 32)):
        on, on_toks, on_lg = templated_run(kv, knob, params, templates, n)
        off, off_toks, off_lg = templated_run(kv, 0, params, templates, n)
        rels = sorted(rel(on_lg[r], off_lg[r]) for r in off_lg)
        worst = rels[-1]
        same = sum(bool(np.array_equal(on_toks[r], off_toks[r]))
                   for r in off_toks)
        others = on["requests"] - templates
        print(f"phase 9 {kv} KV, {templates} template(s), prefix_cache="
              f"{knob}: on vs off tok/s {on['tok_s']:.1f} vs "
              f"{off['tok_s']:.1f}, prefill chunks {on['chunks']} vs "
              f"{off['chunks']}, prompt tokens computed {on['computed']} vs "
              f"{off['computed']}, host wall per step "
              f"{on['host_wall_ms_per_step']:.3f} vs "
              f"{off['host_wall_ms_per_step']:.3f} ms ({on['steps']} vs "
              f"{off['steps']} steps; decode-only steps "
              f"{on['decode_only_wall_ms']} vs {off['decode_only_wall_ms']} "
              f"ms), hits {on['hits']}/{on['lookups']} (fewest tokens "
              f"{on['min_hit_tokens']}), COW copies {on['cow']}, LRU "
              f"evictions {on['evictions']}; final-chunk logits "
              f"|on - off| / |off| median {rels[len(rels) // 2]}, worst "
              f"{worst} (limit {PARITY_TOL}); greedy chains equal in full "
              f"{same}/{len(off_toks)}")
        print(f"phase 9 {kv} KV, {templates} template(s): every request's "
              f"final-chunk |on - off| / |off|, sorted: {rels}")
        check(worst <= PARITY_TOL, f"{kv} templated final-chunk logits with "
              f"the cache differ from without: {worst} > {PARITY_TOL}")
        check(off["hits"] == off["lookups"] == off["cow"] == 0,
              f"the cache-off run used the cache: {off}")
        if templates == 1:
            check(on["lookups"] == others and on["hits"] >= others - 1
                  and on["min_hit_tokens"] >= 128,
                  f"{kv}: {on['hits']} of {on['lookups']} lookups hit, the "
                  f"smallest {on['min_hit_tokens']} tokens")
            check(on["computed"] <= off["computed"] - others * 128,
                  f"{kv}: {on['computed']} prompt tokens computed with the "
                  f"cache, {off['computed']} without")
            check(on["cow"] >= others, f"{kv}: {on['cow']} COW copies")
        else:
            check(on["evictions"] > 0, f"no LRU eviction at 8 retained "
                  f"blocks: {on}")
        for name, n in on["launches"].items():
            check(n > 0 or ("quant" in name) != (kv == "int8"),
                  f"the {kv} templated wave never launched {name}")
    launches = launch_counts()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cow_exact()
    return launches


# ---------------------------------------------------------------------------
# phase 10: observability and crash evacuation
# ---------------------------------------------------------------------------

def phase_obs_smoke():
    """Phase 10 (a): the launcher with ``make obs-smoke``'s flags, its
    trace, metrics and calibration written to a temporary directory and
    read back by the port's own ``validate_chrome_trace`` and
    ``parse_prometheus_text``."""
    import tempfile
    from repro_torch.launch import serve
    from repro_torch.obs import parse_prometheus_text, validate_chrome_trace
    with tempfile.TemporaryDirectory() as d:
        trace, prom, cal = (str(Path(d) / n) for n in (
            "obs_trace.json", "obs_metrics.prom", "obs_calibration.json"))
        rc = serve.main(["--archs", "minicpm-2b", "--requests", "6",
                         "--max-new-tokens", "4", "--trace-out", trace,
                         "--metrics-out", prom, "--calibrate-out", cal])
        check(rc == 0, f"obs-smoke launcher exited {rc}")
        n_events = validate_chrome_trace(json.loads(Path(trace).read_text()))
        series = parse_prometheus_text(Path(prom).read_text())
        overrides = json.loads(Path(cal).read_text())["sim_config_overrides"]
    check(series['epara_requests_finished_total{service="minicpm-2b"}']
          == 6, f"obs-smoke metrics: {series}")
    print(f"phase 10 (a) obs-smoke: {n_events} trace events, {len(series)} "
          f"series, overrides: {overrides}")


def hist_quantile(hist, q):
    """Prometheus' ``histogram_quantile`` over ``Histogram.value()``: the
    q-th observation's value, interpolated linearly inside its bucket (the
    largest finite bound where it falls in the +Inf bucket)."""
    rank = q * hist["count"]
    lo, below = 0.0, 0
    for le, cum in hist["buckets"].items():
        if cum >= rank:
            if le == "+Inf":
                return lo
            return lo + (float(le) - lo) * (rank - below) / max(cum - below, 1)
        lo, below = float(le), cum
    return lo


def obs_wave(tracer=None, metrics=None):
    """Phase 3's int8 wave (``profile_step.wave_runtime``) with an optional
    tracer and registry, stepped to idle as ``drain`` steps it.  Returns
    tokens and final-chunk logits by rid, tok/s, the mean host wall per
    step (each step ends in a host read of the sampled tokens) and the
    paged-attention launches of the run."""
    import torch
    from repro_torch.kernels import paged_attention
    from repro_torch.launch.profile_step import wave_runtime
    gc.collect()
    torch.cuda.empty_cache()
    cfg, rt = wave_runtime("int8", tracer=tracer, metrics=metrics)
    final = keep_final_logits(rt)
    launches0 = dict(paged_attention.launches)
    results, walls = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while rt.pending() or rt.in_flight():
        ts = time.perf_counter()
        results.extend(rt.step(max_wait_s=0.0).results)
        walls.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    rec = {"obs": tracer is not None, "tok_s": sum(map(len, toks.values()))
           / dt, "steps": len(walls),
           "host_wall_ms_per_step": 1e3 * float(np.mean(walls)),
           "launches": {k: paged_attention.launches[k] - launches0[k]
                        for k in paged_attention.launches}}
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return toks, final, rec


def phase_obs_wave(phase3_toks, phase3_launches):
    """Phase 10 (b): phase 3's int8 wave untraced, then traced (a
    ``Tracer`` and a ``MetricsRegistry``; the second traced and untraced
    runs were cut for the script's time limit).  Every run's greedy
    chains equal phase 3's and so do its paged-attention launches; the
    untraced and traced runs' final-chunk logits are identical; every
    request's timeline is balanced, ``request`` > ``queued``, ``prefill``,
    ``decode``, served; the TTFT, TPOT and queue-wait histograms count every
    request.  Returns the first traced run's final-chunk logits."""
    import torch
    from repro_torch.obs import MetricsRegistry, Tracer
    runs, logits = [], []
    for traced in (False, True):
        tracer, metrics = ((Tracer(), MetricsRegistry()) if traced
                           else (None, None))
        toks, final, rec = obs_wave(tracer, metrics)
        check(sorted(toks) == sorted(phase3_toks)
              and all(np.array_equal(toks[r], phase3_toks[r])
                      for r in phase3_toks),
              f"a greedy chain differs from phase 3's (obs={traced})")
        check(rec["launches"] == phase3_launches,
              f"launches {rec['launches']} != phase 3's {phase3_launches}")
        runs.append(rec)
        logits.append(final)
        if len(runs) == 2:              # the first traced run
            svc = "minicpm-2b"
            for rid in toks:
                tid = str(rid)
                roots, instants = tracer.span_tree(svc, tid)
                check(tracer.open_spans(svc, tid) == [] and len(roots) == 1
                      and [c.name for c in roots[0].children]
                      == ["queued", "prefill", "decode"]
                      and roots[0].args.get("outcome") == "served"
                      and [i.name for i in instants] == ["first_token"],
                      f"request {rid}'s timeline: {roots} {instants}")
            hists = {n: metrics.histogram(n).value(service=svc)
                     for n in ("ttft_seconds", "tpot_seconds",
                               "queue_wait_seconds")}
            check(all(h["count"] == len(toks) for h in hists.values()),
                  f"histogram counts {[h['count'] for h in hists.values()]}")
            lat = {n: {"median": hist_quantile(h, 0.5),
                       "p99": hist_quantile(h, 0.99),
                       "mean": h["sum"] / h["count"], "count": h["count"]}
                   for n, h in hists.items()}
            print(f"phase 10 (b) latency from the histograms (bucket-"
                  f"interpolated median and p99, exact mean, seconds): {lat}; "
                  f"{tracer.emitted} trace events, {tracer.dropped} dropped")
    check(sorted(logits[0]) == sorted(logits[1]) == sorted(phase3_toks)
          and all(torch.equal(logits[0][r], logits[1][r])
                  for r in logits[0]),
          "the final-chunk logits differ with obs on")
    off = [r for r in runs if not r["obs"]]
    on = [r for r in runs if r["obs"]]
    print(f"phase 10 (b) int8 wave, obs off, on: tok/s "
          f"{[r['tok_s'] for r in runs]}, host wall ms per step "
          f"{[r['host_wall_ms_per_step'] for r in runs]} ({runs[0]['steps']} "
          f"steps); mean on vs off: tok/s "
          f"{np.mean([r['tok_s'] for r in on])} vs "
          f"{np.mean([r['tok_s'] for r in off])}, host wall per step "
          f"{np.mean([r['host_wall_ms_per_step'] for r in on])} vs "
          f"{np.mean([r['host_wall_ms_per_step'] for r in off])} ms; every "
          f"chain equals phase 3's, launches {runs[0]['launches']}")
    return logits[1]


EVACUATE_AFTER = 2      # steps before the crash: 24 of the 32 requests
#                         admitted (12 a step), so queued, mid-prefill and
#                         decoding requests are all present (checked below)


def phase_evacuate(phase3_toks, phase3_final):
    """Phase 10 (c): phase 3's int8 wave, traced, evacuated after
    ``EVACUATE_AFTER`` steps, its requests resubmitted to the same runtime
    and served to idle.  Checks the counters, the arena (no live slot, free
    plus idle cached blocks are the pool), the two ``request`` roots of
    each resubmitted timeline; counts the chains equal to phase 3's and
    holds every resubmitted request's final-chunk logits to phase 3's
    (phase 10 (b)'s traced run) within PARITY_TOL of their norm."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.obs import MetricsRegistry, Tracer
    gc.collect()
    torch.cuda.empty_cache()
    tracer = Tracer()
    cfg, rt = wave_runtime("int8", tracer=tracer, metrics=MetricsRegistry())
    final = keep_final_logits(rt)
    results = []
    for _ in range(EVACUATE_AFTER):
        results.extend(rt.step(max_wait_s=0.0).results)
    slots = [s for g in rt.groups.values() for s in g.slots]
    state = {"queued": rt.pending(),
             "waiting_prefill": sum(s.prefilling and s.consumed == 0
                                    for s in slots),
             "mid_prefill": sum(s.prefilling and s.consumed > 0
                                for s in slots),
             "decoding": sum(not s.prefilling for s in slots),
             "finished": len(results)}
    check(state["queued"] and state["mid_prefill"] and state["decoding"],
          f"after {EVACUATE_AFTER} steps not every state is present: {state}")
    hits0 = rt.prefix_hits
    back = rt.evacuate()
    arena = rt.groups[0].arena
    check(rt.evacuations == 1 and rt.evacuated_requests == len(back)
          == len(phase3_toks) - len(results),
          f"evacuation counters {rt.evacuations} {rt.evacuated_requests} "
          f"{len(back)}")
    check(rt.pending() == rt.in_flight() == arena.live == 0,
          "a request survived the evacuation")
    check(len(arena._free_blocks) + len(arena._idle_cached)
          == arena.free_capacity == arena.pool_blocks,
          f"arena after evacuation: {len(arena._free_blocks)} free + "
          f"{len(arena._idle_cached)} idle cached of {arena.pool_blocks}")
    for req in back:
        rt.submit(req)
    stats = [rt.step(max_wait_s=0.0)]
    while rt.pending() or rt.in_flight():
        stats.append(rt.step(max_wait_s=0.0))
    check(stats[0].evacuated == len(back)
          and all(st.evacuated == 0 for st in stats[1:]),
          f"StepStats.evacuated {[st.evacuated for st in stats[:3]]}")
    for st in stats:
        results.extend(st.results)
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    check(sorted(toks) == sorted(phase3_toks),
          f"served {len(toks)}/{len(phase3_toks)} after the evacuation")
    rel = {r.rid: ((final[r.rid].float() - phase3_final[r.rid].float()).norm()
                   / phase3_final[r.rid].float().norm()).item() for r in back}
    same = [r.rid for r in back
            if np.array_equal(toks[r.rid], phase3_toks[r.rid])]
    worst = max(rel.values())
    check(all(np.array_equal(toks[r], phase3_toks[r]) for r in toks
              if r not in rel), "a request served before the crash changed")
    check(all(rel[r] <= PARITY_TOL for r in rel if r not in same),
          f"a differing chain's final-chunk logits are off: {rel}")
    for req in back:
        tid = str(req.rid)
        roots, _ = tracer.span_tree("minicpm-2b", tid)
        check(tracer.open_spans("minicpm-2b", tid) == []
              and [s.name for s in roots] == ["request", "request"]
              and roots[0].args.get("outcome") == "evacuated"
              and roots[1].args.get("outcome") == "served",
              f"request {req.rid}'s timeline after resubmission: {roots}")
    print(f"phase 10 (c) evacuation after {EVACUATE_AFTER} steps: {state}; "
          f"{len(back)} requests evacuated and resubmitted, StepStats."
          f"evacuated {stats[0].evacuated}, arena {arena.pool_blocks} "
          f"blocks free or idle cached, prefix hits on resubmission "
          f"{rt.prefix_hits - hits0}; chains equal to phase 3's "
          f"{len(same)}/{len(back)}; final-chunk |resubmitted - phase 3| / "
          f"|phase 3| sorted: {sorted(rel.values())} (worst {worst}, "
          f"limit {PARITY_TOL} where a chain differs)")
    del rt
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: threefry sampling, SDF admission with parking, n-way forks
# ---------------------------------------------------------------------------

STOCH_T, STOCH_K = 0.8, 50      # phase 11's stochastic sampler
# random weights put the last token's logit ~200 above the next (tied
# embeddings), so at 0.8 every draw is the argmax; forks and the check
# that sampling changes tokens run at a temperature that flattens that gap
HOT_T = 100.0
SAMPLER_ROWS = 512              # the plan's slots (phase 3's capacity)


def cuda_ms(fn, reps=5):
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_sampler():
    """Phase 11 (a): the port's sampler on the card against the port's own
    CPU sampler, on identical float32 logits (512 rows of minicpm-2b's
    vocabulary, seeds = row ids, offsets = row ids mod 40).  The counter
    keys, the threefry words (int64) and the uniforms of every drawn row
    must be bit-identical; the Gumbel noise is counted where it differs
    (float64 logarithms on both sides); with 32 and with 512 rows live and
    top_k 0 and 50, every row's token must be equal, and a differing row
    is printed with its CPU top-two perturbed-score margin and passes only
    where that margin is within twice the noise difference of its row.
    ``speculative_verify`` at k = 4, greedy and stochastic: tokens and
    n_emit equal.  Times each sampling call on the card (CUDA events)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import sampler as S
    V = get_config("minicpm-2b").vocab_size
    B = SAMPLER_ROWS
    gen = torch.Generator().manual_seed(11)
    logits = torch.randn(B, V, generator=gen) * 4.0
    dlogits = logits.cuda()
    seeds, sids, offs = np.arange(B), np.zeros(B, np.int64), np.arange(B) % 40
    kc, kd = S.prng_key(0), S.prng_key(0, "cuda")
    keys = S.slot_keys(kc, seeds, sids, offs)
    check(torch.equal(keys, S.slot_keys(kd, seeds, sids, offs).cpu()),
          "the counter keys differ on the card")
    live_sets = {32: np.arange(B) % (B // 32) == 0, B: np.ones(B, bool)}
    rec = {"rows": B, "vocab": V}
    for n_live, live in live_sets.items():
        rows = np.flatnonzero(live)
        bits = S.random_bits(keys[rows], (V,))
        dbits = S.random_bits(keys[rows].cuda(), (V,))
        check(torch.equal(bits, dbits.cpu()),
              f"threefry words differ on the card ({n_live} live)")
        u = S.uniform_from_bits(bits, S._TINY)
        check(torch.equal(u.view(torch.int32), S.uniform_from_bits(
            dbits, S._TINY).cpu().view(torch.int32)),
            f"uniforms differ on the card ({n_live} live)")
        g, dg = S.gumbel_from_bits(bits), S.gumbel_from_bits(dbits).cpu()
        noise_diff = (g - dg).abs().amax(dim=-1)
        rec[f"gumbel_differ_{n_live}"] = int((g != dg).sum())
        del bits, dbits, u, dg
        for top_k in (0, STOCH_K):
            cfg = S.SamplerConfig(STOCH_T, top_k)
            mask = torch.from_numpy(live)
            want = S.sample_per_slot(logits, kc, seeds, sids, offs, cfg,
                                     live=mask, fill_token=-1)
            dmask = mask.cuda()
            got = S.sample_per_slot(dlogits, kd, seeds, sids, offs, cfg,
                                    live=dmask, fill_token=-1).cpu()
            differ = torch.nonzero(got != want).flatten().tolist()
            scores = g + S._filtered(logits[rows], cfg)
            top2 = scores.topk(2, dim=-1).values
            margins = (top2[:, 0] - top2[:, 1])
            row_of = {int(r): i for i, r in enumerate(rows)}
            for r in differ:
                i = row_of[r]
                print(f"phase 11 (a) row {r} ({n_live} live, top_k "
                      f"{top_k}): card {int(got[r])} vs CPU {int(want[r])}, "
                      f"CPU top-two margin {float(margins[i])}, noise "
                      f"difference {float(noise_diff[i])}")
                check(float(margins[i]) <= 2 * float(noise_diff[i]),
                      f"row {r}'s token differs beyond a near tie")
            ms = cuda_ms(lambda: S.sample_per_slot(
                dlogits, kd, seeds, sids, offs, cfg, live=dmask))
            rec[f"live{n_live}_k{top_k}"] = {
                "rows_differ": len(differ), "ms": ms,
                "min_margin": float(margins.min())}
        del g
    # speculative_verify at k = 4 over the first 32 rows
    k, Bv = 4, 32
    gen = torch.Generator().manual_seed(12)
    tl = torch.randn(Bv, k + 1, V, generator=gen) * 4.0
    dl = tl[:, :k] + torch.randn(Bv, k, V, generator=gen)
    drafts = dl.argmax(-1)
    flip = torch.rand(Bv, k, generator=gen) < 0.3
    drafts = torch.where(flip, torch.randint(0, V, (Bv, k), generator=gen),
                         drafts)
    for temp in (0.0, STOCH_T):
        cfg = S.SamplerConfig(temp, STOCH_K)
        want = S.speculative_verify(tl, dl, drafts, kc, seeds[:Bv],
                                    sids[:Bv], offs[:Bv], cfg)
        got = S.speculative_verify(tl.cuda(), dl.cuda(), drafts.cuda(), kd,
                                   seeds[:Bv], sids[:Bv], offs[:Bv], cfg)
        check(torch.equal(want[0], got[0].cpu())
              and torch.equal(want[1], got[1].cpu()),
              f"speculative_verify differs on the card (temperature {temp})")
        rec[f"verify_t{temp}_n_emit"] = np.bincount(
            want[1].numpy(), minlength=k + 2).tolist()
    print(f"phase 11 (a) sampler, card vs CPU: keys, threefry words and "
          f"uniforms bit-identical; {json.dumps(rec)}")
    del dlogits
    torch.cuda.empty_cache()
    return rec


def stochastic_wave(temperature, n_requests=32, new_tokens=40):
    """Phase 3's int8 wave at ``temperature``, top_k STOCH_K.  Returns the
    chains, tok/s and the median top-two gap of the final-chunk logits."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.serving.sampler import SamplerConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg, rt = wave_runtime("int8", n_requests, new_tokens,
                           sampler=SamplerConfig(temperature, STOCH_K))
    final = keep_final_logits(rt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    check(len(toks) == n_requests and all(
        len(t) == new_tokens and t.min() >= 0 and t.max() < cfg.vocab_size
        for t in toks.values()), f"stochastic wave served {len(toks)}")
    gaps = [float(v) for v in (torch.stack(list(final.values())).float()
                               .topk(2, dim=-1).values.diff(dim=-1)
                               .neg().flatten())]
    del rt, final
    return toks, sum(map(len, toks.values())) / dt, statistics.median(gaps)


def fork_run(n_requests=4, n_samples=4, new_tokens=40):
    """minicpm-2b at full width (512 slots, int8 KV) serving ``n_requests``
    requests of ``n_samples`` samples each at temperature HOT_T: after
    the step that forks them, each request's siblings share its full
    prompt blocks.  Returns chains by (rid, sample) and the counters."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.serving.engine import GenerationRequest
    from repro_torch.serving.sampler import SamplerConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg, rt = wave_runtime("int8", 0, sampler=SamplerConfig(HOT_T,
                                                            STOCH_K))
    rng = np.random.default_rng(5)
    lens = [45, 90, 137, 190]           # none a multiple of the page
    for rid, n in enumerate(lens[:n_requests]):
        rt.submit(GenerationRequest(
            rid=rid, tokens=rng.integers(0, cfg.vocab_size, n).astype(
                np.int32), max_new_tokens=new_tokens, stream=rid,
            n_samples=n_samples))
    results, shared = [], None
    while rt.pending() or rt.in_flight():
        results.extend(rt.step(max_wait_s=0.0).results)
        if shared is None and rt.forks_spawned == n_requests * (
                n_samples - 1):
            arena, shared = rt.groups[0].arena, {}
            for rid, n in enumerate(lens[:n_requests]):
                rows = [arena._block_tables[s.slot_id][:n // 32].tolist()
                        for s in rt.groups[0].slots if s.req.rid == rid]
                shared[rid] = (len(rows), all(r == rows[0] for r in rows),
                               min(arena.block_ref(b) for b in rows[0]))
    rec = {"forks_spawned": rt.forks_spawned,
           "fork_shortfall": rt.fork_shortfall,
           "prefill_tokens_computed": rt.prefill_tokens_computed,
           "prompt_tokens": sum(lens[:n_requests]),
           "cow_copies": rt.prefix_cow_copies, "shared": shared}
    chains = {(r.rid, r.sample): np.asarray(r.tokens) for r in results}
    del rt
    return chains, rec


def phase_stochastic(phase3_toks, phase3_tok_s):
    """Phase 11 (b): phase 3's int8 wave at temperature 0.8, top_k 50, run
    twice (32/32 served, chains identical across the runs, tokens that
    differ from phase 3's greedy chains counted, the final-chunk logits'
    median top-two gap printed); its first STOCH_SPEC_REQUESTS requests at
    HOT_T, where tokens must differ from the greedy chains (all 32 until
    the script's time limit cut them); then 4 requests of 4 samples at
    HOT_T, twice
    (forks share the prompt blocks, copy-on-write copies counted, sibling
    chains differ, each the same across the runs)."""
    from repro_torch.kernels import paged_attention
    l0 = dict(paged_attention.launches)
    (a, tok_s_a, gap), (b, tok_s_b, _) = (stochastic_wave(STOCH_T)
                                          for _ in range(2))
    check(sorted(a) == sorted(b) and all(np.array_equal(a[r], b[r])
                                         for r in a),
          "the stochastic wave's chains differ between two runs")
    total = sum(len(t) for t in a.values())
    differ = sum(int((a[r] != phase3_toks[r]).sum()) for r in a)
    hot, tok_s_hot, _ = stochastic_wave(HOT_T, STOCH_SPEC_REQUESTS)
    differ_hot = sum(int((hot[r] != phase3_toks[r]).sum()) for r in hot)
    check(differ_hot > 0, f"the wave at temperature {HOT_T} drew phase "
          f"3's greedy chains")
    (fa, rec), (fb, _) = (fork_run() for _ in range(2))
    check(sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k])
                                           for k in fa),
          "a sibling's chain differs between two fork runs")
    check(len(fa) == 16 and rec["forks_spawned"] == 12
          and rec["prefill_tokens_computed"] == rec["prompt_tokens"]
          and rec["cow_copies"] >= 12, f"fork run: {rec}")
    check(rec["shared"] and all(n == 4 and same and ref >= 4
                                for n, same, ref in rec["shared"].values()),
          f"forks do not share their prompt blocks: {rec['shared']}")
    for rid in range(4):
        sib = {tuple(fa[(rid, s)].tolist()) for s in range(4)}
        check(len(sib) == 4, f"request {rid}'s sibling chains coincide")
    grown = {k: paged_attention.launches[k] - l0[k]
             for k in paged_attention.launches}
    print(f"phase 11 (b) stochastic int8 wave (T {STOCH_T}, top_k "
          f"{STOCH_K}), two runs: 32/32 served, chains identical; tok/s "
          f"{tok_s_a}, {tok_s_b} (phase 3 greedy {phase3_tok_s}); "
          f"{differ}/{total} tokens differ from "
          f"phase 3's greedy chains (final-chunk logits' median top-two gap "
          f"{gap}); at T {HOT_T} ({STOCH_SPEC_REQUESTS} requests): "
          f"{differ_hot}/{STOCH_SPEC_REQUESTS * 40} differ, {tok_s_hot} "
          f"tok/s; 4 requests x 4 "
          f"samples at T {HOT_T}, two runs: {rec}, sibling chains distinct "
          f"and repeatable; launches {grown}")
    return {"tok_s": [tok_s_a, tok_s_b], "differ": differ,
            "differ_hot": differ_hot, "gap": gap, "forks": rec,
            "launches": grown}


# phase 11 (c)'s plan: the trace's own (latency category, 2 slots, bf16
# KV by the category unless kv_dtype says otherwise)
GOODPUT_EXPECTED = {"fifo": 4, "sdf": 12, "preemptions": 1}


def phase_goodput():
    """Phase 11 (c): the reference's goodput overload trace
    (``profile_step.goodput_trace``) on minicpm-2b at full width under a
    logical clock, fifo and sdf, greedy (bf16 KV, the trace's plan; the
    trace at temperature 0.8 and with int8 KV, 6-9 s a run, were cut for
    the script's time limit: the CPU tests run the trace on the toy
    config).  sdf's on-time count at least 1.3x fifo's,
    at least one preemption and as many resumes, identical chains for
    every request completed under both policies, every request served or
    verdicted with one verdict, the arenas left with no parked block and
    no live slot; the counts are held beside the CPU test's on the toy
    config."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.allocator import ParallelPlan
    from repro_torch.core.categories import Sensitivity, TaskCategory
    from repro_torch.kernels import paged_attention
    from repro_torch.launch.profile_step import goodput_trace
    from repro_torch.models.registry import model_api
    from repro_torch.serving.engine import ServiceRuntime
    from repro_torch.serving.sampler import SamplerConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("minicpm-2b")
    params = model_api(cfg).init(1, cfg, "cuda")
    plan = ParallelPlan(service="minicpm-2b",
                        category=TaskCategory(Sensitivity.LATENCY, False),
                        bs=2)
    out = {}
    for label, temp, kv in (("greedy bf16", 0.0, -1),):
        runs = {}
        l0 = dict(paged_attention.launches)
        for policy in ("fifo", "sdf"):
            def make():
                return ServiceRuntime(
                    cfg, params, dc.replace(plan, admission=policy,
                                            kv_dtype=kv),
                    sampler=SamplerConfig(temp, 0), device="cuda")
            t0 = time.perf_counter()
            r = goodput_trace(make, cfg.vocab_size)
            r["wall_s"] = time.perf_counter() - t0
            check(r["completed"] + r["rejected"] == r["submitted"]
                  and len(r["reject_verdicts"]) == r["rejected"],
                  f"{label} {policy}: a request left without a verdict")
            check(r["parked_blocks"] == r["live_slots"] == 0,
                  f"{label} {policy}: arena not empty at the end")
            runs[policy] = r
        fifo, sdf = runs["fifo"], runs["sdf"]
        check(sdf["goodput_ontime"] >= 1.3 * fifo["goodput_ontime"],
              f"{label}: sdf on-time {sdf['goodput_ontime']} < 1.3 x fifo "
              f"{fifo['goodput_ontime']}")
        check(sdf["preemptions"] >= 1
              and sdf["resumes"] == sdf["preemptions"],
              f"{label}: preemptions {sdf['preemptions']}, resumes "
              f"{sdf['resumes']}")
        both = set(fifo["tokens"]) & set(sdf["tokens"])
        check(both and all(fifo["tokens"][k] == sdf["tokens"][k]
                           for k in both),
              f"{label}: a chain differs between fifo and sdf")
        grown = {k: paged_attention.launches[k] - l0[k]
                 for k in paged_attention.launches}
        summary = {p: {k: r[k] for k in (
            "goodput_ontime", "completed", "rejected", "submitted",
            "preemptions", "resumes", "arena_parks", "verdicts", "wall_s")}
            for p, r in runs.items()}
        same = (fifo["goodput_ontime"] == GOODPUT_EXPECTED["fifo"]
                and sdf["goodput_ontime"] == GOODPUT_EXPECTED["sdf"]
                and sdf["preemptions"] == GOODPUT_EXPECTED["preemptions"])
        print(f"phase 11 (c) goodput trace, {label}: {json.dumps(summary)}; "
              f"{len(both)} chains identical across policies; counts equal "
              f"the CPU toy trace's {GOODPUT_EXPECTED}: {same}; launches "
              f"{grown}")
        out[label] = {"summary": summary, "same_as_cpu": same,
                      "launches": grown}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_sdf_launcher():
    """Phase 11 (d): the launcher with ``--admission-policy sdf
    --deadline-s 30 --requests 8``: exits 0 and prints its admission
    line."""
    import io
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--archs", "minicpm-2b", "--admission-policy",
                         "sdf", "--deadline-s", "30", "--requests", "8"])
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"sdf launcher exited {rc}")
    check(any(ln.startswith("admission (sdf):")
              for ln in text.splitlines()), "no admission line printed")


def phase_sampling_admission(phase3_toks, phase3_tok_s):
    t0 = time.perf_counter()
    rec = {"sampler": phase_sampler()}
    rec["stochastic"] = phase_stochastic(phase3_toks, phase3_tok_s)
    rec["goodput"] = phase_goodput()
    phase_sdf_launcher()
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 12: speculative decoding on minitron-4b (and mixtral-8x7b)
# ---------------------------------------------------------------------------

SPEC_ARCH = "minitron-4b"
SPEC_K = 4                    # SPECULATE_BY_SENSITIVITY[LATENCY]
DRAFT_LAYERS = 4              # (b)'s small draft: the target's first blocks
# (a)'s live slots: ragged lengths (in, across and at page boundaries), at
# slot ids spread over the 512
VERIFY_LENS = (1, 30, 32, 33, 64, 100, 150, 200)
VERIFY_SLOTS = (0, 63, 64, 130, 255, 300, 411, 511)
MOE_LAYERS = 2                # (e): mixtral-8x7b at full width, 2 of 32
MOE_SPEC_REQUESTS = 16        # (e)'s waves: phase 3's first 16 of 32
STOCH_SPEC_REQUESTS = 8       # (c)'s wave: the first 8 of phase 3's 32
SPEC_WAVE_REQUESTS = 16       # (b)'s plain and self-draft waves


def verify_vs_decode(cfg, params, label):
    """Phase 12 (a): ``verify_step_paged`` (T = SPEC_K + 1, chunk kernel
    #3) against SPEC_K + 1 successive ``decode_step_paged`` calls (#1) fed
    the same tokens, on a copy of the same pools and lengths: 8 live slots
    of VERIFY_LENS tokens (prefilled by one ``prefill_chunk_paged``) at
    VERIFY_SLOTS among 512, the other 504 dead.  Each (slot, position)
    row's logits are held to PARITY_TOL of its norm, and so are the K/V
    rows the two wrote (``check_rows``; both are the ends of two correct
    bf16 chains through every layer, phase 8 (c)'s rule); the verify
    writes nothing outside its slots' rows but the trash page, and returns
    ``len`` unchanged.  Returns the record (its ``max_abs_diff`` is the
    largest logit difference)."""
    import torch
    from repro_torch.models.registry import model_api
    from repro_torch.serving.arena import KVArena
    api = model_api(cfg)
    cap, T, bs = 512, SPEC_K + 1, 32
    lens = np.asarray(VERIFY_LENS)
    sids = list(VERIFY_SLOTS)
    need = sum(-(-(n + T) // bs) for n in lens)
    arena = KVArena(cfg, api.init_cache, capacity=cap, max_seq_len=256,
                    block_size=bs, pool_blocks=need, kv_dtype="bf16",
                    device="cuda")
    for sid, n in zip(sids, lens):
        arena.alloc(int(n) + T, slot=sid)
        arena.reset_len(sid)
    tables = arena.device_block_tables()
    rng = np.random.default_rng(21)
    toks = np.zeros((len(sids), int(lens.max())), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    rows = torch.tensor(sids, device="cuda")
    _, c = api.prefill_chunk_paged(
        params, cfg, {"tokens": torch.from_numpy(toks).cuda()},
        arena.assemble(arena.pages, [], arena.lens[rows]), tables[rows],
        chunk_len=torch.from_numpy(lens.astype(np.int32)).cuda(),
        block_size=bs)
    arena.lens[rows] = c["len"]
    live = torch.zeros(cap, dtype=torch.bool, device="cuda")
    live[rows] = True
    vt = torch.zeros(cap, T, dtype=torch.int64, device="cuda")
    vt[rows] = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (len(sids), T))).cuda()
    pre = [p.clone() for p in arena.pages]
    lens0 = arena.lens.clone()
    dec_pages, dec_lens = [p.clone() for p in pre], lens0.clone()
    logits_v, cv = api.verify_step_paged(
        params, cfg, {"tokens": vt},
        arena.assemble(arena.pages, [], arena.lens), tables,
        chunk_len=torch.where(live, T, 0).to(torch.int32), block_size=bs)
    check(torch.equal(cv["len"], lens0), "verify changed the lengths")
    steps = []
    for j in range(T):
        lg, c = api.decode_step_paged(
            params, cfg, vt[:, j].to(torch.int32),
            {"k": dec_pages[0], "len": dec_lens, "v": dec_pages[1]}, tables,
            live, block_size=bs)
        dec_lens = c["len"]
        steps.append(lg[rows].float())
    torch.cuda.synchronize()
    check(torch.equal(dec_lens, lens0 + live.int() * T),
          "the decode steps' lengths")
    got, want = logits_v[rows].float(), torch.stack(steps, 1)
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite verify or decode logits")
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    rec = {"max_abs_diff": (got - want).abs().max().item(),
           "worst_row_rel_l2": rel,
           "logit_ref_max": want.abs().max().item(),
           "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum()),
           "rows": got.shape[0] * got.shape[1]}
    # the K/V rows each path wrote: positions len..len+T-1 of each slot
    bt = arena.block_tables()
    pos = [(int(bt[s, p // bs]), p % bs) for s, n in zip(sids, lens)
           for p in range(int(n), int(n) + T)]
    blk = torch.tensor([b for b, _ in pos], device="cuda")
    off = torch.tensor([o for _, o in pos], device="cuda")
    for name, vp, dp, p0 in zip("kv", arena.pages, dec_pages, pre):
        rec.update(check_rows(f"{name}_rows", vp[:, blk, off],
                              dp[:, blk, off], rel=PARITY_TOL))
        # the first layer's rows are projections of the embeddings alone
        rec[f"{name}_rows_layer0_max_abs_diff"] = (
            vp[0, blk, off].float() - dp[0, blk, off].float()).abs().max(
            ).item()
        changed = (vp != p0).flatten(3).any(-1).any(0)   # (pages, bs)
        changed[blk, off] = False
        changed[-1] = False                            # the trash page
        check(not bool(changed.any()), f"verify wrote {name} rows outside "
              f"its slots' rows and the trash page")
    check(rel <= PARITY_TOL, f"verify vs decode logits: a row differs by "
          f"{rel} of its norm > {PARITY_TOL}")
    print(f"phase 12 {label} verify_step_paged (T = {T}, #3) vs {T} "
          f"decode_step_paged (#1), {cfg.name} full width, "
          f"{cfg.num_layers} layers, 8 live of 512 slots: "
          f"{json.dumps(rec)}")
    del arena, pre, dec_pages
    return rec


def next_token_gap(cfg, params, tokens, extras=None):
    """The top-two gap of the next-token logits after ``tokens``, computed
    as a decode step computes it: all but the last token as one paged
    chunk (a VLM's with its image prefix, ``extras["embeddings"]``), then
    the last through ``decode_step_paged``, on a bf16 arena of one
    slot."""
    import torch
    from repro_torch.models.registry import model_api
    from repro_torch.serving.arena import KVArena
    api = model_api(cfg)
    n = len(tokens)
    batch = {"tokens": torch.from_numpy(
        np.asarray(tokens[:-1], np.int64)[None]).cuda()}
    if extras is not None and cfg.family == "vlm":
        batch["embeddings"] = torch.from_numpy(
            extras["embeddings"][None]).cuda()
        n += cfg.prefix_len
    arena = KVArena(cfg, api.init_cache, capacity=1, max_seq_len=n + 1,
                    block_size=32, kv_dtype="bf16", device="cuda")
    sid = arena.alloc(n + 1)
    arena.reset_len(sid)
    bt = arena.device_block_tables()
    _, c = api.prefill_chunk_paged(
        params, cfg, batch,
        arena.assemble(arena.pages, arena.state, arena.lens), bt,
        chunk_len=torch.tensor([len(tokens) - 1], dtype=torch.int32,
                               device="cuda"),
        block_size=32)
    lg, _ = api.decode_step_paged(
        params, cfg, torch.tensor([int(tokens[-1])], dtype=torch.int32,
                                  device="cuda"),
        arena.assemble(arena.pages, arena.state, c["len"]), bt,
        torch.ones(1, dtype=torch.bool, device="cuda"), block_size=32)
    top = lg[0].float().topk(2).values
    return (top[0] - top[1]).item()


def router_margins(cfg, params, tokens, rows=SPEC_K + 1):
    """The MoE router's top-k margin at the last ``rows`` tokens of
    ``tokens`` (a verify round's tokens), computed as ``next_token_gap``
    computes the next token: for each token, the smallest over the layers
    of the gap between its k-th and (k+1)-th router logits (f32), in bf16
    steps of the k-th logit (2^(floor(log2 |l_k|) - 7)): under one step, a
    bf16 rounding of the router's input placed otherwise (the verify
    kernel's, not the decode kernel's) can swap the k-th expert.  Returns
    the margins, last token last."""
    import torch
    from repro_torch.models import layers, moe
    per_call, mlp = [], moe.moe_mlp

    def spy(p, c, x, **kw):
        lg = layers.linear(x.float(), p["router"].float())
        top = lg.topk(c.experts_per_token + 1, dim=-1).values
        kth = top[..., -2]
        step = torch.exp2(torch.floor(torch.log2(kth.abs())) - 7)
        per_call.append(((kth - top[..., -1]) / step)[0])
        return mlp(p, c, x, **kw)

    moe.moe_mlp = spy
    try:
        next_token_gap(cfg, params, tokens)
    finally:
        moe.moe_mlp = mlp
    # one call a layer for the head chunk, then one a layer for the token
    L = cfg.num_layers
    head = torch.stack(per_call[:L]).min(0).values[:len(tokens) - 1]
    last = torch.stack(per_call[L:]).min(0).values
    return torch.cat([head, last])[-rows:].tolist()


def chain_splits(cfg, params, plain, spec, prompts=None):
    """Each chain of ``spec`` that differs from ``plain``: its request,
    the first position where they differ, and the plain run's top-two
    logit gap there (``next_token_gap``).  Request ``i``'s prompt is
    ``prompts[i]`` (phase 3's by default) and its extras the wave's."""
    from repro_torch.launch.profile_step import wave_extras, wave_prompts
    if prompts is None:
        prompts = wave_prompts(cfg.vocab_size)
    extras = wave_extras(cfg, len(prompts))
    out = []
    for rid in sorted(plain):
        a, b = plain[rid], spec[rid]
        if np.array_equal(a, b):
            continue
        p = int(np.argmax(a != b))
        out.append({"rid": rid, "pos": p, "gap": next_token_gap(
            cfg, params, np.concatenate([prompts[rid], a[:p]]),
            extras[rid])})
    return out


def spec_wave(label, cfg, params, sampler=None, n_requests=32, **kw):
    """Phase 3's wave (prompts of 6-200 tokens, 40 new), its first
    ``n_requests`` of 32, on ``cfg`` (``params``) at the plan of its full
    config (512 slots, the category's KV and prefix cache), with the
    runtime arguments ``kw`` (a draft, ``speculate``).  Returns
    the chains and the run's record: tok/s, wall, the speculation
    counters, each speculating slot's commits a round (from the rounds
    themselves), launches per kernel, MoE drops and peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.launch.serve import plan_for
    from repro_torch.models import moe
    from repro_torch.serving.engine import GenerationRequest, ServiceRuntime
    from repro_torch.serving.sampler import SamplerConfig
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt = ServiceRuntime(cfg, params, plan_for(get_config(cfg.name)),
                        sampler=sampler or SamplerConfig(), device="cuda",
                        **kw)
    for rid, prompt in enumerate(wave_prompts(cfg.vocab_size)[:n_requests]):
        rt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                    max_new_tokens=40, stream=rid))
    commits = []
    spec_round = rt._spec_round

    def counted_round(state, slots):
        before = [len(s.emitted) for s in slots]
        spec_round(state, slots)
        commits.extend(len(s.emitted) - n for s, n in zip(slots, before)
                       if not s.done)

    rt._spec_round = counted_round
    moe.MOE_DROP_STATS.flush()
    drops0 = moe.MOE_DROP_STATS.dropped
    l0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moe.MOE_DROP_STATS.flush()
    check(len(results) == n_requests,
          f"{label}: served {len(results)}/{n_requests}")
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    for t in toks.values():
        check(len(t) == 40 and t.min() >= 0 and t.max() < cfg.vocab_size,
              f"{label}: token ids out of range")
    n_tok = sum(len(t) for t in toks.values())
    ver = rt.verify_launches
    rec = {"tok_s": n_tok / dt, "wall_s": dt, "decode_steps":
           rt.decode_steps, "prefill_chunks": rt.prefill_chunk_calls,
           "verify_launches": ver, "accepted_tokens": rt.accepted_tokens,
           "accepted_per_launch": rt.accepted_tokens / ver if ver else 0.0,
           "slot_rounds": len(commits),
           "commits_per_slot_round": (float(np.mean(commits)) if commits
                                      else 0.0),
           "commit_hist": np.bincount(commits, minlength=SPEC_K + 2)[
               1:].tolist() if commits else [],
           "draft_steps": rt.draft_steps,
           "draft_prefill_tokens": rt.draft_prefill_tokens,
           "spec_degraded": rt.spec_degraded,
           "moe_dropped_tokens": moe.MOE_DROP_STATS.dropped - drops0,
           "launches": {k: v - l0[k] for k, v in launch_counts().items()
                        if v - l0[k]},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "prefix": prefix_counters(rt)}
    print(f"phase 12 {label} ({n_requests} requests): {json.dumps(rec)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return toks, rec


def draft_view(cfg, params, n):
    """A draft of the target's first ``n`` blocks, embedding, final norm
    and head: views of the target's tensors, no copy."""
    import dataclasses
    from repro_torch.models.transformer import layer_params
    blocks = layer_params(params["blocks"], slice(0, n))
    return dataclasses.replace(cfg, num_layers=n), {
        "embed": params["embed"], "blocks": blocks, "ln_f": params["ln_f"]}


def hold_chains(label, cfg, params, plain, spec, limit):
    """A speculative run's greedy chains against the plain run's: a chain
    may split from the plain one only where the plain run's top-two logit
    gap is below ``limit``, the verify-vs-decode logit difference (a)
    measured (bf16 rounds otherwise in the verify kernel than in the
    decode kernel, and bf16 logits of a 256,000-token vocabulary tie often
    at the top).  Every split is recorded with its gap.  Returns them."""
    splits = chain_splits(cfg, params, plain, spec)
    print(f"phase 12 {label}: {len(plain) - len(splits)}/{len(plain)} chains "
          f"equal the plain run's; splits (first differing position, plain "
          f"top-two gap; "
          f"limit {limit}): {splits}")
    check(all(s["gap"] < limit for s in splits),
          f"{label}: a chain splits from the plain run's where its top-two "
          f"gap is not below {limit}: {splits}")
    return splits


def same_chains(label, a, b):
    """Greedy speculative tokens are the target's: two runs with other
    drafts must give the same chains."""
    same = sum(np.array_equal(a[r], b[r]) for r in a)
    check(sorted(a) == sorted(b) and same == len(a),
          f"{label}: only {same}/{len(a)} chains equal")


def phase_moe_verify():
    """Phase 12 (e): mixtral-8x7b at full width and MOE_LAYERS of its 32
    layers, phase 3's wave greedy, plain and with a self-draft.  At the
    config's capacity factor (1.25; the grouped GEMM at its real shapes)
    each slot's 5 verify rows are one routing group with a capacity of one
    row an expert, so the verify drops assignments that decode (a group a
    token) keeps: the drops and splits are recorded.  At capacity factor
    8 nothing drops: (a) is repeated for mixtral, the splits from the
    plain run's chains are recorded with their gaps (a router's near tie
    can send a token to another expert, which moves a logit by more than
    (a)'s rounding noise), and a 1-layer draft's chains must equal the
    self-draft's."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.models import moe
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("mixtral-8x7b")
    rec = {}
    for cf in (full.moe_capacity_factor, 8.0):
        cfg = dataclasses.replace(full, num_layers=MOE_LAYERS,
                                  moe_capacity_factor=cf)
        params = moe.init(1, cfg, "cuda")
        tag = f"(e) mixtral cf {cf}"
        r = rec[cf] = {}
        if cf != full.moe_capacity_factor:
            r["verify"] = verify_vs_decode(cfg, params, f"{tag} (a)")
        plain, r["plain"] = spec_wave(f"{tag} plain", cfg, params,
                                      n_requests=MOE_SPEC_REQUESTS,
                                      speculate=0)
        spec, r["self_draft"] = spec_wave(
            f"{tag} self-draft", cfg, params, draft_params=params,
            draft_cfg=cfg, n_requests=MOE_SPEC_REQUESTS)
        check(r["self_draft"]["verify_launches"] > 0,
              f"{tag}: no verify launched")
        splits = r["self_draft"]["splits"] = chain_splits(cfg, params,
                                                          plain, spec)
        print(f"phase 12 {tag}: {MOE_SPEC_REQUESTS - len(splits)}/"
              f"{MOE_SPEC_REQUESTS} chains equal the "
              f"plain run's, verify drops "
              f"{r['self_draft']['moe_dropped_tokens']} (plain "
              f"{r['plain']['moe_dropped_tokens']}); splits (first "
              f"differing position, plain top-two gap): {splits}")
        if "verify" in r:
            # each split's router margins over the verify round's tokens
            # before it, in bf16 steps: a margin under one step there is a
            # near tie of the router that the verify may break otherwise
            prompts = wave_prompts(cfg.vocab_size)
            for sp in splits:
                m = router_margins(cfg, params, np.concatenate(
                    [prompts[sp["rid"]], plain[sp["rid"]][:sp["pos"]]]))
                sp["router_margin_steps"] = m
                sp["above_limit"] = sp["gap"] >= r["verify"]["max_abs_diff"]
            margins = [(sp["rid"], sp["pos"], [
                round(x, 3) for x in sp["router_margin_steps"]])
                for sp in splits]
            above = [(sp["rid"], sp["pos"], sp["gap"],
                      min(sp["router_margin_steps"]))
                     for sp in splits if sp["above_limit"]]
            print(f"phase 12 {tag}: router top-{cfg.experts_per_token} "
                  f"margins (bf16 steps of the k-th router logit, the "
                  f"last {SPEC_K + 1} tokens before each split, smallest "
                  f"over {cfg.num_layers} layers): {margins}; splits "
                  f"above the logit limit {r['verify']['max_abs_diff']} "
                  f"(rid, position, gap, smallest margin): {above}")
            check(r["self_draft"]["moe_dropped_tokens"] == 0,
                  f"{tag}: the verify dropped assignments")
            dcfg, dparams = draft_view(cfg, params, 1)
            one, r["draft1"] = spec_wave(
                f"{tag} 1-layer draft", cfg, params, draft_params=dparams,
                draft_cfg=dcfg, n_requests=MOE_SPEC_REQUESTS)
            same_chains(f"{tag} self-draft vs 1-layer draft", spec, one)
            del dparams
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return {str(cf): r for cf, r in rec.items()}


def phase_speculative():
    """Phase 12 (a)-(e): speculative decoding at full width.  Every count
    is zeroed just before it and read just after; returns them."""
    import contextlib as ctx
    import dataclasses
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving.sampler import SamplerConfig
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    cfg = get_config(SPEC_ARCH)
    params = transformer.init(1, cfg, "cuda")
    rec = {"verify": verify_vs_decode(cfg, params, "(a)")}
    limit = rec["verify"]["max_abs_diff"]
    # (b) greedy: plain, self-draft (the same tensors), a 4-layer draft,
    # on the wave's first SPEC_WAVE_REQUESTS requests (all 32 took 55 s:
    # cut for the script's time limit)
    plain, rec["plain"] = spec_wave("(b) plain", cfg, params, speculate=0,
                                    n_requests=SPEC_WAVE_REQUESTS)
    selfd, rec["self_draft"] = spec_wave(
        "(b) self-draft", cfg, params, n_requests=SPEC_WAVE_REQUESTS,
        draft_params=params, draft_cfg=cfg)
    SPEC_CHAINS["self_draft"] = selfd
    # the 4-layer draft on the wave's first STOCH_SPEC_REQUESTS requests
    # (the whole wave took 18.3 s: cut for the script's time limit)
    dcfg, dparams = draft_view(cfg, params, DRAFT_LAYERS)
    small, rec["draft4"] = spec_wave(
        f"(b) {DRAFT_LAYERS}-layer draft", cfg, params,
        n_requests=STOCH_SPEC_REQUESTS, draft_params=dparams, draft_cfg=dcfg)
    for name in ("self_draft", "draft4"):
        r = rec[name]
        check(r["verify_launches"] > 0, f"(b) {name} launched no verify")
        # the target's prefill chunks and verify launches each launch #3
        # once a layer, the draft's catch-up chunks once a draft layer
        n3 = r["launches"].get("paged_chunk_prefill_attention", 0)
        want = (r["prefill_chunks"] + r["verify_launches"]) * cfg.num_layers
        check(n3 >= want, f"(b) {name}: #3 launched {n3} < (prefill chunks "
              f"+ verify launches) x layers = {want}")
    check(rec["self_draft"]["commits_per_slot_round"] >= SPEC_K,
          f"(b) the self-draft commits "
          f"{rec['self_draft']['commits_per_slot_round']} a slot-round")
    check(min(c for c in range(1, SPEC_K + 2)
              if rec["draft4"]["commit_hist"][c - 1]) < SPEC_K + 1,
          "(b) the 4-layer draft never rolled back")
    rec["self_draft"]["splits"] = hold_chains(
        "(b) self-draft", cfg, params, plain, selfd, limit)
    rec["draft4"]["splits"] = hold_chains(
        f"(b) {DRAFT_LAYERS}-layer draft", cfg, params,
        {r: plain[r] for r in small}, small, limit)
    same_chains(f"(b) self-draft vs {DRAFT_LAYERS}-layer draft",
                {r: selfd[r] for r in small}, small)
    rec["seconds_ab"] = time.perf_counter() - t0
    # (c) stochastic, the 4-layer draft, twice, on the wave's first
    # STOCH_SPEC_REQUESTS requests (the script's time limit)
    hot = SamplerConfig(STOCH_T, STOCH_K)
    (a, ra), (b, rb) = (spec_wave(f"(c) T {STOCH_T} run {i}", cfg, params,
                                  sampler=hot, n_requests=STOCH_SPEC_REQUESTS,
                                  draft_params=dparams, draft_cfg=dcfg)
                        for i in (1, 2))
    check(all(np.array_equal(a[r], b[r]) for r in a)
          and ra["verify_launches"] == rb["verify_launches"] > 0,
          "(c) the stochastic speculative runs differ")
    rec["stochastic"] = {"tok_s": [ra["tok_s"], rb["tok_s"]],
                         "verify_launches": ra["verify_launches"],
                         "differ_from_greedy": sum(
                             int((a[r] != small[r]).sum()) for r in a)}
    rec["seconds_abc"] = time.perf_counter() - t0
    del dparams, a, b
    # (d) the launcher
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = io.StringIO()
    with ctx.redirect_stdout(out):
        rc = serve.main(["--archs", "minicpm-2b,minitron-4b",
                         "--draft-arch", SPEC_ARCH])
    text = out.getvalue()
    print(text, end="")
    line = next((ln for ln in text.splitlines()
                 if ln.startswith(f"speculative (draft={SPEC_ARCH})")), "")
    check(rc == 0 and "served 24/24" in text, f"(d) launcher exited {rc}")
    check("note: minicpm-2b incompatible with draft" in text,
          "(d) no non-speculative note for minicpm-2b")
    check(line and int(line.split(":")[1].split()[0]) > 0,
          f"(d) no verify launches: {line!r}")
    rec["seconds_abcd"] = time.perf_counter() - t0
    # (e) MoE verify: mixtral-8x7b at full width, 2 layers, self-draft
    rec["moe"] = phase_moe_verify()
    counts = launch_counts()
    for name in ("paged_decode_attention", "paged_chunk_prefill_attention",
                 "grouped_matmul"):
        check(counts[name] > 0, f"phase 12 never launched {name}")
    rec["launches"] = {k: v for k, v in counts.items() if v}
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 12 record: {json.dumps(rec)}")
    print(f"phase 12: {rec['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 13: the multi-server control plane (placement, handler, ring sync,
# ClusterSupervisor with fault injection and crash failover)
# ---------------------------------------------------------------------------

CLUSTER_LAUNCHER = ["--servers", "2", "--archs", "minicpm-2b",
                    "--chaos-seed", "2", "--requests", "24",
                    "--max-new-tokens", "8"]
CLUSTER_ARCHS = ("minicpm-2b", "minitron-4b")   # frequency int8, latency bf16
CLUSTER_SERVERS = 3
CLUSTER_SLOTS = 128             # plan_for(full, bs=128), as phases 4-5
CLUSTER_REQUESTS = 24           # a service
CLUSTER_NEW = 16               # cut from 24 for the script's limit
CLUSTER_TIMEOUT_S = 4.0
# (at_s, kind, sid, keyword arguments): all five kinds
CLUSTER_FAULTS = ((1.0, "drop_offload", 1, dict(count=2)),
                  (2.0, "straggle", 2, dict(duration_s=6.0, factor=2.0)),
                  (3.0, "corrupt", 1, dict(factor=4.0)),
                  (4.0, "crash", 0, {}),
                  (12.0, "restart", 0, {}))


def launcher_counters(text):
    """The launcher's ``served``, ``admission`` and ``fault tolerance``
    lines with the wall time, tok/s and device taken out: what is left
    counts, on the supervisor's logical clock."""
    import re
    keep = ("served ", "admission (", "fault tolerance:")
    out = []
    for ln in text.splitlines():
        if ln.startswith(keep):
            ln = re.sub(r" in [0-9.]+s \([0-9.]+ tok/s,", "", ln)
            out.append(re.sub(r", device=[a-z0-9:]+", "", ln))
    return out


def phase_cluster_launcher():
    """Phase 13 (a): the launcher on two servers of minicpm-2b at full
    width and the plan's 512 slots, under ``random_fault_spec([0, 1], 20.0,
    seed=2)`` (server 0 crashes at 2.9 mid-burst and restarts at 6.4), and
    the same command on the CPU's reduced config: exit 0 both, a crash
    failover and an evacuation, #2 and #4 launched, every counter of the
    two runs' served, admission and fault tolerance lines equal, and the
    rounds.  Then three servers, which the launcher refuses before it
    allocates anything."""
    import io
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    texts, rcs, walls, reports = {}, {}, {}, {}
    supervisor = serve.ClusterSupervisor

    class Recorded(supervisor):
        """The launcher's supervisor, its report kept for the rounds."""

        def run_until_idle(self, *args, **kwargs):
            reports[dev] = super().run_until_idle(*args, **kwargs)
            return reports[dev]

    l0 = launch_counts()
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        serve.ClusterSupervisor = Recorded
        try:
            with contextlib.redirect_stdout(buf):
                rcs[dev] = serve.main([*CLUSTER_LAUNCHER, "--device", dev])
        finally:
            serve.ClusterSupervisor = supervisor
        walls[dev] = time.perf_counter() - t0
        texts[dev] = buf.getvalue()
        if dev == "cuda":
            peak = (torch.cuda.max_memory_allocated(),
                    torch.cuda.max_memory_reserved())
            grown = {k: v - l0[k] for k, v in launch_counts().items()}
        gc.collect()
        torch.cuda.empty_cache()
    print(texts["cuda"], end="")
    check(rcs == {"cuda": 0, "cpu": 0}, f"(a) the launcher exited {rcs}")
    tol = next((ln for ln in texts["cuda"].splitlines()
                if ln.startswith("fault tolerance:")), "")
    failovers = int(tol.split()[2]) if tol else 0
    evacuated = int(tol.split()[5]) if tol else 0
    check(failovers > 0 and evacuated > 0, f"(a) no failover: {tol!r}")
    check(grown["paged_decode_attention_quant"] > 0
          and grown["paged_chunk_prefill_attention_quant"] > 0,
          f"(a) the int8 kernels did not launch: {grown}")
    card, cpu = launcher_counters(texts["cuda"]), launcher_counters(
        texts["cpu"])
    check(len(card) == 3 and card == cpu
          and reports["cuda"].rounds == reports["cpu"].rounds,
          f"(a) the card's counters differ from the CPU's:\n{card}\n{cpu}")
    args = serve._parser().parse_args(CLUSTER_LAUNCHER)
    weights, arenas = serve.footprint(args)
    rec = {"wall_s": walls["cuda"], "cpu_wall_s": walls["cpu"],
           "rounds": reports["cuda"].rounds, "peak_gb": peak[0] / 1e9,
           "peak_reserved_gb": peak[1] / 1e9,
           "static_gb": (weights + arenas) / 1e9,
           "launches": {k: v for k, v in grown.items() if v}}
    # three servers do not fit with the headroom: refused before anything
    # is allocated, the sum in the message
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    try:
        serve.main(["--servers", "3", "--archs", "minicpm-2b"])
        refusal = ""
    except RuntimeError as e:
        refusal = str(e)
    check(refusal.startswith("the run needs 82.48 GB")
          and "--servers 2 fits" in refusal
          and torch.cuda.memory_allocated() == held,
          f"(a) three servers were not refused before allocating: "
          f"{refusal!r}")
    rec["refusal"] = refusal
    print(f"phase 13 (a) launcher, 2 servers of minicpm-2b, chaos seed 2: "
          f"card and CPU counters equal ({card}); {json.dumps(rec)}")
    return rec


def cluster_run(label, cfgs, params, spec=None):
    """Phase 13 (b)'s cluster: ``CLUSTER_SERVERS`` servers of 4 GPUs under
    the port's ``EdgeCloudControlPlane`` (SSSP placement at demand 4.0),
    a runtime of each service on each server at ``CLUSTER_SLOTS`` slots,
    and ``CLUSTER_REQUESTS`` requests a service (phase 3's prompts of 6-200
    tokens, ``CLUSTER_NEW`` new tokens, entry servers drawn from seed 13)
    through the port's ``ClusterSupervisor`` on its logical clock, under
    ``spec`` if given.  Returns the chains by rid and the run's record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import EdgeCloudControlPlane, ServerSpec
    from repro_torch.core.faults import FaultInjector
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.launch.serve import plan_for, service_spec_for
    from repro_torch.serving.engine import (EparaServingEngine,
                                            GenerationRequest, ServiceRuntime)
    from repro_torch.serving.failover import ClusterSupervisor, RetryPolicy
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    servers = [ServerSpec(sid=i, num_gpus=4) for i in range(CLUSTER_SERVERS)]
    cp = EdgeCloudControlPlane(servers, {
        a: service_spec_for(get_config(a)) for a in CLUSTER_ARCHS})
    cp.run_placement({(a, s.sid): 4.0 for a in CLUSTER_ARCHS
                      for s in servers})
    check(sorted(cp.placements) == sorted(
        (a, s.sid) for a in CLUSTER_ARCHS for s in servers),
        f"{label}: placements {cp.placements}")
    plans = {a: plan_for(get_config(a), bs=CLUSTER_SLOTS)
             for a in CLUSTER_ARCHS}
    engines = {s.sid: EparaServingEngine() for s in servers}
    for svc, sid in cp.placements:
        engines[sid].deploy(svc, ServiceRuntime(
            cfgs[svc], params[svc], plans[svc], device="cuda"))
    cp.publish_all(0.0)
    for _ in servers:
        cp.sync_step(0.0)
    sup = ClusterSupervisor(
        cp, engines, retry=RetryPolicy(base_timeout_s=CLUSTER_TIMEOUT_S),
        injector=FaultInjector(spec) if spec is not None else None)
    prompts = {a: wave_prompts(cfgs[a].vocab_size, CLUSTER_REQUESTS)
               for a in CLUSTER_ARCHS}
    entry = np.random.default_rng(13)
    for i in range(CLUSTER_REQUESTS * len(CLUSTER_ARCHS)):
        svc = CLUSTER_ARCHS[i % len(CLUSTER_ARCHS)]
        sup.submit(svc, GenerationRequest(
            rid=i, tokens=prompts[svc][i // len(CLUSTER_ARCHS)],
            max_new_tokens=CLUSTER_NEW, stream=i),
            at_server=int(entry.integers(0, CLUSTER_SERVERS)), now=0.0)
    l0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = sup.run_until_idle()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = CLUSTER_REQUESTS * len(CLUSTER_ARCHS)
    check(rep.accounted == n and not rep.rejects,
          f"{label}: {rep.accounted}/{n} accounted, rejects "
          f"{[(r.req.rid, r.verdict.value, r.reason) for r in rep.rejects]}")
    toks = {r.rid: np.asarray(r.tokens) for r in rep.results
            if r.sample == 0}
    for rid, t in toks.items():
        vocab = cfgs[CLUSTER_ARCHS[rid % len(CLUSTER_ARCHS)]].vocab_size
        check(len(t) == CLUSTER_NEW and t.min() >= 0 and t.max() < vocab,
              f"{label}: rid {rid}'s tokens out of range")
    steps = {f"{name}@{sid}": rt.decode_steps
             for sid, eng in engines.items()
             for name, rt in eng.runtimes.items()}
    n_tok = sum(len(t) for t in toks.values())
    rec = {"wall_s": dt, "tok_s": n_tok / dt, "rounds": rep.rounds,
           "outcomes": rep.outcomes, "failovers": rep.failovers,
           "evacuated": rep.evacuated, "duplicates": rep.duplicates,
           "dropped_offloads": rep.dropped_offloads,
           "heartbeat_misses": rep.heartbeat_misses,
           "offload_retries": rep.offload_retries,
           "down_at_end": sorted(sup.down), "decode_steps": steps,
           "launches": {k: v - l0[k] for k, v in launch_counts().items()
                        if v - l0[k]},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "static_gb": (sum(t.numel() * t.element_size() for a in params
                             for t in tree_leaves(params[a]))
                         + sum(g.arena.device_bytes()
                               for eng in engines.values()
                               for rt in eng.runtimes.values()
                               for g in rt.groups.values()
                               if g.arena is not None)) / 1e9}
    print(f"phase 13 (b) {label}: {json.dumps(rec)}")
    del sup, engines, cp
    gc.collect()
    torch.cuda.empty_cache()
    return toks, rec


def cluster_splits(cfgs, params, plain, crashed):
    """``chain_splits`` of the crash run's chains against the failure-free
    run's, by service; a split's ``rid`` is its request's index in the
    service's wave."""
    from repro_torch.launch.profile_step import wave_prompts
    k = len(CLUSTER_ARCHS)
    out = {}
    for j, svc in enumerate(CLUSTER_ARCHS):
        ours = range(CLUSTER_REQUESTS)
        out[svc] = chain_splits(
            cfgs[svc], params[svc], {i: plain[i * k + j] for i in ours},
            {i: crashed[i * k + j] for i in ours},
            wave_prompts(cfgs[svc].vocab_size, CLUSTER_REQUESTS))
    return out


def phase_cluster(limit):
    """Phase 13: (a) ``phase_cluster_launcher``; (b) minicpm-2b and
    minitron-4b at full width, 128 slots each, on three servers of the
    port's control plane and supervisor, failure-free and under
    ``CLUSTER_FAULTS``: every rid accounted, no FAILED verdict, failovers,
    evacuations and straggler rounds, server 0 back up, every survivor
    runtime decoding, #1-#4 launched, and every chain that splits from the
    failure-free run's at a top-two gap below ``limit`` (phase 12 (a)'s
    verify-vs-decode logit difference).  Every count is zeroed just before
    it and read just after (printed, not put in the record)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultEvent, FaultSpec
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models.registry import model_api
    t0 = time.perf_counter()
    reset_launches()
    rec = {"launcher": phase_cluster_launcher()}
    cfgs = {a: get_config(a) for a in CLUSTER_ARCHS}
    params = {a: model_api(cfg).init(1, cfg, "cuda")
              for a, cfg in cfgs.items()}
    plain, rec["failure_free"] = cluster_run("failure-free", cfgs, params)
    spec = FaultSpec(events=tuple(
        FaultEvent(at_s=at, kind=kind, sid=sid, **kw)
        for at, kind, sid, kw in CLUSTER_FAULTS))
    crashed, rec["faults"] = cluster_run("under the fault schedule", cfgs,
                                         params, spec)
    r = rec["faults"]
    check(r["evacuated"] > 0 and r["failovers"] > 0
          and r["heartbeat_misses"] > 0 and r["dropped_offloads"] > 0,
          f"(b) the schedule missed: {r}")
    check(r["down_at_end"] == [], f"(b) servers down at the end: {r}")
    survivors = {k: v for k, v in r["decode_steps"].items()
                 if not k.endswith("@0")}
    check(all(v > 0 for v in survivors.values()),
          f"(b) a survivor runtime never decoded: {survivors}")
    counts = launch_counts()
    for name in ("paged_decode_attention", "paged_decode_attention_quant",
                 "paged_chunk_prefill_attention",
                 "paged_chunk_prefill_attention_quant"):
        check(counts[name] > 0, f"phase 13 never launched {name}")
    check(sorted(plain) == sorted(crashed), "(b) the runs served other rids")
    splits = cluster_splits(cfgs, params, plain, crashed)
    rec["splits"] = splits
    print(f"phase 13 (b) chains split from the failure-free run's, by "
          f"service: " + ", ".join(f"{s} {len(v)}/{CLUSTER_REQUESTS}"
                                    for s, v in splits.items())
          + f"; splits (request of the service's wave, first differing "
          f"position, failure-free top-two gap; limit {limit}): {splits}")
    check(all(s["gap"] < limit for v in splits.values() for s in v),
          f"(b) a chain splits where its top-two gap is not below {limit}")
    rec["launches"] = {k: v for k, v in counts.items() if v}
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 13 record: {json.dumps(rec)}")
    print(f"phase 13: {rec['seconds']:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def reset_launches():
    from repro_torch.kernels import ops
    ops.reset_launches()


# ---------------------------------------------------------------------------
# phase 14: the VLM family, paligemma-3b at full width
# ---------------------------------------------------------------------------

def family_wave(phase, label, arch, params, kv_dtype, max_seq_len, slots,
                n_requests=32, **kw):
    """Phase 3's wave (its first ``n_requests`` of 32 requests, prompts of
    6-200 tokens, 40 new) on
    ``arch`` at full width (``wave_runtime``'s extras) with ``kw``, which
    must give ``slots`` slots of ``max_seq_len`` tokens, no prefix cache
    and no draft; every count zeroed just before it and read just after.
    Returns (chains, record)."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch.profile_step import wave_runtime
    torch.cuda.reset_peak_memory_stats()
    cfg, rt = wave_runtime(kv_dtype, n_requests, arch=arch, params=params,
                           **kw)
    check(rt.plan.max_in_flight == slots
          and rt.kv_dtype == kv_dtype and rt.chunked_prefill
          and rt.slot_token_budget == max_seq_len
          and not rt.prefix_cache_enabled and not rt.speculate_k,
          f"{label}: unexpected runtime {rt.plan}")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    check(len(results) == n_requests,
          f"{label}: served {len(results)}/{n_requests}")
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    for t in toks.values():
        check(len(t) == 40 and t.min() >= 0 and t.max() < cfg.vocab_size,
              f"{label}: token ids out of range")
    n_tok = sum(len(t) for t in toks.values())
    static = (sum(t.numel() * t.element_size() for t in tree_leaves(params))
              + sum(g.arena.device_bytes() for g in rt.groups.values()
                    if g.arena is not None))
    rec = {"tok_s": n_tok / dt, "wall_s": dt, "slots": rt.plan.max_in_flight,
           "decode_steps": rt.decode_steps,
           "prefill_chunks": rt.prefill_chunk_calls,
           "chunk_write_bytes": rt.chunk_write_bytes,
           "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "static_gb": static / 1e9}
    print(f"{phase} {label}: {json.dumps(rec)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return toks, rec


def sync_vs_paged_logits(cfg, params, max_seq_len=VLM_MAX_SEQ):
    """Request 0 of the wave (its prompt, and a VLM's image embeddings):
    the next-token logits of the family's one-shot ``prefill`` (the sync
    path's: flash attention, with a VLM's prefix) and of one paged chunk
    of the whole prompt (``prefill_chunk_paged``) on a bf16 arena of one
    slot, both f32 (V,)."""
    import torch
    from repro_torch.launch.profile_step import wave_extras, wave_prompts
    from repro_torch.models.registry import model_api
    from repro_torch.serving.arena import KVArena
    api = model_api(cfg)
    prompt = wave_prompts(cfg.vocab_size, 1)[0]
    batch = {"tokens": torch.from_numpy(prompt.astype(np.int64)[None]).cuda()}
    if cfg.family == "vlm":
        batch["embeddings"] = torch.from_numpy(
            wave_extras(cfg, 1)[0]["embeddings"][None]).cuda()
    lg_s, _ = api.prefill(params, cfg, batch)
    arena = KVArena(cfg, api.init_cache, capacity=1, max_seq_len=max_seq_len,
                    block_size=32, kv_dtype="bf16", device="cuda")
    arena.reset_len(arena.alloc(max_seq_len))
    lg_p, _ = api.prefill_chunk_paged(
        params, cfg, batch,
        arena.assemble(arena.pages, arena.state, arena.lens),
        arena.device_block_tables(),
        chunk_len=torch.tensor([len(prompt)], dtype=torch.int32,
                               device="cuda"), block_size=32)
    return lg_s[0].float(), lg_p[0].float()


def phase_vlm():
    """Phase 14: paligemma-3b at full width (18 layers, 8 query heads on 1
    kv head at D = 256, 257,216-token vocabulary), random weights from
    seed 1 and random-normal image embeddings from seed 1: (a) the native
    vs dense-view logits of a first chunk with its 256-row prefix, two
    text chunks and three decode steps, held as phase 8 (c) holds them;
    (b) the greedy wave at the plan's 512 slots in bf16 (#1, #3 at D =
    256) and int8 (#2, #4) KV, and the dense-view oracle (#6, #5), also at
    512 slots (so that only the attention kernels differ): the bf16 chains
    equal the oracle's or split where the oracle's top-two gap is below
    (a)'s largest logit difference (phase 12's rule); (c) one request
    through the sync path (its one-shot prefill runs #7 with the prefix):
    its first token is the argmax of ``vlm.prefill``'s logits, which agree
    with one paged chunk's (#3) over the same prompt to PARITY_TOL of
    their norm, and the two first tokens are equal or split where the
    paged top-two gap is below the logits' largest difference; (d) the
    launcher ``--archs paligemma-3b --max-seq-len 512 --requests 8``.
    Returns the D = 256 launches of the kernels by name."""
    import contextlib as ctx
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import serve
    from repro_torch.launch.profile_step import wave_extras, wave_runtime
    from repro_torch.models import vlm
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(VLM_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.vocab_size, cfg.prefix_len)
          == (18, 2048, 8, 1, 256, 257216, 256), f"not full width: {cfg}")
    params = vlm.init(1, cfg, "cuda")
    rec = {}
    # (a) the first chunk carries request 0's image embeddings
    emb = torch.from_numpy(
        wave_extras(cfg, 1)[0]["embeddings"][None]).cuda()
    report = hold_logits_parity("phase 14 (a)", cfg, params, embeddings=emb,
                                max_seq_len=VLM_MAX_SEQ)
    limit = max(r["max_abs_diff"] for r in report)
    rec["parity"] = {"max_abs_diff": limit,
                     "max_rel_l2": max(r["rel_l2"] for r in report)}
    # (b) the waves
    launches = {}
    wave = lambda label, kv, **kw: family_wave(
        "phase 14", label, VLM_ARCH, params, kv, VLM_MAX_SEQ, 512, **kw)
    bf16, rec["bf16"] = wave("(b) bf16 KV, 512 slots", "bf16")
    FAMILY_CHAINS[VLM_ARCH] = bf16
    int8, rec["int8"] = wave("(b) int8 KV, 512 slots", "int8")
    oracle, rec["oracle"] = wave("(b) dense-view oracle, bf16 KV, 512 "
                                 "slots", "bf16", paged_native=False)
    for name, r in (("bf16", rec["bf16"]), ("int8", rec["int8"]),
                    ("oracle", rec["oracle"])):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for name in ("paged_decode_attention", "paged_chunk_prefill_attention"):
        check(rec["bf16"]["launches"].get(name, 0) > 0,
              f"the bf16 wave did not launch {name}")
        check(rec["int8"]["launches"].get(name + "_quant", 0) > 0,
              f"the int8 wave did not launch {name}_quant")
    for name in ("chunk_prefill_attention", "decode_attention"):
        check(rec["oracle"]["launches"].get(name, 0) > 0,
              f"the oracle wave did not launch {name}")
    check(not any(k.startswith("paged") for k in rec["oracle"]["launches"]),
          f"the oracle launched a paged kernel: {rec['oracle']['launches']}")
    splits = chain_splits(cfg, params, oracle, bf16)
    rec["bf16"]["splits"] = splits
    same = sum(int((int8[r] == bf16[r]).sum()) for r in bf16)
    print(f"phase 14 (b) bf16 vs the dense-view oracle: "
          f"{32 - len(splits)}/32 chains equal; splits (first differing "
          f"position, oracle top-two gap; limit {limit}): {splits}; int8 vs "
          f"bf16: {same}/{32 * 40} positions agree")
    check(all(sp["gap"] < limit for sp in splits),
          f"(b) a bf16 chain splits from the oracle's where its top-two gap "
          f"is not below {limit}: {splits}")
    # (c) one request through the sync path: one-shot prefill (flash
    # attention with the prefix)
    gc.collect()
    torch.cuda.empty_cache()
    _, rt = wave_runtime("bf16", n_requests=1, new_tokens=1, arch=VLM_ARCH,
                         params=params, mode="sync")
    reset_launches()
    sync = int(np.asarray(rt.drain()[0].tokens)[0])
    torch.cuda.synchronize()
    grown = {k: v for k, v in launch_counts().items() if v}
    for k, v in grown.items():
        launches[k] = launches.get(k, 0) + v
    check(grown.get("flash_attention", 0) == cfg.num_layers,
          f"(c) the sync prefill launched {grown}")
    del rt
    lg_s, lg_p = sync_vs_paged_logits(cfg, params)
    diff = (lg_s - lg_p).abs().max().item()
    top = lg_p.topk(2).values
    rec["sync"] = {"token": sync, "prefill_argmax": int(lg_s.argmax()),
                   "paged_argmax": int(lg_p.argmax()),
                   "wave_first_token": int(bf16[0][0]),
                   "max_abs_diff": diff,
                   "rel_l2": ((lg_s - lg_p).norm() / lg_p.norm()).item(),
                   "paged_gap": (top[0] - top[1]).item(), "launches": grown}
    print(f"phase 14 (c) the sync path's first token vs one paged chunk's: "
          f"{json.dumps(rec['sync'])}")
    check(sync == rec["sync"]["prefill_argmax"],
          "(c) the sync runtime's first token is not its prefill's argmax")
    check(rec["sync"]["rel_l2"] <= PARITY_TOL,
          f"(c) one-shot vs paged chunk logits: {rec['sync']}")
    check(sync == rec["sync"]["paged_argmax"]
          or rec["sync"]["paged_gap"] < diff,
          f"(c) the first tokens differ where the paged top-two gap is not "
          f"below the logits' difference: {rec['sync']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the launcher
    reset_launches()
    out = io.StringIO()
    with ctx.redirect_stdout(out):
        rc = serve.main(["--archs", VLM_ARCH, "--max-seq-len",
                         str(VLM_MAX_SEQ), "--requests", "8"])
    text = out.getvalue()
    print(text, end="")
    check(rc == 0 and "served 8/8" in text, f"(d) launcher exited {rc}")
    for k, v in launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    rec["launches"] = {k: v for k, v in launches.items() if v}
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 14 record: {json.dumps(rec)}")
    print(f"phase 14: {rec['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rec["launches"]


# ---------------------------------------------------------------------------
# phase 15: the hybrid family, zamba2-7b at full width
# ---------------------------------------------------------------------------

def replay_chains(cfg, params, chains, max_seq_len=HYBRID_MAX_SEQ):
    """Phase 15 (b)'s teacher-forced replay: each request of the wave in a
    slot of its own (as many slots as ``chains``, in rid order) of two bf16
    arenas, its prompt as one chunk through ``prefill_chunk_paged`` and
    through ``prefill_chunk`` on the arena's dense view, then every
    position of ``chains`` (the oracle's tokens) fed to both through
    ``decode_step_paged`` and ``decode_step`` on the dense view, all slots
    a step.  Both paths see the same history at every position, so their
    logits differ only by the kernels' rounding.  Returns (the chunk
    steps' logits identical for every request, and per decode position
    (32,) tensors of rel_l2, max |diff|, the dense view's top-two gap and
    whether the argmaxes differ)."""
    import torch
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.models.registry import model_api
    from repro_torch.serving.arena import KVArena
    api = model_api(cfg)
    B = len(chains)
    prompts = wave_prompts(cfg.vocab_size, B)
    arenas = [KVArena(cfg, api.init_cache, capacity=B,
                      max_seq_len=max_seq_len, block_size=32,
                      kv_dtype="bf16", device="cuda") for _ in range(2)]
    for a in arenas:
        for _ in range(B):
            a.reset_len(a.alloc(max_seq_len))
    native, dense = arenas
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    same = True
    for sid in range(B):
        toks = prompts[sid].astype(np.int64)[None]
        batch = {"tokens": torch.from_numpy(toks).cuda()}
        cl = torch.tensor([toks.shape[1]], dtype=torch.int32, device="cuda")
        bt = native.device_block_tables()[sid:sid + 1]
        lg_n, nc = api.prefill_chunk_paged(
            params, cfg, batch, native.assemble(
                native.pages, native.slot_state(sid),
                native.lens[sid:sid + 1]),
            bt, chunk_len=cl, block_size=32)
        native.lens[sid] = nc["len"][0]
        bt = dense.device_block_tables()[sid:sid + 1]
        st = dense.lens[sid:sid + 1]
        view = dense.dense_view(dense.pages, bt)
        lg_d, dc = api.prefill_chunk(
            params, cfg, batch,
            dense.assemble(view, dense.slot_state(sid), st), chunk_len=cl)
        dense.append_rows(dense.pages, dense.disassemble(dc)[0], st, one,
                          bt, n_tokens=toks.shape[1],
                          valid_tokens=dc["len"] - st)
        dense.lens[sid] = dc["len"][0]
        same = same and torch.equal(lg_n, lg_d)
    live = torch.ones(B, dtype=torch.bool, device="cuda")
    tables_n, tables_d = (native.device_block_tables(),
                          dense.device_block_tables())
    rows = []
    for j in range(min(len(c) for c in chains.values()) - 1):
        tok = torch.tensor([int(chains[r][j]) for r in sorted(chains)],
                           dtype=torch.int32, device="cuda")
        lg_n, nc = api.decode_step_paged(
            params, cfg, tok, native.assemble(native.pages, native.state,
                                              native.lens),
            tables_n, live, block_size=32)
        native.lens = nc["len"]
        view = dense.dense_view(dense.pages, tables_d)
        lg_d, dc = api.decode_step(
            params, cfg, tok, dense.assemble(view, dense.state, dense.lens),
            live=live)
        dense.append_rows(dense.pages, dense.disassemble(dc)[0], dense.lens,
                          live, tables_d)
        dense.lens = dc["len"]
        a, b = lg_n.float(), lg_d.float()
        top = b.topk(2, dim=1).values
        rows.append({"rel_l2": ((a - b).norm(dim=1) / b.norm(dim=1)).cpu(),
                     "max_abs_diff": (a - b).abs().amax(dim=1).cpu(),
                     "gap": (top[:, 0] - top[:, 1]).cpu(),
                     "flip": (a.argmax(dim=1) != b.argmax(dim=1)).cpu()})
    del arenas, native, dense
    gc.collect()
    torch.cuda.empty_cache()
    return same, rows


def phase_hybrid():
    """Phase 15: zamba2-7b at full width (81 Mamba-2 layers, d_model 3584,
    112 SSM heads of P = 64, N = 64; one shared attention+MLP block over
    concat(h, h0) after every 6 layers, 13 applications of 32/32 heads at
    D = 112, then 3 tail layers; 32,000-token vocabulary), random weights
    from seed 1, 256-token slots: (a) phase 8 (c)'s native vs dense-view
    logits over three chunks and three decode steps, to
    HYBRID_PARITY_TOL of their norm; (b) phase 3's wave in int8 KV at the
    plan's 256 slots (#2, #4 and the SSD scan #10), then in bf16 KV (#1,
    #3) and through the dense-view oracle (#6, #5), both at 128 slots (the
    oracle's gathered view does not fit beside a 256-slot bf16 arena) and
    on the wave's first 16 requests (the time limit):
    every bf16 first token equals the oracle's (the prefill chunks run one
    body), and ``replay_chains`` feeds the oracle's chains to both paths,
    whose logits must agree to HYBRID_PARITY_TOL at every position; the
    chains' splits are printed with the replay's top-two gap there
    (random weights make this chain part at near ties within a few steps,
    so phase 12's gap rule is printed, not held), and so are int8 vs bf16
    positions; (c) one request through the sync path (its
    one-shot prefill runs #7 and the SSD scan): its first token is its
    prefill's argmax, whose logits agree with one paged chunk's (#3) over
    the same prompt to HYBRID_PARITY_TOL of their norm, the two first
    tokens equal or split where the paged top-two gap is below the logits'
    difference; (d) the launcher ``--archs zamba2-7b`` at its defaults.
    Returns the launches of the kernels by name."""
    import contextlib as ctx
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import serve
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.models import hybrid
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(HYBRID_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
           cfg.attn_every, cfg.vocab_size)
          == (81, 3584, 32, 32, 112, 112, 64, 64, 6, 32000),
          f"not full width: {cfg}")
    params = hybrid.init(1, cfg, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"init_s": time.perf_counter() - t0}
    # (a)
    report = hold_logits_parity("phase 15 (a)", cfg, params,
                                max_seq_len=HYBRID_MAX_SEQ,
                                limit=HYBRID_PARITY_TOL)
    limit = max(r["max_abs_diff"] for r in report)
    rec["parity"] = {"max_abs_diff": limit,
                     "max_rel_l2": max(r["rel_l2"] for r in report)}
    # (b) the waves
    launches = {}
    int8, rec["int8"] = family_wave(
        "phase 15", "(b) int8 KV, the plan's 256 slots", HYBRID_ARCH, params,
        "int8", HYBRID_MAX_SEQ, 256, n_requests=HYBRID_PAIR_REQUESTS)
    FAMILY_CHAINS[HYBRID_ARCH] = int8
    # bf16 and the oracle on the wave's first HYBRID_PAIR_REQUESTS (all 32
    # took 20 s more: cut for the script's time limit)
    bf16, rec["bf16"] = family_wave(
        "phase 15", "(b) bf16 KV, 128 slots", HYBRID_ARCH, params, "bf16",
        HYBRID_MAX_SEQ, 128, n_requests=HYBRID_PAIR_REQUESTS, bs=128)
    oracle, rec["oracle"] = family_wave(
        "phase 15", "(b) dense-view oracle, bf16 KV, 128 slots", HYBRID_ARCH,
        params, "bf16", HYBRID_MAX_SEQ, 128, n_requests=HYBRID_PAIR_REQUESTS,
        bs=128, paged_native=False)
    for r in (rec["int8"], rec["bf16"], rec["oracle"]):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for name in ("paged_decode_attention_quant",
                 "paged_chunk_prefill_attention_quant", "ssd_scan"):
        check(rec["int8"]["launches"].get(name, 0) > 0,
              f"the int8 wave did not launch {name}")
    for name in ("paged_decode_attention", "paged_chunk_prefill_attention"):
        check(rec["bf16"]["launches"].get(name, 0) > 0,
              f"the bf16 wave did not launch {name}")
    for name in ("chunk_prefill_attention", "decode_attention"):
        check(rec["oracle"]["launches"].get(name, 0) > 0,
              f"the oracle wave did not launch {name}")
    check(not any(k.startswith("paged") for k in rec["oracle"]["launches"]),
          f"the oracle launched a paged kernel: {rec['oracle']['launches']}")
    # every first token comes from the prefill chunks, which the two
    # paths run on one body (chunk_tiles.cuh) and one SSD scan
    check(all(oracle[r][0] == bf16[r][0] for r in oracle),
          "(b) a first token differs between the native and oracle waves")
    chunk_same, rows = replay_chains(cfg, params, oracle)
    rel = torch.stack([r["rel_l2"] for r in rows])       # (39, requests)
    mad = torch.stack([r["max_abs_diff"] for r in rows])
    flips = torch.stack([r["flip"] for r in rows])
    gaps = torch.stack([r["gap"] for r in rows])
    replay_limit = mad.max().item()
    # each split: the first position where the native chain leaves the
    # oracle's, with the replay's oracle top-two gap and |diff| there
    # (decode position p - 1 gives the logits of position p)
    splits = []
    for rid in sorted(oracle):
        a, b = oracle[rid], bf16[rid]
        if not np.array_equal(a, b):
            p = int(np.argmax(a != b))
            splits.append({"rid": rid, "pos": p,
                           "gap": gaps[p - 1, rid].item(),
                           "max_abs_diff": mad[p - 1, rid].item()})
    rec["bf16"]["splits"] = splits
    same = sum(int((int8[r] == bf16[r]).sum()) for r in bf16)
    rec["int8_vs_bf16_positions"] = same
    rec["replay"] = {
        "chunk_logits_identical": chunk_same,
        "max_rel_l2": rel.max().item(),
        "median_rel_l2": rel.median().item(),
        "rel_l2_by_position": [round(x, 5) for x in rel.amax(1).tolist()],
        "max_abs_diff": replay_limit,
        "argmax_flips": int(flips.sum()),
        "flip_gaps": gaps[flips].tolist(),
        "splits_within_replay_limit": sum(sp["gap"] < replay_limit
                                          for sp in splits),
        "splits": len(splits)}
    print(f"phase 15 (b) bf16 vs the dense-view oracle: "
          f"{len(oracle) - len(splits)}/{len(oracle)} chains equal; splits "
          f"(first differing position, top-two gap): {splits}; int8 vs "
          f"bf16: {same}/{len(bf16) * 40} positions agree")
    print(f"phase 15 (b) teacher-forced replay of the oracle's chains "
          f"(both paths fed the same tokens at every position, limit "
          f"{HYBRID_PARITY_TOL} of the norm): {json.dumps(rec['replay'])}")
    check(chunk_same, "(b) replay: the chunk steps' logits differ between "
          "the paths")
    check(rec["replay"]["max_rel_l2"] <= HYBRID_PARITY_TOL,
          f"(b) replay: native vs dense-view logits differ by "
          f"{rec['replay']['max_rel_l2']} of their norm > "
          f"{HYBRID_PARITY_TOL}")
    # (c) one request through the sync path
    gc.collect()
    torch.cuda.empty_cache()
    _, rt = wave_runtime("bf16", n_requests=1, new_tokens=1,
                         arch=HYBRID_ARCH, params=params, mode="sync")
    reset_launches()
    sync = int(np.asarray(rt.drain()[0].tokens)[0])
    torch.cuda.synchronize()
    grown = {k: v for k, v in launch_counts().items() if v}
    for k, v in grown.items():
        launches[k] = launches.get(k, 0) + v
    check(grown.get("flash_attention", 0) == attention_layers(cfg)
          and grown.get("ssd_scan", 0) == cfg.num_layers,
          f"(c) the sync prefill launched {grown}")
    del rt
    lg_s, lg_p = sync_vs_paged_logits(cfg, params, HYBRID_MAX_SEQ)
    diff = (lg_s - lg_p).abs().max().item()
    top = lg_p.topk(2).values
    rec["sync"] = {"token": sync, "prefill_argmax": int(lg_s.argmax()),
                   "paged_argmax": int(lg_p.argmax()),
                   "wave_first_token": int(bf16[0][0]),
                   "max_abs_diff": diff,
                   "rel_l2": ((lg_s - lg_p).norm() / lg_p.norm()).item(),
                   "paged_gap": (top[0] - top[1]).item(), "launches": grown}
    print(f"phase 15 (c) the sync path's first token vs one paged chunk's: "
          f"{json.dumps(rec['sync'])}")
    check(sync == rec["sync"]["prefill_argmax"],
          "(c) the sync runtime's first token is not its prefill's argmax")
    check(rec["sync"]["rel_l2"] <= HYBRID_PARITY_TOL,
          f"(c) one-shot vs paged chunk logits: {rec['sync']}")
    check(sync == rec["sync"]["paged_argmax"]
          or rec["sync"]["paged_gap"] < diff,
          f"(c) the first tokens differ where the paged top-two gap is not "
          f"below the logits' difference: {rec['sync']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the launcher at its defaults
    reset_launches()
    out = io.StringIO()
    t1 = time.perf_counter()
    with ctx.redirect_stdout(out):
        rc = serve.main(["--archs", HYBRID_ARCH])
    text = out.getvalue()
    print(text, end="")
    rec["launcher_s"] = time.perf_counter() - t1
    check(rc == 0 and "served 24/24" in text, f"(d) launcher exited {rc}")
    for k, v in launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    rec["launches"] = {k: v for k, v in launches.items() if v}
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 15 record: {json.dumps(rec)}")
    print(f"phase 15: {rec['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rec["launches"]


def phase_train(steps=4):
    """Phase 7: minicpm-2b's training path at full width through the
    launcher's ``run``; every launch count is zeroed just before it and
    read just after.  Returns the counts."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import train
    argv = ["--arch", "minicpm-2b", "--batch", "2", "--seq", "4096",
            "--microbatches", "2", "--lr", TRAIN_LR, "--log-every", "1"]
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    result = train.run(argv + ["--steps", str(steps)])
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, norms = result["losses"], result["grad_norms"]
    check(len(losses) == steps and all(np.isfinite(losses))
          and all(np.isfinite(norms)),
          f"non-finite training losses or grad norms: {losses} {norms}")
    check(losses[-1] < losses[0],
          f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    from repro_torch.configs import get_config
    for i, grown in enumerate(result["launches"]):
        want = dict.fromkeys(grown, 0)
        want.update(train_launches(get_config("minicpm-2b"), 2))
        check(grown == want, f"training step {i} launched {grown}")
    tokens = 2 * 4096
    print(f"phase 7 (minicpm-2b training, 40 layers, bf16, AdamW lr "
          f"{TRAIN_LR}, 2 x 4096 tokens in 2 microbatches): losses "
          f"{losses}, grad norms {norms}, step wall (s) {result['step_s']}, "
          f"tok/s {[tokens / s for s in result['step_s']]}, launches a step "
          f"{result['launches'][-1]}, {dt:.3f} s in all, memory (GB) "
          f"before {mem0 / 1e9:.2f}, peak {peak / 1e9:.2f}")
    # (the profiled second step of a fresh trainer was cut for the
    # script's time limit: ``profile_step --train`` with these flags runs
    # it)
    del result
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 16: training of the five other families at full width
# ---------------------------------------------------------------------------

# (arch, batch, sequence, microbatches, optimizer, layers or None, stub
# embeddings): 2 x 4096 tokens, as phase 7; whisper's 448-token text
# context over its 1500 zero frames (the reference's stub); paligemma's
# train_4k (256 image rows + 3840 text tokens), its image rows normal
# draws (zero rows stay zero through its 18 layers, and each RMSNorm's
# backward at a zero row scales the gradient by 1/sqrt(eps): it overflows
# to NaN, in the reference too); zamba2 with Adafactor (AdamW's state and
# the weights take 81.5 GB); mixtral at 2 of 32 layers (its 32 layers'
# bf16 weights take 93.4 GB)
TRAIN_FAMILIES = (("mamba2-2.7b", 2, 4096, 2, "adamw", None, "zeros"),
                  ("whisper-large-v3", 2, 448, 1, "adamw", None, "zeros"),
                  ("paligemma-3b", 2, 3840, 2, "adamw", None, "normal"),
                  ("zamba2-7b", 2, 4096, 2, "adafactor", None, "zeros"),
                  ("mixtral-8x7b", 2, 4096, 2, "adamw", 2, "zeros"))


def train_launches(cfg, k):
    """Each kernel's launches in a train step of ``k`` microbatches, as the
    training forward's code gives them (the kernels not named: none).  A
    microbatch runs a checkpointed layer's kernels twice (the forward and
    the backward's recompute) and the flash backward once an attention;
    whisper's encoder and zamba2's shared block are not checkpointed; a
    grouped GEMM launches twice more in the backward (dX and dW); the SSD
    scan's backward is a plain recompute."""
    L = cfg.num_layers
    fwd = bwd = ssd = gmm = 0
    if cfg.family in ("dense", "vlm"):
        fwd, bwd = 2 * L, L
    elif cfg.family == "moe":
        fwd, bwd, gmm = 2 * L, L, L * (3 * 2 + 3 * 2)
    elif cfg.family == "ssm":
        ssd = 2 * L
    elif cfg.family == "audio":
        fwd = cfg.encoder_layers + 2 * 2 * L
        bwd = cfg.encoder_layers + 2 * L
    elif cfg.family == "hybrid":
        apps = L // cfg.attn_every
        fwd, bwd, ssd = apps, apps, 2 * L
    counts = {"flash_attention": fwd, "flash_attention_bwd": bwd,
              "ssd_scan": ssd, "grouped_matmul": gmm}
    return {n: k * c for n, c in counts.items() if c}


def phase_train_families(steps=4):
    """Phase 16: each of ``TRAIN_FAMILIES`` trains for ``steps`` steps at
    lr ``TRAIN_LR`` through the launcher's ``run`` (random weights from
    seed 0, bf16): losses and grad norms finite, the last loss below the
    first, every step's launches equal to ``train_launches``, the grouped
    GEMM's all on the TMA route; peak memory beside the static size (the
    weights and the optimizer state) and each step's wall printed.  Every
    count is zeroed just before each family and read just after it.
    Returns the counts summed over the families."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import train
    t0 = time.perf_counter()
    total = {}
    for arch, B, L, k, opt, layers, stub in TRAIN_FAMILIES:
        argv = ["--arch", arch, "--batch", str(B), "--seq", str(L),
                "--microbatches", str(k), "--optimizer", opt, "--lr",
                TRAIN_LR, "--log-every", str(steps), "--steps", str(steps),
                "--stub-embeddings", stub]
        cfg = get_config(arch)
        if layers:
            argv += ["--layers", str(layers)]
            cfg = dataclasses.replace(cfg, num_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        reset_launches()
        t = time.perf_counter()
        result = train.run(argv)
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        counts = launch_counts()
        losses, norms = result["losses"], result["grad_norms"]
        check(len(losses) == steps and np.isfinite(losses).all()
              and np.isfinite(norms).all(),
              f"{arch}: non-finite training losses or grad norms: {losses} "
              f"{norms}")
        check(losses[-1] < losses[0],
              f"{arch}: the loss did not fall: {losses[0]} -> {losses[-1]}")
        want = dict.fromkeys(counts, 0)
        want.update(train_launches(cfg, k))
        for i, grown in enumerate(result["launches"]):
            check(grown == want, f"{arch}: training step {i} launched "
                  f"{grown}, not {want}")
        routes = dict(grouped_matmul.route_launches)
        check(routes["mma_sync"] == 0,
              f"{arch}: a grouped GEMM left the TMA route: {routes}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        tokens = B * (L + cfg.prefix_len)
        print(f"phase 16 {arch} ({cfg.num_layers} layers, bf16, {opt} lr "
              f"{TRAIN_LR}, {B} x {L} tokens in {k} microbatch(es)): losses "
              f"{losses}, grad norms {norms}, step wall (s) "
              f"{result['step_s']}, tok/s "
              f"{[tokens / x for x in result['step_s']]}, launches a step "
              f"{result['launches'][-1]}, grouped GEMM routes {routes}, "
              f"{wall:.3f} s in all, memory (GB) before {mem0 / 1e9:.2f}, "
              f"static {result['static_bytes'][0] / 1e9:.2f}, peak "
              f"{peak / 1e9:.2f}")
        del result
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 16 launches: {total}")
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 17: head-sharded paged serving (--pjit-decode)
# ---------------------------------------------------------------------------

TP_REQUESTS = 16               # phase 3's first 16 requests
TP_NEW_TOKENS = 40
TP_CODEQWEN_REQUESTS = 8
TP_CODEQWEN_BS = 32            # bf16 K/V of 32 slots: 4.3 GB
TP_WITNESS_BS = 64             # the witness's waves: rows see no other slot
# kernels #1-#4 at the shards' shapes: minicpm-2b's 36 heads over 4 and
# over 2 shards, and mistral-large-123b's 96 query heads on 8 kv heads
# over 4 (its G = 12 takes the D = 128, R = 16 decode instance)
TP_KERNEL_SHAPES = {"minicpm_tp4": dict(Hq=9, Hkv=9, D=64),
                    "minicpm_tp2": dict(Hq=18, Hkv=18, D=64),
                    "mistral_large_tp4": dict(Hq=24, Hkv=2, D=128)}


def tp_mesh(devices):
    from repro_torch.launch import mesh as meshlib
    return meshlib.make_mesh((1, len(devices)), ("data", "model"), devices)


def tp_wave(arch, kv_dtype, n_requests, devices=None, bs=None, params=None):
    """Phase 3's first ``n_requests`` requests of ``arch`` at full width,
    unsharded (``devices`` None) or over the service mesh of ``devices``
    (the launcher's builder); every fused decode step's live rows' logits,
    fed tokens and CUDA-event time recorded.  Returns (chains, steps,
    runtime)."""
    import torch
    from repro_torch.launch.profile_step import wave_prompts, wave_runtime
    from repro_torch.launch.steps import paged_decode_builder
    from repro_torch.serving.engine import GenerationRequest
    builder = (None if devices is None
               else paged_decode_builder(tp_mesh(devices)))
    kw = {} if params is None else {"params": params}
    cfg, rt = wave_runtime(kv_dtype, 0, TP_NEW_TOKENS, arch=arch, bs=bs,
                           paged_step_builder=builder, **kw)
    for rid, prompt in enumerate(wave_prompts(cfg.vocab_size)[:n_requests]):
        rt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                    max_new_tokens=TP_NEW_TOKENS,
                                    stream=rid))
    steps, decode = [], rt._paged_decode

    def recorded(arena, tokens, live, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits = decode(arena, tokens, live, **kw)
        b.record()
        steps.append((live.nonzero()[:, 0].cpu(), tokens[live].cpu(),
                      logits[live], a, b))
        return logits

    rt._paged_decode = recorded
    results = rt.drain()
    torch.cuda.synchronize()
    check(len(results) == n_requests,
          f"{arch} tp wave served {len(results)}/{n_requests}")
    chains = {r.rid: np.asarray(r.tokens) for r in results}
    return chains, [(i, t, lg, a.elapsed_time(b))
                    for i, t, lg, a, b in steps], rt


def hold_tp_logits(label, base, sharded):
    """Holds each decode step's logits of the sharded run to the base
    run's as phase 8 (c) holds a step's (``PARITY_TOL`` of their norm),
    over the live slots whose fed tokens so far are the same in both runs;
    returns (steps held, rows, the worst step's share of the limit, the
    worst single row's share: printed, not held)."""
    import torch
    check(len(base) == len(sharded),
          f"{label}: {len(base)} vs {len(sharded)} decode steps")
    same, n_steps, rows, worst, worst_row = {}, 0, 0, 0.0, 0.0
    for (ia, ta, la, _), (ib, tb, lb, _) in zip(base, sharded):
        check(torch.equal(ia, ib), f"{label}: the live slots differ")
        keep = []
        for j, slot in enumerate(ia.tolist()):
            same[slot] = same.get(slot, True) and int(ta[j]) == int(tb[j])
            if same[slot]:
                keep.append(j)
        if not keep:
            continue
        a, b = la[keep].float(), lb[keep].float()
        share = ((b - a).norm() / (PARITY_TOL * a.norm())).item()
        rows_share = ((b - a).norm(dim=1)
                      / (PARITY_TOL * a.norm(dim=1))).max().item()
        check(share <= 1, f"{label}: a decode step's logits differ by "
              f"{share} of the limit ({PARITY_TOL} of their norm)")
        n_steps, rows = n_steps + 1, rows + len(keep)
        worst, worst_row = max(worst, share), max(worst_row, rows_share)
    return n_steps, rows, worst, worst_row


def tp_kv_witness(card0):
    """``python3 chip_smoke.py --tp-witness``: what sets phase 17 (a)'s
    logits gap, int8 K/V or the reduction's rounding.  minicpm-2b's wave at tp = 1 and tp = 4 (over
    ``[card0] * 4``) with int8 and with bf16 K/V, at ``TP_WITNESS_BS``
    slots, one weight draw for the four; each pair held as (a) holds its
    own.  Returns {kv dtype: ``hold_tp_logits``'s tuple}."""
    import torch
    out, params = {}, None
    for kv in ("int8", "bf16"):
        runs = []
        for devices in ([card0], [card0] * 4):
            _, st, rt = tp_wave("minicpm-2b", kv, TP_REQUESTS,
                                devices=devices, bs=TP_WITNESS_BS,
                                params=params)
            params = rt.params if params is None else params
            runs.append(st)
            del rt
            gc.collect()
            torch.cuda.empty_cache()
        out[kv] = hold_tp_logits(f"tp witness minicpm-2b {kv} tp = 4",
                                 *runs)
        print(f"tp witness: minicpm-2b {kv} K/V, {TP_WITNESS_BS} slots, "
              f"tp = 4 against tp = 1: logits held on {out[kv][0]} steps "
              f"({out[kv][1]} rows), worst step {out[kv][2]:.4f} of the "
              f"limit (worst single row {out[kv][3]:.4f})")
    return out


def tp_kernel_cases():
    """#1-#4 at the shards' shapes against their plain versions
    (``check_rows`` and atol = rtol = TOL), the tp = 4 shapes timed; each
    timed record's work equal to ``roofline/op_cost.py``'s rule for the
    same arguments."""
    import torch
    from repro_torch.kernels.quant import QuantPages
    from repro_torch.roofline.op_cost import kernel_work
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rng = np.random.default_rng(17)
    lens = phase3_lens(512)
    out = {}
    for shape, heads in TP_KERNEL_SHAPES.items():
        timed = shape.endswith("tp4")
        for quant in (False, True):
            tag = "_quant" if quant else ""
            rec = decode_case(gen, rng, B=512, lens=lens, quant=quant,
                              timed=timed, **heads)
            if timed:
                meta = lambda *s, dt=torch.bfloat16: torch.empty(
                    s, dtype=dt, device="meta")
                pool = meta(4097, 32, heads["Hkv"], heads["D"])
                if quant:
                    pool = QuantPages(meta(*pool.shape, dt=torch.int8),
                                      meta(*pool.shape[:3],
                                           dt=torch.float32))
                _, flops, nbytes = kernel_work(
                    "paged_decode_attention",
                    meta(512, heads["Hq"], heads["D"]), pool, pool,
                    meta(512, 8, dt=torch.int32), torch.from_numpy(lens))
                check((nbytes, flops) == rec["work"],
                      f"op_cost's paged decode work {(nbytes, flops)} is "
                      f"not the bound's {rec['work']}")
            out[f"paged_decode_attention{tag}@{shape}"] = rec
            rec = chunk_case(gen, rng, B=1, T=128, start=[64],
                             chunk_len=[128], prefix_len=0, quant=quant,
                             timed=timed, **heads)
            out[f"paged_chunk_prefill_attention{tag}@{shape}"] = rec
            torch.cuda.empty_cache()
    for name, rec in out.items():
        print(f"  phase 17 {name}: "
              + json.dumps({k: v for k, v in rec.items() if k != "work"}))
    return out


def phase_tp(phase3_toks):
    """Phase 17: minicpm-2b at its plan (512 slots, int8 K/V, the prefix
    cache at its default) over the service mesh [cuda:0] (tp = 1: phase
    3's chains exactly) and [cuda:0] * 4 (tp = 4, 9 heads a shard: first
    tokens equal, logits held to ``PARITY_TOL``, splits printed with
    their gaps, the kernel launches 4x); codeqwen1.5-7b (bf16 K/V, random
    qkv biases) unsharded and at tp = 2 on 8 requests;
    ``decode_cost_analysis`` beside the measured step time; the launcher
    with ``--pjit-decode``; #1-#4 at the shards' shapes.  Every count is
    zeroed just before the phase and read after the launcher, before the
    kernel comparisons.  Returns the counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import serve
    from repro_torch.launch.profile_step import wave_prompts, wave_runtime
    from repro_torch.models.registry import model_api
    n_cards = torch.cuda.device_count()
    print(f"phase 17: {n_cards} card(s) on this machine")
    reset_launches()
    card0 = torch.device("cuda", 0)
    base, base_steps, rt = tp_wave("minicpm-2b", "int8", TP_REQUESTS,
                                   devices=[card0])
    check(rt.sharded_step.tp == 1 and rt.kv_dtype == "int8"
          and rt.prefix_cache_enabled and rt.plan.max_in_flight == 512,
          "phase 17: minicpm-2b is not at its plan")
    for rid, toks in base.items():
        check(np.array_equal(toks, phase3_toks[rid]),
              f"phase 17: tp = 1 request {rid}'s chain is not phase 3's")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    c0 = launch_counts()
    t0 = time.perf_counter()
    got, steps4, rt = tp_wave("minicpm-2b", "int8", TP_REQUESTS,
                              devices=[card0] * 4)
    wall = time.perf_counter() - t0
    grown = {k: v - c0[k] for k, v in launch_counts().items()}
    L = rt.cfg.num_layers
    check(grown["paged_decode_attention_quant"] == 4 * L * rt.decode_steps
          and grown["paged_chunk_prefill_attention_quant"]
          == 4 * L * rt.prefill_chunk_calls,
          f"phase 17: tp = 4 launches {grown} are not 4 a layer a step")
    check(all(got[r][0] == base[r][0] for r in base),
          "phase 17: a tp = 4 first token differs from tp = 1's")
    held = hold_tp_logits("phase 17 minicpm-2b tp = 4", base_steps, steps4)
    params = rt.params
    splits = chain_splits(rt.cfg, params, base, got,
                          wave_prompts(rt.cfg.vocab_size)[:TP_REQUESTS])
    step_ms = [ms for *_, ms in steps4]
    base_ms = [ms for *_, ms in base_steps]
    cost4 = rt.decode_cost_analysis()
    print(f"phase 17 (a) minicpm-2b int8, 512 slots, {TP_REQUESTS} "
          f"requests: tp = 4 over [cuda:0] * 4, {rt.decode_steps} decode "
          f"steps, {rt.prefill_chunk_calls} chunks, {wall:.3f} s, launches "
          f"{grown}, mesh reductions {rt.sharded_step.mesh.reduce_calls} "
          f"({rt.sharded_step.mesh.reduce_bytes / 1e9:.3f} GB); logits "
          f"held on {held[0]} steps ({held[1]} rows), worst step "
          f"{held[2]:.4f} of the limit (worst single row {held[3]:.4f}); "
          f"{sum(np.array_equal(got[r], base[r]) for r in base)}/"
          f"{len(base)} chains equal tp = 1's, splits {splits}; "
          f"{prefix_counters(rt)}")
    print(f"phase 17 (d) decode step, CUDA events: tp = 1 median "
          f"{statistics.median(base_ms):.3f} ms, tp = 4 median "
          f"{statistics.median(step_ms):.3f} ms; decode_cost_analysis tp "
          f"= 4: " + json.dumps(cost4))
    del rt, steps4, base_steps
    gc.collect()
    torch.cuda.empty_cache()
    _, rt = wave_runtime("int8", 0)
    cost1 = rt.decode_cost_analysis()
    check(cost1["aten_flops"] == cost4["aten_flops"]
          and cost1["kernel_flops"] == cost4["kernel_flops"],
          "phase 17: the sharded step's FLOPs are not the unsharded one's")
    print("phase 17 (d) decode_cost_analysis tp = 1 (every slot at the "
          "full table width, as a static step counts it): "
          + json.dumps(cost1))
    del rt
    gc.collect()
    torch.cuda.empty_cache()

    # (b) codeqwen1.5-7b: D = 128, bf16 K/V, qkv biases drawn so that
    # their split is exercised, unsharded and over [cuda:0] * 2
    cfg = get_config("codeqwen1.5-7b")
    params = model_api(cfg).init(1, cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    for name in ("bq", "bk", "bv"):
        b = params["blocks"]["attn"][name]
        b.copy_(0.02 * torch.randn(b.shape, generator=gen, device="cuda"))
    runs = {}
    for label, devices in (("unsharded", None), ("tp2", [card0] * 2)) + (
            (("tp2_two_cards", [card0, torch.device("cuda", 1)]),)
            if n_cards > 1 else ()):
        chains, st, rt = tp_wave("codeqwen1.5-7b", "bf16",
                                 TP_CODEQWEN_REQUESTS, devices=devices,
                                 bs=TP_CODEQWEN_BS, params=params)
        check(rt.kv_dtype == "bf16", "phase 17: codeqwen is not bf16 K/V")
        runs[label] = (chains, st)
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    base, base_steps = runs["unsharded"]
    for label in runs:
        if label == "unsharded":
            continue
        got, st = runs[label]
        check(all(got[r][0] == base[r][0] for r in base),
              f"phase 17 codeqwen {label}: a first token differs")
        held = hold_tp_logits(f"phase 17 codeqwen {label}", base_steps,
                              st)
        splits = chain_splits(cfg, params, base, got,
                              wave_prompts(cfg.vocab_size)[
                                  :TP_CODEQWEN_REQUESTS])
        print(f"phase 17 (b) codeqwen1.5-7b bf16, {TP_CODEQWEN_BS} slots, "
              f"{TP_CODEQWEN_REQUESTS} requests, {label}: logits held on "
              f"{held[0]} steps ({held[1]} rows), worst step "
              f"{held[2]:.4f} of the limit (worst single row "
              f"{held[3]:.4f}); "
              f"{sum(np.array_equal(got[r], base[r]) for r in base)}/"
              f"{len(base)} chains equal the unsharded run's, splits "
              f"{splits}")
    if n_cards == 1:
        print("phase 17 (b): one card, so the cross-card copies of the "
              "mesh's reductions are unchecked")
    del params, runs, base_steps
    gc.collect()
    torch.cuda.empty_cache()

    print("phase 17 (e) the launcher with --pjit-decode:")
    rc = serve.main(["--pjit-decode", "--requests", "8",
                     "--max-new-tokens", "8"])
    check(rc == 0, f"the launcher with --pjit-decode exited {rc}")
    # the serving runs' launches; (c)'s comparisons are not counted
    counts = launch_counts()
    print("phase 17 (c) #1-#4 at the shards' shapes:")
    tp_kernel_cases()
    return counts



# ---------------------------------------------------------------------------
# phase 18: head-sharded paged serving of the MoE, SSM, audio, hybrid and
# VLM families
# ---------------------------------------------------------------------------

TP_FAMILY_REQUESTS = 8         # the first 8 of phases 4-6's 32 requests
TP_FAMILY_NEW = 8              # (a1)'s and (a2)'s new tokens (cut from
#                                16 for the script's limit)
# phase 18 (a1)'s depth: two layers (whisper: two encoder and two decoder
# layers) carry every kernel and reduction of the path at full width,
# with too little depth to amplify bf16 rounding; at full depth on random
# weights a rounding-level change (mamba2-2.7b's plain SSD scan in place
# of the kernel, unsharded) already moves the final-chunk logits by
# 0.11-0.18 of their norm and splits every chain (``--tp-floor``)
TP_PARITY_LAYERS = 2
# mixtral-8x7b first: its 47 GB of weights before phase 21's kept trees
TP_FAMILIES = ("mixtral-8x7b", "mamba2-2.7b", "whisper-large-v3")
# the archs whose full-depth wave (a2) stays inside ``PARITY_TOL`` of the
# unsharded one and is held there (whisper-large-v3's final-chunk logits
# 0.013-0.016 of their norm); mamba2-2.7b's 64 recurrent layers and
# mixtral-8x7b's router carry a rounding-level change past it on random
# weights (``--tp-floor``: the plain SSD scan for the kernel, unsharded,
# moves mamba2's final-chunk logits 0.11-0.18 of their norm), so their
# waves are measured and (a1) holds their path
TP_WAVE_HELD = ("whisper-large-v3",)
# each family's kernels on the head-sharded path, the launches each makes
# a layer of one shard in a decode step and in a chunk (whisper's flash
# attention also runs its encoder's layers once a request)
TP_FAMILY_KERNELS = {
    "mamba2-2.7b": {"ssd_scan": (0, 1)},
    "whisper-large-v3": {"paged_decode_attention_quant": (1, 0),
                         "decode_attention": (1, 0),
                         "paged_chunk_prefill_attention_quant": (0, 1),
                         "flash_attention": (0, 1)},
    "mixtral-8x7b": {"paged_decode_attention": (1, 0),
                     "paged_chunk_prefill_attention": (0, 1),
                     "grouped_matmul": (3, 3)},
    # the shared block's launches are counted by application
    # (``kernel_layers``), the SSD scan's by mamba layer
    "zamba2-7b": {"paged_decode_attention_quant": (1, 0),
                  "paged_chunk_prefill_attention_quant": (0, 1),
                  "ssd_scan": (0, 1)},
    "paligemma-3b": {"paged_decode_attention": (1, 0),
                     "paged_chunk_prefill_attention": (0, 1)}}
# phase 18's hybrid and VLM families: each one's tp values (paligemma-3b's
# one kv head replicated on every shard), its parity depth (a1) with any
# other change to its config there, and the wave size its prompts are
# spread over (phases 14's and 15's waves, whose chains (a2) is measured
# against).  zamba2-7b's shared block follows every 6th mamba layer, so
# at 2 layers it would run no attention: its parity pair applies the
# block after each of its 2 layers (two applications, each with its own
# pools); at 7 layers (one application and a tail) its final-chunk
# logits already part 0.026-0.046 of their norm on random weights
TP_NEW_FAMILIES = {"zamba2-7b": dict(tps=(4,), layers=TP_PARITY_LAYERS,
                                     over={"attn_every": 1}, spread=16),
                   "paligemma-3b": dict(tps=(2, 4), layers=TP_PARITY_LAYERS,
                                        over={}, spread=32)}
# phases 14's bf16 and 15's int8 chains, by arch: phase 18 (a2)'s
# full-depth diagnostic
FAMILY_CHAINS = {}
# phase 18's weights of phase 21's families, by ``tree_key``: the whole
# 2-layer trees of (a1), its tp = 4 shards and (a2)'s full-depth tp = 4
# shards, which phase 21 (run right after phase 18) serves again; and
# (a2)'s chains by arch, which phase 21 (a2) measures its chains against
TP_TREES = {}
TP_WAVE_CHAINS = {}
# phase 12 (b)'s chains by run ("self_draft"): phase 20 (a2)'s tp = 1
SPEC_CHAINS = {}


def kernel_layers(cfg, name: str) -> int:
    """The layers of ``cfg`` a kernel of ``TP_FAMILY_KERNELS`` runs in:
    the hybrid's attention kernels once an application of its shared
    block, every other kernel once a layer."""
    if cfg.family == "hybrid" and "attention" in name:
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def record_decodes(rt, rids):
    """Wraps ``rt``'s fused decode step: each step's logits row of every
    live slot that serves one of the requests ``rids``, with the token it
    was fed, by request: {rid: [(step, fed token, logits row)]}."""
    out = {r: [] for r in rids}
    decode, step = rt._paged_decode, [0]

    def recorded(arena, tokens, live, **kw):
        logits = decode(arena, tokens, live, **kw)
        fed, on = tokens.cpu(), live.cpu()
        for g in rt.groups.values():
            for s in g.slots:
                if g.arena is arena and s.req.rid in out and on[s.slot_id]:
                    out[s.req.rid].append((step[0], int(fed[s.slot_id]),
                                           logits[s.slot_id].clone()))
        step[0] += 1
        return logits

    rt._paged_decode = recorded
    return out


def record_chunk_drops(rt):
    """Wraps ``rt``'s chunk runner: the MoE drops of every prefill chunk,
    by (rid, the chunk's first prompt position)."""
    from repro_torch.models import moe
    out, run = {}, rt._run_chunk

    def recorded(arena, s, T):
        stats = moe.MOE_DROP_STATS
        stats.flush()
        d0 = stats.dropped
        logits, n_valid = run(arena, s, T)
        stats.flush()
        out[(s.req.rid, s.consumed - n_valid)] = stats.dropped - d0
        return logits, n_valid

    rt._run_chunk = recorded
    return out


def record_routing(rt, tp):
    """Records the MoE router of ``rt``'s first ``TP_FAMILY_REQUESTS``
    requests as the first of its ``tp`` shards (or its one tree) sees it:
    for every FFN call, in order, its kind ("decode" or "prefill"), where
    (the decode step, or the chunk's (rid, first prompt position)), its
    layer, and for each recorded request its rows: the router's input
    (f32, on the host), the top-k experts in the order the dispatch
    claims them, the smallest gap between adjacent ones of its k + 1
    largest router logits, and the router logits' norm.  A one-shot
    prefill is recorded as a chunk from position 0.  Patches
    ``moe.moe_ffn`` (which a head-sharded step calls once a shard, the
    shards in turn, layer by layer) until ``restore()``; returns (log,
    restore)."""
    from repro_torch.models import layers, moe
    rids = set(range(TP_FAMILY_REQUESTS))
    log, where = [], {"calls": 0, "steps": 0}
    ffn, decode, run = moe.moe_ffn, rt._paged_decode, rt._run_chunk
    admit = rt._admit_one

    def logged(lp, cfg, x):
        lead = where["calls"] % tp == 0
        where["calls"] += 1
        if lead:
            k = cfg.experts_per_token
            xs = (x if x.ndim == 2 else x[0]).float()
            lg = layers.linear(xs, lp["moe"]["router"].float())
            top = lg.topk(k + 1, dim=-1)
            gap = (top.values[:, :-1] - top.values[:, 1:]).min(dim=-1).values
            norm = lg.norm(dim=-1)
            log.append({"kind": where["kind"], "at": where["at"],
                        "layer": where["layer"],
                        "rows": {r: (xs[sl].cpu(), top.indices[sl, :k].cpu(),
                                     gap[sl].cpu(), norm[sl].cpu())
                                 for r, sl in where["rows"].items()}})
            where["layer"] += 1
        return ffn(lp, cfg, x)

    def stepped(arena, tokens, live, **kw):
        on = live.cpu()
        where.update(kind="decode", at=where["steps"], layer=0, rows={
            s.req.rid: slice(s.slot_id, s.slot_id + 1)
            for g in rt.groups.values() for s in g.slots
            if g.arena is arena and s.req.rid in rids and on[s.slot_id]})
        out = decode(arena, tokens, live, **kw)
        where["steps"] += 1
        return out

    def chunked(arena, s, T):
        where.update(kind="prefill", at=(s.req.rid, s.consumed), layer=0,
                     rows={s.req.rid: slice(None)} if s.req.rid in rids
                     else {})
        return run(arena, s, T)

    def admitted(req, *a, **kw):
        where.update(kind="prefill", at=(req.rid, 0), layer=0,
                     rows={req.rid: slice(None)} if req.rid in rids else {})
        return admit(req, *a, **kw)

    moe.moe_ffn = logged
    rt._paged_decode, rt._run_chunk = stepped, chunked
    rt._admit_one = admitted

    def restore():
        moe.moe_ffn = ffn
    return log, restore


def hold_routing(label, base, got, hold=True, fed=None):
    """Holds ``got``'s ``record_routing`` log to ``base``'s, call by call:
    the router inputs of every request whose routing has not yet split,
    stacked, to ``PARITY_TOL`` of their norm, so that attention and every
    expert FFN before a request's split stay held; where a request's
    ordered top-k first differs, the base's router gap there must be a
    tie at that noise (``PARITY_TOL`` of the row's router-logit norm, a
    fixed reading, not the two runs' difference).  A request whose fed
    tokens part (``fed``: {rid: the first decode step fed another token})
    is held no further from that step.  Without ``hold`` all only
    measured.  Returns ({rid: (kind, where, layer, router gap, its
    bound)} of the first splits, {calls, rows, the worst call's share of
    the limit})."""
    import torch
    check(len(base) == len(got) and all(
        (a["kind"], a["at"], a["layer"], a["rows"].keys())
        == (b["kind"], b["at"], b["layer"], b["rows"].keys())
        for a, b in zip(base, got)),
        f"{label}: the two runs' MoE calls differ")
    split, calls, rows, worst = {}, 0, 0, 0.0
    fed = fed or {}
    for a, b in zip(base, got):
        held = [r for r in a["rows"] if r not in split and not (
            a["kind"] == "decode" and a["at"] >= fed.get(r, float("inf")))]
        if not held:
            continue
        xa = torch.cat([a["rows"][r][0] for r in held])
        xb = torch.cat([b["rows"][r][0] for r in held])
        share = ((xb - xa).norm() / (PARITY_TOL * xa.norm())).item()
        check(share <= 1 or not hold, f"{label}: the router inputs of "
              f"{a['kind']} {a['at']} layer {a['layer']} differ by {share} "
              f"of the limit ({PARITY_TOL} of their norm)")
        calls, rows, worst = calls + 1, rows + xa.shape[0], max(worst, share)
        for r in held:
            differ = (a["rows"][r][1] != b["rows"][r][1]).any(dim=-1)
            if not differ.any():
                continue
            gap = a["rows"][r][2][differ].max().item()
            bound = (PARITY_TOL * a["rows"][r][3][differ]).min().item()
            check(gap <= bound or not hold, f"{label}: request {r}'s "
                  f"routing split at {a['kind']} {a['at']} layer "
                  f"{a['layer']} at a router gap {gap} above a tie ({bound})")
            split[r] = (a["kind"], a["at"], a["layer"], round(gap, 6),
                        round(bound, 6))
    return split, {"calls": calls, "rows": rows,
                   "worst_of_limit": round(worst, 4)}


def hold_family_logits(label, base, got, hold=True, split=None):
    """Holds each decode step of ``got`` (``record_decodes``'s) to the
    same requests' decode steps in ``base`` as ``hold_tp_logits`` holds a
    step: the rows whose fed tokens so far are the same in both runs,
    and whose MoE routing has not split (``split``: {rid: the decode step
    from which its routing differs}), ``PARITY_TOL`` of their norm
    (without ``hold``, only measured).  Returns (steps compared, rows by
    rid, the worst step's share of the limit, the worst single row's
    share)."""
    import torch
    by_step, per_rid = {}, {}
    split = split or {}
    for rid, rows in got.items():
        per_rid[rid] = 0
        for k, (step, tok, lg) in enumerate(rows):
            if k >= len(base[rid]) or base[rid][k][1] != tok \
                    or step >= split.get(rid, float("inf")):
                break
            by_step.setdefault(step, []).append((base[rid][k][2], lg))
            per_rid[rid] += 1
    worst = worst_row = 0.0
    for step, pairs in sorted(by_step.items()):
        a = torch.stack([p[0] for p in pairs]).float()
        b = torch.stack([p[1].to(a.device) for p in pairs]).float()
        share = ((b - a).norm() / (PARITY_TOL * a.norm())).item()
        check(share <= 1 or not hold, f"{label}: decode step {step}'s "
              f"logits differ by {share} of the limit ({PARITY_TOL} of "
              f"their norm)")
        worst = max(worst, share)
        worst_row = max(worst_row, ((b - a).norm(dim=1) / (
            PARITY_TOL * a.norm(dim=1))).max().item())
    return len(by_step), per_rid, worst, worst_row


def family_splits(base_chains, base, got_chains):
    """Where each chain of ``got_chains`` first leaves ``base_chains``'s,
    with the base run's top-two logit gap there: {rid: (position, gap)}."""
    out = {}
    for rid, toks in got_chains.items():
        want = base_chains[rid]
        p = next((i for i, (a, b) in enumerate(zip(toks, want)) if a != b),
                 None)
        if p is None or p == 0:
            continue
        top = base[rid][p - 1][2].float().topk(2).values
        out[rid] = (p, round((top[0] - top[1]).item(), 6))
    return out


def tree_key(cfg, devices):
    """``TP_TREES``' key of ``cfg``'s weights on ``devices``: the whole
    tree on one device (a list of one among them), or the shards over
    the list ``devices``."""
    if isinstance(devices, list) and len(devices) > 1:
        return cfg, tuple(str(d) for d in devices)
    return cfg, str(devices[0] if isinstance(devices, list) else devices)


# the waves' request extras (``wave_extras``, seed 1: whisper's 32 x 1500
# frames take about half a second to draw), by their shape and wave size
WAVE_EXTRAS = {}


def wave_extras_of(cfg, spread):
    """``wave_extras(cfg, spread)``, drawn once a shape."""
    from repro_torch.launch.profile_step import wave_extras
    key = (cfg.family, cfg.encoder_len, cfg.prefix_len, cfg.d_model, spread)
    if key not in WAVE_EXTRAS:
        WAVE_EXTRAS[key] = wave_extras(cfg, spread)
    return WAVE_EXTRAS[key]


def drawn(key, draw, keep):
    """``TP_TREES[key]`` where phase 18 kept it, else ``draw()``, kept
    there with ``keep``."""
    if key in TP_TREES:
        return TP_TREES[key]
    tree = draw()
    if keep:
        TP_TREES[key] = tree
    return tree


def tp_family_runtime(arch, devices, n_requests, *, layers=None, bs=None,
                      new_tokens=40, spread=32, over=None, kv=-1,
                      keep=False, **rt_kw):
    """``arch`` at full width (``WAVE_LAYERS``' depth unless ``layers``,
    which cuts an encoder-decoder's encoder to the same depth), at ``bs``
    slots (``WAVE_BS``' unless given) of ``WAVE_MAX_SEQ_LEN``'s tokens
    where that names it, K/V of ``kv`` (-1: the plan's), its weights from
    seed 1: the whole tree on ``devices`` when it is one device
    (unsharded) or a list of one (through the builder over it), or drawn
    by ``init_sharded`` straight into the shards of the service mesh over
    the list ``devices`` (the same values); the first ``n_requests`` of
    ``wave_runtime``'s ``spread`` requests submitted.  ``over`` replaces
    other fields of the config, ``rt_kw`` are the runtime's other knobs
    (``chunked_prefill``, ``paged_native``).  The weights are phase 18's
    where it kept them in ``TP_TREES`` (``keep``: keep these).  Returns
    (cfg, runtime)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_step import (WAVE_BS, WAVE_LAYERS,
                                                 WAVE_MAX_SEQ_LEN,
                                                 wave_prompts)
    from repro_torch.launch.serve import plan_for
    from repro_torch.launch.steps import init_sharded, paged_decode_builder
    from repro_torch.models.registry import model_api
    from repro_torch.serving.engine import GenerationRequest, ServiceRuntime
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers or WAVE_LAYERS.get(
        arch, full.num_layers))
    if layers and full.family == "audio":
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    cfg = dataclasses.replace(cfg, **(over or {}))
    plan = plan_for(full, kv, bs or WAVE_BS.get(arch), -1)
    kw = ({"max_seq_len": WAVE_MAX_SEQ_LEN[arch]}
          if arch in WAVE_MAX_SEQ_LEN else {})
    kw.update(rt_kw)
    key = tree_key(cfg, devices)
    if not isinstance(devices, list) or len(devices) == 1:
        dev = devices[0] if isinstance(devices, list) else devices
        params = drawn(key, lambda: model_api(cfg).init(1, cfg, dev), keep)
        builder = (paged_decode_builder(tp_mesh(devices))
                   if isinstance(devices, list) else None)
        rt = ServiceRuntime(cfg, params, plan, device=dev,
                            paged_step_builder=builder, **kw)
    else:
        mesh = tp_mesh(devices)
        shards = drawn(key, lambda: init_sharded(1, cfg, mesh), keep)
        rt = ServiceRuntime(cfg, None, plan, device=devices[0],
                            paged_step_builder=paged_decode_builder(
                                mesh, shards=shards), **kw)
    for rid, (prompt, extras) in enumerate(zip(
            wave_prompts(cfg.vocab_size, spread)[:n_requests],
            wave_extras_of(cfg, spread)[:n_requests])):
        rt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                    max_new_tokens=new_tokens, stream=rid,
                                    extras=extras))
    torch.cuda.synchronize()
    return cfg, rt


def run_steps(rt):
    """Drains ``rt`` step by step; returns (chains by rid, wall s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = []
    while rt.pending() or rt.in_flight():
        results.extend(rt.step(max_wait_s=0.0).results)
    torch.cuda.synchronize()
    return {r.rid: np.asarray(r.tokens) for r in results}, \
        time.perf_counter() - t0


def repeated_flops(cfg, capacity: int, tp: int = 4) -> int:
    """The matmul FLOPs a decode step repeats on every further shard of a
    head-sharded family, a layer: the MoE router and its combine einsum
    (one token a routing group at capacity C; the dispatch einsum
    contracts that one row, counted as no FLOPs), Mamba-2's B and C
    columns of in_proj (the SSM's and the hybrid's mamba layers), the K
    and V projections of a kv head replicated over the ``tp`` shards
    (paligemma-3b's one); whisper none."""
    if cfg.family == "moe":
        C = max(1, int(cfg.moe_capacity_factor * cfg.experts_per_token
                       / cfg.num_experts))
        return 2 * capacity * cfg.d_model * cfg.num_experts * (1 + C)
    if cfg.family in ("ssm", "hybrid"):
        return 2 * capacity * cfg.d_model * 2 * cfg.ssm_ngroups \
            * cfg.ssm_state
    if cfg.num_kv_heads % tp:
        return 2 * (2 * capacity * cfg.d_model * cfg.num_kv_heads
                    * cfg.head_dim)
    return 0


def recorded_run(rt, moe_drops=False, routing=None,
                 n_requests=TP_FAMILY_REQUESTS, oneshot=False):
    """Drains ``rt`` with the first ``n_requests`` requests' decode rows,
    final-chunk logits (``oneshot``: one-shot prefill logits, through
    its sharded step), (``moe_drops``) chunk drops and (``routing``, its
    shard count) MoE routing (``record_routing``) recorded; returns a
    record like phases 4-6's, with the launches and wall."""
    from repro_torch.kernels.ops import launch_counts
    rec = {"decodes": record_decodes(rt, range(n_requests)),
           "final": (keep_oneshot_logits(rt) if oneshot
                     else keep_final_logits(rt)),
           "drops": record_chunk_drops(rt) if moe_drops else None,
           "routing": None}
    restore = None
    if routing is not None:
        rec["routing"], restore = record_routing(rt, routing)
    c0 = launch_counts()
    try:
        rec["chains"], rec["wall"] = run_steps(rt)
    finally:
        if restore is not None:
            restore()
    rec["launches"] = {k: v - c0[k] for k, v in launch_counts().items()
                       if v - c0[k]}
    return rec


def bf16_tie(row) -> bool:
    """Whether a logits row's top two lie within one bf16 ulp of its top
    logit: a tie that any rounding may break either way."""
    import math
    top = row.float().topk(2).values
    e = math.frexp(top[0].item())[1]       # |top| in [2**(e-1), 2**e)
    return (top[0] - top[1]).item() <= 2.0 ** (e - 8)


def compare_runs(label, base, got, hold=True):
    """``got`` against ``base`` (``recorded_run``'s records) on the same
    requests.  A request whose MoE routing split in its prefill (at a tie,
    its router inputs held up to there: ``hold_routing``) is held no
    further.  Every other request: its first token equal, or split at a
    bf16 tie (``bf16_tie`` of the base's final-chunk logits); its
    final-chunk logits within ``PARITY_TOL`` of their norm; its decode
    rows held step by step (``hold_family_logits``) until its fed tokens
    or its routing part, its first decode row always.  MoE drops equal
    chunk by chunk, for every chunk before its request's routing split.
    Without ``hold`` all only measured.  At least half of the requests
    (a quarter for the MoE family, whose router breaks near-ties
    otherwise) must be held whole.  Returns a summary to print."""
    rids = [r for r in got["chains"] if r in base["chains"]]
    routed, router = {}, None
    if got.get("routing") is not None:
        # the first decode step each request was fed another token
        fed = {}
        for r in rids:
            for a, b in zip(base["decodes"].get(r, []),
                            got["decodes"].get(r, [])):
                if a[1] != b[1]:
                    fed[r] = a[0]
                    break
        routed, router = hold_routing(label, base["routing"], got["routing"],
                                      hold, fed)
    whole = [r for r in rids if routed.get(r, ("decode",))[0] != "prefill"]
    need = len(rids) // (4 if router is not None else 2)
    check(len(whole) >= need or not hold, f"{label}: {len(whole)} of "
          f"{len(rids)} requests held whole, under {need}: routing splits "
          f"{routed}")
    firsts = {r: (int(base["chains"][r][0]), int(got["chains"][r][0]),
                  bf16_tie(base["final"][r])) for r in whole
              if got["chains"][r][0] != base["chains"][r][0]}
    check(all(t for _, _, t in firsts.values()) or not hold, f"{label}: "
          f"first tokens split above a bf16 tie (base, got, tie): {firsts}")
    final = {r: round(((got["final"][r].float() - base["final"][r].float())
                       .norm() / base["final"][r].float().norm()).item(), 4)
             for r in rids}
    check(all(final[r] <= PARITY_TOL for r in whole) or not hold,
          f"{label}: final-chunk logits differ from the base's by {final} "
          f"of their norm, over {PARITY_TOL} (requests held: {whole})")
    steps, per_rid, worst, worst_row = hold_family_logits(
        label, base["decodes"], got["decodes"], hold,
        {r: (0 if kind == "prefill" else at)
         for r, (kind, at, _, _, _) in routed.items()})
    # every held request whose first token agrees feeds it to its first
    # decode step, on both runs; it is held unless its routing split there
    first_rows = [r for r in whole if r not in firsts and got["decodes"][r]
                  and (r not in routed
                       or got["decodes"][r][0][0] < routed[r][1])]
    check(all(per_rid[r] > 0 for r in first_rows) or not hold,
          f"{label}: no decode row held for requests "
          f"{[r for r in first_rows if not per_rid[r]]}")
    out = {"held_whole": len(whole), "first_equal": int(sum(
               got["chains"][r][0] == base["chains"][r][0] for r in rids)),
           "first_ties": firsts, "routing_splits": routed, "router": router,
           "final_chunk_rel": [final[r] for r in rids],
           "steps_held": steps, "rows": sum(per_rid.values()),
           "worst_step_of_limit": round(worst, 4),
           "worst_row_of_limit": round(worst_row, 4),
           "chains_equal": sum(np.array_equal(
               got["chains"][r], base["chains"][r][:len(got["chains"][r])])
               for r in rids),
           "splits": family_splits(base["chains"], base["decodes"],
                                   got["chains"])}
    if got["drops"] is not None:
        mine = {k: v for k, v in base["drops"].items() if k[0] in rids}
        check(got["drops"].keys() == mine.keys(), f"{label}: chunks "
              f"{sorted(got['drops'])} are not the base's {sorted(mine)}")
        # a chunk from its request's routing split on routes otherwise
        held = [k for k in mine
                if routed.get(k[0], ("decode",))[0] != "prefill"
                or k[1] < routed[k[0]][1][1]]
        unequal = {k: (mine[k], got["drops"][k]) for k in held
                   if got["drops"][k] != mine[k]}
        check(not unequal or not hold, f"{label}: MoE drops of chunks "
              f"(rid, start) differ (base, tp): {unequal}")
        out["moe_drops"] = {"tp": sum(got["drops"].values()),
                            "base": sum(mine.values()),
                            "chunks_held": len(held),
                            "chunks_equal": len(held) - len(unequal),
                            "chunks": len(mine)}
    return out


def tp_family_parity(arch, card0, tps=(4,), layers=TP_PARITY_LAYERS,
                     spread=32, cost=False, over=None, keep=False):
    """Phase 18 (a1): ``arch`` at full width and ``layers`` layers,
    unsharded and at each tp of ``tps`` over ``[card0] * tp`` with the
    same weights, on the first ``TP_FAMILY_REQUESTS`` requests (of a
    ``spread``-request wave; ``over``: other config changes; ``keep``:
    the trees kept for phase 21), held by ``compare_runs``: first tokens,
    final-chunk logits, each decode step's logits and MoE drops, and the
    MoE router's inputs up to each request's routing split.  With
    ``cost``, (c): each tp step's ``decode_cost_analysis`` against the
    unsharded one's: the kernels' FLOPs equal, the matmuls' those plus
    what the tp - 1 further shards repeat (``repeated_flops``).  Returns
    {tp: comparison}."""
    import torch
    runs, costs = [], []
    for devices in (card0, *[[card0] * tp for tp in tps]):
        cfg, rt = tp_family_runtime(arch, devices, TP_FAMILY_REQUESTS,
                                    layers=layers, new_tokens=TP_FAMILY_NEW,
                                    spread=spread, over=over, keep=keep)
        moe = cfg.family == "moe"
        tp = 1 if devices is card0 else len(devices)
        runs.append(recorded_run(rt, moe_drops=moe,
                                 routing=tp if moe else None))
        if cost:
            costs.append((tp, rt.decode_cost_analysis(),
                          rt.groups[0].arena.capacity))
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    outs = {}
    for tp, got in zip(tps, runs[1:]):
        outs[tp] = compare_runs(f"{arch} {layers} layers tp = {tp}",
                                runs[0], got)
        print(f"phase 18 (a1) {arch} at {layers} layers, unsharded and tp "
              f"= {tp} over [cuda:0] * {tp}: {json.dumps(outs[tp])}")
    if cost:
        _, cost1, cap = costs[0]
        for tp, cost_tp, _ in costs[1:]:
            extra = (tp - 1) * layers * repeated_flops(cfg, cap, tp)
            check(cost_tp["kernel_flops"] == cost1["kernel_flops"]
                  and cost_tp["aten_flops"] == cost1["aten_flops"] + extra,
                  f"phase 18 {arch}: tp = {tp} FLOPs {cost_tp} are not tp "
                  f"= 1's {cost1} (+ {extra} repeated)")
            print(f"phase 18 (c) {arch} at {layers} layers "
                  f"decode_cost_analysis: tp = 1 {json.dumps(cost1)}; tp = "
                  f"{tp} {json.dumps(cost_tp)}; kernel FLOPs equal, matmul "
                  f"FLOPs tp = 1's + {extra} repeated on the {tp - 1} "
                  f"further shards")
    return outs


def tp_family_wave(arch, devices, base, new_tokens=TP_FAMILY_NEW,
                   spread=32, keep=False):
    """Phase 18 (a2): ``arch`` at phases 4-6's (14's, 15's) size over the
    mesh of ``devices`` on the first ``TP_FAMILY_REQUESTS`` requests (of
    a ``spread``-request wave): every kernel of the path launched ``tp``
    times a layer (an application of the hybrid's shared block) a step;
    first tokens, logits, chains and MoE drops against phases 4-6's rows
    of the same requests (``base``), held by ``compare_runs`` for the
    archs of ``TP_WAVE_HELD`` and measured for the others; with ``base``
    None, the chains against ``FAMILY_CHAINS`` (phases 14's and 15's),
    measured (``chain_agreement``); ``keep``: the trees kept for phase
    21, and the chains in ``TP_WAVE_CHAINS``.  Returns (record,
    runtime)."""
    cfg, rt = tp_family_runtime(arch, devices, TP_FAMILY_REQUESTS,
                                new_tokens=new_tokens, spread=spread,
                                keep=keep)
    tp = rt.sharded_step.tp
    got = recorded_run(rt, moe_drops=cfg.family == "moe")
    if keep:
        TP_WAVE_CHAINS[arch] = got["chains"]
    check(len(got["chains"]) == TP_FAMILY_REQUESTS and all(
        len(t) == new_tokens and t.min() >= 0
        and t.max() < cfg.vocab_size
        for t in got["chains"].values()),
          f"{arch} tp = {tp}: served {got['chains']}")
    L = cfg.num_layers
    per_layer = hold_launches(f"{arch} tp = {tp}", cfg, rt, got["launches"],
                              TP_FAMILY_KERNELS[arch],
                              rt.prefill_chunk_calls, TP_FAMILY_REQUESTS)
    print(f"phase 18 (a2) {arch} tp = {tp}: launches a layer a step (a "
          f"decode step or a chunk) by kernel: {json.dumps(per_layer)}")
    out = (compare_runs(f"{arch} tp = {tp}", base, got,
                        hold=arch in TP_WAVE_HELD) if base is not None
           else chain_agreement(got["chains"], FAMILY_CHAINS.get(arch)))
    arena = rt.groups[0].arena
    shard_gb = [round(arena.shard_bytes(j) / 1e9, 3) for j in range(tp)]
    print(f"phase 18 (a2) {arch} ({L} layers, {arena.capacity} slots, tp = "
          f"{tp} over {[str(d) for d in devices]}): {rt.decode_steps} "
          f"decode steps, {rt.prefill_chunk_calls} chunks in "
          f"{got['wall']:.3f} s, launches {got['launches']}; against "
          f"phases {'4-6' if base is not None else '14-15'}'s rows: "
          f"{json.dumps(out)}; mesh reductions "
          f"{rt.sharded_step.mesh.reduce_calls} "
          f"({rt.sharded_step.mesh.reduce_bytes / 1e9:.3f} GB); arena GB "
          f"by shard {shard_gb}")
    return out, rt


def chain_agreement(chains, base):
    """``chains`` (rid -> tokens) against ``base``'s same requests (longer
    chains compared on ``chains``' length), measured: first tokens equal,
    chains equal, and where each split first."""
    if base is None:
        return {"base": None}
    rids = [r for r in chains if r in base]
    split = {r: int(np.argmax(chains[r] != base[r][:len(chains[r])]))
             for r in rids
             if not np.array_equal(chains[r], base[r][:len(chains[r])])}
    return {"requests": len(rids),
            "first_equal": sum(int(chains[r][0] == base[r][0])
                               for r in rids),
            "chains_equal": len(rids) - len(split), "splits_at": split}


def tp_floor(base, card0):
    """``python3 chip_smoke.py --tp-floor``: the full-depth noise floor a
    rounding-level change gives on random weights: mamba2-2.7b's first
    ``TP_FAMILY_REQUESTS`` requests unsharded with the plain SSD scan
    (``ref.ssd_chunked_ref``) in place of the kernel, measured against
    phase 4's rows of the same requests (``base``) as phase 18 (a2)
    measures the tp = 4 wave (which it runs too, at 40 new tokens)."""
    import torch
    from repro_torch.kernels import ref, ssd_scan
    kernel = ssd_scan.ssd_scan
    ssd_scan.ssd_scan = lambda x, dt, A, B, C, D=None, *, chunk=128, \
        initial_state=None: ref.ssd_chunked_ref(
            x, dt, A, B, C, D, chunk=chunk, initial_state=initial_state)
    try:
        _, rt = tp_family_runtime("mamba2-2.7b", card0, TP_FAMILY_REQUESTS)
        got = recorded_run(rt)
    finally:
        ssd_scan.ssd_scan = kernel
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    out = compare_runs("mamba2-2.7b plain SSD scan", base, got, hold=False)
    print(f"tp floor: mamba2-2.7b unsharded, the plain SSD scan in place "
          f"of the kernel, against phase 4's rows: {json.dumps(out)}")
    tp_family_wave("mamba2-2.7b", [card0] * 4, base, new_tokens=40)
    return out


def tp_family_kernel_cases():
    """The kernels at the head shards' shapes at tp = 4 against their plain
    versions (``check_rows`` and atol = rtol = TOL inside each case), timed
    beside their bounds: #1/#3 at mixtral-8x7b's 8/2 heads (D = 128), #2/#4
    at whisper-large-v3's 5/5 (D = 64), #5 and #7 at 5 heads, #9 at N =
    3584 and K = 3584, #10 at 20 of mamba2-2.7b's 80 heads; #1 and #3
    (the 256-row prefix chunk) at paligemma-3b's 4 and 2 query heads on
    its one kv head (D = 256, tp = 2 and 4), #2/#4 at zamba2-7b's 8/8
    (D = 112) and #10 at 28 of its 112 heads (P = N = 64)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    rng = np.random.default_rng(18)
    out = {}
    lens = np.zeros(512, np.int64)
    lens[:32] = np.linspace(6, 200, 32).astype(int) + 20
    mixtral, whisper = dict(Hq=8, Hkv=2, D=128), dict(Hq=5, Hkv=5, D=64)
    out["paged_decode_attention@mixtral_tp4"] = decode_case(
        gen, rng, B=512, lens=lens, quant=False, timed=True, **mixtral)
    out["paged_chunk_prefill_attention@mixtral_tp4"] = chunk_case(
        gen, rng, B=1, T=64, start=[64], chunk_len=[64], prefix_len=0,
        quant=False, timed=True, **mixtral)
    out["paged_decode_attention_quant@whisper_tp4"] = decode_case(
        gen, rng, B=128, lens=phase3_lens(128), quant=True, timed=True,
        **whisper)
    out["paged_chunk_prefill_attention_quant@whisper_tp4"] = chunk_case(
        gen, rng, B=1, T=128, start=[64], chunk_len=[128], prefix_len=0,
        quant=True, timed=True, **whisper)
    cross = np.zeros(128, np.int64)
    cross[:32] = 1500
    out["decode_attention@whisper_tp4"] = dense_decode_case(
        gen, B=128, S=1500, lens=cross, timed=True, **whisper)
    out["flash_attention@whisper_encoder_tp4"] = flash_case(
        gen, B=1, Lq=1500, Lk=1500, causal=False, timed=True, **whisper)
    out["flash_attention@whisper_cross_chunk_tp4"] = flash_case(
        gen, B=1, Lq=128, Lk=1500, causal=False, timed=True, **whisper)
    torch.cuda.empty_cache()
    out["grouped_matmul@mixtral_tp4_gate_up"] = gmm_case(
        gen, E=8, C=512, K=4096, N=3584, timed=True, route="tma")
    out["grouped_matmul@mixtral_tp4_down"] = gmm_case(
        gen, E=8, C=512, K=3584, N=4096, timed=True, route="tma")
    out["ssd_scan@mamba2_tp4"] = ssd_case(gen, Bb=1, L=128, H=20,
                                          timed=True)
    torch.cuda.empty_cache()
    # paligemma-3b's shards: its one kv head whole on each, 4 (tp = 2) or
    # 2 (tp = 4) of its 8 query heads, at phase 14's 512 slots and chunks
    for tp in (2, 4):
        heads = dict(VLM_HEADS, Hq=VLM_HEADS["Hq"] // tp)
        out[f"paged_decode_attention@paligemma_tp{tp}"] = decode_case(
            gen, rng, B=512, lens=vlm_lens(), quant=False, timed=True,
            nblk=VLM_MAX_SEQ // 32, **heads)
        out[f"paged_chunk_prefill_attention@paligemma_tp{tp}_first_t288"] = \
            chunk_case(gen, rng, quant=False, timed=True,
                       nblk=VLM_MAX_SEQ // 32, **heads,
                       **VLM_CHUNKS["first_t288"])
    torch.cuda.empty_cache()
    # zamba2-7b's shards at tp = 4: 8 query on 8 kv heads (D = 112) in
    # int8 pools at the plan's 256 slots, 28 of its 112 SSD heads
    heads = dict(HYBRID_HEADS, Hq=8, Hkv=8)
    out["paged_decode_attention_quant@zamba2_tp4"] = decode_case(
        gen, rng, B=256, lens=phase3_lens(256), quant=True, timed=True,
        nblk=HYBRID_MAX_SEQ // 32, **heads)
    out["paged_chunk_prefill_attention_quant@zamba2_tp4_t128_at64"] = \
        chunk_case(gen, rng, quant=True, timed=True,
                   nblk=HYBRID_MAX_SEQ // 32, **heads,
                   **HYBRID_CHUNKS["t128_at64"])
    out["ssd_scan@zamba2_tp4"] = ssd_case(gen, Bb=1, L=128, H=28, P=64, G=1,
                                          N=64, timed=True)
    torch.cuda.empty_cache()
    for name, rec in out.items():
        print(f"  phase 18 (b) {name}: "
              + json.dumps({k: v for k, v in rec.items() if k != "work"}))
    return out


def phase_tp_families(bases):
    """Phase 18: the MoE, SSM, audio, hybrid and VLM families split by
    heads over the one card's ``[cuda:0] * tp`` meshes (numerics and
    launches, not speed across cards); the hybrid and VLM families run
    after the others, as the module docstring says.  (a1) Each of the
    others at ``TP_PARITY_LAYERS`` layers, unsharded and at tp = 4, held
    to ``PARITY_TOL``
    (``tp_family_parity``); (a2) each family at phases 4-6's size and
    depth on their first ``TP_FAMILY_REQUESTS`` requests
    (``TP_FAMILY_NEW`` new tokens), every kernel launched 4 times a
    layer a step, measured against phases 4-6's rows
    (``tp_family_wave``); (c) each tp = 4 step's ``decode_cost_analysis``
    against phases 4-6's unsharded one: the kernels' FLOPs equal, the
    matmuls' those plus what the 3 further shards repeat
    (``repeated_flops``); (d) the launcher with ``--pjit-decode`` and
    mamba2-2.7b on the card's (1, 1) mesh, refused before anything is
    allocated (its plan's 512 slots of SSD state, 87 GB, do not fit one
    card; a (1, 4) mesh's share does); (b) the kernels at the shards'
    shapes.  Every count is zeroed just before the phase and read after
    (d), before (b)'s comparisons.  ``bases``: {arch: its phase 4-6
    record}.  Returns the counts."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import serve
    reset_launches()
    card0 = torch.device("cuda", 0)
    for arch in TP_FAMILIES:
        t0 = time.perf_counter()
        keep = arch in ONESHOT_TP
        tp_family_parity(arch, card0, keep=keep)
        _, rt = tp_family_wave(arch, [card0] * 4, bases[arch], keep=keep)
        cost4 = rt.decode_cost_analysis()
        cost1 = bases[arch]["cost"]
        extra = 3 * rt.cfg.num_layers * repeated_flops(
            rt.cfg, rt.groups[0].arena.capacity)
        check(cost4["kernel_flops"] == cost1["kernel_flops"]
              and cost4["aten_flops"] == cost1["aten_flops"] + extra,
              f"phase 18 {arch}: tp = 4 FLOPs {cost4} are not tp = 1's "
              f"{cost1} (+ {extra} repeated)")
        print(f"phase 18 (c) {arch} decode_cost_analysis: tp = 1 "
              f"{json.dumps(cost1)}; tp = 4 {json.dumps(cost4)}; kernel "
              f"FLOPs equal, matmul FLOPs tp = 1's + {extra} repeated on "
              f"the 3 further shards; {time.perf_counter() - t0:.1f} s")
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    for arch, spec in TP_NEW_FAMILIES.items():
        t0 = time.perf_counter()
        tp_family_parity(arch, card0, tps=spec["tps"],
                         layers=spec["layers"], spread=spec["spread"],
                         cost=True, over=spec["over"], keep=True)
        for tp in spec["tps"]:
            _, rt = tp_family_wave(arch, [card0] * tp, None,
                                   spread=spec["spread"], keep=tp == 4)
            del rt
            gc.collect()
            torch.cuda.empty_cache()
        print(f"phase 18 {arch}: {time.perf_counter() - t0:.1f} s")
    print("phase 18 (d) the launcher with --pjit-decode, paligemma-3b on "
          "the card's (1, 1) mesh:")
    rc = serve.main(["--pjit-decode", "--archs", "paligemma-3b",
                     "--max-seq-len", "512", "--requests", "4",
                     "--max-new-tokens", "8"])
    check(rc == 0, f"the launcher, paligemma-3b with --pjit-decode, "
          f"exited {rc}")
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 18 (d) the launcher with --pjit-decode, mamba2-2.7b:")
    args = ["--pjit-decode", "--archs", "mamba2-2.7b", "--requests", "4",
            "--max-new-tokens", "8"]
    try:
        why = f"served (exit {serve.main(args)})"
    except RuntimeError as e:
        why = str(e)
    check(why.startswith("the run needs"), f"the launcher on one card's "
          f"(1, 1) mesh and mamba2-2.7b's 87 GB plan: {why}")
    print(f"  (1, 1) mesh: refused before allocating: {why}")
    parsed = serve._parser().parse_args(args)
    cp = serve.control_plane(["mamba2-2.7b"], 1)
    four = meshlib.make_mesh((1, 4), ("data", "model"))
    w, a = serve.footprint(parsed, cp, four)
    check(w + a + serve.HEADROOM_BYTES
          <= torch.cuda.get_device_properties(card0).total_memory,
          f"a (1, 4) mesh's share {(w + a) / 1e9:.2f} GB does not fit")
    print(f"  (1, 4) mesh: a card's share {w / 1e9:.3f} GB of weights and "
          f"{a / 1e9:.3f} GB of arena fits (--across-cards serves it)")
    counts = launch_counts()
    print("phase 18 (b) the kernels at the shards' shapes:")
    tp_family_kernel_cases()
    return counts


# ---------------------------------------------------------------------------
# phase 21: one-shot prefill and the dense-view step split by heads for the
# SSM, audio, hybrid and VLM families
# ---------------------------------------------------------------------------

# phase 21's families in the order it serves them, each one's kept trees
# freed after it (zamba2-7b's 45 GB arena last, beside its own weights
# alone)
ONESHOT_TP = ("mamba2-2.7b", "whisper-large-v3", "paligemma-3b",
              "zamba2-7b")
ONESHOT_REQUESTS = 4           # (a2)'s requests at full depth, and (b)'s
ONESHOT_PROMPT = 200           # (c)'s one-shot rows: the wave's longest
# each family's kernels on the one-shot path: the launches a layer of one
# shard makes in a decode step and in a one-shot prefill (whisper's flash
# attention: its decoder's causal self-attention and its
# cross-attention, and its encoder's layers once a request besides)
ONESHOT_KERNELS = {
    "mamba2-2.7b": {"ssd_scan": (0, 1)},
    "whisper-large-v3": {"paged_decode_attention_quant": (1, 0),
                         "decode_attention": (1, 0),
                         "flash_attention": (0, 2)},
    "zamba2-7b": {"paged_decode_attention_quant": (1, 0),
                  "flash_attention": (0, 1), "ssd_scan": (0, 1)},
    "paligemma-3b": {"paged_decode_attention": (1, 0),
                     "flash_attention": (0, 1)}}
# the dense-view oracle's, bf16: a decode step and a chunk (whisper's
# dense decode also over its cross K/V, its flash attention the chunk's
# cross-attention and its encoder's layers once a request)
ORACLE_KERNELS = {
    "whisper-large-v3": {"decode_attention": (2, 0),
                         "chunk_prefill_attention": (0, 1),
                         "flash_attention": (0, 1)},
    "zamba2-7b": {"decode_attention": (1, 0),
                  "chunk_prefill_attention": (0, 1), "ssd_scan": (0, 1)},
    "paligemma-3b": {"decode_attention": (1, 0),
                     "chunk_prefill_attention": (0, 1)}}


def hold_launches(label, cfg, rt, launches, table, prefills, requests):
    """Every kernel of ``table`` ({name: (a decode step's, a prefill's)
    launches a layer of one shard}) launched exactly tp times that a
    layer a step (whisper's flash attention also tp times its encoder's
    layers for each of the ``requests``); ``prefills``: one-shot prefills
    or chunks.  Returns the launches a layer a step by kernel."""
    tp = rt.sharded_step.tp
    per_layer = {}
    for name, (per_decode, per_prefill) in table.items():
        calls = per_decode * rt.decode_steps + per_prefill * prefills
        encoder = (tp * cfg.encoder_layers * requests
                   if name == "flash_attention" and cfg.family == "audio"
                   else 0)
        want = tp * kernel_layers(cfg, name) * calls + encoder
        have = launches.get(name, 0)
        check(have == want, f"{label}: {name} launched {have} times, not "
              f"{want} ({tp} a layer a step)")
        if calls:
            per_layer[name] = (have - encoder) / (kernel_layers(cfg, name)
                                                  * calls)
    return per_layer


def oneshot_family(arch, card0):
    """Phase 21 (a) and (b) for ``arch``, on phase 18's trees.  (a1) 2
    layers (whisper: its encoder too; zamba2: the shared block after both
    layers) with one-shot prefill at tp = 4 against tp = 1 (the whole
    tree through a one-shard mesh), held by ``compare_runs`` at
    ``PARITY_TOL``; (b) for the families with attention, the same 2
    layers at tp = 4 in bf16 at ``ORACLE_BS`` slots through the
    ``paged_native=False`` oracle (dense views, #5 and #6) against the
    native step, held by ``compare_runs``, the final-chunk logits
    compared bit for bit; (a2) the full depth at tp = 4, one-shot,
    ``ONESHOT_REQUESTS`` requests of ``TP_FAMILY_NEW`` new tokens: their
    chains, measured against phase 18 (a2)'s chunked ones.  Every
    kernel of each path launched exactly tp times a layer a step.
    Returns (record, the launches of the tp = 4 runs)."""
    import torch
    spec = TP_NEW_FAMILIES.get(arch, {})
    over, spread = spec.get("over"), spec.get("spread", 32)
    launches, out = {}, {}

    def add(rec):
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v

    def served(cfg, rt, rec, n):
        check(len(rec["chains"]) == n and all(
            len(t) == TP_FAMILY_NEW and t.min() >= 0
            and t.max() < cfg.vocab_size for t in rec["chains"].values()),
              f"phase 21 {arch}: served {rec['chains']}")

    runs, t0 = {}, time.perf_counter()
    for tp in (1, 4):
        cfg, rt = tp_family_runtime(
            arch, [card0] * tp, TP_FAMILY_REQUESTS, layers=TP_PARITY_LAYERS,
            new_tokens=TP_FAMILY_NEW, spread=spread, over=over,
            chunked_prefill=False)
        check(not rt.chunked_prefill and rt.sharded_step.tp == tp,
              f"phase 21 (a1) {arch}: not one-shot at tp = {tp}")
        runs[tp] = recorded_run(rt, oneshot=True)
        served(cfg, rt, runs[tp], TP_FAMILY_REQUESTS)
        if tp == 4:
            add(runs[4])
            out["a1_per_layer"] = hold_launches(
                f"phase 21 (a1) {arch}", cfg, rt, runs[4]["launches"],
                ONESHOT_KERNELS[arch], rt.oneshot_prefills,
                rt.oneshot_prefills)
        del rt
        gc.collect()
    out["a1"] = compare_runs(f"phase 21 (a1) {arch} one-shot tp = 4",
                             runs[1], runs[4])
    out["a1"]["wall_s"] = [runs[1]["wall"], runs[4]["wall"]]
    print(f"phase 21 (a1) {arch} {TP_PARITY_LAYERS} layers, one-shot "
          f"prefill, tp = 4 over [cuda:0] * 4 against tp = 1, held: "
          f"{json.dumps(out['a1'])}; launches a layer a step "
          f"{json.dumps(out['a1_per_layer'])}; "
          f"{time.perf_counter() - t0:.1f} s")
    del runs
    if arch in ORACLE_KERNELS:
        runs, t0 = {}, time.perf_counter()
        for native in (True, False):
            cfg, rt = tp_family_runtime(
                arch, [card0] * 4, ONESHOT_REQUESTS,
                layers=TP_PARITY_LAYERS, new_tokens=TP_FAMILY_NEW,
                spread=spread, over=over, kv="bf16", bs=ORACLE_BS,
                paged_native=native)
            check(rt.sharded_step.dense != native, f"phase 21 (b) {arch}: "
                  f"the oracle is not on the dense-view step")
            runs[native] = recorded_run(rt, n_requests=ONESHOT_REQUESTS)
            served(cfg, rt, runs[native], ONESHOT_REQUESTS)
            if not native:
                add(runs[False])
                out["b_per_layer"] = hold_launches(
                    f"phase 21 (b) {arch}", cfg, rt, runs[False]["launches"],
                    ORACLE_KERNELS[arch], rt.prefill_chunk_calls,
                    ONESHOT_REQUESTS)
            del rt
            gc.collect()
        out["b"] = compare_runs(f"phase 21 (b) {arch} oracle tp = 4",
                                runs[True], runs[False])
        out["b"]["final_identical"] = [
            r for r in runs[True]["final"] if torch.equal(
                runs[True]["final"][r], runs[False]["final"][r])]
        print(f"phase 21 (b) {arch} {TP_PARITY_LAYERS} layers, bf16, "
              f"{ORACLE_BS} slots, tp = 4: the paged_native=False oracle "
              f"against the native step: {json.dumps(out['b'])}; requests "
              f"whose final-chunk logits are identical: "
              f"{out['b']['final_identical']} of "
              f"{sorted(runs[True]['final'])}; launches a layer a step "
              f"{json.dumps(out['b_per_layer'])}; "
              f"{time.perf_counter() - t0:.1f} s")
        del runs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, rt = tp_family_runtime(arch, [card0] * 4, ONESHOT_REQUESTS,
                                new_tokens=TP_FAMILY_NEW, spread=spread,
                                chunked_prefill=False)
    rec = recorded_run(rt, n_requests=ONESHOT_REQUESTS, oneshot=True)
    served(cfg, rt, rec, ONESHOT_REQUESTS)
    add(rec)
    arena = rt.groups[0].arena
    out["a2"] = {
        "layers": cfg.num_layers, "slots": arena.capacity,
        "kv": rt.kv_dtype, "oneshot_prefills": rt.oneshot_prefills,
        "decode_steps": rt.decode_steps, "wall_s": rec["wall"],
        "per_layer": hold_launches(f"phase 21 (a2) {arch}", cfg, rt,
                                   rec["launches"], ONESHOT_KERNELS[arch],
                                   rt.oneshot_prefills,
                                   rt.oneshot_prefills),
        "chains": {r: rec["chains"][r].tolist()
                   for r in sorted(rec["chains"])},
        "against_phase_18": chain_agreement(rec["chains"],
                                            TP_WAVE_CHAINS.get(arch)),
        "arena_gb_by_shard": [round(arena.shard_bytes(j) / 1e9, 3)
                              for j in range(4)]}
    print(f"phase 21 (a2) {arch} at full depth, one-shot prefill, tp = 4 "
          f"over [cuda:0] * 4: {json.dumps(out['a2'])}; "
          f"{time.perf_counter() - t0:.1f} s")
    del rt, arena
    for key in [k for k in TP_TREES if k[0].name == arch]:
        del TP_TREES[key]
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def oneshot_kernel_cases():
    """#5, #6, #7 and #10 at phase 21's shard shapes against their plain
    versions (held inside each case, ``check_rows`` among them), timed by
    CUDA-graph replay beside their bounds and SDPA: #5 and #6 over (b)'s
    dense views (``ORACLE_BS`` slots) at whisper-large-v3's 5/5 heads (D =
    64), zamba2-7b's 8/8 (D = 112) and paligemma-3b's 4/1 and 2/1 (D =
    256, tp = 2 and 4; its first chunk with the 256-row prefix); #7 over
    a ``ONESHOT_PROMPT``-row prompt: whisper's causal self-attention and
    its cross-attention over 1500 frames at 5 heads, zamba2's shared
    block at 8 heads, paligemma's prefix-LM at 4/1 and 2/1; #10 over the
    same prompt at mamba2-2.7b's 20 heads and zamba2-7b's 28 (tp = 4)."""
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    out = {}
    L = ONESHOT_PROMPT
    shapes = {"whisper_tp4": (dict(Hq=5, Hkv=5, D=64), 256),
              "zamba2_tp4": (dict(Hq=8, Hkv=8, D=112), HYBRID_MAX_SEQ),
              "paligemma_tp2": (dict(VLM_HEADS, Hq=4), VLM_MAX_SEQ),
              "paligemma_tp4": (dict(VLM_HEADS, Hq=2), VLM_MAX_SEQ)}
    for name, (heads, S) in shapes.items():
        vlm = name.startswith("paligemma")
        lens = vlm_lens(ORACLE_BS) if vlm else phase3_lens(ORACLE_BS)
        out[f"decode_attention@{name}_view"] = dense_decode_case(
            gen, B=ORACLE_BS, S=S, lens=lens, timed=True, **heads)
        chunk = (dict(VLM_CHUNKS["first_t288"]) if vlm
                 else dict(HYBRID_CHUNKS["t128_at64"]))
        out[f"chunk_prefill_attention@{name}_view"] = dense_chunk_case(
            gen, S=S, timed=True, **heads, **chunk)
        if vlm:
            P = VLM_CHUNKS["first_t288"]["prefix_len"]
            out[f"flash_attention@{name}_oneshot"] = flash_case(
                gen, B=1, Lq=P + L, Lk=P + L, causal=True, prefix_len=P,
                timed=True, **heads)
        else:
            out[f"flash_attention@{name}_oneshot"] = flash_case(
                gen, B=1, Lq=L, Lk=L, causal=True, timed=True, **heads)
        torch.cuda.empty_cache()
    out["flash_attention@whisper_tp4_cross_oneshot"] = flash_case(
        gen, B=1, Lq=L, Lk=1500, causal=False, timed=True,
        **shapes["whisper_tp4"][0])
    for arch, tag in (("mamba2-2.7b", "mamba2_tp4"),
                      ("zamba2-7b", "zamba2_tp4")):
        cfg = get_config(arch)
        out[f"ssd_scan@{tag}_oneshot"] = ssd_case(
            gen, Bb=1, L=L, H=cfg.ssm_nheads // 4, P=cfg.ssm_headdim,
            G=cfg.ssm_ngroups, N=cfg.ssm_state, chunk=cfg.ssm_chunk,
            timed=True)
    torch.cuda.empty_cache()
    for name, rec in out.items():
        print(f"  phase 21 (c) {name}: "
              + json.dumps({k: v for k, v in rec.items() if k != "work"}))
    return out


def phase_oneshot_tp():
    """Phase 21, run right after phase 18 on its kept trees: for each of
    ``ONESHOT_TP``, one-shot prefill split by heads (a1) at 2 layers
    against tp = 1 and (a2) at full depth, and (b) the dense-view oracle
    against the native step (``oneshot_family``); then (c) #5, #6, #7
    and #10 at the new shard shapes (``oneshot_kernel_cases``).  Every
    count is zeroed just before the phase and read after (b), before
    (c)'s kernel comparisons.  Returns the counts."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    reset_launches()
    card0 = torch.device("cuda", 0)
    for arch in ONESHOT_TP:
        t0 = time.perf_counter()
        oneshot_family(arch, card0)
        print(f"phase 21 {arch}: {time.perf_counter() - t0:.1f} s")
    TP_TREES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    counts = launch_counts()
    print("phase 21 (c) the kernels at the shards' shapes:")
    t0 = time.perf_counter()
    oneshot_kernel_cases()
    print(f"phase 21 (c): {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 19: the examples, through the port on the card
# ---------------------------------------------------------------------------

def load_example(name):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name, argv):
    """``examples/<name>.py``'s ``main(argv)`` in this process, what it
    prints captured and printed; returns (exit code, the lines)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = load_example(name).main(argv)
    print(buf.getvalue(), end="")
    return rc, buf.getvalue().splitlines()


def phase_examples():
    """Phase 19: the four examples as a user runs them, each ``main``
    called in this process with ``--device cuda`` (their reduced configs,
    head dim 64 on the card: ``ops.card_config``): the quickstart (six
    routed requests, each served with 4 tokens), the §4.3 case study
    (three HCI interactions, 4 tokens each), serve_cluster at ``--requests
    9 --chaos`` (a server crashed mid-burst and restarted; every rid
    served or verdicted) and train_small at ``--steps 20`` (the loss
    falls; the checkpoint, written to a temporary directory, is read back
    and its loss on the first batch is below the untrained weights').
    Every count is zeroed just before the phase and read just after it.
    Returns the counts."""
    import re
    import tempfile
    import torch
    from repro_torch.kernels.ops import launch_counts
    reset_launches()
    t0 = time.perf_counter()
    rc, lines = run_example("torch_quickstart", ["--device", "cuda"])
    served = [ln for ln in lines if re.match(r"\s+req\d", ln)]
    check(rc == 0 and len(served) == 6 and lines[-1] == "done."
          and all(len(re.findall(r"\d+\)", ln.split("tokens=")[1]
                                 .split("]")[0])) == 4 for ln in served),
          f"phase 19 quickstart: exit {rc}, {served}")
    rc, lines = run_example("torch_llm_case_study", ["--device", "cuda"])
    talks = [ln for ln in lines if "interaction" in ln and "decode [" in ln]
    check(rc == 0 and len(talks) == 3 and lines[-1] == "done.",
          f"phase 19 case study: exit {rc}, {talks}")
    rc, lines = run_example("torch_serve_cluster",
                            ["--device", "cuda", "--requests", "9",
                             "--chaos"])
    text = "\n".join(lines)
    check(rc == 0 and "accounted 9/9" in text and "chaos: crash" in text,
          f"phase 19 serve_cluster --chaos: exit {rc}")
    with tempfile.TemporaryDirectory() as tmp:
        rc, lines = run_example("torch_train_small",
                                ["--device", "cuda", "--steps", "20",
                                 "--checkpoint", f"{tmp}/small"])
    text = "\n".join(lines)
    loss = re.search(r"final loss ([\d.]+) \(first ([\d.]+)\)", text)
    back = re.search(r"step (\d+), \d+ leaves; eval loss ([\d.]+) "
                     r"restored \(untrained ([\d.]+)\)", text)
    check(rc == 0 and loss and float(loss.group(1)) < float(loss.group(2))
          and back and int(back.group(1)) == 20
          and float(back.group(2)) < float(back.group(3)),
          f"phase 19 train_small: exit {rc}, {loss and loss.groups()}, "
          f"{back and back.groups()}")
    torch.cuda.synchronize()
    counts = launch_counts()
    grown = {k: v for k, v in counts.items() if v}
    print(f"phase 19 launches: {json.dumps(grown)}; "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 20: speculation, the ring and the dense-view oracle split by heads
# ---------------------------------------------------------------------------

TP_SPEC_PAIR_REQUESTS = 8      # (a1): the first 8 of phase 12 (b)'s 16
TP_SPEC_PAIR_NEW = 16
# (a2)'s wave: the first 8 of phase 12 (b)'s 16 requests (all 16 took
# 49.2 s at tp = 4: cut for the script's time limit)
TP_SPEC_WAVE_REQUESTS = 8
RING_ARCH = "mixtral-8x7b"
RING_MAX_SEQ = 4352            # above mixtral-8x7b's 4096-token window
RING_LONG = 4200               # request 0's prompt: past the window
RING_REQUESTS = 8              # request 0 and the wave's first 7
RING_BS = 8                    # one slot a request: 0.268 GB of ring K/V
RING_DEPTH = 16                # (b2)'s layers, as phase 6's
ACROSS_RING_SEQ = 8192         # --across-cards (h): mixtral-8x7b's ring
ACROSS_RING_LONG = 8000
ACROSS_RING_BS = 64
ORACLE_BS = 64
# the kernels of phase 20's paths timed at the tp = 4 shards' shapes
# (PERF.md): #3 at minitron-4b's verify (6 query on 2 kv heads), #5 over
# mixtral-8x7b's full 4096-row ring and #7 in its one-shot prefill past
# the window (8 query on 2 kv heads)
TP_PATH_SHAPES = {"verify": dict(Hq=6, Hkv=2, D=128),
                  "ring": dict(Hq=8, Hkv=2, D=128)}


def tp_spec_runtime(cfg, devices, n_requests, new_tokens):
    """minitron-4b's ``cfg`` at phase 12's plan (512 slots, bf16 K/V,
    k = SPEC_K) over the service mesh of ``devices``, weights from seed 1
    by ``init_sharded`` (the values of ``transformer.init(1, cfg)``), a
    self-draft through the same shards, phase 12 (b)'s first
    ``n_requests`` requests submitted.  The verify logits of every
    speculating slot, its fed tokens and slot ids, and the draft's chunk
    calls are recorded on the runtime (``verify_log``,
    ``draft_chunks``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.launch.serve import plan_for
    from repro_torch.launch.steps import init_sharded, paged_decode_builder
    from repro_torch.serving.engine import (SELF_DRAFT, GenerationRequest,
                                            ServiceRuntime)
    mesh = tp_mesh(devices)
    rt = ServiceRuntime(cfg, None, plan_for(get_config(cfg.name)),
                        device=devices[0], draft_params=SELF_DRAFT,
                        paged_step_builder=paged_decode_builder(
                            mesh, shards=init_sharded(1, cfg, mesh)))
    check(rt.speculate_k == SPEC_K and rt.sharded_draft is rt.sharded_step,
          f"phase 20 (a): {cfg.name} does not speculate through its shards")
    rt.verify_log, rt.draft_chunks = [], [0]
    verify, chunk = rt.sharded_step.verify, rt._chunk_step

    def logged(arena, tokens, chunk_len):
        logits, lens = verify(arena, tokens, chunk_len)
        rows = chunk_len.nonzero()[:, 0]
        rt.verify_log.append((rows.cpu(), tokens[rows].cpu(),
                              logits[rows].clone()))
        return logits, lens

    def counted(arena, sid, toks, n_valid, *, draft=False, **kw):
        rt.draft_chunks[0] += int(draft)
        return chunk(arena, sid, toks, n_valid, draft=draft, **kw)

    rt.sharded_step.verify, rt._chunk_step = logged, counted
    for rid, prompt in enumerate(wave_prompts(cfg.vocab_size)[:n_requests]):
        rt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                    max_new_tokens=new_tokens, stream=rid))
    return rt


def tp_spec_run(cfg, devices, n_requests, new_tokens):
    """Drains ``tp_spec_runtime``; returns (chains, record, runtime), the
    record with phase 12 (b)'s counters and the launches."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    rt = tp_spec_runtime(cfg, devices, n_requests, new_tokens)
    c0 = launch_counts()
    chains, wall = run_steps(rt)
    check(len(chains) == n_requests and all(
        len(t) == new_tokens and t.min() >= 0 and t.max() < cfg.vocab_size
        for t in chains.values()), f"phase 20 (a) served {chains}")
    ver = rt.verify_launches
    rec = {"tp": len(devices), "wall_s": wall,
           "decode_steps": rt.decode_steps,
           "prefill_chunks": rt.prefill_chunk_calls,
           "draft_chunks": rt.draft_chunks[0],
           "verify_launches": ver, "accepted_tokens": rt.accepted_tokens,
           "accepted_per_launch": rt.accepted_tokens / ver if ver else 0.0,
           "draft_steps": rt.draft_steps, "spec_degraded": rt.spec_degraded,
           "launches": {k: v - c0[k] for k, v in launch_counts().items()
                        if v - c0[k]},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(ver > 0, f"phase 20 (a) tp = {len(devices)}: no verify launch")
    L, tp = cfg.num_layers, len(devices)
    want = {"paged_decode_attention": tp * L * (rt.decode_steps
                                                + rt.draft_steps),
            "paged_chunk_prefill_attention": tp * L * (
                rt.prefill_chunk_calls + rt.draft_chunks[0] + ver)}
    have = {k: rec["launches"].get(k, 0) for k in want}
    check(have == want, f"phase 20 (a) tp = {tp}: launches {have} are not "
          f"{tp} a layer a step {want}")
    return chains, rec, rt


def hold_verify_logits(label, base, got):
    """Holds each verify launch of ``got`` to ``base``'s (each
    ``tp_spec_runtime``'s ``verify_log``) with ``check_rows`` at
    ``PARITY_TOL`` of each fed position's norm, over the speculating slots
    whose fed rows so far are the same in both runs, while both runs
    launch for the same slots.  Returns (launches held, rows, the largest
    absolute logit difference held: the noise a split must lie under)."""
    same, n, rows, worst = {}, 0, 0, 0.0
    for (ra, ta, la), (rb, tb, lb) in zip(base, got):
        if not torch_equal(ra, rb):
            break
        keep = []
        for j, slot in enumerate(ra.tolist()):
            same[slot] = same.get(slot, True) and bool((ta[j] == tb[j]).all())
            if same[slot]:
                keep.append(j)
        if not keep:
            continue
        a, b = la[keep].float(), lb[keep].float()
        check_rows(f"{label} verify launch {n}", b, a, rel=PARITY_TOL)
        n, rows = n + 1, rows + len(keep)
        worst = max(worst, (b - a).abs().max().item())
    check(n > 0, f"{label}: no verify launch held")
    return n, rows, worst


def torch_equal(a, b):
    import torch
    return a.shape == b.shape and torch.equal(a, b)


def phase_spec_tp(spec_rec):
    """Phase 20 (a): minitron-4b at full width with a self-draft through
    its shards (k = SPEC_K).  (a1) 2 layers at tp = 2 and 4 against tp =
    1 (the mesh [cuda:0]): verify logits held, chains equal or split where
    tp = 1's top-two gap lies under the pair's measured logit difference.
    (a2) All 32 layers at tp = 4 on the first ``TP_SPEC_WAVE_REQUESTS``
    of phase 12 (b)'s requests: the counters beside phase 12 (b)'s
    self-draft (tp = 1, the same weights) and its chains, splits counted
    with their gaps and held under its limit as phase 12 (b) holds
    them.  Returns (the records, the launches of (a2))."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.models import transformer
    card0 = torch.device("cuda", 0)
    full = get_config(SPEC_ARCH)
    cfg = dataclasses.replace(full, num_layers=2)
    out = {}
    base, base_rec, rt = tp_spec_run(cfg, [card0], TP_SPEC_PAIR_REQUESTS,
                                     TP_SPEC_PAIR_NEW)
    base_log, params = rt.verify_log, rt.sharded_step.shards[0].params
    del rt
    for tp in (2, 4):
        got, rec, rt = tp_spec_run(cfg, [card0] * tp, TP_SPEC_PAIR_REQUESTS,
                                   TP_SPEC_PAIR_NEW)
        held = hold_verify_logits(f"phase 20 (a1) tp = {tp}", base_log,
                                  rt.verify_log)
        splits = chain_splits(cfg, params, base, got, wave_prompts(
            cfg.vocab_size)[:TP_SPEC_PAIR_REQUESTS])
        check(all(s["gap"] < held[2] for s in splits),
              f"phase 20 (a1) tp = {tp}: a chain splits where tp = 1's "
              f"top-two gap is not under {held[2]}: {splits}")
        out[f"pair_tp{tp}"] = {**rec, "verify_held": held[:2],
                               "verify_max_abs_diff": held[2],
                               "splits": splits}
        print(f"phase 20 (a1) {SPEC_ARCH} 2 layers, self-draft k = "
              f"{SPEC_K}, tp = {tp} over [cuda:0] * {tp} against tp = 1: "
              f"verify logits held on {held[0]} launches ({held[1]} rows), "
              f"largest difference {held[2]:.5f}; "
              f"{TP_SPEC_PAIR_REQUESTS - len(splits)}/"
              f"{TP_SPEC_PAIR_REQUESTS} chains equal, splits {splits}; tp "
              f"= 1 {json.dumps(base_rec)}; tp = {tp} {json.dumps(rec)}")
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    del params, base_log
    torch.cuda.reset_peak_memory_stats()
    chains, rec, rt = tp_spec_run(full, [card0] * 4, TP_SPEC_WAVE_REQUESTS,
                                  40)
    launches = rec["launches"]
    shard_gb = [round(rt.groups[0].draft.shard_bytes(j) / 1e9, 3)
                for j in range(4)]
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    one = spec_rec["self_draft"]
    keys = ("verify_launches", "accepted_tokens", "accepted_per_launch",
            "draft_steps", "decode_steps", "wall_s")
    selfd = {r: SPEC_CHAINS["self_draft"][r] for r in chains}
    params = transformer.init(1, full, "cuda")
    splits = chain_splits(full, params, selfd, chains)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    limit = spec_rec["verify"]["max_abs_diff"]
    under = sum(sp["gap"] < limit for sp in splits)
    check(under == len(splits), f"phase 20 (a2): a chain splits from phase "
          f"12 (b)'s where its top-two gap is not under {limit}: {splits}")
    out["wave_tp4"] = {**rec, "splits": splits,
                       "draft_arena_gb_by_shard": shard_gb,
                       "tp1_16_requests": {k: one[k] for k in keys}}
    n = TP_SPEC_WAVE_REQUESTS
    print(f"phase 20 (a2) {SPEC_ARCH} {full.num_layers} layers, self-draft "
          f"k = {SPEC_K}, {n} requests, tp = 4 over [cuda:0] * 4: "
          + ", ".join(f"{k} {rec[k]:.4g}" for k in keys)
          + f" (phase 12 (b)'s tp = 1 on {SPEC_WAVE_REQUESTS}: "
          + ", ".join(f"{k} {one[k]:.4g}" for k in keys)
          + f"); {n - len(splits)}/{n} chains equal phase 12 (b)'s "
          f"self-draft's; splits (phase 12 (b)'s from its plain run: "
          f"{len(one['splits'])}/{SPEC_WAVE_REQUESTS}), {under} under its "
          f"limit "
          f"{limit}: {splits}; draft arena GB by shard {shard_gb}")
    return out, launches


def ring_runtime(layers, devices, routing=False):
    """mixtral-8x7b at full width and ``layers`` layers over the service
    mesh of ``devices`` at ``RING_MAX_SEQ`` tokens a slot, above its
    4096-token window: the ring layout (per-slot K/V of the window, split
    by kv head), one-shot prefill and the dense-view decode step.  Weights
    from seed 1 (``init_sharded``), ``RING_BS`` slots, request 0 a
    ``RING_LONG``-token prompt (seed 4) and the wave's first 7 after it,
    40 new tokens each.  The decode rows and one-shot logits recorded as
    ``recorded_run`` records them, and with ``routing`` the MoE router
    (``record_routing``).  Returns (cfg, runtime, record)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.launch.serve import plan_for
    from repro_torch.launch.steps import init_sharded, paged_decode_builder
    from repro_torch.serving.engine import GenerationRequest, ServiceRuntime
    full = get_config(RING_ARCH)
    cfg = dataclasses.replace(full, num_layers=layers)
    mesh = tp_mesh(devices)
    rt = ServiceRuntime(cfg, None, plan_for(full, -1, RING_BS, -1),
                        device=devices[0], max_seq_len=RING_MAX_SEQ,
                        paged_step_builder=paged_decode_builder(
                            mesh, shards=init_sharded(1, cfg, mesh)))
    check(rt.ring_fallback and rt.sharded_step.dense
          and not rt.chunked_prefill,
          "phase 20 (b): mixtral-8x7b is not on the ring layout")
    prompts = [np.random.default_rng(4).integers(
        0, cfg.vocab_size, RING_LONG).astype(np.int32)]
    prompts += wave_prompts(cfg.vocab_size)[:RING_REQUESTS - 1]
    rec = {"decodes": record_decodes(rt, range(RING_REQUESTS)),
           "final": keep_oneshot_logits(rt), "drops": None, "routing": None}
    if routing:
        rec["routing"], rec["restore"] = record_routing(rt, len(devices))
    for rid, prompt in enumerate(prompts):
        rt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                    max_new_tokens=40, stream=rid))
    torch.cuda.synchronize()
    return cfg, rt, rec


def keep_oneshot_logits(rt):
    """Wraps ``rt``'s one-shot admissions through its sharded step to keep
    each request's prefill logits; returns the dict they go into."""
    final, cur = {}, [None]
    admit, prefill = rt._admit_one, rt.sharded_step.prefill

    def admitted(req, *a, **kw):
        cur[0] = req.rid
        return admit(req, *a, **kw)

    def prefilled(batch, cache_size):
        logits, caches = prefill(batch, cache_size)
        final[cur[0]] = logits[0].clone()
        return logits, caches

    rt._admit_one, rt.sharded_step.prefill = admitted, prefilled
    return final


def ring_run(layers, devices, routing=False):
    """Drains ``ring_runtime``: (record with chains, wall and launches,
    runtime); every kernel of the path launched ``tp`` times a layer a
    step (#7 a one-shot prefill, #5 a decode step, #9 three times each)."""
    from repro_torch.kernels.ops import launch_counts
    cfg, rt, rec = ring_runtime(layers, devices, routing)
    c0 = launch_counts()
    try:
        rec["chains"], rec["wall"] = run_steps(rt)
    finally:
        if "restore" in rec:
            rec.pop("restore")()
    rec["launches"] = {k: v - c0[k] for k, v in launch_counts().items()
                       if v - c0[k]}
    check(len(rec["chains"]) == RING_REQUESTS and all(
        len(t) == 40 and t.min() >= 0 and t.max() < cfg.vocab_size
        for t in rec["chains"].values()),
          f"phase 20 (b) served {rec['chains']}")
    tp, L = len(devices), cfg.num_layers
    n1, n2 = rt.oneshot_prefills, rt.decode_steps
    want = {"flash_attention": tp * L * n1, "decode_attention": tp * L * n2,
            "grouped_matmul": 3 * tp * L * (n1 + n2)}
    have = {k: rec["launches"].get(k, 0) for k in want}
    check(n1 == RING_REQUESTS and have == want,
          f"phase 20 (b) tp = {tp}: launches {have} are not {tp} a layer a "
          f"step {want} ({n1} one-shot prefills)")
    return rec, rt


def phase_ring_tp():
    """Phase 20 (b): mixtral-8x7b past its window split by heads.  (b1) 2
    layers at tp = 4 against tp = 1 (the mesh [cuda:0]), held by
    ``compare_runs`` (the one-shot logits, first tokens, decode rows and
    the router's inputs); the dense-view step's ``decode_cost_analysis``
    at tp = 4 against tp = 1's (kernel FLOPs equal).  (b2) ``RING_DEPTH``
    layers at tp = 4: served, first tokens, launches and the ring's bytes
    a shard (at depth a rounding-level change splits mixtral's chains:
    phase 18, ``--tp-floor``; a tp = 1 run beside it was cut for the
    script's time limit).  Returns (records, the launches of (b1) and
    (b2) at tp = 4)."""
    import torch
    card0 = torch.device("cuda", 0)
    runs, costs = {}, {}
    for tp in (1, 4):
        rec, rt = ring_run(TP_PARITY_LAYERS, [card0] * tp, routing=True)
        costs[tp] = rt.decode_cost_analysis()
        rec["decode_steps"] = rt.decode_steps
        runs[tp] = rec
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    launches = dict(runs[4]["launches"])
    cmp = compare_runs(f"phase 20 (b1) {RING_ARCH} {TP_PARITY_LAYERS} "
                       f"layers tp = 4", runs[1], runs[4])
    out = {"b1": {"compare": cmp,
                  "wall_s": [runs[1]["wall"], runs[4]["wall"]],
                  "decode_steps": runs[4]["decode_steps"],
                  "launches_tp4": runs[4]["launches"]}}
    print(f"phase 20 (b1) {RING_ARCH} {TP_PARITY_LAYERS} layers at "
          f"--max-seq-len {RING_MAX_SEQ} (request 0 a {RING_LONG}-token "
          f"prompt), {RING_BS} slots, tp = 4 over [cuda:0] * 4 against tp "
          f"= 1, held: {json.dumps(out['b1'])}")
    check(costs[4]["kernel_flops"] == costs[1]["kernel_flops"]
          and costs[4]["kernel_calls"]["decode_attention"]
          == 4 * costs[1]["kernel_calls"]["decode_attention"],
          f"phase 20 (d) the ring's dense-view step at tp = 4 {costs[4]} is "
          f"not tp = 1's {costs[1]} split")
    print(f"phase 20 (d) decode_cost_analysis of (b)'s dense-view step at "
          f"{TP_PARITY_LAYERS} layers: tp = 1 {json.dumps(costs[1])}; tp = 4 "
          f"{json.dumps(costs[4])}; kernel FLOPs equal")
    del runs
    rec, rt = ring_run(RING_DEPTH, [card0] * 4)
    arena = rt.groups[0].arena
    out["b2"] = {"served": len(rec["chains"]),
                 "first_tokens": [int(rec["chains"][r][0])
                                  for r in sorted(rec["chains"])],
                 "wall_s": rec["wall"], "decode_steps": rt.decode_steps,
                 "oneshot_prefills": rt.oneshot_prefills,
                 "launches": rec["launches"],
                 "ring_gb_by_shard": [round(arena.shard_bytes(j) / 1e9, 3)
                                      for j in range(4)]}
    for k, v in rec["launches"].items():
        launches[k] = launches.get(k, 0) + v
    print(f"phase 20 (b2) {RING_ARCH} {RING_DEPTH} layers, tp = 4 over "
          f"[cuda:0] * 4: {json.dumps(out['b2'])}")
    del rt, arena
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def phase_oracle_tp():
    """Phase 20 (c): minicpm-2b at 2 layers, bf16 K/V, ``ORACLE_BS``
    slots, tp = 4 over [cuda:0] * 4, the ``paged_native=False`` oracle
    (dense views of each shard's pools, #5 and #6) against the native
    step (#1 and #3), held by ``compare_runs``.  Returns (record, the
    oracle's launches)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.launch.serve import plan_for
    from repro_torch.launch.steps import init_sharded, paged_decode_builder
    from repro_torch.serving.engine import GenerationRequest, ServiceRuntime
    card0 = torch.device("cuda", 0)
    full = get_config("minicpm-2b")
    cfg = dataclasses.replace(full, num_layers=TP_PARITY_LAYERS)
    runs, rts = {}, {}
    for native in (True, False):
        mesh = tp_mesh([card0] * 4)
        rt = ServiceRuntime(cfg, None, plan_for(full, "bf16", ORACLE_BS, 0),
                            device=card0, paged_native=native,
                            paged_step_builder=paged_decode_builder(
                                mesh, shards=init_sharded(1, cfg, mesh)))
        check(rt.sharded_step.dense != native, "phase 20 (c): the oracle "
              "is not on the dense-view step")
        for rid, p in enumerate(wave_prompts(cfg.vocab_size)[
                :TP_FAMILY_REQUESTS]):
            rt.submit(GenerationRequest(rid=rid, tokens=p,
                                        max_new_tokens=TP_FAMILY_NEW,
                                        stream=rid))
        runs[native] = recorded_run(rt)
        runs[native]["steps"] = (rt.decode_steps, rt.prefill_chunk_calls)
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    steps, chunks = runs[False]["steps"]
    L, tp = cfg.num_layers, 4
    want = {"decode_attention": tp * L * steps,
            "chunk_prefill_attention": tp * L * chunks}
    have = {k: runs[False]["launches"].get(k, 0) for k in want}
    check(have == want, f"phase 20 (c): the oracle's launches {have} are "
          f"not {tp} a layer a step {want}")
    cmp = compare_runs("phase 20 (c) minicpm-2b oracle tp = 4", runs[True],
                       runs[False])
    identical = all(torch.equal(runs[True]["final"][r],
                                runs[False]["final"][r])
                    for r in runs[True]["final"])
    print(f"phase 20 (c) minicpm-2b {L} layers, bf16, {ORACLE_BS} slots, tp "
          f"= 4: the paged_native=False oracle against the native step: "
          f"{json.dumps(cmp)}; final-chunk logits identical: {identical}; "
          f"oracle launches {json.dumps(runs[False]['launches'])}")
    return cmp, runs[False]["launches"]


def tp_path_kernel_cases():
    """#3, #5 and #7 at phase 20's tp = 4 shard shapes against their plain
    versions (held inside each case), timed beside their bounds and SDPA:
    #3 at the verify launch (``verify_cases``' 512 slots, T = 5, 32
    speculating), #5 over a full 4096-row ring of ``RING_BS`` slots (and
    the unsharded ring's 32 on 8 heads beside it), #7 over a
    ``RING_LONG``-row prompt with the 4096 window."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    rng = np.random.default_rng(20)
    T = SPEC_K + 1
    start = rng.integers(0, 256 - T + 1, 512)
    spec = np.zeros(512, np.int32)
    spec[::16] = T
    out = {"paged_chunk_prefill_attention@minitron_tp4_verify": chunk_case(
        gen, rng, B=512, T=T, start=start, chunk_len=spec, prefix_len=0,
        quant=False, timed=True, **TP_PATH_SHAPES["verify"])}
    ring = TP_PATH_SHAPES["ring"]
    out["decode_attention@mixtral_tp4_ring"] = dense_decode_case(
        gen, B=RING_BS, S=4096, lens=np.full(RING_BS, 4096), timed=True,
        **ring)
    # the unsharded ring (32 query on 8 kv heads), beside the shard's
    out["decode_attention@mixtral_tp1_ring"] = dense_decode_case(
        gen, B=RING_BS, S=4096, lens=np.full(RING_BS, 4096), timed=True,
        Hq=4 * ring["Hq"], Hkv=4 * ring["Hkv"], D=ring["D"])
    out["flash_attention@mixtral_tp4_oneshot"] = flash_case(
        gen, B=1, Lq=RING_LONG, Lk=RING_LONG, causal=True, window=4096,
        timed=True, **ring)
    torch.cuda.empty_cache()
    for name, rec in out.items():
        print(f"  phase 20 (d) {name}: "
              + json.dumps({k: v for k, v in rec.items() if k != "work"}))
    return out


def phase_tp_paths(spec_rec):
    """Phase 20: (a) speculation, (b) the ring and (c) the dense-view
    oracle split by heads over ``[cuda:0] * tp``; (d) every kernel of
    their paths launched ``tp`` times a layer a step (held in each part),
    the ring's ``decode_cost_analysis``, and #3, #5 and #7 at the shards'
    shapes.  Every count is zeroed just before the phase and read after
    (c), before (d)'s kernel comparisons.  Returns the counts."""
    from repro_torch.kernels.ops import launch_counts
    reset_launches()
    rec = {"spec": phase_spec_tp(spec_rec)[0]}
    rec["ring"] = phase_ring_tp()[0]
    rec["oracle"] = phase_oracle_tp()[0]
    counts = launch_counts()
    print("phase 20 (d) the kernels at the shards' shapes:")
    tp_path_kernel_cases()
    return counts


def across_cards():
    """``python3 chip_smoke.py --across-cards`` on a machine with four
    cards: phase 17's minicpm-2b wave at tp = 4 over cuda:0-3 against the
    same wave over ``[cuda:0] * 4`` (chains and logits), the launcher's
    (1, 4) service mesh, mistral-large-123b (246 GB of bf16 weights)
    drawn shard by shard over the four cards by ``init_sharded`` and
    served without the whole tree, plain and with a self-draft, and
    mixtral-8x7b at all 32 layers past its window
    (``across_cards_paths``); then the MoE, SSM, audio, hybrid and VLM
    families (``across_cards_families``).  Returns the exit code."""
    import torch
    from repro_torch.launch import serve
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    check(len(cards) >= 4, f"--across-cards needs 4 cards, found {len(cards)}")
    peaks = lambda: [round(torch.cuda.max_memory_allocated(d) / 1e9, 2)
                     for d in cards]
    t0 = time.perf_counter()
    one, st_one, rt = tp_wave("minicpm-2b", "int8", TP_REQUESTS,
                              devices=[cards[0]] * 4)
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    four, st_four, rt = tp_wave("minicpm-2b", "int8", TP_REQUESTS,
                                devices=cards[:4])
    held = hold_tp_logits("across cards, minicpm-2b tp = 4", st_one,
                          st_four)
    same = sum(np.array_equal(one[r], four[r]) for r in one)
    check(same == len(one), f"across cards: {same}/{len(one)} chains equal")
    print(f"across cards (a) minicpm-2b tp = 4 over cuda:0-3 against "
          f"[cuda:0] * 4: {same}/{len(one)} chains equal, logits held on "
          f"{held[0]} steps, worst {held[2]} of the limit; decode step "
          f"median (CUDA events) one card "
          f"{statistics.median([s[3] for s in st_one]):.3f} ms, 4 cards "
          f"{statistics.median([s[3] for s in st_four]):.3f} ms; "
          f"{rt.sharded_step.mesh.reduce_calls} reductions "
          f"({rt.sharded_step.mesh.reduce_bytes / 1e9:.3f} GB); peak GB "
          f"by card {peaks()}; {time.perf_counter() - t0:.1f} s")
    del rt, st_one, st_four
    gc.collect()
    torch.cuda.empty_cache()
    rc = serve.main(["--pjit-decode", "--requests", "8",
                     "--max-new-tokens", "8"])
    check(rc == 0, f"the launcher on the (1, 4) mesh exited {rc}")
    print("across cards (b) the launcher with --pjit-decode on the (1, 4) "
          "mesh: exit 0")
    gc.collect()
    torch.cuda.empty_cache()
    across_cards_paths(cards[:4])
    across_cards_families(cards[:4])
    return 0


def across_cards_paths(cards):
    """``--across-cards`` (c), (g) and (h), and all of
    ``--across-cards-paths`` ((i): ``across_cards_oneshot``): (c)
    mistral-large-123b (246 GB of bf16
    weights) drawn shard by shard over the four cards by ``init_sharded``
    and served without the whole tree, 4 requests at 32 slots; (g) the
    same shards with a self-draft through them (k = 4, its draft arena
    split over the cards): served, verify launches, accepted tokens a
    launch, draft steps, peak memory by card; (h) mixtral-8x7b at all 32
    layers over the four cards at ``--max-seq-len`` 8192, over its
    4096-token window (the ring: one-shot prefill and the dense-view
    step), ``ACROSS_RING_BS`` slots, request 0 an ``ACROSS_RING_LONG``-token
    prompt and the wave's first 7 after it: served, the ring's bytes and
    peak memory by card."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import serve
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.launch.steps import init_sharded, paged_decode_builder
    from repro_torch.serving.engine import (SELF_DRAFT, GenerationRequest,
                                            ServiceRuntime)
    peaks = lambda: [round(torch.cuda.max_memory_allocated(d) / 1e9, 2)
                     for d in cards]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    cfg = get_config("mistral-large-123b")
    mesh = meshlib.make_mesh((1, 4), ("data", "model"), cards)
    t0 = time.perf_counter()
    shards = init_sharded(1, cfg, mesh)
    held_gb = [round(torch.cuda.memory_allocated(d) / 1e9, 2)
               for d in cards]
    for label, kw in (("(c)", {}), ("(g)", {"draft_params": SELF_DRAFT})):
        rt = ServiceRuntime(cfg, None, serve.plan_for(cfg, bs=32),
                            device=cards[0],
                            paged_step_builder=paged_decode_builder(
                                mesh, shards=shards), **kw)
        new = 16 if not kw else 32
        for rid, p in enumerate(wave_prompts(cfg.vocab_size)[:4]):
            rt.submit(GenerationRequest(rid=rid, tokens=p,
                                        max_new_tokens=new, stream=rid))
        t1 = time.perf_counter()
        results = rt.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        toks = [r.tokens.tolist() for r in results]
        check(len(results) == 4 and all(
            len(t) == new and min(t) >= 0 and max(t) < cfg.vocab_size
            for t in toks), f"mistral-large-123b {label} served {toks}")
        ver = rt.verify_launches
        spec = "" if not kw else (
            f"self-draft k = {rt.speculate_k}: {ver} verify launches, "
            f"{rt.accepted_tokens} tokens accepted "
            f"({rt.accepted_tokens / max(ver, 1):.2f}/launch), "
            f"{rt.draft_steps} draft steps, {rt.spec_degraded} degraded, "
            f"draft arena GB by card "
            f"{[round(rt.groups[0].draft.shard_bytes(j) / 1e9, 3) for j in range(4)]}; ")
        if kw:
            check(ver > 0 and rt.sharded_draft is rt.sharded_step,
                  "mistral-large-123b (g): the self-draft did not verify")
        print(f"across cards {label} mistral-large-123b over 4 cards "
              f"(init_sharded, no whole tree), 32 slots, bf16 K/V: weights "
              f"GB by card {held_gb}; served {len(results)}/4, "
              f"{sum(map(len, toks))} tokens in {dt:.2f} s, "
              f"{rt.decode_steps} decode steps, {rt.prefill_chunk_calls} "
              f"chunks; {spec}peak GB by card {peaks()}; "
              f"{time.perf_counter() - t0:.1f} s with the draws")
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    del shards
    gc.collect()
    torch.cuda.empty_cache()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    full = get_config(RING_ARCH)
    cfg = dataclasses.replace(full, num_layers=full.num_layers)
    rt = ServiceRuntime(cfg, None, serve.plan_for(full, -1, ACROSS_RING_BS,
                                                  -1),
                        device=cards[0], max_seq_len=ACROSS_RING_SEQ,
                        paged_step_builder=paged_decode_builder(
                            mesh, shards=init_sharded(1, cfg, mesh)))
    check(rt.ring_fallback and rt.sharded_step.dense,
          "mixtral-8x7b (h) is not on the ring layout")
    prompts = [np.random.default_rng(4).integers(
        0, cfg.vocab_size, ACROSS_RING_LONG).astype(np.int32)]
    prompts += wave_prompts(cfg.vocab_size)[:RING_REQUESTS - 1]
    for rid, p in enumerate(prompts):
        rt.submit(GenerationRequest(rid=rid, tokens=p, max_new_tokens=40,
                                    stream=rid))
    chains, wall = run_steps(rt)
    check(len(chains) == RING_REQUESTS and all(
        len(t) == 40 and t.min() >= 0 and t.max() < cfg.vocab_size
        for t in chains.values()), f"mixtral-8x7b (h) served {chains}")
    arena = rt.groups[0].arena
    print(f"across cards (h) mixtral-8x7b, all {cfg.num_layers} layers, over "
          f"4 cards at --max-seq-len {ACROSS_RING_SEQ} (request 0 a "
          f"{ACROSS_RING_LONG}-token prompt), {arena.capacity} slots: served "
          f"{len(chains)}/{RING_REQUESTS}, {rt.oneshot_prefills} one-shot "
          f"prefills, {rt.decode_steps} decode steps in {wall:.2f} s; ring "
          f"GB by card {[round(arena.shard_bytes(j) / 1e9, 3) for j in range(4)]}"
          f" ({arena.shard_bytes(0) / arena.capacity / 1e9:.4f} a slot); "
          f"peak GB by card {peaks()}; {time.perf_counter() - t0:.1f} s "
          f"with the draws")
    del rt, arena
    gc.collect()
    torch.cuda.empty_cache()
    across_cards_oneshot(cards)


def across_cards_oneshot(cards):
    """``--across-cards-paths`` (i): mamba2-2.7b's and whisper-large-v3's
    plans at their 512 slots (87 GB and 126 GB of per-slot state, which
    one card cannot hold) with one-shot prefill (``--no-chunked-prefill``)
    split by heads over the four cards, from ``init_sharded``: served,
    each card's per-slot state and peak memory."""
    import torch
    for arch in ("mamba2-2.7b", "whisper-large-v3"):
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        chains, _, rt = family_run(arch, cards, bs=FULL_PLANS[arch][1],
                                   chunked_prefill=False)
        arena = rt.groups[0].arena
        check(rt.oneshot_prefills == TP_FAMILY_REQUESTS
              and rt.prefill_chunk_calls == 0,
              f"across cards (i) {arch}: {rt.oneshot_prefills} one-shot "
              f"prefills, {rt.prefill_chunk_calls} chunks")
        state = [sum(t.numel() * t.element_size() for t in st)
                 for st in arena.shard_state]
        gb = lambda xs: [round(x / 1e9, 2) for x in xs]
        print(f"across cards (i) {arch} at its plan's {arena.capacity} "
              f"slots, one-shot prefill, over 4 cards: served "
              f"{len(chains)}/{TP_FAMILY_REQUESTS}, {rt.oneshot_prefills} "
              f"one-shot prefills, {rt.decode_steps} decode steps in "
              f"{rt.wall_s:.2f} s; GB by card: per-slot state {gb(state)}, "
              f"peak {gb(torch.cuda.max_memory_allocated(d) for d in cards)}"
              f"; {time.perf_counter() - t0:.1f} s with the draws")
        del rt, arena, chains
        gc.collect()
        torch.cuda.empty_cache()


def family_run(arch, devices, **kw):
    """``tp_family_runtime``'s wave of ``arch`` over ``devices`` (its first
    ``TP_FAMILY_REQUESTS`` requests) drained with every decode step
    recorded; returns (chains, decode records, runtime)."""
    cfg, rt = tp_family_runtime(arch, devices, TP_FAMILY_REQUESTS,
                                new_tokens=TP_FAMILY_NEW, **kw)
    rec = record_decodes(rt, range(TP_FAMILY_REQUESTS))
    chains, wall = run_steps(rt)
    check(len(chains) == TP_FAMILY_REQUESTS and all(
        len(t) == TP_FAMILY_NEW and t.min() >= 0
        and t.max() < cfg.vocab_size
        for t in chains.values()), f"{arch} over {devices}: served {chains}")
    rt.wall_s = wall
    return chains, rec, rt


# each family's full plan over four cards (``across_cards_families`` (e)):
# its layers (None: all) and slots
FULL_PLANS = {"mixtral-8x7b": (32, 512), "mamba2-2.7b": (None, 512),
              "whisper-large-v3": (None, 512), "zamba2-7b": (None, 256)}


def across_cards_families(cards, archs=None):
    """``--across-cards``, the MoE, SSM, audio, hybrid and VLM families
    (``archs``, default all five): (d) phase 18's waves at tp = 4 over
    cuda:0-3 against the same waves over ``[cuda:0] * 4`` (chains and
    every recorded logits row bit for bit); (e) each family of
    ``FULL_PLANS`` at its full plan split over the four cards,
    mixtral-8x7b at all 32 layers from ``init_sharded`` at phase 6's 512
    slots, mamba2-2.7b and whisper-large-v3 at their plans' 512 slots,
    zamba2-7b at its plan's 256, each card's weights, per-slot state and
    pool bytes and its peak memory; (f) the launcher with
    ``--pjit-decode`` serving mamba2-2.7b on the (1, 4) mesh."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import moe
    card0 = cards[0]
    archs = archs or (*TP_FAMILIES, *TP_NEW_FAMILIES)
    spread = lambda a: TP_NEW_FAMILIES.get(a, {}).get("spread", 32)
    for arch in archs:
        t0 = time.perf_counter()
        runs = []
        for devices in ([card0] * 4, cards):
            chains, rec, rt = family_run(arch, devices, spread=spread(arch))
            runs.append((chains, rec, rt.wall_s, rt.decode_steps))
            del rt
            gc.collect()
            torch.cuda.empty_cache()
        (one, rec1, w1, n1), (four, rec4, w4, n4) = runs
        same = all(np.array_equal(one[r], four[r]) for r in one)
        rows = all(len(rec1[r]) == len(rec4[r]) and all(
            a[1] == b[1] and torch.equal(a[2], b[2].to(a[2].device))
            for a, b in zip(rec1[r], rec4[r])) for r in rec1)
        check(same and rows, f"across cards, {arch}: cuda:0-3 is not "
              f"[cuda:0] * 4 bit for bit (chains {same}, logits {rows})")
        print(f"across cards (d) {arch} tp = 4 over cuda:0-3 against "
              f"[cuda:0] * 4: chains and every decode row's logits equal bit "
              f"for bit; wall {w4:.3f} vs {w1:.3f} s ({n4} decode steps); "
              f"{time.perf_counter() - t0:.1f} s")
    for arch, (layers, slots) in FULL_PLANS.items():
        if arch not in archs:
            continue
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        moe.MOE_DROP_STATS.flush()
        chains, _, rt = family_run(arch, cards, layers=layers, bs=slots,
                                   spread=spread(arch))
        arena = rt.groups[0].arena
        weights = [sum(t.numel() * t.element_size()
                       for t in tree_leaves(sh.params))
                   for sh in rt.sharded_step.shards]
        state = [sum(t.numel() * t.element_size() for t in st)
                 for st in arena.shard_state]
        pools = [arena.shard_bytes(j) - state[j]
                 for j in range(len(cards))]
        gb = lambda xs: [round(x / 1e9, 2) for x in xs]
        print(f"across cards (e) {arch} at its full plan ({rt.cfg.num_layers}"
              f" layers, {arena.capacity} slots, {rt.kv_dtype} K/V) over 4 "
              f"cards: served {len(chains)}/{TP_FAMILY_REQUESTS}, "
              f"{rt.decode_steps} decode steps, {rt.prefill_chunk_calls} "
              f"chunks in {rt.wall_s:.2f} s; GB by card: weights "
              f"{gb(weights)}, per-slot state {gb(state)}, pools and "
              f"lengths {gb(pools)}, peak "
              f"{gb(torch.cuda.max_memory_allocated(d) for d in cards)}; "
              f"{time.perf_counter() - t0:.1f} s with the draws")
        del rt, arena, chains
        gc.collect()
        torch.cuda.empty_cache()
    if "mamba2-2.7b" not in archs:
        return
    rc = serve.main(["--pjit-decode", "--archs", "mamba2-2.7b",
                     "--requests", "8", "--max-new-tokens", "8"])
    check(rc == 0, f"the launcher, mamba2-2.7b on the (1, 4) mesh, exited "
          f"{rc}")
    print("across cards (f) the launcher with --pjit-decode, mamba2-2.7b's "
          "512-slot plan on the (1, 4) mesh: exit 0")


def small_input_check():
    """The models on the card (CUDA kernels) against the same models and
    weights on the CPU (plain versions), in bf16 at a reduced width: one
    ragged chunked-prefill call and two decode steps each, for minicpm-2b
    (head dim 64, bf16 and int8 pools), mamba2-2.7b (P = N = 16),
    whisper-large-v3 (head dim 64, encoder_len 64, int8 pools) and
    mixtral-8x7b (head dim 64, 4 experts, bf16 pools), and one MoE layer
    of it with a random router.  The
    two devices round bf16 matrix products differently, so logits agree to
    2**-6 of the largest logit's magnitude (about two bf16 steps
    there)."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.quant import QuantPages
    from repro_torch.models import transformer
    cfg = reduced(get_config("minicpm-2b"), head_dim=64)
    params = transformer.init(3, cfg, "cpu")
    B, nblk, bs = 2, 4, 32
    P1 = B * nblk + 1
    tables = torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk)
    rng = np.random.default_rng(4)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 32)))
    errs = {}
    for quant in (False, True):
        outs = {}
        for dev in ("cpu", "cuda"):
            p = tree_to(params, dev)
            shape = (cfg.num_layers, P1, bs, cfg.num_kv_heads, cfg.head_dim)
            if quant:
                pools = {n: QuantPages(
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.ones(shape[:-1], device=dev)) for n in "kv"}
            else:
                pools = {n: torch.zeros(shape, dtype=torch.bfloat16,
                                        device=dev) for n in "kv"}
            bt = tables.to(dev)
            cl = torch.tensor([32, 19], dtype=torch.int32, device=dev)
            logits = []
            lg, cache = transformer.prefill_chunk_paged(
                p, cfg, {"tokens": chunk.to(dev)},
                {**pools, "len": torch.zeros(B, dtype=torch.int32,
                                             device=dev)}, bt,
                chunk_len=cl, block_size=bs)
            logits.append(lg.float().cpu())
            live = torch.tensor([True, True], device=dev)
            for step in range(2):
                tok = torch.tensor([7 + step, 11 + step], device=dev)
                lg, cache = transformer.decode_step_paged(
                    p, cfg, tok, cache, bt, live, block_size=bs)
                logits.append(lg.float().cpu())
            outs[dev] = torch.stack(logits)
        errs["int8" if quant else "bf16"] = compare_logits(outs)
    errs["mamba2"] = compare_logits(small_mamba2())
    errs["whisper"] = compare_logits(small_whisper())
    # phase 6's runtime turned the process-wide drop counter on; these
    # direct calls switch devices outside any step and read no drops
    from repro_torch.models import moe
    moe.enable_drop_counter(False)
    errs["mixtral"] = compare_logits(small_mixtral())
    errs["mixtral_moe_layer"] = compare_logits(small_moe_layer())
    for arch, seed in (("minicpm-2b", 21), ("mixtral-8x7b", 22),
                       ("whisper-large-v3", 23)):
        errs[f"{arch} dense steps"] = compare_logits(
            small_dense_steps(arch, seed))
    errs["mixtral-8x7b ring"] = compare_logits(small_ring())
    errs["mamba2-2.7b one-shot prefill"] = compare_logits(
        small_ssm_prefill())
    print(f"small-input check: card vs CPU logits (max |diff|, "
          f"tolerance) {errs}")
    print(f"small-input check: sync-mode wave, card vs CPU greedy tokens "
          f"agree at {small_sync_wave()} of the positions")
    small_train_step()
    small_train_families()


def small_train_step():
    """One training step's loss and gradients of reduced minicpm-2b with
    head dim 64, in bf16, on the card (flash kernels) and on the CPU (plain
    versions), from the same weights and batch.  The devices round bf16 at
    other places (the matrix products, the forward kernel's output), so
    the loss agrees to 2**-7 of itself, the grad norm to 2**-5 of itself,
    and each leaf's gradient to 2**-6 of its largest magnitude (on the CPU
    the bf16 step differs from the same step in f32 by at most 2.7e-4 of
    the loss, 6e-5 of the norm and 1.1e-2 of a leaf's largest gradient:
    the logits are of the order of 100, where a bf16 step is 0.5).  The
    attention's gradients alone are held tighter by
    ``small_attention_grads``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer
    cfg = reduced(get_config("minicpm-2b"), head_dim=64)
    rng = np.random.default_rng(12)
    hold_train_step("one train step", cfg, transformer.init(11, cfg, "cpu"),
                    rng.integers(0, cfg.vocab_size, (2, 65)))
    small_attention_grads()


# the five other families' reduced archs (2 layers; head dim 64, zamba2's
# 112 so that the flash backward's D = 112 instance runs), with the seeds
# of their weights
SMALL_TRAIN_FAMILIES = (("mamba2-2.7b", {}, 31),
                        ("whisper-large-v3", dict(head_dim=64), 32),
                        ("paligemma-3b", dict(head_dim=64), 33),
                        ("zamba2-7b", dict(head_dim=112), 34),
                        ("mixtral-8x7b", dict(head_dim=64), 35))


def small_train_families():
    """``small_train_step`` for each other family's reduced arch
    (``SMALL_TRAIN_FAMILIES``), in bf16, card vs CPU, at its limits: the
    grouped GEMM (forward, dX and dW) and the SSD scan (forward; the
    backward's plain recompute) run under autograd on the card, and the
    flash pair over whisper's encoder, cross and decoder masks,
    paligemma's prefix and zamba2's D = 112.  The audio and VLM batches
    carry random frame or image embeddings.  mixtral's router weights are
    zeros, as in ``small_mixtral``: every token then routes to experts 0
    and 1 on both devices (and past capacity is dropped on both), where a
    random router's near ties would let the devices' bf16 roundings pick
    other experts; the router's own gradient still flows.  The loss and
    the grad norm are held to ``small_train_step``'s limits, each leaf's
    gradient to 2**-4 of its largest magnitude, not 2**-6: these leaves'
    gradients are sums with cancellation (norm weights, the SSD's dt_bias
    and A_log, the conv, a mixed-in embedding), so two bf16 roundings of
    one step part by more.  On the CPU alone the bf16 step differs from
    the same step in f32 by up to 0.045 of a leaf's largest gradient
    (mamba2's dt_bias; zamba2 0.024, mixtral 0.019, whisper 0.014,
    paligemma 0.011), where minicpm-2b's differs by 0.011."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import model_api
    for arch, over, seed in SMALL_TRAIN_FAMILIES:
        cfg = reduced(get_config(arch), **over)
        params = model_api(cfg).init(seed, cfg, "cpu")
        if cfg.family == "moe":
            params["blocks"]["moe"]["router"].zero_()
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab_size, (2, 65))
        rows = {"audio": cfg.encoder_len, "vlm": cfg.prefix_len}.get(
            cfg.family)
        emb = (None if rows is None else
               rng.standard_normal((2, rows, cfg.d_model), dtype=np.float32))
        hold_train_step(f"one {arch} train step", cfg, params, tokens, emb,
                        leaf_tol=2 ** -4)


def hold_train_step(label, cfg, params, tokens, embeddings=None,
                    leaf_tol=2 ** -6):
    """One ``value_and_grad`` of ``make_loss_fn(cfg)`` on the CPU and on the
    card from the same weights (a CPU tree) and batch (tokens (B, L + 1),
    shifted into tokens and labels; ``embeddings`` (B, rows, d) or None),
    held to ``small_train_step``'s limits, each leaf's gradient to
    ``leaf_tol`` of its largest magnitude; the card's launches must equal
    ``train_launches`` of one microbatch."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.training import train_step
    from repro_torch.training.tree import tree_paths
    toks = torch.from_numpy(tokens)
    loss_fn = train_step.make_loss_fn(cfg)
    outs = {}
    for dev in ("cpu", "cuda"):
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        if embeddings is not None:
            batch["embeddings"] = torch.from_numpy(embeddings).to(
                cfg.compute_dtype).to(dev)
        before = launch_counts()
        (loss, _), grads = train_step.value_and_grad(
            loss_fn, tree_to(params, dev), batch)
        grown = {n: c - before[n] for n, c in launch_counts().items()}
        if dev == "cuda":
            want = dict.fromkeys(grown, 0)
            want.update(train_launches(cfg, 1))
            check(grown == want, f"{label}: the card launched {grown}, "
                  f"not {want}")
        flat = {k: g.float().cpu() for k, g in tree_paths(grads).items()}
        norm = torch.sqrt(sum(g.square().sum() for g in flat.values()))
        outs[dev] = (loss.item(), norm.item(), flat)
    (l_cpu, n_cpu, g_cpu), (l_gpu, n_gpu, g_gpu) = outs["cpu"], outs["cuda"]
    check(np.isfinite([l_gpu, n_gpu]).all(), f"{label}: non-finite on card")
    check(abs(l_gpu - l_cpu) <= 2 ** -7 * abs(l_cpu),
          f"{label}: card vs CPU loss {l_gpu} vs {l_cpu}")
    check(abs(n_gpu - n_cpu) <= 2 ** -5 * n_cpu,
          f"{label}: card vs CPU grad norm {n_gpu} vs {n_cpu}")
    worst, rel_l2 = 0.0, {}
    for key, g in g_cpu.items():
        err = (g_gpu[key] - g).abs().max().item()
        scale = g.abs().max().item()
        check(err <= leaf_tol * scale,
              f"{label}: card vs CPU gradient of {key}: {err} > {leaf_tol} "
              f"* {scale}")
        worst = max(worst, err / max(scale, 1e-30))
        rel_l2[key] = ((g_gpu[key] - g).norm() / g.norm()).item()
    print(f"small-input check: {label}, card vs CPU: loss {l_gpu} vs "
          f"{l_cpu}, grad norm {n_gpu} vs {n_cpu}, worst leaf max |diff| / "
          f"max |grad| {worst}, each leaf's |diff| / |grad| {rel_l2}")


def small_attention_grads():
    """The gradients of one attention layer of reduced minicpm-2b (head
    dim 64, bf16, 2 x 200 tokens: ragged tiles, rope) on the card (the
    flash kernels, through autograd in the model's layout) against the
    same layer, weights and inputs on the CPU (the plain versions).  With
    no deep chain of bf16 roundings between them, each weight's gradient
    agrees to 1e-2 of its norm and the input's gradient at every position
    to ``check_rows``'s limit: the projections round to bf16 in another
    order, and the kernels round P and dS to bf16 where the plain versions
    do."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models import layers, transformer
    cfg = reduced(get_config("minicpm-2b"), head_dim=64)
    attn = {k: w[0] for k, w in transformer.init(
        13, cfg, "cpu")["blocks"]["attn"].items()}
    rng = np.random.default_rng(14)
    x0, dout = (torch.from_numpy(rng.standard_normal(
        (2, 200, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
        for _ in range(2))
    grads = {}
    for dev in ("cpu", "cuda"):
        p = {k: w.detach().to(dev).requires_grad_(True)
             for k, w in attn.items()}
        x = x0.detach().to(dev).requires_grad_(True)
        before = launch_counts()
        out, _ = layers.attention_with_kv(p, cfg, x)
        out.backward(dout.to(dev))
        grown = {n: c - before[n] for n, c in launch_counts().items()}
        if dev == "cuda":
            check(grown["flash_attention"] == 1
                  and grown["flash_attention_bwd"] == 1,
                  f"the card's attention layer launched {grown}")
        grads[dev] = {"x": x.grad, **{k: w.grad for k, w in p.items()}}
    rel = {}
    for key, g in grads["cpu"].items():
        got = grads["cuda"][key].float().cpu()
        check(bool(torch.isfinite(got).all()), f"non-finite d{key}")
        if key == "x":
            rel.update(check_rows("dx", got, g))
            continue
        rel[key] = ((got - g.float()).norm() / g.float().norm()).item()
        check(rel[key] <= ROW_REL_TOL, f"card vs CPU attention gradient of "
              f"{key}: |diff| / |grad| = {rel[key]} > {ROW_REL_TOL}")
    print(f"small-input check: one attention layer's gradients, card vs CPU "
          f"(|diff| / |grad|, limit {ROW_REL_TOL}): {rel}")


def compare_logits(outs):
    import torch
    check(bool(torch.isfinite(outs["cuda"]).all()), "non-finite logits")
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    tol = 2 ** -6 * outs["cpu"].abs().max().item()
    check(err <= tol, f"card vs CPU logits differ by {err} > {tol}")
    return err, tol


def small_mamba2():
    """reduced(mamba2-2.7b) in bf16 on both devices: a ragged chunk of 32
    then two decode steps; returns the stacked logits per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import ssm
    cfg = reduced(get_config("mamba2-2.7b"))
    params = ssm.init(5, cfg, "cpu")
    B = 2
    chunk = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, 32)))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        cache = ssm.init_cache(cfg, B, 64, device=dev)
        cache["len"] = torch.zeros(B, dtype=torch.int32, device=dev)
        before = ssd_scan.launches["ssd_scan"]
        lg, cache = ssm.prefill_chunk(
            p, cfg, {"tokens": chunk.to(dev)}, cache,
            chunk_len=torch.tensor([32, 19], dtype=torch.int32, device=dev))
        if dev == "cuda":
            check(ssd_scan.launches["ssd_scan"] == before + cfg.num_layers,
                  "the card's chunk did not run the ssd_scan kernel")
        logits = [lg.float().cpu()]
        for step in range(2):
            tok = torch.tensor([7 + step, 11 + step], device=dev)
            lg, cache = ssm.decode_step(p, cfg, tok, cache)
            logits.append(lg.float().cpu())
        outs[dev] = torch.stack(logits)
    return outs


def small_whisper():
    """reduced(whisper-large-v3) with head dim 64 in bf16 on both devices:
    a ragged first chunk of 32 with frame embeddings (encoder, cross K/V
    projection, cross-attention chunk), then two decode steps over int8
    pools; returns the stacked logits per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels.quant import QuantPages
    from repro_torch.models import encdec
    cfg = reduced(get_config("whisper-large-v3"), head_dim=64)
    params = encdec.init(7, cfg, "cpu")
    B, nblk, bs = 2, 4, 32
    rng = np.random.default_rng(8)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 32)))
    emb = torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder_len, cfg.d_model), dtype=np.float32))
    tables = torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        cache = encdec.init_cache(cfg, B, 1, device=dev)
        shape = (cfg.num_layers, B * nblk + 1, bs, cfg.num_kv_heads,
                 cfg.head_dim)
        for n in "kv":
            cache[n] = QuantPages(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones(shape[:-1], device=dev))
        cache["len"] = torch.zeros(B, dtype=torch.int32, device=dev)
        bt = tables.to(dev)
        before = (flash_attention.launches["flash_attention"],
                  decode_attention.launches["decode_attention"])
        lg, cache = encdec.prefill_chunk_paged(
            p, cfg, {"tokens": chunk.to(dev), "embeddings": emb.to(dev)},
            cache, bt, chunk_len=torch.tensor([32, 19], dtype=torch.int32,
                                              device=dev), block_size=bs)
        logits = [lg.float().cpu()]
        live = torch.tensor([True, True], device=dev)
        for step in range(2):
            tok = torch.tensor([7 + step, 11 + step], device=dev)
            lg, cache = encdec.decode_step_paged(p, cfg, tok, cache, bt,
                                                 live, block_size=bs)
            logits.append(lg.float().cpu())
        if dev == "cuda":
            layers = cfg.encoder_layers + cfg.num_layers
            check((flash_attention.launches["flash_attention"],
                   decode_attention.launches["decode_attention"])
                  == (before[0] + layers, before[1] + 2 * cfg.num_layers),
                  "the card's whisper steps did not run the flash and "
                  "decode attention kernels")
        outs[dev] = torch.stack(logits)
    return outs


def small_mixtral():
    """reduced(mixtral-8x7b) with head dim 64 in bf16 on both devices: a
    ragged chunk of 32 (each slot its own routing group of capacity 20)
    then two decode steps over bf16 pools; returns the stacked logits per
    device.  The router's weights are zeros, so every router probability
    is exactly 1/4 on both devices and both route each token to experts 0
    and 1 (the lowest index wins a tie): the two devices' bf16 roundings,
    which differ, cannot flip an argmax that a random router leaves within
    their noise.  The capacity drops 12 of each group's 32 first and 32
    second choices, so the drop path runs too; routing with random
    weights is held to the reference in tests/test_torch_moe.py and runs
    at full size in phase 6."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import grouped_matmul
    from repro_torch.models import moe
    cfg = reduced(get_config("mixtral-8x7b"), head_dim=64)
    params = moe.init(9, cfg, "cpu")
    params["blocks"]["moe"]["router"].zero_()
    B, nblk, bs = 2, 2, 32                 # 64 tokens a slot: the window
    chunk = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (B, 32)))
    tables = torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        shape = (cfg.num_layers, B * nblk + 1, bs, cfg.num_kv_heads,
                 cfg.head_dim)
        cache = {n: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                 for n in "kv"}
        cache["len"] = torch.zeros(B, dtype=torch.int32, device=dev)
        bt = tables.to(dev)
        before = grouped_matmul.launches["grouped_matmul"]
        lg, cache = moe.prefill_chunk_paged(
            p, cfg, {"tokens": chunk.to(dev)}, cache, bt,
            chunk_len=torch.tensor([32, 19], dtype=torch.int32, device=dev),
            block_size=bs)
        logits = [lg.float().cpu()]
        live = torch.tensor([True, True], device=dev)
        for step in range(2):
            tok = torch.tensor([7 + step, 11 + step], device=dev)
            lg, cache = moe.decode_step_paged(p, cfg, tok, cache, bt, live,
                                              block_size=bs)
            logits.append(lg.float().cpu())
        if dev == "cuda":
            check(grouped_matmul.launches["grouped_matmul"]
                  == before + 3 * 3 * cfg.num_layers,
                  "the card's mixtral steps did not run the grouped GEMM "
                  "kernel")
        outs[dev] = torch.stack(logits)
    return outs


def small_dense_steps(arch, seed):
    """reduced(arch) with head dim 64 in bf16 on both devices: a one-shot
    ``prefill`` of 2 x 20 tokens into a 48-row cache and two decode steps,
    then two ragged chunks into a fresh dense cache (``prefill_chunk``,
    one dense chunk kernel launch a layer on the card; the first chunk
    carries frame embeddings for whisper) and two decode steps.  A MoE
    router is zeroed (see ``small_mixtral``).  Returns the stacked logits
    per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import chunk_attention
    from repro_torch.models.registry import model_api
    cfg = reduced(get_config(arch), head_dim=64)
    api = model_api(cfg)
    params = api.init(seed, cfg, "cpu")
    if cfg.family == "moe":
        params["blocks"]["moe"]["router"].zero_()
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20)))
    chunks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, T)))
              for T in (32, 16)]
    emb = None
    if cfg.family == "audio":
        emb = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_len, cfg.d_model), dtype=np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        batch = {"tokens": prompt.to(dev)}
        if emb is not None:
            batch["embeddings"] = emb.to(dev)
        lg, cache = api.prefill(p, cfg, batch, cache_size=48)
        logits = [lg]
        for step in range(2):
            tok = torch.tensor([7 + step, 11 + step], device=dev)
            lg, cache = api.decode_step(p, cfg, tok, cache)
            logits.append(lg)
        cache = api.init_cache(cfg, 2, 48, device=dev)
        cache["len"] = torch.zeros(2, dtype=torch.int32, device=dev)
        before = chunk_attention.launches["chunk_prefill_attention"]
        for i, (chunk, cl) in enumerate(zip(chunks, ([32, 19], [16, 9]))):
            batch = {"tokens": chunk.to(dev)}
            if emb is not None and i == 0:
                batch["embeddings"] = emb.to(dev)
            lg, cache = api.prefill_chunk(
                p, cfg, batch, cache,
                chunk_len=torch.tensor(cl, dtype=torch.int32, device=dev))
            logits.append(lg)
        if dev == "cuda":
            check(chunk_attention.launches["chunk_prefill_attention"]
                  == before + 2 * cfg.num_layers,
                  f"the card's {arch} chunks did not run the dense chunk "
                  f"kernel")
        for step in range(2):
            tok = torch.tensor([3 + step, 5 + step], device=dev)
            lg, cache = api.decode_step(p, cfg, tok, cache)
            logits.append(lg)
        outs[dev] = torch.stack([x.float().cpu() for x in logits])
    return outs


def small_ring():
    """reduced(mixtral-8x7b) (router zeroed) in bf16 on both devices: a
    70-token prompt prefilled for a 128-token slot budget, twice the
    64-token window, keeps a ring of the last 64 rows; three decode steps
    wrap around it.  Returns the stacked logits per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe
    cfg = reduced(get_config("mixtral-8x7b"), head_dim=64)
    params = moe.init(9, cfg, "cpu")
    params["blocks"]["moe"]["router"].zero_()
    prompt = torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab_size, (1, 70)))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        lg, cache = moe.prefill(p, cfg, {"tokens": prompt.to(dev)},
                                cache_size=128)
        check(cache["k"].shape[2] == 64, "the ring is not the window")
        logits = [lg]
        for step in range(3):
            lg, cache = moe.decode_step(p, cfg, torch.tensor(
                [5 + step], device=dev), cache)
            logits.append(lg)
        outs[dev] = torch.stack([x.float().cpu() for x in logits])
    return outs


def small_ssm_prefill():
    """reduced(mamba2-2.7b) in bf16 on both devices: a one-shot
    ``ssm.prefill`` of 2 x 40 tokens (one SSD scan launch a layer on the
    card) and two decode steps.  Returns the stacked logits per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import ssm
    cfg = reduced(get_config("mamba2-2.7b"))
    params = ssm.init(19, cfg, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (2, 40)))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        before = ssd_scan.launches["ssd_scan"]
        lg, cache = ssm.prefill(p, cfg, {"tokens": prompt.to(dev)})
        if dev == "cuda":
            check(ssd_scan.launches["ssd_scan"] == before + cfg.num_layers,
                  "the card's one-shot prefill did not run the ssd_scan "
                  "kernel")
        logits = [lg]
        for step in range(2):
            lg, cache = ssm.decode_step(p, cfg, torch.tensor(
                [7 + step, 11 + step], device=dev), cache)
            logits.append(lg)
        outs[dev] = torch.stack([x.float().cpu() for x in logits])
    return outs


def small_sync_wave():
    """One sync-mode wave of reduced(minicpm-2b) (head dim 64, bf16, 6
    requests of 5-30 tokens, 8 new each, batches of 4) on both devices.
    Greedy chains in bf16 can part at a near-tie that the devices' other
    rounding order flips, after which the rest of the chain differs, so
    the tokens are held to agreement at 0.75 of the positions (the logits
    themselves are held by ``small_dense_steps``).  Returns the share of
    positions that agree."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import plan_for
    from repro_torch.models import transformer
    from repro_torch.serving.engine import GenerationRequest, ServiceRuntime
    full = get_config("minicpm-2b")
    cfg = reduced(full, head_dim=64)
    params = transformer.init(20, cfg, "cpu")
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 30, 12, 21, 8, 17)]
    toks = {}
    for dev in ("cpu", "cuda"):
        rt = ServiceRuntime(cfg, tree_to(params, dev),
                            plan_for(full, "bf16", 4), mode="sync",
                            device=dev)
        for rid, prompt in enumerate(prompts):
            rt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                        max_new_tokens=8, stream=rid))
        res = rt.drain()
        check(len(res) == len(prompts), f"sync wave on {dev} served "
              f"{len(res)}/{len(prompts)}")
        toks[dev] = {r.rid: np.asarray(r.tokens) for r in res}
    same = sum(int((toks["cpu"][r] == toks["cuda"][r]).sum())
               for r in toks["cpu"])
    share = same / sum(len(t) for t in toks["cpu"].values())
    check(share >= 0.75, f"card vs CPU sync-wave tokens agree at only "
          f"{share} of the positions")
    return share


def small_moe_layer():
    """Layer 0's MoE FFN of the same reduced(mixtral-8x7b), with its random
    router, on the same bf16 input on both devices: two routing groups of
    32 tokens, capacity 20.  The router's f32 products differ by float
    noise only, and on this input (seed 15) every token's first, second
    and third router probabilities lie more than 0.008 apart, so the
    devices route alike; 2 assignments are dropped on both.  Returns the
    outputs per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe
    cfg = reduced(get_config("mixtral-8x7b"), head_dim=64)
    params = moe.init(9, cfg, "cpu")
    layer = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (2, 32, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    outs, drops = {}, {}
    for dev in ("cpu", "cuda"):
        p = tree_to(layer, dev)
        probs = torch.softmax(x.to(dev).float() @ p["router"].float(), -1)
        drops[dev] = moe._top_k_dispatch(probs, cfg.experts_per_token,
                                         20)[2].item()
        y, _ = moe.moe_mlp(p, cfg, x.to(dev))
        outs[dev] = y.float().cpu()
    check(drops["cpu"] == drops["cuda"] == 2,
          f"MoE layer drops differ across devices: {drops}")
    return outs


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def ptxas_lines(log):
    """(kernel, line) for each register and spill line of ``ptxas -v``'s
    output, the kernel named by the mangled name of the entry function the
    line belongs to, with its integer template arguments
    (``flash_fwd_kernel<64>``)."""
    import re
    kernel = "?"
    for line in log.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(_Z\w+)", line)
        if entry:
            kernel = demangle(entry[1])
        elif "registers" in line or "spill" in line:
            yield kernel, line.replace("ptxas info    :", "").strip()


def ptxas_record(source):
    """{kernel: {"registers": n, "spill_bytes": stores + loads}} of one
    source's ``ptxas -v`` output in this run's build (empty where this run
    found the library built)."""
    import re
    from repro_torch.kernels import build
    out = {}
    for kernel, line in ptxas_lines(build.build_log.get(source, "")):
        k = out.setdefault(kernel, {"registers": None, "spill_bytes": 0})
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            k["registers"] = int(regs[1])
        k["spill_bytes"] += sum(int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", line))
    return out


def demangle(mangled):
    """The last name of an Itanium-mangled function and its template
    arguments, integers and types: ``_ZN..16flash_fwd_kernelILi64EE..`` ->
    ``flash_fwd_kernel<64>``, ``..18paged_chunk_kernelIaLi64EE..`` ->
    ``paged_chunk_kernel<int8, 64>``."""
    import re
    builtin = {"a": "int8", "h": "uint8", "i": "int", "f": "float"}
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while True:
        num = re.match(r"\d+", mangled[i:])
        if num is None:
            break
        j = i + num.end()
        name, i = mangled[j:j + int(num[0])], j + int(num[0])
    if not mangled[i:].startswith("I"):
        return name
    args, i = [], i + 1
    while i < len(mangled) and mangled[i] != "E":
        lit = re.match(r"L[a-z](-?\d+)E", mangled[i:])
        typ = re.match(r"(\d+)", mangled[i:])
        if lit:
            args.append(lit[1])
            i += lit.end()
        elif typ:
            j = i + typ.end()
            args.append(mangled[j:j + int(typ[1])].strip("_"))
            i = j + int(typ[1])
        elif mangled[i] in builtin:
            args.append(builtin[mangled[i]])
            i += 1
        else:
            break
    return f"{name}<{', '.join(args)}>"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "runs on the card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} is missing: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--decode-attention"] and len(sys.argv) == 3:
        src = Path(sys.argv[2]).resolve() / "src"     # another checkout's #5
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build, paged_attention

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    if sys.argv[1:2] == ["--decode-attention"]:
        decode_attention_alone(sys.argv[2:])
        print(card)
        return 0
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({build.BUILD_ROOT})")
    if sys.argv[1:] == ["--across-cards"]:
        rc = across_cards()
        print(card)
        return rc
    if sys.argv[1:] in (["--across-cards-paths"], ["--across-cards-oneshot"]):
        cards = [torch.device("cuda", i) for i in range(4)]
        check(torch.cuda.device_count() >= 4, f"{sys.argv[1]} needs 4 cards")
        (across_cards_paths if sys.argv[1] == "--across-cards-paths"
         else across_cards_oneshot)(cards)
        print(card)
        return 0
    if sys.argv[1:] == ["--tp-witness"]:
        tp_kv_witness(torch.device("cuda", 0))
        print(card)
        return 0
    if sys.argv[1:] == ["--tp-floor"]:
        tp_floor(wave_mamba2()[1], torch.device("cuda", 0))
        print(card)
        return 0
    for name, log in build.build_log.items():
        for kernel, line in ptxas_lines(log):
            print(f"  ptxas {name} {kernel}: {line}")

    stamp = [time.perf_counter()]

    def phase_time(label):
        now = time.perf_counter()
        print(f"{label}: {now - stamp[0]:.1f} s")
        stamp[0] = now

    print("phase 1: kernels against their plain versions "
          f"(atol = rtol = {TOL})")
    records = phase_kernels()
    for name, rec in records.items():
        print(f"  {name}: {rec}")
    phase_time("phase 1")

    reset_launches()
    print("phase 2: launcher, minicpm-2b full width")
    phase_launcher()
    gc.collect()
    torch.cuda.empty_cache()
    phase_time("phase 2")
    print("phase 3: request wave, prompts of 6-200 tokens, 40 new each")
    int8_toks, int8_grown, int8_tok_s = wave("int8")
    bf16_toks, bf16_grown, _ = wave("bf16")
    launches = dict(paged_attention.launches)
    check(int8_grown["paged_decode_attention_quant"] > 0
          and int8_grown["paged_chunk_prefill_attention_quant"] > 0,
          f"int8 wave did not launch the int8 kernels: {int8_grown}")
    check(bf16_grown["paged_decode_attention"] > 0
          and bf16_grown["paged_chunk_prefill_attention"] > 0,
          f"bf16 wave did not launch the bf16 kernels: {bf16_grown}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    for kv, toks in (("int8", int8_toks), ("bf16", bf16_toks)):
        print(f"phase 3 {kv} greedy tokens: "
              + json.dumps([toks[r].tolist() for r in sorted(toks)]))
    same = sum(int((int8_toks[r] == bf16_toks[r]).sum()) for r in int8_toks)
    total = sum(len(t) for t in int8_toks.values())
    print(f"phase 3 int8 vs bf16 greedy tokens: {same}/{total} positions "
          f"agree ({same / total:.3f})")
    phase_time("phase 3")
    print("phase 4: request wave, mamba2-2.7b full width, 128 slots")
    bases = {}
    launches["ssd_scan"], bases["mamba2-2.7b"] = wave_mamba2()
    phase_time("phase 4")
    print("phase 5: request wave, whisper-large-v3 full width, 128 slots")
    whisper_launches, bases["whisper-large-v3"] = wave_whisper()
    for name in ("flash_attention", "decode_attention"):
        launches[name] = whisper_launches[name]
    phase_time("phase 5")
    print("phase 6: request wave, mixtral-8x7b full width, 16 of 32 layers, "
          "512 slots")
    mixtral_launches, bases["mixtral-8x7b"] = wave_mixtral()
    launches["grouped_matmul"] = mixtral_launches["grouped_matmul"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_time("phase 6")
    print("phase 7: training, minicpm-2b full width, batch 2 x 4096, "
          "2 microbatches")
    train_launches = phase_train()
    launches["flash_attention"] += train_launches["flash_attention"]
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_time("phase 7")
    print("phase 8: the sync and dense-cache paths, minicpm-2b full width")
    phase_dense_launchers()
    oracle_launches, oracle_toks = wave_oracle()
    launches["chunk_prefill_attention"] = \
        oracle_launches["chunk_prefill_attention"]
    same = sum(int((oracle_toks[r] == bf16_toks[r]).sum())
               for r in oracle_toks)
    print(f"phase 8 (b) oracle vs phase 3 native bf16 greedy tokens: "
          f"{same}/{sum(len(t) for t in oracle_toks.values())} positions "
          f"agree")
    logits_parity()
    wave_sync(SYNC_REQUESTS)
    phase_time("phase 8")
    print("phase 9: the prefix cache, minicpm-2b full width, 512 slots, "
          "64 requests sharing a 150-token template, 24 new each")
    templated_launches = phase_templated()
    print(f"phase 9 launches: {templated_launches}")
    phase_time("phase 9")
    print("phase 10: observability and evacuation, minicpm-2b full width, "
          "512 slots")
    phase_obs_smoke()
    gc.collect()
    torch.cuda.empty_cache()
    phase3_final = phase_obs_wave(int8_toks, int8_grown)
    phase_evacuate(int8_toks, phase3_final)
    del phase3_final
    phase_time("phase 10")
    print("phase 11: threefry sampling, SDF admission with parking, n-way "
          "forks, minicpm-2b full width")
    phase_sampling_admission(int8_toks, int8_tok_s)
    print("phase 12: speculative decoding, minitron-4b full width, 512 "
          "slots, k = 4; mixtral-8x7b full width, 2 of 32 layers")
    spec_rec = phase_speculative()
    print("phase 13: the multi-server control plane, minicpm-2b and "
          "minitron-4b full width, crash failover")
    phase_cluster(spec_rec["verify"]["max_abs_diff"])
    print("phase 14: the VLM family, paligemma-3b full width, 512 slots, "
          "D = 256")
    vlm_launches = phase_vlm()
    for name in launches:
        launches[name] += vlm_launches.get(name, 0)
    print("phase 15: the hybrid family, zamba2-7b full width, 256 slots, "
          "D = 112")
    hybrid_launches = phase_hybrid()
    for name in launches:
        launches[name] += hybrid_launches.get(name, 0)
    print("phase 16: training, mamba2-2.7b, whisper-large-v3, paligemma-3b, "
          "zamba2-7b and mixtral-8x7b (2 of 32 layers) full width")
    family_launches = phase_train_families()
    for name in ("flash_attention", "flash_attention_bwd", "grouped_matmul",
                 "ssd_scan"):
        check(family_launches[name] > 0, f"phase 16 never launched {name}")
    for name in launches:
        launches[name] += family_launches.get(name, 0)
    stamp[0] = time.perf_counter()
    print("phase 17: head-sharded paged serving (--pjit-decode), "
          "minicpm-2b at tp = 1 and 4, codeqwen1.5-7b at tp = 2")
    tp_launches = phase_tp(int8_toks)
    for name in ("paged_decode_attention", "paged_decode_attention_quant",
                 "paged_chunk_prefill_attention",
                 "paged_chunk_prefill_attention_quant"):
        check(tp_launches[name] > 0, f"phase 17 never launched {name}")
    for name in launches:
        launches[name] += tp_launches.get(name, 0)
    phase_time("phase 17")
    print("phase 18: head-sharded paged serving of mamba2-2.7b, "
          "whisper-large-v3 and mixtral-8x7b (16 of 32 layers) at tp = 4 "
          "over [cuda:0] * 4")
    tpf_launches = phase_tp_families(bases)
    del bases
    for name in ("paged_decode_attention", "paged_decode_attention_quant",
                 "paged_chunk_prefill_attention",
                 "paged_chunk_prefill_attention_quant", "decode_attention",
                 "flash_attention", "grouped_matmul", "ssd_scan"):
        check(tpf_launches[name] > 0, f"phase 18 never launched {name}")
    for name in launches:
        launches[name] += tpf_launches.get(name, 0)
    gc.collect()
    torch.cuda.empty_cache()
    phase_time("phase 18")
    print("phase 21 (run after phase 18, on its kept trees): one-shot "
          "prefill and the dense-view oracle split by heads "
          "(--pjit-decode) for mamba2-2.7b, whisper-large-v3, "
          "paligemma-3b and zamba2-7b at tp = 4 over [cuda:0] * 4")
    oneshot_launches = phase_oneshot_tp()
    for name in ("paged_decode_attention", "paged_decode_attention_quant",
                 "decode_attention", "chunk_prefill_attention",
                 "flash_attention", "ssd_scan"):
        check(oneshot_launches[name] > 0, f"phase 21 never launched {name}")
    for name in launches:
        launches[name] += oneshot_launches.get(name, 0)
    phase_time("phase 21")
    print("phase 19: the four examples on the card (quickstart, the §4.3 "
          "case study, serve_cluster --chaos, train_small)")
    example_launches = phase_examples()
    for name in ("paged_decode_attention", "paged_decode_attention_quant",
                 "paged_chunk_prefill_attention",
                 "paged_chunk_prefill_attention_quant", "flash_attention",
                 "flash_attention_bwd", "ssd_scan"):
        check(example_launches[name] > 0, f"phase 19 never launched {name}")
    for name in launches:
        launches[name] += example_launches.get(name, 0)
    phase_time("phase 19")
    print("phase 20: speculation, the ring and the dense-view oracle split "
          "by heads (--pjit-decode): minitron-4b with a self-draft at tp = "
          "2 and 4, mixtral-8x7b past its window at tp = 4, minicpm-2b's "
          "oracle at tp = 4, over [cuda:0] * tp")
    paths_launches = phase_tp_paths(spec_rec)
    for name in ("paged_decode_attention", "paged_chunk_prefill_attention",
                 "decode_attention", "chunk_prefill_attention",
                 "flash_attention", "grouped_matmul"):
        check(paths_launches[name] > 0, f"phase 20 never launched {name}")
    for name in launches:
        launches[name] += paths_launches.get(name, 0)
    phase_time("phase 20")
    small_input_check()
    phase_time("small-input check")

    kernels = []
    for name, rec in records.items():
        source = SOURCES[name if name in SOURCES else "paged_attention"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "paligemma_launches": vlm_launches.get(name, 0),
                        "zamba2_launches": hybrid_launches.get(name, 0),
                        "train_families_launches": family_launches.get(
                            name, 0),
                        "tp_launches": tp_launches.get(name, 0),
                        "tp_families_launches": tpf_launches.get(name, 0),
                        "examples_launches": example_launches.get(name, 0),
                        "tp_paths_launches": paths_launches.get(name, 0),
                        "tp_oneshot_launches": oneshot_launches.get(name,
                                                                    0),
                        **{k: rec[k] for k in RECORD_KEYS}})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s, build included")
    check(len(kernels) == 10, f"expected ten kernels, got {len(kernels)}")
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel of the main paths never launched: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
