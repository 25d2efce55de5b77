#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Two models of the paper at full width, random weights from a seed:
Mixtral-8x22B (8 experts, top-2) and Qwen2-57B-A14B (64 experts, top-8, a
sigmoid-gated shared expert, qkv biases, a GQA group of 7); and the MoE
configs registered with the reference's mapping table: Mixtral-8x22B-G8T8
(64 experts top-8 of 2048) and Qwen3-MoE-30B-A3B (128 experts top-8 of 768,
32 heads of 128 over d_model 2048) trained on one card, Llama3-8x70B and
DBRX-132B at their kernel shapes; and the dense Llama3.2-1B at full width
and depth with a sliding-window ring cache, beside Qwen3-MoE-30B-A3B's
window variant (phase 14); and Gemma-7B, Qwen2-VL-7B and Whisper-small,
whose blocks are of other kinds (phase 15); and xLSTM-125M and Zamba2-2.7B,
whose blocks are recurrent (phase 16). Phases (any failure exits non-zero;
nothing is caught):

1. device  — require CUDA; print the card's name and power limit and torch's
   version; turn TF32 off.
2. build   — build the kernel library from ``src/repro_torch/kernels/csrc``.
3. kernels — each CUDA kernel against its plain PyTorch version on the card at
   the model's shapes (bf16, relative error <= 2e-2), its device time, its
   bound, the plain version's device time, and one PyTorch library call of
   the same function as a yardstick (``library_ms``). Every time is device
   time (``repro_torch.launch.devtime``): the kernel and the library call
   from replays of a CUDA graph of 20 calls (``graph_ms``), the plain
   version, which synchronises, from ``torch.profiler``'s kernel times
   (``profiled_ms``). GMM: the serving decode step's gate/up and down
   launches (every expert owning one 128-row block), the training step's
   gate/up and down launches and the ``trans_w`` mode (the training step's
   dgrad) at its two shapes; for Mixtral also 6-of-8 experts, bm=64, and
   the decode gate/up and its ``trans_w`` dgrad at row blocks of 8, 16, 24
   and 32 rows (one an expert: x (8·bm, 6144), the swap-AB kernel).
   Flash: the serving decode and prefill chunk and causal self-attention at
   4096 tokens, each in both output modes (Mixtral: a 32768-key decode too;
   Qwen2: a decode step of 3 queries, whose 21 packed rows split a GQA group
   across two row tiles). Then the attention backward at causal 4096
   (``_bwd_scan`` in torch ops) against SDPA's, each timed as a graph of
   forward and backward less a graph of the forward. The same rows at the
   training step's shapes of the added configs (``phase_config_kernels``):
   the GMM gate/up of G8T8, Qwen3-MoE, Llama3-8x70B and DBRX (down and the
   ``trans_w`` dgrad too for the first two), flash at causal 4096 in the
   training step's partial mode at the heads of G8T8 (48/8), Qwen3-MoE
   (32/4) and Llama3-8x70B (64/8).
4. serve   — the model cut to 4 layers, bf16: 6 requests through the paged
   engine; every launch counter is set to 0 just before and read just
   after, and must equal 3 GMM and 1 flash launch per layer per forward.
5. train   — the serving model freed, the model cut to 1 layer: 4 training
   steps of 4096 tokens (fp32 masters and AdamW state, bf16 compute, full
   remat, token-dropping MoE); the counters are set to 0 just before and
   read just after (3 + 3 + 3 GMM and 1 + 1 flash launches per step); loss
   finite and ``step_ok`` every step; step wall time, tokens/s, MFU and
   peak memory beside the step's compute and optimizer bounds.
6. check   — the reduced (smoke-width) slices on the card against the same
   weights through the plain versions on the CPU: serving's prefill logits,
   the first training step's gradients leaf by leaf, and two training
   steps' loss and gradient norm (bf16 both sides). For Qwen2 also the MoE
   layer with its shared expert: the dropless ``capacity_hint`` pre-pass
   (equal on both), the sort layout with that hint and the scatter layout;
   once more at ``gmm_block_m=16`` (the GMM's swap-AB kernel), its sort
   launches counted.

7. world   — the folded MoE layer across ranks (``repro_torch.launch.world``):
   4 processes share the card over gloo, each loads the kernel library
   phase 2 built, makes the full-width weights from the seed and keeps its
   shard, and runs ``WORLD_TOKENS`` (2048) tokens of its own forward and backward (a seeded
   cotangent) through ``moe_ffn`` with the model's own MoEConfig (bf16,
   ``overlap_chunks=2``). Mixtral at MoE EDP1×EP4×ETP1, padded and ragged
   exchange; Qwen2 at EDP1×EP2×ETP2 with its shared expert. Each rank holds
   its output (relative error <= 2e-2) and its expert-shard and router
   gradients (relative L2 <= 5e-2) against the one-rank layer on the full
   weights (gradients summed over all ranks' tokens); Mixtral's ragged
   output must equal its padded one; the counters, zeroed before the pass,
   must read 3 GMM launches per chunk forward and 3 ``trans_w`` per chunk
   backward. The wall times (of 1 warm pass) are of gloo through
   the host on one card. Then a world of one rank over NCCL: the folded
   layer with every group of size 1 equal to the one-rank layer, and every
   collective the dispatcher calls valid on NCCL. Last, the GMM at the
   world's launch shapes, timed as in phase 3.

8. train-world — the folded training step (``repro_torch.launch.world.
   train_world``): 4 processes share the card over gloo; each builds the
   model cut to 1 layer from the seed in turn, keeps its slices and frees
   the rest. Mixtral at attention CP2×TP2 (Megatron SP, vocabulary-parallel
   embedding, head and loss) with MoE EP4: 2 steps of phase 5's batches
   (cut from 4 to pay for phases 12 and 18) with ``cp_mode="allgather"``, then 2 with the zigzag ring
   from the same start; Qwen2 at CP2×TP2 with MoE EP2×ETP2: one forward and
   backward (no AdamW state: it would not fit 4 ranks). Per rank: every
   step's loss and global ``grad_norm`` against phase 5's one-card step at
   the same seed and batches (step 0, on the same weights, within
   ``FOLD_TOL``; the folded MoE caps each expert per token shard, so other
   tokens drop, and later steps part further: ``FOLD_TOL_LATER``,
   ``GRAD_NORM_TOL_LATER``), the ring against the all-gather run (within
   ``RING_TOL``), each run's launches
   against the count derived from the code, peak memory and step wall
   time (gloo through the host on one card, not NCCL over NVLink); rank 0
   profiles one more step (device time by part, host time in the
   collectives' ``comm`` ranges). Then the flash kernel in partial mode
   at the fold's shapes (all-gather CP at both chunks' offsets; the ring's
   diagonal, wholly visible and wholly masked pairs) and the GMM at the EP
   shard's shape, held and timed as in phase 3.

9. train-zero — the folded step with the training state kept as the
   reference keeps it: attention leaves stored cut over DP (FSDP), AdamW
   moments (and the fp32 master) cut over DP by ZeRO-1. 4 processes share
   the card over gloo at attention DP2×TP2 beside the first MoE fold of
   ``ZERO_MOE_FOLDS`` whose MoE token shards are its SP shards (EDP2×EP2),
   a global batch of 2 × 2048 tokens (``ZERO_SEQ``, cut from 4096 to pay
   for phases 12 and 18; one sequence a DP rank), each run from
   the same weights. Mixtral: (a) ``fsdp=True`` 1 step, (b) ``fsdp=False``
   1 step, (c) ``fsdp=True`` with ``master_weights`` 1 step; Qwen2's (a)
   and (c) (the step phase 8 could not fit) run in phase 12's hand-off
   world, which is this fold. Per rank: every
   step of (b) and (c) against (a)'s step of the same index in loss and
   ``grad_norm`` within ``ZERO_TOL``, its optimizer-state bytes counted
   from its tensors against ``zero1_state_bytes`` for that fold, launches
   against the count from the code, parameters stored, peak memory and
   step wall time. Then the flash
   kernel at a TP
   rank's heads over the whole sequence and the GMM at the EP shard's
   shape, held and timed as in phase 3.

10. train-pipe — pipeline parallelism, the fifth dimension: 4 processes
   share the card over gloo, each holding one pipeline stage's layers (the
   embedding on the first stage, the final norm and head on the last),
   running its stage's ops of the schedule and sending activations and
   their gradients point to point (host-staged under gloo). (a) Mixtral at
   full width cut to 2 layers at PP2 × attention TP2 / MoE EP2
   (``PIPE_FULL``), 1F1B over 4 microbatches of one 2048-token sequence
   (``SyntheticTokens(seed=0)``): one forward and backward and the global
   ``grad_norm``, the parameters held as their bf16 compute casts (AdamW
   state for 1.353 B parameters a rank does not fit 4 ranks), held against
   the same at pp = 1 on stage 0's 2 ranks (the same weights, microbatches
   and inner fold): loss, ``grad_norm`` and every gradient leaf (relative
   L2) within ``PP_TOL``. Per rank: parameters, peak memory, launches
   against the count from the code, wall; per stage
   (its first rank profiled): the device-idle share of the wall beside the
   closed-form bubble (pp − 1)/(m + pp − 1), host time in ``comm send`` and
   ``comm recv``. (b) reduced width in bf16 (``PIPE_SMALL``): interleaved
   PP2 × vpp 2 over 4 layers, ZeRO-1 over attention DP2, 2 AdamW steps
   against pp = 1: loss and ``grad_norm`` every step and every final
   parameter leaf within ``ZERO_TOL``. Then the flash and GMM kernels at
   (a)'s stage shapes, held and timed as in phase 3.

11. train-resume — elastic checkpoints and supervised restart
   (``repro_torch.launch.world.resilient_world``: ``checkpoint/store.py``
   in the reference's ``repro-elastic-v1`` format, ``resilience.
   run_training``). (a) Mixtral at full width cut to 1 layer at phase 9's
   fold (DP2×TP2 / EDP2×EP2, FSDP, ZeRO-1), phase 9's seed, batches and
   AdamWConfig, 4 ranks sharing the card over gloo, under the supervisor:
   1 step, a save every step keeping 1, a ``data_error`` fault at step 0.
   It saves step 0 (the initial state), crashes fetching step 0's batch,
   restores the verified step 0 (the re-hash split over the ranks), runs
   step 0 and saves step 1, in a
   ``tempfile.mkdtemp()`` directory in the RAM-backed ``/dev/shm`` (the
   card's machine caps what is written to its disk at 45 GiB, less than two
   34.88 GB steps; step 0's zero moments are stored deflated, so keep=1
   holds ~46.5 GB while step 1 commits; the directory's free bytes and
   file-system type and the RAM available are printed, and less room
   fails the phase) removed at the end. Checks: each rank's restored
   pieces hash to the saved digests; the loss and ``grad_norm`` of step 0
   equal phase 9's FSDP run's bit for bit; the launch counters, zeroed at
   the restore, equal one step's count from the code. It prints the
   bytes a rank writes a save and the walls of the host copy, hash, write,
   commit, verify and restore. (b) Reduced Mixtral in bf16, 4 layers:
   3 steps at phase 10 (b)'s fold
   (PP2 × vpp 2 / DP2 / EP2, ZeRO-1) saving step 2 (async) and step 3;
   step 2 restored onto DP2×TP2 / EDP2×EP2 at pp 1 and saved there; that
   restored back onto the first fold (each piece hashed against the first
   save's digests) and its step 2 run: loss and ``grad_norm`` equal to the
   uninterrupted run's third step and step 3's state equal shard by shard.

train-configs — phase 5's one-card training (2 steps, launches 3 + 3 + 3
   GMM and 1 + 1 flash a step) and phase 6's reduced card-vs-CPU training
   check for Mixtral-8x22B-G8T8 and Qwen3-MoE-30B-A3B at full width cut to
   1 layer (2.907 B and ~1.25 B parameters); the reduced check keeps each
   config's real expert count and top-k (64 and 128 experts, top-8) and
   Qwen3-MoE's heads of 128 (``FANOUT``, ``HEAD_DIM``), and runs dropless
   (see ``FANOUT``).

12. train-handoff — the SP → MoE token hand-off (``comm.sp_to_moe``):
   Qwen2 at full width cut to 1 layer, FSDP, 1 step of 4 × 2048 tokens
   (``SyntheticTokens(seed=0)``), 4 processes sharing the card over gloo.
   The hand-off world runs phase 9's fold (DP2×TP2 / EDP2×EP2) with 2
   sequences a DP rank, twice from the same weights: phase 9's runs (a)
   (FSDP) and (c) (FSDP and the fp32 master), (c) held to (a) within
   ``ZERO_TOL`` as phase 9 holds them. The sequence is cut over TP, so
   every MoE layer exchanges the SP rows for the reference's token shards
   (a run of the DP rank's flattened tokens: here one whole sequence) and
   back. The oracle
   world runs the same weights, batches and MoE fold at attention DP4, a
   whole sequence a rank and no exchange, so its token shards are the same
   sequences. Checks: each rank's MoE token shard holds the oracle rank's
   token ids, id for id; loss, ``grad_norm`` and the drop fraction of the
   step within ``FOLD_TOL`` of the oracle's (the attention's TP2 and TP1 sums round differently in bf16,
   which moves near-tie top-k choices); optimizer-state bytes equal to
   ``zero1_state_bytes``; launches equal to the count from the code. It
   prints peak memory, step walls and rank 0's host ms in ``comm handoff``
   beside the other ``comm`` ranges (``core.comm.HOST_S`` over the step:
   no profiled step, which cost ~15 s), then the flash and GMM kernels at
   its shapes, held and timed as in phase 3. A third world moves tokens across
   DP ranks (``HANDOFF_CROSS``): 2 pods extending attention CP and MoE EDP
   (``pod_role="cp"``), attention (2, 1, 1), MoE (1, 2, 1), the same batch
   and seed, one forward and backward with the global gradient norm (its
   optimizer state does not fit beside the other ranks' on the card: see
   ``HANDOFF_CROSS``); its SP shard is (dp, pod), its MoE shard (pod, ep), and
   the hand-off is one All-to-All-V over the attention stage. Checks: each
   rank's MoE token ids equal those of the oracle's rank at the same MoE
   token index, id for id; loss, ``grad_norm`` and the drop fraction within
   ``FOLD_TOL`` of the oracle's; launches; each rank's host ms in ``comm
   handoff`` (``core.comm.HOST_S``).

13. serve-world — phase 4's serving workload (the model cut to 4 layers,
   bf16, seed 0, ``ENGINE``, ``PROMPT_LENS``, 16 new tokens) across 4
   processes sharing the card over gloo (``launch.world.serve_world``):
   each rank builds the model in its turn, keeps its compute slices, and
   every rank runs the same engine (``serve.Engine(..., groups=)``).
   (a) Mixtral at attention CP2×TP2 / MoE EP4: the paged pools cut over
   TP heads, the CP slices of each view LSE-merged over CP, ring-CP
   prefill for the even chunks (the odd tail chunks take the merge path),
   24 / 4 heads a rank, 2 experts a rank. (b) Qwen2 at DP2×TP2 / EP2×ETP2:
   2 decode slots a DP rank whose tokens cross DP ranks to their MoE
   shards, ETP with the gated shared expert, qkv biases under TP. Checks:
   every request finishes with 16 tokens and every rank has rank 0's
   tokens and prefill logits; each rank's launches equal the count from
   the code (3 GMM a dispatcher chunk and 1 flash, or ``cp`` for a ring
   prefill chunk, a layer a forward); each rank's KV pools equal
   ``kv_bytes_paged / tp``; every request's prefill logits within
   ``CHECK_TOL`` (relative) of phase 4's, and its first token equal to
   phase 4's wherever phase 4's top-1/top-2 margin exceeds twice the max
   |Δlogit| (the two sum bf16 in other orders). It prints, per request, the
   tokens equal before the first divergence, and per model peak memory a
   rank (build and serving), the build time in turns, the decode-step
   median and prefill tok/s; for (a) rank 0's profiled decode step (device
   time by part, host ms in the ``comm`` ranges). (c) The recurrent kinds
   at DP2×TP2 (``SERVE_WORLD_RECUR``): phase 16's serving workload (xLSTM
   x12 paged, Zamba2 x12 dense) with a slot's state on its DP rank and
   the recurrent layers on leaves gathered whole once: every rank's results
   equal rank 0's, 1 flash launch a forward a KV-bearing layer (Zamba2's
   shared block, none for xLSTM); after phase 16, each request's prefill
   logits within ``CHECK_TOL`` of phase 16's one-card run of the same and
   its first token equal where the margin allows, as in (a). All four runs
   share one world of 4 processes, one after the other. Then the flash kernel in partial
   mode on a CP slice (a decode step, a ring-prefill hop), flash at (b)'s
   and (c)'s decode (a DP rank's rows at a TP rank's heads) and the GMM at
   each fold's decode shard, held and timed as in phase 3.

14. window-dense — dense decoder blocks and sliding-window ring caches, one
   card, three parts. (a) serve-window: Llama3.2-1B as
   ``launch.mappings.model_for`` makes it for ``long_500k`` (a window of
   8192), full width and depth (16 layers), bf16, tied head; the same two
   requests (prompts of 12288 and 1024 tokens from the seed, 32 new
   tokens, prefill chunks of 512) through a paged (pages of 128) and a
   dense engine of 2 slots. Checks: every request finishes with 32
   tokens; paged tokens equal dense tokens; each KV store's bytes equal
   ``kv_bytes_paged`` / ``kv_bytes_dense`` at ``cache_len`` 8192 (a ring of
   the window, not the context); flash launches equal 16 per prefill chunk
   and per decode step, GMM launches 0. (b) train-dense: the same model, 2
   AdamW steps of 2 × 4096 tokens (``SyntheticTokens(seed=0)``), then the
   same again from the same seed: losses finite, losses and ``grad_norm``
   bitwise equal across the runs, launches from the code; step ms, MFU, peak
   memory and, from the rerun's profiled last step, AdamW's share of the
   step; then phase 6's reduced card-vs-CPU check on Llama3.2-1B. (c)
   moe-window: Qwen3-MoE-30B-A3B for ``long_500k`` at full width cut to 2
   layers, one 9000-token request of 16 new tokens, paged: 16 tokens, 3 GMM
   and 1 flash launch a layer a forward. Then flash with key positions
   (``kv_pos``) at (a)'s ring decode and prefill chunk and at (c)'s prefill
   chunk against the plain version (``library_ms``: SDPA with an
   ``attn_mask`` from the positions), flash without them at (b)'s causal
   4096 and at phase 3's Mixtral decode again, and the GMM at (c)'s decode
   (and its gate/up and down at row blocks of 8 and 16 rows, the swap-AB
   kernel's decode, one block an expert);
   beside them flash with query positions (``q_pos``) at (a)'s heads: (b)'s
   causal 2 × 4096 with two packed sequences a row (``kv_pos`` = ``q_pos``)
   and a decode of 4 rows at their own positions, ``library_ms`` from SDPA
   with an ``attn_mask`` from the positions.

15. block-kinds — the three archs of other block kinds, one card, random
   weights from the seed, bf16. (a) Gemma-7B (16 heads of 256, √d_model
   embedding, GeGLU, tied) cut to 4 layers serves 2 requests (prompts of
   1000 and 700 tokens in chunks of 512, 16 new tokens) through a paged
   (pages of 128) and a dense engine: paged tokens equal dense, 1 flash
   launch a layer a forward at heads of 256; cut to 1 layer it takes 2
   AdamW steps of one 4096-token sequence (2 flash launches a layer a
   step: forward and remat). (b) Qwen2-VL-7B, cut to 4 / 2 layers, the
   same, training with 256 vision rows and M-RoPE streams whose height and
   width are the patch grid. (c) Whisper-small at full depth (12 + 12): 2
   training steps of one 4096-token sequence against 1500 frames (2 flash
   launches a step per self-attention, cross-attention and encoder layer),
   then a prompt chunk and 3 greedy ``decode_step``s (2 a layer a call).
   (d) Qwen2-VL at (b)'s 2 layers with its 256 vision rows sharing one
   temporal id (the flash kernel's ``q_pos`` / ``kv_pos`` path): its loss and
   gradient norm at 320 tokens on the card (bf16) against the CPU plain
   path (fp32) within ``CHECK_TOL``, then one AdamW step of 4096 tokens.
   Each run's counters are set to 0 just before and read just after; step
   ms, MFU (``_blocks_flops``) and peak memory are printed. Then phase 6's
   reduced card-vs-CPU checks for the three (Gemma's reduced heads set to
   256; Whisper's ``decode_step`` logits), and flash against its plain
   version at each path's shapes: Gemma's causal 4096, decode against 1024
   keys and prefill chunk at heads of 256, Qwen2-VL's causal 4096 and
   decode, Whisper's encoder (1500 × 1500) and cross-attention (4096 ×
   1500, and its decode) not causal, and (d)'s causal 4096 at its
   positions, with ``library_ms`` from SDPA; beside them a kernel row with
   no main path, CodeQwen1.5-7B's multi-head decode (4 rows, 32/32 heads of
   128, against 1024 keys), on the stream path as Gemma's and Whisper's
   decodes are.

16. recurrent — the recurrent block kinds, one card, random weights from
   the seed, bf16. (a) xLSTM-125M at full width and depth (12 layers: mLSTM
   ×3 + sLSTM, 4 heads over 768) serves phase 15's two requests through a
   paged and a dense engine (paged tokens equal dense; no kernel on the
   path: every launch counter stays 0) and prints the recurrent state a
   request; then, cut to one cycle (4 layers: ``RECUR_TRAIN``), 1 AdamW
   step of one 1024-token sequence, and the same again (losses finite,
   losses and grad_norm bitwise equal across the runs), step ms and MFU
   (``launch.train.recurrent_flops``), and the sLSTM layer's share of the
   step from one sLSTM layer timed alone. (b)
   Zamba2-2.7B at full width cut to 12 layers (two cycle repeats of 6
   Mamba2 layers, each followed by the shared attention + MLP block, 32
   heads of 80) serves the same requests through a dense engine (1 flash
   launch a repeat a forward) and trains as (a), 2 steps a run (2 flash
   launches a repeat a step: forward and remat). Then phase 6's reduced card-vs-CPU checks
   for both at 4 layers (xLSTM's training check in fp32, Zamba2's heads set
   to 80), and flash at heads of
   80 against its plain version: causal 4096 (partial), the decode against
   1024 keys and a 512-query prefill chunk, ``library_ms`` from SDPA.

17. dryrun — the dry run (``python -m repro_torch.launch.dryrun``) in a
   subprocess, tracing the port's real step on fake CUDA tensors, held
   against what phases 5 and 9 measured. Phase 5's step (Mixtral at full
   width cut to 1 layer, 4096 tokens, one rank): the trace's stored-state
   bytes (``arg_bytes``) equal the bytes of that run's parameters and
   optimizer state exactly; its peak of live bytes is within
   ``DRYRUN_MEM_TOL`` of phase 5's ``max_memory_allocated`` (read after
   resetting the peak with the state live); the measured median step is
   at least ``max(compute_s, memory_s)`` at ``roofline.analysis.H100_SXM``
   (a bound the card beat would be a fault of the count), printed as a
   ratio beside ``mfu_bound`` and the measured MFU. Phase 9's fold (run
   (a), rank 0, which phase 9 records under a ``trace_cost.Recorder``):
   the trace's collectives (kind, range, result bytes, global ranks) and
   kernel calls equal the real step's in order, its ``arg_bytes`` equal
   the real state's, and its peak is within ``DRYRUN_MEM_TOL`` of rank 0's.
   Then the static analysis (``repro_torch.analysis``), each line printed
   before the phase fails on any: (a) the collective audit of phase 9's
   real rank-0 records at phase 9's fold, config and shape: no finding, and
   its rows (kind, atoms, labels, count, wire bytes) equal the trace's;
   (b) init purity on the card: full-width Mixtral through the production
   init path for every rank of phase 9's fold (1 layer) and of a pp = 2
   fold (``PURITY_PP``, 2 layers), reassembled on the card, bitwise the
   one-card init (the pp = 2 fold stage by stage), with its time and peak
   bytes; (c) Whisper ``prefill_32k``'s production row (rank -1 of 256,
   1500 encoder frames padded to split over cp·tp) traced on fake CUDA
   tensors in the same subprocess, with its roofline line.

18. replicated-kv — K/V replicated over TP: Qwen2-VL-7B's 28 query and 4
   K/V heads at attention (1, 1, 8), which does not divide the K/V heads,
   so every TP rank projects, caches and attends at all heads
   (``models.attention.kv_replicated``). No registry model reaches that at
   TP <= 4, so this runs one world of 8 processes sharing the card over
   gloo (``launch.world.pool(8)``), opened after the pool of 4 is closed.
   (a) Phase 15's paged Engine (4 layers, bf16, seed 0, its two requests,
   ``serve_world``): greedy tokens equal to phase 15's one-card Engine,
   prefill logits within ``CHECK_TOL`` (relative), 1 flash launch a layer
   a forward, and per rank its peak memory, KV pool and a request's K/V
   bytes, equal to one card's (``serve.cache.kv_bytes_dense(groups=)``).
   (b) One training step of phase 15's (2 layers, its 4096-token batch and
   seed, given to ``train_world(batches=)``): loss and ``grad_norm``
   within ``FOLD_TOL`` of phase 15's one-card step 0, 2 flash launches a
   layer, peak memory a rank.

Phase 9 runs first, right after the build: its 4 ranks need about 70 GB
of the card (Qwen2: 18.02 GB peak a rank on an H100), and what the other
phases leave in this process (3.9 GB reserved before phase 7) left Qwen2's
ranks out of memory when phase 9 ran last. Phases 12, 10 and 11 run right
after it, for the same reason, with the memory reserved before each
printed. Then Mixtral runs phases 3, 4, 5, 6; every Mixtral tensor is
freed and Qwen2
runs 4, 5, 3, 6; then the added configs' phase 3 rows and train-configs;
then Mixtral and Qwen2 run 7 and 8, then phase 13 with phase 4's requests,
then phases 14, 15, 16 and 17, and last phase 18 on its own 8 processes. Every other phase
across ranks runs on one set of 4 processes
(``launch.world.pool``), started after the build: each rank pays its
interpreter, CUDA context, kernel library and first launches once, not
once a world; ``[time]`` lines give each phase's wall. Then it prints the
script time, the
kernels' JSON line (one entry per kernel per main path, its ``launches``
from that path's own run), the card's ``nvidia-smi`` name and power limit,
and last ``{"ok": true, "device": {...}}``. Full results also go to
``results/chip_smoke.json``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

REL_TOL = 2e-2          # kernel vs plain version, bf16 inputs and outputs
CHECK_TOL = 5e-2        # reduced slices, card vs CPU plain path, bf16 both
SERVE_LAYERS, SERVE_NEW_TOKENS = 4, 16
TRAIN_STEPS, TRAIN_SEQ = 4, 4096
WORLD_TOKENS, WORLD_PASSES = 2048, 1     # cut from 4096 to pay for phases 12 and 18
# Phase 8, the folded step against the one-card step (phase 5), bf16 both.
# Step 0 runs both on the same weights and batch: its loss and grad_norm
# differ by bf16 sums in other orders and by the MoE capacity, which the fold
# applies per 1024-token shard and one card per 4096-token stream, so other
# tokens drop. Later steps start from weights that those drops moved apart:
# the loss stays close, grad_norm parts further (measured on an H100: step 0
# 1.6e-3 / 9.4e-3, step 3 2.3e-2 / 9.1e-2), so later steps hold the loss
# to FOLD_TOL_LATER and grad_norm to GRAD_NORM_TOL_LATER.
FOLD_TOL = 2e-2
FOLD_TOL_LATER = 5e-2
GRAD_NORM_TOL_LATER = 0.15
RING_TOL = 5e-3         # ring CP vs all-gather CP, the same fold and routing, bf16
# Phase 9: a run with FSDP off or an fp32 master against the run with FSDP
# on, the same fold, weights and batches: the same math, bf16 sums in
# another order (the FSDP gather's reduce-scatter, ZeRO-1's reduce-scatter).
ZERO_TOL = 5e-3
# Phase 10: a pipelined step against the same step at pp = 1 (the same inner
# fold, weights, batches and microbatches; the stage hand-off is an exact
# copy, so only nondeterministic device sums part them).
PP_TOL = 5e-3
# Phase 17: the dry run's peak of live bytes against the card's
# max_memory_allocated (the allocator rounds blocks and keeps workspaces).
DRYRUN_MEM_TOL = 0.10
TIMING = {"ms": "graph_ms", "library_ms": "graph_ms", "plain_ms": "profiled_ms"}


def _say(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def _peaks() -> tuple:
    """The card's data-sheet peaks, bytes/s and bf16 FLOP/s
    (``roofline.analysis.H100_SXM``: NVIDIA data sheet, dense, 700 W)."""
    from repro_torch.roofline.analysis import H100_SXM
    return H100_SXM.hbm_bw, H100_SXM.peak_flops


def _bound(nbytes: float, flops: float):
    bw, peak = _peaks()
    t_bytes, t_ops = nbytes / bw, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _err(torch, got, ref):
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output has non-finite values")
    max_abs = (got - ref).abs().max().item()
    return max_abs, max_abs / max(ref.abs().max().item(), 1e-30)


def phase_device(torch) -> None:
    _say(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {_smi()}; torch "
         f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _say("[device] TF32 off for matmul and cuDNN: fp32 references run in full fp32")


def phase_build() -> dict:
    from repro_torch.kernels import _build
    path = _build.library_path()
    cached = path.exists()
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    _say(f"[build] {path.relative_to(ROOT)}: {'cached' if cached else 'built'} "
         f"in {secs:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            _say(f"[build]   {line.strip()}")
    return {"seconds": secs, "cached": cached}


MIXTRAL, QWEN2 = "mixtral-8x22b", "qwen2-57b-a14b"
G8T8, QWEN3 = "mixtral-8x22b-g8t8", "qwen3-moe-30b-a3b"     # trained on one card too
LLAMA3, DBRX = "llama3-8x70b", "dbrx-132b"                 # kernel rows only
SHORT = {MIXTRAL: "", QWEN2: "-qwen2", G8T8: "-g8t8", QWEN3: "-qwen3moe",   # path-name suffixes
         "gemma-7b": "-gemma", "qwen2-vl-7b": "-qwen2vl", "whisper-small": "-whisper",
         "xlstm-125m": "-xlstm", "zamba2-2.7b": "-zamba2"}
# Phase 8: the folded train step, 4 ranks on the card. Attention (dp, cp, tp),
# MoE (edp, ep, etp), and its runs (cp_mode, steps; 0 = one forward and
# backward, no optimizer), each from the same start.
TRAIN_WORLD = {MIXTRAL: dict(attn=(1, 2, 2), moe=(1, 4, 1),
                             runs=(("allgather", 2), ("ring", 2))),
               QWEN2: dict(attn=(1, 2, 2), moe=(1, 2, 2), runs=(("allgather", 0),))}


# Phase 9: attention (dp, cp, tp), the MoE folds in order of preference (the
# first whose SP rows are its token shards runs), one sequence a DP rank, and
# per model its runs (cp_mode, steps, fsdp, master_weights, label).
ZERO_ATTN = (2, 1, 2)
ZERO_MOE_FOLDS = ((2, 2, 1), (1, 4, 1))
ZERO_BATCH, ZERO_SEQ = 2, 2048
ZERO_RUNS = {MIXTRAL: (("allgather", 1, True, False, "fsdp"),
                       ("allgather", 1, False, False, "no-fsdp"),
                       ("allgather", 1, True, True, "master"))}


# Phase 10 (a): Mixtral at full width cut to 2 layers (one a stage), PP2 x
# attention (dp, cp, tp) / MoE (edp, ep, etp) below, 1F1B over 4 microbatches
# of one sequence; (b) reduced width in bf16, interleaved PP2 x vpp 2 over 4
# layers, ZeRO-1 over attention DP 2, AdamW steps.
PIPE_FULL = dict(attn=(1, 1, 2), moe=(1, 2, 1), pp=2, vpp=1, microbatch=4, layers=2,
                 seq=2048, steps=0)
PIPE_SMALL = dict(attn=(2, 1, 1), moe=(1, 2, 1), pp=2, vpp=2, microbatch=4, layers=4, seq=256,
                  steps=2)


# Phase 11 (a): phase 9's fold, batches, seed and AdamWConfig under the
# supervisor: 1 step, a save every step keeping 1, a data-stream fault at
# step 0 (so: save 0, crash, restore 0, step 0, save 1: one full-width step
# run, where 2 steps with the fault at step 1 run three); (b) phase 10
# (b)'s fold and the fold it is restored onto. (a)'s checkpoints go to the
# machine's RAM-backed tmpfs: the card's machine counts every byte written
# to its disk against a budget (45 GiB, deletes not returned) that two
# full-width steps (2 x 34.88 GB) exceed, and holds 96 GiB of RAM. keep=1
# holds two steps while a save commits: step 1 and step 0, whose moments
# are zero and stored deflated (``checkpoint.store``), so about the
# parameters' 11.6 GB.
RESUME_STEPS, RESUME_EVERY, RESUME_FAULT = 1, 1, ("data_error", 0)
RESUME_DIR, RESUME_RAM_MARGIN = "/dev/shm", 15e9
RESUME_SECOND = dict(attn=(2, 1, 2), moe=(2, 2, 1), pp=1, vpp=1, microbatch=4)


# Phase 12: Qwen2 at full width cut to 1 layer, FSDP, 1 step of 4 x 2048
# tokens (``SyntheticTokens(seed=0)``). The hand-off world is phase 9's fold
# with 2 sequences a DP rank, the sequence cut over TP; the oracle runs the
# same MoE fold at attention DP4, one whole sequence a rank, so that no
# exchange runs and each MoE token shard is the same sequence in both.
HANDOFF = dict(attn=ZERO_ATTN, moe=(2, 2, 1), seq=2048, batch=4,
               runs=(("allgather", 1, True, False, "fsdp"),
                     ("allgather", 1, True, True, "master")))
HANDOFF_ORACLE = (4, 1, 1)
# The hand-off across DP ranks: pods that extend attention CP and MoE EDP
# (pod_role="cp"). The SP shard is (dp, pod), the MoE shard (pod, ep): MoE
# shard (pod p, ep e) is sequence 2p + e whole, as the oracle's (edp, ep)
# shard is, so token shards cross DP ranks and equal the oracle's.
# Its step is one forward and backward with the global gradient norm (a
# steps = 0 run, no warm-up): the loss, gradient norm and drop fraction
# that the oracle's step 0 reports before its update. An optimizer step
# does not fit: FSDP and ZeRO-1 over DP 2 (not the oracle's 4) leave each
# rank ~20 GB and the card's 79 GiB went out of memory for 4 of them.
HANDOFF_CROSS = dict(attn=(2, 1, 1), moe=(1, 2, 1), pods=2,
                     run=("allgather", 0, True, False, "fsdp"))
# "train-configs": the new configs that fit one card train this many steps.
CONFIG_STEPS = 2


SMALL_BM = (8, 16, 24, 32)  # GMM row blocks of the swap-AB kernel (bm % 64 != 0)


def _gmm_specs(arch: str) -> tuple:
    """(experts, [(label, M, K, N, bm, block_expert, trans_w)]) of a model.

    The serving decode step's two launches first: every expert owning one
    128-row block (``block_expert = arange(E)``), as serving reads them
    (4 tokens, dropless: capacity 4 → 128 rows). Then the training step's
    compute-bound gate/up and down launches (token-dropping CF 1.0 at 4096
    tokens: 1024 rows per expert for Mixtral, 512 for Qwen2) and last the
    ``trans_w`` mode at the training step's two dgrad shapes — dy @ w1[e]^T
    (w1 (E, D, F)) and dy @ w2[e]^T (w2 (E, F, D)) — against ``torch.bmm``
    on the same transposed operands (no copies). Mixtral adds 6 of 8
    experts with two owning no block, 64-row blocks, and the decode
    gate/up and its ``trans_w`` dgrad at row blocks of ``SMALL_BM`` rows
    (one block an expert)."""
    if arch == MIXTRAL:
        E, D, F, rows = 8, 6144, 16384, 1024
    else:
        E, D, F, rows = 64, 3584, 2560, 512
    serving = list(range(E))
    training = [e for e in serving for _ in range(rows // 128)]
    M = E * rows
    specs = [("gate/up, decode (serving)", E * 128, D, F, 128, serving, False),
             ("down, decode (serving)", E * 128, F, D, 128, serving, False)]
    if arch == MIXTRAL:
        specs += [("gate/up, 6 of 8 experts", 1024, D, F, 128, [0, 1, 1, 3, 4, 5, 7, 7], False),
                  ("gate/up, bm=64", 1024, D, F, 64, [e for e in serving for _ in (0, 1)], False)]
        # Row blocks that 64 does not divide (the swap-AB kernel): the 8
        # routed decode rows in one block of bm rows an expert, not 128.
        specs += [(f"gate/up, decode bm={bm}", E * bm, D, F, bm, serving, False)
                  for bm in SMALL_BM]
        specs += [(f"dgrad trans_w, decode bm={bm}", E * bm, F, D, bm, serving, True)
                  for bm in SMALL_BM]
    specs += [(f"gate/up, M={M}", M, D, F, 128, training, False),
              (f"down, M={M}", M, F, D, 128, training, False),
              (f"dgrad trans_w, M={M}", M, F, D, 128, training, True),
              (f"dgrad trans_w down, M={M}", M, D, F, 128, training, True)]
    return E, specs


def _gmm_cases(torch, E: int, specs: list) -> list:
    """Each GMM spec of :func:`_gmm_specs`' form over ``E`` experts: error
    against the plain version, device times and bound."""
    from repro_torch.kernels.gmm.gmm import gmm
    from repro_torch.kernels.gmm.ref import gmm_ref
    from repro_torch.launch.devtime import graph_ms, profiled_ms
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for label, M, K, N, bm, blocks, trans in specs:
        be = torch.tensor(blocks, dtype=torch.int32, device="cuda")
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        w_shape = (E, N, K) if trans else (E, K, N)
        w = (torch.randn(w_shape, generator=g, device="cuda") * K ** -0.5).to(torch.bfloat16)
        y = gmm(x, w, be, bm=bm, trans_w=trans)
        ref = gmm_ref(x, w, be, bm=bm, trans_w=trans)
        torch.cuda.synchronize()
        max_abs, rel = _err(torch, y, ref)
        del y, ref
        ms = graph_ms(torch, lambda: gmm(x, w, be, bm=bm, trans_w=trans))
        plain_ms = profiled_ms(torch, lambda: gmm_ref(x, w, be, bm=bm, trans_w=trans))
        # The same bytes through one batched matmul: x as (E, M/E, K).
        xe, wk = x.view(E, M // E, K), (w.transpose(1, 2) if trans else w)
        library_ms = graph_ms(torch, lambda: torch.bmm(xe, wk))
        n_used = len(set(blocks))
        nbytes = 2 * (M * K + M * N + n_used * K * N)
        bound_ms, bound_by = _bound(nbytes, 2.0 * M * K * N)
        cases.append(dict(case=label, shape=f"x({M},{K}) w{w_shape} bm={bm}"
                                            + (" trans_w" if trans else ""),
                          trans_w=trans, max_abs_err=max_abs, rel_err=rel, ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms))
        del x, w, xe, wk
        torch.cuda.empty_cache()
    return cases


# (label, Sq, Skv, q_offset per batch row[, kv_offset]); heads of 128.
FLASH_HEADS = {MIXTRAL: (48, 8), QWEN2: (28, 4)}
FLASH_CASES = {
    MIXTRAL: (("decode (serving)", 1, 512, [0, 37, 300, 511]),
              ("prefill chunk", 200, 512, [312]),
              ("long decode", 1, 32768, [32767, 30000, 16000, 8191]),
              ("causal self-attention 4096", 4096, 4096, [0])),
    QWEN2: (("decode (serving)", 1, 512, [0, 37, 300, 511]),
            ("decode, 3 queries (a group across two row tiles)", 3, 512, [0, 61, 250, 509]),
            ("prefill chunk", 128, 512, [384]),
            ("causal self-attention 4096", 4096, 4096, [0])),
}
# The kernels line: one entry per kernel per main path that launches it,
# timed at that path's main shape and counted in that path's own run.
HEADLINE = {("gmm", "serve"): "gate/up, decode (serving)",
            ("flash_attention", "serve"): "decode (serving), normalized",
            ("gmm", "train"): "gate/up, M={M}",
            ("gmm_trans_w", "train"): "dgrad trans_w, M={M}",
            ("flash_attention", "train"): "causal self-attention 4096, partial"}


def _flash_cases(torch, arch: str, cases=None, heads=None, modes=(False, True),
                 hd: int = 128, causal: bool = True) -> list:
    """Flash cases (default: the model's ``FLASH_CASES`` at its heads) in
    the output ``modes`` (partial or not). ``library_ms`` is the fastest of
    the ``scaled_dot_product_attention`` forms that compute the same
    function on the same (GQA) inputs: an explicit mask (offsets differ per
    row), ``is_causal`` where the queries start at key 0, and no mask where
    every key is visible (not ``causal``, or a decode row at the last key:
    then the mask form is not timed). Keys sit at
    ``kv_offset + j``; a query row that sees none (a ring pair wholly in its
    future) must agree with the plain version's ``m = -1e30, l = 0, acc = 0``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.flash.ref import flash_ref
    from repro_torch.launch.devtime import graph_ms, profiled_ms
    g = torch.Generator(device="cuda").manual_seed(2)
    H, Hkv = heads or FLASH_HEADS[arch]
    out = []
    for label, Sq, L, offsets, *kv in cases or FLASH_CASES[arch]:
        kv_off = kv[0] if kv else 0
        B = len(offsets)
        q = torch.randn((B, H, Sq, hd), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, Hkv, L, hd), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, Hkv, L, hd), generator=g, device="cuda").to(torch.bfloat16)
        q_off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
        q_pos = q_off[:, None].long() + torch.arange(Sq, device="cuda")          # (B, Sq)
        kv_pos = kv_off + torch.arange(L, device="cuda")
        vis = kv_pos[None, None, :] <= q_pos[:, :, None]
        if not causal:
            vis = torch.ones_like(vis)
        n_vis = vis.sum().item()                         # visible (row, key) pairs per head
        n_keys = sum(max(0, min(L, o + Sq - kv_off)) if causal else L
                     for o in offsets)                   # KV rows seen
        mask = vis[:, None]
        forms = {"SDPA attn_mask, enable_gqa": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)}
        if vis.all():
            forms = {"SDPA no mask, enable_gqa": lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True)}
        elif all(o == 0 for o in offsets) and Sq == L and kv_off == 0:
            forms["SDPA is_causal, enable_gqa"] = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        library = {name: graph_ms(torch, fn) for name, fn in forms.items()}
        library_form = min(library, key=library.get)
        for partial in modes:
            def run(partial=partial):
                return flash_attention(q, k, v, q_off, kv_offset=kv_off, causal=causal,
                                       return_partial=partial)

            def plain(partial=partial):
                return flash_ref(q, k, v, q_off, kv_offset=kv_off, causal=causal,
                                 return_partial=partial)
            got, ref = run(), plain()
            torch.cuda.synchronize()
            pairs = list(zip(got, ref)) if partial else [(got, ref)]
            errs = [_err(torch, a, b) for a, b in pairs]
            max_abs, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            del got, ref, pairs
            ms = graph_ms(torch, run)
            plain_ms = profiled_ms(torch, plain, calls=3)
            out_bytes = B * H * Sq * (hd * 4 + 8) if partial else B * H * Sq * hd * 2
            nbytes = 2 * B * H * Sq * hd + 2 * 2 * Hkv * hd * n_keys + out_bytes
            bound_ms, bound_by = _bound(nbytes, 4.0 * hd * H * n_vis)
            out.append(dict(case=f"{label}, {'partial' if partial else 'normalized'}",
                            shape=f"q({B},{H},{Sq},{hd}) kv({B},{Hkv},{L},{hd}) "
                                  f"q_offset={offsets} kv_offset={kv_off}",
                            max_abs_err=max_abs, rel_err=rel, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library[library_form], library_form=library_form,
                            library_all=library, visible_pairs=n_vis))
        del q, k, v, mask, vis
        torch.cuda.empty_cache()
    return out


def _attention_backward(torch, arch: str) -> dict:
    """The training step's attention backward at causal 4096 tokens: the
    port's (``blockwise_attention``: flash kernel forward, ``_bwd_scan`` in
    torch ops backward) and SDPA's (``is_causal``, ``enable_gqa``), each
    timed as ``graph_ms`` of forward and backward less ``graph_ms`` of the
    forward. Bound: FlashAttention-2's five products over the visible half."""
    import torch.nn.functional as F
    from repro_torch.launch.devtime import graph_ms
    from repro_torch.models.attn_core import blockwise_attention
    g = torch.Generator(device="cuda").manual_seed(3)
    (H, Hkv), hd, S = FLASH_HEADS[arch], 128, 4096

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) \
            .requires_grad_()
    q, k, v = rand(1, H, S, hd), rand(1, Hkv, S, hd), rand(1, Hkv, S, hd)
    dout = torch.randn((1, H, S, hd), generator=g, device="cuda").to(torch.bfloat16)
    fns = {"port": lambda: blockwise_attention(q, k, v),
           "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True)}
    out = {}
    for name, fwd in fns.items():
        fwd_ms = graph_ms(torch, fwd)
        both_ms = graph_ms(torch, lambda fwd=fwd: torch.autograd.grad(fwd(), (q, k, v), dout))
        out[name] = dict(forward_ms=fwd_ms, forward_backward_ms=both_ms,
                         backward_ms=both_ms - fwd_ms)
    n_vis = S * (S + 1) // 2
    bound_ms, bound_by = _bound(0, 2.0 * 5 * hd * H * n_vis)
    out.update(shape=f"q(1,{H},{S},{hd}) kv(1,{Hkv},{S},{hd}) causal", bound_ms=bound_ms,
               bound_by=bound_by)
    _say(f"[kernels] attention backward {out['shape']}: port (_bwd_scan) "
         f"{out['port']['backward_ms']:.4f} ms, SDPA {out['sdpa']['backward_ms']:.4f} ms "
         f"(forward + backward {out['port']['forward_backward_ms']:.4f} / "
         f"{out['sdpa']['forward_backward_ms']:.4f} ms), bound {bound_ms:.4f} ms ({bound_by})")
    del q, k, v, dout
    torch.cuda.empty_cache()
    return out


def phase_kernels(torch, arch: str) -> dict:
    _say(f"[kernels] {arch}: device time: kernel and library_ms by graph_ms (a CUDA graph "
         "of 20 calls), plain_ms by profiled_ms (torch.profiler kernel times)")
    gmm_cases = _gmm_cases(torch, *_gmm_specs(arch))
    out = {"gmm": [c for c in gmm_cases if not c["trans_w"]],
           "gmm_trans_w": [c for c in gmm_cases if c["trans_w"]],
           "flash_attention": _flash_cases(torch, arch)}
    _check_cases(arch, out)
    out["attention_backward"] = _attention_backward(torch, arch)
    torch.cuda.empty_cache()
    return out


def _check_cases(arch: str, out: dict) -> None:
    """Print each kernel case and hold it to ``REL_TOL``."""
    for name, cases in out.items():
        for c in cases:
            _say(f"[kernels] {arch} {name} {c['case']} {c['shape']}: max_abs_err "
                 f"{c['max_abs_err']:.3e} rel_err {c['rel_err']:.3e}; device time: kernel "
                 f"{c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}), "
                 f"plain {c['plain_ms']:.4f} ms, library_ms {c['library_ms']:.4f}"
                 + (f" ({c['library_form']})" if "library_form" in c else ""))
            if not c["rel_err"] <= REL_TOL:
                raise AssertionError(f"{arch} {name} {c['case']}: relative error "
                                     f"{c['rel_err']:.3e} > {REL_TOL}")


def _zero_counters() -> None:
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.gmm.gmm import gmm
    gmm.launches = gmm.trans_w_launches = flash_attention.launches = 0
    flash_attention.qpos_launches = 0


def _read_counters() -> dict:
    """Launches by kernel mode: the GMM forward mode, its trans_w mode,
    flash, and of those flash's with ``q_pos`` (``flash_attention_qpos``,
    a key only where there were some: a path whose expected counts lack it
    fails if it launched the ``QPOS`` instantiations, which its kernel row
    does not time)."""
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.gmm.gmm import gmm
    out = {"gmm": gmm.launches - gmm.trans_w_launches, "gmm_trans_w": gmm.trans_w_launches,
           "flash_attention": flash_attention.launches}
    if flash_attention.qpos_launches:
        out["flash_attention_qpos"] = flash_attention.qpos_launches
    return out


def phase_serve(torch, arch: str) -> dict:
    import numpy as np
    from repro_torch.launch.serve import PROMPT_LENS, run_requests, slice_config
    from repro_torch.models.transformer import init_lm

    tag = "serve" + SHORT[arch]
    cfg = slice_config(arch, layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    new_tokens = SERVE_NEW_TOKENS
    torch.cuda.reset_peak_memory_stats()

    _zero_counters()
    t0 = time.perf_counter()
    eng, rids, res = run_requests(cfg, params, PROMPT_LENS, new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()

    n_fwd = sum(1 for s in eng.stats if s.prefill_tokens) + \
        sum(1 for s in eng.stats if s.decode_tokens)
    expect = {"gmm": 3 * cfg.n_layers * n_fwd, "gmm_trans_w": 0,
              "flash_attention": cfg.n_layers * n_fwd}
    if launches != expect or min(launches["gmm"], launches["flash_attention"]) == 0:
        raise AssertionError(f"{tag} launch counts {launches} != expected {expect} "
                             f"({n_fwd} forwards x {cfg.n_layers} layers)")
    for rid in rids:
        r = res[rid]
        toks = r.tokens
        if not (r.finished and len(toks) == new_tokens):
            raise AssertionError(f"{tag} request {rid} did not finish: {r}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{tag} request {rid}: token out of vocabulary")
        if r.last_prefill_logits.shape != (cfg.vocab_size,) or \
                not np.isfinite(r.last_prefill_logits).all():
            raise AssertionError(f"{tag} request {rid}: bad prefill logits")
    pre_tok = sum(s.prefill_tokens for s in eng.stats)
    dec_tok = sum(s.decode_tokens for s in eng.stats)
    pre_s = sum(t[0] for t in eng.timings)
    dec_times = [t[1] for t in eng.timings if t[1] > 0]
    out = dict(
        model=f"{cfg.name} x{cfg.n_layers} layers (full width), bf16, {n_params / 1e9:.2f} B params",
        init_s=init_s, requests=len(rids), steps=len(eng.stats), forwards=n_fwd,
        launches=launches, wall_s=wall, prefill_tokens=pre_tok, decode_tokens=dec_tok,
        prefill_tok_per_s=pre_tok / pre_s, decode_tok_per_s=dec_tok / sum(dec_times),
        decode_step_ms_median=statistics.median(dec_times) * 1e3,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        # For phase 13 only (main() takes it out before results/ is written).
        reference=[dict(tokens=res[r].tokens.tolist(), logits=res[r].last_prefill_logits)
                   for r in rids])
    _say(f"[{tag}] {out['model']}: {len(rids)} requests, {out['steps']} steps, "
         f"{n_fwd} forwards, wall {wall:.3f} s, launches {launches}")
    _say(f"[{tag}] prefill {pre_tok} tokens at {out['prefill_tok_per_s']:.1f} tok/s; "
         f"decode {dec_tok} tokens at {out['decode_tok_per_s']:.1f} tok/s, median step "
         f"{out['decode_step_ms_median']:.3f} ms; max_memory_allocated "
         f"{out['max_memory_allocated_gb']:.2f} GB")
    del eng, params
    torch.cuda.empty_cache()
    return out


def phase_train(torch, arch: str, steps: int = TRAIN_STEPS, tag: str = "") -> dict:
    """The full-width model cut to 1 layer: ``steps`` steps of one
    TRAIN_SEQ-token sequence through ``make_train_step`` (the port's entry
    point), launch counters set to 0 just before and read just after."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.dryrun import state_bytes
    from repro_torch.launch.train import PEAK_BF16_FLOPS, step_flops, train_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.transformer import leaf_rank
    from repro_torch.train.loop import init_train_state, make_train_step

    tag = tag or "train" + SHORT[arch]
    cfg = train_config(arch, layers=1)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    opt = init_train_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, guard=True)
    data = SyntheticTokens(DataConfig(seq_len=TRAIN_SEQ, global_batch=1,
                                      vocab_size=cfg.vocab_size))
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
               for _ in range(steps)]
    named = dict(params.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    flops = step_flops(cfg, TRAIN_SEQ, 1)
    # AdamW reads each fp32 master, moment pair and (bf16 or fp32) gradient
    # once and writes the master and moments once.
    opt_bytes = sum(p.numel() * (24 + (2 if leaf_rank(n, p) >= 2 else 4))
                    for n, p in named.items())
    compute_bound_ms, _ = _bound(0, flops)
    opt_bound_ms, _ = _bound(opt_bytes, 0)
    stored = state_bytes(params, opt)            # the dry run's arg_bytes (phase 17)
    del named
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero_counters()
    rows = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        row = {k: float(v) for k, v in m.items()}
        row.update(step_ok=bool(m["step_ok"]), step_ms=dt * 1e3, tok_per_s=TRAIN_SEQ / dt,
                   mfu=flops / dt / PEAK_BF16_FLOPS)
        rows.append(row)
    launches = _read_counters()
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 1e9

    expect = {"gmm": 6 * cfg.n_layers * steps,            # forward + remat
              "gmm_trans_w": 3 * cfg.n_layers * steps,    # dgrad
              "flash_attention": 2 * cfg.n_layers * steps}
    if launches != expect:
        raise AssertionError(f"{tag} launch counts {launches} != expected {expect}")
    for i, r in enumerate(rows):
        _say(f"[{tag}] step {i}: loss {r['loss']:.4f} (ce {r['ce_loss']:.4f}, aux "
             f"{r['moe_aux_loss']:.4f}, z {r['moe_z_loss']:.4f}, drop "
             f"{r['moe_drop_fraction']:.4f}), grad_norm {r['grad_norm']:.4f}, step_ok "
             f"{r['step_ok']}; wall {r['step_ms']:.3f} ms, {r['tok_per_s']:.1f} tok/s, "
             f"MFU {100 * r['mfu']:.2f}%")
        if not (r["step_ok"] and all(x == x and abs(x) != float("inf")
                                     for x in (r["loss"], r["grad_norm"]))):
            raise AssertionError(f"{tag} step {i}: non-finite loss or step_ok false: {r}")
    warm = [r["step_ms"] for r in rows[1:]]
    out = dict(model=f"{cfg.name} x{cfg.n_layers} layer (full width), {n_params / 1e9:.3f} B "
                     "params, fp32 masters + AdamW, bf16 compute, remat full",
               tokens_per_step=TRAIN_SEQ, init_s=init_s, steps=rows, launches=launches,
               step_ms_warm_median=statistics.median(warm),
               tok_per_s_warm=TRAIN_SEQ / statistics.median(warm) * 1e3,
               mfu_warm=flops / (statistics.median(warm) / 1e3) / PEAK_BF16_FLOPS,
               model_tflop_per_step=flops / 1e12, compute_bound_ms=compute_bound_ms,
               optimizer_bytes=opt_bytes, optimizer_bound_ms=opt_bound_ms,
               max_memory_allocated_gb=peak_gb, max_memory_allocated_bytes=peak_bytes,
               state_bytes=stored)
    _say(f"[{tag}] {out['model']}: launches {launches}; warm step (median of steps 1-"
         f"{steps - 1}) {out['step_ms_warm_median']:.3f} ms, {out['tok_per_s_warm']:.1f} "
         f"tok/s, MFU {100 * out['mfu_warm']:.2f}%; max_memory_allocated {peak_gb:.2f} GB")
    _say(f"[{tag}] bounds: compute {compute_bound_ms:.3f} ms ({flops / 1e12:.3f} model TFLOP "
         f"at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s), optimizer {opt_bound_ms:.3f} ms "
         f"({opt_bytes / 1e9:.2f} GB at {_peaks()[0] / 1e12:.2f} TB/s)")
    del params, opt, step, batches
    torch.cuda.empty_cache()
    return out


def phase_check(torch, arch: str, cfg=None) -> dict:
    """Reduced slice (or ``cfg``): kernels on the card vs plain versions on
    the CPU, same weights."""
    import copy

    import numpy as np
    from repro_torch.launch.serve import run_requests, slice_config
    from repro_torch.models.transformer import init_lm

    cfg = cfg or slice_config(arch, reduce=True)
    cpu = init_lm(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    lens = (5, 40, 19, 130)
    kw = {"cache": "dense"} if cfg.shared_attention_every else {}   # as launch/serve.py serves it
    _, rids, res_g = run_requests(cfg, gpu, lens, 8, **kw)
    _, _, res_c = run_requests(cfg, cpu, lens, 8, **kw)
    worst, same = 0.0, 0
    for rid in rids:
        a, b = res_g[rid].last_prefill_logits, res_c[rid].last_prefill_logits
        if not np.isfinite(a).all():
            raise AssertionError(f"request {rid}: non-finite logits on the card")
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
        same += int(np.array_equal(res_g[rid].tokens, res_c[rid].tokens))
    _say(f"[check] {arch} reduced slice, card vs CPU plain versions: prefill logits rel err "
         f"{worst:.3e} (limit {CHECK_TOL}), {same}/{len(rids)} requests with equal greedy tokens")
    if not worst <= CHECK_TOL:
        raise AssertionError(f"{arch} reduced slice: card vs CPU logits rel err {worst:.3e}")
    return {"prefill_logits_rel_err": worst, "equal_token_requests": same,
            "requests": len(rids)}


# Reduced widths at the real fan-out of the configs trained in
# "train-configs": ``reduced()`` caps experts at 4 of top-2 and heads at 64,
# so those are set back (and qwen3-moe's 128-wide heads: q width 512 over
# d_model 256). At 64 and 128 experts top-8 many tokens sit near their
# top-8 boundary, so the bf16 sums of the card and of the CPU route a few
# of them differently, and with token dropping each such token moves
# others across the capacity line: layer 1's expert gradients came 8.1e-2
# apart on an H100. So their card-vs-CPU training check runs dropless,
# where a moved token changes only its own rows.
FANOUT = {G8T8: dict(n_experts=64, top_k=8), QWEN3: dict(n_experts=128, top_k=8)}
HEAD_DIM = {QWEN3: 128}


def _reduced_train_config(arch: str):
    """The reduced training config of ``arch`` (fp32), at the real expert
    count, top-k and head size for the configs of ``FANOUT``."""
    import dataclasses
    from repro_torch.launch.train import train_config
    cfg = train_config(arch, reduce=True)
    if arch not in FANOUT:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **FANOUT[arch]),
                               **({"head_dim": HEAD_DIM[arch]} if arch in HEAD_DIM else {}))


def phase_train_check(torch, arch: str, cfg=None, dtype: str = "bfloat16") -> dict:
    """Reduced training slice (or ``cfg``), in ``dtype``, the kernels on the card vs
    the plain versions on the CPU, same weights and batches (with the
    arch's stub inputs, ``materialize_batch``): step 1's gradients leaf by
    leaf (relative L2), then two steps' loss and gradient norm. The
    learning rate warms up in 2 steps, so step 2 sees step 1's update."""
    import copy
    import dataclasses

    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens, mark_runs,
                                           materialize_batch)
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import cast_params, init_train_state, loss_fn, make_train_step

    cfg = dataclasses.replace(cfg or _reduced_train_config(arch), dtype=dtype)
    if arch in FANOUT:                      # dropless: see FANOUT
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=True))
    cpu = init_lm(cfg, seed=3, device="cpu")
    runs = {"card": ("cuda", copy.deepcopy(cpu).to("cuda")), "cpu": ("cpu", cpu)}
    data = SyntheticTokens(DataConfig(seq_len=256, global_batch=2, vocab_size=cfg.vocab_size,
                                      seed=3))
    batches = [mark_runs(materialize_batch(cfg, next(data))) for _ in range(2)]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=100)
    out, grads = {}, {}
    for run, (dev, params) in runs.items():
        cparams = cast_params(params, cfg)
        loss, _ = loss_fn(cparams, {k: torch.from_numpy(v).to(dev)
                                    for k, v in batches[0].items()}, cfg)
        loss.backward()
        grads[run] = {n: p.grad.float().cpu() for n, p in cparams.named_parameters()}
        del cparams, loss
        opt = init_train_state(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, guard=True)
        out[run] = []
        for b in batches:
            params, opt, m = step(params, opt, {k: torch.from_numpy(v).to(dev)
                                                for k, v in b.items()})
            out[run].append({k: float(m[k]) for k in ("loss", "grad_norm", "step_ok")})
    leaf_err = {n: float((grads["card"][n] - c).norm() / c.norm().clamp_min(1e-30))
                for n, c in grads["cpu"].items()}
    worst_leaf = max(leaf_err, key=leaf_err.get)
    what = ("dense" if cfg.moe is None else f"{cfg.moe.n_experts} experts top-"
            f"{cfg.moe.top_k}{', dropless' if cfg.moe.dropless else ''}")
    _say(f"[check] {arch} reduced training ({what}), step 1 gradients, card vs CPU plain "
         "versions: "
         f"{len(leaf_err)} leaves, worst relative L2 {leaf_err[worst_leaf]:.3e} "
         f"({worst_leaf}; limit {CHECK_TOL})")
    if not leaf_err[worst_leaf] <= CHECK_TOL:
        raise AssertionError(f"{arch} reduced training: gradient of {worst_leaf} card vs CPU "
                             f"rel L2 {leaf_err[worst_leaf]:.3e}")
    worst = 0.0
    for g, c in zip(out["card"], out["cpu"]):
        if not (g["step_ok"] and c["step_ok"]):
            raise AssertionError(f"{arch} reduced training step not ok: card {g}, CPU {c}")
        for k in ("loss", "grad_norm"):
            worst = max(worst, abs(g[k] - c[k]) / abs(c[k]))
    _say(f"[check] {arch} reduced training, 2 steps, card vs CPU plain versions: loss and "
         f"grad_norm rel err {worst:.3e} (limit {CHECK_TOL}); card {out['card']}, CPU {out['cpu']}")
    if not worst <= CHECK_TOL:
        raise AssertionError(f"{arch} reduced training: card vs CPU rel err {worst:.3e}")
    return {"rel_err": worst, "card": out["card"], "cpu": out["cpu"],
            "grad_rel_l2": leaf_err}


def phase_moe_check(torch, arch: str) -> dict:
    """:func:`_moe_check` at the config's GMM row block (128) and again at
    ``gmm_block_m=16``, whose sort layout runs the GMM's swap-AB kernel
    (passes of 16 rows or more): its launches counted from 0 over that
    check's card run."""
    import dataclasses
    from repro_torch.launch.serve import slice_config
    cfg = slice_config(arch, reduce=True)
    out = _moe_check(torch, arch, cfg)
    small = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, gmm_block_m=SMALL_BM[1]))
    out["block_m_16"] = _moe_check(torch, arch, small)
    return out


def _moe_check(torch, arch: str, cfg) -> dict:
    """The reduced MoE layer with its shared expert, bf16, on the card
    against the CPU's plain path on the same weights and tokens: the
    dropless ``capacity_hint`` pre-pass (an int, equal on both), the sort
    layout with that hint (nothing dropped), and the scatter layout."""
    import copy

    from repro_torch.core.dispatcher import routed_capacity_hint
    from repro_torch.core.moe_layer import moe_block
    from repro_torch.models.transformer import init_lm

    cpu = init_lm(cfg, seed=4, dtype=torch.bfloat16, device="cpu").layers[0].moe
    runs = {"card": ("cuda", copy.deepcopy(cpu).to("cuda")), "cpu": ("cpu", cpu)}
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 384, cfg.d_model), generator=g).to(torch.bfloat16)
    hints, ys = {}, {}
    for run, (dev, p) in runs.items():
        xd = x.to(dev)
        with torch.no_grad():
            hints[run] = routed_capacity_hint(xd.reshape(-1, cfg.d_model), p.router, cfg.moe)
            if dev == "cuda":
                torch.cuda.synchronize()
                _zero_counters()
            y_sort, aux = moe_block(p, xd, cfg, capacity_hint=hints[run])
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = _read_counters()
            y_scatter, aux_s = moe_block(p, xd, cfg, permute_mode="scatter")
        if float(aux["moe_drop_fraction"]) or float(aux_s["moe_drop_fraction"]):
            raise AssertionError(f"{arch} reduced MoE layer ({run}): a dropless run dropped")
        ys[run] = {"sort": y_sort.float().cpu(), "scatter": y_scatter.float().cpu()}
    if hints["card"] != hints["cpu"]:
        raise AssertionError(f"{arch} capacity_hint card {hints['card']} != CPU {hints['cpu']}")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    errs = {f"{mode} card vs CPU": rel(ys["card"][mode], ys["cpu"][mode])
            for mode in ("sort", "scatter")}
    errs["card sort vs card scatter"] = rel(ys["card"]["sort"], ys["card"]["scatter"])
    _say(f"[check] {arch} reduced MoE layer (shared expert, gate {cfg.moe.shared_expert_gate}, "
         f"gmm_block_m {cfg.moe.gmm_block_m}), {x.shape[0] * x.shape[1]} tokens: capacity_hint "
         f"{hints['card']} on both (worst case {x.shape[0] * x.shape[1]}); sort launches "
         f"{launches}; rel err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
         + f" (limit {CHECK_TOL})")
    if not max(errs.values()) <= CHECK_TOL:
        raise AssertionError(f"{arch} reduced MoE layer: {errs}")
    if not (launches["gmm"] >= 3 and launches["gmm"] % 3 == 0):
        raise AssertionError(f"{arch} reduced MoE layer, gmm_block_m {cfg.moe.gmm_block_m}: "
                             f"sort launches {launches}, not 3 GMM a dispatcher chunk")
    return {"capacity_hint": hints["card"], "tokens": x.shape[0] * x.shape[1],
            "gmm_block_m": cfg.moe.gmm_block_m, "launches": launches, "rel_err": errs}


def _world_gmm(torch, arch: str) -> dict:
    """The GMM at the world's launch shapes (forward gate/up and the
    ``trans_w`` dgrad of the same product), timed as in phase 3."""
    from repro_torch.launch.world import gmm_shape
    s = gmm_shape(arch, WORLD_TOKENS)
    E, rows, D, F, bm = s["experts"], s["rows_per_expert"], s["d_model"], s["d_expert"], s["bm"]
    M = E * rows
    blocks = [e for e in range(E) for _ in range(rows // bm)]
    cases = _gmm_cases(torch, E, [(f"world gate/up, M={M}", M, D, F, bm, blocks, False),
                                  (f"world dgrad trans_w, M={M}", M, F, D, bm, blocks, True)])
    out = {"gmm": cases[:1], "gmm_trans_w": cases[1:]}
    _check_cases(arch, out)
    return out


def phase_world(torch) -> dict:
    """Phase 7: see the module docstring."""
    from repro_torch.launch.world import FOLDS, moe_world, nccl_world_of_one

    out = {}
    for arch in (MIXTRAL, QWEN2):
        tag = "moe-world" + SHORT[arch]
        fold, ragged = FOLDS[arch]
        t0 = time.perf_counter()
        ranks = moe_world(arch, device="cuda", tokens=WORLD_TOKENS, passes=WORLD_PASSES)
        wall = time.perf_counter() - t0
        C = ranks[0]["chunks"]
        expect_fwd = {"gmm": 3 * C, "gmm_trans_w": 0}
        expect_bwd = {"gmm": 0, "gmm_trans_w": 3 * C}
        fwd_ms = [statistics.median(r["forward_s"]) * 1e3 for r in ranks]
        both_ms = [statistics.median(r["forward_backward_s"]) * 1e3 for r in ranks]
        for r in ranks:
            worst = max(r["grad_rel_l2"], key=r["grad_rel_l2"].get)
            _say(f"[{tag}] rank {r['rank']} (token shard {r['shard']}): forward rel err "
                 f"{r['forward_rel_err']:.3e} (limit {REL_TOL}); gradients rel L2 "
                 + ", ".join(f"{k} {v:.3e}" for k, v in r["grad_rel_l2"].items())
                 + f" (worst {worst}, limit {CHECK_TOL}); launches forward "
                 f"{r['launches_forward']} backward {r['launches_backward']} (expected "
                 f"{expect_fwd} / {expect_bwd})"
                 + (f"; ragged == padded: {r['ragged_equal']}" if ragged else ""))
            if not r["forward_rel_err"] <= REL_TOL:
                raise AssertionError(f"{tag} rank {r['rank']}: forward rel err "
                                     f"{r['forward_rel_err']:.3e}")
            if not r["grad_rel_l2"][worst] <= CHECK_TOL:
                raise AssertionError(f"{tag} rank {r['rank']}: gradient of {worst} rel L2 "
                                     f"{r['grad_rel_l2'][worst]:.3e}")
            if r["launches_forward"] != expect_fwd or r["launches_backward"] != expect_bwd:
                raise AssertionError(f"{tag} rank {r['rank']}: launches {r['launches_forward']}"
                                     f" / {r['launches_backward']} != {expect_fwd} / {expect_bwd}")
            if ragged and not r["ragged_equal"]:
                raise AssertionError(f"{tag} rank {r['rank']}: ragged output != padded output")
        pay = ranks[0]["payload"]
        rag_ms = [statistics.median(r["ragged_forward_s"]) * 1e3 for r in ranks] if ragged \
            else None
        _say(f"[{tag}] MoE EDP{fold[0]}xEP{fold[1]}xETP{fold[2]} on {len(ranks)} ranks "
             f"(gloo through the host, one card), {WORLD_TOKENS} tokens a rank, {C} chunks: "
             f"forward {statistics.median(fwd_ms):.1f} ms, forward + backward "
             f"{statistics.median(both_ms):.1f} ms"
             + (f", ragged forward {statistics.median(rag_ms):.1f} ms" if ragged else "")
             + f" (median over ranks of each rank's median of {WORLD_PASSES} warm passes); "
             f"phase wall {wall:.1f} s")
        _say(f"[{tag}] EP payload a rank a direction: padded {pay['padded_bytes'] / 1e6:.1f} MB"
             f", ragged send max {pay['ragged_send_bytes_max'] / 1e6:.1f} MB / mean "
             f"{pay['ragged_send_bytes_mean'] / 1e6:.1f} MB, recv max "
             f"{pay['ragged_recv_bytes_max'] / 1e6:.1f} MB; capacity {pay['capacity']:.0f}")
        out[arch] = dict(fold=fold, ranks=ranks, chunks=C, wall_s=wall,
                         forward_ms_median=statistics.median(fwd_ms),
                         forward_backward_ms_median=statistics.median(both_ms),
                         ragged_forward_ms_median=rag_ms and statistics.median(rag_ms),
                         launches=ranks[0]["launches"], payload=ranks[0]["payload"],
                         kernels=_world_gmm(torch, arch))
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = nccl_world_of_one(MIXTRAL, tokens=WORLD_TOKENS)
    _say(f"[moe-world] a world of 1 over NCCL, Mixtral, every group of size 1 "
         f"({time.perf_counter() - t0:.1f} s): " + ", ".join(f"{k} {v}" for k, v in one.items()))
    if not all(v for k, v in one.items() if k != "chunks"):
        raise AssertionError(f"NCCL world of 1: {one}")
    out["nccl_world_of_one"] = one
    return out


def _train_world_kernels(torch, arch: str) -> dict:
    """The kernels at phase 8's launch shapes, timed as in phase 3: flash in
    partial mode at a TP rank's heads — all-gather CP (the queries of either
    CP chunk against the whole sequence) and, for the ring, one pair of
    each kind (diagonal, wholly visible, wholly masked) at the zigzag runs'
    offsets — and the GMM forward and ``trans_w`` at the EP shard's shape."""
    from repro_torch.core.folding import zigzag_runs
    from repro_torch.launch.world import gmm_shape
    w = TRAIN_WORLD[arch]
    cp, tp = w["attn"][1], w["attn"][2]
    H, Hkv = (h // tp for h in FLASH_HEADS[arch])
    S, chunk = TRAIN_SEQ, TRAIN_SEQ // cp
    cases = [(f"all-gather CP, queries of chunk {i}", chunk, S, [i * chunk]) for i in range(cp)]
    if any(mode == "ring" for mode, _ in w["runs"]):
        (a, b), _ = zigzag_runs(S, cp)[:2]
        half = S // (2 * cp)
        cases += [("ring pair, diagonal", half, half, [a], a),
                  ("ring pair, keys wholly visible", half, half, [b], a),
                  ("ring pair, keys wholly masked", half, half, [a], b)]
    flash = _flash_cases(torch, arch, cases, heads=(H, Hkv), modes=(True,))
    s = gmm_shape(arch, S // (cp * tp), fold=w["moe"])
    E, rows, D, F, bm = s["experts"], s["rows_per_expert"], s["d_model"], s["d_expert"], s["bm"]
    M = E * rows
    blocks = [e for e in range(E) for _ in range(rows // bm)]
    gmm_cases = _gmm_cases(torch, E, [(f"train-world gate/up, M={M}", M, D, F, bm, blocks, False),
                                      (f"train-world dgrad trans_w, M={M}", M, F, D, bm, blocks,
                                       True)])
    out = {"gmm": gmm_cases[:1], "gmm_trans_w": gmm_cases[1:], "flash_attention": flash}
    _check_cases(arch, out)
    out["gmm_shape"] = s
    return out


def _expected_world_launches(arch: str, mode: str, steps: int, attn=None,
                             tokens: int = TRAIN_SEQ) -> dict:
    """Launches a rank makes in one run of phase 8 (or 9 and 12, at attention
    fold ``attn``), from the code: per layer and forward, ``3 · chunks`` GMM
    (the layer's forward and remat's recompute) and ``3 · chunks``
    ``trans_w`` in the backward (the MoE input has a gradient), and one
    flash launch (all-gather: the DP rank's sequences in one launch) or
    ``4 · cp`` (the ring: four (q half, kv half) pairs a ring step), twice
    with remat. A rank's tokens are its DP rank's ``tokens`` over cp · tp."""
    from repro_torch.core.overlap import resolve_chunks
    from repro_torch.launch.train import train_config
    cfg = train_config(arch, layers=1)
    _, cp, tp = attn or TRAIN_WORLD[arch]["attn"]
    C = resolve_chunks(tokens // (cp * tp), cfg.moe.overlap_chunks)
    flash = 4 * cp if mode == "ring" and cp > 1 else 1
    n = max(steps, 1) * cfg.n_layers
    return {"gmm": 6 * C * n, "gmm_trans_w": 3 * C * n, "flash_attention": 2 * flash * n}


def phase_train_world(torch, one_card: dict) -> dict:
    """Phase 8: see the module docstring. ``one_card``: each model's phase 5
    result (the one-card steps at the same seed and batches). Every check
    is printed before the phase fails on any of them."""
    from repro_torch.launch.world import train_world

    smi = _smi()
    out, failures = {}, []
    for arch in (MIXTRAL, QWEN2):
        tag = "train-world" + SHORT[arch]
        w = TRAIN_WORLD[arch]
        t0 = time.perf_counter()
        ranks = train_world(arch, attn=w["attn"], moe=w["moe"], runs=w["runs"], device="cuda",
                            layers=1, seq=TRAIN_SEQ, batch=1, seed=0, profile=arch == MIXTRAL)
        wall = time.perf_counter() - t0
        ref = one_card[arch]["steps"]
        res = dict(fold=w, wall_s=wall, ranks=ranks, errors={})
        for r in ranks:
            if r["sp_index"] != r["tokens_index"]:
                failures.append(f"{tag} rank {r['rank']}: SP shard {r['sp_index']} != MoE "
                                f"token shard {r['tokens_index']}")
            for mode, steps in w["runs"]:
                run = r["runs"][mode]
                expect = _expected_world_launches(arch, mode, steps)
                if run["launches"] != expect:
                    failures.append(f"{tag} rank {r['rank']} {mode}: launches "
                                    f"{run['launches']} != expected {expect}")
                for i, m in enumerate(run["metrics"]):
                    if not all(x == x and abs(x) != float("inf")
                               for x in (m["loss"], m["grad_norm"])):
                        failures.append(f"{tag} rank {r['rank']} {mode} step {i}: {m}")
                        continue
                    if mode == "allgather":          # against the one-card step
                        key, base = f"step {i} vs one card", ref[i]
                        tols = {"loss": FOLD_TOL, "grad_norm": FOLD_TOL} if i == 0 else \
                            {"loss": FOLD_TOL_LATER, "grad_norm": GRAD_NORM_TOL_LATER}
                    else:                            # against the all-gather run
                        key, base = f"{mode} step {i} vs allgather", \
                            r["runs"]["allgather"]["metrics"][i]
                        tols = {"loss": RING_TOL, "grad_norm": RING_TOL}
                    for k, tol in tols.items():
                        e = abs(m[k] - base[k]) / abs(base[k])
                        res["errors"][f"{key} {k}"] = max(res["errors"].get(f"{key} {k}", 0.0), e)
                        if not e <= tol:
                            failures.append(f"{tag} rank {r['rank']} {key}: {k} {m[k]:.6f} "
                                            f"against {base[k]:.6f}, rel err {e:.3e} > {tol}")
        r0 = ranks[0]
        for mode, steps in w["runs"]:
            run = r0["runs"][mode]
            for i, m in enumerate(run["metrics"]):
                one = ref[i]
                _say(f"[{tag}] {mode} step {i}: loss {m['loss']:.6f} (one card "
                     f"{one['loss']:.6f}), grad_norm {m['grad_norm']:.6f} (one card "
                     f"{one['grad_norm']:.6f}), drop {m['moe_drop_fraction']:.4f} (one card "
                     f"{one['moe_drop_fraction']:.4f}); wall a rank " + ", ".join(
                         f"{x['runs'][mode]['step_s'][i] * 1e3:.1f}" for x in ranks) + " ms")
            _say(f"[{tag}] {mode}: launches a rank {run['launches']} (expected "
                 f"{_expected_world_launches(arch, mode, steps)}); peak memory a rank "
                 + ", ".join(f"{x['runs'][mode]['peak_gb']:.2f}" for x in ranks) + " GB")
        _say(f"[{tag}] {arch} x1 layer at attention (dp, cp, tp) {w['attn']}, MoE (edp, ep, "
             f"etp) {w['moe']}: {len(ranks)} ranks over gloo through the host on one card "
             f"({smi}); {r0['params'] / 1e6:.1f} M parameters on rank 0; weights built in "
             f"turns in {r0['init_s']:.1f} s; phase wall {wall:.1f} s; worst rel err "
             + ", ".join(f"{k} {v:.3e}" for k, v in res["errors"].items())
             + f" (limits: one card step 0 {FOLD_TOL}, later loss {FOLD_TOL_LATER} and "
             f"grad_norm {GRAD_NORM_TOL_LATER}; ring {RING_TOL})")
        prof = r0["runs"][w["runs"][0][0]].get("profile")
        if prof:
            _say(f"[{tag}] profiled step on rank 0: wall {prof['wall_ms']:.1f} ms, device "
                 f"{prof['device_ms']:.1f} ms (" + ", ".join(
                     f"{k} {v:.1f}" for k, v in prof["parts_ms"].items()) + "); host time in "
                 "the collectives " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                 prof["comm_host_ms"].items()) + " ms")
        res["kernels"] = _train_world_kernels(torch, arch)
        out[arch] = res
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 8:\n" + "\n".join(failures))
    return out

def _zero_fold() -> tuple:
    """The first of ``ZERO_MOE_FOLDS`` whose MoE token index is the
    attention (dp, cp, tp) index on every rank beside attention
    ``ZERO_ATTN`` (``folding.moe_token_index``), so that the SP → MoE
    hand-off stays within each DP rank; at one sequence a DP rank it is a
    reshape."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import folded_layout, moe_token_index, sp_token_index
    for moe in ZERO_MOE_FOLDS:
        pcfg = ParallelConfig(attn=PM(*ZERO_ATTN), moe=PM(*moe))
        fg = folded_layout(pcfg, rank=0, world=pcfg.world_size)
        cross = [r for r in range(pcfg.world_size)
                 if sp_token_index(fg, r) != moe_token_index(fg, r)]
        if cross:
            _say(f"[train-zero] MoE fold {moe} beside attention {ZERO_ATTN}: ranks {cross} "
                 "hold other DP ranks' tokens")
            continue
        _say(f"[train-zero] MoE fold {moe} beside attention {ZERO_ATTN}: the MoE token atoms "
             "are the attention (dp, cp, tp) atoms in order")
        return moe
    raise AssertionError(f"no MoE fold of {ZERO_MOE_FOLDS} passes the SP <-> MoE hand-off")


def _train_zero_kernels(torch, arch: str, moe: tuple) -> dict:
    """The kernels at phase 9's launch shapes, timed as in phase 3: flash in
    partial mode at a TP rank's heads over the whole ``ZERO_SEQ``-token
    sequence (cp = 1, the queries at offset 0), and the GMM forward and ``trans_w`` at
    the EP shard's shape (the experts' D gathered over EDP)."""
    from repro_torch.launch.world import gmm_shape
    _, cp, tp = ZERO_ATTN
    H, Hkv = (h // tp for h in FLASH_HEADS[arch])
    flash = _flash_cases(torch, arch, [(f"TP rank's heads, causal {ZERO_SEQ}", ZERO_SEQ, ZERO_SEQ,
                                        [0])], heads=(H, Hkv), modes=(True,))
    s = gmm_shape(arch, ZERO_SEQ // (cp * tp), fold=moe)
    E, rows, D, F, bm = s["experts"], s["rows_per_expert"], s["d_model"], s["d_expert"], s["bm"]
    M = E * rows
    blocks = [e for e in range(E) for _ in range(rows // bm)]
    cases = _gmm_cases(torch, E, [(f"train-zero gate/up, M={M}", M, D, F, bm, blocks, False),
                                  (f"train-zero dgrad trans_w, M={M}", M, F, D, bm, blocks, True)])
    out = {"gmm": cases[:1], "gmm_trans_w": cases[1:], "flash_attention": flash}
    _check_cases(arch, out)
    out["gmm_shape"] = s
    return out


def phase_train_zero(torch) -> dict:
    """Phase 9: see the module docstring. Every check is printed before the
    phase fails on any of them."""
    from repro_torch.launch.world import Run, train_world

    smi = _smi()
    moe = _zero_fold()
    out, failures = {"moe": moe}, []
    for arch in ZERO_RUNS:
        tag = "train-zero" + SHORT[arch]
        runs = [Run(*r) for r in ZERO_RUNS[arch]]
        base = runs[0].key
        t0 = time.perf_counter()
        ranks = train_world(arch, attn=ZERO_ATTN, moe=moe, runs=runs, device="cuda", layers=1,
                            seq=ZERO_SEQ, batch=ZERO_BATCH, seed=0, record=True)
        wall = time.perf_counter() - t0
        res = dict(attn=ZERO_ATTN, moe=moe, runs=[r._asdict() for r in runs], base=base,
                   wall_s=wall, ranks=ranks, errors={})
        for r in ranks:
            if r["sp_index"] != r["tokens_index"]:
                failures.append(f"{tag} rank {r['rank']}: SP shard {r['sp_index']} != MoE "
                                f"token shard {r['tokens_index']}")
            for run_spec in runs:
                run = r["runs"][run_spec.key]
                expect = _expected_world_launches(arch, run_spec.cp_mode, run_spec.steps,
                                                  ZERO_ATTN, tokens=ZERO_SEQ)
                if run["launches"] != expect:
                    failures.append(f"{tag} rank {r['rank']} {run_spec.key}: launches "
                                    f"{run['launches']} != expected {expect}")
                if run["state_bytes"] != run["state_bytes_expected"]:
                    failures.append(f"{tag} rank {r['rank']} {run_spec.key}: optimizer state "
                                    f"{run['state_bytes']} B != zero1_state_bytes "
                                    f"{run['state_bytes_expected']} B")
                for i, m in enumerate(run["metrics"]):
                    if not (m["step_ok"] and all(x == x and abs(x) != float("inf")
                                                 for x in (m["loss"], m["grad_norm"]))):
                        failures.append(f"{tag} rank {r['rank']} {run_spec.key} step {i}: {m}")
                        continue
                    if run_spec.key == base:
                        continue
                    ref = r["runs"][base]["metrics"][i]
                    for k in ("loss", "grad_norm"):
                        e = abs(m[k] - ref[k]) / abs(ref[k])
                        key = f"{run_spec.key} step {i} vs {base} {k}"
                        res["errors"][key] = max(res["errors"].get(key, 0.0), e)
                        if not e <= ZERO_TOL:
                            failures.append(f"{tag} rank {r['rank']} {key}: {m[k]:.6f} against "
                                            f"{ref[k]:.6f}, rel err {e:.3e} > {ZERO_TOL}")
        r0 = ranks[0]
        for run_spec in runs:
            run = r0["runs"][run_spec.key]
            for i, m in enumerate(run["metrics"]):
                ref = r0["runs"][base]["metrics"][i]
                _say(f"[{tag}] {run_spec.key} step {i}: loss {m['loss']:.6f} ({base} "
                     f"{ref['loss']:.6f}), grad_norm {m['grad_norm']:.6f} ({base} "
                     f"{ref['grad_norm']:.6f}), drop {m['moe_drop_fraction']:.4f}; wall a rank "
                     + ", ".join(f"{x['runs'][run_spec.key]['step_s'][i] * 1e3:.1f}"
                                 for x in ranks) + " ms")
            _say(f"[{tag}] {run_spec.key} (fsdp {run['fsdp']}, master_weights "
                 f"{run['master_weights']}): parameters stored a rank " + ", ".join(
                     f"{x['runs'][run_spec.key]['params'] / 1e6:.1f}" for x in ranks)
                 + " M; optimizer state a rank " + ", ".join(
                     f"{x['runs'][run_spec.key]['state_bytes'] / 1e9:.3f}" for x in ranks)
                 + f" GB (zero1_state_bytes {run['state_bytes_expected'] / 1e9:.3f} GB); "
                 f"launches a rank {run['launches']} (expected "
                 f"{_expected_world_launches(arch, run_spec.cp_mode, run_spec.steps, ZERO_ATTN, tokens=ZERO_SEQ)});"
                 " peak memory a rank " + ", ".join(
                     f"{x['runs'][run_spec.key]['peak_gb']:.2f}" for x in ranks) + " GB (reserved "
                 + ", ".join(f"{x['runs'][run_spec.key]['peak_reserved_gb']:.2f}" for x in ranks)
                 + f" GB); card in use at the run's end {run['card_used_gb']:.2f} of "
                 f"{run['card_gb']:.2f} GB")
        _say(f"[{tag}] {arch} x1 layer at attention (dp, cp, tp) {ZERO_ATTN}, MoE (edp, ep, "
             f"etp) {moe}, {ZERO_BATCH} x {ZERO_SEQ} tokens a step: {len(ranks)} ranks over "
             f"gloo through the host on one card ({smi}); {r0['params'] / 1e6:.1f} M "
             f"parameters a rank to compute with; weights built in turns in "
             f"{r0['init_s']:.1f} s; phase wall {wall:.1f} s; worst rel err "
             + ", ".join(f"{k} {v:.3e}" for k, v in res["errors"].items())
             + f" (limit {ZERO_TOL})")
        prof = r0["runs"][base].get("profile")
        if prof:
            _say(f"[{tag}] profiled {base} step on rank 0: wall {prof['wall_ms']:.1f} ms, device "
                 f"{prof['device_ms']:.1f} ms (" + ", ".join(
                     f"{k} {v:.1f}" for k, v in prof["parts_ms"].items()) + "); host time in "
                 "the collectives " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                 prof["comm_host_ms"].items()) + " ms")
        res["kernels"] = _train_zero_kernels(torch, arch, moe)
        out[arch] = res
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 9:\n" + "\n".join(failures))
    return out


def _expected_pipe_launches(cfg, w: dict, layers_on_stage: int) -> dict:
    """Launches a rank of phase 10 makes in its run, from the code: per layer
    it holds, microbatch and pass (one forward and backward, or a step),
    ``3 · chunks`` GMM in the forward and as many in remat's recompute,
    ``3 · chunks`` ``trans_w`` in the backward (every chunk's input has a
    gradient: the embedding's output or the received activation), and
    flash twice (forward and recompute). A rank's tokens are a sequence over
    cp · tp."""
    from repro_torch.core.overlap import resolve_chunks
    _, cp, tp = w["attn"]
    C = resolve_chunks(w["seq"] // (cp * tp), cfg.moe.overlap_chunks)
    n = layers_on_stage * w["microbatch"] * max(w["steps"], 1)
    return {"gmm": 6 * C * n, "gmm_trans_w": 3 * C * n, "flash_attention": 2 * n}


def _train_pipe_kernels(torch) -> dict:
    """The kernels at phase 10 (a)'s launch shapes, timed as in phase 3:
    flash in partial mode at a TP rank's heads over the whole sequence, and
    the GMM forward and ``trans_w`` at the EP shard's shape."""
    from repro_torch.launch.world import gmm_shape
    w = PIPE_FULL
    _, cp, tp = w["attn"]
    H, Hkv = (h // tp for h in FLASH_HEADS[MIXTRAL])
    flash = _flash_cases(torch, MIXTRAL, [(f"stage rank's heads, causal {w['seq']}", w["seq"],
                                           w["seq"], [0])], heads=(H, Hkv), modes=(True,))
    s = gmm_shape(MIXTRAL, w["seq"] // (cp * tp), fold=w["moe"])
    E, rows, D, F, bm = s["experts"], s["rows_per_expert"], s["d_model"], s["d_expert"], s["bm"]
    M = E * rows
    blocks = [e for e in range(E) for _ in range(rows // bm)]
    cases = _gmm_cases(torch, E, [(f"train-pipe gate/up, M={M}", M, D, F, bm, blocks, False),
                                  (f"train-pipe dgrad trans_w, M={M}", M, F, D, bm, blocks, True)])
    out = {"gmm": cases[:1], "gmm_trans_w": cases[1:], "flash_attention": flash}
    _check_cases(MIXTRAL, out)
    out["gmm_shape"] = s
    return out


def _pipe_run(torch, label: str, w: dict, *, reduce: bool, failures: list, tol: float) -> dict:
    """One pipelined run of phase 10 (``w``: PIPE_FULL or PIPE_SMALL) and
    the same at pp = 1 on stage 0's ranks; every check is printed, each
    failure appended to ``failures``."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import folded_layout
    from repro_torch.core.pipeline import bubble_fraction, stage_of
    from repro_torch.launch.train import train_config
    from repro_torch.launch.world import train_world
    tag = "train-pipe" + label
    t0 = time.perf_counter()
    ranks = train_world(MIXTRAL, attn=w["attn"], moe=w["moe"], pp=w["pp"], vpp=w["vpp"],
                        microbatch=w["microbatch"], runs=(("allgather", w["steps"]),),
                        device="cuda", reduce=reduce, layers=w["layers"], seq=w["seq"],
                        batch=w["microbatch"] * w["attn"][0], seed=0, profile=not reduce,
                        master_weights=w["steps"] == 0, against_pp1=True,
                        dtype="bfloat16" if reduce else None)
    wall = time.perf_counter() - t0
    cfg = train_config(MIXTRAL, layers=w["layers"], reduce=reduce)
    pcfg = ParallelConfig(attn=PM(*w["attn"]), moe=PM(*w["moe"]), pp=w["pp"], vpp=w["vpp"],
                          microbatch=w["microbatch"])
    n = pcfg.attn.size
    res = dict(fold=w, wall_s=wall, ranks=ranks, errors={},
               bubble_formula=bubble_fraction(w["pp"], w["microbatch"], w["vpp"]))
    for r in ranks:
        run = r["runs"]["allgather"]
        stage = stage_of(cfg, folded_layout(pcfg, rank=r["rank"], world=pcfg.world_size))
        expect = _expected_pipe_launches(cfg, w, len(stage.layers))
        ref = ranks[r["rank"] % n]["runs"]["allgather"]["pp1"]["metrics"]
        leaves = run["pp1"]["rel_l2"]
        worst = max(leaves, key=leaves.get)
        res["errors"][f"rank {r['rank']} worst leaf"] = leaves[worst]
        if run["launches"] != expect or min(run["launches"].values()) == 0:
            failures.append(f"{tag} rank {r['rank']}: launches {run['launches']} != expected "
                            f"{expect}")
        if "state_bytes" in run and run["state_bytes"] != run["state_bytes_expected"]:
            failures.append(f"{tag} rank {r['rank']}: optimizer state {run['state_bytes']} B != "
                            f"zero1_state_bytes {run['state_bytes_expected']} B")
        for i, (m, b) in enumerate(zip(run["metrics"], ref)):
            if not all(x == x and abs(x) != float("inf") for x in (m["loss"], m["grad_norm"])) \
                    or not m.get("step_ok", 1.0):
                failures.append(f"{tag} rank {r['rank']} step {i}: {m}")
                continue
            for k in ("loss", "grad_norm"):
                e = abs(m[k] - b[k]) / abs(b[k])
                key = f"step {i} {k} vs pp=1"
                res["errors"][key] = max(res["errors"].get(key, 0.0), e)
                if not e <= tol:
                    failures.append(f"{tag} rank {r['rank']} {key}: {m[k]:.6f} against "
                                    f"{b[k]:.6f}, rel err {e:.3e} > {tol}")
        if not leaves[worst] <= tol:
            failures.append(f"{tag} rank {r['rank']}: {worst} rel L2 {leaves[worst]:.3e} against "
                            f"pp=1 > {tol}")
        _say(f"[{tag}] rank {r['rank']} (stage {r['stage']}, layers {list(stage.layers)}"
             f"{', embedding' if stage.first else ''}{', head' if stage.last else ''}): "
             f"{run['params'] / 1e6:.1f} M parameters, peak memory {run['peak_gb']:.2f} GB "
             f"(reserved {run['peak_reserved_gb']:.2f} GB; card in use at the run's end "
             f"{run['card_used_gb']:.2f} of {run['card_gb']:.2f} GB), "
             f"launches {run['launches']} (expected {expect}), wall "
             + ", ".join(f"{t * 1e3:.1f}" for t in run["step_s"]) + " ms; "
             + ", ".join(f"step {i} loss {m['loss']:.6f} (pp=1 {b['loss']:.6f}) grad_norm "
                         f"{m['grad_norm']:.6f} (pp=1 {b['grad_norm']:.6f})"
                         for i, (m, b) in enumerate(zip(run["metrics"], ref)))
             + f"; {len(leaves)} {'gradient' if w['steps'] == 0 else 'parameter'} leaves against "
             f"pp=1, worst rel L2 {leaves[worst]:.3e} ({worst})")
    for r in ranks:
        prof = r["runs"]["allgather"].get("profile")
        if prof:
            comm = prof["comm_host_ms"]
            _say(f"[{tag}] stage {r['stage']} (rank {r['rank']}) profiled pass: wall "
                 f"{prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, device idle "
                 f"{100 * prof['device_idle_share']:.1f}% of the wall (closed-form bubble "
                 f"{100 * res['bubble_formula']:.1f}%); host ms in comm send "
                 f"{comm.get('comm send', 0.0):.1f}, comm recv {comm.get('comm recv', 0.0):.1f}, "
                 "the rest " + ", ".join(f"{k} {v:.1f}" for k, v in comm.items()
                                          if k not in ("comm send", "comm recv")))
    what = "one forward and backward" if w["steps"] == 0 else f"{w['steps']} AdamW steps"
    width = "reduced, bf16" if reduce else "full width"
    _say(f"[{tag}] {cfg.name} x{cfg.n_layers} layers ({width}) at PP{w['pp']} x vpp {w['vpp']}, "
         f"attention (dp, cp, tp) {w['attn']}, MoE (edp, ep, etp) {w['moe']}, {w['microbatch']} "
         f"microbatches of {w['attn'][0]} x {w['seq']} tokens, {what}: {len(ranks)} ranks over "
         f"gloo through the host on one card; weights built in turns in "
         f"{ranks[0]['init_s']:.1f} s; phase wall {wall:.1f} s; worst rel err against pp=1 "
         + ", ".join(f"{k} {v:.3e}" for k, v in res["errors"].items() if "step" in k)
         + f", worst leaf {max(v for k, v in res['errors'].items() if 'leaf' in k):.3e} (limit "
         f"{tol})")
    return res


def phase_train_pipe(torch) -> dict:
    """Phase 10: see the module docstring. Every check is printed before the
    phase fails on any of them."""
    failures: list = []
    out = {"full": _pipe_run(torch, "", PIPE_FULL, reduce=False, failures=failures,
                             tol=PP_TOL)}
    torch.cuda.empty_cache()
    out["reduced"] = _pipe_run(torch, "-reduced", PIPE_SMALL, reduce=True, failures=failures,
                               tol=ZERO_TOL)
    out["kernels"] = _train_pipe_kernels(torch)
    if failures:
        raise AssertionError("phase 10:\n" + "\n".join(failures))
    return out


def _fs_type(path: str) -> str:
    """The type of the file system holding ``path`` (``/proc/mounts``)."""
    import os
    path, best = os.path.realpath(path), ("", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, kind = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best[0]):
                best = (mnt, kind)
    return f"{best[1]} at {best[0]}"


def _meminfo() -> dict:
    """``/proc/meminfo`` in bytes."""
    with open("/proc/meminfo") as f:
        return {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}


def _io_line(r: dict) -> str:
    parts = []
    for rec in r["io"]:
        if rec["op"] == "save":
            parts.append(f"save {rec['step']}: {rec['bytes'] / 1e9:.3f} GB ({rec['file_bytes'] / 1e9:.3f} "
                         f"GB in its file), host copy "
                         f"{rec['host_copy']:.2f} s, hash {rec['hash']:.2f} s, write "
                         f"{rec['write']:.2f} s, commit {rec['commit']:.2f} s")
        else:
            parts.append(f"{rec['op']} {rec['step']}: {rec['seconds']:.2f} s")
    return "; ".join(parts)


def _resume_full(torch, train_zero: dict, failures: list) -> dict:
    """Phase 11 (a): see the module docstring."""
    import math
    import os
    import shutil
    import tempfile
    from repro_torch.launch.train import train_config
    from repro_torch.launch.world import resilient_world
    from repro_torch.models.transformer import param_shapes
    tag, moe = "train-resume", train_zero["moe"]
    cfg = train_config(MIXTRAL, layers=1)
    n_params = sum(math.prod(s) for s in param_shapes(cfg).values())
    step_bytes = n_params * 12                  # fp32 parameters, mu and nu
    if not os.path.isdir(RESUME_DIR):
        raise AssertionError(f"phase 11: no {RESUME_DIR} (RAM-backed tmpfs) for the checkpoints")
    directory = tempfile.mkdtemp(prefix="chip-smoke-ckpt-", dir=RESUME_DIR)
    try:
        free, fs, mem = shutil.disk_usage(directory).free, _fs_type(directory), _meminfo()
        need = step_bytes + n_params * 4        # the last step, and step 0's parameters
        _say(f"[{tag}] checkpoint directory {directory} ({fs}): {free / 1e9:.2f} GB free; RAM "
             f"{mem['MemTotal'] / 1e9:.2f} GB, {mem['MemAvailable'] / 1e9:.2f} GB available; a "
             f"step is {step_bytes / 1e9:.2f} GB ({n_params / 1e9:.3f} B parameters x 12 B), "
             f"{step_bytes / 4e9:.2f} GB a rank; keep=1 holds {need / 1e9:.2f} GB while a "
             "save commits")
        if min(free, mem["MemAvailable"] - RESUME_RAM_MARGIN) < need:
            raise AssertionError(
                f"phase 11: {directory} has {free / 1e9:.2f} GB free and the machine "
                f"{mem['MemAvailable'] / 1e9:.2f} GB of RAM available, less than the "
                f"{need / 1e9:.2f} GB that keep=1 holds while a save commits (with "
                f"{RESUME_RAM_MARGIN / 1e9:.0f} GB of RAM for the processes)")
        t0 = time.perf_counter()
        ranks, = resilient_world(dict(
            attn=ZERO_ATTN, moe=moe, arch=MIXTRAL, layers=1, seq=ZERO_SEQ, batch=ZERO_BATCH,
            seed=0, lr=3e-4, steps=RESUME_STEPS, ckpt_dir=directory, ckpt_every=RESUME_EVERY,
            keep=1, supervise=True, faults=[RESUME_FAULT + ({},)], max_restarts=1))
        wall = time.perf_counter() - t0
        left = sorted(os.listdir(directory))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    anchor = RESUME_FAULT[1] // RESUME_EVERY * RESUME_EVERY      # the last save before it
    expect = _expected_world_launches(MIXTRAL, "allgather", RESUME_STEPS - anchor, ZERO_ATTN,
                                      tokens=ZERO_SEQ)
    zero = train_zero[MIXTRAL]
    for r in ranks:
        rid = f"{tag} rank {r['rank']}"
        ref = zero["ranks"][r["rank"]]["runs"][zero["base"]]["metrics"]
        errs = [x for x in r["incidents"] if x["incident"] == "restart"]
        if r["restarts"] != 1 or [x["error"] for x in errs] != ["DataStreamError"]:
            failures.append(f"{rid}: restarts {r['restarts']}, incidents {r['incidents']}")
        rest = r["restored"]
        if rest is None or rest["step"] != anchor or rest["bad"] or not rest["checked"]:
            failures.append(f"{rid}: restored {rest}")
        if sorted(r["metrics"]) != list(range(RESUME_STEPS)):
            failures.append(f"{rid}: steps run {sorted(r['metrics'])}")
        for i, m in sorted(r["metrics"].items()):
            for k in ("loss", "grad_norm"):
                if m[k] != ref[i][k]:
                    failures.append(f"{rid} step {i} {k}: {m[k]!r} != phase 9's {ref[i][k]!r}")
        if r["launches"] != expect:
            failures.append(f"{rid}: launches since the restore {r['launches']} != "
                            f"{RESUME_STEPS - anchor} steps' {expect}")
    if left != [f"ckpt_{RESUME_STEPS:08d}", f"ckpt_{RESUME_STEPS:08d}.done"]:
        failures.append(f"{tag}: the directory held {left} at the end, not step "
                        f"{RESUME_STEPS} alone (keep=1)")
    r0 = ranks[0]
    ref = zero["ranks"][0]["runs"][zero["base"]]["metrics"]
    for i, m in sorted(r0["metrics"].items()):
        _say(f"[{tag}] step {i}: loss {m['loss']!r} (phase 9 {ref[i]['loss']!r}), grad_norm "
             f"{m['grad_norm']!r} (phase 9 {ref[i]['grad_norm']!r})")
    for r in ranks:
        _say(f"[{tag}] rank {r['rank']}: restarts {r['restarts']}, restored step "
             f"{r['restored']['step'] if r['restored'] else None} with "
             f"{r['restored']['checked'] if r['restored'] else 0} pieces hashed equal to the "
             f"saved digests, launches since the restore {r['launches']} ({RESUME_STEPS - anchor} "
             f"steps: {expect}), "
             f"peak memory {r['peak_gb']:.2f} GB; {_io_line(r)}")
    _say(f"[{tag}] {MIXTRAL} x1 layer at attention (dp, cp, tp) {ZERO_ATTN}, MoE (edp, ep, "
         f"etp) {moe}, FSDP, ZeRO-1, {ZERO_BATCH} x {ZERO_SEQ} tokens a step: "
         f"{RESUME_STEPS} steps, a save every {RESUME_EVERY} (keep 1), fault "
         f"{RESUME_FAULT[0]} at step {RESUME_FAULT[1]}; incidents "
         + ", ".join(x["incident"] for x in r0["incidents"]) + f"; phase wall {wall:.1f} s")
    return dict(wall_s=wall, ranks=ranks, step_bytes=step_bytes, disk_free=free, fs=fs,
                meminfo_start=mem, meminfo_end=_meminfo())


def _resume_reduced(torch, failures: list) -> dict:
    """Phase 11 (b): see the module docstring."""
    import json as _json
    import os
    import shutil
    import tempfile
    from repro_torch.launch.world import resilient_world
    tag = "train-resume-reduced"
    w = PIPE_SMALL
    first = {k: w[k] for k in ("attn", "moe", "pp", "vpp", "microbatch")}
    common = dict(arch=MIXTRAL, reduce=True, layers=w["layers"], dtype="bfloat16",
                  seq=w["seq"], batch=w["microbatch"] * w["attn"][0], seed=0, lr=3e-4)
    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-reduced-")
    dirs = {k: os.path.join(root, k) for k in "abc"}
    try:
        t0 = time.perf_counter()
        a, b, c = resilient_world(      # one world, three runs in turn
            dict(first, **common, steps=3, ckpt_every=2, ckpt_dir=dirs["a"]),
            dict(RESUME_SECOND, **common, steps=2, ckpt_dir=dirs["b"], resume=dirs["a"],
                 resume_step=2),
            dict(first, **common, steps=3, ckpt_dir=dirs["c"], resume=dirs["b"],
                 check=(dirs["a"], 2)))
        wall = time.perf_counter() - t0

        def digests(d, step):
            with open(os.path.join(d, f"ckpt_{step:08d}", "manifest.json")) as f:
                leaves = _json.load(f)["leaves"]
            return {k: [(sh["start"], sh["stop"], sh["sha256"]) for sh in v["shards"]]
                    for k, v in leaves.items()}
        same = digests(dirs["a"], 3) == digests(dirs["c"], 3)
        n_shards = sum(len(v) for v in digests(dirs["a"], 3).values())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not same:
        failures.append(f"{tag}: the state after the round trip's step differs from the "
                        "uninterrupted run's (step 3's shard digests)")
    for ra, rc in zip(a, c):
        rid = f"{tag} rank {ra['rank']}"
        rest = rc["restored"]
        if rest is None or rest["bad"] or not rest["checked"]:
            failures.append(f"{rid}: restored {rest}")
        if sorted(rc["metrics"]) != [2] or rc["metrics"][2]["loss"] != ra["metrics"][2]["loss"] \
                or rc["metrics"][2]["grad_norm"] != ra["metrics"][2]["grad_norm"]:
            failures.append(f"{rid}: step 2 after the round trip {rc['metrics']} != the "
                            f"uninterrupted {ra['metrics'].get(2)}")
    for rb in b:
        if rb["restored"] is None or rb["restored"]["step"] != 2 or rb["restored"]["bad"] \
                or rb["metrics"]:
            failures.append(f"{tag} second fold rank {rb['rank']}: {rb['restored']}, "
                            f"{rb['metrics']}")
    m_a, m_c = a[0]["metrics"][2], c[0]["metrics"][2]
    _say(f"[{tag}] reduced {MIXTRAL} x{w['layers']} in bf16: 2 steps at PP{w['pp']} x vpp "
         f"{w['vpp']} / attention {w['attn']} / MoE {w['moe']} saved, restored at attention "
         f"{RESUME_SECOND['attn']} / MoE {RESUME_SECOND['moe']} (pp 1) and saved there, "
         f"restored back ({c[0]['restored']['checked']} pieces on rank 0 hashed equal to the "
         f"first save's digests); step 2 there: loss {m_c['loss']!r} grad_norm "
         f"{m_c['grad_norm']!r} (uninterrupted {m_a['loss']!r} / {m_a['grad_norm']!r}); "
         f"step 3's {n_shards} shard digests {'equal' if same else 'DIFFER'}; phase wall "
         f"{wall:.1f} s")
    return dict(wall_s=wall, first=a, second=b, back=c, state_equal=same)


def phase_train_resume(torch, train_zero: dict) -> dict:
    """Phase 11: see the module docstring. Every check is printed before
    the phase fails on any of them."""
    failures: list = []
    out = {"full": _resume_full(torch, train_zero, failures)}
    torch.cuda.empty_cache()
    out["reduced"] = _resume_reduced(torch, failures)
    if failures:
        raise AssertionError("phase 11:\n" + "\n".join(failures))
    return out


def _config_gmm_specs(arch: str) -> tuple:
    """(experts, specs in :func:`_gmm_specs`' form) of a config's training
    step at TRAIN_SEQ tokens, token-dropping CF 1.0: every expert owning its
    capacity in 128-row blocks, the gate/up launch, and for the configs
    trained in "train-configs" the down launch and the ``trans_w`` dgrad at
    both."""
    from repro_torch.core.router import capacity_per_expert
    from repro_torch.launch.train import train_config
    cfg = train_config(arch)
    m = cfg.moe
    E, D, F, bm = m.n_experts, cfg.d_model, m.d_expert, m.gmm_block_m
    rows = -(-capacity_per_expert(TRAIN_SEQ, m) // bm) * bm
    M = E * rows
    blocks = [e for e in range(E) for _ in range(rows // bm)]
    specs = [(f"gate/up, M={M}", M, D, F, bm, blocks, False)]
    if arch in FANOUT:
        specs += [(f"down, M={M}", M, F, D, bm, blocks, False),
                  (f"dgrad trans_w, M={M}", M, F, D, bm, blocks, True),
                  (f"dgrad trans_w down, M={M}", M, D, F, bm, blocks, True)]
    return E, specs


def phase_config_kernels(torch) -> dict:
    """Phase 3's rows at the shapes of the configs added with the mapping
    table: the GMM of each (``_config_gmm_specs``) and flash at causal 4096
    at each one's heads (dbrx's are Mixtral's), held and timed as in phase 3."""
    from repro_torch.launch.train import train_config
    out = {}
    for arch in (G8T8, QWEN3, LLAMA3, DBRX):
        cfg = train_config(arch)
        gmm_cases = _gmm_cases(torch, *_config_gmm_specs(arch))
        res = {"gmm": [c for c in gmm_cases if not c["trans_w"]],
               "gmm_trans_w": [c for c in gmm_cases if c["trans_w"]]}
        if arch != DBRX:                    # heads of 128, as _flash_cases takes them
            res["flash_attention"] = _flash_cases(
                torch, arch, [("causal self-attention 4096", TRAIN_SEQ, TRAIN_SEQ, [0])],
                heads=(cfg.n_heads, cfg.n_kv_heads), modes=(True,))
        _check_cases(arch, res)
        out[arch] = res
        torch.cuda.empty_cache()
    return out


def phase_train_configs(torch) -> dict:
    """"train-configs": phase 5's one-card training and phase 6's reduced
    card-vs-CPU check for the new configs that fit one card at 1 layer."""
    out = {}
    for arch in (G8T8, QWEN3):
        out[arch] = {"train": phase_train(torch, arch, steps=CONFIG_STEPS,
                                          tag="train-configs" + SHORT[arch]),
                     "check_train": phase_train_check(torch, arch)}
        out[arch]["memory"] = _free(torch, f"{arch} trained")
    return out


def _handoff_kernels(torch) -> dict:
    """The kernels at phase 12's launch shapes, timed as in phase 3: flash
    in partial mode at a TP rank's heads over the DP rank's two 2048-token
    sequences, and the GMM forward and ``trans_w`` at the EP shard's shape
    (a rank's 2048 tokens), which the world across DP ranks shares; flash
    also at that world's shape: all heads, the second CP chunk of 1024
    queries of the DP rank's two sequences against their whole 2048 keys."""
    from repro_torch.launch.world import gmm_shape
    _, cp, tp = HANDOFF["attn"]
    seqs, S = HANDOFF["batch"] // HANDOFF["attn"][0], HANDOFF["seq"]
    H, Hkv = (h // tp for h in FLASH_HEADS[QWEN2])
    flash = _flash_cases(torch, QWEN2, [(f"TP rank's heads, {seqs} sequences causal {S}", S, S,
                                         [0] * seqs)], heads=(H, Hkv), modes=(True,))
    cross = _flash_cases(torch, QWEN2, [(f"all heads, {seqs} sequences, CP chunk 2 of 2 "
                                         f"(queries {S // 2}-{S - 1} of {S})", S // 2, S,
                                         [S // 2] * seqs)], heads=FLASH_HEADS[QWEN2],
                         modes=(True,))
    s = gmm_shape(QWEN2, seqs * S // (cp * tp), fold=HANDOFF["moe"])
    E, rows, D, F, bm = s["experts"], s["rows_per_expert"], s["d_model"], s["d_expert"], s["bm"]
    M = E * rows
    blocks = [e for e in range(E) for _ in range(rows // bm)]
    cases = _gmm_cases(torch, E, [(f"train-handoff gate/up, M={M}", M, D, F, bm, blocks, False),
                                  (f"train-handoff dgrad trans_w, M={M}", M, F, D, bm, blocks,
                                   True)])
    out = {"gmm": cases[:1], "gmm_trans_w": cases[1:], "flash_attention": flash + cross}
    _check_cases(QWEN2, out)
    out["gmm_shape"] = s
    return out


# The axis each world of phase 12 exchanges its SP rows over
# (``comm.handoff_axis``): within each DP rank, none, across DP ranks.
HANDOFF_AXIS = {"handoff": "cp_tp", "oracle": None, "cross-dp": "stage"}


def _handoff_world(name: str, attn: tuple, runs: list, smi: str, failures: list, *,
                   moe: tuple = HANDOFF["moe"], pods: int = 1, warmup: bool = True) -> dict:
    """One world of phase 12 (``name``: "handoff", "oracle" or "cross-dp")
    at attention fold ``attn`` and MoE fold ``moe`` (``pods`` > 1: pods
    that extend attention CP and MoE EDP), each of ``runs`` from the same
    weights: its ranks' results, checked (the hand-off's axis, launches
    against the count from the code, optimizer-state bytes, finite steps,
    each later run's loss and ``grad_norm`` within ``ZERO_TOL`` of the
    first's) and printed as soon as it ends."""
    from repro_torch.launch.world import train_world
    t0 = time.perf_counter()
    ranks = train_world(QWEN2, attn=attn, moe=moe, runs=runs, device="cuda", layers=1,
                        seq=HANDOFF["seq"], batch=HANDOFF["batch"], seed=0, pods=pods,
                        warmup=warmup)
    wall = time.perf_counter() - t0
    base = runs[0].key
    cp_all = (attn[0], attn[1] * pods, attn[2])      # the pods extend CP
    for r in ranks:
        rid = f"train-handoff {name} rank {r['rank']}"
        if r["handoff"] != HANDOFF_AXIS[name]:
            failures.append(f"{rid}: {r['seqs']} sequences a DP rank, hand-off over "
                            f"{r['handoff']}, not {HANDOFF_AXIS[name]}")
        for run in runs:
            got = r["runs"][run.key]
            expect = _expected_world_launches(QWEN2, run.cp_mode, run.steps, cp_all,
                                              tokens=r["seqs"] * HANDOFF["seq"])
            if got["launches"] != expect:
                failures.append(f"{rid} {run.key}: launches {got['launches']} != expected "
                                f"{expect}")
            if run.steps and got["state_bytes"] != got["state_bytes_expected"]:
                failures.append(f"{rid} {run.key}: optimizer state {got['state_bytes']} B != "
                                f"zero1_state_bytes {got['state_bytes_expected']} B")
            for i, m in enumerate(got["metrics"]):
                if not (m.get("step_ok", 1.0) and all(x == x and abs(x) != float("inf")
                                             for x in (m["loss"], m["grad_norm"]))):
                    failures.append(f"{rid} {run.key} step {i}: {m}")
                    continue
                if run.key == base:
                    continue
                ref = r["runs"][base]["metrics"][i]
                for k in ("loss", "grad_norm"):
                    e = abs(m[k] - ref[k]) / abs(ref[k])
                    if not e <= ZERO_TOL:
                        failures.append(f"{rid} {run.key} step {i} {k}: {m[k]:.6f} against "
                                        f"{base}'s {ref[k]:.6f}, rel err {e:.3e} > {ZERO_TOL}")
    r0 = ranks[0]
    for run in runs:
        per_rank = [r["runs"][run.key] for r in ranks]
        got = per_rank[0]
        _say(f"[train-handoff] {name} {run.key} (fsdp {got['fsdp']}, master_weights "
             f"{got['master_weights']}): {QWEN2} x1 layer at attention (dp, cp, tp) {attn}, MoE "
             f"(edp, ep, etp) {moe}" + (f", {pods} pods extending CP and EDP" if pods > 1
                                        else "") + f", {HANDOFF['batch']} x {HANDOFF['seq']} tokens a "
             f"step, {r0['seqs']} sequences a DP rank (hand-off {r0['handoff']}): {len(ranks)} "
             f"ranks over gloo through the host on one card ({smi}); loss " + ", ".join(
                 f"{m['loss']:.6f}" for m in got["metrics"]) + ", grad_norm " + ", ".join(
                 f"{m['grad_norm']:.6f}" for m in got["metrics"]) + "; wall a step a rank "
             + "; ".join(", ".join(f"{t * 1e3:.1f}" for t in x["step_s"]) for x in per_rank)
             + " ms; peak memory a rank " + ", ".join(f"{x['peak_gb']:.2f}" for x in per_rank)
             + " GB (reserved " + ", ".join(f"{x['peak_reserved_gb']:.2f}" for x in per_rank)
             + f" GB; card in use at the run's end {got['card_used_gb']:.2f} of "
             f"{got['card_gb']:.2f} GB); " + ("optimizer state a rank " + ", ".join(
                 f"{x['state_bytes'] / 1e9:.3f}" for x in per_rank)
                 + f" GB (zero1_state_bytes {got['state_bytes_expected'] / 1e9:.3f} GB)"
                 if run.steps else "a forward and backward, no optimizer state") + "; launches a "
             f"rank {got['launches']}; host ms in comm handoff a rank " + ", ".join(
                 f"{1e3 * x['comm_host_s'].get('comm handoff', 0.0):.1f}" for x in per_rank))
    _say(f"[train-handoff] {name}: runs {[run.key for run in runs]} from the same weights; "
         f"weights built in turns in {r0['init_s']:.1f} s; world wall {wall:.1f} s")
    host = r0["runs"][base]["comm_host_s"]
    _say(f"[train-handoff] {name}: host ms in the comm ranges of rank 0's {base} step: "
         + ", ".join(f"{k} {1e3 * v:.1f}" for k, v in sorted(host.items(), key=lambda x: -x[1])))
    return dict(attn=attn, moe=moe, pods=pods, runs=[run._asdict() for run in runs],
                ranks=ranks, wall_s=wall)


def phase_train_handoff(torch) -> dict:
    """Phase 12: see the module docstring. Every check is printed before the
    phase fails on any of them."""
    from repro_torch.launch.world import Run

    smi = _smi()
    runs = [Run(*r) for r in HANDOFF["runs"]]
    run = runs[0]
    failures: list = []
    worlds = {}
    # The hand-off world runs every run (Qwen2's FSDP and fp32-master steps
    # at phase 9's fold); the oracle the first only.
    for name, attn, its_runs in (("handoff", HANDOFF["attn"], runs),
                                 ("oracle", HANDOFF_ORACLE, runs[:1])):
        worlds[name] = _handoff_world(name, attn, its_runs, smi, failures)
        torch.cuda.empty_cache()
    t_cross = time.perf_counter()
    worlds["cross-dp"] = _handoff_world("cross-dp", HANDOFF_CROSS["attn"],
                                        [Run(*HANDOFF_CROSS["run"])], smi, failures,
                                        moe=HANDOFF_CROSS["moe"], pods=HANDOFF_CROSS["pods"],
                                        warmup=False)
    worlds["cross-dp"]["phase_s"] = time.perf_counter() - t_cross
    torch.cuda.empty_cache()
    hand, oracle = worlds["handoff"]["ranks"], worlds["oracle"]["ranks"]
    same_tokens = [a["moe_tokens"] == b["moe_tokens"] for a, b in zip(hand, oracle)]
    _say(f"[train-handoff] each rank's MoE token shard equal to the oracle rank's, id for id: "
         f"{same_tokens}")
    if not all(same_tokens):
        failures.append(f"train-handoff: MoE token shards equal to the oracle's by rank "
                        f"{same_tokens}")
    errors = {}
    m_h, m_o = hand[0]["runs"][run.key]["metrics"], oracle[0]["runs"][run.key]["metrics"]
    for i, (a, b) in enumerate(zip(m_h, m_o)):
        tol = FOLD_TOL if i == 0 else FOLD_TOL_LATER
        for k in ("loss", "grad_norm", "moe_drop_fraction"):
            errors[f"step {i} {k}"] = e = abs(a[k] - b[k]) / abs(b[k])
            if not e <= tol:
                failures.append(f"train-handoff step {i} {k}: {a[k]!r} against the oracle's "
                                f"{b[k]!r}, rel err {e:.3e} > {tol}")
        _say(f"[train-handoff] step {i}: loss {a['loss']:.6f} (oracle {b['loss']:.6f}), "
             f"grad_norm {a['grad_norm']:.6f} (oracle {b['grad_norm']:.6f}), drop "
             f"{a['moe_drop_fraction']!r} (oracle {b['moe_drop_fraction']!r}, "
             f"{'equal' if a['moe_drop_fraction'] == b['moe_drop_fraction'] else 'not equal'}); "
             f"rel err loss {errors[f'step {i} loss']:.3e}, grad_norm "
             f"{errors[f'step {i} grad_norm']:.3e}, drop "
             f"{errors[f'step {i} moe_drop_fraction']:.3e} (limit {tol}; ZERO_TOL {ZERO_TOL})")
    cross = _cross_dp_check(worlds["cross-dp"]["ranks"], oracle, run.key, failures)
    if failures:
        raise AssertionError("phase 12:\n" + "\n".join(failures))
    return dict(worlds=worlds, errors=errors, same_tokens=same_tokens, cross_dp=cross,
                kernels=_handoff_kernels(torch))


def _cross_dp_check(cross: list, oracle: list, key: str, failures: list) -> dict:
    """The world across DP ranks against the oracle: each rank's MoE token
    ids against those of the oracle's rank at the same MoE token index, id
    for id; loss, ``grad_norm`` and the drop fraction of the step within
    ``FOLD_TOL`` of the oracle's."""
    by_index = {r["tokens_index"]: r["moe_tokens"] for r in oracle}
    same = [r["moe_tokens"] == by_index[r["tokens_index"]] for r in cross]
    _say(f"[train-handoff] cross-dp: each rank's MoE token shard (index "
         f"{[r['tokens_index'] for r in cross]}, SP index {[r['sp_index'] for r in cross]}) "
         f"equal to the oracle's of the same index, id for id: {same}")
    if not all(same):
        failures.append(f"train-handoff cross-dp: MoE token shards equal to the oracle's by "
                        f"index {same}")
    a = cross[0]["runs"][HANDOFF_CROSS["run"][4]]["metrics"][0]
    b = oracle[0]["runs"][key]["metrics"][0]
    errors = {}
    for k in ("loss", "grad_norm", "moe_drop_fraction"):
        errors[k] = e = abs(a[k] - b[k]) / abs(b[k])
        if not e <= FOLD_TOL:
            failures.append(f"train-handoff cross-dp {k}: {a[k]!r} against the oracle's "
                            f"{b[k]!r}, rel err {e:.3e} > {FOLD_TOL}")
    _say(f"[train-handoff] cross-dp step 0: loss {a['loss']:.6f} (oracle {b['loss']:.6f}), "
         f"grad_norm {a['grad_norm']:.6f} (oracle {b['grad_norm']:.6f}), drop "
         f"{a['moe_drop_fraction']!r} (oracle {b['moe_drop_fraction']!r}); rel err " + ", ".join(
             f"{k} {v:.3e}" for k, v in errors.items()) + f" (limit {FOLD_TOL})")
    return dict(same_tokens=same, errors=errors)


# Phase 13: phase 4's serving workload across 4 ranks sharing the card. Per
# model the attention (dp, cp, tp) and MoE (edp, ep, etp) folds.
SERVE_WORLD = {MIXTRAL: dict(attn=(1, 2, 2), moe=(1, 4, 1)),
               QWEN2: dict(attn=(2, 1, 2), moe=(1, 2, 2))}
# (c): the recurrent kinds at DP2 x TP2, phase 16's serving workload (its
# depth, requests and engine; xLSTM paged, Zamba2 dense), held against
# phase 16's one-card run of the same.
SERVE_WORLD_RECUR = dict(attn=(2, 1, 2), moe=(2, 1, 2))


def _expected_serve_launches(cfg, forwards, attn, moe, max_batch: int) -> dict:
    """Launches a rank makes serving at a fold, from the code: per layer and
    forward (a B = 1 prefill chunk of C tokens, a decode of ``max_batch``
    rows), 3 GMM a dispatcher chunk of the rank's token shard (the global
    B·C tokens padded over EDP·EP·ETP, ``overlap_chunks`` clamped to the
    shard) and one flash launch, or ``cp`` for a ring-CP prefill chunk
    (C > 1, C % cp == 0)."""
    import math
    from repro_torch.core.overlap import resolve_chunks
    cp, n_tok = attn[1], math.prod(moe)
    gmm = flash = 0
    for pre, dec in forwards:
        for B, C in ([(1, pre)] if pre else []) + ([(max_batch, 1)] if dec else []):
            t_l = -(-B * C // n_tok)
            gmm += 3 * resolve_chunks(t_l, cfg.moe.overlap_chunks) * cfg.n_layers
            flash += (cp if cp > 1 and C > 1 and C % cp == 0 else 1) * cfg.n_layers
    return {"gmm": gmm, "gmm_trans_w": 0, "flash_attention": flash}


def _serve_world_kernels(torch) -> dict:
    """The kernels at phase 13's launch shapes, timed as in phase 3: flash
    in partial mode on Mixtral's CP slice 1 (a TP rank's 24 / 4 heads,
    keys 256-511): a decode step of 4 rows and one ring-prefill hop (the
    second 64-query half of a 128-token chunk at 256); flash normalized at
    Qwen2's decode (a DP rank's 2 rows, a TP rank's 14 / 2 heads, 512
    keys) and at (c)'s Zamba2 decode (a DP rank's row at a TP rank's 16 /
    16 heads of 80, 1024 keys); the GMM forward at each fold's decode shard
    (dropless, one token a shard: one 128-row block a source, EP·ETP
    sources an expert)."""
    from repro_torch.launch.serve import slice_config
    H, Hkv = (h // SERVE_WORLD[MIXTRAL]["attn"][2] for h in FLASH_HEADS[MIXTRAL])
    flash = {MIXTRAL: _flash_cases(torch, MIXTRAL, [
        ("serve-world decode, CP slice 1 of 2", 1, 256, [300, 511, 257, 420], 256),
        ("serve-world ring-prefill hop, CP slice 1 of 2", 64, 256, [320], 256)],
        heads=(H, Hkv), modes=(True,))}
    H, Hkv = (h // SERVE_WORLD[QWEN2]["attn"][2] for h in FLASH_HEADS[QWEN2])
    flash[QWEN2] = _flash_cases(torch, QWEN2, [
        ("serve-world decode, a DP rank's 2 rows", 1, 512, [37, 300])], heads=(H, Hkv),
        modes=(False,))
    tp = SERVE_WORLD_RECUR["attn"][2]
    flash[ZAMBA2] = _flash_cases(torch, ZAMBA2, [
        ("serve-world decode, a DP rank's row, 1024 keys", 1, 1024, [1023])],
        heads=(32 // tp, 32 // tp), modes=(False,), hd=80)
    _check_cases(ZAMBA2, {"flash_attention": flash[ZAMBA2]})
    out = {"flash_attention": flash, "gmm": {}}
    for arch in (MIXTRAL, QWEN2):
        cfg = slice_config(arch)
        _, ep, etp = SERVE_WORLD[arch]["moe"]
        m, bm = cfg.moe, cfg.moe.gmm_block_m
        E, D, F = m.n_experts // ep, cfg.d_model, m.d_expert // etp
        M = E * ep * etp * bm
        blocks = [e for e in range(E) for _ in range(ep * etp)]
        out["gmm"][arch] = _gmm_cases(torch, E, [(f"serve-world gate/up, EP{ep} ETP{etp} "
                                                  f"decode shard", M, D, F, bm, blocks, False)])
        _check_cases(arch, {"gmm": out["gmm"][arch], "flash_attention": flash[arch]})
    return out


def _serve_world_recurrent(worlds: dict) -> tuple:
    """(c)'s checks within the world: every rank's tokens and prefill
    logits equal rank 0's, launches as counted (1 flash launch a forward a
    KV-bearing layer: Zamba2's shared block a repeat; none for xLSTM).
    Phase 16's one-card run of the same is compared after it ran
    (:func:`_recurrent_world_check`)."""
    import numpy as np
    from repro_torch.launch.serve import slice_config
    from repro_torch.serve.cache import n_kv_layers
    out, failures = {}, []
    for arch, ranks in worlds.items():
        tag = "serve-world" + SHORT[arch]
        cfg = slice_config(arch, layers=RECUR_LAYERS[arch])
        r0 = ranks[0]
        expect = {"gmm": 0, "gmm_trans_w": 0,
                  "flash_attention": n_kv_layers(cfg) * sum(bool(p) + bool(d)
                                                            for p, d in r0["forwards"])}
        for r in ranks:
            if r["launches"] != expect:
                failures.append(f"{tag} rank {r['rank']}: launches {r['launches']} != {expect}")
            if any(a["tokens"] != b["tokens"] or not np.array_equal(a["logits"], b["logits"])
                   for a, b in zip(r["results"], r0["results"])):
                failures.append(f"{tag} rank {r['rank']}: results differ from rank 0's")
        dec = [t[1] for t in r0["timings"] if t[1] > 0]
        out[arch] = dict(fold=SERVE_WORLD_RECUR, ranks=ranks, launches_expected=expect,
                         decode_step_ms_median=statistics.median(dec) * 1e3)
        _say(f"[{tag}] {cfg.name} x{cfg.n_layers} layers (full width, bf16), "
             f"{RECUR_CACHES[arch][0]} cache, at attention (dp, cp, tp) "
             f"{SERVE_WORLD_RECUR['attn']}: {len(r0['forwards'])} steps, serving wall a rank "
             + ", ".join(f"{r['wall_s']:.2f}" for r in ranks) + f" s, decode step median "
             f"{out[arch]['decode_step_ms_median']:.1f} ms; build in turns {r0['init_s']:.1f} s; "
             f"launches a rank {r0['launches']} (expected {expect}); peak memory a rank "
             + ", ".join(f"{r.get('peak_gb', 0.0):.2f}" for r in ranks) + " GB; tokens "
             + "; ".join(str(x["tokens"]) for x in r0["results"]))
    return out, failures


def _recurrent_world_check(serve_world: dict, recurrent: dict) -> dict:
    """Phase 13 (c) against phase 16's one-card run of the same arch,
    cache, weights and requests: each request's prefill logits within
    ``CHECK_TOL`` (relative), its first token equal wherever the one-card
    top-1/top-2 margin exceeds twice the max |Δlogit| (the fold sums bf16
    in other orders: TP's fp32 partial sums of the shared block), and the
    tokens equal before the first divergence, printed. Drops the logits
    from both records."""
    import numpy as np
    out, failures = {}, []
    for arch, world in serve_world["recurrent"].items():
        tag = "serve-world" + SHORT[arch]
        one = recurrent[arch]["serve"]["runs"][RECUR_CACHES[arch][0]]
        errors = []
        for i, (got, tok, lg) in enumerate(zip(world["ranks"][0]["results"], one["tokens"],
                                               one["logits"])):
            base = np.asarray(lg, np.float64)
            delta = float(np.abs(np.asarray(got["logits"], np.float64) - base).max())
            rel = delta / max(float(np.abs(base).max()), 1e-30)
            top2 = np.sort(base)[-2:]
            margin = float(top2[1] - top2[0])
            agree = next((k for k, (a, b) in enumerate(zip(got["tokens"], tok)) if a != b),
                         len(tok))
            errors.append(dict(max_abs=delta, rel=rel, margin=margin, agree=agree))
            if not (got["finished"] and len(got["tokens"]) == len(tok)):
                failures.append(f"{tag} request {i}: finished {got['finished']} with "
                                f"{len(got['tokens'])} tokens")
            if not rel <= CHECK_TOL:
                failures.append(f"{tag} request {i}: prefill logits rel err {rel:.3e} > "
                                f"{CHECK_TOL} against phase 16's")
            if margin > 2 * delta and got["tokens"][0] != tok[0]:
                failures.append(f"{tag} request {i}: first token {got['tokens'][0]} != phase "
                                f"16's {tok[0]} with margin {margin:.4f} > 2 x {delta:.4f}")
        out[arch] = errors
        _say(f"[{tag}] against phase 16 (one card, same weights, cache and requests): prefill "
             "logits rel err " + ", ".join(f"{e['rel']:.2e}" for e in errors)
             + f" (limit {CHECK_TOL}); top-1/2 margin "
             + ", ".join(f"{e['margin']:.4f}" for e in errors) + "; tokens equal before the "
             "first divergence " + ", ".join(str(e["agree"]) for e in errors)
             + f" of {BLOCKS_SERVE['new']}")
        for r in world["ranks"]:
            for x in r["results"]:
                x["logits"] = None
        for run in recurrent[arch]["serve"]["runs"].values():
            run["logits"] = None
    if failures:
        raise AssertionError("phase 13 (c):\n" + "\n".join(failures))
    return out


def phase_serve_world(torch, one_card: dict) -> dict:
    """Phase 13: see the module docstring. ``one_card``: each model's phase 4
    requests (tokens and prefill logits). Every check is printed before the
    phase fails on any of them."""
    import numpy as np
    from repro_torch.launch.serve import ENGINE, slice_config
    from repro_torch.launch.world import serve_world
    from repro_torch.serve.cache import kv_bytes_paged

    smi = _smi()
    t_phase = time.perf_counter()
    out, failures = {}, []
    # Both models and (c)'s two in one world of 4 (one start, one
    # teardown); rank 0 profiles a decode step of the first.
    worlds = serve_world(*(dict(arch=arch, attn=SERVE_WORLD[arch]["attn"],
                                moe=SERVE_WORLD[arch]["moe"], layers=SERVE_LAYERS,
                                new_tokens=SERVE_NEW_TOKENS, keep_logits=True,
                                profile=arch == MIXTRAL) for arch in (MIXTRAL, QWEN2)),
                         *(dict(arch=arch, **SERVE_WORLD_RECUR, layers=RECUR_LAYERS[arch],
                                engine=dict(BLOCKS_ENGINE, cache=RECUR_CACHES[arch][0],
                                            s_max=BLOCKS_SERVE["s_max"]),
                                prompt_lens=BLOCKS_SERVE["prompts"],
                                new_tokens=BLOCKS_SERVE["new"], keep_logits=True)
                           for arch in (XLSTM, ZAMBA2)),
                         device="cuda")
    wall = time.perf_counter() - t_phase
    out["recurrent"], failures = _serve_world_recurrent(dict(zip((XLSTM, ZAMBA2),
                                                                  worlds[2:])))
    worlds = worlds[:2]
    for arch, ranks in zip((MIXTRAL, QWEN2), worlds):
        tag = "serve-world" + SHORT[arch]
        w = SERVE_WORLD[arch]
        cfg = slice_config(arch, layers=SERVE_LAYERS)
        r0, ref = ranks[0], one_card[arch]
        expect = _expected_serve_launches(cfg, r0["forwards"], w["attn"], w["moe"],
                                          ENGINE["max_batch"])
        n_pages = ENGINE["max_batch"] * ENGINE["s_max"] // ENGINE["page_size"] + 1
        kv_rank = kv_bytes_paged(cfg, n_pages, ENGINE["page_size"]) // w["attn"][2]
        for r in ranks:
            rid = f"{tag} rank {r['rank']}"
            if r["launches"] != expect:
                failures.append(f"{rid}: launches {r['launches']} != expected {expect}")
            if r["cache_bytes"] != kv_rank:
                failures.append(f"{rid}: KV pools {r['cache_bytes']} B != kv_bytes_paged / tp "
                                f"{kv_rank} B")
            if any(a["tokens"] != b["tokens"] for a, b in zip(r["results"], r0["results"])):
                failures.append(f"{rid}: tokens differ from rank 0's")
            if any(not np.array_equal(a["logits"], b["logits"])
                   for a, b in zip(r["results"], r0["results"])):
                failures.append(f"{rid}: prefill logits differ from rank 0's")
        errors, agree = [], []
        for i, (got, one) in enumerate(zip(r0["results"], ref)):
            if not (got["finished"] and len(got["tokens"]) == SERVE_NEW_TOKENS):
                failures.append(f"{tag} request {i}: finished {got['finished']} with "
                                f"{len(got['tokens'])} tokens")
            lg, base = np.asarray(got["logits"], np.float64), np.asarray(one["logits"], np.float64)
            delta = float(np.abs(lg - base).max())
            rel = delta / max(float(np.abs(base).max()), 1e-30)
            top2 = np.sort(base)[-2:]
            margin = float(top2[1] - top2[0])
            n_agree = next((k for k, (a, b) in enumerate(zip(got["tokens"], one["tokens"]))
                            if a != b), len(got["tokens"]))
            errors.append(dict(max_abs=delta, rel=rel, margin=margin, agree=n_agree))
            agree.append(n_agree)
            if not rel <= CHECK_TOL:
                failures.append(f"{tag} request {i}: prefill logits rel err {rel:.3e} > "
                                f"{CHECK_TOL} against phase 4's")
            if margin > 2 * delta and got["tokens"][0] != one["tokens"][0]:
                failures.append(f"{tag} request {i}: first token {got['tokens'][0]} != phase "
                                f"4's {one['tokens'][0]} with margin {margin:.4f} > 2 x "
                                f"{delta:.4f}")
        dec = [t[1] for t in r0["timings"] if t[1] > 0]
        pre_tok = sum(p for p, _ in r0["forwards"])
        pre_s = sum(t[0] for t in r0["timings"])
        res = dict(fold=w, wall_s=wall, ranks=ranks, launches_expected=expect,
                   kv_bytes_rank=kv_rank, errors=errors,
                   decode_step_ms_median=statistics.median(dec) * 1e3,
                   prefill_tok_per_s=pre_tok / pre_s)
        for r in ranks:
            for x in r["results"]:
                x["logits"] = None              # 0.2-3.6 MB each: not kept in results/
        _say(f"[{tag}] {cfg.name} x{cfg.n_layers} layers (full width, bf16) at attention "
             f"(dp, cp, tp) {w['attn']}, MoE (edp, ep, etp) {w['moe']}: {len(ranks)} ranks over "
             f"gloo through the host on one card ({smi}); {r0['params'] / 1e9:.3f} B parameters "
             f"on rank 0; weights built in turns in {r0['init_s']:.1f} s; {len(r0['forwards'])} "
             f"steps, serving wall a rank " + ", ".join(f"{r['wall_s']:.2f}" for r in ranks)
             + f" s; world wall (both models) {wall:.1f} s: start "
             f"{max(r['start_s'] for r in ranks):.1f} s, groups {r0['groups_s']:.1f} s, profiled "
             f"extra request {r0.get('profile_s', 0.0):.1f} s, teardown "
             f"{max(r['end_s'] for r in ranks):.1f} s")
        _say(f"[{tag}] decode step median {res['decode_step_ms_median']:.1f} ms (phase 4 one "
             f"card: see [serve{SHORT[arch]}]); prefill {pre_tok} tokens at "
             f"{res['prefill_tok_per_s']:.1f} tok/s; peak memory a rank: build "
             + ", ".join(f"{r['peak_init_gb']:.2f}" for r in ranks) + " GB, serving "
             + ", ".join(f"{r['peak_gb']:.2f}" for r in ranks) + " GB (reserved "
             + ", ".join(f"{r['peak_reserved_gb']:.2f}" for r in ranks) + " GB); KV pools a "
             f"rank {r0['cache_bytes'] / 1e6:.2f} MB (kv_bytes_paged / tp {kv_rank / 1e6:.2f} "
             f"MB); launches a rank {r0['launches']} (expected {expect})")
        _say(f"[{tag}] against phase 4 (one card, same weights and requests): prefill logits "
             f"max |d| " + ", ".join(f"{e['max_abs']:.4f}" for e in errors) + "; rel err "
             + ", ".join(f"{e['rel']:.2e}" for e in errors) + f" (limit {CHECK_TOL}); top-1/2 "
             "margin " + ", ".join(f"{e['margin']:.4f}" for e in errors)
             + "; tokens equal before the first divergence " + ", ".join(map(str, agree))
             + f" of {SERVE_NEW_TOKENS}")
        prof = r0.get("profile")
        if prof:
            _say(f"[{tag}] profiled decode step on rank 0: wall {prof['wall_ms']:.1f} ms, device "
                 f"{prof['device_ms']:.1f} ms (" + ", ".join(
                     f"{k} {v:.1f}" for k, v in prof["parts_ms"].items()) + "); device idle "
                 f"{prof['device_idle_share']:.1%}; host ms in " + ", ".join(
                     f"{k} {v:.1f}" for k, v in sorted(prof["comm_host_ms"].items())))
        out[arch] = res
        torch.cuda.empty_cache()
    out["kernels"] = _serve_world_kernels(torch)
    out["seconds"] = time.perf_counter() - t_phase
    _say(f"[serve-world] phase 13 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 13:\n" + "\n".join(failures))
    return out


# Phase 14: dense decoder blocks and sliding-window ring caches.
LLAMA = "llama3.2-1b"
LONG = "long_500k"                  # launch.mappings.model_for: window 8192 on full attention
WINDOW_ENGINE = dict(max_batch=2, page_size=128, prefill_chunk=512)
WINDOW_PROMPTS, WINDOW_NEW = (12288, 1024), 32
DENSE_TRAIN = dict(steps=2, seq=4096, batch=2)
MOE_WINDOW = dict(layers=2, prompt=9000, new=16)


def _serve_window(torch) -> dict:
    """(a) Llama3.2-1B under ``model_for(..., "long_500k")`` at full width and
    depth, bf16: the same two requests (12288 and 1024 prompt tokens) through
    a paged and a dense engine, each run with the counters set to 0 just
    before and read just after."""
    from repro_torch.launch.serve import slice_config, submit_random
    from repro_torch.launch.world import pool_bytes
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.cache import kv_bytes_dense, kv_bytes_paged

    cfg = slice_config(LLAMA, shape=LONG)
    s_max = max(WINDOW_PROMPTS) + WINDOW_NEW
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    out = dict(model=f"{cfg.name} x{cfg.n_layers} layers (full width and depth), window "
                     f"{cfg.sliding_window}, bf16, {n_params / 1e9:.3f} B params", runs={})
    failures = []
    for cache in ("paged", "dense"):
        tag = "serve-window" + ("" if cache == "paged" else "-dense")
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, EngineConfig(cache=cache, s_max=s_max, **WINDOW_ENGINE))
        kv = pool_bytes(eng.state)
        want_kv = (kv_bytes_paged(cfg, eng.scheduler.alloc.n_pages, eng.ecfg.page_size)
                   if cache == "paged" else kv_bytes_dense(cfg, eng.ecfg.max_batch,
                                                           eng.cache_len))
        rids = submit_random(eng, cfg, WINDOW_PROMPTS, WINDOW_NEW, seed=0)
        torch.cuda.synchronize()
        _zero_counters()
        t0 = time.perf_counter()
        res = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters()
        n_fwd = sum(1 for s in eng.stats if s.prefill_tokens) + \
            sum(1 for s in eng.stats if s.decode_tokens)
        expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": cfg.n_layers * n_fwd}
        pre_tok = sum(s.prefill_tokens for s in eng.stats)
        pre_s = sum(t[0] for t in eng.timings)
        dec = [t[1] for t in eng.timings if t[1] > 0]
        run = dict(cache_len=eng.cache_len, kv_bytes=kv, kv_bytes_expected=want_kv,
                   kv_bytes_a_request=kv_bytes_dense(cfg, 1, eng.cache_len),
                   kv_bytes_full_context=kv_bytes_dense(cfg, 1, 524288),
                   steps=len(eng.stats), forwards=n_fwd, launches=launches, wall_s=wall,
                   prefill_tok_per_s=pre_tok / pre_s,
                   decode_step_ms_median=statistics.median(dec) * 1e3,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                   tokens=[res[r].tokens.tolist() for r in rids])
        _say(f"[{tag}] {out['model']}: cache_len {eng.cache_len}, KV store {kv} B (expected "
             f"{want_kv}; {run['kv_bytes_a_request']} a request, "
             f"{run['kv_bytes_full_context']} for a full 524288-token context); "
             f"{len(rids)} requests, {run['steps']} steps, {n_fwd} forwards, wall {wall:.3f} s, "
             f"launches {launches} (expected {expect}); prefill "
             f"{run['prefill_tok_per_s']:.1f} tok/s, decode step median "
             f"{run['decode_step_ms_median']:.3f} ms; max_memory_allocated "
             f"{run['max_memory_allocated_gb']:.2f} GB")
        if eng.cache_len != cfg.sliding_window or kv != want_kv:
            failures.append(f"{tag}: cache_len {eng.cache_len}, KV bytes {kv} != {want_kv}")
        if launches != expect:
            failures.append(f"{tag}: launches {launches} != {expect}")
        for r in rids:
            if not (res[r].finished and len(res[r].tokens) == WINDOW_NEW):
                failures.append(f"{tag} request {r} did not finish with {WINDOW_NEW} tokens")
        out["runs"][cache] = run
        del eng, res
        torch.cuda.empty_cache()
    same = out["runs"]["paged"]["tokens"] == out["runs"]["dense"]["tokens"]
    _say(f"[serve-window] paged tokens equal dense tokens: {same}")
    if not same:
        failures.append("serve-window: paged tokens differ from dense tokens")
    out["paged_equals_dense"] = same
    del params
    return out, failures


def _train_dense_run(torch, cfg, profile: bool) -> dict:
    """``DENSE_TRAIN`` steps from the seed's weights; with ``profile`` the
    last step under ``torch.profiler`` (device time by part)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.profile_train import breakdown
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state, make_train_step

    params = init_lm(cfg, seed=0, device="cuda")
    opt = init_train_state(params)
    step = make_train_step(cfg, guard=True)
    data = SyntheticTokens(DataConfig(seq_len=DENSE_TRAIN["seq"],
                                      global_batch=DENSE_TRAIN["batch"],
                                      vocab_size=cfg.vocab_size, seed=0))
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
               for _ in range(DENSE_TRAIN["steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    rows, prof = [], None
    for i, b in enumerate(batches):
        traced = profile and i == len(batches) - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if traced:
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                params, opt, m = step(params, opt, b)
                torch.cuda.synchronize()
            prof = breakdown(p)
        else:
            params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        rows.append(dict({k: float(v) for k, v in m.items()},
                         step_ms=(time.perf_counter() - t0) * 1e3))
    out = dict(steps=rows, launches=_read_counters(),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               state_gb=sum(t.numel() * t.element_size()
                            for t in list(params.parameters()) + list(opt.mu.values())
                            + list(opt.nu.values())) / 1e9,
               profile=prof)
    del params, opt, step, batches
    torch.cuda.empty_cache()
    return out


def _train_dense(torch) -> tuple:
    """(b) Llama3.2-1B at full width and depth, tied embeddings, fp32
    masters and AdamW, bf16 compute, remat: 2 steps of 2 x 4096 tokens, then
    the same again from the same seed with the last step profiled."""
    from repro_torch.launch.train import PEAK_BF16_FLOPS, step_flops, train_config
    cfg = train_config(LLAMA)
    flops = step_flops(cfg, DENSE_TRAIN["seq"], DENSE_TRAIN["batch"])
    first = _train_dense_run(torch, cfg, profile=False)
    rerun = _train_dense_run(torch, cfg, profile=True)
    steps = DENSE_TRAIN["steps"]
    expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": 2 * cfg.n_layers * steps}
    failures = []
    for i, (a, b) in enumerate(zip(first["steps"], rerun["steps"])):
        a["mfu"] = flops / (a["step_ms"] / 1e3) / PEAK_BF16_FLOPS
        same = a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        _say(f"[train-dense] step {i}: loss {a['loss']:.6f} (rerun {b['loss']:.6f}), grad_norm "
             f"{a['grad_norm']:.4f} (rerun {b['grad_norm']:.4f}), bitwise {same}, step_ok "
             f"{bool(a['step_ok'])}; wall {a['step_ms']:.3f} ms, MFU {100 * a['mfu']:.2f}%")
        finite = all(x == x and abs(x) != float("inf") for x in (a["loss"], a["grad_norm"]))
        if not (finite and a["step_ok"] and same):
            failures.append(f"train-dense step {i}: loss {a['loss']} / rerun {b['loss']}, "
                            f"grad_norm {a['grad_norm']} / rerun {b['grad_norm']}, "
                            f"step_ok {a['step_ok']}")
    for run in (first, rerun):
        if run["launches"] != expect:
            failures.append(f"train-dense launches {run['launches']} != {expect}")
    # The profiler slows the step it traces (its first trace most): AdamW's
    # device time is held against the unprofiled run's last step.
    prof = rerun["profile"]
    adamw = prof["parts_ms"]["adamw update"]
    out = dict(model=f"{cfg.name} x{cfg.n_layers} layers (full width and depth), tied, "
                     f"{DENSE_TRAIN['batch']} x {DENSE_TRAIN['seq']} tokens a step",
               first=first, rerun=rerun, model_tflop_per_step=flops / 1e12,
               compute_bound_ms=_bound(0, flops)[0], launches=first["launches"],
               adamw_device_ms=adamw, adamw_share_of_step=adamw / first["steps"][-1]["step_ms"])
    _say(f"[train-dense] {out['model']}: launches {first['launches']} (expected {expect}); "
         f"{flops / 1e12:.3f} model TFLOP a step, compute bound {out['compute_bound_ms']:.3f} "
         f"ms; max_memory_allocated {first['max_memory_allocated_gb']:.2f} GB (parameters "
         f"and AdamW moments {first['state_gb']:.2f} GB); profiled step: wall "
         f"{rerun['steps'][-1]['step_ms']:.1f} ms, device {prof['device_ms']:.1f} ms ("
         + ", ".join(f"{k} {v:.1f}" for k, v in prof["parts_ms"].items())
         + f"); AdamW {100 * out['adamw_share_of_step']:.1f}% of the unprofiled step "
         f"({first['steps'][-1]['step_ms']:.1f} ms)")
    return out, failures


def _moe_window(torch) -> tuple:
    """(c) Qwen3-MoE-30B-A3B under ``model_for(..., "long_500k")`` at full
    width cut to 2 layers: one 9000-token request, 16 new tokens, paged."""
    from repro_torch.launch.serve import slice_config, submit_random
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Engine, EngineConfig
    cfg = slice_config(QWEN3, layers=MOE_WINDOW["layers"], shape=LONG)
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = Engine(cfg, params, EngineConfig(s_max=MOE_WINDOW["prompt"] + MOE_WINDOW["new"],
                                           **dict(WINDOW_ENGINE, max_batch=1)))
    rids = submit_random(eng, cfg, (MOE_WINDOW["prompt"],), MOE_WINDOW["new"], seed=0)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    res = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    n_fwd = sum(1 for s in eng.stats if s.prefill_tokens) + \
        sum(1 for s in eng.stats if s.decode_tokens)
    expect = {"gmm": 3 * cfg.n_layers * n_fwd, "gmm_trans_w": 0,
              "flash_attention": cfg.n_layers * n_fwd}
    toks = res[rids[0]].tokens
    out = dict(model=f"{cfg.name} x{cfg.n_layers} layers (full width), window "
                     f"{cfg.sliding_window}, bf16", cache_len=eng.cache_len, forwards=n_fwd,
               launches=launches, wall_s=wall, tokens=toks.tolist())
    _say(f"[moe-window] {out['model']}: one {MOE_WINDOW['prompt']}-token request, cache_len "
         f"{eng.cache_len}, {n_fwd} forwards, wall {wall:.3f} s, launches {launches} (expected "
         f"{expect}), {len(toks)} tokens")
    failures = []
    if launches != expect:
        failures.append(f"moe-window launches {launches} != {expect}")
    if len(toks) != MOE_WINDOW["new"] or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        failures.append(f"moe-window: tokens {toks.tolist()}")
    del eng, params, res
    torch.cuda.empty_cache()
    return out, failures


def _flash_ring_cases(torch, cases, heads, hd: int, modes=(False, True)) -> list:
    """Flash with key positions: ``(label, Sq, L, newest query position per
    batch row, window)``: the queries of each row end at its position and
    the L keys are the slots of a sliding-window ring
    (``attention._cache_kv_positions``: wrapped, or not yet written).
    Held against the plain version at the same positions; ``library_ms``:
    SDPA with an ``attn_mask`` built from the positions (no mask where every
    key is visible). Bytes: q, the key
    and value slots some query of the row sees, ``kv_pos`` and the output;
    operations: the visible (query, key) pairs."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.flash.ref import flash_ref
    from repro_torch.launch.devtime import graph_ms, profiled_ms
    from repro_torch.models.attention import _cache_kv_positions
    g = torch.Generator(device="cuda").manual_seed(4)
    H, Hkv = heads
    out = []
    for label, Sq, L, last, window in cases:
        B = len(last)
        q = torch.randn((B, H, Sq, hd), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, Hkv, L, hd), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, Hkv, L, hd), generator=g, device="cuda").to(torch.bfloat16)
        q_pos = torch.tensor(last, device="cuda")[:, None] - Sq + 1 + \
            torch.arange(Sq, device="cuda")
        kv_pos = _cache_kv_positions(q_pos, L).to(torch.int32).contiguous()
        q_off = q_pos[:, 0].to(torch.int32).contiguous()
        d = q_pos[:, :, None] - kv_pos[:, None, :].long()
        vis = (d >= 0) & (d < window)
        n_vis, n_keys = vis.sum().item(), vis.any(dim=1).sum().item()
        mask = None if vis.all() else vis[:, None]     # every key visible: SDPA with no mask
        library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
        for partial in modes:
            def run(partial=partial):
                return flash_attention(q, k, v, q_off, kv_pos=kv_pos, window=window,
                                       return_partial=partial)

            def plain(partial=partial):
                return flash_ref(q, k, v, q_off, kv_pos=kv_pos, window=window,
                                 return_partial=partial)
            got, ref = run(), plain()
            torch.cuda.synchronize()
            errs = [_err(torch, a, b) for a, b in (zip(got, ref) if partial else [(got, ref)])]
            del got, ref
            ms = graph_ms(torch, run)
            plain_ms = profiled_ms(torch, plain, calls=3)
            out_bytes = B * H * Sq * (hd * 4 + 8) if partial else B * H * Sq * hd * 2
            nbytes = 2 * B * H * Sq * hd + 2 * 2 * Hkv * hd * n_keys + 4 * B * L + out_bytes
            bound_ms, bound_by = _bound(nbytes, 4.0 * hd * H * n_vis)
            out.append(dict(case=f"{label}, {'partial' if partial else 'normalized'}",
                            shape=f"q({B},{H},{Sq},{hd}) kv({B},{Hkv},{L},{hd}) kv_pos "
                                  f"ring, newest {last}, window {window}",
                            max_abs_err=max(e[0] for e in errs), rel_err=max(e[1] for e in errs),
                            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms,
                            library_form="SDPA no mask" if mask is None else
                            "SDPA attn_mask from kv_pos",
                            visible_pairs=n_vis))
        del q, k, v, mask, vis, d
        torch.cuda.empty_cache()
    return out


def _packed_positions(B: int, S: int, cuts) -> "np.ndarray":
    """(B, S) positions of packed rows: row b holds two sequences, the
    second restarting at 0 after ``cuts[b]`` tokens."""
    import numpy as np
    return np.stack([np.concatenate([np.arange(c), np.arange(S - c)]) for c in cuts[:B]]
                    ).astype(np.int32)


def _shared_positions(cfg, B: int, S: int) -> "np.ndarray":
    """M-RoPE streams (B, S, 3) of a batch whose first ``n_vision_tokens``
    rows are an image's patches that share one temporal id (0), height and
    width the patch grid, then text that continues past the grid on every
    stream (Qwen2-VL's own layout)."""
    import numpy as np
    n = cfg.n_vision_tokens
    side = int(round(n ** 0.5))
    text = side + np.arange(S - n)
    t = np.concatenate([np.zeros(n), text])
    h = np.concatenate([np.arange(n) // side, text])
    w = np.concatenate([np.arange(n) % side, text])
    return np.broadcast_to(np.stack([t, h, w], -1), (B, S, 3)).astype(np.int32).copy()


def _flash_qpos_cases(torch, cases, heads, hd: int, modes=(False, True)) -> list:
    """Flash with query positions (``q_pos``): ``(label, q_pos (B, Sq)
    numpy, Skv, keys)``, keys ``"self"`` (``kv_pos`` = ``q_pos``, causal
    self-attention) or an int ``kv_offset`` (keys a run from it, causal).
    Held against the plain version at the same positions; ``library_ms``:
    SDPA with an ``attn_mask`` built from the positions (no mask where every
    key is visible). Bytes: q, the key
    and value rows some query of the row sees, the positions and the
    output; operations: the visible (query, key) pairs."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash.flash import flash_attention
    from repro_torch.kernels.flash.ref import flash_ref
    from repro_torch.launch.devtime import graph_ms, profiled_ms
    g = torch.Generator(device="cuda").manual_seed(6)
    H, Hkv = heads
    out = []
    for label, pos, L, keys in cases:
        B, Sq = pos.shape
        q = torch.randn((B, H, Sq, hd), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, Hkv, L, hd), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, Hkv, L, hd), generator=g, device="cuda").to(torch.bfloat16)
        q_pos = torch.from_numpy(pos).to("cuda")
        kw = dict(kv_pos=q_pos) if keys == "self" else dict(kv_offset=keys)
        kv_pos = q_pos if keys == "self" else \
            keys + torch.arange(L, dtype=torch.int32, device="cuda").expand(B, L)
        vis = kv_pos[:, None, :].long() <= q_pos[:, :, None].long()
        n_vis, n_keys = vis.sum().item(), vis.any(dim=1).sum().item()
        mask = None if vis.all() else vis[:, None]     # every key visible: SDPA with no mask
        library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
        for partial in modes:
            def run(partial=partial):
                return flash_attention(q, k, v, None, q_pos=q_pos, return_partial=partial,
                                       **kw)

            def plain(partial=partial):
                return flash_ref(q, k, v, None, q_pos=q_pos, return_partial=partial, **kw)
            got, ref = run(), plain()
            torch.cuda.synchronize()
            errs = [_err(torch, a, b) for a, b in (zip(got, ref) if partial else [(got, ref)])]
            del got, ref
            ms = graph_ms(torch, run)
            plain_ms = profiled_ms(torch, plain, calls=3)
            out_bytes = B * H * Sq * (hd * 4 + 8) if partial else B * H * Sq * hd * 2
            nbytes = 2 * B * H * Sq * hd + 2 * 2 * Hkv * hd * n_keys + 4 * B * Sq + out_bytes
            bound_ms, bound_by = _bound(nbytes, 4.0 * hd * H * n_vis)
            out.append(dict(case=f"{label}, {'partial' if partial else 'normalized'}",
                            shape=f"q({B},{H},{Sq},{hd}) kv({B},{Hkv},{L},{hd}) q_pos "
                                  + ("and kv_pos" if keys == "self" else f"kv_offset={keys}"),
                            max_abs_err=max(e[0] for e in errs), rel_err=max(e[1] for e in errs),
                            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms,
                            library_form="SDPA no mask" if mask is None else
                            "SDPA attn_mask from q_pos",
                            visible_pairs=n_vis))
        del q, k, v, mask, vis
        torch.cuda.empty_cache()
    return out


def _qwen3_decode_specs(cfg) -> list:
    """(c)'s GMM decode launch at its 128-row blocks, then gate/up and down
    at row blocks of 8 and 16 rows (the swap-AB kernel), one block an
    expert: what a smaller ``gmm_block_m`` would stream at decode."""
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    serving = list(range(E))
    return ([("gate/up, decode (serving)", E * 128, D, F, 128, serving, False)]
            + [(f"{name}, decode bm={bm}", E * bm, K, N, bm, serving, False)
               for bm in SMALL_BM[:2] for name, K, N in (("gate/up", D, F), ("down", F, D))])


def _window_kernels(torch) -> dict:
    """Phase 14's kernel rows, held and timed as in phase 3: flash with key
    positions at (a)'s ring decode and prefill chunk and at (c)'s prefill
    chunk, flash without them at (b)'s causal 4096 (2 sequences, 32/8 heads
    of 64) and phase 3's Mixtral decode again, and the GMM at (c)'s decode
    (:func:`_qwen3_decode_specs`);
    beside them flash with query positions at (a)'s heads (``qpos``): (b)'s
    shape with two packed sequences a row, and a decode of 4 rows."""
    import numpy as np
    from repro_torch.launch.serve import slice_config
    llama = slice_config(LLAMA, shape=LONG)
    W = llama.sliding_window            # (a)'s rows end at 12300 and 1040 (W 8192)
    heads = (llama.n_heads, llama.n_kv_heads)
    qwen3 = slice_config(QWEN3, shape=LONG)
    res = {LLAMA: {"flash_attention": _flash_ring_cases(torch, [
        ("ring decode", 1, W, [3 * W // 2 + 12, W // 8 + 16], W),
        ("ring prefill chunk", 512, W, [3 * W // 2 - 1], W)], heads, llama.resolved_head_dim) +
        _flash_cases(torch, LLAMA, [("causal self-attention 4096", 4096, 4096, [0, 0])],
                     heads=heads, modes=(True,), hd=llama.resolved_head_dim)},
           MIXTRAL: {"flash_attention": _flash_cases(torch, MIXTRAL, FLASH_CASES[MIXTRAL][:1])},
           "qpos": {"flash_attention": _flash_qpos_cases(torch, [
               ("packed rows, causal self-attention 2 x 4096",
                _packed_positions(2, 4096, (1536, 2560)), 4096, "self"),
               ("decode, 4 rows at their own positions, 4096 keys",
                np.array([[4095], [3000], [100], [2047]], np.int32), 4096, 0)],
               heads, llama.resolved_head_dim)},
           QWEN3: {"flash_attention": _flash_ring_cases(torch, [
               ("ring prefill chunk", 512, W, [W + 511], W)], (qwen3.n_heads, qwen3.n_kv_heads),
               qwen3.resolved_head_dim, modes=(False,)),
               "gmm": _gmm_cases(torch, qwen3.moe.n_experts, _qwen3_decode_specs(qwen3))}}
    for arch, r in res.items():
        _check_cases(arch, r)
    return res


def phase_window_dense(torch) -> dict:
    """Phase 14: see the module docstring."""
    t_phase = time.perf_counter()
    out, failures = {}, []
    out["serve"], f = _serve_window(torch)
    failures += f
    _free(torch, "serve-window done")
    out["train"], f = _train_dense(torch)
    failures += f
    out["check_train"] = phase_train_check(torch, LLAMA)
    _free(torch, "train-dense done")
    out["moe"], f = _moe_window(torch)
    failures += f
    out["kernels"] = _window_kernels(torch)
    out["seconds"] = time.perf_counter() - t_phase
    _say(f"[window-dense] phase 14 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 14:\n" + "\n".join(failures))
    return out


def _window_dense_line(window: dict, sources: dict) -> list:
    """Phase 14's entries of the kernels line: flash on (a)'s paged and dense
    runs (timed at the ring decode), on (b) (causal 4096) and on (c) (its
    ring prefill chunk), and the GMM on (c) (its decode)."""
    def case(arch, name, label):
        return next(c for c in window["kernels"][arch][name] if c["case"] == label)
    serve, train, moe = window["serve"]["runs"], window["train"], window["moe"]
    return [
        _entry("flash_attention", "serve-window", LLAMA,
               case(LLAMA, "flash_attention", "ring decode, normalized"),
               serve["paged"]["launches"]["flash_attention"], sources),
        _entry("flash_attention", "serve-window-dense", LLAMA,
               case(LLAMA, "flash_attention", "ring decode, normalized"),
               serve["dense"]["launches"]["flash_attention"], sources),
        _entry("flash_attention", "train-dense", LLAMA,
               case(LLAMA, "flash_attention", "causal self-attention 4096, partial"),
               train["launches"]["flash_attention"], sources),
        _entry("flash_attention", "moe-window", QWEN3,
               case(QWEN3, "flash_attention", "ring prefill chunk, normalized"),
               moe["launches"]["flash_attention"], sources),
        _entry("gmm", "moe-window", QWEN3, case(QWEN3, "gmm", "gate/up, decode (serving)"),
               moe["launches"]["gmm"], sources)]


def _serve_world_line(serve_world: dict, sources: dict) -> list:
    """Phase 13's entries of the kernels line: per model (path
    ``serve-world[-qwen2]``) the GMM with rank 0's launches, timed at the
    fold's decode shard, and flash with rank 0's launches, timed at the
    fold's decode launch (Mixtral: the partial on a CP slice)."""
    line = []
    for arch in (MIXTRAL, QWEN2):
        launches = serve_world[arch]["ranks"][0]["launches"]
        path = "serve-world" + SHORT[arch]
        line.append(_entry("gmm", path, arch, serve_world["kernels"]["gmm"][arch][0],
                           launches["gmm"], sources))
        line.append(_entry("flash_attention", path, arch,
                           serve_world["kernels"]["flash_attention"][arch][0],
                           launches["flash_attention"], sources))
    line.append(_entry("flash_attention", "serve-world" + SHORT[ZAMBA2], ZAMBA2,
                       serve_world["kernels"]["flash_attention"][ZAMBA2][0],
                       serve_world["recurrent"][ZAMBA2]["ranks"][0]["launches"]
                       ["flash_attention"], sources))
    return line


def _entry(name: str, path: str, model: str, c: dict, launches: int, sources: dict) -> dict:
    """One entry of the kernels line: kernel ``name`` on main path ``path``
    with that path's ``launches``, timed and held in case ``c``."""
    return dict(name=name, path=path, model=model, case=c["case"], route="cuda",
                source=sources[name][0], replaces=sources[name][1], launches=launches,
                max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
                bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=c["library_ms"])


def _train_configs_line(config_kernels: dict, train_configs: dict, sources: dict) -> list:
    """"train-configs" entries of the kernels line (path
    ``train-configs-<model>``): each kernel with that model's launches, timed
    at its phase 3 row of the training step's shape."""
    line = []
    for arch, res in train_configs.items():
        M = _config_gmm_specs(arch)[1][0][1]
        for name, label in (("gmm", f"gate/up, M={M}"), ("gmm_trans_w", f"dgrad trans_w, M={M}"),
                            ("flash_attention", "causal self-attention 4096, partial")):
            c = next(x for x in config_kernels[arch][name] if x["case"] == label)
            line.append(_entry(name, "train-configs" + SHORT[arch], arch, c,
                               res["train"]["launches"][name], sources))
    return line


def _train_handoff_line(train_handoff: dict, sources: dict) -> list:
    """Phase 12's entries of the kernels line (paths ``train-handoff`` and
    ``train-handoff-cross-dp``): each kernel with rank 0's launches in the
    hand-off world and in the world across DP ranks, timed at its shape."""
    line = []
    k = train_handoff["kernels"]
    for world, path, flash in (("handoff", "train-handoff", k["flash_attention"][0]),
                               ("cross-dp", "train-handoff-cross-dp",
                                k["flash_attention"][1])):
        runs = train_handoff["worlds"][world]["ranks"][0]["runs"]
        launches = runs[HANDOFF["runs"][0][4]]["launches"]     # both runs are keyed "fsdp"
        line += [_entry(name, path, QWEN2, c, launches[name], sources)
                 for name, c in (("gmm", k["gmm"][0]), ("gmm_trans_w", k["gmm_trans_w"][0]),
                                 ("flash_attention", flash))]
    return line


def _train_resume_line(train_resume: dict, train_zero: dict, sources: dict) -> list:
    """Phase 11's entries of the kernels line (path ``train-resume``): each
    kernel with rank 0's launches since the restore, timed at phase 9's
    Mixtral shape (the same launches)."""
    launches = train_resume["full"]["ranks"][0]["launches"]
    return [_entry(name, "train-resume", MIXTRAL, train_zero[MIXTRAL]["kernels"][name][0],
                   launches[name], sources) for name in ("gmm", "gmm_trans_w", "flash_attention")]


def _train_pipe_line(train_pipe: dict, sources: dict) -> list:
    """Phase 10's entries of the kernels line (path ``train-pipe``): each
    kernel with rank 0's launches in run (a), timed at its shape."""
    launches = train_pipe["full"]["ranks"][0]["runs"]["allgather"]["launches"]
    return [_entry(name, "train-pipe", MIXTRAL, train_pipe["kernels"][name][0], launches[name],
                   sources) for name in ("gmm", "gmm_trans_w", "flash_attention")]


def _train_zero_line(train_zero: dict, sources: dict) -> list:
    """Phase 9's entries of the kernels line: per model (path
    ``train-zero[-qwen2]``) each kernel with rank 0's launches in its first
    run, timed at that run's shape."""
    line = []
    for arch in ZERO_RUNS:
        res = train_zero[arch]
        launches = res["ranks"][0]["runs"][res["base"]]["launches"]
        line += [_entry(name, "train-zero" + SHORT[arch], arch, res["kernels"][name][0],
                        launches[name], sources)
                 for name in ("gmm", "gmm_trans_w", "flash_attention")]
    return line


def _train_world_line(train_world: dict, sources: dict) -> list:
    """Phase 8's entries of the kernels line: per model and run (path
    ``train-world[-ring][-qwen2]``) each kernel with rank 0's launches in
    that run, timed at the run's shape (all-gather: the queries of CP chunk
    1; ring: a wholly visible pair; the GMM at the EP shard's)."""
    line = []
    for arch, res in train_world.items():
        for mode, _ in TRAIN_WORLD[arch]["runs"]:
            path = "train-world" + ("-ring" if mode == "ring" else "") + SHORT[arch]
            launches = res["ranks"][0]["runs"][mode]["launches"]
            for name in ("gmm", "gmm_trans_w", "flash_attention"):
                cases = res["kernels"][name]
                if name == "flash_attention":
                    cases = [c for c in cases if c["case"].startswith(
                        "ring pair, keys wholly visible" if mode == "ring" else
                        "all-gather CP, queries of chunk 1")]
                line.append(_entry(name, path, arch, cases[0], launches[name], sources))
    return line


# ----------------------------------------------------------- phase 15: block kinds

GEMMA, QWEN2VL, WHISPER = "gemma-7b", "qwen2-vl-7b", "whisper-small"
CODEQWEN = "codeqwen1.5-7b"             # a kernel row only: multi-head decode at heads of 128
BLOCKS_SERVE = dict(layers=4, prompts=(1000, 700), new=16, s_max=1024)
BLOCKS_ENGINE = dict(max_batch=2, page_size=128, prefill_chunk=512)
# Training depth (None: the published depth) and steps of one 4096-token sequence.
BLOCKS_TRAIN = dict(layers={GEMMA: 1, QWEN2VL: 2, WHISPER: None}, seq=4096, batch=1, steps=2)
WHISPER_DECODE = dict(prompt=8, steps=3, s_max=64)
# (d): Qwen2-VL's step with an image's patches that share one temporal id,
# its kernel row, and the length of its card-vs-CPU check at full width
# (the CPU takes seconds a step there: 256 vision rows and 64 of text).
POSITIONS_ROW = "causal self-attention 4096, 256 vision rows share a temporal id"
POSITIONS_CHECK_SEQ = 320


def _flash_layers(cfg) -> int:
    """Flash launches of one forward of ``cfg``'s training step: one per
    self-attention, one per cross-attention and one per encoder layer."""
    return cfg.n_layers * (2 if cfg.is_encoder_decoder else 1) + cfg.n_encoder_layers


def _blocks_flops(cfg, S: int) -> float:
    """Model FLOPs of one training step of one S-token sequence: 6 per
    weight per token it touches (the encoder's and the cross K/V weights
    per frame), the LM head, and the attention products (3 × 4·hd per
    visible query-key pair per head: causal self-attention, the encoder's
    and the cross-attention's full ones). The input lookup is no product."""
    D, F, V, H, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_heads, cfg.resolved_head_dim
    attn = D * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * D
    ffn = D * F * (3 if cfg.activation in ("swiglu", "geglu") else 2)
    flops = 6.0 * S * (cfg.n_layers * (attn + ffn) + D * V)
    pairs = cfg.n_layers * S * (S + 1) / 2
    if cfg.is_encoder_decoder:
        T = cfg.max_source_positions
        cross_q = D * cfg.q_dim + cfg.q_dim * D
        flops += 6.0 * (S * cfg.n_layers * cross_q + T * cfg.n_layers * 2 * D * cfg.kv_dim
                        + T * cfg.n_encoder_layers * (attn + ffn))
        pairs += cfg.n_layers * S * T + cfg.n_encoder_layers * T * T
    return flops + 3 * 4.0 * hd * H * pairs


def _vision_positions(cfg, B: int, S: int):
    """M-RoPE streams (B, S, 3) for a batch whose first ``n_vision_tokens``
    rows are an image's patches: the temporal stream a run (what the flash
    kernel's mask takes), height and width the patch grid, then the text's
    positions on every stream."""
    import numpy as np
    n = cfg.n_vision_tokens
    side = int(round(n ** 0.5))
    t = np.arange(S)
    h, w = t.copy(), t.copy()
    h[:n], w[:n] = np.arange(n) // side, np.arange(n) % side
    return np.broadcast_to(np.stack([t, h, w], -1), (B, S, 3)).astype(np.int32).copy()


def _blocks_batches(cfg, seq: int, batch: int, steps: int) -> list:
    """``steps`` batches from ``SyntheticTokens(seed=0)`` with the arch's stub
    inputs (``materialize_batch``; Qwen2-VL's positions from
    :func:`_vision_positions`), read on the host as the launcher reads
    them (``mark_runs``: a temporal run masks at scalar offsets)."""
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens, mark_runs,
                                           materialize_batch)
    data = SyntheticTokens(DataConfig(seq_len=seq, global_batch=batch,
                                      vocab_size=cfg.vocab_size, seed=0))
    out = []
    for _ in range(steps):
        b = materialize_batch(cfg, next(data))
        if cfg.rope_kind == "mrope":
            b["positions"] = _vision_positions(cfg, batch, seq)
        out.append(mark_runs(b))
    return out


def _record_margins(eng) -> dict:
    """Each request's top-1 minus top-2 logit at every greedy choice the
    engine ``eng`` makes, by request id (its sampler wrapped; it chooses as
    before)."""
    import numpy as np
    margins: dict = {}
    sample = eng._sample

    def recorded(run, row):
        top = np.partition(row, -2)[-2:]
        margins.setdefault(run.rid, []).append(float(top[1] - top[0]))
        return sample(run, row)
    eng._sample = recorded
    return margins


def _blocks_serve(torch, arch: str) -> tuple:
    """(a)/(b) serving: ``arch`` at full width cut to 4 layers, bf16, the same
    two requests through a paged and a dense engine, each run with the
    counters set to 0 just before and read just after."""
    from repro_torch.launch.serve import slice_config, submit_random
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Engine, EngineConfig
    cfg = slice_config(arch, layers=BLOCKS_SERVE["layers"])
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    out, failures = dict(model=f"{cfg.name} x{cfg.n_layers} layers (full width), bf16, heads "
                               f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}",
                         runs={}), []
    for cache in ("paged", "dense"):
        tag = f"serve-{SHORT[arch][1:]}" + ("" if cache == "paged" else "-dense")
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, EngineConfig(cache=cache, s_max=BLOCKS_SERVE["s_max"],
                                               **BLOCKS_ENGINE))
        keep = arch == QWEN2VL and cache == "paged"       # phase 18's reference
        margins = _record_margins(eng) if keep else None
        rids = submit_random(eng, cfg, BLOCKS_SERVE["prompts"], BLOCKS_SERVE["new"], seed=0)
        torch.cuda.synchronize()
        _zero_counters()
        t0 = time.perf_counter()
        res = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters()
        n_fwd = sum(1 for s in eng.stats if s.prefill_tokens) + \
            sum(1 for s in eng.stats if s.decode_tokens)
        expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": cfg.n_layers * n_fwd}
        dec = [t[1] for t in eng.timings if t[1] > 0]
        run = dict(forwards=n_fwd, launches=launches, wall_s=wall,
                   decode_step_ms_median=statistics.median(dec) * 1e3,
                   prefill_tok_per_s=sum(s.prefill_tokens for s in eng.stats) /
                   sum(t[0] for t in eng.timings),
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                   tokens=[res[r].tokens.tolist() for r in rids])
        if keep:                         # phase 18's reference (the logits not in the JSON)
            run["logits"] = [res[r].last_prefill_logits for r in rids]
            run["margins"] = [margins[r] for r in rids]
        _say(f"[blocks {tag}] {out['model']}: {len(rids)} requests, {n_fwd} forwards, wall "
             f"{wall:.3f} s, launches {launches} (expected {expect}); prefill "
             f"{run['prefill_tok_per_s']:.1f} tok/s, decode step median "
             f"{run['decode_step_ms_median']:.3f} ms; max_memory_allocated "
             f"{run['max_memory_allocated_gb']:.2f} GB")
        if launches != expect:
            failures.append(f"{arch} {tag}: launches {launches} != {expect}")
        for r in rids:
            toks = res[r].tokens
            if not (res[r].finished and len(toks) == BLOCKS_SERVE["new"]
                    and 0 <= toks.min() and toks.max() < cfg.vocab_size):
                failures.append(f"{arch} {tag} request {r}: tokens {toks.tolist()}")
        out["runs"][cache] = run
        del eng, res
        torch.cuda.empty_cache()
    out["paged_equals_dense"] = out["runs"]["paged"]["tokens"] == out["runs"]["dense"]["tokens"]
    _say(f"[blocks serve] {arch}: paged tokens equal dense tokens: {out['paged_equals_dense']}")
    if not out["paged_equals_dense"]:
        failures.append(f"{arch}: paged tokens differ from dense tokens")
    del params
    return out, failures


def _blocks_train(torch, arch: str) -> tuple:
    """(a)/(b)/(c) training: AdamW steps of one 4096-token sequence (fp32
    masters and moments, bf16 compute, full remat), counters set to 0 just
    before and read just after: 2 flash launches (forward, remat's
    recompute) a step per self-attention, cross-attention and encoder
    layer."""
    from repro_torch.launch.train import PEAK_BF16_FLOPS, train_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state, make_train_step
    cfg = train_config(arch, layers=BLOCKS_TRAIN["layers"][arch])
    seq, steps = BLOCKS_TRAIN["seq"], BLOCKS_TRAIN["steps"]
    params = init_lm(cfg, seed=0, device="cuda")
    opt = init_train_state(params)
    step = make_train_step(cfg, guard=True)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
               for b in _blocks_batches(cfg, seq, BLOCKS_TRAIN["batch"], steps)]
    flops = _blocks_flops(cfg, seq) * BLOCKS_TRAIN["batch"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    rows = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows.append(dict({k: float(v) for k, v in m.items()}, step_ms=dt * 1e3,
                         mfu=flops / dt / PEAK_BF16_FLOPS))
    launches = _read_counters()
    expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": 2 * _flash_layers(cfg) * steps}
    out = dict(model=f"{cfg.name} x{cfg.n_layers} layers"
                     + (f" + {cfg.n_encoder_layers} encoder layers over "
                        f"{cfg.max_source_positions} frames" if cfg.is_encoder_decoder else "")
                     + (f", {cfg.n_vision_tokens} vision rows" if cfg.n_vision_tokens else "")
                     + f" (full width), {BLOCKS_TRAIN['batch']} x {seq} tokens a step",
               steps=rows, launches=launches, model_tflop_per_step=flops / 1e12,
               compute_bound_ms=_bound(0, flops)[0],
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    failures = []
    for i, r in enumerate(rows):
        _say(f"[blocks train-{SHORT[arch][1:]}] step {i}: loss {r['loss']:.6f} grad_norm "
             f"{r['grad_norm']:.4f} step_ok {bool(r['step_ok'])}; {r['step_ms']:.1f} ms, MFU "
             f"{100 * r['mfu']:.2f}%")
        if not (r["loss"] == r["loss"] and abs(r["loss"]) != float("inf") and r["step_ok"]):
            failures.append(f"{arch} train step {i}: loss {r['loss']}, step_ok {r['step_ok']}")
    _say(f"[blocks train-{SHORT[arch][1:]}] {out['model']}: launches {launches} (expected "
         f"{expect}); {flops / 1e12:.3f} model TFLOP a step, compute bound "
         f"{out['compute_bound_ms']:.3f} ms; max_memory_allocated "
         f"{out['max_memory_allocated_gb']:.2f} GB")
    if launches != expect:
        failures.append(f"{arch} train launches {launches} != {expect}")
    del params, opt, step, batches
    torch.cuda.empty_cache()
    return out, failures


def _blocks_train_positions(torch) -> tuple:
    """(d) Qwen2-VL at BLOCKS_TRAIN's depth and width, an image's 256
    patches sharing one temporal id (``_shared_positions``): the flash
    kernel takes the temporal stream as ``q_pos`` and ``kv_pos``. First the
    check at POSITIONS_CHECK_SEQ tokens, the card (bf16) against the CPU
    plain path (fp32) on the same weights: the loss, the gradient norm and
    the logits (max abs error over max abs) within ``CHECK_TOL``; and a
    control, the card with the positions dropped (the default causal mask
    at offsets), whose logits must part from the CPU's by more than
    ``CHECK_TOL``, or the check could not tell the positions from the
    default. Then one AdamW step of 4096 tokens, counters set to 0 just
    before and read just after (2 flash launches a layer, all with
    ``q_pos``)."""
    import dataclasses
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, materialize_batch
    from repro_torch.launch.train import PEAK_BF16_FLOPS, train_config
    from repro_torch.models.sharding import map_params
    from repro_torch.models.transformer import apply_lm, init_lm
    from repro_torch.train.loop import (grad_norm, init_train_state, loss_and_grads,
                                        make_train_step)
    cfg = train_config(QWEN2VL, layers=BLOCKS_TRAIN["layers"][QWEN2VL])
    params = init_lm(cfg, seed=0, device="cuda")

    def batch(seq, seed):
        data = SyntheticTokens(DataConfig(seq_len=seq, global_batch=1,
                                          vocab_size=cfg.vocab_size, seed=seed))
        b = materialize_batch(cfg, next(data))
        b["positions"] = _shared_positions(cfg, 1, seq)
        return b
    check = batch(POSITIONS_CHECK_SEQ, 1)
    control = {k: v for k, v in check.items() if k != "positions"}
    got, logits = {}, {}
    t0 = time.perf_counter()
    for run, dev, c, p, b in (
            ("card", "cuda", cfg, params, check), ("control", "cuda", cfg, params, control),
            ("cpu", "cpu", dataclasses.replace(cfg, dtype="float32"),
             map_params(params, lambda n, t: t.cpu()), check)):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        grads, m = loss_and_grads(p, tb, c, remat=False)
        got[run] = dict(loss=float(m["loss"]), grad_norm=float(grad_norm(grads)))
        del grads
        with torch.no_grad():
            logits[run] = apply_lm(p, tb, c, remat=False)[0].float().cpu()
        del p, tb
    check_s = time.perf_counter() - t0
    scale = float(logits["cpu"].abs().max())
    rel = {run: dict({k: abs(got[run][k] - got["cpu"][k]) / abs(got["cpu"][k])
                      for k in got["cpu"]},
                     logits=float((logits[run] - logits["cpu"]).abs().max()) / scale)
           for run in ("card", "control")}
    del logits
    _say(f"[blocks train-positions-qwen2vl] {POSITIONS_CHECK_SEQ} tokens, 256 vision rows "
         f"sharing a temporal id, full width x{cfg.n_layers}: card (bf16) {got['card']}, CPU "
         f"plain path (fp32) {got['cpu']}: rel err {rel['card']} (limit {CHECK_TOL}); "
         f"control, the card without the positions: {got['control']}, rel err "
         f"{rel['control']} (logits must exceed {CHECK_TOL}); {check_s:.1f} s")
    failures = []
    if max(rel["card"].values()) > CHECK_TOL:
        failures.append(f"qwen2-vl positions check: rel err {rel['card']}")
    if rel["control"]["logits"] <= CHECK_TOL:
        failures.append(f"qwen2-vl positions check: the control (no positions) is within "
                        f"the limit too, logits rel err {rel['control']['logits']:.3e}")
    seq = BLOCKS_TRAIN["seq"]
    step_batch = {k: torch.from_numpy(v).to("cuda") for k, v in batch(seq, 0).items()}
    opt = init_train_state(params)
    step = make_train_step(cfg, guard=True)
    flops = _blocks_flops(cfg, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, step_batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counters()
    expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": 2 * _flash_layers(cfg),
              "flash_attention_qpos": 2 * _flash_layers(cfg)}
    row = dict({k: float(v) for k, v in m.items()}, step_ms=dt * 1e3,
               mfu=flops / dt / PEAK_BF16_FLOPS)
    out = dict(model=f"{cfg.name} x{cfg.n_layers} layers, 256 vision rows sharing a temporal "
                     f"id (full width), 1 x {seq} tokens a step", check=got, check_rel_err=rel,
               check_s=check_s, step=row, launches=launches,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    _say(f"[blocks train-positions-qwen2vl] {out['model']}: loss {row['loss']:.6f} grad_norm "
         f"{row['grad_norm']:.4f} step_ok {bool(row['step_ok'])}; {row['step_ms']:.1f} ms, MFU "
         f"{100 * row['mfu']:.2f}%; launches {launches} (expected {expect}); "
         f"max_memory_allocated {out['max_memory_allocated_gb']:.2f} GB")
    if launches != expect or not (row["loss"] == row["loss"] and row["step_ok"]):
        failures.append(f"qwen2-vl positions step: launches {launches} (expected {expect}), "
                        f"loss {row['loss']}, step_ok {row['step_ok']}")
    del params, opt, step, step_batch
    torch.cuda.empty_cache()
    return out, failures


def _whisper_decode(torch) -> tuple:
    """(c) Whisper's ``decode_step`` at full depth, bf16, one row: a prompt
    chunk, then greedy decode steps, counters set to 0 just before and read
    just after (2 flash launches a layer a call: self- and cross-attention,
    the cross K/V zeros, as the reference leaves them)."""
    from repro_torch.launch.train import train_config
    from repro_torch.models.transformer import decode_step, init_decode_state, init_lm
    cfg = train_config(WHISPER)
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    state = init_decode_state(cfg, 1, WHISPER_DECODE["s_max"], device="cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (1, WHISPER_DECODE["prompt"]), generator=g)
    tok = tok.to("cuda")
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    calls, new, finite = 0, [], True
    with torch.no_grad():
        for _ in range(WHISPER_DECODE["steps"] + 1):
            logits, state = decode_step(params, state, tok, cfg)
            calls += 1
            finite &= bool(torch.isfinite(logits).all())
            tok = logits[:, -1:].argmax(-1)
            new.append(int(tok))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": 2 * cfg.n_layers * calls}
    out = dict(calls=calls, launches=launches, wall_s=wall, tokens=new, step=state["step"])
    _say(f"[blocks decode-whisper] {cfg.name} x{cfg.n_layers} decoder layers, bf16: a "
         f"{WHISPER_DECODE['prompt']}-token chunk then {WHISPER_DECODE['steps']} decode steps in "
         f"{wall:.3f} s, tokens {new}, launches {launches} (expected {expect}), finite {finite}")
    failures = []
    if launches != expect or not finite or state["step"] != WHISPER_DECODE["prompt"] + \
            WHISPER_DECODE["steps"] or not all(0 <= t < cfg.vocab_size for t in new):
        failures.append(f"whisper decode: launches {launches} (expected {expect}), finite "
                        f"{finite}, step {state['step']}, tokens {new}")
    del params, state
    torch.cuda.empty_cache()
    return out, failures


def _blocks_checks(torch) -> dict:
    """Phase 6's reduced card-vs-CPU checks for the three archs: training
    (gradients leaf by leaf, two steps' loss and grad_norm) with their stub
    inputs, serving's prefill logits for Gemma and Qwen2-VL, and Whisper's
    ``decode_step`` logits. Gemma's reduced heads are set to 256, so the
    check runs the head-256 kernels."""
    import copy
    import dataclasses
    from repro_torch.launch.serve import slice_config
    from repro_torch.launch.train import train_config
    from repro_torch.models.transformer import decode_step, init_decode_state, init_lm
    heads = {GEMMA: dict(head_dim=256)}
    out = {}
    for arch in (GEMMA, QWEN2VL, WHISPER):
        kw = heads.get(arch, {})
        res = {"train": phase_train_check(torch, arch, dataclasses.replace(
            train_config(arch, reduce=True), **kw))}
        if arch != WHISPER:
            res["serve"] = phase_check(torch, arch, dataclasses.replace(
                slice_config(arch, reduce=True), **kw))
        else:
            cfg = train_config(arch, reduce=True)
            cfg = dataclasses.replace(cfg, dtype="bfloat16")
            cpu = init_lm(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
            runs = {"cuda": copy.deepcopy(cpu).to("cuda"), "cpu": cpu}
            tok = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(3))
            logits = {}
            with torch.no_grad():
                for dev, p in runs.items():
                    st = init_decode_state(cfg, 2, 32, device=dev)
                    outs = []
                    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
                        lg, st = decode_step(p, st, tok[:, lo:hi].to(dev), cfg)
                        outs.append(lg.float().cpu())
                    logits[dev] = torch.cat(outs, 1)
            err = float((logits["cuda"] - logits["cpu"]).abs().max() / logits["cpu"].abs().max())
            _say(f"[check] {arch} reduced decode_step, card vs CPU plain versions: logits rel "
                 f"err {err:.3e} (limit {CHECK_TOL})")
            if not (torch.isfinite(logits["cuda"]).all() and err <= CHECK_TOL):
                raise AssertionError(f"{arch} reduced decode_step: card vs CPU rel err {err:.3e}")
            res["decode"] = {"logits_rel_err": err}
        out[arch] = res
    return out


def _blocks_kernels(torch) -> dict:
    """Phase 15's kernel rows, held and timed as in phase 3: flash at Gemma's
    heads of 256 (causal 4096 in the training step's partial mode, the
    serving decode against 1024 keys, a 512-query prefill chunk), at
    Qwen2-VL's (28/4 of 128: causal 4096, its decode, and (d)'s causal 4096
    at the positions of 256 vision rows that share a temporal id, ``q_pos``
    and ``kv_pos``), and at Whisper's 12
    of 64, not causal, over 1500 frames (the encoder; cross-attention of
    4096 queries); and CodeQwen1.5-7B's multi-head decode (32/32 heads of
    128, 4 rows against 1024 keys), a kernel row with no main path."""
    from repro_torch.launch.train import train_config
    res = {}
    for arch, rows in ((GEMMA, [
            (("causal self-attention 4096", 4096, 4096, [0]), (True,), True),
            (("decode, 1024 keys", 1, 1024, [1023, 1023]), (False,), True),
            (("prefill chunk 512 of 1024", 512, 1024, [512]), (False,), True)]),
            (QWEN2VL, [
                (("causal self-attention 4096", 4096, 4096, [0]), (True,), True),
                (("decode, 1024 keys", 1, 1024, [1023, 1023]), (False,), True)]),
            (WHISPER, [
                (("encoder 1500 x 1500", 1500, 1500, [0]), (True,), False),
                (("cross-attention 4096 x 1500", 4096, 1500, [0]), (True,), False),
                (("decode cross-attention, 1500 frames", 1, 1500, [0]), (False,), False),
                (("causal self-attention 4096", 4096, 4096, [0]), (True,), True)]),
            (CODEQWEN, [(("MHA decode, 1024 keys", 1, 1024, [1023] * 4), (False,), True)])):
        cfg = train_config(arch)
        cases = []
        for case, modes, causal in rows:
            cases += _flash_cases(torch, arch, [case], heads=(cfg.n_heads, cfg.n_kv_heads),
                                  modes=modes, hd=cfg.resolved_head_dim, causal=causal)
        if arch == QWEN2VL:             # (d)'s launch: the temporal stream as q_pos and kv_pos
            cases += _flash_qpos_cases(torch, [(
                POSITIONS_ROW, _shared_positions(cfg, 1, 4096)[..., 0], 4096, "self")],
                (cfg.n_heads, cfg.n_kv_heads), cfg.resolved_head_dim, modes=(True,))
        res[arch] = {"flash_attention": cases}
        _check_cases(arch, res[arch])
    return res


def phase_blocks(torch) -> dict:
    """Phase 15: see the module docstring."""
    t_phase = time.perf_counter()
    out, failures = {}, []
    for arch in (GEMMA, QWEN2VL):
        out[arch] = {}
        out[arch]["serve"], f = _blocks_serve(torch, arch)
        failures += f
        _free(torch, f"{arch} serving done")
        out[arch]["train"], f = _blocks_train(torch, arch)
        failures += f
        _free(torch, f"{arch} training done")
    out[QWEN2VL]["train_positions"], f = _blocks_train_positions(torch)
    failures += f
    _free(torch, "qwen2-vl positions done")
    out[WHISPER] = {}
    out[WHISPER]["train"], f = _blocks_train(torch, WHISPER)
    failures += f
    out[WHISPER]["decode"], f = _whisper_decode(torch)
    failures += f
    _free(torch, "whisper done")
    out["checks"] = _blocks_checks(torch)
    out["kernels"] = _blocks_kernels(torch)
    out["seconds"] = time.perf_counter() - t_phase
    _say(f"[blocks] phase 15 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 15:\n" + "\n".join(failures))
    return out


def _blocks_line(blocks: dict, sources: dict) -> list:
    """Phase 15's entries of the kernels line: flash on each arch's paths
    (``blocks-serve[-dense]-<arch>``, ``blocks-train-<arch>``,
    ``blocks-decode-whisper``), each with its own launches, timed at that
    path's shape."""
    def case(arch, label):
        return next(c for c in blocks["kernels"][arch]["flash_attention"]
                    if c["case"] == label)
    line = []
    for arch in (GEMMA, QWEN2VL):
        runs = blocks[arch]["serve"]["runs"]
        for cache in ("paged", "dense"):
            line.append(_entry("flash_attention",
                               "blocks-serve" + ("" if cache == "paged" else "-dense")
                               + SHORT[arch], arch, case(arch, "decode, 1024 keys, normalized"),
                               runs[cache]["launches"]["flash_attention"], sources))
        line.append(_entry("flash_attention", "blocks-train" + SHORT[arch], arch,
                           case(arch, "causal self-attention 4096, partial"),
                           blocks[arch]["train"]["launches"]["flash_attention"], sources))
    line.append(_entry("flash_attention", "blocks-train-positions" + SHORT[QWEN2VL], QWEN2VL,
                       case(QWEN2VL, POSITIONS_ROW + ", partial"),
                       blocks[QWEN2VL]["train_positions"]["launches"]["flash_attention"],
                       sources))
    line.append(_entry("flash_attention", "blocks-train" + SHORT[WHISPER], WHISPER,
                       case(WHISPER, "cross-attention 4096 x 1500, partial"),
                       blocks[WHISPER]["train"]["launches"]["flash_attention"], sources))
    line.append(_entry("flash_attention", "blocks-decode" + SHORT[WHISPER], WHISPER,
                       case(WHISPER, "decode cross-attention, 1500 frames, normalized"),
                       blocks[WHISPER]["decode"]["launches"]["flash_attention"], sources))
    return line


XLSTM, ZAMBA2 = "xlstm-125m", "zamba2-2.7b"
# Phase 16: the depth of each arch (None: the published one), the serving
# workload (BLOCKS_SERVE's requests and engine), Zamba2 from a dense cache
# only (its shared block's cache is per cycle repeat), and the training runs.
RECUR_LAYERS = {XLSTM: None, ZAMBA2: 12}
RECUR_CACHES = {XLSTM: ("paged", "dense"), ZAMBA2: ("dense",)}
# xLSTM trains one cycle (4 layers: mLSTM x3 + sLSTM): at its 12 layers a
# step took 23.6-25.8 s on an H100 (3 sLSTM layers of 4096 sequential
# cells, 88% of it), so its four steps would take 100 s alone; at one cycle
# a 4096-token step still took 15-32 s, so it runs one step a run (Zamba2
# two) of 1024 tokens (its sLSTM cells are sequential: a quarter of the
# time; ``launch/profile_train.py`` splits it at the same length).
RECUR_TRAIN = dict(seq={XLSTM: 1024, ZAMBA2: 4096}, batch=1, steps={XLSTM: 1, ZAMBA2: 2},
                   layers={XLSTM: 4, ZAMBA2: 12})


def _recurrent_serve(torch, arch: str) -> tuple:
    """(a)/(b) serving: BLOCKS_SERVE's two requests through each of the
    arch's engines, each run with the counters set to 0 just before and
    read just after: 1 flash launch per forward per KV-bearing layer (none
    for xLSTM; Zamba2's shared block once a cycle repeat), no GMM."""
    from repro_torch.launch.serve import slice_config, submit_random
    from repro_torch.models import ssm_blocks
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.cache import n_kv_layers
    cfg = slice_config(arch, layers=RECUR_LAYERS[arch])
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    state = {k: ssm_blocks.state_bytes(k, cfg) for k in set(cfg.blocks()) & set(ssm_blocks.KINDS)}
    out, failures = dict(model=f"{cfg.name} x{cfg.n_layers} layers (full width), bf16",
                         state_bytes_a_layer=state,
                         state_bytes_a_request=sum(state[k] for k in cfg.blocks() if k in state),
                         runs={}), []
    _say(f"[recurrent serve{SHORT[arch]}] recurrent state a request: "
         f"{out['state_bytes_a_request'] / 1e6:.2f} MB ("
         + ", ".join(f"{k} {v / 1e6:.3f} MB a layer" for k, v in state.items()) + ")")
    for cache in RECUR_CACHES[arch]:
        tag = f"serve{SHORT[arch]}" + ("" if cache == "paged" else "-dense")
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, EngineConfig(cache=cache, s_max=BLOCKS_SERVE["s_max"],
                                               **BLOCKS_ENGINE))
        rids = submit_random(eng, cfg, BLOCKS_SERVE["prompts"], BLOCKS_SERVE["new"], seed=0)
        torch.cuda.synchronize()
        _zero_counters()
        t0 = time.perf_counter()
        res = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters()
        n_fwd = sum(1 for s in eng.stats if s.prefill_tokens) + \
            sum(1 for s in eng.stats if s.decode_tokens)
        expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": n_kv_layers(cfg) * n_fwd}
        dec = [t[1] for t in eng.timings if t[1] > 0]
        run = dict(forwards=n_fwd, launches=launches, wall_s=wall,
                   decode_step_ms_median=statistics.median(dec) * 1e3,
                   prefill_tok_per_s=sum(s.prefill_tokens for s in eng.stats) /
                   sum(t[0] for t in eng.timings),
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                   tokens=[res[r].tokens.tolist() for r in rids],
                   logits=[res[r].last_prefill_logits for r in rids])
        _say(f"[recurrent {tag}] {out['model']}: {len(rids)} requests, {n_fwd} forwards, wall "
             f"{wall:.3f} s, launches {launches} (expected {expect}); prefill "
             f"{run['prefill_tok_per_s']:.1f} tok/s, decode step median "
             f"{run['decode_step_ms_median']:.3f} ms; max_memory_allocated "
             f"{run['max_memory_allocated_gb']:.2f} GB")
        if launches != expect:
            failures.append(f"{arch} {tag}: launches {launches} != {expect}")
        for r in rids:
            toks = res[r].tokens
            if not (res[r].finished and len(toks) == BLOCKS_SERVE["new"]
                    and 0 <= toks.min() and toks.max() < cfg.vocab_size):
                failures.append(f"{arch} {tag} request {r}: tokens {toks.tolist()}")
        out["runs"][cache] = run
        del eng, res
        torch.cuda.empty_cache()
    if "paged" in out["runs"]:
        out["paged_equals_dense"] = out["runs"]["paged"]["tokens"] == \
            out["runs"]["dense"]["tokens"]
        _say(f"[recurrent serve] {arch}: paged tokens equal dense tokens: "
             f"{out['paged_equals_dense']}")
        if not out["paged_equals_dense"]:
            failures.append(f"{arch}: paged tokens differ from dense tokens")
    del params
    return out, failures


def _recurrent_train_run(torch, cfg, batches) -> dict:
    """RECUR_TRAIN's AdamW steps from the seed's weights (fp32 masters and
    moments, bf16 compute, remat), counters set to 0 just before and read
    just after. (Not profiled here: under ``torch.profiler`` an xLSTM step
    of 4096 sLSTM cells took 400 s; ``launch/profile_train.py`` splits
    one.)"""
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.loop import init_train_state, make_train_step
    params = init_lm(cfg, seed=0, device="cuda")
    opt = init_train_state(params)
    step = make_train_step(cfg, guard=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    rows = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        rows.append(dict({k: float(v) for k, v in m.items()},
                         step_ms=(time.perf_counter() - t0) * 1e3))
    out = dict(steps=rows, launches=_read_counters(),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def _slstm_ms(torch, cfg) -> dict:
    """One sLSTM block at ``cfg``'s width over xLSTM's RECUR_TRAIN sequence, bf16,
    timed alone by the host clock (each synchronised; the training runs
    before warmed its ops): its forward without autograd (the step's first
    forward under the reentrant remat) and its forward with the backward
    (remat's recompute and the backward). A step runs both in each sLSTM
    layer. Launch-bound on a host shared with other machines' work, so
    noisy: read it beside the step it is divided by, from the same run."""
    from repro_torch.models import ssm_blocks
    from repro_torch.models.transformer import _init_norm
    g = torch.Generator(device="cuda").manual_seed(5)
    p = ssm_blocks.init_block("slstm", cfg, _init_norm(cfg, "cuda"), generator=g,
                              dtype=torch.bfloat16, device="cuda")
    x = torch.randn((RECUR_TRAIN["batch"], RECUR_TRAIN["seq"][XLSTM], cfg.d_model),
                    generator=g, device="cuda").to(torch.bfloat16).requires_grad_()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def fwd():
        with torch.no_grad():
            ssm_blocks.apply_block(p, x, cfg)

    def fwd_bwd():
        torch.autograd.grad(ssm_blocks.apply_block(p, x, cfg).float().sum(), [x])
    return {"forward_ms": timed(fwd), "forward_backward_ms": timed(fwd_bwd)}


def _recurrent_train(torch, arch: str) -> tuple:
    """(a)/(b) training: RECUR_TRAIN's steps of one sequence
    (``SyntheticTokens(seed=0)``), then the same again: losses finite and
    ``step_ok``, losses and ``grad_norm`` bitwise equal across the two
    runs, flash launches 2 a step per KV-bearing layer (forward and remat's
    recompute: Zamba2's shared block twice, xLSTM none), no GMM. For xLSTM
    also the sLSTM layers' estimated share of the step (``_slstm_ms``)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import PEAK_BF16_FLOPS, recurrent_flops, train_config
    from repro_torch.models.transformer import param_shapes
    from repro_torch.serve.cache import n_kv_layers
    cfg = train_config(arch, layers=RECUR_TRAIN["layers"][arch])
    seq, steps = RECUR_TRAIN["seq"][arch], RECUR_TRAIN["steps"][arch]
    data = SyntheticTokens(DataConfig(seq_len=seq, global_batch=RECUR_TRAIN["batch"],
                                      vocab_size=cfg.vocab_size, seed=0))
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
               for _ in range(steps)]
    flops = recurrent_flops(cfg, seq) * RECUR_TRAIN["batch"]
    first = _recurrent_train_run(torch, cfg, batches)
    rerun = _recurrent_train_run(torch, cfg, batches)
    expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": 2 * n_kv_layers(cfg) * steps}
    n_params = sum(math.prod(s) for s in param_shapes(cfg).values())
    out = dict(model=f"{cfg.name} x{cfg.n_layers} layers (full width), {n_params / 1e9:.3f} B "
                     f"parameters, {RECUR_TRAIN['batch']} x {seq} tokens a step",
               first=first, rerun=rerun, launches=first["launches"],
               model_tflop_per_step=flops / 1e12, compute_bound_ms=_bound(0, flops)[0])
    failures = []
    tag = f"[recurrent train{SHORT[arch]}]"
    for i, (a, b) in enumerate(zip(first["steps"], rerun["steps"])):
        a["mfu"] = flops / (a["step_ms"] / 1e3) / PEAK_BF16_FLOPS
        same = a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        _say(f"{tag} step {i}: loss {a['loss']:.6f} (rerun {b['loss']:.6f}), grad_norm "
             f"{a['grad_norm']:.4f} (rerun {b['grad_norm']:.4f}), bitwise {same}, step_ok "
             f"{bool(a['step_ok'])}; wall {a['step_ms']:.1f} ms (rerun {b['step_ms']:.1f}), "
             f"MFU {100 * a['mfu']:.3f}%")
        finite = all(x == x and abs(x) != float("inf") for x in (a["loss"], a["grad_norm"]))
        if not (finite and a["step_ok"] and same):
            failures.append(f"{arch} train step {i}: loss {a['loss']} / rerun {b['loss']}, "
                            f"grad_norm {a['grad_norm']} / rerun {b['grad_norm']}, "
                            f"step_ok {a['step_ok']}")
    for run in (first, rerun):
        if run["launches"] != expect:
            failures.append(f"{arch} train launches {run['launches']} != {expect}")
    _say(f"{tag} {out['model']}: launches {first['launches']} (expected {expect}); "
         f"{flops / 1e12:.3f} model TFLOP a step (recurrent_flops), compute bound "
         f"{out['compute_bound_ms']:.3f} ms; max_memory_allocated "
         f"{first['max_memory_allocated_gb']:.2f} GB")
    n_slstm = sum(1 for k in cfg.blocks() if k == "slstm")
    if n_slstm:
        sl = _slstm_ms(torch, cfg)
        # the steps but the first (its warm-up), median: the host's pace varies
        step_ms = statistics.median(r["step_ms"] for r in first["steps"][1:] + rerun["steps"])
        sl["layers"] = n_slstm
        sl["share_of_step"] = n_slstm * (sl["forward_ms"] + sl["forward_backward_ms"]) / step_ms
        out["slstm"] = sl
        _say(f"{tag} one sLSTM layer alone over {seq} tokens: forward {sl['forward_ms']:.1f} ms, "
             f"forward + backward {sl['forward_backward_ms']:.1f} ms; {n_slstm} layers ~ "
             f"{100 * sl['share_of_step']:.1f}% of the median step, {step_ms:.1f} ms")
    return out, failures


def _recurrent_checks(torch) -> dict:
    """Phase 6's reduced card-vs-CPU checks for both archs at 4 layers
    (xLSTM's cycle with its sLSTM layer; Zamba2's two shared-block repeats,
    its heads set to 80 so that the check runs the head-80 kernels):
    training's gradients and two steps, and serving's prefill logits
    (Zamba2 from a dense cache). xLSTM's path has no kernel, and in bf16
    its gate gradients part from fp32 by 3–36% on the CPU alone (two card
    runs of the bf16 check held layer 2's ``wf`` at 1.0e-1 and
    ``w_qkv_lstm`` at 6.0e-2 against the CPU): its training check runs in
    fp32 on both sides (TF32 off), where a device-side fault stands out.
    Zamba2's runs the head-80 flash kernel, which takes bf16."""
    import dataclasses
    from repro_torch.launch.serve import slice_config
    from repro_torch.launch.train import train_config
    kw = {XLSTM: dict(n_layers=4), ZAMBA2: dict(n_layers=4, head_dim=80)}
    train_kw = {XLSTM: dict(dtype="float32"), ZAMBA2: {}}
    return {arch: {"train": phase_train_check(torch, arch, dataclasses.replace(
                       train_config(arch, reduce=True), **kw[arch]), **train_kw[arch]),
                   "serve": phase_check(torch, arch, dataclasses.replace(
                       slice_config(arch, reduce=True), **kw[arch]))}
            for arch in (XLSTM, ZAMBA2)}


def _recurrent_kernels(torch) -> dict:
    """Phase 16's kernel rows, held and timed as in phase 3: flash at
    Zamba2's heads (32/32 of 80): causal 4096 in the training step's
    partial mode, the serving decode against 1024 keys, a 512-query prefill
    chunk against 1024 keys."""
    cases = []
    for case, modes in ((("causal self-attention 4096", 4096, 4096, [0]), (True,)),
                        (("decode, 1024 keys", 1, 1024, [1023, 1023]), (False,)),
                        (("prefill chunk 512 of 1024", 512, 1024, [512]), (False,))):
        cases += _flash_cases(torch, ZAMBA2, [case], heads=(32, 32), modes=modes, hd=80)
    res = {"flash_attention": cases}
    _check_cases(ZAMBA2, res)
    return res


def phase_recurrent(torch) -> dict:
    """Phase 16: see the module docstring."""
    t_phase = time.perf_counter()
    out, failures = {}, []
    for arch in (XLSTM, ZAMBA2):
        out[arch] = {}
        out[arch]["serve"], f = _recurrent_serve(torch, arch)
        failures += f
        _free(torch, f"{arch} serving done")
        out[arch]["train"], f = _recurrent_train(torch, arch)
        failures += f
        _free(torch, f"{arch} training done")
    out["checks"] = _recurrent_checks(torch)
    out["kernels"] = _recurrent_kernels(torch)
    out["seconds"] = time.perf_counter() - t_phase
    _say(f"[recurrent] phase 16 took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError("phase 16:\n" + "\n".join(failures))
    return out


def _recurrent_line(rec: dict, sources: dict) -> list:
    """Phase 16's entries of the kernels line: flash on Zamba2's paths
    (``recurrent-serve-dense-zamba2``, ``recurrent-train-zamba2``), each with
    its own launches, timed at that path's shape. xLSTM's paths launch no
    kernel: the reference has no TPU kernel on them."""
    def case(label):
        return next(c for c in rec["kernels"]["flash_attention"] if c["case"] == label)
    return [_entry("flash_attention", "recurrent-serve-dense" + SHORT[ZAMBA2], ZAMBA2,
                   case("decode, 1024 keys, normalized"),
                   rec[ZAMBA2]["serve"]["runs"]["dense"]["launches"]["flash_attention"],
                   sources),
            _entry("flash_attention", "recurrent-train" + SHORT[ZAMBA2], ZAMBA2,
                   case("causal self-attention 4096, partial"),
                   rec[ZAMBA2]["train"]["launches"]["flash_attention"], sources)]


DRYRUN_TRAIN = ("--arch", MIXTRAL, "--shape", "train_4k", "--layers", "1")
# Phase 17 (c): a production row that pads its encoder frames (1500 over
# cp·tp = 8), traced at its world (rank -1 of 256).
DRYRUN_WHISPER = ("--arch", WHISPER, "--shape", "prefill_32k")
# Phase 17 (b): the pp = 2 fold of the purity check (2 layers, one a stage).
PURITY_PP = dict(attn=(1, 1, 2), moe=(1, 1, 2), pp=2, layers=2)


def _dryrun(*argvs: tuple) -> list:
    """Traces of ``python -m repro_torch.launch.dryrun`` on fake CUDA tensors,
    each given by its arguments, in one subprocess (one interpreter and CUDA
    start); their records."""
    import os
    results = ROOT / "results"
    results.mkdir(exist_ok=True)
    outs = [results / f"dryrun_{i}.jsonl" for i in range(len(argvs))]
    argvs = [[*args, "--device", "cuda", "--out", str(out)] for args, out in zip(argvs, outs)]
    for out in outs:
        out.unlink(missing_ok=True)
    code = ("from repro_torch.launch.dryrun import main\n"
            f"for argv in {argvs!r}:\n    main(argv)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   stdout=subprocess.DEVNULL, env=dict(os.environ, PYTHONPATH=str(SRC)))
    return [json.loads(out.read_text().splitlines()[-1]) for out in outs]


def _plain(x):
    """Lists and tuples alike, as JSON reads them back."""
    return json.loads(json.dumps(x))


def _records(lists) -> list:
    """``trace_cost.CollectiveRecord``s from a record's collective lists
    (``key()``: kind, range, result bytes, global ranks)."""
    from repro_torch.roofline.trace_cost import CollectiveRecord
    return [CollectiveRecord(kind, name, int(nbytes), len(ranks), tuple(ranks))
            for kind, name, nbytes, ranks in lists]


def _dryrun_audit(run0: dict, t9: dict, moe: tuple, smi: str, failures: list) -> dict:
    """Phase 17 (a): phase 9's real rank-0 records classified and budgeted
    at phase 9's fold, config and shape (``analysis.audit.audit_step``):
    no finding, and the rows equal the trace's."""
    import dataclasses
    from repro_torch.analysis.audit import audit_step
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.configs.shapes import get_shape
    from repro_torch.launch.dryrun import step_config
    from repro_torch.launch.train import train_config
    t0 = time.perf_counter()
    pcfg = ParallelConfig(attn=PM(*ZERO_ATTN), moe=PM(*moe))
    cfg = step_config(train_config(MIXTRAL, layers=1), "train")
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=ZERO_SEQ, global_batch=ZERO_BATCH)
    real, found = audit_step({0: _records(run0["collectives"])}, cfg, shape, pcfg,
                             where="phase 9 rank 0")
    traced, _ = audit_step({0: _records(t9["collectives"])}, cfg, shape, pcfg,
                           where="phase 9 trace")
    rows = [r.row() for r in real]
    same = rows == [r.row() for r in traced]
    out = dict(rows=rows, findings=[str(f) for f in found], rows_equal_trace=same,
               seconds=time.perf_counter() - t0)
    for r in rows:
        _say(f"[dryrun-audit]   {r['kind']:15s} atoms={','.join(r['atoms']):6s} "
             f"fold={r['fold']:9s} x{r['count']:<3g} {r['wire_bytes'] / 2 ** 20:10.2f} MiB "
             f"[{' '.join(r['labels'])}]")
    _say(f"[dryrun-audit] (a) phase 9's real rank-0 records at attention {ZERO_ATTN} / MoE {moe}"
         f": {len(rows)} rows, {len(found)} findings, rows "
         f"{'equal to' if same else 'DIFFERENT FROM'} the trace's ({out['seconds']:.2f} s; {smi})")
    failures += [f"audit: {f}" for f in found]
    if not same:
        failures.append("audit: phase 9's real rows differ from the trace's")
    return out


def _dryrun_purity(torch, moe: tuple, smi: str, failures: list) -> dict:
    """Phase 17 (b): full-width Mixtral built on the card through the
    production init path (``init_lm(groups=)`` then ``shard_lm_params``)
    for every rank of phase 9's fold (1 layer) and of ``PURITY_PP``'s pp = 2
    fold (2 layers), reassembled on the card: bitwise the one-card init of
    the same depth (the pp = 2 fold stage by stage)."""
    from repro_torch.analysis.purity import fold_label, stored_whole, tree_bitwise_diffs
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import folded_layout
    from repro_torch.launch.train import train_config
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    zero = ParallelConfig(attn=PM(*ZERO_ATTN), moe=PM(*moe))
    pp = ParallelConfig(attn=PM(*PURITY_PP["attn"]), moe=PM(*PURITY_PP["moe"]),
                        pp=PURITY_PP["pp"])
    out, diffs = {}, {}
    for pcfg, layers in ((zero, 1), (pp, PURITY_PP["layers"])):
        cfg = train_config(MIXTRAL, layers=layers)
        one = stored_whole(cfg, None, device="cuda")
        stages = {}
        for r in range(pcfg.world_size):
            stages.setdefault(folded_layout(pcfg, rank=r, world=pcfg.world_size).pp_stage,
                              []).append(r)
        found, names = [], set()
        for _, ranks in sorted(stages.items()):
            whole = stored_whole(cfg, pcfg, device="cuda", ranks=ranks)
            names |= set(whole)
            found += tree_bitwise_diffs({n: one[n] for n in whole}, whole)
            del whole
        found += [(n, 0, float("inf")) for n in sorted(set(one) - names)]
        del one
        torch.cuda.empty_cache()
        label = f"{fold_label(pcfg)} x {layers} layer(s)"
        diffs[label] = found
        _say(f"[dryrun-purity] (b) {label}: {pcfg.world_size} ranks' stored leaves reassembled "
             f"on the card ({len(stages)} stage(s)), {len(found)} leaves differing bitwise from "
             "the one-card init")
    torch.cuda.synchronize()
    out = dict(diffs={k: [list(d) for d in v] for k, v in diffs.items()},
               seconds=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated())
    _say(f"[dryrun-purity] (b) {out['seconds']:.2f} s, peak allocated "
         f"{out['peak_bytes'] / 1e9:.2f} GB ({smi})")
    failures += [f"purity: {k}: {v[:4]}" for k, v in diffs.items() if v]
    return out


def _dryrun_whisper(tw: dict, smi: str, failures: list) -> dict:
    """Phase 17 (c): Whisper ``prefill_32k``'s production row, whose 1500
    encoder frames the port pads to split over cp·tp, traced on fake CUDA
    tensors at its world."""
    keys = ("ok", "chips", "rank", "t_trace_s", "bytes_per_device", "compute_s", "memory_s",
            "collective_s", "dominant", "mfu_bound", "n_collectives", "n_kernel_calls",
            "assumptions", "pcfg")
    out = {k: tw.get(k) for k in keys}
    _say(f"[dryrun-whisper] (c) {WHISPER} x prefill_32k x {tw['chips']} ranks, rank {tw['rank']}"
         f" ({tw['pcfg']['attn']}): ok={tw['ok']} traced in {tw['t_trace_s']:.1f} s; "
         f"mem/dev {tw['bytes_per_device'] / 2 ** 30:.2f} GiB, compute "
         f"{tw['compute_s'] * 1e3:.2f} ms, memory {tw['memory_s'] * 1e3:.2f} ms, collective "
         f"{tw['collective_s'] * 1e3:.2f} ms -> {tw['dominant']}-bound, MFU <= "
         f"{100 * tw['mfu_bound']:.1f}% at H100_SXM ({smi})")
    if not tw["ok"]:
        failures.append(f"whisper prefill_32k trace: {tw}")
    return out


def phase_dryrun(torch, one_card: dict, train_zero: dict) -> dict:
    """Phase 17: see the module docstring. Every check is printed before
    the phase fails on any of them."""
    smi = _smi()
    failures, out = [], {}
    moe = train_zero["moe"]
    t0 = time.perf_counter()
    one = ("--rank", "0", "--lists")
    t5, t9, tw = _dryrun((*DRYRUN_TRAIN, "--seq", str(TRAIN_SEQ), "--batch", "1", "--attn",
                          "1,1,1", *one),
                         (*DRYRUN_TRAIN, "--seq", str(ZERO_SEQ), "--batch", str(ZERO_BATCH),
                          "--attn", ",".join(map(str, ZERO_ATTN)),
                          "--moe", ",".join(map(str, moe)), *one),
                         DRYRUN_WHISPER)
    out["t_subprocess_s"] = time.perf_counter() - t0
    real5 = one_card
    step_s = real5["step_ms_warm_median"] / 1e3
    bound_s = max(t5["compute_s"], t5["memory_s"])
    mem5 = t5["bytes_per_device"] / real5["max_memory_allocated_bytes"] - 1
    out["phase5"] = dict(arg_bytes=t5["arg_bytes"], state_bytes=real5["state_bytes"],
                         bytes_per_device=t5["bytes_per_device"],
                         max_memory_allocated_bytes=real5["max_memory_allocated_bytes"],
                         memory_rel=mem5, compute_s=t5["compute_s"], memory_s=t5["memory_s"],
                         dominant=t5["dominant"], step_s=step_s, step_over_bound=step_s / bound_s,
                         mfu_bound=t5["mfu_bound"], mfu_measured=real5["mfu_warm"],
                         t_trace_s=t5["t_trace_s"], n_kernel_calls=t5["n_kernel_calls"],
                         assumptions=t5["assumptions"])
    _say(f"[dryrun] phase 5's step traced ({t5['t_trace_s']:.1f} s): arg_bytes "
         f"{t5['arg_bytes']} B against the run's params + optimizer state {real5['state_bytes']} "
         f"B; peak live {t5['bytes_per_device'] / 1e9:.3f} GB against max_memory_allocated "
         f"{real5['max_memory_allocated_bytes'] / 1e9:.3f} GB ({100 * mem5:+.2f}%, limit "
         f"{100 * DRYRUN_MEM_TOL:.0f}%); compute {t5['compute_s'] * 1e3:.3f} ms, memory "
         f"{t5['memory_s'] * 1e3:.3f} ms ({t5['dominant']}-bound) at H100_SXM; measured median "
         f"step {step_s * 1e3:.3f} ms = {step_s / bound_s:.3f} x the bound; MFU bound "
         f"{100 * t5['mfu_bound']:.2f}% against measured {100 * real5['mfu_warm']:.2f}% ({smi})")
    if t5["arg_bytes"] != real5["state_bytes"]:
        failures.append(f"phase 5 arg_bytes {t5['arg_bytes']} != {real5['state_bytes']}")
    if not abs(mem5) <= DRYRUN_MEM_TOL:
        failures.append(f"phase 5 peak {t5['bytes_per_device']} B vs "
                        f"{real5['max_memory_allocated_bytes']} B: {100 * mem5:+.2f}%")
    if not step_s >= bound_s:
        failures.append(f"phase 5 measured step {step_s * 1e3:.3f} ms beats the bound "
                        f"{bound_s * 1e3:.3f} ms: the count is wrong")

    run0 = next(r for r in train_zero[MIXTRAL]["ranks"] if r["rank"] == 0)["runs"]["fsdp"]
    mem9 = t9["bytes_per_device"] / run0["peak_bytes"] - 1
    same_coll = _plain(t9["collectives"]) == _plain(run0["collectives"])
    same_kern = _plain([k[:2] for k in t9["kernels"]]) == _plain(run0["kernel_calls"])
    out["phase9"] = dict(arg_bytes=t9["arg_bytes"], state_bytes=run0["arg_bytes"],
                         bytes_per_device=t9["bytes_per_device"], peak_bytes=run0["peak_bytes"],
                         memory_rel=mem9, n_collectives=len(t9["collectives"]),
                         n_collectives_real=len(run0["collectives"]), collectives_equal=same_coll,
                         kernel_calls_equal=same_kern, collective_s=t9["collective_s"],
                         collective_per_kind=t9["collective_per_kind"],
                         compute_s=t9["compute_s"], memory_s=t9["memory_s"],
                         t_trace_s=t9["t_trace_s"], step_s=run0["step_s"][0])
    _say(f"[dryrun] phase 9's fold, rank 0 (attention {ZERO_ATTN}, MoE {moe}, FSDP, ZeRO-1) "
         f"traced ({t9['t_trace_s']:.1f} s): {len(t9['collectives'])} collectives "
         f"{'equal to' if same_coll else 'DIFFERENT FROM'} the real step's "
         f"{len(run0['collectives'])} (kind, range, bytes, ranks, in order); kernel calls "
         f"{'equal' if same_kern else 'DIFFERENT'}; arg_bytes {t9['arg_bytes']} B against "
         f"{run0['arg_bytes']} B; peak live {t9['bytes_per_device'] / 1e9:.3f} GB against rank "
         f"0's {run0['peak_bytes'] / 1e9:.3f} GB ({100 * mem9:+.2f}%); collective "
         f"{t9['collective_s'] * 1e3:.3f} ms at NVLink's 450 GB/s (not this card's gloo)")
    if not same_coll:
        failures.append(f"phase 9 collectives differ: trace {_plain(t9['collectives'])[:3]}... "
                        f"real {_plain(run0['collectives'])[:3]}...")
    if not same_kern:
        failures.append("phase 9 kernel calls differ")
    if t9["arg_bytes"] != run0["arg_bytes"]:
        failures.append(f"phase 9 arg_bytes {t9['arg_bytes']} != {run0['arg_bytes']}")
    if not abs(mem9) <= DRYRUN_MEM_TOL:
        failures.append(f"phase 9 peak {t9['bytes_per_device']} B vs {run0['peak_bytes']} B: "
                        f"{100 * mem9:+.2f}%")
    out["audit"] = _dryrun_audit(run0, t9, moe, smi, failures)
    out["purity"] = _dryrun_purity(torch, moe, smi, failures)
    out["whisper_prefill_32k"] = _dryrun_whisper(tw, smi, failures)
    out["wall_s"] = time.perf_counter() - t0
    if failures:
        raise AssertionError("phase 17:\n" + "\n".join(failures))
    return out


# Phase 18: K/V replicated over TP. Qwen2-VL-7B's 28 query and 4 K/V heads
# at attention TP 8, which does not divide the K/V heads: every TP rank
# holds q and K/V at all heads (``attention.kv_replicated``). No registry
# model reaches it at TP <= 4 (every K/V head count is a multiple of 4), so
# it needs a world of 8 processes sharing the card, opened after the pool
# of 4 is closed. Phase 15's depths, batch, requests and seed.
REPLICATED = dict(attn=(1, 1, 8), moe=(1, 1, 8))


def _replicated_serve(arch: str, blocks: dict, smi: str, failures: list) -> dict:
    """(a) Phase 15's paged Engine (4 layers, bf16, seed 0, its two requests)
    at attention TP 8: prefill logits within ``CHECK_TOL`` (relative) of
    phase 15's one-card Engine; greedy tokens equal to its, up to a step
    where the one-card choice was a near tie (its top-1/top-2 margin at
    most twice the largest prefill logit gap between the two runs: bf16
    sums taken in another order over TP then choose otherwise, and the
    requests part from there on, as phase 13 allows); launches 1 flash a
    layer a forward; each rank's KV pool and a request's KV bytes beside one
    card's: every rank holds all K/V heads."""
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import folded_layout
    from repro_torch.launch.serve import slice_config
    from repro_torch.launch.world import serve_world
    from repro_torch.serve.cache import kv_bytes_dense
    one = blocks[arch]["serve"]["runs"]["paged"]
    one_logits, margins = one.pop("logits"), one.pop("margins")
    t0 = time.perf_counter()
    ranks, = serve_world(dict(arch=arch, **REPLICATED, layers=BLOCKS_SERVE["layers"],
                              engine=dict(cache="paged", s_max=BLOCKS_SERVE["s_max"],
                                          **BLOCKS_ENGINE),
                              prompt_lens=BLOCKS_SERVE["prompts"],
                              new_tokens=BLOCKS_SERVE["new"], seed=0, keep_logits=True),
                         device="cuda", timeout_s=900)
    wall = time.perf_counter() - t0
    cfg = slice_config(arch, layers=BLOCKS_SERVE["layers"])
    pcfg = ParallelConfig(attn=PM(*REPLICATED["attn"]), moe=PM(*REPLICATED["moe"]))
    kv_one = kv_bytes_dense(cfg, 1, BLOCKS_SERVE["s_max"])
    out = dict(model=f"{cfg.name} x{cfg.n_layers} layers (full width), bf16, heads "
                     f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}",
               attn=REPLICATED["attn"], wall_s=wall, kv_bytes_request_one_card=kv_one,
               ranks=[])
    for r in ranks:
        n_fwd = sum(1 for p, _ in r["forwards"] if p) + sum(1 for _, d in r["forwards"] if d)
        expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": cfg.n_layers * n_fwd}
        fg = folded_layout(pcfg, rank=r["rank"], world=pcfg.world_size)
        kv = kv_bytes_dense(cfg, 1, BLOCKS_SERVE["s_max"], groups=fg)
        errs = [_rel_max(_as_f64(g["logits"]), _as_f64(w))
                for g, w in zip(r["results"], one_logits)]
        gap = max(float(abs(_as_f64(g["logits"]) - _as_f64(w)).max())
                  for g, w in zip(r["results"], one_logits))
        tokens = [g["tokens"] for g in r["results"]]
        parted = []                 # (request, first step that differs, its one-card margin)
        for i, (t, w) in enumerate(zip(tokens, one["tokens"])):
            j = next((k for k, (a, b) in enumerate(zip(t, w)) if a != b), None)
            if j is not None:
                parted.append((i, j, margins[i][j]))
        rec = dict(rank=r["rank"], launches=r["launches"], expected=expect, forwards=n_fwd,
                   tokens_equal=tokens == one["tokens"], parted=parted,
                   prefill_logit_gap=gap, logits_rel_err=errs,
                   kv_bytes_request=kv, cache_bytes=r["cache_bytes"], peak_gb=r["peak_gb"],
                   init_s=r["init_s"], wall_s=r["wall_s"])
        out["ranks"].append(rec)
        if r["launches"] != expect:
            failures.append(f"replicated serve rank {r['rank']}: launches {r['launches']} != "
                            f"{expect}")
        for i, j, m in parted:
            if not m <= 2 * gap:
                failures.append(f"replicated serve rank {r['rank']} request {i}: token {j} "
                                f"{tokens[i][j]} != one card's {one['tokens'][i][j]}, whose "
                                f"margin {m:.4f} exceeds twice the prefill logit gap {gap:.4f}")
        if not max(errs) <= CHECK_TOL:
            failures.append(f"replicated serve rank {r['rank']}: prefill logits rel err {errs} "
                            f"> {CHECK_TOL}")
        if kv != kv_one:
            failures.append(f"replicated serve rank {r['rank']}: {kv} K/V bytes a request, one "
                            f"card {kv_one}")
    r0 = out["ranks"][0]
    _say(f"[replicated serve] {out['model']} at attention (dp, cp, tp) {REPLICATED['attn']}: "
         f"{len(ranks)} ranks over gloo through the host on one card ({smi}); every rank holds "
         f"all {cfg.n_kv_heads} K/V heads and attends at all {cfg.n_heads}; {r0['forwards']} "
         "forwards; tokens equal to phase 15's one-card Engine on ranks "
         f"{[x['rank'] for x in out['ranks'] if x['tokens_equal']]}, parted (request, step, "
         f"one-card margin) {r0['parted']} against twice the prefill logit gap "
         f"{2 * r0['prefill_logit_gap']:.4f}; one-card margins at each step " + "; ".join(
             " ".join(f"{m:.3f}" for m in ms) for ms in margins) + "; prefill logits rel err "
         "(worst a rank) " + ", ".join(f"{max(x['logits_rel_err']):.3e}" for x in out["ranks"])
         + f" (limit {CHECK_TOL}); launches a rank {r0['launches']} (expected {r0['expected']}); "
         f"K/V bytes a request a rank {r0['kv_bytes_request'] / 1e6:.2f} MB (one card "
         f"{kv_one / 1e6:.2f} MB), KV pool a rank " + ", ".join(
             f"{x['cache_bytes'] / 1e6:.1f}" for x in out["ranks"]) + " MB; peak memory a rank "
         + ", ".join(f"{x['peak_gb']:.2f}" for x in out["ranks"]) + " GB; serving wall a rank "
         + ", ".join(f"{x['wall_s']:.2f}" for x in out["ranks"]) + f" s; world wall {wall:.1f} s")
    return out


def _replicated_train(arch: str, blocks: dict, smi: str, failures: list) -> dict:
    """(b) One training step of phase 15's (2 layers, one 4096-token
    sequence, its batch and seed) at attention TP 8: loss and ``grad_norm``
    within ``FOLD_TOL`` of phase 15's one-card step 0, launches 2 flash a
    layer (forward, remat's recompute)."""
    from repro_torch.launch.train import train_config
    from repro_torch.launch.world import Run, train_world
    cfg = train_config(arch, layers=BLOCKS_TRAIN["layers"][arch])
    batches = _blocks_batches(cfg, BLOCKS_TRAIN["seq"], BLOCKS_TRAIN["batch"], 1)
    t0 = time.perf_counter()
    ranks = train_world(arch, **REPLICATED, runs=[Run("allgather", 1)], device="cuda",
                        layers=BLOCKS_TRAIN["layers"][arch], seq=BLOCKS_TRAIN["seq"],
                        batch=BLOCKS_TRAIN["batch"], seed=0, batches=batches, timeout_s=900)
    wall = time.perf_counter() - t0
    ref = blocks[arch]["train"]["steps"][0]
    expect = {"gmm": 0, "gmm_trans_w": 0, "flash_attention": 2 * _flash_layers(cfg)}
    out = dict(attn=REPLICATED["attn"], wall_s=wall, one_card=dict(loss=ref["loss"],
                                                                   grad_norm=ref["grad_norm"]),
               ranks=[])
    for r in ranks:
        run = r["runs"]["allgather"]
        m = run["metrics"][0]
        errs = {k: abs(m[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
        out["ranks"].append(dict(rank=r["rank"], loss=m["loss"], grad_norm=m["grad_norm"],
                                 rel_err=errs, launches=run["launches"], peak_gb=run["peak_gb"],
                                 step_s=run["step_s"], init_s=r["init_s"]))
        if not (m["step_ok"] and max(errs.values()) <= FOLD_TOL):
            failures.append(f"replicated train rank {r['rank']}: loss {m['loss']!r}, grad_norm "
                            f"{m['grad_norm']!r} against one card's {ref['loss']!r}, "
                            f"{ref['grad_norm']!r}: rel err {errs} (limit {FOLD_TOL})")
        if run["launches"] != expect:
            failures.append(f"replicated train rank {r['rank']}: launches {run['launches']} != "
                            f"{expect}")
    r0 = out["ranks"][0]
    _say(f"[replicated train] {cfg.name} x{cfg.n_layers} layers (full width), "
         f"{BLOCKS_TRAIN['batch']} x {BLOCKS_TRAIN['seq']} tokens, at attention (dp, cp, tp) "
         f"{REPLICATED['attn']} over {cfg.n_kv_heads} K/V heads: {len(ranks)} ranks over gloo "
         f"through the host on one card ({smi}); step 0 loss {r0['loss']:.6f} (one card "
         f"{ref['loss']:.6f}), grad_norm {r0['grad_norm']:.6f} (one card {ref['grad_norm']:.6f})"
         "; worst rel err a rank " + ", ".join(f"{max(x['rel_err'].values()):.3e}"
                                               for x in out["ranks"])
         + f" (limit {FOLD_TOL}); launches a rank {r0['launches']} (expected {expect}); peak "
         "memory a rank " + ", ".join(f"{x['peak_gb']:.2f}" for x in out["ranks"])
         + " GB; step wall a rank " + ", ".join(f"{1e3 * x['step_s'][0]:.1f}"
                                               for x in out["ranks"])
         + f" ms; weights built in turns in {r0['init_s']:.1f} s; world wall {wall:.1f} s")
    return out


def phase_replicated_kv(torch, blocks: dict) -> dict:
    """Phase 18: see the module docstring. One world of 8 processes for both
    parts; every check is printed before the phase fails on any of them."""
    from repro_torch.launch.world import pool
    smi, failures = _smi(), []
    with pool(8, backend="gloo", device="cuda", timeout_s=900):
        serve = _replicated_serve(QWEN2VL, blocks, smi, failures)
        train = _replicated_train(QWEN2VL, blocks, smi, failures)
    if failures:
        raise AssertionError("phase 18:\n" + "\n".join(failures))
    return dict(serve=serve, train=train)


def _replicated_line(replicated: dict, blocks: dict, sources: dict) -> list:
    """Phase 18's entries of the kernels line: flash on its serving and
    training paths (``replicated-kv-serve``, ``replicated-kv-train``) with
    rank 0's launches, timed at phase 15's rows of the same shapes (all
    heads on every TP rank: the one card's shapes)."""
    def case(label):
        return next(c for c in blocks["kernels"][QWEN2VL]["flash_attention"]
                    if c["case"] == label)
    return [_entry("flash_attention", "replicated-kv-serve" + SHORT[QWEN2VL], QWEN2VL,
                   case("decode, 1024 keys, normalized"),
                   replicated["serve"]["ranks"][0]["launches"]["flash_attention"], sources),
            _entry("flash_attention", "replicated-kv-train" + SHORT[QWEN2VL], QWEN2VL,
                   case("causal self-attention 4096, partial"),
                   replicated["train"]["ranks"][0]["launches"]["flash_attention"], sources)]


def _as_f64(x):
    """A logits row as a float64 numpy array."""
    import numpy as np
    return np.asarray(x, dtype=np.float64)


def _rel_max(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    import numpy as np
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _free(torch, label: str) -> dict:
    """Release every cached block; the reserved memory before and after."""
    before = torch.cuda.memory_reserved() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved() / 1e9
    _say(f"[memory] {label}: reserved {before:.2f} GB -> {after:.2f} GB "
         f"(allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    return {"reserved_gb_before": before, "reserved_gb_after": after}


ORDER = {MIXTRAL: (phase_kernels, phase_serve, phase_train),
         QWEN2: (phase_serve, phase_train, phase_kernels)}


def run_model(torch, arch: str) -> dict:
    """One model's phases in its ``ORDER``, then the checks."""
    out = {}
    for phase in ORDER[arch]:
        out[phase.__name__[len("phase_"):]] = phase(torch, arch)
    out["check"] = phase_check(torch, arch)
    out["check_train"] = phase_train_check(torch, arch)
    if arch == QWEN2:
        out["check_moe"] = phase_moe_check(torch, arch)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.world import pool
    t_start = time.perf_counter()
    marks = [("start", t_start)]

    def mark(label: str) -> None:
        now = time.perf_counter()
        _say(f"[time] {label}: {now - marks[-1][1]:.1f} s (script at {now - t_start:.1f} s)")
        marks.append((label, now))
    phase_device(torch)
    build = phase_build()
    mark("phases 1-2")
    # One world of 4 ranks for every phase across ranks (9, 12, 10, 11, 7, 8,
    # 13): each rank starts once, not once a world.
    with pool(4, backend="gloo", device="cuda", timeout_s=1200):
        mark("world of 4 started")
        train_zero = phase_train_zero(torch)          # first: see the module docstring
        mark("phase 9")
        memory_zero = _free(torch, "phase 9 done, before phase 12")
        train_handoff = phase_train_handoff(torch)
        mark("phase 12")
        memory_handoff = _free(torch, "phase 12 done, before phase 10")
        train_pipe = phase_train_pipe(torch)
        mark("phase 10")
        memory_pipe = _free(torch, "phase 10 done")
        train_resume = phase_train_resume(torch, train_zero)
        mark("phase 11")
        memory_resume = _free(torch, "phase 11 done")
        results = {MIXTRAL: run_model(torch, MIXTRAL)}
        mark("Mixtral phases 3-6")
        memory = _free(torch, "Mixtral-8x22B freed")
        results[QWEN2] = run_model(torch, QWEN2)
        mark("Qwen2 phases 3-6")
        memory_configs = _free(torch, "Qwen2-57B-A14B freed")
        config_kernels = phase_config_kernels(torch)
        train_configs = phase_train_configs(torch)
        mark("train-configs")
        memory_world = _free(torch, "train-configs done")
        world = phase_world(torch)
        mark("phase 7")
        train_world = phase_train_world(torch, {arch: res["train"]
                                                for arch, res in results.items()})
        mark("phase 8")
        memory_serve_world = _free(torch, "phase 8 done, before phase 13")
        serve_world = phase_serve_world(torch, {arch: res["serve"].pop("reference")
                                                for arch, res in results.items()})
        mark("phase 13")
    memory_window = _free(torch, "phase 13 done, before phase 14")
    window = phase_window_dense(torch)
    mark("phase 14")
    memory_blocks = _free(torch, "phase 14 done, before phase 15")
    blocks = phase_blocks(torch)
    mark("phase 15")
    memory_recurrent = _free(torch, "phase 15 done, before phase 16")
    recurrent = phase_recurrent(torch)
    serve_world["recurrent_against_one_card"] = _recurrent_world_check(serve_world, recurrent)
    mark("phase 16")
    memory_dryrun = _free(torch, "phase 16 done, before phase 17")
    dryrun = phase_dryrun(torch, results[MIXTRAL]["train"], train_zero)
    mark("phase 17")
    memory_replicated = _free(torch, "phase 17 done, before phase 18")
    replicated = phase_replicated_kv(torch, blocks)
    mark("phase 18")
    seconds = time.perf_counter() - t_start

    gmm_src = ("src/repro_torch/kernels/csrc/gmm.cu", "src/repro/kernels/gmm/gmm.py:73")
    sources = {"gmm": gmm_src, "gmm_trans_w": gmm_src,
               "flash_attention": ("src/repro_torch/kernels/csrc/flash.cu",
                                   "src/repro/kernels/flash/flash.py:150")}
    line = []
    for arch, res in results.items():
        M = _gmm_specs(arch)[1][-1][1]                  # the training step's GMM rows
        for (name, path), label in HEADLINE.items():
            label = label.format(M=M)
            c = next(x for x in res["kernels"][name] if x["case"] == label)
            line.append(_entry(name, path + SHORT[arch], arch, c, res[path]["launches"][name],
                               sources))
        line += [_entry(name, "moe-world" + SHORT[arch], arch, world[arch]["kernels"][name][0],
                        world[arch]["launches"][name], sources)
                 for name in ("gmm", "gmm_trans_w")]
    line += _train_world_line(train_world, sources)
    line += _train_zero_line(train_zero, sources)
    line += _train_pipe_line(train_pipe, sources)
    line += _train_resume_line(train_resume, train_zero, sources)
    line += _train_configs_line(config_kernels, train_configs, sources)
    line += _train_handoff_line(train_handoff, sources)
    line += _serve_world_line(serve_world, sources)
    line += _window_dense_line(window, sources)
    line += _blocks_line(blocks, sources)
    line += _recurrent_line(recurrent, sources)
    line += _replicated_line(replicated, blocks, sources)
    c = next(x for x in results[MIXTRAL]["kernels"]["gmm"]
             if x["case"] == f"gate/up, decode bm={SMALL_BM[1]}")
    line.append(_entry("gmm", "moe-check-bm16" + SHORT[QWEN2], QWEN2, c,
                       results[QWEN2]["check_moe"]["block_m_16"]["launches"]["gmm"], sources))
    smi = _smi()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, device=device, timing=TIMING, build=build, models=results,
        world=world, train_world=train_world, train_zero=train_zero, train_pipe=train_pipe,
        train_resume=train_resume, train_handoff=train_handoff, serve_world=serve_world,
        window_dense=window, memory_before_window_dense=memory_window,
        blocks=blocks, memory_before_blocks=memory_blocks,
        recurrent=recurrent, memory_before_recurrent=memory_recurrent, dryrun=dryrun,
        memory_before_dryrun=memory_dryrun, replicated_kv=replicated,
        memory_before_replicated_kv=memory_replicated,
        config_kernels=config_kernels,
        train_configs=train_configs, memory_after_train_zero=memory_zero,
        memory_after_train_handoff=memory_handoff,
        memory_after_train_pipe=memory_pipe, memory_after_train_resume=memory_resume,
        memory_between_models=memory, memory_before_train_configs=memory_configs,
        memory_before_world=memory_world, memory_before_serve_world=memory_serve_world,
        phase_s={a: t - s0 for (_, s0), (a, t) in zip(marks, marks[1:])},
        seconds=seconds), indent=1))
    _say(f"[done] script time {seconds:.2f} s (build {build['seconds']:.2f} s)")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
