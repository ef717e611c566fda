"""Chip smoke test: build the port's Hopper kernels and drive the port on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):

1. Build the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   in parallel), with each kernel's ptxas register and spill counts by its
   entry name; print the card and its power limit; turn TF32 off.
2. Hold each kernel (each EW op) against its plain PyTorch version on the
   card, in float32 and bfloat16, at ragged shapes and at the shapes of
   phase 3.  EW*, 1DCONV: bit-exact.  MMM, MVM, SMMM: normwise relative
   error, see ``TOL``.  VDP: bit-exact on integer vectors whose sum every
   order gets exactly, and relative error (``VDP_TOL``) on vectors of mean
   1.  JS (``check_js``, x ≠ 0): normwise against the exact sweep in
   float64 (``TOL``), and against the plain version within ``TOL`` plus the
   plain version's own error; and 30 sweeps of ``jacobi_solve`` on the
   phase-3 system must reach ‖Ax − b‖/‖b‖ ≤ ``JS_RESIDUAL`` in float64.
   SMMM's pad slots hold 7.0 and one block row has only pad slots (its
   output rows must be exactly 0); its tensor-core kernel, in three types,
   also against its plain model ``smmm_tf32x3_ref`` (``SMMM_MODEL_TOL``)
   and, in float32, a float64 product (``SMMM_F64_TOL``), at (bm, bk) off
   64 and 32, N = 1 and an index row of 1100 slots, two calls
   bit-identical, and with ±inf and NaN in kept blocks and in B against
   ``smmm_bell_ref``.  MMM's skinny route: every M up to
   SKINNY_M_MAX at danube's five decode projections, ragged and unaligned
   cases, against ``mmm_ref`` and the split-K plain version (``TOL``), and
   two calls bit-identical.  MMM's tensor-core route, bfloat16 and float16:
   danube's eight prefill projections (512 and 4200 rows), ragged M, N and
   K, 4096³, and operands TMA cannot load as they lie (K or N off a
   multiple of 8, odd N, A or B off the 16-byte grid: packed first),
   against ``mmm_ref`` (``TOL``) and element by element within half an
   output ulp of a float32 product of the same inputs
   (``mmm_ulp_excess``); two calls bit-identical.  MMM's 3×TF32 route,
   float32: 4096³, the float32 replay's four 512-row prefill shapes, ragged
   M, N and K, every K and N in {1, 3, 5, 4094, 4095}, M = 65, the lone
   request's 4096×4094 @ 4094×4096 and operands off the 16-byte grid,
   against ``mmm_ref``, a float64 product and its plain model
   ``mmm_tf32x3_ref`` (``TOL``), its error against float64 printed beside
   ``torch.matmul``'s; ±inf, NaN and ±FLT_MAX inputs at an off-grid shape
   against ``mmm_ref``; two calls bit-identical.  FFT: normwise within ``FFT_TOL`` against
   ``torch.fft.fft`` in float64 and against its plain version, in three
   types: the radix route at every n = 2^j ≤ 4096, the chirp route at
   n = 3, 7, 100, 1000, 2999, DFT_N, 4093 and 4095, each at 1, 3 and 2048
   rows and 1-D, and an x off the 16-byte grid; two calls bit-identical.
   SORT: bit-exact, and NaN last on rows that hold NaN, ±inf and ±0;
   the radix route also on rows that skip passes (16-bit types, a
   constant row, integers 0–15) and on negative-only rows, bit-exact
   with its plain model and, where both take the row, the tile route.
   SORT's tile route under its launch plan (``sort_tile_plan``): 3 rows at
   every power of two from 1 to 8192 and one ragged length below each,
   shapes with several rows a block, rows off the 16-byte grid, NaN of
   both signs with ±inf and ±0, duplicates; bit-exact with the plain
   version (±0 by value) and with the plan's model ``sort_tile_ref``, two
   calls bit-identical.  EW* at the edges of its plan (``ewise_plan``:
   n = 1, one vector ± 1, one block's vectors ± 1 at 1 and 4 vectors a
   thread, a block for every SM ± 1, 8192² + 3) and off the 16-byte grid,
   every op, bit-exact with the plain version and the plan's model
   ``ewise_plan_ref``.
   HIST: bit-exact, on bin edges, range ends, NaN and ±inf, at several
   bin counts, and with every value in one bin.
   RMSNORM and FLASH_ATTN: normwise (``TOL``) at the model path's shapes
   in three types (RMSNORM at 1, 4, 512, 4096 and 4200 rows of d_model,
   two calls bit-identical, and at (3, 80) and (7, 1000)), FLASH_ATTN
   under four masks (causal, window, prefix with window, Sq < Skv): the
   mma route in bfloat16 and float16 (also against its plain model); the
   wgmma route (``phase2_fa_wgmma``) in both at gemma3-4b's widths (8
   heads of 256 on 4 KV heads) under the same masks, also against its
   plain model ``attention_mma_ref``, two calls bit-identical, at the served
   leg's 2048 tokens with window 1024, over a row of 8192 keys, at
   paligemma-3b's prefill (2×8 heads on 1 KV head, 512 rows, causal with
   a bidirectional prefix of 256 keys), on operands
   off the 16-byte grid and as a new host thread's first launch; the
   3×TF32 route in float32 (``phase2_fa_tf32x3``) also against its plain
   model ``attention_tf32x3_ref`` (``FA_TF32_MODEL_TOL``) and float64
   (``FA_TF32_F64_TOL``), two calls bit-identical, at head dims 32, 128 and
   256, over a row of 8192 keys, and with ±inf and NaN in kept key rows
   and a query row (the same non-finite outputs as the model and the plain
   version).
   The fused chain kernel: bit-exact against its plain version
   and against serial EW launches, in float32, bfloat16 and float16, on
   every op, copy, "acc" as the second operand, an input read twice and a
   chain at the caps, at ragged, prime and misaligned sizes.
   SSD (no kernel: the reference has no Pallas SSD): its aten row (the
   chunked form) against its torch row (the scan) at zamba2's widths, 2048
   and 515 tokens, in float32 and bfloat16 (``TOL``, the float32 state
   within ``SSD_STATE_TOL``), and SSD_DECODE fed every step against the
   scan.  The zamba2 leg's kernels at its shapes (``phase2_hybrid``):
   MMM at every projection on the wgmma (512 and 2048 rows) and skinny (2
   rows) routes, two calls bit-identical; RMSNORM at d_model 2048 and the
   gated norm's 4096; FLASH_ATTN's mma route at 32 heads of 64, causal.
   MoE and MLA (``phase2_moe_mla``; MOE_FFN has no Pallas site, so no
   kernel): MOE_FFN's aten row against its torch row at moonshot's prefill
   and decode capacities, (64, 244, 2048) and (64, 4, 2048) bfloat16;
   ``moe_layer`` at moonshot's widths on the kernels against the layer's
   definition in float64 (``moe_definition``: its own routing, capacity
   drops and every shared expert) at 4 and 256 tokens; the capacity
   dispatch on the card bit-identical to the CPU's for a router that
   overflows two experts; FLASH_ATTN at MLA's head dim 192 (1×128×2048×192
   bfloat16, padded to 256 on the wgmma route; float32 on tf32x3) and at
   48 (mma, tf32x3) against ``attention_ref`` at the real dim.
3. The slice end to end: ``repro_torch.quickstart.run`` on ``cuda`` with
   every claim pinned to the hopper records, blocking and asynchronous, at
   working sets inside the paper's 48 MB–1 GB.  Every kernel's launch count
   must rise by exactly the requests sent to it (MMM at 4096³ float32 on
   the 3×TF32 route, FFT at n = 4096 and SORT at 2^24 on their radix
   routes), the scheduler's quarantine must stay empty, and every output
   must match its plain version.  Three more requests, each counted alone,
   drive the other routes: FFT of 2048 rows of DFT_N (the chirp route),
   SORT of 4096 rows of 4096 (the tile route) and MMM 4096×4094 @
   4094×4096 float32 (the 3×TF32 route, its split pass padding K = 4094,
   which TMA cannot stride, to 4096).  Then
   the template is timed end to end (median of 5 runs, T1 per call), and
   ``repro_torch.portability_demo`` runs on the card (``portability_leg``:
   the torch, aten and hopper policies' picks, one ``mmm_tf32x3`` launch a
   hopper call, each result within ``TOL`` of ``mmm_ref``, the attached
   agent served, the fail-safe engaged; T3, Φ and the penalty printed).
3b. The model path: h2o-danube-1.8b at full width (random bfloat16 weights
   from a seed) served through ``repro_torch.launch.serve.run_requests``
   on a SlotEngine/StepScheduler: 8 requests on 4 slots, prompts of 512
   and 4200 tokens (past the 4096 window), greedy, mixed budgets up to 16.
   The launch counts must follow the model's structure (MMM 7·L+1 and
   RMSNORM 2·L+1 per forward pass, FLASH_ATTN L per prefill on the
   tensor-core route; a prefill's
   7·L projections on MMM's tensor-core route, its one-row unembed and
   every decode pass's MMMs on the skinny route),
   the quarantine must stay
   empty, and every step's logits must agree with a replay through the
   plain versions on the card (``SERVE_TOL``).  The same weights widened
   to float32 replay one request on the kernels against the plain versions
   (``F32_SERVE_TOL``); its prefill, counted alone, drives FLASH_ATTN's
   3×TF32 route (L launches) and MMM's 3×TF32 route (7·L launches).
   Prefill MMM device time comes from a profiled rerun.  The decode step is
   split into MMM device time per pass and dispatches per pass × T1.
   Then the same model, weights and requests on a PagedEngine
   (``SERVE_PAGED``: 4 slots, 16-token blocks, every cache a ring of 4096,
   ``phase3b_paged``): (a) whole-prompt admission — the dense leg's tokens
   and launch counts, and every recorded logit bit for bit; (b) chunked
   prefill of 256 tokens with requests 5 and 7 beginning with request 1's
   first 448 tokens — exactly 56 prefix hits and no eviction, every block
   back at drain, launch counts by the chunks' rows (no FLASH_ATTN in a
   chunk), each request's end-of-prefill and teacher-forced decode logits
   within ``SERVE_TOL`` of a dense one-lane replay on the kernels; one
   decode step's gather and scatter by device time beside the bytes.
   A second leg (``SERVE_D256``) serves gemma3-4b at its published widths,
   cut to one 5:1 pattern (5 local layers of window 1024, 1 global), 4
   requests of 512 and 2048 tokens on 2 slots, 8 tokens each: every
   prefill's attention takes FLASH_ATTN's wgmma route (head dim 256, one
   launch a layer, no other FLASH_ATTN route), and one 2048-token
   request's logits agree with the plain replay (``SERVE_TOL``);
   FLASH_ATTN's device time from a profiled rerun; that request again
   through ``Model.prefill_chunk`` at ``D256_CHUNK`` tokens a chunk (the
   local layers' ring chunk attention, the global layer's full-length
   one), its last logits within ``SERVE_TOL`` of the whole prefill.  A third leg
   (``SERVE_HYBRID``) serves zamba2-1.2b at its published widths and full
   depth (38 Mamba-2 layers and a shared attention block invoked 6 times),
   4 requests of 512 and 2048 tokens on 2 slots, 8 tokens each: launch
   counts by the model's structure (FLASH_ATTN's mma route 6 a prefill),
   SSD 38 a prefill and SSD_DECODE 38 a decode pass on their aten rows
   (``counting_registry``), the 2048-token request's logits at every
   step against the plain replay (``SERVE_HYBRID_TOL`` at full depth,
   ``SERVE_TOL`` with the first pattern of 7 blocks kept) and, in float32,
   kernels against plain (``F32_SERVE_TOL``); tokens/s, prefill and
   decode-step ms, device time by kernel and the SSD rows' device time.
   ``tools/zamba2_gap.py`` studies where the bfloat16 gap comes from.
   A fourth leg (``SERVE_MOE``) serves moonshot-v1-16b-a3b at its
   published widths and full depth (layer 0 dense, 47 MoE layers of 64
   experts top 6 and 2 shared), 8 requests of 512 and 2048 tokens on 4
   slots, 8 tokens each; a fifth (``SERVE_MLA``) deepseek-v2-236b at its
   published widths, cut to layer 0 and 3 MoE layers, 4 requests on 2
   slots: MLA's prefill attention on FLASH_ATTN's wgmma route (head dim
   192 padded to 256).  Each (``phase3b_moe_leg``): launch counts by the
   model's structure (``moe_leg_structure``), MOE_FFN one dispatch a MoE
   layer a pass on its aten row, none of FLASH_ATTN on aten; then, from
   each block's input captured in the served run (``BlockCapture``) for
   the 2048-token request's prefill and decode steps, the block on the
   kernels and on the plain versions with the kernel block's expert
   indices forced (``routing_tap``): (a) router probabilities within
   ``ROUTER_PROB_TOL``, (b) a top-k set that differs from the plain
   router's own only at a plain margin within ``FLIP_MARGIN`` × the call's
   largest probability difference, (c) the block's output less its input
   within ``MOE_BLOCK_TOL``, a control (MMM's plain version summed in
   another order) beside; MLA's absorbed decode against a prefill through
   the same position (``MLA_DECODE_TOL``) and MLA's multi-token cache step
   (a ``MLA_CHUNK``-token chunk after the prompt) against a prefill over
   prompt + chunk (``MLA_DECODE_TOL``); the whole model's gap with
   routing forced and free, printed; tokens/s, prefill and decode-step
   ms, peak memory, device time by kernel, MOE_FFN's device ms a call and
   its share, one decode step's device time beside the expert weights'
   bytes over 3.35 TB/s.  moonshot's first 4 layers in float32, kernels
   against plain with routing forced (``F32_SERVE_TOL``).  Last, the stub
   frontends at their published widths and full depth (``frontend_leg``):
   paligemma-3b (``SERVE_PALIGEMMA``, 3.036 B parameters) through
   ``ServeEngine.generate``'s lockstep path, 2 rows of 256 seeded patch
   embeddings + 256 tokens, 16 tokens each; musicgen-large
   (``SERVE_MUSICGEN``, 2.425 B) at the model level, a prefill over 2 × 512
   seeded frame embeddings and 8 decode steps fed frame embeddings (the
   lockstep path refuses ``frame_embed``): launch counts by structure (the
   prefill's FLASH_ATTN on the wgmma route at paligemma's head dim 256, on
   mma at musicgen's 64; none on aten), an empty quarantine, every step's
   logits within ``SERVE_TOL`` of a plain replay (teacher-forced); prefill
   and decode-step ms, peak memory, paligemma's tokens/s.
   Every engine of these legs captures its decode step once into a CUDA
   graph and replays it (``serve/step_graph.py``): each leg checks its
   engine's steps (``check_captured``: the first eager, the second
   captured, the rest replayed; a MoE leg's tapped steps eager), counts
   launches at every step (replays credited) and dispatches at the
   dispatched passes only, and prints them; the profiled reruns fail where
   torch.profiler missed replayed kernels (``profiler_coverage``); on every
   leg one step alone is timed captured against eager (``lone_decode``:
   host ms, device ms, busy share, the capturing step's ms, graph pool GB).
3m. The captured decode step against the eager body (``phase3m``, after
   3b; ``DECODE_GRAPH``): danube at full width, dense and paged, 6
   requests on 4 slots as lanes join and leave; before each step a twin
   engine's caches take a copy of the engine's and the twin runs the eager
   body: logits and every cache leaf ``torch.equal`` at every step; one
   step alone captured against eager (host ms, device ms, busy share,
   capture ms, graph pool GB) beside the card's name and power limit;
   launches with replays credited by structure.
3c. Execution graphs, fusion and compiled replay: ``halo.graph(launch=False)``
   → ``compile()`` → 20 ``replay()`` calls per workload, every other one
   rebinding an input, each output bit-identical to serial blocking
   dispatch of the same members: an EW chain EWMM → EWADD → EWSUB → EWMD
   over 8192² float32 and bfloat16 (one launch of the chain kernel per
   replay); a decode
   chain MVM → EWADD → RMSNORM × 24 layers at danube's d_model 2560 in
   bfloat16, one fused call loop; 30 Jacobi sweeps on the phase-3 system,
   fused, in the same graph as the EW chain.  Compile stats, launch counts
   per replay, an empty quarantine, no re-scored placement in steady state
   and a compile-cache hit are checked; then each workload is timed three
   ways (serial, fresh capture + launch, compiled replay; median of 5).
3e. Collectives (``phase3e``, run after 3c; its tensors are freed before
   3d): the paper's collective Jacobi (``repro_torch.collective_jacobi``)
   on ``halo.initialize()``'s card session, an n = 16384 float32 system
   (A 1.07 GB), 30 sweeps, over two device groups (``COLLECTIVE``): (a)
   four ranks on ``hopper``, (b) the heterogeneous ``hopper`` + ``aten``
   pair; each run serial (one agent pinned to ``hopper``), with blocking
   collective verbs (eager) and as one captured graph.  First MVM, VDP
   and EW* against their plain versions at the shapes the path gives
   them (the whole system, each group's row shards, the 0-d combines) on
   this problem's data; serial hopper and serial aten within
   ``COLLECTIVE_B_TOL`` of serial on the plain ``torch`` rows.  Launches
   of mvm, vdp and ewise by the runs' structure; (a)'s iterate
   bit-identical to serial hopper (its residual within rtol 1e-5: VDP's
   partials bracket apart), graph bit-identical to eager in both groups
   (iterate and residual), (b)'s iterate within ``COLLECTIVE_B_TOL`` of
   serial hopper; every graph node placed, every allreduce combine on a
   member of its group; the solve error ‖Ax − b‖/‖b‖ falling over 1, 2
   and 3 sweeps and within ``COLLECTIVE_SOLVE_TOL`` after 30; an empty
   quarantine.  T3 (median of 5 solves)
   and Φ against serial hopper for serial hopper, serial aten and each
   group's eager and graph runs, with each solve's device ms (torch.profiler)
   and busy share.
3g. Resilience (``phase3g``, after 3e; DESIGN.md §11; ``RESILIENCE``):
   every leg on a fresh card session whose health monitor is started
   (sweeps every 0.02 s), every check a ``fail()``: (a) 3e's n = 16384
   system over ``["hopper", "aten"]``, eager and with one captured graph a
   sweep, the aten member wedged (``FaultPlan(mode="die")``) a few sweeps
   in: DEAD within 1 s, ``handle_dead_agent`` re-binds its rank onto hopper
   (size 2, the epoch moved) and replays the wedged call, every later
   sweep's MVM, VDP and EW* on hopper; the iterate within
   ``COLLECTIVE_B_TOL`` of serial hopper, the solve error within
   ``COLLECTIVE_SOLVE_TOL``, the elements differing from a fault-free group
   run printed; (b) one MMM at danube's gate shape (512×2560 @ 2560×6912
   bf16) over ``["aten", "hopper"]``, aten hung: the speculative backup on
   hopper (``mmm_wgmma``, one launch) wins, ``torch.equal`` to a direct
   hopper dispatch, and the late aten result leaves the node's result and
   ready event the backup's; (c) 3c's EW chain over ``["hopper",
   "torch"]``, compiled on the chain kernel (B13, which has no torch row),
   the fused call hung: ``"decomposed+spec"``, the member chain placed off
   hopper wins on the torch rows while the fused call still hangs, the
   output ``torch.equal`` to serial dispatch on those rows (and compared
   with serial hopper), the late fused launch discarded; (d) phase 3b's danube at
   full width (random weights from ``SERVE["seed"]``) on a whole-prompt
   PagedEngine, three requests on two slots: a raise at the second decode
   call fails the in-flight lanes with ``FaultError`` and serves the
   queued one with the fault-free tokens; a 0.2 s hang changes no token;
   a wedged decode call under ``attach_health`` fails every request with
   ``AgentDeadError`` and drains the arena while still wedged; after each,
   ``pool.check()``, no live or reserved block, the whole capacity free.
   Each leg prints the monitor states, the fault counts, the replay count,
   the attempts, the ms to detect and to recover, and its launches; leg
   (e) is phase 3f's (c).  The kernels line lists each kernel's launches
   over the legs as ``launches_resilience``; a kernel of the legs' path
   launched no time fails the run.
3h. Multi-process C²MPI (``phase3h``, after 3g; DESIGN.md §13;
   ``MULTIPROC``): (a) a worker process ``w0`` spawned on the card
   (``repro_torch.distributed.remote.spawn_worker``: its own CUDA context,
   the kernel library loaded before its hello; the seconds to hello
   printed) and attached as ``hopper@w0``; (b) every alias with a hopper
   row sent at small shapes to ``hopper@w0`` and to the in-process hopper
   row: ``torch.equal``, the worker's own launch counts (carried in its
   ``ping`` reply) equal to the host's for the same request, every
   request served by the worker's hopper agent (none by its aten or torch
   rows); (c) 3e's system, eager and captured, over ``["hopper",
   "hopper@w0"]`` at the default wire-cache cap (the 0.54 GB row block
   ships every sweep) and, after (d), over ``["hopper", "hopper@w1"]``
   with w1 spawned under ``HALO_WIRE_CACHE_MB`` raised (the block ships
   once; ``bytes_saved`` counts the rest): bit-identical to serial hopper, one MVM and VDP a sweep on
   each side, T3, the host process's device time and busy share, and
   ``wire_stats()``; (d) w0 killed with its MVM wedged in flight: the ms
   from the kill to DEAD, the comm re-bound, the clones gone, held as 3g
   holds its member death; (e) danube cut to 2 layers over ``["hopper",
   "hopper@w1"]``, 2 steps: history and parameters bit-identical to one
   member's, the worker's LM_GRAD on its kernels.  Every worker is shut
   down before the phase ends, also on failure.
3i. Expert parallelism (``phase3i``, after 3h; DESIGN.md §15;
   ``EXPERT_PARALLEL``): moonshot-v1-16b-a3b's MoE layers 1-4 at their
   published widths through ``moe_expert_parallel``, each call against
   ``moe_layer`` on the same session and inputs: (a) bfloat16, a prefill
   batch of 4 x 512 tokens and a decode batch of 4 x 1, over ``["aten",
   "aten"]`` and ``["aten"] * 4``; (b) float32, layer 1, over ``["aten",
   "torch", "aten", "torch"]``; (c) layer 1 over ``["aten", "aten@w0"]``,
   w0 a worker process on the card, against (a)'s two-member result.  y
   and aux ``torch.equal`` to the reference, every MOE_FFN node on its
   member's platform, 3 MMM launches a call on the route ``mmm_route``
   names, the worker's aten agent serving 5 requests a call; host ms a
   call, device ms and the wire's bytes printed.  The worker is shut down before the phase ends.
3j. Expert parallelism under a device mesh (``phase3j``, after 3i; ROADMAP
   A10c's serving half; ``MESH``): the kernel library built first, then
   four ranks on the one card over ``gloo`` (``launch.mesh.run_ranks``,
   ``mesh_rank``), each holding every tensor whole outside the
   ``shard_map`` bodies: (a) moonshot-v1-16b-a3b's MoE layers at
   published width, bfloat16, 2 layers, a prefill of 4 × 128 tokens (a2a)
   and a decode of 4 × 1 (replicated) on meshes (1, 4) and (2, 2), the
   prefill with int8 dispatch (within 0.05 of the exact path), float32
   decode on (1, 4): each call within ``TOL`` of ``moe_layer`` in one
   process over the same token shares (``moe_by_shares``), two calls the
   same bits, the body and MOE_FFN on the rank's aten row once a call, 3
   MMM launches on ``mmm_route``'s route; on (1, 4) decode each rank's
   expert outputs ``torch.equal`` to ``moe_layer``'s rows [16r, 16r + 16),
   float32 included; host ms, device ms (torch.profiler) and the bytes a
   rank hands each verb, beside ``moe_layer``'s; (b) moonshot at full
   width cut to layer 0 and 2 MoE layers (capacity factor 11.0 ≥ 64 / 6:
   no row drops) served through ``ServeEngine.generate`` under (2, 2), 4 prompts
   of 128 tokens, 8 greedy tokens, every step's logits within ``TOL`` of a
   one-process run fed the one-process tokens, its expert choices forced
   on the mesh (``mesh_routing``; the free gap and the tokens routed
   otherwise printed: a bfloat16 router margin flips an expert now and
   then).  Every rank's outputs the
   same bits; the bodies counted in every rank; MMM, RMSNORM and
   FLASH_ATTN launches summed over the ranks into the kernels line
   (``launches_mesh``).  Every rank is reaped before the phase returns.
3k. Training under a device mesh (``phase3k``, after 3j; ROADMAP A10c's
   training half; ``MESH_TRAIN``): moonshot-v1-16b-a3b at published
   width cut to layer 0 and one MoE layer at capacity factor 11.0,
   bfloat16, 4 × 128 tokens a step.  ``mesh_train_reckoning`` (bytes a
   rank under the global view) is printed and the ranks' fit checked
   before any rank starts; a one-process step runs first in a process of
   its own and keeps its step-1 gradients in a temporary file; then two
   gloo ranks on the card train 2 steps of ``make_train_step`` under
   (1, 2) and then (2, 1): (a) every rank's loss, gradients and state the
   same bits as rank 0's after every step (``fingerprint``), (b) step 1's
   xent, grad norm and every gradient leaf within phase 3d's tolerances of
   the one-process step, (c) the int8 dispatch's gradients at cosine ≥
   ``TRAIN_COS_MIN`` of the exact dispatch's, (d) MMM, RMSNORM, FLASH_ATTN
   and EMBED_GRAD launches a step by ``train_structure``, (e) the a2a body
   twice a MoE layer a step (the recompute kept the mesh), (f) the
   backward's all_to_all bytes equal to the forward's; host ms, device ms
   (rank 0, torch.profiler), peak GB and bytes a verb printed.  The launches
   over ranks, meshes and steps go into the kernels line
   (``launches_mesh_train``).  ``tools/mesh_train_cards.py`` runs the same
   leg over four cards, (2, 2), one NCCL rank a card.
3d. Training (``phase3d``): (a) the gradients of the MMM, RMSNORM and
   FLASH_ATTN autograd Functions on the card against autograd of their
   plain versions on the card: MMM at danube's projections and unembed
   with 2048 rows in bfloat16 (``TOL``, and dA and dB within half an ulp
   of the float32 products, ``mmm_ulp_excess``) and at one float32 shape
   on the tf32x3 route, RMSNORM at 2048 × 2560, FLASH_ATTN at 4 × 32 × 512
   × 80 on 8 KV heads (causal, window 4096) and at head dim 256; (b)
   h2o-danube-1.8b at full width and depth (``TRAIN``) trained 3 steps
   through ``repro_torch.launch.train`` on the kernels: per step the loss,
   lr, grad norm, host ms, device ms (torch.profiler over the step),
   tokens/s and peak memory, and the launches, which must equal the
   structure's (``train_structure``: each repeat recomputed in the
   backward); (c) step 1 on the kernels against step 1 with every alias
   on its plain torch row (the manifest of 3b's plain replays), same
   weights and batch: loss within ``TRAIN_LOSS_TOL``, grad norm within
   ``TRAIN_GNORM_TOL``, every gradient leaf at cosine ≥ ``TRAIN_COS_MIN``;
   (d) LM_GRAD and ADAMW_STEP through ``halo_dispatch`` on danube cut to 4
   layers against ``make_train_step`` (the same tolerances, the update's
   cosine, launches by structure).  The structure counts EMBED_GRAD, the
   embedding's backward, once a step.
3f. Data-parallel training (``phase3f``, after 3d): danube at full width
   cut to ``TRAIN_COMM["layers"]`` layers (the reckoning of a step's flat
   float32 vectors at full depth is printed beside the measured peak),
   phase 3d's 4 × 512 tokens in 4 microbatches, through ``Trainer(comm=,
   arch=)`` on ``halo.initialize()``'s card session: (a) LM_GRAD twice on
   one microbatch bit-identical, EMBED_GRAD at a step's 2048 × 2560
   bfloat16 gradient bit-identical to its plain version and to itself, and
   the number of elements in which two calls of the gather's own atomic
   backward differ (printed); (b) groups ``["hopper"]``, ``["hopper"] * 2``,
   ``["hopper"] * 4`` and ``["hopper", "aten", "hopper", "torch"]`` from the
   same weights, 3 steps each: loss histories and final flat params, mu and
   nu ``torch.equal``; per step the loss, lr, grad norm, host ms, device ms
   (torch.profiler) and busy share, and the launches, which must follow
   ``comm_structure`` (LM_GRAD's per microbatch on every member; on the
   hopper-only groups the EWADD combines on the ewise kernel, the
   one-member group's last one fused with its COPY); (c) ``["hopper",
   "aten"]`` whose aten member dies (``on_member_dead``) before step 2: the
   epoch moves, the trainer recaptures once, and its 4-step history equals
   one member's bit for bit; (d) step 1 against ``Trainer.run`` on one
   device with 4 microbatches, same weights and batch (phase 3d's loss and
   grad-norm tolerances, the parameter updates' cosine); (e) a second
   2-step run over ``["hopper"] * 2`` replays the cached compiled graph
   (one more cache hit, no new graph) with the same history.  Its (c) is
   phase 3g's leg (e): the death goes through
   ``session.handle_dead_agent`` (nothing queued, 0 replayed), and a second
   4-step run on a fresh aten agent wedges it (``FaultPlan(mode="die")``)
   in step 2's first LM_GRAD call under a started monitor
   (``RESILIENCE["train_timeout"]``): DEAD, the wedged and the queued call
   replayed on the torch row, the epoch moved, the history bit-identical to
   one member's; the monitor is stopped after it.
3l. Tuning (``phase3l``, after 3f; DESIGN.md §9; ROADMAP A5; ``TUNE``):
   the only phase run under a TuningDB (``HALO_TUNING_DB`` is unset at the
   start and after it).  (a) ``repro_torch.launch.tune.sweep`` over its
   SHAPES into a temporary DB, each bucket's default and tuned µs, gain
   and every plan's µs printed with the card; every bucket must time 1 +
   len(variants) plans (a plan that raised on the card fails the phase);
   (b) every plan of every bucket against its plan model, two calls
   bit-identical (``tuned_bucket_check``); (c) with no DB every swept
   shape dispatches with no plan merged and one launch on the default
   route, with the swept DB with the entry's plan, the bits those of the
   row at that plan; (d) danube at full width served (``tuned_serve``)
   with no DB, a seeded DB (the decode k/v bucket on ``TUNE["kv_plan"]``:
   its projections, 48 a decode pass, move from ``mmm_skinny`` to
   ``mmm_wgmma``, launches by structure) and the swept DB, each run's
   logits against no DB's within SERVE_TOL up to the step the served
   tokens part (``served_logits_agree``), decode-step host ms, one step
   alone by host clock and device time, T1; (e) the template under the
   swept DB: EW* and SORT bit-identical to no DB, the rest within TOL,
   launches equal; (f) a worker spawned under the seeded DB: MMM and
   RMSNORM at seeded buckets on ``hopper@w0`` torch.equal to in-process,
   launches equal; (g) 3c's decode chain under the swept DB with
   ``TUNE["norm_plan"]`` seeded at its RMSNORM bucket: serial dispatch and
   replays run every RMSNORM at that plan (a noting registry), replays
   bit-identical to serial dispatch under the DB, launches per replay.
4. Times at the phase-3 shapes: the median of 20 CUDA-event-timed calls of
   the kernel, its plain version and one library call, beside the least
   time the card could take (``bound_ms``).  RMSNORM and FLASH_ATTN, at the
   shapes of phase 3b: device time per call from ``torch.profiler`` over 20
   calls (a kernel of tens of µs is shorter than its Python wrapper), with
   the event times beside it (FLASH_ATTN's mma route in bfloat16 and its
   3×TF32 route in float32;
   RMSNORM at 4, 512, 4096 and 4200 rows,
   each beside ``F.rms_norm`` and its bound, under its launch plan); so are the radix FFT at the template's shape
   and MMM's skinny route at each decode projection (M = 4, bfloat16, B
   cold in L2), beside ``torch.matmul``, with a sweep over M of the skinny
   route against the route that takes M > SKINNY_M_MAX (wgmma in
   bfloat16, 3×TF32 in float32) that sets SKINNY_M_MAX; MMM's tensor-core
   route at each prefill projection (bfloat16, B cold in L2) beside its
   plain version and ``torch.matmul``, and at 4200×2558 @ 2558×6910 (both
   operands packed; the pack and the product apart).  MMM's 3×TF32 route
   by device time at 4096³ and at the lone request's 4096×4094 @
   4094×4096 (the split pass and the product apart, from the same
   profiler windows, unless their sum strays from the whole call's) and
   at the float32 replay's four 512-row shapes, beside ``torch.matmul``
   (TF32 off), its bound at the TF32 tensor-core rate and the floor of
   three such products apart.  The
   chirp FFT route by device time at 2048 x DFT_N beside cuFFT, with its
   table build apart and a sweep over n at 2048 rows; SORT's radix route
   at 2^24 and its tile route at 4096 x 4096 (events, device time
   beside), with a sweep of both SORT routes over the row lengths the tile
   route takes; EW* per op by device time beside ATen's, event times
   beside, and its vector kernel at 1 and at 4 vectors a thread around
   the size where its plan turns to 4 and at phase 3's size.  The fused
   chain kernel at a 4-step
   8192² float32 chain, beside its plain version, the four ATen calls and
   the four serial EW launches.  SMMM at the template's shape by events,
   by device time with its split pass and product apart, beside the dense
   ``torch.matmul`` of the densified A and a ``torch.sparse`` BSR product
   where that takes the blocks, its bound at the TF32 tensor-core rate and
   the float32 CUDA-core bound and three products' floor apart.
   FLASH_ATTN's 3×TF32 route also at the float32 replay's 512 tokens and
   at head dim 256 (1x16x4096x256, causal), beside SDPA and its bound at
   the TF32 rate (the three products' floor and the float32 CUDA-core
   bound beside it, its split pass and product apart), with its error
   against float64.  FLASH_ATTN's wgmma route (``FA_D256``) at gemma-7b's
   1x16x4096x256 causal in bfloat16 and float16 and gemma3-4b's 1x8x4096x256
   on 4 KV heads with window 1024 in bfloat16, and deepseek-v2's MLA
   prefill 1x128x2048x192 (padded to 256; its bound at the real dim), by
   device time beside SDPA, the plain version and its bound at the
   bfloat16 tensor-core rate.  EMBED_GRAD at phase 3d's batch (2048
   positions, 2560 columns, bfloat16, into the 32000-row table) by device
   time beside its plain version, ``index_put_(accumulate=True)`` and its
   byte bound.

It prints one ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: working sets of phase 3 (paper's 48 MB–1 GB range): JS A 268 MB; 1DCONV
#: 268 MB in and out; SMMM A 8192x8192 in 64x128 blocks at density 0.25
#: (values ~110 MB) times B 8192x4096 (134 MB); FFT a 2048x4096 batch
#: (32 MB) into 64 MB of complex64 on the radix route (a 32 KB twiddle
#: table); SORT 2^24 values (64 MB in, 64 MB out); HIST 2^26 values (268 MB)
SIZES = {"MMM": 4096, "EW": 8192, "MVM": 8192, "VDP": 1 << 26, "JS": 8192,
         "1DCONV": 1 << 26, "SMMM": 8192, "FFT": 4096, "SORT": 1 << 24,
         "HIST": 1 << 26}

#: phase 3 and 4: the FFT length that is not a power of two, for the chirp
#: route (2048 rows of it, 24.6 MB in, 49.2 MB of complex64 out; L = 8192)
DFT_N = 3000
#: phase 2 and 4: the chirp route's lengths (2999 and 4093 are primes)
CHIRP_N = (3, 7, 100, 1000, 2999, DFT_N, 4093, 4095)
#: phase 3 and 4: the lone float32 MMM request (M, K, N): K = 4094 is not a
#: multiple of 4, so TMA cannot stride A's rows; the 3×TF32 route's split
#: pass pads its workspace to K = 4096
LONE_MMM = (4096, 4094, 4096)
#: phase 2 and 4: a bfloat16 prefill-sized MMM whose K and N are off every
#: multiple of 8: the tensor-core route packs both operands first
PACKED_MMM = (4200, 2558, 6910)

#: MMM and MVM: normwise relative error allowed between a kernel and its
#: plain version.  float32: the two sum the same float32 products in another
#: order, which moves the result by a few units of 2^-24 times sqrt(K); 1e-5
#: leaves room for K = 8192.  bfloat16: the float32 sums are alike, but
#: rounding the output to an 8-bit mantissa (2^-9 ≈ 2e-3 relative) can land
#: on the other side for some elements.  float16 (RMSNORM and FLASH_ATTN
#: only): the same with an 11-bit mantissa, as tests/test_torch_cuda.py.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}

#: FLASH_ATTN's 16-bit tensor-core routes (mma, wgmma) against their plain
#: model (``attention_mma_ref``: the same 64-key tiles, p rounded to the
#: input type): the two differ only in float32 sum order, which moves the
#: output's last rounding for a few elements.  On the H100, on phase 2's
#: and the card tests' cases, the mma route reads ≤ 1.8e-4 (bfloat16) and
#: ≤ 6e-5 (float16), the wgmma route ≤ 9.0e-5 and ≤ 5.7e-5, and 3.56e-4 and
#: 1.68e-4 over 8192 keys (128 key tiles summed in one accumulator); a
#: kernel that masks one key too many at the window's edge reads ≥ 4e-3
#: (mma) and 5.66e-3 (wgmma, bfloat16).  ``TOL`` against the plain version
#: would let that pass.
MMA_MODEL_TOL = {torch.bfloat16: 1e-3, torch.float16: 3e-4}

#: FLASH_ATTN's float32 route (3×TF32 on the tensor cores) against its plain
#: model (``attention_tf32x3_ref``: the same 32-deep head-dim stages, key
#: tiles and 32-key p·v sums, each a fresh accumulator added in float32)
#: and against float64 (``attention_f64``).  Kernel and model differ only
#: in the order within a tensor-core sum; on the H100 the kernel read
#: ≤ 2.5e-7 against the model and ≤ 2.3e-7 against float64 at phase 2's and
#: the card tests' masks, ≤ 2.9e-7 and ≤ 3.6e-7 over rows of 8192 keys.  A
#: kernel that carries one p·v accumulator over a row of thousands of keys
#: (the tensor cores truncate its sums) or drops the lo·hi product of q·kᵀ
#: errs past these; ``TOL`` (1e-5) would let the first pass.
FA_TF32_MODEL_TOL = 1e-6
FA_TF32_F64_TOL = 1e-6

#: SMMM's tensor-core kernel against its plain model (``smmm_tf32x3_ref``:
#: the same padded workspace, three TF32 products a 32-deep stage, each
#: stage added to the float32 sums in slot order) and, in float32, against
#: a float64 product.  Kernel and model differ only in the order of a
#: stage's sum; on the H100 the kernel read ≤ 3.2e-7 against the model and
#: ≤ 5.6e-7 against float64 in float32, and ≤ 2.6e-5 (bfloat16) and ≤ 1.7e-5
#: (float16) against the model, where that order moves a 16-bit output's
#: last rounding for a few elements.  A kernel that dropped the lo·hi term
#: errs ~1e-4; one that carried one tensor-core accumulator over a row's
#: stages errs past 1e-5 on the long index row.  ``TOL`` would pass both
#: at some shapes.
SMMM_MODEL_TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-3, torch.float16: 3e-4}
SMMM_F64_TOL = 2e-6

#: VDP: |k − r| / |r| on vectors of mean 1, where Σxy ≈ n is about half of
#: ‖x‖‖y‖, so this is the dot product's own relative error.  The output is
#: float32 and bfloat16 products are exact in float32, so both types differ
#: only in summation order: a chain of d float32 additions errs by about
#: sqrt(d)·2^-24 · Σ|xy|/|Σxy| (≈ 1.4 here) when its rounding errors are
#: random; the kernel's longest chain at n = 2^26 is ~270 additions, which
#: gives ~1.4e-6.  1e-5 leaves room, and still catches one pass-1 block of
#: the 1024 left out (~1e-3).  The integer cases of ``vdp_exact_inputs`` are
#: held bit-exact instead.
VDP_TOL = 1e-5

#: JS: 30 sweeps of a diagonally dominant system must bring the float64
#: residual ‖Ax − b‖/‖b‖ this low; the contraction factor is ~2/√n per
#: sweep, so what is left is float32 rounding (~1e-6).
JS_RESIDUAL = 1e-4

#: FFT: normwise relative error of the kernel against the float64 DFT and
#: against its plain version (the same stages in the same order).  Each
#: Stockham stage rounds once in float32 against twiddles and chirps
#: rounded once from float64; log2(L) ≤ 13 stages, twice on the chirp
#: route, err by a few units of 2^-24 each, ~2e-7 on the H100.  Twiddles
#: whose angle is formed in float32, as the reference's are, err above
#: this limit from n = 1000 on (tests/test_torch_fft_sorthist.py).
FFT_TOL = 1e-5

#: SMMM pad slots are filled with this instead of zeros, so a kernel that
#: read a pad slot as block 0 would add 7·B[0:bk] to its rows
PAD_FILL = 7.0

#: published peaks (NVIDIA data sheets, dense): bytes/s, float32 CUDA-core
#: FLOP/s, bfloat16 tensor-core FLOP/s
PEAKS = {"H100 SXM": (3.35e12, 67e12, 989e12),
         "H100 PCIe": (2.0e12, 51e12, 756e12)}
#: TF32 tensor-core FLOP/s, dense (the same data sheets)
TF32_PEAKS = {"H100 SXM": 495e12, "H100 PCIe": 378e12}

#: phase 3b: the served model and its traffic
SERVE = {"arch": "h2o-danube-1.8b", "slots": 4, "requests": 8,
         "prompt_lens": (512, 4200), "max_new": 16, "seed": 0}

#: phase 3b, the paged danube legs: the danube leg's model, weights and
#: requests on a PagedEngine of SERVE["slots"] slots and 16-token blocks
#: (every cache a ring of 4096), (a) whole-prompt admission, (b) chunked
#: prefill of 256 tokens with requests 5 and 7 (512 tokens) beginning with
#: request 1's first 448 tokens (28 blocks): 28 prefix hits each
SERVE_PAGED = {"block_size": 16, "chunk": 256, "shared_tokens": 448, "sharers": (4, 6),
               "prefix_hits": 56}
#: phase 3m: the captured decode step against the eager body, danube at
#: full width (24 layers, bfloat16) on 4 slots, dense and paged (16-token
#: blocks, whole-prompt admission): 6 requests of these prompt lengths and
#: budgets, so lanes join and leave (13 decode steps); then one decode step
#: alone, every slot past its prompt, captured and eager, ``runs`` steps a
#: sample
DECODE_GRAPH = {"arch": "h2o-danube-1.8b", "slots": 4,
                "prompt_lens": (512, 96, 300, 40, 700, 128), "max_new": (12, 5, 9, 4, 6, 7),
                "seed": 0, "runs": 5}
#: phase 3b's gemma3-4b leg: its 2048-token request again through
#: prefill_chunk, 256 tokens a chunk (below the 1024-slot rings)
D256_CHUNK = 256
#: phase 3b's deepseek leg: MLA's multi-token cache step, a chunk of this
#: many tokens after the 2048-token prompt
MLA_CHUNK = 64

#: phase 3b's second leg, FLASH_ATTN at head dim 256 on a served path:
#: gemma3-4b at its published widths (d_model 2560, 8 heads of 256 on 4 KV
#: heads, d_ff 10240, vocab 262144, bfloat16), its depth cut to one 5:1
#: pattern (5 local layers of window 1024 and 1 global), weights from a
#: seed; prompts of 2048 tokens pass the window, so the local caches roll
#: into rings
SERVE_D256 = {"arch": "gemma3-4b", "pattern_repeats": 1, "slots": 2, "requests": 4,
              "prompt_lens": (512, 2048), "max_new": 8, "seed": 0}

#: phase 3b's third leg, the state-space path (SERVE_HYBRID): zamba2-1.2b at
#: its published widths and full depth (d_model 2048; 38 Mamba-2 layers of
#: state 64, head dim 64, expand 2, conv 4, chunk 128; one shared attention
#: block of 32 heads of 64 and d_ff 8192 invoked 6 times, 44 blocks in all;
#: vocab 32000; bfloat16 weights from a seed), 4 requests of 512 and 2048
#: tokens on 2 slots, 8 tokens each, greedy
SERVE_HYBRID = {"arch": "zamba2-1.2b", "slots": 2, "requests": 4,
                "prompt_lens": (512, 2048), "max_new": 8, "seed": 0}

#: phase 3b's fourth leg, mixture of experts (SERVE_MOE): moonshot-v1-16b-a3b
#: at its published widths and full depth (d_model 2048; 16 heads of 128 on
#: 16 KV heads; layer 0 dense with d_ff 11264, then 47 MoE layers of 64
#: experts of d_ff 1408, top 6, 2 shared experts, capacity factor 1.25;
#: vocab 163840; 28.39 B parameters, 56.8 GB in bfloat16, from a seed), 8
#: requests of 512 and 2048 tokens on 4 slots, 8 tokens each, greedy
SERVE_MOE = {"arch": "moonshot-v1-16b-a3b", "slots": 4, "requests": 8,
             "prompt_lens": (512, 2048), "max_new": 8, "seed": 0}
#: phase 3b's fifth leg, MLA (SERVE_MLA): deepseek-v2-236b at its published
#: widths (d_model 5120; MLA of 128 heads, q_lora 1536, kv_lora 512, nope
#: 128 + rope 64, v 128; 160 experts of d_ff 1536, top 6, 2 shared,
#: capacity factor 1.25; vocab 102400; bfloat16 from a seed), its depth cut
#: from 60 layers to layer 0 (dense, d_ff 12288) and 3 MoE layers: 235.7 B
#: parameters do not fit one 80 GB card, 13.3 B (26.6 GB) do; 4 requests of
#: 512 and 2048 tokens on 2 slots, 8 tokens each, greedy
SERVE_MLA = {"arch": "deepseek-v2-236b", "moe_repeats": 3, "slots": 2, "requests": 4,
             "prompt_lens": (512, 2048), "max_new": 8, "seed": 0}
#: phase 3b's stub-frontend legs at their published widths and full depth:
#: paligemma-3b (18 layers, d_model 2048, 8 heads of 256 on 1 KV head,
#: d_ff 16384 geglu, vocab 257216) through ServeEngine.generate's lockstep
#: path, 2 rows of 256 seeded patch embeddings + 256 prompt tokens, 16 new
#: tokens each, greedy; musicgen-large (48 layers, 32 heads of 64, d_ff
#: 8192 gelu, vocab 2048) at the model level: a prefill over 2 × 512 seeded
#: frame embeddings, then 8 decode steps fed seeded frame embeddings
SERVE_PALIGEMMA = {"arch": "paligemma-3b", "rows": 2, "prompt_len": 256, "max_new": 16,
                   "seed": 0}
SERVE_MUSICGEN = {"arch": "musicgen-large", "rows": 2, "frames": 512, "decode_steps": 8,
                  "seed": 0}
#: phase 3b, the moonshot leg's float32 replay: its first layers (layer 0
#: dense and 3 MoE layers), kernels against plain with routing forced
F32_MOE_LAYERS = 4
#: phase 3b's MoE legs, check (b): the kernel block's top-k set may differ
#: from the plain router's own only where the plain margin between its k-th
#: and (k+1)-th probability is at most this multiple of the largest
#: difference between the two runs' probabilities in that call.  Two
#: probability vectors within δ of each other can order two experts
#: differently only if their plain margin is ≤ 2δ; a wider flip is a
#: routing fault (a wrong index, a top k of other scores)
FLIP_MARGIN = 2.0
#: check (a): the router probabilities of the kernel block against the
#: plain block's from the same block input, normwise.  Both round the
#: block's bfloat16 attention output and residual at the same places, so
#: the router's inputs differ by a few bfloat16 ulps: on the H100 the
#: worst call read 1.47e-3 (moonshot, 48 blocks × 8 steps) and 1.54e-3
#: (deepseek), the control below 1.19e-3 and 1.21e-3; attention scaled by
#: the padded dim's 256^-1/2 at MLA's 192 read 1.74e-2
ROUTER_PROB_TOL = 5e-3
#: check (c): the block's output less its input, kernels against plain with
#: the kernel block's routing forced, normwise.  On the H100 the worst
#: block-step read 8.63e-3 (moonshot) and 6.93e-3 (deepseek); the no-fault
#: control, the plain block with MMM's plain version summing K in another
#: order, 7.21e-3 and 5.41e-3: the gap is bfloat16 rounding, as in one
#: danube layer (SERVE_TOL).  Gates left unnormalised after the top k read
#: 0.334, one expert's down product skipped 0.161, MLA's attention at the
#: padded dim's scale 0.150 (deepseek's 4 blocks)
MOE_BLOCK_TOL = 2e-2
#: MLA's absorbed decode over the latent cache against a prefill through
#: the same position (decompressed keys through FLASH_ATTN), normwise, on
#: the kernels: the decode's float32 einsums against the prefill's
#: bfloat16 products and attention.  On the H100 1.69e-3 to 3.48e-3 over
#: deepseek's 4 blocks at the first and last decode step; a decode without
#: the rope scores read 5.06e-2 to 3.65e-1
MLA_DECODE_TOL = 1e-2

#: phase 2: SSD's aten row against its torch row at zamba2's widths (B, S,
#: H, P, G, N, chunk): the served 2048-token prefill, and two lanes of a
#: length off the chunk
SSD_SHAPES = ((1, 2048, 64, 64, 1, 64, 128), (2, 515, 64, 64, 1, 64, 128))
#: phase 2: the float32 SSM state of SSD's two rows and of SSD_DECODE fed
#: every step, against the scan's: both sum the same float32 terms in
#: another order (per chunk, then across chunks), as one kernel against its
#: plain version
SSD_STATE_TOL = 1e-5

#: phase 3b: normwise error allowed between the served logits and the plain
#: replay's, both bfloat16.  Both round every kernel's output to bfloat16 at
#: the same places, and the kernels compute the plain versions' function
#: (the float32 leg below holds them to F32_SERVE_TOL), but one rounding
#: that lands on the other side of a bfloat16 boundary changes that value
#: by 2^-8 of itself, which moves each output of the next projection by a
#: few hundredths of its own rounding step, so a few in a hundred of them
#: round the other way too; within a layer or two the two runs differ by
#: an ulp in most elements, and the logits by ~5e-3.  On the H100 the gap
#: read 4.9e-3 with one layer kept and 1.7e-2 with all 24 (the depth sweep
#: below prints it); a kernel that dropped a key tile, a rescale or the
#: window mask errs by 3e-2 to 5e-1 at a single call.
SERVE_TOL = 2e-2

#: phase 3b's zamba2 leg (SERVE_HYBRID): the served bfloat16 logits against
#: the plain replay's at full depth, 44 blocks.  SERVE_TOL was set at
#: danube's 24 layers; here the gap grows with the blocks kept (on the
#: H100, tools/zamba2_gap.py: 2.07e-3 after 1 block, 1.20e-2 after 7,
#: 3.82e-2 at 44) and no one part carries it: the plain replay against
#: itself with one MMM call summed in another float32 order (2.4e-4 of
#: that call's outputs moved by one ulp, no fault) reads 3.32e-2 at 44
#: blocks, and the chunked SSD alone 2.92e-2.  Dropping SSD_DECODE's D
#: skip in its aten row reads 1.39 to 1.44 at every decode step.  So the
#: leg holds the whole depth to this bound, the same request with its
#: first pattern kept (7 blocks: 6 Mamba layers and the shared block) to
#: SERVE_TOL at every step (1.08e-2 to 1.20e-2), and the float32 replay
#: (kernels against plain) to F32_SERVE_TOL
SERVE_HYBRID_TOL = 6e-2

#: phase 3b: the same check with the weights widened to float32, where both
#: paths differ only in float32 summation order (~1e-7 per kernel call), and
#: a depth of 24 layers amplifies that to ~1e-5; the CPU parity tests hold
#: reduced models to the JAX package at the same 1e-4
F32_SERVE_TOL = 1e-4

#: phase 4: enough copies of a decode weight matrix to pass the H100's 50 MB
#: L2 between two calls on one of them
L2_COLD_BYTES = 200_000_000

#: phase 4: the row counts of the MMM route sweep
CROSSOVER_M = (1, 4, 8, 16, 32, 64, 128, 256)
#: phase 4: the row lengths of the SORT route sweep (2^24 keys each), up to
#: the tile route's limit SORT_TILE, 4097 padded to 8192 by the tile route
CROSSOVER_SORT_N = (256, 1024, 4096, 4097, 8192)

#: phase 3c: the graph workloads' sizes and the replays each is driven
GRAPH = {"ew_n": 8192, "decode_d": 2560, "decode_layers": 24, "js_n": 8192,
         "js_sweeps": 30, "replays": 20}

#: phase 3e, collectives: the paper's distributed Jacobi
#: (repro_torch.collective_jacobi) on an n × n float32 system (A is 1.07 GB at
#: n = 16384) over two device groups — four ranks on one substrate, and the
#: heterogeneous pair; the solve error is also read after ``err_sweeps``
#: serial sweeps to see it fall
COLLECTIVE = {"n": 16384, "sweeps": 30, "seed": 5, "err_sweeps": (1, 2, 3),
              "groups": {"a": ("hopper",) * 4, "b": ("hopper", "aten")}}
#: group (b)'s iterate against serial hopper, and serial hopper and serial
#: aten against serial on the plain torch rows, normwise: torch.mv and the
#: plain MVM sum each row's 16384 products in other orders than mvm.cu's
#: warp, so the rows differ by float32 rounding; the Jacobi map contracts
#: (spectral radius ~1/sqrt(n)) and the iterates meet at the float32
#: solution's noise (~1e-7, relative), so float32's TOL leaves 100x.  A
#: kernel that dropped one term of each row would move the fixed point by
#: ~1/n relative (6e-5), past it
COLLECTIVE_B_TOL = 1e-5
#: the relative solve error ‖Ax − b‖/‖b‖ (float64) after 30 sweeps: it read
#: 4.116e-7 at float32's floor on the card; 2e-6 leaves 5x, and is 30x below
#: the ~6e-5 a fixed point moved by a dropped term per row would leave
COLLECTIVE_SOLVE_TOL = 2e-6

#: phase 3d, training: h2o-danube-1.8b at full width and depth through
#: repro_torch.launch.train (batch × seq_len tokens a step, SyntheticLM from
#: the seed); the LM_GRAD/ADAMW_STEP leg cut to ``alias_layers`` layers,
#: whose flat float32 vectors (3p + 4 out, four p-vectors in) would not fit
#: beside a full-depth model
TRAIN = {"arch": "h2o-danube-1.8b", "batch": 4, "seq_len": 512, "steps": 3, "seed": 0,
         "lr": 3e-3, "alias_layers": 4}
#: phase 3d: step 1 on the kernels against step 1 on the plain rows, same
#: weights and batch: the loss (relative), the gradients' global norm
#: (relative), and each gradient leaf's cosine similarity
TRAIN_LOSS_TOL = 2e-2
TRAIN_GNORM_TOL = 5e-2
TRAIN_COS_MIN = 0.99
#: phase 3f, data-parallel training (§15): danube at full width cut to
#: ``layers`` layers (a step's flat float32 vectors, several of 4p bytes
#: each, would not fit 80 GB at full depth: ``comm_reckoning``), phase 3d's
#: 4 × 512 tokens in 4 microbatches, one member to four, the mixed group;
#: the member-death run over ``death``, ``death_steps`` steps; the second
#: run from the compiled-graph cache over group "2", ``cache_steps`` steps
TRAIN_COMM = {"arch": "h2o-danube-1.8b", "layers": 8, "batch": 4, "seq_len": 512,
              "microbatches": 4, "steps": 3, "seed": 0, "lr": 3e-4,
              "groups": {"1": ("hopper",), "2": ("hopper",) * 2, "4": ("hopper",) * 4,
                         "mixed": ("hopper", "aten", "hopper", "torch")},
              "death": ("hopper", "aten"), "death_steps": 4, "cache_steps": 2}

#: phase 3g, resilience (DESIGN.md §11): a monitor declares a member DEAD
#: after ``timeout`` s without a beat, swept every ``poll`` s (straggler
#: speculation off); (a) wedges the aten member on its ``death_nth``-th
#: device call (a few sweeps into the solve); (b) and (c) hang a call for
#: up to ``hang_s`` (the DEAD timeout then too, so only the straggler
#: watch acts) with speculation at ``straggler_multiple`` × the estimate,
#: never under ``straggler_min_s``; (b)'s MMM at danube's gate projection,
#: 512 prefill rows; (d)'s paged danube requests (prompt lengths past
#: SKINNY_M_MAX, so prefill takes the wgmma route); 3f's monitored
#: member death at ``train_timeout`` (an LM_GRAD call takes ~0.2 s of host)
RESILIENCE = {"timeout": 1.0, "poll": 0.02, "death_nth": 40, "hang_s": 60.0,
              "straggler_multiple": 1.0, "straggler_min_s": 0.05,
              "mmm": (512, 2560, 6912), "paged_lens": (96, 80, 72), "paged_max_new": 6,
              "paged_slots": 2, "train_timeout": 2.0}
#: the kernels phase 3g's legs (3f's death runs included) must launch
RESILIENCE_KERNELS = ("mmm_wgmma", "mmm_skinny", "ewise", "mvm", "vdp", "rmsnorm",
                      "flash_attention_mma", "fused", "embed_grad")

#: phase 3h, multi-process C²MPI (DESIGN.md §13): workers on the card;
#: (b)'s requests from ``payload_seed``; (c) runs on w0 at the default
#: wire-cache cap (256 MB: a member's 0.54 GB row block of 3e's system ships
#: every sweep) and on w1, spawned with ``HALO_WIRE_CACHE_MB`` at
#: ``raised_mb``, after (d) (it ships once); (d) wedges w0's MVM
#: ``kill_nth`` (a third of the way into the solve) and kills w0; (e)
#: trains danube cut to ``train_layers`` layers (its float32 parameter
#: vector 1.2 GB) for ``train_steps`` steps; ``hello_timeout`` bounds a
#: spawn (a cold kernel build in the worker included) and ``timeout`` a
#: request
MULTIPROC = {"payload_seed": 13, "raised_mb": 1024, "kill_nth": 10, "train_layers": 2,
             "train_steps": 2, "hello_timeout": 300.0, "timeout": 600.0}

#: phase 3i, expert parallelism over device groups (DESIGN.md §15; ROADMAP
#: A10c's first half): moonshot-v1-16b-a3b's MoE layers at their published
#: widths (d_model 2048, 64 experts of d_ff 1408, top 6, 2 shared experts,
#: capacity factor 1.25) cut to ``layers`` of its 48, weights from
#: ``seed``; (a) a prefill batch of ``batch`` × ``prefill`` tokens (C =
#: 244) and a decode batch of ``batch`` × 1 (C = 4), bfloat16, each layer
#: fed the one before's output, over each group of ``groups_a``; (b)
#: float32, the first layer, over ``group_b``; (c) the first layer over
#: ``["aten", "aten@w0"]``, w0 a worker process on the card; host ms a call
#: the median of ``timed`` synchronised calls, device ms from ``profiled``
#: profiler runs (in (c), one synchronised call in a bare profiler window
#: gives both: each of its calls ships ~1.7 GB over the wire and back, 5-6 s
#: on the H100)
EXPERT_PARALLEL = {"arch": "moonshot-v1-16b-a3b", "layers": (1, 2, 3, 4), "batch": 4,
                   "prefill": 512, "seed": 21, "timed": 5, "profiled": 2,
                   "groups_a": (("aten", "aten"), ("aten",) * 4),
                   "group_b": ("aten", "torch", "aten", "torch")}
#: phase 3j, expert parallelism under a device mesh (ROADMAP A10c's
#: serving half): ``ranks`` processes on the one card over gloo
#: (``run_ranks``), meshes (data, model) of ``meshes``; (a) moonshot's MoE
#: layers at published width (d_model 2048, 64 experts of d_ff 1408, top
#: 6, 2 shared, capacity factor 1.25), ``layers`` of them, weights from
#: ``seed``: bfloat16 prefill ``batch`` × ``prefill`` (a2a: 128 tokens a
#: rank, C = 16) and decode ``batch`` × 1 (replicated, C = 4) on each
#: mesh, the prefill again with int8 dispatch (within ``int8_rel`` of the
#: exact path, tests/test_sharded.py's bound), float32 decode on (1, 4);
#: host ms the median of ``timed`` calls, device ms from ``profiled``
#: profiler runs; (b) moonshot at full width cut to layer 0 and
#: ``moe_layers`` MoE layers served under ``mesh``, ``requests`` prompts
#: of ``prompt_len`` tokens, ``max_new`` greedy tokens, at capacity factor
#: 11.0 ≥ 64 experts / top 6, so that every expert's capacity holds every
#: token a call sees and no row drops, in one process or on a rank's share
#: (a capacity is sized per call from the tokens it sees, so where rows
#: drop the mesh drops others than one process: at 8.0 random weights
#: route so many of a prompt's tokens to one expert that the mesh dropped
#: each share's last tokens, and the prefill's last-token logits stood
#: 7.5e-2 from one process's on the H100).  ``timeout`` bounds the ranks'
#: whole run, spawn included
MESH = {"arch": "moonshot-v1-16b-a3b", "ranks": 4,
        "meshes": {"1x4": (1, 4), "2x2": (2, 2)}, "layers": 2, "batch": 4,
        "prefill": 128, "seed": 23, "timed": 3, "profiled": 2, "int8_rel": 0.05,
        "timeout": 400,
        "serve": {"mesh": "2x2", "moe_layers": 2, "capacity_factor": 11.0, "requests": 4,
                  "prompt_len": 128, "max_new": 8}}

#: phase 3k, training under a device mesh (ROADMAP A10c's training half):
#: moonshot-v1-16b-a3b at published width (d_model 2048, vocab 163840, 64
#: experts of d_ff 1408, top 6, 2 shared) cut to layer 0 and ``moe_layers``
#: MoE layers at capacity factor 11.0 ≥ 64 / 6 (no row can drop, in one
#: process or on a rank's share: PR 37), bfloat16, ``batch`` ×
#: ``seq_len`` tokens a step from SyntheticLM(``seed``), ``steps`` steps of
#: make_train_step (lr ``lr`` after one warmup step; step i on batch i - 1),
#: on ``ranks`` gloo ranks on the one card, mesh after mesh: (1, 2)
#: exchanges over the model axis (a2a bodies at 256 tokens a rank), (2, 1)
#: sums over the data axis.
#: Every rank holds the whole state (the global view): the ranks must fit
#: the card together, with ``headroom_gb`` a rank beside the reckoning
#: (``mesh_train_reckoning``) for the CUDA context and the backend's buffers.
#: ``timeout`` bounds one mesh's ranks, spawn included
MESH_TRAIN = {"arch": "moonshot-v1-16b-a3b", "moe_layers": 1, "capacity_factor": 11.0,
              "batch": 4, "seq_len": 128, "steps": 2, "seed": 0, "lr": 3e-3,
              "ranks": 2, "meshes": {"1x2": (1, 2), "2x1": (2, 1)}, "headroom_gb": 2.0,
              "timeout": 600}

#: phase 3l, tuning (DESIGN.md §9; ROADMAP A5): launch.tune's sweep at
#: ``repeats`` interleaved rounds after ``warmup`` calls a plan, its inputs
#: from ``seed``; (d) danube served at full width, ``requests`` prompts of
#: ``prompt_len`` tokens on ``slots`` slots, ``max_new`` tokens each, under
#: no DB, a seeded DB (danube's decode k/v projections, ``slots`` rows,
#: onto ``kv_plan``; RMSNORM at ``worker_rows`` rows, (f)'s, at
#: ``norm_plan``) and the swept DB (with ``norm_plan`` seeded at phase 3c's
#: decode chain's one-row bucket for (g)); (g) ``replays`` replays
TUNE = {"repeats": 5, "warmup": 2, "seed": 21, "slots": 4, "requests": 2,
        "prompt_len": 512, "max_new": 8, "worker_rows": 8, "replays": 5,
        "kv_plan": {"route": "wgmma", "tile_n": 128}, "norm_plan": {"warps_per_row": 2}}

TIMED_RUNS = 20
E2E_REPEATS = 5
PIN = {"allowed_platforms": ["hopper"]}

#: each kernel: its source under src/repro_torch/csrc/ and the TPU kernel
#: it replaces
REPLACES = {
    "ewise": ("ewise.cu", "src/repro/kernels/ewise/ewise.py:33"),
    "mvm": ("mvm.cu", "src/repro/kernels/mvm/mvm.py:42"),
    "vdp": ("vdp.cu", "src/repro/kernels/vdp/vdp.py:33"),
    "jacobi": ("jacobi.cu", "src/repro/kernels/jacobi/jacobi.py:47"),
    "conv1d": ("conv1d.cu", "src/repro/kernels/conv1d/conv1d.py:35"),
    "spmm": ("spmm.cu", "src/repro/kernels/spmm/spmm.py:54"),
    "sort": ("sort.cu", "src/repro/kernels/sorthist/sorthist.py:57"),
    "hist": ("hist.cu", "src/repro/kernels/sorthist/sorthist.py:97"),
    "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm/rmsnorm.py:36"),
    "fused": ("fused.cu", "src/repro/kernels/fused.py:58"),
    "mmm_skinny": ("mmm_skinny.cu", "src/repro/kernels/matmul/matmul.py:43"),
    "mmm_wgmma": ("mmm_wgmma.cu", "src/repro/kernels/matmul/matmul.py:43"),
    "fft_radix": ("fft_radix.cu", "src/repro/kernels/fft/fft.py:58"),
    "fft_chirp": ("fft_chirp.cu", "src/repro/kernels/fft/fft.py:58"),
    "mmm_tf32x3": ("mmm_wgmma.cu", "src/repro/kernels/matmul/matmul.py:43"),
    "sort_radix": ("sort_radix.cu", "src/repro/kernels/sorthist/sorthist.py:57"),
    "flash_attention_mma": ("flash_attention_mma.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:106"),
    "flash_attention_tf32x3": ("flash_attention_tf32x3.cu",
                               "src/repro/kernels/flash_attention/flash_attention.py:106"),
    "flash_attention_wgmma": ("flash_attention_wgmma.cu",
                              "src/repro/kernels/flash_attention/flash_attention.py:106"),
    # no Pallas site: the card's fixed-order backward of the reference's
    # jnp.take, whose VJP is XLA's scatter-add
    "embed_grad": ("embed_grad.cu", "none (no Pallas site; the VJP of jnp.take at "
                   "src/repro/models/layers.py:68, an XLA scatter-add)"),
}

#: where each kernel's launches are counted when it is not the template's
#: (phase 3): the model path (3b), its float32 replay on the kernels (3b;
#: FLASH_ATTN's 3×TF32 route), its gemma3-4b leg (3b; FLASH_ATTN's wgmma
#: route, head dim 256), the graphs (3c), or one of phase 3's requests
#: counted alone: FFT at the non-power-of-two DFT_N (the chirp route), SORT
#: of rows that fit one tile
PATH_OF = {"rmsnorm": "serve", "flash_attention_mma": "serve", "mmm_skinny": "serve",
           "mmm_wgmma": "serve", "fused": "graph", "fft_chirp": "chirp",
           "sort": "sort_tile", "flash_attention_tf32x3": "serve_float32",
           "flash_attention_wgmma": "serve_d256", "embed_grad": "train"}


#: the paged danube legs, the stub-frontend legs, the training leg (3d),
#: the data-parallel one (3f, the member-count runs), expert parallelism
#: over device groups (3i) and under a mesh (3j, summed over its four
#: ranks), training under a mesh (3k, summed over its ranks, meshes and
#: steps), phase 3's portability demo, phase 3l's danube served under
#: the seeded and the swept TuningDB (summed) and phase 3m's steps alone
#: (dense and paged, replays credited), whose launches
#: the kernels line lists beside those of each kernel's own path
NEW_LEG_PATHS = ("serve_paged_whole", "serve_paged_chunked", "serve_paligemma",
                 "serve_musicgen", "train", "train_comm", "expert_parallel", "mesh",
                 "mesh_train", "portability_demo", "tune", "decode_graph")


def decode_projections(cfg):
    """(K, N) → launches per forward pass of danube's projections: q and o
    (d × H·dh), k and v (d × Hkv·dh), gate and up (d × d_ff), down
    (d_ff × d), the unembed (d × padded vocab)."""
    block = cfg.stages[0].pattern[0]
    attn, layers, d = block.attn, cfg.n_layers, cfg.d_model
    shapes = [(d, attn.n_heads * attn.head_dim), (d, attn.n_kv_heads * attn.head_dim),
              (d, attn.n_kv_heads * attn.head_dim), (attn.n_heads * attn.head_dim, d),
              (d, block.d_ff), (d, block.d_ff), (block.d_ff, d)]
    per_pass = {}
    for kn in shapes:
        per_pass[kn] = per_pass.get(kn, 0) + layers
    per_pass[(d, cfg.padded_vocab)] = per_pass.get((d, cfg.padded_vocab), 0) + 1
    return per_pass


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    key = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return key, PEAKS[key]


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------
def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float64, or complex128 when it is complex."""
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def normwise(k: torch.Tensor, r: torch.Tensor) -> float:
    k, r = wide(k), wide(r)
    return float((k - r).norm() / r.norm().clamp_min(1e-300))


def relative(k: torch.Tensor, r: torch.Tensor) -> float:
    """|k − r| / |r| of two scalars."""
    k, r = k.double(), r.double()
    return float((k - r).abs() / r.abs().clamp_min(1e-300))


def vdp_exact_inputs(n: int, dtype, gen, dev):
    """Integer vectors whose dot product every summation order gets exactly.

    x ∈ {0, 1, 2} (nonzero with density min(1, 2^22/n)), y ∈ {1, 2}: every
    product is a small integer, Σxy < 2^24 (checked), so every partial sum
    is an integer that float32 holds exactly.  The kernel must then give the
    plain version's bits and the exact sum; where x is dense, each element
    dropped or counted twice moves the result by at least 1."""
    def bern(p):
        return (torch.rand(n, generator=gen, device=dev) < p).float()
    x = bern(min(1.0, 2.0 ** 22 / n)) * (1 + bern(0.5))
    y = 1 + bern(0.5)
    exact = float((x.double() * y.double()).sum())
    if not exact < 2 ** 24:
        fail(f"VDP exact case n={n}: Σxy = {exact} is not below 2^24")
    return x.to(dtype), y.to(dtype), exact


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def check_close(what: str, err: float, dtype, tol=None) -> None:
    tol = TOL[dtype] if tol is None else tol
    print(f"  {what:42s} err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        fail(f"{what}: error {err:.3e} exceeds {tol:g}")


def check_js(what: str, k, r, a, x, b, dtype) -> None:
    """JS: the kernel ``k`` against the exact sweep, computed in float64
    from the same inputs, within ``TOL`` — the kernel leaves the diagonal
    out of its float32 sum, so nothing cancels and its rounding stays near
    2^-24·√n (the 16-bit types also round x').  The plain version ``r``
    sums A·x with the diagonal, which is ≈ √n times the rest of each row,
    and then cancels it, so it errs by more; ``k`` must agree with it
    within ``TOL`` plus that error (all three measured against ‖exact‖)."""
    a64, x64, b64 = a.double(), x.double(), b.double()
    d = a64.diagonal()
    exact = (b64 - (a64 @ x64 - d * x64)) / d
    scale = float(exact.norm())

    def err(u, v):
        return float((u.double() - v.double()).norm()) / scale

    e_plain = err(r, exact)
    check_close(f"{what} vs float64", err(k, exact), dtype)
    check_close(f"{what} vs plain (plain {e_plain:.1e})", err(k, r), dtype,
                TOL[dtype] + e_plain)


def js_system(n, dtype, gen, dev):
    """A + n·I (diagonally dominant) with a random x ≠ 0 and b."""
    a = torch.randn((n, n), generator=gen, device=dev)
    a.diagonal().add_(float(n))
    x = torch.randn(n, generator=gen, device=dev)
    b = torch.randn(n, generator=gen, device=dev)
    if not bool((x != 0).all()):
        fail("JS inputs: x has a zero")
    return a.to(dtype), x.to(dtype), b.to(dtype)


def bell_inputs(m, k, n, bm, bk, density, dtype, gen, dev):
    """Blocked-ELL parts of a random block-sparse m×k A (bm×bk blocks of
    the given density) whose block row 0 has only pad slots, pad slots
    filled with ``PAD_FILL``, and a dense k×n B."""
    from repro_torch.kernels.spmm.ref import dense_to_bell, random_block_sparse
    a = random_block_sparse(gen, m, k, bm, bk, density)
    a[:bm] = 0
    values, indices = dense_to_bell(a.to(dtype), bm, bk)
    if not bool((indices[0] < 0).all()) or bool((indices >= 0).all()):
        fail("SMMM inputs: no pad slots or no all-pad block row")
    values[indices < 0] = PAD_FILL
    b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
    return values, indices, b


def same_values(k: torch.Tensor, r: torch.Tensor) -> bool:
    """Equal element by element when −0.0 counts as +0.0 and NaN as NaN."""
    return k.shape == r.shape and k.dtype == r.dtype and bool(
        ((k == r) | (k.isnan() & r.isnan())).all())


def hist_edge_inputs(bins, lo, hi, gen, dev):
    """Values on every bin edge lo + k·width (k = 0 .. bins, in float32 and
    rounded from float64), one float32 step either side of each, lo, hi,
    nextafter(hi, +inf), below lo, NaN, ±inf, and uniform values over
    [lo − 1, hi + 1]: float32."""
    f32 = dict(dtype=torch.float32, device=dev)
    k = torch.arange(bins + 1, **f32)
    lo32, w32 = torch.tensor(lo, **f32), torch.tensor((hi - lo) / bins, **f32)
    edges = torch.cat([lo32 + k * w32, (lo + torch.arange(
        bins + 1, dtype=torch.float64, device=dev) * ((hi - lo) / bins)).float()])
    inf = torch.tensor(float("inf"), **f32)
    hi32 = torch.tensor(hi, **f32)
    ends = torch.tensor([lo, hi, lo - 1.0, float("nan"), float("inf"),
                         float("-inf")], **f32)
    uniform = torch.rand(100_000, generator=gen, **f32) * (hi - lo + 2) + (lo - 1)
    return torch.cat([edges, torch.nextafter(edges, inf),
                      torch.nextafter(edges, -inf), ends,
                      torch.nextafter(hi32, inf).view(1), uniform])


def check_bits(what: str, k: torch.Tensor, r: torch.Tensor) -> None:
    same = k.shape == r.shape and k.dtype == r.dtype and torch.equal(bits(k), bits(r))
    print(f"  {what:42s} bit-exact {same}")
    if not same:
        diff = int((bits(k) != bits(r)).sum()) if k.shape == r.shape else -1
        fail(f"{what}: not bit-identical to the plain version ({diff} differ)")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def phase2(dev) -> None:
    from repro_torch.kernels.conv1d.conv1d import conv1d_hopper
    from repro_torch.kernels.conv1d.ref import conv1d_ref
    from repro_torch.kernels.ewise.ewise import ewise_hopper
    from repro_torch.kernels.ewise.ref import OP_REFS as EW_REFS
    from repro_torch.kernels.jacobi.jacobi import jacobi_hopper
    from repro_torch.kernels.jacobi.ops import jacobi_solve
    from repro_torch.kernels.jacobi.ref import jacobi_step_ref
    from repro_torch.kernels.matmul.matmul import mmm_hopper
    from repro_torch.kernels.matmul.ref import mmm_ref
    from repro_torch.kernels.mvm.mvm import mvm_hopper
    from repro_torch.kernels.mvm.ref import mvm_ref
    from repro_torch.kernels.vdp.ref import vdp_ref
    from repro_torch.kernels.vdp.vdp import vdp_hopper

    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, dtype, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) + shift).to(dtype)

    n_ew, n_mmm, n_mvm, n_vdp = SIZES["EW"], SIZES["MMM"], SIZES["MVM"], SIZES["VDP"]
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        for m, k, n in ((1000, 777, 1001), (1, 5, 3), (n_mmm, n_mmm, n_mmm)):
            a, b = rnd(m, k, dtype=dt), rnd(k, n, dtype=dt)
            check_close(f"MMM {name} {m}x{k}@{k}x{n}",
                        normwise(mmm_hopper(a, b), mmm_ref(a, b)), dt)
        ew_cases = [("1000x777", rnd(1000, 777, dtype=dt),
                     rnd(1000, 777, dtype=dt, shift=3.0)),
                    (f"{n_ew}x{n_ew}", rnd(n_ew, n_ew, dtype=dt),
                     rnd(n_ew, n_ew, dtype=dt, shift=3.0))]
        # offset views: pointers off the 16-byte grid take the scalar path
        flat_a, flat_b = rnd(100_003, dtype=dt), rnd(100_003, dtype=dt, shift=3.0)
        ew_cases.append(("unaligned 100002", flat_a[1:], flat_b[1:]))
        for label, a, b in ew_cases:
            for op, ref in EW_REFS.items():
                check_bits(f"EW {op} {name} {label}", ewise_hopper(a, b, op), ref(a, b))
        for m, k in ((1000, 777), (1000, 776), (n_mvm, n_mvm)):
            a, x = rnd(m, k, dtype=dt), rnd(k, dtype=dt)
            check_close(f"MVM {name} {m}x{k}", normwise(mvm_hopper(a, x), mvm_ref(a, x)), dt)
        for n in (1, 4099, 1_000_003, n_vdp):
            x, y, exact = vdp_exact_inputs(n, dt, gen, dev)
            k = vdp_hopper(x, y)
            check_bits(f"VDP {name} n={n} integers", k, vdp_ref(x, y))
            if float(k) != exact:
                fail(f"VDP {name} n={n}: {float(k)} != exact sum {exact}")
        for n in (1_000_003, n_vdp):
            x, y = rnd(n, dtype=dt, shift=1.0), rnd(n, dtype=dt, shift=1.0)
            check_close(f"VDP {name} n={n} mean 1",
                        relative(vdp_hopper(x, y), vdp_ref(x, y)), dt, VDP_TOL)
        x, y = rnd(1_000_003, dtype=dt), rnd(1_000_003, dtype=dt)
        first = vdp_hopper(x, y)
        if not all(torch.equal(first, vdp_hopper(x, y)) for _ in range(3)):
            fail(f"VDP {name}: repeated calls differ (expected the same bits)")
        print(f"  VDP {name} repeated calls give the same bits")
        # JS: ragged row counts (1001 also takes the scalar path), x ≠ 0
        for n in (1000, 1001, SIZES["JS"]):
            a, x, b = js_system(n, dt, gen, dev)
            check_js(f"JS {name} n={n}", jacobi_hopper(a, x, b),
                     jacobi_step_ref(a, x, b), a, x, b, dt)
        # 1DCONV: the last output tile is ragged at every N here
        n_conv = SIZES["1DCONV"]
        for n, k in ((1_000_003, 1), (1_000_003, 17), (1_000_003, 1025),
                     (1_000_003, 4097), (n_conv, 17)):
            x, w = rnd(n, dtype=dt), rnd(k, dtype=dt)
            check_bits(f"1DCONV {name} N={n} K={k}", conv1d_hopper(x, w),
                       conv1d_ref(x, w))
    # JS convergence on the phase-3 system, on its own terms (not against
    # the plain version)
    n = SIZES["JS"]
    a, _, b = js_system(n, torch.float32, gen, dev)
    x = jacobi_solve(a, b, iters=30)
    resid = float((a.double() @ x.double() - b.double()).norm() / b.double().norm())
    check_close(f"JS solve n={n}, 30 sweeps: ‖Ax−b‖/‖b‖", resid, torch.float32,
                JS_RESIDUAL)
    for dt in (torch.float32, torch.bfloat16):
        phase2_mmm_skinny(dev, gen, dt)
    for dt in (torch.bfloat16, torch.float16):
        phase2_mmm_wgmma(dev, gen, dt)
    phase2_mmm_tf32x3(dev, gen)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        phase2_smmm(dev, dt)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        phase2_fft(dev, gen, dt)
    for dt in (torch.float32, torch.bfloat16):
        phase2_hist(dev, gen, dt)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        phase2_ewise_plan(dev, gen, dt)
        phase2_sort(dev, gen, dt)
        phase2_sort_tile(dev, gen, dt)
        phase2_model(dev, gen, dt)
    for dt in (torch.bfloat16, torch.float16):
        phase2_fa_wgmma(dev, gen, dt)
    phase2_fa_tf32x3(dev, gen)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        phase2_fused(dev, gen, dt)
    phase2_ssd(dev, gen)
    phase2_hybrid(dev, gen)
    phase2_moe_mla(dev, gen)
    torch.cuda.synchronize(dev)


def ssd_inputs(bsz, seq, h, p, g, n, dt, gen, dev):
    """SSD operands as zamba2's Mamba block feeds them: x, b, c in ``dt``;
    dt = softplus(0.5·N(0,1) + dt_bias) with the model's dt_bias spread,
    a = −(1..H) (its a_log init) and d, all float32."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h, device=dev)))
    dtv = torch.nn.functional.softplus(0.5 * rnd(bsz, seq, h) + bias)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    return (rnd(bsz, seq, h, p).to(dt), dtv, a, rnd(bsz, seq, g, n).to(dt),
            rnd(bsz, seq, g, n).to(dt), rnd(h))


def phase2_ssd(dev, gen) -> None:
    """SSD's aten row (the chunked form, batched float32 products) against
    its torch row (the scan) on the card at zamba2's widths (SSD_SHAPES):
    y within ``TOL`` of its type (float32 with TF32 off), the float32 final
    state within SSD_STATE_TOL; and SSD_DECODE fed every step from a zero
    state against the scan's outputs and final state.  No kernel stands
    behind either alias: the reference has no Pallas SSD."""
    from repro_torch.kernels.ssd.ops import ssd_chunked, ssd_decode_step
    from repro_torch.kernels.ssd.ref import ssd_ref

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        for bsz, seq, h, p, g, n, q in SSD_SHAPES:
            x, dtv, a, b, c, d = ssd_inputs(bsz, seq, h, p, g, n, dt, gen, dev)
            y_scan, h_scan = ssd_ref(x, dtv, a, b, c, d, return_state=True)
            y, h_end = ssd_chunked(x, dtv, a, b, c, d, chunk=q, return_state=True)
            label = f"SSD aten {name} {bsz}x{seq}x{h}x{p} N{n}"
            if y.dtype != dt or h_end.dtype != torch.float32:
                fail(f"{label}: y {y.dtype}, state {h_end.dtype}")
            check_close(f"{label} y vs scan", normwise(y, y_scan), dt)
            check_close(f"{label} state vs scan", normwise(h_end, h_scan),
                        torch.float32, SSD_STATE_TOL)
            state, ys = torch.zeros_like(h_scan), []
            for t in range(seq):
                state, y_t = ssd_decode_step(state, x[:, t], dtv[:, t], a, b[:, t],
                                             c[:, t], d)
                ys.append(y_t)
            label = f"SSD_DECODE {name} {seq} steps"
            check_close(f"{label} y vs scan", normwise(torch.stack(ys, 1), y_scan), dt)
            check_close(f"{label} state vs scan", normwise(state, h_scan),
                        torch.float32, SSD_STATE_TOL)


def hybrid_projections(cfg):
    """(K, N) → launches per forward pass of zamba2's projections: each
    Mamba layer's z, x (d × d_in), BC (d × 2·G·N), dt (d × H) and out
    (d_in × d); each shared-block invocation's q, k, v, o and swiglu gate,
    up, down; the unembed (d × padded vocab)."""
    from repro_torch.models.ssm import ssm_dims

    d, per_pass = cfg.d_model, {}
    a, f = cfg.shared_attn, cfg.shared_d_ff

    def add(shapes, times):
        for kn in shapes:
            per_pass[kn] = per_pass.get(kn, 0) + times
    for st in cfg.stages:
        for b in st.pattern:
            if b.kind == "mamba":
                d_in, h, d_bc = ssm_dims(d, b.ssm)
                add([(d, d_in), (d, d_in), (d, d_bc), (d, h), (d_in, d)], st.repeats)
            else:
                add([(d, a.n_heads * a.head_dim), (d, a.n_kv_heads * a.head_dim),
                     (d, a.n_kv_heads * a.head_dim), (a.n_heads * a.head_dim, d),
                     (d, f), (d, f), (f, d)], st.repeats)
    add([(d, cfg.padded_vocab)], 1)
    return per_pass


def phase2_hybrid(dev, gen) -> None:
    """The kernels of the zamba2 leg at the shapes it gives them, bfloat16,
    against their plain versions within ``TOL``: MMM at every projection
    for the prefills' rows (the wgmma route) and the decode's 2 slots (the
    skinny route), two calls bit-identical; RMSNORM at d_model 2048 and the
    gated norm's d_in 4096 at the same row counts; FLASH_ATTN's mma route
    at 32 heads of 64 on 32 KV heads, causal, also against its plain model
    (MMA_MODEL_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import (
        fa_route, flash_attention_mma_hopper)
    from repro_torch.kernels.flash_attention.ref import attention_mma_ref, attention_ref
    from repro_torch.kernels.matmul.matmul import mmm_hopper, mmm_route
    from repro_torch.kernels.matmul.ref import mmm_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_hopper
    from repro_torch.models.ssm import ssm_dims

    dt = torch.bfloat16
    cfg = get_config(SERVE_HYBRID["arch"])
    rows = (SERVE_HYBRID["slots"],) + SERVE_HYBRID["prompt_lens"]
    for m in rows:
        for kk, n in hybrid_projections(cfg):
            if n == cfg.padded_vocab and m != SERVE_HYBRID["slots"]:
                continue                        # a prefill unembeds one row
            a = torch.randn((m, kk), generator=gen, device=dev).to(dt)
            b = (torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5).to(dt)
            out = mmm_hopper(a, b)
            check_close(f"MMM {mmm_route(dt, m)} bf16 {m}x{kk}@{kk}x{n}",
                        normwise(out, mmm_ref(a, b)), dt)
            if not torch.equal(bits(out), bits(mmm_hopper(a, b))):
                fail(f"MMM bf16 {m}x{kk}@{kk}x{n}: two calls differ (expected the same bits)")
    d_in = ssm_dims(cfg.d_model, cfg.stages[0].pattern[0].ssm)[0]
    for m in (1,) + rows:
        for d, eps in ((cfg.d_model, cfg.norm_eps), (d_in, 1e-6)):
            x = (torch.randn((m, d), generator=gen, device=dev) + 0.5).to(dt)
            g = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1.0).to(dt)
            check_close(f"RMSNORM bf16 {m}x{d} eps {eps:g}",
                        normwise(rmsnorm_hopper(x, g, eps), rmsnorm_ref(x, g, eps)), dt)
    a_cfg = cfg.shared_attn
    if fa_route(dt, a_cfg.head_dim) != "mma":
        fail(f"FLASH_ATTN bf16 at head dim {a_cfg.head_dim} routes to "
             f"{fa_route(dt, a_cfg.head_dim)}, not mma")
    for sq in SERVE_HYBRID["prompt_lens"]:
        q, k = (torch.randn((1, h, sq, a_cfg.head_dim), generator=gen, device=dev).to(dt)
                for h in (a_cfg.n_heads, a_cfg.n_kv_heads))
        v = (torch.randn((1, a_cfg.n_kv_heads, sq, a_cfg.head_dim), generator=gen,
                         device=dev) + 1.0).to(dt)
        out = flash_attention_mma_hopper(q, k, v, causal=True)
        what = f"FLASH_ATTN bf16 1x{a_cfg.n_heads}x{sq}x{a_cfg.head_dim} causal mma"
        check_close(what, normwise(out, attention_ref(q, k, v, causal=True)), dt)
        check_close(f"{what} vs model",
                    normwise(out, attention_mma_ref(q, k, v, causal=True)), dt,
                    MMA_MODEL_TOL[dt])


def moe_definition(p, x2, m):
    """The MoE layer by its definition, in float64, with routing of its
    own: softmax of float32 products of x2 and the router rounded to x2's
    type, the top k renormalised, each (token, k) row in flattened order
    kept while its expert has fewer than the capacity's rows, then per
    token Σ gate × SwiGLU expert + the shared experts (all of them).
    Returns (y (T,D) float64, expert indices (T,k), kept (T,k) bool)."""
    from repro_torch.models import moe
    probs = torch.softmax(x2.float() @ p["router"].to(x2.dtype).float(), dim=-1)
    gates, eidx = torch.topk(probs, m.top_k, dim=-1)
    gates = (gates / gates.sum(-1, keepdim=True)).double()
    fe = eidx.reshape(-1)
    onehot = torch.nn.functional.one_hot(fe, m.n_experts)
    earlier = (onehot.cumsum(0) * onehot).sum(1) - 1      # rows before, same expert
    kept = (earlier < moe._capacity(x2.shape[0], m)).reshape(eidx.shape)
    x = x2.double()
    y = torch.zeros_like(x)
    for e in range(m.n_experts):
        tok, j = torch.nonzero((eidx == e) & kept, as_tuple=True)
        if tok.numel():
            h = torch.nn.functional.silu(x[tok] @ p["we_g"][e].double()) \
                * (x[tok] @ p["we_u"][e].double())
            y.index_add_(0, tok, gates[tok, j, None] * (h @ p["we_d"][e].double()))
    sh = torch.nn.functional.silu(x @ p["ws_g"].double()) * (x @ p["ws_u"].double())
    return y + sh @ p["ws_d"].double(), eidx, kept


def phase2_moe_mla(dev, gen) -> None:
    """The MoE and MLA legs' shapes (no new kernel: MOE_FFN has no Pallas
    site; MLA runs FLASH_ATTN padded).  MOE_FFN's aten row against its
    torch row in bfloat16 (``TOL``) at moonshot's prefill and decode
    capacities, (64, 244, 2048) and (64, 4, 2048), d_ff 1408;
    ``moe_layer`` at moonshot's widths on the kernels (MMM for the shared
    experts) against ``moe_definition`` in float64 (``TOL``), at the decode
    slots' 4 tokens (the capacity: no drop possible) and 256 (capacity 32)
    whose first 64 tokens are one token repeated, so that its 6 experts
    overflow and rows are dropped, its routing equal to the definition's;
    ``_dispatch_indices`` and ``_gather_dispatch`` over 2048 tokens on the
    card bit-identical to the same calls on the CPU, for a router skewed so
    that experts 0 and 1 overflow; FLASH_ATTN at MLA's head dim 192,
    1×128×2048×192 bfloat16 (padded to 256) and float32 at 1×16×1024×192,
    and at the reduced MLA's 48 in both types, against ``attention_ref``
    at the real dim (``TOL``), each on the route ``fa_route`` names."""
    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention.flash_attention import (fa_route,
                                                                     flash_attention_hopper)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_ffn.ops import grouped_ffn
    from repro_torch.kernels.moe_ffn.ref import grouped_ffn_ref
    from repro_torch.models import moe

    bf = torch.bfloat16
    cfg = get_config(SERVE_MOE["arch"])
    d_model, m, seq = cfg.d_model, cfg.stages[1].pattern[0].moe, max(SERVE_MOE["prompt_lens"])
    specs = moe.moe_param_specs(d_model, m, bf)
    p = {n: (torch.randn(s.shape, generator=gen, device=dev)
             * s.shape[-2] ** -0.5).to(s.dtype) for n, s in specs.items()}
    for cap in (moe._capacity(seq, m), moe._capacity(SERVE_MOE["slots"], m)):
        xe = torch.randn((m.n_experts, cap, d_model), generator=gen, device=dev).to(bf)
        got = grouped_ffn(xe, p["we_g"], p["we_u"], p["we_d"])
        check_close(f"MOE_FFN aten vs torch {tuple(xe.shape)} bf16",
                    normwise(got, grouped_ffn_ref(xe, p["we_g"], p["we_u"], p["we_d"])), bf)
    halo.initialize()
    try:
        for t, repeat in ((SERVE_MOE["slots"], 1), (256, 64)):
            x = torch.randn((1, t, d_model), generator=gen, device=dev).to(bf)
            x[:, :repeat] = x[:, :1]
            y, _ = moe.moe_layer(p, x, m, "swiglu")
            _, eidx, _ = moe._route(x[0], p["router"], m)
            want, want_eidx, kept = moe_definition(p, x[0], m)
            if not torch.equal(eidx, want_eidx):
                fail(f"moe_layer at {t} tokens routes otherwise than its definition")
            if bool(kept.all()) != (repeat == 1):
                fail(f"moe_layer at {t} tokens: {int((~kept).sum())} rows dropped, "
                     f"expected {'none' if repeat == 1 else 'some'}")
            check_close(f"moe_layer {t} tokens vs its definition", normwise(y[0], want), bf)
    finally:
        halo.finalize()
    del p
    # the dispatch, card against CPU, two experts overflowing
    c = moe._capacity(seq, m)
    g = torch.Generator().manual_seed(0)
    x2 = (torch.randn(seq, d_model, generator=g) + 1.0).to(bf)
    router = torch.randn(d_model, m.n_experts, generator=g) * d_model ** -0.5
    router[:, :2] += 0.01                # every token's logits favour 0 and 1
    _, eidx, _ = moe._route(x2, router, m)
    slot, keep = moe._dispatch_indices(eidx, seq, c, m.n_experts)
    xe = moe._gather_dispatch(x2, slot, keep, m.n_experts, c, m.top_k)
    cs, ck = moe._dispatch_indices(eidx.to(dev), seq, c, m.n_experts)
    cxe = moe._gather_dispatch(x2.to(dev), cs, ck, m.n_experts, c, m.top_k)
    over = [int((eidx == e).sum()) for e in (0, 1)]
    if min(over) <= c or bool(keep.all()):
        fail(f"the skewed router did not overflow experts 0 and 1: {over} rows, capacity {c}")
    check_bits(f"_dispatch_indices slot, card vs CPU ({over} rows, capacity {c})",
               cs.cpu(), slot)
    check_bits("_dispatch_indices keep, card vs CPU", ck.cpu().long(), keep.long())
    check_bits("_gather_dispatch, card vs CPU", cxe.cpu(), xe)
    # FLASH_ATTN between the instantiated head dims, at the real dim
    mla = get_config(SERVE_MLA["arch"]).stages[0].pattern[0].attn
    d_qk = mla.head_dim + mla.rope_head_dim
    for (h, s, d, dt) in ((mla.n_heads, seq, d_qk, bf), (16, 1024, d_qk, torch.float32),
                          (16, 1024, 48, bf), (16, 1024, 48, torch.float32)):
        q, k, v = (torch.randn((1, h, s, d), generator=gen, device=dev).to(dt)
                   for _ in range(3))
        route = fa_route(dt, d)
        before = _cuda.launch_counts().get(f"flash_attention_{route}", 0)
        out = flash_attention_hopper(q, k, v, causal=True)
        if _cuda.launch_counts()[f"flash_attention_{route}"] != before + 1 \
                or out.shape != q.shape:
            fail(f"FLASH_ATTN at head dim {d} {dt} did not launch the {route} route once "
                 f"or returned {tuple(out.shape)}")
        check_close(f"FLASH_ATTN {route} 1x{h}x{s}x{d} padded vs plain",
                    normwise(out, attention_ref(q, k, v, causal=True)), dt)
        del q, k, v, out
    torch.cuda.synchronize(dev)


def phase2_mmm_skinny(dev, gen, dt) -> None:
    """The skinny-M route against its plain versions (``mmm_ref``, and
    ``mmm_splitk_ref``, which sums K in the kernel's own segments) within
    ``TOL``: every M up to SKINNY_M_MAX at danube's decode projections; a
    ragged N = 1001 with K = 777 (scalar loads), an N that is a multiple of
    4 but not of 8, a B off the 16-byte grid; two calls bit-identical."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.matmul.matmul import SKINNY_M_MAX, mmm_skinny_hopper
    from repro_torch.kernels.matmul.ref import mmm_ref, mmm_splitk_ref

    name = str(dt).split(".")[-1]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def check(label, a, b):
        k = mmm_skinny_hopper(a, b)
        check_close(f"{label} vs plain", normwise(k, mmm_ref(a, b)), dt)
        check_close(f"{label} vs split-K plain", normwise(k, mmm_splitk_ref(a, b)), dt)
        return k

    shapes = list(decode_projections(get_config(SERVE["arch"])))
    for m in sorted({1, 2, 4, 7, 8, 16, SKINNY_M_MAX}):
        a_by_k = {kk: rnd(m, kk) for kk in {kk for kk, _ in shapes}}
        for kk, n in shapes:
            check(f"MMM skinny {name} {m}x{kk}@{kk}x{n}", a_by_k[kk], rnd(kk, n))
    for m, kk, n in ((1, 777, 1001), (4, 777, 1001), (16, 777, 1001), (4, 2560, 2564)):
        check(f"MMM skinny {name} {m}x{kk}@{kk}x{n}", rnd(m, kk), rnd(kk, n))
    b = rnd(2560 * 640 + 1)[1:].view(2560, 640)
    if b.data_ptr() % 16 == 0:
        fail("MMM skinny: the offset view of B is 16-byte aligned")
    a = rnd(4, 2560)
    check(f"MMM skinny {name} 4x2560@2560x640 unaligned B", a, b)
    b = rnd(2560, 6912)
    first = mmm_skinny_hopper(a, b)
    if not torch.equal(bits(first), bits(mmm_skinny_hopper(a, b))):
        fail(f"MMM skinny {name}: two calls differ (expected the same bits)")
    print(f"  MMM skinny {name} 4x2560@2560x6912: two calls give the same bits")


def prefill_projections(cfg):
    """(K, N) → launches per prefill of danube's projections: the decode
    pass's less the unembed (a prefill unembeds its last row alone)."""
    shapes = decode_projections(cfg)
    del shapes[(cfg.d_model, cfg.padded_vocab)]
    return shapes


def phase2_mmm_wgmma(dev, gen, dt) -> None:
    """The tensor-core route against ``mmm_ref`` within ``TOL`` and, element
    by element, within half an output ulp (plus a float32 sum-order term)
    of the float32 product of the same inputs (``mmm_ulp_excess``; ``TOL``
    alone would pass a lost K stage, a wrong swizzle or rounding toward
    zero): danube's eight prefill projections, ragged M, N and K (TMA
    zero-fills past each), 4096³, and operands TMA cannot load as they lie,
    which the route packs first (``wgmma_packs``): K or N off a multiple of
    8, odd N, A or B one element into a buffer, off the 16-byte grid; the
    largest ratio to that bound is printed; two calls bit-identical, at an
    aligned and at a packed shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.matmul.matmul import mmm_wgmma_hopper, wgmma_packs
    from repro_torch.kernels.matmul.ref import mmm_ref, mmm_ulp_ratios

    name = str(dt).split(".")[-1]
    shapes = [(m, kk, n, 0) for m in SERVE["prompt_lens"]
              for kk, n in prefill_projections(get_config(SERVE["arch"]))]
    shapes += [(130, 72, 136, 0), (65, 8, 8, 0), (SIZES["MMM"],) * 3 + (0,)]
    # off TMA's grid: (M, K, N, 1 when A and B are views one element in)
    shapes += [(*PACKED_MMM, 0), (130, 75, 137, 0), (300, 17, 259, 0), (200, 8, 13, 0),
               (65, 1, 1, 0), (100, 64, 64, 1), (512, 2560, 640, 1), (130, 75, 137, 1)]
    for m, kk, n, off in shapes:
        a = torch.randn(m * kk + off, generator=gen, device=dev).to(dt)[off:].view(m, kk)
        b = torch.randn(kk * n + off, generator=gen, device=dev).to(dt)[off:].view(kk, n)
        packs = wgmma_packs(kk, n, a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0)
        out = mmm_wgmma_hopper(a, b)
        label = (f"MMM wgmma {name} {m}x{kk}@{kk}x{n}"
                 + "".join(f" {w} packed" for w, p in zip("AB", packs) if p))
        if out.shape != (m, n) or out.dtype != dt:
            fail(f"{label}: {tuple(out.shape)} {out.dtype}")
        check_close(f"{label} vs plain", normwise(out, mmm_ref(a, b)), dt)
        ratios = mmm_ulp_ratios(out, a, b)
        excess = int((ratios > 1).sum())
        print(f"  {label:42s} {excess} of {out.numel()} past half an ulp of the "
              f"float32 product; largest ratio to the bound {float(ratios.max()):.4f}")
        if excess:
            fail(f"{label}: {excess} elements lie past half an ulp of the float32 product")
        if (m, kk, n) in ((SIZES["MMM"],) * 3, PACKED_MMM):
            if not torch.equal(bits(out), bits(mmm_wgmma_hopper(a, b))):
                fail(f"{label}: two calls differ (expected the same bits)")
            print(f"  {label}: two calls give the same bits")


def phase2_mmm_tf32x3(dev, gen) -> None:
    """The 3×TF32 route against ``mmm_ref``, a float64 product of the same
    inputs and its plain model ``mmm_tf32x3_ref`` (the three float32
    products of the TF32 parts) within ``TOL``: 4096³, the float32 replay's
    four 512-row prefill projections, ragged M, N and K, every K and N in
    {1, 3, 5, 4094, 4095} (the split pass pads rows to a multiple of 4 and
    the epilogue stores odd N one value at a time), M = 65, the lone
    request's shape and A and B one element into a buffer, off the 16-byte
    grid; each shape's error against float64 printed beside
    ``torch.matmul``'s (TF32 off); ±inf, NaN and
    ±FLT_MAX inputs at an off-grid shape against ``mmm_ref``; two calls
    bit-identical, at 4096³ and at the lone request's shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.matmul.matmul import mmm_tf32x3_hopper
    from repro_torch.kernels.matmul.ref import mmm_ref, mmm_tf32x3_ref

    dt = torch.float32
    shapes = [(SERVE["prompt_lens"][0], kk, n, 0)
              for kk, n in prefill_projections(get_config(SERVE["arch"]))]
    shapes += [(1000, 772, 1004, 0), (130, 72, 136, 0), (65, 2560, 640, 0), (65, 8, 4, 0),
               (SIZES["MMM"],) * 3 + (0,), (*LONE_MMM, 0), (1000, 777, 1001, 1),
               (130, 75, 137, 1)]
    shapes += [(130, kk, n, 0) for kk in (1, 3, 5, 4094, 4095) for n in (1, 3, 5, 4094, 4095)]
    for m, kk, n, off in shapes:
        a = torch.randn(m * kk + off, generator=gen, device=dev)[off:].view(m, kk)
        b = torch.randn(kk * n + off, generator=gen, device=dev)[off:].view(kk, n)
        out = mmm_tf32x3_hopper(a, b)
        label = f"MMM tf32x3 float32 {m}x{kk}@{kk}x{n}" + (" off the grid" if off else "")
        if out.shape != (m, n) or out.dtype != dt:
            fail(f"{label}: {tuple(out.shape)} {out.dtype}")
        exact = a.double() @ b.double()
        e64, e_lib = normwise(out, exact), normwise(torch.matmul(a, b), exact)
        check_close(f"{label} vs plain", normwise(out, mmm_ref(a, b)), dt)
        check_close(f"{label} vs float64 (torch.matmul {e_lib:.2e})", e64, dt)
        check_close(f"{label} vs model", normwise(out, mmm_tf32x3_ref(a, b)), dt)
        del exact
        if (m, kk, n) in ((SIZES["MMM"],) * 3, LONE_MMM):
            if not torch.equal(bits(out), bits(mmm_tf32x3_hopper(a, b))):
                fail(f"{label}: two calls differ (expected the same bits)")
            print(f"  {label}: two calls give the same bits")
    a, b = non_finite_operands(gen, dev, 130, 75, 137)
    out, want = mmm_tf32x3_hopper(a, b), mmm_ref(a, b)
    label = "MMM tf32x3 float32 130x75@75x137 ±inf, NaN, ±FLT_MAX"
    inf = torch.isinf(want)
    finite = torch.isfinite(want)
    err = (out.double() - a.double() @ b.double()).abs()
    scale = a.double().abs() @ b.double().abs()
    worst = float((err[finite] / scale[finite].clamp_min(1e-300)).max())
    print(f"  {label}: {int(torch.isnan(want).sum())} NaN, {int(inf.sum())} ±inf in "
          f"mmm_ref; finite entries within {worst:.3e} of (|A|·|B|)_ij")
    if not (torch.equal(torch.isnan(out), torch.isnan(want))
            and torch.equal(torch.isinf(out), inf) and torch.equal(out[inf], want[inf])):
        fail(f"{label}: NaN or ±inf where mmm_ref has none, or the reverse")
    if not worst <= TOL[dt]:
        fail(f"{label}: a finite entry errs by {worst:.3e} of (|A|·|B|)_ij")


def phase2_smmm(dev, dt) -> None:
    """SMMM's tensor-core kernel against its plain version
    (``smmm_bell_ref``, ``TOL``), its plain model (``smmm_tf32x3_ref``,
    ``SMMM_MODEL_TOL``) and, in float32, a float64 product
    (``SMMM_F64_TOL``, printed beside the plain version's own error): the
    template's 64x128 blocks with N off the 256-column tile, (bm, bk) off 64
    and 32 (the split pass pads), N = 1, and an index row of 1100 slots of
    16x8 blocks (a tenth of them pads, block columns repeated), each far
    past one warp's ballot of 32 slots; pad slots hold ``PAD_FILL`` and
    block row 0 holds only pads (its rows must be exactly 0); two calls
    bit-identical; in float32, ±inf and NaN in kept blocks and in B, NaN
    and ±inf where ``smmm_bell_ref`` has them and finite entries within
    ``TOL`` of (|A|·|B|)_ij."""
    from repro_torch.kernels.spmm.ref import bell_to_dense, smmm_bell_ref, smmm_tf32x3_ref
    from repro_torch.kernels.spmm.spmm import smmm_hopper

    name = str(dt).split(".")[-1]
    gen = torch.Generator(device=dev).manual_seed(10)
    m8 = SIZES["SMMM"]
    cases = []
    for m, k, n, bm, bk in ((1024, 1024, 1000, 64, 128), (m8, m8, m8 // 2 + 77, 64, 128),
                            (200, 120, 70, 100, 40), (64, 128, 1, 32, 128),
                            (384, 256, 300, 128, 64), (390, 99, 257, 65, 33)):
        values, indices, b = bell_inputs(m, k, n, bm, bk, 0.25 if m == m8 else 0.4, dt,
                                         gen, dev)
        cases.append((f"{m}x{k}@{k}x{n} in {bm}x{bk}", values, indices, b, True, m == m8))
    k_long = 1200 * 8
    values = torch.randn((3, 1100, 16, 8), generator=gen, device=dev).to(dt)
    indices = torch.randint(0, 1200, (3, 1100), generator=gen, device=dev, dtype=torch.int32)
    indices[:, ::10] = -1
    values[indices < 0] = PAD_FILL
    cases.append(("(3, 1100, 16, 8) @ 9600x300, 1100 slots a row", values, indices,
                  torch.randn((k_long, 300), generator=gen, device=dev).to(dt), False, True))
    for label, values, indices, b, pad_row, repeat in cases:
        label = f"SMMM {name} {label}"
        out = smmm_hopper(values, indices, b)
        bm = values.shape[2]
        if out.shape != (values.shape[0] * bm, b.shape[1]) or out.dtype != dt:
            fail(f"{label}: {tuple(out.shape)} {out.dtype}")
        if pad_row and bool(out[:bm].any()):
            fail(f"{label}: the all-pad block row is not 0")
        plain = smmm_bell_ref(values, indices, b)
        check_close(f"{label} vs plain", normwise(out, plain), dt)
        check_close(f"{label} vs model", normwise(out, smmm_tf32x3_ref(values, indices, b)),
                    dt, SMMM_MODEL_TOL[dt])
        if dt == torch.float32:
            exact = bell_to_dense(values, indices, b.shape[0]).double() @ b.double()
            check_close(f"{label} vs float64 (plain {normwise(plain, exact):.2e})",
                        normwise(out, exact), dt, SMMM_F64_TOL)
            del exact
        if repeat:
            if not torch.equal(bits(out), bits(smmm_hopper(values, indices, b))):
                fail(f"{label}: two calls differ (expected the same bits)")
            print(f"  {label}: two calls give the same bits")
    if dt != torch.float32:
        return
    # ±inf and NaN in kept blocks and in B, in the 1024 case
    _, values, indices, b, _, _ = cases[0]
    values, b = values.clone(), b.clone()
    rows, slots = (indices >= 0).nonzero(as_tuple=True)
    for j, x in enumerate((float("inf"), float("-inf"), float("nan"))):
        values[rows[3 * j + 1], slots[3 * j + 1], 5 + j, 7 + j] = x
    b[200, 17], b[900, 400] = float("inf"), float("-inf")
    out, want = smmm_hopper(values, indices, b), smmm_bell_ref(values, indices, b)
    label = f"SMMM {name} 1024 ±inf, NaN"
    inf, finite = torch.isinf(want), torch.isfinite(want)

    def kept_sum(f):
        """Σ over the kept slots of f(value block) @ f(B's rows) in float64
        (a dense product would meet B's infinities with A's zeros)."""
        b3 = f(b.double()).reshape(-1, values.shape[3], b.shape[1])
        acc = 0
        for s_ in range(indices.shape[1]):
            idx = indices[:, s_].long()
            acc = acc + torch.where((idx >= 0)[:, None, None],
                                    f(values[:, s_].double()) @ b3[idx.clamp(min=0)], 0.0)
        return acc.reshape(out.shape)

    err = (out.double() - kept_sum(lambda x: x)).abs()
    scale = kept_sum(torch.abs)
    worst = float((err[finite] / scale[finite].clamp_min(1e-300)).max())
    print(f"  {label}: {int(torch.isnan(want).sum())} NaN, {int(inf.sum())} ±inf in "
          f"smmm_bell_ref; finite entries within {worst:.3e} of (|A|·|B|)_ij")
    if not (torch.equal(torch.isnan(out), torch.isnan(want))
            and torch.equal(torch.isinf(out), inf) and torch.equal(out[inf], want[inf])):
        fail(f"{label}: NaN or ±inf where smmm_bell_ref has none, or the reverse")
    if not worst <= TOL[dt]:
        fail(f"{label}: a finite entry errs by {worst:.3e} of (|A|·|B|)_ij")


def non_finite_operands(gen, dev, m, k, n):
    """Normal float32 A (m, k) and B (k, n) with ±inf and NaN entries, and
    ±FLT_MAX entries whose products stay finite (times 1/8 to 1/4) or
    overflow (times 2 to 4), in rows of A and in a column of B, as
    tests/test_torch_cuda.py holds them.  No overflowing product meets an
    infinite column: whether inf plus an overflowed product is inf or NaN
    then hangs on the sum's order."""
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    big = torch.finfo(torch.float32).max

    def signed(lo, hi, size):
        u = torch.rand(size, generator=gen, device=dev) * (hi - lo) + lo
        return torch.where(torch.rand(size, generator=gen, device=dev) < 0.5, -u, u)

    a[1, 5], a[2, 9], a[4, 0] = float("inf"), float("-inf"), float("nan")
    b[7, 3], b[8, 6] = float("inf"), float("-inf")
    a[3, 11], b[11] = big, signed(0.125, 0.25, n)
    a[5, 12], b[12] = -big, signed(2.0, 4.0, n)
    b[12, [3, 6]] = 0.5
    b[13, 10], a[:, 13] = big, signed(0.125, 0.25, m)
    return a, b


def phase2_fft(dev, gen, dt) -> None:
    """FFT against torch.fft.fft of the same input in float64 and against
    its plain version, at 1, 3 and 2048 rows and 1-D: the radix route at
    every n = 2^j up to 4096, the chirp route at CHIRP_N, each with an x
    off the 16-byte grid; two calls of each route bit-identical."""
    from repro_torch.kernels.fft.fft import fft_chirp_hopper, fft_radix_hopper
    from repro_torch.kernels.fft.ops import cached_chirp_tables, cached_radix_twiddles
    from repro_torch.kernels.fft.ref import fft_chirp_ref, fft_radix_ref

    name = str(dt).split(".")[-1]

    def check(label, k, x, ref):
        check_close(f"{label} vs float64",
                    normwise(k, torch.fft.fft(x.double(), dim=-1)), dt, FFT_TOL)
        check_close(f"{label} vs plain", normwise(k, ref), dt, FFT_TOL)

    def repeatable(label, fn, x):
        if not torch.equal(torch.view_as_real(fn(x)), torch.view_as_real(fn(x))):
            fail(f"{label}: two calls differ (expected the same bits)")
        print(f"  {label}: two calls give the same bits")

    shapes = ((1,), (3,), (2048,), ())
    for j in range(13):
        n = 1 << j
        tw = cached_radix_twiddles(n, dev)
        for rows in shapes:
            x = torch.randn((*rows, n), generator=gen, device=dev).to(dt)
            check(f"FFT radix {name} {'x'.join(map(str, (*rows, n)))}",
                  fft_radix_hopper(x, tw), x, fft_radix_ref(x, tw))
    x = torch.randn(3 * 4096 + 1, generator=gen, device=dev).to(dt)[1:].view(3, 4096)
    tw = cached_radix_twiddles(4096, dev)
    check(f"FFT radix {name} 3x4096 unaligned", fft_radix_hopper(x, tw), x,
          fft_radix_ref(x, tw))
    repeatable(f"FFT radix {name} 3x4096", lambda x_: fft_radix_hopper(x_, tw), x)
    for n in CHIRP_N:
        tables = cached_chirp_tables(n, dev)
        for rows in shapes:
            x = torch.randn((*rows, n), generator=gen, device=dev).to(dt)
            check(f"FFT chirp {name} {'x'.join(map(str, (*rows, n)))}",
                  fft_chirp_hopper(x, tables), x, fft_chirp_ref(x, tables))
    x = torch.randn(3 * 2999 + 1, generator=gen, device=dev).to(dt)[1:].view(3, 2999)
    if x.data_ptr() % 16 == 0:
        fail("FFT chirp: the offset view is 16-byte aligned")
    tables = cached_chirp_tables(2999, dev)
    check(f"FFT chirp {name} 3x2999 unaligned", fft_chirp_hopper(x, tables), x,
          fft_chirp_ref(x, tables))
    x = torch.randn((2048, DFT_N), generator=gen, device=dev).to(dt)
    tables = cached_chirp_tables(DFT_N, dev)
    repeatable(f"FFT chirp {name} 2048x{DFT_N}", lambda x_: fft_chirp_hopper(x_, tables), x)


def phase2_sort(dev, gen, dt) -> None:
    """SORT bit-exact against its plain version across the tile boundary,
    on ragged and many rows, on duplicates; NaN last beside ±inf and ±0.
    The radix route also on its own terms: rows that skip digit passes
    (16-bit types, integers 0–15, a constant row) and negative-only rows,
    bit-exact with the plain version, its plain model and, for rows that
    fit one tile, the tile route."""
    from repro_torch.kernels.sorthist.ref import sort_radix_ref, sort_ref
    from repro_torch.kernels.sorthist.sorthist import (SORT_TILE, sort_hopper,
                                                       sort_radix_hopper, sort_route,
                                                       sort_tile_hopper)

    name = str(dt).split(".")[-1]
    # rows of at most SORT_TILE places sort in one block (the tile route),
    # longer ones take the radix route
    tile = SORT_TILE
    shapes = [(n,) for n in (1, 2, 127, 128, 129, tile, tile + 1, (1 << 20) + 3,
                             SIZES["SORT"])]
    shapes += [(5, 129), (5, tile + 1), (5, (1 << 20) + 3), (4096, 4096)]
    for shape in shapes:
        x = torch.randn(shape, generator=gen, device=dev).to(dt)
        check_bits(f"SORT {name} {'x'.join(map(str, shape))}", sort_hopper(x),
                   sort_ref(x))
    for shape in ((1 << 20) + 3,), (4096, 4096), (3, 2, 1000):
        x = torch.randint(0, 16, shape, generator=gen, device=dev).to(dt)
        check_bits(f"SORT {name} {'x'.join(map(str, shape))} duplicates",
                   sort_hopper(x), sort_ref(x))
    specials = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0,
                             -float("nan")], device=dev)
    for n in (1000, tile + 1, (1 << 20) + 3):
        x = torch.randn((2, n), generator=gen, device=dev)
        place = torch.randperm(n, generator=gen, device=dev)[:3 * specials.numel()]
        x[:, place] = specials.repeat(3)
        x = x.to(dt)
        k, r = sort_hopper(x), sort_ref(x)
        nans = int(x[0].isnan().sum())
        ok = same_values(k, r) and bool(k[:, n - nans:].isnan().all()) \
            and not bool(k[:, :n - nans].isnan().any())
        print(f"  {f'SORT {name} 2x{n} NaN, ±inf, ±0':42s} NaN last, values "
              f"of the plain version {ok}")
        if not ok:
            fail(f"SORT {name} 2x{n} with NaN, ±inf and ±0: not NaN-last or "
                 f"not the plain version's values")
        # the radix route orders −0 before +0, as its key order has it
        check_bits(f"SORT radix {name} 2x{n} NaN, ±inf, ±0 vs model",
                   sort_radix_hopper(x), sort_radix_ref(x))
    # the radix route on its own terms, at rows that take every pass, skip
    # passes (integers 0–15; 16-bit types), skip them all (a constant row),
    # hold only negatives, and start off the 16-byte grid
    cases = {"normal": lambda s: torch.randn(s, generator=gen, device=dev),
             "integers 0-15": lambda s: torch.randint(0, 16, s, generator=gen,
                                                      device=dev).float(),
             "negative only": lambda s: -1.0 - torch.rand(s, generator=gen, device=dev),
             "constant": lambda s: torch.full(s, -0.75, device=dev)}
    for label, make in cases.items():
        for shape in ((3, 4097), (2, tile + 1), (3, 70_001), (SIZES["SORT"],)):
            x = make(shape).to(dt)
            what = f"SORT radix {name} {'x'.join(map(str, shape))} {label}"
            k = sort_radix_hopper(x)
            check_bits(f"{what} vs plain", k, sort_ref(x))
            check_bits(f"{what} vs model", k, sort_radix_ref(x))
            if sort_route(shape[-1]) == "tile":
                check_bits(f"{what} vs tile route", k, sort_tile_hopper(x))
    x = torch.randn(3 * 20_001 + 1, generator=gen, device=dev).to(dt)[1:].view(3, 20_001)
    if x.data_ptr() % 16 == 0:
        fail("SORT radix: the offset view is 16-byte aligned")
    check_bits(f"SORT radix {name} 3x20001 unaligned", sort_radix_hopper(x), sort_ref(x))


def phase2_ewise_plan(dev, gen, dt) -> None:
    """EW* at the edges of its launch plan (``ewise_plan``), every op:
    n = 1, one 16-byte vector ± 1, one block's vectors ± 1 at 1 and at 4
    vectors a thread, a block for every SM at 4 a thread ± 1 (where the
    plan turns to 4), 8192² + 3, and a view off the 16-byte grid; bit-exact
    with the plain version and with the plan's plain model
    (``ewise_plan_ref``, NaN wherever the plan does not write)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.ewise.ewise import ITEMS, THREADS, ewise_hopper, ewise_plan
    from repro_torch.kernels.ewise.ref import OP_REFS as EW_REFS
    from repro_torch.kernels.ewise.ref import ewise_plan_ref

    name = str(dt).split(".")[-1]
    v, sms = 16 // dt.itemsize, _cuda.sm_count(dev)
    ns = {1, v - 1, v, v + 1, SIZES["EW"] ** 2 + 3}
    for u in ITEMS:
        for items in (u * THREADS, u * THREADS * sms):
            ns |= {items * v - 1, items * v, items * v + 1}
    cases = []
    for n in sorted(k for k in ns if k >= 1):
        cases.append((f"n={n}", torch.randn(n, generator=gen, device=dev).to(dt),
                      (torch.randn(n, generator=gen, device=dev) + 3.0).to(dt)))
    flat = torch.randn(2 * 100_004, generator=gen, device=dev).to(dt)
    cases.append(("unaligned 100003", flat[1:100_004], flat[100_005:]))
    for label, a, b in cases:
        plan = ewise_plan(a.numel(), dt, _cuda.aligned(a, b), sms)
        for op, ref in EW_REFS.items():
            k = ewise_hopper(a, b, op)
            what = f"EW {op} {name} {label} plan {tuple(plan)}"
            same = torch.equal(bits(k), bits(ref(a, b))) and torch.equal(
                bits(k), bits(ewise_plan_ref(a, b, op, plan)))
            if not same:
                fail(f"{what}: not bit-identical to the plain version and the plan's model")
        print(f"  {f'EW {name} {label}':42s} plan {tuple(plan)}: 4 ops bit-exact with "
              f"the plain version and the plan's model")
        del a, b


def phase2_sort_tile(dev, gen, dt) -> None:
    """SORT's tile route under its launch plan (``sort_tile_plan``): 3 rows
    at every power of two from 1 to SORT_TILE and one ragged length below
    each; 1000 rows of 256 and 77 of 1000 (several rows a block); rows off
    the 16-byte grid; NaN of both signs, ±inf and ±0; duplicates.  Each
    bit-exact with the plain version (rows with ±0 by value: the kernel
    orders −0 first) and with the plan's plain model (``sort_tile_ref``),
    and two calls give the same bits."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.sorthist.ref import sort_ref, sort_tile_ref
    from repro_torch.kernels.sorthist.sorthist import (SORT_TILE, sort_tile_hopper,
                                                       sort_tile_plan)

    name = str(dt).split(".")[-1]
    sms = _cuda.sm_count(dev)

    def check(label, x, by_value=False):
        n = x.shape[-1]
        plan = sort_tile_plan(x.numel() // n, n, sms)
        k = sort_tile_hopper(x)
        r = sort_ref(x)
        plain = same_values(k, r) if by_value else torch.equal(bits(k), bits(r))
        model = torch.equal(bits(k), bits(sort_tile_ref(x, plan)))
        again = torch.equal(bits(k), bits(sort_tile_hopper(x)))
        print(f"  {f'SORT tile {name} {label}':42s} plan {tuple(plan)}: plain version "
              f"{plain}, model {model}, repeatable {again}")
        if not (plain and model and again):
            fail(f"SORT tile {name} {label}: plain version {plain}, model {model}, "
                 f"repeatable {again}")

    lengths = sorted({m for p in range(SORT_TILE.bit_length())
                      for m in (1 << p, (1 << p) - 1) if m >= 1})
    for n in lengths:
        check(f"3x{n}", torch.randn((3, n), generator=gen, device=dev).to(dt))
    for rows, n in ((1000, 256), (77, 1000)):
        check(f"{rows}x{n}", torch.randn((rows, n), generator=gen, device=dev).to(dt))
    for n in (100, 4096):
        x = torch.randn(3 * n + 1, generator=gen, device=dev).to(dt)[1:].view(3, n)
        if x.data_ptr() % 16 == 0:
            fail("SORT tile: the offset view is 16-byte aligned")
        check(f"3x{n} unaligned", x)
    specials = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0,
                             -float("nan")], device=dev)
    for n in (100, 4096, SORT_TILE):
        x = torch.randn((2, n), generator=gen, device=dev)
        place = torch.randperm(n, generator=gen, device=dev)[:3 * specials.numel()]
        x[:, place] = specials.repeat(3)
        x = x.to(dt)
        check(f"2x{n} NaN, ±inf, ±0", x, by_value=True)
        nans = int(x[0].isnan().sum())
        k = sort_tile_hopper(x)
        if not (bool(k[:, n - nans:].isnan().all()) and not bool(k[:, :n - nans].isnan().any())):
            fail(f"SORT tile {name} 2x{n}: NaN not last")
    for shape in ((3, 1000), (4096, 4096)):
        x = torch.randint(0, 16, shape, generator=gen, device=dev).to(dt)
        check(f"{'x'.join(map(str, shape))} duplicates", x)


def phase2_hist(dev, gen, dt) -> None:
    """HIST bit-exact against its plain version: 2^26 values, edge values at
    several bin counts and ranges, and every value in one bin."""
    from repro_torch.kernels.sorthist.ref import hist_ref
    from repro_torch.kernels.sorthist.sorthist import hist_hopper

    name = str(dt).split(".")[-1]
    x = torch.sigmoid(torch.randn(SIZES["HIST"], generator=gen, device=dev)).to(dt)
    check_bits(f"HIST {name} n={x.numel()}", hist_hopper(x), hist_ref(x))
    # (10, -2, 3) has a width of 0.5; (7, -2, 3) and (1000, 0, 1) have
    # widths that float32 does not hold exactly
    for bins, lo, hi in ((1, 0.0, 1.0), (64, 0.0, 1.0), (1000, 0.0, 1.0),
                         (65536, 0.0, 1.0), (10, -2.0, 3.0), (7, -2.0, 3.0)):
        x = hist_edge_inputs(bins, lo, hi, gen, dev).to(dt)
        k = hist_hopper(x, bins=bins, lo=lo, hi=hi)
        check_bits(f"HIST {name} bins={bins} [{lo}, {hi}] edges", k,
                   hist_ref(x, bins=bins, lo=lo, hi=hi))
    x = torch.full(((1 << 24) - 1,), 0.3, device=dev).to(dt)
    k = hist_hopper(x)
    check_bits(f"HIST {name} one bin, n=2^24-1", k, hist_ref(x))
    if float(k.max()) != x.numel():
        fail(f"HIST {name} one bin: {float(k.max())} != {x.numel()}")


#: phase 2: FLASH_ATTN masks at (1, 32, Sq, 80) with 8 KV heads
FA_MASKS = {"causal": dict(sq=1024, causal=True, window=None, prefix_len=0),
            "causal window 256": dict(sq=1024, causal=True, window=256, prefix_len=0),
            "prefix 64 window 256": dict(sq=1024, causal=True, window=256,
                                         prefix_len=64),
            "Sq 17 < Skv 1024": dict(sq=17, causal=True, window=None, prefix_len=0)}


def phase2_model(dev, gen, dt) -> None:
    """RMSNORM and FLASH_ATTN's mma route against their plain versions at the
    model path's widths (danube: d_model 2560, 32 heads of 80 over 8 KV
    heads)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        fa_route, flash_attention_mma_hopper)
    from repro_torch.kernels.flash_attention.ref import attention_mma_ref, attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_hopper, rmsnorm_plan

    name = str(dt).split(".")[-1]
    # the model path's row counts (one row, decode's 4 slots, the two
    # prefills, phase 4's 4096) under the launch plan, two calls the same
    # bits; and rows of 80 (one warp a row) and 1000 (a row split over warps)
    for rows, d in ((1, 2560), (4, 2560), (512, 2560), (4096, 2560), (4200, 2560), (3, 80),
                    (7, 1000)):
        x = (torch.randn((rows, d), generator=gen, device=dev) + 0.5).to(dt)
        g = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1.0).to(dt)
        out = rmsnorm_hopper(x, g, 1e-5)
        plan = rmsnorm_plan(rows, d, x.element_size(), _cuda.sm_count(dev))
        check_close(f"RMSNORM {name} {rows}x{d} (plan {tuple(plan)})",
                    normwise(out, rmsnorm_ref(x, g, 1e-5)), dt)
        if not torch.equal(bits(out), bits(rmsnorm_hopper(x, g, 1e-5))):
            fail(f"RMSNORM {name} {rows}x{d}: two calls differ (expected the same bits)")
    # v has mean 1: with zero-mean v, attention spread over ~1000 keys
    # returns a sum ~30x smaller than its terms, and float32 reordering alone
    # then moves it by ~1e-5; a dropped tile of 64 keys still moves it ~1e-3.
    # With mean 1, on the H100, a dropped first key tile reads ≥ 1e-2 and one
    # key too many masked at the window's edge ≥ 4e-3 (MMA_MODEL_TOL).
    # 16-bit types: the tensor-core route, against the plain version and its
    # plain model (p rounded to the input type per 64-key tile)
    skv = 1024
    k = torch.randn((1, 8, skv, 80), generator=gen, device=dev).to(dt)
    v = (torch.randn((1, 8, skv, 80), generator=gen, device=dev) + 1.0).to(dt)
    for label, c in FA_MASKS.items():
        q = torch.randn((1, 32, c["sq"], 80), generator=gen, device=dev).to(dt)
        kw = dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])
        ref = attention_ref(q, k, v, **kw)
        what = f"FLASH_ATTN {name} 1x32x{c['sq']}x80 {label}"
        if fa_route(dt, 80) == "mma":
            out = flash_attention_mma_hopper(q, k, v, **kw)
            check_close(f"{what} mma", normwise(out, ref), dt)
            check_close(f"{what} mma vs model",
                        normwise(out, attention_mma_ref(q, k, v, **kw)), dt,
                        MMA_MODEL_TOL[dt])


def phase2_fa_wgmma(dev, gen, dt) -> None:
    """FLASH_ATTN's wgmma route (bfloat16 and float16 at head dim 256)
    against the plain version (``TOL``) and its plain model
    ``attention_mma_ref`` with 64-key tiles (``MMA_MODEL_TOL``) at gemma3-4b's
    widths (8 heads of 256 over 4 KV heads) under ``FA_MASKS``, two calls
    bit-identical; at the served leg's shape (2048 tokens, window 1024);
    over a row of 8192 keys; at paligemma-3b's prefill (2×8 heads on 1 KV
    head, 512 rows, causal with a prefix of 256); beside a NaN in the next KV head's first key;
    on operands off the 16-byte grid (copied to an
    aligned workspace first); and as the first CUDA work of a new host
    thread (its tensor maps need the device's context there)."""
    import threading

    from repro_torch.kernels.flash_attention.flash_attention import (
        fa_route, flash_attention_wgmma_hopper)
    from repro_torch.kernels.flash_attention.ref import attention_mma_ref, attention_ref

    name = str(dt).split(".")[-1]
    if fa_route(dt, 256) != "wgmma":
        fail(f"{name} FLASH_ATTN at head dim 256 takes the {fa_route(dt, 256)} route, "
             f"not wgmma")

    def rnd(*shape, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) + shift).to(dt)

    def check(what, q, k, v, **kw):
        out = flash_attention_wgmma_hopper(q, k, v, **kw)
        check_close(f"FLASH_ATTN {name} {what} wgmma", normwise(out, attention_ref(q, k, v, **kw)),
                    dt)
        check_close(f"FLASH_ATTN {name} {what} wgmma vs model",
                    normwise(out, attention_mma_ref(q, k, v, **kw)), dt, MMA_MODEL_TOL[dt])
        return out

    # v has mean 1 (phase2_model says why)
    k, v = rnd(1, 4, 1024, 256), rnd(1, 4, 1024, 256, shift=1.0)
    for label, c in FA_MASKS.items():
        kw = dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])
        q = rnd(1, 8, c["sq"], 256)
        out = check(f"1x8x{c['sq']}x256 {label}", q, k, v, **kw)
        if not torch.equal(bits(out), bits(flash_attention_wgmma_hopper(q, k, v, **kw))):
            fail(f"FLASH_ATTN wgmma {name} {label}: two calls differ (expected the same bits)")
    print(f"  FLASH_ATTN wgmma {name}: two calls give the same bits under every mask")
    q, k2, v2 = rnd(1, 8, 2048, 256), rnd(1, 4, 2048, 256), rnd(1, 4, 2048, 256, shift=1.0)
    check("1x8x2048x256 window 1024 (the served leg's local layers)", q, k2, v2, window=1024)
    q, kl, vl = rnd(1, 4, 128, 256), rnd(1, 2, 8192, 256), rnd(1, 2, 8192, 256, shift=1.0)
    check("1x4x128x256 over 8192 keys", q, kl, vl, causal=False)
    # paligemma-3b's prefill: 8 query heads on one KV head and a
    # bidirectional prefix of 256 patch keys, which a query of the prefix
    # sees past its diagonal (a tile chosen or masked by the diagonal alone
    # drops them)
    q, kp, vp = rnd(2, 8, 512, 256), rnd(2, 1, 512, 256), rnd(2, 1, 512, 256, shift=1.0)
    check("2x8x512x256 on 1 KV head, causal, prefix 256 (paligemma's prefill)", q, kp, vp,
          causal=True, prefix_len=256)
    # NaN in column 7 of KV head 1's first key: query heads 2-3 see it (NaN
    # in column 7, as in the model); heads 0-1 must not, though their last
    # key tile runs past Skv = 150, where the rows read must be zeros and
    # not KV head 1's first keys
    q, kn, vn = rnd(1, 4, 150, 256), rnd(1, 2, 150, 256), rnd(1, 2, 150, 256, shift=1.0)
    vn[:, 1, 0, 7] = float("nan")
    out, want = flash_attention_wgmma_hopper(q, kn, vn), attention_mma_ref(q, kn, vn)
    if not torch.equal(torch.isnan(out), torch.isnan(want)) or not torch.isnan(out).any():
        fail(f"FLASH_ATTN wgmma {name}: NaN at {int(torch.isnan(out[:, :2]).sum())} places "
             f"of KV head 0's rows and {int(torch.isnan(out[:, 2:]).sum())} of KV head 1's, "
             f"the model at {int(torch.isnan(want).sum())}: a head read another's keys")
    check_close(f"FLASH_ATTN {name} 1x4x150x256 beside a NaN in the next KV head's keys, "
                f"heads 0-1 wgmma vs model", normwise(out[:, :2], want[:, :2]), dt,
                MMA_MODEL_TOL[dt])

    def off_grid(h, s_, shift=0.0):
        return rnd(2 * h * s_ * 256 + 1, shift=shift)[1:].view(2, h, s_, 256)

    q, ku, vu = off_grid(8, 150), off_grid(2, 150), off_grid(2, 150, 1.0)
    if q.data_ptr() % 16 == 0:
        fail("the off-grid FLASH_ATTN operands lie on the 16-byte grid")
    check("2x8x150x256 window 37, operands off the 16-byte grid", q, ku, vu, window=37)
    result = {}
    torch.cuda.synchronize(dev)

    def first_launch():
        try:
            result["out"] = flash_attention_wgmma_hopper(q, ku, vu, window=37)
            torch.cuda.synchronize(dev)
        except Exception as e:                    # reported below
            result["error"] = e

    thread = threading.Thread(target=first_launch)
    thread.start()
    thread.join()
    if "error" in result:
        fail(f"FLASH_ATTN wgmma {name} as a new thread's first launch: {result['error']}")
    check_close(f"FLASH_ATTN {name} wgmma on a new thread",
                normwise(result["out"], attention_ref(q, ku, vu, window=37)), dt)


def phase2_fa_tf32x3(dev, gen) -> None:
    """FLASH_ATTN's float32 route (3×TF32) against the plain version
    (``TOL``), its plain model (``FA_TF32_MODEL_TOL``) and float64
    (``FA_TF32_F64_TOL``): danube's widths under ``FA_MASKS``, head dims
    32, 128 and 256, a row of 8192 keys (where one p·v accumulator over the
    row would err past the model tolerance), two calls bit-identical, and
    ±inf and NaN in kept key rows and a query row (the same non-finite
    outputs as the model and the plain version, the rest within
    tolerance)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        fa_route, flash_attention_tf32x3_hopper)
    from repro_torch.kernels.flash_attention.ref import (attention_f64, attention_ref,
                                                         attention_tf32x3_ref)

    f32 = torch.float32
    if fa_route(f32, 80) != "tf32x3":
        fail(f"float32 FLASH_ATTN takes the {fa_route(f32, 80)} route, not tf32x3")

    def rnd(*shape, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) + shift

    def check(what, q, k, v, **kw):
        out = flash_attention_tf32x3_hopper(q, k, v, **kw)
        check_close(f"{what} vs plain", normwise(out, attention_ref(q, k, v, **kw)), f32)
        check_close(f"{what} vs model", normwise(out, attention_tf32x3_ref(q, k, v, **kw)),
                    f32, FA_TF32_MODEL_TOL)
        check_close(f"{what} vs float64", normwise(out, attention_f64(q, k, v, **kw)), f32,
                    FA_TF32_F64_TOL)
        return out

    # v has mean 1 (phase2_model says why)
    k, v = rnd(1, 8, 1024, 80), rnd(1, 8, 1024, 80, shift=1.0)
    for label, c in FA_MASKS.items():
        kw = dict(causal=c["causal"], window=c["window"], prefix_len=c["prefix_len"])
        q = rnd(1, 32, c["sq"], 80)
        out = check(f"FLASH_ATTN float32 1x32x{c['sq']}x80 {label} tf32x3", q, k, v, **kw)
        if not torch.equal(bits(out), bits(flash_attention_tf32x3_hopper(q, k, v, **kw))):
            fail(f"FLASH_ATTN tf32x3 {label}: two calls differ (expected the same bits)")
    print("  FLASH_ATTN tf32x3: two calls give the same bits under every mask")
    for d in (32, 128, 256):
        q, kd, vd = rnd(1, 16, 300, d), rnd(1, 4, 300, d), rnd(1, 4, 300, d, shift=1.0)
        check(f"FLASH_ATTN float32 1x16x300x{d} window 100 tf32x3", q, kd, vd,
              window=100, prefix_len=20)
    q, kl, vl = rnd(1, 8, 128, 80), rnd(1, 2, 8192, 80), rnd(1, 2, 8192, 80, shift=1.0)
    check("FLASH_ATTN float32 1x8x128x80 over 8192 keys tf32x3", q, kl, vl, causal=False)
    # +inf in key 5 of k (a score of ±inf by the sign of q); ±inf and NaN in
    # key 9 of v (masked for rows 0-8, whose p = 0 meets them); -inf in
    # query row 100
    q, kn, vn = rnd(1, 8, 256, 80), rnd(1, 2, 256, 80), rnd(1, 2, 256, 80, shift=1.0)
    kn[:, :, 5, 3] = float("inf")
    vn[:, :, 9, 11], vn[:, :, 9, 12], vn[:, :, 9, 13] = (float("inf"), -float("inf"),
                                                         float("nan"))
    q[:, :, 100, 5] = -float("inf")
    out = flash_attention_tf32x3_hopper(q, kn, vn)
    for name, want, tol in (("model", attention_tf32x3_ref(q, kn, vn), FA_TF32_MODEL_TOL),
                            ("plain", attention_ref(q, kn, vn), TOL[f32])):
        for special in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(special(out), special(want)):
                fail(f"FLASH_ATTN tf32x3 ±inf/NaN: {special.__name__} differs from the "
                     f"{name}'s")
        finite = torch.isfinite(out)
        if not (0 < int(finite.sum()) < out.numel() and bool(torch.isinf(out).any())):
            fail("FLASH_ATTN tf32x3 ±inf/NaN: the case gives no mix of finite, inf and NaN")
        check_close(f"FLASH_ATTN tf32x3 ±inf/NaN, finite part vs {name}",
                    normwise(out[finite], want[finite]), f32, tol)
    print(f"  FLASH_ATTN tf32x3 ±inf/NaN: {int(torch.isnan(out).sum())} NaN, "
          f"{int(torch.isinf(out).sum())} inf, where the model and the plain version have them")


#: phase 2: fused chains — (op, a, b) steps over inputs 0..4, "acc" the
#: previous step's result
FUSED_CHAINS = {
    "4-step ((a·b + c) − d) / e": (("mul", 0, 1), ("add", "acc", 2),
                                   ("sub", "acc", 3), ("div", "acc", 4)),
    "every op, acc second": (("sub", 0, 1), ("div", 2, "acc"), ("mul", "acc", 3),
                             ("sub", 4, "acc"), ("add", 1, "acc"),
                             ("div", "acc", 4)),
    "copy": (("copy", 2, None), ("mul", "acc", 0), ("copy", "acc", None),
             ("add", "acc", 3)),
    "input twice": (("mul", 0, 0), ("div", "acc", 4), ("add", "acc", 0)),
}


def fused_cap_chain():
    """A chain at the kernel's caps: 16 inputs, 32 steps, every input read."""
    from repro_torch.kernels.fused import MAX_INPUTS, MAX_STEPS
    ops = ("add", "mul", "sub", "div")
    steps = [("copy", 0, None)]
    for s in range(1, MAX_STEPS):
        steps.append((ops[s % 4], "acc", s % MAX_INPUTS))
    return tuple(steps)


def serial_chain(arrays, steps):
    """The chain as one EW kernel launch per step."""
    from repro_torch.kernels.ewise.ewise import ewise_hopper
    acc = None
    for op, a, b in steps:
        x = acc if a == "acc" else arrays[a]
        acc = x.clone() if op == "copy" else ewise_hopper(
            x, acc if b == "acc" else arrays[b], op)
    return acc


def fused_shift(j: int) -> float:
    """Inputs that the chains divide by (odd ones and input 4) are shifted
    by +3 away from 0."""
    return 3.0 if j % 2 or j == 4 else 0.0


def phase2_fused(dev, gen, dt) -> None:
    """The chain kernel bit-exact against its plain version and against the
    serial EW kernels."""
    from repro_torch.kernels.fused import ewise_chain_hopper, ewise_chain_ref

    name = str(dt).split(".")[-1]

    def inputs(shape, k):
        return [(torch.randn(shape, generator=gen, device=dev)
                 + fused_shift(j)).to(dt) for j in range(k)]

    cases = [(label, shape, steps) for label, steps in FUSED_CHAINS.items()
             for shape in ((1,), (3, 5, 7), (1_000_003,))]
    cases += [("4-step ((a·b + c) − d) / e", (8192, 8191),
               FUSED_CHAINS["4-step ((a·b + c) − d) / e"]),
              ("caps: 16 inputs, 32 steps", (100_003,), fused_cap_chain())]
    for label, shape, steps in cases:
        k = 1 + max(s for _, a, b in steps for s in (a, b) if isinstance(s, int))
        xs = inputs(shape, k)
        out = ewise_chain_hopper(*xs, steps=steps)
        what = f"FUSED {name} {'x'.join(map(str, shape))} {label}"
        check_bits(f"{what} vs plain", out, ewise_chain_ref(*xs, steps=steps))
        check_bits(f"{what} vs serial EW", out, serial_chain(xs, steps))
    # offset views: pointers off the 16-byte grid take the scalar path
    steps = FUSED_CHAINS["every op, acc second"]
    xs = [x[1:] for x in inputs((100_004,), 5)]
    out = ewise_chain_hopper(*xs, steps=steps)
    check_bits(f"FUSED {name} unaligned 100003 vs plain", out,
               ewise_chain_ref(*xs, steps=steps))
    check_bits(f"FUSED {name} unaligned 100003 vs serial EW", out,
               serial_chain(xs, steps))


# ---------------------------------------------------------------------------
# phase 3: the slice end to end through the port's host API
# ---------------------------------------------------------------------------
def phase3(dev):
    from repro_torch import halo, quickstart
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.conv1d.ref import conv1d_ref
    from repro_torch.kernels.ewise.ref import OP_REFS as EW_REFS
    from repro_torch.kernels.fft.ref import fft_chirp_ref, fft_radix_ref
    from repro_torch.kernels.jacobi.ref import jacobi_step_ref
    from repro_torch.kernels.matmul.ref import mmm_ref
    from repro_torch.kernels.mvm.ref import mvm_ref
    from repro_torch.kernels.sorthist.ref import hist_ref, sort_ref
    from repro_torch.kernels.spmm.ref import smmm_bell_ref
    from repro_torch.kernels.vdp.ref import vdp_ref

    session = halo.initialize()              # device=None means the card
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    jobs = quickstart.make_jobs(SIZES, dev, seed=0)
    torch.cuda.synchronize(dev)
    _cuda.reset_launch_counts()
    session.reset_t1()
    t0 = time.perf_counter()
    sync, asyn = quickstart.run(jobs, overrides=PIN)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    quarantined = session.scheduler.failed_record_keys()
    print(f"  quickstart (sync + async) on {session.device}: {wall:.3f} s wall, "
          f"T1 {session.t1_seconds_per_call * 1e6:.1f} us per call over "
          f"{2 * len(jobs)} calls")
    print(f"  launches {launches}; quarantine {quarantined}")
    # MMM at 4096³ float32 takes the 3×TF32 route, FFT at n = 4096 and SORT
    # at 2^24 the radix routes
    expected = {"mmm_skinny": 0, "mmm_wgmma": 0, "mmm_tf32x3": 2, "ewise": 8,
                "mvm": 2, "vdp": 2, "jacobi": 2, "conv1d": 2, "spmm": 2, "fft_radix": 2,
                "fft_chirp": 0, "sort": 0, "sort_radix": 2, "hist": 2, "rmsnorm": 0,
                "flash_attention_mma": 0, "flash_attention_tf32x3": 0,
                "flash_attention_wgmma": 0, "fused": 0, "embed_grad": 0}
    if launches != expected:
        fail(f"launch counts {launches} != requests sent {expected}: a request "
             f"did not reach its kernel")
    if quarantined:
        fail(f"records were quarantined on the main path: {quarantined}")

    refs = {"MMM": mmm_ref, "EWMM": EW_REFS["mul"], "EWMD": EW_REFS["div"],
            "EWADD": EW_REFS["add"], "EWSUB": EW_REFS["sub"], "MVM": mvm_ref,
            "VDP": vdp_ref, "JS": jacobi_step_ref, "1DCONV": conv1d_ref,
            "SMMM": smmm_bell_ref, "FFT": fft_radix_ref, "SORT": sort_ref,
            "HIST": hist_ref}
    kernel_of = {"MMM": "mmm_tf32x3", "MVM": "mvm", "VDP": "vdp", "JS": "jacobi",
                 "1DCONV": "conv1d", "SMMM": "spmm", "FFT": "fft_radix",
                 "SORT": "sort_radix", "HIST": "hist"}
    max_abs = {k: 0.0 for k in expected if k not in PATH_OF}
    for alias, args in jobs.items():
        ref = refs[alias](*args)
        kname = kernel_of.get(alias, "ewise")
        for mode, out in (("sync", sync[alias]), ("async", asyn[alias])):
            if out.shape != ref.shape or out.dtype != ref.dtype \
                    or not bool(torch.isfinite(out).all()):
                fail(f"{alias} {mode}: {tuple(out.shape)} {out.dtype} vs "
                     f"{tuple(ref.shape)} {ref.dtype} or not finite")
            max_abs[kname] = max(max_abs[kname],
                                 float((wide(out) - wide(ref)).abs().max()))
            label = f"{alias} {mode} {'x'.join(map(str, args[0].shape))}"
            if kname in ("ewise", "conv1d", "sort_radix", "hist"):
                check_bits(label, out, ref)
            elif alias == "FFT":
                check_close(f"{label} vs plain", normwise(out, ref), torch.float32,
                            FFT_TOL)
                check_close(f"{label} vs float64", normwise(
                    out, torch.fft.fft(args[0].double(), dim=-1)), torch.float32,
                    FFT_TOL)
            elif alias == "VDP":
                check_close(label, relative(out, ref), torch.float32, VDP_TOL)
            elif alias == "JS":
                check_js(label, out, ref, *args, torch.float32)
            else:
                check_close(label, normwise(out, ref), torch.float32)
    # the other routes through the same host API, each request counted on
    # its own: FFT at the non-power-of-two DFT_N (the chirp route), SORT of
    # 4096 rows of 4096 (the tile route), MMM float32 at a K that TMA cannot
    # stride (the 3×TF32 route, its split pass padding K)
    gen2 = torch.Generator(device=dev).manual_seed(2)
    tm, tk, tn = LONE_MMM
    requests = {
        "chirp": ("FFT", (torch.randn((SIZES["FFT"] // 2, DFT_N), generator=gen2,
                                      device=dev),), "fft_chirp"),
        "sort_tile": ("SORT", (torch.randn((4096, 4096), generator=gen2, device=dev),),
                      "sort"),
        "mmm_lone": ("MMM", (torch.randn((tm, tk), generator=gen2, device=dev),
                             torch.randn((tk, tn), generator=gen2, device=dev)),
                     "mmm_tf32x3"),
    }
    path_launches = {}
    for path, (alias, args, kname) in requests.items():
        cr = halo.claim(alias, overrides=PIN)
        _cuda.reset_launch_counts()
        halo.send(args, cr)
        out = halo.recv(cr)
        torch.cuda.synchronize(dev)
        counts = _cuda.launch_counts()
        path_launches[path] = counts
        label = f"{alias} {'x'.join(map(str, args[0].shape))} ({path})"
        print(f"  {label}: launches { {k: v for k, v in counts.items() if v} }")
        if counts != {**{k: 0 for k in expected}, kname: 1}:
            fail(f"the {label} request launched {counts}, not one {kname}")
        if alias == "FFT":
            x, = args
            ref = fft_chirp_ref(x)
            check_close(f"{label} vs plain", normwise(out, ref), torch.float32, FFT_TOL)
            check_close(f"{label} vs float64", normwise(
                out, torch.fft.fft(x.double(), dim=-1)), torch.float32, FFT_TOL)
        elif alias == "MMM":
            ref = mmm_ref(*args)
            check_close(f"{label} vs plain", normwise(out, ref), torch.float32)
        else:
            ref = sort_ref(*args)
            check_bits(label, out, ref)
        max_abs[kname] = max(max_abs.get(kname, 0.0),
                             float((wide(out) - wide(ref)).abs().max()))
        del out, ref
    # end to end, after the counted run: wall time of the whole template
    # (blocking + burst) on the same inputs, and T1 per call
    walls = []
    session.reset_t1()
    for _ in range(E2E_REPEATS):
        t0 = time.perf_counter()
        quickstart.run(jobs, overrides=PIN)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    e2e = {"wall_ms": sorted(walls)[len(walls) // 2] * 1e3,
           "wall_ms_all": [w * 1e3 for w in walls],
           "t1_us_per_call": session.t1_seconds_per_call * 1e6,
           "requests": 2 * len(jobs)}
    halo.finalize()
    path_launches["portability_demo"], e2e["portability_demo"] = portability_leg(dev)
    return jobs, launches, path_launches, max_abs, e2e


def portability_leg(dev):
    """``repro_torch.portability_demo`` on the card: the same
    ``agent.invoke`` line for MMM 512×512 float32 under the policies
    ``["torch"]``, ``["torch", "aten"]`` and ``["torch", "aten", "hopper"]``
    is served, every call of it, by the torch, aten and hopper agent in
    turn (their request counts); the hopper policy's every call launches
    the 3×TF32 MMM once and nothing else launches a kernel; each result
    within ``TOL`` of ``mmm_ref``; the fancy agent serves its claim; the
    fail-safe engages.  Prints T3 per policy with Φ and the penalty
    against aten.  Returns (launches, stats)."""
    from repro_torch import portability_demo
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.matmul.ref import mmm_ref

    torch.cuda.synchronize(dev)
    _cuda.reset_launch_counts()
    res = portability_demo.run(dev)
    torch.cuda.synchronize(dev)
    got = {k: v for k, v in _cuda.launch_counts().items() if v}
    picks = [pol["picked"] for pol in res["policies"]]
    calls = sum(pol["calls"] for pol in res["policies"] if pol["picked"] == "hopper")
    ref = mmm_ref(res["a"], res["b"])
    rows = {}
    for pol in res["policies"]:
        err = normwise(pol["out"], ref)
        check_close(f"portability demo {pol['allowed']} -> {pol['picked']}", err,
                    torch.float32)
        rows[pol["picked"]] = {"t3_ms": pol["t3_s"] * 1e3, "phi": pol["phi"],
                               "penalty_pct": pol["penalty_pct"], "err": err}
        print(f"  portability demo: substrates={pol['allowed']} -> {pol['picked']}: "
              f"T3 {pol['t3_s'] * 1e3:.4f} ms a call, Φ {pol['phi']:.4f}, penalty "
              f"{pol['penalty_pct']:+.2f} % against {portability_demo.BASELINE}; "
              f"normwise {err:.3e} against mmm_ref")
    fancy_err = normwise(res["fancy"]["out"], ref)
    print(f"  portability demo: launches {got} ({calls} hopper calls); the fancy agent "
          f"served {res['fancy']['served']} (normwise {fancy_err:.3e}); fail-safe "
          f"engaged {res['failsafe']['engaged']}, result {tuple(res['failsafe']['out'].shape)} "
          f"on {res['failsafe']['out'].device}")
    served = [pol["served"] for pol in res["policies"]]
    if picks != ["torch", "aten", "hopper"] or \
            served != [{p: pol["calls"]} for p, pol in zip(picks, res["policies"])]:
        fail(f"the portability demo's policies were served by {served}")
    if got != {"mmm_tf32x3": calls}:
        fail(f"the portability demo launched {got}, not {calls} mmm_tf32x3 (one a hopper "
             f"call)")
    check_close("portability demo fancy agent", fancy_err, torch.float32)
    if res["fancy"]["served"] != 1 or not res["failsafe"]["engaged"] \
            or res["failsafe"]["out"].device != dev or res["fancy"]["out"].device != dev:
        fail(f"the fancy agent served {res['fancy']['served']}, the fail-safe engaged "
             f"{res['failsafe']['engaged']}, results on {res['fancy']['out'].device} and "
             f"{res['failsafe']['out'].device}")
    return got, {"picks": picks, "policies": rows, "launches": got,
                 "fancy_served": res["fancy"]["served"], "failsafe": True}


# ---------------------------------------------------------------------------
# phase 3b: the model path, served at full width
# ---------------------------------------------------------------------------
def recording_engine(paged: bool = False):
    """A SlotEngine (a PagedEngine with ``paged``) that keeps each
    request's logits (float32 copies on the card) at the end of its prefill
    (whole, or its last chunk) and at every decode step, the rows of every
    chunk, the time of each request's prefill (its device bodies, run to
    completion, its chunks summed) and the host time of each decode step,
    and apart those of the steps that replayed the captured step; it
    computes exactly what the engine does."""
    from repro_torch.serve.engine import PagedEngine, SlotEngine

    class RecordingEngine(PagedEngine if paged else SlotEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.records, self._lane_rec, self._prefill_t = [], {}, {}
            self.prefill_s, self.decode_s, self.chunk_rows = [], [], []
            self.replay_s = []
            self._active = None

        @staticmethod
        def _timed(fn, *args):
            t0 = time.perf_counter()
            logits = fn(*args)
            if logits.is_cuda:
                torch.cuda.synchronize(logits.device)
            return logits, time.perf_counter() - t0

        def _prefilled(self, slot, prompt, logits, seconds):
            self.prefill_s.append((len(prompt), self._prefill_t.pop(slot, 0.0) + seconds))
            rec = {"prompt": list(prompt), "logits": [logits[0].float()]}
            self.records.append(rec)
            self._lane_rec[slot] = rec

        def _admit_logits(self, slot, toks):
            logits, sec = self._timed(super()._admit_logits, slot, toks)
            self._prefilled(slot, toks[0].tolist(), logits, sec)
            return logits

        def _chunk_logits(self, slot, toks, p0):
            logits, sec = self._timed(super()._chunk_logits, slot, toks, p0)
            self.chunk_rows.append(toks.shape[1])
            prompt = self._meta[slot].prompt
            if p0 + toks.shape[1] < len(prompt):
                self._prefill_t[slot] = self._prefill_t.get(slot, 0.0) + sec
            else:
                self._prefilled(slot, prompt, logits, sec)
            return logits

        def _decode_logits(self, tok, pos, active):
            logits = super()._decode_logits(tok, pos, active)
            for i in self._active:
                self._lane_rec[i]["logits"].append(logits[i].float())
            return logits

        def decode_step(self, tok, pos, active, generator, temperature=0.0):
            self._active = [i for i, a in enumerate(active) if a]
            before = self.step_stats()
            t0 = time.perf_counter()
            out = super().decode_step(tok, pos, active, generator, temperature)
            self.decode_s.append(time.perf_counter() - t0)
            after = self.step_stats()
            if after["replays"] > before["replays"] and after["captures"] == before["captures"]:
                self.replay_s.append(self.decode_s[-1])
            return out

    return RecordingEngine


def device_seconds_of(e) -> float:
    """Device seconds of one torch.profiler key-average entry."""
    return (getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)) or 0.0) / 1e6


def device_seconds(prof) -> float:
    """Σ device time of every kernel a torch.profiler run saw."""
    return sum(device_seconds_of(e) for e in prof.key_averages())


def device_ms_per_call(fn, runs: int, dev, by_kernel: bool = False):
    """Device ms of the kernels one call of ``fn`` launches: ``runs`` calls,
    each synchronised, under torch.profiler after one waiting and one
    warm-up call.  The profiler does not record every launch (on the H100
    it kept 4 of 5 of a kernel launched from an agent's worker thread), so
    each kernel counts at its mean time times its launches per call, the
    recorded count over ``runs`` rounded.  The sum over the kernels, or
    with ``by_kernel`` each kernel's share keyed by its name."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=runs)) as prof:
        for _ in range(runs + 2):
            fn()
            torch.cuda.synchronize(dev)
            prof.step()
    per = {e.key: 1e3 * device_seconds_of(e) / e.count * max(1, round(e.count / runs))
           for e in prof.key_averages() if e.count and device_seconds_of(e)}
    return per if by_kernel else sum(per.values())


def median_device_ms(fn, dev) -> float:
    """Device time per call of the kernels ``fn`` launches, from
    torch.profiler over TIMED_RUNS calls.  A kernel of tens of µs is
    shorter than its Python wrapper, so events around each call would time
    the host's launch."""
    for _ in range(3):
        fn()
    # the profiler on the card now and then returns an empty window (a
    # library call has read 0.0 ms) or one that undercounts (an 8192²
    # float32 ATen multiply has read 0.1244 ms, half its time): the median
    # of three windows, and after three empty windows TIMED_RUNS calls back
    # to back by CUDA events (the host's launches then count where they
    # outlast the kernels)
    windows = [t for t in (device_ms_per_call(fn, TIMED_RUNS, dev) for _ in range(3))
               if t > 0]
    if windows:
        return statistics.median(windows)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_RUNS):
        fn()
    end.record()
    end.synchronize()
    t = start.elapsed_time(end) / TIMED_RUNS
    print(f"  torch.profiler saw no device time in three windows: {t:.4f} ms per "
          f"call by CUDA events over {TIMED_RUNS} calls back to back")
    return t


class EagerStep:
    """Stands in for an engine's step graph (``engine._step``) and runs
    every decode step eagerly: the graph is handed no key."""

    def __init__(self, graph):
        self.graph = graph

    def __call__(self, key, body, *inputs):
        return self.graph(None, body, *inputs)

    def stats(self):
        return self.graph.stats()


def step_line(stats: dict) -> str:
    return (f"{stats['captures']} captured, {stats['replays']} replayed, "
            f"{stats['eager_steps']} eager")


def check_captured(what: str, engine, decodes: int, tapped: int = 0) -> dict:
    """The engine's decode steps: the first eager, the second captured
    (and replayed), every later one a replay (one key for the whole run),
    but the ``tapped`` steps a ``BlockCapture`` ran eagerly."""
    stats = engine.step_stats()
    print(f"  {what}: decode steps {step_line(stats)} of {decodes}"
          + (f" ({tapped} tapped steps eager)" if tapped else ""))
    want = {"captures": 1, "replays": decodes - 1 - tapped, "eager_steps": 1 + tapped} \
        if decodes - tapped > 1 else {"captures": 0, "replays": 0, "eager_steps": decodes}
    if stats != want:
        fail(f"{what}: decode steps {stats}, not {want}: a step after the first was not "
             f"a replay of the captured step")
    return stats


def profiler_coverage(prof, launched: int, what: str) -> str:
    """How many of the ``launched`` RMSNORM kernels a torch.profiler run
    saw (it must attribute the replayed ones as well as the eager ones);
    fails below 95 %."""
    seen = sum(e.count for e in prof.key_averages() if "rmsnorm_" in e.key.split("<")[0])
    if not launched or seen < 0.95 * launched:
        fail(f"{what}: torch.profiler saw {seen} of the {launched} RMSNORM kernels "
             f"launched, so its device time misses kernels")
    return f"{seen} of {launched} RMSNORM kernels seen"


def profiled_rerun(dev, make, prompts, max_news, seed):
    """The same requests again on a fresh engine ``make()`` under
    torch.profiler, its decode steps captured and replayed; fails where the
    profiler missed the replayed kernels (``profiler_coverage``).  Returns
    (tokens, profile, wall s, coverage)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import run_requests
    from repro_torch.serve.engine import StepScheduler

    sched = StepScheduler(make(), seed=seed)
    _cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again, _, wall = run_requests(sched, prompts, max_news)
        torch.cuda.synchronize(dev)
    how = profiler_coverage(prof, _cuda.launch_counts()["rmsnorm"], "profiled rerun")
    print(f"  profiled rerun: {how}")
    return again, prof, wall, how


def lone_steps(runs: int) -> int:
    """The decode steps ``lone_decode`` takes: the eager one and the
    capture, three samples of 2·``runs`` (host clock, profiler), and the
    eager sample's warm step.  Its engine holds that many positions past
    each prompt."""
    return 3 + 6 * runs


def slot_stepper(engine, admit, slots: int):
    """One decode step of ``engine`` a call, every lane active from its
    prompt on (``admit(slot)`` prefills lane ``slot`` and returns (first
    token, prompt length))."""
    import numpy as np

    first = [admit(i) for i in range(slots)]
    state = {"tok": np.array([t for t, _ in first]), "pos": np.array([n for _, n in first])}
    act = np.ones(slots, bool)

    def step():
        state["tok"] = engine.decode_step(state["tok"], state["pos"], act, None)
        state["pos"] = state["pos"] + 1
    return step


def lone_decode(dev, step, holder, runs: int, attr: str = "_step") -> dict:
    """One decode step alone: ``step()`` takes one, every lane past its
    prompt, through the step graph ``getattr(holder, attr)`` (an engine's
    ``_step``, a lockstep width's ``graph``), whose key has taken no step
    yet.  The eager step; the capturing step (its capture and its replay)
    by the host clock with the device memory it reserved, the graph's pool;
    then ``runs`` captured steps, ``runs`` eager ones (``EagerStep``), and
    ``runs`` captured again, each by the host clock (synchronised) and by
    torch.profiler's device time (``profiler_coverage``).  Busy share:
    device ms / host ms.  The engine's caches must hold
    ``lone_steps(runs)`` positions past every prompt."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _cuda

    graph = getattr(holder, attr)

    def steps(k):
        for _ in range(k):
            step()
        torch.cuda.synchronize(dev)

    def timed(what):
        t0 = time.perf_counter()
        steps(runs)
        host = (time.perf_counter() - t0) / runs * 1e3
        norms = _cuda.launch_counts()["rmsnorm"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps(runs)
        profiler_coverage(prof, _cuda.launch_counts()["rmsnorm"] - norms, what)
        return host, device_seconds(prof) / runs * 1e3

    steps(1)
    reserved = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    steps(1)
    out = {"capture_ms": (time.perf_counter() - t0) * 1e3,
           "pool_gb": (torch.cuda.memory_reserved(dev) - reserved) / 1e9}
    if graph.stats() != {"captures": 1, "replays": 1, "eager_steps": 1}:
        fail(f"one decode step alone: steps {graph.stats()}, not one eager and one captured")
    out["captured_host_ms"], out["captured_device_ms"] = timed("captured steps alone")
    setattr(holder, attr, EagerStep(graph))
    steps(1)
    out["eager_host_ms"], out["eager_device_ms"] = timed("eager steps alone")
    setattr(holder, attr, graph)
    out["captured_host_ms_2"], out["captured_device_ms_2"] = timed("captured steps alone")
    host = min(out["captured_host_ms"], out["captured_host_ms_2"])
    out["captured_busy"] = out["captured_device_ms"] / host
    out["eager_busy"] = out["eager_device_ms"] / out["eager_host_ms"]
    return out


def lone_line(r: dict) -> str:
    return (f"one decode step alone: host ms captured {r['captured_host_ms']:.3f}, "
            f"{r['captured_host_ms_2']:.3f}, eager {r['eager_host_ms']:.3f}; device ms "
            f"(torch.profiler) captured {r['captured_device_ms']:.3f}, "
            f"{r['captured_device_ms_2']:.3f}, eager {r['eager_device_ms']:.3f}; busy "
            f"captured {r['captured_busy']:.3f}, eager {r['eager_busy']:.3f}; the capturing "
            f"step {r['capture_ms']:.1f} ms host clock, graph pool {r['pool_gb']:.3f} GB")


def lone_slot_decode(dev, model, params, slots: int, prompts, max_len: int, runs: int):
    """``lone_decode`` on a fresh SlotEngine, lane i prefilled with
    ``prompts[i]``; the engine holds ``lone_steps(runs)`` positions more
    than ``max_len``."""
    from repro_torch.serve.engine import SlotEngine

    lone = SlotEngine(model, params, slots, max_len + lone_steps(runs))
    step = slot_stepper(lone, lambda i: (lone.prefill_into_slot(i, prompts[i], None),
                                         len(prompts[i])), slots)
    return lone_decode(dev, step, lone, runs)


def phase3b(dev):
    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.core.manifest import default_manifest
    from repro_torch.core.portability import percentile_nearest
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import mixed_budgets, run_requests, summary
    from repro_torch.models import build_model
    from repro_torch.serve.engine import SlotEngine, StepScheduler
    from repro_torch.serve.kvcache import pad_caches

    cfg = get_config(SERVE["arch"])
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SERVE["seed"])
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize(dev)
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}, random from seed "
          f"{SERVE['seed']} ({time.perf_counter() - t0:.1f} s)")
    n, lens = SERVE["requests"], SERVE["prompt_lens"]
    prompts = [torch.randint(0, cfg.vocab_size, (lens[i % len(lens)],), generator=gen,
                             device=dev).tolist() for i in range(n)]
    max_news = mixed_budgets(n, SERVE["max_new"])
    max_len = max(lens) + SERVE["max_new"] + cfg.prefix_len + 8
    Engine = recording_engine()

    session = halo.initialize()              # device=None means the card
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    # warm-up: one short request on a one-slot engine, before the counts
    warm = StepScheduler(SlotEngine(model, params, 1, 80), seed=SERVE["seed"])
    run_requests(warm, [prompts[0][:64]], [2])
    del warm
    engine = Engine(model, params, SERVE["slots"], max_len)
    sched = StepScheduler(engine, temperature=0.0, seed=SERVE["seed"])
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launch_counts()
    session.reset_t1()
    results, lat, wall = run_requests(sched, prompts, max_news)
    torch.cuda.synchronize(dev)
    launches = _cuda.launch_counts()
    quarantined = session.scheduler.failed_record_keys()
    t1_us = session.t1_seconds_per_call * 1e6
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    report = sched.report()
    for line in summary(results, lat, wall, report):
        print("  " + line)
    print(f"  launches {launches} (replays credited); quarantine {quarantined}")

    if [len(r) for r in results] != max_news:
        fail(f"served {[len(r) for r in results]} tokens, budgets {max_news}")
    graph_stats = check_captured("danube", engine, len(engine.decode_s))
    passes = len(engine.prefill_s) + len(engine.decode_s)
    layers = cfg.n_layers
    expected = {k: 0 for k in launches}
    # 7·L + 1 MMMs per forward pass: a prefill's 7·L projections of its
    # prompt rows (bfloat16, K and N multiples of 8) take the tensor-core
    # route and its last-token unembed (one row) the skinny route; a decode
    # pass's 7·L + 1 (one row per slot) all take the skinny route; every
    # prefill's attention (bfloat16, head dim
    # 80) takes FLASH_ATTN's tensor-core route
    expected.update(mmm_wgmma=7 * layers * len(engine.prefill_s),
                    mmm_skinny=(7 * layers + 1) * len(engine.decode_s)
                    + len(engine.prefill_s),
                    rmsnorm=(2 * layers + 1) * passes,
                    flash_attention_mma=layers * len(engine.prefill_s))
    print(f"  {len(engine.prefill_s)} prefills + {len(engine.decode_s)} decode steps: "
          f"expected launches {expected}")
    if launches != expected:
        fail(f"launch counts {launches} != the model's structure {expected}: a "
             f"dispatch went to another record")
    if quarantined:
        fail(f"records were quarantined on the model path: {quarantined}")
    for rec, p, r in zip(engine.records, prompts, results):
        if rec["prompt"] != p or len(rec["logits"]) != len(r):
            fail("the recorded steps do not match the requests")
        if not all(bool(torch.isfinite(x).all()) and x.shape == (cfg.padded_vocab,)
                   for x in rec["logits"]):
            fail("served logits are not finite or not of the vocab's width")

    prefill_ms = {L: [s * 1e3 for n_, s in engine.prefill_s if n_ == L] for L in lens}
    decode_ms = sorted(s * 1e3 for s in engine.decode_s)
    stats = {"tokens_per_s": sum(map(len, results)) / wall, "wall_s": wall,
             "latency_p50_ms": percentile_nearest(lat, 0.5) * 1e3,
             "latency_p95_ms": percentile_nearest(lat, 0.95) * 1e3,
             "prefill_ms": {str(L): v for L, v in prefill_ms.items()},
             "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
             "decode_steps": len(decode_ms), "t1_us_per_dispatch": t1_us,
             "t1_s": report.t1_s, "t3_s": report.t3_s, "peak_gb": peak_gb,
             "decode_graph": graph_stats,
             "replay_step_ms_median": statistics.median(engine.replay_s) * 1e3}
    for L, v in prefill_ms.items():
        print(f"  prefill {L} tokens: {', '.join(f'{x:.1f}' for x in v)} ms per request")
    print(f"  decode step: median {stats['decode_step_ms_median']:.2f} ms over "
          f"{len(decode_ms)} steps ({decode_ms[0]:.2f}–{decode_ms[-1]:.2f}), the "
          f"{len(engine.replay_s)} replays' {stats['replay_step_ms_median']:.2f}; T1 "
          f"{t1_us:.1f} us per dispatch; peak memory {peak_gb:.2f} GB")

    # the same requests again under torch.profiler: device time by kernel
    records = engine.records
    del engine, sched
    again, prof, wall_prof, stats["profiled_by"] = profiled_rerun(
        dev, lambda: SlotEngine(model, params, SERVE["slots"], max_len), prompts,
        max_news, SERVE["seed"])
    if again != results:
        fail("a second greedy run served other tokens")
    busy_s = device_seconds(prof)
    stats["device_s"] = busy_s
    stats["device_busy_share"] = busy_s / wall if busy_s > 0 else None
    # the prefills' projections: every MMM kernel that is not the skinny one
    prefill_mmm_s = sum(device_seconds_of(e) for e in prof.key_averages()
                        if e.key.split("<")[0].split("::")[-1].strip()
                        == "mmm_wgmma_kernel")
    stats["prefill_mmm_device_ms"] = prefill_mmm_s * 1e3 if prefill_mmm_s > 0 else None
    print("  prefill MMM device time (profiled rerun, 7·L projections per prefill): "
          + (f"{prefill_mmm_s * 1e3:.1f} ms" if prefill_mmm_s > 0 else "not measured"))
    # the decode step's split: the skinny kernels of the decode passes (M =
    # slots; the prefills' one-row unembeds are the MT = 1 instances), and
    # the host's dispatches per pass times T1
    slots_mt = f", {SERVE['slots']}"
    mmm_decode_s = sum(device_seconds_of(e) for e in prof.key_averages()
                       if "mmm_skinny" in e.key and slots_mt in e.key.split("<", 1)[-1]
                       .split(">", 1)[0])
    per_pass = 7 * layers + 1 + 2 * layers + 1
    stats["decode_mmm_device_ms_per_pass"] = (mmm_decode_s * 1e3 / stats["decode_steps"]
                                              if mmm_decode_s > 0 else None)
    stats["decode_dispatches_per_pass"] = per_pass
    stats["decode_dispatch_t1_ms_per_pass"] = per_pass * t1_us / 1e3
    print(f"  decode step split: MMM device time "
          + (f"{stats['decode_mmm_device_ms_per_pass']:.3f} ms per pass (profiled "
             f"rerun, skinny kernels at M = {SERVE['slots']})" if mmm_decode_s > 0
             else "not measured (the profiler saw no skinny kernel)")
          + f"; {per_pass} dispatches per dispatched pass (the eager step and the "
          f"capture: 2 of {stats['decode_steps']}; a replay makes none) × T1 "
          f"{t1_us:.1f} us = {stats['decode_dispatch_t1_ms_per_pass']:.3f} ms; median "
          f"step {stats['decode_step_ms_median']:.2f} ms")
    if busy_s > 0:
        print(f"  device time {busy_s * 1e3:.1f} ms (profiled rerun, wall "
              f"{wall_prof * 1e3:.1f} ms); busy share {busy_s / wall:.3f} of the "
              f"counted run's {wall * 1e3:.1f} ms")
        key = "self_device_time_total" if hasattr(
            prof.key_averages()[0], "self_device_time_total") else "self_cuda_time_total"
        top = sorted(prof.key_averages(), key=lambda e: getattr(e, key), reverse=True)
        for e in top[:10]:
            print(f"    {getattr(e, key) / 1e3:10.1f} ms  {e.count:6d}x  {e.key[:90]}")
    else:
        print("  device busy share: not measured (the profiler saw no device time)")
    # one decode step alone, every slot past its prompt: captured and eager
    alone = lone_slot_decode(dev, model, params, SERVE["slots"], prompts, max_len, 5)
    stats["alone"] = alone
    stats["decode_step_ms_alone"] = alone["captured_host_ms"]
    stats["decode_step_device_ms"] = alone["captured_device_ms"]
    print(f"  ({SERVE['slots']} slots) " + lone_line(alone))
    halo.finalize()

    # replay every request through the plain versions on the card
    plain = default_manifest()
    plain.platform_list = [{"platform_preference": ["torch"]}]
    halo.initialize(manifest=plain)
    _cuda.reset_launch_counts()
    worst, same, total, per_request = 0.0, 0, 0, []
    with torch.no_grad():
        for rec, p, r in zip(records, prompts, results):
            logits, caches = model.prefill(params, {"tokens": torch.tensor([p], device=dev)})
            caches = pad_caches(cfg, caches, max_len)
            steps = [logits[0]]
            for i, tok in enumerate(r[:-1]):
                logits, caches = model.decode_step(
                    params, caches, torch.tensor([[tok]], device=dev), len(p) + i)
                steps.append(logits[0])
            errs = [normwise(served, ref) for served, ref in zip(rec["logits"], steps)]
            per_request.append((len(p), max(errs), errs.index(max(errs)), len(errs)))
            worst = max(worst, *errs)
            same += sum(int(ref.argmax()) == tok for ref, tok in zip(steps, r))
            total += len(errs)
            del caches
    plain_launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    halo.finalize()
    print(f"  plain replay on the card (manifest prefers torch): worst normwise "
          f"logits error {worst:.3e} over {total} steps (tol {SERVE_TOL:g}); "
          f"{same} of {total} served tokens equal the plain argmax")
    print("  per request (prompt, worst error, at step, steps): " + "; ".join(
        f"{n_} {e:.2e} @{i}/{k}" for n_, e, i, k in per_request))
    if plain_launches:
        fail(f"the plain replay launched kernels: {plain_launches}")
    if not worst <= SERVE_TOL:
        fail(f"served logits differ from the plain replay by {worst:.3e}")
    stats.update(plain_worst_err=worst, plain_argmax_agree=same, steps_checked=total)

    # where the bfloat16 gap comes from: the same weights widened to float32
    # on the kernels against the plain versions (F32_SERVE_TOL), and the
    # bfloat16 gap of the 512-token prefill against the depth kept.  The
    # float32 prefill is the path of FLASH_ATTN's and MMM's 3×TF32 routes:
    # their launches are counted over the kernels' replay alone
    prompt, toks = prompts[0], results[0][:4]
    wide32 = torch.utils._pytree.tree_map(lambda t: t.float(), params)
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    _cuda.reset_launch_counts()
    served32 = replay(m32, wide32, prompt, toks, max_len, None)
    f32_launches = _cuda.launch_counts()
    e32 = [normwise(k, r) for k, r in zip(
        served32, replay(m32, wide32, prompt, toks, max_len, plain))]
    del wide32, served32
    attn_f32 = {k: f32_launches[k] for k in ("flash_attention_mma", "flash_attention_tf32x3",
                                             "flash_attention_wgmma")}
    mmm_f32 = {k: f32_launches[k] for k in ("mmm_wgmma", "mmm_tf32x3")}
    print(f"  float32 replay on the kernels: FLASH_ATTN launches {attn_f32}, "
          f"prefill MMM launches {mmm_f32}")
    if attn_f32 != {"flash_attention_mma": 0, "flash_attention_tf32x3": layers,
                    "flash_attention_wgmma": 0}:
        fail(f"the float32 prefill launched FLASH_ATTN {attn_f32}, not {layers} "
             f"on the 3×TF32 route")
    if mmm_f32 != {"mmm_wgmma": 0, "mmm_tf32x3": 7 * layers}:
        fail(f"the float32 prefill launched MMM {mmm_f32}, not {7 * layers} on the "
             f"3×TF32 route")
    print(f"  float32, same weights, {len(prompt)}-token prompt + {len(toks) - 1} "
          f"decode steps, kernels vs plain: {', '.join(f'{e:.2e}' for e in e32)} "
          f"(tol {F32_SERVE_TOL:g})")
    if not max(e32) <= F32_SERVE_TOL:
        fail(f"float32 served logits differ from the plain versions by {max(e32):.3e}")
    depth = {}
    for n_layers in sorted({n_ for n_ in (1, 3, 6, 12) if n_ < cfg.n_layers}
                           | {cfg.n_layers}):
        cut = dataclasses.replace(cfg, stages=(dataclasses.replace(
            cfg.stages[0], repeats=n_layers),))
        sliced = dict(params, stages=[torch.utils._pytree.tree_map(
            lambda t: t[:n_layers], params["stages"][0])])
        mc = build_model(cut)
        depth[n_layers] = normwise(replay(mc, sliced, prompt, toks[:1], max_len, None)[0],
                                   replay(mc, sliced, prompt, toks[:1], max_len, plain)[0])
    print(f"  {cfg.dtype} prefill gap, kernels vs plain, by layers kept: " + ", ".join(
        f"{n_}: {e:.2e}" for n_, e in depth.items()))
    stats.update(f32_err=e32, bf16_gap_by_depth=depth)
    paged_launches, stats["paged"] = phase3b_paged(dev, model, params, prompts, max_news,
                                                   results, records, launches, max_len)
    return launches, stats, f32_launches, paged_launches


def phase3b_paged(dev, model, params, prompts, max_news, results, records, dense_launches,
                  max_len):
    """The danube leg's model, weights and requests on a PagedEngine
    (SERVE_PAGED) through ``run_requests`` on the kernels.  (a) Whole-prompt
    admission: the dense leg's tokens, launch counts and every recorded
    logit bit for bit (the views are gathered to the dense cache's shape,
    masked positions score -1e30 either way).  (b) Chunked prefill, 256
    tokens a chunk, requests 5 and 7 beginning with request 1's first 448
    tokens: the expected prefix hits and no eviction, every block back at
    drain, launch counts by the chunks' rows (7·L MMMs a chunk on the wgmma
    route past 64 rows, else skinny; one skinny unembed a chunk; no
    FLASH_ATTN in a chunk), each request's end-of-prefill and decode logits
    (teacher-forced on its tokens) within SERVE_TOL of a dense one-lane
    replay on the kernels.  Prints tokens/s, prefill and decode-step ms,
    the arena scorecard, and the device time of one decode step's gather
    and scatter beside the bytes they move."""
    from repro_torch import halo
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import arena_line, run_requests, summary
    from repro_torch.serve.engine import PagedEngine, StepScheduler
    from repro_torch.serve.kvcache import gather_views, scatter_token

    cfg = model.cfg
    layers = cfg.n_layers
    bs, slots = SERVE_PAGED["block_size"], SERVE["slots"]
    Engine = recording_engine(paged=True)
    out_launches, out = {}, {}
    for leg, chunk in (("whole", 0), ("chunked", SERVE_PAGED["chunk"])):
        reqs = [list(p_) for p_ in prompts]
        if chunk:
            for i in SERVE_PAGED["sharers"]:
                reqs[i][:SERVE_PAGED["shared_tokens"]] = prompts[0][:SERVE_PAGED["shared_tokens"]]
        session = halo.initialize()            # device=None means the card
        engine = Engine(model, params, slots, max_len, block_size=bs, chunk_tokens=chunk)
        sched = StepScheduler(engine, temperature=0.0, seed=SERVE["seed"])
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _cuda.reset_launch_counts()
        session.reset_t1()
        res, lat, wall = run_requests(sched, reqs, max_news)
        torch.cuda.synchronize(dev)
        launches = _cuda.launch_counts()
        quarantined = session.scheduler.failed_record_keys()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        st_ = engine.stats()
        print(f"  paged danube, {leg} admission (block {bs}, chunk {engine.chunk_tokens}, "
              f"{engine.num_blocks} blocks):")
        for line in summary(res, lat, wall, sched.report()) + [arena_line(st_)]:
            print("    " + line)
        print(f"    launches {launches}; quarantine {quarantined}; pool {engine.pool.stats()}")
        if [len(r) for r in res] != max_news:
            fail(f"paged {leg}: served {[len(r) for r in res]} tokens, budgets {max_news}")
        graph_stats = check_captured(f"paged {leg}", engine, len(engine.decode_s))
        if quarantined:
            fail(f"records were quarantined on the paged {leg} leg: {quarantined}")
        engine.pool.check()
        if engine.pool.live_blocks() or engine.pool.reserved:
            fail(f"paged {leg}: {engine.pool.live_blocks()} blocks live and "
                 f"{engine.pool.reserved} reserved at drain")
        prefill_ms = {str(L): [t * 1e3 for n_, t in engine.prefill_s if n_ == L]
                      for L in SERVE["prompt_lens"]}
        decode_ms = sorted(t * 1e3 for t in engine.decode_s)
        stats = {"tokens_per_s": sum(map(len, res)) / wall, "wall_s": wall,
                 "prefill_ms": prefill_ms, "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
                 "decode_steps": len(decode_ms), "peak_gb": peak_gb, "arena": st_,
                 "launches": launches, "decode_graph": graph_stats,
                 "replay_step_ms_median": statistics.median(engine.replay_s) * 1e3}
        print(f"    prefill ms by prompt: " + "; ".join(
            f"{L}: {', '.join(f'{x:.1f}' for x in v)}" for L, v in prefill_ms.items())
            + f"; decode step median {stats['decode_step_ms_median']:.2f} ms over "
            f"{len(decode_ms)} (replays {stats['replay_step_ms_median']:.2f}); peak memory "
            f"{peak_gb:.2f} GB")
        # records in the order prefills completed: matched to requests by prompt
        by_prompt = {tuple(r_["prompt"]): r_ for r_ in engine.records}
        recs = [by_prompt.get(tuple(p_)) for p_ in reqs]
        if None in recs:
            fail(f"paged {leg}: a request's prefill left no record")
        if not chunk:
            # (a) the dense leg's tokens, launch counts and logits, bit for bit
            if res != results:
                fail("whole-prompt paged serving served other tokens than the dense leg")
            if launches != dense_launches:
                fail(f"whole-prompt paged launches {launches} != the dense leg's "
                     f"{dense_launches}")
            dense = {tuple(r_["prompt"]): r_ for r_ in records}
            pairs = [(a_, b_) for ra in recs
                     for a_, b_ in zip(ra["logits"], dense[tuple(ra["prompt"])]["logits"])]
            same = sum(torch.equal(a_, b_) for a_, b_ in pairs)
            n_steps = sum(len(r["logits"]) for r in records)
            print(f"    {same} of {n_steps} recorded logit rows bit-identical to the dense "
                  f"leg's")
            if len(pairs) != n_steps or same != n_steps:
                worst = max(normwise(a_, b_) for a_, b_ in pairs)
                fail(f"whole-prompt paged logits differ from the dense leg's in "
                     f"{n_steps - same} of {n_steps} rows (worst normwise {worst:.3e})")
            stats["bit_identical_rows"] = same
            # one decode step alone, every lane past its prompt: captured and
            # eager (the chunked leg's decode step is this one: chunks change
            # admission only)
            lone = PagedEngine(model, params, slots, max_len + lone_steps(5), block_size=bs,
                               chunk_tokens=0)
            stats["alone"] = lone_decode(dev, slot_stepper(lone, lambda i: (
                lone.begin_admission(i, prompts[i], lone_steps(5) + 1, None),
                len(prompts[i])), slots), lone, 5)
            print(f"    ({slots} lanes) " + lone_line(stats["alone"]))
            del lone
        else:
            # (b) prefix hits, launches by the chunks' rows, logits vs dense
            if st_["prefix_hits"] != SERVE_PAGED["prefix_hits"] or st_["evictions"]:
                fail(f"chunked paged serving: {st_['prefix_hits']} prefix hits and "
                     f"{st_['evictions']} evictions, expected "
                     f"{SERVE_PAGED['prefix_hits']} and 0")
            rows, decodes = engine.chunk_rows, len(engine.decode_s)
            n_wide = sum(r > 64 for r in rows)
            expected = {k: 0 for k in launches}
            expected.update(mmm_wgmma=7 * layers * n_wide,
                            mmm_skinny=7 * layers * (len(rows) - n_wide) + len(rows)
                            + (7 * layers + 1) * decodes,
                            rmsnorm=(2 * layers + 1) * (len(rows) + decodes))
            print(f"    {len(rows)} chunks ({n_wide} past 64 rows; rows {sorted(set(rows))}) + "
                  f"{decodes} decode steps: expected launches {expected}")
            if launches != expected:
                fail(f"chunked paged launches {launches} != the chunks' structure {expected}")
            worst_prefill = worst_decode = 0.0
            for rec, r in zip(recs, res):
                ref = replay(model, params, rec["prompt"], r, max_len, None)
                if len(ref) != len(rec["logits"]):
                    fail("the chunked leg's recorded steps do not match its requests")
                worst_prefill = max(worst_prefill, normwise(rec["logits"][0], ref[0]))
                worst_decode = max([worst_decode] + [normwise(a_, b_) for a_, b_ in
                                                     zip(rec["logits"][1:], ref[1:])])
            print(f"    vs a dense one-lane replay on the kernels: end-of-prefill logits worst "
                  f"{worst_prefill:.3e}, decode logits (teacher-forced) worst "
                  f"{worst_decode:.3e} (tol {SERVE_TOL:g})")
            if not max(worst_prefill, worst_decode) <= SERVE_TOL:
                fail(f"chunked paged logits differ from the dense replay by "
                     f"{max(worst_prefill, worst_decode):.3e}")
            stats.update(prefill_vs_dense=worst_prefill, decode_vs_dense=worst_decode,
                         chunks=len(rows), chunks_wide=n_wide)
            # one decode step's gather and scatter over 4 full lanes
            halo.initialize()
            m = engine.blocks_per_lane
            tables = torch.arange(1, 1 + slots * m, device=dev).reshape(slots, m)
            pos = torch.tensor([len(p_) for p_ in prompts[:slots]], device=dev)
            act = torch.ones(slots, dtype=torch.bool, device=dev)
            views = gather_views(engine.layout, engine.paged, tables, bs)
            view_bytes = sum(v.numel() * v.element_size()
                             for v in torch.utils._pytree.tree_leaves(views))
            g_ms = median_device_ms(lambda: gather_views(engine.layout, engine.paged, tables,
                                                         bs), dev)
            s_ms = median_device_ms(lambda: scatter_token(engine.layout, engine.paged, views,
                                                          tables, pos, act, bs), dev)
            bw = peaks(torch.cuda.get_device_name(dev))[1][0]
            stats.update(gather_ms=g_ms, scatter_ms=s_ms, gather_bytes=2 * view_bytes,
                         gather_bound_ms=2 * view_bytes / bw * 1e3)
            print(f"    one decode step's gather ({slots} lanes × {m} blocks, 2·{layers} "
                  f"leaves): {g_ms:.4f} ms of device time for {2 * view_bytes / 1e9:.3f} GB "
                  f"read and written (bound {stats['gather_bound_ms']:.4f} ms at "
                  f"{bw / 1e12:g} TB/s); scatter of the {slots} written entries "
                  f"{s_ms:.4f} ms")
            del views
        out[leg] = stats
        out_launches[f"serve_paged_{leg}"] = launches
        del engine, sched
        halo.finalize()
        torch.cuda.empty_cache()
    return out_launches, out


def phase3m(dev, card):
    """The captured decode step against the eager body at danube's full
    width (DECODE_GRAPH), on a SlotEngine and a PagedEngine through
    ``run_requests``: before each step a twin engine's caches take a copy
    of the engine's, the twin runs the eager body (``_decode_body``) and
    the engine its step (the first eager, the second captured, the rest
    replays); every step's logits and every cache leaf after it
    ``torch.equal`` between the two, each timed by the host clock to a
    synchronise.  Then one decode step alone (``lone_decode``): captured
    and eager by the host clock and device time, busy shares, the capturing
    step's ms and its graph pool.  Launch counts of the
    path: the dense engine's timed captured steps (replays credited)
    against 7·L + 1 skinny MMMs and 2·L + 1 RMSNORMs a step.  Returns
    (launches, stats)."""
    import torch.utils._pytree as pytree

    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.matmul.matmul import mmm_route
    from repro_torch.launch.serve import run_requests
    from repro_torch.models import build_model
    from repro_torch.serve.engine import PagedEngine, SlotEngine, StepScheduler

    leg = DECODE_GRAPH
    cfg = get_config(leg["arch"])
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(leg["seed"])
    params = model.init(gen)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).tolist()
               for n in leg["prompt_lens"]]
    max_news = list(leg["max_new"])
    max_len = max(leg["prompt_lens"]) + max(max_news) + 8
    slots, layers = leg["slots"], cfg.n_layers
    session = halo.initialize()
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    out, launches = {}, {}
    for name in ("dense", "paged"):
        def make():
            if name == "paged":
                return PagedEngine(model, params, slots, max_len,
                                   block_size=SERVE_PAGED["block_size"], chunk_tokens=0)
            return SlotEngine(model, params, slots, max_len)
        engine, twin = make(), make()
        caches = (lambda e: e.paged) if name == "paged" else (lambda e: e.caches)
        rows = []
        captured_step = engine._decode_logits

        def both(tok, pos, act):
            for d, s_ in zip(pytree.tree_leaves(caches(twin)), pytree.tree_leaves(caches(engine))):
                d.copy_(s_)
            extra = (torch.from_numpy(engine.tables).to(dev),) if name == "paged" else ()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            eager = twin._decode_body(tok.to(dev), pos.to(dev), act.to(dev), *extra)
            torch.cuda.synchronize(dev)
            reserved = torch.cuda.memory_reserved(dev)
            t1 = time.perf_counter()
            got = captured_step(tok, pos, act)
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            same = all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(caches(twin)),
                                                         pytree.tree_leaves(caches(engine))))
            rows.append({"logits": bool(torch.equal(eager, got)), "caches": same,
                         "active": int(act.sum()), "eager_ms": (t1 - t0) * 1e3,
                         "step_ms": (t2 - t1) * 1e3,
                         "reserved_gb": (torch.cuda.memory_reserved(dev) - reserved) / 1e9})
            return got
        engine._decode_logits = both
        results, _, wall = run_requests(StepScheduler(engine, seed=leg["seed"]), prompts,
                                        max_news)
        stats = check_captured(f"3m {name}", engine, len(rows))
        if [len(r) for r in results] != max_news or len(rows) < 8:
            fail(f"3m {name}: served {[len(r) for r in results]} tokens in {len(rows)} "
                 f"decode steps")
        bad = [i for i, r in enumerate(rows) if not (r["logits"] and r["caches"])]
        replays = rows[2:]
        res = {"steps": len(rows), "lanes_by_step": [r["active"] for r in rows],
               "not_equal_steps": bad, "capture_ms": rows[1]["step_ms"],
               "pool_gb": rows[1]["reserved_gb"],
               "replay_step_ms": statistics.median(r["step_ms"] for r in replays),
               "eager_body_ms": statistics.median(r["eager_ms"] for r in replays),
               "first_steps_ms": [r["step_ms"] for r in rows[:2]], "decode_graph": stats,
               "wall_s": wall}
        print(f"  {name}: {len(rows)} decode steps, lanes active by step "
              f"{res['lanes_by_step']}; captured vs eager body from the same caches: "
              f"logits and every cache leaf torch.equal at {len(rows) - len(bad)} of "
              f"{len(rows)} steps; the body a step, host clock to a synchronise, median "
              f"over the {len(replays)} replays: captured {res['replay_step_ms']:.3f} ms, "
              f"eager {res['eager_body_ms']:.3f} ms (the eager step "
              f"{rows[0]['step_ms']:.1f}); the capturing step (capture + its replay) "
              f"{res['capture_ms']:.1f} ms, graph pool {res['pool_gb']:.3f} GB; {card}")
        if bad:
            fail(f"3m {name}: the captured step differs from the eager body at steps {bad}")
        del engine._decode_logits           # the wrapper's cycle through the engine
        del engine, twin, rows
        # one decode step alone, every slot past its prompt
        lone = make()
        steps = lone_steps(leg["runs"])
        if name == "paged":
            def admit(i):
                return (lone.begin_admission(i, prompts[i], steps + 1, None),
                        len(prompts[i]))
        else:
            def admit(i):
                return lone.prefill_into_slot(i, prompts[i], None), len(prompts[i])
        _cuda.reset_launch_counts()
        alone = lone_decode(dev, slot_stepper(lone, admit, slots), lone, leg["runs"])
        got = {k: v for k, v in _cuda.launch_counts().items() if v}
        # a prefill: 7·L projections on the route of its rows and a one-row
        # unembed; a decode step: 7·L + 1 one-row-a-lane MMMs
        want = collections.Counter({"mmm_skinny": (7 * layers + 1) * steps + slots,
                                    "rmsnorm": (2 * layers + 1) * (steps + slots),
                                    "flash_attention_mma": layers * slots})
        for n_ in leg["prompt_lens"][:slots]:
            want[f"mmm_{mmm_route(cfg.activation_dtype(), n_)}"] += 7 * layers
        want = dict(want)
        print(f"  {name} " + lone_line(alone) + f"; {card}")
        print(f"  {name}: launches {got} over {slots} prefills and {steps} decode steps "
              f"(expected {want})")
        if got != want:
            fail(f"3m {name}: launches {got}, not {want}: replays were not credited")
        res["alone"] = alone
        launches[name] = got
        out[name] = res
        del lone
        torch.cuda.empty_cache()
    halo.finalize()
    total = collections.Counter()
    for got in launches.values():
        total.update(got)
    return dict(total), out


def phase3b_d256(dev):
    """gemma3-4b, cut to one 5:1 pattern, served through ``run_requests`` on
    ``halo.initialize()`` (SERVE_D256): every prefill's attention is bfloat16
    at head dim 256, FLASH_ATTN's wgmma route, one launch a layer; no other
    FLASH_ATTN route moves.  One 2048-token request's logits at every step
    against a replay through the plain versions on the card (SERVE_TOL),
    and FLASH_ATTN's device time from a profiled rerun."""
    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.core.manifest import default_manifest
    from repro_torch.kernels import _cuda
    from repro_torch.core.registry import KernelRegistry
    from repro_torch.kernels import register_all
    from repro_torch.launch.serve import run_requests
    from repro_torch.models import build_model
    from repro_torch.serve.engine import SlotEngine, StepScheduler

    full = get_config(SERVE_D256["arch"])
    cfg = dataclasses.replace(full, stages=(dataclasses.replace(
        full.stages[0], repeats=SERVE_D256["pattern_repeats"]),))
    attn = cfg.stages[0].pattern[0].attn
    windows = [b.attn.window for b in cfg.stages[0].pattern]
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SERVE_D256["seed"])
    params = model.init(gen)
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} of {full.n_layers} layers (windows {windows}), "
          f"d_model {cfg.d_model}, {attn.n_heads} heads of {attn.head_dim} on "
          f"{attn.n_kv_heads} KV heads, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
          f"parameters in {cfg.dtype}, random from seed {SERVE_D256['seed']}")
    n, lens = SERVE_D256["requests"], SERVE_D256["prompt_lens"]
    prompts = [torch.randint(0, cfg.vocab_size, (lens[i % len(lens)],), generator=gen,
                             device=dev).tolist() for i in range(n)]
    max_news = [SERVE_D256["max_new"]] * n
    max_len = max(lens) + SERVE_D256["max_new"] + cfg.prefix_len + 8

    session = halo.initialize()              # device=None means the card
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    warm = StepScheduler(SlotEngine(model, params, 1, 80), seed=SERVE_D256["seed"])
    run_requests(warm, [prompts[0][:64]], [2])
    del warm
    engine = recording_engine()(model, params, SERVE_D256["slots"], max_len)
    sched = StepScheduler(engine, temperature=0.0, seed=SERVE_D256["seed"])
    torch.cuda.synchronize(dev)
    _cuda.reset_launch_counts()
    results, lat, wall = run_requests(sched, prompts, max_news)
    torch.cuda.synchronize(dev)
    launches = _cuda.launch_counts()
    quarantined = session.scheduler.failed_record_keys()
    prefills = len(engine.prefill_s)
    attn_counts = {k: launches[k] for k in ("flash_attention_mma", "flash_attention_tf32x3",
                                            "flash_attention_wgmma")}
    want = {"flash_attention_mma": 0, "flash_attention_tf32x3": 0,
            "flash_attention_wgmma": cfg.n_layers * prefills}
    print(f"  {prefills} prefills + {len(engine.decode_s)} decode steps on "
          f"{SERVE_D256['slots']} slots: FLASH_ATTN launches {attn_counts} (expected "
          f"{want}); all launches {launches}; quarantine {quarantined}")
    if [len(r) for r in results] != max_news or prefills != n:
        fail(f"served {[len(r) for r in results]} tokens in {prefills} prefills, budgets "
             f"{max_news}")
    graph_stats = check_captured(cfg.name, engine, len(engine.decode_s))
    if attn_counts != want:
        fail(f"the head-dim-256 leg launched FLASH_ATTN {attn_counts}, not {want}")
    if quarantined:
        fail(f"records were quarantined on the head-dim-256 leg: {quarantined}")
    for rec, p_ in zip(engine.records, prompts):
        if rec["prompt"] != p_ or not all(bool(torch.isfinite(x).all())
                                          and x.shape == (cfg.padded_vocab,)
                                          for x in rec["logits"]):
            fail("the head-dim-256 leg's logits are not finite, not of the vocab's width "
                 "or not its requests'")
    prefill_ms = {str(L): [t * 1e3 for n_, t in engine.prefill_s if n_ == L] for L in lens}
    stats = {"arch": cfg.name, "layers": cfg.n_layers, "launches": launches,
             "tokens_per_s": sum(map(len, results)) / wall, "wall_s": wall,
             "prefill_ms": prefill_ms, "decode_graph": graph_stats,
             "decode_step_ms_median": statistics.median(engine.decode_s) * 1e3,
             "replay_step_ms_median": statistics.median(engine.replay_s) * 1e3}
    records = engine.records
    del engine, sched
    # the same requests under torch.profiler: FLASH_ATTN's device time
    again, prof, _, stats["profiled_by"] = profiled_rerun(
        dev, lambda: SlotEngine(model, params, SERVE_D256["slots"], max_len), prompts,
        max_news, SERVE_D256["seed"])
    if again != results:
        fail("a second greedy run of the head-dim-256 leg served other tokens")
    fa_s = sum(device_seconds_of(e) for e in prof.key_averages()
               if e.key.split("<")[0].split("::")[-1].strip() == "fa16_wgmma_kernel")
    busy_s = device_seconds(prof)
    stats["flash_attention_device_ms"] = fa_s * 1e3 if fa_s > 0 else None
    stats["device_ms"] = busy_s * 1e3 if busy_s > 0 else None
    stats["device_busy_share"] = busy_s / wall if busy_s > 0 else None
    stats["alone"] = lone_slot_decode(dev, model, params, SERVE_D256["slots"], prompts,
                                      max_len, 3)
    halo.finalize()
    print(f"  ({SERVE_D256['slots']} slots) " + lone_line(stats["alone"]))
    print(f"  {stats['tokens_per_s']:.2f} tokens/s over {wall:.2f} s; prefill ms by prompt: "
          + "; ".join(f"{L}: {', '.join(f'{x:.1f}' for x in v)}" for L, v in prefill_ms.items())
          + "; FLASH_ATTN device time (profiled rerun, "
          + f"{cfg.n_layers * prefills} launches): "
          + (f"{fa_s * 1e3:.3f} ms" if fa_s > 0 else "not measured")
          + "; all device time: "
          + (f"{busy_s * 1e3:.1f} ms, busy share {busy_s / wall:.3f}" if busy_s > 0
             else "not measured")
          + f"; decode step median {stats['decode_step_ms_median']:.2f} ms (replays "
          f"{stats['replay_step_ms_median']:.2f})")

    # one 2048-token request, every step, against the plain versions
    plain = default_manifest()
    plain.platform_list = [{"platform_preference": ["torch"]}]
    i = lens.index(max(lens))
    _cuda.reset_launch_counts()
    ref = replay(model, params, prompts[i], results[i], max_len, plain)
    if any(_cuda.launch_counts().values()):
        fail("the plain replay of the head-dim-256 leg launched kernels")
    errs = [normwise(k_, r_) for k_, r_ in zip(records[i]["logits"], ref)]
    print(f"  {len(prompts[i])}-token request vs the plain replay on the card: worst "
          f"normwise logits error {max(errs):.3e} over {len(errs)} steps (tol "
          f"{SERVE_TOL:g})")
    if len(errs) != len(results[i]) or not max(errs) <= SERVE_TOL:
        fail(f"the head-dim-256 leg's logits differ from the plain replay by {max(errs):.3e}")
    stats["plain_worst_err"] = max(errs)
    stats["chunked_prefill"] = d256_chunk_check(dev, model, params, prompts[i],
                                                records[i]["logits"][0], max_len)

    # where the gap comes from: the same request's prefill, kernels vs
    # plain, by the pattern's blocks kept; and at full depth with
    # FLASH_ATTN alone on its plain version (a registry without its
    # hopper and aten records), so the wgmma kernel's share is measured
    prompt, first = prompts[i], results[i][:1]
    depth = {}
    for n_blocks in range(1, cfg.n_layers + 1):
        cut = dataclasses.replace(cfg, stages=(dataclasses.replace(
            cfg.stages[0], pattern=cfg.stages[0].pattern[:n_blocks]),))
        sliced = dict(params, stages=[params["stages"][0][:n_blocks]])
        mc = build_model(cut)
        depth[n_blocks] = normwise(replay(mc, sliced, prompt, first, max_len, None)[0],
                                   replay(mc, sliced, prompt, first, max_len, plain)[0])
    no_fa = KernelRegistry()
    register_all(no_fa)
    no_fa.deregister("FLASH_ATTN", "hopper")
    no_fa.deregister("FLASH_ATTN", "aten")
    _cuda.reset_launch_counts()
    fa_plain = replay(model, params, prompt, first, max_len, None, registry=no_fa)[0]
    moved = _cuda.launch_counts()
    if any(moved[k] for k in attn_counts) or not moved["mmm_wgmma"]:
        fail(f"the replay with FLASH_ATTN on its plain version launched {moved}")
    kernels_ref = replay(model, params, prompt, first, max_len, None)[0]
    gap = {"fa_plain_vs_plain": normwise(fa_plain, ref[0]),
           "kernels_vs_fa_plain": normwise(kernels_ref, fa_plain)}
    print(f"  {cfg.dtype} prefill gap of the {len(prompt)}-token request, kernels vs "
          f"plain, by blocks kept ({', '.join(str(w) for w in windows)}): " + ", ".join(
              f"{n_}: {e:.2e}" for n_, e in depth.items())
          + f"; at {cfg.n_layers}, FLASH_ATTN alone on its plain version vs plain "
          f"{gap['fa_plain_vs_plain']:.2e}, kernels vs that {gap['kernels_vs_fa_plain']:.2e}")
    stats.update(bf16_gap_by_depth=depth, **gap)
    return launches, stats


def d256_chunk_check(dev, model, params, prompt, whole_logits, max_len):
    """The gemma3-4b leg's 2048-token request through
    ``Model.prefill_chunk``, D256_CHUNK tokens a chunk from an empty cache
    on the kernels: the 5 local layers take ``chunk_ring_attention`` over
    their 1024-slot rings, the global layer ``chunk_attention``, at head
    dim 256.  Launch counts by the chunks (7·L wgmma MMMs and one skinny
    unembed a chunk, no FLASH_ATTN); the last chunk's logits within
    SERVE_TOL of the leg's whole-prompt prefill."""
    from repro_torch import halo
    from repro_torch.kernels import _cuda

    cfg = model.cfg
    halo.initialize()
    try:
        with torch.no_grad():
            cache = model.init_cache(1, max_len, device=dev)
            toks = torch.tensor([prompt], device=dev)
            chunks = list(range(0, len(prompt), D256_CHUNK))
            torch.cuda.synchronize(dev)
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            for p0 in chunks:
                logits, cache = model.prefill_chunk(params, cache,
                                                    toks[:, p0:p0 + D256_CHUNK], p0)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    finally:
        halo.finalize()
    rings = sorted({c.shape[3] for c in torch.utils._pytree.tree_leaves(cache)})
    expected = {"mmm_wgmma": 7 * cfg.n_layers * len(chunks), "mmm_skinny": len(chunks),
                "rmsnorm": (2 * cfg.n_layers + 1) * len(chunks)}
    err = normwise(logits[0].float(), whole_logits)
    print(f"  the {len(prompt)}-token request through prefill_chunk, {len(chunks)} chunks "
          f"of {D256_CHUNK} (cache lengths {rings}): {wall_ms:.1f} ms host clock; launches "
          f"{launches} (expected {expected}); last chunk's logits vs the whole prefill "
          f"{err:.3e} (tol {SERVE_TOL:g})")
    if launches != expected:
        fail(f"the gemma3-4b chunked prefill launched {launches}, not {expected}")
    if not err <= SERVE_TOL:
        fail(f"gemma3-4b's chunked prefill differs from its whole prefill by {err:.3e}")
    return {"err": err, "chunks": len(chunks), "wall_ms": wall_ms, "launches": launches}


def wrapped_registry(wrap):
    """A registry of every record ``register_all`` publishes, each record's
    function replaced by ``wrap(record)`` where that is not None."""
    from repro_torch.core.registry import KernelRegistry
    from repro_torch.kernels import register_all

    full, reg = KernelRegistry(), KernelRegistry()
    register_all(full)
    for alias in full.aliases():
        for rec in full.records(alias):
            fn = wrap(rec)
            reg.register(rec if fn is None else dataclasses.replace(rec, fn=fn))
    return reg


def counting_registry():
    """``wrapped_registry`` with every record's function adding one to a
    count keyed "ALIAS/platform" when it is called; returns (registry,
    counts).  SSD and SSD_DECODE have no kernel, so no launch counter
    stands behind them."""
    counts = collections.Counter()

    def wrap(rec):
        key = f"{rec.alias}/{rec.platform}"

        @functools.wraps(rec.fn)
        def counted(*args, _fn=rec.fn, **kwargs):
            counts[key] += 1
            return _fn(*args, **kwargs)
        return counted
    return wrapped_registry(wrap), counts


def first_blocks(cfg, params, k: int):
    """``cfg`` and ``params`` cut to the first ``k`` blocks in the order they
    run (whole repeats of a stage, then a prefix of its pattern); the
    shared block's one weight copy stays."""
    stages, sp = [], []
    for st, p in zip(cfg.stages, params["stages"]):
        n = len(st.pattern)
        whole = min(st.repeats, k // n)
        if whole:
            stages.append(dataclasses.replace(st, repeats=whole))
            sp.append(torch.utils._pytree.tree_map(lambda t: t[:whole], p))
            k -= whole * n
        if 0 < k < n and whole < st.repeats:
            stages.append(dataclasses.replace(st, pattern=st.pattern[:k], repeats=1))
            sp.append(torch.utils._pytree.tree_map(lambda t: t[whole:whole + 1], p[:k]))
            k = 0
    return dataclasses.replace(cfg, stages=tuple(stages)), dict(params, stages=sp)


def serve_leg(dev, leg: dict, cfg, note: str, expect, capture: bool = False):
    """``cfg`` with random weights from ``leg["seed"]``, its requests
    (``leg["requests"]`` prompts of ``leg["prompt_lens"]`` in turn,
    ``leg["max_new"]`` greedy tokens each, on ``leg["slots"]`` slots)
    served through ``run_requests`` on ``halo.initialize()`` with a
    counting registry, after a one-request warm-up; with ``capture`` the
    longest request's block inputs are captured on the way
    (``BlockCapture``).  ``expect(prefills, decodes)`` gives the launch
    counts the model's structure predicts (a kernel it does not name: 0)
    and the dispatch counts of the "ALIAS/platform" keys it names: the
    launches at every decode step (replays credited), the dispatches at
    the steps that dispatched (the eager ones and the capture).
    Checks the tokens served, both counts, an empty quarantine, every
    request's logits finite and of the vocab's width, and a profiled
    rerun that serves the same tokens; then one decode step alone
    (``lone_slot_decode``).  Prints tokens/s, prefill and decode-step ms,
    T1, peak memory, the rerun's device time by kernel and the lone step's
    figures.
    The session stays open.  Returns a namespace: model, params, gen,
    prompts, results, records, max_len, launches, cap, stats, busy_s."""
    from repro_torch import halo
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import run_requests
    from repro_torch.models import build_model
    from repro_torch.serve.engine import SlotEngine, StepScheduler

    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(leg["seed"])
    params = model.init(gen)
    leaves = torch.utils._pytree.tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    print(f"  {cfg.name}: {note}; {n_params / 1e9:.3f} B parameters in {cfg.dtype} "
          f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.1f} GB), random "
          f"from seed {leg['seed']}")
    n, lens = leg["requests"], leg["prompt_lens"]
    prompts = [torch.randint(0, cfg.vocab_size, (lens[i % len(lens)],), generator=gen,
                             device=dev).tolist() for i in range(n)]
    max_news = [leg["max_new"]] * n
    max_len = max(lens) + leg["max_new"] + 8
    cap = BlockCapture(prompts[lens.index(max(lens))], leg["max_new"] - 1) if capture \
        else None

    registry, dispatches = counting_registry()
    session = halo.initialize(registry=registry)     # device=None means the card
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    warm = StepScheduler(SlotEngine(model, params, 1, 80), seed=leg["seed"])
    run_requests(warm, [prompts[0][:64]], [2])
    del warm
    engine = (cap.engine() if cap else recording_engine())(model, params, leg["slots"],
                                                           max_len)
    sched = StepScheduler(engine, temperature=0.0, seed=leg["seed"])
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launch_counts()
    dispatches.clear()
    session.reset_t1()
    with cap.tapping() if cap else contextlib.nullcontext():
        results, _, wall = run_requests(sched, prompts, max_news)
    torch.cuda.synchronize(dev)
    launches = _cuda.launch_counts()
    aliases = dict(sorted(dispatches.items()))
    quarantined = session.scheduler.failed_record_keys()
    t1_us = session.t1_seconds_per_call * 1e6
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prefills, decodes = len(engine.prefill_s), len(engine.decode_s)
    graph_stats = check_captured(cfg.name, engine, decodes, getattr(engine, "tapped", 0))
    dispatched = graph_stats["eager_steps"] + graph_stats["captures"]
    want, _ = expect(prefills, decodes)
    _, want_dispatch = expect(prefills, dispatched)
    expected = {k: 0 for k in launches}
    expected.update(want)
    got_dispatch = {k: aliases.get(k, 0) for k in want_dispatch}
    print(f"  {prefills} prefills + {decodes} decode steps on {leg['slots']} slots: "
          f"launches {launches} (expected {expected}); dispatches {got_dispatch} "
          f"(expected {want_dispatch}, {dispatched} decode passes dispatched); all "
          f"dispatches {aliases}; quarantine {quarantined}")
    if [len(r) for r in results] != max_news or prefills != n:
        fail(f"served {[len(r) for r in results]} tokens in {prefills} prefills, budgets "
             f"{max_news}")
    if launches != expected:
        fail(f"the {cfg.name} leg's launch counts {launches} != the model's structure "
             f"{expected}")
    if got_dispatch != want_dispatch:
        fail(f"the {cfg.name} leg's dispatches {got_dispatch} != the model's structure "
             f"{want_dispatch}")
    if quarantined:
        fail(f"records were quarantined on the {cfg.name} leg: {quarantined}")
    for rec, p_ in zip(engine.records, prompts):
        if rec["prompt"] != p_ or not all(bool(torch.isfinite(x).all())
                                          and x.shape == (cfg.padded_vocab,)
                                          for x in rec["logits"]):
            fail(f"the {cfg.name} leg's logits are not finite, not of the vocab's width "
                 f"or not its requests'")
    prefill_ms = {str(L): [t * 1e3 for n_, t in engine.prefill_s if n_ == L] for L in lens}
    decode_ms = sorted(t * 1e3 for t in engine.decode_s)
    stats = {"arch": cfg.name, "n_params": n_params, "launches": launches,
             "dispatches": aliases, "tokens_per_s": sum(map(len, results)) / wall,
             "wall_s": wall, "prefill_ms": prefill_ms,
             "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
             "decode_steps": decodes, "t1_us_per_dispatch": t1_us, "peak_gb": peak_gb,
             "decode_graph": graph_stats,
             "replay_step_ms_median": statistics.median(engine.replay_s) * 1e3}
    print(f"  {stats['tokens_per_s']:.2f} tokens/s over {wall:.2f} s; prefill ms by "
          f"prompt: " + "; ".join(f"{L}: {', '.join(f'{x:.1f}' for x in v)}"
                                  for L, v in prefill_ms.items())
          + f"; decode step median {stats['decode_step_ms_median']:.2f} ms over "
          f"{decodes} ({decode_ms[0]:.2f}–{decode_ms[-1]:.2f}), the "
          f"{len(engine.replay_s)} replays' {stats['replay_step_ms_median']:.2f}; T1 "
          f"{t1_us:.1f} us per dispatch; peak memory {peak_gb:.2f} GB")
    records = engine.records
    del engine, sched

    # the same requests under torch.profiler: device time by kernel
    again, prof, wall_prof, stats["profiled_by"] = profiled_rerun(
        dev, lambda: SlotEngine(model, params, leg["slots"], max_len), prompts, max_news,
        leg["seed"])
    if again != results:
        fail(f"a second greedy run of the {cfg.name} leg served other tokens")
    busy_s = device_seconds(prof)
    stats["device_ms"] = busy_s * 1e3 if busy_s > 0 else None
    stats["device_busy_share"] = busy_s / wall if busy_s > 0 else None
    if busy_s > 0:
        print(f"  device time {busy_s * 1e3:.1f} ms (profiled rerun, wall "
              f"{wall_prof * 1e3:.1f} ms); busy share {busy_s / wall:.3f} of the counted "
              f"run's {wall * 1e3:.1f} ms; by kernel:")
        top = sorted(prof.key_averages(), key=device_seconds_of, reverse=True)
        stats["device_ms_by_kernel"] = {e.key[:90]: device_seconds_of(e) * 1e3
                                        for e in top[:12]}
        for e in top[:12]:
            print(f"    {device_seconds_of(e) * 1e3:10.1f} ms  {e.count:6d}x  {e.key[:90]}")
    else:
        print("  device time: not measured (the profiler saw none)")
    del prof
    # one decode step alone, every slot past its prompt: captured and eager
    stats["alone"] = lone_slot_decode(dev, model, params, leg["slots"], prompts, max_len, 3)
    print(f"  ({leg['slots']} slots) " + lone_line(stats["alone"]))
    return types.SimpleNamespace(model=model, params=params, gen=gen, prompts=prompts,
                                 results=results, records=records, max_len=max_len,
                                 launches=launches, cap=cap, stats=stats, busy_s=busy_s)


def phase3b_hybrid(dev):
    """zamba2-1.2b at full width and depth served through ``serve_leg``
    (SERVE_HYBRID).  Checks: launch counts by the model's structure
    (FLASH_ATTN's mma route 6 per prefill and no other route; MMM's wgmma
    route for a prefill's projections, skinny for its unembed and every
    decode pass; RMSNORM 2 per Mamba layer and shared invocation + 1 per
    pass); SSD dispatches 38 per prefill and SSD_DECODE 38 per decode
    pass, all on their aten rows; ``serve_leg``'s checks; the 2048-token
    request's logits at every step against a replay through the plain
    versions, at full depth (SERVE_HYBRID_TOL) and with the first pattern
    kept (7 blocks: 6 Mamba layers and the shared block; SERVE_TOL), so
    that bfloat16 decode steps through SSD_DECODE, the conv step and the
    in-place state writes are held to SERVE_TOL too; the same request in
    float32, kernels against plain (F32_SERVE_TOL).  Prints what
    ``serve_leg`` prints and the SSD rows' device time at the leg's
    shapes."""
    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.core.manifest import default_manifest
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.ssd.ops import ssd_chunked, ssd_decode_step
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.models import build_model
    from repro_torch.models.ssm import ssm_dims

    cfg = get_config(SERVE_HYBRID["arch"])
    mamba = [b for st in cfg.stages for b in st.pattern for _ in range(st.repeats)
             if b.kind == "mamba"]
    invocations = sum(st.repeats for st in cfg.stages for b in st.pattern
                      if b.kind == "shared_attn")
    ssm, a_cfg = mamba[0].ssm, cfg.shared_attn
    d_in, heads, _ = ssm_dims(cfg.d_model, ssm)
    blocks = len(mamba) + invocations
    mmm_pass = sum(hybrid_projections(cfg).values())

    def expect(prefills, decodes):
        return (dict(mmm_wgmma=(mmm_pass - 1) * prefills,
                     mmm_skinny=mmm_pass * decodes + prefills,
                     rmsnorm=(2 * blocks + 1) * (prefills + decodes),
                     flash_attention_mma=invocations * prefills),
                {"SSD/aten": len(mamba) * prefills, "SSD/torch": 0,
                 "SSD_DECODE/aten": len(mamba) * decodes, "SSD_DECODE/torch": 0})

    note = (f"{len(mamba)} Mamba-2 layers (d_in {d_in}, {heads} heads of {ssm.head_dim}, "
            f"state {ssm.state_dim}, conv {ssm.conv_width}, chunk {ssm.chunk}) + a shared "
            f"block ({a_cfg.n_heads} heads of {a_cfg.head_dim}, d_ff {cfg.shared_d_ff}) "
            f"invoked {invocations} times; d_model {cfg.d_model}, vocab {cfg.vocab_size}")
    leg = serve_leg(dev, SERVE_HYBRID, cfg, note, expect)
    model, params, prompts, results = leg.model, leg.params, leg.prompts, leg.results
    lens, max_len, stats = SERVE_HYBRID["prompt_lens"], leg.max_len, leg.stats
    launches, records = leg.launches, leg.records
    stats["blocks"] = blocks

    # the SSD rows at the leg's shapes: device time per call
    gen2 = torch.Generator(device=dev).manual_seed(3)
    ssd_ms = {}
    for L in lens:
        args = ssd_inputs(1, L, heads, ssm.head_dim, ssm.n_groups, ssm.state_dim,
                          torch.bfloat16, gen2, dev)
        ssd_ms[f"aten_{L}"] = median_device_ms(
            lambda: ssd_chunked(*args, chunk=ssm.chunk, return_state=True), dev)
    args = ssd_inputs(SERVE_HYBRID["slots"], 1, heads, ssm.head_dim, ssm.n_groups,
                      ssm.state_dim, torch.bfloat16, gen2, dev)
    h0 = torch.zeros((SERVE_HYBRID["slots"], heads, ssm.head_dim, ssm.state_dim),
                     device=dev)
    step = (h0, args[0][:, 0], args[1][:, 0], args[2], args[3][:, 0], args[4][:, 0],
            args[5])
    ssd_ms["decode"] = median_device_ms(lambda: ssd_decode_step(*step), dev)
    args = ssd_inputs(1, max(lens), heads, ssm.head_dim, ssm.n_groups, ssm.state_dim,
                      torch.bfloat16, gen2, dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ssd_ref(*args, return_state=True)
    end.record()
    end.synchronize()
    ssd_ms[f"scan_{max(lens)}_events"] = start.elapsed_time(end)
    stats["ssd_ms"] = ssd_ms
    print(f"  SSD device ms per call (bf16, {heads} heads of {ssm.head_dim}, state "
          f"{ssm.state_dim}): aten row (chunked) " + ", ".join(
              f"{L} tokens {ssd_ms[f'aten_{L}']:.4f}" for L in lens)
          + f"; SSD_DECODE at {SERVE_HYBRID['slots']} lanes {ssd_ms['decode']:.4f}; the "
          f"torch row (scan) at {max(lens)} tokens {ssd_ms[f'scan_{max(lens)}_events']:.1f} "
          f"by events, one call; per prefill of {max(lens)} tokens, {len(mamba)} calls × "
          f"{ssd_ms[f'aten_{max(lens)}']:.4f} = "
          f"{len(mamba) * ssd_ms[f'aten_{max(lens)}']:.2f} ms")
    halo.finalize()

    # the 2048-token request, every step, against the plain versions
    plain = default_manifest()
    plain.platform_list = [{"platform_preference": ["torch"]}]
    i = lens.index(max(lens))
    _cuda.reset_launch_counts()
    ref = replay(model, params, prompts[i], results[i], max_len, plain)
    if any(_cuda.launch_counts().values()):
        fail("the plain replay of the zamba2 leg launched kernels")
    errs = [normwise(k_, r_) for k_, r_ in zip(records[i]["logits"], ref)]
    same = sum(int(r_.argmax()) == t for r_, t in zip(ref, results[i]))
    stats.update(plain_errs=errs, plain_argmax_agree=same)
    print(f"  {len(prompts[i])}-token request vs the plain replay on the card: "
          + ", ".join(f"{e:.3e}" for e in errs) + f" by step (tol {SERVE_HYBRID_TOL:g}); "
          f"{same} of {len(errs)} served tokens equal the plain argmax")

    # the first pattern alone, kernels vs plain, the same request at every
    # step: bfloat16 decode steps held to SERVE_TOL
    first_pattern = len(cfg.stages[0].pattern)
    cut, sliced = first_blocks(cfg, params, first_pattern)
    m7 = build_model(cut)
    e7 = [normwise(k_, r_) for k_, r_ in zip(
        replay(m7, sliced, prompts[i], results[i], max_len, None),
        replay(m7, sliced, prompts[i], results[i], max_len, plain))]
    del m7, sliced
    stats.update(plain_worst_err=max(errs), first_pattern_errs=e7)
    print(f"  the same request with the first {first_pattern} blocks kept, kernels vs "
          f"plain: " + ", ".join(f"{e:.3e}" for e in e7) + f" by step (tol {SERVE_TOL:g})")

    # the same request with the weights widened to float32, kernels against
    # plain (its prefill takes MMM's and FLASH_ATTN's 3×TF32 routes)
    wide32 = torch.utils._pytree.tree_map(lambda t: t.float(), params)
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    e32 = [normwise(k_, r_) for k_, r_ in zip(
        replay(m32, wide32, prompts[i], results[i], max_len, None),
        replay(m32, wide32, prompts[i], results[i], max_len, plain))]
    del wide32
    stats["f32_errs"] = e32
    print(f"  float32, same weights, the {len(prompts[i])}-token request + "
          f"{len(e32) - 1} decode steps, kernels vs plain: "
          + ", ".join(f"{e:.2e}" for e in e32) + f" (tol {F32_SERVE_TOL:g})")
    if len(errs) != len(results[i]) or not max(errs) <= SERVE_HYBRID_TOL:
        fail(f"the zamba2 leg's logits differ from the plain replay by {max(errs):.3e}")
    if len(e7) != len(results[i]) or not max(e7) <= SERVE_TOL:
        fail(f"the zamba2 leg's first {first_pattern} blocks differ from the plain "
             f"replay by {max(e7):.3e}")
    if len(e32) != len(results[i]) or not max(e32) <= F32_SERVE_TOL:
        fail(f"the zamba2 leg's float32 logits differ from the plain versions by "
             f"{max(e32):.3e}")
    return launches, stats


class BlockCapture:
    """Each block's input in a served run, for one request: its prefill's
    (1, S, D) and, at each of its decode steps, its lane's (1, 1, D) row;
    and each block's (spec, weights) in the order the blocks run."""

    def __init__(self, prompt, decode_steps: int):
        self.prompt, self.steps_left = prompt, decode_steps
        self.lane = self.row = None
        self.blocks, self.inputs, self.j = [], [], 0

    @contextlib.contextmanager
    def tapping(self):
        """Patch ``transformer._apply_block`` to copy the captured row of
        each block's input while a forward of the request runs."""
        from repro_torch.models import transformer
        orig = transformer._apply_block

        def tapped(spec, bp, x, **kw):
            if self.row is not None:
                if self.j == len(self.blocks):
                    self.blocks.append((spec, bp))
                    self.inputs.append([])
                self.inputs[self.j].append(x[self.row:self.row + 1].clone())
                self.j += 1
            return orig(spec, bp, x, **kw)
        transformer._apply_block = tapped
        try:
            yield self
        finally:
            transformer._apply_block = orig

    def engine(self):
        """A RecordingEngine class that points the tap at the request's
        prefill and at its lane in its first ``decode_steps`` decode
        steps.  The tap is Python inside the forward, which a replay does
        not run: a tapped step runs eagerly (``EagerStep``), and
        ``tapped`` counts them."""
        cap = self

        class CapturingEngine(recording_engine()):
            tapped = 0

            def _admit_logits(self, slot, toks):
                if cap.lane is not None or toks[0].tolist() != cap.prompt:
                    return super()._admit_logits(slot, toks)
                cap.lane, cap.row, cap.j = slot, 0, 0
                try:
                    return super()._admit_logits(slot, toks)
                finally:
                    cap.row = None

            def _decode_logits(self, tok, pos, active):
                if cap.lane is None or not cap.steps_left or cap.lane not in self._active:
                    return super()._decode_logits(tok, pos, active)
                cap.row, cap.j = cap.lane, 0
                cap.steps_left -= 1
                self.tapped += 1
                graph, self._step = self._step, EagerStep(self._step)
                try:
                    return super()._decode_logits(tok, pos, active)
                finally:
                    cap.row = None
                    self._step = graph
        return CapturingEngine


@contextlib.contextmanager
def routing_tap(mode: str, calls: list, key: str = "plain"):
    """Patch ``models.moe._route``.  ``"record"``: route as the program does
    and append {"probs", "eidx"} per call (the router's float32
    probabilities by ``moe._router_probs``).  ``"force"``: take each call's
    recorded expert indices in order, with gates recomputed from this run's
    own probabilities at those indices and renormalised; keep this run's
    probabilities and its own top k under ``key``."""
    from repro_torch.models import moe
    orig = moe._route
    pending = iter(calls)

    def tapped(x2, router_w, m):
        probs = moe._router_probs(x2, router_w)
        if mode == "record":
            gates, eidx, aux = orig(x2, router_w, m)
            calls.append({"probs": probs, "eidx": eidx})
            return gates, eidx, aux
        call = next(pending)
        call[key] = (probs, torch.topk(probs, m.top_k, dim=-1).indices)
        gates = probs.gather(1, call["eidx"])
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return gates, call["eidx"], torch.zeros((), device=x2.device)
    moe._route = tapped
    try:
        yield
    finally:
        moe._route = orig


def run_block(cfg, spec, bp, xs, max_len):
    """One block alone from captured inputs: a prefill of ``xs[0]`` (1, S,
    D) at positions 0..S−1, its cache padded to ``max_len``, then one
    decode step per later entry (1, 1, D) at S, S+1, …; its outputs."""
    import torch.nn.functional as F

    from repro_torch.models.transformer import _apply_block
    s, dev = xs[0].shape[1], xs[0].device
    with torch.no_grad():
        y, _, cache = _apply_block(spec, bp, xs[0], cfg=cfg,
                                   positions=torch.arange(s, device=dev)[None])
        # the sequence axis is the last but one of GQA's (B,H,S,dh) and of
        # MLA's (B,S,lat), (B,S,rope)
        cache = tuple(F.pad(c, (0, 0, 0, max_len - s)) for c in cache)
        outs = [y]
        for i, xt in enumerate(xs[1:]):
            pos = torch.tensor([s + i], device=dev)
            y, _, cache = _apply_block(spec, bp, xt, cfg=cfg, positions=pos[:, None],
                                       cache=cache, cache_pos=pos)
            outs.append(y)
    return outs


def split_k_mmm(a, b):
    """MMM's plain version with K summed in two halves and the halves added:
    another float32 order of the same products, a no-fault control."""
    h = a.shape[1] // 2
    return ((a[:, :h].float() @ b[:h].float())
            + (a[:, h:].float() @ b[h:].float())).to(a.dtype)


def routed_block_check(cfg, cap: BlockCapture, max_len, plain):
    """From each block's captured inputs, the block on the kernels (its
    router's choices recorded), on the plain versions with the kernel
    block's expert indices (``routing_tap``), and on the plain versions
    with MMM summed in another order (``split_k_mmm``, the control).  Per
    block and step: (a) the router probabilities, kernels against plain,
    normwise; (b) every top-k set of the kernels that differs from the
    plain router's own, with the plain margin between its k-th and
    (k+1)-th probability; (c) the block's output less its input, kernels
    (and the control) against plain, normwise."""
    from repro_torch import halo

    control_reg = wrapped_registry(
        lambda rec: split_k_mmm if (rec.alias, rec.platform) == ("MMM", "torch") else None)
    runs, calls = {}, [[] for _ in cap.blocks]
    for name, manifest, registry, mode in (("kernels", None, None, "record"),
                                           ("plain", plain, None, "force"),
                                           ("control", plain, control_reg, "force")):
        halo.initialize(manifest=manifest, registry=registry)
        try:
            runs[name] = []
            for j, (spec, bp) in enumerate(cap.blocks):
                with routing_tap(mode, calls[j], key=name):
                    runs[name].append(run_block(cfg, spec, bp, cap.inputs[j], max_len))
        finally:
            halo.finalize()
    out = {"block_err": [], "control_err": [], "prob_err": [], "control_prob_err": [],
           "flips": 0, "flip_margin_ratio": 0.0, "routes": 0}
    for j, xs in enumerate(cap.inputs):
        for x, yk, yp, yc in zip(xs, runs["kernels"][j], runs["plain"][j], runs["control"][j]):
            dp = yp.double() - x.double()
            out["block_err"].append(float((yk.double() - yp.double()).norm() / dp.norm()))
            out["control_err"].append(float((yc.double() - yp.double()).norm() / dp.norm()))
        for call in calls[j]:
            pk, (pp, own) = call["probs"], call["plain"]
            out["prob_err"].append(normwise(pk, pp))
            out["control_prob_err"].append(normwise(call["control"][0], pp))
            delta = float((pk - pp).abs().max())
            srt = pp.sort(dim=-1, descending=True).values
            k = own.shape[1]
            margin = srt[:, k - 1] - srt[:, k]
            flipped = (call["eidx"].sort(-1).values != own.sort(-1).values).any(-1)
            out["routes"] += own.shape[0]
            if bool(flipped.any()):
                n = int(flipped.sum())
                out["flips"] += n
                ratio = float(margin[flipped].max()) / max(delta, 1e-30)
                out["flip_margin_ratio"] = max(out["flip_margin_ratio"], ratio)
    return out


def moe_leg_structure(cfg):
    """Launches and dispatches per pass by the model's structure: MMM a
    prefill (every projection on the wgmma route) and a decode pass (every
    one on the skinny route, the unembed included); RMSNORM a pass; the
    FLASH_ATTN route and launches a prefill; MOE_FFN a pass."""
    from repro_torch.kernels.flash_attention.flash_attention import fa_route
    blocks = [b for st in cfg.stages for b in st.pattern for _ in range(st.repeats)]
    mla = [b.attn.kv_lora > 0 for b in blocks]
    # MLA: wdq, wuq, wdkv, wkrope, wo, and in prefill wuk, wuv; GQA: q k v o
    attn_pre = sum(7 if x else 4 for x in mla)
    attn_dec = sum(5 if x else 4 for x in mla)
    ffn = sum(3 for b in blocks if (b.moe is not None and b.moe.n_shared) or
              (b.moe is None and b.d_ff))
    a = blocks[0].attn
    d_qk = a.head_dim + a.rope_head_dim if a.kv_lora else a.head_dim
    return {"prefill_mmm": attn_pre + ffn, "decode_mmm": attn_dec + ffn + 1,
            "rmsnorm": 2 * len(blocks) + 2 * sum(mla) + 1,
            "fa_route": fa_route(cfg.activation_dtype(), d_qk), "fa": len(blocks),
            "moe": sum(b.moe is not None for b in blocks), "d_qk": d_qk}


def phase3b_moe_leg(dev, leg: dict, cfg, note: str):
    """One MoE leg (SERVE_MOE, SERVE_MLA) through ``serve_leg``, the
    2048-token request's block inputs captured on the way.  Checks: launch
    counts by ``moe_leg_structure``; MOE_FFN dispatches one a MoE layer a
    pass, all on aten; no FLASH_ATTN on aten; ``serve_leg``'s checks;
    ``routed_block_check`` on the 2048-token request's prefill and decode
    steps: (a) ≤ ROUTER_PROB_TOL, (b) every flip at a plain margin ≤
    FLIP_MARGIN × the call's largest probability difference, (c) ≤
    MOE_BLOCK_TOL; for MLA, each decode step's attention against a
    prefill through the same position (≤ MLA_DECODE_TOL).  Prints what
    ``serve_leg`` prints, MOE_FFN's device ms a call at the leg's
    capacities and its share, one decode step's device time beside the
    expert weights' bytes over 3.35 TB/s, and the whole-model gap to a
    plain replay with routing forced and free.  Returns (launches, stats,
    model, params, the 2048-token request's prompt and tokens)."""
    from repro_torch import halo
    from repro_torch.core.manifest import default_manifest
    from repro_torch.kernels.moe_ffn.ops import grouped_ffn
    from repro_torch.models import moe

    st = moe_leg_structure(cfg)
    mcfg = next(b.moe for s_ in cfg.stages for b in s_.pattern if b.moe is not None)

    def expect(prefills, decodes):
        return ({"mmm_wgmma": st["prefill_mmm"] * prefills,
                 "mmm_skinny": st["decode_mmm"] * decodes + prefills,
                 "rmsnorm": st["rmsnorm"] * (prefills + decodes),
                 f"flash_attention_{st['fa_route']}": st["fa"] * prefills},
                {"MOE_FFN/aten": st["moe"] * (prefills + decodes), "MOE_FFN/torch": 0,
                 "FLASH_ATTN/aten": 0})

    served = serve_leg(dev, leg, cfg, note, expect, capture=True)
    model, params, gen, prompts = served.model, served.params, served.gen, served.prompts
    results, max_len, cap, stats = served.results, served.max_len, served.cap, served.stats
    busy_s, launches = served.busy_s, served.launches
    stats["layers"] = cfg.n_layers
    lens = leg["prompt_lens"]
    i_long = lens.index(max(lens))
    decodes = stats["decode_steps"]
    if len(cap.inputs) != len(cap.blocks) or any(len(x) != leg["max_new"]
                                                 for x in cap.inputs):
        fail(f"captured {[len(x) for x in cap.inputs]} inputs of {len(cap.blocks)} blocks")

    # MOE_FFN at the leg's capacities (one MoE layer's experts), device ms a
    # call; its device time in the served run by the dispatches at each
    layer = next(p_["moe"] for p_ in (sp[0] for sp in params["stages"]) if "moe" in p_)
    w3 = [layer[k][0] for k in ("we_g", "we_u", "we_d")]
    caps = {f"prefill_{L}": (moe._capacity(L, mcfg), st["moe"] * prompts_n)
            for L, prompts_n in ((L, sum(len(p_) == L for p_ in prompts)) for L in lens)}
    caps["decode"] = (moe._capacity(leg["slots"], mcfg), st["moe"] * decodes)
    ffn_ms = {}
    for key, (c, _) in caps.items():
        xe = torch.randn((mcfg.n_experts, c, cfg.d_model), generator=gen, device=dev).to(
            cfg.activation_dtype())
        ffn_ms[key] = median_device_ms(lambda: grouped_ffn(xe, *w3), dev)
    moe_ms = sum(ffn_ms[k] * calls for k, (_, calls) in caps.items())
    expert_bytes = st["moe"] * sum(w.numel() * w.element_size() for w in w3)
    stats.update(moe_ffn_ms_per_call=ffn_ms, moe_ffn_ms_in_run=moe_ms,
                 moe_ffn_share=moe_ms / (busy_s * 1e3) if busy_s > 0 else None,
                 expert_bytes_per_pass=expert_bytes,
                 expert_bytes_bound_ms=expert_bytes / PEAKS["H100 SXM"][0] * 1e3)
    print(f"  MOE_FFN (aten row) device ms a call, capacity: " + ", ".join(
        f"{k} (C={caps[k][0]}) {v:.4f}" for k, v in ffn_ms.items())
        + f"; in the served run ~{moe_ms:.1f} ms"
        + (f", {stats['moe_ffn_share']:.3f} of its device time" if busy_s > 0 else "")
        + f"; a decode pass reads every expert's weights: {expert_bytes / 1e9:.2f} GB, "
        f"{stats['expert_bytes_bound_ms']:.2f} ms at 3.35 TB/s; MOE_FFN a decode pass "
        f"{ffn_ms['decode'] * st['moe']:.2f} ms")

    stats["decode_step_ms_alone"] = stats["alone"]["captured_host_ms"]
    stats["decode_step_device_ms"] = stats["alone"]["captured_device_ms"]
    print(f"  the expert weights' bytes bound a decode step at "
          f"{stats['expert_bytes_bound_ms']:.2f} ms; one alone takes "
          f"{stats['decode_step_device_ms']:.3f} ms of device time")
    halo.finalize()

    # the 2048-token request, block by block, kernels against plain with the
    # kernel block's routing forced on the plain one
    plain = default_manifest()
    plain.platform_list = [{"platform_preference": ["torch"]}]
    chk = routed_block_check(cfg, cap, max_len, plain)
    stats["routing"] = {k: (max(v) if isinstance(v, list) else v) for k, v in chk.items()}
    print(f"  {len(prompts[i_long])}-token request, {len(cap.blocks)} blocks × "
          f"{leg['max_new']} steps from the served run's inputs, kernels vs plain with "
          f"routing forced: (a) router probabilities worst {max(chk['prob_err']):.3e} "
          f"(tol {ROUTER_PROB_TOL:g}; control {max(chk['control_prob_err']):.3e}); "
          f"(b) {chk['flips']} of {chk['routes']} top-k sets "
          f"differ from the plain router's own, widest plain margin "
          f"{chk['flip_margin_ratio']:.3f} × the call's largest probability difference "
          f"(tol {FLIP_MARGIN:g}); (c) block output less input worst "
          f"{max(chk['block_err']):.3e}, median {statistics.median(chk['block_err']):.3e} "
          f"(tol {MOE_BLOCK_TOL:g}); control (plain, MMM summed in another order) worst "
          f"{max(chk['control_err']):.3e}, median {statistics.median(chk['control_err']):.3e}")
    if not max(chk["prob_err"]) <= ROUTER_PROB_TOL:
        fail(f"the {cfg.name} leg's router probabilities differ from plain by "
             f"{max(chk['prob_err']):.3e}")
    if not chk["flip_margin_ratio"] <= FLIP_MARGIN:
        fail(f"the {cfg.name} leg flipped an expert at a plain margin of "
             f"{chk['flip_margin_ratio']:.3f} × its largest probability difference")
    if not max(chk["block_err"]) <= MOE_BLOCK_TOL:
        fail(f"a block of the {cfg.name} leg differs from its plain version by "
             f"{max(chk['block_err']):.3e} with routing forced")
    if cfg.stages[0].pattern[0].attn.kv_lora:
        stats["mla_decode_vs_prefill"] = mla_decode_check(cfg, cap, max_len)
        stats["mla_chunk_vs_prefill"] = mla_chunk_check(cfg, cap)

    # the whole model, as information: the request replayed on the kernels
    # (routing recorded) and on the plain versions, routing forced and free
    req, toks = prompts[i_long], results[i_long]
    calls = []
    with routing_tap("record", calls):
        kern = replay(model, params, req, toks, max_len, None)
    with routing_tap("force", calls):
        forced = replay(model, params, req, toks, max_len, plain)
    free = replay(model, params, req, toks, max_len, plain)
    for name, ref in (("forced", forced), ("free", free)):
        errs = [normwise(k_, r_) for k_, r_ in zip(kern, ref)]
        same = sum(int(r_.argmax()) == t for r_, t in zip(ref, toks))
        stats[f"whole_model_{name}"] = {"errs": errs, "argmax_agree": same}
        print(f"  whole model, kernels vs plain, routing {name}: " + ", ".join(
            f"{e:.3e}" for e in errs) + f" by step; {same} of {len(errs)} served tokens "
            f"equal the plain argmax")
    del calls, kern, forced, free, cap
    return launches, stats, model, params, req, toks


def mla_decode_check(cfg, cap: BlockCapture, max_len):
    """Each MLA block's attention at the request's first and last decode
    step (the absorbed form over the latent cache) against a prefill over
    the prompt and the decode inputs through that step (decompressed keys
    through FLASH_ATTN), its last row, on the kernels: ≤ MLA_DECODE_TOL."""
    import torch.nn.functional as F

    from repro_torch import halo
    from repro_torch.models.attention import mla_forward
    from repro_torch.models.layers import rms_norm

    halo.initialize()
    errs = []
    try:
        with torch.no_grad():
            for (spec, bp), xs in zip(cap.blocks, cap.inputs):
                a, p = spec.attn, bp["attn"]
                hs = [rms_norm(x, bp["ln1"], cfg.norm_eps) for x in xs]
                s, dev = hs[0].shape[1], hs[0].device
                _, cache = mla_forward(p, hs[0], a, positions=torch.arange(s, device=dev)[None],
                                       norm_eps=cfg.norm_eps)
                cache = tuple(F.pad(c, (0, 0, 0, max_len - s)) for c in cache)
                for i, h in enumerate(hs[1:]):
                    pos = torch.tensor([s + i], device=dev)
                    y, cache = mla_forward(p, h, a, positions=pos[:, None], cache=cache,
                                           cache_pos=pos, norm_eps=cfg.norm_eps)
                    if i in (0, len(hs) - 2):
                        seq = torch.cat(hs[:i + 2], dim=1)
                        full, _ = mla_forward(p, seq, a, norm_eps=cfg.norm_eps,
                                              positions=torch.arange(seq.shape[1],
                                                                     device=dev)[None])
                        errs.append(normwise(y[:, -1], full[:, -1]))
    finally:
        halo.finalize()
    print(f"  MLA decode (absorbed, latent cache) vs prefill through the same position, "
          f"{len(cap.blocks)} blocks at the first and last decode step: "
          + ", ".join(f"{e:.3e}" for e in errs) + f" (tol {MLA_DECODE_TOL:g})")
    if not max(errs) <= MLA_DECODE_TOL:
        fail(f"MLA's decode differs from its prefill by {max(errs):.3e}")
    return errs


def mla_chunk_check(cfg, cap: BlockCapture):
    """Each MLA block's multi-token cache step: the 2048-token prompt's
    block input prefilled into the latent cache, then a MLA_CHUNK-token
    chunk at positions S..S+MLA_CHUNK-1 (the prompt's last MLA_CHUNK input
    rows again: a chunk as long as the engines' clamp allows a MoE model
    none, but the step is the paged engine's) written first and masked per
    query, against a prefill over prompt + chunk (decompressed keys through
    FLASH_ATTN), its last MLA_CHUNK rows, on the kernels: ≤
    MLA_DECODE_TOL."""
    import torch.nn.functional as F

    from repro_torch import halo
    from repro_torch.models.attention import mla_forward
    from repro_torch.models.layers import rms_norm

    halo.initialize()
    errs = []
    try:
        with torch.no_grad():
            for (spec, bp), xs in zip(cap.blocks, cap.inputs):
                a, p = spec.attn, bp["attn"]
                h = rms_norm(xs[0], bp["ln1"], cfg.norm_eps)
                hc = h[:, -MLA_CHUNK:]
                s, dev = h.shape[1], h.device
                _, cache = mla_forward(p, h, a, positions=torch.arange(s, device=dev)[None],
                                       norm_eps=cfg.norm_eps)
                cache = tuple(F.pad(c, (0, 0, 0, MLA_CHUNK)) for c in cache)
                pos = torch.tensor([s], device=dev)
                y, _ = mla_forward(p, hc, a, positions=(s + torch.arange(
                    MLA_CHUNK, device=dev))[None], cache=cache, cache_pos=pos,
                    norm_eps=cfg.norm_eps)
                seq = torch.cat([h, hc], dim=1)
                full, _ = mla_forward(p, seq, a, norm_eps=cfg.norm_eps,
                                      positions=torch.arange(s + MLA_CHUNK, device=dev)[None])
                errs.append(normwise(y, full[:, s:]))
    finally:
        halo.finalize()
    print(f"  MLA chunk step ({MLA_CHUNK} tokens after the prompt, latent cache written "
          f"first, masked per query) vs prefill over prompt + chunk, {len(cap.blocks)} "
          f"blocks: " + ", ".join(f"{e:.3e}" for e in errs) + f" (tol {MLA_DECODE_TOL:g})")
    if not max(errs) <= MLA_DECODE_TOL:
        fail(f"MLA's chunk step differs from its prefill by {max(errs):.3e}")
    return errs


def phase3b_moe(dev):
    """moonshot-v1-16b-a3b at its published widths and full depth
    (SERVE_MOE) through ``phase3b_moe_leg``; then its first F32_MOE_LAYERS
    layers in float32, built after the bfloat16 weights are freed, the
    2048-token request on the kernels against the plain versions with the
    kernels' routing forced (F32_SERVE_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(SERVE_MOE["arch"])
    b0, b1 = cfg.stages[0].pattern[0], cfg.stages[1].pattern[0]
    note = (f"{cfg.n_layers} layers (layer 0 dense, d_ff {b0.d_ff}; {cfg.n_layers - 1} of "
            f"{b1.moe.n_experts} experts of d_ff {b1.moe.d_ff_expert}, top {b1.moe.top_k}, "
            f"{b1.moe.n_shared} shared), d_model {cfg.d_model}, {b0.attn.n_heads} heads of "
            f"{b0.attn.head_dim}, vocab {cfg.vocab_size}")
    launches, stats, model, params, req, toks = phase3b_moe_leg(dev, SERVE_MOE, cfg, note)
    max_len = len(req) + SERVE_MOE["max_new"] + 8
    del model, params
    torch.cuda.empty_cache()

    # float32, the first F32_MOE_LAYERS layers, kernels against plain
    from repro_torch.core.manifest import default_manifest
    cut = dataclasses.replace(cfg, dtype="float32", stages=(
        cfg.stages[0], dataclasses.replace(cfg.stages[1], repeats=F32_MOE_LAYERS - 1)))
    m32 = build_model(cut)
    p32 = m32.init(torch.Generator(device=dev).manual_seed(SERVE_MOE["seed"]))
    plain = default_manifest()
    plain.platform_list = [{"platform_preference": ["torch"]}]
    calls = []
    with routing_tap("record", calls):
        kern = replay(m32, p32, req, toks, max_len, None)
    with routing_tap("force", calls):
        ref = replay(m32, p32, req, toks, max_len, plain)
    e32 = [normwise(k_, r_) for k_, r_ in zip(kern, ref)]
    stats["f32_errs"] = e32
    print(f"  float32, the first {F32_MOE_LAYERS} layers, the {len(req)}-token request + "
          f"{len(e32) - 1} decode steps, kernels vs plain, routing forced: "
          + ", ".join(f"{e:.2e}" for e in e32) + f" (tol {F32_SERVE_TOL:g})")
    del m32, p32, calls, kern, ref
    torch.cuda.empty_cache()
    if len(e32) != len(toks) or not max(e32) <= F32_SERVE_TOL:
        fail(f"the moonshot leg's float32 logits differ from the plain versions by "
             f"{max(e32):.3e}")
    return launches, stats


def phase3b_mla(dev):
    """deepseek-v2-236b at its published widths, its depth cut to layer 0
    and SERVE_MLA["moe_repeats"] MoE layers, through ``phase3b_moe_leg``:
    FLASH_ATTN on the wgmma route at head dim 192 padded to 256."""
    from repro_torch.configs import get_config

    full = get_config(SERVE_MLA["arch"])
    cfg = dataclasses.replace(full, stages=(
        full.stages[0], dataclasses.replace(full.stages[1], repeats=SERVE_MLA["moe_repeats"])))
    b0, b1 = cfg.stages[0].pattern[0], cfg.stages[1].pattern[0]
    a = b0.attn
    note = (f"{cfg.n_layers} of {full.n_layers} layers (layer 0 dense, d_ff {b0.d_ff}; "
            f"{cfg.n_layers - 1} of {b1.moe.n_experts} experts of d_ff "
            f"{b1.moe.d_ff_expert}, top {b1.moe.top_k}, {b1.moe.n_shared} shared), "
            f"d_model {cfg.d_model}, MLA {a.n_heads} heads, q_lora {a.q_lora}, kv_lora "
            f"{a.kv_lora}, nope {a.head_dim} + rope {a.rope_head_dim}, v {a.v_head_dim}, "
            f"vocab {cfg.vocab_size}")
    launches, stats, model, params, _, _ = phase3b_moe_leg(dev, SERVE_MLA, cfg, note)
    del model, params
    torch.cuda.empty_cache()
    return launches, stats


def replay_inputs(model, params, batch, steps, pos0, max_len, manifest, registry=None):
    """Logits (float32, (B, V)) of a prefill over ``batch`` and of one
    decode step per entry of ``steps`` ((B, 1) tokens or (B, 1, D) frame
    embeddings) at positions ``pos0``, ``pos0 + 1``, …, on a session with
    ``manifest`` (None: the kernels) and ``registry``; each step's host ms
    (synchronised) and the session's quarantined records beside."""
    from repro_torch import halo
    from repro_torch.serve.kvcache import pad_caches

    dev = params["embed"].device
    halo.initialize(manifest=manifest, registry=registry)
    out, ms = [], []
    try:
        with torch.no_grad():
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            logits, caches = model.prefill(params, batch)
            caches = pad_caches(model.cfg, caches, max_len)
            out.append(logits.float())
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            for i, x in enumerate(steps):
                t0 = time.perf_counter()
                logits, caches = model.decode_step(params, caches, x, pos0 + i)
                out.append(logits.float())
                torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms, halo.session().scheduler.failed_record_keys()
    finally:
        halo.finalize()


def frontend_leg(dev, leg: dict, serve):
    """One stub-frontend leg at its published widths: weights from
    ``leg["seed"]``; ``serve(model, params, gen, registry, dispatches)``
    runs it on the kernels and returns a namespace: batch, steps (the
    decode inputs), pos0 (the first decode position), max_len, served (the
    logits of every step), prefill_ms, decode_ms (a step each), toks (the
    served tokens, or None), launches, quarantined and stats;
    launch counts by the model's structure (a prefill: 7·L (6·L without a
    gate) MMMs on the wgmma route, its unembed skinny, L FLASH_ATTN on the
    route of the head dim; a decode pass: those MMMs + 1 skinny; RMSNORM
    2·L + 1 a pass), no FLASH_ATTN on aten, an empty quarantine, finite
    logits of the vocab's width, and every step's logits within SERVE_TOL
    of a plain replay (teacher-forced), over the real vocabulary's
    columns.  Prints the parameter count, prefill and decode-step ms and
    peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.core.manifest import default_manifest
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention.flash_attention import fa_route
    from repro_torch.models import build_model

    cfg = get_config(leg["arch"])
    block = cfg.stages[0].pattern[0]
    a, layers = block.attn, cfg.n_layers
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(leg["seed"])
    params = model.init(gen)
    leaves = torch.utils._pytree.tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    print(f"  {cfg.name} ({cfg.frontend}): {layers} layers, d_model {cfg.d_model}, "
          f"{a.n_heads} heads of {a.head_dim} on {a.n_kv_heads} KV heads, d_ff "
          f"{block.d_ff} {block.act}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B "
          f"parameters in {cfg.dtype} ({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} "
          f"GB), random from seed {leg['seed']}")
    registry, dispatches = counting_registry()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    run = serve(model, params, gen, registry, dispatches)
    steps, served, launches, quarantined = run.steps, run.served, run.launches, run.quarantined
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    per_layer = 7 if block.act in ("swiglu", "geglu") else 6
    route = fa_route(cfg.activation_dtype(), a.head_dim)
    decodes = len(steps)
    expected = {k: 0 for k in launches}
    expected.update(mmm_wgmma=per_layer * layers,
                    mmm_skinny=1 + (per_layer * layers + 1) * decodes,
                    rmsnorm=(2 * layers + 1) * (1 + decodes))
    expected[f"flash_attention_{route}"] = layers
    fa_aten = dispatches.get("FLASH_ATTN/aten", 0)
    print(f"  1 prefill + {decodes} decode passes: launches {launches} (expected {expected}); "
          f"FLASH_ATTN on aten {fa_aten}; quarantine {quarantined}")
    if launches != expected:
        fail(f"the {cfg.name} leg's launch counts {launches} != its structure {expected}")
    if fa_aten or quarantined:
        fail(f"the {cfg.name} leg ran FLASH_ATTN on aten {fa_aten} times or quarantined "
             f"{quarantined}")
    if not all(bool(torch.isfinite(x).all()) and x.shape == (leg["rows"], cfg.padded_vocab)
               for x in served):
        fail(f"the {cfg.name} leg's logits are not finite or not of the vocab's width")
    plain = default_manifest()
    plain.platform_list = [{"platform_preference": ["torch"]}]
    _cuda.reset_launch_counts()
    ref, _, _ = replay_inputs(model, params, run.batch, steps, run.pos0, run.max_len, plain)
    if any(_cuda.launch_counts().values()):
        fail(f"the plain replay of the {cfg.name} leg launched kernels")
    # the real vocabulary only: paligemma's padded tail (257280 − 257216
    # columns) holds −1e30 on both sides and would swamp the norm
    v = cfg.vocab_size
    errs = [normwise(k_[:, :v], r_[:, :v]) for k_, r_ in zip(served, ref)]
    stats = dict(run.stats, arch=cfg.name, n_params=n_params, launches=launches,
                 prefill_ms=run.prefill_ms,
                 decode_step_ms_median=statistics.median(run.decode_ms), peak_gb=peak_gb,
                 plain_errs=errs)
    if run.toks is not None:
        stats["plain_argmax_agree"] = sum(
            int(r_.argmax(-1)[j]) == t_[j] for r_, t_ in zip(ref, run.toks.T.tolist())
            for j in range(leg["rows"]))
    print(f"  prefill {run.prefill_ms:.1f} ms, decode step median {stats['decode_step_ms_median']:.2f} "
          f"ms over {decodes}; peak memory {peak_gb:.2f} GB; vs the plain replay on the card "
          f"(teacher-forced) by step: " + ", ".join(f"{e:.2e}" for e in errs)
          + f" (tol {SERVE_TOL:g})")
    if len(errs) != decodes + 1 or not max(errs) <= SERVE_TOL:
        fail(f"the {cfg.name} leg's logits differ from the plain replay by {max(errs):.3e}")
    del model, params
    torch.cuda.empty_cache()
    return launches, stats


def phase3b_frontends(dev):
    """The stub frontends at their published widths and full depth:
    paligemma-3b through ``ServeEngine.generate`` (the lockstep path, its
    patches in ``batch_extra``, decode from s0 + prefix_len) and
    musicgen-large at the model level (its frame embeddings through
    ``Model.prefill`` and ``Model.decode_step``: the lockstep path refuses
    ``frame_embed``), each through ``frontend_leg``."""
    from repro_torch import halo
    from repro_torch.kernels import _cuda
    from repro_torch.serve.engine import ServeEngine

    def paligemma(model, params, gen, registry, dispatches):
        cfg, leg = model.cfg, SERVE_PALIGEMMA
        b, s0, n = leg["rows"], leg["prompt_len"], leg["max_new"]
        prompts = torch.randint(0, cfg.vocab_size, (b, s0), generator=gen, device=dev)
        patches = (torch.randn((b, cfg.prefix_len, cfg.d_model), generator=gen, device=dev)
                   * cfg.d_model ** -0.5).to(cfg.activation_dtype())
        max_len = cfg.prefix_len + s0 + n + 8
        engine = ServeEngine(model, max_len=max_len)
        session = halo.initialize(registry=registry)       # device=None: the card
        if session.device.type != "cuda":
            fail(f"session runs on {session.device}, not the card")
        engine.generate(params, prompts[:, :8], 2,
                        batch_extra={"patches": patches})  # warm-up: the eager step
        # record every step's logits and host ms from the lockstep loop: the
        # prefill, and each decode step through the width's step graph
        served, times = [], []
        prefill, decode = model.prefill, engine._lockstep_logits

        def timed(fn, logits_of):
            def call(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                served.append(logits_of(out).float())
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
                return out
            return call

        model.prefill = timed(prefill, lambda out: out[0])
        engine._lockstep_logits = timed(decode, lambda out: out)
        torch.cuda.synchronize(dev)
        _cuda.reset_launch_counts()
        dispatches.clear()
        t0 = time.perf_counter()
        try:
            toks = engine.generate(params, prompts, n, batch_extra={"patches": patches})
            torch.cuda.synchronize(dev)
        finally:
            del model.prefill, engine._lockstep_logits
        wall = time.perf_counter() - t0
        launches = _cuda.launch_counts()
        quarantined = session.scheduler.failed_record_keys()
        graph_stats = engine.step_stats()
        del engine
        # one lockstep decode step alone, on a fresh engine's width b
        lone = ServeEngine(model, max_len=max_len + lone_steps(3))
        state = {"tok": lone.generate(params, prompts, 1, batch_extra={"patches": patches}),
                 "pos": s0 + cfg.prefix_len}
        width = lone._lockstep[b]

        def step():
            logits = lone._lockstep_logits(width, state["tok"], state["pos"])
            state["tok"], state["pos"] = logits.argmax(-1)[:, None], state["pos"] + 1
        alone = lone_decode(dev, step, width, 3, attr="graph")
        del lone, width
        halo.finalize()
        print(f"  ({b} rows, lockstep) " + lone_line(alone))
        print(f"  {b} rows × {n} tokens through ServeEngine.generate in {wall:.2f} s: "
              f"{b * n / wall:.2f} tokens/s; lockstep decode steps {step_line(graph_stats)} "
              f"(the warm-up call's 1 step eager, this call's first captured)")
        if tuple(toks.shape) != (b, n):
            fail(f"paligemma served {tuple(toks.shape)} tokens, not {(b, n)}")
        want = {"captures": 1, "replays": n - 1, "eager_steps": 1}
        if graph_stats != want:
            fail(f"paligemma's lockstep steps {graph_stats}, not {want}")
        return types.SimpleNamespace(
            batch={"tokens": prompts, "patches": patches},
            steps=[toks[:, i:i + 1] for i in range(n - 1)], pos0=s0 + cfg.prefix_len,
            max_len=max_len, served=served, prefill_ms=times[0], decode_ms=times[1:],
            toks=toks, launches=launches, quarantined=quarantined,
            stats={"tokens_per_s": b * n / wall, "wall_s": wall,
                   "decode_graph": graph_stats, "alone": alone})

    def musicgen(model, params, gen, registry, dispatches):
        cfg, leg = model.cfg, SERVE_MUSICGEN
        b, s0 = leg["rows"], leg["frames"]
        dt = cfg.activation_dtype()
        frames = (torch.randn((b, s0, cfg.d_model), generator=gen, device=dev)
                  * cfg.d_model ** -0.5).to(dt)
        steps = [(torch.randn((b, 1, cfg.d_model), generator=gen, device=dev)
                  * cfg.d_model ** -0.5).to(dt) for _ in range(leg["decode_steps"])]
        max_len = s0 + leg["decode_steps"] + 8
        batch = {"frames": frames}
        replay_inputs(model, params, {"frames": frames[:, :64]}, steps[:1], 64, 80, None,
                      registry)                             # warm-up
        _cuda.reset_launch_counts()
        dispatches.clear()
        served, ms, quarantined = replay_inputs(model, params, batch, steps, s0, max_len,
                                                None, registry)
        return types.SimpleNamespace(
            batch=batch, steps=steps, pos0=s0, max_len=max_len, served=served,
            prefill_ms=ms[0], decode_ms=ms[1:], toks=None,
            launches=_cuda.launch_counts(), quarantined=quarantined, stats={})

    out_launches, out = {}, {}
    out_launches["serve_paligemma"], out["paligemma"] = frontend_leg(dev, SERVE_PALIGEMMA,
                                                                    paligemma)
    out_launches["serve_musicgen"], out["musicgen"] = frontend_leg(dev, SERVE_MUSICGEN,
                                                                  musicgen)
    return out_launches, out


# ---------------------------------------------------------------------------
# phase 3c: execution graphs, fusion and compiled replay
# ---------------------------------------------------------------------------
def ew_program(send, w):
    """EWMM(a, b) → EWADD(·, c) → EWSUB(·, d) → EWMD(·, e)."""
    t = send("EWMM", (w["a"], w["b"]))
    t = send("EWADD", (t, w["c"]))
    t = send("EWSUB", (t, w["d"]))
    return [send("EWMD", (t, w["e"]))]


def decode_program(send, w):
    """benchmarks/graph_fusion.py's decode step: per layer MVM → EWADD →
    RMSNORM on a (D,) activation."""
    x = w["x"]
    for wi, bi in zip(w["W"], w["bias"]):
        x = send("MVM", (wi, x))
        x = send("EWADD", (x, bi))
        x = send("RMSNORM", (x, w["gamma"]))
    return [x]


def ew_js_program(send, w):
    """The EW chain and, independent of it, ``js_sweeps`` Jacobi sweeps."""
    out = ew_program(send, w)
    x = w["x0"]
    for _ in range(GRAPH["js_sweeps"]):
        x = send("JS", (w["A"], x, w["bJ"]))
    return out + [x]


def phase3c(dev, card):
    from repro_torch import halo
    from repro_torch.kernels import _cuda

    session = halo.initialize()              # device=None means the card
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, dtype=torch.float32, shift=0.0, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    def ew_inputs(dtype):
        n = GRAPH["ew_n"]
        w = {k: rnd(n, n, dtype=dtype) for k in "abcd"}
        w["e"] = (rnd(n, n).abs() + 1.0).to(dtype)     # away from 0
        return w

    d, layers = GRAPH["decode_d"], GRAPH["decode_layers"]
    bf16 = torch.bfloat16
    decode_w = {"W": [rnd(d, d, dtype=bf16, scale=d ** -0.5) for _ in range(layers)],
                "bias": [rnd(d, dtype=bf16, scale=0.1) for _ in range(layers)],
                "gamma": rnd(d, dtype=bf16, shift=1.0, scale=0.1),
                "x": rnd(d, dtype=bf16)}
    js_w = ew_inputs(torch.float32)
    js_w["A"], js_w["x0"], js_w["bJ"] = js_system(GRAPH["js_n"], torch.float32,
                                                  gen, dev)
    # (name, program, inputs, the input rebound on every other replay,
    #  expected stats, expected launches per replay)
    n_dec, sweeps = 3 * layers, GRAPH["js_sweeps"]
    workloads = [
        (f"EW chain {dt_name}", ew_program, ew_inputs(dt), "a",
         dict(captured_nodes=4, nodes=1, fused_nodes=1, intermediates_eliminated=3),
         {"fused": 1})
        for dt, dt_name in ((torch.float32, "float32"), (bf16, "bfloat16"))]
    workloads += [
        (f"decode chain bfloat16 {layers} layers", decode_program, decode_w, "x",
         dict(captured_nodes=n_dec, nodes=1, fused_nodes=1,
              intermediates_eliminated=n_dec - 1),
         {"mvm": layers, "ewise": layers, "rmsnorm": layers}),
        (f"EW chain + {sweeps} JS sweeps float32", ew_js_program, js_w, "x0",
         dict(captured_nodes=4 + sweeps, nodes=2, fused_nodes=2,
              intermediates_eliminated=3 + sweeps - 1),
         {"fused": 1, "jacobi": sweeps})]

    def sync():
        torch.cuda.synchronize(dev)

    def claims(program, w):
        crs = {}
        program(lambda al, p: crs.setdefault(al, halo.claim(al, overrides=PIN)), w)
        return crs

    def serial(program, w, crs):
        def send(al, p):
            halo.send(p, crs[al])
            return halo.recv(crs[al])
        return program(send, w)

    def capture(program, w, crs, launch):
        with halo.graph(launch=launch) as g:
            program(lambda al, p: halo.isend(p, crs[al]), w)
        return g

    _cuda.reset_launch_counts()
    compiled = []
    for name, program, w, swap, want_stats, per_replay in workloads:
        crs = claims(program, w)
        alt = dict(w, **{swap: w[swap] * 1.5 + 0.25})
        refs = [serial(program, w, crs), serial(program, alt, crs)]
        sync()
        cg = capture(program, w, crs, launch=False).compile()
        st = cg.stats
        got = {k: st[k] for k in want_stats}
        print(f"  {name}: compile stats {got}; fused {st['fused_aliases']}")
        if got != want_stats or st["unplanned_placements"]:
            fail(f"{name}: compile stats {st} != {want_stats}")
        if capture(program, w, crs, launch=False).compile() is not cg \
                or st["cache_hits"] != 1:
            fail(f"{name}: a second compile of the same capture missed the cache")
        slot = cg.slot_of(w[swap])
        before = _cuda.launch_counts()
        for i in range(GRAPH["replays"]):
            outs = cg.replay(updates={slot: alt[swap]} if i % 2 else None)
            sync()
            for out, ref in zip(outs, refs[i % 2]):
                if not (out.shape == ref.shape and out.dtype == ref.dtype
                        and torch.equal(bits(out), bits(ref))):
                    fail(f"{name}: replay {i} differs from serial dispatch")
        after = _cuda.launch_counts()
        delta = {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}
        want = {k: v * GRAPH["replays"] for k, v in per_replay.items()}
        quarantined = session.scheduler.failed_record_keys()
        print(f"  {name}: {GRAPH['replays']} replays bit-identical to serial "
              f"dispatch; launches {delta}; quarantine {quarantined}; "
              f"placements scored in the last replay "
              f"{st['placements_scored_last']}")
        if delta != want:
            fail(f"{name}: launches {delta} != {want}: a node went to another "
                 f"record or decomposed")
        if quarantined or st["placements_scored_last"] != 0:
            fail(f"{name}: quarantine {quarantined}, "
                 f"{st['placements_scored_last']} placements re-scored")
        if program is ew_js_program:
            x = outs[-1]
            a, b = w["A"].double(), w["bJ"].double()
            resid = float((a @ x.double() - b).norm() / b.norm())
            check_close(f"{name}: JS ‖Ax−b‖/‖b‖", resid, torch.float32, JS_RESIDUAL)
        compiled.append((name, program, w, crs, cg))
    launches = _cuda.launch_counts()

    # times: serial blocking send/recv, a fresh capture + launch, compiled
    # replay; median of E2E_REPEATS per workload, one step each
    print(f"  times on {card} (median of {E2E_REPEATS}, ms per step):")
    stats = {}
    for name, program, w, crs, cg in compiled:

        def timed(fn, host=None):
            walls = []
            for _ in range(E2E_REPEATS):
                t0 = time.perf_counter()
                fn()
                if host is not None:
                    host.append(time.perf_counter() - t0)
                sync()
                walls.append(time.perf_counter() - t0)
            return sorted(walls)[len(walls) // 2] * 1e3

        def launched():
            g = capture(program, w, crs, launch=True)
            g.wait(timeout=600)

        host = []
        row = {"serial_ms": timed(lambda: serial(program, w, crs)),
               "graph_ms": timed(launched),
               "replay_ms": timed(lambda: cg.replay(timeout=600), host)}
        row["t1_replay_us"] = sorted(host)[len(host) // 2] * 1e6
        busy = device_ms_per_call(lambda: cg.replay(timeout=600), E2E_REPEATS, dev)
        row["device_ms_per_replay"] = busy if busy > 0 else None
        row["device_busy_share"] = busy / row["replay_ms"] if busy > 0 else None
        stats[name] = row
        print(f"    {name}: serial {row['serial_ms']:.3f}, graph "
              f"{row['graph_ms']:.3f}, replay {row['replay_ms']:.3f}; T1 per "
              f"replay {row['t1_replay_us']:.1f} us; device "
              + (f"{busy:.3f} ms per replay, busy share "
                 f"{row['device_busy_share']:.3f}" if busy > 0
                 else "time not measured (the profiler saw none)"))
    halo.finalize()
    return launches, stats


# ---------------------------------------------------------------------------
# phase 3e: collectives
# ---------------------------------------------------------------------------
def combine_nodes(g):
    """The allreduce combine nodes of a captured collective Jacobi: EWADD
    nodes fed by VDP partials or by other combines (a sweep's EWADD is fed
    by EWSUB and EWMM)."""
    return [n for n in g.nodes if n.alias == "EWADD"
            and all(p.alias in ("VDP", "EWADD") for p in n.parents)]


def check_path_kernels(a, b, d, n, group_sizes) -> None:
    """MVM, VDP and EW* on the card against their plain versions at the
    shapes the collective path gives them, on this problem's data: the
    whole system (serial), each group's first row shard, and the 0-d
    partials the allreduce combines.  MVM normwise within ``TOL``, VDP
    relative within ``VDP_TOL``, EW* bit-exact.  These launches fall
    outside every counted run."""
    from repro_torch.kernels.ewise.ewise import ewise_hopper
    from repro_torch.kernels.ewise.ref import OP_REFS as EW_REFS
    from repro_torch.kernels.mvm.mvm import mvm_hopper
    from repro_torch.kernels.mvm.ref import mvm_ref
    from repro_torch.kernels.vdp.ref import vdp_ref
    from repro_torch.kernels.vdp.vdp import vdp_hopper

    x = b / d                                # the first sweep's iterate
    e = x - b.roll(1) / d                    # a nonzero sweep difference
    f32 = torch.float32
    for rows in sorted({n // size for size in group_sizes} | {n}, reverse=True):
        sl = slice(0, rows)
        check_close(f"MVM {rows}x{n} (collective path)",
                    normwise(mvm_hopper(a[sl], x), mvm_ref(a[sl], x)), f32)
        check_close(f"VDP n={rows} (collective path)",
                    relative(vdp_hopper(e[sl], e[sl]), vdp_ref(e[sl], e[sl])),
                    f32, VDP_TOL)
        for op, ref in EW_REFS.items():
            u, v = (b[sl], d[sl]) if op == "div" else (b[sl], x[sl])
            check_bits(f"EW {op} n={rows} (collective path)", ewise_hopper(u, v, op),
                       ref(u, v))
    s, t = vdp_ref(e, e), vdp_ref(x, x)      # 0-d float32, as VDP gives them
    for op, ref in EW_REFS.items():
        check_bits(f"EW {op} 0-d (allreduce combine)", ewise_hopper(s, t, op), ref(s, t))


def phase3e(dev, card):
    """The paper's collective Jacobi on the card (``COLLECTIVE``): serial on
    one agent, eager blocking verbs and one captured graph, over each
    group; bit-identity, tolerance, placement and convergence checks, the
    launches of mvm, vdp and ewise, T3 and Φ against serial hopper."""
    from repro_torch import collective_jacobi as cj
    from repro_torch import halo
    from repro_torch.core.portability import portability_score
    from repro_torch.kernels import _cuda

    session = halo.initialize()              # device=None means the card
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    n, sweeps = COLLECTIVE["n"], COLLECTIVE["sweeps"]
    a, b, d = cj.problem(n, dev, COLLECTIVE["seed"])

    def sync():
        torch.cuda.synchronize(dev)

    def counted(fn):
        sync()
        _cuda.reset_launch_counts()
        out = fn()
        sync()
        got = {k: v for k, v in _cuda.launch_counts().items() if v}
        return out, got

    def per_sweep(ranks, combines=0):
        return {"ewise": 5 * ranks * sweeps + combines, "mvm": ranks * sweeps,
                "vdp": ranks * sweeps}

    check_path_kernels(a, b, d, n, [len(g) for g in COLLECTIVE["groups"].values()])
    launches = collections.Counter()
    (x_ser, res_ser), got = counted(lambda: cj.serial_jacobi(a, b, d, sweeps, "hopper"))
    launches.update(got)
    print(f"  n = {n} float32 (A {a.numel() * 4 / 1e9:.3f} GB), {sweeps} sweeps; "
          f"serial hopper launches {got}")
    if got != per_sweep(1):
        fail(f"serial hopper launches {got} != {per_sweep(1)}")
    errs = [1.0]                             # x = 0: ‖b‖ / ‖b‖
    for k in COLLECTIVE["err_sweeps"]:
        xk, _ = cj.serial_jacobi(a, b, d, k, "hopper")
        errs.append(cj.solve_error(a, b, xk))
    errs.append(cj.solve_error(a, b, x_ser))
    marks = (0,) + COLLECTIVE["err_sweeps"] + (sweeps,)
    print("  relative solve error ‖Ax − b‖/‖b‖ (float64) after "
          + ", ".join(f"{k}: {e:.3e}" for k, e in zip(marks, errs)))
    # it falls ~sqrt(n)-fold a sweep down to float32's floor (~4e-7 here),
    # where the last sweeps only move its noise
    if not all(e1 < e0 for e0, e1 in zip(errs[:-1], errs[1:-1])):
        fail(f"the solve error does not fall across the sweeps: {errs}")
    if not errs[-1] <= COLLECTIVE_SOLVE_TOL:
        fail(f"the solve error after {sweeps} sweeps is {errs[-1]:.3e}, past "
             f"{COLLECTIVE_SOLVE_TOL:g}")
    print(f"  the solve error falls, and ends within {COLLECTIVE_SOLVE_TOL:g}")
    x_aten, _ = cj.serial_jacobi(a, b, d, sweeps, "aten")
    x_plain, _ = cj.serial_jacobi(a, b, d, sweeps, "torch")
    check_close("serial hopper against serial plain", normwise(x_ser, x_plain),
                torch.float32, COLLECTIVE_B_TOL)
    check_close("serial aten against serial plain", normwise(x_aten, x_plain),
                torch.float32, COLLECTIVE_B_TOL)

    stats = {"n": n, "sweeps": sweeps, "solve_error": dict(zip(marks, errs)),
             "groups": {}}
    runs = {}
    for key, group in COLLECTIVE["groups"].items():
        comm = halo.comm_split(list(group))
        ranks_on_hopper = sum(p == "hopper" for p in group)
        (x_e, res_e), got_e = counted(lambda: cj.collective_jacobi(comm, a, b, d, sweeps))
        (g, x_g, res_g), got_g = counted(
            lambda: cj.collective_jacobi_graph(comm, a, b, d, sweeps))
        launches.update(got_e)
        launches.update(got_g)
        n_combines = (len(group) - 1) * sweeps
        combines = collections.Counter(nd.platform for nd in combine_nodes(g))
        unplaced = [nd.uid for nd in g.nodes if nd.platform is None]
        err_e = cj.solve_error(a, b, x_e)
        # the eager combines run in private graphs: those on hopper show only
        # as ewise launches past the sweeps' own, between none and all
        hopper_e = got_e.get("ewise", 0) - per_sweep(ranks_on_hopper)["ewise"]
        print(f"  group ({key}) {list(group)}: launches eager {got_e}, graph {got_g}; "
              f"graph {len(g.nodes)} nodes, combines on {dict(combines)} (eager: "
              f"{hopper_e} on hopper by launches); residual eager {res_e:.6e}, "
              f"graph {res_g:.6e}, serial {res_ser:.6e}; solve error {err_e:.3e}")
        if not 0 <= hopper_e <= n_combines \
                or got_e != per_sweep(ranks_on_hopper, hopper_e) \
                or got_g != per_sweep(ranks_on_hopper, combines["hopper"]):
            fail(f"group ({key}): launches eager {got_e}, graph {got_g} != "
                 f"{per_sweep(ranks_on_hopper)} and one ewise a combine on hopper")
        if unplaced:
            fail(f"group ({key}): graph nodes {unplaced[:8]} were never placed")
        retried = [(nd.uid, nd.attempts) for nd in g.nodes if len(nd.attempts) != 1]
        if retried:
            fail(f"group ({key}): nodes re-placed, replayed or speculated: {retried[:8]}")
        if not set(combines) <= set(group) \
                or sum(combines.values()) != n_combines:
            fail(f"group ({key}): combines {dict(combines)}, expected "
                 f"{n_combines} on the members {sorted(set(group))}")
        if len(set(group)) == 1 and hopper_e != n_combines:
            fail(f"group ({key}): {n_combines - hopper_e} eager combines left hopper")
        if not (torch.equal(x_g, x_e) and res_g == res_e):
            fail(f"group ({key}): graph differs from eager (residual {res_g} vs {res_e})")
        if len(set(group)) == 1:
            if not torch.equal(x_e, x_ser):
                fail(f"group ({key}): collective iterate differs from serial hopper")
            if abs(res_e - res_ser) > 1e-5 * abs(res_ser):
                fail(f"group ({key}): residual {res_e} vs serial {res_ser} "
                     f"past rtol 1e-5")
            print(f"  group ({key}): iterate bit-identical to serial hopper, graph "
                  f"bit-identical to eager; residual within rtol 1e-5 of serial")
        else:
            check_close(f"group ({key}) iterate against serial hopper",
                        normwise(x_e, x_ser), torch.float32, COLLECTIVE_B_TOL)
            check_close(f"group ({key}) iterate against serial plain",
                        normwise(x_e, x_plain), torch.float32, COLLECTIVE_B_TOL)
            print(f"  group ({key}): {normwise(x_e, x_aten):.3e} from serial aten; "
                  f"graph bit-identical to eager")
        stats["groups"][key] = {"platforms": list(group), "launches": got_e,
                                "graph_nodes": len(g.nodes),
                                "combine_platforms": dict(combines),
                                "eager_combines_on_hopper": hopper_e,
                                "residual": res_e, "solve_error": err_e}
        runs[key] = comm
        del g, x_g, x_e
    quarantined = session.scheduler.failed_record_keys()
    if quarantined:
        fail(f"quarantine {quarantined}")
    print(f"  launches in the phase (checked runs): {dict(launches)}")

    def t3(fn):
        walls = []
        for _ in range(E2E_REPEATS):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(time.perf_counter() - t0)
        return sorted(walls)[len(walls) // 2] * 1e3

    fns = {"serial hopper": lambda: cj.serial_jacobi(a, b, d, sweeps, "hopper"),
           "serial aten": lambda: cj.serial_jacobi(a, b, d, sweeps, "aten")}
    for key, comm in runs.items():
        fns[f"eager ({key})"] = functools.partial(cj.collective_jacobi, comm, a, b, d, sweeps)
        fns[f"graph ({key})"] = functools.partial(cj.collective_jacobi_graph, comm,
                                                  a, b, d, sweeps)
    rows = {name: t3(fn) for name, fn in fns.items()}
    busy = {name: device_ms_per_call(fn, 3, dev) for name, fn in fns.items()}
    base = rows["serial hopper"]
    print(f"  T3 on {card} (median of {E2E_REPEATS}, ms per {sweeps}-sweep solve, "
          f"Φ = serial hopper / T3; device ms of a solve by torch.profiler, busy "
          f"= device / T3):")
    for name, ms in rows.items():
        print(f"    {name}: T3 {ms:.3f} ms, Φ {portability_score(base, ms):.4f}, "
              f"device {busy[name]:.3f} ms, busy {busy[name] / ms:.3f}")
    stats["t3_ms"] = rows
    stats["device_ms"] = busy
    stats["phase_launches"] = dict(launches)
    del a, b, d, x_ser, x_aten, x_plain, runs, fns
    halo.finalize()
    torch.cuda.empty_cache()
    return dict(launches), stats


# ---------------------------------------------------------------------------
# phase 3g: resilience
# ---------------------------------------------------------------------------
def captured_jacobi(comm, a, b, d, sweeps: int):
    """The collective Jacobi with each sweep captured as one execution graph,
    so a member's death re-binds the next sweep's capture (the reference's
    captured chaos drill); returns the iterate and the last residual."""
    from repro_torch import halo

    A, B, D = comm.scatter(a), comm.scatter(b), comm.scatter(d)
    X = comm.scatter(torch.zeros_like(b))
    res = None
    for _ in range(sweeps):
        with halo.graph(session=comm.session):
            xs = comm.iallgather(X)
            P = comm.imap("MVM", list(zip(A, xs)))
            T = comm.imap("EWSUB", list(zip(B, P)))
            U = comm.imap("EWMM", list(zip(D, X)))
            V = comm.imap("EWADD", list(zip(T, U)))
            Xn = comm.imap("EWMD", list(zip(V, D)))
            E = comm.imap("EWSUB", list(zip(Xn, X)))
            S = comm.imap("VDP", list(zip(E, E)))
            R = comm.iallreduce(S, op="sum")
        X = [nd.result(timeout=600) for nd in Xn]
        res = float(R[0].result(timeout=600))
    return comm.gather(X), res


@contextlib.contextmanager
def recovery_log(session):
    """Record the session's self-healing while the block runs: the count
    each ``handle_dead_agent`` call returns (the monitor's DEAD response),
    the graph nodes the replay hook re-placed, and each monitor transition
    with its monotonic time."""
    from repro_torch.core.graph import ExecutionGraph

    log_ = {"replayed": [], "nodes": [], "transitions": []}
    handle, replay = session.handle_dead_agent, ExecutionGraph._replay_dead

    def handle_(agent, reason="heartbeat timeout"):
        log_["replayed"].append(handle(agent, reason))
        return log_["replayed"][-1]

    def replay_(self, item, agent):
        log_["nodes"].append(item[0][0])
        return replay(self, item, agent)

    if session.health is not None:
        session.health.on_transition(lambda t, old, new: log_["transitions"].append(
            (time.monotonic(), t.name, new)))
    session.handle_dead_agent = handle_
    ExecutionGraph._replay_dead = replay_
    try:
        yield log_
    finally:
        del session.handle_dead_agent
        ExecutionGraph._replay_dead = replay


def dead_after_ms(log_, target) -> float:
    """ms from ``target``'s last beat (the wedged call's claim, or the
    iteration that wedged) to the monitor's DEAD transition."""
    t_dead = next(t for t, name, new in log_["transitions"]
                  if name == target.name and new == "dead")
    return (t_dead - target.heartbeat()[2]) * 1e3


def phase3g(dev, card):
    """Resilience (DESIGN.md §11) on the card, driven through the paths
    that launch the kernels: (a) the collective Jacobi of 3e over
    ``["hopper", "aten"]``, eager and one captured graph a sweep, whose aten
    member wedges mid-solve under a started monitor (DEAD, ranks re-bound
    onto hopper, its calls replayed); (b) a straggling aten MMM raced by a
    speculative backup on the wgmma kernel; (c) a straggling fused EW chain
    (B13) decomposed speculatively; (d) paged danube at full width under a
    raising, a hanging and a wedged decode step.  Returns (launches, stats)."""
    from repro_torch import collective_jacobi as cj
    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.core.agents import (AgentDeadError, AgentState, HealthConfig,
                                         HealthMonitor)
    from repro_torch.kernels import _cuda
    from repro_torch.models import build_model
    from repro_torch.serve.engine import PagedEngine, StepScheduler
    from repro_torch.testing.faults import FaultError, FaultPlan, chaos, engine_chaos

    rs = RESILIENCE
    launches = collections.Counter()
    stats = {}

    def sync():
        torch.cuda.synchronize(dev)

    def counted(fn):
        sync()
        _cuda.reset_launch_counts()
        out = fn()
        sync()
        got = {k: v for k, v in _cuda.launch_counts().items() if v}
        launches.update(got)
        return out, got

    def wait_for(cond, what, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                fail(f"3g: {what} not reached within {timeout:g} s")
            time.sleep(0.002)

    def card_session(**health):
        session = halo.initialize()          # device=None means the card
        if session.device.type != "cuda":
            fail(f"session runs on {session.device}, not the card")
        session.enable_health_monitor(config=HealthConfig(poll_interval=rs["poll"],
                                                          **health))
        return session

    # (a) a member's death mid-solve
    n, sweeps, group = COLLECTIVE["n"], COLLECTIVE["sweeps"], COLLECTIVE["groups"]["b"]
    session = card_session(heartbeat_timeout=rs["timeout"], straggler_multiple=0.0)
    a, b, d = cj.problem(n, dev, COLLECTIVE["seed"])
    x_ser, _ = cj.serial_jacobi(a, b, d, sweeps, "hopper")
    stats["a"] = {}
    for mode, solve in (("eager", cj.collective_jacobi), ("captured", captured_jacobi)):
        comm = halo.comm_split(list(group))
        t0 = time.perf_counter()
        x0, _ = solve(comm, a, b, d, sweeps)
        sync()
        wall0 = time.perf_counter() - t0
        comm.free()
        comm = halo.comm_split(list(group))
        epoch0 = comm.epoch
        with recovery_log(session) as rec, \
                chaos(session, FaultPlan(platform="aten", mode="die",
                                         nth=rs["death_nth"])) as fa:
            t0 = time.perf_counter()
            (x, res), got = counted(lambda: solve(comm, a, b, d, sweeps))
            wall = time.perf_counter() - t0
            detect = dead_after_ms(rec, fa)
            state = session.health.state(fa)
        err, sol = normwise(x, x_ser), cj.solve_error(a, b, x)
        differ = int((x != x0).sum())
        attempts = collections.Counter(tuple(nd.attempts) for nd in rec["nodes"])
        print(f"  (a) {mode} over {list(group)}: aten wedged on its device call "
              f"{rs['death_nth']} ({fa.calls} calls, {fa.failures} failures), monitor "
              f"state {state} {detect:.1f} ms after its last beat; handle_dead_agent "
              f"replayed {rec['replayed']}; replayed nodes' attempts {dict(attempts)}; "
              f"members now {list(comm.platforms)} (size {comm.size}, epoch {epoch0} -> "
              f"{comm.epoch}); launches {got}; {differ} of {x.numel()} elements differ "
              f"from the fault-free group run; solve {wall * 1e3:.1f} ms against "
              f"{wall0 * 1e3:.1f} fault-free")
        check_close(f"(a) {mode} iterate against serial hopper", err, torch.float32,
                    COLLECTIVE_B_TOL)
        check_close(f"(a) {mode} solve error", sol, torch.float32, COLLECTIVE_SOLVE_TOL)
        if fa.failures < 1 or state != AgentState.DEAD or rec["replayed"] != [
                len(rec["nodes"])] or "aten" in comm.platforms or comm.size != len(group) \
                or comm.epoch == epoch0:
            fail(f"(a) {mode}: the member's death was not repaired: failures "
                 f"{fa.failures}, state {state}, replayed {rec['replayed']} for "
                 f"{len(rec['nodes'])} nodes, members {comm.platforms}, epoch "
                 f"{comm.epoch}")
        if not all(got.get(k, 0) > sweeps for k in ("mvm", "vdp")) \
                or got.get("ewise", 0) <= 5 * sweeps:
            fail(f"(a) {mode}: hopper did not take the dead member's sweeps: {got}")
        stats["a"][mode] = {"detect_ms": detect, "replayed": rec["replayed"],
                            "solve_ms": wall * 1e3, "fault_free_ms": wall0 * 1e3,
                            "launches": got, "differ_from_fault_free": differ,
                            "iterate_err": err, "solve_error": sol}
        del rec, x, x0
    del a, b, d, x_ser
    torch.cuda.empty_cache()

    # (b) straggler speculation onto the wgmma MMM
    session = card_session(heartbeat_timeout=rs["hang_s"],
                           straggler_multiple=rs["straggler_multiple"],
                           straggler_min_s=rs["straggler_min_s"])
    m, k, nn = rs["mmm"]
    gen = torch.Generator(device=dev).manual_seed(7)
    x_a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    x_b = (torch.randn((k, nn), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    want = halo.dispatch("MMM", x_a, x_b, overrides={"allowed_platforms": ["hopper"],
                                                     "platform_preference": ["hopper"]})
    sync()
    both = ["aten", "hopper"]
    with chaos(session, FaultPlan(platform="aten", mode="hang", delay_s=rs["hang_s"])) as fa:
        cr = halo.claim("MMM", overrides={"allowed_platforms": both,
                                          "platform_preference": both})

        def straggle():
            t0 = time.perf_counter()
            with halo.graph():
                node = halo.isend((x_a, x_b), cr)
            out = node.result(timeout=60)
            return node, out, (time.perf_counter() - t0) * 1e3

        (node, out, won_ms), got = counted(straggle)
        ready = node._ready
        fa.release()                        # the late aten attempt lands now
        wait_for(lambda: not fa.heartbeat()[1], "the late aten attempt")
        sync()
    same = torch.equal(bits(out), bits(want))
    print(f"  (b) MMM {m}x{k} @ {k}x{nn} bfloat16 over {both}, aten hung: attempts "
          f"{node.attempts}, ran on {node.platform}, result in {won_ms:.1f} ms; "
          f"launches {got}; torch.equal to a direct hopper dispatch {same}; after the "
          f"late aten result the ready event is the backup's: {node._ready is ready}")
    if node.attempts != ["aten", "hopper+spec"] or node.platform != "hopper" \
            or not same or node._ready is not ready or ready is None \
            or node.result(timeout=0) is not out or got != {"mmm_wgmma": 1}:
        fail("(b) the straggler's backup did not win on the wgmma kernel, or the late "
             "result overwrote it")
    stats["b"] = {"attempts": node.attempts, "backup_ms": won_ms, "launches": got}
    del node, out, want, x_a, x_b, ready

    # (c) a fused straggler decomposes, its member chain off hopper
    nw = GRAPH["ew_n"]
    w = {key: torch.randn((nw, nw), generator=gen, device=dev) for key in "abcd"}
    w["e"] = torch.randn((nw, nw), generator=gen, device=dev).abs() + 1.0
    spec = ["hopper", "torch"]
    claims = {ov: {al: halo.claim(al, overrides={"allowed_platforms": list(ov),
                                                 "platform_preference": list(ov)})
                   for al in ("EWMM", "EWADD", "EWSUB", "EWMD")}
              for ov in (("hopper",), ("torch",), tuple(spec))}

    def serial(ov):
        def send(al, p_):
            halo.send(p_, claims[ov][al])
            return halo.recv(claims[ov][al])
        return ew_program(send, w)[0]

    ref_hop, ref_torch = serial(("hopper",)), serial(("torch",))
    with halo.graph(launch=False) as g:
        ew_program(lambda al, p_: halo.isend(p_, claims[tuple(spec)][al]), w)
    cg = g.compile()
    (alias,) = cg.stats["fused_aliases"]
    with chaos(session, FaultPlan(platform="hopper", mode="hang", delay_s=rs["hang_s"],
                                  aliases=[alias])) as fa:
        def hang_fused():
            t0 = time.perf_counter()
            gr = cg.replay_async()
            out = gr.wait(timeout=60)[-1]    # the chain wins while the fused call hangs
            won_ms = (time.perf_counter() - t0) * 1e3
            hung, ready = fa.heartbeat()[1], gr.nodes[0]._ready
            fa.release()                     # the late fused launch lands now
            wait_for(lambda: not fa.heartbeat()[1], "the late fused attempt")
            gr.wait_device()
            return gr, out, won_ms, hung, ready

        (gr, out, won_ms, hung, ready), got = counted(hang_fused)
    node = gr.nodes[0]
    shadows = [nd for nd in gr.nodes if nd._shadow]
    same, same_hop = torch.equal(bits(out), bits(ref_torch)), torch.equal(bits(out),
                                                                         bits(ref_hop))
    print(f"  (c) fused {alias} over {spec}, its hopper call hung: attempts "
          f"{node.attempts}, ran on {node.platform}; shadow members "
          f"{[(nd.alias, nd.platform) for nd in shadows]}, result in {won_ms:.1f} ms "
          f"with the fused call still hung: {hung}; launches {got} (the late fused "
          f"call's); torch.equal to serial dispatch on the torch rows {same}, on hopper "
          f"{same_hop}; after the late fused call the ready event is the chain's: "
          f"{node._ready is ready}")
    if "decomposed+spec" not in node.attempts or node.platform != "torch" or not hung \
            or [nd.platform for nd in shadows] != ["torch"] * 4 or not same \
            or node._ready is not ready or ready is not shadows[-1]._ready \
            or got != {"fused": 1}:
        fail("(c) the fused straggler's member chain did not win off hopper, or "
             "differs from serial dispatch")
    stats["c"] = {"attempts": node.attempts, "chain_ms": won_ms, "launches": got,
                  "equal_to_serial_hopper": same_hop}
    del w, ref_hop, ref_torch, out, gr, node, shadows, cg, g, ready
    halo.finalize()
    torch.cuda.empty_cache()

    # (d) paged danube at full width
    cfg = get_config(SERVE["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SERVE["seed"]))
    session = halo.initialize()
    gen = torch.Generator(device=dev).manual_seed(SERVE["seed"] + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (length,), generator=gen, device=dev).tolist()
               for length in rs["paged_lens"]]
    max_new = rs["paged_max_new"]
    max_len = max(rs["paged_lens"]) + max_new + cfg.prefix_len + 8

    def paged():
        engine = PagedEngine(model, params, rs["paged_slots"], max_len,
                             block_size=SERVE_PAGED["block_size"], chunk_tokens=0)
        return engine, StepScheduler(engine, temperature=0.0, seed=SERVE["seed"])

    def drained(engine, case):
        pool = engine.pool
        pool.check()
        if pool.live_blocks() or pool.reserved or pool.available() != pool.capacity:
            fail(f"(d) {case}: the arena did not drain: {pool.live_blocks()} live, "
                 f"{pool.reserved} reserved, {pool.available()} of {pool.capacity}")

    def submit_all(sched):
        return [sched.submit(p_, max_new=max_new) for p_ in prompts]

    engine, sched = paged()

    def fault_free():
        futs = submit_all(sched)
        sched.drain()
        return [f.result(timeout=60) for f in futs]

    expect, got_free = counted(fault_free)
    drained(engine, "fault-free")
    stats["d"] = {"launches": {"fault_free": got_free}}

    engine, sched = paged()

    def raising():
        futs = submit_all(sched)
        with engine_chaos(engine, mode="raise", nth=2, times=1) as fault:
            try:
                while sched.busy():          # the 2nd batched decode call raises
                    sched.step()
                fail("(d) raise: the injected decode fault never surfaced")
            except FaultError:
                pass
            lanes = [type(f.exception(timeout=5)).__name__ for f in futs[:2]]
            sched.drain()                    # the queued request still serves
        return fault, lanes, futs[2].result(timeout=60)

    (fault, lanes, third), got = counted(raising)
    drained(engine, "raise")
    print(f"  (d) paged {cfg.name} at full width, {len(prompts)} requests of "
          f"{list(rs['paged_lens'])} tokens on {rs['paged_slots']} slots: raise at the "
          f"2nd decode call ({fault.failures} failure): in-flight lanes {lanes}; the "
          f"queued request equals the fault-free run's tokens: {third == expect[2]}; "
          f"launches {got}; arena drained")
    if lanes != ["FaultError"] * 2 or third != expect[2] or sched.completed != 1:
        fail("(d) raise: the in-flight lanes or the queued request went wrong")
    stats["d"]["launches"]["raise"] = got

    engine, sched = paged()

    def hanging():
        with engine_chaos(engine, mode="hang", nth=2, times=1, delay_s=0.2) as fault:
            futs = submit_all(sched)
            sched.drain()
        return fault, [f.result(timeout=60) for f in futs]

    (fault, toks), got = counted(hanging)
    drained(engine, "hang")
    print(f"  (d) hang 0.2 s at the 2nd decode call ({fault.failures} failure): every "
          f"request equals the fault-free run's tokens: {toks == expect}; launches {got}; "
          f"arena drained")
    if toks != expect or fault.failures != 1:
        fail("(d) hang: the straggling decode changed the tokens")
    stats["d"]["launches"]["hang"] = got

    engine, sched = paged()
    mon = HealthMonitor(HealthConfig(heartbeat_timeout=rs["timeout"], poll_interval=rs["poll"]))
    sched.attach_health(mon)
    trans = []
    mon.on_transition(lambda t, old, new: trans.append((time.monotonic(), t.name, new)))

    def dying():
        with engine_chaos(engine, mode="die", nth=1) as fault, mon:
            sched.start()
            futs = submit_all(sched)
            wait_for(lambda: fault.calls >= 1, "the wedged decode call")
            errors = [type(f.exception(timeout=30)).__name__ for f in futs]
            t_failed = time.monotonic()
            last_beat = sched.heartbeat()[2]     # the wedged iteration's
            wedged = not fault._release.is_set()
            drained(engine, "die")           # while the decode call is still wedged
        sched.stop(drain=False)
        return errors, t_failed, last_beat, wedged

    (errors, t_failed, last_beat, wedged), got = counted(dying)
    t_dead = next(t for t, name, new in trans if name == sched.name and new == "dead")
    detect = (t_dead - last_beat) * 1e3
    print(f"  (d) die at the 1st decode call: the monitor declared {sched.name} "
          f"{mon.state(sched)} {detect:.1f} ms after its last beat; futures {errors} "
          f"{(t_failed - t_dead) * 1e3:.1f} ms later; the arena drained while the call "
          f"was still wedged: {wedged}; launches {got}")
    if errors != [AgentDeadError.__name__] * len(prompts) or not wedged \
            or sched.pending() or sched.active():
        fail("(d) die: the wedged scheduler's requests did not fail with AgentDeadError")
    stats["d"]["launches"]["die"] = got
    stats["d"]["detect_ms"] = detect
    del model, params, engine, sched
    halo.finalize()
    torch.cuda.empty_cache()
    print(f"  launches in the phase: {dict(launches)}")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 3h: multi-process C²MPI
# ---------------------------------------------------------------------------
def same_tree(a, b) -> bool:
    """Equal structure, and every tensor leaf equal bit for bit in dtype and
    shape (NaN included)."""
    import torch.utils._pytree as pytree
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    if sa != sb:
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)) \
                    or x.dtype != y.dtype or x.shape != y.shape:
                return False
            if x.numel() and not torch.equal(
                    x.contiguous().reshape(-1).view(torch.uint8),
                    y.contiguous().reshape(-1).view(torch.uint8)):
                return False
        elif x != y:
            return False
    return True


def hopper_alias_payloads(dev):
    """One small request, on the card, for every alias with a hopper row:
    (args, kwargs) from a seed (the cases of tests/test_torch_remote.py)."""
    from repro_torch.kernels.spmm.ref import dense_to_bell, random_block_sparse
    from repro_torch.train.step_kernels import param_size, resolve_arch

    gen = torch.Generator(device=dev).manual_seed(MULTIPROC["payload_seed"])

    def a(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    n = 16
    diag_dom = a((n, n)) + n * torch.eye(n, device=dev)
    values, indices = dense_to_bell(random_block_sparse(gen, 16, 16, 4, 4), 4, 4)
    q, k, v = a((1, 2, 64, 16)), a((1, 2, 64, 16)), a((1, 2, 64, 16))
    step_kw = dict(arch=TRAIN_COMM["arch"], reduced=True)
    p = param_size(**step_kw)
    vocab = resolve_arch(**step_kw).vocab_size
    toks = torch.randint(0, vocab, (2, 16), generator=gen, device=dev)
    return {
        "MMM": ((a((16, 12)), a((12, 8))), {}),
        "EWMM": ((a((8, 8)), a((8, 8))), {}),
        "EWMD": ((a((8, 8)), a((8, 8)).abs() + 1.0), {}),
        "EWADD": ((a((8, 8)), a((8, 8))), {}),
        "EWSUB": ((a((8, 8)), a((8, 8))), {}),
        "MVM": ((a((8, 8)), a((8,))), {}),
        "VDP": ((a((16,)), a((16,))), {}),
        "JS": ((diag_dom, a((n,)), a((n,))), {}),
        "1DCONV": ((a((32,)), a((5,))), {}),
        "RMSNORM": ((a((4, 16)), torch.ones(16, device=dev)), {}),
        "FLASH_ATTN": ((q, k, v), {}),
        "SMMM": ((values, indices, a((16, 8))), {}),
        "COPY": ((a((8, 8)),), {}),
        "CONCAT": ((a((4, 4)), a((4, 4))), {}),
        "FFT": ((a((4, 32)),), {}),
        "SORT": ((a((33,)),), {}),
        "HIST": ((torch.sigmoid(a((200,))),), {}),
        "EMBED_GRAD": ((a((24, 16), torch.bfloat16),
                        torch.randint(0, 40, (24,), generator=gen, device=dev), 40), {}),
        "LM_GRAD": ((a((p,)) * 0.02, toks, toks.roll(-1, 1),
                     torch.ones((2, 16), device=dev)), step_kw),
        "ADAMW_STEP": ((a((p + 1,)) * 0.01, a((p,)) * 0.02, torch.zeros(p, device=dev),
                        torch.zeros(p, device=dev),
                        torch.tensor(0, dtype=torch.int32, device=dev)),
                       dict(step_kw, n_micro=2)),
    }


def phase3h(dev, card):
    """Multi-process C²MPI (DESIGN.md §13) on the card: (a) worker w0 spawned
    on the card, ``hopper@w0`` attached; (b) every alias with a hopper row
    on ``hopper@w0`` torch.equal to the in-process hopper row, the worker's
    own launch counts equal to the host's for the same request; (c) phase
    3e's Jacobi, eager and captured, over ``["hopper", "hopper@w0"]`` at the
    default wire-cache cap and, after (d), over ``["hopper", "hopper@w1"]``
    with w1 spawned under a raised ``HALO_WIRE_CACHE_MB``, bit-identical to
    serial hopper; (d) w0 killed mid-solve; (e) phase 3f's danube cut to
    ``MULTIPROC["train_layers"]`` layers over ``["hopper", "hopper@w1"]``,
    its history and parameters bit-identical to one member's.  Every worker
    is shut down (or killed) before the phase returns, also on failure.
    Returns stats."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import collective_jacobi as cj
    from repro_torch import halo
    from repro_torch import multiproc_jacobi as mpj
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.remote import spawn_worker
    from repro_torch.kernels import _cuda
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import step_kernels
    from repro_torch.train.trainer import TrainHyper, Trainer, TrainState

    mp = MULTIPROC
    timeout = mp["timeout"]
    stats = {}
    workers = []

    def sync():
        torch.cuda.synchronize(dev)

    def pin(platform):
        return {"allowed_platforms": [platform], "platform_preference": [platform]}

    def diff(after, before):
        return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}

    def spawn(name):
        t0 = time.perf_counter()
        w = spawn_worker(name, device="cuda", timeout=mp["hello_timeout"])
        workers.append(w)
        return w, time.perf_counter() - t0

    session = halo.initialize()              # device=None means the card
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    try:
        # (a) spawn
        w0, hello_s = spawn("w0")
        agent = w0.agent("hopper").attach(session)
        banned = sorted(set(w0.hello["imports"]) & {"jax", "jaxlib", "repro", "ml_dtypes"})
        print(f"  (a) worker w0 (pid {w0.proc.pid}) on {w0.device}: hello after "
              f"{hello_s:.2f} s (its kernel library loaded first); serves "
              f"{list(w0.platforms)}; {len(agent._clones)} hopper records cloned as "
              f"{agent.platform}; packages of JAX in the worker: {banned}")
        if not w0.device.startswith("cuda") or banned or not agent._clones:
            fail(f"(a) worker w0 on {w0.device}, JAX packages {banned}, "
                 f"{len(agent._clones)} clones")
        stats["hello_s"] = hello_s

        # (b) parity sweep
        payloads = hopper_alias_payloads(dev)
        if set(payloads) != {r.alias for r in agent._clones}:
            fail(f"(b) payloads {sorted(payloads)} != hopper aliases "
                 f"{sorted(r.alias for r in agent._clones)}")
        served0 = w0.heartbeat(timeout)["served"]
        sweep, differ, kernels = {}, [], collections.Counter()
        for alias, (args, kwargs) in payloads.items():
            sync()
            _cuda.reset_launch_counts()
            local = session.isend(args, session.claim(alias, overrides=pin("hopper")),
                                  mailbox=False, **kwargs).result(timeout)
            sync()
            here = {k: v for k, v in _cuda.launch_counts().items() if v}
            before = w0.heartbeat(timeout)["launches"]
            remote = session.isend(args, session.claim(alias, overrides=pin(agent.platform)),
                                   mailbox=False, **kwargs).result(timeout)
            there = diff(w0.heartbeat(timeout)["launches"], before)
            same = same_tree(remote, local)
            sweep[alias] = {"equal": same, "launches": there}
            kernels.update(there)
            if not same:
                differ.append(alias)
            if there != here:
                fail(f"(b) {alias}: the worker launched {there}, in process {here}")
        served = diff(w0.heartbeat(timeout)["served"], served0)
        print(f"  (b) {len(payloads)} aliases with a hopper row on {agent.platform} against "
              f"in-process hopper: torch.equal for all but {differ}; the worker's agents "
              f"served {served}; its launches, equal to the host's for each request: "
              f"{dict(kernels)}")
        if differ:
            fail(f"(b) {differ} on {agent.platform} differ from in-process hopper")
        if served != {"hopper": len(payloads)}:
            fail(f"(b) the worker's requests went to {served}, not its hopper agent alone")
        quarantined = session.scheduler.failed_record_keys()
        if quarantined:
            fail(f"(b) quarantine {quarantined}")
        stats["parity"] = {"aliases": len(payloads), "served": served,
                           "launches": dict(kernels)}

        # (c) the collective Jacobi over a local and a remote member: at the
        # default wire-cache cap on w0 here, at the raised cap on w1 after (d)
        n, sweeps = COLLECTIVE["n"], COLLECTIVE["sweeps"]
        a, b, d = cj.problem(n, dev, COLLECTIVE["seed"])
        x_ser, _ = cj.serial_jacobi(a, b, d, sweeps, "hopper")
        block = a.numel() * 4 // 2
        stats["jacobi"] = {}

        def jacobi(w, member, cap):
            group = ["hopper", member.platform]
            cap_mb = w.client.cache.cap_bytes >> 20
            if cap_mb != (mp["raised_mb"] if cap == "raised" else 256):
                fail(f"(c) {w.name}'s wire cap is {cap_mb} MB at the {cap} cap")
            for mode in ("eager", "captured"):
                comm = halo.comm_split(group)
                wire0, hb0 = w.client.wire_stats(), w.heartbeat(timeout)
                sync()
                _cuda.reset_launch_counts()
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                t0 = time.perf_counter()
                if mode == "eager":
                    x, res = cj.collective_jacobi(comm, a, b, d, sweeps)
                else:
                    _, x, res = cj.collective_jacobi_graph(comm, a, b, d, sweeps)
                sync()
                wall = time.perf_counter() - t0
                prof.stop()
                device_ms = device_seconds(prof) * 1e3
                here = {k: v for k, v in _cuda.launch_counts().items() if v}
                there = diff(w.heartbeat(timeout)["launches"], hb0["launches"])
                wire = diff(w.client.wire_stats(), wire0)
                comm.free()
                same = torch.equal(x, x_ser)
                print(f"  (c) {mode} over {group}, wire cap {cap_mb} MB: T3 "
                      f"{wall * 1e3:.1f} ms, device {device_ms:.1f} ms in the host process "
                      f"(busy {device_ms / (wall * 1e3):.3f}; the worker's kernels are "
                      f"not in it); launches host {here}, worker {there}; wire "
                      f"{wire} (totals {w.client.wire_stats()}); iterate bit-identical "
                      f"to serial hopper: {same}; residual {res:.6e}")
                if not same:
                    fail(f"(c) {mode} at cap {cap}: the iterate differs from serial hopper")
                if here.get("mvm") != sweeps or there.get("mvm") != sweeps \
                        or there.get("vdp") != sweeps:
                    fail(f"(c) {mode}: launches host {here}, worker {there}: one MVM "
                         f"and VDP a sweep on each member")
                if cap == "default" and wire.get("bytes_sent", 0) < sweeps * block:
                    fail(f"(c) at the default cap the {block / 1e9:.2f} GB row block "
                         f"did not ship every sweep: {wire}")
                if cap == "raised" and wire.get("bytes_saved", 0) < sweeps * block:
                    fail(f"(c) at the raised cap the row block was not elided: {wire}")
                stats["jacobi"][f"{mode} {cap}"] = {
                    "t3_ms": wall * 1e3, "device_ms_host": device_ms,
                    "busy_host": device_ms / (wall * 1e3), "wire": wire,
                    "launches_host": here, "launches_worker": there}
                del x

        jacobi(w0, agent, "default")

        # (d) the kill drill
        group = ["hopper", agent.platform]
        comm = halo.comm_split(group)
        epoch0 = comm.epoch
        sync()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        (x, res), dead_ms = mpj.kill_mid_solve(
            w0, lambda: cj.collective_jacobi(comm, a, b, d, sweeps), nth=mp["kill_nth"],
            timeout=timeout)
        sync()
        wall = time.perf_counter() - t0
        here = {k: v for k, v in _cuda.launch_counts().items() if v}
        w0.proc.wait(timeout=60)
        err, sol = normwise(x, x_ser), cj.solve_error(a, b, x)
        differ_n = int((x != x_ser).sum())
        print(f"  (d) w0 killed with its MVM {mp['kill_nth']} wedged in flight: DEAD "
              f"{dead_ms:.2f} ms after the kill (exit code {w0.proc.returncode}); members "
              f"now {list(comm.platforms)} (epoch {epoch0} -> {comm.epoch}); clones left "
              f"{len(agent._clones)}; launches {here}; {differ_n} of {x.numel()} elements "
              f"differ from serial hopper; solve {wall * 1e3:.1f} ms")
        check_close("(d) iterate against serial hopper", err, torch.float32,
                    COLLECTIVE_B_TOL)
        check_close("(d) solve error", sol, torch.float32, COLLECTIVE_SOLVE_TOL)
        if not (agent.dead and w0.dead) or agent._clones or agent.platform in comm.platforms \
                or comm.size != 2 or comm.epoch == epoch0:
            fail("(d) the worker's death was not repaired")
        if here.get("mvm", 0) <= sweeps:
            fail(f"(d) hopper did not take the dead member's sweeps: {here}")
        comm.free()
        stats["kill"] = {"dead_ms": dead_ms, "iterate_err": err, "solve_error": sol,
                         "differ": differ_n, "launches": here, "solve_ms": wall * 1e3}
        del x

        # (e) data-parallel training with a remote member
        tc = TRAIN_COMM
        name = f"{tc['arch']}@{mp['train_layers']}"
        cut = step_kernels.resolve_arch(name)
        model = build_model(cut)
        hp = TrainHyper(base_lr=tc["lr"], warmup_steps=0, total_steps=mp["train_steps"],
                        microbatches=tc["microbatches"])
        pipe = SyntheticLM(cut, tc["seq_len"], tc["batch"], tc["seed"])

        def train(platforms):
            comm_ = session.comm_split(list(platforms))
            tr = Trainer(model=model, hp=hp, comm=comm_, arch=name, log_every=1)
            params = model.init(torch.Generator(device=dev).manual_seed(tc["seed"]))
            state0 = TrainState(params, adamw_init(params))
            del params
            t0_ = time.perf_counter()
            state, hist = tr.run(state0, lambda s: pipe.device_batch(s, dev),
                                 mp["train_steps"])
            sync()
            wall_ = time.perf_counter() - t0_
            comm_.free()
            return hist, step_kernels.flatten_params(state.params), wall_

        h_one, p_one, wall_one = train(["hopper"])
        # (c) at the raised cap, on w1 (spawned after (e)'s one-member run,
        # as no remote member may be attached to it): a worker's wire ledger
        # reads the HALO_WIRE_CACHE_MB knob when the worker is spawned
        halo.configure(wire_cache_mb=mp["raised_mb"])
        try:
            w1, hello1 = spawn("w1")
        finally:
            halo.configure(wire_cache_mb=None)
        ag1 = w1.agent("hopper").attach(session)
        jacobi(w1, ag1, "raised")
        del a, b, d, x_ser
        torch.cuda.empty_cache()

        # (e) continued: the group with the remote member
        hb0, wire_e0 = w1.heartbeat(timeout), w1.client.wire_stats()
        h_mix, p_mix, wall_mix = train(["hopper", ag1.platform])
        hb1 = w1.heartbeat(timeout)
        there = diff(hb1["launches"], hb0["launches"])
        served = diff(hb1["served"], hb0["served"])
        wire_e = diff(w1.client.wire_stats(), wire_e0)
        same = h_mix == h_one and torch.equal(p_mix, p_one)
        print(f"  (e) {cut.name} at full width cut to {mp['train_layers']} layers "
              f"({step_kernels.param_size(name)} parameters, a float32 vector "
              f"{step_kernels.param_size(name) * 4 / 1e9:.2f} GB), {mp['train_steps']} "
              f"steps of {tc['batch']} x {tc['seq_len']} tokens in {tc['microbatches']} "
              f"microbatches: w1 hello after {hello1:.2f} s; one member {h_one} in "
              f"{wall_one:.2f} s; ['hopper', '{ag1.platform}'] {h_mix} in {wall_mix:.2f} s; "
              f"history and parameters bit-identical: {same}; the worker served {served}, "
              f"launched {there}; wire {wire_e}")
        if not same:
            fail("(e) the remote-member history or parameters differ from one member's")
        if not all(there.get(k) for k in ("mmm_wgmma", "rmsnorm", "flash_attention_mma",
                                          "embed_grad")):
            fail(f"(e) the worker's LM_GRAD did not run on the kernels: {there}")
        stats["train"] = {"history": h_mix, "one_member_s": wall_one, "mixed_s": wall_mix,
                          "worker_launches": there, "served": served,
                          "wire": wire_e, "hello_s": hello1}
        del model, p_one, p_mix
    finally:
        for w in workers:
            if not w.dead:
                w.shutdown(timeout=60)
            w.kill()
            if w.proc is not None:
                w.proc.wait(timeout=60)
        halo.finalize()
        torch.cuda.empty_cache()
    alive = [w.name for w in workers if w.proc is None or w.proc.poll() is None]
    print(f"  workers {[w.name for w in workers]} exit codes "
          f"{[w.proc.returncode for w in workers]}; alive: {alive}")
    if alive:
        fail(f"workers {alive} are still alive")
    return stats


# ---------------------------------------------------------------------------
# phase 3i: expert parallelism over device groups
# ---------------------------------------------------------------------------
def phase3i(dev, card):
    """Expert parallelism (DESIGN.md §15) on the card: moonshot's MoE layers
    through ``moe_expert_parallel`` over device groups (``EXPERT_PARALLEL``),
    each call against ``moe_layer`` on the same session and inputs:
    (a) bfloat16, 4 layers, prefill and decode, over ``["aten", "aten"]``
    and ``["aten"] * 4``; (b) float32, one layer, over ``["aten", "torch",
    "aten", "torch"]``; (c) one layer over ``["aten", "aten@w0"]`` with w0 a
    worker process on the card, against (a)'s two-member result, the
    worker's aten agent serving that member's 4 COPYs and its MOE_FFN.
    Every call: y and aux ``torch.equal`` to the reference, each MOE_FFN
    node on its member's own platform, MMM launches 3 (the shared
    experts) on the route ``mmm_route`` names and no other kernel.  Host
    ms a call and device ms by torch.profiler beside ``moe_layer``'s, as
    records.  The worker is shut down (or killed) before the phase
    returns, also on failure.  Returns (launches over the counted calls,
    stats)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.distributed.remote import spawn_worker
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.matmul.matmul import mmm_route
    from repro_torch.models import moe

    ep = EXPERT_PARALLEL
    cfg = get_config(ep["arch"])
    m, d = cfg.stages[1].pattern[0].moe, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(ep["seed"])
    totals = collections.Counter()
    stats = {"arch": cfg.name, "layers": list(ep["layers"]), "of_layers": cfg.n_layers,
             "d_model": d, "experts": m.n_experts, "d_ff": m.d_ff_expert, "top_k": m.top_k,
             "shared": m.n_shared, "capacity_factor": m.capacity_factor, "legs": {}}
    workers = []

    def sync():
        torch.cuda.synchronize(dev)

    def weights(dtype):
        specs = moe.moe_param_specs(d, m, dtype)
        return {n: (torch.randn(s.shape, generator=gen, device=dev)
                    * s.shape[-2] ** -0.5).to(s.dtype) for n, s in specs.items()}

    def counted(fn):
        sync()
        _cuda.reset_launch_counts()
        out = fn()
        sync()
        got = {k: v for k, v in _cuda.launch_counts().items() if v}
        totals.update(got)
        return out, got

    def group_call(p, x, platforms):
        comm, nodes = session.comm_split(list(platforms)), []
        imap = comm.imap

        def spy(*a, **k):
            out = imap(*a, **k)
            nodes.extend(out)
            return out
        comm.imap = spy
        try:
            out = moe.moe_expert_parallel(p, x, m, "swiglu", comm)
        finally:
            # the session keeps every comm it split until it finalizes: the
            # spy, and through it the nodes' payloads, must not stay on it
            del comm.imap
            comm.free()
        return out, [n.platform for n in nodes]

    def host_device_ms(fn, runs):
        """Host ms a call (median of ``timed``) and device ms a call from
        ``runs`` profiled calls; where ``runs`` is 0 (a worker member's
        calls take seconds) one synchronised call in a bare profiler window
        gives both."""
        if not runs:
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                sync()
                wall = (time.perf_counter() - t0) * 1e3
            return wall, device_seconds(prof) * 1e3
        walls = []
        for _ in range(ep["timed"]):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls), device_ms_per_call(fn, runs, dev)

    def check(label, p, x, platforms, ref, timed, runs=ep["profiled"]):
        """One group call against ``ref`` (y, aux); returns its record."""
        route = f"mmm_{mmm_route(x.dtype, x.shape[0] * x.shape[1])}"
        ((y, aux), placed), got = counted(lambda: group_call(p, x, platforms))
        if got != {route: 3}:
            fail(f"{label}: launches {got}, not 3 {route} (the shared experts)")
        if placed != list(platforms):
            fail(f"{label}: MOE_FFN ran on {placed}, not on the members {list(platforms)}")
        same = torch.equal(y, ref[0]) and torch.equal(aux, ref[1])
        rec = {"platforms": list(platforms), "bit_identical": same, "moe_ffn_on": placed,
               "launches": got}
        if not same:
            fail(f"{label}: not bit-identical to its reference (max |Δ| "
                 f"{float((y.float() - ref[0].float()).abs().max()):.3e}, "
                 f"aux {float(aux)} vs {float(ref[1])})")
        if timed:
            rec["host_ms"], rec["device_ms"] = host_device_ms(
                lambda: group_call(p, x, platforms), runs)
        print(f"  {label}: {list(platforms)} bit-identical {same}; MOE_FFN on {placed}; "
              f"launches {got}" + (f"; host {rec['host_ms']:.3f} ms, device "
                                   f"{rec['device_ms']:.3f} ms a call" if timed else ""))
        return rec, y

    def reference(label, p, x, timed):
        route = f"mmm_{mmm_route(x.dtype, x.shape[0] * x.shape[1])}"
        (y, aux), got = counted(lambda: moe.moe_layer(p, x, m, "swiglu"))
        if got != {route: 3} or y.shape != x.shape or not bool(torch.isfinite(y).all()):
            fail(f"{label}: moe_layer launched {got} or returned {tuple(y.shape)} "
                 f"with non-finite values")
        rec = {"launches": got}
        if timed:
            rec["host_ms"], rec["device_ms"] = host_device_ms(
                lambda: moe.moe_layer(p, x, m, "swiglu"), ep["profiled"])
            print(f"  {label}: moe_layer host {rec['host_ms']:.3f} ms, device "
                  f"{rec['device_ms']:.3f} ms a call")
        return (y, aux), rec

    session = halo.initialize()              # device=None means the card
    if session.device.type != "cuda":
        fail(f"session runs on {session.device}, not the card")
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        layers = {layer: weights(torch.bfloat16) for layer in ep["layers"]}
        first = ep["layers"][0]
        xs = {"prefill": torch.randn((ep["batch"], ep["prefill"], d), generator=gen,
                                     device=dev).to(torch.bfloat16),
              "decode": torch.randn((ep["batch"], 1, d), generator=gen,
                                    device=dev).to(torch.bfloat16)}
        print(f"  {cfg.name} MoE layers {list(ep['layers'])} of {cfg.n_layers}: d_model "
              f"{d}, {m.n_experts} experts of d_ff {m.d_ff_expert}, top {m.top_k}, "
              f"{m.n_shared} shared, capacity factor {m.capacity_factor}; expert stacks "
              f"{sum(layers[first][n].numel() * 2 for n in ('we_g', 'we_u', 'we_d')) / 1e9:.3f}"
              f" GB a layer; {card}")
        # (a) bfloat16, every layer, two groups
        leg_a, firsts = {}, {}
        for batch, x0 in xs.items():
            x, c = x0, moe._capacity(x0.shape[0] * x0.shape[1], m)
            for layer in ep["layers"]:
                p, timed = layers[layer], layer == first
                label = f"(a) {batch} {tuple(x.shape)} C={c} layer {layer}"
                ref, ref_rec = reference(label, p, x, timed)
                recs = {"moe_layer": ref_rec}
                for group in ep["groups_a"]:
                    recs[f"x{len(group)}"], y = check(label, p, x, group, ref, timed)
                    if layer == first and len(group) == 2:
                        firsts[batch] = (ref, y)
                leg_a[f"{batch}/layer{layer}"] = recs
                x = ref[0]
        stats["legs"]["a"] = leg_a
        # (b) float32, the first layer, the reference's mixed-substrate group
        p32 = weights(torch.float32)
        leg_b = {}
        for batch, x0 in xs.items():
            x = x0.float()
            label = f"(b) {batch} {tuple(x.shape)} float32 layer {first}"
            ref, ref_rec = reference(label, p32, x, True)
            leg_b[batch] = {"moe_layer": ref_rec}
            leg_b[batch]["group"], _ = check(label, p32, x, ep["group_b"], ref, True)
        stats["legs"]["b"] = leg_b
        del p32
        # (c) a worker member on the card
        t0 = time.perf_counter()
        w0 = spawn_worker("w0", device="cuda", timeout=MULTIPROC["hello_timeout"])
        workers.append(w0)
        hello_s = time.perf_counter() - t0
        agent = w0.agent("aten").attach(session)
        group = ["aten", agent.platform]
        timeout = MULTIPROC["timeout"]
        leg_c = {"hello_s": hello_s}
        print(f"  (c) worker w0 (pid {w0.proc.pid}) on {w0.device}: hello after "
              f"{hello_s:.2f} s; {len(agent._clones)} aten records cloned as "
              f"{agent.platform}; wire cap {w0.client.cache.cap_bytes >> 20} MB")
        for batch, x in xs.items():
            ref, two = firsts[batch]
            label = f"(c) {batch} {tuple(x.shape)} layer {first}"
            wire0, served0 = w0.client.wire_stats(), w0.heartbeat(timeout)["served"]
            rec, y = check(label, layers[first], x, group, (two, ref[1]), False)
            served = {k: v - served0.get(k, 0) for k, v in
                      w0.heartbeat(timeout)["served"].items() if v - served0.get(k, 0)}
            wire = {k: v - wire0[k] for k, v in w0.client.wire_stats().items()}
            if served != {"aten": 5}:
                fail(f"{label}: the worker served {served}, not 4 COPYs and one MOE_FFN "
                     f"on its aten agent")
            rec.update(served=served, wire=wire,
                       equal_to_moe_layer=bool(torch.equal(y, ref[0])))
            rec["host_ms"], rec["device_ms"] = host_device_ms(
                lambda: group_call(layers[first], x, group), 0)
            print(f"  {label}: the worker served {served}; wire bytes sent "
                  f"{wire['bytes_sent']}, saved {wire['bytes_saved']}; pinned "
                  f"{w0.client.wire_stats()['pinned_bytes']} bytes; torch.equal to "
                  f"moe_layer {rec['equal_to_moe_layer']}; host {rec['host_ms']:.3f} ms, "
                  f"device (this process) {rec['device_ms']:.3f} ms a call")
            leg_c[batch] = rec
        stats["legs"]["c"] = leg_c
        agent._deregister_clones()
        stats["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"  peak device memory {stats['peak_gb']:.2f} GB")
        del layers, xs, firsts
    finally:
        for w in workers:
            if not w.dead:
                w.shutdown(timeout=60)
            w.kill()
            if w.proc is not None:
                w.proc.wait(timeout=60)
        halo.finalize()
        torch.cuda.empty_cache()
    alive = [w.name for w in workers if w.proc is None or w.proc.poll() is None]
    if alive:
        fail(f"workers {alive} are still alive")
    stats["launches"] = dict(totals)
    return dict(totals), stats


# ---------------------------------------------------------------------------
# phase 3j: expert parallelism under a device mesh
# ---------------------------------------------------------------------------
def mesh_shares(x, m, mesh_shape):
    """The token shares ``moe_layer`` gives the ranks under a mesh of
    ``mesh_shape`` (data, model): a2a splits the tokens over every rank,
    replicated over the data axis only.  Returns (mode, shares)."""
    n_dp, n_ep = mesh_shape
    t = x.shape[0] * x.shape[1]
    a2a = m.n_experts % n_ep == 0 and t % (n_dp * n_ep) == 0 \
        and t // (n_dp * n_ep) >= m.top_k
    return ("a2a", n_dp * n_ep) if a2a else ("replicated", n_dp)


@contextlib.contextmanager
def expert_tap():
    """Patch ``models.moe._expert_ffn`` to keep each call's expert outputs
    (one a share in one process, one a rank's body under a mesh)."""
    from repro_torch.models import moe
    taps, ffn = [], moe._expert_ffn

    def tap(*a, **k):
        taps.append(ffn(*a, **k))
        return taps[-1]
    moe._expert_ffn = tap
    try:
        yield taps
    finally:
        moe._expert_ffn = ffn


def moe_by_shares(p, x, m, shares: int):
    """``moe_layer`` in one process on each token share alone (the
    capacity a mesh call sizes from a rank's share), the shares' y
    concatenated and their aux averaged, as the mesh's pmean does; with
    the expert outputs of each share's call."""
    from repro_torch.models import moe

    b, s, d = x.shape
    with expert_tap() as taps:
        outs = [moe.moe_layer(p, xs[None], m, "swiglu")
                for xs in x.reshape(b * s, d).chunk(shares)]
    y = torch.cat([o[0][0] for o in outs]).reshape(b, s, d)
    return y, torch.stack([o[1] for o in outs]).mean(), taps


@contextlib.contextmanager
def mesh_routing(mode: str, calls: list, mesh, key: str = "mesh"):
    """``routing_tap`` for one rank under ``mesh``, over the calls a
    one-process run recorded: each ``_route`` call sees this rank's token
    share, the row-major block of the one-process call that the body's
    spec gives it (a2a: one block a rank; replicated: one a data-axis
    coordinate).  ``"record"``: route as the program does and keep
    (block, top k) under ``key``; ``"force"``: route the share by the
    recorded call's indices, gates from this run's probabilities."""
    import torch.distributed as dist

    from repro_torch.models import moe
    orig = moe._route
    pending = iter(calls)

    def block(call, n):
        parts = call["eidx"].shape[0] // n
        idx = (0 if parts == 1 else dist.get_rank() if parts == mesh.size()
               else mesh.get_local_rank("data"))
        return slice(idx * n, (idx + 1) * n)

    def tapped(x2, router_w, m):
        call = next(pending)
        rows = block(call, x2.shape[0])
        if mode == "record":
            gates, eidx, aux = orig(x2, router_w, m)
            call[key] = (rows, eidx)
            return gates, eidx, aux
        probs = moe._router_probs(x2, router_w)
        eidx = call["eidx"][rows]
        gates = probs.gather(1, eidx)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return gates, eidx, torch.zeros((), device=x2.device)
    moe._route = tapped
    try:
        yield
    finally:
        moe._route = orig


def digest(*ts) -> str:
    """A hash of tensors' bytes (cross-rank bit identity)."""
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_rank(legs):
    """Phase 3j in one of four ranks on the card (``run_ranks``, gloo):
    ``legs`` ⊆ {"layers", "f32", "serve"}.  Every check is a ``fail()``
    (a SystemExit the parent reports); returns this rank's records,
    digests and launch counts."""
    import torch.distributed as dist

    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.distributed import mesh_ops
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.matmul.matmul import mmm_route
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.serve.engine import ServeEngine

    ms = MESH
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    reg, counts = counting_registry()
    session = halo.initialize(registry=reg)       # device=None means the card
    if session.device.type != "cuda":
        fail(f"rank {rank}: session runs on {session.device}, not the card")
    meshes = {k: make_mesh(v, ("data", "model")) for k, v in ms["meshes"].items()}
    if any(mm.device_type != "cuda" for mm in meshes.values()):
        fail(f"rank {rank}: a mesh is not on the card")
    cfg = get_config(ms["arch"])
    m, d = cfg.stages[1].pattern[0].moe, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(ms["seed"])
    out = {"rank": rank, "records": {}, "digests": {}, "launches": collections.Counter()}

    def sync():
        torch.cuda.synchronize(dev)

    def weights(dtype):
        specs = moe.moe_param_specs(d, m, dtype)
        return {n: (torch.randn(s.shape, generator=gen, device=dev)
                    * s.shape[-2] ** -0.5).to(s.dtype) for n, s in specs.items()}

    def counted(fn):
        """``fn()`` with this rank's kernel launches and MOE_FFN dispatches
        (by platform) during it."""
        sync()
        _cuda.reset_launch_counts()
        before = dict(counts)
        res = fn()
        sync()
        got = {k: v for k, v in _cuda.launch_counts().items() if v}
        rows = {k: v - before.get(k, 0) for k, v in counts.items()
                if k.startswith("MOE_FFN/") and v - before.get(k, 0)}
        return res, got, rows

    def timed_call(fn):
        """(host ms a call, the median of ``timed``; device ms a call by
        torch.profiler): every rank runs the same calls, each rank times
        its own."""
        walls = []
        for _ in range(ms["timed"]):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls), device_ms_per_call(fn, ms["profiled"], dev)

    def mesh_check(label, mk, p, x, timed, m_=m):
        """One MoE call under mesh ``mk`` against ``moe_by_shares``."""
        mode, shares = mesh_shares(x, m_, ms["meshes"][mk])
        t = x.shape[0] * x.shape[1]
        route = f"mmm_{mmm_route(x.dtype, t)}"
        ref_y, ref_aux, ref_taps = moe_by_shares(p, x, m_, shares)
        calls0 = dict(moe.BODY_CALLS)
        bytes0 = dict(mesh_ops.BYTES_SENT)
        with mesh_context(meshes[mk]), expert_tap() as taps:
            (y, aux), got, rows = counted(lambda: moe.moe_layer(p, x, m_, "swiglu"))
            y2, aux2 = moe.moe_layer(p, x, m_, "swiglu")
        body = {k: v - calls0.get(k, 0) for k, v in moe.BODY_CALLS.items()
                if v - calls0.get(k, 0)}
        sent = {k: (v - bytes0.get(k, 0)) // 2 for k, v in mesh_ops.BYTES_SENT.items()
                if v - bytes0.get(k, 0)}
        if body != {mode: 2}:
            fail(f"{label} rank {rank}: bodies ran {body}, not the {mode} body twice")
        if got != {route: 3}:
            fail(f"{label} rank {rank}: launches {got}, not 3 {route} (the shared experts)")
        if rows != {"MOE_FFN/aten": 1}:
            fail(f"{label} rank {rank}: MOE_FFN ran on {rows}, not once on this rank's aten row")
        if y.shape != x.shape or y.dtype != x.dtype or not bool(torch.isfinite(y).all()):
            fail(f"{label} rank {rank}: y {tuple(y.shape)} {y.dtype} or non-finite")
        if not (torch.equal(y, y2) and torch.equal(aux, aux2)):
            fail(f"{label} rank {rank}: two calls differ")
        err = normwise(y, ref_y)
        aux_err = abs(float(aux) - float(ref_aux)) / max(abs(float(ref_aux)), 1e-30)
        if not (err <= TOL[x.dtype] and aux_err <= TOL[x.dtype]):
            fail(f"{label} rank {rank}: y normwise {err:.3e}, aux relative {aux_err:.3e} "
                 f"against moe_layer by shares (tol {TOL[x.dtype]:g})")
        e_loc = m_.n_experts // ms["meshes"][mk][1]
        slice_equal = None
        if mode == "replicated" and shares == 1:
            slice_equal = bool(torch.equal(
                taps[0], ref_taps[0][rank * e_loc:(rank + 1) * e_loc]))
            if not slice_equal:
                fail(f"{label} rank {rank}: expert outputs differ from moe_layer's rows "
                     f"[{rank * e_loc}, {(rank + 1) * e_loc})")
        rec = {"mode": mode, "shares": shares, "capacity": moe._capacity(t // shares, m_),
               "normwise": err, "aux_rel": aux_err, "launches": got, "moe_ffn": rows,
               "bytes_sent": sent, "expert_slice_equal": slice_equal}
        out["digests"][label] = digest(y, aux)
        out["launches"].update(got)
        if timed:
            with mesh_context(meshes[mk]):
                rec["host_ms"], rec["device_ms"] = timed_call(
                    lambda: moe.moe_layer(p, x, m_, "swiglu"))
            rec["moe_layer_host_ms"], rec["moe_layer_device_ms"] = timed_call(
                lambda: moe.moe_layer(p, x, m_, "swiglu"))
        out["records"][label] = rec
        return y

    if "layers" in legs:
        layers = {layer: weights(torch.bfloat16) for layer in range(1, ms["layers"] + 1)}
        xs = {"prefill": torch.randn((ms["batch"], ms["prefill"], d), generator=gen,
                                     device=dev).to(torch.bfloat16),
              "decode": torch.randn((ms["batch"], 1, d), generator=gen,
                                    device=dev).to(torch.bfloat16)}
        for mk in ms["meshes"]:
            for batch, x0 in xs.items():
                x = x0
                for layer, p in layers.items():
                    x = mesh_check(f"(a) {mk} {batch} layer {layer}", mk, p, x, layer == 1)
            # int8 dispatch: the first layer's prefill against the exact path
            p, x = layers[1], xs["prefill"]
            m8 = dataclasses.replace(m, a2a_precision="int8")
            with mesh_context(meshes[mk]):
                exact = moe.moe_layer(p, x, m, "swiglu")[0]
                y8, aux8 = moe.moe_layer(p, x, m8, "swiglu")
                y8b = moe.moe_layer(p, x, m8, "swiglu")[0]
            rel = float((y8.float() - exact.float()).abs().max() / exact.float().abs().max())
            if not 0 < rel < ms["int8_rel"] or not torch.equal(y8, y8b):
                fail(f"(a) {mk} int8 rank {rank}: relative gap {rel:.3e} to the exact "
                     f"dispatch (limit {ms['int8_rel']}) or two calls differ")
            out["digests"][f"(a) {mk} int8"] = digest(y8, aux8)
            out["records"][f"(a) {mk} int8"] = {"rel_to_exact": rel}
        del layers, xs
        torch.cuda.empty_cache()
    if "f32" in legs:
        p32 = weights(torch.float32)
        x32 = torch.randn((ms["batch"], 1, d), generator=gen, device=dev)
        mesh_check("(a) 1x4 decode float32 layer 1", "1x4", p32, x32, True)
        del p32
        torch.cuda.empty_cache()
    if "serve" in legs:
        sv = ms["serve"]
        full = get_config(ms["arch"])
        cut = dataclasses.replace(full, stages=(
            full.stages[0], dataclasses.replace(full.stages[1], pattern=tuple(
                dataclasses.replace(b, moe=dataclasses.replace(
                    b.moe, capacity_factor=sv["capacity_factor"]))
                for b in full.stages[1].pattern), repeats=sv["moe_layers"])))
        model = build_model(cut)
        params = model.init(torch.Generator(device=dev).manual_seed(ms["seed"]))
        prompts = torch.randint(0, cut.vocab_size, (sv["requests"], sv["prompt_len"]),
                                generator=gen, device=dev)
        max_len = sv["prompt_len"] + sv["max_new"] + 8
        mesh = meshes[sv["mesh"]]
        calls0 = dict(moe.BODY_CALLS)
        sync()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        serving = ServeEngine(model, max_len=max_len)
        with mesh_context(mesh), torch.no_grad():
            toks = serving.generate(params, prompts, sv["max_new"])
        sync()
        # under a mesh the decode step is not captured: every step eager
        graph_stats = serving._scheds[len(prompts)].engine.step_stats()
        del serving
        serve_s = time.perf_counter() - t0
        launches = {k: v for k, v in _cuda.launch_counts().items() if v}
        body = {k: v - calls0.get(k, 0) for k, v in moe.BODY_CALLS.items()
                if v - calls0.get(k, 0)}
        out["launches"].update(launches)
        out["digests"]["(b) tokens"] = digest(toks)
        # the one-process run (its routing recorded), then the mesh fed its
        # tokens, routing free (flips counted) and with its choices forced
        from repro_torch.serve.kvcache import pad_caches

        def lockstep(mesh_, feed=None):
            logits_, toks_ = [], []
            with mesh_context(mesh_), torch.no_grad():
                lg, caches = model.prefill(params, {"tokens": prompts})
                caches = pad_caches(cut, caches, max_len)
                logits_.append(lg.float())
                for i in range(sv["max_new"] - 1):
                    nxt = feed[i] if feed is not None else lg.argmax(-1, keepdim=True)
                    toks_.append(nxt)
                    lg, caches = model.decode_step(params, caches, nxt, sv["prompt_len"] + i)
                    logits_.append(lg.float())
            return logits_, toks_
        calls = []
        with routing_tap("record", calls):
            one, one_toks = lockstep(None)
        with mesh_routing("record", calls, mesh):
            free, _ = lockstep(mesh, one_toks)
        with mesh_routing("force", calls, mesh):
            meshed, _ = lockstep(mesh, one_toks)
        errs = [normwise(a, b) for a, b in zip(meshed, one)]
        free_errs = [normwise(a, b) for a, b in zip(free, one)]
        flips = [int((c["mesh"][1].sort(-1).values != c["eidx"][c["mesh"][0]].sort(-1).values)
                     .any(-1).sum()) for c in calls]
        if len(errs) != sv["max_new"] or not max(errs) <= TOL[torch.bfloat16]:
            fail(f"(b) rank {rank}: logits with routing forced against the one-process "
                 f"run {errs}")
        first = torch.cat(one_toks + [one[-1].argmax(-1, keepdim=True)], dim=1)
        out["records"]["(b)"] = {
            "mesh": sv["mesh"], "serve_s": serve_s, "bodies": body, "launches": launches,
            "logits_normwise": errs, "logits_normwise_free": free_errs,
            "flips_by_call": flips, "tokens": toks.tolist(),
            "tokens_equal_one_process": bool(torch.equal(toks, first)),
            "decode_graph": graph_stats}
        if not body.get("a2a") or not body.get("replicated"):
            fail(f"(b) rank {rank}: the bodies ran {body}: the engine lost the mesh")
        if graph_stats["captures"] or graph_stats["replays"] \
                or graph_stats["eager_steps"] != sv["max_new"] - 1:
            fail(f"(b) rank {rank}: decode steps {graph_stats} under the mesh, not "
                 f"{sv['max_new'] - 1} eager")
        del model, params
        torch.cuda.empty_cache()
    out["body_calls"] = dict(moe.BODY_CALLS)
    out["launches"] = dict(out["launches"])
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    halo.finalize()
    return out


def phase3j(dev, card):
    """Expert parallelism under a device mesh (ROADMAP A10c's serving half;
    ``MESH``): four ranks on the one card over ``gloo`` (``run_ranks``),
    every rank holding every tensor whole outside the ``shard_map`` bodies.
    (a) moonshot's MoE layers at published width, bfloat16, 2 layers:
    prefill 4 × 128 (a2a) and decode 4 × 1 (replicated) on (1, 4) and (2,
    2), int8 dispatch on the prefill, float32 decode on (1, 4); each call
    within ``TOL`` of ``moe_layer`` in one process on the same token
    shares (``moe_by_shares``: the capacity a call sizes from the tokens
    it sees), two calls the same bits, the bodies and MOE_FFN on this
    rank's aten row counted, 3 MMM launches a call on ``mmm_route``'s
    route; on (1, 4) decode every rank's expert outputs ``torch.equal`` to
    ``moe_layer``'s rows, float32 included.  (b) moonshot at full width
    cut to 3 layers served through ``ServeEngine.generate`` under the
    mesh; every step's logits within ``TOL`` of a one-process run fed the
    same tokens with that run's expert choices forced (``mesh_routing``;
    the free run's gap and the tokens it routes otherwise printed, as the
    phase-3b MoE legs force the kernels' choices).  Every rank's results
    the same bits (digests).  The
    kernel library is built before the ranks start; every rank is reaped
    before this returns.  Returns (launches summed over the ranks,
    stats)."""
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import run_ranks

    _cuda.lib()
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(mesh_rank, MESH["ranks"], backend="gloo", timeout=MESH["timeout"],
                          args=(("layers", "f32", "serve"),), device_type="cuda")
    except (RuntimeError, TimeoutError) as exc:
        fail(f"phase 3j: {exc}")
    wall = time.perf_counter() - t0
    for label, dig in ranks[0]["digests"].items():
        differ = [r["rank"] for r in ranks if r["digests"].get(label) != dig]
        if differ:
            fail(f"phase 3j {label}: ranks {differ} differ from rank 0")
    for r in ranks:
        if not r["body_calls"].get("a2a") or not r["body_calls"].get("replicated"):
            fail(f"phase 3j: rank {r['rank']} ran the bodies {r['body_calls']}")
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
    records = ranks[0]["records"]
    for label, rec in records.items():
        extra = ""
        if "host_ms" in rec:
            extra = (f"; host {rec['host_ms']:.3f} ms, device {rec['device_ms']:.3f} ms a "
                     f"call (moe_layer in one process: host {rec['moe_layer_host_ms']:.3f}"
                     f" ms, device {rec['moe_layer_device_ms']:.3f} ms)")
        if "mode" in rec:
            print(f"  {label}: {rec['mode']} over {rec['shares']} shares, C={rec['capacity']}"
                  f"; normwise {rec['normwise']:.3e}, aux {rec['aux_rel']:.3e}; bytes a rank "
                  f"hands each verb {rec['bytes_sent']}; expert slice equal "
                  f"{rec['expert_slice_equal']}{extra}")
        elif label == "(b)":
            print(f"  (b) served under {rec['mesh']}: {rec['serve_s']:.2f} s; bodies "
                  f"{rec['bodies']}; launches {rec['launches']}; logits normwise against "
                  f"one process, routing forced "
                  f"{['%.2e' % e for e in rec['logits_normwise']]}, free "
                  f"{['%.2e' % e for e in rec['logits_normwise_free']]} (tokens routed "
                  f"otherwise by MoE call {rec['flips_by_call']}); tokens equal to the "
                  f"one-process run {rec['tokens_equal_one_process']}")
        else:
            print(f"  {label}: {rec}")
    stats = {"ranks": MESH["ranks"], "backend": "gloo", "wall_s": wall,
             "peak_gb": [r["peak_gb"] for r in ranks], "records": records,
             "body_calls": [r["body_calls"] for r in ranks], "launches": dict(launches)}
    print(f"  four ranks on {card}: {wall:.1f} s with spawn; peak GB a rank "
          f"{[round(g, 2) for g in stats['peak_gb']]}; launches over the ranks {dict(launches)}")
    return dict(launches), stats


# ---------------------------------------------------------------------------
# phase 3k: training under a device mesh
# ---------------------------------------------------------------------------
def mesh_train_config(moe_layers: int):
    """moonshot at full width cut to layer 0 and ``moe_layers`` MoE layers
    at ``MESH_TRAIN``'s capacity factor."""
    from repro_torch.configs import get_config
    full = get_config(MESH_TRAIN["arch"])
    return dataclasses.replace(full, stages=(
        full.stages[0], dataclasses.replace(full.stages[1], pattern=tuple(
            dataclasses.replace(b, moe=dataclasses.replace(
                b.moe, capacity_factor=MESH_TRAIN["capacity_factor"]))
            for b in full.stages[1].pattern), repeats=moe_layers)))


def mesh_train_reckoning(cfg) -> dict:
    """Device bytes one rank holds at a step's peak under the global view,
    from the parameter specs: the parameters, their gradients (each in its
    parameter's type), AdamW's float32 moments, the update's new
    parameters and moments beside the old (the old state is freed after
    the step), and four float32 temporaries of the largest leaf (its
    update).  Activations are not reckoned: the one-process step's peak,
    measured, stands beside this."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.transformer import param_specs
    specs = tree_leaves(param_specs(cfg))
    item = [torch.empty((), dtype=s.dtype).element_size() for s in specs]
    n = [math.prod(s.shape) for s in specs]
    params = sum(k * i for k, i in zip(n, item))
    parts = {"params": params, "grads": params, "moments": 8 * sum(n),
             "new_state": params + 8 * sum(n), "update_temporaries": 16 * max(n)}
    return {"parameters": sum(n), **parts, "total": sum(parts.values())}


def fingerprint(ts) -> list:
    """Each tensor's bit patterns summed with pseudo-random int64 weights
    (one fixed stream, the same on every rank), mod 2⁶⁴, on its device: two
    tensors whose bits differ anywhere give equal sums with probability
    about 2⁻³² or less (a bit pattern of ≤ 32 bits differs by less than
    2³²).  Stands in for torch.equal across ranks where the state is GBs a
    rank."""
    out = []
    for t in ts:
        t = t.detach().reshape(-1)
        bits = t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
        gen = torch.Generator(device=t.device).manual_seed(38)
        acc = torch.zeros((), dtype=torch.int64, device=t.device)
        for chunk in bits.split(1 << 26):
            w = torch.randint(-(1 << 62), 1 << 62, chunk.shape, generator=gen,
                              device=t.device, dtype=torch.int64)
            acc += (chunk.to(torch.int64) * w).sum()
        out.append(int(acc))
    return out


def mesh_train_rank(shape, moe_layers: int, ref_path: str):
    """Phase 3k in one rank (``run_ranks``): ``MESH_TRAIN["steps"]`` steps
    of make_train_step under a (data, model) mesh of ``shape``; step 1's gradients
    against the one-process step's (``ref_path``, rank 0); then the int8
    dispatch's gradients against the exact one's.  Every check is a
    ``fail()``; returns this rank's records, fingerprints and counts."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import halo
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import mesh_ops
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.optim.adamw import adamw_init, global_norm
    from repro_torch.train import trainer

    mt = MESH_TRAIN
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    session = halo.initialize()                   # device=None means the card
    if session.device.type != "cuda":
        fail(f"rank {rank}: session runs on {session.device}, not the card")
    mesh = make_mesh(shape, ("data", "model"))
    mesh_key = f"{shape[0]}x{shape[1]}"
    cfg = mesh_train_config(moe_layers)
    expect = train_structure(cfg)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(mt["seed"]))
    pipe = SyntheticLM(cfg, mt["seq_len"], mt["batch"], mt["seed"])
    hp = trainer.TrainHyper(base_lr=mt["lr"], warmup_steps=1, total_steps=mt["steps"])
    state = trainer.TrainState(params=params, opt=adamw_init(params))
    del params
    out = {"rank": rank, "steps": [], "launches": collections.Counter()}

    def delta(before, now):
        return {k: v - before.get(k, 0) for k, v in now.items() if v - before.get(k, 0)}

    orig = trainer.loss_and_grads

    def recorded(model_, params_, batch_):
        """loss_and_grads with this step's records: bytes a verb in the
        forward and in the backward (the recompute's forward exchanges
        included), body calls, fingerprints, and at step 1 the gradients
        against the one-process step's."""
        rec = {"step": len(out["steps"]) + 1}
        bytes0, calls0 = dict(mesh_ops.BYTES_SENT), dict(moe.BODY_CALLS)
        forward = {}

        def loss_fn(p, b):
            res = type(model_).loss_fn(model_, p, b)
            forward.update(delta(bytes0, mesh_ops.BYTES_SENT))
            return res
        model_.loss_fn = loss_fn
        try:
            loss, metrics, grads = orig(model_, params_, batch_)
        finally:
            del model_.loss_fn
        total = delta(bytes0, mesh_ops.BYTES_SENT)
        rec["bytes_forward"] = forward
        rec["bytes_backward"] = {k: v - forward.get(k, 0) for k, v in total.items()}
        rec["body_calls"] = delta(calls0, moe.BODY_CALLS)
        leaves = tree_leaves(grads)
        rec["grad_norm"] = float(global_norm(grads))
        rec["xent"], rec["aux"] = float(metrics["xent"]), float(metrics["aux"])
        out.setdefault("fingerprints", {})[f"step {rec['step']} loss, grads"] = \
            fingerprint([loss, *leaves])
        if rec["step"] == 1 and rank == 0:
            ref = torch.load(ref_path)
            rec["cosines"] = [cosine(g, r.to(dev)) for g, r in zip(leaves, ref["grads"])]
            rec["ref"] = {k: ref[k] for k in ("xent", "grad_norm", "aux")}
            del ref
        out["steps"].append(rec)
        return loss, metrics, grads

    trainer.loss_and_grads = recorded
    try:
        step_fn = trainer.make_train_step(model, hp)
        for i in range(mt["steps"]):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _cuda.reset_launch_counts()
            profiled = rank == 0 and i == mt["steps"] - 1
            with mesh_context(mesh), (profile(activities=[ProfilerActivity.CUDA])
                                      if profiled else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                new, metrics = step_fn(state, pipe.device_batch(i, dev))
                torch.cuda.synchronize(dev)
                host_ms = (time.perf_counter() - t0) * 1e3
            trainer._donate(state, new)
            state = new
            rec = out["steps"][-1]
            rec.update(host_ms=host_ms, loss=float(metrics["loss"]),
                       peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                       launches={k: v for k, v in _cuda.launch_counts().items() if v})
            if profiled:
                rec["device_ms"] = device_seconds(prof) * 1e3
            out["launches"].update(rec["launches"])
            out["fingerprints"][f"step {rec['step']} state"] = fingerprint(
                [metrics["loss"], *tree_leaves(state)])
            if rec["launches"] != expect:
                fail(f"3k {mesh_key} rank {rank} step {rec['step']}: launches "
                     f"{rec['launches']}, the structure gives {expect}")
            if rec["body_calls"] != {"a2a": 2 * moe_layers}:
                fail(f"3k {mesh_key} rank {rank} step {rec['step']}: bodies ran "
                     f"{rec['body_calls']}, not a2a twice a MoE layer (forward and "
                     f"recompute): the recompute lost the mesh")
            if rec["bytes_backward"].get("all_to_all", 0) != \
                    rec["bytes_forward"].get("all_to_all", 0) * 2:
                fail(f"3k {mesh_key} rank {rank} step {rec['step']}: all_to_all bytes "
                     f"forward {rec['bytes_forward']}, backward with the recompute "
                     f"{rec['bytes_backward']}: the backward's own exchange is not "
                     f"the forward's")
            if not all(math.isfinite(rec[k]) for k in ("loss", "grad_norm")):
                fail(f"3k {mesh_key} rank {rank} step {rec['step']}: not finite {rec}")
    finally:
        trainer.loss_and_grads = orig
    first = out["steps"][0]
    if rank == 0:
        xent_err = abs(first["xent"] - first["ref"]["xent"]) / abs(first["ref"]["xent"])
        gnorm_err = abs(first["grad_norm"] - first["ref"]["grad_norm"]) / \
            first["ref"]["grad_norm"]
        worst = min(first["cosines"])
        first.update(xent_err=xent_err, gnorm_err=gnorm_err, worst_cosine=worst)
        if xent_err > TRAIN_LOSS_TOL or gnorm_err > TRAIN_GNORM_TOL or worst < TRAIN_COS_MIN:
            fail(f"3k {mesh_key}: step 1 against one process: xent {xent_err:.2e} (tol "
                 f"{TRAIN_LOSS_TOL:g}), grad norm {gnorm_err:.2e} (tol {TRAIN_GNORM_TOL:g}), "
                 f"worst leaf cosine {worst:.6f} (min {TRAIN_COS_MIN:g})")
    # (c) the int8 dispatch's gradients against the exact dispatch's, on
    # the trained parameters (the moments go first)
    params = state.params
    del state, new
    torch.cuda.empty_cache()
    m8 = build_model(dataclasses.replace(cfg, stages=tuple(
        dataclasses.replace(st, pattern=tuple(
            dataclasses.replace(b, moe=dataclasses.replace(b.moe, a2a_precision="int8"))
            if b.moe is not None else b for b in st.pattern)) for st in cfg.stages)))
    batch = pipe.device_batch(0, dev)
    with mesh_context(mesh):
        exact = tree_leaves(trainer.loss_and_grads(model, params, batch)[2])
        int8 = tree_leaves(trainer.loss_and_grads(m8, params, batch)[2])
    cos8 = [cosine(a, b) for a, b in zip(int8, exact)]
    out["int8"] = {"worst_cosine": min(cos8), "rel_max": max(
        float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
        for a, b in zip(int8, exact))}
    out["fingerprints"]["int8 grads"] = fingerprint(int8)
    if min(cos8) < TRAIN_COS_MIN:
        fail(f"3k {mesh_key} rank {rank}: int8 dispatch's gradients against the exact "
             f"dispatch's: worst leaf cosine {min(cos8):.6f} (min {TRAIN_COS_MIN:g})")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["launches"] = dict(out["launches"])
    del params, exact, int8
    halo.finalize()
    return out


def mesh_train_reference(moe_layers: int, ref_path: str) -> dict:
    """Phase 3k's one-process step, in a process of its own (so that its
    memory goes with it): one make_train_step on the weights and batch the
    ranks take, its step-1 gradients, xent, aux and grad norm saved to
    ``ref_path``; returns those scalars, the step's host ms and its peak
    bytes."""
    from repro_torch import halo
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init, global_norm
    from repro_torch.train import trainer

    mt = MESH_TRAIN
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    session = halo.initialize()
    if session.device.type != "cuda":
        fail(f"the one-process step runs on {session.device}, not the card")
    cfg = mesh_train_config(moe_layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(mt["seed"]))
    batch = SyntheticLM(cfg, mt["seq_len"], mt["batch"], mt["seed"]).device_batch(0, dev)
    state = trainer.TrainState(params=params, opt=adamw_init(params))
    del params
    kept = {}
    orig = trainer.loss_and_grads

    def keep(model_, params_, batch_):
        loss, metrics, grads = orig(model_, params_, batch_)
        kept.update(grads=[g.cpu() for g in tree_leaves(grads)], xent=float(metrics["xent"]),
                    aux=float(metrics["aux"]), grad_norm=float(global_norm(grads)))
        return loss, metrics, grads
    trainer.loss_and_grads = keep
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer.make_train_step(model, trainer.TrainHyper(
            base_lr=mt["lr"], warmup_steps=1, total_steps=mt["steps"]))(state, batch)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        trainer.loss_and_grads = orig
    torch.save(kept, ref_path)
    halo.finalize()
    return {"xent": kept["xent"], "aux": kept["aux"], "grad_norm": kept["grad_norm"],
            "ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}


def mesh_train_leg(dev, card, meshes: dict, moe_layers: int, backend: str):
    """Training under each of ``meshes`` (key → shape, one mesh after the
    other), moonshot cut to ``moe_layers`` MoE layers: the reckoning, the
    one-process step (its gradients kept in a file, its memory freed),
    then each mesh's ranks (``mesh_train_rank``) over ``backend`` (gloo:
    the ranks share the card ``dev``; nccl: one card a rank).  Returns
    (launches summed over the ranks, stats)."""
    import tempfile

    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import run_ranks

    mt = MESH_TRAIN
    ranks = math.prod(next(iter(meshes.values())))
    cfg = mesh_train_config(moe_layers)
    reckoning = mesh_train_reckoning(cfg)
    print(f"  moonshot-v1-16b-a3b at full width, layer 0 and {moe_layers} MoE layer(s) at "
          f"capacity factor {mt['capacity_factor']}, bfloat16, {mt['batch']} x "
          f"{mt['seq_len']} tokens a step; mesh_train_reckoning (bytes a rank): "
          f"{json.dumps(reckoning)}")

    print("  one process, step 1 on the same weights and batch (the reference for (b)), "
          "in a process of its own")
    _cuda.lib()
    with tempfile.TemporaryDirectory(prefix="mesh_train_") as tmp:
        ref_path = str(Path(tmp) / "step1.pt")
        try:
            one = run_ranks(mesh_train_reference, 1, backend="gloo", timeout=mt["timeout"],
                            args=(moe_layers, ref_path), device_type="cuda")[0]
        except (RuntimeError, TimeoutError) as exc:
            fail(f"phase 3k, the one-process step: {exc}")
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0] if backend == "gloo" else \
            torch.cuda.get_device_properties(dev).total_memory
        one_peak = one["peak"]
        per_rank = max(reckoning["total"], one_peak) + mt["headroom_gb"] * 1e9
        need = per_rank * (ranks if backend == "gloo" else 1)
        print(f"    xent {one['xent']:.6f}, aux {one['aux']:.6f}, grad norm "
              f"{one['grad_norm']:.6f}; the whole step {one['ms']:.1f} ms, peak "
              f"{one_peak / 1e9:.2f} GB (reckoned {reckoning['total'] / 1e9:.2f})")
        print(f"    a rank needs {per_rank / 1e9:.2f} GB (the larger of the two, and "
              f"{mt['headroom_gb']} GB for its context and the backend's buffers); "
              f"{ranks} rank(s) over {backend}, "
              f"{'all on the card' if backend == 'gloo' else 'one a card'}: "
              f"{need / 1e9:.2f} GB of {free / 1e9:.2f} GB free a card")
        if need > free:
            fail(f"phase 3k: {ranks} ranks of {per_rank / 1e9:.2f} GB do not fit the "
                 f"{free / 1e9:.2f} GB free on {card}")

        launches = collections.Counter()
        stats = {"moe_layers": moe_layers, "reckoning": reckoning, "one_process_peak_gb":
                 one_peak / 1e9, "one_process_step_ms": one["ms"], "backend": backend,
                 "meshes": {}}
        for mk, shape in meshes.items():
            t0 = time.perf_counter()
            try:
                got = run_ranks(mesh_train_rank, ranks, backend=backend,
                                timeout=mt["timeout"],
                                args=(tuple(shape), moe_layers, ref_path),
                                device_type="cuda")
            except (RuntimeError, TimeoutError) as exc:
                fail(f"phase 3k {mk}: {exc}")
            wall = time.perf_counter() - t0
            r0 = got[0]
            for label, fp in r0["fingerprints"].items():
                differ = [r["rank"] for r in got if r["fingerprints"].get(label) != fp]
                if differ:
                    fail(f"phase 3k {mk} {label}: ranks {differ} differ from rank 0")
            for r in got:
                launches.update(r["launches"])
            first = r0["steps"][0]
            print(f"  ({shape[0]}, {shape[1]}) over {ranks} {backend} rank(s): {wall:.1f} s "
                  f"with spawn; (a) every rank's loss, gradients and state the same bits "
                  f"as rank 0's after each step ({len(r0['fingerprints'])} fingerprints)")
            print(f"    (b) step 1 against one process: xent {first['xent']:.6f} vs "
                  f"{first['ref']['xent']:.6f} ({first['xent_err']:.2e}), grad norm "
                  f"{first['grad_norm']:.6f} vs {first['ref']['grad_norm']:.6f} "
                  f"({first['gnorm_err']:.2e}), worst leaf cosine {first['worst_cosine']:.6f}"
                  f"; aux {first['aux']:.6f} (one process {first['ref']['aux']:.6f}: the "
                  f"mesh's is the mean of each share's)")
            print(f"    (c) int8 dispatch against exact: worst leaf cosine "
                  f"{r0['int8']['worst_cosine']:.6f}, largest relative gap "
                  f"{r0['int8']['rel_max']:.3e}")
            for rec in r0["steps"]:
                print(f"    step {rec['step']}: loss {rec['loss']:.6f}, grad norm "
                      f"{rec['grad_norm']:.6f}; host {rec['host_ms']:.1f} ms"
                      + (f", device {rec['device_ms']:.1f} ms (rank 0, profiler)"
                         if "device_ms" in rec else "")
                      + f"; peak {rec['peak_gb']:.2f} GB; (d) launches {rec['launches']}; "
                      f"(e) bodies {rec['body_calls']}; (f) bytes a rank forward "
                      f"{rec['bytes_forward']}, backward with the recompute "
                      f"{rec['bytes_backward']}")
            stats["meshes"][mk] = {
                "shape": list(shape), "wall_s": wall, "steps": [
                    {k: v for k, v in rec.items() if k not in ("cosines", "ref")}
                    for rec in r0["steps"]],
                "int8": r0["int8"], "peak_gb": [r["peak_gb"] for r in got],
                "step1": {k: first[k] for k in ("xent_err", "gnorm_err", "worst_cosine")}}
    return dict(launches), stats


def phase3k(dev, card):
    """Training under a device mesh (ROADMAP A10c's training half;
    ``MESH_TRAIN``): moonshot at published width cut to layer 0 and one MoE
    layer, two gloo ranks on the one card, (1, 2) then (2, 1), two steps of
    make_train_step each.  (a) after every step every rank's loss,
    gradients and state the same bits as rank 0's (``fingerprint``); (b)
    step 1's cross-entropy, grad norm and every gradient leaf against a
    one-process step on the same weights and batch at phase 3d's
    tolerances (aux printed: under a mesh it is the mean of each share's);
    (c) the int8 dispatch's gradients against the exact dispatch's, every
    leaf at cosine ≥ TRAIN_COS_MIN; (d) the kernels' launches a step by
    structure (``train_structure``); (e) the a2a body twice a MoE
    layer a step (forward and recompute: the recompute kept the mesh);
    (f) the backward's all_to_all bytes equal the forward's.  The
    reckoning is printed before any rank starts, and the phase fails if
    the ranks would not fit.  Returns (launches summed over the ranks,
    meshes and steps, stats)."""
    return mesh_train_leg(dev, card, MESH_TRAIN["meshes"], MESH_TRAIN["moe_layers"], "gloo")


# ---------------------------------------------------------------------------
# phase 3d: training
# ---------------------------------------------------------------------------
def leaf_names(tree, prefix: str = "params") -> list:
    """Each leaf's path, in the order ``core.tree.tree_leaves`` takes them."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, f"{prefix}[{i}]")]
    return [prefix]


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    den = float(a.norm() * b.norm())
    if den == 0.0:
        return 1.0 if float(a.norm()) == float(b.norm()) else 0.0
    return float(a @ b) / den


def train_structure(cfg) -> dict:
    """Launches one training step of a GQA stack makes, each repeat
    recomputed in the backward: each MMM of a pass (``moe_leg_structure``'s
    prefill count: 7 a danube layer; a MoE layer's shared experts included)
    in the forward and again in the recompute, dA and dB of each in the
    backward, and the unembed's forward with its two (3); RMSNORM 2 a layer
    forward and recompute and the final norm (its backward is the plain
    version's VJP); FLASH_ATTN 1 a layer forward and recompute (its backward
    is mea_attention's VJP); EMBED_GRAD once, the embedding's backward.
    Every product has 512 rows or more: the wgmma route.  Under a mesh
    every rank runs the whole model outside the MoE bodies, so each rank
    launches these (MOE_FFN has no kernel)."""
    layers = sum(st.repeats * len(st.pattern) for st in cfg.stages)
    st = moe_leg_structure(cfg)
    return {"mmm_wgmma": 4 * st["prefill_mmm"] + 3, "rmsnorm": 4 * layers + 1,
            f"flash_attention_{st['fa_route']}": 2 * layers, "embed_grad": 1}


def phase3d_backward(dev) -> None:
    """(a) each Function's gradients on the card against autograd of its
    plain version on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.matmul.ops import mmm
    from repro_torch.kernels.matmul.ref import mmm_ref, mmm_ulp_excess
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=dev).manual_seed(30)
    cfg = get_config(TRAIN["arch"])
    rows = TRAIN["batch"] * TRAIN["seq_len"]

    def rnd(*shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def grads(fn, inputs, g):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        if out.grad_fn is None:
            fail("a Function's output on the card has no grad_fn")
        out.backward(g)
        torch.cuda.synchronize(dev)
        return out.detach(), [t.grad for t in leaves]

    shapes = [(rows, k, n, torch.bfloat16) for k, n in decode_projections(cfg)]
    shapes.append((rows, 2560, 640, torch.float32))          # the tf32x3 route
    for m, k, n, dt in shapes:
        a = rnd(m, k, dtype=dt)
        b = rnd(k, n, dtype=dt, scale=k ** -0.5)
        g = rnd(m, n, dtype=dt, scale=1e-2)
        out, (da, db) = grads(mmm, (a, b), g)
        ref, (ra, rb) = grads(mmm_ref, (a, b), g)
        errs = [normwise(x, y) for x, y in ((out, ref), (da, ra), (db, rb))]
        for what, e in zip(("C", "dA", "dB"), errs):
            check_close(f"MMM backward {m}x{k} @ {k}x{n} {dt} {what}", e, dt)
        line = (f"  MMM {m}x{k} @ {k}x{n} {str(dt)[6:]}: C {errs[0]:.2e}, dA {errs[1]:.2e}, "
                f"dB {errs[2]:.2e} against autograd of mmm_ref")
        if dt != torch.float32:
            excess = (mmm_ulp_excess(da, g, b.t().contiguous()),
                      mmm_ulp_excess(db, a.t().contiguous(), g))
            if any(excess):
                fail(f"MMM backward {m}x{k} @ {k}x{n}: {excess} elements of dA, dB past "
                     f"half an ulp of the float32 product")
            line += "; dA, dB within half an ulp of the float32 products"
        print(line)
        del a, b, g, out, da, db, ref, ra, rb

    x = rnd(rows, cfg.d_model, dtype=torch.bfloat16, scale=2.0)
    gamma = rnd(cfg.d_model, dtype=torch.bfloat16, scale=0.1, shift=1.0)
    g = rnd(rows, cfg.d_model, dtype=torch.bfloat16)
    out, (dx, dg) = grads(lambda x_, g_: rmsnorm(x_, g_, eps=cfg.norm_eps), (x, gamma), g)
    ref, (rx, rg) = grads(lambda x_, g_: rmsnorm_ref(x_, g_, cfg.norm_eps), (x, gamma), g)
    errs = [normwise(p, q) for p, q in ((out, ref), (dx, rx), (dg, rg))]
    for what, e in zip(("out", "dx", "dgamma"), errs):
        check_close(f"RMSNORM backward {rows}x{cfg.d_model} {what}", e, torch.bfloat16)
    print(f"  RMSNORM {rows}x{cfg.d_model} bfloat16: out {errs[0]:.2e}, dx {errs[1]:.2e}, "
          f"dgamma {errs[2]:.2e}; gradients bit-identical to the plain version's: "
          f"{torch.equal(dx, rx) and torch.equal(dg, rg)}")

    attn = cfg.stages[0].pattern[0].attn
    fa_cases = [(TRAIN["batch"], attn.n_heads, attn.n_kv_heads, TRAIN["seq_len"],
                 attn.head_dim, attn.window), (1, 8, 4, TRAIN["seq_len"], 256, None)]
    for b_, h, hkv, s_, d, window in fa_cases:
        q = rnd(b_, h, s_, d, dtype=torch.bfloat16)
        k = rnd(b_, hkv, s_, d, dtype=torch.bfloat16)
        v = rnd(b_, hkv, s_, d, dtype=torch.bfloat16)
        g = rnd(b_, h, s_, d, dtype=torch.bfloat16)
        kw = dict(causal=True, window=window)
        out, gk = grads(lambda *t: flash_attention(*t, **kw), (q, k, v), g)
        ref, gr = grads(lambda *t: attention_ref(*t, **kw), (q, k, v), g)
        errs = [normwise(out, ref)] + [normwise(p, q_) for p, q_ in zip(gk, gr)]
        for what, e in zip(("out", "dq", "dk", "dv"), errs):
            check_close(f"FLASH_ATTN backward {b_}x{h}x{s_}x{d} on {hkv} KV heads {what}",
                        e, torch.bfloat16)
        print(f"  FLASH_ATTN {b_}x{h}x{s_}x{d} bfloat16 on {hkv} KV heads, causal, window "
              f"{window}: out {errs[0]:.2e}, dq {errs[1]:.2e}, dk {errs[2]:.2e}, "
              f"dv {errs[3]:.2e} against autograd of attention_ref")


def phase3d(dev):
    """Training: (a) ``phase3d_backward``; (b) danube at full width and
    depth through ``repro_torch.launch.train``, each step timed, profiled
    and counted; (c) step 1 on the kernels against step 1 on the plain rows;
    (d) LM_GRAD and ADAMW_STEP through ``halo_dispatch`` against
    ``make_train_step``.  Returns (the leg's launches over its steps,
    stats)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.core.c2mpi import halo_dispatch
    from repro_torch.core.manifest import default_manifest
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _cuda
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init, global_norm
    from repro_torch.train import step_kernels, trainer

    print("  (a) each Function's gradients against autograd of its plain version")
    phase3d_backward(dev)

    cfg = get_config(TRAIN["arch"])
    tokens = TRAIN["batch"] * TRAIN["seq_len"]
    expect = train_structure(cfg)
    print(f"  (b) {cfg.name} at full width and depth ({cfg.n_layers} layers, "
          f"{cfg.dtype}) through repro_torch.launch.train: {TRAIN['steps']} steps of "
          f"{TRAIN['batch']} x {TRAIN['seq_len']} tokens; launches a step by structure "
          f"{expect}")
    steps = []
    orig = trainer.make_train_step

    def timed_make_train_step(model, hp):
        step_fn = orig(model, hp)

        def timed(state, batch):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _cuda.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                torch.cuda.synchronize(dev)
                host_s = time.perf_counter() - t0
            launches = {k: v for k, v in _cuda.launch_counts().items() if v}
            by_kernel = sorted(((device_seconds_of(e) * 1e3, e.count, e.key)
                                for e in prof.key_averages() if device_seconds_of(e)),
                               reverse=True)
            rec = {"step": len(steps) + 1, "loss": float(metrics["loss"]),
                   "lr": float(metrics["lr"]), "grad_norm": float(metrics["grad_norm"]),
                   "host_ms": host_s * 1e3, "device_ms": device_seconds(prof) * 1e3,
                   "tokens_per_s": tokens / host_s,
                   "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                   "launches": launches,
                   "top_kernels": [(round(ms, 3), n, key[:90]) for ms, n, key in by_kernel[:12]]}
            rec["busy"] = rec["device_ms"] / rec["host_ms"]
            steps.append(rec)
            print(f"    step {rec['step']}: loss {rec['loss']:.4f}, lr {rec['lr']:.2e}, "
                  f"grad norm {rec['grad_norm']:.4f}, {rec['host_ms']:.1f} ms host "
                  f"(under the profiler), {rec['device_ms']:.1f} ms device (busy "
                  f"{rec['busy']:.3f}), {rec['tokens_per_s']:.0f} tokens/s, peak "
                  f"{rec['peak_gb']:.2f} GB; launches {launches}")
            if rec["step"] == TRAIN["steps"]:
                print("    its device time by kernel (ms, calls, name): " + "; ".join(
                    f"{ms:.2f} {n} {key[:60]}" for ms, n, key in rec["top_kernels"]))
            if launches != expect:
                fail(f"training step {rec['step']} launched {launches}, the structure "
                     f"gives {expect}")
            return state, metrics
        return timed

    trainer.make_train_step = timed_make_train_step
    try:
        history = launch_train.main([
            "--arch", TRAIN["arch"], "--steps", str(TRAIN["steps"]),
            "--seq-len", str(TRAIN["seq_len"]), "--batch", str(TRAIN["batch"]),
            "--lr", str(TRAIN["lr"]), "--seed", str(TRAIN["seed"])])
    finally:
        trainer.make_train_step = orig
    if len(steps) != TRAIN["steps"] or not history:
        fail(f"the launcher ran {len(steps)} steps, not {TRAIN['steps']}")
    for rec in steps:
        if not all(math.isfinite(rec[k]) for k in ("loss", "grad_norm")):
            fail(f"training step {rec['step']}: loss or grad norm not finite: {rec}")
    if abs(steps[0]["loss"] - math.log(cfg.vocab_size)) > 3.0:
        fail(f"step 1's loss {steps[0]['loss']:.4f} is far from ln(vocab) "
             f"{math.log(cfg.vocab_size):.4f} for random weights")
    launches = collections.Counter()
    for rec in steps:
        launches.update(rec["launches"])
    torch.cuda.empty_cache()

    print("  (c) step 1 on the kernels against step 1 on the plain rows (manifest "
          "prefers torch), same weights and batch")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(TRAIN["seed"]))
    batch = SyntheticLM(cfg, TRAIN["seq_len"], TRAIN["batch"], TRAIN["seed"]).device_batch(0, dev)
    halo.initialize()
    _cuda.reset_launch_counts()
    loss_k, _, grads_k = trainer.loss_and_grads(model, params, batch)
    kernel_launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    gnorm_k = float(global_norm(grads_k))
    halo.finalize()
    if kernel_launches != expect:
        fail(f"step 1 on the kernels launched {kernel_launches}, not {expect}")
    plain = default_manifest()
    plain.platform_list = [{"platform_preference": ["torch"]}]
    halo.initialize(manifest=plain)
    _cuda.reset_launch_counts()
    loss_p, _, grads_p = trainer.loss_and_grads(model, params, batch)
    plain_launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    gnorm_p = float(global_norm(grads_p))
    halo.finalize()
    if plain_launches:
        fail(f"the plain replay launched kernels: {plain_launches}")
    loss_k, loss_p = float(loss_k), float(loss_p)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    gnorm_err = abs(gnorm_k - gnorm_p) / gnorm_p
    cos = [(cosine(a, b), name) for a, b, name in
           zip(tree_leaves(grads_k), tree_leaves(grads_p), leaf_names(params))]
    worst_cos, worst_leaf = min(cos)
    print(f"    loss {loss_k:.6f} (kernels) vs {loss_p:.6f} (plain): {loss_err:.2e} "
          f"(tol {TRAIN_LOSS_TOL:g}); the launcher's step 1 read {steps[0]['loss']:.6f}; "
          f"grad norm {gnorm_k:.6f} vs {gnorm_p:.6f}: {gnorm_err:.2e} (tol "
          f"{TRAIN_GNORM_TOL:g}); worst leaf cosine {worst_cos:.6f} at {worst_leaf} "
          f"(min {TRAIN_COS_MIN:g}) over {len(cos)} leaves")
    if loss_err > TRAIN_LOSS_TOL or gnorm_err > TRAIN_GNORM_TOL or worst_cos < TRAIN_COS_MIN:
        fail("training step 1 on the kernels disagrees with the plain replay")
    if abs(loss_k - steps[0]["loss"]) > 1e-3 * abs(loss_k):
        fail(f"step 1 of the launcher ({steps[0]['loss']}) is not step 1 on the "
             f"same weights and batch ({loss_k})")
    del model, params, grads_k, grads_p
    torch.cuda.empty_cache()

    layers = TRAIN["alias_layers"]
    name = f"{TRAIN['arch']}@{layers}"
    cut = dataclasses.replace(cfg, stages=(dataclasses.replace(cfg.stages[0], repeats=layers),))
    step_kernels.register_arch(name, cut)
    model = build_model(cut)
    params = model.init(torch.Generator(device=dev).manual_seed(TRAIN["seed"]))
    p = step_kernels.param_size(name)
    print(f"  (d) LM_GRAD and ADAMW_STEP through halo_dispatch on {cut.name} at full "
          f"width cut to {layers} layers ({p} parameters) against make_train_step")
    hp = trainer.TrainHyper(base_lr=TRAIN["lr"], warmup_steps=1, total_steps=TRAIN["steps"])
    halo.initialize()
    _cuda.reset_launch_counts()
    pvec = step_kernels.flatten_params(params)
    gvec = halo_dispatch("LM_GRAD", pvec, batch["tokens"], batch["labels"], batch["mask"],
                         arch=name)
    alias_launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    zeros = torch.zeros_like(pvec)
    one = torch.ones((), dtype=torch.int32, device=dev)        # past the warmup
    out = halo_dispatch("ADAMW_STEP", gvec, pvec, zeros, zeros, one, arch=name,
                        n_micro=1, base_lr=hp.base_lr, warmup_steps=hp.warmup_steps,
                        total_steps=hp.total_steps, weight_decay=hp.weight_decay,
                        clip_norm=hp.clip_norm)
    new_vec, _, _, m = step_kernels.unpack_adamw_out(out, name)
    a_loss, a_gnorm = float(m["loss"]), float(m["grad_norm"])
    del gvec, out, zeros
    opt = adamw_init(params)._replace(step=one)
    state, ref = trainer.make_train_step(model, hp)(trainer.TrainState(params, opt), batch)
    r_loss, r_gnorm = float(ref["loss"]), float(ref["grad_norm"])
    new_cos = cosine(new_vec - pvec, step_kernels.flatten_params(state.params) - pvec)
    halo.finalize()
    expect_alias = train_structure(cut)
    loss_err, gnorm_err = abs(a_loss - r_loss) / abs(r_loss), abs(a_gnorm - r_gnorm) / r_gnorm
    print(f"    LM_GRAD launches {alias_launches} (structure {expect_alias}); loss "
          f"{a_loss:.6f} vs {r_loss:.6f}: {loss_err:.2e}; grad norm {a_gnorm:.6f} vs "
          f"{r_gnorm:.6f}: {gnorm_err:.2e}; the parameter updates' cosine {new_cos:.6f}; "
          f"step {int(m['step'])}")
    if alias_launches != expect_alias:
        fail(f"LM_GRAD launched {alias_launches}, not {expect_alias}")
    if loss_err > TRAIN_LOSS_TOL or gnorm_err > TRAIN_GNORM_TOL or new_cos < TRAIN_COS_MIN \
            or int(m["step"]) != 2:
        fail("LM_GRAD/ADAMW_STEP disagree with make_train_step")
    del model, params, pvec, new_vec, state
    torch.cuda.empty_cache()

    stats = {"arch": cfg.name, "layers": cfg.n_layers, "tokens_per_step": tokens,
             "steps": steps, "history": history, "step1_loss_kernels": loss_k,
             "step1_loss_plain": loss_p, "step1_gnorm_kernels": gnorm_k,
             "step1_gnorm_plain": gnorm_p, "worst_leaf_cosine": worst_cos,
             "worst_leaf": worst_leaf, "alias_layers": layers, "alias_params": p,
             "alias_loss": [a_loss, r_loss], "alias_grad_norm": [a_gnorm, r_gnorm],
             "alias_launches": alias_launches}
    return dict(launches), stats


def comm_reckoning(p: int, members: int, micro: int) -> dict:
    """Device bytes a comm step holds at its peak, in flat float32 vectors
    of ``p`` elements (4p bytes each) alive together while ADAMW_STEP runs:
    the step's pvec, mu and nu; one LM_GRAD output a microbatch and the
    EWADD tree's micro - 1 partials, which the replay's nodes keep until it
    returns; one allreduce COPY a member; ADAMW_STEP's working trees (the
    mean gradient, the clipped gradient, the new mu and nu, the weights in
    and out in bfloat16: five vectors' worth) and its 3p + 4 output.  The
    capture-time pvec, mu and nu the compiled graph keeps are freed after
    the first replay, as the reference's donation frees a step's input
    state; a running LM_GRAD's bfloat16 weights and gradients (one vector
    a member agent) are gone by then."""
    vectors = {"pvec, mu, nu": 3, "LM_GRAD outputs": micro, "EWADD partials": micro - 1,
               "allreduce copies": members, "ADAMW_STEP trees": 5,
               "ADAMW_STEP output": 3}
    return {"vectors": vectors, "gb": sum(vectors.values()) * 4 * p / 1e9}


def comm_structure(cut, members: int, micro: int, platforms) -> dict:
    """Launches one comm step makes: LM_GRAD's ``train_structure`` once a
    microbatch (each on the hopper rows, whatever member runs it), and on a
    hopper-only group the combines: EWADD micro - 1 times on the ewise
    kernel, the one-member group's last EWADD and its allreduce COPY fused
    into one chain-kernel launch.  A mixed group's combines land where the
    scheduler places them, so it fixes only the LM_GRAD part."""
    out = {k: v * micro for k, v in train_structure(cut).items()}
    if set(platforms) == {"hopper"} and micro > 1:
        if members == 1:
            out["ewise"], out["fused"] = micro - 2, 1
        else:
            out["ewise"] = micro - 1
    return {k: v for k, v in out.items() if v}


def phase3f(dev):
    """Data-parallel training (DESIGN.md §15) at danube's full width, the
    depth cut to ``TRAIN_COMM["layers"]``: (a) LM_GRAD twice bit-identical,
    EMBED_GRAD against its plain version bit for bit at a training step's
    gradient, the old atomic backward's differing elements printed; (b)
    every group of ``TRAIN_COMM["groups"]`` trained from the same weights
    on the same batches, histories and final params, mu and nu
    bit-identical, each step timed, profiled and counted; (c) a member's
    death before step 2 moving the epoch, a recapture, the 4-step history
    bit-identical to one member's; (d) step 1 against ``Trainer.run`` on
    one device with the same microbatches (phase 3d's tolerances); (e) a
    second run of one topology replayed from the compiled-graph cache.
    Returns (the (b) runs' launches, stats)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import halo
    from repro_torch.configs import get_config
    from repro_torch.core.agents import AtenAgent, HealthConfig
    from repro_torch.core.c2mpi import halo_dispatch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.embed_grad.embed_grad import embed_grad_hopper
    from repro_torch.kernels.embed_grad.ref import embed_grad_ref
    from repro_torch.models import build_model
    from repro_torch.testing.faults import FaultPlan, chaos
    from repro_torch.train import step_kernels, trainer

    tc = TRAIN_COMM
    cfg = get_config(tc["arch"])
    layers, micro = tc["layers"], tc["microbatches"]
    name = f"{tc['arch']}@{layers}"
    cut = dataclasses.replace(cfg, stages=(dataclasses.replace(cfg.stages[0],
                                                               repeats=layers),))
    step_kernels.register_arch(name, cut)
    model = build_model(cut)
    p = step_kernels.param_size(name)
    full_p = step_kernels.param_size(tc["arch"])
    widest = max(len(g) for g in tc["groups"].values())
    need = comm_reckoning(p, widest, micro)
    need_full = comm_reckoning(full_p, widest, micro)
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    print(f"  {cut.name} at full width (d_model {cut.d_model}, {cut.vocab_size} tokens, "
          f"{cut.dtype}), cut to {layers} of {cfg.n_layers} layers: {p} parameters "
          f"({full_p} at full depth); {tc['batch']} x {tc['seq_len']} tokens a step in "
          f"{micro} microbatches; reckoning of a {widest}-member step's float32 vectors "
          f"{need['vectors']} x 4p bytes: {need['gb']:.1f} GB at {layers} layers, "
          f"{need_full['gb']:.1f} GB at {cfg.n_layers} (the card holds {card_gb:.1f})")
    # no warmup: step 1 already moves the weights, so (d)'s update cosine
    # compares two non-zero updates
    hp = trainer.TrainHyper(base_lr=tc["lr"], warmup_steps=0,
                            total_steps=tc["death_steps"], microbatches=micro)
    pipe = SyntheticLM(cut, tc["seq_len"], tc["batch"], tc["seed"])

    def data(step):
        return pipe.device_batch(step, dev)

    def weights():
        return model.init(torch.Generator(device=dev).manual_seed(tc["seed"]))

    session = halo.initialize()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    # (a) determinism of one step's gradients
    params = weights()
    pvec = step_kernels.flatten_params(params)
    del params
    batch = data(0)
    mb = tuple(batch[k][:tc["batch"] // micro] for k in ("tokens", "labels", "mask"))
    _cuda.reset_launch_counts()
    first = halo_dispatch("LM_GRAD", pvec, *mb, arch=name)
    torch.cuda.synchronize(dev)
    one = {k: v for k, v in _cuda.launch_counts().items() if v}
    again = halo_dispatch("LM_GRAD", pvec, *mb, arch=name)
    same = torch.equal(first, again)
    print(f"  (a) LM_GRAD on microbatch 0 ({mb[0].numel()} tokens) twice: bit-identical "
          f"{same}; loss {float(first[0]):.6f}; launches a call {one} (structure "
          f"{train_structure(cut)})")
    if not same:
        fail("two LM_GRAD calls on the same inputs differ on the card")
    if one != train_structure(cut):
        fail(f"LM_GRAD launched {one}, not {train_structure(cut)}")
    del first, again, pvec
    gen = torch.Generator(device=dev).manual_seed(33)
    tokens = batch["tokens"].reshape(-1)
    g = torch.randn((tokens.numel(), cut.d_model), generator=gen, device=dev).to(cut.activation_dtype())
    vocab = cut.padded_vocab
    k1 = embed_grad_hopper(g, tokens, vocab)
    k2 = embed_grad_hopper(g, tokens, vocab)
    ref = embed_grad_ref(g, tokens, vocab)
    torch.cuda.synchronize(dev)
    runs = torch.bincount(tokens.long(), minlength=vocab)
    eq = torch.equal(k1, ref) and torch.equal(k1, k2)
    print(f"  (a) EMBED_GRAD at {tuple(g.shape)} {str(g.dtype)[6:]} into ({vocab}, "
          f"{cut.d_model}): kernel bit-identical to its plain version and to itself: "
          f"{eq} ({int((runs > 0).sum())} tokens occur, the longest run "
          f"{int(runs.max())} rows)")
    if not eq:
        fail(f"EMBED_GRAD disagrees with its plain version: max abs "
             f"{float((wide(k1) - wide(ref)).abs().max())}")
    table = torch.zeros((vocab, cut.d_model), dtype=g.dtype, device=dev)
    olds = []
    for _ in range(2):
        leaf = table.clone().requires_grad_()
        leaf[tokens].backward(g)
        olds.append(leaf.grad)
    torch.cuda.synchronize(dev)
    differ = int((olds[0] != olds[1]).sum())
    print(f"  (a) the gather's own backward (index_put_ accumulate) twice: {differ} of "
          f"{olds[0].numel()} elements of the embed gradient differ")
    del g, k1, k2, ref, table, olds, leaf
    torch.cuda.empty_cache()

    # every comm step's metrics and per-step timing, counts and device time
    metrics_log = []
    orig_unpack = step_kernels.unpack_adamw_out

    def recording_unpack(out, arch, reduced=False):
        res = orig_unpack(out, arch, reduced)
        metrics_log.append({k: float(v) for k, v in res[3].items()})
        return res

    class StepClock:
        """data_fn wrapper: a step runs from one data call to the next (or
        the run's end); each is synchronised and counted, and with
        ``profiled`` timed under torch.profiler."""

        def __init__(self, data_fn, profiled):
            self.data_fn, self.profiled = data_fn, profiled
            self.recs, self.prof, self.t0 = [], None, None

        def close(self):
            if self.t0 is None:
                return
            torch.cuda.synchronize(dev)
            rec = {"host_ms": (time.perf_counter() - self.t0) * 1e3}
            if self.prof is not None:
                self.prof.stop()
                rec["device_ms"] = device_seconds(self.prof) * 1e3
                rec["busy"] = rec["device_ms"] / rec["host_ms"]
            rec["launches"] = {k: v for k, v in _cuda.launch_counts().items() if v}
            self.recs.append(rec)
            self.prof = self.t0 = None

        def __call__(self, step):
            self.close()
            batch_ = self.data_fn(step)
            torch.cuda.synchronize(dev)
            _cuda.reset_launch_counts()
            if self.profiled:
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
            self.t0 = time.perf_counter()
            return batch_

    def run(platforms, steps, params=None, on_draw=None, profiled=False):
        """A comm-mode run over ``platforms`` from the seed's weights (or
        ``params``); ``on_draw(step)`` runs as each step's batch is drawn
        (the member-death drills).  Returns (state, history, step records,
        [(epoch, compiled graph) per capture], metrics, comm)."""
        comm = session.comm_split(list(platforms))
        tr = trainer.Trainer(model=model, hp=hp, comm=comm, arch=name, log_every=1)
        captures = []
        orig = tr._capture_comm_step

        def capture(*a):
            cg_, slots = orig(*a)
            captures.append((comm.epoch, cg_))
            return cg_, slots

        def data_fn(step):
            if on_draw is not None:
                on_draw(step)
            return data(step)

        tr._capture_comm_step = capture
        params = weights() if params is None else params
        state0 = trainer.TrainState(params, trainer.adamw_init(params))
        del params
        clock = StepClock(data_fn, profiled)
        n0 = len(metrics_log)
        state, hist = tr.run(state0, clock, steps)
        clock.close()
        comm.free()
        return state, hist, clock.recs, captures, metrics_log[n0:], comm

    step_kernels.unpack_adamw_out = recording_unpack
    try:
        # (b) member counts
        torch.cuda.reset_peak_memory_stats(dev)
        results = {}
        launches = collections.Counter()
        first_label = next(iter(tc["groups"]))
        for label, plats in tc["groups"].items():
            state, hist, recs, _, mets, _ = run(plats, tc["steps"], profiled=True)
            vecs = [step_kernels.flatten_params(t)
                    for t in (state.params, state.opt.mu, state.opt.nu)]
            del state
            expect = comm_structure(cut, len(plats), micro, plats)
            for i, rec in enumerate(recs):
                print(f"    {label} {list(plats)} step {i + 1}: loss {hist[i][1]:.6f}, "
                      f"lr {mets[i]['lr']:.2e}, grad norm {mets[i]['grad_norm']:.6f}, "
                      f"{rec['host_ms']:.1f} ms host{' (capture + compile)' if i == 0 else ''}"
                      f", {rec['device_ms']:.1f} ms device (busy {rec['busy']:.3f}); "
                      f"launches {rec['launches']}")
                got = rec["launches"]
                if set(plats) != {"hopper"}:       # the combines land anywhere
                    got = {k: v for k, v in got.items() if k not in ("ewise", "fused")}
                if got != expect:
                    fail(f"group {label} step {i + 1} launched {rec['launches']}, the "
                         f"structure gives {expect}")
                launches.update(rec["launches"])
            results[label] = (hist, vecs, recs, mets)
            if label != first_label:
                h0, v0 = results[first_label][:2]
                equal = [hist == h0] + [torch.equal(a, b) for a, b in zip(vecs, v0)]
                print(f"    {label}: history, params, mu, nu bit-identical to one "
                      f"member's: {equal}")
                if not all(equal):
                    fail(f"group {label} {list(plats)} differs from one member: {equal}")
                results[label] = (hist, None, recs, mets)
            del vecs
            torch.cuda.empty_cache()
        results[first_label] = results[first_label][:1] + (None,) + results[first_label][2:]
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"  (b) peak device memory {peak_gb:.2f} GB (reckoned "
              f"{need['gb']:.1f} GB for the widest group's step)")
        torch.cuda.empty_cache()

        # (c) a member's death (phase 3g's leg (e)): declared through the
        # session before step 2 (the reference's drill), then found by a
        # started monitor when the member wedges in step 2's first LM_GRAD
        _, ref_hist, *_ = run(("hopper",), tc["death_steps"])
        victim = tc["death"][1]
        res_launches = collections.Counter()
        replayed = []

        def declare(step):
            if step == 2 and not replayed:
                replayed.append(session.handle_dead_agent(session.agents[victim],
                                                          reason="chaos drill"))

        _, hist, recs, caps, _, comm = run(tc["death"], tc["death_steps"], on_draw=declare)
        for rec in recs:
            res_launches.update(rec["launches"])
        epochs = [e for e, _ in caps]
        print(f"  (c) {list(tc['death'])}: handle_dead_agent({victim}) before step 2 "
              f"replayed {replayed}: members now {list(comm.platforms)}, captures at "
              f"epochs {epochs}; {tc['death_steps']}-step history bit-identical to one "
              f"member's: {hist == ref_hist}")
        if replayed != [0] or not session.agents[victim].dead or comm.epoch == 0 \
                or epochs != [0, comm.epoch] or hist != ref_hist or victim in comm.platforms:
            fail("the member-death run did not recapture or differs from one member's")
        session.attach_agent(AtenAgent())        # an operator's re-registration
        mon = session.enable_health_monitor(config=HealthConfig(
            heartbeat_timeout=RESILIENCE["train_timeout"],
            poll_interval=RESILIENCE["poll"], straggler_multiple=0.0))
        with recovery_log(session) as rlog, \
                chaos(session, FaultPlan(platform=victim, mode="die", nth=10 ** 6,
                                         aliases=["LM_GRAD"])) as fa:
            def arm(step):                        # wedge at step 2's first LM_GRAD
                if step == 2:
                    fa.plan = dataclasses.replace(fa.plan, nth=fa.calls + 1)

            _, hist2, recs2, caps2, _, comm2 = run(tc["death"], tc["death_steps"],
                                                   on_draw=arm)
            detect = dead_after_ms(rlog, fa)
            state = mon.state(fa)
        mon.stop()
        for rec in recs2:
            res_launches.update(rec["launches"])
        epochs2 = [e for e, _ in caps2]
        attempts = [nd.attempts for nd in rlog["nodes"]]
        print(f"  (c) {list(tc['death'])} under a started monitor: {victim} wedged in its "
              f"LM_GRAD call {fa.plan.nth} ({fa.calls} calls, {fa.failures} failure), "
              f"{state} {detect:.1f} ms after its last beat; handle_dead_agent replayed "
              f"{rlog['replayed']}, attempts {attempts}; step 2 took "
              f"{recs2[2]['host_ms']:.1f} ms (step 3 {recs2[3]['host_ms']:.1f}); members "
              f"now {list(comm2.platforms)}, captures at epochs {epochs2}; history "
              f"bit-identical to one member's: {hist2 == ref_hist}; launches of both "
              f"death runs {dict(res_launches)}")
        if fa.failures != 1 or state != "dead" or rlog["replayed"] != [len(attempts)] \
                or not attempts or any(a_[-1] == victim for a_ in attempts) \
                or epochs2 != [0, comm2.epoch] or comm2.epoch == 0 or hist2 != ref_hist \
                or victim in comm2.platforms:
            fail("the monitored member death was not repaired bit-identically")
        del rlog

        # (d) step 1 against the single-device trainer with the same microbatches
        params = weights()
        p0 = step_kernels.flatten_params(params)
        c_state, c_hist, _, _, c_mets, _ = run(("hopper",), 1, params=params)
        c_delta = step_kernels.flatten_params(c_state.params) - p0
        del c_state
        single = {}
        orig_make = trainer.make_train_step

        def recording_make(model_, hp_):
            step_fn = orig_make(model_, hp_)

            def step_(state_, batch_):
                new, m = step_fn(state_, batch_)
                single.update({k: float(v) for k, v in m.items() if v.numel() == 1})
                return new, m
            return step_

        trainer.make_train_step = recording_make
        try:
            params = weights()
            s_state, s_hist = trainer.Trainer(model=model, hp=hp, log_every=1).run(
                trainer.TrainState(params, trainer.adamw_init(params)), data, 1)
        finally:
            trainer.make_train_step = orig_make
        del params
        s_delta = step_kernels.flatten_params(s_state.params) - p0
        del s_state, p0
        loss_err = abs(c_hist[0][1] - s_hist[0][1]) / abs(s_hist[0][1])
        gnorm_err = abs(c_mets[0]["grad_norm"] - single["grad_norm"]) / single["grad_norm"]
        upd_cos = cosine(c_delta, s_delta)
        del c_delta, s_delta
        print(f"  (d) step 1 in comm mode vs Trainer.run on one device ({micro} "
              f"microbatches): loss {c_hist[0][1]:.6f} vs {s_hist[0][1]:.6f}: "
              f"{loss_err:.2e} (tol {TRAIN_LOSS_TOL:g}); grad norm "
              f"{c_mets[0]['grad_norm']:.6f} vs {single['grad_norm']:.6f}: {gnorm_err:.2e} "
              f"(tol {TRAIN_GNORM_TOL:g}); the parameter updates' cosine {upd_cos:.6f} "
              f"(min {TRAIN_COS_MIN:g})")
        if loss_err > TRAIN_LOSS_TOL or gnorm_err > TRAIN_GNORM_TOL \
                or upd_cos < TRAIN_COS_MIN:
            fail("comm-mode step 1 disagrees with the single-device trainer")
        torch.cuda.empty_cache()

        # (e) a second run of one topology from the compiled-graph cache
        plats = tc["groups"]["2"]
        _, h_a, _, caps_a, _, _ = run(plats, tc["cache_steps"])
        cg = caps_a[0][1]
        before = dict(replays=cg.stats["replays"], hits=cg.stats["cache_hits"],
                      graphs=len(session._compiled_graphs))
        _, h_b, _, caps_b, _, _ = run(plats, tc["cache_steps"])
        after = dict(replays=cg.stats["replays"], hits=cg.stats["cache_hits"],
                     graphs=len(session._compiled_graphs))
        print(f"  (e) a second {tc['cache_steps']}-step run over {list(plats)}: the same "
              f"compiled graph {caps_b[0][1] is cg}, replays {before['replays']} -> "
              f"{after['replays']}, cache hits {before['hits']} -> {after['hits']}, "
              f"graphs cached {before['graphs']} -> {after['graphs']}; history equal "
              f"{h_a == h_b}, and equal to the first steps of (b) "
              f"{h_a == results['2'][0][:tc['cache_steps']]}")
        if caps_b[0][1] is not cg or after["replays"] != before["replays"] + tc["cache_steps"] \
                or after["hits"] != before["hits"] + 1 or after["graphs"] != before["graphs"] \
                or h_a != h_b or h_a != results["2"][0][:tc["cache_steps"]]:
            fail("the second run did not replay the cached graph or its history differs")
        quarantined = session.scheduler.failed_record_keys()
        if quarantined:
            fail(f"records were quarantined on the comm path: {quarantined}")
    finally:
        step_kernels.unpack_adamw_out = orig_unpack
        halo.finalize()
    torch.cuda.empty_cache()
    stats = {"arch": cut.name, "layers": layers, "of_layers": cfg.n_layers, "params": p,
             "reduced": f"depth {layers} of {cfg.n_layers} layers: a step's flat float32 "
                        f"vectors reckon {need_full['gb']:.1f} GB at full depth",
             "reckoned_gb": need["gb"], "peak_gb": peak_gb,
             "tokens_per_step": tc["batch"] * tc["seq_len"], "microbatches": micro,
             "groups": {label: {"history": r[0], "steps": r[2], "metrics": r[3]}
                        for label, r in results.items()},
             "embed_grad_bits": eq, "atomic_backward_differing": differ,
             "death_history": hist, "death_monitor": {"detect_ms": detect,
                                                      "step_ms": [r["host_ms"] for r in recs2],
                                                      "attempts": attempts},
             "resilience_launches": dict(res_launches), "step1": {"loss": [c_hist[0][1], s_hist[0][1]],
                                              "grad_norm": [c_mets[0]["grad_norm"],
                                                            single["grad_norm"]],
                                              "update_cosine": upd_cos}}
    return dict(launches), stats


def replay(model, params, prompt, toks, max_len, manifest, registry=None):
    """Logits (float32) of ``prompt``'s prefill and of one decode step per
    token of ``toks`` but the last, on a session with ``manifest`` (None:
    the default, which resolves to the kernels) and ``registry`` (None: the
    global one)."""
    dev = params["embed"].device
    out, _, _ = replay_inputs(model, params, {"tokens": torch.tensor([prompt], device=dev)},
                              [torch.tensor([[t]], device=dev) for t in toks[:-1]],
                              len(prompt), max_len, manifest, registry)
    return [x[0] for x in out]


# ---------------------------------------------------------------------------
# phase 3l: tuning — the launch plans swept on the card and taken through the
# normal entry points under a TuningDB (DESIGN.md §9)
# ---------------------------------------------------------------------------
#: the EW aliases' ops
EW_OPS = {"EWMM": "mul", "EWMD": "div", "EWADD": "add", "EWSUB": "sub"}


def tuned_bucket_check(dev, alias, rec, args, plans, sms) -> int:
    """(b): each plan of ``plans`` (``{}`` first) through the hopper row's
    fn against its plan model, and two calls bit-identical.  EW* and SORT
    bit-exact with their plan models, RMSNORM bit-exact with
    ``rmsnorm_plan_ref`` under the plan, a skinny MMM within TOL of
    ``mmm_splitk_ref`` at its split count, a wgmma one within TOL of
    ``mmm_ref``, both within half an ulp of the float32 product
    (``mmm_ulp_excess`` 0).  Returns the plans checked."""
    from repro_torch.kernels.ewise.ewise import ewise_plan
    from repro_torch.kernels.ewise.ref import OP_REFS as EW_REFS
    from repro_torch.kernels.ewise.ref import ewise_plan_ref
    from repro_torch.kernels.matmul.matmul import mmm_route
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.matmul.ref import mmm_ref, mmm_splitk_ref, mmm_ulp_excess
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plan_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_plan
    from repro_torch.kernels.sorthist.ref import sort_tile_ref
    from repro_torch.kernels.sorthist.sorthist import sort_tile_plan

    for plan in plans:
        out = rec.fn(*args, **plan)
        again = rec.fn(*args, **plan)
        torch.cuda.synchronize(dev)
        label = f"{alias} {'x'.join(map(str, args[0].shape))} {plan or '(default)'}"
        if not torch.equal(bits(out), bits(again)):
            fail(f"(b) {label}: two calls differ")
        if alias in EW_OPS:
            a, b = args
            model = ewise_plan_ref(a, b, EW_OPS[alias], ewise_plan(
                a.numel(), a.dtype, _cuda.aligned(a, b, out), sms, **plan))
            check_bits(f"(b) {label} vs its plan model", out, model)
            check_bits(f"(b) {label} vs plain", out, EW_REFS[EW_OPS[alias]](a, b))
        elif alias == "SORT":
            x, = args
            n = x.shape[-1]
            check_bits(f"(b) {label} vs its plan model", out,
                       sort_tile_ref(x, sort_tile_plan(x.numel() // n, n, sms, **plan)))
        elif alias == "RMSNORM":
            x, g = args
            d = x.shape[-1]
            check_bits(f"(b) {label} vs its plan model", out, rmsnorm_plan_ref(
                x, g, 1e-6, rmsnorm_plan(x.numel() // d, d, x.element_size(), sms,
                                         _cuda.aligned(x, g, out), **plan)))
        else:
            a, b = args
            route = plan.get("route", mmm_route(a.dtype, a.shape[0]))
            model = mmm_splitk_ref(a, b, splits=plan.get("splits")) if route == "skinny" \
                else mmm_ref(a, b)
            check_close(f"(b) {label} vs {'split-K model' if route == 'skinny' else 'plain'}",
                        normwise(out, model), a.dtype)
            excess = mmm_ulp_excess(out, a, b) if a.dtype != torch.float32 else 0
            if excess:
                fail(f"(b) {label}: {excess} elements past half an ulp of the float32 "
                     f"product")
        del out, again
    return len(plans)


def tuned_serve(dev, model, params, prompts, max_news, max_len, db_path):
    """Danube served through ``launch.serve.run_requests`` on a fresh
    ``halo.initialize()`` session with ``HALO_TUNING_DB`` at ``db_path``
    (unset for None): the recorded logits and tokens, launch counts,
    prefills and decode passes, T1 per dispatch and the median decode step
    by the host clock; then one decode step alone, every slot past its
    prompt, by the host clock (5 replays of the captured step) and by
    profiler device time, with T1 a dispatch of the two steps before them
    (the eager one and the capture)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import halo
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import run_requests
    from repro_torch.serve.engine import SlotEngine, StepScheduler

    if db_path is None:
        os.environ.pop("HALO_TUNING_DB", None)
    else:
        os.environ["HALO_TUNING_DB"] = str(db_path)
    session = halo.initialize()
    try:
        entries = len(session.scheduler.tuning)
        engine = recording_engine()(model, params, TUNE["slots"], max_len)
        sched = StepScheduler(engine, temperature=0.0, seed=TUNE["seed"])
        torch.cuda.synchronize(dev)
        _cuda.reset_launch_counts()
        session.reset_t1()
        results, _, wall = run_requests(sched, prompts, max_news)
        torch.cuda.synchronize(dev)
        launches = _cuda.launch_counts()
        out = {"entries": entries, "results": results, "records": engine.records,
               "launches": launches, "prefills": len(engine.prefill_s),
               "decodes": len(engine.decode_s), "wall_s": wall,
               "t1_us": session.t1_seconds_per_call * 1e6,
               "decode_step_ms": statistics.median(engine.decode_s) * 1e3}
        quarantined = session.scheduler.failed_record_keys()
        if quarantined:
            fail(f"(d) records were quarantined serving under {db_path}: {quarantined}")
        del engine, sched
        lone = SlotEngine(model, params, TUNE["slots"], max_len)
        tok = np.array([lone.prefill_into_slot(i, prompts[i % len(prompts)], None)
                        for i in range(TUNE["slots"])])
        pos = np.array([len(prompts[i % len(prompts)]) for i in range(TUNE["slots"])])
        act = np.ones(TUNE["slots"], bool)

        def steps(k):
            nonlocal tok, pos
            for _ in range(k):
                tok = lone.decode_step(tok, pos, act, None)
                pos = pos + 1
            torch.cuda.synchronize(dev)

        # the eager step and the capture dispatch; the timed replays do not
        session.reset_t1()
        steps(2)
        out["alone_t1_us"] = session.t1_seconds_per_call * 1e6
        t0 = time.perf_counter()
        steps(5)
        out["alone_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps(5)
        busy = device_seconds(prof)
        out["alone_device_ms"] = busy / 5 * 1e3 if busy > 0 else None
        del lone
    finally:
        halo.finalize()
    return out


def served_logits_agree(what: str, prompts, base, other) -> dict:
    """(d): each request's logits under a DB against the run with no DB, at
    every step whose inputs are the same — up to and including the first
    step at which the served tokens part (a bfloat16 argmax that the other
    plan's rounding flips), after which the runs' inputs differ.  Within
    SERVE_TOL normwise.  Returns the steps compared, the worst error and
    the steps at which tokens parted."""
    def by_prompt(run):
        return {tuple(r["prompt"]): r["logits"] for r in run["records"]}

    logits, base_logits = by_prompt(other), by_prompt(base)
    worst, compared, parted = 0.0, 0, []
    for i, p in enumerate(prompts):
        toks, base_toks = other["results"][i], base["results"][i]
        for j, (k, r) in enumerate(zip(logits[tuple(p)], base_logits[tuple(p)])):
            worst = max(worst, normwise(k, r))
            compared += 1
            if toks[j] != base_toks[j]:
                parted.append(j)
                break
    print(f"  (d) {what}: logits against the run with no DB at {compared} steps, worst "
          f"normwise {worst:.3e} (tol {SERVE_TOL:g}); served tokens parted at steps "
          f"{parted or 'none'}")
    if not worst <= SERVE_TOL:
        fail(f"(d) {what}: served logits differ from the run with no DB by {worst:.3e}")
    return {"steps_compared": compared, "worst_err": worst, "tokens_parted_at": parted}


def phase3l(dev, card):
    """Tuning (DESIGN.md §9; ROADMAP A5) on the card: (a) ``launch.tune``'s
    sweep over its SHAPES into a temporary DB, each bucket's default and
    tuned µs and gain printed with the card, every bucket timing 1 +
    len(variants) plans (none dropped); (b) every plan of every bucket
    against its plan model (``tuned_bucket_check``); (c) with no DB every
    swept shape dispatches with the wrapper's own plan (no kwargs merged,
    one launch on the default route), with the swept DB with the entry's
    plan; (d) danube at full width served with no DB, with a seeded entry
    (the decode k/v projections' bucket onto the wgmma route: the skinny
    and wgmma counters move by 2 × layers a decode pass) and with the
    swept DB, logits against the run with no DB, decode-step host and
    device ms and T1 beside each other; (e) the template under the swept DB
    (EW* and SORT bit-identical to no DB, the rest within TOL); (f) a
    worker spawned under the seeded DB: MMM and RMSNORM at seeded buckets
    through ``hopper@w0`` torch.equal to in-process; (g) phase 3c's decode
    chain under the swept DB (with a seeded RMSNORM plan at the chain's
    bucket) replayed bit-identical to serial dispatch.  The DB files live
    in a temporary directory removed at the end; ``HALO_TUNING_DB`` is
    unset before and after.  Returns (launches of (d)'s DB runs, stats)."""
    import shutil
    import tempfile

    from repro_torch import halo, quickstart
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import abstract_signature
    from repro_torch.core.tuning import TuneEntry, TuningDB
    from repro_torch.distributed.remote import spawn_worker
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.matmul.matmul import mmm_route
    from repro_torch.launch import tune
    from repro_torch.models import build_model

    if os.environ.get("HALO_TUNING_DB"):
        fail("HALO_TUNING_DB is set before phase 3l: every other phase runs with no DB")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tmp = Path(tempfile.mkdtemp(prefix="halo_tune_"))
    stats, workers = {"card": card}, []
    try:
        # (a) the sweep
        swept_path = tmp / "swept.json"
        db = TuningDB(swept_path)
        t0 = time.perf_counter()
        results = tune.sweep(db, sorted(tune.SHAPES), repeats=TUNE["repeats"],
                             warmup=TUNE["warmup"], verbose=False, device=dev,
                             seed=TUNE["seed"])
        stats["sweep_s"] = time.perf_counter() - t0
        db.save()
        buckets = [(alias, i, build) for alias in sorted(tune.SHAPES)
                   for i, build in enumerate(tune.SHAPES[alias])]
        if len(results) != len(buckets) or any(
                r.record.alias != alias or not r.swept
                for r, (alias, _, _) in zip(results, buckets)):
            fail(f"(a) the sweep visited {[(r.record.alias, r.swept) for r in results]}, "
                 f"not one swept bucket each of {[(a, i) for a, i, _ in buckets]}")
        print(f"  (a) {len(results)} buckets swept in {stats['sweep_s']:.1f} s "
              f"(repeats {TUNE['repeats']}, warm-up {TUNE['warmup']}) on {card}:")
        rows, plans_checked, inputs = [], 0, []
        for res, (alias, i, build) in zip(results, buckets):
            args = build(dev, TUNE["seed"] + 2 * i)
            inputs.append(args)
            variants = res.record.variants(*args)
            timed = [c for c, _ in res.timings]
            if timed != [{}] + variants:
                fail(f"(a) {res.key}: timed {timed}, not the default and every variant "
                     f"{variants}: a variant raised on the card")
            default_us = res.timings[0][1] * 1e6
            row = {"key": res.key, "default_us": default_us,
                   "tuned_us": res.entry.seconds * 1e6, "gain": res.entry.speedup,
                   "config": res.entry.config,
                   "timings_us": [[c, s * 1e6] for c, s in res.timings]}
            rows.append(row)
            print(f"    {res.key}: default {default_us:.1f} us, tuned "
                  f"{row['tuned_us']:.1f} us, gain {row['gain']:.3f}x -> "
                  f"{res.entry.config or '(default)'}; every plan: " + ", ".join(
                      f"{c or 'default'} {s * 1e6:.1f}" for c, s in res.timings))
            # (b) every plan against its plan model
            plans_checked += tuned_bucket_check(dev, alias, res.record, args,
                                                [{}] + variants, sms)
        print(f"  (b) {plans_checked} plans over {len(results)} buckets against their "
              f"plan models (EW*, SORT, RMSNORM bit-exact; MMM within TOL and half an "
              f"ulp), two calls of each bit-identical")
        stats["sweep"] = rows

        # the seeded DB of (d) and (f), and the swept DB with the chain's plan
        cfg = get_config(SERVE["arch"])
        records = {res.record.alias: res.record for res in results}
        mmm_rec, norm_rec = records["MMM"], records["RMSNORM"]
        bf16 = torch.bfloat16

        def key_of(rec, *shapes):
            return db.key_for(rec, abstract_signature(
                [torch.empty(s, dtype=bf16, device="meta") for s in shapes]))

        kv = (cfg.d_model, cfg.stages[0].pattern[0].attn.n_kv_heads
              * cfg.stages[0].pattern[0].attn.head_dim)
        seeded_path = tmp / "seeded.json"
        seeded = TuningDB(seeded_path)
        seed_keys = {"kv": key_of(mmm_rec, (TUNE["slots"], kv[0]), kv),
                     "norm": key_of(norm_rec, (TUNE["worker_rows"], cfg.d_model),
                                    (cfg.d_model,))}
        seeded.put(seed_keys["kv"], TuneEntry(config=dict(TUNE["kv_plan"]), seconds=1e-6,
                                              default_seconds=1e-6, source="seed"))
        seeded.put(seed_keys["norm"], TuneEntry(config=dict(TUNE["norm_plan"]),
                                                seconds=1e-6, default_seconds=1e-6,
                                                source="seed"))
        seeded.save()
        chain_key = key_of(norm_rec, (GRAPH["decode_d"],), (GRAPH["decode_d"],))
        db.put(chain_key, TuneEntry(config=dict(TUNE["norm_plan"]), seconds=1e-6,
                                    default_seconds=1e-6, source="seed"))
        db.save()
        print(f"  seeded DB: {seed_keys['kv']} -> {TUNE['kv_plan']}, {seed_keys['norm']} "
              f"-> {TUNE['norm_plan']}; swept DB + {chain_key} -> {TUNE['norm_plan']}")

        # (c) no DB: every swept shape with the wrapper's own plan; the swept
        # DB: the entry's plan
        pin = {"allowed_platforms": ["hopper"]}
        for db_path in (None, swept_path):
            if db_path is None:
                os.environ.pop("HALO_TUNING_DB", None)
            else:
                os.environ["HALO_TUNING_DB"] = str(db_path)
            session = halo.initialize()
            try:
                n_entries = len(session.scheduler.tuning)
                if (db_path is None) != (n_entries == 0):
                    fail(f"(c) the session under {db_path} holds {n_entries} entries")
                moved = 0
                for res, (alias, _, _), args in zip(results, buckets, inputs):
                    merged = session._tuned_kwargs(res.record, args, {})
                    want = {} if db_path is None else res.entry.config
                    if merged != want:
                        fail(f"(c) {res.key} under {db_path}: merged plan {merged}, not {want}")
                    moved += bool(merged)
                    torch.cuda.synchronize(dev)
                    _cuda.reset_launch_counts()
                    out = session.dispatch(alias, *args, overrides=pin)
                    torch.cuda.synchronize(dev)
                    counts = {k: v for k, v in _cuda.launch_counts().items() if v}
                    route = merged.get("route", mmm_route(args[0].dtype, args[0].shape[0])) \
                        if alias == "MMM" else None
                    kname = {"MMM": f"mmm_{route}", "SORT": "sort",
                             "RMSNORM": "rmsnorm"}.get(alias, "ewise")
                    if counts != {kname: 1}:
                        fail(f"(c) {res.key} under {db_path}: launches {counts}, not one "
                             f"{kname}")
                    if not torch.equal(bits(out), bits(res.record.fn(*args, **want))):
                        fail(f"(c) {res.key} under {db_path}: dispatch differs from the "
                             f"row at plan {want or '(default)'}")
                    del out
            finally:
                halo.finalize()
            print(f"  (c) {'no DB' if db_path is None else 'swept DB'}: "
                  f"{len(results)} swept shapes dispatched on one launch each, "
                  f"{moved} with a merged plan, bits equal to the row at "
                  f"{'its default plan' if db_path is None else 'the entry plan'}")
        os.environ.pop("HALO_TUNING_DB", None)
        del inputs

        # (d) danube served with no DB, the seeded DB and the swept DB
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(TUNE["seed"])
        params = model.init(gen)
        prompts = [torch.randint(0, cfg.vocab_size, (TUNE["prompt_len"],), generator=gen,
                                 device=dev).tolist() for _ in range(TUNE["requests"])]
        max_news = [TUNE["max_new"]] * TUNE["requests"]
        max_len = TUNE["prompt_len"] + TUNE["max_new"] + 8
        # warm-up, before any count
        tuned_serve(dev, model, params, [p[:64] for p in prompts], [2] * len(prompts),
                    max_len, None)
        runs = {name: tuned_serve(dev, model, params, prompts, max_news, max_len, path)
                for name, path in (("no_db", None), ("seeded", seeded_path),
                                   ("swept", swept_path))}
        # the decode pass's projections in the seeded bucket: k and v, 2 a
        # layer (48 on danube: q and o, 2560 × 2560, bucket apart)
        layers = cfg.n_layers
        moved = sum(n_ for (k_, n_out), n_ in decode_projections(cfg).items()
                    if key_of(mmm_rec, (TUNE["slots"], k_), (k_, n_out)) == seed_keys["kv"])
        print(f"  (d) {moved} MMMs a decode pass lie in the seeded bucket {seed_keys['kv']}")
        tune_launches = collections.Counter()
        for name, r in runs.items():
            per_decode = moved if name == "seeded" else 0
            want = {k: 0 for k in r["launches"]}
            want.update(mmm_wgmma=7 * layers * r["prefills"] + per_decode * r["decodes"],
                        mmm_skinny=(7 * layers + 1) * r["decodes"] + r["prefills"]
                        - per_decode * r["decodes"],
                        rmsnorm=(2 * layers + 1) * (r["prefills"] + r["decodes"]),
                        flash_attention_mma=layers * r["prefills"])
            got = {k: v for k, v in r["launches"].items() if v}
            print(f"  (d) {name} ({r['entries']} entries): {r['prefills']} prefills + "
                  f"{r['decodes']} decode passes, launches {got}")
            if name != "swept" and r["launches"] != want:
                fail(f"(d) {name}: launches {got} != {want}: the seeded plan moved "
                     f"{moved} k/v projections a decode pass onto the wgmma route only "
                     f"if these agree")
            if [len(x) for x in r["results"]] != max_news:
                fail(f"(d) {name}: served {[len(x) for x in r['results']]} tokens")
            if name != "no_db":
                tune_launches.update(r["launches"])
                r["agreement"] = served_logits_agree(name, prompts, runs["no_db"], r)
        for name, r in runs.items():
            print(f"  (d) {name}: decode step median {r['decode_step_ms']:.3f} ms (host "
                  f"clock, served), alone {r['alone_host_ms']:.3f} ms host / "
                  + (f"{r['alone_device_ms']:.3f} ms device" if r["alone_device_ms"]
                     else "device not measured")
                  + f"; T1 {r['t1_us']:.2f} us a dispatch served, {r['alone_t1_us']:.2f} "
                  f"us alone; wall {r['wall_s'] * 1e3:.1f} ms on {card}")
        stats["serve"] = {name: {k: v for k, v in r.items() if k not in ("records",
                                                                          "results")}
                          for name, r in runs.items()}
        del runs, params, model
        torch.cuda.empty_cache()

        # (e) the template under the swept DB
        jobs = quickstart.make_jobs(SIZES, dev, seed=0)
        outs = {}
        for db_path in (None, swept_path):
            if db_path is None:
                os.environ.pop("HALO_TUNING_DB", None)
            else:
                os.environ["HALO_TUNING_DB"] = str(db_path)
            halo.initialize()
            try:
                torch.cuda.synchronize(dev)
                _cuda.reset_launch_counts()
                outs[db_path] = quickstart.run(jobs, overrides=PIN)
                torch.cuda.synchronize(dev)
                outs[db_path, "launches"] = _cuda.launch_counts()
            finally:
                halo.finalize()
        os.environ.pop("HALO_TUNING_DB", None)
        if outs[None, "launches"] != outs[swept_path, "launches"]:
            fail(f"(e) template launches {outs[swept_path, 'launches']} under the swept DB, "
                 f"{outs[None, 'launches']} with none")
        worst = 0.0
        for mode in (0, 1):
            for alias in jobs:
                a, b = outs[None][mode][alias], outs[swept_path][mode][alias]
                if alias in EW_OPS or alias == "SORT":
                    check_bits(f"(e) {alias} under the swept DB vs no DB", b, a)
                else:
                    err = normwise(b, a)
                    worst = max(worst, err)
                    check_close(f"(e) {alias} under the swept DB vs no DB", err,
                                torch.float32)
        print(f"  (e) template (sync + async) under the swept DB: EW* and SORT "
              f"bit-identical to no DB, the rest within {worst:.2e} (TOL "
              f"{TOL[torch.float32]:g}); launches equal to no DB's "
              f"{ {k: v for k, v in outs[None, 'launches'].items() if v} }")
        stats["template_worst"] = worst
        del jobs, outs

        # (f) one process boundary under the seeded DB
        os.environ["HALO_TUNING_DB"] = str(seeded_path)
        session = halo.initialize()
        try:
            w = spawn_worker("w0", device="cuda", timeout=MULTIPROC["hello_timeout"])
            workers.append(w)
            agent = w.agent("hopper").attach(session)
            g2 = torch.Generator(device=dev).manual_seed(TUNE["seed"] + 1)
            cases = {
                "MMM": (torch.randn((TUNE["slots"], kv[0]), generator=g2, device=dev).to(bf16),
                        (torch.randn(kv, generator=g2, device=dev) * kv[0] ** -0.5).to(bf16)),
                "RMSNORM": (torch.randn((TUNE["worker_rows"], cfg.d_model), generator=g2,
                                        device=dev).to(bf16),
                            (torch.randn((cfg.d_model,), generator=g2, device=dev) * 0.1
                             + 1.0).to(bf16))}
            timeout = MULTIPROC["timeout"]
            for alias, args in cases.items():
                rec = mmm_rec if alias == "MMM" else norm_rec
                plan = session._tuned_kwargs(rec, args, {})
                want = TUNE["kv_plan"] if alias == "MMM" else TUNE["norm_plan"]
                if plan != want:
                    fail(f"(f) {alias}: the host merges {plan}, not the seeded {want}")
                torch.cuda.synchronize(dev)
                _cuda.reset_launch_counts()
                local = session.isend(args, session.claim(alias, overrides={
                    "allowed_platforms": ["hopper"]}), mailbox=False).result(timeout)
                torch.cuda.synchronize(dev)
                here = {k: v for k, v in _cuda.launch_counts().items() if v}
                before = w.heartbeat(timeout)["launches"]
                remote = session.isend(args, session.claim(alias, overrides={
                    "allowed_platforms": [agent.platform]}), mailbox=False).result(timeout)
                after = w.heartbeat(timeout)["launches"]
                there = {k: v - before.get(k, 0) for k, v in after.items()
                         if v - before.get(k, 0)}
                default = rec.fn(*args)
                torch.cuda.synchronize(dev)
                moved_bits = not torch.equal(bits(local), bits(default))
                print(f"  (f) {alias} {'x'.join(map(str, args[0].shape))} at its seeded "
                      f"plan {want}: in process {here}, on {agent.platform} {there}; "
                      f"torch.equal {torch.equal(remote, local)}; the plan moved the bits "
                      f"off the default plan's: {moved_bits}")
                if not torch.equal(remote, local) or there != here:
                    fail(f"(f) {alias} on {agent.platform} differs from in-process under "
                         f"the seeded DB ({there} vs {here})")
                if alias == "MMM" and here != {"mmm_wgmma": 1}:
                    fail(f"(f) the seeded MMM launched {here}, not one mmm_wgmma")
        finally:
            for w in workers:
                if not w.dead:
                    w.shutdown(timeout=60)
                w.kill()
                if w.proc is not None:
                    w.proc.wait(timeout=60)
            halo.finalize()
            os.environ.pop("HALO_TUNING_DB", None)

        # (g) phase 3c's decode chain replayed under the swept DB
        gen3 = torch.Generator(device=dev).manual_seed(3)
        d, chain_layers = GRAPH["decode_d"], GRAPH["decode_layers"]

        def rnd(*shape, shift=0.0, scale=1.0):
            return (torch.randn(shape, generator=gen3, device=dev) * scale + shift).to(bf16)

        w_dec = {"W": [rnd(d, d, scale=d ** -0.5) for _ in range(chain_layers)],
                 "bias": [rnd(d, scale=0.1) for _ in range(chain_layers)],
                 "gamma": rnd(d, shift=1.0, scale=0.1), "x": rnd(d)}
        # the hopper RMSNORM row's function notes the plan each call gets
        norm_plans = []

        def note_plan(rec):
            if rec.alias != "RMSNORM" or rec.platform != "hopper":
                return None
            fn = rec.fn

            def noted(*args, **kw):
                norm_plans.append({k: v for k, v in kw.items() if k != "eps"})
                return fn(*args, **kw)
            return noted

        serial_out, noted = {}, {}
        for db_path in (None, swept_path):
            if db_path is None:
                os.environ.pop("HALO_TUNING_DB", None)
            else:
                os.environ["HALO_TUNING_DB"] = str(db_path)
            halo.initialize(registry=wrapped_registry(note_plan))
            norm_plans.clear()
            try:
                crs = {}
                decode_program(lambda al, p: crs.setdefault(al, halo.claim(al, overrides=PIN)),
                               w_dec)

                def send(al, p):
                    halo.send(p, crs[al])
                    return halo.recv(crs[al])

                serial_out[db_path] = decode_program(send, w_dec)[0]
                noted[db_path, "serial"] = list(norm_plans)
                if db_path is None:
                    continue
                with halo.graph(launch=False) as g:
                    decode_program(lambda al, p: halo.isend(p, crs[al]), w_dec)
                cg = g.compile()
                if cg.stats["fused_nodes"] != 1:
                    fail(f"(g) the decode chain compiled to {cg.stats}")
                torch.cuda.synchronize(dev)
                _cuda.reset_launch_counts()
                norm_plans.clear()
                for i in range(TUNE["replays"]):
                    out = cg.replay(timeout=600)[0]
                    torch.cuda.synchronize(dev)
                    if not torch.equal(bits(out), bits(serial_out[db_path])):
                        fail(f"(g) replay {i} under the swept DB differs from serial "
                             f"dispatch under it")
                counts = {k: v for k, v in _cuda.launch_counts().items() if v}
                noted[db_path, "replay"] = list(norm_plans)
            finally:
                halo.finalize()
        os.environ.pop("HALO_TUNING_DB", None)
        want = {k: v * TUNE["replays"] for k, v in
                {"mvm": chain_layers, "ewise": chain_layers, "rmsnorm": chain_layers}.items()}
        plan = dict(TUNE["norm_plan"])
        want_noted = {(None, "serial"): [{}] * chain_layers,
                      (swept_path, "serial"): [plan] * chain_layers,
                      (swept_path, "replay"): [plan] * chain_layers * TUNE["replays"]}
        moved_bits = not torch.equal(bits(serial_out[None]), bits(serial_out[swept_path]))
        print(f"  (g) decode chain ({3 * chain_layers} nodes, one call loop) under the swept "
              f"DB: {TUNE['replays']} replays bit-identical to serial dispatch under it; "
              f"launches {counts}; RMSNORM ran at {plan} in every serial call and every "
              f"replayed member: {noted == want_noted}; the plan moved serial dispatch's "
              f"bits off the run with no DB: {moved_bits}")
        if counts != want:
            fail(f"(g) replay launches {counts} != {want}")
        if noted != want_noted:
            fail(f"(g) RMSNORM's plans {noted} != {want_noted}: a member did not run at "
                 f"the plan serial dispatch gives it")
        stats["chain_moved_bits"] = moved_bits
    finally:
        os.environ.pop("HALO_TUNING_DB", None)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    alive = [w.name for w in workers if w.proc is None or w.proc.poll() is None]
    if alive:
        fail(f"(f) workers {alive} are still alive")
    return dict(tune_launches), stats


# ---------------------------------------------------------------------------
# phase 4: times at the phase-3 shapes
# ---------------------------------------------------------------------------
#: phase 4: FLASH_ATTN on its wgmma route in the 16-bit types, causal:
#: (heads, KV heads, type, window, head dim, tokens) of gemma-7b's prefill
#: and gemma3-4b's local layers at 4096 tokens, and of deepseek-v2's MLA
#: prefill at the served 2048 (head dim 192, padded to 256)
FA_D256 = {"gemma7b_bfloat16": (16, 16, torch.bfloat16, None, 256, 4096),
           "gemma3_4b_bfloat16": (8, 4, torch.bfloat16, 1024, 256, 4096),
           "gemma7b_float16": (16, 16, torch.float16, None, 256, 4096),
           "deepseek_v2_mla_bfloat16": (128, 128, torch.bfloat16, None, 192, 2048)}


def fa_d256_rows(dev, bw, peak, events_ms):
    """FA_D256's rows through ``flash_attention_hopper``, by the route the
    package gives each (named in each row, so the function also times an
    older tree's route there when imported beside that tree's package):
    device time per call of the kernel, the plain version and SDPA, event
    times beside (``events_ms``), checked against the plain version
    (``TOL``), the route under "fa_route", bound from the mask's visible
    pairs (4·d operations each at the real head dim d) at the 16-bit
    tensor-core peak ``peak`` or q, k, v and o over ``bw``."""
    from repro_torch.kernels.flash_attention.flash_attention import (fa_route,
                                                                     flash_attention_hopper)
    from repro_torch.kernels.flash_attention.ref import (attention_aten, attention_ref,
                                                         visibility)

    rows = {}
    for key, (heads, kv_heads, dt, window, d, seq) in FA_D256.items():
        g = torch.Generator(device=dev).manual_seed(6)
        shape = (1, heads, seq, d)
        q = torch.randn(shape, generator=g, device=dev).to(dt)
        k = torch.randn((1, kv_heads, seq, d), generator=g, device=dev).to(dt)
        v = (torch.randn((1, kv_heads, seq, d), generator=g, device=dev) + 1.0).to(dt)
        kw = dict(causal=True, window=window, prefix_len=0)
        pairs = int(visibility(seq, seq, device=dev, **kw).sum()) * heads
        flops = 4 * d * pairs
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        t_bytes, t_ops = nbytes / bw, flops / peak
        out, want = flash_attention_hopper(q, k, v, **kw), attention_ref(q, k, v, **kw)
        route = fa_route(dt, d)
        check_close(f"FLASH_ATTN {route} {shape} {dt} window {window} vs plain",
                    normwise(out, want), dt)
        fns = {"ms": lambda: flash_attention_hopper(q, k, v, **kw),
               "plain_ms": lambda: attention_ref(q, k, v, **kw),
               "library_ms": lambda: attention_aten(q, k, v, **kw)}
        row = {name: median_device_ms(fn, dev) for name, fn in fns.items()}
        row["event_ms"] = {name: events_ms(fn) for name, fn in fns.items()}
        row.update(fa_route=route, max_abs_err=float((wide(out) - wide(want)).abs().max()),
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   visible_pairs=pairs, tflops=flops / (row["ms"] * 1e-3) / 1e12,
                   shape=f"1x{heads}x{seq}x{d} {str(dt).split('.')[-1]}, {kv_heads} "
                         f"KV heads, causal, window {window}")
        del q, k, v, out, want
        print(f"  flash_attention {route} {row['shape']}: kernel_ms {row['ms']:.4f}  SDPA "
              f"{row['library_ms']:.4f}  plain_ms {row['plain_ms']:.4f}  bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']}: {pairs} visible pairs)  "
              f"{row['tflops']:.1f} TFLOP/s; events kernel {row['event_ms']['ms']:.4f}  "
              f"SDPA {row['event_ms']['library_ms']:.4f}")
        rows[key] = row
    return rows


def phase4(dev, jobs, launches, max_abs, e2e, card_name, serve_launches,
           graph_launches, path_launches):
    from repro_torch.configs import get_config
    from repro_torch.core.portability import KernelReport, time_fn
    from repro_torch.kernels.conv1d.conv1d import conv1d_hopper
    from repro_torch.kernels.conv1d.ref import conv1d_aten, conv1d_ref
    from repro_torch.kernels.ewise.ewise import OPS as EW_OPS
    from repro_torch.kernels.ewise.ewise import THREADS as EW_THREADS
    from repro_torch.kernels.ewise.ewise import ewise_hopper, ewise_plan
    from repro_torch.kernels.ewise.ref import OP_ATEN
    from repro_torch.kernels.ewise.ref import OP_REFS as EW_REFS
    from repro_torch.kernels.fft.fft import fft_chirp_hopper, fft_radix_hopper
    from repro_torch.kernels.fft.ops import cached_chirp_tables, cached_radix_twiddles
    from repro_torch.kernels.fft.ref import (chirp_length, fft_aten, fft_chirp_ref,
                                             fft_radix_ref)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_mma_hopper, flash_attention_tf32x3_hopper)
    from repro_torch.kernels.flash_attention.ref import (attention_aten, attention_f64,
                                                         attention_ref, visibility)
    from repro_torch.kernels.fused import ewise_chain_hopper, ewise_chain_ref
    from repro_torch.kernels.jacobi.jacobi import jacobi_hopper
    from repro_torch.kernels.jacobi.ref import jacobi_step_aten, jacobi_step_ref
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.matmul.matmul import (SKINNY_M_MAX, mmm_skinny_hopper,
                                                   mmm_tf32x3_hopper, mmm_wgmma_hopper,
                                                   wgmma_tile_n)
    from repro_torch.kernels.matmul.ref import mmm_aten, mmm_ref
    from repro_torch.kernels.mvm.mvm import mvm_hopper
    from repro_torch.kernels.mvm.ref import mvm_aten, mvm_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_aten, rmsnorm_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_hopper, rmsnorm_plan
    from repro_torch.kernels.sorthist.ref import (hist_ref, radix_passes, sort_keys,
                                                  sort_ref)
    from repro_torch.kernels.sorthist.sorthist import (SORT_TILE, hist_hopper,
                                                       sort_radix_hopper, sort_tile_hopper)
    from repro_torch.kernels.spmm.ref import bell_to_dense, smmm_aten, smmm_bell_ref
    from repro_torch.kernels.spmm.spmm import smmm_hopper
    from repro_torch.kernels.vdp.ref import vdp_aten, vdp_ref
    from repro_torch.kernels.vdp.vdp import vdp_hopper

    spec, (bw, f32_peak, bf16_peak) = peaks(card_name)
    tf32_peak = TF32_PEAKS[spec]
    print(f"  bounds from the {spec} data sheet: {bw / 1e12} TB/s, "
          f"{f32_peak / 1e12} TFLOP/s float32 (all phase-3 inputs are float32), "
          f"{bf16_peak / 1e12} TFLOP/s bfloat16 tensor cores (RMSNORM, FLASH_ATTN), "
          f"{tf32_peak / 1e12} TFLOP/s TF32 tensor cores (MMM's 3×TF32 route)")

    def ms(fn, *args):
        return time_fn(fn, *args, device=dev, warmup=3,
                       iters=TIMED_RUNS).median_s * 1e3

    def device_ms(fn):
        return median_device_ms(fn, dev)

    def model_row(kernel, plain, library):
        """Device times of a kernel, its plain version and its library call,
        with the CUDA-event times beside them."""
        fns = {"ms": kernel, "plain_ms": plain, "library_ms": library}
        row = {k: device_ms(f) for k, f in fns.items()}
        row["event_ms"] = {k: ms(f) for k, f in fns.items()}
        return row

    def bound(nbytes, flops, peak=f32_peak):
        t_bytes, t_ops = nbytes / bw, flops / peak
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    a, b = jobs["MMM"]
    m, k = a.shape
    n = b.shape[1]
    # the function's bound on the float32 CUDA cores, and at the card's
    # fastest rate for float32 operands (TF32 tensor cores), the 3×TF32
    # route's; its algorithm floor, three products at that rate, apart
    mmm_bound = bound(4 * (m * k + k * n + m * n), 2 * m * n * k)
    tf32_bound = bound(4 * (m * k + k * n + m * n), 2 * m * n * k, tf32_peak)
    tf32_floor_ms = 3 * 2 * m * n * k / tf32_peak * 1e3
    # phase 3's lone request on the 3×TF32 route: K = 4094 off TMA's stride
    gen9 = torch.Generator(device=dev).manual_seed(9)
    lm, lk, ln = LONE_MMM
    la = torch.randn((lm, lk), generator=gen9, device=dev)
    lb = torch.randn((lk, ln), generator=gen9, device=dev)
    ea, eb = jobs["EWMM"]
    ne = ea.numel()
    ew_bound = bound(4 * 3 * ne, ne)
    ma, mx = jobs["MVM"]
    mm, mk = ma.shape
    mvm_bound = bound(4 * (mm * mk + mk + mm), 2 * mm * mk)
    vx, vy = jobs["VDP"]
    nv = vx.numel()
    vdp_bound = bound(4 * (2 * nv + 1), 2 * nv)
    ja, jx, jb = jobs["JS"]
    nj = ja.shape[0]
    js_bound = bound(4 * (nj * nj + 3 * nj), 2 * nj * nj)
    cx, cw = jobs["1DCONV"]
    nc, kc = cx.numel(), cw.numel()
    lc = nc - kc + 1
    conv_bound = bound(4 * (nc + kc + lc), 2 * kc * lc)
    sv, si, sb = jobs["SMMM"]
    nrows, snnz, bm, bk = sv.shape
    ks, ns = sb.shape
    # the work this run's sparsity pattern needs: its non-pad slots only,
    # counted on the host before any timing
    kept = int((si >= 0).sum())
    spmm_bytes = 4 * (kept * bm * bk + ks * ns + nrows * bm * ns) + si.numel() * si.element_size()
    # at the card's fastest rate for float32 operands (TF32 tensor cores),
    # the kernel's; on the float32 CUDA cores and the three products' floor
    # apart
    spmm_bound = bound(spmm_bytes, 2 * kept * bm * bk * ns, tf32_peak)
    spmm_bound_f32 = bound(spmm_bytes, 2 * kept * bm * bk * ns)
    spmm_floor_ms = 3 * 2 * kept * bm * bk * ns / tf32_peak * 1e3
    # library yardstick: one dense cuBLAS product of the densified A (built
    # outside the timing); no single PyTorch call computes blocked-ELL @ B
    sa_dense = bell_to_dense(sv, si, ks)
    spmm_aten_ms = ms(smmm_aten, sv, si, sb)
    print(f"  spmm: {kept} of {nrows * snnz} slots kept (S = {snnz}); "
          f"smmm_aten (per-slot baddbmm) {spmm_aten_ms:.4f} ms")
    fx, = jobs["FFT"]
    f_m, f_n = fx.shape

    def fft_bound_of(m_, n_):
        """The transform's own work: x read once, complex64 written once,
        and the 5/2·n·log2(n) operations of a real-input FFT per row."""
        return bound(4 * m_ * n_ + 8 * m_ * n_, 2.5 * m_ * n_ * math.log2(n_))

    fft_bound = fft_bound_of(f_m, f_n)
    dx = torch.randn((f_m, DFT_N), generator=torch.Generator(device=dev).manual_seed(6),
                     device=dev)
    chirp_bound = fft_bound_of(f_m, DFT_N)
    # the tables' first-call builds, timed apart from the kernels
    for what, cache, n_ in (("radix table", cached_radix_twiddles, f_n),
                            ("chirp tables", cached_chirp_tables, DFT_N)):
        cache.cache_clear()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cache(n_, dev)
        torch.cuda.synchronize(dev)
        print(f"  fft table build, {what} (first call, n={n_}, host clock): "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    ftw = cached_radix_twiddles(f_n, dev)
    ctab = cached_chirp_tables(DFT_N, dev)
    # the chirp route over phase 2's lengths at f_m rows, by device time,
    # beside cuFFT
    chirp_sweep = {}
    gen6 = torch.Generator(device=dev).manual_seed(6)
    for n_ in CHIRP_N:
        x_ = torch.randn((f_m, n_), generator=gen6, device=dev)
        t_ = cached_chirp_tables(n_, dev)
        chirp_sweep[str(n_)] = {"L": chirp_length(n_),
                                "ms": device_ms(lambda: fft_chirp_hopper(x_, t_)),
                                "library_ms": device_ms(lambda: fft_aten(x_)),
                                "bound_ms": fft_bound_of(f_m, n_)[0]}
    del x_
    print(f"  fft chirp route at {f_m} rows, device ms (n (L): kernel / cuFFT / bound): "
          + "; ".join(f"{n_} ({t['L']}): {t['ms']:.4f} / {t['library_ms']:.4f} / "
                      f"{t['bound_ms']:.4f}" for n_, t in chirp_sweep.items()))
    sx, = jobs["SORT"]
    n_sort = sx.numel()
    # bytes: one read, one write; operations: the n·log2(n) comparisons no
    # comparison sort can do without (the bytes bound it all the same, and
    # no comparison sort reaches that bound)
    sort_bound = bound(4 * 2 * n_sort, n_sort * max(1, (n_sort - 1).bit_length()))
    # a model of the radix route's own traffic on this input, printed beside
    # the bound and not measured: one counting read of x, the first pass's
    # read and write, and a counting read, a read and a write for every
    # later pass (tile counts aside), with the passes the plain model plans
    n_passes = len(radix_passes(sort_keys(sx))) or 1
    radix_bytes = 4 * n_sort * (3 + 3 * (n_passes - 1))
    print(f"  sort radix route (model): {n_passes} digit passes at n={n_sort} float32, "
          f"{radix_bytes / 1e6:.1f} MB of key traffic "
          f"({radix_bytes / bw * 1e3:.4f} ms at {bw / 1e12} TB/s)")
    # the radix route's device time by kernel (a count and a plan, then per
    # pass an upsweep, a scan and a scatter): mean ms per launch from the
    # profiler over 10 calls, and the launches it saw (it may drop some)
    from torch.profiler import ProfilerActivity, profile
    sort_radix_hopper(sx)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            sort_radix_hopper(sx)
        torch.cuda.synchronize(dev)
    parts = sorted(((device_seconds_of(e) * 1e3 / e.count, e.count,
                     e.key.replace("(anonymous namespace)::", "").replace("void ", "")
                     .split("(")[0].split("<")[0])
                    for e in prof.key_averages() if device_seconds_of(e)), reverse=True)
    print("  sort radix route by kernel (profiler over 10 calls): " + "; ".join(
        f"{k} {t:.4f} ms x {c} launches seen" for t, c, k in parts))
    # EW* per op at phase 3's operands: device time of the kernel, the plain
    # version and the ATen call, CUDA-event times beside
    per_op = {op: model_row(lambda op=op: ewise_hopper(ea, eb, op),
                            lambda op=op: EW_REFS[op](ea, eb),
                            lambda op=op: OP_ATEN[op](ea, eb))
              for op in ("mul", "div", "add", "sub")}
    for op, t in per_op.items():
        print(f"  ewise {op}, device ms: kernel {t['ms']:.4f}  plain {t['plain_ms']:.4f}  "
              f"ATen {t['library_ms']:.4f}; by events: kernel {t['event_ms']['ms']:.4f}  "
              f"ATen {t['event_ms']['library_ms']:.4f}")
    # EW*'s plan takes 1 vector a thread while 4 would leave an SM without a
    # block, else 4: the vector kernel at both, by device time, below the
    # switch, at it and at phase 3's size, through the C entry point (plans
    # the wrapper does not make; not counted as launches)
    def ew_at(a_, b_, o_, op, u):
        items = a_.numel() // (16 // a_.element_size())
        rc = _cuda.lib().halo_ewise(a_.data_ptr(), b_.data_ptr(), o_.data_ptr(), a_.numel(),
                                    EW_OPS[op], _cuda.dtype_code(a_.dtype), 1, u,
                                    max(1, -(-items // (u * EW_THREADS))), _cuda.stream(dev))
        _cuda.check(rc, "ewise")

    sms = _cuda.sm_count(dev)
    ew_u = {}
    gen7 = torch.Generator(device=dev).manual_seed(7)
    for dt in (torch.float32, torch.bfloat16):
        v = 16 // dt.itemsize
        for n_ in (65536, 4 * EW_THREADS * sms * v - v, SIZES["EW"] ** 2):
            a_ = torch.randn(n_, generator=gen7, device=dev).to(dt)
            b_ = (torch.randn(n_, generator=gen7, device=dev) + 3.0).to(dt)
            o_ = torch.empty_like(a_)
            row = {"plan_u": ewise_plan(n_, dt, True, sms).items_per_thread}
            for op in ("mul", "div"):
                for u in (1, 4):
                    ew_at(a_, b_, o_, op, u)
                    if not torch.equal(bits(o_), bits(EW_REFS[op](a_, b_))):
                        fail(f"EW {op} {dt} n={n_} at U={u}: not bit-identical")
                    row[f"{op}_u{u}_ms"] = device_ms(lambda: ew_at(a_, b_, o_, op, u))
            ew_u[f"{str(dt).split('.')[-1]} {n_}"] = row
    del a_, b_, o_
    print("  ewise plan, vector kernel device us (type n, plan's U: mul U=1 / U=4; div "
          "U=1 / U=4): " + "; ".join(
              f"{k} U={r['plan_u']}: {r['mul_u1_ms'] * 1e3:.3f} / {r['mul_u4_ms'] * 1e3:.3f}; "
              f"{r['div_u1_ms'] * 1e3:.3f} / {r['div_u4_ms'] * 1e3:.3f}"
              for k, r in ew_u.items()))
    # the two SORT routes at rows that fit one tile, 2^24 keys each: the tile
    # route takes every row up to SORT_TILE while it is faster; the tile
    # route's device time beside
    sort_sweep = {}
    gen8 = torch.Generator(device=dev).manual_seed(8)
    for n_ in CROSSOVER_SORT_N:
        x_ = torch.randn(((1 << 24) // n_, n_), generator=gen8, device=dev)
        sort_sweep[str(n_)] = {"tile_ms": ms(sort_tile_hopper, x_),
                               "radix_ms": ms(sort_radix_hopper, x_),
                               "tile_device_ms": device_ms(lambda: sort_tile_hopper(x_))}
    del x_
    faster = [int(n_) for n_, t in sort_sweep.items() if t["radix_ms"] < t["tile_ms"]]
    print("  SORT routes at 2^24 float32 keys, event ms (row length: tile / radix; "
          "tile device ms): " + "; ".join(
              f"{n_}: {t['tile_ms']:.4f} / {t['radix_ms']:.4f}; {t['tile_device_ms']:.4f}"
              for n_, t in sort_sweep.items())
          + f"; radix faster at n = {faster}; SORT_TILE = {SORT_TILE}")
    # the tile route at phase 3's request shape, 4096 rows of 4096: events,
    # device time beside
    stx = torch.randn((4096, 4096), generator=gen8, device=dev)
    sort_times = {"ms": ms(sort_tile_hopper, stx),
                  "plain_ms": ms(sort_ref, stx),
                  "library_ms": ms(torch.sort, stx),
                  "device_ms": {"ms": device_ms(lambda: sort_tile_hopper(stx)),
                                "library_ms": device_ms(lambda: torch.sort(stx))},
                  "crossover": sort_sweep}
    print(f"  sort tile route 4096x4096 float32: event ms kernel {sort_times['ms']:.4f}  "
          f"torch.sort {sort_times['library_ms']:.4f}; device ms kernel "
          f"{sort_times['device_ms']['ms']:.4f}  torch.sort "
          f"{sort_times['device_ms']['library_ms']:.4f}")
    sort_tile_bound = bound(4 * 2 * stx.numel(), stx.numel() * 12)
    hx, = jobs["HIST"]
    n_hist = hx.numel()
    hist_bound = bound(4 * n_hist + 4 * 64, n_hist)

    # the model path at phase 3b's shapes, in the model's type: RMSNORM over
    # 4096 rows of d_model; FLASH_ATTN over the longest prompt, every head,
    # with the model's mask (danube: 1x32x4200x80 on 8 KV heads, causal,
    # window 4096)
    cfg = get_config(SERVE["arch"])
    attn = cfg.stages[0].pattern[0].attn
    mdt, seq = cfg.activation_dtype(), max(SERVE["prompt_lens"])
    gen = torch.Generator(device=dev).manual_seed(4)
    rx = (torch.randn((4096, cfg.d_model), generator=gen, device=dev) + 0.5).to(mdt)
    rg = (torch.randn(cfg.d_model, generator=gen, device=dev) * 0.1 + 1.0).to(mdt)

    def rms_bound_of(x):
        """x read once, gamma once, the output written once; 4 operations
        an element."""
        return bound(x.element_size() * (2 * x.numel() + x.shape[-1]), 4 * x.numel(),
                     bf16_peak)

    rms_bound = rms_bound_of(rx)
    # RMSNORM at the row counts the served run launches it at (decode's
    # slots, the two prompt lengths) and at 4096, by device time, under its
    # launch plan, beside F.rms_norm and its plain version
    rms_rows = []
    for rows in sorted({SERVE["slots"], 4096, *SERVE["prompt_lens"]}):
        x_ = (torch.randn((rows, cfg.d_model), generator=gen, device=dev) + 0.5).to(mdt)
        eps = cfg.norm_eps
        row = model_row(lambda: rmsnorm_hopper(x_, rg, eps), lambda: rmsnorm_ref(x_, rg, eps),
                        lambda: rmsnorm_aten(x_, rg, eps))
        row["bound_ms"], row["bound_by"] = rms_bound_of(x_)
        row.update(rows=rows, plan=rmsnorm_plan(rows, cfg.d_model, x_.element_size(), sms)
                   ._asdict())
        rms_rows.append(row)
        print(f"  rmsnorm {rows}x{cfg.d_model} {str(mdt).split('.')[-1]} (plan "
              f"{tuple(row['plan'].values())}) kernel_ms {row['ms']:.4f}  F.rms_norm "
              f"{row['library_ms']:.4f}  plain_ms {row['plain_ms']:.4f}  bound_ms "
              f"{row['bound_ms']:.6f} ({row['bound_ms'] / row['ms']:.0%} of it)")
        del x_
    fq = torch.randn((1, attn.n_heads, seq, attn.head_dim), generator=gen, device=dev).to(mdt)
    fk = torch.randn((1, attn.n_kv_heads, seq, attn.head_dim), generator=gen, device=dev).to(mdt)
    fv = (torch.randn((1, attn.n_kv_heads, seq, attn.head_dim), generator=gen, device=dev)
          + 1.0).to(mdt)
    fkw = dict(causal=True, window=attn.window, prefix_len=cfg.prefix_len)
    # the (q, k) pairs this mask leaves visible, 4·D operations each (q·k and
    # p·v); q, k, v read once and o written once
    pairs = int(visibility(seq, seq, device=dev, **fkw).sum()) * attn.n_heads
    fa_flops = 4 * attn.head_dim * pairs
    fa_bound = bound(fq.element_size() * (2 * fq.numel() + fk.numel() + fv.numel()),
                     fa_flops, bf16_peak)
    print(f"  flash_attention: {pairs} visible (q, k) pairs, {fa_flops / 1e9:.1f} "
          f"GFLOP; RMSNORM and FLASH_ATTN are bound against the bfloat16 "
          f"tensor-core peak")
    max_abs["rmsnorm"] = float((wide(rmsnorm_hopper(rx, rg, cfg.norm_eps))
                                - wide(rmsnorm_ref(rx, rg, cfg.norm_eps))).abs().max())
    fo, fr = flash_attention_mma_hopper(fq, fk, fv, **fkw), attention_ref(fq, fk, fv, **fkw)
    max_abs["flash_attention_mma"] = float((wide(fo) - wide(fr)).abs().max())
    check_close(f"FLASH_ATTN {tuple(fq.shape)} window {attn.window} mma vs plain",
                normwise(fo, fr), mdt)
    del fo, fr
    # the 3×TF32 route (the one float32 takes) at the same shape in float32,
    # bound at the TF32 tensor-core peak (the float32 CUDA-core bound beside)
    fq32, fk32, fv32 = fq.float(), fk.float(), fv.float()
    fr = attention_ref(fq32, fk32, fv32, **fkw)
    fo = flash_attention_tf32x3_hopper(fq32, fk32, fv32, **fkw)
    max_abs["flash_attention_tf32x3"] = float((fo - fr).abs().max())
    check_close(f"FLASH_ATTN {tuple(fq.shape)} window {attn.window} float32 "
                f"flash_attention_tf32x3 vs plain", normwise(fo, fr), torch.float32)
    del fo, fr
    fa32_bytes = 4 * (2 * fq.numel() + fk.numel() + fv.numel())
    fa_tf32_bound = bound(fa32_bytes, fa_flops, tf32_peak)
    mname = str(mdt).split(".")[-1]

    def cycling(fn, args_list):
        """``fn`` on the next argument tuple at each call."""
        it = iter(range(1 << 62))
        return lambda: fn(*args_list[next(it) % len(args_list)])

    # the skinny route at danube's decode projections (M = slots, the
    # model's type): device time per call from the profiler, each call on
    # the next of enough copies of B that the 50 MB L2 holds none of them
    # from one call to the next, as a decode pass finds them (it reads
    # 3.5 GB of weights); event times beside it
    slots, gen7 = SERVE["slots"], torch.Generator(device=dev).manual_seed(7)

    def weights(kk, nn, copies):
        return [(torch.randn((kk, nn), generator=gen7, device=dev) * kk ** -0.5).to(mdt)
                for _ in range(copies)]

    decode = []
    for (kk, nn), per_pass in decode_projections(cfg).items():
        a4 = torch.randn((slots, kk), generator=gen7, device=dev).to(mdt)
        bs = weights(kk, nn, max(2, math.ceil(L2_COLD_BYTES / (2 * kk * nn))))
        args = [(a4, b_) for b_ in bs]
        fns = {"ms": cycling(mmm_skinny_hopper, args), "plain_ms": cycling(mmm_ref, args),
               "library_ms": cycling(mmm_aten, args)}
        row = {k: device_ms(f) for k, f in fns.items()}
        row["event_ms"] = {k: ms(f) for k, f in fns.items()}
        row["bound_ms"], row["bound_by"] = bound(
            a4.element_size() * (a4.numel() + kk * nn + slots * nn),
            2 * slots * kk * nn, bf16_peak)
        row["max_abs_err"] = float((wide(mmm_skinny_hopper(a4, bs[0]))
                                    - wide(mmm_ref(a4, bs[0]))).abs().max())
        row.update(shape=f"{slots}x{kk}@{kk}x{nn} {mname}", launches_per_pass=per_pass,
                   copies_of_b=len(bs))
        decode.append(row)
        print(f"  mmm_skinny {row['shape']:26s} kernel_ms {row['ms']:.4f}  plain_ms "
              f"{row['plain_ms']:.4f}  library_ms {row['library_ms']:.4f}  bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']}, {row['bound_ms'] / row['ms']:.0%} "
              f"of it)  {per_pass} per pass; events {row['event_ms']}")
        del bs, args
    max_abs["mmm_skinny"] = max(r["max_abs_err"] for r in decode)
    skinny_times = {k: sum(r[k] * r["launches_per_pass"] for r in decode)
                    for k in ("ms", "plain_ms", "library_ms")}
    skinny_bound = (sum(r["bound_ms"] * r["launches_per_pass"] for r in decode), "bytes")
    print(f"  mmm_skinny, one decode pass ({sum(r['launches_per_pass'] for r in decode)} "
          f"MMMs): kernel {skinny_times['ms']:.3f} ms, torch.matmul "
          f"{skinny_times['library_ms']:.3f} ms, bound {skinny_bound[0]:.3f} ms")

    # the tensor-core route at danube's prefill projections (M = the two
    # prompt lengths, the model's type): device time per call from the
    # profiler, each call on the next of enough copies of B that the L2
    # holds none of them from one call to the next, as a prefill finds its
    # weights; beside it the plain version, torch.matmul, and the bound at
    # the tensor-core peak.  The row totals one serving run's prefills:
    # each shape's time × its launches in phase 3b (7·L per prefill).

    def wgmma_widths(args):
        """Device ms per call of the tensor-core kernel at each tile width."""
        return {str(bn): device_ms(cycling(functools.partial(mmm_wgmma_hopper, tile_n=bn),
                                           args)) for bn in (128, 256)}

    def widths_text(by_width, chosen):
        fastest = min(by_width, key=by_width.get)
        return (" / ".join(f"128x{bn} {t:.4f} ms" for bn, t in by_width.items())
                + f"; wgmma_tile_n picks {chosen}, the faster is {fastest}")

    lens = [SERVE["prompt_lens"][i % len(SERVE["prompt_lens"])]
            for i in range(SERVE["requests"])]
    prefill = []
    for m_ in SERVE["prompt_lens"]:
        a_ = torch.randn((m_, max(kk for kk, _ in decode_projections(cfg))),
                         generator=gen7, device=dev).to(mdt)
        for (kk, nn), per_prefill in prefill_projections(cfg).items():
            am = a_[:, :kk].contiguous()
            bs = weights(kk, nn, max(2, math.ceil(L2_COLD_BYTES / (2 * kk * nn))))
            args = [(am, b_) for b_ in bs]
            row = {k: device_ms(cycling(f, args)) for k, f in (
                ("ms", mmm_wgmma_hopper), ("plain_ms", mmm_ref), ("library_ms", mmm_aten))}
            row["width_ms"] = wgmma_widths(args)
            t_bytes = am.element_size() * (am.numel() + kk * nn + m_ * nn) / bw
            t_ops = 2 * m_ * kk * nn / bf16_peak
            row.update(bound_ms=max(t_bytes, t_ops) * 1e3, bytes_ms=t_bytes * 1e3,
                       ops_ms=t_ops * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            row["max_abs_err"] = float((wide(mmm_wgmma_hopper(am, bs[0]))
                                        - wide(mmm_ref(am, bs[0]))).abs().max())
            row.update(shape=f"{m_}x{kk}@{kk}x{nn} {mname}", tile_n=wgmma_tile_n(m_, nn, sms),
                       launches_per_run=per_prefill * lens.count(m_), copies_of_b=len(bs))
            prefill.append(row)
            print(f"  mmm_wgmma {row['shape']:26s} (128x{row['tile_n']}) kernel_ms "
                  f"{row['ms']:.4f}  plain_ms "
                  f"{row['plain_ms']:.4f}  library_ms {row['library_ms']:.4f}  bound_ms "
                  f"{row['bound_ms']:.4f} ({row['bound_by']}, {row['bound_ms'] / row['ms']:.0%} "
                  f"of it)  {row['launches_per_run']} per run; by width "
                  + widths_text(row["width_ms"], row["tile_n"]))
            del bs, args, am
        del a_
    # the template's 4096³ in the model's type, at both widths
    a_ = torch.randn((SIZES["MMM"],) * 2, generator=gen7, device=dev).to(mdt)
    bs = weights(SIZES["MMM"], SIZES["MMM"], 2)
    cube = {"shape": f"{SIZES['MMM']}^3 {mname}",
            "tile_n": wgmma_tile_n(SIZES["MMM"], SIZES["MMM"], sms),
            "width_ms": wgmma_widths([(a_, b_) for b_ in bs])}
    print(f"  mmm_wgmma {cube['shape']:26s} by width "
          + widths_text(cube["width_ms"], cube["tile_n"]))
    del a_, bs
    max_abs["mmm_wgmma"] = max(r["max_abs_err"] for r in prefill)
    wgmma_times = {k: sum(r[k] * r["launches_per_run"] for r in prefill)
                   for k in ("ms", "plain_ms", "library_ms")}
    t_bytes, t_ops = (sum(r[k] * r["launches_per_run"] for r in prefill)
                      for k in ("bytes_ms", "ops_ms"))
    wgmma_bound = (sum(r["bound_ms"] * r["launches_per_run"] for r in prefill),
                   "bytes" if t_bytes >= t_ops else "operations")
    wgmma_times.update(per_shape=prefill, sms=sms, cube=cube)
    print(f"  mmm_wgmma, one serving run's prefills "
          f"({sum(r['launches_per_run'] for r in prefill)} MMMs): kernel "
          f"{wgmma_times['ms']:.1f} ms, torch.matmul {wgmma_times['library_ms']:.1f} ms, bound "
          f"{wgmma_bound[0]:.1f} ms")

    # the 3×TF32 route by device time: at the template's 4096³ and at phase
    # 3's lone request (K = 4094, padded to 4096 by the split pass), the
    # split pass and the product apart (mean device ms per launch of each
    # kernel, torch.profiler), and at the float32 replay's four 512-row
    # prefill projections (each call on the next of enough copies of B that
    # the L2 holds none of them), beside torch.matmul with TF32 off; the
    # tensor-core route likewise at PACKED_MMM, the pack pass apart
    def two_parts(fn, whole_ms, first, key, product_kernel="mmm_wgmma_kernel"):
        """Device ms per call of a route's first pass (the kernel whose name
        holds ``first``, under ``key``) and of its product (the kernel whose
        name holds ``product_kernel``), each the median
        of five device_ms_per_call windows (an empty window, which the
        profiler on the card now and then returns, is measured again, up
        to three times).  Printed as not measured (None) where a window saw
        another kernel or only one of the two, or where ``whole_ms``, the
        whole call's device time measured apart, lies farther from the
        windows' totals than their spread."""
        windows = []
        for _ in range(5):
            for _ in range(3):
                per = device_ms_per_call(fn, TIMED_RUNS, dev, by_kernel=True)
                if per:
                    break
            pre = sum(t for k_, t in per.items() if first in k_)
            product = sum(t for k_, t in per.items() if product_kernel in k_)
            windows.append((pre, product, sum(per.values())))
        totals = [w[2] for w in windows]
        spread = max(totals) - min(totals)
        off = max(min(totals) - whole_ms, whole_ms - max(totals), 0.0)
        parts = {key: statistics.median(w[0] for w in windows),
                 "product_ms": statistics.median(w[1] for w in windows),
                 "parts_windows_ms": totals}
        if off > spread or any(not (w[0] and w[1]) or w[0] + w[1] != w[2] for w in windows):
            print(f"  {first} pass not measured: {parts[key]:.4f} + product "
                  f"{parts['product_ms']:.4f} against the whole call's {whole_ms:.4f} ms, "
                  f"window totals {', '.join(f'{t:.4f}' for t in totals)}")
            parts.update({key: None, "product_ms": None})
        return parts

    def parts_text(row, key="split_ms"):
        if row[key] is None:
            return f"{key[:-3]} not measured"
        return f"{key[:-3]} {row[key]:.4f} + product {row['product_ms']:.4f}"

    tf32_times = model_row(lambda: mmm_tf32x3_hopper(a, b), lambda: mmm_ref(a, b),
                           lambda: mmm_aten(a, b))
    tf32_times.update(two_parts(lambda: mmm_tf32x3_hopper(a, b), tf32_times["ms"],
                                "tf32_split", "split_ms"))
    exact = a.double() @ b.double()
    tf32_times["err_vs_float64"] = normwise(mmm_tf32x3_hopper(a, b), exact)
    tf32_times["library_err_vs_float64"] = normwise(mmm_aten(a, b), exact)
    del exact
    tf32_times.update(bound_float32_ms=mmm_bound[0], bound_float32_by=mmm_bound[1],
                      algorithm_floor_ms=tf32_floor_ms)
    print(f"  mmm_tf32x3 {m}x{k}@{k}x{n} float32: kernel_ms {tf32_times['ms']:.4f} "
          f"({parts_text(tf32_times)})  torch.matmul {tf32_times['library_ms']:.4f}  bound "
          f"{tf32_bound[0]:.4f} (TF32 tensor cores), {mmm_bound[0]:.4f} (float32 CUDA "
          f"cores); algorithm floor {tf32_floor_ms:.4f} (three TF32 products); normwise "
          f"error vs float64 {tf32_times['err_vs_float64']:.3e}, torch.matmul "
          f"{tf32_times['library_err_vs_float64']:.3e}")
    lone = model_row(lambda: mmm_tf32x3_hopper(la, lb), lambda: mmm_ref(la, lb),
                     lambda: mmm_aten(la, lb))
    lone.update(two_parts(lambda: mmm_tf32x3_hopper(la, lb), lone["ms"], "tf32_split",
                          "split_ms"))
    lone["bound_ms"], lone["bound_by"] = bound(4 * (lm * lk + lk * ln + lm * ln),
                                               2 * lm * ln * lk, tf32_peak)
    lone["max_abs_err"] = float((mmm_tf32x3_hopper(la, lb) - mmm_ref(la, lb)).abs().max())
    lone["shape"] = f"{lm}x{lk}@{lk}x{ln} float32"
    tf32_times["lone_request"] = lone
    print(f"  mmm_tf32x3 {lone['shape']} (the lone request): kernel_ms {lone['ms']:.4f} "
          f"({parts_text(lone)})  torch.matmul {lone['library_ms']:.4f}  plain_ms "
          f"{lone['plain_ms']:.4f}  bound {lone['bound_ms']:.4f} (TF32 tensor cores)")
    # the tensor-core route with both operands packed (K and N off every
    # multiple of 8), B cold in L2, beside torch.matmul
    pm, pk, pn = PACKED_MMM
    pa = torch.randn((pm, pk), generator=gen7, device=dev).to(mdt)
    pbs = weights(pk, pn, max(2, math.ceil(L2_COLD_BYTES / (2 * pk * pn))))
    pargs = [(pa, b_) for b_ in pbs]
    packed = {k_: device_ms(cycling(f, pargs)) for k_, f in (
        ("ms", mmm_wgmma_hopper), ("plain_ms", mmm_ref), ("library_ms", mmm_aten))}
    packed.update(two_parts(cycling(mmm_wgmma_hopper, pargs), packed["ms"], "pack16",
                            "pack_ms"))
    packed["bound_ms"], packed["bound_by"] = bound(
        2 * (pm * pk + pk * pn + pm * pn), 2 * pm * pk * pn, bf16_peak)
    packed["max_abs_err"] = float((wide(mmm_wgmma_hopper(pa, pbs[0]))
                                   - wide(mmm_ref(pa, pbs[0]))).abs().max())
    packed.update(shape=f"{pm}x{pk}@{pk}x{pn} {mname}, A and B packed",
                  copies_of_b=len(pbs))
    wgmma_times["packed"] = packed
    print(f"  mmm_wgmma {packed['shape']}: kernel_ms {packed['ms']:.4f} "
          f"({parts_text(packed, 'pack_ms')})  torch.matmul {packed['library_ms']:.4f}  "
          f"plain_ms {packed['plain_ms']:.4f}  bound {packed['bound_ms']:.4f}")
    del pa, pbs, pargs
    f32_prefill = []
    m_ = SERVE["prompt_lens"][0]
    for (kk, nn), per_prefill in prefill_projections(cfg).items():
        am = torch.randn((m_, kk), generator=gen7, device=dev)
        bs = [torch.randn((kk, nn), generator=gen7, device=dev) * kk ** -0.5
              for _ in range(max(2, math.ceil(L2_COLD_BYTES / (4 * kk * nn))))]
        args = [(am, b_) for b_ in bs]
        row = {"shape": f"{m_}x{kk}@{kk}x{nn} float32", "launches_per_replay": per_prefill,
               "ms": device_ms(cycling(mmm_tf32x3_hopper, args)),
               "library_ms": device_ms(cycling(mmm_aten, args)),
               "bound_ms": bound(4 * (m_ * kk + kk * nn + m_ * nn), 2 * m_ * kk * nn,
                                 tf32_peak)[0],
               "algorithm_floor_ms": 3 * 2 * m_ * kk * nn / tf32_peak * 1e3,
               "copies_of_b": len(bs)}
        row.update(two_parts(cycling(mmm_tf32x3_hopper, args), row["ms"], "tf32_split",
                             "split_ms"))
        f32_prefill.append(row)
        print(f"  mmm_tf32x3 {row['shape']:26s} kernel_ms {row['ms']:.4f} "
              f"({parts_text(row)})  torch.matmul {row['library_ms']:.4f}  bound_ms "
              f"{row['bound_ms']:.4f}  algorithm floor {row['algorithm_floor_ms']:.4f}  "
              f"{per_prefill} per float32 prefill")
        del am, bs, args
    replay_ms = {k: sum(r[k] * r["launches_per_replay"] for r in f32_prefill)
                 for k in ("ms", "library_ms", "bound_ms", "algorithm_floor_ms")}
    tf32_times.update(per_shape=f32_prefill, float32_prefill=replay_ms)
    print(f"  mmm_tf32x3, the float32 replay's prefill "
          f"({sum(r['launches_per_replay'] for r in f32_prefill)} MMMs): kernel "
          f"{replay_ms['ms']:.2f} ms, torch.matmul {replay_ms['library_ms']:.2f} ms, bound "
          f"{replay_ms['bound_ms']:.2f} ms, algorithm floor "
          f"{replay_ms['algorithm_floor_ms']:.2f} ms")

    # the crossover of the routes by device time, at the gate/up projection
    # and at the unembed (the widest), in the model's type and in float32:
    # the skinny route against the route that takes M > SKINNY_M_MAX in
    # that type (wgmma in bfloat16, 3×TF32 in float32); it sets SKINNY_M_MAX
    crossover = {}
    for dt_, above, fn_ in ((mdt, "wgmma", mmm_wgmma_hopper),
                            (torch.float32, "tf32x3", mmm_tf32x3_hopper)):
        dname = str(dt_).split(".")[-1]
        for kk, nn in ((cfg.d_model, cfg.stages[0].pattern[0].d_ff),
                       (cfg.d_model, cfg.padded_vocab)):
            copies = max(2, math.ceil(L2_COLD_BYTES / (dt_.itemsize * kk * nn)))
            bs = [(torch.randn((kk, nn), generator=gen7, device=dev) * kk ** -0.5).to(dt_)
                  for _ in range(copies)]
            sweep = {}
            for m_ in CROSSOVER_M:
                a_ = torch.randn((m_, kk), generator=gen7, device=dev).to(dt_)
                args = [(a_, b_) for b_ in bs]
                sweep[str(m_)] = {"skinny_ms": device_ms(cycling(mmm_skinny_hopper, args)),
                                  f"{above}_ms": device_ms(cycling(fn_, args)),
                                  "library_ms": device_ms(cycling(mmm_aten, args))}
            del bs, args
            faster = [int(m_) for m_, t in sweep.items() if t["skinny_ms"] < t[f"{above}_ms"]]
            crossover[f"{kk}x{nn} {dname}"] = sweep
            print(f"  MMM routes at {kk}x{nn} {dname}, device ms (M: skinny / {above} / "
                  f"torch.matmul): " + "; ".join(
                      f"{m_}: {t['skinny_ms']:.4f} / {t[f'{above}_ms']:.4f} / "
                      f"{t['library_ms']:.4f}" for m_, t in sweep.items())
                  + f"; skinny faster at M = {faster}; SKINNY_M_MAX = {SKINNY_M_MAX}")
    skinny_times.update(per_shape=decode, crossover=crossover, skinny_m_max=SKINNY_M_MAX)

    # SMMM at the template's shape three ways: by CUDA events (the row's ms,
    # as every earlier tree timed it), by device time with the split pass
    # and the product apart, and against its bounds; beside the dense
    # torch.matmul of the densified A and, where torch.sparse takes the
    # 64x128 blocks, one BSR product
    def spmm_call():
        return smmm_hopper(sv, si, sb)

    spmm_times = {"ms": ms(smmm_hopper, sv, si, sb),
                  "plain_ms": ms(smmm_bell_ref, sv, si, sb),
                  "library_ms": ms(torch.matmul, sa_dense, sb),
                  "device_ms": device_ms(spmm_call)}
    spmm_times.update(two_parts(spmm_call, spmm_times["device_ms"], "smmm_split",
                                "split_ms", product_kernel="smmm_tf32_kernel"))
    exact = sa_dense.double() @ sb.double()
    spmm_times.update(bound_float32_ms=spmm_bound_f32[0], algorithm_floor_ms=spmm_floor_ms,
                      aten_per_slot_ms=spmm_aten_ms,
                      err_vs_float64=normwise(spmm_call(), exact),
                      library_err_vs_float64=normwise(torch.matmul(sa_dense, sb), exact))
    del exact
    try:
        bsr = sa_dense.to_sparse_bsr((bm, bk))
        bsr_err = normwise(bsr @ sb, smmm_bell_ref(sv, si, sb))
        spmm_times["library_bsr_ms"] = ms(torch.matmul, bsr, sb)
        spmm_times["library_bsr_err_vs_plain"] = bsr_err
        bsr_text = f"torch.sparse BSR @ B {spmm_times['library_bsr_ms']:.4f} (err {bsr_err:.1e})"
        del bsr
    except (RuntimeError, NotImplementedError, ValueError) as e:
        spmm_times["library_bsr_ms"] = None
        spmm_times["library_bsr_error"] = str(e).splitlines()[0][:300]
        bsr_text = "torch.sparse BSR @ B refused"
        print(f"  spmm: torch.sparse BSR @ B with {bm}x{bk} blocks refused: "
              f"{spmm_times['library_bsr_error']}")
    print(f"  spmm {nrows * bm}x{ks} bELL {bm}x{bk} @{ks}x{ns} float32: kernel_ms "
          f"{spmm_times['ms']:.4f} (events), device {spmm_times['device_ms']:.4f} "
          f"({parts_text(spmm_times)})  dense torch.matmul {spmm_times['library_ms']:.4f}  "
          f"{bsr_text}  bound {spmm_bound[0]:.4f} (TF32 tensor cores), "
          f"{spmm_bound_f32[0]:.4f} (float32 CUDA cores); algorithm floor "
          f"{spmm_floor_ms:.4f} (three TF32 products); normwise error vs float64 "
          f"{spmm_times['err_vs_float64']:.3e}, torch.matmul "
          f"{spmm_times['library_err_vs_float64']:.3e}")

    # FLASH_ATTN in float32 at danube's prefill (1 x heads x 4200 x 80), at
    # the float32 replay's (512 tokens, its launches) and at head dim 256
    # (gemma-7b's 16 heads on 16 KV heads, causal, 4096 tokens): the 3×TF32
    # route by device time, beside the plain version and SDPA, bound from the
    # mask's visible pairs at the TF32 rate, with the three products' floor
    # and the float32 CUDA-core bound beside it, and its error against
    # float64
    def fa_tf32_row(heads, kv_heads, sq, d, **kw):
        g_ = torch.Generator(device=dev).manual_seed(6)
        q_ = torch.randn((1, heads, sq, d), generator=g_, device=dev)
        k_ = torch.randn((1, kv_heads, sq, d), generator=g_, device=dev)
        v_ = torch.randn((1, kv_heads, sq, d), generator=g_, device=dev) + 1.0
        flops_ = 4 * d * int(visibility(sq, sq, device=dev, **kw).sum()) * heads
        nbytes = 4 * (2 * q_.numel() + k_.numel() + v_.numel())
        out = flash_attention_tf32x3_hopper(q_, k_, v_, **kw)
        check_close(f"FLASH_ATTN tf32x3 {(1, heads, sq, d)} float32 vs plain",
                    normwise(out, attention_ref(q_, k_, v_, **kw)), torch.float32)
        err = normwise(out, attention_f64(q_, k_, v_, **kw))
        del out
        fns = {"ms": lambda: flash_attention_tf32x3_hopper(q_, k_, v_, **kw),
               "plain_ms": lambda: attention_ref(q_, k_, v_, **kw),
               "library_ms": lambda: attention_aten(q_, k_, v_, **kw)}
        tf = model_row(*fns.values())
        shape = f"1x{heads}x{sq}x{d} float32, {kv_heads} KV heads, {kw}"
        tf["bound_ms"], tf["bound_by"] = bound(nbytes, flops_, tf32_peak)
        tf.update(shape=shape, err_vs_float64=err,
                  bound_float32_ms=bound(nbytes, flops_, f32_peak)[0],
                  algorithm_floor_ms=bound(nbytes, 3 * flops_, tf32_peak)[0])
        tf.update(two_parts(fns["ms"], tf["ms"], "fa_split_kernel", "split_ms",
                            product_kernel="fa_wgmma_kernel"))
        print(f"  flash_attention_tf32x3 {shape}: kernel_ms {tf['ms']:.4f} "
              f"({parts_text(tf)})  SDPA {tf['library_ms']:.4f}  plain_ms "
              f"{tf['plain_ms']:.4f}  bound_ms {tf['bound_ms']:.4f} ({tf['bound_by']}, TF32 "
              f"tensor cores; three products {tf['algorithm_floor_ms']:.4f}, float32 CUDA "
              f"cores {tf['bound_float32_ms']:.4f})  error vs float64 {err:.3e}")
        del q_, k_, v_
        return tf

    fa_tf32_main = {**fa_tf32_row(attn.n_heads, attn.n_kv_heads, seq, attn.head_dim, **fkw),
                    "float32_replay": fa_tf32_row(attn.n_heads, attn.n_kv_heads,
                                                  min(SERVE["prompt_lens"]), attn.head_dim,
                                                  **fkw),
                    "d256_float32": fa_tf32_row(16, 16, 4096, 256, causal=True, window=None,
                                                prefix_len=0)}
    # FLASH_ATTN at head dim 256 in bfloat16 and float16, the wgmma route
    # (FA_D256: gemma-7b's heads, gemma3-4b's local layers), by device time
    fa_d256 = fa_d256_rows(dev, bw, bf16_peak, ms)
    if any(r_["fa_route"] != "wgmma" for r_ in fa_d256.values()):
        fail(f"FLASH_ATTN at head dims 256 and 192 took "
             f"{[r_['fa_route'] for r_ in fa_d256.values()]}")
    fa16_main = dict(fa_d256.pop("gemma7b_bfloat16"), **fa_d256)
    max_abs["flash_attention_wgmma"] = fa16_main.pop("max_abs_err")
    for r_ in fa_d256.values():
        r_.pop("max_abs_err")

    # the fused chain at phase 3c's EW shape: ((a·b + c) − d) / e over five
    # 8192² float32 inputs; five read and one written, one operation per
    # element per step.  No single PyTorch call computes the chain: the
    # library yardstick is the four ATen calls in a row, and the four
    # serial EW kernel launches stand beside it.
    chain = FUSED_CHAINS["4-step ((a·b + c) − d) / e"]
    gen5 = torch.Generator(device=dev).manual_seed(5)
    chain_x = [torch.randn((SIZES["EW"], SIZES["EW"]), generator=gen5, device=dev)
               for _ in range(5)]
    chain_x[4] = chain_x[4].abs() + 1.0          # the divisor, away from 0
    fused_bound = bound(4 * 6 * chain_x[0].numel(), 4 * chain_x[0].numel())
    max_abs["fused"] = float((wide(ewise_chain_hopper(*chain_x, steps=chain))
                              - wide(ewise_chain_ref(*chain_x, steps=chain))).abs().max())
    if max_abs["fused"] != 0.0:                  # phase 2 holds it bit-exact
        fail(f"fused chain at {SIZES['EW']}² float32 differs from its plain "
             f"version by {max_abs['fused']}")

    def four_aten(a, b, c, d, e):
        return torch.div(torch.sub(torch.add(torch.mul(a, b), c), d), e)

    # EMBED_GRAD at a danube training step's gradient: 4 × 512 positions of
    # phase 3d's batch 0 into the (padded vocab, d_model) table, bfloat16;
    # the bound reads g and the tokens once and writes the table once
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.embed_grad.embed_grad import embed_grad_hopper
    from repro_torch.kernels.embed_grad.ref import embed_grad_aten, embed_grad_ref
    e_tok = SyntheticLM(cfg, TRAIN["seq_len"], TRAIN["batch"],
                        TRAIN["seed"]).device_batch(0, dev)["tokens"].reshape(-1)
    e_vocab = cfg.padded_vocab
    e_g = torch.randn((e_tok.numel(), cfg.d_model), generator=gen5,
                      device=dev).to(torch.bfloat16)
    embed_bound = bound(e_g.numel() * 2 + e_tok.numel() * e_tok.element_size()
                        + e_vocab * cfg.d_model * 2, 0)
    max_abs["embed_grad"] = float((wide(embed_grad_hopper(e_g, e_tok, e_vocab))
                                   - wide(embed_grad_ref(e_g, e_tok, e_vocab))).abs().max())
    if max_abs["embed_grad"] != 0.0:             # phase 3f holds it bit-exact
        fail(f"EMBED_GRAD differs from its plain version by {max_abs['embed_grad']}")

    rows = [
        # device time (events under "event_ms"); bound: 2·M·N·K at the TF32
        # tensor-core rate (the float32 CUDA-core bound under
        # "bound_float32_ms", three products under "algorithm_floor_ms")
        ("mmm_tf32x3", tf32_times, tf32_bound,
         f"{m}x{k}@{k}x{n} float32, 3×TF32 route, device time of the split pass and "
         f"the product (library: torch.matmul, TF32 off; lone_request: phase 3's "
         f"{lm}x{lk}@{lk}x{ln})"),
        # device time of one decode pass's MMMs: Σ per shape of device ms ×
        # launches per pass (per_shape below); launches from phase 3b
        ("mmm_skinny", skinny_times, skinny_bound,
         f"one decode pass: {sum(r['launches_per_pass'] for r in decode)} MMMs at "
         f"M={slots} {mname}, device time (library: torch.matmul)"),
        # device time of one serving run's prefill projections: Σ per shape
        # of device ms × launches per run (per_shape below; packed: A and B
        # packed at PACKED_MMM)
        ("mmm_wgmma", wgmma_times, wgmma_bound,
         f"one serving run's prefills: {sum(r['launches_per_run'] for r in prefill)} "
         f"MMMs at M={'/'.join(map(str, SERVE['prompt_lens']))} {mname}, device time "
         f"(library: torch.matmul)"),
        # device time (events under "event_ms"), per op under "per_op"
        ("ewise", dict(per_op["mul"]), ew_bound, f"{ea.shape[0]}x{ea.shape[1]} "
         f"float32, EWMM, device time (per op below)"),
        ("mvm", {"ms": ms(mvm_hopper, ma, mx), "plain_ms": ms(mvm_ref, ma, mx),
                 "library_ms": ms(mvm_aten, ma, mx)}, mvm_bound,
         f"{mm}x{mk}@{mk} float32"),
        ("vdp", {"ms": ms(vdp_hopper, vx, vy), "plain_ms": ms(vdp_ref, vx, vy),
                 "library_ms": ms(vdp_aten, vx, vy)}, vdp_bound,
         f"n={nv} float32"),
        ("jacobi", {"ms": ms(jacobi_hopper, ja, jx, jb),
                    "plain_ms": ms(jacobi_step_ref, ja, jx, jb),
                    "library_ms": ms(jacobi_step_aten, ja, jx, jb)}, js_bound,
         f"{nj}x{nj} float32, one sweep"),
        ("conv1d", {"ms": ms(conv1d_hopper, cx, cw), "plain_ms": ms(conv1d_ref, cx, cw),
                    "library_ms": ms(conv1d_aten, cx, cw)}, conv_bound,
         f"N={nc} K={kc} float32"),
        # events (device time under "device_ms", split pass and product
        # apart); bound: the kept slots' operations at the TF32 tensor-core
        # rate (the float32 CUDA-core bound under "bound_float32_ms", three
        # products under "algorithm_floor_ms")
        ("spmm", spmm_times, spmm_bound,
         f"{nrows * bm}x{ks} bELL {bm}x{bk} @{ks}x{ns} float32, 3×TF32 (library: dense "
         f"torch.matmul of the densified A)"),
        ("fft_radix", model_row(lambda: fft_radix_hopper(fx, ftw),
                                lambda: fft_radix_ref(fx, ftw), lambda: fft_aten(fx)),
         fft_bound, f"{f_m}x{f_n} float32, radix route, device time (library: cuFFT)"),
        ("fft_chirp", {**model_row(lambda: fft_chirp_hopper(dx, ctab),
                                   lambda: fft_chirp_ref(dx, ctab), lambda: fft_aten(dx)),
                       "sweep": chirp_sweep}, chirp_bound,
         f"{f_m}x{DFT_N} float32, chirp route (L = {chirp_length(DFT_N)}), device time "
         f"(library: cuFFT)"),
        # the library call also returns the permutation; the plain version
        # makes every NaN positive, then keeps the values of one torch.sort.
        # Events, not the profiler: the radix route launches 4 of its
        # kernels 4 times per call, and a window that drops launches would
        # round that count down
        ("sort_radix", {"ms": ms(sort_radix_hopper, sx), "plain_ms": ms(sort_ref, sx),
                        "library_ms": ms(torch.sort, sx)}, sort_bound,
         f"n={n_sort} float32, radix route (library: torch.sort)"),
        # events (device time under "device_ms"); both routes per row
        # length under "crossover"
        ("sort", sort_times, sort_tile_bound,
         "4096x4096 float32, tile route (library: torch.sort)"),
        # torch.histc bins the edges differently: a time yardstick only
        ("hist", {"ms": ms(hist_hopper, hx), "plain_ms": ms(hist_ref, hx),
                  "library_ms": ms(torch.histc, hx, 64, 0.0, 1.0)}, hist_bound,
         f"n={n_hist} float32, 64 bins (library: histc)"),
        # device time from the profiler (event times under "event_ms"); the
        # path's row counts under "per_rows"
        ("rmsnorm", {**model_row(lambda: rmsnorm_hopper(rx, rg, cfg.norm_eps),
                                 lambda: rmsnorm_ref(rx, rg, cfg.norm_eps),
                                 lambda: rmsnorm_aten(rx, rg, cfg.norm_eps)),
                     "per_rows": rms_rows}, rms_bound,
         f"4096x{cfg.d_model} {mname}, device time (library: F.rms_norm)"),
        ("flash_attention_mma", model_row(
            lambda: flash_attention_mma_hopper(fq, fk, fv, **fkw),
            lambda: attention_ref(fq, fk, fv, **fkw),
            lambda: attention_aten(fq, fk, fv, **fkw)),
         fa_bound, f"1x{attn.n_heads}x{seq}x{attn.head_dim} {mname}, "
         f"{attn.n_kv_heads} KV heads, causal, window {attn.window}, tensor-core "
         f"route, device time (library: SDPA, explicit mask)"),
        # device time (events under "event_ms"); the float32 replay's shape
        # and head dim 256 under "float32_replay" and "d256_float32"
        ("flash_attention_tf32x3", fa_tf32_main, fa_tf32_bound,
         f"1x{attn.n_heads}x{seq}x{attn.head_dim} float32, {attn.n_kv_heads} KV heads, "
         f"causal, window {attn.window}, 3×TF32 route, device time (library: SDPA, "
         f"explicit mask)"),
        # device time (events under "event_ms"); gemma3-4b's local layers,
        # float16 and deepseek-v2's MLA prefill at head dim 192 under
        # "gemma3_4b_bfloat16", "gemma7b_float16" and "deepseek_v2_mla_bfloat16"
        ("flash_attention_wgmma", fa16_main, (fa16_main["bound_ms"], fa16_main["bound_by"]),
         fa16_main["shape"] + ", wgmma route, device time (library: SDPA)"),
        ("fused", {"ms": ms(lambda: ewise_chain_hopper(*chain_x, steps=chain)),
                   "plain_ms": ms(lambda: ewise_chain_ref(*chain_x, steps=chain)),
                   "library_ms": ms(four_aten, *chain_x),
                   "serial_ewise_ms": ms(lambda: serial_chain(chain_x, chain))},
         fused_bound, f"{SIZES['EW']}x{SIZES['EW']} float32, 4 steps "
         f"((a*b+c)-d)/e (library: four ATen calls; serial_ewise_ms: four EW "
         f"kernel launches)"),
        # device time (events under "event_ms"); the plain version's Python
        # loops over pieces read the card back (a synchronise) each call
        ("embed_grad", model_row(lambda: embed_grad_hopper(e_g, e_tok, e_vocab),
                                 lambda: embed_grad_ref(e_g, e_tok, e_vocab),
                                 lambda: embed_grad_aten(e_g, e_tok, e_vocab)),
         embed_bound, f"{e_tok.numel()}x{cfg.d_model} bfloat16 into {e_vocab}x"
         f"{cfg.d_model}, a danube training step's tokens, device time (library: "
         f"index_put_ accumulate, PyTorch's backward of table[tokens])"),
    ]
    kernels = []
    for name, times, (bound_ms, bound_by), shape in rows:
        # each kernel's launches in the run of the path it serves (PATH_OF):
        # phase 3 for the quickstart's, 3b for the model path's, 3c for the
        # fused chain, 3b's float32 replay for the 3×TF32 FLASH_ATTN, 3b's
        # gemma3-4b leg for the wgmma FLASH_ATTN, phase 3's requests counted
        # alone for the chirp FFT and the tile SORT
        path = PATH_OF.get(name)
        n_launches = {"serve": serve_launches, "graph": graph_launches,
                      **path_launches}.get(path, launches)[name]
        if not n_launches:
            fail(f"{name} was launched no time on its path")
        source, site = REPLACES[name]
        entry = {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
                 "replaces": site, "launches": n_launches,
                 "max_abs_err": max_abs[name], **times, "bound_ms": bound_ms,
                 "bound_by": bound_by, "shape": shape}
        if name == "ewise":
            entry["per_op"] = per_op
            entry["items_a_thread"] = ew_u
        if name == "mmm_tf32x3":
            entry["launches_float32_replay"] = \
                path_launches["serve_float32"]["mmm_tf32x3"]
            entry["launches_lone_request"] = path_launches["mmm_lone"]["mmm_tf32x3"]
        if name == "flash_attention_wgmma":
            # the MLA leg's prefills, head dim 192 padded to 256
            entry["launches_serve_mla"] = path_launches["serve_mla"][name]
        for leg in NEW_LEG_PATHS:
            if path_launches[leg].get(name):
                entry[f"launches_{leg}"] = path_launches[leg][name]
        entry["launches_resilience"] = path_launches["resilience"].get(name, 0)
        if name == "fused":
            print(f"  fused: four serial EW launches {times['serial_ewise_ms']:.4f} ms")
        if name in ("flash_attention_mma", "flash_attention_tf32x3"):
            entry["tflops"] = fa_flops / (times["ms"] * 1e-3) / 1e12
            print(f"  {name}: {entry['tflops']:.1f} TFLOP/s of the {fa_flops / 1e9:.1f} "
                  f"GFLOP")
        kernels.append(entry)
        print(f"  {name:6s} {shape:40s} kernel_ms {times['ms']:.4f}  plain_ms "
              f"{times['plain_ms']:.4f}  library_ms {times['library_ms']:.4f}  "
              f"bound_ms {bound_ms:.4f} ({bound_by})  launches {n_launches}")
    for name, t in ((e["name"], e["event_ms"]) for e in kernels if "event_ms" in e):
        print(f"  {name} CUDA-event times per call (host launch included): "
              f"kernel_ms {t['ms']:.4f}  plain_ms {t['plain_ms']:.4f}  "
              f"library_ms {t['library_ms']:.4f}")
    # the paper's evaluation row per kernel: T3 of the library call as the
    # baseline, of the kernel as HALO's, of the plain version as the
    # hardware-agnostic one; T1 from the end-to-end runs; Φ = T3_base/T3_halo
    print("  " + KernelReport.csv_header())
    for entry in kernels:
        report = KernelReport(entry["name"], card_name,
                              t1_s=e2e["t1_us_per_call"] * 1e-6,
                              t3_baseline_s=entry["library_ms"] * 1e-3,
                              t3_halo_s=entry["ms"] * 1e-3,
                              t3_agnostic_s=entry["plain_ms"] * 1e-3)
        entry["phi"] = report.halo_score
        print("  " + report.csv())
    # device time the template's requests need: each kernel's median
    # times the launches the counted run made (EW per op: two each, by
    # device time; the sum with EW by events beside, the yardstick of trees
    # that time EW by events only)
    rest = sum(e["ms"] * e["launches"] for e in kernels
               if e["name"] != "ewise" and e["name"] not in PATH_OF)
    busy = sum(per_op[op]["ms"] * 2 for op in per_op) + rest
    e2e["kernel_ms_sum"] = busy
    e2e["kernel_ms_sum_ew_by_events"] = sum(
        per_op[op]["event_ms"]["ms"] * 2 for op in per_op) + rest
    e2e["device_busy_share"] = busy / e2e["wall_ms"]
    print(f"  end to end: quickstart wall {e2e['wall_ms']:.3f} ms (median of "
          f"{E2E_REPEATS}: {', '.join(f'{w:.3f}' for w in e2e['wall_ms_all'])}) "
          f"for {e2e['requests']} requests; kernel time {busy:.3f} ms (EW by "
          f"events: {e2e['kernel_ms_sum_ew_by_events']:.3f} ms); device "
          f"busy share {e2e['device_busy_share']:.3f}; T1 "
          f"{e2e['t1_us_per_call']:.1f} us per call")
    print(json.dumps({"e2e": e2e}))
    return kernels


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the card")
    from repro_torch.kernels import _cuda

    dev = torch.device("cuda", 0)
    seconds = {}
    # every phase but 3l runs with no TuningDB: the launch counts they hold
    # the kernels to are the default plans'
    if os.environ.pop("HALO_TUNING_DB", None):
        print("  HALO_TUNING_DB was set: unset for the run (phase 3l sets its own)")
    print("phase 1: build")
    t0 = time.perf_counter()
    so = _cuda.build()
    print(f"  built {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in (so.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        if "registers" in line or "bytes stack" in line or "error" in line:
            print(f"  ptxas: {entry}: {line.strip()}")
    _cuda.lib()
    card = card_line()
    print(f"  card: {card}")
    from repro_torch.core.config import halo_config
    print(f"  knobs: {halo_config()} (the health monitor runs in phase 3g only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")

    seconds["1 build"] = time.perf_counter() - t0

    print("phase 2: kernels against their plain versions on the card")
    t0 = time.perf_counter()
    phase2(dev)
    seconds["2 kernels"] = time.perf_counter() - t0
    print("phase 3: quickstart through claim/send/recv and isend/waitall, "
          "pinned to hopper")
    t0 = time.perf_counter()
    jobs, launches, path_launches, max_abs, e2e = phase3(dev)
    seconds["3 quickstart"] = time.perf_counter() - t0
    print(f"phase 3b: {SERVE['arch']} at full width served through "
          f"repro_torch.launch.serve on the kernels")
    t0 = time.perf_counter()
    serve_launches, serve_stats, path_launches["serve_float32"], paged_launches = phase3b(dev)
    path_launches.update(paged_launches)
    print(json.dumps({"serve": serve_stats}))
    print(f"phase 3b, head dim 256: {SERVE_D256['arch']} at full width, "
          f"{SERVE_D256['pattern_repeats']} 5:1 pattern, served on the kernels")
    path_launches["serve_d256"], d256_stats = phase3b_d256(dev)
    print(json.dumps({"serve_d256": d256_stats}))
    print(f"phase 3b, state-space path: {SERVE_HYBRID['arch']} at full width and depth, "
          f"served on the kernels")
    _, hybrid_stats = phase3b_hybrid(dev)
    print(json.dumps({"serve_hybrid": hybrid_stats}))
    torch.cuda.empty_cache()              # the zamba2 leg's weights are gone
    print(f"phase 3b, mixture of experts: {SERVE_MOE['arch']} at full width and depth, "
          f"served on the kernels")
    path_launches["serve_moe"], moe_stats = phase3b_moe(dev)
    print(json.dumps({"serve_moe": moe_stats}))
    print(f"phase 3b, MLA: {SERVE_MLA['arch']} at full width, layer 0 and "
          f"{SERVE_MLA['moe_repeats']} MoE layers, served on the kernels")
    path_launches["serve_mla"], mla_stats = phase3b_mla(dev)
    print(json.dumps({"serve_mla": mla_stats}))
    torch.cuda.empty_cache()              # the deepseek leg's weights are gone
    print("phase 3b, stub frontends: paligemma-3b and musicgen-large at full width and "
          "depth on the kernels")
    frontend_launches, frontend_stats = phase3b_frontends(dev)
    path_launches.update(frontend_launches)
    print(json.dumps({"serve_frontends": frontend_stats}))
    seconds["3b serve"] = time.perf_counter() - t0
    print(f"phase 3m: the captured decode step against the eager body, "
          f"{DECODE_GRAPH['arch']} at full width on {card}")
    t0 = time.perf_counter()
    path_launches["decode_graph"], decode_graph_stats = phase3m(dev, card)
    seconds["3m decode graph"] = time.perf_counter() - t0
    print(json.dumps({"decode_graph": decode_graph_stats}))
    print(f"phase 3c: execution graphs, fusion and compiled replay on {card}")
    t0 = time.perf_counter()
    graph_launches, graph_stats = phase3c(dev, card)
    seconds["3c graphs"] = time.perf_counter() - t0
    print(json.dumps({"graphs": graph_stats}))
    print(f"phase 3e: collectives — the collective Jacobi at n = {COLLECTIVE['n']} "
          f"over device groups on {card}")
    t0 = time.perf_counter()
    _, collective_stats = phase3e(dev, card)
    seconds["3e collectives"] = time.perf_counter() - t0
    print(json.dumps({"collectives": collective_stats}))
    print(f"phase 3g: resilience — a member's death, stragglers and a wedged decode "
          f"step on {card}")
    t0 = time.perf_counter()
    resilience_launches, resilience_stats = phase3g(dev, card)
    seconds["3g resilience"] = time.perf_counter() - t0
    print(json.dumps({"resilience": resilience_stats}))
    print(f"phase 3h: multi-process C²MPI — worker processes serving hopper@w0 on {card}")
    t0 = time.perf_counter()
    multiproc_stats = phase3h(dev, card)
    seconds["3h multi-process"] = time.perf_counter() - t0
    print(json.dumps({"multiproc": multiproc_stats}))
    print(f"phase 3i: expert parallelism — {EXPERT_PARALLEL['arch']}'s MoE layers over "
          f"device groups on {card}")
    t0 = time.perf_counter()
    path_launches["expert_parallel"], ep_stats = phase3i(dev, card)
    seconds["3i expert parallelism"] = time.perf_counter() - t0
    print(json.dumps({"expert_parallel": ep_stats}))
    print(f"phase 3j: expert parallelism under a device mesh — {MESH['ranks']} gloo ranks "
          f"on {card}")
    t0 = time.perf_counter()
    path_launches["mesh"], mesh_stats = phase3j(dev, card)
    seconds["3j mesh"] = time.perf_counter() - t0
    print(json.dumps({"mesh": mesh_stats}))
    torch.cuda.empty_cache()
    print(f"phase 3k: training under a device mesh — {MESH_TRAIN['arch']} on "
          f"{MESH_TRAIN['ranks']} gloo ranks on {card}")
    t0 = time.perf_counter()
    path_launches["mesh_train"], mesh_train_stats = phase3k(dev, card)
    seconds["3k mesh train"] = time.perf_counter() - t0
    print(json.dumps({"mesh_train": mesh_train_stats}))
    print(f"phase 3d: training {TRAIN['arch']} at full width and depth on the kernels")
    t0 = time.perf_counter()
    path_launches["train"], train_stats = phase3d(dev)
    seconds["3d train"] = time.perf_counter() - t0
    print(json.dumps({"train": train_stats}))
    print(f"phase 3f: data-parallel training, {TRAIN_COMM['arch']} at full width over "
          f"device groups on {card}")
    t0 = time.perf_counter()
    path_launches["train_comm"], train_comm_stats = phase3f(dev)
    seconds["3f train comm"] = time.perf_counter() - t0
    print(json.dumps({"train_comm": train_comm_stats}))
    print(f"phase 3l: tuning — the kernels' launch plans swept, checked and served "
          f"under a TuningDB on {card}")
    t0 = time.perf_counter()
    path_launches["tune"], tune_stats = phase3l(dev, card)
    seconds["3l tuning"] = time.perf_counter() - t0
    print(json.dumps({"tuning": tune_stats}))
    # phase 3g's legs and 3f's member-death runs (3g's leg (e))
    resilience_launches.update(train_comm_stats["resilience_launches"])
    path_launches["resilience"] = dict(resilience_launches)
    missing = [k for k in RESILIENCE_KERNELS if not resilience_launches.get(k)]
    if missing:
        fail(f"the resilience legs launched no {missing}")
    print(f"phase 4: times (median of 20 CUDA-event-timed calls) on {card}")
    t0 = time.perf_counter()
    kernels = phase4(dev, jobs, launches, max_abs, e2e, card.split(",")[0],
                     serve_launches, graph_launches, path_launches)
    seconds["4 times"] = time.perf_counter() - t0
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
