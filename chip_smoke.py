"""Smoke run of the PyTorch/CUDA port on one GPU: the quickest proof that
the port still builds, agrees with its plain versions and serves.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):

1. device   — a CUDA card must be present; prints its name and power limit.
2. build    — nvcc builds every kernel in src/repro_torch/kernels/csrc/.
3. kernels  — each kernel against its plain PyTorch version at the
              internlm2-20b FFF main-path shapes (D = 6144, depth 4, 16
              leaves of width 1024; decode batch 8; prefill 8 x 128 tokens;
              the gathered kernels at the 32-token verify slab, 6144 -> 1024
              and 1024 -> 6144, every activation, random, one-leaf and
              distinct-leaf routings), in float32 (TF32 off; tolerance
              1e-4) and bfloat16 (5e-2).  Leaf indices must match exactly
              except on near-ties (deciding logit |l| < 1e-3 in float32),
              which are counted; outputs are compared on tokens whose
              indices agree.  Times each kernel, its plain version and,
              where one PyTorch call computes the same function, that call
              (library_ms), with CUDA events.  The gathered kernels are also
              held at the per-leaf token counts where their per-pass cap of
              32 tokens a leaf shows (one leaf holding 0, 1, 31, 32, 33 and
              all 64 tokens of a 64-token slab, and a 33-token slab), and
              timed on the one-leaf and distinct routings beside a read-rate
              yardstick (torch.sum over the same weight bytes).  Every
              gathered and fused decode case is called twice and must come
              out bit-identical (no atomics in either sum).
              The grouped kernels and the router are also held and timed
              at a 256-token admission slab (lines of their own; the table
              stays at 1024).  Each kernel's time (ms) is its device time:
              CUDA events around replays of a CUDA graph of 20 calls, so
              the wrapper's host cost is left out; the loop of 20 launches
              that earlier tables used is logged beside it.  Each router
              row also logs torch.addmm of its logits and zero_() of its
              output, timed both ways.
   ragged   — the same kernels at the CPU tests' small unaligned sizes,
              which exercise their masked edge paths, the gathered
              kernels' guard for leaf indices outside [0, E) and their
              per-leaf token-count edges, and the
              grouped kernels at their tile edges: group sizes 0, 1, 63,
              64, 65, 127 and 128 in one call, capacity 256 with sizes 0
              to 256 around each 64-row slice, capacity 264, D and H off
              the bf16 kernels' k-step and column atoms, N 384, whisper-
              small's up projection (a D split), x rows past the group
              sizes holding non-zero values (their outputs must be exactly
              zero) and an x off 16 bytes (the masked path), every call
              twice and bit-identical; and the float32 forms' edges (N 1,
              8, 16, 32 narrow, 33, 64, 96 wide; group sizes 0, 1, 31, 32,
              33, 127, 128; capacity 264; D 100 and 45, off the 32-float
              step and off 4; D 1000 split; rows past the sizes non-zero;
              an x 4 bytes off 16); and both grouped kernels at the
              overflow pass of a 1024-token slab (capacity 896, the 16
              leaves' group sizes 0, 1, 31, 33, 896 and 11 x 0, main-path
              widths, both dtypes), against their plain versions and
              timed.  Every grouped call in the run
              counts its launch by path (kernels/leaf_gemm/kernel.py
              plan); each full-width call, the serve and engine runs' and
              the arch sites' included, must count on the TMA path in
              bf16 and on the CUDA-core path in float32.
   router   — the router at depths 1-8, D = 6144, 20 and 24, B = 1, 31,
              33, 65, 256 and 1031, an unaligned x, all-left and all-right
              routings; both dtypes; and its float32 resident form's edges
              (D 4, 32, 64, 100, 128, 200, 500, 1024, 1025; B up to 16384,
              both lane layouts at D <= 128); every case twice and
              bit-identical, each counted on the form
              kernels/tree_router/kernel.py::plan picks.
4. serve    — internlm2-20b FFF at full width (bf16) with 8 of its 48
              layers, random weights from a seeded CUDA generator: batch 8,
              prompt 128, 16 greedy decode steps through
              repro_torch.launch.serve.serve (the fixed-batch loop); asserts
              each kernel's launch count on that run and that no site fell
              back to the reference (the grouped kernels twice a tree where
              the prefill's 1024 tokens pass a leaf's capacity: the
              overflow pass), and reports how many prefill tokens
              overflowed a leaf's capacity (and took the overflow pass).
              The loop's decode step is a replayed CUDA graph
              (serving/graphs.py; asserted captured, its first eager call
              and first replay under torch.cuda.set_sync_debug_mode
              ("error")); the same run op by op (graphs.disabled())
              follows, the same counts asserted, the tokens bit-identical,
              and both decode p50s are logged.  Every loop of the later
              phases goes through the same checks.
   profile  — a warm prefill and warm decode steps of that model under
              torch.profiler: device busy share and the top kernels.
5. engine   — the same model and weights through the continuous-batching
              engine (repro_torch.launch.serve.serve_engine): 8 slots,
              speculative decoding with spec_k 3 (a 32-token verify slab)
              and the self:1 draft, fcfs, 16 Markov-source requests of
              16-128 prompt tokens and 32 new tokens each, monolithic then
              chunked (16-token chunks) admission.  Asserts the launch
              counts of each run (both gathered kernels once per layer per
              verify round, the fused decode kernel once per draft step,
              the grouped kernels once per layer per pass of an admission
              slab, two passes for a monolithic slab of 256-1024 tokens;
              a replayed graph credits the launches it holds), the fixed
              dispatch shapes, one captured graph for the spec round, for
              admission and for each prefill bucket used (or the chunk
              slab) and no eager dispatch, and that the reference never
              ran.  Each dispatch's first eager call and first replay run
              under torch.cuda.set_sync_debug_mode("error").  An A/B in the
              same process follows: the monolithic run op by op
              (graphs.disabled()), then on graphs in a fresh engine; every
              request's tokens must be bit-identical to the first run's,
              and each run's tok/s, TTFT, round p50 and admission slabs
              (p50 of the replays, each dispatch's first call) are logged.
   engine profile — three warm speculative rounds under torch.profiler,
              replayed graphs and then op by op: host and graph launches,
              kernels executed, stream syncs per round; then a warm
              monolithic admission (admit and an 8 x 128 slab) both ways.
   paged    — the same model and weights through the engine on the paged KV
              cache: 16 requests with a shared 64-token system prompt
              (prompts 65-128 tokens, 32 new tokens each, two tenants), 8
              slots, spec_k 3 with the self:1 draft, max_len 176; (a) the
              contiguous cache, fcfs; (b) pages of 16, prefix sharing off;
              (c) sharing on, monolithic; (d) sharing on, chunked (16),
              weighted_leaf_aware at a=3,b=1.  (b)'s tokens must equal
              (a)'s exactly; (c) and (d) must hit shared pages, and every
              run's prefilled plus shared tokens must equal the prompt
              tokens.  Each run's launch counts and dispatch shapes are
              asserted as in the engine phase.  Prints TTFT, per-token
              latency, the paging counters, each tenant's tokens/s, and how
              many of (c)'s requests give (a)'s tokens.
6. parity   — the same width with 2 layers in float32: 8 greedy tokens from
              the kernel backends must equal those of the reference backend;
              then the engine (plain and speculative, monolithic and
              chunked; contiguous, and paged with prefix sharing on
              shared-prefix and copy-on-write requests) must give every
              request lm.generate's greedy tokens, except where a deciding
              margin (a node logit or the top-2 logit gap) is under 1e-3.
7. grouped  — the capacity-bounded grouped backends.  The grouped GEMMs at
              the JAX grouped path's capacities (C = 8, 16, 136 and 264,
              group sizes 0, 1, C-1 and C in one call) against their plain
              versions at full width in both dtypes, timed beside the C =
              128 table row.  The 8-layer bf16 model served through the
              engine with fff_backend="grouped" (the engine phase's 16
              requests, spec_k 3), once with the default policy ("drop", cf
              2.0) and once with "exact_dense" at cf 0.5: asserts the
              grouped kernels' launch counts (one call each per layer per
              dispatch, two where "exact_dense" repairs a dispatch that can
              drop a token; no other kernel), every dispatch captured as a
              graph, that the reference never ran, and
              overflow with repairs at cf 0.5; logs the overflow means and
              each run's device-busy share over one profiled spec round.
              Then float32 at 2 layers: lm.generate through grouped
              ("exact_dense", cf 0.5) and one-process grouped_ep must give
              the reference backend's greedy tokens, and so must the engine
              on grouped ("exact_dense", cf 0.5), except at near-ties.
8. train    — the training path (repro_torch.launch.train, lm.loss_fn, the
              train backends, plain PyTorch under autograd: the JAX package
              trains through einsums, no Pallas kernel).  First the card
              against the CPU: FFF_CONFIG.reduced() in float32, one seeded
              param tree on both, loss, metrics and every gradient within
              1e-3 under train/reference and train/grouped, each with remat
              "none" and "full" (whose recompute runs in autograd's own
              thread on the card).  Then internlm2-20b FFF at full width,
              bf16, remat "full", 4 of 48 layers: 20 steps of
              launch.train.train, batch 8 x seq 128, lr 3e-4; every loss
              finite, every gradient finite and nonzero at step 0, no
              kernel launched, the mean loss of the last 5 steps at least
              TRAIN_MARGIN below step 0's; logs the step time p50 (CUDA
              events), peak memory, hardening, balance and the decisive
              fraction before and after, and profiles one warm step (the
              update of step 16 and the loss and gradient of step 17).  Last, 2 layers in float32 trained
              3 steps, then served: lm.generate (batch 4, prompt 32, 8
              greedy tokens) through the kernel backends (router, grouped
              GEMMs, fused decode; their launches asserted) must equal the
              reference backend's tokens, except where a row met a deciding
              margin under 1e-3.
9. ckpt     — checkpoint/restart training (repro_torch.checkpoint, the fault
              supervisor): internlm2-20b FFF at full width, bf16, remat
              "full", 1 of 48 layers (1.53B parameters; ~15 GB a checkpoint,
              so the phase fails unless the temporary directory's disk holds
              two).  (b) 6 uninterrupted steps of launch.train.train; (c) the
              same 6 steps under the supervisor (a checkpoint every 3 steps,
              async, keep 2, a failure injected at step 4): it ends at step
              6 with 1 restart, its losses and final parameters bit-identical
              to (b)'s; (a) a blocking save_tree and restore_tree of (c)'s
              final {params, opt}, bit-identical; (d) the step-6 checkpoint
              restored into a fresh model and served (batch 8, prompt 128, 8
              greedy tokens) through the kernels: the in-memory model's
              tokens.  Prints the free disk, the checkpoint bytes, the
              snapshot time on the caller's thread and the background write
              and restore times, each with its rate.  Then the command line
              on the card (--reduced), each run its own process: killed with
              SIGKILL after step 4 and run again, it resumes at step 3, and
              its step-5 line and step-6 checkpoint are the uninterrupted
              run's; and the data Prefetcher's card path.
10. dense   — the paper's FF baseline: internlm2-20b native (dense SwiGLU,
              d_ff 16384) at full width, bf16, 8 layers (4.26B parameters,
              as the serve phase): the fixed-batch loop (batch 8, prompt 128,
              16 decode steps; no kernel launches), then one warm prefill
              and one warm decode step of it and of the 8-layer FFF model,
              profiled, with the FFN sites' device time (the kernels inside
              the 8 sites' device-side ranges) side by side; then
              the reduced native LM's loss and gradients on the card against
              the CPU (1e-3).
11. archs   — the other registry archs' FFF configs at their published
              widths, bf16, one model on the card at a time: phi3-medium-14b
              (leaves of width 1120), starcoder2-15b (GELU leaves without a
              gate, LayerNorm, attention biases) and command-r-35b (d_model
              8192, a tied 256000-word head) at 4 of 40 layers, olmoe-1b-7b
              (a forest of 8 trees of depth 3) at all 16.  For each: every
              kernel its sites reach on layer 0's weights at the sites'
              shapes (the prefill slab's router and grouped kernels, the
              verify slab's router and gathered kernels, the decode step's
              fused kernel over the whole forest; every tree checked, tree 0
              timed), through the kernels phase's row builders and
              bounds; the serve phase's fixed-batch loop with its launch
              counts (per tree) asserted; the parity phase at 2 layers
              (kernel backends against the reference backend, 0
              differences off near-ties).  olmoe also serves the engine
              phase's 16 requests (8 slots, spec_k 3, self:1), its launch
              counts asserted per tree, and its FFN sites are timed for moe.
12. moe     — olmoe-1b-7b native: the noisy top-k MoE (64 GELU experts of
              width 1024, top 8) at full width, all 16 layers, bf16, its
              gates drawn at random (zero gates tie every expert), its
              sites on the grouped GEMMs (core/moe.forward_sparse): the
              fixed-batch loop as serve (graphs and op by op; grouped_matmul
              up and down once a pass a site, two passes for the 1024-token
              prefill), its decode p50 beside the FFF forest's (same
              inference width, 8 x 1024); the FFN sites' device time
              against the forest's in a warm prefill and decode step,
              beside the MoE sites' bound; the MoE site on layer 0's
              prefill and decode inputs against the gather form (bf16
              tolerance, bit-identical twice), its device time, bound and
              buffer bytes, and both grouped GEMMs on its buffers against
              their plain versions; 8 requests through the engine (8
              slots): decode, each prefill bucket and admission captured
              once, no host sync in a first call or first replay, tokens
              bit-identical to op by op.
13. long    — starcoder2-15b FFF at full width, 2 of 40 layers: one
              6144-token prompt prefilled through flash_attention (the 4096
              window binds), 8 decode steps, launch counts asserted, time
              and peak memory printed; layer 0's q, k, v in float32: flash
              against the plain masked attention within 1e-3.

14. kimi    — kimi-k2-1t-a32b FFF (8 trees of depth 6, 64 SwiGLU leaves of
              2048 a tree, D 7168, head_dim 112, a 163840-word vocabulary)
              at 1 of 61 layers, bf16: every kernel at its site's shapes
              (as archs), the fixed-batch loop with its launch counts; the
              native MoE (384 experts, top 8, gates drawn N(0, 1/d_model))
              at 1 layer through the same loop (the grouped GEMMs, from
              graphs), its decode p50 beside the forest's; fp32 greedy parity at 1 layer with
              the forest cut to 2 trees (8 fp32 trees are ~90 GB).
15. jamba   — jamba-1.5-large-398b FFF, bf16, its period cut to positions
              (0, 1, 7): Mamba with the MoE-derived forest (2 trees of depth
              3, leaves of 24576), Mamba with the dense-derived tree (16 x
              1536), attention with the dense-derived tree; 3 of 72 layers.
              (The port's layer i takes period[i % len(period)], so a depth
              cut of the published period would never reach attention.)
              Every kernel at both site configs' shapes, the fixed-batch
              loop with per-site launch counts, the engine's refusal (the
              JAX message), fp32 greedy parity at the same 3 layers.
16. xlstm   — xlstm-1.3b, all 48 layers (42 mLSTM, 6 sLSTM), bf16: no FFN
              site, so the fixed-batch loop launches no kernel (asserted);
              the engine refuses it.
17. mixers  — at full width in float32, Mamba (D 8192) and the mLSTM and
              sLSTM blocks (D 2048), the card against the CPU with the same
              weights: a prefill of 2 x 32 tokens from zeros and 4 one-token
              steps from its state, every output and the final state
              within 1e-3; on the card, chunkwise mLSTM (chunks of 8 and
              256) against the sequential recurrence.
18. whisper — whisper-small FFF whole (12 encoder + 12 decoder layers,
              D 768, a 51865-word head), bf16: every kernel at the decoder
              site's shapes (one tree of depth 3, 8 GELU leaves of 384), as
              archs, and the two dual kernels on random SwiGLU leaves of
              those shapes (no GELU site runs them), each twice and
              bit-identical; lm.encode over (8, 1500, 768) launches no
              kernel (its sites run FORWARD_T in train mode, as in the JAX
              package); the fixed-batch loop with enc_embeds (8, 1500, 768):
              12 router and 24 grouped_matmul launches in the prefill, 12
              fused decode launches a step, the decode step from a graph
              (learned positions from a staged offset); the loop again,
              warm; a warm
              prefill and decode step profiled (as profile); the engine's
              refusal (the JAX message); the encoder in float32 on
              the card against the CPU (2 x 1500 frames, within 1e-3); fp32
              greedy parity at full depth from tokens and enc_embeds.
19. internvl — internvl2-26b FFF at full width (D 6144, 16 SwiGLU leaves
              of 1024, a 92553-word head), 8 of 48 layers, bf16: the
              fixed-batch loop with an embeds prompt of 8 x 128 x 6144 in
              place of tokens (launch counts asserted), warm again; a warm
              prefill and decode step profiled; the engine's refusal; fp32 greedy parity at 2 layers from an
              embeds prompt.

20. cluster — (runs after paged, on its 8-layer bf16 model) the
              disaggregated cluster (repro_torch.cluster): first the handoff
              round trip between two engines of 8 slots on pages of 16, 8
              of the engine phase's requests a wave: each request's pages,
              extracted to the host and installed, equal the source
              engine's bit for bit, and both engines then decode all 8 to
              the same tokens (extract and install timed, bytes counted;
              install, padded to the table width, a captured graph whose
              first eager call and first replay must not sync);
              then a LocalBus fleet of 1 prefill + 2 decode workers of 8
              slots sharing the parameters serves the engine phase's 16
              requests (32 greedy tokens, pages of 16) beside one engine of
              24 slots and one of 8: its tokens must equal the 8-slot
              engine's exactly; the launch counts around each worker's tick (a
              prefill worker launches no fused decode and its compiled
              dispatches are admission and its slabs, one graph each; a
              decode worker launches the
              fused decode kernel alone, and captures decode and install
              once each),
              TTFT, per-token latency and tok/s of the fleet and of the
              24-slot engine, and how many requests' bf16 tokens differ
              from the 24-slot engine's (for each, its first differing
              token and whether its handed-off prompt K/V already
              differed).  Then fp32 at 2 layers: the fleet and the 24-slot
              engine give lm.generate's tokens, off near-ties.
21. cluster_proc — the fleet on ProcBus at 2 layers, bf16: three spawned
              processes on the one card, each rebuilding its weights from
              the seed (every child's weights checksum must equal this
              process's); decode worker d0 SIGKILLed after 4 results, its
              requests replayed and the role respawned: every rid finishes
              once, with the tokens of a LocalBus run without a kill; then
              a drain, which must finish clean, and no child may be left.
              Prints spawn-to-first-heartbeat seconds and each process's
              peak device memory.  Last, the serve CLI in a subprocess
              (--cluster 1 2 --cluster-kill 4 --cluster-verify --drain,
              reduced, on the card by default) must report parity_ok.
22. draft    — the engine phase's requests with spec_k 3 and the
              starcoder2-15b draft (--draft-config starcoder2-15b):
              starcoder2 reduced to D 6144, 48 heads, vocab 92544, one
              layer, one tree of depth 3 with 8 GELU leaves of 16, float32
              as reduced() makes it.  Every kernel at the draft's site
              (as archs; rows in the arch_kernels JSON under
              "starcoder2-15b draft" with the draft's launches), the engine
              run with its launch counts asserted (the target's as in the
              engine phase plus the draft's router and two grouped_matmul
              a pass of an admission slab and 4 fused decode launches a round; the
              draft's read off the counts around each of its calls), the
              acceptance printed (random weights), and how many requests'
              bf16 tokens differ from the engine without speculation, with
              the self:1 draft's count beside it as the witness that the
              verify path, not the draft, makes bf16 tokens differ (the
              two drafts' greedy tokens must be equal); then
              fp32 at 2 layers: with the draft and without speculation the
              engine gives lm.generate's tokens, off near-ties.
23. model_parallel — (runs after draft, on its 8-layer bf16 model)
              serve --model-parallel 2: two ranks spawned on the one card
              (launch/mesh.spawn_ranks, gloo, a bounded join), layout
              (1, 2).  Each rank first logs which collectives gloo takes on
              CUDA tensors and times a 64 MB all_gather through gloo's own
              copies and through the port's pinned staging; then draws the
              model from the seed and keeps its share
              (launch/serve.setup_model_parallel): it must hold 8 of each
              tree's 16 leaves, half of one process's leaf bytes; every
              other tensor stays whole on each rank, so a pass moves only
              grouped_ep's tokens between the ranks.  Both
              ranks run the fixed loop (batch 8, prompt 128, 16 greedy
              steps) and the engine (8 slots, 8 requests of 16-128 prompt
              tokens, 16 new tokens, fcfs, monolithic, no speculation), the
              launch counts set to 0 just before each run and read just
              after: grouped_matmul and grouped_matmul_dual once per call of
              the grouped leaf MLP (at least one a layer a dispatch), every
              other kernel 0, grouped_ep the only backend.  Both ranks'
              tokens must be equal, and in float32 at 2 layers equal to one
              process's grouped_ep run.  Prints the bytes staged through
              pinned host memory a rank, decode p50, engine tok/s and peak
              memory a rank beside one process's (this process, grouped_ep
              alone), and the bf16 token differences; then both grouped
              kernels at rank 0's buffers (E/M 8 leaves x M*C rows, the
              prefill slab's and a decode step's) against their plain
              versions, as rows of the arch_kernels JSON under
              "internlm2-20b model_parallel rank 0" with the engine run's
              launches.
24. train_mesh — (runs after train) train --mesh host: olmoe-1b-7b FFF at
              full width, 2 of 16 layers, bf16, two ranks on the card, batch
              8 x 128 split over them, 3 steps, twice: at the
              straight-through FFF's default capacity (per data rank, so
              other tokens overflow than in one process) and at a capacity
              factor of 8 (a leaf holds the whole batch: none overflows).
              Each step's loss within the bf16 tolerance of a one-process
              run on the same batches; the step-0 gradient norm of the
              second run within 1% of one process's (a reduction skipped
              or not averaged would be far off); both ranks end each run
              with bit-equal parameters (weights_checksum) and losses; then
              compressed_psum of a 64 MB float32 CUDA tensor a rank within
              0.05 relative of the exact sum.

25. vit     — (runs after internvl) the paper's Table-3 ViT (configs/
              paper_vit: d128, 4 layers, 4 heads, learned positions over the
              64 patch tokens, the vision stub, float32) whole, through
              examples/vit_cifar_fff_torch.py on synthetic CIFAR-like data:
              the dense baseline and FFF leaf widths 32, 8 and 1 (depth 2, 4
              and 7), each trained the example's default 150 AdamW steps
              (FORWARD_T; no kernel may launch), its first 3 losses within
              1e-3 of a CPU run from the same weights and batches; then
              G_A over the 1024 test images in batches of 256 (hard
              FORWARD_I, 16384 tokens a site: tree_router and
              grouped_matmul up (gelu) and down, their launch counts set to
              0 just before and read just after, > 0 asserted, every other
              kernel 0, every router launch counted on its float32
              resident form; the serve, engine and draft runs' router
              launches must count on its cluster form).  The share of
              each site's tokens that the grouped buffers hold (the rest
              take the overflow pass)
              is printed and recorded: the trained models route most
              tokens to one leaf.  For each FFF model the first eval batch
              through the kernels against the reference backend, site by
              site (leaves exact off near-ties, outputs within 1e-4) and as
              logits on the images without a near-tie; the router and both
              grouped_matmul calls at layer 0's site against their plain
              versions, twice and bit-identical (rows "paper-vit lN" of the
              arch_kernels JSON, with the eval launches and the share
              kept); the same at the eval's shapes on a site whose routing
              spreads (16384 N(0, 1) tokens through a fresh FFF(depth,
              leaf), as the FFN-site timing draws them), at least
              VIT_KEPT_FLOOR of its tokens kept asserted, and its cuda
              output against the reference backend's (rows "paper-vit lN
              balanced"); the FFN-site speedup of dense FF(128) over hard
              FFF at batch 2048 on the reference backend (the JAX
              benchmark's) and on cuda.  Prints G_A, the drop against dense
              and the widths.
26. examples — the ported examples in this process: serve_fff_kernels_torch
              (256 tokens through tree_router, grouped_matmul_dual and
              grouped_matmul, 8 through tree_router and the gathered
              kernels; its own routing-agreement assertion, errors within
              1e-3), quickstart_torch (300 SGD steps; its leaves carry
              biases, so auto serves on the reference backend and no kernel
              launches) and train_lm_fff_torch --small (20 steps under the
              supervisor with checkpoints every 10, run again to resume at
              step 20; the greedy sample through the gathered and fused
              decode kernels), launch counts asserted.

Each phase's seconds print as a "[time]" line.  Prints the new archs' kernel rows as one JSON line ({"arch_kernels": ...},
jamba's rows tagged with their site, trees x leaves x width; whisper's
SwiGLU probe rows tagged "[swiglu probe]", 0 launches; the draft's site
under "starcoder2-15b draft"; the grouped kernels at a model-parallel
rank's shapes under "internlm2-20b model_parallel rank 0"; the ViT's
site at each leaf width under "paper-vit lN", and at a site that routes
evenly under "paper-vit lN balanced"),
the kernel table as one JSON line (launches from the monolithic engine
run; the grouped GEMMs' float32 rows at the main shape beside their bf16
ones, "dtype" float32, launches from the float32 grouped parity runs; the
router's float32 resident form at the ViT's evenly routed l1 site, depth 7,
launches from the three FFF models' evals),
the card's name and power limit, and, last,
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, no TF32
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}   # tests/conftest.py "kernel"
NEAR_TIE = 1e-3

# main-path shapes: internlm2-20b FFF at full width
D, DEPTH, E, L_W, O = 6144, 4, 16, 1024, 6144
N_NODES = 2 ** DEPTH - 1
DECODE_B, PREFILL_B, PREFILL_S, SLAB_B = 8, 8, 128, 256
SERVE_LAYERS, GEN, PARITY_LAYERS, PARITY_B, PARITY_S, PARITY_STEPS = 8, 16, 2, 4, 32, 8
# the engine: 8 slots x (spec_k 3 + 1) = the 32-token verify slab
SLOTS, SPEC_K, ENGINE_REQS, ENGINE_PROMPT, ENGINE_MIN_PROMPT, ENGINE_GEN = 8, 3, 16, 128, 16, 32
ENGINE_CHUNK, DRAFT_LAYERS = 16, 1
VERIFY_B = SLOTS * (SPEC_K + 1)
# the paged phase: a shared system prompt of 4 pages, a max_len that is a
# whole number of pages, two tenants
PAGED_PREFIX, PAGE, PAGED_MAX_LEN, PAGED_WEIGHTS = 64, 16, 176, {"a": 3.0, "b": 1.0}
ACTS = ("none", "relu", "gelu", "silu")
# tokens on one leaf of a 64-token slab around the gathered kernels' per-pass
# cap of 32 tokens a leaf (csrc/fused_fff.cu kMaxTok)
LEAF_EDGES, EDGE_B = (0, 1, 31, 32, 33, 64), 64
# the capacities of the JAX grouped path (multiples of 8, not of 128)
GROUPED_CAPS = (8, 16, 136, 264)
# the router's resident form (float32): its widths' edges (off 4, the ViT's,
# its widest, the first past it) and one of each lane layout the plan picks
RESIDENT_DS = (4, 32, 64, 100, 128, 200, 500, 1024, 1025)
# the train phase: full width, 4 layers, the JAX driver's defaults; the loss
# must fall by TRAIN_MARGIN (nats, last 5 steps' mean against step 0)
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_MARGIN = 4, 20, 8, 128, 3e-4, 1.0
TRAIN_SERVE_LAYERS, TRAIN_SERVE_STEPS = 2, 3
# the ckpt phase: full width, 1 of 48 layers (bf16 params and float32 moments,
# ~10 bytes a parameter: ~15 GB a checkpoint, CKPT_KEEP of them on disk); a
# failure injected at CKPT_FAIL_AT; the restored model serves CKPT_GEN tokens
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AT, CKPT_KEEP, CKPT_GEN = 1, 6, 3, 4, 2, 8
# the archs phase: each registry arch's FFF config at its published widths,
# cut to this many layers (olmoe-1b-7b whole); the long phase: starcoder2-15b
# with a prompt past its 4096-token window
ARCH_LAYERS = {"phi3-medium-14b": 4, "starcoder2-15b": 4, "command-r-35b": 4,
               "olmoe-1b-7b": 16}
LONG_LAYERS, LONG_PROMPT, LONG_GEN = 2, 6144, 8
# kimi-k2-1t-a32b at KIMI_LAYERS of 61 layers (fp32 parity with its forest
# cut to KIMI_PARITY_TREES trees: a float32 layer of 8 trees is ~90 GB);
# jamba-1.5-large-398b on the period positions JAMBA_POSITIONS (Mamba + the
# MoE-derived forest, Mamba + the dense-derived tree, attention + the
# dense-derived tree); xlstm-1.3b whole; the mixers phase's prefill of
# MIXER_B x MIXER_S tokens and MIXER_STEPS one-token steps, held at E2E
KIMI_LAYERS, KIMI_PARITY_TREES, JAMBA_POSITIONS = 1, 2, (0, 1, 7)
MIXER_B, MIXER_S, MIXER_STEPS, E2E = 2, 32, 4, 1e-3
# whisper-small whole (12 encoder + 12 decoder layers), its encoder held
# against the CPU's in float32 at WHISPER_CPU_B rows; internvl2-26b at
# INTERNVL_LAYERS of 48 layers
WHISPER_CPU_B, INTERNVL_LAYERS = 2, 8
# the moe phase's engine run: requests and new tokens a request
MOE_ENGINE_REQS, MOE_ENGINE_GEN = 8, 16
# the cluster phases: a decode worker SIGKILLed after this many results; the
# registry arch the draft phase serves as --draft-config
CLUSTER_KILL_AFTER, DRAFT_ARCH = 4, "starcoder2-15b"
# model_parallel and train_mesh: ranks on the one card over gloo, the
# engine's requests and new tokens, olmoe-1b-7b's layers and steps, the bytes
# of a rank's tensor in the gloo and compressed_psum checks, each spawn's limit
MP_RANKS, MP_REQS, MP_GEN, MESH_LAYERS, MESH_STEPS = 2, 8, 16, 2, 3
MP_PROBE_BYTES, MP_LIMIT_S = 64 * 2 ** 20, 600
# train_mesh: the step-0 gradient norm of two ranks against one process's, no
# token overflowing (bf16 rounding of a sum over ~1e9 elements)
MESH_NORM_RTOL = 0.01
# vit: the paper's Table-3 ViT (configs/paper_vit) at these FFF leaf widths
# beside its dense baseline; the first VIT_CPU_STEPS training losses on the
# card held against a CPU run at E2E; the examples phase's LM run
VIT_LEAVES, VIT_CPU_STEPS = (32, 8, 1), 3
# the least share of a balanced site's tokens the grouped buffers must hold
# (the rest take the overflow pass); N(0, 1) tokens keep all of them
VIT_KEPT_FLOOR = 0.95
# an arch_kernels JSON row's keys; the ViT's rows add the share of tokens kept
ARCH_ROW_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "kept", "eval_kept_min")
EXAMPLE_LM_STEPS, EXAMPLE_LM_CKPT_EVERY = 20, 10


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call: CUDA events around replays of a CUDA graph that
    holds ``reps`` calls.  A loop of launches (``time_ms``) times the host
    instead once a call's Python, ctypes and launch cost exceeds the
    kernel's run, as it does for the router."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Each kernel's bound from its inputs in this run: every input read once
# (each routed leaf's weights once), every output written once.

def router_bound(B, N, d, depth, dtype) -> tuple[float, str]:
    """B tokens of width d down a tree of N nodes: x, weights, biases in;
    (B,) int32 out.  A hard descent takes one node a level, so its
    operations are ``depth`` dot products a token, not N."""
    sz = torch.finfo(dtype).bits // 8
    return bound(B * d * sz + N * (d + 1) * sz + B * 4, 2 * B * depth * d, dtype)


def grouped_bound(gs, C, k_in, n_out, n_mats, dtype) -> tuple[float, str]:
    """n_mats (k_in, n_out) weights per group over capacity-C buffers: each
    live group's weights and each routed token's row read, the whole
    (E, C, n_out) output written."""
    sz = torch.finfo(dtype).bits // 8
    tokens, live = int(gs.sum()), int((gs > 0).sum())
    return bound(live * n_mats * k_in * n_out * sz + tokens * k_in * sz
                 + gs.numel() * C * n_out * sz, 2 * n_mats * tokens * k_in * n_out, dtype)


def gathered_bound(idx, k_in, n_out, n_mats, dtype) -> tuple[float, str]:
    """n_mats (k_in, n_out) weights of each distinct leaf in idx, the tokens'
    rows and leaf indices read, their outputs written."""
    sz = torch.finfo(dtype).bits // 8
    B, distinct = idx.numel(), int(torch.unique(idx).numel())
    return bound(distinct * n_mats * k_in * n_out * sz + B * (k_in + n_out) * sz + B * 4,
                 2 * n_mats * B * k_in * n_out, dtype)


def decode_bound(idx, N, d, L, n_mats, dtype) -> tuple[float, str]:
    """The fused decode step: idx (B, T) leaves over T trees of N nodes;
    each tree's distinct leaves' n_mats (d, L) matrices, every node, x in
    and y out; the descent's operations one node a level of each tree."""
    sz = torch.finfo(dtype).bits // 8
    B, T = idx.shape
    depth = (N + 1).bit_length() - 1
    distinct = sum(int(torch.unique(idx[:, t]).numel()) for t in range(T))
    return bound(distinct * n_mats * d * L * sz + T * N * (d + 1) * sz + B * 2 * d * sz,
                 2 * B * (T * depth * d + n_mats * T * d * L), dtype)


def margins(x, nw, nb, depth):
    """Per token: the leaf the float32 plain descent reaches and the
    smallest |deciding logit| on its path."""
    xf = x.float()
    idx = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    margin = torch.full((x.shape[0],), float("inf"), device=x.device)
    for m in range(depth):
        g = (2 ** m - 1) + idx
        logit = (xf * nw[g].float()).sum(-1) + nb[g].float()
        margin = torch.minimum(margin, logit.abs())
        idx = 2 * idx + (logit >= 0).long()
    return idx, margin


def compare_idx(name, got, want, margin):
    """Exact leaf indices except near-ties; returns the agreeing mask, the
    number of near-tie disagreements and the largest index difference off
    near-ties (0, or this raises)."""
    agree = got.long() == want.long()
    bad = ~agree & (margin >= NEAR_TIE)
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} tokens routed "
                             f"differently away from any near-tie")
    diff = (got.long() - want.long()).abs()[margin >= NEAR_TIE]
    return agree, int((~agree).sum()), float(diff.max()) if diff.numel() else 0.0


def twice(name, fn):
    """fn() called twice: the two outputs must be equal bit for bit."""
    first, again = fn(), fn()
    for a, b in zip(first if isinstance(first, tuple) else (first,),
                    again if isinstance(again, tuple) else (again,)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two calls on one input differ")
    return first


def full_width_path(dtype) -> str:
    """The path every full-width grouped GEMM call takes (kernels/leaf_gemm/
    kernel.py::plan): the TMA kernel in bf16, the CUDA-core kernel in
    float32."""
    return "tma" if dtype == torch.bfloat16 else "cuda_cores"


def twice_on(name, fn, kernel, path):
    """``twice`` of a kernel call, both launches counted on ``path`` by the
    kernel's per-path launch count."""
    before = dict(kernel.paths)
    out = twice(name, fn)
    grew = {k: v - before.get(k, 0) for k, v in kernel.paths.items()
            if v != before.get(k, 0)}
    if grew != {path: 2}:
        raise AssertionError(f"{name}: launches by path {grew}, expected 2 on {path!r}")
    return out


def check_paths(common, label, counts, dtype) -> dict:
    """Every grouped GEMM launch of a run (the counts read just after it)
    was counted on the full-width path of its dtype, every fused decode
    launch on its TMA path (kernels/fused_decode/kernel.py::plan) and every
    router launch on the cluster form (kernels/tree_router/kernel.py::plan:
    the model's D 6144); returns the paths."""
    want, paths = full_width_path(dtype), common.path_counts()
    for k, path in (("grouped_matmul", want), ("grouped_matmul_dual", want),
                    ("fused_forest_decode", "tma"), ("tree_router", "cluster")):
        got = paths.get(k, {})
        if sum(got.values()) != counts.get(k, 0) or got.get(path, 0) != counts.get(k, 0):
            raise AssertionError(f"{label}: {k} launches by path {got}, expected all "
                                 f"{counts.get(k, 0)} on {path!r}")
    return paths


def plan_tag(p) -> str:
    """A grouped GEMM plan in a log line: path, tile, split of D, grid."""
    return f"{p.path} {p.rows}x{p.cols} split {p.splits} grid {p.grid}"


def decode_plan_tag(p) -> str:
    """A fused decode plan in a log line: path, chunk, splits of D and of l,
    ring stages, the grids, and which passes run."""
    passes = ["route", "up"] + (["finish"] if p.splits_up > 1 else []) + ["down"] + (
        [] if p.direct else ["combine"])
    return (f"{p.path} chunk {p.chunk} split D {p.splits_up} l {p.splits_down} stages "
            f"{p.stages_up}/{p.stages_down} up {p.up_grid} down {p.down_grid} "
            f"passes {'+'.join(passes)}")


def edge_routing(gen, n, leaf=5, B=EDGE_B, num_leaves=E):
    """B int32 leaf indices in [0, num_leaves), exactly n of them `leaf`."""
    dev = torch.device("cuda")
    idx = torch.randint(0, num_leaves - 1, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[idx >= leaf] += 1
    idx[torch.randperm(B, generator=gen, device=dev)[:n]] = leaf
    return idx


def compare(name, got, want, dtype, rows=None):
    if rows is not None:
        got, want = got[rows], want[rows]
    g, w = got.float(), want.float()
    tol = TOL[dtype]
    err = (g - w).abs()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > tol + tol * w.abs()).any()):
        raise AssertionError(f"{name} [{dtype}]: max |err| {float(err.max()):.3e}"
                             f" exceeds rtol=atol={tol}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         f"from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | TF32 off for float32 matmuls and convolutions")
    return name, smi


def phase_build(common) -> None:
    t0 = time.perf_counter()
    took = common.build_all()
    log(f"[build] {len(took)} libraries built in {time.perf_counter() - t0:.1f}s "
        + " ".join(f"{k}={v:.1f}s" for k, v in took.items()))


def kernel_row(err, call, plain, b_by, library=None) -> dict:
    """A table row: device and loop times of ``call``, the plain version's
    time, the bound and, where one PyTorch call computes the same
    function, that call's device time."""
    b, by = b_by
    return dict(max_abs_err=err, ms=device_ms(call), loop_ms=time_ms(call),
                plain_ms=time_ms(plain), bound_ms=b, bound_by=by,
                library_ms=None if library is None else device_ms(library))


def routed(label, x, nw, nb, depth=DEPTH):
    """The router on one input, called twice (bit-identical): leaf indices
    exact against the float32 plain descent off near-ties.  Returns the
    leaves and the number of near-tie disagreements."""
    from repro_torch.kernels.tree_router import kernel as trk
    leaf = twice(label, lambda: trk.tree_router(x, nw, nb, depth=depth))
    want, margin = margins(x, nw, nb, depth)
    _, ties, _ = compare_idx(label, leaf, want, margin)
    return leaf, ties


def router_row(label, x, nw, nb, depth=DEPTH) -> dict:
    """The router's row on one input (``routed``'s checks, device and loop
    times, the plain version, the bound); and on a line of its own two
    yardsticks, timed the same ways: ``torch.addmm`` of the logits alone
    (no single PyTorch call computes the descent, so the row has no
    library time) and ``zero_()`` of the (B,) int32 output, the smallest
    launch."""
    from repro_torch.kernels.tree_router import kernel as trk, ref as trr
    _, ties = routed(label, x, nw, nb, depth)
    row = kernel_row(0.0, lambda: trk.tree_router(x, nw, nb, depth=depth),
                     lambda: trr.tree_router_ref(x, nw, nb, depth=depth),
                     router_bound(x.shape[0], nw.shape[0], x.shape[1], depth,
                                  x.dtype))
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    logits = lambda: torch.addmm(nb, x, nw.T)
    log(f"{label} yardsticks {str(x.dtype):15s} torch.addmm logits "
        f"{device_ms(logits):.4f} ms (loop {time_ms(logits):.4f}); zero_ of the "
        f"output {device_ms(out.zero_):.4f} ms (loop {time_ms(out.zero_):.4f})")
    return dict(row, near_ties=ties)


def grouped_rows(label, xg, up_w, wd, gs, act, dtype, timed=True):
    """The grouped up projection on xg (E, C, d), the dual kernel on up_w =
    (wg, wu) under SwiGLU, else ``grouped_matmul`` with ``act`` on up_w =
    (w1,), then ``grouped_matmul`` down on its output, each called twice
    (bit-identical) and held against its plain version.  Returns the hidden
    and, when ``timed``, a row for each (``torch.bmm`` the down
    projection's library call)."""
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    C, d = xg.shape[1:]
    L, O = wd.shape[1:]
    if act == "swiglu":
        up_name = "grouped_matmul_dual"
        up = lambda: gk.grouped_matmul_dual(xg, *up_w, gs)
        up_ref = lambda: gr.grouped_matmul_dual_ref(xg, *up_w, gs)
    else:
        up_name = "grouped_matmul (up)"
        up = lambda: gk.grouped_matmul(xg, up_w[0], gs, act=act)
        up_ref = lambda: gr.grouped_matmul_ref(xg, up_w[0], gs, act=act)
    path = full_width_path(dtype)
    h = twice_on(f"{label} {up_name}", up, gk.GMM_DUAL if act == "swiglu" else gk.GMM, path)
    err_up = compare(f"{label} {up_name}", h, up_ref(), dtype)
    down = lambda: gk.grouped_matmul(h, wd, gs)
    down_ref = lambda: gr.grouped_matmul_ref(h, wd, gs)
    err_down = compare(f"{label} grouped_matmul",
                       twice_on(f"{label} grouped_matmul", down, gk.GMM, path),
                       down_ref(), dtype)
    if not timed:
        return h, {}
    return h, {up_name: dict(kernel_row(err_up, up, up_ref,
                                        grouped_bound(gs, C, d, L, len(up_w), dtype)),
                             plan=plan_tag(gk.launch_plan(xg, up_w))),
               "grouped_matmul": dict(kernel_row(err_down, down, down_ref,
                                                 grouped_bound(gs, C, L, O, 1, dtype),
                                                 library=lambda: torch.bmm(h, wd)),
                                      plan=plan_tag(gk.launch_plan(h, (wd,))))}


def gathered_rows(label, x, up_w, wd, idx, act, dtype, timed=True):
    """The gathered up projection on x (B, d) routed to leaves idx (the
    dual kernel under SwiGLU, as ``grouped_rows``), then the gathered down
    projection on its output, each called twice (bit-identical) and held
    against its plain version.  Returns the hidden and, when ``timed``, a
    row for each (no library call computes a gathered matmul)."""
    from repro_torch.kernels.fused_fff import kernel as fk, ref as fr
    d, (L, O) = x.shape[1], wd.shape[1:]
    if act == "swiglu":
        up_name = "gathered_matmul_dual"
        up = lambda: fk.gathered_matmul_dual(x, *up_w, idx)
        up_ref = lambda: fr.gathered_matmul_dual_ref(x, *up_w, idx)
    else:
        up_name = "gathered_matmul (up)"
        up = lambda: fk.gathered_matmul(x, up_w[0], idx, act=act)
        up_ref = lambda: fr.gathered_matmul_ref(x, up_w[0], idx, act=act)
    h = twice(f"{label} {up_name}", up)
    err_up = compare(f"{label} {up_name}", h, up_ref(), dtype)
    down = lambda: fk.gathered_matmul(h, wd, idx)
    down_ref = lambda: fr.gathered_matmul_ref(h, wd, idx)
    err_down = compare(f"{label} gathered_matmul", twice(f"{label} gathered_matmul", down),
                       down_ref(), dtype)
    if not timed:
        return h, {}
    distinct = int(torch.unique(idx).numel())
    rows = {up_name: kernel_row(err_up, up, up_ref,
                                gathered_bound(idx, d, L, len(up_w), dtype)),
            "gathered_matmul": kernel_row(err_down, down, down_ref,
                                          gathered_bound(idx, L, O, 1, dtype))}
    return h, {k: dict(r, distinct_leaves=distinct) for k, r in rows.items()}


def decode_checked(label, x, nw, nb, leaves, depth, act, dtype, master_w=None):
    """The fused decode kernel on x (B, d) over a forest (nw (T, N, d), nb
    (T, N), leaves (T, E, ...) each; ``master_w`` the optional master
    leaf), called twice (bit-identical, both launches counted on the TMA
    path: every caller's shapes are full width): every tree's leaf indices
    exact against the float32 descent off near-ties, the output against the
    plain version on the rows whose every tree agreed.  Returns (the call,
    the plain version, y, leaf indices, max |err|, near-ties)."""
    from repro_torch.kernels.fused_decode import kernel as fdk, ref as fdr
    call = lambda: fdk.fused_forest_decode(x, nw, nb, leaves, depth=depth, act=act,
                                           master_w=master_w)
    plain = lambda: fdr.fused_decode_ref(x, nw, nb, leaves, depth=depth, act=act,
                                         master_w=master_w)
    before = dict(fdk.KERNEL.paths)
    y, idx = twice(f"{label} fused_forest_decode", call)
    grew = {k: v - before.get(k, 0) for k, v in fdk.KERNEL.paths.items()
            if v != before.get(k, 0)}
    if grew != {"tma": 2}:
        raise AssertionError(f"{label} fused_forest_decode: launches by path {grew}, "
                             f"expected 2 on 'tma'")
    y_ref, idx_ref = plain()
    agree, ties = torch.ones(x.shape[0], dtype=torch.bool, device=x.device), 0
    for t in range(nw.shape[0]):
        _, margin = margins(x, nw[t], nb[t], depth)
        a, n, _ = compare_idx(f"{label} fused_forest_decode (tree {t})", idx[:, t],
                              idx_ref[:, t], margin)
        agree, ties = agree & a, ties + n
    err = compare(f"{label} fused_forest_decode", y, y_ref, dtype, rows=agree)
    return call, plain, y, idx, err, ties


def decode_graph_check(label, run, x1, x2) -> tuple:
    """``run(x)`` -> (y, leaf_idx) of the fused decode kernels captured in a
    CUDA graph on a copy of x1; with x2 (routed otherwise) copied into the
    captured input the replay must give the eager ``run(x2)`` bit for bit,
    leaf indices too.  Returns the leaf indices of x2 and of x1."""
    xin = x1.clone()
    y_eager, idx_eager = run(x2)
    run(xin)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g, idx_g = run(xin)
    graph.replay()
    torch.cuda.synchronize()
    idx_1 = idx_g.clone()
    xin.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    if torch.equal(idx_1, idx_eager):
        raise AssertionError(f"{label} fused decode graph check: x1 and x2 route alike")
    if not (torch.equal(y_g, y_eager) and torch.equal(idx_g, idx_eager)):
        raise AssertionError(f"{label} fused decode graph check: the replay on x2 differs "
                             f"from the eager call on x2")
    del graph
    return idx_eager, idx_1


def decode_row(label, x, nw, nb, leaves, depth, act, dtype) -> dict:
    """``decode_checked`` of the fused decode kernel and its row, with the
    plan the call took (logged), and ``decode_graph_check`` on x and -x
    (every logit negated, so each token takes its mirror leaf off ties)."""
    from repro_torch.kernels.fused_decode import kernel as fdk
    call, plain, _, idx, err, ties = decode_checked(label, x, nw, nb, leaves, depth, act,
                                                    dtype)
    decode_graph_check(label, lambda v: fdk.fused_forest_decode(
        v, nw, nb, leaves, depth=depth, act=act), x, -x)
    row = kernel_row(err, call, plain, decode_bound(idx, nw.shape[1], x.shape[1],
                                                    leaves[-1].shape[2], len(leaves), dtype))
    distinct = sum(int(torch.unique(idx[:, t]).numel()) for t in range(nw.shape[0]))
    tag = decode_plan_tag(fdk.launch_plan(x, nw, leaves, depth, None))
    log(f"{label} fused_forest_decode {str(dtype):15s} plan: {tag}")
    return dict(row, near_ties=ties, distinct_leaves=distinct, plan=tag)


def pick_rows(gen, n, nw, nb, depth, dtype, pool=512):
    """n rows of x (d,) each routed away from any near-tie by the float32
    descent of one tree (nw (N, d), nb (N,)): ``pick_rows(...)[0]`` all to
    the leaf most of a pool reaches, ``[1]`` to n distinct leaves."""
    dev = nw.device
    x = torch.randn((pool, nw.shape[1]), generator=gen, device=dev).to(dtype)
    leaf, margin = margins(x, nw, nb, depth)
    ok = margin >= 10 * NEAR_TIE
    common = int(torch.mode(leaf[ok]).values)
    same = torch.nonzero(ok & (leaf == common)).flatten()[:n]
    firsts = [int(torch.nonzero(ok & (leaf == e)).flatten()[0])
              for e in torch.unique(leaf[ok]).tolist()][:n]
    if same.numel() < n or len(firsts) < n:
        raise AssertionError(f"pick_rows: a pool of {pool} rows cannot give {n} tokens on "
                             f"one leaf and on {n} distinct leaves")
    return x[same], x[torch.tensor(firsts, device=dev)]


def decode_cases(gen, dtype, nw, nb, leaves) -> None:
    """The fused decode kernel at the main path's full width beyond the
    table's batch of 8: batch 1, 8 tokens on one leaf, 8 on 8 distinct
    leaves, 24 (the cluster engine's slots), 64, and 8 with a master leaf of
    width 1024; each through ``decode_checked`` (twice, bit-identical, TMA
    path, leaf indices exact off near-ties, the plain version's output) and
    timed.  Then the graph check: the call captured in a CUDA graph on x1,
    x2 (routed otherwise) copied into the captured input, the replay must
    give the eager call's output on x2 bit for bit, leaf indices too."""
    from repro_torch.kernels.fused_decode import kernel as fdk
    dev = torch.device("cuda")
    one, distinct = pick_rows(gen, DECODE_B, nw[0], nb[0], DEPTH, dtype)
    randn = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen, device=dev)
                                       * scale).to(dtype)
    master = (randn(D, L_W, scale=D ** -0.5), randn(D, L_W, scale=D ** -0.5),
              randn(L_W, O, scale=L_W ** -0.5))
    cases = [("batch 1", randn(1, D), None), (f"{DECODE_B} on one leaf", one, None),
             (f"{DECODE_B} on {DECODE_B} leaves", distinct, None),
             (f"batch {SLOTS * 3}", randn(SLOTS * 3, D), None), ("batch 64", randn(64, D), None),
             (f"batch {DECODE_B} + master leaf", randn(DECODE_B, D), master)]
    for name, x, mst in cases:
        label = f"[kernels] fused decode, {name}"
        call, _, _, idx, err, ties = decode_checked(label, x, nw, nb, leaves, DEPTH, "swiglu",
                                                    dtype, master_w=mst)
        p = fdk.launch_plan(x, nw, leaves, DEPTH, mst)
        b, by = decode_bound(idx, N_NODES, D, L_W, 3, dtype)
        if mst is not None:   # the master leaf's three matrices, read once
            b += 3 * D * L_W * (torch.finfo(dtype).bits // 8) / HBM_BYTES_PER_S * 1e3
        ms = device_ms(call)
        log(f"{label} {str(dtype):15s} {ms:.4f} ms (bound {b:.4f}, {by}, kernel/bound "
            f"{ms / b:.2f}); distinct leaves {int(torch.unique(idx).numel())}; max|err| "
            f"{err:.3e}; near-ties {ties}; plan {decode_plan_tag(p)}")
    idx_2, idx_1 = decode_graph_check(
        f"[kernels] {dtype}", lambda v: fdk.fused_forest_decode(v, nw, nb, leaves, depth=DEPTH,
                                                                act="swiglu"),
        randn(DECODE_B, D), distinct)
    log(f"[kernels] fused decode {str(dtype):15s} graph check: captured on x1, replayed "
        f"on x2 (leaves {idx_2.flatten().tolist()} against x1's {idx_1.flatten().tolist()}):"
        f" output and leaf indices equal the eager call's bit for bit")


def phase_kernels(gen) -> dict:
    dev = torch.device("cuda")
    rows = {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        # -- tree_router: prefill routing, 1024 tokens x 15 nodes x 6144
        B = PREFILL_B * PREFILL_S
        x = randn(B, D, dtype=dtype)
        nw = randn(N_NODES, D, scale=D ** -0.5, dtype=dtype)
        nb = randn(N_NODES, scale=0.1, dtype=dtype)
        rows[("tree_router", dtype)] = router_row("[kernels] tree_router", x, nw, nb)

        # -- grouped GEMMs: 1024 routed tokens in 16 capacity-128 groups
        C = max(128, math.ceil(2 * math.ceil(B / E) / 128) * 128)   # leaf_gemm capacity
        leaf = torch.randint(0, E, (B,), generator=gen, device=dev)
        gs = torch.bincount(leaf, minlength=E).clamp(max=C).to(torch.int32)
        mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
        xg = randn(E, C, D, dtype=dtype) * mask
        wg = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wu = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wd = randn(E, L_W, O, scale=L_W ** -0.5, dtype=dtype)
        _, r = grouped_rows("[kernels]", xg, (wg, wu), wd, gs, "swiglu", dtype)
        rows.update({(k, dtype): v for k, v in r.items()})
        del xg
        grouped_slab(dtype, wg, wu, wd)
        router_slab(dtype, nw, nb)

        # -- fused forest decode: batch 8, one tree of 16 SwiGLU leaves
        xd = randn(DECODE_B, D, dtype=dtype)
        rows[("fused_forest_decode", dtype)] = decode_row(
            "[kernels]", xd, nw[None], nb[None], (wg[None], wu[None], wd[None]), DEPTH,
            "swiglu", dtype)
        decode_cases(torch.Generator(device=dev).manual_seed(3), dtype, nw[None], nb[None],
                     (wg[None], wu[None], wd[None]))
        del wg, wu, wd
        torch.cuda.empty_cache()
    log_rows(rows)
    return rows


def grouped_slab(dtype, wg, wu, wd, tokens=SLAB_B) -> None:
    """Both grouped kernels at an engine admission slab of 256 tokens in
    the main path's capacity-128 groups (~16 tokens a leaf, so every block
    has one live 64-row half): agreement and times, logged beside the
    table's 1024-token rows.  Its own generator leaves the table's inputs
    as they were."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    C = 128
    leaf = torch.randint(0, E, (tokens,), generator=gen, device=dev)
    gs = torch.bincount(leaf, minlength=E).clamp(max=C).to(torch.int32)
    mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
    xg = (torch.randn((E, C, D), generator=gen, device=dev) * mask).to(dtype)
    _, r = grouped_rows(f"[kernels] @{tokens}", xg, (wg, wu), wd, gs, "swiglu", dtype)
    dual, down = r["grouped_matmul_dual"], r["grouped_matmul"]
    log(f"[kernels] grouped @{tokens} tokens {str(dtype):15s} (group sizes "
        f"{min(gs.tolist())}-{max(gs.tolist())}): grouped_matmul_dual {dual['ms']:.4f} ms"
        f" (bound {dual['bound_ms']:.4f}, kernel/bound {dual['ms'] / dual['bound_ms']:.2f},"
        f" max|err| {dual['max_abs_err']:.3e}); grouped_matmul {down['ms']:.4f} ms (bound "
        f"{down['bound_ms']:.4f}, kernel/bound {down['ms'] / down['bound_ms']:.2f}, max|err| "
        f"{down['max_abs_err']:.3e}); torch.bmm {down['library_ms']:.4f} ms")


def router_slab(dtype, nw, nb, tokens=SLAB_B) -> None:
    """The router at an engine admission slab of 256 tokens (4 token tiles,
    32 blocks), logged beside the grouped slab line; its own generator
    leaves the table's inputs as they were."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((tokens, D), generator=gen, device="cuda").to(dtype)
    r = router_row(f"[kernels] tree_router@{tokens}", x, nw, nb)
    log(f"[kernels] tree_router @{tokens} tokens {str(dtype):15s} {r['ms']:.4f} ms "
        f"(loop {r['loop_ms']:.4f}; bound {r['bound_ms']:.4f}, kernel/bound "
        f"{r['ms'] / r['bound_ms']:.2f}; plain {r['plain_ms']:.4f}; near-ties "
        f"{r['near_ties']})")


def phase_gathered(gen) -> dict:
    """The verify slab's kernels: the gathered leaf matmuls at 32 tokens,
    6144 -> 1024 (the SwiGLU up-projection, and gathered_matmul with every
    activation) and 1024 -> 6144 (the down-projection), E = 16, under a
    random routing, every token on one leaf, 16 tokens on 16 distinct
    leaves, a 64-token slab with 0, 1, 31, 32, 33 or 64 tokens on one leaf
    and a 33-token slab, each call twice and bit-identical; the table rows
    are timed on the random routing, whose bound counts each distinct
    routed leaf once, and the one-leaf and distinct routings and a
    read-rate yardstick are logged beside them; and the tree router at 32
    tokens (a row of its own, "tree_router@32", beside the prefill-shape
    row)."""
    from repro_torch.kernels.fused_fff import kernel as fk, ref as fr

    dev = torch.device("cuda")
    rows = {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        sz = 2 if dtype == torch.bfloat16 else 4
        x = randn(VERIFY_B, D, dtype=dtype)
        nw = randn(N_NODES, D, scale=D ** -0.5, dtype=dtype)
        nb = randn(N_NODES, scale=0.1, dtype=dtype)
        rows[("tree_router@32", dtype)] = router_row("[kernels] tree_router@32", x, nw, nb)
        wg = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wu = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wd = randn(E, L_W, O, scale=L_W ** -0.5, dtype=dtype)
        i32 = dict(device=dev, dtype=torch.int32)
        routings = {
            "random": torch.randint(0, E, (VERIFY_B,), generator=gen, **i32),
            "one leaf": torch.full((VERIFY_B,), 5, **i32),
            "distinct": torch.randperm(E, generator=gen, device=dev).to(torch.int32)}
        # the count edges draw from a generator of their own, which leaves
        # the next dtype's table inputs as they were
        egen = torch.Generator(device=dev).manual_seed(5)
        xe = (torch.randn((EDGE_B, D), generator=egen, device=dev)).to(dtype)
        for n in LEAF_EDGES:
            routings[f"{n} of {EDGE_B} on one leaf"] = edge_routing(egen, n)
        routings["33 tokens"] = torch.randint(0, E, (33,), generator=egen, **i32)
        times = {}
        for rname, idx in routings.items():
            xb = (x if idx.numel() <= VERIFY_B else xe)[:idx.numel()]
            h, _ = gathered_rows(f"[kernels] ({rname})", xb, (wg, wu), wd, idx, "swiglu",
                                 dtype, timed=False)
            for act in ACTS:
                compare(f"gathered_matmul {act} 6144->1024 ({rname})",
                        twice(f"gathered_matmul {act} ({rname})",
                              lambda: fk.gathered_matmul(xb, wg, idx, act=act)),
                        fr.gathered_matmul_ref(xb, wg, idx, act=act), dtype)
            if rname in ("one leaf", "distinct"):
                times[rname] = (device_ms(lambda: fk.gathered_matmul_dual(xb, wg, wu, idx)),
                                device_ms(lambda: fk.gathered_matmul(h, wd, idx)))
        idx = routings["random"]
        _, r = gathered_rows("[kernels]", x, (wg, wu), wd, idx, "swiglu", dtype)
        rows.update({(k, dtype): v for k, v in r.items()})
        distinct = r["gathered_matmul"]["distinct_leaves"]
        # read-rate yardstick: one library read of the same weight bytes (the
        # first `distinct` leaves); no single PyTorch call computes a
        # gathered matmul, so this is no library_ms
        flat_g, flat_u = wg[:distinct].reshape(-1), wu[:distinct].reshape(-1)
        flat_d = wd[:distinct].reshape(-1)
        read_d = device_ms(lambda: (flat_g.sum(), flat_u.sum()))
        read = device_ms(flat_d.sum)
        dual_b, down_b = 2 * flat_g.numel() * sz, flat_d.numel() * sz
        log(f"[kernels] gathered {str(dtype):15s} device ms by routing: dual random "
            f"{rows[('gathered_matmul_dual', dtype)]['ms']:.4f} / one leaf "
            f"{times['one leaf'][0]:.4f} / distinct {times['distinct'][0]:.4f}; down "
            f"{rows[('gathered_matmul', dtype)]['ms']:.4f} / {times['one leaf'][1]:.4f} / "
            f"{times['distinct'][1]:.4f}; read-rate yardstick torch.sum over the "
            f"{distinct} routed leaves' bytes: wg+wu {dual_b / 1e6:.1f} MB {read_d:.4f} ms "
            f"({dual_b / read_d / 1e9:.2f} TB/s; dual kernel "
            f"{dual_b / rows[('gathered_matmul_dual', dtype)]['ms'] / 1e9:.2f}), wd "
            f"{down_b / 1e6:.1f} MB {read:.4f} ms ({down_b / read / 1e9:.2f} TB/s; down "
            f"kernel {down_b / rows[('gathered_matmul', dtype)]['ms'] / 1e9:.2f})")
        del wg, wu, wd, flat_g, flat_u, flat_d
        torch.cuda.empty_cache()
    log_rows(rows)
    log(f"[kernels] gathered kernels agree in {len(routings)} routings x "
        f"{len(ACTS) + 2} products per dtype, each called twice with "
        f"bit-identical outputs")
    return rows


def kernel_of(row_name: str) -> str:
    """The kernel a row times: "tree_router@32" and "grouped_matmul (up)"
    are rows of tree_router and grouped_matmul."""
    return row_name.split(" ")[0].split("@")[0]


def log_rows(rows, tag="[kernels]", counts=None) -> None:
    """One line per row; rows keyed by (name, dtype) or by name, and with
    ``counts`` each row's kernel's serve-loop launches."""
    for key, r in rows.items():
        name, dtype = key if isinstance(key, tuple) else (key, None)
        log(f"{tag} {name:24s} " + (f"{str(dtype):15s} " if dtype else "")
            + f"max|err| {r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms (loop "
            f"{r['loop_ms']:.4f})  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, kernel/bound "
            f"{r['ms'] / r['bound_ms']:.2f})  library "
            + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "n/a")
            + (f"  serve launches {counts.get(kernel_of(name), 0)}" if counts else "")
            + (f"  capacity {r['capacity']}" if "capacity" in r else "")
            + (f"  plan {r['plan']}" if "plan" in r else "")
            + (f"  near-ties {r['near_ties']}" if "near_ties" in r else "")
            + (f"  distinct leaves {r['distinct_leaves']}" if "distinct_leaves" in r else ""))


def gathered_pair(label, x, w, w2, idx, act, dtype):
    """Both gathered kernels on one input against their plain versions,
    each called twice with bit-identical outputs."""
    from repro_torch.kernels.fused_fff import kernel as fk, ref as fr
    y = twice(f"gathered_matmul {label}", lambda: fk.gathered_matmul(x, w, idx, act=act))
    compare(f"gathered_matmul {label}", y, fr.gathered_matmul_ref(x, w, idx, act=act), dtype)
    y2 = twice(f"gathered_matmul_dual {label}", lambda: fk.gathered_matmul_dual(x, w, w2, idx))
    compare(f"gathered_matmul_dual {label}", y2, fr.gathered_matmul_dual_ref(x, w, w2, idx), dtype)
    return y, y2


def phase_ragged(gen) -> None:
    """The kernels' masked and element-wise paths, at the CPU tests' small
    sizes (which the full-width shapes never reach): odd batches, D = 20
    and 24, leaf widths 4 and 8, a two-tree forest, the master leaf, every
    activation; then the grouped kernels' tile edges in both dtypes
    (``grouped_edges``) and the float32 forms' (``grouped_f32_edges``)."""
    from repro_torch.kernels.fused_decode import kernel as fdk, ref as fdr
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    from repro_torch.kernels.tree_router import kernel as trk

    dev = torch.device("cuda")
    checked = 0

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # D = 20 takes the element-wise paths; D = 24 (a multiple of 8) the
    # 16-byte ones wherever the other widths allow
    for d, dtype in [(d, t) for d in (20, 24)
                     for t in (torch.float32, torch.bfloat16)]:
        for B, depth in ((1, 1), (7, 2), (37, 4)):
            N = 2 ** depth - 1
            x = randn(B, d, dtype=dtype)
            nw, nb = randn(N, d, scale=d ** -0.5, dtype=dtype), randn(N, scale=0.1, dtype=dtype)
            want, margin = margins(x, nw, nb, depth)
            compare_idx("tree_router (ragged)", trk.tree_router(x, nw, nb, depth=depth),
                        want, margin)
            checked += 1
        for H, act in ((4, "gelu"), (8, "relu"), (8, "silu")):
            E, C = 3, 16
            gs = torch.tensor([0, 5, 16], dtype=torch.int32, device=dev)
            mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
            x = randn(E, C, d, dtype=dtype) * mask
            w, w2 = (randn(E, d, H, scale=d ** -0.5, dtype=dtype) for _ in range(2))
            compare("grouped_matmul (ragged)",
                    twice("grouped_matmul (ragged)",
                          lambda: gk.grouped_matmul(x, w, gs, act=act)),
                    gr.grouped_matmul_ref(x, w, gs, act=act), dtype)
            compare("grouped_matmul_dual (ragged)",
                    twice("grouped_matmul_dual (ragged)",
                          lambda: gk.grouped_matmul_dual(x, w, w2, gs)),
                    gr.grouped_matmul_dual_ref(x, w, w2, gs), dtype)
            checked += 2
        for act, leaf, master in (("gelu", 4, False), ("swiglu", 8, True),
                                  ("relu", 8, True)):
            T, depth, B = 2, 3, 7
            N, E = 2 ** depth - 1, 2 ** depth
            x = randn(B, d, dtype=dtype)
            nw, nb = randn(T, N, d, scale=d ** -0.5, dtype=dtype), randn(T, N, scale=0.1, dtype=dtype)
            n_up = 2 if act == "swiglu" else 1
            leaves = tuple(randn(T, E, d, leaf, scale=d ** -0.5, dtype=dtype)
                           for _ in range(n_up)) + (randn(T, E, leaf, d, scale=leaf ** -0.5, dtype=dtype),)
            mw = 5
            mst = (tuple(randn(d, mw, scale=d ** -0.5, dtype=dtype) for _ in range(n_up))
                   + (randn(mw, d, scale=mw ** -0.5, dtype=dtype),)) if master else None
            y, idx = twice("fused_forest_decode (ragged)", lambda: fdk.fused_forest_decode(
                x, nw, nb, leaves, depth=depth, act=act, master_w=mst))
            y_ref, idx_ref = fdr.fused_decode_ref(x, nw, nb, leaves, depth=depth, act=act, master_w=mst)
            agree = torch.ones(B, dtype=torch.bool, device=dev)
            for t in range(T):
                _, margin = margins(x, nw[t], nb[t], depth)
                a, _, _ = compare_idx("fused_forest_decode (ragged)", idx[:, t], idx_ref[:, t], margin)
                agree &= a
            compare("fused_forest_decode (ragged)", y, y_ref, dtype, rows=agree)
            decode_graph_check("(ragged)", lambda v: fdk.fused_forest_decode(
                v, nw, nb, leaves, depth=depth, act=act, master_w=mst), x, -x)
            checked += 1
        # gathered: H = 8 takes the 16-byte loads in both dtypes, 12 in
        # float32 only, 13 in neither; B = 7 routes two tokens outside
        # [0, E), whose rows must come out zero
        for B, H, act in ((1, 8, "gelu"), (7, 12, "relu"), (31, 13, "silu")):
            E = 3
            x = randn(B, d, dtype=dtype)
            w, w2 = (randn(E, d, H, scale=d ** -0.5, dtype=dtype) for _ in range(2))
            idx = torch.randint(0, E, (B,), generator=gen, device=dev, dtype=torch.int32)
            if B == 7:
                idx[0], idx[-1] = -1, E
            y, y2 = gathered_pair("(ragged)", x, w, w2, idx, act, dtype)
            if B == 7 and (float(y[[0, -1]].abs().max()) != 0.0
                           or float(y2[[0, -1]].abs().max()) != 0.0):
                raise AssertionError("gathered kernels: an index outside [0, E) "
                                     "did not give a zero row")
            checked += 2
        # the per-leaf token counts at the per-pass cap: 64 tokens with 0,
        # 1, 31, 32, 33 or 64 of them on one leaf, and a 33-token slab; H = 8
        # (16-byte loads in both dtypes) and 13 (element-wise)
        for H in (8, 13):
            w, w2 = (randn(4, d, H, scale=d ** -0.5, dtype=dtype) for _ in range(2))
            cases = [(f"{n} on one leaf", edge_routing(gen, n, leaf=2, num_leaves=4))
                     for n in LEAF_EDGES]
            cases.append(("33 tokens", torch.randint(0, 4, (33,), generator=gen, device=dev,
                                                     dtype=torch.int32)))
            for label, idx in cases:
                gathered_pair(f"(ragged, {label}, H {H})", randn(idx.numel(), d, dtype=dtype),
                              w, w2, idx, "gelu", dtype)
                checked += 2
    checked += grouped_edges(gen)
    checked += grouped_f32_edges(gen)
    torch.cuda.synchronize()
    log(f"[ragged] {checked} small kernel cases agree with their plain "
        f"versions (fp32 and bf16)")
    overflow_pass_rows(gen)


def overflow_pass_rows(gen) -> None:
    """Both grouped kernels at the overflow pass of a 1024-token slab
    (``leaf_gemm.ops.fff_leaf_mlp``): capacity 896 = round_up(1024 - 128,
    32) at the main path's widths, the 16 leaves' group sizes 0, 1, 31,
    33 and 896 and 0 for the other 11 (most leaves dead, as most of the
    pass's are), in both dtypes: held against the plain versions (each
    call twice, bit-identical, on its path) and timed."""
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    dev = torch.device("cuda")
    C = gemm_ops.overflow_rows(PREFILL_B * PREFILL_S, 128)
    sizes = [0, 1, 31, 33, C] + [0] * (E - 5)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
    for dtype in (torch.bfloat16, torch.float32):
        xg = (torch.randn((E, C, D), generator=gen, device=dev) * mask).to(dtype)
        wg, wu = ((torch.randn((E, D, L_W), generator=gen, device=dev)
                   * D ** -0.5).to(dtype) for _ in range(2))
        wd = (torch.randn((E, L_W, O), generator=gen, device=dev) * L_W ** -0.5).to(dtype)
        _, rows = grouped_rows(f"[ragged] overflow pass C {C}", xg, (wg, wu), wd, gs,
                               "swiglu", dtype)
        log_rows({(f"{k} @overflow C {C}", dtype): r for k, r in rows.items()},
                 tag=f"[ragged] group sizes {sizes[:5]} + {E - 5} x 0:")
        del xg, wg, wu, wd
    torch.cuda.empty_cache()


def phase_router(gen) -> None:
    """The router wherever its design branches, each case called twice and
    bit-identical (both forms sum in a fixed order) and counted on the form
    ``plan`` picks.  The cluster form: every depth 1-8 (one 8-node tile per
    warp up to depth 4, up to 8 tiles at depths 5-7, 16 at depth 8), D =
    6144 and the CPU tests' 20 (element-wise copies) and 24 (16-byte
    copies), B = 1, 31, 33, 65, 256 and 1031 (partial 64-token tiles, one
    and several clusters), an x one element off its alignment (element-wise
    copies at full width), and all-left and all-right routings (zero node
    weights, bias -1 or +1); both dtypes (float32 at D 20 and 24 takes the
    resident form).  The resident form (float32, ``RESIDENT_DS``): D 4, 32,
    64, 100 (off 4: element-wise loads), 128 (the ViT's), 200 and 500 (16
    and 32 lanes a token), 1024 (its widest: 32 lanes of 8 float4 pieces;
    depths 6-8 pass its shared memory and take the cluster form) and 1025
    (past it: the cluster form), depths 1-8, B = 1, 31, 33, 65, 1031 and
    16384 (ragged lane groups; 16384 down 4 or more levels at D <= 128
    takes 4 lanes a token in the flipped order, the rest 8 or more), an x
    one element off its alignment and all-left and all-right routings."""
    from repro_torch.kernels.tree_router import kernel as trk
    dev = torch.device("cuda")
    checked = ties = 0
    forms = {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def check(label, x, nw, nb, depth):
        path = trk.plan(x.shape[0], x.shape[1], depth, x.dtype).path
        got = twice_on(label, lambda: trk.tree_router(x, nw, nb, depth=depth), trk.KERNEL,
                       path)
        forms[path] = forms.get(path, 0) + 1
        want, margin = margins(x, nw, nb, depth)
        return got, compare_idx(label, got, want, margin)[1]

    def edges(d, depth, dtype):
        """An x off its alignment; all-left and all-right routings."""
        nonlocal ties
        N = 2 ** depth - 1
        nw = randn(N, d, scale=d ** -0.5, dtype=dtype)
        nb = randn(N, scale=0.1, dtype=dtype)
        x = randn(33 * d + 1, dtype=dtype)[1:].view(33, d)
        _, t = check(f"tree_router (unaligned x, D {d}, depth {depth}, {dtype})", x, nw, nb,
                     depth)
        ties += t
        x = randn(1031, d, dtype=dtype)
        for bias, leaf in ((-1.0, 0), (1.0, 2 ** depth - 1)):
            nw = torch.zeros(N, d, dtype=dtype, device=dev)
            nb = torch.full((N,), bias, dtype=dtype, device=dev)
            got, _ = check(f"tree_router (bias {bias}, D {d}, depth {depth}, {dtype})",
                           x, nw, nb, depth)
            if not bool((got == leaf).all()):
                raise AssertionError(f"tree_router: zero weights and bias {bias} "
                                     f"must send every token to leaf {leaf}")
        return 3

    for dtype in (torch.float32, torch.bfloat16):
        for depth in range(1, 9):
            N = 2 ** depth - 1
            for d in (D, 20, 24):
                nw = randn(N, d, scale=d ** -0.5, dtype=dtype)
                nb = randn(N, scale=0.1, dtype=dtype)
                for B in (1, 31, 33, 65, 256, 1031):
                    _, t = check(f"tree_router (depth {depth}, D {d}, B {B}, {dtype})",
                                 randn(B, d, dtype=dtype), nw, nb, depth)
                    ties += t
                    checked += 1
        for depth in (4, 8):
            checked += edges(D, depth, dtype)
    for d in RESIDENT_DS:
        for depth in range(1, 9):
            N = 2 ** depth - 1
            nw, nb = randn(N, d, scale=d ** -0.5), randn(N, scale=0.1)
            for B in (1, 31, 33, 65, 1031, 16384):
                _, t = check(f"tree_router (depth {depth}, D {d}, B {B}, float32)",
                             randn(B, d), nw, nb, depth)
                ties += t
                checked += 1
        for depth in (4, 8):
            checked += edges(d, depth, torch.float32)
    torch.cuda.synchronize()
    log(f"[router] {checked} router cases agree with the plain descent ({ties} "
        f"near-tie differences), each called twice with bit-identical outputs, "
        f"each on the form the plan picks (cases by form: {forms})")


def grouped_edges(gen) -> int:
    """The grouped kernels at their tile edges, every call twice (bit-
    identical) against its plain version and counted on the path the plan
    names: capacity 128 with group sizes 0, 1, 63, 64, 65, 127 and 128
    (empty, partial and full 64-row slices), also with D and H off the bf16
    kernels' 64-deep steps and 64-column atoms and with N 384; capacity 256
    (a whole leaf in one row tile) with 0, 1, 63, 64, 65, 127, 128, 129,
    192, 255 and 256; capacity 264 (past one 256-row tile); whisper-small's
    up projection (8 leaves, 768 -> 384 at capacity 256), whose units are
    too few for the card, so D is split; x holding non-zero rows past the
    group sizes, whose outputs must still be exactly zero; and an x 8 bytes
    off its alignment, which takes the masked path.  Every activation, both
    dtypes.  Returns the cases checked."""
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    dev = torch.device("cuda")
    checked, split_in = 0, set()
    edge, edge256 = [0, 1, 63, 64, 65, 127, 128], [0, 1, 63, 64, 65, 127, 128, 129, 192, 255, 256]
    # (C, group sizes, D, H, x past the sizes non-zero, x off 16 bytes)
    cases = [(128, edge, 256, 1024, False, False),
             (128, edge, 136, 200, False, False),
             (128, edge, 256, 384, False, False),
             (256, [0, 100, 200, 256], 192, 328, False, False),
             (256, edge256, 192, 328, False, False),
             (264, [0, 1, 255, 256, 257, 263, 264], 136, 200, False, False),
             (256, [128, 100, 150, 0, 256, 64, 1, 129], 768, 384, False, False),
             (256, edge256, 192, 328, True, False),
             (128, edge, 256, 1024, False, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for C, sizes, d, H, junk, off in cases:
            gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
            E_ = gs.numel()
            mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
            x = torch.randn((E_, C, d), generator=gen, device=dev)
            x = (x if junk else x * mask).to(dtype)
            if off:
                skip = 8 // x.element_size()
                buf = torch.empty(x.numel() + skip, dtype=dtype, device=dev)
                x = buf[skip:].view(E_, C, d).copy_(x)
            w, w2 = ((torch.randn((E_, d, H), generator=gen, device=dev) * d ** -0.5).to(dtype)
                     for _ in range(2))
            path = "masked" if off and dtype == torch.bfloat16 else full_width_path(dtype)
            tag = (f"C={C} D={d} H={H}" + (" x non-zero past the sizes" if junk else "")
                   + (" x off 16 bytes" if off else ""))
            if gk.launch_plan(x, (w,)).splits > 1:
                split_in.add(dtype)
            y2 = twice_on(f"grouped_matmul_dual (edges {tag})",
                          lambda: gk.grouped_matmul_dual(x, w, w2, gs), gk.GMM_DUAL, path)
            compare(f"grouped_matmul_dual (edges {tag})", y2,
                    gr.grouped_matmul_dual_ref(x, w, w2, gs), dtype)
            rows_past = ~mask[..., 0]
            for act in ACTS:
                y = twice_on(f"grouped_matmul {act} (edges {tag})",
                             lambda: gk.grouped_matmul(x, w, gs, act=act), gk.GMM, path)
                compare(f"grouped_matmul {act} (edges {tag})", y,
                        gr.grouped_matmul_ref(x, w, gs, act=act), dtype)
                if float(y[rows_past].abs().max()) != 0.0:
                    raise AssertionError(f"grouped_matmul {act} ({tag}): a row past its "
                                         f"group's size is not zero")
            if float(y2[rows_past].abs().max()) != 0.0:
                raise AssertionError(f"grouped_matmul_dual ({tag}): a row past its "
                                     f"group's size is not zero")
            checked += 1 + len(ACTS)
    if len(split_in) != 2:
        raise AssertionError(f"grouped edges: D was split only in {split_in}")
    return checked


def grouped_f32_edges(gen) -> int:
    """The float32 grouped kernels at the edges of their two forms (csrc/
    leaf_gemm.cu), every call twice (bit-identical) against its plain
    version and counted on the CUDA-core path: N = 1, 8, 16 and 32 (the
    narrow form: one column group, then 4 rows a thread), 33, 64 and 96
    (the wide form, N off its 128-column tile); group sizes 0, 1, 31, 32,
    33, 127 and 128 in one call of capacity 128 (dead, partial and whole
    32-row slices) and 0 to 264 at capacity 264 (three row tiles); D = 100
    (off the 32-float step) and 45 (off 4: element-wise copies); D = 1000
    with 7 leaves, whose blocks are too few for the card, so D is split; x
    holding non-zero rows past the group sizes, whose outputs must be
    exactly zero; an x 4 bytes off its 16-byte alignment; and N = 16 at
    capacities 264 and 384 with D = 512 (split), where the narrow form's
    longest row tile (512) fits a block's shared memory only without the
    dual form's second panel.  Every activation and the dual form.  Returns
    the cases checked."""
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    dev = torch.device("cuda")
    checked, split_in, longest = 0, set(), False
    edge, edge264 = [0, 1, 31, 32, 33, 127, 128], [0, 1, 31, 32, 33, 127, 128, 129, 255, 264]
    edge384 = edge264[:-1] + [256, 257, 383, 384]
    # (N, C, group sizes, D, x off 16 bytes)
    cases = ([(n, 128, edge, d, False) for n in (1, 8, 16, 32, 33, 64, 96) for d in (100, 45)]
             + [(n, 264, edge264, 100, False) for n in (16, 96)]
             + [(16, 264, edge264, 512, False), (16, 384, edge384, 512, False)]
             + [(n, 128, edge, 100, True) for n in (32, 96)]
             + [(n, 128, edge, 1000, False) for n in (16, 64)])
    for N, C, sizes, d, off in cases:
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        E_ = gs.numel()
        past = ~(torch.arange(C, device=dev)[None, :] < gs[:, None])
        x = torch.randn((E_, C, d), generator=gen, device=dev)   # non-zero past the sizes
        if off:
            buf = torch.empty(x.numel() + 1, device=dev)
            x = buf[1:].view(E_, C, d).copy_(x)
        w, w2 = (torch.randn((E_, d, N), generator=gen, device=dev) * d ** -0.5
                 for _ in range(2))
        p = gk.launch_plan(x, (w,))
        if p.splits > 1:
            split_in.add(gk.f32_form(N))
        longest |= p.rows == 512
        tag = (f"float32 {gk.f32_form(N)} N={N} C={C} D={d}" + (" x off 16 bytes" if off else ""))
        y2 = twice_on(f"grouped_matmul_dual ({tag})",
                      lambda: gk.grouped_matmul_dual(x, w, w2, gs), gk.GMM_DUAL, "cuda_cores")
        compare(f"grouped_matmul_dual ({tag})", y2, gr.grouped_matmul_dual_ref(x, w, w2, gs),
                torch.float32)
        outs = [y2]
        for act in ACTS:
            y = twice_on(f"grouped_matmul {act} ({tag})",
                         lambda: gk.grouped_matmul(x, w, gs, act=act), gk.GMM, "cuda_cores")
            compare(f"grouped_matmul {act} ({tag})", y, gr.grouped_matmul_ref(x, w, gs, act=act),
                    torch.float32)
            outs.append(y)
        if any(float(o[past].abs().max()) != 0.0 for o in outs):
            raise AssertionError(f"grouped kernels ({tag}): a row past its group's size "
                                 f"is not zero")
        checked += 1 + len(ACTS)
    if split_in != {"narrow", "wide"}:
        raise AssertionError(f"grouped float32 edges: D was split only in {split_in}")
    if not longest:
        raise AssertionError("grouped float32 edges: no narrow row tile of 512")
    return checked


@contextlib.contextmanager
def no_reference(api):
    """Fails the run if the reference backend ran inside the context."""
    calls = []
    ref_fn = api.get_backend("infer", "reference")
    api.register_backend("infer", "reference",
                         lambda *a: (calls.append(1), ref_fn(*a))[1])
    try:
        yield
    finally:
        api.register_backend("infer", "reference", ref_fn)
    if calls:
        raise AssertionError(f"the reference backend ran {len(calls)} times "
                             f"on the kernel path")


@contextlib.contextmanager
def kept_masks():
    """Yields a list that takes the kept mask of every grouped dispatch
    (one per site and tree) made inside the context: the tokens within
    their leaf's capacity, a device tensor, no sync (the rest take the
    overflow pass)."""
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    layout, layouts = gemm_ops._layout, []

    def recording_layout(x, li, slot, num_leaves, capacity, first=0, **kw):
        out = layout(x, li, slot, num_leaves, capacity, first, **kw)
        if first == 0 and kw.get("zero", True):   # an FFF site's, not a MoE site's
            layouts.append(out.kept)
        return out

    gemm_ops._layout = recording_layout
    try:
        yield layouts
    finally:
        gemm_ops._layout = layout


def slab_passes(cfg, tokens: int) -> int:
    """Each grouped GEMM's launches a tree of cfg's FFF sites for a slab of
    ``tokens`` on the cuda backend: 1, or 2 where the overflow pass runs
    (``leaf_gemm.ops.grouped_passes``, the shape alone decides)."""
    from repro_torch.core import api
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    return gemm_ops.grouped_passes(tokens, 2 ** cfg.period[0].ffn.fff_depth,
                                   api.DEFAULT_CAPACITY_INFER)


@contextlib.contextmanager
def slab_log():
    """Yields a list that takes (dispatch name, tokens, host seconds, first
    call of that name in its engine) for every admission slab an engine
    runs inside the context.  A slab ends in its host copy, so its host
    time is its latency; an engine's first slab of a name includes its
    graph's capture."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    slab, slabs = ContinuousBatchingEngine._slab, []

    def timed(self, name, toks, valid):
        seen = self.__dict__.setdefault("_smoke_slabs_seen", set())
        first = name not in seen
        seen.add(name)
        t0 = time.perf_counter()
        out = slab(self, name, toks, valid)
        slabs.append((name, toks.size, time.perf_counter() - t0, first))
        return out

    ContinuousBatchingEngine._slab = timed
    try:
        yield slabs
    finally:
        ContinuousBatchingEngine._slab = slab


def slab_summary(slabs) -> str:
    """The slabs' count and sum, the p50 of every call but an engine's first
    of each dispatch (replays, on graphs), and those first calls (a graph's
    capture included); host clock, ms."""
    rep = sorted(t for _, _, t, first in slabs if not first)
    firsts = {n: round(t * 1e3, 2) for n, _, t, first in slabs if first}
    p50 = f"{rep[len(rep) // 2] * 1e3:.2f}" if rep else "none"
    return (f"{len(slabs)} slabs, {sum(t for _, _, t, _ in slabs) * 1e3:.2f} ms in all; "
            f"{len(rep)} later calls p50 {p50} ms; first calls {firsts} ms")


def moe_site_configs(cfg) -> list:
    """The MoEConfig of each of cfg's MoE sites, one a layer that has one."""
    from repro_torch.nn import mlp
    return [mlp.make_moe_config(f, cfg.d_model, param_dtype=cfg.param_dtype,
                                accum_dtype=cfg.accum_dtype)
            for f in (cfg.period[i % len(cfg.period)].ffn for i in range(cfg.n_layers))
            if f.kind == "moe"]


def moe_passes(mcfg, tokens: int) -> int:
    """A MoE site's launches of each grouped GEMM (up and down) for a slab
    of ``tokens``: 1, or 2 where its overflow pass runs (the shape alone
    decides, ``core/moe.overflow_rows``)."""
    from repro_torch.core import moe
    return 1 + bool(moe.overflow_rows(tokens, mcfg))


def moe_buffer_bytes(mcfg, tokens: int) -> int:
    """The bytes of a MoE site's capacity-padded buffers for a slab of
    ``tokens`` (x (E, C, D), the hidden layer (E, C, H) and the output (E, C,
    O), first pass and overflow pass together)."""
    from repro_torch.core import moe
    rows = moe.capacity(tokens, mcfg) + moe.overflow_rows(tokens, mcfg)
    sz = torch.finfo(mcfg.param_dtype).bits // 8
    return (mcfg.num_experts * rows * (mcfg.dim_in + mcfg.expert_width + mcfg.dim_out)
            * sz)


def moe_capacity_tag(mcfg, tokens: int) -> str:
    """C, plus the overflow pass's rows where it runs."""
    from repro_torch.core import moe
    rows = moe.overflow_rows(tokens, mcfg)
    return f"{moe.capacity(tokens, mcfg)}" + (f" + overflow {rows}" if rows else "")


def phase_serve(common, api, serve_mod, cfg, params, label="[serve]"):
    """The fixed-batch loop (batch 8, prompt 128, 16 greedy decode steps) on
    the default infer backend, each kernel's launch count asserted, summed
    over the layers' own FFF and MoE sites (a layer without one adds
    nothing): per FFF tree the router once and the grouped kernels once a
    pass in the prefill (SwiGLU: dual and down; otherwise grouped_matmul
    up and down; two passes where the 1024 tokens exceed a leaf's
    capacity, the overflow pass's), the fused decode kernel once per FFF
    layer per step; per MoE site grouped_matmul up and down once a pass in
    the prefill and in each decode step.  The run on graphs must capture
    the decode step (every loop does), its first eager call and first
    replay under sync debug mode "error", and give the op-by-op run's
    tokens bit for bit.  Returns (counts, the serve result)."""
    from repro_torch.core import api as api_mod
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    from repro_torch.serving import graphs
    sites = [fc for fc in site_configs(cfg) if fc is not None]
    moes = moe_site_configs(cfg)
    trees = sum(fc.trees for fc in sites)
    passes = {id(fc): gemm_ops.grouped_passes(PREFILL_B * PREFILL_S, fc.num_leaves,
                                              api_mod.DEFAULT_CAPACITY_INFER)
              for fc in sites}
    swiglu = sum(fc.trees * passes[id(fc)] for fc in sites if fc.activation == "swiglu")
    up_down = sum(2 * fc.trees * passes[id(fc)] for fc in sites)
    moe_gemms = sum(2 * (moe_passes(m, PREFILL_B * PREFILL_S) + GEN * moe_passes(m, PREFILL_B))
                    for m in moes)
    want = {"fused_forest_decode": len(sites) * GEN, "tree_router": trees,
            "grouped_matmul_dual": swiglu, "grouped_matmul": up_down - swiglu + moe_gemms,
            "gathered_matmul": 0, "gathered_matmul_dual": 0}
    runs = {}
    # the decode step as a replayed CUDA graph (the default), then op by op
    for how, ctx in (("graphs", lambda: sync_checked(f"{label} serve")),
                     ("eager", graphs.disabled)):
        with kept_masks() as layouts, no_reference(api), ctx():
            common.reset_launch_counts()
            res = serve_mod.serve(cfg, batch=PREFILL_B, prompt_len=PREFILL_S,
                                  gen=GEN, device="cuda", params=params)
            counts = common.launch_counts()
        if counts != want:
            raise AssertionError(f"{label} serve ({how}): launch counts {counts} "
                                 f"!= expected {want}")
        runs[how] = (res, layouts, check_paths(common, f"{label} serve ({how})",
                                               counts, cfg.param_dtype))
    (res, layouts, paths), eager = runs["graphs"], runs["eager"][0]
    same = bool(torch.equal(res.tokens, eager.tokens))
    if res.graphs != {"decode": 1} or eager.graphs or not same:
        raise AssertionError(f"{label} serve: decode graphs {res.graphs} (op by op "
                             f"{eager.graphs}), tokens bit-identical: {same}")
    log(f"{label} serve A/B, decode p50 / p90 (host clock): graphs "
        f"{res.steady.p50_ms:.2f} / {res.steady.p90_ms:.2f} ms (decode graphs "
        f"captured {res.graphs}), op by op {eager.steady.p50_ms:.2f} / "
        f"{eager.steady.p90_ms:.2f} ms; tokens bit-identical: {same}")
    if moes:
        m = moes[0]
        log(f"{label} serve: {len(moes)} MoE sites, each grouped_matmul up and down "
            f"x{moe_passes(m, PREFILL_B * PREFILL_S)} in the prefill ({PREFILL_B * PREFILL_S}"
            f" tokens, capacity {moe_capacity_tag(m, PREFILL_B * PREFILL_S)}, buffers "
            f"{moe_buffer_bytes(m, PREFILL_B * PREFILL_S) / 1e6:.1f} MB a site) and "
            f"x{moe_passes(m, PREFILL_B)} a decode step (capacity "
            f"{moe_capacity_tag(m, PREFILL_B)}, buffers "
            f"{moe_buffer_bytes(m, PREFILL_B) / 1e6:.2f} MB a site)")
    toks = res.tokens
    if tuple(toks.shape) != (PREFILL_B, GEN + 1) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{label} serve: bad generated tokens {tuple(toks.shape)}")
    dropped = [int((~k).sum()) for k in layouts]
    log(f"{label} serve: prefill tokens over their leaf's capacity (the overflow pass): "
        f"{sum(dropped)} of {sum(k.numel() for k in layouts)} over {len(layouts)} "
        f"grouped dispatches (sites x trees), most in one {max(dropped, default=0)}")
    log(f"{label} serve batch {PREFILL_B} x prompt {PREFILL_S}, {GEN} decode steps: "
        f"prefill {res.prefill_s * 1e3:.2f} ms (first call); decode p50 "
        f"{res.steady.p50_ms:.2f} ms p90 {res.steady.p90_ms:.2f} ms; "
        f"{res.tokens_per_s:.1f} tok/s; launches {counts} (as expected; grouped by path "
        f"{paths}); reference backend never ran")
    return counts, res


def profile_report(label, prof, wall_s, steps, plain_s=None) -> None:
    """Logs a profiled window of ``steps`` steps; ``plain_s``, the same
    number of steps timed without the profiler, gives the device-busy share
    of an unprofiled step beside the profiled one."""
    averages = prof.key_averages()
    # kernels, memsets, copies; not the device span a scheduled profiler's
    # step annotation (ProfilerStep#) reports over them
    events = [e for e in averages if str(e.device_type).endswith("CUDA")
              and not e.key.startswith("ProfilerStep")]
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    busy_us = sum(dev(e) for e in events)
    mm_us = sum(dev(e) for e in events if any(
        n in e.key.lower() for n in ("gemm", "nvjet", "xmma", "cutlass", "matmul")))
    launches = sum(e.count for e in averages if e.key.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel")))
    # a replayed CUDA graph is one launch on the host; its kernels execute
    # on the device all the same
    graph_launches = sum(e.count for e in averages if e.key.startswith(
        "cudaGraphLaunch"))
    executed = sum(e.count for e in events
                   if not e.key.startswith(("Memcpy", "Memset")))
    # each blocking copy (.cpu(), float(t), a pageable upload) syncs the host
    syncs = sum(e.count for e in averages if e.key == "cudaStreamSynchronize")
    d2h = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    top = sorted(events, key=dev, reverse=True)[:8]
    # kernels launched as programmatic dependents (the fused decode's) start
    # while the kernel before them drains, so their spans overlap and the sum
    # above counts the overlap twice; the union counts each instant once
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and not e.name.startswith("ProfilerStep"))
    union_us, end = 0.0, float("-inf")
    for a, b in spans:
        union_us += max(0.0, b - max(a, end))
        end = max(end, b)
    log(f"[profile] {label}: {wall_s / steps * 1e3:.2f} ms per step (host "
        f"clock, profiler on); device busy {busy_us / 1e3 / steps:.2f} ms "
        f"per step (kernel time summed; {union_us / 1e3 / steps:.2f} ms as the union of "
        f"their spans) = {busy_us / 1e6 / wall_s:.1%} of the window"
        + (f"; {busy_us / 1e6 / plain_s:.1%} of the same steps unprofiled "
           f"({plain_s / steps * 1e3:.2f} ms a step)" if plain_s else "")
        + f"; {launches / steps:.0f} kernel launches and {graph_launches / steps:.0f} "
        f"graph launches on the host, {executed / steps:.0f} kernels executed, "
        f"{syncs / steps:.0f} stream "
        f"syncs and {d2h / steps:.0f} device-to-host copies per step; matmul "
        f"kernels {mm_us / 1e3 / steps:.2f} ms, the rest "
        f"{(busy_us - mm_us) / 1e3 / steps:.2f} ms per step")
    router = [e for e in events if "tree_router" in e.key]
    for e in top + [e for e in router if e not in top]:
        log(f"[profile]   {dev(e) / 1e3 / steps:8.3f} ms/step  {e.count // steps:4d}"
            f" calls/step  {e.key[:90]}")


def phase_profile(cfg, params, lm, inputs=None) -> None:
    """Where a warm prefill and a warm decode step spend their time:
    host-clock step time, device busy share (kernel time over the window)
    and the kernels with the most device time, from torch.profiler.
    ``inputs(prompt)``, when given, makes the prefill's inputs from the
    token prompt (an encoder's enc_embeds, or an embeds prompt)."""
    from torch.profiler import ProfilerActivity, profile
    # a seeded prompt: its overflow repairs, launches and syncs repeat from run to run
    prompt = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4),
                           dtype=torch.int32)
    max_len = PREFILL_S + GEN + 1
    batch = {"tokens": prompt} if inputs is None else inputs(prompt)

    def prefill():
        caches = lm.init_caches(cfg, PREFILL_B, max_len, device="cuda")
        out = lm.prefill(params, cfg, batch, caches)
        torch.cuda.synchronize()
        return out

    with torch.inference_mode():
        prefill()                                   # warm
        t0 = time.perf_counter()
        for _ in range(3):
            logits, caches = prefill()
        log(f"[profile] warm prefill {PREFILL_B}x{PREFILL_S}: "
            f"{(time.perf_counter() - t0) / 3 * 1e3:.2f} ms (host clock, mean of 3)")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, caches = prefill()
            wall = time.perf_counter() - t0
        profile_report("prefill", prof, wall, 1)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        steps = 4
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, caches = lm.decode_step(params, cfg, tok, caches, PREFILL_S + i)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_report("decode", prof, wall, steps)


def phase_parity(api, fff, lm, fff_config, label="[parity]", exact=True,
                 layers=PARITY_LAYERS, inputs=None) -> None:
    """float32, full width, ``layers`` layers: lm.generate's greedy tokens
    through the kernel backends against the reference backend's.  A row
    may differ only where it met a deciding margin under NEAR_TIE (a node
    logit on a routed path, or the gap between the two largest logits);
    with ``exact`` no row may differ.  ``inputs(cfg, prompt, gen)``, when
    given, makes the prefill's inputs from the token prompt (an encoder's
    enc_embeds, or an embeds prompt), which ``greedy`` decodes from."""
    cfg = dataclasses.replace(fff_config, n_layers=layers,
                              param_dtype=torch.float32, accum_dtype=torch.float32)
    params = lm.init(cfg, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (PARITY_B, PARITY_S), generator=gen,
                           device="cuda", dtype=torch.int32)
    batch = None if inputs is None else inputs(cfg, prompt, gen)
    max_len = PARITY_S + PARITY_STEPS + 1
    kern, m_kern = generate_batch_with_margins(api, fff, lm, cfg, params, prompt,
                                               PARITY_STEPS, max_len, batch=batch)
    ref, m_ref = generate_batch_with_margins(api, fff, lm, cfg, params, prompt,
                                             PARITY_STEPS, max_len, batch=batch,
                                             backend="reference", mode="infer")
    margin = [min(a, b) for a, b in zip(m_kern, m_ref)]
    ties = near_tie_check(label, dict(enumerate(kern)), dict(enumerate(ref)), margin)
    if exact and ties:
        raise AssertionError(
            f"{label}: greedy tokens differ between the kernel and reference backends "
            f"in {ties} rows (smallest deciding margin per row {margin}):"
            f"\nkernel    {kern.tolist()}\nreference {ref.tolist()}")
    log(f"{label} {cfg.n_layers} layers fp32 at full width, batch {PARITY_B} x prompt "
        f"{PARITY_S}, {PARITY_STEPS} greedy tokens: kernel backends equal the reference "
        f"backend ({ties} near-tie rows); smallest deciding margin per row "
        f"{[f'{m:.3e}' for m in margin]}")
    del params
    torch.cuda.empty_cache()


def check_engine_run(tag, cfg, run, counts, chunk, n_reqs, slabs_seen) -> tuple[int, int]:
    """Asserts a speculative engine run's launch counts, dispatch shapes and
    results (spec_k SPEC_K, the self:DRAFT_LAYERS draft, ENGINE_GEN new
    tokens a request); ``slabs_seen`` is the run's ``slab_log``.  Returns
    (spec rounds, admission slabs)."""
    n_layers, trees = cfg.n_layers, cfg.period[0].ffn.fff_trees
    m = run.metrics
    rounds = m.n_steps
    slabs = m.n_chunks if chunk else m.n_prefills
    if len(slabs_seen) != slabs:
        raise AssertionError(f"{tag}: {len(slabs_seen)} slabs logged, {slabs} counted")
    passes = sum(slab_passes(cfg, n) for _, n, _, _ in slabs_seen)
    # a verify round: every target layer's trees once each through the
    # gathered kernels (and the router); a draft step: the fused decode
    # kernel per draft layer (all trees in one launch); an admission slab
    # (> 32 tokens): the router per tree of every target and draft layer,
    # and the grouped kernels once a pass (two past a leaf's capacity)
    want = {"gathered_matmul": n_layers * trees * rounds,
            "gathered_matmul_dual": n_layers * trees * rounds,
            "fused_forest_decode": DRAFT_LAYERS * (SPEC_K + 1) * rounds,
            "grouped_matmul": (n_layers + DRAFT_LAYERS) * trees * passes,
            "grouped_matmul_dual": (n_layers + DRAFT_LAYERS) * trees * passes,
            "tree_router": (n_layers * rounds + (n_layers + DRAFT_LAYERS) * slabs) * trees}
    if counts != want:
        raise AssertionError(f"{tag}: launch counts {counts} != expected {want}")
    shapes = run.shapes
    want_shapes = {"draft": {(SLOTS, 1)}, "verify": {(SLOTS, SPEC_K + 1)}}
    if chunk:
        want_shapes["chunk"] = {(SLOTS, chunk)}
    else:
        want_shapes.update({k: {(SLOTS, int(k.split("_")[1]))}
                            for k in shapes if k.startswith("prefill_")})
    if shapes != want_shapes:
        raise AssertionError(f"{tag}: dispatch shapes {shapes} != {want_shapes}")
    bad = [r.rid for r in run.results
           if len(r.tokens) != ENGINE_GEN or r.finish_reason != "length"
           or not ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()]
    if len(run.results) != n_reqs or bad:
        raise AssertionError(f"{tag}: bad results for rids {bad}")
    return rounds, slabs


def phase_engine(common, api, serve_mod, cfg, params) -> dict:
    """The continuous-batching engine with speculative decoding at full
    width: monolithic, then chunked admission, each run's launch counts
    reset just before it and read just after.  Returns the monolithic
    run's counts."""
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import EngineConfig
    reqs = serve_mod.build_requests(cfg.vocab_size, ENGINE_REQS, ENGINE_PROMPT,
                                    ENGINE_GEN, seed=0,
                                    min_prompt_len=ENGINE_MIN_PROMPT)
    n_layers = cfg.n_layers
    out, runs, slab_logs = {}, {}, {}

    def ecfg_of(chunk):
        return EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                            max_prompt_len=ENGINE_PROMPT, prefill_chunk=chunk,
                            spec_k=SPEC_K, draft_config=f"self:{DRAFT_LAYERS}",
                            scheduler="fcfs", seed=0, device="cuda")
    for mode, chunk in (("monolithic", 0), ("chunked", ENGINE_CHUNK)):
        ecfg = ecfg_of(chunk)
        log(f"[engine] {mode}: {cfg.arch_id} FFF full width, {n_layers} layers "
            f"{cfg.param_dtype}, {SLOTS} slots, spec_k {SPEC_K}, draft "
            f"self:{DRAFT_LAYERS}, {len(reqs)} requests, prompts "
            f"{min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)}"
            f" tokens, {ENGINE_GEN} new tokens each")
        with no_reference(api), slab_log() as seen, sync_checked(mode), \
                capture_log() as caps:
            common.reset_launch_counts()
            run = serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
            counts = common.launch_counts()
        m = run.metrics
        rounds, slabs = check_engine_run(f"[engine] {mode}", cfg, run, counts,
                                         chunk, len(reqs), seen)
        check_paths(common, f"[engine] {mode}", counts, cfg.param_dtype)
        check_graphs(f"[engine] {mode}", run, seen)
        runs[mode], slab_logs[mode] = run, seen
        shapes = run.shapes
        log(f"[engine] {mode}: TTFT p50 {m.ttft.p50_ms:.2f} ms p90 "
            f"{m.ttft.p90_ms:.2f} ms; per-token p50 {m.per_token.p50_ms:.2f} ms "
            f"p90 {m.per_token.p90_ms:.2f} ms; {m.throughput_tok_s:.1f} tok/s; "
            f"{rounds} spec rounds (p50 {m.decode_step.p50_ms:.2f} ms), {slabs} "
            f"admission slabs; spec acceptance {m.spec_acceptance:.3f} "
            f"({m.accepted_tokens}/{m.draft_tokens}; random weights: says "
            f"nothing of a trained model's acceptance); launches {counts} (as "
            f"expected: each gathered kernel {n_layers} per verify round); "
            f"dispatch shapes {sorted((k, sorted(v)) for k, v in shapes.items())}; "
            f"graphs {run.graphs}; admission slabs (host clock): {slab_summary(seen)}")
        log(f"[engine] {mode}: captures (host clock; device memory reserved by each "
            f"graph's pool): {capture_summary(caps)}")
        out[mode] = counts
    engine_ab(common, api, serve_mod, cfg, params, reqs, ecfg_of(0), runs["monolithic"],
              slab_logs["monolithic"])
    phase_engine_profile(cfg, params)
    with graphs.disabled():
        phase_engine_profile(cfg, params, label=", op by op (graphs.disabled())")
    phase_admission_profile(cfg, params)
    with graphs.disabled():
        phase_admission_profile(cfg, params, label=", op by op (graphs.disabled())")
    return out["monolithic"]


def check_graphs(tag, run, slabs_seen) -> None:
    """A speculative run on the kernels captures each dispatch once: one
    graph for the spec round's (greedy) key, one for admission and one for
    each slab name the run used (``prefill_<b>`` a bucket, or
    ``prefill_chunk``); no dispatch ran eagerly (an eager one counts its
    shapes in ``compiled_shapes()`` and makes no graph)."""
    want = dict.fromkeys({"spec_round", "admit"} | {n for n, _, _, _ in slabs_seen}, 1)
    if run.graphs != want or {"draft", "verify", "chunk"} & set(run.compiled):
        raise AssertionError(f"{tag}: graphs {run.graphs} (want {want}), compiled "
                             f"{run.compiled}: a dispatch ran eagerly")


@contextlib.contextmanager
def capture_log():
    """Yields a list that takes (dispatch name, capture seconds, device
    memory reserved by the capture, allocated by it) for every CUDA graph
    captured inside the context: the first of these is the graph's own
    memory pool (its outputs and the blocks its kernels wrote, which it
    keeps), the second what stays allocated there (its outputs).  The
    capture empties the allocator's cache as it begins
    (``torch.cuda.graph``); emptying it just before also keeps the cached
    blocks it releases out of the reserved bytes' difference."""
    from repro_torch.serving import graphs
    Entry, Rec = graphs._Entry, graphs.CudaGraphRecorder
    first0, capture0 = Entry._first, Rec.capture
    names, out = [], []

    def first(self):
        names.append(self.name)
        try:
            return first0(self)
        finally:
            names.pop()

    def capture(self, run, stream):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0, a0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = capture0(self, run, stream)
        torch.cuda.synchronize()
        out.append((names[-1] if names else "?", time.perf_counter() - t0,
                    torch.cuda.memory_reserved() - r0, torch.cuda.memory_allocated() - a0))
        return res

    Entry._first, Rec.capture = first, capture
    try:
        yield out
    finally:
        Entry._first, Rec.capture = first0, capture0


def capture_summary(caps) -> str:
    return "; ".join(f"{n} {t * 1e3:.1f} ms, pool {r / 2 ** 20:.1f} MiB (outputs "
                     f"{a / 2 ** 20:.1f} MiB)" for n, t, r, a in caps)


@contextlib.contextmanager
def sync_checked(tag):
    """Each dispatch name's first eager call (the call before its capture)
    and its first replay, staging included, run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any op
    that synchronizes with the host; the capture itself begins with a
    device synchronization and runs outside it.  Logs the names checked."""
    from repro_torch.serving import graphs
    Entry = graphs._Entry
    run0, call0 = Entry._run, Entry.__call__
    eager_done, replay_done = set(), set()

    def strict(fn, *a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def run(self):
        if self.captured or torch.cuda.is_current_stream_capturing() or \
                self.name in eager_done:
            return run0(self)
        eager_done.add(self.name)
        return strict(run0, self)

    def call(self, inputs):
        if not self.captured or self.name in replay_done:
            return call0(self, inputs)
        replay_done.add(self.name)
        return strict(call0, self, inputs)

    Entry._run, Entry.__call__ = run, call
    try:
        yield
    finally:
        Entry._run, Entry.__call__ = run0, call0
    log(f"[sync] {tag}: under sync debug mode 'error', nothing synchronized in the "
        f"first eager call of {sorted(eager_done)} or the first replay (staging "
        f"included) of {sorted(replay_done)}")


def phase_admission_profile(cfg, params, label="") -> None:
    """Where a warm monolithic admission's time goes: an engine (spec_k 3,
    the self:1 draft) admits one 100-token prompt (bucket 128) to capture
    its dispatches, then two more, the last under torch.profiler: the
    ``admit`` dispatch and the 8 x 128 slab through both models, each a
    replayed graph (op by op in the disabled() run), and the first token's
    sampling."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
    from repro_torch.serving.request import Request
    ecfg = EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                        max_prompt_len=ENGINE_PROMPT, spec_k=SPEC_K,
                        draft_config=f"self:{DRAFT_LAYERS}", device="cuda")
    eng = ContinuousBatchingEngine(params, cfg, ecfg)
    gen = torch.Generator().manual_seed(5)

    def admit_one(i):
        eng.submit(Request(rid=i, prompt=torch.randint(
            0, cfg.vocab_size, (100,), generator=gen).numpy(),
            max_new_tokens=ENGINE_GEN))
        eng._admit()

    admit_one(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    admit_one(1)
    plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        admit_one(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if eng.n_prefills != 3 or eng.queue:
        raise AssertionError(f"[admission profile] {eng.n_prefills} prefills")
    profile_report(f"monolithic admission (admit + 8 x 128 slab, target and draft)"
                   f"{label}; graphs {eng._graphs.counts()}", prof, wall, 1,
                   plain_s=plain)


def engine_ab(common, api, serve_mod, cfg, params, reqs, ecfg, first, first_slabs) -> None:
    """The monolithic run again op by op (graphs.disabled()), then on graphs
    in a fresh engine, in one process on one card: every request's tokens
    must be bit-identical across the three runs, and the launch counts of
    each equal the first's.  Logs each run's admission slabs (host clock)
    beside its TTFT."""
    from repro_torch.serving import graphs
    runs, slabs = {"graphs": first}, {"graphs": first_slabs}
    for how, ctx in (("eager", graphs.disabled), ("graphs again", contextlib.nullcontext)):
        with no_reference(api), ctx(), slab_log() as seen:
            common.reset_launch_counts()
            run = serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
            counts = common.launch_counts()
        if counts != first.launches:
            raise AssertionError(f"[engine A/B] {how}: launch counts {counts} != "
                                 f"{first.launches}")
        runs[how], slabs[how] = run, seen
    check_graphs("[engine A/B] graphs again", runs["graphs again"], slabs["graphs again"])
    if runs["eager"].graphs:
        raise AssertionError(f"[engine A/B] eager: graphs {runs['eager'].graphs}")
    want = by_rid(first.results)
    for how, run in runs.items():
        got = by_rid(run.results)
        diff = [rid for rid in want if not np.array_equal(got[rid], want[rid])]
        if diff:
            raise AssertionError(f"[engine A/B] {how}: tokens differ from the first "
                                 f"graphs run for rids {diff}")
    log("[engine A/B] monolithic, one card, one process; graphs / op by op / "
        "graphs again: " + "; ".join(
            f"{how} {r.metrics.throughput_tok_s:.1f} tok/s, TTFT p50 "
            f"{r.metrics.ttft.p50_ms:.2f} ms, round p50 "
            f"{r.metrics.decode_step.p50_ms:.2f} ms p90 "
            f"{r.metrics.decode_step.p90_ms:.2f} ms, admission slabs "
            f"{slab_summary(slabs[how])}" for how, r in runs.items())
        + f"; every request's tokens bit-identical ({len(want)} requests); "
        f"compiled {runs['graphs again'].compiled} against op by op "
        f"{runs['eager'].compiled}")


def phase_engine_profile(cfg, params, steps=3, label="", **ecfg_kw) -> None:
    """Where a warm speculative round's time goes: a warm engine with every
    slot live and no admission pending, ``steps`` rounds on the host clock
    alone, then ``steps`` rounds under torch.profiler (whose tracing slows
    the host, most of all around graph replays); ``ecfg_kw`` adds engine
    knobs (the grouped phase's backend and policy)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
    from repro_torch.serving.request import Request
    ecfg = EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                        max_prompt_len=ENGINE_PROMPT, spec_k=SPEC_K,
                        draft_config=f"self:{DRAFT_LAYERS}", max_prefills_per_step=SLOTS,
                        device="cuda", **ecfg_kw)
    eng = ContinuousBatchingEngine(params, cfg, ecfg)
    gen = torch.Generator().manual_seed(3)
    for i in range(SLOTS):
        eng.submit(Request(rid=i, prompt=torch.randint(
            0, cfg.vocab_size, (ENGINE_PROMPT,), generator=gen).numpy(),
            max_new_tokens=ENGINE_GEN))
    eng.step()                       # admit every slot, then one warm round
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if eng.n_steps != 2 * steps + 2 or eng.queue:
        raise AssertionError("[engine profile] the window was not spec rounds alone")
    profile_report(f"spec round (4 draft steps + 32-token verify){label}", prof,
                   wall, steps, plain_s=plain)


def phase_paged(common, api, serve_mod, cfg, params) -> None:
    """The engine on the paged KV cache at full width: four runs over the
    same shared-prefix requests, each run's launch counts reset just before
    it and read just after (module docstring, phase 5).  Each admission
    slab (a prefill or chunk dispatch, which ends in its host copy) is
    timed on the host clock."""
    from repro_torch.serving.engine import EngineConfig
    reqs = serve_mod.build_requests(cfg.vocab_size, ENGINE_REQS, ENGINE_PROMPT,
                                    ENGINE_GEN, seed=0, shared_prefix=PAGED_PREFIX,
                                    tenants=sorted(PAGED_WEIGHTS))
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    paged = dict(page_size=PAGE)
    runs = {"a": ("contiguous, fcfs", {}),
            "b": ("paged, sharing off", dict(paged, prefix_sharing=False)),
            "c": ("paged, sharing on, monolithic", paged),
            "d": (f"paged, sharing on, chunked ({ENGINE_CHUNK}), weighted_leaf_aware",
                  dict(paged, prefill_chunk=ENGINE_CHUNK,
                       scheduler="weighted_leaf_aware",
                       scheduler_kw={"weights": PAGED_WEIGHTS}))}
    log(f"[paged] {cfg.arch_id} FFF full width, {cfg.n_layers} layers "
        f"{cfg.param_dtype}, {SLOTS} slots, spec_k {SPEC_K}, draft "
        f"self:{DRAFT_LAYERS}, max_len {PAGED_MAX_LEN}, {len(reqs)} requests "
        f"with a {PAGED_PREFIX}-token shared prefix, prompts "
        f"{min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)} "
        f"tokens ({prompt_tokens} in all), {ENGINE_GEN} new tokens each, "
        f"tenants {PAGED_WEIGHTS}")
    tokens = {}
    for key, (label, kw) in runs.items():
        ecfg = EngineConfig(num_slots=SLOTS, max_len=PAGED_MAX_LEN,
                            max_prompt_len=ENGINE_PROMPT, spec_k=SPEC_K,
                            draft_config=f"self:{DRAFT_LAYERS}", seed=0,
                            device="cuda", **kw)
        with no_reference(api), slab_log() as seen:
            common.reset_launch_counts()
            run = serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
            counts = common.launch_counts()
        tag = f"[paged] ({key}) {label}"
        rounds, slabs = check_engine_run(tag, cfg, run, counts,
                                         kw.get("prefill_chunk", 0), len(reqs), seen)
        check_graphs(tag, run, seen)
        m = run.metrics
        tokens[key] = {r.rid: r.tokens for r in run.results}
        if m.prefill_tokens + m.prefix_hit_tokens != prompt_tokens:
            raise AssertionError(f"{tag}: {m.prefill_tokens} prefilled + "
                                 f"{m.prefix_hit_tokens} shared != "
                                 f"{prompt_tokens} prompt tokens")
        if (m.prefix_hit_tokens > 0) != (key in "cd"):
            raise AssertionError(f"{tag}: {m.prefix_hit_tokens} prompt tokens "
                                 f"from shared pages")
        tenants = " ".join(f"{t} {d['throughput_tok_s']:.1f} tok/s "
                           f"({d['n_requests']} requests, TTFT p50 "
                           f"{d['ttft_ms']['p50_ms']:.2f} ms)"
                           for t, d in sorted(m.tenants.items()))
        log(f"{tag}: TTFT p50 {m.ttft.p50_ms:.2f} ms p90 {m.ttft.p90_ms:.2f} ms; "
            f"per-token p50 {m.per_token.p50_ms:.2f} ms; "
            f"{m.throughput_tok_s:.1f} tok/s; tokens prefilled on the device "
            f"{m.prefill_tokens}, from shared pages {m.prefix_hit_tokens}, "
            f"copy-on-write copies {m.cow_copies}, pages in use "
            f"{m.pages_in_use} free {m.pages_free}; {rounds} spec rounds, "
            f"admission slabs (host clock): {slab_summary(seen)}; tenants: {tenants}; "
            f"launches {counts} (as expected); graphs {run.graphs}")
    diff = [rid for rid in tokens["a"]
            if not (tokens["b"][rid] == tokens["a"][rid]).all()]
    if diff:
        raise AssertionError(f"[paged] (b) differs from (a) for rids {diff}")
    same = sum(bool((tokens["c"][rid] == tokens["a"][rid]).all())
               for rid in tokens["a"])
    log(f"[paged] (b) gives (a)'s tokens for all {len(reqs)} requests; (c) for "
        f"{same} of {len(reqs)} (its suffix slabs are other bf16 dispatches)")


def phase_engine_parity(api, fff, lm, serve_mod, FFF_CONFIG) -> None:
    """The engine, plain and speculative, monolithic and chunked, against
    lm.generate request by request (fp32, full width, 2 layers): on the
    contiguous cache, and on the paged cache with prefix sharing over
    shared-prefix requests, one of them the system prompt alone and one a
    page-aligned repeat of another's prompt (both copy-on-write).  A token
    may differ only where the generate run met a deciding margin under
    NEAR_TIE: a node logit, or the gap between the two largest logits."""
    from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
    from repro_torch.serving.request import Request
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=PARITY_LAYERS,
                              param_dtype=torch.float32,
                              accum_dtype=torch.float32)
    params = lm.init(cfg, seed=1, device="cuda")
    slots, prompt, steps, page, system = 4, 32, 8, 8, 16
    reqs = serve_mod.build_requests(cfg.vocab_size, 8, prompt, steps, seed=2,
                                    min_prompt_len=8)
    shared = serve_mod.build_requests(cfg.vocab_size, 8, prompt, steps, seed=3,
                                      shared_prefix=system)
    shared += [Request(rid=8, prompt=shared[0].prompt[:system], max_new_tokens=steps),
               Request(rid=9, prompt=shared[0].prompt[:3 * page], max_new_tokens=steps)]
    max_len = prompt + steps + 1
    ties, smallest = 0, math.inf
    paged = []
    for kw, batch in (({}, reqs), (dict(page_size=page), shared)):
        want, margin = generate_with_margins(api, fff, lm, cfg, params, batch,
                                             steps, max_len)
        smallest = min(smallest, *margin.values())
        for spec_k in (0, SPEC_K):
            for chunk in (0, 16):
                ecfg = EngineConfig(num_slots=slots, max_len=max_len,
                                    max_prompt_len=prompt, prefill_chunk=chunk,
                                    spec_k=spec_k, device="cuda", **kw)
                results, m = ContinuousBatchingEngine(params, cfg, ecfg).run(batch)
                ties += near_tie_check(
                    f"[engine parity] spec_k {spec_k} chunk {chunk} {kw}",
                    {r.rid: r.tokens for r in results}, want, margin)
                if kw:
                    if not (m.prefix_hit_tokens > 0 and m.cow_copies > 0):
                        raise AssertionError(
                            f"[engine parity] paged spec_k {spec_k} chunk "
                            f"{chunk}: {m.prefix_hit_tokens} shared tokens, "
                            f"{m.cow_copies} copy-on-write copies")
                    paged.append((spec_k, chunk, m.prefix_hit_tokens, m.cow_copies))
    log(f"[engine parity] {cfg.n_layers} layers fp32, {slots} slots, {len(reqs)} "
        f"requests x {steps} greedy tokens: the plain and speculative (spec_k "
        f"{SPEC_K}, a {slots * (SPEC_K + 1)}-token verify slab) engines, "
        f"monolithic and chunked, equal lm.generate for every request, and so "
        f"do they on the paged cache (pages of {page}, prefix sharing, "
        f"{len(shared)} requests with a {system}-token shared prefix; (spec_k, "
        f"chunk, shared tokens, copy-on-write copies) {paged}) ({ties} near-tie "
        f"differences allowed); smallest deciding margin {smallest:.3e}")
    del params
    torch.cuda.empty_cache()


def near_tie_check(label, got, want, margin) -> int:
    """Greedy tokens per request against ``want``: a request may differ only
    where the run that made ``want`` met a deciding margin under NEAR_TIE.
    Returns how many differed."""
    ties = 0
    for rid, toks in got.items():
        if (toks == want[rid]).all():
            continue
        if margin[rid] >= NEAR_TIE:
            raise AssertionError(
                f"{label} rid {rid}: {toks.tolist()} != {want[rid].tolist()} "
                f"with no deciding margin under {NEAR_TIE} (smallest "
                f"{margin[rid]:.3e})")
        ties += 1
    return ties


def generate_with_margins(api, fff, lm, cfg, params, reqs, steps, max_len,
                          **overrides):
    """lm.generate's greedy tokens for each request alone (under
    ``api.overrides(**overrides)`` when given), and the smallest deciding
    margin each met: a node logit on a routed path of any tree, or the gap
    between the two largest logits."""
    smallest = {}
    apply_fn, head_fn = api.apply, lm._head

    def recording_apply(p, c, x, spec=api.ExecutionSpec()):
        xf = x.reshape(-1, x.shape[-1]).to(c.accum_dtype)
        every = fff._node_logits_all(p, c, xf)
        for t in range(c.trees):
            logits = every[:, t]
            idx = torch.zeros(xf.shape[0], dtype=torch.long, device=x.device)
            off = 0
            for m in range(c.depth):
                cur = logits[:, off:off + 2 ** m].gather(1, idx[:, None])[:, 0]
                smallest["now"] = min(smallest["now"], float(cur.abs().min()))
                idx = 2 * idx + (cur >= 0).long()
                off += 2 ** m
        return apply_fn(p, c, x, spec)

    def recording_head(p, c, x):
        out = head_fn(p, c, x)
        top2 = out.topk(2, dim=-1).values
        smallest["now"] = min(smallest["now"], float((top2[..., 0] - top2[..., 1]).min()))
        return out

    want, margin = {}, {}
    api.apply, lm._head = recording_apply, recording_head
    try:
        with torch.inference_mode(), (api.overrides(**overrides) if overrides
                                      else contextlib.nullcontext()):
            for r in reqs:
                smallest["now"] = math.inf
                out = lm.generate(params, cfg, torch.from_numpy(r.prompt)[None].cuda(),
                                  steps, max_len)
                want[r.rid] = out[0, len(r.prompt):].cpu().numpy()
                margin[r.rid] = smallest["now"]
    finally:
        api.apply, lm._head = apply_fn, head_fn
    return want, margin


def grouped_capacities(rows) -> None:
    """Both grouped kernels at the JAX grouped path's capacities, full width,
    both dtypes: C = 8, 16, 136 and 264 with group sizes 0, 1, C-1 and C
    (four leaves each) in one call, against their plain versions, rows past
    a group's size zero; device times and bounds logged beside the table's C
    = 128 row.  Its own generator leaves the earlier phases' inputs as they
    were."""
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        wg = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wu = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wd = randn(E, L_W, O, scale=L_W ** -0.5, dtype=dtype)
        table = (rows[("grouped_matmul_dual", dtype)]["ms"],
                 rows[("grouped_matmul", dtype)]["ms"])
        for C in GROUPED_CAPS:
            gs = torch.tensor([0, 1, C - 1, C] * (E // 4), dtype=torch.int32, device=dev)
            mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
            xg = randn(E, C, D, dtype=dtype) * mask
            path = full_width_path(dtype)
            h = twice_on(f"grouped_matmul_dual (C={C})",
                         lambda: gk.grouped_matmul_dual(xg, wg, wu, gs), gk.GMM_DUAL, path)
            err_d = compare(f"grouped_matmul_dual (C={C})", h,
                            gr.grouped_matmul_dual_ref(xg, wg, wu, gs), dtype)
            y = twice_on(f"grouped_matmul (C={C})", lambda: gk.grouped_matmul(h, wd, gs),
                         gk.GMM, path)
            err = compare(f"grouped_matmul (C={C})", y, gr.grouped_matmul_ref(h, wd, gs), dtype)
            past = ~mask[..., 0]
            if float(h[past].abs().max()) != 0.0 or float(y[past].abs().max()) != 0.0:
                raise AssertionError(f"grouped kernels (C={C}): a row past its "
                                     f"group's size is not zero")
            live, n = int((gs > 0).sum()), int(gs.sum())
            b_d, _ = grouped_bound(gs, C, D, L_W, 2, dtype)
            b, by = grouped_bound(gs, C, L_W, O, 1, dtype)
            ms_d = device_ms(lambda: gk.grouped_matmul_dual(xg, wg, wu, gs))
            ms = device_ms(lambda: gk.grouped_matmul(h, wd, gs))
            log(f"[grouped] C={C:3d} {str(dtype):15s} ({n} tokens in {live} live "
                f"leaves): grouped_matmul_dual {ms_d:.4f} ms (bound {b_d:.4f}, "
                f"kernel/bound {ms_d / b_d:.2f}, max|err| {err_d:.3e}); grouped_matmul "
                f"{ms:.4f} ms (bound {b:.4f} {by}, kernel/bound {ms / b:.2f}, max|err| "
                f"{err:.3e}); table row C=128: {table[0]:.4f} / {table[1]:.4f} ms; plans "
                f"{plan_tag(gk.launch_plan(xg, (wg, wu)))} / {plan_tag(gk.launch_plan(h, (wd,)))}")
        del wg, wu, wd
        torch.cuda.empty_cache()


def phase_grouped_serving(common, api, serve_mod, cfg, params) -> None:
    """The full-width bf16 model served through the engine on the grouped
    backend: the engine phase's requests, monolithic admission, spec_k 3,
    with the default policy ("drop", cf 2.0) and with "exact_dense" at cf
    0.5; each run's launch counts reset just before it and read just after,
    every dispatch captured (``check_graphs``), then one profiled spec round
    of a warm engine with the same knobs."""
    from repro_torch.core import routing
    from repro_torch.serving.engine import EngineConfig
    reqs = serve_mod.build_requests(cfg.vocab_size, ENGINE_REQS, ENGINE_PROMPT,
                                    ENGINE_GEN, seed=0,
                                    min_prompt_len=ENGINE_MIN_PROMPT)
    n_layers, E = cfg.n_layers, 2 ** cfg.period[0].ffn.fff_depth
    for label, kw in (("drop, cf 2.0 (the defaults)", {}),
                      ("exact_dense, cf 0.5", dict(overflow_policy="exact_dense",
                                                   capacity_factor=0.5))):
        ecfg = EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                            max_prompt_len=ENGINE_PROMPT, spec_k=SPEC_K,
                            draft_config=f"self:{DRAFT_LAYERS}", scheduler="fcfs",
                            seed=0, device="cuda", fff_backend="grouped", **kw)
        with no_reference(api), slab_log() as seen:
            common.reset_launch_counts()
            run = serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
            counts = common.launch_counts()
        m = run.metrics
        rounds, slabs = m.n_steps, m.n_prefills
        check_graphs(f"[grouped] {label}", run, seen)
        # every FFF dispatch on the grouped backend, one call of each kernel
        # per layer, and one more where "exact_dense" repairs a slab that can
        # drop a token (routing.repair_rows, the shape alone decides): the
        # verify slab and the admission slabs through the target's layers and
        # the draft's, each draft step through the draft's; the round runs at
        # the capacity factor times SPEC_K + 1
        cf = kw.get("capacity_factor", 2.0)

        def calls(tokens, c):
            return 1 + (kw.get("overflow_policy") == "exact_dense"
                        and routing.repair_rows(tokens, E, c) > 0)
        slab_calls = sum(calls(n, cf) for _, n, _, _ in seen)
        vcf = cf * (SPEC_K + 1)
        per_kernel = (n_layers * (rounds * calls(SLOTS * (SPEC_K + 1), vcf) + slab_calls)
                      + DRAFT_LAYERS * ((SPEC_K + 1) * rounds * calls(SLOTS, vcf)
                                        + slab_calls))
        want = {k: 0 for k in counts}
        want["grouped_matmul"] = want["grouped_matmul_dual"] = per_kernel
        if counts != want:
            raise AssertionError(f"[grouped] {label}: launch counts {counts} != "
                                 f"expected {want}")
        bad = [r.rid for r in run.results
               if len(r.tokens) != ENGINE_GEN or r.finish_reason != "length"
               or not ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()]
        if len(run.results) != len(reqs) or bad:
            raise AssertionError(f"[grouped] {label}: bad results for rids {bad}")
        if kw and not (m.overflow_fraction_mean > 0 and m.overflow_repairs > 0):
            raise AssertionError(f"[grouped] {label}: no overflow repaired "
                                 f"(overflow mean {m.overflow_fraction_mean})")
        log(f"[grouped] engine, {label}: overflow mean {m.overflow_fraction_mean:.4f}"
            f" (decode-side {m.overflow_decode_mean:.4f}), ~{m.overflow_repairs} "
            f"slots repaired; TTFT p50 {m.ttft.p50_ms:.2f} ms; per-token p50 "
            f"{m.per_token.p50_ms:.2f} ms; {m.throughput_tok_s:.1f} tok/s; {rounds} "
            f"spec rounds (p50 {m.decode_step.p50_ms:.2f} ms), {slabs} admission "
            f"slabs (host clock: {slab_summary(seen)}); launches {counts} (as "
            f"expected: each grouped kernel once per layer per dispatch, twice where "
            f"the repair runs); graphs {run.graphs}; reference backend never ran")
        phase_engine_profile(cfg, params, steps=1, label=f", grouped {label}",
                             fff_backend="grouped", **kw)


def phase_grouped_parity(api, fff, lm, serve_mod, FFF_CONFIG) -> None:
    """float32, full width, 2 layers: lm.generate through grouped
    ("exact_dense", cf 0.5) and through one-process grouped_ep (its default
    "exact_dense", cf 1.25), and the engine on grouped ("exact_dense", cf
    0.5, plain and speculative), all against the reference backend's
    lm.generate, request by request, except at near-ties.  Returns the
    float32 grouped GEMM launches of these runs (counts set to 0 just
    before, read just after), every one asserted on the CUDA-core path."""
    from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=PARITY_LAYERS,
                              param_dtype=torch.float32,
                              accum_dtype=torch.float32)
    params = lm.init(cfg, seed=1, device="cuda")
    slots, prompt, steps = 4, 32, 8
    reqs = serve_mod.build_requests(cfg.vocab_size, 8, prompt, steps, seed=2,
                                    min_prompt_len=8)
    from repro_torch.kernels import common
    common.reset_launch_counts()
    max_len = prompt + steps + 1
    want, margin = generate_with_margins(api, fff, lm, cfg, params, reqs, steps,
                                         max_len, backend="reference", mode="infer")
    exact = dict(capacity_factor=0.5, overflow_policy="exact_dense")
    ties = {}
    for label, kw in (("grouped exact_dense cf 0.5",
                       dict(backend="grouped", mode="infer", **exact)),
                      ("grouped_ep", {})):
        with (grouped_ep_alone(api) if not kw else contextlib.nullcontext()), \
                backends_ran(api) as ran:
            got, _ = generate_with_margins(api, fff, lm, cfg, params, reqs, steps,
                                           max_len, **kw)
        if {n for _, n in ran} != {label.split()[0]}:
            raise AssertionError(f"[grouped parity] {label}: backends {set(ran)} ran")
        ties[label] = near_tie_check(f"[grouped parity] lm.generate {label}", got,
                                     want, margin)
    for spec_k in (0, SPEC_K):
        ecfg = EngineConfig(num_slots=slots, max_len=max_len, max_prompt_len=prompt,
                            spec_k=spec_k, fff_backend="grouped", device="cuda",
                            **exact)
        results, m = ContinuousBatchingEngine(params, cfg, ecfg).run(reqs)
        label = f"engine spec_k {spec_k}"
        ties[label] = near_tie_check(f"[grouped parity] {label}",
                                     {r.rid: r.tokens for r in results}, want, margin)
        ties[label + " overflow"] = m.overflow_fraction_mean
    log(f"[grouped parity] {cfg.n_layers} layers fp32, {len(reqs)} requests x "
        f"{steps} greedy tokens: lm.generate on grouped (exact_dense, cf 0.5) and "
        f"on grouped_ep (one process, exact_dense, cf 1.25), and the engine on "
        f"grouped (exact_dense, cf 0.5; plain and spec_k {SPEC_K}), equal the "
        f"reference backend's lm.generate for every request; near-tie "
        f"differences and engine overflow means {ties}; smallest deciding margin "
        f"{min(margin.values()):.3e}")
    counts, paths = common.launch_counts(), common.path_counts()
    grouped = {k: counts[k] for k in ("grouped_matmul", "grouped_matmul_dual")}
    for k, n in grouped.items():
        if n <= 0 or paths.get(k, {}) != {"cuda_cores": n}:
            raise AssertionError(f"[grouped parity] {k}: {n} launches by path "
                                 f"{paths.get(k)}, expected all on 'cuda_cores'")
    log(f"[grouped parity] float32 grouped launches, all on the CUDA-core path: {grouped}")
    del params
    torch.cuda.empty_cache()
    return grouped


def train_card_vs_cpu(api, lm, base_cfg, backends=("reference", "grouped"),
                      label="train") -> None:
    """base_cfg.reduced() in float32: loss, metrics and every gradient of
    lm.loss_fn on the card against the port's own CPU result (1e-3), under
    each train backend (they steer FFF sites only), remat none and full."""
    from repro_torch import optim, utils
    from repro_torch.data import tokens as tokens_lib
    cfg = base_cfg.reduced()
    cpu = lm.init(cfg, seed=3, device="cpu")
    card = utils.tree_map(lambda p: p.to("cuda"), cpu)
    batch = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=3).batch(4, 32, seed=3)
    worst = {}
    for backend in backends:
        for remat in ("none", "full"):
            c = dataclasses.replace(cfg, remat=remat)
            vg = optim.value_and_grad(lambda p, b: lm.loss_fn(p, c, b))
            with api.overrides(backend=backend, mode="train"):
                (_, want_m), want_g = vg(cpu, batch)
                (_, got_m), got_g = vg(card, batch)
            pairs = [(f"metric {k}", got_m[k], want_m[k]) for k in want_m]
            pairs += [(f"grad {i}", g, w) for i, (g, w) in enumerate(
                zip(utils.tree_leaves(got_g), utils.tree_leaves(want_g)))]
            err = 0.0
            for name, g, w in pairs:
                g, w = g.float().cpu(), w.float()
                e = (g - w).abs()
                if not bool(torch.isfinite(g).all()) or bool((e > 1e-3 + 1e-3 * w.abs()).any()):
                    raise AssertionError(f"[{label}] card vs CPU, {backend} remat {remat}: "
                                         f"{name} max |err| {float(e.max()):.3e} "
                                         f"exceeds rtol=atol=1e-3")
                err = max(err, float(e.max()))
            worst[f"{backend}/{remat}"] = err
    log(f"[{label}] card vs CPU, {cfg.arch_id} {cfg.period[0].ffn.kind} reduced fp32 "
        f"({lm.param_count(cpu)} params): loss, metrics and every gradient within "
        f"1e-3 under {', '.join('train/' + b for b in backends)}, remat none and "
        f"full; max |err| "
        f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())}")


def decisive_fractions(api, fff, lm, cfg, params, batch) -> list:
    """Per layer, the fraction of decisive node decisions (entropy < 0.10)
    of one training forward on ``batch``."""
    fracs, apply_fn = [], api.apply

    def recording_apply(p, c, x, spec=api.ExecutionSpec()):
        y, out = apply_fn(p, c, x, spec)
        fracs.append(float(fff.decisive_fraction(out.node_probs)))
        return y, out

    api.apply = recording_apply
    try:
        with torch.no_grad():
            lm.loss_fn(params, cfg, batch)
    finally:
        api.apply = apply_fn
    return fracs


def train_full_width(common, api, fff, lm, FFF_CONFIG) -> None:
    """internlm2-20b FFF, full width, bf16, remat "full", TRAIN_LAYERS layers:
    TRAIN_STEPS steps of launch.train.train from seeded weights."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch import utils
    from repro_torch.data import tokens as tokens_lib
    from repro_torch.launch import train as train_mod
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=TRAIN_LAYERS)
    params = lm.init(cfg, seed=0, device="cuda")
    probe = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=0).batch(
        TRAIN_B, TRAIN_S, seed=0)
    before = decisive_fractions(api, fff, lm, cfg, params, probe)
    bad_grads = []
    # the profiler's steps end at each inspect call: its active step runs
    # from the gradient of step W to that of step W + 1
    W = TRAIN_STEPS - 4
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=W, warmup=1, active=1, repeat=1))
    marks = {}

    def inspect(i, grads, metrics):
        if i == 0:
            for k, g in enumerate(utils.tree_leaves(grads)):
                if g is None or not bool(torch.isfinite(g).all()) or not bool(g.any()):
                    bad_grads.append(k)
        if i in (W, W + 1):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
        prof.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    prof.start()
    try:
        res = train_mod.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                              lr=TRAIN_LR, seed=0, device="cuda", params=params,
                              inspect=inspect, log=lambda line: log(f"[train]   {line}"))
    finally:
        prof.stop()
    counts = common.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del params
    if any(counts.values()):
        raise AssertionError(f"[train] kernels launched during training: {counts}")
    if bad_grads:
        raise AssertionError(f"[train] step 0: {len(bad_grads)} parameters with a "
                             f"non-finite or all-zero gradient (leaves {bad_grads})")
    losses = res.losses
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train] non-finite loss: {losses}")
    tail = sum(losses[-5:]) / 5
    if not tail < losses[0] - TRAIN_MARGIN:
        raise AssertionError(f"[train] loss fell from {losses[0]:.4f} to a last-5 "
                             f"mean of {tail:.4f}, not by {TRAIN_MARGIN}")
    after = decisive_fractions(api, fff, lm, cfg, res.params, probe)
    ms = sorted(res.step_ms)
    last = res.metrics[-1]
    log(f"[train] {cfg.arch_id} FFF full width, {cfg.n_layers} of 48 layers, "
        f"{lm.param_count(res.params) / 1e9:.2f}B params {cfg.param_dtype}, remat "
        f"{cfg.remat}, batch {TRAIN_B} x seq {TRAIN_S}, {TRAIN_STEPS} steps, lr "
        f"{TRAIN_LR}: loss {losses[0]:.4f} -> last-5 mean {tail:.4f} (drop "
        f"{losses[0] - tail:.4f}, margin {TRAIN_MARGIN}); ce {res.metrics[0]['ce']:.4f}"
        f" -> {last['ce']:.4f}; hardening {res.metrics[0]['hardening']:.4f} -> "
        f"{last['hardening']:.4f}; balance {last['balance']:.4f}; step time p50 "
        f"{ms[len(ms) // 2]:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}; CUDA "
        f"events, loss + gradient + update); peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated); decisive fraction per layer "
        f"{[round(f, 4) for f in before]} -> {[round(f, 4) for f in after]}; "
        f"every gradient finite and nonzero at step 0; kernel launches {counts}")
    profile_report(f"train step (update {W}, loss and gradient {W + 1})", prof,
                   marks[W + 1] - marks[W], 1)
    del res
    torch.cuda.empty_cache()


def greedy(lm, cfg, params, batch, steps, max_len) -> torch.Tensor:
    """lm.generate's greedy loop from a prefill of ``batch`` (tokens with an
    encoder's enc_embeds, or an embeds prompt): the (B, steps) generated
    tokens."""
    B, S = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[:2]
    caches = lm.init_caches(cfg, B, max_len, device="cuda")
    logits, caches = lm.prefill(params, cfg, batch, caches)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out = []
    for i in range(steps):
        out.append(tok)
        logits, caches = lm.decode_step(params, cfg, tok, caches, S + i)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


def generate_batch_with_margins(api, fff, lm, cfg, params, prompt, steps, max_len,
                                batch=None, **overrides):
    """lm.generate on the whole batch (``greedy`` from ``batch``'s prefill
    inputs when given), under ``api.overrides(**overrides)`` when given,
    and per row the smallest deciding margin it met: a node logit on a
    routed path of any tree, or the gap between the two largest logits.
    Train-mode sites (an encoder's soft mixture) decide nothing and are
    left out."""
    B = prompt.shape[0]
    row_min = torch.full((B,), math.inf, device="cuda")
    apply_fn, head_fn = api.apply, lm._head

    def recording_apply(p, c, x, spec=api.ExecutionSpec()):
        if spec.mode == "train":
            return apply_fn(p, c, x, spec)
        xf = x.reshape(B, -1, x.shape[-1]).to(c.accum_dtype)
        every = fff._node_logits_all(p, c, xf.reshape(-1, x.shape[-1]))
        for t in range(c.trees):
            logits = every[:, t]
            idx = torch.zeros(logits.shape[0], dtype=torch.long, device=x.device)
            off = 0
            for m in range(c.depth):
                cur = logits[:, off:off + 2 ** m].gather(1, idx[:, None])[:, 0]
                row_min.copy_(torch.minimum(row_min, cur.abs().reshape(B, -1).amin(1)))
                idx = 2 * idx + (cur >= 0).long()
                off += 2 ** m
        return apply_fn(p, c, x, spec)

    def recording_head(p, c, x):
        out = head_fn(p, c, x)
        top2 = out.topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).reshape(B, -1).amin(1)
        row_min.copy_(torch.minimum(row_min, gap))
        return out

    api.apply, lm._head = recording_apply, recording_head
    try:
        with torch.inference_mode(), (api.overrides(**overrides) if overrides
                                      else contextlib.nullcontext()):
            out = (lm.generate(params, cfg, prompt, steps, max_len)[:, prompt.shape[1]:]
                   if batch is None else greedy(lm, cfg, params, batch, steps, max_len))
    finally:
        api.apply, lm._head = apply_fn, head_fn
    return out, row_min.tolist()


def train_then_serve(common, api, fff, lm, FFF_CONFIG) -> None:
    """float32, full width, TRAIN_SERVE_LAYERS layers trained
    TRAIN_SERVE_STEPS steps, then served through the kernel backends and the
    reference backend: greedy tokens equal off near-ties."""
    from repro_torch.launch import train as train_mod
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=TRAIN_SERVE_LAYERS,
                              param_dtype=torch.float32, accum_dtype=torch.float32)
    res = train_mod.train(cfg, steps=TRAIN_SERVE_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                          lr=TRAIN_LR, seed=1, device="cuda",
                          log=lambda line: log(f"[train]   {line}"))
    params = res.params
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (PARITY_B, PARITY_S), generator=gen,
                           device="cuda", dtype=torch.int32)
    max_len = PARITY_S + PARITY_STEPS + 1
    common.reset_launch_counts()
    kern, _ = generate_batch_with_margins(api, fff, lm, cfg, params, prompt,
                                          PARITY_STEPS, max_len)
    counts = common.launch_counts()
    used = ("tree_router", "grouped_matmul", "grouped_matmul_dual", "fused_forest_decode")
    if not all(counts[k] > 0 for k in used):
        raise AssertionError(f"[train] serving the trained model: kernel launches {counts}")
    ref, margin = generate_batch_with_margins(api, fff, lm, cfg, params, prompt,
                                              PARITY_STEPS, max_len,
                                              backend="reference", mode="infer")
    ties = near_tie_check("[train] trained model", dict(enumerate(kern)),
                          dict(enumerate(ref)), margin)
    log(f"[train] {cfg.n_layers} layers fp32 trained {TRAIN_SERVE_STEPS} steps (loss "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}), then batch {PARITY_B} x "
        f"prompt {PARITY_S}, {PARITY_STEPS} greedy tokens: kernel backends equal the "
        f"reference backend ({ties} near-tie rows); kernel launches {counts}; "
        f"smallest deciding margin per row {[f'{m:.3e}' for m in margin]}")
    del params, res
    torch.cuda.empty_cache()


def phase_train(common, api, fff, lm, FFF_CONFIG) -> None:
    train_card_vs_cpu(api, lm, FFF_CONFIG)
    train_full_width(common, api, fff, lm, FFF_CONFIG)
    train_then_serve(common, api, fff, lm, FFF_CONFIG)


# ---------------------------------------------------------------------------
# checkpoint/restart training, and the dense FF baseline
# ---------------------------------------------------------------------------

def trees_equal(a, b, utils) -> bool:
    """Every leaf torch.equal (tensors) or equal (ints), in one structure."""
    la, lb = utils.tree_leaves(a), utils.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(y, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def rate(nbytes: int, seconds: float) -> str:
    return f"{seconds:.2f} s at {nbytes / seconds / 1e9:.2f} GB/s"


def ckpt_supervised(common, cfg, root: Path):
    """(b) CKPT_STEPS uninterrupted steps; (c) the same steps under the
    supervisor (async manager, a checkpoint every CKPT_EVERY, keep
    CKPT_KEEP) with a failure injected at step CKPT_FAIL_AT: the same
    losses and final parameters, bit for bit.  Returns (c)'s result."""
    from repro_torch import checkpoint, utils
    from repro_torch.launch import train as train_mod
    kw = dict(steps=CKPT_STEPS, batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR, seed=0,
              device="cuda")
    common.reset_launch_counts()
    plain = train_mod.train(cfg, log=lambda line: log(f"[ckpt]   (b) {line}"), **kw)
    tripped = []

    def fail_once(i):
        if i == CKPT_FAIL_AT and not tripped:
            tripped.append(i)
            log(f"[ckpt]   (c) injected failure at step {i}")
            return True
        return False

    sup = train_mod.train(cfg, ckpt_dir=str(root / "c"), ckpt_every=CKPT_EVERY,
                          keep=CKPT_KEEP, failure_hook=fail_once,
                          log=lambda line: log(f"[ckpt]   (c) {line}"), **kw)
    counts = common.launch_counts()
    steps = checkpoint.CheckpointManager(str(root / "c")).steps()
    if (sup.end, sup.restarts, steps) != (CKPT_STEPS, 1, [CKPT_EVERY, CKPT_STEPS]):
        raise AssertionError(f"[ckpt] (c) ended at step {sup.end} with "
                             f"{sup.restarts} restarts, checkpoints {steps}")
    if any(counts.values()):
        raise AssertionError(f"[ckpt] kernels launched during training: {counts}")
    if sup.losses != plain.losses:
        raise AssertionError(f"[ckpt] (c) losses {sup.losses} != (b)'s {plain.losses}")
    if not trees_equal(sup.params, plain.params, utils):
        raise AssertionError("[ckpt] (c) final parameters differ from (b)'s")
    t = sup.ckpt_timings
    nbytes = dir_bytes(root / "c" / f"step_{CKPT_STEPS}")
    log(f"[ckpt] (b) {CKPT_STEPS} uninterrupted steps, losses "
        f"{[round(x, 4) for x in plain.losses]}; (c) under the supervisor, "
        f"checkpoints every {CKPT_EVERY} (async, keep {CKPT_KEEP}), failure at "
        f"step {CKPT_FAIL_AT}: ended at step {sup.end}, restarts {sup.restarts}, "
        f"checkpoints {steps}; losses and final parameters bit-identical to (b)'s; "
        f"kernel launches {counts}")
    log(f"[ckpt] checkpoint bytes {nbytes} ({nbytes / 1e9:.2f} GB) at step {CKPT_STEPS}")
    log(f"[ckpt] snapshot on the caller's thread {t['snapshot_s'] * 1e3:.1f} ms "
        f"({nbytes / t['snapshot_s'] / 1e9:.2f} GB/s; step {CKPT_STEPS}, device to host)")
    log(f"[ckpt] background write {rate(nbytes, t['write_s'])} (serialize + commit, "
        f"step {CKPT_STEPS}); restore {rate(nbytes, t['restore_s'])} (step "
        f"{CKPT_EVERY}, after the failure)")
    return sup


def ckpt_round_trip(trained, root: Path) -> None:
    """(a) a blocking save_tree and restore_tree of (c)'s final {params,
    opt}: every leaf bit-identical, on the card in its dtype, the AdamW
    step intact.  It takes the room of (c)'s step-3 checkpoint."""
    from repro_torch import checkpoint, utils
    shutil.rmtree(root / "c" / f"step_{CKPT_EVERY}")
    state = {"params": trained.params, "opt": trained.opt_state}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_tree(str(root / "a"), state, step=CKPT_STEPS)
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(root / "a")
    t0 = time.perf_counter()
    got, step, _ = checkpoint.restore_tree(str(root / "a"), state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    placed = all((g.device, g.dtype) == (w.device, w.dtype)
                 for g, w in zip(utils.tree_leaves(got), utils.tree_leaves(state))
                 if isinstance(w, torch.Tensor))
    adam = got["opt"].step
    if not (placed and trees_equal(got, state, utils)) or step != CKPT_STEPS or \
            type(adam) is not int or adam != CKPT_STEPS:
        raise AssertionError(f"[ckpt] (a) round trip: placed {placed}, step {step}, "
                             f"AdamW step {adam!r}")
    log(f"[ckpt] (a) blocking save_tree + restore_tree of (c)'s final {{params, opt}}: "
        f"{len(utils.tree_leaves(state))} leaves bit-identical (torch.equal), on cuda "
        f"in their dtypes, AdamW step {adam} (int); {nbytes} bytes; save_tree "
        f"{rate(nbytes, save_s)}, restore_tree {rate(nbytes, restore_s)} (host clock)")
    del got
    shutil.rmtree(root / "a")


def ckpt_serve_restored(common, lm, serve_mod, cfg, root: Path, trained) -> None:
    """(d) the newest checkpoint restored into a fresh model on the card,
    served through the kernels: the in-memory model's tokens."""
    from repro_torch import checkpoint
    fresh = {"params": lm.init(cfg, seed=1, device="cuda")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, step, _ = checkpoint.restore_tree(str(root / "c" / f"step_{CKPT_STEPS}"), fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del fresh
    runs = {}
    for name, params in (("restored", got["params"]), ("in memory", trained)):
        common.reset_launch_counts()
        res = serve_mod.serve(cfg, batch=PREFILL_B, prompt_len=PREFILL_S, gen=CKPT_GEN,
                              device="cuda", params=params)
        runs[name] = (res.tokens, common.launch_counts())
    (toks, counts), (want, _) = runs["restored"], runs["in memory"]
    used = ("tree_router", "grouped_matmul", "grouped_matmul_dual", "fused_forest_decode")
    if not all(counts[k] > 0 for k in used):
        raise AssertionError(f"[ckpt] (d) serving the restored model: launches {counts}")
    if step != CKPT_STEPS or not torch.equal(toks, want):
        raise AssertionError(f"[ckpt] (d) restored step {step}: tokens "
                             f"{toks.tolist()} != in-memory {want.tolist()}")
    log(f"[ckpt] (d) step {step} restored into a fresh model on the card "
        f"({restore_s:.2f} s, params only) and served, batch {PREFILL_B} x prompt "
        f"{PREFILL_S}, {CKPT_GEN} greedy tokens: the in-memory model's tokens; "
        f"kernel launches {counts}")


#: the training command line, held once it has printed the line that starts
#: with argv[1] (its next step never starts) until it is killed
HELD_CLI = """
import sys, threading
from repro_torch.launch import train
hold = sys.argv[1]

class Held:
    def __init__(self, out):
        self.out, self.line = out, ""
    def write(self, s):
        self.out.write(s)
        self.out.flush()
        *done, self.line = (self.line + s).split("\\n")
        if any(line.startswith(hold) for line in done):
            threading.Event().wait()
        return len(s)
    def flush(self):
        self.out.flush()

sys.stdout = Held(sys.stdout)
train.main(sys.argv[2:])
"""


def same_checkpoint(a: Path, b: Path) -> bool:
    """The same manifest and the same arrays, bit for bit."""
    import numpy as np
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    if ma != mb:
        return False
    for shard in ma["shards"]:
        with np.load(a / shard) as za, np.load(b / shard) as zb:
            if za.files != zb.files or not all(
                    za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
                    for k in za.files):
                return False
    return True


def ckpt_cli_resume() -> None:
    """The command line on the card, each run in its own process:
    ``python -m repro_torch.launch.train --reduced --steps 6 --ckpt-every 3
    --ckpt-dir D`` killed with SIGKILL after step 4 (held once it printed
    its step-4 line, killed when the step-3 checkpoint has committed), then
    run again: it resumes at step 3, and its step-5 line and step-6
    checkpoint are an uninterrupted run's.  Then the Prefetcher's card path
    against shard_batch."""
    import os
    import signal
    import tempfile
    from repro_torch.data import pipeline
    from repro_torch.data import tokens as tokens_lib
    d = Path(tempfile.mkdtemp(prefix="ckpt_cli_"))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    args = ["--arch", "internlm2-20b", "--reduced", "--steps", "6", "--batch", "2", "--seq",
            "16", "--ckpt-every", "3"]
    cli = [sys.executable, "-m", "repro_torch.launch.train", *args]
    no_ms = lambda line: line.rsplit(None, 1)[0]

    def run(ckpt_dir):
        out = subprocess.run(cli + ["--ckpt-dir", str(ckpt_dir)], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise AssertionError(f"[ckpt] CLI exit {out.returncode}: {out.stderr[-2000:]}")
        return out.stdout.strip().splitlines()

    try:
        full = run(d / "full")
        child = subprocess.Popen([sys.executable, "-c", HELD_CLI, "step    4 ", *args,
                                  "--ckpt-dir", str(d / "killed")], env=env, cwd=ROOT,
                                 stdout=subprocess.PIPE, text=True)
        try:
            seen = ""
            for line in child.stdout:
                if line.startswith("step    4 "):
                    seen = line
                    break
            deadline = time.monotonic() + 300
            while seen and not (d / "killed" / "step_3" / "manifest.json").exists():
                if child.poll() is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.01)
            child.send_signal(signal.SIGKILL)
            rc = child.wait(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
            child.stdout.close()
        left = sorted(p.name for p in (d / "killed").iterdir())
        if not seen or rc != -signal.SIGKILL or left != ["step_3"]:
            raise AssertionError(f"[ckpt] CLI kill: step-4 line {seen!r}, exit {rc}, "
                                 f"directory {left}")
        res = run(d / "killed")
        if (res[1] != f"resuming from step 3 ({d / 'killed'})"
                or [int(x.split()[1]) for x in res[2:5]] != [3, 4, 5]
                or no_ms(res[4]) != no_ms(full[6])
                or res[-1] != "done at step 6 (restarts=0)"
                or not same_checkpoint(d / "killed" / "step_6", d / "full" / "step_6")):
            raise AssertionError(f"[ckpt] CLI resumed: {res}; uninterrupted: {full}")
        log(f"[ckpt] CLI on the card (--reduced --steps 6 --ckpt-every 3, each run "
            f"its own process): SIGKILL after step 4 (exit {rc}), run again: "
            f"resumed at step 3; step 5 {no_ms(res[4])!r}, the uninterrupted "
            f"run's; step-6 checkpoints bit-identical")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    src = tokens_lib.MarkovTokenSource(1000, seed=0)
    pf = pipeline.Prefetcher(lambda i: src.batch(TRAIN_B, TRAIN_S, seed=i), device="cuda")
    try:
        for i in range(3):
            got, want = next(pf), pipeline.shard_batch(src.batch(TRAIN_B, TRAIN_S, seed=i))
            if got.keys() != want.keys() or not all(
                    got[k].is_cuda and torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"[ckpt] Prefetcher batch {i} != shard_batch's")
    finally:
        pf.close()
    log("[ckpt] Prefetcher on the card (pinned, side-stream copies): 3 batches "
        "equal shard_batch's")


def phase_ckpt(common, lm, serve_mod, FFF_CONFIG) -> None:
    import tempfile
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=CKPT_LAYERS)
    root = Path(tempfile.mkdtemp(prefix="ckpt_smoke_"))
    try:
        free = shutil.disk_usage(root).free
        params = lm.init(cfg, seed=0, device="cuda")
        n = lm.param_count(params)
        del params
        # bf16 params (2 bytes) and float32 moments (8) a parameter, CKPT_KEEP kept
        need = CKPT_KEEP * n * (torch.finfo(cfg.param_dtype).bits // 8 + 8)
        log(f"[ckpt] {cfg.arch_id} FFF full width, {cfg.n_layers} of 48 layers, "
            f"{n / 1e9:.2f}B params {cfg.param_dtype}, remat {cfg.remat}; free disk "
            f"{free} bytes ({free / 1e9:.2f} GB) at {root} before the phase "
            f"(shutil.disk_usage); needs {need / 1e9:.2f} GB")
        if free < need:
            raise AssertionError(f"[ckpt] the disk holds {free / 1e9:.2f} GB free at "
                                 f"{root}; the phase needs {need / 1e9:.2f} GB")
        sup = ckpt_supervised(common, cfg, root)
        torch.cuda.empty_cache()
        ckpt_round_trip(sup, root)
        torch.cuda.empty_cache()
        ckpt_serve_restored(common, lm, serve_mod, cfg, root, sup.params)
        del sup
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ckpt_cli_resume()


def ffn_site_times(lm, mlp, cfg, params, tag="[dense]") -> dict:
    """One warm prefill (PREFILL_B x PREFILL_S) and one warm decode step of
    ``cfg`` under torch.profiler, every FFN site inside a
    record_function("ffn_site") range.  Per phase: (device busy ms, FFN
    sites' device ms: the kernels that start inside the ranges' device-side
    spans).  Raises unless every layer's site ran inside its range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    forward, sites = mlp.forward, []

    def timed(*a, **kw):
        sites.append(1)
        with record_function("ffn_site"):
            return forward(*a, **kw)

    prompt = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4),
                           dtype=torch.int32)

    def prefill():
        caches = lm.init_caches(cfg, PREFILL_B, PREFILL_S + 2, device="cuda")
        return lm.prefill(params, cfg, {"tokens": prompt}, caches)

    on_card = lambda e: str(e.device_type).endswith("CUDA")
    out = {}
    mlp.forward = timed
    try:
        with torch.inference_mode():
            logits, caches = prefill()                       # warm both
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            lm.decode_step(params, cfg, tok, caches, PREFILL_S)
            _, caches = prefill()
            torch.cuda.synchronize()
            for phase, fn in (("prefill", prefill), ("decode", lambda: lm.decode_step(
                    params, cfg, tok, caches, PREFILL_S))):
                sites.clear()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                evs = prof.events()
                ranges = [(e.time_range.start, e.time_range.end) for e in evs
                          if on_card(e) and e.name == "ffn_site"]
                work = [(e.time_range.start, e.time_range.end) for e in evs
                        if on_card(e) and e.name != "ffn_site"]
                if not len(sites) == len(ranges) == cfg.n_layers:
                    raise AssertionError(f"{tag} {phase}: {len(sites)} FFN sites ran, "
                                         f"{len(ranges)} device-side ranges, "
                                         f"{cfg.n_layers} layers")
                names = {}
                for e in evs:
                    if (on_card(e) and e.name != "ffn_site" and any(
                            r0 <= e.time_range.start < r1 for r0, r1 in ranges)):
                        names[e.name] = names.get(e.name, 0) + e.time_range.elapsed_us()
                inside = sum(names.values())
                out[phase] = (sum(t1 - t0 for t0, t1 in work) / 1e3, inside / 1e3)
                top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
                log(f"{tag} {cfg.arch_id} warm {phase}: top kernels inside the FFN sites "
                    + "; ".join(f"{us / 1e3:.3f} ms {name[:60]}" for name, us in top))
    finally:
        mlp.forward = forward
    return out


def phase_dense(common, api, lm, serve_mod, FFF_CONFIG, CONFIG) -> None:
    """internlm2-20b native (dense SwiGLU, d_ff 16384) at full width, bf16,
    SERVE_LAYERS layers: the serve phase's fixed-batch loop (no kernel), then
    the FFN sites' device time against FFF's in a warm prefill and decode
    step; then the dense LM's loss and gradients on the card against the CPU."""
    from repro_torch.nn import mlp
    dense_cfg = dataclasses.replace(CONFIG, n_layers=SERVE_LAYERS)
    fff_cfg = dataclasses.replace(FFF_CONFIG, n_layers=SERVE_LAYERS)
    params = lm.init(dense_cfg, seed=0, device="cuda")
    spec = dense_cfg.period[0].ffn
    log(f"[dense] {dense_cfg.arch_id} native ({spec.kind} {spec.activation}, d_ff "
        f"{spec.d_ff}) full width, {dense_cfg.n_layers} of 48 layers, "
        f"{lm.param_count(params) / 1e9:.2f}B params {dense_cfg.param_dtype}")
    common.reset_launch_counts()
    res = serve_mod.serve(dense_cfg, batch=PREFILL_B, prompt_len=PREFILL_S, gen=GEN,
                          device="cuda", params=params)
    counts = common.launch_counts()
    toks = res.tokens
    if any(counts.values()) or tuple(toks.shape) != (PREFILL_B, GEN + 1) or not bool(
            ((toks >= 0) & (toks < dense_cfg.vocab_size)).all()):
        raise AssertionError(f"[dense] serve: launches {counts}, tokens {tuple(toks.shape)}")
    log(f"[dense] serve batch {PREFILL_B} x prompt {PREFILL_S}, {GEN} decode steps: "
        f"prefill {res.prefill_s * 1e3:.2f} ms (first call); decode p50 "
        f"{res.steady.p50_ms:.2f} ms p90 {res.steady.p90_ms:.2f} ms; "
        f"{res.tokens_per_s:.1f} tok/s; kernel launches {counts} (none: dense)")
    times = {"dense": ffn_site_times(lm, mlp, dense_cfg, params)}
    del params, res
    torch.cuda.empty_cache()
    params = lm.init(fff_cfg, seed=0, device="cuda")
    times["fff"] = ffn_site_times(lm, mlp, fff_cfg, params)
    del params
    torch.cuda.empty_cache()
    for phase, what in (("prefill", f"{PREFILL_B}x{PREFILL_S} tokens"),
                        ("decode", f"one step, batch {PREFILL_B}")):
        d, f = times["dense"][phase], times["fff"][phase]
        for name, (busy, inside) in (("dense FF", d), ("FFF", f)):
            log(f"[dense] warm {phase} ({what}), {name}: FFN sites {inside:.3f} ms "
                f"device time (kernels inside the {SERVE_LAYERS} sites' device-side "
                f"spans); device busy {busy:.3f} ms")
        log(f"[dense] warm {phase}: FFN sites' device time dense/FFF "
            f"{d[1] / max(f[1], 1e-9):.2f}x")
    train_card_vs_cpu(api, lm, CONFIG, backends=("reference",), label="dense")


# ---------------------------------------------------------------------------
# the registry archs at their own widths, the MoE baseline, long prompts
# ---------------------------------------------------------------------------

def site_configs(cfg) -> list:
    """Per layer, the FFFConfig of its FFN site, or None where the layer
    has no FFF site (jamba's period holds two site configs; xlstm has no
    FFN site at all)."""
    from repro_torch.nn import mlp
    out = []
    for i in range(cfg.n_layers):
        f = cfg.period[i % len(cfg.period)].ffn
        out.append(None if f.kind != "fff" else mlp.make_fff_config(
            f, cfg.d_model, param_dtype=cfg.param_dtype, accum_dtype=cfg.accum_dtype))
    return out


def site_tag(fc) -> str:
    """trees x leaves x leaf width, e.g. "2x8x24576"."""
    return f"{fc.trees}x{fc.num_leaves}x{fc.leaf_width}"


def arch_kernels(label, cfg, params) -> dict:
    """Every kernel cfg's FFN sites reach, on each distinct site config's
    first layer's own weights (bf16) and seeded inputs at the site's
    shapes, through the kernels phase's row builders: the router at the
    1024-token prefill slab and the grouped kernels on the buffers it
    routes to (capacity as the kernel path sizes them), the router and the
    gathered kernels at the 32-token verify slab, the fused decode kernel
    at batch 8 over the whole forest.  Every tree is checked; the rows are
    timed on tree 0 (every tree has its shapes).  Returns {row name: row};
    with more than one site config each name ends in its site's tag."""
    from repro_torch import utils
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    first = {}
    for i, fc in enumerate(site_configs(cfg)):
        if fc is not None and fc not in first:
            first[fc] = i
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    for fc, layer in first.items():
        suffix = f" [{site_tag(fc)}]" if len(first) > 1 else ""
        p = params["stack"][layer]["ffn"]
        nw, nb = (t.contiguous() for t in fd_ops.collapse_nodes(p, fc))
        depth, E, act, dtype = fc.depth, fc.num_leaves, fc.activation, cfg.param_dtype
        names = (("leaf_wg", "leaf_wu", "leaf_wd") if act == "swiglu"
                 else ("leaf_w1", "leaf_w2"))
        leaves = tuple(p[n] for n in names)
        randn = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
        site_rows = {}
        for slab, B in (("", PREFILL_B * PREFILL_S), ("@32", VERIFY_B)):
            x = randn(B, cfg.d_model)
            C = max(128, utils.round_up(int(2.0 * utils.cdiv(B, E)), 128))
            for t in range(fc.trees):
                tag = f"{label}{suffix} (tree {t})"
                if t == 0:
                    site_rows[f"tree_router{slab}"] = router_row(
                        f"{label}{suffix} tree_router{slab}", x, nw[t], nb[t], depth)
                leaf, _ = routed(f"{tag} tree_router{slab}", x, nw[t], nb[t], depth)
                w = [m[t] for m in leaves]
                if slab:
                    _, r = gathered_rows(tag, x, w[:-1], w[-1], leaf, act, dtype,
                                         timed=t == 0)
                else:
                    lay = gemm_ops.scatter_to_groups(x, leaf, E, C)
                    _, r = grouped_rows(tag, lay.x_grouped, w[:-1], w[-1],
                                        lay.group_sizes, act, dtype, timed=t == 0)
                    r = {k: dict(v, capacity=C) for k, v in r.items()}
                site_rows.update(r)
                torch.cuda.empty_cache()
        site_rows["fused_forest_decode"] = decode_row(
            f"{label}{suffix}", randn(DECODE_B, cfg.d_model), nw, nb, leaves, depth,
            act, dtype)
        rows.update({k + suffix: v for k, v in site_rows.items()})
        del nw, nb, leaves
        torch.cuda.empty_cache()
    return rows


def arch_engine(common, api, serve_mod, label, cfg, params) -> None:
    """The engine phase's monolithic run on cfg: 8 slots, spec_k 3, the
    self:1 draft, 16 requests; launch counts (per tree) and dispatch shapes
    asserted as there."""
    from repro_torch.serving.engine import EngineConfig
    reqs = serve_mod.build_requests(cfg.vocab_size, ENGINE_REQS, ENGINE_PROMPT,
                                    ENGINE_GEN, seed=0, min_prompt_len=ENGINE_MIN_PROMPT)
    ecfg = EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                        max_prompt_len=ENGINE_PROMPT, spec_k=SPEC_K,
                        draft_config=f"self:{DRAFT_LAYERS}", scheduler="fcfs", seed=0,
                        device="cuda")
    with no_reference(api), slab_log() as seen:
        common.reset_launch_counts()
        run = serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
        counts = common.launch_counts()
    rounds, slabs = check_engine_run(f"{label} engine", cfg, run, counts, 0, len(reqs),
                                     seen)
    check_graphs(f"{label} engine", run, seen)
    m = run.metrics
    log(f"{label} engine: {SLOTS} slots, spec_k {SPEC_K}, draft self:{DRAFT_LAYERS}, "
        f"{len(reqs)} requests: TTFT p50 {m.ttft.p50_ms:.2f} ms p90 {m.ttft.p90_ms:.2f} ms;"
        f" per-token p50 {m.per_token.p50_ms:.2f} ms; {m.throughput_tok_s:.1f} tok/s; "
        f"{rounds} spec rounds (p50 {m.decode_step.p50_ms:.2f} ms), {slabs} admission "
        f"slabs; launches {counts} (as expected, per tree)")


def phase_archs(common, api, fff, lm, serve_mod) -> dict:
    """The registry archs through the kernels at their published widths,
    cut in depth to ARCH_LAYERS (one model on the card at a time): each
    kernel at its sites' shapes, the fixed-batch loop, fp32 greedy parity;
    olmoe-1b-7b also through the engine, and its FFN sites' device time
    for the moe phase.  Returns {arch: {kernel: row}} and olmoe's site
    times and loop decode p50 under "olmoe ffn"."""
    import importlib
    from repro_torch.configs import registry
    from repro_torch.nn import mlp
    out = {}
    for arch, layers in ARCH_LAYERS.items():
        t0 = time.perf_counter()
        mod = importlib.import_module(registry._MODULES[arch])
        cfg = dataclasses.replace(mod.FFF_CONFIG, n_layers=layers)
        fc = site_configs(cfg)[0]
        label = f"[archs] {arch}"
        params = lm.init(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        log(f"{label} FFF full width (d_model {cfg.d_model}, {fc.trees} tree(s) of depth "
            f"{fc.depth}, {fc.num_leaves} {fc.activation} leaves of width "
            f"{fc.leaf_width}), {layers} of {mod.CONFIG.n_layers} layers, "
            f"{lm.param_count(params) / 1e9:.2f}B params {cfg.param_dtype}, init "
            f"{time.perf_counter() - t0:.1f}s")
        with torch.inference_mode():
            rows = arch_kernels(label, cfg, params)
        counts, res = phase_serve(common, api, serve_mod, cfg, params, label=label)
        log_rows(rows, f"{label} kernel", counts)
        if arch == "olmoe-1b-7b":
            arch_engine(common, api, serve_mod, label, cfg, params)
            out["olmoe ffn"] = (ffn_site_times(lm, mlp, cfg, params, tag=label),
                                res.steady.p50_ms)
        del params
        torch.cuda.empty_cache()
        phase_parity(api, fff, lm, mod.FFF_CONFIG, label=f"{label} parity", exact=False)
        out[arch] = {k: dict(v, launches=counts.get(kernel_of(k), 0)) for k, v in rows.items()}
        log(f"{label} done in {time.perf_counter() - t0:.1f}s")
    return out


def site_inputs(lm, mlp, cfg, params) -> dict:
    """Each FFN site's (params, input) in a prefill of ffn_site_times's
    seeded prompt and in the decode step after it: {"prefill": [...],
    "decode": [...]}, one entry a layer."""
    forward, seen = mlp.forward, []

    def recording(p, s, d, x, **kw):
        seen.append((p, x.clone()))
        return forward(p, s, d, x, **kw)

    prompt = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4),
                           dtype=torch.int32)
    out = {}
    mlp.forward = recording
    try:
        with torch.inference_mode():
            logits, caches = lm.prefill(params, cfg, {"tokens": prompt},
                                        lm.init_caches(cfg, PREFILL_B, PREFILL_S + 2,
                                                       device="cuda"))
            out["prefill"], seen = seen, []
            lm.decode_step(params, cfg, logits.argmax(-1)[:, None].to(torch.int32),
                           caches, PREFILL_S)
            out["decode"] = seen
    finally:
        mlp.forward = forward
    return out


def moe_sites_bound(moe, mcfg, inputs) -> tuple[float, int]:
    """The MoE sites' bound over one pass (each site's own, summed: they
    run one after another): per site the gate weights, each live expert's
    two matrices and the tokens read, the outputs written; the gate logits
    and each (token, choice) pair's two products.  Returns (ms, live
    experts summed over the sites)."""
    total, live_all = 0.0, 0
    with torch.inference_mode():
        for p, x in inputs:
            _, aux = moe.forward_sparse(p, mcfg, x)
            n, k = aux["expert_idx"].shape
            live = int(torch.unique(aux["expert_idx"]).numel())
            d, E, F = mcfg.dim_in, mcfg.num_experts, mcfg.expert_width
            sz = torch.finfo(mcfg.param_dtype).bits // 8
            b, _ = bound(d * E * sz + live * 2 * d * F * sz + n * 2 * d * sz,
                         2 * n * d * E + 2 * 2 * n * k * d * F, mcfg.param_dtype)
            total, live_all = total + b, live_all + live
    return total, live_all


def moe_layout(moe, gemm_ops, p, mcfg, x):
    """A MoE site's first-pass grouped layout for x (B, D), as
    ``forward_sparse`` builds it (dead rows zeroed, so the plain versions'
    outputs are finite there)."""
    _, _, _, top_idx = moe._clean_top_k(p, mcfg, x)
    B, k = top_idx.shape
    pairs = x.to(p["expert_w1"].dtype)[:, None].expand(B, k, x.shape[1]).reshape(B * k, -1)
    flat = top_idx.reshape(-1)
    slot = gemm_ops._slots(flat, mcfg.num_experts, None)
    return gemm_ops._layout(pairs, flat, slot, mcfg.num_experts, moe.capacity(B, mcfg))


def moe_site_rows(label, moe, mcfg, p, x) -> dict:
    """One MoE site on x: ``forward_sparse`` (the grouped GEMMs) twice,
    bit-identical, against ``forward_sparse_gather`` (the same experts; the
    bf16 tolerance), its device time (CUDA graph replays: it reads nothing
    on the host) against the site's bound and its buffers' bytes; then both
    grouped GEMMs on the site's first-pass buffers against their plain
    versions (``grouped_rows``).  Returns those kernel rows."""
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    x = x.reshape(-1, x.shape[-1])
    B = x.shape[0]
    site = lambda: moe.forward_sparse(p, mcfg, x)[0]
    y = twice(f"{label} forward_sparse", site)
    aux = moe.forward_sparse(p, mcfg, x)[1]
    y_ref, aux_ref = moe.forward_sparse_gather(p, mcfg, x)
    if not torch.equal(aux["expert_idx"], aux_ref["expert_idx"]):
        raise AssertionError(f"{label}: the grouped and gather forms chose other experts")
    err = compare(f"{label} forward_sparse vs gather", y, y_ref, mcfg.param_dtype)
    del y_ref
    ms = device_ms(site)
    gather_ms = time_ms(lambda: moe.forward_sparse_gather(p, mcfg, x), reps=3, warmup=1)
    b_ms, live = moe_sites_bound(moe, mcfg, [(p, x)])
    load = torch.bincount(aux["expert_idx"].reshape(-1), minlength=mcfg.num_experts)
    log(f"{label} MoE site, {B} tokens: forward_sparse (grouped GEMMs, capacity "
        f"{moe_capacity_tag(mcfg, B)}, buffers {moe_buffer_bytes(mcfg, B) / 1e6:.2f} MB) "
        f"equals the gather form within the {mcfg.param_dtype} tolerance (max|err| "
        f"{err:.3e}), "
        f"bit-identical twice; {live} of {mcfg.num_experts} experts live, "
        f"{int(load.min())}-{int(load.max())} pairs each; device {ms:.4f} ms against "
        f"its bound {b_ms:.4f} ms ({ms / b_ms:.2f}x); gather form {gather_ms:.4f} ms "
        f"(loop)")
    lay = moe_layout(moe, gemm_ops, p, mcfg, x)
    _, rows = grouped_rows(f"{label} MoE site {B} tok", lay.x_grouped, (p["expert_w1"],),
                           p["expert_w2"], lay.group_sizes, mcfg.activation,
                           mcfg.param_dtype)
    C = lay.x_grouped.shape[1]
    return {f"{k} [moe {B} tok]": dict(v, capacity=C) for k, v in rows.items()}


def moe_engine(common, api, serve_mod, label, cfg, params) -> None:
    """A few requests through the engine on the MoE model (8 slots, no
    speculation, MOE_ENGINE_REQS requests of MOE_ENGINE_GEN new tokens):
    decode, each prefill bucket and admission captured once and nothing
    run eagerly, each dispatch's first eager call and first replay with no
    host sync, the grouped GEMMs' launches the slab shapes fix
    asserted; then op by op, every request's tokens bit-identical."""
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import EngineConfig
    moes = moe_site_configs(cfg)
    reqs = serve_mod.build_requests(cfg.vocab_size, MOE_ENGINE_REQS, ENGINE_PROMPT,
                                    MOE_ENGINE_GEN, seed=0,
                                    min_prompt_len=ENGINE_MIN_PROMPT)
    ecfg = EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + MOE_ENGINE_GEN + 1,
                        max_prompt_len=ENGINE_PROMPT, scheduler="fcfs", seed=0,
                        device="cuda")
    runs = {}
    for how, ctx in (("graphs", lambda: sync_checked(f"{label} engine")),
                     ("op by op", graphs.disabled)):
        with no_reference(api), slab_log() as seen, ctx():
            common.reset_launch_counts()
            run = serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
            counts = common.launch_counts()
        m = run.metrics
        want = dict.fromkeys(common.KERNELS, 0)
        want["grouped_matmul"] = sum(
            2 * (sum(moe_passes(mc, n) for _, n, _, _ in seen)
                 + m.n_steps * moe_passes(mc, SLOTS)) for mc in moes)
        if counts != want or len(seen) != m.n_prefills:
            raise AssertionError(f"{label} engine ({how}): launches {counts} != {want} "
                                 f"({len(seen)} slabs logged, {m.n_prefills} counted)")
        check_paths(common, f"{label} engine ({how})", counts, cfg.param_dtype)
        runs[how] = run
        log(f"{label} engine ({how}): {SLOTS} slots, {len(reqs)} requests, "
            f"{MOE_ENGINE_GEN} new tokens each: TTFT p50 {m.ttft.p50_ms:.2f} ms; "
            f"per-token p50 {m.per_token.p50_ms:.2f} ms; decode step p50 "
            f"{m.decode_step.p50_ms:.2f} ms; {m.throughput_tok_s:.1f} tok/s; "
            f"{m.n_steps} decode steps, {m.n_prefills} admission slabs "
            f"({slab_summary(seen)}); launches {counts} (as the slab shapes fix); "
            f"graphs {run.graphs}; dispatch shapes "
            f"{sorted((k, sorted(v)) for k, v in run.shapes.items())}")
        if how == "graphs":
            slabs = {n for n, _, _, _ in seen}
            want_graphs = dict.fromkeys({"decode", "admit"} | slabs, 1)
            if run.graphs != want_graphs or set(run.compiled) != set(want_graphs):
                raise AssertionError(f"{label} engine: graphs {run.graphs} (want "
                                     f"{want_graphs}), compiled {run.compiled}")
    got, ref = by_rid(runs["graphs"].results), by_rid(runs["op by op"].results)
    bad = [rid for rid in ref if not np.array_equal(got[rid], ref[rid])]
    if bad or len(got) != len(reqs):
        raise AssertionError(f"{label} engine: rids {bad} differ between graphs and op "
                             f"by op")
    log(f"{label} engine: every request's tokens bit-identical, graphs against op by op")


def phase_moe(common, api, lm, serve_mod, fff_ref) -> dict:
    """olmoe-1b-7b native: the noisy top-k MoE (64 experts, top 8, GELU
    experts of width 1024, no bias) at full width, all 16 layers, bf16, its
    sites on the grouped GEMMs: the fixed-batch loop through phase_serve
    (graphs and op by op, the grouped launches the shapes fix), its decode
    p50 beside the FFF forest's (same inference width, 8 x 1024), the FFN
    sites' device time against the forest's in a warm prefill and decode
    step, the MoE site on layer 0's prefill and decode inputs
    (``moe_site_rows``), and a few requests through the engine
    (``moe_engine``).  Returns the kernel rows with the loop's launches."""
    from repro_torch.configs.olmoe_1b_7b import CONFIG
    from repro_torch.core import moe
    from repro_torch.nn import mlp
    t0 = time.perf_counter()
    label = "[moe]"
    cfg = CONFIG
    spec = cfg.period[0].ffn
    fff_times, fff_p50 = fff_ref
    params = lm.init(cfg, seed=0, device="cuda")
    random_gates(cfg, params, seed=6)
    log(f"{label} {cfg.arch_id} native (moe: {spec.moe_experts} experts, top "
        f"{spec.moe_top_k}, width {spec.d_ff}; active width {spec.active_width}) full "
        f"width, all {cfg.n_layers} layers, {lm.param_count(params) / 1e9:.2f}B params "
        f"{cfg.param_dtype}; gates drawn N(0, 1/d_model)")
    counts, res = phase_serve(common, api, serve_mod, cfg, params, label=label)
    log(f"{label} decode p50 (batch {PREFILL_B}, {cfg.n_layers} layers, host clock, "
        f"both on graphs): MoE {res.steady.p50_ms:.2f} ms, FFF forest {fff_p50:.2f} ms "
        f"(MoE/FFF {res.steady.p50_ms / fff_p50:.2f}x)")
    moe_times = ffn_site_times(lm, mlp, cfg, params, tag=label)
    inputs = site_inputs(lm, mlp, cfg, params)
    mcfg = mlp.make_moe_config(spec, cfg.d_model, param_dtype=cfg.param_dtype,
                               accum_dtype=cfg.accum_dtype)
    for phase, what in (("prefill", f"{PREFILL_B}x{PREFILL_S} tokens"),
                        ("decode", f"one step, batch {PREFILL_B}")):
        m, f = moe_times[phase], fff_times[phase]
        for name, (busy, inside) in (("MoE", m), ("FFF", f)):
            log(f"{label} warm {phase} ({what}), {name}: FFN sites {inside:.3f} ms device "
                f"time (kernels inside the {cfg.n_layers} sites' device-side spans); "
                f"device busy {busy:.3f} ms")
        b_ms, live = moe_sites_bound(moe, mcfg, inputs[phase])
        log(f"{label} warm {phase}: FFN sites' device time MoE/FFF "
            f"{m[1] / max(f[1], 1e-9):.2f}x; the MoE sites' bound {b_ms:.3f} ms ({live} "
            f"live experts over {cfg.n_layers} sites), MoE sites/bound {m[1] / b_ms:.2f}")
    rows = {}
    with torch.inference_mode():
        for phase in ("prefill", "decode"):
            p, x = inputs[phase][0]
            rows.update(moe_site_rows(f"{label} layer 0 {phase}", moe, mcfg, p, x))
            torch.cuda.empty_cache()
    del inputs, p, x
    moe_engine(common, api, serve_mod, label, cfg, params)
    del params
    torch.cuda.empty_cache()
    log(f"{label} done in {time.perf_counter() - t0:.1f}s")
    return {k: dict(v, launches=counts.get(kernel_of(k), 0)) for k, v in rows.items()}


def phase_long(common, api, lm) -> None:
    """starcoder2-15b FFF at full width, LONG_LAYERS layers, bf16: one
    LONG_PROMPT-token prompt prefilled through flash_attention (its 4096
    sliding window binds), then LONG_GEN greedy decode steps; launch
    counts asserted, time and peak memory printed.  Then layer 0's q, k
    and v of that prompt in float32: flash_attention against the plain
    masked attention within the e2e tolerance (1e-3)."""
    from repro_torch.configs.starcoder2_15b import FFF_CONFIG
    from repro_torch.nn import attention, norms, transformer
    t0 = time.perf_counter()
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=LONG_LAYERS)
    window = cfg.period[0].sliding_window
    params = lm.init(cfg, seed=0, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(5),
                           dtype=torch.int32)
    flash, calls = attention.flash_attention, []
    attention.flash_attention = lambda *a, **kw: (calls.append(kw), flash(*a, **kw))[1]
    try:
        with torch.inference_mode(), no_reference(api):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            common.reset_launch_counts()
            caches = lm.init_caches(cfg, 1, LONG_PROMPT + LONG_GEN + 1, device="cuda")
            t1 = time.perf_counter()
            logits, caches = lm.prefill(params, cfg, {"tokens": prompt}, caches)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t1
            toks, step_s = [], []
            for i in range(LONG_GEN):
                tok = logits.argmax(-1)[:, None].to(torch.int32)
                toks.append(int(tok))
                t1 = time.perf_counter()
                logits, caches = lm.decode_step(params, cfg, tok, caches, LONG_PROMPT + i)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
            counts = common.launch_counts()
            peak = torch.cuda.max_memory_allocated()
    finally:
        attention.flash_attention = flash
    L = cfg.n_layers
    # GELU leaves: grouped_matmul up and down, a pass each (two past capacity)
    want = {"fused_forest_decode": L * LONG_GEN, "tree_router": L,
            "grouped_matmul": 2 * L * slab_passes(cfg, LONG_PROMPT),
            "grouped_matmul_dual": 0, "gathered_matmul": 0, "gathered_matmul_dual": 0}
    if counts != want:
        raise AssertionError(f"[long] launch counts {counts} != expected {want}")
    if calls != [dict(causal=True, chunk=cfg.attn_chunk, sliding_window=window)] * L:
        raise AssertionError(f"[long] flash_attention calls {calls}")
    if not bool(torch.isfinite(logits).all()) or not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"[long] bad output: tokens {toks}")
    log(f"[long] {cfg.arch_id} FFF full width, {L} of 40 layers, "
        f"{lm.param_count(params) / 1e9:.2f}B params {cfg.param_dtype}, one "
        f"{LONG_PROMPT}-token prompt (window {window}): prefill through flash_attention "
        f"({len(calls)} calls, chunk {cfg.attn_chunk}) {prefill_s * 1e3:.2f} ms (first "
        f"call, host clock); {LONG_GEN} decode steps p50 "
        f"{sorted(step_s)[len(step_s) // 2] * 1e3:.2f} ms; peak memory {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB, max_memory_allocated); tokens {toks}; launches "
        f"{counts} (as expected)")
    # layer 0's q, k, v in float32: flash against the plain masked attention
    acfg = transformer.make_attn_config(cfg, cfg.period[0])
    layer = params["stack"][0]
    with torch.inference_mode():
        from repro_torch.nn import embeddings
        h = norms.norm_apply(cfg.norm, layer["norm1"],
                             embeddings.embed(params["embed"], prompt, cfg.accum_dtype))
        pos = torch.arange(LONG_PROMPT, device="cuda")[None]
        q, k, v = (a.float() for a in attention.qkv(layer["mixer"], acfg, h, pos))
        del params, caches
        torch.cuda.empty_cache()
        got = attention.flash_attention(q, k, v, causal=True, chunk=acfg.chunk,
                                        sliding_window=window)
        i = torch.arange(LONG_PROMPT, device="cuda")
        band = (i[:, None] - i[None, :]) < window
        want = attention.full_attention(q, k, v, causal=True, bias_mask=band)
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or bool((err > 1e-3 + 1e-3 * want.abs()).any()):
            raise AssertionError(f"[long] flash vs plain masked attention: max |err| "
                                 f"{float(err.max()):.3e} exceeds rtol=atol=1e-3")
        del want
        torch.cuda.empty_cache()
        flash_ms = time_ms(lambda: attention.flash_attention(
            q, k, v, causal=True, chunk=acfg.chunk, sliding_window=window), reps=3, warmup=1)
    log(f"[long] layer 0's q {tuple(q.shape)}, k, v {tuple(k.shape)} in float32: "
        f"flash_attention equals the plain masked attention (window {window}) within "
        f"1e-3 (max |err| {float(err.max()):.3e}); flash {flash_ms:.2f} ms a call "
        f"(CUDA events); done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# kimi-k2-1t-a32b, jamba-1.5-large-398b and xlstm-1.3b; the recurrent mixers
# ---------------------------------------------------------------------------

def refuses_engine(serve_mod, label, cfg, params, why="requires attention mixers"
                   ) -> None:
    """serve_engine must refuse a model with a recurrent mixer (or, with
    ``why="decoder-only token LMs"``, an encoder or frontend model), with
    the JAX package's message."""
    from repro_torch.serving.engine import EngineConfig
    reqs = serve_mod.build_requests(cfg.vocab_size, ENGINE_REQS, ENGINE_PROMPT,
                                    ENGINE_GEN, seed=0, min_prompt_len=ENGINE_MIN_PROMPT)
    ecfg = EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                        max_prompt_len=ENGINE_PROMPT, device="cuda")
    try:
        serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
    except ValueError as e:
        if why not in str(e):
            raise
        log(f"{label} engine refuses it: {e}")
        return
    raise AssertionError(f"{label}: the engine served a model it must refuse ({why})")


def random_gates(cfg, params, seed) -> None:
    """The MoE sites' gates drawn N(0, 1/d_model) in place.  init's gates
    are zero (Shazeer), which ties every expert and sends every token to
    experts 0-7; a trained gate spreads tokens over the experts, so the
    gates are drawn at random, as the FFF nodes are."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for layer in params["stack"]:
        g = layer["ffn"]["gate_w"]
        g.copy_(torch.randn(g.shape, generator=gen, device="cuda") * cfg.d_model ** -0.5)


def arch_intro(label, lm, cfg, params, layers_of, t0) -> None:
    tags = sorted({site_tag(fc) for fc in site_configs(cfg) if fc is not None})
    log(f"{label} {cfg.arch_id} full width (d_model {cfg.d_model}, mixers "
        f"{[b.mixer for b in cfg.period]}, FFF sites (trees x leaves x width) "
        f"{tags or 'none'}), {cfg.n_layers} of {layers_of} layers, "
        f"{lm.param_count(params) / 1e9:.2f}B params {cfg.param_dtype}, init "
        f"{time.perf_counter() - t0:.1f}s")


def phase_kimi(common, api, fff, lm, serve_mod) -> dict:
    """kimi-k2-1t-a32b FFF (8 trees of depth 6, leaves of 2048, D 7168) at
    KIMI_LAYERS of 61 layers, bf16: every kernel at its site's shapes, the
    fixed-batch loop; the native MoE (384 experts, top 8, on the grouped
    GEMMs) through the same loop, from graphs and op by op; fp32 greedy
    parity with the forest cut to KIMI_PARITY_TREES trees.  Returns the
    kernel rows with their launches."""
    from repro_torch.configs import kimi_k2_1t_a32b as mod
    t0 = time.perf_counter()
    label = "[kimi]"
    cfg = dataclasses.replace(mod.FFF_CONFIG, n_layers=KIMI_LAYERS)
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    arch_intro(label, lm, cfg, params, mod.CONFIG.n_layers, t0)
    with torch.inference_mode():
        rows = arch_kernels(label, cfg, params)
    counts, res = phase_serve(common, api, serve_mod, cfg, params, label=label)
    log_rows(rows, f"{label} kernel", counts)
    fff_p50 = res.steady.p50_ms
    del params, res
    free_device()
    t1 = time.perf_counter()
    ncfg = dataclasses.replace(mod.CONFIG, n_layers=KIMI_LAYERS)
    params = lm.init(ncfg, seed=0, device="cuda")
    random_gates(ncfg, params, seed=6)
    torch.cuda.synchronize()
    arch_intro(f"{label} native MoE", lm, ncfg, params, mod.CONFIG.n_layers, t1)
    _, res = phase_serve(common, api, serve_mod, ncfg, params, label=f"{label} native")
    log(f"{label} decode p50 (batch {PREFILL_B}, {KIMI_LAYERS} layer, host clock, both "
        f"on graphs): FFF forest {fff_p50:.2f} ms, native MoE (384 experts, top 8, on "
        f"the grouped GEMMs, gates drawn N(0, 1/d_model)) {res.steady.p50_ms:.2f} ms")
    del params, res
    free_device()
    cut = dataclasses.replace(mod.FFF_CONFIG, period=tuple(
        dataclasses.replace(b, ffn=dataclasses.replace(b.ffn, fff_trees=KIMI_PARITY_TREES))
        for b in mod.FFF_CONFIG.period))
    phase_parity(api, fff, lm, cut, label=f"{label} parity (forest cut to "
                 f"{KIMI_PARITY_TREES} of 8 trees)", exact=False, layers=KIMI_LAYERS)
    log(f"{label} done in {time.perf_counter() - t0:.1f}s")
    return {k: dict(v, launches=counts.get(kernel_of(k), 0)) for k, v in rows.items()}


def phase_jamba(common, api, fff, lm, serve_mod) -> dict:
    """jamba-1.5-large-398b FFF, bf16, its period cut to JAMBA_POSITIONS
    (the port's layer i takes period[i % len(period)], so a depth cut on
    the published period would never reach its attention block): every
    kernel at both site configs' shapes, the fixed-batch loop, the
    engine's refusal, fp32 greedy parity.  Returns the kernel rows."""
    from repro_torch.configs import jamba_1_5_large_398b as mod
    t0 = time.perf_counter()
    label = "[jamba]"
    base = mod.FFF_CONFIG
    cfg = dataclasses.replace(base, period=tuple(base.period[i] for i in JAMBA_POSITIONS),
                              n_layers=len(JAMBA_POSITIONS))
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    arch_intro(label, lm, cfg, params, base.n_layers, t0)
    with torch.inference_mode():
        rows = arch_kernels(label, cfg, params)
    counts, _ = phase_serve(common, api, serve_mod, cfg, params, label=label)
    log_rows(rows, f"{label} kernel", counts)
    refuses_engine(serve_mod, label, cfg, params)
    del params
    torch.cuda.empty_cache()
    phase_parity(api, fff, lm, cfg, label=f"{label} parity", exact=False,
                 layers=len(JAMBA_POSITIONS))
    log(f"{label} done in {time.perf_counter() - t0:.1f}s")
    return {k: dict(v, launches=counts.get(kernel_of(k), 0)) for k, v in rows.items()}


def phase_xlstm(common, api, lm, serve_mod) -> None:
    """xlstm-1.3b, all 48 layers, bf16: no FFN site, so the fixed-batch
    loop must launch no kernel; the engine refuses it."""
    from repro_torch.configs import xlstm_1_3b as mod
    t0 = time.perf_counter()
    label = "[xlstm]"
    cfg = mod.FFF_CONFIG
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    arch_intro(label, lm, cfg, params, cfg.n_layers, t0)
    counts, _ = phase_serve(common, api, serve_mod, cfg, params, label=label)
    if any(counts.values()):
        raise AssertionError(f"{label} a kernel launched: {counts}")
    refuses_engine(serve_mod, label, cfg, params)
    del params
    torch.cuda.empty_cache()
    log(f"{label} done in {time.perf_counter() - t0:.1f}s")


def close_e2e(name, got, want) -> float:
    """got (card) against want (CPU) within rtol = atol = E2E; max |err|."""
    g, w = got.float().cpu(), want.float().cpu()
    err = (g - w).abs()
    if not bool(torch.isfinite(g).all()) or bool((err > E2E + E2E * w.abs()).any()):
        raise AssertionError(f"{name}: max |err| {float(err.max()):.3e} exceeds "
                             f"rtol=atol={E2E}")
    return float(err.max())


def phase_mixers() -> None:
    """The recurrent mixers at full width in float32, the card against the
    CPU with the same weights: Mamba at jamba's D 8192, the mLSTM and sLSTM
    blocks at xlstm's D 2048.  A prefill of MIXER_B x MIXER_S tokens from
    zeros, then MIXER_STEPS one-token steps from its state: every output
    and the final state within E2E.  On the card, chunkwise mLSTM (chunks
    of 8 and the default 256) against the sequential recurrence."""
    from repro_torch import utils
    from repro_torch.configs import jamba_1_5_large_398b as jamba, xlstm_1_3b as xl
    from repro_torch.nn import mamba, transformer, xlstm
    t0 = time.perf_counter()
    f32 = lambda c: dataclasses.replace(c, param_dtype=torch.float32,
                                        accum_dtype=torch.float32)
    mcfg = transformer.make_mamba_config(f32(jamba.CONFIG))
    xcfg = transformer.make_xlstm_config(f32(xl.CONFIG))
    gen = torch.Generator().manual_seed(11)
    cases = (("mamba", mamba.init(gen, mcfg), mcfg.d_model,
              lambda p, x, st: (mamba.forward if st is None else mamba.forward_step)(
                  p, mcfg, x, st)),
             ("mlstm", xlstm.mlstm_init(gen, xcfg), xcfg.d_model,
              lambda p, x, st: xlstm.mlstm_block(p, xcfg, x, st)),
             ("slstm", xlstm.slstm_init(gen, xcfg), xcfg.d_model,
              lambda p, x, st: xlstm.slstm_block(p, xcfg, x, st)))
    for name, p_cpu, d, fwd in cases:
        x = torch.randn((MIXER_B, MIXER_S + MIXER_STEPS, d), generator=gen)
        out = {}
        for dev, p in (("cpu", p_cpu), ("cuda", utils.tree_map(lambda a: a.cuda(), p_cpu))):
            xd = x.to(dev)
            with torch.inference_mode():
                t1 = time.perf_counter()
                y, st = fwd(p, xd[:, :MIXER_S], None)
                ys = [y]
                for i in range(MIXER_S, MIXER_S + MIXER_STEPS):
                    y, st = fwd(p, xd[:, i:i + 1], st)
                    ys.append(y)
                if dev == "cuda":
                    torch.cuda.synchronize()
                out[dev] = (torch.cat(ys, dim=1), st, time.perf_counter() - t1)
        (yc, sc, tc), (yg, sg, tg) = out["cpu"], out["cuda"]
        err = close_e2e(f"[mixers] {name} output", yg, yc)
        st_err = max(close_e2e(f"[mixers] {name} state.{f}", a, b)
                     for f, a, b in zip(type(sg)._fields, sg, sc))
        log(f"[mixers] {name} (d_model {d}, {sum(a.numel() for a in utils.tree_leaves(p_cpu)) / 1e6:.1f}M params "
            f"fp32): prefill {MIXER_B}x{MIXER_S} + {MIXER_STEPS} steps, card equals "
            f"CPU within {E2E} (max |err| output {err:.3e}, state {st_err:.3e}; state "
            f"{[tuple(a.shape) for a in sg]}); card {tg * 1e3:.1f} ms, CPU "
            f"{tc * 1e3:.1f} ms (host clock, first call)")
        if name == "mlstm":
            p = utils.tree_map(lambda a: a.cuda(), p_cpu)
            xg = x[:, :MIXER_S].cuda()
            with torch.inference_mode():
                seq, seq_st = xlstm.mlstm_block(p, xcfg, xg, sequential=True)
                for chunk in (8, xcfg.chunk):
                    ccfg = dataclasses.replace(xcfg, chunk=chunk)
                    got, got_st = xlstm.mlstm_block(p, ccfg, xg)
                    e = close_e2e(f"[mixers] mlstm chunk {chunk} vs sequential", got, seq)
                    for f, a, b in zip(got_st._fields, got_st, seq_st):
                        close_e2e(f"[mixers] mlstm chunk {chunk} state.{f}", a, b)
                    log(f"[mixers] mlstm on the card: chunkwise (chunk {chunk}) equals the "
                        f"sequential recurrence within {E2E} (max |err| {e:.3e})")
            del p
        torch.cuda.empty_cache()
    log(f"[mixers] done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# whisper-small (encoder-decoder, cross-attention) and internvl2-26b (vision stub)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def backends_ran(api):
    """Yields a list that takes (mode, name) of every FFF backend that runs
    inside the context."""
    saved, ran = dict(api._REGISTRY), []
    for key, fn in saved.items():
        api._REGISTRY[key] = lambda *a, _fn=fn, _k=key: (ran.append(_k), _fn(*a))[1]
    try:
        yield ran
    finally:
        api._REGISTRY.update(saved)


@contextlib.contextmanager
def grouped_ep_alone(api):
    """``overrides(backend="grouped_ep")`` in one process: its supports
    predicate asks for a model group of more than one rank (auto's rule),
    so an override would fall through to the kernel backends; inside this
    context it is eligible wherever the tree has a leaf to route to."""
    fn, pred = api.get_backend("infer", "grouped_ep"), api._SUPPORTS[("infer", "grouped_ep")]
    api.register_backend("infer", "grouped_ep", fn,
                         supports=lambda params, cfg: cfg.depth > 0)
    try:
        with api.overrides(backend="grouped_ep", mode="infer"):
            yield
    finally:
        api.register_backend("infer", "grouped_ep", fn, supports=pred)


def swiglu_probe(label, cfg, params) -> dict:
    """The two dual kernels, which a GELU site never runs, at the site's
    shapes (D, E leaves of width L) on random SwiGLU leaves, routed by
    layer 0's nodes: the grouped dual at the 1024-token prefill slab and
    the gathered dual at the 32-token verify slab, each twice
    (bit-identical) against its plain version, with its row."""
    from repro_torch import utils
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    fc = site_configs(cfg)[0]
    nw, nb = (t[0].contiguous() for t in fd_ops.collapse_nodes(params["stack"][0]["ffn"], fc))
    E, L, d, dtype = fc.num_leaves, fc.leaf_width, cfg.d_model, cfg.param_dtype
    gen = torch.Generator(device="cuda").manual_seed(8)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device="cuda")
                                   * scale).to(dtype)
    wg, wu = randn(E, d, L, scale=d ** -0.5), randn(E, d, L, scale=d ** -0.5)
    wd = randn(E, L, d, scale=L ** -0.5)
    tag = f"{label} [swiglu probe]"
    x = randn(PREFILL_B * PREFILL_S, d)
    leaf, _ = routed(f"{tag} tree_router", x, nw, nb, fc.depth)
    C = max(128, utils.round_up(int(2.0 * utils.cdiv(x.shape[0], E)), 128))
    lay = gemm_ops.scatter_to_groups(x, leaf, E, C)
    _, grouped = grouped_rows(tag, lay.x_grouped, (wg, wu), wd, lay.group_sizes,
                              "swiglu", dtype)
    x = randn(VERIFY_B, d)
    leaf, _ = routed(f"{tag} tree_router@32", x, nw, nb, fc.depth)
    _, gathered = gathered_rows(tag, x, (wg, wu), wd, leaf, "swiglu", dtype)
    return {"grouped_matmul_dual [swiglu probe]": dict(grouped["grouped_matmul_dual"],
                                                       capacity=C),
            "gathered_matmul_dual [swiglu probe]": gathered["gathered_matmul_dual"]}


def encoder_card_vs_cpu(lm, base_cfg, label) -> None:
    """The encoder in float32 (TF32 off) over WHISPER_CPU_B x seq_len frame
    embeddings, one seeded param tree on the CPU and on the card: the
    outputs within E2E."""
    from repro_torch import utils
    cfg = dataclasses.replace(base_cfg, param_dtype=torch.float32,
                              accum_dtype=torch.float32)
    t0 = time.perf_counter()
    p_cpu = lm.init(cfg, seed=3, device="cpu")
    enc = torch.randn((WHISPER_CPU_B, cfg.encoder.seq_len, cfg.d_model),
                      generator=torch.Generator().manual_seed(5))
    out, secs = {}, {}
    for where, p in (("CPU", p_cpu), ("card", utils.tree_map(lambda a: a.cuda(), p_cpu))):
        with torch.inference_mode():
            t1 = time.perf_counter()
            out[where] = lm.encode(p, cfg, enc.to(p["enc_norm"]["scale"].device))
            torch.cuda.synchronize()
            secs[where] = time.perf_counter() - t1
        del p
    err = close_e2e(f"{label} encoder fp32, card against CPU", out["card"], out["CPU"])
    log(f"{label} encoder fp32 ({cfg.encoder.n_layers} layers, {WHISPER_CPU_B} x "
        f"{cfg.encoder.seq_len} frames): card equals CPU within {E2E} (max |err| "
        f"{err:.3e}); card {secs['card'] * 1e3:.1f} ms, CPU {secs['CPU'] * 1e3:.1f} ms "
        f"(host clock, first call); done in {time.perf_counter() - t0:.1f}s")
    del p_cpu
    torch.cuda.empty_cache()


def warm_serve(serve_mod, label, cfg, params) -> None:
    """The fixed-batch loop again, warm: its prefill and decode times."""
    res = serve_mod.serve(cfg, batch=PREFILL_B, prompt_len=PREFILL_S, gen=GEN,
                          device="cuda", params=params)
    log(f"{label} serve again (warm) batch {PREFILL_B} x prompt {PREFILL_S}, {GEN} "
        f"decode steps: prefill {res.prefill_s * 1e3:.2f} ms; decode p50 "
        f"{res.steady.p50_ms:.2f} ms p90 {res.steady.p90_ms:.2f} ms; "
        f"{res.tokens_per_s:.1f} tok/s (host clock)")


def phase_whisper(common, api, fff, lm, serve_mod) -> dict:
    """whisper-small FFF whole (12 encoder + 12 decoder layers), bf16: every
    kernel at the decoder site's shapes (D 768, one tree of depth 3, 8
    GELU leaves of 384) and the two dual kernels on SwiGLU leaves of those
    shapes; the encoder launches nothing (its sites run FORWARD_T in train
    mode, as in the JAX package); the fixed-batch loop with enc_embeds
    (8, 1500, 768) and its launch counts, again warm, and a profiled warm
    prefill and decode step; the engine's refusal; the fp32 encoder on the
    card against the CPU; fp32 greedy parity at full depth.
    Returns the kernel rows with their launches."""
    from repro_torch.configs import whisper_small as mod
    t0 = time.perf_counter()
    label = "[whisper]"
    cfg = mod.FFF_CONFIG
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    arch_intro(label, lm, cfg, params, cfg.n_layers, t0)
    log(f"{label} encoder: {cfg.encoder.n_layers} layers over {cfg.encoder.seq_len} "
        f"frames, sinusoidal positions; decoder: learned positions "
        f"({cfg.max_seq_len} rows), cross-attention in every block")
    with torch.inference_mode():
        rows = arch_kernels(label, cfg, params)
        rows.update(swiglu_probe(label, cfg, params))
    enc = torch.randn((PREFILL_B, cfg.encoder.seq_len, cfg.d_model), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(9))
    with torch.inference_mode(), backends_ran(api) as ran:
        common.reset_launch_counts()
        out = lm.encode(params, cfg, enc)
        torch.cuda.synchronize()
        counts = common.launch_counts()
    if any(counts.values()) or set(ran) != {("train", "reference")} or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"{label} encode: launches {counts}, backends {set(ran)}")
    log(f"{label} encode {tuple(enc.shape)}: no kernel launched, every site on "
        f"{sorted(set(ran))} ({len(ran)} site calls), output finite {tuple(out.shape)}")
    del out, enc
    counts, _ = phase_serve(common, api, serve_mod, cfg, params, label=label)
    log_rows(rows, f"{label} kernel", counts)
    warm_serve(serve_mod, label, cfg, params)
    phase_profile(cfg, params, lm, inputs=lambda prompt: {
        "tokens": prompt, "enc_embeds": torch.randn(
            (prompt.shape[0], cfg.encoder.seq_len, cfg.d_model), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(9))})
    refuses_engine(serve_mod, label, cfg, params, why="decoder-only token LMs")
    del params
    torch.cuda.empty_cache()
    encoder_card_vs_cpu(lm, cfg, label)
    phase_parity(api, fff, lm, cfg, label=f"{label} parity", exact=False,
                 layers=cfg.n_layers, inputs=lambda c, prompt, gen: {
                     "tokens": prompt, "enc_embeds": torch.randn(
                         (prompt.shape[0], c.encoder.seq_len, c.d_model), generator=gen,
                         device="cuda")})
    log(f"{label} done in {time.perf_counter() - t0:.1f}s")
    return {k: dict(v, launches=counts.get(kernel_of(k), 0)) for k, v in rows.items()}


def phase_internvl(common, api, fff, lm, serve_mod) -> None:
    """internvl2-26b FFF at full width (D 6144, one tree of 16 SwiGLU leaves
    of 1024, the 92553-word head), INTERNVL_LAYERS of 48 layers, bf16: the
    fixed-batch loop with an embeds prompt (8 x 128 x 6144) in place of
    tokens and its launch counts, warm again, and a profiled warm prefill
    and decode step; the engine's refusal; fp32 greedy parity at
    PARITY_LAYERS layers from an embeds prompt."""
    from repro_torch.configs import internvl2_26b as mod
    t0 = time.perf_counter()
    label = "[internvl]"
    cfg = dataclasses.replace(mod.FFF_CONFIG, n_layers=INTERNVL_LAYERS)
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    arch_intro(label, lm, cfg, params, mod.CONFIG.n_layers, t0)
    phase_serve(common, api, serve_mod, cfg, params, label=label)
    warm_serve(serve_mod, label, cfg, params)
    phase_profile(cfg, params, lm, inputs=lambda prompt: {"embeds": torch.randn(
        (*prompt.shape, cfg.d_model), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(9))})
    refuses_engine(serve_mod, label, cfg, params, why="decoder-only token LMs")
    del params
    torch.cuda.empty_cache()
    phase_parity(api, fff, lm, mod.FFF_CONFIG, label=f"{label} parity", exact=False,
                 inputs=lambda c, prompt, gen: {"embeds": torch.randn(
                     (*prompt.shape, c.d_model), generator=gen, device="cuda")})
    log(f"{label} done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# the disaggregated cluster and registry-arch drafts


def cluster_ecfg(slots=SLOTS, **kw):
    """The engine phase's shapes on the paged cache (pages of PAGE), greedy,
    no speculation: one worker's engine, or one engine of ``slots``."""
    from repro_torch.serving.engine import EngineConfig
    return EngineConfig(num_slots=slots, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                        max_prompt_len=ENGINE_PROMPT, page_size=PAGE, seed=0,
                        device="cuda", **kw)


def engine_requests(serve_mod, cfg):
    return serve_mod.build_requests(cfg.vocab_size, ENGINE_REQS, ENGINE_PROMPT,
                                    ENGINE_GEN, seed=0, min_prompt_len=ENGINE_MIN_PROMPT)


def by_rid(results) -> dict:
    return {r.rid: np.asarray(r.tokens) for r in results}


def first_diff(a, b) -> int:
    n = min(len(a), len(b))
    d = np.nonzero(a[:n] != b[:n])[0]
    return int(d[0]) if d.size else n


def handoff_round_trip(cfg, params, reqs) -> dict:
    """extract -> install between two engines of the same shape, 8 requests
    a wave: the decode engine's installed pages equal the prefill engine's
    bit for bit (on the card) and the shipped rows; then both decode their
    8 requests, the prefill engine keeping its slots, and every token must
    agree.  Returns per-request bytes and extract / install ms (each call
    between two synchronizations)."""
    from repro_torch.cluster import handoff
    from repro_torch.serving.engine import ContinuousBatchingEngine
    stats = {"bytes": [], "extract_ms": [], "install_ms": []}
    for w in range(0, len(reqs), SLOTS):
        wave = reqs[w:w + SLOTS]
        src = ContinuousBatchingEngine(params, cfg, cluster_ecfg())
        dst = ContinuousBatchingEngine(params, cfg, cluster_ecfg())
        for r in wave:
            src.submit(r)
        while src.queue:
            src._admit()
        for i, st in enumerate(src.slots):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = handoff.extract(src, i)
            t1 = time.perf_counter()
            if handoff.install(dst, h) != i:
                raise AssertionError(f"[cluster] handoff of rid {st.request.rid} "
                                     f"did not install into slot {i}")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            stats["bytes"].append(h.nbytes)
            stats["extract_ms"].append((t1 - t0) * 1e3)
            stats["install_ms"].append((t2 - t1) * 1e3)
            a, b = src._slot_pages[i][:h.n_pages], dst._slot_pages[i][:h.n_pages]
            for layer, (cs, cd) in enumerate(zip(src.caches, dst.caches)):
                for name, rows in (("k", h.k_rows), ("v", h.v_rows)):
                    got = getattr(cd["kv"], name)[b]
                    if not (torch.equal(got, getattr(cs["kv"], name)[a])
                            and torch.equal(got, rows[layer].cuda())):
                        raise AssertionError(
                            f"[cluster] rid {st.request.rid} layer {layer} {name}: "
                            f"installed pages differ from the extracted ones")
        while src.has_work() or dst.has_work():
            src.step()
            dst.step()
        want, got = by_rid(src.results), by_rid(dst.results)
        bad = [rid for rid in want if not np.array_equal(want[rid], got[rid])]
        if bad or len(got) != len(wave):
            raise AssertionError(f"[cluster] rids {bad}: the decode engine's tokens "
                                 f"differ from the prefill engine's own after the handoff")
    return stats


def cluster_fleet(common, cfg, params, reqs, n_prefill=1, n_decode=2):
    """A LocalBus fleet sharing ``params``: ``n_prefill`` + ``n_decode``
    workers of SLOTS slots, the router on the host clock.  Each worker's
    tick is wrapped to read the launch counts around it and to keep the
    handoffs it sends.  Returns (results, metrics, cluster metrics, launches
    per wid, engines per wid, handoffs per rid)."""
    from repro_torch.cluster import ClusterConfig, ClusterWorker, LocalBus, Router
    from repro_torch.cluster import bus as bus_lib
    from repro_torch.cluster.control import ControlConfig
    from repro_torch.serving.engine import ContinuousBatchingEngine
    per, engines, handoffs = {}, {}, {}

    def factory(wid, role):
        engines[wid] = ContinuousBatchingEngine(params, cfg, cluster_ecfg())
        w = ClusterWorker(wid, role, engines[wid])
        tick = w.tick

        def counted():
            before = common.launch_counts()
            out = tick()
            after = common.launch_counts()
            c = per.setdefault(wid, {})
            for k, v in after.items():
                c[k] = c.get(k, 0) + v - before.get(k, 0)
            handoffs.update({m.handoff.request.rid: m.handoff for m in out
                             if isinstance(m, bus_lib.PrefillDone)})
            return out

        w.tick = counted
        return w

    router = Router(LocalBus(factory), ClusterConfig(
        n_prefill=n_prefill, n_decode=n_decode, page_size=PAGE,
        control=ControlConfig(heartbeat_timeout=600.0, scale_up_watermark=1e9,
                              scale_down_watermark=-1.0)), clock=time.monotonic)
    router.start()
    t0 = time.monotonic()
    results = router.run(reqs)
    m = router.metrics(elapsed_s=time.monotonic() - t0)
    cm = router.cluster_metrics()
    router.shutdown()
    return results, m, cm, per, engines, handoffs


def check_roles(per, engines) -> None:
    """The per-role contract: a prefill worker launches no fused decode and
    its compiled dispatches are admission and its slabs alone, each one
    graph; a decode worker launches the fused decode kernel alone and its
    dispatches are decode and install, each one graph."""
    for wid, eng in engines.items():
        c, shapes = per.get(wid, {}), eng.compiled_shapes()
        if wid.startswith("p"):
            ok = (c.get("fused_forest_decode", 0) == 0 and c.get("tree_router", 0) > 0
                  and shapes.pop("admit", 0) == 1 and shapes
                  and all(k.startswith("prefill_") for k in shapes)
                  and eng._graphs.counts() == dict(shapes, admit=1))
        else:
            ok = (c.get("fused_forest_decode", 0) > 0
                  and sum(v for k, v in c.items() if k != "fused_forest_decode") == 0
                  and shapes == eng._graphs.counts() == {"decode": 1, "install": 1})
        if not ok:
            raise AssertionError(f"[cluster] worker {wid}: launches {c}, dispatch "
                                 f"shapes {shapes} break its role's contract")


def kv_differs(h, snap) -> bool:
    """Whether two handoffs of one prompt hold different K/V at any prompt
    position (the rows past the prompt in its last page are not compared)."""
    L = h.prompt_len
    flat = lambda t: t.reshape(-1, *t.shape[2:])[:L]
    return any(not torch.equal(flat(a), flat(b))
               for a, b in zip(h.k_rows + h.v_rows, snap.k_rows + snap.v_rows))


def one_engine_snapshots(cfg, params, reqs, slots) -> dict:
    """One engine of ``slots`` slots serving ``reqs``, each request's prompt
    K/V copied (``handoff.extract``, which releases nothing) right after
    the step that prefilled it."""
    from repro_torch.cluster import handoff
    from repro_torch.serving.engine import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(params, cfg, cluster_ecfg(slots))
    snaps, step = {}, eng.step

    def stepped():
        step()
        for i, st in enumerate(eng.slots):
            if st is not None and st.tokens and st.request.rid not in snaps:
                snaps[st.request.rid] = handoff.extract(eng, i)

    eng.step = stepped
    eng.run(reqs)
    return snaps


def phase_cluster(common, api, fff, lm, serve_mod, cfg, params) -> None:
    """The disaggregated cluster at full width (module docstring, phase 20)."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    reqs = engine_requests(serve_mod, cfg)
    n_workers = 3
    log(f"[cluster] {cfg.arch_id} FFF full width, {cfg.n_layers} layers "
        f"{cfg.param_dtype}, LocalBus, 1 prefill + 2 decode workers sharing one "
        f"parameter set, {SLOTS} slots each, pages of {PAGE}; {len(reqs)} requests, "
        f"prompts {min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)}"
        f" tokens, {ENGINE_GEN} greedy tokens each")
    with no_reference(api):
        with sync_checked("[cluster] handoff round trip"):
            rt = handoff_round_trip(cfg, params, reqs)
        b = np.asarray(rt["bytes"])
        log(f"[cluster] handoff round trip: {len(b)} requests, installed pages equal "
            f"the extracted ones bit for bit and the decode engine's tokens equal the "
            f"prefill engine's own; bytes a request min {b.min()} mean {b.mean():.0f} max "
            f"{b.max()} ({b.sum() / sum(len(r.prompt) for r in reqs):.0f} a prompt token, "
            f"{b.sum() / 1e6:.2f} MB in all); extract ms p50 "
            f"{np.median(rt['extract_ms']):.3f} max {max(rt['extract_ms']):.3f}; install "
            f"ms p50 {np.median(rt['install_ms']):.3f} max {max(rt['install_ms']):.3f} "
            f"(host clock, each call between two synchronizations; an engine's first "
            f"install runs eagerly and captures its graph, the rest replay it)")
        one = ContinuousBatchingEngine(params, cfg, cluster_ecfg(n_workers * SLOTS))
        want, m1 = one.run(reqs)
        same, _ = ContinuousBatchingEngine(params, cfg, cluster_ecfg()).run(reqs)
        common.reset_launch_counts()
        res, m, cm, per, engines, handoffs = cluster_fleet(common, cfg, params, reqs)
        total = common.launch_counts()
    check_roles(per, engines)
    if sorted(r.rid for r in res) != list(range(len(reqs))) or cm["duplicate_results"]:
        raise AssertionError(f"[cluster] results {sorted(r.rid for r in res)}, "
                             f"{cm['duplicate_results']} duplicates")
    log(f"[cluster] launches {total}; by worker " + "; ".join(
        f"{w} {dict(sorted((k, v) for k, v in c.items() if v))} shapes "
        f"{engines[w].compiled_shapes()}" for w, c in sorted(per.items()))
        + " (per-role contract holds)")
    for tag, mm in (("cluster 1+2", m), (f"one engine, {n_workers * SLOTS} slots", m1)):
        log(f"[cluster] {tag}: TTFT p50 {mm.ttft.p50_ms:.2f} ms p90 {mm.ttft.p90_ms:.2f} "
            f"ms; per-token p50 {mm.per_token.p50_ms:.2f} ms p90 {mm.per_token.p90_ms:.2f}"
            f" ms; {mm.throughput_tok_s:.1f} tok/s (host clock)")
    log(f"[cluster] handoff bytes in all {cm['handoff_bytes']} "
        f"({cm['handoff_bytes'] / len(reqs) / 1e6:.3f} MB a request); tok/s "
        f"cluster / one engine {m.throughput_tok_s / m1.throughput_tok_s:.3f}")
    got, ref = by_rid(res), by_rid(want)
    diff = [rid for rid in ref if not np.array_equal(got[rid], ref[rid])]
    ref8 = by_rid(same)
    diff8 = [rid for rid in ref8 if not np.array_equal(got[rid], ref8[rid])]
    if diff8:
        raise AssertionError(f"[cluster] rids {diff8}: the cluster's tokens differ from "
                             f"one engine's of a worker's {SLOTS} slots")
    log(f"[cluster] {cfg.param_dtype} tokens: every request equals one engine's of "
        f"{SLOTS} slots (a worker's size); {len(diff)} of {len(reqs)} differ from the "
        f"one engine's of {n_workers * SLOTS} slots")
    if diff:
        snaps = one_engine_snapshots(cfg, params, reqs, n_workers * SLOTS)
        for rid in diff:
            log(f"[cluster]   rid {rid}: first differing token {first_diff(got[rid], ref[rid])}"
                f" of {ENGINE_GEN}; handed-off prompt K/V "
                f"{'differ' if kv_differs(handoffs[rid], snaps[rid]) else 'equal'} "
                f"from the one engine's")
    del handoffs
    cluster_parity(api, fff, lm, serve_mod, cfg)


def cluster_parity(api, fff, lm, serve_mod, base_cfg) -> None:
    """fp32 at PARITY_LAYERS layers: the LocalBus fleet and one engine of
    the same slots give lm.generate's greedy tokens, off near-ties."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.kernels import common
    cfg = dataclasses.replace(base_cfg, n_layers=PARITY_LAYERS,
                              param_dtype=torch.float32, accum_dtype=torch.float32)
    params = lm.init(cfg, seed=1, device="cuda")
    reqs = engine_requests(serve_mod, cfg)
    want, margin = generate_with_margins(api, fff, lm, cfg, params, reqs, ENGINE_GEN,
                                         ENGINE_PROMPT + ENGINE_GEN + 1)
    res = cluster_fleet(common, cfg, params, reqs)[0]
    one, _ = ContinuousBatchingEngine(params, cfg, cluster_ecfg(3 * SLOTS)).run(reqs)
    ties = [near_tie_check(f"[cluster parity] {tag}", by_rid(r), want, margin)
            for tag, r in (("cluster", res), ("one engine", one))]
    log(f"[cluster parity] {cfg.n_layers} layers fp32, {len(reqs)} requests x "
        f"{ENGINE_GEN} greedy tokens: the cluster (1 prefill + 2 decode) and one "
        f"engine of {3 * SLOTS} slots equal lm.generate ({ties[0]} and {ties[1]} "
        f"near-tie differences); smallest deciding margin {min(margin.values()):.3e}")
    del params
    torch.cuda.empty_cache()


def phase_cluster_proc(serve_mod, lm, base_cfg) -> None:
    """The cluster on ProcBus at PARITY_LAYERS layers, bf16 (module
    docstring, phase 21)."""
    import multiprocessing
    import tempfile
    from repro_torch.cluster import ClusterConfig, ProcBus, Router, WorkerSpec
    from repro_torch.cluster.control import ControlConfig
    from repro_torch.cluster.worker import weights_checksum
    from repro_torch.kernels import common
    cfg = dataclasses.replace(base_cfg, n_layers=PARITY_LAYERS)
    reqs = engine_requests(serve_mod, cfg)
    params = lm.init(cfg, seed=0, device="cuda")
    checksum = weights_checksum(params)
    want = by_rid(cluster_fleet(common, cfg, params, reqs)[0])
    del params
    torch.cuda.empty_cache()
    bus = ProcBus(lambda wid, role: WorkerSpec(
        wid=wid, role=role, cfg=cfg, ecfg=cluster_ecfg(), seed=0, device="cuda"))
    router = Router(bus, ClusterConfig(
        n_prefill=1, n_decode=2, page_size=PAGE,
        control=ControlConfig(heartbeat_timeout=600.0, scale_up_watermark=1e9,
                              scale_down_watermark=-1.0)), clock=time.monotonic)
    killed = []

    def on_tick(r):
        if not killed and len(r.results) >= CLUSTER_KILL_AFTER:
            killed.append(next(w for w, v in sorted(r.views.items()) if v.role == "decode"))
            r.kill_worker(killed[0])

    t0 = time.perf_counter()
    try:
        router.start()
        res = router.run(reqs, on_tick=on_tick)
        router.drain_all()
        deadline = time.monotonic() + 120
        while router.views and time.monotonic() < deadline:
            router.step()
        drained = not router.views
    finally:
        router.shutdown()
    wall = time.perf_counter() - t0
    left = multiprocessing.active_children()
    cm = router.cluster_metrics()
    got = by_rid(res)
    if left:
        raise AssertionError(f"[cluster_proc] child processes left behind: {left}")
    if sorted(r.rid for r in res) != list(range(len(reqs))) or cm["duplicate_results"] \
            or cm["worker_restarts"] != 1:
        raise AssertionError(f"[cluster_proc] rids {sorted(r.rid for r in res)}, "
                             f"duplicates {cm['duplicate_results']}, restarts "
                             f"{cm['worker_restarts']}")
    bad = [rid for rid in want if not np.array_equal(got[rid], want[rid])]
    if bad:
        raise AssertionError(f"[cluster_proc] rids {bad}: tokens after the kill differ "
                             f"from the run without one")
    sums = router.checksums
    if set(sums) != set(bus.ready_s) or set(sums.values()) != {checksum}:
        raise AssertionError(f"[cluster_proc] weights checksums {sums} != this "
                             f"process's {checksum}")
    if not drained:
        raise AssertionError("[cluster_proc] the drain did not finish")
    peaks = {w: b.metrics.get("peak_bytes", 0) / 2 ** 30 for w, b in router.byes.items()}
    log(f"[cluster_proc] {cfg.arch_id} FFF full width, {cfg.n_layers} layers "
        f"{cfg.param_dtype}, ProcBus (spawn), 1 prefill + 2 decode processes on the "
        f"one card: {len(reqs)} requests, decode worker {killed[0]} SIGKILLed after "
        f"{CLUSTER_KILL_AFTER} results, {cm['replayed_requests']} requests replayed, "
        f"1 respawn, 0 duplicate results; "
        f"every rid once, tokens equal the run without a kill (LocalBus, "
        f"same weights); drain clean ({len(router.byes)} goodbyes); every child's "
        f"weights checksum {checksum} equals this process's; no child left; "
        f"{wall:.1f}s")
    log(f"[cluster_proc] spawn-to-first-heartbeat s " + " ".join(
        f"{w}={s:.2f}" for w, s in sorted(bus.ready_s.items()))
        + "; peak device memory GiB (torch, per process) "
        + " ".join(f"{w}={g:.2f}" for w, g in sorted(peaks.items())))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cluster.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--cluster", "1", "2",
               "--cluster-kill", "4", "--cluster-verify", "--drain",
               "--metrics-json", str(path)]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"[cluster_proc] the serve CLI failed:\n"
                                 f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        payload = json.loads(path.read_text())
    if payload.get("parity_ok") is not True or payload["cluster"]["worker_restarts"] != 1 \
            or "drained: clean" not in out.stdout:
        raise AssertionError(f"[cluster_proc] the serve CLI: parity_ok "
                             f"{payload.get('parity_ok')}, cluster {payload['cluster']}"
                             f"\n{out.stdout[-3000:]}")
    log(f"[cluster_proc] CLI {' '.join(cmd[1:])} (reduced, on the card by default): "
        f"parity_ok true, 1 restart, drain clean, {time.perf_counter() - t0:.1f}s")


def phase_draft(common, api, fff, lm, serve_mod, cfg, params) -> dict:
    """The engine with a registry-arch draft (module docstring, phase 22).
    Returns the draft site's kernel rows with the draft's launches."""
    from repro_torch.serving import spec as spec_lib
    from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
    label = f"[draft] {DRAFT_ARCH}"
    dparams, dcfg = spec_lib.build_draft(DRAFT_ARCH, params, cfg, seed=0)
    fc = site_configs(dcfg)[0]
    log(f"{label} draft: {DRAFT_ARCH} reduced to d_model {dcfg.d_model}, "
        f"{dcfg.n_heads} heads ({dcfg.n_kv_heads} KV), vocab {dcfg.vocab_size}, "
        f"{dcfg.n_layers} layer, {fc.trees} tree of depth {fc.depth}, {fc.num_leaves} "
        f"{fc.activation} leaves of width {fc.leaf_width}, {dcfg.param_dtype} (as "
        f"reduced() makes it), {lm.param_count(dparams) / 1e9:.2f}B params")
    with torch.inference_mode():
        rows = arch_kernels(label, dcfg, dparams)
    del dparams
    torch.cuda.empty_cache()
    reqs = engine_requests(serve_mod, cfg)
    kw = dict(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
              max_prompt_len=ENGINE_PROMPT, scheduler="fcfs", seed=0, device="cuda")
    ecfg = EngineConfig(spec_k=SPEC_K, draft_config=DRAFT_ARCH, **kw)
    mine = {}
    with no_reference(api):
        with draft_launches(common, lm, dcfg, mine), slab_log() as seen:
            common.reset_launch_counts()
            run = serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
            counts = common.launch_counts()
            router_paths = common.path_counts().get("tree_router", {})
        plain, _ = ContinuousBatchingEngine(params, cfg, EngineConfig(**kw)).run(reqs)
        selfspec, _ = ContinuousBatchingEngine(params, cfg, EngineConfig(
            spec_k=SPEC_K, draft_config="self:1", **kw)).run(reqs)
    m, L = run.metrics, cfg.n_layers
    rounds, slabs = m.n_steps, m.n_prefills
    mine = {k: mine.get(k, 0) for k in counts}
    if len(seen) != slabs:
        raise AssertionError(f"{label}: {len(seen)} slabs logged, {slabs} counted")
    # the draft: one site, its slabs grouped (up and down, a pass each; two
    # passes past a leaf's capacity), its steps fused
    want_mine = dict({k: 0 for k in counts}, tree_router=slabs,
                     grouped_matmul=2 * sum(slab_passes(dcfg, n) for _, n, _, _ in seen),
                     fused_forest_decode=(SPEC_K + 1) * rounds)
    if mine != want_mine:
        raise AssertionError(f"{label}: the draft's launch counts {mine} != "
                             f"expected {want_mine}")
    passes = sum(slab_passes(cfg, n) for _, n, _, _ in seen)
    want = {"gathered_matmul": L * rounds, "gathered_matmul_dual": L * rounds,
            "fused_forest_decode": mine["fused_forest_decode"],
            "grouped_matmul": L * passes + mine["grouped_matmul"],
            "grouped_matmul_dual": L * passes,
            "tree_router": L * rounds + L * slabs + mine["tree_router"]}
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != expected {want}")
    if router_paths != {"cluster": counts["tree_router"]}:   # the draft's D 6144, fp32
        raise AssertionError(f"{label}: tree_router launches by path {router_paths}, "
                             f"expected all {counts['tree_router']} on the cluster form")
    got, ref, own = by_rid(run.results), by_rid(plain), by_rid(selfspec)
    diff = [rid for rid in ref if not np.array_equal(got[rid], ref[rid])]
    own_diff = [rid for rid in ref if not np.array_equal(own[rid], ref[rid])]
    vs_own = [rid for rid in ref if not np.array_equal(got[rid], own[rid])]
    if vs_own:      # greedy tokens are the verify's argmaxes, whatever the draft
        raise AssertionError(f"{label}: requests {vs_own} differ from the self:1 "
                             f"draft's greedy tokens")
    log_rows(rows, f"{label} kernel", mine)
    log(f"{label} engine: {SLOTS} slots, spec_k {SPEC_K}, {len(reqs)} requests: "
        f"TTFT p50 {m.ttft.p50_ms:.2f} ms; per-token p50 {m.per_token.p50_ms:.2f} ms; "
        f"{m.throughput_tok_s:.1f} tok/s; {rounds} spec rounds (p50 "
        f"{m.decode_step.p50_ms:.2f} ms), {slabs} admission slabs; acceptance "
        f"{m.spec_acceptance:.3f} ({m.accepted_tokens}/{m.draft_tokens}; random "
        f"weights); launches {counts} (as expected; the draft's, measured around "
        f"its calls: {mine}; the router's all on the cluster form); {cfg.param_dtype} "
        f"tokens: "
        f"{len(diff)} of {len(reqs)} requests differ from the no-spec engine's"
        + "".join(f"; rid {rid} from token {first_diff(got[rid], ref[rid])}"
                  for rid in diff))
    log(f"{label} witness, {cfg.param_dtype}: spec_k {SPEC_K} with the self:1 draft "
        f"(the same verify path) differs from the no-spec engine in {len(own_diff)} "
        f"of {len(reqs)} requests"
        + "".join(f"; rid {rid} from token {first_diff(own[rid], ref[rid])}"
                  for rid in own_diff)
        + f"; the {DRAFT_ARCH} draft's tokens equal the self:1 draft's in all "
        f"{len(reqs)}")
    draft_parity(api, fff, lm, serve_mod, cfg)
    return {k: dict(v, launches=mine.get(kernel_of(k), 0)) for k, v in rows.items()}


@contextlib.contextmanager
def draft_launches(common, lm, dcfg, into: dict):
    """Adds to ``into`` each kernel's launches made inside ``lm.decode_step``
    and ``lm.prefill_chunk`` on the config ``dcfg`` (the draft's), read off
    the counts around every such call.  A call made while a dispatch graph
    is captured executes nothing: its launches are the graph's, added again
    at each of that graph's replays."""
    from repro_torch.serving import graphs
    saved = {n: getattr(lm, n) for n in ("decode_step", "prefill_chunk")}
    rec = graphs.CudaGraphRecorder
    capture, replay = rec.capture, rec.replay
    capturing, shares = [], {}       # the recorder capturing; its draft share

    def wrap(fn):
        def call(*a, **kw):
            if (a[1] if len(a) > 1 else kw.get("cfg")) != dcfg:
                return fn(*a, **kw)
            before = common.launch_counts()
            out = fn(*a, **kw)
            dst = shares[id(capturing[-1])] if capturing else into
            for k, n in common.launch_counts().items():
                dst[k] = dst.get(k, 0) + n - before[k]
            return out
        return call

    def capturing_share(self, run, stream):
        capturing.append(self)
        shares[id(self)] = {}
        try:
            return capture(self, run, stream)
        finally:
            capturing.pop()

    def replaying_share(self):
        replay(self)
        for k, n in shares.get(id(self), {}).items():
            into[k] = into.get(k, 0) + n

    for n, fn in saved.items():
        setattr(lm, n, wrap(fn))
    rec.capture, rec.replay = capturing_share, replaying_share
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(lm, n, fn)
        rec.capture, rec.replay = capture, replay


def draft_parity(api, fff, lm, serve_mod, base_cfg) -> None:
    """fp32 at PARITY_LAYERS layers: the engine with the registry draft, and
    without speculation, give lm.generate's greedy tokens off near-ties."""
    from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
    cfg = dataclasses.replace(base_cfg, n_layers=PARITY_LAYERS,
                              param_dtype=torch.float32, accum_dtype=torch.float32)
    params = lm.init(cfg, seed=1, device="cuda")
    reqs = engine_requests(serve_mod, cfg)
    want, margin = generate_with_margins(api, fff, lm, cfg, params, reqs, ENGINE_GEN,
                                         ENGINE_PROMPT + ENGINE_GEN + 1)
    kw = dict(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
              max_prompt_len=ENGINE_PROMPT, device="cuda")
    ties = {}
    for tag, extra in (("spec", dict(spec_k=SPEC_K, draft_config=DRAFT_ARCH)),
                       ("no spec", {})):
        res, m = ContinuousBatchingEngine(params, cfg, EngineConfig(**kw, **extra)).run(reqs)
        ties[tag] = near_tie_check(f"[draft parity] {tag}", by_rid(res), want, margin)
    log(f"[draft parity] {cfg.n_layers} layers fp32, {len(reqs)} requests x {ENGINE_GEN} "
        f"greedy tokens: spec_k {SPEC_K} with the {DRAFT_ARCH} draft and the engine "
        f"without speculation equal lm.generate (near-tie differences {ties}); "
        f"smallest deciding margin {min(margin.values()):.3e}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# model_parallel and train_mesh: ranks over gloo on the one card
# ---------------------------------------------------------------------------

def quiet_stdout():
    """A rank's prints (the serve and train drivers report) go nowhere: the
    phase prints what the ranks return."""
    import io
    return contextlib.redirect_stdout(io.StringIO())


def gloo_on_cuda(rank: int) -> dict:
    """Which collectives this torch's gloo takes on CUDA tensors, and a 64
    MB all_gather through gloo's own copies against the pinned host
    staging of ``distributed/collectives``."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    x = torch.full((1024,), float(rank + 1), device="cuda")
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
    }
    took = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            took[name] = True
        except (RuntimeError, ValueError) as e:
            took[name] = f"{type(e).__name__}: {str(e)[:120]}"
    big = torch.randn(MP_PROBE_BYTES // 4, device="cuda")
    parts = [torch.empty_like(big) for _ in range(2)]

    def wall(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    ms = {"gloo's copies": wall(lambda: dist.all_gather(parts, big))
          if took["all_gather"] is True else None,
          "pinned staging": wall(lambda: collectives.all_gather_cat(big, dist.group.WORLD))}
    return {"took": took, "all_gather_ms": ms}


def mp_ecfg(**kw):
    from repro_torch.serving.engine import EngineConfig
    return EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + MP_GEN + 1,
                        max_prompt_len=ENGINE_PROMPT, scheduler="fcfs", seed=0,
                        device="cuda", **kw)


def mp_requests(serve_mod, cfg):
    return serve_mod.build_requests(cfg.vocab_size, MP_REQS, ENGINE_PROMPT, MP_GEN,
                                    seed=0, min_prompt_len=ENGINE_MIN_PROMPT)


def leaf_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for layer in params["stack"]
               for k, t in layer["ffn"].items() if k.startswith("leaf_"))


def mp_serve_rank(rank: int, world: int) -> dict:
    """One rank of the model_parallel phase (module docstring, phase 23):
    the 8-layer bf16 model's share and the two serving runs under the
    layout, each run's launch counts, calls of the grouped leaf MLP,
    backends and bytes staged; then the 2-layer float32 loop."""
    from repro_torch.configs.internlm2_20b import FFF_CONFIG
    from repro_torch.core import api, routing
    from repro_torch.distributed import collectives
    from repro_torch.kernels import common
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm
    torch.cuda.set_device(0)
    out = {"gloo": gloo_on_cuda(rank)}
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    with quiet_stdout():
        _, ctx, local = serve_mod.setup_model_parallel(
            cfg, world, params=lm.init(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["setup_s"] = time.perf_counter() - t0
    out["leaf_bytes"] = leaf_bytes(local)
    out["held"] = [layer["ffn"]["leaf_wg"].shape[1] for layer in local["stack"]]
    calls = [0]
    inner = routing._leaf_mlp_on_buffers
    routing._leaf_mlp_on_buffers = lambda *a, **kw: (
        calls.__setitem__(0, calls[0] + 1), inner(*a, **kw))[1]
    torch.cuda.reset_peak_memory_stats()
    out["resident"] = torch.cuda.memory_allocated()

    def measured(name, run):
        common.reset_launch_counts()
        collectives.reset_staged()
        calls[0] = 0
        t = time.perf_counter()
        with backends_ran(api) as ran:
            res = run()
        torch.cuda.synchronize()
        out[name] = {"counts": common.launch_counts(), "calls": calls[0],
                     "backends": sorted({n for _, n in ran}),
                     "staged": collectives.staged_bytes(),
                     "wall_s": time.perf_counter() - t}
        return res

    with ctx(), quiet_stdout():
        res = measured("loop", lambda: serve_mod.serve(
            cfg, batch=PREFILL_B, prompt_len=PREFILL_S, gen=GEN, device="cuda",
            params=local))
        out["loop"].update(tokens=res.tokens.cpu().numpy(), p50=res.steady.p50_ms,
                           prefill_ms=res.prefill_s * 1e3)
        run = measured("engine", lambda: serve_mod.serve_engine(
            cfg, mp_ecfg(), mp_requests(serve_mod, cfg), params=local))
        out["engine"].update(tokens=by_rid(run.results), tok_s=run.metrics.throughput_tok_s,
                             steps=run.metrics.n_steps, shapes=run.shapes)
    out["peak"] = torch.cuda.max_memory_allocated()
    del local
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(FFF_CONFIG, n_layers=PARITY_LAYERS,
                                param_dtype=torch.float32, accum_dtype=torch.float32)
    with quiet_stdout():
        _, ctx32, local32 = serve_mod.setup_model_parallel(
            cfg32, world, params=lm.init(cfg32, seed=0, device="cuda"))
        with ctx32():
            out["fp32"] = serve_mod.serve(cfg32, batch=PARITY_B, prompt_len=PARITY_S,
                                          gen=PARITY_STEPS, device="cuda",
                                          params=local32).tokens.cpu().numpy()
    routing._leaf_mlp_on_buffers = inner
    return out


def ep_buffer(fff, api, params, cfg, M, m, B, seed=11):
    """Rank ``m``'s (E/M, M*C, D) buffer of a B-token slab's tokens under a
    model group of M (what it receives from every source rank), routed
    through layer 0's tree as grouped_ep routes, and its leaves."""
    from repro_torch.distributed import dispatch
    from repro_torch.core import routing
    from repro_torch.nn import mlp
    p = params["stack"][0]["ffn"]
    fc = mlp.make_fff_config(cfg.period[0].ffn, cfg.d_model,
                             param_dtype=cfg.param_dtype, accum_dtype=cfg.accum_dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, cfg.d_model, generator=gen, device="cuda").to(cfg.param_dtype)
    idx = fff.route_hard(p, fc, x)[:, 0]
    E, Bl = fc.num_leaves, B // M
    C = dispatch.ep_capacity(Bl, E, api.DEFAULT_CAPACITY_EP)
    recv = []
    for s in range(M):
        i = idx[s * Bl:(s + 1) * Bl].long()
        plan = dispatch.make_ep_plan(i, routing.group_slots(i, E + 1), i < E, E, M, C)
        recv.append(dispatch.ep_scatter(x[s * Bl:(s + 1) * Bl], plan)[m])
    xg = torch.stack(recv).transpose(0, 1).reshape(E // M, M * C, cfg.d_model).contiguous()
    El = E // M
    leaves = [p[k][0, m * El:(m + 1) * El] for k in ("leaf_wg", "leaf_wu", "leaf_wd")]
    return xg, leaves, C


def phase_model_parallel(common, api, fff, lm, serve_mod, cfg, params) -> dict:
    """serve --model-parallel 2 on the one card (module docstring, phase
    23).  Returns the grouped kernels' rows at a rank's shapes with rank
    0's engine-run launches."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.configs.internlm2_20b import FFF_CONFIG
    M = MP_RANKS
    # one process: the same model and requests on grouped_ep (local grouped
    # dispatch and the same exact repair)
    one = {"leaf_bytes": leaf_bytes(params)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one["resident"] = torch.cuda.memory_allocated()
    with quiet_stdout(), grouped_ep_alone(api), backends_ran(api) as ran:
        res = serve_mod.serve(cfg, batch=PREFILL_B, prompt_len=PREFILL_S, gen=GEN,
                              device="cuda", params=params)
        run = serve_mod.serve_engine(cfg, mp_ecfg(), mp_requests(serve_mod, cfg),
                                     params=params)
        one.update(loop=res.tokens.cpu().numpy(), p50=res.steady.p50_ms,
                   engine=by_rid(run.results), tok_s=run.metrics.throughput_tok_s,
                   peak=torch.cuda.max_memory_allocated())
        cfg32 = dataclasses.replace(FFF_CONFIG, n_layers=PARITY_LAYERS,
                                    param_dtype=torch.float32, accum_dtype=torch.float32)
        p32 = lm.init(cfg32, seed=0, device="cuda")
        one["fp32"] = serve_mod.serve(cfg32, batch=PARITY_B, prompt_len=PARITY_S,
                                      gen=PARITY_STEPS, device="cuda",
                                      params=p32).tokens.cpu().numpy()
    if {n for _, n in ran} != {"grouped_ep"}:
        raise AssertionError(f"[model_parallel] one process ran backends {set(ran)}")
    del p32
    free_device()

    t0 = time.perf_counter()
    ranks = mesh_lib.spawn_ranks(mp_serve_rank, M, timeout_s=MP_LIMIT_S)
    wall = time.perf_counter() - t0
    g = ranks[0]["gloo"]
    log(f"[model_parallel] gloo (torch {torch.__version__}) on CUDA tensors: "
        + ", ".join(f"{k} {'takes them' if v is True else v}" for k, v in g["took"].items())
        + f"; all_gather of {MP_PROBE_BYTES / 2 ** 20:.0f} MB a rank, 2 ranks: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in g["all_gather_ms"].items() if v is not None)
        + " (host clock; the port stages through pinned memory)")
    E = 2 ** cfg.period[0].ffn.fff_depth
    n = cfg.n_layers
    for r, rk in enumerate(ranks):
        if rk["held"] != [E // M] * n or rk["leaf_bytes"] * M != one["leaf_bytes"]:
            raise AssertionError(f"[model_parallel] rank {r} holds {rk['held']} leaves a "
                                 f"layer, {rk['leaf_bytes']} leaf bytes (one process "
                                 f"{one['leaf_bytes']})")
        for name in ("loop", "engine"):
            c = rk[name]
            k = c["calls"]
            want = {"grouped_matmul": k, "grouped_matmul_dual": k, "tree_router": 0,
                    "gathered_matmul": 0, "gathered_matmul_dual": 0,
                    "fused_forest_decode": 0}
            least = n * (1 + GEN) if name == "loop" else n * c.get("steps", 1)
            if c["counts"] != want or k < least or c["backends"] != ["grouped_ep"]:
                raise AssertionError(f"[model_parallel] rank {r} {name}: launches "
                                     f"{c['counts']} for {k} grouped leaf MLP calls "
                                     f"(at least {least}), backends {c['backends']}")
    a, b = ranks
    if not (np.array_equal(a["loop"]["tokens"], b["loop"]["tokens"])
            and all(np.array_equal(a["engine"]["tokens"][i], b["engine"]["tokens"][i])
                    for i in a["engine"]["tokens"])
            and np.array_equal(a["fp32"], b["fp32"])):
        raise AssertionError("[model_parallel] the two ranks' tokens differ")
    d32 = int((a["fp32"] != one["fp32"]).sum())
    if d32:
        raise AssertionError(f"[model_parallel] fp32, {PARITY_LAYERS} layers: {d32} greedy "
                             f"tokens differ from one process's grouped_ep run")
    loop_rows = int((a["loop"]["tokens"] != one["loop"]).any(1).sum())
    eng_diff = sum(not np.array_equal(a["engine"]["tokens"][i], one["engine"][i])
                   for i in one["engine"])
    gib = lambda x: x / 2 ** 30
    log(f"[model_parallel] {cfg.arch_id} FFF full width, {n} layers {cfg.param_dtype}, "
        f"--model-parallel {M}: {M} ranks on cuda:0 over gloo, layout (1, {M}); "
        f"spawn to results {wall:.1f}s (rank setup {a['setup_s']:.1f}s); each rank "
        f"holds {E // M} of each tree's {E} leaves: {gib(a['leaf_bytes']):.3f} GiB of "
        f"leaves a rank against {gib(one['leaf_bytes']):.3f} GiB in one process")
    for name, what in (("loop", f"loop batch {PREFILL_B} x prompt {PREFILL_S}, {GEN} "
                                 f"greedy steps"),
                       ("engine", f"engine {SLOTS} slots, {MP_REQS} requests of "
                                  f"{ENGINE_MIN_PROMPT}-{ENGINE_PROMPT} prompt tokens, "
                                  f"{MP_GEN} new, fcfs, monolithic")):
        log(f"[model_parallel] {what}: launches per rank "
            + " | ".join(str(rk[name]["counts"]) for rk in ranks)
            + f" ({[rk[name]['calls'] for rk in ranks]} grouped leaf MLP calls; only "
            f"grouped_ep ran); staged through pinned host memory per rank "
            + ", ".join(f"{rk[name]['staged'] / 1e9:.3f} GB" for rk in ranks)
            + f"; wall {a[name]['wall_s']:.1f}s")
    log(f"[model_parallel] decode p50 (loop, host clock) {a['loop']['p50']:.2f} ms "
        f"(one process {one['p50']:.2f} ms); engine {a['engine']['tok_s']:.1f} tok/s "
        f"(one process {one['tok_s']:.1f}); peak device memory a rank "
        + ", ".join(f"{gib(rk['peak']):.2f} GiB (resident {gib(rk['resident']):.2f})"
                    for rk in ranks)
        + f", one process {gib(one['peak']):.2f} GiB (resident {gib(one['resident']):.2f}; "
        f"it also holds the earlier phases' state)")
    log(f"[model_parallel] both ranks' tokens equal; bf16 against one process: "
        f"{loop_rows} of {PREFILL_B} loop rows and {eng_diff} of {len(one['engine'])} "
        f"engine requests differ; fp32 at {PARITY_LAYERS} layers: 0 of "
        f"{a['fp32'].size} greedy tokens differ")
    # the grouped kernels at a rank's shapes: the prefill slab's and a
    # decode step's buffers of rank 0, layer 0
    rows = {}
    with torch.inference_mode():
        for tag, B in (("", PREFILL_B * PREFILL_S), ("@decode", DECODE_B)):
            xg, leaves, C = ep_buffer(fff, api, params, cfg, M, 0, B)
            gs = torch.full((E // M,), M * C, dtype=torch.int32, device="cuda")
            _, r = grouped_rows(f"[model_parallel] rank 0{tag} (E/M {E // M}, M*C "
                                f"{M * C})", xg, leaves[:2], leaves[2], gs, "swiglu",
                                cfg.param_dtype)
            # the engine run's calls: one a layer per decode step, the rest
            # one a layer per admission slab
            decode = n * a["engine"]["steps"]
            for k, v in r.items():
                rows[k + tag] = dict(v, capacity=C, launches=(
                    decode if tag else a["engine"]["counts"][k] - decode))
    log_rows(rows, tag="[model_parallel kernels]")
    return rows


def mesh_witness(cfg) -> float:
    """The capacity factor at which no token of the straight-through FFF
    can overflow: a leaf's capacity is then the whole batch."""
    return float(2 ** cfg.period[0].ffn.fff_depth)


def mesh_train(train_mod, api, cfg, capacity=None, **kw):
    """``train_mesh``'s run: (the train result, the step-0 gradient's
    global norm, as the optimizer sees it: averaged over the data ranks)."""
    from repro_torch import utils
    norm0 = []

    def inspect(i, grads, metrics):
        if i == 0:
            norm0.append(float(utils.tree_global_norm(grads)))

    with (api.overrides(capacity_factor=capacity) if capacity
          else contextlib.nullcontext()):
        r = train_mod.train(cfg, steps=MESH_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                            device="cuda", log=lambda *a: None, inspect=inspect,
                            **kw)
    return r, norm0[0]


def mp_train_rank(rank: int, world: int) -> dict:
    """One rank of the train_mesh phase (module docstring, phase 24)."""
    from repro_torch.cluster.worker import weights_checksum
    from repro_torch.configs.olmoe_1b_7b import FFF_CONFIG
    from repro_torch.core import api
    from repro_torch.distributed import collectives, compression
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_mod
    torch.cuda.set_device(0)
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=MESH_LAYERS)
    layout = mesh_lib.make_host_mesh()
    collectives.reset_staged()
    torch.cuda.reset_peak_memory_stats()
    out = {"layout": layout.shape}
    for name, cf in (("default", None), ("no overflow", mesh_witness(cfg))):
        r, norm0 = mesh_train(train_mod, api, cfg, cf, layout=layout)
        out[name] = {"losses": r.losses, "step_ms": r.step_ms, "norm0": norm0,
                     "checksum": weights_checksum(r.placements.gather(r.params))}
        if name == "default":
            out.update(staged=collectives.staged_bytes(),
                       peak=torch.cuda.max_memory_allocated())
        del r
        torch.cuda.empty_cache()
    group = layout.groups()["data"]
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    x = torch.randn(MP_PROBE_BYTES // 4, generator=gen, device="cuda")
    t0 = time.perf_counter()
    y = compression.compressed_psum(x, group)
    torch.cuda.synchronize()
    out["psum_ms"] = (time.perf_counter() - t0) * 1e3
    exact = collectives.all_reduce(x, group)
    out["psum_rel"] = float((y - exact).abs().max() / exact.abs().max())
    out["psum_shape"] = tuple(y.shape)
    return out


def phase_train_mesh(common, api, lm) -> None:
    """train --mesh host on 2 ranks of the one card (module docstring,
    phase 24)."""
    from repro_torch.configs.olmoe_1b_7b import FFF_CONFIG
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_mod
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=MESH_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    one = {}
    for name, cf in (("default", None), ("no overflow", mesh_witness(cfg))):
        r, norm0 = mesh_train(train_mod, api, cfg, cf)
        one[name] = {"losses": r.losses, "step_ms": r.step_ms, "norm0": norm0}
        del r
        torch.cuda.empty_cache()
    one_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    common.reset_launch_counts()
    ranks = mesh_lib.spawn_ranks(mp_train_rank, MP_RANKS, timeout_s=MP_LIMIT_S)
    wall = time.perf_counter() - t0
    tol = TOL[cfg.param_dtype]
    gaps = {}
    for r, rk in enumerate(ranks):
        for name in one:
            got, want = rk[name]["losses"], one[name]["losses"]
            bad = [i for i, (a, b) in enumerate(zip(got, want))
                   if not (math.isfinite(a) and abs(a - b) <= tol + tol * abs(b))]
            if len(got) != MESH_STEPS or bad:
                raise AssertionError(f"[train_mesh] rank {r} ({name}): losses {got} "
                                     f"against one process's {want} (tolerance {tol})")
            gaps[name] = [abs(a - b) for a, b in zip(got, want)]
        # the data-parallel gradient the optimizer sees is the whole batch's:
        # a reduction skipped (a half batch's gradient) or not averaged (2x)
        # is far outside bf16 rounding of a norm at step 0, where no token
        # overflows and both runs hold the same parameters
        n0, n1 = rk["no overflow"]["norm0"], one["no overflow"]["norm0"]
        if not abs(n0 - n1) <= MESH_NORM_RTOL * n1:
            raise AssertionError(f"[train_mesh] rank {r}: step-0 gradient norm {n0} "
                                 f"against one process's {n1} (relative limit "
                                 f"{MESH_NORM_RTOL})")
        if rk["psum_rel"] >= 0.05 or rk["psum_shape"] != (MP_PROBE_BYTES // 4,):
            raise AssertionError(f"[train_mesh] rank {r}: compressed_psum relative error "
                                 f"{rk['psum_rel']:.4f} (limit 0.05)")
    a, b = ranks
    for name in one:
        if a[name]["losses"] != b[name]["losses"] or a[name]["checksum"] != b[name]["checksum"]:
            raise AssertionError(f"[train_mesh] ({name}) the ranks end with different "
                                 f"losses or parameters")
    log(f"[train_mesh] {cfg.arch_id} FFF full width, {cfg.n_layers} of 16 layers "
        f"{cfg.param_dtype}, --mesh host: {MP_RANKS} ranks on cuda:0 over gloo, layout "
        f"{a['layout']}, zero_stage {cfg.zero_stage} (parameters replicated, gradients "
        f"averaged), batch {TRAIN_B} x seq {TRAIN_S} split over the ranks, "
        f"{MESH_STEPS} steps; spawn to results {wall:.1f}s; both ranks end with "
        f"bit-equal parameters (weights_checksum)")
    for name in one:
        what = ("the straight-through FFF's default capacity (per data rank)"
                if name == "default" else
                f"capacity factor {mesh_witness(cfg):.0f} (a leaf holds the whole "
                f"batch: no token overflows)")
        log(f"[train_mesh] {what}: losses {a[name]['losses']} against one process's "
            f"{one[name]['losses']}, gaps {gaps[name]} (within {tol} + {tol}|loss|); "
            f"step-0 gradient norm {a[name]['norm0']} against {one[name]['norm0']}; "
            f"step ms (CUDA events) {a[name]['step_ms']} against "
            f"{one[name]['step_ms']}")
    log(f"[train_mesh] staged through pinned host memory a rank (default run) "
        f"{a['staged'] / 1e9:.3f} GB; peak device memory a rank "
        f"{a['peak'] / 2 ** 30:.2f} GiB, one process {one_peak / 2 ** 30:.2f} GiB")
    log(f"[train_mesh] compressed_psum of {MP_PROBE_BYTES / 2 ** 20:.0f} MB a rank (float32 "
        f"on the card, int8 payload summed as int32): relative error "
        + ", ".join(f"{rk['psum_rel']:.4f}" for rk in ranks)
        + f" against the exact sum (limit 0.05); {a['psum_ms']:.1f} ms (host clock)")


# ---------------------------------------------------------------------------
# the paper's ViT and the examples
# ---------------------------------------------------------------------------

def load_example(name: str):
    """``examples/<name>.py`` as a module (the folder is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def site_calls(api, name: str):
    """Yields a list that takes (x, leaf_idx, y, params, cfg) of every call
    of the inference backend ``name`` inside the context."""
    fn, pred = api.get_backend("infer", name), api._SUPPORTS.get(("infer", name))
    calls = []

    def recorded(p, c, x, spec):
        y, out = fn(p, c, x, spec)
        calls.append((x, out.leaf_idx, y, p, c))
        return y, out

    api.register_backend("infer", name, recorded, supports=pred)
    try:
        yield calls
    finally:
        api.register_backend("infer", name, fn, supports=pred)


def vit_eval_parity(api, ex, cfg, params, proj, x) -> tuple[int, int, float, float, list]:
    """The ViT's hard evaluation of ``x`` (B, S, dpatch) on the kernels
    (``auto``: ``cuda``) against the ``reference`` backend on the same card,
    in float32.  Site by site: the kernel backend on the reference run's
    input takes the reference's leaf on every token whose deciding node
    logits all exceed NEAR_TIE, and its output agrees on the tokens whose
    leaf agrees (kernel tolerance).  Whole images: an image any of whose
    tokens meets a near-tie at any site is set aside (attention carries a
    legitimately different leaf to its other tokens); every other image
    takes the reference's leaves at every site and its logits agree within
    the kernel tolerance.  Returns the near-tie tokens over all sites, the
    images set aside, the largest site and logit errors, and the kernel
    run's site calls."""
    from repro_torch.kernels.fused_decode import ops as fd_ops
    kernel_spec = api.ExecutionSpec(mode="infer", backend="cuda")
    B = x.shape[0]
    with torch.inference_mode():
        with site_calls(api, "cuda") as kc:
            got, _ = ex.vit_forward(params, cfg, proj, x, "eval")
        with api.overrides(backend="reference", mode="infer"), \
                site_calls(api, "reference") as rc:
            want, _ = ex.vit_forward(params, cfg, proj, x, "eval")
        if len(kc) != cfg.n_layers or len(rc) != cfg.n_layers:
            raise AssertionError(f"[vit] {len(kc)} kernel and {len(rc)} reference "
                                 f"site calls for {cfg.n_layers} layers")
        near_img = torch.zeros(B, dtype=torch.bool, device=x.device)
        ties, site_err = 0, 0.0
        for i, (xr, ir, y_ref, p, c) in enumerate(rc):
            nw, nb = fd_ops.collapse_nodes(p, c)
            _, margin = margins(xr.reshape(-1, xr.shape[-1]), nw[0], nb[0], c.depth)
            y, out = api.apply(p, c, xr, kernel_spec)
            agree, n, _ = compare_idx(f"[vit] layer {i} site", out.leaf_idx.reshape(-1),
                                      ir.reshape(-1), margin)
            ties += n
            site_err = max(site_err, compare(
                f"[vit] layer {i} site cuda vs reference", y.reshape(agree.numel(), -1),
                y_ref.reshape(agree.numel(), -1), torch.float32, rows=agree))
            near_img |= (margin < NEAR_TIE).reshape(B, -1).any(1)
        for i, (k, r) in enumerate(zip(kc, rc)):
            differ = (k[1].reshape(B, -1) != r[1].reshape(B, -1)).any(1) & ~near_img
            if bool(differ.any()):
                raise AssertionError(f"[vit] layer {i}: {int(differ.sum())} images "
                                     f"routed differently away from any near-tie")
    err = (compare("[vit] eval logits cuda vs reference", got, want, torch.float32,
                   rows=~near_img) if bool((~near_img).any()) else float("nan"))
    return ties, int(near_img.sum()), site_err, err, kc


def vit_capacity(B: int, E: int) -> int:
    """The grouped path's per-leaf capacity for B tokens over E leaves, as
    ``leaf_gemm.ops.fff_leaf_mlp`` sizes it at the cuda backend's default
    capacity factor."""
    from repro_torch.core import api
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    return gemm_ops.capacity(B, E, api.DEFAULT_CAPACITY_INFER)


def kept_share(leaf_idx, E: int) -> tuple[float, int]:
    """One site call's (share of its tokens that the capacity-bounded
    grouped buffers hold, leaves with a token); the other tokens take the
    overflow pass."""
    li = leaf_idx.reshape(-1).long()
    gs = torch.bincount(li, minlength=E)[:E]
    return float(gs.clamp(max=vit_capacity(li.numel(), E)).sum()) / li.numel(), int((gs > 0).sum())


def vit_site_rows(label, x, p, c) -> dict:
    """The router and both grouped_matmul calls at one ViT FFN site's
    shapes (float32), each twice and bit-identical, against the plain
    versions, capacity as the kernel path sizes it; each row records the
    share of the site's tokens the grouped buffers hold (``kept``)."""
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    x = x.reshape(-1, x.shape[-1]).contiguous()
    nw, nb = (t[0].contiguous() for t in fd_ops.collapse_nodes(p, c))
    rows = {"tree_router": router_row(f"{label} tree_router", x, nw, nb, c.depth)}
    leaf, _ = routed(f"{label} tree_router", x, nw, nb, c.depth)
    E = c.num_leaves
    C = vit_capacity(x.shape[0], E)
    lay = gemm_ops.scatter_to_groups(x, leaf, E, C)
    _, r = grouped_rows(label, lay.x_grouped, (p["leaf_w1"][0].contiguous(),),
                        p["leaf_w2"][0].contiguous(), lay.group_sizes, c.activation,
                        torch.float32)
    rows.update({k: dict(v, capacity=C) for k, v in r.items()})
    kept = float(lay.group_sizes.sum()) / x.shape[0]
    return {k: dict(v, kept=kept) for k, v in rows.items()}


def vit_balanced_site(api, label, leaf: int, B: int):
    """A site at the ViT eval's shapes whose routing spreads: B N(0, 1)
    tokens of width 128 through a fresh FFF(log2(128 / leaf), leaf), drawn
    as ``ffn_site_speedup`` draws its input and FFF (seeds 0 and 2).  Holds
    the cuda backend's output against the reference backend's (leaves
    exact off near-ties, outputs within 1e-4) and asserts at least
    VIT_KEPT_FLOOR of the tokens kept.  Returns (x, params, cfg, share
    kept, site max|err|)."""
    from repro_torch.core import fff as fff_lib
    from repro_torch.kernels.fused_decode import ops as fd_ops
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    x = torch.randn((B, 128), generator=gen(0), device="cuda")
    c = fff_lib.FFFConfig(dim_in=128, dim_out=128, depth=int(math.log2(128 // leaf)),
                          leaf_width=leaf, activation="gelu", leaf_bias=False)
    p = fff_lib.init(gen(2), c)
    with torch.inference_mode():
        y, out = api.apply(p, c, x, api.ExecutionSpec(mode="infer", backend="cuda"))
        y_ref, ref = api.apply(p, c, x, api.ExecutionSpec(mode="infer", backend="reference"))
        nw, nb = fd_ops.collapse_nodes(p, c)
        _, margin = margins(x, nw[0], nb[0], c.depth)
        agree, _, _ = compare_idx(f"{label} site", out.leaf_idx.reshape(-1),
                                  ref.leaf_idx.reshape(-1), margin)
        err = compare(f"{label} site cuda vs reference", y, y_ref, torch.float32,
                      rows=agree)
    kept, live = kept_share(out.leaf_idx, c.num_leaves)
    if kept < VIT_KEPT_FLOOR:
        raise AssertionError(f"{label} site: {kept:.4f} of {B} tokens kept ({live} "
                             f"leaves live), below {VIT_KEPT_FLOOR}")
    return x, p, c, kept, err


def host_copy(tree):
    """A copy of a tensor tree on the host."""
    from repro_torch import utils
    return utils.tree_map(lambda t: t.detach().cpu(), tree)


def phase_vit(common, api) -> dict:
    """The paper's Table-3 ViT (configs/paper_vit: d128, 4 layers, 64 patch
    tokens of 48 values, float32) whole, through examples/
    vit_cifar_fff_torch.py's pieces on synthetic CIFAR-like data: the dense
    baseline and FFF leaf widths VIT_LEAVES, each trained the example's
    default steps (AdamW, batch 128, FORWARD_T: no kernel may launch) and
    evaluated on the 1024 test images in batches of 256 (hard FORWARD_I:
    16384 tokens a site, router + grouped kernels; their launch counts set
    to 0 just before and read just after, > 0 asserted, every other kernel
    0; each site call's share of tokens that the grouped buffers hold
    printed, the rest taking the overflow pass).  For each FFF
    model: the first eval batch against the reference backend
    (``vit_eval_parity``), the router and grouped kernels at layer 0's
    site (rows "paper-vit lN" of the arch_kernels JSON with the eval
    launches and the share kept) and at a site of the same shapes whose
    routing spreads (``vit_balanced_site``, rows "paper-vit lN balanced"),
    the FFN-site speedup at batch 2048 on the reference backend (the JAX
    benchmark's) and on cuda; the first VIT_CPU_STEPS losses against a
    CPU run from the same weights and batches within E2E.  Prints G_A, the
    drop against dense and the widths.  Returns the rows."""
    from repro_torch.configs.paper_vit import vit_config
    from repro_torch.data import synthetic
    ex = load_example("vit_cifar_fff_torch")
    label, t0 = "[vit]", time.perf_counter()
    ds = synthetic.make("cifar10_like")
    xtr, xte = ex.vit_batchify(ds)
    log(f"{label} cifar10_like: {len(xtr)} train / {len(xte)} test images, "
        f"{xtr.shape[1]} patches of {xtr.shape[2]} values; {ex.DEFAULT_STEPS} "
        f"steps each ({time.perf_counter() - t0:.1f}s to make the data)")
    archs, base = {}, None
    for leaf in (0,) + VIT_LEAVES:
        cfg = vit_config("dense") if leaf == 0 else vit_config("fff", leaf_width=leaf)
        tag = "dense" if leaf == 0 else f"l{leaf}"
        params, proj = ex.make_vit(cfg, xtr.shape[-1], device="cuda")
        cpu_losses = []
        ex.vit_train(cfg, host_copy(params), proj.cpu(), xtr, ds.y_train, VIT_CPU_STEPS,
                     losses=cpu_losses)
        losses = []
        common.reset_launch_counts()
        t1 = time.perf_counter()
        params = ex.vit_train(cfg, params, proj, xtr, ds.y_train, ex.DEFAULT_STEPS,
                              losses=losses)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        if any(common.launch_counts().values()):
            raise AssertionError(f"{label} {tag} training launched {common.launch_counts()}")
        for i, (a, b) in enumerate(zip(losses, cpu_losses)):
            if not abs(a - b) <= E2E * (1 + abs(b)):
                raise AssertionError(f"{label} {tag} step {i} loss {a} on the card, "
                                     f"{b} on the CPU")
        with backends_ran(api) as ran, site_calls(api, "cuda") as ec:
            common.reset_launch_counts()
            t1 = time.perf_counter()
            ga = ex.vit_accuracy(cfg, params, proj, xte, ds.y_test)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t1
            counts = common.launch_counts()
            router_paths = common.path_counts().get("tree_router", {})
        fff_sites = {k for k in ran if k[0] == "infer"}
        shares = [kept_share(call[1], call[4].num_leaves) for call in ec]
        E = ec[0][4].num_leaves if ec else 0
        del ec
        if leaf == 0:
            if any(counts.values()) or fff_sites:
                raise AssertionError(f"{label} dense eval: {counts}, {fff_sites}")
            base = ga
            log(f"{label} dense: G_A {ga:.4f}, training width 128, inference width "
                f"128; losses {losses[0]:.4f} -> {losses[-1]:.4f}, first "
                f"{VIT_CPU_STEPS} within {E2E} of the CPU's; train {train_s:.1f}s, "
                f"eval {eval_s:.2f}s, no kernel launched")
            continue
        others = {k: v for k, v in counts.items()
                  if k not in ("tree_router", "grouped_matmul") and v}
        if (counts["tree_router"] <= 0 or counts["grouped_matmul"] <= 0 or others
                or fff_sites != {("infer", "cuda")}):
            raise AssertionError(f"{label} {tag} eval: launches {counts}, "
                                 f"backends {fff_sites}")
        if router_paths != {"resident": counts["tree_router"]}:   # float32, D 128
            raise AssertionError(f"{label} {tag} eval: tree_router launches by path "
                                 f"{router_paths}, expected all {counts['tree_router']} "
                                 f"on the resident form")
        x0 = torch.as_tensor(xte[:ex.EVAL_BATCH], device="cuda")
        ties, near, site_err, err, kc = vit_eval_parity(api, ex, cfg, params, proj, x0)
        x_site, _, _, p_site, c_site = kc[0]
        with torch.inference_mode():
            rows = vit_site_rows(f"{label} {tag}", x_site, p_site, c_site)
        del kc, x_site, p_site
        xb, pb, cb, kept_b, err_b = vit_balanced_site(api, f"{label} {tag} balanced", leaf,
                                                      x0.shape[0] * x0.shape[1])
        with torch.inference_mode():
            rows_b = vit_site_rows(f"{label} {tag} balanced", xb, pb, cb)
        del xb, pb
        per_layer = [[k for k, _ in shares[i::cfg.n_layers]] for i in range(cfg.n_layers)]
        spd_ref = ex.ffn_site_speedup(leaf, device="cuda")
        spd_cuda = ex.ffn_site_speedup(leaf, device="cuda", backend="cuda")
        depth = int(math.log2(128 // leaf))
        log(f"{label} {tag}: G_A {ga:.4f}, drop {(base - ga) / max(base, 1e-9) * 100:.2f}% "
            f"against dense; training width {2 ** depth * leaf} (size "
            f"{2 ** depth - 1 + 128}), inference width {leaf}; FFN-site speedup "
            f"at batch {ex.SITE_BATCH}: reference {spd_ref:.3f}x, cuda {spd_cuda:.3f}x; "
            f"eval launches tree_router {counts['tree_router']} (all on the resident "
            f"form), grouped_matmul "
            f"{counts['grouped_matmul']}; cuda vs reference on {ex.EVAL_BATCH} images: "
            f"sites max|err| {site_err:.3e} ({ties} of "
            f"{cfg.n_layers * x0.shape[0] * x0.shape[1]} site tokens take another leaf at a "
            f"near-tie), logits max|err| {err:.3e} "
            f"({near} images set aside at near-ties); losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, first {VIT_CPU_STEPS} within "
            f"{E2E} of the CPU's; train {train_s:.1f}s, eval {eval_s:.2f}s")
        log(f"{label} {tag} eval: share of each site's tokens in the grouped buffers "
            f"(capacity {vit_capacity(x0.shape[0] * x0.shape[1], E)} a leaf of {E}; "
            f"the rest take the overflow "
            f"pass), by layer over the {len(shares) // cfg.n_layers} batches: "
            + "; ".join(f"layer {i} " + ", ".join(f"{k:.4f}" for k in ks)
                        for i, ks in enumerate(per_layer))
            + f"; leaves live at most {max(n for _, n in shares)}")
        log(f"{label} {tag} balanced site ({x0.shape[0] * x0.shape[1]} N(0, 1) tokens, "
            f"a fresh FFF): {kept_b:.4f} kept (floor {VIT_KEPT_FLOOR}), cuda vs "
            f"reference max|err| {err_b:.3e}")
        log_rows(rows, f"{label} {tag} kernel", counts)
        log_rows(rows_b, f"{label} {tag} balanced kernel", counts)
        eval_kept = min(k for k, _ in shares)
        archs[f"paper-vit {tag}"] = {k: dict(v, launches=counts.get(kernel_of(k), 0),
                                             eval_kept_min=eval_kept)
                                     for k, v in rows.items()}
        archs[f"paper-vit {tag} balanced"] = {
            k: dict(v, launches=counts.get(kernel_of(k), 0)) for k, v in rows_b.items()}
        del params
        torch.cuda.empty_cache()
    log(f"{label} done in {time.perf_counter() - t0:.1f}s")
    return archs


def phase_examples(common) -> None:
    """The ported examples in this process on the card, each with its own
    assertions: serve_fff_kernels_torch (D 512, 16 SwiGLU leaves of 256:
    256 tokens through tree_router, grouped_matmul_dual and
    grouped_matmul, 8 through tree_router and the gathered kernels) and
    quickstart_torch (its 300 SGD steps; its leaves carry biases, which
    the kernel path refuses, so auto serves the 1024 test images on the
    reference backend), their launch counts asserted;
    train_lm_fff_torch --small EXAMPLE_LM_STEPS steps under the supervisor
    with checkpoints, run again to resume from its last checkpoint, the
    greedy sample through the gathered and fused decode kernels."""
    import tempfile
    label = "[examples]"
    sk = load_example("serve_fff_kernels_torch")
    common.reset_launch_counts()
    r = sk.main(["--device", "cuda"])
    torch.cuda.synchronize()
    counts = common.launch_counts()
    want = ("tree_router", "grouped_matmul_dual", "grouped_matmul",
            "gathered_matmul_dual", "gathered_matmul")
    if (any(counts[k] <= 0 for k in want) or counts["fused_forest_decode"]
            or not r["max_abs_err"] <= E2E or not r["decode_max_abs_err"] <= E2E):
        raise AssertionError(f"{label} serve_fff_kernels: {r}, launches {counts}")
    log(f"{label} serve_fff_kernels_torch: max|err| {r['max_abs_err']:.3e} (256 "
        f"tokens), {r['decode_max_abs_err']:.3e} (8), routing agreement "
        f"{r['routing_agreement']:.4f}; launches {counts}")
    qs = load_example("quickstart_torch")
    common.reset_launch_counts()
    q = qs.main(["--device", "cuda"])
    torch.cuda.synchronize()
    counts = common.launch_counts()
    # its leaves carry biases, which the kernel path refuses: auto serves
    # them on the reference backend, and no kernel may launch
    on_kernels = q["backend"] == "cuda"
    if (on_kernels != (counts["tree_router"] > 0 and counts["grouped_matmul"] > 0)
            or (not on_kernels and any(counts.values()))
            or not q["max_abs_err"] <= E2E or not q["routing_agreement"] > 0.99):
        raise AssertionError(f"{label} quickstart: {q}, launches {counts}")
    log(f"{label} quickstart_torch: accuracy {q['accuracy']:.4f}, auto -> "
        f"{q['backend']}, max|err| {q['max_abs_err']:.3e}, routing agreement "
        f"{q['routing_agreement']:.4f}; launches {counts}")
    tl = load_example("train_lm_fff_torch")
    root = tempfile.mkdtemp(prefix="lm_example_")
    try:
        argv = ["--small", "--steps", str(EXAMPLE_LM_STEPS), "--device", "cuda",
                "--ckpt-dir", root, "--ckpt-every", str(EXAMPLE_LM_CKPT_EVERY)]
        common.reset_launch_counts()
        t0 = time.perf_counter()
        res = tl.main(argv)
        torch.cuda.synchronize()
        took, counts = time.perf_counter() - t0, common.launch_counts()
        again = tl.main(argv)
        if (res.step != EXAMPLE_LM_STEPS or res.restarts or again.step != EXAMPLE_LM_STEPS
                or counts["gathered_matmul"] <= 0 or counts["fused_forest_decode"] <= 0):
            raise AssertionError(f"{label} train_lm_fff: steps {res.step}, {again.step}, "
                                 f"launches {counts}")
        log(f"{label} train_lm_fff_torch --small: {res.step} steps and the sample in "
            f"{took:.1f}s; the second run resumed at step {again.step}; launches {counts}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def timed(name: str):
    """Logs the seconds the phase inside took, then frees what the phase
    left unreachable (``free_device``)."""
    t0 = time.perf_counter()
    yield
    log(f"[time] {name}: {time.perf_counter() - t0:.1f}s")
    free_device()


def free_device() -> None:
    """Collects garbage, then empties the allocator's cache.  An engine is
    in a reference cycle with its graph cache (each entry's dispatch is
    one of the engine's methods), so its KV pools, its graphs' memory pools
    and a draft's weights go back to the card only when the cycle
    collector runs, which a phase's allocations alone may not trigger."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    device_name, smi = phase_device()
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.internlm2_20b import CONFIG, FFF_CONFIG
    from repro_torch.core import api, fff
    from repro_torch.kernels import common
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    with timed("build"):
        phase_build(common)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        with timed("kernels"):
            rows = phase_kernels(gen)
            rows.update(phase_gathered(gen))
        with timed("ragged"):
            phase_ragged(gen)
        with timed("router"):
            phase_router(gen)
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] {cfg.arch_id} FFF full width, {cfg.n_layers} of 48 layers, "
        f"{lm.param_count(params) / 1e9:.2f}B params {cfg.param_dtype}, "
        f"init {time.perf_counter() - t0:.1f}s")
    with timed("serve and profile"):
        phase_serve(common, api, serve_mod, cfg, params)
        phase_profile(cfg, params, lm)
    with timed("engine"):
        counts = phase_engine(common, api, serve_mod, cfg, params)
    with timed("paged"):
        phase_paged(common, api, serve_mod, cfg, params)
    with timed("cluster"):
        phase_cluster(common, api, fff, lm, serve_mod, cfg, params)
    with timed("cluster_proc"):
        phase_cluster_proc(serve_mod, lm, FFF_CONFIG)
    with timed("draft"):
        draft_rows = phase_draft(common, api, fff, lm, serve_mod, cfg, params)
    with timed("model_parallel"):
        mp_rows = phase_model_parallel(common, api, fff, lm, serve_mod, cfg, params)
    with timed("parity"):
        phase_parity(api, fff, lm, FFF_CONFIG)
        phase_engine_parity(api, fff, lm, serve_mod, FFF_CONFIG)
    with timed("grouped"):
        with torch.inference_mode():
            grouped_capacities(rows)
        phase_grouped_serving(common, api, serve_mod, cfg, params)
        del params
        torch.cuda.empty_cache()
        f32_launches = phase_grouped_parity(api, fff, lm, serve_mod, FFF_CONFIG)
    with timed("train"):
        phase_train(common, api, fff, lm, FFF_CONFIG)
    with timed("train_mesh"):
        phase_train_mesh(common, api, lm)
    with timed("ckpt"):
        phase_ckpt(common, lm, serve_mod, FFF_CONFIG)
    with timed("dense"):
        phase_dense(common, api, lm, serve_mod, FFF_CONFIG, CONFIG)
    with timed("archs"):
        archs = phase_archs(common, api, fff, lm, serve_mod)
    with timed("moe"):
        archs["olmoe-1b-7b native"] = phase_moe(common, api, lm, serve_mod,
                                                archs.pop("olmoe ffn"))
    with timed("long"):
        phase_long(common, api, lm)
    with timed("kimi"):
        archs["kimi-k2-1t-a32b"] = phase_kimi(common, api, fff, lm, serve_mod)
    with timed("jamba"):
        archs["jamba-1.5-large-398b"] = phase_jamba(common, api, fff, lm, serve_mod)
    with timed("xlstm"):
        phase_xlstm(common, api, lm, serve_mod)
    with timed("mixers"):
        phase_mixers()
    with timed("whisper"):
        archs["whisper-small"] = phase_whisper(common, api, fff, lm, serve_mod)
    with timed("internvl"):
        phase_internvl(common, api, fff, lm, serve_mod)
    with timed("vit"):
        archs.update(phase_vit(common, api))
    with timed("examples"):
        phase_examples(common)
    archs[f"{DRAFT_ARCH} draft"] = draft_rows
    archs[f"{cfg.arch_id} model_parallel rank 0"] = mp_rows
    log(f"[time] all phases: {time.perf_counter() - t_start:.1f}s")

    # bf16 rows: the engine's launches; the grouped GEMMs' float32 rows
    # beside them: the float32 grouped parity runs' launches; the router's
    # float32 resident form: the ViT's l1 site (depth 7), the evals' launches
    table = []
    vit_router = sum(archs[f"paper-vit l{leaf}"]["tree_router"]["launches"]
                     for leaf in VIT_LEAVES)
    for row_name, kname, dtype, launches, r in (
            [(kname, kname, torch.bfloat16, counts[kname], rows[(kname, torch.bfloat16)])
             for kname in common.KERNELS]
            + [(f"{kname} (float32)", kname, torch.float32, f32_launches[kname],
                rows[(kname, torch.float32)])
               for kname in ("grouped_matmul_dual", "grouped_matmul")]
            + [("tree_router (float32, resident)", "tree_router", torch.float32, vit_router,
                archs["paper-vit l1 balanced"]["tree_router"])]):
        k = common.KERNELS[kname]
        table.append({"name": row_name,
                      "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{k.source}",
                      "replaces": k.replaces, "launches": launches,
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                      "dtype": str(dtype)[6:]})
    print(json.dumps({"arch_kernels": {
        arch: [dict(name=k, **{f: r[f] for f in ARCH_ROW_KEYS if f in r})
               for k, r in rows.items()] for arch, rows in archs.items()}}))
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
