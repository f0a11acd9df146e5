#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero, printing no result, without one
or without the rest of the repository beside it. Phases (any failure is
fatal):

1. Card: name and power limit from nvidia-smi.
2. Build: compiles the four kernels from production_stack_tpu_torch/csrc,
   one nvcc per source, all at once.
3. Kernels: K1 kv_write, K2 ragged_paged_attention, K3
   paged_decode_attention and K4 paged_prefill_attention, each against its
   plain PyTorch version on the card at the llama-3-8b serving shapes and
   at a tiny-llama geometry (float32, D = 32, atol = rtol = 1e-5), with
   every unwritten pool slot holding NaN; K2, K3 and K4 also at head dims
   96 and 256 (G = 2, soft cap 50, bf16 and float32). bf16 K1 is bit for
   bit. bf16 K2, K3 and K4 run on the tensor cores: they agree within one
   bf16 rounding step of each output (rtol 2^-7, atol 1e-5) plus 2^-8 of
   plain(|V|), the plain version's output with V replaced by |V|, since
   they round P to bf16 before P V (``P_ROUNDING``). Times each kernel and
   each library call as the device's time alone (after warm-up, one pair
   of CUDA events around the replay of a CUDA graph of many back-to-back
   launches, over the count; K1 also issued from Python and per call,
   wrapper included) beside its plain version and one PyTorch call that
   computes the same function (K1: ``index_copy_``; K2, K3, K4:
   ``scaled_dot_product_attention`` on the context gathered beforehand,
   the gather not timed; for K2 and K3 also
   ``torch.nn.attention.varlen.varlen_attn`` on the same gathered
   contexts, where the card's PyTorch has it), and computes each kernel's
   bound from this run's inputs. K2 runs on the mixed stream and on a
   prefill-only stream of 4 fresh 512-token spans (beside K4 on the same
   work) and on a speculative verify stream (48 spans of 1 + 4 tokens and
   16 one-token spans over contexts 130-2048), K3 at B = 64 (contexts up to
   2k) and at B = 4, ctx 8192. Sweeps K2's row tile (rows a CTA x positions
   a stage) and the split span of its one-token spans, K3's split span,
   and K4's tile.
4. Slices, each through the port's HTTP server on the card serving
   llama-3-8b (random weights from a seed, bf16, default scheduler) to the
   same 16 requests; every response must be 200 with the asked-for token
   count. First the ragged path: K1, K2 and K3 must launch in it, K4 not;
   the engine is then traced (torch.profiler) over two full prefill steps
   and 16 decode steps at 64 rows (device busy time, idle share, device
   time by kernel class and per wrapper call) and released. Then the
   bucketed path (``--attention-impl bucketed``): K1, K3 and K4 must
   launch in it, K2 not; then two full bucketed prefill steps (4 chunks of
   512 tokens) are traced the same way.
5. Kernel path against plain path: tiny-llama (float32) greedy tokens from
   the engine on the card equal those of the engine on the CPU, on the
   ragged and on the bucketed path, up to any printed argmax near-tie (CPU
   top-2 logprob gap under 1e-4). Then bf16 tiny-llama served twice on the
   card in this process on each path: through the kernels (K2 and K3 on
   the ragged path, K4 on the bucketed path), and with this script putting
   their plain versions in the model runner's place of the wrappers for
   that run only; greedy tokens equal up to printed near-ties and
   logprobs within ``BF16_LOGPROB_BAND``. Then float32 tiny-llama on the
   ragged path with n-gram speculation, a LoRA adapter and grammars, card
   against CPU, greedy-equal up to printed near-ties; and bf16 tiny-llama
   with speculation on against off on the card, within the band. Then,
   card against CPU: float32 tiny-mixtral on the ragged and the bucketed
   path; float32 tiny-llama with ``quant="int8"`` on the ragged path at T
   = 512 (ragged steps W8A16, decode steps W8A8; both routes must run on
   the card; greedy flips accepted within ``INT8_TIE_GAP``); a tiny-llama
   HF checkpoint written here in numpy and served with ``--model <dir>``.
6. Request features: llama-3-8b at full width and ``CUT_LAYERS`` (8) of
   its 32 layers (the script's time) through the HTTP
   server on the ragged path with ``--speculative-ngram 4``: a random
   rank-16 adapter on all seven targets of its layers, written here in
   numpy, loaded with ``POST /v1/load_lora_adapter``; one wave of 18
   requests mixing base, the adapter, ``guided_regex``, ``guided_json`` and
   motif-loop prompts (every response 200, unguided ones with their token
   count, guided ones matching; K1, K2 and K3 launch; some drafts
   accepted). On that engine: the adapter's greedy tokens on a fixed prompt
   differ from base's; 16 motif requests with speculation off and on in
   turns (tok/s, acceptance, tokens a spec step); decode steps traced with
   base, adapter and guided rows. Then the bucketed path with the adapter
   and grammars (K1, K3 and K4 launch).
7. The surface the router and the fleet read: llama-3-8b (bf16, ragged)
   at full width and ``CUT_LAYERS`` (8) of its 32 layers, through the
   server's command-line defaults but a 6 s accountant window
   (``--perf-window 6``), so the launch warmup runs:
   ``/ready`` answers 503 ``warming``, then 200, and
   ``vllm:engine_warming`` goes 1 -> 0 (warmup seconds and compile events
   printed). A mixed wave of 16 requests (64-1024 tokens, greedy and
   sampled, logprobs, one guided, one prompt sent twice): then
   ``vllm:unexpected_recompiles`` reads 0, the ``/metrics`` token counters
   (parsed here) equal the wave's usage sums, and prefix-cache hits are
   > 0. ``/kv/lookup`` matches the repeated prompt's full blocks and none
   of a fresh one. A prefill window (16 x 1024 tokens, one out) and a
   64-row x 64-token decode window, each alone in the accountant's 6 s
   window: ``/debug/perf``'s MFU and HBM-bandwidth utilization in (0,
   1.05], beside the client's token rate and ``/metrics``' latency under
   load. ``/debug/profile`` during a wave returns a trace naming K2's and
   K3's kernels; ``/debug/canary`` one record per probe; ``POST /drain``
   with a 256-token stream in flight: ``/ready`` 503 ``draining``, a new
   completion 503 with ``Retry-After``, the stream ends whole. Then
   float32 tiny-llama's canary records, card against CPU, under
   ``canary_golden.compare`` at tolerance 1e-4.
8. MoE in int8 (``moe-int8``): mixtral-8x7b at full width and depth,
   bf16 activations with ``--quantization int8`` (46.7 GB of int8
   weights made from seed 0 on the card, quantized a layer's expert at a
   time), through the HTTP server on the ragged path, launch warmup
   skipped. The 16 requests of phase 4: every response 200 with its 32
   tokens, K1, K2 and K3 launched and K4 not. Prints the weight bytes
   (int8, scales, the rest), the KV blocks, output tok/s and median TTFT;
   ``/debug/perf`` after a prefill window (8 x 1024 tokens) alone in a
   5 s accountant window, MFU in (0, 1.05]; a torch.profiler window of
   one 2048-token ragged step and one of 16 decode steps at 64 rows
   (device busy and idle share, device time by class: attention kernels,
   int8 GEMM, activation quantization, W8A16 dequantization, MoE dispatch
   and combine, bf16 GEMM), each also timed untraced. Then llama-3-8b at
   full width, bf16 against the same weights in int8 on one 256-token
   prompt: last-token logit cosine > 0.99 through W8A8 and W8A16.
9. The KV plane (``kv-plane``): llama-3-8b, bf16, full width and
   ``CUT_LAYERS`` (8) of its 32 layers (the script's time),
   through the HTTP server; this script plays the router's two hops.
   A ``--role prefill`` and a ``--role decode`` server (4096 blocks, 2 GiB
   each) in this process; 16 greedy requests (512-2048 tokens, 64 out,
   64 printable byte tokens allowed, so text is tokens) served unified on
   the prefill server, twice (the repeat's largest logprob deviation sets
   the band: BF16_LOGPROB_BAND or twice that deviation, if larger); then
   pulled (the producer answers ``remote_block_ids``, the consumer pulls
   ``/kv/export`` as a stream: ``cached_tokens`` = the full blocks, 16
   imports); then pushed and spliced (``spliced_seqs_total`` +16); every
   run's tokens equal the unified run's up to a near-tie, logprobs within
   the band. One more push of a fresh 2048-token prompt: the blocks that
   landed equal the producer's bit for bit; its GB/s over loopback and
   the device time of a 128-block gather and scatter are printed. Then
   the host tier (a 1088-block pool, 4 GiB of host tier: wave A of 16 x
   1024 tokens, wave B, which evicts A from the pool, A again: CPU hits
   and prefetched blocks >= 90% of A's 1008 usable blocks, A's tokens as
   before) and the remote tier (this package's ``kv_server`` in a thread;
   one engine serves A, a fresh one serves A again from the remote tier:
   >= 90% remote hits, A's tokens as before); median TTFT of A cold, warm
   from the host and warm from the remote tier, and the prefetch
   histograms. K1, K2 and K3 launch, K4 not.

10. The scoring surface (``scoring-surface``): llama-3-8b bf16 at full
   width and ``CUT_LAYERS`` (8) of its 32 layers (since PR 21: the
   script's time), random weights from seed 0, default scheduler, pool
   at 0.9, through the HTTP server. (a) 4 greedy completions (256-1024
   byte tokens, 32 out, logprobs 1), one at a time, then each prompt and
   completion echoed with ``max_tokens: 0``: every echo entry at a
   completion position within ``SCORE_BAND`` (0.05) of the generation's
   logprob, the echo's top-1 (read in process) the generated token up to
   a near-tie within the band; a 2048-token echo with logprobs. (b) 64
   ``guided_choice`` strings over a 1024-token prompt: the answer is the
   argmax of ``choice_logprobs`` read in process; (a)'s completions
   scored as choices equal their echo sums within 0.05 a token. (c)
   ``/v1/embeddings`` at 16, 2048 and 8191 tokens: 4096 finite floats,
   bit-identical on repeat and through ``/pooling``; ``/v1/score`` of a
   text against itself >= 0.999; ``/v1/rerank``'s order is the score
   order. Each scoring call's wall time and device memory above its
   pre-call allocation are printed, and that peak must stay within
   ``ModelRunner.score_bytes()``, the reserve's share for it. (d) one
   greedy message through ``/v1/chat/completions``, ``/v1/messages`` and
   ``/v1/responses``, JSON and SSE: one text, events in the reference's
   order. (e) ``/sleep`` with a stream in flight answers 409; level 1
   frees >= 0.95 of the pool's bytes (``mem_get_info``), level 2 the pool
   and the weights; after each ``/wake_up`` (a)'s first request gives its
   tokens. K1, K2 and K3 launch, K4 not.
11. Whisper (``whisper``): (a) float32 tiny-whisper, the same weights on
   the card and on the CPU: a 440 Hz tone at 8 kHz, noise at 44.1 kHz
   stereo and silence, each transcribed with language detection,
   translated, in timestamp mode and with a prompt; tokens equal up to
   printed near-ties (``TIE_GAP``), the language equal, no_speech_prob and
   logprobs within 1e-4. (b) whisper-large-v3-class at full width and
   depth (32 + 32 layers, E 1280, 128 mels, vocab 51866), seed-0 weights
   in float32 and cast to bf16: SOT-position logit cosine > 0.99, the
   encoder output's relative error printed. (c) whisper-large-v3-class in
   bf16 at full width and ``CUT_LAYERS`` of its encoder's and decoder's
   layers each (since PR 23: the script's time; (a) and (b) keep their
   depth) served over HTTP with ``--max-num-seqs 4``: 8 concurrent requests
   (5, 12 and 30 s clips at 16 and 44.1 kHz, every response format,
   transcribe and translate, ``max_tokens`` 32) all 200, verbose_json's
   segment tokens at most 32 and start <= end, srt and vtt cues ordered;
   one SSE stream read to ``[DONE]``; one left after its headers: the
   aborted counter goes up by 1, all 4 admission slots are free, and a
   burst of 4 completes; a bad language answers 400 before any device
   work, ``/v1/completions`` 404, ``/v1/models`` carries the
   capabilities. (d) on that runner: encode + cross K/V device time of a
   30 s clip (CUDA events; traced: kernels and device time by class)
   beside its FLOP bound; a traced 32-token decode chunk (wall and device
   time a token, kernels a token, idle share) beside its byte bound; the
   device memory an admitted request holds, and none left once it is
   closed. K1-K4 launch 0 times: Whisper reaches none of them.
12. Resilience, overload and tenants (``overload``): llama-3-8b bf16 at
   full width and depth, seed 0, the ragged path, through
   ``server_from_args``. Server 1 (``--max-queue-len 4 --max-num-seqs 8
   --fault-injection ""``): (a) an expired ``x-request-deadline`` answers
   504 ``timeout_error`` and launches no kernel, a malformed one 200, one
   0.5 s out on a 2000-token request 504 (streamed: data events, the
   in-band error, ``[DONE]``) with ``vllm:aborted_seqs_total`` +1 and
   ``vllm:kv_blocks_free`` back (the time from the deadline to the answer
   printed); (b) 32 concurrent requests: 429s with ``Retry-After`` >= the
   floor, some above it, the rest 200; (c) ``/debug/faults``:
   ``error_rate=1`` answers 500 ``fault_injection`` while ``/health`` and
   ``/metrics`` answer, ``stall_ms=300`` delays the first byte >= 300 ms,
   ``off=1`` restores 200; then, the queue bound lifted in process, (d) a
   wave of ``heavy`` (24 x 1024 tokens) and ``light`` (4 x 128), 32 out:
   ``/debug/tenants`` lists both, the tenants' token deltas sum per phase
   to the accountant's and the prompt tokens, their chip-seconds to the
   attributed dispatch seconds within 1e-6; (e) the wave again with fair
   share on (light's and heavy's median TTFT both ways), and one tenant's
   greedy batch gives the same tokens with fair share on and off. Server
   2 (``--speculative-ngram 4 --brownout`` at a 0.25 s interval, queue
   high 0.05, up 1, calm 2, clamp 16, ``--max-queue-len 64``, weights
   heavy 1, light 4): (f) a heavy flood beside 4 light requests takes
   ``/debug/overload`` to stage 3 (timeline printed); then a new heavy
   request gets 429, a light one 200 and a light one asking 200 tokens at
   most 16; the spec and tenant sheds count; the stage returns to 0. (g)
   On that engine, its front end stopped: a 64-row decode step's untraced
   wall with tenant metering off and on, in turns. K1, K2 and K3 launch,
   K4 not.
13. The observability plane (``observability``): llama-3-8b bf16 at full
   width and ``CUT_LAYERS`` layers (the drill's server too), seed 0, the ragged
   path, through ``server_from_args`` with ``--flight-recorder-size 64
   --perf-ledger-interval 1 --diagnostics-cooldown 0
   --diagnostics-profile-seconds 0.5 --costmodel-drift-band 3`` (ledger and
   bundles in a temporary directory). (a) 16 requests, each with its own
   x-request-id, streamed
   and not, n = 2 on one: ``/debug/requests`` holds 16 records newest
   first, each with received <= admitted <= first_token <= last_token <=
   finished, tokens equal to its usage (the prompt once a choice) and
   outcome ``completed``; an expired deadline gives ``deadline_exceeded``
   and 504, a client that resets its stream ``client_disconnect``; the
   recorder's host cost a request (the server's own merge, on a table of
   its own) printed. (b) ``/debug/memory`` with nothing served: the
   pickle loads, its segments sum to ``memory_reserved()`` and its
   allocated blocks to ``memory_allocated()`` within 1%; bytes and ms
   printed. (c) allocated / total at rest and at a wave's peak printed; no
   ``hbm_pressure`` bundle at the default threshold. (d) ``POST
   /debug/diagnostics/capture`` with an incident while requests arrive
   (every 0.1 s, until 0.1 s into its trace): 200, the bundle holds every
   collector's file, ``memory.pickle``
   and a trace whose kernel events name K1, K2 and K3, with no error;
   16-request waves without and with a capture, in turns, printed. (e) a
   recompile after ``mark_steady`` and the HBM threshold lowered below the
   measured share each leave one bundle, counted by
   ``vllm:diagnostic_bundles_total``. (f) ``POST /drain``: the ledger holds
   interval records and one drain record, stamped with this card and
   platform ``gpu``, whose generation tokens equal ``/metrics``'. K1, K2
   and K3 launch, K4 not. Then no bundle in the default archive, where
   every other phase's servers keep theirs, is an ``hbm_pressure`` one.
14. The decode step as CUDA graphs (``decode-graphs``): llama-3-8b bf16
   at full width and ``CUT_LAYERS`` of its layers (since PR 21: the
   script's time), seed 0, default scheduler, prefix cache off
   (a repeated run must prefill as the first did), one ``LLMEngine`` in
   this process whose graphs and chain are toggled between windows. (c)
   ``warm_decode_graphs``: every key without an adapter at every rung of
   the plan ladder captured (count, seconds, the graph pool's bytes from
   ``torch.cuda.memory_stats`` around the captures beside the runner's
   reserve for it); allocated share under 0.92. (a) 32 requests x 48
   tokens, greedy and seeded-sampled, contexts of 100-700 tokens (three
   rungs): graphed = eager in tokens and logprobs bit for bit; chain on =
   chain off in tokens, with max_tokens staggered so the decode rows
   change membership, and some dispatches chained. (b) the decode step's
   untraced wall, eager / graphed / graphed + chain in turns, two
   rounds of 16 steps, at 64 and 4 rows and contexts ~130-180 and
   ~2100-2260 (median and spread printed); one eager and one graphed
   window of 16 steps at 64 rows traced (device busy, idle share, kernels
   a step). (d) sleep level 2, then wake: the graphs are dropped and
   captured again, 8 greedy requests' tokens equal before and after
   (phase 10 (e) sleeps at both levels with graphs on). Then, the engine
   released, K3 at the ladder's plan against the exact per-step plan on
   the same inputs (64 live rows at ~150 and ~2K, 4 live of 64 at 8192),
   each checked against the plain version first, with the plain version
   and SDPA and varlen_attn on the live rows' gathered contexts timed
   beside them.
   K1, K2 and K3 launch (K1 and K3 counted through the replays), K4 not.

15. Tensor parallelism (``tp2``): llama-3-8b bf16 at full width and
   ``CUT_LAYERS`` (8) of its 32 layers, as in phases 16-18 (over gloo a
   step's collectives cost milliseconds a layer; each judged comparison
   holds two runs of one depth), seed 0, prefix cache off, decode eager,
   2048 KV blocks a rank,
   at tensor-parallel size 2 with both ranks on this card over gloo
   (NCCL refuses two ranks on one card). The tp 1 engine of each path
   runs first and is released before the ranks start. (a) 16 greedy
   prompts (64-1024 tokens, 16 out, logprobs 2) on the ragged path, then
   the bucketed path: tokens equal tp 1's up to a near-tie, logprobs
   within max(``BF16_LOGPROB_BAND``, twice tp 1's own repeat deviation);
   the follower's token digest and call count equal rank 0's exactly, and
   it launched the same kernels as many times; on the ragged engine,
   phase 17 (d)'s 128-block export and import. (b) K1-K4 at the shard's
   shapes (H 16, KH 4, D 128), against their plain versions as in phase
   3, with times, bounds and library calls (each kernel's record carries
   them under ``also``), without phase 3's tile and span sweeps. (c) The
   server in a fresh process (``chip_smoke.py --tp-server PORT``,
   ``server.main`` with both ranks on cuda:0 over gloo), run after phase
   16 (a) as phase 17's prefill server: 8 concurrent requests answer 200
   with their 16 tokens (phase 17's reference wave); phase 16 (c)'s and
   phase 17 (c)'s routes; after SIGTERM, no rank's process is alive
   within 3 s. Beside its start, ``--tensor-parallel-size 2`` on the
   command line (rank r on cuda:r) exits non-zero naming the card
   count. (d) Printed, not judged: an
   eager 64-row decode step and a 2048-token ragged step at tp 2 beside
   tp 1 (one of each; three until PR 18), and the phase's seconds: two
   ranks share one card over gloo, so none of these is a tensor-parallel
   speed. K1-K4 launch (K2 on the ragged path, K4 on the bucketed one).
16. The model's features at tensor-parallel size 2 (``tp2-features``),
   both ranks on this card over gloo. (a) mixtral-8x7b in int8, phase 8's
   configuration at full width and ``CUT_LAYERS`` layers on the ragged
   path (a rank holds every expert's half of F), 2048 KV blocks a
   rank, prefix cache off: 16 greedy prompts (64-256 tokens) x 16 tokens
   against tp 1's answers, taken first on a tp 1 engine of the same
   depth, released before the ranks start,
   with its slots handed out as a fresh engine's (a ragged step packs
   spans in slot order, and the tokens past an expert's capacity follow
   it). There an identical repeat must be bit for bit, and the same 16
   requests at once again with tp 2's row-parallel float sums made on the
   one device (``_RankSums``: ``wo`` and the experts' ``w_down`` as two
   float32 partials) give tp 1's own deviation at the same batch. tp 2's
   first ragged step must equal that one-device step in every MoE block's
   input and output bit for bit, its logprobs within two bf16 steps of
   its largest logit (the vocab-cut head's own rounding); a decode step
   from an empty context must equal tp 1's bit for bit; the step beside
   plain tp 1's, layer by layer, is printed (``_FirstStepProbe``). The
   whole wave, every token and every logprob, must equal the one-device
   run with tp 2's sums bit for bit; beside plain tp 1 it is printed with
   the band it stayed in before (flips where tp 1's top-2 gap is under
   max(``INT8_TIE_GAP``, twice the largest at the one-device repeat's
   flips), logprobs within max(``INT8_LP_BAND``, twice its deviation));
   the follower's digest and launches rank 0's; K1-K3 launch, K4 not; a
   rank's weight bytes, KV blocks and engine-up seconds printed. (b)
   llama-3-8b bf16 with a rank-16 adapter on all seven targets (written
   here in numpy), on phase 15's tp 1 and tp 2 engines
   after their own waves, ragged and bucketed: the adapter loaded (at tp
   2 each rank receives its share), one wave of 8 prompts (64-256 tokens,
   16 out), base and adapter rows, and prompt 0 again with the adapter;
   tokens equal tp 1's up to a near-tie,
   logprobs within max(0.05, twice tp 1's own deviation), the adapter
   changes prompt 0's tokens at both, the follower = rank 0. (c) On
   phase 15 (c)'s server: ``/v1/load_lora_adapter``, a completion naming
   the adapter and ``/v1/unload_lora_adapter`` answer 200. (d) Printed, not
   judged: (a)'s 64-row decode step (contexts ~32-48) and 2048-token
   ragged step, once each (twice until PR 18), their share in
   collectives and the bytes each collective kind sent; these walls, as
   the phase's, run beside phase 17's two servers starting in their own
   processes. Phase 16's waves
   prefill in one or two steps: at tp 2 over gloo a step's collectives
   take seconds.
17. The KV plane at tensor-parallel size 2 (``tp2-kv-plane``), after
   phase 16 (a): llama-3-8b bf16 at ``CUT_LAYERS`` layers, a prefill
   server (``--role
   prefill``, phase 15 (c)'s server) and a decode server (``--role
   decode``, 536 KV blocks a rank, a 4 GiB host tier) each in a fresh
   process (``--tp-server``, ``server.main``, both ranks of each on this card
   over gloo), started before phase 16 (``_TpKvStart``), both with
   ``--remote-kv-url`` to a ``kv_server`` in this process. The reference: 8
   prompts (512-1024 tokens, 16 out) served twice by the prefill server itself,
   as phase 9 takes it; the
   band is max(``BF16_LOGPROB_BAND``, twice its own repeat deviation).
   (a) The same 8 pulled, then pushed and spliced, as phase 9 judges
   them: imports 8 with ``cached_tokens`` the full blocks, splices 8,
   tokens equal the reference up to a near-tie, logprobs within the
   band; a lone 2048-token push lands 128 full blocks equal, bit for
   bit, to the producer's pool as its ranks hold it, joined (each
   server's ``/kv/export``), and is spliced. (b) The host tier (wave A
   of 4 x 1024 tokens, wave B of 8 evicting it from the pool, wave A
   again) and the remote tier (wave C of 4 served by the prefill server,
   which offloads it, then by the decode server): each wave back hits
   at least 90% of its usable blocks, tokens equal as in (a). (c) On
   the prefill server: ``/kv/export`` answers a real prompt's two blocks
   (200, grouped in 2), which, streamed out in frames of half the layers
   and pushed into its own
   ``/kv/recv`` (200), a continuation splices. (d) Printed, not judged,
   beside phase 9's tp 1 figures: the lone push's GB/s, the wall of a
   128-block export and import at tp 2 and the device time of rank 0's
   own gather and scatter (phase 15 (a)'s engine), median TTFT cold, warm
   from the host tier and warm from the remote tier. Rank 0's launches
   of both servers, read over ``/debug/perf`` before and after (a) and
   (b): K1-K3, not K4. Both servers leave on SIGTERM, their followers
   within 3 s.
18. Whisper at tensor-parallel size 2 (``tp2-whisper``):
   whisper-large-v3-class in bf16 at full width and ``CUT_LAYERS`` of its
   32 encoder and 32 decoder layers each, seed 0, both ranks on this
   card over gloo, through ``server_from_args`` with
   ``--max-num-seqs 4`` (a rank holds half of the heads, the MLP and the
   vocabulary, and half of each request's cross and self K/V). (a) Three
   clips (5, 12 and 30 s; detection, translation, timestamp mode),
   greedy, 16 tokens: tokens, logprobs, ``no_speech_prob`` and the
   language equal, bit for bit, those of the tp 1 runner on the same
   weights computing as the ranks do (``_WhisperRankSums``: each
   column-parallel product and attention on the ranks' halves, each
   row-parallel product as two float32 partials added and rounded once);
   the band against plain tp 1 printed beside it. (b) The server over
   HTTP: 6 concurrent requests (four whole, one SSE stream read to
   ``[DONE]``, one left after its headers), every response 200, the
   abort counted; then every rank's digest and call count rank 0's, no
   rank holding a request's state, no kernel launched on either. (c)
   Printed, not judged: each rank's weight bytes and one live request's
   bytes beside tp 1's, a 30 s clip's encode wall and a token's wall at
   tp 2 beside tp 1. (d) The same server in a fresh process
   (``--tp-server PORT --model whisper-large-v3-class``) answers a
   request, and its follower is gone within 3 s of SIGTERM. K1-K4 launch
   0 times.

19. Pipeline parallelism (``pp2``): llama-3-8b bf16 at full width and
   depth, seed 0, at pipeline-parallel size 2 with both stages on this
   card (each stage a runner with 16 layers and its own KV pool, the
   host relaying the residual stream; the bucketed path, decode eager).
   (a) Phase 15's 16 prompts, greedy, ``TP_TOKENS`` tokens, against
   the tp 1 bucketed engine at full depth on them (run first and
   released; phase 15's runs are at ``CUT_LAYERS``): tokens equal, bit
   for bit predicted; a flip is accepted only where the reference's top-2
   gap is under ``TIE_GAP``, and printed. (b) K1, K3 and K4 launch on (a)
   and K2 does not. Then the bucketed HTTP server from the flags
   (``--pipeline-parallel-size 1``, then ``2`` through
   ``server_from_args`` with both stages on cuda:0), each sizing its
   pools from the card's free memory in the same state: (c) printed, each
   stage's weight bytes and the block count of the stages' pools (both
   alike) beside pp 1's; (d) printed, not judged, the host wall of a
   64-row decode step on each server's engine thread, eager over the two
   stages, graphed at pp 1 (not a PP speed: the stages share one card);
   (e) at each, one completion (200, every token), and at pp 2 one with
   logprobs, answered 400.

20. Sequence parallelism (``seq2``): llama-3-8b bf16 at full width and
   ``CUT_LAYERS`` layers (84 s at full depth, over the phase's 60 s),
   seed 0, ``max_model_len`` 8192, at sequence-parallel size 2
   with both ranks on this card over gloo (each holding the whole model
   and a pool of ``SEQ_BLOCKS`` blocks), ring threshold 4096, the ragged
   path, decode graphs on. (a) 4 greedy prompts of 4500-8000 tokens, 16
   tokens each with logprobs, through the ring, against the same prompts
   through the chunked path on the same engine (the prefix cache
   cleared by a level-1 sleep, the ring switched off): tokens equal up to
   a near-tie (a flip only where the chunked run's top-2 gap is under the
   band), logprobs within the band, max(``BF16_LOGPROB_BAND``, twice the
   chunked run's own deviation 2 at a time from a cleared cache). (b) The scheduler took the
   ring for each prompt, alone, padded to 8192; K1 and K3 launch on the
   ring wave and K2 and K4 do not, on every rank; the ranks' digests
   agree; rank 0's ``ring_rotate`` and ``ring_gather`` bytes are the
   prediction, 4 prompts x the layers x one 4096-token K/V shard (16.8
   MB) each.
   (c) Printed, not judged: one fresh 8000-token prompt's prefill through
   the ring and then through the chunked path, each its wall and rank
   0's device busy time (not a sequence-parallel speed: the ranks share
   one card and their exchange goes through host memory). (d) The first
   prompt again takes the chunked path with ``(n - 1) // 16 * 16``
   tokens cached and no ring call, and its tokens are (a)'s. (e) The
   server in a fresh process (``--tp-server PORT --tensor-parallel-size
   1 --sequence-parallel-size 2``, ``CUT_LAYERS`` layers; started as the
   phase starts, so that its start-up runs beside (a)-(d)) answers a
   6000-token completion with 16 tokens through the ring (its
   ``prefill_ring:8192`` signature in ``/debug/perf``), and its follower
   is gone within 3 s of SIGTERM.
21. Sequence x tensor parallelism (``seq2tp2``): phase 20 on the seq x
   tensor grid, seq 2 x tp 2: four processes on this card over gloo, each
   tensor rank's two seq ranks holding its shard (H 16, KH 4) and a pool
   of ``SEQ_BLOCKS`` blocks of its KV heads, decode eager (the tensor
   group's collectives run in decode). (a)-(d) as phase 20 on the same
   prompts, the band from the chunked run's own deviation on this engine;
   (b) rank 0's ``ring_rotate`` and ``ring_gather`` bytes are each half
   phase 20's (4 prompts x the layers x a 4096-token shard of 4 KV heads,
   8.4 MB), every follower's digest and launches rank 0's, and the tensor
   group's bytes are printed by op. (e) The server in a fresh process
   (``--tp-server PORT --tensor-parallel-size 2 --sequence-parallel-size
   2``), started before phase 20 so that its start-up runs beside it,
   answers the 6000-token completion through the ring, and its three
   followers are gone within 3 s of SIGTERM.
22. Multi-host serving (``mh2-one-card``): llama-3-8b bf16 at tp 2 and
   ``CUT_LAYERS`` as two processes started on their own (``--mh-server
   PORT``: the ``PSTPU_*`` environment, then ``server.main`` with
   ``rank_devices=["cuda:0"]`` over gloo), the calls on the authenticated
   step-plan channel; started before phase 20, beside the spawned
   ``--tp-server`` of the same flags and depth. (a) A leader without
   ``PSTPU_CONTROL_SECRET`` exits non-zero with the card untouched; a
   follower with a wrong secret is refused and exits non-zero while the
   leader waits; the right one then joins. (b) 4 greedy prompts of
   64-1024 tokens x 16, one at a time: tokens and logprobs equal the
   spawned server's bit for bit; then a concurrent wave of 8, each 200,
   tokens equal up to a near-tie and logprobs within max(0.05, twice the
   spawned server's own repeat deviation). (c) Both ranks' digests, calls
   and launches equal (``/debug/ranks``); the follower's ``/health`` is
   ``{"status": "follower", "process_id": 1}``. (d) SIGTERM to the
   leader: it drains and exits 0, the follower exits 0 within 5 s; a
   fresh pair: SIGKILL to the leader, the follower exits 0 within 5 s on
   the closed channel. Printed: start-up seconds, each call's median
   frame bytes and host microseconds to send, a decode step's wall.
23. Pipeline x tensor parallelism (``pp2tp2-one-card``): llama-3-8b bf16
   at full width and ``CUT_LAYERS`` (8) of its layers (the script's
   time), seed 0, at pp 2 x tp 2: four processes on this card over gloo
   (the stage x tensor grid, process g stage g // 2 and tensor rank g %
   2, each 4 layers at H 16 and KH 4 and a pool of ``TP_BLOCKS``
   blocks), the bucketed path, prefix cache off, decode eager, the
   residual stream relayed stage to stage through host memory. (a) Phase
   15's 16 prompts, greedy, ``TP_TOKENS`` tokens, against the tp 2
   bucketed engine at the same depth (run first and released): tokens
   equal bit for bit (stage after stage runs tp 2's operations). (b) K1, K3 and
   K4 launch on each of the four processes (``follower_reports``, each
   naming its stage and tensor rank) and K2 on none; every digest rank
   0's. (c) Printed, not judged: each process's weight bytes, the block
   count, three eager 64-row decode steps' host wall and the stage
   relay's bytes each step on rank 0. (d) The server from
   ``--pipeline-parallel-size 2 --tensor-parallel-size 2`` in a fresh
   process (``--tp-server``, ``CUT_LAYERS`` layers, started as phase 23
   starts) answers a completion, a stream, an embedding and
   ``/kv/export`` (two blocks, tp 2's head groups, every stage's layers),
   and its three followers are gone within 3 s of SIGTERM.
24. What sequence parallelism did not carry before
   (``seq2-features-one-card``), every process on this card over gloo.
   (c) llama-3-8b bf16 at ``CUT_LAYERS``: a ``--role prefill`` server at
   seq 2 (P), a ``--role decode`` server at seq 1 (D) and a fresh seq 2
   server with a 4 GiB host tier (P2), P and P2 on a remote store in
   this process (``--tp-server``, each in a fresh process, started as
   phase 22 starts so that their start-up runs beside phases 22-23). P's
   own unified answers to 8 prompts of 4500-6000 tokens x 16, through the
   ring (its ``prefill_ring:8192`` signature), twice (the repeat's
   deviation sets the band, as phase 9's); the 8 pulled by D (imports 8,
   ``cached_tokens`` the full blocks), then pushed and spliced (splices
   8): tokens equal P's up to a near-tie, logprobs within the band; a
   fresh 4608-token prompt pushed alone through the ring: its blocks
   landed on D equal P's bit for bit. Then
   P2: wave A (4 of the 8) from the remote tier P wrote at each finish,
   against P's answers; wave B (3 x 8000 tokens through the ring) evicts
   A from P2's pool; A again from the host tier, against P2's first
   serve: each tier's hits and committed blocks at least 90% of A's
   usable blocks. K1, K2 and K3 launch on the three servers' rank 0, K4
   not; every follower gone within 3 s of SIGTERM. (a) mixtral-8x7b
   ``--quantization int8`` at ``CUT_LAYERS`` (about 12 GB of int8
   weights a process; the whole model does not fit twice on the card)
   at seq 2: phase 20's 4 prompts of 4500-8000 tokens x 16 through the
   ring (one call a prompt, padded to 8192), then through the chunked
   path on the same engine (prefix cache off) and again 2 at a time:
   tokens equal up to a near-tie, logprobs within max(0.05, twice the
   chunked run's own deviation); the ranks' digests and launches equal;
   K1 and K3 on the ring wave, K2 and K4 not; rank 0's ``ring_rotate``
   and ``ring_gather`` bytes phase 20's formula at Mixtral's KH 8, its
   ``ring_moe_counts`` bytes 4 prompts x 8 layers x 1 x 8 experts x 4 B;
   each prompt's first token against one process's forward of its whole
   padded prompt on rank 0's weights (the reference's ring call: dense
   attention, S's int8 route and MoE capacity, the slots ranked over all
   S tokens at once): the same token unless that forward's top-2 gap is
   under ``SEQF_FIRST_BAND`` (0.15), logprobs within it. Printed: the
   int8 route each ring call's products took, the slots past capacity of
   each prompt (real and pad tokens' apart, and the real ones that rank
   0's counts decide), and the one-process first token with each half
   ranking its slots alone (what a missing offset gives), and judged:
   some real slot is dropped only through rank 0's counts, and the judge
   refuses some prompt's first token without the offset. (b) The same
   at seq 2 x tp 2, four processes, 2 of (a)'s prompts (4500 and 8000
   tokens), the repeat one at a time, the first tokens against (a)'s
   one-process forward; the tensor group's bytes printed by op.
25. Expert parallelism (``ep2-one-card``), every process on this card
   over gloo: mixtral-8x7b ``--quantization int8`` at ``CUT_LAYERS``, as
   phase 16 serves it (seed 0, prefix cache off, eager decode),
   ``EngineConfig.mesh`` with ``expert=2`` (the reference's CLI has no
   expert flag). (a) Expert 2, two processes, each holding 4 of the 8
   experts of every layer and the rest of the model whole: phase 16's 16
   prompts x 16 tokens on the ragged path against phase 16's one-process
   wave on the same weights, every token and every logprob bit for bit
   (each rank's float32 combine partial holds at most a token's two
   weighted rows and zeros, so their sum is one device's); each
   process's weight bytes against ``param_shapes`` with the experts
   halved, exactly; rank 0's ``moe_combine`` bytes against ``L rows E 4``
   over every call it made (``_GridRows``), exactly; K1, K2 and K3 launched
   by both processes, equal, K4 not; then one 2048-token ragged step and
   one 64-row eager decode step, host walls with their combine's share
   and bytes, not speeds. (b) Expert 2 x tp 2, four processes (expert
   rank g // 2, tensor rank g % 2): the same wave against phase 16's tp 2
   wave (the same tensor sums), bit for bit; a bucketed prefill dispatch
   of 208 tokens (``_ep_moves``: K1 and K4 on all four processes) and its
   KV exported equal tp 2's bit for bit, imported into other blocks and
   exported again unchanged; each process's weight bytes, exactly; every
   digest, call count and launch count rank 0's. (c) mixtral-8x7b in
   bf16 (no quantization) at ``CUT_LAYERS``: phase 16's wave on one
   process, released, then at expert 2, where each rank's batched expert
   product runs over 4 experts instead of 8; every token and logprob
   equal.
26. Every mesh on one process grid (``grid-one-card``), every process on
   this card over gloo, at ``CUT_LAYERS`` layers through
   ``EngineConfig.mesh``: (a) mixtral-8x7b int8 at seq 2 x expert 2,
   four processes, on phase 24 (a)'s prompts through the ring, against
   phase 24 (a)'s seq 2 wave bit for bit (expert 2 is expert 1 bit for
   bit); (b) mixtral-8x7b int8 at stage 2 x expert 2, bucketed, on phase
   16's prompts, against one process's bucketed wave at the same depth
   (run first and released) bit for bit; (c) llama-3-8b bf16 at seq 2 x
   stage 2, bucketed, on phase 15's prompts, against pp 2 in one process
   at the same depth (run first and released) bit for bit: the seq ranks
   run no ring beside stages, as the reference's staged runner has no
   ``seq_parallel``, and each is a whole pipeline. Each part prints every
   process's weight bytes, rank 0's launches and each process's (K1, K2
   and K3 on (a); K1, K3 and K4 on (b) and (c)), the ring, count, relay
   and combine bytes on rank 0 against their formulas (``_GridRows``,
   exactly), and the walls of a 64-row decode step and of a 2048-token
   prompt's first step, not speeds.

Before the build the script prints whether ``tensorstore`` and a zstd
decoder import on this machine (``[orbax]``), in a process of their own.

Phases 4-14 run with decode graphs on, the default; phase 5's bf16 run
through the plain versions decodes eagerly (a plain version synchronises
with the host, which a capture cannot hold), and so do phases 15-17
(a gloo collective cannot be captured) and phases 19 and 23 (a staged
runner decodes eagerly), and phases 25-26 (a combine or a stage relay
runs in their decode); Whisper's paths have no graphs. Phase 20's seq ranks
keep theirs: their decode runs no collective. Phase 21's decode runs its
tensor group's, so it decodes eagerly.

The line before the card line carries the kernels' JSON record, whose
``launches`` sum each kernel's launches over every served path (each
path's own counts are in ``launches_by_path``, ``moe-int8``, ``kv-plane``,
``scoring-surface``, ``whisper``, ``overload``, ``observability``,
``decode-graphs``, ``tp2``, ``tp2-lora-ragged``, ``tp2-lora-bucketed``,
``tp2-moe-int8``, ``tp2-kv-plane``, ``tp2-whisper`` (rank 0's), ``pp2``,
``seq2``, ``seq2tp2``, ``mh2``, ``pp2tp2``, ``seq2-moe-int8``,
``seq2tp2-moe-int8``, ``seq2-kv-plane``, ``ep2-moe-int8``,
``ep2tp2-moe-int8``, ``ep2tp2-moe-int8-bucketed``, ``ep2seq2``,
``ep2pp2`` and ``seq2pp2`` (rank 0's) among them; a
graph
replay adds
the launches its capture recorded); the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import gc
import json
import math
import pathlib
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

ROOT = pathlib.Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# Kernel and plain version both accumulate in float32 and round once to
# bf16, so an output may differ by one bf16 step, at most 2^-7 of its
# magnitude; atol covers float32 sums in another order near zero.
BF16_TOL = (1e-5, 2.0 ** -7)  # (atol, rtol)
F32_TOL = (1e-5, 1e-5)  # float32 sums in another order
# bf16 K2, K3 and K4 round P to bf16 (relative error up to 2^-8) before
# P V, while their denominators sum P unrounded: an output may move by up
# to 2^-8 of the softmax-weighted mean of |V| on top of BF16_TOL
P_ROUNDING = 2.0 ** -8
TIE_GAP = 1e-4
# bf16 tiny-llama through the tensor-core kernels against the same engine
# through their plain versions: the two differ by P's rounding (above),
# which bf16 hidden
# states and logits carry forward; a bf16 logit of magnitude ~4 is only
# resolved to ~2^-6, so logprobs may differ by a few hundredths, and a
# greedy flip is accepted only where the top-2 gap is within that band
BF16_LOGPROB_BAND = 0.05

# phases 6, 7, 9, 10, 11 (c)-(d), 13, 14, 15-18 and 20-26 serve their
# models at full width and this many of their layers (whisper-large-v3-class: of
# its encoder's and of its decoder's each). What they check holds at any
# depth, and each judged comparison holds two runs of one depth; at full
# depth the script took 900-1,300 s of its 1,200 s limit, the gloo phases
# 15-18 varying most with the host, and phase 20 84 s; with phase 21 and
# 10 and 14 at full depth, 853 s; with phase 23 and 11 at full depth, 985
# s; phases 6, 9 and 23 were cut for phase 24 (975.7 s with 9 and 23
# cut). Phases 4, 5, 8, 12 and 19 keep the full depth.
CUT_LAYERS = 8


def _cut_depth(cfg):
    """``cfg`` at ``CUT_LAYERS`` of its layers (a Whisper model's encoder
    and decoder each)."""
    cut = {"num_layers": CUT_LAYERS}
    if cfg.model.architecture == "whisper":
        cut["encoder_layers"] = CUT_LAYERS
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **cut))


class _CutServers:
    """Inside it, a server made from the flags (``server.main``,
    ``server_from_args``) serves its model at ``CUT_LAYERS`` of its layers
    (``_cut_depth`` over ``server.config_from_args``); every flag keeps
    its meaning."""

    def __enter__(self):
        from production_stack_tpu_torch.engine import server

        self.server, self.base = server, server.config_from_args
        server.config_from_args = lambda args, *a: _cut_depth(
            self.base(args, *a))
        return self

    def __exit__(self, *exc):
        self.server.config_from_args = self.base


SRC = {
    "K1": ("production_stack_tpu_torch/csrc/kv_write.cu",
           "production_stack_tpu/ops/paged_attention_pallas.py:476"),
    "K2": ("production_stack_tpu_torch/csrc/ragged_paged_attention.cu",
           "production_stack_tpu/ops/ragged_paged_attention_pallas.py:51"),
    "K3": ("production_stack_tpu_torch/csrc/paged_decode_attention.cu",
           "production_stack_tpu/ops/paged_attention_pallas.py:53"),
    "K4": ("production_stack_tpu_torch/csrc/paged_prefill_attention.cu",
           "production_stack_tpu/ops/paged_attention_pallas.py:277"),
}
SDPA_NOTE = "SDPA on pre-gathered K/V, gather not counted"
# further numbers a kernel's record carries where it has them, and those of
# each further shape it was measured at ("also")
EXTRA_KEYS = ("varlen_ms", "varlen_max_abs_err", "varlen_note",
              "ms_by_tile", "ms_by_split_span")
ALSO_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "k4_same_work_ms") + EXTRA_KEYS


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 2, rounds: int = 3,
            graph: bool = True) -> float:
    """The device's time of one call, in milliseconds: after warm-up, one
    pair of CUDA events around ``reps`` back-to-back calls, over the count;
    the median of ``rounds`` such
    runs. With ``graph`` the ``reps`` calls are captured once into a CUDA
    graph and the events bracket its replay: issued from Python one by
    one, a call of a few microseconds is paced by the host's wrapper, not
    by the device (on an H100, K1 read 35 us a call that way, against
    1.7-5 us of kernel time in the profiler). Functions that synchronise
    (the plain versions) take ``graph=False``. The L2 cache is not
    flushed: in a step, a kernel's inputs were just written by the kernel
    before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()  # the first replay uploads the graph
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def call_ms(torch, fn, reps: int) -> float:
    """Median time of one call with a synchronise after it, the host's
    wrapper and launch included: beside ``time_ms`` it shows what a call
    costs the host when the device waits for it."""
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


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernels ---------------------------------------------------------

def make_stream(rng, spans, T, S, M, bs, KH2, D, dtype, torch, L=2, layer=1):
    """A pool whose every unwritten slot is NaN, plus the packed stream of
    ``spans`` = [(slot, q_len, ctx)]: slots own distinct random blocks, the
    tables are 0-padded past live blocks (block 0 belongs to a sequence),
    and each slot's positions below ctx hold random values."""
    import numpy as np

    need = sum(-(-ctx // bs) for _, _, ctx in spans)
    N = need + 8
    perm = rng.permutation(N).astype(np.int32)
    perm = np.concatenate([[0], perm[perm != 0]])  # block 0 is live
    tables = np.zeros((S, M), np.int32)
    ctx_lens = np.zeros(S, np.int32)
    cu = np.zeros(S + 1, np.int32)
    written = []
    nxt = 0
    by_slot = {slot: (q, c) for slot, q, c in spans}
    for slot in range(S):
        q_len, ctx = by_slot.get(slot, (0, 0))
        nb = -(-ctx // bs)
        tables[slot, :nb] = perm[nxt:nxt + nb]
        nxt += nb
        ctx_lens[slot] = ctx
        cu[slot + 1] = cu[slot] + q_len
        for p in range(ctx):
            written.append(tables[slot, p // bs] * bs + p % bs)
    assert cu[-1] <= T
    pool = torch.full((L, N, bs, KH2, D), float("nan"), dtype=dtype,
                      device="cuda")
    flat = pool[layer].view(N * bs, KH2, D)
    idx = torch.as_tensor(np.asarray(written, np.int64), device="cuda")
    flat[idx] = torch.randn((len(written), KH2, D), dtype=dtype, device="cuda")
    slots = np.full(T, -1, np.int32)
    for slot in range(S):
        q_len, ctx = by_slot.get(slot, (0, 0))
        c0 = cu[slot]
        for j in range(q_len):
            p = ctx - q_len + j
            slots[c0 + j] = tables[slot, p // bs] * bs + p % bs
    dev = {k: torch.as_tensor(v, device="cuda") for k, v in
           (("tables", tables), ("ctx", ctx_lens), ("cu", cu),
            ("slots", slots))}
    return pool, dev, spans


def ragged_work(spans, H, KH, D, itemsize, S, bs, T):
    """(bytes, FLOPs) K2 needs for these spans: the q rows of spans once
    (tail padding outputs 0 whatever q holds), all T output rows once, each
    span's context K and V and its live block-table entries once, the span
    offsets and context lengths; 4 H D FLOPs per (query, visible position)
    pair."""
    flops = 0
    nbytes = T * H * D * itemsize + (2 * S + 1) * 4
    for _, q_len, ctx in spans:
        if q_len:
            # token j of the span sees ctx - q_len + j + 1 positions
            vis = q_len * (ctx - q_len + 1) + q_len * (q_len - 1) // 2
            flops += 4 * H * D * vis
            nbytes += (q_len * H * D * itemsize + ctx * 2 * KH * D * itemsize
                       + -(-ctx // bs) * 4)
    return nbytes, flops


def decode_work(ctx_lens, H, KH, D, itemsize, bs):
    """(bytes, FLOPs) K3 needs: the q rows of slots with context once, all
    output rows once, each context's K and V and live block-table entries
    once, the context lengths; 4 H D FLOPs per visible position."""
    B = len(ctx_lens)
    live = [c for c in ctx_lens if c > 0]
    nbytes = (len(live) * H * D * itemsize + B * H * D * itemsize + B * 4
              + sum(c * 2 * KH * D * itemsize + -(-c // bs) * 4
                    for c in live))
    return nbytes, 4 * H * D * sum(live)


def make_prefill_batch(rng, chunks, S, M, bs, KH2, D, dtype, torch, L=2,
                       layer=1):
    """A pool whose every unwritten slot is NaN, plus a batch of
    ``chunks`` = [(q_start, chunk_len) or None for an inactive row] padded
    to the bucket S: chunks own distinct random blocks, the tables are
    0-padded past live blocks (block 0 belongs to a chunk), and each active
    chunk's positions below its context hold random values (those of the
    chunk itself as K1 writes them just before K4 runs)."""
    import numpy as np

    P = len(chunks)
    ctxs = [sum(c) if c else 0 for c in chunks]
    N = sum(-(-c // bs) for c in ctxs) + 8
    perm = rng.permutation(N).astype(np.int32)
    perm = np.concatenate([[0], perm[perm != 0]])  # block 0 is live
    tables = np.zeros((P, M), np.int32)
    q_starts = np.full(P, -1, np.int32)  # as the engine passes inactive rows
    written = []
    nxt = 0
    for p, c in enumerate(chunks):
        if c is None:
            continue
        nb = -(-ctxs[p] // bs)
        tables[p, :nb] = perm[nxt:nxt + nb]
        nxt += nb
        q_starts[p] = c[0]
        pos = np.arange(ctxs[p])
        written.append(tables[p, pos // bs].astype(np.int64) * bs + pos % bs)
    pool = torch.full((L, N, bs, KH2, D), float("nan"), dtype=dtype,
                      device="cuda")
    flat = pool[layer].view(N * bs, KH2, D)
    idx = torch.as_tensor(np.concatenate(written), device="cuda")
    flat[idx] = torch.randn((len(idx), KH2, D), dtype=dtype, device="cuda")
    dev = {k: torch.as_tensor(v, device="cuda") for k, v in
           (("tables", tables), ("q_starts", q_starts),
            ("ctx", np.asarray(ctxs, np.int32)))}
    return pool, dev


def prefill_work(chunks, S, H, KH, D, itemsize, bs):
    """(bytes, FLOPs) K4 needs: the q rows of active chunks (the padding
    rows of an active chunk attend its whole context, so their queries are
    read too; an inactive chunk outputs 0 whatever q holds), all output
    rows, each active chunk's context K and V and live block-table entries
    once, the chunk starts and contexts; 4 H D FLOPs per (row, visible
    position) pair, where row s of a chunk sees min(q_start + s + 1, ctx)
    positions."""
    P = len(chunks)
    nbytes = P * S * H * D * itemsize + 2 * P * 4
    flops = 0
    for c in chunks:
        if c is None:
            continue
        q0, n = c
        ctx = q0 + n
        vis = n * q0 + n * (n + 1) // 2 + (S - n) * ctx
        flops += 4 * H * D * vis
        nbytes += (S * H * D * itemsize + ctx * 2 * KH * D * itemsize
                   + -(-ctx // bs) * 4)
    return nbytes, flops


def sdpa_yardstick(torch, pool, layer, entries, H, KH):
    """One ``scaled_dot_product_attention`` call that computes what a paged
    kernel computes on these inputs, for its ``library_ms``: each entry's
    context gathered contiguously beforehand (not timed), GQA heads
    expanded, queries padded to the longest entry and the causal offset as
    a boolean mask. ``entries`` = [(q (n, H, D), positions (n,), ctx,
    table row)], one per span, sequence or active chunk. Returns the call
    and a function giving entry b's (n, H, D) rows of its output."""
    import torch.nn.functional as F
    from production_stack_tpu_torch.ops.paged_attention import split_kv

    _, _, bs, KH2, D = pool.shape
    G = H // KH
    B = len(entries)
    Lq = max(e[0].shape[0] for e in entries)
    Lk = max(e[2] for e in entries)
    dev, dt = pool.device, pool.dtype
    Q = torch.zeros((B, H, Lq, D), dtype=dt, device=dev)
    K = torch.zeros((B, H, Lk, D), dtype=dt, device=dev)
    V = torch.zeros_like(K)
    mask = torch.zeros((B, 1, Lq, Lk), dtype=torch.bool, device=dev)
    for b, (q, qpos, ctx, row) in enumerate(entries):
        nb = -(-ctx // bs)
        k, v = split_kv(pool[layer][row[:nb].long()].reshape(
            nb * bs, KH2, D)[:ctx])
        K[b, :, :ctx] = k.repeat_interleave(G, dim=1).transpose(0, 1)
        V[b, :, :ctx] = v.repeat_interleave(G, dim=1).transpose(0, 1)
        Q[b, :, :q.shape[0]] = q.transpose(0, 1)
        mask[b, 0, :q.shape[0], :ctx] = (
            torch.arange(ctx, device=dev)[None, :] <= qpos[:, None])

    def call():
        return F.scaled_dot_product_attention(Q, K, V, attn_mask=mask)

    def rows(out, b):
        return out[b, :, :entries[b][0].shape[0]].transpose(0, 1)

    return call, rows


def time_sdpa(torch, name, pool, layer, entries, H, KH, want_rows,
              reps=10) -> float:
    """Time the SDPA yardstick, and log how far its output lies from the
    plain version's on the same rows (a check that it computes the same
    function; its bf16 rounding differs from the kernels')."""
    call, rows = sdpa_yardstick(torch, pool, layer, entries, H, KH)
    out = call()
    err = max(float((rows(out, b).float() - w.float()).abs().max())
              for b, w in enumerate(want_rows))
    ms = time_ms(torch, call, reps)
    log(f"[kernels] {name} library call ({SDPA_NOTE}): {ms:.4f} ms, max abs "
        f"err against the plain version {err:.3e}")
    del out
    return ms


def time_varlen(torch, name, pool, layer, entries, H, KH, want_rows,
                reps=10):
    """``torch.nn.attention.varlen.varlen_attn`` as a second yardstick for
    K2 and K3: the entries' contexts gathered contiguously beforehand (not
    timed), packed with their query rows, causal from the bottom right (a
    query row at position ctx - n + i sees the first ctx - n + i + 1 keys),
    GQA by its own option where it has one. Returns (ms, max abs err
    against the plain version), or (None, why) where the card's PyTorch
    lacks the call or a causal option, or the call fails."""
    import inspect

    from production_stack_tpu_torch.ops.paged_attention import split_kv

    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError as e:
        return None, f"no varlen_attn in torch {torch.__version__} ({e})"
    params = inspect.signature(varlen_attn).parameters
    kw = {}
    if "window_size" in params:
        kw["window_size"] = (-1, 0)
    elif "is_causal" in params:
        kw["is_causal"] = True
    else:
        return None, "varlen_attn has no causal option"
    gqa = "enable_gqa" in params
    if gqa:
        kw["enable_gqa"] = True
    _, _, bs, KH2, D = pool.shape
    G = H // KH
    qs, ks, vs, cu_q, cu_k = [], [], [], [0], [0]
    for q, _, ctx, row in entries:
        nb = -(-ctx // bs)
        k, v = split_kv(pool[layer][row[:nb].long()].reshape(
            nb * bs, KH2, D)[:ctx])
        if not gqa:
            k, v = (x.repeat_interleave(G, dim=1) for x in (k, v))
        qs.append(q)
        ks.append(k)
        vs.append(v)
        cu_q.append(cu_q[-1] + q.shape[0])
        cu_k.append(cu_k[-1] + ctx)
    Q = torch.cat(qs).contiguous()
    K = torch.cat(ks).contiguous()
    V = torch.cat(vs).contiguous()
    cq = torch.tensor(cu_q, dtype=torch.int32, device=pool.device)
    ck = torch.tensor(cu_k, dtype=torch.int32, device=pool.device)
    max_q = max(e[0].shape[0] for e in entries)
    max_k = max(e[2] for e in entries)

    def call():
        return varlen_attn(Q, K, V, cq, ck, max_q, max_k, **kw)

    try:
        out = call()
        err = max(float((out[cu_q[b]:cu_q[b + 1]].float() - w.float())
                        .abs().max()) for b, w in enumerate(want_rows))
        ms = time_ms(torch, call, reps)
    except Exception as e:  # a yardstick only: record why it did not run
        return None, f"varlen_attn failed: {type(e).__name__}: {e}"[:300]
    log(f"[kernels] {name} library call (varlen_attn, {kw}, on pre-gathered "
        f"K/V, gather not counted): {ms:.4f} ms, max abs err against the "
        f"plain version {err:.3e}")
    return ms, err


def check_close(name, got, want, tol, torch, extra=None) -> float:
    """Max abs error of ``got`` against ``want``, failing past ``tol`` =
    (atol, rtol), plus ``extra`` (a tensor like ``want``) where given; logs
    the worst element against its own limit."""
    atol, rtol = tol
    got_f, want_f = got.float(), want.float()
    if not torch.isfinite(got_f).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got_f - want_f).abs()
    limit = atol + rtol * want_f.abs()
    if extra is not None:
        limit = limit + extra
    bad = err > limit
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off, max abs err "
            f"{float(err.max()):.3e} (atol {atol}, rtol {rtol}"
            f"{'' if extra is None else ', + extra'}); worst "
            f"{float((err / limit).max()):.3f} of its limit")
    share = err / limit
    worst = int(share.argmax())
    log(f"[kernels] {name}: max abs err {float(err.max()):.4e}, worst "
        f"element err {float(err.flatten()[worst]):.4e} at |plain| "
        f"{float(want_f.abs().flatten()[worst]):.4e}, "
        f"{float(share.max()):.3f} of its limit; output rms "
        f"{float(want_f.pow(2).mean().sqrt()):.4e}")
    return float(err.max())


def p_allowance(plain, args, torch, soft_cap=0.0):
    """P_ROUNDING of plain(|V|): the plain version ``plain`` on ``args``
    (q, pool, ...) with every V of the pool replaced by |V|."""
    q, pool, *rest = args
    KH = pool.shape[3] // 2
    abs_v = pool.clone()
    abs_v[:, :, :, KH:] = abs_v[:, :, :, KH:].abs()
    extra = P_ROUNDING * plain(q, abs_v, *rest, soft_cap=soft_cap).float()
    del abs_v
    return extra


def check_kernel(name, got, want, plain, args, torch, soft_cap=0.0,
                 extra=None) -> float:
    """A K2, K3 or K4 output against its plain version ``want`` on
    ``args``: float32 within F32_TOL; bf16 within BF16_TOL plus
    ``p_allowance`` (computed here unless given)."""
    if got.dtype == torch.float32:
        return check_close(name, got, want, F32_TOL, torch)
    if extra is None:
        extra = p_allowance(plain, args, torch, soft_cap)
    return check_close(name, got, want, BF16_TOL, torch, extra=extra)


def prefill_check(torch, rng, name, H, KH, D, dtype, soft_cap=0.0):
    """K4 against its plain version on a small batch at (H, KH, D): a fresh
    chunk, a continuation at q_start 37, a chunk 13 tokens short of the
    bucket S = 40 (whose S * G rows no tile divides: the edge tile is
    masked) and an inactive row. Returns the max abs error."""
    from production_stack_tpu_torch.ops import paged_prefill_attention as k4

    chunks, S = [(0, 40), (37, 40), (0, 27), None], 40
    pool, dev = make_prefill_batch(rng, chunks, S, 8, 16, 2 * KH, D, dtype,
                                   torch)
    q = torch.randn((len(chunks), S, H, D), dtype=dtype, device="cuda")
    args = (q, pool, dev["tables"], dev["q_starts"], dev["ctx"], 1)
    got = k4.paged_prefill_attention(*args, soft_cap=soft_cap)
    err = check_kernel(name, got, k4.paged_prefill_attention_plain(
        *args, soft_cap=soft_cap), k4.paged_prefill_attention_plain, args,
        torch, soft_cap)
    if not (got[3] == 0).all():
        raise AssertionError(f"{name}: the inactive chunk is not exactly 0")
    return err


def head_dim_phase(torch, rng) -> None:
    """K2, K3 and K4 at head dims 96 (phi3-mini-class) and 256 (the Gemma
    classes) with gemma2-9b-class's G = 2 (H = 16, KH = 8) and attention
    soft cap 50, in bf16 and in float32, against their plain versions. At
    D = 256 every bf16 CTA needs more than the 48 KiB of shared memory a
    launch gets without opting in."""
    from production_stack_tpu_torch.ops import paged_decode_attention as k3
    from production_stack_tpu_torch.ops import paged_prefill_attention as k4
    from production_stack_tpu_torch.ops import ragged_paged_attention as k2

    H, KH, cap = 16, 8, 50.0
    spans = [(0, 40, 100), (1, 1, 17), (3, 1, 1), (4, 90, 90), (6, 1, 200)]
    T, S, M, bs = 256, 8, 16, 16
    for D in (96, 256):
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"D={D}, {str(dtype).replace('torch.', '')}"
            pool, dev, _ = make_stream(rng, spans, T, S, M, bs, 2 * KH, D,
                                       dtype, torch)
            q = torch.randn((T, H, D), dtype=dtype, device="cuda")
            args = (q, pool, dev["tables"], dev["cu"], dev["ctx"], 1)
            errs = [check_kernel(
                f"K2 ({tag})", k2.ragged_paged_attention(*args, soft_cap=cap),
                k2.ragged_paged_attention_plain(*args, soft_cap=cap),
                k2.ragged_paged_attention_plain, args, torch, cap)]
            dq = torch.randn((S, H, D), dtype=dtype, device="cuda")
            dargs = (dq, pool, dev["tables"], dev["ctx"], 1)
            errs.append(check_kernel(
                f"K3 ({tag})", k3.paged_decode_attention(*dargs, soft_cap=cap),
                k3.paged_decode_attention_plain(*dargs, soft_cap=cap),
                k3.paged_decode_attention_plain, dargs, torch, cap))
            errs.append(prefill_check(torch, rng, f"K4 ({tag})", H, KH, D,
                                      dtype, soft_cap=cap))
            log(f"[kernels] head dim {tag}, H={H}, KH={KH}, soft_cap {cap}: "
                f"K2 / K3 / K4 max abs err "
                f"{' / '.join(f'{e:.3e}' for e in errs)}")
            del pool
    tile = k4.launch_geometry(1, 1, H, KH, 256, torch.bfloat16)
    log(f"[kernels] bf16 at D=256: a row tile {tile['rows']} x "
        f"{tile['positions']} takes {tile['smem_bytes']} bytes of shared "
        f"memory, the split decode walk {k3.decode_geometry(256)['smem_bytes']}"
        f" (opt-in above {48 * 1024})")


def prefill_kernel_phase(torch, np, card, rng, cfg, M) -> dict:
    """K4 at the llama-3-8b shapes of a bucketed prefill step, against its
    plain version, timed beside it and beside SDPA, with its bound and
    achieved rate; then its tile sweep (every (rows a CTA, positions a
    stage) built for D = 128) on a full bucket of 4 fresh 512-token chunks
    and on one fresh 2048-token chunk, each tile checked first."""
    from production_stack_tpu_torch.ops import paged_prefill_attention as k4

    H, KH, D, bs, layer = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 16, 1
    # a fresh chunk, a continuation of a 700-token context, a chunk shorter
    # than the bucket (212 padding rows) and an inactive row
    chunks, S = [(0, 512), (700, 512), (0, 300), None], 512
    pool, dev = make_prefill_batch(rng, chunks, S, M, bs, 2 * KH, D,
                                   torch.bfloat16, torch, layer=layer)
    q = torch.randn((len(chunks), S, H, D), dtype=torch.bfloat16,
                    device="cuda")
    args = (q, pool, dev["tables"], dev["q_starts"], dev["ctx"], layer)
    got = k4.paged_prefill_attention(*args)
    want = k4.paged_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    err = check_kernel("K4 paged_prefill_attention", got, want,
                       k4.paged_prefill_attention_plain, args, torch)
    if not (got[3] == 0).all():
        raise AssertionError("K4: the inactive chunk is not exactly 0")
    ms = time_ms(torch, lambda: k4.paged_prefill_attention(*args), 50)
    plain_ms = time_ms(torch, lambda: k4.paged_prefill_attention_plain(*args),
                       3, warmup=1, graph=False)
    nbytes, flops = prefill_work(chunks, S, H, KH, D, 2, bs)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    active = [p for p, c in enumerate(chunks) if c]
    entries = [(q[p], dev["q_starts"][p] + torch.arange(S, device="cuda"),
                sum(chunks[p]), dev["tables"][p]) for p in active]
    lib_ms = time_sdpa(torch, "K4", pool, layer, entries, H, KH,
                       [want[p] for p in active])
    log(f"[kernels] K4 mixed batch ({card}): {ms:.4f} ms at tile "
        f"{k4.DEFAULT_TILE[D]}, {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / ms:.3f} of its {b_ms:.4f} ms bound ({b_by}); SDPA "
        f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x of it)")
    del entries, pool, got, want

    for label, s_chunks, s_S in (("4 x 512 fresh", [(0, 512)] * 4, 512),
                                 ("1 x 2048 fresh", [(0, 2048)], 2048)):
        spool, sdev = make_prefill_batch(rng, s_chunks, s_S, M, bs, 2 * KH,
                                         D, torch.bfloat16, torch,
                                         layer=layer)
        sq = torch.randn((len(s_chunks), s_S, H, D), dtype=torch.bfloat16,
                         device="cuda")
        sargs = (sq, spool, sdev["tables"], sdev["q_starts"], sdev["ctx"],
                 layer)
        swant = k4.paged_prefill_attention_plain(*sargs)
        sextra = p_allowance(k4.paged_prefill_attention_plain, sargs, torch)
        s_bytes, s_flops = prefill_work(s_chunks, s_S, H, KH, D, 2, bs)
        sb_ms, sb_by = bound(s_bytes, s_flops, BF16_FLOPS)
        times = {}
        for tile in k4.TILES[D]:
            check_close(f"K4 {label}, tile {tile}", k4.paged_prefill_attention(
                *sargs, tile=tile), swant, BF16_TOL, torch, extra=sextra)
            times[f"{tile[0]}x{tile[1]}"] = time_ms(
                torch, lambda: k4.paged_prefill_attention(*sargs, tile=tile),
                20)
        best = min(times, key=times.get)
        log(f"[kernels] K4 ms by tile (rows x positions; default "
            f"{k4.DEFAULT_TILE[D]}) on {label}: {json.dumps(times)}; best "
            f"{best} at {s_flops / times[best] / 1e9:.1f} TFLOP/s; bound "
            f"{sb_ms:.4f} ms by {sb_by} ({card})")
        del spool, sq, swant, sextra
    return {"name": "K4 paged_prefill_attention", "key": "K4",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "tflops": flops / ms / 1e9,
            "shape": f"P=4, S={S}, M={M}: fresh 512, 512 after 700, 300 of "
                     f"512, inactive; tile {k4.DEFAULT_TILE[D]}"}


# split spans swept for K2's one-token spans and for K3 (multiples of the
# split walk's stage); each kernel's own plan is timed beside them
SPAN_SWEEP = (256, 512, 1024, 2048)


def yardsticks(torch, name, pool, layer, entries, H, KH, want_rows) -> dict:
    """The library calls of a K2 or K3 shape: SDPA (padded) and varlen_attn
    (packed), both on contexts gathered beforehand."""
    lib_ms = time_sdpa(torch, name, pool, layer, entries, H, KH, want_rows)
    varlen_ms, note = time_varlen(torch, name, pool, layer, entries, H, KH,
                                  want_rows)
    if varlen_ms is None:
        log(f"[kernels] {name}: no varlen_attn yardstick: {note}")
        return {"library_ms": lib_ms, "varlen_ms": None, "varlen_note": note}
    return {"library_ms": lib_ms, "varlen_ms": varlen_ms,
            "varlen_max_abs_err": note}


def ragged_measure(torch, card, label, pool, dev, spans, q, layer, H, KH, D,
                   S, bs, T, sweep: bool = True) -> dict:
    """bf16 K2 on one stream against its plain version (tail rows exactly
    0), with ``sweep`` its row-tile sweep and, where the stream has
    one-token spans, their split-span sweep (each setting checked first),
    then its time by the default work map beside its plain version, bound
    and library calls. The work maps are made once, as the model runner
    makes one a step, so the times are the kernels' alone."""
    from production_stack_tpu_torch.ops import paged_prefill_attention as k4
    from production_stack_tpu_torch.ops import ragged_paged_attention as k2

    plain = k2.ragged_paged_attention_plain
    args = (q, pool, dev["tables"], dev["cu"], dev["ctx"], layer)
    host = (dev["cu"].cpu().numpy(), dev["ctx"].cpu().numpy())

    def wmap(**kw):
        return k2.ragged_work_map(*host, T, H, KH, D, torch.bfloat16, "cuda",
                                  **kw)

    def timed(work):
        return time_ms(torch, lambda: k2.ragged_paged_attention(
            *args, tiles=work), 10)

    work = wmap()
    got = k2.ragged_paged_attention(*args, tiles=work)
    want = plain(*args)
    extra = p_allowance(plain, args, torch)
    err = check_close(f"K2 {label}", got, want, BF16_TOL, torch, extra=extra)
    live = int(dev["cu"][-1])
    if not (got[live:] == 0).all():
        raise AssertionError(f"K2 {label}: tail padding rows are not 0")
    log(f"[kernels] K2 {label}: {live} live tokens of T={T}; work map "
        f"{work.n_tiles} row tiles of {work.tile}, {work.n_decode} one-token "
        f"spans in {work.plan[0]} splits of {work.plan[1]}")
    by_tile = {}
    for tile in k4.TILES[D] if sweep else ():
        w = wmap(tile=tile)
        check_close(f"K2 {label}, tile {tile}", k2.ragged_paged_attention(
            *args, tiles=w), want, BF16_TOL, torch, extra=extra)
        by_tile[f"{tile[0]}x{tile[1]}"] = timed(w)
    if by_tile:
        log(f"[kernels] K2 {label} ms by row tile (rows x positions; "
            f"default {work.tile}): {json.dumps(by_tile)} ({card})")
    by_span = {}
    if work.n_decode and sweep:
        for span in SPAN_SWEEP:
            w = wmap(split_span=span)
            check_close(f"K2 {label}, split span {span}",
                        k2.ragged_paged_attention(*args, tiles=w), want,
                        BF16_TOL, torch, extra=extra)
            by_span[span] = timed(w)
        log(f"[kernels] K2 {label} ms by split span of its one-token spans "
            f"(default {work.plan[1]}): {json.dumps(by_span)} ({card})")
    ms = timed(work)
    plain_ms = time_ms(torch, lambda: plain(*args), 3, warmup=1,
                       graph=False)
    nbytes, flops = ragged_work(spans, H, KH, D, 2, S, bs, T)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    cu = dev["cu"].tolist()
    entries, want_rows = [], []
    for slot, q_len, ctx in spans:
        if q_len:
            c0 = cu[slot]
            qpos = ctx - q_len + torch.arange(q_len, device="cuda")
            entries.append((q[c0:c0 + q_len], qpos, ctx, dev["tables"][slot]))
            want_rows.append(want[c0:c0 + q_len])
    lib = yardsticks(torch, f"K2 {label}", pool, layer, entries, H, KH,
                     want_rows)
    log(f"[kernels] K2 {label} ({card}): {ms:.4f} ms, "
        f"{b_ms / ms:.3f} of its {b_ms:.4f} ms bound ({b_by}); plain "
        f"{plain_ms:.3f} ms; SDPA {lib['library_ms']:.4f} ms, varlen_attn "
        f"{lib['varlen_ms']}")
    return {"name": "K2 ragged_paged_attention", "key": "K2",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, **lib,
            "ms_by_tile": by_tile, "ms_by_split_span": by_span,
            "shape": f"{label}: T={T}, S={S}, {live} live tokens, "
                     f"{work.n_decode} one-token spans"}


def ragged_prefill_only(torch, card, rng, H, KH, D, S, M, bs, T,
                        layer) -> dict:
    """K2 on a prefill-only stream of 4 fresh 512-token spans (a ragged
    prefill step's work at llama-3-8b), and K4 on the same 4 x 512 fresh
    chunks at its default tile, for the two walks side by side."""
    from production_stack_tpu_torch.ops import paged_prefill_attention as k4

    spans = [(s, 512, 512) for s in range(4)]
    pool, dev, spans = make_stream(rng, spans, T, S, M, bs, 2 * KH, D,
                                   torch.bfloat16, torch, layer=layer)
    q = torch.randn((T, H, D), dtype=torch.bfloat16, device="cuda")
    rec = ragged_measure(torch, card, "4 x 512 prefill-only", pool, dev,
                         spans, q, layer, H, KH, D, S, bs, T)
    del pool
    kpool, kdev = make_prefill_batch(rng, [(0, 512)] * 4, 512, M, bs, 2 * KH,
                                     D, torch.bfloat16, torch, layer=layer)
    kargs = (q.view(4, 512, H, D), kpool, kdev["tables"], kdev["q_starts"],
             kdev["ctx"], layer)
    rec["k4_same_work_ms"] = time_ms(
        torch, lambda: k4.paged_prefill_attention(*kargs), 20)
    log(f"[kernels] K4 on the same 4 x 512 fresh chunks: "
        f"{rec['k4_same_work_ms']:.4f} ms (K2 {rec['ms']:.4f} ms) ({card})")
    del kpool
    return rec


def ragged_verify_stream(torch, card, rng, H, KH, D, S, M, bs, T,
                         layer) -> dict:
    """K2 on the stream of a speculative decode step at llama-3-8b: 48
    verify spans of 1 + 4 tokens (the row's token and 4 drafts) and 16
    one-token spans, slots interleaved, over contexts 130-2048. Each span
    ends at its context, so the causal mask falls inside its last five
    positions; the verify spans take K2's row-tile walk (5 x G = 20 rows of
    a 128-row tile), the one-token spans its split-KV walk, in one
    launch."""
    ctxs = rng.integers(130, 2049, S)
    spans = [(s, 1 if s % 4 == 3 else 5, int(ctxs[s])) for s in range(S)]
    pool, dev, spans = make_stream(rng, spans, T, S, M, bs, 2 * KH, D,
                                   torch.bfloat16, torch, layer=layer)
    q = torch.randn((T, H, D), dtype=torch.bfloat16, device="cuda")
    rec = ragged_measure(torch, card, "verify stream, 48 x (1+4) and 16 x 1",
                         pool, dev, spans, q, layer, H, KH, D, S, bs, T)
    del pool
    return rec


def decode_measure(torch, card, label, rng, lens, H, KH, D, M, bs,
                   layer, sweep: bool = True) -> dict:
    """bf16 K3 on one query per slot with context ``lens`` (0 = an empty
    slot, which must output exactly 0) against its plain version, with
    ``sweep`` its split-span sweep (each span checked first), then its
    time by its own split plan beside its plain version, bound and library
    calls."""
    from production_stack_tpu_torch.ops import paged_decode_attention as k3

    B = len(lens)
    plain = k3.paged_decode_attention_plain
    spans = [(b, 1, c) for b, c in enumerate(lens) if c > 0]
    pool, dev, _ = make_stream(rng, spans, B, B, M, bs, 2 * KH, D,
                               torch.bfloat16, torch, layer=layer)
    q = torch.randn((B, H, D), dtype=torch.bfloat16, device="cuda")
    args = (q, pool, dev["tables"], dev["ctx"], layer)
    plan = k3.split_plan(max(lens), len(spans), KH)

    def timed(p):
        return time_ms(torch, lambda: k3.paged_decode_attention(
            *args, plan=p), 20)

    got = k3.paged_decode_attention(*args, plan=plan)
    want = plain(*args)
    extra = p_allowance(plain, args, torch)
    err = check_close(f"K3 {label}", got, want, BF16_TOL, torch, extra=extra)
    if not (got[dev["ctx"] == 0] == 0).all():
        raise AssertionError(f"K3 {label}: a slot with context 0 did not "
                             "output 0")
    by_span = {}
    for span in (SPAN_SWEEP + ((4096, 8192) if max(lens) > 4096 else ())
                 if sweep else ()):
        p = k3.split_plan(max(lens), len(spans), KH, span)
        check_close(f"K3 {label}, split span {span}",
                    k3.paged_decode_attention(*args, plan=p), want, BF16_TOL,
                    torch, extra=extra)
        by_span[span] = timed(p)
    if by_span:
        log(f"[kernels] K3 {label} ms by split span (default plan {plan}): "
            f"{json.dumps(by_span)} ({card})")
    ms = timed(plan)
    plain_ms = time_ms(torch, lambda: plain(*args), 5, warmup=1, graph=False)
    nbytes, flops = decode_work(lens, H, KH, D, 2, bs)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    entries = [(q[b:b + 1], torch.full((1,), c - 1, device="cuda"), c,
                dev["tables"][b]) for b, c in enumerate(lens) if c > 0]
    want_rows = [want[b:b + 1] for b, c in enumerate(lens) if c > 0]
    lib = yardsticks(torch, f"K3 {label}", pool, layer, entries, H, KH,
                     want_rows)
    log(f"[kernels] K3 {label} ({card}): {ms:.4f} ms, {b_ms / ms:.3f} of "
        f"its {b_ms:.4f} ms bound ({b_by}); plain {plain_ms:.3f} ms; SDPA "
        f"{lib['library_ms']:.4f} ms, varlen_attn {lib['varlen_ms']}")
    del pool
    return {"name": "K3 paged_decode_attention", "key": "K3",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, **lib,
            "ms_by_split_span": by_span,
            "shape": f"{label}: M={M}, {sum(lens)} context tokens, split "
                     f"plan {plan}"}


def kernel_phase(torch, np, card: str) -> list[dict]:
    from production_stack_tpu_torch.engine.config import ModelConfig
    from production_stack_tpu_torch.ops import kv_write as k1
    from production_stack_tpu_torch.ops import paged_decode_attention as k3
    from production_stack_tpu_torch.ops import ragged_paged_attention as k2
    from production_stack_tpu_torch.ops.paged_attention import split_kv

    cfg = ModelConfig.from_pretrained("llama-3-8b")
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T, S, bs = 2048, 64, 16
    M = (-(-cfg.max_model_len // bs) + 7) // 8 * 8  # 512, as the runner pads
    layer = 1
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    results = []

    # -- the mixed K2 stream: prefill chunks of several lengths, 1-token
    # decode rows, a single-token prefill, empty slots and tail padding
    spans = [(0, 512, 512), (3, 700, 1200), (7, 300, 300), (9, 1, 1)]
    decode_slots = [s for s in range(10, S) if s % 5]  # gaps = empty slots
    for s in decode_slots:
        spans.append((s, 1, int(rng.integers(1, 2048))))
    spans.sort()
    pool, dev, spans = make_stream(rng, spans, T, S, M, bs, 2 * KH, D,
                                   torch.bfloat16, torch, layer=layer)
    live = int(dev["cu"][-1])
    log(f"[kernels] K2 stream: {live} live tokens of T={T}, "
        f"{len(spans)} spans of S={S}, pool {tuple(pool.shape)} bf16")

    # K1: the stream's new K+V slabs into the pool (ragged step shape)
    newkv = torch.randn((T, 2 * KH, D), dtype=torch.bfloat16, device="cuda")
    ref_pool = pool.clone()
    k1.kv_write(pool, newkv, dev["slots"], layer)
    k1.kv_write_plain(ref_pool, newkv, dev["slots"], layer)
    torch.cuda.synchronize()
    if not torch.equal(pool.view(torch.int16), ref_pool.view(torch.int16)):
        raise AssertionError("K1 kv_write: pool differs from the plain write")
    keep = dev["slots"] >= 0
    idx = dev["slots"][keep].long()
    src = newkv[keep]
    flat = ref_pool[layer].view(-1, 2 * KH, D)
    ms = time_ms(torch, lambda: k1.kv_write(pool, newkv, dev["slots"], layer),
                 200)
    plain_ms = time_ms(torch, lambda: k1.kv_write_plain(
        ref_pool, newkv, dev["slots"], layer), 20, graph=False)
    lib_ms = time_ms(torch, lambda: flat.index_copy_(0, idx, src), 200)
    eager = time_ms(torch, lambda: k1.kv_write(pool, newkv, dev["slots"],
                                               layer), 200, graph=False)
    per_call = call_ms(torch, lambda: k1.kv_write(pool, newkv, dev["slots"],
                                                  layer), 50)
    lib_call = call_ms(torch, lambda: flat.index_copy_(0, idx, src), 50)
    slab = 2 * KH * D * 2
    b_ms, b_by = bound(2 * live * slab + T * 4, 0, BF16_FLOPS)
    log(f"[kernels] K1 kv_write at T={T} ({card}): device {ms:.5f} ms, "
        f"{b_ms / ms:.3f} of its {b_ms:.5f} ms bound; index_copy_ device "
        f"{lib_ms:.5f} ms; issued from Python back to back (paced by the "
        f"host): K1 {eager:.4f} ms a call; one call with its synchronise "
        f"(host wrapper included): K1 {per_call:.4f} ms, index_copy_ "
        f"{lib_call:.4f} ms")
    results.append({"name": "K1 kv_write", "key": "K1", "max_abs_err": 0.0,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms,
                    "shape": f"T={T}, {live} live slots"})
    del ref_pool
    # K1 at the decode-step shape (T = S = 64), reported on its own line
    dnew = newkv[:S].contiguous()
    dslots = torch.as_tensor(
        np.where(np.arange(S) % 5 == 0, -1,
                 rng.permutation(pool.shape[1] * bs)[:S]).astype(np.int32),
        device="cuda")
    d_ms = time_ms(torch, lambda: k1.kv_write(pool, dnew, dslots, layer), 200)
    d_plain = time_ms(torch, lambda: k1.kv_write_plain(pool, dnew, dslots,
                                                       layer), 20, graph=False)
    d_keep = dslots >= 0
    d_idx, d_src = dslots[d_keep].long(), dnew[d_keep]
    dflat = pool[layer].view(-1, 2 * KH, D)
    d_lib = time_ms(torch, lambda: dflat.index_copy_(0, d_idx, d_src), 200)
    d_call = call_ms(torch, lambda: k1.kv_write(pool, dnew, dslots, layer),
                     50)
    d_b, _ = bound(2 * int(d_keep.sum()) * 2 * KH * D * 2 + S * 4, 0,
                   BF16_FLOPS)
    log(f"[kernels] K1 kv_write at the decode shape T={S}: device "
        f"{d_ms:.5f} ms (bound {d_b:.5f} ms, bytes), plain {d_plain:.4f} "
        f"ms, index_copy_ {d_lib:.5f} ms; one call with its synchronise "
        f"{d_call:.4f} ms ({card})")

    # K2 on the mixed stream, whose span tokens K1 just wrote; then on a
    # prefill-only stream beside K4 on the same work
    q = torch.randn((T, H, D), dtype=torch.bfloat16, device="cuda")
    k2_mixed = ragged_measure(torch, card, "mixed stream", pool, dev, spans,
                              q, layer, H, KH, D, S, bs, T)
    del pool, q
    k2_mixed["also"] = [ragged_prefill_only(torch, card, rng, H, KH, D, S,
                                            M, bs, T, layer),
                        ragged_verify_stream(torch, card, rng, H, KH, D, S,
                                             M, bs, T, layer)]
    results.append(k2_mixed)

    # K3: one query per slot, contexts up to 2k, empty slots at ctx 0; then
    # long contexts at small batch
    lens = [0 if b % 9 == 0 else int(rng.integers(1, 2049))
            for b in range(S)]
    k3_batch = decode_measure(torch, card, f"B={S}", rng, lens, H, KH, D, M,
                              bs, layer)
    k3_batch["also"] = [decode_measure(torch, card, "B=4, ctx 8192", rng,
                                       [8192, 8192, 8000, 8192], H, KH, D,
                                       M, bs, layer)]
    results.append(k3_batch)
    results.append(prefill_kernel_phase(torch, np, card, rng, cfg, M))

    # float32 at D = 32 (tiny-llama geometry: H=4, KH=2)
    tH, tKH, tD, tT, tS, tM = 4, 2, 32, 256, 8, 32
    t_spans = [(0, 40, 100), (1, 1, 17), (3, 1, 1), (4, 90, 90), (6, 1, 200)]
    tpool, tdev, t_spans = make_stream(rng, t_spans, tT, tS, tM, bs,
                                       2 * tKH, tD, torch.float32, torch,
                                       layer=0)
    tnew = torch.randn((tT, 2 * tKH, tD), device="cuda")
    tref = tpool.clone()
    k1.kv_write(tpool, tnew, tdev["slots"], 0)
    k1.kv_write_plain(tref, tnew, tdev["slots"], 0)
    if not torch.equal(tpool.view(torch.int32), tref.view(torch.int32)):
        raise AssertionError("K1 kv_write (f32): pool differs")
    tq = torch.randn((tT, tH, tD), device="cuda")
    targs = (tq, tpool, tdev["tables"], tdev["cu"], tdev["ctx"], 0)
    e2 = check_close("K2 (f32, D=32)", k2.ragged_paged_attention(*targs),
                     k2.ragged_paged_attention_plain(*targs), F32_TOL, torch)
    e2c = check_close(
        "K2 (f32, D=32, soft_cap)",
        k2.ragged_paged_attention(*targs, soft_cap=5.0),
        k2.ragged_paged_attention_plain(*targs, soft_cap=5.0), F32_TOL, torch)
    dq32 = torch.randn((tS, tH, tD), device="cuda")
    dctx = tdev["ctx"].clone()
    d32 = (dq32, tpool, tdev["tables"], dctx, 0)
    e3 = check_close("K3 (f32, D=32)", k3.paged_decode_attention(*d32),
                     k3.paged_decode_attention_plain(*d32), F32_TOL, torch)
    e4 = prefill_check(torch, rng, "K4 (f32, D=32)", tH, tKH, tD,
                       torch.float32)
    log(f"[kernels] float32 D=32: K1 bit-identical, K2 max err {e2:.2e} "
        f"(soft_cap {e2c:.2e}), K3 max err {e3:.2e}, K4 max err {e4:.2e} "
        f"(atol, rtol = {F32_TOL})")
    del tpool, tref
    head_dim_phase(torch, rng)
    # the split of the fused slab the kernels assume: K at [0, KH), V after
    k_, v_ = split_kv(torch.arange(4 * 3, device="cuda").view(1, 4, 3))
    if k_.flatten().tolist() != list(range(6)):
        raise AssertionError("fused slab order is not [K, V]")
    for r in results:
        log(f"[kernels] {r['name']} ({r['shape']}): {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, max abs err "
            f"{r['max_abs_err']:.3e} ({card})")
    torch.cuda.empty_cache()
    return results


# -- phase 4: the slice through the HTTP server --------------------------------

def _request(url: str, body: dict, stream: bool):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status = r.status
        if not stream:
            out = json.loads(r.read())
            return status, out["usage"]["completion_tokens"], \
                time.perf_counter() - t0
        n_out, done = None, False
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                done = True
                break
            ev = json.loads(data)
            if ev.get("usage"):
                n_out = ev["usage"]["completion_tokens"]
        if not done:
            raise AssertionError("stream ended without data: [DONE]")
        return status, n_out, time.perf_counter() - t0


def _slice_wave(np, base: str, model: str, counters):
    """The 16 requests of a slice (two waves, prompts of 64-1024 tokens, 32
    out, half greedy, some streamed, some chat) against the server at
    ``base``, with every kernel counter set to 0 just before. Returns
    (per request (status, tokens, seconds), wall seconds, launches)."""
    rng = np.random.default_rng(1)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
    jobs = []
    for i in range(16):
        n = int(rng.integers(64, 1025))
        greedy = i % 2 == 0
        samp = ({"temperature": 0.0} if greedy
                else {"temperature": 0.8, "top_p": 0.95, "seed": i})
        body = {"model": model, "max_tokens": 32, "ignore_eos": True, **samp}
        stream = i % 4 in (1, 2)
        if stream:
            body["stream"] = True
            body["stream_options"] = {"include_usage": True}
        if i % 3 == 0:  # chat: text of n - 40 chars plus the template
            text = bytes(rng.choice(letters, n - 40)).decode()
            body["messages"] = [{"role": "user", "content": text}]
            path = "/v1/chat/completions"
        else:  # completions: n byte tokens
            body["prompt"] = rng.integers(0, 256, n).tolist()
            path = "/v1/completions"
        jobs.append((i * 0.05 if i < 8 else 1.0 + i * 0.05, path, body,
                     stream))
    for c in counters:
        c.n = 0
    t0 = time.perf_counter()

    def run(job):
        delay, path, body, stream = job
        time.sleep(delay)
        return _request(base + path, body, stream)

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        results = list(pool.map(run, jobs))
    wall = time.perf_counter() - t0
    return results, wall, {c.name.split()[0]: c.n for c in counters}


def slice_phase(torch, np, counters, card: str, impl: str,
                expected: set) -> dict:
    """The 16 requests through the port's HTTP server on llama-3-8b with
    ``--attention-impl impl``; the kernels in ``expected`` must launch in
    this phase and the others not. Releases the engine and its pool before
    it returns the phase's launch counts."""
    from production_stack_tpu_torch.engine.server import (
        EngineServer,
        build_parser,
        config_from_args,
    )

    cfg = config_from_args(build_parser().parse_args(
        ["--model", "llama-3-8b", "--seed", "0", "--attention-impl", impl]))
    t0 = time.perf_counter()
    server = EngineServer(cfg, device="cuda")
    port = server.start("127.0.0.1", 0)
    eng = server.engine
    if eng.attention_impl != impl:
        raise AssertionError(f"[slice] asked for {impl}, the engine runs "
                             f"{eng.attention_impl}")
    log(f"[slice] {impl}: llama-3-8b up in {time.perf_counter() - t0:.1f} "
        f"s: {eng.runner.num_blocks} KV blocks, T="
        f"{cfg.scheduler.max_num_batched_tokens}, S="
        f"{cfg.scheduler.max_num_seqs}, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    results, wall, launches = _slice_wave(
        np, f"http://127.0.0.1:{port}", cfg.model.name, counters)
    stamps = list(server.async_engine.finished)
    stats = eng.stats()
    server.shutdown()
    for status, n_out, _ in results:
        if status != 200 or n_out != 32:
            raise AssertionError(f"[slice] bad response: status {status}, "
                                 f"{n_out} tokens")
    for key, n in launches.items():
        if (n > 0) != (key in expected):
            raise AssertionError(
                f"[slice] {impl}: kernel {key} launched {n} times; this "
                f"path must launch {sorted(expected)} and no other")
    ttft = [ft - arr for arr, ft, _, _ in stamps]
    out_tok = sum(r[1] for r in results)
    summary = {
        "requests": len(results), "output_tokens": out_tok,
        "wall_s": wall, "output_tok_per_s": out_tok / wall,
        "ttft_median_s": statistics.median(ttft),
        "e2e_median_s": statistics.median(r[2] for r in results),
        "ragged_steps": stats["ragged_dispatches_total"],
        "prefill_steps": stats["prefill_dispatches_total"],
        "prefill_bucket_utilization": stats["prefill_bucket_utilization"],
        "decode_steps": stats["decode_dispatches_total"],
        "launches": launches,
    }
    log(f"[slice] {impl} ({card}): {json.dumps(summary)}")
    if impl == "ragged":
        profile_phase(torch, np, eng, card)
    else:
        profile_bucketed(torch, np, eng, card)
    # the next engine sizes its pool to 0.9 of the free memory
    del server, eng
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"[slice] {impl} engine released: {left:.2f} GiB still allocated")
    if left > 1.0:
        raise AssertionError(f"[slice] {impl}: the engine's memory was not "
                             "released")
    return launches


def _category(name: str) -> str:
    # K2's kernels all start ragged_ (ragged_decode_kernel before K3's
    # decode_); K3's start decode_, K4's prefill_mma or prefill_walk
    for key, cat in (("kv_write_kernel", "K1"), ("ragged_", "K2"),
                     ("decode_", "K3"), ("prefill_mma_kernel", "K4"),
                     ("prefill_walk_kernel", "K4"),
                     ("Memcpy", "copy"), ("Memset", "copy")):
        if key in name:
            return cat
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "nvjet", "xmma", "cublas")):
        return "matmul"
    return "other"


# the port's int8 and MoE profiler ranges (``quant.profile_range``), by
# the device-time class each stands for
MOE_RANGES = {"quant.int8_gemm": "int8 GEMM",
              "quant.activations": "activation quantization",
              "quant.dequantize": "W8A16 dequantization",
              "moe.dispatch": "MoE dispatch and combine",
              "moe.combine": "MoE dispatch and combine"}


def _profiled(torch, run, ranges=None):
    """``run()`` under torch.profiler, tracing the card only. Returns
    (wall ms, device busy ms, {category: device ms}, device events,
    {kernel: wrapper calls}); busy is the union of the kernel and copy
    intervals, None when the trace holds none. A wrapper call of K2 or K3
    may launch two or three kernels. With ``ranges`` (``MOE_RANGES``) the
    host is traced too, the port's profiler ranges are on, and a kernel
    that a range's span on the card's timeline holds takes the range's
    class instead of its name's; the GEMMs left are the model dtype's
    ("bf16 GEMM"). A range's own span is not a kernel."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from production_stack_tpu_torch.engine import quant
    from production_stack_tpu_torch.ops import kv_write as k1
    from production_stack_tpu_torch.ops import paged_decode_attention as k3
    from production_stack_tpu_torch.ops import paged_prefill_attention as k4
    from production_stack_tpu_torch.ops import ragged_paged_attention as k2

    counters = {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES, "K3": k3.LAUNCHES,
                "K4": k4.LAUNCHES}
    before = {k: c.n for k, c in counters.items()}
    activities = [ProfilerActivity.CUDA]
    if ranges:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    quant.PROFILE_RANGES = bool(ranges)
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        quant.PROFILE_RANGES = False
    calls = {k: c.n - before[k] for k, c in counters.items()}
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            iv = (e.time_range.start, e.time_range.end)
            if ranges and e.name in ranges:
                spans.append((*iv, ranges[e.name]))
            else:
                kernels.append((*iv, e.name))
    spans.sort()
    starts = [sp[0] for sp in spans]
    cats = collections.Counter()
    for a, b, name in kernels:
        i = bisect.bisect_right(starts, a) - 1
        cls = (spans[i][2] if i >= 0 and b <= spans[i][1]
               else _category(name))
        if ranges and cls == "matmul":
            cls = "bf16 GEMM"
        cats[cls] += (b - a) / 1e3
    busy, end = 0.0, float("-inf")
    for a, b, _ in sorted(kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, (busy / 1e3 if kernels else None), cats, len(kernels), calls


def _add_requests(eng, rng, tag, n, length, max_tokens) -> None:
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens,
                        ignore_eos=True)
    for i in range(n):
        eng.add_request(f"{tag}{i}", sampling=sp, prompt_token_ids=(
            rng.integers(0, 256, length).tolist()))


def _report(card, label, n, wall, busy, cats, kernels, calls) -> None:
    rec = {"steps": n, "wall_ms_per_step": wall / n}
    if busy is None:
        rec["device"] = "not measured (the trace held no device events)"
    else:
        rec.update({
            "device_kernels_per_step": kernels / n,
            "device_busy_ms_per_step": busy / n,
            "device_idle_share": 1.0 - busy / wall,
            "device_ms_per_step": {c: v / n for c, v in
                                   sorted(cats.items())},
            # a hand kernel's device time per wrapper call inside the
            # step, its inputs as the step leaves them in the caches
            "device_us_per_launch": {c: cats[c] * 1e3 / calls[c]
                                     for c in ("K1", "K2", "K3", "K4")
                                     if calls[c]}})
    log(f"[profile] {label} ({card}): {json.dumps(rec)}")


def _prefill_window(torch, eng, rng, counter: str):
    """Two full prefill steps of 4 prompts of 512 tokens each (one
    dispatch each, then the step that resolves it), traced; ``counter``
    is the engine's count of such dispatches."""
    def prefill_twice():
        for tag in ("pa", "pb"):
            _add_requests(eng, rng, tag, 4, 512, 1)
            while eng.has_unfinished():
                eng.step()

    n0 = getattr(eng, counter)
    prof = _profiled(torch, prefill_twice)
    if getattr(eng, counter) - n0 != 2:
        raise AssertionError("[profile] the prefill window is not 2 steps")
    return prof


def profile_bucketed(torch, np, eng, card: str) -> None:
    """Where a bucketed prefill step's time goes, on the llama-3-8b engine
    that just served: two full steps of P = 4 chunks in the 512 bucket."""
    prof = _prefill_window(torch, eng, np.random.default_rng(3),
                           "prefill_dispatches")
    _report(card, "bucketed, 4 x 512 prefill tokens", 2, *prof)


def profile_phase(torch, np, eng, card: str) -> None:
    """Where an engine step's time goes, on the llama-3-8b engine that just
    served (its HTTP front end stopped): a window of two full prefill
    ragged steps (4 prompts of 512 tokens each) and a window of 16
    decode-only steps at 64 rows (contexts of about 130-170 tokens), each
    traced, and the next 16 decode steps timed untraced."""
    rng = np.random.default_rng(3)

    def steps(k):
        for _ in range(k):
            eng.step()

    prof = _prefill_window(torch, eng, rng, "ragged_dispatches")
    _report(card, "ragged, 2048 prefill tokens", 2, *prof)

    _add_requests(eng, rng, "dc", 64, 128, 48)
    d0 = eng.decode_dispatches
    while eng.decode_dispatches == d0:  # prefill all 64, then one decode
        eng.step()
    prof = _profiled(torch, lambda: steps(16))
    if eng.decode_dispatches - d0 != 17:
        raise AssertionError("[profile] the decode window ran ragged steps")
    _report(card, "decode, 64 rows", 16, *prof)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(16)
    torch.cuda.synchronize()
    log(f"[profile] decode, 64 rows, untraced ({card}): "
        f"{(time.perf_counter() - t0) * 1e3 / 16:.3f} ms a step")
    for rid in list(eng.scheduler.seqs):
        eng.abort_request(rid)


# -- phase 5: the kernel path against the plain path --------------------------

def _greedy_tokens(eng, prompts, sp, adapters=None):
    """Serve ``prompts`` to the end, each with its SamplingParams (``sp``,
    or one for all) and adapter slot; each request's tokens and, per token
    where it asked for logprobs, (its logprob, the top-2 gap)."""
    sps = sp if isinstance(sp, list) else [sp] * len(prompts)
    toks = {i: [] for i in range(len(prompts))}
    lps = {i: [] for i in range(len(prompts))}
    for i, pr in enumerate(prompts):
        eng.add_request(str(i), prompt_token_ids=pr, sampling=sps[i],
                        adapter_slot=adapters[i] if adapters else 0)
    while eng.has_unfinished():
        for o in eng.step():
            toks[int(o.request_id)].extend(o.new_token_ids)
            for lp, top in o.new_logprobs or ():
                lps[int(o.request_id)].append((lp, top[0][1] - top[1][1]))
    return toks, lps


def _compare_greedy(tag, ref, other, tie_gap):
    """Compare two runs' greedy tokens request by request, stopping at a
    flip whose top-2 gap in ``ref`` is under ``tie_gap`` (logged) and
    failing at any other. Returns (tokens compared, the largest logprob
    difference over them, where ``other`` has logprobs)."""
    (ref_t, ref_l), (oth_t, oth_l) = ref, other
    compared, worst = 0, 0.0
    for i in ref_t:
        for j, (a, b) in enumerate(zip(ref_t[i], oth_t[i])):
            if a != b:
                if ref_l[i][j][1] >= tie_gap:
                    raise AssertionError(
                        f"[parity] {tag}: request {i} step {j}: {b} != {a} "
                        f"(top-2 gap {ref_l[i][j][1]:.2e})")
                log(f"[parity] {tag}: near-tie at request {i} step {j}: "
                    f"top-2 gap {ref_l[i][j][1]:.2e}; compared up to it")
                break
            if oth_l[i]:
                worst = max(worst, abs(ref_l[i][j][0] - oth_l[i][j][0]))
            compared += 1
        else:
            if len(ref_t[i]) != len(oth_t[i]):
                raise AssertionError(f"[parity] {tag}: request {i}: lengths "
                                     "differ")
    return compared, worst


def _parity_engine(impl: str, dtype: str, **sched):
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )

    return EngineConfig.for_model(
        "tiny-llama", dtype=dtype,
        cache=CacheConfig(block_size=16, num_blocks=256),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=64,
                                  **sched),
        attention_impl=impl)


PARITY_LENGTHS = (5, 17, 150, 33, 64, 2, 90)


def parity_phase(torch, np, impl: str) -> None:
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import (
        init_random,
        to_device,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _parity_engine(impl, "float32")
    params = init_random(cfg.model, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 259, n).tolist() for n in PARITY_LENGTHS]
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True,
                        logprobs=2)
    runs = {}
    for device in ("cpu", "cuda"):
        runs[device] = _greedy_tokens(LLMEngine(
            cfg, params=to_device(params, device), device=device), prompts, sp)
    compared, _ = _compare_greedy(f"{impl}, card against cpu", runs["cpu"],
                                  runs["cuda"], TIE_GAP)
    log(f"[parity] tiny-llama float32, {impl}: {compared} greedy tokens "
        f"identical between the kernel path (card) and the plain path (cpu)")


def bf16_phase(torch, np, impl: str) -> None:
    """bf16 tiny-llama on path ``impl``, served twice on the card in this
    process with the same weights and prompts: through the tensor-core
    kernels (K2 and K3 on the ragged path, K4 on the bucketed one), then
    with their plain versions in the model runner's place of the wrappers,
    put there by this script for that run only. The kernels must launch in
    the first run and not in the second. The plain versions synchronise
    with the host, which a CUDA graph cannot capture, so the second run
    decodes eagerly (``decode_graphs`` off)."""
    from production_stack_tpu_torch.engine import model_runner
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.ops import paged_decode_attention as k3
    from production_stack_tpu_torch.ops import paged_prefill_attention as k4
    from production_stack_tpu_torch.ops import ragged_paged_attention as k2

    # the runner's name of each wrapper: its counter and plain version,
    # which takes no work map or split plan
    swapped = {
        "ragged": {
            "ragged_paged_attention": (k2.LAUNCHES, lambda *a, tiles=None,
                                       **kw: k2.ragged_paged_attention_plain(
                                           *a, **kw)),
            "paged_decode_attention": (k3.LAUNCHES, lambda *a, plan=None,
                                       **kw: k3.paged_decode_attention_plain(
                                           *a, **kw))},
        "bucketed": {
            "paged_prefill_attention": (k4.LAUNCHES,
                                        k4.paged_prefill_attention_plain)},
    }[impl]
    cfg = _parity_engine(impl, "bfloat16")
    params = init_random(cfg.model, seed=0, device="cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 259, n).tolist() for n in PARITY_LENGTHS]
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True,
                        logprobs=2)
    wrappers = {n: getattr(model_runner, n) for n in swapped}
    runs, launches = {}, {}
    for run in ("kernels", "plain"):
        for counter, _ in swapped.values():
            counter.n = 0
        run_cfg = cfg
        if run == "plain":
            for n, (_, plain) in swapped.items():
                setattr(model_runner, n, plain)
            run_cfg = dataclasses.replace(cfg, scheduler=dataclasses.replace(
                cfg.scheduler, decode_graphs=False))
        try:
            runs[run] = _greedy_tokens(
                LLMEngine(run_cfg, params=params, device="cuda"), prompts,
                sp)
        finally:
            for n, w in wrappers.items():
                setattr(model_runner, n, w)
        launches[run] = {c.name.split()[0]: c.n for c, _ in swapped.values()}
    if (not all(launches["kernels"].values())
            or any(launches["plain"].values())):
        raise AssertionError(f"[parity] bf16 {impl}: launches {launches}; "
                             "expected some through each kernel and none "
                             "through the plain versions")
    compared, worst = _compare_greedy(f"bf16 {impl}, kernels against plain",
                                      runs["plain"], runs["kernels"],
                                      BF16_LOGPROB_BAND)
    if worst > BF16_LOGPROB_BAND:
        raise AssertionError(
            f"[parity] bf16 {impl}: logprobs differ by {worst:.3e}, past "
            f"the band {BF16_LOGPROB_BAND}")
    log(f"[parity] tiny-llama bf16, {impl}: {compared} greedy tokens "
        f"identical through the kernels and through their plain versions "
        f"(launches {launches['kernels']}); largest logprob difference "
        f"{worst:.3e} (band {BF16_LOGPROB_BAND})")


# -- phases 5 and 6: guided decoding, multi-LoRA, n-gram speculation ----------

LORA_NAMES = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
              "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
              "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
              "w_down": "mlp.down_proj"}
# a finite JSON language: every output reaches the closing brace
JSON_SCHEMA = {"type": "object", "properties": {
    "sentiment": {"enum": ["pos", "neg"]}, "ok": {"type": "boolean"}}}
REGEXES = (r"(yes|no)( indeed)?", r"[0-9]{3}-[0-9]{4}")


def write_adapter(np, cfg, root: str, rank: int = 16, seed: int = 0) -> str:
    """A random rank-``rank`` PEFT adapter on all seven targets of every
    layer of ``cfg`` (float16, alpha = 2 rank), written with the port's
    own safetensors writer: the card's machine has no ``safetensors``."""
    import os

    from production_stack_tpu_torch.engine.lora import (
        target_shapes,
        write_safetensors,
    )

    rng = np.random.default_rng(seed)
    tensors = {}
    for layer in range(cfg.num_layers):
        for key, (n_in, out) in target_shapes(cfg).items():
            n_out = int(np.prod(out))
            base = f"base_model.model.model.layers.{layer}.{LORA_NAMES[key]}"
            tensors[f"{base}.lora_A.weight"] = (rng.standard_normal(
                (rank, n_in), np.float32) / np.sqrt(n_in)).astype(np.float16)
            tensors[f"{base}.lora_B.weight"] = (rng.standard_normal(
                (n_out, rank), np.float32) * 0.02).astype(np.float16)
    write_safetensors(os.path.join(root, "adapter_model.safetensors"),
                      tensors)
    with open(os.path.join(root, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": 2 * rank}, f)
    return root


def features_parity_phase(torch, np) -> None:
    """tiny-llama float32 on the ragged path with n-gram speculation (k =
    4), a LoRA adapter and grammars, on the card and on the CPU with the
    same weights and requests: greedy tokens equal up to printed near-ties
    (the CPU's top-2 gap under TIE_GAP). Speculating rows carry no
    logprobs, so the gaps come from a CPU run with speculation off and
    logprobs on every row; that run's tokens must equal the CPU's with
    speculation on, up to its own near-ties."""
    import tempfile

    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.lora import LoraManager
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import (
        init_random,
        to_device,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    on = _parity_engine("ragged", "float32", spec_ngram_k=4, multi_step=2)
    off = _parity_engine("ragged", "float32", multi_step=2)
    params = init_random(on.model, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 259, n).tolist() for n in PARITY_LENGTHS]
    # every byte once: any byte the model emits recurs in the history, so
    # the proposer drafts every step (on the base model and the adapter)
    prompts += [rng.permutation(256).tolist() for _ in range(2)]
    greedy = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    lp = dataclasses.replace(greedy, logprobs=2)
    guided = [SamplingParams(temperature=0.0, max_tokens=24, logprobs=2,
                             guided_regex=REGEXES[0]),
              SamplingParams(temperature=0.0, max_tokens=64, logprobs=2,
                             guided_json=JSON_SCHEMA)]
    # rows: plain with logprobs, adapter (speculating), two guided (one on
    # the adapter), plain speculating, and the byte permutations
    sps = [lp, greedy, guided[0], guided[1], greedy, lp, greedy, greedy,
           greedy]
    adapters = [0, 1, 0, 1, 0, 1, 0, 0, 1]
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        write_adapter(np, on.model, root, rank=8, seed=1)
        for tag, cfg, device, plan in (
                ("cpu, spec off", off, "cpu", [lp if s is greedy else s
                                               for s in sps]),
                ("cpu, spec on", on, "cpu", sps), ("card", on, "cuda", sps)):
            eng = LLMEngine(cfg, params=to_device(params, device),
                            device=device)
            LoraManager(eng).load("smoke", root)
            runs[tag] = _greedy_tokens(eng, prompts, plan, adapters)
            runs[tag + " drafted"] = (eng.spec_drafted, eng.spec_accepted)
    if runs["card drafted"][0] == 0:
        raise AssertionError("[parity] features: the card run drafted none")
    ref_t, ref_l = runs["cpu, spec off"]
    n_cpu, _ = _compare_greedy("features, cpu spec on against off",
                               (ref_t, ref_l), runs["cpu, spec on"], TIE_GAP)
    compared, worst = _compare_greedy(
        "features, card against cpu", (runs["cpu, spec on"][0], ref_l),
        runs["card"], TIE_GAP)
    log(f"[parity] tiny-llama float32, ragged, spec k=4 + LoRA + grammars: "
        f"{compared} greedy tokens identical between the kernel path (card) "
        f"and the plain path (cpu) ({n_cpu} cpu spec on = off); drafted, "
        f"accepted: card {runs['card drafted']}, cpu "
        f"{runs['cpu, spec on drafted']}; largest logprob difference "
        f"{worst:.3e} on the logprob rows")


def spec_bf16_phase(torch, np) -> None:
    """bf16 tiny-llama on the card, ragged path, speculation on against
    off on motif-loop and random prompts: greedy tokens equal up to
    near-ties within BF16_LOGPROB_BAND of the off run (a verifying row's
    attention runs K2's row-tile walk, a decoding row's K3's split-KV walk:
    two float32 summation orders)."""
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random

    cfg = _parity_engine("ragged", "bfloat16")
    params = init_random(cfg.model, seed=0, device="cuda")
    rng = np.random.default_rng(6)
    prompts = [(rng.integers(0, 256, 4).tolist() * 6) for _ in range(4)]
    prompts += [rng.integers(0, 259, n).tolist() for n in PARITY_LENGTHS[:4]]
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
    off = _greedy_tokens(LLMEngine(cfg, params=params, device="cuda"),
                         prompts, dataclasses.replace(sp, logprobs=2))
    spec = LLMEngine(_parity_engine("ragged", "bfloat16", spec_ngram_k=4),
                     params=params, device="cuda")
    on = _greedy_tokens(spec, prompts, sp)
    if spec.spec_drafted == 0:
        raise AssertionError("[parity] bf16 spec: nothing was drafted")
    compared, _ = _compare_greedy("bf16 ragged, spec on against off", off,
                                  on, BF16_LOGPROB_BAND)
    log(f"[parity] tiny-llama bf16, ragged: {compared} greedy tokens "
        f"identical with speculation on and off (drafted "
        f"{spec.spec_drafted}, accepted {spec.spec_accepted}; flips only "
        f"within the band {BF16_LOGPROB_BAND})")


def _post(base: str, path: str, body=None):
    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read()), time.perf_counter() - t0


def _serve_features(torch, np, counters, card, impl, adapter, spec_k):
    """llama-3-8b through the port's HTTP server on path ``impl`` (with
    ``--speculative-ngram spec_k``): load ``adapter`` over HTTP, then one
    wave of requests mixing base, the adapter, guided regex and guided
    JSON (and, with speculation, motif-loop prompts), launch counts reset
    just before the wave and read just after it. Every response must be
    200; unguided ones have the asked-for token count, guided ones match
    their pattern or schema. Returns (server, launches, summary); the HTTP
    front end is stopped, the engine kept for the caller."""
    import re

    from production_stack_tpu_torch.engine.server import (
        EngineServer,
        build_parser,
        config_from_args,
    )

    argv = ["--model", "llama-3-8b", "--seed", "0", "--attention-impl", impl]
    if spec_k:
        argv += ["--speculative-ngram", str(spec_k)]
    cfg = _cut_depth(config_from_args(build_parser().parse_args(argv)))
    server = EngineServer(cfg, device="cuda")
    base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    status, out, _ = _post(base, "/v1/load_lora_adapter",
                           {"lora_name": "smoke-adapter",
                            "lora_path": adapter})
    _, models, _ = _post(base, "/v1/models")
    if status != 200 or "smoke-adapter" not in [m["id"] for m in
                                                models["data"]]:
        raise AssertionError(f"[features] {impl}: adapter not loaded: {out}")
    rng = np.random.default_rng(7)
    jobs = []  # (delay, path, body, max_tokens or None if guided, check)
    for i in range(8):  # base and adapter rows, half of them sampled
        samp = ({"temperature": 0.0} if i % 2 == 0
                else {"temperature": 0.8, "top_p": 0.95, "seed": i})
        body = {"model": "smoke-adapter" if i >= 4 else "llama-3-8b",
                "max_tokens": 32, "ignore_eos": True, **samp,
                "prompt": rng.integers(0, 256, int(rng.integers(64, 513)))
                .tolist()}
        jobs.append((0.05 * i, "/v1/completions", body, 32, None))
    for i, pattern in enumerate(REGEXES * 2):
        jobs.append((0.02 * i, "/v1/completions", {
            "model": "smoke-adapter" if i % 2 else "llama-3-8b",
            "prompt": "answer: ", "max_tokens": 32,
            "temperature": 0.0 if i < 2 else 0.7, "seed": i,
            "guided_regex": pattern}, None,
            lambda text, p=pattern: re.fullmatch(p, text)))
    for i in range(2):
        jobs.append((0.03 * i, "/v1/completions", {
            "model": "smoke-adapter" if i else "llama-3-8b",
            "prompt": "json: ", "max_tokens": 96, "temperature": 0.5 * i,
            "seed": i, "guided_json": JSON_SCHEMA}, None,
            lambda text: json.loads(text)["sentiment"] in ("pos", "neg")))
    if spec_k:
        for i in range(4):  # motif loops for the n-gram proposer
            motif = rng.integers(0, 256, 8).tolist()
            jobs.append((0.01 * i, "/v1/completions", {
                "prompt": motif * 8, "max_tokens": 64, "temperature": 0.0,
                "ignore_eos": True}, 64, None))
    for c in counters:
        c.n = 0
    t0 = time.perf_counter()

    def run(job):
        time.sleep(job[0])
        return _post(base, job[1], job[2])

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        results = list(ex.map(run, jobs))
    wall = time.perf_counter() - t0
    launches = {c.name.split()[0]: c.n for c in counters}
    server.shutdown()
    out_tok = 0
    for (_, _, body, want, check), (status, out, _) in zip(jobs, results):
        n = out["usage"]["completion_tokens"]
        text = out["choices"][0]["text"]
        out_tok += n
        if status != 200 or (want is not None and n != want):
            raise AssertionError(f"[features] {impl}: status {status}, {n} "
                                 f"tokens for {want}")
        if check is not None and not check(text):
            raise AssertionError(f"[features] {impl}: guided output "
                                 f"{text!r} does not match")
    summary = {"requests": len(jobs), "output_tokens": out_tok,
               "wall_s": wall, "output_tok_per_s": out_tok / wall,
               "launches": launches}
    return server, launches, summary


def _released(torch, tag: str) -> None:
    """After the caller dropped its engine: its memory must be free."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"[features] {tag} engine released: {left:.2f} GiB still allocated")
    if left > 1.0:
        raise AssertionError(f"[features] {tag}: the engine's memory was not "
                             "released")


def _motif_window(torch, np, eng, seed: int, spec_on: bool) -> dict:
    """16 greedy motif-loop requests (8 random bytes x 8, 64 new tokens
    each) served to the end by the engine directly, speculation on or off;
    the same ``seed`` gives the same requests."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    eng.scheduler.spec_grant_fn = eng._spec_grant_fn if spec_on else None
    rng = np.random.default_rng(seed)
    sp = SamplingParams(temperature=0.0, max_tokens=64, ignore_eos=True)
    d0, a0 = eng.spec_drafted, eng.spec_accepted
    s0, t0_ = eng.spec_steps, eng.spec_step_tokens
    for i in range(16):
        eng.add_request(f"m{seed}-{spec_on}-{i}", sampling=sp,
                        prompt_token_ids=rng.integers(0, 256, 8).tolist() * 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps, finished_at = 0, []
    while eng.has_unfinished():
        finished_at += [steps + 1 for o in eng.step() if o.finished]
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drafted, steps_v = eng.spec_drafted - d0, eng.spec_steps - s0
    return {"output_tok_per_s": 16 * 64 / wall, "engine_steps": steps,
            # a request's end is its own; the batch's is its slowest row's
            "finish_step_median": statistics.median(finished_at),
            "wall_ms_per_step": wall * 1e3 / steps,
            "acceptance_rate": ((eng.spec_accepted - a0) / drafted
                                if drafted else 0.0),
            "tokens_per_spec_step": ((eng.spec_step_tokens - t0_) / steps_v
                                     if steps_v else 0.0)}


def _feature_profiles(torch, np, eng, card, slot: int) -> None:
    """Steps at 64 rows (contexts ~130-170) traced four ways, in turns
    (each way twice, the second pass in reverse order, since the host's
    pace drifts): decode steps of base rows, of rows on the adapter and of
    guided rows, whose cost a step over base's is the adapter's and the
    grammar mask's; and steps of greedy motif-loop rows with speculation
    on, which run as ragged verify steps."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    rng = np.random.default_rng(8)
    base = SamplingParams(temperature=0.0, max_tokens=48, ignore_eos=True)
    ways = (("base", base, 0, False), ("LoRA adapter", base, slot, False),
            ("guided", dataclasses.replace(base, guided_regex="[a-z ]+"), 0,
             False), ("speculating, motif rows", base, 0, True))
    for label, sp, adapter, spec_on in ways + ways[::-1]:
        eng.scheduler.spec_grant_fn = eng._spec_grant_fn if spec_on else None
        for i in range(64):
            prompt = (rng.integers(0, 256, 8).tolist() * 16 if spec_on
                      else rng.integers(0, 256, 128).tolist())
            eng.add_request(f"fp-{label}-{i}", sampling=sp,
                            adapter_slot=adapter, prompt_token_ids=prompt)
        # every prompt admitted, prefilled and its first token out, then
        # one more step, so the window holds no prefill
        while eng.scheduler.waiting or any(
                not s.output_token_ids for s in eng.scheduler.seqs.values()):
            eng.step()
        eng.step()
        r0, d0 = eng.ragged_dispatches, eng.decode_dispatches
        s0, t0 = eng.spec_steps, eng.spec_step_tokens

        def steps():
            for _ in range(16):
                eng.step()

        prof = _profiled(torch, steps)
        spec = ""
        if spec_on:
            spec = (f", {eng.ragged_dispatches - r0} ragged and "
                    f"{eng.decode_dispatches - d0} decode steps, "
                    f"{(eng.spec_step_tokens - t0) / max(eng.spec_steps - s0, 1):.3f}"
                    f" tokens a verified span")
        _report(card, f"64 rows, {label}{spec}", 16, *prof)
        for rid in list(eng.scheduler.seqs):
            eng.abort_request(rid)
    eng.scheduler.spec_grant_fn = eng._spec_grant_fn


def features_phase(torch, np, counters, card: str) -> dict:
    """Phase 6: llama-3-8b at full width and ``CUT_LAYERS`` layers through
    the HTTP server with a random rank-16 adapter loaded over HTTP, guided regex and JSON
    requests, and (ragged path) n-gram speculation, k = 4. Then, on the
    same engine: the adapter's greedy tokens on a fixed prompt differ from
    base's; spec on beside spec off on the same motif requests; decode
    profiles with LoRA rows and with guided rows. Then the bucketed path
    with a grammar and the adapter. Returns each path's launches."""
    import tempfile

    from production_stack_tpu_torch.engine.config import ModelConfig
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    launches = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(ModelConfig.from_pretrained("llama-3-8b"),
                                  num_layers=CUT_LAYERS)
        adapter = write_adapter(np, cfg, root)
        log(f"[features] rank-16 adapter on 7 targets x {cfg.num_layers} "
            f"layers written in {time.perf_counter() - t0:.1f} s")
        server, launches["features-ragged"], summary = _serve_features(
            torch, np, counters, card, "ragged", adapter, spec_k=4)
        eng = server.engine
        stats = eng.stats()
        summary.update({k: stats[k] for k in (
            "spec_decode_num_draft_tokens_total",
            "spec_decode_num_accepted_tokens_total",
            "spec_decode_acceptance_rate", "spec_decode_tokens_per_step",
            "ragged_dispatches_total", "decode_dispatches_total")})
        log(f"[features] ragged, spec k=4 ({card}): {json.dumps(summary)}")
        if stats["spec_decode_acceptance_rate"] <= 0:
            raise AssertionError("[features] no draft was accepted")
        _expect(launches["features-ragged"], {"K1", "K2", "K3"}, "ragged")
        slot = server.lora.slot_of("smoke-adapter")
        sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
        prompt = np.random.default_rng(9).integers(0, 256, 200).tolist()
        for rid, a in (("fixed-base", 0), ("fixed-adapter", slot)):
            eng.add_request(rid, prompt_token_ids=prompt, sampling=sp,
                            adapter_slot=a)
        toks = {"fixed-base": [], "fixed-adapter": []}
        while eng.has_unfinished():
            for o in eng.step():
                toks[o.request_id].extend(o.new_token_ids)
        if toks["fixed-base"] == toks["fixed-adapter"]:
            raise AssertionError("[features] the adapter's greedy output "
                                 "equals base's")
        log(f"[features] adapter against base on one prompt: "
            f"{sum(a != b for a, b in zip(*toks.values()))} of 32 greedy "
            f"tokens differ")
        _motif_window(torch, np, eng, 10, spec_on=False)  # warm-up
        window = {}
        for turn, spec_on in enumerate((False, True, True, False)):
            window.setdefault("on" if spec_on else "off", []).append(
                _motif_window(torch, np, eng, 10, spec_on))
        log(f"[features] 16 motif requests x 64 tokens, spec on beside off, "
            f"in turns off/on/on/off ({card}): {json.dumps(window)}")
        _feature_profiles(torch, np, eng, card, slot)
        # the next engine sizes its pool to 0.9 of the free memory
        del server, eng
        _released(torch, "ragged")

        server, launches["features-bucketed"], summary = _serve_features(
            torch, np, counters, card, "bucketed", adapter, spec_k=0)
        log(f"[features] bucketed ({card}): {json.dumps(summary)}")
        _expect(launches["features-bucketed"], {"K1", "K3", "K4"},
                "bucketed")
        del server
        _released(torch, "bucketed")
    return launches


# -- phase 7: the surface the router and the fleet read -----------------------

_SAMPLE = re.compile(r'^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict:
    """A Prometheus text exposition's samples: (name, sorted label items)
    -> value. Enough of the format for the engine's /metrics (no
    timestamps)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise AssertionError(f"[surface] unparsed /metrics line {line!r}")
        name, raw, value = m.groups()
        labels = tuple(sorted(
            (k, v.encode().decode("unicode_escape"))
            for k, v in _LABEL.findall(raw or "")))
        out[(name, labels)] = float(value)
    return out


def _http(base: str, path: str, body=None):
    """(status, headers, bytes) of a GET, or a POST of ``body``; an error
    status is returned, not raised."""
    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _scrape(base: str, model: str) -> dict:
    """/metrics as name -> value, for the samples labelled by the model
    alone."""
    status, headers, body = _http(base, "/metrics")
    if status != 200 or not headers["Content-Type"].startswith(
            "text/plain; version=0.0.4"):
        raise AssertionError(f"[surface] /metrics: {status} {headers}")
    return {name: v for (name, labels), v in
            parse_exposition(body.decode()).items()
            if labels == (("model_name", model),)}


def _wait_ready(base: str, timeout: float) -> list:
    """Poll /ready until 200; returns the statuses seen before it."""
    seen, t_end = [], time.monotonic() + timeout
    while time.monotonic() < t_end:
        status, _, body = _http(base, "/ready")
        if status == 200:
            return seen
        seen.append(json.loads(body)["status"])
        time.sleep(0.2)
    raise AssertionError(f"[surface] /ready never turned 200: {seen[-3:]}")


class _SseStream(threading.Thread):
    """A streamed completion read on its own thread: ``tokens`` is its
    usage count once ``done``."""

    def __init__(self, base, body):
        super().__init__(daemon=True)
        self.base, self.body = base, dict(body, stream=True,
                                          stream_options={
                                              "include_usage": True})
        self.tokens, self.done = None, False

    def run(self):
        req = urllib.request.Request(
            self.base + "/v1/completions",
            data=json.dumps(self.body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                if line == "data: [DONE]":
                    self.done = True
                    return
                ev = json.loads(line[len("data: "):])
                if ev.get("usage"):
                    self.tokens = ev["usage"]["completion_tokens"]


def _surface_wave(base: str, model: str, rng) -> tuple:
    """The mixed wave: 16 requests, prompts of 64-1024 byte tokens, greedy
    and sampled, some with logprobs, one guided, and one prompt sent a
    second time once its first copy finished. Returns (the results'
    usage, the repeated prompt)."""
    import re as re_

    repeated = rng.integers(0, 256, 700).tolist()
    first_done = threading.Event()
    jobs = []
    for i in range(13):
        n = int(rng.integers(64, 1025))
        body = {"model": model, "prompt": rng.integers(0, 256, n).tolist(),
                "max_tokens": 32, "ignore_eos": True,
                **({"temperature": 0.0} if i % 2 == 0 else
                   {"temperature": 0.8, "top_p": 0.95, "seed": i})}
        if i % 3 == 0:
            body["logprobs"] = 2
        jobs.append((0.05 * i, None, body))
    jobs.append((0.0, None, {"model": model, "prompt": "answer: ",
                             "max_tokens": 32, "temperature": 0.0,
                             "guided_regex": "[a-z ]{4,30}"}))
    jobs.append((0.0, "first", {"model": model, "prompt": repeated,
                                "max_tokens": 16, "temperature": 0.0,
                                "ignore_eos": True}))
    jobs.append((0.0, "again", {"model": model, "prompt": repeated,
                                "max_tokens": 16, "temperature": 0.0,
                                "ignore_eos": True}))

    def run(job):
        delay, tag, body = job
        if tag == "again":
            if not first_done.wait(600):
                raise AssertionError("[surface] the first copy never ended")
        time.sleep(delay)
        status, _, raw = _http(base, "/v1/completions", body)
        if tag == "first":
            first_done.set()
        if status != 200:
            raise AssertionError(f"[surface] wave: {status} {raw[:200]}")
        out = json.loads(raw)
        if "guided_regex" in body and not re_.fullmatch(
                body["guided_regex"], out["choices"][0]["text"]):
            raise AssertionError("[surface] guided output does not match")
        if body.get("logprobs") and len(
                out["choices"][0]["logprobs"]["token_logprobs"]) != 32:
            raise AssertionError("[surface] missing logprobs")
        return tag, out["usage"]

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        results = list(ex.map(run, jobs))
    if len(results) != 16:
        raise AssertionError("[surface] the wave is not 16 requests")
    return results, repeated


def _decode_window(base: str, model: str, rng) -> dict:
    """64 rows x 64 tokens, all admitted at once, /metrics scraped in a
    loop while they run; /debug/perf read as the last row finishes."""
    jobs = [{"model": model, "prompt": rng.integers(0, 256, 32).tolist(),
             "max_tokens": 64, "temperature": 0.0, "ignore_eos": True}
            for _ in range(64)]
    scrape_ms, stop = [], threading.Event()

    def scraper():
        while not stop.is_set():
            t0 = time.perf_counter()
            if _http(base, "/metrics")[0] != 200:
                raise AssertionError("[surface] /metrics failed under load")
            scrape_ms.append((time.perf_counter() - t0) * 1e3)
            time.sleep(0.05)

    scrape = threading.Thread(target=scraper, daemon=True)
    t0 = time.perf_counter()
    scrape.start()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        outs = list(ex.map(lambda b: _http(base, "/v1/completions", b),
                           jobs))
    wall = time.perf_counter() - t0
    perf = json.loads(_http(base, "/debug/perf")[2])
    stop.set()
    scrape.join(30)
    tokens = 0
    for status, _, raw in outs:
        if status != 200:
            raise AssertionError(f"[surface] window: {status}")
        tokens += json.loads(raw)["usage"]["completion_tokens"]
    if tokens != 64 * 64:
        raise AssertionError(f"[surface] window: {tokens} tokens")
    return {"perf": perf, "wall_s": wall, "client_tok_per_s": tokens / wall,
            "scrape_ms": scrape_ms}


def _surface_prefill_window(base: str, model: str, rng) -> dict:
    """16 fresh 1024-token prompts, one token out each: prefill steps of
    the whole 2048-token budget, read through /debug/perf as the last
    request finishes."""
    jobs = [{"model": model, "prompt": rng.integers(0, 256, 1024).tolist(),
             "max_tokens": 1, "temperature": 0.0, "ignore_eos": True}
            for _ in range(16)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        outs = list(ex.map(lambda b: _http(base, "/v1/completions", b),
                           jobs))
    wall = time.perf_counter() - t0
    perf = json.loads(_http(base, "/debug/perf")[2])
    if any(status != 200 for status, _, _ in outs):
        raise AssertionError("[surface] prefill window: a request failed")
    return {"perf": perf, "wall_s": wall,
            "client_prompt_tok_per_s": 16 * 1024 / wall}


def _profile_during_wave(base: str, model: str, rng) -> dict:
    """POST /debug/profile while waves of prefills and decodes run back to
    back for the whole capture (the profiler takes a moment to start
    tracing the card): the trace must name K2's and K3's kernels. Returns
    kernel time by class."""
    import io
    import tarfile

    def wave():
        jobs = [{"model": model,
                 "prompt": rng.integers(0, 256, 256).tolist(),
                 "max_tokens": 16, "temperature": 0.0, "ignore_eos": True}
                for _ in range(8)]
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
            return [r[0] for r in ex.map(
                lambda b: _http(base, "/v1/completions", b), jobs)]

    statuses = []
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        prof = ex.submit(_http, base, "/debug/profile", {"duration_ms": 4000})
        while not prof.done():
            statuses += wave()
        status, headers, body = prof.result()
    if status != 200 or headers["Content-Type"] != "application/gzip":
        raise AssertionError(f"[surface] /debug/profile: {status} "
                             f"{body[:200]}")
    if any(s != 200 for s in statuses):
        raise AssertionError("[surface] a request failed while profiling")
    with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
        trace = json.loads(tar.extractfile("trace/trace.json").read())
    by_cat = collections.Counter()
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") == "kernel":
            by_cat[_category(ev.get("name", ""))] += ev.get("dur", 0) / 1e3
    if by_cat["K2"] <= 0 or by_cat["K3"] <= 0:
        raise AssertionError(f"[surface] the trace names no K2 or no K3 "
                             f"kernel: {dict(by_cat)}")
    return {k: round(v, 3) for k, v in by_cat.items()}


def _drain(base: str, model: str, server) -> dict:
    """A 256-token stream in flight; POST /drain: /ready 503 draining, a
    new completion 503 with Retry-After, the stream finishes whole."""
    stream = _SseStream(base, {"model": model, "prompt": "drain " * 20,
                               "max_tokens": 256, "temperature": 0.0,
                               "ignore_eos": True})
    stream.start()
    # random weights mostly emit ids past the byte range, which decode to
    # no text, so the stream may send no event before its last: wait for
    # the engine to run it instead
    t_end = time.monotonic() + 120
    while _scrape(base, model)["vllm:num_requests_running"] < 1:
        if time.monotonic() > t_end or stream.done:
            raise AssertionError("[surface] the stream never started")
        time.sleep(0.02)
    status, _, body = _http(base, "/drain", {})
    if stream.done or json.loads(body)["inflight"] != 1:
        raise AssertionError(f"[surface] the stream was not in flight at "
                             f"the drain: {body}")
    ready, _, ready_body = _http(base, "/ready")
    late, headers, _ = _http(base, "/v1/completions",
                             {"model": model, "prompt": "late",
                              "max_tokens": 4})
    stream.join(300)
    if (status != 200 or ready != 503
            or json.loads(ready_body)["status"] != "draining"):
        raise AssertionError(f"[surface] drain: {status} {body}, /ready "
                             f"{ready} {ready_body}")
    if late != 503 or "Retry-After" not in headers:
        raise AssertionError(f"[surface] a completion while draining got "
                             f"{late} {headers}")
    if not (stream.done and stream.tokens == 256):
        raise AssertionError(f"[surface] the drained stream ended with "
                             f"{stream.tokens} tokens")
    if not server.wait_drained(60):
        raise AssertionError("[surface] the drain never finished")
    m = _scrape(base, model)
    if (m["vllm:drain_state"] != 1.0
            or m["vllm:drain_rejected_requests_total"] < 1):
        raise AssertionError(f"[surface] drain metrics: {m}")
    return {"stream_tokens": stream.tokens,
            "drain_rejected": m["vllm:drain_rejected_requests_total"],
            "drain_aborted": m["vllm:drain_aborted_seqs_total"]}


def _canary_card_against_cpu(torch) -> int:
    """float32 tiny-llama's /debug/canary records on the card against the
    same weights' on the CPU (the plain path), under canary_golden.compare
    at tolerance 1e-4. Returns the tokens compared."""
    from production_stack_tpu_torch.canary_golden import GoldenRecord, compare
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.server import EngineServer
    from production_stack_tpu_torch.engine.weights import (
        init_random,
        to_device,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _parity_engine("ragged", "float32")
    params = init_random(cfg.model, seed=0, device="cpu")
    records = {}
    for device in ("cpu", "cuda"):
        server = EngineServer(cfg, engine=LLMEngine(
            cfg, params=to_device(params, device), device=device))
        base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
        try:
            status, _, body = _http(base, "/debug/canary?tolerance=1e-4")
        finally:
            server.shutdown()
        out = json.loads(body)
        if status != 200 or out["errors"]:
            raise AssertionError(f"[surface] canary on {device}: {out}")
        records[device] = [GoldenRecord.from_dict(r) for r in out["records"]]
    compared = 0
    for want, got in zip(records["cpu"], records["cuda"]):
        verdict = compare(want, got.tokens, got.fingerprint)
        if not verdict.ok:
            raise AssertionError(f"[surface] canary {got.probe}: card "
                                 f"against cpu: {verdict}")
        compared += len(got.tokens)
    return compared


def _utilizations(perf: dict, tag: str) -> tuple:
    mfu = perf["model_flops_utilization"]
    hbm = perf["hbm_bandwidth_utilization"]
    if not (0 < mfu <= 1.05 and 0 < hbm <= 1.05):
        raise AssertionError(f"[surface] {tag}: utilizations out of (0, "
                             f"1.05]: MFU {mfu}, HBM {hbm}")
    return mfu, hbm


def _compile_events(runner) -> list:
    """Every compile event's (seconds, kind, bucket), beside the
    accountant's own tail of 64: each step's tracker also reports here.
    (A helper, so that no local of the caller keeps the runner alive.)"""
    events = []
    for attr in ("ragged_step", "prefill", "decode_program"):
        tracker = getattr(runner, attr)
        tracker.observer = (lambda kind, bucket, s, note=tracker.observer:
                            (events.append((s, kind, bucket)),
                             note(kind, bucket, s)))
    return events


# phase 7's accountant window (``--perf-window``; the CLI's default is
# 60 s): each utilization window is read alone in it after a pause this
# long (a window's requests finish in 0.7-3.5 s)
SURFACE_PERF_WINDOW = 6.0


def surface_phase(torch, np, counters, card: str) -> dict:
    """Phase 7: llama-3-8b (bf16, ragged, ``CUT_LAYERS`` layers) through the
    server's command-line defaults, warmup on: /ready warming -> ready, the
    mixed wave and its /metrics, /kv/lookup, a prefill window and a steady
    64-row decode window, each read through /debug/perf, /metrics under load,
    /debug/profile during a wave, /debug/canary, the drain. Then canary records
    card = CPU on float32 tiny-llama. Returns the phase's launches."""
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        server_from_args,
    )

    model = "llama-3-8b"
    args = build_parser().parse_args(["--model", model, "--seed", "0",
                                      "--perf-window",
                                      str(SURFACE_PERF_WINDOW)])
    with _CutServers():
        server = server_from_args(args)
    eng = server.engine
    events = _compile_events(eng.runner)
    for c in counters:
        c.n = 0
    base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        warming = _scrape(base, model)["vllm:engine_warming"]
        seen = _wait_ready(base, 900)
        m = _scrape(base, model)
        if (not seen or seen[0] != "warming" or warming != 1.0
                or m["vllm:engine_warming"] != 0.0):
            raise AssertionError(f"[surface] /ready never warmed: {seen[:2]}"
                                 f", engine_warming {warming} -> "
                                 f"{m['vllm:engine_warming']}")
        slow = max(events)
        log(f"[surface] warmup ({card}): "
            f"{m['vllm:engine_warmup_seconds']:.1f} s, {len(events)} "
            f"compile events, {sum(s for s, _, _ in events):.1f} s of first "
            f"calls, slowest {slow[1]}:{slow[2]} {slow[0]:.2f} s; /ready "
            f"polls while warming: {len(seen)}")
        rng = np.random.default_rng(11)
        m0 = m
        results, repeated = _surface_wave(base, model, rng)
        m = _scrape(base, model)
        usage = [u for _, u in results]
        sums = {"prompt": sum(u["prompt_tokens"] for u in usage),
                "completion": sum(u["completion_tokens"] for u in usage)}
        got = {"prompt": m["vllm:prompt_tokens_total"]
               - m0["vllm:prompt_tokens_total"],
               "completion": m["vllm:generation_tokens_total"]
               - m0["vllm:generation_tokens_total"]}
        cached = dict(results)["again"]["prompt_tokens_details"][
            "cached_tokens"]
        if m["vllm:unexpected_recompiles_total"] != 0:
            raise AssertionError(
                "[surface] unexpected recompiles after warmup: "
                f"{json.loads(_http(base, '/debug/perf')[2])['compile']}")
        if got != sums or m["vllm:gpu_prefix_cache_hits_total"] <= 0:
            raise AssertionError(f"[surface] /metrics {got} against the "
                                 f"wave's usage {sums}; prefix hits "
                                 f"{m['vllm:gpu_prefix_cache_hits_total']}")
        log(f"[surface] mixed wave of 16: /metrics token counters = usage "
            f"sums {sums}; unexpected recompiles 0; prefix-cache hits "
            f"{m['vllm:gpu_prefix_cache_hits_total']:.0f}; the repeated "
            f"prompt had {cached} cached tokens")
        bs = eng.config.cache.block_size
        hit = json.loads(_http(base, "/kv/lookup", {"tokens": repeated})[2])
        fresh = json.loads(_http(base, "/kv/lookup", {
            "tokens": rng.integers(0, 256, 300).tolist()})[2])
        if (hit["matched_tokens"] != len(repeated) // bs * bs
                or fresh["matched_tokens"] != 0):
            raise AssertionError(f"[surface] /kv/lookup: {hit}, {fresh}")
        log(f"[surface] /kv/lookup: repeated prompt {hit}, fresh {fresh}")
        # the accountant's window holds only a window's dispatches once
        # the earlier ones are older than that
        time.sleep(SURFACE_PERF_WINDOW + 1)
        w = _surface_prefill_window(base, model, rng)
        perf = w["perf"]
        _utilizations(perf, "prefill window")
        log(f"[surface] 16 x 1024 prompt tokens, one out ({card}): "
            f"/debug/perf MFU {perf['model_flops_utilization']:.4f}, HBM "
            f"bandwidth {perf['hbm_bandwidth_utilization']:.4f}, prefill "
            f"{perf['tokens_per_second']['prefill']:.1f} tok/s; cost model "
            f"measured/predicted {perf['costmodel']['drift_ratio']}; client "
            f"{w['client_prompt_tok_per_s']:.1f} prompt tok/s over "
            f"{w['wall_s']:.2f} s")
        time.sleep(SURFACE_PERF_WINDOW + 1)
        w = _decode_window(base, model, rng)
        perf = w["perf"]
        mfu, hbm = _utilizations(perf, "decode window")
        log(f"[surface] 64 rows x 64 tokens ({card}): /debug/perf MFU "
            f"{mfu:.4f}, HBM bandwidth {hbm:.4f}, decode "
            f"{perf['tokens_per_second']['decode']:.1f} tok/s (prefill "
            f"{perf['tokens_per_second']['prefill']:.1f}); cost model "
            f"measured/predicted {perf['costmodel']['drift_ratio']}; client "
            f"{w['client_tok_per_s']:.1f} tok/s over {w['wall_s']:.2f} s; "
            f"device memory {perf['hbm_bytes']}; /metrics under load: "
            f"median {statistics.median(w['scrape_ms']):.2f} ms, max "
            f"{max(w['scrape_ms']):.2f} ms over {len(w['scrape_ms'])} "
            f"scrapes")
        by_cat = _profile_during_wave(base, model, rng)
        log(f"[surface] /debug/profile during a wave: kernel ms by class "
            f"{json.dumps(by_cat)}")
        status, _, body = _http(base, "/debug/canary")
        out = json.loads(body)
        if status != 200 or out["errors"] or len(out["records"]) != 2:
            raise AssertionError(f"[surface] /debug/canary: {out}")
        drain = _drain(base, model, server)
        log(f"[surface] drain: {json.dumps(drain)}")
    finally:
        launches = {c.name.split()[0]: c.n for c in counters}
        server.shutdown()
    _expect(launches, {"K1", "K2", "K3"}, "surface")
    del server, eng
    _released(torch, "surface")
    n = _canary_card_against_cpu(torch)
    log(f"[surface] /debug/canary float32 tiny-llama: card = cpu on {n} "
        f"greedy tokens (compare, tolerance 1e-4)")
    return launches


# -- phases 5 and 8: Mixtral's MoE block, int8, local checkpoints -------------

# An int8 activation whose value over its scale lies within float noise of
# a rounding boundary rounds either way on the card and on the CPU, which
# moves its token's products by one int8 step: about 1e-2 of a logit on
# tiny-llama (the CPU tests against the JAX engine saw logprobs move by up
# to 0.03). An int8 greedy flip is accepted where the CPU run's top-2 gap
# is within this band.
INT8_TIE_GAP = 0.05
# the accountant's window in phase 8: the prefill window is read alone in
# it after a pause this long
MOE_PERF_WINDOW = 5.0


def write_hf_checkpoint(np, cfg, root: str, seed: int = 0) -> str:
    """A HF-layout checkpoint of ``cfg``'s geometry written in numpy: a
    config.json and every tensor the port's key map reads, float32, split
    over two ``*.safetensors`` shards (``lora.write_safetensors``)."""
    from production_stack_tpu_torch.engine.lora import write_safetensors
    from production_stack_tpu_torch.engine.weights import _hf_key_map

    E, F, H, KH, D, V = (cfg.hidden_size, cfg.intermediate_size,
                         cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.vocab_size)
    shapes = {"q_proj": (H * D, E), "k_proj": (KH * D, E),
              "v_proj": (KH * D, E), "o_proj": (E, H * D),
              "gate_proj": (F, E), "up_proj": (F, E), "down_proj": (E, F)}
    rng = np.random.default_rng(seed)
    shards = [{}, {}]

    def put(shard, name, shape, scale):
        shards[shard][name] = (rng.standard_normal(shape) * scale).astype(
            np.float32)

    put(0, "model.embed_tokens.weight", (V, E), E ** -0.5)
    put(1, "model.norm.weight", (E,), 0.1)
    put(1, "lm_head.weight", (V, E), E ** -0.5)
    for i in range(cfg.num_layers):
        for name in _hf_key_map(cfg, i):
            shape = shapes.get(name.split(".")[-2], (E,))
            put(i * 2 // cfg.num_layers, name, shape,
                0.1 if len(shape) == 1 else shape[1] ** -0.5)
    for n, tensors in enumerate(shards):
        write_safetensors(f"{root}/model-{n + 1:05d}-of-00002.safetensors",
                          tensors)
    with open(f"{root}/config.json", "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"], "hidden_size": E,
                   "intermediate_size": F, "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": H, "num_key_value_heads": KH,
                   "head_dim": D, "vocab_size": V,
                   "max_position_embeddings": cfg.max_model_len,
                   "rms_norm_eps": cfg.rms_norm_eps,
                   "rope_theta": cfg.rope_theta}, f)
    return root


def moe_int8_parity_phase(torch, np) -> None:
    """Phase 5's MoE, int8 and checkpoint checks, each on the card against
    the CPU with the same weights and prompts: tiny-mixtral float32 on the
    ragged path and on the bucketed path (where the MoE block runs between
    K4's launches); tiny-llama with ``quant="int8"`` (float32) on the
    ragged path at T = 512, so ragged steps take W8A16 and decode steps
    W8A8, and both routes must run on the card; and a tiny-llama HF
    checkpoint written here in numpy, served with ``--model <dir>``.
    Greedy tokens equal up to printed near-ties: TIE_GAP in float32,
    INT8_TIE_GAP with int8."""
    import tempfile

    from production_stack_tpu_torch.engine import quant
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        ModelConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        config_from_args,
    )
    from production_stack_tpu_torch.engine.weights import (
        init_random,
        to_device,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 259, n).tolist() for n in PARITY_LENGTHS]
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True,
                        logprobs=2)

    def engine_cfg(model, impl, T=64, **model_kw):
        return EngineConfig.for_model(
            model, cache=CacheConfig(block_size=16, num_blocks=256),
            scheduler=SchedulerConfig(max_num_seqs=8,
                                      max_num_batched_tokens=T),
            attention_impl=impl, **model_kw)

    def card_against_cpu(tag, cfg, params, gap):
        runs = {}
        for device in ("cpu", "cuda"):
            p = None if params is None else to_device(params, device)
            runs[device] = _greedy_tokens(
                LLMEngine(cfg, params=p, device=device), prompts, sp)
        compared, worst = _compare_greedy(tag + ", card against cpu",
                                          runs["cpu"], runs["cuda"], gap)
        log(f"[parity] {tag}: {compared} greedy tokens identical between "
            f"the card and the cpu; largest logprob difference {worst:.3e}")

    for impl in ("ragged", "bucketed"):
        cfg = engine_cfg("tiny-mixtral", impl)
        card_against_cpu(f"tiny-mixtral float32, {impl}", cfg,
                         init_random(cfg.model, seed=0, device="cpu"),
                         TIE_GAP)

    cfg = engine_cfg("tiny-llama", "ragged", T=512, quant="int8")
    routes = collections.Counter()
    wrapped = {name: getattr(quant, name)
               for name in ("int8_mm", "dequantize_tile")}

    def counting(name):
        def call(*a, **kw):
            if a[0].is_cuda:
                routes[name] += 1
            return wrapped[name](*a, **kw)
        return call

    for name in wrapped:
        setattr(quant, name, counting(name))
    try:
        card_against_cpu("tiny-llama int8, ragged, T = 512", cfg,
                         init_random(cfg.model, seed=0, device="cpu"),
                         INT8_TIE_GAP)
    finally:
        for name, fn in wrapped.items():
            setattr(quant, name, fn)
    if not (routes["int8_mm"] and routes["dequantize_tile"]):
        raise AssertionError(f"[parity] int8: routes on the card {routes}; "
                             "both W8A8 (int8_mm) and W8A16 must run")
    log(f"[parity] int8 routes on the card: {dict(routes)} calls")

    with tempfile.TemporaryDirectory() as root:
        write_hf_checkpoint(np, ModelConfig.from_pretrained("tiny-llama"),
                            root)
        cfg = config_from_args(build_parser().parse_args(
            ["--model", root, "--dtype", "float32", "--max-num-seqs", "8",
             "--max-num-batched-tokens", "64", "--num-blocks", "256"]))
        if cfg.model.weights_path != root:
            raise AssertionError("[parity] --model <dir> did not set the "
                                 "checkpoint path")
        card_against_cpu("tiny-llama checkpoint, --model <dir>", cfg, None,
                         TIE_GAP)


def _moe_profile(torch, np, eng, card: str) -> None:
    """One ragged step of 2048 prefill tokens (2 prompts of 1024, one
    dispatch and the step that resolves it) and 16 decode steps at 64
    rows, traced on the Mixtral engine that just served."""
    rng = np.random.default_rng(9)
    r0 = eng.ragged_dispatches

    def prefill():
        _add_requests(eng, rng, "mp", 2, 1024, 1)
        while eng.has_unfinished():
            eng.step()

    prof = _profiled(torch, prefill, MOE_RANGES)
    if eng.ragged_dispatches - r0 != 1:
        raise AssertionError("[moe-int8] the prefill window is not one "
                             "ragged step")
    _report(card, "mixtral int8, ragged, 2048 prefill tokens (traced: host "
            "tracing slows the wall clock)", 1, *prof)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    log(f"[moe-int8] ragged, 2048 prefill tokens, untraced ({card}): "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    _add_requests(eng, rng, "md", 64, 128, 48)
    d0 = eng.decode_dispatches
    while eng.decode_dispatches == d0:  # prefill all 64, then one decode
        eng.step()

    def decode():
        for _ in range(16):
            eng.step()

    prof = _profiled(torch, decode, MOE_RANGES)
    if eng.decode_dispatches - d0 != 17:
        raise AssertionError("[moe-int8] the decode window ran ragged steps")
    _report(card, "mixtral int8, decode, 64 rows (traced)", 16, *prof)
    # the host's tracing slows a step: the next 16 untraced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    log(f"[moe-int8] decode, 64 rows, untraced ({card}): "
        f"{(time.perf_counter() - t0) * 1e3 / 16:.3f} ms a step")
    for rid in list(eng.scheduler.seqs):
        eng.abort_request(rid)


def _last_logits(torch, cfg, params, tokens, ref_tokens=None):
    """float32 logits at the last of ``tokens`` (one sequence) through the
    port's model on the card, attention through K1 and K2."""
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops.kv_write import kv_write
    from production_stack_tpu_torch.ops.paged_attention import combine_kv
    from production_stack_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    S, bs, dev = len(tokens), 16, "cuda"
    M = -(-S // bs)
    pool = torch.zeros((cfg.num_layers, M, bs, 2 * cfg.num_kv_heads,
                        cfg.head_dim), dtype=cfg.torch_dtype, device=dev)
    tables = torch.zeros((1, (M + 7) // 8 * 8), dtype=torch.int32,
                         device=dev)
    tables[0, :M] = torch.arange(M, dtype=torch.int32, device=dev)
    cu = torch.tensor([0, S], dtype=torch.int32, device=dev)
    ctx = torch.tensor([S], dtype=torch.int32, device=dev)
    slots = torch.arange(S, dtype=torch.int32, device=dev)

    def attend(q, k, v, pool, layer):
        kv_write(pool, combine_kv(k, v).to(pool.dtype).contiguous(), slots,
                 layer)
        return ragged_paged_attention(q.contiguous(), pool, tables, cu, ctx,
                                      layer), pool

    with torch.inference_mode():
        hidden, _ = llama.forward_tokens(
            cfg, params, torch.tensor(tokens, device=dev),
            torch.arange(S, device=dev), attend, pool, ref_tokens=ref_tokens)
        return llama.logits_from_hidden(cfg, params, hidden[-1:])[0]


def int8_cosine_check(torch, np) -> dict:
    """llama-3-8b at full width, bf16 against the same weights quantized
    to int8, on one 256-token prompt: the last token's logits must have
    cosine > 0.99 (the reference's tests/test_quant.py bound), through
    W8A8 (256 rows) and through W8A16 (the products told they run 2048
    tokens, as a ragged step's do)."""
    import dataclasses as dc

    from production_stack_tpu_torch.engine.config import ModelConfig
    from production_stack_tpu_torch.engine.quant import quantize_params
    from production_stack_tpu_torch.engine.weights import init_random

    cfg = ModelConfig.from_pretrained("llama-3-8b")
    prompt = np.random.default_rng(11).integers(0, 256, 256).tolist()
    params = init_random(cfg, seed=0, device="cuda")
    want = _last_logits(torch, cfg, params, prompt).float()
    qcfg = dc.replace(cfg, quant="int8")
    qparams = quantize_params(qcfg, params)
    del params
    cos = {}
    for route, ref in (("w8a8", None), ("w8a16", 2048)):
        got = _last_logits(torch, qcfg, qparams, prompt, ref).float()
        cos[route] = float(torch.nn.functional.cosine_similarity(
            want, got, dim=0))
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    if min(cos.values()) <= 0.99:
        raise AssertionError(f"[moe-int8] llama-3-8b int8 against bf16: "
                             f"last-token logit cosine {cos} <= 0.99")
    log(f"[moe-int8] llama-3-8b int8 against bf16, 256-token prompt: "
        f"last-token logit cosine {json.dumps(cos)} (> 0.99)")
    return cos


def moe_int8_phase(torch, np, counters, card: str) -> dict:
    """Phase 8: mixtral-8x7b at full width and depth in int8 (bf16
    activations, ``--quantization int8``, random weights from seed 0 made
    on the card) through the HTTP server on the ragged path, without the
    launch warmup. The 16 requests of a slice: every response 200 with 32
    tokens, K1, K2 and K3 launched and K4 not. Weight bytes, KV blocks,
    output tok/s and median TTFT printed; /debug/perf read after a prefill
    window alone in the accountant's window (MFU in (0, 1.05]); a profile
    of one 2048-token ragged step and 16 decode steps at 64 rows. Then
    llama-3-8b int8 against bf16 (``int8_cosine_check``). Returns the
    wave's launches."""
    from production_stack_tpu_torch.engine import quant
    from production_stack_tpu_torch.engine.server import (
        EngineServer,
        build_parser,
        config_from_args,
    )

    model = "mixtral-8x7b"
    cfg = config_from_args(build_parser().parse_args(
        ["--model", model, "--quantization", "int8", "--seed", "0",
         "--perf-window", str(MOE_PERF_WINDOW)]))
    t0 = time.perf_counter()
    server = EngineServer(cfg, device="cuda")  # no launch warmup
    base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    eng = server.engine
    params = eng.runner.params
    leaves = [params["embed"], params["lm_head"], *params["layers"].values()]
    q_bytes = sum(w["q"].numel() for w in leaves if quant.is_quantized(w))
    s_bytes = sum(4 * w["s"].numel() for w in leaves if quant.is_quantized(w))
    rest = sum(w.numel() * w.element_size() for w in leaves
               if not quant.is_quantized(w)) + 2 * params["final_norm"].numel()
    log(f"[moe-int8] {model} int8 up in {time.perf_counter() - t0:.1f} s "
        f"({card}; launch warmup skipped): weights {q_bytes} B int8 + "
        f"{s_bytes} B float32 scales + {rest} B bf16 (norms, router); "
        f"{eng.runner.num_blocks} KV blocks of {cfg.cache.block_size} "
        f"tokens; device memory {torch.cuda.memory_allocated() / 2**30:.1f}"
        f" GiB allocated")
    try:
        results, wall, launches = _slice_wave(np, base, model, counters)
        stamps = list(server.async_engine.finished)
        for status, n_out, _ in results:
            if status != 200 or n_out != 32:
                raise AssertionError(f"[moe-int8] bad response: status "
                                     f"{status}, {n_out} tokens")
        _expect(launches, {"K1", "K2", "K3"}, "moe-int8")
        out_tok = sum(r[1] for r in results)
        stats = eng.stats()
        log(f"[moe-int8] wave ({card}): " + json.dumps({
            "requests": len(results), "output_tokens": out_tok,
            "wall_s": wall, "output_tok_per_s": out_tok / wall,
            "ttft_median_s": statistics.median(
                ft - arr for arr, ft, _, _ in stamps),
            "e2e_median_s": statistics.median(r[2] for r in results),
            "ragged_steps": stats["ragged_dispatches_total"],
            "decode_steps": stats["decode_dispatches_total"],
            "launches": launches}))
        # the wave's dispatches leave the accountant's window first
        time.sleep(MOE_PERF_WINDOW + 0.5)
        rng = np.random.default_rng(10)
        bodies = [{"model": model, "prompt": rng.integers(0, 256, 1024)
                   .tolist(), "max_tokens": 1, "temperature": 0.0}
                  for _ in range(8)]
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            done = list(pool.map(lambda b: _post(base, "/v1/completions", b),
                                 bodies))
        window = time.perf_counter() - t1
        status, perf, _ = _post(base, "/debug/perf")
        mfu = perf["model_flops_utilization"]
        if (any(d[0] != 200 for d in done) or status != 200
                or not 0.0 < mfu <= 1.05):
            raise AssertionError(f"[moe-int8] prefill window: statuses "
                                 f"{[d[0] for d in done]}, /debug/perf "
                                 f"{status}, MFU {mfu}")
        log(f"[moe-int8] prefill window, 8 x 1024 tokens in {window:.2f} s "
            f"({card}): /debug/perf MFU {mfu:.4f}, HBM "
            f"{perf['hbm_bandwidth_utilization']:.4f}, prefill tok/s "
            f"{perf['tokens_per_second']['prefill']:.1f}; parameters "
            f"{perf['model']['param_count']}, active a token "
            f"{perf['model']['active_param_count']}, bytes "
            f"{perf['model']['param_bytes']}")
    finally:
        server.shutdown()
    _moe_profile(torch, np, eng, card)
    del server, eng, params, leaves
    _released(torch, "moe-int8")
    int8_cosine_check(torch, np)
    return launches


# phase 9: greedy requests restricted to 64 printable byte tokens, so the
# byte tokenizer's text is one character a token and two runs' texts are
# equal exactly when their tokens are. Logprobs report the raw
# distribution (its top-2 need not be allowed tokens), so a flip is a
# near-tie when each run's logprob of its own token at that step is within
# the band of the other's. The band is BF16_LOGPROB_BAND or, if larger,
# twice the largest deviation of the prefill engine's own repeat of the
# unified wave (its full blocks prefix-cached, each tail recomputed: what
# a pull or a tier does): 32 random bf16 layers carry a recomputed token's
# rounding into later logprobs further than tiny-llama's 2 layers, and the
# plane is held to the engine's own noise, not below it
KV_ALLOWED = list(range(48, 112))
KV_MODEL = "llama-3-8b"
KV_PROMPTS = (512, 2048)  # P->D prompt lengths; the first is the longest
KV_PD_BLOCKS = 4096  # each P/D pool: 2 GiB at llama-3-8b's CUT_LAYERS
KV_WAVE = 1024  # tier-wave prompt length
KV_HOST_BYTES = 4 << 30


def _kv_body(prompt, max_tokens: int, **extra) -> dict:
    return {"model": KV_MODEL, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0.0, "ignore_eos": True, "logprobs": 1,
            "allowed_token_ids": KV_ALLOWED, **extra}


def _kv_post(base: str, body: dict) -> dict:
    status, out, _ = _post(base, "/v1/completions", body)
    if status != 200:
        raise AssertionError(f"[kv-plane] {base}: HTTP {status}")
    return out


def _kv_run(out: dict) -> tuple:
    """(text, token logprobs) of a completion."""
    c = out["choices"][0]
    return c["text"], list(c["logprobs"]["token_logprobs"])


def _kv_dev(ref: tuple, got: tuple) -> tuple:
    """(tokens equal before the first flip, the largest logprob deviation
    over them, the flip's two logprobs or None)."""
    (rt, rl), (gt, gl) = ref, got
    if len(gt) != len(rt):
        raise AssertionError(f"[kv-plane] {len(gt)} tokens, want {len(rt)}")
    n = next((j for j, (a, b) in enumerate(zip(rt, gt)) if a != b), len(rt))
    worst = max((abs(x - y) for x, y in zip(rl[:n], gl[:n])), default=0.0)
    return n, worst, ((rl[n], gl[n]) if n < len(rt) else None)


def _kv_same(tag: str, ref: tuple, got: tuple, band: float) -> tuple:
    """``got``'s tokens equal ``ref``'s up to a near-tie, logprobs within
    ``band`` up to there; (tokens compared, the largest deviation)."""
    n, worst, flip = _kv_dev(ref, got)
    if flip is not None:
        if abs(flip[0] - flip[1]) >= band:
            raise AssertionError(f"[kv-plane] {tag}: step {n}: tokens "
                                 f"differ (logprobs {flip[0]:.4f}, "
                                 f"{flip[1]:.4f}; band {band:.4f})")
        log(f"[kv-plane] {tag}: near-tie at step {n} (logprobs "
            f"{flip[0]:.4f}, {flip[1]:.4f}); compared up to it")
    if worst > band:
        raise AssertionError(f"[kv-plane] {tag}: logprobs differ by {worst} "
                             f"(band {band:.4f})")
    return n, worst


def _kv_server(cfg_args: list):
    from production_stack_tpu_torch.engine.server import (
        EngineServer,
        build_parser,
        config_from_args,
    )

    cfg = _cut_depth(config_from_args(build_parser().parse_args(
        ["--model", KV_MODEL, "--seed", "0", *cfg_args])))
    server = EngineServer(cfg, device="cuda")  # no launch warmup
    return server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"


def _kv_wave(base: str, prompts: list, max_tokens: int,
             server) -> tuple:
    """Serve ``prompts`` at once; (runs, median TTFT from the engine's
    stamps, wall seconds)."""
    n0 = len(server.async_engine.finished)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        outs = list(pool.map(
            lambda p: _kv_post(base, _kv_body(p, max_tokens)), prompts))
    wall = time.perf_counter() - t0
    stamps = list(server.async_engine.finished)[n0:]
    ttft = statistics.median(ft - arr for arr, ft, _, _ in stamps)
    return [_kv_run(o) for o in outs], ttft, wall


def _kv_pd(torch, np, card: str) -> float:
    """Phase 9, parts 1 and 2: a prefill and a decode server of
    llama-3-8b at ``CUT_LAYERS`` (pools of 4096 blocks, 2 GiB each) in
    this process; this script plays the router's two hops."""
    from production_stack_tpu_torch.engine.kv_transfer import nbytes_of

    P, p_url = _kv_server(["--role", "prefill", "--num-blocks",
                           str(KV_PD_BLOCKS)])
    D, d_url = _kv_server(["--role", "decode", "--num-blocks",
                           str(KV_PD_BLOCKS)])
    bs = P.config.cache.block_size
    lo, hi = KV_PROMPTS
    try:
        rng = np.random.default_rng(9)
        lens = [hi] + [int(x) for x in rng.integers(lo, hi + 1, 15)]
        prompts = [rng.integers(0, 256, n).tolist() for n in lens]
        # the reference: the prefill server's own unified serve
        unified, _, _ = _kv_wave(p_url, prompts, 64, P)
        repeat, _, _ = _kv_wave(p_url, prompts, 64, P)
        noise = max(_kv_dev(u, r)[1] for u, r in zip(unified, repeat))
        band = max(BF16_LOGPROB_BAND, 2 * noise)
        log(f"[kv-plane] the prefill engine's own repeat of the wave "
            f"deviates by up to {noise:.4f} in logprob ({card}): band "
            f"{band:.4f}")

        # pull (the router's buffered flow): the producer answers with its
        # block ids, the consumer pulls /kv/export as a stream
        def pull(prompt):
            pre = _kv_post(p_url, _kv_body(prompt, 1, kv_transfer_params={
                "do_remote_decode": True}))
            kv = dict(pre["kv_transfer_params"], remote_host=p_url)
            return _kv_post(d_url, _kv_body(prompt, 64,
                                            kv_transfer_params=kv))

        imports0 = D.metrics.transfer_totals.get("import", {}).get("count", 0)
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            pulled = list(pool.map(pull, prompts))
        imports = D.metrics.transfer_totals["import"]["count"] - imports0
        for i, (prompt, out) in enumerate(zip(prompts, pulled)):
            want = (len(prompt) - 1) // bs * bs
            got = out["usage"]["prompt_tokens_details"]["cached_tokens"]
            if got != want:
                raise AssertionError(f"[kv-plane] pull {i}: cached_tokens "
                                     f"{got}, the import lands {want}")
            _kv_same(f"pull {i}", unified[i], _kv_run(out), band)
        if imports != 16:
            raise AssertionError(f"[kv-plane] pull: {imports} imports, want 16")

        # push and splice (the streamed flow): the prefill hop pushes its
        # blocks to the decode engine, the continuation splices them
        def push(i):
            tid = f"xfer-{i}-{time.monotonic_ns()}"
            pre = _kv_post(p_url, _kv_body(prompts[i], 1, kv_transfer_params={
                "do_remote_decode": True, "push_url": d_url,
                "transfer_id": tid}))
            kv = pre["kv_transfer_params"]
            if not kv.get("pushed"):
                raise AssertionError(f"[kv-plane] push {i} failed")
            first = _kv_run(pre)
            cont = prompts[i] + [ord(first[0])]
            dec = _kv_post(d_url, _kv_body(cont, 63, kv_transfer_params={
                "do_remote_prefill": True, "transfer_id": tid,
                "remote_block_ids": kv["remote_block_ids"],
                "remote_host": p_url}))
            rest = _kv_run(dec)
            return (first[0] + rest[0], first[1] + rest[1]), \
                kv["remote_block_ids"]

        spliced0 = D.engine.spliced_seqs
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            pushed = list(pool.map(push, range(16)))
        spliced = D.engine.spliced_seqs - spliced0
        if spliced != 16:
            raise AssertionError(f"[kv-plane] push: {spliced} splices, "
                                 "want 16 (a re-prefill is a failure)")
        same = [_kv_same(f"push {i}", unified[i], run, band)
                for i, (run, _) in enumerate(pushed)]
        compared = sum(n for n, _ in same)
        log(f"[kv-plane] P->D ({card}): 16 pulls imported (cached_tokens = "
            f"the full blocks), 16 pushes spliced, {compared} tokens equal "
            f"to unified up to near-ties, logprobs within "
            f"{max(w for _, w in same):.4f}")

        # one push alone: a fresh 2048-token prompt, 128 blocks, 64 MiB at
        # llama-3-8b's CUT_LAYERS;
        # the blocks it landed on the decode engine, read before the decode
        # hop attaches them, are bit-identical to the producer's
        before = dict(P.metrics.transfer_totals["push"])
        tid = f"xfer-alone-{time.monotonic_ns()}"
        prompt = rng.integers(0, 256, hi).tolist()
        n_blocks = hi // bs  # the prompt's full blocks
        pre = _kv_post(p_url, _kv_body(prompt, 1, kv_transfer_params={
            "do_remote_decode": True, "push_url": d_url, "transfer_id": tid}))
        after = P.metrics.transfer_totals["push"]
        nbytes = after["bytes"] - before["bytes"]
        secs = after["seconds"] - before["seconds"]
        # the producer's whole table goes: with the block its first decode
        # step would have written (allocated before the prefill resolved)
        src = pre["kv_transfer_params"]["remote_block_ids"]
        want = nbytes_of(P._kv_shape(len(src)), P.config.model.dtype)
        if not pre["kv_transfer_params"].get("pushed") or nbytes != want:
            raise AssertionError(f"[kv-plane] lone push: {nbytes} B, want "
                                 f"{want}")
        with D._kv_lock:
            dst = list(D._kv_transfers[tid]["blocks"])
        a = P.async_engine.run_on_engine(
            lambda e: e.export_kv(src[:n_blocks]))
        b = D.async_engine.run_on_engine(
            lambda e: e.export_kv(dst[:n_blocks]))
        if len(dst) != len(src) or not torch.equal(a.view(torch.int16),
                                                   b.view(torch.int16)):
            raise AssertionError("[kv-plane] lone push: the decode engine's "
                                 "blocks differ from the producer's")
        spliced0 = D.engine.spliced_seqs
        _kv_post(d_url, _kv_body(prompt + [ord(_kv_run(pre)[0][0])], 1,
                                  kv_transfer_params={"transfer_id": tid}))
        if D.engine.spliced_seqs != spliced0 + 1:
            raise AssertionError("[kv-plane] lone push was not spliced")
        # the gather and the scatter alone, as device time (128 blocks)
        runner = D.engine.runner
        idx = torch.arange(0, 2 * n_blocks, 2, device=runner.device)
        gathered = runner.kv.index_select(1, idx)
        gather_ms = time_ms(torch, lambda: runner.kv.index_select(1, idx),
                            20, graph=False)
        scatter_ms = time_ms(torch, lambda: runner.kv.index_copy_(
            1, idx, gathered), 20, graph=False)
        bound = 2 * want / HBM_BYTES_PER_S * 1e3
        log(f"[kv-plane] push of a {hi}-token prompt ({card}): {len(src)} "
            f"blocks, the prompt's {n_blocks} bit-identical on both engines; "
            f"{nbytes} B in "
            f"{secs:.4f} s = {nbytes / secs / 1e9:.3f} GB/s over loopback "
            f"(both servers in this process); device time of the export "
            f"gather {gather_ms:.4f} ms and the import scatter "
            f"{scatter_ms:.4f} ms for {n_blocks} blocks (bound {bound:.4f} ms: "
            f"{want} B read and written at 3.35 TB/s); transfer totals P "
            f"{json.dumps(P.metrics.transfer_totals)}, D "
            f"{json.dumps(D.metrics.transfer_totals)}")
        del gathered, idx, runner
    finally:
        P.shutdown()
        D.shutdown()
    del P, D
    _released(torch, "kv-plane P/D")
    return band, {"push_gb_s": nbytes / secs / 1e9, "gather_ms": gather_ms,
                  "scatter_ms": scatter_ms}


def _kv_tiers(torch, np, card: str, band: float) -> dict:
    """Phase 9, parts 3 and 4: the host tier (A, then B, which evicts A
    from the pool, then A again) and the remote tier (A on one engine,
    then on a fresh one)."""
    from production_stack_tpu_torch.kv_server import KVServer

    bs = 16
    rng = np.random.default_rng(19)
    wave_a = [rng.integers(0, 256, KV_WAVE).tolist() for _ in range(16)]
    wave_b = [rng.integers(0, 256, KV_WAVE).tolist() for _ in range(16)]
    usable = 16 * ((KV_WAVE - 1) // bs)  # the blocks a tier can give A
    # a wave of 16 holds 16 x (KV_WAVE + 16) / bs blocks (1040 at 1024
    # tokens); with 48 more, wave B evicts every chain of A from the pool
    # (1088 blocks) and A's return is the host tier's to serve
    pool = 16 * (KV_WAVE + 16) // bs + 48
    server, base = _kv_server(["--num-blocks", str(pool),
                               "--kv-host-cache-bytes", str(KV_HOST_BYTES)])
    eng = server.engine
    try:
        first, ttft_cold, _ = _kv_wave(base, wave_a, 16, server)
        _kv_wave(base, wave_b, 16, server)
        hits0, blocks0 = eng.host_kv.hits, eng.prefetch_blocks
        again, ttft_host, _ = _kv_wave(base, wave_a, 16, server)
        hits = eng.host_kv.hits - hits0
        committed = eng.prefetch_blocks - blocks0
        if hits < 0.9 * usable or committed < 0.9 * usable:
            raise AssertionError(f"[kv-plane] host tier: {hits} CPU hits, "
                                 f"{committed} blocks committed of {usable}")
        for i in range(16):
            _kv_same(f"host tier {i}", first[i], again[i], band)
        host_stats = eng.tier_stats()
    finally:
        server.shutdown()
    del server, eng
    _released(torch, "kv-plane host tier")

    store = KVServer()
    url = f"http://127.0.0.1:{store.start('127.0.0.1', 0)}"
    try:
        server, base = _kv_server(["--remote-kv-url", url])
        try:
            _kv_wave(base, wave_a, 16, server)
            t_end = time.monotonic() + 120
            while server.engine.remote_kv._pending_puts:
                if time.monotonic() > t_end:
                    raise AssertionError("[kv-plane] remote puts never "
                                         "drained")
                time.sleep(0.05)
        finally:
            server.shutdown()
        del server
        _released(torch, "kv-plane remote writer")
        puts = store.puts
        server, base = _kv_server(["--remote-kv-url", url])
        eng = server.engine
        try:
            fresh, ttft_remote, _ = _kv_wave(base, wave_a, 16, server)
            hits = eng.remote_kv.hits
            if hits < 0.9 * usable or eng.prefetch_blocks < 0.9 * usable:
                raise AssertionError(f"[kv-plane] remote tier: {hits} hits, "
                                     f"{eng.prefetch_blocks} blocks "
                                     f"committed of {usable}")
            for i in range(16):
                _kv_same(f"remote tier {i}", first[i], fresh[i], band)
            remote_stats = eng.tier_stats()
        finally:
            server.shutdown()
        del server, eng
        _released(torch, "kv-plane remote reader")
    finally:
        store.shutdown()
    log(f"[kv-plane] tiers ({card}): " + json.dumps({
        "wave_a": f"16 x {KV_WAVE} tokens, 16 out", "pool_blocks": pool,
        "usable_blocks": usable,
        "ttft_median_s": {"cold": ttft_cold, "warm_host": ttft_host,
                          "warm_remote": ttft_remote},
        "host": {"cpu_hits": host_stats["tiers"]["host"]["hits"],
                 "prefetch": host_stats["prefetch"],
                 "bytes": host_stats["bytes"]},
        "remote": {"puts": puts, "hits": remote_stats["tiers"]["remote"],
                   "prefetch": remote_stats["prefetch"],
                   "bytes": remote_stats["bytes"]}}))
    return {"ttft_cold_s": ttft_cold, "ttft_host_s": ttft_host,
            "ttft_remote_s": ttft_remote}


def kv_plane_phase(torch, np, counters, card: str) -> dict:
    """Phase 9 (``kv-plane``): llama-3-8b bf16 at full width and
    ``CUT_LAYERS`` layers, random weights from seed 0. P->D: a prefill and a decode server, 16
    requests (512-2048 tokens, 64 out) pulled, then pushed and spliced;
    then the host and the remote tier. Returns the phase's launches (K1,
    K2 and K3 must launch, K4 not) and its figures that phase 17 prints
    beside tp 2's."""
    for c in counters:
        c.n = 0
    band, figures = _kv_pd(torch, np, card)
    figures.update(_kv_tiers(torch, np, card, band))
    launches = {c.name.split()[0]: c.n for c in counters}
    _expect(launches, {"K1", "K2", "K3"}, "kv-plane")
    log(f"[kv-plane] launches: {json.dumps(launches)}")
    return {"launches": launches, "figures": figures}


# -- phase 10: the scoring surface --------------------------------------------

# echo entries against the generation's own logprobs, and a near-tie of
# the echo's top-1 against the generated token: a bf16 band, as phase 5's
SCORE_BAND = BF16_LOGPROB_BAND
SCORE_CHOICES = 64


def _sse_events(base: str, path: str, body: dict) -> list:
    """(event name or None, data) of an SSE response, in order."""
    status, _, raw = _http(base, path, body)
    if status != 200:
        raise AssertionError(f"[scoring] {path} stream: {status} {raw[:200]}")
    out = []
    for block in raw.decode().strip().split("\n\n"):
        name, data = None, None
        for line in block.splitlines():
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                d = line[len("data: "):]
                data = d if d == "[DONE]" else json.loads(d)
        out.append((name, data))
    return out


class _RecordedIds:
    """The token ids the server's ``collect`` drains, by request id, while
    in a ``with`` block: the HTTP answer carries text only, and random
    llama-3-8b's ids above 255 decode to nothing."""

    def __init__(self, server):
        self.server = server
        self.ids: dict = {}

    def __enter__(self):
        collect = self.collect = self.server.collect

        def recording(stream, sampling):
            out = collect(stream, sampling)
            self.ids[stream.request_id] = list(out[4])
            return out

        self.server.collect = recording
        return self.ids

    def __exit__(self, *exc):
        self.server.collect = self.collect


def _scored_call(torch, base: str, path: str, body: dict, tag: str,
                 calls: list, limit: int) -> dict:
    """One scoring request over HTTP with its wall time and the device
    memory it allocated above what was allocated before it (the peak
    counter reset first); the peak must stay inside the runner's reserve
    for the scoring path (``limit``)."""
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    status, _, raw = _http(base, path, body)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_bytes
    if status != 200:
        raise AssertionError(f"[scoring] {tag}: {status} {raw[:300]}")
    if peak > limit:
        raise AssertionError(f"[scoring] {tag}: peak {peak} B above the "
                             f"reserve's scoring share {limit} B")
    calls.append({"call": tag, "wall_s": wall, "peak_bytes": peak})
    return json.loads(raw)


def _score_echo(torch, np, base, server, calls, limit) -> tuple:
    """(a): 4 greedy completions (prompts of 256-1024 byte tokens, 32
    out, logprobs 1) one at a time, then each prompt plus its completion
    echoed with max_tokens 0 and logprobs 1. The same 4 completions served
    at once measure the generation path's own deviation under another
    batch (phase 9's rule: the band is SCORE_BAND or twice that, if
    larger). Returns ([(prompt, completion ids, generation logprobs, echo
    logprobs)], band)."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 256, n).tolist() for n in (256, 512, 768,
                                                          1024)]
    with _RecordedIds(server) as ids_of:
        def generate(prompt):
            status, out, _ = _post(base, "/v1/completions", {
                "prompt": prompt, "max_tokens": 32, "temperature": 0,
                "ignore_eos": True, "logprobs": 1})
            comp = ids_of[out["id"]]
            gen = out["choices"][0]["logprobs"]["token_logprobs"]
            if status != 200 or len(comp) != 32 or len(gen) != 32:
                raise AssertionError(f"[scoring] generation: {status}")
            return comp, gen

        alone = [generate(p) for p in prompts]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            batched = list(pool.map(generate, prompts))
    runs = []
    for prompt, (comp, gen) in zip(prompts, alone):
        n = len(prompt)
        echo = _scored_call(torch, base, "/v1/completions", {
            "prompt": prompt + comp, "echo": True, "max_tokens": 0,
            "logprobs": 1}, f"echo {n + 32} tokens", calls, limit)
        lps = echo["choices"][0]["logprobs"]["token_logprobs"]
        if lps[0] is not None or len(lps) != n + 32:
            raise AssertionError(f"[scoring] echo {n}: {len(lps)} entries")
        runs.append((prompt, comp, gen, lps[n:]))
    noise = max(_kv_dev(a, b)[1] for a, b in zip(alone, batched))
    band = max(SCORE_BAND, 2 * noise)
    devs = sorted((abs(a - b) for _, _, gen, lps in runs
                   for a, b in zip(gen, lps)), reverse=True)
    log(f"[scoring] echo against generation: largest deviations "
        f"{[round(d, 4) for d in devs[:6]]}, median {devs[64]:.4f}; the "
        f"generation's own deviation batched 4 at once {noise:.4f}: band "
        f"{band:.4f}")
    if devs[0] > band:
        raise AssertionError(f"[scoring] echo against generation: "
                             f"{devs[0]:.4f} > {band:.4f}")
    # the echo's top-1 at each completion position, read in process
    ties = 0
    for prompt, comp, _, _ in runs:
        entries = server.async_engine.run_on_engine(
            lambda e, ids=prompt + comp: e.prompt_logprobs(ids))
        for j, tok in enumerate(comp):
            lp, top = entries[len(prompt) - 1 + j]
            if top[0][0] != tok:
                if top[0][1] - lp > band:
                    raise AssertionError(
                        f"[scoring] echo top-1 {top[0]} is not the "
                        f"generated {tok} ({lp:.4f})")
                ties += 1
    _scored_call(torch, base, "/v1/completions", {
        "prompt": rng.integers(0, 256, 2048).tolist(), "echo": True,
        "max_tokens": 0, "logprobs": 1}, "echo 2048 tokens, logprobs",
        calls, limit)
    log(f"[scoring] echo: top-1 = the generated token at {128 - ties} of "
        f"128 positions, near-ties within the band at {ties}")
    return runs, band


def _score_choice(torch, np, base, server, calls, limit, runs,
                  band: float) -> None:
    """(b): 64 choices over a 1024-token prompt; the answer is the argmax
    of the engine's choice_logprobs read in process; the greedy completion
    of (a) scored as a choice equals the sum of its echo entries."""
    tk = server.engine.tokenizer
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 256, 1024).tolist()
    choices = [f"option {i} of {SCORE_CHOICES}" for i in range(SCORE_CHOICES)]
    out = _scored_call(torch, base, "/v1/completions", {
        "prompt": prompt, "guided_choice": choices, "temperature": 0},
        f"guided_choice {SCORE_CHOICES} x 1024 tokens", calls, limit)
    text = out["choices"][0]["text"]
    logps = server.async_engine.run_on_engine(lambda e: e.choice_logprobs(
        prompt, [tk.encode(c, add_bos=False) for c in choices]))
    if text != choices[int(np.argmax(logps))]:
        raise AssertionError(f"[scoring] guided_choice {text!r} is not the "
                             "argmax of choice_logprobs")
    worst = 0.0
    for p, comp, _, lps in runs:
        got = server.async_engine.run_on_engine(
            lambda e, p=p, c=comp: e.choice_logprobs(p, [c]))[0]
        worst = max(worst, abs(got - sum(lps)) / len(comp))
    if worst > band:
        raise AssertionError(f"[scoring] completion as a choice: {worst:.4f}"
                             f" a token from its echo sum")
    log(f"[scoring] guided_choice: {text!r} = argmax of {SCORE_CHOICES} "
        f"scores; (a)'s completions as choices within {worst:.5f} a token "
        "of their echo sums")


def _score_embed(torch, np, base, calls, limit, hidden: int) -> None:
    """(c): embeddings at 16, 2048 and 8191 tokens, bit-identical on
    repeat and equal to /pooling's; score against itself; rerank's order
    is the score order."""
    rng = np.random.default_rng(12)
    vecs = {}
    for n in (16, 2048, 8191):
        ids = rng.integers(0, 256, n).tolist()
        a, b = (_scored_call(torch, base, "/v1/embeddings", {"input": ids},
                             f"embedding {n} tokens{tag}", calls, limit)
                for tag in ("", " (repeat)"))
        v = a["data"][0]["embedding"]
        if (len(v) != hidden or not all(np.isfinite(v))
                or v != b["data"][0]["embedding"]):
            raise AssertionError(f"[scoring] embedding {n}: not {hidden} "
                                 "finite floats equal on repeat")
        pooled = _scored_call(torch, base, "/pooling", {"input": ids},
                              f"pooling {n} tokens", calls, limit)
        if pooled["data"][0]["data"] != v:
            raise AssertionError(f"[scoring] /pooling {n} differs")
        vecs[n] = v
    docs = ["the cat sat on the mat", "stock prices fell", "a cat on a mat",
            "rain in spain"]
    score = _scored_call(torch, base, "/v1/score", {
        "text_1": docs[0], "text_2": docs}, "score 1 x 4", calls, limit)
    scores = [d["score"] for d in score["data"]]
    if scores[0] < 0.999:
        raise AssertionError(f"[scoring] self score {scores[0]}")
    rr = _scored_call(torch, base, "/v1/rerank", {
        "query": docs[0], "documents": docs}, "rerank 4", calls, limit)
    order = [r["index"] for r in rr["results"]]
    if order != sorted(range(4), key=lambda i: -scores[i]):
        raise AssertionError(f"[scoring] rerank order {order}, scores "
                             f"{scores}")
    log(f"[scoring] embeddings 16/2048/8191 tokens: {hidden} finite floats, "
        f"bit-identical on repeat and through /pooling; self score "
        f"{scores[0]:.6f}; rerank order {order} = score order")


def _score_apis(base: str) -> None:
    """(d): one greedy message through chat, Messages and Responses gives
    one text; each stream concatenates to its JSON text, its events in the
    reference's order. A first request puts the prompt's blocks in the
    prefix cache, so every later one computes the same tail. Printable
    byte tokens only, so the text is the tokens."""
    text = "list the planets of the solar system in order " * 4
    msgs = [{"role": "user", "content": text}]
    greedy = {"temperature": 0, "ignore_eos": True,
              "allowed_token_ids": KV_ALLOWED}
    _post(base, "/v1/chat/completions", {"messages": msgs, "max_tokens": 32,
                                         **greedy})
    _, chat, _ = _post(base, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 32, **greedy})
    want = chat["choices"][0]["message"]["content"]
    _, msg, _ = _post(base, "/v1/messages", {"messages": msgs,
                                             "max_tokens": 32, **greedy})
    _, resp, _ = _post(base, "/v1/responses", {
        "input": msgs, "max_output_tokens": 32, **greedy})
    texts = {"messages": msg["content"][0]["text"],
             "responses": resp["output"][0]["content"][0]["text"]}
    ev = _sse_events(base, "/v1/messages", {"messages": msgs,
                                            "max_tokens": 32, "stream": True,
                                            **greedy})
    names = [n for n, _ in ev]
    deltas = [n for n in names if n == "content_block_delta"]
    if names != (["message_start", "content_block_start"] + deltas
                 + ["content_block_stop", "message_delta", "message_stop"]):
        raise AssertionError(f"[scoring] messages events {names}")
    texts["messages stream"] = "".join(
        d["delta"]["text"] for n, d in ev if n == "content_block_delta")
    ev = _sse_events(base, "/v1/responses", {
        "input": msgs, "max_output_tokens": 32, "stream": True, **greedy})
    names = [n for n, _ in ev]
    deltas = [n for n in names if n == "response.output_text.delta"]
    if (names != ["response.created", "response.output_item.added"]
            + deltas + ["response.output_text.done", "response.completed"]
            or [d["sequence_number"] for _, d in ev] != list(
                range(len(ev)))):
        raise AssertionError(f"[scoring] responses events {names}")
    texts["responses stream"] = "".join(
        d["delta"] for n, d in ev if n == "response.output_text.delta")
    ev = _sse_events(base, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 32, "stream": True, **greedy})
    texts["chat stream"] = "".join(
        d["choices"][0]["delta"].get("content", "") for _, d in ev[:-1]
        if d["choices"])
    bad = {k: v for k, v in texts.items() if v != want}
    if bad:
        raise AssertionError(f"[scoring] chat text {want!r}, others {bad}")
    if len(want) != 32:
        raise AssertionError(f"[scoring] chat text {want!r}: not 32 chars")
    log(f"[scoring] chat, messages and responses (JSON and SSE) give one "
        f"greedy text, {want!r}; events in the reference's order")


def _score_sleep(torch, base, server, eng, runs) -> dict:
    """(e): a sleep with a stream in flight answers 409; level 1 frees the
    pool, level 2 the weights too; after each wake (a)'s first request
    gives the same tokens."""
    import http.client

    prompt, comp = runs[0][0], runs[0][1]

    def again(ids_of) -> list:
        _, out, _ = _post(base, "/v1/completions", {
            "prompt": prompt, "max_tokens": 32, "temperature": 0,
            "ignore_eos": True, "logprobs": 1})
        return ids_of[out["id"]]

    u = urllib.parse.urlsplit(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    # printable tokens only: each step streams text, so the first chunk
    # arrives while the request is in flight
    conn.request("POST", "/v1/completions", json.dumps({
        "prompt": prompt, "max_tokens": 256, "temperature": 0,
        "ignore_eos": True, "stream": True,
        "allowed_token_ids": KV_ALLOWED}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    first = resp.read(6)
    status, _, body = _http(base, "/sleep", {})
    rest = resp.read()
    conn.close()
    if first != b"data: " or status != 409 or not rest.rstrip().endswith(
            b"data: [DONE]"):
        raise AssertionError(f"[scoring] sleep with a stream in flight: "
                             f"{status} {body[:200]}")
    pool = eng.runner.kv.numel() * eng.runner.kv.element_size()
    weights = sum(t.numel() * t.element_size()
                  for t in _leaves(eng.runner.params))
    out = {"pool_bytes": pool, "weight_bytes": weights}
    with _RecordedIds(server) as ids_of:
        for level, need in ((1, 0.95 * pool), (2, pool + weights)):
            torch.cuda.synchronize()
            free0 = torch.cuda.mem_get_info()[0]
            t0 = time.perf_counter()
            status, _, body = _http(base, f"/sleep?level={level}", {})
            t_sleep = time.perf_counter() - t0
            freed = torch.cuda.mem_get_info()[0] - free0
            held = {"allocated": torch.cuda.memory_allocated(),
                    "reserved": torch.cuda.memory_reserved()}
            _, _, asleep = _http(base, "/is_sleeping")
            if (status != 200 or freed < need
                    or json.loads(asleep) != {"is_sleeping": True}):
                segs = [(sg["total_size"], [b["size"] for b in sg["blocks"]
                                            if b["state"] == "active_allocated"])
                        for sg in torch.cuda.memory_snapshot()]
                raise AssertionError(
                    f"[scoring] sleep level {level}: {status}, {freed} B "
                    f"freed of {need}; asleep {held}; segments "
                    f"{sorted(segs, reverse=True)[:12]}")
            t0 = time.perf_counter()
            status, _, _ = _http(base, "/wake_up", {})
            t_wake = time.perf_counter() - t0
            toks = again(ids_of)
            if status != 200 or toks != comp:
                raise AssertionError(f"[scoring] after the level-{level} "
                                     f"wake the tokens differ")
            out[f"level{level}"] = {"freed_bytes": freed, "sleep_s": t_sleep,
                                    "wake_s": t_wake, "asleep": held}
    log(f"[scoring] sleep: a stream in flight -> 409; " + json.dumps(out)
        + "; (a)'s first request gives its tokens after each wake")
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def scoring_phase(torch, np, counters, card: str) -> dict:
    """Phase 10 (``scoring-surface``): llama-3-8b bf16 at full width and
    ``CUT_LAYERS`` of its layers, random weights from seed 0, default
    scheduler, pool at 0.9.
    (a) echo against generation, (b) a 64-choice guided_choice, (c)
    embeddings, pooling, score and rerank, (d) chat, Messages and
    Responses, (e) sleep at levels 1 and 2. Returns the phase's launches
    (K1, K2 and K3 launch, K4 not)."""
    from production_stack_tpu_torch.engine.server import (
        EngineServer,
        build_parser,
        config_from_args,
    )

    cfg = _cut_depth(config_from_args(build_parser().parse_args(
        ["--model", "llama-3-8b", "--seed", "0"])))
    t0 = time.perf_counter()
    server = EngineServer(cfg, device="cuda")
    base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    eng = server.engine
    limit = eng.runner.score_bytes()
    log(f"[scoring] llama-3-8b up in {time.perf_counter() - t0:.1f} s: "
        f"{eng.runner.num_blocks} KV blocks; reserve beside the pool "
        f"{eng.runner._transient_bytes()} B, of which the scoring path's "
        f"peak bound {limit} B")
    calls: list = []
    t_phase = time.perf_counter()
    try:
        for c in counters:
            c.n = 0
        runs, band = _score_echo(torch, np, base, server, calls, limit)
        _score_choice(torch, np, base, server, calls, limit, runs, band)
        _score_embed(torch, np, base, calls, limit, cfg.model.hidden_size)
        _score_apis(base)
        sleep = _score_sleep(torch, base, server, eng, runs)
        launches = {c.name.split()[0]: c.n for c in counters}
    finally:
        server.shutdown()
    del server, eng
    _released(torch, "scoring-surface")
    _expect(launches, {"K1", "K2", "K3"}, "scoring-surface")
    log(f"[scoring] ({card}) in {time.perf_counter() - t_phase:.1f} s: "
        + json.dumps({"calls": calls, "sleep": sleep, "launches": launches}))
    return launches


# -- phase 11: Whisper ------------------------------------------------------

# (c)'s max_tokens a request (64 until PR 18)
WHISPER_MAX_TOKENS = 32
WHISPER_CLIPS = ((5.0, 16000), (12.0, 44100), (30.0, 16000), (5.0, 44100),
                 (12.0, 16000), (30.0, 44100), (5.0, 16000), (12.0, 44100))
WHISPER_FORMATS = ("json", "text", "verbose_json", "srt", "vtt",
                   "verbose_json", "srt", "json")
# "HH:MM:SS,mmm --> HH:MM:SS,mmm" (srt) or with "." (vtt)
_CUE = re.compile(r"^(\d\d):(\d\d):(\d\d)[,.](\d{3}) --> "
                  r"(\d\d):(\d\d):(\d\d)[,.](\d{3})$", re.M)


def _wav(np, seconds: float, rate: int, kind: str = "tone",
         channels: int = 1, seed: int = 0) -> bytes:
    """16-bit PCM WAV bytes from a seed: a 440 Hz tone with a little
    noise, noise, or silence."""
    import io
    import wave

    n = int(rate * seconds)
    rng = np.random.default_rng(seed)
    if kind == "tone":
        x = 0.5 * np.sin(2 * np.pi * 440.0 * np.arange(n) / rate) + \
            0.05 * rng.standard_normal(n)
    elif kind == "noise":
        x = rng.uniform(-0.5, 0.5, n)
    else:
        x = np.zeros(n)
    frames = np.repeat((np.clip(x, -1, 1) * 20000).astype(np.int16)[:, None],
                       channels, axis=1)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(frames.tobytes())
    return buf.getvalue()


def _form(wav: bytes, **fields) -> tuple:
    """(multipart body, content type) with a ``file`` part and ``fields``."""
    b = "chipSmokeBoundary"
    out = b"".join(
        f'--{b}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
        f"{v}\r\n".encode() for k, v in fields.items())
    out += (f'--{b}\r\nContent-Disposition: form-data; name="file"; '
            f'filename="clip.wav"\r\nContent-Type: audio/wav\r\n\r\n'
            ).encode() + wav + f"\r\n--{b}--\r\n".encode()
    return out, f"multipart/form-data; boundary={b}"


def _post_form(port: int, path: str, body: bytes, ctype: str):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": ctype})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type") or "", r.read()
    finally:
        conn.close()


def _whisper_gap(torch, cpu, feats, kw, prefix) -> float:
    """The CPU run's top-2 logprob gap of the suppressed logits after
    ``prefix``: how near a tie the step where two runs part was."""
    from production_stack_tpu_torch.models import whisper as W

    cfg = cpu.cfg
    ck, cv = cpu._encode(feats)
    lang = kw.get("language") or cpu._language_of(cpu._sot_logits(ck, cv))
    ts = kw.get("timestamps", False)
    toks = cpu._forced_tokens(lang, kw.get("task", "transcribe"),
                              kw.get("prompt"), timestamps=ts) + prefix
    logits, _ = W.decode_tokens(cfg, cpu.params, torch.tensor([toks]), [0],
                                W.init_self_kv(cfg, 1, cfg.max_model_len),
                                ck, cv, [len(toks)])
    run = 0
    for t in prefix:
        run = run + 1 if t > cfg.notimestamps_id else 0
    lp = torch.log_softmax(cpu._suppress(
        logits[0, -1], sum(t < cfg.eot_id for t in prefix), ts,
        max([t for t in prefix if t > cfg.notimestamps_id], default=0),
        run), -1)
    top = lp.topk(2).values
    return float(top[0] - top[1])


def _whisper_card_vs_cpu(torch, np) -> dict:
    """(a) float32 tiny-whisper, the same weights on the card and on the
    CPU: three clips, each transcribed with language detection,
    translated, in timestamp mode and with a prompt. Tokens equal up to
    printed near-ties, the language equal, no_speech_prob within 1e-4."""
    from production_stack_tpu_torch.engine import audio
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.weights import to_device
    from production_stack_tpu_torch.engine.whisper_runner import (
        WhisperRunner,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = EngineConfig.for_model("tiny-whisper")
    cpu = WhisperRunner(cfg, device="cpu")
    card = WhisperRunner(cfg, device="cuda",
                         params=to_device(cpu.params, "cuda"))
    clips = {"tone-8k": _wav(np, 0.5, 8000, seed=1),
             "noise-44.1k-stereo": _wav(np, 0.7, 44100, "noise", 2, seed=2),
             "silence-16k": _wav(np, 0.3, 16000, "silence")}
    modes = {"detect": {}, "translate": dict(language="en",
                                             task="translate"),
             "timestamps": dict(language="en", timestamps=True),
             "prompt": dict(language="en", prompt="a conditioning prompt")}
    tokens, ties, worst_nsp, worst_lp = 0, [], 0.0, 0.0
    for clip, wav in clips.items():
        feats = audio.wav_to_features(wav, cfg.model.num_mel_bins,
                                      cpu.chunk_frames)[0]
        for mode, kw in modes.items():
            want_info, got_info = {}, {}
            want = cpu.transcribe(feats, info=want_info, **kw)
            got = card.transcribe(feats, info=got_info, **kw)
            n = len(want)
            for i, (a, b) in enumerate(zip(want, got)):
                if a != b:
                    gap = _whisper_gap(torch, cpu, feats, kw, want[:i])
                    ties.append({"clip": clip, "mode": mode, "step": i,
                                 "cpu": a, "card": b, "gap": gap})
                    if gap >= TIE_GAP:
                        raise AssertionError(
                            f"[whisper] (a) {clip} {mode}: card and CPU "
                            f"part at step {i} ({a} vs {b}), gap {gap}")
                    n = i
                    break
            else:
                if got != want:
                    raise AssertionError(f"[whisper] (a) {clip} {mode}: "
                                         f"{len(got)} tokens vs {len(want)}")
            if got_info["language"] != want_info["language"]:
                raise AssertionError(f"[whisper] (a) {clip}: language "
                                     f"{got_info['language']} vs "
                                     f"{want_info['language']}")
            nsp = abs(got_info["no_speech_prob"]
                      - want_info["no_speech_prob"])
            lp = max((abs(x - y) for x, y in zip(
                got_info["logprobs"][:n], want_info["logprobs"][:n])),
                default=0.0)
            if nsp > 1e-4 or lp > 1e-4:
                raise AssertionError(f"[whisper] (a) {clip} {mode}: "
                                     f"no_speech_prob off by {nsp}, "
                                     f"logprob by {lp}")
            tokens += n
            worst_nsp, worst_lp = max(worst_nsp, nsp), max(worst_lp, lp)
    out = {"runs": len(clips) * len(modes), "tokens_compared": tokens,
           "near_ties": ties, "max_no_speech_prob_diff": worst_nsp,
           "max_logprob_diff": worst_lp}
    log(f"[whisper] (a) float32 tiny-whisper, card = CPU: {json.dumps(out)}")
    return out


def _whisper_bf16_vs_f32(torch, np) -> dict:
    """(b) whisper-large-v3-class, seed-0 weights made in float32 on the
    card and cast to bf16: the SOT-position logits' cosine (> 0.99) and
    the encoder output's relative error, on one 12 s clip."""
    import dataclasses

    from production_stack_tpu_torch.engine import audio
    from production_stack_tpu_torch.engine.config import ModelConfig
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.models import whisper as W

    torch.backends.cudnn.allow_tf32 = False
    cfg32 = ModelConfig.from_pretrained("whisper-large-v3-class",
                                        dtype="float32")
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    p32 = init_random(cfg32, seed=0, device="cuda")

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.bfloat16()
                for k, v in tree.items()}

    p16 = cast(p32)
    feats = audio.wav_to_features(_wav(np, 12.0, 16000, seed=5), 128,
                                  3000)[0]
    mel = torch.as_tensor(feats, device="cuda")[None]
    outs = {}
    for name, cfg, params in (("f32", cfg32, p32), ("bf16", cfg16, p16)):
        with torch.no_grad():
            enc = W.encode(cfg, params, mel)
            ck, cv = W.cross_kv(cfg, params, enc)
            toks = torch.tensor([[cfg.sot_id]], device="cuda")
            logits, _ = W.decode_tokens(
                cfg, params, toks, [0],
                W.init_self_kv(cfg, 1, cfg.max_model_len, "cuda"), ck, cv,
                [1])
        outs[name] = (enc.float(), logits[0, 0].float())
        del ck, cv
    (e32, l32), (e16, l16) = outs["f32"], outs["bf16"]
    cos = float(torch.nn.functional.cosine_similarity(l32, l16, dim=0))
    rel = float((e16 - e32).norm() / e32.norm())
    out = {"sot_logit_cosine": cos, "encoder_rel_err": rel,
           "argmax_equal": int(l32.argmax()) == int(l16.argmax())}
    del p32, p16, outs, e32, e16
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[whisper] (b) whisper-large-v3-class bf16 vs float32: "
        f"{json.dumps(out)}")
    if not cos > 0.99 or not np.isfinite(rel):
        raise AssertionError(f"[whisper] (b) bf16 against float32: {out}")
    return out


def _whisper_numbers(torch, np, runner, card: str) -> dict:
    """(d) on the served runner: encode + cross K/V device time a clip
    (CUDA events) beside its FLOP bound; a traced 32-token decode chunk
    (wall and device time a token, kernels a token, idle share) beside
    its byte bound; device memory an admitted request holds."""
    from production_stack_tpu_torch.engine import audio
    from production_stack_tpu_torch.engine import whisper_runner as WR

    cfg = runner.cfg
    E, F, H, D, L = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                     cfg.head_dim, cfg.num_layers)
    S, T = cfg.n_audio_ctx, 2 * cfg.n_audio_ctx
    feats = audio.wav_to_features(_wav(np, 30.0, 16000, seed=6),
                                  cfg.num_mel_bins, runner.chunk_frames)[0]
    with torch.no_grad():
        enc_ms = []
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ck, cv = runner._encode(feats)
            end.record()
            end.synchronize()
            enc_ms.append(start.elapsed_time(end))
        enc_ms = statistics.median(enc_ms[1:])
        enc_wall, enc_busy, enc_cats, enc_kernels, _ = _profiled(
            torch, lambda: runner._encode(feats))
        # FLOPs: two convs, the encoder layers (projections, MLP,
        # attention), every decoder layer's cross K and V
        enc_flops = (2 * T * 3 * cfg.num_mel_bins * E + 2 * S * 3 * E * E
                     + cfg.encoder_layers * (8 * S * E * E + 4 * S * E * F
                                             + 4 * H * S * S * D)
                     + L * 4 * S * E * E)
        enc_bound, enc_by = bound(
            2 * (cfg.encoder_layers * (4 * E * E + 2 * E * F)
                 + L * 2 * E * E) + 2 * 2 * L * S * E, enc_flops, BF16_FLOPS)
        forced = runner._forced_tokens("en", "transcribe", None)
        P = runner._bucket(len(forced))
        kv, last = runner._dec_prefill(ck, cv, forced + [0] * (P - len(forced)),
                                       len(forced))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        st = WR._Decode(kv=kv, logits=last, cur=len(forced), gen=gen)
        runner._chunk(st, ck, cv, cfg.max_model_len, 0.0, False)  # warm
        n = WR.DECODE_CHUNK
        t0 = time.perf_counter()
        toks, _, _ = runner._chunk(st, ck, cv, st.cur + n + 1, 0.0, False)
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) * 1e3 / len(toks)
        box = {}
        wall, busy, cats, kernels, _ = _profiled(torch, lambda: box.update(
            toks=runner._chunk(st, ck, cv, st.cur + n + 1, 0.0, False)[0]))
        n_tok = len(box["toks"])
    # bytes a token must read: the decoder's weights the step touches
    # (self attention, cross Q and O, MLP, the tied head), the cross K/V
    # and the self K/V up to the context
    params = L * (6 * E * E + 2 * E * F) + cfg.vocab_size * E
    dec_bytes = 2 * params + 2 * 2 * L * S * E + 2 * 2 * L * st.cur * E
    # a product per weight, and attention over the cross and self keys
    dec_flops = 2 * params + 4 * L * H * D * (S + st.cur)
    dec_bound, dec_by = bound(dec_bytes, dec_flops, BF16_FLOPS)
    del ck, cv, kv, last, st
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    stream = runner.transcribe_stream(feats, language="en", max_tokens=40)
    next(stream)
    held = torch.cuda.memory_allocated() - base
    stream.close()
    gc.collect()
    left = torch.cuda.memory_allocated() - base
    want = 2 * 2 * L * S * E + 2 * 2 * L * cfg.max_model_len * E
    out = {
        "encode_cross_kv_ms": enc_ms, "encode_bound_ms": enc_bound,
        "encode_bound_by": enc_by, "encode_tflop": enc_flops / 1e12,
        "encode_share_of_bound": enc_bound / enc_ms,
        "encode_traced": {
            "wall_ms": enc_wall, "kernels": enc_kernels,
            "device_busy_ms": (enc_busy if enc_busy is not None
                               else "not measured"),
            "device_ms_by_class": dict(sorted(enc_cats.items()))},
        "decode_tokens": n_tok,
        "decode_wall_ms_per_token_untraced": untraced,
        "decode_wall_ms_per_token_traced": wall / n_tok,
        "decode_device_ms_per_token": (busy / n_tok if busy is not None
                                       else "not measured"),
        "decode_idle_share": (1.0 - busy / wall if busy is not None
                              else "not measured"),
        "decode_kernels_per_token": kernels / n_tok,
        "decode_device_ms_by_class_per_token": {
            c: v / n_tok for c, v in sorted(cats.items())},
        "decode_bound_ms_per_token": dec_bound, "decode_bound_by": dec_by,
        "decode_bytes_per_token": dec_bytes,
        "request_bytes_held": held, "request_bytes_expected": want,
        "request_bytes_left_after_close": left,
    }
    log(f"[whisper] (d) numbers ({card}): {json.dumps(out)}")
    if left > 16 * 2**20:
        raise AssertionError(f"[whisper] (d) a closed request left {left} "
                             "bytes on the card")
    if held < want:
        raise AssertionError(f"[whisper] (d) an admitted request holds "
                             f"{held} bytes, under its K/V's {want}")
    return out


def _whisper_http(torch, np, server, port: int) -> dict:
    """(c) the served whisper-large-v3-class over HTTP: a wave of 8
    concurrent requests (every format, transcribe and translate, 5-30 s
    clips at 16 and 44.1 kHz, ``WHISPER_MAX_TOKENS``); one SSE stream read to
    [DONE]; one left after its headers (an abort, its slot back, then a
    burst of 4); the 400 and 404 and the model card."""
    clips = [(_wav(np, s, r, seed=10 + i), s)
             for i, (s, r) in enumerate(WHISPER_CLIPS)]

    def one(i):
        wav, _ = clips[i]
        fields = dict(model="whisper-large-v3-class",
                      max_tokens=str(WHISPER_MAX_TOKENS),
                      response_format=WHISPER_FORMATS[i])
        if i % 3:
            fields["language"] = "en"
        path = ("/v1/audio/translations" if i % 2
                else "/v1/audio/transcriptions")
        t0 = time.perf_counter()
        status, ctype, body = _post_form(port, path, *_form(wav, **fields))
        return i, status, ctype, body, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        wave = list(pool.map(one, range(8)))
    wave_s = time.perf_counter() - t0
    tokens = []
    for i, status, ctype, body, _ in wave:
        fmt = WHISPER_FORMATS[i]
        if status != 200:
            raise AssertionError(f"[whisper] (c) request {i} ({fmt}): "
                                 f"{status} {body[:300]!r}")
        text = body.decode()
        if fmt == "verbose_json":
            out = json.loads(text)
            n = sum(len(s["tokens"]) for s in out["segments"])
            if n > WHISPER_MAX_TOKENS or any(s["start"] > s["end"]
                             for s in out["segments"]):
                raise AssertionError(f"[whisper] (c) verbose_json {i}: "
                                     f"{n} tokens, {out['segments'][:3]}")
            if abs(out["duration"] - clips[i][1]) > 0.01:
                raise AssertionError(f"[whisper] (c) duration {out}")
            tokens.append(n)
        elif fmt in ("srt", "vtt"):
            if fmt == "vtt" and not text.startswith("WEBVTT\n\n"):
                raise AssertionError(f"[whisper] (c) vtt {i}: {text[:80]!r}")
            for c in _CUE.findall(text):
                a = int(c[0]) * 3600 + int(c[1]) * 60 + int(c[2]) \
                    + int(c[3]) / 1e3
                b = int(c[4]) * 3600 + int(c[5]) * 60 + int(c[6]) \
                    + int(c[7]) / 1e3
                if a > b:
                    raise AssertionError(f"[whisper] (c) {fmt} cue {c}")
        elif fmt == "json" and "text" not in json.loads(text):
            raise AssertionError(f"[whisper] (c) json {i}: {text[:200]!r}")
    lat = sorted(w[4] for w in wave)
    # one SSE stream to the end
    body, ctype = _form(clips[0][0], language="en", stream="true",
                        max_tokens=str(WHISPER_MAX_TOKENS))
    status, _, sse = _post_form(port, "/v1/audio/transcriptions", body,
                                ctype)
    events = [ln for ln in sse.decode().split("\n")
              if ln.startswith("data: ")]
    if status != 200 or events[-1] != "data: [DONE]":
        raise AssertionError(f"[whisper] (c) SSE: {status} {events[-3:]}")
    # one SSE stream left after its headers: an abort, its slot back
    scraped = parse_exposition(_http(f"http://127.0.0.1:{port}",
                                     "/metrics")[2].decode())
    key = ("pstpu_transcription_aborted_requests_total",
           (("endpoint", "audio.transcribe"),))
    aborted0 = scraped.get(key, 0.0)
    body, ctype = _form(clips[2][0], language="en", stream="true")
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    sock.sendall((f"POST /v1/audio/transcriptions HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Type: {ctype}\r\nContent-Length: {len(body)}"
                  "\r\n\r\n").encode() + body)
    head = b""
    while b"\r\n\r\n" not in head:
        head += sock.recv(4096)
    sock.close()
    t_end = time.monotonic() + 120
    aborted = aborted0
    while aborted == aborted0 and time.monotonic() < t_end:
        time.sleep(0.1)
        aborted = parse_exposition(_http(
            f"http://127.0.0.1:{port}", "/metrics")[2].decode()).get(
                key, 0.0)
    if aborted != aborted0 + 1 or not head.startswith(b"HTTP/1.1 200"):
        raise AssertionError(f"[whisper] (c) abort: {head[:40]!r}, "
                             f"aborted {aborted0} -> {aborted}")
    slots = [server.runner.admit.acquire(blocking=False) for _ in range(4)]
    for s in slots:
        if s:
            server.runner.admit.release()
    if not all(slots):
        raise AssertionError(f"[whisper] (c) slots after the abort: {slots}")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        burst = list(pool.map(one, (0, 2, 4, 6)))
    if any(b[1] != 200 for b in burst):
        raise AssertionError(f"[whisper] (c) burst: {[b[1] for b in burst]}")
    # refusals before any device work, and the router's surface
    encodes = []
    encode = server.runner._encode
    server.runner._encode = lambda f: encodes.append(1) or encode(f)
    try:
        status, _, bad = _post_form(port, "/v1/audio/transcriptions",
                                    *_form(clips[0][0], language="klingon",
                                           stream="true"))
    finally:
        server.runner._encode = encode
    if status != 400 or encodes:
        raise AssertionError(f"[whisper] (c) bad language: {status} "
                             f"{bad[:200]!r}, {len(encodes)} encodes")
    status, _, _ = _http(f"http://127.0.0.1:{port}", "/v1/completions",
                         {"prompt": "hi", "max_tokens": 2})
    card = json.loads(_http(f"http://127.0.0.1:{port}",
                            "/v1/models")[2])["data"][0]
    if status != 404 or card["capabilities"] != ["audio.transcriptions",
                                                 "audio.translations"]:
        raise AssertionError(f"[whisper] (c) surface: {status} {card}")
    out = {"wave_requests": 8, "wave_s": wave_s, "clips_per_s": 8 / wave_s,
           "latency_median_s": statistics.median(lat),
           "latency_max_s": lat[-1], "verbose_json_tokens": tokens,
           "sse_events": len(events), "aborted": aborted - aborted0,
           "burst_latency_s": [b[4] for b in burst]}
    log(f"[whisper] (c) HTTP: {json.dumps(out)}")
    return out


def whisper_phase(torch, np, counters, card: str) -> dict:
    """Phase 11 (``whisper``): (a) float32 tiny-whisper card = CPU; (b)
    whisper-large-v3-class bf16 against float32; (c) whisper-large-v3-class
    in bf16 at ``CUT_LAYERS`` served over HTTP with ``--max-num-seqs 4``;
    (d) its numbers.
    Returns the launches of the served path: K1-K4 all 0 (Whisper reaches
    none of them)."""
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        server_from_args,
    )

    t_phase = time.perf_counter()
    _whisper_card_vs_cpu(torch, np)
    _whisper_bf16_vs_f32(torch, np)
    t0 = time.perf_counter()
    with _CutServers():
        server = server_from_args(build_parser().parse_args(
            ["--model", "whisper-large-v3-class", "--max-num-seqs", "4",
             "--seed", "0"]))
    port = server.start("127.0.0.1", 0)
    log(f"[whisper] whisper-large-v3-class at {CUT_LAYERS} layers up in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    try:
        for c in counters:
            c.n = 0
        _whisper_http(torch, np, server, port)
        launches = {c.name.split()[0]: c.n for c in counters}
        _whisper_numbers(torch, np, server.runner, card)
    finally:
        server.shutdown()
    del server
    _released(torch, "whisper")
    _expect(launches, set(), "whisper")
    log(f"[whisper] ({card}) in {time.perf_counter() - t_phase:.1f} s: "
        + json.dumps({"launches": launches}))
    return launches

# -- phase 12: resilience, overload and tenants ------------------------------

OV_FLOOR = 1.0  # --overload-retry-after's default: the Retry-After floor


def _ov_call(base: str, path: str, body=None, headers=None,
             timeout: float = 600):
    """(status, headers, bytes, seconds to the response headers, seconds
    to the end) of a GET, or a POST of ``body``; an error status is
    returned, not raised."""
    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            t_head = time.perf_counter() - t0
            data = r.read()
            return r.status, dict(r.headers), data, t_head, \
                time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        t_head = time.perf_counter() - t0
        return e.code, dict(e.headers), e.read(), t_head, \
            time.perf_counter() - t0


def _ov_stream(base: str, body: dict, headers=None) -> tuple:
    """A streamed completion: (status, events, seconds to the first data
    event); ``events`` are the parsed data payloads, "[DONE]" last."""
    req = urllib.request.Request(
        base + "/v1/completions", data=json.dumps(
            dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    events, first = [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if first is None:
                first = time.perf_counter() - t0
            data = line[len("data: "):]
            events.append(data if data == "[DONE]" else json.loads(data))
            if data == "[DONE]":
                break
        return r.status, events, first


def _ov_metrics(base: str) -> dict:
    status, headers, body, _, _ = _ov_call(base, "/metrics")
    if status != 200:
        raise AssertionError(f"[overload] /metrics answered {status}")
    return parse_exposition(body.decode())


def _ov_sample(samples: dict, name: str, **labels) -> float:
    for (n, lbl), v in samples.items():
        if n == name and all(dict(lbl).get(k) == v2
                             for k, v2 in labels.items()):
            return v
    return 0.0


def _ov_json(base: str, path: str, body=None) -> dict:
    status, _, data, _, _ = _ov_call(base, path, body)
    if status != 200:
        raise AssertionError(f"[overload] {path} answered {status}: "
                             f"{data[:200]!r}")
    return json.loads(data)


def _ov_deadlines(base: str, counters) -> dict:
    """(a) An expired x-request-deadline: 504 before admission, no kernel
    launched for it; a malformed one: 200; one 0.5 s out on a 2000-token
    request, plain and streamed: 504 (in-band error then [DONE] when
    streamed), one abort counted, the free blocks back."""
    model = "llama-3-8b"
    out = {}
    before = [c.n for c in counters]
    status, _, data, _, _ = _ov_call(base, "/v1/completions", {
        "model": model, "prompt": list(range(10, 74)), "max_tokens": 4},
        {"x-request-deadline": f"{time.time() - 1:.3f}"})
    err = json.loads(data)
    if status != 504 or err["error"]["type"] != "timeout_error":
        raise AssertionError(f"[overload] expired deadline: {status} {err}")
    if [c.n for c in counters] != before:
        raise AssertionError("[overload] an expired request launched "
                             "kernels")
    status, _, data, _, _ = _ov_call(base, "/v1/completions", {
        "model": model, "prompt": list(range(10, 74)), "max_tokens": 4,
        "temperature": 0.0, "ignore_eos": True},
        {"x-request-deadline": "soon-ish"})
    if status != 200 or json.loads(data)["usage"]["completion_tokens"] != 4:
        raise AssertionError(f"[overload] malformed deadline: {status}")
    body = {"model": model, "prompt": list(range(20, 84)),
            "max_tokens": 2000, "temperature": 0.0, "ignore_eos": True,
            "allowed_token_ids": KV_ALLOWED}
    for stream in (False, True):
        m0 = _ov_metrics(base)
        aborted0 = _ov_sample(m0, "vllm:aborted_seqs_total")
        free0 = _ov_sample(m0, "vllm:kv_blocks_free")
        deadline = time.time() + 0.5
        hdr = {"x-request-deadline": f"{deadline:.6f}"}
        if stream:
            status, events, _ = _ov_stream(base, body, hdr)
            answered = time.time()
            chunks = [e for e in events[:-2] if "choices" in e]
            if (status != 200 or events[-1] != "[DONE]"
                    or events[-2].get("error", {}).get("type")
                    != "timeout_error" or not chunks):
                raise AssertionError(f"[overload] streamed deadline: "
                                     f"{status} {events[-3:]}")
            n_chunks = len(chunks)
        else:
            status, _, data, _, _ = _ov_call(base, "/v1/completions", body,
                                             hdr)
            answered = time.time()
            if status != 504 or json.loads(data)["error"]["type"] != \
                    "timeout_error":
                raise AssertionError(f"[overload] mid-generation deadline: "
                                     f"{status} {data[:200]!r}")
            n_chunks = None
        m1 = _ov_metrics(base)
        aborted = _ov_sample(m1, "vllm:aborted_seqs_total") - aborted0
        free = _ov_sample(m1, "vllm:kv_blocks_free")
        if aborted != 1 or free != free0:
            raise AssertionError(
                f"[overload] deadline abort (stream={stream}): aborted "
                f"+{aborted}, free blocks {free0} -> {free}")
        out["stream" if stream else "plain"] = {
            "answer_after_deadline_s": answered - deadline,
            "aborted_delta": aborted, "kv_blocks_free": free,
            **({"data_events": n_chunks} if stream else {})}
    return out


def _ov_queue_bound(np, base: str) -> dict:
    """(b) 32 concurrent ignore_eos requests (256 tokens out) against
    --max-queue-len 4 --max-num-seqs 8: 12 at once fill the slots and the
    queue, 20 more follow 0.13 s apart while the queue stays full. Some
    answers are 429 with Retry-After >= the floor, the rest 200; once the
    queue has drained, some 429 advertised more than the floor (the
    queue's depth over its measured drain rate)."""
    rng = np.random.default_rng(21)
    bodies = [{"model": "llama-3-8b", "prompt": rng.integers(
        0, 256, 128).tolist(), "max_tokens": 256, "ignore_eos": True,
        "temperature": 0.0} for _ in range(32)]

    def one(i):
        time.sleep(0.13 * max(i - 11, 0))
        return _ov_call(base, "/v1/completions", bodies[i])

    with concurrent.futures.ThreadPoolExecutor(32) as pool:
        res = list(pool.map(one, range(32)))
    codes = collections.Counter(r[0] for r in res)
    if set(codes) != {200, 429}:
        raise AssertionError(f"[overload] queue bound: statuses {codes}")
    retry = sorted(float(r[1]["Retry-After"]) for r in res if r[0] == 429)
    if min(retry) < OV_FLOOR or max(retry) <= OV_FLOOR:
        raise AssertionError(f"[overload] Retry-After {retry}: each must be "
                             f">= {OV_FLOOR} and some above it")
    for r in res:
        if r[0] == 200 and json.loads(r[2])["usage"][
                "completion_tokens"] != 256:
            raise AssertionError("[overload] an admitted request came back "
                                 "short")
    return {"statuses": dict(codes), "retry_after_s": retry}


def _ov_faults(base: str) -> dict:
    """(c) /debug/faults on a server armed by --fault-injection "":
    error_rate=1 makes completions 500 fault_injection while /health and
    /metrics answer 200; stall_ms=300 delays the first byte by >= 300 ms;
    off=1 brings 200 back."""
    body = {"model": "llama-3-8b", "prompt": list(range(30, 62)),
            "max_tokens": 2, "temperature": 0.0, "ignore_eos": True}
    if not _ov_json(base, "/debug/faults?error_rate=1", {})["active"]:
        raise AssertionError("[overload] faults did not arm")
    status, _, data, _, _ = _ov_call(base, "/v1/completions", body)
    if status != 500 or json.loads(data)["error"]["type"] != \
            "fault_injection":
        raise AssertionError(f"[overload] error_rate=1: {status} {data!r}")
    for path in ("/health", "/metrics"):
        if _ov_call(base, path)[0] != 200:
            raise AssertionError(f"[overload] {path} faulted")
    _ov_json(base, "/debug/faults?stall_ms=300", {})
    status, _, _, ttfb, _ = _ov_call(base, "/v1/completions", body)
    if status != 200 or ttfb < 0.3:
        raise AssertionError(f"[overload] stall_ms=300: {status}, first "
                             f"byte after {ttfb:.3f} s")
    if _ov_json(base, "/debug/faults?off=1", {}) != {"active": False}:
        raise AssertionError("[overload] faults did not clear")
    status, _, _, ttfb_off, _ = _ov_call(base, "/v1/completions", body)
    if status != 200:
        raise AssertionError(f"[overload] after off=1: {status}")
    return {"stalled_first_byte_s": ttfb, "first_byte_after_off_s": ttfb_off}


def _ov_tenant_rows(base: str) -> dict:
    samples = _ov_metrics(base)
    rows = collections.defaultdict(dict)
    for (name, lbl), v in samples.items():
        lbl = dict(lbl)
        if name == "vllm:tenant_tokens_total":
            rows[lbl["tenant"]][lbl["phase"]] = v
        elif name == "vllm:tenant_chip_seconds_total":
            rows[lbl["tenant"]]["chip_seconds"] = v
    perf = _ov_json(base, "/debug/perf")
    return {"rows": dict(rows), "totals": perf["totals"],
            "dispatch_s": _ov_json(base, "/debug/tenants")[
                "dispatch_seconds_total"],
            "prompt": _ov_sample(samples, "vllm:prompt_tokens_total"),
            "generation": _ov_sample(samples,
                                     "vllm:generation_tokens_total")}


def _ov_wave(np, base: str, seed: int) -> dict:
    """The two-tenant wave: heavy sends 24 requests of 1024 prompt tokens,
    light 4 of 128, each 32 tokens out, all at once, streamed so the first
    data event marks the first token (printable tokens only). Returns the
    TTFT of each tenant's requests and the cached prompt tokens."""
    rng = np.random.default_rng(seed)
    jobs = [("heavy", 1024)] * 24 + [("light", 128)] * 4
    prompts = [rng.integers(0, 256, n).tolist() for _, n in jobs]
    order = rng.permutation(len(jobs))

    def one(i):
        tenant, n = jobs[i]
        body = {"model": "llama-3-8b", "prompt": prompts[i],
                "max_tokens": 32, "temperature": 0.0, "ignore_eos": True,
                "allowed_token_ids": KV_ALLOWED,
                "stream_options": {"include_usage": True}}
        status, events, first = _ov_stream(base, body,
                                           {"x-tenant-id": tenant})
        usage = next(e["usage"] for e in events if isinstance(e, dict)
                     and e.get("usage"))
        if status != 200 or usage["completion_tokens"] != 32:
            raise AssertionError(f"[overload] wave {tenant}: {status} "
                                 f"{usage}")
        return tenant, first

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        res = list(pool.map(one, order))
    ttft = collections.defaultdict(list)
    for tenant, first in res:
        ttft[tenant].append(first)
    return {t: statistics.median(v) for t, v in ttft.items()}


def _ov_tenants(np, base: str) -> dict:
    """(d) The two-tenant wave: /debug/tenants lists both; per phase the
    tenants' token deltas sum to the accountant's totals (prefill plus
    nothing cached is the prompt delta), and their chip-seconds deltas to
    the attributed dispatch seconds within 1e-6 relative."""
    before = _ov_tenant_rows(base)
    t0 = time.perf_counter()
    ttft = _ov_wave(np, base, 31)
    wall = time.perf_counter() - t0
    after = _ov_tenant_rows(base)
    doc = _ov_json(base, "/debug/tenants")
    if not {"heavy", "light"} <= set(doc["tenants"]):
        raise AssertionError(f"[overload] /debug/tenants: {doc['tenants']}")

    def delta(t, key):
        return after["rows"].get(t, {}).get(key, 0.0) - \
            before["rows"].get(t, {}).get(key, 0.0)

    tenants = set(after["rows"])
    out = {"wave_s": wall, "ttft_median_s": ttft}
    for phase in ("prefill", "decode"):
        got = sum(delta(t, phase) for t in tenants)
        want = (after["totals"][f"{phase}_tokens"]
                - before["totals"][f"{phase}_tokens"])
        if got != want:
            raise AssertionError(f"[overload] {phase}: tenants {got}, "
                                 f"accountant {want}")
        out[f"{phase}_tokens"] = {t: delta(t, phase) for t in
                                  ("heavy", "light")}
    prompt = after["prompt"] - before["prompt"]
    if sum(delta(t, "prefill") for t in tenants) != prompt:
        raise AssertionError(f"[overload] prefill tokens "
                             f"{out['prefill_tokens']} against {prompt} "
                             "prompt tokens")
    # each request's first token is a prefill sample; the rest decode
    out["generation_tokens"] = after["generation"] - before["generation"]
    chip = sum(delta(t, "chip_seconds") for t in tenants)
    attributed = after["dispatch_s"] - before["dispatch_s"]
    if abs(chip - attributed) > 1e-6 * attributed or attributed <= 0:
        raise AssertionError(f"[overload] chip-seconds {chip} against "
                             f"{attributed} attributed")
    out["chip_seconds"] = {t: delta(t, "chip_seconds")
                           for t in ("heavy", "light")}
    out["attributed_dispatch_s"] = attributed
    return out


def _ov_greedy_batch(base: str, prompts: list) -> list:
    """One tenant's greedy batch, admitted at once in prompt order; each
    choice's text (printable tokens only: a token is a character)."""
    status, _, data, _, _ = _ov_call(base, "/v1/completions", {
        "model": "llama-3-8b", "prompt": prompts, "max_tokens": 16,
        "temperature": 0.0, "ignore_eos": True,
        "allowed_token_ids": KV_ALLOWED}, {"x-tenant-id": "solo"})
    if status != 200:
        raise AssertionError(f"[overload] greedy batch: {status}")
    choices = sorted(json.loads(data)["choices"], key=lambda c: c["index"])
    texts = [c["text"] for c in choices]
    if any(len(t) != 16 for t in texts):
        raise AssertionError(f"[overload] greedy batch texts {texts}")
    return texts


def _ov_fair_share(np, server, base: str, first: dict) -> dict:
    """(e) The wave again with --fair-share's switch on (light's median
    TTFT printed beside the FCFS run's); then one tenant's greedy batch
    gives the same tokens with fair share on and off (a first run fills
    the prefix cache, so both compared runs hit it alike)."""
    def fair(on):
        server.async_engine.run_on_engine(
            lambda eng: setattr(eng.scheduler.config, "fair_share", on))

    fair(True)
    ttft_on = _ov_wave(np, base, 32)
    snap = _ov_json(base, "/debug/overload")["fair_share"]
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, 256, 256).tolist() for _ in range(8)]
    fair(False)
    _ov_greedy_batch(base, prompts)
    off = _ov_greedy_batch(base, prompts)
    fair(True)
    on = _ov_greedy_batch(base, prompts)
    fair(False)
    if on != off:
        raise AssertionError("[overload] one tenant: fair share changed "
                             "the greedy tokens")
    return {"light_ttft_median_s": {"fcfs": first["light"],
                                    "fair_share": ttft_on["light"]},
            "heavy_ttft_median_s": {"fcfs": first["heavy"],
                                    "fair_share": ttft_on["heavy"]},
            "admit_pass_after": snap["admit_pass"],
            "one_tenant_tokens_equal": True}


def _ov_brownout(np, base: str) -> dict:
    """(f) Flood the brownout server from ``heavy`` (4 long ``light``
    requests in flight too): /debug/overload reaches stage 3; at once a
    new heavy request gets 429, a light one 200 and a light one asking 200
    tokens at most 16 (admission applies the stage); the spec sheds count;
    after the flood the stage returns to 0. Returns the timeline of
    stages (seconds from the flood's start, stage)."""
    rng = np.random.default_rng(41)
    timeline, stop = [], threading.Event()

    def req(tenant, n, max_tokens):
        return _ov_call(base, "/v1/completions", {
            "model": "llama-3-8b", "prompt": prompts.pop(), "max_tokens":
            max_tokens, "temperature": 0.0, "ignore_eos": True},
            {"x-tenant-id": tenant})

    prompts = [rng.integers(0, 256, 512).tolist() for _ in range(100)]
    t0 = time.perf_counter()

    def watch():
        last = None
        while not stop.is_set():
            stage = _ov_json(base, "/debug/overload")["brownout"]["stage"]
            if stage != last:
                timeline.append((round(time.perf_counter() - t0, 3), stage))
                last = stage
            time.sleep(0.05)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    pool = concurrent.futures.ThreadPoolExecutor(100)
    try:
        lights = [pool.submit(req, "light", 256, 192) for _ in range(4)]
        time.sleep(0.2)
        flood = [pool.submit(req, "heavy", 512, 48) for _ in range(90)]
        # stage 3, and its shed set applied on the engine thread
        t_end = time.monotonic() + 60
        while True:
            snap = _ov_json(base, "/debug/overload")
            shed = snap["shed_tenants"]
            if snap["brownout"]["stage"] == 3 and shed:
                break
            if time.monotonic() > t_end:
                raise AssertionError(f"[overload] stage 3 never reached: "
                                     f"{timeline}")
            time.sleep(0.02)
        heavy = req("heavy", 64, 8)
        clamp = pool.submit(req, "light", 64, 200)
        light = pool.submit(req, "light", 64, 8)
        status, _, data, _, _ = clamp.result()
        clamped = (json.loads(data)["usage"]["completion_tokens"]
                   if status == 200 else None)
        if status != 200 or clamped > 16:
            raise AssertionError(f"[overload] stage-2 clamp: {status}, "
                                 f"{clamped} tokens")
        if heavy[0] != 429 or light.result()[0] != 200 or shed != ["heavy"]:
            raise AssertionError(
                f"[overload] stage 3: heavy {heavy[0]}, light "
                f"{light.result()[0]}, shed set {shed}")
        flood_codes = collections.Counter(f.result()[0] for f in flood)
        light_codes = collections.Counter(f.result()[0] for f in lights)
        t_end = time.monotonic() + 60
        while timeline[-1][1] != 0:
            if time.monotonic() > t_end:
                raise AssertionError(f"[overload] the stage did not return "
                                     f"to 0: {timeline}")
            time.sleep(0.05)
    finally:
        stop.set()
        watcher.join(10)
        pool.shutdown(wait=True)
    snap = _ov_json(base, "/debug/overload")
    sheds = {dict(lbl)["reason"]: v for (n, lbl), v in
             _ov_metrics(base).items() if n == "vllm:brownout_sheds_total"}
    if sheds.get("spec", 0) <= 0 or sheds.get("tenant", 0) <= 0:
        raise AssertionError(f"[overload] sheds {sheds}")
    return {"timeline_s_stage": timeline, "shed_tenants_at_3": shed,
            "clamped_tokens": clamped,
            "heavy_retry_after_s": float(heavy[1]["Retry-After"]),
            "flood_statuses": dict(flood_codes),
            "light_statuses": dict(light_codes),
            "sheds": sheds, "transitions": snap["brownout"]["transitions"]}


def _ov_metering_cost(torch, np, eng) -> dict:
    """(g) A 64-row decode step's untraced wall with tenant metering off
    and on, in turns (off, on, on, off, twice; 32 steps a turn), on the
    brownout server's engine with its HTTP front end stopped (sampled
    rows: no drafts, so every step is a plain decode step). The host's
    pace moves between turns, so each mode's median is printed beside
    every turn."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    rng = np.random.default_rng(51)
    sp = SamplingParams(temperature=0.8, top_p=0.95, max_tokens=64,
                        ignore_eos=True)
    walls = collections.defaultdict(list)
    for turn, on in enumerate((False, True, True, False) * 2):
        eng.perf.tenant_metering = on
        for i in range(64):
            eng.add_request(f"mc{turn}-{i}", sampling=sp, tenant=f"t{i % 4}",
                            prompt_token_ids=rng.integers(
                                0, 256, 128).tolist())
        d0 = eng.decode_dispatches
        while eng.decode_dispatches == d0:  # prefill all 64, one decode
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(32):
            eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 32
        if eng.decode_dispatches - d0 != 33:
            raise AssertionError("[overload] the metering window ran "
                                 "ragged steps")
        walls["on" if on else "off"].append(ms)
        for rid in list(eng.scheduler.seqs):
            eng.abort_request(rid)
    eng.perf.tenant_metering = True
    return {"decode_64_rows_ms_a_step": dict(walls),
            "order": "off, on, on, off, off, on, on, off",
            "median_ms": {k: statistics.median(v) for k, v in walls.items()}}


def overload_phase(torch, np, counters, card: str) -> dict:
    """Phase 12 (``overload``): llama-3-8b, bf16, seed 0, the ragged path,
    through ``server_from_args``. Server 1 (``--max-queue-len 4
    --max-num-seqs 8 --fault-injection ""``): (a) deadlines, (b) the queue
    bound, (c) faults, then, with the queue bound lifted in process, (d)
    the two-tenant wave and (e) fair share off and on. Server 2
    (``--speculative-ngram 4 --brownout ...``): (f) the brownout flood,
    then (g) the metering host cost on its engine. K1-K3 launch, K4 not.
    Returns the phase's launches."""
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        server_from_args,
    )

    t_phase = time.perf_counter()
    out = {}
    for c in counters:
        c.n = 0
    t0 = time.perf_counter()
    server = server_from_args(build_parser().parse_args(
        ["--model", "llama-3-8b", "--seed", "0", "--skip-warmup",
         "--max-queue-len", "4", "--max-num-seqs", "8",
         "--fault-injection", ""]))
    base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    log(f"[overload] server 1 up in {time.perf_counter() - t0:.1f} s: "
        f"{server.engine.runner.num_blocks} KV blocks")
    try:
        out["a_deadlines"] = _ov_deadlines(base, counters)
        out["b_queue_bound"] = _ov_queue_bound(np, base)
        out["c_faults"] = _ov_faults(base)
        server.async_engine.run_on_engine(lambda eng: setattr(
            eng.scheduler.config, "max_queue_len", 4096))
        out["d_tenants"] = _ov_tenants(np, base)
        out["e_fair_share"] = _ov_fair_share(
            np, server, base, out["d_tenants"]["ttft_median_s"])
    finally:
        server.shutdown()
    del server
    _released(torch, "overload server 1")
    t0 = time.perf_counter()
    server = server_from_args(build_parser().parse_args(
        ["--model", "llama-3-8b", "--seed", "0", "--skip-warmup",
         "--speculative-ngram", "4", "--brownout",
         "--brownout-interval", "0.25", "--brownout-queue-high", "0.05",
         "--brownout-up-evals", "1", "--brownout-calm-evals", "2",
         "--brownout-max-tokens-clamp", "16", "--max-queue-len", "64",
         "--tenant-weights", '{"heavy":1,"light":4}']))
    base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    log(f"[overload] server 2 up in {time.perf_counter() - t0:.1f} s")
    try:
        out["f_brownout"] = _ov_brownout(np, base)
    finally:
        server.shutdown()
    out["g_metering"] = _ov_metering_cost(torch, np, server.engine)
    launches = {c.name.split()[0]: c.n for c in counters}
    del server
    _released(torch, "overload server 2")
    _expect(launches, {"K1", "K2", "K3"}, "overload")
    log(f"[overload] ({card}) in {time.perf_counter() - t_phase:.1f} s: "
        + json.dumps({**out, "launches": launches}))
    return launches


# -- phase 13: the observability plane ----------------------------------------

OBS_MODEL = "llama-3-8b"
OBS_DEFAULT_HBM = 0.92  # --diagnostics-hbm-threshold's default
# every file a forced capture's bundle holds on the card
OBS_FILES = {"manifest.json", "perf.json", "lifecycle.json",
             "flight_recorder.json", "scheduler.json", "compile_events.json",
             "memory.pickle", "trace/trace.json"}


def _obs_body(rng) -> dict:
    """A greedy completion of 256-1024 byte tokens, 32 out."""
    return {"model": OBS_MODEL, "max_tokens": 32, "temperature": 0.0,
            "ignore_eos": True, "prompt": rng.integers(0, 256, int(
                rng.integers(256, 1025))).tolist()}


def _obs_bodies(np, rng, n: int, tag: str) -> list:
    """``n`` of ``_obs_body``, each with its own x-request-id; every third
    streamed (usage included), the first asking n = 2."""
    jobs = []
    for i in range(n):
        body = _obs_body(rng)
        if i == 0:
            body["n"] = 2
        if i % 3 == 1:
            body.update(stream=True, stream_options={"include_usage": True})
        jobs.append((f"{tag}-{i:02d}", body))
    return jobs


def _obs_send(base: str, xrid: str, body: dict, headers=None) -> tuple:
    """(status, usage or None, headers) of one completion sent with its
    x-request-id; a stream is read to [DONE] for its usage chunk."""
    hdrs = {"x-request-id": xrid, **(headers or {})}
    if body.get("stream"):
        status, events, _ = _ov_stream(base, body, hdrs)
        usage = [e["usage"] for e in events
                 if isinstance(e, dict) and e.get("usage")]
        return status, usage[-1] if usage else None, {}
    status, rh, raw, _, _ = _ov_call(base, "/v1/completions", body, hdrs)
    return status, (json.loads(raw).get("usage") if status == 200
                    else None), rh


def _obs_wave(base: str, jobs: list) -> tuple:
    """Send ``jobs`` at once; (wall seconds, {xrid: (status, usage)})."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        out = dict(zip((x for x, _ in jobs), ex.map(
            lambda j: _obs_send(base, *j)[:2], jobs)))
    wall = time.perf_counter() - t0
    bad = {x: s for x, (s, _) in out.items() if s != 200}
    if bad:
        raise AssertionError(f"[observability] wave statuses {bad}")
    return wall, out


def _obs_records(base: str, **query) -> list:
    q = "&".join(f"{k}={v}" for k, v in query.items())
    return _ov_json(base, "/debug/requests" + (f"?{q}" if q else ""))[
        "requests"]


def _obs_flight(np, base: str, server) -> dict:
    """(a) 16 requests with their own x-request-ids: 16 records, newest
    first, each whole and ordered, tokens = usage (the prompt counted once
    a choice), completed; an expired deadline and a client that leaves a
    stream. The recorder's host cost a request, measured in process."""
    jobs = _obs_bodies(np, np.random.default_rng(13), 16, "obs-a")
    _, answers = _obs_wave(base, jobs)
    recs = _obs_records(base)
    if len(recs) != 16 or {r["client_request_id"] for r in recs} != set(
            answers):
        raise AssertionError(f"[observability] /debug/requests holds "
                             f"{len(recs)} records")
    finished = [r["timeline"]["finished"] for r in recs]
    if finished != sorted(finished, reverse=True):
        raise AssertionError("[observability] records not newest first")
    order = ("received", "admitted", "first_token", "last_token", "finished")
    bodies = dict(jobs)
    for rec in recs:
        xrid = rec["client_request_id"]
        tl = rec["timeline"]
        stamps = [tl.get(k) for k in order]
        usage = answers[xrid][1]
        n = bodies[xrid].get("n", 1)
        if (None in stamps or stamps != sorted(stamps)
                or rec["outcome"] != "completed" or rec["status"] != 200
                or rec["num_output_tokens"] != usage["completion_tokens"]
                or rec["num_prompt_tokens"] != usage["prompt_tokens"] * n):
            raise AssertionError(f"[observability] record {xrid}: {rec} "
                                 f"against usage {usage}")
    status, _, rh = _obs_send(base, "obs-a-expired", {
        "model": OBS_MODEL, "prompt": "late", "max_tokens": 4},
        {"x-request-deadline": f"{time.time() - 1:.3f}"})
    leaver = _obs_leave(base)
    expired = {r["client_request_id"]: r for r in _obs_records(
        base, limit=4)}
    if (status != 504 or rh.get("X-Request-Id") != "obs-a-expired"
            or expired["obs-a-expired"]["outcome"] != "deadline_exceeded"
            or expired["obs-a-expired"]["status"] != 504):
        raise AssertionError(f"[observability] expired deadline: {status} "
                             f"{expired.get('obs-a-expired')}")
    if leaver["outcome"] != "client_disconnect":
        raise AssertionError(f"[observability] a client that left: "
                             f"{leaver}")
    cost = _obs_recorder_cost(server)
    log(f"[observability] (a) 16 records newest first, whole and ordered, "
        f"tokens = usage; expired deadline 504 deadline_exceeded; a client "
        f"that left mid-stream client_disconnect after "
        f"{leaver['num_output_tokens']} finished tokens; recorder host cost "
        f"a request: median {cost['median_us']:.2f} us (p90 "
        f"{cost['p90_us']:.2f} us)")
    return {"records": len(recs), "recorder_us": cost}


def _obs_leave(base: str) -> dict:
    """A streamed 1024-token request whose client reads its first chunk
    and resets the connection; returns its record once finished."""
    host, port = base[len("http://"):].split(":")
    # printable tokens only, so text (and chunks) flow from the start
    body = json.dumps({"model": OBS_MODEL, "prompt": "leave " * 50,
                       "max_tokens": 1024, "ignore_eos": True,
                       "temperature": 0.0, "stream": True,
                       "allowed_token_ids": KV_ALLOWED}).encode()
    sock = socket.create_connection((host, int(port)), timeout=120)
    sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 b"x-request-id: obs-a-leaver\r\n"
                 + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    if b"200" not in sock.recv(4096):
        raise AssertionError("[observability] the leaving stream got no 200")
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    b"\x01\x00\x00\x00\x00\x00\x00\x00")
    sock.close()
    t_end = time.monotonic() + 120
    while time.monotonic() < t_end:
        recs = {r["client_request_id"]: r for r in _obs_records(base,
                                                                limit=4)}
        if "obs-a-leaver" in recs:
            return recs["obs-a-leaver"]
        time.sleep(0.05)
    raise AssertionError("[observability] no record of the client that left")


def _obs_recorder_cost(server) -> dict:
    """The recorder's host work for one two-choice request, through the
    server's own code (begin, register, ``_merge_flight`` of each choice,
    unregister, finish) on a recorder and table of its own, so the live
    ring is untouched: median and p90 microseconds over 2000 requests."""
    import types

    from production_stack_tpu_torch.flight_recorder import FlightRecorder

    fr = FlightRecorder(64)
    table = types.SimpleNamespace(_flights={}, _flight_lock=threading.Lock())
    merge = type(server)._merge_flight
    outs = [types.SimpleNamespace(
        request_id=f"x-{i}", admit_time=1.1, first_token_time=1.2 + i,
        finish_time=1.9 + i, num_prompt_tokens=512, num_output_tokens=32)
        for i in range(2)]
    times = []
    for _ in range(2000):
        t0 = time.perf_counter()
        rec = fr.begin(request_id="x", client_request_id="obs",
                       endpoint="/v1/completions", model=OBS_MODEL,
                       tenant="anonymous", streaming=False, trace_id=None,
                       outcome=None, status=None, num_prompt_tokens=0,
                       num_output_tokens=0)
        with table._flight_lock:
            table._flights["x"] = rec
        for out in outs:
            merge(table, out)
        with table._flight_lock:
            table._flights.pop("x")
        rec["outcome"], rec["status"] = "completed", 200
        fr.finish(rec)
        times.append((time.perf_counter() - t0) * 1e6)
    if rec["num_output_tokens"] != 64:
        raise AssertionError("[observability] the merge missed a choice")
    times.sort()
    return {"median_us": statistics.median(times),
            "p90_us": times[int(0.9 * len(times))]}


def _obs_memory(torch, base: str) -> dict:
    """(b) /debug/memory with nothing served: the pickle loads; its
    segments' total_size sums to memory_reserved() and its allocated
    blocks to memory_allocated(), each within 1%."""
    import pickle

    t0 = time.perf_counter()
    status, headers, data, _, _ = _ov_call(base, "/debug/memory")
    ms = (time.perf_counter() - t0) * 1e3
    if (status != 200 or headers.get("Content-Type")
            != "application/octet-stream"
            or "memory.pickle" not in headers.get("Content-Disposition", "")):
        raise AssertionError(f"[observability] /debug/memory: {status} "
                             f"{headers} {data[:200]!r}")
    snap = pickle.loads(data)
    dev = torch.cuda.current_device()
    segs = [s for s in snap["segments"] if s.get("device", dev) == dev]
    reserved = sum(s["total_size"] for s in segs)
    allocated = sum(b["size"] for s in segs for b in s["blocks"]
                    if b["state"] == "active_allocated")
    want_r, want_a = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    if (abs(reserved - want_r) > 0.01 * want_r
            or abs(allocated - want_a) > 0.01 * want_a):
        raise AssertionError(f"[observability] snapshot {reserved} reserved "
                             f"/ {allocated} allocated against torch's "
                             f"{want_r} / {want_a}")
    log(f"[observability] (b) /debug/memory: {len(data)} bytes in "
        f"{ms:.1f} ms, {len(segs)} segments; reserved {reserved} = "
        f"memory_reserved() {want_r}, allocated {allocated} = "
        f"memory_allocated() {want_a}")
    return {"bytes": len(data), "ms": ms, "segments": len(segs)}


def _obs_bundles(base: str) -> list:
    return _ov_json(base, "/debug/diagnostics")["bundles"]


def _obs_tar(base: str, bundle_id: str) -> dict:
    """A bundle's tar.gz: {path inside the bundle: bytes}."""
    import io
    import tarfile

    status, headers, data, _, _ = _ov_call(
        base, f"/debug/diagnostics/{bundle_id}")
    if status != 200 or headers.get("Content-Type") != "application/gzip":
        raise AssertionError(f"[observability] bundle {bundle_id}: {status}")
    out = {}
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        for m in tar.getmembers():
            if m.isfile():
                out[m.name[len(bundle_id) + 1:]] = tar.extractfile(m).read()
    return out


def _obs_capture(np, torch, base: str) -> dict:
    """(c) no hbm_pressure bundle after the wave at the default threshold,
    the allocated share at rest and at the wave's peak; (d) a forced
    capture while requests arrive and decode: 200, every file, no
    error, a trace
    naming K1, K2 and K3; then waves without and with a capture in turns."""
    total = torch.cuda.mem_get_info()[1]
    rest = torch.cuda.memory_allocated() / total
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(17)
    _obs_wave(base, _obs_bodies(np, rng, 16, "obs-c"))
    peak = torch.cuda.max_memory_allocated() / total
    time.sleep(1.5)  # a ledger interval: the accountant polls the card
    hbm = [b for b in _obs_bundles(base) if b["trigger"] == "hbm_pressure"]
    if hbm:
        raise AssertionError(f"[observability] hbm_pressure bundles at the "
                             f"default threshold: {hbm}")
    log(f"[observability] (c) allocated / total at rest {rest:.4f}, at the "
        f"wave's peak {peak:.4f}; threshold {OBS_DEFAULT_HBM}: no "
        f"hbm_pressure bundle")
    # a request arrives every 0.1 s until 0.1 s into the capture's trace,
    # then the ones in flight decode: the trace holds ragged steps with
    # prefill (K2), then decode-only steps (K3). The profiler's first start
    # in a process takes seconds, so the trace's start is watched for.
    stop, sent = threading.Event(), []

    def feed():
        i = 0
        with concurrent.futures.ThreadPoolExecutor(32) as fx:
            while not stop.is_set():
                sent.append(fx.submit(_obs_send, base, f"obs-d-{i:03d}",
                                      _obs_body(rng)))
                i += 1
                stop.wait(0.1)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    time.sleep(0.3)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        cap = ex.submit(_ov_call, base, "/debug/diagnostics/capture",
                        {"trigger": "manual", "incident": "inc-chip-smoke"})
        t_end = time.monotonic() + 60
        while not (torch.autograd.profiler._is_profiler_enabled
                   or cap.done() or time.monotonic() > t_end):
            time.sleep(0.005)
        time.sleep(0.1)
        stop.set()
        status, _, raw, _, _ = cap.result()
    feeder.join(600)
    statuses = [f.result()[0] for f in sent]
    body = json.loads(raw)
    if status != 200 or not body.get("captured") or set(statuses) != {200}:
        raise AssertionError(f"[observability] capture: {status} {body}; "
                             f"wave statuses {set(statuses)}")
    files = _obs_tar(base, body["bundle"])
    manifest = json.loads(files["manifest.json"])
    if (set(files) != OBS_FILES or manifest["errors"] != {}
            or manifest["detail"].get("incident") != "inc-chip-smoke"):
        raise AssertionError(f"[observability] bundle files {sorted(files)}"
                             f", manifest {manifest}")
    trace = json.loads(files["trace/trace.json"])
    kernels = collections.Counter(
        _category(ev.get("name", "")) for ev in trace.get("traceEvents", [])
        if ev.get("cat") == "kernel")
    if not all(kernels[k] > 0 for k in ("K1", "K2", "K3")):
        raise AssertionError(f"[observability] the bundle's trace names "
                             f"{dict(kernels)}")
    walls = {"without": [], "with": []}
    for turn in ("without", "with", "without", "with"):
        jobs = _obs_bodies(np, rng, 16, f"obs-d-{turn}")
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            cap = (ex.submit(_ov_call, base, "/debug/diagnostics/capture",
                             {"trigger": "manual"})
                   if turn == "with" else None)
            walls[turn].append(_obs_wave(base, jobs)[0])
            if cap is not None and cap.result()[0] != 200:
                raise AssertionError("[observability] a timed capture "
                                     "failed")
    log(f"[observability] (d) forced capture during a wave: 200 in "
        f"{manifest['capture_seconds']:.3f} s, {len(files)} files "
        f"({len(files['memory.pickle'])} B memory.pickle, "
        f"{len(files['trace/trace.json'])} B trace), no errors; trace "
        f"kernels by class {dict(kernels)}; 16-request wave wall without / "
        f"with a capture, in turns: {[round(w, 3) for w in walls['without']]}"
        f" / {[round(w, 3) for w in walls['with']]} s (not judged)")
    return {"alloc_share_rest": rest, "alloc_share_peak": peak,
            "capture_s": manifest["capture_seconds"],
            "wave_s": walls, "trace_kernels": dict(kernels)}


def _obs_wait_bundle(base: str, trigger: str, t_end: float) -> dict:
    while time.monotonic() < t_end:
        rows = [b for b in _obs_bundles(base) if b["trigger"] == trigger]
        if rows:
            return rows[0]
        time.sleep(0.1)
    raise AssertionError(f"[observability] no {trigger} bundle")


def _obs_triggers(base: str, server, share: float) -> dict:
    """(e) a recompile after steady and the HBM threshold lowered below
    the measured share each leave one bundle with their trigger; the
    vllm:diagnostic_* families count them."""
    perf = server.engine.perf
    t_end = time.monotonic() + 120
    perf.mark_steady()
    perf.on_compile("ragged", "chip-smoke-drill", 0.01)
    row = _obs_wait_bundle(base, "unexpected_recompile", t_end)
    if row["detail"].get("bucket") != "chip-smoke-drill":
        raise AssertionError(f"[observability] recompile bundle {row}")
    perf.hbm_threshold = share * 0.9
    perf._hbm_ts = 0.0  # poll now, not at the next interval
    perf.poll_hbm()
    perf.hbm_threshold = OBS_DEFAULT_HBM
    row = _obs_wait_bundle(base, "hbm_pressure", t_end)
    if not row["detail"]["fraction"] >= row["detail"]["threshold"]:
        raise AssertionError(f"[observability] hbm bundle {row}")
    idx = _ov_json(base, "/debug/diagnostics")
    samples = _ov_metrics(base)
    counted = {}
    for trig in ("unexpected_recompile", "hbm_pressure", "manual"):
        counted[trig] = _ov_sample(samples, "vllm:diagnostic_bundles_total",
                                   trigger=trig)
        if counted[trig] != idx["bundles_total"].get(trig, 0):
            raise AssertionError(f"[observability] /metrics counts {trig} "
                                 f"{counted[trig]}, the index "
                                 f"{idx['bundles_total']}")
    if counted["unexpected_recompile"] != 1 or counted["hbm_pressure"] != 1:
        raise AssertionError(f"[observability] triggered bundles {counted}")
    n = _ov_sample(samples, "vllm:diagnostic_capture_seconds_count")
    log(f"[observability] (e) unexpected_recompile and hbm_pressure (at "
        f"threshold {share * 0.9:.4f}) left one bundle each; "
        f"vllm:diagnostic_bundles_total {counted}, capture seconds count "
        f"{n:.0f}, sum "
        f"{_ov_sample(samples, 'vllm:diagnostic_capture_seconds_sum'):.3f}")
    return counted


def _obs_ledger(torch, base: str, server, path: str) -> dict:
    """(f) POST /drain: the ledger then holds interval and drain records,
    read back through the port's read_records, stamped with this card and
    platform gpu; the drain record's generation tokens equal /metrics'."""
    from production_stack_tpu_torch.perf_ledger import read_records

    if _ov_call(base, "/drain", {})[0] != 200 or not server.wait_drained(60):
        raise AssertionError("[observability] the drain did not finish")
    tokens = _ov_sample(_ov_metrics(base), "vllm:generation_tokens_total")
    recs, skipped = read_records(path)
    reasons = collections.Counter(r["reason"] for r in recs)
    drain = [r for r in recs if r["reason"] == "drain"]
    fp = drain[-1]["fingerprint"] if drain else {}
    if (skipped or reasons["interval"] < 1 or len(drain) != 1
            or fp.get("chip") != torch.cuda.get_device_name(0)
            or fp.get("platform") != "gpu" or fp.get("framework") != "torch"
            or drain[0]["marks"]["generation_tokens_total"] != tokens):
        raise AssertionError(f"[observability] ledger {dict(reasons)}, "
                             f"{skipped} skipped, fingerprint {fp}, drain "
                             f"marks {drain[0]['marks'] if drain else None} "
                             f"against /metrics {tokens}")
    log(f"[observability] (f) ledger: {dict(reasons)} records, fingerprint "
        f"{drain[0]['fingerprint_id']} (chip {fp['chip']}, torch "
        f"{fp['torch_version']}); drain marks generation_tokens_total "
        f"{tokens:.0f} = /metrics, decode_tps "
        f"{drain[0]['marks'].get('decode_tps')}")
    return {"records": dict(reasons), "fingerprint_id":
            drain[0]["fingerprint_id"]}


# 0.5 s captures in a row after the two 2 s ones (the drill watches for
# an abort in a capture; phases 17 and 18 needed the seconds of eighteen
# more)
DRILL_CAPTURES = 2
# the drill's request rate: 4 a second x 32 tokens, under what llama-3-8b
# serves on the ragged path (~180 tokens/s at 16 in flight), so a queue
# builds only while a capture holds the server
DRILL_EVERY = 0.25
DRILL_SERVER = ["--model", OBS_MODEL, "--seed", "0", "--skip-warmup",
                "--diagnostics-cooldown", "0", "--diagnostics-max-bundles", "4"]


def capture_drill_child(argv: list) -> int:
    """``chip_smoke.py --capture-drill DIR [server flags]``: the capture
    drill's server (``CUT_LAYERS`` layers), in a fresh process that never
    started a profiler, as a production server's: DRILL_SERVER's flags
    (diagnostics at their defaults but the cooldown), bundles under DIR, then
    ``argv``'s. Prints one JSON line (port, seconds up, the profiler's warm-up)
    and serves until its standard input closes; a line ``profile-seconds S``
    there sets the bundles' trace length."""
    import logging

    sys.path.insert(0, str(ROOT))
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        server_from_args,
    )

    logging.basicConfig(level=logging.WARNING)
    logging.getLogger("production_stack_tpu_torch.engine.server").setLevel(
        logging.INFO)
    t0 = time.perf_counter()
    with _CutServers():
        server = server_from_args(build_parser().parse_args(
            DRILL_SERVER + ["--diagnostics-dir", argv[0]] + argv[1:]))
    port = server.start("127.0.0.1", 0)
    print(json.dumps({"port": port, "server_up_s": time.perf_counter() - t0,
                      "profiler_warmup_s": server.profiler_warmup_seconds}),
          flush=True)
    try:
        for line in sys.stdin:  # "profile-seconds S": set, then answer ok
            server.diagnostics.config.profile_seconds = float(line.split()[1])
            print("ok", flush=True)
    finally:
        server.shutdown()
    return 0


class _Feed:
    """A streamed greedy request (``_obs_body``) every DRILL_EVERY seconds
    from entry to exit, its 32-token answer timed end to end on this
    process's clock: a stall of the server's process shows here, where
    the server's own stamps, taken under its GIL, would not show it. (The
    first streamed event is no TTFT here: random weights' tokens seldom
    decode to text, so most answers' first event is their last.)"""

    def __init__(self, base: str, rng):
        self.base, self.rng = base, rng
        self.stop, self.sent = threading.Event(), []

    def _one(self, body: dict) -> tuple:
        t0 = time.perf_counter()
        status = _ov_stream(self.base, body)[0]
        return status, time.perf_counter() - t0

    def _run(self) -> None:
        with concurrent.futures.ThreadPoolExecutor(32) as fx:
            while not self.stop.is_set():
                self.sent.append(fx.submit(self._one, _obs_body(self.rng)))
                self.stop.wait(DRILL_EVERY)

    def __enter__(self):
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        self.thread.join(600)

    def stats(self) -> dict:
        """Requests, every one 200; their median and longest end to
        end."""
        got = [f.result() for f in self.sent]
        if {s for s, _ in got} != {200}:
            raise AssertionError(f"[drill] statuses "
                                 f"{collections.Counter(s for s, _ in got)}")
        e2e = [e for _, e in got]
        return {"requests": len(got), "e2e_median_s": statistics.median(e2e),
                "e2e_max_s": max(e2e)}


def _obs_capture_drill(np, card: str, extra=()) -> dict:
    """(g) The capture drill: a server in a fresh process
    (capture_drill_child), driven from this one. Under a request every
    DRILL_EVERY seconds: 4 s alone, the process's first capture, 4 s
    alone, a later capture (2 s traces, the default), each window's
    answers timed end to end; then DRILL_CAPTURES captures of 0.5 s
    traces in a row, each 200 with every file, a trace and no error. The
    server must then exit 0, which an abort would not. Prints whether
    kineto reported its thread-affinity error."""
    import select
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-smoke-drill-")
    t0 = time.perf_counter()
    with open(f"{tmp}/server.log", "w+") as err:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--capture-drill",
             f"{tmp}/diag", *extra], cwd=ROOT, text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err)
        try:
            if not select.select([proc.stdout], [], [], 300)[0]:
                raise AssertionError("[drill] the server did not start")
            out = json.loads(proc.stdout.readline() or "null")
            if out is None:
                raise AssertionError("[drill] the server exited at start")
            base = f"http://127.0.0.1:{out['port']}"
            rng = np.random.default_rng(23)

            def capture() -> dict:
                status, _, raw, _, _ = _ov_call(
                    base, "/debug/diagnostics/capture", {"trigger": "manual"})
                if status != 200:
                    raise AssertionError(f"[drill] capture: {status} "
                                         f"{raw[:200]!r}")
                bundle = json.loads(raw)["bundle"]
                with open(f"{tmp}/diag/{bundle}/manifest.json") as f:
                    m = json.load(f)
                if m["errors"] != {} or "trace/" not in m["files"]:
                    raise AssertionError(f"[drill] bundle {bundle}: {m}")
                return {"capture_s": m["capture_seconds"]}

            _obs_wave(base, _obs_bodies(np, rng, 4, "drill-prime"))
            windows = {}
            for tag in ("alone-1", "first-capture", "alone-2",
                        "later-capture"):
                with _Feed(base, rng) as feed:
                    time.sleep(0.5)
                    held = capture() if tag.endswith("capture") else {}
                    time.sleep(0.5 if held else 4.0)
                windows[tag] = {**feed.stats(), **held}
            out["windows"] = windows
            proc.stdin.write("profile-seconds 0.5\n")
            proc.stdin.flush()
            if proc.stdout.readline().strip() != "ok":
                raise AssertionError("[drill] the server did not answer")
            with _Feed(base, rng) as feed:
                captures = [capture() for _ in range(DRILL_CAPTURES)]
            out["captures"] = {"n": len(captures), **feed.stats(),
                               "capture_s": [c["capture_s"]
                                             for c in captures]}
        finally:
            proc.stdin.close()
            rc = proc.wait(120)
        err.seek(0)
        log_text = err.read()
    if rc != 0:
        raise AssertionError(f"[drill] the server exited {rc}: "
                             f"{log_text[-3000:]}")
    holds = [tuple(map(float, m)) for m in re.findall(
        r"engine held ([0-9.]+) s to start and ([0-9.]+) s to stop",
        log_text)]
    out["kineto_thread_error"] = (
        "External init callback must run in same thread" in log_text)
    out["process_s"] = time.perf_counter() - t0
    if len(holds) != 2 + DRILL_CAPTURES:
        raise AssertionError(f"[drill] {len(holds)} traces logged")
    for tag, (start, stop) in zip(("first-capture", "later-capture"),
                                  holds):
        windows[tag].update(start_s=start, stop_s=stop)
    out["captures"].update(start_s=[h[0] for h in holds[2:]],
                           stop_s=[h[1] for h in holds[2:]])

    def window(tag: str) -> str:
        w = out["windows"][tag]
        held = (f", capture {w['capture_s']:.3f} s, engine held "
                f"{w['start_s']:.3f} s to start and {w['stop_s']:.3f} s to "
                f"stop" if "stop_s" in w else "")
        return (f"{tag} {w['e2e_median_s']:.3f} / {w['e2e_max_s']:.3f} s "
                f"({w['requests']} requests{held})")

    log(f"[observability] (g) capture drill, a server in a fresh process "
        f"({card}): exit 0 in {out['process_s']:.1f} s; profiler warm-up "
        f"at bind {out['profiler_warmup_s']:.3f} s (server up in "
        f"{out['server_up_s']:.1f} s); client median / longest end to end "
        f"of a 32-token answer, one sent every {DRILL_EVERY} s, 2 s traces: "
        + "; ".join(map(window, out["windows"])) + f". "
        f"{out['captures']['n']} captures of 0.5 s in a row, every one 200 "
        f"with its trace and no error: " + json.dumps(out["captures"])
        + f"; kineto's thread-affinity error printed: "
        f"{out['kineto_thread_error']}")
    return out
def observability_phase(torch, np, counters, card: str) -> dict:
    """Phase 13 (``observability``): llama-3-8b at ``CUT_LAYERS`` layers, bf16,
    seed 0, the ragged path, through ``server_from_args`` with the flight
    recorder at 64, the perf ledger every second, diagnostics with no cooldown
    and 0.5 s traces, and the drift band at 3: (a) flight records, (b)
    /debug/memory, (c) no false HBM alarm, (d) a forced capture, (e) triggered
    bundles, (f) the ledger. K1-K3 launch, K4 not. Returns the phase's
    launches."""
    import tempfile

    from production_stack_tpu_torch.engine.server import (
        build_parser,
        server_from_args,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-obs-")
    ledger = f"{tmp}/perf.jsonl"
    for c in counters:
        c.n = 0
    t0 = time.perf_counter()
    with _CutServers():
        server = server_from_args(build_parser().parse_args(
            ["--model", OBS_MODEL, "--seed", "0", "--skip-warmup",
             "--flight-recorder-size", "64",
             "--perf-ledger-path", ledger, "--perf-ledger-interval", "1",
             "--diagnostics-dir", f"{tmp}/diag", "--diagnostics-cooldown",
             "0", "--diagnostics-profile-seconds", "0.5",
             "--costmodel-drift-band", "3"]))
    base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    log(f"[observability] server up in {time.perf_counter() - t0:.1f} s: "
        f"{server.engine.runner.num_blocks} KV blocks")
    out = {}
    try:
        out["a_flight"] = _obs_flight(np, base, server)
        out["b_memory"] = _obs_memory(torch, base)
        out["cd_capture"] = _obs_capture(np, torch, base)
        out["e_triggers"] = _obs_triggers(
            base, server, out["cd_capture"]["alloc_share_rest"])
        out["f_ledger"] = _obs_ledger(torch, base, server, ledger)
    finally:
        server.shutdown()
    launches = {c.name.split()[0]: c.n for c in counters}
    del server
    _released(torch, "observability")
    _expect(launches, {"K1", "K2", "K3"}, "observability")
    out["g_drill"] = _obs_capture_drill(np, card)
    log(f"[observability] ({card}) in {time.perf_counter() - t_phase:.1f} "
        "s: " + json.dumps({**out, "launches": launches}))
    return launches


# -- phase 14: the decode step as CUDA graphs ---------------------------------

DG_MODES = ("eager", "graphed", "graphed+chain")
DG_WINDOW = 16  # decode steps a timed or traced window
DG_ROUNDS = 2


def _dg_mode(eng, graphs, mode: str) -> None:
    """One engine, three ways to run its decode step: eager (no graph
    cache: the same body over the same static inputs), graphed, and
    graphed with chained dispatches."""
    eng.runner.graphs = None if mode == "eager" else graphs
    eng.config.scheduler.chain_decode = mode == "graphed+chain"


def _dg_serve(eng, reqs) -> dict:
    """Serve ``reqs`` [(rid, prompt, SamplingParams)] to the end: each
    request's tokens and logprob entries."""
    out = {rid: ([], []) for rid, _, _ in reqs}
    for rid, prompt, sp in reqs:
        eng.add_request(rid, prompt_token_ids=prompt, sampling=sp)
    while eng.has_unfinished():
        for o in eng.step():
            out[o.request_id][0].extend(o.new_token_ids)
            out[o.request_id][1].extend(o.new_logprobs or ())
    return out


def _dg_capture(torch, eng, card: str) -> dict:
    """(c) Every key without an adapter at every rung, captured as warmup
    captures them: count, seconds, and the device memory the graphs hold
    (the graph pool, read from torch.cuda.memory_stats around the captures,
    the banks allocated before), against the runner's reserve for it."""
    r = eng.runner
    r._ensure_counts()
    r._ensure_grammar_bank()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_stats()
    n0, s0 = r.graphs.captures, r.graphs.capture_seconds
    t0 = time.perf_counter()
    keys = r.warm_decode_graphs()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = torch.cuda.memory_stats()
    total = torch.cuda.mem_get_info()[1]
    out = {
        "keys": keys, "rungs": r.decode_rungs,
        "captures": r.graphs.captures - n0,
        "capture_s": r.graphs.capture_seconds - s0, "wall_s": wall,
        "pool_reserved_bytes": after["reserved_bytes.all.current"]
        - before["reserved_bytes.all.current"],
        "allocated_delta_bytes": after["allocated_bytes.all.current"]
        - before["allocated_bytes.all.current"],
        "reserve_bytes": r.decode_graph_bytes(),
        "allocated_share": after["allocated_bytes.all.current"] / total,
        "reserved_share": after["reserved_bytes.all.current"] / total}
    if len(r.graphs) != keys or out["captures"] != keys:
        raise AssertionError(f"[decode-graphs] (c) {keys} keys, "
                             f"{len(r.graphs)} graphs: {out}")
    if out["allocated_share"] >= 0.92:
        raise AssertionError(f"[decode-graphs] (c) allocated share "
                             f"{out['allocated_share']:.4f} reaches the "
                             "0.92 hbm_pressure threshold")
    log(f"[decode-graphs] (c) capture ({card}): {json.dumps(out)}")
    return out


def _dg_identity(np, eng, graphs, card: str) -> dict:
    """(a) 32 requests x 48 tokens, greedy and seeded-sampled, contexts of
    100-700 tokens (rungs 256, 512 and 1024): graphed against eager, tokens
    and logprobs bit for bit; then, graphed, chain on against chain off,
    tokens equal, with max_tokens staggered 16-48 so the decode rows
    change membership."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, 256, int(n)).tolist()
               for n in rng.integers(100, 701, 32)]

    def sp(i, **kw):
        samp = ({"temperature": 0.0} if i % 2 == 0 else
                {"temperature": 0.8, "top_p": 0.95, "seed": i})
        return SamplingParams(ignore_eos=True, **samp, **kw)

    runs = {}
    for mode in ("eager", "graphed"):
        _dg_mode(eng, graphs, mode)
        runs[mode] = _dg_serve(eng, [
            (f"{mode}{i}", p, sp(i, max_tokens=48, logprobs=1))
            for i, p in enumerate(prompts)])
    same = [a == b for a, b in zip(runs["eager"].values(),
                                   runs["graphed"].values())]
    if not all(same):
        i = same.index(False)
        raise AssertionError(f"[decode-graphs] (a) request {i}: graphed "
                             "and eager differ")
    chained = [0]
    inner = eng.runner.decode_multi

    def spy(*a, **kw):
        chained[0] += kw.get("tokens_dev") is not None
        return inner(*a, **kw)

    toks = {}
    for mode in ("graphed", "graphed+chain"):
        _dg_mode(eng, graphs, mode)
        eng.runner.decode_multi = spy
        try:
            toks[mode] = [t for t, _ in _dg_serve(eng, [
                (f"{mode}{i}", p, sp(i, max_tokens=16 + 8 * (i % 5)))
                for i, p in enumerate(prompts)]).values()]
        finally:
            del eng.runner.decode_multi
    if toks["graphed"] != toks["graphed+chain"] or not chained[0]:
        raise AssertionError(f"[decode-graphs] (a) chain on differs from "
                             f"off ({chained[0]} chained dispatches)")
    n_tok = sum(len(t) for t, _ in runs["eager"].values())
    out = {"requests": len(prompts), "tokens_compared": n_tok,
           "logprobs_compared": n_tok, "chained_dispatches": chained[0],
           "chain_tokens_compared": sum(len(t) for t in toks["graphed"]),
           "graphs": len(graphs)}
    log(f"[decode-graphs] (a) identity ({card}): graphed = eager in tokens "
        f"and logprobs bit for bit, chain on = off in tokens: "
        f"{json.dumps(out)}")
    return out


def _dg_admit(np, eng, rng, tag, rows, length, max_tokens) -> None:
    """``rows`` greedy requests of ``length`` tokens, stepped until they
    are all in decode (one decode step run)."""
    _add_requests(eng, rng, tag, rows, length, max_tokens)
    d0 = eng.decode_dispatches
    while eng.decode_dispatches == d0:
        eng.step()


def _dg_clear(eng) -> None:
    for rid in list(eng.scheduler.seqs) + [s.request_id for s in
                                           eng.scheduler.waiting]:
        eng.abort_request(rid)
    while eng.has_unfinished():
        eng.step()
    eng.step()  # lands a chain the aborts left


def _dg_timing(torch, np, eng, graphs, card: str) -> dict:
    """(b) The decode step's untraced wall, eager / graphed / graphed +
    chain in turns, ``DG_ROUNDS`` rounds of 16 steps each (after one untimed
    step that lands the previous mode's chain), at 64 and 4 rows and
    contexts of ~130-180 tokens (fresh requests each round) and ~2.1K
    (the same requests through the rounds: contexts 2100-2260, one plan
    rung)."""
    rng = np.random.default_rng(15)
    out = {}
    for rows, length in ((64, 128), (64, 2100), (4, 128), (4, 2100)):
        fresh = length < 1024
        budget = 1 + DG_ROUNDS * len(DG_MODES) * (DG_WINDOW + 1) + 8
        times = {m: [] for m in DG_MODES}
        for rnd in range(DG_ROUNDS):
            if fresh or rnd == 0:
                _dg_mode(eng, graphs, "graphed")
                _dg_admit(np, eng, rng, f"t{rows}x{length}r{rnd}", rows,
                          length, budget)
            for mode in DG_MODES:
                _dg_mode(eng, graphs, mode)
                eng.step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DG_WINDOW):
                    eng.step()
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3
                                   / DG_WINDOW)
            if fresh:
                _dg_clear(eng)
        _dg_clear(eng)
        label = f"{rows} rows, ctx ~{length}"
        out[label] = {m: {"median_ms": statistics.median(v),
                          "spread_ms": max(v) - min(v), "runs_ms": v}
                      for m, v in times.items()}
        log(f"[decode-graphs] (b) decode step, {label}, untraced "
            f"({card}): {json.dumps(out[label])}")
    _dg_mode(eng, graphs, "graphed")
    return out


def _dg_traces(torch, np, eng, graphs, card: str) -> dict:
    """(b) One eager and one graphed window of 16 decode steps at 64 rows
    (contexts ~130-180), traced: device busy, idle share, device kernels
    a step, and graph replays a step."""
    rng = np.random.default_rng(16)
    out = {}
    for mode in ("eager", "graphed"):
        _dg_mode(eng, graphs, "graphed")
        _dg_admit(np, eng, rng, f"tr{mode}", 64, 128, 48)
        _dg_mode(eng, graphs, mode)
        d0 = eng.decode_dispatches
        wall, busy, cats, kernels, calls = _profiled(
            torch, lambda: [eng.step() for _ in range(DG_WINDOW)])
        if eng.decode_dispatches - d0 != DG_WINDOW:
            raise AssertionError("[decode-graphs] a traced window ran "
                                 "other steps")
        _report(card, f"decode, 64 rows, {mode}", DG_WINDOW, wall, busy,
                cats, kernels, calls)
        out[mode] = {"wall_ms_per_step": wall / DG_WINDOW,
                     "busy_ms_per_step": (None if busy is None
                                          else busy / DG_WINDOW),
                     "idle_share": (None if busy is None
                                    else 1.0 - busy / wall),
                     "kernels_per_step": kernels / DG_WINDOW,
                     "graph_replays_per_step": (
                         1 if mode == "graphed" else 0),
                     "wrapper_launches": calls}
        _dg_clear(eng)
    _dg_mode(eng, graphs, "graphed")
    log(f"[decode-graphs] (b) traced windows ({card}): {json.dumps(out)}")
    return out


def _dg_k3_ladder(torch, np, geo: dict, card: str) -> dict:
    """(b) K3 at the plan ladder's plan (every slot of the 64-row batch, the
    rung above the step's longest context) next to the exact per-step
    ``split_plan`` (live rows, longest context + multi_step), on the same
    inputs at the engine's batch of 64: all rows live at contexts 130-170
    and 2000-2100, and 4 live rows at 8192 beside 60 empty ones. Both
    plans are checked against the plain version first; the plain
    version, and SDPA and varlen_attn on the live rows' gathered contexts
    (``yardsticks``), are timed beside them."""
    from production_stack_tpu_torch.ops import paged_decode_attention as k3

    H, KH, D, bs, M, S, K, rungs = (geo[k] for k in (
        "H", "KH", "D", "bs", "M", "S", "K", "rungs"))
    rng = np.random.default_rng(17)
    out = {}
    cases = (("64 live, ctx 130-170",
              rng.integers(130, 171, S).tolist()),
             ("64 live, ctx 2000-2100",
              rng.integers(2000, 2101, S).tolist()),
             ("4 live of 64, ctx 8192", [8192] * 4 + [0] * (S - 4)))
    for label, lens in cases:
        spans = [(b, 1, n) for b, n in enumerate(lens) if n > 0]
        pool, dev, _ = make_stream(rng, spans, S, S, M, bs, 2 * KH, D,
                                   torch.bfloat16, torch)
        q = torch.randn((S, H, D), dtype=torch.bfloat16, device="cuda")
        args = (q, pool, dev["tables"], dev["ctx"], 1)
        rung = k3.ladder_rung(rungs, max(lens) + K - 1)
        plans = {"ladder": k3.split_plan(rung, S, KH),
                 "exact": k3.split_plan(max(lens) + K, len(spans), KH)}
        want = k3.paged_decode_attention_plain(*args)
        extra = p_allowance(k3.paged_decode_attention_plain, args, torch)
        rec = {"rung": rung}
        for name, plan in plans.items():
            check_close(f"K3 {label}, {name} plan {plan}",
                        k3.paged_decode_attention(*args, plan=plan), want,
                        BF16_TOL, torch, extra=extra)
            rec[name] = {"plan": list(plan), "ms": time_ms(
                torch, lambda p=plan: k3.paged_decode_attention(
                    *args, plan=p), 20)}
        nbytes, flops = decode_work(lens, H, KH, D, 2, bs)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
        rec["ladder_over_exact"] = rec["ladder"]["ms"] / rec["exact"]["ms"]
        rec["plain_ms"] = time_ms(
            torch, lambda: k3.paged_decode_attention_plain(*args), 5,
            warmup=1, graph=False)
        # the library calls on the live rows' contexts, gathered beforehand
        live = [b for b, n in enumerate(lens) if n > 0]
        rec.update(yardsticks(
            torch, f"K3 {label}, the ladder's batch", pool, 1,
            [(q[b:b + 1], torch.full((1,), lens[b] - 1, device="cuda"),
              lens[b], dev["tables"][b]) for b in live], H, KH,
            [want[b:b + 1] for b in live]))
        out[label] = rec
        del pool
    log(f"[decode-graphs] (b) K3 at the ladder's plan and the exact plan "
        f"({card}): {json.dumps(out)}")
    return out


def _dg_sleep(torch, np, eng, graphs, card: str) -> dict:
    """(d) Sleep level 2, then wake: the graphs are dropped while asleep
    and captured again at wake, and 8 greedy requests give the same
    tokens before and after (the wake makes the seed-0 weights again).
    Level 1 drops the graphs with the pool too; phase 10 (e) sleeps and
    wakes at both levels with graphs on."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    rng = np.random.default_rng(18)
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
    prompts = [rng.integers(0, 256, int(n)).tolist()
               for n in rng.integers(64, 600, 8)]

    def wave(tag):
        got = _dg_serve(eng, [(f"{tag}{i}", p, sp)
                              for i, p in enumerate(prompts)])
        return [t for t, _ in got.values()]

    before = wave("before")
    held = set(graphs.entries)
    out = {"graphs": len(held)}
    for level in (2,):
        eng.sleep_mode(level)
        if len(graphs) or set(eng.runner._held_keys) != held:
            raise AssertionError(f"[decode-graphs] (d) level {level}: "
                                 f"{len(graphs)} graphs held asleep")
        asleep = torch.cuda.memory_allocated()
        n0, s0 = graphs.captures, graphs.capture_seconds
        t0 = time.perf_counter()
        eng.wake_mode()
        out[f"level{level}"] = {
            "allocated_asleep_gib": asleep / 2**30,
            "wake_s": time.perf_counter() - t0,
            "recaptured": graphs.captures - n0,
            "recapture_s": graphs.capture_seconds - s0}
        if set(graphs.entries) != held:
            raise AssertionError(f"[decode-graphs] (d) level {level}: wake "
                                 "did not capture the held keys again")
        n0 = graphs.captures
        after = wave(f"after{level}-")
        if after != before or graphs.captures != n0:
            raise AssertionError(f"[decode-graphs] (d) level {level}: "
                                 "tokens after wake differ, or live "
                                 "traffic captured")
    log(f"[decode-graphs] (d) sleep ({card}): graphs dropped and captured "
        f"again, greedy tokens equal after wake: {json.dumps(out)}")
    return out


def decode_graphs_phase(torch, np, counters, card: str) -> dict:
    """Phase 14: llama-3-8b bf16 at ``CUT_LAYERS`` layers, seed 0, default
    scheduler, prefix cache off, one engine in this process with its graphs toggled between windows: (c) capture,
    (a) identity, (b) timing and traces, (d) sleep; then, the engine
    released, K3 at the ladder's plan. Returns the phase's launches (K1,
    K2 and K3; K1 and K3 through the replays)."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine

    t_phase = time.perf_counter()
    # no prefix cache: a run repeated for comparison must prefill as the
    # first one did, not from its cached blocks
    eng = LLMEngine(EngineConfig.for_model(
        "llama-3-8b", seed=0, num_layers=CUT_LAYERS,
        cache=CacheConfig(enable_prefix_caching=False)), device="cuda")
    graphs = eng.runner.graphs
    if graphs is None:
        raise AssertionError("[decode-graphs] the engine runs no graphs")
    log(f"[decode-graphs] llama-3-8b up in "
        f"{time.perf_counter() - t_phase:.1f} s: {eng.runner.num_blocks} "
        f"KV blocks, rungs {eng.runner.decode_rungs}")
    for ctr in counters:
        ctr.n = 0
    out = {"c_capture": _dg_capture(torch, eng, card)}
    out["a_identity"] = _dg_identity(np, eng, graphs, card)
    out["b_timing"] = _dg_timing(torch, np, eng, graphs, card)
    out["b_traces"] = _dg_traces(torch, np, eng, graphs, card)
    out["d_sleep"] = _dg_sleep(torch, np, eng, graphs, card)
    launches = {ctr.name.split()[0]: ctr.n for ctr in counters}
    _expect(launches, {"K1", "K2", "K3"}, "decode-graphs")
    c, r = eng.config, eng.runner
    geo = {"H": c.model.num_heads, "KH": c.model.num_kv_heads,
           "D": c.model.head_dim, "bs": c.cache.block_size,
           "M": r.max_blocks_per_seq, "S": c.scheduler.max_num_seqs,
           "K": r.decode_steps, "rungs": r.decode_rungs}
    del eng, graphs, c, r
    _released(torch, "decode-graphs")
    # the plain version's gathers need the memory the pool held
    out["b_k3"] = _dg_k3_ladder(torch, np, geo, card)
    log(f"[decode-graphs] ({card}) in {time.perf_counter() - t_phase:.1f} "
        "s: " + json.dumps({"launches": launches}))
    return launches


# -- phase 15: tensor parallelism, two ranks sharing one card -----------------

TP_NOTE = "two ranks share one card over gloo: not a TP speed"
TP_BLOCKS = 2048
# phase 15 (a)'s tokens a request (32 until PR 18): the same requests
# with their answers cut short, so every step compared is one of the
# longer run's
TP_TOKENS = 16
# phase 16 (c): the tp 2 server's ranks are gone this long after SIGTERM
TP_GONE_S = 3.0
# phase 16 (a): mixtral-8x7b's KV blocks a rank (256 KiB each at KH 4 a
# rank and CUT_LAYERS layers); the 16 prompts need at most 16 x 67
MOE_TP_BLOCKS = 2048
# phase 16 (a)'s least band: the CPU tests' int8 band (test_torch_quant.py),
# an activation on a rounding boundary rounding either way
INT8_LP_BAND = 0.05


def _tp_engine(impl: str, tp: int, layers: int | None = CUT_LAYERS):
    """llama-3-8b bf16 at ``layers`` of its layers (None: all), seed 0,
    ``impl``, prefix cache off (a repeated run must prefill as the first
    did), decode eager, ``TP_BLOCKS`` blocks a rank; at tp 2 both ranks on
    cuda:0 over gloo."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    cfg = EngineConfig.for_model(
        "llama-3-8b", seed=0, attention_impl=impl,
        cache=CacheConfig(enable_prefix_caching=False, num_blocks=TP_BLOCKS),
        scheduler=SchedulerConfig(decode_graphs=False),
        mesh=MeshConfig(tensor=tp),
        **({"num_layers": layers} if layers else {}))
    return LLMEngine(cfg, device="cuda",
                     rank_devices=["cuda:0"] * tp if tp > 1 else None,
                     backend="gloo" if tp > 1 else None)


def _tp_prompts(np) -> list:
    rng = np.random.default_rng(15)
    return [rng.integers(0, 32000, int(n)).tolist()
            for n in rng.integers(64, 1025, 16)]


# RankGroup's device-group collectives
TP_COLLECTIVES = ("all_reduce", "all_reduce_int32", "all_reduce_max",
                  "all_gather_last", "moe_combine")


def _tp_collective_clock(torch, ranks) -> list:
    """Time rank 0's collectives: each of ``ranks``' collectives adds its
    host wall (synchronised on both sides) to the returned cell until
    ``del``eted from the instance."""
    spent = [0.0]
    for name in TP_COLLECTIVES:
        def timed(x, _fn=getattr(ranks, name)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = _fn(x)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return y
        setattr(ranks, name, timed)
    return spent


def _tp_steps(torch, np, eng, card: str, label: str, length: int = 128,
              reps: int = 1) -> dict:
    """(d) An eager decode step at 64 rows (contexts of ``length`` + a few
    tokens) and a 2048-token ragged step, host wall to a synchronise,
    ``reps`` each; at tp 2 also the share of it rank 0 spends in
    collectives and the bytes each kind of collective put on the wire
    (``RankGroup.wire``)."""
    rng = np.random.default_rng(16)
    ranks = eng.runner.ranks
    spent = [0.0] if ranks is None else _tp_collective_clock(torch, ranks)
    wire = {}

    def timed_step(kind: str) -> tuple:
        spent[0] = 0.0
        sent = dict(ranks.wire) if ranks is not None else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if ranks is not None:
            wire[kind] = {op: n - sent.get(op, 0.0)
                          for op, n in ranks.wire.items()
                          if n != sent.get(op, 0.0)}
        return (time.perf_counter() - t0) * 1e3, spent[0] * 1e3

    _dg_admit(np, eng, rng, f"{label}-d", 64, length, 64)
    decode = [timed_step("decode_64") for _ in range(reps)]
    _dg_clear(eng)
    ragged = []
    for i in range(reps):
        _add_requests(eng, rng, f"{label}-r{i}-", 1, 2048, 1)
        ragged.append(timed_step("ragged_2048"))
        _dg_clear(eng)
    if ranks is not None:
        for name in TP_COLLECTIVES:
            delattr(ranks, name)
    out = {"decode_64_ms": statistics.median(t for t, _ in decode),
           "decode_64_collective_ms": statistics.median(c for _, c in decode),
           "ragged_2048_ms": statistics.median(t for t, _ in ragged),
           "ragged_2048_collective_ms": statistics.median(
               c for _, c in ragged),
           "wire_bytes_a_step": wire}
    log(f"[tp] (d) {label} ({card}; {TP_NOTE}): {json.dumps(out)}")
    return out


def _tp_kernels(torch, np, card: str) -> dict:
    """(b) K1-K4 at a tp 2 shard of llama-3-8b (H 16, KH 4, D 128) against
    their plain versions, NaN in every unwritten pool slot, with their
    times, bounds and library calls; returns each kernel's record."""
    from production_stack_tpu_torch.engine.config import ModelConfig
    from production_stack_tpu_torch.ops import kv_write as k1

    cfg = dataclasses.replace(ModelConfig.from_pretrained("llama-3-8b"),
                              num_heads=16, num_kv_heads=4)
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T, S, bs, layer = 2048, 64, 16, 1
    M = (-(-cfg.max_model_len // bs) + 7) // 8 * 8
    rng = np.random.default_rng(17)
    spans = [(0, 512, 512), (3, 700, 1200), (7, 300, 300), (9, 1, 1)]
    spans += [(s, 1, int(rng.integers(1, 2048))) for s in range(10, S)
              if s % 5]
    spans.sort()
    pool, dev, spans = make_stream(rng, spans, T, S, M, bs, 2 * KH, D,
                                   torch.bfloat16, torch, layer=layer)
    live = int(dev["cu"][-1])
    newkv = torch.randn((T, 2 * KH, D), dtype=torch.bfloat16, device="cuda")
    ref_pool = pool.clone()
    k1.kv_write(pool, newkv, dev["slots"], layer)
    k1.kv_write_plain(ref_pool, newkv, dev["slots"], layer)
    torch.cuda.synchronize()
    if not torch.equal(pool.view(torch.int16), ref_pool.view(torch.int16)):
        raise AssertionError("[tp] (b) K1 at the shard: pool differs")
    keep = dev["slots"] >= 0
    idx, src = dev["slots"][keep].long(), newkv[keep]
    flat = ref_pool[layer].view(-1, 2 * KH, D)
    b_ms, b_by = bound(2 * live * 2 * KH * D * 2 + T * 4, 0, BF16_FLOPS)
    recs = {"K1": {
        "shape": f"tp 2 shard: T={T}, {live} live slots, 2KH={2 * KH}",
        "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
        "ms": time_ms(torch, lambda: k1.kv_write(pool, newkv, dev["slots"],
                                                 layer), 200),
        "plain_ms": time_ms(torch, lambda: k1.kv_write_plain(
            ref_pool, newkv, dev["slots"], layer), 20, graph=False),
        "library_ms": time_ms(torch, lambda: flat.index_copy_(0, idx, src),
                              200)}}
    del ref_pool
    q = torch.randn((T, H, D), dtype=torch.bfloat16, device="cuda")
    # no tile or span sweeps at the shard (PERF.md keeps their earlier
    # readings): phase 17 needs their seconds
    recs["K2"] = ragged_measure(torch, card, "tp 2 shard, mixed stream",
                                pool, dev, spans, q, layer, H, KH, D, S, bs,
                                T, sweep=False)
    del pool, q
    lens = [0 if b % 9 == 0 else int(rng.integers(1, 2049))
            for b in range(S)]
    recs["K3"] = decode_measure(torch, card, f"tp 2 shard, B={S}", rng, lens,
                                H, KH, D, M, bs, layer, sweep=False)
    recs["K4"] = prefill_kernel_phase(torch, np, card, rng, cfg, M)
    recs["K4"]["shape"] = "tp 2 shard: " + recs["K4"]["shape"]
    for key, r in recs.items():
        log(f"[tp] (b) {key} at H {H}, KH {KH}, D {D} ({r['shape']}): "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']}, max abs err {r['max_abs_err']:.3e} ({card})")
    torch.cuda.empty_cache()
    return {k: {f: r[f] for f in ALSO_KEYS if f in r} for k, r in recs.items()}


def tp_server_child(argv: list) -> int:
    """``--tp-server PORT [FLAG ...]``: llama-3-8b at tensor-parallel size
    2 and ``CUT_LAYERS`` of its layers (``_CutServers``), both ranks on
    cuda:0 over gloo, through the server's own entry point
    (``server.main``: SIGTERM drains, then the process exits); the further
    flags pass through (``--role``, the tiers, ``--model
    whisper-large-v3-class``, ``--tensor-parallel-size 1
    --sequence-parallel-size 2``, ``--sequence-parallel-size 2`` on the
    seq x tensor grid, ``--pipeline-parallel-size 2`` on the stage x
    tensor grid; a repeated flag's last value wins), every process on
    cuda:0."""
    sys.path.insert(0, str(ROOT))
    from production_stack_tpu_torch.engine import server

    def last(flag: str, default: int) -> int:
        got = [argv[i + 1] for i, a in enumerate(argv[:-1]) if a == flag]
        return int(got[-1]) if got else default

    n = (last("--tensor-parallel-size", 2)
         * last("--sequence-parallel-size", 1)
         * last("--pipeline-parallel-size", 1))
    with _CutServers():
        server.main(["--model", "llama-3-8b", "--host", "127.0.0.1",
                     "--port", argv[0], "--tensor-parallel-size", "2",
                     "--num-blocks", "1024", "--max-num-seqs", "16",
                     "--skip-warmup", *argv[1:]],
                    rank_devices=["cuda:0"] * n, backend="gloo")
    return 0


class _TpServer:
    """A ``--tp-server`` child: started with ``extra`` flags (``start``),
    waited for until its ``/debug/perf`` answers (``up``), and stopped by
    SIGTERM (``stop``: its follower gone within ``TP_GONE_S``, then the
    server's exit 0), its log kept in a temporary file."""

    CHILD = (str(ROOT / "chip_smoke.py"), "--tp-server")

    def __init__(self, extra=()):
        import tempfile

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.base = f"http://127.0.0.1:{port}"
        self.logf = tempfile.TemporaryFile()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, *self.CHILD, str(port), *extra], cwd=ROOT,
            stdout=self.logf,
            stderr=subprocess.STDOUT)
        self.pids = [self.proc.pid]
        self.up_s = None

    def log_tail(self) -> str:
        self.logf.seek(0)
        return self.logf.read().decode(errors="replace")[-3000:]

    def up(self, tag: str, timeout: float = 300,
           graphs: bool = False, size: int = 2) -> dict:
        """Wait for the server; returns its ``/debug/perf`` ranks, ``size``
        of them, decoding through graphs as ``graphs`` says."""
        while True:
            try:
                status, _, raw = _http(self.base, "/debug/perf")
                break
            except (urllib.error.URLError, ConnectionError):
                if (self.proc.poll() is not None
                        or time.perf_counter() - self.t0 > timeout):
                    raise AssertionError(
                        f"[{tag}] the server did not come up (exit "
                        f"{self.proc.poll()}):\n{self.log_tail()}")
                time.sleep(0.5)
        self.up_s = time.perf_counter() - self.t0
        ranks = json.loads(raw)["ranks"]
        self.pids = [self.proc.pid] + ranks["pids"][1:]
        if ranks["size"] != size or ranks["decode_graphs"] != graphs:
            raise AssertionError(f"[{tag}] ranks {ranks}")
        return ranks

    def launches(self) -> dict:
        """Rank 0's kernel launches so far (``/debug/perf``)."""
        return json.loads(_http(self.base, "/debug/perf")[2])["ranks"][
            "launches"]

    def stop(self, tag: str) -> dict:
        """SIGTERM; (seconds until the followers were gone, until the
        server exited)."""
        import signal

        t_stop = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        # the follower ranks, watched from the signal on (a follower's
        # zombie, not yet reaped by the server, counts as gone)
        while any(_pid_alive(p) for p in self.pids[1:]):
            if time.perf_counter() - t_stop > TP_GONE_S:
                raise AssertionError(f"[{tag}] ranks {self.pids[1:]} alive "
                                     f"{TP_GONE_S} s after the stop")
            time.sleep(0.02)
        gone = time.perf_counter() - t_stop
        rc = self.proc.wait(60)
        exited = time.perf_counter() - t_stop
        if rc != 0:
            raise AssertionError(f"[{tag}] the server exited {rc}:\n"
                                 f"{self.log_tail()}")
        return {"ranks_gone_s": gone, "server_exit_s": exited, "exit": rc}

    def kill(self) -> None:
        """Whatever is left of it, killed (after a failure)."""
        import os
        import signal

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        for p in self.pids[1:]:
            if _pid_alive(p):
                os.kill(p, signal.SIGKILL)
        self.logf.close()


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except (FileNotFoundError, IndexError):
        return False


def _tpf_server_routes(base: str, adapter: str) -> dict:
    """Phase 16 (c) on the tp 2 server: ``adapter`` loads over
    ``/v1/load_lora_adapter`` (200), a completion naming it answers 200
    with its 16 tokens, it unloads (200). Phase 17 (c): ``/kv/export``
    answers a real prompt's two blocks (200, their bytes, grouped in 2),
    and those blocks, streamed out and pushed into the server's own
    ``/kv/recv`` (200), are spliced by a continuation."""
    lora = {"lora_name": "tp-adapter", "lora_path": adapter}
    t0 = time.perf_counter()
    loaded = _http(base, "/v1/load_lora_adapter", lora)[0]
    load_s = time.perf_counter() - t0
    status, n_out, _ = _request(base + "/v1/completions", {
        "model": "tp-adapter", "prompt": list(range(100, 164)),
        "max_tokens": 16, "temperature": 0.0, "ignore_eos": True}, False)
    unloaded = _http(base, "/v1/unload_lora_adapter", lora)[0]
    out = {"load": loaded, "load_s": load_s, "completion": status,
           "completion_tokens": n_out, "unload": unloaded}
    if (loaded, status, n_out, unloaded) != (200, 200, 16, 200):
        raise AssertionError(f"[tp2-features] (c) adapter routes: {out}")
    out["kv"] = _tpkv_routes(base)
    return out


def _kv_frames(base: str, blocks: list, group: int) -> tuple:
    """``base``'s streamed ``/kv/export`` of ``blocks`` in ``group``-layer
    frames: (its headers, the frames' payloads)."""
    import http.client
    import io

    from production_stack_tpu_torch.engine import kv_transfer as kvt

    u = urllib.parse.urlsplit(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    try:
        conn.request("POST", "/kv/export", json.dumps(
            {"blocks": blocks, "stream": True, "group_layers": group}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"[tp2-kv-plane] streamed export: HTTP "
                                 f"{resp.status}")
        body = io.BytesIO(resp.read())
        payloads = []
        while (payload := kvt.read_frame(body)) is not None:
            payloads.append(bytes(payload))
        return dict(resp.headers), payloads
    finally:
        conn.close()


def _spliced(base: str) -> float:
    return _scrape(base, KV_MODEL)["vllm:spliced_seqs_total"]


def _tpkv_routes(base: str) -> dict:
    """Phase 17 (c) on the tp 2 server (``_tpf_server_routes``)."""
    from production_stack_tpu_torch.engine import kv_transfer as kvt

    prompt = list(range(1000, 1040))  # two full blocks of 16
    status, pre, _ = _post(base, "/v1/completions", {
        "model": KV_MODEL, "prompt": prompt, "max_tokens": 1,
        "temperature": 0.0, "ignore_eos": True,
        "kv_transfer_params": {"do_remote_decode": True}})
    ids = pre["kv_transfer_params"]["remote_block_ids"][:2]
    code, headers, raw = _http(base, "/kv/export", {"blocks": ids})
    shape = [int(x) for x in headers.get("X-KV-Shape", "0").split(",")]
    want = kvt.nbytes_of(shape, headers.get("X-KV-Dtype", "bfloat16"))
    if (code, len(raw), shape[1], headers.get(kvt.HEAD_GROUPS_HEADER)) != (
            200, want, 2, "2"):
        raise AssertionError(f"[tp2-kv-plane] (c) /kv/export: {code}, "
                             f"{len(raw)} B of {want}, {headers}")
    got, payloads = _kv_frames(base, ids, CUT_LAYERS // 2)
    if b"".join(payloads) != raw:
        raise AssertionError("[tp2-kv-plane] (c) the streamed export is "
                             "not the whole one")
    tid = f"own-{time.monotonic_ns()}"
    meta = {"transfer_id": tid, "prompt_token_ids": prompt[:32],
            "first_token": 50}
    headers = {"X-KV-Transfer-Id": tid, "X-KV-Start-Layer": "0",
               "X-KV-Group-Layers": str(CUT_LAYERS // 2),
               **{k: got[k] for k in ("X-KV-Shape", "X-KV-Dtype",
                                      kvt.HEAD_GROUPS_HEADER)}}
    recv, text = kvt._post_chunked(
        base, "/kv/recv", headers,
        [kvt.frame(json.dumps(meta).encode()),
         *map(kvt.frame, payloads), kvt.END_FRAME], 600)
    spliced = _spliced(base)
    status, _, _ = _post(base, "/v1/completions", {
        "model": KV_MODEL, "prompt": prompt[:32] + [50],
        "max_tokens": 2, "temperature": 0.0, "ignore_eos": True,
        "kv_transfer_params": {"transfer_id": tid}})
    out = {"export": code, "export_bytes": len(raw), "recv": recv,
           "recv_answer": json.loads(text), "spliced": status,
           "spliced_seqs": _spliced(base) - spliced}
    if (recv, status, out["spliced_seqs"]) != (200, 200, 1):
        raise AssertionError(f"[tp2-kv-plane] (c) /kv/recv: {out}")
    return out


def _tp_cli_refusal() -> subprocess.Popen:
    """``--tensor-parallel-size 2`` from the command line, ranks on
    cuda:r, started now to exit beside other work (``_tp_cli_refused``)."""
    return subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", "llama-3-8b", "--tensor-parallel-size", "2",
         "--port", "0"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _tp_cli_refused(cli: subprocess.Popen) -> str:
    """(c) The CLI at tp 2 exited non-zero naming the card count; its
    last line."""
    _, err = cli.communicate(timeout=300)
    n = _card_count()
    if cli.returncode == 0 or f"has {n} CUDA card" not in err:
        raise AssertionError(f"[tp] (c) the CLI at tp 2 on {n} card(s): rc "
                             f"{cli.returncode}, {err[-400:]}")
    return err.strip().splitlines()[-1]


def _tp_server_checks(np, base: str, card: str) -> dict:
    """Phase 15 (c) and phases 16 (c) and 17 (c) on a tp 2 server in a
    fresh process (phase 17's prefill server): a rank-16 adapter, written
    here, loads, serves and unloads; the KV routes answer
    (``_tpf_server_routes``). Its 8 concurrent requests are phase 17's
    reference wave (``_tpkv_reference``), each answered 200 with its
    tokens."""
    import tempfile

    from production_stack_tpu_torch.engine.config import ModelConfig

    with tempfile.TemporaryDirectory() as tmp:
        adapter = write_adapter(np, ModelConfig.from_pretrained(
            KV_MODEL, num_layers=CUT_LAYERS), tmp, rank=16, seed=0)
        routes = _tpf_server_routes(base, adapter)
    log(f"[tp2-features] (c) the tp 2 server's routes ({card}): "
        f"{json.dumps(routes)}")
    return routes


def _card_count() -> int:
    import torch

    return torch.cuda.device_count()


def _tp_dev(ref: tuple, got: tuple) -> tuple:
    """Two ``_greedy_tokens`` runs request by request: (tokens equal
    before each request's first flip, the largest logprob deviation over
    them, the flips as (request, step))."""
    (ref_t, ref_l), (got_t, got_l) = ref, got
    compared, worst, flips = 0, 0.0, []
    for i in ref_t:
        if len(got_t[i]) != len(ref_t[i]):
            raise AssertionError(f"[tp] request {i}: {len(got_t[i])} "
                                 f"tokens, want {len(ref_t[i])}")
        n = next((j for j, (a, b) in enumerate(zip(ref_t[i], got_t[i]))
                  if a != b), len(ref_t[i]))
        worst = max([worst] + [abs(ref_l[i][j][0] - got_l[i][j][0])
                               for j in range(n)])
        compared += n
        if n < len(ref_t[i]):
            flips.append((i, n))
    return compared, worst, flips


def _tp_same(tag: str, ref: tuple, got: tuple, band: float,
             tie_gap: float | None = None) -> tuple:
    """``got``'s greedy tokens (``_greedy_tokens``' runs) equal ``ref``'s
    request by request up to a near-tie, as phase 9 holds them: at a flip
    the two runs' logprobs of their own tokens differ by less than
    ``band`` (a bf16 logit in [8, 16) moves in steps of 0.0625, so the two
    candidates can swap places), or, given a ``tie_gap``, ``ref``'s top-2
    gap there is under it (``_compare_greedy``); before it every logprob
    is within ``band``. Returns (tokens compared, the largest
    deviation)."""
    (ref_t, ref_l), (got_t, got_l) = ref, got
    compared, worst, flips = _tp_dev(ref, got)
    for i, n in flips:
        if (ref_l[i][n][1] >= tie_gap if tie_gap is not None
                else abs(ref_l[i][n][0] - got_l[i][n][0]) >= band):
            raise AssertionError(
                f"[tp] {tag}: request {i} step {n}: {got_t[i][n]} != "
                f"{ref_t[i][n]}, logprobs {ref_l[i][n][0]:.4f} and "
                f"{got_l[i][n][0]:.4f}, top-2 gap {ref_l[i][n][1]:.4f} (band "
                f"{band:.4f}, tie gap {tie_gap})")
        log(f"[tp] {tag}: near-tie at request {i} step {n} (logprobs "
            f"{ref_l[i][n][0]:.4f}, {got_l[i][n][0]:.4f}; top-2 gap "
            f"{ref_l[i][n][1]:.4f}); compared up to it")
    if worst >= band:
        raise AssertionError(f"[tp] {tag}: logprobs differ by {worst} "
                             f"(band {band:.4f})")
    return compared, worst


def _tp_repeat_dev(eng, prompts, sp, ref: tuple, slots=None,
                   per: int = 2) -> float:
    """The engine's own deviation from ``ref``: the same requests ``per``
    (2) at a time, so every prefill step runs in other shapes on both
    paths (an identical repeat is bit for bit, and 4 at a time is the
    bucketed path's own batch)."""
    starts = range(0, len(prompts), per)
    again = [_greedy_tokens(eng, prompts[k:k + per], sp,
                            slots and slots[k:k + per]) for k in starts]
    _, rep, _ = _tp_dev(ref, tuple(
        {k + i: run[c][i] for k, run in zip(starts, again) for i in run[c]}
        for c in (0, 1)))
    return rep


# phase 16 (a)'s tokens a request (32 until PR 18: its judged checks are
# bit for bit, so fewer tokens cut only its depth)
TPF_TOKENS = 16


def _tpf_prompts(np, n: int) -> list:
    """Phase 16's ``n`` prompts of 64-256 tokens: at tp 2 over gloo a
    prefill step pays seconds in collectives (phase 15 (d)), so its waves
    prefill in one or two steps."""
    rng = np.random.default_rng(16)
    return [rng.integers(0, 32000, int(n)).tolist()
            for n in rng.integers(64, 257, n)]


def _tp_lora_wave(eng, lora: dict) -> tuple:
    """Phase 16 (b) on an engine: the adapter loaded as the server's route
    loads it (``LoraManager``: at tp 2 each rank gets its share), then one
    wave of ``lora``'s prompts, base and adapter rows, every odd prompt
    with the adapter and prompt 0 again with it. Returns (the run, the
    prompts, their slots)."""
    from production_stack_tpu_torch.engine.lora import LoraManager

    manager = LoraManager(eng)
    manager.load("tp-adapter", lora["adapter"])
    prompts, sp = lora["prompts"], lora["sp"]
    wave = list(prompts) + [prompts[0]]
    slots = [i % 2 for i in range(len(prompts))] + [
        manager.slot_of("tp-adapter")]
    return _greedy_tokens(eng, wave, sp, slots), wave, slots


def _tp_reference(torch, np, impl: str, card: str, prompts, sp,
                  lora: dict) -> dict:
    """The tp 1 engine on ``impl``, twice: its own repeat deviation sets
    (a)'s band; on the ragged path (d)'s step times too; then phase 16
    (b)'s adapter wave (``_tp_lora_wave``) and its own repeat deviation.
    Released after."""
    eng = _tp_engine(impl, 1)
    ref = _greedy_tokens(eng, prompts, sp)
    rep = _tp_repeat_dev(eng, prompts, sp, ref)
    steps = (_tp_steps(torch, np, eng, card, f"tp1-{impl}")
             if impl == "ragged" else None)
    run, wave, slots = _tp_lora_wave(eng, lora)
    lora_rep = _tp_repeat_dev(eng, wave, lora["sp"], run, slots)
    del eng
    _released(torch, f"tp1 {impl}")
    return {"run": ref, "repeat_dev": rep, "steps": steps,
            "band": max(BF16_LOGPROB_BAND, 2 * rep),
            "lora": {"run": run, "repeat_dev": lora_rep,
                     "band": max(BF16_LOGPROB_BAND, 2 * lora_rep)}}


def _zero(counters) -> None:
    for ctr in counters:
        ctr.n = 0


def _counts(counters) -> dict:
    return {ctr.name.split()[0]: ctr.n for ctr in counters}


def _tp_agree(tag: str, reports: list, launches: dict,
              before: list | None = None) -> None:
    """Every rank's token digest and call count rank 0's, and the
    follower's kernel launches since ``before`` (its reports then; its
    start without) rank 0's ``launches`` over the same calls."""
    if (len({(r["calls"], r["digest"]) for r in reports}) != 1
            or any(r["diverged_at"] is not None for r in reports)):
        raise AssertionError(f"[tp] {tag}: the ranks sampled other tokens: "
                             f"{reports}")
    for r, rep in enumerate(reports[1:], start=1):
        got = {k: n - (before[r]["launches"].get(k, 0) if before else 0)
               for k, n in rep["launches"].items()}
        if got != launches:
            raise AssertionError(f"[tp] {tag}: rank {r} launched {got}, "
                                 f"rank 0 {launches}")


def _tp_identity(torch, np, impl: str, card: str, prompts, sp,
                 ref: dict, counters, lora: dict) -> dict:
    """(a) tp 2 on ``impl``: tokens equal tp 1's up to a near-tie,
    logprobs within the band, every follower's token digest and kernel
    launches rank 0's; on the ragged path (d)'s step times too. Then
    phase 16 (b) on the same ranks: the adapter wave against tp 1's.
    Each wave's launches are counted from 0 just before it."""
    _zero(counters)
    t0 = time.perf_counter()
    eng = _tp_engine(impl, 2)
    up = time.perf_counter() - t0
    try:
        got = _greedy_tokens(eng, prompts, sp)
        launches = _counts(counters)
        first = eng.runner.follower_reports()
        steps = (_tp_steps(torch, np, eng, card, f"tp2-{impl}")
                 if impl == "ragged" else None)
        collective = eng.perf.stats_fields()["collective_bytes"]
        moves = _tp_kv_moves(torch, eng, card) if impl == "ragged" else None
        before = eng.runner.follower_reports()
        _zero(counters)
        t1 = time.perf_counter()
        got_lora, _, _ = _tp_lora_wave(eng, lora)
        lora_s = time.perf_counter() - t1
        lora_launches = _counts(counters)
        reports = eng.runner.follower_reports()
    finally:
        eng.close()
    del eng
    _released(torch, f"tp2 {impl}")
    band = ref["band"]
    compared, worst = _tp_same(f"(a) tp2 {impl}", ref["run"], got, band)
    _tp_agree(f"(a) {impl}", first, launches)
    out = {"tokens_compared": compared, "max_logprob_dev": worst,
           "band": band, "tp1_repeat_dev": ref["repeat_dev"],
           "tp2_up_s": up, "calls": first[0]["calls"],
           "accountant_collective_bytes": collective,
           "steps": {"tp1": ref["steps"], "tp2": steps},
           "launches": launches}
    if moves is not None:
        out["kv_moves"] = moves
    log(f"[tp] (a) {impl} ({card}): tp 2 = tp 1 up to near-ties, the "
        f"follower = rank 0 exactly: {json.dumps(out)}")
    lref = ref["lora"]
    n_lora, lworst = _tp_same(f"(b) tp2 {impl} with an adapter", lref["run"],
                              got_lora, lref["band"])
    _tp_agree(f"(b) {impl}", reports, lora_launches, before)
    last = len(lora["prompts"])
    for tag, run in (("tp 1", lref["run"]), ("tp 2", got_lora)):
        if run[0][last] == run[0][0]:
            raise AssertionError(f"[tp2-features] (b) {impl}: at {tag} the "
                                 "adapter left prompt 0's tokens unchanged")
    lrec = {"requests": last + 1, "adapter_rows": sum(
        1 for i in range(last) if i % 2) + 1, "tokens_compared": n_lora,
        "max_logprob_dev": lworst, "band": lref["band"],
        "tp1_repeat_dev": lref["repeat_dev"], "wave_s": lora_s,
        "calls": reports[0]["calls"], "launches": lora_launches}
    log(f"[tp2-features] (b) llama-3-8b with a rank-16 adapter, {impl} "
        f"({card}): tp 2 = tp 1 up to near-ties, the adapter changes prompt "
        f"0 at both, the follower = rank 0: {json.dumps(lrec)}")
    out["lora"] = lrec
    return out


def tp_phase(torch, np, counters, card: str) -> dict:
    """Phase 15: llama-3-8b at ``CUT_LAYERS`` layers and tensor-parallel size
    2, both ranks on this card over gloo. The tp 1 references first (released),
    then (a) identity and (d) step times at tp 2 on the ragged and the bucketed
    path, (b) K1-K4 at the shard's shapes; (c), the server in a fresh process,
    rides on phase 17's prefill server (``tp_kv_phase``). Phase
    16 (b) rides on these engines: a rank-16 adapter's wave after (a)'s
    on each. Returns rank 0's launches at tp 2, those of each adapter
    wave, the kernels' shard records and phase 17 (d)'s 128-block
    moves."""
    import tempfile

    from production_stack_tpu_torch.engine.config import ModelConfig
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    t_phase = time.perf_counter()
    prompts = _tp_prompts(np)
    sp = SamplingParams(temperature=0.0, max_tokens=TP_TOKENS,
                        ignore_eos=True, logprobs=2)
    with tempfile.TemporaryDirectory() as tmp:
        lora = {"adapter": write_adapter(np, ModelConfig.from_pretrained(
                    "llama-3-8b", num_layers=CUT_LAYERS), tmp, rank=16,
                    seed=0),
                "prompts": _tpf_prompts(np, 8),
                "sp": SamplingParams(temperature=0.0, max_tokens=16,
                                     ignore_eos=True, logprobs=2)}
        refs = {impl: _tp_reference(torch, np, impl, card, prompts, sp, lora)
                for impl in ("ragged", "bucketed")}
        out = {impl: _tp_identity(torch, np, impl, card, prompts, sp, ref,
                                  counters, lora)
               for impl, ref in refs.items()}
        launches = {k: sum(out[impl]["launches"][k] for impl in out)
                    for k in out["ragged"]["launches"]}
        _expect(launches, {"K1", "K2", "K3", "K4"}, "tp2")
        lora_launches = {impl: out[impl]["lora"]["launches"] for impl in out}
        _expect(lora_launches["ragged"], {"K1", "K2", "K3"},
                "tp2-lora-ragged")
        _expect(lora_launches["bucketed"], {"K1", "K3", "K4"},
                "tp2-lora-bucketed")
        log(f"[tp] launches at tp 2 ({card}), rank 0 = rank 1: "
            f"{json.dumps(launches)}; with the adapter: "
            f"{json.dumps(lora_launches)}")
        shard = _tp_kernels(torch, np, card)
    log(f"[tp] phase 15 (a) and (b) ({card}) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "lora_launches": lora_launches,
            "shard": shard, "kv_moves": out["ragged"]["kv_moves"]}


class _FirstStepProbe:
    """Records, in this process (tp 1's engine, or tp 2's rank 0), the
    first ragged step an engine runs in its ``with``: each MoE block's
    input rows, the router's top-k set, the gap between its k-th and
    (k+1)-th logits and the block's output (summed over the ranks at tp
    2), and the step's sampled logits; and the slots over capacity in
    every block of the run's ragged steps. Rows are put in an order two
    engines share whatever the order they packed their spans and the
    slots they gave them: spans by their tokens, logits rows by their
    span. Installed around ``_greedy_tokens``; the probe's arithmetic runs
    after the block's own and changes nothing it computes."""

    def __init__(self, torch, eng):
        from production_stack_tpu_torch.models import llama

        self.torch, self.eng, self.llama = torch, eng, llama
        self.local = getattr(eng.runner, "_inner", eng.runner)
        self.layers = eng.config.model.num_layers
        self.moe, self.logits, self.armed = [], [], False
        self.over_capacity, self.in_step = 0, False  # every ragged step's

    def __enter__(self):
        moe, step = self.llama._moe_mlp, self.eng.runner.ragged_step
        logits = self.local._logits

        def probe_moe(cfg, lp, x, tokens=None, group=None, seq=None,
                      expert=None):
            out = moe(cfg, lp, x, tokens, group, seq, expert)
            if self.in_step:
                row = self._moe_row(cfg, lp, x, tokens, out)
                self.over_capacity += row["over_capacity"]
                if self.armed and len(self.moe) < self.layers:
                    self.moe.append(row)
            return out

        def probe_logits(*args, **kw):
            out = logits(*args, **kw)
            if self.armed and out.shape[0] == len(self.slots[0]):
                self.logits.append(out[self.slots[1]].float().cpu())
            return out

        def probe_step(*args, **kw):
            self.armed, self.in_step = not self.moe, True
            if self.armed:
                self._order(*args[:8])
            try:
                return step(*args, **kw)
            finally:
                self.armed = self.in_step = False

        self._saved = (moe, step)
        self.llama._moe_mlp = probe_moe
        self.local._logits = probe_logits
        self.eng.runner.ragged_step = probe_step
        return self

    def __exit__(self, *exc):
        self.llama._moe_mlp, self.eng.runner.ragged_step = self._saved
        del self.local._logits
        self.eng = self.local = self._saved = None  # the engine is freed

    def _order(self, tokens, _pos, _tables, _ctx, cu, _slot_map, last_idx,
               mask) -> None:
        cu = [int(c) for c in cu]
        spans = sorted((bytes(tokens[a:b].tobytes()), a, b)
                       for a, b in zip(cu[:-1], cu[1:]) if b > a)
        owner = {r: key for key, a, b in spans for r in range(a, b)}
        live = [i for i in range(len(mask)) if mask[i]]
        self.rows = self.torch.tensor([r for _, a, b in spans
                                       for r in range(a, b)])
        self.slots = (mask, sorted(live, key=lambda i: owner[int(
            last_idx[i])]))

    def _moe_row(self, cfg, lp, x, tokens, out) -> dict:
        torch = self.torch
        xt = x.reshape(-1, x.shape[-1])
        k, X = cfg.num_experts_per_tok, cfg.num_experts
        vals, idx = torch.sort((xt @ lp["router"]).float(), dim=-1,
                               descending=True, stable=True)
        cap = max(int(2.0 * (xt.shape[0] if tokens is None else tokens)
                      * k / X), k)
        load = torch.bincount(idx[:, :k].reshape(-1), minlength=X)
        row = {"over_capacity": int((load - cap).clamp(min=0).sum())}
        if self.armed:
            r = self.rows.to(xt.device)
            choice = idx[:, :k].reshape(-1)
            onehot = (choice[None, :] == torch.arange(
                X, device=xt.device)[:, None]).to(torch.int32)
            pos = (torch.cumsum(onehot, 1) - onehot).gather(
                0, choice[None, :])[0]
            row.update(dropped=(pos >= cap).view(-1, k).any(-1)[r].cpu())
            row.update(x=xt[r].cpu(), top=idx[r, :k].sort(-1).values.cpu(),
                       gap=(vals[r, k - 1] - vals[r, k]).cpu(),
                       out=out.reshape(-1, out.shape[-1])[r].cpu())
        return row


def _probe_diff(torch, ref: _FirstStepProbe, got: _FirstStepProbe) -> dict:
    """Where two engines' first ragged steps part (``_FirstStepProbe``),
    layer by layer: the MoE block's input and output, their largest
    difference and count of differing elements; the tokens routed to
    another expert set and ``ref``'s largest router gap among them; the
    slots over capacity in the step and in the whole wave. Then the step's
    logprobs, beside one bf16 step of its largest logit (the LM head's
    logits are rounded to bf16 before float32)."""
    per = collections.defaultdict(list)
    for a, b in zip(ref.moe, got.moe):
        flip = (a["top"] != b["top"]).any(-1)
        for key in ("x", "out"):
            per[f"{key}_max_abs"].append(float(
                (a[key].float() - b[key].float()).abs().max()))
            per[f"{key}_differ"].append(int((a[key] != b[key]).sum()))
        per["routed_otherwise"].append(int(flip.sum()))
        per["over_capacity"].append([a["over_capacity"], b["over_capacity"]])
        rows = (a["out"] != b["out"]).any(-1)
        per["rows_out_differ"].append(int(rows.sum()))
        per["of_them_dropping"].append(int((rows & (a["dropped"]
                                                    | b["dropped"])).sum()))
        per["their_max_gap"].append(float(a["gap"][flip].max())
                                    if flip.any() else None)
    la = torch.log_softmax(torch.cat(ref.logits), -1)
    lb = torch.log_softmax(torch.cat(got.logits), -1)
    top = float(torch.cat(ref.logits).abs().max())
    first = lambda key: next((i for i, n in enumerate(per[key])  # noqa: E731
                              if n), None)
    return {"tokens": int(ref.moe[0]["x"].shape[0]),
            "first_layer_x_differs": first("x_differ"),
            "first_layer_routed_otherwise": first("routed_otherwise"),
            "step_over_capacity": [sum(r["over_capacity"] for r in p.moe)
                                   for p in (ref, got)],
            "wave_over_capacity": [ref.over_capacity, got.over_capacity],
            "logits_rows": int(la.shape[0]),
            "logprob_max_abs": float((la - lb).abs().max()),
            "logit_bf16_step": 2.0 ** (math.floor(math.log2(top)) - 7),
            "argmax_equal": bool(torch.equal(la.argmax(-1), lb.argmax(-1))),
            "by_layer": dict(per)}


def _empty_context_decode(np, eng) -> tuple:
    """One decode step on identical inputs at any tensor-parallel size:
    every one of the engine's slots live, at position 0 (its context the
    token's own K/V, written by K1 in the step), greedy, with logprobs;
    seeded tokens, one free block a slot. Called with no request live.
    Returns (top ids (S, N), their logprobs (S, N))."""
    S = eng.config.scheduler.max_num_seqs
    M = eng._block_tables.shape[1]
    bs = eng.config.cache.block_size
    blocks = np.arange(1, S + 1, dtype=np.int32)
    tables = np.zeros((S, M), np.int32)
    tables[:, 0] = blocks
    _, _, ids, lps = eng.runner.decode_multi(
        np.random.default_rng(17).integers(
            0, eng.config.model.vocab_size, S).astype(np.int32),
        np.zeros(S, np.int32), tables, np.ones(S, np.int32), blocks * bs,
        np.zeros(S, np.float32), np.ones(S, np.float32),
        np.full(S, -1, np.int32), np.zeros(S, np.uint32),
        np.ones(S, np.int32), greedy_only=True, want_logprobs=True)
    return ids[0], lps[0]


class _RankSums:
    """tp 1 computing a tp 2 rank pair's row-parallel sums on one device,
    where they are float (the W8A16 route): ``wo`` and the experts'
    ``w_down`` as two float32 partials over the halves of their contracted
    axis, each half laid out as a rank's shard (``quant.empty_q``), added
    and rounded once. W8A8 products are left alone: their int32 sum is
    exact in any order."""

    def __init__(self, torch, mlp: int):
        from production_stack_tpu_torch.engine import quant
        from production_stack_tpu_torch.models import llama

        self.torch, self.quant, self.llama = torch, quant, llama
        self.mlp = mlp  # F: the experts' down-projection contracts it

    def _half(self, q, a: int, b: int, axes: tuple):
        out = self.quant.empty_q((b - a,) + tuple(q.shape[1:]), axes,
                                 q.device)
        out.copy_(q[a:b])
        return out

    def _partial(self, x2, q, s2, axes):
        """x2 (M, K) against q (K-first) and its scale, in two halves."""
        quant, h = self.quant, x2.shape[1] // 2
        parts = []
        for a, b in ((0, h), (h, x2.shape[1])):
            qh = self._half(q, a * q.shape[0] // x2.shape[1],
                            b * q.shape[0] // x2.shape[1], axes)
            parts.append(quant._w8a16(x2[:, a:b].contiguous(),
                                      qh.reshape(b - a, -1), s2,
                                      self.torch.float32))
        return parts[0] + parts[1]

    def __enter__(self):
        quant, llama = self.quant, self.llama
        row, experts = llama._row_parallel, quant.expert_matmul
        self._saved = (row, experts)

        def row_parallel(group, axis, x, w, n_contract=1, tokens=None,
                         delta=None):
            if (group is not None or not quant.is_quantized(w)
                    or quant.w8a8(x, w, n_contract, tokens)):
                return row(group, axis, x, w, n_contract, tokens, delta)
            lead = x.shape[:x.dim() - n_contract]
            y = self._partial(quant._rows(x, n_contract), w["q"],
                              w["s"].reshape(1, -1), tuple(range(n_contract)))
            y = y.reshape(*lead, *w["q"].shape[n_contract:]).to(x.dtype)
            return y if delta is None else y + delta

        def expert_matmul(xb, w, out_dtype, *, sx=None, group=None,
                          rows=None):
            if (group is not None or sx is not None
                    or not quant.is_quantized(w) or xb.shape[-1] != self.mlp):
                return experts(xb, w, out_dtype, sx=sx, group=group,
                               rows=rows)
            return self.torch.stack([
                self._partial(xb[e], w["q"][e], w["s"][e], (0,))
                for e in range(xb.shape[0])]).to(out_dtype)

        llama._row_parallel, quant.expert_matmul = row_parallel, expert_matmul
        return self

    def __exit__(self, *exc):
        self.llama._row_parallel, self.quant.expert_matmul = self._saved


def _perturbed_repeat(torch, eng, prompts, sp) -> tuple:
    """tp 1's own same-batch repeat: the 16 requests again at once (the
    same steps, so the same MoE capacity and dispatch), with only the
    order of the float sums changed, as tp 2 changes it (``_RankSums``).
    Returns the run and its first step's probe."""
    _fresh_slots(eng)
    with _RankSums(torch, eng.config.model.intermediate_size), \
            _FirstStepProbe(torch, eng) as probe:
        return _greedy_tokens(eng, prompts, sp), probe


def _fresh_slots(eng) -> None:
    """Give the next requests the slots a fresh engine gives them (0, 1,
    ... in arrival order), with no request live: a ragged step packs its
    spans in slot order, and where an expert's slots pass its capacity
    the tokens dropped are the last in that order."""
    free = eng.scheduler.free_slots
    if len(free) != eng.config.scheduler.max_num_seqs:
        raise AssertionError("[tp2-features] a request is still live")
    free.sort(reverse=True)


def _flip_gaps(ref: tuple, flips: list) -> float:
    """The largest top-2 gap ``ref`` had at ``flips`` (0 with none)."""
    return max([ref[1][i][n][1] for i, n in flips] + [0.0])


def moe_tp_reference(torch, np, eng) -> dict:
    """Phase 16 (a)'s tp 1 answers, on ``eng`` (``_moe_tp_engine`` at tp
    1), with the prefix cache off and the slots handed out as the fresh tp
    2 engine hands them (``_fresh_slots``): 16
    greedy prompts (``_tpf_prompts``) x ``TPF_TOKENS``, their
    first ragged step probed (``_FirstStepProbe``); the same requests at
    once again with only the float sums' order changed
    (``_perturbed_repeat``), whose deviation sets the band and whose
    flips' top-2 gaps the tie gap; an identical repeat, which must be
    bit for bit; then the empty-context decode step."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    prompts = _tpf_prompts(np, 16)
    sp = SamplingParams(temperature=0.0, max_tokens=TPF_TOKENS,
                        ignore_eos=True, logprobs=2)
    alloc = eng.scheduler.allocator
    alloc.enable_prefix_caching = False
    try:
        t0 = time.perf_counter()
        _fresh_slots(eng)
        with _FirstStepProbe(torch, eng) as probe:
            run = _greedy_tokens(eng, prompts, sp)
        wave = time.perf_counter() - t0
        sums, sums_probe = _perturbed_repeat(torch, eng, prompts, sp)
        _, rep, flips = _tp_dev(run, sums)
        _fresh_slots(eng)
        again = _greedy_tokens(eng, prompts, sp)
        decode = _empty_context_decode(np, eng)
    finally:
        alloc.enable_prefix_caching = True
    if again != run:
        raise AssertionError("[tp2-features] (a) tp 1's identical repeat of "
                             "the 16 requests is not bit for bit")
    gap = _flip_gaps(run, flips)
    log(f"[tp2-features] (a) tp 1 reference at {CUT_LAYERS} layers: 16 x "
        f"{TPF_TOKENS} "
        f"tokens in {wave:.2f} s; an identical repeat bit for bit; its own "
        f"deviation at the same batch with the float sums reordered "
        f"{rep:.4f}, {len(flips)} flip(s), top-2 gaps up to {gap:.4f}")
    return {"prompts": prompts, "sp": sp, "run": run, "repeat_dev": rep,
            "repeat_flips": len(flips), "repeat_flip_gap": gap,
            "wave_s": wave, "band": max(INT8_LP_BAND, 2 * rep),
            "tie_gap": max(INT8_TIE_GAP, 2 * gap), "probe": probe,
            "sums": sums, "sums_probe": sums_probe, "decode": decode}


def _moe_tp_engine(blocks: int, tp: int, ep: int = 1):
    """mixtral-8x7b int8 as phase 8 serves it (the CLI's scheduler, seed
    0) at ``CUT_LAYERS`` of its layers, at tensor-parallel size ``tp`` and
    expert-parallel size ``ep`` (through ``EngineConfig.mesh``: the CLI
    has no expert flag; every rank on cuda:0 over gloo), ``blocks`` KV
    blocks a rank, prefix cache off, decode eager."""
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        config_from_args,
    )

    cfg = config_from_args(build_parser().parse_args(
        ["--model", "mixtral-8x7b", "--quantization", "int8", "--seed", "0",
         "--tensor-parallel-size", str(tp), "--num-blocks", str(blocks)]))
    cfg = dataclasses.replace(
        _cut_depth(cfg), cache=dataclasses.replace(
            cfg.cache, enable_prefix_caching=False),
        scheduler=dataclasses.replace(cfg.scheduler, decode_graphs=False),
        mesh=dataclasses.replace(cfg.mesh, expert=ep))
    if tp * ep == 1:
        return LLMEngine(cfg, device="cuda")
    return LLMEngine(cfg, device="cuda", rank_devices=["cuda:0"] * (tp * ep),
                     backend="gloo")


def tp_features_phase(torch, np, counters, card: str) -> dict:
    """Phase 16 (a) and (d): mixtral-8x7b int8 at ``CUT_LAYERS`` layers and
    tensor-parallel size 2, both ranks on this card over gloo, against tp
    1's answers at the same depth (``moe_tp_reference``, its engine released
    before the ranks start): the first ragged step that of tp 1 summing as tp 2
    sums, bit for bit but the head's rounding; a decode step from an empty
    context tp 1's bit for bit; the whole wave, every token and
    every logprob, that of tp 1 summing as tp 2 sums (the band against
    plain tp 1 printed beside it); the follower's digest and launches
    rank 0's; K1-K3 launch, K4 not.
    Prints a rank's weight bytes, its KV blocks and the engine-up
    seconds, then (d) the
    step times, their share in collectives and each collective kind's
    bytes: host walls, taken while phase 17's servers start beside this
    phase (``_TpKvStart``). Returns the wave's launches."""
    from production_stack_tpu_torch.engine import quant

    t_phase = time.perf_counter()
    eng = _moe_tp_engine(MOE_TP_BLOCKS, 1)
    ref = moe_tp_reference(torch, np, eng)
    del eng
    _released(torch, "tp1 moe-int8")
    _zero(counters)
    t0 = time.perf_counter()
    eng = _moe_tp_engine(MOE_TP_BLOCKS, 2)
    up = time.perf_counter() - t0
    params = eng.runner.params
    leaves = [params["embed"], params["lm_head"], *params["layers"].values()]
    q_bytes = sum(w["q"].numel() for w in leaves if quant.is_quantized(w))
    s_bytes = sum(4 * w["s"].numel() for w in leaves if quant.is_quantized(w))
    log(f"[tp2-features] (a) mixtral-8x7b int8 at tp 2 up in {up:.1f} s "
        f"({card}; {TP_NOTE}): rank 0 holds {q_bytes} B int8 + {s_bytes} B "
        f"float32 scales, {eng.runner.num_blocks} KV blocks of "
        f"{eng.config.cache.block_size} tokens; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated in this "
        f"process")
    del params, leaves
    try:
        t1 = time.perf_counter()
        _fresh_slots(eng)
        with _FirstStepProbe(torch, eng) as probe:
            got = _greedy_tokens(eng, ref["prompts"], ref["sp"])
        wave = time.perf_counter() - t1
        launches = _counts(counters)
        reports = eng.runner.follower_reports()
        decode = _empty_context_decode(np, eng)
        moves = _ep_moves(np, eng, counters)
        steps = _tp_steps(torch, np, eng, card, "tp2-moe-int8", length=32,
                          reps=1)
        collective = eng.perf.stats_fields()["collective_bytes"]
    finally:
        eng.close()
    del eng
    _released(torch, "tp2 moe-int8")
    _expect(launches, {"K1", "K2", "K3"}, "tp2-moe-int8")
    log(f"[tp2-features] (a) the first ragged step, tp 2 against tp 1 on "
        f"identical inputs ({card}; printed, not judged): "
        f"{json.dumps(_probe_diff(torch, ref['probe'], probe))}")
    sums = _probe_diff(torch, ref["sums_probe"], probe)
    log(f"[tp2-features] (a) the first ragged step, tp 2 against tp 1 "
        f"summing as tp 2 sums ({card}): {json.dumps(sums)}")
    by = sums["by_layer"]
    if (any(by["x_differ"]) or any(by["out_differ"])
            or any(by["routed_otherwise"]) or not sums["argmax_equal"]
            or sums["logprob_max_abs"] > 2 * sums["logit_bf16_step"]):
        raise AssertionError("[tp2-features] (a) tp 2's first ragged step "
                             "is not tp 1's with tp 2's sums: every MoE "
                             "block's input and output must be bit for bit "
                             "and the logprobs within two bf16 steps of the "
                             "largest logit")
    dec = {"rows": int(decode[0].shape[0]),
           "top_ids_equal": bool(np.array_equal(decode[0], ref["decode"][0])),
           "logprob_max_abs": float(np.abs(decode[1] - ref["decode"][1])
                                    .max())}
    log(f"[tp2-features] (a) a decode step from an empty context, tp 2 "
        f"against tp 1 on identical inputs ({card}): {json.dumps(dec)}")
    if not dec["top_ids_equal"] or dec["logprob_max_abs"] != 0.0:
        raise AssertionError("[tp2-features] (a) tp 2's decode step from an "
                             "empty context is not tp 1's bit for bit")
    same, dev, flips = _tp_dev(ref["sums"], got)
    log(f"[tp2-features] (a) the wave against tp 1 summing as tp 2 sums "
        f"({card}): {same} tokens before the first flip, deviation {dev}, "
        f"{len(flips)} flip(s)")
    if got != ref["sums"]:
        raise AssertionError(
            "[tp2-features] (a) tp 2's mixtral-8x7b int8 wave is not tp 1's "
            "with tp 2's row-parallel sums bit for bit: every token and "
            f"every logprob must be ({same} tokens before the first flip, "
            f"logprobs up to {dev} apart, flips at {flips[:4]})")
    compared, worst, plain_flips = _tp_dev(ref["run"], got)
    log(f"[tp2-features] (a) the wave against plain tp 1 ({card}; printed, "
        f"not judged): {compared} tokens before the first flips, deviation "
        f"{worst} (band {ref['band']:.4f}), {len(plain_flips)} flip(s) at "
        f"top-2 gaps up to {_flip_gaps(ref['run'], plain_flips):.4f} (tie "
        f"gap {ref['tie_gap']:.4f})")
    _tp_agree("(a) moe-int8", reports, launches)
    out = {"sums_bit_for_bit": True, "tokens": sum(map(len, got[0].values())),
           "plain_tokens_compared": compared, "plain_max_logprob_dev": worst,
           "band": ref["band"], "tie_gap": ref["tie_gap"],
           "tp1_repeat_dev": ref["repeat_dev"],
           "tp1_repeat_flips": ref["repeat_flips"],
           "tp2_up_s": up, "tp2_wave_s": wave, "tp1_wave_s": ref["wave_s"],
           "calls": reports[0]["calls"], "launches": launches,
           "accountant_collective_bytes": collective}
    log(f"[tp2-features] (a) ({card}): tp 2 = tp 1 with tp 2's sums bit for "
        f"bit, the follower = rank 0 exactly: {json.dumps(out)}")
    log(f"[tp2-features] phase 16 (a) ({card}) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "steps": steps,
            # what phase 25 judges against
            "ep": {"prompts": ref["prompts"], "sp": ref["sp"],
                   "tp1_run": ref["run"], "tp2_run": got, "tp2_moves": moves}}


# -- phase 17: the KV plane under tensor parallelism ---------------------------

TPKV_N = 8  # (a)'s requests, and (b)'s wave B
TPKV_LENS = (512, 1024)  # (a)'s prompt lengths; the first is the longest
TPKV_OUT = 16  # 32 until PR 18: the same requests cut short
TPKV_TIER_N = 4  # (b)'s waves A and C, each back from a tier
TPKV_WAVE = 1024  # (b)'s prompt length
TPKV_WAVE_OUT = 16
TPKV_BS = 16
# the decode server's blocks a rank: (a)'s 8 transfers, pinned at once,
# hold at most 66 blocks each with their decode blocks; (b)'s wave B (8 x
# 65 blocks) leaves at most 16 of wave A's in the pool, so wave A's
# return is the host tier's
TPKV_D_BLOCKS = TPKV_N * (TPKV_LENS[1] + 32 + TPKV_BS) // TPKV_BS
TPKV_LONE = 2048  # (d)'s lone push: 128 full blocks


def _tpkv_prompts(np) -> list:
    rng = np.random.default_rng(17)
    lo, hi = TPKV_LENS
    lens = [hi] + [int(x) for x in rng.integers(lo, hi + 1, TPKV_N - 1)]
    return [rng.integers(0, 256, n).tolist() for n in lens]


def _tpkv_wave(base: str, prompts: list, max_tokens: int) -> list:
    """``prompts`` served at once, each answered 200 with its
    ``max_tokens`` tokens; each one's (text, logprobs)."""
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        outs = list(pool.map(
            lambda p: _kv_post(base, _kv_body(p, max_tokens)), prompts))
    if any(o["usage"]["completion_tokens"] != max_tokens for o in outs):
        raise AssertionError(f"[tp2-kv-plane] a wave's answers: "
                             f"{[o['usage'] for o in outs]}")
    return [_kv_run(o) for o in outs]


def _tpkv_ttft(base: str, n: int) -> float:
    """The median TTFT of the server's last ``n`` requests, from its
    flight records (its own clock: received to first token)."""
    return statistics.median(
        r["timeline"]["first_token"] - r["timeline"]["received"]
        for r in _obs_records(base, limit=n))


def _perf(base: str) -> dict:
    return json.loads(_http(base, "/debug/perf")[2])


def _tpkv_reference(np, base: str, card: str) -> dict:
    """Phase 17's unified answers, on the tp 2 prefill server's own
    serve, as phase 9 takes them: (a)'s prompts twice; the repeat's
    deviation sets the band."""
    prompts = _tpkv_prompts(np)
    t0 = time.perf_counter()
    runs = _tpkv_wave(base, prompts, TPKV_OUT)
    wave_s = time.perf_counter() - t0
    again = _tpkv_wave(base, prompts, TPKV_OUT)
    noise = max(_kv_dev(u, r)[1] for u, r in zip(runs, again))
    band = max(BF16_LOGPROB_BAND, 2 * noise)
    log(f"[tp2-kv-plane] the tp 2 prefill server's unified answers ({card}): "
        f"{TPKV_N} prompts of {TPKV_LENS[0]}-{TPKV_LENS[1]} tokens x "
        f"{TPKV_OUT} in {wave_s:.2f} s; its own repeat deviates by up to "
        f"{noise:.4f}: band {band:.4f}")
    return {"prompts": prompts, "runs": runs, "noise": noise, "band": band,
            "wave_s": wave_s}


def _tpkv_pd(np, P, D, ref: dict, card: str, tag: str = "tp2-kv-plane",
             lone: int = TPKV_LONE, what: str = f"at tp 2 ({{}}; {TP_NOTE})"
             ) -> dict:
    """(a) Pull, then push and splice, P -> D, judged as phase 9 judges
    them against the unified server's answers; then (d)'s lone push of a
    fresh ``lone``-token prompt, whose landed blocks (read before the
    decode hop attaches them) equal the producer's, bit for bit. ``tag``
    and ``what`` (``card`` formatted into it) name the phase in its
    messages (phase 17's by default, phase 24 (c)'s)."""
    prompts, runs, band = ref["prompts"], ref["runs"], ref["band"]
    bs = TPKV_BS

    def pull(prompt):
        pre = _kv_post(P.base, _kv_body(prompt, 1, kv_transfer_params={
            "do_remote_decode": True}))
        kv = dict(pre["kv_transfer_params"], remote_host=P.base)
        return _kv_post(D.base, _kv_body(prompt, TPKV_OUT,
                                         kv_transfer_params=kv))

    def imports() -> int:
        return _perf(D.base)["kv_transfer"]["transfers"].get(
            "import", {}).get("count", 0)

    t0, imports0 = time.perf_counter(), imports()
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        pulled = list(pool.map(pull, prompts))
    pull_s = time.perf_counter() - t0
    n_imports = imports() - imports0
    same = []
    for i, (prompt, out) in enumerate(zip(prompts, pulled)):
        want = (len(prompt) - 1) // bs * bs
        got = out["usage"]["prompt_tokens_details"]["cached_tokens"]
        if got != want:
            raise AssertionError(f"[{tag}] pull {i}: cached_tokens "
                                 f"{got}, the import lands {want}")
        same.append(_kv_same(f"{tag} pull {i}", runs[i], _kv_run(out),
                             band))
    if n_imports != len(prompts):
        raise AssertionError(f"[{tag}] pull: {n_imports} imports, "
                             f"want {len(prompts)}")

    def push(i):
        tid = f"{tag}-xfer-{i}-{time.monotonic_ns()}"
        pre = _kv_post(P.base, _kv_body(prompts[i], 1, kv_transfer_params={
            "do_remote_decode": True, "push_url": D.base,
            "transfer_id": tid}))
        kv = pre["kv_transfer_params"]
        if not kv.get("pushed"):
            raise AssertionError(f"[{tag}] push {i} failed")
        first = _kv_run(pre)
        dec = _kv_post(D.base, _kv_body(
            prompts[i] + [ord(first[0])], TPKV_OUT - 1, kv_transfer_params={
                "do_remote_prefill": True, "transfer_id": tid,
                "remote_block_ids": kv["remote_block_ids"],
                "remote_host": P.base}))
        rest = _kv_run(dec)
        return first[0] + rest[0], first[1] + rest[1]

    t0, spliced0 = time.perf_counter(), _spliced(D.base)
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        pushed = list(pool.map(push, range(len(prompts))))
    push_s = time.perf_counter() - t0
    spliced = _spliced(D.base) - spliced0
    if spliced != len(prompts):
        raise AssertionError(f"[{tag}] push: {spliced} splices, want "
                             f"{len(prompts)} (a re-prefill is a failure)")
    same += [_kv_same(f"{tag} push {i}", runs[i], run, band)
             for i, run in enumerate(pushed)]

    # (d) the lone push
    rng = np.random.default_rng(20)
    prompt = rng.integers(0, 256, lone).tolist()
    n_blocks = lone // bs
    tid = f"{tag}-lone-{time.monotonic_ns()}"
    totals = _perf(P.base)["kv_transfer"]["transfers"]
    before = totals.get("push", {"bytes": 0, "seconds": 0.0})
    pre = _kv_post(P.base, _kv_body(prompt, 1, kv_transfer_params={
        "do_remote_decode": True, "push_url": D.base, "transfer_id": tid}))
    after = _perf(P.base)["kv_transfer"]["transfers"]["push"]
    nbytes = after["bytes"] - before["bytes"]
    secs = after["seconds"] - before["seconds"]
    src = pre["kv_transfer_params"]["remote_block_ids"]
    dst = _perf(D.base)["kv_transfer"]["pending_blocks"][tid]
    mine = _http(P.base, "/kv/export", {"blocks": src[:n_blocks]})
    theirs = _http(D.base, "/kv/export", {"blocks": dst[:n_blocks]})
    if (not pre["kv_transfer_params"].get("pushed") or len(dst) != len(src)
            or mine[0] != 200 or theirs[0] != 200 or mine[2] != theirs[2]):
        raise AssertionError(f"[{tag}] lone push: the decode server's "
                             "blocks differ from the producer's")
    spliced0 = _spliced(D.base)
    _kv_post(D.base, _kv_body(prompt + [ord(_kv_run(pre)[0][0])], 1,
                              kv_transfer_params={"transfer_id": tid}))
    if _spliced(D.base) != spliced0 + 1:
        raise AssertionError(f"[{tag}] lone push was not spliced")
    out = {"pulls": len(prompts), "imports": n_imports,
           "pushes": len(prompts),
           "spliced": spliced, "tokens_compared": sum(n for n, _ in same),
           "max_logprob_dev": max(w for _, w in same), "band": band,
           "pull_wave_s": pull_s, "push_wave_s": push_s,
           "lone_push": {"blocks": len(src), "bit_identical_blocks":
                         n_blocks, "bytes": nbytes, "seconds": secs,
                         "gb_s": nbytes / secs / 1e9}}
    log(f"[{tag}] (a) P -> D {what.format(card)}: {json.dumps(out)}")
    return out


def _tpkv_tiers(np, P, D, band: float, store, card: str) -> dict:
    """(b) The host tier on D (wave A, wave B evicting it from the pool,
    wave A again) and the remote tier (wave C served by P, which offloads
    it at finish, then by D, whose pool and host tier never held it):
    each wave back hits at least 90% of the usable blocks, its tokens
    equal the first serve's as (a)'s are judged."""
    from production_stack_tpu_torch.engine.kv_cache import HASH_SEED
    from production_stack_tpu_torch.engine.kv_offload import chain_hashes

    bs = TPKV_BS
    rng = np.random.default_rng(19)
    wave_a, wave_b, wave_c = (
        [rng.integers(0, 256, TPKV_WAVE).tolist() for _ in range(n)]
        for n in (TPKV_TIER_N, TPKV_N, TPKV_TIER_N))
    usable = TPKV_TIER_N * ((TPKV_WAVE - 1) // bs)

    def tier(name: str) -> tuple:
        t = _perf(D.base)["kv_tier"]
        return t["tiers"][name]["hits"], t["prefetch"]["blocks"]

    first = _tpkv_wave(D.base, wave_a, TPKV_WAVE_OUT)
    ttft_cold = _tpkv_ttft(D.base, TPKV_TIER_N)
    _tpkv_wave(D.base, wave_b, TPKV_WAVE_OUT)
    hits0, blocks0 = tier("host")
    again = _tpkv_wave(D.base, wave_a, TPKV_WAVE_OUT)
    ttft_host = _tpkv_ttft(D.base, TPKV_TIER_N)
    hits1, blocks1 = tier("host")
    host = {"hits": hits1 - hits0, "committed": blocks1 - blocks0}
    if min(host.values()) < 0.9 * usable:
        raise AssertionError(f"[tp2-kv-plane] host tier: {host} of "
                             f"{usable} usable blocks")
    same = [_kv_same(f"tp2 host tier {i}", first[i], again[i], band)
            for i in range(TPKV_TIER_N)]

    on_p = _tpkv_wave(P.base, wave_c, TPKV_WAVE_OUT)
    keys = {str(h) for p in wave_c
            for h in chain_hashes(p, bs, HASH_SEED)[:(TPKV_WAVE - 1) // bs]}
    t_end = time.monotonic() + 120
    while True:
        with store._lock:
            left = len(keys - store.blocks.keys())
        if not left:
            break
        if time.monotonic() > t_end:
            raise AssertionError(f"[tp2-kv-plane] remote tier: {left} of "
                                 f"wave C's blocks never put")
        time.sleep(0.05)
    hits0, blocks0 = tier("remote")
    warm = _tpkv_wave(D.base, wave_c, TPKV_WAVE_OUT)
    ttft_remote = _tpkv_ttft(D.base, TPKV_TIER_N)
    hits1, blocks1 = tier("remote")
    remote = {"hits": hits1 - hits0, "committed": blocks1 - blocks0}
    if min(remote.values()) < 0.9 * usable:
        raise AssertionError(f"[tp2-kv-plane] remote tier: {remote} of "
                             f"{usable} usable blocks")
    same += [_kv_same(f"tp2 remote tier {i}", on_p[i], warm[i], band)
             for i in range(TPKV_TIER_N)]
    tiers = _perf(D.base)["kv_tier"]
    out = {"waves": f"A and C {TPKV_TIER_N}, B {TPKV_N} x {TPKV_WAVE} "
                    f"tokens, {TPKV_WAVE_OUT} out",
           "pool_blocks": TPKV_D_BLOCKS, "usable_blocks": usable,
           "host": host, "remote": remote,
           "tokens_compared": sum(n for n, _ in same),
           "max_logprob_dev": max(w for _, w in same),
           "ttft_median_s": {"cold": ttft_cold, "warm_host": ttft_host,
                             "warm_remote": ttft_remote},
           "bytes": tiers["bytes"], "prefetch": {
               k: tiers["prefetch"][k] for k in ("submitted", "committed",
                                                 "dropped", "blocks")},
           "remote_refused": tiers["tiers"]["remote"]["refused"]}
    log(f"[tp2-kv-plane] (b) the tiers at tp 2 ({card}; {TP_NOTE}): "
        f"{json.dumps(out)}")
    return out


class _TpKvStart:
    """Phase 17's processes, started before phase 16 so that their
    start-up (~25 s, most of it on the host) runs beside phase 16's
    waves: the remote tier's store in this process, the command line's
    refusal (``_tp_cli_refusal``), and the prefill and the decode server
    (``_TpServer``, ``--role`` passed through, both with
    ``--remote-kv-url`` to the store). ``close`` stops the store and
    kills whatever is left of the processes."""

    def __init__(self):
        from production_stack_tpu_torch.kv_server import KVServer

        self.cli, self.servers = None, []
        self.store = KVServer()
        url = f"http://127.0.0.1:{self.store.start('127.0.0.1', 0)}"
        try:
            self.cli = _tp_cli_refusal()
            self.P = self._start(["--role", "prefill", "--remote-kv-url",
                                  url])
            self.D = self._start(["--role", "decode", "--num-blocks",
                                  str(TPKV_D_BLOCKS), "--kv-host-cache-bytes",
                                  str(KV_HOST_BYTES), "--remote-kv-url", url])
        except BaseException:
            self.close()
            raise

    def _start(self, extra: list) -> _TpServer:
        srv = _TpServer(extra)
        self.servers.append(srv)
        return srv

    def close(self) -> None:
        if self.cli is not None and self.cli.poll() is None:
            self.cli.kill()
            self.cli.wait(30)
        for srv in self.servers:
            srv.kill()
        self.servers = []
        if self.store is not None:
            self.store.shutdown()
            self.store = None


def tp_kv_phase(np, card: str, tp1: dict, moves: dict,
                started: _TpKvStart) -> dict:
    """Phase 17 (``tp2-kv-plane``): llama-3-8b bf16 at ``CUT_LAYERS``
    layers and tensor-parallel size 2, a prefill and a decode server each
    in a fresh process (``--tp-server``, ``server.main``, both ranks of
    each on this card over gloo), started beside phase 16
    (``started``), and the remote tier's store in this process. Phase
    15 (c) runs on the prefill server
    (``_tp_server_checks``; the CLI's refusal beside the servers' start),
    whose unified answers are the reference (``_tpkv_reference``); then
    (a) pull, then push and splice (``_tpkv_pd``), (b) the host and the
    remote tier (``_tpkv_tiers``); (d) prints tp 2's rates beside phase
    9's tp 1 figures (``tp1``) and phase 15's 128-block gather and
    scatter at tp 2 (``moves``). Both servers leave on SIGTERM, their
    followers within ``TP_GONE_S``. Returns rank 0's launches, summed
    over both servers, each read before and after (a) and (b), and the
    servers' pids."""
    t_phase = time.perf_counter()
    P, D, cli, store = started.P, started.D, started.cli, started.store
    servers = list(started.servers)
    try:
        P.up("tp2-kv-plane")
        D.up("tp2-kv-plane")
        refused = _tp_cli_refused(cli)
        routes = _tp_server_checks(np, P.base, card)
        ref = _tpkv_reference(np, P.base, card)
        before = [srv.launches() for srv in servers]
        pd = _tpkv_pd(np, P, D, ref, card)
        tiers = _tpkv_tiers(np, P, D, ref["band"], store, card)
        after = [srv.launches() for srv in servers]
        stops = {"prefill": P.stop("tp2-kv-plane"),
                 "decode": D.stop("tp2-kv-plane")}
    finally:
        started.close()
    log(f"[tp] (c) the prefill server ({card}; {TP_NOTE}): " + json.dumps({
        "up_s": P.up_s, "reference_wave_s": ref["wave_s"],
        "requests": TPKV_N, "routes": routes, **stops["prefill"],
        "cli_refusal": refused}))
    launches = {k: sum(a[k] - b[k] for a, b in zip(after, before))
                for k in after[0]}
    _expect(launches, {"K1", "K2", "K3"}, "tp2-kv-plane")
    figures = {
        "tp2": {"push_gb_s": pd["lone_push"]["gb_s"], **moves,
                "ttft_cold_s": tiers["ttft_median_s"]["cold"],
                "ttft_host_s": tiers["ttft_median_s"]["warm_host"],
                "ttft_remote_s": tiers["ttft_median_s"]["warm_remote"]},
        "tp1 (phase 9)": tp1}
    log(f"[tp2-kv-plane] (d) ({card}; printed, not judged; {TP_NOTE}): "
        f"{json.dumps(figures)}")
    log(f"[tp2-kv-plane] servers up in {P.up_s:.1f} and {D.up_s:.1f} s; "
        f"stops {json.dumps(stops)}; launches on rank 0 of both "
        f"{json.dumps(launches)}; phase 17 ({card}) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "pids": [srv.proc.pid for srv in servers]}


def _tp_kv_moves(torch, eng, card: str) -> dict:
    """(d) A 128-block export and import at tp 2 on phase 15 (a)'s ragged
    engine: host wall of the whole (both ranks' gathers, rank 1's share
    over gloo, the join, one copy to the host; the split, the share back
    and both scatters), and the device time of rank 0's own gather and
    scatter (its half of the heads) as CUDA events time them."""
    runner, n = eng.runner, 128
    inner, L = runner._inner, eng.config.model.num_layers
    ids = list(range(0, 2 * n, 2))
    walls = {"export": [], "import": []}
    for _ in range(3):
        t0 = time.perf_counter()
        data = runner.export_blocks(ids)
        walls["export"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        runner.import_blocks(ids, data)
        torch.cuda.synchronize()
        walls["import"].append(time.perf_counter() - t0)
    dev = inner.gather_blocks(ids, 0, L)
    out = {"blocks": n, "bytes": data.nbytes,
           "export_wall_ms": statistics.median(walls["export"]) * 1e3,
           "import_wall_ms": statistics.median(walls["import"]) * 1e3,
           "rank0_gather_ms": time_ms(torch, lambda: inner.gather_blocks(
               ids, 0, L), 20, graph=False),
           "rank0_scatter_ms": time_ms(torch, lambda: inner.scatter_blocks(
               ids, 0, dev), 20, graph=False)}
    del data, dev
    log(f"[tp2-kv-plane] (d) 128 blocks out and back in at tp 2 ({card}; "
        f"{TP_NOTE}): {json.dumps(out)}")
    return out


# -- phase 18: Whisper under tensor parallelism ----------------------------

TPW_MODEL = "whisper-large-v3-class"
# (a)'s clips: (seconds, rate, kind), each in its own mode
TPW_CLIPS = ((5.0, 16000, "tone"), (12.0, 44100, "noise"),
             (30.0, 16000, "tone"))
TPW_MODES = (dict(), dict(language="en", task="translate"),
             dict(language="en", timestamps=True))
TPW_TOKENS = 16  # (a)'s max_tokens a clip
TPW_HTTP_TOKENS = 8  # (b)'s
TPW_CHUNK = 8  # (c)'s timed chunk


class _WhisperRankSums:
    """tp 1 computing a tp 2 rank pair's products on one device, in their
    shapes (models/whisper.py, tensor parallelism): each column-parallel
    product (Q, K and V over heads, ``fc1`` over the MLP axis, the tied
    logits over the vocabulary) and each attention made on each half as a
    rank holds it (a contiguous copy of that half of the weights), the
    halves side by side; each row-parallel product (``wo``, ``cwo``,
    ``fc2``) as two float32 partials over the halves of its contracted
    axis, added and rounded to the model dtype once, its bias after. The
    embedding's sum over the ranks adds only zeros, so it is left whole."""

    def __init__(self, torch):
        from production_stack_tpu_torch.engine import quant
        from production_stack_tpu_torch.models import whisper as W

        self.torch, self.quant, self.W = torch, quant, W
        self.names = ("_heads", "_attention", "_up", "_row_parallel",
                      "_logits")

    @staticmethod
    def _halves(n: int) -> tuple:
        return ((0, n // 2), (n // 2, n))

    @staticmethod
    def _cut(x, dim: int, a: int, b: int):
        return x.narrow(dim, a, b - a).contiguous()

    def __enter__(self):
        torch, W, cut, halves = self.torch, self.W, self._cut, self._halves
        self._saved = {n: getattr(W, n) for n in self.names}
        heads, attention, up, row, logits = (self._saved[n]
                                             for n in self.names)

        def heads_(x, w, b=None):
            return torch.cat([heads(x, cut(w, 1, a, c), None if b is None
                                    else cut(b, 0, a, c)).contiguous()
                              for a, c in halves(w.shape[1])], dim=1)

        def attention_(q, k, v, mask=None):
            return torch.cat([attention(q[:, a:c], k[:, a:c], v[:, a:c],
                                        mask)
                              for a, c in halves(q.shape[1])], dim=1)

        def up_(x, w, b):
            return torch.cat([up(x, cut(w, 1, a, c), cut(b, 0, a, c))
                              for a, c in halves(w.shape[1])], dim=-1)

        def row_(group, axis, x, w):
            if group is not None:
                return row(group, axis, x, w)
            parts = [self.quant.matmul_f32(
                cut(x, x.dim() - 1, a, c).reshape(-1, c - a),
                cut(w, 0, a, c)) for a, c in halves(x.shape[-1])]
            return (parts[0] + parts[1]).to(x.dtype).reshape(
                *x.shape[:-1], w.shape[-1])

        def logits_(group, h, embed, dt):
            if group is not None:
                return logits(group, h, embed, dt)
            return torch.cat([logits(None, h, cut(embed, 0, a, c), dt)
                              for a, c in halves(embed.shape[0])], dim=-1)

        for n, fn in zip(self.names, (heads_, attention_, up_, row_,
                                      logits_)):
            setattr(W, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self.W, n, fn)


def _tpw_clips(np, runner) -> list:
    """(a)'s clips as features, with their modes."""
    from production_stack_tpu_torch.engine import audio

    return [(audio.wav_to_features(_wav(np, sec, rate, kind, seed=30 + i),
                                   runner.cfg.num_mel_bins,
                                   runner.chunk_frames)[0], TPW_MODES[i])
            for i, (sec, rate, kind) in enumerate(TPW_CLIPS)]


def _tpw_runs(runner, clips) -> list:
    """Each clip greedy, to ``TPW_TOKENS``: (tokens, info)."""
    out = []
    for feats, kw in clips:
        info: dict = {}
        toks = runner.transcribe(feats, info=info, max_tokens=TPW_TOKENS,
                                 **kw)
        out.append((toks, info))
    return out


def _tpw_band(ref: list, got: list) -> dict:
    """Where ``got`` parts from ``ref``: flips, the largest logprob
    deviation before each clip's first flip, no_speech_prob's."""
    flips, worst, nsp = 0, 0.0, 0.0
    for (rt, ri), (gt, gi) in zip(ref, got):
        n = next((i for i, (a, b) in enumerate(zip(rt, gt)) if a != b),
                 min(len(rt), len(gt)))
        flips += n < max(len(rt), len(gt))
        worst = max([worst] + [abs(a - b) for a, b in zip(
            ri["logprobs"][:n], gi["logprobs"][:n])])
        nsp = max(nsp, abs(ri["no_speech_prob"] - gi["no_speech_prob"]))
    return {"clips_parted": flips, "max_logprob_dev": worst,
            "max_no_speech_dev": nsp}


def _tpw_numbers(torch, runner, clips) -> dict:
    """(c) on ``runner`` (tp 1's, or the tp 2 server's), twice: a 30 s
    clip's encode + cross K/V wall to a synchronise, a ``TPW_CHUNK``-token
    chunk's wall a token, and the bytes each rank holds (weights; one live
    request's cross K/V and self-attention cache)."""
    import itertools

    dev, feats = runner.dev, clips[2][0]
    forced = runner._forced_tokens("en", "transcribe", None)
    P = runner._bucket(len(forced))
    enc, tok = [], []
    for h in itertools.islice(runner._handles, 2):
        with runner.lock:
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dev.encode_request(h, feats)
                torch.cuda.synchronize()
                enc.append((time.perf_counter() - t0) * 1e3)
                dev.prefill_request(h, forced + [0] * (P - len(forced)),
                                    len(forced), 0)
                held = runner.held_by_rank()
                t0 = time.perf_counter()
                toks, _, _ = dev.chunk_request(
                    h, runner.cfg.max_model_len, 0.0, False, TPW_CHUNK)
                torch.cuda.synchronize()
                tok.append((time.perf_counter() - t0) * 1e3 / len(toks))
            finally:
                dev.free(h)
    return {"encode_wall_ms": statistics.median(enc),
            "token_wall_ms": statistics.median(tok),
            "weight_bytes_by_rank": [r["params"] for r in held],
            "request_bytes_by_rank": [sum(r["requests"].values())
                                      for r in held]}


def _tpw_http(np, server, port: int) -> dict:
    """(b) 6 concurrent requests to the tp 2 server (``--max-num-seqs
    4``): four whole, one SSE stream read to ``[DONE]``, one SSE stream
    left after its headers; every response 200, the abort counted."""
    clips = [_wav(np, sec, rate, kind, seed=40 + i)
             for i, (sec, rate, kind) in enumerate(
                 TPW_CLIPS + TPW_CLIPS)]
    fmts = ("json", "verbose_json", "srt", "text")
    base = f"http://127.0.0.1:{port}"
    key = ("pstpu_transcription_aborted_requests_total",
           (("endpoint", "audio.transcribe"),))
    aborted0 = parse_exposition(_http(base, "/metrics")[2].decode()).get(
        key, 0.0)

    def whole(i):
        path = ("/v1/audio/translations" if i % 2
                else "/v1/audio/transcriptions")
        fields = dict(model=TPW_MODEL, max_tokens=str(TPW_HTTP_TOKENS),
                      response_format=fmts[i])
        if i != 1:
            fields["language"] = "en"
        t0 = time.perf_counter()
        status, _, body = _post_form(port, path, *_form(clips[i], **fields))
        return status, body, time.perf_counter() - t0

    def streamed(_):
        t0 = time.perf_counter()
        status, _, body = _post_form(port, "/v1/audio/transcriptions",
                                     *_form(clips[4], language="en",
                                            stream="true", max_tokens=str(
                                                TPW_HTTP_TOKENS)))
        events = [ln for ln in body.decode().split("\n")
                  if ln.startswith("data: ")]
        if not events or events[-1] != "data: [DONE]":
            raise AssertionError(f"[tp2-whisper] (b) SSE: {events[-3:]}")
        return status, b"", time.perf_counter() - t0

    def left(_):
        body, ctype = _form(clips[5], language="en", stream="true")
        sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        sock.sendall((f"POST /v1/audio/transcriptions HTTP/1.1\r\nHost: "
                      f"x\r\nContent-Type: {ctype}\r\nContent-Length: "
                      f"{len(body)}\r\n\r\n").encode() + body)
        head = b""
        while b"\r\n\r\n" not in head:
            head += sock.recv(4096)
        sock.close()
        return int(head.split()[1]), b"", 0.0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        futs = [pool.submit(whole, i) for i in range(4)]
        futs += [pool.submit(streamed, 4), pool.submit(left, 5)]
        answers = [f.result() for f in futs]
    wave_s = time.perf_counter() - t0
    if any(a[0] != 200 for a in answers):
        raise AssertionError(f"[tp2-whisper] (b) statuses "
                             f"{[(a[0], a[1][:200]) for a in answers]}")
    t_end = time.monotonic() + 120
    aborted = aborted0
    while aborted == aborted0 and time.monotonic() < t_end:
        time.sleep(0.1)
        aborted = parse_exposition(_http(base, "/metrics")[2].decode()).get(
            key, 0.0)
    if aborted != aborted0 + 1:
        raise AssertionError(f"[tp2-whisper] (b) aborted {aborted0} -> "
                             f"{aborted}")
    return {"requests": 6, "wave_s": wave_s, "aborted": aborted - aborted0,
            "latency_s": [a[2] for a in answers[:5]]}


class _TpWhisperServer(_TpServer):
    """A ``--tp-server`` child serving whisper-large-v3-class: up once
    ``/health`` answers, its follower found among its children."""

    def __init__(self):
        super().__init__(["--model", TPW_MODEL, "--max-num-seqs", "4"])

    def up(self, tag: str, timeout: float = 300) -> dict:
        while True:
            try:
                _http(self.base, "/health")
                break
            except (urllib.error.URLError, ConnectionError):
                if (self.proc.poll() is not None
                        or time.perf_counter() - self.t0 > timeout):
                    raise AssertionError(
                        f"[{tag}] the server did not come up (exit "
                        f"{self.proc.poll()}):\n{self.log_tail()}")
                time.sleep(0.5)
        self.up_s = time.perf_counter() - self.t0
        self.pids = [self.proc.pid] + _spawned_children(self.proc.pid)
        if len(self.pids) != 2:
            raise AssertionError(f"[{tag}] follower pids {self.pids[1:]}")
        return {"pids": self.pids}


def _spawned_children(pid: int) -> list:
    """The processes ``pid`` started with multiprocessing's spawn (its
    tensor-parallel followers)."""
    import os

    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                spawned = b"spawn_main" in f.read()
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid and spawned:
            out.append(int(d))
    return out


def tp_whisper_phase(torch, np, counters, card: str) -> dict:
    """Phase 18 (``tp2-whisper``): whisper-large-v3-class in bf16 at
    ``CUT_LAYERS`` of its encoder and decoder layers (``_CutServers``) and
    tensor-parallel size 2, both ranks on this card over gloo, through
    ``server_from_args`` with ``--max-num-seqs 4``. (a) three clips,
    greedy, equal bit for bit (tokens, logprobs, no_speech_prob, the
    language) to tp 1 summing as tp 2 sums (``_WhisperRankSums``), the
    band against plain tp 1 printed; (b) 6 concurrent requests over HTTP,
    one streamed, one left: every response 200, every rank's digest and
    call count rank 0's, no rank holding a handle or launching a kernel;
    (c) printed: the bytes a rank holds, an encode's and a token's wall at
    tp 2 beside tp 1; (d) a server in a fresh process (``--tp-server``)
    answers one request, and its follower is gone within ``TP_GONE_S`` of
    SIGTERM. Returns rank 0's launches: K1-K4 all 0."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        server_from_args,
    )
    from production_stack_tpu_torch.engine.whisper_runner import (
        WhisperRunner,
    )

    t_phase = time.perf_counter()
    child = _TpWhisperServer()  # comes up while (a) runs
    try:
        tp1 = WhisperRunner(_cut_depth(EngineConfig.for_model(
            TPW_MODEL, seed=0)), device="cuda")
        clips = _tpw_clips(np, tp1)
        plain = _tpw_runs(tp1, clips)
        with _WhisperRankSums(torch):
            sums = _tpw_runs(tp1, clips)
        figures = {"tp1": _tpw_numbers(torch, tp1, clips)}
        del tp1
        _released(torch, "tp2-whisper tp 1")
        _zero(counters)
        t0 = time.perf_counter()
        with _CutServers():
            server = server_from_args(build_parser().parse_args(
                ["--model", TPW_MODEL, "--max-num-seqs", "4", "--seed", "0",
                 "--tensor-parallel-size", "2"]),
                rank_devices=["cuda:0", "cuda:0"], backend="gloo")
        up_s = time.perf_counter() - t0
        runner = server.runner
        try:
            t0 = time.perf_counter()
            got = _tpw_runs(runner, clips)
            a_s = time.perf_counter() - t0
            first = runner.follower_reports()
            figures["tp2"] = _tpw_numbers(torch, runner, clips)
            http = _tpw_http(np, server, server.start("127.0.0.1", 0))
            reports = runner.follower_reports()
            held = runner.held_by_rank()
        finally:
            server.shutdown()
        launches = _counts(counters)
        del server, runner
        _released(torch, "tp2-whisper tp 2")
        child.up("tp2-whisper")
        status, _, _ = _post_form(int(child.base.rsplit(":", 1)[1]),
                                  "/v1/audio/transcriptions",
                                  *_form(_wav(np, 5.0, 16000, seed=50),
                                         language="en", max_tokens="8"))
        if status != 200:
            raise AssertionError(f"[tp2-whisper] (d) status {status}:\n"
                                 f"{child.log_tail()}")
        stop = child.stop("tp2-whisper")
    finally:
        child.kill()
    if got != sums:
        for i, ((st, si), (gt, gi)) in enumerate(zip(sums, got)):
            band = _tpw_band([(st, si)], [(gt, gi)])
            log(f"[tp2-whisper] (a) clip {i}: tp 1 with tp 2's sums "
                f"{st[:12]} {si.get('language')} {si['no_speech_prob']!r}; "
                f"tp 2 {gt[:12]} {gi.get('language')} "
                f"{gi['no_speech_prob']!r}; {band}")
        raise AssertionError("[tp2-whisper] (a) tp 2 is not tp 1 with tp 2's "
                             "sums bit for bit")
    for tag, reps in (("(a)", first), ("(b)", reports)):
        if (len({(r["calls"], r["digest"]) for r in reps}) != 1
                or any(r["diverged_at"] is not None or r["live"]
                       for r in reps)):
            raise AssertionError(f"[tp2-whisper] {tag} ranks: {reps}")
        if any(n for r in reps[1:] for n in r["launches"].values()):
            raise AssertionError(f"[tp2-whisper] {tag} a follower launched "
                                 f"a kernel: {reps}")
    if any(h["requests"] for h in held):
        raise AssertionError(f"[tp2-whisper] (b) handles left: {held}")
    _expect(launches, set(), "tp2-whisper")
    out = {"tokens_compared": sum(len(t) for t, _ in got),
           "clips": len(got), "bit_for_bit_with_tp2_sums": True,
           "against_plain_tp1": _tpw_band(plain, got),
           "languages": [i["language"] for _, i in got],
           "tp2_up_s": up_s, "a_s": a_s, "calls": reports[0]["calls"]}
    log(f"[tp2-whisper] (a) {TPW_MODEL} bf16 at tp 2 ({card}): "
        f"{json.dumps(out)}")
    ranks = [(r["rank"], r["calls"], r["live"]) for r in reports]
    log(f"[tp2-whisper] (b) over HTTP, --max-num-seqs 4 ({card}; "
        f"{TP_NOTE}): {json.dumps(http)}; ranks {ranks}")
    log(f"[tp2-whisper] (c) ({card}; printed, not judged; {TP_NOTE}): "
        f"{json.dumps(figures)}")
    log(f"[tp2-whisper] (d) a fresh server up in {child.up_s:.1f} s; "
        f"{json.dumps(stop)}; phase 18 ({card}) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 19: pipeline parallelism, two stages sharing one card ---------------

PP_NOTE = "two stages share one card: not a PP speed"


def _pp_engine():
    """llama-3-8b bf16 at full depth, seed 0, two pipeline stages on
    cuda:0, as (a)'s tp 1 bucketed reference (``_tp_engine``): prefix
    cache off, decode eager, ``TP_BLOCKS`` blocks a stage."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    cfg = EngineConfig.for_model(
        "llama-3-8b", seed=0, attention_impl="bucketed",
        cache=CacheConfig(enable_prefix_caching=False, num_blocks=TP_BLOCKS),
        scheduler=SchedulerConfig(decode_graphs=False),
        mesh=MeshConfig(stage=2, tensor=1))
    return LLMEngine(cfg, device="cuda", stage_devices=["cuda:0"] * 2)


def _pp_decode_ms(torch, np, eng) -> list:
    """(d) The host wall of three decode steps at 64 rows (contexts of
    128 + a few tokens), each to a synchronise."""
    _dg_admit(np, eng, np.random.default_rng(16), "pp-d", 64, 128, 64)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _dg_clear(eng)
    return walls


def _pp_server(torch, np, pp: int) -> dict:
    """(c)-(e) The bucketed server from the flags at
    ``--pipeline-parallel-size pp``, every stage on cuda:0, its pools
    sized from the card's free memory (pp 1 decodes through graphs, pp 2
    eagerly): its pools, a completion, (d)'s decode step on the engine
    thread, and at pp 2 a logprobs request, which must answer 400."""
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        server_from_args,
    )

    t0 = time.perf_counter()
    server = server_from_args(build_parser().parse_args(
        ["--model", "llama-3-8b", "--seed", "0", "--skip-warmup",
         "--attention-impl", "bucketed", "--pipeline-parallel-size",
         str(pp)]), stage_devices=["cuda:0"] * pp if pp > 1 else None)
    try:
        base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
        up = time.perf_counter() - t0
        runner = server.engine.runner
        pools = [int(r.kv.shape[1])
                 for r in getattr(runner, "stages", [runner])]
        body = {"model": "llama-3-8b", "prompt": list(range(100, 164)),
                "max_tokens": 16, "temperature": 0.0, "ignore_eos": True}
        status, out, wall = _post(base, "/v1/completions", body)
        if status != 200 or out["usage"]["completion_tokens"] != 16:
            raise AssertionError(f"[pp2] (e) pp {pp}'s completion: "
                                 f"{status} {out}")
        decode_ms = server.async_engine.run_on_engine(
            lambda eng: _pp_decode_ms(torch, np, eng))
        lp_status = None
        if pp > 1:
            lp_body = ""
            try:
                _post(base, "/v1/completions", {**body, "logprobs": 2})
                lp_status = 200
            except urllib.error.HTTPError as e:
                lp_status, lp_body = e.code, e.read().decode()
            if lp_status != 400 or "pipeline parallelism" not in lp_body:
                raise AssertionError(f"[pp2] (e) a logprobs request "
                                     f"answered {lp_status} {lp_body!r}, "
                                     "not 400")
    finally:
        server.shutdown()
    del server, runner
    _released(torch, f"pp {pp} server")
    return {"up_s": up, "pools": pools, "completion_s": wall,
            "decode_64_ms": decode_ms, "logprobs_status": lp_status}


def pp_phase(torch, np, counters, card: str) -> dict:
    """Phase 19: llama-3-8b at pipeline-parallel size 2, both stages on
    this card. (a) identity against the tp 1 bucketed engine at full depth on
    phase 15's prompts (run first and released) and (b) its launches; then the
    server from the flags at pp 1 and at pp 2 in turn, in the same state of the
    card: (c) the stages' weight bytes and the pools each sized, (d) a decode
    step's wall, (e) the
    requests. Returns (a)'s launches."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    t_phase = time.perf_counter()
    prompts = _tp_prompts(np)
    sp = SamplingParams(temperature=0.0, max_tokens=TP_TOKENS,
                        ignore_eos=True)
    eng = _tp_engine("bucketed", 1, layers=None)
    ref = _greedy_tokens(eng, prompts, dataclasses.replace(sp, logprobs=2))
    del eng
    _released(torch, "pp2 tp 1 reference")
    _zero(counters)
    t0 = time.perf_counter()
    eng = _pp_engine()
    up = time.perf_counter() - t0
    got = _greedy_tokens(eng, prompts, sp)
    launches = _counts(counters)
    stages = eng.runner.stages
    layers = [r.cfg.num_layers for r in stages]
    weight_bytes = [sum(int(t.numel()) * t.element_size()
                        for t in _leaves(r.params)) for r in stages]
    del eng, stages
    _released(torch, "pp2")
    compared, _ = _compare_greedy("(a) pp2 against tp 1 bucketed", ref, got,
                                  TIE_GAP)
    _expect(launches, {"K1", "K3", "K4"}, "pp2")
    log(f"[pp2] (a)+(b) llama-3-8b at pp 2, both stages on one card "
        f"({card}): up in {up:.1f} s, stages of {layers} layers; "
        f"{compared} greedy tokens equal tp 1's bucketed run (a flip at a "
        f"near-tie is printed above); launches {json.dumps(launches)}")
    srv = {pp: _pp_server(torch, np, pp) for pp in (1, 2)}
    mem = {"stage_weight_bytes": weight_bytes,
           "weight_bytes": sum(weight_bytes),
           "pp2_blocks_a_stage": srv[2]["pools"],
           "pp1_blocks": srv[1]["pools"][0]}
    if len(set(srv[2]["pools"])) != 1:
        raise AssertionError(f"[pp2] (c) the stages' pools differ: {mem}")
    log(f"[pp2] (c) memory ({card}): {json.dumps(mem)}")
    log(f"[pp2] (d) decode step at 64 rows ({card}; {PP_NOTE}): pp 2 eager "
        f"{json.dumps(srv[2]['decode_64_ms'])} ms, pp 1 graphed "
        f"{json.dumps(srv[1]['decode_64_ms'])} ms")
    log(f"[pp2] (e) the server at --pipeline-parallel-size 2 and 1 "
        f"({card}): {json.dumps(srv)}; phase 19 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


SEQ_NOTE = ("the seq ranks share one card over gloo, their exchange "
            "staged through host memory: not a sequence-parallel speed")
SEQ_MODEL = "llama-3-8b"
SEQ_MAX_LEN = 8192
SEQ_BLOCKS = 4096  # each rank's pool: 2 GiB at llama-3-8b's 8 layers
SEQ_THRESHOLD = 4096
SEQ_TOKENS = 16
SEQ_LENS = (8000, 4500, 6000, 7000)  # (a)'s prompts
SEQ_PAD = 8192  # each of them padded to the next power of two
SEQ_LONG = 8000  # (c)'s fresh prompt
SEQ_SERVER_LEN = 6000  # (e)'s prompt
SEQ_IDS = 32000  # prompts' token ids lie below this


def _seq_engine(tp: int = 1):
    """llama-3-8b bf16 at ``CUT_LAYERS`` layers, seed 0, max_model_len
    8192, at sequence-parallel size 2 and tensor-parallel size ``tp``
    with every process on cuda:0 over gloo: the ragged path, the prefix
    cache on, decode graphs on (kept at tensor size 1 only),
    ``SEQ_BLOCKS`` blocks a process, ring threshold ``SEQ_THRESHOLD``."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    cfg = EngineConfig.for_model(
        SEQ_MODEL, seed=0, max_model_len=SEQ_MAX_LEN,
        num_layers=CUT_LAYERS, cache=CacheConfig(num_blocks=SEQ_BLOCKS),
        scheduler=SchedulerConfig(ring_prefill_threshold=SEQ_THRESHOLD),
        mesh=MeshConfig(seq=2, tensor=tp))
    return LLMEngine(cfg, device="cuda", rank_devices=["cuda:0"] * 2 * tp,
                     backend="gloo")


def _seq_ring_calls(eng) -> list:
    """The padded length of each ``prefill_ring`` call rank 0 makes from
    now on."""
    lengths = []
    inner = eng.runner.prefill_ring

    def counted(tokens, *args, **kwargs):
        lengths.append(int(tokens.shape[1]))
        return inner(tokens, *args, **kwargs)

    eng.runner.prefill_ring = counted
    return lengths


def _seq_prefill(torch, eng, prompt) -> dict:
    """(c) One fresh prompt to its first token, traced on rank 0: its
    wall and rank 0's device busy time."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    def run():
        eng.add_request(f"seq-c-{time.monotonic_ns()}",
                        prompt_token_ids=prompt, sampling=SamplingParams(
                            temperature=0.0, max_tokens=1,
                            ignore_eos=True))
        while eng.has_unfinished():
            eng.step()

    wall, busy, _, kernels, calls = _profiled(torch, run)
    return {"wall_ms": wall, "rank0_device_busy_ms": busy,
            "rank0_kernels": kernels, "launches": calls}


def _seq_reuse(eng, prompt, sp) -> tuple:
    """(d) ``prompt`` again: (its tokens, the cached count it reported)."""
    eng.add_request("seq-d", prompt_token_ids=prompt, sampling=sp)
    toks, cached = [], 0
    while eng.has_unfinished():
        for o in eng.step():
            toks.extend(o.new_token_ids)
            cached = max(cached, o.num_cached_tokens)
    return toks, cached


def _seq_server_start(tp: int = 1) -> "_TpServer":
    """(e)'s server in a fresh process at ``CUT_LAYERS`` layers, seq 2 and
    tensor size ``tp`` (started ahead of its phase: its start-up runs on
    the host beside earlier work)."""
    return _TpServer(["--tensor-parallel-size", str(tp),
                      "--sequence-parallel-size", "2", "--max-model-len",
                      str(SEQ_MAX_LEN), "--ring-prefill-threshold",
                      str(SEQ_THRESHOLD)])


def _seq_server(np, srv: "_TpServer", tp: int, tag: str) -> dict:
    """(e) A long completion through the ring on ``srv``, then SIGTERM:
    its followers gone within ``TP_GONE_S``."""
    try:
        ranks = srv.up(tag, graphs=tp == 1, size=2 * tp)
        if ranks["shape"] != ({"seq": 2} if tp == 1 else
                              {"seq": 2, "tensor": tp}):
            raise AssertionError(f"[{tag}] (e) ranks {ranks}")
        prompt = np.random.default_rng(21).integers(0, SEQ_IDS,
                                                    SEQ_SERVER_LEN)
        status, out, wall = _post(srv.base, "/v1/completions", {
            "model": SEQ_MODEL, "prompt": prompt.tolist(),
            "max_tokens": SEQ_TOKENS, "temperature": 0.0,
            "ignore_eos": True})
        if status != 200 or out["usage"]["completion_tokens"] != SEQ_TOKENS:
            raise AssertionError(f"[{tag}] (e) the long completion: "
                                 f"{status} {out}")
        counts = json.loads(_http(srv.base, "/debug/perf")[2])[
            "compile"]["counts"]
        if not counts.get(f"prefill_ring:{SEQ_PAD}"):
            raise AssertionError(f"[{tag}] (e) the completion took no ring "
                                 f"prefill: {counts}")
        stop = srv.stop(tag)
    except BaseException:
        log(srv.log_tail())
        srv.kill()
        raise
    return {"up_s": srv.up_s, "completion_s": wall, **stop}


def _ring_phase(torch, np, counters, card: str, tp: int, tag: str,
                srv: "_TpServer") -> dict:
    """Phases 20 (``tp`` 1) and 21 (``tp`` 2): llama-3-8b at seq 2 and
    tensor size ``tp``, ``CUT_LAYERS`` layers, every process on this card
    (module docstring); ``srv`` is (e)'s server, already started. Returns
    the ring wave's launches."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.parallel.distributed import RING_OPS

    t_phase = time.perf_counter()
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, SEQ_IDS, n).tolist() for n in SEQ_LENS]
    sp = SamplingParams(temperature=0.0, max_tokens=SEQ_TOKENS,
                        ignore_eos=True, logprobs=2)
    t0 = time.perf_counter()
    eng = _seq_engine(tp)
    up = time.perf_counter() - t0
    try:
        info = eng.rank_info()
        if info["decode_graphs"] != (tp == 1) or info["size"] != 2 * tp:
            raise AssertionError(f"[{tag}] ranks {info}")
        calls = _seq_ring_calls(eng)
        before = eng.runner.follower_reports()
        wire0 = dict(eng.runner.ranks.wire)
        _zero(counters)
        t0 = time.perf_counter()
        ring = _greedy_tokens(eng, prompts, sp)
        ring_s = time.perf_counter() - t0
        launches = _counts(counters)
        wire = {op: n - wire0.get(op, 0.0)
                for op, n in eng.runner.ranks.wire.items()}
        _tp_agree(f"{tag} (b)", eng.runner.follower_reports(), launches,
                  before)
        _expect(launches, {"K1", "K3"}, tag)
        if calls != [SEQ_PAD] * len(prompts):
            raise AssertionError(f"[{tag}] (b) ring calls {calls}, want one "
                                 f"of {SEQ_PAD} tokens a prompt")
        # each layer: one rotation of a seq rank's half of K and V at its
        # KV heads, and the gather of the other half
        cfg, bs = eng.config.model, eng.config.cache.block_size
        shard = (SEQ_PAD // 2 * 2 * (cfg.num_kv_heads // tp) * cfg.head_dim
                 * cfg.torch_dtype.itemsize)
        want = len(prompts) * cfg.num_layers * shard
        if (wire.get("ring_rotate"), wire.get("ring_gather")) != (want,
                                                                   want):
            raise AssertionError(f"[{tag}] (b) wire {wire}, want {want} "
                                 "bytes rotated and gathered")
        tensor_wire = {op: n for op, n in wire.items()
                       if op not in RING_OPS and n}
        if (tp > 1) != bool(tensor_wire):
            raise AssertionError(f"[{tag}] (b) the tensor group's wire "
                                 f"{tensor_wire} at tensor size {tp}")
        reuse, cached = _seq_reuse(eng, prompts[0], sp)
        if (reuse != ring[0][0] or len(calls) != len(prompts)
                or cached != (len(prompts[0]) - 1) // bs * bs):
            raise AssertionError(f"[{tag}] (d) the prompt again: cached "
                                 f"{cached}, ring calls {calls}, tokens "
                                 f"{reuse} against {ring[0][0]}")
        long_prompt = rng.integers(0, SEQ_IDS, SEQ_LONG).tolist()
        walls = {"ring": _seq_prefill(torch, eng, long_prompt)}
        # the chunked path on the same engine: the prefix cache goes with
        # a level-1 sleep, and the ring is switched off; its own
        # deviation, 2 at a time, from a cleared cache again
        eng.scheduler.ring_enabled = False
        eng.sleep_mode(1)
        eng.wake_mode()
        t0 = time.perf_counter()
        chunked = _greedy_tokens(eng, prompts, sp)
        chunked_s = time.perf_counter() - t0
        eng.sleep_mode(1)
        eng.wake_mode()
        rep = _tp_repeat_dev(eng, prompts, sp, chunked)
        walls["chunked"] = _seq_prefill(torch, eng, long_prompt)
        if len(calls) != len(prompts) + 1:
            raise AssertionError(f"[{tag}] ring calls {calls}")
    finally:
        eng.close()
    del eng
    _released(torch, tag)
    band = max(BF16_LOGPROB_BAND, 2 * rep)
    # a flip is a near-tie where the chunked run's top-2 gap is under
    # the band
    compared, worst = _tp_same(f"{tag} (a) ring against chunked", chunked,
                               ring, band, tie_gap=band)
    where = ("both ranks" if tp == 1 else f"all {2 * tp} processes")
    log(f"[{tag}] (a)+(b) {SEQ_MODEL} at seq 2 x tp {tp}, {where} on one "
        f"card ({card}): up in {up:.1f} s; the ring wave in {ring_s:.1f} "
        f"s, the chunked one in {chunked_s:.1f} s; {compared} greedy tokens "
        f"equal the chunked path's, logprobs within {worst:.4f} (band "
        f"{band:.4f}, the chunked run's own deviation {rep:.4f}); ring "
        f"calls {calls}; launches {json.dumps(launches)}; rank 0's wire "
        f"{json.dumps(wire)} (predicted {want} rotated and gathered; the "
        f"tensor group's by op {json.dumps(tensor_wire)})")
    log(f"[{tag}] (c) one {SEQ_LONG}-token prefill to its first token "
        f"({card}; {SEQ_NOTE}): {json.dumps(walls)}")
    log(f"[{tag}] (d) the first prompt again: {cached} tokens cached, its "
        f"{len(reuse)} tokens equal the ring's")
    out = _seq_server(np, srv, tp, tag)
    log(f"[{tag}] (e) the server at --sequence-parallel-size 2 "
        f"--tensor-parallel-size {tp} ({card}): {json.dumps(out)}; the "
        f"phase in {time.perf_counter() - t_phase:.1f} s")
    return launches


def seq_phase(torch, np, counters, card: str) -> dict:
    """Phase 20: llama-3-8b at sequence-parallel size 2, tensor size 1
    (module docstring). Returns the ring wave's launches."""
    return _ring_phase(torch, np, counters, card, 1, "seq2",
                       _seq_server_start(1))


def grid_phase(torch, np, counters, card: str, srv: "_TpServer") -> dict:
    """Phase 21: llama-3-8b on the seq x tensor grid, seq 2 x tp 2, four
    processes on this card (module docstring); ``srv`` is its server,
    started beside phase 20. Returns the ring wave's launches."""
    return _ring_phase(torch, np, counters, card, 2, "seq2tp2", srv)


MH_NOTE = ("two processes started on their own share one card over "
           "gloo: not a TP speed")
MH_SECRET = "chip-smoke-mh2-secret"
MH_TOKENS = 16
MH_LENS = (1024, 64, 300, 700)  # (b)'s prompts, sent one at a time
MH_WAVE = 8  # (b)'s concurrent wave, 64-1024 tokens each
MH_GONE_S = 5.0  # a follower leaves this soon after its leader's end


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def mh_server_child(argv: list) -> int:
    """``--mh-server PORT [FLAG ...]``: one process of a multi-host group,
    started on its own with the ``PSTPU_*`` environment its parent set:
    ``--tp-server``'s llama-3-8b at tensor-parallel size 2 and
    ``CUT_LAYERS`` of its layers on cuda:0 over gloo, through the server's
    own entry point (process 0 serves and leads, process 1 follows; the
    further flags pass through). A process that exits at start prints
    whether it had touched the card."""
    sys.path.insert(0, str(ROOT))
    import torch
    from production_stack_tpu_torch.engine import server

    try:
        with _CutServers():
            server.main(["--model", "llama-3-8b", "--host", "127.0.0.1",
                         "--port", argv[0], "--tensor-parallel-size", "2",
                         "--num-blocks", "1024", "--max-num-seqs", "16",
                         "--skip-warmup", *argv[1:]],
                        rank_devices=["cuda:0"], backend="gloo")
    except SystemExit:
        print(f"[mh2] exited at start; the card touched: "
              f"{torch.cuda.is_initialized()}", flush=True)
        raise
    return 0


class _MhProc:
    """One ``--mh-server`` child: process ``pid`` of a two-process group
    at ``coord`` with its channel on ``control``, serving on ``port``,
    with the shared ``secret`` (none when None); its log in a temporary
    file."""

    def __init__(self, pid: int, coord: int, control: int, port: int,
                 secret):
        import os
        import tempfile

        env = dict(os.environ)
        env.pop("PSTPU_CONTROL_SECRET", None)
        env.update({"PSTPU_COORDINATOR": f"127.0.0.1:{coord}",
                    "PSTPU_NUM_PROCESSES": "2",
                    "PSTPU_PROCESS_ID": str(pid),
                    "PSTPU_CONTROL_PORT": str(control)})
        if secret is not None:
            env["PSTPU_CONTROL_SECRET"] = secret
        self.base = f"http://127.0.0.1:{port}"
        self.logf = tempfile.TemporaryFile()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mh-server",
             str(port)], cwd=ROOT, env=env, stdout=self.logf,
            stderr=subprocess.STDOUT)

    def log_tail(self) -> str:
        self.logf.seek(0)
        return self.logf.read().decode(errors="replace")[-3000:]

    def up(self, tag: str, timeout: float = 300) -> float:
        """Wait for its ``/health``; seconds from its start."""
        while True:
            try:
                if _http(self.base, "/health")[0] == 200:
                    return time.perf_counter() - self.t0
            except (urllib.error.URLError, ConnectionError):
                pass
            if (self.proc.poll() is not None
                    or time.perf_counter() - self.t0 > timeout):
                raise AssertionError(f"[mh2] {tag} did not come up (exit "
                                     f"{self.proc.poll()}):\n"
                                     f"{self.log_tail()}")
            time.sleep(0.25)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self.logf.close()


class _MhPair:
    """A leader and its follower (``_MhProc``). With ``drill``, a
    follower with a wrong secret goes first: once it has exited, the
    leader must still be waiting, and only then does the right follower
    start (on a thread of its own, so the start-up runs beside other
    work)."""

    def __init__(self, drill: bool = False):
        coord, control, lport, fport = _free_ports(4)
        self.args = (coord, control, fport)
        self.leader = _MhProc(0, coord, control, lport, MH_SECRET)
        self.follower = None
        self.drill = None
        if drill:
            self.wrong = _MhProc(1, coord, control, fport, MH_SECRET + "-no")
            self.thread = threading.Thread(target=self._admit, daemon=True)
            self.thread.start()
        else:
            self.follower = _MhProc(1, coord, control, fport, MH_SECRET)

    def _admit(self) -> None:
        try:
            rc = self.wrong.proc.wait(300)
            waiting = self.leader.proc.poll() is None
            self.drill = {"wrong_secret_exit": rc,
                          "wrong_secret_s": time.perf_counter()
                          - self.wrong.t0,
                          "leader_waiting": waiting,
                          "leader_serving": False}
            try:
                self.drill["leader_serving"] = _http(
                    self.leader.base, "/health")[0] == 200
            except (urllib.error.URLError, ConnectionError):
                pass
        finally:
            coord, control, fport = self.args
            self.follower = _MhProc(1, coord, control, fport, MH_SECRET)

    def up(self, tag: str) -> dict:
        if hasattr(self, "thread"):
            self.thread.join(300)
        return {"leader_up_s": self.leader.up(f"{tag} leader"),
                "follower_health": json.loads(_http(
                    self.follower.base, "/health")[2])}

    def kill(self) -> None:
        for p in (self.leader, self.follower, getattr(self, "wrong", None)):
            if p is not None:
                p.kill()


class _MhStart:
    """Phase 22's processes, started beside phases 20 and 21: the leader
    without a secret, the pair (behind the wrong-secret follower) and the
    spawned ``--tp-server`` reference of the same flags and depth."""

    def __init__(self):
        self.ref = _TpServer()
        self.bare = _MhProc(0, *_free_ports(3), None)
        self.pair = _MhPair(drill=True)

    def close(self) -> None:
        self.ref.kill()
        self.bare.kill()
        self.pair.kill()


def _mh_reports(base: str) -> dict:
    return json.loads(_http(base, "/debug/ranks")[2])


def _mh_same_launches(tag: str, reports: list, before: list) -> dict:
    """Rank 0's launches since ``before``; every follower's digest and
    call count are rank 0's and its launches over the same calls too."""
    if (len({(r["calls"], r["digest"]) for r in reports}) != 1
            or any(r["diverged_at"] is not None for r in reports)):
        raise AssertionError(f"[mh2] {tag}: the ranks sampled other "
                             f"tokens: {reports}")
    deltas = [{k: n - b["launches"].get(k, 0)
               for k, n in r["launches"].items()}
              for r, b in zip(reports, before)]
    if any(d != deltas[0] for d in deltas[1:]):
        raise AssertionError(f"[mh2] {tag}: launches by rank {deltas}")
    return deltas[0]


def _mh_secret(start: "_MhStart") -> dict:
    """(a) A leader without the secret exits non-zero, naming it, with the
    card untouched; a follower with a wrong secret is refused and exits
    non-zero while the leader keeps waiting; the right one then joins."""
    rc = start.bare.proc.wait(300)
    tail = start.bare.log_tail()
    if (rc == 0 or "PSTPU_CONTROL_SECRET" not in tail
            or "the card touched: False" not in tail):
        raise AssertionError(f"[mh2] (a) the leader without a secret: exit "
                             f"{rc}:\n{tail}")
    pair = start.pair
    pair.thread.join(300)
    drill = pair.drill
    if (drill is None or drill["wrong_secret_exit"] in (0, None)
            or not drill["leader_waiting"] or drill["leader_serving"]):
        raise AssertionError(f"[mh2] (a) the wrong secret: {drill}:\n"
                             f"{pair.wrong.log_tail()}")
    return {"no_secret_exit": rc, **drill}


def _mh_prompts(np) -> tuple:
    rng = np.random.default_rng(22)
    one = [rng.integers(0, 32000, n).tolist() for n in MH_LENS]
    lens = [1024] + [int(x) for x in rng.integers(64, 1025, MH_WAVE - 1)]
    return one, [rng.integers(0, 32000, n).tolist() for n in lens]


def _mh_identity(np, pair_base: str, ref_base: str) -> dict:
    """(b) The sequential prompts bit for bit on the pair and on the
    spawned server; then the concurrent wave, each answered 200, tokens
    equal up to a near-tie and logprobs within the band of the spawned
    server's own repeat (phase 15's kind of band)."""
    one, wave = _mh_prompts(np)
    for i, prompt in enumerate(one):
        got = _kv_run(_kv_post(pair_base, _kv_body(prompt, MH_TOKENS)))
        want = _kv_run(_kv_post(ref_base, _kv_body(prompt, MH_TOKENS)))
        if got != want:
            raise AssertionError(f"[mh2] (b) prompt {i} ({len(prompt)} "
                                 f"tokens): the pair {got} != the spawned "
                                 f"server {want}")
    ref = _tpkv_wave(ref_base, wave, MH_TOKENS)
    again = _tpkv_wave(ref_base, wave, MH_TOKENS)
    noise = max(_kv_dev(u, r)[1] for u, r in zip(ref, again))
    band = max(BF16_LOGPROB_BAND, 2 * noise)
    got = _tpkv_wave(pair_base, wave, MH_TOKENS)
    compared, worst = 0, 0.0
    for i, (r, g) in enumerate(zip(ref, got)):
        n, w = _kv_same(f"mh2 (b) wave request {i}", r, g, band)
        compared, worst = compared + n, max(worst, w)
    return {"sequential": len(one), "sequential_bit_for_bit": True,
            "wave": len(wave), "wave_tokens_compared": compared,
            "wave_max_logprob_dev": worst, "band": band,
            "spawned_repeat_dev": noise}


def _mh_stop(pair: "_MhPair", sig: str) -> dict:
    """(d) ``sig`` to the leader: after SIGTERM it drains and exits 0;
    either way the follower exits 0 within ``MH_GONE_S`` of the signal."""
    import signal

    t0 = time.perf_counter()
    pair.leader.proc.send_signal(getattr(signal, sig))
    try:
        f_rc = pair.follower.proc.wait(MH_GONE_S)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"[mh2] (d) {sig}: the follower still runs "
                             f"{MH_GONE_S} s after the signal:\n"
                             f"{pair.follower.log_tail()}")
    gone = time.perf_counter() - t0
    l_rc = pair.leader.proc.wait(60)
    out = {"follower_exit": f_rc, "follower_gone_s": gone,
           "leader_exit": l_rc, "leader_exit_s": time.perf_counter() - t0}
    if f_rc != 0 or (sig == "SIGTERM" and l_rc != 0):
        raise AssertionError(f"[mh2] (d) {sig}: {out}:\n"
                             f"{pair.leader.log_tail()}\n"
                             f"{pair.follower.log_tail()}")
    return out


def mh_phase(np, card: str, start: "_MhStart") -> dict:
    """Phase 22: llama-3-8b at tp 2 and ``CUT_LAYERS`` as two processes
    started on their own on this card (module docstring); ``start`` holds
    its processes, started beside phases 20 and 21. Returns rank 0's
    launches on (b)."""
    t_phase = time.perf_counter()
    pair = start.pair
    try:
        secret = _mh_secret(start)
        up = pair.up("mh2")
        if up["follower_health"] != {"status": "follower",
                                     "process_id": 1}:
            raise AssertionError(f"[mh2] (c) the follower's /health: {up}")
        status, _, _ = _http(pair.follower.base, "/v1/models")
        if status != 404:
            raise AssertionError(f"[mh2] (c) the follower answered "
                                 f"/v1/models with {status}")
        start.ref.up("mh2 reference")
        base = pair.leader.base
        before = _mh_reports(base)["reports"]
        t0 = time.perf_counter()
        ident = _mh_identity(np, base, start.ref.base)
        ident["pair_s"] = time.perf_counter() - t0
        after = _mh_reports(base)
        launches = _mh_same_launches("(c)", after["reports"], before)
        _expect(launches, {"K1", "K2", "K3"}, "mh2")
        channel = after["channel"]
        steps = [(r["timeline"]["last_token"] - r["timeline"]["first_token"])
                 / (MH_TOKENS - 1) for r in _obs_records(base, limit=12)[
                     MH_WAVE:]]
        host = {m: channel[m] for m in ("ragged_step", "decode_multi")
                if m in channel}
        stop = {"sigterm": _mh_stop(pair, "SIGTERM"),
                "reference": start.ref.stop("mh2 reference")}
        fresh = _MhPair()
        try:
            fresh_up = fresh.up("mh2 fresh pair")
            stop["sigkill"] = _mh_stop(fresh, "SIGKILL")
        finally:
            fresh.kill()
    except BaseException:
        for p in (pair.leader, pair.follower):
            if p is not None:
                log(p.log_tail())
        raise
    log(f"[mh2] (a) the secret ({card}): {json.dumps(secret)}")
    log(f"[mh2] (b) llama-3-8b at tp 2 as two processes started on their "
        f"own against the spawned tp 2 server, one card ({card}; {MH_NOTE})"
        f": {json.dumps(ident)}")
    log(f"[mh2] (c) digests, calls and launches equal on both ranks: "
        f"{json.dumps(launches)} ({after['reports'][0]['calls']} calls); "
        f"the follower's /health {json.dumps(up['follower_health'])}")
    log(f"[mh2] (d) stops ({card}): {json.dumps(stop)}")
    log(f"[mh2] start-up ({card}): the pair {up['leader_up_s']:.1f} s "
        f"beside phases 20-21, a fresh pair alone "
        f"{fresh_up['leader_up_s']:.1f} s; the channel by method (median "
        f"payload bytes and host microseconds to send one: pickle, HMAC, "
        f"socket) {json.dumps(host)}; a decode step's wall on the pair, "
        f"host clock, median of the sequential requests "
        f"{1e3 * statistics.median(steps):.2f} ms; the phase in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


PPTP_NOTE = ("four processes share one card over gloo, the stage relay "
             "staged through host memory: not a pipeline or tensor-parallel "
             "speed")
PPTP_MODEL = "llama-3-8b"  # (d)'s server's model


def _pptp_engine():
    """llama-3-8b bf16 at ``CUT_LAYERS`` layers, seed 0, pp 2 x tp 2: four
    processes on cuda:0 over gloo, process g stage g // 2 and tensor rank
    g % 2 (4 layers at H 16 and KH 4 each), as (a)'s tp 2 bucketed
    reference (``_tp_engine``): prefix cache off, decode eager,
    ``TP_BLOCKS`` blocks a process."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    cfg = EngineConfig.for_model(
        "llama-3-8b", seed=0, attention_impl="bucketed",
        num_layers=CUT_LAYERS,
        cache=CacheConfig(enable_prefix_caching=False, num_blocks=TP_BLOCKS),
        scheduler=SchedulerConfig(decode_graphs=False),
        mesh=MeshConfig(stage=2, tensor=2))
    return LLMEngine(cfg, device="cuda", rank_devices=["cuda:0"] * 4,
                     backend="gloo")


def _pptp_figures(torch, np, eng) -> dict:
    """(c) Each process's weight bytes, the pool's block count, and an
    eager decode step at 64 rows (contexts of 128 + a few tokens): three
    steps' host wall, each to a synchronise, and the stage relay's bytes
    each step on rank 0 (``STAGE_OPS``: the residual stream stage 0 sends
    on, the last stage's tokens it receives)."""
    from production_stack_tpu_torch.parallel.distributed import STAGE_OPS

    runner = eng.runner
    weights = runner.gather("param_bytes")
    _dg_admit(np, eng, np.random.default_rng(23), "pptp-c", 64, 128, 64)
    wire = runner.ranks.wire
    walls, relay = [], []
    for _ in range(3):
        before = {op: wire.get(op, 0.0) for op in STAGE_OPS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        relay.append({op: wire.get(op, 0.0) - n for op, n in before.items()})
    _dg_clear(eng)
    return {"weight_bytes": weights, "blocks": runner.num_blocks,
            "decode_64_ms": walls, "relay_bytes_a_step": relay}


def _pptp_server(np, srv: "_TpServer") -> dict:
    """(d) The server from ``--pipeline-parallel-size 2
    --tensor-parallel-size 2`` at ``CUT_LAYERS`` layers (started ahead of
    its phase): a completion, a stream, an embedding and ``/kv/export``
    (two blocks, tp 2's head groups, every stage's layers); then SIGTERM,
    its three followers gone within ``TP_GONE_S``."""
    from production_stack_tpu_torch.engine import kv_transfer as kvt
    from production_stack_tpu_torch.engine.config import ModelConfig

    tag = "pp2tp2"
    cfg = ModelConfig.from_pretrained(PPTP_MODEL)
    try:
        ranks = srv.up(tag, size=4)
        if ranks["shape"] != {"stage": 2, "tensor": 2}:
            raise AssertionError(f"[{tag}] (d) ranks {ranks}")
        prompt = np.random.default_rng(23).integers(
            0, min(cfg.vocab_size, 32000), 64).tolist()
        body = {"model": PPTP_MODEL, "prompt": prompt,
                "max_tokens": TP_TOKENS, "temperature": 0.0,
                "ignore_eos": True}
        status, out, wall = _post(srv.base, "/v1/completions", body)
        s_status, s_out, _ = _request(srv.base + "/v1/completions", {
            **body, "stream": True,
            "stream_options": {"include_usage": True}}, True)
        e_status, emb, _ = _post(srv.base, "/v1/embeddings", {
            "model": PPTP_MODEL, "input": [prompt]})
        _, pre, _ = _post(srv.base, "/v1/completions", {
            **body, "prompt": prompt[:40], "max_tokens": 1,
            "kv_transfer_params": {"do_remote_decode": True}})
        ids = pre["kv_transfer_params"]["remote_block_ids"][:2]
        k_status, headers, raw = _http(srv.base, "/kv/export",
                                       {"blocks": ids})
        shape = [int(x) for x in headers.get("X-KV-Shape", "0").split(",")]
        got = {"completion": status,
               "completion_tokens": out["usage"]["completion_tokens"],
               "stream": s_status, "stream_tokens": s_out,
               "embedding": e_status,
               "embedding_width": len(emb["data"][0]["embedding"]),
               "kv_export": k_status, "kv_shape": shape,
               "kv_bytes": len(raw),
               "head_groups": headers.get(kvt.HEAD_GROUPS_HEADER)}
        want = {"completion": 200, "completion_tokens": TP_TOKENS,
                "stream": 200, "stream_tokens": TP_TOKENS, "embedding": 200,
                "embedding_width": cfg.hidden_size, "kv_export": 200,
                "kv_shape": [min(CUT_LAYERS, cfg.num_layers), 2, 16,
                             2 * cfg.num_kv_heads, cfg.head_dim],
                "kv_bytes": kvt.nbytes_of(shape, headers.get(
                    "X-KV-Dtype", "bfloat16")),
                "head_groups": "2"}
        if got != want:
            raise AssertionError(f"[{tag}] (d) the routes: {got} against "
                                 f"{want}")
        stop = srv.stop(tag)
    except BaseException:
        log(srv.log_tail())
        srv.kill()
        raise
    return {"up_s": srv.up_s, "completion_s": wall, **got, **stop}


def pptp_phase(torch, np, counters, card: str, srv: "_TpServer") -> dict:
    """Phase 23: llama-3-8b at pp 2 x tp 2 and ``CUT_LAYERS`` layers, four
    processes on this card over gloo. (a) identity against the tp 2
    bucketed engine at the same depth on phase 15's prompts (run first
    and released), bit for bit; (b) K1,
    K3 and K4 launched on each of the four processes and K2 on none; (c)
    each process's weight bytes, the block count, an eager decode step's
    wall and the relay's bytes a step; (d) the server from the flags
    (``srv``, started ahead of the phase) and its SIGTERM. Returns rank
    0's launches on (a)."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    t_phase = time.perf_counter()
    tag = "pp2tp2"
    prompts = _tp_prompts(np)
    sp = SamplingParams(temperature=0.0, max_tokens=TP_TOKENS,
                        ignore_eos=True)
    t0 = time.perf_counter()
    eng = _tp_engine("bucketed", 2)
    ref_up = time.perf_counter() - t0
    try:
        ref = _greedy_tokens(eng, prompts, sp)
    finally:
        eng.close()
    del eng
    _released(torch, f"{tag} tp 2 reference")
    ref_s = time.perf_counter() - t0
    _zero(counters)
    t0 = time.perf_counter()
    eng = _pptp_engine()
    up = time.perf_counter() - t0
    try:
        got = _greedy_tokens(eng, prompts, sp)
        launches = _counts(counters)
        reports = eng.runner.follower_reports()
        run_s = time.perf_counter() - t0 - up
        figures = _pptp_figures(torch, np, eng)
    finally:
        eng.close()
    del eng
    _released(torch, tag)
    for i in ref[0]:
        if got[0][i] != ref[0][i]:
            raise AssertionError(f"[{tag}] (a) request {i}: pp 2 x tp 2 "
                                 f"{got[0][i]} != tp 2 {ref[0][i]}")
    compared = sum(len(t) for t in ref[0].values())
    _expect(launches, {"K1", "K3", "K4"}, tag)
    places = [r["place"] for r in reports]
    if places != [{"stage": s, "tensor": t} for s in (0, 1)
                  for t in (0, 1)]:
        raise AssertionError(f"[{tag}] (b) the processes: {places}")
    if (len({(r["calls"], r["digest"]) for r in reports}) != 1
            or any(r["diverged_at"] is not None for r in reports)):
        raise AssertionError(f"[{tag}] (b) the processes sampled other "
                             f"tokens: {reports}")
    for r in reports:
        _expect(r["launches"], {"K1", "K3", "K4"},
                f"{tag} process {r['rank']} {r['place']}")
    server = _pptp_server(np, srv)
    log(f"[{tag}] (a) llama-3-8b at pp 2 x tp 2, four processes on one card "
        f"({card}; {PPTP_NOTE}): {compared} greedy tokens of 16 requests "
        f"equal the tp 2 bucketed run's bit for bit; tp 2 up in "
        f"{ref_up:.1f} s and run with its release in {ref_s:.1f} s, pp 2 x "
        f"tp 2 up in {up:.1f} s and run in {run_s:.1f} s")
    log(f"[{tag}] (b) launches by process (stage, tensor rank): "
        + json.dumps([[r["place"]["stage"], r["place"]["tensor"],
                       r["launches"]] for r in reports])
        + f"; rank 0's counters {json.dumps(launches)}")
    log(f"[{tag}] (c) figures ({card}; {PPTP_NOTE}): {json.dumps(figures)}")
    log(f"[{tag}] (d) the server at --pipeline-parallel-size 2 "
        f"--tensor-parallel-size 2, {CUT_LAYERS} layers ({card}): "
        f"{json.dumps(server)}; phase 23 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 24: what sequence parallelism did not carry before ---------------

SEQF_MODEL = "mixtral-8x7b"
# (a)'s and (b)'s pools a process: 512 KiB a block at Mixtral's KH 8 and
# CUT_LAYERS layers (256 KiB at tp 2's KH 4)
SEQF_BLOCKS = 4096
SEQF_GRID = (1, 0)  # (b)'s prompts: (a)'s of 4500 and 8000 tokens
# (a)'s and (b)'s first tokens against one process's forward of the whole
# padded prompt: the same token unless the one process's top-2 gap is
# under this, and the same token's logprobs within it. Read on an NVIDIA
# H100 80GB HBM3 at 700 W before it was judged: logprobs within 0.0172
# at seq 2 and 0.0913 at seq 2 x tp 2, top-2 gaps 0.2399-1.2491 (PERF.md
# section 6)
SEQF_FIRST_BAND = 0.15
# (c): the prefill server's 8 requests (reference, pulled, pushed), their
# lengths, and the servers' pools. P holds the 8 prompts at once (a pull
# reads blocks the prefix cache holds, unpinned); D the 8 transfers; P2
# is smaller, so that wave B evicts wave A from it
SEQKV_N = 8
SEQKV_LENS = (4500, 6000)
SEQKV_TIER_N = 4  # wave A: the first 4 of the 8 prompts
SEQKV_LONE = 4608  # (c)'s lone push: through the ring, 288 full blocks
# wave B on P2: 1,503 blocks, which leave at most 33 of wave A's 1,354
# in P2's 1,536 (A's 4 prompts and B's 3 each fit it at once)
SEQKV_B = (8000,) * 3
SEQKV_P_BLOCKS = SEQKV_N * (SEQKV_LENS[1] + 2 * TPKV_BS) // TPKV_BS + 64
SEQKV_D_BLOCKS = SEQKV_P_BLOCKS
SEQKV_P2_BLOCKS = 1536
SEQKV_SEQ = ["--tensor-parallel-size", "1", "--max-model-len",
             str(SEQ_MAX_LEN), "--ring-prefill-threshold",
             str(SEQ_THRESHOLD)]


def _seqf_engine(tp: int):
    """mixtral-8x7b int8 (the CLI's scheduler, seed 0) at ``CUT_LAYERS``
    layers, seq 2 and tensor size ``tp``, every process on cuda:0 over
    gloo, ``SEQF_BLOCKS`` blocks a process, prefix cache off (the chunked
    run after the ring run prefills again), ``max_model_len`` 8192, ring
    threshold ``SEQ_THRESHOLD``."""
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        config_from_args,
    )

    cfg = config_from_args(build_parser().parse_args(
        ["--model", SEQF_MODEL, "--quantization", "int8", "--seed", "0",
         "--sequence-parallel-size", "2", "--tensor-parallel-size", str(tp),
         "--max-model-len", str(SEQ_MAX_LEN), "--ring-prefill-threshold",
         str(SEQ_THRESHOLD), "--num-blocks", str(SEQF_BLOCKS)]))
    cfg = dataclasses.replace(_cut_depth(cfg), cache=dataclasses.replace(
        cfg.cache, enable_prefix_caching=False))
    return LLMEngine(cfg, device="cuda", rank_devices=["cuda:0"] * 2 * tp,
                     backend="gloo")


class _RingCalls:
    """Rank 0's ring calls from now on: each call's padded length, the
    int8 route each of its products asked for (token count -> W8A16 or
    W8A8, ``quant.a16``), and each MoE layer's routed slots an expert
    summed over the seq ranks (``RankGroup.moe_counts``), from which the
    slots past the capacity follow. ``close`` puts the spied calls
    back."""

    def __init__(self, eng):
        from production_stack_tpu_torch.engine import quant

        self.quant, self.calls = quant, []
        runner, seq = eng.runner, eng.runner.ranks.seq
        self.runner, self.seq = runner, seq
        ring, counts, a16 = runner.prefill_ring, seq.moe_counts, quant.a16
        self.a16 = a16

        self.inside = False

        def spied_ring(tokens, *args, **kwargs):
            self.calls.append({"S": int(tokens.shape[1]), "routes": {},
                               "totals": []})
            self.inside = True
            try:
                return ring(tokens, *args, **kwargs)
            finally:
                self.inside = False

        def spied_counts(c):
            out = counts(c)
            if self.inside:
                self.calls[-1]["totals"].append(out.sum(0).tolist())
            return out

        def spied_a16(tokens):
            got = a16(tokens)
            if self.inside:
                self.calls[-1]["routes"][int(tokens)] = (
                    "W8A16" if got else "W8A8")
            return got

        self.ring = ring
        runner.prefill_ring = spied_ring
        seq.moe_counts = spied_counts
        quant.a16 = spied_a16

    def close(self) -> None:
        """Put the spied calls back and let go of the engine's runner
        (its memory is released after the engine's close)."""
        self.quant.a16 = self.a16
        self.runner.prefill_ring = self.ring  # the mirrored call
        self.seq.__dict__.pop("moe_counts", None)
        self.runner = self.seq = self.ring = None

    def dropped(self, cfg) -> list:
        """Each call's slots past its capacity over its layers (the pad
        tokens' slots, last in the prompt, included)."""
        k, X = cfg.num_experts_per_tok, cfg.num_experts
        out = []
        for c in self.calls:
            cap = max(int(2.0 * c["S"] * k / X), k)
            out.append(sum(max(0, t - cap) for layer in c["totals"]
                           for t in layer))
        return out


def _seqf_slots(torch, picks: list, n_real: int, S: int, cfg) -> dict:
    """One prompt's slots past the capacity in the whole prompt's routing
    (``picks``: each MoE layer's (S, k) experts), over its layers: the
    real tokens' (``real``), the pad tokens' (``pad``), and the real
    slots on seq rank 1 that only rank 0's routed counts push past the
    capacity (``decided``: kept with no offset, dropped with it)."""
    k, X = cfg.num_experts_per_tok, cfg.num_experts
    cap = max(int(2.0 * S * k / X), k)
    out = {"real": 0, "pad": 0, "decided": 0}
    for idx in picks:
        choice = idx.reshape(-1).long()
        hot = torch.nn.functional.one_hot(choice, X)
        pos = ((hot.cumsum(0) - hot) * hot).sum(-1)
        tok = torch.arange(S, device=choice.device).repeat_interleave(k)
        real, drop = tok < n_real, pos >= cap
        first = hot[:S // 2 * k].sum(0)  # rank 0's slots an expert
        local = pos - torch.where(tok >= S // 2, first[choice], 0)
        out["real"] += int((drop & real).sum())
        out["pad"] += int((drop & ~real).sum())
        out["decided"] += int((drop & real & (local < cap)).sum())
    return out


def _seqf_dense(torch, eng, prompts) -> list:
    """The reference's ring call on one process: rank 0's weights (seq 2
    at tensor size 1 holds them whole) over each prompt's whole padded
    (1, S), dense causal attention, every product's int8 route and the
    MoE capacity from S and each MoE layer's slots ranked over all S
    tokens at once. A dict a prompt: ``first``, its first token (token,
    its logprob, the top-2 gap); ``unranked``, the same forward with each
    seq rank's half ranking its slots alone (no offset from the earlier
    rank's counts: what a wrong offset would give); ``slots``, its slots
    past the capacity (``_seqf_slots``)."""
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops.attention import dense_causal_attention
    from production_stack_tpu_torch.parallel.ring_attention import (
        ring_length,
    )

    runner = eng.runner._inner
    cfg, dev = runner.cfg, runner.device
    top_k, moe = llama.top_k_lower_first, llama._moe_mlp
    picks = []

    def attend(q, k, v, kv, layer):
        return dense_causal_attention(q, k, v, q_block=512), kv

    def spied_top_k(logits, k):
        got = top_k(logits, k)
        picks.append(got[1])
        return got

    def unranked(cfg, lp, x, tokens=None, group=None, seq=None,
                 expert=None):
        half = x.shape[-2] // 2
        return torch.cat([moe(cfg, lp, x[..., :half, :], tokens, group,
                              expert=expert),
                          moe(cfg, lp, x[..., half:, :], tokens, group,
                              expert=expert)], dim=-2)

    def first(tokens, n, positions, S):
        hidden, _ = runner.model.forward_tokens(
            cfg, runner.params, tokens, positions, attend, None,
            ref_tokens=S)
        lp = torch.log_softmax(runner._logits(hidden[:, n - 1])[0], -1)
        top = torch.topk(lp, 2)
        return (int(top.indices[0]), float(top.values[0]),
                float(top.values[0] - top.values[1]))

    out = []
    with torch.inference_mode():
        for p in prompts:
            S = ring_length(len(p), 2)
            tokens = torch.zeros((1, S), dtype=torch.int32, device=dev)
            tokens[0, :len(p)] = torch.tensor(p, dtype=torch.int32,
                                              device=dev)
            positions = torch.arange(S, device=dev)[None]
            picks.clear()
            llama.top_k_lower_first = spied_top_k
            try:
                got = {"first": first(tokens, len(p), positions, S)}
            finally:
                llama.top_k_lower_first = top_k
            got["slots"] = _seqf_slots(torch, picks, len(p), S, cfg)
            picks.clear()
            llama._moe_mlp = unranked
            try:
                got["unranked"] = first(tokens, len(p), positions, S)
            finally:
                llama._moe_mlp = moe
            out.append(got)
    return out


def _seqf_off(tok: int, lp: float, ref: tuple) -> bool:
    """Whether a first token ``tok`` of logprob ``lp`` falls outside
    ``SEQF_FIRST_BAND`` of the one-process reference's ``ref`` (token,
    logprob, top-2 gap): another token where the reference's top-2 gap is
    not under the band, or the same one with logprobs not within it."""
    return (abs(lp - ref[1]) if tok == ref[0] else ref[2]) >= SEQF_FIRST_BAND


def _seqf_first(tag: str, ring: tuple, dense: list, order) -> list:
    """Each ring prompt's first token against the one-process reference's
    (``_seqf_dense``; ``order`` maps a ring prompt to its entry), judged
    by ``_seqf_off`` (a flip under the band is a near-tie, logged).
    Returns (same token, |logprob difference|, the reference's top-2
    gap) a prompt."""
    toks, lps = ring
    out = []
    for i, j in enumerate(order):
        tok, lp, gap = ref = dense[j]["first"]
        if _seqf_off(toks[i][0], lps[i][0][0], ref):
            raise AssertionError(
                f"[{tag}] prompt {i}'s first token {toks[i][0]} (logprob "
                f"{lps[i][0][0]:.4f}) against one process's {tok} "
                f"({lp:.4f}, top-2 gap {gap:.4f}): band {SEQF_FIRST_BAND}")
        if toks[i][0] != tok:
            log(f"[{tag}] prompt {i}'s first token: a near-tie with one "
                f"process's (top-2 gap {gap:.4f})")
        out.append((toks[i][0] == tok, abs(lps[i][0][0] - lp), gap))
    return out


def _seqf_teeth(tag: str, dense: list) -> list:
    """The phase's prompts must exercise the offset and the judge must
    tell its absence: some real slot is dropped only through the earlier
    rank's counts, and some prompt's first token without the offset
    (``unranked``) falls outside the band (``_seqf_off``). Returns the
    prompts whose first token the judge would refuse without it."""
    caught = [j for j, d in enumerate(dense)
              if _seqf_off(*d["unranked"][:2], d["first"])]
    if not any(d["slots"]["decided"] for d in dense) or not caught:
        raise AssertionError(
            f"[{tag}] the prompts do not show the offset: slots "
            f"{[d['slots'] for d in dense]}, without it "
            f"{[d['unranked'] for d in dense]} against "
            f"{[d['first'] for d in dense]}")
    return caught


def _seqf_ring(torch, np, counters, card: str, tp: int, order,
               dense=None) -> dict:
    """(a) at ``tp`` 1, (b) at ``tp`` 2: the prompts of ``SEQ_LENS``
    ``order`` picks x ``SEQ_TOKENS`` greedy tokens through the ring, then
    through the chunked path on the same engine, and again a prompt or
    two at a time (the chunked run's own deviation). Judged: each
    prompt's first token against the one-process reference's
    (``_seqf_dense``: at tp 1 made here, on rank 0's weights; at tp 2
    ``dense``, (a)'s) within ``SEQF_FIRST_BAND`` (``_seqf_first``); the
    ring's tokens equal the chunked path's up to a near-tie, logprobs
    within max(0.05, twice that deviation) (the two paths drop different
    slots, so this band is wide); the ranks' digests and launches equal;
    K1 and K3 on the ring wave; the ring and the count exchange's bytes
    exactly; at tp 1, that the judge would refuse the reference without
    the offset (``_seqf_teeth``). Printed besides: the reference's first
    token without the offset (``unranked``) and its slots past the
    capacity, real and pad apart. Returns the figures printed, the ring wave's launches and the
    reference among them."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.parallel.distributed import RING_OPS

    tag = "seq2-moe-int8" if tp == 1 else "seq2tp2-moe-int8"
    rng = np.random.default_rng(24)
    every = [rng.integers(0, SEQ_IDS, n).tolist() for n in SEQ_LENS]
    prompts = [every[j] for j in order]
    sp = SamplingParams(temperature=0.0, max_tokens=SEQ_TOKENS,
                        ignore_eos=True, logprobs=2)
    t0 = time.perf_counter()
    eng = _seqf_engine(tp)
    up = time.perf_counter() - t0
    try:
        cfg = eng.config.model
        info = eng.rank_info()
        if info["size"] != 2 * tp or info["decode_graphs"] != (tp == 1):
            raise AssertionError(f"[{tag}] ranks {info}")
        spies = _RingCalls(eng)
        before = eng.runner.follower_reports()
        wire0 = dict(eng.runner.ranks.wire)
        _zero(counters)
        t0 = time.perf_counter()
        try:
            ring = _greedy_tokens(eng, prompts, sp)
        finally:
            spies.close()
        ring_s = time.perf_counter() - t0
        launches = _counts(counters)
        wire = {op: n - wire0.get(op, 0.0)
                for op, n in eng.runner.ranks.wire.items()}
        _tp_agree(f"{tag} (a)", eng.runner.follower_reports(), launches,
                  before)
        _expect(launches, {"K1", "K3"}, tag)
        if dense is None:
            t0 = time.perf_counter()
            dense = _seqf_dense(torch, eng, every)
            dense_s = time.perf_counter() - t0
        else:
            dense_s = None
        eng.scheduler.ring_enabled = False
        t0 = time.perf_counter()
        chunked = _greedy_tokens(eng, prompts, sp)
        chunked_s = time.perf_counter() - t0
        rep = _tp_repeat_dev(eng, prompts, sp, chunked,
                             per=2 if len(prompts) > 2 else 1)
    finally:
        eng.close()
    del eng
    _released(torch, tag)
    calls = [c["S"] for c in spies.calls]
    if calls != [SEQ_PAD] * len(prompts):
        raise AssertionError(f"[{tag}] ring calls {calls}, want one of "
                             f"{SEQ_PAD} tokens a prompt")
    # a layer: one rotation of a seq rank's half of K and V at its KV
    # heads, the gather of the other half; one all-gather of (X,) int32
    # counts from the other rank
    shard = (SEQ_PAD // 2 * 2 * (cfg.num_kv_heads // tp) * cfg.head_dim
             * cfg.torch_dtype.itemsize)
    want = len(prompts) * cfg.num_layers * shard
    want_counts = len(prompts) * cfg.num_layers * (2 - 1) * \
        cfg.num_experts * 4
    got = (wire.get("ring_rotate"), wire.get("ring_gather"),
           wire.get("ring_moe_counts"))
    if got != (want, want, want_counts):
        raise AssertionError(f"[{tag}] wire {wire}, want {want} bytes "
                             f"rotated and gathered, {want_counts} of "
                             "counts")
    tensor_wire = {op: n for op, n in wire.items()
                   if op not in RING_OPS and n}
    if (tp > 1) != bool(tensor_wire):
        raise AssertionError(f"[{tag}] the tensor group's wire "
                             f"{tensor_wire} at tensor size {tp}")
    first = _seqf_first(tag, ring, dense, order)
    caught = _seqf_teeth(tag, dense) if dense_s is not None else None
    band = max(BF16_LOGPROB_BAND, 2 * rep)
    compared, worst = _tp_same(f"{tag} ring against chunked", chunked,
                               ring, band, tie_gap=band)
    figures = {"up_s": up, "ring_wave_s": ring_s,
               "chunked_wave_s": chunked_s, "tokens_compared": compared,
               "max_logprob_dev": worst, "band": band, "repeat_dev": rep,
               "ring_calls": calls,
               "first_token_against_one_process": first,
               "first_band": SEQF_FIRST_BAND, "one_process_s": dense_s,
               "unranked_against_one_process": [
                   (dense[j]["unranked"][0] == dense[j]["first"][0],
                    abs(dense[j]["unranked"][1] - dense[j]["first"][1]))
                   for j in order],
               "refused_without_offset": caught,
               "routes": [c["routes"] for c in spies.calls],
               "slots_past_capacity": spies.dropped(cfg),
               "one_process_slots_past_capacity": [dense[j]["slots"]
                                                   for j in order],
               "wire": wire, "predicted": {"ring_rotate": want,
                                           "ring_gather": want,
                                           "ring_moe_counts": want_counts},
               "launches": launches}
    log(f"[{tag}] {SEQF_MODEL} int8 at seq 2 x tp {tp}, {CUT_LAYERS} "
        f"layers, {2 * tp} processes on one card ({card}; {SEQ_NOTE}): "
        f"{json.dumps(figures)}")
    figures["dense"] = dense
    # what phase 26 (a) judges against
    figures["wave"] = {"prompts": prompts, "sp": sp, "run": ring}
    return figures


def _seqkv_start() -> dict:
    """(c)'s processes, started as phase 22 starts, beside phases 22-23
    (their start-up runs on the host): the remote tier's store in this
    process; a ``--role prefill`` server at seq 2 (P) and a fresh seq 2
    server (P2) with the host tier, both on the store; a ``--role
    decode`` server at seq 1 (D). Every process on cuda:0, llama-3-8b at
    ``CUT_LAYERS`` (``--tp-server``)."""
    from production_stack_tpu_torch.kv_server import KVServer

    out = {"servers": []}
    out["store"] = store = KVServer()
    url = f"http://127.0.0.1:{store.start('127.0.0.1', 0)}"
    try:
        for name, extra in (
                ("P", [*SEQKV_SEQ, "--sequence-parallel-size", "2",
                       "--role", "prefill", "--num-blocks",
                       str(SEQKV_P_BLOCKS), "--remote-kv-url", url]),
                ("D", [*SEQKV_SEQ, "--role", "decode", "--num-blocks",
                       str(SEQKV_D_BLOCKS)]),
                ("P2", [*SEQKV_SEQ, "--sequence-parallel-size", "2",
                        "--num-blocks", str(SEQKV_P2_BLOCKS),
                        "--kv-host-cache-bytes", str(KV_HOST_BYTES),
                        "--remote-kv-url", url])):
            out[name] = _TpServer(extra)
            out["servers"].append(out[name])
    except BaseException:
        _seqkv_close(out)
        raise
    return out


def _seqkv_close(started: dict) -> None:
    for srv in started.get("servers", []):
        srv.kill()
    started["servers"] = []
    if started.get("store") is not None:
        started["store"].shutdown()
        started["store"] = None


def _seqkv_prompts(np) -> list:
    rng = np.random.default_rng(24)
    lo, hi = SEQKV_LENS
    lens = [hi] + [int(x) for x in rng.integers(lo, hi + 1, SEQKV_N - 1)]
    return [rng.integers(0, 256, n).tolist() for n in lens]


def _seqkv_tiers(np, P2, store, ref: dict, tag: str) -> dict:
    """(c)'s tiers on P2 (seq 2, the host tier, the store P offloaded to
    at each finish): wave A (the first ``SEQKV_TIER_N`` of ``ref``'s
    prompts) from the remote tier, fresh, against P's answers; wave B
    through the ring, which evicts A from P2's pool; A again from the host
    tier, against P2's first serve. Each tier's hits and committed blocks
    at least 90% of A's usable blocks."""
    from production_stack_tpu_torch.engine.kv_cache import HASH_SEED
    from production_stack_tpu_torch.engine.kv_offload import chain_hashes

    bs, band = TPKV_BS, ref["band"]
    wave_a = ref["prompts"][:SEQKV_TIER_N]
    runs_a = ref["runs"][:SEQKV_TIER_N]
    usable = sum((len(p) - 1) // bs for p in wave_a)
    keys = {str(h) for p in wave_a
            for h in chain_hashes(p, bs, HASH_SEED)[:(len(p) - 1) // bs]}
    t_end = time.monotonic() + 120
    while True:
        with store._lock:
            left = len(keys - store.blocks.keys())
        if not left:
            break
        if time.monotonic() > t_end:
            raise AssertionError(f"[{tag}] remote tier: {left} of wave A's "
                                 "blocks never put")
        time.sleep(0.05)

    def tier(name: str) -> tuple:
        t = _perf(P2.base)["kv_tier"]
        return t["tiers"][name]["hits"], t["prefetch"]["blocks"]

    hits0, blocks0 = tier("remote")
    warm = _tpkv_wave(P2.base, wave_a, TPKV_OUT)
    hits1, blocks1 = tier("remote")
    remote = {"hits": hits1 - hits0, "committed": blocks1 - blocks0}
    if min(remote.values()) < 0.9 * usable:
        raise AssertionError(f"[{tag}] remote tier: {remote} of {usable} "
                             "usable blocks")
    same = [_kv_same(f"{tag} remote tier {i}", runs_a[i], warm[i], band)
            for i in range(SEQKV_TIER_N)]
    rng = np.random.default_rng(25)
    wave_b = [rng.integers(0, 256, n).tolist() for n in SEQKV_B]
    _tpkv_wave(P2.base, wave_b, TPKV_OUT)
    rings = _perf(P2.base)["compile"]["counts"].get(
        f"prefill_ring:{SEQ_PAD}", 0)
    hits0, blocks0 = tier("host")
    back = _tpkv_wave(P2.base, wave_a, TPKV_OUT)
    hits1, blocks1 = tier("host")
    host = {"hits": hits1 - hits0, "committed": blocks1 - blocks0}
    if min(host.values()) < 0.9 * usable:
        raise AssertionError(f"[{tag}] host tier: {host} of {usable} "
                             "usable blocks")
    same += [_kv_same(f"{tag} host tier {i}", warm[i], back[i], band)
             for i in range(SEQKV_TIER_N)]
    if not rings:
        raise AssertionError(f"[{tag}] wave B took no ring prefill")
    return {"usable_blocks": usable, "remote": remote, "host": host,
            "tier_tokens_compared": sum(n for n, _ in same),
            "tier_max_logprob_dev": max(w for _, w in same),
            "tier_bytes": _perf(P2.base)["kv_tier"]["bytes"]}


def _seqkv_phase(np, card: str, started: dict) -> dict:
    """(c) llama-3-8b bf16 at ``CUT_LAYERS``: P at seq 2 (``--role
    prefill``) and D at seq 1 (``--role decode``). P's own unified
    answers to 8 prompts of 4500-6000 tokens x 16, through the ring, twice
    (the repeat's deviation sets the band); the 8 pulled from P by D, then
    pushed from P to D and spliced, and a fresh ``SEQKV_LONE``-token
    prompt pushed alone, judged as phase 9 judges them against P's
    answers (``_tpkv_pd``): imports 8, splices 8, tokens equal up to a
    near-tie, logprobs within the band, the lone push's landed blocks
    the producer's bit for bit; beside it, P2's tiers
    (``_seqkv_tiers``). Returns rank 0's launches summed over the three
    servers, each read before and after."""
    tag = "seq2-kv-plane"
    t_phase = time.perf_counter()
    P, D, P2, store = (started["P"], started["D"], started["P2"],
                       started["store"])
    servers = [P, D, P2]
    P.up(tag, graphs=True, size=2)
    D.up(tag, graphs=True, size=1)
    P2.up(tag, graphs=True, size=2)
    before = [srv.launches() for srv in servers]
    prompts = _seqkv_prompts(np)
    rings0 = _perf(P.base)["compile"]["counts"]
    t0 = time.perf_counter()
    runs = _tpkv_wave(P.base, prompts, TPKV_OUT)
    ref_s = time.perf_counter() - t0
    counts = _perf(P.base)["compile"]["counts"]
    if not counts.get(f"prefill_ring:{SEQ_PAD}") or rings0.get(
            f"prefill_ring:{SEQ_PAD}"):
        raise AssertionError(f"[{tag}] the reference wave took no ring "
                             f"prefill: {counts}")
    again = _tpkv_wave(P.base, prompts, TPKV_OUT)
    noise = max(_kv_dev(u, r)[1] for u, r in zip(runs, again))
    band = max(BF16_LOGPROB_BAND, 2 * noise)
    ref = {"prompts": prompts, "runs": runs, "band": band}
    # P -> D and P2's tiers at once: they share no server
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        pd = pool.submit(_tpkv_pd, np, P, D, ref, card, tag, SEQKV_LONE,
                         f"from seq 2 to seq 1 ({{}}; {SEQ_NOTE})")
        tiers = pool.submit(_seqkv_tiers, np, P2, store, ref, tag)
        pd, tiers = pd.result(), tiers.result()
    after = [srv.launches() for srv in servers]
    with concurrent.futures.ThreadPoolExecutor(len(servers)) as pool:
        stops = dict(zip(("P", "D", "P2"), pool.map(
            lambda srv: srv.stop(tag), servers)))
    launches = {k: sum(a[k] - b[k] for a, b in zip(after, before))
                for k in after[0]}
    _expect(launches, {"K1", "K2", "K3"}, tag)
    out = {"reference_wave_s": ref_s, "noise": noise, "band": band,
           "imports": pd["imports"], "spliced": pd["spliced"],
           "lone_push_blocks": pd["lone_push"]["blocks"], **tiers,
           "up_s": {"P": P.up_s, "D": D.up_s, "P2": P2.up_s},
           "stops": stops, "launches": launches,
           "pids": [srv.proc.pid for srv in servers],
           "phase_s": time.perf_counter() - t_phase}
    log(f"[{tag}] (c) llama-3-8b bf16 at {CUT_LAYERS} layers, a seq 2 "
        f"prefill server, a seq 1 decode server and a fresh seq 2 server "
        f"with the tiers ({card}; {SEQ_NOTE}): {json.dumps(out)}")
    return out


def seq_features_phase(torch, np, counters, card: str,
                       started: dict) -> dict:
    """Phase 24 (``seq2-features-one-card``): (c) the KV plane at seq 2
    on the servers ``started`` beside phases 22-23 (``_seqkv_start``),
    stopped after; then (a) mixtral-8x7b int8 at seq 2 and (b) at seq 2 x
    tp 2 (``_seqf_ring``). Returns each part's launches (rank 0's)."""
    t_phase = time.perf_counter()
    try:
        kv = _seqkv_phase(np, card, started)
    except BaseException:
        for srv in started.get("servers", []):
            log(srv.log_tail())
        raise
    finally:
        _seqkv_close(started)
    a = _seqf_ring(torch, np, counters, card, 1, range(len(SEQ_LENS)))
    b = _seqf_ring(torch, np, counters, card, 2, SEQF_GRID, a["dense"])
    log(f"[seq2-features] phase 24 ({card}) in "
        f"{time.perf_counter() - t_phase:.1f} s: (c) "
        f"{kv['phase_s']:.1f} s, (a) up {a['up_s']:.1f} s, (b) up "
        f"{b['up_s']:.1f} s")
    return {"launches": {"seq2-moe-int8": a["launches"],
                         "seq2tp2-moe-int8": b["launches"],
                         "seq2-kv-plane": kv["launches"]},
            "pids": kv["pids"], "ring_wave": a["wave"]}


# -- phase 25: expert parallelism ------------------------------------------

EP_NOTE = ("the expert ranks share one card over gloo, their combine "
           "through host memory: not an EP speed")
EP_PREFILL = 208  # _ep_moves' prompt: 13 full blocks of 16 tokens
EP_BUCKET = 256


def _ep_moves(np, eng, counters) -> dict:
    """One bucketed prefill dispatch (the bucketed path's step, K1 and K4)
    of an ``EP_PREFILL``-token prompt into blocks 1-13, greedy with
    logprobs, through the mirrored runner; those blocks exported, imported
    into blocks 20-32 and exported again. Called with no request live (the
    prefix cache off, so no block is held). Returns the sampled token and
    logprobs, both exports on the host and the launches of the dispatch,
    rank 0's and each follower's."""
    runner = eng.runner
    bs = eng.config.cache.block_size
    n = EP_PREFILL // bs
    M = eng._block_tables.shape[1]
    ids = list(range(1, n + 1))
    tables = np.zeros((1, M), np.int32)
    tables[0, :n] = ids
    pos = np.full((1, EP_BUCKET), -1, np.int32)
    pos[0, :EP_PREFILL] = np.arange(EP_PREFILL)
    slots = np.full(EP_BUCKET, -1, np.int32)
    slots[:EP_PREFILL] = (np.repeat(ids, bs) * bs
                          + np.tile(np.arange(bs), n))
    tokens = np.zeros((1, EP_BUCKET), np.int32)
    tokens[0, :EP_PREFILL] = np.random.default_rng(25).integers(
        0, eng.config.model.vocab_size, EP_PREFILL)
    before = runner.follower_reports()
    _zero(counters)
    out = runner.prefill(
        tokens, pos, tables, np.full(1, EP_PREFILL, np.int32), slots,
        np.full(1, EP_PREFILL - 1, np.int32), np.zeros(1, np.float32),
        np.ones(1, np.float32), np.full(1, -1, np.int32),
        np.zeros(1, np.uint32), greedy_only=True)
    launches = _counts(counters)
    after = runner.follower_reports()
    blocks = runner.export_blocks(ids).clone()
    again = list(range(20, 20 + n))
    runner.import_blocks(again, blocks)
    back = runner.export_blocks(again).clone()
    return {"prefill": [x.cpu().numpy() for x in out], "blocks": blocks,
            "imported": back, "launches": launches,
            "followers": [{k: v - b["launches"].get(k, 0)
                           for k, v in a["launches"].items()}
                          for a, b in zip(after[1:], before[1:])]}


def _ep_weights(cfg, tp: int, ep: int) -> list:
    """Each process's weight bytes at (tp, ep), from the shapes alone:
    ``param_shapes`` cut by its ``Shard`` (the router whole), int8 values
    and float32 scales of the quantized leaves, the rest in bf16."""
    from production_stack_tpu_torch.engine import quant
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.parallel import shardings

    shapes = llama.param_shapes(cfg)
    specs = shardings.held_specs(llama.param_specs(cfg))
    axes = {**quant.contract_axes(cfg), **quant.TOP_CONTRACT}
    out = []
    for g in range(tp * ep):
        shard = shardings.Shard.of(cfg, g % tp, tp, (g // tp, ep))
        total = 0
        leaves = [(k, v, specs[k]) for k, v in shapes.items()
                  if k != "layers"] + [
            (k, v, specs["layers"][k]) for k, v in shapes["layers"].items()]
        for name, shape, spec in leaves:
            local = [shard.local(a, d) for a, d in zip(spec, shape)]
            if name in axes:
                total += math.prod(local) + 4 * math.prod(
                    d for i, d in enumerate(local) if i not in axes[name])
            else:
                total += cfg.torch_dtype.itemsize * math.prod(local)
        out.append(total)
    return out


def _ep_run(torch, np, counters, card: str, tp: int, want: tuple,
            tag: str) -> dict:
    """One engine at expert 2 x ``tp`` (``_moe_tp_engine``): its weight
    bytes a process, phase 16's wave (``want``'s prompts) with its
    launches, every rank's report, the combine's bytes against
    ``_GridRows``; at tp 1 (d)'s step walls, at tp 2 ``_ep_moves``."""
    prompts, sp = want
    t0 = time.perf_counter()
    eng = _moe_tp_engine(MOE_TP_BLOCKS, tp, ep=2)
    up = time.perf_counter() - t0
    try:
        rows = _GridRows(eng)
        held = eng.runner.gather("param_bytes")
        _fresh_slots(eng)
        _zero(counters)
        t1 = time.perf_counter()
        got = _greedy_tokens(eng, prompts, sp)
        wave = time.perf_counter() - t1
        launches = _counts(counters)
        reports = eng.runner.follower_reports()
        moves = _ep_moves(np, eng, counters) if tp > 1 else None
        steps = (_tp_steps(torch, np, eng, card, tag, length=32, reps=1)
                 if tp == 1 else None)
        final = eng.runner.follower_reports()
        combine = {"want": rows.want(eng.config.model, eng.runner.ranks.grid)[
            "moe_combine"], "calls": len(rows.moe),
                   "ranks": [r["wire"].get("moe_combine", 0.0)
                             for r in final]}
        blocks = eng.runner.num_blocks
    finally:
        eng.close()
    del eng
    _released(torch, tag)
    return {"up_s": up, "wave_s": wave, "run": got, "held": held,
            "launches": launches, "reports": reports, "moves": moves,
            "steps": steps, "combine": combine, "blocks": blocks}


def ep_phase(torch, np, counters, card: str, tpf: dict) -> dict:
    """Phase 25 (a) and (b) (module docstring), against phase 16's waves
    (``tpf``: its prompts, its one-process wave, its tp 2 wave and tp 2's
    ``_ep_moves``). Returns each engine's wave launches, and (b)'s
    bucketed dispatch's."""
    from production_stack_tpu_torch.engine.config import ModelConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(ModelConfig.from_pretrained(
        "mixtral-8x7b", quant="int8"), num_layers=CUT_LAYERS)
    want = (tpf["prompts"], tpf["sp"])
    out = {}
    for tp, ref, tag in ((1, tpf["tp1_run"], "ep2-moe-int8"),
                         (2, tpf["tp2_run"], "ep2tp2-moe-int8")):
        run = _ep_run(torch, np, counters, card, tp, want, tag)
        part = "(a)" if tp == 1 else "(b)"
        weights = _ep_weights(cfg, tp, 2)
        same, dev, flips = _tp_dev(ref, run["run"])
        launches = run["launches"]
        rec = {"processes": 2 * tp, "up_s": run["up_s"],
               "wave_s": run["wave_s"], "kv_blocks": run["blocks"],
               "weight_bytes": run["held"], "weight_bytes_want": weights,
               "tokens": sum(map(len, run["run"][0].values())),
               "tokens_before_first_flip": same, "max_logprob_dev": dev,
               "flips": len(flips), "launches": launches,
               "places": [r["place"] for r in run["reports"]],
               "calls": run["reports"][0]["calls"],
               "moe_combine_bytes": run["combine"]}
        if run["steps"] is not None:
            rec["steps"] = run["steps"]
        log(f"[ep2] {part} {tag} at {CUT_LAYERS} layers ({card}; "
            f"{EP_NOTE}): {json.dumps(rec)}")
        if run["run"] != ref:
            raise AssertionError(
                f"[ep2] {part} {tag}'s wave is not "
                f"{'one process' if tp == 1 else 'tp 2'}'s bit for bit: "
                f"{same} tokens before the first flip, logprobs up to {dev} "
                f"apart, flips at {flips[:4]}")
        if run["held"] != weights:
            raise AssertionError(f"[ep2] {part} weight bytes a process "
                                 f"{run['held']}, want {weights}")
        comb = run["combine"]
        if comb["want"] <= 0 or any(b != comb["want"]
                                    for b in comb["ranks"]):
            raise AssertionError(f"[ep2] {part} moe_combine bytes "
                                 f"{comb['ranks']}, want {comb['want']}")
        _expect(launches, {"K1", "K2", "K3"}, tag)
        _tp_agree(f"{part} {tag}", run["reports"], launches)
        if run["moves"] is not None:
            mv, ref_mv = run["moves"], tpf["tp2_moves"]
            same_prefill = all(np.array_equal(a, b) for a, b in
                               zip(mv["prefill"], ref_mv["prefill"]))
            kv = {"prefill_equal": same_prefill,
                  "export_equal": bool(torch.equal(mv["blocks"],
                                                   ref_mv["blocks"])),
                  "import_equal": bool(torch.equal(mv["imported"],
                                                   mv["blocks"])),
                  "export_bytes": mv["blocks"].numel()
                  * mv["blocks"].element_size(),
                  "launches": mv["launches"],
                  "followers": mv["followers"]}
            log(f"[ep2] (b) a bucketed prefill of {EP_PREFILL} tokens and "
                f"its KV against tp 2's ({card}): {json.dumps(kv)}")
            if not (same_prefill and kv["export_equal"]
                    and kv["import_equal"]):
                raise AssertionError(f"[ep2] (b) the bucketed dispatch or "
                                     f"its KV moves differ from tp 2's: {kv}")
            _expect(mv["launches"], {"K1", "K4"}, f"{tag} bucketed")
            if any(f != mv["launches"] for f in mv["followers"]):
                raise AssertionError(f"[ep2] (b) bucketed launches by rank "
                                     f"{mv['launches']} {mv['followers']}")
            out[f"{tag}-bucketed"] = mv["launches"]
        out[tag] = launches
    _ep_bf16(torch, np, card, want)
    log(f"[ep2] phase 25 ({card}) in {time.perf_counter() - t_phase:.1f} s")
    return out


def _ep_bf16(torch, np, card: str, want: tuple) -> dict:
    """(c) bf16 mixtral-8x7b at ``CUT_LAYERS`` layers on phase 16's wave
    (``want``: its prompts and greedy sampling with logprobs): one
    process, released, then expert 2 (each rank's batched expert product
    over X / 2 experts, ``torch.bmm``, where one process runs it over X).
    Judged: every token and logprob equal. Returns each run's figures."""
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        config_from_args,
    )
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    prompts, sp = want
    cfg = config_from_args(build_parser().parse_args(
        ["--model", "mixtral-8x7b", "--seed", "0", "--tensor-parallel-size",
         "1", "--num-blocks", str(MOE_TP_BLOCKS)]))
    cfg = dataclasses.replace(
        _cut_depth(cfg), cache=dataclasses.replace(
            cfg.cache, enable_prefix_caching=False),
        scheduler=dataclasses.replace(cfg.scheduler, decode_graphs=False))
    runs = {}
    for ep in (1, 2):
        t0 = time.perf_counter()
        eng = (LLMEngine(cfg, device="cuda") if ep == 1 else LLMEngine(
            dataclasses.replace(cfg, mesh=MeshConfig(tensor=1, expert=2)),
            device="cuda", rank_devices=["cuda:0"] * 2, backend="gloo"))
        up = time.perf_counter() - t0
        try:
            held = (eng.runner.gather("param_bytes") if ep > 1
                    else [eng.runner.param_bytes()])
            _fresh_slots(eng)
            t0 = time.perf_counter()
            run = _greedy_tokens(eng, prompts, sp)
            runs[ep] = {"run": run, "up_s": up, "held": held,
                        "wave_s": time.perf_counter() - t0}
        finally:
            eng.close()
        del eng
        _released(torch, f"ep{ep} moe-bf16")
    same, dev, flips = _tp_dev(runs[1]["run"], runs[2]["run"])
    rec = {"tokens": sum(map(len, runs[1]["run"][0].values())),
           "tokens_before_first_flip": same, "max_logprob_dev": dev,
           "flips": len(flips), "bit_for_bit": runs[2]["run"] == runs[1]["run"],
           **{f"ep{ep}_{k}": r[k] for ep, r in runs.items()
              for k in ("up_s", "wave_s", "held")}}
    log(f"[ep2] (c) mixtral-8x7b bf16 at {CUT_LAYERS} layers, expert 2 "
        f"against one process ({card}; {EP_NOTE}): {json.dumps(rec)}")
    if not rec["bit_for_bit"]:
        raise AssertionError(
            f"[ep2] (c) bf16 expert 2 is not one process bit for bit: "
            f"{same} tokens before the first flip, logprobs up to {dev} "
            f"apart, flips at {flips[:4]}")
    return rec


# -- phase 26: every mesh on one process grid --------------------------------

GRID_NOTE = ("four processes share one card over gloo, their views' "
             "collectives staged through host memory: not a speed of any "
             "axis")


def _grid_engine(flags: list, mesh: dict, impl: str | None = None):
    """The engine of the server's ``flags`` (seed 0, tensor size 1) at
    ``CUT_LAYERS`` layers and ``mesh``'s sizes (through
    ``EngineConfig.mesh``: the CLI has no expert flag), prefix cache off,
    decode eager: one process, or pipeline stages in one process, or the
    grid's processes, every one on cuda:0 over gloo."""
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        config_from_args,
    )
    from production_stack_tpu_torch.parallel.distributed import Grid
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    cfg = config_from_args(build_parser().parse_args(
        ["--seed", "0", "--tensor-parallel-size", "1", *flags]))
    cfg = dataclasses.replace(
        _cut_depth(cfg), cache=dataclasses.replace(
            cfg.cache, enable_prefix_caching=False),
        scheduler=dataclasses.replace(cfg.scheduler, decode_graphs=False),
        mesh=MeshConfig(tensor=1, **mesh),
        **({"attention_impl": impl} if impl else {}))
    grid = Grid.of(cfg.mesh, 1)
    if grid.size == 1:
        return LLMEngine(cfg, device="cuda")
    if grid.axes == ("stage",):
        return LLMEngine(cfg, device="cuda",
                         stage_devices=["cuda:0"] * grid.stage)
    return LLMEngine(cfg, device="cuda", rank_devices=["cuda:0"] * grid.size,
                     backend="gloo")


class _GridRows:
    """Rank 0's calls from now on, by what its views send: the rows each
    of its MoE layers runs (a ragged step's live stream as
    ``stream_length`` rounds it, a bucketed chunk batch's P x S, a fused
    decode iteration's rows, a ring prefill's S / n slice), the rows stage
    0 relays and the tokens it receives (a chunk batch's P x S and P, a
    decode step's rows), and each ring prefill's padded length."""

    def __init__(self, eng):
        from production_stack_tpu_torch.engine.model_runner import (
            stream_length,
        )

        runner, n = eng.runner, eng.runner.ranks.grid.seq
        steps = eng.config.scheduler.multi_step or 1
        self.moe, self.relay, self.last, self.ring = [], [], [], []

        def wrap(name, moe, relay=None, last=None):
            if not hasattr(runner, name):
                return
            inner = getattr(runner, name)

            def spy(*args, **kw):
                self.moe.append(moe(*args))
                if relay is not None:
                    self.relay.append(relay(*args))
                    self.last.append(last(*args))
                return inner(*args, **kw)

            setattr(runner, name, spy)

        wrap("ragged_step", lambda tokens, *a: stream_length(
            len(tokens), int(a[3][-1])))
        wrap("prefill", lambda tokens, *a: int(tokens.size),
             lambda tokens, *a: int(tokens.size),
             lambda tokens, *a: int(tokens.shape[0]))
        wrap("decode_multi", lambda tokens, *a: len(tokens) * steps,
             lambda tokens, *a: len(tokens) * steps,
             lambda tokens, *a: len(tokens) * steps)

        def ring_rows(tokens, *a):
            self.ring.append(int(tokens.shape[1]))
            return int(tokens.shape[1]) // n

        wrap("prefill_ring", ring_rows)

    def want(self, cfg, grid) -> dict:
        """Each view's bytes on rank 0 by formula: the combine a float32
        (rows, E) all-reduce a MoE layer of rank 0's stage over the expert
        view, 2 (N - 1) / N of it; a ring prefill of S tokens at n seq
        ranks L (n - 1) S / n rows of K and V rotated and as many
        gathered, its last hidden row (n - 1) / n, L (n - 1) X int32
        counts; the relay stage 0's hidden rows and (S - 1) / S of the
        last stage's int32 tokens."""
        E, b = cfg.hidden_size, cfg.torch_dtype.itemsize
        out = {}
        if grid.expert > 1 and cfg.num_experts:
            N, layers = grid.expert, cfg.num_layers // grid.stage
            out["moe_combine"] = float(sum(
                r * layers * E * 4 * 2.0 * (N - 1) / N for r in self.moe))
        if self.ring:
            n, L = grid.seq, cfg.num_layers
            kv = 2 * cfg.num_kv_heads * cfg.head_dim * b
            out["ring_rotate"] = out["ring_gather"] = float(sum(
                L * (n - 1) * (S // n) * kv for S in self.ring))
            out["ring_last"] = len(self.ring) * E * b * (n - 1) / n
            if cfg.num_experts:
                out["ring_moe_counts"] = float(
                    len(self.ring) * L * (n - 1) * cfg.num_experts * 4)
        if grid.stage > 1:
            S = grid.stage
            out["stage_relay"] = float(sum(self.relay) * E * b)
            out["stage_last"] = sum(self.last) * 4 * (S - 1) / S
        return out


def _grid_steps(torch, np, eng, label: str) -> dict:
    """A decode step at 64 rows (contexts of 32 + a few tokens) and the
    first step of a 2048-token prompt, host wall to a synchronise, with
    the bytes each op put on rank 0's wire in each."""
    rng = np.random.default_rng(26)
    wire = eng.runner.ranks.wire

    def timed() -> tuple:
        sent = dict(wire)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, {
            op: n - sent.get(op, 0.0) for op, n in wire.items()
            if n != sent.get(op, 0.0)}

    _dg_admit(np, eng, rng, f"{label}-d", 64, 32, 64)
    decode, decode_wire = timed()
    _dg_clear(eng)
    _add_requests(eng, rng, f"{label}-p", 1, 2048, 1)
    prefill, prefill_wire = timed()
    _dg_clear(eng)
    return {"decode_64_ms": decode, "prefill_2048_ms": prefill,
            "wire_bytes_a_step": {"decode_64": decode_wire,
                                  "prefill_2048": prefill_wire}}


def _grid_part(torch, np, counters, card: str, tag: str, flags: list,
               mesh: dict, impl: str | None, want: tuple, expect: set,
               ref_tag: str) -> dict:
    """One part of phase 26: the grid engine's wave (``want``: prompts,
    sampling, and the reference run it must equal bit for bit), rank 0's
    launches on it and every process's (each must launch ``expect``),
    every process's weight bytes and report, the views' bytes on the wave
    against ``_GridRows.want`` (exact), then ``_grid_steps``."""
    from production_stack_tpu_torch.parallel.distributed import Grid

    prompts, sp, ref = want
    t0 = time.perf_counter()
    eng = _grid_engine(flags, mesh, impl)
    up = time.perf_counter() - t0
    try:
        grid = eng.runner.ranks.grid
        if grid != Grid(**mesh):
            raise AssertionError(f"[{tag}] the engine's grid {grid}")
        cfg = eng.config.model
        ring_on = eng.scheduler.ring_enabled
        held = eng.runner.gather("param_bytes")
        rows = _GridRows(eng)
        before = eng.runner.follower_reports()
        wire0 = dict(eng.runner.ranks.wire)
        _fresh_slots(eng)
        _zero(counters)
        t0 = time.perf_counter()
        got = _greedy_tokens(eng, prompts, sp)
        wave = time.perf_counter() - t0
        launches = _counts(counters)
        reports = eng.runner.follower_reports()
        wire = {op: n - wire0.get(op, 0.0)
                for op, n in eng.runner.ranks.wire.items()
                if n != wire0.get(op, 0.0)}
        predicted = rows.want(cfg, grid)  # the wave's calls, not the steps'
        steps = _grid_steps(torch, np, eng, tag)
    finally:
        eng.close()
    del eng
    _released(torch, tag)
    places = [r["place"] for r in reports]
    rec = {"processes": grid.size, "grid": grid.shape, "up_s": up,
           "wave_s": wave, "weight_bytes": held,
           "tokens": sum(map(len, got[0].values())),
           "ring_enabled": ring_on, "ring_calls": rows.ring,
           "launches": launches,
           "launches_by_process": [
               {k: n - before[i]["launches"].get(k, 0)
                for k, n in r["launches"].items()}
               for i, r in enumerate(reports)],
           "places": places, "calls": reports[0]["calls"],
           "wire": wire, "predicted": predicted, **steps}
    log(f"[grid] {tag} at {CUT_LAYERS} layers ({card}; {GRID_NOTE}): "
        f"{json.dumps(rec)}")
    same, dev, flips = _tp_dev(ref, got) if ref[1] and any(
        ref[1].values()) else (None, None, [])
    if got != ref:
        raise AssertionError(
            f"[grid] {tag}'s wave is not {ref_tag}'s bit for bit: {same} "
            f"tokens before the first flip, logprobs up to {dev} apart, "
            f"flips at {flips[:4]}; tokens {got[0]} against {ref[0]}")
    if places != [{a: grid.coords(g)[a] for a in grid.axes}
                  for g in range(grid.size)]:
        raise AssertionError(f"[grid] {tag}: the processes' places {places}")
    if {op: wire.get(op) for op in predicted} != predicted or any(
            op not in predicted for op in wire
            if op.startswith(("ring_", "stage_", "moe_"))):
        raise AssertionError(f"[grid] {tag}: the views' bytes {wire}, want "
                             f"{predicted}")
    if grid.seq > 1 and grid.stage > 1 and (ring_on or rows.ring):
        raise AssertionError(f"[grid] {tag}: a ring ran beside stages")
    if grid.seq > 1 and grid.stage == 1 and not rows.ring:
        raise AssertionError(f"[grid] {tag}: no prompt took the ring")
    _expect(launches, expect, tag)
    _tp_agree(tag, reports, launches, before)
    return rec


def grid_one_card_phase(torch, np, counters, card: str, ring_wave: dict,
                        tpf: dict) -> dict:
    """Phase 26 (``grid-one-card``): (a) mixtral-8x7b int8 at seq 2 x
    expert 2 on phase 24 (a)'s prompts through the ring, against that
    wave (seq 2 at expert 1); (b) mixtral-8x7b int8 at stage 2 x expert 2,
    bucketed, on phase 16's prompts, against one process's bucketed wave
    at the same depth (run first and released); (c) llama-3-8b bf16 at seq
    2 x stage 2, bucketed, on phase 15's prompts, against pp 2's wave in
    one process at the same depth (run first and released). Returns each
    part's wave launches (rank 0's)."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    t_phase = time.perf_counter()
    moe = ["--model", "mixtral-8x7b", "--quantization", "int8"]
    out = {}
    a = _grid_part(
        torch, np, counters, card, "ep2seq2",
        [*moe, "--sequence-parallel-size", "2", "--max-model-len",
         str(SEQ_MAX_LEN), "--ring-prefill-threshold", str(SEQ_THRESHOLD),
         "--num-blocks", str(SEQF_BLOCKS)], dict(seq=2, expert=2), None,
        (ring_wave["prompts"], ring_wave["sp"], ring_wave["run"]),
        {"K1", "K3"}, "phase 24 (a)'s seq 2")
    out["ep2seq2"] = a["launches"]
    prompts = tpf["ep"]["prompts"]
    sp = SamplingParams(temperature=0.0, max_tokens=TPF_TOKENS,
                        ignore_eos=True)
    flags = [*moe, "--num-blocks", str(MOE_TP_BLOCKS)]
    for tag, part_flags, mesh, ref_mesh, part_prompts, part_sp, what in (
            ("ep2pp2", flags, dict(stage=2, expert=2), {}, prompts, sp,
             "one process's bucketed"),
            ("seq2pp2", ["--model", "llama-3-8b", "--num-blocks",
                         str(TP_BLOCKS), "--sequence-parallel-size", "2"],
             dict(stage=2, seq=2), dict(stage=2), _tp_prompts(np),
             SamplingParams(temperature=0.0, max_tokens=TP_TOKENS,
                            ignore_eos=True), "pp 2's in one process")):
        t0 = time.perf_counter()
        eng = _grid_engine(part_flags, ref_mesh, "bucketed")
        try:
            _fresh_slots(eng)
            ref = _greedy_tokens(eng, part_prompts, part_sp)
        finally:
            eng.close()
        del eng
        _released(torch, f"{tag} reference")
        ref_s = time.perf_counter() - t0
        rec = _grid_part(torch, np, counters, card, tag, part_flags, mesh,
                         "bucketed", (part_prompts, part_sp, ref),
                         {"K1", "K3", "K4"}, what)
        log(f"[grid] {tag}: {rec['tokens']} greedy tokens equal {what} wave "
            f"bit for bit (its engine up and run in {ref_s:.1f} s)")
        out[tag] = rec["launches"]
    log(f"[grid] phase 26 ({card}) in {time.perf_counter() - t_phase:.1f} s")
    return out


def _no_hbm_alarm_left(pids=()) -> int:
    """Every server of this run but phase 13's keeps its bundles in the
    default archive (a directory a process under the system tmpdir): this
    process's and those of the servers that ran in the processes ``pids``
    may hold no hbm_pressure bundle. Returns the bundles there."""
    import os
    import tempfile

    names = []
    for pid in (os.getpid(), *pids):
        root = pathlib.Path(tempfile.gettempdir()) / \
            f"pstpu-diagnostics-{pid}"
        if root.is_dir():
            names += sorted(p.name for p in root.iterdir())
    hbm = [n for n in names if n.endswith("-hbm_pressure")]
    if hbm:
        raise AssertionError(f"[observability] served paths left "
                             f"hbm_pressure bundles: {hbm}")
    log(f"[observability] default archive: {len(names)} bundle(s) "
        f"{names[:8]}, no hbm_pressure")
    return len(names)


def _expect(launches: dict, expected: set, tag: str) -> None:
    for key, n in launches.items():
        if (n > 0) != (key in expected):
            raise AssertionError(
                f"[features] {tag}: kernel {key} launched {n} times; this "
                f"path must launch {sorted(expected)} and no other")


_READERS = """
import importlib, json, sys
out = {}
for name in ("tensorstore", "zstandard", "compression.zstd"):
    try:
        mod = importlib.import_module(name)
        out[name] = getattr(mod, "__version__", "imported")
    except Exception as e:
        out[name] = f"absent: {type(e).__name__}: {e}"
out["jax_imported"] = "jax" in sys.modules
print(json.dumps(out))
"""


def _orbax_readers() -> dict:
    """Whether ``tensorstore`` and a zstd decoder (``zstandard``, or the
    standard library's ``compression.zstd``) import on this machine, with
    their versions, in a process of their own: the reference's
    ``save_orbax`` writes OCDBT with zstd-compressed nodes."""
    got = subprocess.run([sys.executable, "-c", _READERS],
                         capture_output=True, text=True, timeout=120)
    if got.returncode:
        raise AssertionError(f"[orbax] the import check exited "
                             f"{got.returncode}: {got.stderr[-2000:]}")
    return json.loads(got.stdout.strip().splitlines()[-1])


def main() -> int:
    if not (ROOT / "production_stack_tpu_torch" / "__init__.py").exists():
        print("chip_smoke.py: the production_stack_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    from production_stack_tpu_torch.ops import _build
    from production_stack_tpu_torch.ops import kv_write as k1
    from production_stack_tpu_torch.ops import paged_decode_attention as k3
    from production_stack_tpu_torch.ops import paged_prefill_attention as k4
    from production_stack_tpu_torch.ops import ragged_paged_attention as k2

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s): {card}")

    log(f"[orbax] readers on this machine: {json.dumps(_orbax_readers())}")
    build_s = _build.build_all()
    log(f"[build] kernels built in {build_s:.1f} s")

    laps = [("start", t_start)]

    def lap(name: str) -> None:
        laps.append((name, time.perf_counter()))

    results = kernel_phase(torch, np, card)
    lap("1-3 build, kernels")
    counters = [k1.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES, k4.LAUNCHES]
    by_path = {
        "ragged": slice_phase(torch, np, counters, card, "ragged",
                              {"K1", "K2", "K3"}),
        "bucketed": slice_phase(torch, np, counters, card, "bucketed",
                                {"K1", "K3", "K4"}),
    }
    lap("4 slices")
    for impl in list(by_path):
        parity_phase(torch, np, impl)
        bf16_phase(torch, np, impl)
    features_parity_phase(torch, np)
    spec_bf16_phase(torch, np)
    moe_int8_parity_phase(torch, np)
    lap("5 parity")
    by_path.update(features_phase(torch, np, counters, card))
    lap("6 features")
    by_path["surface-ragged"] = surface_phase(torch, np, counters, card)
    lap("7 surface")
    by_path["moe-int8"] = moe_int8_phase(torch, np, counters, card)
    lap("8 moe-int8")
    kv = kv_plane_phase(torch, np, counters, card)
    by_path["kv-plane"] = kv["launches"]
    lap("9 kv-plane")
    by_path["scoring-surface"] = scoring_phase(torch, np, counters, card)
    lap("10 scoring")
    by_path["whisper"] = whisper_phase(torch, np, counters, card)
    lap("11 whisper")
    by_path["overload"] = overload_phase(torch, np, counters, card)
    lap("12 overload")
    by_path["observability"] = observability_phase(torch, np, counters,
                                                   card)
    lap("13 observability")
    by_path["decode-graphs"] = decode_graphs_phase(torch, np, counters, card)
    lap("14 decode-graphs")
    tp = tp_phase(torch, np, counters, card)
    by_path["tp2"] = tp["launches"]
    for impl, n in tp["lora_launches"].items():
        by_path[f"tp2-lora-{impl}"] = n
    lap("15 tp2")
    kv_start = _TpKvStart()  # phase 17's servers start beside phase 16
    try:
        tpf = tp_features_phase(torch, np, counters, card)
        by_path["tp2-moe-int8"] = tpf["launches"]
        lap("16 tp2-features")
        kv_tp = tp_kv_phase(np, card, kv["figures"], tp["kv_moves"],
                            kv_start)
    finally:
        kv_start.close()
    by_path["tp2-kv-plane"] = kv_tp["launches"]
    lap("17 tp2-kv-plane")
    by_path["tp2-whisper"] = tp_whisper_phase(torch, np, counters, card)
    lap("18 tp2-whisper")
    by_path["pp2"] = pp_phase(torch, np, counters, card)
    lap("19 pp2")
    seqkv = {}
    try:
        mh_start = _MhStart()  # phase 22's processes, up beside phases 20-21
        try:
            grid_srv = _seq_server_start(2)  # phase 21's, up beside phase 20
            try:
                by_path["seq2"] = seq_phase(torch, np, counters, card)
                lap("20 seq2")
                by_path["seq2tp2"] = grid_phase(torch, np, counters, card,
                                                grid_srv)
            finally:
                grid_srv.kill()
            lap("21 seq2tp2")
            # phase 24's servers, up beside phases 22-23 (phase 21's engine
            # and server released: all of them at once would not fit)
            seqkv = _seqkv_start()
            by_path["mh2"] = mh_phase(np, card, mh_start)
        finally:
            mh_start.close()
        lap("22 mh2-one-card")
        # phase 23's server starts beside its engines
        pptp_srv = _TpServer(["--pipeline-parallel-size", "2"])
        try:
            by_path["pp2tp2"] = pptp_phase(torch, np, counters, card,
                                           pptp_srv)
        finally:
            pptp_srv.kill()
        lap("23 pp2tp2-one-card")
        seqf = seq_features_phase(torch, np, counters, card, seqkv)
        by_path.update(seqf["launches"])
        lap("24 seq2-features-one-card")
    finally:
        _seqkv_close(seqkv)
    by_path.update(ep_phase(torch, np, counters, card, tpf["ep"]))
    lap("25 ep2-one-card")
    by_path.update(grid_one_card_phase(torch, np, counters, card,
                                       seqf["ring_wave"], tpf))
    lap("26 grid-one-card")
    _no_hbm_alarm_left(kv_tp["pids"] + seqf["pids"])
    log(f"[phases] seconds ({card}): " + json.dumps(
        {name: round(t - laps[k - 1][1], 1)
         for k, (name, t) in enumerate(laps) if k}))

    kernels = []
    for r in results:
        r.setdefault("also", []).append(tp["shard"][r["key"]])
        source, replaces = SRC[r["key"]]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[r["key"]] for n in by_path.values()),
            "launches_by_path": {p: n[r["key"]] for p, n in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_call": SDPA_NOTE if r["key"] != "K1" else "index_copy_",
            "timing": "device: one CUDA event pair around the replay of a "
                      "CUDA graph of many launches",
            "shape": r["shape"],
            **({"achieved_tflops": r["tflops"]} if "tflops" in r else {}),
            **{k: r[k] for k in EXTRA_KEYS if k in r},
            **({"also": [{k: a[k] for k in ALSO_KEYS if k in a}
                         for a in r["also"]]} if "also" in r else {}),
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    CHILDREN = {"--capture-drill": capture_drill_child,
                "--tp-server": tp_server_child,
                "--mh-server": mh_server_child}
    sys.exit(CHILDREN[sys.argv[1]](sys.argv[2:])
             if sys.argv[1:2] and sys.argv[1] in CHILDREN else main())
