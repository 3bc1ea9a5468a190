#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving and training paths on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
card). It exits non-zero, printing no result, when there is no CUDA device
or the port's package is not beside it. Phases, each of which fails the run:

1. The card's name and power limit; the hand-written kernels are built from
   espnet_slurp_tpu_torch/csrc (nvcc, sm_90a) and the build time, the
   compiler's register report and the blocks per SM of K3's bf16 and fp32
   forward, dkv and dq kernels and of K2's bf16 forward kernel printed, and
   K2's fp32 kernels', K4's kernels' (both dtypes), K1's (S 129 and
   401) and K6's kernels' (both dtypes, D 256, k 31) registers, shared and
   local (spill) bytes and blocks per SM.
2. Kernels at the flagship shapes the serving path gives them: K2 fused FFN
   (N = 8 utterances x T' rows, D 256, F 1024) and K3 rel-pos flash
   attention (B 8, H 4, T', Dh 64, ragged lengths, unchunked and chunk 16 /
   left 4), each against its plain PyTorch version on the same inputs in
   bf16 (error <= 2e-2 of max |ref|) and fp32 (<= 1e-4 of max |ref|), then
   timed with CUDA events (median of 25 after 3 warm-up runs) beside its
   plain version, a PyTorch yardstick where one call computes the same
   function, and its bound on an H100 SXM (K3's forward as its launch
   alone, with torch.profiler's device time beside it). K3's bf16 forward is also held
   on every row (fully masked rows included) to
   rel_flash_attention_fwd_tiled_plain at the kernel's key tile (the same
   rounding points) within BWD_PLAIN_TOL and to rel_flash_attention_plain
   within 2e-2, unchunked and chunked, and the library's host-side counts
   (K2's and K3's by instance) show which forward, dkv and dq kernels bf16
   at Dh 64 (the register-resident ones), fp32 and bf16 at Dh 128 (the
   WMMA ones) launch. K2's bf16 forward is also held to fused_ffn_plain
   (the same rounding points) within BWD_PLAIN_TOL, shown by the host
   counts to launch the register-resident ffn_fwd::fwd_kernel once (with
   its reduction where F is split across blocks), and timed as its launch alone beside its device time and the
   eager bf16 composition it replaces (F.linear -> F.silu -> F.dropout ->
   F.linear); the same at the flagship and transducer train shapes in
   phases 4 and 7.
3. The slice: a flagship-width Speech2Text (random weights from a seeded
   torch.Generator) decodes 8 synthetic 15 s utterances with beam 10,
   pre-beam 30, ctc_weight 0.3, max_len 96 (the traffic of bench.py). The
   kernels' launch counts are zeroed just before that decode and must read
   24 (K2) and 12 (K3) just after it. Then two short utterances are encoded
   in fp32 with the same weights on the CPU (plain versions) and on the card
   (kernels), and the valid frames compared (<= 1e-3 of max |ref|: twelve
   stacked blocks, fp32 sums in another order).
4. Kernels at the shapes of the flagship train step (bench.py:43-51: B 64
   utterances of 15 s, T' 468, U 64, V 5000): K1 CTC lattice forward and
   backward, K4 fused CTC head forward and backward, K2 backward and K3
   backward (unchunked and chunk 16 / left 4), each against its plain
   version's outputs and autograd gradients on the same inputs (bf16 within
   2e-2 and fp32 within 1e-4 of max |ref|, per output and gradient; K1 is
   fp32 only), then each direction timed alone as in phase 2, beside its
   plain version, a PyTorch yardstick (K1: F.ctc_loss; K3 backward: SDPA's
   backward over a constant bias, which computes no dp) and its bound.
   The bf16 backward passes of K2 and K3 are also held to
   fused_ffn_bwd_plain and rel_flash_attention_bwd_plain (the same
   rounding points) within BWD_PLAIN_TOL, and printed with each of their
   launches' device times (K2 rows / dx / dW, K3 dkv / dq; torch.profiler)
   and what one call adds to peak memory; K3's dkv and dq launches also
   get bounds of their own. K4's bf16 backward likewise: held to
   fused_ctc_head_emit_bwd_plain within BWD_PLAIN_TOL, its rows, dx and dw
   launches checked by name in torch.profiler and printed with their
   device times and what one call adds to peak memory. K4's bf16 forward
   launches ctc_head_bf16::lse_kernel (the mma.sync mainloop) and the bf16
   gather once each a call, by the library's host-side launch counts (the
   first version's ctc_head_fwd_kernel absent from the build and from the
   profiler's names), printed with the plan, each launch's device time,
   bound, registers, shared bytes, spills and blocks per SM. K1 at S 129
   launches the warp route's fwd_kernel and bwd_kernel (host counts),
   printed likewise and as us a frame beside the byte bound a frame; then
   K1 at U 200 (S 401, past the warp route's 256 states) both ways against
   its plain version within 1e-4, on the block route (host counts), timed
   beside F.ctc_loss both ways.
   K2's bf16 backward
   and K4 both ways are also timed beside the eager bf16 composition of
   their function (K2: F.linear -> F.silu -> F.dropout -> F.linear; K4:
   F.linear -> log_softmax -> gather; autograd's backward). K3's bf16 forward
   is held on every row as in phase 2 and timed beside its plain version,
   SDPA over the precomputed bias and its bound at this shape.
5. The train slice: a flagship ASRModel (fp32 parameters, bf16 compute,
   the recipe's dropout 0.1 (conf/train_ls100_conformer.yaml:14), SpecAug
   on, seeded random weights) and the port's make_train_step with Adam at
   constant lr 1e-3 (bench.py:58), on 64 synthetic 15 s utterances with U
   = 64: one warm-up step, then 5 timed steps on the same batch. Every loss
   and grad norm finite, nothing skipped, the last loss below the first,
   and per step exactly 24 K2 and 12 K3 launches forward and backward and 1
   of K4 and K1 each way (the counts zeroed just before the timed steps and
   read just after), K1's warp route and K4's bf16 launches (lse, gather;
   rows, dx, dw) once each a step by the host counts; then one profiled
   step for the device's busy time.
   The same phase then runs at dropout 0, and its step wall and busy time
   are printed beside.
6. One fp32 forward + backward of the same flagship weights on two short
   utterances (3 s, 2.1 s; SpecAug off) at the recipe's dropout 0.1 on the
   CPU (plain versions) and on the card (kernels), each side's dropout
   seeds drawn from an equally seeded CPU generator (the same Philox masks
   on both): the loss within 1e-4 relative, every parameter gradient
   within 1e-3 of its max |ref| (floored at 1e-4 of the largest gradient
   entry of the model: the key projections' biases have gradient 0 in
   exact arithmetic and hold only rounding noise).
7. The dropout kernels at the flagship train shape (B 64 x T' 468, D 256,
   F 1024, H 4, Dh 64, bf16, rate 0.1): csrc/philox.cuh reproduces
   Random123's Philox4x32-10 answer vectors on the card; the keep mask the
   launches draw equals ops/kernels/philox.py's bit for bit at K2's [N, F]
   and K3's [B * H, T', T'], its keep rate within 6 sigma of 0.9; K2 and
   K3 each way against their plain versions with the same seed, within
   BWD_PLAIN_TOL at the kernels' rounding points and within 2e-2 of the
   unrounded (fp32) plain version per output and gradient; the launches at
   both rates by the host counts, and each launch's device time at 0.1 beside
   rate 0 (the Philox draws' cost). Then K2's width route: a d_model 512 /
   d_ff 2048 FeedForward (bench.py's 17 x 512 config) in bf16 and fp32,
   forward and backward, against its plain version, with the route each
   dtype took read from K2's launch counter: eager in bf16, K2 in fp32.
8. Kernels at the shapes of the Conformer-transducer train step
   (conf/train_transducer.yaml: B 32 utterances of 15 s, T' 468, U 64):
   K2 and K3 both ways as in phase 4 (their backward passes timed beside
   the plain composition, with their launches and peak memory, as in
   phase 4), K5 RNN-T lattice (fp32
   tables [32, 468, 65], ragged T' and U, one row with a zero cotangent,
   on its one-warp-per-utterance route; then test_rnnt_lattice's edge
   cases, U1 1 to 300 at B 5, T' 40, on both routes; then the block route
   at [8, 468, 300]; each with its route by the host counts and exact zero
   gradients at frames past tlen and on zero-cotangent rows) and K6 fused
   conv module
   (x [32, 468, 256], k 31, SAME and causal with ragged lengths in bf16
   and fp32), each direction against its plain version's outputs
   and autograd gradients (bf16 within 2e-2, fp32 within 1e-4 of max
   |ref|), K6's bf16 backward also against fused_conv_module_bwd_plain
   (its rounding points) within BWD_PLAIN_TOL, and each K6 call's launches
   by the library's host-side counts (bf16: glu and out forward, glu_sig,
   rows, du, dx, dw and sum backward, on csrc/conv_module.cu's conv_bf16;
   fp32: glu, norm and out forward, glu_sig, dsw, rows, du, dx, dw and sum
   backward, on conv_f32; the first version's kernels absent from the
   build); K5 then timed as in phase 4 beside the plain
   version and the bound, with us per anti-diagonal step and each route's
   registers, shared bytes, spills and blocks per SM; K6's bf16 directions
   timed by CUDA events and device time (each launch's, torch.profiler)
   beside the plain version,
   the eager ConvModule it replaces (events and device time), the bound
   (products at the bf16 peak and the taps and elementwise work at the
   fp32 peak, counted apart) and what one backward call adds to peak
   memory, each launch with its bound, registers, shared bytes, spills and
   blocks per SM; both directions again at the flagship's B 64 (timed
   only); K6's fp32 directions the same way at B 32 and, checked again
   within 1e-4 first, at B 64 (ragged lengths), beside the plain version,
   the eager fp32 ConvModule and the bound (all work at the fp32 peak).
   Last, K6 forward in bf16 at the greedy decode's shape (x [8, T',
   256], 468 valid frames each) against its plain version, within 2e-2,
   and timed.
9. The transducer train slice: transducer_flagship_config() with
   fused_conv (fp32 parameters, bf16 compute, the yaml's dropout 0.1,
   SpecAug on, seeded random weights), Adam at constant lr 1e-3 (the
   yaml's warmuplr with 15k warm-up steps would not move the loss in 5
   steps), 32 synthetic
   15 s utterances with U = 64: one warm-up step, then 5 timed steps. Every
   loss finite, nothing skipped, the last loss below the first, and per step
   exactly 24 K2, 12 K3 and 12 K6 launches each way, 1 K5 and 1 K1 each way
   and no K4; by the host counts K1 and K5 on their warp routes and K6 on
   its bf16 launches (12 of each a step, no fp32 one).
10. One fp32 transducer forward + backward (fused_conv, SpecAug off, the
   yaml's dropout 0.1 with phase 6's seeds) of the same weights on phase
   6's two short utterances, CPU (plain versions) against the card
   (kernels): loss within 1e-4 relative, every gradient within 1e-3 of its
   max |ref| with phase 6's floor.
11. Greedy decode: Speech2TextTransducer (fused_conv) decodes the 8 x 15 s
   serving traffic on the card; its RTF is printed, and the encode must
   launch 24 K2, 12 K3 and 12 K6, K6 on its bf16 forward (12 glu and 12
   out launches by the host counts, no other counted kernel).

12. The default ASRConfig's fp32 launches and the WMMA ones at rates 0 and
   0.1 at the flagship train shape (run after phase 7): K2 fp32 (the
   register-tiled GEMM launches ffn_f32::hidden_kernel and out_kernel
   forward, rows_kernel, dx_kernel and dw_kernel backward; N 64 x T', D
   256, d_ff 2048: the default ASRConfig's widths), K3 fp32 (the register
   micro-tile kernels rel_f32::fwd_kernel, dkv_kernel, dq_kernel; B 64, H
   4, T', Dh 64) and K3 bf16 at Dh 128 (the WMMA rel_flash_fwd_kernel,
   rel_flash_dkv_kernel, rel_flash_dq_kernel; B 64, H 2, T'), each
   direction against its plain version with the same seed (fp32 within
   1e-4, bf16 within 2e-2 of max |ref| per output and gradient); the
   dropout and rate-0 instantiations by the host counts, each launch's
   device time at 0.1 beside 0 and its bound (K2's also its share of it,
   its registers, local bytes and blocks per SM); each direction timed
   beside its plain version (K2 also beside the eager fp32 composition it
   replaces, F.linear -> F.silu -> F.dropout -> F.linear; K3 beside SDPA
   over the precomputed bias). Then K4's fp32 route (ctc_head_f32's
   lse_kernel, the fp32 gather forward, rows_kernel, dx_kernel and
   dw_kernel backward, on the fp32 GEMM mainloop; B 64, T', D 256, V 5000)
   against its plain version within 1e-4 both ways; the five launches by
   host counts and profiler names (the first versions' ctc_head_fwd_kernel,
   ctc_head_dx_kernel and ctc_head_dw_kernel absent) with the library's
   plan, each launch's device time, bound, registers, shared bytes and
   blocks per SM; each direction timed beside its plain version, its fp32
   bound and the eager fp32 composition of its function (F.linear ->
   log_softmax -> gather; autograd's backward), F.ctc_loss over a
   log-softmax of the same projection (K4 and K1) as a note, and what one
   backward call adds to peak memory.
13. The default ASRConfig() (fp32 compute, dropout 0.1, d_ff 2048, 12 x
   256, 6-block decoder, SpecAug on, seeded random weights) through
   make_train_step with Adam at constant lr 1e-3 on phase 5's traffic: one
   warm-up step and 5 timed steps (3 if 7 steps at the warm-up's time would
   pass 60 s); losses and grad norms finite, nothing skipped, the loss
   falls, and per step exactly 24 K2 and 12 K3 launches each way (all fp32
   launches with dropout) and 1 of K4 (its fp32 route, by the host
   counts) and K1 (the warp route) each
   way; step seconds, audio-s/s, busy ms of one profiled step and peak
   memory printed, and the time phases 12 and 13 add.
14. ASRConfig(fused_conv=True) (phase 13's config with its conv modules
   on K6's fp32 route) the same way, one warm-up and 5 timed steps:
   losses finite, nothing skipped, the loss falls, per step exactly 24 K2,
   12 K3 and 12 K6 launches each way and 1 K4 (fp32) and 1 K1 (warp route)
   each way, K6 on conv_f32's launches only by the host counts (no bf16
   one); step seconds, audio-s/s, busy ms and peak memory printed beside
   phase 13's, with what one K6 backward call holds in scratch.
15. The flagship through the port's own CLIs: a synthetic corpus of 128
   train and 16 dev utterances of 15 s (data/mini_corpus.py's tones under
   noise, ~64 char tokens each) under the gitignored build/;
   bin/asr_train trains flagship_config() at dropout 0.1 with SpecAug on
   (Adam at a constant 1e-3, sorted batches of 64) for 2 epochs, then a
   second call with max_epoch 3 resumes from epoch 2; bin/asr_inference
   decodes 8 dev utterances (beam 10, ctc_weight 0.3, max_len 96) from
   valid.loss.ave_3best. Fails unless reporter.json holds 3 epochs of
   finite losses with nothing skipped, the epoch checkpoints, latest.json
   and the averages exist, every train step makes exactly 24 K2 and 12 K3
   launches each way and 1 K4 and 1 K1 each way (the wrappers' counts, and
   by the host counts the dropout instances of K2 and K3, K4's bf16 route
   and K1's warp route), the decode's launches are phase 3's an encode,
   K4 (both dtypes) and K1 at this corpus's V and S (the first batch's
   int32 labels) hold to their plain versions within phase 4's tolerances,
   and score.txt has WER, CER and RTF. Then one epoch of 1024 train
   utterances (16 steps) through bin/asr_train, each step's launches held
   the same way. Prints each epoch's step_time and iter_time from the
   reporter, the CLI's audio-s/s beside phase 5's make_train_step, the
   16-step epoch's host wait and host time per step after its first and
   its audio-s/s over them, the CLI decode's RTF beside phase 3's, and the
   phase's seconds.
16. The flagship's own recipe through recipe/asr_pipeline.py:run_pipeline
   on the card, stages 1-15: conf/train_ls100_conformer.yaml loaded as
   written (12 x 256, 6 decoder blocks, bf16, dropout 0.1, use_mvn global,
   warmuplr), with only exp_dir, the data dirs, char tokens, phase 15's
   sorted batches of 64 and max_epoch 2 overridden, on phase 15's corpus
   with speed perturbation 0.9 / 1.0 / 1.1. Fails unless stage 10's
   feats_stats.npz matches collect-stats over the same batches on the CPU
   (count exactly, sum and sum_square within STATS_TOL of max |ref|), the
   trained Speech2Text carries the stats, every train step makes phase
   15's launches (wrappers' and host counts), score.txt has WER and CER,
   and stage 15 decodes the unpacked model as the exp dir. Prints each
   stage's seconds, collect-stats' seconds and audio-s/s, and the phase's.
17. The transducer recipe through bin/asr_transducer_train and
   bin/asr_transducer_inference on the card: conf/train_transducer.yaml
   (12 x 256, a 1 x 256 LSTM, joint 256, auxiliary CTC 0.3, bf16, dropout
   0.1) with only the data dirs, char tokens, max_epoch 2, sorted batches
   of 32 and the port-only model.asr.fused_conv set on the command line;
   a second call with max_epoch 3 resumes; then one decode of the 8 dev
   utterances with each of greedy, alsa, default, maes, tsd and nsc at
   beam 5. Fails unless reporter.json holds 3 epochs of finite losses,
   every train step makes phase 9's launches of K2, K3, K5, K6 and the
   auxiliary CTC's K1 (wrappers' counts; K1's and K5's warp routes and
   K6's bf16 launches by the host counts), each search writes text and
   score.txt, and each beam search gives the same tokens and lengths, and
   scores within 1e-4, on the card and on the CPU from the same fp32
   encoder output (the trained weights in fp32 with the joint sharpened
   and blank's bias shifted so that the searches emit varied lengths, hs
   computed once on the card), with lengths strictly between 0 and
   max_len. Prints each search's
   decode wall, RTF and host syncs an utterance, and the phase's seconds.
18. The routed-MoE recipe and the interCTC options, on phase 15's corpus:
   (a) conf/train_moe.yaml (12 x 256, 8 experts on every 2nd block's
   second FFN, bf16, dropout 0.1, global MVN, warmuplr) through
   run_pipeline stages 1-15 with phase 16's overrides (no speed
   perturbation): every train step makes 18 K2 launches each way (the six
   routed FFNs are no K2 launch), 12 K3 and 1 K4 and K1 each way, by the
   wrappers' and the host counts; finite losses, loss_moe_aux in the
   reporter, the unpacked model decodes as the exp dir. (b) The same model
   (the reference's initialisation from a seed) through make_train_step
   on phase 5's traffic: those launches every step, step seconds,
   audio-s/s and peak memory (under MOE_PEAK_GB) beside phase 5's
   flagship. (c) The flagship with interCTC taps after blocks 3, 6 and 9
   (weight 0.3), without and with self-conditioning, on phase 5's
   traffic: per step 24 K2 and 12 K3 each way, and K4 / K1 4 / 4 each way
   without self-conditioning, 1 / 4 with it (the taps' CTC from the
   shared head's logits), by the wrappers' and the host counts; then
   phase 6's fp32 forward and backward card vs CPU for each. (d) The MoE
   layer in fp32, x [64, 468, 256] with ragged lengths, card vs CPU: the
   expert of every token and the kept count of every expert equal, the
   output within 1e-4 of max |ref|, with tokens dropped (a tilted
   router). (e) bin/asr_inference decodes the 8 dev utterances (beam 10,
   ctc 0.3, max_len 96) with the MoE recipe's model and with a
   self-conditioned flagship that bin/asr_train trained one epoch: the
   RTF of each; then, in fp32 from one card encode of MOE_CMP_UTT of
   them, the beam search on the card and on the CPU gives the same tokens
   and lengths on every row but proved near-ties, the card's choices and scores replayed on
   the CPU (search_parity). (f) remat_encoder with stochastic depth 0.1
   on the card (fp32, dropout 0.1): the loss and gradients equal the run
   without remat from an equally seeded generator on the card, which
   ends in the same state, and the recompute launches K2 and K3 forward
   twice a block. Prints the phase's seconds.
19. The fork's contextual biasing and KB-MBR (conf/train_mbr_kb.yaml), over
   KB_WORDS synthetic words in a suffix-marked token list, every train
   batch through slu/kb.py:TCPGenBatchAugmenter (kb_len 30, db_drop 0.3, a
   3-epoch ramp, as the reference's ablation_run.py:484-487): (a) the
   yaml's model (12 x 256, d_ff 2048, bf16, use_tcpgen with the gcn tree
   encoder, ctc 0.3, dropout 0.1, the pointer and gate losses at 1.0 and
   0.2) through make_train_step on phase 5's traffic with labels over the
   list: per step the flagship's launches (K2 24, K3 12, K4 and K1 1 each
   way; K1's warp route, K4's bf16 launches by the host counts), step
   seconds, audio-s/s and peak memory beside phase 5's, a profiled step's
   device busy ms, the augmenter's host ms a batch; (b) the same with the
   yaml's MBR term (weight 0.5, beam 4, pre-beam 12, max_len 96,
   rare_weight 0.5 over the list's tokens): its re-encode doubles K2 and K3
   each way (48 and 24), K4 and K1 stay 1; step seconds, busy ms, peak and
   the n-best search's share; (c) fp32 card against CPU at phase 6's short
   batch: the TCPGen loss, its stats (1e-4 relative; the CPU's loss_ptr,
   loss_gate and p_gen_bias above 0) and gradients (1e-3 of max |ref|) for
   each tree encoder (gcn at the yaml's depth, gat, sage and treelstm on 2
   encoder blocks), the same with the KB-MBR term, and the biased beam
   search (beam 10, ctc 0.3) from one card encode in both boundary
   conventions and with force_p_gen: tokens and lengths equal but on proved
   near-ties, the card's choices and scores replayed on the CPU
   (search_parity); (d) transducer_flagship_config() with use_tcpgen and
   fused_conv on phase 9's traffic (V 600, a list over its pieces): phase
   9's launches (K2 24, K3 12, K6 12, K5 and K1 1 each way; K5 and K1 on
   their warp routes, K6 on its bf16 launches), step seconds, busy ms and
   peak memory against the plain transducer's (PERF.md §5); (e) Speech2Text
   on the yaml's model decodes the serving traffic with and without the
   1,000-word biasing list: each encode K2 24, K3 12, nothing else counted,
   and the RTF of each; (f) conf/train_mbr_kb.yaml as written through
   bin/asr_train on phase 15's corpus (32 train utterances: two steps at
   its batch_bins), only exp_dir, the data dirs, init_params_from (phase
   15's n-best average) and max_epoch 1 overridden: every step (b)'s
   launches, finite loss_mbr and mbr_expected_risk in reporter.json.
20. Two-pass SLU with the BERT postdecoder (conf/train_slu_tcpgen_gcn.yaml:
   12 x 256, d_ff 2048, 6 decoder blocks, bf16, dropout 0.1, BERT 4 x d_ff
   1024 over the transcript, 2 deliberation blocks over the fused memory)
   on a synthetic SLURP-entity corpus (SLU_TRAIN + SLU_DEV utterances of
   1.5-6 s, 3-20 words over SLU_WORDS words, in
   recipe/prepare_slurp.py:format_text's layout): (a) the yaml's model
   (the reference's init from a seed) through make_train_step on the
   first batch of the yaml's numel sampler (batch_bins 8,000,000): per
   step K2 24, K3 12 and K1 1 each way by the wrappers' and the host
   counts, K4, K5 and K6 none; step seconds, audio-s/s, peak memory and a
   profiled step's busy ms; (b) its fp32 step card against CPU on phase
   6's short batch with transcripts of 8 and 3 words (loss and stats
   1e-4 relative, gradients 1e-3 of max |ref|); (c) the yaml as written
   through bin/slu_train (exp_dir, the data dirs and max_epoch 1
   overridden; at least two steps, each with (a)'s launches), then
   bin/slu_inference with GT transcripts, with a first pass (a flagship
   that bin/asr_train trains one epoch on the transcripts, beam 5) and
   with dialogue history: score.txt written, every encode K2 24 and K3
   12, the RTF and the host syncs an utterance of each; (d)
   recipe/slu_pipeline.py:run_slu_pipeline stages 1-13 with the yaml.
21. The language models and shallow fusion (conf/decode.yaml's lm_weight
   0.3): (a) LMConfig() (a 16 x 512 Transformer LM, 8 heads, d_ff 2048,
   fp32) over the flagship's 5,000-token list through bin/lm_train on a
   synthetic text (LM_TRAIN lines of up to 127 words, B 32, 2 epochs):
   finite, falling loss, bin/lm_calc_perplexity, timed steps (step
   seconds, tokens/s, peak MB) and one step card vs CPU (loss 1e-5
   relative, gradients 1e-4 of max |ref|); (b) the same step of a 2 x 512
   LSTM LM card vs CPU; (c) phase 3's Speech2Text and traffic with no LM,
   with (a)'s LM at 0.3, with the stage-9 trigram added at 0.3 and with
   ILM 0.1 added: each decode's RTF beside the no-LM one, each encode K2
   24 and K3 12 and the same kernel instances as the no-LM decode by the
   host counts; the fused fp32 search from one card encode replayed on the
   CPU (2 utterances, max_len 32, search_parity); (d) run_pipeline stages
   1-13 with train_lm and train_ngram on a small cli_split corpus, then
   bin/asr_inference with --lm_exp_dir and --ngram_file; (e) one
   LookAhead, one MultiLevel and one TCPGen decode with the selection LM
   on a small fp32 model, card vs CPU (search_parity).
22. KA2G slot-value generation (recipe/ka2g_run.py's model as written:
   Conformer 6 x 144, 4 heads, so Dh 36, d_ff 576, kernel 15, bf16,
   dropout 0.1, CTC weight 1, utterance MVN, SpecAug; the generator 5
   slots x 144, 2 blocks, d_ff 576, values of 2 words; B 48) on the
   recipe's own synthetic corpus (make_ka2g_corpus, 240 + 48 + 50
   utterances of ~1 s): (a) the nokb and the tcpgen arm two epochs each
   through tasks/generic.py:run_training over a data/resident.py
   ResidentCorpus: every step K3 6 (its Dh-64 instances: Dh 36
   zero-padded), K4 1 and K1 1 each way by the wrappers' and the host
   counts, K2 none (D2 144 is no bf16 K2 width); the last epoch's pace,
   audio-s/s, peak memory, a profiled step's busy ms; K3 at (a)'s shape
   (B 48, H 4, T', Dh 36) through the wrapper against its plain version
   both ways in fp32 and bf16 at rates 0 and 0.1, each by the host
   counts at the Dh-64 instances, timed beside the plain version, SDPA at
   Dh 36 and the bound; (b) the model's fp32 step card against CPU with
   TCPGen on the forest (loss and stats 1e-4 relative, gradients 1e-3 of
   max |ref|) and generate() with and without the forest (the same
   values); (c) the recipe's CLI end to end (one epoch an arm):
   results.json and RESULTS_KA2G.md written, main's return code printed
   and not judged; (d) ASRTask with data.resident_corpus: an epoch's
   batches equal to the host pipeline's, then ASRTask.train one epoch.
23. The remaining ASR decoders at conf/train_streaming.yaml's full width
   (12 x 256, chunk 40 / left 1, global MVN over the phase's own streams,
   bf16, random weights), on 4 synthetic 15 s streams fed 8192 samples a
   call: (a) decode/incremental.py's frames against the full chunked
   encode (bf16 2e-2, fp32 1e-4 of max |ref|), fp32 card vs CPU, an
   incremental step's launches (K2 24, K3 12 by the wrappers' and host
   counts), K3's window widths 40 / 80 / 120 and the ms a step; (b)
   bin/asr_inference_streaming with and without --incremental (RTF, ms a
   call: median, first, last; the fp32 modes' texts equal); (c)
   transducer_flagship_config() chunked with fused_conv through
   StreamingTransducerRecognizer on a stream's first 5 s (a re-encode's
   K6 12 in its causal bf16 form; the fp32 ALSA final equal to the
   non-streaming decode); (d) the
   time-sync and lattice decodes (with LMConfig() and a trigram too) on 8
   x 15 s at beam 10 (RTF), fp32 card vs CPU; (e) bin/asr_align card vs
   CPU; (f) the flagship with model_arch: maskctc through bin/asr_train
   (K1 1, K2 24, K3 12 each way a step, K4 0) and
   bin/asr_inference_maskctc, its fp32 step card vs CPU; K3 at B 1, T 40
   / 80 / 120 with chunk (40, 1) and K6's causal bf16 forward at B 1
   against their plain versions.
24. The remaining encoders and decoders: (a) the E-Branchformer at the
   flagship's widths (cgMLP 2048, bf16, dropout 0.1, SpecAug) through
   make_train_step on 64 x 15 s, U 64 (a warm-up, 3 timed steps, a
   profiled one: step s, audio-s/s, peak MB, busy ms; a step K2 24, K3 12,
   K4 1, K1 1 each way by the wrappers' counts, K1's warp route and K4's
   bf16 launches by the host counts, nothing else), Speech2Text serving 8
   x 15 s at beam 10 (RTF; K2 24, K3 12 an encode, nothing else), its fp32
   step at 2 blocks card vs CPU; (b) the contextual-block Conformer (12 x
   256, block 40 / hop 16 / look-ahead 16) one step on 16 x 15 s (K2 24
   each way, K3 0: its blocks' attention is eager) and one encode of 8 x
   15 s (K2 24), its fp32 step at 2 blocks card vs CPU; (c) vgg_rnn with
   the LAS decoder and rnn with the dynamic 2-D conv decoder (320 units,
   4 layers) one step each on 8 x 5 s (K4 1, K1 1 each way, no K2 or K3),
   a greedy and a beam-10 decode each; the Sinc (sliding-window frames),
   linear and BERT pre- / post-encoders around a 2-block Conformer, one
   step each; each one's fp32 step card vs CPU (2 layers / blocks; VGG2L's
   max-pool near-ties zeroed like the ReLU kinks); (d) every K2 / K3 call
   of one (a) train forward (forward against the plain version, the
   backward launches against the plain backward at the kernels' rounding
   points, the bf16 K3 backward element by element within
   k3_bwd_rounding_bounds as in phase 25) and of one (a) encode, on the
   recorded inputs and seeds.
25. The SSL models: (a) the flagship's CTC head and 6-block decoder over
   the wav2vec2-base encoder (7 x 512 convs, 12 x 768, bf16, attention
   dropout 0.1) through make_train_step on 16 x 15 s, U 64 (step s,
   audio-s/s, peak MB, busy ms, device ms by kernel; a step K4 1, K1 1
   each way, K2 and K3 none), K4 at D 768 (both dtypes) and K1 at its
   batch against their plain versions, Speech2Text serving 8 x 15 s at
   beam 10 (RTF; no counted launch), its fp32 step at 2 wav2vec2 blocks
   card vs CPU; (b) bin/ssl_dump at base width (--layer -1: [749, 13,
   768] an utterance) of 40 x 15 s, bin/asr_train with feats_type ssl
   and ssl_num_layers 13 on the flagship's Conformer (a step K2 24, K3
   12, K4 1, K1 1 each way), bin/asr_inference from feats.scp, K4 and K1
   at its first batch against their plain versions; (c) bin/hubert_train
   with HubertConfig() (fp32) on 3 x 64 x 15 s with km ids (a step K2
   12, K3 6 each way), its fp32 step at 2 blocks card vs CPU; (d) a
   Wav2Vec2PretrainModel step at base width (bf16) on 8 x 15 s, no
   counted launch, the fp32 objective at a small width card vs CPU at
   given draws; then every K2 / K3 call of one train forward of (b)'s
   and (c)'s models against its plain version both ways.

The line before the last is the ``{"kernels": [...]}`` JSON (K2's and
K3's entries carry phase 7's ``dropout`` record, with phase 12's Dh-128
pair in it; their launches are those of phase 5's run at dropout 0.1;
every entry whose timed instance a default-ASRConfig step runs also
carries its launches a default step: not the bf16-timed K2, K3 and K4
entries, whose default-step launches go to their fp32 routes), then
phase 12's fp32 entries (``*_fp32``), whose launches are those of phase
13's timed steps, then phase 8's K6 fp32 entries
(``fused_conv_module*_fp32``), whose launches are those of phase 14's
timed steps. The bf16 entries also carry their launches a train step of
phase 16 (``launches_per_recipe_step``) and of phase 17
(``launches_per_transducer_cli_step``) where those steps launch them, and
the K1-K4 entries their launches a step of phase 18's MoE model
(``launches_per_moe_step``) and of its interCTC models
(``launches_per_interctc_step``: ``interctc`` and ``self-conditioning``),
and of phase 19's TCPGen and KB-MBR steps (``launches_per_tcpgen_step``,
``launches_per_mbr_step``); the entries of K1, K2, K3, K5 and K6 their
launches a step of phase 19's KB-aware transducer
(``launches_per_kb_transducer_step``), and the K1-K3 entries their
launches a step of phase 20's SLU model (``launches_per_slu_step``), and
the K2 and K3 entries their launches in phase 21's LM-fused decode
(``launches_per_lm_decode``), and every bf16 entry its launches a step of
phase 22's KA2G model (``launches_per_ka2g_step``); then phase 22's K3
entries at Dh 36 (``rel_flash_attention_dh36``,
``rel_flash_attention_bwd_dh36``), whose launches are those of phase 22
(a)'s runs. Every counted entry also carries its launches an incremental
step of phase 23 (a) (``launches_per_stream_step``), a re-encode of its
streaming transducer (``launches_per_stream_transducer_encode``) and a
MaskCTC step of (f) (``launches_per_maskctc_step``), and its launches a
step of phase 24's E-Branchformer (``launches_per_ebranchformer_step``),
an encode of it (``launches_per_ebranchformer_encode``), a step of the
contextual block (``launches_per_contextual_block_step``) and of the
VGG-RNN model (``launches_per_vgg_rnn_step``), and its launches a step of
phase 25's wav2vec2 ASR model (``launches_per_wav2vec2_step``), a decode
by it (``launches_per_wav2vec2_decode``), a step of the SSL-feature
Conformer (``launches_per_ssl_conformer_step``), of HuBERT
(``launches_per_hubert_step``, on the fp32 entries: it computes in fp32)
and of the pretraining objective
(``launches_per_wav2vec2_pretrain_step``). The whole run's seconds and
each phase's are printed before the kernels. The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

# Traffic of bench.py:128-133.
N_UTT, UTT_SECONDS, FS = 8, 15, 16000
BEAM, CTC_WEIGHT, MAX_LEN = 10, 0.3, 96  # pre-beam: Speech2Text's 30
# Traffic of the flagship train step, bench.py:43-51.
TRAIN_B, TRAIN_SECONDS, TRAIN_U, TRAIN_STEPS = 64, 15, 64, 5
# Traffic of the transducer train step (the shape at which PERF_NOTES.md:
# 116-123 timed the reference's transducer): 32 x 15 s, U 64.
TR_B, TR_U = 32, 64
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3, and
# fp32 outside the tensor cores (the CTC lattice, whose operands are fp32).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# The bf16 backward passes of K2, K3 and K4 and the bf16 forward of K2
# against fused_ffn_bwd_plain, rel_flash_attention_bwd_plain,
# fused_ctc_head_emit_bwd_plain and fused_ffn_plain, which round hd and ds
# (K2), P, ds and rawg (K3), dlg (K4) and hd (K2's forward) where the
# kernels do: only fp32 summation order differs, and it
# can move a bf16 output by one unit in the last place (2^-8 to 2^-7 of
# itself). At the two train shapes K2's check saw at most 5.0e-3 of max
# |ref| on an H100 80GB HBM3; the bound keeps a 2x margin over that and
# stays above one unit (7.8e-3).
BWD_PLAIN_TOL = 1e-2
# K3's bf16 forward at Dh 64, by its kernel's name in torch.profiler.
FWD_KERNEL = {"fwd": "rel_fwd::fwd_kernel"}
# The recipes' dropout (conf/train_ls100_conformer.yaml:14,
# conf/train_transducer.yaml:15) and a fixed seed for the kernel checks.
DROPOUT, DROPOUT_SEED = 0.1, 20241017
# Philox4x32-10 answer vectors of Random123 (counter, key, output).
PHILOX_KAT = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(torch, fn, warmup=3, reps=25) -> float:
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
    return float(np.median(times))


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def att_bounds(b, h, t, dh, pairs, esize, peak):
    """Bounds (ms, by) of K3's forward, dkv and dq launches and of its
    backward: the products over the visible (query, key) pairs against
    each launch's compulsory bytes, operands in ``esize`` bytes (lse,
    delta and dkv's dp in fp32). Forward: q_u k^T, the skewed q_v p^T and
    P v; q_u, q_v, k, v, p, lengths in, out and lse out. dkv alone: S, dP,
    the skewed q_v p^T, dv, dk and dp; q_u, q_v, dO, k, v, p, lse, delta
    in, dk, dv, dp out. dq alone: S, dP, the skewed q_v p^T, dq_u, dq_v."""
    qkv, pt = b * h * t * dh, h * 2 * t * dh
    return {
        "fwd": bound(6.0 * pairs * dh, esize * (5 * qkv + pt) + 4 * b * h * t
                     + 4 * b, peak),
        "dkv": bound(12.0 * pairs * dh, esize * (5 * qkv + pt)
                     + 8 * b * h * t + esize * 2 * qkv + 4 * pt, peak),
        "dq": bound(10.0 * pairs * dh, esize * (5 * qkv + pt)
                    + 8 * b * h * t + esize * 2 * qkv, peak),
        "bwd": bound(16.0 * pairs * dh, esize * (6 * qkv + pt)
                     + 4 * b * h * t + esize * (4 * qkv + pt), peak),
    }


def ffn_bounds(n, d, f, d2, esize, peak=PEAK_BF16_FLOPS):
    """Bounds (ms, by) of K2's forward, its backward (dx, dW1, dW2, db1,
    db2 from x, g, W1, W2, b1: five products, D2 = D) and, for the fp32
    launches, dx alone (S, dh, dx) and dW alone (S, dh, dW1, dW2);
    operands in ``esize`` bytes, biases in fp32."""
    return {
        "fwd": bound(2.0 * n * f * (d + d2), esize * (n * d + n * d2 + d * f
                                                     + f * d2)
                     + 4 * (f + d2), peak),
        "bwd": bound(10.0 * n * d * f, esize * (3 * n * d + 4 * d * f)
                     + 4 * (2 * f + d), peak),
        "dx": bound(6.0 * n * d * f, esize * (3 * n * d + 2 * d * f) + 4 * f,
                    peak),
        "dw": bound(8.0 * n * d * f, esize * (2 * n * d + 4 * d * f)
                    + 4 * (2 * f + d), peak),
    }


def rel_err(out, ref):
    diff = (out.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def ffn_eager_ms(torch, args, g=None, rate=0.0, warmup=3, reps=25):
    """The eager composition K2 replaces, F.linear -> F.silu -> F.dropout
    -> F.linear (nn.Linear's weight layout), in x's dtype at dropout
    ``rate``: its forward's time (CUDA events; with autograd's graph when a
    cotangent g is given) and autograd's backward's (None without g)."""
    import torch.nn.functional as F
    x, w1, b1, w2, b2 = args
    leaves = [a.detach().clone().to(x.dtype).requires_grad_(g is not None)
              for a in (x, w1.t().contiguous(), b1, w2.t().contiguous(), b2)]
    eager = lambda: F.linear(F.dropout(F.silu(F.linear(
        leaves[0], leaves[1], leaves[2])), rate, training=True),
        leaves[3], leaves[4])
    fwd = median_ms(torch, eager, warmup=warmup, reps=reps)
    if g is None:
        return fwd, None
    y = eager()
    bwd = median_ms(torch, lambda: torch.autograd.grad(
        y, leaves, g, retain_graph=True), warmup=warmup, reps=reps)
    return fwd, bwd


def head_eager_ms(torch, args, g, warmup=3, reps=25):
    """The eager composition of K4's function, F.linear -> log_softmax (in
    fp32, as the model's unfused CTC branch) -> gather at ext, in hs's
    dtype with autograd's graph: its forward's time (CUDA events) and
    autograd's backward's to hs, W and the bias."""
    import torch.nn.functional as F
    hs, w, b, ext = args
    bsz, t, _ = hs.shape
    leaves = [a.detach().clone().to(hs.dtype).requires_grad_(True)
              for a in (hs, w, b)]
    idx = ext.long()[:, None, :].expand(bsz, t, -1)
    eager = lambda: F.log_softmax(F.linear(*leaves).float(), -1).gather(
        2, idx)
    fwd = median_ms(torch, eager, warmup=warmup, reps=reps)
    y = eager()
    bwd = median_ms(torch, lambda: torch.autograd.grad(
        y, leaves, g, retain_graph=True), warmup=warmup, reps=reps)
    return fwd, bwd


def check_ffn(torch, ffn, rows, d, f, gen):
    """K2 against its plain version in bf16 and fp32; returns bf16 inputs
    and the bf16 max abs error."""
    dev = "cuda"
    base = dict(x=torch.randn(rows, d, generator=gen, device=dev),
                w1=torch.randn(d, f, generator=gen, device=dev) * d ** -0.5,
                b1=torch.randn(f, generator=gen, device=dev) * 0.1,
                w2=torch.randn(f, d, generator=gen, device=dev) * f ** -0.5,
                b2=torch.randn(d, generator=gen, device=dev) * 0.1)
    err_bf16, args_bf16 = None, None
    for dt in (torch.bfloat16, torch.float32):
        args = (base["x"].to(dt), base["w1"].to(dt), base["b1"],
                base["w2"].to(dt), base["b2"])
        out = ffn.fused_ffn(*args)
        torch.cuda.synchronize()
        ref = ffn.fused_ffn_plain(*args)
        err, rel = rel_err(out, ref)
        name = str(dt).split(".")[-1]
        print(f"K2 fused_ffn {name} N={rows} D={d} F={f}: max abs err "
              f"{err:.3e}, {rel:.3e} of max|ref| (tolerance {TOL[name]})")
        if not rel <= TOL[name]:
            raise AssertionError(f"K2 {name} disagrees with its plain version")
        if dt == torch.bfloat16:
            err_bf16, args_bf16 = err, args
    return args_bf16, err_bf16


def check_attention(torch, fa, b, h, t, dh, gen):
    """K3 against its plain version (valid query rows, out and lse) in bf16
    and fp32, unchunked and chunked; returns the unchunked bf16 inputs and
    the bf16 max abs error."""
    dev = "cuda"
    lengths = torch.tensor([t - 29 * i for i in range(b)], dtype=torch.int32,
                           device=dev)
    base = [torch.randn(b, h, t, dh, generator=gen, device=dev) * 0.5
            for _ in range(4)]
    p = torch.randn(h, 2 * t, dh, generator=gen, device=dev) * 0.5
    p[:, -1] = 0.0
    valid = (torch.arange(t, device=dev)[None, :]
             < lengths[:, None].long())[:, None, :]  # [B, 1, T]
    scale = dh ** -0.5
    err_bf16, args_bf16 = 0.0, None
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        args = [x.to(dt) for x in base] + [p.to(dt), lengths]
        for cs, lc in ((0, -1), (16, 4)):
            out, lse = fa.rel_flash_attention_fwd(
                *args, scale=scale, chunk_size=cs, left_chunks=lc)
            torch.cuda.synchronize()
            ref, ref_lse = fa.rel_flash_attention_plain(
                *args, scale=scale, chunk_size=cs, left_chunks=lc)
            m = valid[..., None]
            err, rel = rel_err(torch.where(m, out, 0), torch.where(m, ref, 0))
            _, rel_lse = rel_err(torch.where(valid, lse, 0),
                                 torch.where(valid, ref_lse, 0))
            print(f"K3 rel_flash_attention {name} B={b} H={h} T={t} Dh={dh} "
                  f"chunk=({cs},{lc}): out max abs err {err:.3e}, "
                  f"{rel:.3e} of max|ref|; lse {rel_lse:.3e} (tolerance "
                  f"{TOL[name]})")
            if not (rel <= TOL[name] and rel_lse <= TOL[name]):
                raise AssertionError(
                    f"K3 {name} chunk=({cs},{lc}) disagrees with its plain "
                    f"version")
            if dt == torch.bfloat16 and cs == 0:
                err_bf16, args_bf16 = err, args
    return args_bf16, err_bf16, scale


def check_attention_fwd_tiled(torch, fa, args, what):
    """K3's bf16 forward (the register-resident kernel at Dh 32 / 64) on
    every row, fully masked ones included, unchunked and chunk 16 / left 4:
    out within BWD_PLAIN_TOL of max |ref| of rel_flash_attention_fwd_tiled
    _plain at the kernel's key tile (the same rounding points) and within
    TOL of rel_flash_attention_plain; lse within 1e-4 of max |ref| on rows
    with a visible key, the same rows fully masked. Returns the worst
    relative errors (tiled, plain)."""
    scale = args[0].shape[-1] ** -0.5
    worst = [0.0, 0.0]
    for cs, lc in ((0, -1), (16, 4)):
        kw = dict(scale=scale, chunk_size=cs, left_chunks=lc)
        out, lse = fa._launch_fwd(*args, scale, cs, lc)
        torch.cuda.synchronize()
        ref, ref_lse = fa.rel_flash_attention_fwd_tiled_plain(
            *args, block_k=fa.FWD_BLOCK_K, **kw)
        rel_t = rel_err(out, ref)[1]
        rel_p = rel_err(out, fa.rel_flash_attention_plain(*args, **kw)[0])[1]
        seen = ref_lse > 0.5 * fa.NEG
        rel_l = rel_err(lse[seen], ref_lse[seen])[1] if seen.any() else 0.0
        dead = int((~seen).sum().item())
        print(f"K3 rel_flash_attention bfloat16 {what} chunk=({cs},{lc}), "
              f"every row ({dead} fully masked): out {rel_t:.3e} of max|ref| "
              f"against rel_flash_attention_fwd_tiled_plain (tolerance "
              f"{BWD_PLAIN_TOL}), {rel_p:.3e} against "
              f"rel_flash_attention_plain (tolerance {TOL['bfloat16']}); lse "
              f"{rel_l:.3e} (tolerance 1e-4)")
        if not (torch.isfinite(out).all() and rel_t <= BWD_PLAIN_TOL
                and rel_p <= TOL["bfloat16"] and rel_l <= 1e-4
                and torch.equal(seen, lse > 0.5 * fa.NEG)):
            raise AssertionError(f"K3 bf16 forward {what} chunk=({cs},{lc}) "
                                 "disagrees with its plain versions")
        worst = [max(worst[0], rel_t), max(worst[1], rel_p)]
        del out, lse, ref, ref_lse
    return worst


def port_kernels_ms(torch, call, n=3, attempts=5, expect=(), complete=None):
    """torch.profiler's device time per launch of each of the port's
    kernels that call() launches, by name, over n calls after one
    unprofiled call. Averaged over the launches the profiler recorded: on
    the card it has been seen to drop some of a window's launches, all of
    one kernel's among them, and once all of a window's (a serving-shape K2
    forward of 0.045 ms), so the count of calls is no divisor and a window
    whose {name: ms} is not ``complete`` is profiled again, up to
    ``attempts`` windows. By default a window is complete when it holds a
    launch of the port and, for each part in ``expect``, a kernel whose
    name contains it."""
    if complete is None:
        complete = lambda got: bool(got) and all(
            any(part in name for name in got) for part in expect)
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        got = {e.key: e.self_device_time_total / 1e3 / e.count
               for e in prof.key_averages() if "espnet" in e.key and e.count}
        if complete(got):
            break
    return got


def instance_launches(torch, call):
    """{kernel instance: launches} that call() makes, by the library's
    host-side counts (build.launch_counts: each kernel by its name with its
    template arguments), with no profiler window."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    before = build.launch_counts()
    call()
    torch.cuda.synchronize()
    return build.launch_delta(before, build.launch_counts())


def ffn_fwd_detail(torch, ffn, args, what):
    """K2's bf16 forward at one shape: held to fused_ffn_plain (the kernel's
    rounding points) within BWD_PLAIN_TOL, launched as
    ffn_fwd::fwd_kernel<D2, false> once (the host counts; with
    ffn_fwd::reduce_kernel where F is split across blocks), then the launch
    alone timed (CUDA events) beside its device time (torch.profiler: the
    sum of its kernels' times a launch), the plain version's time and its
    bound. Returns a dict of those."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    x, w1, b1, w2, b2 = args
    (n, d), f, d2 = x.shape, w1.shape[1], w2.shape[1]
    call = lambda: ffn._launch_fwd(*args)
    out = call()
    torch.cuda.synchronize()
    rel = rel_err(out, ffn.fused_ffn_plain(*args))[1]
    splits = build.library().espnet_fused_ffn_fwd_splits(n, d, f, d2)
    launched = instance_launches(torch, call)
    want = {f"ffn_fwd::fwd_kernel<{d2}, false>": 1}
    if splits > 1:
        want["ffn_fwd::reduce_kernel"] = 1
    print(f"K2 fused_ffn bfloat16 N={n} {what}: {rel:.3e} of max|ref| "
          f"against fused_ffn_plain (tolerance {BWD_PLAIN_TOL}); F split "
          f"{splits} ways; kernels {launched}")
    if not (torch.isfinite(out).all() and rel <= BWD_PLAIN_TOL
            and launched == want):
        raise AssertionError(f"K2 bf16 forward N={n} disagrees with "
                             "fused_ffn_plain or took another kernel")
    per_kernel = port_kernels_ms(torch, call, n=5, expect=tuple(want))
    ms, dev = median_ms(torch, call), sum(per_kernel.values())
    plain = median_ms(torch, lambda: ffn.fused_ffn_plain(*args))
    bnd = ffn_bounds(n, d, f, d2, 2)["fwd"]
    print(f"K2 fused_ffn bfloat16 N={n} {what}: {ms:.4f} ms (launch "
          f"alone), device {dev:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})")
    return dict(ms=ms, device_ms=dev, plain_ms=plain, bound_ms=bnd[0],
                bound_by=bnd[1], max_rel_err=rel, splits=splits)


def route_cases(torch, args):
    """K3's bf16 Dh 64 inputs, the same in fp32, and in bf16 at Dh 128."""
    wide = [torch.cat([x, x], -1) for x in args[:4]] + [
        torch.cat([args[4], args[4]], -1), args[5]]
    return (("bfloat16 Dh 64", args),
            ("float32 Dh 64", [x.float() if x.is_floating_point() else x
                               for x in args]),
            ("bfloat16 Dh 128", wide))


def attention_fwd_routes(torch, fa, args):
    """Which kernel espnet_rel_flash_fwd launches (the host counts): bf16 at
    Dh 64 the register-resident rel_fwd::fwd_kernel, fp32 at Dh 64 the
    register micro-tile rel_f32::fwd_kernel, bf16 at Dh 128 the WMMA
    rel_flash_fwd_kernel, each once and alone."""
    want = ("rel_fwd::fwd_kernel<64, false>", "rel_f32::fwd_kernel<64, false>",
            "rel_flash_fwd_kernel<__nv_bfloat16, 64, 64, false>")
    for (what, xs), w in zip(route_cases(torch, args), want):
        got = instance_launches(torch, lambda: fa._launch_fwd(
            *xs, xs[0].shape[-1] ** -0.5, 0, -1))
        print(f"K3 forward route, {what}: {got}")
        if got != {w: 1}:
            raise AssertionError(f"K3 forward {what} did not launch {w}")


def attention_bwd_routes(torch, fa, args):
    """Which kernels espnet_rel_flash_bwd launches (the host counts): bf16
    at Dh 64 the register-resident rel_dkv::dkv_kernel and
    rel_dq::dq_kernel, fp32 at Dh 64 the register micro-tile
    rel_f32::dkv_kernel and dq_kernel, bf16 at Dh 128 the WMMA
    rel_flash_dkv_kernel and rel_flash_dq_kernel, each once and alone."""
    want = (("rel_dkv::dkv_kernel<64, false>", "rel_dq::dq_kernel<64, false>"),
            ("rel_f32::dkv_kernel<64, false>", "rel_f32::dq_kernel<64, false>"),
            ("rel_flash_dkv_kernel<__nv_bfloat16, 32, 32, false>",
             "rel_flash_dq_kernel<__nv_bfloat16, 32, 32, false>"))
    for (what, xs), w in zip(route_cases(torch, args), want):
        scale = xs[0].shape[-1] ** -0.5
        out, lse = fa._launch_fwd(*xs, scale, 0, -1)
        g = torch.ones_like(out)
        got = instance_launches(torch, lambda: fa._launch_bwd(
            *xs, out, lse, g, scale, 0, -1))
        print(f"K3 backward route, {what}: {got}")
        if got != dict.fromkeys(w, 1):
            raise AssertionError(f"K3 backward {what} did not launch {w}")
        del out, lse, g


def kernel_phase(torch, t_prime):
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.ops.kernels import ffn
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = flagship_config()
    d, f, h = cfg.d_model, cfg.d_ff, cfg.n_head
    dh = d // h
    rows = N_UTT * t_prime
    ffn_args, ffn_err = check_ffn(torch, ffn, rows, d, f, gen)
    att_args, att_err, scale = check_attention(torch, fa, N_UTT, h, t_prime,
                                               dh, gen)
    check_attention_fwd_tiled(torch, fa, att_args,
                              f"B={N_UTT} T={t_prime} (serving)")
    attention_fwd_routes(torch, fa, att_args)
    attention_bwd_routes(torch, fa, att_args)

    # K2: no single PyTorch call computes swish(x W1 + b1) W2 + b2; its
    # yardstick is the eager composition it replaces (no graph, as served).
    k2 = ffn_fwd_detail(torch, ffn, ffn_args, "(serving)")
    k2_eager_ms = ffn_eager_ms(torch, ffn_args)[0]
    print(f"K2 fused_ffn bfloat16 N={rows} (serving): eager composition "
          f"{k2_eager_ms:.4f} ms")

    # K3 timings; the yardstick is SDPA over a precomputed additive bias
    # (rel-shifted position scores + mask), the bias build not timed.
    q_u, q_v, k, v, p, lengths = att_args
    b, _, t, _ = q_u.shape
    # The launch alone, as at the train shape: at this size the wrapper's
    # host work (checks, autograd) outlasts the kernel. torch.profiler's
    # device time beside it.
    att_ms, att_device, _ = launch_detail(
        torch, lambda: fa._launch_fwd(*att_args, scale, 0, -1), FWD_KERNEL)
    att_plain_ms = median_ms(torch, lambda: fa.rel_flash_attention_plain(
        *att_args, scale=scale))
    raw = q_v.float() @ p[:, :2 * t - 1].float().transpose(-1, -2)
    bd = raw.gather(-1, fa.rel_shift_index(t, raw.device).expand(b, h, t, t))
    allowed = fa.allowed_mask(t, lengths)
    bias = torch.where(allowed, bd * scale, fa.NEG).to(q_u.dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = median_ms(torch, lambda: sdpa(q_u, k, v, attn_mask=bias,
                                           scale=scale))
    # (query, visible key) pairs; the mask broadcasts over the query axis
    # when there is no chunking.
    pairs = float(allowed.expand(b, 1, t, t).sum().item()) * h
    att_bound = att_bounds(b, h, t, dh, pairs, 2, PEAK_BF16_FLOPS)["fwd"]
    del raw, bd, bias
    return [
        dict(name="fused_ffn", route="cuda",
             source="espnet_slurp_tpu_torch/csrc/ffn.cu",
             replaces="espnet_slurp_tpu/ops/pallas/ffn.py:128",
             launches=None, max_abs_err=ffn_err, ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=k2_eager_ms,
             library_note="the eager bf16 composition F.linear -> F.silu "
                          "-> F.dropout -> F.linear at rate 0",
             device_ms=k2["device_ms"], f_splits=k2["splits"]),
        dict(name="rel_flash_attention", route="cuda",
             source="espnet_slurp_tpu_torch/csrc/flash_attention.cu",
             replaces="espnet_slurp_tpu/ops/pallas/flash_attention.py:280",
             launches=None, max_abs_err=att_err, ms=att_ms,
             plain_ms=att_plain_ms, bound_ms=att_bound[0],
             bound_by=att_bound[1], library_ms=lib_ms,
             device_ms=att_device.get("fwd")),
    ]


def philox_phase(torch, n, f, b, h, t):
    """csrc/philox.cuh on the card: Random123's answer vectors, then the
    keep mask the dropout launches draw, written out by the library's test
    entry, equal bit for bit to ops/kernels/philox.py's at K2's [N, F] and
    K3's [B * H, T, T]; the keep rate of the latter within 6 sigma of 1 -
    DROPOUT. Returns the keep rate."""
    from espnet_slurp_tpu_torch.ops.kernels import build, philox
    lib = build.library()
    ck = np.asarray([list(c) + list(k) for c, k, _ in PHILOX_KAT], np.uint32)
    ck_d = torch.from_numpy(ck.view(np.int32)).cuda()
    out = torch.empty(len(PHILOX_KAT), 4, dtype=torch.int32, device="cuda")
    build.check(lib.espnet_philox4x32_10(
        ck_d.data_ptr(), out.data_ptr(), len(PHILOX_KAT),
        build.stream_ptr(out)), "philox answer vectors")
    got = out.cpu().numpy().view(np.uint32)
    want = np.asarray([o for _, _, o in PHILOX_KAT], np.uint32)
    print("Philox4x32-10 answer vectors: " + "; ".join(
        " ".join(f"{v:08x}" for v in row) for row in got)
          + f" ({'match' if np.array_equal(got, want) else 'DIFFER'})")
    if not np.array_equal(got, want):
        raise AssertionError("csrc/philox.cuh misses Random123's answers")
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device="cuda")
    thr = philox.threshold(DROPOUT)
    rate = None
    for what, planes, rows, cols in (("K2 [N, F]", 1, n, f),
                                     ("K3 [B*H, T, T]", b * h, t, t)):
        dev = torch.empty(planes, rows, cols, dtype=torch.uint8,
                          device="cuda")
        build.check(lib.espnet_philox_keep_mask(
            seed.data_ptr(), thr, planes, rows, cols, dev.data_ptr(),
            build.stream_ptr(dev)), "philox keep mask")
        ref = philox.keep_mask(seed, DROPOUT, rows, cols, planes=planes)
        same = torch.equal(dev.bool(), ref)
        rate = float(ref.float().mean())
        sigma = ((1 - DROPOUT) * DROPOUT / ref.numel()) ** 0.5
        dev_sigma = (rate - 1 + DROPOUT) / sigma
        print(f"dropout mask {what} = [{planes}, {rows}, {cols}]: device "
              f"{'equals' if same else 'DIFFERS FROM'} ops/kernels/philox.py "
              f"bit for bit; keep rate {rate:.6f} ({dev_sigma:+.2f} sigma "
              f"from {1 - DROPOUT}; 16-bit draw: "
              f"{philox.keep_probability(DROPOUT):.7f})")
        if not (same and abs(rate - (1 - DROPOUT)) <= 6 * sigma):
            raise AssertionError(f"dropout mask {what}")
        del dev, ref
    return rate


def ffn_dropout_detail(torch, ffn, n, d, f, r):
    """K2's bf16 launches at rate DROPOUT on N rows: forward and backward
    held to fused_ffn_plain / fused_ffn_bwd_plain with the same seed (the
    kernels' rounding points) within BWD_PLAIN_TOL, and to the unrounded
    plain version (fp32, autograd) within TOL of max |ref| per output and
    gradient; the launches at both rates by the host counts (the dropout
    instantiations at DROPOUT); each launch's device time at DROPOUT
    beside rate 0. Returns a dict of those."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    bf = torch.bfloat16
    args = (r(n, d).to(bf), (r(d, f) * d ** -0.5).to(bf), r(f) * 0.1,
            (r(f, d) * f ** -0.5).to(bf), r(d) * 0.1)
    g = r(n, d).to(bf)
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device="cuda")
    x, w1, b1, w2, _ = args
    out = ffn._launch_fwd(*args, seed, DROPOUT)
    grads = ffn._launch_bwd(x, w1, b1, w2, g, seed, DROPOUT)
    at_rp = ffn.fused_ffn_plain(*args, seed, dropout_rate=DROPOUT)
    bwd_rp = ffn.fused_ffn_bwd_plain(x, w1, b1, w2, g, seed,
                                     dropout_rate=DROPOUT)
    leaves = [a.float().requires_grad_(True) for a in args]
    un = ffn.fused_ffn_plain(*leaves, seed, dropout_rate=DROPOUT)
    un_grads = torch.autograd.grad(un, leaves, g.float())
    torch.cuda.synchronize()
    names = ("out", "dx", "dw1", "db1", "dw2", "db2")
    rp = [rel_err(a, b)[1] for a, b in zip((out, *grads), (at_rp, *bwd_rp))]
    unr = [rel_err(a, b)[1] for a, b in zip((out, *grads),
                                            (un.detach(), *un_grads))]
    print(f"K2 fused_ffn bfloat16 N={n} dropout {DROPOUT}: against the "
          "plain versions at the kernels' rounding points "
          + ", ".join(f"{k} {v:.3e}" for k, v in zip(names, rp))
          + f" (tolerance {BWD_PLAIN_TOL}); against the unrounded plain "
          "version " + ", ".join(f"{k} {v:.3e}" for k, v in zip(names, unr))
          + f" of max|ref| (tolerance {TOL['bfloat16']})")
    if not (max(rp) <= BWD_PLAIN_TOL and max(unr) <= TOL["bfloat16"]
            and all(torch.isfinite(a).all() for a in (out, *grads))):
        raise AssertionError("K2 with dropout disagrees with its plain "
                             "versions")
    err = max(rel_err(a, b)[0] for a, b in zip((out, *grads),
                                               (un.detach(), *un_grads)))
    del at_rp, bwd_rp, un, un_grads, leaves, grads
    times = {}
    splits = build.library().espnet_fused_ffn_fwd_splits(n, d, f, d)
    for rate in (0.0, DROPOUT):
        sd = seed if rate else None
        flag = "true>" if rate else "false>"
        fwd_call = lambda: ffn._launch_fwd(*args, sd, rate)
        bwd_call = lambda: ffn._launch_bwd(x, w1, b1, w2, g, sd, rate)
        launched = instance_launches(torch, lambda: (fwd_call(), bwd_call()))
        want = {f"ffn_fwd::fwd_kernel<{d}, {flag}": 1,
                f"ffn_bwd::rows_kernel<{flag}": 1, "ffn_bwd::dx_kernel": 1,
                "ffn_bwd::dw_kernel": 1}
        if splits > 1:
            want["ffn_fwd::reduce_kernel"] = 1
        print(f"K2 fused_ffn bfloat16 N={n}: launches at rate {rate} "
              f"{launched}")
        if launched != want:
            raise AssertionError(f"K2 at rate {rate} launched {launched}, "
                                 f"expected {want}")
        fwd = port_kernels_ms(torch, fwd_call, n=5,
                              expect=(f"ffn_fwd::fwd_kernel<{d}, {flag}",))
        bwd = port_kernels_ms(torch, bwd_call, n=5, expect=(
            f"ffn_bwd::rows_kernel<{flag}", "ffn_bwd::dx_kernel",
            "ffn_bwd::dw_kernel"))
        times[rate] = {**fwd, **bwd}
    ms = {}
    for part in ("ffn_fwd::fwd_kernel", "ffn_bwd::rows_kernel",
                 "ffn_bwd::dx_kernel", "ffn_bwd::dw_kernel"):
        ms[part] = [sum(v for k, v in times[rate].items() if part in k)
                    for rate in (0.0, DROPOUT)]
    print(f"K2 fused_ffn bfloat16 N={n}: device ms a launch, rate 0 -> "
          f"{DROPOUT}: " + ", ".join(f"{k} {a:.4f} -> {b:.4f}"
                                      for k, (a, b) in ms.items()))
    return dict(max_abs_err=err, rounding_point_rel=max(rp),
                unrounded_rel=max(unr), device_ms_rate0_vs_dropout=ms)


def attention_dropout_detail(torch, fa, b, h, t, dh, r):
    """K3's bf16 launches at rate DROPOUT (B x H x T x Dh, ragged key
    lengths): the forward held to rel_flash_attention_fwd_tiled_plain and
    the backward to rel_flash_attention_bwd_plain with the same seed (the
    kernels' rounding points) within BWD_PLAIN_TOL, both to the unrounded
    plain version (fp32, autograd) within TOL of max |ref| per output and
    gradient, lse to the plain version's within 1e-4; the launches at both
    rates by the host counts (the dropout instantiations at DROPOUT); each
    launch's device time at DROPOUT beside rate 0. Returns a dict of
    those."""
    bf = torch.bfloat16
    lengths = torch.tensor([t - 3 * i for i in range(b)], dtype=torch.int32,
                           device="cuda")
    p = r(h, 2 * t, dh) * 0.5
    p[:, -1] = 0.0
    args = [(r(b, h, t, dh) * 0.5).to(bf) for _ in range(4)] + [p.to(bf),
                                                                lengths]
    g = r(b, h, t, dh).to(bf)
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device="cuda")
    scale = dh ** -0.5
    kw = dict(scale=scale, dropout_rate=DROPOUT)
    out, lse = fa._launch_fwd(*args, scale, 0, -1, seed, DROPOUT)
    grads = fa._launch_bwd(*args, out, lse, g, scale, 0, -1, seed, DROPOUT)
    at_rp, _ = fa.rel_flash_attention_fwd_tiled_plain(
        *args, seed, block_k=fa.FWD_BLOCK_K, **kw)
    bwd_rp = fa.rel_flash_attention_bwd_plain(*args, out, lse, g, seed, **kw)
    torch.cuda.synchronize()
    names = ("out", "dq_u", "dq_v", "dk", "dv", "dp")
    rp = [rel_err(a, b_)[1] for a, b_ in zip((out, *grads), (at_rp, *bwd_rp))]
    del at_rp, bwd_rp
    leaves = [a.float().requires_grad_(True) for a in args[:5]]
    un, un_lse = fa.rel_flash_attention_plain(*leaves, lengths, seed, **kw)
    un_grads = torch.autograd.grad(un, leaves, g.float())
    torch.cuda.synchronize()
    unr = [rel_err(a, b_)[1] for a, b_ in zip((out, *grads),
                                              (un.detach(), *un_grads))]
    rel_lse = rel_err(lse, un_lse)[1]
    print(f"K3 rel_flash_attention bfloat16 B={b} T={t} dropout {DROPOUT}: "
          "against the plain versions at the kernels' rounding points "
          + ", ".join(f"{k} {v:.3e}" for k, v in zip(names, rp))
          + f" (tolerance {BWD_PLAIN_TOL}); against the unrounded plain "
          "version " + ", ".join(f"{k} {v:.3e}" for k, v in zip(names, unr))
          + f" of max|ref| (tolerance {TOL['bfloat16']}); lse {rel_lse:.3e} "
          "(undropped; tolerance 1e-4)")
    if not (max(rp) <= BWD_PLAIN_TOL and max(unr) <= TOL["bfloat16"]
            and rel_lse <= 1e-4
            and all(torch.isfinite(a).all() for a in (out, *grads))):
        raise AssertionError("K3 with dropout disagrees with its plain "
                             "versions")
    err = max(rel_err(a, b_)[0] for a, b_ in zip((out, *grads),
                                                 (un.detach(), *un_grads)))
    del un, un_grads, leaves, grads
    times = {}
    for rate in (0.0, DROPOUT):
        sd = seed if rate else None
        flag = "true>" if rate else "false>"
        fwd_call = lambda: fa._launch_fwd(*args, scale, 0, -1, sd, rate)
        bwd_call = lambda: fa._launch_bwd(*args, out, lse, g, scale, 0, -1,
                                          sd, rate)
        launched = instance_launches(torch, lambda: (fwd_call(), bwd_call()))
        want = dict.fromkeys((f"rel_fwd::fwd_kernel<{dh}, {flag}",
                              f"rel_dkv::dkv_kernel<{dh}, {flag}",
                              f"rel_dq::dq_kernel<{dh}, {flag}"), 1)
        print(f"K3 rel_flash_attention bfloat16 B={b} T={t}: launches at "
              f"rate {rate} {launched}")
        if launched != want:
            raise AssertionError(f"K3 at rate {rate} launched {launched}, "
                                 f"expected {want}")
        fwd = port_kernels_ms(torch, fwd_call, n=5, expect=(
            f"rel_fwd::fwd_kernel<{dh}, {flag}",))
        bwd = port_kernels_ms(torch, bwd_call, n=5, expect=(
            f"rel_dkv::dkv_kernel<{dh}, {flag}",
            f"rel_dq::dq_kernel<{dh}, {flag}"))
        times[rate] = {**fwd, **bwd}
    ms = {}
    for part in ("rel_fwd::fwd_kernel", "rel_dkv::dkv_kernel",
                 "rel_dq::dq_kernel"):
        ms[part] = [sum(v for k, v in times[rate].items() if part in k)
                    for rate in (0.0, DROPOUT)]
    print(f"K3 rel_flash_attention bfloat16 B={b} T={t}: device ms a "
          f"launch, rate 0 -> {DROPOUT}: " + ", ".join(
              f"{k} {a:.4f} -> {b_:.4f}" for k, (a, b_) in ms.items()))
    return dict(max_abs_err=err, rounding_point_rel=max(rp),
                unrounded_rel=max(unr), device_ms_rate0_vs_dropout=ms)


# The route a d_model 512 / d_ff 2048 FeedForward takes by dtype: the bf16
# forward holds no output width of 512 in registers, the fp32 launches take
# any width.
ROUTES_512 = {"bfloat16": "eager", "float32": "K2"}


def ffn_route_phase(torch):
    """The K2 width route: a d_model 512 / d_ff 2048 FeedForward (the
    widths of bench.py's 17 x 512 config) on the card in bf16 and fp32,
    forward and backward, against the plain version of its function
    (fused_ffn_plain's autograd on the same weights) within TOL of max
    |ref|; the route each dtype took, read from K2's launch counter, is
    ROUTES_512's."""
    from espnet_slurp_tpu_torch.models.conformer import FeedForward
    from espnet_slurp_tpu_torch.ops.kernels import ffn
    torch.manual_seed(0)
    mod = FeedForward(512, 2048, use_flash=True).cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x0 = torch.randn(8, 200, 512, generator=gen, device="cuda")
    cot = torch.randn(8, 200, 512, generator=gen, device="cuda")
    routes = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        mod.zero_grad()
        x = x0.to(dt).requires_grad_(True)
        before = (ffn.fused_ffn.launches, ffn.fused_ffn.bwd_launches)
        out = mod(x)
        out.backward(cot.to(dt))
        torch.cuda.synchronize()
        moved = (ffn.fused_ffn.launches - before[0],
                 ffn.fused_ffn.bwd_launches - before[1])
        routes[name] = "K2" if moved == (1, 1) else (
            "eager" if moved == (0, 0) else f"mixed {moved}")
        w = [mod.w1.weight, mod.w1.bias, mod.w2.weight, mod.w2.bias]
        leaves = [x0.to(dt).requires_grad_(True)] + [
            p.detach().clone().requires_grad_(True) for p in w]
        ref = ffn.fused_ffn_plain(leaves[0], leaves[1].t().to(dt), leaves[2],
                                  leaves[3].t().to(dt), leaves[4])
        ref.backward(cot.to(dt))
        got = [x.grad] + [p.grad for p in w]
        ref_g = [a.grad for a in leaves]
        rels = [rel_err(out, ref)[1]] + [rel_err(a, b)[1]
                                         for a, b in zip(got, ref_g)]
        print(f"FeedForward d_model 512 d_ff 2048 {name}: route {routes[name]}"
              f" (K2 launches {moved}); out, dx, dW1, db1, dW2, db2 "
              + ", ".join(f"{v:.3e}" for v in rels)
              + f" of max|ref| (tolerance {TOL[name]})")
        if not (max(rels) <= TOL[name] and routes[name] == ROUTES_512[name]):
            raise AssertionError(f"FeedForward 512 {name}: route "
                                 f"{routes[name]}, expected "
                                 f"{ROUTES_512[name]}")
    return routes


def dropout_phase(torch, t_prime):
    """The dropout kernels at the flagship train shape (B 64, T' t_prime, D
    256, F 1024, H 4, Dh 64, bf16, DROPOUT): the Philox mask on the card,
    K2 and K3 both ways against their plain versions with the same seed,
    each launch's device time at DROPOUT beside rate 0; then the K2 width
    route. Returns the kernels-line additions by kernel name."""
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.ops.kernels import ffn
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

    cfg = flagship_config()
    d, f, h = cfg.d_model, cfg.d_ff, cfg.n_head
    b, n = TRAIN_B, TRAIN_B * t_prime
    keep_rate = philox_phase(torch, n, f, b, h, t_prime)
    gen = torch.Generator(device="cuda").manual_seed(4)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    k2 = ffn_dropout_detail(torch, ffn, n, d, f, r)
    k3 = attention_dropout_detail(torch, fa, b, h, t_prime, d // h, r)
    routes = ffn_route_phase(torch)
    fwd = lambda det, part: dict(
        rate=DROPOUT, keep_rate=keep_rate, max_abs_err=det["max_abs_err"],
        rel_err_rounding_points=det["rounding_point_rel"],
        rel_err_unrounded=det["unrounded_rel"],
        device_ms_rate0_vs_dropout={
            k: v for k, v in det["device_ms_rate0_vs_dropout"].items()
            if any(p in k for p in part)})
    return {
        "fused_ffn": {**fwd(k2, ("fwd_kernel",)),
                      "feedforward_512_routes": routes},
        "fused_ffn_bwd": fwd(k2, ("rows", "dx", "dw")),
        "rel_flash_attention": fwd(k3, ("rel_fwd",)),
        "rel_flash_attention_bwd": fwd(k3, ("rel_dkv", "rel_dq")),
    }


def token_list(vocab: int):
    return ["<blank>", "<unk>"] + [f"w{i}" for i in range(vocab - 3)] \
        + ["<sos/eos>"]


def slice_phase(torch, card):
    from espnet_slurp_tpu_torch.decode.beam import BeamSearchConfig
    from espnet_slurp_tpu_torch.models.asr_model import (ASRModel,
                                                          flagship_config)
    from espnet_slurp_tpu_torch.ops.kernels.ffn import fused_ffn
    from espnet_slurp_tpu_torch.ops.kernels.flash_attention import (
        rel_flash_attention_fwd)
    from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
    from espnet_slurp_tpu_torch.utils.params import init_random_

    cfg = flagship_config()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    state = init_random_(ASRModel(cfg32, device="cpu"), seed=0).state_dict()
    tokens = token_list(cfg.vocab_size)
    s2t = Speech2Text(cfg, state, tokens, token_type="word",
                      max_len=MAX_LEN, beam_size=BEAM, ctc_weight=CTC_WEIGHT,
                      device="cuda")
    rng = np.random.RandomState(0)
    speeches = [rng.randn(FS * UTT_SECONDS).astype(np.float32) * 0.1
                for _ in range(N_UTT)]
    t0 = time.perf_counter()
    s2t.decode_batch(speeches)  # warm-up: cuBLAS/cuDNN handles, allocator
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    fused_ffn.launches = 0
    rel_flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    texts = s2t.decode_batch(speeches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_ffn": fused_ffn.launches,
                "rel_flash_attention": rel_flash_attention_fwd.launches}
    print(f"slice: {N_UTT} x {UTT_SECONDS} s, beam {BEAM}, pre-beam "
          f"{BeamSearchConfig().pre_beam_size}, ctc {CTC_WEIGHT}, max_len {MAX_LEN}: wall {wall:.3f} s"
          f" (first call {warm_s:.3f} s), RTF {wall / (N_UTT * UTT_SECONDS):.5f}"
          f" on {card}; launches {launches}")
    n_blocks = cfg.num_encoder_blocks
    if launches != {"fused_ffn": 2 * n_blocks,
                    "rel_flash_attention": n_blocks}:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{2 * n_blocks} and {n_blocks} per encode")
    vocab = set(tokens) - {"<blank>", "<sos/eos>"}
    if len(texts) != N_UTT or not all(
            isinstance(x, str) and len(x.split()) <= MAX_LEN
            and set(x.split()) <= vocab for x in texts):
        raise AssertionError(f"malformed decode output: {texts!r:.500}")
    print(f"slice: hypothesis lengths {[len(x.split()) for x in texts]}")

    # fp32: the same weights on the CPU (plain versions) and on the card.
    short = [rng.randn(n).astype(np.float32) * 0.1 for n in (48000, 33600)]
    enc = {}
    for dev in ("cpu", "cuda"):
        model = ASRModel(cfg32, device=dev)
        model.load_state_dict(state)
        buf, lens = s2t.pad_batch(short)
        with torch.inference_mode():
            hs, hl = model.encode(torch.from_numpy(buf).to(dev),
                                  torch.from_numpy(lens).to(dev))
            lp = model.ctc_logprobs(hs)
        enc[dev] = (hs.cpu(), hl.cpu(), lp.cpu())
    (hs_c, hl_c, lp_c), (hs_g, hl_g, lp_g) = enc["cpu"], enc["cuda"]
    if not torch.equal(hl_c, hl_g):
        raise AssertionError("fp32 encode: lengths differ")
    for i in range(len(short)):
        n = int(hl_c[i])
        for name, a, b in (("hs", hs_g, hs_c), ("ctc_logprobs", lp_g, lp_c)):
            err, rel = rel_err(a[i, :n], b[i, :n])
            print(f"fp32 encode utt {i} ({n} frames) {name}: max abs err "
                  f"{err:.3e}, {rel:.3e} of max|ref| (tolerance 1e-3)")
            if not (torch.isfinite(a[i, :n]).all() and rel <= 1e-3):
                raise AssertionError(f"fp32 encode {name} card vs CPU")
    return launches, wall


def grad_case(torch, fn, args, cot, n_diff):
    """(output, grads of <output, cot> w.r.t. the first n_diff args, and a
    backward-only callable that re-runs that backward on the kept graph)."""
    leaves = [a.detach().clone().requires_grad_(i < n_diff)
              for i, a in enumerate(args)]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    diff = leaves[:n_diff]
    grads = torch.autograd.grad(out, diff, cot, retain_graph=True)
    again = lambda: torch.autograd.grad(out, diff, cot, retain_graph=True)
    return out.detach(), grads, again


def hold(torch, what, out, ref, grads, ref_grads, names, tol):
    """Output and every gradient within tol of max |ref|; returns the max
    abs error of the output and of the gradients."""
    torch.cuda.synchronize()
    err_out, rel_out = rel_err(out, ref)
    errs = [rel_err(a, r) for a, r in zip(grads, ref_grads)]
    detail = ", ".join(f"{n} {r:.3e}" for n, (_, r) in zip(names, errs))
    print(f"{what}: out {rel_out:.3e}; grads {detail} of max|ref| "
          f"(tolerance {tol})")
    if not (rel_out <= tol and all(r <= tol for _, r in errs)
            and all(torch.isfinite(g).all() for g in grads)):
        raise AssertionError(f"{what} disagrees with its plain version")
    return err_out, max(e for e, _ in errs)


def check_ffn_bwd(torch, ffn, n, d, f, r):
    """K2 forward and backward against its plain version in bf16 and fp32
    at N rows; returns the bf16 inputs and cotangent, the bf16 max abs
    gradient error and the plain version's backward on them."""
    base = (r(n, d), r(d, f) * d ** -0.5, r(f) * 0.1, r(f, d) * f ** -0.5,
            r(d) * 0.1)
    cot = r(n, d)
    for dt in (torch.float32, torch.bfloat16):
        args = (base[0].to(dt), base[1].to(dt), base[2], base[3].to(dt),
                base[4])
        o, g, _ = grad_case(torch, ffn.fused_ffn, args, cot.to(dt), 5)
        ro, rg, plain_bwd = grad_case(torch, ffn.fused_ffn_plain, args,
                                      cot.to(dt), 5)
        name = str(dt).split(".")[-1]
        _, err = hold(torch, f"K2 fused_ffn backward {name} N={n}", o, ro, g,
                      rg, ("dx", "dw1", "db1", "dw2", "db2"), TOL[name])
        del o, g, ro, rg
    x, w1, b1, w2, _ = args
    gb = cot.to(dt)
    outs = ffn._launch_bwd(x, w1, b1, w2, gb)
    refs = ffn.fused_ffn_bwd_plain(x, w1, b1, w2, gb)
    torch.cuda.synchronize()
    rels = [rel_err(a, b)[1] for a, b in zip(outs, refs)]
    print(f"K2 fused_ffn backward bfloat16 N={n} against fused_ffn_bwd_plain: "
          + ", ".join(f"{k} {v:.3e}" for k, v in zip(
              ("dx", "dw1", "db1", "dw2", "db2"), rels))
          + f" of max|ref| (tolerance {BWD_PLAIN_TOL})")
    if not max(rels) <= BWD_PLAIN_TOL:
        raise AssertionError("K2 bf16 backward disagrees with "
                             "fused_ffn_bwd_plain")
    del outs, refs
    return args, gb, err, plain_bwd


def launch_detail(torch, call, kernels):
    """call()'s time (CUDA events), the device time of each of its launches
    (port_kernels_ms over 5 calls; kernels maps a label to a part of the
    kernel's name) and what one call adds to peak memory, in MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    got = port_kernels_ms(torch, call, n=5, expect=tuple(kernels.values()))
    launch_ms = {}
    for name, ms in got.items():
        for label, part in kernels.items():
            if part in name:
                launch_ms[label] = ms
    if set(launch_ms) != set(kernels):
        print("the profiler showed no device time for "
              f"{sorted(set(kernels) - set(launch_ms))}")
    return median_ms(torch, call), launch_ms, peak_mb


def ffn_bwd_detail(torch, ffn, args, gb, n):
    """K2's bf16 backward at N rows: its time, each launch's device time
    (rows / dx / dW) and what one call adds to peak memory."""
    x, w1, b1, w2, _ = args
    ms, launch_ms, peak_mb = launch_detail(
        torch, lambda: ffn._launch_bwd(x, w1, b1, w2, gb),
        {p: f"ffn_bwd::{p}_kernel" for p in ("rows", "dx", "dw")})
    print(f"K2 fused_ffn backward bfloat16 N={n}: {ms:.4f} ms; launches rows "
          + " / ".join(f"{launch_ms.get(p, float('nan')):.4f}"
                       for p in ("rows", "dx", "dw"))
          + f" ms (rows / dx / dW, torch.profiler); one call adds "
            f"{peak_mb:.1f} MB at its peak")
    return ms, launch_ms, peak_mb


def check_attention_bwd(torch, fa, b, h, t, dh, r):
    """K3 forward and backward (unchunked and chunk 16 / left 4, ragged
    lengths) against its plain version in bf16 and fp32; returns the
    unchunked bf16 inputs and cotangent, its max abs gradient error and the
    plain version's backward on them."""
    lengths = torch.tensor([t - 3 * i for i in range(b)], dtype=torch.int32,
                           device="cuda")
    qkv = [r(b, h, t, dh) * 0.5 for _ in range(4)]
    p = r(h, 2 * t, dh) * 0.5
    p[:, -1] = 0.0
    cot = r(b, h, t, dh)
    scale = dh ** -0.5
    kept = None
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        args = [x.to(dt) for x in qkv] + [p.to(dt), lengths]
        for cs, lc in ((16, 4), (0, -1)):
            kw = dict(scale=scale, chunk_size=cs, left_chunks=lc)
            o, g, _ = grad_case(
                torch, lambda *a: fa.rel_flash_attention_fwd(*a, **kw), args,
                cot.to(dt), 5)
            ro, rg, plain_bwd = grad_case(
                torch, lambda *a: fa.rel_flash_attention_plain(*a, **kw),
                args, cot.to(dt), 5)
            _, err = hold(torch, f"K3 rel_flash_attention backward {name} "
                          f"B={b} T={t} chunk=({cs},{lc})", o, ro, g, rg,
                          ("dq_u", "dq_v", "dk", "dv", "dp"), TOL[name])
            del o, g, ro, rg
            if dt == torch.bfloat16 and cs == 0:
                kept = (args, cot.to(dt), err, plain_bwd)
            del plain_bwd
    return kept


def attention_bwd_detail(torch, fa, args, gb, b, t):
    """K3's bf16 backward at B x T': held to rel_flash_attention_bwd_plain
    (the kernels' rounding points) within BWD_PLAIN_TOL per output, then its
    time, each launch's device time (dkv / dq) and what one call adds to peak
    memory."""
    scale = args[0].shape[-1] ** -0.5
    out, lse = fa._launch_fwd(*args, scale, 0, -1)
    call = lambda: fa._launch_bwd(*args, out, lse, gb, scale, 0, -1)
    got = call()
    ref = fa.rel_flash_attention_bwd_plain(*args, out, lse, gb, scale=scale)
    torch.cuda.synchronize()
    rels = [rel_err(a, r)[1] for a, r in zip(got, ref)]
    print(f"K3 rel_flash_attention backward bfloat16 B={b} T={t} against "
          "rel_flash_attention_bwd_plain: " + ", ".join(
              f"{k} {v:.3e}" for k, v in zip(
                  ("dq_u", "dq_v", "dk", "dv", "dp"), rels))
          + f" of max|ref| (tolerance {BWD_PLAIN_TOL})")
    if not max(rels) <= BWD_PLAIN_TOL:
        raise AssertionError("K3 bf16 backward disagrees with "
                             "rel_flash_attention_bwd_plain")
    del got, ref
    ms, launch_ms, peak_mb = launch_detail(
        torch, call, {p: f"{p}_kernel" for p in ("dkv", "dq")})
    print(f"K3 rel_flash_attention backward bfloat16 B={b} T={t}: {ms:.4f} "
          "ms; launches dkv / dq " + " / ".join(
              f"{launch_ms.get(k, float('nan')):.4f}" for k in ("dkv", "dq"))
          + f" ms (torch.profiler); one call adds {peak_mb:.1f} MB at its "
            "peak")
    return ms, launch_ms, peak_mb


def ctc_head_bwd_detail(torch, kh, call, args, n):
    """K4's bf16 backward at the flagship train shape: held to
    fused_ctc_head_emit_bwd_plain (the kernels' rounding points) within
    BWD_PLAIN_TOL per output, launched as ctc_head_bwd's rows, dx and dw
    kernels once each (the host counts), then its time, each launch's device
    time and what one call adds to peak memory."""
    got = call()
    ref = kh.fused_ctc_head_emit_bwd_plain(*args)
    torch.cuda.synchronize()
    rels = [rel_err(a, r)[1] for a, r in zip(got, ref)]
    parts = ("rows", "dx", "dw")
    launched = instance_launches(torch, call)
    want = {f"ctc_head_bwd::{p}_kernel": 1 for p in parts}
    print(f"K4 fused_ctc_head_emit backward bfloat16 N={n} against "
          "fused_ctc_head_emit_bwd_plain: " + ", ".join(
              f"{k} {v:.3e}" for k, v in zip(("dhs", "dw", "db"), rels))
          + f" of max|ref| (tolerance {BWD_PLAIN_TOL}); kernels {launched}")
    if not (max(rels) <= BWD_PLAIN_TOL and launched == want):
        raise AssertionError("K4 bf16 backward disagrees with "
                             "fused_ctc_head_emit_bwd_plain or took another "
                             "kernel")
    del got, ref
    ms, launch_ms, peak_mb = launch_detail(
        torch, call, {p: f"ctc_head_bwd::{p}_kernel" for p in parts})
    print(f"K4 fused_ctc_head_emit backward bfloat16 N={n}: {ms:.4f} ms; "
          "launches rows / dx / dw " + " / ".join(
              f"{launch_ms.get(p, float('nan')):.4f}" for p in parts)
          + f" ms (torch.profiler); one call adds {peak_mb:.1f} MB at its "
            "peak")
    return ms, launch_ms, peak_mb


# K1's, K4's, K5's and K6's kernels by their host-side launch counts
# (csrc/common.cuh's counted: each name is also the kernel's profiler name).
K1_WARP = ("ctc_warp::fwd_kernel", "ctc_warp::bwd_kernel")
K1_BLOCK = ("ctc_block::fwd_kernel", "ctc_block::bwd_kernel")
# K5's routes (csrc/transducer.cu): one warp per utterance up to 256 states
# (U1), one block per utterance past it.
K5_WARP = ("rnnt_warp::fwd_kernel", "rnnt_warp::bwd_kernel")
K5_BLOCK = ("rnnt_block::fwd_kernel", "rnnt_block::bwd_kernel")
# tests/test_torch_cuda_kernels.py:test_rnnt_lattice's U1: within a warp,
# across its slots, the warp route's limit and past it.
K5_EDGE_U1 = (1, 2, 33, 65, 129, 256, 257, 300)
K4_BF16_LAUNCHES = {"ctc_head_bf16::lse_kernel": "fwd",
                    "ctc_head_fwd::gather_kernel<__nv_bfloat16>": "fwd",
                    "ctc_head_bwd::rows_kernel": "bwd",
                    "ctc_head_bwd::dx_kernel": "bwd",
                    "ctc_head_bwd::dw_kernel": "bwd"}
# K4's fp32 launches (csrc/ctc_head.cu: ctc_head_f32 on csrc/sgemm.cuh, and
# the gather), in the order of espnet_ctc_head_info's `which`, and their
# direction; the first versions' kernels, which must not launch.
K4_F32_LAUNCHES = {"ctc_head_f32::lse_kernel": "fwd",
                   "ctc_head_fwd::gather_kernel<float>": "fwd",
                   "ctc_head_f32::rows_kernel": "bwd",
                   "ctc_head_f32::dx_kernel": "bwd",
                   "ctc_head_f32::dw_kernel": "bwd"}
K4_GONE = ("ctc_head_fwd_kernel", "ctc_head_dx_kernel", "ctc_head_dw_kernel")
# K6's launches (csrc/conv_module.cu), each with its direction: bf16 in the
# order of espnet_conv_bf16_info's `which`, fp32 in that of
# espnet_conv_f32_info's; the first version's kernels (either dtype, by the
# names in the compiler's report), which must not be built.
K6_BF16_LAUNCHES = {"conv_bf16::glu_kernel": "fwd",
                    "conv_bf16::out_kernel": "fwd",
                    "conv_bf16::glu_sig_kernel": "bwd",
                    "conv_bf16::rows_kernel": "bwd",
                    "conv_bf16::du_kernel": "bwd",
                    "conv_bf16::dx_kernel": "bwd",
                    "conv_bf16::dw_kernel": "bwd",
                    "conv_bf16::sum_kernel": "bwd"}
K6_F32_LAUNCHES = {"conv_f32::glu_kernel": "fwd",
                   "conv_f32::norm_kernel": "fwd",
                   "conv_f32::out_kernel": "fwd",
                   "conv_f32::glu_sig_kernel": "bwd",
                   "conv_f32::dsw_kernel": "bwd",
                   "conv_f32::rows_kernel": "bwd",
                   "conv_f32::du_kernel": "bwd",
                   "conv_f32::dx_kernel": "bwd",
                   "conv_f32::dw_kernel": "bwd",
                   "conv_f32::sum_kernel": "bwd"}
K6_GONE = ("conv_fwd_kernel", "conv_bwd_rows_kernel", "conv_bwd_dw2_kernel",
           "conv_bwd_dw1_kernel", "conv_bwd_dx_kernel")
K6_BF16_FWD = tuple(k for k, w in K6_BF16_LAUNCHES.items() if w == "fwd")
ROUTED = (K1_WARP + K1_BLOCK + tuple(K4_BF16_LAUNCHES) + tuple(K4_F32_LAUNCHES)
          + tuple(K6_BF16_LAUNCHES) + tuple(K6_F32_LAUNCHES) + K5_WARP
          + K5_BLOCK)


def route_counts(names=ROUTED):
    """{kernel: launches so far} from the library's host-side counts."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    return {k: build.launch_count(k) for k in names}


def routes_of(call, names=ROUTED):
    """{kernel: launches} that call() makes, by the host-side counts."""
    before = route_counts(names)
    call()
    after = route_counts(names)
    return {k: after[k] - before[k] for k in names}


def check_routes(what, got, want_each, times=1, names=ROUTED):
    """Each kernel of want_each launched `times` times in got (want_each
    {kernel: int}: its count times `times`), the others of names none."""
    counts = isinstance(want_each, dict) and all(
        isinstance(v, int) for v in want_each.values())
    per = want_each if counts else dict.fromkeys(want_each, 1)
    want = {k: times * per.get(k, 0) for k in names}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")


def ctc_head_info(dtype):
    """{kernel: (registers, shared bytes, local bytes, blocks per SM)} of
    K4's five launches in dtype (0 float32, 1 bfloat16), from the built
    library."""
    import ctypes
    from espnet_slurp_tpu_torch.ops.kernels import build
    out = {}
    names = K4_F32_LAUNCHES if dtype == 0 else K4_BF16_LAUNCHES
    for which, k in enumerate(names):
        buf = (ctypes.c_int * 4)()
        build.check(build.library().espnet_ctc_head_info(dtype, which, buf),
                    "fused_ctc_head_emit kernel info")
        out[k] = tuple(buf)
    return out


def ctc_info(s):
    """{kernel: (registers, shared bytes, local bytes, blocks per SM)} of
    K1's forward and backward launches for S states."""
    import ctypes
    from espnet_slurp_tpu_torch.ops.kernels import build
    route = K1_WARP if s <= build.library().espnet_ctc_warp_states() \
        else K1_BLOCK
    out = {}
    for which, k in enumerate(route):
        buf = (ctypes.c_int * 4)()
        build.check(build.library().espnet_ctc_info(which, s, buf),
                    "ctc_lattice kernel info")
        out[k] = tuple(buf)
    return out


def k4_gone_check(torch, names):
    """The first versions' K4 kernels are not in the built library (the
    compiler's entry list) nor among the profiler's names."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    entries = [ln for ln in build.build_log().splitlines()
               if "Compiling entry" in ln]
    gone = sorted({x for x in K4_GONE for ln in entries if x in ln}
                  | {x for x in K4_GONE for n in names if x in n})
    if gone:
        raise AssertionError(f"K4's first-version kernels are still built "
                             f"or launched: {gone}")


def k6_gone_check(torch):
    """The first version's K6 kernels (either dtype) are not in the built
    library (the compiler's entry list)."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    gone = sorted({x for x in K6_GONE for ln in build.build_log().splitlines()
                   if "Compiling entry" in ln and x in ln})
    if gone:
        raise AssertionError(f"K6's first-version kernels are still built: "
                             f"{gone}")


def k6_info(d, k, fp32=False):
    """{kernel: (registers, shared bytes, local bytes, blocks per SM)} of
    K6's bf16 (or fp32) launches at width d and k taps, from the built
    library."""
    import torch
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    names = K6_F32_LAUNCHES if fp32 else K6_BF16_LAUNCHES
    dtype = torch.float32 if fp32 else torch.bfloat16
    return {name: kc.info(which, d, k, dtype)
            for which, name in enumerate(names)}


def bound2(products: float, fp32_ops: float, nbytes: float):
    """bound() for work of two types: the tensor-core products at the bf16
    peak plus the fp32 work (taps, elementwise) at the fp32 peak, counted
    apart and added, against the bytes."""
    t_ops = products / PEAK_BF16_FLOPS + fp32_ops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# K6's fp32 work a [row, channel] element beyond the products and taps:
# forward GLU (sigmoid as exp, add, reciprocal; product; mask) 5, LayerNorm
# 7, swish 4; backward those again and swish' 5, LayerNorm backward 9, the
# GLU backward 6, the column sums 5.
K6_ELEM_FWD, K6_ELEM_BWD = 16, 41


def k6_bounds(b, t, d, k, nsplit):
    """Bounds (ms, by) of K6's bf16 directions and launches at B x T rows,
    width d, k taps, dW in nsplit splits: products (bf16) and taps and
    elementwise work (fp32) counted apart (bound2); bytes as each reads and
    writes them, scratch included for a launch (g, sig, dc fp32; sw, du
    bf16; the partials fp32), only the function's inputs and outputs for a
    direction (x, lengths, the weights; out, or go in and dx and the
    gradients out)."""
    n = b * t
    tiles = b * -(-t // 32)
    nd, dd = n * d, d * d
    params = 4 * (2 * d + d * k + 4 * d)  # b1, wdw, bdw, gamma, beta, b2
    weights = 2 * 3 * dd
    grads = 2 * 3 * dd + 4 * (2 * d + d * k + 4 * d)
    taps = 2.0 * nd * k
    part = 4 * (tiles * (4 * d + d * k + 2 * d) + nsplit * 3 * dd)
    launches = {
        "conv_bf16::glu_kernel": bound2(4.0 * nd * d, 5.0 * nd,
                                        2 * nd + 4 * dd + 8 * d + 4 * b
                                        + 4 * nd),
        "conv_bf16::out_kernel": bound2(2.0 * nd * d, taps + 11.0 * nd,
                                        4 * nd + 2 * dd + params + 2 * nd),
        "conv_bf16::glu_sig_kernel": bound2(4.0 * nd * d, 5.0 * nd,
                                            2 * nd + 4 * dd + 8 * d + 4 * b
                                            + 8 * nd),
        "conv_bf16::rows_kernel": bound2(
            2.0 * nd * d, 2 * taps + 25.0 * nd,
            4 * nd + 2 * nd + 2 * dd + params + 4 * nd + 2 * nd
            + 4 * tiles * (4 * d + d * k)),
        "conv_bf16::du_kernel": bound2(0.0, taps + 11.0 * nd,
                                       12 * nd + 4 * d * k + 4 * b + 4 * nd
                                       + 4 * tiles * 2 * d),
        "conv_bf16::dx_kernel": bound2(4.0 * nd * d, 0.0,
                                       4 * nd + 4 * dd + 2 * nd),
        "conv_bf16::dw_kernel": bound2(6.0 * nd * d, 0.0,
                                       4 * nd + 2 * nd + 4 * nd
                                       + 4 * nsplit * 3 * dd),
        "conv_bf16::sum_kernel": bound2(0.0, part / 4, part + grads)}
    return {
        "fwd": bound2(6.0 * nd * d, taps + K6_ELEM_FWD * nd,
                      2 * nd + 4 * b + weights + params + 2 * nd),
        "bwd": bound2(16.0 * nd * d, 3 * taps + K6_ELEM_BWD * nd,
                      2 * nd + 4 * b + weights + params + 2 * nd + 2 * nd
                      + grads),
        "launches": launches}


def k6_f32_bounds(b, t, d, k, nsplit):
    """Bounds (ms, by) of K6's fp32 directions and launches at B x T rows,
    width d, k taps, dW in nsplit splits: all work (products, taps,
    elementwise) at the fp32 peak; bytes as each launch reads and writes
    them, scratch included (g, sig, sw, dsw then dc fp32 [N, D], du fp32
    [N, 2D], the partials), only the function's inputs and outputs for a
    direction (x, lengths, the weights; out, or go in and dx and the
    gradients out)."""
    n = b * t
    tiles = b * -(-t // 32)
    nd, dd = n * d, d * d
    params = 4 * (2 * d + d * k + 4 * d)  # b1, wdw, bdw, gamma, beta, b2
    taps = 2.0 * nd * k
    grads = 4 * 3 * dd + params
    ins = 4 * nd + 4 * b + 4 * 3 * dd + params
    part = 4 * (tiles * (3 * d + d * k + 2 * d) + nsplit * (3 * dd + d))
    w1_in = 8 * dd + 8 * d + 4 * b  # W1, b1, lengths
    fp32 = lambda ops, nbytes: bound(ops, nbytes, PEAK_FP32_FLOPS)
    launches = {
        "conv_f32::glu_kernel": fp32(4.0 * nd * d + 5.0 * nd,
                                     4 * nd + w1_in + 4 * nd),
        "conv_f32::norm_kernel": fp32(taps + 11.0 * nd,
                                      4 * nd + params + 4 * nd),
        "conv_f32::out_kernel": fp32(2.0 * nd * d,
                                     4 * nd + 4 * dd + 4 * d + 4 * nd),
        "conv_f32::glu_sig_kernel": fp32(4.0 * nd * d + 5.0 * nd,
                                         4 * nd + w1_in + 8 * nd),
        "conv_f32::dsw_kernel": fp32(2.0 * nd * d, 4 * nd + 4 * dd + 4 * nd),
        "conv_f32::rows_kernel": fp32(
            taps + 25.0 * nd,
            8 * nd + params + 8 * nd + 4 * tiles * 3 * d),
        "conv_f32::du_kernel": fp32(
            2 * taps + 11.0 * nd,
            12 * nd + 4 * d * k + 4 * b + 8 * nd
            + 4 * tiles * (2 * d + d * k)),
        "conv_f32::dx_kernel": fp32(4.0 * nd * d, 8 * nd + 8 * dd + 4 * nd),
        "conv_f32::dw_kernel": fp32(6.0 * nd * d + nd,
                                    20 * nd + 4 * nsplit * (3 * dd + d)),
        "conv_f32::sum_kernel": fp32(part / 4, part + grads)}
    return {
        "fwd": fp32(6.0 * nd * d + taps + K6_ELEM_FWD * nd, ins + 4 * nd),
        "bwd": fp32(16.0 * nd * d + 3 * taps + K6_ELEM_BWD * nd,
                    ins + 4 * nd + 4 * nd + grads),
        "launches": launches}


def launch_table(what, got, info, bounds):
    """{kernel: device ms, bound, registers, shared, local, blocks per SM}
    from profiler times `got` (by name part), printed."""
    out = {}
    for k in info:
        hit = [ms for name, ms in got.items() if k in name]
        if len(hit) != 1:
            raise AssertionError(f"{what}: {k} not timed: {sorted(got)}")
        regs, smem, local, blocks = info[k]
        bms, by = bounds[k]
        out[k] = dict(device_ms=hit[0], bound_ms=bms, bound_by=by,
                      registers=regs, smem_bytes=smem, local_bytes=local,
                      blocks_per_sm=blocks)
        print(f"{what} launch {k}: device {hit[0]:.4f} ms; bound {bms:.4f} "
              f"ms ({by}), {100 * bms / hit[0]:.1f}% of it; registers "
              f"{regs}, {smem} B of shared memory, local bytes {local}, "
              f"blocks per SM {blocks}")
    return out


def ctc_head_bf16_fwd_detail(torch, kh, args, b, t, d, v, s):
    """K4's bf16 forward at the flagship train shape: one call launches
    ctc_head_bf16::lse_kernel and the bf16 gather once each and no fp32 or
    first-version kernel (host counts; the first version absent from the
    build); each launch's device time (torch.profiler), bound, registers,
    shared bytes, spills and blocks per SM; the library's plan."""
    hs, w, bias, ext = args
    n = b * t
    call = lambda: kh._launch_fwd(hs, w, bias, ext)
    fwd = [k for k, p in K4_BF16_LAUNCHES.items() if p == "fwd"]
    check_routes("K4 bf16 forward", routes_of(call), fwd)
    plan = kh._plan(n, d, v, torch.bfloat16, hs.device)
    got = port_kernels_ms(torch, call, n=5, expect=tuple(fwd))
    k4_gone_check(torch, got)
    info = {k: x for k, x in ctc_head_info(1).items() if k in fwd}
    nsplit = plan[0]
    bounds = {
        fwd[0]: bound(2.0 * n * d * v,
                      2 * n * d + 2 * d * v + 4 * v + 8 * nsplit * n),
        fwd[1]: bound(2.0 * n * d * s,
                      2 * n * d + 2 * d * v + 4 * v + 4 * b * s
                      + 8 * nsplit * n + 4 * n * s + 4 * n, PEAK_FP32_FLOPS)}
    launches = launch_table("K4 bf16", got, info, bounds)
    dev = sum(x["device_ms"] for x in launches.values())
    print(f"K4 fused_ctc_head_emit bfloat16 B={b} T={t} V={v}: plan {plan} "
          f"(lse's V splits, dW splits); forward device {dev:.4f} ms")
    return dict(device_ms=dev, launch_detail=launches, plan=plan)


def ctc_lattice_detail(torch, kctc, largs, alpha, cot, b, t, s, fbound,
                       bbound, fwd_ms, bwd_ms):
    """K1 at the flagship train shape: the warp route's launches (host
    counts, once each way a call, no block launch), each direction's device
    time (torch.profiler), ms per frame beside the byte bound per frame,
    registers, shared bytes, spills and blocks per SM."""
    fwd = lambda: kctc._launch_fwd(*largs)
    bwd = lambda: kctc._launch_bwd(*largs, alpha, cot)
    check_routes("K1 forward and backward", routes_of(lambda: (fwd(), bwd())),
                 K1_WARP)
    got = port_kernels_ms(torch, lambda: (fwd(), bwd()), n=5, expect=K1_WARP)
    launches = launch_table("K1", got, ctc_info(s), {
        K1_WARP[0]: fbound, K1_WARP[1]: bbound})
    for (k, x), ms, bnd in zip(launches.items(), (fwd_ms, bwd_ms),
                               (fbound, bbound)):
        x["ms_per_frame"] = ms / t
        x["bound_ms_per_frame"] = bnd[0] / t
        print(f"K1 {k} at S {s}: {1e3 * ms / t:.4f} us a frame over T' {t} "
              f"(device {1e3 * x['device_ms'] / t:.4f}), byte bound "
              f"{1e3 * bnd[0] / t:.4f} us a frame")
    return launches


def ctc_lattice_block_route(torch, kctc, lp, gen, b, t, u):
    """K1 past the warp route's limit: U u labels (S = 2 u + 1 states) on
    the same log-probs, both ways against ctc_lattice_plain within
    TOL["float32"], launched as the block route (host counts), timed
    beside F.ctc_loss on the same log-probs and labels."""
    import torch.nn.functional as F
    v = lp.shape[-1]
    labels = torch.randint(1, v - 1, (b, u), generator=gen, device="cuda")
    ulen = torch.tensor([u - (i % 5) for i in range(b)], device="cuda")
    ext, skip, smax, last = kctc.extend_labels(labels, ulen)
    s = ext.shape[1]
    tlen = torch.tensor([t - 3 * i for i in range(b)], dtype=torch.int32,
                        device="cuda")
    emit = kctc.mask_emit(lp.gather(2, ext[:, None, :].expand(b, t, -1)),
                          smax).contiguous()
    cot = torch.rand(b, generator=gen, device="cuda")
    largs = (emit, skip, tlen, last)
    got = routes_of(lambda: grad_case(torch, kctc.ctc_lattice, largs, cot, 1))
    check_routes(f"K1 at S {s}", got, K1_BLOCK)
    o, g, _ = grad_case(torch, kctc.ctc_lattice, largs, cot, 1)
    ro, rg, _ = grad_case(torch, kctc.ctc_lattice_plain, largs, cot, 1)
    err_o, err_g = hold(torch, f"K1 ctc_lattice float32 B={b} T={t} S={s} "
                        "(block route)", o, ro, g, rg, ("demit",),
                        TOL["float32"])
    _, alpha = kctc._launch_fwd(*largs)
    fwd_ms = median_ms(torch, lambda: kctc._launch_fwd(*largs))
    bwd_ms = median_ms(torch, lambda: kctc._launch_bwd(*largs, alpha, cot))
    # The warp route's bounds (train_kernel_phase) at this S and these tlen.
    states = float((tlen.long() * s).sum().item())
    fbound = bound(10.0 * states, 4 * b * t * s + 4 * b * s + 8 * b + 4 * b,
                   PEAK_FP32_FLOPS)
    bbound = bound(14.0 * states, 4 * b * t * s + 4 * b * s + 8 * b + 4 * b
                   + 4 * b * t * s, PEAK_FP32_FLOPS)
    lpt = lp.transpose(0, 1).detach().requires_grad_(True)
    ctc = lambda: F.ctc_loss(lpt, labels, tlen.long(), ulen, blank=0,
                             reduction="none", zero_infinity=True)
    lib_fwd_ms = median_ms(torch, ctc)
    lib_loss = ctc()
    lib_bwd_ms = median_ms(torch, lambda: torch.autograd.grad(
        lib_loss, lpt, cot, retain_graph=True))
    print(f"K1 ctc_lattice block route B={b} T={t} S={s}: forward "
          f"{fwd_ms:.4f} ms (bound {fbound[0]:.4f}, {fbound[1]}; F.ctc_loss "
          f"{lib_fwd_ms:.4f}), backward {bwd_ms:.4f} ms (bound "
          f"{bbound[0]:.4f}, {bbound[1]}; F.ctc_loss {lib_bwd_ms:.4f}); "
          f"{ctc_info(s)}")
    return dict(s=s, max_abs_err=err_o, max_abs_err_bwd=err_g, ms=fwd_ms,
                bwd_ms=bwd_ms, bound_ms=fbound[0], bwd_bound_ms=bbound[0],
                library_ms=lib_fwd_ms, bwd_library_ms=lib_bwd_ms)


def train_kernel_phase(torch, t_prime):
    """K2 and K3 backward, K4 and K1 both ways, at the flagship train step's
    shapes; returns the kernels-line entries."""
    import torch.nn.functional as F
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.ops.kernels import ctc as kctc
    from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
    from espnet_slurp_tpu_torch.ops.kernels import ffn
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    cfg = flagship_config()
    b, t, u = TRAIN_B, t_prime, TRAIN_U
    d, f, h, v = cfg.d_model, cfg.d_ff, cfg.n_head, cfg.vocab_size
    dh, n, s = d // h, b * t_prime, 2 * u + 1
    out = []

    # K2 backward: N = 64 x T' rows.
    args, gb, err, plain_bwd = check_ffn_bwd(torch, ffn, n, d, f, r)
    x, w1, b1, w2, _ = args
    k2 = ffn_fwd_detail(torch, ffn, args, "(flagship train)")
    plain_ms = median_ms(torch, plain_bwd)
    ms, launch_ms, peak_mb = ffn_bwd_detail(torch, ffn, args, gb, n)
    k2_eager = ffn_eager_ms(torch, args, gb)
    print(f"K2 fused_ffn backward bfloat16 N={n}: plain composition "
          f"{plain_ms:.4f} ms, eager composition forward {k2_eager[0]:.4f} "
          f"ms and backward {k2_eager[1]:.4f} ms in the same call")
    bnd = ffn_bounds(n, d, f, d, 2)["bwd"]
    out.append(dict(
        name="fused_ffn_bwd", route="cuda",
        source="espnet_slurp_tpu_torch/csrc/ffn.cu",
        replaces="espnet_slurp_tpu/ops/pallas/ffn.py:206",
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=k2_eager[1],
        library_note="autograd's backward of the eager bf16 composition "
                     "F.linear -> F.silu -> F.dropout -> F.linear at rate 0",
        launch_ms=launch_ms, peak_mb=peak_mb))
    del args, gb, x, w1, b1, w2, plain_bwd

    # K3 backward: B 64, H 4, T', Dh 64, ragged lengths.
    args, gb, err, plain_bwd = check_attention_bwd(torch, fa, b, h, t, dh, r)
    check_attention_fwd_tiled(torch, fa, args, f"B={b} T={t} (train)")
    scale = dh ** -0.5
    att_fwd_ms, att_fwd_device, _ = launch_detail(
        torch, lambda: fa._launch_fwd(*args, scale, 0, -1), FWD_KERNEL)
    with torch.no_grad():
        att_fwd_plain_ms = median_ms(torch, lambda: fa.rel_flash_attention_plain(
            *args, scale=scale))
    plain_ms = median_ms(torch, plain_bwd)
    del plain_bwd
    ms, launch_ms, peak_mb = attention_bwd_detail(torch, fa, args, gb, b, t)
    print(f"K3 rel_flash_attention backward bfloat16 B={b} T={t}: plain "
          f"composition {plain_ms:.4f} ms in the same call")
    q_u, q_v, k, vv, pp, lengths = args
    raw = q_v.float() @ pp[:, :2 * t - 1].float().transpose(-1, -2)
    bd = raw.gather(-1, fa.rel_shift_index(t, raw.device).expand(b, h, t, t))
    allowed = fa.allowed_mask(t, lengths)
    bias = torch.where(allowed, bd * scale, fa.NEG).to(q_u.dtype)
    del raw, bd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        att_fwd_lib_ms = median_ms(torch, lambda: sdpa(
            q_u, k, vv, attn_mask=bias, scale=scale))
    leaves = [x.detach().requires_grad_(True) for x in (q_u, k, vv)]
    sd = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=bias, scale=scale)
    lib_ms = median_ms(torch, lambda: torch.autograd.grad(
        sd, leaves, gb, retain_graph=True))
    del sd, leaves, bias
    pairs = float(allowed.expand(b, 1, t, t).sum().item()) * h
    att = att_bounds(b, h, t, dh, pairs, 2, PEAK_BF16_FLOPS)
    att_fwd_bound, bnd, dkv_bnd, dq_bnd = (att[k] for k in ("fwd", "bwd",
                                                            "dkv", "dq"))
    out.append(dict(
        name="rel_flash_attention_bwd", route="cuda",
        source="espnet_slurp_tpu_torch/csrc/flash_attention.cu",
        replaces="espnet_slurp_tpu/ops/pallas/flash_attention.py:379",
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms,
        library_note="SDPA backward over a constant rel-shifted bias; "
                     "computes no dp",
        launch_ms=launch_ms, peak_mb=peak_mb, dkv_bound_ms=dkv_bnd[0],
        dkv_bound_by=dkv_bnd[1], dq_bound_ms=dq_bnd[0],
        dq_bound_by=dq_bnd[1]))
    del args, gb, q_u, q_v, k, vv, pp

    # K4: hs [B, T', D], W [V, D], labels U = 64 with blanks between.
    labels = torch.randint(1, v - 1, (b, u), generator=gen, device="cuda")
    ulen = torch.tensor([u - (i % 5) for i in range(b)], device="cuda")
    ext, skip, smax, last = kctc.extend_labels(labels, ulen)
    ext32 = ext.to(torch.int32)
    hs0, w0, b0 = r(b, t, d) * 0.5, r(v, d) * d ** -0.5, r(v) * 0.1
    cot = r(b, t, s)
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        args = (hs0.to(dt), w0.to(dt), b0, ext32)
        o, g, _ = grad_case(torch, kh.fused_ctc_head_emit, args, cot, 3)
        ro, rg, plain_bwd = grad_case(torch, kh.fused_ctc_head_emit_plain,
                                      args, cot, 3)
        err_o, err_g = hold(torch, f"K4 fused_ctc_head_emit {name} B={b} "
                            f"T={t} V={v} S={s}", o, ro, g, rg,
                            ("dhs", "dw", "db"), TOL[name])
        if dt != torch.bfloat16:
            del plain_bwd
            continue
        hs, w, bb, _ = args
        _, z = kh._launch_fwd(hs, w, bb, ext32)
        fwd_ms = median_ms(torch, lambda: kh._launch_fwd(hs, w, bb, ext32))
        fwd_detail = ctc_head_bf16_fwd_detail(torch, kh, args, b, t, d, v, s)
        head_bwd = lambda: kh._launch_bwd(hs, w, bb, ext32, z, cot)
        bwd_ms, head_launch_ms, head_peak_mb = ctc_head_bwd_detail(
            torch, kh, head_bwd, (hs, w, bb, ext32, z, cot), n)
        plain_fwd_ms = median_ms(torch, lambda: kh.fused_ctc_head_emit_plain(
            *args))
        plain_bwd_ms = median_ms(torch, plain_bwd)
        del plain_bwd
        eager_fwd_ms, eager_bwd_ms = head_eager_ms(torch, args, cot)
        print(f"K4 fused_ctc_head_emit bfloat16 B={b} T={t} V={v}: forward "
              f"{fwd_ms:.4f} ms (plain {plain_fwd_ms:.4f}, eager composition "
              f"{eager_fwd_ms:.4f}), backward {bwd_ms:.4f} ms (plain "
              f"{plain_bwd_ms:.4f}, eager composition {eager_bwd_ms:.4f})")
        fbound = bound(2.0 * n * d * v,
                       2 * n * d + 2 * d * v + 4 * v + 4 * b * s
                       + 4 * n * s + 4 * n)
        bbound = bound(6.0 * n * d * v,
                       2 * n * d + 2 * d * v + 4 * v + 4 * b * s + 4 * n
                       + 4 * n * s + 2 * n * d + 2 * d * v + 4 * v)
        common = dict(route="cuda",
                      source="espnet_slurp_tpu_torch/csrc/ctc_head.cu",
                      launches=None,
                      library_note="the eager bf16 composition F.linear -> "
                                   "log_softmax (fp32) -> gather (autograd's "
                                   "backward)")
        out.append(dict(name="fused_ctc_head_emit",
                        replaces="espnet_slurp_tpu/ops/pallas/ctc_head.py:160",
                        max_abs_err=err_o, ms=fwd_ms, plain_ms=plain_fwd_ms,
                        bound_ms=fbound[0], bound_by=fbound[1],
                        library_ms=eager_fwd_ms, **fwd_detail, **common))
        out.append(dict(name="fused_ctc_head_emit_bwd",
                        replaces="espnet_slurp_tpu/ops/pallas/ctc_head.py:179",
                        max_abs_err=err_g, ms=bwd_ms, plain_ms=plain_bwd_ms,
                        bound_ms=bbound[0], bound_by=bbound[1],
                        library_ms=eager_bwd_ms, launch_ms=head_launch_ms,
                        peak_mb=head_peak_mb, **common))
    del hs0, w0, o, g, ro, rg

    # K1: emissions of log-softmaxed random logits, ragged T' and U.
    tlen = torch.tensor([t - 3 * i for i in range(b)], dtype=torch.int32,
                        device="cuda")
    lp = torch.log_softmax(r(b, t, v) * 2.0, -1)
    emit = kctc.mask_emit(lp.gather(2, ext[:, None, :].expand(b, t, -1)),
                          smax).contiguous()
    cot = torch.rand(b, generator=gen, device="cuda")
    largs = (emit, skip, tlen, last)
    o, g, _ = grad_case(torch, kctc.ctc_lattice, largs, cot, 1)
    ro, rg, plain_bwd = grad_case(torch, kctc.ctc_lattice_plain, largs, cot, 1)
    err_o, err_g = hold(torch, f"K1 ctc_lattice float32 B={b} T={t} S={s}",
                        o, ro, g, rg, ("demit",), TOL["float32"])
    _, alpha = kctc._launch_fwd(*largs)
    fwd_ms = median_ms(torch, lambda: kctc._launch_fwd(*largs))
    bwd_ms = median_ms(torch, lambda: kctc._launch_bwd(*largs, alpha, cot))
    plain_fwd_ms = median_ms(torch, lambda: kctc.ctc_lattice_plain(*largs),
                             warmup=1, reps=5)
    plain_bwd_ms = median_ms(torch, plain_bwd, warmup=1, reps=5)
    del plain_bwd
    lpt = lp.transpose(0, 1).detach().requires_grad_(True)
    ctc = lambda: F.ctc_loss(lpt, labels, tlen.long(), ulen, blank=0,
                             reduction="none", zero_infinity=True)
    lib_fwd_ms = median_ms(torch, ctc)
    lib_loss = ctc()
    lib_bwd_ms = median_ms(torch, lambda: torch.autograd.grad(
        lib_loss, lpt, cot, retain_graph=True))
    # Compulsory bytes only: the alpha residual is left out (a backward
    # could recompute it). Forward: emit, skip, tlen, last in, loss out;
    # backward: the same inputs and g in, demit out.
    states = float((tlen.long() * s).sum().item())  # the recursion's work
    fbound = bound(10.0 * states, 4 * b * t * s + 4 * b * s + 8 * b + 4 * b,
                   PEAK_FP32_FLOPS)
    bbound = bound(14.0 * states, 4 * b * t * s + 4 * b * s + 8 * b + 4 * b
                   + 4 * b * t * s, PEAK_FP32_FLOPS)
    k1 = ctc_lattice_detail(torch, kctc, largs, alpha, cot, b, t, s, fbound,
                            bbound, fwd_ms, bwd_ms)
    block = ctc_lattice_block_route(torch, kctc, lp, gen, b, t, 200)
    print(f"K1 ctc_lattice float32 B={b} T={t} S={s}: forward {fwd_ms:.4f} "
          f"ms (plain {plain_fwd_ms:.4f}, F.ctc_loss {lib_fwd_ms:.4f}), "
          f"backward {bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f}, F.ctc_loss "
          f"{lib_bwd_ms:.4f})")
    common = dict(route="cuda", source="espnet_slurp_tpu_torch/csrc/ctc.cu",
                  launches=None, block_route=block)
    out.append(dict(name="ctc_lattice",
                    replaces="espnet_slurp_tpu/ops/pallas/ctc.py:195",
                    max_abs_err=err_o, ms=fwd_ms, plain_ms=plain_fwd_ms,
                    bound_ms=fbound[0], bound_by=fbound[1],
                    library_ms=lib_fwd_ms,
                    library_note="F.ctc_loss forward on [T', B, V] log-probs",
                    device_ms=k1[K1_WARP[0]]["device_ms"],
                    launch_detail={K1_WARP[0]: k1[K1_WARP[0]]}, **common))
    out.append(dict(name="ctc_lattice_bwd",
                    replaces="espnet_slurp_tpu/ops/pallas/ctc.py:236",
                    max_abs_err=err_g, ms=bwd_ms, plain_ms=plain_bwd_ms,
                    bound_ms=bbound[0], bound_by=bbound[1],
                    library_ms=lib_bwd_ms,
                    library_note="F.ctc_loss backward to [T', B, V] "
                                 "log-probs",
                    device_ms=k1[K1_WARP[1]]["device_ms"],
                    launch_detail={K1_WARP[1]: k1[K1_WARP[1]]}, **common))
    return out, {
        "fused_ffn": {**{f"{k}_at_train_shape": k2[k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "splits")},
            "library_ms_at_train_shape": k2_eager[0]},
        "rel_flash_attention": dict(
            ms_at_train_shape=att_fwd_ms,
            bound_ms_at_train_shape=att_fwd_bound[0],
            plain_ms_at_train_shape=att_fwd_plain_ms,
            library_ms_at_train_shape=att_fwd_lib_ms,
            device_ms_at_train_shape=att_fwd_device.get("fwd"))}


def train_batch(torch, rng, b, n_samples, u, vocab, device):
    return {
        "speech": torch.from_numpy(
            rng.randn(b, n_samples).astype(np.float32) * 0.1).to(device),
        "speech_lengths": torch.full((b,), n_samples, dtype=torch.int32,
                                     device=device),
        "text": torch.from_numpy(rng.randint(1, vocab - 1, size=(b, u))
                                 .astype(np.int64)).to(device),
        "text_lengths": torch.full((b,), u, dtype=torch.int32, device=device),
    }


COUNTED = {  # kernels-line name -> (wrapper, counter attribute), per step
    "rnnt_lattice": ("kt", "rnnt_lattice", "launches"),
    "rnnt_lattice_bwd": ("kt", "rnnt_lattice", "bwd_launches"),
    "fused_conv_module": ("kc", "fused_conv_module", "launches"),
    "fused_conv_module_bwd": ("kc", "fused_conv_module", "bwd_launches"),
    "fused_ffn": ("ffn", "fused_ffn", "launches"),
    "fused_ffn_bwd": ("ffn", "fused_ffn", "bwd_launches"),
    "rel_flash_attention": ("fa", "rel_flash_attention_fwd", "launches"),
    "rel_flash_attention_bwd": ("fa", "rel_flash_attention_fwd",
                                "bwd_launches"),
    "fused_ctc_head_emit": ("kh", "fused_ctc_head_emit", "launches"),
    "fused_ctc_head_emit_bwd": ("kh", "fused_ctc_head_emit", "bwd_launches"),
    "ctc_lattice": ("kctc", "ctc_lattice", "launches"),
    "ctc_lattice_bwd": ("kctc", "ctc_lattice", "bwd_launches"),
}


def kernel_modules():
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    from espnet_slurp_tpu_torch.ops.kernels import ctc as kctc
    from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
    from espnet_slurp_tpu_torch.ops.kernels import ffn
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa
    from espnet_slurp_tpu_torch.ops.kernels import transducer as kt
    return {"ffn": ffn, "fa": fa, "kh": kh, "kctc": kctc, "kt": kt, "kc": kc}


def zero_counts(names=COUNTED):
    mods = kernel_modules()
    for m, f, a in (COUNTED[n] for n in names):
        setattr(getattr(mods[m], f), a, 0)


def read_counts(names=COUNTED):
    mods = kernel_modules()
    return {n: getattr(getattr(mods[COUNTED[n][0]], COUNTED[n][1]),
                       COUNTED[n][2]) for n in names}


class StepRun(NamedTuple):
    """What run_train_steps measured: the timed steps' launches, median step
    seconds, the profiled step's device busy ms, the number of timed steps,
    the host-counted routes, the peak MB since the warm-up, the last step's
    stats, the batch maker's median host ms (0 for a fixed batch) and every
    timed step's seconds."""
    launches: dict
    step_s: float
    busy_ms: float
    steps: int
    routes: dict
    peak_mb: float
    stats: dict
    host_ms: float
    times: list


def profiled_busy_ms(torch, step, state, batch):
    """(the state after, the device's busy ms) of one train step under
    torch.profiler: the sum of its kernels' device times."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    return state, sum(e.self_device_time_total for e in prof.key_averages()
                      if not e.key.startswith("train_step.")) / 1e3


def run_train_steps(torch, what, model, batch, card, audio_s,
                    budget_s=None, aux=None, falls=True) -> StepRun:
    """One warm-up step, then TRAIN_STEPS timed ones (3 when ``budget_s``
    is given and TRAIN_STEPS + 2 steps at the warm-up's time would run past
    it) with every launch count zeroed just before and read just after
    (the wrappers' counts, and K1's, K4's, K5's and K6's kernels by the
    library's host-side counts); checks finite losses, nothing skipped and
    (with ``falls``) a falling loss; then one more step under
    torch.profiler for the device's busy time (the sum of its kernels'
    times). ``batch`` is a batch, or a callable that makes a fresh one a
    step and returns it with its host ms (the biasing augmenter), outside
    the step's time; ``aux`` (model -> aux_loss_fn) adds a term to the
    loss (the MBR term)."""
    from espnet_slurp_tpu_torch.train.optim import OptimConfig, build_optimizer
    from espnet_slurp_tpu_torch.train.state import TrainState, make_train_step

    if not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError("the model must keep fp32 parameters")
    compute = getattr(model.cfg, "asr", model.cfg).dtype
    make = batch if callable(batch) else (lambda: (batch, 0.0))
    tx = build_optimizer(OptimConfig(lr=1e-3, scheduler="constant"))
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx,
                           aux_loss_fn=None if aux is None else aux(model))
    torch.cuda.reset_peak_memory_stats()
    b, _ = make()
    t0 = time.perf_counter()
    state, st = step(state, b)  # warm-up: cuBLAS/cuDNN, the allocator
    first_loss = float(st["loss"])
    warm_s = time.perf_counter() - t0
    steps = TRAIN_STEPS
    if budget_s is not None and warm_s * (TRAIN_STEPS + 2) > budget_s:
        steps = 3

    zero_counts()
    routes0 = route_counts()
    losses, norms, skipped, times, host_ms = [], [], [], [], []
    for _ in range(steps):
        b, ms = make()
        host_ms.append(ms)
        t0 = time.perf_counter()
        state, st = step(state, b)
        losses.append(float(st["loss"]))  # synchronises
        times.append(time.perf_counter() - t0)
        norms.append(float(st["grad_norm"]))
        skipped.append(float(st["skipped"]))
    launches = read_counts()
    routes = {k: n - routes0[k] for k, n in route_counts().items()}
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    step_s = float(np.median(times))
    stats = {k: round(float(v), 5) for k, v in st.items()}
    print(f"{what}: {compute} compute / fp32 parameters, Adam lr 1e-3: step "
          f"{step_s:.4f} s (median of {steps}; steps {times}; warm-up "
          f"{warm_s:.3f} s), {audio_s / step_s:.1f} audio-s/s, peak memory "
          f"{peak_mb / 1e3:.2f} GB on {card}")
    extra = ", ".join(f"{k} {float(v):.4f}" for k, v in st.items()
                      if k.startswith("loss_"))
    print(f"{what}: losses {[first_loss] + losses}, grad norms {norms}, "
          f"skipped {skipped}, {extra}")
    if callable(batch):
        print(f"{what}: a fresh batch a step, {np.median(host_ms):.2f} ms "
              f"on the host ({[round(x, 2) for x in host_ms]}); last stats "
              f"{stats}")
    print(f"{what}: launches over {steps} steps {launches}; K1, K4, K5 and "
          f"K6 kernels {routes}")
    if not (all(np.isfinite(losses + norms + [first_loss]))
            and sum(skipped) == 0 and (losses[-1] < first_loss or not falls)):
        raise AssertionError(f"{what}: non-finite, skipped or not falling")
    b, _ = make()
    state, busy_ms = profiled_busy_ms(torch, step, state, b)
    print(f"{what}: device busy {busy_ms:.2f} ms in one profiled step")
    return StepRun(launches, step_s, busy_ms, steps, routes, peak_mb, stats,
                   float(np.median(host_ms)), times)


# The kernels line's entries timed in bf16 only; a default ASRConfig()
# step (fp32) launches other instances of these wrappers.
BF16_TIMED = ("fused_ffn", "fused_ffn_bwd", "rel_flash_attention",
              "rel_flash_attention_bwd", "fused_ctc_head_emit",
              "fused_ctc_head_emit_bwd")


def check_per_step(what, launches, per_step, steps=TRAIN_STEPS):
    """Every counted kernel launched exactly steps x per_step times (0 for
    those not named)."""
    want = {k: steps * per_step.get(k, 0) for k in COUNTED}
    if launches != want:
        raise AssertionError(f"{what} launches {launches}, expected "
                             f"{per_step} per step")


def flagship_step_want(n_blocks, times=1, n_ffn=None):
    """A flagship ASR step's launches each way by the wrappers' counts: K2
    n_ffn times (two FFNs a block unless given: a routed MoE second FFN is
    no K2 launch), K3 once a block, K4 and K1 once; ``times`` encoder
    passes (the MBR term's re-encode is a second)."""
    if n_ffn is None:
        n_ffn = 2 * n_blocks
    return {"fused_ffn": n_ffn * times, "fused_ffn_bwd": n_ffn * times,
            "rel_flash_attention": n_blocks * times,
            "rel_flash_attention_bwd": n_blocks * times,
            "fused_ctc_head_emit": 1, "fused_ctc_head_emit_bwd": 1,
            "ctc_lattice": 1, "ctc_lattice_bwd": 1}


def train_phase(torch, card):
    """The flagship train step on the bench traffic at the recipe's dropout
    (DROPOUT), then the same phase at dropout 0 for its step wall and busy
    time; returns the launch counts of the dropout run's timed steps, its
    step seconds and its peak MB."""
    from espnet_slurp_tpu_torch.models.asr_model import (ASRModel,
                                                          flagship_config)
    from espnet_slurp_tpu_torch.utils.params import init_random_

    runs = {}
    for rate in (DROPOUT, 0.0):
        cfg = dataclasses.replace(flagship_config(), dropout_rate=rate)
        model = init_random_(ASRModel(cfg, device="cuda"), seed=0)
        batch = train_batch(torch, np.random.RandomState(0), TRAIN_B,
                            FS * TRAIN_SECONDS, TRAIN_U, cfg.vocab_size,
                            "cuda")
        run = run_train_steps(
            torch, f"train: flagship, B={TRAIN_B} x {TRAIN_SECONDS} s, "
            f"U={TRAIN_U}, dropout {rate}", model, batch, card,
            TRAIN_B * TRAIN_SECONDS)
        check_routes("train", run.routes, K1_WARP + tuple(K4_BF16_LAUNCHES),
                     TRAIN_STEPS)
        check_per_step("train", run.launches,
                       flagship_step_want(cfg.num_encoder_blocks))
        runs[rate] = (run.launches, run.step_s, run.busy_ms, run.peak_mb)
        del model, batch
        torch.cuda.empty_cache()
    (launches, step_s, busy, peak_mb), (_, step0, busy0, _) = (
        runs[DROPOUT], runs[0.0])
    print(f"train: flagship step at dropout {DROPOUT} {step_s:.4f} s, "
          f"device busy {busy:.2f} ms; at dropout 0 {step0:.4f} s, "
          f"{busy0:.2f} ms (same call, {card})")
    return launches, step_s, peak_mb


def transducer_config(**asr):
    from espnet_slurp_tpu_torch.models.transducer import \
        transducer_flagship_config
    cfg = transducer_flagship_config()
    return dataclasses.replace(cfg, asr=dataclasses.replace(
        cfg.asr, fused_conv=True, **asr))


def transducer_kernel_phase(torch, t_prime, t_serve):
    """K2 and K3 both ways, and K5 and K6 both ways, at the transducer
    step's shapes (T' t_prime), then K6 forward at the greedy decode's
    (N_UTT x t_serve, lengths t_prime); returns the kernels-line entries,
    the records at the transducer shape of the entries timed elsewhere and
    K6's fp32 entries."""
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    from espnet_slurp_tpu_torch.ops.kernels import ffn
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa
    from espnet_slurp_tpu_torch.ops.kernels import transducer as kt

    gen = torch.Generator(device="cuda").manual_seed(3)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    cfg = transducer_config().asr
    b, t, u1, d, k = TR_B, t_prime, TR_U + 1, cfg.d_model, cfg.kernel_size
    out = []

    # K2 and K3 at B 32 (the flagship step's checks are at B 64); K2's
    # backward timed beside its plain composition at this shape too.
    args, gb, _, plain_bwd = check_ffn_bwd(torch, ffn, b * t, d, cfg.d_ff, r)
    k2 = ffn_fwd_detail(torch, ffn, args, "(transducer train)")
    ffn_fwd_tr = {f"{k}_at_transducer_shape": k2[k] for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "splits")}
    plain_ms = median_ms(torch, plain_bwd)
    del plain_bwd
    ms, launch_ms, peak_mb = ffn_bwd_detail(torch, ffn, args, gb, b * t)
    print(f"K2 fused_ffn backward bfloat16 N={b * t}: plain composition "
          f"{plain_ms:.4f} ms in the same call")
    ffn_bwd_tr = {"ms_at_transducer_shape": ms,
                  "plain_ms_at_transducer_shape": plain_ms,
                  "launch_ms_at_transducer_shape": launch_ms,
                  "peak_mb_at_transducer_shape": peak_mb}
    del args, gb
    args, gb, _, plain_bwd = check_attention_bwd(torch, fa, b, cfg.n_head, t,
                                                 d // cfg.n_head, r)
    plain_ms = median_ms(torch, plain_bwd)
    del plain_bwd
    ms, launch_ms, peak_mb = attention_bwd_detail(torch, fa, args, gb, b, t)
    print(f"K3 rel_flash_attention backward bfloat16 B={b} T={t}: plain "
          f"composition {plain_ms:.4f} ms in the same call")
    att_bwd_tr = {"ms_at_transducer_shape": ms,
                  "plain_ms_at_transducer_shape": plain_ms,
                  "launch_ms_at_transducer_shape": launch_ms,
                  "peak_mb_at_transducer_shape": peak_mb}
    del args, gb

    out += rnnt_phase(torch, kt, gen, b, t, u1)

    k6, k6_fp32 = conv_phase(torch, kc, b, t, t_serve, d, k, r)
    return out + k6, {"fused_ffn": ffn_fwd_tr, "fused_ffn_bwd": ffn_bwd_tr,
                      "rel_flash_attention_bwd": att_bwd_tr}, k6_fp32


def rnnt_tables(torch, kt, gen, b, t, u1):
    """K5's blank and emit tables [b, t, u1] of log-softmaxed logits, emit's
    last column NEG (as ops/transducer.py pads it)."""
    lp = torch.log_softmax(torch.randn(b, t, u1, 8, generator=gen,
                                       device="cuda") * 2.0, -1)
    emit = lp[..., 1].clone()
    emit[..., -1] = kt.NEG
    return lp[..., 0].contiguous(), emit


def check_rnnt(torch, kt, what, largs, cot, route):
    """K5 both ways against rnnt_lattice_plain within TOL["float32"] of max
    |ref|; one launch each way, of `route`, by the host counts; gradients
    exactly 0 at frames past tlen and on rows whose cotangent is 0. Returns
    (output error, gradient error, the plain version's backward)."""
    got = routes_of(lambda: grad_case(torch, kt.rnnt_lattice, largs, cot, 2))
    check_routes(what, got, route)
    o, g, _ = grad_case(torch, kt.rnnt_lattice, largs, cot, 2)
    ro, rg, plain_bwd = grad_case(torch, kt.rnnt_lattice_plain, largs, cot,
                                  2)
    err_o, err_g = hold(torch, what, o, ro, g, rg, ("dblank", "demit"),
                        TOL["float32"])
    frames = torch.arange(largs[0].shape[1], device="cuda")
    dead = ((frames[None, :, None] >= largs[2].long()[:, None, None])
            | (cot == 0)[:, None, None]).expand_as(g[0])
    for name, x in zip(("dblank", "demit"), g):
        if (x[dead] != 0).any():
            raise AssertionError(f"{what}: {name} is not exactly 0 at dead "
                                 "frames and rows with a zero cotangent")
    return err_o, err_g, plain_bwd


def rnnt_phase(torch, kt, gen, b, t, u1):
    """K5 at the transducer step's shape (B b, T' t, U1 u1; ragged T' and
    U, one row with a zero cotangent) on its warp route, at
    test_rnnt_lattice's U1 on both routes, and the block route at B 8, T'
    t, U1 300: each against rnnt_lattice_plain, its route by host counts;
    the warp route timed beside the plain version and the bound, both
    routes' us per anti-diagonal step, registers, shared bytes, spills and
    blocks per SM. Returns the kernels-line entries."""
    for ue in K5_EDGE_U1:
        be, te = 5, 40
        blank, emit = rnnt_tables(torch, kt, gen, be, te, ue)
        tlen = torch.tensor([te, 1, 0, te - 13, te], dtype=torch.int32,
                            device="cuda")
        ulen = torch.tensor([ue - 1, min(3, ue - 1), 0, 0, (ue - 1) // 2],
                            dtype=torch.int32, device="cuda")
        cot = torch.rand(be, generator=gen, device="cuda")
        cot[4] = 0.0
        route = K5_WARP if ue <= kt.warp_states() else K5_BLOCK
        check_rnnt(torch, kt, f"K5 rnnt_lattice B={be} T={te} U1={ue}",
                   (blank, emit, tlen, ulen), cot, route)

    blank, emit = rnnt_tables(torch, kt, gen, b, t, u1)
    tlen = torch.tensor([t - 3 * i for i in range(b)], dtype=torch.int32,
                        device="cuda")
    ulen = torch.tensor([TR_U - (i % 5) for i in range(b)],
                        dtype=torch.int32, device="cuda")
    cot = torch.rand(b, generator=gen, device="cuda")
    cot[-1] = 0.0
    largs = (blank, emit, tlen, ulen)
    err_o, err_g, plain_bwd = check_rnnt(
        torch, kt, f"K5 rnnt_lattice float32 B={b} T={t} U1={u1}", largs,
        cot, K5_WARP)
    _, alpha = kt._launch_fwd(*largs)
    fwd_ms = median_ms(torch, lambda: kt._launch_fwd(*largs))
    bwd_ms = median_ms(torch, lambda: kt._launch_bwd(*largs, alpha, cot))
    plain_fwd_ms = median_ms(torch, lambda: kt.rnnt_lattice_plain(*largs),
                             warmup=1, reps=5)
    plain_bwd_ms = median_ms(torch, plain_bwd, warmup=1, reps=5)
    del plain_bwd, alpha
    # Compulsory bytes only (the fp64 alpha residual is left out, as for
    # K1): forward both tables, tlen, ulen in and the loss out; backward
    # the same inputs and g in, dblank and demit out.
    table = 4 * b * t * u1
    states = float((tlen.long() * u1).sum().item())
    fbound = bound(10.0 * states, 2 * table + 8 * b + 4 * b, PEAK_FP32_FLOPS)
    bbound = bound(14.0 * states, 2 * table + 12 * b + 2 * table,
                   PEAK_FP32_FLOPS)
    chain = t + u1 - 1
    info = {k: kt.info(w, u1) for w, k in enumerate(K5_WARP)}
    print(f"K5 rnnt_lattice warp route: forward {fwd_ms:.4f} ms, backward "
          f"{bwd_ms:.4f} ms over a chain of {chain} dependent anti-diagonal "
          f"steps ({1e3 * fwd_ms / chain:.4f} / {1e3 * bwd_ms / chain:.4f} "
          f"us a step); bytes bound {fbound[0]:.4f} / {bbound[0]:.4f} ms; "
          "(registers, shared bytes, local bytes, blocks per SM) "
          f"{info}")
    del blank, emit

    # The block route past the warp route's limit, timed.
    bb, ub = 8, 300
    blank, emit = rnnt_tables(torch, kt, gen, bb, t, ub)
    btlen = torch.tensor([t - 5 * i for i in range(bb)], dtype=torch.int32,
                         device="cuda")
    bulen = torch.tensor([ub - 1 - 7 * i for i in range(bb)],
                         dtype=torch.int32, device="cuda")
    bcot = torch.rand(bb, generator=gen, device="cuda")
    bargs = (blank, emit, btlen, bulen)
    berr_o, berr_g, _ = check_rnnt(
        torch, kt, f"K5 rnnt_lattice float32 B={bb} T={t} U1={ub} (block "
        "route)", bargs, bcot, K5_BLOCK)
    _, alpha = kt._launch_fwd(*bargs)
    bchain = t + ub - 1
    block = dict(B=bb, T=t, U1=ub, max_abs_err=berr_o, max_abs_err_bwd=berr_g,
                 ms=median_ms(torch, lambda: kt._launch_fwd(*bargs)),
                 bwd_ms=median_ms(torch, lambda: kt._launch_bwd(
                     *bargs, alpha, bcot)),
                 info={k: kt.info(w, ub) for w, k in enumerate(K5_BLOCK)})
    block["us_per_step"] = 1e3 * block["ms"] / bchain
    block["bwd_us_per_step"] = 1e3 * block["bwd_ms"] / bchain
    print(f"K5 rnnt_lattice block route B={bb} T={t} U1={ub}: forward "
          f"{block['ms']:.4f} ms, backward {block['bwd_ms']:.4f} ms "
          f"({block['us_per_step']:.4f} / {block['bwd_us_per_step']:.4f} us "
          f"a step over {bchain}); {block['info']}")
    del blank, emit, alpha

    common = dict(route="cuda",
                  source="espnet_slurp_tpu_torch/csrc/transducer.cu",
                  launches=None, library_ms=None,
                  library_note="torch has no RNN-T loss of its own",
                  dependency_chain_steps=chain, edge_u1_checked=K5_EDGE_U1,
                  block_route=block)
    return [
        dict(name="rnnt_lattice",
             replaces="espnet_slurp_tpu/ops/pallas/transducer.py:134",
             kernel=K5_WARP[0], info=info[K5_WARP[0]], max_abs_err=err_o,
             ms=fwd_ms, us_per_step=1e3 * fwd_ms / chain,
             plain_ms=plain_fwd_ms, bound_ms=fbound[0], bound_by=fbound[1],
             **common),
        dict(name="rnnt_lattice_bwd",
             replaces="espnet_slurp_tpu/ops/pallas/transducer.py:183",
             kernel=K5_WARP[1], info=info[K5_WARP[1]], max_abs_err=err_g,
             ms=bwd_ms, us_per_step=1e3 * bwd_ms / chain,
             plain_ms=plain_bwd_ms, bound_ms=bbound[0], bound_by=bbound[1],
             **common)]


def conv_phase(torch, kc, b, t, t_serve, d, k, r):
    """K6 both ways at the transducer step's shapes (B b, T' t, width d, k
    taps; bf16 and fp32, SAME and causal, ragged lengths), each call's
    route by the host counts, the bf16 backward also against
    fused_conv_module_bwd_plain; then timed at that shape and the
    flagship's (B 64), fp32 also checked there, the bf16 forward also at
    the greedy decode's (N_UTT x t_serve, t valid frames). Returns the
    kernels-line entries of the bf16 route and of the fp32 one."""
    out = []
    # K6: x [B, T', D], k 31, ragged lengths; SAME and causal in bf16 and
    # fp32; each call's launches by the host counts.
    k6_gone_check(torch)
    lengths = torch.tensor([t - 7 * i for i in range(b)], dtype=torch.int32,
                           device="cuda")
    params0 = (r(2 * d, d) * d ** -0.5, r(2 * d) * 0.1, r(d, k) * k ** -0.5,
               r(d) * 0.1, 1.0 + 0.1 * r(d), r(d) * 0.1, r(d, d) * d ** -0.5,
               r(d) * 0.1)
    x0, gout = r(b, t, d), r(b, t, d)
    names = ("dx", "dw1", "db1", "dwdw", "dbdw", "dgamma", "dbeta", "dw2",
             "db2")
    for dt, causal in ((torch.bfloat16, False), (torch.float32, False),
                       (torch.bfloat16, True), (torch.float32, True)):
        name = str(dt).split(".")[-1]
        args = k6_args(x0, lengths, params0, dt)
        kw = dict(kernel_size=k, causal=causal)
        fn = lambda *a: kc.fused_conv_module(*a, **kw)
        plain = lambda *a: kc.fused_conv_module_plain(*a, **kw)
        grad_args = (args[0],) + args[2:] + (args[1],)  # differentiable first
        reorder = lambda f: lambda x, *rest: f(x, rest[-1], *rest[:-1])
        what = f"K6 fused_conv_module {name} B={b} T={t} D={d} k={k} " \
               f"causal={causal}"
        before = route_counts()
        o, g, _ = grad_case(torch, reorder(fn), grad_args, gout.to(dt), 9)
        torch.cuda.synchronize()
        got = {n: c - before[n] for n, c in route_counts().items()}
        check_routes(what, got, K6_BF16_LAUNCHES if dt == torch.bfloat16
                     else K6_F32_LAUNCHES)
        ro, rg, plain_bwd = grad_case(torch, reorder(plain), grad_args,
                                      gout.to(dt), 9)
        err_o, err_g = hold(torch, what, o, ro, g, rg, names, TOL[name])
        if dt == torch.bfloat16:
            # The backward at the reference's rounding points.
            bp = kc.fused_conv_module_bwd_plain(*args[:-1], gout.to(dt), **kw)
            rels = [rel_err(a, p)[1] for a, p in zip(g, bp)]
            print(f"{what} backward against fused_conv_module_bwd_plain: "
                  + ", ".join(f"{n} {v:.3e}" for n, v in zip(names, rels))
                  + f" of max|ref| (tolerance {BWD_PLAIN_TOL})")
            if not max(rels) <= BWD_PLAIN_TOL:
                raise AssertionError("K6 bf16 backward disagrees with "
                                     "fused_conv_module_bwd_plain")
            del bp
        del o, g, ro, rg
        if dt == torch.float32 and not causal:
            f32_err = (err_o, err_g)
            f32 = k6_fp32_timed(torch, kc, args, plain, plain_bwd,
                                gout.to(dt), params0, k, "(transducer train)")
        if dt != torch.bfloat16 or causal:
            del plain_bwd
            continue
        gb = gout.to(dt)
        timed = k6_timed(torch, kc, args, gb, k, "(transducer train)")
        plain_fwd_ms = median_ms(torch, lambda: plain(*args))
        plain_bwd_ms = median_ms(torch, plain_bwd)
        del plain_bwd
        eager = k6_eager(torch, x0.to(dt), lengths, params0, gb, k)
        info = k6_info(d, k)
        bnd = k6_bounds(b, t, d, k, kc.dw_splits(b * t, d, x0.device))
        k6_launches = launch_table("K6 bf16", {
            **timed["fwd_launch_ms"], **timed["bwd_launch_ms"]}, info,
            bnd["launches"])
        flagship = k6_timed(torch, kc, k6_args(
            r(TRAIN_B, t, d), torch.full((TRAIN_B,), t, dtype=torch.int32,
                                         device="cuda"), params0, dt),
            r(TRAIN_B, t, d).to(dt), k, f"(flagship shape, B={TRAIN_B})")
        print(f"K6 fused_conv_module bfloat16 B={b} T={t}: forward "
              f"{timed['fwd_ms']:.4f} ms (device {timed['fwd_device_ms']:.4f}"
              f"), plain {plain_fwd_ms:.4f}, eager ConvModule "
              f"{eager['fwd_ms']:.4f} (device {eager['fwd_device_ms']:.4f}), "
              f"bound {bnd['fwd'][0]:.4f} ({bnd['fwd'][1]}); backward "
              f"{timed['bwd_ms']:.4f} ms (device {timed['bwd_device_ms']:.4f}"
              f"), plain {plain_bwd_ms:.4f}, eager ConvModule "
              f"{eager['bwd_ms']:.4f} (device {eager['bwd_device_ms']:.4f}), "
              f"bound {bnd['bwd'][0]:.4f} ({bnd['bwd'][1]}); one backward "
              f"call adds {timed['bwd_peak_mb']:.1f} MB at its peak")
        common = dict(route="cuda",
                      source="espnet_slurp_tpu_torch/csrc/conv_module.cu",
                      launches=None,
                      library_note="the eager ConvModule (bf16), which K6 "
                                   "replaces; library_device_ms is its "
                                   "device time (torch.profiler)")
        for way, entry, line, mx, pms in (
                ("fwd", "fused_conv_module", 214, err_o, plain_fwd_ms),
                ("bwd", "fused_conv_module_bwd", 236, err_g, plain_bwd_ms)):
            out.append(dict(
                name=entry, replaces="espnet_slurp_tpu/ops/pallas/"
                f"conv_module.py:{line}", max_abs_err=mx,
                ms=timed[f"{way}_ms"], device_ms=timed[f"{way}_device_ms"],
                plain_ms=pms, bound_ms=bnd[way][0], bound_by=bnd[way][1],
                library_ms=eager[f"{way}_ms"],
                library_device_ms=eager[f"{way}_device_ms"],
                peak_mb=timed[f"{way}_peak_mb"],
                launch_detail={n: v for n, v in k6_launches.items()
                               if K6_BF16_LAUNCHES[n] == way},
                at_flagship_shape={key: flagship[f"{way}_{key}"] for key in (
                    "ms", "device_ms", "launch_ms", "peak_mb")},
                **common))

    # fp32 at the flagship's B 64 (the shape of ASRConfig(fused_conv=True)'s
    # train step): checked and timed.
    bf = TRAIN_B
    lengths = torch.tensor([t - 7 * i for i in range(bf)], dtype=torch.int32,
                           device="cuda")
    args = k6_args(r(bf, t, d), lengths, params0, torch.float32)
    gf = r(bf, t, d)
    kw = dict(kernel_size=k, causal=False)
    fn = lambda *a: kc.fused_conv_module(*a, **kw)
    plain = lambda *a: kc.fused_conv_module_plain(*a, **kw)
    grad_args = (args[0],) + args[2:] + (args[1],)
    reorder = lambda f: lambda x, *rest: f(x, rest[-1], *rest[:-1])
    what = f"K6 fused_conv_module float32 B={bf} T={t} D={d} k={k}"
    before = route_counts()
    o, g, _ = grad_case(torch, reorder(fn), grad_args, gf, 9)
    torch.cuda.synchronize()
    got = {n: c - before[n] for n, c in route_counts().items()}
    check_routes(what, got, K6_F32_LAUNCHES)
    ro, rg, plain_bwd = grad_case(torch, reorder(plain), grad_args, gf, 9)
    err_o, err_g = hold(torch, what, o, ro, g, rg, names, TOL["float32"])
    del o, g, ro, rg
    f32_b64 = k6_fp32_timed(torch, kc, args, plain, plain_bwd, gf, params0,
                            k, f"(flagship shape, B={bf})")
    del plain_bwd, args, gf
    f32_out = []
    for way, entry, line, mx, mx64 in (
            ("fwd", "fused_conv_module_fp32", 214, f32_err[0], err_o),
            ("bwd", "fused_conv_module_bwd_fp32", 236, f32_err[1], err_g)):
        e = f32[way]
        f32_out.append(dict(
            name=entry, route="cuda",
            source="espnet_slurp_tpu_torch/csrc/conv_module.cu",
            replaces=f"espnet_slurp_tpu/ops/pallas/conv_module.py:{line}",
            launches=None, max_abs_err=mx, ms=e["ms"],
            device_ms=e["device_ms"], plain_ms=e["plain_ms"],
            bound_ms=e["bound_ms"], bound_by=e["bound_by"],
            library_ms=e["eager_ms"], library_device_ms=e["eager_device_ms"],
            library_note="the eager fp32 ConvModule, which K6 replaces; "
                         "library_device_ms is its device time "
                         "(torch.profiler)",
            peak_mb=e["peak_mb"], launch_detail=e["launch_detail"],
            at_flagship_shape={"max_abs_err": mx64, **f32_b64[way]}))

    # K6 forward as the greedy decode runs it: 8 utterances of 15 s padded
    # to T' t_serve, each with t_prime valid frames, bf16, no gradient.
    args = k6_args(r(N_UTT, t_serve, d), torch.full(
        (N_UTT,), t, dtype=torch.int32, device="cuda"), params0,
        torch.bfloat16)
    with torch.no_grad():
        o = kc.fused_conv_module(*args, kernel_size=k, causal=False)
        torch.cuda.synchronize()
        ro = kc.fused_conv_module_plain(*args, kernel_size=k, causal=False)
    err, rel = rel_err(o, ro)
    print(f"K6 fused_conv_module bfloat16 B={N_UTT} T={t_serve} valid={t} "
          f"(greedy decode): out max abs err {err:.3e}, {rel:.3e} of "
          f"max|ref| (tolerance {TOL['bfloat16']})")
    if not (torch.isfinite(o).all() and rel <= TOL["bfloat16"]):
        raise AssertionError("K6 at the decode's shape disagrees with its "
                             "plain version")
    decode = k6_timed(torch, kc, args, None, k, f"(greedy decode, B={N_UTT} "
                      f"T={t_serve})")
    next(x for x in out if x["name"] == "fused_conv_module")[
        "at_decode_shape"] = {key: decode[f"fwd_{key}"] for key in (
            "ms", "device_ms", "launch_ms")}
    return out, f32_out


def k6_fp32_timed(torch, kc, args, plain, plain_bwd, gout, params, k, what):
    """K6's fp32 route (csrc/conv_module.cu's conv_f32) at args' shape: each
    direction by CUDA events, each launch's device time and their sum
    (torch.profiler) and what one call adds to peak memory, beside its
    plain version, the eager fp32 ConvModule (events and device time) and
    the bound (k6_f32_bounds: all work at the fp32 peak); each launch with
    its bound, registers, shared bytes, spills and blocks per SM."""
    x, lengths = args[0], args[1]
    b, t, d = x.shape
    timed = k6_timed(torch, kc, args, gout, k, what, K6_F32_LAUNCHES)
    eager = k6_eager(torch, x, lengths, params, gout, k)
    bnd = k6_f32_bounds(b, t, d, k, kc.dw_splits(b * t, d, x.device,
                                                 torch.float32))
    table = launch_table(f"K6 fp32 {what}", {
        **timed["fwd_launch_ms"], **timed["bwd_launch_ms"]},
        k6_info(d, k, fp32=True), bnd["launches"])
    res = {}
    for way, plain_call in (("fwd", lambda: plain(*args)),
                            ("bwd", plain_bwd)):
        r = res[way] = dict(
            ms=timed[f"{way}_ms"], device_ms=timed[f"{way}_device_ms"],
            peak_mb=timed[f"{way}_peak_mb"],
            plain_ms=median_ms(torch, plain_call),
            bound_ms=bnd[way][0], bound_by=bnd[way][1],
            eager_ms=eager[f"{way}_ms"],
            eager_device_ms=eager[f"{way}_device_ms"],
            launch_detail={n: v for n, v in table.items()
                           if K6_F32_LAUNCHES[n] == way})
        print(f"K6 fused_conv_module float32 {way} {what} B={b} T={t} D={d} "
              f"k={k}: {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
              f"{100 * r['bound_ms'] / r['device_ms']:.1f}% of the bound), "
              f"plain {r['plain_ms']:.4f}, eager fp32 ConvModule "
              f"{r['eager_ms']:.4f} (device {r['eager_device_ms']:.4f}), "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}); one call adds "
              f"{r['peak_mb']:.1f} MB at its peak")
    return res


def k6_args(x, lengths, params, dt):
    """K6's arguments in dtype dt: x, w1 and w2 in dt, the rest fp32."""
    w1, b1, wdw, bdw, gamma, beta, w2, b2 = params
    return (x.to(dt), lengths, w1.to(dt), b1, wdw, bdw, gamma, beta,
            w2.to(dt), b2)


def k6_timed(torch, kc, args, gb, k, what, launches=K6_BF16_LAUNCHES):
    """K6's forward (and, with a cotangent gb, backward) launches alone at
    one shape: CUDA events, each launch's device time and their sum
    (torch.profiler), what one call adds to peak memory."""
    pl = kc.left_pad(k, False)
    calls = {"fwd": lambda: kc._launch_fwd(*args, k, pl, 1e-6)}
    if gb is not None:
        calls["bwd"] = lambda: kc._launch_bwd(*args[:-1], gb, k, pl, 1e-6)
    res = {}
    route = "fp32" if launches is K6_F32_LAUNCHES else "bf16"
    for way, call in calls.items():
        parts = {n: n for n, w in launches.items() if w == way}
        ms, launch_ms, peak_mb = launch_detail(torch, call, parts)
        res.update({f"{way}_ms": ms, f"{way}_launch_ms": launch_ms,
                    f"{way}_device_ms": sum(launch_ms.values()),
                    f"{way}_peak_mb": peak_mb})
        print(f"K6 {route} {way} {what}: {ms:.4f} ms, device "
              f"{res[f'{way}_device_ms']:.4f} ms ("
              + ", ".join(f"{n.split('::')[-1]} {v:.4f}"
                          for n, v in launch_ms.items())
              + f"); one call adds {peak_mb:.1f} MB at its peak")
    return res


def k6_eager(torch, x, lengths, params, gb, k):
    """The eager ConvModule with K6's weights, which K6 replaces, on x (its
    dtype, the pad mask from lengths): forward (with autograd's graph) and
    autograd's backward, each by CUDA events and by device time
    (time_kernels.device_ms: a profiler window whose launches match an
    earlier window's)."""
    from espnet_slurp_tpu_torch.bin.time_kernels import device_ms
    from espnet_slurp_tpu_torch.models.conformer import ConvModule
    d, t = x.shape[-1], x.shape[1]
    mod = ConvModule(d, k).cuda()
    with torch.no_grad():
        for p, v in zip((mod.pointwise1.weight, mod.pointwise1.bias,
                         mod.depthwise.weight, mod.depthwise.bias,
                         mod.norm.weight, mod.norm.bias,
                         mod.pointwise2.weight, mod.pointwise2.bias), params):
            p.copy_(v.view_as(p))
    mask = torch.arange(t, device="cuda")[None, :] < lengths.long()[:, None]
    xe = x.detach().requires_grad_(True)
    fwd = lambda: mod(xe, mask)
    ye = fwd()
    leaves = [xe] + list(mod.parameters())
    bwd = lambda: torch.autograd.grad(ye, leaves, gb, retain_graph=True)
    out = {}
    for way, call in (("fwd", fwd), ("bwd", bwd)):
        # the profiler loses records (PERF.md §7): more windows, the same
        # rule (two windows with equal launches by kernel name)
        dev, launches, windows = device_ms(call, windows=10)
        odd = {k[:80]: c for k, c in launches.items() if c != int(c)}
        print(f"eager ConvModule {way} B={x.shape[0]} {x.dtype}: device "
              f"{dev:.4f} ms, {sum(launches.values()):g} launches a call "
              f"(the profiler window taken: number {windows}; kernels with "
              f"launches a call not whole: {odd})")
        out.update({f"{way}_ms": median_ms(torch, call),
                    f"{way}_device_ms": dev})
    return out


def transducer_train_phase(torch, card):
    """The transducer train step (fused_conv, the yaml's dropout 0.1) on 32
    x 15 s, U 64; returns the launch counts of the timed steps and the
    routed kernels' host counts over them."""
    from espnet_slurp_tpu_torch.models.transducer import TransducerModel
    from espnet_slurp_tpu_torch.utils.params import init_random_

    cfg = transducer_config()
    model = init_random_(TransducerModel(cfg, device="cuda"), seed=0)
    batch = train_batch(torch, np.random.RandomState(1), TR_B,
                        FS * TRAIN_SECONDS, TR_U, cfg.asr.vocab_size, "cuda")
    run = run_train_steps(
        torch, f"transducer train: B={TR_B} x {TRAIN_SECONDS} s, U={TR_U}, "
        f"V={cfg.asr.vocab_size}, fused_conv, dropout "
        f"{cfg.asr.dropout_rate}", model, batch, card, TR_B * TRAIN_SECONDS)
    launches, routes = run.launches, run.routes
    n_blocks = cfg.asr.num_encoder_blocks
    check_routes("transducer train", routes, {
        **dict.fromkeys(K1_WARP, 1), **dict.fromkeys(K5_WARP, 1),
        **dict.fromkeys(K6_BF16_LAUNCHES, n_blocks)}, TRAIN_STEPS)
    check_per_step("transducer train", launches, {
        "fused_ffn": 2 * n_blocks, "fused_ffn_bwd": 2 * n_blocks,
        "rel_flash_attention": n_blocks, "rel_flash_attention_bwd": n_blocks,
        "fused_conv_module": n_blocks, "fused_conv_module_bwd": n_blocks,
        "rnnt_lattice": 1, "rnnt_lattice_bwd": 1,
        "ctc_lattice": 1, "ctc_lattice_bwd": 1})
    return launches, routes


def transducer_cpu_vs_card(torch):
    """One fp32 transducer forward + backward (fused_conv, SpecAug off, the
    yaml's dropout DROPOUT with the same masks on both sides), CPU (plain
    versions) against the card (kernels), same weights."""
    from espnet_slurp_tpu_torch.models.transducer import TransducerModel
    from espnet_slurp_tpu_torch.utils.params import init_random_

    cfg = transducer_config(dtype="float32", specaug=None,
                            dropout_rate=DROPOUT)
    state = init_random_(TransducerModel(cfg, device="cpu"),
                         seed=0).state_dict()
    compare_cpu_card(torch, "fp32 transducer step", TransducerModel, cfg,
                     state, *short_batch(cfg.asr.vocab_size))


def short_batch(vocab: int):
    """Two short utterances (3 s, 2.1 s) and 12 / 8 labels, the inputs of
    both fp32 card-vs-CPU checks."""
    rng = np.random.RandomState(2)
    lens = np.asarray([48000, 33600], np.int32)
    speech = np.zeros((2, 48000), np.float32)
    for i, m in enumerate(lens):
        speech[i, :m] = rng.randn(m).astype(np.float32) * 0.1
    text = rng.randint(1, vocab - 1, size=(2, 12)).astype(np.int64)
    return speech, lens, text, np.asarray([12, 8], np.int32)


def compare_cpu_card(torch, what, model_cls, cfg, state, speech, lens, text,
                     tlens, extra=None, aux=None, pointer_stats=()):
    """loss within 1e-4 relative and every gradient within 1e-3 of max |ref|
    (floored at 1e-4 of the largest gradient entry), CPU against card; the
    parameters without a gradient (a module the loss never calls) the same
    on both sides, and named. ``extra`` adds batch keys (a biasing batch's
    trie and walk) and ``aux`` (model -> aux_loss_fn) an MBR term to the
    loss; then every stat of the loss's but acc within 1e-4 relative too.
    Each stat of ``pointer_stats`` must be reported, and above 0 on the
    CPU: the pointer and the gate worked, or their terms would compare 0.

    Each side's train forward draws its dropout seeds from a CPU generator
    seeded with DROPOUT_SEED (ops/kernels/philox.py:draw_seed draws on the
    CPU and copies the seed to the card), so both sides draw the same
    seeds, hence the same Philox masks; the two generators must end in the
    same state, advanced from their seed.

    A ReLU input (relu_inputs: the Conv2d subsampling's, VGG2L's, a
    post-encoder's length adaptors', the decoder's FFNs'; and the leaky
    ReLUs of the Sinc pre-encoder) that lies within fp32 rounding of 0 can
    fall on either side on the two devices; its gradient is then the
    upstream one on one side and 0 on the other, which moves the first
    conv's weight and bias gradients by up to 7e-3 of max |ref| (measured
    on other draws; a decoder FFN's w1 by 3.2e-2 in phase 24's Sinc model).
    Such kinks get gradient 0 on both sides: their forward value is ~0
    either way, and the comparison no longer depends on the draw. VGG2L's
    max-pools have the like near-ties: a window whose two largest inputs
    lie within rounding of each other routes its gradient to another
    element on each side (3.0e-3 of max |ref| at its first conv, phase
    24 (c));
    such windows' inputs get gradient 0 on both sides too."""
    runs, gens = {}, {}
    for dev in ("cpu", "cuda"):
        gens[dev] = torch.Generator().manual_seed(DROPOUT_SEED)
        model = model_cls(cfg, device=dev)
        model.load_state_dict(state)
        batch = {"speech": torch.from_numpy(speech).to(dev),
                 "speech_lengths": torch.from_numpy(lens).to(dev),
                 "text": torch.from_numpy(text).to(dev),
                 "text_lengths": torch.from_numpy(tlens).to(dev)}
        batch.update({k: torch.as_tensor(v).to(dev)
                      for k, v in (extra or {}).items()})
        # an SLU model's acoustic encoder is its ASR model's
        pre = []
        hooks = [m.register_forward_hook(
            lambda m, i, o, pool=pool: pre.append((pool, o)))
            for m, pool in relu_inputs(model)]
        loss, stats = model(**batch, train=True, generator=gens[dev])
        if aux is not None:  # its re-encode's convs are hooked too
            term, aux_stats = aux(model)(batch)
            loss, stats = loss + term, {**stats, **aux_stats}
        for hk in hooks:
            hk.remove()
        runs[dev] = (model, loss, pre, stats)
    fresh = torch.Generator().manual_seed(DROPOUT_SEED).get_state()
    same_draws = torch.equal(gens["cpu"].get_state(), gens["cuda"].get_state())
    drew = not torch.equal(gens["cpu"].get_state(), fresh)
    flips, pooled = [], []
    st_c, st_g = runs["cpu"][3], runs["cuda"][3]
    stat_err = {k: abs(float(st_g[k].detach()) - float(v.detach()))
                / max(abs(float(v.detach())), 1e-6)
                for k, v in st_c.items() if k != "acc"}
    for (pool, z_c), (_, z_g) in zip(runs["cpu"][2], runs["cuda"][2]):
        flip = (z_c > 0) != (z_g > 0).cpu()
        flips.append(int(flip.sum()))
        if pool:
            apart = pool_flips(torch, z_c, z_g.cpu())
            pooled.append(int(apart.sum()) // 4)
            flip = flip | apart
        for z in (z_c, z_g):
            if z.requires_grad:  # not a no-grad pass (MBR's n-best search)
                z.register_hook(
                    lambda g, f=flip.to(z.device): g.masked_fill(f, 0))
    res, no_grad = {}, {}
    for dev, (model, loss, _, _) in runs.items():
        loss.backward()
        res[dev] = (float(loss.detach()), {k: p.grad.detach().cpu()
                                  for k, p in model.named_parameters()
                                  if p.grad is not None})
        no_grad[dev] = sorted(k for k, p in model.named_parameters()
                              if p.grad is None)
    del runs
    (loss_c, g_c), (loss_g, g_g) = res["cpu"], res["cuda"]
    if no_grad["cpu"]:
        print(f"{what}: {len(no_grad['cpu'])} parameters without a gradient "
              f"on the CPU, {len(no_grad['cuda'])} on the card: "
              f"{no_grad['cpu']}")
    if no_grad["cpu"] != no_grad["cuda"]:
        raise AssertionError(f"{what}: parameters without a gradient differ: "
                             f"CPU {no_grad['cpu']}, card {no_grad['cuda']}")
    rel = abs(loss_g - loss_c) / abs(loss_c)
    floor = 1e-4 * max(float(x.abs().max()) for x in g_c.values())
    worst = max(((float((g_g[k] - r).abs().max())
                  / max(float(r.abs().max()), floor)), k)
                for k, r in g_c.items())
    print(f"{what} card vs CPU: loss {loss_g:.6f} vs {loss_c:.6f} "
          f"(rel {rel:.3e}, tolerance 1e-4); worst gradient {worst[1]} "
          f"{worst[0]:.3e} of max|ref| (tolerance 1e-3) over {len(g_c)} "
          f"tensors; ReLU kinks on opposite sides {flips}"
          + (f", max-pool windows chosen apart {pooled}" if pooled else "")
          + "; "
          f"dropout seeds drawn {drew}, the same on both sides {same_draws}")
    if extra is not None or aux is not None:
        shown = {k: round(float(v.detach()), 6) for k, v in st_g.items()}
        errs = {k: f"{e:.2e}" for k, e in stat_err.items()}
        print(f"{what} card vs CPU stats: {shown}; relative errors {errs} "
              f"(tolerance 1e-4)")
        if max(stat_err.values()) > 1e-4:
            raise AssertionError(f"{what} card vs CPU stats")
    missing = [k for k in pointer_stats if k not in st_c or k not in st_g]
    if missing:
        raise AssertionError(f"{what}: the loss reports no {missing}")
    idle = [k for k in pointer_stats if not float(st_c[k].detach()) > 0]
    if idle:
        raise AssertionError(f"{what}: {idle} not above 0 on the CPU")
    if not (rel <= 1e-4 and worst[0] <= 1e-3 and same_draws and drew):
        raise AssertionError(f"{what} card vs CPU")


def transducer_decode_phase(torch, card):
    """Speech2TextTransducer (greedy, fused_conv) on the serving traffic;
    returns the encode's launch counts."""
    from espnet_slurp_tpu_torch.models.transducer import TransducerModel
    from espnet_slurp_tpu_torch.tasks.asr_transducer import \
        Speech2TextTransducer
    from espnet_slurp_tpu_torch.utils.params import init_random_

    cfg = transducer_config()
    state = init_random_(TransducerModel(cfg, device="cpu"),
                         seed=0).state_dict()
    tokens = token_list(cfg.asr.vocab_size)
    s2t = Speech2TextTransducer(cfg, state, tokens, token_type="word",
                                device="cuda")
    rng = np.random.RandomState(0)
    speeches = [rng.randn(FS * UTT_SECONDS).astype(np.float32) * 0.1
                for _ in range(N_UTT)]
    t0 = time.perf_counter()
    s2t.decode_batch(speeches)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    names = ("fused_ffn", "rel_flash_attention", "fused_conv_module")
    zero_counts(names)
    routes0 = route_counts()
    t0 = time.perf_counter()
    texts = s2t.decode_batch(speeches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(names)
    routes = {k: n - routes0[k] for k, n in route_counts().items()}
    n_blocks = cfg.asr.num_encoder_blocks
    check_routes("transducer encode", routes, K6_BF16_FWD, n_blocks)
    print(f"transducer greedy decode: {N_UTT} x {UTT_SECONDS} s, max_len "
          f"{s2t.max_len}, 4 symbols per frame: wall {wall:.3f} s (first "
          f"call {warm_s:.3f} s), RTF {wall / (N_UTT * UTT_SECONDS):.5f} on "
          f"{card}; launches {launches}; hypothesis lengths "
          f"{[len(x.split()) for x in texts]}")
    if launches != {"fused_ffn": 2 * n_blocks,
                    "rel_flash_attention": n_blocks,
                    "fused_conv_module": n_blocks}:
        raise AssertionError(f"transducer encode launches {launches}")
    vocab = set(tokens) - {"<blank>", "<sos/eos>"}
    if len(texts) != N_UTT or not all(
            isinstance(x, str) and len(x.split()) <= s2t.max_len
            and set(x.split()) <= vocab for x in texts):
        raise AssertionError(f"malformed decode output: {texts!r:.500}")
    return launches


def train_cpu_vs_card(torch):
    """One fp32 forward + backward at the recipe's dropout DROPOUT (the same
    masks on both sides), CPU (plain versions) against the card (kernels),
    same flagship weights, two short utterances."""
    from espnet_slurp_tpu_torch.models.asr_model import (ASRModel,
                                                          flagship_config)
    from espnet_slurp_tpu_torch.utils.params import init_random_

    cfg = dataclasses.replace(flagship_config(), dtype="float32",
                              specaug=None, dropout_rate=DROPOUT)
    state = init_random_(ASRModel(cfg, device="cpu"), seed=0).state_dict()
    compare_cpu_card(torch, "fp32 train step", ASRModel, cfg, state,
                     *short_batch(cfg.vocab_size))


# The default ASRConfig's FFN width (the flagship's d_ff is 1024).
DEFAULT_D_FF = 2048


def instance_of(prefix, rate):
    """The instance name (build.launch_counts) of a kernels' name prefix at
    a rate: a prefix ending in "(" names a kernel that draws no mask (its
    one instantiation), any other the rate-0 instantiation (``...,
    false>``) at 0 and the dropout one (``..., true>``) above 0."""
    flag = "true>" if rate else "false>"
    if prefix.endswith("("):
        return prefix[:-1]
    return prefix + (flag if prefix.endswith("<") else " " + flag)


def wmma_launch_ms(torch, what, call, kernels):
    """The launches of call(rate) at rate 0 and at DROPOUT by the host
    counts: each of ``kernels`` (name prefixes, see instance_of) once and
    nothing else of K2 or K3, else the run fails; then torch.profiler's
    device ms a launch of each (None where 5 windows showed none). Returns
    {kernel: [ms at 0, ms at DROPOUT]}."""
    ms = {k: [] for k in kernels}
    for rate in (0.0, DROPOUT):
        want = {instance_of(k, rate): 1 for k in kernels}
        launched = instance_launches(torch, lambda: call(rate))
        if launched != want:
            raise AssertionError(f"{what} at rate {rate}: launched "
                                 f"{launched}, expected {want}")
        flag = "true>" if rate else "false>"
        hits = lambda got, k: [v for name, v in got.items() if k in name and (
            k.endswith("(") or flag in name)]
        got = port_kernels_ms(torch, lambda: call(rate), n=3, complete=lambda
                              got: all(len(hits(got, k)) == 1
                                       for k in kernels))
        for k in kernels:
            hit = hits(got, k)
            ms[k].append(hit[0] if len(hit) == 1 else None)
    return ms


def ms_text(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def total(values):
    """The sum of device times, None if one of them was not measured."""
    values = list(values)
    return None if None in values else sum(values)


# K2's fp32 launches (csrc/ffn.cu, ffn_f32) by profiler name prefix: their
# direction, their indices in espnet_fused_ffn_f32_info at rate 0 and with
# dropout, and the products each forms.
K2_F32_LAUNCHES = {
    "ffn_f32::hidden_kernel<": ("fwd", (0, 1), 1),
    "ffn_f32::out_kernel(": ("fwd", (2, 2), 1),
    "ffn_f32::rows_kernel<": ("bwd", (3, 4), 2),
    "ffn_f32::dx_kernel(": ("bwd", (5, 5), 1),
    "ffn_f32::dw_kernel(": ("bwd", (6, 6), 2),
}


def ffn_f32_info():
    """{kernel prefix: [(registers, static shared bytes, local bytes,
    blocks per SM) at rate 0, the same with dropout]} of K2's fp32
    launches, from the built library."""
    import ctypes
    from espnet_slurp_tpu_torch.ops.kernels import build
    out = {}
    for k, (_, idx, _) in K2_F32_LAUNCHES.items():
        rows = []
        for i in idx:
            buf = (ctypes.c_int * 4)()
            build.check(build.library().espnet_fused_ffn_f32_info(i, buf),
                        "fused_ffn fp32 kernel info")
            rows.append(tuple(buf))
        out[k] = rows
    return out


def ffn_f32_launch_bounds(n, d, f, d2, nsplit):
    """Bound (ms, by) of each fp32 launch: its own products (fp32 operands)
    and the bytes it must move, the [N, F] hidden scratch included."""
    parts = -(-n // 128)
    return {
        "ffn_f32::hidden_kernel<": bound(2.0 * n * d * f, 4 * (
            n * d + d * f + f + n * f), PEAK_FP32_FLOPS),
        "ffn_f32::out_kernel(": bound(2.0 * n * f * d2, 4 * (
            n * f + f * d2 + d2 + n * d2), PEAK_FP32_FLOPS),
        "ffn_f32::rows_kernel<": bound(2.0 * n * f * (d + d2), 4 * (
            n * d + d * f + f + f * d2 + n * d2 + 2 * n * f + parts * f),
            PEAK_FP32_FLOPS),
        "ffn_f32::dx_kernel(": bound(2.0 * n * f * d, 4 * (
            n * f + d * f + n * d), PEAK_FP32_FLOPS),
        "ffn_f32::dw_kernel(": bound(2.0 * n * f * (d + d2), 4 * (
            n * d + 2 * n * f + n * d2 + nsplit * (d * f + f * d2 + d2)),
            PEAK_FP32_FLOPS),
    }


def ffn_fp32_launches(torch, ffn, n, d, f, r):
    """K2's fp32 launches (ffn_f32: hidden_kernel and out_kernel forward,
    rows_kernel, dx_kernel and dw_kernel backward) on N rows of widths D,
    F at rates 0 and DROPOUT: forward and backward against
    fused_ffn_plain / fused_ffn_bwd_plain with the same seed, within
    TOL["float32"] of max |ref| per output and gradient; the launches by
    profiler name; each launch's device time at rate 0 beside DROPOUT, its
    share of its bound (fp32 operands: PEAK_FP32_FLOPS), its registers and
    blocks per SM; each direction's time (CUDA events) at DROPOUT beside
    its plain version's and the eager fp32 composition it replaces
    (F.linear -> F.silu -> F.dropout -> F.linear, no TF32; forward, and
    autograd's backward). Returns the two kernels-line entries. The inputs
    are bin/time_kernels.py's fp32 case at these widths."""
    from espnet_slurp_tpu_torch.bin.time_kernels import ffn_wmma_inputs
    from espnet_slurp_tpu_torch.ops.kernels import build

    args, g = ffn_wmma_inputs(r, n, d, f)
    x, w1, b1, w2, b2 = args
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device="cuda")
    fwd = lambda rate=DROPOUT: ffn._launch_fwd(*args, seed if rate else None,
                                               rate)
    bwd = lambda rate=DROPOUT: ffn._launch_bwd(
        x, w1, b1, w2, g, seed if rate else None, rate)
    names = ("out", "dx", "dw1", "db1", "dw2", "db2")
    for rate in (0.0, DROPOUT):
        sd = seed if rate else None
        got = (fwd(rate), *bwd(rate))
        ref = (ffn.fused_ffn_plain(*args, sd, dropout_rate=rate),
               *ffn.fused_ffn_bwd_plain(x, w1, b1, w2, g, sd,
                                        dropout_rate=rate))
        torch.cuda.synchronize()
        errs = [rel_err(a, b_) for a, b_ in zip(got, ref)]
        print(f"K2 fused_ffn float32 N={n} D={d} F={f} dropout {rate} "
              "against its plain versions, same seed: " + ", ".join(
                  f"{k} {e[1]:.3e}" for k, e in zip(names, errs))
              + f" of max|ref| (tolerance {TOL['float32']})")
        if not (max(e[1] for e in errs) <= TOL["float32"]
                and all(torch.isfinite(a).all() for a in got)):
            raise AssertionError(f"K2 fp32 at rate {rate} disagrees with its "
                                 "plain versions")
        del got, ref
    # errs are those at DROPOUT.
    launch = wmma_launch_ms(torch, "K2 fp32",
                            lambda rate: (fwd(rate), bwd(rate)),
                            tuple(K2_F32_LAUNCHES))
    info = ffn_f32_info()
    nsplit = build.library().espnet_fused_ffn_f32_dw_splits(
        n, d, f, d, torch.cuda.get_device_properties(0).multi_processor_count)
    lb = ffn_f32_launch_bounds(n, d, f, d, nsplit)
    bnd = ffn_bounds(n, d, f, d, 4, PEAK_FP32_FLOPS)
    launches = {}
    for k, (m0, m1) in launch.items():
        regs = [i[0] for i in info[k]]
        blocks = [i[3] for i in info[k]]
        spill = [i[2] for i in info[k]]
        launches[k] = dict(device_ms_rate0_vs_dropout=[m0, m1],
                           bound_ms=lb[k][0], bound_by=lb[k][1],
                           registers=regs, static_smem_bytes=info[k][0][1],
                           local_bytes=spill, blocks_per_sm=blocks)
        share = "?" if m1 is None else f"{100 * lb[k][0] / m1:.1f}"
        print(f"K2 fp32 launch {k.rstrip('<(')}: device {ms_text(m0)} ms at "
              f"rate 0 -> {ms_text(m1)} ms at {DROPOUT}; bound "
              f"{lb[k][0]:.4f} ms ({lb[k][1]}), {share}% of it at "
              f"{DROPOUT}; registers {regs}, local bytes {spill}, "
              f"{info[k][0][1]} B of shared memory, blocks per SM {blocks} "
              "(rate 0, dropout)")
    dev = {p: [total(v["device_ms_rate0_vs_dropout"][i]
                     for k, v in launches.items()
                     if K2_F32_LAUNCHES[k][0] == p) for i in (0, 1)]
           for p in ("fwd", "bwd")}
    for p in ("fwd", "bwd"):
        share = "?" if dev[p][1] is None else \
            f"{100 * bnd[p][0] / dev[p][1]:.1f}"
        print(f"K2 fp32 {p}: device {ms_text(dev[p][0])} -> "
              f"{ms_text(dev[p][1])} ms at rate 0 -> {DROPOUT}; bound "
              f"{bnd[p][0]:.4f} ms, {share}% of it at {DROPOUT}; "
              f"dW split {nsplit} ways")
    ms_f = median_ms(torch, fwd, warmup=1, reps=5)
    ms_b = median_ms(torch, bwd, warmup=1, reps=5)
    plain_f = median_ms(torch, lambda: ffn.fused_ffn_plain(
        *args, seed, dropout_rate=DROPOUT), warmup=1, reps=5)
    plain_b = median_ms(torch, lambda: ffn.fused_ffn_bwd_plain(
        x, w1, b1, w2, g, seed, dropout_rate=DROPOUT), warmup=1, reps=5)
    # The eager composition FeedForward's eager route runs, with autograd's
    # graph, as in training.
    eager_f, eager_b = ffn_eager_ms(torch, args, g, DROPOUT, warmup=1, reps=5)
    print(f"K2 fused_ffn float32 N={n} F={f} at dropout {DROPOUT}: forward "
          f"{ms_f:.4f} ms (plain {plain_f:.4f}, eager composition "
          f"{eager_f:.4f}), backward {ms_b:.4f} ms (plain {plain_b:.4f}, "
          f"eager composition {eager_b:.4f})")
    common = dict(route="cuda", source="espnet_slurp_tpu_torch/csrc/ffn.cu",
                  launches=None, dtype="float32", rate=DROPOUT,
                  shape=f"N {n}, D {d}, F {f}",
                  library_note="the eager fp32 composition F.linear -> "
                               "F.silu -> F.dropout -> F.linear (autograd's "
                               "backward), no TF32")
    part = lambda p: {k.rstrip("<("): v for k, v in launches.items()
                      if K2_F32_LAUNCHES[k][0] == p}
    return [
        dict(name="fused_ffn_fp32", **common,
             replaces="espnet_slurp_tpu/ops/pallas/ffn.py:186",
             max_abs_err=errs[0][0], ms=ms_f, plain_ms=plain_f,
             bound_ms=bnd["fwd"][0], bound_by=bnd["fwd"][1],
             library_ms=eager_f, device_ms_rate0_vs_dropout=dev["fwd"],
             launch_detail=part("fwd")),
        dict(name="fused_ffn_bwd_fp32", **common,
             replaces="espnet_slurp_tpu/ops/pallas/ffn.py:206",
             max_abs_err=max(e[0] for e in errs[1:]), ms=ms_b,
             plain_ms=plain_b, bound_ms=bnd["bwd"][0],
             bound_by=bnd["bwd"][1], library_ms=eager_b,
             device_ms_rate0_vs_dropout=dev["bwd"], dw_splits=nsplit,
             launch_detail=part("bwd")),
    ]


def ctc_head_f32_launch_bounds(b, t, d, v, s, plan):
    """Bound (ms, by) of each fp32 launch: its own products (fp32 operands)
    and the bytes it must move: lse's (max, sum) pairs, the dlg scratch [N,
    V rounded up to 4] and the dbias and dW partials included."""
    n, (vs, nsplit) = b * t, plan
    vp, parts = -(-v // 4) * 4, -(-n // 128)
    proj = 2.0 * n * d * v
    return {
        "ctc_head_f32::lse_kernel": bound(
            proj, 4 * (n * d + d * v + v) + 8 * vs * n, PEAK_FP32_FLOPS),
        "ctc_head_fwd::gather_kernel<float>": bound(
            2.0 * n * d * s, 4 * (n * d + d * v + v + b * s + n * s + n)
            + 8 * vs * n, PEAK_FP32_FLOPS),
        "ctc_head_f32::rows_kernel": bound(
            proj, 4 * (n * d + d * v + v + b * s + 2 * n + n * s + n * vp
                       + parts * v), PEAK_FP32_FLOPS),
        "ctc_head_f32::dx_kernel": bound(
            proj, 4 * (n * vp + d * v + n * d), PEAK_FP32_FLOPS),
        "ctc_head_f32::dw_kernel": bound(
            proj, 4 * (n * vp + n * d + nsplit * v * d), PEAK_FP32_FLOPS),
    }


def ctc_head_fp32(torch, kh, t_prime, r, gen):
    """K4's fp32 route (ctc_head_f32: lse and gather forward, rows, dx and
    dw backward, on csrc/sgemm.cuh's mainloop; the default ASRConfig's) at
    the flagship train shape (B 64, T', D 256, V 5000, U 64, blanks between
    labels): forward and backward against its plain version's output and
    autograd gradients within TOL["float32"] of max |ref|; the five launches
    by profiler name (the first version's fp32 kernels absent) with the
    library's plan, each launch's device time, bound, registers, shared
    bytes and blocks per SM; each direction timed (CUDA events) beside its
    plain version, its fp32 bound and the eager composition of its function
    (F.linear -> log_softmax -> gather, and autograd's backward of it to hs,
    W and the bias), with F.ctc_loss over a log-softmax of the same
    projection (K4 and K1 together) as a note; what one backward call adds
    to peak memory. Returns the two kernels-line entries."""
    import torch.nn.functional as F
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.ops.kernels import ctc as kctc

    cfg = flagship_config()
    b, t, u, d, v = TRAIN_B, t_prime, TRAIN_U, cfg.d_model, cfg.vocab_size
    n, s = b * t, 2 * u + 1
    labels = torch.randint(1, v - 1, (b, u), generator=gen, device="cuda")
    ulen = torch.tensor([u - (i % 5) for i in range(b)], device="cuda")
    ext = kctc.extend_labels(labels, ulen)[0].to(torch.int32)
    hs, w, bias = r(b, t, d) * 0.5, r(v, d) * d ** -0.5, r(v) * 0.1
    cot = r(b, t, s)
    args = (hs, w, bias, ext)
    o, g, _ = grad_case(torch, kh.fused_ctc_head_emit, args, cot, 3)
    ro, rg, plain_bwd = grad_case(torch, kh.fused_ctc_head_emit_plain, args,
                                  cot, 3)
    err_o, err_g = hold(torch, f"K4 fused_ctc_head_emit float32 B={b} T={t} "
                        f"V={v} S={s}", o, ro, g, rg, ("dhs", "dw", "db"),
                        TOL["float32"])
    del o, g, ro, rg
    _, z = kh._launch_fwd(*args)
    fwd = lambda: kh._launch_fwd(*args)
    bwd = lambda: kh._launch_bwd(hs, w, bias, ext, z, cot)
    plan = kh._plan(n, d, v, torch.float32, hs.device)
    check_routes("K4 fp32 both ways", routes_of(lambda: (fwd(), bwd())),
                 K4_F32_LAUNCHES)
    got = port_kernels_ms(torch, lambda: (fwd(), bwd()), n=3,
                          expect=tuple(K4_F32_LAUNCHES))
    k4_gone_check(torch, got)
    launches = launch_table("K4 fp32", got, ctc_head_info(0),
                            ctc_head_f32_launch_bounds(b, t, d, v, s, plan))
    dev = {p: sum(x["device_ms"] for k, x in launches.items()
                  if K4_F32_LAUNCHES[k] == p) for p in ("fwd", "bwd")}
    ms_f = median_ms(torch, fwd, warmup=1, reps=5)
    ms_b = median_ms(torch, bwd, warmup=1, reps=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bwd()
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    plain_f = median_ms(torch, lambda: kh.fused_ctc_head_emit_plain(*args),
                        warmup=1, reps=5)
    plain_b = median_ms(torch, plain_bwd, warmup=1, reps=5)
    del plain_bwd
    eager_f, eager_b = head_eager_ms(torch, args, cot, warmup=1, reps=5)
    tlen = torch.full((b,), t, dtype=torch.long, device="cuda")
    leaves = [a.detach().clone().requires_grad_(True) for a in (hs, w, bias)]
    ctc = lambda: F.ctc_loss(F.log_softmax(F.linear(*leaves), -1)
                             .transpose(0, 1), labels, tlen, ulen, blank=0,
                             reduction="none", zero_infinity=True)
    ctc_f = median_ms(torch, ctc, warmup=1, reps=5)
    loss = ctc()
    ctc_b = median_ms(torch, lambda: torch.autograd.grad(
        loss, leaves, torch.ones_like(loss), retain_graph=True),
        warmup=1, reps=5)
    del loss, leaves
    fbound = bound(2.0 * n * d * v, 4 * (n * d + d * v + v + n * s
                                                + n) + 4 * b * s,
                   PEAK_FP32_FLOPS)
    bbound = bound(6.0 * n * d * v, 4 * (2 * n * d + 2 * d * v + 2 * v
                                         + n * s + n) + 4 * b * s,
                   PEAK_FP32_FLOPS)
    print(f"K4 fused_ctc_head_emit float32 B={b} T={t} V={v}: plan {plan} "
          f"(lse's V splits, dW splits); forward "
          f"{ms_f:.4f} ms, device {dev['fwd']:.4f} (plain {plain_f:.4f}, "
          f"eager composition {eager_f:.4f}; bound {fbound[0]:.4f} ms by "
          f"{fbound[1]}, {100 * fbound[0] / dev['fwd']:.1f}% of it), backward "
          f"{ms_b:.4f} ms, device {dev['bwd']:.4f} (plain {plain_b:.4f}, "
          f"eager composition {eager_b:.4f}; bound {bbound[0]:.4f} ms by "
          f"{bbound[1]}, {100 * bbound[0] / dev['bwd']:.1f}% of it); one "
          f"backward call adds {peak_mb:.1f} MB at its peak; F.ctc_loss over "
          f"a log-softmax of the projection (K4 and K1) {ctc_f:.4f} / "
          f"{ctc_b:.4f} ms")
    common = dict(route="cuda", source="espnet_slurp_tpu_torch/csrc/ctc_head.cu",
                  launches=None, dtype="float32",
                  shape=f"B {b}, T {t}, D {d}, V {v}, S {s}", plan=plan,
                  library_note="the eager fp32 composition F.linear -> "
                               "log_softmax -> gather (autograd's backward), "
                               "no TF32",
                  ctc_loss_note="F.ctc_loss over log_softmax(hs W^T + b): "
                                "the projection, the softmax and the lattice "
                                "(K4 and K1)")
    part = lambda p: {k: x for k, x in launches.items()
                      if K4_F32_LAUNCHES[k] == p}
    return [
        dict(name="fused_ctc_head_emit_fp32", **common,
             replaces="espnet_slurp_tpu/ops/pallas/ctc_head.py:160",
             max_abs_err=err_o, ms=ms_f, plain_ms=plain_f,
             bound_ms=fbound[0], bound_by=fbound[1], library_ms=eager_f,
             device_ms=dev["fwd"], ctc_loss_ms=ctc_f,
             launch_detail=part("fwd")),
        dict(name="fused_ctc_head_emit_bwd_fp32", **common,
             replaces="espnet_slurp_tpu/ops/pallas/ctc_head.py:179",
             max_abs_err=err_g, ms=ms_b, plain_ms=plain_b,
             bound_ms=bbound[0], bound_by=bbound[1], library_ms=eager_b,
             device_ms=dev["bwd"], ctc_loss_ms=ctc_b, peak_mb=peak_mb,
             launch_detail=part("bwd")),
    ]


def attention_wmma_dropout(torch, fa, b, h, t, dh, dtype, r, label):
    """K3's launches in fp32 (the register micro-tile kernels
    rel_f32::fwd_kernel, dkv_kernel, dq_kernel) or in bf16 at Dh 128 (the
    WMMA rel_flash_fwd_kernel, rel_flash_dkv_kernel, rel_flash_dq_kernel)
    at rates 0 and DROPOUT (B x H x T x Dh, key lengths T - 3 b): out and
    lse against rel_flash_attention_plain (fp32) or
    rel_flash_attention_fwd_tiled_plain at the kernel's key tile of 64
    (bf16), the backward against rel_flash_attention_bwd_plain, same seed,
    within TOL[dtype] of max |ref| per output and gradient (lse within
    1e-4); the launches by profiler name; each launch's device time at
    rate 0 beside DROPOUT, and its bound; each direction's time (CUDA
    events) at DROPOUT beside its plain version's and SDPA's over the
    precomputed bias. Returns the two kernels-line entries, named with
    ``label``. The inputs are bin/time_kernels.py's WMMA case at these
    shapes."""
    from espnet_slurp_tpu_torch.bin.time_kernels import attention_wmma_inputs

    name = str(dtype).split(".")[-1]
    if dtype == torch.float32:
        kernels = tuple(f"rel_f32::{k}_kernel<{dh},"
                        for k in ("fwd", "dkv", "dq"))
    else:
        kernels = ("rel_flash_fwd_kernel<__nv_bfloat16, 64, 64,",
                   "rel_flash_dkv_kernel<__nv_bfloat16, 32, 32,",
                   "rel_flash_dq_kernel<__nv_bfloat16, 32, 32,")
    args, g = attention_wmma_inputs(r, dtype, h, dh, b, t)
    lengths = args[-1]
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device="cuda")
    scale = dh ** -0.5
    fwd = lambda rate=DROPOUT: fa._launch_fwd(*args, scale, 0, -1,
                                              seed if rate else None, rate)
    names = ("out", "dq_u", "dq_v", "dk", "dv", "dp")
    for rate in (0.0, DROPOUT):
        kw = dict(scale=scale, dropout_rate=rate)
        sd = seed if rate else None
        out, lse = fwd(rate)
        bwd = lambda rate=DROPOUT: fa._launch_bwd(
            *args, out, lse, g, scale, 0, -1, seed if rate else None, rate)
        if dtype == torch.float32:
            plain_fwd = lambda: fa.rel_flash_attention_plain(*args, sd, **kw)
        else:
            plain_fwd = lambda: fa.rel_flash_attention_fwd_tiled_plain(
                *args, sd, block_k=64, **kw)
        plain_bwd = lambda: fa.rel_flash_attention_bwd_plain(
            *args, out, lse, g, sd, **kw)
        grads = bwd(rate)
        ref, ref_lse = plain_fwd()
        ref_grads = plain_bwd()
        torch.cuda.synchronize()
        errs = [rel_err(a, b_)
                for a, b_ in zip((out, *grads), (ref, *ref_grads))]
        rel_lse = rel_err(lse, ref_lse)[1]
        print(f"K3 rel_flash_attention {name} B={b} H={h} T={t} Dh={dh} "
              f"dropout {rate} against its plain versions, same seed: "
              + ", ".join(f"{k} {e[1]:.3e}" for k, e in zip(names, errs))
              + f" of max|ref| (tolerance {TOL[name]}); lse {rel_lse:.3e} "
              "(undropped; tolerance 1e-4)")
        if not (max(e[1] for e in errs) <= TOL[name] and rel_lse <= 1e-4
                and all(torch.isfinite(a).all() for a in (out, *grads))):
            raise AssertionError(f"K3 {name} Dh {dh} at rate {rate} "
                                 "disagrees with its plain versions")
        del grads, ref, ref_lse, ref_grads
    # out, lse, the plain versions and errs are those at DROPOUT.
    launch = wmma_launch_ms(
        torch, f"K3 {name} Dh {dh}", lambda rate: (fwd(rate), bwd(rate)),
        kernels)
    allowed = fa.allowed_mask(t, lengths)
    pairs = float(allowed.expand(b, 1, t, t).sum().item()) * h
    esize = 4 if dtype == torch.float32 else 2
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    bnd = att_bounds(b, h, t, dh, pairs, esize, peak)
    for (k, (m0, m1)), part in zip(launch.items(), ("fwd", "dkv", "dq")):
        print(f"K3 {name} Dh {dh} launch {k.split('<')[0]}: device "
              f"{ms_text(m0)} ms at rate 0 -> {ms_text(m1)} ms at {DROPOUT}; "
              f"bound {bnd[part][0]:.4f} ms ({bnd[part][1]})")
    ms_f = median_ms(torch, fwd, warmup=1, reps=5)
    ms_b = median_ms(torch, bwd, warmup=1, reps=5)
    plain_f = median_ms(torch, plain_fwd, warmup=1, reps=3)
    plain_b = median_ms(torch, plain_bwd, warmup=1, reps=3)
    q_u, q_v, k, v, pp, _ = args
    raw = q_v @ pp[:, :2 * t - 1].transpose(-1, -2)
    bd = raw.gather(-1, fa.rel_shift_index(t, raw.device).expand(b, h, t, t))
    bias = torch.where(allowed, bd * scale, fa.NEG).to(dtype)
    del raw, bd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        lib_f = median_ms(torch, lambda: sdpa(q_u, k, v, attn_mask=bias,
                                              scale=scale),
                          warmup=1, reps=5)
    leaves = [a.detach().requires_grad_(True) for a in (q_u, k, v)]
    sd = sdpa(*leaves, attn_mask=bias, scale=scale)
    lib_b = median_ms(torch, lambda: torch.autograd.grad(
        sd, leaves, g, retain_graph=True), warmup=1, reps=5)
    del sd, leaves, bias
    print(f"K3 rel_flash_attention {name} Dh {dh} at dropout {DROPOUT}: "
          f"forward {ms_f:.4f} ms (plain {plain_f:.4f}, SDPA {lib_f}), "
          f"backward {ms_b:.4f} ms (plain {plain_b:.4f}, SDPA {lib_b})")
    common = dict(route="cuda",
                  source="espnet_slurp_tpu_torch/csrc/flash_attention.cu",
                  launches=None, dtype=name, rate=DROPOUT,
                  shape=f"B {b}, H {h}, T {t}, Dh {dh}")
    devs = {k.split("<")[0]: v for k, v in launch.items()}
    return [
        dict(name=f"rel_flash_attention_{label}", **common,
             replaces="espnet_slurp_tpu/ops/pallas/flash_attention.py:336",
             max_abs_err=errs[0][0], ms=ms_f, plain_ms=plain_f,
             bound_ms=bnd["fwd"][0], bound_by=bnd["fwd"][1], library_ms=lib_f,
             device_ms_rate0_vs_dropout={
                 k: v for k, v in devs.items() if "fwd" in k}),
        dict(name=f"rel_flash_attention_bwd_{label}", **common,
             replaces="espnet_slurp_tpu/ops/pallas/flash_attention.py:379",
             max_abs_err=max(e[0] for e in errs[1:]), ms=ms_b,
             plain_ms=plain_b, bound_ms=bnd["bwd"][0],
             bound_by=bnd["bwd"][1], library_ms=lib_b,
             device_ms_rate0_vs_dropout={
                 k: v for k, v in devs.items() if "fwd" not in k},
             launch_bounds_ms={k: bnd[k][0] for k in ("dkv", "dq")}),
    ]


def wmma_dropout_phase(torch, t_prime):
    """The launches of the default ASRConfig's fp32 path and the WMMA ones at
    the flagship train shape, at rates 0 and DROPOUT: K2 fp32 (N 64 x T', D
    256, F DEFAULT_D_FF: the ffn_f32 launches), K3 fp32 (B 64, H 4, T', Dh
    64: the register micro-tile kernels) and K3 bf16 at Dh 128 (B 64, H 2,
    T': the WMMA ones), both ways; then K4's fp32 route (no dropout).
    Returns the kernels-line entries of the fp32 launches (the default
    ASRConfig's path) and the records of the Dh-128 pair (on no model's
    path), by kernel name."""
    from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh
    from espnet_slurp_tpu_torch.ops.kernels import ffn
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    entries = ffn_fp32_launches(torch, ffn, TRAIN_B * t_prime, 256,
                                DEFAULT_D_FF, r)
    torch.cuda.empty_cache()
    entries += attention_wmma_dropout(torch, fa, TRAIN_B, 4, t_prime, 64,
                                      torch.float32, r, "fp32")
    torch.cuda.empty_cache()
    wide = attention_wmma_dropout(torch, fa, TRAIN_B, 2, t_prime, 128,
                                  torch.bfloat16, r, "bf16_dh128")
    torch.cuda.empty_cache()
    entries += ctc_head_fp32(torch, kh, t_prime, r, gen)
    torch.cuda.empty_cache()
    return entries, {k["name"].replace("_bf16_dh128", ""): k for k in wide}


def default_train_phase(torch, card):
    """The default ASRConfig() (fp32, dropout 0.1, d_ff 2048, 12 x 256, a
    6-block decoder, SpecAug on, flash "auto"; seeded random weights)
    through make_train_step with Adam at constant lr 1e-3 on the flagship
    bench traffic (64 x 15 s, U 64): a warm-up step, then TRAIN_STEPS timed
    ones (3 if more would run past ~60 s), with exactly 24 K2 and 12 K3
    launches each way and 1 K4 and 1 K1 each way a step. Returns the
    launch counts of the timed steps, per step."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
    from espnet_slurp_tpu_torch.utils.params import init_random_

    cfg = ASRConfig()
    model = init_random_(ASRModel(cfg, device="cuda"), seed=0)
    batch = train_batch(torch, np.random.RandomState(0), TRAIN_B,
                        FS * TRAIN_SECONDS, TRAIN_U, cfg.vocab_size, "cuda")
    run = run_train_steps(
        torch, f"default ASRConfig train: {cfg.dtype}, d_ff {cfg.d_ff}, "
        f"dropout {cfg.dropout_rate}, B={TRAIN_B} x {TRAIN_SECONDS} s, "
        f"U={TRAIN_U}", model, batch, card, TRAIN_B * TRAIN_SECONDS,
        budget_s=60.0)
    launches, step_s, busy_ms, steps, routes = run[:5]
    n_blocks = cfg.num_encoder_blocks
    check_per_step("default ASRConfig train", launches, {
        "fused_ffn": 2 * n_blocks, "fused_ffn_bwd": 2 * n_blocks,
        "rel_flash_attention": n_blocks, "rel_flash_attention_bwd": n_blocks,
        "fused_ctc_head_emit": 1, "fused_ctc_head_emit_bwd": 1,
        "ctc_lattice": 1, "ctc_lattice_bwd": 1}, steps)
    check_routes("default ASRConfig train", routes,
                 K1_WARP + tuple(K4_F32_LAUNCHES), steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"default ASRConfig train: step {step_s:.4f} s, "
          f"{TRAIN_B * TRAIN_SECONDS / step_s:.1f} audio-s/s, device busy "
          f"{busy_ms:.2f} ms a profiled step, on {card}")
    del model, batch
    torch.cuda.empty_cache()
    return ({k: v // steps for k, v in launches.items()}, launches,
            dict(step_s=step_s, busy_ms=busy_ms, peak_gb=peak_gb))


def fused_conv_train_phase(torch, card, default, t_prime):
    """ASRConfig(fused_conv=True) (the default config with its conv modules
    on K6's fp32 route) through make_train_step as default_train_phase
    runs ASRConfig(), one warm-up and TRAIN_STEPS timed steps (the loss on
    this traffic rises at the third of them with or without fused_conv,
    and falls by the fifth): losses finite, nothing
    skipped, the loss falls, and per step exactly 24 K2, 12 K3 and 12 K6
    launches each way and 1 K4 (fp32) and 1 K1 (warp route) each way; by
    the host counts K6 on conv_f32's launches only (12 of each a step, no
    bf16 one). Prints the step beside ``default`` (default_train_phase's
    step s, busy ms and peak GB) and what one K6 backward call holds in
    scratch at T' t_prime. Returns the launch counts of the timed steps,
    per step and in all."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
    from espnet_slurp_tpu_torch.utils.params import init_random_

    cfg = ASRConfig(fused_conv=True)
    model = init_random_(ASRModel(cfg, device="cuda"), seed=0)
    batch = train_batch(torch, np.random.RandomState(0), TRAIN_B,
                        FS * TRAIN_SECONDS, TRAIN_U, cfg.vocab_size, "cuda")
    what = "ASRConfig(fused_conv=True) train"
    launches, step_s, busy_ms, steps, routes = run_train_steps(
        torch, f"{what}: {cfg.dtype}, d_ff {cfg.d_ff}, dropout "
        f"{cfg.dropout_rate}, B={TRAIN_B} x {TRAIN_SECONDS} s, U={TRAIN_U}",
        model, batch, card, TRAIN_B * TRAIN_SECONDS)[:5]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_blocks = cfg.num_encoder_blocks
    check_per_step(what, launches, {
        "fused_ffn": 2 * n_blocks, "fused_ffn_bwd": 2 * n_blocks,
        "rel_flash_attention": n_blocks, "rel_flash_attention_bwd": n_blocks,
        "fused_conv_module": n_blocks, "fused_conv_module_bwd": n_blocks,
        "fused_ctc_head_emit": 1, "fused_ctc_head_emit_bwd": 1,
        "ctc_lattice": 1, "ctc_lattice_bwd": 1}, steps)
    check_routes(what, routes, {
        **dict.fromkeys(K1_WARP + tuple(K4_F32_LAUNCHES), 1),
        **dict.fromkeys(K6_F32_LAUNCHES, n_blocks)}, steps)
    # A K6 backward call's scratch at this shape: g, sig, dc, sw [N, D] and
    # du [N, 2D] fp32, and its partials.
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    n, d, k = TRAIN_B * t_prime, cfg.d_model, cfg.kernel_size
    tiles = TRAIN_B * -(-t_prime // 32)
    nsplit = kc.dw_splits(n, d, "cuda", torch.float32)
    scratch_mb = 4 * (6 * n * d + tiles * (3 * d + d * k + 2 * d)
                      + nsplit * (3 * d * d + d)) / 1e6
    print(f"{what}: step {step_s:.4f} s, {TRAIN_B * TRAIN_SECONDS / step_s:.1f}"
          f" audio-s/s, device busy {busy_ms:.2f} ms, peak {peak_gb:.2f} GB; "
          f"ASRConfig() in the same run: step {default['step_s']:.4f} s "
          f"({100 * (step_s / default['step_s'] - 1):+.1f}%), busy "
          f"{default['busy_ms']:.2f} ms, peak {default['peak_gb']:.2f} GB "
          f"({1e3 * (peak_gb - default['peak_gb']):+.1f} MB); one K6 "
          f"backward call holds {scratch_mb:.1f} MB of scratch (g, sig, dc, "
          f"sw, du and the partials) on {card}")
    del model, batch
    torch.cuda.empty_cache()
    return {k: v // steps for k, v in launches.items()}, launches



# Phase 15: the flagship through the port's own CLIs on a synthetic corpus
# (written under the gitignored build/, removed at the end of the phase):
# CLI_TRAIN train and CLI_DEV dev utterances of UTT_SECONDS s, CLI_WORDS
# words each (about 64 char tokens), batches of CLI_BATCH; then one epoch
# of CLI_PACE_TRAIN train utterances (16 steps), whose steps after the
# first show whether the data producer or the step paces an epoch.
CLI_TRAIN, CLI_DEV, CLI_WORDS, CLI_BATCH = 128, 16, 10, 64
CLI_PACE_TRAIN = 1024
CLI_ROOT = "build/chip_smoke_cli"


def cli_split(d, split, count, rng):
    """d/{wav.scp,text} (data/mini_corpus.py's layout and tones): count
    utterances of CLI_WORDS words each, a tone per word at its frequency,
    under noise."""
    from espnet_slurp_tpu_torch.data.fileio import DatadirWriter, write_wav
    from espnet_slurp_tpu_torch.data.mini_corpus import WORDS

    freqs = {w: 220.0 * 2 ** (i / 4.0) for i, w in enumerate(WORDS)}
    n, seg = FS * UTT_SECONDS, FS * UTT_SECONDS // CLI_WORDS
    t = np.arange(seg) / FS
    (d / "wav").mkdir(parents=True, exist_ok=True)
    with DatadirWriter(d) as w:
        for i in range(count):
            words = [WORDS[j] for j in rng.randint(len(WORDS),
                                                   size=CLI_WORDS)]
            wav = np.concatenate([0.3 * np.sin(2 * np.pi * freqs[x] * t)
                                  for x in words])
            wav = np.pad(wav, (0, n - len(wav))) + 0.01 * rng.randn(n)
            uid = f"{split}_{i:04d}"
            path = (d / "wav" / f"{uid}.wav").resolve()
            write_wav(str(path), wav.astype(np.float32), FS)
            w["wav.scp"][uid] = str(path)
            w["text"][uid] = " ".join(words)
    return d


def cli_corpus(root):
    """root/{train,dev}: CLI_TRAIN and CLI_DEV utterances (cli_split), plus
    dev8/, the first N_UTT dev utterances. Returns the three directories."""
    rng = np.random.RandomState(7)
    dirs = [cli_split(root / split, split, count, rng)
            for split, count in (("train", CLI_TRAIN), ("dev", CLI_DEV))]
    dev8 = root / "dev8"
    dev8.mkdir()
    for name in ("wav.scp", "text"):
        lines = (root / "dev" / name).read_text().splitlines()[:N_UTT]
        (dev8 / name).write_text("\n".join(lines) + "\n")
    return dirs + [dev8]


def cli_train_yaml(root, train_dir, dev_dir, max_epoch, exp="exp"):
    """The train config into root/exp: flagship_config()'s model at dropout
    DROPOUT with SpecAug on (its vocab from the corpus), Adam at a constant
    1e-3 (phase 5's optimizer), char tokens, sorted batches of
    CLI_BATCH."""
    import yaml
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.utils.config import to_dict

    model = to_dict(dataclasses.replace(flagship_config(),
                                        dropout_rate=DROPOUT))
    del model["vocab_size"]
    cfg = {"exp_dir": str(root / exp), "max_epoch": max_epoch,
           "model": model,
           "optim": {"name": "adam", "lr": 1e-3, "scheduler": "constant"},
           "data": {"train_dir": str(train_dir), "valid_dir": str(dev_dir),
                    "token_type": "char", "batch_type": "sorted",
                    "batch_size": CLI_BATCH}}
    path = root / f"train_{exp}_{max_epoch}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def step_recorder(torch, per_step, clock, task=None):
    """Wraps the make_train_step of ``task`` (default tasks/asr.py) so that
    every train step of the CLI appends its launches to per_step: (the
    wrappers' counts, the host counts by instance, the step's N = B x T'
    rows: of waveforms, or of a feature dump's frames), and (entry, exit)
    host times to clock. Returns the original."""
    from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
    from espnet_slurp_tpu_torch.ops.kernels import build
    if task is None:
        from espnet_slurp_tpu_torch.tasks import asr as task

    make = task.make_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def counted_step(state, batch):
            t0 = time.perf_counter()
            wrappers, hosts = read_counts(), build.launch_counts()
            out = step(state, batch)
            clock.append((t0, time.perf_counter()))
            b, n = batch["speech"].shape[:2]
            # waveforms (hop 128), or a feature dump's frames
            frames = n if batch["speech"].ndim > 2 else 1 + n // 128
            t_prime = Conv2dSubsampling.out_length_static(frames)
            per_step.append((
                {k: v - wrappers[k] for k, v in read_counts().items()},
                build.launch_delta(hosts, build.launch_counts()),
                b * t_prime))
            return out
        return counted_step

    task.make_train_step = recording
    return make


def cli_step_want(n_rows, n_blocks, n_ffn=None):
    """The launches of one flagship train step at dropout DROPOUT on n_rows
    rows: by the wrappers' counts, and by the host counts (K2 and K3 by
    instance, the dropout ones; K4's bf16 route; K1's warp route). K2
    runs n_ffn times each way (two FFNs a block unless given: a routed MoE
    second FFN is no K2 launch)."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    if n_ffn is None:
        n_ffn = 2 * n_blocks
    wrappers = flagship_step_want(n_blocks, n_ffn=n_ffn)
    hosts = {"ffn_fwd::fwd_kernel<256, true>": n_ffn,
             "ffn_bwd::rows_kernel<true>": n_ffn,
             "ffn_bwd::dx_kernel": n_ffn,
             "ffn_bwd::dw_kernel": n_ffn,
             "rel_fwd::fwd_kernel<64, true>": n_blocks,
             "rel_dkv::dkv_kernel<64, true>": n_blocks,
             "rel_dq::dq_kernel<64, true>": n_blocks,
             **dict.fromkeys(K4_BF16_LAUNCHES, 1),
             **dict.fromkeys(K1_WARP, 1)}
    if build.library().espnet_fused_ffn_fwd_splits(n_rows, 256, 1024,
                                                   256) > 1:
        hosts["ffn_fwd::reduce_kernel"] = n_ffn
    return {k: wrappers.get(k, 0) for k in COUNTED}, hosts


def cli_kernel_check(torch, exp):
    """K4 (both dtypes) and K1 at this corpus's V and S by
    hold_ctc_kernels: hs [CLI_BATCH, T', 256] and the first train batch's
    labels (data/collate.py's int32)."""
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask, load_task_config

    from espnet_slurp_tpu_torch.data.prefetch import to_device

    cfg = load_task_config(str(exp / "config.yaml"))
    tok, conv, mcfg = ASRTask.prepare_vocab(cfg)
    ds = ASRTask.build_dataset(cfg.data.train_dir, tok, conv)
    t0 = time.perf_counter()
    batch = next(iter(ASRTask.build_iter_factory(cfg, ds, shuffle=False)(1)))
    t1 = time.perf_counter()
    to_device(batch, "cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"phase 15: one batch of {CLI_BATCH} x {UTT_SECONDS} s on the "
          f"host alone: read, tokenised and collated {t1 - t0:.4f} s, to the "
          f"card through pinned memory {t2 - t1:.4f} s")
    labels = torch.from_numpy(batch["text"]).cuda()
    ulen = torch.from_numpy(batch["text_lengths"]).cuda()
    u, v = int(ulen.max()), mcfg.vocab_size
    t = bucket_t_prime(batch["speech"].shape[1])
    hold_ctc_kernels(torch, "phase 15", labels, ulen, t, 256, v, 15)
    return dict(vocab=v, u_max=u, s_max=2 * u + 1, t_prime=t)


def hold_ctc_kernels(torch, what, labels, ulen, t, d, v, seed, tlen=None):
    """K4 (both dtypes) and K1 at hs [B, t, d], W [v, d] and these labels
    (int32, lengths ulen; S = 2 max(ulen) + 1): each against its plain
    version both ways within phase 4's tolerances, K4's bf16 backward also
    against fused_ctc_head_emit_bwd_plain (the kernels' rounding points)
    within BWD_PLAIN_TOL, on K4's bf16 / fp32 routes and K1's warp route by
    the host counts; K1 over frame lengths tlen (default all t)."""
    from espnet_slurp_tpu_torch.ops.kernels import ctc as kctc
    from espnet_slurp_tpu_torch.ops.kernels import ctc_head as kh

    b = labels.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    ext, skip, smax, last = kctc.extend_labels(labels, ulen)
    ext32 = ext.to(torch.int32)
    s = ext.shape[1]
    hs0, w0, b0 = r(b, t, d) * 0.5, r(v, d) * d ** -0.5, r(v) * 0.1
    cot = r(b, t, s)
    for dt, launches in ((torch.bfloat16, K4_BF16_LAUNCHES),
                         (torch.float32, K4_F32_LAUNCHES)):
        name = str(dt).split(".")[-1]
        args = (hs0.to(dt), w0.to(dt), b0, ext32)
        before = route_counts()
        o, g, _ = grad_case(torch, kh.fused_ctc_head_emit, args, cot, 3)
        after = route_counts()
        ro, rg, _ = grad_case(torch, kh.fused_ctc_head_emit_plain, args,
                              cot, 3)
        hold(torch, f"{what} K4 fused_ctc_head_emit {name} B={b} T={t} "
             f"D={d} V={v} S={s}", o, ro, g, rg, ("dhs", "dw", "db"),
             TOL[name])
        check_routes(f"{what} K4 {name}", {k: after[k] - before[k]
                                           for k in ROUTED}, launches)
        if dt == torch.bfloat16:
            _, z = kh._launch_fwd(*args)
            got = kh._launch_bwd(*args, z, cot)
            ref = kh.fused_ctc_head_emit_bwd_plain(*args, z, cot)
            torch.cuda.synchronize()
            rels = [rel_err(a, x)[1] for a, x in zip(got, ref)]
            print(f"{what} K4 fused_ctc_head_emit backward bfloat16 D={d} "
                  "against fused_ctc_head_emit_bwd_plain: " + ", ".join(
                      f"{k} {x:.3e}" for k, x in zip(("dhs", "dw", "db"),
                                                     rels))
                  + f" of max|ref| (tolerance {BWD_PLAIN_TOL})")
            if not max(rels) <= BWD_PLAIN_TOL:
                raise AssertionError(f"{what} K4 bf16 backward disagrees "
                                     "with fused_ctc_head_emit_bwd_plain")
            del got, ref, z
    if tlen is None:
        tlen = torch.full((b,), t, dtype=torch.int32, device="cuda")
    lp = torch.log_softmax(r(b, t, v) * 2.0, -1)
    emit = kctc.mask_emit(lp.gather(2, ext[:, None, :].expand(b, t, -1)),
                          smax).contiguous()
    largs = (emit, skip, tlen, last)
    lcot = torch.rand(b, generator=gen, device="cuda")
    before = route_counts()
    o, g, _ = grad_case(torch, kctc.ctc_lattice, largs, lcot, 1)
    after = route_counts()
    ro, rg, _ = grad_case(torch, kctc.ctc_lattice_plain, largs, lcot, 1)
    hold(torch, f"{what} K1 ctc_lattice float32 B={b} T={t} S={s} (U "
         f"{int(ulen.max())})", o, ro, g, rg, ("demit",), TOL["float32"])
    check_routes(f"{what} K1", {k: after[k] - before[k] for k in ROUTED},
                 K1_WARP)


def bucket_t_prime(n_samples):
    """T' of a batch padded to n_samples (hop 128, x4 subsampling)."""
    from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
    return Conv2dSubsampling.out_length_static(1 + n_samples // 128)


def epoch_figures(hist):
    """{epoch: (steps, s an epoch, step_time, iter_time, audio-s/s)} of a
    reporter history's train phases."""
    out = {}
    for e in hist:
        tr = e["train"]
        out[e["epoch"]] = (tr["steps"], tr["time_s"], tr["step_time"],
                           tr["iter_time"], tr["steps"] * CLI_BATCH
                           * UTT_SECONDS / tr["time_s"])
    return out


def cli_pace(torch, card, root, dev_dir, n_blocks, train_step_s):
    """One epoch of CLI_PACE_TRAIN utterances through bin/asr_train, 16
    steps of CLI_BATCH. Fails unless every step makes its launches and the
    epoch's losses are finite with nothing skipped. Prints, for the steps
    after the epoch's first, the host wait before each (the Trainer's
    iter_time: what of the producer's read and collate the previous step
    did not hide), each step's host time and the audio-s/s over them,
    beside make_train_step's (``train_step_s``, phase 5)."""
    import json

    from espnet_slurp_tpu_torch.bin import asr_train
    from espnet_slurp_tpu_torch.tasks import asr as task

    t0 = time.perf_counter()
    train_dir = cli_split(root / "pace_train", "pace", CLI_PACE_TRAIN,
                          np.random.RandomState(11))
    written = time.perf_counter() - t0
    per_step, clock = [], []
    make = step_recorder(torch, per_step, clock)
    try:
        asr_train.main(["--config", cli_train_yaml(
            root, train_dir, dev_dir, 1, exp="exp_pace")])
    finally:
        task.make_train_step = make
    hist = json.loads((root / "exp_pace" / "reporter.json").read_text()
                      )["history"]
    steps = -(-CLI_PACE_TRAIN // CLI_BATCH)
    tr = hist[0]["train"]
    if not (len(hist) == 1 and tr["steps"] == steps == len(per_step)
            and tr["skipped"] == 0
            and np.isfinite([tr["loss"], hist[0]["valid"]["loss"]]).all()):
        raise AssertionError(f"phase 15 pace: {len(per_step)} steps, "
                             f"reporter {hist}")
    for i, (wrappers, hosts, n_rows) in enumerate(per_step):
        want_w, want_h = cli_step_want(n_rows, n_blocks)
        if wrappers != want_w or hosts != want_h:
            raise AssertionError(
                f"phase 15 pace step {i}: launches {wrappers} and {hosts}, "
                f"expected {want_w} and {want_h}")
    gaps = [clock[i][0] - clock[i - 1][1] for i in range(1, steps)]
    host = [b - a for a, b in clock]
    span = clock[-1][1] - clock[0][1]
    rate = (steps - 1) * CLI_BATCH * UTT_SECONDS / span
    print(f"phase 15 pace: {CLI_PACE_TRAIN} x {UTT_SECONDS} s written in "
          f"{written:.1f} s; one epoch of {steps} steps in "
          f"{tr['time_s']:.3f} s (reporter: step_time {tr['step_time']:.4f}"
          f" s, iter_time {tr['iter_time']:.4f} s), each step's launches "
          f"held; first step's host s {host[0]:.4f}")
    print(f"phase 15 pace, steps 2-{steps}: host wait before each (s) "
          f"{[round(g, 4) for g in gaps]}; mean {np.mean(gaps):.4f} s, "
          f"{100 * sum(gaps) / span:.1f}% of their span; each step's host s "
          f"{[round(h, 4) for h in host[1:]]}, mean "
          f"{np.mean(host[1:]):.4f} s; {span / (steps - 1):.4f} s a step, "
          f"{rate:.1f} audio-s/s through the CLI beside make_train_step's "
          f"{TRAIN_B * TRAIN_SECONDS / train_step_s:.1f} on {card}")


def cli_phase(torch, card, decode_launches, decode_wall, train_step_s):
    """Phase 15: bin/asr_train trains the flagship (bf16, 12 x 256, dropout
    DROPOUT, SpecAug on) for 2 epochs on the card, then a third run with
    max_epoch 3 resumes from epoch 2; bin/asr_inference decodes N_UTT dev
    utterances with beam BEAM, ctc_weight CTC_WEIGHT, max_len MAX_LEN from
    the n-best average. Fails unless the reporter holds 3 epochs of finite
    losses with nothing skipped, the checkpoints, latest.json and the
    averages exist, every train step makes exactly its launches (wrappers'
    and host counts), the decode's K2 / K3 launches are phase 3's a encode
    (``decode_launches``), K4 and K1 at this V and S hold to their plain
    versions, and score.txt has WER, CER and RTF; then cli_pace's epoch of
    16 steps. Prints the step time and iter_time from the reporter, the
    CLI's audio-s/s beside make_train_step's (``train_step_s``, phase 5),
    the CLI decode's RTF beside phase 3's (``decode_wall``) and the phase's
    seconds."""
    import json
    import shutil
    from pathlib import Path

    from espnet_slurp_tpu_torch.bin import asr_inference, asr_train

    t_phase = time.perf_counter()
    root = Path(CLI_ROOT).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    train_dir, dev_dir, dev8 = cli_corpus(root)
    exp = root / "exp"
    n_blocks = 12
    per_step, clock = [], []
    make = step_recorder(torch, per_step, clock)
    try:
        zero_counts()
        asr_train.main(["--config", cli_train_yaml(root, train_dir, dev_dir,
                                                     2)])
        two = json.loads((exp / "reporter.json").read_text())["history"]
        steps_two = len(per_step)
        for name in ("1epoch", "2epoch", "latest.json",
                     "valid.loss.ave_2best"):
            if not (exp / name).exists():
                raise AssertionError(f"phase 15: {name} missing after 2 "
                                     "epochs")
        asr_train.main(["--config", cli_train_yaml(root, train_dir, dev_dir,
                                                     3)])
        launches = read_counts()
    finally:
        from espnet_slurp_tpu_torch.tasks import asr as task
        task.make_train_step = make
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    per_epoch = -(-CLI_TRAIN // CLI_BATCH)
    print(f"phase 15: reporter epochs {[e['epoch'] for e in hist]}; steps "
          f"{steps_two} in the 2-epoch run, {len(per_step) - steps_two} in "
          f"the resumed run; launches of both runs {launches}")
    if not ([e["epoch"] for e in hist] == [1, 2, 3] and hist[:2] == two
            and steps_two == 2 * per_epoch
            and len(per_step) == 3 * per_epoch
            and json.loads((exp / "latest.json").read_text())
            == {"epoch": 3}):
        raise AssertionError("phase 15: the resumed run did not continue "
                             "from epoch 2 to 3")
    for e in hist:
        for phase in ("train", "valid"):
            vals = [e[phase][k] for k in ("loss", "loss_ctc", "loss_att")]
            if not all(np.isfinite(vals)):
                raise AssertionError(f"phase 15: epoch {e['epoch']} {phase} "
                                     f"losses {vals}")
        if e["train"]["skipped"] != 0 or e["train"]["steps"] != per_epoch:
            raise AssertionError(f"phase 15: epoch {e['epoch']} skipped or "
                                 f"short: {e['train']}")
    for name in ("1epoch", "2epoch", "3epoch", "valid.loss.ave_3best"):
        if not (exp / name / "checkpoint.pth").exists():
            raise AssertionError(f"phase 15: {name} missing")
    for i, (wrappers, hosts, n_rows) in enumerate(per_step):
        want_w, want_h = cli_step_want(n_rows, n_blocks)
        if wrappers != want_w or hosts != want_h:
            raise AssertionError(
                f"phase 15 step {i}: launches {wrappers} and {hosts}, "
                f"expected {want_w} and {want_h}")
    print(f"phase 15: every one of the {len(per_step)} train steps made "
          f"{per_step[0][0]} launches; by instance {per_step[0][1]}")
    losses = [(e["epoch"], round(e["train"]["loss"], 4),
               round(e["valid"]["loss"], 4)) for e in hist]
    print(f"phase 15: (epoch, train loss, valid loss) {losses}")
    figs = epoch_figures(hist)
    for ep, (steps, secs, step_t, iter_t, rate) in figs.items():
        print(f"phase 15 train epoch {ep}: {steps} steps of {CLI_BATCH} x "
              f"{UTT_SECONDS} s in {secs:.3f} s; step_time {step_t:.4f} s, "
              f"iter_time {iter_t:.4f} s ({100 * iter_t / (iter_t + step_t):.1f}"
              f"% of their sum), {rate:.1f} audio-s/s through the CLI on "
              f"{card}")
    # Within an epoch, the host time between one step's return and the
    # next's call: the Trainer's wait for the batch (its iter_time), its
    # copy call and the reporter.
    gaps = [round(clock[i][0] - clock[i - 1][1], 4)
            for i in range(len(clock)) if i % per_epoch]
    print(f"phase 15: host s between consecutive steps of an epoch {gaps}; "
          f"steps' host s {[round(b - a, 4) for a, b in clock]}")
    print(f"phase 15: make_train_step (phase 5, dropout {DROPOUT}, one "
          f"resident batch): {TRAIN_B * TRAIN_SECONDS / train_step_s:.1f} "
          f"audio-s/s ({train_step_s:.4f} s a step)")

    kern = cli_kernel_check(torch, exp)
    print(f"phase 15: K4 and K1 at V {kern['vocab']}, U up to "
          f"{kern['u_max']} (S {kern['s_max']}), T' {kern['t_prime']}: "
          "within phase 4's tolerances")

    dec = root / "decode"
    zero_counts()
    t0 = time.perf_counter()
    asr_inference.main([
        "--exp_dir", str(exp), "--data_dir", str(dev8), "--output_dir",
        str(dec), "--beam_size", str(BEAM), "--ctc_weight", str(CTC_WEIGHT),
        "--max_len", str(MAX_LEN), "--batch_size", str(N_UTT),
        "--ckpt", "valid.loss.ave_3best"])
    dec_s = time.perf_counter() - t0
    dlaunch = read_counts()
    want = {k: decode_launches.get(k, 0) for k in COUNTED}
    score = dict(line.split() for line in
                 (dec / "score.txt").read_text().splitlines())
    hyps = (dec / "text").read_text().splitlines()
    print(f"phase 15 decode: {N_UTT} x {UTT_SECONDS} s, beam {BEAM}, ctc "
          f"{CTC_WEIGHT}, max_len {MAX_LEN} from valid.loss.ave_3best: "
          f"score.txt {score}; CLI RTF {score.get('RTF')} beside phase 3's "
          f"{decode_wall / (N_UTT * UTT_SECONDS):.5f}; the whole CLI call "
          f"{dec_s:.2f} s; launches {dlaunch} (phase 3's a encode: "
          f"{decode_launches}) on {card}")
    if dlaunch != want:
        raise AssertionError(f"phase 15 decode launches {dlaunch}, expected "
                             f"{want}")
    if sorted(score) != ["CER", "RTF", "WER"] or len(hyps) != N_UTT:
        raise AssertionError(f"phase 15 decode: score.txt {score}, "
                             f"{len(hyps)} hypotheses")
    cli_pace(torch, card, root, dev_dir, n_blocks, train_step_s)
    # phase 19 (f) warm-starts from this run's n-best average
    shutil.rmtree(KB_INIT, ignore_errors=True)
    shutil.copytree(exp / "valid.loss.ave_3best",
                    Path(KB_INIT) / "valid.loss.ave_3best")
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return figs


# Phase 16: the flagship recipe (conf/train_ls100_conformer.yaml as written,
# global MVN included) through recipe/asr_pipeline.py:run_pipeline, stages
# 1-15, on phase 15's synthetic corpus with speed perturbation 0.9 / 1.0 /
# 1.1; phase 17: the transducer recipe (conf/train_transducer.yaml) through
# bin/asr_transducer_train and bin/asr_transducer_inference.
RECIPE_ROOT = "build/chip_smoke_recipe"
RECIPE_EPOCHS = 2
SP_FACTORS = (0.9, 1.0, 1.1)
# Collect-stats on the card against the same batches on the CPU, each of
# sum and sum_square within this share of its max |ref|: fp32 per-batch
# sums (and an fp32 frontend) in another order, accumulated in fp64. An
# H100 run read 9.6e-8 (sum) and 8.0e-8 (sum_square).
STATS_TOL = 1e-6
TR_CLI_BATCH, TR_SEARCH_BEAM = 32, 5
TR_SEARCHES = ("greedy", "alsa", "default", "maes", "tsd", "nsc")
# transducer_search_check: the share of valid frames at which a label
# leads blank from the start state once blank's bias is shifted (on an
# H100, shares of 5% and 10% gave ALSA and mAES 3 of their 16 rows a
# length strictly between 0 and max_len, 20% 1, 35% and 50% none), and the
# tolerance of the chosen hypotheses' fp32 scores card vs CPU (a sum of
# ~T' log probabilities, from a joint whose products add in another order;
# H100 runs read 1.7e-7 to 4.6e-7).
EMIT_SHARE = 0.05
# The default search compared on a quarter of the utterances: on all 8 its
# fp32 runs took 22.6 s on the card and 33.0 s on the CPU, 45% of phase
# 17, on a whole run of 828.6 s beside an NVIDIA H100 80GB HBM3 (700 W);
# on 4, 18.69 s and 26.29 s of a whole run of 801.2 s (phase 23 added).
TR_DEFAULT_CMP_UTT = N_UTT // 4
SCORE_RTOL = 1e-4


def recipe_phase(torch, card, root, corpus):
    """Phase 16: run_pipeline on the card, stages 1-15, of the flagship's
    own recipe loaded through tasks/asr.py:load_task_config, with only
    exp_dir, the data dirs, char tokens, phase 15's sorted batches of
    CLI_BATCH and max_epoch RECIPE_EPOCHS overridden. Fails unless stage
    10's stats match collect-stats over the same batches on the CPU (count
    exactly, sum and sum_square within STATS_TOL of max |ref|), the trained
    Speech2Text carries them, every train step makes phase 15's launches
    (cli_step_want: wrappers' and host counts), score.txt has WER and CER
    and stage 15 decodes the unpacked model as the exp dir. Returns the
    launches per train step."""
    from espnet_slurp_tpu_torch.recipe.asr_pipeline import (PipelineOptions,
                                                            run_pipeline)
    from espnet_slurp_tpu_torch.tasks import asr as task
    from espnet_slurp_tpu_torch.train.collect_stats import collect_stats

    t_phase = time.perf_counter()
    train_dir, dev_dir, _ = corpus
    exp = root / "exp_recipe"
    cfg = task.load_task_config("conf/train_ls100_conformer.yaml", {
        "exp_dir": str(exp), "max_epoch": RECIPE_EPOCHS,
        "data": {"train_dir": str(train_dir), "valid_dir": str(dev_dir),
                 "token_type": "char", "batch_type": "sorted",
                 "batch_size": CLI_BATCH}})
    m = cfg.model
    print(f"phase 16: conf/train_ls100_conformer.yaml: {m.encoder} "
          f"{m.num_encoder_blocks} x {m.d_model}, d_ff {m.d_ff}, "
          f"{m.num_decoder_blocks} decoder blocks, {m.dtype}, dropout "
          f"{m.dropout_rate}, use_mvn {m.use_mvn}, {cfg.optim.scheduler} lr "
          f"{cfg.optim.lr}; overridden: exp_dir, data dirs, char tokens, "
          f"sorted batches of {CLI_BATCH}, max_epoch {RECIPE_EPOCHS}")
    per_step, clock = [], []
    make = step_recorder(torch, per_step, clock)
    try:
        zero_counts()
        results = run_pipeline(
            cfg, PipelineOptions(speed_perturb_factors=SP_FACTORS), stage=1,
            stop_stage=15)
        launches = read_counts()
    finally:
        task.make_train_step = make
    secs = results["stage_seconds"]
    stage_s = {k: round(v, 2) for k, v in secs.items()}
    print(f"phase 16: seconds by stage {stage_s}; launches over the "
          f"pipeline {launches}")
    for name in ("rel_flash_attention", "fused_ffn", "fused_ctc_head_emit",
                 "ctc_lattice", "rel_flash_attention_bwd", "fused_ffn_bwd",
                 "fused_ctc_head_emit_bwd", "ctc_lattice_bwd"):
        if launches[name] == 0:
            raise AssertionError(f"phase 16: {name} never launched")
    sp_dir = exp / "data" / "train_filtered"
    n_utt = len((sp_dir / "wav.scp").read_text().splitlines())
    steps = RECIPE_EPOCHS * -(-n_utt // CLI_BATCH)
    if len(per_step) != steps:
        raise AssertionError(f"phase 16: {len(per_step)} train steps, "
                             f"expected {steps}")
    for i, (wrappers, hosts, n_rows) in enumerate(per_step):
        want_w, want_h = cli_step_want(n_rows, m.num_encoder_blocks)
        if wrappers != want_w or hosts != want_h:
            raise AssertionError(
                f"phase 16 step {i}: launches {wrappers} and {hosts}, "
                f"expected {want_w} and {want_h}")
    print(f"phase 16: each of the {steps} train steps ({n_utt} utterances "
          f"after speed perturbation {SP_FACTORS}) made {per_step[0][0]}")

    # Stage 10 again on the CPU over the same batches.
    tcfg = task.load_task_config(str(exp / "config.yaml"))
    tok, conv, _ = task.ASRTask.prepare_vocab(tcfg)
    ds = task.ASRTask.build_dataset(str(sp_dir), tok, conv)
    batches = task.ASRTask.build_iter_factory(tcfg, ds, shuffle=False)(1)
    t0 = time.perf_counter()
    ref = collect_stats(batches, tcfg.model.frontend, root / "stats_cpu",
                        device="cpu")
    cpu_s = time.perf_counter() - t0
    got = np.load(exp / "stats" / "feats_stats.npz")
    errs = {k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
            for k in ("sum", "sum_square")}
    audio_s = int(ref["count"]) * tcfg.model.frontend.hop_length / FS
    print(f"phase 16: collect-stats on the card {secs[10]:.2f} s (stage 10, "
          f"with the vocabulary and the dataset), {audio_s / secs[10]:.1f} "
          f"audio-s/s over {int(got['count'])} frames ({audio_s:.0f} s of "
          f"audio); on the CPU {cpu_s:.2f} s; card vs CPU: count "
          f"{int(got['count'])} vs {int(ref['count'])}, worst error of max "
          f"|ref| {errs} (tolerance {STATS_TOL}) on {card}")
    if int(got["count"]) != int(ref["count"]) or max(errs.values()) > \
            STATS_TOL:
        raise AssertionError("phase 16: collect-stats card vs CPU")
    s2t = task.Speech2Text.from_exp_dir(str(exp), device="cuda")
    if s2t.mvn_stats is None:
        raise AssertionError("phase 16: the trained Speech2Text has no MVN "
                             "stats")
    del s2t
    score = dict(line.split() for line in
                 (exp / "decode_dev" / "score.txt").read_text().splitlines())
    print(f"phase 16: score.txt {score}; wer {results['wer_dev']:.4f} cer "
          f"{results['cer_dev']:.4f}; unpack_decode_match "
          f"{results['unpack_decode_match']}")
    if sorted(score) != ["CER", "WER"] or \
            results["unpack_decode_match"] is not True:
        raise AssertionError(f"phase 16: score {score}, results {results}")
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    losses = [(e["epoch"], round(e["train"]["loss"], 4),
               round(e["valid"]["loss"], 4)) for e in hist]
    if not (len(hist) == RECIPE_EPOCHS and all(
            np.isfinite([e[p]["loss"] for p in ("train", "valid")]).all()
            for e in hist)):
        raise AssertionError(f"phase 16: reporter {hist}")
    print(f"phase 16: (epoch, train loss, valid loss) {losses}")
    torch.cuda.empty_cache()
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return {k: v for k, v in per_step[0][0].items() if v}


def tr_step_want(n_blocks):
    """One transducer train step's launches (phase 9's): the wrappers'
    counts, and the routed kernels by the host counts (K1 and K5 on their
    warp routes, K6's bf16 launches)."""
    wrappers = {"fused_ffn": 2 * n_blocks, "fused_ffn_bwd": 2 * n_blocks,
                "rel_flash_attention": n_blocks,
                "rel_flash_attention_bwd": n_blocks,
                "fused_conv_module": n_blocks,
                "fused_conv_module_bwd": n_blocks,
                "rnnt_lattice": 1, "rnnt_lattice_bwd": 1,
                "ctc_lattice": 1, "ctc_lattice_bwd": 1}
    hosts = {**dict.fromkeys(K1_WARP, 1), **dict.fromkeys(K5_WARP, 1),
             **dict.fromkeys(K6_BF16_LAUNCHES, n_blocks)}
    return ({k: wrappers.get(k, 0) for k in COUNTED},
            {k: hosts.get(k, 0) for k in ROUTED})


def transducer_search_check(torch, exp, dev8):
    """Each beam search at beam TR_SEARCH_BEAM on the card and on the CPU
    from the same fp32 encoder output (the trained model in fp32, hs of the
    8 dev utterances computed once on the card, copied to the CPU; the
    default search on the first TR_DEFAULT_CMP_UTT of them), with
    the joint sharpened as tests/test_torch_transducer_task.py's
    search_models does (lin_out's weight x 3, lin_pred's x 4) and blank's
    bias shifted so that blank loses to the best label at EMIT_SHARE of
    the valid frames from the start state: the trained model alone emits
    almost nothing, and lengths of 0 (or max_len) would hide a fault that
    shows only where hypotheses compete. Fails unless each search gives
    the same tokens and lengths on both sides, its card lengths include one
    strictly between 0 and max_len, the searches' lengths are not all
    alike, and the chosen hypotheses' scores agree within SCORE_RTOL of
    max(1, |CPU score|). Returns {search: (card s, CPU s)}."""
    from espnet_slurp_tpu_torch.data.fileio import load_wav, read_2column_text
    from espnet_slurp_tpu_torch.decode.transducer_beam import run_search
    from espnet_slurp_tpu_torch.tasks.asr_transducer import \
        Speech2TextTransducer

    s2t = Speech2TextTransducer.from_exp_dir(str(exp), device="cuda")
    cfg = s2t.model.cfg
    cfg32 = dataclasses.replace(cfg, asr=dataclasses.replace(
        cfg.asr, dtype="float32"))
    state = {k: v.cpu() for k, v in s2t.model.state_dict().items()}
    state["joint.lin_out.weight"] = state["joint.lin_out.weight"] * 3.0
    state["joint.lin_pred.weight"] = state["joint.lin_pred.weight"] * 4.0
    sides = {"card": "cuda", "host": "cpu"}
    models = {}
    for side, dev in sides.items():
        models[side] = type(s2t.model)(cfg32, device=dev)
        models[side].load_state_dict(state)
    wavs = [load_wav(p)[0] for _, p in sorted(read_2column_text(
        dev8 / "wav.scp").items())]
    s2t.model = models["card"]
    hs, hl = s2t.encode_batch(wavs)
    hs = hs.float()
    blank = cfg.asr.blank_id
    with torch.inference_mode():
        card = models["card"]
        n = hs.shape[0]
        g, _ = card.prediction.step(
            torch.full((n,), blank, dtype=torch.long, device="cuda"),
            card.prediction.init_carry(n, "cuda"))
        z = card.joint(hs, g[:, None, :]).float()  # [B, T', V]
        rest = z.clone()
        rest[..., blank] = float("-inf")
        gap = z[..., blank] - rest.max(-1).values
        valid = torch.arange(hs.shape[1], device="cuda")[None] < hl[:, None]
        shift = -float(torch.quantile(gap[valid], EMIT_SHARE))
    for m in models.values():
        with torch.no_grad():
            m.joint.lin_out.bias[blank] += shift
    print(f"phase 17 searches: joint sharpened (lin_out x 3, lin_pred x 4), "
          f"blank's bias {shift:+.4f} so that a label leads at "
          f"{EMIT_SHARE:.0%} of the {int(valid.sum())} valid frames")
    inputs = {"card": (hs, hl),
              "host": (hs.to(sides["host"]), hl.to(sides["host"]))}
    out, lengths = {}, set()
    for search in TR_SEARCHES[1:]:
        res, secs = {}, {}
        rows = slice(TR_DEFAULT_CMP_UTT if search == "default" else None)
        for side, (h, l) in inputs.items():
            t0 = time.perf_counter()
            res[side] = [x.cpu() for x in run_search(
                models[side], h[rows], l[rows], search, TR_SEARCH_BEAM,
                s2t.max_len, with_score=True)]
            secs[side] = time.perf_counter() - t0
        (ct, cl, cs), (ht, hl_, hsc) = res["card"], res["host"]
        same = torch.equal(ct, ht) and torch.equal(cl, hl_)
        score_err = float(((cs.double() - hsc.double()).abs()
                           / hsc.double().abs().clamp_min(1.0)).max())
        varied = bool(((cl > 0) & (cl < s2t.max_len)).any())
        lengths |= set(cl.tolist())
        print(f"phase 17 {search}: fp32 search from the card's hs, card "
              f"{secs['card']:.2f} s, CPU {secs['host']:.2f} s; lengths card "
              f"{cl.tolist()} CPU {hl_.tolist()}; the same tokens and "
              f"lengths: {same}; scores card {[round(x, 4) for x in cs.tolist()]}"
              f", worst |card - CPU| / max(1, |CPU|) {score_err:.3e} "
              f"(tolerance {SCORE_RTOL})")
        if not same:
            raise AssertionError(f"phase 17 {search}: card and CPU differ")
        if not varied:
            raise AssertionError(f"phase 17 {search}: no length strictly "
                                 f"between 0 and {s2t.max_len}")
        if not score_err <= SCORE_RTOL:
            raise AssertionError(f"phase 17 {search}: scores differ by "
                                 f"{score_err:.3e}")
        out[search] = (secs["card"], secs["host"])
    if len(lengths) < 2:
        raise AssertionError(f"phase 17: every search gave lengths {lengths}")
    del models, s2t
    torch.cuda.empty_cache()
    return out


def transducer_cli_phase(torch, card, root, corpus):
    """Phase 17: bin/asr_transducer_train on conf/train_transducer.yaml as
    written, with only the data dirs, char tokens, max_epoch 2, sorted
    batches of TR_CLI_BATCH and the port-only model.asr.fused_conv true set
    on the command line; a second call with max_epoch 3 resumes; then
    bin/asr_transducer_inference with each of TR_SEARCHES at beam
    TR_SEARCH_BEAM on the 8 dev utterances. Fails unless the reporter holds
    3 epochs of finite losses, every train step makes phase 9's launches
    (tr_step_want), each search writes text and score.txt, and each beam
    search agrees on the card and the CPU from the same fp32 hs
    (transducer_search_check). Returns the launches per
    train step."""
    from espnet_slurp_tpu_torch.bin import (asr_transducer_inference,
                                            asr_transducer_train)
    from espnet_slurp_tpu_torch.tasks import asr_transducer as ttask
    from espnet_slurp_tpu_torch.utils import device as devmod

    t_phase = time.perf_counter()
    train_dir, dev_dir, dev8 = corpus
    exp = root / "exp_transducer"
    sets = [f"exp_dir={exp}", f"data.train_dir={train_dir}",
            f"data.valid_dir={dev_dir}", "data.token_type=char",
            "data.batch_type=sorted", f"data.batch_size={TR_CLI_BATCH}",
            "model.asr.fused_conv=true"]
    per_step, clock, routes = [], [], []
    make = step_recorder(torch, per_step, clock, task=ttask)
    try:
        zero_counts()
        r0 = route_counts()
        asr_transducer_train.main(["--config", "conf/train_transducer.yaml",
                                   "--set", *sets, "max_epoch=2"])
        two = json.loads((exp / "reporter.json").read_text())["history"]
        steps_two = len(per_step)
        asr_transducer_train.main(["--config", "conf/train_transducer.yaml",
                                   "--set", *sets, "max_epoch=3"])
        launches = read_counts()
        r1 = route_counts()
    finally:
        ttask.make_train_step = make
    cfg = ttask.load_transducer_config(str(exp / "config.yaml"))
    a = cfg.model.asr
    print(f"phase 17: conf/train_transducer.yaml: {a.num_encoder_blocks} x "
          f"{a.d_model}, {cfg.model.pred_layers} x {cfg.model.pred_dim} "
          f"{cfg.model.prediction}, joint {cfg.model.joint_dim}, aux CTC "
          f"{cfg.model.aux_ctc_weight}, {a.dtype}, dropout {a.dropout_rate}, "
          f"fused_conv {a.fused_conv}, vocab {a.vocab_size}; launches of "
          f"both runs {launches}; routed kernels "
          f"{ {k: r1[k] - r0[k] for k in ROUTED if r1[k] - r0[k]} }")
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    per_epoch = -(-CLI_TRAIN // TR_CLI_BATCH)
    if not ([e["epoch"] for e in hist] == [1, 2, 3] and hist[:2] == two
            and steps_two == 2 * per_epoch
            and len(per_step) == 3 * per_epoch):
        raise AssertionError(f"phase 17: epochs {[e['epoch'] for e in hist]}"
                             f", steps {steps_two} then {len(per_step)}")
    for e in hist:
        vals = [e[p][k] for p in ("train", "valid")
                for k in ("loss", "loss_transducer", "loss_ctc")]
        if not np.isfinite(vals).all() or e["train"]["skipped"] != 0:
            raise AssertionError(f"phase 17: epoch {e['epoch']}: {vals}")
    want_w, want_h = tr_step_want(a.num_encoder_blocks)
    for i, (wrappers, hosts, _) in enumerate(per_step):
        routed = {k: hosts.get(k, 0) for k in ROUTED}
        if wrappers != want_w or routed != want_h:
            raise AssertionError(f"phase 17 step {i}: launches {wrappers} "
                                 f"and {routed}, expected {want_w} and "
                                 f"{want_h}")
    losses = [(e["epoch"], round(e["train"]["loss"], 4),
               round(e["valid"]["loss"], 4)) for e in hist]
    figs = {e["epoch"]: (e["train"]["steps"], e["train"]["time_s"],
                         e["train"]["step_time"]) for e in hist}
    print(f"phase 17: each of the {len(per_step)} train steps made "
          f"{per_step[0][0]}; (epoch, train loss, valid loss) {losses}; "
          f"(steps, s, step_time) by epoch {figs} on {card}")

    for search in TR_SEARCHES:
        dec = root / f"dec_{search}"
        syncs = devmod.host_syncs
        t0 = time.perf_counter()
        asr_transducer_inference.main([
            "--exp_dir", str(exp), "--data_dir", str(dev8), "--output_dir",
            str(dec), "--search", search, "--beam_size", str(TR_SEARCH_BEAM),
            "--batch_size", str(N_UTT)])
        wall = time.perf_counter() - t0
        syncs = devmod.host_syncs - syncs
        score = dict(line.split() for line in
                     (dec / "score.txt").read_text().splitlines())
        hyps = (dec / "text").read_text().splitlines()
        print(f"phase 17 decode {search}: {N_UTT} x {UTT_SECONDS} s in one "
              f"batch, beam {TR_SEARCH_BEAM}: score.txt {score}; the CLI call "
              f"{wall:.2f} s; host syncs {syncs} ({syncs / N_UTT:.1f} an "
              f"utterance) on {card}")
        if sorted(score) != ["CER", "RTF", "WER"] or len(hyps) != N_UTT:
            raise AssertionError(f"phase 17 decode {search}: {score}, "
                                 f"{len(hyps)} hypotheses")
    transducer_search_check(torch, exp, dev8)
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return {k: v for k, v in per_step[0][0].items() if v}


# Phase 18: conf/train_moe.yaml (routed MoE) and the interCTC options the
# other configs use. MOE_ROOT holds its exp dirs (under RECIPE_ROOT, on
# phase 15's corpus); the fp32 beam searches of (e) run on MOE_CMP_UTT of
# the decode's utterances on both devices from one encoder output.
INTERCTC_LAYERS, INTERCTC_WEIGHT = (3, 6, 9), 0.3
# A quarter of the decode's utterances: at N_UTT the CPU's fp32 searches
# and their replays took ~95 s of a whole run beside an NVIDIA H100 80GB
# HBM3 (700 W) on a slow host, and at N_UTT // 2 ~24 s of each decode's
# 31 s in a whole run of 828.6 s; the script must end within its time
# limit there too.
MOE_CMP_UTT = N_UTT // 4
# The MoE step at 64 x 15 s must stay under this peak (ISSUE budget: the
# reference's one-hot [S, E, C] dispatch alone would take 4.5 GB a layer).
MOE_PEAK_GB = 16.0
# (d): the MoE router's top two gates of every token differ by more than
# this (tokens below it are drawn again from the seeded generator), so
# that fp32 rounding on either device cannot send a token elsewhere.
ROUTE_MARGIN = 1e-4


MOE_YAML = "conf/train_moe.yaml"


def moe_config(**model):
    """conf/train_moe.yaml's model, as written (its vocab 5000), with
    ``model`` overridden."""
    from espnet_slurp_tpu_torch.tasks import asr as task
    return dataclasses.replace(task.load_task_config(MOE_YAML).model,
                               **model)


def moe_blocks(cfg):
    """(blocks, MoE blocks) of an encoder config."""
    n = cfg.num_encoder_blocks
    moe = n // max(cfg.moe_every, 1) if cfg.moe_experts > 0 else 0
    return n, moe


def moe_recipe_phase(torch, card, root, corpus):
    """Phase 18 (a): conf/train_moe.yaml through run_pipeline on the card,
    stages 1-15, with phase 16's overrides on phase 15's corpus (no speed
    perturbation). Every train step makes 2 x 12 - 6 = 18 K2 launches each
    way (the second FFN of every 2nd block is the routed MoE), 12 K3 and
    one K4 and K1 each way (wrappers' and host counts). Returns (exp dir,
    launches per train step)."""
    from espnet_slurp_tpu_torch.recipe.asr_pipeline import (PipelineOptions,
                                                            run_pipeline)
    from espnet_slurp_tpu_torch.tasks import asr as task

    t0 = time.perf_counter()
    train_dir, dev_dir, _ = corpus
    exp = root / "exp_moe"
    cfg = task.load_task_config(MOE_YAML, {
        "exp_dir": str(exp), "max_epoch": RECIPE_EPOCHS,
        "data": {"train_dir": str(train_dir), "valid_dir": str(dev_dir),
                 "token_type": "char", "batch_type": "sorted",
                 "batch_size": CLI_BATCH}})
    m = cfg.model
    n_blocks, n_moe = moe_blocks(m)
    print(f"phase 18 (a): {MOE_YAML}: {m.num_encoder_blocks} x {m.d_model}, "
          f"{m.moe_experts} experts on every {m.moe_every}nd block "
          f"(capacity {m.moe_capacity_factor}, aux weight "
          f"{m.moe_aux_weight}), {m.dtype}, dropout {m.dropout_rate}, "
          f"use_mvn {m.use_mvn}, {cfg.optim.scheduler}; overridden: "
          f"exp_dir, data dirs, char tokens, sorted batches of {CLI_BATCH}, "
          f"max_epoch {RECIPE_EPOCHS}")
    per_step, clock = [], []
    make = step_recorder(torch, per_step, clock)
    try:
        results = run_pipeline(cfg, PipelineOptions(), stage=1,
                               stop_stage=15)
    finally:
        task.make_train_step = make
    steps = RECIPE_EPOCHS * -(-CLI_TRAIN // CLI_BATCH)
    if len(per_step) != steps:
        raise AssertionError(f"phase 18 (a): {len(per_step)} train steps, "
                             f"expected {steps}")
    for i, (wrappers, hosts, n_rows) in enumerate(per_step):
        want_w, want_h = cli_step_want(n_rows, n_blocks,
                                       2 * n_blocks - n_moe)
        if wrappers != want_w or hosts != want_h:
            raise AssertionError(
                f"phase 18 (a) step {i}: launches {wrappers} and {hosts}, "
                f"expected {want_w} and {want_h}")
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    aux = [e["train"].get("loss_moe_aux") for e in hist]
    if not (len(hist) == RECIPE_EPOCHS and results["unpack_decode_match"]
            is True and all(np.isfinite(
                [e[p]["loss"] for e in hist for p in ("train", "valid")]
                + aux))):
        raise AssertionError(f"phase 18 (a): reporter {hist}, results "
                             f"{results}")
    stage_s = {k: round(v, 2) for k, v in results["stage_seconds"].items()}
    print(f"phase 18 (a): each of the {steps} train steps made "
          f"{per_step[0][0]}; loss_moe_aux by epoch {aux}; wer "
          f"{results['wer_dev']:.4f} cer {results['cer_dev']:.4f}; "
          f"seconds by stage {stage_s}; {time.perf_counter() - t0:.1f} s "
          f"on {card}")
    return exp, {k: v for k, v in per_step[0][0].items() if v}


def moe_train_phase(torch, card, train_step_s):
    """Phase 18 (b): conf/train_moe.yaml's model (bf16, dropout 0.1,
    SpecAug on, the reference's initialisation from a seed) through
    make_train_step on phase 5's traffic; per step 18 K2, 12 K3 and 1 K4
    and K1 launches each way; step seconds, audio-s/s and peak memory
    beside phase 5's flagship. Returns the launches per step."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    cfg = moe_config()
    n_blocks, n_moe = moe_blocks(cfg)
    state = ASRTask.init_params(ASRModel(cfg, device="cpu"), 0).state_dict()
    model = ASRModel(cfg, device="cuda")
    model.load_state_dict(state)
    batch = train_batch(torch, np.random.RandomState(0), TRAIN_B,
                        FS * TRAIN_SECONDS, TRAIN_U, cfg.vocab_size, "cuda")
    what = (f"phase 18 (b): {MOE_YAML}, B={TRAIN_B} x {TRAIN_SECONDS} s, "
            f"U={TRAIN_U}")
    launches, step_s, busy_ms, _, routes = run_train_steps(
        torch, what, model, batch, card, TRAIN_B * TRAIN_SECONDS)[:5]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = flagship_step_want(n_blocks, n_ffn=2 * n_blocks - n_moe)
    check_per_step(what, launches, per_step)
    check_routes(what, routes, K1_WARP + tuple(K4_BF16_LAUNCHES),
                 TRAIN_STEPS)
    print(f"{what}: step {step_s:.4f} s, "
          f"{TRAIN_B * TRAIN_SECONDS / step_s:.1f} audio-s/s, busy "
          f"{busy_ms:.2f} ms, peak {peak_gb * 1e3:.1f} MB (limit "
          f"{MOE_PEAK_GB:.0f} GB) beside phase 5's flagship "
          f"{train_step_s:.4f} s ({TRAIN_B * TRAIN_SECONDS / train_step_s:.1f}"
          f" audio-s/s) on {card}")
    if peak_gb >= MOE_PEAK_GB:
        raise AssertionError(f"{what}: peak {peak_gb:.2f} GB")
    del model, batch
    torch.cuda.empty_cache()
    return per_step


def interctc_phase(torch, card):
    """Phase 18 (c): the flagship with interCTC taps after blocks
    INTERCTC_LAYERS (weight INTERCTC_WEIGHT), without and with
    self-conditioning, bf16 at dropout 0.1 through make_train_step on phase
    5's traffic: per step 24 K2 and 12 K3 launches each way, and K4 / K1 4
    / 4 each way without self-conditioning (the final CTC and a tap each
    through the fused head), 1 / 4 with it (the taps' CTC from the shared
    head's logits); then phase 6's fp32 forward and backward card vs CPU
    at dropout 0.1 for each. Returns the launches per step of each."""
    from espnet_slurp_tpu_torch.models.asr_model import (ASRModel,
                                                          flagship_config)
    from espnet_slurp_tpu_torch.utils.params import init_random_

    out = {}
    for sc in (False, True):
        kw = dict(interctc_layers=INTERCTC_LAYERS,
                  interctc_weight=INTERCTC_WEIGHT, self_conditioning=sc,
                  dropout_rate=DROPOUT)
        cfg = dataclasses.replace(flagship_config(), **kw)
        label = "self-conditioning" if sc else "interctc"
        what = (f"phase 18 (c) {label} at {INTERCTC_LAYERS}, weight "
                f"{INTERCTC_WEIGHT}")
        model = init_random_(ASRModel(cfg, device="cuda"), seed=0)
        batch = train_batch(torch, np.random.RandomState(0), TRAIN_B,
                            FS * TRAIN_SECONDS, TRAIN_U, cfg.vocab_size,
                            "cuda")
        run = run_train_steps(
            torch, what, model, batch, card, TRAIN_B * TRAIN_SECONDS)
        launches, routes = run.launches, run.routes
        taps = len(INTERCTC_LAYERS)
        head = 1 if sc else 1 + taps
        n = cfg.num_encoder_blocks
        per_step = {"fused_ffn": 2 * n, "fused_ffn_bwd": 2 * n,
                    "rel_flash_attention": n, "rel_flash_attention_bwd": n,
                    "fused_ctc_head_emit": head,
                    "fused_ctc_head_emit_bwd": head,
                    "ctc_lattice": 1 + taps, "ctc_lattice_bwd": 1 + taps}
        check_per_step(what, launches, per_step)
        check_routes(what, routes, {**dict.fromkeys(K1_WARP, 1 + taps),
                                    **dict.fromkeys(K4_BF16_LAUNCHES, head)},
                     TRAIN_STEPS)
        out[label] = per_step
        del model, batch
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32", specaug=None)
        state = init_random_(ASRModel(cfg32, device="cpu"),
                             seed=0).state_dict()
        compare_cpu_card(torch, f"{what}, fp32 step", ASRModel, cfg32, state,
                         *short_batch(cfg.vocab_size))
    return out


def moe_routing_phase(torch, card):
    """Phase 18 (d): conf/train_moe.yaml's MoE layer (D 256, d_ff 1024, 8
    experts, capacity 1.25; the reference's initialisation, the router's
    bias tilted from 0.6 to -0.6 so that tokens are dropped) in fp32 on x
    [64, 468, 256] with ragged lengths, card against CPU: the expert of every token and the kept
    count of every expert exactly, the output and aux loss within 1e-4 of
    max |ref|. Tokens whose top two gates differ by less than ROUTE_MARGIN
    are drawn again (seeded), so that rounding cannot flip a route."""
    from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
    from espnet_slurp_tpu_torch.models.moe import MoEFeedForward
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    cfg = moe_config()
    t_train = Conv2dSubsampling.out_length_static(
        1 + FS * TRAIN_SECONDS // 128)
    gen = torch.Generator().manual_seed(DROPOUT_SEED)
    layer = ASRTask.init_params(MoEFeedForward(
        cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_capacity_factor), 0)
    with torch.no_grad():  # a lopsided router: the first experts overflow
        layer.router.bias.copy_(torch.linspace(0.6, -0.6, cfg.moe_experts))
    x = torch.randn(TRAIN_B, t_train, cfg.d_model, generator=gen)
    lens = torch.randint(t_train // 2, t_train + 1, (TRAIN_B,),
                         generator=gen)
    lens[0] = t_train
    pad = torch.arange(t_train)[None, :] < lens[:, None]
    redrawn = 0
    with torch.no_grad():
        for _ in range(20):
            gates = layer.route(x, pad)[0]
            top2 = gates.topk(2, dim=-1).values
            close = ((top2[:, 0] - top2[:, 1]) < ROUTE_MARGIN).view(
                TRAIN_B, t_train)
            if not close.any():
                break
            redrawn += int(close.sum())
            x[close] = torch.randn(int(close.sum()), cfg.d_model,
                                   generator=gen)
        else:
            raise AssertionError("phase 18 (d): no input clear of ties")
    res = {}
    for dev in ("cpu", "cuda"):
        m = MoEFeedForward(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                           cfg.moe_capacity_factor).to(dev)
        m.load_state_dict(layer.state_dict())
        with torch.no_grad():
            _, expert, _, keep, _ = m.route(x.to(dev), pad.to(dev))
            y, aux = m(x.to(dev), pad.to(dev))
        res[dev] = (expert.cpu(), keep.cpu(), y.cpu(), float(aux))
    (e_c, k_c, y_c, a_c), (e_g, k_g, y_g, a_g) = res["cpu"], res["cuda"]
    valid = pad.reshape(-1)
    kept = [torch.bincount(e[k], minlength=cfg.moe_experts).tolist()
            for e, k in ((e_c, k_c), (e_g, k_g))]
    err = rel_err(y_g, y_c)[1]
    print(f"phase 18 (d): MoE layer fp32, {int(valid.sum())} valid tokens "
          f"of {valid.numel()}, capacity {m.capacity(valid.numel())}, "
          f"{redrawn} tokens drawn again (gate margin {ROUTE_MARGIN}): "
          f"experts equal {torch.equal(e_c[valid], e_g[valid])}, kept "
          f"counts card {kept[1]} CPU {kept[0]}, dropped "
          f"{int(valid.sum()) - int(k_c.sum())}; output {err:.3e} of "
          f"max|ref|, aux {a_g:.6f} vs {a_c:.6f} on {card}")
    if not (torch.equal(e_c[valid], e_g[valid]) and torch.equal(k_c, k_g)
            and kept[0] == kept[1] and err <= 1e-4
            and abs(a_g - a_c) <= 1e-4 * abs(a_c)
            and int(k_c.sum()) < int(valid.sum())):
        raise AssertionError("phase 18 (d): MoE routing card vs CPU")


def remat_phase(torch, card):
    """Phase 18 (f): remat_encoder with stochastic depth 0.1 on the card.
    The flagship in fp32 at dropout 0.1 on phase 6's two utterances, one
    forward and backward without and one with remat, from the same weights
    and an equally seeded generator on the card: the loss equal within
    1e-6, every gradient within 1e-4 of its max |ref| (floored as phase
    6's: K3's dp adds in an order of its own), the generators in the same
    state after, and the recompute's launches: K2 and K3 forward twice a
    block, their backward, K4 and K1 once."""
    from espnet_slurp_tpu_torch.models.asr_model import (ASRModel,
                                                          flagship_config)
    from espnet_slurp_tpu_torch.utils.params import init_random_

    cfg = dataclasses.replace(flagship_config(), dtype="float32",
                              specaug=None, dropout_rate=DROPOUT,
                              stochastic_depth_rate=0.1)
    state = init_random_(ASRModel(cfg, device="cpu"), seed=0).state_dict()
    speech, lens, text, tlens = short_batch(cfg.vocab_size)
    batch = {"speech": speech, "speech_lengths": lens, "text": text,
             "text_lengths": tlens}
    res = {}
    for remat in (False, True):
        model = ASRModel(dataclasses.replace(cfg, remat_encoder=remat),
                         device="cuda")
        model.load_state_dict(state)
        gen = torch.Generator(device="cuda").manual_seed(DROPOUT_SEED)
        zero_counts()
        loss, _ = model(**{k: torch.from_numpy(v).cuda()
                           for k, v in batch.items()},
                        train=True, generator=gen)
        loss.backward()
        res[remat] = (float(loss.detach()), {
            k: p.grad.detach().cpu() for k, p in model.named_parameters()},
            read_counts(), gen.get_state())
        del model
    (l0, g0, n0, s0), (l1, g1, n1, s1) = res[False], res[True]
    floor = 1e-4 * max(float(x.abs().max()) for x in g0.values())
    worst = max((float((g1[k] - r).abs().max())
                 / max(float(r.abs().max()), floor), k)
                for k, r in g0.items())
    n = cfg.num_encoder_blocks
    want = dict(n0, fused_ffn=2 * n0["fused_ffn"],
                rel_flash_attention=2 * n0["rel_flash_attention"])
    print(f"phase 18 (f): remat at stochastic depth 0.1, dropout {DROPOUT}, "
          f"fp32: loss {l1:.6f} vs {l0:.6f}; worst gradient {worst[1]} "
          f"{worst[0]:.3e} of max|ref| (tolerance 1e-4); generators equal "
          f"{torch.equal(s0, s1)}; launches without {n0}, with {n1} on "
          f"{card}")
    if not (abs(l1 - l0) <= 1e-6 * abs(l0) and worst[0] <= 1e-4
            and torch.equal(s0, s1) and n1 == want
            and n0["fused_ffn"] == 2 * n and n0["ctc_lattice"] == 1):
        raise AssertionError("phase 18 (f): remat")


def selfcond_cli_train(torch, root, corpus):
    """A self-conditioned flagship (interCTC taps INTERCTC_LAYERS, bf16,
    dropout 0.1) trained 1 epoch by bin/asr_train on phase 15's corpus,
    for (e)'s decode. Returns its exp dir."""
    from pathlib import Path

    import yaml
    from espnet_slurp_tpu_torch.bin import asr_train

    train_dir, dev_dir, _ = corpus
    path = Path(cli_train_yaml(root, train_dir, dev_dir, 1, exp="exp_sc"))
    cfg = yaml.safe_load(path.read_text())
    cfg["model"].update(interctc_layers=list(INTERCTC_LAYERS),
                        interctc_weight=INTERCTC_WEIGHT,
                        self_conditioning=True)
    path.write_text(yaml.safe_dump(cfg))
    asr_train.main(["--config", str(path)])
    return root / "exp_sc"


# Card-vs-CPU searches: the CPU's search runs a second time with each of
# its pre-beam and beam choices (decode/beam.py:_top_k) taken from the
# card's, and the card's search must prove a valid beam search under the
# CPU's arithmetic: each choice a top-k of the CPU's own scores but by at
# most TIE_RTOL of the k-th score (floored at 1 nat), and the replay's
# hypotheses and scores the card's, the scores within TIE_RTOL relative.
# Each row's best hypothesis must be the same on both devices, or the
# replay proves the row a near-tie that fp32 rounding decides either way;
# such rows may be at most half of the rows. (A 4-step model's 95-token
# hypotheses, cycles of a few tokens, parted at token 63 of one row in 8
# on an H100.)
TIE_RTOL = 1e-5


@contextlib.contextmanager
def top_k_as(wrap):
    """decode/beam.py:_top_k replaced by ``wrap(_top_k)`` inside."""
    from espnet_slurp_tpu_torch.decode import beam as beam_mod
    top_k = beam_mod._top_k
    beam_mod._top_k = wrap(top_k)
    try:
        yield
    finally:
        beam_mod._top_k = top_k


def recording(picks):
    """A _top_k wrapper that appends each call's indices to ``picks``."""
    def wrap(top_k):
        def rec(x, k):
            vals, idx = top_k(x, k)
            picks.append(idx)
            return vals, idx
        return rec
    return wrap


def search_parity(torch, search, card, cpu, picks, n):
    """Holds the card's search against the CPU's on the first n rows
    (each batch_beam_search(..., return_nbest=True) on the CPU; ``picks``
    the card search's _top_k indices by ``recording``; ``search()`` runs
    the CPU search again) and returns a note; raises unless the replay
    holds and at most half of the rows differ."""
    def hyp(res, i):
        return res[0][i, :res[1][i]]

    def same(a, b):
        return a.shape == b.shape and torch.equal(a, b)

    margins = []

    def replay(top_k):
        def rep(x, k):
            if len(margins) == len(picks):
                raise AssertionError("the replay outran the card's search")
            sel = picks[len(margins)].to(x.device)
            chosen = x.gather(-1, sel)
            weakest = chosen.min(-1).values
            strongest = x.scatter(-1, sel, -float("inf")).max(-1).values
            margins.append(float(((strongest - weakest)
                                  / weakest.abs().clamp_min(1.0)).max()))
            return chosen, sel
        return rep

    with top_k_as(replay):
        res = tuple(x.cpu() for x in search())

    def beam(r, i):  # the live hypotheses of row i -> their scores
        return {tuple(r[2][i, j, :r[3][i, j]].tolist()): float(r[4][i, j])
                for j in range(r[2].shape[1]) if abs(float(r[4][i, j])) < 1e29}

    # the replay must hold the card's beam; the last choice, the best,
    # is held like the others
    follows, score_err = len(margins) == len(picks), 0.0
    for i in range(n):
        got, rep = beam(card, i), beam(res, i)
        follows = follows and got.keys() == rep.keys()
        score_err = max([score_err] + [
            abs(v - rep[h]) / max(abs(rep[h]), 1.0)
            for h, v in got.items() if h in rep])
        best = rep.get(tuple(hyp(card, i).tolist()))
        margins.append(float("inf") if best is None else
                       (max(rep.values()) - best) / max(abs(best), 1.0))
    differ = [i for i in range(n) if not same(hyp(card, i), hyp(cpu, i))]
    note = (f"rows that differ {differ} (best scores card "
            f"{card[4][differ, 0].tolist()}, CPU {cpu[4][differ, 0].tolist()}"
            f"); the CPU replaying the card's {len(picks)} choices ends in "
            f"its hypotheses {follows}, {sum(m > 0 for m in margins)} "
            f"choices not the CPU's own top-k, the largest margin "
            f"{max(margins):.3e} of the k-th score, scores within "
            f"{score_err:.3e} of the card's (tolerance {TIE_RTOL:.0e})")
    if not (follows and max(margins) <= TIE_RTOL and score_err <= TIE_RTOL
            and len(differ) <= n // 2):
        raise AssertionError(f"card vs CPU search: {note}")
    return note


def decode_phase(torch, card, exp, dev8, what):
    """Phase 18 (e): bin/asr_inference on ``exp`` (its n-best average)
    decodes the N_UTT dev utterances at beam BEAM, ctc_weight CTC_WEIGHT,
    max_len MAX_LEN: RTF from score.txt. Then the same weights in fp32:
    one encoder output on the card, and the beam search from it on the
    card and on the CPU over MOE_CMP_UTT of the utterances; tokens and
    lengths equal on every row but proved near-ties, the card's choices and
    scores replayed on the CPU (search_parity)."""
    from espnet_slurp_tpu_torch.bin import asr_inference
    from espnet_slurp_tpu_torch.data.fileio import load_wav, \
        read_2column_text
    from espnet_slurp_tpu_torch.decode.beam import (BeamSearchConfig,
                                                    batch_beam_search)
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.tasks.asr import Speech2Text

    dec = exp.parent / f"decode_{exp.name}"
    t0 = time.perf_counter()
    asr_inference.main([
        "--exp_dir", str(exp), "--data_dir", str(dev8), "--output_dir",
        str(dec), "--beam_size", str(BEAM), "--ctc_weight", str(CTC_WEIGHT),
        "--max_len", str(MAX_LEN), "--batch_size", str(N_UTT)])
    call_s = time.perf_counter() - t0
    score = dict(line.split() for line in
                 (dec / "score.txt").read_text().splitlines())
    if sorted(score) != ["CER", "RTF", "WER"]:
        raise AssertionError(f"phase 18 (e) {what}: score.txt {score}")
    s2t = Speech2Text.from_exp_dir(str(exp), device="cuda")
    cfg = dataclasses.replace(s2t.model.cfg, dtype="float32")
    state = s2t.model.state_dict()
    wavs = sorted(read_2column_text(dev8 / "wav.scp").items())[:MOE_CMP_UTT]
    buf, lens = s2t.pad_batch([load_wav(p)[0] for _, p in wavs])
    beam = BeamSearchConfig(beam_size=BEAM, max_len=MAX_LEN,
                            ctc_weight=CTC_WEIGHT)
    got, secs = {}, {}
    with torch.inference_mode():
        model = ASRModel(cfg, device="cuda")
        model.load_state_dict(state)
        hs, hl = model.encode(torch.from_numpy(buf).cuda(),
                              torch.from_numpy(lens).cuda(), s2t.mvn_stats)
        picks = []
        for dev in ("cuda", "cpu"):
            if dev == "cpu":
                model = ASRModel(cfg, device="cpu")
                model.load_state_dict(state)
            t0 = time.perf_counter()
            with (top_k_as(recording(picks)) if dev == "cuda" else
                  contextlib.nullcontext()):
                res = batch_beam_search(model, hs.to(dev), hl.to(dev), beam,
                                        return_nbest=True)
            got[dev] = tuple(x.cpu() for x in res)
            secs[dev] = time.perf_counter() - t0
        n = len(wavs)
        note = search_parity(
            torch, lambda: batch_beam_search(model, hs.cpu(), hl.cpu(), beam,
                                             return_nbest=True),
            got["cuda"], got["cpu"], picks, n)
    lg = got["cuda"][1]
    print(f"phase 18 (e) {what}: bin/asr_inference {N_UTT} x {UTT_SECONDS} "
          f"s, beam {BEAM}, ctc {CTC_WEIGHT}, max_len {MAX_LEN}: score.txt "
          f"{score} (RTF {score['RTF']}; the whole CLI call {call_s:.2f} s) "
          f"on {card}; fp32 beam search from one card encode, {n} "
          f"utterances: lengths {lg[:n].tolist()}, card {secs['cuda']:.2f} "
          f"s, CPU {secs['cpu']:.2f} s; {note}")
    return float(score["RTF"])


def moe_phases(torch, card, root, corpus, train_step_s):
    """Phase 18, (a)-(f), on phases 16-17's corpus under ``root``. Returns
    the launches per step of the MoE model's and the interCTC models'
    steps."""
    t_phase = time.perf_counter()
    exp_moe, recipe_step = moe_recipe_phase(torch, card, root, corpus)
    moe_step = moe_train_phase(torch, card, train_step_s)
    if moe_step != recipe_step:
        raise AssertionError(f"phase 18: (a)'s step {recipe_step} against "
                             f"(b)'s {moe_step}")
    inter = interctc_phase(torch, card)
    moe_routing_phase(torch, card)
    remat_phase(torch, card)
    exp_sc = selfcond_cli_train(torch, root, corpus)
    rtf = {what: decode_phase(torch, card, exp, corpus[2], what)
           for what, exp in (("MoE", exp_moe),
                             ("self-conditioning", exp_sc))}
    print(f"phase 18: decode RTF {rtf}; {time.perf_counter() - t_phase:.1f} "
          f"s on {card}")
    return moe_step, inter



# Phase 19: the fork's contextual biasing and KB-MBR (conf/train_mbr_kb.yaml)
# and the KB-aware transducer. Biasing lists are KB_WORDS synthetic words
# over a suffix-marked token list (the fork's dictionary convention): word
# pieces p{j}, those with j odd ending a word ("p{j}▁"). Each train batch
# goes through TCPGenBatchAugmenter with recipe/ablation_run.py:484-487's
# settings. The MBR term runs with the yaml's beam 4 and pre-beam 12, the
# reference's max_len 96 and rare_weight 0.5 over the list's token set.
KB_YAML = "conf/train_mbr_kb.yaml"
KB_WORDS, KB_LEN, KB_DB_DROP, KB_SCHED = 1000, 30, 0.3, 3
# A word of a batch's text is a biasing word with this probability, else a
# common one (a second synthetic list, disjoint from the first).
KB_SHARE = 0.3
KB_INIT = "build/chip_smoke_kb_init"  # (f): phase 15's n-best average
# (c): the biased searches card vs CPU (fp32, one card encode).
KB_CMP_MAX_LEN = 32


class PieceTokenizer:
    """Word <-> pieces through a lexicon ({word: pieces}), for Speech2Text's
    biasing list: text2tokens splits on spaces and spells each word by its
    pieces; tokens2text joins pieces and ends a word at a '▁'."""

    def __init__(self, lexicon):
        self.lexicon = lexicon

    def text2tokens(self, line):
        return [p for w in line.split() for p in self.lexicon[w]]

    def tokens2text(self, tokens):
        return "".join(t.replace("▁", " ") for t in tokens).strip()


def suffix_token_list(vocab):
    """<blank>, <unk>, pieces p0..p{vocab-4} (odd ones end a word:
    "p{j}▁"), <sos/eos>: a suffix-convention list for
    slu/kb.py:boundary_token_ids."""
    return (["<blank>", "<unk>"]
            + [f"p{j}▁" if j % 2 else f"p{j}" for j in range(vocab - 3)]
            + ["<sos/eos>"])


def kb_lexicons(vocab, rng):
    """(biasing words, common words) as piece-id tuples, KB_WORDS each,
    disjoint: 0-3 inner pieces and a word-final one."""
    inner = np.arange(2, vocab - 1)[0::2]  # p{even}
    final = np.arange(3, vocab - 1)[0::2]  # p{odd}▁
    seen, out = set(), []
    while len(out) < 2 * KB_WORDS:
        w = tuple(int(x) for x in rng.choice(inner, rng.randint(4))) \
            + (int(rng.choice(final)),)
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out[:KB_WORDS], out[KB_WORDS:]


def kb_text(rng, b, u, words, common):
    """[b, u] label ids: words drawn from the biasing list with probability
    KB_SHARE, else from the common list, cut at u."""
    rows = []
    for _ in range(b):
        seq = []
        while len(seq) < u:
            pool = words if rng.rand() < KB_SHARE else common
            seq.extend(pool[rng.randint(len(pool))])
        rows.append(seq[:u])
    return np.asarray(rows, np.int64)


def kb_augmenter(vocab, words, prefix=False):
    """TCPGenBatchAugmenter over ``words`` at ablation_run.py's settings,
    with the suffix (or prefix) convention's boundary ids."""
    from espnet_slurp_tpu_torch.slu.kb import (TCPGenBatchAugmenter,
                                               boundary_token_ids)
    bset, conv = boundary_token_ids(suffix_token_list(vocab))
    if conv:
        raise AssertionError("the synthetic token list is suffix-marked")
    if prefix:  # word-initial pieces instead: the prefix convention's ids
        bset = {w[0] for w in words}
    return TCPGenBatchAugmenter(words, bset, vocab - 1, vocab - 1,
                                prefix_boundary=prefix, kb_len=KB_LEN,
                                db_drop=KB_DB_DROP, sched_epochs=KB_SCHED,
                                seed=7), bset


def kb_batches(torch, b, seconds, u, vocab, words, common, aug, epoch=2,
               keys=None):
    """A train batch on the card (train_batch's speech, kb_text's labels)
    and a callable that augments it anew (a fresh trie, walk and labels a
    call, on the host, then to the card); the callable returns the batch
    and the augmenter's host ms. ``keys`` limits the augmenter's keys
    taken (the transducer takes the trie and the walk only)."""
    rng = np.random.RandomState(0)
    base = train_batch(torch, rng, b, FS * seconds, u, vocab, "cuda")
    text = kb_text(rng, b, u, words, common)
    base["text"] = torch.from_numpy(text).cuda()

    def make():
        t0 = time.perf_counter()
        extra = aug.augment({"text": text}, epoch)
        ms = (time.perf_counter() - t0) * 1e3
        out = dict(base)
        out.update({k: v.cuda(non_blocking=True) for k, v in extra.items()
                    if k != "text" and (keys is None or k in keys)})
        return out, ms
    return make


def kb_config(**model):
    """conf/train_mbr_kb.yaml's model (12 x 256, d_ff 2048, bf16, use_tcpgen,
    ctc 0.3, its vocab 5000) with ablation_run.py's pointer and gate loss
    weights, SpecAug on, and ``model``."""
    from espnet_slurp_tpu_torch.tasks import asr as task
    return dataclasses.replace(
        task.load_task_config(KB_YAML).model, tcpgen_ptr_loss_weight=1.0,
        tcpgen_gate_loss_weight=0.2, **model)


def kb_mbr_config(vocab_words, **kw):
    """The yaml's MBR section (weight 0.5, beam 4, pre-beam 12, rare_weight
    0.5) with kb_tokens the biasing list's token set, and ``kw``."""
    from espnet_slurp_tpu_torch.tasks import asr as task
    tokens = tuple(sorted({p for w in vocab_words for p in w}))
    return dataclasses.replace(task.load_task_config(KB_YAML).mbr,
                               kb_tokens=tokens, **kw)


def kb_aux(mbr, vocab):
    """model -> the MBR aux_loss_fn with mbr's KB token mask, as
    ASRTask.train builds it."""
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask, ASRTaskConfig
    from espnet_slurp_tpu_torch.train.mbr import make_mbr_aux_loss

    def make(model):
        mask = ASRTask._kb_token_mask(ASRTaskConfig(mbr=mbr), vocab)
        return make_mbr_aux_loss(model, mbr, kb_token_mask=mask.to(
            model.device))
    return make


def kb_train_phase(torch, card, train_step_s, flagship_peak_mb):
    """Phase 19 (a) and (b): the TCPGen step and the KB-MBR step on phase
    5's traffic with labels over the biasing list, each batch augmented
    anew; their launches by the wrappers' and host counts. Returns
    (tcpgen launches a step, MBR launches a step)."""
    from espnet_slurp_tpu_torch.decode import beam as beam_mod
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    cfg = kb_config()
    v, n = cfg.vocab_size, cfg.num_encoder_blocks
    words, common = kb_lexicons(v, np.random.RandomState(3))
    aug, _ = kb_augmenter(v, words)
    state = ASRTask.init_params(ASRModel(cfg, device="cpu"), 0).state_dict()
    audio_s = TRAIN_B * TRAIN_SECONDS
    mbr = kb_mbr_config(words, weight=0.5)
    out = {}
    for label, aux, times in (("tcpgen", None, 1),
                              ("mbr", kb_aux(mbr, v), 2)):
        model = ASRModel(cfg, device="cuda")
        model.load_state_dict(state)
        make = kb_batches(torch, TRAIN_B, TRAIN_SECONDS, TRAIN_U, v, words,
                          common, aug)
        what = (f"phase 19 ({'a' if aux is None else 'b'}) {label} step: "
                f"{KB_YAML}'s model ({cfg.num_encoder_blocks} x "
                f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.dtype}, dropout "
                f"{cfg.dropout_rate}, {cfg.tcpgen_tree_encoder} tree "
                f"encoder), B={TRAIN_B} x {TRAIN_SECONDS} s, U={TRAIN_U}, "
                f"kb_len {KB_LEN}")
        search_s = []
        search = beam_mod.batch_beam_search

        def timed_search(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = search(*a, **kw)
            torch.cuda.synchronize()
            search_s.append(time.perf_counter() - t0)
            return res

        beam_mod.batch_beam_search = timed_search
        try:
            run = run_train_steps(torch, what, model, make, card, audio_s,
                                  aux=aux, falls=aux is None)
        finally:
            beam_mod.batch_beam_search = search
        want = flagship_step_want(n, times)
        check_per_step(what, run.launches, want)
        check_routes(what, run.routes, K1_WARP + tuple(K4_BF16_LAUNCHES),
                     TRAIN_STEPS)
        print(f"{what}: step {run.step_s:.4f} s, device busy "
              f"{run.busy_ms:.2f} ms, augmenter {run.host_ms:.2f} ms a "
              f"batch on the host, peak {run.peak_mb:.1f} MB on {card}")
        if aux is None:
            print(f"{what}: {run.step_s:.4f} s against phase 5's flagship "
                  f"{train_step_s:.4f} s ({run.step_s / train_step_s:.2f}x),"
                  f" peak {run.peak_mb:.1f} MB against "
                  f"{flagship_peak_mb:.1f}; launches a step {want} held on "
                  f"{card}")
        else:
            # the warm-up's, the timed steps' and the profiled step's
            timed = search_s[1:1 + TRAIN_STEPS]
            share = sum(timed) / sum(run.times)
            keys = ("loss_mbr", "mbr_expected_risk", "mbr_rare_risk")
            if len(search_s) != TRAIN_STEPS + 2 or not all(
                    k in run.stats for k in keys):
                raise AssertionError(f"{what}: searches {len(search_s)}, "
                                     f"stats {run.stats}")
            print(f"{what}: MBR beam {mbr.beam_size}, pre-beam "
                  f"{mbr.pre_beam_size}, max_len {mbr.max_len}, rare_weight "
                  f"{mbr.rare_weight} over {len(mbr.kb_tokens)} KB tokens: "
                  f"n-best search s by step {[round(x, 4) for x in timed]}, "
                  f"{100 * share:.1f}% of the steps' time; launches a step "
                  f"{want} (the re-encode doubles K2 and K3 each way) held "
                  f"on {card}")
        out[label] = want
        del model
        torch.cuda.empty_cache()
    return out["tcpgen"], out["mbr"]


def kb_fp32_phase(torch, card):
    """Phase 19 (c): fp32 card against CPU at phase 6's short batch (labels
    over the biasing list, one augmented trie, dropout 0.1 with phase 6's
    seeds, SpecAug off): the TCPGen loss, its stats and its gradients for
    each tree encoder; the same with the KB-MBR term (without the ground
    truth among the hypotheses); then the biased beam search (beam BEAM,
    ctc CTC_WEIGHT, max_len KB_CMP_MAX_LEN) from one card encode on both
    devices, in the suffix and the prefix convention and with force_p_gen:
    tokens and lengths equal on every row but proved near-ties, the card's
    choices and scores replayed on the CPU (search_parity)."""
    from espnet_slurp_tpu_torch.decode.beam import (BeamSearchConfig,
                                                    batch_beam_search)
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.slu.kb import build_trie
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    speech, lens, _, tlens = short_batch(5000)
    words, _ = kb_lexicons(5000, np.random.RandomState(3))
    # labels of biasing words only, so that the pointer and gate losses
    # have pointed steps in two short rows
    text = kb_text(np.random.RandomState(4), 2, int(tlens.max()), words,
                   words)
    text[1, tlens[1]:] = -1
    aug, _ = kb_augmenter(5000, words)
    extra = {k: v.numpy() for k, v in aug.augment({"text": text}, 2).items()
             if k != "text"}
    # Without the ground truth as hypothesis 0: its teacher-forced score
    # leads an untrained model's n-best by tens of nats, so the softmax
    # over hypotheses would saturate and the MBR gradient vanish.
    mbr = kb_mbr_config(words, weight=0.5, include_gt=False)
    # Every tree encoder on a 2-block encoder (the pointer sits after the
    # decoder, whose 6 blocks stay; the 12-block encoder's fp32 step is
    # phase 6's).
    for enc, aux, blocks in (("gcn", None, 2), ("gat", None, 2),
                             ("sage", None, 2), ("treelstm", None, 2),
                             ("gcn", kb_aux(mbr, 5000), 2)):
        cfg = kb_config(dtype="float32", specaug=None, dropout_rate=DROPOUT,
                        tcpgen_tree_encoder=enc, num_encoder_blocks=blocks)
        state = ASRTask.init_params(ASRModel(cfg, device="cpu"),
                                    0).state_dict()
        compare_cpu_card(
            torch, f"phase 19 (c) fp32 TCPGen step, {enc} tree encoder, "
            f"{blocks} encoder blocks"
            + (", with the KB-MBR term" if aux else ""), ASRModel, cfg,
            state, speech, lens, text, tlens, extra=extra, aux=aux,
            pointer_stats=("loss_ptr", "loss_gate", "p_gen_bias"))
    cfg = kb_config(dtype="float32")
    state = ASRTask.init_params(ASRModel(cfg, device="cpu"), 0).state_dict()
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = ASRModel(cfg, device=dev)
        models[dev].load_state_dict(state)
    trie = build_trie(words)
    beam = BeamSearchConfig(beam_size=BEAM, max_len=KB_CMP_MAX_LEN,
                            ctc_weight=CTC_WEIGHT)
    with torch.inference_mode():
        hs, hl = models["cuda"].encode(torch.from_numpy(speech).cuda(),
                                       torch.from_numpy(lens).cuda())
        for prefix, force in ((False, None), (True, None), (False, 0.9)):
            _, bset = kb_augmenter(5000, words, prefix=prefix)
            mask = torch.zeros(5001, dtype=torch.bool)
            mask[sorted(bset)] = True
            got, picks = {}, []
            for dev, model in models.items():
                biasing = {
                    "trie": {f"trie_{k}": torch.from_numpy(getattr(t, k))
                             .to(dev) for t in (trie,) for k in (
                                 "token", "children_tok", "children_node",
                                 "n_children")},
                    "boundary_mask": mask.to(dev), "dead": trie.dead,
                    "prefix_boundary": prefix, "smoothprob": 1.0,
                    "force_p_gen": force}
                with (top_k_as(recording(picks)) if dev == "cuda" else
                      contextlib.nullcontext()):
                    res = batch_beam_search(model, hs.to(dev), hl.to(dev),
                                            beam, biasing=biasing,
                                            return_nbest=True)
                got[dev] = tuple(x.cpu() for x in res)
            lg, lc = got["cuda"][1], got["cpu"][1]
            note = search_parity(
                torch, lambda: batch_beam_search(
                    models["cpu"], hs.cpu(), hl.cpu(), beam, biasing=biasing,
                    return_nbest=True),
                got["cuda"], got["cpu"], picks, len(lens))
            print(f"phase 19 (c) biased beam search fp32, "
                  f"{'prefix' if prefix else 'suffix'} convention, "
                  f"force_p_gen {force}: lengths card {lg.tolist()} CPU "
                  f"{lc.tolist()}; {note} on {card}")
    del models


# The transducer step's peak in PERF.md §5 (transducer_flagship_config()
# with fused_conv, 32 x 15 s, bf16, dropout 0.1; PRs 17-18's chip runs).
TR_PEAK_MB = 10613.1


def kb_transducer_phase(torch, card):
    """Phase 19 (d): transducer_flagship_config() with use_tcpgen and
    fused_conv (bf16, dropout 0.1, SpecAug on, the reference's init from a
    seed) on 32 x 15 s, U 64, V 600, each batch augmented anew over a
    600-token biasing list: per step phase 9's launches (K2 24, K3 12, K6
    12 each way, K5 and the auxiliary CTC's K1 once; K5 and K1 on their
    warp routes, K6 on its bf16 launches by the host counts); step
    seconds and peak memory beside TR_PEAK_MB. Returns the launches a
    step."""
    from espnet_slurp_tpu_torch.models.transducer import TransducerModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    cfg = dataclasses.replace(transducer_config(), use_tcpgen=True)
    v, n = cfg.asr.vocab_size, cfg.asr.num_encoder_blocks
    words, common = kb_lexicons(v, np.random.RandomState(5))
    aug, _ = kb_augmenter(v, words)
    state = ASRTask.init_params(TransducerModel(cfg, device="cpu"),
                                0).state_dict()
    model = TransducerModel(cfg, device="cuda")
    model.load_state_dict(state)
    what = (f"phase 19 (d) KB-aware transducer: B={TR_B} x {TRAIN_SECONDS} "
            f"s, U={TR_U}, V={v}, fused_conv, bf16, dropout "
            f"{cfg.asr.dropout_rate}, kb_len {KB_LEN}")
    make = kb_batches(torch, TR_B, TRAIN_SECONDS, TR_U, v, words, common,
                      aug, keys=("trie_token", "trie_children_tok",
                                 "trie_children_node", "trie_n_children",
                                 "node", "p_gen_mask"))
    run = run_train_steps(torch, what, model, make, card,
                          TR_B * TRAIN_SECONDS)
    launches, step_s, peak, routes = (run.launches, run.step_s, run.peak_mb,
                                      run.routes)
    want = {"fused_ffn": 2 * n, "fused_ffn_bwd": 2 * n,
            "rel_flash_attention": n, "rel_flash_attention_bwd": n,
            "fused_conv_module": n, "fused_conv_module_bwd": n,
            "rnnt_lattice": 1, "rnnt_lattice_bwd": 1,
            "ctc_lattice": 1, "ctc_lattice_bwd": 1}
    check_per_step(what, launches, want)
    check_routes(what, routes, {**dict.fromkeys(K1_WARP, 1),
                                **dict.fromkeys(K5_WARP, 1),
                                **dict.fromkeys(K6_BF16_LAUNCHES, n)},
                 TRAIN_STEPS)
    print(f"{what}: peak {peak:.1f} MB against the plain transducer step's "
          f"{TR_PEAK_MB} (PERF.md §5), step {step_s:.4f} s, device busy "
          f"{run.busy_ms:.2f} ms, augmenter {run.host_ms:.2f} ms a batch on "
          f"the host; launches a step {want} held on {card}")
    del model
    torch.cuda.empty_cache()
    return want


def kb_decode_phase(torch, card):
    """Phase 19 (e): Speech2Text on conf/train_mbr_kb.yaml's model (the
    reference's init from a seed, bf16) decodes the serving traffic (N_UTT x
    UTT_SECONDS s, beam BEAM, ctc CTC_WEIGHT, max_len MAX_LEN) without and
    with biasing_words (the KB_WORDS-word list, spelled by PieceTokenizer);
    each encode launches K2 24 and K3 12 and nothing else counted; RTF of
    each, in the same call."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask, Speech2Text

    cfg = kb_config()
    v, n = cfg.vocab_size, cfg.num_encoder_blocks
    state = ASRTask.init_params(ASRModel(cfg, device="cpu"), 0).state_dict()
    tokens = suffix_token_list(v)
    words, _ = kb_lexicons(v, np.random.RandomState(3))
    lexicon = {f"kw{i}": [tokens[p] for p in w] for i, w in enumerate(words)}
    rng = np.random.RandomState(0)
    speeches = [rng.randn(FS * UTT_SECONDS).astype(np.float32) * 0.1
                for _ in range(N_UTT)]
    rtf = {}
    for biased in (False, True):
        s2t = Speech2Text(cfg, state, tokens, max_len=MAX_LEN,
                          beam_size=BEAM, ctc_weight=CTC_WEIGHT,
                          device="cuda", tokenizer=PieceTokenizer(lexicon),
                          biasing_words=list(lexicon) if biased else None)
        s2t.decode_batch(speeches)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        texts = s2t.decode_batch(speeches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c for k, c in read_counts().items() if c}
        label = "biased" if biased else "unbiased"
        rtf[label] = wall / (N_UTT * UTT_SECONDS)
        print(f"phase 19 (e) Speech2Text {label}: {N_UTT} x {UTT_SECONDS} "
              f"s, beam {BEAM}, ctc {CTC_WEIGHT}, max_len {MAX_LEN}"
              + (f", {len(lexicon)} biasing words (trie of "
                 f"{s2t.biasing['dead'] + 1} nodes)" if biased else "")
              + f": wall {wall:.3f} s, RTF {rtf[label]:.5f}, hypothesis "
              f"words {[len(x.split()) for x in texts]}; launches "
              f"{launches} on {card}")
        if launches != {"fused_ffn": 2 * n, "rel_flash_attention": n} \
                or len(texts) != N_UTT:
            raise AssertionError(f"phase 19 (e) {label}: launches "
                                 f"{launches}, {len(texts)} texts")
        del s2t
    print(f"phase 19 (e): RTF biased {rtf['biased']:.5f} against unbiased "
          f"{rtf['unbiased']:.5f} ({rtf['biased'] / rtf['unbiased']:.2f}x) "
          f"on {card}")
    return rtf


# (f): a train subset of phase 15's corpus at the yaml's batch_bins: two
# steps in its one epoch.
KB_F_TRAIN = 32


def kb_recipe_phase(torch, card, root, corpus):
    """Phase 19 (f): conf/train_mbr_kb.yaml through bin/asr_train on the
    card on phase 15's corpus (KB_F_TRAIN train utterances, its 16 dev
    ones), overriding only exp_dir, the data dirs, init_params_from (phase
    15's n-best average, KB_INIT) and max_epoch 1. Fails unless the epoch
    makes at least 2 steps, each with the KB-MBR step's launches
    (flagship_step_want(12, 2)), and reporter.json carries finite
    loss_mbr and mbr_expected_risk."""
    import shutil
    from pathlib import Path

    from espnet_slurp_tpu_torch.bin import asr_train

    t0 = time.perf_counter()
    train_dir, dev_dir, _ = corpus
    sub = root / "train_kb"
    sub.mkdir()
    for name in ("wav.scp", "text"):
        lines = (train_dir / name).read_text().splitlines()[:KB_F_TRAIN]
        (sub / name).write_text("\n".join(lines) + "\n")
    exp = root / "exp_mbr_kb"
    init = Path(KB_INIT).resolve() / "valid.loss.ave_3best"
    per_step, clock = [], []
    make = step_recorder(torch, per_step, clock)
    try:
        asr_train.main(["--config", KB_YAML, "--set", f"exp_dir={exp}",
                        f"data.train_dir={sub}", f"data.valid_dir={dev_dir}",
                        f"init_params_from={init}", "max_epoch=1"])
    finally:
        from espnet_slurp_tpu_torch.tasks import asr as task
        task.make_train_step = make
    shutil.rmtree(KB_INIT, ignore_errors=True)
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    train = hist[-1]["train"] if hist else {}
    want = flagship_step_want(12, 2)
    want = {k: want.get(k, 0) for k in COUNTED}
    bad = [i for i, (w, _, _) in enumerate(per_step) if w != want]
    keys = ("loss", "loss_mbr", "mbr_expected_risk")
    print(f"phase 19 (f): {KB_YAML} through bin/asr_train (exp_dir, data "
          f"dirs, init_params_from {init.name}, max_epoch 1 overridden): "
          f"{len(per_step)} steps, launches a step "
          f"{per_step[0][0] if per_step else None}, by instance "
          f"{per_step[0][1] if per_step else None}; train "
          f"{ {k: train.get(k) for k in keys + ('step_time', 'iter_time')} }"
          f"; {time.perf_counter() - t0:.1f} s on {card}")
    if not (len(hist) == 1 and len(per_step) >= 2 and not bad
            and all(np.isfinite(train.get(k, np.nan)) for k in keys)):
        raise AssertionError(f"phase 19 (f): steps {per_step}, reporter "
                             f"{hist}")


def recipe_phases(torch, card, train_step_s):
    """Phases 16, 17, 18 and 19 (f) on one synthetic corpus (cli_corpus)
    under RECIPE_ROOT, removed at the end. Returns the launches per train
    step of phases 16 and 17, and phase 18's (moe_phases)."""
    import shutil
    from pathlib import Path

    root = Path(RECIPE_ROOT).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    corpus = cli_corpus(root)
    print(f"phases 16-18: corpus of {CLI_TRAIN} + {CLI_DEV} x {UTT_SECONDS} "
          f"s written in {time.perf_counter() - t0:.1f} s")
    recipe = recipe_phase(torch, card, root, corpus)
    transducer = transducer_cli_phase(torch, card, root, corpus)
    moe = moe_phases(torch, card, root, corpus, train_step_s)
    kb_recipe_phase(torch, card, root, corpus)
    shutil.rmtree(root, ignore_errors=True)
    return recipe, transducer, moe


# Phase 20: two-pass SLU with the BERT postdecoder
# (conf/train_slu_tcpgen_gcn.yaml) on a synthetic SLURP-entity corpus
# written under the gitignored build/ (removed at the end): SLU_TRAIN train
# and SLU_DEV dev utterances of 1.5-6 s, transcripts of 3-20 words over
# SLU_WORDS synthetic words, an intent of SLU_INTENTS and 0-2 entities
# each, in recipe/prepare_slurp.py:format_text's layout. The first pass of
# (c) is a flagship that bin/asr_train trains one epoch on the train
# split's transcripts (phase 15's config: char tokens, sorted batches of
# CLI_BATCH).
SLU_YAML = "conf/train_slu_tcpgen_gcn.yaml"
SLU_ROOT = "build/chip_smoke_slu"
SLU_WORDS, SLU_TRAIN, SLU_DEV, SLU_INTENTS = 2000, 200, 4, 60
SLU_SCENARIOS = ("alarm", "audio", "calendar", "cooking", "datetime",
                 "email", "general", "iot", "lists", "music", "news", "play",
                 "qa", "recommendation", "social", "takeaway", "transport",
                 "weather")
SLU_ACTIONS = ("set", "query", "remove", "volume_up", "volume_mute",
               "factoid", "hue_lightoff", "quirky", "recipe", "ticket",
               "podcasts", "radio", "sendemail", "createoradd", "order",
               "events", "traffic", "convert")
SLU_ENTITY_TYPES = ("date", "time", "place_name", "person", "event_name",
                    "business_name", "device_type", "food_type", "media_type",
                    "artist_name", "song_name", "weather_descriptor",
                    "timeofday", "relation", "house_place", "transport_type",
                    "currency_name", "list_name", "color_type", "player_setting")
# Each encode of the yaml's model: K2 twice and K3 once a block.
SLU_BLOCKS = 12
SLU_REPORTED = ("loss", "loss_ctc", "loss_att", "step_time", "iter_time")


def slu_split(d, split, count, rng, intents):
    """d/{wav.scp,text,transcript}: count utterances of 1.5-6 s, 3-20 words
    of w0000..w{SLU_WORDS - 1} (a tone a word), an intent and 0-2 entities
    of 1-2 words, written by recipe/prepare_slurp.py:format_text."""
    from espnet_slurp_tpu_torch.data.fileio import DatadirWriter, write_wav
    from espnet_slurp_tpu_torch.recipe.prepare_slurp import format_text

    (d / "wav").mkdir(parents=True, exist_ok=True)
    with DatadirWriter(d) as w:
        for i in range(count):
            n_words = rng.randint(3, 21)
            ids = rng.randint(SLU_WORDS, size=n_words)
            words = [f"w{j:04d}" for j in ids]
            spans, taken = [], set()
            for _ in range(rng.randint(3)):
                start, width = rng.randint(n_words), rng.randint(1, 3)
                cells = set(range(start, min(start + width, n_words)))
                if cells & taken:
                    continue
                taken |= cells
                spans.append((min(cells), max(cells) + 1,
                              SLU_ENTITY_TYPES[rng.randint(
                                  len(SLU_ENTITY_TYPES))]))
            annotated, k = [], 0
            for start, end, typ in sorted(spans):
                annotated += words[k:start]
                annotated.append(f"[{typ} : {' '.join(words[start:end])}]")
                k = end
            annotated += words[k:]
            scenario, action = intents[rng.randint(len(intents))]
            rec = {"sentence": " ".join(words),
                   "sentence_annotation": " ".join(annotated),
                   "scenario": scenario, "action": action}
            n = int(FS * rng.uniform(1.5, 6.0))
            seg = n // n_words
            t = np.arange(seg) / FS
            wav = np.concatenate([0.3 * np.sin(2 * np.pi * (200 + 2 * j) * t)
                                  for j in ids])
            wav = np.pad(wav, (0, n - len(wav))) + 0.01 * rng.randn(n)
            uid = f"slurp_{split}_{i:04d}"
            path = (d / "wav" / f"{uid}.wav").resolve()
            write_wav(str(path), wav.astype(np.float32), FS)
            w["wav.scp"][uid] = str(path)
            w["text"][uid] = format_text(rec, "entity")
            w["transcript"][uid] = format_text(rec, "transcript")
    return d


def slu_corpus(root):
    """root/{train,dev} (slu_split) over SLU_INTENTS scenario_action pairs;
    returns both directories."""
    rng = np.random.RandomState(11)
    pairs = [(s, a) for s in SLU_SCENARIOS for a in SLU_ACTIONS]
    intents = [pairs[i] for i in rng.permutation(len(pairs))[:SLU_INTENTS]]
    dirs = [slu_split(root / split, split, count, rng, intents)
            for split, count in (("train", SLU_TRAIN), ("dev", SLU_DEV))]
    return dirs


def slu_config(**over):
    """conf/train_slu_tcpgen_gcn.yaml as written, with ``over`` (nested
    dicts) merged into it."""
    from espnet_slurp_tpu_torch.tasks.slu import load_slu_config
    return load_slu_config(SLU_YAML, over)


def slu_step_want():
    """An SLU train step's launches each way by the wrappers' counts: the
    acoustic encoder's K2 and K3, the CTC term's K1 (from the head's
    logits: no K4); the deliberation blocks and the BERT are eager."""
    return {"fused_ffn": 2 * SLU_BLOCKS, "fused_ffn_bwd": 2 * SLU_BLOCKS,
            "rel_flash_attention": SLU_BLOCKS,
            "rel_flash_attention_bwd": SLU_BLOCKS,
            "ctc_lattice": 1, "ctc_lattice_bwd": 1}


def slu_host_want(n_rows):
    """The host counts of one SLU train step on n_rows = B x T' rows: the
    flagship step's at dropout DROPOUT (cli_step_want) without K4's."""
    _, hosts = cli_step_want(n_rows, SLU_BLOCKS)
    return {k: v for k, v in hosts.items() if k not in K4_BF16_LAUNCHES}


def slu_train_phase(torch, card, root, corpus, train_step_s):
    """Phase 20 (a): the yaml's model (the reference's initialisation from
    a seed) through make_train_step on the first batch of the yaml's numel
    sampler over the train split (batch_bins 8,000,000 samples): every
    step K2 24, K3 12 and K1 1 each way by the wrappers' and the host
    counts, K4, K5 and K6 none; step seconds, audio-s/s, peak memory and
    a profiled step's busy ms beside phase 5's flagship. Returns the
    launches a step and the vocabulary sizes."""
    from espnet_slurp_tpu_torch.data.prefetch import to_device
    from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
    from espnet_slurp_tpu_torch.ops.kernels import build
    from espnet_slurp_tpu_torch.slu.model import SLUModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask
    from espnet_slurp_tpu_torch.tasks.slu import SLUTask

    train_dir, dev_dir = corpus
    cfg = slu_config(exp_dir=str(root / "exp_a"), data={
        "train_dir": str(train_dir), "valid_dir": str(dev_dir)})
    tok, conv, extra, mcfg = SLUTask.prepare_vocab(cfg)
    ds = SLUTask.build_dataset(cfg, cfg.data.train_dir, tok, conv, extra)
    t0 = time.perf_counter()
    np_batch = next(iter(SLUTask.build_iter_factory(cfg, ds, True)(1)))
    host_s = time.perf_counter() - t0
    batch = to_device(np_batch, "cuda")
    b, n = np_batch["speech"].shape
    audio_s = float(np_batch["speech_lengths"].sum()) / FS
    model = ASRTask.init_params(SLUModel(mcfg, device="cuda"), cfg.data.seed)
    a = mcfg.asr
    what = (f"phase 20 (a) {SLU_YAML}: {a.num_encoder_blocks} x {a.d_model},"
            f" d_ff {a.d_ff}, {a.num_decoder_blocks} decoder blocks, "
            f"{a.dtype}, dropout {a.dropout_rate}, {mcfg.postdecoder} "
            f"postdecoder {mcfg.text_encoder_blocks} x d_ff "
            f"{mcfg.text_encoder_d_ff}, {mcfg.deliberation_blocks} "
            f"deliberation blocks; V {a.vocab_size}, transcript V "
            f"{mcfg.transcript_vocab_size}; a numel batch of B={b} (padded "
            f"to {n} samples, {audio_s:.1f} audio-s; transcripts up to "
            f"{int(np_batch['transcript_lengths'].max())} words, labels up "
            f"to {int(np_batch['text_lengths'].max())})")
    print(f"{what}: the batch read and collated in {host_s:.2f} s on the "
          f"host")
    hosts0 = build.launch_counts()
    run = run_train_steps(torch, what, model, batch, card, audio_s)
    hosts = build.launch_delta(hosts0, build.launch_counts())
    want = slu_step_want()
    check_per_step(what, run.launches, want)
    check_routes(what, run.routes, K1_WARP, TRAIN_STEPS)
    t_prime = Conv2dSubsampling.out_length_static(1 + n // 128)
    steps = TRAIN_STEPS + 2  # the warm-up and the profiled step too
    host_want = {k: v * steps for k, v in
                 slu_host_want(b * t_prime).items()}
    host_got = {k: hosts.get(k, 0) for k in host_want}
    stray = {k: v for k, v in hosts.items() if k not in host_want}
    print(f"{what}: host counts over {steps} steps {hosts}")
    if host_got != host_want or stray:
        raise AssertionError(f"{what}: host counts {hosts}, expected "
                             f"{host_want}")
    ratio = audio_s / (TRAIN_B * TRAIN_SECONDS)
    print(f"{what}: step {run.step_s:.4f} s, "
          f"{audio_s / run.step_s:.1f} audio-s/s ({ratio:.2f}x phase 5's "
          f"audio a batch; phase 5's flagship step "
          f"{train_step_s:.4f} s), device busy {run.busy_ms:.2f} ms, peak "
          f"{run.peak_mb:.1f} MB; launches a step {want} and K4, K5, K6 "
          f"none, held on {card}")
    del model, batch
    torch.cuda.empty_cache()
    return want, (a.vocab_size, mcfg.transcript_vocab_size)


def slu_fp32_phase(torch, card, vocab, t_vocab):
    """Phase 20 (b): the yaml's model in fp32 (SpecAug off, its dropout 0.1
    with phase 6's seeds) on phase 6's short batch with transcripts of 8
    and 3 words (the fused memory's mask has a hole): the loss, every stat
    (1e-4 relative) and every gradient (1e-3 of max |ref|), card against
    CPU."""
    from espnet_slurp_tpu_torch.slu.model import SLUModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    base = slu_config().model
    cfg = dataclasses.replace(
        base, transcript_vocab_size=t_vocab, asr=dataclasses.replace(
            base.asr, vocab_size=vocab, dtype="float32", specaug=None))
    state = ASRTask.init_params(SLUModel(cfg, device="cpu"), 0).state_dict()
    speech, lens, text, tlens = short_batch(vocab)
    rng = np.random.RandomState(5)
    extra = {"transcript": rng.randint(1, t_vocab, (2, 8)).astype(np.int64),
             "transcript_lengths": np.asarray([8, 3], np.int32)}
    compare_cpu_card(
        torch, f"phase 20 (b) fp32 two-pass SLU step ({SLU_YAML}'s model, "
        f"{cfg.asr.num_encoder_blocks} encoder blocks, dropout "
        f"{cfg.asr.dropout_rate}, transcripts of 8 and 3 words)", SLUModel,
        cfg, state, speech, lens, text, tlens, extra=extra)


def slu_decode_cli(torch, card, exp, dev_dir, out, flags, encodes):
    """bin/slu_inference on dev_dir with ``flags``; each utterance's call
    timed, its launches and host syncs counted (every call ``encodes``
    encodes: K2 24 and K3 12 each, nothing else counted). Returns (RTF,
    host syncs an utterance, score)."""
    from espnet_slurp_tpu_torch.bin import slu_inference
    from espnet_slurp_tpu_torch.tasks import slu as task
    from espnet_slurp_tpu_torch.utils import device as devmod

    call = task.Speech2Understand.__call__
    walls, counts, audio = [], [], []

    def counted(self, speech, transcript=None):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, speech, transcript)
        walls.append(time.perf_counter() - t0)  # `out` is a host string
        counts.append({k: v for k, v in read_counts().items() if v})
        audio.append(len(speech) / FS)
        return out

    task.Speech2Understand.__call__ = counted
    syncs0 = devmod.host_syncs
    try:
        slu_inference.main(["--exp_dir", str(exp), "--data_dir",
                            str(dev_dir), "--output_dir", str(out)] + flags)
    finally:
        task.Speech2Understand.__call__ = call
    syncs = devmod.host_syncs - syncs0
    want = {"fused_ffn": 2 * SLU_BLOCKS * encodes,
            "rel_flash_attention": SLU_BLOCKS * encodes}
    score = dict(line.split() for line in
                 (out / "score.txt").read_text().splitlines())
    rtf = sum(walls) / sum(audio)
    hyps = (out / "text").read_text().splitlines()
    print(f"phase 20 (c) bin/slu_inference {' '.join(flags)}: "
          f"{len(walls)} utterances, {sum(audio):.1f} audio-s in "
          f"{sum(walls):.3f} s (RTF {rtf:.5f}), host syncs "
          f"{syncs / len(walls):.2f} an utterance, launches a call "
          f"{counts[0]}; score.txt {score}; hypothesis words "
          f"{[len(h.split()) - 1 for h in hyps]} on {card}")
    if any(c != want for c in counts) or sorted(score) != [
            "intent_acc", "precision", "recall", "slu_f1"] \
            or len(hyps) != len(walls):
        raise AssertionError(f"phase 20 (c) {flags}: launches {counts} "
                             f"(expected {want}), score {score}")
    return rtf, syncs / len(walls), score


def slu_first_pass(root, corpus):
    """The first-pass recognizer's experiment: bin/asr_train trains the
    flagship (cli_train_yaml: dropout DROPOUT, char tokens, sorted batches
    of CLI_BATCH) one epoch on the splits with text := transcript."""
    import shutil
    from espnet_slurp_tpu_torch.bin import asr_train

    dirs = []
    for d in corpus:
        a = root / f"{d.name}_asr"
        a.mkdir()
        shutil.copy(d / "wav.scp", a / "wav.scp")
        shutil.copy(d / "transcript", a / "text")
        dirs.append(a)
    t0 = time.perf_counter()
    asr_train.main(["--config", cli_train_yaml(root, *dirs, 1,
                                               exp="exp_asr")])
    print(f"phase 20 (c): the first pass (the flagship, one epoch on the "
          f"transcripts through bin/asr_train) trained in "
          f"{time.perf_counter() - t0:.1f} s")
    return root / "exp_asr"


def slu_cli_phase(torch, card, root, corpus):
    """Phase 20 (c): the yaml as written through bin/slu_train on the card
    (only exp_dir, the data dirs and max_epoch 1 overridden): at least two
    steps, each with (a)'s launches by the wrappers' and the host counts,
    finite losses in reporter.json; then bin/slu_inference with GT
    transcripts, with phase 15's flagship experiment as the first pass
    (beam 5) and with dialogue history: RTF, host syncs an utterance and
    score.txt of each."""
    from espnet_slurp_tpu_torch.bin import slu_train
    from espnet_slurp_tpu_torch.tasks import slu as task

    t0 = time.perf_counter()
    train_dir, dev_dir = corpus
    exp = root / "exp_c"
    per_step, clock = [], []
    make = step_recorder(torch, per_step, clock, task=task)
    try:
        slu_train.main(["--config", SLU_YAML, "--set", f"exp_dir={exp}",
                        f"data.train_dir={train_dir}",
                        f"data.valid_dir={dev_dir}", "max_epoch=1"])
    finally:
        task.make_train_step = make
    train_s = time.perf_counter() - t0
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    train = hist[-1]["train"] if hist else {}
    want = {k: slu_step_want().get(k, 0) for k in COUNTED}
    bad = [i for i, (w, h, rows) in enumerate(per_step)
           if w != want or h != slu_host_want(rows)]
    print(f"phase 20 (c) {SLU_YAML} through bin/slu_train (exp_dir, data "
          f"dirs, max_epoch 1 overridden): {len(per_step)} steps of B x T' "
          f"{[rows for _, _, rows in per_step]} rows, launches a step "
          f"{per_step[0][0] if per_step else None}, by instance "
          f"{per_step[0][1] if per_step else None}; train "
          f"{ {k: train.get(k) for k in SLU_REPORTED} }; {train_s:.1f} s "
          f"on {card}")
    if not (len(hist) == 1 and len(per_step) >= 2 and not bad
            and all(np.isfinite(train.get(k, np.nan))
                    for k in ("loss", "loss_ctc", "loss_att"))):
        raise AssertionError(f"phase 20 (c): steps {per_step}, reporter "
                             f"{hist}")
    first = slu_first_pass(root, corpus)
    decodes = {}
    for name, flags, encodes in (
            ("gt", ["--use_transcript"], 1),
            ("first_pass", ["--asr_exp_dir", str(first),
                            "--asr_beam_size", "5"], 2),
            ("history", ["--use_transcript", "--use_history"], 1)):
        decodes[name] = slu_decode_cli(torch, card, exp, dev_dir,
                                       root / f"dec_{name}", flags, encodes)
    print(f"phase 20 (c): RTF and host syncs an utterance "
          f"{ {k: (round(r, 5), s) for k, (r, s, _) in decodes.items()} }; "
          f"{time.perf_counter() - t0:.1f} s on {card}")


def slu_recipe_phase(torch, card, root, corpus):
    """Phase 20 (d): recipe/slu_pipeline.py:run_slu_pipeline stages 1-13 on
    the card with the yaml (exp_dir, the data dirs and max_epoch 1
    overridden): intent accuracy and SLU-F1 of the dev split with GT
    transcripts, score.txt written."""
    from espnet_slurp_tpu_torch.recipe.slu_pipeline import run_slu_pipeline

    t0 = time.perf_counter()
    train_dir, dev_dir = corpus
    cfg = slu_config(exp_dir=str(root / "exp_d"), max_epoch=1, data={
        "train_dir": str(train_dir), "valid_dir": str(dev_dir)})
    results = run_slu_pipeline(cfg, stage=1, stop_stage=13, device="cuda")
    score = root / "exp_d" / "decode_dev" / "score.txt"
    print(f"phase 20 (d) run_slu_pipeline stages 1-13: {results}; "
          f"score.txt {score.read_text().split()}; "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    if sorted(results) != ["intent_acc_dev", "slu_f1_dev"]:
        raise AssertionError(f"phase 20 (d): {results}")


def slu_phases(torch, card, train_step_s):
    """Phase 20 (a)-(d) on one synthetic corpus under SLU_ROOT, removed at
    the end. Returns the launches of an SLU train step."""
    import shutil
    from pathlib import Path

    root = Path(SLU_ROOT).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    corpus = slu_corpus(root)
    print(f"phase 20: corpus of {SLU_TRAIN} + {SLU_DEV} utterances written "
          f"in {time.perf_counter() - t0:.1f} s")
    lap = time.perf_counter()
    step, (vocab, t_vocab) = slu_train_phase(torch, card, root, corpus,
                                             train_step_s)
    print(f"phase 20 (a): {time.perf_counter() - lap:.1f} s")
    lap = time.perf_counter()
    slu_fp32_phase(torch, card, vocab, t_vocab)
    print(f"phase 20 (b): {time.perf_counter() - lap:.1f} s")
    slu_cli_phase(torch, card, root, corpus)
    slu_recipe_phase(torch, card, root, corpus)
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")
    return step


# Phase 21: the language models and shallow fusion. (a)-(c) under LM_ROOT
# (the gitignored build/, removed at the end): a synthetic text over phase
# 3's word list (a Zipf-like unigram and 4 likely successors a word, so that
# a few steps move the loss), LM_TRAIN train and LM_VALID valid lines of up
# to LM_MAX_LEN - 1 words, batches of LM_BATCH; (d) a corpus of
# LM_CLI_TRAIN train and N_UTT dev utterances (cli_split) under LM_ROOT;
# (e) a small model (LM_SMALL) over a suffix-marked token list.
LM_ROOT = "build/chip_smoke_lm"
LM_TRAIN, LM_VALID, LM_BATCH, LM_MAX_LEN = 256, 32, 32, 128
LM_EPOCHS, LM_TIMED_STEPS, LM_CMP_ROWS = 2, 5, 8
LM_WEIGHT, NGRAM_WEIGHT, ILM_WEIGHT = 0.3, 0.3, 0.1
LM_LOSS_RTOL, LM_GRAD_TOL = 1e-5, 1e-4
LM_CMP_UTT, LM_CMP_MAX_LEN = 2, 32  # the CPU replays, as phase 19's
LM_CLI_TRAIN = 32
LM_SMALL = dict(vocab_size=64, d_model=64, n_head=2, d_ff=128,
                num_encoder_blocks=2, num_decoder_blocks=1,
                decoder_d_ff=128, dtype="float32", specaug=None)


def lm_text(path, rng, n, words):
    """n Kaldi-style lines of 8 to LM_MAX_LEN - 1 words over ``words``."""
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    p /= p.sum()
    succ = np.random.RandomState(1).randint(len(words), size=(len(words), 4))
    lines = []
    for i in range(n):
        seq = [rng.choice(len(words), p=p)]
        for _ in range(rng.randint(8, LM_MAX_LEN) - 1):
            seq.append(succ[seq[-1], rng.randint(4)] if rng.rand() < 0.6
                       else rng.choice(len(words), p=p))
        lines.append(f"lm{i:04d} " + " ".join(words[j] for j in seq))
    path.write_text("\n".join(lines) + "\n")
    return path


def lm_step_card_vs_cpu(torch, what, card, model_cfg, seed, batch):
    """One LM train step's forward and backward (lm_loss, as
    tasks/lm.py:make_lm_train_step takes them) on the card and on the CPU
    from the same initial parameters (the reference's initializers,
    seeded) on ``batch``: loss within LM_LOSS_RTOL relative, every
    gradient within LM_GRAD_TOL of its max |ref| (floored at 1e-4 of the
    largest gradient entry, as compare_cpu_card). A ReLU input of the
    Transformer's FFNs within fp32 rounding of 0 can fall on either side
    on the two devices and move a w1 gradient row by its token's share;
    such kinks get gradient 0 on both sides, as compare_cpu_card's."""
    from espnet_slurp_tpu_torch.models.lm import lm_loss
    from espnet_slurp_tpu_torch.models.transformer import FeedForward
    from espnet_slurp_tpu_torch.tasks.lm import LMTask

    state = LMTask.init_model(model_cfg, seed, "cpu").state_dict()
    runs, secs = {}, {}
    for dev in ("cpu", "cuda"):
        model = LMTask.init_model(model_cfg, seed, dev)
        model.load_state_dict(state)
        b = {k: v.to(dev) for k, v in batch.items()}
        pre = []
        hooks = [m.w1.register_forward_hook(lambda m, i, o: pre.append(o))
                 for m in model.modules() if isinstance(m, FeedForward)]
        t0 = time.perf_counter()
        loss, _, _ = lm_loss(model(b["ys"], b["ys_lengths"]), b["targets"],
                             b["ys_lengths"])
        for hk in hooks:
            hk.remove()
        runs[dev] = (model, loss, pre)
        secs[dev] = time.perf_counter() - t0
    flips, n_relu = [], sum(z.numel() for z in runs["cpu"][2])
    for z_c, z_g in zip(runs["cpu"][2], runs["cuda"][2]):
        flip = (z_c > 0) != (z_g > 0).cpu()
        flips.append(int(flip.sum()))
        for z in (z_c, z_g):
            z.register_hook(lambda g, f=flip.to(z.device): g.masked_fill(f, 0))
    res = {}
    for dev, (model, loss, _) in runs.items():
        t0 = time.perf_counter()
        loss.backward()
        res[dev] = (float(loss.detach()), {k: p.grad.detach().cpu()
                                           for k, p in
                                           model.named_parameters()})
        secs[dev] += time.perf_counter() - t0
    del runs
    (loss_c, g_c), (loss_g, g_g) = res["cpu"], res["cuda"]
    rel = abs(loss_g - loss_c) / abs(loss_c)
    floor = 1e-4 * max(float(x.abs().max()) for x in g_c.values())
    worst = max(((float((g_g[k] - r).abs().max())
                  / max(float(r.abs().max()), floor)), k)
                for k, r in g_c.items())
    print(f"{what} card vs CPU, one step on {tuple(batch['ys'].shape)} "
          f"tokens: loss {loss_g:.7f} vs {loss_c:.7f} (rel {rel:.3e}, "
          f"tolerance {LM_LOSS_RTOL:.0e}); worst gradient {worst[1]} "
          f"{worst[0]:.3e} of max|ref| (tolerance {LM_GRAD_TOL:.0e}) over "
          f"{len(g_c)} tensors; FFN ReLU kinks on opposite sides "
          f"{sum(flips)} of {n_relu}; CPU {secs['cpu']:.2f} s, card "
          f"{secs['cuda']:.3f} s on {card}")
    if not (np.isfinite(loss_g) and rel <= LM_LOSS_RTOL
            and worst[0] <= LM_GRAD_TOL):
        raise AssertionError(f"{what} card vs CPU")


def lm_train_phase(torch, card, root, tokens):
    """Phase 21 (a)-(b): LMConfig() (transformer, 16 x 512, 8 heads, d_ff
    2048, fp32) over the flagship's 5,000-token list, written into the
    LM's exp_dir/tokens.txt first, through bin/lm_train (LM_EPOCHS epochs
    of LM_TRAIN lines at B LM_BATCH, Adam at a constant 1e-3): reporter
    epochs, finite and falling train loss; then LM_TIMED_STEPS timed
    steps of make_lm_train_step on the card (step seconds, tokens/s, peak
    MB); one step card vs CPU on LM_CMP_ROWS rows of the first batch; the
    same step of a 2 x 512 LSTM LM card vs CPU. Returns the LM's exp dir
    and the train text."""
    import io

    import yaml
    from espnet_slurp_tpu_torch.bin import lm_calc_perplexity, lm_train
    from espnet_slurp_tpu_torch.models.lm import LMConfig
    from espnet_slurp_tpu_torch.tasks.lm import (LMTask, load_lm_config,
                                                 make_lm_train_step)
    from espnet_slurp_tpu_torch.train.optim import build_optimizer
    from espnet_slurp_tpu_torch.train.state import TrainState

    t_phase = time.perf_counter()
    rng = np.random.RandomState(21)
    words = tokens[2:-1]
    train = lm_text(root / "lm_train", rng, LM_TRAIN, words)
    valid = lm_text(root / "lm_valid", rng, LM_VALID, words)
    exp = root / "lm_exp"
    exp.mkdir()
    (exp / "tokens.txt").write_text("\n".join(tokens) + "\n")
    cfg_path = root / "lm.yaml"
    cfg_path.write_text(yaml.safe_dump({
        "exp_dir": str(exp), "max_epoch": LM_EPOCHS, "keep_nbest": 1,
        "optim": {"name": "adam", "lr": 1e-3, "scheduler": "constant"},
        "data": {"train_text": str(train), "valid_text": str(valid),
                 "token_type": "word", "batch_size": LM_BATCH,
                 "max_len": LM_MAX_LEN, "seed": 0}}))
    t0 = time.perf_counter()
    lm_train.main(["--config", str(cfg_path)])
    cli_s = time.perf_counter() - t0
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    cfg = load_lm_config(exp / "config.yaml")
    losses = [(e["train"]["loss"], e["valid"]["loss"]) for e in hist]
    if cfg.model != LMConfig() or [e["epoch"] for e in hist] != list(
            range(1, LM_EPOCHS + 1)) or not np.isfinite(losses).all() \
            or not losses[-1][0] < losses[0][0]:
        raise AssertionError(f"phase 21 (a) bin/lm_train: model {cfg.model}, "
                             f"(train, valid) losses {losses}")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        lm_calc_perplexity.main(["--exp_dir", str(exp), "--text", str(valid)])
    ppl = float(out.getvalue().split()[-1])
    steps = hist[0]["train"]["steps"]
    print(f"phase 21 (a) bin/lm_train: LMConfig() {cfg.model.num_blocks} x "
          f"{cfg.model.d_model}, {cfg.model.n_head} heads, d_ff "
          f"{cfg.model.d_ff}, vocab {cfg.model.vocab_size}, fp32; "
          f"{LM_EPOCHS} epochs of {steps} steps at B {LM_BATCH} x up to "
          f"{LM_MAX_LEN} tokens in {cli_s:.1f} s; (train, valid) loss by "
          f"epoch {[(round(a, 4), round(b, 4)) for a, b in losses]}; "
          f"bin/lm_calc_perplexity {ppl} on {card}")

    tokenizer, conv, model_cfg = LMTask.prepare_vocab(cfg)
    batches = list(LMTask.batches(str(train), tokenizer, conv, cfg, 1, True,
                                  "cuda"))
    model = LMTask.init_model(model_cfg, 0, "cuda")
    tx = build_optimizer(cfg.optim)
    state = TrainState.create(model, tx)
    step = make_lm_train_step(model, tx)
    state, _ = step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, ntok = [], []
    for b in batches[1:1 + LM_TIMED_STEPS]:
        t0 = time.perf_counter()
        state, stats = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        ntok.append(int(b["ys_lengths"].sum()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    step_s = float(np.median(times))
    print(f"phase 21 (a) LMConfig() make_lm_train_step, {len(times)} steps "
          f"at B {LM_BATCH}: step {step_s:.4f} s (median; "
          f"{[round(x, 4) for x in times]}), {sum(ntok) / sum(times):.0f} "
          f"tokens/s ({ntok} valid tokens a step), peak {peak:.1f} MB, "
          f"last loss {float(stats['loss']):.4f} on {card}")
    del model, state, tx
    torch.cuda.empty_cache()
    rows = {k: v[:LM_CMP_ROWS].cpu() for k, v in batches[0].items()}
    lm_step_card_vs_cpu(torch, "phase 21 (a) LMConfig() fp32", card,
                        model_cfg, 0, rows)
    lm_step_card_vs_cpu(torch, "phase 21 (b) LSTM LM 2 x 512 fp32", card,
                        dataclasses.replace(model_cfg, arch="lstm",
                                            num_layers=2), 0, rows)
    print(f"phase 21 (a)-(b): {time.perf_counter() - t_phase:.1f} s")
    return exp, train


def lm_decode_phase(torch, card, root, tokens, exp, train):
    """Phase 21 (c): phase 3's Speech2Text (flagship, bf16, random weights
    from seed 0, beam BEAM, ctc CTC_WEIGHT, max_len MAX_LEN) on phase 3's
    traffic with no LM, with (a)'s LM at LM_WEIGHT, with the stage-9
    trigram (train_arpa over (a)'s text, its .npz cache) added at
    NGRAM_WEIGHT, and with ILM_WEIGHT added: each decode's RTF beside the
    no-LM one; each encode launches K2 24 and K3 12 by the wrappers'
    counts and the same kernel instances by the host counts as the no-LM
    decode (the LMs launch none of the port's kernels). Then the fp32
    model's beam search with all three from one card encode of
    LM_CMP_UTT utterances (max_len LM_CMP_MAX_LEN) on the card and on the
    CPU: equal but on proved near-ties, the card's choices replayed on the
    CPU (search_parity). Returns the wrappers' launches of the fused
    decode."""
    from espnet_slurp_tpu_torch.data.fileio import read_2column_text
    from espnet_slurp_tpu_torch.decode.beam import (BeamSearchConfig,
                                                    batch_beam_search)
    from espnet_slurp_tpu_torch.decode.ngram import ArpaLM
    from espnet_slurp_tpu_torch.decode.ngram_train import train_arpa
    from espnet_slurp_tpu_torch.models.asr_model import (ASRModel,
                                                          flagship_config)
    from espnet_slurp_tpu_torch.ops.kernels import build
    from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
    from espnet_slurp_tpu_torch.utils.params import init_random_

    t_phase = time.perf_counter()
    cfg = flagship_config()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    state = init_random_(ASRModel(cfg32, device="cpu"), seed=0).state_dict()
    t0 = time.perf_counter()
    arpa = train_arpa([text.split() for text in
                       read_2column_text(train).values()],
                      root / "train.arpa")
    tok2id = {tok: i for i, tok in enumerate(tokens)}
    tok2id.setdefault("<s>", cfg.sos_id)
    tok2id.setdefault("</s>", cfg.eos_id)
    npz = root / "train_ngram.npz"
    ArpaLM(str(arpa), tok2id, cfg.vocab_size).save_binary(str(npz))
    print(f"phase 21 (c) stage-9 trigram over (a)'s text: ARPA and .npz "
          f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    speeches = [rng.randn(FS * UTT_SECONDS).astype(np.float32) * 0.1
                for _ in range(N_UTT)]
    n = cfg.num_encoder_blocks
    runs = (("no LM", {}),
            (f"lm_weight {LM_WEIGHT}", dict(lm_exp_dir=str(exp),
                                            lm_weight=LM_WEIGHT)),
            (f"+ ngram_weight {NGRAM_WEIGHT}", dict(
                lm_exp_dir=str(exp), lm_weight=LM_WEIGHT,
                ngram_file=str(npz), ngram_weight=NGRAM_WEIGHT)),
            (f"+ ilm_weight {ILM_WEIGHT}", dict(
                lm_exp_dir=str(exp), lm_weight=LM_WEIGHT,
                ngram_file=str(npz), ngram_weight=NGRAM_WEIGHT,
                ilm_weight=ILM_WEIGHT)))
    rtf, host0, fused = {}, None, None
    for label, fusion in runs:
        s2t = Speech2Text(cfg, state, tokens, token_type="word",
                          max_len=MAX_LEN, beam_size=BEAM,
                          ctc_weight=CTC_WEIGHT, device="cuda", **fusion)
        if host0 is None:
            s2t.decode_batch(speeches)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        before = build.launch_counts()
        t0 = time.perf_counter()
        texts = s2t.decode_batch(speeches)  # host strings: the card is done
        wall = time.perf_counter() - t0
        host = build.launch_delta(before, build.launch_counts())
        launches = {k: c for k, c in read_counts().items() if c}
        host0 = host if host0 is None else host0
        rtf[label] = wall / (N_UTT * UTT_SECONDS)
        print(f"phase 21 (c) Speech2Text {label}: {N_UTT} x {UTT_SECONDS} "
              f"s, beam {BEAM}, ctc {CTC_WEIGHT}, max_len {MAX_LEN}: wall "
              f"{wall:.3f} s, RTF {rtf[label]:.5f} (no LM "
              f"{rtf['no LM']:.5f}, {rtf[label] / rtf['no LM']:.2f}x), "
              f"hypothesis words {[len(x.split()) for x in texts]}; "
              f"launches {launches}, by instance {host} on {card}")
        if launches != {"fused_ffn": 2 * n, "rel_flash_attention": n} \
                or host != host0 or len(texts) != N_UTT:
            raise AssertionError(f"phase 21 (c) {label}: launches "
                                 f"{launches}, {host} (no LM {host0})")
        fused = launches
        del s2t
        torch.cuda.empty_cache()

    # fp32 replay on the CPU of the card's fused search
    models, hooks = {}, {}
    for dev in ("cuda", "cpu"):
        s2t = Speech2Text(cfg32, state, tokens, token_type="word",
                          max_len=LM_CMP_MAX_LEN, beam_size=BEAM,
                          ctc_weight=CTC_WEIGHT, device=dev,
                          **dict(runs[-1][1]))
        models[dev], hooks[dev] = s2t.model, s2t._fusion()
    beam = BeamSearchConfig(beam_size=BEAM, max_len=LM_CMP_MAX_LEN,
                            ctc_weight=CTC_WEIGHT, lm_weight=1.0,
                            ilm_weight=ILM_WEIGHT)
    buf, lens = s2t.pad_batch(speeches[:LM_CMP_UTT])
    got, picks, secs = {}, [], {}
    with torch.inference_mode():
        hs, hl = models["cuda"].encode(torch.from_numpy(buf).cuda(),
                                       torch.from_numpy(lens).cuda())
        for dev in ("cuda", "cpu"):
            step, init = hooks[dev]
            t0 = time.perf_counter()
            with (top_k_as(recording(picks)) if dev == "cuda" else
                  contextlib.nullcontext()):
                res = batch_beam_search(models[dev], hs.to(dev), hl.to(dev),
                                        beam, lm_step=step, lm_init=init,
                                        return_nbest=True)
            got[dev] = tuple(x.cpu() for x in res)
            secs[dev] = time.perf_counter() - t0
        step, init = hooks["cpu"]
        note = search_parity(
            torch, lambda: batch_beam_search(
                models["cpu"], hs.cpu(), hl.cpu(), beam, lm_step=step,
                lm_init=init, return_nbest=True),
            got["cuda"], got["cpu"], picks, LM_CMP_UTT)
    print(f"phase 21 (c) fp32 beam search with the LM, the trigram and the "
          f"ILM from one card encode, {LM_CMP_UTT} x {UTT_SECONDS} s, max_len "
          f"{LM_CMP_MAX_LEN}: lengths card {got['cuda'][1].tolist()} CPU "
          f"{got['cpu'][1].tolist()}, card {secs['cuda']:.2f} s, CPU "
          f"{secs['cpu']:.2f} s; {note} on {card}")
    del models, hooks
    torch.cuda.empty_cache()
    print(f"phase 21 (c): {time.perf_counter() - t_phase:.1f} s")
    return fused


def lm_cli_phase(torch, card, root):
    """Phase 21 (d): on LM_CLI_TRAIN + N_UTT utterances (cli_split),
    recipe/asr_pipeline.py:run_pipeline stages 1-13 with train_lm and
    train_ngram (the flagship of cli_train_yaml, 1 epoch; stage 7's LM,
    stage 8's perplexity, stage 9's trigram fused at stage 12), then
    bin/asr_inference on the dev set with --lm_exp_dir (stage 7's LM) and
    --ngram_file (stage 9's cache) at weight 0.3 each: score.txt, the RTF,
    one encode's K2 24 and K3 12 and nothing else counted."""
    from espnet_slurp_tpu_torch.bin import asr_inference
    from espnet_slurp_tpu_torch.recipe.asr_pipeline import (PipelineOptions,
                                                            run_pipeline)
    from espnet_slurp_tpu_torch.tasks.asr import load_task_config

    t_phase = time.perf_counter()
    rng = np.random.RandomState(8)
    train, dev = (cli_split(root / "cli" / s, s, count, rng)
                  for s, count in (("train", LM_CLI_TRAIN), ("dev", N_UTT)))
    cfg = load_task_config(cli_train_yaml(root / "cli", train, dev, 1))
    t0 = time.perf_counter()
    res = run_pipeline(cfg, PipelineOptions(
        train_lm=True, train_ngram=True, ngram_weight=NGRAM_WEIGHT,
        decode_beam_size=BEAM, decode_ctc_weight=CTC_WEIGHT,
        decode_max_len=MAX_LEN, decode_batch_size=N_UTT), stage=1,
        stop_stage=13, device="cuda")
    pipe_s = time.perf_counter() - t0
    secs = {k: round(v, 2) for k, v in res["stage_seconds"].items()}
    print(f"phase 21 (d) run_pipeline stages 1-13 with train_lm and "
          f"train_ngram: {pipe_s:.1f} s, seconds by stage {secs}; LM "
          f"perplexity {res['lm_ppl']:.3f}; wer {res['wer_dev']:.4f} cer "
          f"{res['cer_dev']:.4f} with the trigram at {NGRAM_WEIGHT} on "
          f"{card}")
    if not {7, 8, 9, 11, 12, 13} <= set(secs) or not np.isfinite(
            [res["lm_ppl"], res["wer_dev"]]).all():
        raise AssertionError(f"phase 21 (d) pipeline: {res}")
    exp = root / "cli" / "exp"
    out = root / "cli" / "decode_lm"
    zero_counts()
    asr_inference.main([
        "--exp_dir", str(exp), "--data_dir", str(dev), "--output_dir",
        str(out), "--beam_size", str(BEAM), "--ctc_weight", str(CTC_WEIGHT),
        "--max_len", str(MAX_LEN), "--batch_size", str(N_UTT),
        "--lm_exp_dir", str(exp / "lm"), "--lm_weight", str(LM_WEIGHT),
        "--ngram_file", str(exp / "train_ngram.npz"), "--ngram_weight",
        str(NGRAM_WEIGHT)])
    launches = {k: c for k, c in read_counts().items() if c}
    score = dict(line.split() for line in
                 (out / "score.txt").read_text().splitlines())
    n = cfg.model.num_encoder_blocks
    print(f"phase 21 (d) bin/asr_inference --lm_exp_dir --ngram_file: "
          f"{N_UTT} x {UTT_SECONDS} s in one batch: score.txt {score}; "
          f"launches {launches} on {card}")
    if launches != {"fused_ffn": 2 * n, "rel_flash_attention": n} \
            or sorted(score) != ["CER", "RTF", "WER"]:
        raise AssertionError(f"phase 21 (d) asr_inference: {launches}, "
                             f"{score}")
    print(f"phase 21 (d): {time.perf_counter() - t_phase:.1f} s")


def small_lstm(torch, vocab, seed):
    """An LSTM LM (vocab, 1 x 32) from the reference's initializers on the
    CPU, and its copy on the card."""
    from espnet_slurp_tpu_torch.models.lm import LMConfig
    from espnet_slurp_tpu_torch.tasks.lm import LMTask
    cfg = LMConfig(vocab_size=vocab, arch="lstm", d_model=32, num_layers=1)
    cpu = LMTask.init_model(cfg, seed, "cpu").eval()
    card = LMTask.init_model(cfg, seed, "cuda").eval()
    card.load_state_dict(cpu.state_dict())
    return {"cpu": cpu, "cuda": card}


def word_lm_phase(torch, card):
    """Phase 21 (e): a small fp32 model (LM_SMALL over suffix_token_list,
    random weights) on 2 utterances; one LookAhead decode (an LSTM word LM
    over 24 words of 1-3 pieces), one MultiLevel decode (the same word LM
    and an LSTM subword LM) and one TCPGen decode (use_tcpgen) with
    biasing["selection"] (an LSTM selection LM over the words choosing
    among 4 class roots), each at lm_weight 0.5, beam 4, pre-beam 16, ctc
    0.3, max_len 16, from one card encode: card against CPU by
    search_parity."""
    from espnet_slurp_tpu_torch.decode import word_lm
    from espnet_slurp_tpu_torch.decode.beam import (BeamSearchConfig,
                                                    batch_beam_search)
    from espnet_slurp_tpu_torch.models.asr_model import ASRConfig, ASRModel
    from espnet_slurp_tpu_torch.slu.kb import boundary_token_ids, build_trie
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask
    from espnet_slurp_tpu_torch.tasks.lm import make_lm_fusion

    t_phase = time.perf_counter()
    v = LM_SMALL["vocab_size"]
    tokens = suffix_token_list(v)
    bset, _ = boundary_token_ids(tokens)
    bnd = np.zeros(v, bool)
    bnd[sorted(bset)] = True
    rng = np.random.RandomState(5)
    inner = np.arange(2, v - 1)[0::2]
    words = []
    while len(words) < 24:
        w = [int(x) for x in rng.choice(inner, rng.randint(1, 4))]
        if w not in words:
            words.append(w)
    n_words = len(words) + 3  # 0 pad, 1 unk, 2.. words, last eos
    wtrie = word_lm.build_word_trie(words, list(range(2, 2 + len(words))))
    fusion = dict(trie=wtrie, vocab_size=v, space_id=int(sorted(bset)[0]),
                  eos_id=v - 1, boundary_mask=bnd, word_eos=n_words - 1,
                  word_unk=1)
    wlm, slm = small_lstm(torch, n_words, 1), small_lstm(torch, v, 2)
    beam = BeamSearchConfig(beam_size=4, pre_beam_size=16, max_len=16,
                            ctc_weight=0.3, lm_weight=0.5)
    x = rng.randn(2, FS * 3).astype(np.float32) * 0.1
    lens = np.array([FS * 3, FS * 2], np.int32)
    for label, tcpgen in (("LookAhead", False), ("MultiLevel", False),
                          ("selection", True)):
        cfg = ASRConfig(use_tcpgen=tcpgen, **LM_SMALL)
        state = ASRTask.init_params(ASRModel(cfg, device="cpu"),
                                    3).state_dict()
        models, args = {}, {}
        for dev in ("cuda", "cpu"):
            models[dev] = ASRModel(cfg, device=dev)
            models[dev].load_state_dict(state)
            wstep, winit = make_lm_fusion(wlm[dev], 64)
            if label == "LookAhead":
                step, init = word_lm.make_lookahead_fusion(
                    wstep, winit, device=dev, **fusion)
                args[dev] = dict(lm_step=step, lm_init=init)
            elif label == "MultiLevel":
                sstep, sinit = make_lm_fusion(slm[dev], 64)
                step, init = word_lm.make_multilevel_fusion(
                    wstep, winit, sstep, sinit, device=dev, **fusion)
                args[dev] = dict(lm_step=step, lm_init=init)
            else:
                trie = build_trie([w + [int(sorted(bset)[i % len(bset)])]
                                   for i, w in enumerate(words)])
                kids = trie.children_node[0][:trie.n_children[0]]
                mask = torch.zeros(v + 1, dtype=torch.bool)
                mask[sorted(bset)] = True
                args[dev] = dict(biasing={
                    "trie": {f"trie_{k}": torch.from_numpy(getattr(trie, k))
                             .to(dev) for k in ("token", "children_tok",
                                                "children_node",
                                                "n_children")},
                    "boundary_mask": mask.to(dev), "dead": trie.dead,
                    "prefix_boundary": False, "smoothprob": 1.0,
                    "selection": {
                        "word_trie": wtrie, "word_unk": 1,
                        "sel_step": wstep, "sel_init": winit,
                        "class_roots": np.array(
                            [0] + [int(k) for k in kids[:3]] * n_words)[
                                :n_words]}})
        got, picks = {}, []
        with torch.inference_mode():
            hs, hl = models["cuda"].encode(torch.from_numpy(x).cuda(),
                                           torch.from_numpy(lens).cuda())
            for dev in ("cuda", "cpu"):
                with (top_k_as(recording(picks)) if dev == "cuda" else
                      contextlib.nullcontext()):
                    res = batch_beam_search(models[dev], hs.to(dev),
                                            hl.to(dev), beam,
                                            return_nbest=True, **args[dev])
                got[dev] = tuple(r.cpu() for r in res)
            note = search_parity(
                torch, lambda: batch_beam_search(
                    models["cpu"], hs.cpu(), hl.cpu(), beam,
                    return_nbest=True, **args["cpu"]),
                got["cuda"], got["cpu"], picks, 2)
        print(f"phase 21 (e) {label} decode fp32 "
              f"({LM_SMALL['num_encoder_blocks']} x {LM_SMALL['d_model']}, "
              f"V {v}): lengths card "
              f"{got['cuda'][1].tolist()} CPU {got['cpu'][1].tolist()}; "
              f"{note} on {card}")
    print(f"phase 21 (e): {time.perf_counter() - t_phase:.1f} s")


def lm_phases(torch, card):
    """Phase 21 (a)-(e) under LM_ROOT, removed at the end. Returns the
    wrappers' launches of (c)'s fused decode."""
    import shutil
    from pathlib import Path

    root = Path(LM_ROOT).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    tokens = token_list(5000)
    exp, train = lm_train_phase(torch, card, root, tokens)
    fused = lm_decode_phase(torch, card, root, tokens, exp, train)
    lm_cli_phase(torch, card, root)
    word_lm_phase(torch, card)
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    return fused


# Phase 22: KA2G slot-value generation (recipe/ka2g_run.py) on the recipe's
# own synthetic corpus (make_ka2g_corpus: KA2G_TRAIN + KA2G_DEV + KA2G_TEST
# utterances of ~1-3 s under KA2G_ROOT, the gitignored build/, removed at
# the end), the model at the recipe's full width (build_cfg: Conformer 6 x
# 144, 4 heads (Dh 36: K3 zero-padded to its Dh-64 route), d_ff 576,
# kernel 15, bf16, dropout 0.1; the generator 5 slots x 144, 2 blocks, d_ff
# 576, max_value_len 2) at the recipe's B 48.
KA2G_ROOT = "build/chip_smoke_ka2g"
KA2G_TRAIN, KA2G_DEV, KA2G_TEST, KA2G_B = 240, 48, 50, 48
KA2G_EPOCHS = 2  # (a): the second epoch's steps meet no new shape
KA2G_BLOCKS, KA2G_HEADS, KA2G_DH = 6, 4, 36


def ka2g_step_want():
    """A KA2G train step's launches each way by the wrappers' counts: K3
    once a block, K4 and K1 once (the CTC term), K2 none (D2 144 is no
    bf16 K2 width: the FFNs run eager), K5 and K6 none."""
    return {"rel_flash_attention": KA2G_BLOCKS,
            "rel_flash_attention_bwd": KA2G_BLOCKS,
            "fused_ctc_head_emit": 1, "fused_ctc_head_emit_bwd": 1,
            "ctc_lattice": 1, "ctc_lattice_bwd": 1}


def ka2g_host_want():
    """The same step by the host counts: K3's bf16 launches at Dh 64 (Dh
    36 padded) with dropout, K4's bf16 route, K1's warp route."""
    return {"rel_fwd::fwd_kernel<64, true>": KA2G_BLOCKS,
            "rel_dkv::dkv_kernel<64, true>": KA2G_BLOCKS,
            "rel_dq::dq_kernel<64, true>": KA2G_BLOCKS,
            **dict.fromkeys(K4_BF16_LAUNCHES, 1),
            **dict.fromkeys(K1_WARP, 1)}


def ka2g_setup(corpus):
    """(token list, tok2id, forest trie, roots) as the recipe builds them."""
    from pathlib import Path
    from espnet_slurp_tpu_torch.data.fileio import read_2column_text
    from espnet_slurp_tpu_torch.recipe import ka2g_run as kr
    from espnet_slurp_tpu_torch.slu.generator import build_ontology_forest

    train_dir, _, _, onto = corpus
    tokens = kr.build_vocab(read_2column_text(Path(train_dir) / "text"),
                            onto)
    tok2id = {t: i for i, t in enumerate(tokens)}
    trie, roots = build_ontology_forest(
        [[[tok2id[w] for w in v] for v in sv] for sv in onto])
    return tokens, tok2id, trie, roots


def ka2g_busy_ms(torch, model, batch):
    """The device's busy ms in one train step of ``model`` on ``batch``
    (a warm-up step first), by profiled_busy_ms."""
    from espnet_slurp_tpu_torch.data.prefetch import to_device
    from espnet_slurp_tpu_torch.train.optim import OptimConfig, build_optimizer
    from espnet_slurp_tpu_torch.train.state import TrainState, make_train_step

    tx = build_optimizer(OptimConfig(lr=1e-3, scheduler="constant"))
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx)
    b = to_device(batch, "cuda")
    state, _ = step(state, b)
    torch.cuda.synchronize()
    return profiled_busy_ms(torch, step, state, b)[1]


def ka2g_train_phase(torch, card, root, corpus, train_step_s):
    """Phase 22 (a): each arm (nokb, tcpgen) KA2G_EPOCHS epochs through
    tasks/generic.py:run_training over a ResidentCorpus of the train and
    dev splits (KA2G_TRAIN / KA2G_B steps and one valid batch an epoch),
    every train step recorded: its launches by the wrappers' and the host
    counts exactly ka2g_step_want / ka2g_host_want, the run's totals those
    steps' plus the valid batches' forward ones; the pace (entry to entry
    of the last epoch's steps, whose batch shapes the first epoch met),
    audio-s/s, peak memory, the device's busy ms in a profiled step and
    its idle share; finite train and valid losses. Returns (launches a
    step, the K3 launches of both arms each way, the first train batch
    (the same utterances, TCPGen's arrays left out), V)."""
    import json as _json
    from espnet_slurp_tpu_torch.data.resident import ResidentCorpus
    from espnet_slurp_tpu_torch.ops.kernels import build
    from espnet_slurp_tpu_torch.recipe import ka2g_run as kr
    from espnet_slurp_tpu_torch.slu.ka2g import KA2GModel
    from espnet_slurp_tpu_torch.tasks import generic
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask
    from espnet_slurp_tpu_torch.train.optim import OptimConfig

    train_dir, dev_dir, _, _ = corpus
    tokens, tok2id, trie, roots = ka2g_setup(corpus)
    t0 = time.perf_counter()
    rc = ResidentCorpus.from_datadirs([str(train_dir), str(dev_dir)],
                                      device="cuda")
    rows = int(rc.buffer.shape[0])
    print(f"phase 22 (a): ResidentCorpus of {len(rc.index)} utterances, "
          f"{rows * rc.ROW * 2 / 1e6:.1f} MB of int16 on the card, decoded "
          f"and copied in {time.perf_counter() - t0:.2f} s")
    train_uids = [u for u in rc.index if u.startswith("train_")]
    per_epoch = KA2G_TRAIN // KA2G_B
    steps = KA2G_EPOCHS * per_epoch
    audio_s = sum(rc.index[u][1] for u in train_uids) / FS / per_epoch
    want, host_want = ka2g_step_want(), ka2g_host_want()
    fwd_only = {k: v for k, v in want.items() if not k.endswith("_bwd")}
    n_valid = KA2G_EPOCHS * (KA2G_DEV // KA2G_B)
    k3_total, t_prime = {"fwd": 0, "bwd": 0}, None
    for arm, tcp in (("nokb", False), ("tcpgen", True)):
        cfg = kr.build_cfg(len(tokens), tcp)
        what = (f"phase 22 (a) KA2G {arm}: Conformer {KA2G_BLOCKS} x "
                f"{cfg.asr.d_model} ({cfg.asr.n_head} heads, Dh "
                f"{cfg.asr.d_model // cfg.asr.n_head}), d_ff {cfg.asr.d_ff}, "
                f"{cfg.asr.dtype}, dropout {cfg.asr.dropout_rate}; generator "
                f"{cfg.gen.n_slots} slots x {cfg.gen.d_model}, "
                f"{cfg.gen.num_blocks} blocks, TCPGen {tcp}; V "
                f"{len(tokens)}; B {KA2G_B}, {audio_s:.1f} audio-s a batch")
        per_step, clock = [], []
        orig = step_recorder(torch, per_step, clock, task=generic)
        model = KA2GModel(cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        hosts0 = build.launch_counts()
        t0 = time.perf_counter()
        try:
            generic.run_training(
                exp_dir=str(root / f"exp_a_{arm}"), model=model,
                init_fn=lambda m, seed: ASRTask.init_params(m, seed),
                train_factory=kr.make_factory(rc, train_dir, tok2id, KA2G_B,
                                              tcp, True, trie, roots),
                valid_factory=kr.make_factory(rc, dev_dir, tok2id, KA2G_B,
                                              tcp, False, trie, roots),
                optim=OptimConfig(lr=1e-3, scheduler="warmuplr",
                                  warmup_steps=800),
                run=generic.RunOptions(max_epoch=KA2G_EPOCHS, keep_nbest=1,
                                       nbest_average=1, log_interval=100))
        finally:
            generic.make_train_step = orig
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        total = read_counts()
        hosts = build.launch_delta(hosts0, build.launch_counts())
        hist = _json.loads((root / f"exp_a_{arm}" / "reporter.json")
                           .read_text())["history"][-1]
        bad = [i for i, (w, h, _) in enumerate(per_step)
               if w != {k: want.get(k, 0) for k in COUNTED}
               or h != host_want]
        total_want = {k: steps * want.get(k, 0) + n_valid * fwd_only.get(k, 0)
                      for k in COUNTED}
        pace = [clock[i + 1][0] - clock[i][0]
                for i in range(steps - per_epoch, steps - 1)]
        pace_s = float(np.median(pace))
        t_prime = per_step[0][2] // KA2G_B
        busy_ms = ka2g_busy_ms(torch, model, next(iter(kr.make_factory(
            rc, train_dir, tok2id, KA2G_B, tcp, False, trie, roots)(1))))
        print(f"{what}: {len(per_step)} steps in {wall:.2f} s with the valid "
              f"passes; a step every {pace_s:.4f} s in the last epoch "
              f"({[round(x, 4) for x in pace]}), {audio_s / pace_s:.1f} "
              f"audio-s/s (phase 5's flagship step {train_step_s:.4f} s), "
              f"host s issuing each step "
              f"{[round(b - a, 4) for a, b in clock]}; device busy "
              f"{busy_ms:.2f} ms in a profiled step (idle "
              f"{1 - busy_ms / 1e3 / pace_s:.0%} of the pace); peak "
              f"{peak_mb:.1f} MB; T' {t_prime}; last epoch train "
              f"{hist['train']}; valid {hist['valid']} on {card}")
        print(f"{what}: launches a step {per_step[0][0]}, host counts "
              f"{per_step[0][1]}; the epoch's {total}, host {hosts}")
        if (len(per_step) != steps or bad or total != total_want
                or not all(np.isfinite(v) for ph in ("train", "valid")
                           for k, v in hist[ph].items()
                           if k.startswith("loss"))):
            raise AssertionError(f"{what}: steps {len(per_step)}, off-want "
                                 f"steps {bad}, totals {total} against "
                                 f"{total_want}, or a non-finite loss")
        k3_total["fwd"] += total["rel_flash_attention"]
        k3_total["bwd"] += total["rel_flash_attention_bwd"]
        del model
        torch.cuda.empty_cache()
    first = next(iter(kr.make_factory(rc, train_dir, tok2id, KA2G_B, False,
                                      True, trie, roots)(1)))
    if bucket_t_prime(first["speech"].shape[1]) != t_prime:
        raise AssertionError("phase 22 (a): the first batch's T' differs "
                             "from the first step's")
    return want, k3_total, first, len(tokens)


def ka2g_ctc_check(torch, first, v):
    """K4 and K1 at phase 22 (a)'s shape by hold_ctc_kernels: hs [KA2G_B,
    T' of the first train batch, 144] (D 144: a 16-wide tail past the bf16
    gemms' BK 32), the recipe's V, that batch's transcripts (S 2U + 1) and
    its utterances' frame lengths."""
    t = bucket_t_prime(first["speech"].shape[1])
    tlen = torch.tensor([bucket_t_prime(int(n))
                         for n in first["speech_lengths"]],
                        dtype=torch.int32, device="cuda")
    hold_ctc_kernels(torch, "phase 22", torch.from_numpy(
        first["text"]).cuda(), torch.from_numpy(first["text_lengths"]).cuda(),
        t, 144, v, 22, tlen=tlen)
    return t


def ka2g_slot_batch(trie, roots, onto_ids):
    """Slot streams for phase 6's short batch: utterance 0 with slots 0 and
    3 (an ontology value, then one outside the ontology: its walk goes
    dead), utterance 1 with slot 4 (one word of a value), and the forest's
    walk of them."""
    from espnet_slurp_tpu_torch.recipe import ka2g_run as kr
    from espnet_slurp_tpu_torch.slu.generator import walk_forest
    s, l = kr.N_SLOTS, kr.VALUE_LEN
    present = np.zeros((2, s), np.int32)
    values = np.full((2, s, l), -1, np.int32)
    vlens = np.zeros((2, s), np.int32)
    present[0, [0, 3]] = 1
    values[0, 0] = onto_ids[0][12]
    values[0, 3] = [onto_ids[3][0][0], onto_ids[1][5][1]]
    vlens[0, [0, 3]] = 2
    present[1, 4] = 1
    values[1, 4, 0] = onto_ids[4][2][0]
    vlens[1, 4] = 1
    vals = np.maximum(values, 0).reshape(2 * s, l)
    ys_in = np.pad(vals, ((0, 0), (1, 0)))[:, :l]
    node, pmask = walk_forest(trie, roots, ys_in, np.tile(np.arange(s), 2))
    return {"slot_present": present, "values": values,
            "value_lengths": vlens, **kr.forest_arrays(trie),
            "node": node.reshape(2, s * l),
            "p_gen_mask": pmask.reshape(2, s * l)}


def ka2g_fp32_phase(torch, card, corpus):
    """Phase 22 (b): the recipe's model in fp32 (SpecAug off, dropout 0.1
    with phase 6's seeds, TCPGen on) on phase 6's short batch with (a)'s
    vocabulary and ka2g_slot_batch's slots: the loss, every stat (1e-4
    relative) and every gradient (1e-3 of max |ref|), card against CPU;
    then generate() from the same weights with and without the forest on
    both: the same values, slot logits within 1e-4 of max |ref|."""
    from espnet_slurp_tpu_torch.recipe import ka2g_run as kr
    from espnet_slurp_tpu_torch.slu.ka2g import KA2GModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    tokens, tok2id, trie, roots = ka2g_setup(corpus)
    onto_ids = [[[tok2id[w] for w in v] for v in sv] for sv in corpus[3]]
    base = kr.build_cfg(len(tokens), True)
    cfg = dataclasses.replace(
        base, asr=dataclasses.replace(base.asr, dtype="float32",
                                      specaug=None),
        gen=dataclasses.replace(base.gen, dtype="float32"))
    state = ASRTask.init_params(KA2GModel(cfg, device="cpu"), 0).state_dict()
    speech, lens, text, tlens = short_batch(len(tokens))
    extra = ka2g_slot_batch(trie, roots, onto_ids)
    compare_cpu_card(
        torch, "phase 22 (b) fp32 KA2G step (the recipe's model, TCPGen on "
        "the ontology forest, dropout 0.1)", KA2GModel, cfg, state, speech,
        lens, text, tlens, extra=extra,
        pointer_stats=("loss_ptr", "loss_gate", "p_gen_live"))
    out = {}
    for dev in ("cpu", "cuda"):
        model = KA2GModel(cfg, device=dev)
        model.load_state_dict(state)
        forest = dict(
            trie={k: torch.from_numpy(v).to(dev)
                  for k, v in kr.forest_arrays(trie).items()},
            roots=torch.from_numpy(roots).to(dev),
            boundary_mask=torch.zeros(len(tokens) + 1, dtype=torch.bool,
                                      device=dev),
            dead=trie.dead)
        sp, sl = (torch.from_numpy(x).to(dev) for x in (speech, lens))
        out[dev] = [tuple(x.cpu() for x in model.generate(sp, sl, **kw))
                    for kw in ({}, forest)]
        del model
    for label, (lc, vc), (lg, vg) in zip(("without", "with"), out["cpu"],
                                         out["cuda"]):
        err = rel_err(lg, lc)[1]
        print(f"phase 22 (b) fp32 KA2G generate() {label} the forest card vs "
              f"CPU: slot logits {err:.3e} of max|ref| (tolerance 1e-4); "
              f"values equal {torch.equal(vg, vc)} ({vg.tolist()})")
        if not (err <= 1e-4 and torch.equal(vg, vc)):
            raise AssertionError(f"phase 22 (b) generate() {label} the "
                                 "forest, card vs CPU")


def ka2g_cli_phase(torch, card, root):
    """Phase 22 (c): recipe/ka2g_run.py's CLI end to end on the corpus
    under root (its arms trained one epoch each, evaluate on one batch of
    KA2G_TEST): results.json with the three arms and RESULTS_KA2G.md
    written; main's return code read and printed (1 when the KB arm does
    not beat the no-KB arm: a one-epoch model says nothing of F1). No K2
    launch."""
    import json as _json
    from espnet_slurp_tpu_torch.recipe import ka2g_run as kr

    out = root / "cli"
    zero_counts()
    t0 = time.perf_counter()
    rc = kr.main(["--out", str(out), "--corpus", str(root / "corpus"),
                  "--n_train", str(KA2G_TRAIN), "--n_dev", str(KA2G_DEV),
                  "--n_test", str(KA2G_TEST), "--max_epoch", "1",
                  "--batch_size", str(KA2G_B), "--eval_batch",
                  str(KA2G_TEST)])
    secs = time.perf_counter() - t0
    launches = read_counts()
    results = _json.loads((out / "results.json").read_text())
    md = (out / "RESULTS_KA2G.md").read_text()
    print(f"phase 22 (c) recipe/ka2g_run.py main returned {rc} in "
          f"{secs:.1f} s (1: the KB arm did not beat the no-KB arm after one "
          f"epoch; not judged); results {results}; launches {launches} on "
          f"{card}")
    print("phase 22 (c) RESULTS_KA2G.md:\n" + md.strip())
    if sorted(results) != ["nokb", "tcpgen_forest", "tcpgen_noforest"] or \
            "| tcpgen_forest |" not in md or launches["fused_ffn"] or \
            not launches["rel_flash_attention"]:
        raise AssertionError("phase 22 (c): results, RESULTS_KA2G.md or "
                             "launches")


def ka2g_resident_task_phase(torch, card, root, corpus):
    """Phase 22 (d): tasks/asr.py's ASRTask with data.resident_corpus (the
    recipe's ASR model, CTC only, word tokens, sorted batches of KA2G_B):
    every batch of an epoch's iterator through a ResidentCorpus equal to
    the host pipeline's (speech bit for bit), then ASRTask.train one epoch
    (KA2G_TRAIN / KA2G_B steps): reporter.json with finite losses."""
    import json as _json
    from espnet_slurp_tpu_torch.data.resident import ResidentCorpus
    from espnet_slurp_tpu_torch.recipe import ka2g_run as kr
    from espnet_slurp_tpu_torch.tasks.asr import (ASRTask, ASRTaskConfig,
                                                  DataConfig)
    from espnet_slurp_tpu_torch.train.optim import OptimConfig

    train_dir, dev_dir, _, _ = corpus
    cfg = ASRTaskConfig(
        exp_dir=str(root / "exp_d"), model=kr.build_cfg(1, False).asr,
        optim=OptimConfig(scheduler="constant", lr=1e-3),
        data=DataConfig(train_dir=str(train_dir), valid_dir=str(dev_dir),
                        token_type="word", batch_type="sorted",
                        batch_size=KA2G_B, resident_corpus=True),
        max_epoch=1, keep_nbest=1, nbest_average=1)
    tok, conv, _ = ASRTask.prepare_vocab(cfg)
    ds = ASRTask.build_dataset(str(train_dir), tok, conv)
    rc = ResidentCorpus.from_datadirs([str(train_dir)], device="cuda")
    t0 = time.perf_counter()
    plain = list(ASRTask.build_iter_factory(cfg, ds, True)(1))
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = list(ASRTask.build_iter_factory(
        cfg, ds, True, speech_materializer=rc.materializer())(1))
    torch.cuda.synchronize()
    t_res = time.perf_counter() - t0
    same = len(plain) == len(res) > 0 and all(
        sorted(a) == sorted(b) and b["speech"].is_cuda
        and torch.equal(b["speech"].cpu(), torch.from_numpy(a["speech"]))
        and all(np.array_equal(a[k], b[k]) for k in a if k != "speech")
        for a, b in zip(plain, res))
    print(f"phase 22 (d) ASRTask.build_iter_factory over {len(plain)} "
          f"batches: host pipeline {t_plain:.2f} s, resident speech "
          f"{t_res:.2f} s; every batch equal {same}")
    if not same:
        raise AssertionError("phase 22 (d): resident batches differ from the "
                             "host pipeline's")
    t0 = time.perf_counter()
    ASRTask.train(cfg, device="cuda")
    hist = _json.loads((root / "exp_d" / "reporter.json").read_text())[
        "history"][0]
    print(f"phase 22 (d) ASRTask.train with data.resident_corpus, one epoch "
          f"of {len(plain)} steps: {time.perf_counter() - t0:.1f} s; train "
          f"{hist['train']}, valid {hist['valid']} on {card}")
    if not all(np.isfinite(hist[ph]["loss"]) for ph in ("train", "valid")):
        raise AssertionError("phase 22 (d): non-finite loss")


def ka2g_k3_entries(torch, card, t, launches):
    """K3 at the KA2G encoder's shape (B KA2G_B, H 4, T' t, Dh 36, ragged
    lengths) through the wrapper (zero-padded to the Dh-64 routes), both
    ways, against the plain version at Dh 36: fp32 and bf16 at rate 0 and
    bf16 at DROPOUT (the same Philox mask), each by the host counts the
    Dh-64 instances once each way; then the bf16 rate-0 call and its
    backward timed beside the plain version, SDPA at Dh 36 and the bound
    of the Dh-36 work. Returns the two kernels-line entries."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(22)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    b, h, dh = KA2G_B, KA2G_HEADS, KA2G_DH
    lengths = torch.tensor([t - 3 * (i % 9) for i in range(b)],
                           dtype=torch.int32, device="cuda")
    qkv = [r(b, h, t, dh) * 0.5 for _ in range(4)]
    p = r(h, 2 * t, dh) * 0.5
    p[:, -1] = 0.0
    cot = r(b, h, t, dh)
    scale = dh ** -0.5
    seed = torch.tensor([DROPOUT_SEED], dtype=torch.int32, device="cuda")
    kept = None
    for dt, rate in ((torch.float32, 0.0), (torch.bfloat16, 0.0),
                     (torch.bfloat16, DROPOUT)):
        name = str(dt).split(".")[-1]
        args = [x.to(dt) for x in qkv] + [p.to(dt), lengths]
        kw = dict(scale=scale, dropout_rate=rate)
        s = seed if rate else None
        hosts0 = build.launch_counts()
        o, g, again = grad_case(
            torch, lambda *a: fa.rel_flash_attention_fwd(*a, s, **kw), args,
            cot.to(dt), 5)
        torch.cuda.synchronize()
        hosts = build.launch_delta(hosts0, build.launch_counts())
        flag = "true>" if rate else "false>"
        inst = ({f"rel_f32::{k}_kernel<64, {flag}": 1
                 for k in ("fwd", "dkv", "dq")} if dt == torch.float32 else
                {f"rel_fwd::fwd_kernel<64, {flag}": 1,
                 f"rel_dkv::dkv_kernel<64, {flag}": 1,
                 f"rel_dq::dq_kernel<64, {flag}": 1})
        ro, rg, plain_again = grad_case(
            torch, lambda *a: fa.rel_flash_attention_plain(*a, s, **kw),
            args, cot.to(dt), 5)
        err_o, err_g = hold(torch, f"phase 22 K3 Dh {dh} (padded to 64) "
                            f"{name} rate {rate} B={b} H={h} T={t}", o, ro,
                            g, rg, ("dq_u", "dq_v", "dk", "dv", "dp"),
                            TOL[name])
        print(f"phase 22 K3 Dh {dh} {name} rate {rate}: host counts {hosts}")
        if hosts != inst or o.shape[-1] != dh:
            raise AssertionError(f"phase 22 K3 Dh {dh} {name}: launched "
                                 f"{hosts}, expected {inst}")
        if dt == torch.bfloat16 and not rate:
            kept = (args, err_o, err_g, again, plain_again)
        else:
            del again, plain_again
    args, err_o, err_g, again, plain_again = kept
    with torch.no_grad():
        fwd_ms = median_ms(torch, lambda: fa.rel_flash_attention_fwd(
            *args, scale=scale))
        plain_fwd_ms = median_ms(torch, lambda: fa.rel_flash_attention_plain(
            *args, scale=scale))
    bwd_ms, plain_bwd_ms = median_ms(torch, again), median_ms(torch,
                                                              plain_again)
    q_u, q_v, k, vv, pp, lens = args
    raw = q_v.float() @ pp[:, :2 * t - 1].float().transpose(-1, -2)
    bd = raw.gather(-1, fa.rel_shift_index(t, raw.device).expand(b, h, t, t))
    allowed = fa.allowed_mask(t, lens)
    bias = torch.where(allowed, bd * scale, fa.NEG).to(q_u.dtype)
    del raw, bd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        lib_fwd = median_ms(torch, lambda: sdpa(q_u, k, vv, attn_mask=bias,
                                                scale=scale))
    leaves = [x.detach().requires_grad_(True) for x in (q_u, k, vv)]
    sd = sdpa(*leaves, attn_mask=bias, scale=scale)
    gb = cot.to(q_u.dtype)
    lib_bwd = median_ms(torch, lambda: torch.autograd.grad(
        sd, leaves, gb, retain_graph=True))
    del sd, leaves, bias
    pairs = float(allowed.expand(b, 1, t, t).sum().item()) * h
    att = att_bounds(b, h, t, dh, pairs, 2, PEAK_BF16_FLOPS)
    print(f"phase 22 K3 Dh {dh} bfloat16 B={b} H={h} T={t}: forward "
          f"{fwd_ms:.4f} ms (plain {plain_fwd_ms:.4f}, SDPA {lib_fwd:.4f}, "
          f"bound {att['fwd'][0]:.4f} by {att['fwd'][1]}), backward "
          f"{bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f}, SDPA {lib_bwd:.4f}, "
          f"bound {att['bwd'][0]:.4f} by {att['bwd'][1]}); the wrapper's "
          f"pad and slice included, on {card}")
    common = dict(route="cuda",
                  source="espnet_slurp_tpu_torch/csrc/flash_attention.cu",
                  note=f"Dh {dh} (the KA2G recipe's 144 / 4 heads) "
                       "zero-padded to the bf16 mma.sync route at Dh 64 "
                       "(ops/kernels/flash_attention.py:pad_heads); bound "
                       f"of the Dh-{dh} work")
    return [
        dict(name="rel_flash_attention_dh36",
             replaces="espnet_slurp_tpu/ops/pallas/flash_attention.py:336",
             launches=launches["fwd"], max_abs_err=err_o, ms=fwd_ms,
             plain_ms=plain_fwd_ms, bound_ms=att["fwd"][0],
             bound_by=att["fwd"][1], library_ms=lib_fwd,
             library_note=f"SDPA at Dh {dh} over a constant rel-shifted "
                          "bias", **common),
        dict(name="rel_flash_attention_bwd_dh36",
             replaces="espnet_slurp_tpu/ops/pallas/flash_attention.py:379",
             launches=launches["bwd"], max_abs_err=err_g, ms=bwd_ms,
             plain_ms=plain_bwd_ms, bound_ms=att["bwd"][0],
             bound_by=att["bwd"][1], library_ms=lib_bwd,
             library_note=f"SDPA backward at Dh {dh} over a constant "
                          "rel-shifted bias; computes no dp", **common)]


def ka2g_phases(torch, card, train_step_s):
    """Phase 22 (a)-(d) and K3's Dh-36 entries on one corpus under
    KA2G_ROOT, removed at the end. Returns (the launches of a KA2G train
    step, the kernels-line entries)."""
    import shutil
    from pathlib import Path
    from espnet_slurp_tpu_torch.recipe import ka2g_run as kr

    root = Path(KA2G_ROOT).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    corpus = kr.make_ka2g_corpus(root / "corpus", n_train=KA2G_TRAIN,
                                 n_dev=KA2G_DEV, n_test=KA2G_TEST)
    print(f"phase 22: make_ka2g_corpus wrote {KA2G_TRAIN} + {KA2G_DEV} + "
          f"{KA2G_TEST} utterances in {time.perf_counter() - t0:.1f} s")
    lap = time.perf_counter()
    step, k3_launches, first, v = ka2g_train_phase(torch, card, root, corpus,
                                                   train_step_s)
    print(f"phase 22 (a): {time.perf_counter() - lap:.1f} s")
    lap = time.perf_counter()
    t_prime = ka2g_ctc_check(torch, first, v)
    entries = ka2g_k3_entries(torch, card, t_prime, k3_launches)
    print(f"phase 22 K4, K1 at D 144 and K3 at Dh 36: "
          f"{time.perf_counter() - lap:.1f} s")
    lap = time.perf_counter()
    ka2g_fp32_phase(torch, card, corpus)
    print(f"phase 22 (b): {time.perf_counter() - lap:.1f} s")
    lap = time.perf_counter()
    ka2g_cli_phase(torch, card, root)
    print(f"phase 22 (c): {time.perf_counter() - lap:.1f} s")
    lap = time.perf_counter()
    ka2g_resident_task_phase(torch, card, root, corpus)
    print(f"phase 22 (d): {time.perf_counter() - lap:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return step, entries


# Phase 23: the remaining ASR decoders at conf/train_streaming.yaml's full
# width (12 x 256, 4 heads, d_ff 1024, a 6-block decoder with d_ff 2048, V
# 5000, chunk 40 / left 1, global MVN with stats of the phase's own corpus,
# bf16), its weights random (ASRTask.init_params, seed 23): STREAM_N
# streams of UTT_SECONDS s (cli_split's tones, word tokens over a 5000-entry
# list) under STREAM_ROOT (the gitignored build/, removed at the end), fed
# STREAM_CHUNK samples a call. (a) the incremental encoder, (b) the
# streaming CLI both ways, (c) the streaming transducer
# (transducer_flagship_config() chunked, fused_conv), (d) the time-sync and
# lattice decodes on the serving traffic, (e) bin/asr_align, (f) MaskCTC at
# the flagship's width through bin/asr_train and bin/asr_inference_maskctc.
STREAM_YAML = "conf/train_streaming.yaml"
STREAM_ROOT = "build/chip_smoke_stream"
STREAM_N, STREAM_CHUNK = 4, 8192
STREAM_MAX_LEN = 32  # the streaming decodes' last pass
STREAM_TAIL = 512  # samples of silence ending each stream (> n_fft / 2)
# (c): the streaming transducer's greedy partials sync once a frame and
# re-decode the prefix each call (RTF 0.53 on a 15 s stream, an H100 run),
# so it streams the first seconds of stream 0
STREAM_TR_SECONDS = 5
# The incremental step's window widths at chunk 40, left 1, kernel 31: the
# valid cache (0, 40 or 80 frames: C = (1 + ceil(30 / 40)) x 40) + 40 new.
STREAM_WIDTHS = {40, 80, 120}
# (d): the CTC head's weights scaled by this in the fp32 card-vs-CPU
# checks (d) and (e), so that a random model's posteriors are peaked and
# no two competing paths lie within fp32 rounding of each other.
SHARPEN = 8.0
# (f): train and dev utterances of cli_split, batches of MASKCTC_B: two
# steps an epoch, two epochs.
MASKCTC_TRAIN, MASKCTC_DEV, MASKCTC_B, MASKCTC_EPOCHS = 16, 4, 8, 2


def stream_config(dtype="bfloat16"):
    """conf/train_streaming.yaml's model in ``dtype``."""
    from espnet_slurp_tpu_torch.tasks.asr import load_task_config
    return dataclasses.replace(load_task_config(STREAM_YAML).model,
                               dtype=dtype)


def stream_tokens():
    """The 5000-entry word token list: cli_split's ten words first."""
    from espnet_slurp_tpu_torch.data.mini_corpus import WORDS
    fill = 5000 - 3 - len(WORDS)
    return (["<blank>", "<unk>"] + list(WORDS)
            + [f"w{i}" for i in range(fill)] + ["<sos/eos>"])


def stream_setup(torch, root):
    """The streams' data dir, their global MVN stats (count / sum /
    sum_square of the fp32 log-mel frames, computed on the card), the
    yaml's model state (random) and an experiment dir a dtype (config,
    tokens, stats, checkpoint "init"). Returns (dev dir, waveforms, exp
    dirs by dtype, the state, (mean, inv_std))."""
    from espnet_slurp_tpu_torch.data.fileio import (load_wav,
                                                    read_2column_text,
                                                    write_wav)
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.ops.frontend import default_frontend
    from espnet_slurp_tpu_torch.ops.normalize import global_mvn_params
    from espnet_slurp_tpu_torch.tasks.asr import (ASRTask, ASRTaskConfig,
                                                  DataConfig)
    from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
    from espnet_slurp_tpu_torch.utils.config import save_yaml

    dev = cli_split(root / "dev", "dev", STREAM_N, np.random.RandomState(23))
    wavs = []
    for path in read_2column_text(dev / "wav.scp").values():
        # digital silence at the end: the incremental encoder's end
        # reflection and the re-encode's zero padding then see the same
        # samples, and the two modes' final frames agree
        wav = load_wav(path)[0]
        wav[-STREAM_TAIL:] = 0.0
        write_wav(path, wav, FS)
        wavs.append(wav)
    fc = stream_config().frontend
    count, total, sq = 0, 0.0, 0.0
    for wav in wavs:
        x = torch.from_numpy(wav).cuda()[None]
        feats, flens = default_frontend(x, torch.tensor([len(wav)],
                                                        device="cuda"), fc)
        f = feats[0, :int(flens[0])].double()
        count, total = count + f.shape[0], total + f.sum(0)
        sq = sq + (f * f).sum(0)
    stats = {"count": np.asarray(count), "sum": total.cpu().numpy(),
             "sum_square": sq.cpu().numpy()}
    mvn = global_mvn_params(stats)
    model = ASRModel(stream_config(), device="cuda")
    state = {k: v.cpu() for k, v in ASRTask.init_params(model, 23)
             .state_dict().items()}
    del model
    exps = {}
    for dtype in ("bfloat16", "float32"):
        exp = root / f"exp_{dtype}"
        (exp / "init").mkdir(parents=True)
        (exp / "stats").mkdir()
        np.savez(exp / "stats" / "feats_stats.npz", **stats)
        (exp / "tokens.txt").write_text("\n".join(stream_tokens()) + "\n")
        save_yaml(ASRTaskConfig(exp_dir=str(exp), model=stream_config(dtype),
                                data=DataConfig(token_type="word")),
                  exp / "config.yaml")
        torch.save({"params": state}, exp / "init" / CKPT_FILE)
        exps[dtype] = exp
    return dev, wavs, exps, state, mvn


def stream_model(torch, state, dtype, device="cuda", sharpen=1.0):
    """The yaml's ASRModel in ``dtype`` on ``device`` with ``state`` (its
    CTC head's weights times ``sharpen``)."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    model = ASRModel(stream_config(dtype), device=device)
    model.load_state_dict(state)
    if sharpen != 1.0:
        with torch.no_grad():
            model.ctc_proj.weight.mul_(sharpen)
    return model.eval()


def incremental_frames(torch, model, wav, mvn, times=None):
    """The incremental encoder's frames of one stream fed STREAM_CHUNK
    samples a call, and the number of steps; ``times`` collects each
    step's host ms (synchronised)."""
    from espnet_slurp_tpu_torch.decode.incremental import (
        IncrementalConformerEncoder)
    inc = IncrementalConformerEncoder(model, mvn)
    if times is not None:
        step = inc._step

        def timed(*a):
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        inc._step = timed
    outs = [inc.feed(wav[off:off + STREAM_CHUNK],
                     is_final=off + STREAM_CHUNK >= len(wav))
            for off in range(0, len(wav), STREAM_CHUNK)]
    return torch.cat(outs).float(), inc._mel_done // (4 * inc.s)


def full_frames(torch, model, wav, mvn):
    """The full chunked encode of one stream (B 1, no padding)."""
    dev = model.device
    mvn = tuple(torch.from_numpy(x).to(dev) for x in mvn)
    with torch.inference_mode():
        hs, hl = model.encode(torch.from_numpy(wav).to(dev)[None],
                              torch.tensor([len(wav)], device=dev), mvn)
    return hs[0, :int(hl[0])].float()


@contextlib.contextmanager
def k3_widths(seen):
    """Records the T of every K3 call of the conformer's attention."""
    from espnet_slurp_tpu_torch.models import attention
    orig = attention.rel_flash_attention

    def recording(q_u, *a, **kw):
        seen.append(int(q_u.shape[2]))
        return orig(q_u, *a, **kw)
    attention.rel_flash_attention = recording
    try:
        yield seen
    finally:
        attention.rel_flash_attention = orig


def stream_incremental_phase(torch, card, wavs, state, mvn):
    """Phase 23 (a): every stream's incremental frames against its full
    chunked encode on the card (bf16 within TOL of max |ref|, fp32 within
    1e-4), the fp32 frames of stream 0 against the CPU's incremental
    frames (1e-4); one bf16 stream's launches by the wrappers' and the host
    counts (K2 24 and K3 12 a step, nothing else), K3's window widths
    (STREAM_WIDTHS) and each step's host ms. Returns the launches a step."""
    from espnet_slurp_tpu_torch.ops.kernels import build
    models = {dt: stream_model(torch, state, dt) for dt in ("bfloat16",
                                                             "float32")}
    for dt, model in models.items():
        errs = []
        for wav in wavs:
            got, _ = incremental_frames(torch, model, wav, mvn)
            want = full_frames(torch, model, wav, mvn)
            if got.shape != want.shape:
                raise AssertionError(f"phase 23 (a) {dt}: frames {got.shape}"
                                     f" against {want.shape}")
            errs.append(rel_err(got, want)[1])
        print(f"phase 23 (a) {STREAM_YAML} {dt}: incremental frames against "
              f"the full chunked encode, {STREAM_N} x {UTT_SECONDS} s fed "
              f"{STREAM_CHUNK} samples a call: "
              f"{[f'{e:.3e}' for e in errs]} of max|ref| (tolerance "
              f"{TOL[dt]}) on {card}")
        if max(errs) > TOL[dt]:
            raise AssertionError(f"phase 23 (a) {dt} incremental frames")
    cpu = stream_model(torch, state, "float32", "cpu")
    card_f, _ = incremental_frames(torch, models["float32"], wavs[0], mvn)
    cpu_f, _ = incremental_frames(torch, cpu, wavs[0], mvn)
    err = rel_err(card_f.cpu(), cpu_f)[1]
    print(f"phase 23 (a) fp32 incremental frames card vs CPU (stream 0): "
          f"{err:.3e} of max|ref| (tolerance 1e-4)")
    if err > 1e-4:
        raise AssertionError("phase 23 (a) fp32 card vs CPU")
    del cpu
    times, seen = [], []
    model = models["bfloat16"]
    incremental_frames(torch, model, wavs[1], mvn)  # warm
    zero_counts()
    hosts0 = build.launch_counts()
    with k3_widths(seen):
        _, steps = incremental_frames(torch, model, wavs[1], mvn, times)
    torch.cuda.synchronize()
    total = read_counts()
    hosts = build.launch_delta(hosts0, build.launch_counts())
    per_step = {k: v // steps for k, v in total.items() if v}
    k2 = sum(v for k, v in hosts.items() if k.startswith("ffn_fwd::fwd"))
    k3 = sum(v for k, v in hosts.items() if k.startswith("rel_fwd::fwd"))
    print(f"phase 23 (a) bf16 incremental step: {steps} steps a stream, "
          f"launches {total} ({per_step} a step), host counts {hosts}; K3 "
          f"window widths {sorted(set(seen))}; host ms a step median "
          f"{np.median(times):.2f}, first {times[0]:.2f}, last "
          f"{times[-1]:.2f} ({[round(x, 2) for x in times]}) on {card}")
    want = {"fused_ffn": 24 * steps, "rel_flash_attention": 12 * steps}
    if ({k: v for k, v in total.items() if v} != want or k2 != 24 * steps
            or k3 != 12 * steps or set(seen) != STREAM_WIDTHS):
        raise AssertionError(f"phase 23 (a): launches {total}, host K2 {k2} "
                             f"K3 {k3}, widths {set(seen)}")
    return per_step


def chunk_figures(out):
    """(RTF, and over the streams the medians of: the ms a call, the first
    call's, the last partial call's, the slowest partial call's, the final
    call's (the last pass included)) of a bin/asr_inference_streaming
    output dir."""
    score = dict(line.split() for line in
                 (out / "score.txt").read_text().splitlines())
    per = list(json.loads((out / "chunk_ms.json").read_text()).values())
    med = lambda xs: float(np.median(xs))
    return (float(score["RTF"]), med([x for ts in per for x in ts]),
            med([ts[0] for ts in per]), med([ts[-2] for ts in per]),
            med([max(ts[:-1]) for ts in per]), med([ts[-1] for ts in per]))


def stream_cli_phase(torch, card, root, dev, exps):
    """Phase 23 (b): bin/asr_inference_streaming with and without
    --incremental over the streams in bf16, and over the first two in
    fp32: each run's RTF, ms a call (chunk_figures) and launches; the fp32
    runs' final texts equal."""
    from espnet_slurp_tpu_torch.bin import asr_inference_streaming as cli
    two = root / "dev2"
    two.mkdir()
    for name in ("wav.scp", "text"):
        lines = (dev / name).read_text().splitlines()[:2]
        (two / name).write_text("\n".join(lines) + "\n")
    texts = {}
    for dtype, exp in exps.items():
        data = dev if dtype == "bfloat16" else two
        for mode in ("re-encode", "incremental"):
            out = root / f"dec_{dtype}_{mode}"
            flags = ["--incremental"] if mode == "incremental" else []
            zero_counts()
            t0 = time.perf_counter()
            rc = cli.main(["--exp_dir", str(exp), "--ckpt", "init",
                           "--data_dir", str(data), "--output_dir", str(out),
                           "--sim_chunk_length", str(STREAM_CHUNK),
                           "--max_len", str(STREAM_MAX_LEN), *flags])
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in read_counts().items() if v}
            rtf, med, first, last, top, final = chunk_figures(out)
            texts[dtype, mode] = (out / "text").read_text()
            print(f"phase 23 (b) bin/asr_inference_streaming {dtype} {mode}: "
                  f"RTF {rtf:.4f}; host ms a call: median {med:.2f}, a "
                  f"stream's first {first:.2f}, its last partial {last:.2f}, "
                  f"its slowest partial {top:.2f}, its final (the last pass "
                  f"included) {final:.2f}; {wall:.1f} s; launches {launches} "
                  f"on {card}")
            if rc != 0 or not launches.get("rel_flash_attention"):
                raise AssertionError(f"phase 23 (b) {dtype} {mode}")
    same = texts["float32", "re-encode"] == texts["float32", "incremental"]
    print(f"phase 23 (b) fp32 final texts of the two modes equal: {same}")
    if not same:
        raise AssertionError("phase 23 (b): fp32 texts differ by mode")


def stream_transducer_phase(torch, card, wav):
    """Phase 23 (c): transducer_flagship_config() chunked (40, left 1)
    with fused_conv (random weights): one bf16 re-encode of a stream by
    the wrappers' and the host counts (K6 12 in its causal bf16 form, K2
    24, K3 12), the bf16 StreamingTransducerRecognizer (ALSA, beam 4) over
    the stream with its RTF; then in fp32 its final result equal to the
    non-streaming ALSA decode. Returns the re-encode's launches."""
    from espnet_slurp_tpu_torch.decode.streaming import (
        StreamingTransducerRecognizer)
    from espnet_slurp_tpu_torch.decode.transducer_beam import run_search
    from espnet_slurp_tpu_torch.models.transducer import (
        TransducerModel, transducer_flagship_config)
    from espnet_slurp_tpu_torch.ops.kernels import build
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask, pad_speech_batch

    base = transducer_flagship_config()
    cfg = {dt: dataclasses.replace(base, asr=dataclasses.replace(
        base.asr, chunk_size=40, left_chunks=1, fused_conv=True, dtype=dt))
        for dt in ("bfloat16", "float32")}
    model = ASRTask.init_params(TransducerModel(cfg["bfloat16"],
                                                device="cuda"), 23).eval()
    state = model.state_dict()
    x = torch.from_numpy(wav).cuda()[None]
    n = torch.tensor([len(wav)], device="cuda")
    with torch.inference_mode():
        model.encode(x, n)
        torch.cuda.synchronize()
        zero_counts()
        hosts0 = build.launch_counts()
        model.encode(x, n)
        torch.cuda.synchronize()
    enc = {k: v for k, v in read_counts().items() if v}
    hosts = build.launch_delta(hosts0, build.launch_counts())
    print(f"phase 23 (c) streaming transducer (12 x 256, chunk 40 / left 1, "
          f"fused_conv, bf16): a re-encode's launches {enc}, host counts "
          f"{hosts}")
    want = {"fused_conv_module": 12, "fused_ffn": 24,
            "rel_flash_attention": 12}
    if (enc != want or hosts.get("conv_bf16::glu_kernel") != 12
            or hosts.get("conv_bf16::out_kernel") != 12):
        raise AssertionError(f"phase 23 (c): launches {enc}")
    kw = dict(chunk_samples=STREAM_CHUNK, max_len=STREAM_MAX_LEN,
              beam_size=4, search="alsa")
    rec = StreamingTransducerRecognizer(model, **kw)
    t0 = time.perf_counter()
    for off in range(0, len(wav), STREAM_CHUNK):
        ids, _ = rec(wav[off:off + STREAM_CHUNK],
                     is_final=off + STREAM_CHUNK >= len(wav))
    rtf = (time.perf_counter() - t0) / (len(wav) / FS)
    m32 = TransducerModel(cfg["float32"], device="cuda").eval()
    m32.load_state_dict(state)
    rec = StreamingTransducerRecognizer(m32, **kw)
    for off in range(0, len(wav), STREAM_CHUNK):
        ids32, _ = rec(wav[off:off + STREAM_CHUNK],
                       is_final=off + STREAM_CHUNK >= len(wav))
    buf, lens = pad_speech_batch([wav])
    with torch.inference_mode():
        hs, hl = m32.encode(torch.from_numpy(buf).cuda(),
                            torch.from_numpy(lens).cuda())
        tok, ln = run_search(m32, hs, hl, "alsa", 4, STREAM_MAX_LEN)
    want_ids = tok[0, :int(ln[0])].tolist()
    print(f"phase 23 (c) bf16 streaming ALSA over {len(wav) / FS:.1f} s: RTF "
          f"{rtf:.4f}, {len(ids)} tokens; fp32 streaming final {len(ids32)} "
          f"tokens equal to the non-streaming decode: {ids32 == want_ids} "
          f"on {card}")
    if ids32 != want_ids:
        raise AssertionError("phase 23 (c): fp32 streaming final differs")
    return enc


def stream_decode_phase(torch, card, root, wavs, state, mvn):
    """Phase 23 (d): Speech2Text with ctc_timesync and with lattice (the
    decoder at 0.3) on the serving traffic (N_UTT x UTT_SECONDS s: the
    streams twice) at beam BEAM, and lattice_rescore_decode with
    LMConfig() (random) at 0.3 and a trigram over the word list at 0.3:
    each one's RTF. Then fp32 (the CTC head sharpened by SHARPEN) on 2
    utterances from one card encode: the posteriors card vs CPU (1e-4 of
    max |ref|), and, on the card's posteriors, the CPU's prefix beam and
    lattice equal to the card's (tokens and lengths in every slot, scores
    within 1e-4 relative)."""
    from espnet_slurp_tpu_torch.data.tokenizer import build_tokenizer
    from espnet_slurp_tpu_torch.decode import lattice as lat
    from espnet_slurp_tpu_torch.decode import timesync as ts
    from espnet_slurp_tpu_torch.decode.ngram import ArpaLM, make_ngram_fusion
    from espnet_slurp_tpu_torch.decode.ngram_train import train_arpa
    from espnet_slurp_tpu_torch.models.lm import LMConfig
    from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
    from espnet_slurp_tpu_torch.tasks.lm import LMTask

    tokens = stream_tokens()
    speeches = (wavs * N_UTT)[:N_UTT]
    audio_s = sum(len(w) for w in speeches) / FS
    tok = build_tokenizer("word")
    for label, kw in (("ctc_timesync", dict(ctc_timesync=True)),
                      ("lattice", dict(lattice=True,
                                       lattice_att_weight=0.3))):
        s2t = Speech2Text(stream_config(), state, tokens, beam_size=BEAM,
                          max_len=MAX_LEN, device="cuda", mvn_stats=mvn,
                          tokenizer=tok, **kw)
        s2t.decode_batch(speeches[:2])  # warm
        zero_counts()
        t0 = time.perf_counter()
        texts = s2t.decode_batch(speeches)
        secs = time.perf_counter() - t0
        print(f"phase 23 (d) Speech2Text {label} {N_UTT} x {UTT_SECONDS} s at "
              f"beam {BEAM}: RTF {secs / audio_s:.5f}, launches "
              f"{ {k: v for k, v in read_counts().items() if v} }, words "
              f"{[len(x.split()) for x in texts]} on {card}")
    rng = np.random.RandomState(23)
    sents = [list(rng.choice(tokens[2:200], rng.randint(3, 12)))
             for _ in range(400)]
    arpa = train_arpa(sents, root / "lm.arpa", order=3)
    tok2id = {t: i for i, t in enumerate(tokens)}
    tok2id.update({"<s>": 4999, "</s>": 4999})
    ngram = make_ngram_fusion(ArpaLM(str(arpa), tok2id, 5000), 4999, "cuda")
    lm = LMTask.init_model(LMConfig(vocab_size=5000), 23, "cuda").eval()
    model = stream_model(torch, state, "bfloat16")
    buf, lens = s2t.pad_batch(speeches)
    t0 = time.perf_counter()
    with torch.inference_mode():
        hs, hl = model.encode(torch.from_numpy(buf).cuda(),
                              torch.from_numpy(lens).cuda(), s2t.mvn_stats)
        out, out_len, det = lat.lattice_rescore_decode(
            model, hs, hl, lat.LatticeConfig(
                beam_size=BEAM, max_len=MAX_LEN, att_weight=0.3,
                lm_weight=0.3, ngram_weight=0.3), lm_model=lm,
            ngram_step_init=ngram)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"phase 23 (d) lattice with LMConfig() ({lm.cfg.num_blocks} x "
          f"{lm.cfg.d_model}) and the trigram at 0.3 each: RTF "
          f"{secs / audio_s:.5f}; components {sorted(det)}, lengths "
          f"{out_len.tolist()} on {card}")
    del lm, model
    gpu = stream_model(torch, state, "float32", sharpen=SHARPEN)
    cpu = stream_model(torch, state, "float32", "cpu", sharpen=SHARPEN)
    b2, l2 = s2t.pad_batch(speeches[:2])
    with torch.inference_mode():
        hs, hl = gpu.encode(torch.from_numpy(b2).cuda(),
                            torch.from_numpy(l2).cuda(), s2t.mvn_stats)
        lp_card = gpu.ctc_logprobs(hs)
        lp_cpu = cpu.ctc_logprobs(hs.cpu())
    m = (torch.arange(hs.shape[1])[None, :] < hl.cpu()[:, None])[..., None]
    lp_err = rel_err(torch.where(m, lp_card.cpu(), 0),
                     torch.where(m, lp_cpu, 0))[1]
    cpu.ctc_logprobs = lambda x: lp_card.cpu()
    cfg = dict(beam_size=BEAM, max_len=MAX_LEN)
    res = {}
    for dev, mdl, h, l in (("cuda", gpu, hs, hl), ("cpu", cpu, hs.cpu(),
                                                   hl.cpu())):
        full = ts.ctc_prefix_beam_full(mdl, h, l, ts.TimeSyncConfig(**cfg))
        _, _, det = lat.lattice_rescore_decode(
            mdl, h, l, lat.LatticeConfig(att_weight=0.3, **cfg))
        res[dev] = [x.cpu() for x in full] + [det["total"].cpu()]
    same = all(torch.equal(res["cuda"][i], res["cpu"][i]) for i in (0, 1))
    errs = [rel_err(res["cuda"][i], res["cpu"][i])[1] for i in (2, 3)]
    print(f"phase 23 (d) fp32 (CTC head x{SHARPEN}) card vs CPU on 2 "
          f"utterances: posteriors {lp_err:.3e} of max|ref| (tolerance "
          f"1e-4); on the card's posteriors the prefix beam's tokens and "
          f"lengths equal in all {BEAM} slots {same}, its scores "
          f"{errs[0]:.3e} and the lattice's totals (decoder at 0.3) "
          f"{errs[1]:.3e} relative (tolerance 1e-4); lengths "
          f"{res['cuda'][1].tolist()}")
    if not (lp_err <= 1e-4 and same and max(errs) <= 1e-4):
        raise AssertionError("phase 23 (d) fp32 card vs CPU")


def stream_align_phase(torch, card, root, dev, exp):
    """Phase 23 (e): bin/asr_align on the streams (fp32, the CTC head
    sharpened by SHARPEN) on the card and on the CPU: equal segments, one
    line a transcript word."""
    from espnet_slurp_tpu_torch.bin import asr_align
    from espnet_slurp_tpu_torch.train.checkpoint import CKPT_FILE
    ckpt = exp / "init" / CKPT_FILE
    tree = torch.load(ckpt, weights_only=True)
    sharp = dict(tree["params"])
    sharp["ctc_proj.weight"] = sharp["ctc_proj.weight"] * SHARPEN
    (exp / "sharp").mkdir()
    torch.save({"params": sharp}, exp / "sharp" / CKPT_FILE)
    segs, secs = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        rc = asr_align.main(["--exp_dir", str(exp), "--ckpt", "sharp",
                             "--data_dir", str(dev), "--output_dir",
                             str(root / f"ali_{device}"), "--device",
                             device])
        secs[device] = time.perf_counter() - t0
        segs[device] = (root / f"ali_{device}" / "segments").read_text()
        if rc != 0:
            raise AssertionError(f"phase 23 (e) {device}")
    words = sum(len(line.split()[1:]) for line in
                (dev / "text").read_text().splitlines())
    lines = segs["cuda"].splitlines()
    print(f"phase 23 (e) bin/asr_align fp32 on {STREAM_N} x {UTT_SECONDS} s: "
          f"card {secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s; {len(lines)} "
          f"segments ({words} words); card equal to CPU "
          f"{segs['cuda'] == segs['cpu']}; first {lines[:2]} on {card}")
    if segs["cuda"] != segs["cpu"] or len(lines) != words:
        raise AssertionError("phase 23 (e): segments differ")


def maskctc_want(n_rows):
    """A MaskCTC flagship step on n_rows rows, each way: phase 15's step
    (cli_step_want: K2 24, K3 12, K1 1 by the wrappers' counts; their
    dropout instances and K1's warp route by the host counts) without K4,
    as the CTC loss reads the logits."""
    wrappers, hosts = cli_step_want(n_rows, 12)
    wrappers = {k: 0 if k.startswith("fused_ctc_head") else v
                for k, v in wrappers.items()}
    return wrappers, {k: v for k, v in hosts.items()
                      if k not in K4_BF16_LAUNCHES}


def maskctc_phase(torch, card, root):
    """Phase 23 (f): the flagship with model_arch: maskctc (dropout
    DROPOUT, SpecAug on, char tokens) MASKCTC_EPOCHS epochs through
    bin/asr_train on cli_split's MASKCTC_TRAIN + MASKCTC_DEV utterances
    (batches of MASKCTC_B), every step's launches by the wrappers' and the
    host counts (maskctc_want), finite losses; bin/asr_inference_maskctc
    on the dev set (its RTF); and a fp32 step card vs CPU at a fixed mask
    (loss and gradients, compare_cpu_card). Returns the launches a
    step."""
    import yaml
    from espnet_slurp_tpu_torch.bin import asr_inference_maskctc, asr_train
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.models.maskctc import MaskCTCModel
    from espnet_slurp_tpu_torch.tasks import asr as task
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask
    from espnet_slurp_tpu_torch.utils.config import to_dict

    rng = np.random.RandomState(17)
    train = cli_split(root / "mtrain", "train", MASKCTC_TRAIN, rng)
    dev = cli_split(root / "mdev", "dev", MASKCTC_DEV, rng)
    model = to_dict(dataclasses.replace(flagship_config(),
                                        dropout_rate=DROPOUT))
    del model["vocab_size"]
    exp = root / "exp_maskctc"
    cfg = {"exp_dir": str(exp), "model_arch": "maskctc",
           "max_epoch": MASKCTC_EPOCHS, "model": model,
           "optim": {"name": "adam", "lr": 1e-3, "scheduler": "constant"},
           "data": {"train_dir": str(train), "valid_dir": str(dev),
                    "token_type": "char", "batch_type": "sorted",
                    "batch_size": MASKCTC_B}}
    (root / "maskctc.yaml").write_text(yaml.safe_dump(cfg))
    per_step, clock = [], []
    orig = step_recorder(torch, per_step, clock, task=task)
    t0 = time.perf_counter()
    try:
        rc = asr_train.main(["--config", str(root / "maskctc.yaml")])
    finally:
        task.make_train_step = orig
    secs = time.perf_counter() - t0
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    bad = [i for i, (w, h, rows) in enumerate(per_step)
           if (w, h) != maskctc_want(rows)]
    losses = [e[ph][k] for e in hist for ph in ("train", "valid")
              for k in ("loss", "loss_ctc", "loss_mlm")]
    steps = MASKCTC_EPOCHS * (MASKCTC_TRAIN // MASKCTC_B)
    print(f"phase 23 (f) MaskCTC (flagship 12 x 256, bf16, dropout {DROPOUT})"
          f" through bin/asr_train: {len(per_step)} steps in {secs:.1f} s "
          f"with the valid passes; a step's launches {per_step[0][0]}, host "
          f"counts {per_step[0][1]}; losses by epoch "
          f"{[{k: round(v, 4) for k, v in e['train'].items()
               if k.startswith(('loss', 'acc'))} for e in hist]}"
          f" on {card}")
    if rc != 0 or len(per_step) != steps or bad or not np.isfinite(
            losses).all():
        raise AssertionError(f"phase 23 (f): steps {len(per_step)}, off-want "
                             f"steps {bad}, losses {losses}")
    out = root / "dec_maskctc"
    zero_counts()
    asr_inference_maskctc.main(["--exp_dir", str(exp), "--data_dir",
                                str(dev), "--output_dir", str(out),
                                "--max_len", str(MAX_LEN)])
    score = dict(line.split() for line in
                 (out / "score.txt").read_text().splitlines())
    print(f"phase 23 (f) bin/asr_inference_maskctc on {MASKCTC_DEV} x "
          f"{UTT_SECONDS} s: {score}; launches "
          f"{ {k: v for k, v in read_counts().items() if v} } on {card}")
    # fp32 step card vs CPU at a fixed mask of short_batch's targets
    vocab = len((exp / "tokens.txt").read_text().split())
    f32 = dataclasses.replace(flagship_config(), vocab_size=vocab,
                              dropout_rate=DROPOUT, dtype="float32",
                              specaug=None)
    speech, lens, text, tlens = short_batch(vocab)
    mask = (np.random.RandomState(5).rand(*text.shape) < 0.3) & (
        np.arange(text.shape[1])[None, :] < tlens[:, None])

    class Masked(MaskCTCModel):
        def forward(self, *a, **kw):
            return super().forward(*a, mask=torch.from_numpy(mask), **kw)

    state = ASRTask.init_params(MaskCTCModel(f32, device="cpu"), 5)\
        .state_dict()
    compare_cpu_card(torch, f"phase 23 (f) fp32 MaskCTC step "
                     f"({int(mask.sum())} of {int(tlens.sum())} targets "
                     f"masked, dropout {DROPOUT})", Masked, f32, state,
                     speech, lens, text, tlens)
    return per_step[0][0]


def stream_kernel_checks(torch, card):
    """K3's forward at the incremental step's shapes (B 1, H 4, Dh 64, T
    40 / 80 / 120, chunk (40, 1), the last chunk partial: lengths 3T / 4)
    and K6's causal bf16 forward at B 1 (a stream's T' 468, D 256, k 31),
    each against its plain version (bf16 TOL, fp32 1e-4 for K3)."""
    from espnet_slurp_tpu_torch.ops.kernels import conv_module as kc
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(23)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    h, dh = 4, 64
    for t in sorted(STREAM_WIDTHS):
        n = t - t // 4  # the last chunk partial
        lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
        base = [r(1, h, t, dh) * 0.5 for _ in range(4)]
        p = r(h, 2 * t, dh) * 0.5
        p[:, -1] = 0.0
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            args = [x.to(dt) for x in base] + [p.to(dt), lengths]
            kw = dict(scale=dh ** -0.5, chunk_size=40, left_chunks=1)
            out, _ = fa.rel_flash_attention_fwd(*args, **kw)
            ref, _ = fa.rel_flash_attention_plain(*args, **kw)
            rel = rel_err(out[:, :, :n], ref[:, :, :n])[1]
            print(f"phase 23 K3 {name} B=1 H={h} T={t} Dh={dh} chunk (40, 1) "
                  f"lengths {n}: {rel:.3e} of max|ref| (tolerance "
                  f"{TOL[name]})")
            if rel > TOL[name]:
                raise AssertionError(f"phase 23 K3 {name} T {t}")
    t, d, k = 468, 256, 31
    params = (r(2 * d, d) * d ** -0.5, r(2 * d) * 0.1, r(d, k) * k ** -0.5,
              r(d) * 0.1, 1.0 + 0.1 * r(d), r(d) * 0.1, r(d, d) * d ** -0.5,
              r(d) * 0.1)
    args = k6_args(r(1, t, d), torch.tensor([t], dtype=torch.int32,
                                            device="cuda"), params,
                   torch.bfloat16)
    out = kc.fused_conv_module(*args, kernel_size=k, causal=True)
    ref = kc.fused_conv_module_plain(*args, kernel_size=k, causal=True)
    rel = rel_err(out, ref)[1]
    print(f"phase 23 K6 causal bf16 forward B=1 T={t} D={d} k={k}: "
          f"{rel:.3e} of max|ref| (tolerance {TOL['bfloat16']}) on {card}")
    if rel > TOL["bfloat16"]:
        raise AssertionError("phase 23 K6 causal bf16 at B 1")


def stream_phases(torch, card):
    """Phase 23 (a)-(f) and the kernel checks under STREAM_ROOT, removed at
    the end. Returns (the incremental step's launches, the streaming
    transducer re-encode's, the MaskCTC step's)."""
    import shutil
    from pathlib import Path

    root = Path(STREAM_ROOT).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    dev, wavs, exps, state, mvn = stream_setup(torch, root)
    laps = {"setup": time.perf_counter() - t0}

    def lap(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        laps[name] = time.perf_counter() - t
        return out

    step = lap("(a)", stream_incremental_phase, torch, card, wavs, state, mvn)
    lap("(b)", stream_cli_phase, torch, card, root, dev, exps)
    tr = lap("(c)", stream_transducer_phase, torch, card,
             wavs[0][:STREAM_TR_SECONDS * FS])
    lap("(d)", stream_decode_phase, torch, card, root, wavs, state, mvn)
    lap("(e)", stream_align_phase, torch, card, root, dev, exps["float32"])
    masked = lap("(f)", maskctc_phase, torch, card, root)
    lap("kernels", stream_kernel_checks, torch, card)
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s "
          f"({ {k: round(v, 1) for k, v in laps.items()} })")
    return step, tr, masked


# Phase 24: the remaining ASR encoders and decoders (ROADMAP.md item 15).
# The flagship's widths with the E-Branchformer encoder (cgMLP 2 x d_ff).
EB_B, EB_U = TRAIN_B, TRAIN_U
# (b): the contextual block's step batch (16 x 15 s: its 30 blocks of 42
# tokens an utterance hold 2.7x the Conformer's tokens).
CB_B = 16
# (c): the small models' traffic, 8 x 5 s, U 16; the decodes' max_len.
SMALL_B, SMALL_SECONDS, SMALL_U, SMALL_MAX_LEN = 8, 5, 16, 32
# The Sinc pre-encoder's sliding-window frames (400 samples, 10 ms hop).
SINC_FRONT = dict(type="sliding_window", n_fft=512, win_length=400,
                  hop_length=160)


def relu_inputs(model):
    """(module, pooled) for each module whose output goes through a ReLU or
    a leaky ReLU: the Conv2d subsampling's convs or VGG2L's (pooled: a 2 x
    2 ceil max-pool follows the ReLU of the second conv of each VGG block),
    the Sinc pre-encoder's blocks, a post-encoder's length adaptors and
    the attention decoder's FFNs."""
    from espnet_slurp_tpu_torch.models.transformer import FeedForward
    asr = getattr(model, "asr", model)
    enc = asr.encoder
    embed, vgg = getattr(enc, "embed", None), getattr(enc, "vgg", None)
    mods = []
    if hasattr(embed, "n_convs"):
        mods += [(getattr(embed, f"conv{i + 1}"), False)
                 for i in range(embed.n_convs)]
    if vgg is not None:
        mods += [(getattr(vgg, f"conv{i}_{j}"), j == 2) for i in range(2)
                 for j in (1, 2)]
    post = getattr(asr, "postencoder", None)
    if post is not None:
        mods += [(getattr(post, f"adaptor_{i}"), False)
                 for i in range(post.n_adaptors)]
    pre = getattr(asr, "preencoder", None)
    for name, *_, pointwise, _, _ in getattr(pre, "blocks", ()):
        mods.append((getattr(pre, f"{name}_{'pw' if pointwise else 'dw'}"),
                     False))
    decoder = getattr(asr, "decoder", None)  # a transducer has none
    if decoder is not None:
        mods += [(m.w1, False) for m in decoder.modules()
                 if isinstance(m, FeedForward)]
    return mods


def pool_flips(torch, z_c, z_g):
    """[..., H, W] bool: the elements of each 2 x 2 ceil max-pool window
    over relu(z) whose chosen element differs between the two sides (a
    near-tie within fp32 rounding; an all-zero window passes no gradient
    and is left out)."""
    pick = lambda z: torch.nn.functional.max_pool2d(
        torch.relu(z.detach()), 2, 2, ceil_mode=True, return_indices=True)
    (v_c, i_c), (_, i_g) = pick(z_c), pick(z_g)
    apart = (i_c != i_g) & (v_c > 0)
    h, w = z_c.shape[-2:]
    return apart.repeat_interleave(2, -2).repeat_interleave(2, -1)[
        ..., :h, :w]


def eb_config(**kw):
    """The flagship's widths (vocab 5000, 12 x 256, 4 heads, d_ff 1024,
    cgMLP 2048, kernel 31, the 6-block decoder, bf16) with the
    E-Branchformer encoder."""
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    return dataclasses.replace(flagship_config(), encoder="ebranchformer",
                               **kw)


class KernelCalls:
    """Records every K2 / K3 call that the models make through
    models/conformer.py:fused_ffn and models/attention.py:rel_flash_attention
    while ``active``: the kind, the inputs (detached copies) and the
    keywords; the wrappers themselves run as they would."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def active(self):
        import torch
        from espnet_slurp_tpu_torch.models import attention, conformer
        ffn, att = conformer.fused_ffn, attention.rel_flash_attention

        def rec(kind, fn):
            def call(*a, **kw):
                self.calls.append((kind, [
                    x.detach().clone() if torch.is_tensor(x) else x
                    for x in a], dict(kw)))
                return fn(*a, **kw)
            return call

        conformer.fused_ffn = rec("K2", ffn)
        attention.rel_flash_attention = rec("K3", att)
        try:
            yield self
        finally:
            conformer.fused_ffn, attention.rel_flash_attention = ffn, att


def ulp_bf16(torch, x):
    """The bf16 unit in the last place of each |x| (0 at 0)."""
    _, e = torch.frexp(x)
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x), e - 8),
                       torch.zeros_like(x))


def k3_bwd_rounding_bounds(torch, q_u, q_v, k, v, p, lengths, out, lse, g,
                           seed, *, scale, dropout_rate=0.0, chunk_size=0,
                           left_chunks=-1):
    """Elementwise bounds (dq_u, dq_v, dk, dv, dp) on how far two bf16
    computations of K3's backward that round at the same points
    (rel_flash_attention_bwd_plain's: ds, the skewed rawg, the dropped P)
    but sum in another order can fall apart, in float64: the scores and
    ds = P (dP - delta) scale carry the fp32 error of their sums (Dh 2^-24
    of the sums of absolute terms; P through exp's relative error of the
    scores'), each rounded operand moves by that and then one bf16 unit in
    its last place, which reaches each output through the product that
    takes it (T 2^-24 of the product for its own fp32 sum), and each
    output's own rounding adds one unit of itself. Where dP and delta
    nearly cancel (peaked attention), ds's fp32 error is large beside ds,
    and a max|ref|-relative tolerance sits inside this noise."""
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa
    from espnet_slurp_tpu_torch.ops.kernels import philox
    f64 = lambda x: x.double()
    b, h, t, dh = q_u.shape
    qu, qv, kf, vf, pf, gf, of = map(f64, (q_u, q_v, k, v, p, g, out))
    idx = fa.rel_shift_index(t, q_u.device).expand(b, h, t, t)
    eps, eps_t = dh * 2.0 ** -24, t * 2.0 ** -24
    s = (qu @ kf.transpose(-1, -2)
         + (qv @ pf.transpose(-1, -2)).gather(-1, idx)) * scale
    s_abs = (qu.abs() @ kf.abs().transpose(-1, -2)
             + (qv.abs() @ pf.abs().transpose(-1, -2)).gather(-1, idx)) * scale
    ok = fa.allowed_mask(t, lengths, chunk_size, left_chunks)
    prob = torch.where(ok, torch.exp(s - f64(lse)[..., None]), 0.0)
    e_prob = prob * eps * (s_abs + f64(lse).abs()[..., None])
    dprob = gf @ vf.transpose(-1, -2)
    dprob_abs = gf.abs() @ vf.abs().transpose(-1, -2)
    pd, e_pd = prob, e_prob
    if dropout_rate > 0.0:
        keep = fa.dropout_keep(seed, dropout_rate, b, h, t)
        dprob = philox.apply_keep(dprob, keep, dropout_rate)
        dprob_abs = philox.apply_keep(dprob_abs, keep, dropout_rate)
        pd = philox.apply_keep(prob, keep, dropout_rate)
        e_pd = philox.apply_keep(e_prob, keep, dropout_rate)
    delta = (gf * of).sum(-1, keepdim=True)
    delta_abs = (gf * of).abs().sum(-1, keepdim=True)
    gap = dprob - delta
    ds = prob * gap * scale
    e_ds = scale * (prob * eps * (dprob_abs + delta_abs)
                    + e_prob * gap.abs())
    u_ds = torch.where(ok, e_ds + ulp_bf16(torch, ds.abs() + e_ds)
                       + eps_t * ds.abs(), 0.0)
    u_pd = e_pd + ulp_bf16(torch, pd + e_pd) + eps_t * pd
    rawg = torch.zeros(b, h, t, 2 * t, dtype=torch.float64,
                       device=q_u.device).scatter_(-1, idx, u_ds)
    return (u_ds @ kf.abs(), rawg @ pf.abs(),
            u_ds.transpose(-1, -2) @ qu.abs(),
            u_pd.transpose(-1, -2) @ gf.abs(),
            (rawg.transpose(-1, -2) @ qv.abs()).sum(0))


def within_rounding(torch, got, want, bounds):
    """max over elements of |got - want| / (bound + one bf16 unit of
    want): at most 1 when the two differ by no more than the rounding
    bounds allow."""
    worst = 0.0
    for a, r, u in zip(got, want, bounds):
        r = r.double()
        room = u + ulp_bf16(torch, r.abs()) + 1e-30
        worst = max(worst, float(((a.double() - r).abs() / room).max()))
    return worst


def hold_calls(torch, what, calls, backward, k3_rounding=False):
    """Each recorded K2 / K3 call run again on its inputs and seed: the
    wrapper's output (the kernel) within TOL of its plain version's (fp32
    products); with ``backward`` also the backward launches on a random
    cotangent, from the kernel's own forward, within BWD_PLAIN_TOL of the
    plain backward at the kernels' rounding points (fused_ffn_bwd_plain,
    rel_flash_attention_bwd_plain), as phase 4 holds them: against the
    unrounded plain gradient a bf16 dq of real activations, which cancels,
    is off by more than 2e-2 of its max |ref| while the terms it sums
    agree (measured on an H100). With ``k3_rounding`` a bf16 K3 backward is
    held instead element by element within k3_bwd_rounding_bounds of the
    plain backward (within_rounding at most 1): on peaked attention two
    correct computations between the same rounding points differ by about
    BWD_PLAIN_TOL of max |ref| (the plain backward summed in fp32 and in
    fp64, ``accumulate``, whose distance it reports too). Returns {kind:
    (calls, worst forward error, worst backward error)}, each of max
    |ref|, and with ``k3_rounding`` also the worst within_rounding ratio
    and the worst distance of the two plain backwards, of max |ref|."""
    from espnet_slurp_tpu_torch.ops.kernels import ffn
    from espnet_slurp_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(24)
    worst = {}
    for kind, args, kw in calls:
        rate = kw.get("dropout_rate", 0.0)
        if kind == "K2":
            diff, seed = args[:5], (args[5] if len(args) > 5 else None)
            with torch.no_grad():
                out = ffn.fused_ffn(*diff, seed, **kw)
                ref = ffn.fused_ffn_plain(*diff, seed, **kw)
        else:
            diff, (lengths, seed) = args[:5], (args[5:7] + [None])[:2]
            with torch.no_grad():
                out = fa.rel_flash_attention(*diff, lengths, seed, **kw)
                ref = fa.rel_flash_attention_plain(*diff, lengths, seed,
                                                   **kw)[0]
        name = str(diff[0].dtype).split(".")[-1]
        rel_f, rel_b = rel_err(out, ref)[1], 0.0
        rounding = (backward and k3_rounding and kind == "K3"
                    and name == "bfloat16")
        ratio = spread = 0.0
        if backward:
            g = torch.randn(out.shape, generator=gen, device="cuda").to(
                out.dtype)
            if kind == "K2":
                x, w1, b1, w2, _ = diff
                got = ffn._launch_bwd(x, w1, b1, w2, g, seed, rate)
                want = ffn.fused_ffn_bwd_plain(x, w1, b1, w2, g, seed,
                                               dropout_rate=rate)
            else:
                ck = (kw.get("chunk_size", 0), kw.get("left_chunks", -1))
                o, lse = fa._launch_fwd(*diff, lengths, kw["scale"], *ck,
                                        seed, rate)
                got = fa._launch_bwd(*diff, lengths, o, lse, g, kw["scale"],
                                     *ck, seed, rate)
                want = fa.rel_flash_attention_bwd_plain(
                    *diff, lengths, o, lse, g, seed, scale=kw["scale"],
                    dropout_rate=rate, chunk_size=ck[0], left_chunks=ck[1])
            if not all(torch.isfinite(x).all() for x in got):
                raise AssertionError(f"{what} {kind}: non-finite gradient")
            rel_b = max(rel_err(a, r)[1] for a, r in zip(got, want))
            if rounding:
                kws = dict(scale=kw["scale"], dropout_rate=rate,
                           chunk_size=ck[0], left_chunks=ck[1])
                ratio = within_rounding(torch, got, want,
                                        k3_bwd_rounding_bounds(
                                            torch, *diff, lengths, o, lse, g,
                                            seed, **kws))
                want64 = fa.rel_flash_attention_bwd_plain(
                    *diff, lengths, o, lse, g, seed,
                    accumulate=torch.float64, **kws)
                spread = max(rel_err(a, r)[1]
                             for a, r in zip(want, want64))
            del got, want
        torch.cuda.synchronize()
        n, *w = worst.get(kind, (0,) + (0.0,) * (4 if k3_rounding else 2))
        worst[kind] = (n + 1,) + tuple(
            max(x, y) for x, y in zip(w, (rel_f, rel_b, ratio, spread)))
        held_b = ratio <= 1.0 if rounding else rel_b <= BWD_PLAIN_TOL
        if not (rel_f <= TOL[name] and held_b):
            raise AssertionError(
                f"{what} {kind} {name} {[tuple(x.shape) for x in diff]}: "
                f"forward {rel_f:.3e}, backward {rel_b:.3e} of max|ref| "
                "against the plain versions"
                + (f", {ratio:.3f} of the rounding bounds"
                   if rounding else ""))
    return worst


def one_step(torch, what, model, batch, card, audio_s, warm=True):
    """A warm-up train step (with ``warm``), then one step with every
    launch count zeroed just before and read just after (the wrappers'
    counts; K1's and K4's kernels by the library's host-side counts):
    (launches, routes, step seconds, peak MB). The losses and grad norms
    must be finite and nothing skipped."""
    from espnet_slurp_tpu_torch.train.optim import OptimConfig, build_optimizer
    from espnet_slurp_tpu_torch.train.state import TrainState, make_train_step
    tx = build_optimizer(OptimConfig(lr=1e-3, scheduler="constant"))
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx)
    torch.cuda.reset_peak_memory_stats()
    first = float("nan")
    if warm:
        state, st0 = step(state, batch)
        first = float(st0["loss"])
    zero_counts()
    routes0 = route_counts()
    t0 = time.perf_counter()
    state, st = step(state, batch)
    loss = float(st["loss"])
    step_s = time.perf_counter() - t0
    launches = read_counts()
    routes = {k: n - routes0[k] for k, n in route_counts().items()}
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    shown = {k: round(float(v), 4) for k, v in st.items()}
    print(f"{what}: step {step_s:.4f} s{'' if warm else ' (the first)'}, "
          f"{audio_s / step_s:.1f} audio-s/s, "
          f"peak {peak_mb:.0f} MB; loss "
          f"{f'{first:.4f} -> ' if warm else ''}{loss:.4f}; stats "
          f"{shown}; launches { {k: v for k, v in launches.items() if v} }; "
          f"K1 / K4 kernels { {k: v for k, v in routes.items() if v} } on "
          f"{card}")
    if not (np.isfinite([loss, float(st["grad_norm"])]).all()
            and float(st["skipped"]) == 0
            and (np.isfinite(first) or not warm)):
        raise AssertionError(f"{what}: non-finite or skipped")
    return launches, routes, step_s, peak_mb


def eb_train_phase(torch, card):
    """Phase 24 (a), training: eb_config at DROPOUT with SpecAug through
    make_train_step on EB_B x TRAIN_SECONDS s, U EB_U (run_train_steps: a
    warm-up, 3 timed steps, a profiled one); a step's launches each way
    K2 24, K3 12, K4 and K1 1 by the wrappers' counts, K1's warp route and
    K4's bf16 launches once by the host counts, nothing else. Then one
    more training forward with every K2 / K3 call recorded. Returns (a
    step's launches, the recorded calls, the StepRun)."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    cfg = eb_config(dropout_rate=DROPOUT)
    model = ASRTask.init_params(ASRModel(cfg, device="cuda"), 0)
    batch = train_batch(torch, np.random.RandomState(24), EB_B,
                        FS * TRAIN_SECONDS, EB_U, cfg.vocab_size, "cuda")
    run = run_train_steps(
        torch, f"phase 24 (a) E-Branchformer train, B={EB_B} x "
        f"{TRAIN_SECONDS} s, U={EB_U}, dropout {DROPOUT}", model, batch,
        card, EB_B * TRAIN_SECONDS, budget_s=0.0)
    check_routes("phase 24 (a) train", run.routes,
                 K1_WARP + tuple(K4_BF16_LAUNCHES), run.steps)
    check_per_step("phase 24 (a) train", run.launches,
                   flagship_step_want(cfg.num_encoder_blocks), run.steps)
    rec = KernelCalls()
    gen = torch.Generator(device="cuda").manual_seed(DROPOUT_SEED)
    with rec.active():
        loss, _ = model(**batch, train=True, generator=gen)
    del loss, model, batch
    torch.cuda.empty_cache()
    per_step = {k: v // run.steps for k, v in run.launches.items()}
    return per_step, rec.calls, run


def eb_serve_phase(torch, card):
    """Phase 24 (a), serving: Speech2Text with eb_config (seeded weights)
    on N_UTT x UTT_SECONDS s at beam BEAM, ctc CTC_WEIGHT, max_len MAX_LEN:
    a warm-up decode, then one timed with the counts zeroed just before
    and read just after (K2 24, K3 12, nothing else); then one encode of
    the same batch with every K2 / K3 call recorded. Returns (the
    decode's launches, its wall seconds, the recorded calls)."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask, Speech2Text

    cfg = eb_config()
    state = ASRTask.init_params(ASRModel(dataclasses.replace(
        cfg, dtype="float32"), device="cpu"), 0).state_dict()
    tokens = token_list(cfg.vocab_size)
    s2t = Speech2Text(cfg, state, tokens, token_type="word",
                      max_len=MAX_LEN, beam_size=BEAM, ctc_weight=CTC_WEIGHT,
                      device="cuda")
    rng = np.random.RandomState(24)
    speeches = [rng.randn(FS * UTT_SECONDS).astype(np.float32) * 0.1
                for _ in range(N_UTT)]
    s2t.max_len = 4  # warm-up: the encode and a few search steps
    s2t.decode_batch(speeches)
    s2t.max_len = MAX_LEN
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    texts = s2t.decode_batch(speeches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"phase 24 (a) E-Branchformer serving: {N_UTT} x {UTT_SECONDS} s, "
          f"beam {BEAM}, ctc {CTC_WEIGHT}, max_len {MAX_LEN}: wall "
          f"{wall:.3f} s, RTF {wall / (N_UTT * UTT_SECONDS):.5f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; hypothesis "
          f"lengths {[len(x.split()) for x in texts]} on {card}")
    vocab = set(tokens) - {"<blank>", "<sos/eos>"}
    check_per_step("phase 24 (a) serving", launches,
                   {"fused_ffn": 24, "rel_flash_attention": 12}, 1)
    if not all(set(x.split()) <= vocab for x in texts) or len(
            texts) != N_UTT:
        raise AssertionError(f"phase 24 (a) serving: texts {texts!r:.300}")
    buf, lens = s2t.pad_batch(speeches)
    rec = KernelCalls()
    with torch.inference_mode(), rec.active():
        s2t.model.encode(torch.from_numpy(buf).cuda(),
                         torch.from_numpy(lens).cuda())
    del s2t
    return launches, wall, rec.calls


def short_fp32_check(torch, what, cfg):
    """compare_cpu_card of ``cfg`` in fp32 at DROPOUT without SpecAug, on
    short_batch, from seeded reference-initialised weights."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask
    cfg = dataclasses.replace(cfg, dtype="float32", dropout_rate=DROPOUT,
                              specaug=None)
    state = ASRTask.init_params(ASRModel(cfg, device="cpu"), 0).state_dict()
    compare_cpu_card(torch, what, ASRModel, cfg, state,
                     *short_batch(cfg.vocab_size))


def cb_phase(torch, card):
    """Phase 24 (b): the contextual-block Conformer at the flagship's
    widths (12 x 256, d_ff 1024, block 40 / hop 16 / look-ahead 16, bf16,
    DROPOUT, SpecAug): one train step on CB_B x TRAIN_SECONDS s (K2 24
    each way, K3 none: its blocks' attention takes the eager masked path;
    K4 and K1 once), one encode of N_UTT x UTT_SECONDS s (K2 24, nothing
    else), then the fp32 step at 2 blocks card vs CPU. Returns the step's
    launches."""
    from espnet_slurp_tpu_torch.models.asr_model import (ASRModel,
                                                          flagship_config)
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    cfg = dataclasses.replace(flagship_config(), dropout_rate=DROPOUT,
                              encoder="contextual_block_conformer")
    model = ASRTask.init_params(ASRModel(cfg, device="cuda"), 0)
    rng = np.random.RandomState(25)
    batch = train_batch(torch, rng, CB_B, FS * TRAIN_SECONDS, TRAIN_U,
                        cfg.vocab_size, "cuda")
    what = (f"phase 24 (b) contextual block train, B={CB_B} x "
            f"{TRAIN_SECONDS} s, U={TRAIN_U}, dropout {DROPOUT}")
    launches, routes, _, _ = one_step(torch, what, model, batch, card,
                                      CB_B * TRAIN_SECONDS)
    check_per_step(what, launches, flagship_step_want(0, n_ffn=24), 1)
    check_routes(what, routes, K1_WARP + tuple(K4_BF16_LAUNCHES), 1)
    speech = train_batch(torch, rng, N_UTT, FS * UTT_SECONDS, 1,
                         cfg.vocab_size, "cuda")
    zero_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        hs, hl = model.encode(speech["speech"], speech["speech_lengths"])
        torch.cuda.synchronize()
    enc = read_counts()
    print(f"phase 24 (b) contextual block encode of {N_UTT} x {UTT_SECONDS} "
          f"s: {time.perf_counter() - t0:.3f} s, hs {tuple(hs.shape)}; "
          f"launches { {k: v for k, v in enc.items() if v} } on {card}")
    check_per_step("phase 24 (b) encode", enc, {"fused_ffn": 24}, 1)
    if not torch.isfinite(hs).all():
        raise AssertionError("phase 24 (b) encode: non-finite")
    del model, batch, hs
    torch.cuda.empty_cache()
    short_fp32_check(torch, "phase 24 (b) fp32 contextual block step, 2 "
                     "blocks", dataclasses.replace(cfg, num_encoder_blocks=2))
    return launches


def small_configs():
    """Phase 24 (c)'s models at the flagship's widths otherwise: the RNN
    encoders at the reference's defaults (320 units, 4 layers, the rnn
    encoder's subsampling 1 / 2 / 2 / 1) with the LAS decoder or the
    dynamic 2-D conv decoder, and a 2-block Conformer behind the Sinc
    pre-encoder (sliding-window frames), the linear one (80 wide), and
    before the BERT post-encoder (2 x 256, from scratch)."""
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.ops.frontend import FrontendConfig
    base = dataclasses.replace(flagship_config(), dropout_rate=DROPOUT)
    two = dict(num_encoder_blocks=2)
    return {
        "vgg_rnn + rnn": dict(encoder="vgg_rnn", decoder="rnn"),
        "rnn + dynamic_conv2d": dict(encoder="rnn", decoder="dynamic_conv2d"),
        "sinc": dict(preencoder="sinc",
                     frontend=FrontendConfig(**SINC_FRONT), **two),
        "linear": dict(preencoder="linear", preencoder_dim=80, **two),
        "hf_bert": dict(postencoder="hf_bert", **two),
    }, base


def small_decodes(torch, card, what, cfg, state):
    """A greedy and a beam (BEAM) decode of SMALL_B x SMALL_SECONDS s
    through Speech2Text (after the model's train step: the greedy one's
    wall includes its first calls): each one's RTF, and no counted kernel
    launched (CTC prefix scores and the decoder run no kernel)."""
    from espnet_slurp_tpu_torch.tasks.asr import Speech2Text
    rng = np.random.RandomState(26)
    speeches = [rng.randn(FS * SMALL_SECONDS).astype(np.float32) * 0.1
                for _ in range(SMALL_B)]
    tokens = token_list(cfg.vocab_size)
    vocab = set(tokens) - {"<sos/eos>"}  # a random decoder may emit blank
    for beam in (1, BEAM):
        s2t = Speech2Text(cfg, state, tokens, token_type="word",
                          max_len=SMALL_MAX_LEN, beam_size=beam,
                          ctc_weight=CTC_WEIGHT, device="cuda")
        zero_counts()
        t0 = time.perf_counter()
        texts = s2t.decode_batch(speeches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in read_counts().items() if v}
        print(f"{what} {'greedy' if beam == 1 else f'beam {beam}'} decode of "
              f"{SMALL_B} x {SMALL_SECONDS} s: wall {wall:.3f} s, RTF "
              f"{wall / (SMALL_B * SMALL_SECONDS):.5f}; hypothesis lengths "
              f"{[len(x.split()) for x in texts]}; launches {launches} on "
              f"{card}")
        if not all(set(x.split()) <= vocab for x in texts) or len(
                texts) != SMALL_B or launches:
            raise AssertionError(f"{what} decode")


def small_phase(torch, card):
    """Phase 24 (c): each of small_configs() one train step on SMALL_B x
    SMALL_SECONDS s, U SMALL_U (the RNN encoders: K4 and K1 once each way,
    no K2 or K3; the 2-block Conformers: K2 4, K3 2, K4 and K1 once); the
    two RNN models decoded greedily and by beam search; then each one's
    fp32 step at 2 layers / blocks card vs CPU. Returns the vgg_rnn + rnn
    step's launches."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    cases, base = small_configs()
    out, laps = None, {}
    for name, kw in cases.items():
        cfg = dataclasses.replace(base, **kw)
        model = ASRTask.init_params(ASRModel(cfg, device="cuda"), 0)
        batch = train_batch(torch, np.random.RandomState(27), SMALL_B,
                            FS * SMALL_SECONDS, SMALL_U, cfg.vocab_size,
                            "cuda")
        what = f"phase 24 (c) {name}"
        t0 = time.perf_counter()
        launches, routes, _, _ = one_step(
            torch, f"{what} train, B={SMALL_B} x {SMALL_SECONDS} s, "
            f"U={SMALL_U}, dropout {DROPOUT}", model, batch, card,
            SMALL_B * SMALL_SECONDS, warm=False)
        rnn = cfg.encoder in ("rnn", "vgg_rnn")
        check_per_step(what, launches,
                       flagship_step_want(0 if rnn else 2), 1)
        check_routes(what, routes, K1_WARP + tuple(K4_BF16_LAUNCHES), 1)
        if rnn:
            state = {k: v.float().cpu() for k, v in
                     model.state_dict().items()}
            small_decodes(torch, card, what, cfg, state)
        if name == "vgg_rnn + rnn":
            out = launches
        del model, batch
        torch.cuda.empty_cache()
        lap = time.perf_counter()
        small = dict(rnn_encoder_layers=2) if rnn else {}
        short_fp32_check(torch, f"{what} fp32 step, 2 "
                         f"{'layers' if rnn else 'blocks'}",
                         dataclasses.replace(cfg, **small))
        laps[name] = (round(lap - t0, 1), round(time.perf_counter() - lap, 1))
    print(f"phase 24 (c) seconds (card, fp32 card vs CPU): {laps}")
    return out


def encoder_phases(torch, card):
    """Phase 24 (a)-(d). Returns {column: a step's or an encode's
    launches} for the kernels line."""
    laps = {}
    t0 = time.perf_counter()

    def lap(name, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        laps[name] = round(time.perf_counter() - t, 1)
        return res

    eb_step, train_calls, _ = lap("(a) train", eb_train_phase, torch, card)
    eb_encode, _, serve_calls = lap("(a) serve", eb_serve_phase, torch, card)
    lap("(a) fp32", short_fp32_check, torch,
        "phase 24 (a) fp32 E-Branchformer step, 2 blocks",
        eb_config(num_encoder_blocks=2))
    worst_train = lap("(d) train", hold_calls, torch, "phase 24 (d) train",
                      train_calls, True, True)
    worst_serve = lap("(d) serve", hold_calls, torch, "phase 24 (d) serve",
                      serve_calls, False)
    print(f"phase 24 (d): every K2 / K3 call of one E-Branchformer train "
          f"forward (both ways) and of one serving encode (forward) against "
          f"its plain version on the same inputs and seed: (calls, worst "
          f"forward error, worst backward error, of max|ref|, and in train "
          f"the worst share of the bf16 K3 backward's rounding bounds and "
          f"the worst distance of its plain backward summed in fp32 and in "
          f"fp64, of max|ref|) train {worst_train}, serve {worst_serve} "
          f"(tolerances {TOL['bfloat16']}, K2 backward {BWD_PLAIN_TOL}, "
          f"the share 1) on {card}")
    if worst_train.get("K2", (0,))[0] != 24 or worst_train.get(
            "K3", (0,))[0] != 12 or worst_serve.get("K2", (0,))[0] != 24 \
            or worst_serve.get("K3", (0,))[0] != 12:
        raise AssertionError(f"phase 24 (d): calls {worst_train} "
                             f"{worst_serve}")
    del train_calls, serve_calls
    torch.cuda.empty_cache()
    cb_step = lap("(b)", cb_phase, torch, card)
    rnn_step = lap("(c)", small_phase, torch, card)
    print(f"phase 24: {time.perf_counter() - t0:.1f} s ({laps})")
    return {"launches_per_ebranchformer_step": eb_step,
            "launches_per_ebranchformer_encode": eb_encode,
            "launches_per_contextual_block_step": cb_step,
            "launches_per_vgg_rnn_step": rnn_step}


# Phase 25: the SSL models (ROADMAP.md item 15): the wav2vec2 ASR encoder,
# the SSL feature dump and the Conformer on it, HuBERT and the wav2vec2
# pretraining objective, under SSL_ROOT (removed at the end).
SSL_ROOT = "build/chip_smoke_ssl"
# (a): the wav2vec2 ASR model's train batch: 16 x 15 s (T' 749), U 64.
W2V_B = 16
# (b): the dump's corpus (cli_split's tones): SSL_TRAIN train and SSL_DEV
# dev utterances of UTT_SECONDS s, batches of SSL_BATCH; the decode's
# max_len; the dumping encoder's widths (wav2vec2-base's).
SSL_TRAIN, SSL_DEV, SSL_BATCH, SSL_MAX_LEN = 32, 8, 16, 24
SSL_DUMP = {"d_model": 768, "num_blocks": 12, "n_head": 12, "d_ff": 3072}
# (c): HuBERT's batch, train steps (one epoch) and dev utterances; its
# k-means clusters (HubertConfig().n_clusters).
HUBERT_B, HUBERT_STEPS, HUBERT_DEV = 64, 3, 8
# (d): the pretraining batch.
PRETRAIN_B = 8
# The card-vs-CPU checks' reduced depths: wav2vec2 and HuBERT blocks.
SSL_CMP_BLOCKS = 2


def w2v_config(**w2v):
    """The flagship's CTC head and 6-block decoder (vocab 5000, d_model
    256, bf16) at dropout DROPOUT over the wav2vec2-base encoder
    (Wav2Vec2Config(): 7 x 512 convs, 12 x 768, 12 heads, d_ff 3072,
    positional conv 128 / 16, attention dropout 0.1) in bf16."""
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    return dataclasses.replace(
        flagship_config(), encoder="wav2vec2", dropout_rate=DROPOUT,
        wav2vec2=Wav2Vec2Config(**{"dtype": "bfloat16", **w2v}))


def w2v_step_kernels(torch, model, batch, top=10):
    """A warm-up train step of ``model`` on ``batch``, then one under
    torch.profiler: ([(kernel, device ms)] of its ``top`` kernels by
    device time, the device ms of all of them)."""
    from torch.profiler import ProfilerActivity, profile

    from espnet_slurp_tpu_torch.train.optim import OptimConfig, build_optimizer
    from espnet_slurp_tpu_torch.train.state import TrainState, make_train_step
    tx = build_optimizer(OptimConfig(lr=1e-3, scheduler="constant"))
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(model, tx)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and not e.key.startswith("train_step.")),
                  key=lambda r: -r[1])
    return rows[:top], sum(ms for _, ms in rows)


def w2v_phase(torch, card):
    """Phase 25 (a): w2v_config() through make_train_step on W2V_B x
    TRAIN_SECONDS s, U TRAIN_U (run_train_steps); a step's launches each
    way K4 1 and K1 1 (K4's bf16 launches and K1's warp route by the host
    counts), K2 and K3 none; its device ms by kernel (w2v_step_kernels);
    K4 (both dtypes, D 768, V 5000) and K1 at
    the batch's labels held to their plain versions; Speech2Text serving
    N_UTT x UTT_SECONDS s at beam BEAM (RTF; no counted launch: the search
    reads the CTC head's logits); the fp32 step at SSL_CMP_BLOCKS blocks
    and a 2-block decoder card vs CPU. Returns (a step's launches, the
    decode's)."""
    from espnet_slurp_tpu_torch.models.asr_model import ASRModel
    from espnet_slurp_tpu_torch.models.wav2vec2 import conv_out_lengths
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask, Speech2Text

    cfg = w2v_config()
    model = ASRTask.init_params(ASRModel(cfg, device="cuda"), 0)
    batch = train_batch(torch, np.random.RandomState(25), W2V_B,
                        FS * TRAIN_SECONDS, TRAIN_U, cfg.vocab_size, "cuda")
    what = (f"phase 25 (a) wav2vec2 ASR train, B={W2V_B} x {TRAIN_SECONDS} "
            f"s, U={TRAIN_U}, attention dropout {cfg.wav2vec2.dropout_rate}")
    run = run_train_steps(torch, what, model, batch, card,
                          W2V_B * TRAIN_SECONDS, budget_s=12.0)
    check_routes(what, run.routes, K1_WARP + tuple(K4_BF16_LAUNCHES),
                 run.steps)
    check_per_step(what, run.launches, flagship_step_want(0, n_ffn=0),
                   run.steps)
    top, total = w2v_step_kernels(torch, model, batch)
    print(f"{what}: device ms by kernel in one profiled step, {total:.2f} "
          f"ms in all, the top {len(top)}: "
          + "; ".join(f"{name[:80]} {ms:.2f}" for name, ms in top))
    t = int(conv_out_lengths(batch["speech_lengths"][:1].cpu(),
                             cfg.wav2vec2.conv_kernel,
                             cfg.wav2vec2.conv_stride)[0])
    hold_ctc_kernels(torch, "phase 25 (a)", batch["text"].to(torch.int32),
                     batch["text_lengths"], t, cfg.wav2vec2.d_model,
                     cfg.vocab_size, 25)
    del model, batch
    torch.cuda.empty_cache()
    state = ASRTask.init_params(ASRModel(dataclasses.replace(
        cfg, dtype="float32"), device="cpu"), 0).state_dict()
    s2t = Speech2Text(cfg, state, token_list(cfg.vocab_size),
                      token_type="word", max_len=MAX_LEN, beam_size=BEAM,
                      ctc_weight=CTC_WEIGHT, device="cuda")
    rng = np.random.RandomState(25)
    speeches = [rng.randn(FS * UTT_SECONDS).astype(np.float32) * 0.1
                for _ in range(N_UTT)]
    s2t.max_len = 4  # warm-up: the encode and a few search steps
    s2t.decode_batch(speeches)
    s2t.max_len = MAX_LEN
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    texts = s2t.decode_batch(speeches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode = read_counts()
    print(f"phase 25 (a) wav2vec2 ASR serving: {N_UTT} x {UTT_SECONDS} s, "
          f"beam {BEAM}, ctc {CTC_WEIGHT}, max_len {MAX_LEN}: wall "
          f"{wall:.3f} s, RTF {wall / (N_UTT * UTT_SECONDS):.5f}; "
          f"hypothesis lengths {[len(x.split()) for x in texts]} on {card}")
    check_per_step("phase 25 (a) serving", decode, {}, 1)
    if len(texts) != N_UTT:
        raise AssertionError(f"phase 25 (a) serving: {texts!r:.300}")
    del s2t
    torch.cuda.empty_cache()
    short_fp32_check(torch, f"phase 25 (a) fp32 wav2vec2 ASR step, "
                     f"{SSL_CMP_BLOCKS} wav2vec2 blocks, 2 decoder blocks",
                     dataclasses.replace(
                         w2v_config(num_blocks=SSL_CMP_BLOCKS,
                                    dtype="float32"), num_decoder_blocks=2))
    return {k: v // run.steps for k, v in run.launches.items()}, decode


def ssl_train_yaml(root, train_dir, dev_dir):
    """A feats_type ssl train config into root/exp: flagship_config()'s
    Conformer at dropout DROPOUT with SpecAug over the dump's 13 layers of
    768 (the softmax layer weighting, ssl_num_layers 13), Adam at a
    constant 1e-3, char tokens, one epoch of sorted batches of
    SSL_BATCH."""
    import yaml
    from espnet_slurp_tpu_torch.models.asr_model import flagship_config
    from espnet_slurp_tpu_torch.utils.config import to_dict

    model = to_dict(dataclasses.replace(
        flagship_config(), dropout_rate=DROPOUT, input_feats=True,
        input_feats_dim=SSL_DUMP["d_model"],
        ssl_num_layers=SSL_DUMP["num_blocks"] + 1))
    del model["vocab_size"]
    cfg = {"exp_dir": str(root / "exp"), "max_epoch": 1, "model": model,
           "optim": {"name": "adam", "lr": 1e-3, "scheduler": "constant"},
           "data": {"train_dir": str(train_dir), "valid_dir": str(dev_dir),
                    "feats_type": "ssl", "token_type": "char",
                    "batch_type": "sorted", "batch_size": SSL_BATCH,
                    "speech_bucket_multiple": 16}}
    path = root / "train_ssl.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def ssl_cli_phase(torch, card, root):
    """Phase 25 (b): bin/ssl_dump at wav2vec2-base's width (--layer -1:
    [749, 13, 768] fp32 an utterance) of SSL_TRAIN + SSL_DEV utterances,
    bin/asr_train (ssl_train_yaml: a step K2 24, K3 12, K4 1, K1 1 each way
    by the wrappers' counts), bin/asr_inference from the dev dump's
    feats.scp at beam BEAM; then one train forward of the trained model on
    the first batch with every K2 / K3 call recorded, and K4 (D 256, this
    vocabulary) and K1 at that batch's labels held to their plain
    versions. Returns (a step's launches, the recorded calls)."""
    from espnet_slurp_tpu_torch.bin import asr_inference, asr_train, ssl_dump
    from espnet_slurp_tpu_torch.data.prefetch import to_device
    from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
    from espnet_slurp_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                        conv_out_lengths)
    from espnet_slurp_tpu_torch.tasks import asr as task
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask, load_task_config
    from espnet_slurp_tpu_torch.train.checkpoint import CheckpointManager

    rng = np.random.RandomState(25)
    dirs = [cli_split(root / split, split, n, rng)
            for split, n in (("train", SSL_TRAIN), ("dev", SSL_DEV))]
    widths = [x for k, v in SSL_DUMP.items() for x in (f"--{k}", str(v))]
    t0 = time.perf_counter()
    for split, d in zip(("train", "dev"), dirs):
        if ssl_dump.main([
                "--data_dir", str(d), "--out_dir", str(root / "dump" / split),
                *widths, "--layer", "-1", "--device", "cuda"]) != 0:
            raise AssertionError("phase 25 (b): ssl_dump")
    dump_s = time.perf_counter() - t0
    mats = sorted((root / "dump" / "train" / "data").glob("*.npy"))
    first = np.load(mats[0])
    mb = sum(m.stat().st_size for m in mats) / 1e6
    print(f"phase 25 (b) bin/ssl_dump of {SSL_TRAIN + SSL_DEV} x "
          f"{UTT_SECONDS} s at wav2vec2-base width: {dump_s:.1f} s "
          f"({(SSL_TRAIN + SSL_DEV) * UTT_SECONDS / dump_s:.1f} audio-s/s, "
          f"the wav reads and .npy writes included); a matrix "
          f"{first.shape} {first.dtype}, {mb:.0f} MB for the train split")
    w = Wav2Vec2Config()
    t = int(conv_out_lengths(torch.tensor([FS * UTT_SECONDS]),
                             w.conv_kernel, w.conv_stride)[0])
    if len(mats) != SSL_TRAIN or not np.isfinite(first).all() \
            or first.shape != (t, SSL_DUMP["num_blocks"] + 1,
                               SSL_DUMP["d_model"]):
        raise AssertionError("phase 25 (b): the dump")
    per_step, clock = [], []
    make = step_recorder(torch, per_step, clock)
    t0 = time.perf_counter()
    try:
        rc = asr_train.main(["--config", ssl_train_yaml(
            root, root / "dump" / "train", root / "dump" / "dev"),
            "--device", "cuda"])
    finally:
        task.make_train_step = make
    train_s = time.perf_counter() - t0
    exp = root / "exp"
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    steps = [round(b - a, 4) for a, b in clock]
    print(f"phase 25 (b) bin/asr_train, feats_type ssl, ssl_num_layers 13: "
          f"{train_s:.1f} s, {len(per_step)} steps of {SSL_BATCH} (step s "
          f"{steps}); reporter {hist[-1]} on {card}")
    want = flagship_step_want(12)
    bad = [w for w, _, _ in per_step
           if w != {k: want.get(k, 0) for k in COUNTED}]
    if rc != 0 or len(per_step) != SSL_TRAIN // SSL_BATCH or bad:
        raise AssertionError(f"phase 25 (b) train: rc {rc}, launches "
                             f"{[w for w, _, _ in per_step]}")
    out = root / "dec"
    t0 = time.perf_counter()
    if asr_inference.main([
            "--exp_dir", str(exp), "--data_dir", str(root / "dump" / "dev"),
            "--output_dir", str(out), "--beam_size", str(BEAM), "--max_len",
            str(SSL_MAX_LEN), "--device", "cuda"]) != 0:
        raise AssertionError("phase 25 (b): asr_inference")
    wall = time.perf_counter() - t0
    score = (out / "score.txt").read_text().split()
    print(f"phase 25 (b) bin/asr_inference from feats.scp, {SSL_DEV} x "
          f"{UTT_SECONDS} s at beam {BEAM}, max_len {SSL_MAX_LEN}: "
          f"{wall:.2f} s with the model's load (RTF by its wall "
          f"{wall / (SSL_DEV * UTT_SECONDS):.5f}); score.txt {score} (its "
          f"RTF counts 100 frames a second, as the reference's) on {card}")
    if len((out / "text").read_text().splitlines()) != SSL_DEV:
        raise AssertionError("phase 25 (b): the decode's text")
    cfg = load_task_config(str(exp / "config.yaml"))
    tok, conv, mcfg = ASRTask.prepare_vocab(cfg)
    ds = ASRTask.build_dataset(cfg.data.train_dir, tok, conv,
                               feats_type="ssl")
    batch = to_device(next(iter(ASRTask.build_iter_factory(
        cfg, ds, shuffle=False)(1))), "cuda")
    model = ASRTask.build_model(mcfg, device="cuda")
    model.load_state_dict(CheckpointManager(exp, cfg.keep_nbest)
                          .load_params(None))
    rec = KernelCalls()
    gen = torch.Generator(device="cuda").manual_seed(DROPOUT_SEED)
    with rec.active():
        model(**batch, train=True, generator=gen)
    t_prime = Conv2dSubsampling.out_length_static(batch["speech"].shape[1])
    hold_ctc_kernels(torch, "phase 25 (b)", batch["text"].to(torch.int32),
                     batch["text_lengths"], t_prime, mcfg.d_model,
                     mcfg.vocab_size, 26)
    del model, batch
    torch.cuda.empty_cache()
    return per_step[-1][0], rec.calls


def hubert_split(d, split, count, rng):
    """d/{wav.scp,km}: count utterances of UTT_SECONDS s of noise and a
    k-means id a frame at HubertConfig()'s encoder rate (x4 after hop
    128: 468 for 15 s), uniform over its clusters."""
    from espnet_slurp_tpu_torch.data.fileio import DatadirWriter, write_wav
    from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
    from espnet_slurp_tpu_torch.models.hubert import HubertConfig

    n = FS * UTT_SECONDS
    t_enc = Conv2dSubsampling.out_length_static(1 + n // 128)
    (d / "wav").mkdir(parents=True, exist_ok=True)
    with DatadirWriter(d) as w:
        for i in range(count):
            uid = f"{split}_{i:04d}"
            path = (d / "wav" / f"{uid}.wav").resolve()
            write_wav(str(path), (rng.randn(n) * 0.1).astype(np.float32), FS)
            w["wav.scp"][uid] = str(path)
            w["km"][uid] = " ".join(map(str, rng.randint(
                HubertConfig().n_clusters, size=t_enc)))
    return d


def hubert_loss_model(cfg, device=None):
    """HubertModel under compare_cpu_card's keywords: ``text`` carries the
    cluster ids."""
    from espnet_slurp_tpu_torch.models.hubert import HubertModel

    class HubertLoss(HubertModel):
        def forward(self, speech, speech_lengths, text, text_lengths, **kw):
            return super().forward(speech, speech_lengths, text, **kw)
    return HubertLoss(cfg, device)


def hubert_phase(torch, card, root):
    """Phase 25 (c): bin/hubert_train with HubertConfig() (6 x 256, d_ff
    1024, fp32; K2 and K3 fp32 on the card) on HUBERT_STEPS batches of
    HUBERT_B x UTT_SECONDS s with km ids, one epoch (a step K2 12, K3 6
    each way, nothing else, by the wrappers' counts); one train forward on
    the first batch with every K2 / K3 call recorded; the fp32 step at
    SSL_CMP_BLOCKS blocks card vs CPU (the span starts from one CPU
    generator on both sides). Returns (a step's launches, the recorded
    calls)."""
    from espnet_slurp_tpu_torch.bin import hubert_train
    from espnet_slurp_tpu_torch.data.collate import common_collate
    from espnet_slurp_tpu_torch.data.prefetch import to_device
    from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
    from espnet_slurp_tpu_torch.models.hubert import HubertConfig, HubertModel
    from espnet_slurp_tpu_torch.tasks import generic
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask
    from espnet_slurp_tpu_torch.tasks.hubert import HubertTask

    rng = np.random.RandomState(27)
    t0 = time.perf_counter()
    train = hubert_split(root / "hubert_train", "train",
                         HUBERT_B * HUBERT_STEPS, rng)
    dev = hubert_split(root / "hubert_dev", "dev", HUBERT_DEV, rng)
    write_s = time.perf_counter() - t0
    exp = root / "hubert_exp"
    per_step, clock = [], []
    make = step_recorder(torch, per_step, clock, task=generic)
    t0 = time.perf_counter()
    try:
        rc = hubert_train.main([
            "--set", f"exp_dir={exp}", f"train_dir={train}",
            f"valid_dir={dev}", f"batch_size={HUBERT_B}", "run.max_epoch=1",
            "--device", "cuda"])
    finally:
        generic.make_train_step = make
    train_s = time.perf_counter() - t0
    hist = json.loads((exp / "reporter.json").read_text())["history"]
    steps = [round(b - a, 4) for a, b in clock]
    audio = HUBERT_B * UTT_SECONDS
    print(f"phase 25 (c) bin/hubert_train, HubertConfig(), {HUBERT_STEPS} "
          f"steps of {HUBERT_B} x {UTT_SECONDS} s (corpus written in "
          f"{write_s:.1f} s): {train_s:.1f} s; step s {steps} "
          f"({audio / np.median(steps):.1f} audio-s/s at the median); "
          f"reporter {hist[-1]} on {card}")
    want = {"fused_ffn": 12, "fused_ffn_bwd": 12, "rel_flash_attention": 6,
            "rel_flash_attention_bwd": 6}
    bad = [w for w, _, _ in per_step
           if w != {k: want.get(k, 0) for k in COUNTED}]
    if rc != 0 or len(per_step) != HUBERT_STEPS or bad or not np.isfinite(
            hist[-1]["train"]["loss"]):
        raise AssertionError(f"phase 25 (c) train: rc {rc}, launches "
                             f"{[w for w, _, _ in per_step]}")
    cfg = HubertConfig()
    model = ASRTask.init_params(HubertModel(cfg, device="cuda"), 0)
    ds = HubertTask.build_dataset(str(train))
    batch = to_device(HubertTask.batch_adapter(*common_collate(
        [ds[u] for u in sorted(ds.keys)[:HUBERT_B]])), "cuda")
    rec = KernelCalls()
    with rec.active():
        model(**batch, train=True,
              generator=torch.Generator(device="cuda").manual_seed(27))
    del model, batch
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_blocks=SSL_CMP_BLOCKS)
    state = ASRTask.init_params(hubert_loss_model(small, "cpu"),
                                0).state_dict()
    speech, lens, _, _ = short_batch(cfg.n_clusters)
    t_enc = Conv2dSubsampling.out_length_static(1 + speech.shape[1] // 128)
    ids = np.random.RandomState(28).randint(cfg.n_clusters,
                                            size=(2, t_enc))
    compare_cpu_card(torch, f"phase 25 (c) fp32 HuBERT step, "
                     f"{SSL_CMP_BLOCKS} blocks", hubert_loss_model, small,
                     state, speech, lens, ids, np.full(2, t_enc, np.int32))
    return per_step[-1][0], rec.calls


def _pretrain_loss_class(draws):
    """compare_cpu_card's model class for the pretraining objective at the
    given draws (numpy: starts, gumbel_u, neg_idx); ``text`` is unused."""
    def make(cfg, device=None):
        import torch
        from espnet_slurp_tpu_torch.models.wav2vec2 import (
            Wav2Vec2PretrainModel)

        class PretrainLoss(Wav2Vec2PretrainModel):
            def forward(self, speech, speech_lengths, text, text_lengths,
                        **kw):
                given = {k: torch.from_numpy(v) for k, v in draws.items()}
                return super().forward(speech, speech_lengths, **given, **kw)
        return PretrainLoss(cfg, device)
    return make


def pretrain_phase(torch, card):
    """Phase 25 (d): one Wav2Vec2PretrainModel step at wav2vec2-base's
    width in bf16 (the quantizer and the contrastive head in fp32; 100
    distractors a frame from the generator) on PRETRAIN_B x TRAIN_SECONDS
    s after a warm-up: a finite loss, no counted launch (no kernel on its
    path); then the fp32 objective at a small width (7 x 128 convs, 2 x
    128) card vs CPU at given draws (span starts, Gumbel noise,
    distractors). Returns the step's launches."""
    from espnet_slurp_tpu_torch.models.wav2vec2 import (
        Wav2Vec2Config, Wav2Vec2PretrainModel, conv_out_lengths, span_mask)
    from espnet_slurp_tpu_torch.tasks.asr import ASRTask

    cfg = Wav2Vec2Config(dtype="bfloat16")
    model = ASRTask.init_params(Wav2Vec2PretrainModel(cfg, device="cuda"), 0)
    n = FS * TRAIN_SECONDS
    rng = np.random.RandomState(29)
    batch = {"speech": torch.from_numpy(
        rng.randn(PRETRAIN_B, n).astype(np.float32) * 0.1).cuda(),
        "speech_lengths": torch.full((PRETRAIN_B,), n, dtype=torch.int32,
                                     device="cuda")}
    what = (f"phase 25 (d) wav2vec2 pretraining, B={PRETRAIN_B} x "
            f"{TRAIN_SECONDS} s, bf16")
    launches, routes, _, _ = one_step(torch, what, model, batch, card,
                                      PRETRAIN_B * TRAIN_SECONDS)
    check_per_step(what, launches, {}, 1)
    check_routes(what, routes, (), 1)
    del model, batch
    torch.cuda.empty_cache()
    small = Wav2Vec2Config(conv_dim=(128,) * 7, d_model=128, n_head=4,
                           d_ff=256, num_blocks=2, pos_conv_kernel=32,
                           pos_conv_groups=4, n_negatives=20,
                           quantizer_entries=40, vq_dim=64, final_dim=64)
    state = ASRTask.init_params(Wav2Vec2PretrainModel(small, device="cpu"),
                                0).state_dict()
    speech, lens, _, _ = short_batch(10)
    frames = conv_out_lengths(torch.from_numpy(lens), small.conv_kernel,
                              small.conv_stride)
    t = int(frames.max())
    draws = {"starts": rng.rand(2, t) < 0.1,
             "gumbel_u": rng.uniform(1e-6, 1 - 1e-6, (
                 2, t, small.quantizer_groups,
                 small.quantizer_entries)).astype(np.float32)}
    masked = span_mask(torch.from_numpy(draws["starts"]), frames,
                       small.mask_span).numpy()
    draws["neg_idx"] = np.stack([rng.choice(np.flatnonzero(m), (
        t, small.n_negatives)) for m in masked])
    compare_cpu_card(torch, "phase 25 (d) fp32 wav2vec2 pretraining step, "
                     "7 x 128 convs, 2 x 128, given draws",
                     _pretrain_loss_class(draws), small, state, speech, lens,
                     np.zeros((2, 1), np.int64), np.ones(2, np.int32))
    return launches


def ssl_phases(torch, card):
    """Phase 25 (a)-(d) and the K2 / K3 holds of (b)'s and (c)'s recorded
    calls (forward against the plain version, the backward launches
    against the plain backward at the kernels' rounding points), under
    SSL_ROOT, removed at the end. Returns {column: a step's or a decode's
    launches} for the kernels line."""
    import shutil
    from pathlib import Path

    root = Path(SSL_ROOT).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    laps = {}
    t0 = time.perf_counter()

    def lap(name, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        laps[name] = round(time.perf_counter() - t, 1)
        return res

    w2v_step, w2v_decode = lap("(a)", w2v_phase, torch, card)
    ssl_step, ssl_calls = lap("(b)", ssl_cli_phase, torch, card, root)
    hub_step, hub_calls = lap("(c)", hubert_phase, torch, card, root)
    shutil.rmtree(root, ignore_errors=True)
    pre_step = lap("(d)", pretrain_phase, torch, card)
    worst = {}
    for name, calls, n_ffn, n_att in (("(b)", ssl_calls, 24, 12),
                                      ("(c)", hub_calls, 12, 6)):
        worst[name] = lap(f"{name} hold", hold_calls, torch,
                          f"phase 25 {name} train", calls, True, True)
        if worst[name].get("K2", (0,))[0] != n_ffn or worst[name].get(
                "K3", (0,))[0] != n_att:
            raise AssertionError(f"phase 25 {name}: calls {worst[name]}")
    print(f"phase 25: every K2 / K3 call of one train forward of (b)'s "
          f"feats_type ssl Conformer (bf16) and of (c)'s HuBERT (fp32), "
          f"both ways against the plain versions on the same inputs and "
          f"seed: (calls, worst forward error, worst backward error, of "
          f"max|ref|, worst share of the bf16 K3 backward's rounding "
          f"bounds, worst distance of its plain backward summed in fp32 "
          f"and in fp64, of max|ref|) {worst} (tolerances {TOL}, fp32 "
          f"backward {BWD_PLAIN_TOL}, the share 1) on {card}")
    print(f"phase 25: {time.perf_counter() - t0:.1f} s ({laps})")
    return {"launches_per_wav2vec2_step": w2v_step,
            "launches_per_wav2vec2_decode": w2v_decode,
            "launches_per_ssl_conformer_step": ssl_step,
            "launches_per_hubert_step": hub_step,
            "launches_per_wav2vec2_pretrain_step": pre_step}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from espnet_slurp_tpu_torch.data.sampler import bucket_length
    from espnet_slurp_tpu_torch.models.embedding import Conv2dSubsampling
    from espnet_slurp_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(card)  # exactly as nvidia-smi gives it
    laps = {}  # phase -> seconds, printed at the end

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        laps[name] = round(time.perf_counter() - t, 1)
        return out

    t0 = time.perf_counter()
    build.library()
    laps["1 build"] = round(time.perf_counter() - t0, 1)
    print(f"kernel build: {laps['1 build']:.1f} s")
    for line in build.build_log().splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("  " + line.strip())
    blocks = {f"{k} Dh {dh}": getattr(
        build.library(), f"espnet_rel_flash_{k}_blocks_per_sm")(dh)
        for k in ("fwd", "dkv", "dq") for dh in (64, 32)}
    print(f"K3 bf16 kernels, blocks per SM: {blocks}")
    f32_blocks = {f"{k} Dh {dh}": build.library()
                  .espnet_rel_flash_f32_blocks_per_sm(i, dh)
                  for i, k in enumerate(("fwd", "dkv", "dq"))
                  for dh in (64, 32, 128)}
    print(f"K3 fp32 kernels, blocks per SM: {f32_blocks}")
    ffn_blocks = build.library().espnet_fused_ffn_fwd_blocks_per_sm(256, 256)
    print(f"K2 bf16 forward kernel (D 256, D2 256), blocks per SM: "
          f"{ffn_blocks}")
    print("K2 fp32 kernels (registers, static shared bytes, local bytes, "
          f"blocks per SM; rate 0, dropout): {ffn_f32_info()}")
    print("K4 fp32 kernels (registers, shared bytes, local bytes, blocks "
          f"per SM): {ctc_head_info(0)}")
    print("K4 bf16 kernels (registers, shared bytes, local bytes, blocks "
          f"per SM): {ctc_head_info(1)}")
    print("K1 kernels at S 129 and 401 (registers, shared bytes, local "
          f"bytes, blocks per SM): {ctc_info(129)} {ctc_info(401)}")
    print("K6 bf16 kernels at D 256, k 31 (registers, shared bytes, local "
          f"bytes, blocks per SM): {k6_info(256, 31)}")
    print("K6 fp32 kernels at D 256, k 31 (registers, shared bytes, local "
          f"bytes, blocks per SM): {k6_info(256, 31, fp32=True)}")
    from espnet_slurp_tpu_torch.ops.kernels import transducer as kt
    print("K5 kernels at U1 65 and 300 (registers, shared bytes, local "
          f"bytes, blocks per SM): {[kt.info(w, 65) for w in (0, 1)]} "
          f"{[kt.info(w, 300) for w in (0, 1)]}")

    # T' of a 15 s utterance as Speech2Text pads it (bucket of 4096 samples,
    # hop 128, x4 subsampling).
    n = bucket_length(FS * UTT_SECONDS, 4096)
    t_prime = Conv2dSubsampling.out_length_static(1 + n // 128)
    kernels = timed("2", kernel_phase, torch, t_prime)
    decode_launches, decode_wall = timed("3", slice_phase, torch, card)
    t_train = Conv2dSubsampling.out_length_static(
        1 + FS * TRAIN_SECONDS // 128)
    train_kernels, fwd_train = timed("4", train_kernel_phase, torch, t_train)
    kernels += train_kernels
    train_launches, train_step_s, train_peak_mb = timed("5", train_phase,
                                                        torch, card)
    timed("6", train_cpu_vs_card, torch)
    dropout = timed("7", dropout_phase, torch, t_train)
    t_added = time.perf_counter()
    wmma_kernels, wmma_dh128 = wmma_dropout_phase(torch, t_train)
    default_per_step, default_launches, default_stats = default_train_phase(
        torch, card)
    t_added = time.perf_counter() - t_added
    laps["12-13"] = round(t_added, 1)
    print(f"WMMA dropout and default ASRConfig train phases: {t_added:.1f} s")
    t_added = time.perf_counter()
    fused_per_step, fused_launches = fused_conv_train_phase(
        torch, card, default_stats, t_train)
    laps["14"] = round(time.perf_counter() - t_added, 1)
    print(f"ASRConfig(fused_conv=True) train phase: {laps['14']:.1f} s")
    tr_kernels, at_tr_shape, k6_fp32 = timed(
        "8", transducer_kernel_phase, torch, t_train, t_prime)
    kernels += tr_kernels
    for kern in kernels:
        kern.update(at_tr_shape.get(kern["name"], {}))
        if kern["name"] in dropout:
            kern["dropout"] = dropout[kern["name"]]
        if kern["name"] in wmma_dh128:
            kern["dropout"]["wmma_bf16_dh128"] = wmma_dh128[kern["name"]]
        if kern["name"] == "rel_flash_attention":
            kern["blocks_per_sm"] = blocks["fwd Dh 64"]
        if kern["name"] == "fused_ffn":
            kern["blocks_per_sm"] = ffn_blocks
        if kern["name"] == "rel_flash_attention_bwd":
            kern["blocks_per_sm"] = {k: blocks[f"{k} Dh 64"]
                                     for k in ("dkv", "dq")}
    tr_launches, tr_routes = timed("9", transducer_train_phase, torch, card)
    timed("10", transducer_cpu_vs_card, torch)
    tr_decode = timed("11", transducer_decode_phase, torch, card)
    for kern in kernels:
        name = kern["name"]
        # Each kernel's count from its own slice's train step: the flagship
        # ASR step for K1-K4, the transducer step for K5 and K6.
        own = tr_launches if name.startswith(("rnnt", "fused_conv")) \
            else train_launches
        kern["launches"] = own[name]
        kern["launches_per_train_step"] = train_launches[name] // TRAIN_STEPS
        kern["launches_per_transducer_step"] = tr_launches[name] // TRAIN_STEPS
        if name in decode_launches:
            kern["launches_per_decode"] = decode_launches[name]
            kern.update(fwd_train[name])
        if name in tr_decode:
            kern["launches_per_transducer_decode"] = tr_decode[name]
        if name.startswith("rnnt"):
            kern["route_launches"] = {k: tr_routes[k]
                                      for k in K5_WARP + K5_BLOCK}
        if name not in BF16_TIMED:
            kern["launches_per_default_train_step"] = default_per_step[name]
    for kern in wmma_kernels:
        # The default ASRConfig's step launches K2 and K3 in fp32 only: the
        # wrappers' counts are these kernels'.
        base = kern["name"].replace("_fp32", "")
        kern["launches"] = default_launches[base]
        kern["launches_per_default_train_step"] = default_per_step[base]
        if base == "rel_flash_attention":
            kern["blocks_per_sm"] = f32_blocks["fwd Dh 64"]
        if base == "rel_flash_attention_bwd":
            kern["blocks_per_sm"] = {k: f32_blocks[f"{k} Dh 64"]
                                     for k in ("dkv", "dq")}
    kernels += wmma_kernels
    for kern in k6_fp32:
        # ASRConfig(fused_conv=True)'s step launches K6 in fp32 only.
        base = kern["name"].replace("_fp32", "")
        kern["launches"] = fused_launches[base]
        kern["launches_per_fused_conv_train_step"] = fused_per_step[base]
    kernels += k6_fp32
    timed("15", cli_phase, torch, card, decode_launches, decode_wall,
          train_step_s)
    t_added = time.perf_counter()
    recipe_steps, tr_cli_steps, (moe_step, inter_steps) = recipe_phases(
        torch, card, train_step_s)
    laps["16-18, 19 (f)"] = round(time.perf_counter() - t_added, 1)
    print(f"phases 16-18 and 19 (f): {laps['16-18, 19 (f)']:.1f} s")
    t_added = time.perf_counter()
    tcpgen_step, mbr_step = kb_train_phase(torch, card, train_step_s,
                                           train_peak_mb)
    lap = time.perf_counter()
    kb_fp32_phase(torch, card)
    print(f"phase 19 (a)-(b): {lap - t_added:.1f} s, (c): "
          f"{time.perf_counter() - lap:.1f} s")
    lap = time.perf_counter()
    kb_tr_step = kb_transducer_phase(torch, card)
    kb_decode_phase(torch, card)
    print(f"phase 19 (d)-(e): {time.perf_counter() - lap:.1f} s; (a)-(e): "
          f"{time.perf_counter() - t_added:.1f} s")
    laps["19 (a)-(e)"] = round(time.perf_counter() - t_added, 1)
    slu_step = timed("20", slu_phases, torch, card, train_step_s)
    lm_decode = timed("21", lm_phases, torch, card)
    ka2g_step, ka2g_entries = timed("22", ka2g_phases, torch, card,
                                    train_step_s)
    stream_step, stream_tr, maskctc_step = timed("23", stream_phases, torch,
                                                 card)
    encoder_cols = timed("24", encoder_phases, torch, card)
    encoder_cols.update(timed("25", ssl_phases, torch, card))
    # HuBERT computes in fp32: its K2 / K3 launches are the fp32 entries'.
    hubert_step = encoder_cols.pop("launches_per_hubert_step")
    for kern in kernels:
        base = kern["name"]
        if base.endswith("_fp32"):
            kern["launches_per_hubert_step"] = hubert_step.get(
                base[:-len("_fp32")], 0)
        elif base in COUNTED:
            kern["launches_per_hubert_step"] = (
                0 if base in BF16_TIMED else hubert_step.get(base, 0))
    for kern in kernels:
        base = kern["name"]
        if base.endswith("_fp32"):
            continue
        if base in recipe_steps:
            kern["launches_per_recipe_step"] = recipe_steps[base]
        if base in tr_cli_steps:
            kern["launches_per_transducer_cli_step"] = tr_cli_steps[base]
        if base in moe_step:
            kern["launches_per_moe_step"] = moe_step[base]
            kern["launches_per_interctc_step"] = {
                label: per[base] for label, per in inter_steps.items()}
        if base in tcpgen_step:
            kern["launches_per_tcpgen_step"] = tcpgen_step[base]
            kern["launches_per_mbr_step"] = mbr_step[base]
        if base in kb_tr_step:
            kern["launches_per_kb_transducer_step"] = kb_tr_step[base]
        if base in slu_step:
            kern["launches_per_slu_step"] = slu_step[base]
        if base in lm_decode:
            kern["launches_per_lm_decode"] = lm_decode[base]
        if base in COUNTED:
            kern["launches_per_ka2g_step"] = ka2g_step.get(base, 0)
            kern["launches_per_stream_step"] = stream_step.get(base, 0)
            kern["launches_per_stream_transducer_encode"] = stream_tr.get(
                base, 0)
            kern["launches_per_maskctc_step"] = maskctc_step.get(base, 0)
            for col, per in encoder_cols.items():
                kern[col] = per.get(base, 0)
    kernels += ka2g_entries
    print(f"chip_smoke.py: the whole run {time.perf_counter() - t_start:.1f} "
          f"s (the kernel build included) on {card}; by phase (s): {laps}")
    for kern in kernels:
        print(f"{kern['name']}: {kern['ms']:.4f} ms (plain "
              f"{kern['plain_ms']:.4f} ms, library {kern['library_ms']}, "
              f"bound {kern['bound_ms']:.4f} ms by {kern['bound_by']}; "
              f"launches {kern['launches']}) on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
